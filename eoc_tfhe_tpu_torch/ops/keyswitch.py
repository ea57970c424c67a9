"""LWE key switching as a one-hot matrix product.

Port of ``eoc_tfhe_tpu/ops/keyswitch.py``.  The digits of the input mask
select rows of the key-switching table; the selection is a one-hot matrix
times the table's signed byte limbs, recombined mod 2^32.
"""

from __future__ import annotations

import torch

from ..core.keys import KeySwitchKey
from ..core.lwe import LweCiphertext
from ..core.numeric import as_u32, wrap32
from ..device import device_constant, exact_matmuls
from ..utils.profiling import span
from . import polymul

#: Batch rows per one-hot product: bounds the (rows, n_in*t*base) float32
#: one-hot at 128 MiB for the 128-bit set (n_in*t*base = 32768).
_CHUNK = 1024
#: Input rows of the table split into limbs at once: the split's int64
#: temporaries are some six times the rows' words, 64 GB for the whole table
#: at n_in = k N = 65536 (N = 32768, k = 2) against the prepared table's 21 GB.
_PREP_ROWS = 1024
#: The keyswitch's device constants (:func:`digit_shifts`,
#: :func:`round_variance`), by what each is built from and the device.
_CONSTANTS: dict = {}


def prepare_keyswitch_matmul(ks: KeySwitchKey) -> torch.Tensor:
    """(n_in * t * base, (n_out+1) * LIMBS) float32 signed byte limbs of the
    table, with the u=0 plane zeroed (upstream skips zero digits), split
    ``_PREP_ROWS`` input rows at a time."""
    n_in, t, base, m = ks.ks.shape
    out = torch.empty((n_in, t, base, m, polymul.LIMBS), dtype=torch.float32,
                      device=ks.ks.device)
    for i in range(0, n_in, _PREP_ROWS):
        table = ks.ks[i:i + _PREP_ROWS].clone()
        table[:, :, 0, :] = 0
        out[i:i + _PREP_ROWS] = polymul.decompose_signed_limbs(table)   # (rows, t, base, m, L)
    return out.reshape(n_in * t * base, m * polymul.LIMBS)


def keyswitch_digits(a: torch.Tensor, t: int, basebit: int) -> torch.Tensor:
    """Digit extraction with rounding offset (upstream ``lweKeySwitchTranslate``).

    Args:
      a: (..., n_in) int32 coefficients of the input sample.
    Returns:
      (..., n_in, t) int32 digits in [0, base).
    """
    prec_offset = 1 << (32 - (1 + basebit * t))
    aibar = (as_u32(a) + prec_offset) & 0xFFFFFFFF
    shifts = digit_shifts(t, basebit, a.device)
    return ((aibar[..., None] >> shifts) & ((1 << basebit) - 1)).to(torch.int32)


def digit_shifts(t: int, basebit: int, device: torch.device) -> torch.Tensor:
    """(t,) int64 right shifts of the t digits, 32 - (j+1)*basebit, on
    ``device`` (built on its first use there)."""
    return device_constant(
        _CONSTANTS, ("shifts", t, basebit, device),
        lambda: torch.tensor([32 - (j + 1) * basebit for j in range(t)], dtype=torch.int64,
                             device=device))


def round_variance(n_in: int, t: int, basebit: int, device: torch.device) -> torch.Tensor:
    """() float32 variance of the digits' rounding, n_in * 2^(-2 t basebit) / 24,
    on ``device`` (built on its first use there)."""
    return device_constant(
        _CONSTANTS, ("round_var", n_in, t, basebit, device),
        lambda: torch.tensor(n_in * 2.0 ** (-2 * t * basebit) / 24.0, dtype=torch.float32,
                             device=device))


def _onehot_product(digits: torch.Tensor, prepared: torch.Tensor, base: int) -> torch.Tensor:
    """sum over (i, j) of the prepared row selected by digit[i, j]: (rows, m*L) float32.

    Exact in float32: operands are 0/1 and limbs in [-128, 127], and every
    partial sum is an integer below n_in*t*127 < 2^24.  The limbs need 8 bits,
    so TF32's 10-bit mantissa would hold them too; full float32 is requested
    anyway so that exactness does not rest on that.
    """
    rows = digits.shape[0]
    onehot = torch.zeros((rows, digits.shape[1] * digits.shape[2] * base),
                         dtype=torch.float32, device=digits.device)
    flat = (torch.arange(digits.shape[1] * digits.shape[2], device=digits.device)
            * base).reshape(digits.shape[1:])
    onehot.scatter_(1, (flat + digits.to(torch.int64)).reshape(rows, -1), 1.0)
    with exact_matmuls():
        return onehot @ prepared


def keyswitch_delta(digits: torch.Tensor, prepared: torch.Tensor, base: int) -> torch.Tensor:
    """sum over (i, j) of the table row that digit[i, j] selects, mod 2^32:
    (..., n_in, t) digits and the prepared rows of those n_in -> (..., m) int32."""
    n_in, t = digits.shape[-2:]
    flat = digits.reshape((-1, n_in, t))
    z = torch.cat([_onehot_product(flat[c:c + _CHUNK], prepared, base)
                   for c in range(0, flat.shape[0], _CHUNK)])
    m = prepared.shape[-1] // polymul.LIMBS
    z = z.to(torch.int32).reshape(digits.shape[:-2] + (m, polymul.LIMBS))
    return polymul.recombine_limbs(z, dim=-1)


def keyswitch_apply(ct_extracted: LweCiphertext, ks: KeySwitchKey, t: int, basebit: int,
                    prepared: torch.Tensor | None = None) -> LweCiphertext:
    """``lweKeySwitch``: (a over n_in, b) -> LWE over n_out.

    result = (0, b) - sum_{i,j} ks[i, j, digit_ij(a)].
    """
    with span("tfhe.keyswitch"):
        n_in, tt, base, m = ks.ks.shape
        assert tt == t and base == (1 << basebit)
        n_out = m - 1
        if prepared is None:
            prepared = prepare_keyswitch_matmul(ks)

        digits = keyswitch_digits(ct_extracted.a, t, basebit)      # (..., n_in, t)
        delta = keyswitch_delta(digits, prepared, base).to(torch.int64)   # (..., m)

        a = wrap32(-delta[..., :n_out])
        b = wrap32(ct_extracted.b.to(torch.int64) - delta[..., n_out])
        # Each nonzero digit subtracts one table entry and adds its variance;
        # the digit rounding adds n_in * E[s^2] * 2^(-2*t*basebit) / 12.
        nnz = (digits != 0).to(torch.float32).sum(dim=(-2, -1))
        var = (ct_extracted.current_variance + nnz * ks.variance
               + round_variance(n_in, t, basebit, nnz.device))
        return LweCiphertext(a=a, b=b, current_variance=var)
