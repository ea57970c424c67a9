"""Batched TGSW layer: encryption of small integers, the gadget decomposition
and the external product.

Port of ``eoc_tfhe_tpu/core/tgsw.py``.  The blind rotation fuses its own
external products (``ops/blind_rotate*.py``); :func:`tgsw_extern_mul` is the
stand-alone product, plain torch ops as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .numeric import as_u32, wrap32
from .params import TGswParams
from .tlwe import TLweCiphertext, TLweKey, tlwe_sym_encrypt_zero
from ..ops import polymul


@dataclasses.dataclass
class TGswCiphertext:
    """Batched TGSW sample(s): (k+1)*l TLWE rows."""

    rows: torch.Tensor  # (..., kpl, k+1, N) int32
    current_variance: torch.Tensor  # (...) float32

    @property
    def kpl(self) -> int:
        return self.rows.shape[-3]

    @property
    def k(self) -> int:
        return self.rows.shape[-2] - 1

    @property
    def N(self) -> int:
        return self.rows.shape[-1]


def tgsw_sym_encrypt_int(generator: torch.Generator, messages: torch.Tensor,
                         alpha: float, tgsw_key: TLweKey,
                         params: TGswParams) -> TGswCiphertext:
    """``tGswSymEncryptInt``: each of the kpl rows is a fresh zero-TLWE; row
    (bloc*l + p) gets mu * h[p] added to the constant coefficient of
    polynomial ``bloc`` (upstream ``tGswAddMuIntH``)."""
    batch_shape = tuple(messages.shape)
    kpl, k, l = params.kpl, params.tlwe_params.k, params.l
    N = params.tlwe_params.N
    rows = tlwe_sym_encrypt_zero(generator, alpha, tgsw_key, batch_shape + (kpl,)).a
    add = torch.zeros((kpl, k + 1, N), dtype=torch.int64, device=rows.device)
    for bloc in range(k + 1):
        for p in range(l):
            add[bloc * l + p, bloc, 0] = params.h[p]
    rows = wrap32(rows.to(torch.int64)
                  + messages.to(torch.int64)[..., None, None, None] * add)
    var = torch.full(batch_shape, float(np.float32(alpha) ** 2),
                     dtype=torch.float32, device=rows.device)
    return TGswCiphertext(rows=rows, current_variance=var)


def decompose_h(sample_polys: torch.Tensor, params: TGswParams) -> torch.Tensor:
    """``tGswTorus32PolynomialDecompH``: signed gadget decomposition.

    Args:
      sample_polys: (..., k+1, N) int32 torus polynomials.
    Returns:
      (..., (k+1)*l, N) int32 digits in [-Bg/2, Bg/2), ordered
      [bloc0 digit0..l-1, bloc1 digit0..l-1] to match TGSW row order.
    """
    Bgbit, l = params.Bgbit, params.l
    u = (as_u32(sample_polys) + params.offset) & 0xFFFFFFFF   # uint32 add
    shifts = torch.tensor([32 - (p + 1) * Bgbit for p in range(l)],
                          dtype=torch.int64, device=u.device)
    digits = ((u[..., None, :] >> shifts[:, None]) & params.maskMod) - params.halfBg
    kp1, N = sample_polys.shape[-2:]
    return digits.to(torch.int32).reshape(sample_polys.shape[:-2] + (kp1 * l, N))


def tgsw_extern_mul(acc: TLweCiphertext, tgsw_rows: torch.Tensor, params: TGswParams,
                    row_variance: float | torch.Tensor = 0.0) -> TLweCiphertext:
    """External product  tgsw (x) acc  (upstream ``tGswExternMulToTLwe``,
    functional: returns the product instead of accumulating in place).

    Args:
      acc: batched TLWE (..., k+1, N).
      tgsw_rows: shared TGSW rows (kpl, k+1, N) int32, as for the
        bootstrapping key.
    The variance adds the first-order term kpl * N * halfBg^2 * row_variance,
    in float32 as the reference does.
    """
    digits = decompose_h(acc.a, params)                # (..., kpl, N)
    out = polymul.small_by_torus_matmul(digits, tgsw_rows, x_bound=params.halfBg)
    kpl, N = params.kpl, params.tlwe_params.N
    row_var = torch.as_tensor(row_variance, dtype=torch.float32, device=out.device)
    var = acc.current_variance + np.float32(kpl * N * params.halfBg ** 2) * row_var
    return TLweCiphertext(a=out, current_variance=var)
