"""The blind rotation over the stored ("compact") key: CUDA kernel and plain version.

Replaces the TPU kernel ``eoc_tfhe_tpu/ops/pallas_blindrot.py``
(``blind_rotate_pallas``, its ``pallas_call`` at line 208).  Its contract is
bits: each CMux step adds the exact negacyclic product
sum_j digits_j (*) key[i, j, u] mod 2^32 against the *stored* key, which is
the true key or, for ``limbs < 4``, the key rounded to a multiple of
2^(8*(4-limbs)).  The TPU kernel's int8 limbs, in-kernel Toeplitz blocks and
overlap-add buffer exist for its matrix unit; the port stores the key as
int32 rows and the kernel multiplies in uint32, which gives the same bits.

:func:`blind_rotate_compact` is the wrapper.  For a tensor on the CPU it
runs :func:`blind_rotate_compact_plain` (the rows scan); for a CUDA tensor it
launches the hand-written kernel in ``csrc/blind_rotate_compact.cu`` or
raises.  ``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from ..core.numeric import wrap32
from ..core.params import GateBootstrappingParams
from ..core.tgsw import decompose_h
from . import polymul, rotate

#: Number of launches of the CUDA kernel in this process.
launches = 0


def check_digit_domain(params: GateBootstrappingParams) -> None:
    """Raise where the reference's "rows" and "fused" forms are wrong.

    Both cast the gadget digits to int8 (``ops/polymul.py:134``,
    ``ops/pallas_blindrot.py:164``), which wraps for halfBg > 128 (the 80-bit
    set has halfBg = 512) and silently gives wrong bits.  The port refuses
    those parameter sets for these forms instead of copying the fault.
    """
    half = params.tgsw_params.halfBg
    if half > 128:
        raise ValueError(
            f"halfBg = {half} > 128: the compact and rows eval-key forms are exact "
            "only for int8 gadget digits; use the ntt_kernel form")


def prepare_compact_bk(bk_rows: torch.Tensor, limbs: int = polymul.LIMBS) -> torch.Tensor:
    """The stored key of the compact form: (n, kpl, k+1, N) int32.

    ``limbs == 4`` stores the true key.  ``limbs < 4`` is the reference's
    demoted rounded-key form: the key rounded (wrapping) to the nearest
    multiple of 2^(8*drop), drop = 4 - limbs, which is the key that the
    reference's kernel multiplies by when it keeps only the top limbs.
    """
    drop = polymul.LIMBS - limbs
    if not 0 <= drop < polymul.LIMBS:
        raise ValueError(f"limbs must be in 1..{polymul.LIMBS}, got {limbs}")
    if not drop:
        return bk_rows.contiguous()
    half = 1 << (8 * drop - 1)
    return wrap32((bk_rows.to(torch.int64) + half) & -(1 << (8 * drop))).contiguous()


def _shapes(acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
            params: GateBootstrappingParams):
    check_digit_domain(params)
    B, U, N = acc0.shape
    n, J, U2, N2 = key.shape
    tg = params.tgsw_params
    if not (U == U2 == tg.tlwe_params.k + 1 and N == N2 == tg.tlwe_params.N
            and J == tg.kpl and tuple(bara.shape) == (n, B)):
        raise ValueError(f"shape mismatch: acc0 {tuple(acc0.shape)}, bara "
                         f"{tuple(bara.shape)}, key {tuple(key.shape)}")
    return B, U, N, n


def cmux_rotate_step(acc: torch.Tensor, bk_row: torch.Tensor, bara_i: torch.Tensor,
                     params: GateBootstrappingParams) -> torch.Tensor:
    """One CMux step (upstream ``tfhe_MuxRotate_FFT``):
    acc <- acc + bk_i (.) ((X^{bara_i} - 1) * acc).

    Args:
      acc: (..., k+1, N) int32; bk_row: (kpl, k+1, N) int32;
      bara_i: (...) int32 in [0, 2N).
    """
    tg = params.tgsw_params
    rot = rotate.mul_by_xai(acc, bara_i[..., None])
    d = wrap32(rot.to(torch.int64) - acc.to(torch.int64))
    delta = polymul.small_by_torus_matmul(decompose_h(d, tg), bk_row, x_bound=tg.halfBg)
    return wrap32(acc.to(torch.int64) + delta.to(torch.int64))


def blind_rotate_compact_plain(acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
                               params: GateBootstrappingParams) -> torch.Tensor:
    """Plain PyTorch blind rotation: the reference's rows scan
    (``core/bootstrap.blind_rotate``) over the stored key.

    Args:
      acc0: (B, k+1, N) int32; bara: (n, B) int32 in [0, 2N);
      key: (n, kpl, k+1, N) int32 from :func:`prepare_compact_bk`.
    Returns (B, k+1, N) int32.
    """
    _, _, _, n = _shapes(acc0, bara, key, params)
    acc = acc0
    for i in range(n):
        acc = cmux_rotate_step(acc, key[i], bara[i], params)
    return acc


def _launch(acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
            params: GateBootstrappingParams) -> torch.Tensor:
    global launches
    from ..kernels import build

    B, U, N, n = _shapes(acc0, bara, key, params)
    for name, x in (("acc0", acc0), ("bara", bara), ("key", key)):
        if (x.device != acc0.device or x.dtype != torch.int32 or not x.is_contiguous()
                or x.data_ptr() % 4):
            raise ValueError(f"{name} must be a contiguous, 4-byte aligned int32 "
                             f"tensor on {acc0.device}, got {x.dtype} on {x.device}")
    out = torch.empty_like(acc0)
    tg = params.tgsw_params
    lib = build.load("blind_rotate_compact")
    stream = torch.cuda.current_stream(acc0.device).cuda_stream
    with torch.cuda.device(acc0.device):
        err = lib.blind_rotate_compact_launch(
            acc0.data_ptr(), bara.data_ptr(), key.data_ptr(), out.data_ptr(),
            B, n, U, N, tg.l, tg.Bgbit, stream)
    if err != 0:
        raise RuntimeError(f"blind_rotate_compact launch failed: CUDA error {err} "
                           f"({lib.kernel_error_string(err).decode()})")
    launches += 1
    return out


def blind_rotate_compact(acc0: torch.Tensor, bara: torch.Tensor, key: torch.Tensor,
                         params: GateBootstrappingParams) -> torch.Tensor:
    """All n CMux steps of the blind rotation over the stored key.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (no
    fallback)."""
    if acc0.device.type == "cpu":
        return blind_rotate_compact_plain(acc0, bara, key, params)
    if acc0.device.type != "cuda":
        raise ValueError(f"unsupported device {acc0.device}")
    return _launch(acc0, bara, key, params)
