"""Exact negacyclic polynomial products mod 2^32.

Port of ``eoc_tfhe_tpu/ops/polymul.py``: the signed byte-limb split (used
by the keyswitch table), the keygen-side product of torus masks with the
small shared key, and the external product of the rows scan.  CUDA has no
integer matmul, so the products are float64 matmuls of integers whose every
partial sum stays below 2^53, or int64 sums.
"""

from __future__ import annotations

import torch

from ..core.numeric import wrap32

LIMBS = 4


def decompose_signed_limbs(y: torch.Tensor, num_limbs: int = LIMBS) -> torch.Tensor:
    """Split int32 into ``num_limbs`` signed base-256 limbs, top limb wrapped.

    Returns int32 values in [-128, 127] with
    ``sum_t limbs[..., t] << (8 t) == y (mod 2**32)``.
    """
    c = y.to(torch.int64)
    limbs = []
    for t in range(num_limbs):
        limb = ((c + 128) & 255) - 128
        if t < num_limbs - 1:
            c = (c - limb) >> 8
        limbs.append(limb)
    return torch.stack(limbs, dim=-1).to(torch.int32)


def recombine_limbs(z: torch.Tensor, dim: int) -> torch.Tensor:
    """Inverse of :func:`decompose_signed_limbs` modulo 2**32 along ``dim``."""
    parts = torch.movedim(z.to(torch.int64), dim, 0)
    out = torch.zeros_like(parts[0])
    for t in range(parts.shape[0]):
        out = out + (parts[t] << (8 * t))
    return wrap32(out)


def negacyclic_toeplitz(y: torch.Tensor, cols: tuple[int, int] | None = None) -> torch.Tensor:
    """(..., N) -> (..., N, N) with M[..., r, c] = ext[(c - r) mod 2N], ext = [y, -y],
    so that (x * y)[c] = sum_r x[r] M[r, c] in Z[X]/(X^N + 1).  ``cols`` =
    (c0, c1) gives the columns c0 <= c < c1 alone, (..., N, c1 - c0)."""
    N = y.shape[-1]
    c0, c1 = (0, N) if cols is None else cols
    ext = torch.cat([y, -y], dim=-1)
    r = torch.arange(N, device=y.device)[:, None]
    c = torch.arange(c0, c1, device=y.device)[None, :]
    return ext[..., (c - r) % (2 * N)]


#: Output coefficients of :func:`torus_by_small_shared_matmul` a float64
#: Toeplitz block holds: the whole (J N, N) block is 34 GB at N = 65536 (and
#: its int64 index as much), past the card's memory.
TOEPLITZ_COLS = 4096


def torus_by_small_shared_matmul(a_torus: torch.Tensor,
                                 key_small: torch.Tensor) -> torch.Tensor:
    """Exact  out[..., :] = sum_j a_torus[..., j, :] (negacyclic*) key_small[j, :].

    The keygen-side product (upstream ``tLweSymEncryptZero``).  Float64
    matmuls against the negacyclic Toeplitz of the binary key, a block of
    ``TOEPLITZ_COLS`` output coefficients at a time: every term is an int32
    times 0 or +-1, so |sum| <= J*N*2^31 < 2^53 and float64 holds it
    exactly in any summation order; the result is reduced mod 2^32.

    Args:
      a_torus:  (..., J, N) int32 torus polynomials.
      key_small: (J, N) int32 in {0, 1}.
    Returns:
      (..., N) int32.
    """
    J, N = key_small.shape
    assert a_torus.shape[-2:] == (J, N)
    if J * N * 2**31 >= 2**53:
        raise ValueError(f"J*N = {J * N} too large for an exact float64 product")
    x = a_torus.reshape(-1, J * N).to(torch.float64)
    z = torch.empty((x.shape[0], N), dtype=torch.int64, device=x.device)
    for c0 in range(0, N, TOEPLITZ_COLS):
        c1 = min(N, c0 + TOEPLITZ_COLS)
        M = negacyclic_toeplitz(key_small, (c0, c1)).to(torch.float64).reshape(J * N, c1 - c0)
        z[:, c0:c1] = (x @ M).to(torch.int64)
    return wrap32(z).reshape(a_torus.shape[:-2] + (N,))


def negacyclic_extend(p: torch.Tensor) -> torch.Tensor:
    """(..., N) -> (..., 2N) doubled vector [p, -p] (int32 wraparound, as the
    reference)."""
    return torch.cat([p, wrap32(-p.to(torch.int64))], dim=-1)


def negacyclic_polymul_exact(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact negacyclic product of two int32 polynomials mod 2^32.

    Broadcasts over leading dims.  Not a fast path: the full Toeplitz of
    ``y`` is contracted with the 16-bit halves of ``x`` as int64 sums
    (|term| < 2^47, so N < 2^16 terms stay below 2^63).
    """
    N = y.shape[-1]
    if N >= 1 << 16:
        raise ValueError(f"N = {N} too large for exact int64 sums")
    M = negacyclic_toeplitz(y.to(torch.int64))                 # (..., N_r, N_c)
    x = x.to(torch.int64) & 0xFFFFFFFF
    lo, hi = x & 0xFFFF, x >> 16
    z = ((lo[..., :, None] * M).sum(-2)
         + (((hi[..., :, None] * M).sum(-2) & 0xFFFFFFFF) << 16))
    return wrap32(z)


def small_by_torus_matmul(x_small: torch.Tensor, y_torus: torch.Tensor,
                          x_bound: int = 128) -> torch.Tensor:
    """Exact  out[..., u, :] = sum_j x_small[..., j, :] (negacyclic*) y_torus[j, u, :].

    The external product of the rows scan (upstream ``tGswFFTExternMulToTLwe``):
    gadget digits (|x| <= ``x_bound``) against the shared TGSW rows.  One
    float64 matmul per row j against the negacyclic Toeplitz of that row (an
    (N, U*N) block, so that N = 4096 needs 268 MB a block, not J times that):
    each term is at most x_bound * 2^31 and there are N of them, so every
    partial sum is an integer below 2^53 and float64 holds it exactly in any
    order; the rows' sums are added in int64 and reduced mod 2^32.

    The reference casts the digits to int8 and accumulates in int32; both
    bounds are checked here, and a digit bound above 128 (where the
    reference's int8 cast wraps and its result is wrong) raises.

    Args:
      x_small: (..., J, N) int32 digits.
      y_torus: (J, U, N) int32.
    Returns:
      (..., U, N) int32.
    """
    J, U, N = y_torus.shape
    if tuple(x_small.shape[-2:]) != (J, N):
        raise ValueError(f"shape mismatch: {tuple(x_small.shape)} vs {tuple(y_torus.shape)}")
    if x_bound > 128:
        raise ValueError(f"digit bound {x_bound} > 128: the reference's int8 digits "
                         "wrap there (halfBg must be <= 128)")
    if J * N * x_bound * 128 >= 2**31:
        raise ValueError("int32 accumulation of the reference would overflow")
    if N * x_bound * 2**31 >= 2**53:
        raise ValueError(f"N*x_bound = {N * x_bound} too large for exact float64 sums")
    batch_shape = tuple(x_small.shape[:-2])
    x = x_small.reshape(-1, J, N).to(torch.float64)
    z = None
    for j in range(J):
        M = negacyclic_toeplitz(y_torus[j])                   # (U, N_r, N_c)
        M = M.permute(1, 0, 2).reshape(N, U * N).to(torch.float64)
        zj = (x[:, j] @ M).to(torch.int64)
        z = zj if z is None else z + zj
    return wrap32(z).reshape(batch_shape + (U, N))
