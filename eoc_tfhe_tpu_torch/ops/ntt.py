"""Exact CRT-NTT context and the NTT-domain bootstrapping key.

Port of the host-side number theory of ``eoc_tfhe_tpu/ops/ntt.py`` and of
its ``prepare_kernel_key_fast_np``, which here runs on the key's device.

The external product  sum_j digits_j (negacyclic*) bk[i, j, u]  mod 2^32 is
computed as in the reference:

1. Nussbaumer split: p(X) = sum_{r<R} X^r p_r(Z), Z = X^R, inner ring
   Z[Z]/(Z^F + 1) with F = N/R.
2. A single-stage negacyclic NTT of length F per prime (one F x F matrix).
3. CRT over two primes whose product bounds the exact integer convolution.
4. The 32-bit key split into signed limbs of ``key_limb_bits`` bits so that
   the bound in 3 holds; limb results are recombined with shifts mod 2^32.

Two key layouts, one per kernel.  The "ntt_kernel" form stores balanced
int16 residues ``(n, P, F, K, M)`` over ``KERNEL_PRIMES``, with K = J*R rows
(j, r1) and M = L*U*R columns (limb, u, s); the TPU's DMA padding has no use
here.  The "ntt_scan" form stores the same residues over ``DEFAULT_PRIMES`` as
the reference's v1 kernel key ``(n, P, F, K, 2M)`` int8, the last axis the
[lo | hi] bytes of each residue (:func:`prepare_key_ntt`), and
:func:`scan_to_v1_key` / :func:`v1_key_to_scan` carry it to and from the
reference's scan layout ``T8 (n, P, L, 2, F, J*R, U*R)``.
Only the exact plans are ported; the rounded-key plans stay demoted.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..device import resolve_device

#: The "ntt_kernel" form's prime pair (the reference's ``KERNEL_PRIMES``).
KERNEL_PRIMES = (64513, 32257)

#: The "ntt_scan" form's prime pair (the reference's ``DEFAULT_PRIMES``).
DEFAULT_PRIMES = (40961, 61441)

#: Outer split width; 8 keeps the inner NTT length at 128 for N=1024.
DEFAULT_R = 8


# --------------------------------------------------------------------------
# Host-side number theory (numpy / python ints; runs once per context).
# --------------------------------------------------------------------------

def _factorize(n: int) -> list[int]:
    out, d = [], 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return sorted(set(out))


def _find_generator(p: int) -> int:
    """Smallest generator of (Z/p)^* for prime p."""
    factors = _factorize(p - 1)
    for g in range(2, p):
        if all(pow(g, (p - 1) // q, p) != 1 for q in factors):
            return g
    raise ValueError(f"no generator found for {p}")


def _root_of_unity(p: int, order: int) -> int:
    """A primitive ``order``-th root of unity mod p (requires order | p-1)."""
    if (p - 1) % order:
        raise ValueError(f"{order} does not divide {p}-1")
    w = pow(_find_generator(p), (p - 1) // order, p)
    assert pow(w, order, p) == 1 and pow(w, order // 2, p) == p - 1
    return w


def _balanced_np(x: np.ndarray, p: int) -> np.ndarray:
    """Centered representative of x mod p in [-(p-1)/2, (p-1)/2], int64."""
    r = np.mod(x, p)
    return np.where(r > p // 2, r - p, r).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _ntt_matrices_np(p: int, F: int) -> tuple[np.ndarray, np.ndarray]:
    """(W, Winv) int64 balanced: W[t,f] = psi^{(2f+1)t}, Winv[f,t] =
    F^{-1} psi^{-(2f+1)t} — the single-stage negacyclic NTT pair mod p."""
    psi = _root_of_unity(p, 2 * F)
    t = np.arange(F, dtype=object)[:, None]
    f = np.arange(F, dtype=object)[None, :]
    W = np.vectorize(lambda tt, ff: pow(psi, int((2 * ff + 1) * tt), p))(t, f)
    psi_inv = pow(psi, p - 2, p)
    Finv = pow(F, p - 2, p)
    Winv = np.vectorize(
        lambda ff, tt: (Finv * pow(psi_inv, int((2 * ff + 1) * tt), p)) % p
    )(f.T, t.T)
    return _balanced_np(W.astype(np.int64), p), _balanced_np(Winv.astype(np.int64), p)


def _choose_key_limbs(J: int, N: int, halfBg: int,
                      primes: tuple[int, ...]) -> tuple[int, int]:
    """Smallest (limbs, bits) covering 32 bits with the CRT bound met:
    2 * J * N * halfBg * limb_max < prod(primes), limb_max = 2^(bits-1) + 1."""
    P = int(np.prod([int(p) for p in primes], dtype=object))
    for limbs in (2, 3, 4, 6, 8):
        bits = -(-32 // limbs)
        limb_max = (1 << (bits - 1)) + 1
        if limb_max > 32639:
            continue
        if 2 * J * N * halfBg * limb_max < P:
            return limbs, bits
    raise ValueError(
        f"no key-limb split satisfies the CRT bound for J={J} N={N} halfBg={halfBg}")


# --------------------------------------------------------------------------
# Context
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NttContext:
    """Transform matrices (balanced residues, on the device) and the plan."""

    W: torch.Tensor      # (P, F, F) int16, W[p, t, f]
    Winv: torch.Tensor   # (P, F, F) int16, Winv[p, f, t]
    omega: torch.Tensor  # (P, F) int32, psi^{2f+1} balanced
    N: int
    R: int
    F: int
    primes: tuple[int, ...]
    key_limbs: int
    key_limb_bits: int
    halfBg: int
    J: int

    @property
    def crt_inv(self) -> int:
        """p1^{-1} mod p2, balanced."""
        p1, p2 = self.primes
        return int(_balanced_np(np.int64(pow(p1, p2 - 2, p2)), p2))


def make_context(N: int, J: int, halfBg: int, primes: tuple[int, int],
                 device=None) -> NttContext:
    """NTT context for degree N, gadget width J = kpl, digit bound halfBg over
    a CRT prime pair, with the reference's default outer split R."""
    dev = resolve_device(device)
    primes = tuple(primes)
    if len(primes) != 2:
        raise ValueError("the CRT step takes exactly two primes")
    R = min(DEFAULT_R, N)
    while N // R < R and R > 1:
        R //= 2
    F = N // R
    limbs, bits = _choose_key_limbs(J, N, halfBg, primes)
    mats = [_ntt_matrices_np(p, F) for p in primes]
    omegas = []
    for p in primes:
        psi = _root_of_unity(p, 2 * F)
        om = np.array([pow(psi, 2 * f + 1, p) for f in range(F)], dtype=np.int64)
        omegas.append(_balanced_np(om, p))

    def t16(x):
        return torch.from_numpy(np.stack(x).astype(np.int16)).to(dev)

    return NttContext(W=t16([W for W, _ in mats]), Winv=t16([Wi for _, Wi in mats]),
                      omega=torch.from_numpy(np.stack(omegas).astype(np.int32)).to(dev),
                      N=N, R=R, F=F, primes=primes, key_limbs=limbs,
                      key_limb_bits=bits, halfBg=halfBg, J=J)


def kernel_context(N: int, J: int, halfBg: int, device=None) -> NttContext:
    """NttContext with the kernel's prime pair."""
    return make_context(N, J, halfBg, KERNEL_PRIMES, device=device)


def kernel_context_for_params(params, device=None) -> NttContext:
    """Kernel context for a GateBootstrappingParams (J = kpl, bound halfBg)."""
    tg = params.tgsw_params
    return kernel_context(N=tg.tlwe_params.N, J=tg.kpl, halfBg=tg.halfBg,
                          device=device)


def context_for_params(params, device=None) -> NttContext:
    """The "ntt_scan" form's context for a GateBootstrappingParams: the exact
    plan over ``DEFAULT_PRIMES`` (the reference's ``context_for_params``)."""
    tg = params.tgsw_params
    return make_context(N=tg.tlwe_params.N, J=tg.kpl, halfBg=tg.halfBg,
                        primes=DEFAULT_PRIMES, device=device)


# --------------------------------------------------------------------------
# Exact modular arithmetic on tensors
# --------------------------------------------------------------------------

def balanced_mod(z: torch.Tensor, p: int) -> torch.Tensor:
    """Centered z mod p in [-(p-1)/2, (p-1)/2] as int64.  ``z`` is int64, or
    float64 holding exact integers (|z| < 2^53)."""
    r = torch.remainder(z.to(torch.int64), p)
    return torch.where(r > p // 2, r - p, r)


def _bal_f64(z: torch.Tensor, p: int) -> torch.Tensor:
    """z - rint(z / p) * p for float64 z holding exact integers: the
    reference's rounding step, kept so the prepared key matches it bit for bit."""
    return z - torch.round(z * (1.0 / p)) * p


def prepare_kernel_key(bk_rows: torch.Tensor, ctx: NttContext) -> torch.Tensor:
    """(n, J, U, N) int32 TGSW rows -> (n, P, F, K=J*R, M=L*U*R) int16 NTT key.

    key[i, p, f, (j, r1), (l, u, s)] is the NTT (prime p, frequency f) of
    Z^{wrap} * limb_l(bk[i, j, u])_{(s - r1) mod R}: the outer-twisted
    contraction tensor the blind rotation multiplies the digit transforms by.
    Runs on the rows' device.  Every float64 step holds exact integers
    (|limb| <= 2^10 + 1, |W| < 2^15, F <= 128 => |sum| < 2^32).
    """
    n, J, U, N = bk_rows.shape
    R, F, L, bits = ctx.R, ctx.F, ctx.key_limbs, ctx.key_limb_bits
    assert J == ctx.J and N == ctx.N
    dev = bk_rows.device

    # signed base-2^bits limbs, borrow-carried (arithmetic shifts on int64)
    out, c = [], bk_rows.to(torch.int64)
    base, half = 1 << bits, 1 << (bits - 1)
    for _ in range(L - 1):
        m = c & (base - 1)
        borrow = (m >= half).to(torch.int64)
        out.append(m - borrow * base)
        c = (c >> bits) + borrow
    out.append(c)
    kl = torch.stack(out)                                     # (L, n, J, U, N)
    sub = kl.reshape(L, n, J, U, F, R).transpose(-1, -2).to(torch.float64)

    # V[r1, s] = ext[R - r1 + s] with ext = [omega * bhat | bhat] on the subpoly
    # axis: multiplying a subpolynomial by Z is the omega twist in NTT domain.
    r1 = torch.arange(R, device=dev)[:, None]
    s = torch.arange(R, device=dev)[None, :]
    win = (R - r1 + s).reshape(-1)
    keys = []
    for pi, p in enumerate(ctx.primes):
        bhat = _bal_f64(sub @ ctx.W[pi].to(torch.float64), p)   # (L,n,J,U,R,F)
        twb = _bal_f64(bhat * ctx.omega[pi].to(torch.float64), p)
        ext = torch.cat([twb, bhat], dim=-2).to(torch.int16)   # (L,n,J,U,2R,F)
        V = ext[..., win, :].reshape(L, n, J, U, R, R, F)      # (L,n,J,U,r1,s,F)
        keys.append(V.permute(1, 6, 2, 4, 0, 3, 5).reshape(n, F, J * R, L * U * R))
    return torch.stack(keys, dim=1).contiguous()


# --------------------------------------------------------------------------
# The "ntt_scan" form's key: int8 byte pairs in the v1 kernel's layout
# --------------------------------------------------------------------------

def split_key_bytes(key: torch.Tensor) -> torch.Tensor:
    """(..., M) int16 balanced residues -> (..., 2M) int8 [lo | hi] with
    x = lo + 256 * hi and lo in [-128, 127] (the reference's ``split_i8``)."""
    x = key.to(torch.int32)
    lo = ((x + 128) & 255) - 128
    hi = (x - lo) >> 8
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def join_key_bytes(key8: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_key_bytes`: (..., 2M) int8 -> (..., M) int16."""
    M = key8.shape[-1] // 2
    return key8[..., :M].to(torch.int16) + 256 * key8[..., M:].to(torch.int16)


def prepare_key_ntt(bk_rows: torch.Tensor, ctx: NttContext) -> torch.Tensor:
    """(n, J, U, N) int32 TGSW rows -> the "ntt_scan" key (n, P, F, K, 2M) int8.

    The bits of ``pallas_ntt_blindrot.prepare_kernel_key(ntt.prepare_key_ntt_np(
    rows, ctx).T8)`` of the reference: :func:`prepare_kernel_key`'s residues,
    each split into its two bytes.  Runs on the rows' device.
    """
    return split_key_bytes(prepare_kernel_key(bk_rows, ctx)).contiguous()


def scan_to_v1_key(T8: torch.Tensor) -> torch.Tensor:
    """The reference's scan key ``T8`` (n, P, L, 2, F, J*R, U*R) int8 -> the
    v1 layout (n, P, F, J*R, 2*L*U*R) (its ``prepare_kernel_key_np``)."""
    n, P, L, two, F, JR, UR = T8.shape
    if two != 2:
        raise ValueError(f"T8 must hold [lo, hi] byte pairs on axis 3, got {tuple(T8.shape)}")
    return T8.permute(0, 1, 4, 5, 3, 2, 6).reshape(n, P, F, JR, 2 * L * UR).contiguous()


def v1_key_to_scan(key8: torch.Tensor, ctx: NttContext) -> torch.Tensor:
    """Inverse of :func:`scan_to_v1_key`: (n, P, F, J*R, 2*L*U*R) int8 ->
    ``T8`` (n, P, L, 2, F, J*R, U*R) (the reference's ``kernel_key_to_scan``
    without the padding of its later kernel)."""
    n, P, F, JR, M2 = key8.shape
    L = ctx.key_limbs
    if M2 % (2 * L * ctx.R):
        raise ValueError(f"key last axis {M2} is not a multiple of 2 * {L} * {ctx.R}")
    x = key8.reshape(n, P, F, JR, 2, L, M2 // (2 * L))
    return x.permute(0, 1, 5, 4, 2, 3, 6).contiguous()
