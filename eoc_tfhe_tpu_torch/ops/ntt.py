"""Exact CRT-NTT context and the NTT-domain bootstrapping key.

Port of the host-side number theory of ``eoc_tfhe_tpu/ops/ntt.py`` and of
its ``prepare_kernel_key_fast_np``, which here runs on the key's device.

The external product  sum_j digits_j (negacyclic*) bk[i, j, u]  mod 2^32 is
computed as in the reference:

1. Nussbaumer split: p(X) = sum_{r<R} X^r p_r(Z), Z = X^R, inner ring
   Z[Z]/(Z^F + 1) with F = N/R.
2. A single-stage negacyclic NTT of length F per prime (one F x F matrix).
3. CRT over two primes whose product bounds the exact integer convolution
   (three in :func:`wide_context`, the compact form's plain plan from
   N = 32768 on).
4. The 32-bit key split into signed limbs of ``key_limb_bits`` bits so that
   the bound in 3 holds; limb results are recombined with shifts mod 2^32.

Two key layouts, one per kernel.  The "ntt_kernel" form stores the balanced
residues ``(n, P, F, K, M)`` over ``KERNEL_PRIMES`` (:func:`kernel_key_residues`),
with K = J*R rows (j, r1) and M = L*U*R columns (limb, u, s), as the byte
planes of the int8 tensor-core fragments its kernel reads
(:func:`prepare_kernel_key`, :func:`unpack_kernel_key`), K and M padded to
the kernel's 16-row tiles (the TPU's wider DMA padding has no use here).
The "ntt_scan" form stores the same residues over
``DEFAULT_PRIMES`` as the reference's v1 kernel key ``(n, P, F, K, 2M)`` int8,
the last axis the [lo | hi] bytes of each residue (:func:`prepare_key_ntt`),
and :func:`scan_to_v1_key` / :func:`v1_key_to_scan` carry it to and from the
reference's scan layout ``T8 (n, P, L, 2, F, J*R, U*R)``.

Both forms take the reference's rounded-key plans too
(:func:`choose_rounded_plan`): the key rounded to its top 32 - rb bits
(:func:`round_key`) before the limb split, so that fewer limbs meet the CRT
bound; limb l then carries scale 2^(rb + bits*l) (``NttContext.key_round_bits``).
At the shipped sets the plan is exact (rb = 0).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.numeric import wrap32
from ..device import resolve_device

#: The "ntt_kernel" form's prime pair (the reference's ``KERNEL_PRIMES``).
KERNEL_PRIMES = (64513, 32257)

#: The "ntt_scan" form's prime pair (the reference's ``DEFAULT_PRIMES``).
DEFAULT_PRIMES = (40961, 61441)

#: Outer split width; 8 keeps the inner NTT length at 128 for N=1024.
DEFAULT_R = 8

#: The compact form's exact plain product past the "ntt_scan" form's contexts
#: (:func:`wide_context`): ``DEFAULT_PRIMES`` and a third prime, 12289 = 3 *
#: 2^12 + 1, each with a 2F-th root at the inner length ``WIDE_F``.
WIDE_PRIMES = DEFAULT_PRIMES + (12289,)
WIDE_F = 2048

#: Version of the port's prepared-key layouts (the "ntt_kernel" form's
#: fragment-order byte planes, the "ntt_scan" form's v1 byte pairs).  The
#: prepared-key cache (``core/bootstrap``) names its files by it, so a file of
#: another layout is never loaded.
KEY_LAYOUT_VERSION = 1


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
    psi_inv = pow(psi, p - 2, p)
    Finv = pow(F, p - 2, p)
    # psi has order 2F: psi^e = pw[e mod 2F], one table of powers a direction
    pw, pw_inv = np.ones(2 * F, dtype=np.int64), np.ones(2 * F, dtype=np.int64)
    for e in range(1, 2 * F):
        pw[e], pw_inv[e] = pw[e - 1] * psi % p, pw_inv[e - 1] * psi_inv % p
    t = np.arange(F, dtype=np.int64)[:, None]
    f = np.arange(F, dtype=np.int64)[None, :]
    W = pw[(2 * f + 1) * t % (2 * F)]                       # [t, f]
    Winv = Finv * pw_inv[(2 * f.T + 1) * t.T % (2 * F)] % p   # [f, t]
    return _balanced_np(W, p), _balanced_np(Winv, p)


def _choose_key_limbs(J: int, N: int, halfBg: int, primes: tuple[int, ...],
                      cover_bits: int = 32) -> tuple[int, int]:
    """Smallest (limbs, bits) covering ``cover_bits`` with the CRT bound met:
    2 * J * N * halfBg * limb_max < prod(primes), limb_max = 2^(bits-1) + 1.
    ``cover_bits < 32`` is the rounded-key plan: the key is first rounded to
    its top ``cover_bits`` bits and the limbs cover only those."""
    P = int(np.prod([int(p) for p in primes], dtype=object))
    for limbs in (2, 3, 4, 6, 8):
        bits = -(-cover_bits // limbs)
        limb_max = (1 << (bits - 1)) + 1
        if limb_max > 32639:
            continue
        if 2 * J * N * halfBg * limb_max < P:
            return limbs, bits
    raise ValueError(
        f"no key-limb split satisfies the CRT bound for J={J} N={N} halfBg={halfBg}")


def choose_round_bits(J: int, N: int, halfBg: int,
                      primes: tuple[int, ...] = DEFAULT_PRIMES, limbs: int = 2) -> int:
    """Smallest key rounding ``rb`` such that ``limbs`` limbs of
    ceil((32 - rb) / limbs) bits meet the CRT bound; raises if none does."""
    P = int(np.prod([int(p) for p in primes], dtype=object))
    for rb in range(0, 24):
        bits = -(-(32 - rb) // limbs)
        limb_max = (1 << (bits - 1)) + 1
        if limb_max <= 32639 and 2 * J * N * halfBg * limb_max < P:
            return rb
    raise ValueError(
        f"no {limbs}-limb rounded plan satisfies the CRT bound for "
        f"J={J} N={N} halfBg={halfBg} primes={primes}")


def choose_rounded_plan(J: int, N: int, halfBg: int, n_steps: int, bk_variance: float,
                        primes: tuple[int, ...] = DEFAULT_PRIMES) -> int:
    """Key rounding ``rb`` of the fewest-limb plan whose rounding noise is
    acceptable, or 0 (exact).  The rounding error is fixed per key and the
    digits it meets repeat across the n steps, so it adds coherently (~n^2):
    a plan is taken where that variance is at most twice the inherent one
    (the reference's rule, which rejects every sub-exact plan at the shipped
    sets)."""
    inherent = n_steps * J * N * ((2.0 * halfBg) ** 2 / 12.0) * bk_variance
    for limbs in (2, 3, 4):
        try:
            rb = choose_round_bits(J, N, halfBg, primes, limbs)
        except ValueError:
            continue
        if rb == 0:
            return 0
        round_var = (float(n_steps) ** 2 * J * N * float(halfBg ** 2)
                     * (float(1 << (2 * rb)) / 12.0) / float(2 ** 64))
        if round_var <= 2.0 * inherent:
            return rb
    return 0


def round_key(bk: torch.Tensor, rb: int) -> torch.Tensor:
    """A torus int32 key (any integer dtype) rounded to its top 32 - rb bits,
    nearest with ties up: (bk >> rb) + bit rb-1 of bk.  rb = 0 returns ``bk``."""
    if rb == 0:
        return bk
    return (bk >> rb) + ((bk >> (rb - 1)) & 1)


# --------------------------------------------------------------------------
# Context
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NttContext:
    """Transform matrices (balanced residues, on the device) and the plan."""

    W: torch.Tensor      # (P, F, F) int16, W[p, t, f]
    Winv: torch.Tensor   # (P, F, F) int16, Winv[p, f, t]
    omega: torch.Tensor  # (P, F) int32, psi^{2f+1} balanced
    #: (P, FP/8, FP/32, 32, 4, 8) int8, mma_b_fragments of W (None in the
    #: plain-only :func:`wide_context`, which no kernel reads)
    W_mma: torch.Tensor | None
    Winv_mma: torch.Tensor | None   # the same of Winv
    N: int
    R: int
    F: int
    primes: tuple[int, ...]
    key_limbs: int
    key_limb_bits: int
    halfBg: int
    J: int
    #: Key rounding bits (0: exact mod 2^32).  When > 0 the key is rounded to
    #: its top 32 - rb bits before the limb split, and limb l carries scale
    #: 2^(rb + key_limb_bits * l) in the recombination.
    key_round_bits: int = 0

    @property
    def crt_inv(self) -> int:
        """p1^{-1} mod p2, balanced."""
        p1, p2 = self.primes
        return int(_balanced_np(np.int64(pow(p1, p2 - 2, p2)), p2))


def _outer_split(N: int) -> int:
    """The reference's default outer split R for degree N (F = N/R >= R
    where N allows it)."""
    R = min(DEFAULT_R, N)
    while N // R < R and R > 1:
        R //= 2
    return R


def make_context(N: int, J: int, halfBg: int, primes: tuple[int, int],
                 device=None, key_round_bits: int = 0) -> NttContext:
    """NTT context for degree N, gadget width J = kpl, digit bound halfBg over
    a CRT prime pair, with the reference's default outer split R.
    ``key_round_bits > 0`` selects the rounded-key plan."""
    primes = tuple(primes)
    if len(primes) != 2:
        raise ValueError("the CRT step takes exactly two primes")
    return _context(N, _outer_split(N), J, halfBg, primes, device, key_round_bits)


def wide_context(N: int, J: int, halfBg: int, device=None) -> NttContext:
    """The exact plan of the compact form's plain product from N = 32768 on,
    where the "ntt_scan" form's context has no root (F = N/8 = 4096: "8192
    does not divide 61441-1", in both packages): inner length ``WIDE_F`` and
    outer split R = N / WIDE_F over the three ``WIDE_PRIMES``.

    Why a third prime and not a larger R over ``DEFAULT_PRIMES`` alone: the
    CRT bound 2 J N halfBg limb_max < prod(primes) grows with N, and the two
    primes' 2.5e9 needs 8 key limbs at N = 65536, J = 15, halfBg = 128 and
    has no split at J = 20 (k = 4, l = 4, Bgbit = 8).  Three primes (3.1e13)
    meet it with three 11-bit limbs up to N = 2^22 at every k <= 4, l Bgbit
    <= 32 and halfBg <= 128 (J halfBg <= 2560), and with more limbs past
    that, so the product has no ring ceiling.  Exact by construction: every
    float64 product sums integers below 2^53 (forward F 2^7 2^15, pointwise
    J R 2^30, inverse and the key's transform F 2^30, with F = 2048), the
    CRT is in int64 (:func:`crt`, |V| < 2^45) and the limb sum mod 2^32
    (:func:`limb_sum`).  Plain only: it carries no MMA fragments."""
    return _context(N, max(1, N // WIDE_F), J, halfBg, WIDE_PRIMES, device, 0,
                    fragments=False)


def _context(N: int, R: int, J: int, halfBg: int, primes: tuple[int, ...], device,
             key_round_bits: int, fragments: bool = True) -> NttContext:
    dev = resolve_device(device)
    F = N // R
    limbs, bits = _choose_key_limbs(J, N, halfBg, primes, cover_bits=32 - key_round_bits)
    mats = [_ntt_matrices_np(p, F) for p in primes]
    omegas = []
    for p in primes:
        psi = _root_of_unity(p, 2 * F)
        om = np.array([pow(psi, 2 * f + 1, p) for f in range(F)], dtype=np.int64)
        omegas.append(_balanced_np(om, p))

    def t16(x):
        return torch.from_numpy(np.stack(x).astype(np.int16)).to(dev)

    def frags(i):
        if not fragments:
            return None
        return torch.stack([mma_b_fragments(torch.from_numpy(m[i]), p)
                            for m, p in zip(mats, primes)]).to(dev)

    return NttContext(W=t16([W for W, _ in mats]), Winv=t16([Wi for _, Wi in mats]),
                      omega=torch.from_numpy(np.stack(omegas).astype(np.int32)).to(dev),
                      W_mma=frags(0), Winv_mma=frags(1),
                      N=N, R=R, F=F, primes=primes, key_limbs=limbs,
                      key_limb_bits=bits, halfBg=halfBg, J=J, key_round_bits=key_round_bits)


def kernel_context(N: int, J: int, halfBg: int, device=None,
                   key_round_bits: int = 0) -> NttContext:
    """NttContext with the kernel's prime pair.  Raises, naming K1 and the
    prime, where ``KERNEL_PRIMES`` has no 2F-th root of unity (N = 4096: F =
    512 and 1024 does not divide 32257 - 1), as the reference's raises."""
    F = N // _outer_split(N)
    for p in KERNEL_PRIMES:
        if (p - 1) % (2 * F):
            raise ValueError(
                f"K1 (blind_rotate_ntt) has no context at N={N}: its prime {p} has no "
                f"{2 * F}th root of unity ({2 * F} does not divide {p}-1; F = N/R = {F}), "
                f"as in the reference; the ntt_scan form's DEFAULT_PRIMES have one")
    return make_context(N, J, halfBg, KERNEL_PRIMES, device=device,
                        key_round_bits=key_round_bits)


def _rounded_bits(params, rounded: bool, primes: tuple[int, int]) -> int:
    """The key rounding of ``params``'s plan over ``primes``: 0 unless
    ``rounded``, then :func:`choose_rounded_plan` at the set's depth and key
    noise."""
    if not rounded:
        return 0
    tg = params.tgsw_params
    return choose_rounded_plan(tg.kpl, tg.tlwe_params.N, tg.halfBg, n_steps=params.n,
                               bk_variance=float(tg.tlwe_params.alpha_min) ** 2,
                               primes=primes)


def kernel_context_for_params(params, rounded: bool = False, device=None) -> NttContext:
    """Kernel context for a GateBootstrappingParams (J = kpl, bound halfBg);
    ``rounded=True`` takes the rounded-key plan over ``KERNEL_PRIMES`` (the
    reference's ``pallas_ntt_blindrot2.kernel_context_for_params``)."""
    tg = params.tgsw_params
    return kernel_context(N=tg.tlwe_params.N, J=tg.kpl, halfBg=tg.halfBg, device=device,
                          key_round_bits=_rounded_bits(params, rounded, KERNEL_PRIMES))


def context_for_params(params, rounded: bool = False, device=None) -> NttContext:
    """The "ntt_scan" form's context for a GateBootstrappingParams over
    ``DEFAULT_PRIMES``: the exact plan, or with ``rounded=True`` the
    rounded-key one (the reference's ``context_for_params``)."""
    tg = params.tgsw_params
    return make_context(N=tg.tlwe_params.N, J=tg.kpl, halfBg=tg.halfBg,
                        primes=DEFAULT_PRIMES, device=device,
                        key_round_bits=_rounded_bits(params, rounded, DEFAULT_PRIMES))


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


# --------------------------------------------------------------------------
# The external product's stages as torch ops (the reference's XLA path,
# ``ops/ntt.py:331-480, 654-700``).  Every product is a float64 matmul of
# exact integers below 2^53 followed by an integer reduction, so each stage
# gives the reference's balanced residues; the reference's int8 limb split
# (``split_i8``) and its float32 ``balanced_reduce`` are how its matrix unit
# reaches the same residues, and are ``split_bytes`` and ``balanced_mod`` here.
# --------------------------------------------------------------------------

def mod_matmul(x: torch.Tensor, W: torch.Tensor, p: int) -> torch.Tensor:
    """Balanced (x @ W) mod p as int64, batched as ``torch.matmul`` batches.

    ``W`` may be any column slice of a transform matrix (the frequency-split
    tp path takes its frequencies' columns).  Exact in float64 while
    K * max|x| * max|W| < 2^53: residues below 2^15 and K <= 2^22.
    """
    return balanced_mod(x.to(torch.float64) @ W.to(torch.float64), p)


def to_subpolys(x: torch.Tensor, R: int) -> torch.Tensor:
    """(..., N) -> (..., R, F): subpoly r holds the coefficients of X^(tR+r)."""
    N = x.shape[-1]
    return x.reshape(x.shape[:-1] + (N // R, R)).transpose(-1, -2)


def from_subpolys(x: torch.Tensor) -> torch.Tensor:
    """(..., R, F) -> (..., N): inverse of :func:`to_subpolys`."""
    R, F = x.shape[-2:]
    return x.transpose(-1, -2).reshape(x.shape[:-2] + (R * F,))


def ntt_inverse_prime(xhat: torch.Tensor, ctx: NttContext, prime_idx: int) -> torch.Tensor:
    """Inverse negacyclic NTT along the last axis for one prime (int64)."""
    return mod_matmul(xhat, ctx.Winv[prime_idx], ctx.primes[prime_idx])


def crt(res: list[torch.Tensor], ctx: NttContext) -> torch.Tensor:
    """The exact integer (|V| < prod(primes) / 2) of balanced residues over
    any number of primes, int64: Garner's mixed radix with balanced digits
    (for two primes r0 + balanced_mod((r1 - r0) crt_inv, p2) p1)."""
    V, m = res[0], 1
    for p_prev, p, r in zip(ctx.primes, ctx.primes[1:], res[1:]):
        m *= p_prev
        inv = pow(m, -1, p)
        V = V + m * balanced_mod(balanced_mod(r - V, p) * inv, p)
    return V


def limb_sum(V: torch.Tensor, ctx: NttContext, dim: int) -> torch.Tensor:
    """sum_l V[l] * 2^(key_round_bits + key_limb_bits * l) mod 2^32 over the
    key-limb axis ``dim`` of the CRT'd values: the product with the whole
    (rounded) 32-bit key.  Each part is taken mod 2^32 before its shift, so
    no int64 product leaves int64 (three primes' values reach 2^44)."""
    parts = torch.movedim(V, dim, 0)
    out = torch.zeros_like(parts[0])
    for li in range(parts.shape[0]):
        shift = ctx.key_round_bits + ctx.key_limb_bits * li
        out = out + (((parts[li] & 0xFFFFFFFF) << shift) & 0xFFFFFFFF)
    return wrap32(out)


def external_product_ntt(digits: torch.Tensor, key_step: torch.Tensor,
                         ctx: NttContext) -> torch.Tensor:
    """Exact  sum_j digits[b, j] (negacyclic*) bk_step[j, u]  mod 2^32.

    ``digits`` may hold any run of whole gadget rows j and ``key_step`` the
    matching key rows: K = (j, r1) is j-major, so the rows of J' digits are a
    contiguous J'*R of K, and the product over them is the partial sum the
    TGSW-row tp path reduces across ranks.  Every stage is exact in float64
    (|digit| <= halfBg and |residue| < 2^15: forward < 2^31, pointwise
    K 2^30, inverse F 2^30).

    Args:
      digits: (B, J', N) int32 gadget digits, |digit| <= halfBg.
      key_step: (P, F, J'*R, M) int16, one step of the prepared key's rows.
    Returns (B, U, N) int32, U = M / (L*R).
    """
    B, J, _ = digits.shape
    R, F, L = ctx.R, ctx.F, ctx.key_limbs
    K, M = key_step.shape[2:]
    if K != J * R:
        raise ValueError(f"key rows {K} != {J} digit rows x R={R}")
    U = M // (L * R)
    sub = to_subpolys(digits, R)                                       # (B,J,R,F)
    res = []
    for pi, p in enumerate(ctx.primes):
        dhat = mod_matmul(sub, ctx.W[pi], p).reshape(B, K, F).permute(2, 0, 1)   # (F,B,K)
        chat = mod_matmul(dhat, key_step[pi], p).permute(1, 2, 0)      # (B,M,F)
        res.append(ntt_inverse_prime(chat, ctx, pi))
    V = crt(res, ctx).reshape(B, L, U, R, F)
    return from_subpolys(limb_sum(V, ctx, dim=1))                      # index m = t*R + s


def kernel_key_residues(bk_rows: torch.Tensor, ctx: NttContext) -> torch.Tensor:
    """(n, J, U, N) int32 TGSW rows -> (n, P, F, K=J*R, M=L*U*R) int16 NTT key.

    key[i, p, f, (j, r1), (l, u, s)] is the NTT (prime p, frequency f) of
    Z^{wrap} * limb_l(bk[i, j, u])_{(s - r1) mod R}: the outer-twisted
    contraction tensor the blind rotation multiplies the digit transforms by.
    A rounded plan (``ctx.key_round_bits``) rounds the rows first
    (:func:`round_key`).  Runs on the rows' device.  Every float64 step holds
    exact integers (|limb| <= 2^15 + 1, |W| < 2^15, F <= 2048 => |sum| < 2^42).
    """
    n, J, U, N = bk_rows.shape
    R, F, L, bits = ctx.R, ctx.F, ctx.key_limbs, ctx.key_limb_bits
    assert J == ctx.J and N == ctx.N
    dev = bk_rows.device

    # signed base-2^bits limbs, borrow-carried (arithmetic shifts on int64)
    out, c = [], round_key(bk_rows.to(torch.int64), ctx.key_round_bits)
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
# The "ntt_kernel" form's key and matrices: byte planes of int8 MMA fragments
# --------------------------------------------------------------------------

def split_bytes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = lo + 256 * hi with lo in [-128, 127], in x's integer dtype."""
    lo = ((x + 128) & 255) - 128
    return lo, (x - lo) >> 8


def mma_b_fragments(B: torch.Tensor, p: int) -> torch.Tensor:
    """The m16n8k32 B operand fragments of a (Kd, Nd) matrix of balanced
    residues mod p, zero-padded to multiples of 32 rows and 8 columns (at
    least 32): (Nd/8, Kd/32, 32, 4, 8) int8.  Lane 4g + tig of tile (nt, kt)
    holds, per plane (lo(B), hi(B), lo(V), hi(V)) with V = 256 B mod p,
    b0 = rows 32kt + 4tig + e and b1 = rows 32kt + 16 + 4tig + e (e < 4) of
    column 8nt + g."""
    Kd, Nd = B.shape
    KP, NP = max(32, -(-Kd // 32) * 32), max(32, -(-Nd // 8) * 8)
    Bp = torch.zeros((KP, NP), dtype=torch.int64)
    Bp[:Kd, :Nd] = B.to(torch.int64)
    planes = torch.stack([*split_bytes(Bp), *split_bytes(balanced_mod(256 * Bp, p))])
    x = planes.reshape(4, KP // 32, 2, 4, 4, NP // 8, 8)    # q, kt, half, tig, e, nt, g
    return x.permute(5, 1, 6, 3, 0, 2, 4).reshape(NP // 8, KP // 32, 32, 4, 8).to(
        torch.int8).contiguous()


def pad16(x: int) -> int:
    """x rounded up to a multiple of 16: the kernels' m16 / k16 tiles."""
    return -(-x // 16) * 16


def pack_kernel_key(res: torch.Tensor) -> torch.Tensor:
    """(n, P, F, K, M) int16 residues -> (n, P, F, Mp/16, Kp/16, 32, 16) int8,
    K and M zero-padded to Kp, Mp (multiples of 16: zero rows and columns add
    nothing to any sum): per m16 x k16 tile of T^T (T = the (Kp, Mp)
    residues of one frequency), lane 4g + tig holds lo(a0), lo(a1), hi(a0),
    hi(a1), a0 = T^T[16mt + g, 16kt + 4tig + e], a1 = the same 8 rows on
    (e < 4): the m16n8k16 A fragments."""
    n, P, F, K, M = res.shape
    Kp, Mp = pad16(K), pad16(M)
    res = torch.nn.functional.pad(res.to(torch.int16), (0, Mp - M, 0, Kp - K))
    lo, hi = split_bytes(res)
    x = torch.stack([lo, hi]).to(torch.int8).reshape(2, n, P, F, Kp // 16, 4, 4, Mp // 16, 2, 8)
    # (q, n, P, F, kt, tig, e, mt, half, g) -> (n, P, F, mt, kt, g, tig, q, half, e)
    return x.permute(1, 2, 3, 7, 4, 9, 5, 0, 8, 6).reshape(
        n, P, F, Mp // 16, Kp // 16, 32, 16).contiguous()


def unpack_kernel_key(key: torch.Tensor, K: int | None = None,
                      M: int | None = None) -> torch.Tensor:
    """Inverse of :func:`pack_kernel_key`: (..., F, Mp/16, Kp/16, 32, 16) int8
    -> (..., F, K, M) int16 residues, cropped to the true K and M where given
    (else the padded Kp, Mp)."""
    *lead, F, MT, KT, _, _ = key.shape
    x = key.reshape(-1, F, MT, KT, 8, 4, 2, 2, 4)      # (b, F, mt, kt, g, tig, q, half, e)
    x = x.permute(6, 0, 1, 3, 5, 8, 2, 7, 4).to(torch.int16)   # (q, b, F, kt, tig, e, mt, half, g)
    res = (x[0] + 256 * x[1]).reshape(*lead, F, 16 * KT, 16 * MT)
    return res[..., :16 * KT if K is None else K, :16 * MT if M is None else M]


def prepare_kernel_key(bk_rows: torch.Tensor, ctx: NttContext) -> torch.Tensor:
    """(n, J, U, N) int32 TGSW rows -> the "ntt_kernel" form's key: the
    residues of :func:`kernel_key_residues` as :func:`pack_kernel_key`'s byte
    planes, (n, P, F, Mp/16, Kp/16, 32, 16) int8 (the bytes of the int16
    residues, K and M padded to multiples of 16)."""
    return pack_kernel_key(kernel_key_residues(bk_rows, ctx))


# --------------------------------------------------------------------------
# The "ntt_scan" form's key: int8 byte pairs in the v1 kernel's layout
# --------------------------------------------------------------------------

def split_key_bytes(key: torch.Tensor) -> torch.Tensor:
    """(..., M) int16 balanced residues -> (..., 2M) int8 [lo | hi] with
    x = lo + 256 * hi and lo in [-128, 127] (the reference's ``split_i8``)."""
    return torch.cat(split_bytes(key.to(torch.int32)), dim=-1).to(torch.int8)


def join_key_bytes(key8: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_key_bytes`: (..., 2M) int8 -> (..., M) int16."""
    M = key8.shape[-1] // 2
    return key8[..., :M].to(torch.int16) + 256 * key8[..., M:].to(torch.int16)


#: Bytes of int16 residues a chunk of steps of :func:`prepare_key_ntt` makes
#: at once: its float64 and int64 intermediates are about ten times that,
#: where the whole key at N = 16384 (15.9 GB) would need over 80 GB.
KEY_CHUNK_BYTES = 1 << 30


def prepare_key_ntt(bk_rows: torch.Tensor, ctx: NttContext) -> torch.Tensor:
    """(n, J, U, N) int32 TGSW rows -> the "ntt_scan" key (n, P, F, K, 2M) int8.

    The bits of ``pallas_ntt_blindrot.prepare_kernel_key(ntt.prepare_key_ntt_np(
    rows, ctx).T8)`` of the reference: :func:`kernel_key_residues`, each
    split into its two bytes, a chunk of steps at a time
    (:data:`KEY_CHUNK_BYTES`).  Runs on the rows' device.
    """
    n, J, U, N = bk_rows.shape
    P, K, M = len(ctx.primes), J * ctx.R, ctx.key_limbs * U * ctx.R
    step = max(1, KEY_CHUNK_BYTES // (P * ctx.F * K * M * 2))
    out = torch.empty((n, P, ctx.F, K, 2 * M), dtype=torch.int8, device=bk_rows.device)
    for i in range(0, n, step):
        out[i:i + step] = split_key_bytes(kernel_key_residues(bk_rows[i:i + step], ctx))
    return out


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
