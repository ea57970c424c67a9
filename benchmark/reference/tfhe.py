"""Plain TFHE gate bootstrapping: the benchmark's reference.

Written from upstream tfhe's definitions (``lwe-functions.cpp``,
``tlwe-functions.cpp``, ``tgsw-functions.cpp``, ``lwe-bootstrapping-functions.cpp``,
``lwe-keyswitch-functions.cpp``, ``boot-gates.cpp``) in plain PyTorch.  It
imports nothing of the system under test, so it computes every bit the
benchmark judges on its own: keygen, encryption, decryption, the blind
rotation, the sample extraction and the key switch.

Exactness: every torus word is an int64 reduced mod 2^32.  A negacyclic
product of the gadget digits (|d| <= Bg/2) with the int32 key rows is one
float64 matrix product per output polynomial, against the key's negacyclic
(Toeplitz) matrix: each sum has at most (k+1)*l*N terms of magnitude below
Bg/2 * 2^31, under 2^53 at both shipped sets (2^50.6 at 128 bits, 2^52 at
80 bits; :func:`check_exact` refuses a set past it), so float64 holds every
partial sum exactly in any order.  ``dtype=torch.float32`` runs the same
products in float32: the control, which is not exact.
"""

from __future__ import annotations

import dataclasses

import torch

MASK32 = 0xFFFFFFFF
TWO32 = 1 << 32


@dataclasses.dataclass(frozen=True)
class Params:
    """A gate-bootstrapping parameter set (upstream
    ``TFheGateBootstrappingParameterSet``), read from a configuration file's
    ``params`` object."""

    n: int
    N: int
    k: int
    l: int
    Bgbit: int
    ks_t: int
    ks_basebit: int
    ks_stdev: float
    bk_stdev: float
    max_stdev: float

    @classmethod
    def from_config(cls, p: dict) -> "Params":
        return cls(n=p["n"], N=p["N"], k=p["k"], l=p["bk_l"], Bgbit=p["bk_Bgbit"],
                   ks_t=p["ks_t"], ks_basebit=p["ks_basebit"], ks_stdev=p["ks_stdev"],
                   bk_stdev=p["bk_stdev"], max_stdev=p["max_stdev"])

    @property
    def kpl(self) -> int:
        return (self.k + 1) * self.l

    @property
    def halfBg(self) -> int:
        return 1 << (self.Bgbit - 1)

    @property
    def offset(self) -> int:
        """Upstream's decomposition offset: sum over p of halfBg * 2^(32-(p+1)Bgbit)."""
        return sum(self.halfBg << (32 - (p + 1) * self.Bgbit) for p in range(self.l)) & MASK32


@dataclasses.dataclass
class Keys:
    """A secret keyset: the LWE key, the ring key, the bootstrapping key's
    TGSW rows and the key-switching table (upstream's layouts)."""

    lwe: torch.Tensor   # (n,) int32 in {0, 1}
    ring: torch.Tensor  # (k, N) int32 in {0, 1}
    bk: torch.Tensor    # (n, (k+1)l, k+1, N) int32
    ks: torch.Tensor    # (k*N, t, base, n+1) int32, body last


def check_exact(p: Params) -> None:
    """Refuse a set whose float64 products could round (see the module doc)."""
    if p.kpl * p.N * p.halfBg * (1 << 31) >= 1 << 53:
        raise ValueError(f"the float64 product is not exact for {p}")


def wrap(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 mod 2^32."""
    return (((x + (1 << 31)) & MASK32) - (1 << 31)).to(torch.int32)


def t32(num: int, den: int) -> int:
    """upstream ``modSwitchToTorus32(num, den)`` as an int32 value."""
    interv = ((1 << 63) // den) * 2
    v = ((num * interv) % (1 << 64)) >> 32
    return v - TWO32 if v >= 1 << 31 else v


#: The boolean encoding: true is +1/8, false -1/8 (upstream ``_1s8``).
MU = t32(1, 8)


def mod_switch_from_torus(x: torch.Tensor, msize_log2: int) -> torch.Tensor:
    """upstream ``modSwitchFromTorus32`` for Msize = 2^m: the nearest of 2^m slots."""
    u = ((x.to(torch.int64) & MASK32) + (1 << (31 - msize_log2))) & MASK32
    return u >> (32 - msize_log2)


def _uniform32(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randint(-(1 << 31), 1 << 31, tuple(shape), generator=gen,
                         dtype=torch.int64, device=gen.device)


def _noise(gen: torch.Generator, sigma: float, shape) -> torch.Tensor:
    """A gaussian torus error of standard deviation ``sigma``, as int64 words."""
    e = torch.randn(tuple(shape), generator=gen, dtype=torch.float64, device=gen.device)
    return torch.round(e * (sigma * TWO32)).to(torch.int64)


def negacyclic_matrix(poly: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """(..., N) -> (..., N, N) with row m, column i holding the coefficient
    that multiplies input coefficient m into output coefficient i of the
    product mod X^N + 1: poly[i - m] for i >= m, -poly[N + i - m] below."""
    N = poly.shape[-1]
    ext = torch.cat([poly, -poly], dim=-1).to(dtype)
    i = torch.arange(N, device=poly.device)
    idx = (i[None, :] - i[:, None]) % (2 * N)
    return ext[..., idx]


def key_dot(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """<a, s> mod 2^32 for a binary key s, as int64 words in [0, 2^32)."""
    return (torch.where(s.bool(), a.to(torch.int64), 0).sum(-1)) & MASK32


def keygen(gen: torch.Generator, p: Params) -> Keys:
    """Upstream ``new_random_gate_bootstrapping_secret_keyset`` with its
    randomness from ``gen`` (a generator on the device that keeps the keys),
    in a few large calls."""
    check_exact(p)
    lwe = torch.randint(0, 2, (p.n,), generator=gen, dtype=torch.int32, device=gen.device)
    ring = torch.randint(0, 2, (p.k, p.N), generator=gen, dtype=torch.int32,
                         device=gen.device)
    # bootstrapping key: n TGSW samples of the LWE key bits under the ring key
    mask = _uniform32(gen, (p.n, p.kpl, p.k, p.N))
    body = _noise(gen, p.bk_stdev, (p.n, p.kpl, p.N))
    for j in range(p.k):
        prod = mask[:, :, j].to(torch.float64) @ negacyclic_matrix(ring[j])
        body = body + prod.to(torch.int64)
    rows = torch.cat([mask, body[:, :, None]], dim=2)
    h = torch.tensor([1 << (32 - (q + 1) * p.Bgbit) for q in range(p.l)],
                     dtype=torch.int64, device=gen.device)
    for bloc in range(p.k + 1):
        rows[:, bloc * p.l:(bloc + 1) * p.l, bloc, 0] += lwe.to(torch.int64)[:, None] * h
    # key-switching table: (k N, t, base) LWE samples of s_i * u / base^(j+1)
    ext = ring.reshape(-1).to(torch.int64)
    base = 1 << p.ks_basebit
    u = torch.arange(base, dtype=torch.int64, device=gen.device)
    shift = torch.tensor([32 - (j + 1) * p.ks_basebit for j in range(p.ks_t)],
                         dtype=torch.int64, device=gen.device)
    mu = ext[:, None, None] * (u[None, None, :] << shift[None, :, None])
    a = _uniform32(gen, (p.k * p.N, p.ks_t, base, p.n))
    b = mu + _noise(gen, p.ks_stdev, mu.shape) + key_dot(a, lwe)
    ks = torch.cat([a, b[..., None]], dim=-1)
    return Keys(lwe=lwe, ring=ring, bk=wrap(rows), ks=wrap(ks))


def encrypt(gen: torch.Generator, mu: torch.Tensor, s: torch.Tensor, sigma: float):
    """upstream ``lweSymEncrypt`` of int32 messages ``mu`` (B,): (a (B, n), b (B,)) int32."""
    a = _uniform32(gen, tuple(mu.shape) + (s.shape[0],))
    b = mu.to(torch.int64) + _noise(gen, sigma, mu.shape) + key_dot(a, s)
    return wrap(a), wrap(b)


def phase(a: torch.Tensor, b: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """upstream ``lwePhase``: b - <a, s> as int32."""
    return wrap(b.to(torch.int64) - key_dot(a, s))


def decrypt_bits(a: torch.Tensor, b: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """upstream ``bootsSymDecrypt``: the sign of the phase."""
    return phase(a, b, s) > 0


def rotate(x: torch.Tensor, amount: torch.Tensor) -> torch.Tensor:
    """X^amount * x mod X^N + 1, amount (B,) in [0, 2N), x (B, ..., N)."""
    N = x.shape[-1]
    ext = torch.cat([x, -x], dim=-1)
    i = torch.arange(N, device=x.device)
    idx = (i[None, :] - amount[:, None]) % (2 * N)
    idx = idx.reshape((x.shape[0],) + (1,) * (x.dim() - 2) + (N,)).expand(x.shape)
    return torch.gather(ext, -1, idx)


def extract(acc: torch.Tensor) -> torch.Tensor:
    """upstream ``tLweExtractLweSampleIndex`` at index 0: the mask of
    coefficient 0, a_j[0] and -a_j[N - i] for i > 0, flattened over the k
    mask polynomials."""
    mask = acc[:, :-1]
    N = mask.shape[-1]
    i = torch.arange(N, device=acc.device)
    out = torch.where(i == 0, mask[..., (-i) % N], -mask[..., (-i) % N])
    return out.reshape(acc.shape[0], -1) & MASK32


class Evaluator:
    """The bootstrap under one keyset: the blind rotation, the extraction and
    the key switch, with the keys laid out once for the products.

    ``dtype`` float64 is exact (see the module doc); float32 is the control.
    """

    def __init__(self, keys: Keys, p: Params, dtype=torch.float64):
        check_exact(p)
        self.keys, self.p, self.dtype = keys, p, dtype
        dev, N = keys.bk.device, p.N
        bk = keys.bk.to(torch.int64)
        # (n, k+1, (k+1)l, 2N): each key row and its negation, by output polynomial
        self.bk_ext = torch.cat([bk, -bk], dim=-1).to(dtype).transpose(1, 2).contiguous()
        i = torch.arange(N, device=dev)
        self.toeplitz = (i[None, :] - i[:, None]) % (2 * N)
        self.digit_shifts = torch.tensor([32 - (q + 1) * p.Bgbit for q in range(p.l)],
                                         dtype=torch.int64, device=dev)
        n_in, t, base, m = keys.ks.shape
        self.ks_table = keys.ks.to(torch.float64).reshape(n_in * t * base, m)
        self.ks_shifts = torch.tensor([32 - (j + 1) * p.ks_basebit for j in range(t)],
                                      dtype=torch.int64, device=dev)

    def decompose(self, x: torch.Tensor) -> torch.Tensor:
        """upstream ``tGswTorus32PolynomialDecompH``: (B, k+1, N) words ->
        (B, (k+1) l, N) int64 digits in [-Bg/2, Bg/2), rows [bloc][level]."""
        p = self.p
        u = ((x & MASK32) + p.offset) & MASK32
        d = ((u[:, :, None, :] >> self.digit_shifts[None, None, :, None])
             & ((1 << p.Bgbit) - 1)) - p.halfBg
        return d.reshape(x.shape[0], p.kpl, x.shape[-1])

    def blind_rotate(self, acc: torch.Tensor, bara: torch.Tensor) -> torch.Tensor:
        """upstream ``tfhe_blindRotate``: for each step i, acc += bk_i (x)
        (X^bara_i - 1) acc, one product of the digits with the step's
        negacyclic key matrices.  acc (B, k+1, N) int64 words, bara (B, n)."""
        p = self.p
        B, N, U = acc.shape[0], p.N, p.k + 1
        for i in range(p.n):
            diff = (rotate(acc, bara[:, i]) - acc) & MASK32
            digits = self.decompose(diff).reshape(B, p.kpl * N).to(self.dtype)
            key = self.bk_ext[i][..., self.toeplitz].reshape(U, p.kpl * N, N)
            prod = torch.matmul(digits, key).transpose(0, 1).to(torch.int64)
            acc = (acc + prod) & MASK32
        return acc

    def bootstrap_wo_ks(self, mu: int, a: torch.Tensor, b: torch.Tensor):
        """upstream ``tfhe_bootstrap_woKS``: the rotated test vector, the blind
        rotation and the extraction of coefficient 0, an LWE sample over k*N:
        (a (B, k N), b (B,)) int64 words."""
        p = self.p
        m = (2 * p.N).bit_length() - 1
        barb = mod_switch_from_torus(b, m)
        bara = mod_switch_from_torus(a, m)
        acc = torch.zeros((b.shape[0], p.k + 1, p.N), dtype=torch.int64, device=b.device)
        acc[:, p.k] = mu & MASK32
        acc = rotate(acc, (2 * p.N - barb) % (2 * p.N)) & MASK32
        acc = self.blind_rotate(acc, bara)
        return extract(acc), acc[:, p.k, 0]

    def keyswitch(self, a: torch.Tensor, b: torch.Tensor, rows: int = 256):
        """upstream ``lweKeySwitch``: (0, b) minus the table entries that the
        input mask's rounded base-2^basebit digits select, zero digits
        skipped.  The selection is a one-hot float64 product, exact (each sum
        has k N t terms below 2^31), ``rows`` samples at a time.  Returns
        int32 (a, b)."""
        p = self.p
        n_in, t, base, _ = self.keys.ks.shape
        off = 1 << (32 - (1 + p.ks_basebit * t))
        u = ((a & MASK32) + off) & MASK32
        digits = (u[:, :, None] >> self.ks_shifts) & (base - 1)          # (B, n_in, t)
        cols = (torch.arange(n_in * t, device=a.device) * base).reshape(n_in, t)
        out = []
        for r in range(0, a.shape[0], rows):
            d = digits[r:r + rows]
            hot = torch.zeros((d.shape[0], n_in * t * base), dtype=torch.float64,
                              device=a.device)
            hot.scatter_(1, (cols + d).reshape(d.shape[0], -1),
                         (d != 0).to(torch.float64).reshape(d.shape[0], -1))
            out.append((hot @ self.ks_table).to(torch.int64))
        delta = torch.cat(out)
        return wrap(-delta[:, :-1]), wrap(b.to(torch.int64) - delta[:, -1])

    def bootstrap(self, mu: int, a, b):
        """upstream ``tfhe_bootstrap``: the woKS bootstrap, then the key switch."""
        return self.keyswitch(*self.bootstrap_wo_ks(mu, a, b))
