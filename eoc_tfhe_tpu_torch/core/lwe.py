"""Batched LWE layer: keygen, encrypt, phase, decrypt, linear ops.

Port of ``eoc_tfhe_tpu/core/lwe.py``.  A ciphertext is a batched tensor pair
``a: (..., n) int32``, ``b: (...) int32`` with a float32 variance per sample.
CUDA has no int32 matmul, so <a, s> is a masked int64 sum wrapped to int32.

Seeded ciphertexts carry their mask as a 128-bit seed.  Its expansion is a
wire format, so it is fixed: the reference's two threefry2x32 streams in the
counter layout that JAX gives with ``jax_threefry_partitionable`` at its
default (on); see :func:`threefry2x32`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .params import LweParams
from .numeric import (approx_phase_np, gaussian32, uniform_binary, uniform_torus32,
                      wrap32)


@dataclasses.dataclass
class LweKey:
    """Binary LWE secret key s in {0,1}^n."""

    s: torch.Tensor  # (n,) int32 in {0,1}

    @property
    def n(self) -> int:
        return self.s.shape[-1]


@dataclasses.dataclass
class LweCiphertext:
    """Batched LWE sample(s): phase(c) = b - <a, s>."""

    a: torch.Tensor  # (..., n) int32
    b: torch.Tensor  # (...)    int32
    current_variance: torch.Tensor  # (...) float32

    @property
    def n(self) -> int:
        return self.a.shape[-1]


def _dot_key(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """<a, s> mod 2^32 for binary s: a masked int64 sum (|sum| < n * 2^31)."""
    return wrap32(torch.where(s.bool(), a.to(torch.int64), 0).sum(-1))


def lwe_key_gen(generator: torch.Generator, params: LweParams) -> LweKey:
    """Uniform binary secret key (upstream ``lweKeyGen``)."""
    return LweKey(s=uniform_binary(generator, (params.n,)))


def _encrypt_under_mask(generator: torch.Generator, message: torch.Tensor, alpha: float,
                        lwe_key: LweKey, a: torch.Tensor) -> LweCiphertext:
    """b = gaussian32(mu, alpha) + <a, s> for the given mask ``a``."""
    shape = tuple(message.shape)
    noisy_mu = gaussian32(message, alpha, generator, shape)
    b = wrap32(noisy_mu.to(torch.int64) + _dot_key(a, lwe_key.s).to(torch.int64))
    var = torch.full(shape, float(np.float32(alpha) ** 2), dtype=torch.float32,
                     device=a.device)
    return LweCiphertext(a=a, b=b, current_variance=var)


def lwe_sym_encrypt(generator: torch.Generator, message: torch.Tensor,
                    alpha: float, lwe_key: LweKey) -> LweCiphertext:
    """``lweSymEncrypt``: b = gaussian32(mu, alpha) + <a, s>, a uniform."""
    a = uniform_torus32(generator, tuple(message.shape) + (lwe_key.n,))
    return _encrypt_under_mask(generator, message, alpha, lwe_key, a)


@dataclasses.dataclass
class SeededLweCiphertext:
    """LWE sample with the public mask ``a`` stored as its 128-bit seed
    (the reference's mask-compressed upload format, wire UID 242)."""

    seed: torch.Tensor  # (..., 4) int64 holding uint32 words
    b: torch.Tensor     # (...)    int32
    current_variance: torch.Tensor  # (...) float32


_M32 = 0xFFFFFFFF
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(wrap_key_data(key, impl="threefry2x32"), (n,), uint32)``
    with ``jax_threefry_partitionable`` on: word i is x0 ^ x1 of the 20-round
    threefry2x32 block of counter (hi, lo) = (0, i) under (key0, key1).

    Args:
      key: (..., 2) int64 uint32 words.  Returns (..., n) int64 uint32 words.
    The CPU build has no uint32 shift, so the words live in int64 and every
    sum and rotation is masked to 32 bits.
    """
    k0, k1 = key[..., 0:1], key[..., 1:2]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = torch.zeros(n, dtype=torch.int64, device=key.device) + k0
    x1 = (torch.arange(n, dtype=torch.int64, device=key.device) + k1) & _M32
    for block in range(5):
        for r in _THREEFRY_ROTATIONS[block % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(block + 1) % 3]) & _M32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _M32
    return x0 ^ x1


def _expand_mask(seed: torch.Tensor, n: int) -> torch.Tensor:
    """(..., 4) uint32 seed words -> (..., n) int32 masks: the XOR of the
    threefry2x32 streams of the two keys (words 0-1 and 2-3)."""
    flat = seed.reshape(-1, 4).to(torch.int64)
    a = threefry2x32(flat[:, :2], n) ^ threefry2x32(flat[:, 2:], n)
    return wrap32(a).reshape(tuple(seed.shape[:-1]) + (n,))


def lwe_sym_encrypt_seeded(generator: torch.Generator, message: torch.Tensor,
                           alpha: float, lwe_key: LweKey) -> SeededLweCiphertext:
    """``lweSymEncrypt`` emitting a seeded ciphertext: one 128-bit mask seed
    per element, drawn from ``generator``; :func:`lwe_seeded_expand` of the
    result decrypts like :func:`lwe_sym_encrypt` output at the same noise."""
    shape = tuple(message.shape)
    B = int(np.prod(shape)) if shape else 1
    seeds = torch.randint(0, 1 << 32, (B, 4), generator=generator, dtype=torch.int64,
                          device=generator.device)
    a = _expand_mask(seeds, lwe_key.n).reshape(shape + (lwe_key.n,))
    ct = _encrypt_under_mask(generator, message, alpha, lwe_key, a)
    return SeededLweCiphertext(seed=seeds.reshape(shape + (4,)), b=ct.b,
                               current_variance=ct.current_variance)


def lwe_seeded_expand(ct: SeededLweCiphertext, n: int) -> LweCiphertext:
    """The full ciphertext of a seeded one (the mask expanded on its device)."""
    return LweCiphertext(a=_expand_mask(ct.seed, n), b=ct.b,
                         current_variance=ct.current_variance)


def lwe_phase(ct: LweCiphertext, lwe_key: LweKey) -> torch.Tensor:
    """``lwePhase``: b - <a, s> (exact int32 wraparound)."""
    return wrap32(ct.b.to(torch.int64) - _dot_key(ct.a, lwe_key.s).to(torch.int64))


def lwe_sym_decrypt(ct: LweCiphertext, lwe_key: LweKey, Msize: int) -> np.ndarray:
    """``lweSymDecrypt`` = approxPhase(lwePhase(ct), Msize), on the host."""
    return approx_phase_np(lwe_phase(ct, lwe_key).cpu().numpy(), Msize)


def lwe_noiseless_trivial(mu: torch.Tensor, n: int) -> LweCiphertext:
    """``lweNoiselessTrivial``: (0, mu) — decrypts to mu under every key."""
    mu = mu.to(torch.int32)
    return LweCiphertext(
        a=torch.zeros(tuple(mu.shape) + (n,), dtype=torch.int32, device=mu.device),
        b=mu,
        current_variance=torch.zeros(mu.shape, dtype=torch.float32, device=mu.device))


def lwe_negate(ct: LweCiphertext) -> LweCiphertext:
    """``lweNegate``: encrypt(-mu)."""
    return LweCiphertext(a=wrap32(-ct.a.to(torch.int64)),
                         b=wrap32(-ct.b.to(torch.int64)),
                         current_variance=ct.current_variance)


def lwe_add(x: LweCiphertext, y: LweCiphertext) -> LweCiphertext:
    """``lweAddTo`` semantics, functional: x + y."""
    return lwe_add_mul(x, 1, y)


def lwe_add_mul(x: LweCiphertext, p: int, y: LweCiphertext) -> LweCiphertext:
    """``lweAddMulTo``: x + p*y for an integer constant p."""
    return LweCiphertext(
        a=wrap32(x.a.to(torch.int64) + p * y.a.to(torch.int64)),
        b=wrap32(x.b.to(torch.int64) + p * y.b.to(torch.int64)),
        current_variance=x.current_variance + float(p) ** 2 * y.current_variance)


def lwe_clear(template: LweCiphertext) -> LweCiphertext:
    """``lweClear``: the (0, 0) sample with the same shape."""
    return LweCiphertext(a=torch.zeros_like(template.a), b=torch.zeros_like(template.b),
                         current_variance=torch.zeros_like(template.current_variance))


def lwe_copy(ct: LweCiphertext) -> LweCiphertext:
    """``lweCopy`` (functional: the same tensors; kept for API parity)."""
    return LweCiphertext(a=ct.a, b=ct.b, current_variance=ct.current_variance)


def lwe_sub(x: LweCiphertext, y: LweCiphertext) -> LweCiphertext:
    """``lweSubTo`` semantics, functional: x - y."""
    return lwe_sub_mul(x, 1, y)


def lwe_sub_mul(x: LweCiphertext, p: int, y: LweCiphertext) -> LweCiphertext:
    """``lweSubMulTo``: x - p*y."""
    return LweCiphertext(
        a=wrap32(x.a.to(torch.int64) - p * y.a.to(torch.int64)),
        b=wrap32(x.b.to(torch.int64) - p * y.b.to(torch.int64)),
        current_variance=x.current_variance + float(p) ** 2 * y.current_variance)


def lwe_stack(cts: list[LweCiphertext]) -> LweCiphertext:
    """Stack samples into a batch along a new leading axis."""
    return LweCiphertext(a=torch.stack([c.a for c in cts]), b=torch.stack([c.b for c in cts]),
                         current_variance=torch.stack([c.current_variance for c in cts]))


def lwe_index(ct: LweCiphertext, idx) -> LweCiphertext:
    """Select a sub-batch (leading-axis indexing; the result may be a view)."""
    return LweCiphertext(a=ct.a[idx], b=ct.b[idx], current_variance=ct.current_variance[idx])
