"""Batched LWE layer: keygen, encrypt, phase, linear ops.

Port of ``eoc_tfhe_tpu/core/lwe.py``.  A ciphertext is a batched tensor pair
``a: (..., n) int32``, ``b: (...) int32`` with a float32 variance per sample.
CUDA has no int32 matmul, so <a, s> is a masked int64 sum wrapped to int32.
The seeded (threefry mask) ciphertexts and ``lwe_sym_decrypt`` are not
ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .params import LweParams
from .numeric import gaussian32, uniform_binary, uniform_torus32, wrap32


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


def lwe_sym_encrypt(generator: torch.Generator, message: torch.Tensor,
                    alpha: float, lwe_key: LweKey) -> LweCiphertext:
    """``lweSymEncrypt``: b = gaussian32(mu, alpha) + <a, s>, a uniform."""
    shape = tuple(message.shape)
    a = uniform_torus32(generator, shape + (lwe_key.n,))
    noisy_mu = gaussian32(message, alpha, generator, shape)
    b = wrap32(noisy_mu.to(torch.int64) + _dot_key(a, lwe_key.s).to(torch.int64))
    var = torch.full(shape, float(np.float32(alpha) ** 2), dtype=torch.float32,
                     device=a.device)
    return LweCiphertext(a=a, b=b, current_variance=var)


def lwe_phase(ct: LweCiphertext, lwe_key: LweKey) -> torch.Tensor:
    """``lwePhase``: b - <a, s> (exact int32 wraparound)."""
    return wrap32(ct.b.to(torch.int64) - _dot_key(ct.a, lwe_key.s).to(torch.int64))


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
