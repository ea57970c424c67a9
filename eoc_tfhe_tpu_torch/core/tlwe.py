"""Batched TLWE (ring-LWE over the torus) layer.

Port of ``eoc_tfhe_tpu/core/tlwe.py``.  A TLWE sample is (k+1) torus
polynomials; phase(c) = b - sum_i key_i * a_i with exact negacyclic products.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .params import TLweParams
from .numeric import gaussian32, uniform_binary, uniform_torus32, wrap32
from ..ops import polymul
from .lwe import LweCiphertext


@dataclasses.dataclass
class TLweKey:
    """k binary polynomials."""

    key: torch.Tensor  # (k, N) int32 in {0,1}

    @property
    def k(self) -> int:
        return self.key.shape[0]

    @property
    def N(self) -> int:
        return self.key.shape[1]


@dataclasses.dataclass
class TLweCiphertext:
    """Batched TLWE sample(s): a[..., :k, :] mask polys, a[..., k, :] the body."""

    a: torch.Tensor  # (..., k+1, N) int32
    current_variance: torch.Tensor  # (...) float32

    @property
    def k(self) -> int:
        return self.a.shape[-2] - 1

    @property
    def N(self) -> int:
        return self.a.shape[-1]

    @property
    def b(self) -> torch.Tensor:
        """The body polynomial, (..., N)."""
        return self.a[..., -1, :]


def tlwe_key_gen(generator: torch.Generator, params: TLweParams) -> TLweKey:
    """Uniform binary ring key (upstream ``tLweKeyGen``)."""
    return TLweKey(key=uniform_binary(generator, (params.k, params.N)))


def tlwe_sym_encrypt_zero(generator: torch.Generator, alpha: float,
                          tlwe_key: TLweKey, batch_shape: tuple = ()) -> TLweCiphertext:
    """``tLweSymEncryptZero``: b = sum_i key_i * a_i + gaussian noise, a_i uniform."""
    k, N = tlwe_key.key.shape
    batch_shape = tuple(batch_shape)
    a = uniform_torus32(generator, batch_shape + (k, N))
    zero = torch.zeros((), dtype=torch.int32, device=a.device)
    noise = gaussian32(zero, alpha, generator, batch_shape + (N,))
    b = wrap32(noise.to(torch.int64)
               + polymul.torus_by_small_shared_matmul(a, tlwe_key.key).to(torch.int64))
    var = torch.full(batch_shape, float(np.float32(alpha) ** 2),
                     dtype=torch.float32, device=a.device)
    return TLweCiphertext(a=torch.cat([a, b[..., None, :]], dim=-2),
                          current_variance=var)


def tlwe_phase(ct: TLweCiphertext, tlwe_key: TLweKey) -> torch.Tensor:
    """``tLwePhase``: b - sum_i key_i * a_i (exact), (..., N) int32."""
    dot = polymul.torus_by_small_shared_matmul(ct.a[..., :-1, :], tlwe_key.key)
    return wrap32(ct.b.to(torch.int64) - dot.to(torch.int64))


def tlwe_add(x: TLweCiphertext, y: TLweCiphertext) -> TLweCiphertext:
    """``tLweAddTo`` semantics, functional: x + y."""
    return TLweCiphertext(a=wrap32(x.a.to(torch.int64) + y.a.to(torch.int64)),
                          current_variance=x.current_variance + y.current_variance)


def tlwe_sub(x: TLweCiphertext, y: TLweCiphertext) -> TLweCiphertext:
    """``tLweSubTo`` semantics, functional: x - y."""
    return TLweCiphertext(a=wrap32(x.a.to(torch.int64) - y.a.to(torch.int64)),
                          current_variance=x.current_variance + y.current_variance)


def tlwe_noiseless_trivial(mu_poly: torch.Tensor, k: int) -> TLweCiphertext:
    """``tLweNoiselessTrivial``: (0, ..., 0, mu(X))."""
    mu_poly = mu_poly.to(torch.int32)
    N = mu_poly.shape[-1]
    zeros = torch.zeros(mu_poly.shape[:-1] + (k, N), dtype=torch.int32,
                        device=mu_poly.device)
    return TLweCiphertext(
        a=torch.cat([zeros, mu_poly[..., None, :]], dim=-2),
        current_variance=torch.zeros(mu_poly.shape[:-1], dtype=torch.float32,
                                     device=mu_poly.device))


def tlwe_extract_lwe_sample(ct: TLweCiphertext, index: int = 0) -> LweCiphertext:
    """``tLweExtractLweSampleIndex``: coefficient ``index`` as an LWE sample over n = k*N.

    ext_a[i*N + j] = a_i[index - j]  for j <= index,
                   = -a_i[N + index - j]  for j > index  (negacyclic wrap).
    """
    k, N = ct.a.shape[-2] - 1, ct.a.shape[-1]
    mask = ct.a[..., :-1, :]                              # (..., k, N)
    j = torch.arange(N, device=mask.device)
    src = (index - j) % N
    ext = mask[..., src]
    ext = torch.where(j <= index, ext, -ext)
    a = ext.reshape(ext.shape[:-2] + (k * N,))
    return LweCiphertext(a=a, b=ct.a[..., -1, index],
                         current_variance=ct.current_variance)
