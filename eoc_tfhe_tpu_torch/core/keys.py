"""Key material: secret/cloud key sets, bootstrapping key, key-switching key.

Port of ``eoc_tfhe_tpu/core/keys.py``.  Randomness comes from a
``torch.Generator``, so a keyset made here cannot match the reference's bit
for bit; :func:`keyset_from_numpy` carries a reference keyset across so that
both packages compute with the same keys.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from .params import GateBootstrappingParams
from .lwe import LweKey, lwe_key_gen, lwe_sym_encrypt
from .tlwe import TLweKey, tlwe_key_gen
from .tgsw import tgsw_sym_encrypt_int
from .numeric import wrap32


@dataclasses.dataclass
class KeySwitchKey:
    """``LweKeySwitchKey``: ks[i, j, u] encrypts in_key[i] * u * 2^(32-(j+1)*basebit)
    under the output key, packed as (n_in, t, base, n_out + 1) int32 with the
    body in the last column."""

    ks: torch.Tensor        # (n_in, t, base, n_out + 1) int32
    variance: torch.Tensor  # () float32 — noise variance of each entry

    @property
    def n_in(self) -> int:
        return self.ks.shape[0]

    @property
    def t(self) -> int:
        return self.ks.shape[1]

    @property
    def base(self) -> int:
        return self.ks.shape[2]

    @property
    def n_out(self) -> int:
        return self.ks.shape[3] - 1


@dataclasses.dataclass
class BootstrappingKey:
    """``LweBootstrappingKey``: n TGSW encryptions of the LWE key bits + ks key."""

    bk: torch.Tensor           # (n, kpl, k+1, N) int32
    bk_variance: torch.Tensor  # () float32
    ks: KeySwitchKey

    @property
    def n(self) -> int:
        return self.bk.shape[0]


@dataclasses.dataclass
class CloudKeySet:
    """``TFheGateBootstrappingCloudKeySet``: the public evaluation material."""

    bk: BootstrappingKey


@dataclasses.dataclass
class SecretKeySet:
    """``TFheGateBootstrappingSecretKeySet``: lwe key + tgsw key + cloud keys."""

    lwe_key: LweKey
    tgsw_key: TLweKey
    cloud: CloudKeySet

    @property
    def extracted_key(self) -> LweKey:
        """``tLweExtractKey``: the ring key flattened to an LWE key over k*N."""
        return LweKey(s=self.tgsw_key.key.reshape(-1))


def _f32_square(alpha: float, device) -> torch.Tensor:
    return torch.tensor(np.float32(alpha) ** 2, dtype=torch.float32, device=device)


def create_keyswitch_key(generator: torch.Generator, in_key: LweKey, out_key: LweKey,
                         t: int, basebit: int, alpha: float) -> KeySwitchKey:
    """``lweCreateKeySwitchKey``: N_in * t * base fresh LWE encryptions."""
    dev = in_key.s.device
    u = torch.arange(1 << basebit, dtype=torch.int64, device=dev)
    shifts = torch.tensor([32 - (j + 1) * basebit for j in range(t)],
                          dtype=torch.int64, device=dev)
    mess = wrap32(in_key.s.to(torch.int64)[:, None, None]
                  * (u[None, None, :] << shifts[None, :, None]))
    ct = lwe_sym_encrypt(generator, mess, alpha, out_key)
    return KeySwitchKey(ks=torch.cat([ct.a, ct.b[..., None]], dim=-1),
                        variance=_f32_square(alpha, dev))


def create_bootstrapping_key(generator: torch.Generator, lwe_key: LweKey,
                             tgsw_key: TLweKey,
                             params: GateBootstrappingParams) -> BootstrappingKey:
    """``tfhe_createLweBootstrappingKey``: TGSW(s_i) for each LWE key bit + ks key."""
    alpha_bk = params.tgsw_params.tlwe_params.alpha_min
    tg = tgsw_sym_encrypt_int(generator, lwe_key.s, alpha_bk, tgsw_key,
                              params.tgsw_params)
    extracted = LweKey(s=tgsw_key.key.reshape(-1))
    ks = create_keyswitch_key(generator, extracted, lwe_key, t=params.ks.t,
                              basebit=params.ks.basebit,
                              alpha=params.in_out_params.alpha_min)
    return BootstrappingKey(bk=tg.rows, bk_variance=_f32_square(alpha_bk, tg.rows.device),
                            ks=ks)


def new_random_gate_bootstrapping_secret_keyset(
        generator: torch.Generator, params: GateBootstrappingParams,
        device=None) -> SecretKeySet:
    """``new_random_gate_bootstrapping_secret_keyset`` with explicit randomness.

    ``generator`` must live on ``device`` (the card by default)."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, keyset on {dev}")
    lwe_key = lwe_key_gen(generator, params.in_out_params)
    tgsw_key = tlwe_key_gen(generator, params.tgsw_params.tlwe_params)
    bk = create_bootstrapping_key(generator, lwe_key, tgsw_key, params)
    return SecretKeySet(lwe_key=lwe_key, tgsw_key=tgsw_key, cloud=CloudKeySet(bk=bk))


def keyset_from_numpy(lwe_s, tgsw_key, bk, bk_variance, ks, ks_variance,
                      device=None) -> SecretKeySet:
    """A keyset of the JAX package, given as numpy arrays, as the port's keyset.

    Args are the reference's ``lwe_key.s`` (n,), ``tgsw_key.key`` (k, N),
    ``cloud.bk.bk`` (n, kpl, k+1, N), ``cloud.bk.bk_variance``,
    ``cloud.bk.ks.ks`` (n_in, t, base, n_out+1) and ``cloud.bk.ks.variance``.
    """
    dev = resolve_device(device)

    def i32(x):
        return torch.from_numpy(np.array(x, dtype=np.int32)).to(dev)

    def f32(x):
        return torch.tensor(np.float32(x), dtype=torch.float32, device=dev)

    ksk = KeySwitchKey(ks=i32(ks), variance=f32(ks_variance))
    return SecretKeySet(
        lwe_key=LweKey(s=i32(lwe_s)), tgsw_key=TLweKey(key=i32(tgsw_key)),
        cloud=CloudKeySet(bk=BootstrappingKey(bk=i32(bk), bk_variance=f32(bk_variance),
                                              ks=ksk)))
