"""Boolean gate API: batched bootstrapped gates.

Port of ``eoc_tfhe_tpu/core/gates.py`` (upstream ``boot-gates.cpp``): the
two-input gates, NOT, COPY, CONSTANT, MUX, MAJ and refresh.  Booleans are
mu = +-1/8 on the torus (Torus32 +-2^29).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from .params import GateBootstrappingParams
from .numeric import mod_switch_to_torus32_np, double_to_t32
from .lwe import (LweCiphertext, LweKey, SeededLweCiphertext, lwe_add, lwe_add_mul,
                  lwe_negate, lwe_noiseless_trivial, lwe_phase, lwe_sym_encrypt,
                  lwe_sym_encrypt_seeded)
from .bootstrap import EvalKey, bootstrap, bootstrap_woKS, predicted_bootstrap_variance
from ..ops.keyswitch import keyswitch_apply

#: mu for "true"/"false": 1/8 and -1/8 (upstream _1s8).
MU_BOOL = double_to_t32(0.125)          # == 2**29


def _t32(num: int, den: int) -> int:
    """modSwitchToTorus32(num, den) as a host constant."""
    return int(mod_switch_to_torus32_np(num, den))


def _mu(bits, device) -> torch.Tensor:
    bits = torch.as_tensor(bits, device=device).bool()
    return torch.where(bits, MU_BOOL, -MU_BOOL).to(torch.int32)


def encrypt_bit(generator: torch.Generator, bits, sk_lwe: LweKey,
                params: GateBootstrappingParams) -> LweCiphertext:
    """``bootsSymEncrypt``: bit -> LWE(+-1/8) at the keyswitch noise level,
    on the key's device."""
    return lwe_sym_encrypt(generator, _mu(bits, sk_lwe.s.device),
                           params.in_out_params.alpha_min, sk_lwe)


def encrypt_bit_seeded(generator: torch.Generator, bits, sk_lwe: LweKey,
                       params: GateBootstrappingParams) -> SeededLweCiphertext:
    """``bootsSymEncrypt`` emitting seeded (mask-compressed) ciphertexts."""
    return lwe_sym_encrypt_seeded(generator, _mu(bits, sk_lwe.s.device),
                                  params.in_out_params.alpha_min, sk_lwe)


def decrypt_bit(ct: LweCiphertext, sk_lwe: LweKey) -> torch.Tensor:
    """``bootsSymDecrypt``: sign of the phase (bool tensor)."""
    return lwe_phase(ct, sk_lwe) > 0


# ---------------------------------------------------------------------------
# Linear-only gates (no bootstrap).
# ---------------------------------------------------------------------------

def not_(ct: LweCiphertext) -> LweCiphertext:
    return lwe_negate(ct)


def copy(ct: LweCiphertext) -> LweCiphertext:
    return ct


def constant(value, params: GateBootstrappingParams, device=None) -> LweCiphertext:
    """``bootsCONSTANT``: noiseless trivial +-1/8."""
    return lwe_noiseless_trivial(_mu(value, resolve_device(device)), params.n)


# ---------------------------------------------------------------------------
# Bootstrapped two-input gates: a linear combination into a temp LWE sample,
# then a bootstrap with mu = 1/8.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def check_noise_budget(params: GateBootstrappingParams,
                       sa: int = 2, sb: int = 2, sc: int = 0, sd: int = 0) -> float:
    """Static noise-budget rail at gate boundaries.

    Each input is taken as a worst-case gate output scaled by the gate's
    linear coefficients.  Raises if one input's variance exceeds
    max_stdev^2 or the combined stdev exceeds twice max_stdev; returns the
    predicted input stdev.
    """
    per_input = predicted_bootstrap_variance(params)
    stdev = float(np.sqrt((sa * sa + sb * sb + sc * sc + sd * sd) * per_input))
    budget = float(params.in_out_params.alpha_max)
    if per_input > budget * budget or stdev > 2.0 * budget:
        raise ValueError(
            f"gate noise budget exceeded: predicted input stdev {stdev:.3e} "
            f"(per-input var {per_input:.3e}) vs max_stdev {budget:.3e} "
            f"for params {params!r}")
    return stdev


def linear_input(offset_t32: int, ca: LweCiphertext, cb: LweCiphertext,
                 sa: int, sb: int) -> LweCiphertext:
    """A two-input gate's bootstrap input: (0, offset) + sa*ca + sb*cb."""
    temp = lwe_noiseless_trivial(
        torch.full(tuple(ca.b.shape), offset_t32, dtype=torch.int32, device=ca.b.device),
        ca.n)
    return lwe_add_mul(lwe_add_mul(temp, sa, ca), sb, cb)


def _gate(offset_t32: int, ca: LweCiphertext, cb: LweCiphertext,
          sa: int, sb: int, ek: EvalKey, params: GateBootstrappingParams) -> LweCiphertext:
    """temp = (0, offset) + sa*ca + sb*cb ; bootstrap(mu=1/8, temp)."""
    check_noise_budget(params, sa, sb)
    return bootstrap(MU_BOOL, linear_input(offset_t32, ca, cb, sa, sb), ek, params)


def nand(ca, cb, ek, params):
    """NAND = bootstrap((0,1/8) - ca - cb)."""
    return _gate(_t32(1, 8), ca, cb, -1, -1, ek, params)


def and_(ca, cb, ek, params):
    """AND = bootstrap((0,-1/8) + ca + cb)."""
    return _gate(_t32(-1, 8), ca, cb, 1, 1, ek, params)


def or_(ca, cb, ek, params):
    """OR = bootstrap((0,1/8) + ca + cb)."""
    return _gate(_t32(1, 8), ca, cb, 1, 1, ek, params)


def nor(ca, cb, ek, params):
    """NOR = bootstrap((0,-1/8) - ca - cb)."""
    return _gate(_t32(-1, 8), ca, cb, -1, -1, ek, params)


def xor_(ca, cb, ek, params):
    """XOR = bootstrap((0,1/4) + 2*(ca + cb))."""
    return _gate(_t32(1, 4), ca, cb, 2, 2, ek, params)


def xnor(ca, cb, ek, params):
    """XNOR = bootstrap((0,-1/4) - 2*(ca + cb))."""
    return _gate(_t32(-1, 4), ca, cb, -2, -2, ek, params)


def andny(ca, cb, ek, params):
    """ANDNY = (not a) and b = bootstrap((0,-1/8) - ca + cb)."""
    return _gate(_t32(-1, 8), ca, cb, -1, 1, ek, params)


def andyn(ca, cb, ek, params):
    """ANDYN = a and (not b) = bootstrap((0,-1/8) + ca - cb)."""
    return _gate(_t32(-1, 8), ca, cb, 1, -1, ek, params)


def orny(ca, cb, ek, params):
    """ORNY = (not a) or b = bootstrap((0,1/8) - ca + cb)."""
    return _gate(_t32(1, 8), ca, cb, -1, 1, ek, params)


def oryn(ca, cb, ek, params):
    """ORYN = a or (not b) = bootstrap((0,1/8) + ca - cb)."""
    return _gate(_t32(1, 8), ca, cb, 1, -1, ek, params)


def mux(c, a, b, ek, params):
    """MUX(c, a, b) = c ? a : b: two woKS bootstraps, a sum and one keyswitch
    (upstream ``bootsMUX``)."""
    check_noise_budget(params, 1, 1)
    mu = _t32(1, 8)
    u1 = bootstrap_woKS(mu, linear_input(_t32(-1, 8), c, a, 1, 1), ek, params)
    u2 = bootstrap_woKS(mu, linear_input(_t32(-1, 8), b, c, 1, -1), ek, params)
    return keyswitch_apply(linear_input(mu, u1, u2, 1, 1), ek.ks, t=params.ks.t,
                           basebit=params.ks.basebit, prepared=ek.ks_prepared)


def maj(ca, cb, cc, ek, params):
    """MAJ(a, b, c) = bootstrap((0, 0) + ca + cb + cc): 3-input majority.

    The phase of a + b + c on the +-1/8 encoding is (2t-3)/8 for t ones; its
    sign is the majority.  No upstream analog; the primitive behind the
    one-bootstrap full adder (``circuits/adder.py``).
    """
    check_noise_budget(params, 1, 1, 1)
    return bootstrap(MU_BOOL, lwe_add(lwe_add(ca, cb), cc), ek, params)


def refresh(ct, ek, params):
    """Noise refresh: bootstrap(mu=1/8, ct) re-encrypts sign(phase) at the
    fresh gate-output noise level.  The static rail models the worst input
    it is fed, a fast-adder raw sum with coefficients (2, 1, 1, 1)."""
    check_noise_budget(params, 2, 1, 1, 1)
    return bootstrap(MU_BOOL, ct, ek, params)
