"""The gate path's device constants (``device.device_constant``) against the
formulas a gate evaluated on every call before they were kept: the blind
rotation's output variance kept with its eval key, the keyswitch's digit
shifts and rounding variance, and the circuits' constant false bit.

Only the port is imported.  At the full parameter sets the rotation itself
is replaced by the identity, since what is checked is the variance around
it (and a rotation at N = 1024 takes minutes on the CPU); the small sets run
the real bootstrap through the rounded NTT key and the rounded compact keys.
"""

import numpy as np
import pytest
import torch

from eoc_tfhe_tpu_torch import device as D
from eoc_tfhe_tpu_torch.circuits import adder
from eoc_tfhe_tpu_torch.core import bootstrap, gates, keys, lwe, params
from eoc_tfhe_tpu_torch.core.numeric import as_u32, wrap32
from eoc_tfhe_tpu_torch.ops import keyswitch, ntt

#: case -> (parameter set, eval-key form, compact limbs); "ntt_full" runs
#: the full set with the identity in the rotation's place.
CASES = {
    "128bit": (params.default_128bit_params, "ntt_full", None),
    "80bit": (params.default_80bit_params, "ntt_full", None),
    "ntt_rounded": (lambda: params.test_params(n=8), "ntt_rounded", None),
    "compact_limbs2": (lambda: params.test_params(n=8), "compact", 2),
    "compact_limbs3": (lambda: params.test_params(n=8), "compact", 3),
}
B = 3


def _random_i32(gen, shape):
    return torch.randint(-2**31, 2**31, shape, generator=gen, dtype=torch.int64).to(torch.int32)


def _full_set_key(p):
    """An "ntt_kernel" key of the set with no rotation key: its variance,
    context and a small random keyswitch table (n_in = 24) with the set's t
    and basebit."""
    gen = torch.Generator().manual_seed(1)
    ks = keys.KeySwitchKey(
        ks=_random_i32(gen, (24, p.ks.t, 1 << p.ks.basebit, p.n + 1)),
        variance=torch.tensor(np.float32(p.in_out_params.alpha_min) ** 2))
    return bootstrap.EvalKey(
        bk_rows=torch.zeros((p.n, 1, 1, 1), dtype=torch.int32),
        bk_variance=torch.tensor(np.float32(p.tgsw_params.tlwe_params.alpha_min) ** 2),
        ks_prepared=keyswitch.prepare_keyswitch_matmul(ks), ks=ks, form="ntt_kernel",
        ntt_ctx=ntt.kernel_context_for_params(p, device="cpu"),
        bk_ntt_kernel=torch.zeros(1, dtype=torch.int8))


def _prepared_key(p, form, limbs):
    ks = keys.new_random_gate_bootstrapping_secret_keyset(
        torch.Generator().manual_seed(2), p, device="cpu")
    if form == "compact":
        return bootstrap.prepare_eval_key_fused(ks.cloud, p, limbs=limbs)
    ek = bootstrap.prepare_eval_key_ntt(ks.cloud, p, rounded=True)
    assert ek.ntt_ctx.key_round_bits > 0
    return ek


def _per_call_rotation_variance(p, ek):
    """The output variance as ``bootstrap_woKS`` computed it on each call."""
    var = bootstrap.blind_rotate_output_variance(
        p, ek.bk_variance,
        key_round_bits=ek.ntt_ctx.key_round_bits if ek.ntt_ctx is not None else 0)
    if ek.compact_limbs < 4:
        var = var + torch.tensor(bootstrap.compact_round_variance(p, ek.compact_limbs),
                                 dtype=torch.float32)
    return var


def _per_call_keyswitch(u, ek, t, basebit):
    """``keyswitch_apply`` with its shifts and rounding variance made on the call."""
    n_in, _, base, m = ek.ks.ks.shape
    shifts = torch.tensor([32 - (j + 1) * basebit for j in range(t)], dtype=torch.int64)
    aibar = (as_u32(u.a) + (1 << (32 - (1 + basebit * t)))) & 0xFFFFFFFF
    digits = ((aibar[..., None] >> shifts) & (base - 1)).to(torch.int32)
    delta = keyswitch.keyswitch_delta(digits, ek.ks_prepared, base).to(torch.int64)
    nnz = (digits != 0).to(torch.float32).sum(dim=(-2, -1))
    var = (u.current_variance + nnz * ek.ks.variance
           + torch.tensor(n_in * 2.0 ** (-2 * t * basebit) / 24.0, dtype=torch.float32))
    return wrap32(-delta[..., :m - 1]), wrap32(u.b.to(torch.int64) - delta[..., m - 1]), var


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("case", list(CASES))
def test_gate_constants_equal_the_per_call_formulas(case, monkeypatch):
    """Each case: the bootstrap's output variance and the keyswitch's words
    and variance bit for bit as the per-call formulas give them; the false
    bit's words those of ``gates.constant(False)``; the key's first
    bootstrap builds one constant and a second call on the key none."""
    make, form, limbs = CASES[case]
    p = make()
    gen = torch.Generator().manual_seed(3)
    if form == "ntt_full":
        ek = _full_set_key(p)
        monkeypatch.setattr(bootstrap, "blind_rotate_ntt", lambda acc0, *_: acc0)
    else:
        ek = _prepared_key(p, form, limbs)
    ct = lwe.LweCiphertext(a=_random_i32(gen, (B, p.n)), b=_random_i32(gen, (B,)),
                           current_variance=torch.rand(B, generator=gen))

    before = D.gate_constants
    u = bootstrap.bootstrap_woKS(gates.MU_BOOL, ct, ek, p)
    assert D.gate_constants == before + 1           # the key's rotation variance
    assert torch.equal(_bits(u.current_variance),
                       _bits(_per_call_rotation_variance(p, ek).expand(B)))

    n_in = ek.ks.ks.shape[0]
    ext = lwe.LweCiphertext(a=u.a[..., :n_in].contiguous(), b=u.b,
                            current_variance=u.current_variance)
    out = keyswitch.keyswitch_apply(ext, ek.ks, t=p.ks.t, basebit=p.ks.basebit,
                                    prepared=ek.ks_prepared)
    want_a, want_b, want_var = _per_call_keyswitch(ext, ek, p.ks.t, p.ks.basebit)
    assert torch.equal(out.a, want_a) and torch.equal(out.b, want_b)
    assert torch.equal(_bits(out.current_variance), _bits(want_var))

    like = lwe.LweCiphertext(a=torch.zeros((8, B, p.n), dtype=torch.int32),
                             b=torch.zeros((8, B), dtype=torch.int32),
                             current_variance=torch.zeros((8, B)))
    after_first = D.gate_constants
    again = bootstrap.bootstrap_woKS(gates.MU_BOOL, ct, ek, p)
    keyswitch.keyswitch_apply(ext, ek.ks, t=p.ks.t, basebit=p.ks.basebit,
                              prepared=ek.ks_prepared)
    false, want = adder._false(like, p), gates.constant(torch.zeros(B, dtype=torch.bool), p,
                                                         device="cpu")
    assert D.gate_constants == after_first
    assert torch.equal(again.a, u.a) and torch.equal(again.b, u.b)
    assert all(torch.equal(getattr(false, f), getattr(want, f))
               for f in ("a", "b", "current_variance"))
    assert false.b.dtype == torch.int32 and bool((false.b == -gates.MU_BOOL).all())
