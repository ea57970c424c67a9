"""The port's integer circuits and linear LWE ops against the JAX package.

Both sides compute with one JAX-made keyset (carried across with
``keyset_from_numpy``) and the same ciphertexts.  The JAX side uses its
"rows" eval key, the port its "compact" key; the reference's own tests hold
its two forms bit-identical.  Ciphertexts must agree bit for bit, the
variance to float32 rounding, and the decryptions with the integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoc_tfhe_tpu.circuits import adder as jadder
from eoc_tfhe_tpu.core import bootstrap as jboot
from eoc_tfhe_tpu.core import gates as jgates
from eoc_tfhe_tpu.core import keys as jkeys
from eoc_tfhe_tpu.core import lwe as jlwe
from eoc_tfhe_tpu.core import params as jparams

from eoc_tfhe_tpu_torch.circuits import adder
from eoc_tfhe_tpu_torch.core import bootstrap, gates, keys, lwe

BATCH = 3


def _bits(vals, nbits):
    return np.stack([(np.asarray(vals) >> i) & 1 for i in range(nbits)]).astype(bool)


def _from_bits(bits):
    return sum(bits[i].astype(np.int64) << i for i in range(bits.shape[0]))


def _port_ct(ct):
    def t(x):
        return torch.from_numpy(np.array(x))
    return lwe.LweCiphertext(a=t(ct.a), b=t(ct.b), current_variance=t(ct.current_variance))


def _assert_same_ct(ref, out):
    np.testing.assert_array_equal(np.asarray(ref.a), out.a.numpy())
    np.testing.assert_array_equal(np.asarray(ref.b), out.b.numpy())
    # both sides compute the variance in float32
    np.testing.assert_allclose(out.current_variance.numpy(),
                               np.asarray(ref.current_variance), rtol=1e-6)


@pytest.fixture(scope="module")
def env():
    p = jparams.test_params()
    jk = jkeys.new_random_gate_bootstrapping_secret_keyset(jax.random.key(5), p)
    bk = jk.cloud.bk
    tk = keys.keyset_from_numpy(
        np.asarray(jk.lwe_key.s), np.asarray(jk.tgsw_key.key), np.asarray(bk.bk),
        np.asarray(bk.bk_variance), np.asarray(bk.ks.ks), np.asarray(bk.ks.variance),
        device="cpu")
    seed = iter(range(100, 200))

    def words(nbits, seed_np):
        vals = np.random.default_rng(seed_np).integers(0, 1 << nbits, BATCH)
        ct = jgates.encrypt_bit(jax.random.key(next(seed)), jnp.asarray(_bits(vals, nbits)),
                                jk.lwe_key, p)
        return vals, ct, _port_ct(ct)

    return dict(p=p, jk=jk, tk=tk, words=words, jek=jboot.prepare_eval_key(jk.cloud),
                tek=bootstrap.prepare_eval_key_fused(tk.cloud, p))


def _run(env, name, *cts):
    """The circuit ``name`` on both sides; returns (reference out, port out)."""
    ref = getattr(jadder, name)(*[c[1] for c in cts], env["jek"], env["p"])
    out = getattr(adder, name)(*[c[2] for c in cts], env["tek"], env["p"])
    return ref, out


def _decrypt(env, ct):
    return gates.decrypt_bit(ct, env["tk"].lwe_key).numpy()


def test_linear_ops_match_reference(env):
    _, x, tx = env["words"](3, 1)
    _, y, ty = env["words"](3, 2)
    for jf, tf in ((jlwe.lwe_sub, lwe.lwe_sub), (jlwe.lwe_add, lwe.lwe_add)):
        _assert_same_ct(jf(x, y), tf(tx, ty))
    _assert_same_ct(jlwe.lwe_sub_mul(x, 3, y), lwe.lwe_sub_mul(tx, 3, ty))
    _assert_same_ct(jlwe.lwe_clear(x), lwe.lwe_clear(tx))
    _assert_same_ct(jlwe.lwe_copy(x), lwe.lwe_copy(tx))
    _assert_same_ct(jlwe.lwe_index(x, slice(1, 3)), lwe.lwe_index(tx, slice(1, 3)))
    _assert_same_ct(jlwe.lwe_stack([jlwe.lwe_index(x, 0), jlwe.lwe_index(y, 2)]),
                    lwe.lwe_stack([lwe.lwe_index(tx, 0), lwe.lwe_index(ty, 2)]))


@pytest.mark.parametrize("mode", ["fast", "raw", "classic"])
@pytest.mark.parametrize("op", ["ripple_carry_add", "ripple_borrow_sub"])
def test_add_sub_match_reference(env, op, mode):
    nbits = 8 if mode == "fast" else 3
    a = env["words"](nbits, 3)
    b = env["words"](nbits, 4)
    ref = getattr(jadder, op)(a[1], b[1], env["jek"], env["p"], mode=mode)
    out = getattr(adder, op)(a[2], b[2], env["tek"], env["p"], mode=mode)
    for r, o in zip(ref, out):
        _assert_same_ct(r, o)
    want = a[0] + b[0] if op == "ripple_carry_add" else a[0] - b[0]
    np.testing.assert_array_equal(_from_bits(_decrypt(env, out[0])), want % (1 << nbits))
    flag = want >= (1 << nbits) if op == "ripple_carry_add" else want < 0
    np.testing.assert_array_equal(_decrypt(env, out[1]), flag)


def test_ripple_mul_matches_reference(env):
    a, b = env["words"](3, 12), env["words"](3, 13)
    (ref, _), (out, none) = _run(env, "ripple_mul", a, b)
    assert none is None
    _assert_same_ct(ref, out)
    np.testing.assert_array_equal(_from_bits(_decrypt(env, out)), (a[0] * b[0]) % 8)


def test_add_rejects_unknown_mode(env):
    a = env["words"](2, 5)
    for op in (adder.ripple_carry_add, adder.ripple_borrow_sub):
        with pytest.raises(ValueError, match="ripple mode"):
            op(a[2], a[2], env["tek"], env["p"], mode="turbo")


def test_16bit_add_matches_reference(env):
    a, b = env["words"](16, 6), env["words"](16, 7)
    ref, out = _run(env, "ripple_carry_add", a, b)
    for r, o in zip(ref, out):
        _assert_same_ct(r, o)
    np.testing.assert_array_equal(_from_bits(_decrypt(env, out[0])), (a[0] + b[0]) % 65536)


def test_compare_lt_and_select_word_match_reference(env):
    a, b = env["words"](3, 8), env["words"](3, 9)
    ref, lt = _run(env, "compare_lt", a, b)
    _assert_same_ct(ref, lt)
    np.testing.assert_array_equal(_decrypt(env, lt), a[0] < b[0])
    c = (None, ref, lt)
    ref, out = _run(env, "select_word", c, a, b)
    _assert_same_ct(ref, out)
    np.testing.assert_array_equal(_from_bits(_decrypt(env, out)),
                                  np.where(a[0] < b[0], a[0], b[0]))


@pytest.mark.parametrize("nbits", [3, 2])
def test_equals_matches_reference(env, nbits):
    a, b = env["words"](nbits, 10), env["words"](nbits, 11)
    for other in (b, a):
        ref, out = _run(env, "equals", a, other)
        _assert_same_ct(ref, out)
        np.testing.assert_array_equal(_decrypt(env, out), a[0] == other[0])


def test_half_adder_fast_matches_reference(env):
    a, b = env["words"](1, 14), env["words"](1, 15)
    ref = jadder.half_adder_fast(a[1], b[1], env["jek"], env["p"])
    out = adder.half_adder_fast(a[2], b[2], env["tek"], env["p"])
    for r, o in zip(ref, out):
        _assert_same_ct(r, o)
    np.testing.assert_array_equal(_decrypt(env, out[0])[0], (a[0] ^ b[0]) & 1)
    np.testing.assert_array_equal(_decrypt(env, out[1])[0], (a[0] & b[0]) & 1)
