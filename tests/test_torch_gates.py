"""The port's key switching and bootstrapped gates against the JAX package.

Both packages compute with one keyset of the port's keygen, carried to the
reference by ``tests/torch_reference.py``; the reference runs its
``kernel=True`` eval key (the Pallas kernel in interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoc_tfhe_tpu.core import bootstrap as jboot
from eoc_tfhe_tpu.core import gates as jgates
from eoc_tfhe_tpu.core import lwe as jlwe
from eoc_tfhe_tpu.core import params as jparams
from eoc_tfhe_tpu.ops import keyswitch as jks

from eoc_tfhe_tpu_torch.core import bootstrap, gates, keys, params
from eoc_tfhe_tpu_torch.ops import blind_rotate, keyswitch

from torch_reference import keyset_pair, to_port

GATES = ["nand", "and_", "or_", "nor", "xor_", "xnor", "andny", "andyn", "orny", "oryn"]


def toy_params():
    return jparams.test_params(n=16, N=64, k=1, l=3, Bgbit=7)


@pytest.fixture(scope="module")
def shared():
    """A keyset in both packages and their eval keys, plus encrypted inputs."""
    p = toy_params()
    jk, tk = keyset_pair(p, 0)
    rng = np.random.default_rng(1)
    B = 6
    a, b = rng.integers(0, 2, B).astype(bool), rng.integers(0, 2, B).astype(bool)
    ca = jgates.encrypt_bit(jax.random.key(1), jnp.asarray(a), jk.lwe_key, p)
    cb = jgates.encrypt_bit(jax.random.key(2), jnp.asarray(b), jk.lwe_key, p)
    return dict(p=p, jk=jk, tk=tk, a=a, b=b, ca=ca, cb=cb,
                jek=jboot.prepare_eval_key_ntt(jk.cloud, p, kernel=True),
                tek=bootstrap.prepare_eval_key_ntt(tk.cloud, p))


def test_keyswitch_matches_reference(shared):
    p, jk = shared["p"], shared["jk"]
    kN = p.N * p.k
    rng = np.random.default_rng(3)
    a = rng.integers(-2**31, 2**31, (2100, kN), dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, 2100, dtype=np.int64).astype(np.int32)
    v = rng.uniform(0, 1e-6, 2100).astype(np.float32)
    jct = jlwe.LweCiphertext(a=jnp.asarray(a), b=jnp.asarray(b), current_variance=jnp.asarray(v))
    ref = jks.keyswitch_apply(jct, jk.cloud.bk.ks, t=p.ks.t, basebit=p.ks.basebit)
    out = keyswitch.keyswitch_apply(to_port(jct), shared["tk"].cloud.bk.ks,
                                    t=p.ks.t, basebit=p.ks.basebit)
    np.testing.assert_array_equal(np.asarray(ref.a), out.a.numpy())
    np.testing.assert_array_equal(np.asarray(ref.b), out.b.numpy())
    np.testing.assert_array_equal(np.asarray(ref.current_variance),
                                  out.current_variance.numpy())
    np.testing.assert_array_equal(
        np.asarray(jks.keyswitch_digits(jnp.asarray(a), p.ks.t, p.ks.basebit)),
        keyswitch.keyswitch_digits(torch.from_numpy(a), p.ks.t, p.ks.basebit).numpy())


@pytest.mark.parametrize("gate", GATES)
def test_gate_matches_reference(shared, gate):
    p = shared["p"]
    ref = getattr(jgates, gate)(shared["ca"], shared["cb"], shared["jek"], p)
    out = getattr(gates, gate)(to_port(shared["ca"]), to_port(shared["cb"]),
                               shared["tek"], p)
    np.testing.assert_array_equal(np.asarray(ref.a), out.a.numpy())
    np.testing.assert_array_equal(np.asarray(ref.b), out.b.numpy())
    # both sides compute the variance in float32
    np.testing.assert_allclose(out.current_variance.numpy(),
                               np.asarray(ref.current_variance), rtol=1e-6)
    truth = {"nand": lambda x, y: ~(x & y), "and_": lambda x, y: x & y,
             "or_": lambda x, y: x | y, "nor": lambda x, y: ~(x | y),
             "xor_": lambda x, y: x ^ y, "xnor": lambda x, y: ~(x ^ y),
             "andny": lambda x, y: ~x & y, "andyn": lambda x, y: x & ~y,
             "orny": lambda x, y: ~x | y, "oryn": lambda x, y: x | ~y}[gate]
    np.testing.assert_array_equal(gates.decrypt_bit(out, shared["tk"].lwe_key).numpy(),
                                  truth(shared["a"], shared["b"]))


def test_linear_gates_match_reference(shared):
    p, ca = shared["p"], shared["ca"]
    ref, out = jgates.not_(ca), gates.not_(to_port(ca))
    np.testing.assert_array_equal(np.asarray(ref.a), out.a.numpy())
    np.testing.assert_array_equal(np.asarray(ref.b), out.b.numpy())
    assert gates.copy(out) is out
    bits = np.array([True, False, True])
    ref = jgates.constant(jnp.asarray(bits), p)
    out = gates.constant(bits, p, device="cpu")
    np.testing.assert_array_equal(np.asarray(ref.b), out.b.numpy())
    np.testing.assert_array_equal(np.asarray(ref.a), out.a.numpy())
    np.testing.assert_array_equal(gates.decrypt_bit(out, shared["tk"].lwe_key).numpy(), bits)


def test_variance_rails_match_reference():
    for make in (jparams.default_128bit_params, toy_params):
        p = make()
        assert bootstrap.predicted_bootstrap_variance(p) == jboot.predicted_bootstrap_variance(p)
        assert gates.check_noise_budget(p, -1, -1) == jgates.check_noise_budget(p, -1, -1)
        bkv = np.float32(p.tgsw_params.tlwe_params.alpha_min) ** 2
        np.testing.assert_array_equal(
            bootstrap.blind_rotate_output_variance(p, torch.tensor(bkv)).numpy(),
            np.asarray(jboot.blind_rotate_output_variance(p, jnp.float32(bkv))))


def test_port_keyset_decrypts_its_own_nand():
    p = params.test_params(n=16, N=64, k=1, l=3, Bgbit=7)
    gen = torch.Generator(device="cpu").manual_seed(5)
    ks = keys.new_random_gate_bootstrapping_secret_keyset(gen, p, device="cpu")
    ek = bootstrap.prepare_eval_key_ntt(ks.cloud, p)
    a = torch.tensor([0, 0, 1, 1, 1, 0], dtype=torch.bool)
    b = torch.tensor([0, 1, 0, 1, 1, 1], dtype=torch.bool)
    ca = gates.encrypt_bit(gen, a, ks.lwe_key, p)
    cb = gates.encrypt_bit(gen, b, ks.lwe_key, p)
    before = blind_rotate.launches
    out = gates.nand(ca, cb, ek, p)
    assert blind_rotate.launches == before          # CPU tensors: plain version
    assert torch.equal(gates.decrypt_bit(out, ks.lwe_key), ~(a & b))
