"""The port's core leftovers and its noise, against the JAX package.

Bit-exact twins: ``t32_to_double``, ``tlwe_phase`` / ``tlwe_add`` /
``tlwe_sub``, ``SecretKeySet.extracted_key``, ``tgsw_extern_mul`` (twin of
``tests/test_tgsw.py``'s external product), ``bootstrap`` under every
``rotation_impl`` (twin of ``tests/test_bootstrap.py``'s sign test) and the
variance functions with every keyword.  Keygen and encryption noise come from
another PRNG, so they are held by distribution: the samplers' moments and a
Kolmogorov-Smirnov or chi-square test at a fixed seed, and the measured phase
error of port-made bootstraps against ``predicted_bootstrap_variance`` (twin
of ``tests/test_noise.py``'s empirical test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from eoc_tfhe_tpu.core import bootstrap as jboot
from eoc_tfhe_tpu.core import lwe as jlwe
from eoc_tfhe_tpu.core import numeric as jnumeric
from eoc_tfhe_tpu.core import params as jparams
from eoc_tfhe_tpu.core import tgsw as jtgsw
from eoc_tfhe_tpu.core import tlwe as jtlwe

from eoc_tfhe_tpu_torch import config
from eoc_tfhe_tpu_torch.circuits import adder
from eoc_tfhe_tpu_torch.core import bootstrap, gates, keys, lwe, numeric, params, tgsw, tlwe

from torch_reference import keyset_pair, to_port

GATES = ("nand", "and_", "or_", "nor", "xor_", "xnor", "andny", "andyn", "orny", "oryn")


def _t(x):
    return torch.from_numpy(np.array(x))


# --- bit-exact leftovers -------------------------------------------------------

def test_t32_to_double_matches_reference():
    x = np.random.default_rng(0).integers(-2**31, 2**31, 1000).astype(np.int32)
    x[:3] = (-2**31, 0, 2**31 - 1)
    got = numeric.t32_to_double(x)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, np.asarray(jnumeric.t32_to_double(x)))
    assert got.min() >= -0.5 and got.max() < 0.5


def test_tlwe_phase_add_sub_match_reference():
    rng = np.random.default_rng(1)
    k, N = 2, 64
    key = rng.integers(0, 2, (k, N)).astype(np.int32)
    xs = [rng.integers(-2**31, 2**31, (3, k + 1, N)).astype(np.int32) for _ in range(2)]
    vs = [rng.random(3).astype(np.float32) for _ in range(2)]
    jx, jy = (jtlwe.TLweCiphertext(a=jnp.asarray(a), current_variance=jnp.asarray(v))
              for a, v in zip(xs, vs))
    tx, ty = (tlwe.TLweCiphertext(a=_t(a), current_variance=_t(v)) for a, v in zip(xs, vs))
    jkey, tkey = jtlwe.TLweKey(key=jnp.asarray(key)), tlwe.TLweKey(key=_t(key))
    np.testing.assert_array_equal(tlwe.tlwe_phase(tx, tkey).numpy(),
                                  np.asarray(jtlwe.tlwe_phase(jx, jkey)))
    np.testing.assert_array_equal(tx.b.numpy(), np.asarray(jx.b))
    for port_fn, ref_fn in ((tlwe.tlwe_add, jtlwe.tlwe_add), (tlwe.tlwe_sub, jtlwe.tlwe_sub)):
        got, want = port_fn(tx, ty), ref_fn(jx, jy)
        assert got.a.dtype == torch.int32
        np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
        np.testing.assert_array_equal(got.current_variance.numpy(),
                                      np.asarray(want.current_variance))


@pytest.fixture(scope="module")
def keyset42():
    """The reference's bootstrap-test keyset (``jax.random.key(42)`` at
    ``test_params()``) in both packages, with each package's rows eval key."""
    p = jparams.test_params()
    jk, tk = keyset_pair(p, 42, keygen="reference")
    return dict(p=p, jk=jk, tk=tk, jek=jboot.prepare_eval_key(jk.cloud),
                tek=bootstrap.prepare_eval_key(tk.cloud, p))


def test_extracted_key_matches_reference(keyset42):
    jk, tk, p = keyset42["jk"], keyset42["tk"], keyset42["p"]
    got = tk.extracted_key
    assert isinstance(got, lwe.LweKey) and got.n == p.k * p.N
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(jk.extracted_key.s))


@pytest.mark.parametrize("m", [0, 1, 3])
def test_tgsw_extern_mul_matches_reference(m):
    """Twin of tests/test_tgsw.py::test_tgsw_extern_mul_scales_message: the
    same TGSW(m) rows and accumulator give the reference's words, and the
    product decrypts to m * mu."""
    TG = jparams.test_params().tgsw_params
    TL = TG.tlwe_params
    key = jtlwe.tlwe_key_gen(jax.random.key(0), TL)
    rows = jtgsw.tgsw_sym_encrypt_int(jax.random.key(1), jnp.int32(m), 1e-9, key, TG).rows
    mu = np.zeros(TL.N, np.int32)
    mu[0] = 1 << 26
    jacc = jtlwe.tlwe_noiseless_trivial(jnp.broadcast_to(jnp.asarray(mu), (2, TL.N)), TL.k)
    want = jtgsw.tgsw_extern_mul(jacc, rows, TG, row_variance=1e-18)
    tacc = tlwe.TLweCiphertext(a=_t(jacc.a), current_variance=_t(jacc.current_variance))
    got = tgsw.tgsw_extern_mul(tacc, _t(rows), TG, row_variance=1e-18)
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_allclose(got.current_variance.numpy(),
                               np.asarray(want.current_variance), rtol=1e-6)
    phase = tlwe.tlwe_phase(got, tlwe.TLweKey(key=_t(key.key))).numpy().astype(np.int64)
    expect = np.zeros(TL.N, np.int64)
    expect[0] = m * (1 << 26)
    err = ((phase - expect + 2**31) % 2**32) - 2**31
    assert np.abs(err).max() < 2**22


@pytest.mark.parametrize("rotation_impl", ["auto", "gather", "onehot", "barrel"])
def test_bootstrap_sign_matches_reference(keyset42, rotation_impl):
    """Twin of tests/test_bootstrap.py::test_bootstrap_sign: the port's
    bootstrap under every rotation_impl gives the reference's words (the
    argument changes no bits) and +-mu by the sign of the phase."""
    p, jk, tk = keyset42["p"], keyset42["jk"], keyset42["tk"]
    mu = int(gates.MU_BOOL)
    for seed, (msg_mu, sign) in enumerate([(1 << 29, 1), (-(1 << 29), -1)]):
        ct = jlwe.lwe_sym_encrypt(jax.random.key(9 + seed), jnp.int32(msg_mu),
                                  p.in_out_params.alpha_min, jk.lwe_key)
        want = jboot.bootstrap(jnp.int32(mu), ct, keyset42["jek"], p, "gather")
        got = bootstrap.bootstrap(mu, to_port(ct), keyset42["tek"], p, rotation_impl)
        np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
        np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
        np.testing.assert_allclose(got.current_variance.numpy(),
                                   np.asarray(want.current_variance), rtol=1e-6)
        phase = int(lwe.lwe_phase(got, tk.lwe_key))
        err = ((phase - sign * mu + 2**31) % 2**32) - 2**31
        assert abs(err) < 2**27


def _small_inputs(keyset42, nbits=None):
    """Two encrypted bits (or two nbits-words) at the keyset42 set."""
    p, tk = keyset42["p"], keyset42["tk"]
    gen = torch.Generator().manual_seed(3)
    shape = (2,) if nbits is None else (nbits, 2)
    bits = torch.randint(0, 2, shape, generator=gen).bool()
    return [gates.encrypt_bit(gen, bits, tk.lwe_key, p) for _ in range(3)]


@pytest.mark.parametrize("name", [*GATES, "mux", "maj", "refresh", "bootstrap_woKS"])
def test_rotation_impl_is_positional_and_checked_in_every_gate(keyset42, name):
    p, ek = keyset42["p"], keyset42["tek"]
    ca, cb, cc = _small_inputs(keyset42)
    args = {"mux": (ca, cb, cc), "maj": (ca, cb, cc), "refresh": (ca,),
            "bootstrap_woKS": (int(gates.MU_BOOL), ca)}.get(name, (ca, cb))
    fn = getattr(bootstrap if name == "bootstrap_woKS" else gates, name)
    base = fn(*args, ek, p)
    out = fn(*args, ek, p, "onehot")                   # the reference's positional slot
    assert torch.equal(out.a, base.a) and torch.equal(out.b, base.b)
    with pytest.raises(ValueError, match="rotation impl 'warp'"):
        fn(*args, ek, p, "warp")


@pytest.mark.parametrize("name", ["ripple_carry_add", "ripple_borrow_sub", "ripple_mul",
                                  "compare_lt", "equals", "select_word"])
def test_rotation_impl_is_positional_and_checked_in_every_circuit(keyset42, name):
    p, ek = keyset42["p"], keyset42["tek"]
    a, b, _ = _small_inputs(keyset42, nbits=3)
    args = (lwe.lwe_index(a, 0), a, b) if name == "select_word" else (a, b)
    fn = getattr(adder, name)
    with pytest.raises(ValueError, match="rotation impl 'warp'"):
        fn(*args, ek, p, "warp")
    base, out = fn(*args, ek, p), fn(*args, ek, p, "barrel")
    base, out = (x[0] if isinstance(x, tuple) else x for x in (base, out))
    assert torch.equal(out.a, base.a) and torch.equal(out.b, base.b)
    if name in ("ripple_carry_add", "ripple_borrow_sub"):   # mode after rotation_impl
        raw = fn(*args, ek, p, "gather", "raw")[0]
        assert torch.equal(gates.decrypt_bit(raw, keyset42["tk"].lwe_key),
                           gates.decrypt_bit(base, keyset42["tk"].lwe_key))
        with pytest.raises(ValueError, match="unknown ripple mode"):
            fn(*args, ek, p, "gather", "ripple")


def test_configured_rotation_impl_reaches_the_gate_api(keyset42):
    p, tk = keyset42["p"], keyset42["tk"]
    api = config.FrameworkConfig(param_set="test", rotation_impl="barrel").make_gate_api(tk, p)
    assert api.nand.keywords["rotation_impl"] == "barrel"
    ca, cb, _ = _small_inputs(keyset42)
    assert torch.equal(api.nand(ca, cb).b, gates.nand(ca, cb, api.eval_key, p).b)


# --- the variance functions, every keyword ------------------------------------

@pytest.mark.parametrize("make", [jparams.default_128bit_params, jparams.default_80bit_params,
                                  lambda: jparams.test_params(n=16, N=64, k=1, l=3, Bgbit=7)])
def test_variance_functions_with_every_keyword_match_reference(make):
    p = make()
    alpha2 = float(p.tgsw_params.tlwe_params.alpha_min) ** 2
    for bkv in (None, alpha2, 4.0 * alpha2):
        for with_ks in (True, False):
            for rb in (0, 4, 8):
                kw = dict(bk_variance=bkv, with_keyswitch=with_ks, key_round_bits=rb)
                assert (bootstrap.predicted_bootstrap_variance(p, **kw)
                        == jboot.predicted_bootstrap_variance(p, **kw)), kw
    assert (bootstrap.predicted_bootstrap_variance(p, with_keyswitch=False)
            < bootstrap.predicted_bootstrap_variance(p)
            < bootstrap.predicted_bootstrap_variance(p, key_round_bits=8))
    for bkv in (alpha2, 4.0 * alpha2):
        for rb in (0, 4, 8):
            got = bootstrap.blind_rotate_output_variance(
                p, torch.tensor(bkv, dtype=torch.float32), key_round_bits=rb)
            want = jboot.blind_rotate_output_variance(p, jnp.float32(bkv), key_round_bits=rb)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# --- the samplers, by distribution ---------------------------------------------

SAMPLES = 200_000


def test_gaussian32_distribution():
    """Mean, variance and a KS test against N(mu, sigma^2) at a fixed seed;
    and a two-sample KS test against the reference's sampler."""
    sigma, mu = 1e-3, 1 << 29
    gen = torch.Generator().manual_seed(7)
    out = numeric.gaussian32(torch.tensor(mu, dtype=torch.int32), sigma, gen, (SAMPLES,))
    assert out.dtype == torch.int32
    x = numeric.t32_to_double(numeric.wrap32(out.to(torch.int64) - mu).numpy())
    assert abs(x.mean()) < 5 * sigma / np.sqrt(SAMPLES)
    assert abs(x.var() / sigma ** 2 - 1) < 5 * np.sqrt(2 / SAMPLES)
    assert stats.kstest(x, stats.norm(0, sigma).cdf).pvalue > 1e-3
    ref = np.asarray(jnumeric.gaussian32(jnp.int32(0), sigma, jax.random.key(7), (SAMPLES,)))
    assert stats.ks_2samp(x, numeric.t32_to_double(ref)).pvalue > 1e-3


def test_uniform_torus32_distribution():
    gen = torch.Generator().manual_seed(8)
    out = numeric.uniform_torus32(gen, (SAMPLES,))
    assert out.dtype == torch.int32
    x = numeric.t32_to_double(out.numpy())
    assert abs(x.mean()) < 5 / np.sqrt(12 * SAMPLES)
    assert abs(x.var() * 12 - 1) < 5 * np.sqrt(0.8 / SAMPLES)   # Var(12 x^2) = 0.8
    assert stats.kstest(x, stats.uniform(-0.5, 1).cdf).pvalue > 1e-3
    # every bit position is a fair coin (the low bits included)
    words = out.numpy().astype(np.int64) & 0xFFFFFFFF
    ones = np.array([((words >> i) & 1).mean() for i in range(32)])
    assert np.all(np.abs(ones - 0.5) < 5 * 0.5 / np.sqrt(SAMPLES))


def test_uniform_binary_distribution():
    gen = torch.Generator().manual_seed(9)
    out = numeric.uniform_binary(gen, (SAMPLES,))
    assert out.dtype == torch.int32 and set(out.unique().tolist()) == {0, 1}
    counts = np.bincount(out.numpy(), minlength=2)
    assert abs(counts[1] / SAMPLES - 0.5) < 5 * 0.5 / np.sqrt(SAMPLES)
    assert stats.chisquare(counts).pvalue > 1e-3
    # pairs of consecutive draws are independent: the four patterns are equally likely
    pairs = np.bincount(2 * out.numpy()[0::2] + out.numpy()[1::2], minlength=4)
    assert stats.chisquare(pairs).pvalue > 1e-3


# --- the noise of port-made bootstraps -------------------------------------------

def test_empirical_vs_predicted_bootstrap_variance():
    """Twin of tests/test_noise.py::test_empirical_vs_predicted_bootstrap_variance
    on a port-made keyset: 10,240 NAND bootstraps; the measured phase variance
    is within [1/4, 4] of the prediction, and the tracked variance within
    [1/5, 5] of the measurement."""
    p = params.test_params(n=16, N=64, k=1, l=3, Bgbit=7)
    gen = torch.Generator().manual_seed(0)
    ks = keys.new_random_gate_bootstrapping_secret_keyset(gen, p, device="cpu")
    ek = bootstrap.prepare_eval_key(ks.cloud, p)
    B = 10_240
    a = torch.randint(0, 2, (B,), generator=gen).bool()
    b = torch.randint(0, 2, (B,), generator=gen).bool()
    out = gates.nand(gates.encrypt_bit(gen, a, ks.lwe_key, p),
                     gates.encrypt_bit(gen, b, ks.lwe_key, p), ek, p)
    want_mu = torch.where(~(a & b), gates.MU_BOOL, -gates.MU_BOOL).to(torch.int64)
    err = numeric.t32_to_double(
        numeric.wrap32(lwe.lwe_phase(out, ks.lwe_key).to(torch.int64) - want_mu).numpy())
    measured = float(np.mean(err ** 2))
    predicted = bootstrap.predicted_bootstrap_variance(p)
    assert predicted == jboot.predicted_bootstrap_variance(p)
    assert 0.25 * predicted <= measured <= 4.0 * predicted, (measured, predicted)
    tracked = float(out.current_variance[0])
    assert 0.2 * measured <= tracked <= 5.0 * measured
    # and the gates keep their 1/16 decision margin by a wide factor
    assert np.abs(err).max() < 1 / 16
