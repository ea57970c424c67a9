"""The port's compact eval-key form (the reference's "fused" and "rows") against the JAX package.

The blind rotation over the stored key (the plain version of the CUDA
kernel, which the wrapper runs on CPU tensors) is held bit for bit against
the reference's Pallas kernel in interpret mode and its rows scan; the
exact products, the eval-key forms, MUX/MAJ/refresh and FrameworkConfig
likewise.  Keysets are made by the JAX package and carried across with
``keyset_from_numpy``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoc_tfhe_tpu import config as jconfig
from eoc_tfhe_tpu.core import bootstrap as jboot
from eoc_tfhe_tpu.core import gates as jgates
from eoc_tfhe_tpu.core import keys as jkeys
from eoc_tfhe_tpu.core import params as jparams
from eoc_tfhe_tpu.ops import ntt as jntt
from eoc_tfhe_tpu.ops import pallas_blindrot as jpb
from eoc_tfhe_tpu.ops import polymul as jpoly

from eoc_tfhe_tpu_torch import config
from eoc_tfhe_tpu_torch.core import bootstrap, gates, keys, lwe
from eoc_tfhe_tpu_torch.ops import blind_rotate_compact as brc
from eoc_tfhe_tpu_torch.ops import polymul


def _i32(rng, shape):
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def _rotation_inputs(p, n_steps, B, seed):
    tg = p.tgsw_params
    N, U = tg.tlwe_params.N, tg.tlwe_params.k + 1
    rng = np.random.default_rng(seed)
    return (_i32(rng, (n_steps, tg.kpl, U, N)), _i32(rng, (B, U, N)),
            rng.integers(0, 2 * N, (n_steps, B)).astype(np.int32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_ct(ct):
    return lwe.LweCiphertext(a=_t(ct.a), b=_t(ct.b), current_variance=_t(ct.current_variance))


def _assert_same_ct(ref, out):
    np.testing.assert_array_equal(np.asarray(ref.a), out.a.numpy())
    np.testing.assert_array_equal(np.asarray(ref.b), out.b.numpy())
    # both sides compute the variance in float32
    np.testing.assert_allclose(out.current_variance.numpy(),
                               np.asarray(ref.current_variance), rtol=1e-6)


# --- exact products ----------------------------------------------------------

def test_polymul_matches_reference():
    rng = np.random.default_rng(0)
    x, y = _i32(rng, (3, 32)), _i32(rng, (3, 32))
    np.testing.assert_array_equal(
        polymul.negacyclic_polymul_exact(_t(x), _t(y)).numpy(),
        np.asarray(jpoly.negacyclic_polymul_exact(jnp.asarray(x), jnp.asarray(y))))
    np.testing.assert_array_equal(polymul.negacyclic_extend(_t(x)).numpy(),
                                  np.asarray(jpoly.negacyclic_extend(jnp.asarray(x))))
    digits = rng.integers(-64, 64, (5, 6, 32)).astype(np.int32)
    rows = _i32(rng, (6, 2, 32))
    np.testing.assert_array_equal(
        polymul.small_by_torus_matmul(_t(digits), _t(rows), x_bound=64).numpy(),
        np.asarray(jpoly.small_by_torus_matmul(jnp.asarray(digits), jnp.asarray(rows),
                                               x_bound=64)))
    with pytest.raises(ValueError, match="digit bound"):
        polymul.small_by_torus_matmul(_t(digits), _t(rows), x_bound=512)


# --- the stored key and the blind rotation -----------------------------------

@pytest.mark.parametrize("limbs", [4, 3])
def test_compact_key_matches_reference(limbs):
    p = jparams.test_params()
    rows, _, _ = _rotation_inputs(p, 3, 1, seed=1)
    n, J, U, N = rows.shape
    T = np.asarray(jpb.prepare_compact_bk(jnp.asarray(rows), limbs=limbs)).astype(np.int64)
    Jp = jpb._padded_rows(J)
    T = T.reshape(n, U, limbs, Jp, N)[:, :, :, :J]
    drop = 4 - limbs
    recombined = sum(T[:, :, li] << (8 * (li + drop)) for li in range(limbs))
    want = ((recombined + 2**31) % 2**32 - 2**31).astype(np.int32).transpose(0, 2, 1, 3)
    np.testing.assert_array_equal(brc.prepare_compact_bk(_t(rows), limbs).numpy(), want)


@pytest.mark.parametrize("chunk,limbs", [(64, 4), (32, 4), (16, 4), (32, 3)])
def test_plain_rotation_matches_pallas_interpret(chunk, limbs):
    p = jparams.test_params()
    rows, acc0, bara = _rotation_inputs(p, p.n, 5, seed=2)
    want = np.asarray(jpb.blind_rotate_pallas(
        jnp.asarray(acc0), jnp.asarray(bara),
        jpb.prepare_compact_bk(jnp.asarray(rows), limbs=limbs), p, chunk=chunk,
        interpret=True))
    key = brc.prepare_compact_bk(_t(rows), limbs)
    before = brc.launches
    out = brc.blind_rotate_compact(_t(acc0), _t(bara), key, p)
    assert brc.launches == before                       # CPU tensors: plain version
    np.testing.assert_array_equal(out.numpy(), want)


def test_plain_rotation_matches_rows_scan_at_128bit_width():
    p = jparams.default_128bit_params()
    rows, acc0, bara = _rotation_inputs(p, 2, 3, seed=3)
    want = np.asarray(jboot.blind_rotate(jnp.asarray(acc0), jnp.asarray(bara.T),
                                         jnp.asarray(rows), p, rotation_impl="gather"))
    out = brc.blind_rotate_compact_plain(_t(acc0), _t(bara), _t(rows), p)
    np.testing.assert_array_equal(out.numpy(), want)
    before = brc.launches
    np.testing.assert_array_equal(
        bootstrap.blind_rotate(_t(acc0), _t(bara.T), _t(rows), p).numpy(), want)
    assert brc.launches == before                       # CPU tensors: plain version


def test_wrapper_checks_its_inputs():
    p = jparams.test_params()
    rows, acc0, bara = _rotation_inputs(p, 4, 2, seed=4)
    with pytest.raises(ValueError, match="shape mismatch"):
        brc.blind_rotate_compact(_t(acc0), _t(bara[:, :1]), _t(rows), p)
    with pytest.raises(ValueError, match="limbs"):
        brc.prepare_compact_bk(_t(rows), 0)


def test_reference_int8_digit_fault_is_refused():
    """The reference's rows scan casts gadget digits to int8; at Bg=2^10 the
    digits reach +-512 and its result differs from the exact NTT scan, while
    at Bg=2^8 they agree.  The port raises where the reference is wrong."""
    for Bgbit, agrees in ((8, True), (10, False)):
        p = jparams.test_params(n=4, N=64, l=2, Bgbit=Bgbit)
        rows, acc0, bara = _rotation_inputs(p, p.n, 3, seed=Bgbit)
        scan = np.asarray(jboot.blind_rotate(jnp.asarray(acc0), jnp.asarray(bara.T),
                                             jnp.asarray(rows), p, rotation_impl="gather"))
        ctx = jntt.context_for_params(p)
        exact = np.asarray(jntt.blind_rotate_ntt(
            jnp.asarray(acc0), jnp.asarray(bara), jntt.prepare_key_ntt_np(rows, ctx), p, ctx))
        assert np.array_equal(scan, exact) == agrees
        if agrees:
            np.testing.assert_array_equal(
                brc.blind_rotate_compact(_t(acc0), _t(bara), _t(rows), p).numpy(), exact)
        else:
            with pytest.raises(ValueError, match="halfBg"):
                brc.blind_rotate_compact(_t(acc0), _t(bara), _t(rows), p)
            with pytest.raises(ValueError, match="digit bound"):
                polymul.small_by_torus_matmul(torch.zeros((4, 64), dtype=torch.int32),
                                              _t(rows[0]), x_bound=p.tgsw_params.halfBg)


# --- eval-key forms, gates and config on shared keys -------------------------

@pytest.fixture(scope="module")
def shared():
    p = jparams.test_params()
    jk = jkeys.new_random_gate_bootstrapping_secret_keyset(jax.random.key(3), p)
    bk = jk.cloud.bk
    tk = keys.keyset_from_numpy(
        np.asarray(jk.lwe_key.s), np.asarray(jk.tgsw_key.key), np.asarray(bk.bk),
        np.asarray(bk.bk_variance), np.asarray(bk.ks.ks), np.asarray(bk.ks.variance),
        device="cpu")
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, (3, 7)).astype(bool)
    cts = [jgates.encrypt_bit(jax.random.key(10 + i), jnp.asarray(x), jk.lwe_key, p)
           for i, x in enumerate(bits)]
    return dict(p=p, jk=jk, tk=tk, bits=bits, cts=cts,
                jek=jboot.prepare_eval_key(jk.cloud),
                tek=bootstrap.prepare_eval_key_fused(tk.cloud, p))


def test_eval_key_forms(shared):
    p, cloud = shared["p"], shared["tk"].cloud
    rows = bootstrap.prepare_eval_key(cloud, p)
    assert rows.form == "compact" and rows.compact_limbs == 4      # the reference's "rows"
    assert torch.equal(rows.bk_compact, cloud.bk.bk)
    fused = shared["tek"]
    assert fused.form == "compact" and torch.equal(fused.bk_compact, cloud.bk.bk)
    assert fused.n == p.n
    assert bootstrap.prepare_eval_key_chunked(cloud, p).form == "compact"
    with pytest.raises(ValueError, match="chunk"):
        bootstrap.prepare_eval_key_chunked(cloud, p, chunk=64)
    rounded = bootstrap.prepare_eval_key_fused(cloud, p, limbs=3)
    assert rounded.compact_limbs == 3
    assert torch.equal(rounded.bk_compact, brc.prepare_compact_bk(cloud.bk.bk, 3))
    with pytest.raises(ValueError, match="requires its key field"):
        bootstrap._check_eval_key(bootstrap.EvalKey(
            bk_rows=rows.bk_rows, bk_variance=rows.bk_variance,
            ks_prepared=rows.ks_prepared, ks=rows.ks, form="compact"))
    with pytest.raises(ValueError, match="unknown EvalKey form"):
        bootstrap._check_eval_key(bootstrap.EvalKey(
            bk_rows=rows.bk_rows, bk_variance=rows.bk_variance,
            ks_prepared=rows.ks_prepared, ks=rows.ks, form="rows"))
    p80 = jparams.default_80bit_params()
    for prepare in (bootstrap.prepare_eval_key, bootstrap.prepare_eval_key_fused):
        with pytest.raises(ValueError, match="halfBg"):
            prepare(cloud, p80)


@pytest.mark.parametrize("limbs", [4, 3])
def test_bootstrap_wo_ks_matches_reference(shared, limbs):
    p, ct = shared["p"], shared["cts"][0]
    jek = jboot.prepare_eval_key_fused(shared["jk"].cloud, limbs=limbs)
    ref = jboot.bootstrap_woKS(jnp.int32(jgates.MU_BOOL), ct, jek, p)
    for tek in (bootstrap.prepare_eval_key_fused(shared["tk"].cloud, p, limbs=limbs),) + (
            (bootstrap.prepare_eval_key(shared["tk"].cloud, p),) if limbs == 4 else ()):
        _assert_same_ct(ref, bootstrap.bootstrap_woKS(gates.MU_BOOL, _port_ct(ct), tek, p))


def test_mux_maj_refresh_match_reference(shared):
    p, (ca, cb, cc), bits = shared["p"], shared["cts"], shared["bits"]
    jek, tek, sk = shared["jek"], shared["tek"], shared["tk"].lwe_key
    tca, tcb, tcc = (_port_ct(c) for c in (ca, cb, cc))
    out = gates.mux(tca, tcb, tcc, tek, p)
    _assert_same_ct(jgates.mux(ca, cb, cc, jek, p), out)
    np.testing.assert_array_equal(gates.decrypt_bit(out, sk).numpy(),
                                  np.where(bits[0], bits[1], bits[2]))
    out = gates.maj(tca, tcb, tcc, tek, p)
    _assert_same_ct(jgates.maj(ca, cb, cc, jek, p), out)
    np.testing.assert_array_equal(gates.decrypt_bit(out, sk).numpy(), bits.sum(0) >= 2)
    out = gates.refresh(tca, tek, p)
    _assert_same_ct(jgates.refresh(ca, jek, p), out)
    np.testing.assert_array_equal(gates.decrypt_bit(out, sk).numpy(), bits[0])


def test_config_dispatch_and_gate_api(shared):
    p, tk = shared["p"], shared["tk"]
    forms = {"rows": "compact", "fused": "compact", "ntt": "ntt_kernel",
             "ntt_rounded": "ntt_kernel"}
    for form, expect in forms.items():
        ek = config.FrameworkConfig(param_set="test", eval_key_form=form).prepare_eval_key(
            tk.cloud, p)
        assert ek.form == expect
    api = config.FrameworkConfig(param_set="test", eval_key_form="fused").make_gate_api(tk, p)
    assert api.eval_key.form == "compact" and api.params is p
    ca, cb = (_port_ct(c) for c in shared["cts"][:2])
    a, b = shared["bits"][:2]
    np.testing.assert_array_equal(gates.decrypt_bit(api.nand(ca, cb), tk.lwe_key).numpy(),
                                  ~(a & b))
    np.testing.assert_array_equal(
        gates.decrypt_bit(api.mux(ca, cb, ca), tk.lwe_key).numpy(), np.where(a, b, a))
    assert api.constant(np.array([True, False])).b.device.type == "cpu"
    for form in ("fused", "rows"):
        with pytest.raises(ValueError, match="halfBg"):
            config.FrameworkConfig(param_set="80", eval_key_form=form).prepare_eval_key(
                tk.cloud)


def test_config_fields_validate_and_roundtrip_like_reference():
    assert config.EVAL_KEY_FORM_CHOICES == jconfig.EVAL_KEY_FORM_CHOICES
    assert config.ROTATION_IMPL_CHOICES == jconfig.ROTATION_IMPL_CHOICES
    assert (config.FrameworkConfig.__dataclass_fields__.keys()
            == jconfig.FrameworkConfig.__dataclass_fields__.keys())
    assert config.DEFAULT_CONFIG.to_json() == jconfig.DEFAULT_CONFIG.to_json()
    for bad in (dict(eval_key_form="chunked"), dict(rotation_impl="warp")):
        with pytest.raises(ValueError):
            config.FrameworkConfig(**bad)
    cfg = config.FrameworkConfig(param_set="80", eval_key_form="ntt_rounded",
                                 rotation_impl="gather")
    assert config.FrameworkConfig.from_json(cfg.to_json()) == cfg
    assert jconfig.FrameworkConfig.from_json(cfg.to_json()).to_json() == cfg.to_json()
    # fields whose consumer is not ported yet keep their default or are refused
    changed = dict(mesh_dp=4, mesh_tp=4, batch_size=512, serving_max_batch=64,
                   serving_max_delay_s=0.1, serving_pipeline_chunk=32)
    assert changed.keys() == config.NOT_PORTED.keys()
    for name, value in changed.items():
        jconfig.FrameworkConfig(**{name: value})
        with pytest.raises(ValueError, match=f"{name}=.*not ported yet"):
            config.FrameworkConfig(**{name: value})
    # the API's fields have their consumers (api.tfhe, utils.profiling)
    cfg = config.FrameworkConfig(enable_jwt=False, jwt_rs256=True, profile_echo=True)
    assert cfg.to_json() == jconfig.FrameworkConfig(
        enable_jwt=False, jwt_rs256=True, profile_echo=True).to_json()
    for name in ("128", "80", "test"):
        assert (dataclasses.asdict(config.FrameworkConfig(param_set=name).params())
                == dataclasses.asdict(jconfig.FrameworkConfig(param_set=name).params()))
