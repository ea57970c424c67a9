"""The port's core modules against the JAX package, on the CPU.

Inputs come from numpy with a fixed seed and go through both packages;
every deterministic function must agree bit for bit.
"""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoc_tfhe_tpu.core import lwe as jlwe
from eoc_tfhe_tpu.core import numeric as jnum
from eoc_tfhe_tpu.core import params as jparams
from eoc_tfhe_tpu.core import tgsw as jtgsw
from eoc_tfhe_tpu.core import tlwe as jtlwe
from eoc_tfhe_tpu.ops import polymul as jpoly
from eoc_tfhe_tpu.ops import rotate as jrot

from eoc_tfhe_tpu_torch.core import lwe, numeric, params, tgsw, tlwe
from eoc_tfhe_tpu_torch.core import keys
from eoc_tfhe_tpu_torch.ops import polymul, rotate

from torch_reference import keyset_pair, to_port


def _i32(rng, shape):
    x = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    x.reshape(-1)[:4] = [-2**31, 2**31 - 1, 0, -1]     # the wrap edges
    return x


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("name", ["default_128bit_params", "default_80bit_params",
                                  "test_params"])
def test_params_field_equal(name):
    ref, port = getattr(jparams, name)(), getattr(params, name)()
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    assert ref.tgsw_params.h == port.tgsw_params.h
    assert ref.tgsw_params.offset == port.tgsw_params.offset
    assert ref.tgsw_params.kpl == port.tgsw_params.kpl


def test_mod_switches_bit_identical():
    rng = np.random.default_rng(0)
    x = _i32(rng, (4096,))
    for Msize in (2, 8, 2048, 1 << 16):
        np.testing.assert_array_equal(
            np.asarray(jnum.mod_switch_from_torus32(jnp.asarray(x), Msize)),
            numeric.mod_switch_from_torus32(_t(x), Msize).numpy())
        mu = rng.integers(-Msize, Msize, 512).astype(np.int32)
        np.testing.assert_array_equal(
            np.asarray(jnum.mod_switch_to_torus32(jnp.asarray(mu), Msize)),
            numeric.mod_switch_to_torus32(_t(mu), Msize).numpy())
    for num, den in [(1, 8), (-1, 8), (1, 4), (3, 2**31 - 1)]:
        assert int(jnum.mod_switch_to_torus32_np(num, den)) == int(
            numeric.mod_switch_to_torus32_np(num, den))
    for d in (0.125, -0.25, 0.3, 1e-9, -0.4999):
        assert jnum.double_to_t32(d) == numeric.double_to_t32(d)


def test_dtot32_bit_identical():
    rng = np.random.default_rng(1)
    d = np.concatenate([rng.normal(size=2048) * 1e-3, rng.uniform(-3, 3, 2048),
                        [0.5, -0.5, 0.999999, -0.999999]]).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jnum.dtot32(jnp.asarray(d))),
                                  numeric.dtot32(_t(d)).numpy())


def test_decompose_h_bit_identical():
    rng = np.random.default_rng(2)
    for p in (jparams.default_128bit_params(), jparams.default_80bit_params(),
              jparams.test_params()):
        x = _i32(rng, (5, 2, p.N))
        np.testing.assert_array_equal(
            np.asarray(jtgsw.decompose_h(jnp.asarray(x), p.tgsw_params)),
            tgsw.decompose_h(_t(x), p.tgsw_params).numpy())


def test_mul_by_xai_bit_identical():
    rng = np.random.default_rng(3)
    N = 64
    x = _i32(rng, (6, 2, N))
    a = rng.integers(0, 2 * N, (6, 1)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jrot.mul_by_xai_gather(jnp.asarray(x), jnp.asarray(a))),
        rotate.mul_by_xai(_t(x), _t(a)).numpy())


@pytest.mark.parametrize("index", [0, 5, 63])
def test_extraction_bit_identical(index):
    rng = np.random.default_rng(4)
    x = _i32(rng, (3, 2, 64))
    var = np.float32([1e-5, 2e-5, 3e-5])
    ref = jtlwe.tlwe_extract_lwe_sample(
        jtlwe.TLweCiphertext(a=jnp.asarray(x), current_variance=jnp.asarray(var)), index)
    out = tlwe.tlwe_extract_lwe_sample(
        tlwe.TLweCiphertext(a=_t(x), current_variance=_t(var)), index)
    np.testing.assert_array_equal(np.asarray(ref.a), out.a.numpy())
    np.testing.assert_array_equal(np.asarray(ref.b), out.b.numpy())


def test_lwe_phase_and_linear_ops_bit_identical():
    rng = np.random.default_rng(5)
    n = 630
    a1, a2 = _i32(rng, (32, n)), _i32(rng, (32, n))
    b1, b2 = _i32(rng, (32,)), _i32(rng, (32,))
    v = rng.uniform(0, 1e-4, 32).astype(np.float32)
    s = rng.integers(0, 2, n).astype(np.int32)
    jx = jlwe.LweCiphertext(a=jnp.asarray(a1), b=jnp.asarray(b1), current_variance=jnp.asarray(v))
    jy = jlwe.LweCiphertext(a=jnp.asarray(a2), b=jnp.asarray(b2), current_variance=jnp.asarray(v))
    tx = lwe.LweCiphertext(a=_t(a1), b=_t(b1), current_variance=_t(v))
    ty = lwe.LweCiphertext(a=_t(a2), b=_t(b2), current_variance=_t(v))
    np.testing.assert_array_equal(np.asarray(jlwe.lwe_phase(jx, jlwe.LweKey(s=jnp.asarray(s)))),
                                  lwe.lwe_phase(tx, lwe.LweKey(s=_t(s))).numpy())
    for p in (-2, -1, 1, 2):
        r, o = jlwe.lwe_add_mul(jx, p, jy), lwe.lwe_add_mul(tx, p, ty)
        np.testing.assert_array_equal(np.asarray(r.a), o.a.numpy())
        np.testing.assert_array_equal(np.asarray(r.b), o.b.numpy())
        np.testing.assert_array_equal(np.asarray(r.current_variance),
                                      o.current_variance.numpy())
    r, o = jlwe.lwe_negate(jx), lwe.lwe_negate(tx)
    np.testing.assert_array_equal(np.asarray(r.a), o.a.numpy())
    np.testing.assert_array_equal(np.asarray(r.b), o.b.numpy())


def test_limbs_bit_identical():
    rng = np.random.default_rng(6)
    x = _i32(rng, (64, 9))
    ref = np.asarray(jpoly.decompose_signed_limbs(jnp.asarray(x)))
    out = polymul.decompose_signed_limbs(_t(x))
    np.testing.assert_array_equal(ref, out.numpy())
    np.testing.assert_array_equal(polymul.recombine_limbs(out, dim=-1).numpy(), x)


@pytest.mark.parametrize("J,N", [(1, 64), (2, 64), (1, 1024)])
def test_keygen_polymul_bit_identical(J, N):
    rng = np.random.default_rng(7)
    a = _i32(rng, (5, J, N))
    key = rng.integers(0, 2, (J, N)).astype(np.int32)
    ref = np.asarray(jpoly.torus_by_small_shared_matmul(jnp.asarray(a), jnp.asarray(key)))
    np.testing.assert_array_equal(
        ref, polymul.torus_by_small_shared_matmul(_t(a), _t(key)).numpy())


def test_port_keygen_decrypts_fresh_encryptions():
    p = params.test_params()
    gen = torch.Generator(device="cpu").manual_seed(11)
    ks = keys.new_random_gate_bootstrapping_secret_keyset(gen, p, device="cpu")
    mu = torch.tensor([2**29, -2**29, 2**28, 0], dtype=torch.int32)
    ct = lwe.lwe_sym_encrypt(gen, mu, p.in_out_params.alpha_min, ks.lwe_key)
    err = (lwe.lwe_phase(ct, ks.lwe_key).to(torch.int64) - mu).abs()
    assert int(err.max()) < 2**20
    # the ring key decrypts the bootstrapping key's body rows: row (l + q)
    # holds s_i * h[q] on coefficient 0 of the body
    rows = ks.cloud.bk.bk                           # (n, kpl, k+1, N)
    mask = rows[:, :, 0, :]
    body = rows[:, :, 1, :]
    prod = polymul.torus_by_small_shared_matmul(mask[..., None, :], ks.tgsw_key.key)
    phase = numeric.wrap32(body.to(torch.int64) - prod.to(torch.int64))
    h = p.tgsw_params.h
    expect = torch.zeros_like(phase[:, p.l:, :], dtype=torch.int64)
    for q in range(p.l):
        expect[:, q, 0] = ks.lwe_key.s.to(torch.int64) * h[q]
    err = (phase[:, p.l:, :].to(torch.int64) - expect).abs()
    assert int(err.max()) < 2**16


def test_port_imports_neither_jax_nor_reference():
    code = textwrap.dedent("""
        import sys, importlib, pkgutil
        before = set(sys.modules)
        import eoc_tfhe_tpu_torch
        for m in pkgutil.walk_packages(eoc_tfhe_tpu_torch.__path__, "eoc_tfhe_tpu_torch."):
            importlib.import_module(m.name)
        bad = [m for m in set(sys.modules) - before if m.split(".")[0] in
               ("jax", "jaxlib", "eoc_tfhe_tpu")]
        assert not bad, bad
        print("clean")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = params.test_params()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        keys.new_random_gate_bootstrapping_secret_keyset(torch.Generator(), p)
    from eoc_tfhe_tpu_torch.core import gates
    from eoc_tfhe_tpu_torch.ops import ntt
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gates.constant(np.array([True]), p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ntt.kernel_context_for_params(p)


def test_dataclass_accessors_match_reference():
    """The reference's dataclass accessors (``KeySwitchKey.n_in/t/base/n_out``,
    ``BootstrappingKey.n``, ``n`` and ``batch_shape`` of the LWE samples,
    ``kpl/k/N`` of a TGSW sample, ``k/N`` of a TLWE sample and key) on a
    JAX-made keyset carried across (``tests/torch_reference.py``), and
    ``native.b64encode`` against the reference's encoder (binascii's bytes)."""
    import base64

    import jax
    from eoc_tfhe_tpu import native as jnative
    from eoc_tfhe_tpu.core import gates as jgates
    from eoc_tfhe_tpu_torch import native

    p = jparams.test_params(k=2, l=2, N=64, n=8)     # k, N, kpl and n all differ
    jk, tk = keyset_pair(p, 5, keygen="reference")
    jbk, bk = jk.cloud.bk, tk.cloud.bk
    for name in ("n_in", "t", "base", "n_out"):
        assert getattr(bk.ks, name) == getattr(jbk.ks, name), name
    assert bk.n == jbk.n == 8
    assert (tk.tgsw_key.k, tk.tgsw_key.N) == (jk.tgsw_key.k, jk.tgsw_key.N) == (2, 64)

    def t(x):
        return torch.from_numpy(np.array(x))
    bits = jnp.asarray(np.array([[True, False, True], [False, False, True]]))
    jct = jgates.encrypt_bit(jax.random.key(6), bits, jk.lwe_key, p)
    ct = to_port(jct)
    assert (ct.n, tuple(ct.batch_shape)) == (jct.n, tuple(jct.batch_shape)) == (8, (2, 3))
    jsd = jgates.encrypt_bit_seeded(jax.random.key(7), bits, jk.lwe_key, p)
    sd = to_port(jsd)
    assert tuple(sd.batch_shape) == tuple(jsd.batch_shape) == (2, 3)
    var = np.zeros(jbk.bk.shape[:1], np.float32)
    jg = jtgsw.TGswCiphertext(rows=jbk.bk, current_variance=jnp.asarray(var))
    g = tgsw.TGswCiphertext(rows=bk.bk, current_variance=t(var))
    assert (g.kpl, g.k, g.N) == (jg.kpl, jg.k, jg.N) == (6, 2, 64)
    jr = jtlwe.TLweCiphertext(a=jbk.bk[:, 0], current_variance=jnp.asarray(var))
    r = tlwe.TLweCiphertext(a=bk.bk[:, 0], current_variance=t(var))
    assert (r.k, r.N) == (jr.k, jr.N) == (2, 64)
    data = bytes(range(256)) * 3 + b"xy"
    assert native.b64encode(data) == base64.b64encode(data).decode()
    ref = jnative.b64encode(data)          # None where the reference's library is not built
    assert ref is None or native.b64encode(data) == ref
