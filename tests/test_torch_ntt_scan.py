"""The port's "ntt_scan" eval-key form and its blind rotation against the JAX package.

The form's key is the reference's v1 kernel key (n, P, F, K, 2M) int8 over
either prime pair.  On the CPU its blind rotation runs the plain version,
held bit for bit against the reference's XLA scan (``ntt.blind_rotate_ntt``)
and, where that kernel is right, against its Pallas kernel in interpret
mode.  For halfBg > 128 the reference's kernel is wrong (ROADMAP C3) and the
port must give the scan's bits.  Gates and circuits over the form use a
keyset of the port's keygen, carried to the reference by
``tests/torch_reference.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoc_tfhe_tpu.circuits import adder as jadder
from eoc_tfhe_tpu.core import bootstrap as jboot
from eoc_tfhe_tpu.core import gates as jgates
from eoc_tfhe_tpu.core import params as jparams
from eoc_tfhe_tpu.ops import ntt as jntt
from eoc_tfhe_tpu.ops import pallas_ntt_blindrot as jpnb

from eoc_tfhe_tpu_torch.circuits import adder
from eoc_tfhe_tpu_torch.core import bootstrap, gates
from eoc_tfhe_tpu_torch.kernels import build
from eoc_tfhe_tpu_torch.ops import blind_rotate, blind_rotate_v1, ntt

from torch_reference import assert_same_ct, keyset_pair, rotation_inputs, to_port

CASES = {
    "toy": lambda: jparams.test_params(n=16, N=64, k=1, l=3, Bgbit=7),
    "bgbit10": lambda: jparams.test_params(n=8, N=64, k=1, l=2, Bgbit=10),
    "full_width_8_steps": lambda: jparams.default_128bit_params(),
}
PRIMES = {"default": ntt.DEFAULT_PRIMES, "kernel": ntt.KERNEL_PRIMES}


def _contexts(p, primes):
    tg = p.tgsw_params
    ref = jntt.make_context(N=tg.tlwe_params.N, J=tg.kpl, halfBg=tg.halfBg, primes=primes)
    mine = ntt.make_context(tg.tlwe_params.N, tg.kpl, tg.halfBg, primes, device="cpu")
    return ref, mine


def test_scan_context_matches_reference():
    for case in CASES:
        p = CASES[case]()
        ref = jntt.context_for_params(p)
        ctx = ntt.context_for_params(p, device="cpu")
        assert ntt.DEFAULT_PRIMES == jntt.DEFAULT_PRIMES
        assert (ctx.N, ctx.R, ctx.F, ctx.primes, ctx.key_limbs, ctx.key_limb_bits) == (
            ref.N, ref.R, ref.F, ref.primes, ref.key_limbs, ref.key_limb_bits)
    p80 = jparams.default_80bit_params()
    ctx80 = ntt.context_for_params(p80, device="cpu")
    assert (ctx80.key_limbs, ctx80.key_limb_bits, p80.tgsw_params.halfBg) == (4, 8, 512)


@pytest.mark.parametrize("primes", list(PRIMES))
@pytest.mark.parametrize("case", list(CASES))
def test_scan_key_and_relayouts_match_reference(case, primes):
    p = CASES[case]()
    rows, _, _ = rotation_inputs(p, 3, 1, 1)
    jctx, ctx = _contexts(p, PRIMES[primes])
    T8 = jntt.prepare_key_ntt_np(rows, jctx, as_numpy=True).T8
    want = jpnb.prepare_kernel_key_np(T8)
    key = ntt.prepare_key_ntt(torch.from_numpy(rows), ctx)
    assert key.dtype == torch.int8 and key.is_contiguous()
    np.testing.assert_array_equal(key.numpy(), want)
    np.testing.assert_array_equal(ntt.scan_to_v1_key(torch.from_numpy(T8)).numpy(), want)
    np.testing.assert_array_equal(ntt.v1_key_to_scan(key, ctx).numpy(), T8)
    # the byte pairs rebuild the int16 residues of the other form's layout
    np.testing.assert_array_equal(ntt.join_key_bytes(key).numpy(),
                                  ntt.kernel_key_residues(torch.from_numpy(rows), ctx).numpy())


@pytest.mark.parametrize("primes", list(PRIMES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_v1_rotation_matches_reference(case, primes):
    p = CASES[case]()
    n_steps, B = min(p.n, 8), 3
    rows, acc0, bara = rotation_inputs(p, n_steps, B, 2)
    jctx, ctx = _contexts(p, PRIMES[primes])
    jkey = jntt.prepare_key_ntt_np(rows, jctx)
    ref_scan = np.asarray(jntt.blind_rotate_ntt(jnp.asarray(acc0), jnp.asarray(bara), jkey,
                                                p, jctx))
    key = ntt.prepare_key_ntt(torch.from_numpy(rows), ctx)
    before = blind_rotate_v1.launches
    out = blind_rotate_v1.blind_rotate_ntt_v1(torch.from_numpy(acc0), torch.from_numpy(bara),
                                              key, ctx, p)
    assert blind_rotate_v1.launches == before            # CPU tensors: plain version
    np.testing.assert_array_equal(out.numpy(), ref_scan)
    if p.tgsw_params.halfBg <= 128:                      # where the reference's kernel is right
        ref_kernel = np.asarray(jpnb.blind_rotate_ntt_pallas(
            jnp.asarray(acc0), jnp.asarray(bara), jnp.asarray(key.numpy()), jctx, p,
            block_b=B, interpret=True))
        np.testing.assert_array_equal(out.numpy(), ref_kernel)


def test_c3_reference_kernel_is_wrong_for_wide_digits_and_the_port_is_not():
    """ROADMAP C3: the reference's K3 casts gadget digits to int8, so at
    halfBg = 512 it leaves the scan form's bits; the port keeps them."""
    p = jparams.test_params(n=4, N=64, k=1, l=2, Bgbit=10)
    assert p.tgsw_params.halfBg == 512
    rows, acc0, bara = rotation_inputs(p, p.n, 4, 3)
    jctx = jntt.context_for_params(p)
    ctx = ntt.context_for_params(p, device="cpu")
    jkey = jntt.prepare_key_ntt_np(rows, jctx, as_numpy=True)
    scan = np.asarray(jntt.blind_rotate_ntt(jnp.asarray(acc0), jnp.asarray(bara),
                                            jntt.NttKey(T8=jnp.asarray(jkey.T8), variance=0.0),
                                            p, jctx))
    ref_kernel = np.asarray(jpnb.blind_rotate_ntt_pallas(
        jnp.asarray(acc0), jnp.asarray(bara), jnp.asarray(jpnb.prepare_kernel_key_np(jkey.T8)),
        jctx, p, block_b=4, interpret=True))
    assert not np.array_equal(ref_kernel, scan)
    out = blind_rotate_v1.blind_rotate_ntt_v1(
        torch.from_numpy(acc0), torch.from_numpy(bara),
        ntt.prepare_key_ntt(torch.from_numpy(rows), ctx), ctx, p)
    np.testing.assert_array_equal(out.numpy(), scan)


def test_wrapper_checks_shapes_and_devices():
    p = CASES["toy"]()
    rows, acc0, bara = rotation_inputs(p, 4, 2, 4)
    ctx = ntt.context_for_params(p, device="cpu")
    key = ntt.prepare_key_ntt(torch.from_numpy(rows), ctx)
    with pytest.raises(ValueError, match="shape mismatch"):
        blind_rotate_v1.blind_rotate_ntt_v1(torch.from_numpy(acc0),
                                            torch.from_numpy(bara[:, :1]), key, ctx, p)
    with pytest.raises(ValueError, match="shape mismatch"):    # an int16-layout key
        blind_rotate_v1.blind_rotate_ntt_v1(torch.from_numpy(acc0), torch.from_numpy(bara),
                                            ntt.join_key_bytes(key), ctx, p)
    with pytest.raises(ValueError, match="unsupported device"):
        blind_rotate_v1.blind_rotate_ntt_v1(torch.from_numpy(acc0).to("meta"),
                                            torch.from_numpy(bara), key, ctx, p)


def test_kernel_build_hashes_included_headers(tmp_path, monkeypatch):
    # K3 runs on K1's tensor-core header; the CUDA-core header is gone
    assert [s.name for s in build._sources("blind_rotate_ntt_v1")] == [
        "blind_rotate_ntt_v1.cu", "crt_ntt_mma.cuh"]
    assert not (build.SRC_DIR / "crt_ntt_rotate.cuh").exists()
    assert "blind_rotate_ntt_v1" in build.SIGNATURES
    for src in build.SRC_DIR.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "SRC_DIR", tmp_path)
    for header_name, users in (("crt_ntt_mma.cuh", {"blind_rotate_ntt", "blind_rotate_ntt_v1"}),
                               ("blind_rotate_ntt_v1.cu", {"blind_rotate_ntt_v1"})):
        before = {name: build._target(name) for name in build.SIGNATURES}
        header = tmp_path / header_name
        header.write_bytes(header.read_bytes() + b"\n// edited\n")
        after = {name: build._target(name) for name in build.SIGNATURES}
        assert {name for name in build.SIGNATURES if after[name] != before[name]} == users


# --- the eval-key form and the gates over it --------------------------------

@pytest.fixture(scope="module")
def env():
    p = jparams.test_params()
    jk, tk = keyset_pair(p, 11)
    rng = np.random.default_rng(12)
    bits = rng.integers(0, 2, (3, 4)).astype(bool)
    cts = [jgates.encrypt_bit(jax.random.key(20 + i), jnp.asarray(b), jk.lwe_key, p)
           for i, b in enumerate(bits)]
    jek = jboot.prepare_eval_key_ntt(jk.cloud, p, kernel=False)
    assert jek.form == "ntt_scan"
    return dict(p=p, jk=jk, tk=tk, bits=bits, cts=cts, jek=jek,
                tek=bootstrap.prepare_eval_key_ntt(tk.cloud, p, kernel=False))


def test_eval_key_forms(env):
    p, tk, ek = env["p"], env["tk"], env["tek"]
    assert ek.form == "ntt_scan" and ek.ntt_ctx.primes == ntt.DEFAULT_PRIMES
    assert ek.bk_ntt.dtype == torch.int8 and ek.bk_ntt_kernel is None
    for kernel in ("auto", True):
        ekk = bootstrap.prepare_eval_key_ntt(tk.cloud, p, kernel=kernel)
        assert ekk.form == "ntt_kernel" and ekk.ntt_ctx.primes == ntt.KERNEL_PRIMES
    with pytest.raises(ValueError, match="kernel must be"):
        bootstrap.prepare_eval_key_ntt(tk.cloud, p, kernel="yes")
    with pytest.raises(ValueError, match="requires ntt_ctx"):
        bootstrap._check_eval_key(bootstrap.EvalKey(
            bk_rows=ek.bk_rows, bk_variance=ek.bk_variance, ks_prepared=ek.ks_prepared,
            ks=ek.ks, form="ntt_scan", bk_ntt=ek.bk_ntt))
    assert "ntt_scan" in bootstrap.EVAL_KEY_FORMS


def test_gates_over_the_scan_key_match_reference(env):
    p, jek, tek = env["p"], env["jek"], env["tek"]
    ca, cb, cc = env["cts"]
    a, b, c = env["bits"]
    before = (blind_rotate_v1.launches, blind_rotate.launches)
    ref = jgates.nand(ca, cb, jek, p)
    out = gates.nand(to_port(ca), to_port(cb), tek, p)
    assert_same_ct(ref, out)
    np.testing.assert_array_equal(gates.decrypt_bit(out, env["tk"].lwe_key).numpy(), ~(a & b))
    ref = jgates.mux(ca, cb, cc, jek, p)
    out = gates.mux(to_port(ca), to_port(cb), to_port(cc), tek, p)
    assert_same_ct(ref, out)
    np.testing.assert_array_equal(gates.decrypt_bit(out, env["tk"].lwe_key).numpy(),
                                  np.where(a, b, c))
    assert (blind_rotate_v1.launches, blind_rotate.launches) == before


def test_fast_add_over_the_scan_key_matches_reference(env):
    p, jek, tek, jk = env["p"], env["jek"], env["tek"], env["jk"]
    rng = np.random.default_rng(13)
    av, bv = rng.integers(0, 256, 2), rng.integers(0, 256, 2)

    def word(vals, seed):
        bits = np.stack([(vals >> i) & 1 for i in range(8)]).astype(bool)
        return jgates.encrypt_bit(jax.random.key(seed), jnp.asarray(bits), jk.lwe_key, p)
    ca, cb = word(av, 30), word(bv, 31)
    ref_s, ref_c = jadder.ripple_carry_add(ca, cb, jek, p)
    out_s, out_c = adder.ripple_carry_add(to_port(ca), to_port(cb), tek, p)
    assert_same_ct(ref_s, out_s)
    assert_same_ct(ref_c, out_c)
    bits = gates.decrypt_bit(out_s, env["tk"].lwe_key).numpy().astype(np.int64)
    np.testing.assert_array_equal(sum(bits[i] << i for i in range(8)), (av + bv) % 256)
