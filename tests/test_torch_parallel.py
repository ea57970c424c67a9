"""The port's parallel tier (parallel/, FrameworkConfig.make_mesh) against the JAX package.

The port runs one process per rank: four ranks are spawned under gloo on
the CPU (``torch_parallel_worker.py``, which imports torch and the port
only), two "hosts" of two (``LOCAL_WORLD_SIZE=2``).  The reference runs the
same sharded functions on its 8 virtual CPU devices in this process.  The
keyset, the ciphertexts and the rotation inputs are the JAX package's,
carried to the ranks as numpy.  Every result is exact integer arithmetic
mod 2^32, so words and the variance rail must be bit-identical: to the
reference's sharded function and to its unsharded gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eoc_tfhe_tpu.core import bootstrap as jboot
from eoc_tfhe_tpu.core import gates as jgates
from eoc_tfhe_tpu.core.params import test_params as jtest_params
from eoc_tfhe_tpu.io import tfhe_io as jtfhe_io
from eoc_tfhe_tpu.ops import ntt as jntt
from eoc_tfhe_tpu.parallel import mesh as jmesh
from eoc_tfhe_tpu.parallel import sharded as jsharded

from eoc_tfhe_tpu_torch.core import gates, lwe
from eoc_tfhe_tpu_torch.parallel import distributed, mesh
from torch_parallel_worker import run_ranks
from torch_reference import keyset_pair

P = jtest_params()
WORLD = 4
A = np.tile(np.array([0, 0, 1, 1], bool), 2)
B = np.tile(np.array([0, 1, 0, 1], bool), 2)


@pytest.fixture(scope="module")
def ref():
    """The reference's keyset, inputs and sharded results on its virtual devices."""
    jk, tk = keyset_pair(P, 3, keygen="reference")
    ek = jboot.prepare_eval_key(jk.cloud)
    ca = jgates.encrypt_bit(jax.random.key(31), jnp.asarray(A), jk.lwe_key, P)
    cb = jgates.encrypt_bit(jax.random.key(32), jnp.asarray(B), jk.lwe_key, P)
    ks_var = jnp.float32(jk.cloud.bk.ks.variance)
    out = {"nand": jgates.nand(ca, cb, ek, P)}
    m42 = jmesh.make_mesh(dp=4, tp=2)
    out["sharded_nand"] = jsharded.make_sharded_nand(m42, P)(
        ca.a, ca.b, ca.current_variance, cb.a, cb.b, cb.current_variance,
        ek.bk_rows, ek.bk_variance, ek.ks_prepared, ks_var)

    ekn = jboot.prepare_eval_key_ntt(jk.cloud, P)
    ctx = ekn.ntt_ctx
    tl = P.tgsw_params.tlwe_params
    rng = np.random.default_rng(7)
    acc0 = rng.integers(-2**31, 2**31, (8, tl.k + 1, tl.N), dtype=np.int64).astype(np.int32)
    bara = rng.integers(0, 2 * tl.N, (P.n, 8), dtype=np.int64).astype(np.int32)
    out["scan"] = np.asarray(jntt.blind_rotate_ntt(jnp.asarray(acc0), jnp.asarray(bara),
                                                   ekn.bk_ntt, P, ctx))
    out["rows_tp"] = np.asarray(jsharded.blind_rotate_ntt_tp(
        jnp.asarray(acc0), jnp.asarray(bara), jsharded.shard_ntt_key_rows(ekn.bk_ntt.T8, m42),
        P, ctx, m42))
    out["freq_nand"] = jsharded.make_sharded_nand_freq(m42, P, ctx)(
        ca.a, ca.b, ca.current_variance, cb.a, cb.b, cb.current_variance,
        jsharded.shard_ntt_key_freq(ekn.bk_ntt.T8, m42), ek.bk_variance, ek.ks_prepared, ks_var)

    bk = jk.cloud.bk
    inputs = dict(lwe_s=np.asarray(jk.lwe_key.s), tgsw_key=np.asarray(jk.tgsw_key.key),
                  bk=np.asarray(bk.bk), bk_var=np.asarray(bk.bk_variance),
                  ks=np.asarray(bk.ks.ks), ks_var=np.asarray(bk.ks.variance),
                  acc0=acc0, bara=bara,
                  blob=np.frombuffer(jtfhe_io.export_secret_keyset(jk, P), np.uint8))
    for name, ct in (("ca", ca), ("cb", cb)):
        for f, x in (("a", ct.a), ("b", ct.b), ("var", ct.current_variance)):
            inputs[f"{name}_{f}"] = np.asarray(x)
    return dict(out=out, inputs=inputs, tk=tk)


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    """The port's results on four gloo ranks (two hosts of two)."""
    return run_ranks("parallel", WORLD, tmp_path_factory.mktemp("parallel"), ref["inputs"],
                     env={"LOCAL_WORLD_SIZE": "2"})


def _decrypts_to_nand(a, b, ref):
    ct = lwe.LweCiphertext(a=torch.from_numpy(a), b=torch.from_numpy(b),
                           current_variance=torch.zeros(b.shape))
    np.testing.assert_array_equal(gates.decrypt_bit(ct, ref["tk"].lwe_key).numpy(), ~(A & B))


def test_mesh_rank_layout(ranks):
    """Rank r sits at (r // tp, r % tp); its dp and tp groups are the column
    and the row of the layout (the reference's devices.reshape(dp, tp))."""
    for r, out in enumerate(ranks):
        for dp, tp in ((4, 1), (2, 2), (1, 4)):
            key = f"mesh_{dp}x{tp}"
            np.testing.assert_array_equal(out[key], [r, r // tp, r % tp])
            np.testing.assert_array_equal(out[f"{key}_dp"], [i * tp + r % tp for i in range(dp)]
                                          if dp > 1 else [r])
            np.testing.assert_array_equal(out[f"{key}_tp"], [(r // tp) * tp + j for j in range(tp)]
                                          if tp > 1 else [r])


def test_hybrid_mesh_two_hosts(ranks):
    """dp across the two hosts, tp inside each; a tp wider than a host is refused."""
    for r, out in enumerate(ranks):
        host = r // 2
        np.testing.assert_array_equal(out["hybrid"], [2, 2, host, r % 2, 2 * host, 2 * host + 1])
        assert out["hybrid_tp4_refused"]


def test_hybrid_mesh_single_host_fallback():
    assert distributed.initialize() is False  # single-process: no-op
    m = distributed.make_hybrid_mesh(tp=1, device="cpu")
    assert m.axis_names == ("dp", "tp") and m.shape == {"dp": 1, "tp": 1}
    with pytest.raises(ValueError, match="x tp=2 != 1 ranks"):
        distributed.make_hybrid_mesh(tp=2, device="cpu")


@pytest.mark.parametrize("layout", ["2x2", "4x1"])
def test_dp_sharded_nand_matches_reference(ranks, ref, layout):
    want, unsharded = ref["out"]["sharded_nand"], ref["out"]["nand"]
    for out in ranks:
        got = [out[f"nand_{layout}_{f}"] for f in ("a", "b", "var")]
        for g, w, u in zip(got, want, (unsharded.a, unsharded.b, unsharded.current_variance)):
            np.testing.assert_array_equal(g, np.asarray(w))
            np.testing.assert_array_equal(g, np.asarray(u))
    _decrypts_to_nand(ranks[0][f"nand_{layout}_a"], ranks[0][f"nand_{layout}_b"], ref)


@pytest.mark.parametrize("layout", ["2x2", "4x1", "1x4"])
def test_checkpoint_restart_resharded_mesh(ranks, ref, layout):
    """Twin of tests/test_recovery.py: every layout restarts from the keyset
    blob through FrameworkConfig(mesh_dp, mesh_tp).make_mesh and gives the
    same words as the reference's sharded NAND."""
    want = ref["out"]["sharded_nand"]
    for out in ranks:
        np.testing.assert_array_equal(out[f"restart_{layout}_a"], np.asarray(want[0]))
        np.testing.assert_array_equal(out[f"restart_{layout}_b"], np.asarray(want[1]))
    _decrypts_to_nand(ranks[0][f"restart_{layout}_a"], ranks[0][f"restart_{layout}_b"], ref)


def test_tp_external_product_matches_reference(ranks, ref):
    """TGSW-row split (key rows cut over tp=2) against the reference's
    blind_rotate_ntt_tp and its unsharded scan."""
    np.testing.assert_array_equal(ref["out"]["rows_tp"], ref["out"]["scan"])
    for out in ranks:
        np.testing.assert_array_equal(out["rows_tp2"], ref["out"]["rows_tp"])


@pytest.mark.parametrize("tp", [2, 4])
def test_freq_split_all_to_all_matches_reference(ranks, ref, tp):
    for out in ranks:
        np.testing.assert_array_equal(out[f"freq_tp{tp}"], ref["out"]["scan"])


@pytest.mark.parametrize("tp", [2, 4])
def test_gate_level_freq_split_nand(ranks, ref, tp):
    """Words and variance rail of the frequency-split NAND against the
    reference's make_sharded_nand_freq (tp=2) and its unsharded NAND."""
    want, unsharded = ref["out"]["freq_nand"], ref["out"]["nand"]
    for out in ranks:
        got = [out[f"freq_nand_tp{tp}_{f}"] for f in ("a", "b", "var")]
        for g, w, u in zip(got, want, (unsharded.a, unsharded.b, unsharded.current_variance)):
            np.testing.assert_array_equal(g, np.asarray(w))
            np.testing.assert_array_equal(g, np.asarray(u))
    _decrypts_to_nand(ranks[0][f"freq_nand_tp{tp}_a"], ranks[0][f"freq_nand_tp{tp}_b"], ref)


def test_scaling_report_harness(ranks):
    """The harness runs and reports per-rank throughput (no efficiency is
    asserted: the CPU ranks share cores)."""
    devices, batch, single, multi, per_chip, eff = ranks[0]["scaling"]
    assert (devices, batch) == (4, 2)
    assert single > 0 and multi > 0 and eff > 0
    assert per_chip == pytest.approx(multi / 4)


def test_ranks_import_neither_jax_nor_the_reference(ranks):
    assert not any(bool(out["imported_jax"]) for out in ranks)


def test_single_rank_mesh_collectives_and_shards():
    """Without a process group the world is one rank: collectives are the
    identity and a spec over sizes of 1 keeps the whole tensor."""
    m = mesh.make_mesh(device="cpu")
    assert (m.dp, m.tp, m.coords, m.dp_group, m.tp_group) == (1, 1, (0, 0), None, None)
    x = torch.arange(-6, 6, dtype=torch.int32).reshape(4, 3)
    assert m.psum(x, "tp") is x and m.all_gather(x, "dp", 1) is x
    assert m.all_to_all(x, "tp", 1, 0) is x
    s = mesh.shard(x, (("dp",), ("tp",)), m)
    assert torch.equal(s.local, x) and s.shape == (4, 3) and s.spec == (("dp",), ("tp",))
    ct = lwe.LweCiphertext(a=x, b=x[:, 0], current_variance=torch.zeros(4))
    assert torch.equal(mesh.shard_lwe_batch(ct, m).a, x)
    assert torch.equal(mesh.replicate({"k": [x]}, m)["k"][0], x)
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard(x, (("dp",),), mesh.Mesh(dp=3, tp=1, rank=0, device=m.device))


def test_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is taken")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
