"""The port's sharded native key checkpoint (io/native_keys) against the JAX package.

The three cases of tests/test_native_keys.py run on the port: the
replicated round trip in this process, the row-sharded "ntt_scan" key and
a dp-sharded batch on two gloo ranks (``torch_parallel_worker.py``), each
rank writing only its own shard.  Then the directories cross: the reference
writes its tp-sharded key on its virtual devices and the port's ranks read
it and write it again; the reference reads the port's directory.  The shard
files must be the same bytes and the manifests the same apart from the
informational ``"treedef"``.
"""

import json
import os

import numpy as np
import pytest
import torch

from eoc_tfhe_tpu.core import bootstrap as jboot
from eoc_tfhe_tpu.core.params import test_params as jtest_params
from eoc_tfhe_tpu.io import native_keys as jnative_keys
from eoc_tfhe_tpu.parallel import mesh as jmesh
from eoc_tfhe_tpu.parallel import sharded as jsharded

from eoc_tfhe_tpu_torch.core import bootstrap
from eoc_tfhe_tpu_torch.io import native_keys
from torch_parallel_worker import run_ranks
from torch_reference import keyset_pair

P = jtest_params()


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    jk, tk = keyset_pair(P, 8, keygen="reference")
    jek = jboot.prepare_eval_key_ntt(jk.cloud, P)
    m42 = jmesh.make_mesh(dp=4, tp=2)
    jtree = {"T8": jsharded.shard_ntt_key_rows(jek.bk_ntt.T8, m42),
             "variance": jek.bk_ntt.variance}
    d = tmp_path_factory.mktemp("native_keys")
    jnative_keys.save_pytree(str(d / "jax"), jtree, mesh=m42)
    ek = bootstrap.prepare_eval_key_ntt(tk.cloud, P, kernel=False)
    outs = run_ranks("native_keys", 2, d / "ranks",
                     dict(key=ek.bk_ntt.numpy(), variance=np.asarray(jek.bk_ntt.variance),
                          T8=np.asarray(jek.bk_ntt.T8), dir=np.array(str(d))))
    return dict(d=d, jtree=jtree, m42=m42, tk=tk, ek=ek, outs=outs)


def test_replicated_pytree_roundtrip(tmp_path, shared):
    ek = bootstrap.prepare_eval_key(shared["tk"].cloud, P)
    tree = {"bk_rows": ek.bk_rows, "ks_prepared": ek.ks_prepared}
    man = native_keys.save_pytree(str(tmp_path), tree)
    assert man["tensors"]["t0"] == {"dtype": "int32", "shape": list(ek.bk_rows.shape),
                                    "spec": None, "shards": 1}
    got = native_keys.load_pytree(str(tmp_path), tree, device="cpu")
    for k in tree:
        assert torch.equal(got[k], tree[k])
    # the reference reads the port's replicated directory
    jgot = jnative_keys.load_pytree(str(tmp_path), {"bk_rows": 0, "ks_prepared": 0})
    for k in tree:
        np.testing.assert_array_equal(np.asarray(jgot[k]), tree[k].numpy())


def test_sharded_ntt_key_roundtrip(shared):
    """The "ntt_scan" key's K rows cut over tp=2: one shard file per tp slice,
    each rank reading back its own block with its spec."""
    K = shared["ek"].bk_ntt.shape[3]
    for r, out in enumerate(shared["outs"]):
        assert out["rows_shards"] == 2
        np.testing.assert_array_equal(out["rows_block"], out["rows_block_want"])
        np.testing.assert_array_equal(
            out["rows_block"], shared["ek"].bk_ntt[:, :, :, r * K // 2:(r + 1) * K // 2].numpy())
        np.testing.assert_array_equal(out["rows_spec"], [False, False, False, True, False])
        np.testing.assert_array_equal(out["rows_variance"], shared["ek"].bk_variance.numpy())
    files = sorted(os.listdir(shared["d"] / "rows"))
    assert files == ["MANIFEST.json", "t0.shard0.bin", "t0.shard1.bin", "t1.shard0.bin"]


def test_sharded_load_refuses_a_missing_or_other_mesh(shared):
    for out in shared["outs"]:
        assert out["rows_without_mesh_refused"] and out["rows_mesh_mismatch_refused"]
    with pytest.raises(ValueError, match="saved as 2 shards; pass the mesh"):
        native_keys.load_pytree(str(shared["d"] / "rows"),
                                {"key": torch.empty(0), "variance": torch.empty(0)},
                                device="cpu")


def test_dp_sharded_batch_roundtrip(shared):
    x = np.arange(8 * 5, dtype=np.int32).reshape(8, 5)
    for r, out in enumerate(shared["outs"]):
        np.testing.assert_array_equal(out["batch_block"], out["batch_block_want"])
        np.testing.assert_array_equal(out["batch_block"], x[4 * r:4 * (r + 1)])
    man = json.load(open(shared["d"] / "batch" / "MANIFEST.json"))
    assert man["tensors"]["t0"]["spec"] == [["dp"]] and man["tensors"]["t0"]["shards"] == 2


def test_directories_cross_between_the_packages(shared):
    """JAX writes, the port reads and writes again, JAX reads: same blocks,
    same shard bytes, same manifest but the treedef string."""
    d, T8 = shared["d"], np.asarray(shared["jtree"]["T8"])
    JR = T8.shape[5]
    for r, out in enumerate(shared["outs"]):
        np.testing.assert_array_equal(out["jax_block"], T8[:, :, :, :, :, r * JR // 2:
                                                           (r + 1) * JR // 2])
        np.testing.assert_array_equal(out["jax_block"], out["jax_block_want"])
        np.testing.assert_array_equal(out["jax_variance"],
                                      np.asarray(shared["jtree"]["variance"]))
    got = jnative_keys.load_pytree(str(d / "port"), shared["jtree"], mesh=shared["m42"])
    np.testing.assert_array_equal(np.asarray(got["T8"]), T8)
    assert got["T8"].sharding.spec[5] is not None
    np.testing.assert_array_equal(np.asarray(got["variance"]),
                                  np.asarray(shared["jtree"]["variance"]))
    files = sorted(os.listdir(d / "jax"))
    assert files == sorted(os.listdir(d / "port"))
    for name in files:
        if name != "MANIFEST.json":
            assert (d / "jax" / name).read_bytes() == (d / "port" / name).read_bytes(), name
    man_j, man_p = (json.load(open(d / w / "MANIFEST.json")) for w in ("jax", "port"))
    assert man_j.pop("treedef") and man_p.pop("treedef")
    assert man_j == man_p


def test_ranks_import_neither_jax_nor_the_reference(shared):
    assert not any(bool(out["imported_jax"]) for out in shared["outs"])
