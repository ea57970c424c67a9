"""Rank bodies of the port's multi-process tests, and the parent's launcher.

Each rank is its own interpreter (``python tests/torch_parallel_worker.py
JOB RANK WORLD DIR``) that imports torch, numpy and the port only: never JAX
nor the JAX package.  The ranks join one gloo group on the CPU through a
``FileStore`` in DIR, read their inputs from ``DIR/inputs.npz``, run JOB and
write ``DIR/out<rank>.npz``.  The test (parent) makes the inputs with the
JAX package and holds the ranks' outputs against it.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent


def run_ranks(job: str, world: int, workdir, inputs: dict, env: dict | None = None,
              timeout: float = 240.0) -> list[dict]:
    """Run ``job`` on ``world`` ranks; returns each rank's outputs."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    np.savez(workdir / "inputs.npz", **inputs)
    child_env = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
    procs = [subprocess.Popen([sys.executable, str(Path(__file__)), job, str(r), str(world),
                               str(workdir)], env=child_env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {job} exited {p.returncode}:\n{log}")
    return [dict(np.load(workdir / f"out{r}.npz")) for r in range(world)]


# ---------------------------------------------------------------------------
# Rank side: imports only torch and the port.
# ---------------------------------------------------------------------------

def _ct(inp, prefix):
    import torch
    from eoc_tfhe_tpu_torch.core.lwe import LweCiphertext
    return LweCiphertext(*(torch.from_numpy(inp[f"{prefix}_{f}"]) for f in ("a", "b", "var")))


def _keyset(inp):
    from eoc_tfhe_tpu_torch.core import keys
    return keys.keyset_from_numpy(inp["lwe_s"], inp["tgsw_key"], inp["bk"], inp["bk_var"],
                                  inp["ks"], inp["ks_var"], device="cpu")


def _job_parallel(inp, out) -> None:
    """Mesh layouts, the dp NAND, the resharded restart, the tp rotations."""
    import torch
    import torch.distributed as dist
    from eoc_tfhe_tpu_torch.config import FrameworkConfig
    from eoc_tfhe_tpu_torch.core import bootstrap, gates, lwe, params
    from eoc_tfhe_tpu_torch.io import tfhe_io
    from eoc_tfhe_tpu_torch.parallel import distributed, mesh, sharded

    for dp, tp in ((None, 1), (2, 2), (4, 1), (1, 4)):
        m = mesh.make_mesh(dp, tp, device="cpu")
        key = f"mesh_{m.dp}x{m.tp}"
        out[key] = np.array([m.rank, *m.coords])
        for axis in m.axis_names:
            g = m.group(axis)
            out[f"{key}_{axis}"] = np.array(
                [m.rank] if g is None else dist.get_process_group_ranks(g))
    m = distributed.make_hybrid_mesh(tp=2, device="cpu")
    out["hybrid"] = np.array([m.dp, m.tp, *m.coords,
                              *dist.get_process_group_ranks(m.tp_group)])
    try:
        distributed.make_hybrid_mesh(tp=4, device="cpu")
        out["hybrid_tp4_refused"] = np.array(False)
    except ValueError:
        out["hybrid_tp4_refused"] = np.array(True)

    p = params.test_params()
    ks = _keyset(inp)
    ek = bootstrap.prepare_eval_key(ks.cloud, p)
    ca, cb = _ct(inp, "ca"), _ct(inp, "cb")

    def nand(m, ek, ks):
        fn = sharded.make_sharded_nand(m, p)
        return fn(ca.a, ca.b, ca.current_variance, cb.a, cb.b, cb.current_variance,
                  ek.bk_rows, ek.bk_variance, ek.ks_prepared, ks.cloud.bk.ks.variance)

    for dp, tp in ((2, 2), (4, 1)):
        for f, x in zip(("a", "b", "var"), nand(mesh.make_mesh(dp, tp, device="cpu"), ek, ks)):
            out[f"nand_{dp}x{tp}_{f}"] = x.numpy()
    # the resharded restart: each layout restarts from the checkpoint blob
    for dp, tp in ((2, 2), (4, 1), (1, 4)):
        ks2, _ = tfhe_io.import_secret_keyset(inp["blob"].tobytes(), device="cpu")
        ek2 = bootstrap.prepare_eval_key(ks2.cloud, p)
        cfg = FrameworkConfig(param_set="test", mesh_dp=dp, mesh_tp=tp)
        oa, ob, _ = nand(cfg.make_mesh(device="cpu"), ek2, ks2)
        out[f"restart_{dp}x{tp}_a"], out[f"restart_{dp}x{tp}_b"] = oa.numpy(), ob.numpy()

    # the tp rotations over the "ntt_scan" key
    eks = bootstrap.prepare_eval_key_ntt(ks.cloud, p, kernel=False)
    ctx = eks.ntt_ctx
    acc0, bara = torch.from_numpy(inp["acc0"]), torch.from_numpy(inp["bara"])
    m = mesh.make_mesh(2, 2, device="cpu")
    out["rows_tp2"] = sharded.blind_rotate_ntt_tp(
        acc0, bara, sharded.shard_ntt_key_rows(eks.bk_ntt, m), p, ctx, m).numpy()
    for dp, tp in ((2, 2), (1, 4)):
        m = mesh.make_mesh(dp, tp, device="cpu")
        key_f = sharded.shard_ntt_key_freq(eks.bk_ntt, m)
        out[f"freq_tp{tp}"] = sharded.blind_rotate_ntt_freq_tp(acc0, bara, key_f, p, ctx,
                                                               m).numpy()
        fn = sharded.make_sharded_nand_freq(m, p, ctx)
        res = fn(ca.a, ca.b, ca.current_variance, cb.a, cb.b, cb.current_variance, key_f,
                 eks.bk_variance, eks.ks_prepared, ks.cloud.bk.ks.variance)
        for f, x in zip(("a", "b", "var"), res):
            out[f"freq_nand_tp{tp}_{f}"] = x.numpy()

    # the scaling harness over the dp NAND
    m = mesh.make_mesh(2, 2, device="cpu")

    def run_fn(mm, B):
        idx = torch.arange(B) % ca.b.shape[0]
        xa, xb = (lwe.LweCiphertext(c.a[idx], c.b[idx], c.current_variance[idx])
                  for c in (ca, cb))
        if mm is None:
            return lambda: gates.nand(xa, xb, ek, p)
        fn = sharded.make_sharded_nand(mm, p)
        return lambda: fn(xa.a, xa.b, xa.current_variance, xb.a, xb.b, xb.current_variance,
                          ek.bk_rows, ek.bk_variance, ek.ks_prepared, ks.cloud.bk.ks.variance)

    rep = distributed.scaling_report(run_fn, [2], m, iters=1)
    pt = rep["points"][0]
    out["scaling"] = np.array([rep["devices"], pt["batch_per_device"], pt["single_dev_per_s"],
                               pt["mesh_per_s"], pt["per_chip_per_s"],
                               pt["scaling_efficiency"]])


def _job_parallel_form(inp, out) -> None:
    """The dp NAND on the eval key that FrameworkConfig prepares ("ntt": K1's
    plain version here), per parameter set and layout: rank 0 holds the
    keyset and hands the cloud key to the others through ``mesh.replicate``;
    each rank prepares its own eval key.  One call of the (4, 1) layout runs
    again under a profiler for its spans and collective bytes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from eoc_tfhe_tpu_torch.config import FrameworkConfig
    from eoc_tfhe_tpu_torch.core import gates, keys, lwe, params
    from eoc_tfhe_tpu_torch.parallel import mesh, sharded

    for s in inp["sets"]:
        p = params.test_params(Bgbit=int(inp[f"{s}_Bgbit"]))
        host = [inp[f"{s}_{k}"] for k in ("lwe", "ring", "bk", "bk_var", "ks", "ks_var")]
        m0 = mesh.make_mesh(device="cpu")
        if m0.rank:     # only rank 0 holds the keyset: the others take its shapes
            host = [np.zeros_like(x) for x in host]
        ks = keys.keyset_from_numpy(*host, device="cpu")
        cloud = mesh.replicate(ks.cloud, m0)
        ca, cb = (lwe.LweCiphertext(*(torch.from_numpy(inp[f"{s}_{c}_{f}"])
                                      for f in ("a", "b", "var"))) for c in ("ca", "cb"))
        args = (ca.a, ca.b, ca.current_variance, cb.a, cb.b, cb.current_variance)
        for dp, tp in ((4, 1), (2, 2)):
            cfg = FrameworkConfig(param_set="test", eval_key_form="ntt", mesh_dp=dp,
                                  mesh_tp=tp)
            m = cfg.make_mesh(device="cpu")
            ek = cfg.prepare_eval_key(cloud, p)
            fn = sharded.make_sharded_nand(m, p)
            for f, x in zip(("a", "b", "var"), fn(*args, ek)):
                out[f"{s}_{dp}x{tp}_{f}"] = x.numpy()
            out[f"{s}_form"] = np.array(ek.form)
            if (dp, tp) == (4, 1) and s == inp["sets"][0]:
                sent = mesh.collective_bytes
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    fn(*args, ek)
                out["collective_bytes"] = np.array(mesh.collective_bytes - sent)
                out["spans"] = np.array(sorted({e.name for e in prof.events()
                                                if e.name.startswith("tfhe.")}))
        one = gates.nand(ca, cb, cfg.prepare_eval_key(cloud, p), p)
        for f, x in zip(("a", "b", "var"), (one.a, one.b, one.current_variance)):
            out[f"{s}_one_{f}"] = x.numpy()


def _job_native_keys(inp, out) -> None:
    """Row-sharded key and dp-sharded batch round trips, and the directory
    the JAX package wrote: read, rewritten, and read back."""
    import torch
    from eoc_tfhe_tpu_torch.io import native_keys
    from eoc_tfhe_tpu_torch.parallel import mesh, sharded

    key, var = torch.from_numpy(inp["key"]), torch.tensor(inp["variance"])
    m = mesh.make_mesh(1, 2, device="cpu")
    tree = {"key": sharded.shard_ntt_key_rows(key, m), "variance": var}
    d = inp["dir"].item()
    man = native_keys.save_pytree(os.path.join(d, "rows"), tree, mesh=m)
    out["rows_shards"] = np.array(man["tensors"]["t0"]["shards"])
    got = native_keys.load_pytree(os.path.join(d, "rows"), tree, mesh=m)
    out["rows_block"] = got["key"].local.numpy()
    out["rows_block_want"] = tree["key"].local.numpy()
    out["rows_spec"] = np.array([e is not None for e in got["key"].spec])
    out["rows_variance"] = got["variance"].numpy()
    try:
        native_keys.load_pytree(os.path.join(d, "rows"), tree, device="cpu")
        out["rows_without_mesh_refused"] = np.array(False)
    except ValueError:
        out["rows_without_mesh_refused"] = np.array(True)
    try:
        native_keys.load_pytree(os.path.join(d, "rows"), tree,
                                mesh=mesh.make_mesh(2, 1, device="cpu"))
        out["rows_mesh_mismatch_refused"] = np.array(False)
    except ValueError:
        out["rows_mesh_mismatch_refused"] = np.array(True)

    m_dp = mesh.make_mesh(2, 1, device="cpu")
    x = torch.arange(8 * 5, dtype=torch.int32).reshape(8, 5)
    xs = mesh.shard(x, (("dp",),), m_dp)
    native_keys.save_pytree(os.path.join(d, "batch"), [xs], mesh=m_dp)
    (gx,) = native_keys.load_pytree(os.path.join(d, "batch"), [xs], mesh=m_dp)
    out["batch_block"], out["batch_block_want"] = gx.local.numpy(), xs.local.numpy()

    # the JAX package's directory (its T8, cut over tp) read, then rewritten
    T8 = torch.from_numpy(inp["T8"])
    spec = (None,) * 5 + (("tp",), None)
    like = {"T8": mesh.shard(T8, spec, m), "variance": var}
    got = native_keys.load_pytree(os.path.join(d, "jax"), like, mesh=m)
    out["jax_block"], out["jax_block_want"] = got["T8"].local.numpy(), like["T8"].local.numpy()
    out["jax_variance"] = got["variance"].numpy()
    native_keys.save_pytree(os.path.join(d, "port"), got, mesh=m)


def _job_llama(inp, out) -> None:
    """The llama forward at tp=2 on this rank's shard of the weights."""
    import torch
    from eoc_tfhe_tpu_torch.models import llama
    from eoc_tfhe_tpu_torch.parallel import mesh

    cfg = llama.LlamaConfig(**{k[4:]: int(v) for k, v in inp.items() if k.startswith("cfg_")})
    p = llama.params_from_numpy({k[2:]: v for k, v in inp.items() if k.startswith("p_")},
                                device="cpu")
    m = mesh.make_mesh(1, 2, device="cpu")
    local = llama.shard_params(p, llama.llama_param_specs(cfg), m)
    toks = torch.from_numpy(inp["tokens"])
    out["local_wq_cols"] = np.array(local["wq"].shape[-1])
    out["logits"] = llama.forward(local, toks, cfg, compute_dtype=torch.float32,
                                  tp_group=m.tp_group).numpy()
    # prefill fills this rank's kv heads; a decode step continues from them
    last, cache = llama.prefill(local, toks, cfg, compute_dtype=torch.float32,
                                tp_group=m.tp_group)
    nxt, _ = llama.decode_step(local, cache, toks.shape[1], toks[:, 0], cfg,
                               compute_dtype=torch.float32, tp_group=m.tp_group)
    out["prefill_last"], out["decode_next"] = last.numpy(), nxt.numpy()
    out["cache_shape"] = np.array(cache.shape)


def _main(job: str, rank: int, world: int, workdir: str) -> None:
    sys.path.insert(0, str(_HERE.parent))
    import torch
    torch.set_num_threads(1)
    from eoc_tfhe_tpu_torch.parallel import distributed

    store = os.path.join(workdir, "store")
    if not distributed.initialize(f"file://{store}", world, rank, device="cpu"):
        raise RuntimeError(f"no group of {world} ranks formed")
    with np.load(os.path.join(workdir, "inputs.npz")) as f:
        inp = dict(f)
    out = {}
    {"parallel": _job_parallel, "parallel_form": _job_parallel_form,
     "native_keys": _job_native_keys, "llama": _job_llama}[job](inp, out)
    out["imported_jax"] = np.array(any(name == "jax" or name.startswith(("jax.", "eoc_tfhe_tpu."))
                                       or name == "eoc_tfhe_tpu" for name in sys.modules))
    np.savez(os.path.join(workdir, f"out{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
