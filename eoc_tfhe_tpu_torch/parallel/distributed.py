"""Multi-process runtime: process-group init, hybrid meshes, scaling.

Port of ``eoc_tfhe_tpu/parallel/distributed.py`` onto ``torch.distributed``.
One process (rank) drives one device.  :func:`initialize` forms the process
group, :func:`make_hybrid_mesh` lays dp across hosts and tp inside one, and
:func:`scaling_report` measures throughput per rank against one device.

The backend follows the device: NCCL for CUDA, gloo for the CPU.  NCCL
refuses two ranks on one GPU, so ranks that share a card pass
``backend="gloo"``; the collectives then move CUDA tensors through the host
(``mesh._on_backend``).
"""

from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh, rank_device

#: How long a collective waits for the other ranks before it raises.
TIMEOUT = datetime.timedelta(minutes=10)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None, device=None) -> bool:
    """Join (or skip) the multi-process group.

    Resolution order: explicit arguments (``coordinator_address`` is
    ``host:port`` or an ``init_method`` URL such as ``file:///path``), then
    the standard ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``
    variables, else a single-process no-op.  Returns True when a group of
    more than one rank is (already) active; a second call is a no-op.

    ``device`` is this rank's (:func:`~.mesh.rank_device`: the card unless
    the caller names the CPU); ``backend`` defaults to NCCL on a card and gloo
    on the CPU.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and num_processes is None:
        if not all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
            return False            # single-process mode; nothing to join
        init_method = "env://"
    else:
        init_method = coordinator_address or "env://"
        if "://" not in init_method:
            init_method = f"tcp://{init_method}"
    world = num_processes if num_processes is not None else int(env["WORLD_SIZE"])
    rank = process_id if process_id is not None else int(env["RANK"])
    dev = rank_device(device, rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=TIMEOUT)
    return dist.get_world_size() > 1


def make_hybrid_mesh(tp: int = 1, dp: int | None = None, device=None) -> Mesh:
    """(dp, tp) mesh with dp across hosts and tp inside one host.

    Hosts are ``LOCAL_WORLD_SIZE`` ranks each, host-major (rank r on host
    r // LOCAL_WORLD_SIZE), so rank r at (r // tp, r % tp) keeps every tp
    group on one host whenever tp divides the ranks per host.  One host (or
    no ``LOCAL_WORLD_SIZE``) is the flat :func:`~.mesh.make_mesh`.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_host:
        raise ValueError(f"{world} ranks are not whole hosts of {per_host}")
    n_hosts = world // per_host
    if n_hosts > 1:
        if per_host % tp:
            raise ValueError(f"tp={tp} must divide ranks/host={per_host} (tp crosses "
                             "hosts otherwise: the keyswitch sum would leave the host)")
        want_dp = n_hosts * (per_host // tp)
        if dp is not None and dp != want_dp:
            raise ValueError(f"dp={dp} inconsistent with {n_hosts} hosts x "
                             f"{per_host // tp} local")
    return make_mesh(dp=dp, tp=tp, device=device)


def scaling_report(run_fn, batch_sizes, mesh: Mesh, iters: int = 3) -> dict:
    """Measure throughput per rank on ``mesh`` against one device.

    ``run_fn(mesh_or_none, B) -> callable()`` returns a nullary step of batch
    B; this harness times it and computes scaling efficiency = (throughput
    per rank on the mesh) / (throughput on one device).  On one rank the
    point measures the sharded path's overhead, not scaling.
    """
    n_dev = mesh.dp * mesh.tp
    out = {"devices": n_dev, "points": []}
    for B in batch_sizes:
        base = _time_throughput(run_fn(None, B), B, iters, mesh.device)
        multi = _time_throughput(run_fn(mesh, B * n_dev), B * n_dev, iters, mesh.device)
        eff = (multi / n_dev) / base if base else float("nan")
        out["points"].append({
            "batch_per_device": B,
            "single_dev_per_s": base,
            "mesh_per_s": multi,
            "per_chip_per_s": multi / n_dev,
            "scaling_efficiency": eff,
        })
    return out


def _time_throughput(step, B: int, iters: int, device=None) -> float:
    """Items per second of ``step`` over ``iters`` calls after one warm call,
    on the host clock, each end synchronized with the card."""
    def sync():
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    step()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    sync()
    dt = (time.perf_counter() - t0) / iters
    return B / dt
