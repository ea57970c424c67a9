"""Closed loop of one data-parallel gate over the cards of one host, a rank a card.

Traffic keys: ``gate`` (a two-input gate of ``reference.gates.LINEAR``),
``batch`` (samples a rank: a call takes ``batch`` x dp), ``pool`` (input
batches encrypted in set-up, whole and equal on every rank, taken in turn),
``rows_per_call`` (samples of each call's gathered output kept on every
rank, drawn from the seed over the whole call before the window),
``check_rows`` (of rank 0's kept samples, those the reference recomputes),
``trace_calls`` (calls in the traced sub-window, from the window's third,
traced on every rank).  The configuration's ``framework`` gives the layout:
``mesh_dp`` x ``mesh_tp`` ranks, rank r on card r.

Rank 0 is the harness's process.  It starts ranks 1.. as processes of this
module (``child_command``), and every rank joins one process group (NCCL on
the cards, gloo on the CPU) through a file store, plus a gloo group that
carries the loop's control.  Rank 0 makes the keys and the pool from the
seed and hands the cloud key and the pool to the other ranks through the
port's ``mesh.replicate``; each rank prepares its own eval key
(``FrameworkConfig.prepare_eval_key``) and calls
``parallel.sharded.make_sharded_gate`` on the whole batch: its dp slice
bootstrapped, the output gathered on every rank.

The window opens and closes on a synchronize of every rank's card and a
barrier; calls go back to back with at most two in flight, and after each
call rank 0 says whether another follows.  ``bootstraps_per_s`` is the
window's samples over its seconds on rank 0's clock; ``setup_s`` runs from
rank 0's process start and holds the ranks' start.  Each rank reduces its
own trace (the device seconds queued inside ``tfhe.parallel.gather``, its
idle share) and hands the numbers to rank 0, with its rows for the check.

Checks: ``words_off`` and ``bits_off`` of rank 0's kept rows against the
reference, as ``closed_batch``'s; ``ranks_off``, the kept rows of every
rank that differ from rank 0's.

Failure: rank 0 watches the ranks; when one exits non-zero, or rank 0
raises, every rank is killed and rank 0 exits non-zero.  A rank exits when
rank 0, its parent, dies.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from collections import deque
from pathlib import Path

import torch
import torch.distributed as dist

from .. import harness as H
from .. import spans as S
from ..reference import gates as G
from ..reference import tfhe as ref

#: Calls with a row set of their own; later calls reuse them in turn.
CALL_ROWS = 1024

#: Seconds rank 0 waits for the ranks to exit once their work is done.
EXIT_S = 120


def inside_s(trace, name: str) -> float | None:
    """Device seconds of the operations queued while a span named ``name``
    was open on the queuing thread, the spans nested in it included.  None
    where the trace holds no device operation or no such span."""
    outer = [s for s in S.program_spans(trace) if s.name == name]
    ops = S.linked_ops(trace)
    if not ops or not outer:
        return None

    def within(s):
        return any(o.thread == s.thread and o.start <= s.start and s.end <= o.end
                   for o in outer)
    return sum(b - a for _, a, b, s in ops if s is not None and within(s))


class PortProgram:
    """The system under test: the sharded two-input gate on the eval key of
    the configuration's form."""

    def __init__(self, cell, cloud, p, mesh, pool_a, pool_b, var):
        from eoc_tfhe_tpu_torch.parallel import sharded

        pp = H.port_params(p)
        self.ek = H.framework_config(cell.config).prepare_eval_key(cloud, pp)
        num, den, sa, sb = G.LINEAR[cell.traffic["gate"]]
        self.fn = sharded.make_sharded_gate(mesh, pp, ref.t32(num, den), sa, sb)
        self.pool_a, self.pool_b, self.var = pool_a, pool_b, var

    def call(self, i: int):
        a, b, v = self.pool_a[i], self.pool_b[i], self.var
        out = self.fn(a[0], b[0], v, a[1], b[1], v, self.ek)
        return out[0], out[1]


class ReferenceProgram:
    """The control: each rank's dp slice through the reference, its products
    in float32, gathered over dp as the program gathers."""

    def __init__(self, cell, cloud, p, mesh, pool_a, pool_b, var):
        keys = ref.Keys(lwe=None, ring=None, bk=cloud.bk.bk, ks=cloud.bk.ks.ks)
        self.g = G.Gates(keys, p, torch.float32)
        self.kind, self.mesh = cell.traffic["gate"], mesh
        self.pool_a, self.pool_b = pool_a, pool_b

    def call(self, i: int):
        from eoc_tfhe_tpu_torch.parallel.mesh import batch_slice

        m = self.mesh
        ops = [(H.words(batch_slice(self.pool_a[i, j], m)),
                H.words(batch_slice(self.pool_b[i, j], m))) for j in range(2)]
        return tuple(m.all_gather(ref.wrap(x), "dp", 0) for x in self.g.gate(self.kind, *ops))


def _cloud_like(p: ref.Params, device):
    """A cloud key of ``p``'s shapes, zero: what ``mesh.replicate`` fills."""
    from eoc_tfhe_tpu_torch.core.keys import BootstrappingKey, CloudKeySet, KeySwitchKey

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)
    ks = KeySwitchKey(ks=z(p.k * p.N, p.ks_t, 1 << p.ks_basebit, p.n + 1),
                      variance=z(dtype=torch.float32))
    return CloudKeySet(bk=BootstrappingKey(bk=z(p.n, p.kpl, p.k + 1, p.N),
                                           bk_variance=z(dtype=torch.float32), ks=ks))


def _rank_body(cell, args, rank: int, world: int, store: str, marks: dict) -> dict:
    """One rank's part of the run, the same code on every rank; rank 0's
    return holds what the check needs, every rank's the numbers it hands on."""
    from eoc_tfhe_tpu_torch.ops import blind_rotate, blind_rotate_compact
    from eoc_tfhe_tpu_torch.parallel import distributed
    from eoc_tfhe_tpu_torch.parallel import mesh as M

    dev, tr = args.device, cell.traffic
    distributed.initialize(f"file://{store}", world, rank, device=dev)
    control = dist.new_group(backend="gloo")
    mesh = H.framework_config(cell.config).make_mesh(device=dev)
    p = ref.Params.from_config(cell.config["params"])
    P, B = tr["pool"], tr["batch"] * mesh.dp
    shape = (P, 2, B)
    keys = bits = None
    if rank == 0:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        keys = ref.keygen(gen, p)
        bits = torch.randint(0, 2, shape, generator=gen, device=dev).bool()
        pool = [H.encrypt_bits(gen, x, keys, p) for x in bits.reshape(-1, B)]
        pool_a = torch.stack([a for a, _ in pool]).reshape(shape + (p.n,))
        pool_b = torch.stack([b for _, b in pool]).reshape(shape)
        cloud = H.port_keyset(keys, p, dev).cloud
        del pool
    else:
        pool_a = torch.zeros(shape + (p.n,), dtype=torch.int32, device=dev)
        pool_b = torch.zeros(shape, dtype=torch.int32, device=dev)
        cloud = _cloud_like(p, dev)
    H.device_sync(dev)
    marks["keys"] = H.process_age_s()
    cloud, pool_a, pool_b = M.replicate((cloud, pool_a, pool_b), mesh)
    var = torch.full((B,), float(torch.tensor(p.ks_stdev, dtype=torch.float32) ** 2),
                     dtype=torch.float32, device=dev)
    program = (ReferenceProgram if args.control else PortProgram)(
        cell, cloud, p, mesh, pool_a, pool_b, var)
    H.device_sync(dev)
    marks["program"] = H.process_age_s()
    for i in range(min(P, 2)):          # every shape of the window, and the kernel loaded
        program.call(i)
    H.device_sync(dev)
    dist.barrier(group=control)
    setup_s = H.process_age_s()

    keep = torch.randint(0, B, (CALL_ROWS, tr["rows_per_call"]),
                         generator=torch.Generator().manual_seed(args.seed)).to(dev)
    trace = H.Trace(dev) if args.trace else None
    if trace is not None:
        trace.prepare()
    setup_peak = H.peak_reset(dev)
    launched = (blind_rotate.launches, blind_rotate_compact.launches)
    go = torch.ones(1, dtype=torch.int32)
    kept, pending, calls = [], deque(), 0
    H.device_sync(dev)
    dist.barrier(group=control)
    t0 = time.perf_counter()
    while go[0]:
        if trace is not None and calls == 2:
            trace.start()
        rows = keep[calls % CALL_ROWS]
        kept.append(tuple(x.index_select(0, rows) for x in program.call(calls % P)))
        calls += 1
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > 2:
                pending.popleft().synchronize()
        if trace is not None and trace.active and calls == 2 + tr["trace_calls"]:
            trace.stop()
        if rank == 0:
            traced = trace is None or calls >= 2 + tr["trace_calls"]
            go[0] = not (traced and time.perf_counter() - t0 >= args.seconds)
        dist.broadcast(go, src=0, group=control)
    H.device_sync(dev)
    dist.barrier(group=control)
    window_s = time.perf_counter() - t0
    peaks = {"set-up": setup_peak, "window": H.peak_reset(dev)}
    launches = (blind_rotate.launches - launched[0], blind_rotate_compact.launches - launched[1])

    del program
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    got_a, got_b = (torch.cat([k[j] for k in kept]) for j in range(2))
    del kept
    first_a, first_b = got_a.clone(), got_b.clone()
    dist.broadcast(first_a, src=0)        # rank 0's kept rows, to every rank
    dist.broadcast(first_b, src=0)
    share = {"rank": rank, "calls": calls, "rows_off": H.rows_off(got_a, got_b, first_a, first_b),
             "gather_s": inside_s(trace, "tfhe.parallel.gather") if trace else None,
             "idle": H.idle_share(trace) if trace else None, "peaks": peaks,
             "k1_launches": launches[0], "k2_launches": launches[1]}
    shares = [None] * world
    dist.all_gather_object(shares, share, group=control)
    dist.destroy_process_group()          # on every rank at once: NCCL's teardown waits for all
    return dict(shares=shares, calls=calls, window_s=window_s, setup_s=setup_s, B=B,
                keys=keys, bits=bits, pool_a=pool_a, pool_b=pool_b, keep=keep, trace=trace,
                got_a=got_a, got_b=got_b, peaks=peaks)


def child_args(cell, args, rank: int, world: int, store: str) -> list[str]:
    """The arguments of rank ``rank``'s process (:func:`child_main`)."""
    return ["--root", str(cell.root), "--workload", cell.workload["name"], "--rank", str(rank),
            "--world", str(world), "--store", store, "--seed", str(args.seed),
            "--seconds", str(args.seconds), "--trace", str(int(args.trace)),
            "--device", args.device.type, "--parent", str(os.getpid())] + \
        (["--control"] if args.control else [])


def child_command(cell, args, rank: int, world: int, store: str) -> list[str]:
    return [sys.executable, "-m", __name__] + child_args(cell, args, rank, world, store)


def _child_env() -> dict:
    """Rank 0's environment, with this benchmark's checkout and the port's
    root first on the path, so that every rank runs the same code."""
    import eoc_tfhe_tpu_torch

    paths = [str(Path(__file__).resolve().parents[2]),
             str(Path(eoc_tfhe_tpu_torch.__file__).resolve().parents[1])]
    if os.environ.get("PYTHONPATH"):
        paths.append(os.environ["PYTHONPATH"])
    return dict(os.environ, PYTHONPATH=os.pathsep.join(paths))


def _fail(procs, tmp: str) -> None:
    """End every rank and this process, non-zero."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
    for proc in procs:
        proc.wait()
    shutil.rmtree(tmp, ignore_errors=True)
    sys.stderr.flush()
    os._exit(1)


def _watch(procs, tmp: str, done: threading.Event) -> None:
    """Rank 0's watch of the ranks: the first that exits non-zero ends every
    rank and this process."""
    while not done.wait(0.2):
        for r, proc in enumerate(procs, 1):
            if proc.poll() not in (None, 0):
                print(f"dp_batch: rank {r} exited {proc.returncode}; ending every rank",
                      file=sys.stderr, flush=True)
                _fail(procs, tmp)


def run(cell, args) -> H.Outcome:
    marks = {"start": H.process_age_s()}
    fw = cell.config["framework"]
    world = fw.get("mesh_dp", 1) * fw.get("mesh_tp", 1)
    if args.device.type == "cuda" and world != cell.workload["chips"]:
        raise SystemExit(f"the layout has {world} ranks; the cell asks for "
                         f"{cell.workload['chips']} chips")
    tmp = tempfile.mkdtemp(prefix="dp_batch-")
    store = os.path.join(tmp, "store")
    procs, done = [], threading.Event()
    try:
        env = _child_env()
        procs = [subprocess.Popen(child_command(cell, args, r, world, store), env=env,
                                  stdout=sys.stderr.fileno()) for r in range(1, world)]
        threading.Thread(target=_watch, args=(procs, tmp, done), daemon=True).start()
        marks["ranks"] = H.process_age_s()
        res = _rank_body(cell, args, 0, world, store, marks)
        done.set()
        for r, proc in enumerate(procs, 1):
            if proc.wait(timeout=EXIT_S):
                raise RuntimeError(f"rank {r} exited {proc.returncode}")
    except BaseException:
        done.set()
        traceback.print_exc()
        _fail(procs, tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    return _outcome(cell, args, res, marks)


def _outcome(cell, args, res: dict, marks: dict) -> H.Outcome:
    """Rank 0's check of its kept rows against the reference, and the result."""
    t_check = time.perf_counter()
    dev, tr, kind = args.device, cell.traffic, cell.traffic["gate"]
    p = ref.Params.from_config(cell.config["params"])
    calls, B, P, m = res["calls"], res["B"], tr["pool"], tr["rows_per_call"]
    pick = torch.randperm(calls * m, generator=torch.Generator().manual_seed(args.seed))
    pick = pick[:min(tr["check_rows"], calls * m)].sort().values.to(dev)
    got_a, got_b = res["got_a"].index_select(0, pick), res["got_b"].index_select(0, pick)
    call_of = pick // m
    row_of = res["keep"][call_of % CALL_ROWS, pick % m]
    pool_of = call_of % P
    ops = [(H.words(res["pool_a"][pool_of, j, row_of]), H.words(res["pool_b"][pool_of, j, row_of]))
           for j in range(2)]
    want_a, want_b = G.Gates(res["keys"], p).gate(kind, *ops)
    want_bits = G.PLAIN[kind](*res["bits"][pool_of, :, row_of].t())
    got_bits = ref.decrypt_bits(got_a, got_b, res["keys"].lwe)
    shares = res["shares"]
    checks = {"words_off": (H.rows_off(got_a, got_b, want_a, want_b), 0),
              "bits_off": (int((got_bits != want_bits).sum()), 0),
              "ranks_off": (sum(s["rows_off"] for s in shares), 0)}

    def each(key, fmt=str):
        return ", ".join("-" if s[key] is None else fmt(s[key]) for s in shares)
    print(f"ranks: calls {each('calls')}; K1 launches {each('k1_launches')}; K2 launches "
          f"{each('k2_launches')}; memory peaks "
          f"{', '.join(str(max(s['peaks'].values())) for s in shares)} B; gather device ms "
          f"{each('gather_s', lambda x: f'{x * 1e3:.3f}')}; idle % {each('idle')}",
          file=sys.stderr, flush=True)
    window_s = res["window_s"]
    return H.Outcome(
        attempted=calls * B, failed=0,
        e2e={"bootstraps_per_s": calls * B / window_s, "setup_s": res["setup_s"]},
        checks=checks, trace=res["trace"],
        memory_peak_bytes=max(max(s["peaks"].values()) for s in shares),
        counters={"setup_marks": marks, "memory_peaks": res["peaks"], "calls": calls,
                  "window_s": window_s, "batch": B, "calls_traced": tr["trace_calls"],
                  "bootstraps_traced": tr["trace_calls"] * B,
                  "check_s": time.perf_counter() - t_check, "checked": len(pick),
                  "ranks": shares})


def _exit_with_parent(parent: int) -> None:
    """End this process when rank 0, its parent, dies: the kernel's
    parent-death signal (Linux ``prctl``), and an exit now where rank 0
    died before it was set."""
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)     # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        os._exit(1)


def child_main(argv=None) -> None:
    """Rank r >= 1: the rank body, then exit."""
    from benchmark.run import RunArgs

    ap = argparse.ArgumentParser(description="one rank of a dp_batch cell")
    for name in ("--root", "--workload", "--store", "--device"):
        ap.add_argument(name, required=True)
    for name in ("--rank", "--world", "--seed", "--trace", "--parent"):
        ap.add_argument(name, type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    a = ap.parse_args(argv)
    _exit_with_parent(a.parent)
    cell = H.Cell.find(Path(a.root), a.workload)
    dev = torch.device("cuda", a.rank) if a.device == "cuda" else torch.device("cpu")
    args = RunArgs(seed=a.seed, seconds=a.seconds, trace=bool(a.trace), device=dev,
                   control=a.control)
    _rank_body(cell, args, a.rank, a.world, a.store, {})
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)         # its work handed on, the rank skips the interpreter's teardown


if __name__ == "__main__":
    child_main()
