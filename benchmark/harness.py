"""What every traffic driver of the benchmark shares: the cell's files, the
keys and inputs made from the seed, the hand-over of the keys to the system
under test, the traced sub-window and its reduction, and the checks.

The system under test is ``eoc_tfhe_tpu_torch``; it is imported here and
in the drivers, never in ``reference/``.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .reference import tfhe as ref

#: The benchmark's folder and the checkout's root.
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: Top-level module names that no run may hold once its window has closed
#: (compared whole: the port's own name begins with the JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "eoc_tfhe_tpu")


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is in FORBIDDEN_MODULES."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN_MODULES})


def process_age_s() -> float:
    """Seconds since this process started (Linux: its start time in clock
    ticks after boot against the uptime)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with its configuration and traffic."""

    root: Path
    bench: dict
    workload: dict
    config: dict
    traffic: dict

    @classmethod
    def find(cls, root: Path, name: str) -> "Cell":
        bench = load_json(root / "BENCHMARK.json")
        workload = _named(bench["workloads"], name, "workload")
        entry = _named(bench["configs"], workload["config"], "configuration")
        config = load_json(root / entry["file"])
        traffic = load_json(root / "benchmark" / "traffic" / f"{workload['traffic']}.json")
        return cls(root=root, bench=bench, workload=workload, config=config, traffic=traffic)

    def metrics(self, kind: str) -> list[dict]:
        """The cell's metrics of ``kind`` ("end_to_end" or "per_layer"): those
        that list this workload, or list none and move a metric this cell
        reports."""
        name = self.workload["name"]
        e2e = [m["name"] for m in self.bench["end_to_end"]
               if name in m.get("workloads", [name])]
        if kind == "end_to_end":
            return [m for m in self.bench["end_to_end"] if m["name"] in e2e]
        return [m for m in self.bench["per_layer"]
                if name in m.get("workloads", [name] if m["moves"] in e2e else [])]


def _named(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def port_params(p: ref.Params):
    """The system's parameter set object for the reference's ``p``."""
    from eoc_tfhe_tpu_torch.core import params as P

    tl = P.TLweParams(N=p.N, k=p.k, alpha_min=p.bk_stdev, alpha_max=p.max_stdev)
    return P.GateBootstrappingParams(
        ks=P.KeySwitchParams(t=p.ks_t, basebit=p.ks_basebit),
        in_out_params=P.LweParams(n=p.n, alpha_min=p.ks_stdev, alpha_max=p.max_stdev),
        tgsw_params=P.TGswParams(l=p.l, Bgbit=p.Bgbit, tlwe_params=tl))


def framework_config(config: dict):
    """The system's FrameworkConfig for the configuration's ``framework`` fields."""
    from eoc_tfhe_tpu_torch.config import FrameworkConfig

    return FrameworkConfig(**config["framework"])


def port_keyset(keys: ref.Keys, p: ref.Params, device):
    """The benchmark's keys as the system's secret keyset, through
    ``keys.keyset_from_numpy``."""
    from eoc_tfhe_tpu_torch.core.keys import keyset_from_numpy

    var = (np.float32(p.bk_stdev) * np.float32(p.bk_stdev),
           np.float32(p.ks_stdev) * np.float32(p.ks_stdev))
    host = [x.cpu().numpy() for x in (keys.lwe, keys.ring, keys.bk, keys.ks)]
    return keyset_from_numpy(host[0], host[1], host[2], var[0], host[3], var[1], device=device)


def encrypt_bits(gen: torch.Generator, bits: torch.Tensor, keys: ref.Keys, p: ref.Params):
    """Gate-encoded encryptions of ``bits`` (+-1/8) at the keyswitch noise:
    (a, b) int32."""
    mu = torch.where(bits, ref.MU, -ref.MU).to(torch.int32)
    return ref.encrypt(gen, mu, keys.lwe, p.ks_stdev)


def words(x: torch.Tensor) -> torch.Tensor:
    """int32 words as int64 in [0, 2^32), the reference's form."""
    return x.to(torch.int64) & ref.MASK32


def rows_off(a: torch.Tensor, b: torch.Tensor, ra: torch.Tensor, rb: torch.Tensor) -> int:
    """Samples whose mask or body words differ from the reference's."""
    return int(((words(a) != words(ra)).any(-1) | (words(b) != words(rb))).sum())


def peak_reset(device: torch.device) -> int:
    """The device memory's peak since the last reset (or the process's
    start), in bytes; the count starts anew."""
    if device.type != "cuda":
        return 0
    peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return peak


def device_sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trace:
    """A profiled sub-window: ``torch.profiler`` over CPU and CUDA between
    :meth:`start` and :meth:`stop`, each after a synchronize where the
    driver can give one, with the host's seconds between them.  The
    profiler's own set-up (seconds on the card, CUPTI's) runs in
    :meth:`prepare`, before the window, so that starting it stalls no
    caller inside the window."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.window_s = 0.0
        self.events = []
        self.done = False
        self._recording = False

    def prepare(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts,
                            schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        self.prof.__enter__()

    def start(self, sync: bool = True) -> None:
        if sync:
            device_sync(self.device)
        self.prof.step()
        self._recording = True
        self.t0 = time.perf_counter()

    def stop(self, sync: bool = True) -> None:
        if sync:
            device_sync(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.prof.step()
        self.prof.__exit__(None, None, None)
        self.events = list(self.prof.events())
        self._recording = False
        self.done = True

    @property
    def active(self) -> bool:
        return self._recording

    def device_ops(self) -> list[tuple[str, float, float]]:
        """(name, start s, end s) of every operation that ran on the device;
        the profiler's own ranges mirrored on the device's timeline (its
        step, user annotations) are no operations."""
        from torch.autograd import DeviceType

        return [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
                for e in self.events if e.device_type != DeviceType.CPU
                and not getattr(e, "is_user_annotation", False)
                and not e.name.startswith("ProfilerStep")]

    def host_spans(self) -> list[tuple[str, float, float]]:
        from torch.autograd import DeviceType

        return [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
                for e in self.events if e.device_type == DeviceType.CPU]


def busy_intervals(ops: list[tuple[str, float, float]]) -> list[tuple[float, float]]:
    """The union of the operations' intervals, merged and in order."""
    merged: list[list[float]] = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_s(ops) -> float:
    return sum(e - s for s, e in busy_intervals(ops))


def idle_share(trace: Trace) -> float | None:
    """The device's idle share of the traced sub-window, in %: one minus the
    union of the intervals in which any operation ran on the device over the
    sub-window's seconds on the host clock.  None where the trace holds no
    device operation; an error where the device was busy longer than the
    window, since the two clocks then disagree."""
    ops = trace.device_ops()
    if not ops or trace.window_s <= 0:
        return None
    busy = busy_s(ops)
    if busy > trace.window_s:
        raise ValueError(f"the device was busy {busy:.6f} s in a traced window of "
                         f"{trace.window_s:.6f} s")
    return 100.0 * (1.0 - busy / trace.window_s)


#: Kernels of the three rotation wrappers: K1 and K3 (``rotate_kernel``,
#: ``rotate_kernel_cluster``, ``rotate_kernel_stream``) and K2
#: (``blind_rotate_compact_kernel``, ``_general``, ``_global`` and its
#: digit pass ``compact_global_digits``).
ROTATION_KERNELS = ("rotate_kernel", "blind_rotate_compact", "compact_global_digits")


def is_rotation(name: str) -> bool:
    return any(k in name for k in ROTATION_KERNELS)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    between busy intervals, each named by the host operation that began last
    before the device resumed."""
    ops = trace.device_ops()
    by_name: dict[str, float] = {}
    for name, s, e in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    device_ops = [(n[:120], t) for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
    busy = busy_intervals(ops)
    spans = sorted(trace.host_spans(), key=lambda sp: sp[1])
    starts = [sp[1] for sp in spans]
    gaps = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        # the host operation that began last before the device resumed
        k = bisect.bisect_right(starts, s1) - 1
        gaps.append((f"host: {spans[k][0][:100] if k >= 0 else 'none traced'}", s1 - e0))
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, t] for n, t in device_ops],
            "idle_gaps": [[n, t] for n, t in gaps[:top]]}


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the window's numbers and the checks."""

    attempted: int
    failed: int
    e2e: dict[str, float]
    #: name -> (number, limit): each compared number is correct at or below its limit
    checks: dict[str, tuple[float, float]]
    #: program counters and driver counts the per-layer readers take
    counters: dict
    trace: Trace | None = None
    memory_peak_bytes: int = 0

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(v <= lim for v, lim in self.checks.values())
