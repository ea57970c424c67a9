"""The dp cell's driver (``drivers/dp_batch``) on gloo CPU ranks: a tiny dp
cell, added as files only, runs on 2 ranks and is correct; a gather that
returns one rank's slice twice and a rank whose output differs come out not
correct; a rank that raises ends the run non-zero within 60 s, no rank left;
a rank ends when rank 0 dies.
Each run is a process of its own (``dp_cell.py``)."""

from __future__ import annotations

import json
import os
import select
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

from benchmark.drivers.dp_batch import inside_s
from benchmark.harness import ROOT, Trace
from benchmark.run import load
from benchmark.tests.conftest import TINY_PARAMS, make_tiny_root

CELL = "tinydp.tiny-dp"
DP_CELL = "tfhe128-ntt-dp4.dp-nand-b8192"
SCRIPT = Path(__file__).resolve().parent / "dp_cell.py"


@pytest.fixture(scope="module")
def dp_root(tmp_path_factory) -> Path:
    """The tiny checkout with a dp configuration (``test_params``, 2 ranks on
    dp) and traffic added, its cell listed where the dp cell is."""
    root = make_tiny_root(tmp_path_factory.mktemp("dp_checkout"))
    cfg = json.loads((root / "benchmark/configs/tfhe128-ntt-dp4.json").read_text())
    cfg.update(name="tinydp", params=TINY_PARAMS,
               framework={"param_set": "test", "eval_key_form": "ntt", "mesh_dp": 2,
                          "mesh_tp": 1})
    (root / "benchmark/configs/tinydp.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "benchmark/traffic/dp-nand-b8192.json").read_text())
    tr.update(batch=8, pool=2, rows_per_call=8, check_rows=1000, trace_calls=2)
    (root / "benchmark/traffic/tiny-dp.json").write_text(json.dumps(tr))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinydp", "source": "test_params", "reduced": [],
                             "file": "benchmark/configs/tinydp.json", "why": "CPU tests"})
    bench["workloads"].append({"name": CELL, "config": "tinydp", "traffic": "tiny-dp",
                               "chips": 2, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if DP_CELL in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root: Path, fault: str, timeout: float = 240):
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, str(SCRIPT), str(root), CELL, "3000000123", fault],
                         cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    return out, time.monotonic() - t0


def _line(out) -> dict:
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_tiny_dp_cell_is_correct(dp_root):
    line = _line(_run(dp_root, "none")[0])
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"words_off", "bits_off", "ranks_off"}
    assert line["device"]["count"] == 2 and line["failed"] == 0


@pytest.mark.parametrize("fault,number", [("gather_twice", "words_off"),
                                          ("rank_differs", "ranks_off")])
def test_dp_fault_is_not_correct(dp_root, fault, number):
    line = _line(_run(dp_root, fault)[0])
    assert not line["correct"] and line["checks"][number]["value"] > 0, line["checks"]


def _ranks_of(root: Path) -> list[int]:
    """Pids of processes whose command line names ``root`` (the ranks)."""
    pids = []
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                if str(root).encode() in (d / "cmdline").read_bytes():
                    pids.append(int(d.name))
            except OSError:
                pass
    return pids


@pytest.mark.parametrize("fault", ["rank_raises", "every_rank_raises"])
def test_a_rank_that_raises_ends_the_run(dp_root, fault):
    """Rank 1 raises at its first call, or every rank does (a program whose
    sharded gate cannot take the eval key): the run exits non-zero within
    60 s and leaves no rank running."""
    out, secs = _run(dp_root, fault, timeout=120)
    assert out.returncode != 0 and secs < 60, (out.returncode, secs, out.stderr[-2000:])
    time.sleep(1.0)
    assert _ranks_of(dp_root) == []


def test_ranks_exit_when_rank0_dies(dp_root):
    """Rank 0 killed while rank 1 stalls outside any collective: rank 1 ends
    with it."""
    rank0 = subprocess.Popen([sys.executable, str(SCRIPT), str(dp_root), CELL, "3000000125",
                              "rank_stalls"], cwd=ROOT, stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE, text=True,
                             env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if select.select([rank0.stderr], [], [], 1.0)[0] and \
                    "rank stalls" in rank0.stderr.readline():
                break
        else:
            pytest.fail("rank 1 never reached its first call")
    finally:
        rank0.kill()
        rank0.wait()
        rank0.stderr.close()
    deadline = time.monotonic() + 10
    while _ranks_of(dp_root) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _ranks_of(dp_root) == []


def _ev(name, a, b, dev=DeviceType.CPU, id=0, thread=1):
    return NS(name=name, device_type=dev, id=id, thread=thread, is_user_annotation=False,
              time_range=NS(start=a * 1e6, end=b * 1e6))


def test_inside_s_counts_the_nested_collective():
    """Device time queued inside the gather span, the mesh span nested in it
    included; an operation queued outside it, or on another thread, not."""
    t = Trace.__new__(Trace)
    t.events = [
        _ev("tfhe.parallel.gather dp=4 bytes=9", 1, 5),
        _ev("tfhe.mesh.all_gather axis=dp bytes=8", 1.5, 3),
        _ev("cudaLaunchKernel", 2, 2.1, id=1), _ev("cudaLaunchKernel", 4, 4.1, id=2),
        _ev("cudaLaunchKernel", 6, 6.1, id=3), _ev("cudaLaunchKernel", 2, 2.1, id=4, thread=2),
        _ev("ncclKernel", 2.2, 3.2, dev=DeviceType.CUDA, id=1),
        _ev("cat", 4.2, 4.4, dev=DeviceType.CUDA, id=2),
        _ev("gemm", 6.2, 7.2, dev=DeviceType.CUDA, id=3),
        _ev("copy", 2.2, 2.3, dev=DeviceType.CUDA, id=4)]
    assert inside_s(t, "tfhe.parallel.gather") == pytest.approx(1.2)
    assert inside_s(t, "tfhe.keyswitch") is None


@pytest.mark.parametrize("name,shares,want", [
    ("gather_us.dp", [{"gather_s": 0.001}, {"gather_s": 0.003}], 0.003 * 1e6 / 96),
    ("gather_us.dp", [{"gather_s": 0.001}, {"gather_s": None}], None),
    ("rank_idle.dp", [{"idle": 1.5}, {"idle": 2.5}], 2.5),
    ("rank_idle.dp", [{"idle": None}, {"idle": 2.5}], None)])
def test_dp_readers_take_the_largest_rank(name, shares, want):
    reader = load(ROOT / "benchmark" / "metrics" / f"{name}.py", f"metric_{name}")
    got = reader.read(None, NS(counters={"ranks": shares, "bootstraps_traced": 96}))
    assert got == (None if want is None else pytest.approx(want))
