"""Whole runs of tiny cells on the CPU, the chip's look skipped: a cell,
configuration, traffic mix and per-layer metric added as files only are
found by name; no run loads JAX or the JAX package; the control and each
fault that a cell can have come out not correct."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import ROOT, forbidden_modules

CELLS = ("tiny.tiny-nand", "tiny.tiny-api")


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_is_correct(run_tiny, cell):
    line = run_tiny(cell)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and line["failed"] == 0
    assert set(line["metrics"]) >= {"setup_s"} and len(line["metrics"]) == 2


def test_added_files_are_found_by_name(tiny_root, run_tiny, tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, each a
    file and an entry, reach a run with no other edit."""
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    cfg = json.loads((root / "benchmark/configs/tiny.json").read_text())
    cfg["name"] = "tiny2"
    (root / "benchmark/configs/tiny2.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "benchmark/traffic/tiny-nand.json").read_text())
    tr.update(gate="xor_", batch=8)
    (root / "benchmark/traffic/tiny-xor.json").write_text(json.dumps(tr))
    (root / "benchmark/metrics/calls_seen.batch.py").write_text(
        "def read(cell, outcome):\n    return float(outcome.counters['calls'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny2", "source": "t", "file": "benchmark/configs/tiny2.json",
                             "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "tiny2.tiny-xor", "config": "tiny2",
                               "traffic": "tiny-xor", "chips": 1, "why": "t"})
    bench["end_to_end"][0]["workloads"].append("tiny2.tiny-xor")
    bench["per_layer"].append({"name": "calls_seen.batch", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "t",
                               "moves": "bootstraps_per_s", "workloads": ["tiny2.tiny-xor"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = run_tiny("tiny2.tiny-xor", root=root)
    assert line["correct"] and "bootstraps_per_s" in line["metrics"]
    traced = run_tiny("tiny2.tiny-xor", root=root, trace=True)
    assert traced["correct"] and traced["metrics"]["calls_seen.batch"]["value"] >= 4


def test_no_run_loads_jax():
    """A whole run in a fresh process: nothing whose top-level name is jax,
    jaxlib, flax or eoc_tfhe_tpu is loaded (eoc_tfhe_tpu_torch is)."""
    code = ("import sys, tempfile, torch, pathlib\n"
            "from benchmark.tests.conftest import make_tiny_root\n"
            "from benchmark.run import RunArgs, run_cell\n"
            "root = make_tiny_root(pathlib.Path(tempfile.mkdtemp()))\n"
            "run_cell(root, 'tiny.tiny-nand', RunArgs(3, 0.2, False, torch.device('cpu')))\n"
            "from benchmark.harness import forbidden_modules\n"
            "print(forbidden_modules(), 'eoc_tfhe_tpu_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_are_whole():
    sys.modules.setdefault("eoc_tfhe_tpu_torch_probe", sys)
    try:
        assert "eoc_tfhe_tpu_torch_probe" not in forbidden_modules()
    finally:
        del sys.modules["eoc_tfhe_tpu_torch_probe"]


def test_reference_imports_nothing_of_the_system():
    """The reference's sources import neither the port, JAX nor the JAX
    package, and importing them loads none of these."""
    banned = ("eoc_tfhe_tpu", "eoc_tfhe_tpu_torch", "jax", "jaxlib", "flax")
    for path in (ROOT / "benchmark/reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            assert not [n for n in names if n.split(".")[0] in banned], (path, names)
    code = ("import sys, benchmark.reference.tfhe, benchmark.reference.gates, "
            "benchmark.reference.codec, benchmark.reference.roofline\n"
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {banned!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(run_tiny, cell):
    """The reference in the program's place, its products in float32."""
    line = run_tiny(cell, control=True)
    assert not line["correct"] and line["checks"]["words_off"]["value"] > 0


def _unchanged(acc0, bara, key, ctx, params):
    return acc0.clone()


def _half(acc0, bara, key, ctx, params):
    from eoc_tfhe_tpu_torch.ops.blind_rotate import blind_rotate_ntt_plain

    out = acc0.clone()
    h = (acc0.shape[0] + 1) // 2
    out[:h] = blind_rotate_ntt_plain(acc0[:h], bara[:, :h], key, ctx, params)
    return out


FAULTS = {"state_unchanged": ("eoc_tfhe_tpu_torch.core.bootstrap.blind_rotate_ntt", _unchanged),
          "half_the_batch": ("eoc_tfhe_tpu_torch.core.bootstrap.blind_rotate_ntt", _half)}


def _altered(bootstrap):
    def run(*args, **kw):
        out = bootstrap(*args, **kw)
        out.b = out.b.clone()
        out.b.view(-1)[0] += 1
        return out
    return run


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(run_tiny, monkeypatch, cell, fault):
    """The timed path broken underneath: a blind rotation that returns its
    state unchanged, one that leaves half of the batch out, and an answer
    altered where it is produced (one word of each gate's output)."""
    from eoc_tfhe_tpu_torch.core import gates

    if fault == "answer_altered":
        monkeypatch.setattr(gates, "bootstrap", _altered(gates.bootstrap))
    else:
        target, fn = FAULTS[fault]
        monkeypatch.setattr(target, fn)
    line = run_tiny(cell)
    assert not line["correct"], line["checks"]
