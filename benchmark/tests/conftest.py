"""Fixtures of the benchmark's own tests: a copy of the benchmark's files
beside a BENCHMARK.json that adds a tiny configuration ("tiny", the
port's ``test_params`` shape) and tiny traffic under new names, so that a
whole cell runs on the CPU in seconds.  Tests that need the card carry the
``gpu`` marker and decide inside a fixture whether a card is present."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_PARAMS = {"n": 16, "N": 64, "k": 1, "bk_l": 2, "bk_Bgbit": 8, "ks_t": 8, "ks_basebit": 2,
               "ks_stdev": 1e-7, "bk_stdev": 1e-9, "max_stdev": 0.012467}

#: traffic name -> (the traffic it copies, what it changes)
TINY_TRAFFIC = {
    "tiny-nand": ("nand-b8192", {"batch": 16, "pool": 2, "rows_per_call": 8,
                                 "check_rows": 1000, "trace_calls": 2}),
    "tiny-api": ("api-uint8", {"pool": 16, "trace_cycles": 1}),
}

#: cell of the tiny configuration -> the cell whose metrics it reports
TINY_CELLS = {"tiny.tiny-nand": "tfhe128-ntt.nand-b8192",
              "tiny.tiny-api": "tfhe128-ntt.api-uint8"}


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


def make_tiny_root(dest: Path) -> Path:
    """A checkout-like directory: BENCHMARK.json and a copy of benchmark/,
    with the tiny configuration, traffic and cells added as files only."""
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/tfhe128-ntt.json").read_text())
    cfg.update(name="tiny", params=TINY_PARAMS,
               framework={"param_set": "test", "eval_key_form": "ntt"})
    (dest / "benchmark/configs/tiny.json").write_text(json.dumps(cfg))
    for name, (base, over) in TINY_TRAFFIC.items():
        t = json.loads((ROOT / f"benchmark/traffic/{base}.json").read_text())
        t.update(over)
        (dest / f"benchmark/traffic/{name}.json").write_text(json.dumps(t))
    bench["configs"].append({"name": "tiny", "source": "test_params", "reduced": [],
                             "file": "benchmark/configs/tiny.json", "why": "CPU tests"})
    for cell, like in TINY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": "tiny",
                                   "traffic": cell.split(".", 1)[1], "chips": 1, "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the check runs on the chip")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def run_tiny(tiny_root):
    """One run of a tiny cell on the CPU, the chip's look skipped."""
    import torch

    from benchmark.run import RunArgs, run_cell

    def run(cell: str, seed: int = 7, seconds: float = 0.5, trace: bool = False,
            control: bool = False, root: Path | None = None) -> dict:
        return run_cell(root or tiny_root, cell, RunArgs(
            seed=seed, seconds=seconds, trace=trace, device=torch.device("cpu"),
            control=control))
    return run
