"""The benchmark of eoc_tfhe_tpu_torch on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json: it finds the cell's configuration
(``configs/<name>.json``), its traffic (``traffic/<name>.json``, whose
``driver`` names the generator in ``drivers/``) and, with ``--trace 1``,
its per-layer metrics (``metrics/<name>.py``, each a ``read(cell,
outcome)`` that returns a number or None) by the names in BENCHMARK.json.
It makes keys and inputs on the card from ``--seed``, warms every shape
the window uses, measures for ``--seconds``, checks what the window
produced against the plain reference in ``reference/`` and prints one JSON
line last on standard output.  Each compared number and its limit are the
last lines of standard error and the ``checks`` key of that line.

One option is for measuring the check itself and never for a run of the
cell: ``--control`` puts the reference, computed in float32, in the
program's place (it must come out not correct).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Build and kernel caches a program may use, at fixed paths in the checkout.
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
              "CUDA_CACHE_PATH": "cuda"}


@dataclasses.dataclass
class RunArgs:
    seed: int
    seconds: float
    trace: bool
    device: object
    control: bool = False


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    return ap.parse_args(argv)


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def query_card():
    """nvidia-smi reading the card's name, power limit and clocks, started
    so that it runs beside torch's import; None where it cannot start."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm,clocks.sm,temperature.gpu",
             "--format=csv,noheader"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        print(f"card: nvidia-smi not started: {e}", file=sys.stderr)
        return None


def card_line(proc) -> str:
    try:
        return proc.communicate(timeout=30)[0].strip()
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return "nvidia-smi gave no answer in 30 s"


def run_cell(root: Path, name: str, args: RunArgs) -> dict:
    """Run one cell and return its result line as a dict."""
    import torch

    from benchmark import harness as H

    cell = H.Cell.find(root, name)
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")
    outcome = driver.run(cell, args)
    c = outcome.counters
    marks = ", ".join(f"{k} {v:.2f}" for k, v in c["setup_marks"].items())
    print(f"run: set-up {outcome.e2e.get('setup_s', 0.0):.3f} s (after process start: {marks}); "
          f"window "
          f"{c.get('window_s', 0.0):.3f} s; {c['checked']} outputs checked against the "
          f"reference in {c['check_s']:.3f} s; memory peak "
          f"{', '.join(f'{k} {v} B' for k, v in c['memory_peaks'].items())}",
          file=sys.stderr, flush=True)
    found = H.forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {', '.join(found)}")
    if args.trace:
        metrics = {}
        for m in cell.metrics("per_layer"):
            reader = load(root / "benchmark" / "metrics" / f"{m['name']}.py", f"metric_{m['name']}")
            value = reader.read(cell, outcome)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": outcome.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.metrics("end_to_end") if m["name"] in outcome.e2e}
    dev = args.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.workload["chips"],
              "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = H.busy_s(outcome.trace.device_ops())
        device["window_s"] = outcome.trace.window_s
        line["breakdown"] = H.breakdown(outcome.trace)
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    smi = query_card()
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    import torch

    from benchmark import harness as H

    cell = H.Cell.find(ROOT, args.workload)
    chips = cell.workload["chips"]
    card = card_line(smi) if smi is not None else "not read"
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    print(f"card: {card}", file=sys.stderr, flush=True)
    line = run_cell(ROOT, args.workload, RunArgs(
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=torch.device("cuda", 0), control=args.control))
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
