"""A tiny dp cell on gloo CPU ranks, run whole in a process of its own, and
the faults its check must catch.

    python benchmark/tests/dp_cell.py ROOT CELL SEED FAULT

runs rank 0 of ``drivers/dp_batch`` on the CPU (``run.run_cell``) in this
process and prints the result line; its ranks run this file too (``child
FAULT <dp_batch arguments>``), so that each takes the fault as its rank
should.  FAULT is ``none`` or a key of :data:`FAULTS`.  Rank 0 exits
non-zero where a rank fails (``dp_batch``'s watch); this process is its own
so that that exit ends no test run.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _gather_twice():
    """The gather returns rank 0's slice in rank 1's place too, on every rank."""
    import torch

    from eoc_tfhe_tpu_torch.parallel import mesh

    real = mesh.all_gather

    def gather(x, group, dim=0, axis="world"):
        parts = list(real(x, group, dim, axis).split(x.shape[dim], dim))
        parts[1] = parts[0]
        return torch.cat(parts, dim)
    mesh.all_gather = gather


def _rank_differs():
    """Rank 1's gathered output altered by one word."""
    from eoc_tfhe_tpu_torch.parallel import sharded

    real = sharded._dp_outputs

    def outputs(out, m):
        a, b, v = real(out, m)
        b = b.clone()
        b.view(-1)[0] += 1
        return a, b, v
    sharded._dp_outputs = outputs


def _raises():
    """The sharded gate raises at its first call."""
    from eoc_tfhe_tpu_torch.parallel import sharded

    def make(*args, **kw):
        def gate(*a, **k):
            raise RuntimeError("a rank that raises")
        return gate
    sharded.make_sharded_gate = make


def _stalls():
    """The sharded gate stops at its first call, outside any collective."""
    import time

    from eoc_tfhe_tpu_torch.parallel import sharded

    def make(*args, **kw):
        def gate(*a, **k):
            print("rank stalls", flush=True)
            time.sleep(300)
        return gate
    sharded.make_sharded_gate = make


#: fault -> (what it does, the ranks it is applied on)
FAULTS = {"gather_twice": (_gather_twice, "all"), "rank_differs": (_rank_differs, (1,)),
          "rank_raises": (_raises, (1,)), "every_rank_raises": (_raises, "all"),
          "rank_stalls": (_stalls, (1,))}


def _apply(fault: str, rank: int) -> None:
    if fault != "none":
        fn, ranks = FAULTS[fault]
        if ranks == "all" or rank in ranks:
            fn()


def main(argv) -> int:
    if argv[0] == "child":
        from benchmark.drivers import dp_batch

        fault, rest = argv[1], argv[2:]
        _apply(fault, int(rest[rest.index("--rank") + 1]))
        dp_batch.child_main(rest)
    root, cell, seed, fault = argv
    import torch

    from benchmark.drivers import dp_batch
    from benchmark.run import RunArgs, run_cell

    torch.set_num_threads(1)
    _apply(fault, 0)
    dp_batch.child_command = lambda *a: [sys.executable, __file__, "child", fault] + \
        dp_batch.child_args(*a)
    line = run_cell(Path(root), cell, RunArgs(seed=int(seed), seconds=0.5, trace=True,
                                              device=torch.device("cpu")))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
