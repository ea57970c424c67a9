"""Per-op timing and structured counters.

Port of ``eoc_tfhe_tpu/utils/profiling.py`` (``Profiler``, ``PROFILER`` and
``op_timer``): per-op host wall time and call counts, opt-in echo lines like
the reference wrapper's.  An op's time is what its caller waits for: the API
methods end in a host copy of their result, which waits for the card.
The reference's ``trace`` (a ``jax.profiler`` region) is not ported.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from dataclasses import dataclass


@dataclass
class OpStats:
    calls: int = 0
    total_s: float = 0.0
    last_s: float = 0.0

    def as_dict(self) -> dict:
        return {"calls": self.calls, "total_s": self.total_s, "last_s": self.last_s}


class Profiler:
    """Process-wide op profiler.  Enabled by default (cheap); JSON-dumpable."""

    def __init__(self) -> None:
        self.stats: dict[str, OpStats] = defaultdict(OpStats)
        self.enabled = True
        self.echo = False  # print per-op lines like the reference wrapper

    @contextlib.contextmanager
    def op(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            s = self.stats[name]
            s.calls += 1
            s.total_s += dt
            s.last_s = dt
            if self.echo:
                print(f"{name} completed in {dt * 1e3:.1f} ms")

    def summary(self) -> dict:
        return {k: v.as_dict() for k, v in sorted(self.stats.items())}

    def dump_json(self) -> str:
        return json.dumps(self.summary())

    def reset(self) -> None:
        self.stats.clear()


PROFILER = Profiler()


def op_timer(name: str):
    return PROFILER.op(name)
