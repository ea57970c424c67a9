"""Per-op timing and spans on the profiler's clock.

Port of ``eoc_tfhe_tpu/utils/profiling.py``: ``Profiler``, ``PROFILER`` and
``op_timer`` give per-op host wall time and call counts, with opt-in echo
lines like the reference wrapper's.  An op's time is what its caller waits
for: the API methods end in a host copy of their result, which waits for the
card.

:func:`span` names a stretch of the calling thread's work for a
``torch.profiler`` run: while a profiler records, it is a
``record_function`` range, one of the profiler's own events, so it shares
the clock of the device operations in the same trace; while none records, it
costs one check of the profiler's state.  ``op_timer`` opens the span
``tfhe.api.<op>`` beside its timer.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass

import torch

#: True while a profiler is recording on this process (its C check).
_profiler_enabled = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str, **attrs):
    """A context: a ``torch.profiler.record_function`` range named
    ``"<name> k=v k=v"`` (the profiler keeps no arguments of a range, so the
    attributes ride in its name) while a profiler records, else nothing."""
    if not _profiler_enabled():
        return _NO_SPAN
    if attrs:
        name = " ".join([name] + [f"{k}={v}" for k, v in attrs.items()])
    return torch.profiler.record_function(name)


@dataclass
class OpStats:
    calls: int = 0
    total_s: float = 0.0
    last_s: float = 0.0

    def as_dict(self) -> dict:
        return {"calls": self.calls, "total_s": self.total_s, "last_s": self.last_s}


class Profiler:
    """Process-wide op profiler.  Enabled by default (cheap)."""

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

    def reset(self) -> None:
        self.stats.clear()


PROFILER = Profiler()


@contextlib.contextmanager
def op_timer(name: str):
    """``PROFILER``'s timer of the op ``name`` inside the span
    ``tfhe.api.<name>``."""
    with span("tfhe.api." + name), PROFILER.op(name):
        yield
