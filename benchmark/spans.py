"""The program's spans in a traced sub-window, and what the device did and
did not do inside them.

The system under test opens ``torch.profiler`` ranges named ``tfhe.<...>``
(``eoc_tfhe_tpu_torch.utils.profiling.span``), with attributes in the name
as ``"<name> k=v k=v"``.  They are the profiler's own host events, on the
clock of the device's operations in the same trace.  Here:

* each device operation is linked to the host runtime call that queued it
  (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...; the two share the
  profiler's correlation id), and that call to the innermost span open on
  its thread at the call's start;
* each idle instant of the sub-window (the complement of
  ``harness.busy_intervals``, inside the profiler's active step) is put
  down to the innermost span open on the host at that instant.

Nothing here imports the system.  A trace without the program's spans (a
program that opens none) reads as every operation and every idle instant
outside any span, and the sums over a span it lacks as None.
"""

from __future__ import annotations

import bisect
import dataclasses

from torch.autograd import DeviceType

from .harness import busy_intervals
from .reference.roofline import rotation_bound_ms

#: Prefix of the program's span names.
PREFIX = "tfhe."

#: Names of host runtime calls that queue device work begin so (the CUDA
#: runtime's ``cuda*`` and the driver's ``cu*``).
RUNTIME_PREFIX = "cu"


@dataclasses.dataclass(frozen=True)
class Span:
    label: str          # the range's name, attributes included
    thread: int
    start: float        # seconds on the trace's clock
    end: float

    @property
    def name(self) -> str:
        return self.label.split(" ", 1)[0]

    @property
    def attrs(self) -> dict[str, str]:
        return dict(kv.split("=", 1) for kv in self.label.split(" ")[1:])


def _is_host(e) -> bool:
    return e.device_type == DeviceType.CPU


def _is_device_op(e) -> bool:
    """The rule of ``harness.Trace.device_ops``."""
    return (not _is_host(e) and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("ProfilerStep"))


def _interval(e) -> tuple[float, float]:
    return e.time_range.start * 1e-6, e.time_range.end * 1e-6


def program_spans(trace) -> list[Span]:
    """Every ``tfhe.`` range of the trace, in order of start."""
    out = [Span(e.name, e.thread, *_interval(e)) for e in trace.events
           if _is_host(e) and e.name.startswith(PREFIX)]
    return sorted(out, key=lambda s: (s.start, -s.end))


class Timeline:
    """The innermost span open at each instant: the open span that began
    last (of two that began at once, the one that ends first)."""

    def __init__(self, spans: list[Span]):
        bounds = sorted({t for s in spans for t in (s.start, s.end)})
        self.starts, self.spans = [], []
        for a, b in zip(bounds, bounds[1:]):
            open_ = [s for s in spans if s.start <= a and s.end >= b]
            self.starts.append(a)
            self.spans.append(max(open_, key=lambda s: (s.start, -s.end)) if open_ else None)
        self.ends = bounds[1:]

    def at(self, t: float) -> Span | None:
        i = bisect.bisect_right(self.starts, t) - 1
        return self.spans[i] if i >= 0 and t < self.ends[i] else None

    def segments(self):
        """(start, end, innermost span or None) over the spans' extent."""
        return zip(self.starts, self.ends, self.spans)


def linked_ops(trace) -> list[tuple[str, float, float, Span | None]]:
    """(name, start s, end s, span) of every device operation: the
    innermost span open on the queuing call's thread at the call's start,
    None where the call is outside every span or was not traced."""
    by_thread: dict[int, list[Span]] = {}
    for s in program_spans(trace):
        by_thread.setdefault(s.thread, []).append(s)
    lines = {th: Timeline(ss) for th, ss in by_thread.items()}
    calls = {}
    for e in trace.events:
        if _is_host(e) and e.name.startswith(RUNTIME_PREFIX):
            calls.setdefault(e.id, e)
    out = []
    for e in trace.events:
        if not _is_device_op(e):
            continue
        call, span = calls.get(e.id), None
        if call is not None and call.thread in lines:
            span = lines[call.thread].at(call.time_range.start * 1e-6)
        out.append((e.name, *_interval(e), span))
    return out


def device_s(trace, name: str) -> float | None:
    """Device seconds of the operations queued with ``name`` the innermost
    span (by its name, attributes left out).  None where the trace holds no
    device operation or no such span (a program without it)."""
    ops = linked_ops(trace)
    if not ops or not any(s.name == name for s in program_spans(trace)):
        return None
    return sum(b - a for _, a, b, s in ops if s is not None and s.name == name)


def window(trace) -> tuple[float, float] | None:
    """The profiler's active step on the trace's clock (its host range)."""
    steps = [_interval(e) for e in trace.events
             if _is_host(e) and e.name.startswith("ProfilerStep")]
    return (min(a for a, _ in steps), max(b for _, b in steps)) if steps else None


def idle_by_span(trace) -> dict[str | None, float] | None:
    """Idle seconds of the device in the active step by the name of the
    innermost span open on the host (None: no span open).  None where the
    trace holds no device operation."""
    ops = [(e.name, *_interval(e)) for e in trace.events if _is_device_op(e)]
    w = window(trace)
    if not ops or w is None:
        return None
    idle, t = [], w[0]
    for a, b in busy_intervals(ops):
        if a > t:
            idle.append((t, min(a, w[1])))
        t = max(t, b)
    if t < w[1]:
        idle.append((t, w[1]))
    idle = [(a, b) for a, b in idle if b > a]
    out: dict[str | None, float] = {None: sum(b - a for a, b in idle)}
    segs = list(Timeline(program_spans(trace)).segments())
    j = 0
    for a, b in idle:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s0, s1, span = segs[k]
            cut = min(b, s1) - max(a, s0)
            if span is not None and cut > 0:
                out[span.name] = out.get(span.name, 0.0) + cut
                out[None] -= cut
            k += 1
    return out


def idle_s(trace, select) -> float | None:
    """Idle seconds whose innermost span's name ``select`` takes.  None
    where the trace holds no device operation or no such span."""
    by = idle_by_span(trace)
    if by is None or not any(select(s.name) for s in program_spans(trace)):
        return None
    return sum(v for k, v in by.items() if k is not None and select(k))


def rotation_bound_s(config: dict, trace) -> float:
    """The roofline bound (``reference/roofline.py``) summed over the
    traced ``tfhe.bootstrap.rotate`` spans, each at its own batch ``B``."""
    return sum(rotation_bound_ms(config, int(s.attrs["B"]))[0] * 1e-3
               for s in program_spans(trace) if s.name == "tfhe.bootstrap.rotate")
