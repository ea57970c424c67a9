"""gate_other_us.batch: device microseconds a bootstrap outside the
blind-rotation kernels (the keyswitch product, the mod switch, the
extraction, the linear combination, copies), summed over the operations of
the traced calls.  None where the trace holds no device operation."""

from benchmark.harness import is_rotation


def read(cell, outcome):
    ops = outcome.trace.device_ops()
    if not ops:
        return None
    secs = sum(e - s for n, s, e in ops if not is_rotation(n))
    return secs * 1e6 / outcome.counters["bootstraps_traced"]
