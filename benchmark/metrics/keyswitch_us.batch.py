"""keyswitch_us.batch: device microseconds a bootstrap of the operations
queued inside the program's ``tfhe.keyswitch`` spans (``spans.device_s``),
over the traced calls' bootstraps.  None where the trace holds no device
operation or no such span."""

from benchmark.spans import device_s


def read(cell, outcome):
    secs = device_s(outcome.trace, "tfhe.keyswitch")
    return None if secs is None else secs * 1e6 / outcome.counters["bootstraps_traced"]
