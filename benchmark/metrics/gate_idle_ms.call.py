"""gate_idle_ms.call: milliseconds a traced call in which the device is
idle while the innermost open span is the circuit's or the gate's
(``tfhe.api.circuit``, ``tfhe.bootstrap.*``, ``tfhe.keyswitch``), by
``spans.idle_s``.  None where the trace holds no device operation or no
such span."""

from benchmark.spans import idle_s


def gate_own(name: str) -> bool:
    return (name == "tfhe.api.circuit" or name.startswith("tfhe.bootstrap.")
            or name == "tfhe.keyswitch")


def read(cell, outcome):
    secs = idle_s(outcome.trace, gate_own)
    return None if secs is None else secs * 1e3 / outcome.counters["calls_traced"]
