"""api_idle_ms.call: milliseconds a traced call in which the device is idle
while the innermost open span is the API's own (``tfhe.api.<op>``,
``.decode``, ``.upload``, ``.export``; not ``.circuit``), by
``spans.idle_s``.  None where the trace holds no device operation or no
such span."""

from benchmark.spans import idle_s


def api_own(name: str) -> bool:
    return name.startswith("tfhe.api.") and name != "tfhe.api.circuit"


def read(cell, outcome):
    secs = idle_s(outcome.trace, api_own)
    return None if secs is None else secs * 1e3 / outcome.counters["calls_traced"]
