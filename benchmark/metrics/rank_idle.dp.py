"""rank_idle.dp: the largest of the ranks' idle shares of their traced
sub-windows, in %, each computed on its rank as ``harness.idle_share``
does.  None where a rank's trace holds no device operation."""


def read(cell, outcome):
    idle = [s["idle"] for s in outcome.counters.get("ranks", [])]
    if not idle or None in idle:
        return None
    return max(idle)
