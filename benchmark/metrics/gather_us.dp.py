"""gather_us.dp: device microseconds a bootstrap of the operations queued
inside the program's ``tfhe.parallel.gather`` spans (the output's all_gather
over dp and its concatenation, the mesh's collective spans nested in it):
the transfer and each card's wait for the slowest.  The largest of the
ranks, each reducing its own trace (``drivers/dp_batch.inside_s``), over the
traced calls' bootstraps.  None where a rank's trace holds no device
operation or no such span."""


def read(cell, outcome):
    secs = [s["gather_s"] for s in outcome.counters.get("ranks", [])]
    if not secs or None in secs:
        return None
    return max(secs) * 1e6 / outcome.counters["bootstraps_traced"]
