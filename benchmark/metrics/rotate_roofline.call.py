"""rotate_roofline.call: the blind rotation's share of its roofline at the
API's batches, in %.

The bound (``reference/roofline.py``) summed over the traced
``tfhe.bootstrap.rotate`` spans, each at the batch ``B`` its name carries,
over the device time of the operations queued inside those spans
(``spans.device_s``).  None where no operation was queued inside one (the
CPU's plain versions queue none) or the trace holds no such span.
"""

from benchmark.spans import device_s, rotation_bound_s


def read(cell, outcome):
    secs = device_s(outcome.trace, "tfhe.bootstrap.rotate")
    if not secs:
        return None
    return 100.0 * rotation_bound_s(cell.config, outcome.trace) / secs
