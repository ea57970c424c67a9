"""rotate_roofline.batch: the blind rotation's share of its roofline, in %.

Device time of the blind-rotation kernels in the traced calls (by kernel
name, ``harness.ROTATION_KERNELS``) against the bound of as many
rotations over the cell's batch (``reference/roofline.py``: the parameter
set's and the configuration's constants and B alone).  Nothing to read (no rotation kernel in the
trace): None.
"""

from benchmark.harness import is_rotation
from benchmark.reference.roofline import rotation_bound_ms


def read(cell, outcome):
    ops = outcome.trace.device_ops()
    secs = sum(e - s for n, s, e in ops if is_rotation(n))
    if secs <= 0:
        return None
    c = outcome.counters
    bound_ms, _ = rotation_bound_ms(cell.config, c["batch"])
    return 100.0 * bound_ms * 1e-3 * c["calls_traced"] / secs
