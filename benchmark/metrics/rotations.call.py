"""rotations.call: blind-rotation launches an API call made over the
window (the ``launches`` counters of ``ops.blind_rotate``,
``ops.blind_rotate_v1`` and ``ops.blind_rotate_compact``, summed, over the
calls).  None where no launch was counted (the CPU's plain versions)."""


def read(cell, outcome):
    c = outcome.counters
    return c["rotations"] / c["calls"] if c.get("rotations") else None
