"""device_idle.batch: the device's idle share of the traced sub-window, in %
(``harness.idle_share``)."""

from benchmark.harness import idle_share


def read(cell, outcome):
    return idle_share(outcome.trace)
