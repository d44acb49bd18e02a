"""device.idle_pct.dense: the share of the window (dense cells) in which no
operation ran on the card, from the profiler's device trace."""

from benchmarks.metrics import idle_pct


def read(record):
    return idle_pct(record)
