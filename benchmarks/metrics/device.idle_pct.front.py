"""device.idle_pct.front: the share of the window (front-end cells) in which
no operation ran on the card, from the profiler's device trace."""

from benchmarks.metrics import idle_pct


def read(record):
    return idle_pct(record)
