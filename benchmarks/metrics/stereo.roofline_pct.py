"""stereo.roofline_pct: the plane sweeps' least time on the card
(benchmarks/stereo_roofline.py, from the program's counters of the work)
over the seconds in which the card ran an operation inside the program's
`stereo.sweep` spans (the device trace against the spans' intervals, which
the dense job kind records: its judge's `sweep_busy_s`), in a traced run
on the card (a run without device time reads nothing)."""

from benchmarks import roofline, stereo_roofline


def read(record):
    trace = record.get("trace")
    busy_s = record["check"]["numbers"].get("sweep_busy_s")
    least = stereo_roofline.least_s(record["phases"]["counts"])
    if not trace or trace["busy_s"] <= 0 or not busy_s or busy_s <= 0 or least is None:
        return None
    return roofline.share_pct(least * 1e3, busy_s)
