"""stereo.host_s_per_image: the dense stereo's host work, the program's
spans `stereo.problem` (a view's sources, depth range and uploads) and
`stereo.write` (its maps to disk), over the images densified in the
window."""

SPANS = ("stereo.problem", "stereo.write")


def read(record):
    totals = record["phases"]["totals"]
    n = record["registered"]
    if not n or not any(s in totals for s in SPANS):
        return None
    return sum(totals.get(s, 0.0) for s in SPANS) / n
