"""mapper.track_merge_s_per_image: PHASES `track_merge_complete` (the
mapper's host track bookkeeping) over the window's registered images."""

from benchmarks.metrics import per_image


def read(record):
    return per_image(record, "track_merge_complete")
