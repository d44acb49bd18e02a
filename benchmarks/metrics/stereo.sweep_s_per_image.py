"""stereo.sweep_s_per_image: the program's span `stereo.sweep` (each
view-pass's plane sweep through the fetch of its maps, host clock) over
the images densified in the window."""

from benchmarks.metrics import per_image


def read(record):
    return per_image(record, "stereo.sweep")
