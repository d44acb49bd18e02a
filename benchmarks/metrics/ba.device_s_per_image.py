"""ba.device_s_per_image: PHASES `ba_device` (the BA solves' device section,
host clock, fetch included) over the window's registered images."""

from benchmarks.metrics import per_image


def read(record):
    return per_image(record, "ba_device")
