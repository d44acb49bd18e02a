"""lidar.proj_s_per_image: PHASES `lidar_assoc_proj` (the lidar depth
projection and association) over the window's registered images."""

from benchmarks.metrics import per_image


def read(record):
    return per_image(record, "lidar_assoc_proj")
