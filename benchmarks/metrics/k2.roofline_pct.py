"""k2.roofline_pct: the least time of the window's K2 launches (their shapes
recorded by the harness's wrapper around nn_kernel.nn_argmin, the bound by
benchmarks/roofline.py) over the device time the profiler gave K2's kernels."""

from benchmarks import roofline
from benchmarks.metrics import kernel_s

KERNELS = ("nn_scan_queries_kernel", "nn_scan_points_kernel", "nn_reduce_kernel")


def read(record):
    trace, shapes = record.get("trace"), record.get("kernels")
    if not trace or not shapes or not shapes["k2"]:
        return None
    device_s = kernel_s(record, KERNELS)
    return roofline.share_pct(sum(roofline.k2_bound(q, n)[0] for q, n in shapes["k2"]), device_s)
