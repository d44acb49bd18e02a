"""k1u8.roofline_pct: the least time of the window's uint8 K1 launches
(shapes and valid counts recorded by the harness's wrapper around
ops.matching.match_top2_u8, the bound by benchmarks/roofline.py) over the
device time the profiler gave its kernels."""

from benchmarks import roofline
from benchmarks.metrics import kernel_s

KERNELS = ("top2_u8_kernel", "top2_u8_reduce_kernel")


def read(record):
    trace, shapes = record.get("trace"), record.get("kernels")
    if not trace or not shapes or not shapes["k1u8"]:
        return None
    device_s = kernel_s(record, KERNELS)
    bound_ms = sum(roofline.k1u8_bound(B, N1, N2, vsum, vprod)[0] for B, N1, N2, vsum, vprod in shapes["k1u8"])
    return roofline.share_pct(bound_ms, device_s)
