"""guided.roofline_pct: the least time of the window's guided K1 launches
(benchmarks/guided_roofline.py, from the program's counters of the guided
re-match; two launches a pair where the configuration cross-checks) over
the device time the profiler gave the guided kernels, by name."""

from benchmarks import guided_roofline, harness, roofline
from benchmarks.metrics import kernel_s

KERNELS = ("guided_top2_kernel", "guided_merge_kernel")


def read(record):
    trace = record.get("trace")
    if not trace:
        return None
    device_s = kernel_s(record, KERNELS)
    launches = 2 if harness.load_cell(record["cell"]).config["matching"].get("cross_check", True) else 1
    least = guided_roofline.least_s(record["phases"]["counts"], launches)
    if least is None or device_s <= 0:
        return None
    return roofline.share_pct(least * 1e3, device_s)
