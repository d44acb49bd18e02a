"""The guided K1's least time on one NVIDIA H100, from the program's
counters of its work (the matcher's guided stage, models/feature_pipeline.py),
whatever computes it.

Per launch, over the pairs it re-matches: 2 x 128 int8 operations a valid
(row, column) on the tensor cores and SAMPSON_OPS f32 operations a valid
(row, column) for the Sampson test (three products and two sums of the
line against the point, the square, the sum of the two thresholds, the
comparison) on the FMA pipes, the two units' times added (`guided_sims`
counts the valid rows times the valid columns of each pair); bytes: each
valid point's descriptor (128), inverse norm (4) and point record (16)
read once (`guided_points` counts the valid points of both images). A
cross-checked pair takes two launches, its rows and its transpose. The
bound is the larger of the bytes' time at the memory bandwidth and the
operations' time (benchmarks/roofline.py's peaks).
"""

from __future__ import annotations

from benchmarks import roofline

SIM_OPS = 2 * 128
SAMPSON_OPS = 8
POINT_BYTES = 128 + 4 + 16


def least_s(counts: dict, launches_per_pair: int) -> float | None:
    """Seconds the counted guided launches need at the card's peaks, or
    None where nothing was counted."""
    sims = float(counts.get("guided_sims", 0))
    if not sims:
        return None
    ops_s = launches_per_pair * sims * (SIM_OPS / roofline.INT8_OPS + SAMPSON_OPS / roofline.F32_FLOPS)
    bytes_s = launches_per_pair * float(counts.get("guided_points", 0)) * POINT_BYTES / roofline.HBM_BYTES_S
    return max(ops_s, bytes_s)
