"""The plane sweep's least time on one NVIDIA H100, from the program's
counters of its work (models/mvs.py), whatever computes it.

Operations: 8 f32 operations a window tap of a hypothesis (weight times
the warped sample, and its square and its product with the reference,
each added, the validity's weight added) over `stereo_tap_hyp` =
sum of H*W*S*D*(2r+1)^2; 30 a hypothesis (homography, bilinear sample,
the NCC's closing terms, the top-k selection) over `stereo_hyp`; 40 more
a hypothesis of the geometric pass (the source depth's sample, the
back-projection and reprojection) over `stereo_hyp_geom`. Bytes
(`stereo_bytes`): the images and source depth maps read once, the depth,
cost and normal maps written once. The bound is the larger of operations
over the f32 peak and bytes over the memory bandwidth (benchmarks/roofline.py).
"""

from __future__ import annotations

from benchmarks import roofline

TAP_OPS, HYP_OPS, GEOM_OPS = 8, 30, 40


def operations(counts: dict) -> float:
    return (TAP_OPS * counts.get("stereo_tap_hyp", 0) + HYP_OPS * counts.get("stereo_hyp", 0)
            + GEOM_OPS * counts.get("stereo_hyp_geom", 0))


def least_s(counts: dict) -> float | None:
    """Seconds the counted sweeps need at the card's peaks, or None where
    nothing was counted."""
    if not counts.get("stereo_hyp"):
        return None
    ms, _by = roofline.bound(float(counts.get("stereo_bytes", 0)), float(operations(counts)), roofline.F32_FLOPS)
    return ms * 1e-3
