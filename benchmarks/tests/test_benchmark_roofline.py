"""benchmarks/roofline.py against hand-counted launches of PERF.md §6's
kernel tables (bound column: ms to four places, and which bound)."""

import pytest

from benchmarks import roofline

# (queries, map points) -> (bound ms, by), PERF.md §6's K2 table
K2 = [
    ((4096, 504_000), (0.2465, "operations")),
    ((37, 504_000), (0.0022, "operations")),
    ((4096, 100_003), (0.0489, "operations")),
    ((7_180, 504_000), (0.4321, "operations")),
    ((9_455, 504_000), (0.5690, "operations")),
]
# (B, N1, N2, sum of n1 + n2, sum of n1 * n2) -> (bound ms, by), PERF.md
# §6's uint8-K1 table (valid counts written out: the pixel-world chunk at
# its mean of 485 valid rows and columns a pair)
K1U8 = [
    ((1, 8192, 8192, 16384.0, 8192.0 * 8192), (0.0087, "operations")),
    ((1, 1000, 1537, 2537.0, 1000.0 * 1537), (0.0002, "operations")),
    ((1, 1024, 2048, 3072.0, 1024.0 * 2048), (0.0003, "operations")),
    ((16, 1024, 1024, 16 * 970.0, 16 * 485.0 * 485), (0.0007, "bytes")),
]


@pytest.mark.parametrize("shape,expected", K2)
def test_k2_bound(shape, expected):
    ms, by = roofline.k2_bound(*shape)
    assert (round(ms, 4), by) == expected


@pytest.mark.parametrize("shape,expected", K1U8)
def test_k1u8_bound(shape, expected):
    ms, by = roofline.k1u8_bound(*shape)
    assert (round(ms, 4), by) == expected


def test_share_needs_device_time():
    assert roofline.share_pct(0.25, 0.0) is None
    assert roofline.share_pct(0.0, 1e-3) is None
    assert roofline.share_pct(0.2465, 0.5247e-3) == pytest.approx(47.0, abs=0.05)
