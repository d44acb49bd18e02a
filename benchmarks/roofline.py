"""The hand kernels' least times on one NVIDIA H100: operations and bytes
per launch from its shapes, over the published peaks.

A bound is the larger of bytes over the memory bandwidth and operations
over the peak rate of the unit the kernel uses, counting what the function
needs: each input read once, each output written once, only the valid rows
and columns. A roofline share is the sum of the bounds of a window's
launches over the device time the profiler gave the kernel's launches.
"""

from __future__ import annotations

# published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet,
# dense): device memory bytes/s, f32 FLOP/s outside the tensor cores, int8
# tensor-core OP/s. A card set below 700 W reaches less (the run prints its
# power limit beside the shares).
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
INT8_OPS = 1979e12


def bound(bytes_moved: float, operations: float, peak: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take."""
    by_bytes, by_ops = bytes_moved / HBM_BYTES_S * 1e3, operations / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def k2_bound(queries: int, points: int) -> tuple[float, str]:
    """K2 (`nn_argmin`): Q queries [Q,3] f32 against N map points [N,3] f32,
    an index and a distance written per query; 8 flops a (query, point)."""
    Q, N = float(queries), float(points)
    return bound(12 * Q + 12 * N + 8 * Q, 8.0 * Q * N, F32_FLOPS)


def k1u8_bound(batch: int, cap1: int, cap2: int, valid_sum: float, valid_products: float) -> tuple[float, str]:
    """K1 uint8 (`match_top2_u8`): a batch of B pairs padded to caps N1 and
    N2, whose valid rows and columns number n1 and n2 per pair;
    `valid_sum` is the sum over the batch of n1 + n2, `valid_products` of
    n1 * n2. The valid descriptors (128 bytes) and their inverse norms (4)
    are read once, both masks (4 bytes a slot) once, three 4-byte outputs
    written per row; 2 operations per byte product of a valid pair."""
    B, N1, N2 = float(batch), float(cap1), float(cap2)
    return bound(valid_sum * (128 + 4) + 4.0 * B * (N1 + N2) + 12 * B * N1,
                 2.0 * 128 * valid_products, INT8_OPS)


def share_pct(bound_ms_total: float, device_s: float) -> float | None:
    """Percent of the roofline reached, or None where no device time was read."""
    if device_s <= 0 or bound_ms_total <= 0:
        return None
    return 100.0 * bound_ms_total * 1e-3 / device_s
