"""Descriptor matching: dot-product similarity + ratio / cross checks.

Port of colmap_pcd_tpu/ops/matching.py. Descriptors are L2-normalized,
similarity = dot product, distance = arccos(similarity) (the reference's
sift.cc:142-165 convention), ratio test on arccos distances, optional cross
check and a guided (epipolar-masked) variant (feature/matching.h:277-310).

Every function broadcasts over a leading batch of image pairs. On CUDA
tensors `match_descriptors` (L2-normalized f32 descriptors) and
`match_descriptors_u8` (the database's uint8 descriptors with their inverse
norms, the matcher's path) run through the hand-written top-2 kernels K1
(ops/match_kernel.py), so the similarity matrix never exists in memory:
the float kernel forms the cross-check's column bests in the same launch as
the rows; the uint8 kernel runs once for the rows and once on the
transpose. On CPU tensors they take the plain matmul + `_best2`.
`match_guided_u8`, the matcher's guided re-match, is the uint8 route with
the epipolar mask in the kernel's epilogue (`match_top2_u8_guided`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .match_kernel import (
    _best2,
    _best_rows,
    match_top2,
    match_top2_cross,
    match_top2_u8,
    match_top2_u8_guided,
    point_records,
    similarity_u8,
)

Tensor = torch.Tensor


class MatchingOptions(NamedTuple):
    max_ratio: float = 0.8  # SiftMatchingOptions.max_ratio
    max_distance: float = 0.7  # SiftMatchingOptions.max_distance (arccos units)
    cross_check: bool = True
    guided_max_error: float = 4.0  # px, for guided matching


def normalize_descriptors(d: Tensor) -> Tensor:
    """L2-normalize rows (uint8 COLMAP descriptors or raw floats)."""
    d = d.to(torch.float32)
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-8)


def _accept(s1: Tensor, s2: Tensor, idx: Tensor, back: Tensor | None, valid1: Tensor,
            opts: MatchingOptions) -> Tensor:
    """Distance, ratio and (given `back`, the best row of every column)
    cross-check tests of a top-2 result."""
    dist1 = torch.arccos(torch.clamp(s1, -1.0, 1.0))
    dist2 = torch.arccos(torch.clamp(s2, -1.0, 1.0))
    ok = (valid1 > 0) & (dist1 < opts.max_distance) & (dist1 < opts.max_ratio * dist2)
    if back is not None:
        rows = torch.arange(idx.shape[-1], device=idx.device)
        ok = ok & (torch.gather(back.long(), -1, idx) == rows)
    return ok


def match_descriptors(
    d1: Tensor,  # [..., N1, D] L2-normalized
    d2: Tensor,  # [..., N2, D]
    valid1: Tensor,  # [..., N1]
    valid2: Tensor,  # [..., N2]
    opts: MatchingOptions = MatchingOptions(),
) -> tuple[Tensor, Tensor, Tensor]:
    """(match_idx [..., N1] int64 into d2, ok [..., N1] bool, sim [..., N1]
    best cosine similarity, the match quality PROSAC sampling consumes).

    CUDA tensors launch K1 once: with cross_check the fused launch that also
    gives the best row of every column (`match_top2_cross`), without it the
    rows alone; CPU tensors compute the similarity matrix and reduce it."""
    if d1.device.type == "cuda":
        if opts.cross_check:
            s1, s2, idx, back = match_top2_cross(d1, d2, valid1, valid2)
        else:
            (s1, s2, idx), back = match_top2(d1, d2, valid2), None
        idx = idx.long()
        return idx, _accept(s1, s2, idx, back, valid1, opts), s1
    return match_descriptors_reference(d1, d2, valid1, valid2, opts)


def match_descriptors_u8(
    d1: Tensor,  # [..., N1, D] uint8
    d2: Tensor,  # [..., N2, D] uint8
    inv1: Tensor,  # [..., N1] f32 inverse norms (match_kernel.inverse_norms)
    inv2: Tensor,  # [..., N2]
    valid1: Tensor,  # [..., N1]
    valid2: Tensor,  # [..., N2]
    opts: MatchingOptions = MatchingOptions(),
) -> tuple[Tensor, Tensor, Tensor]:
    """match_descriptors on the uint8 descriptors as the database holds
    them: the similarity is float(dot) * (inv_row * inv_col), exact in the
    dot product. CUDA tensors launch the tensor-core kernel
    (`match_top2_u8`) for the rows and, with cross_check, on the transpose;
    rows and columns that are not valid cost nothing there."""
    if d1.device.type == "cuda":
        s1, s2, idx = match_top2_u8(d1, d2, inv1, inv2, valid2, valid1)
        idx = idx.long()
        back = match_top2_u8(d2, d1, inv2, inv1, valid1, valid2)[2] if opts.cross_check else None
        return idx, _accept(s1, s2, idx, back, valid1, opts), s1
    return match_descriptors_u8_reference(d1, d2, inv1, inv2, valid1, valid2, opts)


def match_descriptors_u8_reference(d1, d2, inv1, inv2, valid1, valid2,
                                   opts: MatchingOptions = MatchingOptions()):
    """Plain version of match_descriptors_u8 on any device; rows that are
    not valid report (0, False, -2), as the kernel leaves them."""
    idx, ok, s1 = _match_similarity(similarity_u8(d1, d2, inv1, inv2), valid1, valid2, opts)
    rows = valid1 > 0
    return torch.where(rows, idx, torch.zeros_like(idx)), ok, torch.where(rows, s1, torch.full_like(s1, -2.0))


def match_descriptors_reference(d1, d2, valid1, valid2, opts: MatchingOptions = MatchingOptions()):
    """Plain version of match_descriptors on any device: the similarity
    matrix [..., N1, N2] in memory, reduced by `_best2` and an argmax over
    the rows for the cross-check."""
    return _match_similarity(d1 @ d2.mT, valid1, valid2, opts)


def _match_similarity(sim: Tensor, valid1, valid2, opts: MatchingOptions):
    """(idx, ok, s1) of a similarity matrix [..., N1, N2] in memory."""
    s1, s2, idx = _best2(sim, valid2)
    back = _best_rows(sim, valid1) if opts.cross_check else None
    return idx, _accept(s1, s2, idx, back, valid1, opts), s1


def match_guided(
    d1: Tensor,
    d2: Tensor,
    uv1: Tensor,  # [N1, 2] pixel coords
    uv2: Tensor,  # [N2, 2]
    valid1: Tensor,
    valid2: Tensor,
    F: Tensor,  # 3x3 fundamental matrix (pixel frame)
    opts: MatchingOptions = MatchingOptions(),
) -> tuple[Tensor, Tensor]:
    """Guided matching: candidates restricted to epipolar-consistent pairs
    (pairwise Sampson error below guided_max_error), then the same ratio and
    cross-check logic (feature/matching.h guided matcher semantics)."""
    sim = d1 @ d2.mT
    x1 = torch.cat([uv1, torch.ones_like(uv1[..., :1])], dim=-1)
    x2 = torch.cat([uv2, torch.ones_like(uv2[..., :1])], dim=-1)
    Fx1 = x1 @ F.mT  # [N1, 3]
    Ftx2 = x2 @ F  # [N2, 3]
    num = (Fx1 @ x2.mT) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2)[..., :, None] + (
        Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    )[..., None, :]
    err = num / torch.clamp(den, min=1e-12)
    sim = torch.where(err < opts.guided_max_error**2, sim, torch.full_like(sim, -2.0))
    s1, s2, idx = _best2(sim, valid2)
    back = _best_rows(sim, valid1) if opts.cross_check else None
    return idx, _accept(s1, s2, idx, back, valid1, opts) & (s1 > -1.5)


def match_guided_u8(
    d1: Tensor,  # [..., N1, D] uint8
    d2: Tensor,  # [..., N2, D] uint8
    inv1: Tensor,  # [..., N1] f32 inverse norms
    inv2: Tensor,  # [..., N2]
    valid1: Tensor,  # [..., N1]
    valid2: Tensor,  # [..., N2]
    uv1: Tensor,  # [..., N1, 2] pixel coords
    uv2: Tensor,  # [..., N2, 2]
    F: Tensor,  # [..., 3, 3] fundamental matrix (pixel frame)
    opts: MatchingOptions = MatchingOptions(),
) -> tuple[Tensor, Tensor]:
    """match_guided on the uint8 descriptors, batched over pairs: the
    similarities of pairs whose Sampson error is not below
    guided_max_error count as -2 (`point_records`), then the ratio, distance
    and cross-check tests. CUDA tensors launch the guided kernel for the
    rows and, with cross_check, on the transpose (the same mask, transposed
    bit for bit); CPU tensors take its plain version."""
    geo1, geo2 = point_records(uv1, uv2, F, opts.guided_max_error)
    s1, s2, idx = match_top2_u8_guided(d1, d2, inv1, inv2, geo1, geo2, valid2, valid1)
    idx = idx.long()
    back = match_top2_u8_guided(d2, d1, inv2, inv1, geo2, geo1, valid1, valid2)[2] if opts.cross_check else None
    return idx, _accept(s1, s2, idx, back, valid1, opts) & (s1 > -1.5)


def matches_to_pairs(idx, ok) -> np.ndarray:
    """[M, 2] int32 (i1, i2) of the accepted rows (host-side convenience)."""
    idx = idx.cpu().numpy() if torch.is_tensor(idx) else np.asarray(idx)
    ok = ok.cpu().numpy() if torch.is_tensor(ok) else np.asarray(ok)
    rows = np.nonzero(ok)[0]
    return np.stack([rows, idx[rows]], axis=-1).astype(np.int32)
