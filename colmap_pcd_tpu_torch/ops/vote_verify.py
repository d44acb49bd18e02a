"""Vote-and-verify spatial re-ranking for retrieval candidates.

Port of colmap_pcd_tpu/ops/vote_verify.py (the reference's
src/retrieval/vote_and_verify.{h,cc}, Schönberger et al., ACCV 2016): score a
candidate image by the effective inlier count of a similarity/affine
transform voted from quantized feature matches, which suppresses false loop
closures on repetitive structure.

One call scores a query against a bank of C candidates, batched natively
over C:
  * match candidates come from shared visual words (the VLAD codebook cell,
    ops/retrieval.py): per query feature, up to `partners` same-word
    features found by a stable sort + left-sided searchsorted;
  * votes go to a dense 4D histogram (translation x2, log-scale, angle) with
    a factor-2 sum-pooling pyramid; the counts are sums of 0/1 and exact in
    any order, so a scatter-add gives the same histogram on every run;
  * the top-K bins (a stable descending sort: `jax.lax.top_k` takes the
    lowest index among equal scores, `torch.topk` promises no order) give
    mean transforms, whose sums are one-hot products over the K bins only:
    deterministic, and no [C, bins, 4] tensor;
  * the K transforms are verified as a bank (two-way transfer + scale
    checks), the best refit by weighted least-squares affine (two 3x3
    normal systems in closed form) and kept if it has more inliers;
  * the score is the effective inlier count: the occupancy of inlier query
    features over a 16x16 grid of their bounding box.

The geometry (transforms, bins, means, inlier tests, the affine refit) is
computed in float64: in f32 the card's sin/cos and product sums differ from
the CPU's in the last bits, and a vote or an inlier test at the edge then
flips (1 of 200 scores differed on the pixel world's shortlists, NVIDIA
H100, chip_smoke phase 11). The histogram and its pyramid stay f32 sums of
0/1 votes, exact as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .solvers import solve3

Tensor = torch.Tensor


class VoteVerifyOptions(NamedTuple):
    num_transformations: int = 8  # top-K voted transforms to verify
    num_trans_bins: int = 32  # translation bins per axis (ref: 64)
    num_scale_bins: int = 16  # log2-scale bins (ref: 32)
    num_angle_bins: int = 8
    num_levels: int = 4  # multi-resolution pyramid depth (ref: 6)
    max_image_size: float = 4096.0  # translation vote range bound
    max_log_scale: float = np.log2(10.0)
    max_transfer_error: float = 100.0**2  # squared px, two-way sum
    max_scale_error: float = 2.0
    min_num_votes: int = 1
    partners: int = 4  # same-word partners per query feature
    eff_bins: int = 16  # effective-count occupancy grid


def _pair_transforms(g1: Tensor, g2: Tensor):
    """Similarity transform (s, angle, tx, ty) mapping feature 1's frame to
    feature 2's, per pair (FeatureGeometry::TransformFromMatch)."""
    s = g2[..., 2] / torch.clamp(g1[..., 2], min=1e-8)
    a = g2[..., 3] - g1[..., 3]
    a = torch.remainder(a + math.pi, 2 * math.pi) - math.pi  # floor mod, wrap to [-pi, pi)
    ca, sa = torch.cos(a), torch.sin(a)
    tx = g2[..., 0] - s * (ca * g1[..., 0] - sa * g1[..., 1])
    ty = g2[..., 1] - s * (sa * g1[..., 0] + ca * g1[..., 1])
    return s, a, tx, ty


def _two_way_inliers(A: Tensor, t: Tensor, g1: Tensor, g2: Tensor, w: Tensor, opts) -> Tensor:
    """Per-pair inlier mask [..., P] under affine A [..., 2, 2], t [..., 2]:
    forward + backward transfer error and feature scale consistency
    (ComputeScaleError / ComputeTransferError). g1, g2 [..., P, 4]."""
    a00, a01, a10, a11 = (A[..., i, j, None] for i, j in ((0, 0), (0, 1), (1, 0), (1, 1)))
    t0, t1 = t[..., 0, None], t[..., 1, None]
    det = a00 * a11 - a01 * a10
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    i00, i01, i10, i11 = a11 / det, -a01 / det, -a10 / det, a00 / det
    ti0 = -(i00 * t0 + i01 * t1)
    ti1 = -(i10 * t0 + i11 * t1)
    x1, y1, x2, y2 = g1[..., 0], g1[..., 1], g2[..., 0], g2[..., 1]
    e12 = (x2 - (x1 * a00 + y1 * a01) - t0) ** 2 + (y2 - (x1 * a10 + y1 * a11) - t1) ** 2
    e21 = (x1 - (x2 * i00 + y2 * i01) - ti0) ** 2 + (y1 - (x2 * i10 + y2 * i11) - ti1) ** 2
    # feature area ratio under the transform (similarity: |det| * scale1^2)
    area_t = torch.abs(det) * g1[..., 2] ** 2
    area_m = torch.clamp(g2[..., 2] ** 2, min=1e-12)
    ratio = torch.maximum(area_t / area_m, area_m / torch.clamp(area_t, min=1e-12))
    return (
        w
        * (e12 + e21 <= opts.max_transfer_error).to(w.dtype)
        * (ratio <= opts.max_scale_error**2).to(w.dtype)
    )


def _fit_affine(xy1: Tensor, xy2: Tensor, w: Tensor) -> tuple[Tensor, Tensor]:
    """Weighted least-squares affine xy2 ~ A xy1 + t per item (two 3x3
    normal systems, AffineTransformEstimator::Estimate analog, solved in
    closed form). xy1, xy2 [..., P, 2], w [..., P] -> A [..., 2, 2], t [..., 2]."""
    X = torch.cat([xy1, torch.ones_like(xy1[..., :1])], dim=-1)  # [..., P, 3]
    XtX = X.mT @ (X * w[..., None]) + 1e-6 * torch.eye(3, dtype=X.dtype, device=X.device)
    rhs = X.mT @ (xy2 * w[..., None])  # [..., 3, 2]
    sol = torch.stack([solve3(XtX, rhs[..., 0]), solve3(XtX, rhs[..., 1])], dim=-1)  # [..., 3, 2]
    return sol[..., :2, :].mT, sol[..., 2, :]


def vote_and_verify_batch(
    geom1: Tensor,  # [N1, 4] (x, y, scale, orientation) of the query image
    word1: Tensor,  # [N1] codebook cell per feature
    valid1: Tensor,  # [N1]
    geom2: Tensor,  # [C, N2, 4] candidate images
    word2: Tensor,  # [C, N2]
    valid2: Tensor,  # [C, N2]
    opts: VoteVerifyOptions = VoteVerifyOptions(),
) -> Tensor:
    """Effective inlier count [C] int32 of the best voted transform between
    the query and each candidate: re-ranking a query's shortlist is one
    batched call."""
    C, N2 = word2.shape
    N1 = geom1.shape[0]
    M = opts.partners
    dev = geom1.device
    geom1, geom2 = geom1.double(), geom2.double()

    # ---- 1. candidate matches by shared visual word (sort + searchsorted)
    big = torch.iinfo(torch.int32).max
    w2 = torch.where(valid2 > 0, word2.long(), torch.full_like(word2, big, dtype=torch.int64))
    w2s, order2 = torch.sort(w2, dim=1, stable=True)
    starts = torch.searchsorted(w2s, word1.long()[None, :].expand(C, N1).contiguous())  # [C, N1]
    pos = starts[:, :, None] + torch.arange(M, device=dev)  # [C, N1, M]
    cand = torch.clamp(pos, 0, N2 - 1).reshape(C, -1)
    j = torch.gather(order2, 1, cand)  # [C, P] partner indices
    ok = (
        (valid1[None, :, None] > 0)
        & (pos < N2)
        & (torch.gather(w2s, 1, cand).view(C, N1, M) == word1.long()[None, :, None])
    )
    P = N1 * M
    g1 = geom1[:, None, :].expand(N1, M, 4).reshape(P, 4)  # query feature of each pair
    g2 = torch.gather(geom2, 1, j[..., None].expand(C, P, 4))  # [C, P, 4]

    # ---- 2. per-pair similarity transform votes
    s, a, tx, ty = _pair_transforms(g1, g2)
    ls = torch.log2(torch.clamp(s, min=1e-8))
    in_range = (
        (torch.abs(tx) <= opts.max_image_size)
        & (torch.abs(ty) <= opts.max_image_size)
        & (torch.abs(ls) <= opts.max_log_scale)
    )
    w = (ok.reshape(C, P) & in_range).double()

    nt, ns, na = opts.num_trans_bins, opts.num_scale_bins, opts.num_angle_bins

    def bin_of(x, half_range, n):  # truncation toward zero, as astype(int32)
        return torch.clamp(((x / half_range + 1) * 0.5 * n).to(torch.int64), 0, n - 1)

    flat = ((bin_of(ty, opts.max_image_size, nt) * nt + bin_of(tx, opts.max_image_size, nt)) * ns
            + bin_of(ls, opts.max_log_scale, ns)) * na + bin_of(a, math.pi, na)
    nbins = nt * nt * ns * na
    counts = torch.zeros((C, nbins), device=dev).scatter_add_(1, flat, w.float())

    # ---- 3. multi-resolution score: factor-2 sum pooling per level,
    # broadcast back to the base bins
    score = counts
    base = counts.view(C, nt, nt, ns, na)
    lw = 0.5
    for level in range(1, opts.num_levels):
        f = 2**level
        shape, dims = [C], []
        for d in (nt, nt, ns, na):
            blk = min(f, d)
            dims.append(d // blk)
            shape.extend([d // blk, blk])
        up = base.reshape(shape).sum(dim=(2, 4, 6, 8))
        for ax, (d, pd) in enumerate(zip((nt, nt, ns, na), dims)):
            up = torch.repeat_interleave(up, d // pd, dim=ax + 1)
        score = score + lw * up.reshape(C, -1)
        lw *= 0.5
    score = torch.where(counts >= opts.min_num_votes, score, torch.full_like(score, -math.inf))

    # ---- 4. top-K bins -> mean transforms; the sums over each bin's votes
    # as a one-hot product over the K bins
    K = opts.num_transformations
    top_score, top_bin = (x[:, :K] for x in torch.sort(score, dim=1, descending=True, stable=True))
    hit = (flat[:, None, :] == top_bin[:, :, None]).double() * w[:, None, :]  # [C, K, P]
    sums = hit @ torch.stack([s, a, tx, ty], dim=-1)  # [C, K, 4]
    mean = sums / torch.clamp(torch.gather(counts, 1, top_bin).double()[..., None], min=1.0)
    k_ok = torch.isfinite(top_score)

    # ---- 5. bank verification: two-way transfer + scale error, [C, K, P]
    s_k, a_k = mean[..., 0], mean[..., 1]
    ca, sa = torch.cos(a_k), torch.sin(a_k)
    A = s_k[..., None, None] * torch.stack([torch.stack([ca, -sa], -1), torch.stack([sa, ca], -1)], -2)
    inl_k = _two_way_inliers(A, mean[..., 2:], g1, g2[:, None], w[:, None], opts)
    n_k = torch.where(k_ok, torch.sum(inl_k, dim=-1).float(), torch.full_like(top_score, -1.0))
    best = torch.argmax(n_k, dim=1)
    best_mask = torch.gather(inl_k, 1, best[:, None, None].expand(C, 1, P))[:, 0]  # [C, P]

    # ---- 6. LO: weighted LSQ affine refit on the best inliers, recount
    A_lo, t_lo = _fit_affine(g1[:, :2].expand(C, P, 2), g2[..., :2], best_mask)
    lo_mask = _two_way_inliers(A_lo, t_lo, g1, g2, w, opts)
    use_lo = torch.sum(lo_mask, dim=-1) > torch.sum(best_mask, dim=-1)
    final_mask = torch.where(use_lo[:, None], lo_mask, best_mask)

    # ---- 7. effective inlier count: per-query-feature any-inlier, 16x16
    # occupancy over the inlier bounding box
    per_feat = final_mask.view(C, N1, M).amax(dim=-1)  # [C, N1]
    xy = geom1[:, :2]
    hitf = (per_feat > 0)[..., None]
    mn = torch.amin(torch.where(hitf, xy, torch.full_like(xy, 1e12)), dim=1)  # [C, 2]
    mx = torch.amax(torch.where(hitf, xy, torch.full_like(xy, -1e12)), dim=1)
    span = torch.clamp(mx - mn, min=1e-6)
    nb = opts.eff_bins
    cells = torch.clamp(((xy - mn[:, None]) / span[:, None] * nb).to(torch.int64), 0, nb - 1)
    cflat = cells[..., 0] * nb + cells[..., 1]  # [C, N1]
    occ = torch.zeros((C, nb * nb), dtype=per_feat.dtype, device=dev).scatter_reduce_(1, cflat, per_feat, "amax")
    eff = torch.sum(occ, dim=1).to(torch.int32)
    return torch.where(torch.any(per_feat > 0, dim=1), eff, torch.zeros_like(eff))


def vote_and_verify(geom1, word1, valid1, geom2, word2, valid2,
                    opts: VoteVerifyOptions = VoteVerifyOptions()) -> Tensor:
    """Effective inlier count (int32 scalar) of one candidate [N2, 4], [N2],
    [N2]: the batch of one."""
    return vote_and_verify_batch(geom1, word1, valid1, geom2[None], word2[None], valid2[None], opts)[0]
