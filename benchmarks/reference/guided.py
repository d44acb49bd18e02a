"""A plain reference of the matcher's guided re-match, in plain PyTorch at
float64.

COLMAP's guided matcher (feature/matching.h:277-310, with the JAX
package's `ops/matching.match_guided` as the port's semantics): for a pair
of images with a fundamental matrix F (x2^T F x1 = 0, pixels), the
similarity of two keypoints is the dot product of their L2-normalized
descriptors; a pair of keypoints is a candidate where its Sampson error

    (x2^T F x1)^2 / ((F x1)_0^2 + (F x1)_1^2 + (F^T x2)_0^2 + (F^T x2)_1^2)

lies below max_error^2; every row takes its best candidate column, and
keeps it where arccos of its similarity is below max_distance and below
max_ratio times arccos of the second best candidate's (-2, an arccos of
pi, where there is none), and, with the cross-check, where the column's
best candidate row is the row itself. Ties go to the lower index.

The pair is computed in blocks of rows, so that no [N1, N2] matrix exists
whole: the rows' best two, the columns' best two and best row carried from
block to block. Beside the matches it says which rows it decides, with
margins for the program's f32 arithmetic (the port forms the similarity
from uint8 descriptors and f32 inverse norms, a few ulps of 1 off, and the
Sampson test from f32 point records, some 1e-4 of the threshold off):

- SIM_MARGIN: a row whose best two candidates, or whose best column's best
  two rows, lie within it of each other is not decided;
- DIST_MARGIN: a row whose ratio or distance test lies within it (radians)
  of its boundary is not decided;
- ERR_MARGIN: a row is not decided where a pair of keypoints whose Sampson
  error lies within ERR_MARGIN * max_error^2 of the threshold (inside or
  out) has a similarity that could enter the row's best two, or its best
  column's best two.

Departures from COLMAP: no `max_num_matches` cap (the port has none), and
the descriptors' similarity is the float64 dot product of the uint8
descriptors normalized, where COLMAP rounds them to integers first.
Imports nothing of the program; TF32 is turned off for its products.
"""

from __future__ import annotations

import math

import torch

SIM_MARGIN = 1e-5
DIST_MARGIN = 1e-4
ERR_MARGIN = 1e-3
BLOCK_ROWS = 1024


def _best2_along(x: torch.Tensor, dim: int):
    """(best, index of the first best, second best) along `dim`."""
    idx = torch.argmax(x, dim=dim)
    best = torch.gather(x, dim, idx.unsqueeze(dim)).squeeze(dim)
    masked = x.scatter(dim, idx.unsqueeze(dim), -math.inf)
    return best, idx, torch.amax(masked, dim=dim)


def guided_matches(d1, d2, uv1, uv2, F, max_error: float = 4.0, max_ratio: float = 0.8,
                   max_distance: float = 0.7, cross_check: bool = True, sim_dtype=torch.float64,
                   device="cpu") -> dict:
    """The guided matches of one pair: d1 [N1, D], d2 [N2, D] descriptors
    (any dtype), uv1 [N1, 2], uv2 [N2, 2] pixel coordinates, F [3, 3].
    Similarities are formed in `sim_dtype` (the reference's precision; the
    rest in float64). Returns numpy arrays: `match` [N1] (the column, -1
    where the row keeps none) and `decided` [N1] bool."""
    torch.backends.cuda.matmul.allow_tf32 = False
    f64 = dict(dtype=torch.float64, device=device)
    a = torch.as_tensor(d1, device=device).to(torch.float64)
    b = torch.as_tensor(d2, device=device).to(torch.float64)
    a = a / torch.linalg.norm(a, dim=1, keepdim=True).clamp(min=1e-300)
    b = b / torch.linalg.norm(b, dim=1, keepdim=True).clamp(min=1e-300)
    a, b = a.to(sim_dtype), b.to(sim_dtype)
    F = torch.as_tensor(F, **f64)
    x1 = torch.cat([torch.as_tensor(uv1, **f64), torch.ones(len(uv1), 1, **f64)], 1)
    x2 = torch.cat([torch.as_tensor(uv2, **f64), torch.ones(len(uv2), 1, **f64)], 1)
    line1, line2 = x1 @ F.T, x2 @ F  # F x1, F^T x2
    den2 = line2[:, 0] ** 2 + line2[:, 1] ** 2
    thr = max_error ** 2
    N1, N2 = len(x1), len(x2)
    s1, s2 = torch.empty(N1, **f64), torch.empty(N1, **f64)
    idx = torch.empty(N1, dtype=torch.int64, device=device)
    row_near = torch.empty(N1, **f64)  # best raw similarity of a near-threshold pair, per row
    c1 = torch.full((N2,), -math.inf, **f64)
    c2 = torch.full((N2,), -math.inf, **f64)
    back = torch.zeros(N2, dtype=torch.int64, device=device)
    col_near = torch.full((N2,), -math.inf, **f64)
    for r0 in range(0, N1, BLOCK_ROWS):
        rows = slice(r0, min(N1, r0 + BLOCK_ROWS))
        sim = (a[rows] @ b.T).to(torch.float64)
        l1 = line1[rows]
        err = (l1 @ x2.T) ** 2 / ((l1[:, 0] ** 2 + l1[:, 1] ** 2)[:, None] + den2[None, :]).clamp(min=1e-12)
        near = (err - thr).abs() < ERR_MARGIN * thr
        masked = torch.where(err < thr, sim, torch.full_like(sim, -2.0))
        s1[rows], idx[rows], s2[rows] = _best2_along(masked, 1)
        s2[rows] = s2[rows].clamp(min=-2.0)
        near_sim = torch.where(near, sim, torch.full_like(sim, -math.inf))
        row_near[rows] = near_sim.amax(1)
        col_near = torch.maximum(col_near, near_sim.amax(0))
        bb, bi, bs = _best2_along(masked, 0)
        up = bb > c1  # a later block takes a column only with a strictly better row
        c2 = torch.where(up, torch.maximum(c1, bs), torch.maximum(c2, bb))
        back = torch.where(up, bi + r0, back)
        c1 = torch.where(up, bb, c1)
    dist1 = torch.arccos(s1.clamp(-1.0, 1.0))
    dist2 = torch.arccos(s2.clamp(-1.0, 1.0))
    ok = (s1 > -1.5) & (dist1 < max_distance) & (dist1 < max_ratio * dist2)
    rows_all = torch.arange(N1, device=device)
    if cross_check:
        ok &= back[idx] == rows_all
    undecided = (s1 > -1.5) & (s1 - s2 < SIM_MARGIN)
    undecided |= ((dist1 - max_ratio * dist2).abs() < DIST_MARGIN) | ((dist1 - max_distance).abs() < DIST_MARGIN)
    undecided |= row_near >= s2 - SIM_MARGIN
    if cross_check:
        undecided |= (s1 > -1.5) & (c1[idx] - c2[idx] < SIM_MARGIN)
        undecided |= col_near[idx] >= c2[idx] - SIM_MARGIN
    return {"match": torch.where(ok, idx, torch.full_like(idx, -1)).cpu().numpy(),
            "decided": (~undecided).cpu().numpy()}


def compare(match, decided, written, raw) -> dict:
    """The program's written inliers of one guided pair against the
    reference's guided matches, under the matcher's replacement rule
    (guided matches replace the verified inliers where they are more):
    the written inliers either agree with the reference's matches on every
    decided row, or are the pair's verified inliers, which are raw matches
    and at least as many as the decided guided matches. Otherwise each
    decided row on which they differ is a mismatch. `written` and `raw` are
    [M, 2] (row, column) arrays. Returns held (decided rows matched by
    either), mismatched, and whether the pair kept its inliers."""
    import numpy as np

    have = np.full(len(match), -1, np.int64)
    if len(written):
        have[np.asarray(written[:, 0], np.int64)] = np.asarray(written[:, 1], np.int64)
    held = decided & ((match >= 0) | (have >= 0))
    differ = held & (have != match)
    out = {"held": int(held.sum()), "mismatched": 0, "kept": 0}
    if not differ.any():
        return out
    raw_set = {(int(i), int(j)) for i, j in raw}
    as_inliers = all((int(i), int(j)) in raw_set for i, j in written)
    if as_inliers and int((decided & (match >= 0)).sum()) <= len(written):
        out["kept"] = 1
        return out
    out["mismatched"] = int(differ.sum())
    return out
