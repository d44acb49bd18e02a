"""A plain reference of the port's dense stereo: plane-sweep costs and
fusion's consistency test, in plain PyTorch at float64.

It computes what `ops/stereo.plane_sweep` and `consistency_mask` compute,
written out from their semantics, one depth of the bank at a time, for any
set of pixels of a reference view:

- the plane homography H = K_src (R + t n^T / d) K_ref^-1 of the
  fronto-parallel plane at depth d (n = (0, 0, 1)), applied to each pixel
  of the window as (u, v, w) -> (u / w, v / w), w clamped to 1e-8 where
  |w| < 1e-8;
- the bilinear sample of a source at those coordinates with the port's
  border rules: the corners clipped to the image first, then the fractions
  clipped to [0, 1]; valid where the unclipped coordinate lies inside
  [0, W-1] x [0, H-1];
- the bilaterally weighted zero-mean NCC over the (2r+1)^2 window
  (COLMAP's patch_match.h): a tap at offset o weighs
  exp(-|o|^2 / (2 sigma_spatial^2) - (I(p) - I(p+o))^2 / (2 sigma_color^2)),
  a tap outside the view takes the nearest border pixel (of the reference,
  and of the warped source with its validity); cost 1 - ncc with ncc
  clipped to [-1, 1], or 2 where the valid taps weigh no more than 0.8 of
  the window;
- in the geometric pass, the forward-backward reprojection error of the
  hypothesis against the source's given depth map (the source pixel
  back-projected at its sampled depth, mapped into the reference view),
  capped at geom_max_cost px (also where the sample is invalid, the depth
  not positive or the point behind the reference), weighted by
  geom_regularizer and added to the photometric cost;
- per depth, the mean of the best top_k sources by total cost (a stable
  sort: ties to the lower source index), and over the bank the first
  argmin; the gap between the two least costs (within rounding of 0 the
  argmin may fall on either) and the window's variance (near 0 the NCC is
  0 / 0, its cost rounding noise in any precision) say where the plane is
  determined;
- fusion's test: a pixel is kept where its photometric cost is below
  1 - min_ncc and at least min_consistent other views, at the pixel its
  point projects to (rounded half to even, clipped to the view), hold a
  depth within max_depth_error * 10 of the point's depth, relative.

Departures from COLMAP's PatchMatch, which the port shares: a fixed bank
of fronto-parallel planes spaced evenly in inverse depth between bounds
taken from the sparse points (2nd percentile x 0.8, 98th x 1.25) instead
of random slanted planes refined by propagation; the best top_k sources'
mean instead of COLMAP's sampled source probabilities; the geometric term
against the first pass's maps in one second pass instead of COLMAP's
iterations; fusion's depth gate ten times `max_depth_error` and against
the first four other views in registration order instead of a traversal
of neighbours with normal and reprojection gates. The box-filter NCC of
`sigma_color` <= 0 is not covered.

Imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, device=device).to(dtype)


def inv3(M: torch.Tensor) -> torch.Tensor:
    """The inverse of a 3x3 matrix: its adjugate over its determinant (in
    any dtype, float16 too)."""
    a, b, c, d, e, f, g, h, i = M.reshape(9)
    adj = torch.stack([e * i - f * h, c * h - b * i, b * f - c * e,
                       f * g - d * i, a * i - c * g, c * d - a * f,
                       d * h - e * g, b * g - a * h, a * e - b * d]).reshape(3, 3)
    return adj / (a * adj[0, 0] + b * adj[1, 0] + c * adj[2, 0])


def homography(K_ref, K_src, R, t, depth) -> torch.Tensor:
    """The ref -> src homography [3,3] of the fronto-parallel plane z = depth."""
    n = torch.zeros(3, dtype=K_ref.dtype, device=K_ref.device)
    n[2] = 1
    return K_src @ (R + t[:, None] * n[None, :] / depth) @ inv3(K_ref)


def warp(Hm, x, y) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixels (x, y) mapped by the homography Hm [..., 3, 3]."""
    u = Hm[..., 0, 0, None] * x + Hm[..., 0, 1, None] * y + Hm[..., 0, 2, None]
    v = Hm[..., 1, 0, None] * x + Hm[..., 1, 1, None] * y + Hm[..., 1, 2, None]
    w = Hm[..., 2, 0, None] * x + Hm[..., 2, 1, None] * y + Hm[..., 2, 2, None]
    w = torch.where(w.abs() < 1e-8, torch.full_like(w, 1e-8), w)
    return u / w, v / w


def bilinear(img, x, y) -> tuple[torch.Tensor, torch.Tensor]:
    """img [H,W] at (x, y): (value, valid) with the port's border rules."""
    H, W = img.shape
    x0 = torch.nan_to_num(torch.floor(x), nan=0.0).clamp(0, W - 1)
    y0 = torch.nan_to_num(torch.floor(y), nan=0.0).clamp(0, H - 1)
    x1, y1 = (x0 + 1).clamp(0, W - 1), (y0 + 1).clamp(0, H - 1)
    fx, fy = (x - x0).clamp(0, 1), (y - y0).clamp(0, 1)
    flat = img.reshape(-1)
    r0, r1 = y0.long() * W, y1.long() * W
    c0, c1 = x0.long(), x1.long()

    def at(i):
        return torch.index_select(flat, 0, i.reshape(-1)).reshape(i.shape)

    v = (at(r0 + c0) * (1 - fx) * (1 - fy) + at(r0 + c1) * fx * (1 - fy)
         + at(r1 + c0) * (1 - fx) * fy + at(r1 + c1) * fx * fy)
    valid = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    return v, valid


def plane_costs(ref, srcs, K_ref, K_srcs, R_rel, t_rel, depths, xs, ys, *, window_radius: int,
                sigma_spatial: float = -1.0, sigma_color: float = 0.2, top_k: int = 2, src_depths=None,
                geom_regularizer: float = 0.3, geom_max_cost: float = 3.0, dtype=torch.float64, device=None):
    """(total [N, D], photometric [N, D]) of the pixels (xs, ys) [N] of
    the reference view `ref` [H,W] against the sources `srcs` [S,H,W] at
    every depth of the bank `depths` [D]: the best top_k sources' mean,
    and the photometric part of the same sources. R_rel, t_rel [S,3,3],
    [S,3] take reference-camera points to the sources'; with `src_depths`
    [S,H,W] the geometric pass. Computed in `dtype` on `device` (default:
    ref's)."""
    if sigma_color <= 0:
        raise ValueError("the reference covers the bilaterally weighted NCC only (sigma_color > 0)")
    device = device if device is not None else (ref.device if torch.is_tensor(ref) else "cpu")
    f = dict(dtype=dtype, device=device)
    ref, srcs, K_ref, K_srcs = (_t(a, dtype, device) for a in (ref, srcs, K_ref, K_srcs))
    R_rel, t_rel, depths = (_t(a, dtype, device) for a in (R_rel, t_rel, depths))
    S = srcs.shape[0]
    tx, ty, w, I_t = _window(ref, xs, ys, window_radius, sigma_spatial, sigma_color)
    px, py = tx[:, tx.shape[1] // 2], ty[:, ty.shape[1] // 2]
    Wsum = w.sum(1).clamp(min=1e-8)
    mu_r = (w * I_t).sum(1) / Wsum
    var_r = ((w * I_t * I_t).sum(1) / Wsum - mu_r * mu_r).clamp(min=1e-8)
    txf, tyf = tx.to(dtype), ty.to(dtype)
    pxf, pyf = px.to(dtype), py.to(dtype)
    gmax = torch.tensor(geom_max_cost, **f)
    k = min(top_k, S)
    total = torch.empty(len(px), len(depths), **f)
    photo = torch.empty_like(total)
    for d in range(len(depths)):
        c_tot, c_ph = [], []
        for s in range(S):
            Hm = homography(K_ref, K_srcs[s], R_rel[s], t_rel[s], depths[d])
            sx, sy = warp(Hm, txf, tyf)
            val, ok = bilinear(srcs[s], sx, sy)
            okf = ok.to(dtype)
            mu_w = (w * val).sum(1) / Wsum
            var_w = ((w * val * val).sum(1) / Wsum - mu_w * mu_w).clamp(min=1e-8)
            cov = (w * I_t * val).sum(1) / Wsum - mu_r * mu_w
            ncc = (cov / torch.sqrt(var_r * var_w)).clamp(-1, 1)
            cost = torch.where((w * okf).sum(1) > 0.8 * Wsum, 1 - ncc, torch.full_like(ncc, 2))
            c_ph.append(cost)
            if src_depths is not None:
                cost = cost + geom_regularizer * _geom_cost(
                    Hm, pxf, pyf, _t(src_depths[s], dtype, device), K_ref, K_srcs[s], R_rel[s], t_rel[s], gmax)
            c_tot.append(cost)
        c_tot, c_ph = torch.stack(c_tot, 1), torch.stack(c_ph, 1)  # [N, S]
        order = torch.sort(c_tot, dim=1, stable=True).indices[:, :k]
        total[:, d] = torch.gather(c_tot, 1, order).mean(1)
        photo[:, d] = torch.gather(c_ph, 1, order).mean(1)
    return total, photo


def _window(ref, xs, ys, r: int, sigma_spatial: float, sigma_color: float):
    """The window's taps of the pixels (xs, ys) [N], clipped to the view
    (the nearest border pixel): (x [N,T], y [N,T], bilateral weight [N,T],
    the reference's value [N,T]); the centre tap is the middle one."""
    H, W = ref.shape
    device = ref.device
    px = torch.as_tensor(np.asarray(xs), device=device).long()
    py = torch.as_tensor(np.asarray(ys), device=device).long()
    oy, ox = torch.meshgrid(torch.arange(-r, r + 1, device=device), torch.arange(-r, r + 1, device=device),
                            indexing="ij")
    oy, ox = oy.reshape(-1), ox.reshape(-1)
    ty = (py[:, None] + oy[None]).clamp(0, H - 1)
    tx = (px[:, None] + ox[None]).clamp(0, W - 1)
    ss = sigma_spatial if sigma_spatial > 0 else float(r)
    I_c, I_t = ref[py, px][:, None], ref[ty, tx]
    spatial = (ox * ox + oy * oy).to(ref.dtype) / (2 * ss * ss)
    w = torch.exp(-spatial[None] - (I_c - I_t) ** 2 / (2 * sigma_color * sigma_color))
    return tx, ty, w, I_t


def window_variance(ref, xs, ys, *, window_radius: int, sigma_spatial: float = -1.0,
                    sigma_color: float = 0.2) -> torch.Tensor:
    """The bilaterally weighted variance [N] of the reference's window at
    the pixels (xs, ys), in float64. Where it is near 0 (a flat window) the
    NCC is 0 / 0 and its cost is rounding noise in any precision: a plane is
    not held there."""
    ref = _t(ref, torch.float64, ref.device if torch.is_tensor(ref) else "cpu")
    _, _, w, I_t = _window(ref, xs, ys, window_radius, sigma_spatial, sigma_color)
    mu = (w * I_t).sum(1) / w.sum(1)
    return (w * I_t * I_t).sum(1) / w.sum(1) - mu * mu


def _geom_cost(Hm, px, py, src_depth, K_ref, K_src, R, t, gmax):
    """The capped forward-backward reprojection error (pixels) of the
    hypothesis Hm at pixels (px, py) against the source's depth map."""
    sx, sy = warp(Hm, px, py)
    d_s, ok = bilinear(src_depth, sx, sy)
    y_src = torch.stack([sx, sy, torch.ones_like(sx)], -1) @ inv3(K_src).T * d_s[:, None]
    y_ref = (y_src - t) @ R  # R^T (y - t)
    q = y_ref @ K_ref.T
    qz = torch.where(q[:, 2].abs() < 1e-8, torch.full_like(q[:, 2], 1e-8), q[:, 2])
    err = torch.sqrt((q[:, 0] / qz - px) ** 2 + (q[:, 1] / qz - py) ** 2)
    ok = ok & (d_s > 0) & (y_ref[:, 2] > 0)
    return torch.where(ok, torch.minimum(err, gmax), gmax)


def best_plane(total: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(first argmin over the bank [N], the gap between the two least costs
    [N]); a gap within rounding is a tie, on which the plane is not held."""
    two = torch.topk(total, min(2, total.shape[1]), dim=1, largest=False).values
    gap = two[:, 1] - two[:, 0] if two.shape[1] > 1 else torch.full_like(two[:, 0], float("inf"))
    return torch.argmin(total, dim=1), gap


def consistency_mask(depth_ref, cost_ref, depths_other, K, R_to_other, t_to_other, *, min_consistent: int,
                     max_depth_error: float, min_ncc: float, dtype=torch.float64):
    """(mask [H,W] bool, margin [H,W]): fusion's test of every pixel of the
    reference view against the other views' depth maps [V,H,W], and each
    pixel's least distance to one of the test's decision boundaries (the
    rounding of the projected pixel, the view's border, the depth gate, the
    cost gate), in pixels or in relative depth; a pixel within rounding of
    a boundary may fall either way."""
    dev = depth_ref.device if torch.is_tensor(depth_ref) else "cpu"
    depth_ref, cost_ref, depths_other, K, R_to_other, t_to_other = (
        _t(a, dtype, dev) for a in (depth_ref, cost_ref, depths_other, K, R_to_other, t_to_other))
    H, W = depth_ref.shape
    yy, xx = torch.meshgrid(torch.arange(H, device=dev).to(dtype), torch.arange(W, device=dev).to(dtype),
                            indexing="ij")
    pix = torch.stack([xx, yy, torch.ones_like(xx)], -1)
    x_ref = pix @ inv3(K).T * depth_ref[..., None]
    gate = max_depth_error * 10
    count = torch.zeros(H, W, dtype=torch.int64, device=dev)
    margin = (cost_ref - (1 - min_ncc)).abs()
    for v in range(depths_other.shape[0]):
        x_o = x_ref @ R_to_other[v].T + t_to_other[v]
        uv = x_o @ K.T
        w = torch.where(uv[..., 2].abs() < 1e-8, torch.full_like(uv[..., 2], 1e-8), uv[..., 2])
        u, vv = uv[..., 0] / w, uv[..., 1] / w
        ui = torch.nan_to_num(torch.round(u), nan=0.0).clamp(0, W - 1).long()
        vi = torch.nan_to_num(torch.round(vv), nan=0.0).clamp(0, H - 1).long()
        z_o = x_o[..., 2]
        d_o = depths_other[v][vi, ui]
        rel = (d_o - z_o).abs() / z_o.clamp(min=1e-6)
        inside = (u >= 0) & (u <= W - 1) & (vv >= 0) & (vv <= H - 1)
        count += ((z_o > 0) & inside & (rel < gate)).long()
        frac = torch.minimum((u - u.floor() - 0.5).abs(), (vv - vv.floor() - 0.5).abs())
        edge = torch.stack([u.abs(), (u - (W - 1)).abs(), vv.abs(), (vv - (H - 1)).abs()]).amin(0)
        near = torch.minimum(torch.minimum(frac, edge), (rel - gate).abs())
        margin = torch.minimum(margin, torch.nan_to_num(near, nan=0.0))
    mask = (count >= min_consistent) & (cost_ref < 1 - min_ncc)
    return mask, margin
