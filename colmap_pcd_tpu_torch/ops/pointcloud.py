"""Device ops on the LiDAR map: depth projection, ray-plane seeding, 1-NN.

Port of colmap_pcd_tpu/ops/pointcloud.py (`frustum_planes` :56,
`points_in_frustum` :105, `depth_project` :134, `depth_project_batch`
:222, `depth_project_shared` :235, `nn_query` :260, `ray_plane_points`
:305). The reference splats points into a z-buffered depth image behind mutexes
(src/lidar/pcd_projection.cc:315-462); here every (feature, candidate point)
pair is tested for splat coverage and the nearest covering point per
feature wins through a blocked running argmin — exact, no scatter.

The JAX version vmaps depth_project over views; here the batch of views is
an explicit leading dimension (of the candidates too, in
depth_project_batch), and the candidate block is sized so that one
[B, F, block] temporary stays near 256 MB.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import camera_models as cm
from . import se3

Tensor = torch.Tensor

# The reference normalizes splat footprints by this focal length
# (pcd_projection.cc:384-388 magic constant) and by depth_image_scale/0.2.
_REF_FOCAL = 3039.0
_REF_SCALE = 0.2

# elements of one [B, F, block] coverage temporary (f32: 256 MB)
_BLOCK_ELEMS = 1 << 26


class ProjOptions(NamedTuple):
    """Depth-projection options (PcdProjectionOptions, pcd_projection.h:31-46)."""

    depth_image_scale: float = 0.2
    max_proj_scale: int = 10
    min_proj_scale: int = 2
    min_proj_dist: float = 2.0
    choose_meter: float = 40.0
    min_lidar_proj_dist: float = 0.5
    submap_cell: float = 1.0  # submap_length/width/height (cubical cells)


def frustum_planes(q: Tensor, t: Tensor, fx, fy, cx, cy, width, height, choose_meter) -> Tensor:
    """The 5 planes of the view pyramid (camera apex + 4 corners at depth D).

    Returns planes [5,4] with inward side satisfying a.x+b.y+c.z+d <= 0,
    matching SearchSubMap/SearchImageMap (pcd_projection.cc:258-297,499-559).
    (fx..cy, width, height are at full resolution; the frustum is
    scale-invariant.)
    """
    qi = se3.quat_conj(q)
    center = se3.projection_center(q, t)  # apex
    x_min = -cx / fx
    x_max = (width - cx) / fx
    y_min = -cy / fy
    y_max = (height - cy) / fy
    D = choose_meter
    corners_cam = torch.tensor(
        [
            [x_max * D, y_max * D, D],
            [x_max * D, y_min * D, D],
            [x_min * D, y_min * D, D],
            [x_min * D, y_max * D, D],
        ],
        dtype=q.dtype, device=q.device,
    )
    corners = se3.quat_rotate(qi[None, :], corners_cam) + center[None, :]
    # orient each plane so that the frustum centroid is on the inside (<= 0)
    centroid = (center + torch.sum(corners, dim=0)) / 5.0

    def oriented(p0, p1, p2):
        n = torch.linalg.cross(p1 - p0, p2 - p0)
        n = n / torch.clamp(torch.linalg.norm(n), min=1e-12)
        d = -torch.dot(n, p0)
        flip = torch.where(torch.dot(n, centroid) + d > 0, -1.0, 1.0)
        return torch.cat([n * flip, (d * flip)[None]])

    c1, c2, c3, c4 = corners[0], corners[1], corners[2], corners[3]
    return torch.stack(
        [
            oriented(c1, c2, c3),  # far plane through the 4 corners
            oriented(center, c1, c2),
            oriented(center, c2, c3),
            oriented(center, c3, c4),
            oriented(center, c4, c1),
        ]
    )


def points_in_frustum(planes: Tensor, pts: Tensor) -> Tensor:
    """Boolean mask of pts [M,3] inside all 5 half-spaces."""
    vals = pts @ planes[:, :3].T + planes[None, :, 3]  # [M,5]
    return torch.all(vals <= 0.0, dim=-1)


def splat_scales(dist: Tensor, fx, fy, opts: ProjOptions):
    """Depth-dependent splat half-extent in scaled pixels (x and y): linear
    from max_proj_scale at min_proj_dist down to min_proj_scale at
    choose_meter, normalized by focal/3039 and scale/0.2
    (pcd_projection.cc:376-413; both axes use the scaled min)."""
    s = opts.depth_image_scale / _REF_SCALE

    def one_axis(f):
        mx = opts.max_proj_scale * (f / _REF_FOCAL) * s
        mn = opts.min_proj_scale * (f / _REF_FOCAL) * s
        a = (mx - mn) / (opts.min_proj_dist - opts.choose_meter)
        b = mn - a * opts.choose_meter
        return torch.floor(torch.where(dist <= opts.min_proj_dist, mx, a * dist + b))

    return one_axis(fx), one_axis(fy)


def _block_size(B: int, F: int, M: int) -> int:
    return max(256, min(M, _BLOCK_ELEMS // max(B * F, 1)))


def _depth_project(feat_xy, feat_valid, pts_all, nrm_all, valid_all, q, t, params,
                   width, height, model_id, opts, block):
    """The nearest covering point per feature of B views over candidate sets
    [M,3] (one set shared by all views) or [B,M,3] (one set per view)."""
    sc = opts.depth_image_scale
    fx, fy, _, _ = cm.focal_pp(params, model_id)  # [B]
    fuv = torch.floor(feat_xy * sc)  # [B,F,2] feature pixels in the scaled grid
    in_img = (
        (fuv[..., 0] >= 0)
        & (fuv[..., 0] < float(int(width * sc)))
        & (fuv[..., 1] >= 0)
        & (fuv[..., 1] < float(int(height * sc)))
    )
    feat_ok = (feat_valid > 0) & in_img

    B, F = feat_xy.shape[:2]
    M = pts_all.shape[-2]
    dev = pts_all.device
    block = block or _block_size(B, F, M)
    big = torch.tensor(1e30, dtype=torch.float32, device=dev)
    best_dist = torch.full((B, F), 1e30, dtype=torch.float32, device=dev)
    best_idx = torch.zeros((B, F), dtype=torch.int64, device=dev)
    qb, tb, pb = q[:, None, :], t[:, None, :], params[:, None, :]
    for start in range(0, M, block):
        pts = pts_all[..., start : start + block, :]  # [b,3] or [B,b,3]
        val = valid_all[..., start : start + block]
        pc = se3.se3_apply(qb, tb, pts)  # [B,b,3]
        z = pc[..., 2]
        dist = torch.linalg.norm(pc, dim=-1)
        xy, _ = cm.project(model_id, pb, qb, tb, pts)  # [B,b,2]
        puv = torch.round(xy * sc)
        sx, sy = splat_scales(z, fx[:, None], fy[:, None], opts)
        ok = (
            (val > 0)
            & (z > 0)
            & (z >= opts.min_lidar_proj_dist)
            & (z <= opts.choose_meter)
        )
        # coverage per (feature, candidate): |fu - pu| <= sx and |fv - pv| <= sy
        cover = (
            (torch.abs(fuv[:, :, None, 0] - puv[:, None, :, 0]) <= sx[:, None, :])
            & (torch.abs(fuv[:, :, None, 1] - puv[:, None, :, 1]) <= sy[:, None, :])
            & ok[:, None, :]
        )  # [B,F,b]
        d = torch.where(cover, dist[:, None, :], big)
        bd, bi = torch.min(d, dim=-1)
        upd = bd < best_dist
        best_dist = torch.where(upd, bd, best_dist)
        best_idx = torch.where(upd, bi + start, best_idx)
    found = (best_dist < 1e30) & feat_ok
    if pts_all.dim() == 2:
        return pts_all[best_idx], nrm_all[best_idx], found
    idx = best_idx[..., None]
    return torch.take_along_dim(pts_all, idx, dim=1), torch.take_along_dim(nrm_all, idx, dim=1), found


def depth_project_shared(
    feat_xy: Tensor,  # [B,F,2] full-res feature pixels
    feat_valid: Tensor,  # [B,F]
    map_pts: Tensor,  # [M,3] world-frame candidate lidar points, shared by all views
    map_nrm: Tensor,  # [M,3]
    map_valid: Tensor,  # [M]
    q: Tensor,  # [B,4]
    t: Tensor,  # [B,3]
    params: Tensor,  # [B,12]
    width: int,
    height: int,
    model_id: int,
    opts: ProjOptions,
    block: int | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """For each feature pixel of each view, the nearest lidar point whose
    splat covers it (ImageMapProj z-buffer semantics, pcd_projection.cc:
    315-462). Points project through the image's full camera model, cover a
    rectangle of +-scale pixels in the depth_image_scale grid, must lie at
    depth z in [min_lidar_proj_dist, choose_meter], and the covering point
    nearest the camera center wins (ties: lowest map index).

    Returns (lidar_pt [B,F,3], lidar_nrm [B,F,3], found [B,F] bool).
    """
    return _depth_project(feat_xy, feat_valid, map_pts, map_nrm, map_valid, q, t, params,
                          width, height, model_id, opts, block)


def depth_project_batch(
    feat_xy: Tensor,  # [B,F,2]
    feat_valid: Tensor,  # [B,F]
    cand_pts: Tensor,  # [B,M,3] each view's own candidate set, padded to M
    cand_nrm: Tensor,  # [B,M,3]
    cand_valid: Tensor,  # [B,M]
    q: Tensor,  # [B,4]
    t: Tensor,  # [B,3]
    params: Tensor,  # [B,12]
    width: int,
    height: int,
    model_id: int,
    opts: ProjOptions,
    block: int | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """depth_project of each view over its own candidate set (e.g. the map
    points in its frustum, `points_in_frustum`), batched over the views as
    depth_project_shared is: one pass over the candidate blocks for all B.
    Returns (lidar_pt [B,F,3], lidar_nrm [B,F,3], found [B,F] bool)."""
    return _depth_project(feat_xy, feat_valid, cand_pts, cand_nrm, cand_valid, q, t, params,
                          width, height, model_id, opts, block)


def depth_project(
    feat_xy: Tensor,  # [F,2]
    feat_valid: Tensor,  # [F]
    cand_pts: Tensor,  # [M,3]
    cand_nrm: Tensor,  # [M,3]
    cand_valid: Tensor,  # [M]
    q: Tensor,  # [4]
    t: Tensor,  # [3]
    params: Tensor,  # [12]
    width: int,
    height: int,
    model_id: int,
    opts: ProjOptions,
    block: int | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """depth_project_shared for one view: (lidar_pt [F,3], lidar_nrm [F,3],
    found [F])."""
    lpt, lnr, found = depth_project_shared(
        feat_xy[None], feat_valid[None], cand_pts, cand_nrm, cand_valid,
        q[None], t[None], params[None], width, height, model_id, opts, block,
    )
    return lpt[0], lnr[0], found[0]


def nn_query(queries: Tensor, map_pts: Tensor, map_valid: Tensor) -> tuple[Tensor, Tensor]:
    """Exact 1-NN among the valid map points: (nn_idx [Q] into map_pts,
    nn_dist [Q]). Plain PyTorch (the blocked brute force of
    ops/nn_kernel.nn_argmin_reference over the valid rows)."""
    from .nn_kernel import nn_argmin_reference

    rows = torch.nonzero(map_valid > 0)[:, 0]
    idx, dist = nn_argmin_reference(queries, map_pts[rows].contiguous())
    return rows[idx.long()], dist


def ray_plane_points(
    feat_xy: Tensor,  # [F,2]
    planes: Tensor,  # [F,4] world-frame plane (a,b,c,d) per feature
    found: Tensor,  # [F] bool
    q: Tensor,
    t: Tensor,
    params: Tensor,
    model_id: int,
) -> tuple[Tensor, Tensor]:
    """World 3D points: the camera ray through each feature intersected with
    its plane, X = C + s*dir with s = -(n.C + d)/(n.dir), solved in the world
    frame so any seed pose works. Returns (xyz [F,3], ok [F] bool); ok
    requires found, a non-grazing ray (|n.dir| > 1e-6) and positive depth."""
    center, direction = cm.unproject_ray(model_id, params, q, t, feat_xy)
    n = planes[:, :3]
    d = planes[:, 3]
    denom = torch.sum(n * direction, dim=-1)
    denom_safe = torch.where(torch.abs(denom) < 1e-6, torch.full_like(denom, 1e-6), denom)
    s = -(torch.sum(n * center, dim=-1) + d) / denom_safe
    X = center + s[:, None] * direction
    z = se3.se3_apply(q, t, X)[..., 2]
    ok = found & (torch.abs(denom) > 1e-6) & (s > 0) & (z > 0)
    return X, ok


def classify_ground(normals: Tensor, ratio: float = 10.0) -> Tensor:
    """Ground test: |ny/nx| > ratio and |ny/nz| > ratio (y is vertical in the
    converted camera-world frame; incremental_mapper.cc:1447-1459)."""
    nx = torch.abs(normals[..., 0])
    ny = torch.abs(normals[..., 1])
    nz = torch.abs(normals[..., 2])
    return (ny > ratio * nx) & (ny > ratio * nz)


def plane_through(points: Tensor, normals: Tensor) -> Tensor:
    """Plane (a,b,c,d) with unit normal through each point (LidarPoint::Normalize,
    lidar_point.cc:39-50)."""
    n = normals / torch.clamp(torch.linalg.norm(normals, dim=-1, keepdim=True), min=1e-12)
    d = -torch.sum(points * n, dim=-1, keepdim=True)
    return torch.cat([n, d], dim=-1)
