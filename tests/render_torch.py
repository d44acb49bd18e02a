"""Analytic corridor renderer: SIFT-able synthetic images with exact geometry.

A copy of tests/render.py on the PyTorch port's `np_geom`, so that the
port's tests and smoke run render without importing JAX (as
tests/synthetic_torch.py stands beside tests/synthetic.py).

Renders the synthetic_torch.build_corridor_map world (walls at x=+-4, ground at
y=2) by per-pixel ray casting against the three planes and sampling
procedural textures — giving real parallax, depth discontinuities, and
feature-rich imagery so the FULL pipeline (pixels -> SIFT -> matching ->
lidar-constrained mapping) can run end to end with known ground truth.
"""

from __future__ import annotations

import numpy as np

from colmap_pcd_tpu_torch.ops import np_geom


def _hash01(ix, iy, seed):
    """Deterministic pseudo-random in [0,1) from integer lattice coords.
    NON-periodic — periodic (sinusoidal) textures alias under SIFT matching:
    wide-baseline matches lock onto the next period and pass epipolar
    verification (the classic repeated-structure failure)."""
    h = (ix.astype(np.int64) * 374761393 + iy.astype(np.int64) * 668265263 + np.int64(seed) * np.int64(40503)) & 0x7FFFFFFF
    h = (h ^ (h >> 13)) * 1274126177 & 0x7FFFFFFF
    return ((h ^ (h >> 16)) % 100003) / 100003.0


def _value_noise(u, v, scale, seed):
    """Bilinear value noise at one octave."""
    x = u * scale
    y = v * scale
    x0 = np.floor(x)
    y0 = np.floor(y)
    fx = x - x0
    fy = y - y0
    fx = fx * fx * (3 - 2 * fx)
    fy = fy * fy * (3 - 2 * fy)
    v00 = _hash01(x0, y0, seed)
    v01 = _hash01(x0, y0 + 1, seed)
    v10 = _hash01(x0 + 1, y0, seed)
    v11 = _hash01(x0 + 1, y0 + 1, seed)
    return (
        v00 * (1 - fx) * (1 - fy)
        + v10 * fx * (1 - fy)
        + v01 * (1 - fx) * fy
        + v11 * fx * fy
    )


def _tex(u, v, seed):
    out = 0.15
    amp = 0.45
    for o, scale in enumerate((0.7, 1.6, 3.4, 7.9, 16.0)):
        out = out + amp * _value_noise(u, v, scale, seed + o * 977)
        amp *= 0.55
    return out


def _tex_wall(y, z, phase=0.0):
    return _tex(y, z, int(1 + phase * 10))


def _tex_ground(x, z):
    return _tex(x, z, 7)


def render_corridor(q_cw, t_cw, width=640, height=480, focal=500.0,
                    model_id=None, params=None):
    """Render one view; returns float32 [H,W] in [0,1].

    With model_id/params given, renders through that camera model: each pixel
    ray passes through iterative undistortion (np_geom.image_to_world), so a
    world point projected by the SAME model lands back on its pixel — the
    setup the reference's lidar path assumes (pcd_projection.cc:561-594
    hardcodes OpenCV distortion)."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    if model_id is not None:
        xy = np.stack([xx.ravel(), yy.ravel()], -1)
        m = np_geom.image_to_world(model_id, np.asarray(params, np.float64), xy)
        dirs_cam = np.concatenate(
            [m, np.ones((m.shape[0], 1))], -1
        ).reshape(height, width, 3)
    else:
        dirs_cam = np.stack(
            [(xx - width / 2) / focal, (yy - height / 2) / focal, np.ones_like(xx)], -1
        )
    R_wc = np_geom.quat_to_rotmat(np_geom.quat_conj(q_cw))
    C = np_geom.projection_center(q_cw, t_cw)
    d = dirs_cam @ R_wc.T  # world-frame ray directions [H,W,3]

    img = np.full((height, width), 0.08)
    best_t = np.full((height, width), np.inf)

    def hit(plane_axis, plane_val, tex):
        nonlocal img, best_t
        denom = d[..., plane_axis]
        safe = np.where(np.abs(denom) > 1e-9, denom, 1e-9)
        t = np.where(np.abs(denom) > 1e-9, (plane_val - C[plane_axis]) / safe, np.inf)
        pt = C[None, None, :] + np.where(np.isfinite(t), t, 0.0)[..., None] * d
        ok = (t > 0.05) & (t < best_t) & (pt[..., 2] > -1.0) & (pt[..., 2] < 500.0)
        if plane_axis == 0:  # walls: inside the corridor vertically
            ok &= (pt[..., 1] > -2.5) & (pt[..., 1] < 2.05)
        else:  # ground: inside the corridor horizontally
            ok &= (pt[..., 0] > -4.05) & (pt[..., 0] < 4.05)
        val = tex(np.where(ok[..., None], pt, 0.0))  # keep inf rays out of the int cast
        img = np.where(ok, val, img)
        best_t = np.where(ok, t, best_t)

    hit(0, -4.0, lambda p: _tex_wall(p[..., 1], p[..., 2], 0.0))
    hit(0, 4.0, lambda p: _tex_wall(p[..., 1], p[..., 2], 1.7))
    hit(1, 2.0, lambda p: _tex_ground(p[..., 0], p[..., 2]))
    return np.clip(img, 0.0, 1.0).astype(np.float32)
