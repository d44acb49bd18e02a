"""The benchmark's synthetic corridor: trajectory, lidar map and views.

A frozen copy of the pixel world that the port's records were taken on
(the trajectory of the bench's corridor, its 5 cm map of two walls and a
ground plane, and the ray-cast corridor renderer), kept here so that no
later change to the program can move the yardstick. The renderer is
rewritten in PyTorch so that a run renders its views on the card in its
set-up; on the CPU it gives the same views, which is how the test suite
holds it to the original.

Camera convention (x right, y down, z forward); the map frame is the
camera convention's world: walls at x = -4 and x = +4, ground at y = 2.

A world is fixed by a seed and a job index: `world_key(seed, job)` gives
the offset of the three texture seeds; (seed 0, job 0) is the original
world, offset 0. Every world has the same trajectory and the same map, so
that every seed sets the same amount of work (the textures move the
keypoints, not the sizes). Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STEP = 0.8  # metres between views
MAP_MARGIN = 25.0  # metres of map beyond the last view, as the bench builds it
# the corridor's surfaces: (axis, value) of each plane and its extent test
WALL_X = 4.0
GROUND_Y = 2.0
# base texture seeds of the left wall, the right wall and the ground
# (int(1 + phase * 10) with phases 0 and 1.7; the ground's 7)
TEXTURE_SEEDS = (1, 18, 7)
_OCTAVES = (0.7, 1.6, 3.4, 7.9, 16.0)


def world_key(seed: int, job: int) -> int:
    """The texture seed offset of job `job` of a run at `seed`; 0 for
    (0, 0). Any whole seed (beyond 32 bits too)."""
    return (int(seed) * 2654435761 + int(job) * 40503) % 1048573


def quat_to_rotmat(q) -> np.ndarray:
    """Rotation matrix of a unit quaternion (w, x, y, z)."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def projection_center(q, t) -> np.ndarray:
    """Camera centre -R^T t of a world-to-camera pose."""
    return -quat_to_rotmat(q).T @ np.asarray(t, np.float64)


def trajectory(n_views: int, step: float = STEP) -> list:
    """World-to-camera (q, t) of each view: forward along z at `step`,
    swaying 0.5 m sideways, 0.25 m up and down and yawing by up to 0.03 rad."""
    poses = []
    for i in range(n_views):
        c = np.asarray([0.5 * np.sin(i * 0.6), 0.25 * np.cos(i * 0.4), i * step])
        yaw = 0.03 * np.sin(i * 0.9)
        q_cw = np.asarray([np.cos(yaw / 2), 0.0, -np.sin(yaw / 2), 0.0])
        poses.append((q_cw, -quat_to_rotmat(q_cw) @ c))
    return poses


def build_corridor_map(length: float, spacing: float = 0.05) -> tuple[np.ndarray, np.ndarray]:
    """Map-frame points and normals, float32 [N,3] each: both walls from y
    -2 to 2 and the ground from x -4 to 4, over z in [0, length)."""
    zs = np.arange(0.0, length, spacing)
    ys = np.arange(-2.0, 2.0, spacing)
    Z, Y = np.meshgrid(zs, ys)
    wall_l = np.stack([np.full(Z.size, -WALL_X), Y.ravel(), Z.ravel()], -1)
    wall_r = np.stack([np.full(Z.size, WALL_X), Y.ravel(), Z.ravel()], -1)
    nl = np.tile([1.0, 0, 0], (wall_l.shape[0], 1))
    nr = np.tile([-1.0, 0, 0], (wall_r.shape[0], 1))
    xs = np.arange(-WALL_X, WALL_X, spacing * 2)
    X, Z2 = np.meshgrid(xs, zs)
    ground = np.stack([X.ravel(), np.full(X.size, GROUND_Y), Z2.ravel()], -1)
    ng = np.tile([0.0, -1.0, 0], (ground.shape[0], 1))
    pts = np.concatenate([wall_l, wall_r, ground]).astype(np.float32)
    nrm = np.concatenate([nl, nr, ng]).astype(np.float32)
    return pts, nrm


def _hash01(ix: torch.Tensor, iy: torch.Tensor, seed: int) -> torch.Tensor:
    """Non-periodic lattice noise in [0, 1) from integer coordinates (int64)."""
    h = (ix * 374761393 + iy * 668265263 + seed * 40503) & 0x7FFFFFFF
    h = (h ^ (h >> 13)) * 1274126177 & 0x7FFFFFFF
    return ((h ^ (h >> 16)) % 100003).to(torch.float64) / 100003.0


def _value_noise(u: torch.Tensor, v: torch.Tensor, scale: float, seed: int) -> torch.Tensor:
    x = u * scale
    y = v * scale
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    fx = fx * fx * (3 - 2 * fx)
    fy = fy * fy * (3 - 2 * fy)
    ix, iy = x0.to(torch.int64), y0.to(torch.int64)
    v00 = _hash01(ix, iy, seed)
    v01 = _hash01(ix, iy + 1, seed)
    v10 = _hash01(ix + 1, iy, seed)
    v11 = _hash01(ix + 1, iy + 1, seed)
    return v00 * (1 - fx) * (1 - fy) + v10 * fx * (1 - fy) + v01 * (1 - fx) * fy + v11 * fx * fy


def _texture(u: torch.Tensor, v: torch.Tensor, seed: int) -> torch.Tensor:
    out = 0.15
    amp = 0.45
    for o, scale in enumerate(_OCTAVES):
        out = out + amp * _value_noise(u, v, scale, seed + o * 977)
        amp *= 0.55
    return out


def render_view(q_cw, t_cw, width: int, height: int, focal: float, texture_offset: int = 0,
                device="cpu", texture=_texture) -> torch.Tensor:
    """One view, float32 [H,W] in [0,1] on `device`: each pixel's ray (pixel
    (x, y) at ((x - W/2)/f, (y - H/2)/f, 1)) cast against the walls and the
    ground, which carry the value-noise `texture(u, v, seed)`; 0.08 where it
    hits nothing."""
    f64 = dict(dtype=torch.float64, device=device)
    yy, xx = torch.meshgrid(torch.arange(height, **f64), torch.arange(width, **f64), indexing="ij")
    dirs_cam = torch.stack([(xx - width / 2) / focal, (yy - height / 2) / focal, torch.ones_like(xx)], -1)
    R_wc = torch.as_tensor(quat_to_rotmat(q_cw).T, **f64)
    C = torch.as_tensor(projection_center(q_cw, t_cw), **f64)
    d = dirs_cam @ R_wc.T  # world-frame ray directions [H,W,3]
    img = torch.full((height, width), 0.08, **f64)
    best_t = torch.full((height, width), math.inf, **f64)
    seeds = [s + texture_offset for s in TEXTURE_SEEDS]
    planes = (
        (0, -WALL_X, lambda p: texture(p[..., 1], p[..., 2], seeds[0])),
        (0, WALL_X, lambda p: texture(p[..., 1], p[..., 2], seeds[1])),
        (1, GROUND_Y, lambda p: texture(p[..., 0], p[..., 2], seeds[2])),
    )
    for axis, value, tex in planes:
        denom = d[..., axis]
        hit = denom.abs() > 1e-9
        safe = torch.where(hit, denom, torch.full_like(denom, 1e-9))
        t = torch.where(hit, (value - C[axis]) / safe, torch.full_like(denom, math.inf))
        pt = C + torch.where(torch.isfinite(t), t, torch.zeros_like(t))[..., None] * d
        ok = (t > 0.05) & (t < best_t) & (pt[..., 2] > -1.0) & (pt[..., 2] < 500.0)
        if axis == 0:  # walls: inside the corridor vertically
            ok &= (pt[..., 1] > -2.5) & (pt[..., 1] < 2.05)
        else:  # ground: inside the corridor horizontally
            ok &= (pt[..., 0] > -4.05) & (pt[..., 0] < 4.05)
        val = tex(torch.where(ok[..., None], pt, torch.zeros_like(pt)))
        img = torch.where(ok, val, img)
        best_t = torch.where(ok, t, best_t)
    return img.clamp(0.0, 1.0).to(torch.float32)


def render_u8(poses, width: int, height: int, focal: float, texture_offset: int = 0,
              device="cpu", texture=_texture) -> np.ndarray:
    """Every view of `poses` as uint8 grayscale [n,H,W] (x 255, truncated),
    rendered on `device` and fetched once."""
    views = torch.stack([
        (render_view(q, t, width, height, focal, texture_offset, device, texture) * 255).to(torch.uint8)
        for q, t in poses
    ])
    return views.cpu().numpy()
