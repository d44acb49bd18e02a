"""Camera models: batched project / unproject for all 11 reference models.

Port of colmap_pcd_tpu/ops/camera_models.py. Param layouts and model ids
match COLMAP exactly so databases and model files interoperate:

  id  name                    params
  0   SIMPLE_PINHOLE          f, cx, cy
  1   PINHOLE                 fx, fy, cx, cy
  2   SIMPLE_RADIAL           f, cx, cy, k
  3   RADIAL                  f, cx, cy, k1, k2
  4   OPENCV                  fx, fy, cx, cy, k1, k2, p1, p2
  5   OPENCV_FISHEYE          fx, fy, cx, cy, k1, k2, k3, k4
  6   FULL_OPENCV             fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, k5, k6
  7   FOV                     fx, fy, cx, cy, omega
  8   SIMPLE_RADIAL_FISHEYE   f, cx, cy, k
  9   RADIAL_FISHEYE          f, cx, cy, k1, k2
  10  THIN_PRISM_FISHEYE      fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, sx1, sy1

Functions take `params` padded to MAX_PARAMS=12 and work on normalized camera
coordinates (u, v) = (x/z, y/z). `image_to_world` undistorts with a
fixed-iteration Gauss-Newton whose 2x2 Jacobians come from forward-mode
`torch.func.jvp` (the reference's IterativeUndistortion,
camera_models.h:950-1000). `model_id` is a Python int.
"""

from __future__ import annotations

import torch

from . import se3

Tensor = torch.Tensor

MAX_PARAMS = 12

MODEL_NAMES = [
    "SIMPLE_PINHOLE", "PINHOLE", "SIMPLE_RADIAL", "RADIAL", "OPENCV",
    "OPENCV_FISHEYE", "FULL_OPENCV", "FOV", "SIMPLE_RADIAL_FISHEYE",
    "RADIAL_FISHEYE", "THIN_PRISM_FISHEYE",
]
MODEL_IDS = {n: i for i, n in enumerate(MODEL_NAMES)}
NUM_PARAMS = [3, 4, 3 + 1, 3 + 2, 4 + 4, 4 + 4, 4 + 8, 4 + 1, 3 + 1, 3 + 2, 4 + 8]

# Index of (fx, fy, cx, cy) within each model's param vector; fy index equals fx
# index for single-focal models.
_FOCAL_IDX = {
    0: (0, 0, 1, 2), 1: (0, 1, 2, 3), 2: (0, 0, 1, 2), 3: (0, 0, 1, 2),
    4: (0, 1, 2, 3), 5: (0, 1, 2, 3), 6: (0, 1, 2, 3), 7: (0, 1, 2, 3),
    8: (0, 0, 1, 2), 9: (0, 0, 1, 2), 10: (0, 1, 2, 3),
}

_FISHEYE_MODELS = frozenset([5, 8, 9, 10])


def pad_params(params, model_id: int, device=None) -> Tensor:
    """Pad a raw param list/array to MAX_PARAMS (float32)."""
    p = torch.as_tensor(params, dtype=torch.float32, device=device)
    n = NUM_PARAMS[model_id]
    if p.shape[-1] != n:
        raise ValueError(f"model {MODEL_NAMES[model_id]} expects {n} params, got {p.shape[-1]}")
    return torch.nn.functional.pad(p, (0, MAX_PARAMS - n))


def focal_pp(params: Tensor, model_id: int) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    fi, fj, ci, cj = _FOCAL_IDX[model_id]
    return params[..., fi], params[..., fj], params[..., ci], params[..., cj]


def _fisheye_forward(u: Tensor, v: Tensor) -> tuple[Tensor, Tensor]:
    """Equidistant fisheye map (u,v) -> (theta/r * u, theta/r * v)."""
    r = torch.sqrt(u * u + v * v)
    theta = torch.atan(r)
    scale = torch.where(r > 1e-8, theta / torch.clamp(r, min=1e-8), torch.ones_like(r))
    return u * scale, v * scale


def _distort(model_id: int, p: Tensor, u: Tensor, v: Tensor) -> tuple[Tensor, Tensor]:
    """Model-specific distortion deltas (du, dv) on normalized coords; for
    fisheye models the equidistant map is included."""
    if model_id in (0, 1):  # pinhole family: no distortion
        return torch.zeros_like(u), torch.zeros_like(v)

    if model_id in _FISHEYE_MODELS:
        uf, vf = _fisheye_forward(u, v)
    else:
        uf, vf = u, v
    r2 = uf * uf + vf * vf

    if model_id in (2, 8):  # SIMPLE_RADIAL(_FISHEYE): k
        radial = p[..., 3] * r2
        du, dv = uf * radial, vf * radial
    elif model_id in (3, 9):  # RADIAL(_FISHEYE): k1, k2
        k1, k2 = p[..., 3], p[..., 4]
        radial = k1 * r2 + k2 * r2 * r2
        du, dv = uf * radial, vf * radial
    elif model_id == 4:  # OPENCV: k1, k2, p1, p2
        k1, k2, p1, p2 = p[..., 4], p[..., 5], p[..., 6], p[..., 7]
        uv = uf * vf
        radial = k1 * r2 + k2 * r2 * r2
        du = uf * radial + 2 * p1 * uv + p2 * (r2 + 2 * uf * uf)
        dv = vf * radial + 2 * p2 * uv + p1 * (r2 + 2 * vf * vf)
    elif model_id == 5:  # OPENCV_FISHEYE: theta polynomial on equidistant coords
        k1, k2, k3, k4 = p[..., 4], p[..., 5], p[..., 6], p[..., 7]
        theta2 = r2
        radial = k1 * theta2 + k2 * theta2**2 + k3 * theta2**3 + k4 * theta2**4
        du, dv = uf * radial, vf * radial
    elif model_id == 6:  # FULL_OPENCV
        k1, k2, p1, p2 = p[..., 4], p[..., 5], p[..., 6], p[..., 7]
        k3, k4, k5, k6 = p[..., 8], p[..., 9], p[..., 10], p[..., 11]
        uv = uf * vf
        r4, r6 = r2 * r2, r2 * r2 * r2
        num = 1 + k1 * r2 + k2 * r4 + k3 * r6
        den = 1 + k4 * r2 + k5 * r4 + k6 * r6
        radial = num / den - 1.0
        du = uf * radial + 2 * p1 * uv + p2 * (r2 + 2 * uf * uf)
        dv = vf * radial + 2 * p2 * uv + p1 * (r2 + 2 * vf * vf)
    elif model_id == 7:  # FOV: omega (Devernay & Faugeras)
        omega = p[..., 4]
        r = torch.sqrt(torch.clamp(r2, min=1e-16))
        tiny = torch.abs(omega) < 1e-6
        omega_safe = torch.where(tiny, torch.full_like(omega, 1e-6), omega)
        # As omega -> 0: factor = atan(2r tan(w/2))/(r w) -> 1 - (r w)^2 / 3.
        factor = torch.where(
            tiny,
            -(r2 * omega * omega) / 3.0,
            torch.atan(2.0 * r * torch.tan(omega_safe * 0.5))
            / torch.clamp(r * omega_safe, min=1e-12) - 1.0,
        )
        du, dv = uf * factor, vf * factor
    elif model_id == 10:  # THIN_PRISM_FISHEYE
        k1, k2, p1, p2 = p[..., 4], p[..., 5], p[..., 6], p[..., 7]
        k3, k4, sx1, sy1 = p[..., 8], p[..., 9], p[..., 10], p[..., 11]
        uv = uf * vf
        r4, r6, r8 = r2 * r2, r2**3, r2**4
        radial = k1 * r2 + k2 * r4 + k3 * r6 + k4 * r8
        du = uf * radial + 2 * p1 * uv + p2 * (r2 + 2 * uf * uf) + sx1 * r2
        dv = vf * radial + 2 * p2 * uv + p1 * (r2 + 2 * vf * vf) + sy1 * r2
    else:
        raise ValueError(f"unknown camera model id {model_id}")

    return uf + du - u, vf + dv - v


def distorted_normalized(model_id: int, params: Tensor, uv: Tensor) -> Tensor:
    """Apply the full distortion map on normalized coords (..., 2) -> (..., 2)."""
    u, v = uv[..., 0], uv[..., 1]
    du, dv = _distort(model_id, params, u, v)
    return torch.stack([u + du, v + dv], dim=-1)


def world_to_image(model_id: int, params: Tensor, uv: Tensor) -> Tensor:
    """Normalized camera coords (..., 2) -> pixel coords (..., 2)."""
    fx, fy, cx, cy = focal_pp(params, model_id)
    d = distorted_normalized(model_id, params, uv)
    return torch.stack([fx * d[..., 0] + cx, fy * d[..., 1] + cy], dim=-1)


def image_to_world(model_id: int, params: Tensor, xy: Tensor, num_iters: int = 20) -> Tensor:
    """Pixel coords (..., 2) -> normalized camera coords (..., 2).

    Fixed-iteration Gauss-Newton undistortion; exact at iteration 0 for the
    pinhole models.
    """
    fx, fy, cx, cy = focal_pp(params, model_id)
    target = torch.stack([(xy[..., 0] - cx) / fx, (xy[..., 1] - cy) / fy], dim=-1)
    if model_id in (0, 1):
        return target

    def fwd(uv):
        return distorted_normalized(model_id, params, uv)

    uv = target
    e1 = torch.zeros_like(uv)
    e1[..., 0] = 1.0
    e2 = torch.zeros_like(uv)
    e2[..., 1] = 1.0
    for _ in range(num_iters):
        # per-point 2x2 Jacobian from forward-mode derivatives along the
        # two basis directions; solve J d = (target - f)
        f, j1 = torch.func.jvp(fwd, (uv,), (e1,))
        _, j2 = torch.func.jvp(fwd, (uv,), (e2,))
        r = target - f
        a, b = j1[..., 0], j2[..., 0]
        c, d = j1[..., 1], j2[..., 1]
        det = a * d - b * c
        det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
        dx = (d * r[..., 0] - b * r[..., 1]) / det
        dy = (-c * r[..., 0] + a * r[..., 1]) / det
        uv = uv + torch.stack([dx, dy], dim=-1)
    return uv


def project(model_id: int, params: Tensor, q: Tensor, t: Tensor, X: Tensor) -> tuple[Tensor, Tensor]:
    """Full world-point -> pixel chain. Returns (xy_pixel, depth); points
    behind the camera yield negative depth (callers mask on depth > 0)."""
    xc = se3.se3_apply(q, t, X)
    z = xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    uv = xc[..., :2] / zs[..., None]
    return world_to_image(model_id, params, uv), z


def unproject_ray(model_id: int, params: Tensor, q: Tensor, t: Tensor, xy: Tensor) -> tuple[Tensor, Tensor]:
    """Pixel -> (camera_center, unit world ray direction)."""
    uv = image_to_world(model_id, params, xy)
    d_cam = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    qi, _ = se3.se3_inverse(q, t)
    center = se3.projection_center(q, t)
    d_world = se3.quat_rotate(qi, d_cam)
    return center, d_world
