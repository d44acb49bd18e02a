"""Quaternion / SO(3) / SE(3) operations on batched tensors.

Port of colmap_pcd_tpu/ops/se3.py with the same conventions, so model files
and both packages interoperate:
  - quaternions are (w, x, y, z), normalized, scalar-first;
  - a pose (q, t) maps world points to camera points: x_cam = R(q) x_world + t;
  - every function broadcasts over leading batch dims and has no
    data-dependent control flow (torch.func transforms apply).

The se3 tangent used by the bundle adjuster: delta = (omega, upsilon) with
retraction q' = exp_quat(omega) * q, t' = exp_rot(omega) t + upsilon.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def quat_normalize(q: Tensor) -> Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product a*b, scalar-first."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: Tensor) -> Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_rotmat(q: Tensor) -> Tensor:
    """(..., 4) -> (..., 3, 3)."""
    w, x, y, z = quat_normalize(q).unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def rotmat_to_quat(R: Tensor) -> Tensor:
    """(..., 3, 3) -> (..., 4), scalar-first, w >= 0.

    Branch-free Shepperd's method: all four candidate quaternions, keeping
    the one seeded from the largest diagonal combination.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    t0 = 1 + m00 + m11 + m22  # = 4w^2
    t1 = 1 + m00 - m11 - m22  # = 4x^2
    t2 = 1 - m00 + m11 - m22  # = 4y^2
    t3 = 1 - m00 - m11 + m22  # = 4z^2
    cand = torch.stack(
        [
            torch.stack([t0, m21 - m12, m02 - m20, m10 - m01], -1),
            torch.stack([m21 - m12, t1, m01 + m10, m02 + m20], -1),
            torch.stack([m02 - m20, m01 + m10, t2, m12 + m21], -1),
            torch.stack([m10 - m01, m02 + m20, m12 + m21, t3], -1),
        ],
        dim=-2,
    )
    best = torch.argmax(torch.stack([t0, t1, t2, t3], -1), dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = quat_normalize(torch.gather(cand, -2, idx)[..., 0, :])
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def so3_exp_quat(omega: Tensor) -> Tensor:
    """Axis-angle (..., 3) -> unit quaternion (..., 4). Taylor-safe near 0."""
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    half = 0.5 * theta
    small = theta2 < 1e-12
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    s = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    return torch.cat([w, s * omega], dim=-1)


def so3_log(q: Tensor) -> Tensor:
    """Unit quaternion (..., 4) -> axis-angle (..., 3). Taylor-safe near identity."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vn2 = torch.sum(v * v, dim=-1, keepdim=True)
    vn = torch.sqrt(torch.clamp(vn2, min=1e-24))
    theta = 2.0 * torch.atan2(vn, w)
    small = vn2 < 1e-12
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-6), theta / vn)
    return scale * v


def se3_apply(q: Tensor, t: Tensor, x: Tensor) -> Tensor:
    """x_cam = R(q) x + t, broadcasting over leading dims."""
    return quat_rotate(q, x) + t


def se3_inverse(q: Tensor, t: Tensor) -> tuple[Tensor, Tensor]:
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def se3_compose(q1: Tensor, t1: Tensor, q2: Tensor, t2: Tensor) -> tuple[Tensor, Tensor]:
    """(q1,t1) ∘ (q2,t2): first apply 2, then 1."""
    return quat_mul(q1, q2), quat_rotate(q1, t2) + t1


def se3_retract(q: Tensor, t: Tensor, delta: Tensor) -> tuple[Tensor, Tensor]:
    """Left-multiplicative retraction with tangent delta (..., 6) = (omega, upsilon)."""
    omega, ups = delta[..., :3], delta[..., 3:]
    dq = so3_exp_quat(omega)
    return quat_normalize(quat_mul(dq, q)), quat_rotate(dq, t) + ups


def projection_center(q: Tensor, t: Tensor) -> Tensor:
    """Camera center in world coordinates: C = -R^T t."""
    return -quat_rotate(quat_conj(q), t)


def euler_zyx_to_quat(roll: Tensor, pitch: Tensor, yaw: Tensor) -> Tensor:
    """Intrinsic z-y-x (yaw-pitch-roll) Euler angles -> quaternion (the
    reference's pose-prior convention)."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        dim=-1,
    )


def quat_to_euler_zyx(q: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Quaternion -> (roll, pitch, yaw), inverse of euler_zyx_to_quat."""
    w, x, y, z = quat_normalize(q).unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def angle_between(q1: Tensor, q2: Tensor) -> Tensor:
    """Rotation angle (radians) between two unit quaternions."""
    d = torch.abs(torch.sum(q1 * q2, dim=-1))
    return 2.0 * torch.acos(torch.clamp(d, -1.0, 1.0))
