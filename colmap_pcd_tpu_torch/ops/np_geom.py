"""Numpy mirrors of the small geometry ops for HOST-SIDE bookkeeping.

The device modules (ops/se3.py, ops/camera_models.py) are batched PyTorch
for the device compute path. Host-side scene bookkeeping (reconstruction
filtering, triangulator gating, mapper bookkeeping) calls the same math on a
handful of elements at a time — running those on the GPU costs a launch and
a copy per call. These numpy twins keep the host loop on the host.

A copy of colmap_pcd_tpu/ops/np_geom.py (cross-checked there in
tests/test_np_geom.py); it reads only the camera-model tables.
"""

from __future__ import annotations

import numpy as np

from . import camera_models as cm

# --------------------------------------------------------------------- quats


def quat_normalize(q):
    q = np.asarray(q, np.float64)
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-30)


def quat_conj(q):
    return np.asarray(q) * np.asarray([1.0, -1.0, -1.0, -1.0])


def quat_mul(a, b):
    aw, ax, ay, az = np.moveaxis(np.asarray(a, np.float64), -1, 0)
    bw, bx, by, bz = np.moveaxis(np.asarray(b, np.float64), -1, 0)
    return np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_rotate(q, v):
    q = np.asarray(q, np.float64)
    v = np.asarray(v, np.float64)
    w = q[..., :1]
    u = q[..., 1:]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def quat_to_rotmat(q):
    w, x, y, z = np.moveaxis(quat_normalize(q), -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = np.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def rotmat_to_quat(R):
    R = np.asarray(R, np.float64)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    t0 = 1 + m00 + m11 + m22
    t1 = 1 + m00 - m11 - m22
    t2 = 1 - m00 + m11 - m22
    t3 = 1 - m00 - m11 + m22
    cand = np.stack(
        [
            np.stack([t0, m21 - m12, m02 - m20, m10 - m01], -1),
            np.stack([m21 - m12, t1, m01 + m10, m02 + m20], -1),
            np.stack([m02 - m20, m01 + m10, t2, m12 + m21], -1),
            np.stack([m10 - m01, m02 + m20, m12 + m21, t3], -1),
        ],
        axis=-2,
    )
    scores = np.stack([t0, t1, t2, t3], -1)
    best = np.argmax(scores, axis=-1)
    q = np.take_along_axis(cand, np.broadcast_to(best[..., None, None], best.shape + (1, 4)), axis=-2)[..., 0, :]
    q = quat_normalize(q)
    return q * np.where(q[..., :1] < 0, -1.0, 1.0)


def so3_exp_quat(w):
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w, axis=-1, keepdims=True)
    th_s = np.maximum(th, 1e-30)
    return np.concatenate([np.cos(th / 2), np.sin(th / 2) * w / th_s], axis=-1)


def projection_center(q, t):
    return -quat_rotate(quat_conj(q), np.asarray(t, np.float64))


def se3_apply(q, t, x):
    return quat_rotate(q, x) + np.asarray(t, np.float64)


def se3_inverse(q, t):
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, np.asarray(t, np.float64))


def se3_compose(q1, t1, q2, t2):
    return quat_mul(q1, q2), quat_rotate(q1, np.asarray(t2)) + np.asarray(t1)


def angle_between(q1, q2):
    d = np.abs(np.sum(quat_normalize(q1) * quat_normalize(q2), axis=-1))
    return 2.0 * np.arccos(np.clip(d, -1.0, 1.0))


def triangulation_angle(c1, c2, X):
    v1 = np.asarray(c1) - X
    v2 = np.asarray(c2) - X
    c = np.sum(v1 * v2, -1) / np.maximum(
        np.linalg.norm(v1, axis=-1) * np.linalg.norm(v2, axis=-1), 1e-12
    )
    return np.arccos(np.clip(c, -1.0, 1.0))


# ----------------------------------------------- lidar-frame pose convention
# The reference uses ONE convention at all three pose conversion sites (init
# flags, pose.ply load, pose.ply save): lidar frame is x-forward/y-left/z-up,
# camera(map) frame is x-right/y-down/z-forward, angles are radians, and
#   R_wc = Ry(-yaw) @ Rx(-pitch) @ Rz(roll),   t_wc(map) = (-y, -z, x)
# (controllers/incremental_mapper.cc:953-976 LoadPose,
#  ui/main_window.cc:1136-1160 SaveImagePoses,
#  sfm/incremental_mapper.cc:517-552 RegisterInitialImagePairByDepthProj).


def _rot_axis(axis: str, a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    if axis == "x":
        return np.asarray([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def lidar_pose_to_cam(x, y, z, roll, pitch, yaw):
    """(x,y,z,roll,pitch,yaw) in the lidar frame (radians) -> (q_cw, t_cw)."""
    R_wc = _rot_axis("y", -yaw) @ _rot_axis("x", -pitch) @ _rot_axis("z", roll)
    t_wc = np.asarray([-y, -z, x], np.float64)
    R_cw = R_wc.T
    t_cw = -R_cw @ t_wc
    return rotmat_to_quat(R_cw), t_cw


def cam_pose_to_lidar(qvec, tvec):
    """(q_cw, t_cw) -> (x,y,z,roll,pitch,yaw) in the lidar frame (radians).

    Canonical decomposition R_wc = Ry(a) Rx(b) Rz(c) with b in [-pi/2, pi/2];
    roll = c, pitch = -b, yaw = -a. Round-trips exactly through
    lidar_pose_to_cam, and reference-written files load identically (the
    reference's Eigen eulerAngles branch normalizes to an equivalent angle
    triple for the same rotation)."""
    R_cw = quat_to_rotmat(np.asarray(qvec, np.float64))
    R_wc = R_cw.T
    t_wc = -R_wc @ np.asarray(tvec, np.float64)
    b = np.arcsin(np.clip(-R_wc[1, 2], -1.0, 1.0))
    a = np.arctan2(R_wc[0, 2], R_wc[2, 2])
    c = np.arctan2(R_wc[1, 0], R_wc[1, 1])
    x, y, z = t_wc[2], -t_wc[0], -t_wc[1]
    return float(x), float(y), float(z), float(c), float(-b), float(-a)


# ------------------------------------------------------------- camera models


def _fisheye_forward(u, v):
    r = np.sqrt(u * u + v * v)
    theta = np.arctan(r)
    scale = np.where(r > 1e-8, theta / np.maximum(r, 1e-8), 1.0)
    return u * scale, v * scale


def _distort(model_id, p, u, v):
    """Numpy twin of camera_models._distort (kept in lockstep; see
    tests/test_np_geom.py cross-check)."""
    if model_id in (0, 1):
        return np.zeros_like(u), np.zeros_like(v)
    if model_id in cm._FISHEYE_MODELS:
        uf, vf = _fisheye_forward(u, v)
    else:
        uf, vf = u, v
    r2 = uf * uf + vf * vf
    if model_id in (2, 8):
        k = p[..., 3]
        radial = k * r2
        du, dv = uf * radial, vf * radial
    elif model_id in (3, 9):
        k1, k2 = p[..., 3], p[..., 4]
        radial = k1 * r2 + k2 * r2 * r2
        du, dv = uf * radial, vf * radial
    elif model_id == 4:
        k1, k2, p1, p2 = p[..., 4], p[..., 5], p[..., 6], p[..., 7]
        uv = uf * vf
        radial = k1 * r2 + k2 * r2 * r2
        du = uf * radial + 2 * p1 * uv + p2 * (r2 + 2 * uf * uf)
        dv = vf * radial + 2 * p2 * uv + p1 * (r2 + 2 * vf * vf)
    elif model_id == 5:
        k1, k2, k3, k4 = p[..., 4], p[..., 5], p[..., 6], p[..., 7]
        t2 = r2
        radial = k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4
        du, dv = uf * radial, vf * radial
    elif model_id == 6:
        k1, k2, p1, p2 = p[..., 4], p[..., 5], p[..., 6], p[..., 7]
        k3, k4, k5, k6 = p[..., 8], p[..., 9], p[..., 10], p[..., 11]
        uv = uf * vf
        r4, r6 = r2 * r2, r2**3
        radial = (1 + k1 * r2 + k2 * r4 + k3 * r6) / (1 + k4 * r2 + k5 * r4 + k6 * r6) - 1.0
        du = uf * radial + 2 * p1 * uv + p2 * (r2 + 2 * uf * uf)
        dv = vf * radial + 2 * p2 * uv + p1 * (r2 + 2 * vf * vf)
    elif model_id == 7:
        omega = p[..., 4]
        r = np.sqrt(np.maximum(r2, 1e-16))
        om = np.where(np.abs(omega) < 1e-6, 1e-6, omega)
        factor = np.where(
            np.abs(omega) < 1e-6,
            -(r2 * omega * omega) / 3.0,
            np.arctan(2.0 * r * np.tan(om * 0.5)) / np.maximum(r * om, 1e-12) - 1.0,
        )
        du, dv = uf * factor, vf * factor
    elif model_id == 10:
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


def distorted_normalized(model_id, params, uv):
    u, v = uv[..., 0], uv[..., 1]
    du, dv = _distort(model_id, np.asarray(params, np.float64), u, v)
    return np.stack([u + du, v + dv], axis=-1)


def world_to_image(model_id, params, uv):
    params = np.asarray(params, np.float64)
    fi, fj, ci, cj = cm._FOCAL_IDX[model_id]
    d = distorted_normalized(model_id, params, np.asarray(uv, np.float64))
    return np.stack(
        [params[..., fi] * d[..., 0] + params[..., ci], params[..., fj] * d[..., 1] + params[..., cj]],
        axis=-1,
    )


def image_to_world(model_id, params, xy, num_iters: int = 20):
    params = np.asarray(params, np.float64)
    fi, fj, ci, cj = cm._FOCAL_IDX[model_id]
    xy = np.asarray(xy, np.float64)
    target = np.stack(
        [(xy[..., 0] - params[..., ci]) / params[..., fi], (xy[..., 1] - params[..., cj]) / params[..., fj]],
        axis=-1,
    )
    if model_id in (0, 1):
        return target
    uv = target.copy()
    eps = 1e-7
    for _ in range(num_iters):
        f0 = distorted_normalized(model_id, params, uv)
        # numeric 2x2 Jacobian
        fu = distorted_normalized(model_id, params, uv + np.asarray([eps, 0.0]))
        fv = distorted_normalized(model_id, params, uv + np.asarray([0.0, eps]))
        j11 = (fu[..., 0] - f0[..., 0]) / eps
        j21 = (fu[..., 1] - f0[..., 1]) / eps
        j12 = (fv[..., 0] - f0[..., 0]) / eps
        j22 = (fv[..., 1] - f0[..., 1]) / eps
        r0 = target - f0
        det = j11 * j22 - j12 * j21
        det = np.where(np.abs(det) < 1e-12, 1e-12, det)
        du = (j22 * r0[..., 0] - j12 * r0[..., 1]) / det
        dv = (-j21 * r0[..., 0] + j11 * r0[..., 1]) / det
        uv = uv + np.stack([du, dv], axis=-1)
    return uv


def project(model_id, params, q, t, X):
    """(xy_pixel, depth) — numpy twin of camera_models.project."""
    xc = se3_apply(q, t, X)
    z = xc[..., 2]
    zs = np.where(np.abs(z) < 1e-8, 1e-8, z)
    uv = xc[..., :2] / zs[..., None]
    return world_to_image(model_id, params, uv), z


def plane_through(points, normals):
    points = np.asarray(points, np.float64)
    n = np.asarray(normals, np.float64)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    d = -np.sum(points * n, axis=-1, keepdims=True)
    return np.concatenate([n, d], axis=-1)


def classify_ground(normals, ratio: float = 10.0):
    n = np.asarray(normals)
    nx, ny, nz = np.abs(n[..., 0]), np.abs(n[..., 1]), np.abs(n[..., 2])
    return (ny > ratio * nx) & (ny > ratio * nz)


def frustum_planes(q, t, fx, fy, cx, cy, width, height, choose_meter):
    """Numpy twin of pointcloud.frustum_planes (host-side culling setup)."""
    qi = quat_conj(q)
    center = projection_center(q, t)
    x_min = -cx / fx
    x_max = (width - cx) / fx
    y_min = -cy / fy
    y_max = (height - cy) / fy
    D = choose_meter
    corners_cam = np.asarray(
        [
            [x_max * D, y_max * D, D],
            [x_max * D, y_min * D, D],
            [x_min * D, y_min * D, D],
            [x_min * D, y_max * D, D],
        ]
    )
    corners = quat_rotate(qi[None, :], corners_cam) + center[None, :]
    centroid = (center + np.sum(corners, axis=0)) / 5.0

    def oriented(p0, p1, p2):
        n = np.cross(p1 - p0, p2 - p0)
        n = n / max(np.linalg.norm(n), 1e-12)
        d = -np.dot(n, p0)
        flip = -1.0 if np.dot(n, centroid) + d > 0 else 1.0
        return np.concatenate([n * flip, [d * flip]])

    c1, c2, c3, c4 = corners
    return np.stack(
        [
            oriented(c1, c2, c3),
            oriented(center, c1, c2),
            oriented(center, c2, c3),
            oriented(center, c3, c4),
            oriented(center, c4, c1),
        ]
    )


def pad_params(params, model_id: int):
    """Numpy twin of camera_models.pad_params."""
    p = np.asarray(params, np.float32)
    assert p.shape[-1] == cm.NUM_PARAMS[model_id]
    pad = [(0, 0)] * (p.ndim - 1) + [(0, cm.MAX_PARAMS - p.shape[-1])]
    return np.pad(p, pad)
