"""Coordinate-frame estimation: gravity, Manhattan world frame, plane/ENU
alignment.

Port of colmap_pcd_tpu/models/coordinate_frame.py (src/estimators/
coordinate_frame.{h,cc}): the numpy parts are carried unchanged and
`detect_line_segments` runs in PyTorch on a device.
  * EstimateGravityVectorFromImageOrientation (coordinate_frame.h:59) —
    consensus over the images' downward axes, vectorized.
  * EstimateManhattanWorldFrame (coordinate_frame.h:68) — per-image line
    detection + vanishing-point RANSAC. The reference detects lines with
    LSD (lib/LSD, base/line.cc); the region-growing LSD algorithm is
    inherently sequential, so here lines come from a dense Hough transform
    (Sobel edges -> top-K edge pixels -> [theta, rho] accumulator ->
    non-max-suppressed peaks -> endpoint extraction), which is data-parallel.
    Vanishing points use the batched-hypothesis RANSAC style of
    ops/ransac.py.
  * AlignToPrincipalPlane / AlignToENUPlane (coordinate_frame.h:73-83).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .. import device as device_mod
from ..ops import np_geom


@dataclass
class ManhattanWorldFrameEstimationOptions:
    """(coordinate_frame.h:42-56)."""

    max_image_size: int = 1024
    min_line_length: float = 3.0
    line_orientation_tolerance: float = 0.2
    max_line_vp_distance: float = 0.5
    max_axis_distance: float = 0.05


# ---------------------------------------------------------------------------
# consensus axis


def find_best_consensus_axis(axes: np.ndarray, max_distance: float) -> np.ndarray:
    """Best consensus direction among candidate unit axes
    (coordinate_frame.cc:94-141 FindBestConsensusAxis), vectorized: every
    axis is a hypothesis; inliers are axes within 1-cos distance."""
    axes = np.asarray(axes, np.float64)
    if axes.shape[0] == 0:
        return np.zeros(3)
    n = axes / np.maximum(np.linalg.norm(axes, axis=1, keepdims=True), 1e-12)
    dist = 1.0 - np.abs(n @ n.T)  # [N,N] cosine distances (axis = line, not ray)
    inl = dist <= max_distance
    counts = inl.sum(1)
    sums = (dist * inl).sum(1)
    # most inliers, ties broken by smaller inlier distance sum
    best = np.lexsort((sums, -counts))[0]
    if counts[best] == 0:
        return np.zeros(3)
    sel = n[inl[best]]
    # average with sign alignment to the winning hypothesis
    sgn = np.sign(sel @ n[best])
    axis = (sel * sgn[:, None]).mean(0)
    norm = np.linalg.norm(axis)
    return axis / norm if norm > 1e-12 else np.zeros(3)


def estimate_gravity_vector_from_image_orientation(
    rec, max_axis_distance: float = 0.05
) -> np.ndarray:
    """(coordinate_frame.cc:145-155): consensus over R.row(1) (the world
    direction of each camera's downward axis)."""
    axes = []
    for iid in rec.registered_ids:
        R = np_geom.quat_to_rotmat(rec.images[iid].qvec)
        axes.append(R[1])
    return find_best_consensus_axis(np.asarray(axes), max_axis_distance)


# ---------------------------------------------------------------------------
# line detection (Hough re-design of lib/LSD)


def _top_k(x: torch.Tensor, k: int):
    """The k largest of x [N], highest first and, among equal values, the
    lowest indices first: the set and the order `jax.lax.top_k` returns
    (a flat image region gives many equal edge magnitudes, and weak Hough
    peaks many equal votes)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def detect_line_segments(
    img: np.ndarray,
    min_length: float = 3.0,
    num_thetas: int = 180,
    max_peaks: int = 64,
    max_edge_pixels: int = 8192,
    device=None,
):
    """Detect line segments in a grayscale float image [H,W] on `device`
    (None: CUDA).

    Returns (segments [L,4] as (x1,y1,x2,y2), count). Dense Hough transform:
    the accumulator over (theta, rho) counts the top edge pixels' votes,
    peaks are 3x3 non-max suppressed, and each peak's endpoints come from the
    extent of its supporting edge pixels along the line."""
    dev = device_mod.resolve(device)
    H, W = img.shape
    x = F.pad(torch.as_tensor(np.asarray(img, np.float32), device=dev), (1, 1, 1, 1))
    # the Sobel pair as cross-correlations with zero padding ("SAME")
    gx = (x[:-2, 2:] - x[:-2, :-2]) + 2.0 * (x[1:-1, 2:] - x[1:-1, :-2]) + (x[2:, 2:] - x[2:, :-2])
    gy = (x[2:, :-2] - x[:-2, :-2]) + 2.0 * (x[2:, 1:-1] - x[:-2, 1:-1]) + (x[2:, 2:] - x[:-2, 2:])
    mag = torch.sqrt(gx * gx + gy * gy)

    K = min(max_edge_pixels, H * W)
    val, idx = _top_k(mag.reshape(-1), K)
    w_k = (val > 0.1 * val[0]).to(torch.float32)
    ys = torch.div(idx, W, rounding_mode="floor").to(torch.float32)
    xs = (idx % W).to(torch.float32)

    # jnp.linspace(0, pi, T, endpoint=False) as JAX forms it: pi * (i / T)
    thetas = np.float32(np.pi) * (torch.arange(num_thetas, dtype=torch.float32, device=dev) / num_thetas)
    diag = float(np.hypot(H, W))
    R = int(2 * diag) + 1
    rho = xs[:, None] * torch.cos(thetas)[None, :] + ys[:, None] * torch.sin(thetas)[None, :]
    rbin = torch.clamp(torch.round(rho + diag).to(torch.int64), 0, R - 1)  # [K,T]
    # votes are whole numbers, so the accumulator is exact in any order
    flat = (torch.arange(num_thetas, device=dev)[None, :] * R + rbin).reshape(-1)
    acc = torch.zeros(num_thetas * R, device=dev).index_add_(
        0, flat, w_k[:, None].expand(-1, num_thetas).reshape(-1)
    ).view(num_thetas, R)
    # 3x3 non-max suppression
    mx = F.max_pool2d(acc[None, None], 3, stride=1, padding=1)[0, 0]
    peaks = torch.where((acc >= mx) & (acc >= 2.0), acc, torch.zeros_like(acc))
    pv, pidx = _top_k(peaks.reshape(-1), max_peaks)
    th = thetas[torch.div(pidx, R, rounding_mode="floor")]
    rr = (pidx % R).to(torch.float32) - diag
    ct, st = torch.cos(th), torch.sin(th)
    # distance of every edge pixel to each peak line; support within 1.5 px
    d = torch.abs(xs[None, :] * ct[:, None] + ys[None, :] * st[:, None] - rr[:, None])
    sup = (d <= 1.5) & (w_k[None, :] > 0)
    # project supporters on the line direction (-sin, cos)
    tproj = -xs[None, :] * st[:, None] + ys[None, :] * ct[:, None]
    tmin = torch.where(sup, tproj, torch.full_like(tproj, torch.inf)).amin(dim=1)
    tmax = torch.where(sup, tproj, torch.full_like(tproj, -torch.inf)).amax(dim=1)
    nsup = sup.sum(dim=1)
    length = torch.where(nsup > 0, tmax - tmin, torch.zeros_like(tmax))
    ok = (pv > 0) & (length >= min_length) & (nsup >= max(min_length, 2))
    x0 = rr * ct
    y0 = rr * st
    segs = torch.stack([x0 - st * tmin, y0 + ct * tmin, x0 - st * tmax, y0 + ct * tmax], -1)
    segs, ok = segs.cpu().numpy(), ok.cpu().numpy()
    return segs[ok], int(ok.sum())


def classify_line_orientations(segs: np.ndarray, tolerance: float = 0.2):
    """HORIZONTAL(+1)/VERTICAL(-1)/UNDEFINED(0) per segment
    (base/line.h ClassifyLineSegmentOrientations semantics)."""
    d = segs[:, 2:] - segs[:, :2]
    ang = np.arctan2(d[:, 1], d[:, 0])  # [-pi, pi]
    ang = np.where(ang < 0, ang + np.pi, ang)  # line angle in [0, pi)
    horiz = np.minimum(ang, np.pi - ang) <= tolerance
    vert = np.abs(ang - np.pi / 2) <= tolerance
    return np.where(horiz, 1, np.where(vert, -1, 0))


def estimate_vanishing_point(
    segs: np.ndarray, max_error: float = 0.5, num_hypotheses: int = 512, seed: int = 0
):
    """RANSAC vanishing point from line segments (VanishingPointEstimator,
    coordinate_frame.cc:47-92): hypotheses are cross products of random line
    pairs; support = midpoint-weighted line-to-point distance."""
    L = segs.shape[0]
    if L < 2:
        return None, 0
    p1 = np.concatenate([segs[:, :2], np.ones((L, 1))], 1)
    p2 = np.concatenate([segs[:, 2:], np.ones((L, 1))], 1)
    lines = np.cross(p1, p2)
    mid = 0.5 * (p1 + p2)
    rng = np.random.default_rng(seed)
    i = rng.integers(0, L, num_hypotheses)
    j = rng.integers(0, L, num_hypotheses)
    vps = np.cross(lines[i], lines[j])  # [Hyp, 3]
    nrm = np.linalg.norm(vps, axis=1, keepdims=True)
    vps = vps / np.maximum(nrm, 1e-12)
    # line-vp distance normalized by segment midpoint scale (reference
    # normalizes the line by its midpoint-to-vp direction; we use the
    # perpendicular distance of the vp ray from each line)
    ln = lines / np.maximum(np.linalg.norm(lines[:, :2], axis=1, keepdims=True), 1e-12)
    wscale = np.maximum(np.abs(mid @ vps.T), 1e-6)  # [L, Hyp]
    err = np.abs(ln @ vps.T) / wscale * np.linalg.norm(mid[:, :2], axis=1, keepdims=True)
    inl = err <= max_error
    counts = inl.sum(0)
    best = int(np.argmax(counts))
    if counts[best] < 2 or abs(vps[best][2]) < 1e-12 and counts[best] < 2:
        return None, 0
    return vps[best], int(counts[best])


# ---------------------------------------------------------------------------
# Manhattan frame


def estimate_manhattan_world_frame(
    opts: ManhattanWorldFrameEstimationOptions, rec, image_path: str, device=None
) -> np.ndarray:
    """(coordinate_frame.cc:156-263): per registered image, detect lines on
    the (undistorted) image, estimate horizontal/vertical vanishing points,
    unproject them to world axes, and take consensus. Returns [3,3] with
    columns rightward/downward/forward (zero column = undetermined).
    Undistortion and line detection run on `device` (None: CUDA)."""
    import os

    from ..utils import image as image_utils
    from .undistortion import undistort_image, undistorted_camera

    rightward, downward = [], []
    for iid in rec.registered_ids:
        img_rec = rec.images[iid]
        cam = rec.cameras[img_rec.camera_id]
        path = os.path.join(image_path, img_rec.name)
        if not os.path.exists(path):
            continue
        img = image_utils.imread_gray(path)
        ucam = undistorted_camera(cam)
        if not np.allclose(ucam.params, cam.params):
            img = undistort_image(img, cam, ucam, device)
        scale = 1.0
        if max(img.shape) > opts.max_image_size:
            img, scale = image_utils.resize_max(img, opts.max_image_size)
        segs, n = detect_line_segments(img, opts.min_line_length, device=device)
        if n == 0:
            continue
        if scale != 1.0:
            segs = segs / scale
        orient = classify_line_orientations(segs, opts.line_orientation_tolerance)
        from ..ops.camera_models import _FOCAL_IDX

        fi, fj, ci, cj = _FOCAL_IDX[ucam.model_id]
        fx, fy = ucam.params[fi], ucam.params[fj]
        cx, cy = ucam.params[ci], ucam.params[cj]
        R_cw = np_geom.quat_to_rotmat(img_rec.qvec)
        R_wc = R_cw.T

        def vp_to_world_axis(vp):
            # vanishing point -> camera-ray direction -> world direction
            if abs(vp[2]) < 1e-9:
                d_cam = np.asarray([vp[0] / fx, vp[1] / fy, 0.0])
            else:
                u, v = vp[0] / vp[2], vp[1] / vp[2]
                d_cam = np.asarray([(u - cx) / fx, (v - cy) / fy, 1.0])
            n = np.linalg.norm(d_cam)
            return R_wc @ (d_cam / n) if n > 1e-12 else None

        hsegs = segs[orient == 1]
        vsegs = segs[orient == -1]
        vp_h, n_h = estimate_vanishing_point(hsegs, opts.max_line_vp_distance, seed=iid)
        vp_v, n_v = estimate_vanishing_point(vsegs, opts.max_line_vp_distance, seed=iid + 7)
        if vp_h is not None and n_h >= 2:
            a = vp_to_world_axis(vp_h)
            if a is not None:
                # sign: rightward = positive camera x
                cam_dir = R_cw @ a
                rightward.append(a if cam_dir[0] >= 0 else -a)
        if vp_v is not None and n_v >= 2:
            a = vp_to_world_axis(vp_v)
            if a is not None:
                cam_dir = R_cw @ a
                downward.append(a if cam_dir[1] >= 0 else -a)

    frame = np.zeros((3, 3))
    if rightward:
        frame[:, 0] = find_best_consensus_axis(np.asarray(rightward), opts.max_axis_distance)
    if downward:
        frame[:, 1] = find_best_consensus_axis(np.asarray(downward), opts.max_axis_distance)
    r, d = frame[:, 0], frame[:, 1]
    if np.linalg.norm(r) > 0 and np.linalg.norm(d) > 0:
        f = np.cross(r, d)
        f /= max(np.linalg.norm(f), 1e-12)
        frame[:, 2] = f
        # re-orthogonalize downward
        d2 = np.cross(f, r)
        frame[:, 1] = d2 / max(np.linalg.norm(d2), 1e-12)
    return frame


def rotation_from_unit_vectors(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Minimal rotation taking unit vector a onto unit vector b
    (base/pose.cc RotationFromUnitVectors)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    a = a / max(np.linalg.norm(a), 1e-12)
    b = b / max(np.linalg.norm(b), 1e-12)
    v = np.cross(a, b)
    c = float(a @ b)
    if c < -1.0 + 1e-12:
        # 180 deg: rotate about any axis orthogonal to a
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, [0.0, 1.0, 0.0])
        axis /= np.linalg.norm(axis)
        return 2.0 * np.outer(axis, axis) - np.eye(3)
    vx = np.asarray([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx / (1.0 + c)


def orientation_aligner_rotation(frame: np.ndarray) -> np.ndarray:
    """World -> aligned rotation from an estimated (possibly partial)
    Manhattan frame, matching RunModelOrientationAligner
    (exe/model.cc:764-777): full frame -> transpose; only one axis
    determined -> minimal rotation onto that canonical axis."""
    r, d = frame[:, 0], frame[:, 1]
    if np.linalg.norm(r) == 0 and np.linalg.norm(d) > 0:
        return rotation_from_unit_vectors(d, np.asarray([0.0, 1.0, 0.0]))
    if np.linalg.norm(d) == 0 and np.linalg.norm(r) > 0:
        return rotation_from_unit_vectors(r, np.asarray([1.0, 0.0, 0.0]))
    if np.linalg.norm(r) > 0 and np.linalg.norm(d) > 0:
        return frame.T
    return np.eye(3)


def align_to_manhattan_world_frame(rec, frame: np.ndarray):
    """Apply the estimated frame (columns right/down/forward in world)."""
    R = orientation_aligner_rotation(frame)
    rec.transform(np_geom.rotmat_to_quat(R), np.zeros(3), 1.0)
    return rec


def align_to_principal_plane(rec):
    """(coordinate_frame.cc AlignToPrincipalPlane): center on the 3D point
    centroid and rotate so x/y are the two leading principal components."""
    pts = np.stack([p.xyz for p in rec.points3D.values()])
    c = pts.mean(0)
    _, _, vt = np.linalg.svd(pts - c, full_matrices=False)
    R = vt  # rows = principal axes
    if np.linalg.det(R) < 0:
        R[2] = -R[2]
    rec.transform(np_geom.rotmat_to_quat(R), -R @ c, 1.0)
    return rec


def align_to_enu_plane(rec, lat_deg: float, lon_deg: float, unscaled: bool = True):
    """(coordinate_frame.cc AlignToENUPlane): rotate so x-y aligns with the
    ENU tangent plane at the centroid (model coords assumed ECEF)."""
    from ..utils.gps import ecef_to_enu_rotation

    pts = np.stack([p.xyz for p in rec.points3D.values()])
    c = pts.mean(0)
    R = ecef_to_enu_rotation(lat_deg, lon_deg)
    rec.transform(np_geom.rotmat_to_quat(R), -R @ c, 1.0)
    return rec
