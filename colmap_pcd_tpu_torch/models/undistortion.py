"""Image + camera undistortion (parity with src/base/undistortion.{h,cc}:
COLMAPUndistorter / UndistortCamera / UndistortImage).

Port of colmap_pcd_tpu/models/undistortion.py. The undistorted camera is
PINHOLE with the same focal and principal point. The warp is one dense
gather on the device: for every target pixel, unproject through the pinhole,
re-distort through the source model and sample bilinearly with the
coordinates clipped to the image and pixels outside it set to 0 (the JAX
package's rules; `grid_sample`'s edge and corner rules differ).
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as device_mod
from ..ops import camera_models as cm
from ..ops import np_geom
from .reconstruction import Camera, Reconstruction


@dataclass
class UndistortOptions:
    blank_pixels: float = 0.0
    min_scale: float = 0.2
    max_scale: float = 2.0
    max_image_size: int = -1


def undistorted_camera(cam: Camera) -> Camera:
    """PINHOLE camera with matching focal/pp (UndistortCamera)."""
    fi, fj, ci, cj = cm._FOCAL_IDX[cam.model_id]
    p = cam.params
    params = np.asarray([p[fi], p[fj], p[ci], p[cj]], np.float64)
    return Camera(cam.camera_id, cm.MODEL_IDS["PINHOLE"], cam.width, cam.height, params)


def _bilinear(im: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample im [H,W,C] at float pixel coordinates x, y [...]: corners
    clipped to the image, weights clipped to [0, 1], 0 outside the image."""
    H, W = im.shape[:2]
    # a NaN coordinate takes corner 0, as a saturating float -> int cast does
    x0 = torch.clamp(torch.nan_to_num(torch.floor(x), nan=0.0), 0, W - 1)
    y0 = torch.clamp(torch.nan_to_num(torch.floor(y), nan=0.0), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    fx = torch.clamp(x - x0, 0, 1)[..., None]
    fy = torch.clamp(y - y0, 0, 1)[..., None]
    flat = im.reshape(H * W, -1)

    def at(yy, xx):
        return flat[(yy * W + xx).long()]

    v = (
        at(y0, x0) * (1 - fx) * (1 - fy)
        + at(y0, x1) * fx * (1 - fy)
        + at(y1, x0) * (1 - fx) * fy
        + at(y1, x1) * fx * fy
    )
    inb = ((x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)).to(v.dtype)[..., None]
    return v * inb


def _warp(img: torch.Tensor, params: torch.Tensor, new_params: torch.Tensor, model_id: int,
          width: int, height: int) -> torch.Tensor:
    """img [H,W] or [H,W,C] -> f32 [height, width, C] on img's device."""
    dev = img.device
    yy, xx = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    # target pinhole pixel -> normalized -> source distorted pixel
    uv = cm.image_to_world(cm.MODEL_IDS["PINHOLE"], new_params, torch.stack([xx, yy], -1))
    src = cm.world_to_image(model_id, params, uv)
    im = img.reshape(img.shape[0], img.shape[1], -1).to(torch.float32)
    return _bilinear(im, src[..., 0], src[..., 1])


def _to_image(out: np.ndarray, like: np.ndarray) -> np.ndarray:
    """The warped f32 [H,W,C] in the input's layout and type."""
    if like.ndim == 2:
        out = out[..., 0]
    if like.dtype == np.uint8:
        out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out


def undistort_image(img: np.ndarray, cam: Camera, new_cam: Camera, device=None) -> np.ndarray:
    """UndistortImage on `device` (None: CUDA)."""
    dev = device_mod.resolve(device)
    out = _warp(
        torch.as_tensor(img, device=dev),
        torch.as_tensor(cam.padded_params(), device=dev),
        torch.as_tensor(new_cam.padded_params(), device=dev),
        cam.model_id,
        new_cam.width,
        new_cam.height,
    )
    return _to_image(out.cpu().numpy(), img)


def rectify_stereo_cameras(cam1: Camera, cam2: Camera, qvec: np.ndarray, tvec: np.ndarray):
    """Row-aligning rectification homographies for two PINHOLE cameras with
    relative pose (qvec, tvec) of cam2 w.r.t. cam1
    (base/undistortion.cc:978-1038 RectifyStereoCameras). Returns
    (H1, H2, Q) with Q the disparity-to-depth reprojection matrix. Host
    numpy, carried unchanged."""
    # split the relative rotation evenly between the two views
    q = np.asarray(qvec, np.float64)
    q = q / np.linalg.norm(q)
    angle = 2.0 * np.arctan2(np.linalg.norm(q[1:]), q[0])
    axis = q[1:] / max(np.linalg.norm(q[1:]), 1e-15)
    # rotation by -angle/2 about the same axis (reference: rvec.angle() *= -0.5)
    half = -0.5 * angle
    q_half = np.concatenate([[np.cos(half / 2)], axis * np.sin(half / 2)])
    R2 = np_geom.quat_to_rotmat(q_half)
    R1 = R2.T
    t = R2 @ np.asarray(tvec, np.float64)
    x_unit = np.array([1.0, 0.0, 0.0])
    if t @ x_unit < 0:
        x_unit = -x_unit
    rot_axis = np.cross(t, x_unit)
    if np.linalg.norm(rot_axis) < 1e-15:
        R_x = np.eye(3)
    else:
        ang = np.arccos(np.clip(abs(t @ x_unit) / np.linalg.norm(t), -1.0, 1.0))
        a = rot_axis / np.linalg.norm(rot_axis)
        K_ = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        R_x = np.eye(3) + np.sin(ang) * K_ + (1 - np.cos(ang)) * (K_ @ K_)
    R1 = R_x @ R1
    R2 = R_x @ R2
    t = R_x @ t
    f = min(cam1.mean_focal_length(), cam2.mean_focal_length())
    fi, fj, ci, cj = cm._FOCAL_IDX[cam1.model_id]
    fi2, fj2, ci2, cj2 = cm._FOCAL_IDX[cam2.model_id]
    cx = cam1.params[ci]
    cy = (cam1.params[cj] + cam2.params[cj2]) / 2
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])

    def calib(camx):
        fi_, fj_, ci_, cj_ = cm._FOCAL_IDX[camx.model_id]
        p = camx.params
        return np.array([[p[fi_], 0, p[ci_]], [0, p[fj_], p[cj_]], [0, 0, 1.0]])

    H1 = K @ R1 @ np.linalg.inv(calib(cam1))
    H2 = K @ R2 @ np.linalg.inv(calib(cam2))
    Q = np.eye(4)
    Q[3, 0] = -K[1, 2]
    Q[3, 1] = -K[0, 2]
    Q[3, 2] = K[0, 0]
    Q[2, 3] = -1.0 / t[0] if abs(t[0]) > 1e-15 else 0.0
    Q[3, 3] = 0.0
    return H1, H2, Q


def _warp_homography_from_distorted(img: np.ndarray, H_inv: np.ndarray, cam: Camera, und_cam: Camera,
                                    device=None):
    """Warp a distorted source image into the rectified frame: target pixel
    -> H^{-1} -> undistorted pixel -> normalized -> distorted source pixel ->
    bilinear sample (base/undistortion.cc WarpImageWithHomographyBetweenCameras).
    The homography runs in float64 on the host as in the JAX package; the
    distortion on `device` in f32, the sampling on the host in float64."""
    dev = device_mod.resolve(device)
    H, W = img.shape[:2]
    yy, xx = np.meshgrid(np.arange(H, dtype=np.float64), np.arange(W, dtype=np.float64), indexing="ij")
    tgt = np.stack([xx.ravel() + 0.5, yy.ravel() + 0.5, np.ones(H * W)], axis=0)
    und = H_inv @ tgt
    und = und[:2] / und[2:]
    fi, fj, ci, cj = cm._FOCAL_IDX[und_cam.model_id]
    p = und_cam.params
    uv = np.stack([(und[0] - p[ci]) / p[fi], (und[1] - p[cj]) / p[fj]], axis=-1)
    src = cm.world_to_image(
        cam.model_id, torch.as_tensor(cam.padded_params(), device=dev),
        torch.as_tensor(uv, dtype=torch.float32, device=dev),
    ).cpu().numpy()
    out = _bilinear(
        torch.as_tensor(img.reshape(H, W, -1), dtype=torch.float64),
        torch.as_tensor(src[:, 0] - 0.5, dtype=torch.float64),
        torch.as_tensor(src[:, 1] - 0.5, dtype=torch.float64),
    )
    return _to_image(out.numpy().reshape(H, W, -1), img)


def rectify_stereo_pair(rec: Reconstruction, id1: int, id2: int, img1: np.ndarray, img2: np.ndarray,
                        device=None):
    """Rectified image pair for two registered images (StereoImageRectifier,
    base/undistortion.cc:1040-1075)."""
    im1, im2 = rec.images[id1], rec.images[id2]
    cam1, cam2 = rec.cameras[im1.camera_id], rec.cameras[im2.camera_id]
    # relative pose of image2 w.r.t. image1
    q_rel = np_geom.quat_mul(im2.qvec, np_geom.quat_conj(im1.qvec))
    t_rel = im2.tvec - np_geom.quat_to_rotmat(q_rel) @ im1.tvec
    u1, u2 = undistorted_camera(cam1), undistorted_camera(cam2)
    H1, H2, _ = rectify_stereo_cameras(u1, u2, q_rel, t_rel)
    r1 = _warp_homography_from_distorted(img1, np.linalg.inv(H1), cam1, u1, device)
    r2 = _warp_homography_from_distorted(img2, np.linalg.inv(H2), cam2, u2, device)
    return r1, r2


def run_image_undistorter(
    image_path: str,
    input_model: str,
    output_path: str,
    options: UndistortOptions = UndistortOptions(),
    device=None,
) -> int:
    """COLMAP-workspace undistorter (RunImageUndistorter, exe/image.cc):
    writes undistorted images + a PINHOLE model into output_path. The warps
    and the keypoints' undistortion run on `device` (None: CUDA)."""
    from PIL import Image as PILImage

    from ..utils import image as image_utils

    dev = device_mod.resolve(device)
    rec = Reconstruction.read(input_model)
    os.makedirs(os.path.join(output_path, "images"), exist_ok=True)
    new_rec = Reconstruction()
    new_cams = {}
    for cid, cam in rec.cameras.items():
        nc = undistorted_camera(cam)
        new_cams[cid] = nc
        new_rec.add_camera(nc)
    n = 0
    for img in rec.images.values():
        if not img.registered:
            continue
        src = image_utils.imread_rgb(os.path.join(image_path, img.name))
        out = undistort_image(src, rec.cameras[img.camera_id], new_cams[img.camera_id], dev)
        dst = os.path.join(output_path, "images", img.name)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        PILImage.fromarray(out).save(dst)
        n += 1
    # copy scene with undistorted observations
    for iid, img in rec.images.items():
        im2 = copy.deepcopy(img)
        cam = rec.cameras[img.camera_id]
        if img.xys.shape[0]:
            uv = cm.image_to_world(
                cam.model_id, torch.as_tensor(cam.padded_params(), device=dev),
                torch.as_tensor(img.xys, dtype=torch.float32, device=dev),
            )
            xy = cm.world_to_image(
                cm.MODEL_IDS["PINHOLE"], torch.as_tensor(new_cams[img.camera_id].padded_params(), device=dev), uv
            )
            im2.xys = xy.cpu().numpy().astype(np.float64)
        new_rec.add_image(im2)
        if img.registered:
            new_rec.registered_ids.append(iid)
    new_rec.points3D = copy.deepcopy(rec.points3D)
    new_rec._next_point3D_id = rec._next_point3D_id
    new_rec.write(os.path.join(output_path, "sparse"))
    return n
