"""Model management tools: merge, crop, split, orientation alignment, compare.

Parity with the reference's model_* CLI family (src/exe/model.cc):
model_merger, model_cropper, model_splitter, model_orientation_aligner,
model_comparer. Host-side numpy on the scene model; heavy math (Umeyama)
reuses ops/solvers, on `device` (None: CUDA).

A copy of colmap_pcd_tpu/models/model_tools.py (host code, carried).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .. import device as device_mod
from ..ops import np_geom, solvers
from .hierarchical import merge_reconstructions
from .reconstruction import Reconstruction


def merge_models(rec1: Reconstruction, rec2: Reconstruction, device=None) -> Reconstruction | None:
    """Merge two overlapping models (RunModelMerger): align rec2 onto rec1 by
    shared registered images and import it."""
    out = copy.deepcopy(rec1)
    if merge_reconstructions(out, copy.deepcopy(rec2), device=device):
        return out
    return None


def crop_model(rec: Reconstruction, box_min, box_max) -> Reconstruction:
    """Keep points inside an axis-aligned box and images observing them
    (RunModelCropper)."""
    out = copy.deepcopy(rec)
    box_min = np.asarray(box_min)
    box_max = np.asarray(box_max)
    for pid in list(out.points3D.keys()):
        x = out.points3D[pid].xyz
        if np.any(x < box_min) or np.any(x > box_max):
            out.delete_point3D(pid)
    for iid in list(out.registered_ids):
        if out.images[iid].num_points3D() == 0:
            out.deregister_image(iid)
    return out


def split_model(rec: Reconstruction, parts: int, axis: int = 0, overlap: float = 0.0) -> list[Reconstruction]:
    """Split along an axis into equal slabs with optional overlap
    (RunModelSplitter, box mode)."""
    lo, hi = rec.compute_bounding_box()
    width = (hi[axis] - lo[axis]) / parts
    out = []
    for k in range(parts):
        bmin = np.asarray(lo, np.float64).copy()
        bmax = np.asarray(hi, np.float64).copy()
        bmin[axis] = lo[axis] + k * width - overlap
        bmax[axis] = lo[axis] + (k + 1) * width + overlap
        out.append(crop_model(rec, bmin, bmax))
    return out


def align_to_principal_axes(rec: Reconstruction) -> Reconstruction:
    """Rotate the model so gravity/principal axes align with coordinate axes
    (RunModelOrientationAligner — Manhattan-frame estimate approximated by
    the PCA of camera centers + up-vector vote from camera y axes)."""
    out = copy.deepcopy(rec)
    if not out.registered_ids:
        return out
    # up vector: average of camera -y axes in world (camera y points down)
    ups = []
    centers = []
    for iid in out.registered_ids:
        img = out.images[iid]
        R = np_geom.quat_to_rotmat(img.qvec)  # world->cam
        ups.append(-R[1])  # world direction of camera up
        centers.append(img.projection_center())
    up = np.mean(ups, axis=0)
    up /= max(np.linalg.norm(up), 1e-12)
    # forward: principal direction of camera centers orthogonal to up
    C = np.stack(centers)
    C = C - C.mean(0)
    C = C - np.outer(C @ up, up)
    if np.linalg.norm(C) > 1e-9:
        _, _, vt = np.linalg.svd(C, full_matrices=False)
        fwd = vt[0]
    else:
        fwd = np.asarray([0.0, 0.0, 1.0])
    fwd = fwd - up * (fwd @ up)
    fwd /= max(np.linalg.norm(fwd), 1e-12)
    right = np.cross(up, fwd)
    # world-to-aligned rotation: rows = target axes
    R_align = np.stack([right, -up, fwd])  # x right, y down, z forward
    if np.linalg.det(R_align) < 0:
        R_align[0] = -R_align[0]
    q = np_geom.rotmat_to_quat(R_align)
    out.transform(q, np.zeros(3), 1.0)
    return out


def compare_models(rec1: Reconstruction, rec2: Reconstruction, device=None) -> dict:
    """Pose-error statistics between two models sharing image ids
    (RunModelComparer): aligns rec2 to rec1 first."""
    common = [
        i
        for i in rec1.registered_ids
        if i in rec2.images and rec2.images[i].registered
    ]
    dev = device_mod.resolve(device)
    if len(common) < 3:
        return {"num_common_images": len(common)}
    c1 = np.stack([rec1.images[i].projection_center() for i in common])
    c2 = np.stack([rec2.images[i].projection_center() for i in common])
    q, t, s = solvers.umeyama(
        torch.as_tensor(c2, dtype=torch.float32, device=dev),
        torch.as_tensor(c1, dtype=torch.float32, device=dev), with_scale=True,
    )
    aligned = copy.deepcopy(rec2)
    aligned.transform(q.cpu().numpy(), t.cpu().numpy(), float(s))
    terrs, rerrs = [], []
    for i in common:
        terrs.append(
            np.linalg.norm(rec1.images[i].projection_center() - aligned.images[i].projection_center())
        )
        rerrs.append(
            float(np.rad2deg(np_geom.angle_between(rec1.images[i].qvec, aligned.images[i].qvec)))
        )
    return {
        "num_common_images": len(common),
        "mean_translation_error": float(np.mean(terrs)),
        "median_translation_error": float(np.median(terrs)),
        "mean_rotation_error_deg": float(np.mean(rerrs)),
        "median_rotation_error_deg": float(np.median(rerrs)),
        "scale": float(s),
    }


def normalize_model(rec: Reconstruction, extent: float = 10.0) -> Reconstruction:
    """Center + scale the model (Reconstruction::Normalize parity — note the
    reference skips this when lidar constraints are on)."""
    out = copy.deepcopy(rec)
    if not out.registered_ids:
        return out
    centers = np.stack([out.images[i].projection_center() for i in out.registered_ids])
    lo = np.percentile(centers, 5, axis=0)
    hi = np.percentile(centers, 95, axis=0)
    mid = (lo + hi) / 2
    scale = extent / max(float(np.max(hi - lo)), 1e-9)
    out.transform(np.asarray([1.0, 0, 0, 0]), -mid * scale, scale)
    return out
