"""Camera rigs: rigid multi-camera configurations over snapshots.

Host module carried from colmap_pcd_tpu/models/camera_rig.py (numpy and
ops/np_geom only). Re-design of src/base/camera_rig.{h,cc}: a rig is a set
of cameras with fixed relative poses to a reference camera, capturing
synchronized "snapshots" (one image per rig camera). Relative poses can be
given or computed from a reconstruction by averaging over snapshots;
rig-level absolute poses are the per-snapshot average of image poses mapped
through the relative poses.

Also the JSON rig-config reader used by the `rig_bundle_adjuster` CLI
(src/exe/sfm.cc:58-170 ReadCameraRigConfig): cameras are matched to images
by filename prefix, and images with a common suffix form one snapshot.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from ..ops import np_geom


def average_quaternions(qs: np.ndarray, weights=None) -> np.ndarray:
    """Weighted chordal-L2 quaternion average (largest eigenvector of the
    weighted outer-product matrix; Markley et al.) — the same estimate the
    reference's AverageQuaternions (base/pose.cc) computes."""
    qs = np.asarray(qs, np.float64)
    if weights is None:
        weights = np.ones(qs.shape[0])
    w = np.asarray(weights, np.float64)
    A = np.einsum("n,ni,nj->ij", w, qs, qs)
    _, vecs = np.linalg.eigh(A)
    q = vecs[:, -1]
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


@dataclass
class CameraRig:
    """Relative configuration of one camera rig (base/camera_rig.h:49-120)."""

    ref_camera_id: int = -1
    # camera_id -> (rel_qvec, rel_tvec): rig-frame-to-camera pose. The rig
    # frame is the reference camera's frame, so rel of ref camera = identity.
    rel_poses: dict[int, tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)
    snapshots: list[list[int]] = field(default_factory=list)  # lists of image_ids

    def num_cameras(self) -> int:
        return len(self.rel_poses)

    def num_snapshots(self) -> int:
        return len(self.snapshots)

    def has_camera(self, camera_id: int) -> bool:
        return camera_id in self.rel_poses

    def add_camera(self, camera_id: int, rel_qvec=None, rel_tvec=None):
        q = np.asarray([1.0, 0, 0, 0]) if rel_qvec is None else np.asarray(rel_qvec, np.float64)
        t = np.zeros(3) if rel_tvec is None else np.asarray(rel_tvec, np.float64)
        self.rel_poses[int(camera_id)] = (q, t)

    def add_snapshot(self, image_ids: list[int]):
        assert image_ids, "empty snapshot"
        self.snapshots.append([int(i) for i in image_ids])

    def check(self, rec) -> None:
        """Validate against a reconstruction (CameraRig::Check)."""
        assert self.ref_camera_id in self.rel_poses, "ref camera not in rig"
        seen: set[int] = set()
        for snap in self.snapshots:
            assert snap, "empty snapshot"
            for iid in snap:
                img = rec.images[iid]
                assert img.camera_id in self.rel_poses, (
                    f"image {iid} camera {img.camera_id} not in rig"
                )
                assert iid not in seen, f"image {iid} in two snapshots"
                seen.add(iid)

    # -------------------------------------------------------------- geometry
    def compute_scale(self, rec) -> float:
        """Mean ratio of rig-frame to reconstruction-frame baselines
        (CameraRig::ComputeScale)."""
        total, n = 0.0, 0
        ref_c_rig = np_geom.projection_center(*self.rel_poses[self.ref_camera_id])
        for snap in self.snapshots:
            centers = {}
            for iid in snap:
                img = rec.images[iid]
                if not img.registered:
                    continue
                centers[img.camera_id] = img.projection_center()
            if self.ref_camera_id not in centers:
                continue
            for cid, c in centers.items():
                if cid == self.ref_camera_id:
                    continue
                rig_base = np.linalg.norm(
                    np_geom.projection_center(*self.rel_poses[cid]) - ref_c_rig
                )
                rec_base = np.linalg.norm(c - centers[self.ref_camera_id])
                if rig_base > 1e-9 and rec_base > 1e-9:
                    total += rec_base / rig_base
                    n += 1
        return total / n if n else float("nan")

    def compute_relative_poses(self, rec) -> bool:
        """Average rel pose per camera over all snapshots where both the
        camera and the reference camera are registered
        (CameraRig::ComputeRelativePoses)."""
        acc_q: dict[int, list[np.ndarray]] = {cid: [] for cid in self.rel_poses}
        acc_t: dict[int, list[np.ndarray]] = {cid: [] for cid in self.rel_poses}
        for snap in self.snapshots:
            poses = {}
            for iid in snap:
                img = rec.images[iid]
                if img.registered:
                    poses[img.camera_id] = (np.asarray(img.qvec), np.asarray(img.tvec))
            ref = poses.get(self.ref_camera_id)
            if ref is None:
                continue
            inv_q, inv_t = np_geom.se3_inverse(*ref)
            for cid, (q, t) in poses.items():
                # rel = img_pose ∘ inv(ref_pose)
                rq, rt = np_geom.se3_compose(q, t, inv_q, inv_t)
                acc_q[cid].append(rq)
                acc_t[cid].append(rt)
        ok = True
        for cid in self.rel_poses:
            if cid == self.ref_camera_id:
                self.rel_poses[cid] = (np.asarray([1.0, 0, 0, 0]), np.zeros(3))
                continue
            if not acc_q[cid]:
                ok = False
                continue
            q = average_quaternions(np.stack(acc_q[cid]))
            t = np.mean(np.stack(acc_t[cid]), axis=0)
            self.rel_poses[cid] = (q, t)
        return ok

    def compute_absolute_pose(self, snapshot_idx: int, rec):
        """Average world-to-rig pose of one snapshot
        (CameraRig::ComputeAbsolutePose): rig = inv(rel) ∘ img_pose."""
        qs, ts = [], []
        for iid in self.snapshots[snapshot_idx]:
            img = rec.images[iid]
            if not img.registered:
                continue
            rq, rt = self.rel_poses[img.camera_id]
            iq, it = np_geom.se3_inverse(rq, rt)
            gq, gt = np_geom.se3_compose(iq, it, np.asarray(img.qvec), np.asarray(img.tvec))
            qs.append(gq)
            ts.append(gt)
        if not qs:
            return None
        return average_quaternions(np.stack(qs)), np.mean(np.stack(ts), axis=0)


def read_rig_config(path: str, rec, database=None) -> list[CameraRig]:
    """Parse the reference's JSON rig configuration and build CameraRigs with
    snapshots grouped by image-name suffix (exe/sfm.cc ReadCameraRigConfig +
    RunRigBundleAdjuster snapshot assembly).

    Format: [{"ref_camera_id": 1,
              "cameras": [{"camera_id":1, "image_prefix":"left/",
                           "rel_qvec":[...], "rel_tvec":[...]}, ...]}, ...]
    rel_qvec/rel_tvec are optional — absent means compute from the model.
    """
    with open(path) as f:
        cfgs = json.load(f)
    rigs = []
    for cfg in cfgs:
        rig = CameraRig()
        rig.ref_camera_id = int(cfg["ref_camera_id"])
        prefixes = {}
        explicit = True
        for cam in cfg["cameras"]:
            cid = int(cam["camera_id"])
            q = cam.get("rel_qvec")
            t = cam.get("rel_tvec")
            if q is None or t is None:
                explicit = False
            rig.add_camera(cid, q, t)
            prefixes[cid] = cam["image_prefix"]
        # snapshots: images whose name = prefix + suffix, grouped by suffix
        by_suffix: dict[str, list[int]] = {}
        for iid, img in rec.images.items():
            for cid, pre in prefixes.items():
                if img.camera_id == cid and img.name.startswith(pre):
                    by_suffix.setdefault(img.name[len(pre):], []).append(iid)
                    break
        for suffix in sorted(by_suffix):
            snap = by_suffix[suffix]
            if any(rec.images[i].registered for i in snap):
                rig.add_snapshot(snap)
        if not explicit:
            rig.compute_relative_poses(rec)
        rigs.append(rig)
    return rigs
