"""Rig bundle adjustment of a reconstruction with its CameraRigs: the rig BA solve.

Carried from colmap_pcd_tpu/models/rig_adjuster.py; its device call is the
port's ops/rig_ba.solve on `device`. Re-design of RigBundleAdjuster::Solve/
SetUp/TearDown (src/optim/bundle_adjustment.cc:700-940): compute
per-snapshot rig poses, assemble one RigBAProblem over all registered
images (rig images share snapshot pose slots and per-rig-camera relative
pose slots; non-rig images get private snapshot slots with a frozen identity
relative pose), solve, and write composed image poses + refined relative
poses + points back into the reconstruction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import device as device_mod
from ..ops import np_geom, rig_ba
from .camera_rig import CameraRig
from .reconstruction import INVALID_POINT3D, Reconstruction


@dataclass
class RigBAOptions:
    """RigBundleAdjuster::Options + the relevant BundleAdjustmentOptions."""

    refine_relative_poses: bool = True
    max_reproj_error: float = 1000.0
    max_iterations: int = 100
    loss_type: int = 0
    loss_scale: float = 1.0


class RigBundleAdjuster:
    """Runs on `device` (None: CUDA; the CPU only by name)."""

    def __init__(self, options: RigBAOptions | None = None, device=None):
        self.opts = options or RigBAOptions()
        self.device = device_mod.resolve(device)

    def solve(self, rec: Reconstruction, rigs: list[CameraRig]) -> bool:
        opts = self.opts
        # ---- parameter slots -------------------------------------------------
        # snapshot slots: one per rig snapshot with >=1 registered image, plus
        # one per registered non-rig image. rel slots: slot 0 = frozen
        # identity; then one per (rig, camera).
        image_rig: dict[int, tuple[int, int]] = {}  # image_id -> (rig_idx, snap_idx)
        for ri, rig in enumerate(rigs):
            rig.check(rec)
            for si, snap in enumerate(rig.snapshots):
                for iid in snap:
                    image_rig[iid] = (ri, si)

        snap_slot: dict[tuple[int, int], int] = {}
        rel_slot: dict[tuple[int, int], int] = {}  # (rig_idx, camera_id) -> slot
        rig_q, rig_t = [], []
        rel_q, rel_t = [np.asarray([1.0, 0, 0, 0])], [np.zeros(3)]
        rel_fixed = [1.0]
        img_slots: dict[int, tuple[int, int]] = {}  # image_id -> (snap slot, rel slot)

        for ri, rig in enumerate(rigs):
            for cid, (q, t) in rig.rel_poses.items():
                rel_slot[(ri, cid)] = len(rel_q)
                rel_q.append(np.asarray(q, np.float64))
                rel_t.append(np.asarray(t, np.float64))
                # freeze the reference camera's (identity) relative pose: it is
                # the rig-frame gauge (ParameterizeCameraRigs holds the rig
                # gauge via constant blocks in the reference)
                rel_fixed.append(1.0 if cid == rig.ref_camera_id else 0.0)

        for iid in rec.registered_ids:
            img = rec.images[iid]
            hit = image_rig.get(iid)
            if hit is not None:
                ri, si = hit
                key = (ri, si)
                if key not in snap_slot:
                    pose = rigs[ri].compute_absolute_pose(si, rec)
                    if pose is None:
                        hit = None
                    else:
                        snap_slot[key] = len(rig_q)
                        rig_q.append(pose[0])
                        rig_t.append(pose[1])
                if hit is not None:
                    img_slots[iid] = (snap_slot[key], rel_slot[(hit[0], img.camera_id)])
                    continue
            # non-rig image: private snapshot slot, identity rel (slot 0)
            s = len(rig_q)
            rig_q.append(np.asarray(img.qvec, np.float64))
            rig_t.append(np.asarray(img.tvec, np.float64))
            img_slots[iid] = (s, 0)

        if len(rig_q) < 2:
            return False

        # ---- intrinsics slots ------------------------------------------------
        cam_ids = sorted({rec.images[i].camera_id for i in img_slots})
        k_slot = {cid: k for k, cid in enumerate(cam_ids)}
        intr = np.stack([rec.cameras[c].padded_params() for c in cam_ids])
        model_ids = tuple(sorted({rec.cameras[c].model_id for c in cam_ids}))
        cam_model = np.asarray(
            [model_ids.index(rec.cameras[c].model_id) for c in cam_ids], np.int32
        )

        # ---- observations ----------------------------------------------------
        obs_rig, obs_rel, obs_k, obs_pid, obs_uv = [], [], [], [], []
        for iid, (ss, rs) in img_slots.items():
            img = rec.images[iid]
            f = np.nonzero(img.point3D_ids != INVALID_POINT3D)[0]
            for fi in f:
                pid = int(img.point3D_ids[fi])
                if pid not in rec.points3D:
                    continue
                obs_rig.append(ss)
                obs_rel.append(rs)
                obs_k.append(k_slot[img.camera_id])
                obs_pid.append(pid)
                obs_uv.append(img.xys[fi])
        if not obs_pid:
            return False
        obs_rig = np.asarray(obs_rig, np.int32)
        obs_rel = np.asarray(obs_rel, np.int32)
        obs_k = np.asarray(obs_k, np.int32)
        obs_uv = np.asarray(obs_uv, np.float32)
        pid_arr = np.asarray(obs_pid, np.int64)
        uniq_pids, obs_pt = np.unique(pid_arr, return_inverse=True)
        points = np.stack([rec.points3D[int(p)].xyz for p in uniq_pids]).astype(np.float32)

        # drop observations whose composed-pose reprojection error explodes
        # (rig_options.max_reproj_error, bundle_adjustment.cc:795-807): the
        # concatenated rig+rel pose can disagree with the image's own pose.
        rig_q, rig_t, rel_q, rel_t = (np.stack(a) for a in (rig_q, rig_t, rel_q, rel_t))
        cq, ct = np_geom.se3_compose(rel_q[obs_rel], rel_t[obs_rel], rig_q[obs_rig], rig_t[obs_rig])
        Xc = np_geom.se3_apply(cq, ct, points[obs_pt])  # [M,3]
        z = Xc[:, 2]
        uvn = Xc[:, :2] / np.where(np.abs(z[:, None]) < 1e-9, 1e-9, z[:, None])
        err = np.full(len(pid_arr), np.inf)
        for kk in range(len(cam_ids)):
            g = np.nonzero(obs_k == kk)[0]
            if g.size:
                mid = model_ids[int(cam_model[kk])]
                xy = np_geom.world_to_image(mid, intr[kk], uvn[g])
                err[g] = np.linalg.norm(xy - obs_uv[g], axis=-1)
        err = np.where(z > 0, err, np.inf)
        valid = ((np.isfinite(err)) & (err <= opts.max_reproj_error)).astype(np.float32)

        prob = rig_ba.make_problem(
            rig_q, rig_t, rel_q, rel_t, intr, points,
            obs_rig, obs_rel, obs_k, obs_pt.astype(np.int32), obs_uv,
            cam_model=cam_model,
            obs_valid=valid,
            track_len=int(np.bincount(obs_pt).max()),
            rel_fixed=rel_fixed,
            device=self.device,
        )
        cfg = rig_ba.RigBAConfig(
            model_id=model_ids[0],
            model_ids=model_ids,
            loss_type=opts.loss_type,
            loss_scale=opts.loss_scale,
            max_iterations=opts.max_iterations,
            refine_relative_poses=opts.refine_relative_poses,
        )
        out = rig_ba.solve(prob, cfg)
        final_cost, initial_cost = float(out.final_cost), float(out.initial_cost)
        if not np.isfinite(final_cost) or final_cost > initial_cost:
            return False

        # ---- write back (TearDown, :872-900) ---------------------------------
        rig_qo, rig_to, rel_qo, rel_to, p_out = (
            x.cpu().numpy().astype(np.float64) for x in (out.rig_q, out.rig_t, out.rel_q, out.rel_t, out.points)
        )
        for iid, (ss, rs) in img_slots.items():
            img = rec.images[iid]
            q, t = np_geom.se3_compose(rel_qo[rs], rel_to[rs], rig_qo[ss], rig_to[ss])
            img.qvec = np.asarray(q, np.float64)
            img.tvec = np.asarray(t, np.float64)
        if opts.refine_relative_poses:
            for (ri, cid), rs in rel_slot.items():
                rigs[ri].rel_poses[cid] = (rel_qo[rs].copy(), rel_to[rs].copy())
        for s, pid in enumerate(uniq_pids):
            rec.points3D[int(pid)].xyz = p_out[s]
        rec.update_point_errors()
        self.initial_cost = initial_cost
        self.final_cost = final_cost
        self.iterations = out.iterations
        self.host_syncs = out.host_syncs
        return True
