"""The incremental SfM state machine with LiDAR-constrained bundle adjustment.

Parity re-design of src/sfm/incremental_mapper.{h,cc} (2,358 LoC):

  * lidar-seeded initialization (RegisterInitialImagePairByDepthProj,
    incremental_mapper.cc:489-693): image1 pose from init options / pose
    prior, features ray-plane intersected with the map, image2 by PnP,
    3D points created at lidar depths.
  * classic two-view initialization (RegisterInitialImagePair, :391):
    relative pose from the essential matrix of models/two_view.
  * next-image selection by visible triangulated correspondences
    (FindNextImages, :299 — visibility-pyramid score simplified to
    visible-point count).
  * PnP registration with RANSAC + pose-only refinement
    (RegisterNextImage, :706-964).
  * lidar-aware local BA (AdjustLocalBundle, :1004-1213): variable points
    split by track length into depth-projection association (short) and
    kd-tree ICP with shrinking radius (long); first-image pose fixed for the
    first `first_image_fixed_frames` registrations.
  * spherical global BA (AdjustGlobalBundleByLidar, :1297-1493): only images
    within ba_spherical_search_radius of the newest camera are variable;
    their points get NN plane associations with ground classification;
    per-point global_opt_num incremented after the solve.
  * classic global BA (:1225-1285) and filtering (:1551-1580).

Port of colmap_pcd_tpu/models/incremental_mapper.py: the host logic is
carried over unchanged; the device call sites (ray-plane seeding, PnP
RANSAC, bundle adjustment) run the PyTorch ops on `self.device`, one
device->host fetch per call. BA problems keep the JAX package's padded,
bucketed shapes, so both implementations see identical problems. With
`dist_mesh` (a parallel/mesh.Mesh) set, every local and global BA solve
goes through parallel/dist_ba over that mesh, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as device_mod
from ..ops import ba as ba_ops
from ..ops import pointcloud as pc_ops
from ..ops import np_geom
from ..ops import ransac as ransac_ops
from ..utils.logging_utils import PHASES
from .correspondence_graph import CorrespondenceGraph
from .lidar_map import LidarMap
from .reconstruction import (
    INVALID_POINT3D,
    LIDAR_ICP,
    LIDAR_ICP_GROUND,
    LIDAR_PROJ,
    LidarAssoc,
    Reconstruction,
)
from .triangulator import IncrementalTriangulator, TriangulatorOptions


@dataclass
class MapperOptions:
    """Union of IncrementalMapper::Options and the lidar fields of
    IncrementalMapperOptions (controllers/incremental_mapper.h:40-140)."""

    # lidar
    if_add_lidar_constraint: bool = True
    if_add_lidar_corresponding: bool = True
    first_image_fixed_frames: int = 8
    min_proj_num: int = 1
    kdtree_max_search_range: float = 1.5
    kdtree_min_search_range: float = 0.2
    search_range_drop_speed: float = 0.1
    ba_spherical_search_radius: float = 40.0
    ba_match_features_threshold: int = 200
    proj_lidar_constraint_weight: float = 10.0
    icp_lidar_constraint_weight: float = 1000.0
    icp_ground_lidar_constraint_weight: float = 10000.0
    proj_max_dist_error: float = 10.0
    icp_max_dist_error: float = 2.0
    # init
    init_image_id1: int = 1
    init_image_id2: int = -1
    init_image_x: float = 0.0
    init_image_y: float = 0.0
    init_image_z: float = 0.0
    init_image_roll: float = 0.0
    init_image_pitch: float = 0.0
    init_image_yaw: float = 0.0
    init_min_num_inliers: int = 100
    init_max_error: float = 4.0
    init_max_forward_motion: float = 0.95
    init_min_tri_angle: float = 16.0
    init_max_reg_trials: int = 2
    # registration
    abs_pose_max_error: float = 24.0
    abs_pose_min_num_inliers: int = 30
    abs_pose_min_inlier_ratio: float = 0.25
    max_reg_trials: int = 3
    # local BA
    local_ba_num_images: int = 6
    local_ba_min_tri_angle: float = 6.0
    # filtering
    filter_max_reproj_error: float = 8.0
    filter_min_tri_angle: float = 1.5
    min_focal_length_ratio: float = 0.1
    max_focal_length_ratio: float = 10.0
    max_extra_param: float = 1.0
    # BA solver
    ba_local_max_num_iterations: int = 25
    ba_global_max_num_iterations: int = 50
    loss_type: int = ba_ops.LOSS_TRIVIAL
    loss_scale: float = 1.0
    num_ransac_hypotheses: int = 4096
    fix_existing_images: bool = False


@dataclass
class LocalBAReport:
    num_adjusted_observations: int = 0
    num_merged_observations: int = 0
    num_completed_observations: int = 0
    num_filtered_observations: int = 0


class IncrementalMapper:
    def __init__(
        self,
        rec: Reconstruction,
        graph: CorrespondenceGraph,
        lidar_map: LidarMap | None = None,
        pose_priors: dict[int, tuple[np.ndarray, np.ndarray]] | None = None,
        device=None,
    ):
        from .visibility import VisibilityIndex

        # device of the PnP and BA solves: the lidar map's unless given
        if device is None and lidar_map is not None:
            self.device = lidar_map.device
        else:
            self.device = device_mod.resolve(device)
        self.rec = rec
        self.graph = graph
        self.lidar_map = lidar_map
        self.pose_priors = pose_priors or {}
        self.triangulator = IncrementalTriangulator(rec, graph)
        self.num_reg_trials: dict[int, int] = {}
        self.filtered_images: set[int] = set()
        self.existing_image_ids: set[int] = set()
        # cross-model/trial state (persist across BeginReconstruction calls,
        # sfm/incremental_mapper.h: init_image_pairs_, init_num_reg_trials_,
        # num_registrations_)
        self.init_image_pairs: set[tuple[int, int]] = set()
        self.init_num_reg_trials: dict[int, int] = {}
        self.num_registrations: dict[int, int] = {}
        # the last init pair verified by estimate_initial_two_view_geometry
        self._prev_init_pair: tuple[int, int] | None = None
        self._prev_init_geometry = None
        # incremental next-image scoring (visibility pyramid bookkeeping)
        self.visibility = VisibilityIndex(rec, graph)
        # the most recently registered image (center of the spherical global
        # BA) — tracked explicitly so resume-from-model keeps the invariant
        self.last_registered_id: int = (
            rec.registered_ids[-1] if rec.registered_ids else -1
        )
        # per-image depth-projection cache for the current BA round
        # (lidar_searched_image_ids_, bundle_adjustment.h:189)
        self._proj_cache: dict[int, tuple[tuple[int, int, int], tuple, dict]] = {}
        # optional parallel/mesh.Mesh: route every BA solve through the
        # distributed Schur solver (parallel/dist_ba.py) over this mesh
        self.dist_mesh = None

    # ------------------------------------------------------------------ lidar
    def clear_lidar_points(self):
        # NOTE: the projection cache survives this on purpose — an entry is a
        # pure function of (image pose, triangulated feature set, lidar map)
        # and is stamp-validated against (pose_epoch, mut_epoch), so clearing
        # associations does not require re-projecting unchanged views.
        self.rec.clear_lidar_points()

    def _camera_of(self, image_id: int):
        img = self.rec.images[image_id]
        return self.rec.cameras[img.camera_id]

    def _proj_stamp(self, image_id: int) -> tuple[int, int, int]:
        # (pose, triangulated-feature-set, camera-intrinsics) change epochs:
        # project_to_image depends on all three, so an intrinsics refinement
        # (rec.bump_camera_params) invalidates entries exactly like a pose write
        return (
            self.rec.pose_epoch.get(image_id, 0),
            self.rec.mut_epoch.get(image_id, 0),
            self.rec.cam_params_epoch.get(
                self.rec.images[image_id].camera_id, 0
            ),
        )

    # pose tolerance under which a cached depth projection stays valid: the
    # association (which lidar point a feature ray hits) is stable under
    # millimeter pose nudges, and the second local-refinement iteration's
    # re-projection after a converged local BA step was pure recompute
    # (~0.17 s per registration at 450 images). Translation in meters;
    # rotation bound via quaternion distance. 0 disables the tolerance
    # (exact epoch semantics, the pre-r5 behavior).
    PROJ_CACHE_POSE_TOL = 5e-3

    def _proj_cached(self, image_id: int):
        e = self._proj_cache.get(image_id)
        if e is None:
            return None
        stamp, pose, result = e
        cur = self._proj_stamp(image_id)
        if stamp == cur:
            return result
        # mut/cam epoch changes always invalidate; a pose-only change is
        # tolerated while the pose stays within PROJ_CACHE_POSE_TOL
        if stamp[1:] == cur[1:] and self.PROJ_CACHE_POSE_TOL > 0:
            img = self.rec.images[image_id]
            if (
                np.linalg.norm(img.tvec - pose[1]) < self.PROJ_CACHE_POSE_TOL
                and np.linalg.norm(img.qvec - pose[0]) < self.PROJ_CACHE_POSE_TOL
            ):
                return result
        return None

    def _pose_of(self, image_id: int):
        img = self.rec.images[image_id]
        return (np.array(img.qvec, np.float64), np.array(img.tvec, np.float64))

    def _project_image_to_cloud(self, image_id: int):
        """SetNewImage(map overload): associate this image's triangulated
        features with lidar points; cache per image (Project2Image), entries
        stamp-validated against pose/triangulation change epochs."""
        cached = self._proj_cached(image_id)
        if cached is not None:
            return cached
        stamp = self._proj_stamp(image_id)
        img = self.rec.images[image_id]
        cam = self._camera_of(image_id)
        feat_idx = np.nonzero(img.point3D_ids != INVALID_POINT3D)[0]
        result: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        if feat_idx.size > 0 and self.lidar_map is not None:
            out = self.lidar_map.project_to_image(
                img.xys[feat_idx].astype(np.float32),
                np.asarray(img.qvec, np.float32),
                np.asarray(img.tvec, np.float32),
                cam.padded_params(),
                cam.model_id,
                cam.width,
                cam.height,
            )
            for k, fi in enumerate(feat_idx):
                if out["found"][k]:
                    pid = int(img.point3D_ids[fi])
                    result[pid] = (out["lidar_pt"][k], out["lidar_nrm"][k])
        self._proj_cache[image_id] = (stamp, self._pose_of(image_id), result)
        return result

    def _project_images_to_cloud(self, image_ids):
        """Batch-fill the projection cache for several views at once: one
        vmapped depth_project dispatch per camera group instead of one per
        view (Project2Image across the track set of a local-BA round)."""
        todo = [
            i for i in dict.fromkeys(image_ids) if self._proj_cached(i) is None
        ]
        PHASES.count("proj_cache_miss_imgs", len(todo))
        if len(todo) < 2 or self.lidar_map is None:
            return
        by_cam: dict[int, list[int]] = {}
        for iid in todo:
            by_cam.setdefault(self.rec.images[iid].camera_id, []).append(iid)
        for cam_id, iids in by_cam.items():
            cam = self.rec.cameras[cam_id]
            feat_sets = []
            for iid in iids:
                img = self.rec.images[iid]
                feat_sets.append(np.nonzero(img.point3D_ids != INVALID_POINT3D)[0])
            F = max((f.size for f in feat_sets), default=0)
            if F == 0:
                for iid in iids:
                    self._proj_cache[iid] = (
                        self._proj_stamp(iid), self._pose_of(iid), {}
                    )
                continue
            B = len(iids)
            fxy = np.zeros((B, F, 2), np.float32)
            fval = np.zeros((B, F), np.float32)
            qs = np.zeros((B, 4), np.float32)
            ts = np.zeros((B, 3), np.float32)
            for b, (iid, fidx) in enumerate(zip(iids, feat_sets)):
                img = self.rec.images[iid]
                fxy[b, : fidx.size] = img.xys[fidx]
                fval[b, : fidx.size] = 1.0
                qs[b] = img.qvec
                ts[b] = img.tvec
            out = self.lidar_map.project_to_images(
                fxy, fval, qs, ts, cam.padded_params(), cam.model_id,
                cam.width, cam.height,
            )
            for b, (iid, fidx) in enumerate(zip(iids, feat_sets)):
                img = self.rec.images[iid]
                hit = np.nonzero(out["found"][b, : fidx.size])[0]
                pids = img.point3D_ids[fidx[hit]]
                lp = out["lidar_pt"][b, hit]
                ln = out["lidar_nrm"][b, hit]
                self._proj_cache[iid] = (
                    self._proj_stamp(iid),
                    self._pose_of(iid),
                    {int(p): (lp[k], ln[k]) for k, p in enumerate(pids)},
                )

    def _match_variable_points_to_lidar(self, point3D_ids, image_id: int, opts: MapperOptions):
        """Project2Image + MatchVariablePoint2LidarPoint, batched: across each
        track's cached projections, pick the lidar match whose (point -
        lidar_pt) vector is most perpendicular to the normal
        (bundle_adjustment.cc:241-350). One vectorized pass over all candidate
        (point, image) pairs instead of per-point Python walks."""
        # gather candidate (pid, iid) pairs with Project2Image pair gating
        gate_cache: dict[int, bool] = {image_id: True}

        def gate(iid: int) -> bool:
            ok = gate_cache.get(iid)
            if ok is None:
                corrs = self.graph.num_matches(image_id, iid)
                ok = not (corrs and corrs <= opts.ba_match_features_threshold)
                gate_cache[iid] = ok
            return ok

        # pre-batch the projections for every track image of this round
        need: list[int] = []
        for pid in point3D_ids:
            p = self.rec.points3D.get(pid)
            if p is not None:
                need.extend(iid for iid, _ in p.track if gate(iid))
        self._project_images_to_cloud(need)

        cand_pid, cand_lpt, cand_lnr, cand_xyz = [], [], [], []
        for pid in point3D_ids:
            p = self.rec.points3D.get(pid)
            if p is None:
                continue
            for iid, _ in p.track:
                if not gate(iid):
                    continue
                hit = self._project_image_to_cloud(iid).get(pid)
                if hit is None:
                    continue
                cand_pid.append(pid)
                cand_lpt.append(hit[0])
                cand_lnr.append(hit[1])
                cand_xyz.append(p.xyz)
        if not cand_pid:
            return
        pid_arr = np.asarray(cand_pid, np.int64)
        lpt = np.asarray(cand_lpt, np.float64)
        lnr = np.asarray(cand_lnr, np.float64)
        xyz = np.asarray(cand_xyz, np.float64)
        vec = xyz - lpt
        nv = np.linalg.norm(vec, axis=-1) * np.linalg.norm(lnr, axis=-1)
        cosang = np.where(
            nv < 1e-12, 0.0, np.abs(np.sum(vec * lnr, axis=-1)) / np.maximum(nv, 1e-12)
        )
        # per-pid argmin over candidates: sort by (pid, cos), keep first of each
        order = np.lexsort((cosang, pid_arr))
        first = np.ones(len(order), bool)
        sp = pid_arr[order]
        first[1:] = sp[1:] != sp[:-1]
        win = order[first]
        planes = np_geom.plane_through(lpt[win], lnr[win])
        for k, row in enumerate(win):
            self.rec.add_lidar_point(
                int(pid_arr[row]),
                LidarAssoc(LIDAR_PROJ, lpt[row], planes[k]),
            )

    def _match_closest_lidar_points(self, point3D_ids: list[int], max_ranges: list[float]):
        """Batched kd-tree replacement: NN + ground classification + range gate
        (MatchClosestLidarPoint, bundle_adjustment.cc:358-410)."""
        if not point3D_ids or self.lidar_map is None:
            return
        pts = np.stack([self.rec.points3D[pid].xyz for pid in point3D_ids]).astype(np.float32)
        lpts, lnrs, dists = self.lidar_map.nn_query(pts)
        ground = np_geom.classify_ground(lnrs)
        planes = np_geom.plane_through(lpts, lnrs)
        for i, pid in enumerate(point3D_ids):
            if not np.isfinite(lnrs[i]).all() or np.linalg.norm(lnrs[i]) < 1e-6:
                continue
            if dists[i] > max_ranges[i]:
                continue
            typ = LIDAR_ICP_GROUND if ground[i] else LIDAR_ICP
            self.rec.add_lidar_point(
                pid, LidarAssoc(typ, np.asarray(lpts[i], np.float64), planes[i])
            )

    # ------------------------------------------------------------------- init
    def init_pose_from_options(self, opts: MapperOptions) -> tuple[np.ndarray, np.ndarray]:
        """Seed pose from init_image_* flags with the lidar->camera axis
        conversion (incremental_mapper.cc:517-552)."""
        q_cw, t_cw = np_geom.lidar_pose_to_cam(
            opts.init_image_x,
            opts.init_image_y,
            opts.init_image_z,
            math.radians(opts.init_image_roll),
            math.radians(opts.init_image_pitch),
            math.radians(opts.init_image_yaw),
        )
        return q_cw, t_cw

    def _pnp(self, uv: np.ndarray, X: np.ndarray, seed: int, thr: float, opts: MapperOptions):
        """RANSAC + Cauchy-GN pose polish on the device for n 2D-3D matches
        (normalized coords). Returns (num_inliers, q, t, inlier_mask [n]) on
        the host."""
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        res = ransac_ops.ransac_pnp(
            torch.as_tensor(uv, dtype=torch.float32, device=dev),
            torch.as_tensor(X, dtype=torch.float32, device=dev),
            torch.ones(uv.shape[0], dtype=torch.float32, device=dev),
            gen,
            ransac_ops.RansacOptions(num_hypotheses=opts.num_ransac_hypotheses),
            refine_iters=10, max_error=thr,
        )
        # one batched device->host fetch
        n_in, q, t, mask = (
            x.cpu().numpy() for x in (res.num_inliers, res.q, res.t, res.inlier_mask)
        )
        return int(n_in), q, t, mask

    def register_initial_image_pair_by_depth_proj(
        self, opts: MapperOptions, image_id1: int, image_id2: int
    ) -> bool:
        assert self.rec.num_reg_images == 0
        img1 = self.rec.images[image_id1]
        img2 = self.rec.images[image_id2]
        cam1 = self._camera_of(image_id1)
        cam2 = self._camera_of(image_id2)

        q1, t1 = self.init_pose_from_options(opts)
        if image_id1 in self.pose_priors:
            q1, t1 = self.pose_priors[image_id1]
        img1.qvec, img1.tvec = np.asarray(q1, np.float64), np.asarray(t1, np.float64)
        self.rec.bump_pose(image_id1)

        matches = self.graph.matches_between(image_id1, image_id2)
        if len(matches) < opts.init_min_num_inliers:
            return False
        self.init_num_reg_trials[image_id1] = self.init_num_reg_trials.get(image_id1, 0) + 1
        self.init_num_reg_trials[image_id2] = self.init_num_reg_trials.get(image_id2, 0) + 1

        # lidar depth association + world-frame ray-plane intersection
        feat_xy = img1.xys[matches[:, 0]].astype(np.float32)
        out = self.lidar_map.project_to_image(
            feat_xy,
            np.asarray(img1.qvec, np.float32),
            np.asarray(img1.tvec, np.float32),
            cam1.padded_params(),
            cam1.model_id,
            cam1.width,
            cam1.height,
        )
        planes = np_geom.plane_through(out["lidar_pt"], out["lidar_nrm"]).astype(np.float32)
        dev = self.device
        X, ok = pc_ops.ray_plane_points(
            torch.as_tensor(feat_xy, device=dev),
            torch.as_tensor(planes, device=dev),
            torch.as_tensor(out["found"], device=dev),
            torch.as_tensor(img1.qvec, dtype=torch.float32, device=dev),
            torch.as_tensor(img1.tvec, dtype=torch.float32, device=dev),
            torch.as_tensor(cam1.padded_params(), device=dev),
            cam1.model_id,
        )
        X, ok = X.cpu().numpy(), ok.cpu().numpy()
        sel = np.nonzero(ok)[0]
        if sel.size < max(opts.abs_pose_min_num_inliers, 6):
            return False

        # PnP for image2 on the lidar-depth points
        uv2 = img2.xys[matches[sel, 1]].astype(np.float32)
        n2 = np_geom.image_to_world(cam2.model_id, cam2.padded_params(), uv2).astype(np.float32)
        thr = opts.abs_pose_max_error / cam2.mean_focal_length()
        n_in2, q2_a, t2_a, inlier_mask = self._pnp(n2, X[sel], 0, thr, opts)
        if n_in2 < opts.abs_pose_min_num_inliers:
            return False
        img2.qvec = np.asarray(q2_a, np.float64)
        img2.tvec = np.asarray(t2_a, np.float64)
        self.rec.bump_pose(image_id2)
        # pose prior for image2 wins if present (reference :577-580)
        if image_id2 in self.pose_priors:
            img2.qvec, img2.tvec = (np.asarray(v, np.float64) for v in self.pose_priors[image_id2])
            self.rec.bump_pose(image_id2)

        self._register_image_event(image_id1)
        self._register_image_event(image_id2)
        self.last_registered_id = image_id2
        self.num_reg_trials[image_id1] = self.num_reg_trials.get(image_id1, 0) + 1
        self.num_reg_trials[image_id2] = self.num_reg_trials.get(image_id2, 0) + 1

        for k, si in enumerate(sel):
            if not inlier_mask[k]:
                continue
            f1, f2 = int(matches[si, 0]), int(matches[si, 1])
            if img1.point3D_ids[f1] != INVALID_POINT3D or img2.point3D_ids[f2] != INVALID_POINT3D:
                continue
            self.rec.add_point3D(X[si], [(image_id1, f1), (image_id2, f2)])
        # refine image2 pose against the created points
        self._refine_pose(image_id2, opts)
        return True

    def _two_view_geometry(self, opts: MapperOptions, image_id1: int, image_id2: int, matches,
                           watermark: bool):
        """Two-view geometry of an init candidate on the mapper's device;
        the watermark test needs the image sizes, which only the
        verification of a candidate passes (as in the JAX package)."""
        from . import two_view

        img1, img2 = self.rec.images[image_id1], self.rec.images[image_id2]
        cam1, cam2 = self._camera_of(image_id1), self._camera_of(image_id2)
        return two_view.estimate_two_view_geometry(
            img1.xys[matches[:, 0]].astype(np.float32),
            img2.xys[matches[:, 1]].astype(np.float32),
            cam1.padded_params(), cam2.padded_params(),
            cam1.model_id, cam2.model_id,
            two_view.TwoViewOptions(max_error=opts.init_max_error),
            size1=(cam1.width, cam1.height) if watermark else None,
            size2=(cam2.width, cam2.height) if watermark else None,
            device=self.device,
        )

    def register_initial_image_pair(self, opts: MapperOptions, image_id1: int, image_id2: int) -> bool:
        """Classic two-view init (RegisterInitialImagePair, :391): relative
        pose from the essential matrix, triangulate, |t|=1 gauge."""
        from . import two_view

        assert self.rec.num_reg_images == 0
        img1, img2 = self.rec.images[image_id1], self.rec.images[image_id2]
        cam1, cam2 = self._camera_of(image_id1), self._camera_of(image_id2)
        matches = self.graph.matches_between(image_id1, image_id2)
        if len(matches) < opts.init_min_num_inliers:
            return False
        self.init_num_reg_trials[image_id1] = self.init_num_reg_trials.get(image_id1, 0) + 1
        self.init_num_reg_trials[image_id2] = self.init_num_reg_trials.get(image_id2, 0) + 1
        key = (min(image_id1, image_id2), max(image_id1, image_id2))
        if self._prev_init_pair == key and self._prev_init_geometry is not None:
            # verified by find_initial_image_pair (:418 reuses the cache)
            g = self._prev_init_geometry
        else:
            g = self._two_view_geometry(opts, image_id1, image_id2, matches, watermark=False)
            if g.config != two_view.CALIBRATED or g.qvec is None:
                return False
            if len(g.inlier_matches) < opts.init_min_num_inliers:
                return False
            if g.tri_angle < math.radians(opts.init_min_tri_angle) / 4:
                return False
        img1.qvec = np.asarray([1.0, 0, 0, 0])
        img1.tvec = np.zeros(3)
        img2.qvec = np.asarray(g.qvec, np.float64)
        img2.tvec = np.asarray(g.tvec, np.float64)
        self.rec.bump_pose(image_id1)
        self.rec.bump_pose(image_id2)
        self._register_image_event(image_id1)
        self._register_image_event(image_id2)
        self.last_registered_id = image_id2
        # triangulate the inliers (host, float64 SVD per point)
        rows = g.inlier_matches[:, 0]
        n1 = np_geom.image_to_world(cam1.model_id, cam1.padded_params(), img1.xys[matches[rows, 0]])
        n2 = np_geom.image_to_world(cam2.model_id, cam2.padded_params(), img2.xys[matches[rows, 1]])
        P1 = np.concatenate([np_geom.quat_to_rotmat(img1.qvec), np.asarray(img1.tvec)[:, None]], axis=1)
        P2 = np.concatenate([np_geom.quat_to_rotmat(img2.qvec), np.asarray(img2.tvec)[:, None]], axis=1)
        rows4 = np.stack([
            n1[:, 0, None] * P1[2] - P1[0],
            n1[:, 1, None] * P1[2] - P1[1],
            n2[:, 0, None] * P2[2] - P2[0],
            n2[:, 1, None] * P2[2] - P2[1],
        ], axis=1)  # [N,4,4]
        _, _, vt = np.linalg.svd(rows4)
        Xh = vt[:, 3, :]
        w = np.where(np.abs(Xh[:, 3]) < 1e-12, 1e-12, Xh[:, 3])
        X = Xh[:, :3] / w[:, None]
        z1 = X[:, 2]  # cam1 at identity
        X2c = np_geom.se3_apply(img2.qvec, img2.tvec, X)
        good = (z1 > 0) & (X2c[:, 2] > 0) & np.isfinite(X).all(axis=1)
        for k in np.nonzero(good)[0]:
            f1, f2 = int(matches[rows[k], 0]), int(matches[rows[k], 1])
            if img1.point3D_ids[f1] == INVALID_POINT3D and img2.point3D_ids[f2] == INVALID_POINT3D:
                self.rec.add_point3D(X[k], [(image_id1, f1), (image_id2, f2)])
        return True

    # ------------------------------------------- multi-model lifecycle
    def begin_reconstruction(self, rec: Reconstruction):
        """Attach a (possibly fresh) model, keeping cross-trial state
        (BeginReconstruction, sfm/incremental_mapper.cc:124-160)."""
        from .visibility import VisibilityIndex

        self.rec = rec
        self.triangulator = IncrementalTriangulator(rec, self.graph)
        self.visibility = VisibilityIndex(rec, self.graph)
        self.num_reg_trials.clear()
        self.filtered_images.clear()
        self._proj_cache.clear()
        self.existing_image_ids = set(rec.registered_ids)
        self.last_registered_id = rec.registered_ids[-1] if rec.registered_ids else -1
        for iid in rec.registered_ids:
            self.num_registrations[iid] = self.num_registrations.get(iid, 0) + 1

    def end_reconstruction(self, discard: bool):
        """Release the model; on discard, decrement the shared registration
        counts so the images become available to later trials
        (EndReconstruction, sfm/incremental_mapper.cc:162-178)."""
        if discard:
            for iid in self.rec.registered_ids:
                self.num_registrations[iid] = self.num_registrations.get(iid, 1) - 1

    @property
    def _registered_set(self) -> set:
        # O(R) set of ints per call — trivial next to any per-image work
        return set(self.rec.registered_ids)

    def _register_image_event(self, image_id: int):
        """(RegisterImageEvent, :1916): register in the current model and bump
        the cross-model registration counter."""
        self.rec.register_image(image_id)
        self.num_registrations[image_id] = self.num_registrations.get(image_id, 0) + 1

    def num_shared_reg_images(self) -> int:
        """Images of the current model registered in other models too."""
        return sum(
            1
            for iid in self.rec.registered_ids
            if self.num_registrations.get(iid, 0) > 1
        )

    def num_total_reg_images(self) -> int:
        return sum(1 for v in self.num_registrations.values() if v > 0)

    # ---------------------------------------------------- init pair search
    def _find_first_initial_images(self, opts: MapperOptions) -> list[int]:
        """Ranked first-image candidates: prior-focal cameras first, then by
        correspondence count; skip over-tried or already-registered images
        (FindFirstInitialImage, sfm/incremental_mapper.cc:1606-1674)."""
        infos = []
        for iid in self.rec.images:
            nc = self.graph.num_correspondences_for_image(iid)
            if nc == 0:
                continue
            if self.init_num_reg_trials.get(iid, 0) >= opts.init_max_reg_trials:
                continue
            if self.num_registrations.get(iid, 0) > 0:
                continue
            prior = bool(getattr(self._camera_of(iid), "prior_focal", False))
            infos.append((not prior, -nc, iid))
        infos.sort()
        return [iid for _, _, iid in infos]

    def _find_second_initial_images(self, opts: MapperOptions, image_id1: int) -> list[int]:
        """Ranked partners of image_id1 with enough matches, not registered
        elsewhere (FindSecondInitialImage, :1676-1760)."""
        infos = []
        for iid2 in self.rec.images:
            if iid2 == image_id1 or self.num_registrations.get(iid2, 0) > 0:
                continue
            m = self.graph.num_matches(image_id1, iid2)
            if m < opts.init_min_num_inliers:
                continue
            prior = bool(getattr(self._camera_of(iid2), "prior_focal", False))
            infos.append((not prior, -m, iid2))
        infos.sort()
        return [iid for _, _, iid in infos]

    def estimate_initial_two_view_geometry(
        self, opts: MapperOptions, image_id1: int, image_id2: int
    ) -> bool:
        """Verify an init candidate pair: enough two-view inliers, bounded
        forward motion |t_z| < init_max_forward_motion, and sufficient
        triangulation angle (EstimateInitialTwoViewGeometry, :1947-2003).
        Caches the verified geometry for register_initial_image_pair."""
        from . import two_view

        key = (min(image_id1, image_id2), max(image_id1, image_id2))
        if self._prev_init_pair == key and self._prev_init_geometry is not None:
            return True
        matches = self.graph.matches_between(image_id1, image_id2)
        if len(matches) < opts.init_min_num_inliers:
            return False
        g = self._two_view_geometry(opts, image_id1, image_id2, matches, watermark=True)
        if g.config != two_view.CALIBRATED or g.qvec is None:
            return False
        if len(g.inlier_matches) < opts.init_min_num_inliers:
            return False
        if abs(float(g.tvec[2])) >= opts.init_max_forward_motion:
            return False
        if g.tri_angle <= math.radians(opts.init_min_tri_angle):
            return False
        self._prev_init_pair = key
        self._prev_init_geometry = g
        return True

    def find_initial_image_pair(self, opts: MapperOptions) -> tuple[int, int]:
        """(FindInitialImagePair, :215-287): enumerate ranked (first, second)
        candidates, skip pairs tried in earlier trials, and return the first
        pair passing the two-view verification gates."""
        if (
            opts.init_image_id1 in self.rec.images
            and opts.init_image_id2 in self.rec.images
            and opts.init_image_id2 > 0
        ):
            return opts.init_image_id1, opts.init_image_id2
        if opts.init_image_id1 in self.rec.images:
            ids1 = [opts.init_image_id1]
        else:
            ids1 = self._find_first_initial_images(opts)
        for id1 in ids1:
            for id2 in self._find_second_initial_images(opts, id1):
                key = (min(id1, id2), max(id1, id2))
                if key in self.init_image_pairs:
                    continue
                self.init_image_pairs.add(key)
                if opts.if_add_lidar_constraint and self.lidar_map is not None:
                    # depth-proj init does not need a verified relative pose;
                    # the forward-motion/tri-angle gates reject the dominant
                    # corridor motion this pipeline targets
                    # (RegisterInitialImagePairByDepthProj seeds scale from
                    # lidar, not from two-view parallax)
                    return id1, id2
                if self.estimate_initial_two_view_geometry(opts, id1, id2):
                    return id1, id2
        return -1, -1

    # ----------------------------------------------------------- registration
    def find_next_images(self, opts: MapperOptions) -> list[int]:
        """Rank unregistered images by visibility-pyramid score
        (FindNextImages, :299 + RankNextImageMinUncertainty) using the
        incrementally maintained VisibilityIndex — O(images) per call.
        Fresh images rank ahead of previously filtered/failed ones."""
        ranks, other_ranks = [], []
        for iid, img in self.rec.images.items():
            if img.registered:
                continue
            if self.visibility.num_visible_points3D(iid) < opts.abs_pose_min_num_inliers:
                continue
            trials = self.num_reg_trials.get(iid, 0)
            if trials >= opts.max_reg_trials:
                continue
            score = self.visibility.score(iid)
            if iid not in self.filtered_images and trials == 0:
                ranks.append((score, iid))
            else:
                other_ranks.append((score, iid))
        ranks.sort(key=lambda s: -s[0])
        other_ranks.sort(key=lambda s: -s[0])
        return [iid for _, iid in ranks] + [iid for _, iid in other_ranks]

    def _search_2d3d(self, image_id: int):
        """Batched 2D-3D correspondence search (RegisterNextImage :770-823):
        for every feature of image_id, collect the distinct triangulated 3D
        points seen by its correspondences in registered images. Fully
        vectorized over the CSR graph."""
        img = self.rec.images[image_id]
        nf = img.xys.shape[0]
        if nf == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        # restrict the query to features the visibility index knows can see
        # a triangulated point (cheap superset filter)
        feats = self.visibility.visible_features(image_id)
        if feats.size == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        qid, nimg, nfeat = self.graph.find_batch(image_id, feats)
        if qid.size == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        # group the correspondences by neighbor image and gather pids from the
        # live per-image arrays — O(covisible images) per call, instead of
        # rebuilding a flat table over ALL registered images (the r2 profile
        # showed that rebuild at 60% of register wall at 450-image scale)
        reg_set = self._registered_set
        pid = np.full(qid.shape, INVALID_POINT3D, np.int64)
        order = np.argsort(nimg, kind="stable")
        uniq, starts = np.unique(nimg[order], return_index=True)
        bounds = np.append(starts, nimg.shape[0])
        for k, u in enumerate(uniq):
            if int(u) not in reg_set:
                continue
            rows = order[bounds[k] : bounds[k + 1]]
            pid[rows] = self.rec.images[int(u)].point3D_ids[nfeat[rows]]
        ok = pid != INVALID_POINT3D
        sel = np.nonzero(ok)[0]
        if sel.size == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        # dedup (feature, pid) pairs
        fidx = feats[qid[sel]]
        key = (fidx << 44) | pid[sel]
        ukey = np.unique(key)
        return ukey >> 44, ukey & ((1 << 44) - 1)

    def register_next_image(self, opts: MapperOptions, image_id: int) -> bool:
        """(RegisterNextImage, :706-964)."""
        img = self.rec.images[image_id]
        cam = self._camera_of(image_id)
        self.num_reg_trials[image_id] = self.num_reg_trials.get(image_id, 0) + 1

        # 2D-3D correspondence search over the graph (:770-823)
        tri_feat_arr, tri_pid_arr = self._search_2d3d(image_id)
        if tri_feat_arr.size < opts.abs_pose_min_num_inliers:
            return False
        n_tri = tri_feat_arr.size
        pts3D = self.rec.points3D
        uv = img.xys[tri_feat_arr].astype(np.float32)
        X = np.asarray([pts3D[p].xyz for p in tri_pid_arr.tolist()], np.float32)
        nuv = np_geom.image_to_world(cam.model_id, cam.padded_params(), uv).astype(np.float32)
        thr = opts.abs_pose_max_error / cam.mean_focal_length()
        # RANSAC + Cauchy-GN pose polish (RegisterNextImage's
        # EstimateAbsolutePose + RefineAbsolutePose, :824-868)
        n_in, q_a, t_a, mask_a = self._pnp(nuv, X, image_id, thr, opts)
        if n_in < opts.abs_pose_min_num_inliers:
            return False
        if n_in < opts.abs_pose_min_inlier_ratio * n_tri:
            return False
        img.qvec = np.asarray(q_a, np.float64)
        img.tvec = np.asarray(t_a, np.float64)
        self.rec.bump_pose(image_id)
        # pose prior injection (:737-750): prior overrides PnP when available
        has_prior = image_id in self.pose_priors
        if has_prior:
            img.qvec, img.tvec = (np.asarray(v, np.float64) for v in self.pose_priors[image_id])
            self.rec.bump_pose(image_id)

        self._register_image_event(image_id)
        self.last_registered_id = image_id
        # continue tracks for inliers (:930-960) — vectorized candidate
        # filtering, add_observation only on the accepted rows
        inl = np.nonzero(mask_a)[0]
        f_sel = tri_feat_arr[inl]
        p_sel = tri_pid_arr[inl]
        free = img.point3D_ids[f_sel] == INVALID_POINT3D
        for fidx, pid in zip(f_sel[free].tolist(), p_sel[free].tolist()):
            if img.point3D_ids[fidx] == INVALID_POINT3D and pid in pts3D:
                self.rec.add_observation(pid, image_id, fidx)
        if has_prior:
            # PnP's fused polish refined the estimated pose; a prior replaces
            # it after the fact, so polish around the prior separately
            self._refine_pose(image_id, opts)
        return True

    def _refine_pose(self, image_id: int, opts: MapperOptions):
        """RefineAbsolutePose: pose-only BA on this image's observations."""
        img = self.rec.images[image_id]
        cam = self._camera_of(image_id)
        fidx = np.nonzero(img.point3D_ids != INVALID_POINT3D)[0]
        if fidx.size < 6:
            return
        pids = img.point3D_ids[fidx]
        pts = np.stack([self.rec.points3D[int(p)].xyz for p in pids]).astype(np.float32)
        uv = img.xys[fidx].astype(np.float32)
        prob = ba_ops.make_problem(
            np.asarray(img.qvec, np.float32)[None],
            np.asarray(img.tvec, np.float32)[None],
            cam.padded_params(),
            pts,
            np.zeros(fidx.size, np.int32),
            np.arange(fidx.size, dtype=np.int32),
            uv,
            point_fixed=np.ones(fidx.size, np.float32),
            track_len=1,
            device=self.device,
        )
        cfg = ba_ops.BAConfig(
            model_id=cam.model_id, max_iterations=20,
            loss_type=ba_ops.LOSS_CAUCHY, loss_scale=opts.abs_pose_max_error / 3.0,
        )
        out = ba_ops.solve(prob, cfg)
        PHASES.count("ba_solves", 1)
        PHASES.count("ba_lm_syncs", out.host_syncs)
        init_c, fin_c, q, t = (
            x.cpu().numpy() for x in (out.initial_cost, out.final_cost, out.cam_q[0], out.cam_t[0])
        )
        if fin_c <= init_c:
            img.qvec = np.asarray(q, np.float64)
            img.tvec = np.asarray(t, np.float64)
            self.rec.bump_pose(image_id)

    # -------------------------------------------------------------- local BA
    def find_local_bundle(self, opts: MapperOptions, image_id: int) -> list[int]:
        """Most-covisible registered images with the reference's full 8-stage
        (tri-angle, shared-count) relaxation ladder (FindLocalBundle,
        sfm/incremental_mapper.cc:1747-1914): candidates ordered by shared
        observations; each stage admits candidates whose 75th-percentile
        triangulation angle (over the new image's 3D points, against the
        candidate's center — the reference computes angles over ALL of the
        image's points, :1858-1864) clears angle/k AND whose shared count
        clears frac*num_points3D; remaining slots fill as stages relax.
        Selects local_ba_num_images - 1 neighbors (:1782)."""
        img = self.rec.images[image_id]
        shared_count: dict[int, int] = {}
        xyz_list: list[np.ndarray] = []
        pts3D = self.rec.points3D
        for fidx in np.nonzero(img.point3D_ids != INVALID_POINT3D)[0]:
            pid = int(img.point3D_ids[fidx])
            p = pts3D.get(pid)
            if p is None:
                continue
            xyz_list.append(p.xyz)
            for iid, _ in p.track:
                if iid != image_id and self.rec.images[iid].registered:
                    shared_count[iid] = shared_count.get(iid, 0) + 1
        ranked = sorted(shared_count.items(), key=lambda kv: -kv[1])
        n_want = min(max(opts.local_ba_num_images - 1, 0), len(ranked))
        if len(ranked) == n_want:
            return [iid for iid, _ in ranked]
        num_pts = len(xyz_list)
        xyz = np.asarray(xyz_list)
        min_angle = math.radians(opts.local_ba_min_tri_angle)
        C_new = img.projection_center()
        d1 = C_new[None, :] - xyz
        n1 = np.linalg.norm(d1, axis=1)
        ladder = [
            (min_angle / 1.0, 0.6 * num_pts), (min_angle / 1.5, 0.6 * num_pts),
            (min_angle / 2.0, 0.5 * num_pts), (min_angle / 2.5, 0.4 * num_pts),
            (min_angle / 3.0, 0.3 * num_pts), (min_angle / 4.0, 0.2 * num_pts),
            (min_angle / 5.0, 0.1 * num_pts), (min_angle / 6.0, 0.1 * num_pts),
        ]
        tri_angle = [-1.0] * len(ranked)
        used = [False] * len(ranked)
        selected: list[int] = []
        for ang_thr, cnt_thr in ladder:
            for k, (iid, cnt) in enumerate(ranked):
                if cnt < cnt_thr:
                    break
                if used[k]:
                    continue
                if tri_angle[k] < 0.0:
                    C2 = self.rec.images[iid].projection_center()
                    d2 = C2[None, :] - xyz
                    denom = n1 * np.linalg.norm(d2, axis=1)
                    cosang = np.einsum("ij,ij->i", d1, d2) / np.maximum(denom, 1e-12)
                    angles = np.arccos(np.clip(cosang, -1.0, 1.0))
                    tri_angle[k] = float(np.percentile(angles, 75)) if angles.size else 0.0
                if tri_angle[k] >= ang_thr:
                    selected.append(iid)
                    used[k] = True
                    if len(selected) >= n_want:
                        break
            if len(selected) >= n_want:
                break
        return selected

    def adjust_local_bundle(
        self, opts: MapperOptions, image_id: int, point3D_ids: set[int]
    ) -> LocalBAReport:
        report = LocalBAReport()
        with PHASES.phase("find_local_bundle"):
            local_bundle = self.find_local_bundle(opts, image_id)
        if not local_bundle:
            return report
        bundle_images = [image_id] + local_bundle

        pose_fixed_ids: set[int] = set()
        if (
            opts.if_add_lidar_constraint
            and opts.init_image_id1 in bundle_images
            and self.rec.num_reg_images < opts.first_image_fixed_frames
        ):
            pose_fixed_ids.add(opts.init_image_id1)
        if opts.fix_existing_images:
            pose_fixed_ids |= {i for i in bundle_images if i in self.existing_image_ids}

        tvec_fixed: dict[int, list[int]] = {}
        if not opts.if_add_lidar_constraint:
            # classic 7-DoF gauge fix (:1084-1100)
            if len(local_bundle) == 1:
                pose_fixed_ids.add(local_bundle[0])
                tvec_fixed[image_id] = [0]
            else:
                pose_fixed_ids.add(local_bundle[-1])
                tvec_fixed[local_bundle[-2]] = [0]

        # variable points: modified points with bounded track length (:1106-1135)
        max_track = 1000 if opts.if_add_lidar_constraint else 15
        variable_pids, proj_pids, icp_pids = [], [], []
        for pid in point3D_ids:
            p = self.rec.points3D.get(pid)
            if p is None:
                continue
            if len(p.track) <= max_track:
                variable_pids.append(pid)
                if opts.if_add_lidar_constraint:
                    if len(p.track) < opts.min_proj_num + 3:
                        proj_pids.append(pid)
                    else:
                        icp_pids.append(pid)

        # lidar associations (:1140-1170)
        if self.lidar_map is not None and (
            opts.if_add_lidar_constraint or opts.if_add_lidar_corresponding
        ):
            with PHASES.phase("lidar_assoc_proj"):
                self._match_variable_points_to_lidar(proj_pids, image_id, opts)
            # per-call cost of the two association paths scales with these
            PHASES.count("lidar_proj_pts", len(proj_pids))
            PHASES.count("lidar_icp_pts", len(icp_pids))
            ranges = [
                max(
                    opts.kdtree_max_search_range
                    - self.rec.points3D[pid].global_opt_num * opts.search_range_drop_speed,
                    opts.kdtree_min_search_range,
                )
                for pid in icp_pids
            ]
            with PHASES.phase("lidar_assoc_icp"):
                self._match_closest_lidar_points(icp_pids, ranges)

        with PHASES.phase("local_ba_solve"):
            self._solve_ba(
                opts,
                bundle_images,
                set(variable_pids),
                pose_fixed_ids,
                tvec_fixed,
                max_iterations=opts.ba_local_max_num_iterations,
                lidar_assocs=self.rec.lidar_points if opts.if_add_lidar_constraint else {},
            )
        report.num_adjusted_observations = sum(
            len(self.rec.points3D[p].track) for p in variable_pids if p in self.rec.points3D
        )

        tri_opts = TriangulatorOptions(
            complete_max_reproj_error=opts.filter_max_reproj_error / 2,
            merge_max_reproj_error=opts.filter_max_reproj_error / 2,
            min_angle=opts.filter_min_tri_angle,
        )
        with PHASES.phase("track_merge_complete"):
            report.num_merged_observations = self.triangulator.merge_tracks(tri_opts, variable_pids)
            report.num_completed_observations = self.triangulator.complete_tracks(tri_opts, variable_pids)
            report.num_completed_observations += self.triangulator.complete_image(tri_opts, image_id)

        with PHASES.phase("filter_points"):
            report.num_filtered_observations = self.rec.filter_points3D(
                opts.filter_max_reproj_error, opts.filter_min_tri_angle, list(point3D_ids)
            )
        if opts.if_add_lidar_constraint:
            with PHASES.phase("lidar_outlier_filter"):
                report.num_filtered_observations += self.rec.filter_lidar_outliers(
                    opts.proj_max_dist_error, opts.icp_max_dist_error
                )
        return report

    # ------------------------------------------------------------- global BA
    def adjust_global_bundle_by_lidar(self, opts: MapperOptions) -> bool:
        """(AdjustGlobalBundleByLidar, :1297-1493)."""
        reg = list(self.rec.registered_ids)
        if len(reg) < 2:
            return False
        # sphere center = most recently registered image, tracked explicitly
        # (registration order and registered_ids list order can diverge after
        # resume-from-model)
        newest = self.last_registered_id if self.last_registered_id in self.rec.images and self.rec.images[self.last_registered_id].registered else reg[-1]
        c_new = self.rec.images[newest].projection_center()
        variable_imgs, const_imgs = [], []
        for iid in reg:
            c = self.rec.images[iid].projection_center()
            if np.linalg.norm(c - c_new) <= opts.ba_spherical_search_radius:
                variable_imgs.append(iid)
            else:
                const_imgs.append(iid)
        pose_fixed_ids = set(const_imgs)
        if (
            opts.init_image_id1 in variable_imgs
            and self.rec.num_reg_images < opts.first_image_fixed_frames
        ):
            pose_fixed_ids.add(opts.init_image_id1)

        # points observed by variable images -> variable + NN association
        # (vectorized: one unique over the concatenated id arrays, not a
        # Python loop over every feature of every in-sphere image)
        all_ids = np.concatenate(
            [self.rec.images[iid].point3D_ids for iid in variable_imgs]
        )
        uniq = np.unique(all_ids[all_ids != INVALID_POINT3D])
        variable_pids = set()
        for pid in uniq:
            p = self.rec.points3D.get(int(pid))
            if p is not None:
                variable_pids.add(int(pid))
                p.in_sphere = True

        self.rec.clear_lidar_points_in_global()
        pids = sorted(variable_pids)
        if self.lidar_map is not None and opts.if_add_lidar_constraint and pids:
            ranges = [
                max(
                    opts.kdtree_max_search_range
                    - self.rec.points3D[p].global_opt_num * opts.search_range_drop_speed,
                    opts.kdtree_min_search_range,
                )
                for p in pids
            ]
            # global associations go into the dedicated map
            saved = dict(self.rec.lidar_points)
            self.rec.lidar_points = {}
            self._match_closest_lidar_points(pids, ranges)
            self.rec.lidar_points_in_global = self.rec.lidar_points
            self.rec.lidar_points = saved

        # remember the variable set: in-loop refinement filtering only needs
        # to re-check points the solve could have moved
        self.last_global_variable_pids = set(variable_pids)
        self._solve_ba(
            opts,
            variable_imgs,
            variable_pids,
            pose_fixed_ids,
            {},
            max_iterations=opts.ba_global_max_num_iterations,
            lidar_assocs=self.rec.lidar_points_in_global if opts.if_add_lidar_constraint else {},
            variable_obs_only=True,
        )
        # bump global_opt_num (:1483-1487)
        for pid in self.rec.lidar_points_in_global:
            if pid in self.rec.points3D:
                self.rec.points3D[pid].global_opt_num += 1
        return True

    def adjust_global_bundle(self, opts: MapperOptions) -> bool:
        """Classic global BA (:1225-1285): gauge fixed by first pose + one
        translation component of the second."""
        reg = list(self.rec.registered_ids)
        if len(reg) < 2:
            return False
        self._solve_ba(
            opts,
            reg,
            set(self.rec.points3D.keys()),
            {reg[0]},
            {reg[1]: [0]},
            max_iterations=opts.ba_global_max_num_iterations,
            lidar_assocs={},
        )
        return True

    # ------------------------------------------------------- BA construction
    def _solve_ba(
        self,
        opts: MapperOptions,
        bundle_images: list[int],
        variable_pids: set[int],
        pose_fixed_ids: set[int],
        tvec_fixed: dict[int, list[int]],
        max_iterations: int,
        lidar_assocs: dict[int, LidarAssoc],
        refine_intrinsics: bool = False,
        refine_focal: bool = True,
        refine_principal: bool = False,
        refine_extra: bool = True,
        variable_obs_only: bool = False,
    ):
        """Build the BAProblem at the data's size (every image, point and
        observation in it, the longest track as its table width) and run
        the device solve, then write results back into the reconstruction.

        variable_obs_only=True restricts even bundle images to observations of
        variable points — the spherical global BA semantics, where
        AddImageInSphereToProblem skips points with IfInSphere()==false
        (optim/bundle_adjustment.cc:694-806). This bounds the global problem
        by the sphere rather than the whole scene.
        """
        rec = self.rec
        with PHASES.phase("ba_assemble"):
            bundle_set = set(bundle_images)
            # collect observations, vectorized per image: bundle images observe
            # all their points (unless variable_obs_only); other registered images
            # contribute only their observations of variable points and enter with
            # fixed poses (AddImageToProblem/AddPointToProblem semantics)
            img_ids: list[int] = list(bundle_images)
            var_arr = np.fromiter(variable_pids, np.int64, len(variable_pids))
            var_arr.sort()
            obs_iid_parts, obs_pid_parts, obs_uv_parts = [], [], []
            for iid in bundle_images:
                img = rec.images[iid]
                f = np.nonzero(img.point3D_ids != INVALID_POINT3D)[0]
                if f.size and variable_obs_only and var_arr.size:
                    pids_f = img.point3D_ids[f]
                    pos = np.searchsorted(var_arr, pids_f)
                    isvar = (pos < var_arr.size) & (
                        var_arr[np.minimum(pos, var_arr.size - 1)] == pids_f
                    )
                    f = f[isvar]
                if f.size:
                    obs_iid_parts.append(np.full(f.size, iid, np.int64))
                    obs_pid_parts.append(img.point3D_ids[f])
                    obs_uv_parts.append(img.xys[f])
            # out-of-bundle observations of variable points: scan every other
            # registered image with the same vectorized searchsorted filter
            # (equivalent to walking the variable tracks, without the per-
            # observation Python steps)
            if var_arr.size:
                for iid in rec.registered_ids:
                    if iid in bundle_set:
                        continue
                    img = rec.images[iid]
                    f = np.nonzero(img.point3D_ids != INVALID_POINT3D)[0]
                    if f.size == 0:
                        continue
                    pids_f = img.point3D_ids[f]
                    pos = np.searchsorted(var_arr, pids_f)
                    isvar = (pos < var_arr.size) & (
                        var_arr[np.minimum(pos, var_arr.size - 1)] == pids_f
                    )
                    f = f[isvar]
                    if f.size == 0:
                        continue
                    img_ids.append(iid)
                    pose_fixed_ids = pose_fixed_ids | {iid}
                    obs_iid_parts.append(np.full(f.size, iid, np.int64))
                    obs_pid_parts.append(img.point3D_ids[f])
                    obs_uv_parts.append(img.xys[f])
            if not obs_pid_parts:
                return
            obs_iid = np.concatenate(obs_iid_parts)
            obs_pid_arr = np.concatenate(obs_pid_parts)
            obs_uv_all = np.concatenate(obs_uv_parts).astype(np.float32)
            img_slot = {iid: k for k, iid in enumerate(img_ids)}
            uniq_pids, obs_pt_slots = np.unique(obs_pid_arr, return_inverse=True)
            pids_in_problem = {int(pid): s for s, pid in enumerate(uniq_pids)}

            C = len(img_ids)
            T = int(np.bincount(obs_pt_slots).max())

            cam_q = np.zeros((C, 4), np.float32)
            cam_t = np.zeros((C, 3), np.float32)
            pose_fixed = np.zeros(C, np.float32)
            tvf = np.zeros((C, 3), np.float32)
            for iid, k in img_slot.items():
                img = rec.images[iid]
                cam_q[k] = img.qvec
                cam_t[k] = img.tvec
                pose_fixed[k] = 1.0 if iid in pose_fixed_ids else 0.0
                for comp in tvec_fixed.get(iid, []):
                    tvf[k, comp] = 1.0

            pts3D = rec.points3D
            points = np.asarray([pts3D[int(p)].xyz for p in uniq_pids], np.float32)
            point_fixed = np.ones(uniq_pids.size, np.float32)
            lidar_plane = np.zeros((uniq_pids.size, 4), np.float32)
            lidar_w = np.zeros(uniq_pids.size, np.float32)
            if var_arr.size:
                pos = np.searchsorted(var_arr, uniq_pids)
                isvar = (pos < var_arr.size) & (var_arr[np.minimum(pos, var_arr.size - 1)] == uniq_pids)
                point_fixed = np.where(isvar, 0.0, 1.0).astype(np.float32)
            w_of_type = {
                LIDAR_PROJ: opts.proj_lidar_constraint_weight,
                LIDAR_ICP: opts.icp_lidar_constraint_weight,
                LIDAR_ICP_GROUND: opts.icp_ground_lidar_constraint_weight,
            }
            for pid, a in lidar_assocs.items():
                s = pids_in_problem.get(int(pid))
                if s is not None and point_fixed[s] == 0.0:
                    lidar_plane[s] = a.plane
                    lidar_w[s] = w_of_type[a.type]

            # per-camera intrinsics slots (bundle_adjustment.cc:1047-1100
            # ParameterizeCameras semantics: every camera its own parameter block)
            cam_ids = [rec.images[iid].camera_id for iid in img_ids]
            uniq_cams = sorted(set(cam_ids))
            cam_slot_of = {cid: k for k, cid in enumerate(uniq_cams)}
            intr = np.stack([rec.cameras[c].padded_params() for c in uniq_cams])
            model_ids = tuple(sorted({rec.cameras[c].model_id for c in uniq_cams}))
            cam_model = np.asarray(
                [model_ids.index(rec.cameras[c].model_id) for c in uniq_cams], np.int32
            )
            cam_k = np.asarray([cam_slot_of[c] for c in cam_ids], np.int32)

            uniq_iids, inv_iid = np.unique(obs_iid, return_inverse=True)
            slot_lookup = np.asarray([img_slot[int(i)] for i in uniq_iids], np.int32)
            obs_cam = slot_lookup[inv_iid]

            # compact the reduced camera system to the VARIABLE cameras: fixed
            # poses contribute nothing (their jacobians are zeroed) and map to
            # block 0, so the Schur system scales with the in-sphere/bundle
            # variable count — not the total registered-camera count (the point
            # of spherical windowing, sfm/incremental_mapper.cc:1349-1388)
            var = pose_fixed == 0.0
            n_var = int(var.sum())
            if 0 < n_var < C:
                num_pose_blocks = n_var
                cam_blk = np.where(var, np.cumsum(var) - 1, 0)
            else:
                num_pose_blocks = 0  # identity layout
                cam_blk = np.arange(C)

            # numpy fields; uploaded whole here, or per shard by dist_ba
            prob = ba_ops.host_problem(
                cam_q, cam_t, intr, points,
                obs_cam, obs_pt_slots, obs_uv_all,
                cam_k=cam_k, cam_model=cam_model, cam_blk=cam_blk, track_len=T,
                lidar_plane=lidar_plane, lidar_w=lidar_w,
                pose_fixed=pose_fixed, tvec_fixed=tvf, point_fixed=point_fixed,
            )
            if self.dist_mesh is None:
                prob = ba_ops.to_device(prob, self.device)
            cfg = ba_ops.BAConfig(
                num_pose_blocks=num_pose_blocks,
                model_id=model_ids[0],
                model_ids=model_ids,
                loss_type=opts.loss_type,
                loss_scale=opts.loss_scale,
                max_iterations=max_iterations,
                refine_intrinsics=refine_intrinsics,
                refine_focal=refine_focal,
                refine_principal=refine_principal,
                refine_extra=refine_extra,
                # chunk sizing: ~2^24 (point, track slot, pose block) entries
                # per Schur reduction chunk (~64 MB) — a handful of large
                # chunks instead of hundreds of tiny ones
                point_chunk=int(np.clip((1 << 24) // (T * (num_pose_blocks or C)), 32, 4096)),
            )
        with PHASES.phase("ba_device"):
            if self.dist_mesh is not None:
                from ..parallel import dist_ba

                out = dist_ba.solve_distributed(prob, cfg, self.dist_mesh)
            else:
                out = ba_ops.solve(prob, cfg)
            q_out, t_out, intr_out, p_out, init_c, fin_c = (
                x.cpu().numpy()
                for x in (out.cam_q, out.cam_t, out.intr, out.points,
                          out.initial_cost, out.final_cost)
            )
        PHASES.count("ba_solves", 1)
        PHASES.count("ba_lm_syncs", out.host_syncs)
        if not np.isfinite(float(fin_c)) or float(fin_c) > float(init_c):
            return
        q_out = np.asarray(q_out, np.float64)
        t_out = np.asarray(t_out, np.float64)
        for iid, k in img_slot.items():
            if iid not in pose_fixed_ids:
                rec.images[iid].qvec = q_out[k]
                rec.images[iid].tvec = t_out[k]
                rec.bump_pose(iid)
        if refine_intrinsics:
            # per-camera write-back of each refined intrinsics slot
            new_params = np.asarray(intr_out, np.float64)
            for cid, k in cam_slot_of.items():
                cam = rec.cameras[cid]
                n = len(cam.params)
                cam.params = new_params[k, :n].copy()
                rec.bump_camera_params(cid)
        p_out = np.asarray(p_out, np.float64)
        free = np.nonzero(point_fixed == 0.0)[0]
        for s in free:
            pid = int(uniq_pids[s])
            if pid in pts3D:
                pts3D[pid].xyz = p_out[s]

    # -------------------------------------------------------------- filtering
    def filter_points(self, opts: MapperOptions, point_ids=None) -> int:
        return self.rec.filter_points3D(
            opts.filter_max_reproj_error, opts.filter_min_tri_angle,
            point_ids=point_ids,
        )

    def filter_images(self, opts: MapperOptions) -> int:
        """Deregister images with bogus cameras or too few 3D points
        (FilterImages, reconstruction.cc)."""
        n = 0
        for iid in list(self.rec.registered_ids):
            img = self.rec.images[iid]
            cam = self.rec.cameras[img.camera_id]
            if cam.has_bogus_params(
                opts.min_focal_length_ratio, opts.max_focal_length_ratio, opts.max_extra_param
            ) or img.num_points3D() == 0:
                self.rec.deregister_image(iid)
                self.num_registrations[iid] = self.num_registrations.get(iid, 1) - 1
                self.filtered_images.add(iid)
                n += 1
        return n
