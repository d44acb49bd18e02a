"""Pipeline controllers: the register->triangulate->BA loop, batch BA.

A copy of colmap_pcd_tpu/models/controllers.py (host logic only; the every-5
global-BA cadence and the scoped track sweeps are unchanged).

Parity with src/controllers/:
  * IncrementalMapperController (incremental_mapper.cc:442-901): load data,
    initialize (lidar-seeded or classic), then the per-image hot loop with
    iterative local refinement and threshold-gated global refinement,
    snapshots, and the final global refinement.
  * BundleAdjustmentController (bundle_adjustment.cc:76-204): whole-map BA
    with fresh NN lidar associations per point (the GUI "Bundle adjustment"
    button / `bundle_adjuster` CLI path).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

from ..utils.logging_utils import PHASES

import numpy as np

from .correspondence_graph import CorrespondenceGraph
from .incremental_mapper import IncrementalMapper, MapperOptions
from .lidar_map import LidarMap
from .reconstruction import (
    INVALID_POINT3D,
    LIDAR_ICP,
    LIDAR_ICP_GROUND,
    LidarAssoc,
    Reconstruction,
    save_image_poses,
)


@dataclass
class ControllerOptions:
    """IncrementalMapperOptions controller-level fields
    (controllers/incremental_mapper.h:140-220)."""

    min_num_matches: int = 15
    multiple_models: bool = True
    max_num_models: int = 50
    max_model_overlap: int = 20
    min_model_size: int = 10
    init_num_trials: int = 200
    ba_local_max_refinements: int = 2
    ba_local_max_refinement_change: float = 0.001
    ba_global_max_refinements: int = 5
    ba_global_max_refinement_change: float = 0.0005
    ba_global_images_ratio: float = 1.1
    ba_global_points_ratio: float = 1.1
    # the lidar fork HARD-CADENCES global (spherical) BA to every 5 newly
    # registered images (controllers/incremental_mapper.h:182 — upstream
    # COLMAP uses 500); the frequent lidar-constrained global refinement is
    # its primary drift corrector at scale, and with 500 the r5 450-image
    # run drifted to 39 mm ATE on the ratio-only cadence
    ba_global_images_freq: int = 5
    ba_global_points_freq: int = 250000
    # final whole-map rounds: re-run iterative global refinement at model
    # completion with the spherical window lifted (all poses variable) —
    # recovers drift the moving 40 m sphere froze into early trajectory
    final_wholemap_rounds: int = 1
    snapshot_path: str = ""
    snapshot_images_freq: int = 0
    image_pose_save_folder: str = ""
    image_path: str = ""  # when set, per-registration color extraction runs
    extract_colors: bool = True
    verbose: bool = True


@dataclass
class MapperState:
    num_img_last_global_ba: int = 2
    num_pts_last_global_ba: int = 0


class IncrementalMapperController:
    """Drives IncrementalMapper through a full reconstruction."""

    def __init__(
        self,
        rec: Reconstruction,
        graph: CorrespondenceGraph,
        mapper_options: MapperOptions = None,
        controller_options: ControllerOptions = None,
        lidar_map: LidarMap | None = None,
        pose_priors=None,
        pair_feed=None,
        device=None,
    ):
        self.rec = rec
        self.base_rec = rec  # pristine dataset skeleton for multi-model trials
        self.graph = graph
        self.opts = mapper_options or MapperOptions()
        self.copts = controller_options or ControllerOptions()
        self.mapper = IncrementalMapper(rec, graph, lidar_map, pose_priors, device)
        self.state = MapperState()
        self._imgs_at_last_global: set[int] = set()
        self.callbacks = []  # called after each registration
        # overlapped frontend (models/overlap.py): verified pairs and images
        # stream in WHILE mapping runs; drained at the loop top
        self.pair_feed = pair_feed

    def _log(self, msg: str):
        if self.copts.verbose:
            import sys

            print(f"[mapper] {msg}", file=sys.stderr, flush=True)

    # ------------------------------------------------------------------
    def _initialize_status(self, init_opts: MapperOptions | None = None) -> str:
        """Find/verify an init pair and register it. init_opts carries the
        (possibly relaxed) initialization thresholds. Returns one of
        "ok" | "no_pair" | "reg_failed" | "empty" — the reference's three
        distinct bail-outs (controllers/incremental_mapper.cc:649-735)."""
        with PHASES.phase("initialize"):
            opts = init_opts or self.opts
            id1, id2 = self.mapper.find_initial_image_pair(opts)
            if id1 < 0 or id2 < 0:
                self._log("no viable initial image pair (empty database or no matches)")
                return "no_pair"
            self._log(f"initializing with image pair ({id1}, {id2})")
            if opts.if_add_lidar_constraint and self.mapper.lidar_map is not None:
                ok = self.mapper.register_initial_image_pair_by_depth_proj(opts, id1, id2)
            else:
                ok = self.mapper.register_initial_image_pair(opts, id1, id2)
            if not ok:
                self._log("initialization failed")
                return "reg_failed"
            self._log(
                f"initialized: {len(self.rec.points3D)} points, "
                f"{self.rec.num_reg_images} images"
            )
            full = self.opts
            if full.if_add_lidar_constraint:
                self.mapper.adjust_global_bundle_by_lidar(full)
            else:
                self.mapper.adjust_global_bundle(full)
            self.mapper.filter_points(full)
            self.mapper.filter_images(full)
            if self.rec.num_reg_images == 0 or len(self.rec.points3D) == 0:
                return "empty"
            if self.copts.image_path and self.copts.extract_colors:
                # color the init-pair points (ExtractColors after init,
                # controllers/incremental_mapper.cc:713 region)
                for iid in list(self.rec.registered_ids):
                    self.rec.extract_colors_for_image(iid, self.copts.image_path)
            return "ok"

    def initialize(self, init_opts: MapperOptions | None = None) -> bool:
        return self._initialize_status(init_opts) == "ok"

    def iterative_local_refinement(self, image_id: int):
        """(:106-148): repeat local BA while it keeps changing things."""
        opts = self.opts
        for _ in range(self.copts.ba_local_max_refinements):
            # modified points = points observed by this image
            img = self.rec.images[image_id]
            pids = {
                int(p)
                for p in img.point3D_ids[img.point3D_ids != INVALID_POINT3D]
                if int(p) in self.rec.points3D
            }
            report = self.mapper.adjust_local_bundle(opts, image_id, pids)
            changed = (
                report.num_merged_observations
                + report.num_completed_observations
                + report.num_filtered_observations
            )
            denom = max(report.num_adjusted_observations, 1)
            if changed / denom < self.copts.ba_local_max_refinement_change:
                break

    def iterative_global_refinement(self, full: bool = True):
        """(:150-180): complete+merge, then repeated global BA + filtering.

        full=False scopes the CompleteAndMergeTracks sweep to the points
        observed by images registered since the last global round (plus their
        merge partners found transitively by merge_tracks itself): the lidar
        fork cadences global refinement to EVERY 5 registrations
        (incremental_mapper.h:182), and a full sweep over all tracks at that
        frequency re-examined the same long-settled points ~100x per run
        (195 s of the r5 450-image wall). Ratio-triggered rounds and the
        final refinement keep the full sweep, so every point is still
        periodically revisited — the same local/global split the spherical
        BA itself applies."""
        opts = self.opts
        if full:
            tri_opts_pids = list(self.rec.points3D.keys())
        else:
            recent = [
                iid for iid in self.rec.registered_ids
                if iid not in self._imgs_at_last_global
            ]
            pids = set()
            for iid in recent:
                img = self.rec.images[iid]
                from .reconstruction import INVALID_POINT3D

                for p in img.point3D_ids[img.point3D_ids != INVALID_POINT3D]:
                    pids.add(int(p))
            tri_opts_pids = [p for p in pids if p in self.rec.points3D]
        from .triangulator import TriangulatorOptions

        topts = TriangulatorOptions(min_angle=opts.filter_min_tri_angle)
        with PHASES.phase("global_track_complete_merge"):
            self.mapper.triangulator.complete_tracks(topts, tri_opts_pids)
            self.mapper.triangulator.merge_tracks(topts, tri_opts_pids)
        with PHASES.phase("retriangulate"):
            # revisit under-reconstructed pairs before the BA rounds
            # (IterativeGlobalRefinement, controllers/incremental_mapper.cc:
            # 150-180: CompleteAndMergeTracks -> Retriangulate -> BA loop);
            # repeated global rounds make this the reference's multi-pass
            # retriangulation — the prime drift corrector at scale
            self.mapper.triangulator.retriangulate(topts)
        for round_i in range(self.copts.ba_global_max_refinements):
            with PHASES.phase("global_ba_solve"):
                if opts.if_add_lidar_constraint:
                    self.mapper.adjust_global_bundle_by_lidar(opts)
                else:
                    self.mapper.adjust_global_bundle(opts)
            with PHASES.phase("global_filter"):
                # round 0 filters the whole scene (track complete/merge above
                # can have changed any point); later rounds only re-check the
                # points the spherical solve could have moved — exact, since
                # every point observed by a variable camera IS variable
                subset = None
                if round_i > 0 and opts.if_add_lidar_constraint:
                    subset = sorted(
                        getattr(self.mapper, "last_global_variable_pids", None) or []
                    ) or None
                n_changed = self.mapper.filter_points(opts, point_ids=subset)
            n_obs = sum(len(p.track) for p in self.rec.points3D.values())
            if n_changed / max(n_obs, 1) < self.copts.ba_global_max_refinement_change:
                break
        self.state.num_img_last_global_ba = self.rec.num_reg_images
        self.state.num_pts_last_global_ba = len(self.rec.points3D)
        self._imgs_at_last_global = set(self.rec.registered_ids)

    def _check_global_refinement(self) -> bool:
        s = self.state
        return (
            self.rec.num_reg_images >= self.copts.ba_global_images_ratio * s.num_img_last_global_ba
            or self.rec.num_reg_images >= self.copts.ba_global_images_freq + s.num_img_last_global_ba
            or len(self.rec.points3D) >= self.copts.ba_global_points_ratio * s.num_pts_last_global_ba
            or len(self.rec.points3D) >= self.copts.ba_global_points_freq + s.num_pts_last_global_ba
        )

    def _global_refinement_is_full(self) -> bool:
        """True when a ratio/points trigger fired (scene grew materially) —
        those rounds sweep all tracks; pure every-5-images cadence rounds
        scope to recently-touched points (see iterative_global_refinement)."""
        s = self.state
        return (
            self.rec.num_reg_images >= self.copts.ba_global_images_ratio * s.num_img_last_global_ba
            or len(self.rec.points3D) >= self.copts.ba_global_points_ratio * s.num_pts_last_global_ba
            or len(self.rec.points3D) >= self.copts.ba_global_points_freq + s.num_pts_last_global_ba
        )

    def drain_feed(self) -> int:
        """Pull newly extracted images + verified pairs from the overlapped
        frontend into the live reconstruction/graph (models/overlap.py).
        Returns the number of new pairs ingested."""
        if self.pair_feed is None:
            return 0
        from .reconstruction import Image as RecImage

        imgs, cams, pairs = self.pair_feed.drain()
        for cid, c in cams.items():
            if cid not in self.rec.cameras:
                from .reconstruction import Camera

                self.rec.add_camera(
                    Camera(cid, c["model_id"], c["width"], c["height"], c["params"],
                           prior_focal=bool(c.get("prior_focal", False)))
                )
        for iid, name, cam_id, xys in imgs:
            if iid not in self.rec.images:
                self.rec.add_image(
                    RecImage(iid, name, cam_id, xys=np.asarray(xys, np.float64))
                )
                self.graph.add_image(iid, len(xys))
        n = 0
        for i, j, m in pairs:
            if len(m) >= self.copts.min_num_matches:
                self.graph.add_matches(i, j, m)
                # replay late matches into the next-image ranking
                self.mapper.visibility.on_matches_added(i, j, m)
                n += 1
        return n

    def _incremental_loop(self):
        """The per-image registration hot loop with the last-rescue global
        refinement and the multi-model overlap break
        (controllers/incremental_mapper.cc:744-869)."""
        from .triangulator import TriangulatorOptions

        opts = self.opts
        topts = TriangulatorOptions(min_angle=opts.filter_min_tri_angle)
        t0 = time.time()
        reg_next_success, prev_reg_next_success = True, True
        while reg_next_success:
            reg_next_success = False
            self.drain_feed()
            with PHASES.phase("next_image_ranking"):
                next_images = self.mapper.find_next_images(opts)
            if not next_images:
                # the frontend may still be producing registrable images
                if self.pair_feed is not None and not self.pair_feed.done:
                    time.sleep(0.2)
                    reg_next_success = True
                    continue
                break
            for reg_trial, image_id in enumerate(next_images):
                self._log(
                    f"registering image #{image_id} "
                    f"({self.rec.num_reg_images + 1}) "
                    f"[{self.rec.num_reg_images / max(time.time() - t0, 1e-9):.2f} reg/s]"
                )
                with PHASES.phase("register_next_image"):
                    reg_next_success = self.mapper.register_next_image(opts, image_id)
                if reg_next_success:
                    self.mapper.clear_lidar_points()
                    with PHASES.phase("triangulate_image"):
                        self.mapper.triangulator.triangulate_image(topts, image_id)
                    with PHASES.phase("local_refinement"):
                        self.iterative_local_refinement(image_id)
                    if self._check_global_refinement():
                        full = self._global_refinement_is_full()
                        with PHASES.phase("global_refinement"):
                            self.iterative_global_refinement(full=full)
                    if self.copts.image_path and self.copts.extract_colors:
                        # per-registration point coloring (ExtractColors,
                        # controllers/incremental_mapper.cc:205-214,734)
                        with PHASES.phase("extract_colors"):
                            self.rec.extract_colors_for_image(
                                image_id, self.copts.image_path
                            )
                    if (
                        self.copts.snapshot_path
                        and self.copts.snapshot_images_freq > 0
                        and self.rec.num_reg_images % self.copts.snapshot_images_freq == 0
                    ):
                        self.write_snapshot()
                    for cb in self.callbacks:
                        cb(image_id)
                    break
                # abandon a model that cannot grow past the minimum size
                # after many failed trials (kMinNumInitialRegTrials, :845)
                if (
                    reg_trial >= 30
                    and self.rec.num_reg_images < self.copts.min_model_size
                ):
                    return
            if self.mapper.num_shared_reg_images() >= self.copts.max_model_overlap:
                return
            # last-rescue: one global refinement buys one more attempt (:862)
            if not reg_next_success and prev_reg_next_success:
                reg_next_success = True
                prev_reg_next_success = False
                with PHASES.phase("global_refinement"):
                    self.iterative_global_refinement()
            else:
                prev_reg_next_success = reg_next_success

    def _finish_model(self):
        """Final global refinement + pose export for the current model.

        On top of the reference's closing IterativeGlobalRefinement, run
        final rounds with the spherical window LIFTED: during mapping the
        40 m sphere (AdjustGlobalBundleByLidar) freezes drift into any part
        of the trajectory it has moved past — one whole-map lidar-constrained
        solve at the end re-opens every pose (PCG tier engages automatically
        above 1024 pose blocks)."""
        if (
            self.rec.num_reg_images >= 2
            and self.rec.num_reg_images != self.state.num_img_last_global_ba
        ):
            with PHASES.phase("final_global_refinement"):
                self.iterative_global_refinement()
        if self.rec.num_reg_images >= 2 and self.copts.final_wholemap_rounds > 0:
            import dataclasses

            saved = self.opts
            try:
                self.opts = dataclasses.replace(
                    saved, ba_spherical_search_radius=1e12
                )
                for _ in range(self.copts.final_wholemap_rounds):
                    with PHASES.phase("final_wholemap_refinement"):
                        self.iterative_global_refinement()
            finally:
                self.opts = saved
        if self.copts.image_pose_save_folder:
            os.makedirs(self.copts.image_pose_save_folder, exist_ok=True)
            save_image_poses(
                os.path.join(self.copts.image_pose_save_folder, "pose.ply"), self.rec
            )
        self._log(
            f"done: {self.rec.num_reg_images} images, {len(self.rec.points3D)} points, "
            f"mean track {self.rec.mean_track_length():.2f}"
        )

    def _wait_for_init_feed(self, timeout: float = 900.0):
        """Overlapped frontend: block until the init pair (or a workable set
        of matched images) has streamed in before attempting initialization."""
        id1, id2 = self.opts.init_image_id1, self.opts.init_image_id2
        t0 = time.time()
        while time.time() - t0 < timeout:
            self.drain_feed()
            if id2 > 0:
                ready = (
                    id1 in self.rec.images and id2 in self.rec.images
                    and len(self.graph.matches_between(id1, id2)) >= self.copts.min_num_matches
                )
            else:
                ready = len(self.rec.images) >= 8 and any(
                    True for _ in self.graph.image_pairs()
                )
            if ready or self.pair_feed.done:
                return
            time.sleep(0.2)

    def reconstruct(self) -> bool:
        """Single-model main loop (Reconstruct,
        controllers/incremental_mapper.cc:591) on the controller's own rec."""
        if self.pair_feed is not None:
            self._wait_for_init_feed()
        if self.rec.num_reg_images == 0 and not self.initialize():
            return False
        self._incremental_loop()
        self._finish_model()
        return True

    def _reconstruct_trials(self, init_opts, manager) -> None:
        """The init_num_trials loop over candidate initial pairs, producing
        models in `manager` (Reconstruct, :591-901)."""
        from .reconstruction_manager import clone_skeleton

        initial_given = manager.size() > 0
        assert manager.size() <= 1, "can only resume from a single model"
        num_images = len(self.base_rec.images)
        pinned_pair = (
            init_opts.init_image_id1 in self.base_rec.images
            and init_opts.init_image_id2 in self.base_rec.images
            and init_opts.init_image_id2 > 0
        )
        for trial in range(self.copts.init_num_trials):
            if not initial_given or trial > 0:
                rec = clone_skeleton(self.base_rec)
                idx = manager.add(rec)
            else:
                idx = 0
                rec = manager.get(0)
            self.rec = rec
            self.mapper.begin_reconstruction(rec)
            self.state = MapperState()
            if rec.num_reg_images == 0:
                status = self._initialize_status(init_opts)
                if status != "ok":
                    self.mapper.end_reconstruction(discard=True)
                    manager.delete(idx)
                    if status == "no_pair" or pinned_pair:
                        # pairs exhausted at these thresholds (or a manual
                        # pair, :725) — relaxation (run()) is the next lever
                        break
                    # reg_failed/empty: the pair is recorded in
                    # init_image_pairs, so the next trial picks a new one.
                    # (The reference breaks on reg_failed; we keep searching —
                    # its FindInitialImagePair verification makes post-find
                    # failures rare, but the depth-proj path skips
                    # verification, so retrying is the robust equivalent.)
                    continue
            self._incremental_loop()
            self._finish_model()
            min_model_size = min(num_images, self.copts.min_model_size)
            if (
                self.copts.multiple_models and rec.num_reg_images < min_model_size
            ) or rec.num_reg_images == 0:
                self.mapper.end_reconstruction(discard=True)
                manager.delete(idx)
            else:
                self.mapper.end_reconstruction(discard=False)
            if (
                initial_given
                or not self.copts.multiple_models
                or manager.size() >= self.copts.max_num_models
                or self.mapper.num_total_reg_images() >= num_images - 1
            ):
                break

    def run(self, manager=None):
        """Top-level Run (controllers/incremental_mapper.cc:442-493): try the
        full reconstruction; on total failure relax the init constraints
        (halve init_min_num_inliers, then init_min_tri_angle) and retry.
        Returns the ReconstructionManager with all surviving models."""
        import copy

        from .reconstruction_manager import ReconstructionManager

        if manager is None:
            manager = ReconstructionManager()
            if self.rec.num_reg_images > 0:
                manager.add(self.rec)  # resume from an existing model
        init_opts = copy.deepcopy(self.opts)
        self._reconstruct_trials(init_opts, manager)
        for _ in range(2):  # kNumInitRelaxations
            if manager.size() > 0:
                break
            self._log("relaxing the initialization constraints (inliers/2)")
            init_opts.init_min_num_inliers //= 2
            self._reconstruct_trials(init_opts, manager)
            if manager.size() > 0:
                break
            self._log("relaxing the initialization constraints (tri_angle/2)")
            init_opts.init_min_tri_angle /= 2
            self._reconstruct_trials(init_opts, manager)
        best = manager.best_index()
        if best >= 0:
            self.rec = manager.get(best)
        return manager

    def write_snapshot(self):
        path = os.path.join(
            self.copts.snapshot_path, time.strftime("%Y%m%d-%H%M%S")
        )
        self.rec.write(path)


class BundleAdjustmentController:
    """Whole-map batch BA with fresh lidar associations
    (controllers/bundle_adjustment.cc:76-204)."""

    def __init__(
        self,
        rec: Reconstruction,
        mapper_options: MapperOptions = None,
        lidar_map: LidarMap | None = None,
        refine_intrinsics: bool = False,
        refine_extrinsics: bool = True,
        device=None,
    ):
        self.rec = rec
        self.opts = mapper_options or MapperOptions()
        self.lidar_map = lidar_map
        self.device = device
        self.refine_intrinsics = refine_intrinsics
        self.refine_extrinsics = refine_extrinsics

    def run(self) -> bool:

        from .incremental_mapper import IncrementalMapper

        opts = self.opts
        rec = self.rec
        if rec.num_reg_images < 2:
            return False
        rec.clear_lidar_points()
        mapper = IncrementalMapper(rec, CorrespondenceGraph(), self.lidar_map, device=self.device)

        if self.lidar_map is not None and opts.if_add_lidar_constraint:
            # per-point NN with gates dist2plane > 1 | dist2point > 2 dropped
            # (bundle_adjustment.cc:127-179)
            pids = sorted(rec.points3D.keys())
            pts = np.stack([rec.points3D[p].xyz for p in pids]).astype(np.float32)
            from ..ops import np_geom

            lpts, lnrs, dists = self.lidar_map.nn_query(pts)
            planes = np_geom.plane_through(lpts, lnrs)
            ground = np_geom.classify_ground(lnrs)
            for i, pid in enumerate(pids):
                d2plane = abs(float(np.dot(planes[i, :3], pts[i]) + planes[i, 3]))
                if d2plane > 1.0 or dists[i] > 2.0:
                    continue
                typ = LIDAR_ICP_GROUND if ground[i] else LIDAR_ICP
                rec.add_lidar_point(pid, LidarAssoc(typ, np.asarray(lpts[i], np.float64), planes[i]))

        pose_fixed: set[int] = set()
        tvec_fixed: dict[int, list[int]] = {}
        if not self.refine_extrinsics:
            # BundleAdjustmentOptions.refine_extrinsics=false: freeze all
            # poses (calibration-only refinement)
            pose_fixed = set(rec.registered_ids)
        elif not (self.lidar_map is not None and opts.if_add_lidar_constraint):
            reg = rec.registered_ids
            pose_fixed = {reg[0]}
            tvec_fixed = {reg[1]: [0]}

        mapper._solve_ba(
            opts,
            list(rec.registered_ids),
            set(rec.points3D.keys()),
            pose_fixed,
            tvec_fixed,
            max_iterations=opts.ba_global_max_num_iterations * 2,
            lidar_assocs=rec.lidar_points,
            refine_intrinsics=self.refine_intrinsics,
        )
        rec.update_point_errors()
        return True
