"""Incremental triangulation: new tracks, track completion, merging,
retriangulation.

Parity with src/sfm/incremental_triangulator.{h,cc} (1,136 LoC): per newly
registered image, walk its features' correspondences in the graph; continue
existing tracks or create new points by (multi-)view DLT, gated by
triangulation angle and reprojection error. CompleteTracks retries failed
observations after BA moved things; MergeTracks joins tracks connected by
correspondences when the merged point explains both; Retriangulate revisits
under-reconstructed image pairs.

Triangulation and the graph walking are host-side numpy bookkeeping
(ops/np_geom); reconstruction state is only mutated from the mapper thread.

CompleteTracks, CompleteImage and MergeTracks walk the graph point by point
(or feature by feature), and almost everything they visit finds nothing to
do. Each walk therefore starts with an exact array screen: one batched pass
over the correspondences of its whole set, on the state as the walk starts,
flags the ids the walk can change, and the walk runs, in its own order and
with its own gates, over those alone (the argument for each screen is at
its `_screen_*` method).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops import np_geom
from ..utils.logging_utils import PHASES
from .correspondence_graph import FEAT_BITS
from .reconstruction import INVALID_POINT3D, Reconstruction

# Relative room on a reprojection gate in the screens, and depth room (in
# the model's units) on its cheirality test: the screens batch their
# projections otherwise than the walks do, so a last-bit difference can only
# add an id to a flagged set, never drop one.
SCREEN_GATE_SLACK = 1e-9
SCREEN_DEPTH_SLACK = 1e-6


@dataclass
class TriangulatorOptions:
    """Mirrors IncrementalTriangulator::Options (incremental_triangulator.h:46-74)."""

    max_transitivity: int = 1
    create_max_angle_error: float = 2.0  # deg
    continue_max_angle_error: float = 2.0  # deg
    merge_max_reproj_error: float = 4.0  # px
    complete_max_reproj_error: float = 4.0  # px
    min_angle: float = 1.5  # deg, min triangulation angle for new points
    ignore_two_view_tracks: bool = False
    min_focal_length_ratio: float = 0.1
    max_focal_length_ratio: float = 10.0
    max_extra_param: float = 1.0
    # retriangulation (incremental_triangulator.h:65-73)
    re_max_angle_error: float = 5.0  # deg: relaxed continue gate
    re_min_ratio: float = 0.2  # only pairs with tri ratio below this
    re_max_trials: int = 1  # retriangulation attempts per pair


class IncrementalTriangulator:
    def __init__(self, rec: Reconstruction, graph):
        self.rec = rec
        self.graph = graph
        # per-pair retriangulation trial counters (re_num_trials_,
        # incremental_triangulator.h:155)
        self.re_num_trials: dict[tuple[int, int], int] = {}

    # ------------------------------------------------------------------
    def _normalized(self, image_id: int, feat_idx: int) -> np.ndarray:
        img = self.rec.images[image_id]
        cam = self.rec.cameras[img.camera_id]
        return np_geom.image_to_world(cam.model_id, cam.padded_params(), img.xys[feat_idx])

    def _reproj_error(self, image_id: int, feat_idx: int, xyz: np.ndarray) -> float:
        img = self.rec.images[image_id]
        cam = self.rec.cameras[img.camera_id]
        xy, z = np_geom.project(cam.model_id, cam.padded_params(), img.qvec, img.tvec, xyz)
        if z <= 0:
            return np.inf
        return float(np.linalg.norm(xy - img.xys[feat_idx]))

    # ------------------------------------------------------------------
    def triangulate_image(self, options: TriangulatorOptions, image_id: int) -> int:
        """Create/continue tracks for all features of a registered image.
        Returns number of added observations (TriangulateImage,
        incremental_triangulator.cc).

        Batched re-design for the default transitivity<=1 path: per-pair
        matches are 1:1 (cross-checked), so distinct features of this image
        have disjoint correspondence sets and the reference's sequential
        per-feature loop is equivalent to one vectorized partition pass +
        one batched continuation reprojection test + per-track-length
        batched multiview DLTs (numpy batch SVD) — the same math with the
        per-point python/SVD overhead amortized across every new point."""
        img = self.rec.images[image_id]
        if not img.registered:
            return 0
        if options.max_transitivity > 1:
            return self._triangulate_image_transitive(options, image_id)
        free = np.nonzero(img.point3D_ids == INVALID_POINT3D)[0]
        if free.size == 0:
            return 0
        qid, nbr_img, nbr_feat = self.graph.find_batch(image_id, free)
        if qid.size == 0:
            return 0
        q_feat = free[qid]

        reg, pid_row = self._neighbour_pids(nbr_img, nbr_feat)

        num_tris = 0
        order = np.argsort(q_feat, kind="stable")
        qs_f = q_feat[order]
        starts = np.nonzero(np.r_[True, qs_f[1:] != qs_f[:-1]])[0]
        bounds = np.r_[starts, qs_f.size]
        has_pid = reg & (pid_row != INVALID_POINT3D)

        # --- continuation: features with a triangulated registered corr ----
        cont_feats: list[int] = []
        cont_pids: list[int] = []
        handled: set[int] = set()
        for s, e in zip(bounds[:-1], bounds[1:]):
            f = int(qs_f[s])
            rows = order[s:e]
            pids = pid_row[rows][has_pid[rows]]
            if pids.size:
                # continue the most common existing track if reprojection fits
                handled.add(f)
                vals, counts = np.unique(pids, return_counts=True)
                pid = int(vals[np.argmax(counts)])
                if pid in self.rec.points3D:
                    cont_feats.append(f)
                    cont_pids.append(pid)
        if cont_feats:
            cam = self.rec.cameras[img.camera_id]
            xyz = np.stack([self.rec.points3D[p].xyz for p in cont_pids])
            xy, z = np_geom.project(
                cam.model_id, cam.padded_params(), img.qvec, img.tvec, xyz
            )
            errs = np.linalg.norm(xy - img.xys[np.asarray(cont_feats)], axis=-1)
            okm = (z > 0) & (errs < options.complete_max_reproj_error)
            for f, pid, ok in zip(cont_feats, cont_pids, okm):
                if ok:
                    self.rec.add_observation(pid, image_id, int(f))
                    num_tris += 1

        # --- creation: registered corrs present, none triangulated ---------
        creations: list[list[tuple[int, int]]] = []
        for s, e in zip(bounds[:-1], bounds[1:]):
            f = int(qs_f[s])
            if f in handled:
                continue
            rows = order[s:e]
            cand_rows = rows[reg[rows] & (pid_row[rows] == INVALID_POINT3D)]
            if cand_rows.size == 0:
                continue
            if options.ignore_two_view_tracks and cand_rows.size < 2:
                continue
            creations.append(
                [(image_id, f)]
                + [(int(nbr_img[r]), int(nbr_feat[r])) for r in cand_rows]
            )
        num_tris += self._create_points_batched(options, creations)
        return num_tris

    def _create_points_batched(self, options: TriangulatorOptions, creations) -> int:
        """Batched multiview DLT + gates for many candidate points, grouped
        by view count T so every group is one [K,2T,4] batch SVD."""
        if not creations:
            return 0
        num = 0
        by_T: dict[int, list] = {}
        for views in creations:
            by_T.setdefault(len(views), []).append(views)
        for T, group in sorted(by_T.items()):
            K = len(group)
            qs = np.empty((K, T, 4), np.float64)
            ts = np.empty((K, T, 3), np.float64)
            xys = np.empty((K, T, 2), np.float64)
            cams = np.empty((K, T), np.int64)
            for k, views in enumerate(group):
                for j, (iid, fidx) in enumerate(views):
                    im = self.rec.images[iid]
                    qs[k, j] = im.qvec
                    ts[k, j] = im.tvec
                    xys[k, j] = im.xys[fidx]
                    cams[k, j] = im.camera_id
            uvn = np.empty((K, T, 2), np.float64)
            for cid in np.unique(cams):
                cam = self.rec.cameras[int(cid)]
                m = cams == cid
                uvn[m] = np_geom.image_to_world(cam.model_id, cam.padded_params(), xys[m])
            R = np_geom.quat_to_rotmat(qs)  # [K,T,3,3]
            P = np.concatenate([R, ts[..., None]], axis=-1)  # [K,T,3,4]
            r0 = uvn[..., 0][..., None] * P[:, :, 2, :] - P[:, :, 0, :]
            r1 = uvn[..., 1][..., None] * P[:, :, 2, :] - P[:, :, 1, :]
            A = np.concatenate([r0, r1], axis=1)  # [K,2T,4]
            _, _, vt = np.linalg.svd(A)
            Xh = vt[:, -1]
            w = np.where(np.abs(Xh[:, 3]) > 1e-12, Xh[:, 3], 1e-12)
            X = Xh[:, :3] / w[:, None]
            finite = np.isfinite(X).all(axis=1)
            X = np.where(finite[:, None], X, 0.0)
            # triangulation-angle gate: max pairwise angle >= min_angle
            C = np_geom.projection_center(
                qs.reshape(-1, 4), ts.reshape(-1, 3)
            ).reshape(K, T, 3)
            d = C - X[:, None]
            dn = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
            cosang = np.clip(np.einsum("kti,kui->ktu", dn, dn), -1.0, 1.0)
            iu = np.triu_indices(T, 1)
            max_ang = np.arccos(cosang[:, iu[0], iu[1]]).max(axis=-1)
            ang_ok = max_ang >= np.deg2rad(options.min_angle)
            # reprojection gate per view; keep passing views only
            err = np.empty((K, T))
            zs = np.empty((K, T))
            Xrep = np.broadcast_to(X[:, None], (K, T, 3))
            for cid in np.unique(cams):
                cam = self.rec.cameras[int(cid)]
                m = cams == cid
                xy, z = np_geom.project(
                    cam.model_id, cam.padded_params(), qs[m], ts[m], Xrep[m]
                )
                err[m] = np.linalg.norm(xy - xys[m], axis=-1)
                zs[m] = z
            good = (err < options.complete_max_reproj_error) & (zs > 0)
            for k, views in enumerate(group):
                if not (finite[k] and ang_ok[k] and good[k, 0]):
                    continue
                sel = [v for j, v in enumerate(views) if good[k, j]]
                if len(sel) < 2:
                    continue
                self.rec.add_point3D(X[k], sel)
                num += len(sel)
        return num

    def _triangulate_image_transitive(
        self, options: TriangulatorOptions, image_id: int
    ) -> int:
        """Sequential per-feature path for max_transitivity > 1 (BFS
        correspondences cannot be batched per image)."""
        img = self.rec.images[image_id]
        num_tris = 0
        for feat_idx in range(img.xys.shape[0]):
            if img.point3D_ids[feat_idx] != INVALID_POINT3D:
                continue
            corrs = self.graph.find_transitive_correspondences(
                image_id, feat_idx, options.max_transitivity
            )
            # partition correspondences
            existing_pids = []
            candidates = []  # (image_id, feat_idx) registered, untriangulated
            for cid, cfeat in corrs:
                cimg = self.rec.images.get(cid)
                if cimg is None or not cimg.registered:
                    continue
                pid = int(cimg.point3D_ids[cfeat])
                if pid != INVALID_POINT3D:
                    existing_pids.append(pid)
                else:
                    candidates.append((cid, cfeat))
            if existing_pids:
                # continue the most common existing track if reprojection fits
                pid = max(set(existing_pids), key=existing_pids.count)
                if pid in self.rec.points3D:
                    err = self._reproj_error(image_id, feat_idx, self.rec.points3D[pid].xyz)
                    if err < options.complete_max_reproj_error:
                        self.rec.add_observation(pid, image_id, feat_idx)
                        num_tris += 1
                continue
            if not candidates:
                continue
            if options.ignore_two_view_tracks and len(candidates) < 2:
                continue
            # triangulate a new point from this feature + candidates
            views = [(image_id, feat_idx)] + candidates
            num_tris += self._try_create_point(options, views)
        return num_tris

    def _try_create_point(self, options: TriangulatorOptions, views) -> int:
        qs, ts, uvs, centers = [], [], [], []
        for iid, fidx in views:
            im = self.rec.images[iid]
            qs.append(np.asarray(im.qvec, np.float32))
            ts.append(np.asarray(im.tvec, np.float32))
            uvs.append(self._normalized(iid, fidx))
            centers.append(im.projection_center())
        T = len(views)
        # host-side multiview DLT (numpy SVD on a [2T,4] matrix — far cheaper
        # than an eager device roundtrip per candidate point)
        Rt = [np.concatenate([np_geom.quat_to_rotmat(q), t[:, None]], axis=1) for q, t in zip(qs, ts)]
        rows = []
        for P, uv in zip(Rt, uvs):
            rows.append(uv[0] * P[2] - P[0])
            rows.append(uv[1] * P[2] - P[1])
        A = np.stack(rows)
        _, _, vt = np.linalg.svd(A)
        Xh = vt[-1]
        w = Xh[3] if abs(Xh[3]) > 1e-12 else 1e-12
        X = Xh[:3] / w
        if not np.isfinite(X).all():
            return 0
        # triangulation angle gate: max pairwise angle must exceed min_angle
        max_ang = 0.0
        for a in range(T):
            for b in range(a + 1, T):
                ang = float(np_geom.triangulation_angle(centers[a], centers[b], X))
                max_ang = max(max_ang, ang)
        if max_ang < np.deg2rad(options.min_angle):
            return 0
        # reprojection gate per view; keep passing views only
        good = []
        for iid, fidx in views:
            if self._reproj_error(iid, fidx, X) < options.complete_max_reproj_error:
                good.append((iid, fidx))
        if len(good) < 2 or good[0] != views[0]:
            return 0
        self.rec.add_point3D(X, good)
        return len(good)

    # ------------------------------------------------------------------
    def complete_tracks(self, options: TriangulatorOptions, point3D_ids) -> int:
        """Extend tracks with correspondences that now reproject well
        (CompleteTracks, incremental_triangulator.h:114)."""
        n = 0
        point3D_ids = list(point3D_ids)
        flagged = self._screen_complete_tracks(options, point3D_ids)
        for pid in point3D_ids:
            if pid not in flagged:
                continue
            p = self.rec.points3D.get(pid)
            if p is None:
                continue
            frontier = list(p.track)
            seen = set(p.track)
            while frontier:
                iid, fidx = frontier.pop()
                cands = []
                for cid, cfeat in self.graph.find_correspondences(iid, fidx):
                    if (cid, cfeat) in seen:
                        continue
                    seen.add((cid, cfeat))
                    cimg = self.rec.images.get(cid)
                    if cimg is None or not cimg.registered:
                        continue
                    if cimg.point3D_ids[cfeat] != INVALID_POINT3D:
                        continue
                    cands.append((cid, cfeat))
                if not cands:
                    continue
                # one vectorized reprojection check for all candidates of
                # this observation (they usually share one camera)
                errs = self._reproj_errors(cands, p.xyz)
                for (cid, cfeat), e in zip(cands, errs):
                    if e < options.complete_max_reproj_error:
                        self.rec.add_observation(pid, cid, cfeat)
                        frontier.append((cid, cfeat))
                        n += 1
        return n

    def _reproj_errors(self, obs_list, xyz):
        """Vectorized reprojection errors for [(image_id, feat_idx), ...]."""
        errs = np.empty(len(obs_list))
        by_cam: dict[int, list[int]] = {}
        for k, (iid, _) in enumerate(obs_list):
            by_cam.setdefault(self.rec.images[iid].camera_id, []).append(k)
        for cam_id, rows in by_cam.items():
            cam = self.rec.cameras[cam_id]
            qv = np.stack([self.rec.images[obs_list[k][0]].qvec for k in rows])
            tv = np.stack([self.rec.images[obs_list[k][0]].tvec for k in rows])
            uv = np.stack(
                [self.rec.images[obs_list[k][0]].xys[obs_list[k][1]] for k in rows]
            )
            xy, z = np_geom.project(
                cam.model_id, cam.padded_params()[None, :], qv, tv, xyz[None, :]
            )
            e = np.linalg.norm(xy - uv, axis=-1)
            e = np.where(z <= 0, np.inf, e)
            for j, k in enumerate(rows):
                errs[k] = e[j]
        return errs

    def complete_image(self, options: TriangulatorOptions, image_id: int) -> int:
        """Try to continue existing tracks into this image's free features."""
        img = self.rec.images[image_id]
        if not img.registered:
            return 0
        n = 0
        for feat_idx in self._screen_complete_image(options, image_id):
            if img.point3D_ids[feat_idx] != INVALID_POINT3D:
                continue
            for cid, cfeat in self.graph.find_correspondences(image_id, feat_idx):
                cimg = self.rec.images.get(cid)
                if cimg is None or not cimg.registered:
                    continue
                pid = int(cimg.point3D_ids[cfeat])
                if pid == INVALID_POINT3D or pid not in self.rec.points3D:
                    continue
                if self._reproj_error(image_id, feat_idx, self.rec.points3D[pid].xyz) < options.complete_max_reproj_error:
                    self.rec.add_observation(pid, image_id, feat_idx)
                    n += 1
                    break
        return n

    def merge_tracks(self, options: TriangulatorOptions, point3D_ids) -> int:
        """Merge connected tracks when the merged point explains both
        (MergeTracks, incremental_triangulator.h:123)."""
        n = 0
        point3D_ids = list(point3D_ids)
        flagged = self._screen_merge_tracks(point3D_ids)
        for pid in point3D_ids:
            if pid not in flagged:
                continue
            p = self.rec.points3D.get(pid)
            if p is None:
                continue
            merge_target = None
            for iid, fidx in p.track:
                for cid, cfeat in self.graph.find_correspondences(iid, fidx):
                    cimg = self.rec.images.get(cid)
                    if cimg is None or not cimg.registered:
                        continue
                    opid = int(cimg.point3D_ids[cfeat])
                    if opid != INVALID_POINT3D and opid != pid and opid in self.rec.points3D:
                        merge_target = opid
                        break
                if merge_target:
                    break
            if merge_target is None:
                continue
            q = self.rec.points3D[merge_target]
            n1, n2 = len(p.track), len(q.track)
            merged_xyz = (p.xyz * n1 + q.xyz * n2) / (n1 + n2)
            if self._tracks_reproject_ok(
                p.track + q.track, merged_xyz, options.merge_max_reproj_error
            ):
                self.rec.merge_points3D(pid, merge_target)
                n += n1 + n2
        return n

    def _tracks_reproject_ok(self, track, xyz, max_err: float) -> bool:
        """Vectorized 'all observations reproject within max_err' test (the
        merge acceptance check runs over every candidate pair each global
        round — per-observation scalar projection calls dominate it)."""
        by_cam: dict[int, list] = {}
        for iid, fidx in track:
            img = self.rec.images[iid]
            by_cam.setdefault(img.camera_id, []).append((img, fidx))
        for cam_id, obs in by_cam.items():
            cam = self.rec.cameras[cam_id]
            qv = np.stack([img.qvec for img, _ in obs])
            tv = np.stack([img.tvec for img, _ in obs])
            uv = np.stack([img.xys[f] for img, f in obs])
            xy, z = np_geom.project(cam.model_id, cam.padded_params()[None, :], qv, tv, xyz[None, :])
            if np.any(z <= 0):
                return False
            if np.any(np.linalg.norm(xy - uv, axis=-1) >= max_err):
                return False
        return True

    # ------------------------------------------------------------------
    # Screens: one array pass each, on the state as its walk starts.

    def _live_table(self) -> np.ndarray:
        """Bool table over point ids, True for those in points3D; it spans
        every id an image carries."""
        rec = self.rec
        keys = np.fromiter(rec.points3D.keys(), np.int64, len(rec.points3D))
        top = max(
            [int(keys.max(initial=0))]
            + [int(im.point3D_ids.max(initial=0)) for im in rec.images.values()]
        )
        live = np.zeros(top + 1, bool)
        live[keys] = True
        return live

    def _neighbour_pids(self, nbr_img, nbr_feat):
        """(registered, point id) of each neighbour feature, one gather a
        neighbour image; the id is INVALID_POINT3D where the image is not
        registered."""
        nbr_reg = np.zeros(nbr_img.size, bool)
        nbr_pid = np.full(nbr_img.size, INVALID_POINT3D, np.int64)
        for cid, rows in _groups(nbr_img):
            cimg = self.rec.images.get(cid)
            if cimg is None or not cimg.registered:
                continue
            nbr_reg[rows] = True
            nbr_pid[rows] = cimg.point3D_ids[nbr_feat[rows]]
        return nbr_reg, nbr_pid

    def _track_correspondences(self, point3D_ids, live: np.ndarray):
        """Every correspondence of every observation of the points of
        `point3D_ids` in the model, from one batched graph lookup. The
        observations come from the images' point3D_ids, one mask an image.

        Returns (n_points, pid, nbr_img, nbr_feat, nbr_reg, nbr_pid): the
        number of distinct points screened, then per correspondence the
        observing point, the neighbour feature, and its state as
        `_neighbour_pids` gives it."""
        ids = np.asarray(point3D_ids, np.int64).reshape(-1)
        ids = ids[(ids >= 0) & (ids < live.size)]
        wanted = np.zeros(live.size, bool)
        wanted[ids] = live[ids]
        obs_pid, obs_key = [], []
        for iid, im in self.rec.images.items():
            p = im.point3D_ids
            feats = np.nonzero(wanted[p] & (p != INVALID_POINT3D))[0]
            if feats.size:
                obs_pid.append(p[feats])
                obs_key.append((np.int64(iid) << FEAT_BITS) | feats.astype(np.int64))
        n_points = int(wanted.sum())
        if not obs_pid:
            z = np.zeros(0, np.int64)
            return n_points, z, z, z, np.zeros(0, bool), z
        qid, nbr_img, nbr_feat = self.graph.find_batch_keys(np.concatenate(obs_key))
        nbr_reg, nbr_pid = self._neighbour_pids(nbr_img, nbr_feat)
        return n_points, np.concatenate(obs_pid)[qid], nbr_img, nbr_feat, nbr_reg, nbr_pid

    def _passes_gate(self, image_ids, feats, pids, max_err: float) -> np.ndarray:
        """Rows whose point reprojects into feature `feats` of `image_ids`
        in front of the camera and within max_err, with the screens'
        slack: one projection an image."""
        ok = np.zeros(image_ids.size, bool)
        if not ok.size:
            return ok
        uniq, inv = np.unique(pids, return_inverse=True)
        xyz = np.stack([self.rec.points3D[p].xyz for p in uniq.tolist()])[inv.reshape(-1)]
        for iid, rows in _groups(image_ids):
            img = self.rec.images[iid]
            cam = self.rec.cameras[img.camera_id]
            xy, z = np_geom.project(cam.model_id, cam.padded_params(), img.qvec, img.tvec, xyz[rows])
            err = np.linalg.norm(xy - img.xys[feats[rows]], axis=-1)
            ok[rows] = (z > -SCREEN_DEPTH_SLACK) & (err < max_err * (1 + SCREEN_GATE_SLACK))
        return ok

    @staticmethod
    def _count_screen(n_screened: int, n_flagged: int):
        PHASES.count("track_screen_pts", n_screened)
        PHASES.count("track_screen_flagged", n_flagged)

    def _screen_merge_tracks(self, point3D_ids) -> set:
        """The points of `point3D_ids` that merge_tracks can merge: those
        with a correspondence in a registered image that carries another
        point of the model. Exact: a merge relabels only features that
        already carry a point, so no free feature and no feature of an
        unregistered image becomes a candidate while the walk runs; a point
        that had none as the walk began has none when it is reached, or is
        gone, merged into a flagged one."""
        live = self._live_table()
        n_points, pid, _, _, _, nbr_pid = self._track_correspondences(point3D_ids, live)
        cand = live[nbr_pid] & (nbr_pid != INVALID_POINT3D) & (nbr_pid != pid)
        flagged = set(np.unique(pid[cand]).tolist())
        self._count_screen(n_points, len(flagged))
        return flagged

    def _screen_complete_tracks(self, options: TriangulatorOptions, point3D_ids) -> set:
        """The points of `point3D_ids` that complete_tracks can extend:
        those with a free correspondence in a registered image that they
        reproject into within the gate. Exact: the walk only claims free
        features and moves no point and no pose, so a point with no such
        first hop as the walk began finds none when it is reached, and
        without a first hop there is no second."""
        n_points, pid, nbr_img, nbr_feat, nbr_reg, nbr_pid = self._track_correspondences(
            point3D_ids, self._live_table()
        )
        cand = np.nonzero(nbr_reg & (nbr_pid == INVALID_POINT3D))[0]
        ok = self._passes_gate(
            nbr_img[cand], nbr_feat[cand], pid[cand], options.complete_max_reproj_error
        )
        flagged = set(np.unique(pid[cand[ok]]).tolist())
        self._count_screen(n_points, len(flagged))
        return flagged

    def _screen_complete_image(self, options: TriangulatorOptions, image_id: int) -> list:
        """The free features of `image_id` that complete_image can give a
        point, ascending: those with a correspondence in a registered image
        that carries a point of the model reprojecting into the feature
        within the gate. Exact: an observation added to `image_id` changes
        neither another feature's correspondences nor their points."""
        img = self.rec.images[image_id]
        free = np.nonzero(img.point3D_ids == INVALID_POINT3D)[0]
        qid, nbr_img, nbr_feat = self.graph.find_batch(image_id, free)
        _, nbr_pid = self._neighbour_pids(nbr_img, nbr_feat)
        live = self._live_table()
        cand = np.nonzero(live[nbr_pid] & (nbr_pid != INVALID_POINT3D))[0]
        cand_feat = free[qid[cand]]
        ok = self._passes_gate(
            np.full(cand.size, image_id, np.int64), cand_feat, nbr_pid[cand],
            options.complete_max_reproj_error,
        )
        feats = np.unique(cand_feat[ok]).tolist()
        self._count_screen(int(free.size), len(feats))
        return feats

    def retriangulate(self, options: TriangulatorOptions) -> int:
        """Retriangulate under-reconstructed image pairs (Retriangulate,
        incremental_triangulator.cc:350-496): for every registered pair whose
        triangulated-correspondence ratio is below re_min_ratio (and with
        fewer than re_max_trials prior attempts), continue one-sided
        correspondences into existing tracks with the RELAXED re gate, and
        create new two-view points with the ORIGINAL thresholds ("do not use
        larger triangulation threshold ... causes significant drift",
        :481-485). Repeated global rounds make this multi-pass: each round
        revisits pairs still under re_min_ratio within their trial budget."""
        n = 0
        # our continue gate is a pixel reproj bound; scale it by the ratio of
        # the reference's relaxed/strict angular gates (5.0/2.0 deg default)
        re_scale = options.re_max_angle_error / max(options.continue_max_angle_error, 1e-9)
        re_thr = options.complete_max_reproj_error * re_scale
        pts3D = self.rec.points3D
        for i, j in list(self.graph.image_pairs()):
            img1 = self.rec.images.get(i)
            img2 = self.rec.images.get(j)
            if img1 is None or img2 is None or not (img1.registered and img2.registered):
                continue
            m = self.graph.matches_between(i, j)
            if len(m) == 0:
                continue
            pids1 = img1.point3D_ids[m[:, 0]]
            pids2 = img2.point3D_ids[m[:, 1]]
            tri = int(np.sum((pids1 == pids2) & (pids1 != INVALID_POINT3D)))
            if tri / len(m) >= options.re_min_ratio:
                continue
            trials = self.re_num_trials.get((i, j), 0)
            if trials >= options.re_max_trials:
                continue
            self.re_num_trials[(i, j)] = trials + 1
            cam1 = self.rec.cameras[img1.camera_id]
            cam2 = self.rec.cameras[img2.camera_id]
            if cam1.has_bogus_params(
                options.min_focal_length_ratio, options.max_focal_length_ratio,
                options.max_extra_param,
            ) or cam2.has_bogus_params(
                options.min_focal_length_ratio, options.max_focal_length_ratio,
                options.max_extra_param,
            ):
                continue
            has1 = pids1 != INVALID_POINT3D
            has2 = pids2 != INVALID_POINT3D
            # one-sided: continue the free feature into the existing track
            # (vectorized reproj gate per direction)
            n += self._continue_rows(
                img2, m[:, 1], pids1, np.nonzero(has1 & ~has2)[0], re_thr, j
            )
            n += self._continue_rows(
                img1, m[:, 0], pids2, np.nonzero(~has1 & has2)[0], re_thr, i
            )
            # both free: create new two-view points with STRICT options
            for k in np.nonzero(~has1 & ~has2)[0]:
                f1, f2 = int(m[k, 0]), int(m[k, 1])
                if (
                    img1.point3D_ids[f1] == INVALID_POINT3D
                    and img2.point3D_ids[f2] == INVALID_POINT3D
                ):
                    n += self._try_create_point(options, [(i, f1), (j, f2)])
        return n

    def _continue_rows(self, img, feats, pids, rows, max_err: float, image_id: int) -> int:
        """Continue existing points `pids[rows]` into `img`'s free features
        `feats[rows]` when they reproject within max_err (vectorized)."""
        if rows.size == 0:
            return 0
        pts3D = self.rec.points3D
        keep = [k for k in rows if int(pids[k]) in pts3D]
        if not keep:
            return 0
        cam = self.rec.cameras[img.camera_id]
        X = np.stack([pts3D[int(pids[k])].xyz for k in keep])
        xy, z = np_geom.project(
            cam.model_id, cam.padded_params(), img.qvec, img.tvec, X
        )
        uv = img.xys[feats[keep]]
        err = np.linalg.norm(xy - uv, axis=-1)
        ok = (z > 0) & (err < max_err)
        n = 0
        for idx, k in enumerate(keep):
            f = int(feats[k])
            if ok[idx] and img.point3D_ids[f] == INVALID_POINT3D:
                self.rec.add_observation(int(pids[k]), image_id, f)
                n += 1
        return n


def _groups(ids: np.ndarray):
    """(id, rows) for each distinct value of `ids`, ascending."""
    order = np.argsort(ids, kind="stable")
    uniq, starts = np.unique(ids[order], return_index=True)
    return zip(uniq.tolist(), np.split(order, starts[1:]))
