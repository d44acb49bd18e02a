"""Incremental next-image scoring: per-image visible-point counters and the
multi-level visibility pyramid.

Parity re-design of src/base/visibility_pyramid.{h,cc} and the incremental
correspondence bookkeeping of src/base/image.cc:110-135
(Increment/DecrementCorrespondenceHasPoint3D) feeding FindNextImages
(src/sfm/incremental_mapper.cc:299): whenever an observation (image, feat)
becomes (un)triangulated, every correspondence of that feature updates its
image's counters — so ranking candidates is O(images), not a scan over every
feature of every unregistered image per registration.

Scoring matches the reference exactly:
  * pyramid with L levels (default 6); level l (1-based) is a 2^l x 2^l grid;
  * a feature whose triangulated-correspondence count goes 0->1 marks its
    cell on every level; a cell becoming non-empty adds dim*dim to the score
    (visibility_pyramid.cc SetPoint/ResetPoint);
  * num_visible counts features with >=1 triangulated correspondence
    (RankNextImageMinUncertainty == pyramid score is the default rank).
"""

from __future__ import annotations

import numpy as np

NUM_PYRAMID_LEVELS = 6  # Image::kNumPoint3DVisibilityPyramidLevels


class _ImageVis:
    __slots__ = ("corr_tri_count", "num_visible", "levels", "score", "cell_xy")

    def __init__(self, num_features: int, xys: np.ndarray, width: int, height: int):
        self.corr_tri_count = np.zeros(num_features, np.int32)
        self.num_visible = 0
        self.levels = [
            np.zeros((1 << (l + 1), 1 << (l + 1)), np.int32)
            for l in range(NUM_PYRAMID_LEVELS)
        ]
        self.score = 0
        # precomputed finest-level cell per feature (CellForPoint)
        max_dim = 1 << NUM_PYRAMID_LEVELS
        if num_features > 0:
            cx = np.clip((max_dim * xys[:, 0] / max(width, 1)).astype(np.int64), 0, max_dim - 1)
            cy = np.clip((max_dim * xys[:, 1] / max(height, 1)).astype(np.int64), 0, max_dim - 1)
        else:
            cx = cy = np.zeros(0, np.int64)
        self.cell_xy = np.stack([cx, cy], axis=1)

    def set_point(self, feat: int):
        cx, cy = self.cell_xy[feat]
        for i in range(NUM_PYRAMID_LEVELS - 1, -1, -1):
            lv = self.levels[i]
            lv[cy, cx] += 1
            if lv[cy, cx] == 1:
                self.score += lv.size
            cx >>= 1
            cy >>= 1

    def reset_point(self, feat: int):
        cx, cy = self.cell_xy[feat]
        for i in range(NUM_PYRAMID_LEVELS - 1, -1, -1):
            lv = self.levels[i]
            lv[cy, cx] -= 1
            if lv[cy, cx] == 0:
                self.score -= lv.size
            cx >>= 1
            cy >>= 1


class VisibilityIndex:
    """Observer on Reconstruction observation transitions; answers
    find_next_images ranking queries in O(candidate images)."""

    def __init__(self, rec, graph):
        self.rec = rec
        self.graph = graph
        self._vis: dict[int, _ImageVis] = {}
        rec.obs_observers.append(self)
        # replay current state (resume-from-model support)
        from .reconstruction import INVALID_POINT3D

        for iid, img in rec.images.items():
            for f in np.nonzero(img.point3D_ids != INVALID_POINT3D)[0]:
                self.on_observation(iid, int(f), True)

    def _vis_of(self, image_id: int) -> _ImageVis:
        v = self._vis.get(image_id)
        if v is None:
            img = self.rec.images[image_id]
            cam = self.rec.cameras[img.camera_id]
            v = _ImageVis(img.xys.shape[0], img.xys, cam.width, cam.height)
            self._vis[image_id] = v
        return v

    # Reconstruction observer protocol -------------------------------------
    def on_observation(self, image_id: int, feat_idx: int, triangulated: bool):
        """(image_id, feat_idx) transitioned to/from having a 3D point."""
        for cid, cfeat in self.graph.find_correspondences(image_id, feat_idx):
            cid, cfeat = int(cid), int(cfeat)
            if cid not in self.rec.images:
                continue
            v = self._vis_of(cid)
            if triangulated:
                v.corr_tri_count[cfeat] += 1
                if v.corr_tri_count[cfeat] == 1:
                    v.num_visible += 1
                    v.set_point(cfeat)
            else:
                v.corr_tri_count[cfeat] -= 1
                if v.corr_tri_count[cfeat] == 0:
                    v.num_visible -= 1
                    v.reset_point(cfeat)

    def on_matches_added(self, image_id1: int, image_id2: int, matches: np.ndarray):
        """Replay for matches added AFTER points were triangulated (the
        overlapped pipeline feeds verified pairs into the graph while mapping
        runs): each side whose feature is already triangulated bumps the
        OTHER side's counters, exactly as on_observation would have at
        triangulation time had the match existed then."""
        from .reconstruction import INVALID_POINT3D

        m = np.asarray(matches)
        if m.size == 0:
            return
        for (a, b, fa_col, fb_col) in (
            (image_id1, image_id2, 0, 1),
            (image_id2, image_id1, 1, 0),
        ):
            img_a = self.rec.images.get(a)
            if img_a is None or b not in self.rec.images:
                continue
            tri = img_a.point3D_ids[m[:, fa_col]] != INVALID_POINT3D
            if not tri.any():
                continue
            v = self._vis_of(b)
            for f in m[tri, fb_col]:
                f = int(f)
                v.corr_tri_count[f] += 1
                if v.corr_tri_count[f] == 1:
                    v.num_visible += 1
                    v.set_point(f)

    # queries ---------------------------------------------------------------
    def num_visible_points3D(self, image_id: int) -> int:
        v = self._vis.get(image_id)
        return v.num_visible if v is not None else 0

    def score(self, image_id: int) -> int:
        v = self._vis.get(image_id)
        return v.score if v is not None else 0

    def visible_features(self, image_id: int) -> np.ndarray:
        """Feature indices with >=1 triangulated correspondence."""
        v = self._vis.get(image_id)
        if v is None:
            return np.zeros(0, np.int64)
        return np.nonzero(v.corr_tri_count > 0)[0]
