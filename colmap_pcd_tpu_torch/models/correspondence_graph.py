"""Correspondence graph: per-feature adjacency across images.

Parity with src/base/correspondence_graph.{h,cc}: stores two-view inlier
matches and answers "which (image, feature) pairs correspond to feature j of
image i", including transitive closure, plus per-pair statistics used by the
mapper (num_correspondences per image, pair stats for Project2Image gating).

Re-design for scale: the adjacency is a CSR structure over packed
(image_id << FEAT_BITS | feat) int64 keys, bulk-built by the native C++
runtime (cpp/native.cpp cg_build_csr; numpy fallback) and queried with
fully vectorized batched lookups — the O(1)-per-correspondence array walks
of the reference's C++ graph (correspondence_graph.h:45-116), without
per-feature Python dict churn.
"""

from __future__ import annotations

import numpy as np

from ..utils import native

FEAT_BITS = native.FEAT_BITS


def pair_id(image_id1: int, image_id2: int) -> int:
    """COLMAP pair packing (base/database.cc ImagePairToPairId)."""
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * 2147483647 + image_id2


class CorrespondenceGraph:
    def __init__(self):
        self._pair_matches: dict[tuple[int, int], np.ndarray] = {}
        self.num_observations_per_image: dict[int, int] = {}
        self.num_correspondences_per_image: dict[int, int] = {}
        # CSR state (built lazily after match ingestion)
        self._keys: np.ndarray | None = None  # [M] sorted packed keys
        self._off: np.ndarray | None = None  # [M+1]
        self._nbr: np.ndarray | None = None  # [E] packed neighbor keys
        self._dirty = True

    # ------------------------------------------------------------- ingestion
    def add_image(self, image_id: int, num_features: int):
        self.num_observations_per_image.setdefault(image_id, num_features)
        self.num_correspondences_per_image.setdefault(image_id, 0)

    def add_matches(self, image_id1: int, image_id2: int, matches: np.ndarray):
        """matches [M,2] of (feat1, feat2) verified inlier matches."""
        if image_id1 > image_id2:
            image_id1, image_id2 = image_id2, image_id1
            matches = matches[:, ::-1]
        key = (image_id1, image_id2)
        if key in self._pair_matches:
            return
        self._pair_matches[key] = np.asarray(matches, np.int32)
        self.num_correspondences_per_image[image_id1] = (
            self.num_correspondences_per_image.get(image_id1, 0) + len(matches)
        )
        self.num_correspondences_per_image[image_id2] = (
            self.num_correspondences_per_image.get(image_id2, 0) + len(matches)
        )
        self._dirty = True

    def _build(self):
        if not self._dirty:
            return
        k1_parts, k2_parts = [], []
        for (i1, i2), m in self._pair_matches.items():
            if len(m) == 0:
                continue
            k1_parts.append((np.int64(i1) << FEAT_BITS) | m[:, 0].astype(np.int64))
            k2_parts.append((np.int64(i2) << FEAT_BITS) | m[:, 1].astype(np.int64))
        if not k1_parts:
            self._keys = np.zeros(0, np.int64)
            self._off = np.zeros(1, np.int64)
            self._nbr = np.zeros(0, np.int64)
        else:
            self._keys, self._off, self._nbr = native.build_csr(
                np.concatenate(k1_parts), np.concatenate(k2_parts)
            )
        self._dirty = False

    # --------------------------------------------------------------- queries
    def matches_between(self, image_id1: int, image_id2: int) -> np.ndarray:
        """[M,2] (feat_in_id1, feat_in_id2)."""
        if image_id1 > image_id2:
            m = self._pair_matches.get((image_id2, image_id1))
            return m[:, ::-1] if m is not None else np.zeros((0, 2), np.int32)
        m = self._pair_matches.get((image_id1, image_id2))
        return m if m is not None else np.zeros((0, 2), np.int32)

    def find_batch(self, image_id: int, feat_idx: np.ndarray):
        """Vectorized correspondence lookup for many features of one image.

        Returns (qid, nbr_img, nbr_feat): flat int arrays where qid[k] is the
        index into feat_idx whose correspondence (nbr_img[k], nbr_feat[k]) is.
        """
        self._build()
        feat_idx = np.asarray(feat_idx, np.int64)
        qkeys = (np.int64(image_id) << FEAT_BITS) | feat_idx
        return self.find_batch_keys(qkeys)

    def find_batch_keys(self, qkeys: np.ndarray):
        """Batched lookup by packed keys; returns (qid, nbr_img, nbr_feat)."""
        self._build()
        M = len(self._keys)
        if M == 0 or len(qkeys) == 0:
            z = np.zeros(0, np.int64)
            return z, z, z
        pos = np.searchsorted(self._keys, qkeys)
        pos_c = np.minimum(pos, M - 1)
        found = self._keys[pos_c] == qkeys
        starts = np.where(found, self._off[pos_c], 0)
        counts = np.where(found, self._off[pos_c + 1] - self._off[pos_c], 0)
        total = int(counts.sum())
        if total == 0:
            z = np.zeros(0, np.int64)
            return z, z, z
        qid = np.repeat(np.arange(len(qkeys), dtype=np.int64), counts)
        # flat positions: arange within each group + group start
        cum = np.concatenate([[0], np.cumsum(counts)[:-1]])
        flat = np.arange(total, dtype=np.int64) - np.repeat(cum, counts) + np.repeat(starts, counts)
        nbr = self._nbr[flat]
        return qid, nbr >> FEAT_BITS, nbr & ((1 << FEAT_BITS) - 1)

    def find_correspondences(self, image_id: int, feat_idx: int):
        """Single-feature lookup returning [(image_id, feat_idx), ...]."""
        self._build()
        M = len(self._keys)
        if M == 0:
            return []
        key = (np.int64(image_id) << FEAT_BITS) | np.int64(feat_idx)
        pos = int(np.searchsorted(self._keys, key))
        if pos >= M or self._keys[pos] != key:
            return []
        nbr = self._nbr[self._off[pos] : self._off[pos + 1]]
        return list(zip((nbr >> FEAT_BITS).tolist(), (nbr & ((1 << FEAT_BITS) - 1)).tolist()))

    def find_transitive_correspondences(
        self, image_id: int, feat_idx: int, transitivity: int = 1
    ):
        """BFS up to `transitivity` hops (correspondence_graph.h:86-99)."""
        if transitivity <= 1:
            return self.find_correspondences(image_id, feat_idx)
        seen = {(image_id, feat_idx)}
        frontier = [(image_id, feat_idx)]
        out = []
        for _ in range(transitivity):
            nxt = []
            for node in frontier:
                for other in self.find_correspondences(*node):
                    if other not in seen:
                        seen.add(other)
                        out.append(other)
                        nxt.append(other)
            frontier = nxt
        return out

    def image_pairs(self):
        return self._pair_matches.keys()

    def num_matches(self, image_id1: int, image_id2: int) -> int:
        return len(self.matches_between(image_id1, image_id2))

    def num_correspondences_for_image(self, image_id: int) -> int:
        return self.num_correspondences_per_image.get(image_id, 0)
