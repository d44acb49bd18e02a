"""Overlapped frontend: extraction + matching + mapping run CONCURRENTLY.

Port of colmap_pcd_tpu/models/overlap.py (host code). The reference
pipelines resizer->extractor->writer threads inside extraction
(feature/extraction.h:50-148) and matcher->verifier threads inside matching
(feature/matching.h:222-345), but the three stages themselves run strictly
sequentially (`colmap feature_extractor && colmap *_matcher && colmap
mapper`). The mapper's wall time is dominated by host bookkeeping and launch
latency, not device occupancy, so the device can absorb the extraction and
matching work inside those gaps. This module runs:

  thread E: run_feature_extractor          (writes features to SQLite, WAL)
  thread M: incremental sequential matcher (matches a pair as soon as both
            sides are extracted; pushes verified pairs into a PairFeed)
  main:     the incremental mapper, draining the PairFeed between
            registrations (controllers.IncrementalMapperController hooks
            _drain_feed at the loop top; VisibilityIndex.on_matches_added
            replays late matches into the next-image ranking)

e2e wall becomes ~max(mapping, extraction+matching) instead of their sum.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from .. import device as device_mod
from ..utils.config import SiftExtractionConfig, SiftMatchingConfig
from .database import Database
from .feature_pipeline import (
    ImageReaderConfig,
    _MatchWorker,
    list_images,
    run_feature_extractor,
    sequential_pair_list,
)


class PairFeed:
    """Thread-safe buffer of extracted images + verified pairs, produced by
    the frontend threads and drained by the mapper."""

    def __init__(self):
        self._lock = threading.Lock()
        self._images: list[tuple] = []  # (iid, name, camera_id, xys)
        self._cameras: dict[int, dict] = {}
        self._pairs: list[tuple] = []  # (i, j, inlier_matches)
        self._done = False
        self._error: BaseException | None = None
        self.n_pairs_matched = 0
        self.n_pairs_verified = 0
        self.extract_s = 0.0  # extraction thread wall (set on completion)
        self.match_s = 0.0  # matcher thread wall, includes waiting on extract
        self.match_busy_s = 0.0  # wall actually inside match_pairs (no waits)

    def push_image(self, iid, name, camera_id, xys):
        with self._lock:
            self._images.append((iid, name, camera_id, xys))

    def push_camera(self, camera_id, cam):
        with self._lock:
            self._cameras[camera_id] = cam

    def push_pair(self, i, j, matches):
        with self._lock:
            self._pairs.append((i, j, matches))
            self.n_pairs_verified += 1

    def drain(self):
        with self._lock:
            imgs, self._images = self._images, []
            pairs, self._pairs = self._pairs, []
            cams, self._cameras = dict(self._cameras), {}
        return imgs, cams, pairs

    def mark_done(self, error: BaseException | None = None):
        with self._lock:
            self._done = True
            self._error = error

    @property
    def done(self) -> bool:
        with self._lock:
            return self._done

    @property
    def error(self):
        with self._lock:
            return self._error

    def wait_for_images(self, n: int, timeout: float = 600.0) -> bool:
        """Block until >= n images have been pushed (without draining)."""
        t0 = time.time()
        while time.time() - t0 < timeout:
            with self._lock:
                if len(self._images) >= n or self._done:
                    return len(self._images) >= n
            time.sleep(0.1)
        return False


def run_overlapped_frontend(
    database_path: str,
    image_path: str,
    extraction: SiftExtractionConfig = SiftExtractionConfig(),
    matching: SiftMatchingConfig = SiftMatchingConfig(),
    reader: ImageReaderConfig = ImageReaderConfig(),
    overlap: int = 5,
    quadratic_overlap: bool = False,
    match_block: int = 64,
    device=None,
) -> tuple[PairFeed, threading.Thread, threading.Thread]:
    """Start extraction + incremental matching threads; returns the feed and
    both threads (join them for stage timing; the feed is marked done when
    matching finishes). Both run on CUDA unless `device` is "cpu"."""
    feed = PairFeed()
    dev = device_mod.resolve(device)
    # the matcher's workers and the caller's mapper are about to use linalg
    # from several threads: load the library here, before any of them starts
    device_mod.warm_linalg(dev)
    expected = list_images(image_path)

    def _extract():
        t0 = time.time()
        try:
            run_feature_extractor(database_path, image_path, extraction, reader, device=dev)
        except BaseException as e:  # surfaced via the feed
            feed.mark_done(e)
            raise
        finally:
            feed.extract_s = time.time() - t0

    t_extract = threading.Thread(target=_extract, name="overlap-extract", daemon=True)
    t_extract.start()

    def _match():
        # own connection: WAL allows reading while the extractor writes
        db = None
        t0 = time.time()
        try:
            # wait for the db file to exist with the schema
            while not feed.done:
                try:
                    db = Database(database_path)
                    break
                except Exception:
                    time.sleep(0.2)
            w = _MatchWorker(db, matching, dev)
            pushed_imgs: set[int] = set()
            pushed_cams: set[int] = set()
            matched: set[tuple[int, int]] = set()
            while True:
                imgs = db.images()
                # push newly visible images (with keypoints) to the feed
                for iid in sorted(imgs):
                    if iid in pushed_imgs:
                        continue
                    kp = db.read_keypoints(iid)
                    cam_id = imgs[iid]["camera_id"]
                    if cam_id not in pushed_cams:
                        cams = db.cameras()
                        if cam_id in cams:
                            feed.push_camera(cam_id, cams[cam_id])
                            pushed_cams.add(cam_id)
                    feed.push_image(iid, imgs[iid]["name"], cam_id, kp[:, :2])
                    pushed_imgs.add(iid)
                # name-ordered sequential pair policy over available images
                by_name = sorted(imgs, key=lambda i: imgs[i]["name"])
                pairs = [
                    p for p in sequential_pair_list(by_name, overlap, quadratic_overlap)
                    if p not in matched
                ]
                extraction_live = t_extract.is_alive()
                if pairs:
                    # refresh the worker's image/camera tables (new rows)
                    w.images = imgs
                    w.cameras = db.cameras()
                    block = pairs[:match_block]
                    tb = time.time()
                    w.match_pairs(block)
                    feed.match_busy_s += time.time() - tb
                    for i, j in block:
                        matched.add((i, j))
                        feed.n_pairs_matched += 1
                        g = db.read_two_view_geometry(i, j)
                        if g is not None and len(g["inlier_matches"]):
                            feed.push_pair(i, j, g["inlier_matches"].astype(np.int32))
                elif not extraction_live and len(imgs) >= len(expected):
                    break
                elif not extraction_live and not pairs:
                    # extractor died early or fewer images than files
                    break
                else:
                    time.sleep(0.2)
            feed.mark_done()
        except BaseException as e:
            feed.mark_done(e)
            raise
        finally:
            feed.match_s = time.time() - t0
            if db is not None:
                db.close()

    t_match = threading.Thread(target=_match, name="overlap-match", daemon=True)
    t_match.start()
    return feed, t_extract, t_match
