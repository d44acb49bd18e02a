"""Feature extraction + matching controllers over the database.

Port of colmap_pcd_tpu/models/feature_pipeline.py (parity with
src/feature/extraction.{h,cc}, the SiftFeatureExtractor staged pipeline, and
src/feature/matching.{h,cc}, the matcher controller family):

  * extraction: IO-threaded read+resize -> one device SIFT stage
    (`ops/sift.extract_batch` on uint8 uploads) -> one SQLite writer
    (`utils/threading_utils.pipeline_map`, the resizer/extractor/writer
    topology of extraction.h:50-148); `run_feature_importer` reads COLMAP
    text feature files instead.
  * matching: each controller enumerates candidate pairs its own way, then a
    shared worker matches descriptors (uint8 as the database holds them,
    through the hand-written tensor-core top-2 kernel K1 on a CUDA device),
    verifies two-view geometry with the batched E/F/H LO-RANSAC banks,
    optionally re-matches guided by F, and writes `matches` and
    `two_view_geometries`.

Matchers: exhaustive, sequential (with retrieval loop detection),
spatial, transitive, vocab-tree (VLAD retrieval, ops/retrieval.py, with
optional vote-and-verify re-ranking), image-pairs and feature-pairs (raw /
inlier match import). `use_pallas` is accepted and has no effect: on a
CUDA device K1 is the matcher.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from dataclasses import dataclass
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import device as device_mod
from ..ops import camera_models as cm
from ..ops import match_kernel
from ..ops import matching as matching_ops
from ..ops import np_geom
from ..ops import retrieval
from ..ops import sift as sift_ops
from ..utils import image as image_utils
from ..utils.camera_database import exif_focal_length
from ..utils.config import SiftExtractionConfig, SiftMatchingConfig
from ..utils.threading_utils import pipeline_map
from . import two_view as two_view_mod
from .database import Database


# images per device batch of the extractor
_EXTRACT_BATCH = 8

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".ppm", ".pgm")


@dataclass
class ImageReaderConfig:
    camera_model: str = "OPENCV"
    single_camera: bool = True
    camera_params: str = ""  # comma-separated; empty = default from EXIF-less prior
    default_focal_factor: float = 1.2


def list_images(image_path: str) -> list[str]:
    names = []
    for root, _, files in os.walk(image_path):
        for f in sorted(files):
            if f.lower().endswith(IMAGE_EXTS):
                names.append(os.path.relpath(os.path.join(root, f), image_path))
    return sorted(names)


class _CameraAssigner:
    """One camera per (model, size) with `single_camera`, else per image
    (ImageReader semantics, base/image_reader.cc): known parameters from the
    reader config, else an EXIF focal prior, else the default focal factor."""

    def __init__(self, db: Database, reader: ImageReaderConfig):
        self.db = db
        self.reader = reader
        self.model_id = cm.MODEL_IDS[reader.camera_model]
        self.camera_ids: dict[tuple, int] = {}

    def camera_id(self, name: str, W0: int, H0: int, exif_focal) -> int:
        reader = self.reader
        key = (reader.camera_model, W0, H0) if reader.single_camera else (name,)
        if key not in self.camera_ids:
            if reader.camera_params:
                params = [float(x) for x in reader.camera_params.split(",")]
                prior_focal = True
            else:
                f = exif_focal or reader.default_focal_factor * max(W0, H0)
                prior_focal = exif_focal is not None
                fi, fj, ci, cj = cm._FOCAL_IDX[self.model_id]
                params = [0.0] * cm.NUM_PARAMS[self.model_id]
                params[fi] = params[fj] = f
                params[ci] = W0 / 2
                params[cj] = H0 / 2
            self.camera_ids[key] = self.db.add_camera(
                self.model_id, W0, H0, params, prior_focal=prior_focal
            )
        return self.camera_ids[key]


def run_feature_extractor(
    database_path: str,
    image_path: str,
    extraction: SiftExtractionConfig = SiftExtractionConfig(),
    reader: ImageReaderConfig = ImageReaderConfig(),
    num_io_threads: int = 4,
    device=None,
) -> int:
    """Extract SIFT for every image under image_path into the database.
    Returns the number of images processed (RunFeatureExtractor parity,
    exe/feature.cc:104). Runs on CUDA unless `device` is "cpu"."""
    dev = device_mod.resolve(device)
    names = list_images(image_path)
    if not names:
        return 0
    db = Database(database_path)

    opts = sift_ops.SiftOptions(
        max_num_features=extraction.max_num_features,
        num_octaves=extraction.num_octaves,
        octave_resolution=extraction.octave_resolution,
        first_octave=extraction.first_octave,
        peak_threshold=extraction.peak_threshold,
        edge_threshold=extraction.edge_threshold,
        upright=extraction.upright,
        estimate_affine_shape=extraction.estimate_affine_shape,
        domain_size_pooling=extraction.domain_size_pooling,
        dsp_min_scale=extraction.dsp_min_scale,
        dsp_max_scale=extraction.dsp_max_scale,
        dsp_num_scales=extraction.dsp_num_scales,
    )
    cameras = _CameraAssigner(db, reader)

    def produce(batch):
        """IO threads: read, EXIF focal prior, resize."""
        out = []
        for name in batch:
            path = os.path.join(image_path, name)
            img = image_utils.imread_gray_u8(path)
            H0, W0 = img.shape
            exif_focal = None if reader.camera_params else exif_focal_length(path, W0, H0)
            img, scale = image_utils.resize_max(img, extraction.max_image_size)
            out.append((img, scale, (W0, H0), exif_focal))
        return out

    def device_stage(batch, data):
        """Caller thread: upload uint8, extract, and fetch numpy before the
        stage ends, so the writer thread never waits on the device. Images
        of one shape go as one batch; a group is never padded."""
        shapes = {d[0].shape for d in data}
        groups = [list(range(len(data)))] if len(shapes) == 1 else [[i] for i in range(len(data))]
        fetched = [None] * len(data)
        for group in groups:
            imgs = torch.as_tensor(np.stack([data[i][0] for i in group]), device=dev)
            kp, desc, _score, valid = sift_ops.extract_batch(imgs, opts)
            kp, desc, valid = (
                t.cpu().numpy() for t in (kp, sift_ops.descriptors_to_uint8(desc), valid)
            )
            for row, i in enumerate(group):
                fetched[i] = (kp[row][valid[row]], desc[row][valid[row]])
        return fetched, data

    def consume(batch, staged):
        """Writer thread: back to original-image scale, then SQLite."""
        fetched, data = staged
        for name, (kp, desc), (_img, scale, (W0, H0), exif_focal) in zip(batch, fetched, data):
            if scale != 1.0:
                kp[:, :3] /= scale
            iid = db.add_image(name, cameras.camera_id(name, W0, H0, exif_focal))
            db.write_keypoints(iid, kp[:, :4])
            db.write_descriptors(iid, desc)
            db.commit()

    batches = [names[i : i + _EXTRACT_BATCH] for i in range(0, len(names), _EXTRACT_BATCH)]
    try:
        pipeline_map(batches, produce, consume, device_stage, num_io_threads=num_io_threads)
    finally:
        db.close()
    return len(names)


def run_feature_importer(
    database_path: str,
    image_path: str,
    import_path: str,
    reader: ImageReaderConfig = ImageReaderConfig(),
) -> int:
    """Import pre-extracted features from COLMAP text files
    (FeatureImporter, feature/extraction.cc + exe/feature.cc:177
    RunFeatureImporter): for every image under image_path, reads
    `<import_path>/<name>.txt` with header "NUM DIM" and rows
    `x y scale orientation d1..dDIM` (uint8 descriptors). Camera assignment
    follows the same reader rules as extraction."""
    from PIL import Image as PILImage

    names = list_images(image_path)
    db = Database(database_path)
    cameras = _CameraAssigner(db, reader)
    n_done = 0
    for name in names:
        feat_path = os.path.join(import_path, name + ".txt")
        if not os.path.exists(feat_path):
            print(f"skipping {name}: no feature file {feat_path}")
            continue
        with open(feat_path) as fh:
            header = fh.readline().split()
            num, dim = int(header[0]), int(header[1])
            rows = np.loadtxt(fh, dtype=np.float64, ndmin=2)
        if rows.size == 0:
            kp = np.zeros((0, 4), np.float32)
            desc = np.zeros((0, dim), np.uint8)
        else:
            if rows.shape[1] != 4 + dim:
                raise ValueError(f"{feat_path}: rows of {rows.shape[1]} values, header says 4 + {dim}")
            kp = rows[:num, :4].astype(np.float32)
            desc = np.clip(np.round(rows[:num, 4:]), 0, 255).astype(np.uint8)
        path = os.path.join(image_path, name)
        with PILImage.open(path) as im:
            W0, H0 = im.size
        exif_focal = None if reader.camera_params else exif_focal_length(path, W0, H0)
        iid = db.add_image(name, cameras.camera_id(name, W0, H0, exif_focal))
        db.write_keypoints(iid, kp)
        db.write_descriptors(iid, desc)
        db.commit()
        n_done += 1
    db.close()
    return n_done


class _MatchWorker:
    """Shared per-pair matcher + verifier + writer.

    A chunked pipeline: every chunk of pairs passes through
        prepare (host: SQLite reads + padding, caller thread)
      -> match  (device: one batched top-2 bank over the chunk + one fetch)
      -> assemble (host: match extraction, E/F/H item build)
      -> verify (device: one batched E/F/H + pose bank + one fetch)
      -> classify (host) -> SQLite writes (caller thread, in order).
    Chunks run on a 2-thread pool, so one chunk's host stages overlap the
    other's device work (the reference's matcher/verifier worker pool,
    feature/matching.h:222-345, as pipeline stages around batched device
    work). Only the caller thread touches SQLite."""

    def __init__(self, db: Database, config: SiftMatchingConfig, device=None):
        self.db = db
        self.cfg = config
        self.device = device_mod.resolve(device)
        self._host_cache: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray, int]] = {}
        self._dev_cache: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._float_cache: dict[int, torch.Tensor] = {}
        self._dev_lock = threading.Lock()
        self.cameras = db.cameras()
        self.images = db.images()
        # the pool's two threads would race to PyTorch's lazy linalg loader
        device_mod.warm_linalg(self.device)

    # ------------------------------------------------------------ features
    def _feats_host(self, image_id: int):
        """(kp_p, d_u8, v, N) host arrays padded to a power of two >= 64
        (FeatureMatcherCache parity). Caller thread only (SQLite)."""
        if image_id not in self._host_cache:
            kp = self.db.read_keypoints(image_id)
            desc = self.db.read_descriptors(image_id)
            N = desc.shape[0]
            cap = 1 << max(6, int(np.ceil(np.log2(max(N, 1)))))
            kp_p = np.zeros((cap, 6), np.float32)
            kp_p[:N] = kp
            d_u8 = np.zeros((cap, desc.shape[1] if desc.size else 128), np.uint8)
            if N:
                d_u8[:N] = desc
            v = np.zeros(cap, np.float32)
            v[:N] = 1.0
            if len(self._host_cache) > 200:  # LRU-ish cap
                self._host_cache.pop(next(iter(self._host_cache)))
            self._host_cache[image_id] = (kp_p, d_u8, v, N)
        return self._host_cache[image_id]

    def _feats_dev(self, image_id: int, d_u8: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """Device-resident (uint8 descriptors, f32 inverse norms; 0 for a
        padding row): one uint8 upload per image, its norms taken once on
        the device."""
        with self._dev_lock:
            feats = self._dev_cache.get(image_id)
        if feats is None:
            d = torch.as_tensor(d_u8, device=self.device)
            feats = (d, match_kernel.inverse_norms(d))
            with self._dev_lock:
                if len(self._dev_cache) > 200:
                    self._dev_cache.pop(next(iter(self._dev_cache)))
                self._dev_cache[image_id] = feats
        return feats

    def _feats_float(self, image_id: int, d_u8: np.ndarray) -> torch.Tensor:
        """Device-resident normalized f32 descriptors for the float route
        (`match_pair`), normalized once per image. Caller thread only."""
        d = self._float_cache.get(image_id)
        if d is None:
            d = matching_ops.normalize_descriptors(self._feats_dev(image_id, d_u8)[0])
            if len(self._float_cache) > 200:
                self._float_cache.pop(next(iter(self._float_cache)))
            self._float_cache[image_id] = d
        return d

    def _mopts(self) -> matching_ops.MatchingOptions:
        return matching_ops.MatchingOptions(
            max_ratio=self.cfg.max_ratio,
            max_distance=self.cfg.max_distance,
            cross_check=self.cfg.cross_check,
            guided_max_error=self.cfg.max_error,
        )

    def _tv_opts(self):
        return two_view_mod.TwoViewOptions(
            max_error=self.cfg.max_error,
            min_num_inliers=self.cfg.min_num_inliers,
            num_hypotheses=self.cfg.num_hypotheses,
        )

    # ------------------------------------------------------- pipeline stages
    def _prep(self, pairs):
        """Host (caller thread): pull host features, decide the chunk cap."""
        hfeats = [(self._feats_host(i), self._feats_host(j)) for i, j in pairs]
        cap = max(max(f1[1].shape[0], f2[1].shape[0]) for f1, f2 in hfeats)
        degenerate = all(f1[3] == 0 or f2[3] == 0 for f1, f2 in hfeats)
        return dict(pairs=list(pairs), hfeats=hfeats, cap=cap, degenerate=degenerate)

    def _dev_match(self, prep):
        """Device: upload missing descriptors, match the whole chunk as one
        [B, cap, 128] uint8 bank, fetch (idx, ok, sim) once."""
        cap = prep["cap"]
        sides = ([], [], []), ([], [], [])  # descriptors, inverse norms, valid
        for (i, j), (f1, f2) in zip(prep["pairs"], prep["hfeats"]):
            for iid, f, (ds, ns, vs) in ((i, f1, sides[0]), (j, f2, sides[1])):
                d, inv = self._feats_dev(iid, f[1])
                ds.append(torch.nn.functional.pad(d, (0, 0, 0, cap - d.shape[0])))
                ns.append(torch.nn.functional.pad(inv, (0, cap - inv.shape[0])))
                vs.append(np.pad(f[2], (0, cap - f[2].shape[0])))
        dev = self.device
        (d1s, n1s, v1s), (d2s, n2s, v2s) = sides
        idx, ok, sim = matching_ops.match_descriptors_u8(
            torch.stack(d1s), torch.stack(d2s), torch.stack(n1s), torch.stack(n2s),
            torch.as_tensor(np.stack(v1s), device=dev), torch.as_tensor(np.stack(v2s), device=dev),
            self._mopts(),
        )
        return idx.cpu().numpy(), ok.cpu().numpy(), sim.cpu().numpy()

    def _assemble_pure(self, prep, fetched):
        """Host: extract per-pair matches, build the E/F/H items. Returns
        (asm | None, match_writes)."""
        idx_b, ok_b, sim_b = fetched
        items, meta, match_writes = [], [], []
        for b, (id1, id2) in enumerate(prep["pairs"]):
            rows = np.nonzero(ok_b[b])[0]
            mpairs = np.stack([rows, idx_b[b][rows]], axis=-1).astype(np.int32)
            if len(mpairs) < self.cfg.min_num_inliers:
                match_writes.append((id1, id2, np.zeros((0, 2), np.uint32)))
                continue
            match_writes.append((id1, id2, mpairs))
            kp1 = prep["hfeats"][b][0][0]
            kp2 = prep["hfeats"][b][1][0]
            cam1 = self.cameras[self.images[id1]["camera_id"]]
            cam2 = self.cameras[self.images[id2]["camera_id"]]
            items.append(dict(
                uv1=kp1[mpairs[:, 0], :2],
                uv2=kp2[mpairs[:, 1], :2],
                params1=np_geom.pad_params(
                    cam1["params"][: cm.NUM_PARAMS[cam1["model_id"]]], cam1["model_id"]
                ),
                params2=np_geom.pad_params(
                    cam2["params"][: cm.NUM_PARAMS[cam2["model_id"]]], cam2["model_id"]
                ),
                model_id1=cam1["model_id"],
                model_id2=cam2["model_id"],
                size1=(cam1["width"], cam1["height"]),
                size2=(cam2["width"], cam2["height"]),
                quality=sim_b[b][mpairs[:, 0]],
            ))
            meta.append((id1, id2, mpairs))
        if not items:
            return None, match_writes
        return dict(items=items, meta=meta), match_writes

    def _dev_verify(self, asm):
        """Device: the fused E/F/H + pose bank over the chunk, fetched once."""
        outputs, ctx = two_view_mod.two_view_verify_dispatch(asm["items"], self._tv_opts(), self.device)
        return two_view_mod.fetch(outputs), ctx

    def _classify_pure(self, asm, vctx, vfetched):
        """Host: configuration classification. Returns (geom_writes, n_ok)
        with geom_writes rows (id1, id2, inliers, geom)."""
        geoms = two_view_mod.two_view_verify_classify(vfetched, vctx, asm["items"], self._tv_opts())
        n_ok = 0
        geom_writes = []
        for (id1, id2, mpairs), g in zip(asm["meta"], geoms):
            rows = g.inlier_matches[:, 0] if len(g.inlier_matches) else np.zeros(0, np.int64)
            inliers = mpairs[rows] if len(rows) else np.zeros((0, 2), np.uint32)
            geom_writes.append((id1, id2, inliers, g))
            if len(inliers) >= self.cfg.min_num_inliers:
                n_ok += 1
        return geom_writes, n_ok

    def _process_chunk(self, prep):
        """One chunk through match -> assemble -> verify -> classify; touches
        no SQLite. Returns (match_writes, geom_writes, n_ok) for the caller
        to flush in submission order."""
        if prep["degenerate"]:
            return [(i, j, np.zeros((0, 2), np.uint32)) for i, j in prep["pairs"]], [], 0
        asm, match_writes = self._assemble_pure(prep, self._dev_match(prep))
        if asm is None:
            return match_writes, [], 0
        vfetched, vctx = self._dev_verify(asm)
        geom_writes, n_ok = self._classify_pure(asm, vctx, vfetched)
        return match_writes, geom_writes, n_ok

    def match_pairs(self, pair_list, chunk: int = 16) -> int:
        """Pipelined batched pair matching + verification (see the class
        doc). Returns the number of pairs with a verified geometry."""
        if self.cfg.guided_matching:
            return sum(1 if self.match_pair(i, j) else 0 for i, j in pair_list)
        n_ok = 0

        def flush(fut):
            nonlocal n_ok
            match_writes, geom_writes, ok = fut.result()
            for id1, id2, mpairs in match_writes:
                self.db.write_matches(id1, id2, mpairs)
            for id1, id2, inliers, g in geom_writes:
                self.db.write_two_view_geometry(
                    id1, id2, inliers, g.config, F=g.F, E=g.E, H=g.H, qvec=g.qvec, tvec=g.tvec,
                )
            self.db.commit()
            n_ok += ok

        window: deque = deque()
        with ThreadPoolExecutor(max_workers=2) as pool:
            for c0 in range(0, len(pair_list), chunk):
                prep = self._prep(pair_list[c0 : c0 + chunk])  # caller thread: SQLite reads
                window.append(pool.submit(self._process_chunk, prep))
                while len(window) > 2:
                    flush(window.popleft())
            while window:
                flush(window.popleft())
        return n_ok

    def match_pair(self, id1: int, id2: int) -> int:
        """Match + verify (+ guided re-match) + write one pair. Returns the
        inlier count."""
        kp1, d1_u8, v1, n1 = self._feats_host(id1)
        kp2, d2_u8, v2, n2 = self._feats_host(id2)
        if n1 == 0 or n2 == 0:
            return 0
        dev = self.device
        # the guided re-match masks a float similarity matrix: float route
        d1, d2 = self._feats_float(id1, d1_u8), self._feats_float(id2, d2_u8)
        v1t, v2t = torch.as_tensor(v1, device=dev), torch.as_tensor(v2, device=dev)
        mopts = self._mopts()
        idx, ok, sim1 = matching_ops.match_descriptors(d1, d2, v1t, v2t, mopts)
        pairs = matching_ops.matches_to_pairs(idx, ok)
        if len(pairs) < self.cfg.min_num_inliers:
            self.db.write_matches(id1, id2, np.zeros((0, 2), np.uint32))
            return 0
        self.db.write_matches(id1, id2, pairs)

        cam1 = self.cameras[self.images[id1]["camera_id"]]
        cam2 = self.cameras[self.images[id2]["camera_id"]]
        g = two_view_mod.estimate_two_view_geometry(
            kp1[pairs[:, 0], :2], kp2[pairs[:, 1], :2],
            np_geom.pad_params(cam1["params"][: cm.NUM_PARAMS[cam1["model_id"]]], cam1["model_id"]),
            np_geom.pad_params(cam2["params"][: cm.NUM_PARAMS[cam2["model_id"]]], cam2["model_id"]),
            cam1["model_id"], cam2["model_id"],
            two_view_mod.TwoViewOptions(
                max_error=self.cfg.max_error, min_num_inliers=self.cfg.min_num_inliers,
            ),
            quality=sim1.cpu().numpy()[pairs[:, 0]],
            device=dev,
        )
        inlier_rows = g.inlier_matches[:, 0] if len(g.inlier_matches) else np.zeros(0, np.int64)

        if self.cfg.guided_matching and g.F is not None and len(inlier_rows) >= self.cfg.min_num_inliers:
            gi, gok = matching_ops.match_guided(
                d1, d2,
                torch.as_tensor(kp1[:, :2], device=dev), torch.as_tensor(kp2[:, :2], device=dev),
                v1t, v2t, torch.as_tensor(g.F, dtype=torch.float32, device=dev), mopts,
            )
            gpairs = matching_ops.matches_to_pairs(gi, gok)
            if len(gpairs) > len(inlier_rows):
                self.db.write_two_view_geometry(
                    id1, id2, gpairs, g.config, F=g.F, E=g.E, H=g.H, qvec=g.qvec, tvec=g.tvec,
                )
                self.db.commit()
                return len(gpairs)

        inliers = pairs[inlier_rows] if len(inlier_rows) else np.zeros((0, 2), np.uint32)
        self.db.write_two_view_geometry(
            id1, id2, inliers, g.config, F=g.F, E=g.E, H=g.H, qvec=g.qvec, tvec=g.tvec
        )
        self.db.commit()
        return len(inliers)


def run_exhaustive_matcher(
    database_path: str,
    config: SiftMatchingConfig = SiftMatchingConfig(),
    block_size: int = 50,
    device=None,
) -> int:
    """All-pairs matching in blocks (ExhaustiveFeatureMatcher,
    matching.h:401)."""
    db = Database(database_path)
    w = _MatchWorker(db, config, device)
    ids = sorted(db.images().keys())
    pair_list = []
    for bi in range(0, len(ids), block_size):
        for bj in range(bi, len(ids), block_size):
            for i in ids[bi : bi + block_size]:
                for j in ids[bj : bj + block_size]:
                    if j > i:
                        pair_list.append((i, j))
    n = w.match_pairs(pair_list)
    db.close()
    return n


def sequential_pair_list(ids: list[int], overlap: int, quadratic_overlap: bool):
    """Deduped sequential pair list (SequentialFeatureMatcher pair policy)."""
    seen: set[tuple[int, int]] = set()
    pair_list: list[tuple[int, int]] = []
    for a, i in enumerate(ids):
        for d in range(1, overlap + 1):
            offsets = [d, (1 << d)] if quadratic_overlap else [d]
            for off in offsets:
                b = a + off
                if b < len(ids) and (i, ids[b]) not in seen:
                    seen.add((i, ids[b]))
                    pair_list.append((i, ids[b]))
    return pair_list


def _retrieval_index(db: Database, ids: list, with_geoms: bool, device):
    """VLAD index of the database's images on `device`, with the keypoint
    geometries that vote-and-verify re-ranking reads when asked for."""
    return retrieval.build_index(
        {i: np.asarray(db.read_descriptors(i), np.float32) for i in ids},
        geoms_by_image={
            i: np.asarray(db.read_keypoints(i), np.float32)[:, :4] for i in ids
        } if with_geoms else None,
        device=device,
    )


def run_sequential_matcher(
    database_path: str,
    config: SiftMatchingConfig = SiftMatchingConfig(),
    overlap: int = 10,
    quadratic_overlap: bool = True,
    loop_detection: bool = False,
    loop_detection_period: int = 10,
    loop_detection_num_images: int = 30,
    loop_spatial_rerank: bool = False,
    device=None,
) -> int:
    """Consecutive-pair matching with optional retrieval loop closure
    (SequentialFeatureMatcher, matching.h:434): every loop_detection_period
    -th image queries the VLAD index for loop_detection_num_images
    candidates. loop_spatial_rerank re-ranks them by vote-and-verify
    effective inliers, the false-loop suppressor on repetitive structure."""
    db = Database(database_path)
    w = _MatchWorker(db, config, device)
    ids = sorted(db.images().keys())  # name-ordered assumed == id order
    pair_list = sequential_pair_list(ids, overlap, quadratic_overlap)
    n = w.match_pairs(pair_list)
    if loop_detection:
        index = _retrieval_index(db, ids, loop_spatial_rerank, w.device)
        # set-based dedup, seeded with the sequential pairs so overlapping
        # loop candidates are neither re-matched nor double-counted
        seen = {(min(i, j), max(i, j)) for i, j in pair_list}
        loop_pairs = []
        for a in range(0, len(ids), loop_detection_period):
            i = ids[a]
            for j in retrieval.query(index, i, loop_detection_num_images, rerank=loop_spatial_rerank):
                key = (min(i, j), max(i, j))
                if j != i and key not in seen:
                    seen.add(key)
                    loop_pairs.append(key)
        n += w.match_pairs(loop_pairs)
    db.close()
    return n


def run_spatial_matcher(
    database_path: str,
    locations: dict[int, np.ndarray],
    config: SiftMatchingConfig = SiftMatchingConfig(),
    max_num_neighbors: int = 50,
    max_distance: float = 100.0,
    device=None,
) -> int:
    """Position-prior neighbor matching (SpatialFeatureMatcher,
    matching.h:474): match each image against its nearest neighbors in space."""
    db = Database(database_path)
    w = _MatchWorker(db, config, device)
    ids = [i for i in sorted(db.images().keys()) if i in locations]
    locs = np.stack([locations[i] for i in ids])
    pair_list = []
    for a, i in enumerate(ids):
        d = np.linalg.norm(locs - locs[a], axis=1)
        order = np.argsort(d)
        cnt = 0
        for b in order:
            j = ids[int(b)]
            if j == i or d[b] > max_distance:
                continue
            if cnt >= max_num_neighbors:
                break
            cnt += 1
            if j > i and (i, j) not in pair_list:
                pair_list.append((i, j))
    n = w.match_pairs(pair_list)
    db.close()
    return n


def run_transitive_matcher(
    database_path: str,
    config: SiftMatchingConfig = SiftMatchingConfig(),
    batch_size: int = 1000,
    num_iterations: int = 3,
    device=None,
) -> int:
    """Close the match graph transitively (TransitiveFeatureMatcher,
    matching.h:513): if A-B and B-C matched, try A-C."""
    db = Database(database_path)
    w = _MatchWorker(db, config, device)
    n = 0
    for _ in range(num_iterations):
        have = set()
        adj: dict[int, set[int]] = {}
        for i, j in db.all_two_view_pair_ids():
            adj.setdefault(i, set()).add(j)
            adj.setdefault(j, set()).add(i)
            have.add((min(i, j), max(i, j)))
        todo = []
        for nbrs in adj.values():
            for a in nbrs:
                for c in nbrs:
                    if a < c and (a, c) not in have:
                        todo.append((a, c))
                        have.add((a, c))
        if not todo:
            break
        n += w.match_pairs(todo[:batch_size])
    db.close()
    return n


def run_image_pairs_matcher(
    database_path: str,
    pairs: list[tuple[str, str]],
    config: SiftMatchingConfig = SiftMatchingConfig(),
    device=None,
) -> int:
    """Match an explicit list of image-name pairs (ImagePairsFeatureMatcher)."""
    db = Database(database_path)
    w = _MatchWorker(db, config, device)
    by_name = {v["name"]: k for k, v in db.images().items()}
    pair_list = []
    for n1, n2 in pairs:
        if n1 in by_name and n2 in by_name:
            i, j = by_name[n1], by_name[n2]
            if i != j and (min(i, j), max(i, j)) not in pair_list:
                pair_list.append((min(i, j), max(i, j)))
    n = w.match_pairs(pair_list)
    db.close()
    return n


def run_feature_pairs_importer(
    database_path: str,
    pairs_file: str,
    config: SiftMatchingConfig = SiftMatchingConfig(),
    verify: bool = True,
    device=None,
) -> int:
    """Import raw feature-index matches from a text file
    (FeaturePairsFeatureMatcher, matching.h:538): blocks of 'name1 name2'
    followed by 'idx1 idx2' lines, blank-line separated. With verify=True
    the imported matches get two-view verification."""
    db = Database(database_path)
    by_name = {v["name"]: k for k, v in db.images().items()}
    w = _MatchWorker(db, config, device)
    n = 0
    with open(pairs_file) as f:
        blocks = f.read().split("\n\n")
    for block in blocks:
        lines = [ln for ln in block.splitlines() if ln.strip()]
        if not lines:
            continue
        n1, n2 = lines[0].split()[:2]
        if n1 not in by_name or n2 not in by_name:
            continue
        id1, id2 = by_name[n1], by_name[n2]
        m = np.asarray(
            [[int(a), int(b)] for a, b in (ln.split()[:2] for ln in lines[1:])], np.uint32,
        ).reshape(-1, 2)
        db.write_matches(id1, id2, m)
        if verify and len(m) >= config.min_num_inliers:
            kp1 = w._feats_host(id1)[0]
            kp2 = w._feats_host(id2)[0]
            cam1 = w.cameras[w.images[id1]["camera_id"]]
            cam2 = w.cameras[w.images[id2]["camera_id"]]
            g = two_view_mod.estimate_two_view_geometry(
                kp1[m[:, 0], :2], kp2[m[:, 1], :2],
                np_geom.pad_params(cam1["params"][: cm.NUM_PARAMS[cam1["model_id"]]], cam1["model_id"]),
                np_geom.pad_params(cam2["params"][: cm.NUM_PARAMS[cam2["model_id"]]], cam2["model_id"]),
                cam1["model_id"], cam2["model_id"], device=w.device,
            )
            inl = m[g.inlier_matches[:, 0]] if len(g.inlier_matches) else np.zeros((0, 2), np.uint32)
            db.write_two_view_geometry(id1, id2, inl, g.config, F=g.F, E=g.E, H=g.H)
        else:
            db.write_two_view_geometry(id1, id2, m, two_view_mod.CALIBRATED)
        db.commit()
        n += 1
    db.close()
    return n


def run_vocab_tree_matcher(
    database_path: str,
    config: SiftMatchingConfig = SiftMatchingConfig(),
    num_images: int = 100,
    spatial_rerank: bool = False,
    num_verify: int = 20,
    device=None,
) -> int:
    """Retrieval-based matching (VocabTreeFeatureMatcher, matching.h:455):
    VLAD global descriptors instead of a FLANN vocab tree; every image is
    matched against its num_images most similar. spatial_rerank re-orders
    each query's top num_verify by vote-and-verify effective inlier count
    (retrieval/vote_and_verify.cc analog, ops/vote_verify.py)."""
    db = Database(database_path)
    w = _MatchWorker(db, config, device)
    ids = sorted(db.images().keys())
    index = _retrieval_index(db, ids, spatial_rerank, w.device)
    pair_list, seen = [], set()
    for i in ids:
        for j in retrieval.query(index, i, num_images, rerank=spatial_rerank, num_verify=num_verify):
            if j > i and (i, j) not in seen:
                seen.add((i, j))
                pair_list.append((i, j))
    n = w.match_pairs(pair_list)
    db.close()
    return n
