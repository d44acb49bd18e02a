#!/usr/bin/env python3
"""End-to-end benchmark of the PyTorch port (colmap_pcd_tpu_torch) on one
NVIDIA GPU: pixels -> SIFT -> matching -> lidar-constrained incremental
mapping, the port's counterpart of the JAX package's bench.py.

    python3 bench_torch.py
    BENCH_REF_SCALE=1 BENCH_OVERLAP=0 python3 bench_torch.py
    BENCH_CPU=1 BENCH_N_IMAGES=6 python3 bench_torch.py

Settings, bench.py's environment variables and no others:
  BENCH_N_IMAGES   views along the corridor trajectory (default 100);
  BENCH_REF_SCALE  1: the reference feature scale, 1280x960, f = 1000, 8192
                   features, 4 octaves; 0 (default): the light scale,
                   640x480, f = 500, 2048 features, 3 octaves;
  BENCH_OVERLAP    1 (default): extraction, matching and mapping at once,
                   run_overlapped_frontend feeding the controller; 0: the
                   extractor, then the sequential matcher, then the mapper
                   on the pairs with >= 15 inlier matches;
  BENCH_VERBOSE    1 (default): the controller's progress on stderr;
  BENCH_CPU        set: compute on the CPU, asked for by name.

The world is tests/synthetic_torch.py's: the corridor trajectory at a 0.8 m
step, ray-cast into PNGs before the clock starts, and its lidar map. The
timed window runs, as bench.py's does, from the start of the front end to
the end of the mapper, and includes building the corridor map and its
LidarMap. Both branches match the sequential pairs at overlap 5 without the
quadratic offsets (min_num_inliers 15) with the reader's default camera, and
map with bench.py's MapperOptions, the known PINHOLE camera and the pose
prior of image 1.

The last line of stdout is one JSON object with bench.py's keys, except
`mfu` and `model_tflops` (bench.py's TPU FLOP accounting, which has no
counterpart here); `device` is the card's name and power limit as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them,
or "cpu". The lines before it, on stderr, carry the progress, each hand
kernel's launches (with the largest K2 query count and uint8-K1 cap), the
peak device memory, the BA solves and LM host syncs per solve, and the
mapper's PHASES report. Without a card, and without BENCH_CPU, it prints
bench.py's error line and exits 1: it never falls back to the CPU. The
kernels are built from colmap_pcd_tpu_torch/csrc while the views render.
Imports nothing of JAX.
"""

from __future__ import annotations

import ast
import faulthandler
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "tests"))  # the synthetic world, as bench.py's

from colmap_pcd_tpu_torch import device as device_mod  # noqa: E402
from colmap_pcd_tpu_torch.models.controllers import ControllerOptions, IncrementalMapperController  # noqa: E402
from colmap_pcd_tpu_torch.models.correspondence_graph import CorrespondenceGraph  # noqa: E402
from colmap_pcd_tpu_torch.models.database import Database  # noqa: E402
from colmap_pcd_tpu_torch.models.feature_pipeline import (  # noqa: E402
    ImageReaderConfig,
    run_feature_extractor,
    run_sequential_matcher,
)
from colmap_pcd_tpu_torch.models.incremental_mapper import MapperOptions  # noqa: E402
from colmap_pcd_tpu_torch.models.lidar_map import LidarMap  # noqa: E402
from colmap_pcd_tpu_torch.models.overlap import run_overlapped_frontend  # noqa: E402
from colmap_pcd_tpu_torch.models.reconstruction import Camera, Image, Reconstruction  # noqa: E402
from colmap_pcd_tpu_torch.ops import match_kernel, nn_kernel, np_geom  # noqa: E402
from colmap_pcd_tpu_torch.ops import pointcloud as pc_ops  # noqa: E402
from colmap_pcd_tpu_torch.utils.config import SiftExtractionConfig, SiftMatchingConfig  # noqa: E402
from colmap_pcd_tpu_torch.utils.logging_utils import PHASES  # noqa: E402
from synthetic_torch import ate_rmse, build_corridor_map, make_trajectory, render_images, scale_error  # noqa: E402

# bench.py's baseline (bench.py:21-25, 48): the reference publishes no
# numbers, only "a few minutes for tens of images"
REFERENCE_FPS = 25.0 / 180.0
BASELINE_SOURCE = ("doc/tutorial.rst:354 guidance 25 img/180 s (reference unbuildable here: zero egress, "
                   "no Ceres/PCL/Qt)")
STEP = 0.8
PINHOLE = 1
# (width, height, focal, features, octaves) of bench.py's two scales (bench.py:53-59)
LIGHT_SCALE = (640, 480, 500.0, 2048, 3)
REF_SCALE = (1280, 960, 1000.0, 8192, 4)
OVERLAP, MIN_NUM_INLIERS = 5, 15
# the lidar mapper's options on SIFT features (bench.py:184-192)
BENCH_MAPPER_OPTIONS = dict(
    if_add_lidar_constraint=True, init_image_id1=1, init_image_id2=2, init_min_num_inliers=40,
    abs_pose_min_num_inliers=12, abs_pose_min_inlier_ratio=0.15, num_ransac_hypotheses=2048,
    filter_max_reproj_error=6.0,
)
# bench.py's keys that this line leaves out: its TPU FLOP accounting
DROPPED_KEYS = ("mfu", "model_tflops")


def _log(msg: str):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _quiet(msg: str):
    pass


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_counters() -> dict:
    """The hand kernels' wrappers by name; each counts its launches."""
    return {"match_top2": match_kernel.match_top2, "match_top2_u8": match_kernel.match_top2_u8,
            "nn_argmin": nn_kernel.nn_argmin}


def counted(fn, counters: dict, device="cuda"):
    """fn() with the given launch counters zeroed just before it and read
    just after; host-clock seconds end at a device sync on CUDA. Returns
    (fn's value, seconds, launches)."""
    for wrapper in counters.values():
        wrapper.launches = 0
        for record in ("max_queries", "max_cap"):  # the largest shapes launched
            if hasattr(wrapper, record):
                setattr(wrapper, record, 0)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    seconds = time.perf_counter() - t0
    return out, seconds, {name: wrapper.launches for name, wrapper in counters.items()}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_phases():
    PHASES.reset()


def mapper_numbers(seconds: float, registered: int, device="cuda") -> dict:
    """What the mapper's PHASES counters and the allocator say of a run;
    peak device memory is None on the CPU."""
    solves = PHASES.counts.get("ba_solves", 0)
    cuda = torch.device(device).type == "cuda"
    return {
        "seconds": seconds,
        "frames_per_s": registered / seconds,
        "peak_mem_bytes": torch.cuda.max_memory_allocated() if cuda else None,
        "ba_solves": solves,
        "lm_syncs_per_solve": PHASES.counts.get("ba_lm_syncs", 0) / max(solves, 1),
        "phases": PHASES.report(),
    }


def render_world(n_images: int, tmp: str, scale=LIGHT_SCALE, workers: int = 8) -> dict:
    """bench.py's world: the corridor trajectory over n_images views (the
    twin of bench.make_gt) ray-cast at `scale` into tmp/images on `workers`
    threads."""
    t0 = time.perf_counter()
    gt = make_trajectory(n_images, STEP)
    img_dir = os.path.join(tmp, "images")
    os.makedirs(img_dir)
    render_images(img_dir, gt, *scale[:3], workers=workers)
    return {"gt": gt, "images": img_dir, "scale": tuple(scale), "seconds": time.perf_counter() - t0}


def rates(reg_times: list, n_reg: int, map_s: float) -> tuple[float, float, list]:
    """bench.py's rates (bench.py:288-308) from (registered, seconds since
    the mapper started) at each registration: the steady rate over the
    second half of the registrations, the first half's, and the rate over a
    sliding window of 10 registrations at each; with fewer than 4
    registrations both rates are n_reg / map_s and the curve is empty."""
    curve = []
    if len(reg_times) < 4:
        steady = n_reg / map_s if map_s > 0 else 0.0
        return steady, steady, curve
    for k in range(1, len(reg_times)):
        k0 = max(0, k - 10)
        dn = reg_times[k][0] - reg_times[k0][0]
        dt = reg_times[k][1] - reg_times[k0][1]
        curve.append(round(dn / dt, 3) if dt > 0 else 0.0)
    mid = len(reg_times) // 2
    dn, dt = reg_times[-1][0] - reg_times[mid][0], reg_times[-1][1] - reg_times[mid][1]
    steady = dn / dt if dt > 0 else 0.0
    dn, dt = reg_times[mid][0] - reg_times[0][0], reg_times[mid][1] - reg_times[0][1]
    return steady, dn / dt if dt > 0 else 0.0, curve


def error_profile(rec: Reconstruction, gt) -> list:
    """(image id, metres from its true centre) of each registered image, in
    image order (bench.py:271-278)."""
    errs = []
    for i, (q, t) in enumerate(gt, start=1):
        img = rec.images.get(i)
        if img is not None and img.registered:
            errs.append((i, float(np.linalg.norm(img.projection_center() - np_geom.projection_center(q, t)))))
    return errs


def bench_line(res: dict, scale, device: str) -> dict:
    """bench.py's JSON line (bench.py:317-349) but DROPPED_KEYS, from what
    `run_bench` returns."""
    n_images, errs = res["n_images"], res["errors"]
    es = np.asarray([e for _, e in errs])
    curve = res["rate_curve"]
    match_s, n_pairs = res["match_seconds"], res["pairs_verified"]
    busy = res["match_busy_seconds"] or match_s
    W, H, _, features, _ = scale
    return {
        "metric": "frames_registered_per_s",
        "value": round(res["steady_frames_per_s"], 4),
        "unit": "frames/s",
        "vs_baseline": round(res["steady_frames_per_s"] / REFERENCE_FPS, 2),
        "baseline_source": BASELINE_SOURCE,
        "n_images": n_images,
        "registered": res["registered"],
        "ate_m": round(res["ate_m"], 4),
        "ate_profile_mm": {
            "p50": round(float(np.median(es)) * 1000, 1),
            "p90": round(float(np.percentile(es, 90)) * 1000, 1),
            "max": round(float(es.max()) * 1000, 1),
        } if errs else None,
        "err_curve_mm": [round(e * 1000, 1) for _, e in errs[:: max(1, len(errs) // 40)]],
        "first_half_fps": round(res["first_half_fps"], 4),
        "reg_s_curve": curve[:: max(1, len(curve) // 40)],
        "extract_img_per_s": round(n_images / res["extract_seconds"], 3),
        "match_pairs_per_s": round(n_pairs / max(match_s, 1e-9), 3),
        "match_pairs_per_s_busy": round(n_pairs / max(busy, 1e-9), 3),
        "match_wall_s": round(match_s, 2),
        "mapping_wall_s": round(res["seconds"], 2),
        "e2e_wall_s": round(res["wall_seconds"], 2),
        "device": device,
        "feature_scale": {"max_num_features": features, "image_wh": [W, H], "ref_scale": tuple(scale) == REF_SCALE},
    }


def bench_py_line_keys() -> set:
    """The keys of bench.py's result line, read from its source (the dict
    printed by json.dumps that holds "e2e_wall_s"), without importing it."""
    path = os.path.join(REPO, "bench.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if "e2e_wall_s" in keys:
                return keys
    raise ValueError(f"no result line in {path}")


def _sequential_frontend(rec, database, img_dir, n, extraction, matching, reader, dev, log):
    """bench.py:212-236: the extractor, the sequential matcher, then the
    images into `rec` and the graph from the database. Returns (graph,
    numbers)."""
    t0 = time.perf_counter()
    run_feature_extractor(database, img_dir, extraction, reader, device=dev)
    extract_s = time.perf_counter() - t0
    log(f"extraction: {n} images in {extract_s:.1f}s ({n / extract_s:.2f} img/s)")
    t0 = time.perf_counter()
    n_pairs = run_sequential_matcher(database, matching, overlap=OVERLAP, quadratic_overlap=False, device=dev)
    match_s = time.perf_counter() - t0
    log(f"matching: {n_pairs} verified pairs in {match_s:.1f}s ({n_pairs / max(match_s, 1e-9):.2f} pairs/s)")
    db = Database(database)
    for iid, im in sorted(db.images().items()):
        rec.add_image(Image(iid, im["name"], 1, xys=db.read_keypoints(iid)[:, :2].astype(np.float64)))
    graph = CorrespondenceGraph()
    pairs = db.all_two_view_pair_ids()
    for i, j in pairs:
        g = db.read_two_view_geometry(i, j)
        if g is not None and len(g["inlier_matches"]) >= MIN_NUM_INLIERS:
            graph.add_matches(i, j, g["inlier_matches"].astype(np.int32))
    db.close()
    return graph, {"extract_seconds": extract_s, "match_seconds": match_s, "match_busy_seconds": None,
                   "pairs_matched": len(pairs), "pairs_verified": n_pairs}


def run_bench(world: dict, tmp: str, overlapped: bool = True, device="cuda", verbose: bool = False,
              pinhole_reader: bool = False, log=_quiet) -> dict:
    """bench.py's run (bench.py:178-308) on a world of `render_world`'s form,
    through the port's entry points, with the launch counts zeroed just
    before it: the overlapped or the sequential front end, the corridor map
    built inside the timed window, IncrementalMapperController, the threads
    joined (one still alive, or an error in the feed, raises), the ATE,
    error profile and rates. The database's camera comes from the reader's
    defaults, as bench.py gives none (the matcher verifies with it), or is
    the known PINHOLE with `pinhole_reader`. Returns the numbers with the
    model as "rec" and the map's points as "map_points"."""
    dev = device_mod.resolve(device)
    gt, img_dir = world["gt"], world["images"]
    n_images = len(gt)
    W, H, F, features, octaves = world["scale"]
    database = os.path.join(tmp, "db.db")
    reader = (ImageReaderConfig(camera_model="PINHOLE", camera_params=f"{F},{F},{W / 2},{H / 2}")
              if pinhole_reader else ImageReaderConfig())
    extraction = SiftExtractionConfig(max_num_features=features, first_octave=0, num_octaves=octaves,
                                      max_image_size=W)
    matching = SiftMatchingConfig(min_num_inliers=MIN_NUM_INLIERS)
    kernels = kernel_counters()
    reg_times = []  # (registered, seconds since the mapper started) per registration
    reset_phases()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def drive():
        wall_t0 = time.perf_counter()
        feed = t_extract = t_match = None
        rec = Reconstruction()
        rec.add_camera(Camera(1, PINHOLE, W, H, np.asarray([F, F, W / 2, H / 2])))
        if overlapped:
            feed, t_extract, t_match = run_overlapped_frontend(
                database, img_dir, extraction, matching, reader, overlap=OVERLAP, quadratic_overlap=False,
                device=dev)
            graph, front = CorrespondenceGraph(), {}
        else:
            graph, front = _sequential_frontend(rec, database, img_dir, n_images, extraction, matching, reader,
                                                dev, log)
        # inside the timed window, as bench.py builds it (overlapped: while extraction streams)
        map_pts, map_nrm = build_corridor_map(np.random.default_rng(0), length=n_images * STEP + 25)
        lmap = LidarMap.from_arrays(map_pts, map_nrm, pc_ops.ProjOptions(), device=dev)
        ctl = IncrementalMapperController(
            rec, graph, MapperOptions(**BENCH_MAPPER_OPTIONS),
            ControllerOptions(verbose=verbose, image_path=img_dir),
            lidar_map=lmap, pose_priors={1: gt[0]}, pair_feed=feed, device=dev,
        )
        map_t0 = time.perf_counter()
        ctl.callbacks.append(lambda _iid: reg_times.append((rec.num_reg_images, time.perf_counter() - map_t0)))
        ok = ctl.reconstruct()
        _sync(dev)
        map_s = time.perf_counter() - map_t0
        wall_s = time.perf_counter() - wall_t0
        if overlapped:
            t_extract.join(timeout=300)
            t_match.join(timeout=300)
            if t_extract.is_alive() or t_match.is_alive():
                raise RuntimeError("the overlapped front end's threads did not end")
            if feed.error is not None:
                raise RuntimeError(f"the overlapped front end failed: {feed.error!r}")
            front = {"extract_seconds": feed.extract_s or 1e-9, "match_seconds": feed.match_s or 1e-9,
                     "match_busy_seconds": feed.match_busy_s, "pairs_matched": feed.n_pairs_matched,
                     "pairs_verified": feed.n_pairs_verified}
            log(f"extraction thread: {n_images} images in {front['extract_seconds']:.1f}s "
                f"({n_images / front['extract_seconds']:.2f} img/s, overlapped)")
            busy = front["match_busy_seconds"] or front["match_seconds"]
            log(f"matching thread: {front['pairs_verified']} verified pairs in {front['match_seconds']:.1f}s wall "
                f"/ {busy:.1f}s busy ({front['pairs_verified'] / max(busy, 1e-9):.2f} pairs/s busy, "
                f"overlapped with extraction + mapping)")
        return rec, ok, map_pts, map_s, wall_s, front

    (rec, ok, map_pts, map_s, wall_s, front), _, launches = counted(drive, kernels, dev)
    max_q, max_cap = kernels["nn_argmin"].max_queries, kernels["match_top2_u8"].max_cap
    n_reg = rec.num_reg_images
    ate = ate_rmse(rec, gt) if ok else float("inf")
    errs = error_profile(rec, gt)
    if errs:
        es = np.asarray([e for _, e in errs])
        log(f"ATE profile: p50 {np.median(es) * 1000:.1f} p90 {np.percentile(es, 90) * 1000:.1f} max "
            f"{es.max() * 1000:.1f} mm (argmax image {errs[int(np.argmax(es))][0]})")
    log(f"mapping: {n_reg}/{n_images} images in {map_s:.1f}s, ATE {ate * 1000:.1f} mm")
    steady, first_half, curve = rates(reg_times, n_reg, map_s)
    db = Database(database)
    keypoints = [db.read_keypoints(i).shape[0] for i in sorted(db.images())]
    db_cameras = db.cameras()
    db.close()
    res = {
        "n_images": n_images, "ok": ok, "registered": n_reg, "ate_m": ate,
        "scale_err": scale_error(rec, gt) if ok and n_reg else float("inf"), "errors": errs,
        "reg_times": reg_times, "steady_frames_per_s": steady, "first_half_fps": first_half, "rate_curve": curve,
        "wall_seconds": wall_s, **front, "launches": launches, "max_queries": max_q, "max_cap": max_cap,
        "keypoints": keypoints, "db_cameras": db_cameras, "camera": rec.cameras[1].params.tolist(),
        "points": len(rec.points3D), "map_points": map_pts, "rec": rec,
    }
    res.update(mapper_numbers(map_s, n_reg, dev))
    log("phase breakdown:\n" + res["phases"])
    return res


def _error_line(error: str) -> dict:
    """bench.py's line when no device is available (bench.py:76-78)."""
    return {"metric": "frames_registered_per_s", "value": 0.0, "unit": "frames/s", "vs_baseline": 0.0,
            "error": f"device unavailable: {error}"}


def main() -> int:
    n_images = int(os.environ.get("BENCH_N_IMAGES", "100"))
    scale = REF_SCALE if os.environ.get("BENCH_REF_SCALE", "0") != "0" else LIGHT_SCALE
    overlapped = os.environ.get("BENCH_OVERLAP", "1") != "0"
    verbose = os.environ.get("BENCH_VERBOSE", "1") != "0"
    if os.environ.get("BENCH_CPU"):
        device = name = "cpu"
    elif not torch.cuda.is_available():
        print(json.dumps(_error_line("CUDA is not available; BENCH_CPU=1 asks for the CPU")))
        return 1
    else:
        device, name = "cuda", nvidia_smi()
    _log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    with tempfile.TemporaryDirectory(prefix="bench_torch_") as tmp, ThreadPoolExecutor(max_workers=2) as pool:
        # the kernels the path launches build (one nvcc each) while the views render
        builds = [pool.submit(b) for b in (nn_kernel.build, match_kernel.build_u8)] if device == "cuda" else []
        world = render_world(n_images, tmp, scale)
        for b in builds:
            b.result()
        W, H, F, features, octaves = scale
        _log(f"rendered {n_images} images ({W}x{H}, f = {F:g}) in {world['seconds']:.1f}s; "
             f"{features} features, {octaves} octaves, {'overlapped' if overlapped else 'sequential'}")
        res = run_bench(world, tmp, overlapped, device, verbose, log=_log)
    peak = "not measured (CPU)" if res["peak_mem_bytes"] is None else f"{res['peak_mem_bytes'] / 2**20:.1f} MiB"
    _log(f"kernel launches {res['launches']} (uint8 K1 at caps up to {res['max_cap']}, K2 at up to "
         f"{res['max_queries']} queries)")
    _log(f"peak device memory {peak}; {res['ba_solves']} BA solves, {res['lm_syncs_per_solve']:.2f} LM host "
         f"syncs per solve; scale error {res['scale_err']:.6f}")
    print(json.dumps(bench_line(res, scale, name)))
    return 0


if __name__ == "__main__":
    # kill -USR1 <pid> dumps every thread's Python stack to stderr
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    sys.exit(main())
