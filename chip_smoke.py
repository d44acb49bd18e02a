#!/usr/bin/env python3
"""Smoke run of the PyTorch port (colmap_pcd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--n-images 100] [--seed 0]

Phases, each printing its numbers on its own line:
  1. environment: the card's name and power limit (nvidia-smi), torch/CUDA;
  2. build: the hand-written CUDA kernel K2 (nn_argmin) from the sources in
     colmap_pcd_tpu_torch/csrc, with its ptxas report;
  3. K2 against its plain PyTorch version on the card at the mapper's
     shapes (Q in {37, 4096} queries against the smoke world's ~0.5 M-point
     map and a ragged map), with CUDA-event times of both and the median
     host-clock time of the C++ kd-tree;
  4. the main path: a synthetic corridor world (100 images, 0.8 m step,
     640x480, f = 500, ~2 000 keypoints per image) written to a COLMAP
     database, a lidar PLY and a pose-prior file, then
     `python -m colmap_pcd_tpu_torch mapper ...` through `cli.main`, and
     the model read back;
  5. checks: K2 launched on the main path, >= 95% of images registered,
     ATE < 0.10 m, scale error < 2%.

Any failure raises (non-zero exit, no result line). The last lines are the
kernels' JSON record, the nvidia-smi line, and
{"ok": true, "device": {...}}. Without CUDA it exits non-zero at once.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# K2's agreement with its plain version: distances to 1e-5 relative;
# indices equal except where both points are equally near (f32 ties)
DIST_RTOL = 1e-5


def _log(msg: str):
    print(msg, flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of fn() over reps launches, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernel(map_pts: np.ndarray, rng) -> dict:
    """Phase 3: K2 against its plain version at the mapper's shapes."""
    import torch

    from colmap_pcd_tpu_torch.ops import nn_kernel
    from colmap_pcd_tpu_torch.utils.native import NativeKdTree, get_lib

    dev = torch.device("cuda")
    if get_lib() is None:
        raise RuntimeError("the native host runtime (cpp/native.cpp) did not build")
    ragged = 100_003
    record = {"max_abs_err": 0.0}
    for n_map in (map_pts.shape[0], ragged):
        pts = map_pts[:n_map]
        pts_d = torch.as_tensor(pts, device=dev)
        tree = NativeKdTree(pts)
        for Q in (37, 4096):
            q = (pts[rng.integers(0, n_map, Q)] + rng.normal(0, 0.2, (Q, 3))).astype(np.float32)
            q_d = torch.as_tensor(q, device=dev)
            idx, dist = nn_kernel.nn_argmin(q_d, pts_d)
            torch.cuda.synchronize()
            ref_idx, ref_dist = nn_kernel.nn_argmin_reference(q_d, pts_d)
            idx, dist, ref_idx, ref_dist = (
                a.cpu().numpy() for a in (idx, dist, ref_idx, ref_dist)
            )
            err = float(np.max(np.abs(dist - ref_dist)))
            rel = float(np.max(np.abs(dist - ref_dist) / np.maximum(ref_dist, 1e-6)))
            mism = np.nonzero(idx != ref_idx)[0]
            d_k = np.linalg.norm(pts[idx[mism]].astype(np.float64) - q[mism], axis=-1)
            d_r = np.linalg.norm(pts[ref_idx[mism]].astype(np.float64) - q[mism], axis=-1)
            if rel > DIST_RTOL or not np.allclose(d_k, d_r, rtol=DIST_RTOL, atol=0.0):
                raise AssertionError(
                    f"K2 disagrees with its plain version at Q={Q} N={n_map}: "
                    f"max rel dist err {rel:.3g}, {mism.size} index mismatches"
                )
            ms = _cuda_ms(lambda: nn_kernel.nn_argmin(q_d, pts_d), 20)
            plain_ms = _cuda_ms(lambda: nn_kernel.nn_argmin_reference(q_d, pts_d), 3)
            _, host_dist = tree.nn(q)  # warm-up (OpenMP threads) and a third opinion
            host_rel = float(np.max(np.abs(host_dist - dist) / np.maximum(dist, 1e-6)))
            if host_rel > DIST_RTOL:
                raise AssertionError(f"K2 and the host kd-tree disagree: max rel {host_rel:.3g}")
            host_s = []
            for _ in range(20):
                t0 = time.perf_counter()
                tree.nn(q)
                host_s.append(time.perf_counter() - t0)
            host_ms = float(np.median(host_s)) * 1e3
            _log(
                f"[k2] Q={Q} N={n_map}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"host kd-tree {host_ms:.4f} ms (host clock, median of 20); "
                f"max abs dist err {err:.3g} m, "
                f"max rel {rel:.3g}, index mismatches at equal distance {mism.size}"
            )
            record["max_abs_err"] = max(record["max_abs_err"], err)
            if Q == 4096 and n_map == map_pts.shape[0]:
                record.update(ms=ms, plain_ms=plain_ms)
    return record


def run_mapper(paths: dict, gt, out_dir: str) -> dict:
    """Phase 4: the port's `mapper` command on the world's files."""
    import torch

    from colmap_pcd_tpu_torch import cli
    from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction
    from colmap_pcd_tpu_torch.ops import nn_kernel
    from colmap_pcd_tpu_torch.utils.logging_utils import PHASES
    from synthetic_torch import ate_rmse, mapper_argv, scale_error

    nn_kernel.nn_argmin.launches = 0
    PHASES.totals.clear()
    PHASES.counts.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(mapper_argv(paths, out_dir))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = nn_kernel.nn_argmin.launches
    if rc != 0:
        raise RuntimeError(f"mapper exited with {rc}")
    recs = [Reconstruction.read(os.path.join(out_dir, d)) for d in sorted(os.listdir(out_dir))]
    rec = max(recs, key=lambda r: r.num_reg_images)
    solves = PHASES.counts.get("ba_solves", 0)
    return {
        "models": len(recs),
        "registered": rec.num_reg_images,
        "ate_m": ate_rmse(rec, gt),
        "scale_err": scale_error(rec, gt),
        "seconds": seconds,
        "frames_per_s": rec.num_reg_images / seconds,
        "k2_launches": launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "ba_solves": solves,
        "lm_syncs_per_solve": PHASES.counts.get("ba_lm_syncs", 0) / max(solves, 1),
        "phases": PHASES.report(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-images", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from colmap_pcd_tpu_torch.ops import nn_kernel
    from synthetic_torch import make_world, write_world

    # 1. environment
    smi = _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    _log(f"[env] nvidia-smi: {smi}")
    _log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
         f"count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    nn_kernel.build()
    _log(f"[build] nn_argmin.cu built and loaded in {time.perf_counter() - t0:.2f} s")
    for log in sorted(os.listdir(nn_kernel.BUILD_DIR)):
        if log.endswith(".log"):
            with open(os.path.join(nn_kernel.BUILD_DIR, log)) as f:
                for line in f:
                    if "registers" in line or "spill" in line:
                        _log(f"[build] {line.strip()}")

    # the world of phases 3 and 4 (host numpy; the map goes to the card in phase 4)
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    rec, graph, lmap, gt = make_world(
        rng, n_images=args.n_images, n_points=110 * args.n_images, noise_px=0.4, step=0.8,
    )
    kps = [img.xys.shape[0] for img in rec.images.values()]
    _log(f"[world] {args.n_images} images, {lmap.num_points} map points, "
         f"{np.mean(kps):.0f} keypoints/image, {len(graph.image_pairs())} matched pairs, "
         f"built in {time.perf_counter() - t0:.2f} s")

    # 3. K2 against its plain version
    k2 = check_kernel(lmap.points, np.random.default_rng(args.seed + 1))

    # 4. the main path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        paths = write_world(rec, graph, lmap, gt, tmp)
        res = run_mapper(paths, gt, os.path.join(tmp, "model"))
    _log(f"[mapper] registered {res['registered']}/{args.n_images} in {res['models']} model(s), "
         f"ATE {res['ate_m']:.6f} m, scale error {res['scale_err']:.6f}")
    _log(f"[mapper] {res['seconds']:.3f} s end to end (cli.main), "
         f"{res['frames_per_s']:.4f} frames registered/s")
    _log(f"[mapper] K2 launches {res['k2_launches']}, peak device memory "
         f"{res['peak_mem_bytes'] / 2**20:.1f} MiB, {res['ba_solves']} BA solves, "
         f"{res['lm_syncs_per_solve']:.2f} LM host syncs per solve")
    _log("[mapper] phases:\n" + res["phases"])

    # 5. checks
    if res["k2_launches"] <= 0:
        raise AssertionError("the main path never launched K2")
    if res["registered"] < 0.95 * args.n_images:
        raise AssertionError(f"registered {res['registered']} < 95% of {args.n_images}")
    if not res["ate_m"] < 0.10:
        raise AssertionError(f"ATE {res['ate_m']} m >= 0.10 m")
    if not res["scale_err"] < 0.02:
        raise AssertionError(f"scale error {res['scale_err']} >= 2%")

    print(json.dumps({"kernels": [{
        "name": "nn_argmin",
        "route": "cuda",
        "source": "colmap_pcd_tpu_torch/csrc/nn_argmin.cu",
        "replaces": "colmap_pcd_tpu/ops/pallas_kernels.py:191",
        "launches": res["k2_launches"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
