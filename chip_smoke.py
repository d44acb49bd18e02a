#!/usr/bin/env python3
"""Smoke run of the PyTorch port (colmap_pcd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--n-images 100] [--classic-images 20] [--seed 0]

Phases, each printing its numbers on its own line:
  1. environment: the card's name and power limit (nvidia-smi), torch/CUDA;
  2. build: the hand-written CUDA kernels K2 (nn_argmin) and K1
     (match_top2) from the sources in colmap_pcd_tpu_torch/csrc, one nvcc
     each, started together, with their ptxas reports;
  3. K2 against its plain PyTorch version at the mapper's shapes (Q in
     {37, 4096} queries against the smoke world's ~0.5 M-point map and a
     ragged map), with CUDA-event times of both and the median host-clock
     time of the C++ kd-tree;
  4. K1 against its plain PyTorch version: the matcher's chunk (B = 16
     pairs at cap 2048, ragged 1 500-2 048 valid rows), the smoke world's
     chunk (B = 16 at cap 4096, ragged 1 900-2 200), one pair at
     8192 x 8192, a ragged 1000 x 1537 pair and a pair with duplicated
     descriptors, with CUDA-event times of both;
  5. the main path: a synthetic corridor world (100 images, 0.8 m step,
     640x480, f = 500, ~2 000 keypoints per image plus 5% distractors, each
     with a SIFT-like uint8 descriptor) written to a COLMAP database with no
     matches, a lidar PLY and a pose-prior file; then through `cli.main`
     `sequential_matcher --SequentialMatching.overlap 5` (K1) and the lidar
     `mapper` (K2), each with the launch counts zeroed just before it; the
     written inlier matches are scored against the generator's
     correspondences and the model is read back;
  6. the classic path: a 20-image world (step 1.0, 0.2 px noise), the
     sequential matcher, then `mapper` without a lidar map, initialized on
     (1, 3); registered images, median reprojection error and the ATE after
     a sim(3) alignment;
  7. checks: K1 launched by the matcher and K2 by the mapper, match
     precision >= 0.95, lidar mapper >= 95% registered with ATE < 0.10 m and
     scale error < 2%, classic mapper >= 19/20 registered with median
     reprojection error < 1.0 px.

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# K2's agreement with its plain version: distances to 1e-5 relative;
# indices equal except where both points are equally near (f32 ties)
DIST_RTOL = 1e-5
# K1's agreement: similarities to 1e-6 absolute (f32 dot products of unit
# vectors summed in another order); indices equal wherever best and second
# best are more than 1e-6 apart; the accept decision equal except within
# 1e-6 of a threshold or at such a near-tie
SIM_ATOL = 1e-6


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


def _ptxas_lines(stem: str):
    from colmap_pcd_tpu_torch.ops.cuda_build import BUILD_DIR

    for log in sorted(os.listdir(BUILD_DIR)):
        if log.startswith(stem) and log.endswith(".log"):
            with open(os.path.join(BUILD_DIR, log)) as f:
                for line in f:
                    if "registers" in line or "spill" in line or "smem" in line:
                        yield line.strip()


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


def _k1_case(rng, B, N1, N2, n_lo=None, n_hi=None, dup=False):
    """Unit descriptors for B pairs: d2's valid rows are noisy copies of
    d1's in another order plus fresh ones (true matches and clutter); rows
    past each pair's ragged valid count are zero, as the matcher pads."""
    d1 = np.zeros((B, N1, 128), np.float32)
    d2 = np.zeros((B, N2, 128), np.float32)
    v1 = np.zeros((B, N1), np.float32)
    v2 = np.zeros((B, N2), np.float32)
    for b in range(B):
        n1 = N1 if n_lo is None else int(rng.integers(n_lo, min(n_hi, N1) + 1))
        n2 = N2 if n_lo is None else int(rng.integers(n_lo, min(n_hi, N2) + 1))
        base = rng.normal(size=(n1 + n2, 128)) ** 2
        a = base[:n1] + rng.normal(0, 0.02, (n1, 128))
        shared = min(n1, n2) * 3 // 4
        src = np.concatenate([base[rng.permutation(n1)[:shared]], base[n1 : n1 + n2 - shared]])
        c = src[rng.permutation(n2)] + rng.normal(0, 0.02, (n2, 128))
        if dup:  # exact duplicates at higher columns and rows: ties
            c[n2 // 2 : n2 // 2 + n2 // 4] = c[: n2 // 4]
            a[n1 // 2 : n1 // 2 + n1 // 8] = a[: n1 // 8]
        a = np.maximum(a, 0.0)
        c = np.maximum(c, 0.0)
        d1[b, :n1] = a / np.linalg.norm(a, axis=-1, keepdims=True)
        d2[b, :n2] = c / np.linalg.norm(c, axis=-1, keepdims=True)
        v1[b, :n1] = 1.0
        v2[b, :n2] = 1.0
    return d1, d2, v1, v2


def check_match_kernel(rng) -> dict:
    """Phase 4: K1 against its plain version at the matcher's shapes."""
    import torch

    from colmap_pcd_tpu_torch.ops import match_kernel, matching

    dev = torch.device("cuda")
    opts = matching.MatchingOptions()
    cases = [
        ("matcher chunk B=16 cap 2048", dict(B=16, N1=2048, N2=2048, n_lo=1500, n_hi=2048), 20, 3),
        ("smoke-world chunk B=16 cap 4096", dict(B=16, N1=4096, N2=4096, n_lo=1900, n_hi=2200), 10, 2),
        ("one pair 8192x8192", dict(B=1, N1=8192, N2=8192), 10, 3),
        ("ragged 1000x1537", dict(B=1, N1=1000, N2=1537), 50, 10),
        ("duplicates 1024x2048", dict(B=1, N1=1024, N2=2048, dup=True), 50, 10),
    ]
    record = {"max_abs_err": 0.0, "shapes": {}}
    for label, shape, reps, plain_reps in cases:
        d1, d2, v1, v2 = (torch.as_tensor(x, device=dev) for x in _k1_case(rng, **shape))
        s1, s2, idx = match_kernel.match_top2(d1, d2, v2)
        torch.cuda.synchronize()
        r1, r2, ridx = match_kernel.match_top2_reference(d1, d2, v2)
        err = max(float((s1 - r1).abs().max()), float((s2 - r2).abs().max()))
        sep = (r1 - r2) > SIM_ATOL
        idx_mism = int(((idx != ridx) & sep).sum())
        if err > SIM_ATOL or idx_mism:
            raise AssertionError(
                f"K1 disagrees with its plain version ({label}): max sim err {err:.3g}, "
                f"{idx_mism} index mismatches away from near-ties"
            )
        # the lowest of equal columns: no kernel pick has an equal,
        # lower-indexed twin
        if shape.get("dup"):
            ik = idx[0].long()
            twin = ik - (d2.shape[1] // 2)
            has_twin = (twin >= 0) & (twin < d2.shape[1] // 4)
            same = (d2[0, twin.clamp(min=0)] == d2[0, ik]).all(-1)
            if bool((has_twin & same).any()):
                raise AssertionError("K1 picked a duplicated column over its lower twin")
        # the full accept decision of match_descriptors (two launches)
        ik, ok_k, _ = matching.match_descriptors(d1, d2, v1, v2, opts)
        ir, ok_r, _ = matching.match_descriptors_reference(d1, d2, v1, v2, opts)
        dist1 = torch.arccos(r1.clamp(-1, 1))
        dist2 = torch.arccos(r2.clamp(-1, 1))
        bt1, bt2, _ = match_kernel.match_top2_reference(d2, d1, v1)
        col_tie = torch.gather(bt1 - bt2, -1, ir) <= SIM_ATOL
        exempt = (
            ((dist1 - opts.max_distance).abs() < SIM_ATOL)
            | ((dist1 - opts.max_ratio * dist2).abs() < SIM_ATOL)
            | ~sep | col_tie
        )
        ok_mism = int(((ok_k != ok_r) & ~exempt).sum())
        if ok_mism:
            raise AssertionError(f"K1's accept decisions differ in {ok_mism} rows ({label})")
        ms = _cuda_ms(lambda: match_kernel.match_top2(d1, d2, v2), reps)
        plain_ms = _cuda_ms(lambda: match_kernel.match_top2_reference(d1, d2, v2), plain_reps)
        B, N1, N2 = d1.shape[0], d1.shape[1], d2.shape[1]
        gflop = 2.0 * B * N1 * N2 * 128 / 1e9
        _log(
            f"[k1] {label}: kernel {ms:.4f} ms ({gflop / ms:.2f} TFLOP/s), plain {plain_ms:.4f} ms; "
            f"max abs sim err {err:.3g}, index mismatches away from near-ties {idx_mism}, "
            f"near-tie rows {int((~sep).sum())}, accepted {int(ok_k.sum())} vs plain "
            f"{int(ok_r.sum())}, accept mismatches outside 1e-6 of a threshold {ok_mism}"
        )
        record["max_abs_err"] = max(record["max_abs_err"], err)
        record["shapes"][label] = (ms, plain_ms)
    record["ms"], record["plain_ms"] = record["shapes"]["matcher chunk B=16 cap 2048"]
    return record


def _run_cli(argv: list, counters: dict) -> tuple[int, float, dict]:
    """cli.main(argv) with the given launch counters zeroed just before it
    and read just after; host-clock seconds end at a device sync."""
    import torch

    from colmap_pcd_tpu_torch import cli

    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return rc, seconds, {name: fn.launches for name, fn in counters.items()}


def run_main_path(args, tmp: str, rng) -> dict:
    """Phase 5: matcher then lidar mapper on the 100-image world."""
    import torch

    from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction
    from colmap_pcd_tpu_torch.ops import match_kernel, nn_kernel
    from colmap_pcd_tpu_torch.utils.logging_utils import PHASES
    from synthetic_torch import (
        ate_rmse, make_descriptor_world, mapper_argv, match_precision_recall, scale_error,
        write_world,
    )

    kernels = {"match_top2": match_kernel.match_top2, "nn_argmin": nn_kernel.nn_argmin}
    t0 = time.perf_counter()
    rec, graph, lmap, gt, desc, point_ids = make_descriptor_world(
        rng, n_images=args.n_images, n_points=110 * args.n_images, noise_px=0.4, step=0.8,
        distractor_share=0.05,
    )
    paths = write_world(rec, graph, lmap, gt, tmp, descriptors=desc)
    kps = [d.shape[0] for d in desc.values()]
    _log(f"[world] {args.n_images} images, {lmap.num_points} map points, "
         f"{np.mean(kps):.0f} keypoints/image ({min(kps)}-{max(kps)}), "
         f"{len(graph.image_pairs())} pairs share points, built and written in "
         f"{time.perf_counter() - t0:.2f} s")
    # the K2 check on this world's map, before any path runs
    k2 = check_kernel(lmap.points, np.random.default_rng(args.seed + 1))

    PHASES.totals.clear()
    PHASES.counts.clear()
    rc, m_seconds, m_launches = _run_cli(
        ["sequential_matcher", "--database_path", paths["database"],
         "--SequentialMatching.overlap", "5"], kernels,
    )
    if rc != 0:
        raise RuntimeError(f"sequential_matcher exited with {rc}")
    pr = match_precision_recall(paths["database"], point_ids)
    m_syncs = PHASES.counts.get("linalg_syncs", 0)

    PHASES.totals.clear()
    PHASES.counts.clear()
    torch.cuda.reset_peak_memory_stats()
    out_dir = os.path.join(tmp, "model")
    rc, seconds, launches = _run_cli(mapper_argv(paths, out_dir), kernels)
    if rc != 0:
        raise RuntimeError(f"mapper exited with {rc}")
    recs = [Reconstruction.read(os.path.join(out_dir, d)) for d in sorted(os.listdir(out_dir))]
    out = max(recs, key=lambda r: r.num_reg_images)
    solves = PHASES.counts.get("ba_solves", 0)
    return {
        "k2": k2,
        "matcher_seconds": m_seconds,
        "matcher_launches": m_launches,
        "matcher_linalg_syncs": m_syncs,
        "match": pr,
        "models": len(recs),
        "registered": out.num_reg_images,
        "ate_m": ate_rmse(out, gt),
        "scale_err": scale_error(out, gt),
        "seconds": seconds,
        "frames_per_s": out.num_reg_images / seconds,
        "mapper_launches": launches,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "ba_solves": solves,
        "lm_syncs_per_solve": PHASES.counts.get("ba_lm_syncs", 0) / max(solves, 1),
        "phases": PHASES.report(),
    }


def run_classic_path(args, tmp: str) -> dict:
    """Phase 6: matcher then classic (lidar-free) mapper on a small world,
    with test_e2e_classic_no_lidar's parameters."""
    import torch

    from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction
    from colmap_pcd_tpu_torch.ops import match_kernel, nn_kernel, np_geom, solvers
    from synthetic_torch import classic_mapper_argv, make_descriptor_world, write_world

    kernels = {"match_top2": match_kernel.match_top2, "nn_argmin": nn_kernel.nn_argmin}
    rec, graph, lmap, gt, desc, _ = make_descriptor_world(
        np.random.default_rng(args.seed + 11), n_images=args.classic_images,
        n_points=85 * args.classic_images, noise_px=0.2, step=1.0,
    )
    paths = write_world(rec, graph, lmap, gt, tmp, descriptors=desc)
    rc, m_seconds, m_launches = _run_cli(
        ["sequential_matcher", "--database_path", paths["database"],
         "--SequentialMatching.overlap", "5"], kernels,
    )
    if rc != 0:
        raise RuntimeError(f"sequential_matcher (classic world) exited with {rc}")
    out_dir = os.path.join(tmp, "classic_model")
    rc, seconds, launches = _run_cli(
        classic_mapper_argv(
            paths, out_dir, (1, 3), "--Mapper.init_min_tri_angle", "2",
            "--Mapper.init_min_num_inliers", "30", "--Mapper.abs_pose_min_num_inliers", "15",
            "--Mapper.multiple_models", "0",
        ),
        kernels,
    )
    if rc != 0:
        raise RuntimeError(f"classic mapper exited with {rc}")
    out = Reconstruction.read(os.path.join(out_dir, "0"))
    out.update_point_errors()
    errs = [p.error for p in out.points3D.values() if p.error >= 0]
    reg = sorted(out.registered_ids)
    est = np.stack([out.images[i].projection_center() for i in reg])
    ref = np.stack([np_geom.projection_center(*gt[i - 1]) for i in reg])
    q, t, s = solvers.umeyama(
        torch.as_tensor(est, dtype=torch.float32), torch.as_tensor(ref, dtype=torch.float32),
        with_scale=True,
    )
    R = np_geom.quat_to_rotmat(q.numpy().astype(np.float64))
    aligned = float(s) * est @ R.T + t.numpy()
    ate = float(np.sqrt(np.mean(np.sum((aligned - ref) ** 2, axis=-1))))
    return {
        "registered": out.num_reg_images,
        "median_reproj_px": float(np.median(errs)),
        "ate_sim3_m": ate,
        "matcher_seconds": m_seconds,
        "matcher_launches": m_launches,
        "mapper_seconds": seconds,
        "mapper_launches": launches,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-images", type=int, default=100)
    ap.add_argument("--classic-images", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from colmap_pcd_tpu_torch.ops import match_kernel, nn_kernel

    # 1. environment
    smi = _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    _log(f"[env] nvidia-smi: {smi}")
    _log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
         f"count {torch.cuda.device_count()}")

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        for fut in [pool.submit(nn_kernel.build), pool.submit(match_kernel.build)]:
            fut.result()
    _log(f"[build] nn_argmin.cu and match_top2.cu built and loaded in "
         f"{time.perf_counter() - t0:.2f} s")
    for stem in ("nn_argmin", "match_top2"):
        for line in _ptxas_lines(stem):
            _log(f"[build] {stem}: {line}")

    # 4. K1 against its plain version (3. runs on the world's map below)
    k1 = check_match_kernel(np.random.default_rng(args.seed + 2))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 3. + 5. the main path
        os.makedirs(os.path.join(tmp, "main"))
        res = run_main_path(args, os.path.join(tmp, "main"), np.random.default_rng(args.seed))
        pr = res["match"]
        _log(f"[matcher] {res['matcher_seconds']:.3f} s (cli.main sequential_matcher), "
             f"{pr['pairs_tried']} pairs tried, {pr['pairs_verified']} verified, "
             f"{pr['inlier_matches']} inlier matches, precision {pr['precision']:.6f}, "
             f"recall {pr['recall']:.6f}, K1 launches {res['matcher_launches']['match_top2']}, "
             f"{res['matcher_linalg_syncs']} linalg host syncs")
        _log(f"[mapper] registered {res['registered']}/{args.n_images} in {res['models']} model(s), "
             f"ATE {res['ate_m']:.6f} m, scale error {res['scale_err']:.6f}")
        _log(f"[mapper] {res['seconds']:.3f} s end to end (cli.main), "
             f"{res['frames_per_s']:.4f} frames registered/s")
        _log(f"[mapper] K2 launches {res['mapper_launches']['nn_argmin']}, peak device memory "
             f"{res['peak_mem_bytes'] / 2**20:.1f} MiB, {res['ba_solves']} BA solves, "
             f"{res['lm_syncs_per_solve']:.2f} LM host syncs per solve")
        _log("[mapper] phases:\n" + res["phases"])

        # 6. the classic path
        os.makedirs(os.path.join(tmp, "classic"))
        cl = run_classic_path(args, os.path.join(tmp, "classic"))
        _log(f"[classic] registered {cl['registered']}/{args.classic_images}, median reprojection "
             f"error {cl['median_reproj_px']:.4f} px, ATE after sim(3) alignment "
             f"{cl['ate_sim3_m']:.6f} m; matcher {cl['matcher_seconds']:.3f} s "
             f"(K1 launches {cl['matcher_launches']['match_top2']}), mapper "
             f"{cl['mapper_seconds']:.3f} s")

    # 7. checks
    if res["matcher_launches"]["match_top2"] <= 0:
        raise AssertionError("the matcher never launched K1")
    if res["mapper_launches"]["nn_argmin"] <= 0:
        raise AssertionError("the mapper never launched K2")
    if not pr["precision"] >= 0.95:
        raise AssertionError(f"match precision {pr['precision']} < 0.95")
    if res["registered"] < 0.95 * args.n_images:
        raise AssertionError(f"registered {res['registered']} < 95% of {args.n_images}")
    if not res["ate_m"] < 0.10:
        raise AssertionError(f"ATE {res['ate_m']} m >= 0.10 m")
    if not res["scale_err"] < 0.02:
        raise AssertionError(f"scale error {res['scale_err']} >= 2%")
    if cl["registered"] < args.classic_images - 1:
        raise AssertionError(f"classic: registered {cl['registered']} < {args.classic_images - 1}")
    if not cl["median_reproj_px"] < 1.0:
        raise AssertionError(f"classic: median reprojection error {cl['median_reproj_px']} >= 1 px")

    k2 = res["k2"]
    print(json.dumps({"kernels": [
        {
            "name": "nn_argmin",
            "route": "cuda",
            "source": "colmap_pcd_tpu_torch/csrc/nn_argmin.cu",
            "replaces": "colmap_pcd_tpu/ops/pallas_kernels.py:191",
            "launches": res["mapper_launches"]["nn_argmin"],
            "max_abs_err": k2["max_abs_err"],
            "ms": k2["ms"],
            "plain_ms": k2["plain_ms"],
        },
        {
            "name": "match_top2",
            "route": "cuda",
            "source": "colmap_pcd_tpu_torch/csrc/match_top2.cu",
            "replaces": "colmap_pcd_tpu/ops/pallas_kernels.py:94",
            "launches": res["matcher_launches"]["match_top2"],
            "max_abs_err": k1["max_abs_err"],
            "ms": k1["ms"],
            "plain_ms": k1["plain_ms"],
        },
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
