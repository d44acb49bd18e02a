#!/usr/bin/env python3
"""Smoke run of the PyTorch port (colmap_pcd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--n-images 100] [--descriptor-images 100]
                          [--overlap-images 30] [--classic-images 20] [--seed 0]

Phases, each printing its numbers on its own line:
  1. environment: the card's name and power limit (nvidia-smi), torch/CUDA;
  2. build: the hand-written CUDA kernels K2 (nn_argmin), K1 for float
     descriptors (match_top2) and K1 for uint8 descriptors on the integer
     tensor cores (match_top2_u8) from the sources in
     colmap_pcd_tpu_torch/csrc, one nvcc each, started together, with their
     build seconds and ptxas reports; meanwhile the pixel world's images are
     rendered on the host (100 views of the corridor at 640x480, f = 500,
     0.8 m step, and 4 at 1280x960);
  3. K2 against its plain PyTorch version and the host kd-tree at the
     mapper's shapes (Q in {37, 4096} queries against the pixel world's
     ~0.5 M-point map and a ragged map). Times: CUDA events around repeated
     calls; the kernel's device time alone from a CUDA graph of the repeated launch
     (at Q = 37 the call's time is the host's); the plain version; one
     library call (`torch.cdist` + `argmin`, blocked); the C++ kd-tree's
     median host-clock time; and the bound computed from the shape;
  4. both K1 kernels against their plain versions: the pixel world's chunk
     (B = 16 pairs at cap 1024, ragged 430-540 valid rows), a matcher chunk
     at the feature limit (B = 16 at cap 2048, ragged 1 500-2 048), the
     descriptor world's chunk (B = 16 at cap 4096, ragged 1 900-2 200), one
     pair at 8192 x 8192, a ragged 1000 x 1537 pair
     and a pair with duplicated descriptors. The uint8 cases are the float
     ones quantized as the world generator quantizes descriptors; the uint8
     kernel must agree with its plain version exactly (similarity error 0,
     no index or accept mismatch), and its launch on the transpose must form
     bit-identical similarities. Times as in 3., the float and the uint8
     kernel in turns (float, uint8, uint8, float); the library call is one
     bf16 `torch.matmul` of the chunk (the product alone);
  5. SIFT on the card: one batch of 8 rendered 640x480 images extracted on
     CUDA and on the CPU (keypoint sets and descriptors must agree within
     the tolerances of tests/test_torch_sift.py), the CUDA batch extracted
     twice (identical bytes), TF32 off (asserted); ms per batch, kernels
     launched per batch, peak memory; one batch of 4 images at 1280x960
     with 8192 features and 4 octaves for its time and peak memory;
  6. the pixel world, the main path from pixels: the 100 rendered images
     through `cli.main feature_extractor` (PINHOLE with the known
     intrinsics), the sequential matcher at overlap 5 without the quadratic
     offsets (match_top2_u8) and `cli.main mapper` on the lidar map (K2)
     with the pose prior of image 1, each with the launch counts zeroed just
     before it; the model is read back and its ATE printed;
  7. the overlapped front end: the first 30 of those images through
     `run_overlapped_frontend` (extraction and matching threads) feeding
     `IncrementalMapperController(pair_feed=...)` on the caller's thread;
  8. the descriptor world: a synthetic corridor world (100 images, 0.8 m
     step, ~2 000 keypoints per image plus 5% distractors, each with a
     SIFT-like uint8 descriptor) written to a COLMAP database with no
     matches; `cli.main sequential_matcher --SequentialMatching.overlap 5`
     and the lidar `mapper`; the written inlier matches are scored against
     the generator's correspondences;
  9. the classic path: a 20-image world (step 1.0, 0.2 px noise), the
     sequential matcher, then `mapper` without a lidar map, initialized on
     (1, 3); registered images, median reprojection error and the ATE after
     a sim(3) alignment. Then the float route: `sequential_matcher
     --SiftMatching.guided_matching 1` on a copy of that database, which
     matches pair by pair through match_top2;
 10. checks: match_top2_u8 launched by every matcher run, match_top2 by the
     guided matcher and K2 by every lidar mapper run; the pixel world holds
     100 images of 300-2 048 keypoints and its model >= 95% registered
     with ATE < 0.10 m and scale error < 2%, and so do the overlapped run
     (with no error in its feed) and the descriptor world (match precision
     >= 0.95); classic mapper >= 19/20 registered with median reprojection
     error < 1.0 px.

`--kernels-only` stops after phase 4 (on a corridor map built like the
pixel world's) and prints no result line: a short first look at a changed
kernel.

Any failure raises (non-zero exit, no result line). The last lines are the
kernels' JSON record, the nvidia-smi line, and
{"ok": true, "device": {...}}. Without CUDA it exits non-zero at once.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
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

# SIFT on CUDA against SIFT on the CPU, as tests/test_torch_sift.py holds the
# port to the JAX package: of each side's valid keypoints, SIFT_PARTNER_SHARE
# have a partner within SIFT_PARTNER_PX pixels and SIFT_PARTNER_SCALE relative
# scale; of the partners, SIFT_GOOD_SHARE have the same orientation (within
# SIFT_ORI_ATOL rad; the rest are near-tied histogram peaks) and a descriptor
# cosine >= SIFT_COS
SIFT_PARTNER_PX, SIFT_PARTNER_SCALE, SIFT_PARTNER_SHARE = 0.01, 1e-3, 0.98
SIFT_ORI_ATOL, SIFT_COS, SIFT_GOOD_SHARE = 1e-4, 0.995, 0.99

# the pixel world (the JAX package's bench at its light scale) and the
# accuracy that package recorded on it (BENCH_r05.json)
PIXEL_W, PIXEL_H, PIXEL_F, PIXEL_STEP = 640, 480, 500.0, 0.8
PIXEL_FEATURES, PIXEL_OCTAVES = 2048, 3
REF_W, REF_H, REF_F, REF_FEATURES, REF_OCTAVES = 1280, 960, 1000.0, 8192, 4
REFERENCE_ATE_MM = 18.0
# the lidar mapper's options on SIFT features, as that bench sets them
PIXEL_MAPPER_FLAGS = (
    "--Mapper.init_min_num_inliers", "40", "--Mapper.abs_pose_min_num_inliers", "12",
    "--Mapper.abs_pose_min_inlier_ratio", "0.15", "--Mapper.filter_max_reproj_error", "6.0",
)

# published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# device memory bytes/s, f32 FLOP/s outside the tensor cores, int8 tensor
# core OP/s. A bound is the larger of bytes / HBM and operations / peak.
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
INT8_OPS = 1979e12


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


def _graph_ms(fn, reps: int) -> float:
    """Device time of one fn(): `reps` calls captured into one CUDA graph,
    which then replays without the host between the launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _turns_ms(first, second, reps: int) -> tuple[float, float, list]:
    """CUDA-event times of two kernels in turns (first, second, second,
    first): (mean first, mean second, the four times in order)."""
    times = [_cuda_ms(fn, reps) for fn in (first, second, second, first)]
    return (times[0] + times[3]) / 2, (times[1] + times[2]) / 2, times


def _bound(bytes_moved: float, operations: float, peak: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take."""
    by_bytes, by_ops = bytes_moved / HBM_BYTES_S * 1e3, operations / peak * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _ptxas_lines(stem: str):
    from colmap_pcd_tpu_torch.ops.cuda_build import BUILD_DIR

    for log in sorted(os.listdir(BUILD_DIR)):
        if log.startswith(stem + "-") and log.endswith(".log"):
            with open(os.path.join(BUILD_DIR, log)) as f:
                for line in f:
                    if any(w in line for w in ("registers", "spill", "smem", "nvcc:", "(C7")):
                        yield line.strip()


def _cdist_argmin(q, pts):
    """The library yardstick for K2: `torch.cdist` + `argmin`, over blocks
    of 1024 queries so that a block's distance matrix stays near 2 GB."""
    import torch

    return torch.cat([torch.cdist(q[i : i + 1024], pts).argmin(dim=1) for i in range(0, q.shape[0], 1024)])


def check_kernel(map_pts: np.ndarray, rng) -> dict:
    """Phase 3: K2 against its plain version at the mapper's shapes."""
    import torch

    from colmap_pcd_tpu_torch.ops import nn_kernel
    from colmap_pcd_tpu_torch.utils.native import NativeKdTree, get_lib

    dev = torch.device("cuda")
    if get_lib() is None:
        raise RuntimeError("the native host runtime (cpp/native.cpp) did not build")
    ragged = 100_003
    record = {"max_abs_err": 0.0, "shapes": {}}
    for n_map in (map_pts.shape[0], ragged):
        pts = map_pts[:n_map].copy()
        if n_map == ragged:  # duplicated points far apart in the map: ties
            pts[50_000:50_008] = pts[1000:1008]
        pts_d = torch.as_tensor(pts, device=dev)
        pts4_d = nn_kernel.pack_points(pts_d)
        tree = NativeKdTree(pts)
        for Q in (37, 4096):
            q = (pts[rng.integers(0, n_map, Q)] + rng.normal(0, 0.2, (Q, 3))).astype(np.float32)
            if n_map == ragged:  # exact hits on the duplicated points
                q[:8] = pts[1000:1008]
            q_d = torch.as_tensor(q, device=dev)
            idx, dist = nn_kernel.nn_argmin(q_d, pts4_d)
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
            if n_map == ragged and not (np.array_equal(idx[:8], ref_idx[:8]) and idx[:8].max() < 50_000):
                raise AssertionError(f"K2 did not take the lowest of equally near points: {idx[:8]}")
            ms = _cuda_ms(lambda: nn_kernel.nn_argmin(q_d, pts4_d), 20)
            device_ms = _graph_ms(lambda: nn_kernel.nn_argmin(q_d, pts4_d), 20)
            plain_ms = _cuda_ms(lambda: nn_kernel.nn_argmin_reference(q_d, pts_d), 3)
            library_ms = _cuda_ms(lambda: _cdist_argmin(q_d, pts_d), 3)
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
            # each input read once (queries and map as [n,3] f32), each
            # output written once; 8 flops per (query, point) pair
            bound_ms, bound_by = _bound(12 * Q + 12 * n_map + 8 * Q, 8.0 * Q * n_map, F32_FLOPS)
            _log(
                f"[k2] Q={Q} N={n_map}: kernel {ms:.4f} ms per call, {device_ms:.4f} ms on the "
                f"device (CUDA graph); bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / device_ms:.1f}% reached; "
                f"plain {plain_ms:.4f} ms, cdist+argmin {library_ms:.4f} ms, "
                f"host kd-tree {host_ms:.4f} ms (host clock, median of 20); "
                f"max abs dist err {err:.3g} m, "
                f"max rel {rel:.3g}, index mismatches at equal distance {mism.size}"
            )
            record["max_abs_err"] = max(record["max_abs_err"], err)
            shape = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
                         host_kdtree_ms=host_ms, bound_ms=bound_ms, bound_by=bound_by)
            record["shapes"][f"Q={Q} N={n_map}"] = shape
            if Q == 4096 and n_map == map_pts.shape[0]:
                record.update(shape)
    # where the two scans cross: device time of each at the full map
    pts4_d = nn_kernel.pack_points(torch.as_tensor(map_pts, device=dev))
    lib, sms = nn_kernel.build(), torch.cuda.get_device_properties(dev).multi_processor_count
    for Q in (128, 256, 512, 1024, 2048):
        q_d = torch.as_tensor(
            map_pts[rng.integers(0, map_pts.shape[0], Q)] + np.float32(0.1), device=dev
        )
        # the few-queries scan forced, then the many-queries scan forced
        by_mode = [
            _graph_ms(lambda: nn_kernel.launch(lib, q_d, pts4_d, nn_kernel.launch_plan(
                Q, map_pts.shape[0], sms, lib.tiles, few_max=few_max)), 10)
            for few_max in (1 << 30, 0)
        ]
        _log(f"[k2] scan choice at Q={Q} N={map_pts.shape[0]}: points split among threads "
             f"{by_mode[0]:.4f} ms, queries in registers {by_mode[1]:.4f} ms on the device "
             f"(the wrapper switches above Q={nn_kernel.FEW_QUERIES_MAX})")
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


def _quantize(d: np.ndarray) -> np.ndarray:
    """Unit descriptors to uint8 as the world generator and the JAX
    package's `sift.descriptors_to_uint8` do: x 512, rounded, clipped."""
    return np.clip(np.round(d * 512.0), 0, 255).astype(np.uint8)


def _check_k1_f32(label, shape, d1, d2, v1, v2, opts):
    """The float kernel against its plain version (as since it landed)."""
    import torch

    from colmap_pcd_tpu_torch.ops import match_kernel, matching

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
    _log(
        f"[k1] {label}: max abs sim err {err:.3g}, index mismatches away from near-ties "
        f"{idx_mism}, near-tie rows {int((~sep).sum())}, accepted {int(ok_k.sum())} vs plain "
        f"{int(ok_r.sum())}, accept mismatches outside 1e-6 of a threshold {ok_mism}"
    )
    return err


def _check_k1_u8(label, shape, u1, u2, inv1, inv2, v1, v2, opts):
    """The uint8 kernel against its plain version: exactly equal."""
    import torch

    from colmap_pcd_tpu_torch.ops import match_kernel, matching

    s1, s2, idx = match_kernel.match_top2_u8(u1, u2, inv1, inv2, v2, v1)
    torch.cuda.synchronize()
    r1, r2, ridx = match_kernel.match_top2_u8_reference(u1, u2, inv1, inv2, v2, v1)
    err = max(float((s1 - r1).abs().max()), float((s2 - r2).abs().max()))
    idx_mism = int((idx != ridx).sum())
    if err != 0.0 or idx_mism:
        raise AssertionError(
            f"the uint8 K1 disagrees with its plain version ({label}): max sim err {err:.3g}, "
            f"{idx_mism} index mismatches"
        )
    # without the row mask every row is computed: the same answers
    f1, f2, fidx = match_kernel.match_top2_u8(u1, u2, inv1, inv2, v2)
    rows = v1 > 0
    if not (torch.equal(f1[rows], s1[rows]) and torch.equal(f2[rows], s2[rows])
            and torch.equal(fidx[rows], idx[rows])):
        raise AssertionError(f"the uint8 K1 changes its valid rows with the row mask ({label})")
    # the launch on the transpose forms bit-identical similarities: where row
    # i and column j pick each other, both launches report the same float
    t1, _, tidx = match_kernel.match_top2_u8(u2, u1, inv2, inv1, v1, v2)
    j = idx.long()
    mutual = rows & (torch.gather(v2, -1, j) > 0) & (
        torch.gather(tidx.long(), -1, j) == torch.arange(idx.shape[-1], device=idx.device)
    )
    if not torch.equal(torch.gather(t1, -1, j)[mutual], s1[mutual]) or int(mutual.sum()) == 0:
        raise AssertionError(f"the uint8 K1's transposed launch forms other similarities ({label})")
    if shape.get("dup"):
        ik = idx[0].long()
        twin = ik - (u2.shape[1] // 2)
        has_twin = (twin >= 0) & (twin < u2.shape[1] // 4)
        same = (u2[0, twin.clamp(min=0)] == u2[0, ik]).all(-1)
        if bool((has_twin & same).any()) or not bool((s1[0] == s2[0]).any()):
            raise AssertionError("the uint8 K1 picked a duplicated column over its lower twin")
    ik, ok_k, sk = matching.match_descriptors_u8(u1, u2, inv1, inv2, v1, v2, opts)
    ir, ok_r, sr = matching.match_descriptors_u8_reference(u1, u2, inv1, inv2, v1, v2, opts)
    ok_mism = int((ok_k != ok_r).sum()) + int((ik != ir).sum()) + int((sk != sr).sum())
    if ok_mism:
        raise AssertionError(f"the uint8 K1's match decisions differ in {ok_mism} places ({label})")
    _log(
        f"[k1-u8] {label}: max abs sim err {err:.3g}, index mismatches {idx_mism}, mutual picks "
        f"with bit-identical similarities {int(mutual.sum())}, accepted {int(ok_k.sum())} vs "
        f"plain {int(ok_r.sum())}, decision mismatches {ok_mism}"
    )
    return err


def check_match_kernel(rng) -> dict:
    """Phase 4: both K1 kernels against their plain versions at the
    matcher's shapes, timed in turns."""
    import torch

    from colmap_pcd_tpu_torch.ops import match_kernel, matching

    dev = torch.device("cuda")
    opts = matching.MatchingOptions()
    cases = [
        ("pixel-world chunk B=16 cap 1024", dict(B=16, N1=1024, N2=1024, n_lo=430, n_hi=540), 20, 3),
        ("matcher chunk B=16 cap 2048", dict(B=16, N1=2048, N2=2048, n_lo=1500, n_hi=2048), 20, 3),
        ("descriptor-world chunk B=16 cap 4096", dict(B=16, N1=4096, N2=4096, n_lo=1900, n_hi=2200), 10, 2),
        ("one pair 8192x8192", dict(B=1, N1=8192, N2=8192), 10, 3),
        ("ragged 1000x1537", dict(B=1, N1=1000, N2=1537), 50, 10),
        ("duplicates 1024x2048", dict(B=1, N1=1024, N2=2048, dup=True), 50, 10),
    ]
    f32 = {"max_abs_err": 0.0, "shapes": {}}
    u8 = {"max_abs_err": 0.0, "shapes": {}}
    for label, shape, reps, plain_reps in cases:
        case = _k1_case(rng, **shape)
        d1, d2, v1, v2 = (torch.as_tensor(x, device=dev) for x in case)
        u1, u2 = (torch.as_tensor(_quantize(x), device=dev) for x in case[:2])
        inv1, inv2 = match_kernel.inverse_norms(u1), match_kernel.inverse_norms(u2)
        f32["max_abs_err"] = max(f32["max_abs_err"], _check_k1_f32(label, shape, d1, d2, v1, v2, opts))
        u8["max_abs_err"] = max(
            u8["max_abs_err"], _check_k1_u8(label, shape, u1, u2, inv1, inv2, v1, v2, opts)
        )

        def run_f32():
            return match_kernel.match_top2(d1, d2, v2)

        def run_u8():
            return match_kernel.match_top2_u8(u1, u2, inv1, inv2, v2, v1)

        f32_ms, u8_ms, turns = _turns_ms(run_f32, run_u8, reps)
        f32_dev, u8_dev = _graph_ms(run_f32, reps), _graph_ms(run_u8, reps)
        f32_plain = _cuda_ms(lambda: match_kernel.match_top2_reference(d1, d2, v2), plain_reps)
        u8_plain = _cuda_ms(
            lambda: match_kernel.match_top2_u8_reference(u1, u2, inv1, inv2, v2, v1), plain_reps
        )
        b1, b2 = d1.to(torch.bfloat16), d2.to(torch.bfloat16)
        library_ms = _cuda_ms(lambda: torch.matmul(b1, b2.mT), reps)
        del b1, b2
        B, N1, N2 = d1.shape[0], d1.shape[1], d2.shape[1]
        n1, n2 = v1.sum(-1).double(), v2.sum(-1).double()
        # match_top2(d1, d2, valid2) has no row mask: every row against the
        # valid columns, 2 flops per product term; d1, the valid rows of d2
        # and valid2 read once, 3 outputs written
        f32_bound = _bound(4.0 * 128 * (B * N1 + float(n2.sum())) + 4 * B * N2 + 12 * B * N1,
                           2.0 * 128 * N1 * float(n2.sum()), F32_FLOPS)
        # with valid1 the uint8 kernel owes only the valid rows as well
        u8_bound = _bound(float((n1 + n2).sum()) * (128 + 4) + 4.0 * B * (N1 + N2) + 12 * B * N1,
                          2.0 * 128 * float((n1 * n2).sum()), INT8_OPS)
        tops = 2.0 * 128 * float((n1 * n2).sum()) / (u8_dev * 1e-3) / 1e12
        _log(
            f"[k1] {label}: float kernel {f32_ms:.4f} ms per call, {f32_dev:.4f} ms on the device "
            f"(CUDA graph), bound {f32_bound[0]:.4f} ms ({f32_bound[1]}), plain {f32_plain:.4f} ms; "
            f"uint8 kernel {u8_ms:.4f} ms per call, {u8_dev:.4f} ms on the device, bound "
            f"{u8_bound[0]:.4f} ms ({u8_bound[1]}), {100 * u8_bound[0] / u8_dev:.1f}% reached, "
            f"{tops:.1f} TOP/s on the valid rows and columns, plain {u8_plain:.4f} ms; turns "
            f"float/uint8/uint8/float {' '.join(f'{t:.4f}' for t in turns)}; one bf16 matmul of "
            f"the chunk {library_ms:.4f} ms"
        )
        f32["shapes"][label] = dict(ms=f32_ms, device_ms=f32_dev, plain_ms=f32_plain,
                                    library_ms=library_ms, bound_ms=f32_bound[0], bound_by=f32_bound[1])
        u8["shapes"][label] = dict(ms=u8_ms, device_ms=u8_dev, plain_ms=u8_plain, library_ms=library_ms,
                                   bound_ms=u8_bound[0], bound_by=u8_bound[1], float_kernel_ms=f32_ms)
    f32.update(f32["shapes"]["matcher chunk B=16 cap 2048"])
    u8.update(u8["shapes"]["pixel-world chunk B=16 cap 1024"])  # the main path's shape
    return {"match_top2": f32, "match_top2_u8": u8}


def _counted(fn, counters: dict):
    """fn() with the given launch counters zeroed just before it and read
    just after; host-clock seconds end at a device sync. Returns (fn's
    value, seconds, launches)."""
    import torch

    for wrapper in counters.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, seconds, {name: wrapper.launches for name, wrapper in counters.items()}


def _run_cli(argv: list, counters: dict) -> tuple[int, float, dict]:
    """cli.main(argv) under `_counted`."""
    from colmap_pcd_tpu_torch import cli

    return _counted(lambda: cli.main(argv), counters)


def _kernel_counters() -> dict:
    from colmap_pcd_tpu_torch.ops import match_kernel, nn_kernel

    return {"match_top2": match_kernel.match_top2, "match_top2_u8": match_kernel.match_top2_u8,
            "nn_argmin": nn_kernel.nn_argmin}


def _reset_phases():
    from colmap_pcd_tpu_torch.utils.logging_utils import PHASES

    PHASES.totals.clear()
    PHASES.counts.clear()


def _read_model(out_dir: str, gt) -> dict:
    """The largest model under out_dir against the ground truth."""
    from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction
    from synthetic_torch import ate_rmse, scale_error

    recs = [Reconstruction.read(os.path.join(out_dir, d)) for d in sorted(os.listdir(out_dir))]
    out = max(recs, key=lambda r: r.num_reg_images)
    return {"models": len(recs), "registered": out.num_reg_images, "ate_m": ate_rmse(out, gt),
            "scale_err": scale_error(out, gt)}


def _mapper_numbers(seconds: float, registered: int) -> dict:
    """What the mapper's PHASES counters and the allocator say of a run."""
    import torch

    from colmap_pcd_tpu_torch.utils.logging_utils import PHASES

    solves = PHASES.counts.get("ba_solves", 0)
    return {
        "seconds": seconds,
        "frames_per_s": registered / seconds,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "ba_solves": solves,
        "lm_syncs_per_solve": PHASES.counts.get("ba_lm_syncs", 0) / max(solves, 1),
        "phases": PHASES.report(),
    }


def render_pixel_world(args, tmp: str) -> dict:
    """The pixel world's files: ground truth, the rendered views (threaded
    over images), four views at the reference scale, the lidar PLY and the
    pose prior of image 1."""
    from synthetic_torch import build_corridor_map, make_trajectory, render_images, write_lidar_files

    t0 = time.perf_counter()
    gt = make_trajectory(args.n_images, PIXEL_STEP)
    img_dir, ref_dir = os.path.join(tmp, "images"), os.path.join(tmp, "images_ref")
    os.makedirs(img_dir)
    os.makedirs(ref_dir)
    render_images(img_dir, gt, PIXEL_W, PIXEL_H, PIXEL_F, workers=6)
    render_images(ref_dir, gt[:4], REF_W, REF_H, REF_F, workers=4)
    pts, nrm = build_corridor_map(np.random.default_rng(0), length=args.n_images * PIXEL_STEP + 25)
    paths = write_lidar_files(pts, nrm, gt, tmp)
    paths.update(images=img_dir, images_ref=ref_dir, database=os.path.join(tmp, "pixels.db"))
    return {"gt": gt, "paths": paths, "map_points": pts, "map_normals": nrm,
            "seconds": time.perf_counter() - t0}


def _read_stack(img_dir: str, n: int) -> np.ndarray:
    from colmap_pcd_tpu_torch.utils.image import imread_gray_u8

    return np.stack([imread_gray_u8(os.path.join(img_dir, f)) for f in sorted(os.listdir(img_dir))[:n]])


def _sift_agreement(a, b) -> dict:
    """Keypoint sets and descriptors of two extractions of one image,
    (kp, desc, score, valid) numpy each, by the SIFT_* tolerances."""
    from scipy.spatial import cKDTree

    kp_a, d_a = a[0][a[3]], a[1][a[3]]
    kp_b, d_b = b[0][b[3]], b[1][b[3]]

    def partners(p, q):
        d, j = cKDTree(q[:, :2]).query(p[:, :2])
        return j, (d <= SIFT_PARTNER_PX) & (np.abs(q[j, 2] / p[:, 2] - 1.0) <= SIFT_PARTNER_SCALE)

    j, ok = partners(kp_a, kp_b)
    back = partners(kp_b, kp_a)[1]
    x, y = d_a[ok], d_b[j[ok]]
    cos = (x * y).sum(-1) / (np.linalg.norm(x, axis=-1) * np.linalg.norm(y, axis=-1))
    same_ori = np.abs(np.angle(np.exp(1j * (kp_a[ok, 3] - kp_b[j[ok], 3])))) <= SIFT_ORI_ATOL
    u8_a = np.clip(np.round(x * 512.0), 0, 255)
    u8_b = np.clip(np.round(y * 512.0), 0, 255)
    return {
        "valid": (len(kp_a), len(kp_b)),
        "partner_share": float(min(ok.mean(), back.mean())),
        "good_share": float((same_ori & (cos >= SIFT_COS)).mean()),
        "max_px": float(np.linalg.norm(kp_a[ok, :2] - kp_b[j[ok], :2], axis=-1).max()),
        "u8_within_1": float((np.abs(u8_a - u8_b)[same_ori] <= 1).mean()),
    }


def _count_kernels(fn) -> int | None:
    """Device kernels launched by one fn(), from `torch.profiler`; None
    where the profiler sees no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return int(n) if n else None


def check_sift(paths: dict) -> dict:
    """Phase 5: SIFT on the card against SIFT on the CPU."""
    import torch

    from colmap_pcd_tpu_torch.ops import sift

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("the numerics policy is not in force: TF32 is allowed")
    dev = torch.device("cuda")
    opts = sift.SiftOptions(max_num_features=PIXEL_FEATURES, first_octave=0, num_octaves=PIXEL_OCTAVES)
    imgs = torch.as_tensor(_read_stack(paths["images"], 8))
    imgs_d = imgs.to(dev)

    def on_card():
        return sift.extract_batch(imgs_d, opts)

    first = on_card()
    again = on_card()
    torch.cuda.synchronize()
    # what a database gets must not change from run to run: the valid mask,
    # and every valid row's keypoint, float descriptor, uint8 code and score
    v = first[3]
    if not torch.equal(v, again[3]) or int(v.sum()) == 0:
        raise AssertionError("two extractions of one batch on the card differ in their valid rows")
    for name, x, y in zip(("keypoints", "descriptors", "scores"), first, again):
        if not torch.equal(x[v], y[v]):
            raise AssertionError(f"two extractions of one batch on the card differ in their {name}")
    if not torch.equal(sift.descriptors_to_uint8(first[1])[v], sift.descriptors_to_uint8(again[1])[v]):
        raise AssertionError("two extractions of one batch on the card differ in their uint8 codes")

    t0 = time.perf_counter()
    cpu = [a.numpy() for a in sift.extract_batch(imgs, opts)]
    cpu_s = time.perf_counter() - t0
    card = [a.cpu().numpy() for a in first]
    worst = None
    for b in range(imgs.shape[0]):
        agree = _sift_agreement([a[b] for a in card], [a[b] for a in cpu])
        if agree["partner_share"] < SIFT_PARTNER_SHARE or agree["good_share"] < SIFT_GOOD_SHARE:
            raise AssertionError(f"SIFT on the card and on the CPU disagree on image {b}: {agree}")
        if worst is None or agree["good_share"] < worst["good_share"]:
            worst = agree
    n_valid = [int(n) for n in v.sum(-1).tolist()]

    torch.cuda.reset_peak_memory_stats()
    ms = _cuda_ms(on_card, 3)
    peak = torch.cuda.max_memory_allocated()
    kernels = _count_kernels(on_card)

    # the reference scale: 4 images at 1280x960, 8192 features, 4 octaves
    ref_opts = sift.SiftOptions(max_num_features=REF_FEATURES, first_octave=0, num_octaves=REF_OCTAVES)
    ref_d = torch.as_tensor(_read_stack(paths["images_ref"], 4), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref_out = sift.extract_batch(ref_d, ref_opts)
    end.record()
    torch.cuda.synchronize()
    ref_valid = [int(n) for n in ref_out[3].sum(-1).tolist()]
    if min(ref_valid) < 500 or not bool(torch.isfinite(ref_out[1][ref_out[3]]).all()):
        raise AssertionError(f"the reference-scale batch extracted {ref_valid} keypoints")
    return {
        "valid": n_valid, "worst": worst, "cpu_seconds": cpu_s, "ms_per_batch": ms,
        "kernels_per_batch": kernels, "peak_mem_bytes": peak,
        "ref_valid": ref_valid, "ref_ms": start.elapsed_time(end),
        "ref_peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }


def _extraction_config():
    from colmap_pcd_tpu_torch.utils.config import SiftExtractionConfig

    return SiftExtractionConfig(max_num_features=PIXEL_FEATURES, first_octave=0,
                                num_octaves=PIXEL_OCTAVES, max_image_size=PIXEL_W)


def run_pixel_world(world: dict, tmp: str) -> dict:
    """Phase 6: pixels -> SIFT -> matcher (K1) -> lidar mapper (K2)."""
    import torch

    from colmap_pcd_tpu_torch.models.database import Database
    from colmap_pcd_tpu_torch.models.feature_pipeline import run_sequential_matcher
    from colmap_pcd_tpu_torch.utils.config import SiftMatchingConfig
    from synthetic_torch import mapper_argv

    kernels = _kernel_counters()
    paths = world["paths"]
    cfg = _extraction_config()
    rc, e_seconds, _ = _run_cli([
        "feature_extractor", "--database_path", paths["database"], "--image_path", paths["images"],
        "--ImageReader.camera_model", "PINHOLE",
        "--ImageReader.camera_params", f"{PIXEL_F},{PIXEL_F},{PIXEL_W / 2},{PIXEL_H / 2}",
        "--SiftExtraction.max_num_features", str(cfg.max_num_features),
        "--SiftExtraction.first_octave", str(cfg.first_octave),
        "--SiftExtraction.num_octaves", str(cfg.num_octaves),
        "--SiftExtraction.max_image_size", str(cfg.max_image_size),
    ], kernels)
    if rc != 0:
        raise RuntimeError(f"feature_extractor exited with {rc}")
    db = Database(paths["database"])
    keypoints = [db.read_keypoints(i).shape[0] for i in sorted(db.images())]
    cameras = db.cameras()
    db.close()

    # overlap 5 without the quadratic offsets, which the CLI's command always
    # adds: the matcher's own entry point takes the switch
    _reset_phases()
    n_verified, m_seconds, m_launches = _counted(
        lambda: run_sequential_matcher(paths["database"], SiftMatchingConfig(min_num_inliers=15),
                                       overlap=5, quadratic_overlap=False), kernels)
    db = Database(paths["database"])
    n_tried = len(db.all_two_view_pair_ids())
    db.close()

    _reset_phases()
    torch.cuda.reset_peak_memory_stats()
    out_dir = os.path.join(tmp, "pixel_model")
    rc, seconds, launches = _run_cli(mapper_argv(paths, out_dir, *PIXEL_MAPPER_FLAGS), kernels)
    if rc != 0:
        raise RuntimeError(f"mapper (pixel world) exited with {rc}")
    res = _read_model(out_dir, world["gt"])
    res.update(_mapper_numbers(seconds, res["registered"]))
    res.update(keypoints=keypoints, cameras=cameras, extract_seconds=e_seconds,
               matcher_seconds=m_seconds, matcher_launches=m_launches, pairs_verified=n_verified,
               pairs_tried=n_tried, mapper_launches=launches)
    return res


def run_overlapped(args, world: dict, tmp: str) -> dict:
    """Phase 7: extraction and matching threads feeding the mapper on the
    caller's thread, on the first images of the pixel world."""
    import torch

    from colmap_pcd_tpu_torch.models.controllers import ControllerOptions, IncrementalMapperController
    from colmap_pcd_tpu_torch.models.correspondence_graph import CorrespondenceGraph
    from colmap_pcd_tpu_torch.models.feature_pipeline import ImageReaderConfig
    from colmap_pcd_tpu_torch.models.incremental_mapper import MapperOptions
    from colmap_pcd_tpu_torch.models.lidar_map import LidarMap
    from colmap_pcd_tpu_torch.models.overlap import run_overlapped_frontend
    from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction
    from colmap_pcd_tpu_torch.utils.config import SiftMatchingConfig
    from synthetic_torch import ate_rmse, scale_error

    n = args.overlap_images
    gt = world["gt"][:n]
    img_dir = os.path.join(tmp, "overlap_images")
    os.makedirs(img_dir)
    for name in sorted(os.listdir(world["paths"]["images"]))[:n]:
        shutil.copy(os.path.join(world["paths"]["images"], name), img_dir)
    lmap = LidarMap.from_arrays(world["map_points"], world["map_normals"], device="cuda")
    opts = MapperOptions(
        if_add_lidar_constraint=True, init_image_id1=1, init_image_id2=2, init_min_num_inliers=40,
        abs_pose_min_num_inliers=12, abs_pose_min_inlier_ratio=0.15, num_ransac_hypotheses=2048,
        filter_max_reproj_error=6.0,
    )
    reader = ImageReaderConfig(
        camera_model="PINHOLE", camera_params=f"{PIXEL_F},{PIXEL_F},{PIXEL_W / 2},{PIXEL_H / 2}"
    )
    kernels = _kernel_counters()
    rec = Reconstruction()
    _reset_phases()

    def drive():
        feed, t_extract, t_match = run_overlapped_frontend(
            os.path.join(tmp, "overlap.db"), img_dir, _extraction_config(),
            SiftMatchingConfig(min_num_inliers=15), reader, overlap=5, quadratic_overlap=False,
        )
        ctl = IncrementalMapperController(
            rec, CorrespondenceGraph(), opts, ControllerOptions(verbose=False, image_path=img_dir),
            lidar_map=lmap, pose_priors={1: gt[0]}, pair_feed=feed,
        )
        ok = ctl.reconstruct()
        t_extract.join(timeout=300)
        t_match.join(timeout=300)
        if t_extract.is_alive() or t_match.is_alive():
            raise RuntimeError("the overlapped front end's threads did not end")
        return ok, feed

    (ok, feed), seconds, launches = _counted(drive, kernels)
    if feed.error is not None:
        raise RuntimeError(f"the overlapped front end failed: {feed.error!r}")
    if not ok:
        raise RuntimeError("the mapper behind the overlapped front end did not initialize")
    return {
        "registered": rec.num_reg_images, "ate_m": ate_rmse(rec, gt), "scale_err": scale_error(rec, gt),
        "seconds": seconds, "extract_seconds": feed.extract_s, "match_seconds": feed.match_s,
        "match_busy_seconds": feed.match_busy_s, "pairs_matched": feed.n_pairs_matched,
        "pairs_verified": feed.n_pairs_verified, "launches": launches,
    }


def run_descriptor_world(args, tmp: str, rng) -> dict:
    """Phase 8: matcher then lidar mapper on clean synthetic descriptors."""
    import torch

    from colmap_pcd_tpu_torch.utils.logging_utils import PHASES
    from synthetic_torch import make_descriptor_world, mapper_argv, match_precision_recall, write_world

    kernels = _kernel_counters()
    n = args.descriptor_images
    t0 = time.perf_counter()
    rec, graph, lmap, gt, desc, point_ids = make_descriptor_world(
        rng, n_images=n, n_points=110 * n, noise_px=0.4, step=0.8, distractor_share=0.05,
    )
    paths = write_world(rec, graph, lmap, gt, tmp, descriptors=desc)
    kps = [d.shape[0] for d in desc.values()]
    _log(f"[descriptor world] {n} images, {lmap.num_points} map points, "
         f"{np.mean(kps):.0f} keypoints/image ({min(kps)}-{max(kps)}), "
         f"{len(graph.image_pairs())} pairs share points, built and written in "
         f"{time.perf_counter() - t0:.2f} s")

    _reset_phases()
    rc, m_seconds, m_launches = _run_cli(
        ["sequential_matcher", "--database_path", paths["database"],
         "--SequentialMatching.overlap", "5"], kernels,
    )
    if rc != 0:
        raise RuntimeError(f"sequential_matcher exited with {rc}")
    pr = match_precision_recall(paths["database"], point_ids)
    m_syncs = PHASES.counts.get("linalg_syncs", 0)

    _reset_phases()
    torch.cuda.reset_peak_memory_stats()
    out_dir = os.path.join(tmp, "model")
    rc, seconds, launches = _run_cli(mapper_argv(paths, out_dir), kernels)
    if rc != 0:
        raise RuntimeError(f"mapper exited with {rc}")
    res = _read_model(out_dir, gt)
    res.update(_mapper_numbers(seconds, res["registered"]))
    res.update(matcher_seconds=m_seconds, matcher_launches=m_launches, matcher_linalg_syncs=m_syncs,
               match=pr, mapper_launches=launches)
    return res


def run_classic_path(args, tmp: str) -> dict:
    """Phase 6: matcher then classic (lidar-free) mapper on a small world,
    with test_e2e_classic_no_lidar's parameters."""
    import torch

    from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction
    from colmap_pcd_tpu_torch.ops import np_geom, solvers
    from synthetic_torch import classic_mapper_argv, make_descriptor_world, write_world

    kernels = _kernel_counters()
    rec, graph, lmap, gt, desc, _ = make_descriptor_world(
        np.random.default_rng(args.seed + 11), n_images=args.classic_images,
        n_points=85 * args.classic_images, noise_px=0.2, step=1.0,
    )
    paths = write_world(rec, graph, lmap, gt, tmp, descriptors=desc)
    guided_db = os.path.join(tmp, "guided.db")
    shutil.copy(paths["database"], guided_db)
    rc, m_seconds, m_launches = _run_cli(
        ["sequential_matcher", "--database_path", paths["database"],
         "--SequentialMatching.overlap", "5"], kernels,
    )
    if rc != 0:
        raise RuntimeError(f"sequential_matcher (classic world) exited with {rc}")
    # the float route: guided matching goes pair by pair through match_top2
    rc, g_seconds, g_launches = _run_cli(
        ["sequential_matcher", "--database_path", guided_db, "--SequentialMatching.overlap", "2",
         "--SiftMatching.guided_matching", "1"], kernels,
    )
    if rc != 0:
        raise RuntimeError(f"sequential_matcher with guided matching exited with {rc}")
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
        "guided_seconds": g_seconds,
        "guided_launches": g_launches,
        "mapper_seconds": seconds,
        "mapper_launches": launches,
    }


def _require_model(label: str, res: dict, n_images: int):
    """The lidar paths' bars (PERF.md section 2)."""
    if res["registered"] < 0.95 * n_images:
        raise AssertionError(f"{label}: registered {res['registered']} < 95% of {n_images}")
    if not res["ate_m"] < 0.10:
        raise AssertionError(f"{label}: ATE {res['ate_m']} m >= 0.10 m")
    if not res["scale_err"] < 0.02:
        raise AssertionError(f"{label}: scale error {res['scale_err']} >= 2%")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-images", type=int, default=100, help="depth of the pixel world")
    ap.add_argument("--descriptor-images", type=int, default=100)
    ap.add_argument("--overlap-images", type=int, default=30)
    ap.add_argument("--classic-images", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks of phases 3 and 4; no result line")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from colmap_pcd_tpu_torch.models.lidar_map import LidarMap
    from colmap_pcd_tpu_torch.ops import match_kernel, nn_kernel
    from colmap_pcd_tpu_torch.ops.cuda_build import BUILD_SECONDS

    # 1. environment
    smi = _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    _log(f"[env] nvidia-smi: {smi}")
    _log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
         f"count {torch.cuda.device_count()}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp, \
            ThreadPoolExecutor(max_workers=4) as pool:
        # 2. build: one nvcc per source, started together, while the host
        # renders the pixel world
        t0 = time.perf_counter()
        os.makedirs(os.path.join(tmp, "pixels"))
        rendering = None if args.kernels_only else pool.submit(
            render_pixel_world, args, os.path.join(tmp, "pixels"))
        for fut in [pool.submit(f) for f in (nn_kernel.build, match_kernel.build, match_kernel.build_u8)]:
            fut.result()
        _log(f"[build] {len(BUILD_SECONDS)} sources built and loaded in {time.perf_counter() - t0:.2f} s: "
             + ", ".join(f"{stem}.cu {sec:.2f} s" for stem, sec in sorted(BUILD_SECONDS.items())))
        for stem in ("nn_argmin", "match_top2", "match_top2_u8"):
            for line in _ptxas_lines(stem):
                _log(f"[build] {stem}: {line}")

        if args.kernels_only:
            from synthetic_torch import build_corridor_map

            pts, nrm = build_corridor_map(np.random.default_rng(args.seed), length=0.8 * args.n_images + 25)
            lmap = LidarMap.from_arrays(pts, nrm, device="cpu")
            check_kernel(lmap.points, np.random.default_rng(args.seed + 1))
            check_match_kernel(np.random.default_rng(args.seed + 2))
            _log("[kernels-only] phases 2-4 passed; the main path was not driven")
            return 0

        world = rendering.result()
        _log(f"[pixel world] {args.n_images} views at {PIXEL_W}x{PIXEL_H} and 4 at {REF_W}x{REF_H} "
             f"rendered, {world['map_points'].shape[0]} map points written, in {world['seconds']:.2f} s "
             f"(host, beside the build)")

        # 3. + 4. the kernels against their plain versions, on the pixel world's map
        k2 = check_kernel(
            LidarMap.from_arrays(world["map_points"], world["map_normals"], device="cpu").points,
            np.random.default_rng(args.seed + 1),
        )
        k1 = check_match_kernel(np.random.default_rng(args.seed + 2))

        # 5. SIFT on the card
        sf = check_sift(world["paths"])
        w = sf["worst"]
        _log(f"[sift] batch of 8 at {PIXEL_W}x{PIXEL_H}, {PIXEL_FEATURES} features, {PIXEL_OCTAVES} octaves: "
             f"{min(sf['valid'])}-{max(sf['valid'])} keypoints per image; two runs on the card "
             f"identical; against the CPU ({sf['cpu_seconds']:.2f} s there), worst image: partners "
             f"{w['partner_share']:.4f} (within {w['max_px']:.2g} px), same orientation and cosine >= "
             f"{SIFT_COS}: {w['good_share']:.4f}, uint8 codes within 1 there: {w['u8_within_1']:.6f}")
        _log(f"[sift] {sf['ms_per_batch']:.3f} ms per batch of 8 (CUDA events, mean of 3 after a warm-up), "
             f"{sf['kernels_per_batch'] if sf['kernels_per_batch'] is not None else 'not measured'} "
             f"kernels launched per batch, peak device memory {sf['peak_mem_bytes'] / 2**20:.1f} MiB")
        _log(f"[sift] reference scale, batch of 4 at {REF_W}x{REF_H}, {REF_FEATURES} features, "
             f"{REF_OCTAVES} octaves: {sf['ref_ms']:.3f} ms (one call), "
             f"{min(sf['ref_valid'])}-{max(sf['ref_valid'])} keypoints per image, peak device memory "
             f"{sf['ref_peak_mem_bytes'] / 2**20:.1f} MiB")

        # 6. the pixel world
        px = run_pixel_world(world, tmp)
        kps = px["keypoints"]
        _log(f"[pixels] feature_extractor: {len(kps)} images in {px['extract_seconds']:.3f} s "
             f"({len(kps) / px['extract_seconds']:.3f} images/s, cli.main, reading and SQLite included), "
             f"{min(kps)}-{max(kps)} keypoints per image")
        _log(f"[pixels] sequential matcher (overlap 5, no quadratic offsets): {px['matcher_seconds']:.3f} s, "
             f"{px['pairs_tried']} pairs tried, {px['pairs_verified']} verified, K1 launches "
             f"{px['matcher_launches']['match_top2_u8']} (uint8)")
        _log(f"[pixels] mapper: registered {px['registered']}/{args.n_images} in {px['models']} model(s), "
             f"ATE {px['ate_m'] * 1e3:.3f} mm (the JAX package recorded {REFERENCE_ATE_MM} mm on this "
             f"world), scale error {px['scale_err']:.6f}; {px['seconds']:.3f} s end to end (cli.main), "
             f"{px['frames_per_s']:.4f} frames registered/s, K2 launches {px['mapper_launches']['nn_argmin']}, "
             f"peak device memory {px['peak_mem_bytes'] / 2**20:.1f} MiB, {px['ba_solves']} BA solves, "
             f"{px['lm_syncs_per_solve']:.2f} LM host syncs per solve")
        _log("[pixels] mapper phases:\n" + px["phases"])

        # 7. the overlapped front end
        os.makedirs(os.path.join(tmp, "overlap"))
        ov = run_overlapped(args, world, os.path.join(tmp, "overlap"))
        _log(f"[overlap] {args.overlap_images} images: registered {ov['registered']}, ATE "
             f"{ov['ate_m'] * 1e3:.3f} mm, scale error {ov['scale_err']:.6f}; wall {ov['seconds']:.3f} s, "
             f"extraction thread {ov['extract_seconds']:.3f} s, matcher thread "
             f"{ov['match_seconds']:.3f} s of which busy {ov['match_busy_seconds']:.3f} s, "
             f"{ov['pairs_matched']} pairs matched, {ov['pairs_verified']} verified; launches "
             f"{ov['launches']}")

        # 8. the descriptor world
        os.makedirs(os.path.join(tmp, "main"))
        res = run_descriptor_world(args, os.path.join(tmp, "main"), np.random.default_rng(args.seed))
        pr = res["match"]
        _log(f"[matcher] {res['matcher_seconds']:.3f} s (cli.main sequential_matcher), "
             f"{pr['pairs_tried']} pairs tried, {pr['pairs_verified']} verified, "
             f"{pr['inlier_matches']} inlier matches, precision {pr['precision']:.6f}, "
             f"recall {pr['recall']:.6f}, K1 launches {res['matcher_launches']['match_top2_u8']} (uint8) "
             f"and {res['matcher_launches']['match_top2']} (float), "
             f"{res['matcher_linalg_syncs']} linalg host syncs")
        _log(f"[mapper] registered {res['registered']}/{args.descriptor_images} in {res['models']} model(s), "
             f"ATE {res['ate_m']:.6f} m, scale error {res['scale_err']:.6f}")
        _log(f"[mapper] {res['seconds']:.3f} s end to end (cli.main), "
             f"{res['frames_per_s']:.4f} frames registered/s")
        _log(f"[mapper] K2 launches {res['mapper_launches']['nn_argmin']}, peak device memory "
             f"{res['peak_mem_bytes'] / 2**20:.1f} MiB, {res['ba_solves']} BA solves, "
             f"{res['lm_syncs_per_solve']:.2f} LM host syncs per solve")
        _log("[mapper] phases:\n" + res["phases"])

        # 9. the classic path
        os.makedirs(os.path.join(tmp, "classic"))
        cl = run_classic_path(args, os.path.join(tmp, "classic"))
        _log(f"[classic] registered {cl['registered']}/{args.classic_images}, median reprojection "
             f"error {cl['median_reproj_px']:.4f} px, ATE after sim(3) alignment "
             f"{cl['ate_sim3_m']:.6f} m; matcher {cl['matcher_seconds']:.3f} s "
             f"(K1 launches {cl['matcher_launches']['match_top2_u8']} uint8), mapper "
             f"{cl['mapper_seconds']:.3f} s; guided matcher {cl['guided_seconds']:.3f} s "
             f"(K1 launches {cl['guided_launches']['match_top2']} float)")

    # 10. checks
    u8_launches = {"pixel world": px["matcher_launches"]["match_top2_u8"],
                   "overlapped": ov["launches"]["match_top2_u8"],
                   "descriptor world": res["matcher_launches"]["match_top2_u8"],
                   "classic world": cl["matcher_launches"]["match_top2_u8"]}
    k2_launches = {"pixel world": px["mapper_launches"]["nn_argmin"],
                   "overlapped": ov["launches"]["nn_argmin"],
                   "descriptor world": res["mapper_launches"]["nn_argmin"]}
    for path, n in u8_launches.items():
        if n <= 0:
            raise AssertionError(f"the matcher of the {path} never launched the uint8 K1")
    for path, n in k2_launches.items():
        if n <= 0:
            raise AssertionError(f"the mapper of the {path} never launched K2")
    if cl["guided_launches"]["match_top2"] <= 0:
        raise AssertionError("the guided matcher never launched the float K1")
    # the corridor's value-noise texture gives ~450 keypoints per view above
    # the peak threshold (both packages find the same number on one view)
    if len(px["keypoints"]) != args.n_images or min(px["keypoints"]) < 300 \
            or max(px["keypoints"]) > PIXEL_FEATURES:
        raise AssertionError(f"pixel world: {len(px['keypoints'])} images with "
                             f"{min(px['keypoints'])}-{max(px['keypoints'])} keypoints")
    cam = px["cameras"]
    if len(cam) != 1 or cam[1]["model_id"] != 1 or list(cam[1]["params"]) != [PIXEL_F, PIXEL_F, PIXEL_W / 2, PIXEL_H / 2]:
        raise AssertionError(f"pixel world: cameras {cam}")
    _require_model("pixel world", px, args.n_images)
    _require_model("overlapped front end", ov, args.overlap_images)
    _require_model("descriptor world", res, args.descriptor_images)
    if not pr["precision"] >= 0.95:
        raise AssertionError(f"match precision {pr['precision']} < 0.95")
    if cl["registered"] < args.classic_images - 1:
        raise AssertionError(f"classic: registered {cl['registered']} < {args.classic_images - 1}")
    if not cl["median_reproj_px"] < 1.0:
        raise AssertionError(f"classic: median reprojection error {cl['median_reproj_px']} >= 1 px")

    def entry(name, source, line, launches, rec, **more):
        return {
            "name": name, "route": "cuda", "source": f"colmap_pcd_tpu_torch/csrc/{source}",
            "replaces": f"colmap_pcd_tpu/ops/pallas_kernels.py:{line}", "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "device_ms": rec["device_ms"], **more, "shapes": rec["shapes"],
        }

    # `launches` is the pixel world's count (the guided matcher's for the
    # float K1, which no other path runs); the other paths' stand beside it
    print(json.dumps({"kernels": [
        entry("nn_argmin", "nn_argmin.cu", 191, k2_launches["pixel world"], k2,
              launches_by_path=k2_launches),
        entry("match_top2", "match_top2.cu", 94, cl["guided_launches"]["match_top2"], k1["match_top2"],
              launches_by_path={"guided matcher, classic world": cl["guided_launches"]["match_top2"]}),
        entry("match_top2_u8", "match_top2_u8.cu", 94, u8_launches["pixel world"],
              k1["match_top2_u8"], mma="wgmma", launches_by_path=u8_launches),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
