#!/usr/bin/env python3
"""Smoke run of the PyTorch port (colmap_pcd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--n-images 100] [--descriptor-images 50]
                          [--overlap-images 30] [--classic-images 20]
                          [--rig-snapshots 100] [--rig-points 20000] [--seed 0]

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
  8. the descriptor world: a synthetic corridor world (50 images, 0.8 m
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
 10. the SfM tools on the pixel world's model and database, each through
     cli.main with the launch counts zeroed just before it: model_analyzer;
     bundle_adjuster with the lidar map (K2 over every model point, and K2
     timed at that query count); image_deleter of the last tenth of the
     images, then image_registrator; point_triangulator; model_aligner
     (robust, 0.05 m) with a tenth of the references moved 1 m, onto the
     model's own centres under a known similarity and onto the ground
     truth; model_converter to TXT, NVM and PLY; model_comparer;
     model_orientation_aligner (image orientation); image_undistorter over
     every registered view; database_cleaner of the matches on a copy of
     the database, then spatial_matcher on the first 30 views (uint8 K1);
     hierarchical_mapper in leaves of 50 sharing 10 with the lidar map and
     the pose prior (K2); then
     `ops.ba.solve` on tests/test_ba_pcg.py's 2000-camera corridor, which
     "auto" sends to the PCG tier;
 11. retrieval and camera rigs, each command through cli.main with the
     launch counts zeroed just before it: vocab_tree_builder (k = 64 words
     x 128) and vocab_tree_retriever --num_images 10 on the pixel world's
     database (recall@10 of the views at most 2 steps away);
     vocab_tree_matcher (10 neighbours, vote-and-verify re-ranking) and
     sequential_matcher at overlap 5 with loop detection and re-ranking,
     each on a copy cleared of matches (uint8 K1); the index built on the
     card against the one built on the CPU (VLADs, top-10 lists,
     vote-and-verify scores of every 10th image's top 20, twice on the
     card); vote_and_verify_batch of one query against 20 candidates (on
     the card twice and on the CPU) and build_index at the reference
     feature cap of 8192 (CUDA events, peak memory); the rig world (a 4-camera rig, 0.3 m lever arms, over 100
     snapshots of the pixel world's trajectory, 20 000 wall points, 0.5 px
     noise; rig poses perturbed by 2 cm / 0.5 deg, relative poses by 1 cm /
     0.3 deg) through rig_bundle_adjuster with refined relative poses; and
     ransac_generalized_relative_pose (GR6P) at 2 000 rays with 20%
     outliers and H = 256;
 12. checks: match_top2_u8 launched by every matcher run (spatial_matcher,
     vocab_tree_matcher and the loop-detecting sequential matcher
     included), match_top2 by the guided matcher and K2 by every lidar
     mapper run, bundle_adjuster and hierarchical_mapper; the pixel world
     holds 100 images of 300-2 048 keypoints and its model >= 95%
     registered with ATE < 0.10 m and scale error < 2%, and so do the
     overlapped run (with no error in its feed) and the descriptor world
     (match precision >= 0.95); classic mapper >= 19/20 registered with
     median reprojection error < 1.0 px; bundle_adjuster keeps every image
     at ATE < 0.10 m and no more than 2 mm above its input's, at least 9 of
     10 images register back, the aligner's median error < 5 mm on its own
     centres (< 0.10 m on the ground truth), undistorted PINHOLE images
     within 1 grey level of their input, spatial pairs verified, the
     hierarchical model holding at least its seeded leaf (50 images) at
     ATE < 0.15 m, and the PCG corridor at < 1% of its initial cost with
     every camera within 0.1 m; vocab_tree_matcher verifies every
     consecutive pair, loop detection adds pairs, recall@10 >= 0.9, the
     card's index agrees with the CPU's (VLADs within 1e-5, top-10 lists
     equal but for near-ties within 1e-6, vote-and-verify scores equal and
     equal twice, at the pixel world's shortlists and at the reference
     cap), rig BA reaches a mean reprojection error < 0.75 px with every
     relative pose within 2 mm and 0.02 deg of the truth and every image
     centre within 5 mm after a sim(3) alignment, and GR6P's rotation error
     is < 1e-3 rad.

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

# retrieval on the card against the CPU: VLADs within VLAD_ATOL (f32 sums
# in another order); top-10 lists equal except between similarities within
# 1e-6; vote-and-verify scores equal. Recall@10 of the views at most two
# steps away on the pixel world
VLAD_ATOL = 1e-5
RETRIEVAL_RECALL = 0.9
# the rig world's bars, set from a CPU rehearsal of the phase at full size
# (mean reprojection 0.609 px, relative poses within 0.0056 deg and 0.55 mm,
# centres within 0.81 mm after a sim(3) alignment; GR6P 7.2e-5 rad)
RIG_REPROJ_PX, RIG_REL_DEG, RIG_REL_M, RIG_CENTRE_M = 0.75, 0.02, 0.002, 0.005
GR6P_ROT_RAD = 1e-3

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


def _k2_shape(q: np.ndarray, pts: np.ndarray, pts_d, pts4_d, tree) -> dict:
    """K2 at one shape: held against its plain version and the host
    kd-tree, then timed (call, device, plain, library, kd-tree) beside its
    bound. Returns the numbers and both versions' indices."""
    import torch

    from colmap_pcd_tpu_torch.ops import nn_kernel

    Q, n_map = q.shape[0], pts.shape[0]
    q_d = torch.as_tensor(q, device=pts_d.device)
    idx, dist = nn_kernel.nn_argmin(q_d, pts4_d)
    torch.cuda.synchronize()
    ref_idx, ref_dist = nn_kernel.nn_argmin_reference(q_d, pts_d)
    idx, dist, ref_idx, ref_dist = (a.cpu().numpy() for a in (idx, dist, ref_idx, ref_dist))
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
    # each input read once (queries and map as [n,3] f32), each output
    # written once; 8 flops per (query, point) pair
    bound_ms, bound_by = _bound(12 * Q + 12 * n_map + 8 * Q, 8.0 * Q * n_map, F32_FLOPS)
    _log(
        f"[k2] Q={Q} N={n_map}: kernel {ms:.4f} ms per call, {device_ms:.4f} ms on the "
        f"device (CUDA graph); bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / device_ms:.1f}% reached; "
        f"plain {plain_ms:.4f} ms, cdist+argmin {library_ms:.4f} ms, "
        f"host kd-tree {host_ms:.4f} ms (host clock, median of 20); "
        f"max abs dist err {err:.3g} m, "
        f"max rel {rel:.3g}, index mismatches at equal distance {mism.size}"
    )
    return dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
                host_kdtree_ms=host_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                idx=idx, ref_idx=ref_idx)


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
            shape = _k2_shape(q, pts, pts_d, pts4_d, tree)
            idx, ref_idx = shape.pop("idx"), shape.pop("ref_idx")
            if n_map == ragged and not (np.array_equal(idx[:8], ref_idx[:8]) and idx[:8].max() < 50_000):
                raise AssertionError(f"K2 did not take the lowest of equally near points: {idx[:8]}")
            record["max_abs_err"] = max(record["max_abs_err"], shape.pop("max_abs_err"))
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
               pairs_tried=n_tried, mapper_launches=launches, model_root=out_dir)
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


def _largest_model_dir(out_dir: str) -> str:
    from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction

    dirs = [os.path.join(out_dir, d) for d in sorted(os.listdir(out_dir))]
    return max(dirs, key=lambda d: Reconstruction.read(d).num_reg_images)


def _centers(rec) -> dict:
    return {iid: rec.images[iid].projection_center() for iid in rec.registered_ids}


def _aligner_errors(model: str, refs: dict, moved: set, out_dir: str, kernels: dict, rng) -> tuple[dict, float]:
    """model_aligner (robust, max error 0.05 m) of `model` onto `refs`
    {image: centre}, the images in `moved` displaced by 1 m in a random
    direction: the aligned centres' distances to the other references, and
    the command's seconds."""
    from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction

    rec = Reconstruction.read(model)
    ref_path = out_dir + ".txt"
    with open(ref_path, "w") as f:
        for iid, c in sorted(refs.items()):
            if iid in moved:
                d = rng.normal(size=3)
                c = c + d / np.linalg.norm(d)
            f.write(f"{rec.images[iid].name} {c[0]:.17g} {c[1]:.17g} {c[2]:.17g}\n")
    rc, seconds, _ = _run_cli(["model_aligner", "--input_path", model, "--output_path", out_dir,
                               "--ref_images_path", ref_path, "--robust_alignment_max_error", "0.05"], kernels)
    if rc != 0:
        raise RuntimeError(f"model_aligner exited with {rc}")
    aligned = _centers(Reconstruction.read(out_dir))
    return {iid: float(np.linalg.norm(aligned[iid] - refs[iid])) for iid in refs if iid not in moved}, seconds


def _corridor_pcg(seed: int, n_cams: int) -> dict:
    """`ops.ba.solve` on tests/test_ba_pcg.py's corridor at n_cams cameras
    (the slow JAX test's problem, built in numpy): "auto" must take the
    PCG tier and converge as that test demands."""
    import torch

    from colmap_pcd_tpu_torch.ops import ba
    from synthetic_torch import corridor_ba_problem

    rng = np.random.default_rng(seed)
    qs, ts, intr, pts, oc, op, ouv = corridor_ba_problem(rng, n_cams)
    ts_n = ts.copy()
    ts_n[2:] += rng.normal(0, 0.02, ts_n[2:].shape).astype(np.float32)
    pts_n = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
    pose_fixed = np.zeros(n_cams, np.float32)
    pose_fixed[:2] = 1.0
    prob = ba.make_problem(qs, ts_n, intr, pts_n, oc, op, ouv, pose_fixed=pose_fixed, track_len=8,
                           device="cuda")
    cfg = ba.BAConfig(model_id=1, max_iterations=15, camera_solver="auto")
    if not ba.uses_pcg(prob, cfg):
        raise AssertionError(f"{n_cams} cameras did not take the PCG tier")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = ba.solve(prob, cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {
        "cameras": n_cams, "points": pts.shape[0], "observations": oc.size, "seconds": seconds,
        "iterations": res.iterations, "host_syncs": res.host_syncs,
        "cg_syncs": res.host_syncs - res.iterations, "initial_cost": float(res.initial_cost),
        "final_cost": float(res.final_cost), "max_t_err_m": float((res.cam_t.cpu() - torch.as_tensor(ts)).abs().max()),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }


def _leaf_sizes(database: str, leaf_max: int, overlap: int) -> list:
    """The sizes of the leaves `hierarchical_mapper` cuts the database's
    match graph into."""
    from colmap_pcd_tpu_torch.models.correspondence_graph import CorrespondenceGraph
    from colmap_pcd_tpu_torch.models.database import Database
    from colmap_pcd_tpu_torch.models.hierarchical import SceneClusteringOptions, cluster_images

    db = Database(database)
    graph = CorrespondenceGraph()
    for i, j in db.all_two_view_pair_ids():
        graph.add_matches(i, j, db.read_two_view_geometry(i, j)["inlier_matches"].astype(np.int32))
    ids = list(db.images())
    db.close()
    opts = SceneClusteringOptions(leaf_max_num_images=leaf_max, image_overlap=overlap)
    return sorted((len(c) for c in cluster_images(graph, ids, opts)), reverse=True)


def _k2_model_queries(rec, map_points: np.ndarray) -> dict:
    """K2 at the bundle adjuster's shape: every point of the model against
    the map, as `BundleAdjustmentController` queries them."""
    import torch

    from colmap_pcd_tpu_torch.ops import nn_kernel
    from colmap_pcd_tpu_torch.utils.native import NativeKdTree

    q = np.stack([p.xyz for p in rec.points3D.values()]).astype(np.float32)
    map_pts = np.ascontiguousarray(map_points, np.float32)
    pts_d = torch.as_tensor(map_pts, device="cuda")
    shape = _k2_shape(q, map_pts, pts_d, nn_kernel.pack_points(pts_d), NativeKdTree(map_pts))
    del shape["idx"], shape["ref_idx"]
    return shape


def run_sfm_tools(args, world: dict, px: dict, tmp: str) -> dict:
    """Phase 10: the SfM tools off the main path, through cli.main on the
    pixel world's model and database, each with the launch counts zeroed
    just before it; then the PCG tier on the 2000-camera corridor."""
    from colmap_pcd_tpu_torch.models.database import Database
    from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction
    from colmap_pcd_tpu_torch.ops import np_geom
    from colmap_pcd_tpu_torch.utils.image import imread_rgb
    from synthetic_torch import ate_rmse, mapper_argv

    kernels = _kernel_counters()
    paths, gt, n = world["paths"], world["gt"], args.n_images
    model = _largest_model_dir(px["model_root"])
    lidar = ["--Mapper.lidar_pointcloud_path", paths["lidar"]]
    res = {"commands": {}}

    def run(label, argv):
        rc, seconds, launches = _run_cli(argv, kernels)
        if rc != 0:
            raise RuntimeError(f"{label} exited with {rc}")
        res["commands"][label] = {"seconds": seconds, "launches": launches}
        _log(f"[sfm tools] {label}: {seconds:.3f} s (cli.main), launches {launches}")
        return launches

    def out(name):
        return os.path.join(tmp, name)

    run("model_analyzer", ["model_analyzer", "--path", model])

    # whole-model BA with a fresh lidar association of every point (K2)
    rec_in = Reconstruction.read(model)
    rec_in.update_point_errors()
    run("bundle_adjuster", ["bundle_adjuster", "--input_path", model, "--output_path", out("ba"), *lidar])
    rec_ba = Reconstruction.read(out("ba"))
    res.update(ba_registered=(rec_in.num_reg_images, rec_ba.num_reg_images),
               ba_ate_m=(ate_rmse(rec_in, gt), ate_rmse(rec_ba, gt)),
               ba_reproj_px=(rec_in.mean_reprojection_error(), rec_ba.mean_reprojection_error()),
               ba_queries=len(rec_in.points3D))
    res["k2_ba_shape"] = _k2_model_queries(rec_in, world["map_points"])

    # the last tenth of the images out of the model, then registered back
    dropped = list(range(n - n // 10 + 1, n + 1))
    ids = out("dropped.txt")
    with open(ids, "w") as f:
        f.write("".join(f"{i}\n" for i in dropped))
    run("image_deleter", ["image_deleter", "--input_path", out("ba"), "--output_path", out("deleted"),
                          "--image_ids_path", ids])
    run("image_registrator", ["image_registrator", "--database_path", paths["database"],
                              "--input_path", out("deleted"), "--output_path", out("registered"),
                              "--Mapper.if_add_lidar_constraint", "0", *PIXEL_MAPPER_FLAGS])
    rec_reg = Reconstruction.read(out("registered"))
    res["registered_back"] = (sum(rec_reg.images[i].registered for i in dropped), len(dropped))

    run("point_triangulator", ["point_triangulator", "--database_path", paths["database"],
                               "--input_path", out("ba"), "--output_path", out("triangulated")])
    res["triangulated_points"] = (len(rec_ba.points3D), len(Reconstruction.read(out("triangulated")).points3D))

    # robust alignment with a tenth of the references displaced by 1 m: onto
    # the model's own centres under a known similarity (the aligner's error
    # alone), and onto the ground-truth centres (bounded by the model's ATE)
    rng = np.random.default_rng(args.seed + 5)
    moved = set(int(i) for i in rng.choice(sorted(rec_ba.registered_ids), len(rec_ba.registered_ids) // 10,
                                           replace=False))
    q_s, s_s, t_s = np_geom.so3_exp_quat(np.asarray([0.1, -0.2, 0.3])), 1.3, np.asarray([2.0, -1.0, 0.5])
    R_s = np_geom.quat_to_rotmat(q_s)
    self_refs = {i: s_s * R_s @ c + t_s for i, c in _centers(rec_ba).items()}
    err_self, sec_self = _aligner_errors(out("ba"), self_refs, moved, out("aligned_self"), kernels, rng)
    gt_refs = {i: np_geom.projection_center(*gt[i - 1]) for i in rec_ba.registered_ids}
    err_gt, sec_gt = _aligner_errors(out("ba"), gt_refs, moved, out("aligned_gt"), kernels, rng)
    res.update(aligner_median_m=(float(np.median(list(err_self.values()))), float(np.median(list(err_gt.values())))),
               aligner_seconds=(sec_self, sec_gt), aligner_moved=len(moved))
    _log(f"[sfm tools] model_aligner: {sec_self:.3f} s and {sec_gt:.3f} s (cli.main), {len(moved)} of "
         f"{len(self_refs)} references moved 1 m")

    for kind, dst in (("TXT", out("txt")), ("NVM", out("model.nvm")), ("PLY", out("model.ply"))):
        run(f"model_converter {kind}", ["model_converter", "--input_path", out("ba"), "--output_path", dst,
                                        "--output_type", kind])
    run("model_comparer", ["model_comparer", "--input_path1", model, "--input_path2", out("ba")])
    run("model_orientation_aligner", ["model_orientation_aligner", "--input_path", out("ba"),
                                      "--output_path", out("oriented"), "--method", "image-orientation"])

    # PINHOLE in, PINHOLE out: the undistorted images equal the input
    run("image_undistorter", ["image_undistorter", "--image_path", paths["images"], "--input_path", out("ba"),
                              "--output_path", out("undistorted")])
    diffs = []
    for img in rec_ba.images.values():
        if img.registered:
            a = imread_rgb(os.path.join(paths["images"], img.name)).astype(np.int16)
            b = imread_rgb(os.path.join(out("undistorted"), "images", img.name)).astype(np.int16)
            diffs.append(int(np.abs(a - b).max()))
    res["undistorted"] = (len(diffs), max(diffs))

    # spatial matching of the first 30 views on a copy cleaned of matches
    spatial_db = out("spatial.db")
    shutil.copy(paths["database"], spatial_db)
    run("database_cleaner", ["database_cleaner", "--database_path", spatial_db, "--type", "matches"])
    db = Database(spatial_db)
    names = {iid: v["name"] for iid, v in db.images().items()}
    db.close()
    loc = out("locations.txt")
    with open(loc, "w") as f:
        for iid in sorted(names)[:30]:
            c = np_geom.projection_center(*gt[iid - 1])
            f.write(f"{names[iid]} {c[0]:.17g} {c[1]:.17g} {c[2]:.17g}\n")
    run("spatial_matcher", ["spatial_matcher", "--database_path", spatial_db, "--location_path", loc,
                            "--SiftMatching.min_num_inliers", "15"])
    db = Database(spatial_db)
    res["spatial_pairs_verified"] = sum(
        1 for i, j in db.all_two_view_pair_ids() if len(db.read_two_view_geometry(i, j)["inlier_matches"]) > 0
    )
    db.close()

    # hierarchical mapping in leaves of 50 with 10 shared, lidar map + prior
    argv = mapper_argv(paths, out("hierarchical"), *PIXEL_MAPPER_FLAGS,
                       "--leaf_max_num_images", "50", "--image_overlap", "10")
    run("hierarchical_mapper", ["hierarchical_mapper", *argv[1:]])
    rec_h = Reconstruction.read(os.path.join(out("hierarchical"), "0"))
    res["hierarchical"] = (rec_h.num_reg_images, ate_rmse(rec_h, gt))
    res["hierarchical_leaves"] = _leaf_sizes(paths["database"], 50, 10)

    res["pcg"] = _corridor_pcg(args.seed + 6, 2000)
    return res


def _require_sfm_tools(st: dict, px: dict, n_images: int):
    """The SfM tools' bars."""
    (n_in, n_ba), (ate_in, ate_ba) = st["ba_registered"], st["ba_ate_m"]
    if n_ba != n_in or not ate_ba < 0.10 or ate_ba > ate_in + 0.002:
        raise AssertionError(f"bundle_adjuster: registered {n_in} -> {n_ba}, ATE {ate_in} -> {ate_ba} m")
    if st["registered_back"][0] < st["registered_back"][1] - 1:
        raise AssertionError(f"image_registrator registered {st['registered_back']} images back")
    if not st["aligner_median_m"][0] < 0.005 or not st["aligner_median_m"][1] < 0.10:
        raise AssertionError(f"model_aligner: median errors {st['aligner_median_m']} m")
    if st["undistorted"] != (px["registered"], st["undistorted"][1]) or st["undistorted"][1] > 1:
        raise AssertionError(f"image_undistorter: {st['undistorted']} (images, max grey-level difference)")
    if st["spatial_pairs_verified"] <= 0:
        raise AssertionError("spatial_matcher verified no pair")
    # the clustering (carried from the JAX package) cuts a sequential capture
    # into one leaf of 50 and leaves of a few images grown by their
    # neighbours (the greedy bisection peels one end of the chain); only
    # the leaf holding the seed maps with the lidar map, and on this
    # forward-moving world the others' classic init fails (PERF.md, section 6):
    # the merged model must hold the seeded leaf, at test_hierarchical.py's
    # accuracy bar
    registered, ate = st["hierarchical"]
    if registered < min(50, n_images) or not ate < 0.15:
        raise AssertionError(f"hierarchical_mapper: registered {registered}/{n_images}, ATE {ate} m")
    pcg = st["pcg"]
    if not (pcg["final_cost"] < 0.01 * pcg["initial_cost"] and pcg["max_t_err_m"] < 0.1):
        raise AssertionError(f"PCG corridor: {pcg}")


# ---------------------------------------------------------------------------
# phase 11: retrieval and camera rigs


def _db_pairs(database: str) -> tuple[int, set]:
    """(pairs tried, {verified pairs}) of a matcher-written database."""
    from colmap_pcd_tpu_torch.models.database import Database, pair_id_to_image_pair

    db = Database(database)
    tried = [pair_id_to_image_pair(r[0]) for r in db.conn.execute("SELECT pair_id FROM matches")]
    verified = {(i, j) for i, j in db.all_two_view_pair_ids()
                if len(db.read_two_view_geometry(i, j)["inlier_matches"]) > 0}
    db.close()
    return len(tried), verified


def _retrieval_agreement(database: str) -> dict:
    """The index on the card against the index on the CPU from one database
    (VLADs, top-10 lists, vote-and-verify scores of every 10th image's top
    20, twice on the card), and the index's build time on the card."""
    import torch

    from colmap_pcd_tpu_torch import device as device_mod
    from colmap_pcd_tpu_torch.models.database import Database
    from colmap_pcd_tpu_torch.ops import retrieval, vote_verify

    db = Database(database)
    ids = sorted(db.images())
    descs = {i: db.read_descriptors(i).astype(np.float32) for i in ids}
    geoms = {i: db.read_keypoints(i)[:, :4].astype(np.float32) for i in ids}
    db.close()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = retrieval.build_index(descs, geoms_by_image=geoms, device=device_mod.resolve("cuda"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cpu = retrieval.build_index(descs, geoms_by_image=geoms, device="cpu")
    res = {"build_index_s": build_s, "images": len(ids),
           "vlad_err": float((gpu.vlads.cpu() - cpu.vlads).abs().max()),
           "centroid_err": float((gpu.centroids.cpu() - cpu.centroids).abs().max()),
           "top10_differ": 0, "top10_near_ties": 0, "vv_checked": 0, "vv_differ": 0, "vv_rerun_differ": 0}
    opts = vote_verify.VoteVerifyOptions()
    for qi, i in enumerate(ids):
        s_g, s_c = retrieval.similarities(gpu, qi), retrieval.similarities(cpu, qi)
        top_g = [int(o) for o in np.argsort(-s_g) if o != qi][:10]
        top_c = [int(o) for o in np.argsort(-s_c) if o != qi][:10]
        if top_g != top_c:
            res["top10_differ"] += 1
            ties = all(abs(s_c[a] - s_c[b]) <= 1e-6 for a, b in zip(top_g, top_c) if a != b)
            res["top10_near_ties"] += int(ties)
        if qi % 10 == 0:
            short = [int(o) for o in np.argsort(-s_c) if o != qi][:20]
            scores = []
            for index in (gpu, gpu, cpu):
                rows = torch.as_tensor(short, device=index.vlads.device)
                scores.append(vote_verify.vote_and_verify_batch(
                    index.geoms[qi], index.words[qi], index.valids[qi], index.geoms[rows], index.words[rows],
                    index.valids[rows], opts).cpu().numpy())
            res["vv_checked"] += len(short)
            res["vv_rerun_differ"] += int(np.sum(scores[0] != scores[1]))
            res["vv_differ"] += int(np.sum(scores[0] != scores[2]))
            res.setdefault("vv_scores_sample", scores[0].tolist())
    return res


def run_retrieval(world: dict, tmp: str) -> dict:
    """Phase 11a: the retrieval commands on the pixel world's database."""
    import contextlib
    import io

    from colmap_pcd_tpu_torch.models.database import Database

    kernels = _kernel_counters()
    database = world["paths"]["database"]
    res = {"commands": {}}

    def run(label, argv, quiet=False):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf) if quiet else contextlib.nullcontext():
            rc, seconds, launches = _run_cli(argv, kernels)
        if rc != 0:
            raise RuntimeError(f"{label} exited with {rc}")
        res["commands"][label] = {"seconds": seconds, "launches": launches}
        return buf.getvalue()

    vocab = os.path.join(tmp, "vocab.npz")
    run("vocab_tree_builder", ["vocab_tree_builder", "--database_path", database, "--vocab_tree_path", vocab])
    res["vocab_words"] = np.load(vocab)["centroids"].shape
    lines = run("vocab_tree_retriever", ["vocab_tree_retriever", "--database_path", database,
                                         "--num_images", "10"], quiet=True)
    db = Database(database)
    by_name = {v["name"]: k for k, v in db.images().items()}
    db.close()
    hits = total = 0
    for line in lines.splitlines():
        name, _, ranked = line.partition(": ")
        if name not in by_name:
            continue
        i = by_name[name]
        got = {by_name[n] for n in ranked.split(", ")}
        truth = {j for j in by_name.values() if 0 < abs(j - i) <= 2}
        hits += len(truth & got)
        total += len(truth)
    res["recall_at_10"] = hits / max(total, 1)
    res["retriever_lines"] = sum(1 for ln in lines.splitlines() if ": " in ln)

    from colmap_pcd_tpu_torch.models.feature_pipeline import sequential_pair_list

    ids = sorted(by_name.values())
    matcher = ["--SiftMatching.min_num_inliers", "15"]
    for label, argv in (
        ("vocab_tree_matcher", ["vocab_tree_matcher", "--VocabTreeMatching.num_images", "10",
                                "--VocabTreeMatching.spatial_rerank", "1", *matcher]),
        ("sequential_matcher loop detection", ["sequential_matcher", "--SequentialMatching.overlap", "5",
                                               "--SequentialMatching.loop_detection", "1",
                                               "--SequentialMatching.spatial_rerank", "1", *matcher]),
    ):
        copy = os.path.join(tmp, label.split()[0] + ".db")
        shutil.copy(database, copy)
        run(f"database_cleaner ({label})", ["database_cleaner", "--database_path", copy, "--type", "matches"])
        run(label, [argv[0], "--database_path", copy, *argv[1:]])
        tried, verified = _db_pairs(copy)
        res["commands"][label].update(pairs_tried=tried, pairs_verified=len(verified),
                                      consecutive_verified=sum((i, i + 1) in verified for i in ids[:-1]))
    res["sequential_pairs"] = len(sequential_pair_list(ids, 5, True))
    res["agreement"] = _retrieval_agreement(database)
    return res


def _vv_reference_scale(rng, C: int = 20, cap: int = 8192) -> dict:
    """vote_and_verify_batch of one query against C candidates and
    build_index of the C + 1 images at the reference feature cap (8192, the
    JAX package's reference-scale bench), on synthetic geometry: candidate c
    shares (1 - c/C)/2 of the query's features under a similarity, the rest
    random. The scores on the card against the CPU's and a second run's;
    times by CUDA events (mean of 3 after a warm-up), peak memory."""
    import torch

    from colmap_pcd_tpu_torch import device as device_mod
    from colmap_pcd_tpu_torch.ops import retrieval, vote_verify

    W, H = REF_W, REF_H

    def feats(n):
        return np.concatenate([rng.uniform([0, 0], [W, H], (n, 2)), rng.uniform(1, 8, (n, 1)),
                               rng.uniform(-np.pi, np.pi, (n, 1))], -1), rng.integers(0, 64, n)

    gq, wq = feats(cap)
    g2, w2 = np.zeros((C, cap, 4)), np.zeros((C, cap), np.int64)
    for c in range(C):
        g2[c], w2[c] = feats(cap)
        keep = rng.random(cap) < 0.5 * (1 - c / C)
        s, a, t = rng.uniform(0.8, 1.25), rng.uniform(-0.3, 0.3), rng.uniform(-100, 100, 2)
        R = np.asarray([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        g2[c, keep, :2] = s * gq[keep, :2] @ R.T + t + rng.normal(0, 1.0, (keep.sum(), 2))
        g2[c, keep, 2] = s * gq[keep, 2]
        g2[c, keep, 3] = gq[keep, 3] + a
        w2[c, keep] = wq[keep]
    dev = device_mod.resolve("cuda")
    args = [torch.as_tensor(x, dtype=dt, device=dev) for x, dt in (
        (gq, torch.float32), (wq, torch.int32), (np.ones(cap), torch.float32),
        (g2, torch.float32), (w2, torch.int32), (np.ones((C, cap)), torch.float32))]
    opts = vote_verify.VoteVerifyOptions()
    scores = vote_verify.vote_and_verify_batch(*args, opts).cpu().numpy()
    rerun = vote_verify.vote_and_verify_batch(*args, opts).cpu().numpy()
    on_cpu = vote_verify.vote_and_verify_batch(*(a.cpu() for a in args), opts).numpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    vv_ms = _cuda_ms(lambda: vote_verify.vote_and_verify_batch(*args, opts), 3)
    vv_peak = torch.cuda.max_memory_allocated() - base

    descs = {i: (rng.normal(size=(cap, 128)) ** 2 * 60).clip(0, 255).astype(np.uint8) for i in range(1, C + 2)}
    geoms = {i: feats(cap)[0].astype(np.float32) for i in descs}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    build_ms = _cuda_ms(lambda: retrieval.build_index(descs, geoms_by_image=geoms, device=dev), 1)
    build_peak = torch.cuda.max_memory_allocated() - base
    return {"C": C, "cap": cap, "scores": scores.tolist(), "rerun_differ": int(np.sum(rerun != scores)),
            "cpu_differ": int(np.sum(on_cpu != scores)), "vv_ms": vv_ms, "vv_peak_bytes": vv_peak,
            "build_ms": build_ms, "build_peak_bytes": build_peak, "images": C + 1}


# the rig world: four cameras (front, right, left, rear; yaw 0, 90, -90, 180
# degrees about the camera's down axis) with 0.3 m lever arms, on the pixel
# world's trajectory
RIG_CAMERAS = (("front", 0.0, (0.0, 0.0, 0.0)), ("right", np.pi / 2, (0.3, 0.0, 0.0)),
               ("left", -np.pi / 2, (-0.3, 0.0, 0.0)), ("rear", np.pi, (0.0, 0.0, -0.3)))


def _perturbed(rng, q, t, metres: float, degrees: float):
    """(q, t) moved by `metres` and turned by `degrees` in random directions."""
    from colmap_pcd_tpu_torch.ops import np_geom

    axis, step = rng.normal(size=3), rng.normal(size=3)
    dq = np_geom.so3_exp_quat(axis / np.linalg.norm(axis) * np.deg2rad(degrees))
    return np_geom.quat_mul(dq, q), t + step / np.linalg.norm(step) * metres


def _rig_world(rng, n_snap: int, n_points: int):
    """The rig world as a model whose image poses compose perturbed rig and
    relative poses (rig 2 cm / 0.5 deg, non-reference cameras 1 cm / 0.3 deg),
    the rig config holding the perturbed relative poses, and the truth."""
    from colmap_pcd_tpu_torch.models.reconstruction import Camera, Image, Reconstruction
    from colmap_pcd_tpu_torch.ops import np_geom
    from synthetic_torch import make_trajectory

    rigs = make_trajectory(n_snap, PIXEL_STEP)  # world -> rig (the front camera)
    rel = []
    for _, yaw, c in RIG_CAMERAS:
        R = np.asarray([[np.cos(yaw), 0, -np.sin(yaw)], [0, 1, 0], [np.sin(yaw), 0, np.cos(yaw)]])  # rig -> cam
        rel.append((np_geom.rotmat_to_quat(R), -R @ np.asarray(c)))
    rel_p = [rel[0]] + [_perturbed(rng, q, t, 0.01, 0.3) for q, t in rel[1:]]
    rigs_p = [_perturbed(rng, q, t, 0.02, 0.5) for q, t in rigs]
    half = n_points // 2
    z = rng.uniform(-25.0, n_snap * PIXEL_STEP + 25.0, n_points)
    pts = np.stack([np.where(np.arange(n_points) < half, -4.0, 4.0), rng.uniform(-2.0, 2.0, n_points), z], -1)

    rec = Reconstruction()
    K = np.asarray([PIXEL_F, PIXEL_F, PIXEL_W / 2, PIXEL_H / 2])
    for c in range(len(RIG_CAMERAS)):
        rec.add_camera(Camera(c + 1, 1, PIXEL_W, PIXEL_H, K.copy()))
    tracks = [[] for _ in range(n_points)]
    truth = {}
    for s in range(n_snap):
        for c, (name, _, _) in enumerate(RIG_CAMERAS):
            iid = s * len(RIG_CAMERAS) + c + 1
            q, t = np_geom.se3_compose(*rel[c], *rigs[s])
            truth[iid] = (q, t)
            Xc = np_geom.se3_apply(q, t, pts)
            zc = Xc[:, 2]
            with np.errstate(divide="ignore", invalid="ignore"):
                uv = PIXEL_F * Xc[:, :2] / zc[:, None] + K[2:]
            seen = np.nonzero((zc > 0.5) & (zc < 30.0) & (uv[:, 0] >= 0) & (uv[:, 0] < PIXEL_W)
                              & (uv[:, 1] >= 0) & (uv[:, 1] < PIXEL_H))[0]
            qp, tp = np_geom.se3_compose(*rel_p[c], *rigs_p[s])
            rec.add_image(Image(iid, f"{name}/{s:04d}.png", c + 1, qvec=qp, tvec=tp,
                                xys=uv[seen] + rng.normal(0, 0.5, (seen.size, 2))))
            rec.register_image(iid)
            for k, p in enumerate(seen):
                tracks[p].append((iid, k))
    for p in range(n_points):
        if len(tracks[p]) >= 2:
            rec.add_point3D(pts[p], tracks[p])
    config = [{"ref_camera_id": 1, "cameras": [
        {"camera_id": c + 1, "image_prefix": f"{name}/", "rel_qvec": rel_p[c][0].tolist(),
         "rel_tvec": rel_p[c][1].tolist()} for c, (name, _, _) in enumerate(RIG_CAMERAS)]}]
    return rec, config, truth, rel


def run_rig_world(args, tmp: str) -> dict:
    """Phase 11c: `rig_bundle_adjuster --RigBundleAdjustment.refine_relative_poses
    1` on the rig world, the solve's own numbers read by wrapping
    `ops.rig_ba.solve`."""
    import torch

    from colmap_pcd_tpu_torch.models.camera_rig import read_rig_config
    from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction
    from colmap_pcd_tpu_torch.ops import np_geom, rig_ba, solvers

    t0 = time.perf_counter()
    rec, config, truth, rel = _rig_world(np.random.default_rng(args.seed + 7), args.rig_snapshots, args.rig_points)
    model, out = os.path.join(tmp, "rig_in"), os.path.join(tmp, "rig_out")
    os.makedirs(model)
    os.makedirs(out)
    rec.write(model)
    cfg_path = os.path.join(tmp, "rig.json")
    with open(cfg_path, "w") as f:
        json.dump(config, f)
    build_s = time.perf_counter() - t0
    n_obs = sum(len(p.track) for p in rec.points3D.values())

    # the command's stages, each timed to a device sync by a wrapper put in
    # place for this run: the model's read and write, the adjuster (its host
    # assembly, the solve, the point errors' update)
    from colmap_pcd_tpu_torch.models.rig_adjuster import RigBundleAdjuster

    stages, results = {}, []
    wrapped = [(rig_ba, "solve"), (RigBundleAdjuster, "solve"), (Reconstruction, "read"),
               (Reconstruction, "write"), (Reconstruction, "update_point_errors")]
    originals = [vars(owner)[name] for owner, name in wrapped]

    def timed(label, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stages[label] = stages.get(label, 0.0) + time.perf_counter() - t1
            if label == "rig_ba.solve":
                results.append((out, a[0]))
            return out
        return run

    for (owner, name), raw in zip(wrapped, originals):
        label = f"{'rig_ba' if owner is rig_ba else owner.__name__}.{name}"
        fn = timed(label, getattr(owner, name))
        setattr(owner, name, staticmethod(fn) if isinstance(raw, classmethod) else fn)
    torch.cuda.reset_peak_memory_stats()
    try:
        rc, seconds, launches = _run_cli(["rig_bundle_adjuster", "--input_path", model, "--output_path", out,
                                          "--rig_config_path", cfg_path,
                                          "--RigBundleAdjustment.refine_relative_poses", "1"], _kernel_counters())
    finally:
        for (owner, name), raw in zip(wrapped, originals):
            setattr(owner, name, raw)
    if rc != 0:
        raise RuntimeError(f"rig_bundle_adjuster exited with {rc}")
    (r, problem), = results
    shapes = {k: tuple(v.shape) for k, v in problem._asdict().items()
              if k in ("rig_q", "rel_q", "points", "obs_uv", "pt_obs")}
    res = Reconstruction.read(out)  # with the point errors the adjuster wrote
    # relative poses: every snapshot composes them exactly after the solve
    (rig,) = read_rig_config(cfg_path, res)
    rig.compute_relative_poses(res)
    rel_err = [(float(np.rad2deg(np_geom.angle_between(rig.rel_poses[c + 1][0], rel[c][0]))),
                float(np.linalg.norm(rig.rel_poses[c + 1][1] - rel[c][1]))) for c in range(len(rel))]
    ids = sorted(res.images)
    est = np.stack([res.images[i].projection_center() for i in ids])
    ref = np.stack([np_geom.projection_center(*truth[i]) for i in ids])
    q, t, s = solvers.umeyama(torch.as_tensor(est, dtype=torch.float64), torch.as_tensor(ref, dtype=torch.float64),
                              with_scale=True)
    aligned = float(s) * est @ np_geom.quat_to_rotmat(q.numpy()).T + t.numpy()
    centre_err = np.linalg.norm(aligned - ref, axis=-1)
    return {"snapshots": args.rig_snapshots, "images": len(ids), "points": len(res.points3D), "observations": n_obs,
            "build_s": build_s, "seconds": seconds, "stages": stages, "launches": launches,
            "iterations": r.iterations,
            "host_syncs": r.host_syncs, "initial_cost": float(r.initial_cost), "final_cost": float(r.final_cost),
            "shapes": shapes, "mean_reproj_px": res.mean_reprojection_error(),
            "rel_err_deg_m": rel_err, "centre_err_max_m": float(centre_err.max()),
            "centre_err_rms_m": float(np.sqrt(np.mean(centre_err**2))),
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def _ray_scene(rng, n, qx=0.15, tx=0.4, noise=5e-5, n_outliers=0):
    """tests/test_generalized_pose.py::_make_rig_scene (that file imports
    JAX): a 3-camera rig seen from two poses, ray correspondences in each
    rig frame, x2 = R x1 + t."""
    from colmap_pcd_tpu_torch.ops import np_geom

    offsets = np.asarray([[0.0, 0, 0], [0.25, 0.05, 0], [-0.2, 0.1, 0.05]])
    q_gt = np.asarray([np.cos(qx / 2), np.sin(qx / 2), 0.0, 0.0])
    R_gt, t_gt = np_geom.quat_to_rotmat(q_gt), np.asarray([tx, 0.1, -0.2])
    X = rng.uniform(-8, 8, size=(n, 3)) + np.asarray([0, 0, 12.0])
    c1, c2 = offsets[np.arange(n) % 3], offsets[(np.arange(n) + 1) % 3]
    f1, f2 = X - c1, X @ R_gt.T + t_gt - c2
    f1 /= np.linalg.norm(f1, axis=-1, keepdims=True)
    f2 /= np.linalg.norm(f2, axis=-1, keepdims=True)
    f1 += rng.normal(scale=noise, size=f1.shape)
    f2 += rng.normal(scale=noise, size=f2.shape)
    f1 /= np.linalg.norm(f1, axis=-1, keepdims=True)
    f2 /= np.linalg.norm(f2, axis=-1, keepdims=True)
    for _ in range(n_outliers):
        j = rng.integers(0, n)
        f2[j] = rng.normal(size=3)
        f2[j] /= np.linalg.norm(f2[j])
    return [x.astype(np.float32) for x in (f1, c1, f2, c2)], q_gt, t_gt


def _gr6p_bank(seed: int, n: int = 2000, hypotheses: int = 256) -> dict:
    """Phase 11d: ransac_generalized_relative_pose on the card at n rays with
    20% outliers and H hypotheses (test_gr6p_ransac_with_outliers's options
    otherwise)."""
    import torch

    from colmap_pcd_tpu_torch import device as device_mod
    from colmap_pcd_tpu_torch.ops import np_geom, ransac

    rng = np.random.default_rng(seed)
    rays, q_gt, t_gt = _ray_scene(rng, n, n_outliers=n // 5)
    dev = device_mod.resolve("cuda")
    f1, c1, f2, c2 = (torch.as_tensor(x, device=dev) for x in rays)
    gen = torch.Generator(device=dev).manual_seed(seed)
    opts = ransac.RansacOptions(max_error=2e-3, num_hypotheses=hypotheses)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ransac.ransac_generalized_relative_pose(f1, c1, f2, c2, torch.ones(n, device=dev), gen, opts)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    q = res.q.cpu().numpy().astype(np.float64)
    return {"rays": n, "hypotheses": hypotheses, "seconds": seconds,
            "rot_err_rad": float(np_geom.angle_between(q, q_gt)),
            "t_err_m": float(np.linalg.norm(res.t.cpu().numpy() - t_gt)),
            "inlier_share": int(res.num_inliers) / n}


def run_retrieval_and_rigs(args, world: dict, tmp: str) -> dict:
    """Phase 11: retrieval on the pixel world's database, vote-and-verify
    and build_index at the reference feature cap, rig BA on the rig world,
    and the GR6P bank."""
    out = {"retrieval": run_retrieval(world, tmp)}
    out["reference_scale"] = _vv_reference_scale(np.random.default_rng(args.seed + 8))
    out["rig"] = run_rig_world(args, tmp)
    out["gr6p"] = _gr6p_bank(args.seed + 9)
    return out


def _require_retrieval_and_rigs(ph: dict, n_images: int):
    """Phase 11's bars (PERF.md section 2)."""
    rt = ph["retrieval"]
    vt = rt["commands"]["vocab_tree_matcher"]
    if vt["consecutive_verified"] != n_images - 1:
        raise AssertionError(f"vocab_tree_matcher verified {vt['consecutive_verified']} of the "
                             f"{n_images - 1} consecutive pairs")
    loop = rt["commands"]["sequential_matcher loop detection"]
    if loop["pairs_tried"] <= rt["sequential_pairs"]:
        raise AssertionError(f"loop detection added no pair: {loop['pairs_tried']} tried, "
                             f"{rt['sequential_pairs']} sequential")
    if not rt["recall_at_10"] >= RETRIEVAL_RECALL:
        raise AssertionError(f"retrieval recall@10 {rt['recall_at_10']} < {RETRIEVAL_RECALL}")
    ag = rt["agreement"]
    if not ag["vlad_err"] <= VLAD_ATOL or ag["top10_differ"] != ag["top10_near_ties"] \
            or ag["vv_differ"] or ag["vv_rerun_differ"]:
        raise AssertionError(f"retrieval on the card against the CPU: {ag}")
    rs = ph["reference_scale"]
    if rs["cpu_differ"] or rs["rerun_differ"]:
        raise AssertionError(f"vote-and-verify at the reference cap: {rs['cpu_differ']} scores differ from the "
                             f"CPU's, {rs['rerun_differ']} from a second run on the card")
    rig = ph["rig"]
    if not rig["mean_reproj_px"] < RIG_REPROJ_PX or not rig["centre_err_max_m"] < RIG_CENTRE_M \
            or any(not (deg < RIG_REL_DEG and m < RIG_REL_M) for deg, m in rig["rel_err_deg_m"]):
        raise AssertionError(f"rig world: reprojection {rig['mean_reproj_px']} px, relative poses "
                             f"{rig['rel_err_deg_m']} (deg, m), centres {rig['centre_err_max_m']} m")
    if not ph["gr6p"]["rot_err_rad"] < GR6P_ROT_RAD:
        raise AssertionError(f"GR6P bank: {ph['gr6p']}")


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
    # 50, not 100: the whole run must stay near half its 1200 s limit now
    # that phase 10 runs too (PERF.md section 4)
    ap.add_argument("--descriptor-images", type=int, default=50)
    ap.add_argument("--overlap-images", type=int, default=30)
    ap.add_argument("--classic-images", type=int, default=20)
    ap.add_argument("--rig-snapshots", type=int, default=100, help="depth of the rig world")
    ap.add_argument("--rig-points", type=int, default=20000)
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

        # 10. the SfM tools on the pixel world's model and database
        os.makedirs(os.path.join(tmp, "tools"))
        st = run_sfm_tools(args, world, px, os.path.join(tmp, "tools"))
        cmds = st["commands"]
        _log(f"[sfm tools] bundle_adjuster with the lidar map: registered {st['ba_registered'][0]} -> "
             f"{st['ba_registered'][1]}, ATE {st['ba_ate_m'][0] * 1e3:.3f} -> {st['ba_ate_m'][1] * 1e3:.3f} mm, "
             f"mean reprojection error {st['ba_reproj_px'][0]:.4f} -> {st['ba_reproj_px'][1]:.4f} px, "
             f"{cmds['bundle_adjuster']['seconds']:.3f} s, K2 launches "
             f"{cmds['bundle_adjuster']['launches']['nn_argmin']} at Q={st['ba_queries']}")
        _log(f"[sfm tools] image_deleter + image_registrator: {st['registered_back'][0]} of "
             f"{st['registered_back'][1]} images registered back; point_triangulator: points "
             f"{st['triangulated_points'][0]} -> {st['triangulated_points'][1]}")
        _log(f"[sfm tools] model_aligner: median error {st['aligner_median_m'][0] * 1e3:.3f} mm onto the model's "
             f"own centres under a known similarity, {st['aligner_median_m'][1] * 1e3:.3f} mm onto the "
             f"ground-truth centres ({st['aligner_moved']} references moved 1 m, excluded)")
        _log(f"[sfm tools] image_undistorter: {st['undistorted'][0]} images, max difference to the input "
             f"{st['undistorted'][1]} grey levels; spatial_matcher: {st['spatial_pairs_verified']} pairs "
             f"verified, {cmds['spatial_matcher']['launches']['match_top2_u8']} uint8 K1 launches")
        _log(f"[sfm tools] hierarchical_mapper (leaves of 50, 10 shared): registered "
             f"{st['hierarchical'][0]}/{args.n_images}, ATE {st['hierarchical'][1] * 1e3:.3f} mm beside the "
             f"flat mapper's {px['ate_m'] * 1e3:.3f} mm, {cmds['hierarchical_mapper']['seconds']:.3f} s, "
             f"K2 launches {cmds['hierarchical_mapper']['launches']['nn_argmin']}; {len(st['hierarchical_leaves'])} "
             f"leaves of {st['hierarchical_leaves'][0]}-{st['hierarchical_leaves'][-1]} images")
        pcg = st["pcg"]
        _log(f"[sfm tools] PCG tier, corridor of {pcg['cameras']} cameras, {pcg['points']} points, "
             f"{pcg['observations']} observations: {pcg['seconds']:.3f} s, {pcg['iterations']} LM iterations, "
             f"{pcg['cg_syncs']} CG host syncs ({pcg['cg_syncs'] / max(pcg['iterations'], 1):.2f} per LM step), "
             f"cost {pcg['initial_cost']:.6g} -> {pcg['final_cost']:.6g}, max |t - truth| "
             f"{pcg['max_t_err_m']:.4f} m, peak device memory {pcg['peak_mem_bytes'] / 2**20:.1f} MiB")

        # 11. retrieval and camera rigs
        os.makedirs(os.path.join(tmp, "retrieval"))
        ph = run_retrieval_and_rigs(args, world, os.path.join(tmp, "retrieval"))
        rt = ph["retrieval"]
        rc_ = rt["commands"]
        _log(f"[retrieval] vocab_tree_builder: {rc_['vocab_tree_builder']['seconds']:.3f} s, "
             f"{rt['vocab_words'][0]} words x {rt['vocab_words'][1]}; vocab_tree_retriever --num_images 10: "
             f"{rc_['vocab_tree_retriever']['seconds']:.3f} s, {rt['retriever_lines']} rankings, recall@10 of "
             f"the views at most 2 steps away {rt['recall_at_10']:.4f}")
        for label in ("vocab_tree_matcher", "sequential_matcher loop detection"):
            c = rc_[label]
            _log(f"[retrieval] {label}: {c['seconds']:.3f} s (cli.main), {c['pairs_tried']} pairs tried, "
                 f"{c['pairs_verified']} verified, {c['consecutive_verified']} of {args.n_images - 1} "
                 f"consecutive pairs verified, K1 launches {c['launches']['match_top2_u8']} (uint8)")
        _log(f"[retrieval] the sequential pairs alone: {rt['sequential_pairs']}; loop pairs tried "
             f"{rc_['sequential_matcher loop detection']['pairs_tried'] - rt['sequential_pairs']}")
        ag = rt["agreement"]
        _log(f"[retrieval] card against CPU, {ag['images']} images: VLADs within {ag['vlad_err']:.3g}, "
             f"centroids within {ag['centroid_err']:.3g}; top-10 lists differing {ag['top10_differ']} (of them "
             f"at near-ties {ag['top10_near_ties']}); vote-and-verify scores differing {ag['vv_differ']} of "
             f"{ag['vv_checked']} (card twice: {ag['vv_rerun_differ']}); build_index on the card "
             f"{ag['build_index_s']:.3f} s")
        rs = ph["reference_scale"]
        _log(f"[retrieval] reference cap {rs['cap']}: vote_and_verify_batch of one query against C={rs['C']} "
             f"{rs['vv_ms']:.3f} ms (CUDA events, mean of 3), peak {rs['vv_peak_bytes'] / 2**20:.1f} MiB above "
             f"the inputs, scores {rs['scores']} ({rs['cpu_differ']} differ from the CPU's, {rs['rerun_differ']} from "
             f"a second run); build_index of {rs['images']} images "
             f"{rs['build_ms']:.3f} ms, peak {rs['build_peak_bytes'] / 2**20:.1f} MiB")
        rg = ph["rig"]
        _log(f"[rig] {rg['snapshots']} snapshots x 4 cameras = {rg['images']} images, {rg['points']} points, "
             f"{rg['observations']} observations (built and written in {rg['build_s']:.3f} s); problem "
             f"{rg['shapes']}")
        _log(f"[rig] rig_bundle_adjuster --RigBundleAdjustment.refine_relative_poses 1: {rg['seconds']:.3f} s "
             f"(cli.main), {rg['iterations']} LM iterations, {rg['host_syncs']} host syncs, cost "
             f"{rg['initial_cost']:.6g} -> {rg['final_cost']:.6g}, mean reprojection error "
             f"{rg['mean_reproj_px']:.4f} px, relative poses against the truth (deg, m) "
             f"{[(round(d, 5), round(m, 6)) for d, m in rg['rel_err_deg_m']]}, image centres after sim(3) "
             f"max {rg['centre_err_max_m'] * 1e3:.3f} mm rms {rg['centre_err_rms_m'] * 1e3:.3f} mm, peak "
             f"{rg['peak_mem_bytes'] / 2**20:.1f} MiB")
        _log("[rig] stages of the command (s, each ended by a device sync): "
             + ", ".join(f"{k} {v:.3f}" for k, v in rg["stages"].items()))
        g6 = ph["gr6p"]
        _log(f"[gr6p] ransac_generalized_relative_pose, {g6['rays']} rays, 20% outliers, H={g6['hypotheses']}: "
             f"{g6['seconds']:.3f} s, rotation error {g6['rot_err_rad']:.3g} rad, translation error "
             f"{g6['t_err_m']:.3g} m, inlier share {g6['inlier_share']:.4f}")

    # 12. checks
    u8_launches = {"pixel world": px["matcher_launches"]["match_top2_u8"],
                   "overlapped": ov["launches"]["match_top2_u8"],
                   "descriptor world": res["matcher_launches"]["match_top2_u8"],
                   "classic world": cl["matcher_launches"]["match_top2_u8"]}
    k2_launches = {"pixel world": px["mapper_launches"]["nn_argmin"],
                   "overlapped": ov["launches"]["nn_argmin"],
                   "descriptor world": res["mapper_launches"]["nn_argmin"],
                   "bundle_adjuster": cmds["bundle_adjuster"]["launches"]["nn_argmin"],
                   "hierarchical_mapper": cmds["hierarchical_mapper"]["launches"]["nn_argmin"]}
    u8_launches["spatial_matcher"] = cmds["spatial_matcher"]["launches"]["match_top2_u8"]
    for label in ("vocab_tree_matcher", "sequential_matcher loop detection"):
        u8_launches[label] = ph["retrieval"]["commands"][label]["launches"]["match_top2_u8"]
    for path, n in u8_launches.items():
        if n <= 0:
            raise AssertionError(f"the {path} run never launched the uint8 K1")
    for path, n in k2_launches.items():
        if n <= 0:
            raise AssertionError(f"the {path} run never launched K2")
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
    _require_sfm_tools(st, px, args.n_images)
    _require_retrieval_and_rigs(ph, args.n_images)

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
    k2["shapes"][f"Q={st['ba_queries']} N={world['map_points'].shape[0]} (bundle_adjuster)"] = st["k2_ba_shape"]
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
