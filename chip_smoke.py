#!/usr/bin/env python3
"""Smoke run of the PyTorch port (colmap_pcd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--n-images 100] [--descriptor-images 30]
                          [--overlap-images 30] [--ref-images 100]
                          [--classic-images 20] [--rig-snapshots 50]
                          [--rig-points 20000] [--dense-views N] [--seed 0]
                          [--kernels-only | --long-images N]

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
     descriptor world's chunk (B = 16 at cap 4096, ragged 1 900-2 200), the
     reference-scale world's chunk (B = 16 at cap 1024, ragged 740-850), a
     chunk at the feature cap (B = 16 at cap 8192, ragged 6 000-8 192), one
     pair at 8192 x 8192, a ragged 1000 x 1537 pair
     and a pair with duplicated descriptors. The float kernel runs rows
     alone (`match_top2`) and fused with the cross-check
     (`match_top2_cross`): the fused launch must give the same rows bit for
     bit and each column's best valid row as the plain argmax away from
     near-ties, and a cross-checked `match_descriptors` must take one
     launch. The uint8 cases are the float
     ones quantized as the world generator quantizes descriptors; the uint8
     kernel must agree with its plain version exactly (similarity error 0,
     no index or accept mismatch), and its launch on the transpose must form
     bit-identical similarities. Times as in 3., the float (rows) and the
     uint8 kernel in turns (float, uint8, uint8, float); the library calls
     are one f32 (TF32 off) and one bf16 `torch.matmul` of the chunk (the
     product alone);
  5. SIFT on the card: one batch of 8 rendered 640x480 images extracted on
     CUDA and on the CPU (keypoint sets and descriptors must agree within
     the tolerances of tests/test_torch_sift.py), the CUDA batch extracted
     twice (identical bytes), TF32 off (asserted); ms per batch, kernels
     launched per batch, peak memory; one batch of 4 images at 1280x960
     with 8192 features and 4 octaves for its time and peak memory, its
     first image also extracted on the CPU and held to the card's by the
     same tolerances. The reference-scale world renders on the host from
     here on, beside phases 5-7;
  6. the pixel world, the main path from pixels: the 100 rendered images
     through `cli.main feature_extractor` (PINHOLE with the known
     intrinsics), the sequential matcher at overlap 5 without the quadratic
     offsets (match_top2_u8) and `cli.main mapper` on the lidar map (K2)
     with the pose prior of image 1, each with the launch counts zeroed just
     before it, writing a snapshot every 25 registrations; the model is
     read back and its ATE printed;
 6b. resume: `cli.main mapper --input_path` from the snapshot nearest half
     of the views (by its registered count read back), with phase 6's
     database, map, pose prior and flags, to the end (K2): snapshot and
     resumed counts, ATE beside phase 6's, scale error, seconds, K2
     launches and largest query count, peak memory; then
     depth_project_batch over 8 of the resumed model's views, each over the
     map points in its frustum, on the card against the CPU;
  7. the overlapped front end: the first 30 of those images
     (`--overlap-images`) through bench_torch.run_bench, bench.py's default
     branch, with the known PINHOLE reader: `run_overlapped_frontend`
     (extraction and matching threads) feeding
     `IncrementalMapperController(pair_feed=...)` on the caller's thread,
     the corridor map built inside the timed window as bench.py builds it;
 7b. the reference feature scale, as the JAX package's bench.py runs it
     with BENCH_REF_SCALE=1 (its default, overlapped branch), through
     bench_torch.run_bench: the pixel world's trajectory over 100 views
     (`--ref-images`) rendered at 1280x960, f = 1000, through
     `run_overlapped_frontend` with 8192 features, first octave 0, 4
     octaves, max image size 1280 (the reader's defaults, as bench.py gives
     none), the sequential pairs at overlap 5 without the quadratic offsets
     and min_num_inliers 15, feeding `IncrementalMapperController` whose
     model holds the PINHOLE camera [1000, 1000, 640, 480], with bench.py's
     MapperOptions and the pose prior of image 1, the launch counts zeroed
     just before it: keypoints per image, pairs matched and verified,
     launches, the largest K1 cap and K2 query count, the threads' and the
     mapper's seconds, frames registered per second (and bench.py's
     second-half rate), registered count, ATE beside the JAX package's
     11.8 mm, scale error, peak memory, BA solves and LM host syncs per
     solve, the PHASES report; then K2 timed at the run's largest query
     count (the model's points against the map) beside its plain version,
     the library call and the host kd-tree;
 7c. bench.py's sequential branch (BENCH_OVERLAP=0) through
     bench_torch.run_bench on phase 7's 30 views with the reader's
     defaults: `run_feature_extractor`, `run_sequential_matcher` at overlap
     5 without the quadratic offsets, the pairs with >= 15 inlier matches
     into the graph, the lidar controller; then its result line built by
     bench_torch.bench_line and printed;
  8. the descriptor world: a synthetic corridor world (30 images, 0.8 m
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
     feature cap of 8192 (CUDA events, peak memory); the rig world (a
     4-camera rig, 0.3 m lever arms, over 50 snapshots of the pixel world's
     trajectory, `--rig-snapshots`; 20 000 wall points, 0.5 px
     noise; rig poses perturbed by 2 cm / 0.5 deg, relative poses by 1 cm /
     0.3 deg) through rig_bundle_adjuster with refined relative poses; and
     ransac_generalized_relative_pose (GR6P) at 2 000 rays with 20%
     outliers and H = 256;
 12. dense reconstruction on phase 10's undistorted workspace (100 PINHOLE
     640x480 views and their model, in the lidar map's frame as
     LidarMap.load holds it: the model's sparse points are measured against
     the map first), each command through cli.main with the launch counts
     zeroed just before it: patch_match_stereo at the defaults (64 depths,
     4 sources, r = 3, bilateral, the geometric pass; seconds, views, peak
     memory, seconds per view-pass, host fetches per view), stereo_fusion,
     poisson_mesher at depth 7, delaunay_mesher in dense mode on the
     workspace and in sparse mode on the model, and automatic_reconstructor
     --dense 1 on the first 10 views with the lidar mapper's flags; then one
     view's plane_sweep with both passes on the card and on the CPU on the
     same inputs, and twice on the card (CUDA-event times, kernels per pass,
     peak memory); the splat and spectral solve and the whole Poisson mesh
     twice on the card; the point-to-plane distance to the lidar map of
     every fused point and every mesh vertex (K2 through
     LidarMap.nn_query), K2 timed at the fused cloud's query count beside
     the host kd-tree. `--dense-views` keeps the first N registered views;
 13. the sharded paths (colmap_pcd_tpu_torch/parallel) over a mesh of
     every visible card, or of cuda:0 repeated twice on one card: phase 6's
     database cut to its first 30 views, map and flags through
     IncrementalMapperController with `mapper.dist_mesh` set (every BA solve
     distributed; seconds, ba_device and its ba_shard part, K2 launches,
     reductions per solve, bytes reduced per LM iteration) and without it;
     MatchPool over the 100 views' descriptors as floats (cap 1024) and
     the 485 overlap-5 pairs, sharded and unsharded on cuda:0 (float K1
     launches, seconds); run_patch_match_stereo with `mesh=` and
     sequentially on copies of phase 12's workspace cut to its first 10
     views; dryrun_multichip over the mesh's size;
 14. checks: match_top2_u8 launched by every matcher run (spatial_matcher,
     vocab_tree_matcher and the loop-detecting sequential matcher
     included), match_top2 by the guided matcher and the sharded
     MatchPool, K2 by every lidar mapper run (the sharded one included),
     bundle_adjuster, hierarchical_mapper and the resumed mapper; the pixel
     world holds 100 images of 300-2 048 keypoints and its model >= 95%
     registered with ATE < 0.10 m and scale error < 2%, and so does the
     resumed model (with more images than its snapshot; depth_project_batch
     on the card finding the CPU's features, depths within 1e-5 m), and the
     overlapped run (with no error in its feed), the sequential run (its
     line holding bench.py's keys, read from bench.py's source, but `mfu`
     and `model_tflops`, at the same bars), the reference-scale run
     (no error in its feed; the uint8 K1 launched at the chunk cap that
     its largest keypoint count gives, K2 launched by its mapper, its SIFT
     on the card agreeing with the CPU's in phase 5) and the descriptor
     world (match precision >= 0.95); classic mapper >= 19/20 registered with
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
     is < 1e-3 rad; the dense stage (DENSE_SAME_DEPTH and the constants
     beside it): maps for every registered view with a source, the card's
     sweep equal to the CPU's, two card runs of the sweep, the splat and the
     mesh byte-identical, a non-empty fused cloud and Poisson mesh within
     their point-to-plane bars, faces in both Delaunay meshes and in the
     one-click pipeline's mesh; the sharded mapper and the unsharded one on
     the same 30 views >= 95% registered at ATE < 0.10 m and scale error
     < 2%, their ATEs within 0.02 m of each other, the
     sharded MatchPool's (idx, ok) identical to the unsharded pool's, the
     sharded stereo's depth identical to the sequential run's on every
     view.

`--kernels-only` stops after phase 4 (on a corridor map built like the
pixel world's) and prints no result line: a short first look at a changed
kernel. `--long-images N` runs phases 1-2 and phase 6 at N views (450 is
the JAX package's BENCH_450_r5.json length, 16.8 mm there), prints the
mapper's numbers beside that ATE and holds them to phase 6's bars, and
prints no result line either.

Any failure raises (non-zero exit, no result line). The last lines are the
kernels' JSON record, the nvidia-smi line, and
{"ok": true, "device": {...}}. Without CUDA it exits non-zero at once.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

from bench_torch import (DROPPED_KEYS, LIGHT_SCALE, REF_SCALE, STEP, bench_line, bench_py_line_keys, counted,
                         kernel_counters, mapper_numbers, nvidia_smi, render_world, reset_phases, run_bench)

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

# the dense stage's bars (phase 12): the card's sweep of one view against
# the CPU's on the same inputs, identical depth at DENSE_SAME_DEPTH of the
# pixels and the cost within DENSE_COST_ATOL where it is; two card runs of the
# sweep, the splat and the mesh byte-identical; the median point-to-plane
# distance to the lidar map of the fused points and of the Poisson mesh's
# vertices under a CPU rehearsal's value x 1.25. The rehearsal (phase 12 on
# a 14-view pixel world): 21.757 and 325.843 mm. Fusion checks every view
# against the first four, whose depth ranges end ~46 m down the corridor, so
# the fused cloud spans about the same length at 14 views and at 100
DENSE_SAME_DEPTH, DENSE_COST_ATOL = 0.995, 1e-4
FUSED_P2P_M, MESH_P2P_M = 0.021757 * 1.25, 0.325843 * 1.25

# the pixel world (the JAX package's bench at its light scale) and the
# accuracy that package recorded on it (BENCH_r05.json)
PIXEL_W, PIXEL_H, PIXEL_F, PIXEL_FEATURES, PIXEL_OCTAVES = LIGHT_SCALE
PIXEL_STEP = STEP
REF_W, REF_H, REF_F, REF_FEATURES, REF_OCTAVES = REF_SCALE
REFERENCE_ATE_MM = 18.0
# the JAX package's accuracy at the reference feature scale
# (BENCH_REFSCALE_r5.json) and on 450 views (BENCH_450_r5.json)
REFERENCE_REF_SCALE_ATE_MM, REFERENCE_450_ATE_MM = 11.8, 16.8
# bench_torch.BENCH_MAPPER_OPTIONS as the mapper command's flags
PIXEL_MAPPER_FLAGS = (
    "--Mapper.init_min_num_inliers", "40", "--Mapper.abs_pose_min_num_inliers", "12",
    "--Mapper.abs_pose_min_inlier_ratio", "0.15", "--Mapper.filter_max_reproj_error", "6.0",
)

# phase 6's mapper writes a snapshot every SNAPSHOT_FREQ registrations; the
# resume phase starts from the one nearest half of the views. Its check of
# depth_project_batch holds the card's depths to the CPU's within DEPTH_ATOL_M
SNAPSHOT_FREQ = 25
DEPTH_ATOL_M = 1e-5

# phase 13's sharded mapper runs on the pixel world's first 30 views,
# beside an unsharded run of the same views
SHARDED_VIEWS = 30

# published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# device memory bytes/s, f32 FLOP/s outside the tensor cores, int8 tensor
# core OP/s. A bound is the larger of bytes / HBM and operations / peak.
# TF32X3_FLOPS, a third of the TF32 tensor-core peak, is the rate of
# 3xTF32 products, which the float K1 does not use (too coarse for its
# SIM_ATOL, scripts/torch_k1_numerics.py): its share is printed beside.
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
INT8_OPS = 1979e12
TF32X3_FLOPS = 495e12 / 3


def _log(msg: str):
    print(msg, flush=True)


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
    """The float kernel, rows alone and fused with the cross-check, against
    the plain versions."""
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
    # the fused launch: the same rows bit for bit, and the best valid row of
    # every column equal to the plain argmax away from columns whose best
    # and second-best valid rows lie within SIM_ATOL
    c1, c2, cidx, back = match_kernel.match_top2_cross(d1, d2, v1, v2)
    *_, rback = match_kernel.match_top2_cross_reference(d1, d2, v1, v2)
    if not (torch.equal(c1, s1) and torch.equal(c2, s2) and torch.equal(cidx, idx)):
        raise AssertionError(f"the fused K1 forms other rows than the rows-only launch ({label})")
    bt1, bt2, _ = match_kernel.match_top2_reference(d2, d1, v1)
    col_sep = (bt1 - bt2) > SIM_ATOL
    back_mism = int(((back != rback) & col_sep).sum())
    if back_mism:
        raise AssertionError(f"the fused K1's column bests differ in {back_mism} columns away from near-ties ({label})")
    # the full accept decision of match_descriptors: one launch
    before = match_kernel.match_top2.launches
    ik, ok_k, _ = matching.match_descriptors(d1, d2, v1, v2, opts)
    if match_kernel.match_top2.launches != before + 1:
        raise AssertionError(f"a cross-checked match_descriptors took "
                             f"{match_kernel.match_top2.launches - before} launches ({label})")
    ir, ok_r, _ = matching.match_descriptors_reference(d1, d2, v1, v2, opts)
    dist1 = torch.arccos(r1.clamp(-1, 1))
    dist2 = torch.arccos(r2.clamp(-1, 1))
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
        f"{idx_mism}, near-tie rows {int((~sep).sum())}; fused: rows identical, column-best "
        f"mismatches away from near-ties {back_mism} (near-tie columns {int((~col_sep).sum())}); "
        f"accepted {int(ok_k.sum())} vs plain {int(ok_r.sum())}, accept mismatches outside 1e-6 "
        f"of a threshold {ok_mism}"
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
        # the reference-scale world's chunk (its views hold ~740-850
        # keypoints) and a chunk at the 8192 cap nearly full
        ("reference-scale chunk B=16 cap 1024", dict(B=16, N1=1024, N2=1024, n_lo=740, n_hi=850), 20, 3),
        ("chunk B=16 cap 8192", dict(B=16, N1=8192, N2=8192, n_lo=6000, n_hi=8192), 5, 1),
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

        def run_cross():
            return match_kernel.match_top2_cross(d1, d2, v1, v2)

        def run_u8():
            return match_kernel.match_top2_u8(u1, u2, inv1, inv2, v2, v1)

        f32_ms, u8_ms, turns = _turns_ms(run_f32, run_u8, reps)
        cross_ms = _cuda_ms(run_cross, reps)
        f32_dev, cross_dev, u8_dev = (_graph_ms(fn, reps) for fn in (run_f32, run_cross, run_u8))
        f32_plain = _cuda_ms(lambda: match_kernel.match_top2_reference(d1, d2, v2), plain_reps)
        cross_plain = _cuda_ms(lambda: match_kernel.match_top2_cross_reference(d1, d2, v1, v2), plain_reps)
        u8_plain = _cuda_ms(
            lambda: match_kernel.match_top2_u8_reference(u1, u2, inv1, inv2, v2, v1), plain_reps
        )
        # the libraries' product of the chunk alone: f32 (TF32 off, the
        # kernel's precision) and bf16
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on: the f32 library yardstick would not be f32")
        library_f32 = _cuda_ms(lambda: torch.matmul(d1, d2.mT), reps)
        b1, b2 = d1.to(torch.bfloat16), d2.to(torch.bfloat16)
        library_ms = _cuda_ms(lambda: torch.matmul(b1, b2.mT), reps)
        del b1, b2
        B, N1, N2 = d1.shape[0], d1.shape[1], d2.shape[1]
        n1, n2 = v1.sum(-1).double(), v2.sum(-1).double()
        # match_top2(d1, d2, valid2) has no row mask: every row against the
        # valid columns, 2 flops per product term; d1, the valid rows of d2
        # and valid2 read once, 3 outputs written
        f32_ops = 2.0 * 128 * N1 * float(n2.sum())
        f32_bound = _bound(4.0 * 128 * (B * N1 + float(n2.sum())) + 4 * B * N2 + 12 * B * N1,
                           f32_ops, F32_FLOPS)
        # the cross-check adds the valid rows against the invalid columns
        # (back covers every column); both inputs, both masks read once, 3
        # row outputs and the column output written
        cross_ops = f32_ops + 2.0 * 128 * float((n1 * (N2 - n2)).sum())
        cross_bound = _bound(4.0 * 128 * B * (N1 + N2) + 4 * B * (N1 + N2) + 12 * B * N1 + 4 * B * N2,
                             cross_ops, F32_FLOPS)
        # with valid1 the uint8 kernel owes only the valid rows as well
        u8_bound = _bound(float((n1 + n2).sum()) * (128 + 4) + 4.0 * B * (N1 + N2) + 12 * B * N1,
                          2.0 * 128 * float((n1 * n2).sum()), INT8_OPS)
        tops = 2.0 * 128 * float((n1 * n2).sum()) / (u8_dev * 1e-3) / 1e12
        _log(
            f"[k1] {label}: float kernel, rows: {f32_ms:.4f} ms per call, {f32_dev:.4f} ms on the "
            f"device (CUDA graph), bound {f32_bound[0]:.4f} ms ({f32_bound[1]}), "
            f"{100 * f32_bound[0] / f32_dev:.1f}% reached, plain {f32_plain:.4f} ms; fused with the "
            f"cross-check: {cross_ms:.4f} ms per call, {cross_dev:.4f} ms on the device, bound "
            f"{cross_bound[0]:.4f} ms ({cross_bound[1]}), {100 * cross_bound[0] / cross_dev:.1f}% "
            f"reached ({100 * cross_ops / TF32X3_FLOPS * 1e3 / cross_dev:.1f}% of the 3xTF32 rate), "
            f"{cross_ops / (cross_dev * 1e-3) / 1e12:.1f} TFLOP/s, plain {cross_plain:.4f} ms; one f32 "
            f"matmul of the chunk (TF32 off) {library_f32:.4f} ms, one bf16 matmul {library_ms:.4f} "
            f"ms; uint8 kernel {u8_ms:.4f} ms per call, {u8_dev:.4f} ms on the device, bound "
            f"{u8_bound[0]:.4f} ms ({u8_bound[1]}), {100 * u8_bound[0] / u8_dev:.1f}% reached, "
            f"{tops:.1f} TOP/s on the valid rows and columns, plain {u8_plain:.4f} ms; turns "
            f"float/uint8/uint8/float {' '.join(f'{t:.4f}' for t in turns)}"
        )
        f32["shapes"][label] = dict(
            ms=cross_ms, device_ms=cross_dev, plain_ms=cross_plain, library_ms=library_f32,
            library_bf16_ms=library_ms, bound_ms=cross_bound[0], bound_by=cross_bound[1],
            rows_ms=f32_ms, rows_device_ms=f32_dev, rows_plain_ms=f32_plain, rows_bound_ms=f32_bound[0])
        u8["shapes"][label] = dict(ms=u8_ms, device_ms=u8_dev, plain_ms=u8_plain, library_ms=library_ms,
                                   bound_ms=u8_bound[0], bound_by=u8_bound[1], float_kernel_ms=f32_ms)
    f32.update(f32["shapes"]["matcher chunk B=16 cap 2048"])
    u8.update(u8["shapes"]["pixel-world chunk B=16 cap 1024"])  # the main path's shape
    return {"match_top2": f32, "match_top2_u8": u8}


def _run_cli(argv: list, counters: dict) -> tuple[int, float, dict]:
    """cli.main(argv) under `counted`."""
    from colmap_pcd_tpu_torch import cli

    return counted(lambda: cli.main(argv), counters)


def _read_model(out_dir: str, gt) -> dict:
    """The largest model under out_dir against the ground truth."""
    from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction
    from synthetic_torch import ate_rmse, scale_error

    recs = [Reconstruction.read(os.path.join(out_dir, d)) for d in sorted(os.listdir(out_dir))]
    out = max(recs, key=lambda r: r.num_reg_images)
    return {"models": len(recs), "registered": out.num_reg_images, "ate_m": ate_rmse(out, gt),
            "scale_err": scale_error(out, gt)}


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
    ref_peak = torch.cuda.max_memory_allocated()
    # the batch's first image on the CPU, held to the card's by the same bars
    t0 = time.perf_counter()
    ref_cpu = [a[0].numpy() for a in sift.extract_batch(ref_d[:1].cpu(), ref_opts)]
    ref_cpu_s = time.perf_counter() - t0
    ref_agree = _sift_agreement([a[0].cpu().numpy() for a in ref_out], ref_cpu)
    if ref_agree["partner_share"] < SIFT_PARTNER_SHARE or ref_agree["good_share"] < SIFT_GOOD_SHARE:
        raise AssertionError(f"SIFT at the reference scale on the card and on the CPU disagree: {ref_agree}")
    return {
        "valid": n_valid, "worst": worst, "cpu_seconds": cpu_s, "ms_per_batch": ms,
        "kernels_per_batch": kernels, "peak_mem_bytes": peak,
        "ref_valid": ref_valid, "ref_ms": start.elapsed_time(end), "ref_peak_mem_bytes": ref_peak,
        "ref_agree": ref_agree, "ref_cpu_seconds": ref_cpu_s,
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

    kernels = kernel_counters()
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
    reset_phases()
    n_verified, m_seconds, m_launches = counted(
        lambda: run_sequential_matcher(paths["database"], SiftMatchingConfig(min_num_inliers=15),
                                       overlap=5, quadratic_overlap=False), kernels)
    db = Database(paths["database"])
    n_tried = len(db.all_two_view_pair_ids())
    db.close()

    reset_phases()
    torch.cuda.reset_peak_memory_stats()
    out_dir = os.path.join(tmp, "pixel_model")
    # the snapshots the resume phase starts from (a model every 25 registrations)
    snapshots = os.path.join(tmp, "pixel_snapshots")
    rc, seconds, launches = _run_cli(mapper_argv(
        paths, out_dir, *PIXEL_MAPPER_FLAGS, "--Mapper.snapshot_path", snapshots,
        "--Mapper.snapshot_images_freq", str(SNAPSHOT_FREQ)), kernels)
    if rc != 0:
        raise RuntimeError(f"mapper (pixel world) exited with {rc}")
    res = _read_model(out_dir, world["gt"])
    res.update(mapper_numbers(seconds, res["registered"]))
    res.update(keypoints=keypoints, cameras=cameras, extract_seconds=e_seconds,
               matcher_seconds=m_seconds, matcher_launches=m_launches, pairs_verified=n_verified,
               pairs_tried=n_tried, mapper_launches=launches, model_root=out_dir, snapshot_root=snapshots)
    return res


def _depth_project_batch_check(model: str, world: dict, n_views: int = 8) -> dict:
    """depth_project_batch over n_views registered views of `model`, each
    over the map points in its frustum (to choose_meter), on the card and
    on the CPU: `found` must be equal and the chosen points' distances to
    the camera centre (the depth the z-buffer keeps) within DEPTH_ATOL_M."""
    import torch

    from colmap_pcd_tpu_torch import device
    from colmap_pcd_tpu_torch.models.lidar_map import LidarMap
    from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction
    from colmap_pcd_tpu_torch.ops import pointcloud as pc
    from colmap_pcd_tpu_torch.ops import se3

    rec = Reconstruction.read(model)
    ids = sorted(rec.registered_ids)
    ids = [ids[k] for k in np.linspace(0, len(ids) - 1, n_views).round().astype(int)]
    cam = rec.cameras[rec.images[ids[0]].camera_id]
    opts = pc.ProjOptions()
    # the map in the frame the mapper holds it in (LidarMap.load converts it)
    lmap = LidarMap.load(world["paths"]["lidar"], opts, device="cpu")
    pts, nrm = torch.as_tensor(lmap.points), torch.as_tensor(lmap.normals)
    q = torch.as_tensor(np.stack([rec.images[i].qvec for i in ids]), dtype=torch.float32)
    t = torch.as_tensor(np.stack([rec.images[i].tvec for i in ids]), dtype=torch.float32)
    fx, fy, cx, cy = (float(v) for v in cam.params[:4])
    sets = [torch.nonzero(pc.points_in_frustum(pc.frustum_planes(
        q[b], t[b], fx, fy, cx, cy, cam.width, cam.height, opts.choose_meter), pts))[:, 0]
        for b in range(n_views)]
    F, M = max(len(rec.images[i].xys) for i in ids), max(len(s) for s in sets)
    xy, fv = torch.zeros(n_views, F, 2), torch.zeros(n_views, F)
    cp, cn, cv = torch.zeros(n_views, M, 3), torch.zeros(n_views, M, 3), torch.zeros(n_views, M)
    for b, (i, sel) in enumerate(zip(ids, sets)):
        k = len(rec.images[i].xys)
        xy[b, :k], fv[b, :k] = torch.as_tensor(rec.images[i].xys, dtype=torch.float32), 1.0
        cp[b, : len(sel)], cn[b, : len(sel)], cv[b, : len(sel)] = pts[sel], nrm[sel], 1.0
    params = torch.zeros(n_views, 12)
    params[:, : len(cam.params)] = torch.as_tensor(cam.params, dtype=torch.float32)
    args = (xy, fv, cp, cn, cv, q, t, params)
    dev = device.resolve("cuda")
    t0 = time.perf_counter()
    cpu = pc.depth_project_batch(*args, cam.width, cam.height, cam.model_id, opts)
    cpu_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    card_args = [a.to(dev) for a in args]
    start.record()
    card = pc.depth_project_batch(*card_args, cam.width, cam.height, cam.model_id, opts)
    end.record()
    torch.cuda.synchronize()
    card = [a.cpu() for a in card]
    if not torch.equal(card[2], cpu[2]) or int(cpu[2].sum()) == 0:
        raise AssertionError(f"depth_project_batch: the card found {int(card[2].sum())} features, "
                             f"the CPU {int(cpu[2].sum())}, not the same ones")

    def depth(points):  # distance to the camera centre of each view's chosen points
        return torch.linalg.norm(se3.se3_apply(q[:, None], t[:, None], points), dim=-1)

    found = cpu[2]
    err = (depth(card[0]) - depth(cpu[0]))[found].abs().max().item()
    if not err <= DEPTH_ATOL_M:
        raise AssertionError(f"depth_project_batch: depths on the card and the CPU differ by {err} m")
    return {"views": ids, "features": F, "candidates": [len(s) for s in sets], "found": int(found.sum()),
            "points_differ": int((card[0] != cpu[0]).any(-1)[found].sum()), "depth_err_m": err,
            "card_ms": start.elapsed_time(end), "cpu_seconds": cpu_s}


def run_resume(world: dict, px: dict, tmp: str) -> dict:
    """The resume phase: `cli.main mapper --input_path` from the snapshot of
    phase 6's run that holds about half of the views (chosen by the
    registered count read back from each snapshot, not by folder name:
    snapshots written in one second share a name), with phase 6's database,
    map, pose prior and flags, to the end; then depth_project_batch on the
    card against the CPU over 8 of the resumed model's views."""
    import torch

    from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction
    from colmap_pcd_tpu_torch.ops import nn_kernel
    from synthetic_torch import mapper_argv

    root = px["snapshot_root"]
    snaps = {d: Reconstruction.read(os.path.join(root, d)).num_reg_images for d in sorted(os.listdir(root))}
    half = len(world["gt"]) / 2
    start = min(snaps, key=lambda d: (abs(snaps[d] - half), d))
    model = os.path.join(root, start)
    kernels = kernel_counters()
    reset_phases()
    torch.cuda.reset_peak_memory_stats()
    out_dir = os.path.join(tmp, "resumed_model")
    rc, seconds, launches = _run_cli(
        mapper_argv(world["paths"], out_dir, *PIXEL_MAPPER_FLAGS, "--input_path", model), kernels)
    if rc != 0:
        raise RuntimeError(f"mapper --input_path exited with {rc}")
    res = _read_model(out_dir, world["gt"])
    res.update(mapper_numbers(seconds, res["registered"] - snaps[start]))
    res.update(snapshots=sorted(snaps.values()), snapshot_registered=snaps[start], launches=launches,
               max_queries=nn_kernel.nn_argmin.max_queries)
    res["depth_project_batch"] = _depth_project_batch_check(os.path.join(out_dir, "0"), world)
    return res


def _log_reference_scale(rs: dict):
    tag = "reference scale"
    kps, cam = rs["keypoints"], rs["db_cameras"][1]
    _log(f"[{tag}] {len(kps)} images, {min(kps)}-{max(kps)} keypoints per image; the matcher's "
         f"camera (the reader's default) {cam['model_id']} {np.round(cam['params'], 3).tolist()}, the "
         f"mapper's PINHOLE {rs['camera']}")
    _log(f"[{tag}] {rs['pairs_matched']} pairs matched, {rs['pairs_verified']} verified; launches "
         f"{rs['launches']} (uint8 K1 at caps up to {rs['max_cap']}, K2 at up to {rs['max_queries']} queries)")
    _log(f"[{tag}] wall {rs['wall_seconds']:.3f} s; extraction thread {rs['extract_seconds']:.3f} s, "
         f"matcher thread {rs['match_seconds']:.3f} s of which busy {rs['match_busy_seconds']:.3f} s; mapper "
         f"{rs['seconds']:.3f} s, {rs['frames_per_s']:.4f} frames registered/s ({rs['steady_frames_per_s']:.4f} "
         f"over the second half, bench.py's rate)")
    _log(f"[{tag}] registered {rs['registered']}/{len(kps)}, ATE {rs['ate_m'] * 1e3:.3f} mm (the "
         f"JAX package recorded {REFERENCE_REF_SCALE_ATE_MM} mm at this scale), scale error "
         f"{rs['scale_err']:.6f}, {rs['points']} points; peak device memory {rs['peak_mem_bytes'] / 2**20:.1f} "
         f"MiB, {rs['ba_solves']} BA solves, {rs['lm_syncs_per_solve']:.2f} LM host syncs per solve")
    _log(f"[{tag}] phases (mapper and the matcher thread):\n" + rs["phases"])


def _require_reference_scale(rs: dict, n_images: int):
    """Phase 7b's bars: the pixel world's, and both kernels launched."""
    _require_model("reference scale", rs, n_images)
    if rs["launches"]["match_top2_u8"] <= 0 or rs["launches"]["nn_argmin"] <= 0:
        raise AssertionError(f"reference scale: launches {rs['launches']}")
    # the chunk cap is the power of two at or above the largest keypoint
    # count of the chunk's images: the run's largest must have launched
    want = 1 << max(6, int(np.ceil(np.log2(max(rs["keypoints"])))))
    if rs["max_cap"] != want:
        raise AssertionError(f"reference scale: the uint8 K1's largest cap {rs['max_cap']}, not {want}")


def _require_bench_line(res: dict, line: dict, n_images: int):
    """Phase 7c's bars: the pixel world's on the run and on its line, whose
    keys are bench.py's result line's, read from its source, but the two
    FLOP fields."""
    _require_model("sequential", res, n_images)
    want = bench_py_line_keys() - set(DROPPED_KEYS)
    if set(line) != want:
        raise AssertionError(f"sequential: the bench line's keys differ from bench.py's: "
                             f"{sorted(set(line) ^ want)}")
    if line["registered"] < 0.95 * n_images or not line["ate_m"] < 0.10 or not line["value"] > 0:
        raise AssertionError(f"sequential: bench line {line}")


def run_long(args, world: dict, tmp: str) -> int:
    """--long-images: phase 6 at args.n_images views, its numbers and bars;
    no result line."""
    import torch

    px = run_pixel_world(world, tmp)
    kps = px["keypoints"]
    _log(f"[long] {len(kps)} views rendered in {world['seconds']:.2f} s; feature_extractor "
         f"{px['extract_seconds']:.3f} s, {min(kps)}-{max(kps)} keypoints per image; sequential matcher "
         f"{px['matcher_seconds']:.3f} s, {px['pairs_verified']} of {px['pairs_tried']} pairs verified")
    _log(f"[long] mapper: registered {px['registered']}/{args.n_images} in {px['models']} model(s), ATE "
         f"{px['ate_m'] * 1e3:.3f} mm (the JAX package recorded {REFERENCE_450_ATE_MM} mm on 450 views), "
         f"scale error {px['scale_err']:.6f}; {px['seconds']:.3f} s (cli.main), {px['frames_per_s']:.4f} frames "
         f"registered/s, K2 launches {px['mapper_launches']['nn_argmin']}, peak device memory "
         f"{px['peak_mem_bytes'] / 2**20:.1f} MiB (max allocated since {torch.cuda.memory_allocated() / 2**20:.1f} "
         f"MiB were held), {px['ba_solves']} BA solves, {px['lm_syncs_per_solve']:.2f} LM host syncs per solve")
    _log("[long] mapper phases:\n" + px["phases"])
    _require_model(f"{args.n_images} views", px, args.n_images)
    _log(f"[long] phases 1-2 and 6 at {args.n_images} views passed; no result line")
    return 0


def run_descriptor_world(args, tmp: str, rng) -> dict:
    """Phase 8: matcher then lidar mapper on clean synthetic descriptors."""
    import torch

    from colmap_pcd_tpu_torch.utils.logging_utils import PHASES
    from synthetic_torch import make_descriptor_world, mapper_argv, match_precision_recall, write_world

    kernels = kernel_counters()
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

    reset_phases()
    rc, m_seconds, m_launches = _run_cli(
        ["sequential_matcher", "--database_path", paths["database"],
         "--SequentialMatching.overlap", "5"], kernels,
    )
    if rc != 0:
        raise RuntimeError(f"sequential_matcher exited with {rc}")
    pr = match_precision_recall(paths["database"], point_ids)
    m_syncs = PHASES.counts.get("linalg_syncs", 0)

    reset_phases()
    torch.cuda.reset_peak_memory_stats()
    out_dir = os.path.join(tmp, "model")
    rc, seconds, launches = _run_cli(mapper_argv(paths, out_dir), kernels)
    if rc != 0:
        raise RuntimeError(f"mapper exited with {rc}")
    res = _read_model(out_dir, gt)
    res.update(mapper_numbers(seconds, res["registered"]))
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

    kernels = kernel_counters()
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


def _k2_model_queries(rec, map_points: np.ndarray, Q: int | None = None) -> dict:
    """K2 timed with a model's points as queries against the map: every
    point, as `BundleAdjustmentController` queries them, or Q of them
    (repeated in turn where the model holds fewer)."""
    import torch

    from colmap_pcd_tpu_torch.ops import nn_kernel
    from colmap_pcd_tpu_torch.utils.native import NativeKdTree

    q = np.stack([p.xyz for p in rec.points3D.values()]).astype(np.float32)
    q = np.resize(q, (Q or q.shape[0], 3))
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

    kernels = kernel_counters()
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
    res["undistorted_workspace"] = out("undistorted")

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

    kernels = kernel_counters()
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
                                          "--RigBundleAdjustment.refine_relative_poses", "1"], kernel_counters())
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


# ---------------------------------------------------------------------------
# phase 12: dense reconstruction


def _dense_workspace(src: str, dst: str, n_views: int):
    """A dense workspace over phase 10's undistorted images whose model
    keeps the first n_views registered (the rest deregistered; they can
    still serve as sources)."""
    from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction

    os.makedirs(dst)
    os.symlink(os.path.join(src, "images"), os.path.join(dst, "images"))
    rec = Reconstruction.read(os.path.join(src, "sparse"))
    for iid in sorted(rec.registered_ids)[n_views:]:
        rec.deregister_image(iid)
    rec.write(os.path.join(dst, "sparse"))
    return rec


def _sweep_inputs(ws: str, rec, ref_id: int) -> tuple:
    """One view's plane_sweep inputs as run_patch_match_stereo builds them
    (numpy), with the sources' depth maps from the workspace as the
    geometric pass's prior."""
    from colmap_pcd_tpu_torch.models import mvs
    from colmap_pcd_tpu_torch.utils.image import imread_gray

    opts = mvs.DenseOptions()
    srcs = mvs._select_sources(rec, ref_id, opts.num_src_images)

    def img(iid):
        return imread_gray(os.path.join(ws, "images", rec.images[iid].name)).astype(np.float32)

    def depth_map(iid):
        name = rec.images[iid].name.replace("/", "_")
        return np.load(os.path.join(ws, "stereo", "depth_maps", name + ".npy"))

    rel = [mvs._relative(rec, ref_id, s) for s in srcs]
    dmin, dmax = mvs._depth_range(rec, ref_id)
    depths = (1.0 / np.linspace(1.0 / dmax, 1.0 / dmin, opts.num_depths)).astype(np.float32)
    K = [mvs._K_of(rec.cameras[rec.images[i].camera_id], 1.0) for i in [ref_id, *srcs]]
    return (img(ref_id), np.stack([img(s) for s in srcs]), K[0], np.stack(K[1:]),
            np.stack([r for r, _ in rel]), np.stack([t for _, t in rel]), depths,
            np.stack([depth_map(s) for s in srcs]))


def _sweep_check(ws: str, rec, ref_id: int) -> dict:
    """plane_sweep of one view, both passes: twice on the card and once on
    the CPU on the same inputs; CUDA-event times, kernels per pass, peak."""
    import torch

    from colmap_pcd_tpu_torch import device
    from colmap_pcd_tpu_torch.ops import stereo

    inputs = _sweep_inputs(ws, rec, ref_id)
    card = device.resolve("cuda")

    def sweep(dev):
        t = [torch.as_tensor(a, device=dev) for a in inputs]
        photo = stereo.plane_sweep(*t[:7])
        geom = stereo.plane_sweep(*t[:7], src_depths=t[7], use_geom=True)
        return [a.cpu().numpy() for a in (*photo, *geom)]

    t_in = [torch.as_tensor(a, device=card) for a in inputs]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    on_card = sweep(card)
    peak = torch.cuda.max_memory_allocated() - base
    on_card2 = sweep(card)
    t0 = time.perf_counter()
    cpu = sweep("cpu")
    cpu_s = time.perf_counter() - t0
    res = {"view": ref_id, "sources": inputs[1].shape[0], "cpu_seconds": cpu_s, "peak_bytes": peak,
           "rerun_identical": all(np.array_equal(a, b) for a, b in zip(on_card, on_card2))}
    for k, label in ((0, "photometric"), (3, "geometric")):
        same = on_card[k] == cpu[k]
        res[label] = {"same_depth": float(same.mean()),
                      "cost_err": float(np.abs(on_card[k + 1] - cpu[k + 1])[same].max()),
                      "normal_err": float(np.abs(on_card[k + 2] - cpu[k + 2])[same].max())}
    res["photo_ms"] = _cuda_ms(lambda: stereo.plane_sweep(*t_in[:7]), 2)
    res["geom_ms"] = _cuda_ms(lambda: stereo.plane_sweep(*t_in[:7], src_depths=t_in[7], use_geom=True), 2)
    res["photo_kernels"] = _count_kernels(lambda: stereo.plane_sweep(*t_in[:7]))
    res["geom_kernels"] = _count_kernels(
        lambda: stereo.plane_sweep(*t_in[:7], src_depths=t_in[7], use_geom=True))
    return res


def _poisson_twice(points: np.ndarray, normals: np.ndarray) -> dict:
    """The splat and spectral solve of `poisson_mesh` at depth 7, twice on
    the card (chi and density byte-identical), timed by CUDA events; then
    the whole mesh twice (identical vertices and faces)."""
    import torch

    from colmap_pcd_tpu_torch import device
    from colmap_pcd_tpu_torch.ops import meshing

    card = device.resolve("cuda")
    n = 1 << 7
    nlen = np.linalg.norm(normals, axis=1)
    keep = nlen > 1e-6
    pts, nrm = points[keep], normals[keep] / nlen[keep, None]
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    span = float((hi - lo).max()) or 1.0
    p01 = torch.as_tensor(((pts - (lo - 0.125 * span)) / (1.25 * span)).astype(np.float32), device=card)
    nd = torch.as_tensor(nrm.astype(np.float32), device=card)
    w = torch.ones(p01.shape[0], device=card)
    a = meshing._indicator_grid(p01, nd, w, n, 1.5, 1e-3)
    b = meshing._indicator_grid(p01, nd, w, n, 1.5, 1e-3)
    ms = _cuda_ms(lambda: meshing._indicator_grid(p01, nd, w, n, 1.5, 1e-3), 2)
    m1 = meshing.poisson_mesh(points, normals, meshing.PoissonOptions(depth=7), device=card)
    m2 = meshing.poisson_mesh(points, normals, meshing.PoissonOptions(depth=7), device=card)
    return {"grid_identical": all(torch.equal(x, y) for x, y in zip(a, b)),
            "mesh_identical": all(np.array_equal(x, y) for x, y in zip(m1, m2)),
            "splat_solve_ms": ms, "points": int(p01.shape[0])}


def _plane_distances(lmap, q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(|(p - m) . n_m|, |p - m|) of each point p against its nearest map
    point m, through LidarMap.nn_query (K2 on a CUDA map)."""
    m_pts, m_nrm, dist = lmap.nn_query(q)
    return np.abs(np.sum((q - m_pts) * m_nrm, axis=1)), dist


def _point_to_plane(lmap, pts: np.ndarray) -> tuple[np.ndarray, dict]:
    """|(p - m) . n_m| of each point p against its nearest map point m (K2
    through LidarMap.nn_query), and K2 timed at this query count beside the
    host kd-tree (CUDA events; kd-tree median of 3 by the host clock)."""
    import torch

    from colmap_pcd_tpu_torch.ops import nn_kernel

    q = np.ascontiguousarray(pts, np.float32)
    d, dist = _plane_distances(lmap, q)
    _, host_dist = lmap.host_tree.nn(q)
    host_rel = float(np.max(np.abs(host_dist - dist) / np.maximum(dist, 1e-6)))
    if host_rel > DIST_RTOL:
        raise AssertionError(f"K2 and the host kd-tree disagree at Q={len(q)}: max rel {host_rel:.3g}")
    q_d = torch.as_tensor(q, device=lmap.device)
    ms = _cuda_ms(lambda: nn_kernel.nn_argmin(q_d, lmap.d_points4), 3)
    device_ms = _graph_ms(lambda: nn_kernel.nn_argmin(q_d, lmap.d_points4), 3)
    host_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        lmap.host_tree.nn(q)
        host_s.append(time.perf_counter() - t0)
    Q, N = len(q), lmap.num_points
    bound_ms, bound_by = _bound(12 * Q + 12 * N + 8 * Q, 8.0 * Q * N, F32_FLOPS)
    return d, {"Q": Q, "N": N, "ms": ms, "device_ms": device_ms, "host_kdtree_ms": float(np.median(host_s)) * 1e3,
               "bound_ms": bound_ms, "bound_by": bound_by, "max_rel_vs_kdtree": host_rel}


def run_dense(args, world: dict, st: dict, tmp: str) -> dict:
    """Phase 12: the dense commands through cli.main on phase 10's
    undistorted workspace, each with the launch counts zeroed just before
    it; automatic_reconstructor --dense 1 on the first 10 views; one view's
    sweep on the card against the CPU; the splat and mesh twice; the fused
    cloud and the mesh against the lidar map."""
    import torch

    from colmap_pcd_tpu_torch.io import ply as ply_io
    from colmap_pcd_tpu_torch.models import mvs
    from colmap_pcd_tpu_torch.models.lidar_map import LidarMap
    from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction
    from colmap_pcd_tpu_torch.utils.logging_utils import PHASES
    from synthetic_torch import mapper_argv

    kernels = kernel_counters()
    paths = world["paths"]
    ws = os.path.join(tmp, "ws")
    rec = _dense_workspace(st["undistorted_workspace"], ws, args.dense_views)
    res = {"commands": {}, "views_registered": rec.num_reg_images}

    def run(label, argv):
        reset_phases()
        torch.cuda.reset_peak_memory_stats()
        rc, seconds, launches = _run_cli(argv, kernels)
        if rc != 0:
            raise RuntimeError(f"{label} exited with {rc}")
        res["commands"][label] = {"seconds": seconds, "launches": launches,
                                  "peak_bytes": torch.cuda.max_memory_allocated(),
                                  "phases": dict(PHASES.counts)}
        _log(f"[dense] {label}: {seconds:.3f} s (cli.main), launches {launches}, peak device memory "
             f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, host fetches {dict(PHASES.counts)}")

    # the model is in the frame LidarMap.load holds the map in: its sparse
    # points lie on the map's planes
    lmap = LidarMap.load(paths["lidar"], device="cuda")
    sparse = np.stack([p.xyz for p in rec.points3D.values()]).astype(np.float32)
    to_plane, to_point = _plane_distances(lmap, sparse)
    res["sparse_to_map_m"] = (float(np.median(to_plane)), float(np.median(to_point)))

    run("patch_match_stereo", ["patch_match_stereo", "--workspace_path", ws])
    with_source = [i for i in rec.registered_ids if mvs._select_sources(rec, i, 4)]
    names = [rec.images[i].name.replace("/", "_") + ".npy" for i in with_source]
    res["maps_missing"] = [n for n in names for kind in ("depth_maps", "normal_maps", "cost_maps")
                           if not os.path.exists(os.path.join(ws, "stereo", kind, n))]
    res["views"] = len(with_source)
    run("stereo_fusion", ["stereo_fusion", "--workspace_path", ws])
    fused = ply_io.read_ply(os.path.join(ws, "fused.ply"))
    res["fused_points"] = len(fused.xyz)
    run("poisson_mesher", ["poisson_mesher", "--input_path", os.path.join(ws, "fused.ply"),
                           "--output_path", os.path.join(ws, "meshed-poisson.ply"), "--PoissonMeshing.depth", "7"])
    verts, faces = ply_io.read_ply_mesh(os.path.join(ws, "meshed-poisson.ply"))
    res["poisson"] = (len(verts), len(faces))
    run("delaunay_mesher dense", ["delaunay_mesher", "--input_path", ws,
                                  "--output_path", os.path.join(ws, "meshed-delaunay.ply")])
    run("delaunay_mesher sparse", ["delaunay_mesher", "--input_path", os.path.join(ws, "sparse"),
                                   "--output_path", os.path.join(ws, "meshed-delaunay-sparse.ply"),
                                   "--input_type", "sparse"])
    meshes = [ply_io.read_ply_mesh(os.path.join(ws, f))
              for f in ("meshed-delaunay.ply", "meshed-delaunay-sparse.ply")]
    res["delaunay_faces"] = tuple(len(f) for _, f in meshes)
    res["delaunay_sparse_vertices"], res["sparse_points"] = len(meshes[1][0]), len(rec.points3D)

    # the one-click pipeline with its dense stage on the first 10 views,
    # with the lidar mapper's flags
    imgs = os.path.join(tmp, "auto_images")
    os.makedirs(imgs)
    for name in sorted(os.listdir(paths["images"]))[:10]:
        shutil.copy(os.path.join(paths["images"], name), imgs)
    cfg = _extraction_config()
    auto = os.path.join(tmp, "auto")
    run("automatic_reconstructor --dense 1", [
        "automatic_reconstructor", "--workspace_path", auto, "--image_path", imgs, "--dense", "1",
        "--ImageReader.camera_model", "PINHOLE",
        "--ImageReader.camera_params", f"{PIXEL_F},{PIXEL_F},{PIXEL_W / 2},{PIXEL_H / 2}",
        "--SiftExtraction.max_num_features", str(cfg.max_num_features),
        "--SiftExtraction.first_octave", str(cfg.first_octave),
        "--SiftExtraction.num_octaves", str(cfg.num_octaves),
        *mapper_argv(paths, "")[3:-2], *PIXEL_MAPPER_FLAGS, "--Mapper.multiple_models", "0",
    ])
    res["auto_registered"] = Reconstruction.read(os.path.join(auto, "sparse", "0")).num_reg_images
    res["auto_faces"] = len(ply_io.read_ply_mesh(os.path.join(auto, "dense", "meshed-poisson.ply"))[1])

    ids = sorted(with_source)
    res["sweep"] = _sweep_check(ws, rec, ids[len(ids) // 2])
    res["poisson_twice"] = _poisson_twice(fused.xyz, fused.normals)
    d_fused, res["k2_fused"] = _point_to_plane(lmap, fused.xyz)
    d_mesh, _ = _point_to_plane(lmap, verts)
    res["p2p_fused_m"] = (float(np.median(d_fused)), float(np.percentile(d_fused, 90)))
    res["p2p_mesh_m"] = (float(np.median(d_mesh)), float(np.percentile(d_mesh, 90)))
    return res


def _require_dense(dn: dict):
    """Phase 12's bars (PERF.md section 2)."""
    if not dn["sparse_to_map_m"][0] < 0.05:
        raise AssertionError(f"dense: the model's points lie {dn['sparse_to_map_m']} m from the map (frame?)")
    if dn["views"] <= 0 or dn["maps_missing"]:
        raise AssertionError(f"dense: {dn['views']} views with a source, maps missing {dn['maps_missing'][:5]}")
    sw = dn["sweep"]
    for label in ("photometric", "geometric"):
        c = sw[label]
        if c["same_depth"] < DENSE_SAME_DEPTH or c["cost_err"] > DENSE_COST_ATOL:
            raise AssertionError(f"dense: the card's {label} sweep against the CPU's: {c}")
    if not sw["rerun_identical"]:
        raise AssertionError("dense: two card runs of the sweep differ")
    pt = dn["poisson_twice"]
    if not (pt["grid_identical"] and pt["mesh_identical"]):
        raise AssertionError(f"dense: two card runs of the splat or the mesh differ: {pt}")
    if dn["fused_points"] <= 0 or dn["poisson"][1] <= 0:
        raise AssertionError(f"dense: fused points {dn['fused_points']}, Poisson mesh {dn['poisson']}")
    if not dn["p2p_fused_m"][0] < FUSED_P2P_M:
        raise AssertionError(f"dense: fused cloud median point-to-plane {dn['p2p_fused_m'][0]} >= {FUSED_P2P_M} m")
    if not dn["p2p_mesh_m"][0] < MESH_P2P_M:
        raise AssertionError(f"dense: mesh median point-to-plane {dn['p2p_mesh_m'][0]} >= {MESH_P2P_M} m")
    # both meshes have faces, and the sparse one keeps every model point as a
    # vertex (on a 14-view cut of the corridor both packages' sparse meshers
    # find no face: ROADMAP queue 3)
    if min(dn["delaunay_faces"]) <= 0 or dn["delaunay_sparse_vertices"] != dn["sparse_points"]:
        raise AssertionError(f"dense: Delaunay faces (dense, sparse) {dn['delaunay_faces']}, sparse vertices "
                             f"{dn['delaunay_sparse_vertices']} of {dn['sparse_points']} model points")
    if dn["auto_faces"] <= 0:
        raise AssertionError(f"dense: automatic_reconstructor --dense 1 meshed {dn['auto_faces']} faces")


# ---------------------------------------------------------------------------
# phase 13: the sharded paths (colmap_pcd_tpu_torch/parallel) on the card


def _smoke_mesh():
    """Every visible card when there are two or more, else cuda:0 twice
    (the counterpart of the JAX tests' virtual devices): (mesh, label)."""
    import torch

    from colmap_pcd_tpu_torch.parallel.mesh import make_mesh

    if torch.cuda.device_count() >= 2:
        return make_mesh(), f"{torch.cuda.device_count()} cards"
    return make_mesh(2, devices=["cuda:0"] * 2), "cuda:0 repeated twice (one card)"


def _first_views_database(src: str, dst: str, n: int):
    """A copy of a database holding its images 1..n and the pairs among them."""
    import sqlite3

    from colmap_pcd_tpu_torch.models.database import MAX_IMAGE_ID

    with sqlite3.connect(src) as a, sqlite3.connect(dst) as b:
        a.backup(b)
    con = sqlite3.connect(dst)
    for table in ("images", "keypoints", "descriptors"):
        con.execute(f"DELETE FROM {table} WHERE image_id > ?", (n,))
    for table in ("matches", "two_view_geometries"):  # pair ids end in the larger image id
        con.execute(f"DELETE FROM {table} WHERE pair_id % ? > ?", (MAX_IMAGE_ID, n))
    con.commit()
    con.close()


def _sharded_mapper(world: dict, mesh, tmp: str) -> dict:
    """The pixel world's lidar mapper (phase 6's map, prior and flags) on a
    copy of phase 6's database cut to its first SHARDED_VIEWS images, through
    IncrementalMapperController with every BA solve distributed over the
    mesh, and the same without the mesh."""
    import torch

    from colmap_pcd_tpu_torch import cli, device
    from colmap_pcd_tpu_torch.utils.logging_utils import PHASES
    from synthetic_torch import mapper_argv

    n_views = SHARDED_VIEWS
    paths = dict(world["paths"], database=os.path.join(tmp, "sharded_views.db"))
    _first_views_database(world["paths"]["database"], paths["database"], n_views)
    runs = {}
    for label, mesh_ in (("unsharded", None), ("sharded", mesh)):
        out_dir = os.path.join(tmp, f"{label}_model")
        ctl = cli.mapper_controller(mapper_argv(paths, out_dir, *PIXEL_MAPPER_FLAGS)[1:], device.resolve("cuda"))
        ctl.mapper.dist_mesh = mesh_
        reset_phases()
        torch.cuda.reset_peak_memory_stats()
        manager, seconds, launches = counted(ctl.run, kernel_counters())
        manager.write(out_dir)
        res = _read_model(out_dir, world["gt"][:n_views])
        res.update(mapper_numbers(seconds, res["registered"]), launches=launches,
                   ba_device_s=PHASES.totals.get("ba_device", 0.0))
        runs[label] = res
    res = runs["sharded"]
    # the distributed solves are the `ba_device` phases; each reduces its
    # initial cost, then per LM iteration (dense tier) its system and cost
    solves = PHASES.counts.get("ba_device", 0)
    reductions = PHASES.counts.get("ba_reductions", 0)
    iterations = max((reductions - solves) / 2, 1)
    res.update(views=n_views, unsharded=runs["unsharded"], dist_solves=solves,
               ba_shard_s=PHASES.totals.get("ba_shard", 0.0), reductions_per_solve=reductions / max(solves, 1),
               bytes_per_iteration=(PHASES.counts.get("ba_reduced_bytes", 0) - 4 * solves) / iterations)
    return res


def _sharded_pool(world: dict, mesh) -> dict:
    """MatchPool over the pixel world's 100 views (descriptors as floats,
    cap 1024) and phase 6's 485 overlap-5 pairs, sharded over the mesh and
    unsharded on cuda:0."""
    from colmap_pcd_tpu_torch.models.database import Database
    from colmap_pcd_tpu_torch.ops import match_kernel
    from colmap_pcd_tpu_torch.parallel import dist_matching

    db = Database(world["paths"]["database"])
    ids = sorted(db.images())
    descs = {i: db.read_descriptors(i).astype(np.float32) for i in ids}
    db.close()
    pairs = [(i, j) for i in ids for j in ids if 0 < j - i <= 5]
    counter = {"match_top2": match_kernel.match_top2}
    sharded = dist_matching.MatchPool(descs, mesh=mesh, cap=1024)
    (idx_s, ok_s), s_seconds, s_launches = counted(lambda: sharded.match_pairs(pairs), counter)
    one = dist_matching.MatchPool(descs, cap=1024, device="cuda:0")
    (idx_1, ok_1), one_seconds, one_launches = counted(lambda: one.match_pairs(pairs), counter)
    return {"pairs": len(pairs), "matches": int(ok_s.sum()), "pairs_matched": int(ok_s.any(axis=1).sum()),
            "identical": bool(np.array_equal(ok_s, ok_1) and np.array_equal(idx_s, idx_1)),
            "seconds": s_seconds, "launches": s_launches["match_top2"],
            "unsharded_seconds": one_seconds, "unsharded_launches": one_launches["match_top2"]}


def _sharded_stereo(st: dict, mesh, tmp: str, n_views: int = 10) -> dict:
    """run_patch_match_stereo over the mesh and sequentially on cuda:0, each
    on its own copy of phase 12's workspace cut to the first n_views
    registered views. Nothing is padded, so every view's depth map must be
    the same floats both ways."""
    from colmap_pcd_tpu_torch.models import mvs

    opts = mvs.DenseOptions()
    runs = {}
    for label, kw in (("sharded", dict(mesh=mesh)), ("sequential", dict(device="cuda:0"))):
        ws = os.path.join(tmp, f"stereo_{label}")
        rec = _dense_workspace(st["undistorted_workspace"], ws, n_views)
        n, seconds, _ = counted(lambda: mvs.run_patch_match_stereo(ws, opts, rec=rec, **kw), {})
        runs[label] = (ws, rec, n, seconds)
    ws_s, rec, n_s, s_seconds = runs["sharded"]
    ws_q, _, n_q, q_seconds = runs["sequential"]
    srcs = {i: mvs._select_sources(rec, i, opts.num_src_images) for i in rec.registered_ids}
    res = {"views": n_s, "sequential_views": n_q, "seconds": s_seconds, "sequential_seconds": q_seconds,
           "sources": sorted({len(s) for s in srcs.values() if s}), "identical": [], "not_identical": []}
    for i in sorted(i for i, s in srcs.items() if s):
        name = rec.images[i].name.replace("/", "_") + ".npy"
        a, b = (np.load(os.path.join(ws, "stereo", "depth_maps", name)) for ws in (ws_s, ws_q))
        res["identical" if np.array_equal(a, b) else "not_identical"].append(i)
    return res


def run_sharded(args, world: dict, st: dict, tmp: str) -> dict:
    """Phase 13: the sharded paths on the card, over every visible card or
    cuda:0 repeated twice: the pixel world's mapper with distributed BA,
    MatchPool sharded against unsharded, sharded stereo against sequential,
    and dryrun_multichip."""
    from colmap_pcd_tpu_torch.parallel.dryrun import dryrun_multichip

    mesh, label = _smoke_mesh()
    _log(f"[sharded] mesh of {mesh.size}: {label}, devices {[str(d) for d in mesh.devices]}")
    res = {"mesh": label, "mesh_size": mesh.size}
    res["mapper"] = _sharded_mapper(world, mesh, tmp)
    res["pool"] = _sharded_pool(world, mesh)
    res["stereo"] = _sharded_stereo(st, mesh, tmp)
    device = None if mesh.size == len(set(mesh.devices)) else "cuda:0"
    res["dryrun"], res["dryrun_seconds"], _ = counted(lambda: dryrun_multichip(mesh.size, device=device), {})
    return res


def _require_sharded(sh: dict):
    """Phase 13's bars (PERF.md section 2)."""
    m, u = sh["mapper"], sh["mapper"]["unsharded"]
    _require_model("pixel world, sharded BA", m, m["views"])
    _require_model("pixel world, the same views unsharded", u, m["views"])
    if not abs(m["ate_m"] - u["ate_m"]) < 0.02:
        raise AssertionError(f"sharded BA: ATE {m['ate_m']} m against {u['ate_m']} m unsharded")
    if m["dist_solves"] <= 0 or m["reductions_per_solve"] < 3:
        raise AssertionError(f"sharded BA: {m['dist_solves']} solves, {m['reductions_per_solve']} reductions each")
    p = sh["pool"]
    if not p["identical"] or p["pairs_matched"] != p["pairs"]:
        raise AssertionError(f"sharded MatchPool: identical {p['identical']}, {p['pairs_matched']} of "
                             f"{p['pairs']} pairs matched")
    s = sh["stereo"]
    if s["views"] != s["sequential_views"] or s["views"] <= 0 or s["not_identical"] \
            or len(s["identical"]) != s["views"]:
        raise AssertionError(f"sharded stereo: {s['views']} views (sequential {s['sequential_views']}), "
                             f"not identical {s['not_identical']}")


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
    # 30 descriptor images, 50 rig snapshots and 30 sharded mapper views pay
    # for the reference-scale phase: the whole run took 706 s of its 1200 s
    # limit on one H100 at 700 W (PERF.md sections 4 and 5)
    ap.add_argument("--descriptor-images", type=int, default=30)
    ap.add_argument("--overlap-images", type=int, default=30)
    ap.add_argument("--ref-images", type=int, default=100, help="depth of the reference-scale world")
    ap.add_argument("--classic-images", type=int, default=20)
    ap.add_argument("--rig-snapshots", type=int, default=50, help="depth of the rig world")
    ap.add_argument("--rig-points", type=int, default=20000)
    ap.add_argument("--dense-views", type=int, default=None,
                    help="registered views kept in phase 12's workspace")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks of phases 3 and 4; no result line")
    ap.add_argument("--long-images", type=int, default=0,
                    help="run phases 1-2 and phase 6 at this many views, then stop; no result line")
    args = ap.parse_args(argv)
    if args.long_images:
        args.n_images = args.long_images

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from colmap_pcd_tpu_torch.models.lidar_map import LidarMap
    from colmap_pcd_tpu_torch.ops import match_kernel, nn_kernel
    from colmap_pcd_tpu_torch.ops.cuda_build import BUILD_SECONDS

    # 1. environment
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    _log(f"[env] nvidia-smi: {smi}")
    _log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
         f"count {torch.cuda.device_count()}")

    t_start = time.perf_counter()

    def clock(phase: str):
        _log(f"[clock] {phase} starts at {time.perf_counter() - t_start:.1f} s")

    # the reference-scale world renders in a process of its own: rendering
    # threads in this one would hold the interpreter lock against phases 5-7
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp, \
            ThreadPoolExecutor(max_workers=4) as pool, \
            ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn")) as procs:
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
        if args.long_images:
            return run_long(args, world, tmp)
        _log(f"[pixel world] {args.n_images} views at {PIXEL_W}x{PIXEL_H} and 4 at {REF_W}x{REF_H} "
             f"rendered, {world['map_points'].shape[0]} map points written, in {world['seconds']:.2f} s "
             f"(host, beside the build)")

        # 3. + 4. the kernels against their plain versions, on the pixel world's map
        k2 = check_kernel(
            LidarMap.from_arrays(world["map_points"], world["map_normals"], device="cpu").points,
            np.random.default_rng(args.seed + 1),
        )
        k1 = check_match_kernel(np.random.default_rng(args.seed + 2))
        # the reference-scale world renders on the host while phases 5-7 run
        os.makedirs(os.path.join(tmp, "reference"))
        ref_rendering = procs.submit(render_world, args.ref_images, os.path.join(tmp, "reference"), REF_SCALE, 4)

        # 5. SIFT on the card
        clock("phase 5")
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
        ra = sf["ref_agree"]
        _log(f"[sift] reference scale, its first image against the CPU ({sf['ref_cpu_seconds']:.2f} s there): "
             f"{ra['valid'][0]} and {ra['valid'][1]} keypoints, partners {ra['partner_share']:.4f} (within "
             f"{ra['max_px']:.2g} px), same orientation and cosine >= {SIFT_COS}: {ra['good_share']:.4f}")

        # 6. the pixel world
        clock("phase 6")
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

        # 6b. resume the mapper from phase 6's snapshot of about half the views
        clock("phase 6b")
        resumed = run_resume(world, px, tmp)
        _log(f"[resume] snapshots of phase 6's run hold {resumed['snapshots']} registered images; "
             f"mapper --input_path from the one of {resumed['snapshot_registered']}: registered "
             f"{resumed['registered']}/{args.n_images}, ATE {resumed['ate_m'] * 1e3:.3f} mm (phase 6 in this run: "
             f"{px['ate_m'] * 1e3:.3f} mm), scale error {resumed['scale_err']:.6f}; {resumed['seconds']:.3f} s "
             f"(cli.main), K2 launches {resumed['launches']['nn_argmin']} (largest Q {resumed['max_queries']}), "
             f"peak device memory {resumed['peak_mem_bytes'] / 2**20:.1f} MiB, {resumed['ba_solves']} BA solves")
        dp = resumed["depth_project_batch"]
        _log(f"[resume] depth_project_batch over views {dp['views']} of the resumed model ({dp['features']} "
             f"feature rows, {min(dp['candidates'])}-{max(dp['candidates'])} frustum candidates each): "
             f"{dp['found']} features found on the card and on the CPU alike, depths within "
             f"{dp['depth_err_m']:.3g} m, chosen points differing {dp['points_differ']}; card "
             f"{dp['card_ms']:.3f} ms (CUDA events, one call), CPU {dp['cpu_seconds']:.3f} s")
        _log("[resume] mapper phases:\n" + resumed["phases"])

        # 7. the overlapped front end
        clock("phase 7")
        n = args.overlap_images
        img_dir = os.path.join(tmp, "overlap", "images")
        os.makedirs(img_dir)
        for name in sorted(os.listdir(world["paths"]["images"]))[:n]:
            shutil.copy(os.path.join(world["paths"]["images"], name), img_dir)
        ov = run_bench({"gt": world["gt"][:n], "images": img_dir, "scale": LIGHT_SCALE},
                       os.path.join(tmp, "overlap"), pinhole_reader=True)
        _log(f"[overlap] {n} images: registered {ov['registered']}, ATE {ov['ate_m'] * 1e3:.3f} mm, scale "
             f"error {ov['scale_err']:.6f}; wall {ov['wall_seconds']:.3f} s (the map's build included), mapper "
             f"{ov['seconds']:.3f} s, extraction thread {ov['extract_seconds']:.3f} s, matcher thread "
             f"{ov['match_seconds']:.3f} s of which busy {ov['match_busy_seconds']:.3f} s, "
             f"{ov['pairs_matched']} pairs matched, {ov['pairs_verified']} verified; launches "
             f"{ov['launches']}")

        # 7b. the reference feature scale, overlapped
        ref = ref_rendering.result()
        _log(f"[reference scale] {args.ref_images} views at {REF_W}x{REF_H}, f = {REF_F:g}, rendered in "
             f"{ref['seconds']:.2f} s (host, beside phases 5-7)")
        clock("phase 7b")
        os.makedirs(os.path.join(tmp, "reference_run"))
        rf = run_bench(ref, os.path.join(tmp, "reference_run"))
        _log_reference_scale(rf)
        # K2 at the run's largest query count, the model's points as queries
        # (the largest call is the whole-model association)
        rf["k2_shape"] = _k2_model_queries(rf["rec"], rf["map_points"], rf["max_queries"])

        # 7c. bench.py's sequential branch on the same views, and its line
        clock("phase 7c")
        os.makedirs(os.path.join(tmp, "sequential"))
        sq = run_bench({"gt": world["gt"][:n], "images": img_dir, "scale": LIGHT_SCALE},
                       os.path.join(tmp, "sequential"), overlapped=False)
        sq_line = bench_line(sq, LIGHT_SCALE, smi)
        _log(f"[sequential] {n} images: extractor {sq['extract_seconds']:.3f} s, sequential matcher "
             f"{sq['match_seconds']:.3f} s ({sq['pairs_matched']} pairs tried, {sq['pairs_verified']} verified), "
             f"mapper {sq['seconds']:.3f} s, wall {sq['wall_seconds']:.3f} s (the map's build included); "
             f"registered {sq['registered']}, ATE {sq['ate_m'] * 1e3:.3f} mm, scale error {sq['scale_err']:.6f}; "
             f"launches {sq['launches']}")
        _log(f"[sequential] bench line: {json.dumps(sq_line)}")

        # 8. the descriptor world
        clock("phase 8")
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
        clock("phase 9")
        os.makedirs(os.path.join(tmp, "classic"))
        cl = run_classic_path(args, os.path.join(tmp, "classic"))
        _log(f"[classic] registered {cl['registered']}/{args.classic_images}, median reprojection "
             f"error {cl['median_reproj_px']:.4f} px, ATE after sim(3) alignment "
             f"{cl['ate_sim3_m']:.6f} m; matcher {cl['matcher_seconds']:.3f} s "
             f"(K1 launches {cl['matcher_launches']['match_top2_u8']} uint8), mapper "
             f"{cl['mapper_seconds']:.3f} s; guided matcher {cl['guided_seconds']:.3f} s "
             f"(K1 launches {cl['guided_launches']['match_top2']} float)")

        # 10. the SfM tools on the pixel world's model and database
        clock("phase 10")
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
        clock("phase 11")
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

        # 12. dense reconstruction on phase 10's undistorted workspace
        clock("phase 12")
        os.makedirs(os.path.join(tmp, "dense"))
        args.dense_views = args.dense_views or args.n_images
        dn = run_dense(args, world, st, os.path.join(tmp, "dense"))
        c = dn["commands"]
        pms = c["patch_match_stereo"]
        _log(f"[dense] workspace: {dn['views_registered']} registered views ({dn['views']} with a source); the "
             f"model's sparse points lie {dn['sparse_to_map_m'][0] * 1e3:.3f} mm (median) from the lidar map's "
             f"planes as LidarMap.load holds it ({dn['sparse_to_map_m'][1] * 1e3:.3f} mm from its nearest point)")
        _log(f"[dense] patch_match_stereo (64 depths, 4 sources, r = 3, bilateral, geometric pass): "
             f"{pms['seconds']:.3f} s for {dn['views']} views, {pms['seconds'] / (2 * dn['views']):.4f} s per "
             f"view-pass, peak device memory {pms['peak_bytes'] / 2**20:.1f} MiB, "
             f"{pms['phases'].get('stereo_fetch', 0) / max(dn['views'], 1):.2f} host fetches per view")
        _log(f"[dense] stereo_fusion: {c['stereo_fusion']['seconds']:.3f} s, {dn['fused_points']} fused points; "
             f"poisson_mesher (depth 7): {c['poisson_mesher']['seconds']:.3f} s, {dn['poisson'][0]} vertices, "
             f"{dn['poisson'][1]} faces")
        _log(f"[dense] delaunay_mesher dense: {c['delaunay_mesher dense']['seconds']:.3f} s, "
             f"{dn['delaunay_faces'][0]} faces; sparse: {c['delaunay_mesher sparse']['seconds']:.3f} s, "
             f"{dn['delaunay_faces'][1]} faces")
        _log(f"[dense] automatic_reconstructor --dense 1 (10 views, lidar mapper): "
             f"{c['automatic_reconstructor --dense 1']['seconds']:.3f} s, {dn['auto_registered']} registered, "
             f"{dn['auto_faces']} mesh faces")
        sw = dn["sweep"]
        _log(f"[dense] one view's sweep (view {sw['view']}, {sw['sources']} sources): photometric "
             f"{sw['photo_ms']:.3f} ms, geometric {sw['geom_ms']:.3f} ms (CUDA events, mean of 2), kernels "
             f"{sw['photo_kernels']} and {sw['geom_kernels']}, peak {sw['peak_bytes'] / 2**20:.1f} MiB above "
             f"the inputs; against the CPU ({sw['cpu_seconds']:.3f} s there): photometric {sw['photometric']}, "
             f"geometric {sw['geometric']}; two card runs identical: {sw['rerun_identical']}")
        pt = dn["poisson_twice"]
        _log(f"[dense] splat + spectral solve at depth 7 of {pt['points']} points: {pt['splat_solve_ms']:.3f} ms "
             f"(CUDA events, mean of 2); twice on the card: grid identical {pt['grid_identical']}, mesh "
             f"identical {pt['mesh_identical']}")
        k2f = dn["k2_fused"]
        _log(f"[dense] point-to-plane distance to the lidar map (median, p90): fused cloud "
             f"{dn['p2p_fused_m'][0] * 1e3:.3f}, {dn['p2p_fused_m'][1] * 1e3:.3f} mm; Poisson mesh vertices "
             f"{dn['p2p_mesh_m'][0] * 1e3:.3f}, {dn['p2p_mesh_m'][1] * 1e3:.3f} mm")
        _log(f"[k2] Q={k2f['Q']} N={k2f['N']} (the fused cloud): kernel {k2f['ms']:.4f} ms per call, "
             f"{k2f['device_ms']:.4f} ms on the device (CUDA graph); bound {k2f['bound_ms']:.4f} ms "
             f"({k2f['bound_by']}), {100 * k2f['bound_ms'] / k2f['device_ms']:.1f}% reached; host kd-tree "
             f"{k2f['host_kdtree_ms']:.4f} ms (host clock, median of 3); max rel dist against the kd-tree "
             f"{k2f['max_rel_vs_kdtree']:.3g}")

        # 13. the sharded paths over a mesh of devices
        clock("phase 13")
        sh = run_sharded(args, world, st, tmp)
        m = sh["mapper"]
        u = m["unsharded"]
        _log(f"[sharded] pixel world mapper on its first {m['views']} views, unsharded: registered "
             f"{u['registered']}, ATE {u['ate_m'] * 1e3:.3f} mm, {u['seconds']:.3f} s, ba_device "
             f"{u['ba_device_s']:.3f} s, K2 launches {u['launches']['nn_argmin']}")
        _log(f"[sharded] the same, every BA solve distributed over the mesh: registered "
             f"{m['registered']}/{m['views']}, ATE {m['ate_m'] * 1e3:.3f} mm, scale error "
             f"{m['scale_err']:.6f}; {m['seconds']:.3f} s, ba_device "
             f"{m['ba_device_s']:.3f} s over {m['dist_solves']} distributed solves (of it sharding and upload, "
             f"ba_shard, {m['ba_shard_s']:.3f} s), K2 launches "
             f"{m['launches']['nn_argmin']}, {m['reductions_per_solve']:.2f} reductions per solve, "
             f"{m['bytes_per_iteration']:.1f} bytes reduced per LM iteration (mean), peak device memory "
             f"{m['peak_mem_bytes'] / 2**20:.1f} MiB")
        _log("[sharded] mapper phases:\n" + m["phases"])
        p = sh["pool"]
        _log(f"[sharded] MatchPool, {p['pairs']} pairs at cap 1024 (float descriptors): sharded "
             f"{p['seconds']:.3f} s with {p['launches']} float-K1 launches, unsharded on cuda:0 "
             f"{p['unsharded_seconds']:.3f} s with {p['unsharded_launches']}; (idx, ok) identical: "
             f"{p['identical']}; {p['matches']} matches, {p['pairs_matched']} pairs with matches")
        s_ = sh["stereo"]
        _log(f"[sharded] patch_match_stereo on the first 10 views (source counts {s_['sources']}): sharded "
             f"{s_['seconds']:.3f} s, sequential {s_['sequential_seconds']:.3f} s, {s_['views']} views; depth "
             f"identical on {len(s_['identical'])} of them")
        _log(f"[sharded] dryrun_multichip({sh['mesh_size']}): {sh['dryrun']} in {sh['dryrun_seconds']:.3f} s")

    # 14. checks
    u8_launches = {"pixel world": px["matcher_launches"]["match_top2_u8"],
                   "overlapped": ov["launches"]["match_top2_u8"],
                   "sequential": sq["launches"]["match_top2_u8"],
                   "reference scale": rf["launches"]["match_top2_u8"],
                   "descriptor world": res["matcher_launches"]["match_top2_u8"],
                   "classic world": cl["matcher_launches"]["match_top2_u8"]}
    k2_launches = {"pixel world": px["mapper_launches"]["nn_argmin"],
                   "overlapped": ov["launches"]["nn_argmin"],
                   "sequential": sq["launches"]["nn_argmin"],
                   "reference scale": rf["launches"]["nn_argmin"],
                   "descriptor world": res["mapper_launches"]["nn_argmin"],
                   "bundle_adjuster": cmds["bundle_adjuster"]["launches"]["nn_argmin"],
                   "hierarchical_mapper": cmds["hierarchical_mapper"]["launches"]["nn_argmin"],
                   "pixel world, sharded BA": sh["mapper"]["launches"]["nn_argmin"],
                   "resume": resumed["launches"]["nn_argmin"]}
    f32_launches = {"guided matcher, classic world": cl["guided_launches"]["match_top2"],
                    "MatchPool, sharded": sh["pool"]["launches"]}
    u8_launches["spatial_matcher"] = cmds["spatial_matcher"]["launches"]["match_top2_u8"]
    for label in ("vocab_tree_matcher", "sequential_matcher loop detection"):
        u8_launches[label] = ph["retrieval"]["commands"][label]["launches"]["match_top2_u8"]
    for path, n in u8_launches.items():
        if n <= 0:
            raise AssertionError(f"the {path} run never launched the uint8 K1")
    for path, n in k2_launches.items():
        if n <= 0:
            raise AssertionError(f"the {path} run never launched K2")
    for path, n in f32_launches.items():
        if n <= 0:
            raise AssertionError(f"the {path} run never launched the float K1")
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
    _require_model("resume", resumed, args.n_images)
    if not resumed["registered"] > resumed["snapshot_registered"]:
        raise AssertionError(f"resume: registered {resumed['registered']}, not above the snapshot's "
                             f"{resumed['snapshot_registered']}")
    _require_model("overlapped front end", ov, args.overlap_images)
    _require_reference_scale(rf, args.ref_images)
    _require_bench_line(sq, sq_line, args.overlap_images)
    _require_model("descriptor world", res, args.descriptor_images)
    if not pr["precision"] >= 0.95:
        raise AssertionError(f"match precision {pr['precision']} < 0.95")
    if cl["registered"] < args.classic_images - 1:
        raise AssertionError(f"classic: registered {cl['registered']} < {args.classic_images - 1}")
    if not cl["median_reproj_px"] < 1.0:
        raise AssertionError(f"classic: median reprojection error {cl['median_reproj_px']} >= 1 px")
    _require_sfm_tools(st, px, args.n_images)
    _require_retrieval_and_rigs(ph, args.n_images)
    _require_dense(dn)
    _require_sharded(sh)

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
    k2["shapes"][f"Q={rf['max_queries']} N={rf['map_points']} (reference scale, the run's largest)"] = \
        rf["k2_shape"]
    k2f = dn["k2_fused"]
    k2["shapes"][f"Q={k2f['Q']} N={k2f['N']} (fused cloud, point-to-plane)"] = {
        **{k: k2f[k] for k in ("ms", "device_ms", "host_kdtree_ms", "bound_ms", "bound_by")},
        "plain_ms": None, "library_ms": None}
    clock("the result")
    print(json.dumps({"kernels": [
        entry("nn_argmin", "nn_argmin.cu", 191, k2_launches["pixel world"], k2,
              launches_by_path=k2_launches),
        entry("match_top2", "match_top2.cu", 94, cl["guided_launches"]["match_top2"], k1["match_top2"],
              mma="fma", launches_by_path=f32_launches),
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
