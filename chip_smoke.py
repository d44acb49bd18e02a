#!/usr/bin/env python3
"""Smoke run of the PyTorch port (colmap_pcd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--n-images 100] [--classic-images 20] [--seed 0]

Phases, each printing its numbers on its own line:
  1. environment: the card's name and power limit (nvidia-smi), torch/CUDA;
  2. build: the hand-written CUDA kernels K2 (nn_argmin), K1 for float
     descriptors (match_top2) and K1 for uint8 descriptors on the integer
     tensor cores (match_top2_u8) from the sources in
     colmap_pcd_tpu_torch/csrc, one nvcc each, started together, with their
     build seconds and ptxas reports;
  3. K2 against its plain PyTorch version and the host kd-tree at the
     mapper's shapes (Q in {37, 4096} queries against the smoke world's
     ~0.5 M-point map and a ragged map). Times: CUDA events around repeated
     calls; the kernel's device time alone from a CUDA graph of the repeated launch
     (at Q = 37 the call's time is the host's); the plain version; one
     library call (`torch.cdist` + `argmin`, blocked); the C++ kd-tree's
     median host-clock time; and the bound computed from the shape;
  4. both K1 kernels against their plain versions: the matcher's chunk
     (B = 16 pairs at cap 2048, ragged 1 500-2 048 valid rows), the smoke
     world's chunk (B = 16 at cap 4096, ragged 1 900-2 200), one pair at
     8192 x 8192, a ragged 1000 x 1537 pair and a pair with duplicated
     descriptors. The uint8 cases are the float ones quantized as the world
     generator quantizes descriptors; the uint8 kernel must agree with its
     plain version exactly (similarity error 0, no index or accept
     mismatch), and its launch on the transpose must form bit-identical
     similarities. Times as in 3., the float and the uint8 kernel in turns
     (float, uint8, uint8, float); the library call is one bf16
     `torch.matmul` of the chunk (the product alone);
  5. the main path: a synthetic corridor world (100 images, 0.8 m step,
     640x480, f = 500, ~2 000 keypoints per image plus 5% distractors, each
     with a SIFT-like uint8 descriptor) written to a COLMAP database with no
     matches, a lidar PLY and a pose-prior file; then through `cli.main`
     `sequential_matcher --SequentialMatching.overlap 5` (match_top2_u8)
     and the lidar `mapper` (K2), each with the launch counts zeroed just
     before it; the written inlier matches are scored against the
     generator's correspondences and the model is read back;
  6. the classic path: a 20-image world (step 1.0, 0.2 px noise), the
     sequential matcher, then `mapper` without a lidar map, initialized on
     (1, 3); registered images, median reprojection error and the ATE after
     a sim(3) alignment. Then the float route: `sequential_matcher
     --SiftMatching.guided_matching 1` on a copy of that database, which
     matches pair by pair through match_top2;
  7. checks: match_top2_u8 launched by the matcher in both worlds,
     match_top2 by the guided matcher and K2 by the mapper, match precision
     >= 0.95, lidar mapper >= 95% registered with ATE < 0.10 m and scale
     error < 2%, classic mapper >= 19/20 registered with median
     reprojection error < 1.0 px.

`--kernels-only` stops after phase 4 (on a corridor map built like the
smoke world's) and prints no result line: a short first look at a changed
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
        ("matcher chunk B=16 cap 2048", dict(B=16, N1=2048, N2=2048, n_lo=1500, n_hi=2048), 20, 3),
        ("smoke-world chunk B=16 cap 4096", dict(B=16, N1=4096, N2=4096, n_lo=1900, n_hi=2200), 10, 2),
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
    u8.update(u8["shapes"]["smoke-world chunk B=16 cap 4096"])  # the main path's shape
    return {"match_top2": f32, "match_top2_u8": u8}


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


def _kernel_counters() -> dict:
    from colmap_pcd_tpu_torch.ops import match_kernel, nn_kernel

    return {"match_top2": match_kernel.match_top2, "match_top2_u8": match_kernel.match_top2_u8,
            "nn_argmin": nn_kernel.nn_argmin}


def run_main_path(args, tmp: str, rng) -> dict:
    """Phase 5: matcher then lidar mapper on the 100-image world."""
    import torch

    from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction
    from colmap_pcd_tpu_torch.utils.logging_utils import PHASES
    from synthetic_torch import (
        ate_rmse, make_descriptor_world, mapper_argv, match_precision_recall, scale_error,
        write_world,
    )

    kernels = _kernel_counters()
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-images", type=int, default=100)
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
    from colmap_pcd_tpu_torch.ops import match_kernel, nn_kernel

    # 1. environment
    smi = _nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    _log(f"[env] nvidia-smi: {smi}")
    _log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
         f"count {torch.cuda.device_count()}")

    # 2. build: one nvcc per source, started together
    from colmap_pcd_tpu_torch.ops.cuda_build import BUILD_SECONDS

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        for fut in [pool.submit(f) for f in (nn_kernel.build, match_kernel.build, match_kernel.build_u8)]:
            fut.result()
    _log(f"[build] {len(BUILD_SECONDS)} sources built and loaded in {time.perf_counter() - t0:.2f} s: "
         + ", ".join(f"{stem}.cu {sec:.2f} s" for stem, sec in sorted(BUILD_SECONDS.items())))
    for stem in ("nn_argmin", "match_top2", "match_top2_u8"):
        for line in _ptxas_lines(stem):
            _log(f"[build] {stem}: {line}")

    if args.kernels_only:
        from colmap_pcd_tpu_torch.models.lidar_map import LidarMap
        from synthetic_torch import build_corridor_map

        pts, nrm = build_corridor_map(np.random.default_rng(args.seed), length=0.8 * args.n_images + 25)
        lmap = LidarMap.from_arrays(pts, nrm, device="cpu")
        check_kernel(lmap.points, np.random.default_rng(args.seed + 1))
        check_match_kernel(np.random.default_rng(args.seed + 2))
        _log("[kernels-only] phases 2-4 passed; the main path was not driven")
        return 0

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
             f"recall {pr['recall']:.6f}, K1 launches {res['matcher_launches']['match_top2_u8']} (uint8) "
             f"and {res['matcher_launches']['match_top2']} (float), "
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
             f"(K1 launches {cl['matcher_launches']['match_top2_u8']} uint8), mapper "
             f"{cl['mapper_seconds']:.3f} s; guided matcher {cl['guided_seconds']:.3f} s "
             f"(K1 launches {cl['guided_launches']['match_top2']} float)")

    # 7. checks
    if res["matcher_launches"]["match_top2_u8"] <= 0 or cl["matcher_launches"]["match_top2_u8"] <= 0:
        raise AssertionError("a matcher run never launched the uint8 K1")
    if cl["guided_launches"]["match_top2"] <= 0:
        raise AssertionError("the guided matcher never launched the float K1")
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

    def entry(name, source, line, launches, rec, **more):
        return {
            "name": name, "route": "cuda", "source": f"colmap_pcd_tpu_torch/csrc/{source}",
            "replaces": f"colmap_pcd_tpu/ops/pallas_kernels.py:{line}", "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "device_ms": rec["device_ms"], **more, "shapes": rec["shapes"],
        }

    print(json.dumps({"kernels": [
        entry("nn_argmin", "nn_argmin.cu", 191, res["mapper_launches"]["nn_argmin"], res["k2"]),
        entry("match_top2", "match_top2.cu", 94, cl["guided_launches"]["match_top2"], k1["match_top2"]),
        entry("match_top2_u8", "match_top2_u8.cu", 94, res["matcher_launches"]["match_top2_u8"],
              k1["match_top2_u8"], mma="wgmma"),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
