"""Distributed bundle adjustment: the Schur complement reduced over the mesh.

Port of colmap_pcd_tpu/parallel/dist_ba.py. 3D points and their
observations are partitioned into per-device blocks; every device assembles
the camera-side normal equations of its block, the reduced camera system is
summed over the mesh onto its root device, solved there once, and the
camera step is copied back to every device, which back-substitutes its own
point block. Camera parameters are replicated; per LM iteration the dense
tier reduces one [D,D] + 2 [D] system (S, b and diag B) and the cost,
whatever the number of points; the PCG tier reduces its gradient and
preconditioner blocks and one [nb,6] matvec per CG step (ops/ba.py,
`solve_shards`).

The JAX devices each solve an identical replicated system; solving it once
on the root and copying the step computes the same thing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ba as ba_ops
from ..utils.logging_utils import PHASES
from .mesh import Mesh


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def shard_problem(problem: ba_ops.BAProblem, n_shards: int, mesh: Mesh | None = None) -> list:
    """Partition a BAProblem into n contiguous point blocks, one BAProblem
    per shard, shard s on mesh.devices[s] (without a mesh: on the problem's
    device). The problem's fields may be tensors or numpy arrays (ops/ba.py's
    `host_problem`); from numpy every shard is uploaded once, to its device.

    Observations are re-packed per shard so that every point's track is
    local to its owner (the "owner computes" rule of the spherical-BA
    windowing), into a per-shard capacity of the next power of two above
    the fullest shard. The host builder already padded the points."""
    if mesh is not None and mesh.size != n_shards:
        raise ValueError(f"{n_shards} shards asked for on a mesh of {mesh.size}")
    Pn = problem.points.shape[0]
    if Pn % n_shards:
        raise ValueError(f"point slots {Pn} not divisible by {n_shards}")
    blk = Pn // n_shards

    obs_pt = _host(problem.obs_pt)
    obs_cam = _host(problem.obs_cam)
    obs_uv = _host(problem.obs_uv)
    obs_valid = _host(problem.obs_valid)
    owner = obs_pt // blk
    # per-shard obs capacity: max over shards, padded
    counts = [int(((owner == s) & (obs_valid > 0)).sum()) for s in range(n_shards)]
    ncap = max(1, 1 << int(np.ceil(np.log2(max(max(counts), 1)))))

    T = problem.pt_obs.shape[1]
    s_obs_cam = np.zeros((n_shards, ncap), np.int64)
    s_obs_pt = np.zeros((n_shards, ncap), np.int64)
    s_obs_uv = np.zeros((n_shards, ncap, 2), np.float32)
    s_obs_valid = np.zeros((n_shards, ncap), np.float32)
    s_pt_obs = -np.ones((n_shards, blk, T), np.int64)
    for s in range(n_shards):
        sel = np.nonzero((owner == s) & (obs_valid > 0))[0]
        n = sel.size
        s_obs_cam[s, :n] = obs_cam[sel]
        s_obs_pt[s, :n] = obs_pt[sel] - s * blk  # local point slot
        s_obs_uv[s, :n] = obs_uv[sel]
        s_obs_valid[s, :n] = 1.0
        if n == 0:
            continue
        pv = s_obs_pt[s, :n]
        order = np.argsort(pv, kind="stable")
        ps = pv[order]
        _, starts, cnts = np.unique(ps, return_index=True, return_counts=True)
        # a sharded solve must optimize the SAME objective as the local one:
        # refuse (loudly) rather than silently drop observations beyond T
        if cnts.max() > T:
            raise ValueError(
                f"track with {cnts.max()} observations exceeds pt_obs capacity "
                f"T={T}; rebuild the problem with track_len >= {cnts.max()}"
            )
        rank = np.arange(ps.size) - np.repeat(starts, cnts)
        s_pt_obs[s, ps, rank] = order

    def split(x):
        x = _host(x)
        return x.reshape((n_shards, blk) + x.shape[1:])

    # the fields sharded by point/observation; the rest are replicated
    sharded = {
        "points": split(problem.points), "obs_cam": s_obs_cam, "obs_pt": s_obs_pt,
        "obs_uv": s_obs_uv, "obs_valid": s_obs_valid, "pt_obs": s_pt_obs,
        "lidar_plane": split(problem.lidar_plane), "lidar_w": split(problem.lidar_w),
        "point_fixed": split(problem.point_fixed),
    }
    devices = mesh.devices if mesh is not None else (torch.as_tensor(problem.points).device,) * n_shards
    shards = []
    for s, dev in enumerate(devices):
        fields = {}
        for f, v in problem._asdict().items():
            if f in sharded:
                fields[f] = torch.as_tensor(np.ascontiguousarray(sharded[f][s]), device=dev)
            else:
                fields[f] = torch.as_tensor(v, device=dev)
        shards.append(ba_ops.BAProblem(**fields))
    return shards


def solve_distributed(problem: ba_ops.BAProblem, cfg: ba_ops.BAConfig, mesh: Mesh) -> ba_ops.BAResult:
    """Solve a BAProblem (tensors, or numpy arrays to be sharded before any
    upload) across all devices of the mesh; the result (points stitched back
    to the flat layout) lies on the mesh's root device. The PHASES span
    `ba_shard` times the sharding and upload."""
    with PHASES.phase("ba_shard"):
        shards = shard_problem(problem, mesh.size, mesh)
    q, t, k, Xs, init_cost, cost, it, syncs = ba_ops.solve_shards(shards, cfg, mesh)
    return ba_ops.BAResult(q, t, k, mesh.gather(Xs), init_cost, cost, it, syncs)
