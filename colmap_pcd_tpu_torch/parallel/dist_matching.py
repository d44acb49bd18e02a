"""Multi-device pairwise matching: image-pair batches sharded over the mesh.

Port of colmap_pcd_tpu/parallel/dist_matching.py. The reference
data-parallels matching with CPU worker threads over pair blocks
(feature/matching.h:222-345); here a batch of B pairs is split into one
contiguous block per mesh device, and each device matches its block with
`ops/matching.match_descriptors`: on CUDA the float K1 kernel
(`ops/match_kernel.match_top2_cross`, batched over the block's pairs: one
launch gives the rows and the cross-check), on the CPU its plain version.
No collectives: every shard is launched before any result is fetched, so
distinct cards overlap.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import matching as matching_ops
from .mesh import Mesh, blocks, shard_devices


def _fetch(outs: list) -> tuple[np.ndarray, np.ndarray]:
    """(idx, ok) of every shard, concatenated in shard order on the host."""
    return tuple(np.concatenate([o[k].cpu().numpy() for o in outs]) for k in range(2))


def match_pairs_batch(
    d1,  # [B, N1, D] L2-normalized (padded rows zero), numpy or tensor
    d2,  # [B, N2, D]
    v1,  # [B, N1]
    v2,  # [B, N2]
    mesh: Mesh | None = None,
    opts: matching_ops.MatchingOptions = matching_ops.MatchingOptions(),
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Match B descriptor pairs at once; with a mesh, B shards across its
    devices (without one: on `device`, None meaning CUDA).

    Returns (idx [B,N1], ok [B,N1]) as numpy. B must be a multiple of the
    mesh size."""
    devs = shard_devices(mesh, device)
    outs = []
    for sl, dev in zip(blocks(d1.shape[0], len(devs)), devs):
        d1s, d2s, v1s, v2s = (torch.as_tensor(x[sl], device=dev) for x in (d1, d2, v1, v2))
        outs.append(matching_ops.match_descriptors(d1s, d2s, v1s, v2s, opts)[:2])
    return _fetch(outs)


def _normalized(d, cap: int) -> tuple[np.ndarray, np.ndarray]:
    """One image's descriptors L2-normalized and zero-padded to `cap` rows,
    and their validity (the JAX package's host normalization)."""
    d = np.asarray(d, np.float32)
    n = min(len(d), cap)
    dp = np.zeros((cap, d.shape[1] if d.size else 128), np.float32)
    if n:
        dp[:n] = d[:n] / np.maximum(np.linalg.norm(d[:n], axis=1, keepdims=True), 1e-8)
    v = np.zeros(cap, np.float32)
    v[:n] = 1.0
    return dp, v


def match_pair_list(
    descs: dict[int, np.ndarray],
    pairs: list[tuple[int, int]],
    mesh: Mesh | None = None,
    cap: int = 2048,
    opts: matching_ops.MatchingOptions = matching_ops.MatchingOptions(),
    device=None,
) -> dict[tuple[int, int], np.ndarray]:
    """Host convenience: normalize/pad per-image descriptors, batch the pair
    list (padding the batch to the mesh size), return per-pair [M,2] matches."""
    norm = {iid: _normalized(d, cap) for iid, d in descs.items()}
    B = len(pairs)
    nd = mesh.size if mesh is not None else 1
    Bp = -(-B // nd) * nd
    d1 = np.zeros((Bp, cap, 128), np.float32)
    d2 = np.zeros((Bp, cap, 128), np.float32)
    v1 = np.zeros((Bp, cap), np.float32)
    v2 = np.zeros((Bp, cap), np.float32)
    for k, (i, j) in enumerate(pairs):
        d1[k], v1[k] = norm[i]
        d2[k], v2[k] = norm[j]
    idx, ok = match_pairs_batch(d1, d2, v1, v2, mesh=mesh, opts=opts, device=device)
    out = {}
    for k, (i, j) in enumerate(pairs):
        rows = np.nonzero(ok[k])[0]
        out[(i, j)] = np.stack([rows, idx[k][rows]], -1).astype(np.int32)
    return out


class MatchPool:
    """A descriptor pool on every mesh device + sharded pair-index matching.

    The stacked [B, N, D] pair-batch path above uploads every image's
    descriptors once PER PAIR it appears in (sequential overlap-5 matching
    ships each image ~10x). The pool keeps ONE normalized copy of every
    image's descriptors on each mesh device (one upload per distinct
    device) and ships only the pair indices per batch; each device gathers
    its block's pairs from its own copy."""

    def __init__(
        self,
        descs: dict[int, np.ndarray],
        mesh: Mesh | None = None,
        cap: int = 2048,
        opts: matching_ops.MatchingOptions = matching_ops.MatchingOptions(),
        device=None,
    ):
        self.devices = shard_devices(mesh, device)
        self.opts = opts
        self.ids = sorted(descs.keys())
        self.row_of = {iid: r for r, iid in enumerate(self.ids)}
        pool = np.zeros((len(self.ids), cap, 128), np.float32)
        valid = np.zeros((len(self.ids), cap), np.float32)
        for r, iid in enumerate(self.ids):
            pool[r], valid[r] = _normalized(descs[iid], cap)
        uploaded = {}
        for dev in self.devices:
            if dev not in uploaded:
                uploaded[dev] = (torch.as_tensor(pool, device=dev), torch.as_tensor(valid, device=dev))
        self.pools = [uploaded[dev] for dev in self.devices]

    def match_pairs(self, pairs: list[tuple[int, int]]) -> tuple[np.ndarray, np.ndarray]:
        """[(i, j)] image-id pairs -> (idx [B,cap], ok [B,cap]) numpy."""
        B = len(pairs)
        nd = len(self.devices)
        Bp = -(-B // nd) * nd
        ii = np.zeros(Bp, np.int64)
        jj = np.zeros(Bp, np.int64)
        for k, (i, j) in enumerate(pairs):
            ii[k] = self.row_of[i]
            jj[k] = self.row_of[j]
        outs = []
        for sl, dev, (pool, valid) in zip(blocks(Bp, nd), self.devices, self.pools):
            i, j = torch.as_tensor(ii[sl], device=dev), torch.as_tensor(jj[sl], device=dev)
            outs.append(matching_ops.match_descriptors(pool[i], pool[j], valid[i], valid[j], self.opts)[:2])
        idx, ok = _fetch(outs)
        return idx[:B], ok[:B]
