"""Exact 1-NN of queries among the lidar map points: the hand-written CUDA
kernel (csrc/nn_argmin.cu) and its plain PyTorch version.

Replaces the Pallas TPU kernel `nn_argmin` (colmap_pcd_tpu/ops/
pallas_kernels.py:175). `nn_argmin` launches the kernel for CUDA tensors and
raises if it cannot; only CPU tensors take `nn_argmin_reference`. The kernel
reads the map as float4 per point: `pack_points` makes that [N,4] copy, and
a caller that queries one map many times (models/lidar_map.py) keeps it. The
kernel is built at its first launch by ops/cuda_build.py; importing this
module needs no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .cuda_build import CSRC_DIR, build_library, on_device, sm_count

Tensor = torch.Tensor

SOURCE = os.path.join(CSRC_DIR, "nn_argmin.cu")

# csrc/nn_argmin.cu has two scans. Mode 0 holds the queries in registers and
# splits the map in tiles; mode 1 serves a few queries a block and splits the
# points among its threads. The source owns their sizes; `load` reads them
# from the library as `lib.tiles[mode] = (queries a block, split granule)`.
# Mode 1 reads the map once per block of queries, so it wins while the
# queries are few: on an H100 up to about 400 of them against a 0.5 M-point
# map (PERF.md).
FEW_QUERIES_MAX = 384

_lock = threading.Lock()
_lib = None


def load(source: str = SOURCE) -> ctypes.CDLL:
    """Compile (if the source changed), load and bind one library of the
    kernel; `build` keeps the one of the package's own source."""
    lib = build_library(source)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.nn_argmin_launch.argtypes = [vp, ci, vp, ci, ci, ci, ci, vp, vp, vp, vp, vp]
    lib.nn_argmin_launch.restype = ci
    for name in ("nn_argmin_split_granule", "nn_argmin_block_queries"):
        getattr(lib, name).argtypes = [ci]
        getattr(lib, name).restype = ci
    lib.tiles = tuple(
        (lib.nn_argmin_block_queries(mode), lib.nn_argmin_split_granule(mode)) for mode in (0, 1)
    )
    return lib


def build() -> ctypes.CDLL:
    """The kernel library of csrc/nn_argmin.cu, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load()
        return _lib


def _check(name: str, x: Tensor, widths=(3,)):
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] not in widths:
        raise ValueError(
            f"nn_argmin: {name} must be float32 [n,{'|'.join(map(str, widths))}], "
            f"got {x.dtype} {tuple(x.shape)}"
        )


def pack_points(points: Tensor) -> Tensor:
    """The [N,4] f32 layout the kernel reads (x, y, z, 0) of points [N,3]."""
    _check("points", points)
    return torch.nn.functional.pad(points, (0, 1)).contiguous()


def nn_argmin_reference(queries: Tensor, points: Tensor) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version: (index int32 [Q], distance f32 [Q]) of each
    query's nearest point, by a blocked brute force on (q-p).(q-p); ties
    resolve to the lowest index. `points` is [N,3] or the packed [N,4]."""
    _check("queries", queries)
    _check("points", points, (3, 4))
    points = points[:, :3]
    Q, N = queries.shape[0], points.shape[0]
    block = max(1, min(N, (1 << 24) // max(Q, 1)))
    best_d = torch.full((Q,), float("inf"), dtype=torch.float32, device=queries.device)
    best_i = torch.zeros((Q,), dtype=torch.int64, device=queries.device)
    for start in range(0, N, block):
        diff = queries[:, None, :] - points[None, start : start + block, :]
        d = torch.sum(diff * diff, dim=-1)  # [Q,b]
        bd, bi = torch.min(d, dim=1)
        upd = bd < best_d
        best_d = torch.where(upd, bd, best_d)
        best_i = torch.where(upd, bi + start, best_i)
    return best_i.to(torch.int32), torch.sqrt(torch.clamp(best_d, min=0.0))


def launch_plan(Q: int, N: int, sms: int, tiles, few_max: int = FEW_QUERIES_MAX,
                blocks_per_sm: int = 2) -> tuple[int, int, int]:
    """(mode, chunk, splits) of a launch: which scan, and how the map is
    split over the grid so that about `blocks_per_sm` blocks per SM are in
    flight. `tiles[mode]` is the scan's (queries a block, split granule);
    chunk is a multiple of the granule and splits * chunk >= N."""
    mode = 1 if Q <= few_max else 0
    block_queries, granule = tiles[mode]
    qblocks = -(-Q // block_queries)
    splits = max(1, min(-(-N // granule), -(-blocks_per_sm * sms // qblocks)))
    chunk = -(-(-(-N // splits)) // granule) * granule
    return mode, chunk, -(-N // chunk)


def launch(lib: ctypes.CDLL, queries: Tensor, points4: Tensor, plan) -> tuple[Tensor, Tensor]:
    """One launch of `lib`'s kernel on checked CUDA tensors (queries [Q,3],
    the packed map [N,4]) under `plan` = (mode, chunk, splits)."""
    dev = queries.device
    Q, N = queries.shape[0], points4.shape[0]
    mode, chunk, splits = plan
    # outputs and scratch in one allocation: index, distance, then the
    # splits' partial distances and indices, Q words each
    buf = torch.empty((2 + 2 * splits, Q), dtype=torch.int32, device=dev)
    base, row = buf.data_ptr(), 4 * Q
    with on_device(dev):
        err = lib.nn_argmin_launch(
            queries.data_ptr(), Q, points4.data_ptr(), N, mode, chunk, splits,
            base + 2 * row, base + (2 + splits) * row, base, base + row,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"nn_argmin kernel launch failed: cudaError {err}")
    return buf[0], buf.view(torch.float32)[1]


def nn_argmin(queries: Tensor, points: Tensor) -> tuple[Tensor, Tensor]:
    """(index int32 [Q], distance f32 [Q]) of each query's nearest map point.
    `points` is [N,3] or, saving the repack on every call, `pack_points`'s
    [N,4].

    CUDA tensors launch the hand kernel (counted in `nn_argmin.launches`,
    the largest query count in `nn_argmin.max_queries`); CPU tensors take
    the plain version. Raises on anything else."""
    _check("queries", queries)
    _check("points", points, (3, 4))
    if queries.device != points.device:
        raise ValueError(f"nn_argmin: queries on {queries.device}, points on {points.device}")
    dev = queries.device
    if dev.type == "cpu":
        return nn_argmin_reference(queries, points)
    if dev.type != "cuda":
        raise ValueError(f"nn_argmin: unsupported device {dev}")
    if not (queries.is_contiguous() and points.is_contiguous()):
        raise ValueError("nn_argmin: inputs must be contiguous")
    Q, N = queries.shape[0], points.shape[0]
    if N == 0:
        raise ValueError("nn_argmin: empty map")
    if Q == 0:
        return (torch.empty((0,), dtype=torch.int32, device=dev),
                torch.empty((0,), dtype=torch.float32, device=dev))
    if points.shape[1] == 3:
        points = pack_points(points)
    if points.data_ptr() % 16:
        raise ValueError("nn_argmin: the packed map must be 16-byte aligned")
    lib = build()
    out = launch(lib, queries, points, launch_plan(Q, N, sm_count(dev), lib.tiles))
    nn_argmin.launches += 1
    nn_argmin.max_queries = max(nn_argmin.max_queries, Q)
    return out


nn_argmin.launches = 0
nn_argmin.max_queries = 0
