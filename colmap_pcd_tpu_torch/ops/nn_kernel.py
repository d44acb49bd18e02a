"""Exact 1-NN of queries among the lidar map points: the hand-written CUDA
kernel (csrc/nn_argmin.cu) and its plain PyTorch version.

Replaces the Pallas TPU kernel `nn_argmin` (colmap_pcd_tpu/ops/
pallas_kernels.py:175). `nn_argmin` launches the kernel for CUDA tensors and
raises if it cannot; only CPU tensors take `nn_argmin_reference`. The kernel
is built at its first launch by ops/cuda_build.py; importing this module
needs no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .cuda_build import CSRC_DIR, build_library

Tensor = torch.Tensor

SOURCE = os.path.join(CSRC_DIR, "nn_argmin.cu")

_lock = threading.Lock()
_lib = None


def build() -> ctypes.CDLL:
    """Compile (if the source changed) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_library(SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nn_argmin_launch.argtypes = [vp, ci, vp, ci, ci, ci, vp, vp, vp, vp, vp]
        lib.nn_argmin_launch.restype = ci
        lib.nn_argmin_tile_points.argtypes = []
        lib.nn_argmin_tile_points.restype = ci
        _lib = lib
        return lib


def _check(name: str, x: Tensor):
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"nn_argmin: {name} must be float32 [n,3], got {x.dtype} {tuple(x.shape)}")


def nn_argmin_reference(queries: Tensor, points: Tensor) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version: (index int32 [Q], distance f32 [Q]) of each
    query's nearest point, by a blocked brute force on (q-p).(q-p); ties
    resolve to the lowest index."""
    _check("queries", queries)
    _check("points", points)
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


def nn_argmin(queries: Tensor, points: Tensor) -> tuple[Tensor, Tensor]:
    """(index int32 [Q], distance f32 [Q]) of each query's nearest map point.

    CUDA tensors launch the hand kernel (counted in `nn_argmin.launches`);
    CPU tensors take the plain version. Raises on anything else."""
    _check("queries", queries)
    _check("points", points)
    if queries.device != points.device:
        raise ValueError(f"nn_argmin: queries on {queries.device}, points on {points.device}")
    if queries.device.type == "cpu":
        return nn_argmin_reference(queries, points)
    if queries.device.type != "cuda":
        raise ValueError(f"nn_argmin: unsupported device {queries.device}")
    if not (queries.is_contiguous() and points.is_contiguous()):
        raise ValueError("nn_argmin: inputs must be contiguous")
    Q, N = queries.shape[0], points.shape[0]
    if N == 0:
        raise ValueError("nn_argmin: empty map")
    dev = queries.device
    out_idx = torch.empty((Q,), dtype=torch.int32, device=dev)
    out_dist = torch.empty((Q,), dtype=torch.float32, device=dev)
    if Q == 0:
        return out_idx, out_dist
    lib = build()
    tile = lib.nn_argmin_tile_points()
    # split the map across blocks until ~4 blocks per SM are in flight
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    qblocks = -(-Q // 256)
    splits = max(1, min(-(-N // tile), -(-4 * sms // qblocks)))
    chunk = -(-(-(-N // splits)) // tile) * tile
    splits = -(-N // chunk)
    part_d = torch.empty((splits, Q), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits, Q), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nn_argmin_launch(
            queries.data_ptr(), Q, points.data_ptr(), N, chunk, splits,
            part_d.data_ptr(), part_i.data_ptr(), out_idx.data_ptr(),
            out_dist.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"nn_argmin kernel launch failed: cudaError {err}")
    nn_argmin.launches += 1
    return out_idx, out_dist


nn_argmin.launches = 0
