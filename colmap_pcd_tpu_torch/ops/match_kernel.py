"""Top-2 descriptor matching: the hand-written CUDA kernel
(csrc/match_top2.cu) and its plain PyTorch version.

Replaces the Pallas TPU kernel `match_top2` (colmap_pcd_tpu/ops/
pallas_kernels.py:77, pallas_call :94). For each row of d1 against the
columns of d2 (one image pair per leading batch item) it gives the best
similarity, the second best and the column of the best, with invalid
columns counted as -2 and ties going to the lowest column. `match_top2`
launches the kernel for CUDA tensors and raises if it cannot; only CPU
tensors take `match_top2_reference`. The kernel is built at its first
launch by ops/cuda_build.py; importing this module needs no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .cuda_build import CSRC_DIR, build_library

Tensor = torch.Tensor

SOURCE = os.path.join(CSRC_DIR, "match_top2.cu")

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
        lib.match_top2_launch.argtypes = [vp, ci, vp, ci, vp, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp]
        lib.match_top2_launch.restype = ci
        for name in ("match_top2_tile_rows", "match_top2_tile_cols", "match_top2_width"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ci
        _lib = lib
        return lib


def _best2(sim: Tensor, valid2: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Top-2 similarities along the last axis of sim [..., N1, N2] with the
    columns where valid2 [..., N2] <= 0 masked to -2: (s1, s2, idx int64).
    Two max passes, as the JAX package's `_best2`; argmax takes the first
    of equal maxima."""
    sim = torch.where(valid2[..., None, :] > 0, sim, torch.full_like(sim, -2.0))
    idx = torch.argmax(sim, dim=-1)
    s1 = torch.gather(sim, -1, idx[..., None])[..., 0]
    cols = torch.arange(sim.shape[-1], device=sim.device)
    s2 = torch.amax(torch.where(cols == idx[..., None], torch.full_like(sim, -2.0), sim), dim=-1)
    return s1, s2, idx


def _check(d1: Tensor, d2: Tensor, valid2: Tensor):
    if d1.dtype != torch.float32 or d2.dtype != torch.float32:
        raise ValueError(f"match_top2: descriptors must be float32, got {d1.dtype}, {d2.dtype}")
    if d1.dim() not in (2, 3) or d2.dim() != d1.dim() or d1.shape[-1] != d2.shape[-1]:
        raise ValueError(f"match_top2: d1 {tuple(d1.shape)} and d2 {tuple(d2.shape)} must be [B,N,D] or [N,D]")
    if d1.shape[:-2] != d2.shape[:-2] or valid2.shape != d2.shape[:-1]:
        raise ValueError(
            f"match_top2: batch/valid mismatch: d1 {tuple(d1.shape)}, d2 {tuple(d2.shape)}, "
            f"valid2 {tuple(valid2.shape)}"
        )
    if d2.shape[-2] == 0:
        raise ValueError("match_top2: d2 has no columns")
    if not (d1.device == d2.device == valid2.device):
        raise ValueError(f"match_top2: inputs on {d1.device}, {d2.device}, {valid2.device}")


def match_top2_reference(d1: Tensor, d2: Tensor, valid2: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version: an f32 matmul and `_best2`, blocked over the
    pairs so that a block's similarity matrix stays under 256 MB (one pair
    at 8192 x 8192). Returns (s1 f32, s2 f32, idx int32), each [..., N1]."""
    _check(d1, d2, valid2)
    if d1.dim() == 2:
        return tuple(x[0] for x in match_top2_reference(d1[None], d2[None], valid2[None]))
    B, N1, N2 = d1.shape[0], d1.shape[1], d2.shape[1]
    block = max(1, (1 << 26) // max(N1 * N2, 1))
    outs = []
    for b0 in range(0, B, block):
        sim = d1[b0 : b0 + block] @ d2[b0 : b0 + block].mT
        s1, s2, idx = _best2(sim, valid2[b0 : b0 + block])
        outs.append((s1, s2, idx.to(torch.int32)))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def match_top2(d1: Tensor, d2: Tensor, valid2: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """(s1 f32, s2 f32, idx int32) [..., N1] of d1 [B?, N1, 128] against
    d2 [B?, N2, 128] with valid2 [B?, N2] (float, > 0 = valid column).

    CUDA tensors launch the hand kernel (counted in `match_top2.launches`);
    CPU tensors take the plain version. Raises on anything else."""
    _check(d1, d2, valid2)
    dev = d1.device
    if dev.type == "cpu":
        return match_top2_reference(d1, d2, valid2)
    if dev.type != "cuda":
        raise ValueError(f"match_top2: unsupported device {dev}")
    if d1.dim() == 2:
        return tuple(x[0] for x in match_top2(d1[None], d2[None], valid2[None]))
    lib = build()
    if d1.shape[-1] != lib.match_top2_width():
        raise ValueError(f"match_top2: the kernel takes {lib.match_top2_width()}-wide descriptors")
    d1 = d1.contiguous()
    d2 = d2.contiguous()
    valid2 = valid2.to(torch.float32).contiguous()
    if d1.data_ptr() % 16 or d2.data_ptr() % 16:
        raise ValueError("match_top2: descriptors must be 16-byte aligned")
    B, N1, N2 = d1.shape[0], d1.shape[1], d2.shape[1]
    s1 = torch.empty((B, N1), dtype=torch.float32, device=dev)
    s2 = torch.empty((B, N1), dtype=torch.float32, device=dev)
    idx = torch.empty((B, N1), dtype=torch.int32, device=dev)
    if B == 0 or N1 == 0:
        return s1, s2, idx
    # split the columns across blocks until ~4 blocks per SM are in flight
    tq, tn = lib.match_top2_tile_rows(), lib.match_top2_tile_cols()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = B * -(-N1 // tq)
    splits = max(1, min(-(-N2 // tn), -(-4 * sms // blocks)))
    chunk = -(-(-(-N2 // splits)) // tn) * tn
    splits = -(-N2 // chunk)
    part_b1 = torch.empty((splits, B, N1), dtype=torch.float32, device=dev)
    part_i1 = torch.empty((splits, B, N1), dtype=torch.int32, device=dev)
    part_b2 = torch.empty((splits, B, N1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.match_top2_launch(
            d1.data_ptr(), N1, d2.data_ptr(), N2, valid2.data_ptr(), B, chunk, splits,
            part_b1.data_ptr(), part_i1.data_ptr(), part_b2.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), idx.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"match_top2 kernel launch failed: cudaError {err}")
    with _lock:
        match_top2.launches += 1
    return s1, s2, idx


match_top2.launches = 0
