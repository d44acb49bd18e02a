"""Top-2 descriptor matching: the hand-written CUDA kernels and their
plain PyTorch versions.

Both replace the Pallas TPU kernel `match_top2` (colmap_pcd_tpu/ops/
pallas_kernels.py:77, pallas_call :94). For each row of d1 against the
columns of d2 (one image pair per leading batch item) they give the best
similarity, the second best and the column of the best, with invalid
columns counted as -2 and ties going to the lowest column.

  * `match_top2_u8` (csrc/match_top2_u8.cu) takes the uint8 descriptors the
    database holds and their f32 inverse norms, and forms the products on
    the integer tensor cores; the similarity float(dot) * (inv_row *
    inv_col) is exact in the dot product, so kernel and plain version agree
    to the last bit. The matcher's path.
  * `match_top2` (csrc/match_top2.cu) takes L2-normalized f32 descriptors
    and forms the products with f32 FMAs in the plain product's order. The
    route for float descriptors. `match_top2_cross` is the same launch
    with the cross-check's best row of every column formed from the same
    similarities.

Each wrapper launches its kernel for CUDA tensors and raises if it cannot;
only CPU tensors take the plain version. A kernel is built at its first
launch by ops/cuda_build.py; importing this module needs no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .cuda_build import CSRC_DIR, build_library, on_device, sm_count

Tensor = torch.Tensor

SOURCE = os.path.join(CSRC_DIR, "match_top2.cu")
SOURCE_U8 = os.path.join(CSRC_DIR, "match_top2_u8.cu")

_lock = threading.Lock()
_lib = None
_lib_u8 = None


def load(source: str = SOURCE) -> ctypes.CDLL:
    """Compile (if the source changed), load and bind one library of the
    float kernel; `build` keeps the one of the package's own source."""
    lib = build_library(source)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.match_top2_launch.argtypes = [vp, ci, vp, ci, vp, vp, ci, ci, ci] + [vp] * 9
    lib.match_top2_launch.restype = ci
    for name in ("match_top2_tile_rows", "match_top2_tile_cols", "match_top2_width"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ci
    lib.match_top2_key_sentinel.argtypes = []
    lib.match_top2_key_sentinel.restype = ctypes.c_longlong
    return lib


def build() -> ctypes.CDLL:
    """The library of csrc/match_top2.cu, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load()
        return _lib


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


def _best_rows(sim: Tensor, valid1: Tensor) -> Tensor:
    """The cross-check's best row of every column of sim [..., N1, N2] with
    the rows where valid1 [..., N1] <= 0 masked to -2: [..., N2] int64, the
    first of equal maxima."""
    return torch.argmax(torch.where(valid1[..., :, None] > 0, sim, torch.full_like(sim, -2.0)), dim=-2)


def _check(d1: Tensor, d2: Tensor, valid2: Tensor, valid1: Tensor | None = None):
    if d1.dtype != torch.float32 or d2.dtype != torch.float32:
        raise ValueError(f"match_top2: descriptors must be float32, got {d1.dtype}, {d2.dtype}")
    if d1.dim() not in (2, 3) or d2.dim() != d1.dim() or d1.shape[-1] != d2.shape[-1]:
        raise ValueError(f"match_top2: d1 {tuple(d1.shape)} and d2 {tuple(d2.shape)} must be [B,N,D] or [N,D]")
    if (d1.shape[:-2] != d2.shape[:-2] or valid2.shape != d2.shape[:-1]
            or (valid1 is not None and valid1.shape != d1.shape[:-1])):
        raise ValueError(
            f"match_top2: batch/valid mismatch: d1 {tuple(d1.shape)}, d2 {tuple(d2.shape)}, "
            f"valid2 {tuple(valid2.shape)}, valid1 {None if valid1 is None else tuple(valid1.shape)}"
        )
    if d2.shape[-2] == 0:
        raise ValueError("match_top2: d2 has no columns")
    if not (d1.device == d2.device == valid2.device) or (valid1 is not None and valid1.device != d1.device):
        raise ValueError(f"match_top2: inputs on {d1.device}, {d2.device}, {valid2.device}")


def _blocked(d1: Tensor, d2: Tensor, fn) -> tuple:
    """fn(pair slice) over blocks of pairs whose similarity matrix stays
    under 256 MB (one pair at 8192 x 8192), the results concatenated along
    the pairs."""
    B, N1, N2 = d1.shape[0], d1.shape[1], d2.shape[1]
    block = max(1, (1 << 26) // max(N1 * N2, 1))
    outs = [fn(slice(b0, b0 + block)) for b0 in range(0, B, block)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def match_top2_reference(d1: Tensor, d2: Tensor, valid2: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version: an f32 matmul and `_best2`, blocked over the
    pairs. Returns (s1 f32, s2 f32, idx int32), each [..., N1]."""
    _check(d1, d2, valid2)
    if d1.dim() == 2:
        return tuple(x[0] for x in match_top2_reference(d1[None], d2[None], valid2[None]))

    def block(sl):
        s1, s2, idx = _best2(d1[sl] @ d2[sl].mT, valid2[sl])
        return s1, s2, idx.to(torch.int32)

    return _blocked(d1, d2, block)


def match_top2_cross_reference(d1: Tensor, d2: Tensor, valid1: Tensor, valid2: Tensor):
    """Plain PyTorch version of `match_top2_cross`: the f32 matmul, `_best2`
    and the argmax over the valid rows of every column, blocked over the
    pairs. Returns (s1 f32, s2 f32, idx int32) [..., N1] and back int32
    [..., N2]."""
    _check(d1, d2, valid2, valid1)
    if d1.dim() == 2:
        return tuple(x[0] for x in match_top2_cross_reference(d1[None], d2[None], valid1[None], valid2[None]))

    def block(sl):
        sim = d1[sl] @ d2[sl].mT
        s1, s2, idx = _best2(sim, valid2[sl])
        return s1, s2, idx.to(torch.int32), _best_rows(sim, valid1[sl]).to(torch.int32)

    return _blocked(d1, d2, block)


def split_columns(N2: int, tile: int, wanted: int) -> tuple[int, int]:
    """(chunk, splits): the N2 columns in about `wanted` splits; chunk is a
    multiple of the column tile and splits * chunk >= N2."""
    splits = max(1, min(-(-N2 // tile), wanted))
    chunk = -(-(-(-N2 // splits)) // tile) * tile
    return chunk, -(-N2 // chunk)


def _outputs(dev, B: int, N1: int, parts: int):
    """(s1 f32, s2 f32, idx int32, three scratch addresses) from one
    allocation: the outputs [B, N1] and `parts` partial (best, column,
    second best) of the column splits."""
    n = B * N1
    buf = torch.empty((3 + 3 * parts, B, N1), dtype=torch.int32, device=dev)
    fbuf = buf.view(torch.float32)
    base = buf.data_ptr() + 12 * n
    return fbuf[0], fbuf[1], buf[2], tuple(base + 4 * n * parts * k for k in range(3))


def match_top2(d1: Tensor, d2: Tensor, valid2: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """(s1 f32, s2 f32, idx int32) [..., N1] of d1 [B?, N1, 128] against
    d2 [B?, N2, 128] with valid2 [B?, N2] (float, > 0 = valid column).

    CUDA tensors launch the hand kernel (counted in `match_top2.launches`);
    CPU tensors take the plain version. Raises on anything else."""
    _check(d1, d2, valid2)
    if d1.device.type == "cpu":
        return match_top2_reference(d1, d2, valid2)
    return _launched(d1, d2, valid2, None)


def match_top2_cross(d1: Tensor, d2: Tensor, valid1: Tensor, valid2: Tensor):
    """`match_top2` and the cross-check in one launch: (s1 f32, s2 f32, idx
    int32) [..., N1] and back int32 [..., N2], the best row of every column
    among the rows with valid1 > 0 (the lowest of equals; row 0 when no row
    is valid), from the same similarities as idx. For L2-normalized rows
    this is the plain version's argmax with invalid rows at -2.

    CUDA tensors launch the hand kernel (counted in `match_top2.launches`);
    CPU tensors take the plain version. Raises on anything else."""
    _check(d1, d2, valid2, valid1)
    if d1.device.type == "cpu":
        return match_top2_cross_reference(d1, d2, valid1, valid2)
    return _launched(d1, d2, valid2, valid1)


def _launched(d1: Tensor, d2: Tensor, valid2: Tensor, valid1: Tensor | None):
    """`launch` of the package's kernel on checked tensors, [N, D] ones as a
    batch of one, counted in `match_top2.launches`."""
    if d1.device.type != "cuda":
        raise ValueError(f"match_top2: unsupported device {d1.device}")
    if d1.dim() == 2:
        args = (d1[None], d2[None], valid2[None], None if valid1 is None else valid1[None])
        return tuple(x[0] for x in _launched(*args))
    out = launch(build(), d1, d2, valid2, valid1)
    with _lock:
        match_top2.launches += 1
    return out


def launch(lib: ctypes.CDLL, d1: Tensor, d2: Tensor, valid2: Tensor, valid1: Tensor | None = None):
    """One launch of `lib`'s float kernel on checked, batched CUDA tensors:
    (s1, s2, idx), and back when valid1 is given (the cross-check's column
    bests)."""
    dev = d1.device
    if d1.shape[-1] != lib.match_top2_width():
        raise ValueError(f"match_top2: the kernel takes {lib.match_top2_width()}-wide descriptors")
    d1 = d1.contiguous()
    d2 = d2.contiguous()
    valid2 = valid2.to(torch.float32).contiguous()
    if d1.data_ptr() % 16 or d2.data_ptr() % 16:
        raise ValueError("match_top2: descriptors must be 16-byte aligned")
    B, N1, N2 = d1.shape[0], d1.shape[1], d2.shape[1]
    back = keys = None
    if B == 0 or N1 == 0:  # no row: back is row 0 for every column
        back = () if valid1 is None else (torch.zeros((B, N2), dtype=torch.int32, device=dev),)
        return _outputs(dev, B, N1, 0)[:3] + back
    if valid1 is not None:
        valid1 = valid1.to(torch.float32).contiguous()
        back = torch.empty((B, N2), dtype=torch.int32, device=dev)
        keys = torch.full((B, N2), lib.match_top2_key_sentinel(), dtype=torch.int64, device=dev)
    # one block runs per SM at a time: split the columns while the row
    # blocks are fewer than two waves
    blocks = B * -(-N1 // lib.match_top2_tile_rows())
    chunk, splits = split_columns(N2, lib.match_top2_tile_cols(), 2 * sm_count(dev) // blocks)
    s1, s2, idx, part = _outputs(dev, B, N1, splits if splits > 1 else 0)
    with on_device(dev):
        err = lib.match_top2_launch(
            d1.data_ptr(), N1, d2.data_ptr(), N2, None if valid1 is None else valid1.data_ptr(),
            valid2.data_ptr(), B, chunk, splits, *part, s1.data_ptr(), s2.data_ptr(), idx.data_ptr(),
            None if keys is None else keys.data_ptr(), None if back is None else back.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"match_top2 kernel launch failed: cudaError {err}")
    return (s1, s2, idx) if back is None else (s1, s2, idx, back)


match_top2.launches = 0


# --------------------------------------------------------------------------
# uint8 descriptors on the integer tensor cores


def load_u8(source: str = SOURCE_U8) -> ctypes.CDLL:
    """Compile (if the source changed), load and bind one library of the
    uint8 kernel; `build_u8` keeps the one of the package's own source."""
    lib = build_library(source)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.match_top2_u8_launch.argtypes = [vp, ci, vp, ci, vp, vp, vp, vp, ci, ci, ci] + [vp] * 7
    lib.match_top2_u8_launch.restype = ci
    for name in ("match_top2_u8_tile_rows", "match_top2_u8_tile_cols", "match_top2_u8_width"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ci
    return lib


def build_u8() -> ctypes.CDLL:
    """The library of csrc/match_top2_u8.cu, built at the first call."""
    global _lib_u8
    with _lock:
        if _lib_u8 is None:
            _lib_u8 = load_u8()
        return _lib_u8


def inverse_norms(d_u8: Tensor) -> Tensor:
    """f32 1 / |row| of uint8 descriptors [..., N, D]; 0 for a zero row (the
    matcher's padding), whose similarity to anything is then 0."""
    norm = torch.linalg.norm(d_u8.to(torch.float32), dim=-1)
    return torch.where(norm > 0, 1.0 / norm, torch.zeros_like(norm))


def _check_u8(d1, d2, inv1, inv2, valid2, valid1):
    if d1.dtype != torch.uint8 or d2.dtype != torch.uint8:
        raise ValueError(f"match_top2_u8: descriptors must be uint8, got {d1.dtype}, {d2.dtype}")
    if d1.dim() not in (2, 3) or d2.dim() != d1.dim() or d1.shape[-1] != d2.shape[-1]:
        raise ValueError(f"match_top2_u8: d1 {tuple(d1.shape)} and d2 {tuple(d2.shape)} must be [B,N,D] or [N,D]")
    if d1.shape[-1] > 256:  # 255^2 * 256 < 2^24: the dot product stays exact in f32
        raise ValueError("match_top2_u8: descriptors wider than 256 would not be exact")
    rows, cols = d1.shape[:-1], d2.shape[:-1]
    if (rows[:-1] != cols[:-1] or inv1.shape != rows or inv2.shape != cols or valid2.shape != cols
            or (valid1 is not None and valid1.shape != rows)):
        raise ValueError(
            f"match_top2_u8: shape mismatch: d1 {tuple(d1.shape)}, d2 {tuple(d2.shape)}, inv1 "
            f"{tuple(inv1.shape)}, inv2 {tuple(inv2.shape)}, valid2 {tuple(valid2.shape)}, valid1 "
            f"{None if valid1 is None else tuple(valid1.shape)}"
        )
    if inv1.dtype != torch.float32 or inv2.dtype != torch.float32:
        raise ValueError("match_top2_u8: inverse norms must be float32")
    if cols[-1] == 0:
        raise ValueError("match_top2_u8: d2 has no columns")
    dev = d1.device
    if (d2.device != dev or inv1.device != dev or inv2.device != dev or valid2.device != dev
            or (valid1 is not None and valid1.device != dev)):
        raise ValueError("match_top2_u8: inputs on different devices")


def similarity_u8(d1: Tensor, d2: Tensor, inv1: Tensor, inv2: Tensor) -> Tensor:
    """The similarity matrix [..., N1, N2] as the uint8 kernel forms it:
    float(dot) * (inv_row * inv_col). The f32 matmul of uint8-valued floats
    is exact (every partial sum is an integer below 2^24), and the product
    of the two inverse norms commutes, so the transposed call gives the
    transposed matrix bit for bit."""
    dot = d1.to(torch.float32) @ d2.to(torch.float32).mT
    return dot * (inv1[..., :, None] * inv2[..., None, :])


def match_top2_u8_reference(d1, d2, inv1, inv2, valid2, valid1=None):
    """Plain PyTorch version of `match_top2_u8`, blocked over the pairs like
    `match_top2_reference`. Returns (s1 f32, s2 f32, idx int32) [..., N1]."""
    _check_u8(d1, d2, inv1, inv2, valid2, valid1)
    if d1.dim() == 2:
        args = (d1, d2, inv1, inv2, valid2, valid1)
        return tuple(x[0] for x in match_top2_u8_reference(*(None if a is None else a[None] for a in args)))

    def block(sl):
        s1, s2, idx = _best2(similarity_u8(d1[sl], d2[sl], inv1[sl], inv2[sl]), valid2[sl])
        return s1, s2, idx.to(torch.int32)

    s1, s2, idx = _blocked(d1, d2, block)
    if valid1 is not None:
        ok = valid1 > 0
        s1 = torch.where(ok, s1, torch.full_like(s1, -2.0))
        s2 = torch.where(ok, s2, torch.full_like(s2, -2.0))
        idx = torch.where(ok, idx, torch.zeros_like(idx))
    return s1, s2, idx


def match_top2_u8(d1, d2, inv1, inv2, valid2, valid1=None):
    """(s1 f32, s2 f32, idx int32) [..., N1] of uint8 descriptors d1
    [B?, N1, 128] against d2 [B?, N2, 128], with their f32 inverse norms
    inv1 [B?, N1], inv2 [B?, N2] (`inverse_norms`) and valid2 [B?, N2]
    (float, > 0 = valid column, others count as -2). With valid1 [B?, N1],
    rows that are not valid return (-2, -2, 0) and row tiles without a
    valid row cost nothing.

    CUDA tensors launch the tensor-core kernel (counted in
    `match_top2_u8.launches`, the largest of N1 and N2 in
    `match_top2_u8.max_cap`); CPU tensors take the plain version. Raises on
    anything else."""
    _check_u8(d1, d2, inv1, inv2, valid2, valid1)
    dev = d1.device
    if dev.type == "cpu":
        return match_top2_u8_reference(d1, d2, inv1, inv2, valid2, valid1)
    if dev.type != "cuda":
        raise ValueError(f"match_top2_u8: unsupported device {dev}")
    if d1.dim() == 2:
        args = (d1, d2, inv1, inv2, valid2, valid1)
        return tuple(x[0] for x in match_top2_u8(*(None if a is None else a[None] for a in args)))
    if d1.shape[0] == 0 or d1.shape[1] == 0:
        return _outputs(dev, d1.shape[0], d1.shape[1], 0)[:3]
    out = launch_u8(build_u8(), d1, d2, inv1, inv2, valid2, valid1)
    with _lock:
        match_top2_u8.launches += 1
        match_top2_u8.max_cap = max(match_top2_u8.max_cap, d1.shape[1], d2.shape[1])
    return out


def launch_u8(lib: ctypes.CDLL, d1, d2, inv1, inv2, valid2, valid1=None):
    """One launch of `lib`'s uint8 kernel on checked, batched, non-empty CUDA
    tensors."""
    dev = d1.device
    if d1.shape[-1] != lib.match_top2_u8_width():
        raise ValueError(f"match_top2_u8: the kernel takes {lib.match_top2_u8_width()}-wide descriptors")
    d1, d2, inv1, inv2 = (x.contiguous() for x in (d1, d2, inv1, inv2))
    valid2 = valid2.to(torch.float32).contiguous()
    if valid1 is not None:
        valid1 = valid1.to(torch.float32).contiguous()
    if d1.data_ptr() % 16 or d2.data_ptr() % 16:
        raise ValueError("match_top2_u8: descriptors must be 16-byte aligned")
    B, N1, N2 = d1.shape[0], d1.shape[1], d2.shape[1]
    # one block runs per SM at a time: split the columns only while the row
    # blocks are fewer than two waves (one split needs no reduce kernel)
    blocks = B * -(-N1 // lib.match_top2_u8_tile_rows())
    chunk, splits = split_columns(N2, lib.match_top2_u8_tile_cols(), 2 * sm_count(dev) // blocks)
    s1, s2, idx, part = _outputs(dev, B, N1, splits if splits > 1 else 0)
    with on_device(dev):
        err = lib.match_top2_u8_launch(
            d1.data_ptr(), N1, d2.data_ptr(), N2, inv1.data_ptr(), inv2.data_ptr(),
            None if valid1 is None else valid1.data_ptr(), valid2.data_ptr(), B, chunk, splits,
            *part, s1.data_ptr(), s2.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"match_top2_u8 kernel launch failed: cudaError {err}")
    return s1, s2, idx


match_top2_u8.launches = 0
match_top2_u8.max_cap = 0
