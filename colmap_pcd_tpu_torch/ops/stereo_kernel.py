"""The plane sweep of one reference view as one launch of the hand-written
CUDA kernel csrc/plane_sweep.cu.

Replaces no Pallas kernel (the JAX package's sweep is plain jnp); it is the
CUDA route of ops/stereo.plane_sweep, whose plain PyTorch route serves CPU
tensors. ops/stereo.py prepares what depends on the reference alone or on
a handful of numbers (the homographies, the bilateral weights and the
reference's window terms, the inverse intrinsics) as the plain route does,
so the kernel reads the same floats; `plane_sweep_cuda` checks and launches.
The kernel is built at its first launch by ops/cuda_build.py; importing
this module needs no CUDA toolkit. It takes window radii 1 to 32, COLMAP's
largest.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from .cuda_build import CSRC_DIR, build_library, on_device

Tensor = torch.Tensor

SOURCE = os.path.join(CSRC_DIR, "plane_sweep.cu")

_lock = threading.Lock()
_lib = None


def load(source: str = SOURCE) -> ctypes.CDLL:
    """Compile (if the source changed), load and bind one library of the
    kernel; `build` keeps the one of the package's own source."""
    lib = build_library(source)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.plane_sweep_launch.argtypes = [vp] * 10 + [ci] * 9 + [cf] * 4 + [vp] * 3
    lib.plane_sweep_launch.restype = ci
    for name in ("plane_sweep_max_radius", "plane_sweep_max_top_k"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ci
    lib.max_radius = lib.plane_sweep_max_radius()
    lib.max_top_k = lib.plane_sweep_max_top_k()
    return lib


def build() -> ctypes.CDLL:
    """The kernel library of csrc/plane_sweep.cu, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load()
        return _lib


class Geometric:
    """The geometric pass's inputs: the sources' depth maps [S, Hs, Ws],
    their inverse intrinsics [S, 3, 3], the relative poses R [S, 3, 3] and
    t [S, 3] (reference camera -> source camera), the reference intrinsics
    [3, 3], and the term's weight and cap."""

    def __init__(self, src_depths, K_src_inv, R_rel, t_rel, K_ref, regularizer: float, max_cost: float):
        self.src_depths, self.regularizer, self.max_cost = src_depths, regularizer, max_cost
        S = R_rel.shape[0]
        # the kernel reads [S, 21] (K_src^-1, R, t a source) then K_ref
        self.packed = torch.cat([
            torch.cat([K_src_inv.reshape(S, 9), R_rel.reshape(S, 9), t_rel.reshape(S, 3)], 1).reshape(-1),
            K_ref.reshape(-1),
        ]).contiguous()


def _require(ok: bool, message: str):
    if not ok:
        raise ValueError(f"plane_sweep_cuda: {message}")


def plane_sweep_cuda(
    ref: Tensor,  # [H, W]
    srcs: Tensor,  # [S, Hs, Ws]
    homographies: Tensor,  # [D, S, 3, 3] reference pixel -> source pixel
    depths: Tensor,  # [D]
    radius: int,
    weights: Tensor | None,  # [(2r+1)^2, H, W] bilateral weights; None: the box window
    ref_terms: tuple,  # bilateral (Wsum, mu_r, var_r), box (s_r, s_rr), each [H, W]
    k: int,  # sources a pixel's cost averages
    big: float,  # the running best's first cost
    geom: Geometric | None = None,
) -> tuple[Tensor, Tensor]:
    """(best depth [H, W], its photometric cost [H, W]) of one view-pass in
    one launch, counted in `plane_sweep_cuda.launches`. Raises on a tensor
    that is not a contiguous float32 CUDA tensor on the reference's device,
    on a shape it does not take, on a radius or k above what the kernel was
    built for, and on a failed launch."""
    H, W = ref.shape
    S, Hs, Ws = srcs.shape
    D = depths.shape[0]
    bilateral = weights is not None
    named = {"ref": ref, "srcs": srcs, "homographies": homographies, "depths": depths}
    named.update({f"ref_terms[{i}]": t for i, t in enumerate(ref_terms)})
    shapes = {"homographies": (D, S, 3, 3), "depths": (D,)}
    shapes.update({f"ref_terms[{i}]": (H, W) for i in range(len(ref_terms))})
    if bilateral:
        named["weights"] = weights
        shapes["weights"] = ((2 * radius + 1) ** 2, H, W)
    if geom is not None:
        named.update(src_depths=geom.src_depths, geom=geom.packed)
        shapes.update(src_depths=(S, Hs, Ws), geom=(21 * S + 9,))
    _require(len(ref_terms) == (3 if bilateral else 2), f"{len(ref_terms)} reference terms")
    for name, t in named.items():
        _require(t.dtype == torch.float32, f"{name} must be float32, got {t.dtype}")
        _require(name not in shapes or tuple(t.shape) == shapes[name],
                 f"{name} has shape {tuple(t.shape)}, expected {shapes.get(name)}")
    _require(min(H, W, S, Hs, Ws, D) >= 1, f"empty sweep: view {H}x{W}, sources {tuple(srcs.shape)}, {D} depths")
    _require(1 <= k <= S, f"k = {k} with {S} sources")
    dev = ref.device
    for name, t in named.items():
        _require(t.device == dev, f"{name} on {t.device}, the reference on {dev}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(dev.type == "cuda", f"tensors on {dev}: the kernel runs on CUDA only")
    lib = build()
    _require(1 <= radius <= lib.max_radius,
             f"window radius {radius}: the kernel is built for radii 1 to {lib.max_radius}")
    _require(k <= lib.max_top_k, f"k = {k}: the kernel keeps at most {lib.max_top_k} sources")
    best_depth = torch.empty((H, W), dtype=torch.float32, device=dev)
    best_photo = torch.empty((H, W), dtype=torch.float32, device=dev)
    terms = [t.data_ptr() for t in ref_terms] + [None] * (3 - len(ref_terms))
    with on_device(dev):
        err = lib.plane_sweep_launch(
            ref.data_ptr(), srcs.data_ptr(), homographies.data_ptr(), depths.data_ptr(),
            weights.data_ptr() if bilateral else None, *terms,
            geom.src_depths.data_ptr() if geom is not None else None,
            geom.packed.data_ptr() if geom is not None else None,
            H, W, S, Hs, Ws, D, radius, int(bilateral), k, big,
            geom.regularizer if geom is not None else 0.0, geom.max_cost if geom is not None else 0.0,
            0.8 * (2 * radius + 1) ** 2, best_depth.data_ptr(), best_photo.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"plane_sweep kernel launch failed: cudaError {err}")
    plane_sweep_cuda.launches += 1
    return best_depth, best_photo


plane_sweep_cuda.launches = 0
