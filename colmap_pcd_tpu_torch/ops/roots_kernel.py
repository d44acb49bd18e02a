"""The real roots of a bank of real polynomials as one launch of the
hand-written CUDA kernel csrc/poly_roots.cu.

Replaces no Pallas kernel (the JAX package's Durand-Kerner is plain jnp,
one XLA program); it is the CUDA route of ops/polynomial.real_roots, whose
plain PyTorch route (`real_roots_plain`) serves CPU tensors and is the
card's yardstick. The kernel runs the plain route's prologue, sweeps,
Newton steps and real-root test in registers, one thread a polynomial, for
degrees 1 to 10 (P3P's quartics, the five-point solver's degree-10
polynomials). It is built at its first launch by ops/cuda_build.py;
importing this module needs no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import math
import os
import threading

import torch

from .cuda_build import CSRC_DIR, build_library, on_device

Tensor = torch.Tensor

SOURCE = os.path.join(CSRC_DIR, "poly_roots.cu")

_lock = threading.Lock()
_lib = None


def build() -> ctypes.CDLL:
    """The kernel library of csrc/poly_roots.cu, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = build_library(SOURCE)
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.poly_roots_launch.argtypes = [vp, ci, ci, ci, ci, cf, vp, vp, vp]
            lib.poly_roots_launch.restype = ci
            _lib = lib
        return _lib


MAX_DEGREE = 10  # the kernel's instantiations (csrc/poly_roots.cu's MAX_DEGREE)


def _require(ok: bool, message: str):
    if not ok:
        raise ValueError(f"real_roots_cuda: {message}")


def real_roots_cuda(
    coeffs: Tensor, rel_imag_tol: float = 1e-2, iters: int = 80, newton_iters: int = 3,
) -> tuple[Tensor, Tensor]:
    """(roots [..., n] float32, valid [..., n] bool) of the polynomials
    coeffs [..., n+1] (highest-degree first) in one launch, counted in
    `real_roots_cuda.launches`: ops/polynomial.real_roots' results. Raises
    on a tensor that is not a contiguous float32 CUDA tensor, on a degree
    outside 1 to 10, and on a failed launch."""
    _require(coeffs.dim() >= 1, "coefficients need a last dimension")
    n = coeffs.shape[-1] - 1
    _require(1 <= n <= MAX_DEGREE, f"degree {n}: the kernel roots degrees 1 to {MAX_DEGREE}")
    _require(coeffs.dtype == torch.float32, f"coefficients must be float32, got {coeffs.dtype}")
    _require(coeffs.device.type == "cuda", f"coefficients on {coeffs.device}: the kernel runs on CUDA only")
    _require(coeffs.is_contiguous(), "coefficients must be contiguous")
    _require(iters >= 0 and newton_iters >= 0, f"{iters} sweeps and {newton_iters} Newton steps")
    P = math.prod(coeffs.shape[:-1])
    _require(P < 2**31, f"{P} polynomials in one bank")
    dev = coeffs.device
    roots = torch.empty(coeffs.shape[:-1] + (n,), dtype=torch.float32, device=dev)
    valid = torch.empty(coeffs.shape[:-1] + (n,), dtype=torch.bool, device=dev)
    if P == 0:
        return roots, valid
    lib = build()
    with on_device(dev):
        err = lib.poly_roots_launch(
            coeffs.data_ptr(), P, n, iters, newton_iters, rel_imag_tol, roots.data_ptr(), valid.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"poly_roots kernel launch failed: cudaError {err}")
    with _lock:  # the matcher's pool threads launch concurrently
        real_roots_cuda.launches += 1
    return roots, valid


real_roots_cuda.launches = 0
