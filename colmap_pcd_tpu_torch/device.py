"""Numerics policy and device resolution for the PyTorch port.

Geometry correctness first (docs/DESIGN.md §6): at scene-coordinate scale
(~50-100 m) a TF32 matmul keeps ~3 decimal digits, which turns the 3-wide
contractions of point projection, Jacobian/Schur assembly and the minimal
solvers into metre-level errors. None of those products is large enough for
TF32 to pay, so float32 runs at full precision for matmul AND cuDNN (whose
TF32 default is on).
"""

from __future__ import annotations

import torch


def set_numerics_policy() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The device to compute on. None or "auto" picks CUDA when present and
    the CPU otherwise; a CUDA device asked for by name must exist — this
    raises instead of falling back to the CPU."""
    if device is None or device == "auto":
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
