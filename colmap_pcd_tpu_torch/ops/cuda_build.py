"""Build a hand-written CUDA source of csrc/ into a plain-C shared library.

Each kernel module (ops/nn_kernel.py, ops/match_kernel.py,
ops/stereo_kernel.py) compiles its source with nvcc for sm_90a at its first
launch, into colmap_pcd_tpu_torch/build/ keyed by a hash of the source, and
binds it with ctypes; importing a kernel module needs no CUDA toolkit. The ptxas
report (registers, shared memory, spills) and the build's seconds are kept
in a `.log` beside the library; `BUILD_SECONDS` holds the seconds of every
source this process compiled.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
BUILD_SECONDS: dict[str, float] = {}  # source stem -> nvcc seconds, this process


def on_device(dev):
    """Context in which `dev` is the current CUDA device, so that a ctypes
    launch lands on it (nothing to do when it already is)."""
    import torch

    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


_SM_COUNT: dict[int, int] = {}


def sm_count(dev) -> int:
    """Streaming multiprocessors of a CUDA device (asked once per device)."""
    import torch

    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNT[index]


def _nvcc(source: str) -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found: {source} cannot be built")
    return nvcc


def build_library(source: str, include_dirs: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile `source` (if its content changed) and load the library.
    `include_dirs` are passed to nvcc as -I (header-only helpers such as
    CUTLASS's). Raises RuntimeError with nvcc's output if the build fails."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    so = os.path.join(BUILD_DIR, f"{stem}-{digest}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [
                _nvcc(source), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                *(f"-I{d}" for d in include_dirs), "-o", tmp, source,
            ],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        BUILD_SECONDS[stem] = seconds
        with open(so[: -len(".so")] + ".log", "w") as f:
            f.write(proc.stderr)
            f.write(f"nvcc: {stem} built in {seconds:.2f} s\n")
        os.replace(tmp, so)
    return ctypes.CDLL(so)
