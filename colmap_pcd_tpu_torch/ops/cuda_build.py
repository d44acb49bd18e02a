"""Build a hand-written CUDA source of csrc/ into a plain-C shared library.

Each kernel module (ops/nn_kernel.py, ops/match_kernel.py) compiles its
source with nvcc for sm_90a at its first launch, into
colmap_pcd_tpu_torch/build/ keyed by a hash of the source, and binds it
with ctypes; importing a kernel module needs no CUDA toolkit. The ptxas
report (registers, shared memory, spills) is kept in a `.log` beside the
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")


def _nvcc(source: str) -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found: {source} cannot be built")
    return nvcc


def build_library(source: str) -> ctypes.CDLL:
    """Compile `source` (if its content changed) and load the library.
    Raises RuntimeError with nvcc's output if the build fails."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    so = os.path.join(BUILD_DIR, f"{stem}-{digest}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [
                _nvcc(source), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                "-o", tmp, source,
            ],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        with open(so[: -len(".so")] + ".log", "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, so)
    return ctypes.CDLL(so)
