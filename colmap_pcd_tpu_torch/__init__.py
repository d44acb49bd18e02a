"""colmap_pcd_tpu_torch — the PyTorch + CUDA port of colmap_pcd_tpu.

Lidar-constrained incremental Structure-from-Motion on one NVIDIA GPU. The
layout mirrors the JAX package so each module's counterpart is easy to find:

  ops/     device compute in PyTorch (SE3, camera models, P3P/EPnP, RANSAC,
           depth projection, bundle adjustment) and the hand-written CUDA
           1-NN kernel (ops/nn_kernel.py + csrc/nn_argmin.cu).
  models/  scene model and mapper logic; host modules carried over from the
           JAX package (which cannot be imported without JAX).
  io/      PLY reading/writing.
  utils/   options registry, phase timers, native C++ host runtime bindings.

Importing the package needs neither nvcc nor a GPU; the CUDA kernel builds at
its first launch. The JAX package `colmap_pcd_tpu` is the reference the port
is tested against and is never imported here.
"""

from .device import set_numerics_policy

set_numerics_policy()

__version__ = "0.1.0"
