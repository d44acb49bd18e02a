"""colmap_pcd_tpu_torch — the PyTorch + CUDA port of colmap_pcd_tpu.

Lidar-constrained incremental Structure-from-Motion on one NVIDIA GPU. The
layout mirrors the JAX package so each module's counterpart is easy to find:

  ops/     device compute in PyTorch (SE3, camera models, minimal solvers,
           RANSAC banks, SIFT, depth projection, bundle adjustment with a
           dense and a PCG camera tier, L1 fitting, plane-sweep stereo, the
           spectral Poisson solve) and the hand-written CUDA kernels K1
           (ops/match_kernel.py + csrc/match_top2*.cu) and K2
           (ops/nn_kernel.py + csrc/nn_argmin.cu); the Delaunay mesher on
           the host.
  models/  scene model, matchers, mapper, hierarchical mapper, model tools,
           undistortion, dense stereo and fusion; host modules carried over
           from the JAX package (which cannot be imported without JAX).
  io/      PLY, interchange formats (NVM, Bundler, CAM, VRML), HTML viewer.
  utils/   options registry, phase timers, native C++ host runtime bindings.

Every entry point computes on CUDA unless it is asked for the CPU by name
(`device="cpu"`, `--device cpu`); without CUDA it raises. Importing the
package needs neither nvcc nor a GPU; each CUDA kernel builds at its first
launch. The JAX package `colmap_pcd_tpu` is the reference the port is
tested against and is never imported here.
"""

from .device import set_numerics_policy

set_numerics_policy()

__version__ = "0.1.0"
