"""State carried across from the JAX package, given as numpy arrays.

The system holds no weights: its state is the lidar map and the bundle
adjustment problem. These turn the JAX package's state (fetched to numpy)
into the port's tensors on a device. Reconstructions cross over through the
COLMAP binary model format that both packages read and write.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as device_mod
from .models.lidar_map import LidarMap
from .ops.ba import BAProblem
from .ops.pointcloud import ProjOptions


def proj_options_from(jax_opts_asdict: dict) -> ProjOptions:
    """ProjOptions from the JAX package's `ProjOptions._asdict()`."""
    return ProjOptions(**jax_opts_asdict)


def lidar_map_from_numpy(points, normals, cell_keys, cell_start, cell_count, opts, device=None) -> LidarMap:
    """A LidarMap from the JAX map's cell-sorted points/normals and its CSR
    grid table (`LidarMap.points`, `.normals`, `.cell_keys`, `.cell_start`,
    `.cell_count`); `opts` is a ProjOptions or its dict."""
    if isinstance(opts, dict):
        opts = proj_options_from(opts)
    return LidarMap.from_grid(points, normals, cell_keys, cell_start, cell_count, opts, device)


def ba_problem_from_numpy(device=None, **fields) -> BAProblem:
    """A BAProblem from the JAX BAProblem's fields as numpy arrays
    (`{k: np.asarray(v) for k, v in problem._asdict().items()}`): integer
    fields become int64, float fields float32, on `device` (None: CUDA;
    the CPU only by name)."""
    device = device_mod.resolve(device)
    missing = set(BAProblem._fields) - set(fields)
    if missing:
        raise ValueError(f"missing BAProblem fields: {sorted(missing)}")
    out = {}
    for name in BAProblem._fields:
        a = np.asarray(fields[name])
        a = a.astype(np.int64 if np.issubdtype(a.dtype, np.integer) else np.float32)
        out[name] = torch.tensor(a, device=device)
    return BAProblem(**out)
