"""State carried across from the JAX package, given as numpy arrays.

The system holds no weights: its state is the lidar map, the bundle
adjustment problems (plain and rig) and the retrieval index. These turn the
JAX package's state (fetched to numpy) into the port's tensors on a device.
Reconstructions cross over through the COLMAP binary model format that both
packages read and write.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as device_mod
from .models.lidar_map import LidarMap
from .ops.ba import BAProblem
from .ops.pointcloud import ProjOptions
from .ops.retrieval import RetrievalIndex
from .ops.rig_ba import RigBAProblem


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


def _problem_from_numpy(cls, device, fields):
    device = device_mod.resolve(device)
    missing = set(cls._fields) - set(fields)
    if missing:
        raise ValueError(f"missing {cls.__name__} fields: {sorted(missing)}")
    out = {}
    for name in cls._fields:
        a = np.asarray(fields[name])
        a = a.astype(np.int64 if np.issubdtype(a.dtype, np.integer) else np.float32)
        out[name] = torch.tensor(a, device=device)
    return cls(**out)


def ba_problem_from_numpy(device=None, **fields) -> BAProblem:
    """A BAProblem from the JAX BAProblem's fields as numpy arrays
    (`{k: np.asarray(v) for k, v in problem._asdict().items()}`): integer
    fields become int64, float fields float32, on `device` (None: CUDA;
    the CPU only by name)."""
    return _problem_from_numpy(BAProblem, device, fields)


def rig_ba_problem_from_numpy(device=None, **fields) -> RigBAProblem:
    """A RigBAProblem from the JAX RigBAProblem's fields as numpy arrays,
    as `ba_problem_from_numpy`."""
    return _problem_from_numpy(RigBAProblem, device, fields)


def retrieval_index_from_numpy(ids, vlads, centroids, geoms=None, words=None, valids=None,
                               device=None) -> RetrievalIndex:
    """A RetrievalIndex from the JAX RetrievalIndex's fields (numpy arrays
    already): VLADs, centroids, geometries and valids as float32, words as
    int32, on `device` (None: CUDA; the CPU only by name)."""
    device = device_mod.resolve(device)

    def t(a, dtype):
        return None if a is None else torch.as_tensor(np.asarray(a, dtype), device=device)

    return RetrievalIndex(list(ids), t(vlads, np.float32), t(centroids, np.float32), t(geoms, np.float32),
                          t(words, np.int32), t(valids, np.float32))
