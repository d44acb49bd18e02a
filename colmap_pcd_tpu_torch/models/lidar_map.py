"""The prior LiDAR map: loading, frame conversion, submap grid, associations.

Port of colmap_pcd_tpu/models/lidar_map.py: host-side orchestration over the
device ops in ops/pointcloud.py and the 1-NN kernel in ops/nn_kernel.py.

  * load PLY with normals, convert the lidar frame (x fwd, y left, z up) to
    the camera-convention map frame: (x,y,z) -> (-y,-z,x), same for normals,
    dropping NaNs (ply.cc:33-57 PointCloudDirectionTrans).
  * bucket the map into a cubical-cell grid (BuildSubMap, pcd_projection.cc:
    223-255) stored CSR-style on the host, with the cell-sorted points and
    normals resident on `device`.
  * project_to_image(s): depth-associate features with the full map.
  * nn_query: exact 1-NN, on the GPU through the hand-written kernel or on
    the host through the native C++ kd-tree.
  * frustum_candidates (the cells inside a view's pyramid) and
    voxel_downsample (centroids per voxel), host numpy as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import device as device_mod
from ..io import ply as ply_io
from ..ops import camera_models as cm
from ..ops import nn_kernel
from ..ops import pointcloud as pc_ops
from ..utils.logging_utils import PHASES

def lidar_to_camera_frame(xyz: np.ndarray) -> np.ndarray:
    """(x fwd, y left, z up) -> camera convention (-y, -z, x)."""
    return np.stack([-xyz[:, 1], -xyz[:, 2], xyz[:, 0]], axis=-1)


def camera_to_lidar_frame(xyz: np.ndarray) -> np.ndarray:
    """Inverse of lidar_to_camera_frame: (x,y,z) -> (z, -x, -y)."""
    return np.stack([xyz[:, 2], -xyz[:, 0], -xyz[:, 1]], axis=-1)


@dataclass
class LidarMap:
    points: np.ndarray  # [N,3] camera-convention map frame, sorted by cell
    normals: np.ndarray  # [N,3]
    cell_size: float
    # CSR grid over the sorted points
    cell_keys: np.ndarray  # [n_cells, 3] int32 rounded coords
    cell_start: np.ndarray  # [n_cells]
    cell_count: np.ndarray  # [n_cells]
    # device-resident copies (sorted by cell)
    d_points: torch.Tensor
    d_points4: torch.Tensor  # [N,4] (x, y, z, 0): the layout the 1-NN kernel reads
    d_normals: torch.Tensor
    d_valid: torch.Tensor  # [N] f32 ones: every map point is a candidate
    opts: pc_ops.ProjOptions

    # ------------------------------------------------------------------
    @classmethod
    def load(
        cls,
        path: str,
        opts: pc_ops.ProjOptions = pc_ops.ProjOptions(),
        convert_frame: bool = True,
        device=None,
    ) -> "LidarMap":
        data = ply_io.read_ply(path)
        if data.normals is None:
            raise ValueError(f"{path}: lidar map must carry per-point normals")
        xyz, nrm = data.xyz, data.normals
        if convert_frame:
            xyz = lidar_to_camera_frame(xyz)
            nrm = lidar_to_camera_frame(nrm)
        return cls.from_arrays(xyz, nrm, opts, device=device)

    @classmethod
    def from_arrays(cls, xyz, nrm, opts=pc_ops.ProjOptions(), device=None) -> "LidarMap":
        with PHASES.phase("lidar_map.build"):
            xyz = np.asarray(xyz, np.float32)
            nrm = np.asarray(nrm, np.float32)
            ok = np.all(np.isfinite(xyz), axis=1) & np.all(np.isfinite(nrm), axis=1)
            xyz, nrm = xyz[ok], nrm[ok]
            # grid bucketing: key = round(x / cell) per axis (pcd_projection.h:70-76),
            # points sorted lexicographically by (kx, ky, kz)
            keys = np.round(xyz / opts.submap_cell).astype(np.int64)
            order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
            xyz, nrm, keys = xyz[order], nrm[order], keys[order]
            uniq, start, count = np.unique(keys, axis=0, return_index=True, return_counts=True)
            return cls.from_grid(xyz, nrm, uniq, start, count, opts, device)

    @classmethod
    def from_grid(cls, xyz, nrm, cell_keys, cell_start, cell_count, opts, device=None):
        """A map from points already sorted by grid cell and their CSR table,
        resident on `device` (None: CUDA; the CPU only by name)."""
        device = device_mod.resolve(device)
        xyz = np.ascontiguousarray(xyz, np.float32)
        nrm = np.ascontiguousarray(nrm, np.float32)
        d_points = torch.as_tensor(xyz, device=device)
        return cls(
            points=xyz,
            normals=nrm,
            cell_size=opts.submap_cell,
            cell_keys=np.asarray(cell_keys).astype(np.int32),
            cell_start=np.asarray(cell_start).astype(np.int64),
            cell_count=np.asarray(cell_count).astype(np.int64),
            d_points=d_points,
            d_points4=nn_kernel.pack_points(d_points),
            d_normals=torch.as_tensor(nrm, device=device),
            d_valid=torch.ones(xyz.shape[0], dtype=torch.float32, device=device),
            opts=opts,
        )

    @property
    def device(self) -> torch.device:
        return self.d_points.device

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    # ------------------------------------------------------------------
    def frustum_candidates(
        self, q, t, params, model_id: int, width: int, height: int, budget: int | None = None
    ):
        """Candidate point range for a view: the 5-plane cell test and the CSR
        compaction on the host (numpy, as in the JAX package), padded to a
        budget.

        Returns (cand_idx [B] int64, valid [B] f32) where B is the padded budget.
        """
        from ..ops import np_geom

        pp = np.asarray(params)
        fi, fj, ci, cj = cm._FOCAL_IDX[model_id]
        planes = np_geom.frustum_planes(
            np.asarray(q, np.float64), np.asarray(t, np.float64),
            pp[fi], pp[fj], pp[ci], pp[cj], width, height, self.opts.choose_meter,
        )
        # cell centers inside the frustum, with one-cell dilation via a radius
        # slack on the plane test (covers the reference's +-1-cell sweep)
        slack = self.cell_size * np.sqrt(3.0) * 0.5
        centers = self.cell_keys.astype(np.float64) * self.cell_size
        vals = centers @ planes[:, :3].T + planes[None, :, 3]
        mask = np.all(vals <= slack, axis=-1)
        sel = np.nonzero(mask)[0]
        if sel.size == 0:
            idx = np.zeros(0, np.int64)
        else:
            counts = self.cell_count[sel]
            total = int(counts.sum())
            # vectorized CSR expansion (no Python loop over cells)
            base = np.repeat(self.cell_start[sel], counts)
            within = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(counts) - counts, counts
            )
            idx = base + within
        n = idx.size
        if budget is None:
            # a power-of-two bucket (min 32k), the JAX package's default
            budget = max(32768, 1 << int(np.ceil(np.log2(max(n, 1)))))
        if n > budget:
            import logging

            logging.getLogger(__name__).warning(
                "frustum candidate set (%d) exceeds budget (%d); truncating", n, budget
            )
            idx = idx[:budget]
            n = budget
        valid = np.zeros(budget, np.float32)
        valid[:n] = 1.0
        pad = np.zeros(budget, np.int64)
        pad[:n] = idx
        return pad, valid

    # ------------------------------------------------------------------
    def project_to_images(
        self,
        feat_xy: np.ndarray,  # [B,F,2] full-res pixels (zero-padded rows ok)
        feat_valid: np.ndarray,  # [B,F]
        qs: np.ndarray,  # [B,4]
        ts: np.ndarray,  # [B,3]
        params,
        model_id: int,
        width: int,
        height: int,
    ):
        """Associate each feature pixel of B views sharing one camera with
        the nearest covering lidar point, against the FULL map (the
        projection itself culls by image bounds and depth).

        Returns dict with lidar_pt [B,F,3], lidar_nrm [B,F,3], found [B,F]
        (SetNewImage map-overload semantics, pcd_projection.cc:13-89).
        """
        dev = self.device
        B = feat_xy.shape[0]
        f32 = dict(dtype=torch.float32, device=dev)
        lpt, lnr, found = pc_ops.depth_project_shared(
            torch.as_tensor(np.asarray(feat_xy, np.float32), device=dev),
            torch.as_tensor(np.asarray(feat_valid, np.float32), device=dev),
            self.d_points, self.d_normals, self.d_valid,
            torch.as_tensor(np.asarray(qs), **f32),
            torch.as_tensor(np.asarray(ts), **f32),
            torch.as_tensor(np.asarray(params), **f32).expand(B, cm.MAX_PARAMS),
            width, height, model_id, self.opts,
        )
        return {"lidar_pt": lpt.cpu().numpy(), "lidar_nrm": lnr.cpu().numpy(),
                "found": found.cpu().numpy()}

    def project_to_image(
        self,
        feat_xy: np.ndarray,  # [F,2] full-res pixels
        q,
        t,
        params,
        model_id: int,
        width: int,
        height: int,
        feat_valid: np.ndarray | None = None,
    ):
        """project_to_images for one view: dict with lidar_pt [F,3],
        lidar_nrm [F,3], found [F] bool."""
        if feat_valid is None:
            feat_valid = np.ones(feat_xy.shape[0], np.float32)
        out = self.project_to_images(
            feat_xy[None], feat_valid[None], np.asarray(q)[None], np.asarray(t)[None],
            params, model_id, width, height,
        )
        return {k: v[0] for k, v in out.items()}

    # ------------------------------------------------------------------
    @property
    def host_tree(self):
        """Lazy native C++ kd-tree (cpp/native.cpp) — the host-side NN path.
        None when the native lib is unavailable."""
        t = getattr(self, "_host_tree", None)
        if t is None:
            from ..utils.native import NativeKdTree, get_lib

            t = NativeKdTree(self.points) if get_lib() is not None else False
            self._host_tree = t
        return t or None

    def nn_query(self, queries: np.ndarray, backend: str = "auto"):
        """Exact 1-NN against the full map. Returns (points, normals, dists).

        backend: "device" = the nn_argmin wrapper on the map's device (the
        CUDA kernel on a GPU map, its plain version on a CPU map); "host" =
        the native C++ kd-tree; "auto" = device on a GPU map, otherwise host
        when the native library is built.
        """
        Q = queries.shape[0]
        if Q == 0:
            return (
                np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.float32),
                np.zeros((0,), np.float32),
            )
        if backend not in ("auto", "host", "device"):
            raise ValueError(f"unknown nn_query backend {backend!r}")
        if backend == "host" and self.host_tree is None:
            raise RuntimeError("nn_query backend 'host' needs the native library (cpp/)")
        use_host = backend == "host" or (
            backend == "auto" and self.device.type == "cpu" and self.host_tree is not None
        )
        if use_host:
            idx, dist = self.host_tree.nn(np.asarray(queries, np.float32))
        else:
            q = torch.as_tensor(np.ascontiguousarray(queries, np.float32), device=self.device)
            idx_t, dist_t = nn_kernel.nn_argmin(q, self.d_points4)
            idx, dist = idx_t.cpu().numpy(), dist_t.cpu().numpy()
        return self.points[idx], self.normals[idx], dist

    # ------------------------------------------------------------------
    def voxel_downsample(self, voxel: float) -> tuple[np.ndarray, np.ndarray]:
        """Centroid voxel filter for display/export (LoadDownsizedMap parity)."""
        keys = np.floor(self.points / voxel).astype(np.int64)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        n = uniq.shape[0]
        sums = np.zeros((n, 3), np.float64)
        nrms = np.zeros((n, 3), np.float64)
        cnt = np.zeros((n, 1), np.int64)
        np.add.at(sums, inv, self.points)
        np.add.at(nrms, inv, self.normals)
        np.add.at(cnt, inv, 1)
        return (sums / cnt).astype(np.float32), (nrms / cnt).astype(np.float32)
