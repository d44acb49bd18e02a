"""The mutable scene model: cameras, images, 3D points, tracks, lidar links.

Parity re-design of src/base/reconstruction.{h,cc} (3,011 LoC), src/base/
{camera,image,point2d,point3d,track}.{h,cc}: same data model and invariants,
Python/numpy implementation (the heavy math all lives on device in ops/).

COLMAP conventions preserved for interop: qvec (w,x,y,z) world-to-camera,
model files binary/text compatible with COLMAP 3.8 (read/write cameras/images/
points3D .bin/.txt), pose.ply prior import/export with the lidar-frame axis
conversion (controllers/incremental_mapper.cc:922-996, ui/main_window.cc:1078).

Lidar extensions mirror the fork: per-point associations with type
Proj/Icp/IcpGround (lidar/lidar_point.h:9), local and global association maps
(reconstruction.h:434-437), FilterLidarOutlier (reconstruction.cc:771-805),
per-point global_opt_num / in_sphere flags used by the spherical global BA.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

from ..ops import camera_models as cm

INVALID_POINT3D = -1


@dataclass
class Camera:
    camera_id: int
    model_id: int
    width: int
    height: int
    params: np.ndarray  # raw (unpadded) params
    prior_focal: bool = False  # focal length from EXIF/specs DB (HasPriorFocalLength)

    @property
    def model_name(self) -> str:
        return cm.MODEL_NAMES[self.model_id]

    def padded_params(self) -> np.ndarray:
        # pure numpy: this is called per-observation in host hot loops.
        # Memoized on the params object identity — BA write-back REBINDS
        # cam.params (never mutates in place), so identity is a valid key.
        cached = getattr(self, "_pp_cache", None)
        if cached is not None and cached[0] is self.params:
            return cached[1]
        p = np.asarray(self.params, np.float32)
        assert p.shape[-1] == cm.NUM_PARAMS[self.model_id]
        out = np.pad(p, (0, cm.MAX_PARAMS - p.shape[-1]))
        self._pp_cache = (self.params, out)
        return out

    def mean_focal_length(self) -> float:
        fi, fj, _, _ = cm._FOCAL_IDX[self.model_id]
        return float((self.params[fi] + self.params[fj]) / 2.0)

    def has_bogus_params(self, min_focal_ratio, max_focal_ratio, max_extra_param) -> bool:
        """reference: camera.cc HasBogusParams."""
        fi, fj, ci, cj = cm._FOCAL_IDX[self.model_id]
        maxdim = max(self.width, self.height)
        for i in {fi, fj}:
            r = self.params[i] / maxdim
            if r < min_focal_ratio or r > max_focal_ratio:
                return True
        for i in range(len(self.params)):
            if i not in (fi, fj, ci, cj) and abs(self.params[i]) > max_extra_param:
                return True
        return False


@dataclass
class Image:
    image_id: int
    name: str
    camera_id: int
    qvec: np.ndarray = field(default_factory=lambda: np.array([1.0, 0, 0, 0]))
    tvec: np.ndarray = field(default_factory=lambda: np.zeros(3))
    registered: bool = False
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float64))
    point3D_ids: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int64))

    def num_points3D(self) -> int:
        return int(np.sum(self.point3D_ids != INVALID_POINT3D))

    def projection_center(self) -> np.ndarray:
        from ..ops import np_geom

        return np_geom.projection_center(self.qvec, self.tvec)


LIDAR_PROJ = 0
LIDAR_ICP = 1
LIDAR_ICP_GROUND = 2


@dataclass
class LidarAssoc:
    """A point3D <-> lidar-plane association (colmap::LidarPoint,
    src/lidar/lidar_point.h:10-50)."""

    type: int  # LIDAR_PROJ / LIDAR_ICP / LIDAR_ICP_GROUND
    point: np.ndarray  # [3] associated lidar point (world/map frame)
    plane: np.ndarray  # [4] (a,b,c,d) unit normal through the lidar point

    def point_to_plane_dist(self, xyz: np.ndarray) -> float:
        return float(abs(np.dot(self.plane[:3], xyz) + self.plane[3]))

    def point_to_point_dist(self, xyz: np.ndarray) -> float:
        return float(np.linalg.norm(xyz - self.point))


@dataclass
class Point3D:
    xyz: np.ndarray
    color: np.ndarray = field(default_factory=lambda: np.zeros(3, np.uint8))
    error: float = -1.0
    track: list = field(default_factory=list)  # [(image_id, point2D_idx)]
    global_opt_num: int = 0  # spherical-BA bookkeeping (reconstruction.h)
    in_sphere: bool = False


class Reconstruction:
    def __init__(self):
        self.cameras: dict[int, Camera] = {}
        self.images: dict[int, Image] = {}
        self.points3D: dict[int, Point3D] = {}
        self.registered_ids: list[int] = []
        self._next_point3D_id = 1
        # lidar association maps (reconstruction.h:434-437)
        self.lidar_points: dict[int, LidarAssoc] = {}
        self.lidar_points_in_global: dict[int, LidarAssoc] = {}
        # image pair stats (from the database cache; used by Project2Image)
        self.image_pair_corrs: dict[tuple[int, int], int] = {}
        # observers notified on every (image, feat) triangulation transition
        # (the reference's SetObservationAsTriangulated bookkeeping hook,
        # base/image.cc:110-135) — see models/visibility.VisibilityIndex
        self.obs_observers: list = []
        # per-image change counters: pose_epoch bumps on every pose write,
        # mut_epoch on every point3D_ids mutation — cheap validity stamps for
        # caches that are pure functions of (pose, triangulated feature set),
        # e.g. the mapper's lidar projection cache
        self.pose_epoch: dict[int, int] = {}
        self.mut_epoch: dict[int, int] = {}
        # per-camera intrinsics change counter: projection caches depend on
        # cam.params too, so refine_intrinsics write-backs must invalidate them
        self.cam_params_epoch: dict[int, int] = {}

    def bump_pose(self, image_id: int):
        self.pose_epoch[image_id] = self.pose_epoch.get(image_id, 0) + 1

    def bump_camera_params(self, camera_id: int):
        self.cam_params_epoch[camera_id] = (
            self.cam_params_epoch.get(camera_id, 0) + 1
        )

    def _set_obs(self, image_id: int, p2d_idx: int, pid: int):
        """Single point of mutation for image.point3D_ids with observer
        notification on INVALID<->valid transitions."""
        img = self.images[image_id]
        old = int(img.point3D_ids[p2d_idx])
        if old == pid:
            return
        self.mut_epoch[image_id] = self.mut_epoch.get(image_id, 0) + 1
        img.point3D_ids[p2d_idx] = pid
        if old == INVALID_POINT3D:
            for ob in self.obs_observers:
                ob.on_observation(image_id, p2d_idx, True)
        elif pid == INVALID_POINT3D:
            for ob in self.obs_observers:
                ob.on_observation(image_id, p2d_idx, False)

    # ------------------------------------------------------------------ build
    def add_camera(self, camera: Camera):
        self.cameras[camera.camera_id] = camera

    def add_image(self, image: Image):
        if image.point3D_ids.size == 0 and image.xys.shape[0] > 0:
            image.point3D_ids = np.full(image.xys.shape[0], INVALID_POINT3D, np.int64)
        self.images[image.image_id] = image

    def register_image(self, image_id: int):
        img = self.images[image_id]
        if not img.registered:
            img.registered = True
            self.registered_ids.append(image_id)

    def deregister_image(self, image_id: int):
        img = self.images[image_id]
        # drop all its observations first
        for p2d_idx in np.nonzero(img.point3D_ids != INVALID_POINT3D)[0]:
            self.delete_observation(image_id, int(p2d_idx))
        img.registered = False
        self.registered_ids.remove(image_id)

    @property
    def num_reg_images(self) -> int:
        return len(self.registered_ids)

    def add_point3D(self, xyz, track, color=None) -> int:
        pid = self._next_point3D_id
        self._next_point3D_id += 1
        p = Point3D(xyz=np.asarray(xyz, np.float64), track=list(track))
        if color is not None:
            p.color = np.asarray(color, np.uint8)
        self.points3D[pid] = p
        for image_id, p2d_idx in track:
            assert self.images[image_id].point3D_ids[p2d_idx] == INVALID_POINT3D
            self._set_obs(image_id, p2d_idx, pid)
        return pid

    def add_observation(self, point3D_id: int, image_id: int, point2D_idx: int):
        img = self.images[image_id]
        assert img.point3D_ids[point2D_idx] == INVALID_POINT3D
        self._set_obs(image_id, point2D_idx, point3D_id)
        self.points3D[point3D_id].track.append((image_id, point2D_idx))

    def delete_observation(self, image_id: int, point2D_idx: int):
        img = self.images[image_id]
        pid = int(img.point3D_ids[point2D_idx])
        if pid == INVALID_POINT3D:
            return
        self._set_obs(image_id, point2D_idx, INVALID_POINT3D)
        p = self.points3D[pid]
        p.track.remove((image_id, point2D_idx))
        if len(p.track) < 2:
            self._delete_point_only(pid)

    def delete_point3D(self, point3D_id: int):
        self._delete_point_only(point3D_id)

    def _delete_point_only(self, pid: int):
        p = self.points3D.pop(pid, None)
        if p is not None:
            for image_id, p2d_idx in p.track:
                self._set_obs(image_id, p2d_idx, INVALID_POINT3D)
        self.lidar_points.pop(pid, None)
        self.lidar_points_in_global.pop(pid, None)

    def merge_points3D(self, pid1: int, pid2: int) -> int:
        """Merge two points; weighted-average position (reconstruction.cc
        MergePoints3D). Returns the new point id."""
        p1, p2 = self.points3D[pid1], self.points3D[pid2]
        n1, n2 = len(p1.track), len(p2.track)
        xyz = (p1.xyz * n1 + p2.xyz * n2) / (n1 + n2)
        color = ((p1.color.astype(np.int64) * n1 + p2.color.astype(np.int64) * n2) // (n1 + n2)).astype(np.uint8)
        track = p1.track + p2.track
        self._delete_point_only(pid1)
        self._delete_point_only(pid2)
        new_id = self._next_point3D_id
        self._next_point3D_id += 1
        self.points3D[new_id] = Point3D(xyz=xyz, color=color, track=track)
        for image_id, p2d_idx in track:
            self._set_obs(image_id, p2d_idx, new_id)
        return new_id

    # ------------------------------------------------------------- lidar glue
    def add_lidar_point(self, point3D_id: int, assoc: LidarAssoc):
        self.lidar_points[point3D_id] = assoc

    def add_lidar_point_in_global(self, point3D_id: int, assoc: LidarAssoc):
        self.lidar_points_in_global[point3D_id] = assoc

    def clear_lidar_points(self):
        self.lidar_points.clear()

    def clear_lidar_points_in_global(self):
        self.lidar_points_in_global.clear()

    def filter_lidar_outliers(self, proj_max_dist: float, icp_max_dist: float) -> int:
        """Drop associations whose point-to-point distance exceeds the
        per-type bound (reconstruction.cc:771-805 FilterLidarOutlier)."""
        n = 0
        for store in (self.lidar_points, self.lidar_points_in_global):
            for pid in list(store.keys()):
                p = self.points3D.get(pid)
                if p is None:
                    del store[pid]
                    continue
                a = store[pid]
                lim = proj_max_dist if a.type == LIDAR_PROJ else icp_max_dist
                if a.point_to_point_dist(p.xyz) > lim:
                    del store[pid]
                    n += 1
        return n

    # -------------------------------------------------------------- filtering
    def compute_reproj_errors(self, point3D_id: int) -> list[float]:
        from ..ops import np_geom

        p = self.points3D[point3D_id]
        errs = []
        for image_id, p2d_idx in p.track:
            img = self.images[image_id]
            cam = self.cameras[img.camera_id]
            xy, z = np_geom.project(
                cam.model_id, cam.padded_params(), img.qvec, img.tvec, p.xyz
            )
            if z <= 0:
                errs.append(np.inf)
            else:
                errs.append(float(np.linalg.norm(xy - img.xys[p2d_idx])))
        return errs

    def filter_points3D(
        self,
        max_reproj_error: float = 4.0,
        min_tri_angle_deg: float = 1.5,
        point_ids: list[int] | None = None,
    ) -> int:
        """Filter observations with large reprojection error / negative depth,
        and points with insufficient triangulation angle
        (reconstruction.cc:760-860 FilterPoints3DWithLargeReprojectionError /
        FilterPoints3DWithSmallTriangulationAngle). Vectorized over all
        observations of the candidate set, per image, in numpy."""
        ids = list(self.points3D.keys()) if point_ids is None else [
            i for i in point_ids if i in self.points3D
        ]
        if not ids:
            return 0
        from ..ops import np_geom

        # reprojection/depth filter, iterated per IMAGE: each image's
        # observations project in one vectorized call with one shared camera
        # (no per-observation Python stacks — this runs every refinement
        # round over the whole scene)
        n_del = 0
        ids_sorted = np.asarray(sorted(ids), np.int64)
        xyz_table = np.stack([self.points3D[int(p)].xyz for p in ids_sorted])
        images_touched = {i for pid in ids for i, _ in self.points3D[pid].track}
        for image_id in images_touched:
            img = self.images[image_id]
            fsel = np.nonzero(img.point3D_ids != INVALID_POINT3D)[0]
            if fsel.size == 0:
                continue
            pids_f = img.point3D_ids[fsel]
            pos = np.searchsorted(ids_sorted, pids_f)
            inset = (pos < ids_sorted.size) & (
                ids_sorted[np.minimum(pos, ids_sorted.size - 1)] == pids_f
            )
            fsel = fsel[inset]
            if fsel.size == 0:
                continue
            slots = pos[inset]
            cam = self.cameras[img.camera_id]
            xy, z = np_geom.project(
                cam.model_id,
                cam.padded_params()[None, :],
                np.asarray(img.qvec)[None, :],
                np.asarray(img.tvec)[None, :],
                xyz_table[slots],
            )
            err = np.linalg.norm(xy - img.xys[fsel], axis=-1)
            bad = (err > max_reproj_error) | (z <= 0)
            for fidx in fsel[bad]:
                self.delete_observation(image_id, int(fidx))
                n_del += 1
        # triangulation-angle filter — fully vectorized: [P, T, 3] masked
        # center table, pairwise max cos over each track in one einsum
        min_ang = np.deg2rad(min_tri_angle_deg)
        live = [pid for pid in ids if pid in self.points3D]
        if not live:
            return n_del
        centers_cache: dict[int, np.ndarray] = {}
        for iid in {i for pid in live for i, _ in self.points3D[pid].track}:
            centers_cache[iid] = self.images[iid].projection_center()
        # chunk by track length: one long track would otherwise size the
        # whole [P,T,T] pairwise tensor (2.5 GB at 450-image scenes)
        live.sort(key=lambda pid: len(self.points3D[pid].track))
        CHUNK = 2048
        to_delete = []
        for c0 in range(0, len(live), CHUNK):
            grp = live[c0 : c0 + CHUNK]
            T = max(2, max(len(self.points3D[pid].track) for pid in grp))
            P_ = len(grp)
            C = np.zeros((P_, T, 3), np.float32)
            M = np.zeros((P_, T), bool)
            X = np.zeros((P_, 3), np.float32)
            for k, pid in enumerate(grp):
                p = self.points3D[pid]
                X[k] = p.xyz
                for t, (iid, _) in enumerate(p.track):
                    C[k, t] = centers_cache[iid]
                    M[k, t] = True
            V = C - X[:, None, :]
            Vn = V / np.maximum(np.linalg.norm(V, axis=-1, keepdims=True), 1e-12)
            cosm = np.einsum("pti,pui->ptu", Vn, Vn)
            pairmask = M[:, :, None] & M[:, None, :]
            np.einsum("ptt->pt", cosm)[:] = 1.0  # ignore self-pairs
            cos_min = np.where(pairmask, cosm, 1.0).min(axis=(1, 2))
            max_ang = np.arccos(np.clip(cos_min, -1.0, 1.0))
            to_delete.extend(pid for k, pid in enumerate(grp) if max_ang[k] < min_ang)
        for pid in to_delete:
            self.delete_point3D(pid)
            n_del += 1
        return n_del

    # ------------------------------------------------------------------ stats
    def mean_reprojection_error(self) -> float:
        errs = [p.error for p in self.points3D.values() if p.error >= 0]
        return float(np.mean(errs)) if errs else 0.0

    def update_point_errors(self, point_ids=None):
        ids = point_ids if point_ids is not None else list(self.points3D.keys())
        for pid in ids:
            if pid in self.points3D:
                e = self.compute_reproj_errors(pid)
                self.points3D[pid].error = float(np.mean(e)) if e else -1.0

    def mean_track_length(self) -> float:
        if not self.points3D:
            return 0.0
        return float(np.mean([len(p.track) for p in self.points3D.values()]))

    def compute_bounding_box(self):
        if not self.points3D:
            return np.zeros(3), np.zeros(3)
        xyz = np.stack([p.xyz for p in self.points3D.values()])
        return xyz.min(0), xyz.max(0)

    # ----------------------------------------------------------------- colors
    @staticmethod
    def _bilinear_colors(rgb: np.ndarray, xys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized bilinear color sampling at keypoints, COLMAP's
        upper-left-pixel-center-at-(0.5, 0.5) convention
        (reconstruction.cc:1516 InterpolateBilinear at (x-0.5, y-0.5)).
        Returns (colors [N,3] float, in_bounds [N] bool)."""
        Hh, Ww = rgb.shape[:2]
        x = np.asarray(xys[:, 0], np.float64) - 0.5
        y = np.asarray(xys[:, 1], np.float64) - 0.5
        x0 = np.floor(x).astype(np.int64)
        y0 = np.floor(y).astype(np.int64)
        ok = (x0 >= 0) & (y0 >= 0) & (x0 + 1 < Ww) & (y0 + 1 < Hh)
        x0c = np.clip(x0, 0, Ww - 2)
        y0c = np.clip(y0, 0, Hh - 2)
        fx = (x - x0c)[:, None]
        fy = (y - y0c)[:, None]
        img = rgb.astype(np.float64)
        c = (
            img[y0c, x0c] * (1 - fx) * (1 - fy)
            + img[y0c, x0c + 1] * fx * (1 - fy)
            + img[y0c + 1, x0c] * (1 - fx) * fy
            + img[y0c + 1, x0c + 1] * fx * fy
        )
        return c, ok

    def extract_colors_for_image(self, image_id: int, image_dir: str) -> bool:
        """Color still-black 3D points from this image's keypoint pixels
        (reconstruction.cc:1500-1527 ExtractColorsForImage; called per
        registration by the mapper controller,
        controllers/incremental_mapper.cc:205-214)."""
        import os as _os

        from ..utils import image as image_utils

        img = self.images[image_id]
        path = _os.path.join(image_dir, img.name)
        try:
            rgb = image_utils.imread_rgb(path)
        except Exception:
            return False
        sel = np.nonzero(img.point3D_ids != INVALID_POINT3D)[0]
        if sel.size == 0:
            return True
        colors, ok = self._bilinear_colors(rgb, img.xys[sel])
        for k in np.nonzero(ok)[0]:
            p = self.points3D.get(int(img.point3D_ids[sel[k]]))
            if p is not None and not p.color.any():
                p.color = colors[k].astype(np.uint8)
        return True

    def extract_colors_for_all_images(self, image_dir: str):
        """Mean track color over all registered images
        (reconstruction.cc:1529-1575 ExtractColorsForAllImages; black when no
        image observes the point)."""
        import os as _os

        from ..utils import image as image_utils

        sums: dict[int, np.ndarray] = {}
        counts: dict[int, int] = {}
        for iid in self.registered_ids:
            img = self.images[iid]
            try:
                rgb = image_utils.imread_rgb(_os.path.join(image_dir, img.name))
            except Exception:
                print(f"Could not read image {img.name} at path {image_dir}.")
                continue
            sel = np.nonzero(img.point3D_ids != INVALID_POINT3D)[0]
            if sel.size == 0:
                continue
            colors, ok = self._bilinear_colors(rgb, img.xys[sel])
            for k in np.nonzero(ok)[0]:
                pid = int(img.point3D_ids[sel[k]])
                if pid in sums:
                    sums[pid] += colors[k]
                    counts[pid] += 1
                else:
                    sums[pid] = colors[k].copy()
                    counts[pid] = 1
        for pid, p in self.points3D.items():
            if pid in sums:
                p.color = (sums[pid] / counts[pid]).astype(np.uint8)
            else:
                p.color = np.zeros(3, np.uint8)

    def transform(self, q, t, scale=1.0):
        """Apply a similarity transform to all poses and points
        (reconstruction.cc Transform)."""
        from ..ops import np_geom

        q = np.asarray(q, np.float64)
        t = np.asarray(t, np.float64)
        R = np_geom.quat_to_rotmat(q)
        for img in self.images.values():
            Ri = np_geom.quat_to_rotmat(img.qvec)
            # world' = s R world + t  =>  R' = Ri R^T, t' = s ti - R' t
            Rn = Ri @ R.T
            tn = scale * img.tvec - Rn @ t
            img.qvec = np_geom.rotmat_to_quat(Rn)
            img.tvec = tn
            self.bump_pose(img.image_id)
        for p in self.points3D.values():
            p.xyz = scale * (R @ p.xyz) + t

    # --------------------------------------------------------------------- IO
    def write(self, path: str, binary: bool = True):
        os.makedirs(path, exist_ok=True)
        ext = ".bin" if binary else ".txt"
        self._write_cameras(os.path.join(path, "cameras" + ext), binary)
        self._write_images(os.path.join(path, "images" + ext), binary)
        self._write_points(os.path.join(path, "points3D" + ext), binary)

    @classmethod
    def read(cls, path: str) -> "Reconstruction":
        rec = cls()
        if os.path.exists(os.path.join(path, "cameras.bin")):
            rec._read_cameras_bin(os.path.join(path, "cameras.bin"))
            rec._read_images_bin(os.path.join(path, "images.bin"))
            rec._read_points_bin(os.path.join(path, "points3D.bin"))
        else:
            rec._read_cameras_txt(os.path.join(path, "cameras.txt"))
            rec._read_images_txt(os.path.join(path, "images.txt"))
            rec._read_points_txt(os.path.join(path, "points3D.txt"))
        return rec

    # binary format per COLMAP 3.8 (src/base/reconstruction.cc WriteBinary)
    def _write_cameras(self, path, binary):
        if binary:
            with open(path, "wb") as f:
                f.write(struct.pack("<Q", len(self.cameras)))
                for c in self.cameras.values():
                    f.write(struct.pack("<iiQQ", c.camera_id, c.model_id, c.width, c.height))
                    f.write(np.asarray(c.params, np.float64).tobytes())
        else:
            with open(path, "w") as f:
                f.write("# Camera list\n")
                for c in self.cameras.values():
                    p = " ".join(f"{x:.12g}" for x in c.params)
                    f.write(f"{c.camera_id} {c.model_name} {c.width} {c.height} {p}\n")

    def _read_cameras_bin(self, path):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            for _ in range(n):
                cid, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
                k = cm.NUM_PARAMS[model_id]
                params = np.frombuffer(f.read(8 * k), "<f8").copy()
                self.add_camera(Camera(cid, model_id, int(w), int(h), params))

    def _read_cameras_txt(self, path):
        with open(path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                tok = line.split()
                cid, model, w, h = int(tok[0]), tok[1], int(tok[2]), int(tok[3])
                params = np.asarray([float(x) for x in tok[4:]])
                self.add_camera(Camera(cid, cm.MODEL_IDS[model], w, h, params))

    def _write_images(self, path, binary):
        if binary:
            with open(path, "wb") as f:
                reg = [i for i in self.images.values() if i.registered]
                f.write(struct.pack("<Q", len(reg)))
                for im in reg:
                    f.write(struct.pack("<i", im.image_id))
                    f.write(np.asarray(im.qvec, "<f8").tobytes())
                    f.write(np.asarray(im.tvec, "<f8").tobytes())
                    f.write(struct.pack("<i", im.camera_id))
                    f.write(im.name.encode() + b"\x00")
                    f.write(struct.pack("<Q", im.xys.shape[0]))
                    rec = np.empty((im.xys.shape[0], 3), "<f8")
                    rec[:, :2] = im.xys
                    rec[:, 2] = im.point3D_ids.astype(np.float64)
                    # COLMAP stores x,y as double and point3D_id as int64
                    buf = np.empty(im.xys.shape[0], dtype=[("x", "<f8"), ("y", "<f8"), ("pid", "<i8")])
                    buf["x"] = im.xys[:, 0]
                    buf["y"] = im.xys[:, 1]
                    buf["pid"] = im.point3D_ids
                    f.write(buf.tobytes())
        else:
            with open(path, "w") as f:
                f.write("# Image list\n")
                for im in self.images.values():
                    if not im.registered:
                        continue
                    q = " ".join(f"{x:.12g}" for x in im.qvec)
                    t = " ".join(f"{x:.12g}" for x in im.tvec)
                    f.write(f"{im.image_id} {q} {t} {im.camera_id} {im.name}\n")
                    pts = " ".join(
                        f"{x:.6f} {y:.6f} {int(pid)}"
                        for (x, y), pid in zip(im.xys, im.point3D_ids)
                    )
                    f.write(pts + "\n")

    def _read_images_bin(self, path):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            for _ in range(n):
                (iid,) = struct.unpack("<i", f.read(4))
                qvec = np.frombuffer(f.read(32), "<f8").copy()
                tvec = np.frombuffer(f.read(24), "<f8").copy()
                (cid,) = struct.unpack("<i", f.read(4))
                name = b""
                while True:
                    c = f.read(1)
                    if c == b"\x00":
                        break
                    name += c
                (npts,) = struct.unpack("<Q", f.read(8))
                buf = np.frombuffer(
                    f.read(24 * npts), dtype=[("x", "<f8"), ("y", "<f8"), ("pid", "<i8")]
                )
                img = Image(
                    iid, name.decode(), cid, qvec, tvec, True,
                    np.stack([buf["x"], buf["y"]], -1).copy() if npts else np.zeros((0, 2)),
                    buf["pid"].copy() if npts else np.zeros((0,), np.int64),
                )
                self.add_image(img)
                self.registered_ids.append(iid)

    def _read_images_txt(self, path):
        with open(path) as f:
            lines = [l for l in f if not l.startswith("#") and l.strip()]
        for i in range(0, len(lines), 2):
            tok = lines[i].split()
            iid = int(tok[0])
            qvec = np.asarray([float(x) for x in tok[1:5]])
            tvec = np.asarray([float(x) for x in tok[5:8]])
            cid = int(tok[8])
            name = tok[9]
            ptok = lines[i + 1].split() if i + 1 < len(lines) else []
            npts = len(ptok) // 3
            xys = np.asarray([[float(ptok[3 * j]), float(ptok[3 * j + 1])] for j in range(npts)]).reshape(npts, 2)
            pids = np.asarray([int(ptok[3 * j + 2]) for j in range(npts)], np.int64)
            img = Image(iid, name, cid, qvec, tvec, True, xys, pids)
            self.add_image(img)
            self.registered_ids.append(iid)

    def _write_points(self, path, binary):
        if binary:
            with open(path, "wb") as f:
                f.write(struct.pack("<Q", len(self.points3D)))
                for pid, p in self.points3D.items():
                    f.write(struct.pack("<Q", pid))
                    f.write(np.asarray(p.xyz, "<f8").tobytes())
                    f.write(np.asarray(p.color, np.uint8).tobytes())
                    f.write(struct.pack("<d", p.error))
                    f.write(struct.pack("<Q", len(p.track)))
                    for image_id, p2d in p.track:
                        f.write(struct.pack("<ii", image_id, p2d))
        else:
            with open(path, "w") as f:
                f.write("# 3D point list\n")
                for pid, p in self.points3D.items():
                    xyz = " ".join(f"{x:.12g}" for x in p.xyz)
                    col = " ".join(str(int(c)) for c in p.color)
                    trk = " ".join(f"{i} {j}" for i, j in p.track)
                    f.write(f"{pid} {xyz} {col} {p.error:.6g} {trk}\n")

    def _read_points_bin(self, path):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            maxid = 0
            for _ in range(n):
                (pid,) = struct.unpack("<Q", f.read(8))
                xyz = np.frombuffer(f.read(24), "<f8").copy()
                color = np.frombuffer(f.read(3), np.uint8).copy()
                (err,) = struct.unpack("<d", f.read(8))
                (tl,) = struct.unpack("<Q", f.read(8))
                track = []
                for _ in range(tl):
                    iid, p2d = struct.unpack("<ii", f.read(8))
                    track.append((iid, p2d))
                self.points3D[pid] = Point3D(xyz=xyz, color=color, error=err, track=track)
                maxid = max(maxid, pid)
            self._next_point3D_id = maxid + 1

    def _read_points_txt(self, path):
        maxid = 0
        with open(path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                tok = line.split()
                pid = int(tok[0])
                xyz = np.asarray([float(x) for x in tok[1:4]])
                color = np.asarray([int(x) for x in tok[4:7]], np.uint8)
                err = float(tok[7])
                track = [(int(tok[8 + 2 * j]), int(tok[9 + 2 * j])) for j in range((len(tok) - 8) // 2)]
                self.points3D[pid] = Point3D(xyz=xyz, color=color, error=err, track=track)
                maxid = max(maxid, pid)
        self._next_point3D_id = maxid + 1


# ---------------------------------------------------------------------------
# pose.ply prior import/export (controllers/incremental_mapper.cc:922-996,
# ui/main_window.cc:1078-1160): one row per image, x y z roll pitch yaw in the
# LIDAR frame (x fwd, y left, z up), nan rows for unregistered images.


def save_image_poses(path: str, rec: Reconstruction, order: list[int] | None = None):
    from ..ops import np_geom

    ids = order if order is not None else sorted(rec.images.keys())
    rows = []
    for iid in ids:
        img = rec.images[iid]
        if not img.registered:
            rows.append([np.nan] * 6)
            continue
        # one shared convention with LoadPose / init flags (np_geom helpers):
        # R_wc = Ry(-yaw) Rx(-pitch) Rz(roll), radians, lidar-frame position
        x, y, z, r, p, yw = np_geom.cam_pose_to_lidar(img.qvec, img.tvec)
        rows.append([x, y, z, r, p, yw])
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(rows)}\n")
        for prop in ("x", "y", "z", "roll", "pitch", "yaw"):
            f.write(f"property float {prop}\n")
        f.write("end_header\n")
        for row in rows:
            f.write(" ".join("nan" if np.isnan(v) else f"{v:.9g}" for v in row) + "\n")


def load_image_poses(path: str) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """Returns image index (1-based row order) -> (qvec, tvec), skipping nans.

    Exactly LoadPose's convention (controllers/incremental_mapper.cc:953-976):
    R_wc = Ry(-yaw) Rx(-pitch) Rz(roll), radians — shared with
    init_pose_from_options via np_geom.lidar_pose_to_cam."""
    from ..ops import np_geom

    out = {}
    with open(path) as f:
        lines = f.read().splitlines()
    start = lines.index("end_header") + 1
    for i, line in enumerate(lines[start:], start=1):
        tok = line.split()
        if not tok:
            continue
        vals = [float(x) for x in tok[:6]]
        if any(np.isnan(v) for v in vals):
            continue
        x, y, z, roll, pitch, yaw = vals
        q_cw, t_cw = np_geom.lidar_pose_to_cam(x, y, z, roll, pitch, yaw)
        out[i] = (np.asarray(q_cw, np.float64), t_cw)
    return out
