"""Synthetic corridor world for the PyTorch port (imports no JAX).

Mirrors tests/synthetic.py, which imports the JAX package: for one seed both
build the same map, trajectory, keypoints and matches. The world itself
(a lidar map of two walls and a ground plane, a forward-moving trajectory,
keypoints and a correspondence graph, with exact ground truth for ATE) is
the package's colmap_pcd_tpu_torch/utils/synthetic_world.py. `make_descriptor_world` adds SIFT-like uint8
descriptors and distractor keypoints, so that the matchers can rebuild the
matches from the database."""

from __future__ import annotations

import numpy as np

from colmap_pcd_tpu_torch.models.correspondence_graph import CorrespondenceGraph
from colmap_pcd_tpu_torch.models.lidar_map import LidarMap
from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction
from colmap_pcd_tpu_torch.ops import camera_models as cm
from colmap_pcd_tpu_torch.ops import np_geom
from colmap_pcd_tpu_torch.utils.synthetic_world import PINHOLE, build_corridor_map, make_world  # noqa: F401
from colmap_pcd_tpu_torch.utils.synthetic_world import make_world_with_ids as _make_world


def _sift_like(rng, n: int) -> np.ndarray:
    """Random non-negative unit descriptors [n, 128] (squared normals: a
    random pair lies ~1.2 rad apart, a spread like SIFT's)."""
    d = rng.normal(size=(n, 128)) ** 2
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def make_descriptor_world(rng, distractor_share=0.1, desc_noise=0.02, **kw):
    """make_world whose images also carry descriptors, for the matchers.

    Each world point gets a random non-negative 128-dim descriptor; each
    observation gets it with N(0, desc_noise) per entry, clipped at 0,
    renormalized and quantized as the JAX package's
    `sift.descriptors_to_uint8` does (x 512, rounded, clipped to [0, 255]).
    At 0.02 two observations of a point lie ~0.3 rad apart, well inside
    max_distance 0.7 and the 0.8 ratio against the ~1.2 rad of a random
    pair. `distractor_share` of extra keypoints per image get random
    descriptors; other keywords go to make_world. Returns (rec, graph, lidar_map, gt_poses, descriptors
    {image_id: uint8 [n_kp, 128]}, point_ids {image_id: [n_kp]}, -1 for a
    distractor); the graph holds the ground-truth correspondences."""
    rec, graph, lmap, gt, point_ids = _make_world(rng, distractor_share=distractor_share, **kw)
    base = _sift_like(rng, max(int(p.max(initial=-1)) for p in point_ids.values()) + 1)
    descriptors = {}
    for iid in sorted(rec.images):
        pid = point_ids[iid]
        d = np.where(pid[:, None] >= 0, base[np.maximum(pid, 0)], _sift_like(rng, pid.size))
        d = np.maximum(d + rng.normal(0, desc_noise, d.shape), 0.0)
        d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
        descriptors[iid] = np.clip(np.round(d * 512.0), 0, 255).astype(np.uint8)
    return rec, graph, lmap, gt, descriptors, point_ids


def match_precision_recall(database_path: str, point_ids: dict) -> dict:
    """Precision of the inlier matches the matcher wrote (two-view
    geometries) against the generator's correspondences, and recall over
    the correspondences of every pair the matcher tried."""
    from colmap_pcd_tpu_torch.models.database import Database, pair_id_to_image_pair

    db = Database(database_path)
    tried = [pair_id_to_image_pair(r[0]) for r in db.conn.execute("SELECT pair_id FROM matches")]
    tp = written = gt_total = verified = 0
    for i, j in tried:
        pi, pj = point_ids[i], point_ids[j]
        gt_total += len(np.intersect1d(pi[pi >= 0], pj[pj >= 0]))
        g = db.read_two_view_geometry(i, j)
        if g is None or len(g["inlier_matches"]) == 0:
            continue
        verified += 1
        m = g["inlier_matches"].astype(np.int64)
        a, b = pi[m[:, 0]], pj[m[:, 1]]
        tp += int(np.sum((a >= 0) & (a == b)))
        written += len(m)
    db.close()
    return {
        "pairs_tried": len(tried),
        "pairs_verified": verified,
        "inlier_matches": written,
        "precision": tp / max(written, 1),
        "recall": tp / max(gt_total, 1),
    }


def ate_rmse(rec: Reconstruction, gt) -> float:
    """RMSE of camera centers vs ground truth over registered images (meters)."""
    errs = []
    for i, (q, t) in enumerate(gt, start=1):
        img = rec.images.get(i)
        if img is None or not img.registered:
            continue
        c_gt = np_geom.projection_center(q, t)
        errs.append(np.sum((img.projection_center() - c_gt) ** 2))
    if not errs:
        return np.inf
    return float(np.sqrt(np.mean(errs)))


def scale_error(rec: Reconstruction, gt) -> float:
    """Relative error of the first-to-last registered camera distance."""
    last = max(rec.registered_ids)
    d_est = np.linalg.norm(
        rec.images[last].projection_center() - rec.images[1].projection_center()
    )
    d_gt = np.linalg.norm(
        np_geom.projection_center(*gt[last - 1]) - np_geom.projection_center(*gt[0])
    )
    return abs(d_est - d_gt) / d_gt


def write_world(rec: Reconstruction, graph: CorrespondenceGraph, lmap: LidarMap, gt, out_dir: str,
                prior_ids=(1,), descriptors: dict | None = None) -> dict:
    """Write a world as the `mapper` command's inputs: a COLMAP database with
    keypoints and verified matches, the map as a lidar-frame PLY with
    normals, and a pose-prior file holding the ground truth of `prior_ids`.
    Given `descriptors` (make_descriptor_world), the database holds them
    and no two-view geometries: a matcher command writes those. Returns
    the paths."""
    import os

    from colmap_pcd_tpu_torch.models.database import Database

    paths = {"database": os.path.join(out_dir, "database.db")}
    db = Database(paths["database"])
    for cid, cam in rec.cameras.items():
        db.add_camera(cam.model_id, cam.width, cam.height, cam.params, camera_id=cid)
    for iid in sorted(rec.images):
        img = rec.images[iid]
        db.add_image(img.name, img.camera_id, image_id=iid)
        kp = np.zeros((img.xys.shape[0], 4), np.float32)
        kp[:, :2] = img.xys
        db.write_keypoints(iid, kp)
        if descriptors is not None:
            db.write_descriptors(iid, descriptors[iid])
    if descriptors is None:
        for i, j in sorted(graph.image_pairs()):
            db.write_two_view_geometry(i, j, graph.matches_between(i, j), config=2)
    db.commit()
    db.close()

    paths.update(write_lidar_files(lmap.points, lmap.normals, gt, out_dir, prior_ids))
    return paths


def write_lidar_files(points, normals, gt, out_dir: str, prior_ids=(1,)) -> dict:
    """The map as a lidar-frame PLY with normals and a pose-prior file
    holding the ground truth of `prior_ids`. Returns their paths."""
    import os

    from colmap_pcd_tpu_torch.io import ply as ply_io
    from colmap_pcd_tpu_torch.models.lidar_map import camera_to_lidar_frame

    paths = {
        "lidar": os.path.join(out_dir, "lidar.ply"),
        "poses": os.path.join(out_dir, "pose_prior.ply"),
    }
    ply_io.write_ply(paths["lidar"], camera_to_lidar_frame(points), camera_to_lidar_frame(normals))
    # one row per image (1-based order): x y z roll pitch yaw in the lidar
    # frame, nan where no prior is given (LoadPose's format)
    rows = []
    for iid in range(1, len(gt) + 1):
        rows.append(np_geom.cam_pose_to_lidar(*gt[iid - 1]) if iid in prior_ids else [np.nan] * 6)
    with open(paths["poses"], "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {len(rows)}\n")
        for prop in ("x", "y", "z", "roll", "pitch", "yaw"):
            f.write(f"property float {prop}\n")
        f.write("end_header\n")
        for row in rows:
            f.write(" ".join("nan" if np.isnan(v) else f"{v:.9g}" for v in row) + "\n")
    return paths


def make_trajectory(n_images: int, step: float = 0.8) -> list:
    """The forward corridor trajectory of the pixel worlds (the JAX
    package's bench and tests/test_full_stack.py): world-to-camera (q, t)
    per image, swaying a little and yawing by up to 0.03 rad."""
    gt = []
    for i in range(n_images):
        c = np.asarray([0.5 * np.sin(i * 0.6), 0.25 * np.cos(i * 0.4), i * step])
        yaw = 0.03 * np.sin(i * 0.9)
        q_wc = np.asarray([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0])
        q_cw = np_geom.quat_conj(q_wc)
        gt.append((q_cw, -np_geom.quat_to_rotmat(q_cw) @ c))
    return gt


def render_images(img_dir: str, gt, width: int, height: int, focal: float,
                  model_id=None, params=None, workers: int = 1) -> None:
    """Ray-cast the corridor for every pose into `img_dir` as v0000.png ...
    (uint8 grayscale), on `workers` threads."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image as PILImage

    from render_torch import render_corridor

    def one(i):
        im = render_corridor(*gt[i], width, height, focal, model_id=model_id, params=params)
        PILImage.fromarray((im * 255).astype(np.uint8)).save(os.path.join(img_dir, f"v{i:04d}.png"))

    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(one, range(len(gt))))


def mapper_argv(paths: dict, out_dir: str, *extra: str) -> list:
    """The `mapper` command line for the files of write_world, seeded by the
    pose prior of image 1 and initialized on the pair (1, 2)."""
    return [
        "mapper",
        "--database_path", paths["database"],
        "--Mapper.lidar_pointcloud_path", paths["lidar"],
        "--Mapper.if_import_pose_prior", "1",
        "--Mapper.image_pose_prior_path", paths["poses"],
        "--Mapper.init_image_id1", "1",
        "--Mapper.init_image_id2", "2",
        "--output_path", out_dir,
        *extra,
    ]


def classic_mapper_argv(paths: dict, out_dir: str, init=(1, 3), *extra: str) -> list:
    """The `mapper` command line without a lidar map: classic two-view
    initialization on the pair `init`."""
    return [
        "mapper",
        "--database_path", paths["database"],
        "--Mapper.init_image_id1", str(init[0]),
        "--Mapper.init_image_id2", str(init[1]),
        "--output_path", out_dir,
        *extra,
    ]


def corridor_ba_problem(rng, n_cams: int):
    """tests/test_ba_pcg.py's corridor in numpy: camera i at (i, 0, 0)
    looking +z at 4 points per camera 8-12 m ahead, each seen by the
    cameras within 3 m of it (tracks of at most 7), identity rotations, a
    PINHOLE camera (f 500, 640x480). Returns (qs, ts, intr [12], points,
    obs_cam, obs_pt, obs_uv) of the noiseless truth."""
    n_pts = n_cams * 4
    pts = np.stack(
        [rng.uniform(0, n_cams, n_pts), rng.uniform(-2, 2, n_pts), rng.uniform(8, 12, n_pts)], axis=-1
    ).astype(np.float32)
    f, cx, cy = 500.0, 320.0, 240.0
    intr = np.pad(np.asarray([f, f, cx, cy], np.float32), (0, cm.MAX_PARAMS - 4))
    qs = np.tile(np.array([1.0, 0, 0, 0], np.float32), (n_cams, 1))
    ts = np.stack([-np.arange(n_cams, dtype=np.float32), np.zeros(n_cams, np.float32),
                   np.zeros(n_cams, np.float32)], axis=-1)
    vis = np.abs(pts[None, :, 0] - np.arange(n_cams, dtype=np.float32)[:, None]) < 3.0  # [C,P]
    oc, op = np.nonzero(vis)
    xc = pts[op] + ts[oc]  # R = I
    ouv = np.stack([f * xc[:, 0] / xc[:, 2] + cx, f * xc[:, 1] / xc[:, 2] + cy], -1)
    return qs, ts, intr, pts, oc.astype(np.int32), op.astype(np.int32), ouv.astype(np.float32)
