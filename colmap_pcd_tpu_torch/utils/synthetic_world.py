"""A synthetic corridor world with exact ground truth: a lidar map (two
walls and a ground plane, with normals), a forward-moving camera
trajectory, 3D feature points on the map surfaces, per-image keypoints and
a correspondence graph, everything the incremental mapper consumes.
`parallel/dryrun.py` maps it; the port's tests build their worlds on it."""

from __future__ import annotations

import numpy as np

from ..models.correspondence_graph import CorrespondenceGraph
from ..models.lidar_map import LidarMap
from ..models.reconstruction import Camera, Image, Reconstruction
from ..ops import camera_models as cm
from ..ops import np_geom
from ..ops import pointcloud as pc_ops

PINHOLE = cm.MODEL_IDS["PINHOLE"]


def build_corridor_map(rng, length=30.0, spacing=0.05):
    """Map-frame (camera convention: x right, y down, z forward):
    walls at x=+-4 (normals -+x), ground at y=2 (normal -y)."""
    zs = np.arange(0.0, length, spacing)
    ys = np.arange(-2.0, 2.0, spacing)
    Z, Y = np.meshgrid(zs, ys)
    wall_l = np.stack([np.full(Z.size, -4.0), Y.ravel(), Z.ravel()], -1)
    wall_r = np.stack([np.full(Z.size, 4.0), Y.ravel(), Z.ravel()], -1)
    nl = np.tile([1.0, 0, 0], (wall_l.shape[0], 1))
    nr = np.tile([-1.0, 0, 0], (wall_r.shape[0], 1))
    xs = np.arange(-4.0, 4.0, spacing * 2)
    X, Z2 = np.meshgrid(xs, zs)
    ground = np.stack([X.ravel(), np.full(X.size, 2.0), Z2.ravel()], -1)
    ng = np.tile([0.0, -1.0, 0], (ground.shape[0], 1))
    pts = np.concatenate([wall_l, wall_r, ground]).astype(np.float32)
    nrm = np.concatenate([nl, nr, ng]).astype(np.float32)
    return pts, nrm


def make_world(rng, **kw):
    """Returns (rec, graph, lidar_map, gt_poses) — a ready-to-run world with
    the lidar map on `device` (keywords of make_world_with_ids)."""
    return make_world_with_ids(rng, **kw)[:4]


def make_world_with_ids(
    rng,
    n_images=10,
    n_points=800,
    noise_px=0.3,
    step=1.0,
    focal=500.0,
    width=640,
    height=480,
    map_spacing=0.05,
    yaw_wiggle=0.02,
    device="cpu",
    distractor_share=0.0,
):
    """make_world, plus `point_ids` {image_id: [n_kp] world-point index of
    each keypoint, -1 for a distractor}. distractor_share > 0 appends that
    share of uniformly placed keypoints to each image (and draws from rng;
    at 0 it draws exactly as make_world always has)."""
    map_pts, map_nrm = build_corridor_map(rng, length=n_images * step + 25, spacing=map_spacing)
    lmap = LidarMap.from_arrays(map_pts, map_nrm, pc_ops.ProjOptions(), device=device)

    # feature points: sample from map surfaces (so lidar constraints are exact)
    sel = rng.choice(map_pts.shape[0], n_points, replace=False)
    X = map_pts[sel].astype(np.float64)

    # trajectory: forward along z with small lateral/yaw wiggle
    gt = []
    for i in range(n_images):
        c = np.asarray([0.4 * np.sin(i * 0.5), 0.2 * np.cos(i * 0.3), i * step])
        yaw = yaw_wiggle * np.sin(i * 0.7)
        # yaw about the camera y axis
        q_wc = np.asarray([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0])
        q_cw = np_geom.quat_conj(q_wc)
        R_cw = np_geom.quat_to_rotmat(q_cw)
        t_cw = -R_cw @ c
        gt.append((q_cw.astype(np.float64), t_cw))

    params = np.asarray([focal, focal, width / 2, height / 2])
    padded = np.pad(params.astype(np.float32), (0, cm.MAX_PARAMS - params.size))

    rec = Reconstruction()
    rec.add_camera(Camera(1, PINHOLE, width, height, params))
    graph = CorrespondenceGraph()

    # project all points into all images; record visibility + keypoints
    feat_of_point = {}  # image_id -> {point_idx: feat_idx}
    point_ids = {}
    for i, (q, t) in enumerate(gt, start=1):
        xy, z = np_geom.project(PINHOLE, padded, q, t, X)
        vis = (
            (z > 2.0) & (z < 25.0)
            & (xy[:, 0] > 5) & (xy[:, 0] < width - 5)
            & (xy[:, 1] > 5) & (xy[:, 1] < height - 5)
        )
        idxs = np.nonzero(vis)[0]
        kps = xy[idxs] + rng.normal(0, noise_px, (idxs.size, 2))
        point_ids[i] = idxs
        if distractor_share > 0:
            n_d = int(round(distractor_share * idxs.size))
            kps = np.concatenate([kps, rng.uniform([5, 5], [width - 5, height - 5], (n_d, 2))])
            point_ids[i] = np.concatenate([idxs, np.full(n_d, -1, idxs.dtype)])
        img = Image(i, f"img{i:04d}.png", 1, xys=kps.astype(np.float64))
        rec.add_image(img)
        graph.add_image(i, kps.shape[0])
        feat_of_point[i] = {int(p): k for k, p in enumerate(idxs)}

    # matches between image pairs within a window
    for i in range(1, n_images + 1):
        for j in range(i + 1, min(i + 5, n_images + 1)):
            shared = sorted(set(feat_of_point[i]) & set(feat_of_point[j]))
            if len(shared) < 8:
                continue
            m = np.asarray(
                [[feat_of_point[i][p], feat_of_point[j][p]] for p in shared], np.int32
            )
            graph.add_matches(i, j, m)

    return rec, graph, lmap, gt, point_ids
