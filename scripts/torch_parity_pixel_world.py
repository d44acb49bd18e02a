#!/usr/bin/env python3
"""Both packages on the light pixel world, on the CPU, stage by stage.

    JAX_PLATFORMS=cpu python3 scripts/torch_parity_pixel_world.py [--n-images 30]
        [--threads 4] [--out DIR] [--resume-at N]

Renders the first N views of the pixel world (the corridor at 640x480,
f = 500, 0.8 m step, as chip_smoke.py's phase 6 and the JAX package's bench
at its light scale) once into PNGs, then runs the JAX package
(colmap_pcd_tpu, its default device pinned to the CPU as tests/conftest.py
does) and the port (colmap_pcd_tpu_torch, device "cpu") on those files with
the same configurations: SIFT (2048 features, first octave 0, 3 octaves,
PINHOLE with the known intrinsics), the sequential matcher at overlap 5
without the quadratic offsets (min_num_inliers 15), and the lidar
IncrementalMapperController with the bench's MapperOptions and the pose
prior of image 1. A third run puts the port's mapper on the JAX package's
database, which separates the front end from the mapper. With
`--resume-at N`, each package's own run also writes a snapshot every N
registrations, and is run again from its N-image snapshot to the end.

It prints, for each stage: keypoints per image in each package, the share
of keypoints with a partner in the other (0.01 px, 1e-3 in scale) and the
share of partners with the same orientation (1e-4 rad);
verified pairs and the pairs only one package verified; inliers per pair
(each package's median and the largest relative difference); the
registration order; registered count, ATE and scale error. The last line
is one JSON object with the numbers.

RANSAC draws differ between the packages (jax.random against
torch.Generator), so two-view inlier sets and the mapper's PnP samples
differ by sampling even where every input agrees; tests/test_torch_e2e.py
allows 0.02 m of ATE between the two for that reason.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from chip_smoke import BENCH_MAPPER_OPTIONS as MAPPER_OPTIONS  # noqa: E402
from chip_smoke import PIXEL_F as F, PIXEL_FEATURES, PIXEL_H as H, PIXEL_OCTAVES  # noqa: E402
from chip_smoke import PIXEL_STEP as STEP, PIXEL_W as W  # noqa: E402


def _log(msg: str):
    print(msg, flush=True)


def _packages():
    """(JAX package modules, port modules): each a dict of the same names."""
    import jax

    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    import torch

    from colmap_pcd_tpu.models import controllers as cj, correspondence_graph as gj, database as dj
    from colmap_pcd_tpu.models import feature_pipeline as fj, incremental_mapper as mj, lidar_map as lj
    from colmap_pcd_tpu.models import reconstruction as rj
    from colmap_pcd_tpu.utils import config as kj
    from colmap_pcd_tpu_torch.models import controllers as ct, correspondence_graph as gt_
    from colmap_pcd_tpu_torch.models import database as dt, feature_pipeline as ft, incremental_mapper as mt
    from colmap_pcd_tpu_torch.models import lidar_map as lt, reconstruction as rt
    from colmap_pcd_tpu_torch.utils import config as kt

    def mods(c, g, d, f, m, lm, r, k):
        return dict(controllers=c, graph=g, database=d, pipeline=f, mapper=m, lidar_map=lm,
                    reconstruction=r, config=k)

    return torch, mods(cj, gj, dj, fj, mj, lj, rj, kj), mods(ct, gt_, dt, ft, mt, lt, rt, kt)


def front_end(pkg: dict, db_path: str, img_dir: str, port: bool) -> dict:
    """Extraction and the sequential matcher into db_path; seconds of each."""
    cfg = pkg["config"]
    fp = pkg["pipeline"]
    extraction = cfg.SiftExtractionConfig(max_num_features=PIXEL_FEATURES, first_octave=0,
                                          num_octaves=PIXEL_OCTAVES, max_image_size=W)
    reader = fp.ImageReaderConfig(camera_model="PINHOLE", camera_params=f"{F},{F},{W / 2},{H / 2}")
    kw = {"device": "cpu"} if port else {}
    t0 = time.perf_counter()
    fp.run_feature_extractor(db_path, img_dir, extraction, reader, **kw)
    t1 = time.perf_counter()
    fp.run_sequential_matcher(db_path, cfg.SiftMatchingConfig(min_num_inliers=15), overlap=5,
                              quadratic_overlap=False, **kw)
    return {"extract_s": t1 - t0, "match_s": time.perf_counter() - t1}


def read_front_end(pkg: dict, db_path: str) -> dict:
    """Keypoints per image and inlier matches per verified pair."""
    db = pkg["database"].Database(db_path)
    kps = {iid: db.read_keypoints(iid)[:, :4].copy() for iid in sorted(db.images())}
    pairs = {}
    for i, j in db.all_two_view_pair_ids():
        g = db.read_two_view_geometry(i, j)
        if g is not None and len(g["inlier_matches"]) >= 15:
            pairs[(i, j)] = g["inlier_matches"].astype(np.int32)
    db.close()
    return {"keypoints": kps, "pairs": pairs}


def run_mapper(pkg: dict, db_path: str, img_dir: str, map_pts, map_nrm, gt, port: bool,
               snapshot_path: str = "", snapshot_freq: int = 0, input_path: str = "") -> dict:
    """The lidar controller on a database, as bench.py's non-overlapped
    branch builds its reconstruction and graph; with `input_path`, on the
    model written there, as the mapper command's --input_path loads it
    (the database's camera, the images the model lacks added)."""
    R, G = pkg["reconstruction"], pkg["graph"]
    db = pkg["database"].Database(db_path)
    rec = R.Reconstruction.read(input_path) if input_path else R.Reconstruction()
    rec.add_camera(R.Camera(1, 1, W, H, np.asarray([F, F, W / 2, H / 2])))
    for iid, im in sorted(db.images().items()):
        if iid in rec.images:
            continue
        kp = db.read_keypoints(iid)
        rec.add_image(R.Image(iid, im["name"], 1, xys=kp[:, :2].astype(np.float64)))
    graph = G.CorrespondenceGraph()
    for i, j in db.all_two_view_pair_ids():
        g = db.read_two_view_geometry(i, j)
        if g is not None and len(g["inlier_matches"]) >= 15:
            graph.add_matches(i, j, g["inlier_matches"].astype(np.int32))
    db.close()
    kw = {"device": "cpu"} if port else {}
    lmap = pkg["lidar_map"].LidarMap.from_arrays(map_pts, map_nrm, **kw)
    C = pkg["controllers"]
    ctl = C.IncrementalMapperController(
        rec, graph, pkg["mapper"].MapperOptions(**MAPPER_OPTIONS),
        C.ControllerOptions(verbose=False, image_path=img_dir, snapshot_path=snapshot_path,
                            snapshot_images_freq=snapshot_freq), lidar_map=lmap,
        pose_priors={1: gt[0]}, **kw,
    )
    order = []
    ctl.callbacks.append(order.append)
    t0 = time.perf_counter()
    ctl.reconstruct()
    seconds = time.perf_counter() - t0
    from synthetic_torch import ate_rmse, scale_error

    return {"registered": rec.num_reg_images, "order": [int(i) for i in order],
            "ate_m": ate_rmse(rec, gt), "scale_err": scale_error(rec, gt), "seconds": seconds,
            "points": len(rec.points3D)}


def keypoint_partners(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    """Keypoints as the database holds them, (x, y, a11, a12): scale
    s = hypot(a11, a12) and orientation atan2(-a12, a11). Returns the share
    of keypoints with a partner in the other set within 0.01 px and 1e-3
    relative scale (tests/test_torch_sift.py's partner test; the smaller of
    the two ways), and the share of a's partners whose orientation agrees
    within 1e-4 rad (the SIFT bar's), each taken at the closest orientation
    among the partners at its location (SIFT gives a point one keypoint per
    orientation histogram peak)."""
    from scipy.spatial import cKDTree

    def scale_ori(k):
        return np.hypot(k[:, 2], k[:, 3]), np.arctan2(-k[:, 3], k[:, 2])

    def one(p, q):
        if len(p) == 0 or len(q) == 0:
            return np.zeros(len(p), bool), np.zeros(len(p), bool)
        (sp, op), (sq, oq) = scale_ori(p), scale_ori(q)
        d, j = cKDTree(q[:, :2]).query(p[:, :2], k=min(4, len(q)))
        d, j = d.reshape(len(p), -1), j.reshape(len(p), -1)
        ok = (d <= 0.01) & (np.abs(sq[j] / sp[:, None] - 1.0) <= 1e-3)
        dtheta = np.where(ok, np.abs(np.angle(np.exp(1j * (op[:, None] - oq[j])))), np.inf)
        return ok.any(1), dtheta.min(1) <= 1e-4

    partnered, same = one(a, b)
    back, _ = one(b, a)
    same_share = float(same[partnered].mean()) if partnered.any() else 0.0
    return min(float(partnered.mean()), float(back.mean())), same_share


def compare_front_ends(fj: dict, ft: dict) -> dict:
    kj, kt = fj["keypoints"], ft["keypoints"]
    counts = [(len(kj[i]), len(kt[i])) for i in sorted(kj)]
    shares = {i: keypoint_partners(kj[i], kt[i]) for i in sorted(kj)}
    partners = [p for p, _ in shares.values()]
    same_ori = {i: o for i, (_, o) in shares.items()}
    worst = min(same_ori, key=same_ori.get)
    pj, pt = set(fj["pairs"]), set(ft["pairs"])
    both = sorted(pj & pt)
    nj = np.array([len(fj["pairs"][p]) for p in both])
    nt = np.array([len(ft["pairs"][p]) for p in both])
    rel = np.abs(nt - nj) / np.maximum(nj, 1)

    def coords(kps, p, m):
        """A pair's inlier matches as rounded keypoint coordinates (the two
        packages may order equal-scored keypoints differently)."""
        xy = np.concatenate([kps[p[0]][m[:, 0], :2], kps[p[1]][m[:, 1], :2]], axis=1)
        return {tuple(r) for r in np.round(xy / 0.01).astype(np.int64)}

    same_rows = [len(coords(kj, p, fj["pairs"][p]) & coords(kt, p, ft["pairs"][p]))
                 / max(len(fj["pairs"][p]), 1) for p in both]
    return {
        "keypoints_equal_count": sum(a == b for a, b in counts), "images": len(counts),
        "keypoints_jax": [a for a, _ in counts], "keypoints_port": [b for _, b in counts],
        "min_partner_share": min(partners),
        "min_same_orientation_share": same_ori[worst], "worst_orientation_image": int(worst),
        "images_below_orientation_bar": sum(o < 0.99 for o in same_ori.values()),
        "pairs_jax": len(pj), "pairs_port": len(pt), "only_jax": sorted(pj - pt), "only_port": sorted(pt - pj),
        "inliers_median_jax": float(np.median(nj)) if len(nj) else 0.0,
        "inliers_median_port": float(np.median(nt)) if len(nt) else 0.0,
        "inliers_max_rel_diff": float(rel.max()) if len(rel) else 0.0,
        "inliers_mean_rel_diff": float(rel.mean()) if len(rel) else 0.0,
        "inlier_rows_shared_min": float(min(same_rows)) if same_rows else 0.0,
        "inlier_rows_shared_mean": float(np.mean(same_rows)) if same_rows else 0.0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-images", type=int, default=30)
    ap.add_argument("--threads", type=int, default=4, help="torch CPU threads")
    ap.add_argument("--out", default=None, help="working directory (default: a temporary one)")
    ap.add_argument("--resume-at", type=int, default=0,
                    help="each package's own mapper run writes a snapshot every N registrations and is "
                         "resumed from the one of N images, as `mapper --input_path` does")
    args = ap.parse_args(argv)
    torch, jax_pkg, port_pkg = _packages()
    torch.set_num_threads(args.threads)
    from synthetic_torch import build_corridor_map, make_trajectory, render_images

    out = args.out or tempfile.mkdtemp(prefix="parity_pixel_world_")
    os.makedirs(out, exist_ok=True)
    img_dir = os.path.join(out, "images")
    gt = make_trajectory(args.n_images, STEP)
    t0 = time.perf_counter()
    if not os.path.isdir(img_dir):
        os.makedirs(img_dir)
        render_images(img_dir, gt, W, H, F, workers=args.threads)
    map_pts, map_nrm = build_corridor_map(np.random.default_rng(0), length=args.n_images * STEP + 25)
    _log(f"[world] {args.n_images} views at {W}x{H}, {map_pts.shape[0]} map points, "
         f"{time.perf_counter() - t0:.1f} s, in {out}")

    dbs = {"jax": os.path.join(out, "jax.db"), "port": os.path.join(out, "port.db")}
    timing = {}
    for name, pkg in (("jax", jax_pkg), ("port", port_pkg)):
        if os.path.exists(dbs[name]):
            os.remove(dbs[name])
        timing[name] = front_end(pkg, dbs[name], img_dir, port=name == "port")
        _log(f"[front end] {name}: extraction {timing[name]['extract_s']:.1f} s, "
             f"matcher {timing[name]['match_s']:.1f} s")
    fe = compare_front_ends(read_front_end(jax_pkg, dbs["jax"]), read_front_end(port_pkg, dbs["port"]))
    _log(f"[keypoints] equal counts on {fe['keypoints_equal_count']} of {fe['images']} images; "
         f"jax {min(fe['keypoints_jax'])}-{max(fe['keypoints_jax'])}, port "
         f"{min(fe['keypoints_port'])}-{max(fe['keypoints_port'])}; smallest partner share "
         f"{fe['min_partner_share']:.4f}; same orientation (1e-4 rad) among the partners: least "
         f"{fe['min_same_orientation_share']:.4f} (image {fe['worst_orientation_image']}), "
         f"{fe['images_below_orientation_bar']} images under 0.99")
    _log(f"[pairs] verified: jax {fe['pairs_jax']}, port {fe['pairs_port']}; only jax {fe['only_jax']}, "
         f"only port {fe['only_port']}")
    _log(f"[inliers] median per pair jax {fe['inliers_median_jax']:.1f}, port "
         f"{fe['inliers_median_port']:.1f}; relative difference mean {fe['inliers_mean_rel_diff']:.4f}, "
         f"max {fe['inliers_max_rel_diff']:.4f}; share of the JAX inliers (by keypoint coordinates) the port also keeps: "
         f"mean {fe['inlier_rows_shared_mean']:.4f}, least {fe['inlier_rows_shared_min']:.4f}")

    snaps = {name: os.path.join(out, f"snapshots_{name}") for name in dbs}
    for path in snaps.values():
        shutil.rmtree(path, ignore_errors=True)
    runs = {
        name: run_mapper(pkg, dbs[name], img_dir, map_pts, map_nrm, gt, port=name == "port",
                         snapshot_path=snaps[name] if args.resume_at else "", snapshot_freq=args.resume_at)
        for name, pkg in (("jax", jax_pkg), ("port", port_pkg))
    }
    runs["port on the jax database"] = run_mapper(port_pkg, dbs["jax"], img_dir, map_pts, map_nrm, gt,
                                                  port=True)
    for name, pkg in (("jax", jax_pkg), ("port", port_pkg)) if args.resume_at else ():
        R = pkg["reconstruction"].Reconstruction
        held = {d: R.read(os.path.join(snaps[name], d)).num_reg_images for d in os.listdir(snaps[name])}
        start = next(d for d, n in sorted(held.items()) if n == args.resume_at)
        runs[f"{name} resumed from {args.resume_at}"] = run_mapper(
            pkg, dbs[name], img_dir, map_pts, map_nrm, gt, port=name == "port",
            input_path=os.path.join(snaps[name], start))
    for name, r in runs.items():
        _log(f"[mapper] {name}: registered {r['registered']}/{args.n_images}, ATE {r['ate_m'] * 1e3:.3f} mm, "
             f"scale error {r['scale_err']:.6f}, {r['points']} points, {r['seconds']:.1f} s; order "
             f"{r['order']}")
    order_j = runs["jax"]["order"]
    for name in ("port", "port on the jax database"):
        o = runs[name]["order"]
        first = next((k for k, (a, b) in enumerate(zip(order_j, o)) if a != b), min(len(o), len(order_j)))
        _log(f"[order] {name} against jax: the same for the first {first} registrations")
    print(json.dumps({"n_images": args.n_images, "front_end": {k: v for k, v in fe.items()
                                                              if not k.startswith("keypoints_")},
                      "timing": timing, "mappers": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
