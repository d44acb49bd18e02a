"""Job kind `pipeline`: one capture from pixels on disk to a lidar-registered
model, through the port's public entry points in the bench's order.

Front end (the workload's `front_end`):
  sequential   run_feature_extractor, then run_sequential_matcher, then the
               images into the model and the graph of the pairs with at
               least `min_num_inliers` inlier matches;
  overlapped   run_overlapped_frontend, whose feed the controller drains.
Then the corridor map is built and handed to LidarMap.from_arrays (inside
the job, as the bench builds it), and IncrementalMapperController
reconstructs with the configuration's MapperOptions, the known PINHOLE
camera and the pose prior of the first view.

The deadline is checked between the stages and at each registration (the
controller's callback); past it the job stops unfinished, and the harness
counts only finished captures. The record carries the model (poses by image
name, points, tracks), the registered count, the database's path and the
front end's numbers.
"""

from __future__ import annotations

import os
import time

import numpy as np

from benchmarks import harness
from benchmarks.reference import check as reference


def _options(ctx):
    from colmap_pcd_tpu_torch.models.feature_pipeline import ImageReaderConfig
    from colmap_pcd_tpu_torch.models.incremental_mapper import MapperOptions
    from colmap_pcd_tpu_torch.utils.config import SiftExtractionConfig, SiftMatchingConfig

    cfg = ctx.cell.config
    extraction = SiftExtractionConfig(**{k: cfg[k] for k in harness.SIFT_KEYS})
    matching = ctx.options("matching", SiftMatchingConfig(**cfg["matching"]))
    mapper = ctx.options("mapper", MapperOptions(**cfg["mapper"]))
    # the reader's default camera, as the bench's (the matcher verifies with it)
    return extraction, matching, ImageReaderConfig(), mapper


def _sequential_front(ctx, rec, database, extraction, matching, reader):
    from colmap_pcd_tpu_torch.models.correspondence_graph import CorrespondenceGraph
    from colmap_pcd_tpu_torch.models.database import Database
    from colmap_pcd_tpu_torch.models.feature_pipeline import run_feature_extractor, run_sequential_matcher
    from colmap_pcd_tpu_torch.models.reconstruction import Image

    with ctx.spans.span("extract"):
        run_feature_extractor(database, ctx.image_dir, extraction, reader, device=ctx.device)
    ctx.check_deadline()
    with ctx.spans.span("match"):
        verified = run_sequential_matcher(database, matching, **ctx.cell.config["sequential_matching"],
                                          device=ctx.device)
    ctx.check_deadline()
    db = Database(database)
    try:
        for iid, im in sorted(db.images().items()):
            rec.add_image(Image(iid, im["name"], 1, xys=db.read_keypoints(iid)[:, :2].astype(np.float64)))
        graph = CorrespondenceGraph()
        pairs = db.all_two_view_pair_ids()
        for i, j in pairs:
            g = db.read_two_view_geometry(i, j)
            if g is not None and len(g["inlier_matches"]) >= matching.min_num_inliers:
                graph.add_matches(i, j, g["inlier_matches"].astype(np.int32))
    finally:
        db.close()
    return graph, {"pairs_matched": len(pairs), "pairs_verified": verified}


def model_of(rec) -> dict:
    """The model as plain arrays: each registered image's (q, t) by name, the
    points, their tracks as (point row, image name, keypoint x, y), and the
    camera's parameters."""
    poses = {img.name: (np.asarray(img.qvec, np.float64), np.asarray(img.tvec, np.float64))
             for img in rec.images.values() if img.registered}
    pids = sorted(rec.points3D)
    xyz = np.asarray([rec.points3D[p].xyz for p in pids], np.float64).reshape(-1, 3)
    rows, names, xy = [], [], []
    for row, p in enumerate(pids):
        for iid, k in rec.points3D[p].track:
            img = rec.images[iid]
            rows.append(row)
            names.append(img.name)
            xy.append(img.xys[k])
    cams = {cid: (c.model_id, np.asarray(c.params, np.float64)) for cid, c in rec.cameras.items()}
    cam_of = {img.name: img.camera_id for img in rec.images.values()}
    return {"poses": poses, "points": xyz, "obs_point": np.asarray(rows, np.int64),
            "obs_image": names, "obs_xy": np.asarray(xy, np.float64).reshape(-1, 2),
            "cameras": cams, "camera_of": cam_of}


def run(ctx) -> dict:
    from colmap_pcd_tpu_torch.models.controllers import ControllerOptions, IncrementalMapperController
    from colmap_pcd_tpu_torch.models.correspondence_graph import CorrespondenceGraph
    from colmap_pcd_tpu_torch.models.lidar_map import LidarMap
    from colmap_pcd_tpu_torch.models.overlap import run_overlapped_frontend
    from colmap_pcd_tpu_torch.models.reconstruction import Camera, Reconstruction
    from colmap_pcd_tpu_torch.ops import camera_models
    from colmap_pcd_tpu_torch.ops import pointcloud as pc_ops

    cfg, wl = ctx.cell.config, ctx.cell.workload
    world = ctx.cell.world()
    W, H, F = cfg["image_width"], cfg["image_height"], cfg["focal_length"]
    extraction, matching, reader, mapper_opts = _options(ctx)
    database = os.path.join(ctx.work_dir, "database.db")
    overlapped = wl["front_end"] == "overlapped"
    record = {"index": ctx.index, "views": ctx.views, "database": database, "stopped": False,
              "t_start": time.perf_counter()}
    rec = Reconstruction()
    rec.add_camera(Camera(1, camera_models.MODEL_IDS[cfg["camera_model"]], W, H, np.asarray([F, F, W / 2, H / 2])))
    feed = threads = None
    try:
        if overlapped:
            feed, *threads = run_overlapped_frontend(
                database, ctx.image_dir, extraction, matching, reader, **cfg["sequential_matching"],
                device=ctx.device)
            graph, front = CorrespondenceGraph(), {}
        else:
            graph, front = _sequential_front(ctx, rec, database, extraction, matching, reader)
        record.update(front)
        with ctx.spans.span("map_build"):
            pts, nrm = world.build_corridor_map(ctx.views * cfg["step_m"] + world.MAP_MARGIN, cfg["map_spacing_m"])
            lmap = LidarMap.from_arrays(pts, nrm, pc_ops.ProjOptions(), device=ctx.device)
        ctl = IncrementalMapperController(
            rec, graph, mapper_opts, ControllerOptions(verbose=False, image_path=ctx.image_dir),
            lidar_map=lmap, pose_priors={1: ctx.truth[0]}, pair_feed=feed, device=ctx.device)

        ctl.callbacks.append(lambda _image_id: ctx.check_deadline())
        with ctx.spans.span("map"):
            ok = ctl.reconstruct()
        if not ok:
            raise RuntimeError(f"job {ctx.index}: the mapper found no initial pair")
    except harness.Deadline:
        record["stopped"] = True
    record["t_end"] = time.perf_counter()
    record["registered"] = rec.num_reg_images
    if feed is not None:
        # the front end's numbers as they stand at the end (or the stop)
        record.update(pairs_matched=feed.n_pairs_matched, pairs_verified=feed.n_pairs_verified,
                      match_busy_s=feed.match_busy_s)
        record["threads"] = (feed, threads)
    record["model"] = model_of(rec)
    return record


def finish(record: dict) -> None:
    """After the window: let an overlapped job's front-end threads end (a
    stopped job's run on outside the window) and surface their errors."""
    if "threads" not in record:
        return
    feed, threads = record.pop("threads")
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads):
        raise RuntimeError(f"job {record['index']}: the overlapped front end's threads did not end")
    if feed.error is not None:
        raise RuntimeError(f"job {record['index']}: the overlapped front end failed: {feed.error!r}")
    record.update(pairs_matched=feed.n_pairs_matched, pairs_verified=feed.n_pairs_verified)


def judge(cell, jobs: list, truths: dict, deadline: float) -> dict:
    """The reference's numbers over every job of the window: a finished job
    whole, a job stopped at the deadline on what it had produced (the
    matches its database holds, the images it had registered); the first
    job's alone (for the end-to-end metric ate_mm); whether the first job
    ended after the deadline."""
    tolerance = cell.config["guarantees"]["pose_tolerance_mm"]
    rows, partial = [], []
    for r in jobs:
        truth = truths[r["index"]]
        row = reference.check_front(reference.read_database(r["database"]), truth, cell.config, cell.workload)
        model = r["model"]
        if not r["stopped"] or (len(model["poses"]) >= 2 and len(model["points"])):
            row.update(reference.check_model(model, truth, tolerance))
        (partial if r["stopped"] else rows).append(row)
    numbers = reference.match_numbers(rows + partial)
    # what never came is asked of finished jobs only
    numbers["missing"] = float(sum(reference.missing(p) + p.get("unregistered", 0) for p in rows))
    modelled = [p for p in rows + partial if "ate_mm" in p]
    if modelled:
        numbers["images_off"] = float(sum(p["images_off"] for p in modelled))
        for key in ("ate_mm", "worst_mm", "scale_err_pct", "plane_mm", "reproj_px"):
            numbers[key] = max(p[key] for p in modelled)
    numbers["first_job_late"] = float(jobs[0]["t_end"] > deadline)
    return {"numbers": numbers, "per_job": rows, "partial": partial,
            "first_job": reference.check_model(jobs[0]["model"], truths[jobs[0]["index"]], tolerance),
            "failed_images": sum(p["images_without_keypoints"] + p.get("unregistered", 0) for p in rows)}
