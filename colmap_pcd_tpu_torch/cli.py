"""Command-line interface: `python -m colmap_pcd_tpu_torch <command> [--flags]`.

Port of colmap_pcd_tpu/cli.py. Flags use the reference's namespaced names
(--Mapper.init_image_x, --SiftMatching.max_ratio, ..., utils/config.py).
Every command runs on CUDA. `--device cpu`, anywhere on the line, asks for
the CPU instead (`--device cuda` is the default); `main` strips the flag
before the command parses its own, and resolves the device first, so a
command raises when CUDA is absent and the CPU was not asked for. All 43
commands of the JAX CLI are here.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .utils.config import OptionManager

def _opt(argv):
    om = OptionManager()
    rest = om.parse_args(argv)
    return om, rest


def _split(argv, *names):
    """({name: value} of the given --name flags, the other arguments)."""
    found = {n: None for n in names}
    rest = []
    it = iter(argv)
    for a in it:
        if a.startswith("--") and a[2:] in found:
            found[a[2:]] = next(it)
        else:
            rest.append(a)
    return found, rest


def _load_mapper_inputs(om, input_path=None, device=None):
    """Database -> Reconstruction skeleton + CorrespondenceGraph (+ lidar map
    on `device`, pose priors): the DatabaseCache load step."""
    from .models.correspondence_graph import CorrespondenceGraph
    from .models.database import Database
    from .models.lidar_map import LidarMap
    from .models.reconstruction import Camera, Image, Reconstruction, load_image_poses
    from .ops.pointcloud import ProjOptions

    db = Database(om.database_path)
    rec = Reconstruction() if input_path in (None, "") else Reconstruction.read(input_path)
    for cid, c in db.cameras().items():
        rec.add_camera(
            Camera(
                cid, c["model_id"], c["width"], c["height"], c["params"],
                prior_focal=bool(c.get("prior_focal", False)),
            )
        )
    for iid, im in sorted(db.images().items()):
        kp = db.read_keypoints(iid)
        if iid in rec.images:
            continue
        rec.add_image(Image(iid, im["name"], im["camera_id"], xys=kp[:, :2].astype(np.float64)))
    graph = CorrespondenceGraph()
    min_matches = om.mapper.min_num_matches
    for i, j in db.all_two_view_pair_ids():
        g = db.read_two_view_geometry(i, j)
        if g is not None and len(g["inlier_matches"]) >= min_matches:
            graph.add_matches(i, j, g["inlier_matches"].astype(np.int32))
    db.close()

    lmap = None
    if om.mapper.if_add_lidar_constraint and om.mapper.lidar_pointcloud_path:
        lmap = LidarMap.load(
            om.mapper.lidar_pointcloud_path,
            ProjOptions(
                depth_image_scale=om.mapper.depth_image_scale,
                max_proj_scale=om.mapper.max_proj_scale,
                min_proj_scale=om.mapper.min_proj_scale,
                min_proj_dist=om.mapper.min_proj_dist,
                choose_meter=om.mapper.choose_meter,
                min_lidar_proj_dist=om.mapper.min_lidar_proj_dist,
                submap_cell=om.mapper.submap_length,
            ),
            device=device,
        )
    priors = {}
    if om.mapper.if_import_pose_prior and om.mapper.image_pose_prior_path:
        priors = load_image_poses(om.mapper.image_pose_prior_path)
    return rec, graph, lmap, priors


def _mapper_options(om):
    from .models.incremental_mapper import MapperOptions

    m = om.mapper
    return MapperOptions(
        if_add_lidar_constraint=m.if_add_lidar_constraint and bool(m.lidar_pointcloud_path),
        if_add_lidar_corresponding=m.if_add_lidar_corresponding,
        first_image_fixed_frames=m.first_image_fixed_frames,
        min_proj_num=m.min_proj_num,
        kdtree_max_search_range=m.kdtree_max_search_range,
        kdtree_min_search_range=m.kdtree_min_search_range,
        search_range_drop_speed=m.search_range_drop_speed,
        ba_spherical_search_radius=m.ba_spherical_search_radius,
        ba_match_features_threshold=m.ba_match_features_threshold,
        proj_lidar_constraint_weight=m.proj_lidar_constraint_weight,
        icp_lidar_constraint_weight=m.icp_lidar_constraint_weight,
        icp_ground_lidar_constraint_weight=m.icp_ground_lidar_constraint_weight,
        proj_max_dist_error=m.proj_max_dist_error,
        icp_max_dist_error=m.icp_max_dist_error,
        init_image_id1=m.init_image_id1,
        init_image_id2=m.init_image_id2,
        init_image_x=m.init_image_x,
        init_image_y=m.init_image_y,
        init_image_z=m.init_image_z,
        init_image_roll=m.init_image_roll,
        init_image_pitch=m.init_image_pitch,
        init_image_yaw=m.init_image_yaw,
        init_min_num_inliers=m.init_min_num_inliers,
        init_max_error=m.init_max_error,
        init_min_tri_angle=m.init_min_tri_angle,
        init_max_forward_motion=m.init_max_forward_motion,
        init_max_reg_trials=m.init_max_reg_trials,
        abs_pose_max_error=m.abs_pose_max_error,
        abs_pose_min_num_inliers=m.abs_pose_min_num_inliers,
        abs_pose_min_inlier_ratio=m.abs_pose_min_inlier_ratio,
        max_reg_trials=m.max_reg_trials,
        local_ba_num_images=m.local_ba_num_images,
        filter_max_reproj_error=m.filter_max_reproj_error,
        filter_min_tri_angle=m.filter_min_tri_angle,
    )


# ---------------------------------------------------------------------------
# features and matching


def _reader_config(om):
    from .models.feature_pipeline import ImageReaderConfig

    return ImageReaderConfig(
        camera_model=om.image_reader.camera_model,
        single_camera=om.image_reader.single_camera,
        camera_params=om.image_reader.camera_params,
        default_focal_factor=om.image_reader.default_focal_length_factor,
    )


def cmd_feature_extractor(argv, device):
    om, _ = _opt(argv)
    from .models.feature_pipeline import run_feature_extractor

    n = run_feature_extractor(om.database_path, om.image_path, om.sift_extraction, _reader_config(om),
                              device=device)
    print(f"Extracted features for {n} images")
    return 0


def cmd_feature_importer(argv, device):
    """Import COLMAP text feature files (RunFeatureImporter, exe/feature.cc:177)."""
    # --image_list_path is parsed and unused, as in the JAX package's CLI
    p, rest = _split(argv, "import_path", "image_list_path")
    om, _ = _opt(rest)
    from .models.feature_pipeline import run_feature_importer

    n = run_feature_importer(om.database_path, om.image_path, p["import_path"], _reader_config(om))
    print(f"Imported features for {n} images")
    return 0


def cmd_exhaustive_matcher(argv, device):
    om, _ = _opt(argv)
    from .models.feature_pipeline import run_exhaustive_matcher

    n = run_exhaustive_matcher(om.database_path, om.sift_matching, device=device)
    print(f"Verified {n} image pairs")
    return 0


def _flag(value: str | None, default: bool = False) -> bool:
    """A 0/1 (false/true) flag's value; `default` where it was not given."""
    return default if value is None else value.lower() in ("1", "true")


def cmd_sequential_matcher(argv, device):
    """Sequential matching with the JAX CLI's quadratic overlap (pairs d
    and 2^d apart for d <= overlap); --SequentialMatching.loop_detection 1
    adds retrieval loop candidates, --SequentialMatching.spatial_rerank 1
    re-ranks them by vote-and-verify."""
    p, rest = _split(argv, "SequentialMatching.overlap", "SequentialMatching.loop_detection",
                     "SequentialMatching.spatial_rerank")
    om, _ = _opt([a for a in rest if not a.startswith("--Sequential")])
    from .models.feature_pipeline import run_sequential_matcher

    n = run_sequential_matcher(
        om.database_path, om.sift_matching, overlap=int(p["SequentialMatching.overlap"] or 10),
        loop_detection=_flag(p["SequentialMatching.loop_detection"]),
        loop_spatial_rerank=_flag(p["SequentialMatching.spatial_rerank"]), device=device,
    )
    print(f"Verified {n} image pairs")
    return 0


def cmd_vocab_tree_matcher(argv, device):
    """Retrieval matching: each image against its --VocabTreeMatching.num_images
    most similar by VLAD (default 100), optionally re-ranked by
    vote-and-verify (--VocabTreeMatching.spatial_rerank 1)."""
    p, rest = _split(argv, "VocabTreeMatching.num_images", "VocabTreeMatching.spatial_rerank")
    om, _ = _opt([a for a in rest if not a.startswith("--VocabTreeMatching")])
    from .models.feature_pipeline import run_vocab_tree_matcher

    n = run_vocab_tree_matcher(
        om.database_path, om.sift_matching, num_images=int(p["VocabTreeMatching.num_images"] or 100),
        spatial_rerank=_flag(p["VocabTreeMatching.spatial_rerank"]), device=device,
    )
    print(f"Verified {n} retrieved pairs")
    return 0


def _database_index(database_path: str, device):
    """(VLAD index of every database image, {image_id: name})."""
    from .models.database import Database
    from .ops import retrieval

    db = Database(database_path)
    descs = {i: db.read_descriptors(i).astype(np.float32) for i in db.images()}
    names = {i: v["name"] for i, v in db.images().items()}
    db.close()
    return retrieval.build_index(descs, device=device), names


def cmd_vocab_tree_builder(argv, device):
    """Build and save a retrieval vocabulary (the VLAD k-means centroids,
    `np.savez(..., centroids=...)`) from the database's descriptors
    (RunVocabTreeBuilder analog)."""
    p, _ = _split(argv, "database_path", "vocab_tree_path")
    index, _names = _database_index(p["database_path"], device)
    cent = index.centroids.cpu().numpy()
    np.savez(p["vocab_tree_path"], centroids=cent)
    print(f"Saved vocabulary ({cent.shape[0]} words) to {p['vocab_tree_path']}")
    return 0


def cmd_vocab_tree_retriever(argv, device):
    """Rank database images against each image (RunVocabTreeRetriever): one
    line per image, its --num_images (default 10) most similar."""
    p, _ = _split(argv, "database_path", "num_images", "vocab_tree_path")
    from .ops import retrieval

    index, names = _database_index(p["database_path"], device)
    k = int(p["num_images"] or 10)
    for i in index.ids:
        print(f"{names[i]}: " + ", ".join(names[j] for j in retrieval.query(index, i, k)))
    return 0


def cmd_transitive_matcher(argv, device):
    om, _ = _opt(argv)
    from .models.feature_pipeline import run_transitive_matcher

    n = run_transitive_matcher(om.database_path, om.sift_matching, device=device)
    print(f"Verified {n} transitive pairs")
    return 0


def cmd_spatial_matcher(argv, device):
    """GPS/position-prior neighbor matching. Locations come from a text file
    (--location_path: 'name lat lon alt' or 'name x y z')."""
    p, rest = _split(argv, "location_path", "SpatialMatching.is_gps")
    is_gps = _flag(p["SpatialMatching.is_gps"])
    om, _ = _opt(rest)
    from .models.database import Database
    from .models.feature_pipeline import run_spatial_matcher

    db = Database(om.database_path)
    by_name = {v["name"]: k for k, v in db.images().items()}
    db.close()
    locations = {}
    rows = []
    with open(p["location_path"]) as f:
        for line in f:
            tok = line.split()
            if len(tok) >= 4 and tok[0] in by_name:
                rows.append((by_name[tok[0]], [float(x) for x in tok[1:4]]))
    if is_gps and rows:
        from .utils.gps import lla_to_enu

        lat0, lon0, alt0 = rows[0][1]
        for iid, (lat, lon, alt) in rows:
            locations[iid] = lla_to_enu(lat, lon, alt, lat0, lon0, alt0)
    else:
        for iid, xyz in rows:
            locations[iid] = np.asarray(xyz)
    n = run_spatial_matcher(om.database_path, locations, om.sift_matching, device=device)
    print(f"Verified {n} spatial pairs")
    return 0


def cmd_matches_importer(argv, device):
    """--match_type pairs (a list of image-name pairs to match), raw
    (feature-index matches to verify) or inliers (imported as verified)."""
    p, rest = _split(argv, "match_list_path", "match_type")
    match_list, match_type = p["match_list_path"], p["match_type"] or "pairs"
    om, _ = _opt(rest)
    if match_type in ("raw", "inliers"):
        from .models.feature_pipeline import run_feature_pairs_importer

        n = run_feature_pairs_importer(
            om.database_path, match_list, om.sift_matching, verify=match_type == "raw", device=device
        )
        print(f"Imported {n} feature-pair blocks")
        return 0
    pairs = []
    with open(match_list) as f:
        for line in f:
            tok = line.split()
            if len(tok) >= 2:
                pairs.append((tok[0], tok[1]))
    from .models.feature_pipeline import run_image_pairs_matcher

    n = run_image_pairs_matcher(om.database_path, pairs, om.sift_matching, device=device)
    print(f"Verified {n} imported pairs")
    return 0


# ---------------------------------------------------------------------------
# mapping and bundle adjustment


def cmd_mapper(argv, device):
    """Incremental mapping from a database (+ lidar map + pose priors) to a
    COLMAP model: lidar-seeded init with --Mapper.lidar_pointcloud_path,
    classic two-view init without."""
    p, _ = _split(argv, "output_path")
    manager = mapper_controller(argv, device).run()
    if p["output_path"]:
        manager.write(p["output_path"])
        print(f"Wrote {manager.size()} model(s) to {p['output_path']}")
    return 0 if manager.size() > 0 else 1


def mapper_controller(argv, device):
    """The `mapper` command's controller for its command line (the
    database, lidar map, pose priors and --input_path model it names;
    --output_path is the caller's). A caller may set the controller's
    `mapper.dist_mesh` before `run()`."""
    from .models.controllers import ControllerOptions, IncrementalMapperController

    p, rest = _split(argv, "input_path", "output_path")
    om, _ = _opt(rest)
    rec, graph, lmap, priors = _load_mapper_inputs(om, p["input_path"], device)
    copts = ControllerOptions(
        min_num_matches=om.mapper.min_num_matches,
        multiple_models=om.mapper.multiple_models,
        max_num_models=om.mapper.max_num_models,
        max_model_overlap=om.mapper.max_model_overlap,
        min_model_size=om.mapper.min_model_size,
        init_num_trials=om.mapper.init_num_trials,
        snapshot_path=om.mapper.snapshot_path,
        snapshot_images_freq=om.mapper.snapshot_images_freq,
        image_pose_save_folder=om.mapper.image_pose_save_folder,
        image_path=om.image_path,
    )
    return IncrementalMapperController(
        rec, graph, _mapper_options(om), copts, lidar_map=lmap, pose_priors=priors, device=device
    )


def cmd_hierarchical_mapper(argv, device):
    """Cluster the scene, reconstruct leaves, merge (RunHierarchicalMapper;
    controllers/hierarchical_mapper.h:47)."""
    p, rest = _split(argv, "output_path", "leaf_max_num_images", "image_overlap")
    om, _ = _opt(rest)
    from .models.controllers import ControllerOptions
    from .models.hierarchical import SceneClusteringOptions, run_hierarchical_mapper

    rec, graph, lmap, priors = _load_mapper_inputs(om, None, device)
    clustering = SceneClusteringOptions(
        leaf_max_num_images=int(p["leaf_max_num_images"] or 500),
        image_overlap=int(p["image_overlap"] or 50),
    )
    merged = run_hierarchical_mapper(
        rec,
        graph,
        _mapper_options(om),
        clustering=clustering,
        lidar_map=lmap,
        pose_priors=priors,
        controller_options=ControllerOptions(
            min_num_matches=om.mapper.min_num_matches,
            min_model_size=om.mapper.min_model_size,
        ),
        device=device,
    )
    ok = merged.num_reg_images >= 2
    if p["output_path"]:
        out = os.path.join(p["output_path"], "0")
        merged.write(out)
        print(f"Wrote merged model to {out}")
    return 0 if ok else 1


def cmd_point_triangulator(argv, device):
    """Triangulate points against fixed known poses (RunPointTriangulator)."""
    p, rest = _split(argv, "input_path", "output_path")
    om, _ = _opt(rest)
    from .models.triangulator import IncrementalTriangulator, TriangulatorOptions

    rec, graph, _lmap, _priors = _load_mapper_inputs(om, p["input_path"], device)
    tri = IncrementalTriangulator(rec, graph)
    topts = TriangulatorOptions()
    n = 0
    for iid in rec.registered_ids:
        n += tri.triangulate_image(topts, iid)
    tri.complete_tracks(topts, list(rec.points3D.keys()))
    tri.merge_tracks(topts, list(rec.points3D.keys()))
    if p["output_path"]:
        rec.write(p["output_path"])
    print(f"Triangulated {n} observations, {len(rec.points3D)} points")
    return 0


def cmd_bundle_adjuster(argv, device):
    """Whole-model BA (RunBundleAdjuster); with --Mapper.lidar_pointcloud_path
    every model point gets a fresh lidar association (K2 on CUDA)."""
    p, rest = _split(argv, "input_path", "output_path")
    om, _ = _opt(rest)
    from .models.controllers import BundleAdjustmentController
    from .models.lidar_map import LidarMap
    from .models.reconstruction import Reconstruction

    rec = Reconstruction.read(p["input_path"])
    lmap = None
    if om.bundle_adjustment.if_add_lidar_constraint and om.mapper.lidar_pointcloud_path:
        lmap = LidarMap.load(om.mapper.lidar_pointcloud_path, device=device)
    mo = _mapper_options(om)
    mo.proj_lidar_constraint_weight = om.bundle_adjustment.proj_lidar_constraint_weight
    mo.icp_lidar_constraint_weight = om.bundle_adjustment.icp_lidar_constraint_weight
    mo.icp_ground_lidar_constraint_weight = om.bundle_adjustment.icp_ground_lidar_constraint_weight
    ctl = BundleAdjustmentController(
        rec, mo, lidar_map=lmap, refine_intrinsics=om.bundle_adjustment.refine_focal_length,
        device=device,
    )
    ok = ctl.run()
    if p["output_path"]:
        rec.write(p["output_path"])
    print(f"Bundle adjustment {'succeeded' if ok else 'failed'}; "
          f"mean reprojection error {rec.mean_reprojection_error():.3f}px")
    return 0 if ok else 1


def cmd_rig_bundle_adjuster(argv, device):
    """Rig-constrained bundle adjustment (RunRigBundleAdjuster,
    exe/sfm.cc): image poses are re-composed from per-snapshot rig poses
    and per-rig-camera relative poses (--rig_config_path, the reference's
    JSON), then jointly optimized with the points."""
    p, _ = _split(argv, "input_path", "output_path", "rig_config_path",
                  "RigBundleAdjustment.refine_relative_poses", "estimate_rig_poses_from_images")
    if not (p["input_path"] and p["output_path"] and p["rig_config_path"]):
        print("usage: rig_bundle_adjuster --input_path M --output_path O "
              "--rig_config_path rig.json [--RigBundleAdjustment.refine_relative_poses 0|1]")
        return 1
    from .models.camera_rig import read_rig_config
    from .models.reconstruction import Reconstruction
    from .models.rig_adjuster import RigBAOptions, RigBundleAdjuster

    rec = Reconstruction.read(p["input_path"])
    rigs = read_rig_config(p["rig_config_path"], rec)
    if _flag(p["estimate_rig_poses_from_images"]):
        for rig in rigs:
            rig.compute_relative_poses(rec)
    for i, rig in enumerate(rigs):
        print(f"rig {i}: {rig.num_cameras()} cameras, {rig.num_snapshots()} snapshots")
    refine = _flag(p["RigBundleAdjustment.refine_relative_poses"], True)
    adj = RigBundleAdjuster(RigBAOptions(refine_relative_poses=refine), device=device)
    ok = adj.solve(rec, rigs)
    if ok:
        print(f"rig BA: cost {adj.initial_cost:.4g} -> {adj.final_cost:.4g} "
              f"in {adj.iterations} iterations")
        rec.write(p["output_path"])
    else:
        print("rig BA failed")
    return 0 if ok else 1


def cmd_image_registrator(argv, device):
    """Register new database images into an existing model WITHOUT mapping
    (RunImageRegistrator, exe/image.cc:239): PnP + pose refine per image, no
    triangulation, no BA."""
    p, rest = _split(argv, "input_path", "output_path")
    om, _ = _opt(rest)
    from .models.incremental_mapper import IncrementalMapper

    rec, graph, lmap, priors = _load_mapper_inputs(om, p["input_path"], device)
    mapper = IncrementalMapper(rec, graph, lmap, priors, device)
    mapper.begin_reconstruction(rec)
    mopts = _mapper_options(om)
    n_new = 0
    for iid in sorted(rec.images.keys()):
        if rec.images[iid].registered:
            continue
        print(f"Registering image #{iid} ({rec.num_reg_images + 1})")
        if mapper.register_next_image(mopts, iid):
            n_new += 1
    mapper.end_reconstruction(discard=False)
    rec.write(p["output_path"])
    print(f"Registered {n_new} new images")
    return 0


def cmd_automatic_reconstructor(argv, device):
    """One-click pipeline (AutomaticReconstructionController parity):
    extract -> exhaustive match -> map, then with --dense 1 the dense stage
    (undistort -> stereo -> fusion -> poisson mesh)."""
    p, filtered = _split(argv, "workspace_path", "image_path", "dense")
    workspace, image_path = p["workspace_path"], p["image_path"]
    os.makedirs(workspace, exist_ok=True)
    database_path = os.path.join(workspace, "database.db")
    cmd_feature_extractor(["--database_path", database_path, "--image_path", image_path] + filtered, device)
    cmd_exhaustive_matcher(["--database_path", database_path] + filtered, device)
    os.makedirs(os.path.join(workspace, "sparse"), exist_ok=True)
    rc = cmd_mapper(
        ["--database_path", database_path, "--image_path", image_path,
         "--output_path", os.path.join(workspace, "sparse")] + filtered,
        device,
    )
    if rc != 0 or not _flag(p["dense"]):
        return rc
    sparse0 = os.path.join(workspace, "sparse", "0")
    if not os.path.isdir(sparse0):
        sparse0 = os.path.join(workspace, "sparse")
    dense_dir = os.path.join(workspace, "dense")
    rc = cmd_image_undistorter(
        ["--image_path", image_path, "--input_path", sparse0, "--output_path", dense_dir], device
    )
    if rc == 0:
        rc = cmd_patch_match_stereo(["--workspace_path", dense_dir], device)
    if rc == 0:
        rc = cmd_stereo_fusion(["--workspace_path", dense_dir], device)
    if rc == 0:
        rc = cmd_poisson_mesher(
            ["--input_path", os.path.join(dense_dir, "fused.ply"),
             "--output_path", os.path.join(dense_dir, "meshed-poisson.ply")],
            device,
        )
    return rc


# ---------------------------------------------------------------------------
# model tools


def cmd_model_converter(argv, device):
    """BIN/TXT/PLY/NVM/BUNDLER/CAM/VRML export, NVM import (RunModelConverter,
    exe/model.cc:560-612 output_type dispatch). An `--input_path *.nvm` file
    imports VisualSFM models."""
    p, _ = _split(argv, "input_path", "output_path", "output_type", "skip_distortion")
    input_path, output_path = p["input_path"], p["output_path"]
    output_type = (p["output_type"] or "BIN").upper()
    skip_distortion = p["skip_distortion"] not in (None, "0", "false", "False")
    from .io import model_formats, ply as ply_io
    from .models.reconstruction import Reconstruction

    if input_path.lower().endswith(".nvm"):
        rec = model_formats.import_nvm(input_path)
    else:
        rec = Reconstruction.read(input_path)
    if output_type in ("BIN", "TXT"):
        rec.write(output_path, binary=output_type == "BIN")
    elif output_type == "PLY":
        pts = np.stack([p.xyz for p in rec.points3D.values()]) if rec.points3D else np.zeros((0, 3))
        cols = np.stack([p.color for p in rec.points3D.values()]) if rec.points3D else np.zeros((0, 3), np.uint8)
        ply_io.write_ply(output_path, pts, colors=cols)
    elif output_type == "NVM":
        if not model_formats.export_nvm(rec, output_path, skip_distortion):
            return 1
    elif output_type == "BUNDLER":
        if not model_formats.export_bundler(
            rec, output_path + ".bundle.out", output_path + ".list.txt", skip_distortion
        ):
            return 1
    elif output_type == "CAM":
        if not model_formats.export_cam(rec, output_path, skip_distortion):
            return 1
    elif output_type == "VRML":
        base = output_path.rsplit(".", 1)[0]
        model_formats.export_vrml(rec, base + ".images.wrl", base + ".points3D.wrl")
    else:
        print(f"unsupported output_type {output_type}")
        return 1
    print(f"Converted model to {output_type}")
    return 0


def cmd_model_analyzer(argv, device):
    p, _ = _split(argv, "path", "input_path")
    from .models.reconstruction import Reconstruction

    rec = Reconstruction.read(p["path"] or p["input_path"])
    rec.update_point_errors()
    obs = sum(len(pt.track) for pt in rec.points3D.values())
    stats = {
        "cameras": len(rec.cameras),
        "images": len(rec.images),
        "registered_images": rec.num_reg_images,
        "points3D": len(rec.points3D),
        "observations": obs,
        "mean_track_length": round(rec.mean_track_length(), 4),
        "mean_observations_per_image": round(obs / max(rec.num_reg_images, 1), 2),
        "mean_reprojection_error_px": round(rec.mean_reprojection_error(), 4),
    }
    for k, v in stats.items():
        print(f"{k}: {v}")
    return 0


def cmd_model_transformer(argv, device):
    """Apply a similarity transform from a 3x4 text file (RunModelTransformer)."""
    p, _ = _split(argv, "input_path", "output_path", "transform_path")
    import torch

    from .models.reconstruction import Reconstruction
    from .ops import se3

    rec = Reconstruction.read(p["input_path"])
    M = np.loadtxt(p["transform_path"]).reshape(3, 4)
    s = float(np.cbrt(np.linalg.det(M[:, :3])))
    q = se3.rotmat_to_quat(torch.as_tensor(M[:, :3] / s, dtype=torch.float32, device=device))
    rec.transform(q.cpu().numpy(), M[:, 3], scale=s)
    rec.write(p["output_path"])
    print("Transformed model")
    return 0


def cmd_model_aligner(argv, device):
    """Align a model to reference positions ('name x y z' rows).

    Robust path (default, reference exe/model.cc RunModelAligner with
    robust_alignment=true -> Reconstruction::AlignRobust): RANSAC over
    minimal-3 Umeyama similarity hypotheses gated by
    --robust_alignment_max_error, LO-refit on inliers, then an L1 polish of
    the 3x4 transform by least absolute deviations (ops/lad.py) projected
    back to sim3, accepted only if it lowers the mean inlier error.
    --robust_alignment 0 falls back to plain Umeyama (reference Align)."""
    p, _ = _split(argv, "input_path", "output_path", "ref_images_path", "robust_alignment",
               "robust_alignment_max_error", "min_common_images")
    robust = p["robust_alignment"] not in ("0", "false", "False")
    max_error = float(p["robust_alignment_max_error"] or 0.0)
    min_common = int(p["min_common_images"] or 3)
    if robust and max_error <= 0:
        print("ERROR: You must provide a maximum alignment error > 0")
        return 1
    import torch

    from .models.reconstruction import Reconstruction
    from .ops import lad, np_geom, ransac, solvers

    rec = Reconstruction.read(p["input_path"])
    refs = {}
    with open(p["ref_images_path"]) as f:
        for line in f:
            tok = line.split()
            if len(tok) >= 4:
                refs[tok[0]] = np.asarray([float(x) for x in tok[1:4]])
    src, dst = [], []
    for img in rec.images.values():
        if img.registered and img.name in refs:
            src.append(img.projection_center())
            dst.append(refs[img.name])
    if len(src) < max(3, min_common):
        print("Not enough reference images")
        return 1
    srcn = np.stack(src).astype(np.float32)
    dstn = np.stack(dst).astype(np.float32)
    src_d = torch.as_tensor(srcn, device=device)
    dst_d = torch.as_tensor(dstn, device=device)
    n_used = srcn.shape[0]
    if robust:
        res = ransac.ransac_similarity(
            src_d, dst_d, torch.ones(n_used, device=device),
            torch.Generator(device=device).manual_seed(0),
            ransac.RansacOptions(max_error=max_error, num_hypotheses=1024),
        )
        q, t, s, inl, n_in = (x.cpu().numpy() for x in (res.q, res.t, res.s, res.inlier_mask, res.num_inliers))
        if int(n_in) < max(3, min_common):
            print("Robust alignment failed: too few inliers")
            return 1
        # L1 polish on the inlier set: min_M sum ||M [x;1] - y||_1 over the
        # free 3x4 M, then project back to a similarity
        Xh = np.concatenate([srcn[inl], np.ones((inl.sum(), 1), np.float32)], axis=1)
        A = np.kron(np.eye(3, dtype=np.float32), Xh)  # [3m, 12]
        b = dstn[inl].T.reshape(-1)  # y-coords grouped per output row
        R = np_geom.quat_to_rotmat(q).astype(np.float32)
        x0 = np.concatenate([float(s) * R, t[:, None]], 1).reshape(-1)
        x = lad.solve_least_absolute_deviations(
            *(torch.as_tensor(a, device=device) for a in (A, b, x0))
        ).cpu().numpy()
        M = x.reshape(3, 4)
        s2 = float(np.cbrt(max(np.linalg.det(M[:, :3]), 1e-12)))
        U, _, Vt = np.linalg.svd(M[:, :3] / s2)
        R2 = U @ Vt
        err_ransac = np.abs(float(s) * srcn[inl] @ R.T + t - dstn[inl]).sum(1).mean()
        err_lad = np.abs(s2 * srcn[inl] @ R2.T + M[:, 3] - dstn[inl]).sum(1).mean()
        if err_lad < err_ransac:
            q, t, s = np_geom.rotmat_to_quat(R2), M[:, 3], s2
        n_ref = int(n_in)
    else:
        q, t, s = (x.cpu().numpy() for x in solvers.umeyama(src_d, dst_d, with_scale=True))
        n_ref = n_used
    rec.transform(np.asarray(q), np.asarray(t), float(s))
    errs = []
    for img in rec.images.values():
        if img.registered and img.name in refs:
            errs.append(float(np.linalg.norm(img.projection_center() - refs[img.name])))
    print(
        f"Aligned model (scale {float(s):.4f}, {n_ref}/{n_used} refs; "
        f"error mean {np.mean(errs):.4f} median {np.median(errs):.4f})"
    )
    rec.write(p["output_path"])
    return 0


def cmd_model_merger(argv, device):
    p, _ = _split(argv, "input_path1", "input_path2", "output_path")
    from .models.model_tools import merge_models
    from .models.reconstruction import Reconstruction

    out = merge_models(Reconstruction.read(p["input_path1"]), Reconstruction.read(p["input_path2"]), device)
    if out is None:
        print("Merge failed: not enough common registered images")
        return 1
    out.write(p["output_path"])
    print(f"Merged: {out.num_reg_images} images, {len(out.points3D)} points")
    return 0


def cmd_model_cropper(argv, device):
    p, _ = _split(argv, "input_path", "output_path", "boundary")
    from .models.model_tools import crop_model
    from .models.reconstruction import Reconstruction

    vals = [float(x) for x in p["boundary"].split(",")]
    rec = crop_model(Reconstruction.read(p["input_path"]), vals[:3], vals[3:6])
    rec.write(p["output_path"])
    print(f"Cropped: {rec.num_reg_images} images, {len(rec.points3D)} points")
    return 0


def cmd_model_splitter(argv, device):
    p, _ = _split(argv, "input_path", "output_path", "num_parts", "axis", "overlap")
    from .models.model_tools import split_model
    from .models.reconstruction import Reconstruction

    parts = split_model(
        Reconstruction.read(p["input_path"]),
        int(p["num_parts"] or 2),
        int(p["axis"] or 0),
        float(p["overlap"] or 0.0),
    )
    for k, r in enumerate(parts):
        r.write(os.path.join(p["output_path"], str(k)))
    print(f"Split into {len(parts)} parts")
    return 0


def cmd_model_orientation_aligner(argv, device):
    """RunModelOrientationAligner (exe/model.cc:735-796): align the model's
    vertical/horizontal axes by MANHATTAN-WORLD (per-image vanishing points)
    or IMAGE-ORIENTATION (gravity consensus); PRINCIPAL (PCA axes) kept as
    a third, image-free method."""
    p, _ = _split(argv, "input_path", "output_path", "image_path", "method", "max_image_size")
    from .models import coordinate_frame as cf
    from .models.reconstruction import Reconstruction
    from .ops import np_geom

    method = (p["method"] or "manhattan-world").lower()
    rec = Reconstruction.read(p["input_path"])
    if method == "manhattan-world":
        if not p["image_path"]:
            print("ERROR: MANHATTAN-WORLD alignment needs --image_path")
            return 1
        opts = cf.ManhattanWorldFrameEstimationOptions(max_image_size=int(p["max_image_size"] or 1024))
        frame = cf.estimate_manhattan_world_frame(opts, rec, p["image_path"], device)
        R = cf.orientation_aligner_rotation(frame)
        rec.transform(np_geom.rotmat_to_quat(R), np.zeros(3), 1.0)
    elif method == "image-orientation":
        g = cf.estimate_gravity_vector_from_image_orientation(rec)
        R = cf.rotation_from_unit_vectors(g, np.asarray([0.0, 1.0, 0.0]))
        rec.transform(np_geom.rotmat_to_quat(R), np.zeros(3), 1.0)
    elif method == "principal":
        from .models.model_tools import align_to_principal_axes

        rec = align_to_principal_axes(rec)
    else:
        print("ERROR: Invalid `method` - 'MANHATTAN-WORLD', 'IMAGE-ORIENTATION' or 'PRINCIPAL'")
        return 1
    rec.write(p["output_path"])
    print(f"Aligned model orientation ({method})")
    return 0


def cmd_model_comparer(argv, device):
    p, _ = _split(argv, "input_path1", "input_path2")
    from .models.model_tools import compare_models
    from .models.reconstruction import Reconstruction

    stats = compare_models(
        Reconstruction.read(p["input_path1"]), Reconstruction.read(p["input_path2"]), device
    )
    for k, v in stats.items():
        print(f"{k}: {v}")
    return 0


def cmd_model_viewer(argv, device):
    """Export a reconstruction as a self-contained HTML WebGL viewer (the
    headless replacement for the reference's Qt ModelViewerWidget): SfM
    points, camera frusta, lidar map, association lines."""
    p, _ = _split(argv, "input_path", "output_path", "lidar_path", "max_lidar_points", "frustum_scale")
    from .io import viewer as viewer_io
    from .models.reconstruction import Reconstruction

    rec = Reconstruction.read(p["input_path"])
    lidar_pts = None
    if p["lidar_path"]:
        from .io import ply as ply_io

        lidar_pts = ply_io.read_ply(p["lidar_path"]).xyz
    out = viewer_io.export_viewer_html(
        rec,
        p["output_path"],
        lidar_pts=lidar_pts,
        max_lidar_points=int(p["max_lidar_points"] or 300000),
        frustum_scale=float(p["frustum_scale"] or 0.4),
    )
    print(f"viewer written to {out} ({rec.num_reg_images} images, "
          f"{len(rec.points3D)} points) — open in any browser")
    return 0


def cmd_color_extractor(argv, device):
    """Mean-track point colors from source images (RunColorExtractor,
    exe/sfm.cc:168; reconstruction.cc ExtractColorsForAllImages)."""
    p, _ = _split(argv, "image_path", "input_path", "output_path")
    from .models.reconstruction import Reconstruction

    rec = Reconstruction.read(p["input_path"])
    rec.extract_colors_for_all_images(p["image_path"])
    rec.write(p["output_path"])
    n_colored = sum(1 for pt in rec.points3D.values() if pt.color.any())
    print(f"Extracted colors for {n_colored}/{len(rec.points3D)} points")
    return 0


def cmd_point_filtering(argv, device):
    """Filter 3D points by reproj error / tri angle / track length
    (RunPointFiltering, exe/sfm.cc:303)."""
    p, _ = _split(argv, "input_path", "output_path", "min_track_len", "max_reproj_error", "min_tri_angle")
    from .models.reconstruction import Reconstruction

    rec = Reconstruction.read(p["input_path"])
    min_track_len = int(p["min_track_len"] or 2)
    n = rec.filter_points3D(
        max_reproj_error=float(p["max_reproj_error"] or 4.0),
        min_tri_angle_deg=float(p["min_tri_angle"] or 1.5),
    )
    for pid in list(rec.points3D.keys()):
        if len(rec.points3D[pid].track) < min_track_len:
            n += len(rec.points3D[pid].track)
            rec.delete_point3D(pid)
    print(f"Filtered observations: {n}")
    rec.write(p["output_path"])
    return 0


# ---------------------------------------------------------------------------
# images


def cmd_image_deleter(argv, device):
    """Deregister images by id/name list (RunImageDeleter, exe/image.cc:77)."""
    p, _ = _split(argv, "input_path", "output_path", "image_ids_path", "image_names_path")
    from .models.reconstruction import Reconstruction

    rec = Reconstruction.read(p["input_path"])
    if p["image_ids_path"]:
        with open(p["image_ids_path"]) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                iid = int(line)
                if iid in rec.images and rec.images[iid].registered:
                    print(f"Deleting image_id={iid}, image_name={rec.images[iid].name}")
                    rec.deregister_image(iid)
                else:
                    print(f"WARNING: Skipping image_id={iid} (not in reconstruction)")
    if p["image_names_path"]:
        by_name = {img.name: iid for iid, img in rec.images.items()}
        with open(p["image_names_path"]) as f:
            for line in f:
                name = line.strip()
                if not name:
                    continue
                iid = by_name.get(name)
                if iid is not None and rec.images[iid].registered:
                    print(f"Deleting image_id={iid}, image_name={name}")
                    rec.deregister_image(iid)
                else:
                    print(f"WARNING: Skipping image_name={name} (not in reconstruction)")
    rec.write(p["output_path"])
    return 0


def cmd_image_filterer(argv, device):
    """Deregister images with bogus intrinsics or too few observations
    (RunImageFilterer, exe/image.cc:155)."""
    p, _ = _split(argv, "input_path", "output_path", "min_focal_length_ratio",
               "max_focal_length_ratio", "max_extra_param", "min_num_observations")
    from .models.reconstruction import Reconstruction

    rec = Reconstruction.read(p["input_path"])
    min_fr = float(p["min_focal_length_ratio"] or 0.1)
    max_fr = float(p["max_focal_length_ratio"] or 10.0)
    max_ep = float(p["max_extra_param"] or 100.0)
    min_obs = int(p["min_num_observations"] or 10)
    n0 = rec.num_reg_images
    to_drop = []
    for iid in list(rec.registered_ids):
        img = rec.images[iid]
        cam = rec.cameras[img.camera_id]
        if cam.has_bogus_params(min_fr, max_fr, max_ep) or img.num_points3D() < min_obs:
            to_drop.append(iid)
    for iid in to_drop:
        rec.deregister_image(iid)
    print(f"Filtered {n0 - rec.num_reg_images} images from a total of {n0} images")
    rec.write(p["output_path"])
    return 0


def _save_image(path: str, img: np.ndarray):
    from PIL import Image as PILImage

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    PILImage.fromarray(img).save(path)


def cmd_image_undistorter(argv, device):
    p, _ = _split(argv, "image_path", "input_path", "output_path")
    from .models.undistortion import run_image_undistorter

    n = run_image_undistorter(p["image_path"], p["input_path"], p["output_path"], device=device)
    print(f"Undistorted {n} images")
    return 0


def cmd_image_undistorter_standalone(argv, device):
    """Undistort images listed as 'name MODEL params...' rows without any
    reconstruction (RunImageUndistorterStandalone, exe/image.cc:407)."""
    p, _ = _split(argv, "image_path", "input_file", "output_path")
    from .models.reconstruction import Camera
    from .models.undistortion import undistort_image, undistorted_camera
    from .ops import camera_models as cm
    from .utils import image as image_utils

    os.makedirs(p["output_path"], exist_ok=True)
    n = 0
    with open(p["input_file"]) as f:
        for line in f:
            tok = line.split()
            if len(tok) < 2:
                continue
            name, model_name = tok[0], tok[1]
            params = np.asarray([float(x) for x in tok[2:]])
            img = image_utils.imread_rgb(os.path.join(p["image_path"], name))
            cam = Camera(1, cm.MODEL_IDS[model_name], img.shape[1], img.shape[0], params)
            out = undistort_image(img, cam, undistorted_camera(cam), device)
            _save_image(os.path.join(p["output_path"], name), out)
            n += 1
    print(f"Undistorted {n} images")
    return 0


def cmd_image_rectifier(argv, device):
    """Stereo-rectify image pairs against a model (RunImageRectifier,
    exe/image.cc:204; base/undistortion.cc RectifyStereoCameras) and write
    `<name1>-<name2>` rectified pairs."""
    p, _ = _split(argv, "image_path", "input_path", "output_path", "stereo_pairs_list")
    from .models.reconstruction import Reconstruction
    from .models.undistortion import rectify_stereo_pair
    from .utils import image as image_utils

    rec = Reconstruction.read(p["input_path"])
    by_name = {img.name: iid for iid, img in rec.images.items()}
    os.makedirs(p["output_path"], exist_ok=True)
    n = 0
    with open(p["stereo_pairs_list"]) as f:
        for line in f:
            names = line.split()
            if len(names) != 2:
                continue
            img1 = image_utils.imread_rgb(os.path.join(p["image_path"], names[0]))
            img2 = image_utils.imread_rgb(os.path.join(p["image_path"], names[1]))
            r1, r2 = rectify_stereo_pair(rec, by_name[names[0]], by_name[names[1]], img1, img2, device)
            stem = f"{os.path.splitext(names[0])[0]}-{os.path.splitext(names[1])[0]}"
            _save_image(os.path.join(p["output_path"], stem + "_1.png"), r1)
            _save_image(os.path.join(p["output_path"], stem + "_2.png"), r2)
            n += 1
    print(f"Rectified {n} stereo pairs")
    return 0


# ---------------------------------------------------------------------------
# database and project


def cmd_patch_match_stereo(argv, device):
    """Dense stereo over an undistorted workspace (RunPatchMatchStereo,
    plane-sweep formulation: ops/stereo.py)."""
    p, _ = _split(argv, "workspace_path")
    from .models.mvs import DenseOptions, run_patch_match_stereo

    n = run_patch_match_stereo(p["workspace_path"], DenseOptions(), device=device)
    print(f"Computed depth/normal maps for {n} views")
    return 0


def cmd_stereo_fusion(argv, device):
    p, _ = _split(argv, "workspace_path", "output_path")
    from .models.mvs import DenseOptions, run_stereo_fusion

    pts, _, _ = run_stereo_fusion(p["workspace_path"], p["output_path"], DenseOptions(), device=device)
    print(f"Fused {len(pts)} points")
    return 0


def cmd_poisson_mesher(argv, device):
    """Fused oriented point cloud -> surface mesh (RunPoissonMesher,
    src/exe/colmap.cc; mvs/meshing.h:106-125): spectral Poisson solve on the
    device + marching tetrahedra (ops/meshing.py)."""
    p, _ = _split(argv, "input_path", "output_path", "PoissonMeshing.depth", "PoissonMeshing.trim",
                  "PoissonMeshing.point_weight")
    input_path, output_path = p["input_path"], p["output_path"]
    if not input_path or not output_path:
        print("usage: poisson_mesher --input_path fused.ply --output_path meshed.ply")
        return 1
    from .io import ply as ply_io
    from .ops.meshing import PoissonOptions, poisson_mesh

    opts = PoissonOptions(
        depth=int(p["PoissonMeshing.depth"] or 7),
        trim=float(p["PoissonMeshing.trim"] or 7.0),
        point_weight=float(p["PoissonMeshing.point_weight"] or 1.0),
    )
    data = ply_io.read_ply(input_path)
    if data.normals is None:
        print(f"{input_path} has no normals; run stereo_fusion first")
        return 1
    verts, faces = poisson_mesh(data.xyz, data.normals, opts, device=device)
    ply_io.write_ply_mesh(output_path, verts, faces)
    print(f"Meshed {len(data.xyz)} points -> {len(verts)} vertices, {len(faces)} faces: {output_path}")
    return 0


def cmd_delaunay_mesher(argv, device):
    """Sparse/dense Delaunay meshing with visibility graph cut
    (RunDelaunayMesher; mvs/meshing.h:110-127, Labatut et al. 2009), host
    code. --input_path: a sparse model dir (sparse mode) or a dense workspace
    containing fused.ply + sparse/ (dense mode, the reference's default)."""
    p, _ = _split(argv, "input_path", "output_path", "input_type",
                  "DelaunayMeshing.quality_regularization", "DelaunayMeshing.visibility_sigma")
    input_path, output_path, input_type = p["input_path"], p["output_path"], p["input_type"] or "dense"
    if not input_path or not output_path:
        print("usage: delaunay_mesher --input_path <sparse_model|dense_workspace>"
              " --output_path meshed.ply [--input_type sparse|dense]")
        return 1
    from .io import ply as ply_io
    from .models.reconstruction import Reconstruction
    from .ops.delaunay import DelaunayMeshingOptions, dense_delaunay_mesh, sparse_delaunay_mesh

    opts = DelaunayMeshingOptions(
        quality_regularization=float(p["DelaunayMeshing.quality_regularization"] or 1.0),
        visibility_sigma=float(p["DelaunayMeshing.visibility_sigma"] or 3.0),
    )
    if input_type == "sparse":
        verts, faces = sparse_delaunay_mesh(Reconstruction.read(input_path), opts)
    else:
        fused = os.path.join(input_path, "fused.ply")
        if not os.path.exists(fused):
            print(f"{fused} not found; run stereo_fusion first")
            return 1
        rec = Reconstruction.read(os.path.join(input_path, "sparse"))
        verts, faces = dense_delaunay_mesh(ply_io.read_ply(fused).xyz, rec, opts)
    ply_io.write_ply_mesh(output_path, verts, faces)
    print(f"Delaunay meshed -> {len(verts)} vertices, {len(faces)} faces: {output_path}")
    return 0


def cmd_database_creator(argv, device):
    om, _ = _opt(argv)
    from .models.database import Database

    Database(om.database_path).close()
    print(f"Created database {om.database_path}")
    return 0


def cmd_database_cleaner(argv, device):
    p, _ = _split(argv, "database_path", "type")
    from .models.database import Database

    db = Database(p["database_path"])
    t = (p["type"] or "all").lower()
    if t in ("all", "matches"):
        db.conn.execute("DELETE FROM matches")
        db.conn.execute("DELETE FROM two_view_geometries")
    if t in ("all", "features"):
        db.conn.execute("DELETE FROM keypoints")
        db.conn.execute("DELETE FROM descriptors")
    if t == "all":
        db.conn.execute("DELETE FROM images")
        db.conn.execute("DELETE FROM cameras")
    db.commit()
    db.close()
    print(f"Cleaned {t}")
    return 0


def cmd_database_merger(argv, device):
    p, _ = _split(argv, "database_path1", "database_path2", "merged_database_path")
    from .models.database import Database

    out = Database(p["merged_database_path"])
    for src_path in (p["database_path1"], p["database_path2"]):
        src = Database(src_path)
        cam_map = {}
        for cid, c in src.cameras().items():
            cam_map[cid] = out.add_camera(
                c["model_id"], c["width"], c["height"], c["params"], c["prior_focal"]
            )
        img_map = {}
        for iid, im in src.images().items():
            img_map[iid] = out.add_image(im["name"], cam_map[im["camera_id"]])
            out.write_keypoints(img_map[iid], src.read_keypoints(iid))
            out.write_descriptors(img_map[iid], src.read_descriptors(iid))
        for i, j in src.all_two_view_pair_ids():
            g = src.read_two_view_geometry(i, j)
            out.write_matches(img_map[i], img_map[j], src.read_matches(i, j))
            out.write_two_view_geometry(
                img_map[i], img_map[j], g["inlier_matches"], g["config"],
                F=g["F"], E=g["E"], H=g["H"],
            )
        src.close()
    out.commit()
    out.close()
    print("Merged databases")
    return 0


def cmd_project_generator(argv, device):
    """Write a full project.ini at a quality preset (RunProjectGenerator,
    exe/gui.cc:77)."""
    p, _ = _split(argv, "output_path", "quality")
    om = OptionManager()
    try:
        om.modify_for_quality(p["quality"] or "high")
    except ValueError as e:
        print(f"ERROR: {e}")
        return 1
    om.write_ini(p["output_path"])
    print(f"Wrote project file to {p['output_path']}")
    return 0


def cmd_gui(argv, device):
    print(
        "The PyTorch package has no Qt GUI. Use "
        "`model_viewer --input_path <sparse> --output_path viewer.html` for a "
        "standalone browser viewer (points, frusta, lidar associations), or "
        "`model_converter --output_type PLY/TXT` for COLMAP-compatible viewers; "
        "poses export via Mapper.image_pose_save_folder (pose.ply)."
    )
    return 0


COMMANDS = {
    "feature_extractor": cmd_feature_extractor,
    "feature_importer": cmd_feature_importer,
    "exhaustive_matcher": cmd_exhaustive_matcher,
    "sequential_matcher": cmd_sequential_matcher,
    "transitive_matcher": cmd_transitive_matcher,
    "vocab_tree_matcher": cmd_vocab_tree_matcher,
    "vocab_tree_builder": cmd_vocab_tree_builder,
    "vocab_tree_retriever": cmd_vocab_tree_retriever,
    "spatial_matcher": cmd_spatial_matcher,
    "matches_importer": cmd_matches_importer,
    "mapper": cmd_mapper,
    "hierarchical_mapper": cmd_hierarchical_mapper,
    "point_triangulator": cmd_point_triangulator,
    "bundle_adjuster": cmd_bundle_adjuster,
    "rig_bundle_adjuster": cmd_rig_bundle_adjuster,
    "image_registrator": cmd_image_registrator,
    "automatic_reconstructor": cmd_automatic_reconstructor,
    "model_converter": cmd_model_converter,
    "model_analyzer": cmd_model_analyzer,
    "model_transformer": cmd_model_transformer,
    "model_aligner": cmd_model_aligner,
    "model_merger": cmd_model_merger,
    "model_cropper": cmd_model_cropper,
    "model_splitter": cmd_model_splitter,
    "model_orientation_aligner": cmd_model_orientation_aligner,
    "model_comparer": cmd_model_comparer,
    "model_viewer": cmd_model_viewer,
    "color_extractor": cmd_color_extractor,
    "point_filtering": cmd_point_filtering,
    "image_deleter": cmd_image_deleter,
    "image_filterer": cmd_image_filterer,
    "image_undistorter": cmd_image_undistorter,
    "image_undistorter_standalone": cmd_image_undistorter_standalone,
    "image_rectifier": cmd_image_rectifier,
    "patch_match_stereo": cmd_patch_match_stereo,
    "stereo_fusion": cmd_stereo_fusion,
    "poisson_mesher": cmd_poisson_mesher,
    "delaunay_mesher": cmd_delaunay_mesher,
    "database_creator": cmd_database_creator,
    "database_cleaner": cmd_database_cleaner,
    "database_merger": cmd_database_merger,
    "project_generator": cmd_project_generator,
    "gui": cmd_gui,
}


def _take_device(argv):
    """(the --device value, "cuda" by default; argv without the flag)."""
    p, rest = _split(argv, "device")
    name = p["device"] or "cuda"
    if name not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, not {name}")
    return name, rest


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help", "help"):
        print("usage: python -m colmap_pcd_tpu_torch <command> [--flags] [--device cuda|cpu]")
        print("commands:", ", ".join(sorted(COMMANDS)))
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd}; available:", ", ".join(sorted(COMMANDS)))
        return 1
    from . import device as device_mod

    name, rest = _take_device(argv[1:])
    return COMMANDS[cmd](rest, device_mod.resolve(name))


if __name__ == "__main__":
    sys.exit(main())
