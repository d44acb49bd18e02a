"""Command-line interface: `python -m colmap_pcd_tpu_torch <command> [--flags]`.

Port of colmap_pcd_tpu/cli.py. Flags use the reference's namespaced names
(--Mapper.init_image_x, --SiftMatching.max_ratio, ..., utils/config.py).
Ported: `feature_extractor`, `feature_importer`, the matchers
`exhaustive_matcher`, `sequential_matcher`, `transitive_matcher` and
`matches_importer`, and `mapper` (lidar-seeded or classic two-view init).
Every other command of the JAX package's registry reports that it is not
yet ported and returns 1. Extraction, matching and mapping run on CUDA when
present, else on the CPU.
"""

from __future__ import annotations

import sys

import numpy as np

from .utils.config import OptionManager

# the rest of the JAX package's command registry
_NOT_PORTED = (
    "vocab_tree_matcher", "spatial_matcher",
    "vocab_tree_builder", "vocab_tree_retriever",
    "hierarchical_mapper", "point_triangulator", "bundle_adjuster",
    "rig_bundle_adjuster", "model_converter", "model_analyzer",
    "model_transformer", "model_aligner", "model_merger", "model_cropper",
    "model_splitter", "model_orientation_aligner", "model_comparer",
    "database_cleaner", "database_merger", "image_undistorter",
    "patch_match_stereo", "stereo_fusion", "poisson_mesher", "delaunay_mesher",
    "database_creator", "automatic_reconstructor", "model_viewer",
    "color_extractor", "image_deleter", "image_filterer",
    "image_rectifier", "image_registrator", "image_undistorter_standalone",
    "point_filtering", "project_generator", "gui",
)


def _opt(argv):
    om = OptionManager()
    rest = om.parse_args(argv)
    return om, rest


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


def cmd_mapper(argv):
    """Incremental mapping from a database (+ lidar map + pose priors) to a
    COLMAP model: lidar-seeded init with --Mapper.lidar_pointcloud_path,
    classic two-view init without. The device is CUDA when present, else
    the CPU."""
    input_path, output_path = None, None
    filtered = []
    it = iter(argv)
    for a in it:
        if a == "--input_path":
            input_path = next(it)
        elif a == "--output_path":
            output_path = next(it)
        else:
            filtered.append(a)
    om, _ = _opt(filtered)
    from . import device as device_mod
    from .models.controllers import ControllerOptions, IncrementalMapperController

    dev = device_mod.resolve()
    rec, graph, lmap, priors = _load_mapper_inputs(om, input_path, dev)
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
    ctl = IncrementalMapperController(
        rec, graph, _mapper_options(om), copts, lidar_map=lmap, pose_priors=priors
    )
    manager = ctl.run()
    if output_path:
        manager.write(output_path)
        print(f"Wrote {manager.size()} model(s) to {output_path}")
    return 0 if manager.size() > 0 else 1


def _reader_config(om):
    from .models.feature_pipeline import ImageReaderConfig

    return ImageReaderConfig(
        camera_model=om.image_reader.camera_model,
        single_camera=om.image_reader.single_camera,
        camera_params=om.image_reader.camera_params,
        default_focal_factor=om.image_reader.default_focal_length_factor,
    )


def cmd_feature_extractor(argv):
    om, _ = _opt(argv)
    from .models.feature_pipeline import run_feature_extractor

    n = run_feature_extractor(om.database_path, om.image_path, om.sift_extraction, _reader_config(om))
    print(f"Extracted features for {n} images")
    return 0


def cmd_feature_importer(argv):
    """Import COLMAP text feature files (RunFeatureImporter, exe/feature.cc:177)."""
    import_path = None
    filtered = []
    it = iter(argv)
    for a in it:
        if a == "--import_path":
            import_path = next(it)
        elif a == "--image_list_path":
            next(it)  # parsed and unused, as in the JAX package's CLI
        else:
            filtered.append(a)
    om, _ = _opt(filtered)
    from .models.feature_pipeline import run_feature_importer

    n = run_feature_importer(om.database_path, om.image_path, import_path, _reader_config(om))
    print(f"Imported features for {n} images")
    return 0


def cmd_exhaustive_matcher(argv):
    om, _ = _opt(argv)
    from .models.feature_pipeline import run_exhaustive_matcher

    n = run_exhaustive_matcher(om.database_path, om.sift_matching)
    print(f"Verified {n} image pairs")
    return 0


def cmd_sequential_matcher(argv):
    """Sequential matching with the JAX CLI's quadratic overlap (pairs d
    and 2^d apart for d <= overlap)."""
    om, _ = _opt([a for a in argv if not a.startswith("--Sequential")])
    overlap = 10
    loop = False
    it = iter(argv)
    for a in it:
        if a == "--SequentialMatching.overlap":
            overlap = int(next(it))
        elif a == "--SequentialMatching.loop_detection":
            loop = next(it).lower() in ("1", "true")
    from .models.feature_pipeline import run_sequential_matcher

    n = run_sequential_matcher(om.database_path, om.sift_matching, overlap=overlap,
                               loop_detection=loop)
    print(f"Verified {n} image pairs")
    return 0


def cmd_transitive_matcher(argv):
    om, _ = _opt(argv)
    from .models.feature_pipeline import run_transitive_matcher

    n = run_transitive_matcher(om.database_path, om.sift_matching)
    print(f"Verified {n} transitive pairs")
    return 0


def cmd_matches_importer(argv):
    """--match_type pairs (a list of image-name pairs to match), raw
    (feature-index matches to verify) or inliers (imported as verified)."""
    match_list = None
    match_type = "pairs"
    it = iter(argv)
    filtered = []
    for a in it:
        if a == "--match_list_path":
            match_list = next(it)
        elif a == "--match_type":
            match_type = next(it)
        else:
            filtered.append(a)
    om, _ = _opt(filtered)
    if match_type in ("raw", "inliers"):
        from .models.feature_pipeline import run_feature_pairs_importer

        n = run_feature_pairs_importer(
            om.database_path, match_list, om.sift_matching, verify=match_type == "raw"
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

    n = run_image_pairs_matcher(om.database_path, pairs, om.sift_matching)
    print(f"Verified {n} imported pairs")
    return 0


COMMANDS = {
    "feature_extractor": cmd_feature_extractor,
    "feature_importer": cmd_feature_importer,
    "mapper": cmd_mapper,
    "exhaustive_matcher": cmd_exhaustive_matcher,
    "sequential_matcher": cmd_sequential_matcher,
    "transitive_matcher": cmd_transitive_matcher,
    "matches_importer": cmd_matches_importer,
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help", "help"):
        print("usage: python -m colmap_pcd_tpu_torch <command> [--flags]")
        print("commands:", ", ".join(sorted(COMMANDS)))
        return 0
    cmd = argv[0]
    if cmd in _NOT_PORTED:
        print(f"{cmd}: not yet ported to the PyTorch package; use `python -m colmap_pcd_tpu {cmd}`")
        return 1
    if cmd not in COMMANDS:
        print(f"unknown command {cmd}; available:", ", ".join(sorted(COMMANDS)))
        return 1
    return COMMANDS[cmd](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
