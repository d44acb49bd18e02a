"""Options registry: namespaced flags, CLI parsing, project.ini round-trip.

Parity with src/util/option_manager.{h,cc} (1,306 LoC of boost
program_options): every pipeline option is a namespaced flag
(`Mapper.init_image_x`, `BundleAdjustment.if_add_lidar_constraint`,
`SiftExtraction.max_num_features`, ...) that can come from the command line
(--Namespace.field value) or a project.ini file, with dataclass defaults as
the source of truth. The reference's lidar flags (option_manager.cc:463-539)
keep their names so existing project.ini files carry over.
"""

from __future__ import annotations

import configparser
from dataclasses import dataclass, field, fields
from typing import Any


@dataclass
class ImageReaderConfig_:
    """ImageReader.* namespace (base/image_reader.h options)."""

    camera_model: str = "OPENCV"
    single_camera: bool = True
    camera_params: str = ""  # comma-separated known intrinsics
    default_focal_length_factor: float = 1.2


@dataclass
class SiftExtractionConfig:
    max_image_size: int = 3200
    max_num_features: int = 8192
    first_octave: int = -1
    num_octaves: int = 4
    octave_resolution: int = 3
    peak_threshold: float = 0.02 / 3.0
    edge_threshold: float = 10.0
    upright: bool = False
    estimate_affine_shape: bool = False  # sift.h:98-100 covariant frames
    domain_size_pooling: bool = False  # DSP-SIFT (sift.h:102)
    dsp_min_scale: float = 1.0 / 6.0
    dsp_max_scale: float = 3.0
    dsp_num_scales: int = 10


@dataclass
class SiftMatchingConfig:
    max_ratio: float = 0.8
    max_distance: float = 0.7
    cross_check: bool = True
    max_error: float = 4.0
    min_num_inliers: int = 15
    guided_matching: bool = False
    use_pallas: bool = False  # accepted, no effect: on CUDA the top-2 kernel K1 is the matcher
    # hypothesis-bank size for match-stage two-view verification; the
    # registration-time init-pair estimation keeps TwoViewOptions' 2048 —
    # matcher-stage geometry only gates pairs and seeds the correspondence
    # graph (the mapper re-estimates via PnP/triangulation/BA), so a half
    # bank + PROSAC + LO trades negligible recall for ~2x verify throughput
    num_hypotheses: int = 1024


@dataclass
class MapperConfig:
    """Mapper.* namespace — mirrors IncrementalMapperOptions incl. all lidar
    flags (controllers/incremental_mapper.h:40-140)."""

    first_image_fixed_frames: int = 8
    min_proj_num: int = 1
    if_add_lidar_constraint: bool = True
    lidar_pointcloud_path: str = ""
    if_import_pose_prior: bool = False
    image_pose_prior_path: str = ""
    image_pose_save_folder: str = ""
    if_add_lidar_corresponding: bool = True
    kdtree_max_search_range: float = 1.5
    kdtree_min_search_range: float = 0.2
    search_range_drop_speed: float = 0.1
    ba_spherical_search_radius: float = 40.0
    ba_match_features_threshold: int = 200
    proj_lidar_constraint_weight: float = 10.0
    icp_lidar_constraint_weight: float = 1000.0
    icp_ground_lidar_constraint_weight: float = 10000.0
    proj_max_dist_error: float = 10.0
    icp_max_dist_error: float = 2.0
    depth_image_scale: float = 0.2
    max_proj_scale: int = 10
    min_proj_scale: int = 2
    min_proj_dist: float = 2.0
    choose_meter: float = 40.0
    min_lidar_proj_dist: float = 0.5
    submap_length: float = 1.0
    submap_width: float = 1.0
    submap_height: float = 1.0
    min_num_matches: int = 15
    init_image_id1: int = 1
    init_image_id2: int = -1
    init_image_x: float = 0.0
    init_image_y: float = 0.0
    init_image_z: float = 0.0
    init_image_roll: float = 0.0
    init_image_pitch: float = 0.0
    init_image_yaw: float = 0.0
    init_min_num_inliers: int = 100
    init_max_error: float = 4.0
    init_min_tri_angle: float = 16.0
    abs_pose_max_error: float = 24.0
    abs_pose_min_num_inliers: int = 30
    abs_pose_min_inlier_ratio: float = 0.25
    max_reg_trials: int = 3
    local_ba_num_images: int = 6
    filter_max_reproj_error: float = 8.0
    filter_min_tri_angle: float = 1.5
    multiple_models: bool = True
    max_num_models: int = 50
    max_model_overlap: int = 20
    min_model_size: int = 10
    init_num_trials: int = 200
    init_max_forward_motion: float = 0.95
    init_max_reg_trials: int = 2
    snapshot_path: str = ""
    snapshot_images_freq: int = 0
    num_threads: int = -1


@dataclass
class BundleAdjustmentConfig_:
    """BundleAdjustment.* namespace (optim/bundle_adjustment.h:52-116)."""

    if_add_lidar_constraint: bool = True
    proj_lidar_constraint_weight: float = 1.0
    icp_lidar_constraint_weight: float = 100.0
    icp_ground_lidar_constraint_weight: float = 1000.0
    if_add_lidar_corresponding: bool = True
    loss_function_type: str = "TRIVIAL"  # TRIVIAL | SOFT_L1 | CAUCHY
    loss_function_scale: float = 1.0
    refine_focal_length: bool = False
    refine_principal_point: bool = False
    refine_extra_params: bool = False
    refine_extrinsics: bool = True
    max_num_iterations: int = 100


@dataclass
class OptionManager:
    """All option namespaces + project file round-trip."""

    database_path: str = ""
    image_path: str = ""
    image_reader: ImageReaderConfig_ = field(default_factory=ImageReaderConfig_)
    sift_extraction: SiftExtractionConfig = field(default_factory=SiftExtractionConfig)
    sift_matching: SiftMatchingConfig = field(default_factory=SiftMatchingConfig)
    mapper: MapperConfig = field(default_factory=MapperConfig)
    bundle_adjustment: BundleAdjustmentConfig_ = field(default_factory=BundleAdjustmentConfig_)

    _SECTIONS = {
        "ImageReader": "image_reader",
        "SiftExtraction": "sift_extraction",
        "SiftMatching": "sift_matching",
        "Mapper": "mapper",
        "BundleAdjustment": "bundle_adjustment",
    }

    # -------------------------------------------------------------- CLI
    def parse_args(self, argv: list[str]) -> list[str]:
        """Consume --Namespace.field value / --field value pairs; returns
        leftover positional args. Unknown flags raise."""
        rest = []
        i = 0
        while i < len(argv):
            a = argv[i]
            if not a.startswith("--"):
                rest.append(a)
                i += 1
                continue
            key = a[2:]
            if "=" in key:
                key, val = key.split("=", 1)
                i += 1
            else:
                if i + 1 >= len(argv):
                    raise ValueError(f"missing value for {a}")
                val = argv[i + 1]
                i += 2
            self.set(key, val)
        return rest

    def set(self, key: str, val: str):
        if "." in key:
            ns, f = key.split(".", 1)
            if ns == "project" or ns not in self._SECTIONS:
                raise ValueError(f"unknown option namespace {ns}")
            obj = getattr(self, self._SECTIONS[ns])
        else:
            obj, f = self, key
        if not hasattr(obj, f):
            raise ValueError(f"unknown option {key}")
        cur = getattr(obj, f)
        setattr(obj, f, _coerce(val, type(cur)))

    # ------------------------------------------------------- quality presets
    def modify_for_quality(self, quality: str):
        """Quality presets applied to the option fields this build carries
        (option_manager.cc:111-168 ModifyFor{Low,Medium,High,Extreme}Quality;
        fields we don't have — patch-match samples, vocab-tree sizes — are
        governed by their own config dataclasses at call sites)."""
        q = quality.lower()
        if q == "low":
            self.sift_extraction.max_image_size = 1000
            self.bundle_adjustment.max_num_iterations = 50
        elif q == "medium":
            self.sift_extraction.max_image_size = 1600
            self.bundle_adjustment.max_num_iterations = 66
        elif q == "high":
            self.sift_extraction.estimate_affine_shape = True
            self.sift_extraction.max_image_size = 2400
            self.sift_matching.guided_matching = True
        elif q == "extreme":
            self.sift_extraction.estimate_affine_shape = True
            self.sift_extraction.domain_size_pooling = True
            self.sift_matching.guided_matching = True
        else:
            raise ValueError(f"invalid quality {quality!r}")

    # -------------------------------------------------------------- ini
    def write_ini(self, path: str):
        cp = configparser.ConfigParser()
        cp["root"] = {
            "database_path": self.database_path,
            "image_path": self.image_path,
        }
        for section, attr in self._SECTIONS.items():
            obj = getattr(self, attr)
            cp[section] = {f.name: str(getattr(obj, f.name)) for f in fields(obj)}
        with open(path, "w") as fh:
            cp.write(fh)

    def read_ini(self, path: str):
        cp = configparser.ConfigParser()
        cp.read(path)
        if "root" in cp:
            self.database_path = cp["root"].get("database_path", self.database_path)
            self.image_path = cp["root"].get("image_path", self.image_path)
        for section, attr in self._SECTIONS.items():
            if section not in cp:
                continue
            obj = getattr(self, attr)
            for f in fields(obj):
                if f.name in cp[section]:
                    setattr(obj, f.name, _coerce(cp[section][f.name], f.type if isinstance(f.type, type) else type(getattr(obj, f.name))))


def _coerce(val: str, typ: Any):
    if typ is bool or typ == "bool":
        return str(val).lower() in ("1", "true", "yes", "on")
    if typ is int or typ == "int":
        return int(val)
    if typ is float or typ == "float":
        return float(val)
    return str(val)
