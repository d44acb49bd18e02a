"""End-to-end lidar mapping through the port's controller on the CPU, on the
worlds of tests/test_e2e.py and with its thresholds, held against the JAX
package on the same world."""

import numpy as np
import torch

import synthetic
import synthetic_torch
from colmap_pcd_tpu.models import controllers as controllers_j
from colmap_pcd_tpu.models import incremental_mapper as mapper_j
from colmap_pcd_tpu_torch.models import controllers as controllers_t
from colmap_pcd_tpu_torch.models import incremental_mapper as mapper_t

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

_OPTS = dict(
    if_add_lidar_constraint=True,
    init_image_id1=1,
    init_image_id2=2,
    abs_pose_min_num_inliers=15,
    init_min_num_inliers=50,
    num_ransac_hypotheses=1024,
)


def _map(make_world, controllers, mapper, seed, n_images, n_points, **copts):
    rec, graph, lmap, gt = make_world(
        np.random.default_rng(seed), n_images=n_images, n_points=n_points, noise_px=0.3
    )
    ctl = controllers.IncrementalMapperController(
        rec, graph, mapper.MapperOptions(**_OPTS),
        controllers.ControllerOptions(verbose=False, **copts),
        lidar_map=lmap, pose_priors={1: gt[0]},
    )
    return ctl, rec, gt


def test_e2e_lidar_mapping_matches_jax():
    """test_e2e_lidar_mapping's world and bars (>= 7/8 registered, ATE <
    0.10 m, scale within 2%), and |ATE_port - ATE_jax| < 0.02 m: RANSAC
    samples differ between the two (torch.Generator vs jax.random), so the
    trajectories agree statistically, not bit for bit."""
    ctl, rec, gt = _map(synthetic_torch.make_world, controllers_t, mapper_t, 7, 8, 600)
    assert ctl.reconstruct()
    assert rec.num_reg_images >= 7, rec.num_reg_images
    ate = synthetic_torch.ate_rmse(rec, gt)
    assert ate < 0.10, ate
    assert synthetic_torch.scale_error(rec, gt) < 0.02

    ctl_j, rec_j, gt_j = _map(synthetic.make_world, controllers_j, mapper_j, 7, 8, 600)
    assert ctl_j.reconstruct()
    ate_j = synthetic.ate_rmse(rec_j, gt_j)
    assert abs(ate - ate_j) < 0.02, (ate, ate_j)


def test_scoped_vs_full_global_refinement_equivalent_accuracy():
    """The every-N global cadence scopes CompleteAndMergeTracks to recent
    points; with scoping forced off the port lands at the same ATE within
    0.02 m and registers as many images."""
    results = {}
    for scoped in (True, False):
        ctl, rec, gt = _map(
            synthetic_torch.make_world, controllers_t, mapper_t, 11, 10, 700,
            ba_global_images_freq=3,
        )
        if not scoped:
            ctl._global_refinement_is_full = lambda: True
        assert ctl.reconstruct()
        results[scoped] = (rec.num_reg_images, synthetic_torch.ate_rmse(rec, gt))
    (n_s, ate_s), (n_f, ate_f) = results[True], results[False]
    assert n_s == n_f, results
    assert ate_s < 0.10 and ate_f < 0.10, results
    assert abs(ate_s - ate_f) < 0.02, results
