"""The port's mapper with every BA solve distributed over a mesh
(`IncrementalMapper.dist_mesh`), on the lidar world of
tests/test_torch_e2e.py at that test's bars. A file of its own so that
tests/test_torch_parallel.py stays short on one worker."""

import numpy as np
import torch

import synthetic_torch
from colmap_pcd_tpu_torch.models import controllers as controllers_t
from colmap_pcd_tpu_torch.models import incremental_mapper as mapper_t
from colmap_pcd_tpu_torch.parallel import mesh as mesh_lib
from colmap_pcd_tpu_torch.utils.logging_utils import PHASES

from test_torch_e2e import _OPTS

torch.set_num_threads(1)  # tier-1 runs several workers on few cores


def _map(dist_mesh=None):
    rec, graph, lmap, gt = synthetic_torch.make_world(
        np.random.default_rng(7), n_images=8, n_points=600, noise_px=0.3)
    ctl = controllers_t.IncrementalMapperController(
        rec, graph, mapper_t.MapperOptions(**_OPTS), controllers_t.ControllerOptions(verbose=False),
        lidar_map=lmap, pose_priors={1: gt[0]},
    )
    ctl.mapper.dist_mesh = dist_mesh
    assert ctl.reconstruct()
    return rec, gt


def test_e2e_lidar_mapping_with_distributed_ba():
    """Over 4 CPU shards: >= 7/8 registered, ATE < 0.10 m, scale within 2%,
    |ATE_dist - ATE_single| < 0.02 m against the one-shard mapper, and every
    BA solve was sharded (the `ba_shard` span) and went through the mesh's
    reductions."""
    before = PHASES.counts.get("ba_reductions", 0)
    solves = PHASES.counts.get("ba_solves", 0)
    sharded = PHASES.counts.get("ba_shard", 0)
    bundles = PHASES.counts.get("ba_device", 0)
    rec, gt = _map(mesh_lib.make_mesh(4, devices=["cpu"] * 4))
    n_solves = PHASES.counts.get("ba_solves", 0) - solves
    assert n_solves > 0
    # every bundle solve (`ba_device`; the one-image pose refinement is not
    # one) sharded once
    assert PHASES.counts.get("ba_shard", 0) - sharded == PHASES.counts.get("ba_device", 0) - bundles > 0
    # at least the initial cost, one system and one cost per solve
    assert PHASES.counts.get("ba_reductions", 0) - before >= 3 * n_solves
    assert rec.num_reg_images >= 7, rec.num_reg_images
    ate = synthetic_torch.ate_rmse(rec, gt)
    assert ate < 0.10, ate
    assert synthetic_torch.scale_error(rec, gt) < 0.02

    rec_s, gt_s = _map()
    ate_s = synthetic_torch.ate_rmse(rec_s, gt_s)
    assert abs(ate - ate_s) < 0.02, (ate, ate_s)
