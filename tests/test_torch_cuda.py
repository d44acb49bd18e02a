"""Tests of the port that need an NVIDIA GPU (marked `cuda`; they skip
without one). This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from colmap_pcd_tpu_torch.ops import nn_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the nn_argmin CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("Q", [37, 4096])
def test_nn_kernel_matches_plain_version(cuda_device, Q):
    """The hand-written kernel against its plain version at the mapper's
    query counts and a ragged ~0-105 m map: distances to 1e-5 relative,
    indices equal except where both points are equally near."""
    rng = np.random.default_rng(Q)
    p = rng.uniform([-4, -2, 0], [4, 2, 105], (200_003, 3)).astype(np.float32)
    q = (p[rng.integers(0, len(p), Q)] + rng.normal(0, 0.2, (Q, 3))).astype(np.float32)
    qt = torch.as_tensor(q, device=cuda_device)
    pt = torch.as_tensor(p, device=cuda_device)
    before = nn_kernel.nn_argmin.launches
    idx, dist = nn_kernel.nn_argmin(qt, pt)
    torch.cuda.synchronize()
    assert nn_kernel.nn_argmin.launches == before + 1
    ref_idx, ref_dist = nn_kernel.nn_argmin_reference(qt, pt)
    idx, dist, ref_idx, ref_dist = (a.cpu().numpy() for a in (idx, dist, ref_idx, ref_dist))
    np.testing.assert_allclose(dist, ref_dist, rtol=1e-5, atol=1e-6)
    mism = idx != ref_idx
    d_k = np.linalg.norm(p[idx[mism]].astype(np.float64) - q[mism], axis=-1)
    d_r = np.linalg.norm(p[ref_idx[mism]].astype(np.float64) - q[mism], axis=-1)
    np.testing.assert_allclose(d_k, d_r, rtol=1e-5)


def test_nn_kernel_rejects_mixed_devices(cuda_device):
    q = torch.zeros((4, 3), device=cuda_device)
    with pytest.raises(ValueError):
        nn_kernel.nn_argmin(q, torch.zeros((8, 3)))
    with pytest.raises(ValueError):
        nn_kernel.nn_argmin(q, torch.zeros((0, 3), device=cuda_device))


def test_mapper_on_gpu_goes_through_the_kernel(cuda_device):
    """The small corridor world mapped on the GPU: the thresholds of
    tests/test_e2e.py, and the lidar NN association launched the kernel."""
    from colmap_pcd_tpu_torch.models.controllers import (
        ControllerOptions,
        IncrementalMapperController,
    )
    from colmap_pcd_tpu_torch.models.incremental_mapper import MapperOptions
    from synthetic_torch import ate_rmse, make_world, scale_error

    rec, graph, lmap, gt = make_world(
        np.random.default_rng(7), n_images=8, n_points=600, noise_px=0.3, device=cuda_device
    )
    opts = MapperOptions(
        if_add_lidar_constraint=True, init_image_id1=1, init_image_id2=2,
        abs_pose_min_num_inliers=15, init_min_num_inliers=50, num_ransac_hypotheses=1024,
    )
    ctl = IncrementalMapperController(
        rec, graph, opts, ControllerOptions(verbose=False), lidar_map=lmap, pose_priors={1: gt[0]}
    )
    before = nn_kernel.nn_argmin.launches
    assert ctl.reconstruct()
    assert nn_kernel.nn_argmin.launches > before
    assert rec.num_reg_images >= 7
    assert ate_rmse(rec, gt) < 0.10
    assert scale_error(rec, gt) < 0.02
