"""Tests of the port that need an NVIDIA GPU (marked `cuda`; they skip
without one). This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from colmap_pcd_tpu_torch.ops import match_kernel, matching, nn_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written CUDA kernels have no CPU mode")
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


def test_match_kernel_matches_plain_version(cuda_device):
    """K1 against its plain version at the matcher's chunk (16 pairs at cap
    2048, ragged valid rows): similarities to 1e-6, indices equal away
    from near-ties, and match_descriptors' decisions equal away from them."""
    rng = np.random.default_rng(0)
    B, cap = 16, 2048
    d = rng.normal(size=(B, 2 * cap, 128)) ** 2
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    v1 = np.zeros((B, cap), np.float32)
    v2 = np.zeros((B, cap), np.float32)
    for b in range(B):
        v1[b, : rng.integers(1500, cap + 1)] = 1.0
        v2[b, : rng.integers(1500, cap + 1)] = 1.0
    d1 = torch.as_tensor((d[:, :cap] * v1[..., None]).astype(np.float32), device=cuda_device)
    noisy = d[:, :cap] + rng.normal(0, 0.02, (B, cap, 128))
    noisy /= np.linalg.norm(noisy, axis=-1, keepdims=True)
    d2 = torch.as_tensor((noisy[:, rng.permutation(cap)] * v2[..., None]).astype(np.float32), device=cuda_device)
    v1t, v2t = torch.as_tensor(v1, device=cuda_device), torch.as_tensor(v2, device=cuda_device)
    before = match_kernel.match_top2.launches
    s1, s2, idx = match_kernel.match_top2(d1, d2, v2t)
    torch.cuda.synchronize()
    assert match_kernel.match_top2.launches == before + 1
    r1, r2, ridx = match_kernel.match_top2_reference(d1, d2, v2t)
    assert float((s1 - r1).abs().max()) <= 1e-6
    assert float((s2 - r2).abs().max()) <= 1e-6
    sep = (r1 - r2) > 1e-6
    assert bool((idx[sep] == ridx[sep]).all())
    _, ok, _ = matching.match_descriptors(d1, d2, v1t, v2t)
    _, ok_ref, _ = matching.match_descriptors_reference(d1, d2, v1t, v2t)
    assert int(((ok != ok_ref) & sep).sum()) == 0
    assert int(ok.sum()) > 1000


def test_sequential_matcher_on_gpu_goes_through_the_kernel(cuda_device, tmp_path):
    """`sequential_matcher` on the GPU launches K1 and writes precise
    verified matches."""
    from colmap_pcd_tpu_torch import cli
    from synthetic_torch import make_descriptor_world, match_precision_recall, write_world

    rec, graph, lmap, gt, desc, point_ids = make_descriptor_world(
        np.random.default_rng(5), n_images=6, n_points=420
    )
    paths = write_world(rec, graph, lmap, gt, str(tmp_path), descriptors=desc)
    before = match_kernel.match_top2.launches
    assert cli.main(["sequential_matcher", "--database_path", paths["database"]]) == 0
    assert match_kernel.match_top2.launches > before
    pr = match_precision_recall(paths["database"], point_ids)
    assert pr["pairs_verified"] > 0 and pr["precision"] > 0.99, pr
