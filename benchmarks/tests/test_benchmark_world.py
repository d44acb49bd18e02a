"""The frozen world of benchmarks/world/ reproduces the pixel world that the
port's records were taken on (tests/render_torch.py and
tests/synthetic_torch.py) at seed 0, job 0, on the CPU; its second version
(corridor_fine) keeps its geometry and fills COLMAP's 8192-feature cap."""

import os
import sys

import numpy as np
import pytest

from benchmarks.world import corridor, corridor_fine

TESTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "tests")


@pytest.fixture(scope="module")
def original():
    sys.path.insert(0, TESTS)
    try:
        import render_torch
        import synthetic_torch
    finally:
        sys.path.remove(TESTS)
    return render_torch, synthetic_torch


def test_seed_zero_is_the_original_world():
    assert corridor.world_key(0, 0) == 0


def test_trajectory(original):
    _, synthetic = original
    for (q0, t0), (q1, t1) in zip(synthetic.make_trajectory(30, 0.8), corridor.trajectory(30)):
        np.testing.assert_allclose(q1, q0, rtol=0, atol=1e-15)
        np.testing.assert_allclose(t1, t0, rtol=0, atol=1e-12)


def test_map():
    from colmap_pcd_tpu_torch.utils.synthetic_world import build_corridor_map

    for a, b in zip(build_corridor_map(None, length=25 * 0.8 + 25), corridor.build_corridor_map(25 * 0.8 + 25)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [(320, 240, 250.0), (160, 120, 125.0)])
def test_views_within_one_gray_level(original, size):
    render, _ = original
    poses = corridor.trajectory(4)
    ours = corridor.render_u8(poses, *size)
    for view, (q, t) in zip(ours, poses):
        theirs = (render.render_corridor(q, t, *size) * 255).astype(np.uint8)
        assert np.abs(view.astype(int) - theirs.astype(int)).max() <= 1


def test_seeds_change_textures():
    a = corridor.render_u8(corridor.trajectory(1), 64, 48, 50.0)
    off = corridor.world_key(2**31 + 17, 3)
    b = corridor.render_u8(corridor.trajectory(1), 64, 48, 50.0, off)
    assert off != 0 and np.abs(a.astype(int) - b.astype(int)).mean() > 5
    assert corridor.world_key(2**31 + 17, 3) == off  # the same seed, the same world


def test_fine_world_keeps_the_geometry():
    assert corridor_fine.trajectory is corridor.trajectory and corridor_fine.world_key is corridor.world_key
    assert corridor_fine.build_corridor_map is corridor.build_corridor_map
    a = corridor.render_u8(corridor.trajectory(2), 64, 48, 50.0)
    b = corridor_fine.render_u8(corridor.trajectory(2), 64, 48, 50.0)
    # the same sky (nothing hit), other textures on the walls and the ground
    np.testing.assert_array_equal(a == 20, b == 20)
    assert np.abs(a.astype(int) - b.astype(int)).mean() > 5


def test_fine_world_fills_the_feature_cap():
    """At the configuration's 1280x960, f = 1000, the port's SIFT at COLMAP's
    defaults (first_octave -1, 4 octaves, 8192 features) fills the cap in
    the first view of the seed-0 world (740-1100 keypoints in corridor's)."""
    import torch

    from colmap_pcd_tpu_torch.ops import sift

    view = corridor_fine.render_u8(corridor.trajectory(1), 1280, 960, 1000.0)[0]
    valid = sift.extract(torch.as_tensor(view), sift.SiftOptions())[3]
    assert int(valid.sum()) == 8192
