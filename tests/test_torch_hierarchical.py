"""The port's hierarchical mapper held to the JAX package on the CPU: the
twins of tests/test_hierarchical.py (same worlds, same bars) and the
clustering's partition against the JAX package's on one graph."""

import copy

import numpy as np
import pytest
import torch

import synthetic
import synthetic_torch
from colmap_pcd_tpu.models import hierarchical as hier_j
from colmap_pcd_tpu.models.controllers import ControllerOptions as ControllerOptionsJ
from colmap_pcd_tpu.models.correspondence_graph import CorrespondenceGraph as GraphJ
from colmap_pcd_tpu.models.incremental_mapper import MapperOptions as MapperOptionsJ
from colmap_pcd_tpu_torch.models import hierarchical as hier_t
from colmap_pcd_tpu_torch.models.controllers import ControllerOptions
from colmap_pcd_tpu_torch.models.correspondence_graph import CorrespondenceGraph as GraphT
from colmap_pcd_tpu_torch.models.incremental_mapper import MapperOptions
from colmap_pcd_tpu_torch.ops import np_geom

torch.set_num_threads(1)  # the suite runs several workers on few cores


def _chain_graph(Graph, n=100, overlap=5):
    """The match graph of a sequential capture: each image matched to its
    `overlap` successors, fewer matches further apart."""
    g = Graph()
    for i in range(1, n + 1):
        for d in range(1, overlap + 1):
            if i + d <= n:
                m = np.arange(50 - 5 * d)
                g.add_matches(i, i + d, np.stack([m, m], 1).astype(np.int32))
    return g


@pytest.mark.parametrize("graph", ["world", "chain"])
def test_cluster_images_same_partition(graph):
    """Both packages cut the same graph into the same overlapping leaves,
    which cover every image. "world": test_cluster_images_balanced's
    12-image world in leaves of 8 (the leaves overlap). "chain": a
    100-image sequential capture in leaves of 50 sharing 10, as
    chip_smoke.py runs hierarchical_mapper: the greedy bisection peels the
    chain's far end image by image, so one leaf of 56 and 41 of 6-12 images
    come out in both packages."""
    out = []
    for make_world, hier, Graph in ((synthetic.make_world, hier_j, GraphJ),
                                    (synthetic_torch.make_world, hier_t, GraphT)):
        if graph == "world":
            rec, g, _, _ = make_world(np.random.default_rng(0), n_images=12, n_points=400)
            ids, opts = list(rec.images.keys()), hier.SceneClusteringOptions(leaf_max_num_images=8)
        else:
            g, ids = _chain_graph(Graph), list(range(1, 101))
            opts = hier.SceneClusteringOptions(leaf_max_num_images=50, image_overlap=10)
        out.append(hier.cluster_images(g, ids, opts))
    clusters_j, clusters_t = out
    assert clusters_t == clusters_j
    assert set().union(*map(set, clusters_t)) == set(ids)
    if graph == "world":
        assert len(clusters_t) >= 2 and set(clusters_t[0]) & set(clusters_t[1])
    else:
        sizes = sorted(len(c) for c in clusters_t)
        assert len(sizes) == 42 and sizes[-1] == 56 and sizes[-2] <= 12


def test_merge_reconstructions():
    """test_merge_reconstructions: two halves of one world, the second in a
    scaled and shifted frame, merge back into one model (ATE < 0.05 m)."""
    rec_a, _, _, gt = synthetic_torch.make_world(np.random.default_rng(0), n_images=8, n_points=500)
    rec_b = copy.deepcopy(rec_a)
    for i in range(1, 7):
        rec_a.images[i].qvec, rec_a.images[i].tvec = gt[i - 1]
        rec_a.register_image(i)
    s, tshift = 2.0, np.asarray([5.0, -1.0, 2.0])
    for i in range(4, 9):  # world' = s * world + tshift  =>  t' = s t - R tshift
        q, t = gt[i - 1]
        rec_b.images[i].qvec = q
        rec_b.images[i].tvec = s * t - np_geom.quat_to_rotmat(q) @ tshift
        rec_b.register_image(i)
    assert hier_t.merge_reconstructions(rec_a, rec_b, device="cpu")
    assert rec_a.num_reg_images == 8
    assert synthetic_torch.ate_rmse(rec_a, gt) < 0.05


def test_hierarchical_end_to_end_matches_jax():
    """test_hierarchical_end_to_end's world (10 images, leaves of 6 with 4
    of overlap, the lidar map and the pose prior of image 1) through both
    packages: the port registers >= 7 at ATE < 0.15 m, and its ATE is
    within 0.05 m of the JAX package's (RANSAC draws differ between
    torch.Generator and jax.random, so the trajectories agree
    statistically, not bit for bit)."""
    ates = []
    for make_world, hier, Mo, Co in (
        (synthetic.make_world, hier_j, MapperOptionsJ, ControllerOptionsJ),
        (synthetic_torch.make_world, hier_t, MapperOptions, ControllerOptions),
    ):
        rec, graph, lmap, gt = make_world(np.random.default_rng(0), n_images=10, n_points=600, noise_px=0.3)
        opts = Mo(if_add_lidar_constraint=True, init_image_id1=1, init_image_id2=2,
                  abs_pose_min_num_inliers=15, init_min_num_inliers=50, num_ransac_hypotheses=1024)
        kw = {"device": "cpu"} if hier is hier_t else {}
        out = hier.run_hierarchical_mapper(
            lambda: copy.deepcopy(rec), graph, opts,
            hier.SceneClusteringOptions(leaf_max_num_images=6, image_overlap=4),
            lidar_map=lmap, pose_priors={1: gt[0]}, controller_options=Co(verbose=False), **kw,
        )
        ates.append(synthetic.ate_rmse(out, gt) if hier is hier_j else synthetic_torch.ate_rmse(out, gt))
        if hier is hier_t:
            assert out.num_reg_images >= 7, out.num_reg_images
    ate_j, ate_t = ates
    assert ate_t < 0.15, ate_t
    assert abs(ate_t - ate_j) < 0.05, (ate_t, ate_j)
