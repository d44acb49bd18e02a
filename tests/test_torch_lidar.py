"""Parity of the port's lidar ops with the JAX package: depth projection
(single view, the per-view candidate batch and the shared-map batch), ray-plane seeding, the plain version
of the 1-NN kernel K2, and the LidarMap glue. Inputs are made with numpy from
a seed and handed to both implementations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_pcd_tpu.models.lidar_map import LidarMap as LidarMapJ
from colmap_pcd_tpu.ops import pallas_kernels as pk
from colmap_pcd_tpu.ops import pointcloud as pc_j
from colmap_pcd_tpu_torch import convert
from colmap_pcd_tpu_torch.ops import nn_kernel
from colmap_pcd_tpu_torch.ops import np_geom
from colmap_pcd_tpu_torch.ops import pointcloud as pc_t

from synthetic_torch import build_corridor_map

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

T = torch.as_tensor
PINHOLE = 1
OPENCV = 4
W, H = 640, 480


def _views(rng, B):
    """B camera poses moving down the corridor, with a little yaw."""
    qs, ts = [], []
    for b in range(B):
        yaw = 0.05 * rng.normal()
        q = np.asarray([np.cos(yaw / 2), 0.0, -np.sin(yaw / 2), 0.0])  # world->camera
        c = np.asarray([0.3 * rng.normal(), 0.2 * rng.normal(), 2.0 + 1.5 * b])
        qs.append(q)
        ts.append(-np_geom.quat_to_rotmat(q) @ c)
    return np.asarray(qs, np.float32), np.asarray(ts, np.float32)


def _features(rng, B, F):
    xy = rng.uniform([-20, -20], [W + 20, H + 20], size=(B, F, 2)).astype(np.float32)
    valid = (rng.random((B, F)) > 0.1).astype(np.float32)
    return xy, valid


def _params(model_id):
    if model_id == PINHOLE:
        p = [500.0, 500.0, 320.0, 240.0]
    else:
        p = [500.0, 505.0, 320.0, 240.0, 0.02, -0.005, 0.001, -0.001]
    return np.pad(np.asarray(p, np.float32), (0, 12 - len(p)))


def _assert_same_association(lpt_t, found_t, lpt_j, found_j, q, t):
    """`found` equal; the chosen lidar point equal except at distance ties
    (two covering points within 1e-4 m of the same distance to the camera)."""
    np.testing.assert_array_equal(found_t, found_j)
    diff = np.any(lpt_t != lpt_j, axis=-1) & found_j
    if diff.any():
        Rm = np_geom.quat_to_rotmat(q)
        dt = np.linalg.norm(lpt_t[diff] @ Rm.T + t, axis=-1)
        dj = np.linalg.norm(lpt_j[diff] @ Rm.T + t, axis=-1)
        np.testing.assert_allclose(dt, dj, atol=1e-4)
    assert diff.mean() < 0.01


@pytest.fixture(scope="module")
def corridor():
    pts, nrm = build_corridor_map(np.random.default_rng(0), length=30.0, spacing=0.1)
    return pts, nrm


@pytest.mark.parametrize("model_id", [PINHOLE, OPENCV])
def test_depth_project_parity(corridor, model_id):
    pts, nrm = corridor
    rng = np.random.default_rng(model_id)
    q, t = _views(rng, 1)
    xy, valid = _features(rng, 1, 700)
    params = _params(model_id)
    opts_j = pc_j.ProjOptions()
    mv = np.ones(len(pts), np.float32)
    lj, nj, fj = (np.asarray(a) for a in pc_j.depth_project(
        jnp.asarray(xy[0]), jnp.asarray(valid[0]), jnp.asarray(pts), jnp.asarray(nrm),
        jnp.asarray(mv), jnp.asarray(q[0]), jnp.asarray(t[0]), jnp.asarray(params),
        W, H, model_id, opts_j,
    ))
    lt, nt, ft = (a.numpy() for a in pc_t.depth_project(
        T(xy[0]), T(valid[0]), T(pts), T(nrm), T(mv), T(q[0]), T(t[0]), T(params),
        W, H, model_id, convert.proj_options_from(opts_j._asdict()), block=4096,
    ))
    assert fj.sum() > 200
    _assert_same_association(lt, ft, lj, fj, q[0], t[0])


def test_depth_project_shared_parity(corridor):
    pts, nrm = corridor
    rng = np.random.default_rng(2)
    B, F = 3, 500
    q, t = _views(rng, B)
    xy, valid = _features(rng, B, F)
    params = np.tile(_params(PINHOLE), (B, 1))
    mv = (rng.random(len(pts)) > 0.05).astype(np.float32)  # some invalid map rows
    opts = pc_j.ProjOptions()
    lj, _, fj = (np.asarray(a) for a in pc_j.depth_project_shared(
        jnp.asarray(xy), jnp.asarray(valid), jnp.asarray(pts), jnp.asarray(nrm),
        jnp.asarray(mv), jnp.asarray(q), jnp.asarray(t), jnp.asarray(params),
        W, H, PINHOLE, opts,
    ))
    lt, _, ft = (a.numpy() for a in pc_t.depth_project_shared(
        T(xy), T(valid), T(pts), T(nrm), T(mv), T(q), T(t), T(params),
        W, H, PINHOLE, pc_t.ProjOptions(**opts._asdict()),
    ))
    for b in range(B):
        _assert_same_association(lt[b], ft[b], lj[b], fj[b], q[b], t[b])


def test_depth_project_batch_parity(corridor):
    """Each view over its own frustum-culled candidate set, ragged and padded
    to the longest (the padding invalid), with the mapper's projection
    options: the port's batch against the JAX package's vmapped
    depth_project, by _assert_same_association (found equal; points equal
    but at distance ties within 1e-4 m on < 1% of the features); and
    against the port's own depth_project of each view, exactly."""
    pts, nrm = corridor
    rng = np.random.default_rng(4)
    B, F = 3, 400
    q, t = _views(rng, B)
    xy, valid = _features(rng, B, F)
    params = np.tile(_params(PINHOLE), (B, 1))
    opts = pc_j.ProjOptions()
    sets = []
    for b in range(B):
        planes = pc_t.frustum_planes(T(q[b]), T(t[b]), 500.0, 500.0, 320.0, 240.0, W, H,
                                     opts.choose_meter)
        sel = pc_t.points_in_frustum(planes, T(pts)).numpy()
        sets.append(np.nonzero(sel)[0][: len(pts) // (b + 2)])  # ragged
    M = max(len(s) for s in sets)
    cp = np.zeros((B, M, 3), np.float32)
    cn = np.zeros((B, M, 3), np.float32)
    cv = np.zeros((B, M), np.float32)
    for b, s in enumerate(sets):
        cp[b, : len(s)], cn[b, : len(s)], cv[b, : len(s)] = pts[s], nrm[s], 1.0
    assert len({len(s) for s in sets}) == B and min(len(s) for s in sets) > 1000
    lj, _, fj = (np.asarray(a) for a in pc_j.depth_project_batch(
        jnp.asarray(xy), jnp.asarray(valid), jnp.asarray(cp), jnp.asarray(cn), jnp.asarray(cv),
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(params), W, H, PINHOLE, opts,
    ))
    opts_t = convert.proj_options_from(opts._asdict())
    lt, nt, ft = (a.numpy() for a in pc_t.depth_project_batch(
        T(xy), T(valid), T(cp), T(cn), T(cv), T(q), T(t), T(params), W, H, PINHOLE, opts_t,
    ))
    assert fj.sum() > 300
    for b in range(B):
        _assert_same_association(lt[b], ft[b], lj[b], fj[b], q[b], t[b])
        one = [a.numpy() for a in pc_t.depth_project(
            T(xy[b]), T(valid[b]), T(cp[b]), T(cn[b]), T(cv[b]), T(q[b]), T(t[b]), T(params[b]),
            W, H, PINHOLE, opts_t,
        )]
        np.testing.assert_array_equal(ft[b], one[2])
        np.testing.assert_array_equal(lt[b][ft[b]], one[0][one[2]])
        np.testing.assert_array_equal(nt[b][ft[b]], one[1][one[2]])


def test_ray_plane_points_parity():
    rng = np.random.default_rng(3)
    q, t = _views(rng, 1)
    xy = rng.uniform([0, 0], [W, H], size=(256, 2)).astype(np.float32)
    n = rng.normal(size=(256, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    p0 = rng.uniform([-4, -2, 5], [4, 2, 30], size=(256, 3)).astype(np.float32)
    planes = np.concatenate([n, -np.sum(n * p0, -1, keepdims=True)], -1).astype(np.float32)
    found = rng.random(256) > 0.2
    params = _params(OPENCV)
    Xj, okj = (np.asarray(a) for a in pc_j.ray_plane_points(
        jnp.asarray(xy), jnp.asarray(planes), jnp.asarray(found), jnp.asarray(q[0]),
        jnp.asarray(t[0]), jnp.asarray(params), OPENCV,
    ))
    Xt, okt = (a.numpy() for a in pc_t.ray_plane_points(
        T(xy), T(planes), T(found), T(q[0]), T(t[0]), T(params), OPENCV,
    ))
    np.testing.assert_array_equal(okt, okj)
    # intersection points: 1e-4 relative (f32 ray-plane solve)
    np.testing.assert_allclose(Xt[okj], Xj[okj], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# K2: the plain version of the 1-NN kernel


def test_nn_reference_matches_pallas_and_kdtree():
    """[-5,5] coordinates, where the Pallas kernel's cross-term identity is
    accurate: exact indices against Pallas (interpret mode) and the C++
    kd-tree."""
    rng = np.random.default_rng(0)
    Q, N = 256, 4096
    q = rng.uniform(-5, 5, (Q, 3)).astype(np.float32)
    p = rng.uniform(-5, 5, (N, 3)).astype(np.float32)
    idx_t, dist_t = nn_kernel.nn_argmin_reference(T(q), T(p))
    idx_p, dist_p = pk.nn_argmin(jnp.asarray(q), jnp.asarray(p), interpret=True)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_p))
    np.testing.assert_allclose(dist_t.numpy(), np.asarray(dist_p), atol=1e-4)
    lmap = LidarMapJ.from_arrays(p, np.tile([0.0, 1.0, 0.0], (N, 1)))
    pts_h, _, dist_h = lmap.nn_query(q, backend="host")
    np.testing.assert_array_equal(p[idx_t.numpy()], pts_h)
    np.testing.assert_allclose(dist_t.numpy(), dist_h, rtol=1e-5)


def test_nn_reference_exact_at_map_scale():
    """~50 m coordinates against a float64 brute force: exact indices except
    exact distance ties. (The JAX kernel's |q|^2+|p|^2-2q.p loses metres
    here, so it is not the reference at this scale.)"""
    rng = np.random.default_rng(1)
    p = rng.uniform([-40, -5, 20], [40, 5, 100], (20000, 3)).astype(np.float32)
    q = (p[rng.integers(0, len(p), 300)] + rng.normal(0, 0.3, (300, 3))).astype(np.float32)
    q = np.concatenate([q, rng.uniform([-40, -5, 20], [40, 5, 100], (37, 3)).astype(np.float32)])
    q[:5] = p[:5]  # exact hits
    idx_t, dist_t = (a.numpy() for a in nn_kernel.nn_argmin_reference(T(q), T(p)))
    d64 = np.sqrt(((q[:, None, :].astype(np.float64) - p[None].astype(np.float64)) ** 2).sum(-1))
    oracle = np.argmin(d64, axis=1)
    mism = idx_t != oracle
    # a mismatch is allowed only where both points are equally near in f64
    np.testing.assert_allclose(
        d64[np.arange(len(q)), idx_t][mism], d64[np.arange(len(q)), oracle][mism], rtol=1e-6
    )
    np.testing.assert_allclose(dist_t, d64[np.arange(len(q)), oracle], rtol=1e-5, atol=1e-6)


def test_nn_wrapper_cpu_takes_plain_version_and_validates():
    rng = np.random.default_rng(2)
    q = T(rng.normal(size=(37, 3)).astype(np.float32))
    p = T(rng.normal(size=(1000, 3)).astype(np.float32))
    before = nn_kernel.nn_argmin.launches
    idx, dist = nn_kernel.nn_argmin(q, p)
    ref_idx, ref_dist = nn_kernel.nn_argmin_reference(q, p)
    assert nn_kernel.nn_argmin.launches == before  # no kernel launch on the CPU
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), ref_idx.numpy())
    with pytest.raises(ValueError):
        nn_kernel.nn_argmin(q.double(), p.double())
    with pytest.raises(ValueError):
        nn_kernel.nn_argmin(q[:, :2], p)


def test_lidar_map_nn_query_backends_and_conversion(corridor):
    """The port's map, carried over from the JAX map's arrays
    (convert.lidar_map_from_numpy), answers nn_query identically through
    its device path (plain version on the CPU) and the host kd-tree, and
    agrees with the JAX map's host kd-tree."""
    pts, nrm = corridor
    mj = LidarMapJ.from_arrays(pts, nrm, pc_j.ProjOptions())
    mt = convert.lidar_map_from_numpy(
        mj.points, mj.normals, mj.cell_keys, mj.cell_start, mj.cell_count,
        mj.opts._asdict(), device="cpu",
    )
    rng = np.random.default_rng(4)
    qr = (pts[rng.integers(0, len(pts), 500)] + rng.normal(0, 0.05, (500, 3))).astype(np.float32)
    pd, nd, dd = mt.nn_query(qr, backend="device")
    ph, nh, dh = mt.nn_query(qr, backend="host")
    pj, nj, dj = mj.nn_query(qr, backend="host")
    np.testing.assert_array_equal(pd, ph)
    np.testing.assert_array_equal(nd, nh)
    np.testing.assert_array_equal(pd, pj)
    np.testing.assert_allclose(dd, dj, rtol=1e-5, atol=1e-6)
    # the masked plain query of ops/pointcloud skips invalid map rows
    valid = np.ones(len(pts), np.float32)
    valid[::2] = 0.0
    idx, _ = pc_t.nn_query(T(qr), mt.d_points, T(valid))
    assert np.all(valid[idx.numpy()] > 0)



def test_nn_reference_packed_map_with_ties_at_map_scale():
    """The plain version on the [N,4] layout the kernel reads, at ~50 m
    coordinates: the same answers as on [N,3], exact hits found at distance
    0, and of equally near points (duplicates far apart in the map) the
    lowest index."""
    rng = np.random.default_rng(5)
    p = rng.uniform([-40, -5, 20], [40, 5, 100], (30000, 3)).astype(np.float32)
    p[20000:20010] = p[100:110]  # duplicates at higher indices
    q = (p[rng.integers(0, len(p), 200)] + rng.normal(0, 0.3, (200, 3))).astype(np.float32)
    q[:10] = p[20000:20010]
    p4 = nn_kernel.pack_points(T(p))
    assert p4.shape == (30000, 4) and p4.is_contiguous() and bool((p4[:, 3] == 0).all())
    idx4, dist4 = nn_kernel.nn_argmin(T(q), p4)
    idx3, dist3 = nn_kernel.nn_argmin_reference(T(q), T(p))
    np.testing.assert_array_equal(idx4.numpy(), idx3.numpy())
    np.testing.assert_array_equal(dist4.numpy(), dist3.numpy())
    np.testing.assert_array_equal(idx4.numpy()[:10], np.arange(100, 110))
    assert float(dist4[:10].max()) == 0.0
    d64 = np.sqrt(((q[:, None, :].astype(np.float64) - p[None].astype(np.float64)) ** 2).sum(-1))
    np.testing.assert_allclose(dist4.numpy(), d64.min(axis=1), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        nn_kernel.nn_argmin(T(q), torch.zeros((8, 5)))


@pytest.mark.parametrize("Q,N", [(1, 5), (37, 504_000), (384, 504_000), (385, 504_000),
                                 (4096, 504_000), (4096, 100_003), (100_000, 2000)])
def test_nn_launch_plan_covers_the_map(Q, N):
    """How the wrapper splits a launch over the grid (132 SMs; the scans'
    sizes as a library reports them: 512 queries a block over 512-point
    tiles, 8 queries a block over rounds of 1024 points): few queries take
    the scan that splits the points among a block's threads, the chunks are
    multiples of that scan's granule and cover the map with no empty split,
    and about two blocks per SM are in flight."""
    tiles = ((512, 512), (8, 1024))
    mode, chunk, splits = nn_kernel.launch_plan(Q, N, 132, tiles)
    assert mode == (1 if Q <= nn_kernel.FEW_QUERIES_MAX else 0)
    block_queries, granule = tiles[mode]
    assert chunk % granule == 0
    assert splits * chunk >= N > (splits - 1) * chunk
    blocks = -(-Q // block_queries) * splits
    assert blocks <= 2 * 132 + -(-Q // block_queries)
    if N >= 100_000:
        assert blocks >= 132
    # the measuring scripts force a scan and a depth through the arguments
    assert nn_kernel.launch_plan(Q, N, 132, tiles, few_max=0)[0] == 0
    assert nn_kernel.launch_plan(Q, N, 132, tiles, few_max=1 << 30, blocks_per_sm=4)[0] == 1


def test_lidar_map_keeps_the_packed_map(corridor):
    """LidarMap packs its map once at load; nn_query hands that copy to the
    wrapper."""
    pts, nrm = corridor
    from colmap_pcd_tpu_torch.models.lidar_map import LidarMap as LidarMapT

    m = LidarMapT.from_arrays(pts[:5000], nrm[:5000], device="cpu")
    assert m.d_points4.shape == (5000, 4)
    np.testing.assert_array_equal(m.d_points4[:, :3].numpy(), m.points)
    got_p, _, got_d = m.nn_query(m.points[:50] + np.float32(0.001), backend="device")
    np.testing.assert_array_equal(got_p, m.points[:50])
    assert got_d.max() < 0.01


# ---------------------------------------------------------------------------
# frustum culling and the voxel filter on tests/test_lidar.py's inputs: the
# camera at the origin looking down +z (PINHOLE 500, 640x480), its six test
# points, and its wall + ground map


def _wall_map_arrays():
    xs, ys = np.arange(-4, 4, 0.02), np.arange(-3, 3, 0.02)
    X, Y = np.meshgrid(xs, ys)
    wall = np.stack([X.ravel(), Y.ravel(), np.full(X.size, 10.0)], -1)
    GX, GZ = np.meshgrid(np.arange(-4, 4, 0.05), np.arange(1, 15, 0.05))
    ground = np.stack([GX.ravel(), np.full(GX.size, 2.0), GZ.ravel()], -1)
    nrm = np.concatenate([np.tile([0.0, 0.0, -1.0], (len(wall), 1)), np.tile([0.0, -1.0, 0.0], (len(ground), 1))])
    return np.concatenate([wall, ground]).astype(np.float32), nrm.astype(np.float32)


def test_frustum_planes_and_culling_parity():
    q, t = np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32)
    cam = (500.0, 500.0, 320.0, 240.0, 640, 480, 40.0)
    pts = np.asarray([[0.0, 0.0, 10.0], [0.0, 0.0, -5.0], [0.0, 0.0, 45.0], [50.0, 0.0, 10.0],
                      [5.0, 3.0, 10.0], [7.0, 0.0, 10.0]], np.float32)
    pl_j = np.asarray(pc_j.frustum_planes(jnp.asarray(q), jnp.asarray(t), *cam))
    pl_t = pc_t.frustum_planes(T(q), T(t), *cam)
    np.testing.assert_allclose(pl_t.numpy(), pl_j, atol=1e-6)
    np.testing.assert_allclose(np_geom.frustum_planes(q.astype(np.float64), t.astype(np.float64), *cam),
                               pl_j, atol=1e-5)
    mask = pc_t.points_in_frustum(pl_t, T(pts)).numpy()
    np.testing.assert_array_equal(mask, [True, False, False, False, True, False])
    np.testing.assert_array_equal(mask, np.asarray(pc_j.points_in_frustum(jnp.asarray(pl_j), jnp.asarray(pts))))
    # a rotated, moved camera and random points: the same masks
    rng = np.random.default_rng(7)
    q2 = np_geom.so3_exp_quat(np.asarray([0.1, -0.3, 0.05])).astype(np.float32)
    t2 = np.asarray([0.5, -0.2, 1.0], np.float32)
    rand = rng.uniform(-30, 30, (5000, 3)).astype(np.float32)
    pl_j = pc_j.frustum_planes(jnp.asarray(q2), jnp.asarray(t2), *cam)
    pl_t = pc_t.frustum_planes(T(q2), T(t2), *cam)
    m_j = np.asarray(pc_j.points_in_frustum(pl_j, jnp.asarray(rand)))
    m_t = pc_t.points_in_frustum(pl_t, T(rand)).numpy()
    assert 0 < m_t.sum() < len(rand) and (m_t != m_j).sum() == 0


def test_frustum_candidates_and_voxel_downsample_parity():
    pts, nrm = _wall_map_arrays()
    opts = pc_j.ProjOptions(submap_cell=1.0)
    mj = LidarMapJ.from_arrays(pts, nrm, opts)
    mt = convert.lidar_map_from_numpy(
        mj.points, mj.normals, mj.cell_keys, mj.cell_start, mj.cell_count, opts._asdict(), device="cpu",
    )
    params = np.asarray([500.0, 500.0, 320.0, 240.0] + [0.0] * 8, np.float32)
    for q, t, budget in ((np.array([1.0, 0, 0, 0]), np.zeros(3), None),
                         (np.array([0.995, 0.0, 0.0998, 0.0]), np.array([0.0, 0.0, 3.0]), 4096)):
        idx_t, valid_t = mt.frustum_candidates(q, t, params, PINHOLE, 640, 480, budget)
        idx_j, valid_j = mj.frustum_candidates(q, t, params, PINHOLE, 640, 480, budget)
        np.testing.assert_array_equal(idx_t, idx_j)
        np.testing.assert_array_equal(valid_t, valid_j)
        assert valid_t.sum() > 0
    for voxel in (0.5, 0.25):
        vt, nt = mt.voxel_downsample(voxel)
        vj, nj = mj.voxel_downsample(voxel)
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(nt, nj)
    # tests/test_lidar.py's bar
    assert vt.shape[0] < mt.num_points // 10 and np.isfinite(vt).all()
