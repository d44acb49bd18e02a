"""The port's dense stereo against the JAX package: `plane_sweep` (bilateral,
box and with the geometric term) and `consistency_mask` on the same numpy
inputs, `run_patch_match_stereo` + `run_stereo_fusion` through both
packages on test_dense_pipeline_and_fusion's 4-view workspace, and the
behaviours of tests/test_stereo.py on the port at their own bars (all but
the sharded test, which waits for the port's multi-device step)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_pcd_tpu.models import mvs as mvs_j
from colmap_pcd_tpu.models import reconstruction as rec_j
from colmap_pcd_tpu.ops import stereo as stereo_j
from colmap_pcd_tpu_torch.models import mvs as mvs_t
from colmap_pcd_tpu_torch.models import reconstruction as rec_t
from colmap_pcd_tpu_torch.ops import stereo as stereo_t

from test_stereo import F, H, K, W, render_plane, texture

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

# XLA on the CPU contracts a*b+c into FMAs and the port rounds every
# product, so costs differ in the last bits, and the NCC's 1 - cov/sqrt(..)
# cancels: near-tie argmins over depth flip at a few pixels. Bars: the
# depth identical at SAME_DEPTH of the pixels; where it is, the cost within
# COST_ATOL everywhere and within COST_ATOL_999 at 99.9% of them, and the
# normal within NORMAL_ATOL where the pixel and its 4 neighbours agree.
SAME_DEPTH = 0.99
COST_ATOL, COST_ATOL_999 = 5e-4, 2e-4
NORMAL_ATOL = 1e-5
# the pipeline through both packages: depth maps identical on >= 99% of
# each view's pixels, fused counts within 1%
PIPE_SAME_DEPTH, FUSED_RTOL = 0.99, 0.01


def _plane_args(centers, z0=10.0, n_depths=48):
    imgs = [render_plane(c, z0) for c in centers]
    S = len(centers) - 1
    R_rel = np.stack([np.eye(3, dtype=np.float32)] * S)
    t_rel = np.stack([-c for c in centers[1:]]).astype(np.float32)
    depths = (1.0 / np.linspace(1 / 14.0, 1 / 7.0, n_depths)).astype(np.float32)
    return (imgs[0], np.stack(imgs[1:]), K, np.stack([K] * S), R_rel, t_rel, depths)


def _two_depth_args():
    """test_plane_sweep_two_depths's scene: left half at z=8, right at 12."""
    z_l, z_r = 8.0, 12.0
    centers = [np.zeros(3), np.asarray([0.4, 0.0, 0.0]), np.asarray([0.2, 0.3, 0.0])]

    def render(c):
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        dx = (xx - W / 2) / F
        dy = (yy - H / 2) / F
        out = np.zeros((H, W), np.float32)
        for z0, mask_fn in ((z_l, lambda wx: wx < 0), (z_r, lambda wx: wx >= 0)):
            depth = z0 - c[2]
            wx = c[0] + dx * depth
            wy = c[1] + dy * depth
            m = mask_fn(wx)
            out[m] = texture(wx, wy)[m]
        return out

    imgs = [render(c) for c in centers]
    R_rel = np.stack([np.eye(3, dtype=np.float32)] * 2)
    t_rel = np.stack([-centers[1], -centers[2]]).astype(np.float32)
    depths = (1.0 / np.linspace(1 / 15.0, 1 / 6.0, 64)).astype(np.float32)
    return (imgs[0], np.stack(imgs[1:]), K, np.stack([K, K]), R_rel, t_rel, depths)


_THREE = [np.zeros(3), np.asarray([0.3, 0.0, 0.0]), np.asarray([0.0, 0.25, 0.0])]


def _sweep_t(args, opts=stereo_t.StereoOptions(), src_depths=None):
    kw = {} if src_depths is None else dict(src_depths=torch.as_tensor(src_depths), use_geom=True)
    return [a.numpy() for a in stereo_t.plane_sweep(*map(torch.as_tensor, args), opts, **kw)]


def _sweep_j(args, opts=stereo_j.StereoOptions(), src_depths=None):
    kw = {} if src_depths is None else dict(src_depths=jnp.asarray(src_depths), use_geom=True)
    return [np.asarray(a) for a in stereo_j.plane_sweep(*map(jnp.asarray, args), opts, **kw)]


def _assert_sweeps_agree(t, j):
    (dt, ct, nt), (dj, cj, nj) = t, j
    same = dt == dj
    assert same.mean() >= SAME_DEPTH, same.mean()
    err = np.abs(ct - cj)[same]
    assert err.max() <= COST_ATOL, err.max()
    assert np.percentile(err, 99.9) <= COST_ATOL_999, np.percentile(err, 99.9)
    nb = same & np.roll(same, 1, 0) & np.roll(same, -1, 0) & np.roll(same, 1, 1) & np.roll(same, -1, 1)
    np.testing.assert_allclose(nt[nb], nj[nb], atol=NORMAL_ATOL)


@pytest.mark.parametrize("case", ["bilateral", "box", "geometric", "two depths"])
def test_plane_sweep_matches_jax(case):
    if case == "two depths":
        args = _two_depth_args()
        _assert_sweeps_agree(_sweep_t(args), _sweep_j(args))
        return
    args = _plane_args(_THREE)
    sc = 0.0 if case == "box" else 0.2
    src_d = None
    if case == "geometric":
        src_d = np.stack([np.full((H, W), 10.0 - c[2], np.float32) for c in _THREE[1:]])
        src_d[1, :, : W // 3] = 0.0  # a source without depth there: the capped cost
    _assert_sweeps_agree(
        _sweep_t(args, stereo_t.StereoOptions(sigma_color=sc), src_d),
        _sweep_j(args, stereo_j.StereoOptions(sigma_color=sc), src_d),
    )


def test_plane_sweep_does_not_depend_on_the_chunk():
    """Chunks of 1 and of 7 depths give the bytes of one chunk of all 48."""
    args = _plane_args(_THREE)
    src_d = np.stack([np.full((H, W), 10.0, np.float32)] * 2)
    for kw in ({}, {"src_depths": src_d}):
        whole = _sweep_t(args, stereo_t.StereoOptions(depth_chunk=48), **kw)
        for dc in (1, 7):
            part = _sweep_t(args, stereo_t.StereoOptions(depth_chunk=dc), **kw)
            for a, b in zip(part, whole):
                np.testing.assert_array_equal(a, b)


def test_consistency_mask_matches_jax():
    rng = np.random.default_rng(4)
    centers = [np.zeros(3), *[rng.normal(size=3) * [0.3, 0.3, 0.1] for _ in range(4)]]
    depth = (10.0 + rng.normal(size=(H, W)) * 0.03).astype(np.float32)
    cost = rng.uniform(0, 1.2, (H, W)).astype(np.float32)
    others = np.stack([
        (10.0 - c[2] + rng.normal(size=(H, W)) * 0.05).astype(np.float32) for c in centers[1:]
    ])
    R = np.stack([np.eye(3, dtype=np.float32)] * 4)
    t = np.stack([-c for c in centers[1:]]).astype(np.float32)
    args = (depth, cost, others, K, R, t)
    mt = stereo_t.consistency_mask(*map(torch.as_tensor, args)).numpy()
    mj = np.asarray(stereo_j.consistency_mask(*map(jnp.asarray, args)))
    # the relative depth error is drawn continuous: a pixel on the gate's
    # float boundary has probability ~0
    assert 0.2 < mt.mean() < 0.8, mt.mean()
    np.testing.assert_array_equal(mt, mj)


def _workspaces(tmp_path, pkg):
    """test_dense_pipeline_and_fusion's 4-view workspace in one package."""
    centers = [np.asarray([0.0, 0.0, 0.0]), np.asarray([0.35, 0.0, 0.0]),
               np.asarray([0.0, 0.3, 0.0]), np.asarray([0.3, 0.3, 0.0])]
    rec = pkg.Reconstruction()
    rec.add_camera(pkg.Camera(1, 1, W, H, np.asarray([F, F, W / 2, H / 2])))
    images = {}
    for i, c in enumerate(centers, 1):
        img = pkg.Image(i, f"v{i}.png", 1, qvec=np.asarray([1.0, 0, 0, 0]), tvec=-c)
        img.xys = np.zeros((8, 2))
        rec.add_image(img)
        rec.register_image(i)
        images[i] = render_plane(c, 10.0)
    for k in range(6):
        x = np.asarray([(k % 3 - 1) * 2.0, (k // 3 - 0.5) * 1.5, 10.0])
        rec.add_point3D(x, [(1, k), (2, k), (3, k), (4, k)])
    ws = str(tmp_path / pkg.__name__.split(".")[0])
    os.makedirs(ws, exist_ok=True)
    return rec, images, ws


def _run_pipeline(tmp_path, pkg, mvs, **kw):
    rec, images, ws = _workspaces(tmp_path, pkg)
    opts = mvs.DenseOptions(max_image_size=max(H, W), num_depths=48, num_src_images=3)
    n = mvs.run_patch_match_stereo(ws, opts, rec=rec, images=images, **kw)
    pts, _, _ = mvs.run_stereo_fusion(ws, options=mvs.DenseOptions(min_consistent=2), rec=rec,
                                      images=images, **kw)
    return n, ws, pts


@pytest.fixture(scope="module")
def port_pipeline(tmp_path_factory):
    """The port's stereo (both passes) and fusion on the 4-view workspace."""
    return _run_pipeline(tmp_path_factory.mktemp("dense"), rec_t, mvs_t, device="cpu")


def test_dense_pipeline_matches_jax(tmp_path, port_pipeline):
    """Both packages' stereo (both passes) and fusion on one workspace."""
    _, ws_t, pts_t = port_pipeline
    n, ws_j, pts_j = _run_pipeline(tmp_path, rec_j, mvs_j)
    assert n == 4
    for i in range(1, 5):
        d_t = np.load(os.path.join(ws_t, "stereo", "depth_maps", f"v{i}.png.npy"))
        d_j = np.load(os.path.join(ws_j, "stereo", "depth_maps", f"v{i}.png.npy"))
        assert (d_t == d_j).mean() >= PIPE_SAME_DEPTH, (i, (d_t == d_j).mean())
    assert abs(len(pts_t) - len(pts_j)) <= FUSED_RTOL * len(pts_j), (len(pts_t), len(pts_j))


# ------------------------------------------- tests/test_stereo.py on the port
def test_plane_sweep_recovers_depth():
    z0 = 10.0
    depth, cost, normal = _sweep_t(_plane_args(_THREE), stereo_t.StereoOptions(window_radius=3))
    inner = np.zeros((H, W), bool)
    inner[10:-10, 10:-10] = True
    good = inner & (cost < 0.3)
    assert good.mean() > 0.5, good.mean()
    assert abs(np.median(depth[good]) - z0) < 0.25
    assert (np.abs(depth[good] - z0) < 0.4).mean() > 0.9
    assert np.median(normal[good][:, 2]) < -0.95


def test_plane_sweep_two_depths():
    depth, cost, _ = _sweep_t(_two_depth_args())
    good = cost < 0.3
    left = depth[20:-20, 15 : W // 2 - 15]
    right = depth[20:-20, W // 2 + 15 : -15]
    gl = good[20:-20, 15 : W // 2 - 15]
    gr = good[20:-20, W // 2 + 15 : -15]
    assert abs(np.median(left[gl]) - 8.0) < 0.4, np.median(left[gl])
    assert abs(np.median(right[gr]) - 12.0) < 0.4, np.median(right[gr])


def test_dense_pipeline_and_fusion(port_pipeline):
    n, ws, pts = port_pipeline
    assert n == 4
    assert len(pts) > 3000, len(pts)
    z_err = np.abs(pts[:, 2] - 10.0)
    assert np.median(z_err) < 0.2, np.median(z_err)
    assert (z_err < 0.5).mean() > 0.8
    assert os.path.exists(os.path.join(ws, "fused.ply"))


def test_geom_consistency_pass():
    z0 = 10.0
    args = _plane_args(_THREE)
    src_d = np.stack([np.full((H, W), z0 - c[2], np.float32) for c in _THREE[1:]])
    d2, c2, _ = _sweep_t(args, stereo_t.StereoOptions(window_radius=3), src_d)
    inner = np.zeros((H, W), bool)
    inner[10:-10, 10:-10] = True
    good = inner & (c2 < 0.3)
    assert good.mean() > 0.5
    assert abs(np.median(d2[good]) - z0) < 0.2
    assert c2.min() >= 0.0 and c2.max() <= 2.0 + 1e-5


def test_bilateral_vs_box_ncc():
    args = _plane_args(_THREE[:2])
    inner = np.zeros((H, W), bool)
    inner[10:-10, 10:-10] = True
    for sc in (0.2, 0.0):
        d, c, _ = _sweep_t(args, stereo_t.StereoOptions(sigma_color=sc))
        good = inner & (c < 0.3)
        assert good.mean() > 0.5
        assert abs(np.median(d[good]) - 10.0) < 0.2


def test_dense_stage_needs_a_device_by_name(tmp_path):
    """Without device="cpu" the dense stage computes on CUDA, so without
    CUDA it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    rec, images, ws = _workspaces(tmp_path, rec_t)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mvs_t.run_patch_match_stereo(ws, rec=rec, images=images)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mvs_t.run_stereo_fusion(ws, rec=rec, images=images)
