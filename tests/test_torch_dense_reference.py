"""The port's dense stereo against its plain reference
(benchmarks/reference/stereo.py, float64, plain PyTorch, no JAX and nothing of the port): `plane_sweep` in
both passes and `consistency_mask` on seeded random textures, the
whole dense stage on a 4-view corridor, and the stage's repairs at
COLMAP's widths: `resize_max` at -1, the options passed through and the
first pass's maps kept.

Tolerances. The port sums in float32, the reference in float64: the
cost's windowed sums (121 taps of w x^2 before the variance's E[x^2] -
E[x]^2 cancels) leave the port ~2e-6 from the reference at a typical
pixel and up to ~2e-5 at low-variance windows (8 seeded cases: medians
1.8-2.0e-6, 99th percentiles 0.96-1.15e-5, maxima 1.5-2.2e-5), so the
cost is held within COST_ATOL_95 at 95% of the pixels and within
COST_ATOL at every one. Where the
reference's two least costs lie within TIE of each other the first argmin
may fall on either, so a plane is held only at untied pixels, and at
SAME_PLANE of them. Fusion's test is held equal wherever the reference's
pixel lies further than TIE from one of its decision boundaries (a
rounding, the view's border, a gate). The whole stage is held to the
reference's fused count within FUSED_RTOL.
"""

import os

import numpy as np
import pytest
import torch

from benchmarks.reference import stereo as reference
from colmap_pcd_tpu_torch.models import mvs
from colmap_pcd_tpu_torch.models.reconstruction import Camera, Image, Reconstruction
from colmap_pcd_tpu_torch.ops import stereo
from colmap_pcd_tpu_torch.utils import image as image_utils
from render_torch import render_corridor
from synthetic_torch import make_trajectory

torch.set_num_threads(2)  # tier-1 runs several workers on few cores

TIE = 1e-4
SAME_PLANE = 0.99
COST_ATOL, COST_ATOL_95 = 5e-5, 1e-5
FUSED_RTOL = 0.01
R5 = 5  # COLMAP's window radius: 121 taps
FIXED = stereo.StereoOptions()  # the widths DenseOptions does not carry

H, W, F = 48, 64, 60.0
K = np.asarray([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)
BANK = (1.0 / np.linspace(1 / 8.0, 1 / 3.0, 16)).astype(np.float32)


def _rot_y(a):
    return np.asarray([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])


def _render(R, t, lattice):
    """A view of two fronto-parallel planes (z = 4 left of x = 0, z = 6
    right of it) carrying a random lattice texture of 4 cm cells, bilinear:
    (image [H,W] f32, depth [H,W] f32)."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    d = np.stack([(xx - W / 2) / F, (yy - H / 2) / F, np.ones_like(xx)], -1) @ R  # R^T d
    C = -R.T @ t
    best = np.full((H, W), np.inf)
    pt = np.zeros((H, W, 3))
    for z0, side in ((4.0, -1), (6.0, 1)):
        s = (z0 - C[2]) / d[..., 2]
        p = C + s[..., None] * d
        ok = (side * p[..., 0] >= 0) & (s < best)
        best = np.where(ok, s, best)
        pt = np.where(ok[..., None], p, pt)
    u, v = pt[..., 0] / 0.04 + 200, pt[..., 1] / 0.04 + 200
    u0, v0 = np.floor(u).astype(int), np.floor(v).astype(int)
    fu, fv = u - u0, v - v0
    img = (lattice[v0, u0] * (1 - fu) * (1 - fv) + lattice[v0, u0 + 1] * fu * (1 - fv)
           + lattice[v0 + 1, u0] * (1 - fu) * fv + lattice[v0 + 1, u0 + 1] * fu * fv)
    depth = ((pt - C) @ R.T)[..., 2]
    return img.astype(np.float32), depth.astype(np.float32)


def _scene(seed):
    """Three views (the first the reference, at the origin) of the two
    planes under a seeded texture, and the sweep's inputs."""
    rng = np.random.default_rng(seed)
    lattice = rng.uniform(0.0, 1.0, (400, 400))
    poses = [(np.eye(3), np.zeros(3)),
             (_rot_y(0.02), np.asarray([-0.3, 0.05, 0.0])),
             (_rot_y(-0.015), np.asarray([0.1, -0.25, 0.05]))]
    views = [_render(R, t, lattice) for R, t in poses]
    R_rel = np.stack([R for R, _ in poses[1:]]).astype(np.float32)
    t_rel = np.stack([t for _, t in poses[1:]]).astype(np.float32)
    args = (views[0][0], np.stack([v[0] for v in views[1:]]), K, np.stack([K, K]), R_rel, t_rel, BANK)
    return args, np.stack([v[1] for v in views[1:]])


def _whole(args, src_depths=None, **kw):
    """The reference's total and photometric costs of every pixel [H*W, D]."""
    ys, xs = np.mgrid[0:H, 0:W].reshape(2, -1)
    return reference.plane_costs(*args, xs, ys, window_radius=R5, src_depths=src_depths, **kw)


@pytest.mark.parametrize("case", ["photometric", "geometric"])
@pytest.mark.parametrize("seed", [11, 12])
def test_plane_sweep_matches_reference(case, seed):
    args, true_depth = _scene(seed)
    src_d = None
    if case == "geometric":
        rng = np.random.default_rng(seed + 100)
        src_d = (true_depth * (1 + 0.01 * rng.standard_normal(true_depth.shape))).astype(np.float32)
        src_d[1, :, : W // 3] = 0.0  # a source without depth there: the capped cost
    kw = {} if src_d is None else dict(src_depths=torch.as_tensor(src_d), use_geom=True)
    depth, cost, _ = stereo.plane_sweep(*map(torch.as_tensor, args), stereo.StereoOptions(window_radius=R5), **kw)
    total, photo = _whole(args, src_d)
    plane, gap = reference.best_plane(total)
    chosen = np.argmin(np.abs(depth.numpy().reshape(-1, 1) - BANK[None]), 1)
    held = gap.numpy() > TIE
    same = held & (chosen == plane.numpy())
    assert held.mean() > 0.9, held.mean()
    assert same.sum() >= SAME_PLANE * held.sum(), (same.sum(), held.sum())
    ref_cost = photo.numpy()[np.arange(H * W), chosen]
    err = np.abs(cost.numpy().reshape(-1) - ref_cost)[same]
    assert err.max() <= COST_ATOL, err.max()
    assert np.percentile(err, 95) <= COST_ATOL_95, np.percentile(err, 95)
    # the planes recover the scene where the texture is seen by both sources
    good = same & (ref_cost < 0.5)
    truth = _render(np.eye(3), np.zeros(3), np.random.default_rng(seed).uniform(0.0, 1.0, (400, 400)))[1]
    rel = np.abs(depth.numpy().reshape(-1) - truth.reshape(-1)) / truth.reshape(-1)
    assert np.median(rel[good]) < 0.05, np.median(rel[good])


def test_lower_precision_misses_the_reference():
    """The reference computed in float16 (the precision below the port's
    float32) chooses other planes at many untied pixels: the comparison can
    tell a lower precision apart."""
    args, _ = _scene(11)
    total, _ = _whole(args)
    half, _ = _whole(args, dtype=torch.float16)
    plane, gap = reference.best_plane(total)
    held = gap > TIE
    wrong = (torch.argmin(half, 1) != plane) & held
    assert wrong.sum() > 0.05 * held.sum(), (int(wrong.sum()), int(held.sum()))


def test_consistency_mask_matches_reference():
    rng = np.random.default_rng(4)
    centers = [rng.normal(size=3) * [0.3, 0.3, 0.1] for _ in range(4)]
    depth = (5.0 + rng.normal(size=(H, W)) * 0.03).astype(np.float32)
    cost = rng.uniform(0, 1.2, (H, W)).astype(np.float32)
    # the other views' depths spread over the relative gate (max_depth_error * 10 = 10%) on both sides
    others = np.stack([(5.0 - c[2] + rng.normal(size=(H, W)) * 0.4).astype(np.float32) for c in centers])
    R = np.stack([_rot_y(0.01 * k) for k in range(4)]).astype(np.float32)
    t = np.stack([-c for c in centers]).astype(np.float32)
    opts = stereo.StereoOptions()
    port = stereo.consistency_mask(*map(torch.as_tensor, (depth, cost, others, K, R, t)), opts).numpy()
    mask, margin = reference.consistency_mask(depth, cost, others, K, R, t, min_consistent=opts.min_consistent,
                                              max_depth_error=opts.max_depth_error, min_ncc=opts.min_ncc)
    decided = margin.numpy() > TIE
    assert 0.2 < port.mean() < 0.8 and decided.mean() > 0.99, (port.mean(), decided.mean())
    np.testing.assert_array_equal(port[decided], mask.numpy()[decided])


@pytest.mark.parametrize("max_size", [-1, 0])
def test_resize_max_keeps_the_view_whole(max_size):
    img = np.random.default_rng(0).uniform(0, 1, (960, 1280)).astype(np.float32)
    out, scale = image_utils.resize_max(img, max_size)
    assert out is img and scale == 1.0


# ------------------------------------------------- the dense stage, whole
CW, CH, CF = 160, 120, 125.0


def _corridor(tmp_path):
    """4 views of the corridor at 160x120 (uint8, as a PNG holds them) with
    their true poses, and sparse points on its walls and ground seen by
    every view."""
    gt = make_trajectory(4)
    rec = Reconstruction()
    rec.add_camera(Camera(1, 1, CW, CH, np.asarray([CF, CF, CW / 2, CH / 2])))
    images = {}
    for i, (q, t) in enumerate(gt, 1):
        img = Image(i, f"v{i}.png", 1, qvec=np.asarray(q, np.float64), tvec=np.asarray(t, np.float64))
        img.xys = np.zeros((12, 2))
        rec.add_image(img)
        rec.register_image(i)
        images[i] = np.floor(render_corridor(q, t, CW, CH, CF) * 255).astype(np.float32) / 255
    for k in range(12):
        z = 6.0 + 1.5 * k
        x = [-4.0, 4.0, (k % 5 - 2) * 1.2][k % 3]
        y = [0.5 * (k % 4 - 1.5), 0.5 * (k % 4 - 1.5), 2.0][k % 3]
        rec.add_point3D(np.asarray([x, y, z]), [(i, k) for i in range(1, 5)])
    ws = str(tmp_path / "dense")
    os.makedirs(ws)
    return rec, images, ws


def _reference_stage(rec, images, opts: mvs.DenseOptions) -> int:
    """The reference's fused count: both passes over every pixel of every
    view (sources: every other view; the bank from the sparse points as the
    stage sets it), then fusion's test of each view against the other
    views' final maps."""
    ids = list(rec.registered_ids)
    Kc = np.asarray([[CF, 0, CW / 2], [0, CF, CH / 2], [0, 0, 1.0]])
    Rs = {i: _rotmat(rec.images[i].qvec) for i in ids}
    ts = {i: np.asarray(rec.images[i].tvec, np.float64) for i in ids}
    pts = np.stack([p.xyz for p in rec.points3D.values()])

    def rel(a, b):  # points of camera a to camera b
        Rr = Rs[b] @ Rs[a].T
        return Rr, ts[b] - Rr @ ts[a]

    def view_maps(i, src_depths=None):
        z = (pts @ Rs[i].T + ts[i])[:, 2]
        bank = 1.0 / np.linspace(1 / (np.percentile(z, 98) * 1.25), 1 / (np.percentile(z, 2) * 0.8), opts.num_depths)
        srcs = [j for j in ids if j != i]
        R_rel, t_rel = zip(*(rel(i, j) for j in srcs))
        ys, xs = np.mgrid[0:CH, 0:CW].reshape(2, -1)
        depth, cost = np.empty(CH * CW), np.empty(CH * CW)
        for c in range(0, CH * CW, 2400):
            total, photo = reference.plane_costs(
                images[i], np.stack([images[j] for j in srcs]), Kc, np.stack([Kc] * len(srcs)), np.stack(R_rel),
                np.stack(t_rel), bank, xs[c : c + 2400], ys[c : c + 2400], window_radius=opts.window_radius,
                src_depths=None if src_depths is None else np.stack([src_depths[j] for j in srcs]))
            plane = reference.best_plane(total)[0]
            depth[c : c + 2400] = bank[plane.numpy()]
            cost[c : c + 2400] = photo[torch.arange(len(plane)), plane].numpy()
        return depth.reshape(CH, CW), cost.reshape(CH, CW)

    photometric = {i: view_maps(i)[0] for i in ids}
    final = {i: view_maps(i, photometric) for i in ids}
    fused = 0
    for i in ids:
        others = [j for j in ids if j != i][:4]
        R_o, t_o = zip(*(rel(i, j) for j in others))
        mask, _ = reference.consistency_mask(
            final[i][0], final[i][1], np.stack([final[j][0] for j in others]), Kc, np.stack(R_o), np.stack(t_o),
            min_consistent=opts.min_consistent, max_depth_error=FIXED.max_depth_error, min_ncc=FIXED.min_ncc)
        fused += int(mask.sum())
    return fused


def _rotmat(q):
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.asarray([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                       [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                       [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


@pytest.fixture(scope="module")
def corridor_stage(tmp_path_factory):
    """The port's stage on the corridor at COLMAP's widths (the whole view,
    r = 5, every covisible source), 16 depths."""
    rec, images, ws = _corridor(tmp_path_factory.mktemp("corridor"))
    opts = mvs.DenseOptions(max_image_size=-1, window_radius=R5, num_src_images=20, num_depths=16)
    n = mvs.run_patch_match_stereo(ws, opts, rec=rec, images=images, device="cpu")
    pts, _, _ = mvs.run_stereo_fusion(ws, options=opts, rec=rec, images=images, device="cpu")
    return rec, images, ws, opts, n, pts


def test_dense_stage_matches_reference(corridor_stage):
    rec, images, _, opts, n, pts = corridor_stage
    assert n == 4 and len(pts) > 2000
    expected = _reference_stage(rec, images, opts)
    assert abs(len(pts) - expected) <= FUSED_RTOL * expected, (len(pts), expected)


def test_first_pass_maps_are_kept(corridor_stage, tmp_path):
    """Beside each view's final maps the stage keeps its first pass's as
    <name>.photometric.npy: the maps of a run without the second pass."""
    rec, images, ws, opts, _, _ = corridor_stage
    one_pass = str(tmp_path / "one")
    os.makedirs(one_pass)
    single = mvs.DenseOptions(**{**opts.__dict__, "geom_consistency": False})
    mvs.run_patch_match_stereo(one_pass, single, rec=rec, images=images, device="cpu")
    for i in rec.registered_ids:
        for kind in ("depth_maps", "normal_maps", "cost_maps"):
            kept = np.load(os.path.join(ws, "stereo", kind, f"v{i}.png.photometric.npy"))
            np.testing.assert_array_equal(kept, np.load(os.path.join(one_pass, "stereo", kind, f"v{i}.png.npy")))
            np.testing.assert_array_equal(
                kept, np.load(os.path.join(one_pass, "stereo", kind, f"v{i}.png.photometric.npy")))
        final = np.load(os.path.join(ws, "stereo", "depth_maps", f"v{i}.png.npy"))
        assert not np.array_equal(final, np.load(os.path.join(ws, "stereo", "depth_maps", f"v{i}.png.photometric.npy")))


def test_options_reach_the_sweep_and_fusion(monkeypatch, tmp_path):
    """DenseOptions' widths arrive in the StereoOptions of both passes'
    sweeps and of fusion; the rest are StereoOptions' own (the JAX
    package's parity holds on them)."""
    rec, images, ws = _corridor(tmp_path)
    seen = []
    sweep, mask = stereo.plane_sweep, stereo.consistency_mask

    def sweep_seen(*args, **kw):
        seen.append(("sweep", args[7]))
        return sweep(*args, **kw)

    def mask_seen(*args):
        seen.append(("mask", args[6]))
        return mask(*args)

    monkeypatch.setattr(stereo, "plane_sweep", sweep_seen)
    monkeypatch.setattr(stereo, "consistency_mask", mask_seen)
    opts = mvs.DenseOptions(max_image_size=80, num_depths=4, window_radius=2, sigma_color=0.3, sigma_spatial=4.0,
                            min_consistent=1)
    mvs.run_patch_match_stereo(ws, opts, rec=rec, images=images, device="cpu")
    mvs.run_stereo_fusion(ws, options=opts, rec=rec, images=images, device="cpu")
    sweeps = [o for kind, o in seen if kind == "sweep"]
    masks = [o for kind, o in seen if kind == "mask"]
    assert len(sweeps) == 8 and len(masks) == 4
    for o in sweeps:
        assert o == FIXED._replace(num_depths=4, window_radius=2, sigma_color=0.3, sigma_spatial=4.0, min_consistent=1)
    for o in masks:
        assert o == FIXED._replace(min_consistent=1)
