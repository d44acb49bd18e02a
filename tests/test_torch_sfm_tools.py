"""The port's SfM-tool modules held to the JAX package on the CPU: the PCG
camera tier of ops/ba.py, ops/ransac.ransac_similarity, ops/lad.py,
models/undistortion.py, models/coordinate_frame.detect_line_segments, and
the carried host modules (scene clustering, model tools, interchange
formats, the HTML viewer). Both packages get the same numpy inputs from a
seed; each test states its tolerance."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_pcd_tpu.io import model_formats as formats_j
from colmap_pcd_tpu.io import viewer as viewer_j
from colmap_pcd_tpu.models import coordinate_frame as cf_j
from colmap_pcd_tpu.models import model_tools as tools_j
from colmap_pcd_tpu.models import undistortion as und_j
from colmap_pcd_tpu.models.reconstruction import Camera as CameraJ
from colmap_pcd_tpu.models.reconstruction import Image as ImageJ
from colmap_pcd_tpu.models.reconstruction import Reconstruction as ReconstructionJ
from colmap_pcd_tpu.ops import ba as ba_j
from colmap_pcd_tpu.ops import lad as lad_j
from colmap_pcd_tpu.ops import ransac as ransac_j
from colmap_pcd_tpu.ops import solvers as solvers_j
from colmap_pcd_tpu_torch import convert
from colmap_pcd_tpu_torch.io import model_formats as formats_t
from colmap_pcd_tpu_torch.io import viewer as viewer_t
from colmap_pcd_tpu_torch.models import coordinate_frame as cf_t
from colmap_pcd_tpu_torch.models import model_tools as tools_t
from colmap_pcd_tpu_torch.models import undistortion as und_t
from colmap_pcd_tpu_torch.models.reconstruction import Camera as CameraT
from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction as ReconstructionT
from colmap_pcd_tpu_torch.ops import ba as ba_t
from colmap_pcd_tpu_torch.ops import lad as lad_t
from colmap_pcd_tpu_torch.ops import np_geom
from colmap_pcd_tpu_torch.ops import ransac as ransac_t
from colmap_pcd_tpu_torch.ops import solvers as solvers_t

from test_ba_pcg import _perturbed

torch.set_num_threads(1)  # the suite runs several workers on few cores


# --------------------------------------------------------------- PCG tier
@pytest.mark.parametrize("intrinsics", [False, True])
def test_pcg_matches_dense_and_jax(intrinsics):
    """test_ba_pcg.py's problems (30 cameras; 16 cameras refining the
    focal length): the port's PCG tier against its dense tier and against
    the JAX PCG. Both final costs < 1e-2 (noiseless observations) and the
    translations within 5e-3 of each other and of the truth."""
    kw = dict(n_cams=16, n_pts=200) if intrinsics else {}
    cfg_kw = dict(point_chunk=64, refine_intrinsics=True) if intrinsics else dict(point_chunk=128)
    pj, _, ts, _ = _perturbed(np.random.default_rng(0), **kw)
    pt = convert.ba_problem_from_numpy(device="cpu", **{k: np.asarray(v) for k, v in pj._asdict().items()})
    cfg = {tier: ba_j.BAConfig(model_id=1, max_iterations=25, camera_solver=tier, **cfg_kw)
           for tier in ("dense", "pcg")}
    dense_t = ba_t.solve(pt, ba_t.BAConfig(**cfg["dense"]._asdict()))
    pcg_t = ba_t.solve(pt, ba_t.BAConfig(**cfg["pcg"]._asdict()))
    pcg_j = ba_j.solve(pj, cfg["pcg"])
    for res in (dense_t, pcg_t, pcg_j):
        assert float(res.final_cost) < 1e-2, float(res.final_cost)
    t_pcg = pcg_t.cam_t.numpy()
    assert np.abs(t_pcg - dense_t.cam_t.numpy()).max() < 5e-3
    assert np.abs(t_pcg - np.asarray(pcg_j.cam_t)).max() < 5e-3
    assert np.abs(t_pcg - ts).max() < 5e-3
    # the CG blocks' host reads are counted with the LM loop's
    assert pcg_t.host_syncs > pcg_t.iterations and dense_t.host_syncs == dense_t.iterations


def test_pcg_auto_tier_above_dense_max():
    """"auto" picks the PCG tier above dense_max_pose_blocks 6-blocks, as
    the JAX package does (ops/ba.py:504-506)."""
    pj, _, _, _ = _perturbed(np.random.default_rng(1), n_cams=12, n_pts=60)
    pt = convert.ba_problem_from_numpy(device="cpu", **{k: np.asarray(v) for k, v in pj._asdict().items()})
    assert not ba_t.uses_pcg(pt, ba_t.BAConfig())
    assert ba_t.uses_pcg(pt, ba_t.BAConfig(dense_max_pose_blocks=11))
    assert not ba_t.uses_pcg(pt, ba_t.BAConfig(dense_max_pose_blocks=12))
    assert not ba_t.uses_pcg(pt, ba_t.BAConfig(camera_solver="dense", dense_max_pose_blocks=1))


# -------------------------------------------------------- similarity RANSAC
def _sim3_world(rng, n=40, outlier_share=0.2):
    src = rng.normal(size=(n, 3)) * 3
    q = np_geom.so3_exp_quat(rng.normal(size=3) * 0.5)
    s, t = 1.7, np.asarray([1.0, -2.0, 0.5])
    dst = s * src @ np_geom.quat_to_rotmat(q).T + t
    bad = rng.permutation(n)[: int(round(outlier_share * n))]
    dst[bad] += rng.normal(size=(bad.size, 3)) * 5
    return src.astype(np.float32), dst.astype(np.float32), bad


def test_umeyama_bank_on_shared_samples():
    """The minimal-3 Umeyama bank on JAX's `_draw_samples` indices, on every
    sample of three distinct, well-spread points (a repeated index leaves
    the rotation undetermined): q and s within 1e-5, t within 1e-5 of the
    largest translation (f32 t = mu_d - s R mu_s, |t| up to ~13 m)."""
    src, dst, _ = _sim3_world(np.random.default_rng(2))
    idx = np.asarray(ransac_j._draw_samples(jax.random.PRNGKey(0), jnp.ones(40), 256, 3))
    qj, tj, sj = (np.asarray(a) for a in jax.vmap(
        lambda ii: solvers_j.umeyama(jnp.asarray(src)[ii], jnp.asarray(dst)[ii], with_scale=True))(idx))
    qt, tt, st = (a.numpy() for a in solvers_t.umeyama(
        torch.from_numpy(src)[idx], torch.from_numpy(dst)[idx], with_scale=True))
    tri = src[idx]
    area = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1)
    good = (area > 1.0)
    assert good.sum() > 200
    assert np.abs(qt - qj)[good].max() < 1e-5
    assert np.abs(st - sj)[good].max() < 1e-5
    assert np.abs(tt - tj)[good].max() < 1e-5 * np.abs(tj).max()


def test_ransac_similarity_outcome_matches_jax():
    """40 correspondences with 20% gross outliers: the same inlier mask
    and (q, t, s) within 1e-4, both with the bank on JAX's sample indices
    and with each package's own draw (torch.Generator vs jax.random)."""
    src, dst, bad = _sim3_world(np.random.default_rng(3))
    opts_j = ransac_j.RansacOptions(max_error=0.05, num_hypotheses=1024)
    opts_t = ransac_t.RansacOptions(**opts_j._asdict())
    key = jax.random.PRNGKey(0)
    rj = ransac_j.ransac_similarity(jnp.asarray(src), jnp.asarray(dst), jnp.ones(40), key, opts_j)
    idx = torch.as_tensor(np.asarray(ransac_j._draw_samples(key, jnp.ones(40), 1024, 3)))
    args = (torch.as_tensor(src), torch.as_tensor(dst), torch.ones(40))
    shared = ransac_t.ransac_similarity(*args, None, opts_t, sample_idx=idx)
    own = ransac_t.ransac_similarity(*args, torch.Generator().manual_seed(0), opts_t)
    mask_j = np.asarray(rj.inlier_mask)
    assert mask_j.sum() == 40 - bad.size and not mask_j[bad].any()
    for rt in (shared, own):
        np.testing.assert_array_equal(rt.inlier_mask.numpy(), mask_j)
        assert int(rt.num_inliers) == int(rj.num_inliers)
        np.testing.assert_allclose(rt.q.numpy(), np.asarray(rj.q), atol=1e-4)
        np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-4)
        np.testing.assert_allclose(float(rt.s), float(rj.s), atol=1e-4)


# --------------------------------------------------------------------- LAD
def test_lad_matches_jax():
    """test_coordinate_frame.py's line fit with 30% gross outliers: the
    solutions agree within 1e-4 relative to |x|, and the L1 fit recovers
    the line as there."""
    rng = np.random.default_rng(0)
    n = 200
    x = rng.uniform(-5, 5, n)
    y = 2.0 * x + 1.0
    y = np.where(rng.random(n) < 0.3, y + rng.uniform(20, 50, n), y)
    A = np.stack([x, np.ones(n)], 1)
    sol_j = np.asarray(lad_j.solve_least_absolute_deviations(A, y, opts=lad_j.LADOptions(max_num_iterations=500)))
    sol_t = lad_t.solve_least_absolute_deviations(
        A, y, opts=lad_t.LADOptions(max_num_iterations=500), device="cpu").numpy()
    assert np.abs(sol_t - sol_j).max() < 1e-4 * np.linalg.norm(sol_j)
    assert abs(sol_t[0] - 2.0) < 0.05 and abs(sol_t[1] - 1.0) < 0.15


# ------------------------------------------------------------ undistortion
def test_undistort_image_matches_jax():
    """An OPENCV camera with k1 = -0.1 on a 64x48 RGB gradient with noise:
    the warp agrees within 1e-3 before the uint8 cast; the uint8 images
    agree within 1 everywhere and are equal on >= 99.9% of the pixels."""
    rng = np.random.default_rng(4)
    img = np.clip(np.linspace(0, 255, 64 * 48 * 3).reshape(48, 64, 3) + rng.normal(0, 20, (48, 64, 3)),
                  0, 255).astype(np.uint8)
    params = np.asarray([50.0, 52.0, 32.0, 24.0, -0.1, 0.01, 0.001, -0.002])
    cam_j, cam_t = CameraJ(1, 4, 64, 48, params), CameraT(1, 4, 64, 48, params)
    new_j, new_t = und_j.undistorted_camera(cam_j), und_t.undistorted_camera(cam_t)
    np.testing.assert_array_equal(new_t.params, new_j.params)
    warp_j = np.asarray(und_j._warp(jnp.asarray(img), jnp.asarray(cam_j.padded_params()),
                                    jnp.asarray(new_j.padded_params()), 4, 64, 48))
    warp_t = und_t._warp(torch.as_tensor(img), torch.as_tensor(cam_t.padded_params()),
                         torch.as_tensor(new_t.padded_params()), 4, 64, 48).numpy()
    assert np.abs(warp_t - warp_j).max() < 1e-3
    out_j = und_j.undistort_image(img, cam_j, new_j)
    out_t = und_t.undistort_image(img, cam_t, new_t, "cpu")
    diff = np.abs(out_t.astype(int) - out_j.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    # a grayscale float image keeps its layout and type
    gray = img[..., 0].astype(np.float32) / 255.0
    g_t = und_t.undistort_image(gray, cam_t, new_t, "cpu")
    assert g_t.shape == gray.shape and g_t.dtype == np.float32
    np.testing.assert_allclose(g_t, und_j.undistort_image(gray, cam_j, new_j), atol=1e-5)


def test_rectify_stereo_matches_jax():
    """rectify_stereo_cameras: H1, H2 within 1e-5 (host numpy in both); the
    rectified uint8 pair within 1 grey level on >= 99.9% of the pixels."""
    rng = np.random.default_rng(5)
    params = np.asarray([500.0, 500.0, 320.0, 240.0])
    w = np.asarray([0.02, -0.03, 0.01])
    q = np.concatenate([[np.cos(np.linalg.norm(w) / 2)], w / np.linalg.norm(w) * np.sin(np.linalg.norm(w) / 2)])
    t = np.asarray([1.0, 0.05, -0.02])
    hj = und_j.rectify_stereo_cameras(CameraJ(1, 1, 640, 480, params), CameraJ(1, 1, 640, 480, params), q, t)
    ht = und_t.rectify_stereo_cameras(CameraT(1, 1, 640, 480, params), CameraT(1, 1, 640, 480, params), q, t)
    for a, b in zip(ht, hj):
        np.testing.assert_allclose(a, b, atol=1e-5)

    dist = np.asarray([50.0, 50.0, 32.0, 24.0, -0.05, 0.0, 0.0, 0.0])
    img = (rng.uniform(0, 255, size=(48, 64, 3))).astype(np.uint8)
    H_inv = np.linalg.inv(hj[0] @ np.diag([0.1, 0.1, 1.0]))
    cam_j, cam_t = CameraJ(1, 4, 64, 48, dist), CameraT(1, 4, 64, 48, dist)
    rj = und_j._warp_homography_from_distorted(img, H_inv, cam_j, und_j.undistorted_camera(cam_j))
    rt = und_t._warp_homography_from_distorted(img, H_inv, cam_t, und_t.undistorted_camera(cam_t), "cpu")
    diff = np.abs(rt.astype(int) - rj.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


# ---------------------------------------------------------- line segments
def _line_image():
    img = np.zeros((120, 160), np.float32)
    img[40, 20:140] = 1.0   # horizontal line
    img[10:110, 80] = 1.0   # vertical line
    return img


def test_detect_line_segments_matches_jax():
    """test_detect_line_segments_synthetic's image: the same number of
    segments, endpoints within 0.5 px (segments paired in the order of
    their peaks, which both take by score and then index), and the same
    orientation classes."""
    img = _line_image()
    segs_j, n_j = cf_j.detect_line_segments(img, min_length=20)
    segs_t, n_t = cf_t.detect_line_segments(img, min_length=20, device="cpu")
    assert n_t == n_j >= 2
    assert np.abs(segs_t - segs_j).max() < 0.5
    np.testing.assert_array_equal(cf_t.classify_line_orientations(segs_t), cf_j.classify_line_orientations(segs_j))
    h = segs_t[cf_t.classify_line_orientations(segs_t) == 1][0]
    assert abs(h[1] - 40) < 3 and abs(h[3] - 40) < 3


def test_detect_line_segments_flat_regions():
    """A box with flat regions (many equal edge magnitudes and equal Hough
    votes): ties go by index in both, so the same segments come out."""
    img = np.zeros((64, 80), np.float32)
    img[16:48, 20:60] = 1.0
    segs_j, n_j = cf_j.detect_line_segments(img, min_length=8)
    segs_t, n_t = cf_t.detect_line_segments(img, min_length=8, device="cpu")
    assert n_t == n_j >= 4
    assert np.abs(segs_t - segs_j).max() < 0.5


# ------------------------------------------------------------ host modules
def _toy_model(Camera, Image, Reconstruction, seed=0, n_images=6, n_points=30):
    """A registered model with colours, built the same way in either
    package from one seed."""
    rng = np.random.default_rng(seed)
    rec = Reconstruction()
    rec.add_camera(Camera(1, 2, 640, 480, np.asarray([500.0, 320.0, 240.0, -0.01])))
    pts = rng.normal(size=(n_points, 3)) + [0, 0, 6.0]
    for i in range(1, n_images + 1):
        w = rng.normal(size=3) * 0.02
        q = np.concatenate([[np.cos(np.linalg.norm(w) / 2)], w / np.linalg.norm(w) * np.sin(np.linalg.norm(w) / 2)])
        rec.add_image(Image(i, f"im{i:02d}.png", 1, qvec=q, tvec=np.asarray([0.2 * i, 0.01 * i, 0.0]),
                            xys=rng.uniform(10, 400, size=(n_points, 2))))
        rec.register_image(i)
    for k in range(n_points):
        pid = rec.add_point3D(pts[k], [(i, k) for i in range(1, n_images + 1)])
        rec.points3D[pid].color = rng.integers(0, 255, 3).astype(np.uint8)
    return rec


def _both_models():
    from colmap_pcd_tpu_torch.models.reconstruction import Image as ImageT

    return (_toy_model(CameraJ, ImageJ, ReconstructionJ), _toy_model(CameraT, ImageT, ReconstructionT))


def _same_tree(a, b):
    """Every file under a equals its counterpart under b, byte for byte."""
    fa = sorted(os.path.relpath(os.path.join(r, f), a) for r, _, fs in os.walk(a) for f in fs)
    fb = sorted(os.path.relpath(os.path.join(r, f), b) for r, _, fs in os.walk(b) for f in fs)
    assert fa == fb and fa
    for f in fa:
        with open(os.path.join(a, f), "rb") as x, open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f


def test_model_formats_byte_identical(tmp_path):
    """NVM, Bundler, CAM and VRML exports of one model, and the NVM import
    written back as a COLMAP model: byte-identical files."""
    for tag, (fm, rec) in zip("jt", zip((formats_j, formats_t), _both_models())):
        d = tmp_path / tag
        d.mkdir()
        assert fm.export_nvm(rec, str(d / "m.nvm"))
        assert fm.export_bundler(rec, str(d / "b.bundle.out"), str(d / "b.list.txt"))
        assert fm.export_cam(rec, str(d / "cams"))
        fm.export_vrml(rec, str(d / "v.images.wrl"), str(d / "v.points3D.wrl"))
        fm.import_nvm(str(d / "m.nvm")).write(str(d / "from_nvm"))
    _same_tree(str(tmp_path / "j"), str(tmp_path / "t"))


def test_viewer_byte_identical(tmp_path):
    rng = np.random.default_rng(6)
    lidar = rng.normal(size=(500, 3)).astype(np.float32)
    for tag, (vw, rec) in zip("jt", zip((viewer_j, viewer_t), _both_models())):
        (tmp_path / tag).mkdir()
        vw.export_viewer_html(rec, str(tmp_path / tag / "v.html"), lidar_pts=lidar, max_lidar_points=300)
    _same_tree(str(tmp_path / "j"), str(tmp_path / "t"))


def test_model_tools_byte_identical(tmp_path):
    """crop, split, principal axes and normalize write byte-identical
    models; merge and compare (each through an f32 Umeyama on its own
    device) agree within 1e-5 m and the same image and point counts."""
    rec_j, rec_t = _both_models()
    for tag, tools, rec in (("j", tools_j, rec_j), ("t", tools_t, rec_t)):
        d = tmp_path / tag
        lo, hi = rec.compute_bounding_box()
        tools.crop_model(rec, lo, (np.asarray(lo) + np.asarray(hi)) / 2).write(str(d / "crop"))
        for k, part in enumerate(tools.split_model(rec, 2, axis=2, overlap=0.3)):
            part.write(str(d / "split" / str(k)))
        tools.align_to_principal_axes(rec).write(str(d / "principal"))
        tools.normalize_model(rec, extent=10.0).write(str(d / "normalized"))
    _same_tree(str(tmp_path / "j"), str(tmp_path / "t"))

    def moved(rec):
        out = copy.deepcopy(rec)
        out.transform(np_geom.so3_exp_quat([0.1, -0.2, 0.05]), np.asarray([1.0, 2, 3]), 1.7)
        out.deregister_image(1)
        return out

    stats_j = tools_j.compare_models(rec_j, moved(rec_j))
    stats_t = tools_t.compare_models(rec_t, moved(rec_t), device="cpu")
    assert stats_t.keys() == stats_j.keys() and stats_t["num_common_images"] == 5
    for k in stats_j:
        assert abs(stats_t[k] - stats_j[k]) < 1e-5, k
    half_j, half_t = copy.deepcopy(rec_j), copy.deepcopy(rec_t)
    for half in (half_j, half_t):
        half.deregister_image(6)
    m_j = tools_j.merge_models(half_j, moved(rec_j))
    m_t = tools_t.merge_models(half_t, moved(rec_t), device="cpu")
    assert m_t.num_reg_images == m_j.num_reg_images == 6
    assert len(m_t.points3D) == len(m_j.points3D)
    for iid in m_j.registered_ids:
        np.testing.assert_allclose(m_t.images[iid].projection_center(), m_j.images[iid].projection_center(),
                                   atol=1e-5)


def test_corridor_problem_matches_jax_and_solves():
    """synthetic_torch.corridor_ba_problem (the corridor chip_smoke.py
    solves at 2000 cameras) equals test_ba_pcg.py's for one seed, and at 60
    cameras "auto" takes the PCG tier above dense_max_pose_blocks and
    converges as the slow JAX test demands: cost < 1% of the initial and
    every camera within 0.1 m of the truth."""
    import synthetic_torch
    from test_ba_pcg import _corridor_problem

    for a, b in zip(synthetic_torch.corridor_ba_problem(np.random.default_rng(0), 60),
                    _corridor_problem(np.random.default_rng(0), 60)):
        np.testing.assert_array_equal(a, np.asarray(b))
    rng = np.random.default_rng(1)
    qs, ts, intr, pts, oc, op, ouv = synthetic_torch.corridor_ba_problem(rng, 60)
    ts_n = ts.copy()
    ts_n[2:] += rng.normal(0, 0.02, ts_n[2:].shape).astype(np.float32)
    pts_n = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
    pose_fixed = np.zeros(60, np.float32)
    pose_fixed[:2] = 1.0
    prob = ba_t.make_problem(qs, ts_n, intr, pts_n, oc, op, ouv, pose_fixed=pose_fixed, track_len=8,
                             device="cpu")
    cfg = ba_t.BAConfig(model_id=1, max_iterations=15, dense_max_pose_blocks=32)
    assert ba_t.uses_pcg(prob, cfg)
    res = ba_t.solve(prob, cfg)
    assert float(res.final_cost) < 1e-2 * float(res.initial_cost)
    assert np.abs(res.cam_t.numpy() - ts).max() < 0.1
