"""Parity of the port's two-view solvers, RANSAC banks and geometry
classification with the JAX package on the same numpy inputs. Nullspace
bases differ between the two eigh implementations in sign and order, so
models are compared up to sign and scale and five-point solutions as sets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_pcd_tpu.models import two_view as two_view_j
from colmap_pcd_tpu.ops import camera_models as cm_j
from colmap_pcd_tpu.ops import ransac as ransac_j
from colmap_pcd_tpu.ops import se3 as se3_j
from colmap_pcd_tpu.ops import solvers as solvers_j
from colmap_pcd_tpu_torch.models import two_view as two_view_t
from colmap_pcd_tpu_torch.ops import ransac as ransac_t
from colmap_pcd_tpu_torch.ops import solvers as solvers_t

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

T = torch.as_tensor
J = jnp.asarray


def _n(x):
    return np.asarray(x)


def _sign_scale_dist(a, b):
    """Distance between two matrices up to sign and scale (both normalized)."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max())


def _relative_pose(rng, planar=False, n=64):
    """Normalized coords of n points seen from the identity and (R, t)."""
    R = np.asarray(se3_j.quat_to_rotmat(se3_j.so3_exp_quat(J(rng.normal(size=3) * 0.05, jnp.float32))))
    t = np.asarray([1.0, 0.1, 0.05]) + rng.normal(0, 0.1, 3)
    X = rng.uniform(-3, 3, (n, 3)) + np.asarray([0, 0, 10.0])
    if planar:
        X[:, 2] = 10.0
    Xc = X @ R.T + t
    x1 = (X[:, :2] / X[:, 2:]).astype(np.float32)
    x2 = (Xc[:, :2] / Xc[:, 2:]).astype(np.float32)
    E = np.cross(np.eye(3), t) @ R
    return x1, x2, R, t, E


def _pixels(x):
    return (x * 800.0 + np.asarray([320.0, 240.0])).astype(np.float32)


# ---------------------------------------------------------------------------
# solvers


def test_normalize_points_and_nullspace_parity():
    rng = np.random.default_rng(0)
    uv = rng.uniform(0, 640, (40, 2)).astype(np.float32)
    mask = (rng.uniform(size=40) > 0.3).astype(np.float32)
    for m in (None, mask):
        nt, Tt = solvers_t._normalize_points(T(uv), None if m is None else T(m))
        nj, Tj = solvers_j._normalize_points(J(uv), None if m is None else J(m))
        np.testing.assert_allclose(nt.numpy(), _n(nj), atol=1e-5)
        np.testing.assert_allclose(Tt.numpy(), _n(Tj), rtol=1e-5, atol=1e-5)
    A = rng.normal(size=(12, 9)).astype(np.float32)
    A[:, 8] = A[:, :8] @ rng.normal(size=8).astype(np.float32)  # rank 8: a 1-dim nullspace
    vt = solvers_t.nullspace_vecs(T(A), 1)[0].numpy()
    vj = _n(solvers_j.nullspace_vecs(J(A), 1)[0])
    assert _sign_scale_dist(vt, vj) < 1e-4
    assert np.abs(A @ vt).max() < 1e-3


def test_triangulation_and_small_ops_parity():
    rng = np.random.default_rng(1)
    x1, x2, R, t, _ = _relative_pose(rng)
    q = _n(se3_j.rotmat_to_quat(J(R, jnp.float32)))
    P1 = np.eye(3, 4, dtype=np.float32)
    P2 = np.asarray(solvers_j.proj_matrix(J(q), J(t, jnp.float32)))
    np.testing.assert_allclose(solvers_t.proj_matrix(T(q), T(t.astype(np.float32))).numpy(), P2, atol=1e-6)
    P1b = np.broadcast_to(P1, (64, 3, 4))
    P2b = np.broadcast_to(P2, (64, 3, 4))
    Xt = solvers_t.triangulate_dlt(T(P1b), T(P2b), T(x1), T(x2)).numpy()
    Xj = _n(solvers_j.triangulate_dlt(J(P1b), J(P2b), J(x1), J(x2)))
    np.testing.assert_allclose(Xt, Xj, rtol=1e-3, atol=1e-3)
    c2 = -R.T @ t
    at = solvers_t.triangulation_angle(T(np.zeros(3, np.float32)), T(c2.astype(np.float32)), T(Xt)).numpy()
    aj = _n(solvers_j.triangulation_angle(J(np.zeros(3, np.float32)), J(c2, jnp.float32), J(Xt)))
    np.testing.assert_allclose(at, aj, atol=1e-5)


def test_eight_point_parity():
    rng = np.random.default_rng(2)
    x1, x2, _, _, E = _relative_pose(rng, n=20)
    mask = np.ones(20, np.float32)
    mask[-3:] = 0.0
    for essential, a, b in ((True, x1, x2), (False, _pixels(x1), _pixels(x2))):
        Mt = solvers_t.eight_point(T(a), T(b), T(mask), essential=essential).numpy()
        Mj = _n(solvers_j.eight_point(J(a), J(b), J(mask), essential=essential))
        assert _sign_scale_dist(Mt, Mj) < 1e-3, essential
    # against the truth (f32 data: a few 1e-3), and batched over leading dims
    Et = solvers_t.eight_point(T(x1), T(x2), essential=True).numpy()
    assert _sign_scale_dist(Et, E) < 5e-3
    Mb = solvers_t.eight_point(T(np.stack([x1, x1 * 2])), T(np.stack([x2, x2 * 2])), essential=True)
    assert _sign_scale_dist(Mb[0].numpy(), Et) < 1e-5


def test_seven_point_parity_as_sets():
    rng = np.random.default_rng(3)
    for _ in range(5):
        x1, x2, _, _, _ = _relative_pose(rng, n=7)
        u1, u2 = _pixels(x1), _pixels(x2)
        Ft, vt = (x.numpy() for x in solvers_t.seven_point(T(u1), T(u2)))
        Fj, vj = (_n(x) for x in solvers_j.seven_point(J(u1), J(u2)))
        assert vt.sum() == vj.sum()
        for i in np.nonzero(vj)[0]:
            assert min(_sign_scale_dist(Fj[i], Ft[k]) for k in np.nonzero(vt)[0]) < 1e-3


def test_five_point_solution_sets():
    """Both packages find the true E among their solutions in most exact
    samples (f32 conditioning varies per sample), and the port's expansion
    tables are exact: in float64 it finds the true E every time."""
    rng = np.random.default_rng(4)
    hits_t = hits_j = 0
    trials = 12
    for _ in range(trials):
        x1, x2, _, _, E = _relative_pose(rng, n=5)
        Et, vt = (x.numpy() for x in solvers_t.five_point(T(x1), T(x2)))
        Ej, vj = (_n(x) for x in solvers_j.five_point(J(x1), J(x2)))
        hits_t += min([_sign_scale_dist(Et[k], E) for k in np.nonzero(vt)[0]] + [9.0]) < 1e-2
        hits_j += min([_sign_scale_dist(Ej[k], E) for k in np.nonzero(vj)[0]] + [9.0]) < 1e-2
        E64, v64 = solvers_t.five_point(T(x1).double(), T(x2).double())
        assert min(_sign_scale_dist(E64[k].numpy(), E) for k in np.nonzero(v64.numpy())[0]) < 1e-3
    assert hits_t >= 0.8 * trials and hits_j >= 0.8 * trials, (hits_t, hits_j)


def test_homography_and_errors_parity():
    rng = np.random.default_rng(5)
    x1, x2, _, _, E = _relative_pose(rng, planar=True, n=16)
    u1, u2 = _pixels(x1), _pixels(x2)
    Ht = solvers_t.homography_dlt(T(u1), T(u2)).numpy()
    Hj = _n(solvers_j.homography_dlt(J(u1), J(u2)))
    np.testing.assert_allclose(Ht, Hj, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        solvers_t.homography_transfer_error(T(Hj), T(u1), T(u2)).numpy(),
        _n(solvers_j.homography_transfer_error(J(Hj), J(u1), J(u2))), atol=1e-4,
    )
    E32 = E.astype(np.float32)
    np.testing.assert_allclose(
        solvers_t.sampson_error(T(E32), T(x1), T(x2)).numpy(),
        _n(solvers_j.sampson_error(J(E32), J(x1), J(x2))), atol=1e-10,
    )


def test_decompose_essential_parity():
    rng = np.random.default_rng(6)
    x1, x2, R, t, E = _relative_pose(rng, n=50)
    m = np.ones(50, np.float32)
    E32 = (E / np.linalg.norm(E)).astype(np.float32)
    qt, tt = (x.numpy() for x in solvers_t.decompose_essential(T(E32), T(x1), T(x2), T(m)))
    qj, tj = (_n(x) for x in solvers_j.decompose_essential(J(E32), J(x1), J(x2), J(m)))
    np.testing.assert_allclose(qt, qj, atol=1e-4)
    np.testing.assert_allclose(tt, tj, atol=1e-4)
    np.testing.assert_allclose(tt, t / np.linalg.norm(t), atol=1e-3)


# ---------------------------------------------------------------------------
# RANSAC banks


def _noisy_matches(rng, planar=False, n=128, cap=160, outliers=0.2, noise=0.3):
    x1, x2, _, _, _ = _relative_pose(rng, planar=planar, n=n)
    u1, u2 = _pixels(x1), _pixels(x2)
    u2 = u2 + rng.normal(0, noise, u2.shape).astype(np.float32)
    bad = rng.uniform(size=n) < outliers
    u2[bad] = rng.uniform(0, 640, (bad.sum(), 2)).astype(np.float32)
    p1 = np.zeros((cap, 2), np.float32)
    p2 = np.zeros((cap, 2), np.float32)
    p1[:n], p2[:n] = u1, u2
    valid = (np.arange(cap) < n).astype(np.float32)
    return p1, p2, valid


@pytest.mark.parametrize("kind", ["fundamental", "essential", "homography"])
def test_ransac_banks_parity_on_shared_samples(kind):
    """Fed the indices JAX's _draw_samples draws with the key its bank
    uses, a batch of two pairs through the port's bank against JAX's bank
    per pair: models agree up to sign and scale, inlier counts within 1.
    The essential bank gets exact inlier coordinates: five-point roots
    differ in their last f32 digits between the two eigh bases, and with
    noisy matches near-equal hypotheses can swap rank."""
    rng = np.random.default_rng({"fundamental": 7, "essential": 8, "homography": 9}[kind])
    opts_j = ransac_j.RansacOptions(max_error=4.0, num_hypotheses=256)
    opts_t = ransac_t.RansacOptions(max_error=4.0, num_hypotheses=256)
    k, per = {"fundamental": (7, 3), "essential": (5, 10), "homography": (4, 1)}[kind]
    items, idxs, res_j = [], [], []
    for b in range(2):
        p1, p2, valid = _noisy_matches(
            rng, planar=kind == "homography", noise=0.0 if kind == "essential" else 0.3
        )
        if kind == "essential":
            p1 = (p1 - np.asarray([320.0, 240.0], np.float32)) / 800.0
            p2 = (p2 - np.asarray([320.0, 240.0], np.float32)) / 800.0
        key = jax.random.PRNGKey(b)
        idxs.append(_n(ransac_j._draw_samples(key, J(valid), 256 // per, k)))
        fn = getattr(ransac_j, f"ransac_{kind}")
        extra = {"max_error": 4.0 / 800.0} if kind == "essential" else {}
        res_j.append(fn(J(p1), J(p2), J(valid), key, opts_j, **extra))
        items.append((p1, p2, valid))
    p1, p2, valid = (T(np.stack(x)) for x in zip(*items))
    fn_t = getattr(ransac_t, f"ransac_{kind}")
    extra = {"max_error": T(np.full(2, 4.0 / 800.0, np.float32))} if kind == "essential" else {}
    res_t = fn_t(p1, p2, valid, None, opts_t, sample_idx=T(np.stack(idxs)), **extra)
    for b in range(2):
        assert _sign_scale_dist(res_t.model[b].numpy(), _n(res_j[b].model)) < 2e-3, b
        assert abs(int(res_t.num_inliers[b]) - int(res_j[b].num_inliers)) <= 1
        assert int(res_t.num_inliers[b]) > 80


def test_prosac_ordered_sampling():
    """Quality-ordered sampling (progressive_sampler.cc semantics): early
    hypotheses draw only from the top-quality rows; late hypotheses can use
    everything; invalid rows are never drawn (tests/test_matching.py's
    statistics, on the port's sampler)."""
    N = 64
    valid = np.ones(N, np.float32)
    valid[50:] = 0.0
    quality = np.arange(N, dtype=np.float32)  # row 49 = best valid
    gen = torch.Generator().manual_seed(0)
    idx = ransac_t._draw_samples(gen, T(valid), 256, 8, T(quality)).numpy()
    assert idx.shape == (256, 8)
    assert (idx < 50).all()
    assert (idx[0] >= 34).all()
    assert idx[-32:].min() < 20
    # an item with no valid row still draws (its hypotheses score out)
    none = ransac_t._draw_samples(gen, T(np.zeros(N, np.float32)), 4, 8, T(quality))
    assert none.shape == (4, 8)


# ---------------------------------------------------------------------------
# two-view geometry


def _stereo_scene(rng, n=128, noise=0.0, planar=False):
    """tests/test_matching.py's calibrated and planar scenes."""
    params = cm_j.pad_params([800.0, 800.0, 320.0, 240.0], 1)
    if planar:
        q2 = se3_j.so3_exp_quat(J(rng.normal(size=3) * 0.03, jnp.float32))
        t2 = J([0.5, 0.0, 0.0], jnp.float32)
        Xp = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
        X = J(np.concatenate([Xp, np.full((n, 1), 10.0, np.float32)], -1))
    else:
        q2 = se3_j.so3_exp_quat(J(rng.normal(size=3) * 0.05, jnp.float32))
        t2 = J([1.0, 0.1, 0.0], jnp.float32)
        X = J(rng.uniform(-3, 3, (n, 3)).astype(np.float32) + np.array([0, 0, 10]))
    uv1, _ = cm_j.project(1, params, J([1.0, 0, 0, 0], jnp.float32), jnp.zeros(3, jnp.float32), X)
    uv2, _ = cm_j.project(1, params, q2, t2, X)
    uv1 = _n(uv1) + rng.normal(0, noise, (n, 2))
    uv2 = _n(uv2) + rng.normal(0, noise, (n, 2))
    return _n(q2), _n(params), uv1.astype(np.float32), uv2.astype(np.float32)


def test_two_view_configs_match_jax():
    """The calibrated, planar and degenerate scenes of tests/test_matching.py
    classify the same in both packages; the calibrated pose agrees."""
    rng = np.random.default_rng(0)
    q2, params, uv1, uv2 = _stereo_scene(rng, noise=0.3)
    _, _, pu1, pu2 = _stereo_scene(rng, planar=True)
    du1 = rng.uniform(0, 600, (30, 2)).astype(np.float32)
    du2 = rng.uniform(0, 600, (30, 2)).astype(np.float32)
    scenes = {"calibrated": (uv1, uv2), "planar": (pu1, pu2), "degenerate": (du1, du2)}
    for name, (a, b) in scenes.items():
        gj = two_view_j.estimate_two_view_geometry(a, b, params, params, 1, 1)
        gt = two_view_t.estimate_two_view_geometry(a, b, params, params, 1, 1, device="cpu")
        assert gt.config == gj.config, name
        if name == "calibrated":
            assert gt.config == two_view_t.CALIBRATED
            assert abs(len(gt.inlier_matches) - len(gj.inlier_matches)) <= 1
            assert float(se3_j.angle_between(J(gt.qvec), J(q2))) < 0.02
            assert float(np.dot(gt.tvec, gj.tvec)) > 0.99
            assert abs(gt.tri_angle - gj.tri_angle) < 1e-3
    assert two_view_t.estimate_two_view_geometry(pu1, pu2, params, params, 1, 1, device="cpu").config == (
        two_view_t.PLANAR_OR_PANORAMIC
    )


def test_two_view_batch_matches_scalar():
    """estimate_two_view_geometry_batch agrees with the scalar path: same
    configs, same inlier sets, poses within the noise floor."""
    rng = np.random.default_rng(1)
    items, scalars = [], []
    for k in range(4):
        _, params, uv1, uv2 = _stereo_scene(rng, noise=0.3)
        scalars.append(two_view_t.estimate_two_view_geometry(
            uv1, uv2, params, params, 1, 1, seed=k, size1=(640, 480), size2=(640, 480), device="cpu",
        ))
        items.append(dict(
            uv1=uv1, uv2=uv2, params1=params, params2=params, model_id1=1, model_id2=1,
            seed=k, size1=(640, 480), size2=(640, 480),
        ))
    for g_s, g_b in zip(scalars, two_view_t.estimate_two_view_geometry_batch(items, device="cpu")):
        assert g_b.config == g_s.config == two_view_t.CALIBRATED
        np.testing.assert_array_equal(g_b.inlier_matches, g_s.inlier_matches)
        assert float(se3_j.angle_between(J(g_b.qvec), J(g_s.qvec))) < 0.03
        assert float(np.dot(g_b.tvec, g_s.tvec)) > 0.98


def test_eigh_in_chunks_matches_one_call(monkeypatch):
    """Batched eigh goes to the device in chunks (cuSOLVER refuses 32768 or
    more matrices per call); chunked results equal one call's."""
    rng = np.random.default_rng(10)
    A = T(rng.normal(size=(5, 7, 4, 4)).astype(np.float32))
    M = A.mT @ A
    w, V = solvers_t._eigh(M)
    monkeypatch.setattr(solvers_t, "_EIGH_BATCH", 3)
    wc, Vc = solvers_t._eigh(M)
    assert wc.shape == (5, 7, 4) and Vc.shape == (5, 7, 4, 4)
    torch.testing.assert_close(wc, w)
    torch.testing.assert_close(Vc, V)


def test_watermark_and_multiple_models_match_jax():
    """The numpy watermark heuristic and the iterative MULTIPLE extraction
    give the JAX package's answers: a border-only pure translation is a
    watermark, a calibrated scene is not; two rigid motions in one match
    set classify as MULTIPLE with both inlier sets."""
    rng = np.random.default_rng(11)
    n = 80
    border = np.concatenate([rng.uniform(0, 40, (n, 1)), rng.uniform(0, 480, (n, 1))], -1)
    shifted = border + np.asarray([3.0, 0.0])
    mask = np.ones(n, bool)
    for uv1, uv2, expect in ((border, shifted, True), (*_stereo_scene(rng, n=n)[2:], False)):
        got_t = two_view_t.detect_watermark(uv1, uv2, mask, (640, 480), (640, 480))
        got_j = two_view_j.detect_watermark(uv1, uv2, mask, (640, 480), (640, 480))
        assert got_t == got_j == expect
    _, params, a1, a2 = _stereo_scene(rng, n=96, noise=0.2)
    _, _, b1, b2 = _stereo_scene(rng, n=96, noise=0.2)
    uv1, uv2 = np.concatenate([a1, b1]), np.concatenate([a2, b2])
    opts_t = two_view_t.TwoViewOptions(multiple_models=True)
    opts_j = two_view_j.TwoViewOptions(multiple_models=True)
    gt = two_view_t.estimate_two_view_geometry(uv1, uv2, params, params, 1, 1, opts_t, device="cpu")
    gj = two_view_j.estimate_two_view_geometry(uv1, uv2, params, params, 1, 1, opts_j)
    assert gt.config == gj.config == two_view_t.MULTIPLE
    assert abs(len(gt.inlier_matches) - len(gj.inlier_matches)) <= 2
