"""Parity of the port's geometry ops with the JAX package on the same inputs:
se3, the 11 camera models, polynomial roots, P3P / EPnP, PnP RANSAC, and the
numerics policy. Inputs are made with numpy from a seed and handed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_pcd_tpu.ops import camera_models as cm_j
from colmap_pcd_tpu.ops import polynomial as poly_j
from colmap_pcd_tpu.ops import ransac as ransac_j
from colmap_pcd_tpu.ops import se3 as se3_j
from colmap_pcd_tpu.ops import solvers as solvers_j
from colmap_pcd_tpu_torch import device as device_t
from colmap_pcd_tpu_torch.ops import camera_models as cm_t
from colmap_pcd_tpu_torch.ops import polynomial as poly_t
from colmap_pcd_tpu_torch.ops import ransac as ransac_t
from colmap_pcd_tpu_torch.ops import se3 as se3_t
from colmap_pcd_tpu_torch.ops import solvers as solvers_t

from test_solvers import make_pnp_scene

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

T = torch.as_tensor


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# se3: the same float32 formulas on both sides; atol 1e-5 is a few ulps of
# the O(1) outputs


def _se3_cases(rng):
    q1, q2 = _unit_quats(rng, 32), _unit_quats(rng, 32)
    v = rng.normal(size=(32, 3)).astype(np.float32)
    t = rng.normal(size=(32, 3)).astype(np.float32)
    small = (rng.normal(size=(32, 3)) * rng.choice([1e-7, 1e-2, 1.0], size=(32, 1))).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, size=(3, 32)).astype(np.float32)
    return {
        "quat_mul": (lambda m: m.quat_mul, (q1, q2)),
        "quat_rotate": (lambda m: m.quat_rotate, (q1, v)),
        "quat_to_rotmat": (lambda m: m.quat_to_rotmat, (q1,)),
        "rotmat_to_quat": (lambda m: m.rotmat_to_quat, (np.asarray(se3_j.quat_to_rotmat(q1)),)),
        "so3_exp_quat": (lambda m: m.so3_exp_quat, (small,)),
        "so3_log": (lambda m: m.so3_log, (q1,)),
        "se3_apply": (lambda m: m.se3_apply, (q1, t, v)),
        "se3_inverse": (lambda m: m.se3_inverse, (q1, t)),
        "se3_compose": (lambda m: m.se3_compose, (q1, t, q2, v)),
        "se3_retract": (lambda m: m.se3_retract, (q1, t, np.concatenate([small, v], -1))),
        "projection_center": (lambda m: m.projection_center, (q1, t)),
        "euler_zyx_to_quat": (lambda m: m.euler_zyx_to_quat, tuple(ang)),
        "quat_to_euler_zyx": (lambda m: m.quat_to_euler_zyx, (q1,)),
        "angle_between": (lambda m: m.angle_between, (q1, q2)),
    }


@pytest.mark.parametrize("name", sorted(_se3_cases(np.random.default_rng(0))))
def test_se3_parity(name):
    get, args = _se3_cases(np.random.default_rng(0))[name]
    out_j = get(se3_j)(*(jnp.asarray(a) for a in args))
    out_t = get(se3_t)(*(T(a) for a in args))
    out_j = out_j if isinstance(out_j, tuple) else (out_j,)
    out_t = out_t if isinstance(out_t, tuple) else (out_t,)
    for a, b in zip(out_j, out_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


# ---------------------------------------------------------------------------
# camera models: normalized coordinates compared at atol 1e-5; pixel
# outputs are compared after dividing by the focal length (~1000 px), since
# 1e-5 px is below a float32 ulp at pixel magnitudes

PARAMS = {
    0: [1000.0, 320.0, 240.0],
    1: [1000.0, 1010.0, 320.0, 240.0],
    2: [1000.0, 320.0, 240.0, 0.05],
    3: [1000.0, 320.0, 240.0, 0.05, -0.01],
    4: [1000.0, 1010.0, 320.0, 240.0, 0.05, -0.01, 0.001, -0.002],
    5: [1000.0, 1010.0, 320.0, 240.0, 0.02, -0.005, 0.001, -0.001],
    6: [1000.0, 1010.0, 320.0, 240.0, 0.05, -0.01, 0.001, -0.002, 0.002, 0.01, -0.002, 0.001],
    7: [1000.0, 1010.0, 320.0, 240.0, 0.8],
    8: [1000.0, 320.0, 240.0, 0.02],
    9: [1000.0, 320.0, 240.0, 0.02, -0.005],
    10: [1000.0, 1010.0, 320.0, 240.0, 0.02, -0.005, 0.001, -0.001, 0.0005, -0.0002, 0.001, -0.001],
}


@pytest.mark.parametrize("model_id", list(range(11)))
def test_camera_model_parity(model_id):
    rng = np.random.default_rng(model_id)
    p_np = np.asarray(cm_j.pad_params(PARAMS[model_id], model_id))
    p_t = cm_t.pad_params(PARAMS[model_id], model_id)
    np.testing.assert_array_equal(p_t.numpy(), p_np)
    uv = rng.uniform(-0.25, 0.25, size=(64, 2)).astype(np.float32)
    f = 1000.0

    xy_j = np.asarray(cm_j.world_to_image(model_id, jnp.asarray(p_np), jnp.asarray(uv)))
    xy_t = cm_t.world_to_image(model_id, p_t, T(uv)).numpy()
    np.testing.assert_allclose(xy_t / f, xy_j / f, atol=1e-5)

    uv_j = np.asarray(cm_j.image_to_world(model_id, jnp.asarray(p_np), jnp.asarray(xy_j)))
    uv_t = cm_t.image_to_world(model_id, p_t, T(xy_j)).numpy()
    np.testing.assert_allclose(uv_t, uv_j, atol=1e-5)

    q = _unit_quats(rng, 1)[0] * np.float32(0.05) + np.float32([1, 0, 0, 0])
    q = (q / np.linalg.norm(q)).astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    X = np.concatenate([uv * 10.0, np.full((64, 1), 10.0, np.float32)], -1)
    (pj, zj), (pt, zt) = (
        cm_j.project(model_id, jnp.asarray(p_np), jnp.asarray(q), jnp.asarray(t), jnp.asarray(X)),
        cm_t.project(model_id, p_t, T(q), T(t), T(X)),
    )
    np.testing.assert_allclose(pt.numpy() / f, np.asarray(pj) / f, atol=1e-5)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-5)

    cj, dj = cm_j.unproject_ray(model_id, jnp.asarray(p_np), jnp.asarray(q), jnp.asarray(t), jnp.asarray(xy_j))
    ct, dt = cm_t.unproject_ray(model_id, p_t, T(q), T(t), T(xy_j))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-5)


# ---------------------------------------------------------------------------
# polynomial roots: Durand-Kerner iterates in complex64 on both sides but
# in another operation order; the real roots agree as sets to 1e-3 relative


@pytest.mark.parametrize("deg", [2, 3, 4])
def test_real_roots_parity(deg):
    rng = np.random.default_rng(deg)
    n_real = rng.integers(0, deg + 1, size=64)
    coeffs = []
    for k in n_real:
        roots = list(rng.uniform(-3, 3, size=k))
        while len(roots) < deg:  # complex-conjugate pairs (or one more real root)
            if deg - len(roots) >= 2:
                c = complex(rng.uniform(-2, 2), rng.uniform(0.5, 2))
                roots += [c, c.conjugate()]
            else:
                roots.append(rng.uniform(-3, 3))
        coeffs.append(np.real(np.poly(roots)) * rng.uniform(0.5, 2))
    coeffs = np.asarray(coeffs, np.float32)
    rj, vj = (np.asarray(a) for a in poly_j.real_roots(jnp.asarray(coeffs)))
    rt, vt = (a.numpy() for a in poly_t.real_roots(T(coeffs)))
    np.testing.assert_array_equal(vt, vj)
    for i in range(coeffs.shape[0]):
        np.testing.assert_allclose(
            np.sort(rt[i][vt[i]]), np.sort(rj[i][vj[i]]), rtol=1e-3, atol=1e-3
        )


# ---------------------------------------------------------------------------
# P3P / EPnP on shared samples: rotation within 1e-3 rad and translation
# within 1e-3 relative (float32 solvers with different eigen/SVD kernels)


def _pnp_world(rng, n, noise=0.0, outliers=0.0):
    q = _unit_quats(rng, 1)[0] * 0.1 + np.float32([1, 0, 0, 0])
    q = (q / np.linalg.norm(q)).astype(np.float32)
    t = rng.normal(size=3).astype(np.float32)
    Xc = np.stack(
        [rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(4, 12, n)], -1
    ).astype(np.float32)
    qi = np.asarray(se3_j.quat_conj(q))
    X = np.asarray(se3_j.quat_rotate(qi, Xc - t)).astype(np.float32)
    uv = (Xc[:, :2] / Xc[:, 2:]).astype(np.float32)
    uv = uv + rng.normal(0, noise, uv.shape).astype(np.float32)
    bad = rng.random(n) < outliers
    uv[bad] = rng.uniform(-0.5, 0.5, (bad.sum(), 2))
    return q, t, X, uv


def _pose_close(qa, ta, qb, tb):
    ang = float(np.asarray(se3_j.angle_between(jnp.asarray(qa), jnp.asarray(qb))))
    rel = np.linalg.norm(ta - tb) / max(np.linalg.norm(tb), 1e-6)
    return ang < 1e-3 and rel < 1e-3


def test_p3p_parity_as_sets():
    """Noise-free samples, so each sample's solution set holds the true
    pose. Wherever JAX's set recovers it (within 1e-3), the port's set must
    hold the same solution within 1e-3. The whole solution sets (the
    non-physical roots included) must agree as sets on >= 90% of samples:
    on an ill-conditioned sample the f32 quartic roots of ANY two
    implementations differ at ~1e-2, and neither finds the true pose."""
    rng = np.random.default_rng(3)
    q, t, X, uv = _pnp_world(rng, 300)
    idx = rng.integers(0, 300, size=(200, 3))
    qj, tj, vj = (np.asarray(a) for a in jax.vmap(solvers_j.p3p)(jnp.asarray(uv[idx]), jnp.asarray(X[idx])))
    qt, tt, vt = (a.numpy() for a in solvers_t.p3p(T(uv[idx]), T(X[idx])))
    n_true = n_sets = 0
    for s in range(idx.shape[0]):
        sols_j = [(qj[s, k], tj[s, k]) for k in range(4) if vj[s, k]]
        sols_t = [(qt[s, k], tt[s, k]) for k in range(4) if vt[s, k]]
        true_j = [b for b in sols_j if _pose_close(*b, q, t)]
        if true_j:
            n_true += 1
            assert any(_pose_close(*a, *true_j[0]) for a in sols_t), s
        n_sets += len(sols_j) == len(sols_t) and all(
            any(_pose_close(*a, *b) for b in sols_j) for a in sols_t
        )
    assert n_true >= 150, n_true
    assert n_sets >= 0.9 * idx.shape[0], n_sets


def test_epnp_parity():
    rng = np.random.default_rng(4)
    _, _, X, uv = _pnp_world(rng, 120, noise=1e-3)
    mask = (rng.random(120) > 0.2).astype(np.float32)
    qj, tj = (np.asarray(a) for a in solvers_j.epnp(jnp.asarray(uv), jnp.asarray(X), jnp.asarray(mask)))
    qt, tt = (a.numpy() for a in solvers_t.epnp(T(uv), T(X), T(mask)))
    assert _pose_close(qt, tt, qj, tj), (qt, tt, qj, tj)


def test_ransac_pnp_parity_on_shared_samples():
    """Fed the indices JAX's _draw_samples draws with the same key: pose
    within 1e-3 and inlier masks agreeing on >= 99% of rows."""
    rng = np.random.default_rng(5)
    n, npad = 400, 512
    q, t, X, uv = _pnp_world(rng, n, noise=5e-4, outliers=0.3)
    uvp = np.zeros((npad, 2), np.float32)
    Xp = np.zeros((npad, 3), np.float32)
    vp = np.zeros(npad, np.float32)
    uvp[:n], Xp[:n], vp[:n] = uv, X, 1.0
    opts_j = ransac_j.RansacOptions(num_hypotheses=512)
    opts_t = ransac_t.RansacOptions(num_hypotheses=512)
    key = jax.random.PRNGKey(11)
    idx = np.asarray(ransac_j._draw_samples(key, jnp.asarray(vp), 128, 3))
    thr = 4.0 / 500.0
    rj = ransac_j.ransac_pnp(
        jnp.asarray(uvp), jnp.asarray(Xp), jnp.asarray(vp), key, opts_j,
        refine_iters=10, max_error=jnp.float32(thr),
    )
    rt = ransac_t.ransac_pnp(
        T(uvp), T(Xp), T(vp), None, opts_t, refine_iters=10, max_error=thr,
        sample_idx=T(idx),
    )
    assert _pose_close(rt.q.numpy(), rt.t.numpy(), np.asarray(rj.q), np.asarray(rj.t))
    agree = np.mean(rt.inlier_mask.numpy() == np.asarray(rj.inlier_mask))
    assert agree >= 0.99, agree
    assert abs(int(rt.num_inliers) - int(rj.num_inliers)) <= 0.01 * npad


def test_ransac_pnp_random_draw_recovers_pose():
    """With its own generator the port's bank draws other samples than JAX;
    the outcome must still be the true pose and inlier set."""
    rng = np.random.default_rng(6)
    n = 300
    q, t, X, uv = _pnp_world(rng, n, noise=5e-4, outliers=0.3)
    gen = torch.Generator().manual_seed(0)
    r = ransac_t.ransac_pnp(
        T(uv), T(X), torch.ones(n), gen, ransac_t.RansacOptions(num_hypotheses=512),
        refine_iters=10, max_error=4.0 / 500.0,
    )
    ang = float(se3_t.angle_between(r.q, T(q)))
    assert ang < 2e-3 and np.linalg.norm(r.t.numpy() - t) < 2e-2 * np.linalg.norm(t)
    assert int(r.num_inliers) >= 0.65 * n


@pytest.mark.parametrize("n", [37, 500, 1500])
def test_ransac_pnp_ignores_padding(n):
    """The mapper hands ransac_pnp its n matches unpadded. With one seed,
    the draws, the inlier mask and the pose equal those over the same
    matches zero-padded to 2048 rows with valid = 0 (the JAX package's
    bucket)."""
    rng = np.random.default_rng(7)
    _, _, X, uv = _pnp_world(rng, n, noise=5e-4, outliers=0.3)
    npad = 2048
    uvp, Xp, vp = np.zeros((npad, 2), np.float32), np.zeros((npad, 3), np.float32), np.zeros(npad, np.float32)
    uvp[:n], Xp[:n], vp[:n] = uv, X, 1.0
    opts = ransac_t.RansacOptions(num_hypotheses=512)
    draws = [ransac_t._draw_samples(torch.Generator().manual_seed(3), T(v), 128, 3) for v in (np.ones(n), vp)]
    assert torch.equal(draws[0], draws[1])
    r, rp = (
        ransac_t.ransac_pnp(T(a), T(b), T(v), torch.Generator().manual_seed(3), opts,
                            refine_iters=10, max_error=4.0 / 500.0)
        for a, b, v in ((uv, X, np.ones(n, np.float32)), (uvp, Xp, vp))
    )
    assert torch.equal(r.inlier_mask, rp.inlier_mask[:n]) and not rp.inlier_mask[n:].any()
    assert int(r.num_inliers) == int(rp.num_inliers)
    np.testing.assert_allclose(r.q.numpy(), rp.q.numpy(), atol=1e-5)
    np.testing.assert_allclose(r.t.numpy(), rp.t.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# numerics policy and device resolution


def test_numerics_policy():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_cuda_request_raises_without_cuda():
    """None, "auto" and "cuda" all mean CUDA; without it they raise, and
    only a request for the CPU by name gives the CPU: the port never falls
    back to the CPU on its own."""
    assert device_t.resolve("cpu").type == "cpu"
    for name in (None, "auto", "cuda"):
        if torch.cuda.is_available():
            assert device_t.resolve(name).type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                device_t.resolve(name)


# ---------------------------------------------------------------------------
# the multi-view and P6P DLTs on tests/test_solvers.py's inputs (its
# rand_pose / project_norm draws): the points within 1e-4 of JAX's, the
# pose within 1e-4 rad and 1e-4 relative (f32 nullspaces of different
# eigensolvers), and both at test_solvers.py's own bars


def _rand_pose(rng):
    q = rng.normal(size=4)
    return (q / np.linalg.norm(q)).astype(np.float32), (rng.normal(size=3)).astype(np.float32)


def test_triangulate_multiview_parity():
    rng = np.random.default_rng(0)
    X = np.asarray([1.0, -0.5, 8.0], np.float32)
    qs, ts, uvs = [], [], []
    for _ in range(5):
        q, t = _rand_pose(rng)
        xc = np.asarray(se3_j.se3_apply(jnp.asarray(q), jnp.asarray(t), jnp.asarray(X[None])))[0]
        qs.append(q)
        ts.append(t)
        uvs.append(xc[:2] / xc[2])
    mask = np.asarray([1, 1, 1, 1, 0], np.float32)
    uvs[4] = uvs[4] + 100.0  # the masked view is corrupt
    args = (np.stack(qs), np.stack(ts), np.stack(uvs).astype(np.float32), mask)
    Xj = np.asarray(solvers_j.triangulate_multiview(*map(jnp.asarray, args)))
    Xt = solvers_t.triangulate_multiview(*map(T, args)).numpy()
    np.testing.assert_allclose(Xt, Xj, atol=1e-4)
    np.testing.assert_allclose(Xt, X, atol=1e-3)
    # batched over leading dims: two points at once give each one's answer
    both = solvers_t.triangulate_multiview(*(torch.stack([T(a), T(a)]) for a in args)).numpy()
    np.testing.assert_allclose(both, np.stack([Xt, Xt]), atol=1e-5)


def test_p6p_dlt_parity():
    """tests/test_solvers.py's exact P6P scene (its `rng` fixture's seed 0),
    and 12 points. The f32 nullspace of the unnormalized DLT's 12x12 Gram
    matrix is poorly conditioned (on some 6-point draws both packages miss
    the truth by 0.05-0.5 m), so the two eigensolvers agree to 2e-3 rad
    and 2e-3 relative here; the port meets test_solvers.py's bar."""
    rng = np.random.default_rng(0)
    for n in (6, 12):
        q, t, X, uv = (np.asarray(a) for a in make_pnp_scene(rng, n=n))
        qj, tj = (np.asarray(a) for a in solvers_j.p6p_dlt(jnp.asarray(uv), jnp.asarray(X)))
        qt, tt = (a.numpy() for a in solvers_t.p6p_dlt(T(uv), T(X)))
        dq = min(np.linalg.norm(qt - qj), np.linalg.norm(qt + qj))
        assert dq < 1e-3, dq  # |dq| ~ angle / 2
        np.testing.assert_allclose(tt, tj, atol=2e-3 * max(1.0, np.linalg.norm(tj)))
        assert float(np.asarray(se3_j.angle_between(jnp.asarray(qt), jnp.asarray(q)))) < 1e-3
        np.testing.assert_allclose(tt, t, atol=1e-3)
