"""Camera rigs in the port against the JAX package on the CPU: the rig
model and its JSON config, the generalized absolute (GP6P) and relative
(GR6P) pose solvers and the GR6P RANSAC bank, rig bundle adjustment, and
the `rig_bundle_adjuster` command (also in an interpreter where `import jax`
fails).

The scenes are tests/test_rig.py's and tests/test_generalized_pose.py's.
The JAX package's random draws (GR6P restarts, RANSAC samples) are handed to
the port, and rig BA problems are carried across with
`convert.rig_ba_problem_from_numpy`."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_pcd_tpu.cli import main as main_j
from colmap_pcd_tpu.models import camera_rig as rig_j
from colmap_pcd_tpu.models import rig_adjuster as adjuster_j
from colmap_pcd_tpu.ops import np_geom
from colmap_pcd_tpu.ops import ransac as ransac_j
from colmap_pcd_tpu.ops import rig_ba as rig_ba_j
from colmap_pcd_tpu.ops import solvers as solvers_j
from colmap_pcd_tpu_torch import convert
from colmap_pcd_tpu_torch.cli import main as main_t
from colmap_pcd_tpu_torch.models import camera_rig as rig_t
from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction
from colmap_pcd_tpu_torch.models.rig_adjuster import RigBundleAdjuster
from colmap_pcd_tpu_torch.ops import ransac as ransac_t
from colmap_pcd_tpu_torch.ops import rig_ba as rig_ba_t
from colmap_pcd_tpu_torch.ops import solvers as solvers_t

from test_generalized_pose import _make_rig_scene as _make_ray_scene
from test_rig import _make_rig_scene, _random_quat

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

REPO = pathlib.Path(__file__).resolve().parents[1]
RIG_JSON = [{"ref_camera_id": 1, "cameras": [{"camera_id": 1, "image_prefix": "cam1/"},
                                             {"camera_id": 2, "image_prefix": "cam2/"}]}]


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x))


def _rot_err(qa, qb) -> float:
    """Rotation distance |R_a - R_b|_F (the JAX tests' measure), ~ rad."""
    return float(np.linalg.norm(np_geom.quat_to_rotmat(np.asarray(qa, np.float64))
                                - np_geom.quat_to_rotmat(np.asarray(qb, np.float64))))


def _model_files(tmp_path, n_snapshots=4, noise=0.5, seed=0):
    """test_rig_bundle_adjuster_cli's scene with 0.5 px of pixel noise (so
    the solution is unique) written as a model and a rig.json without
    relative poses."""
    rng = np.random.default_rng(seed)
    rec, rig, *_ = _make_rig_scene(rng, n_snapshots=n_snapshots, noise=noise)
    for iid in rec.registered_ids[2:]:
        img = rec.images[iid]
        img.tvec = img.tvec + rng.normal(size=3) * 0.02
    model = tmp_path / "in"
    model.mkdir()
    rec.write(str(model))
    cfg = tmp_path / "rig.json"
    cfg.write_text(json.dumps(RIG_JSON))
    return str(model), str(cfg)


def test_camera_rig_and_config_match_jax(tmp_path, rng):
    """read_rig_config, compute_relative_poses, compute_absolute_pose,
    compute_scale and average_quaternions of the carried module equal the
    JAX package's on one model file."""
    model, cfg = _model_files(tmp_path)
    from colmap_pcd_tpu.models.reconstruction import Reconstruction as ReconstructionJ

    rec_j, rec_t = ReconstructionJ.read(model), Reconstruction.read(model)
    (a,), (b,) = rig_j.read_rig_config(cfg, rec_j), rig_t.read_rig_config(cfg, rec_t)
    assert a.snapshots == b.snapshots and a.ref_camera_id == b.ref_camera_id
    for cid in a.rel_poses:
        np.testing.assert_allclose(b.rel_poses[cid][0], a.rel_poses[cid][0], atol=1e-12)
        np.testing.assert_allclose(b.rel_poses[cid][1], a.rel_poses[cid][1], atol=1e-12)
    for s in range(a.num_snapshots()):
        for x, y in zip(a.compute_absolute_pose(s, rec_j), b.compute_absolute_pose(s, rec_t)):
            np.testing.assert_allclose(y, x, atol=1e-12)
    assert b.compute_scale(rec_t) == pytest.approx(a.compute_scale(rec_j), abs=1e-12)
    qs = np.stack([_random_quat(rng, 0.2) for _ in range(5)])
    np.testing.assert_allclose(rig_t.average_quaternions(qs, np.arange(1.0, 6.0)),
                               rig_j.average_quaternions(qs, np.arange(1.0, 6.0)), atol=1e-12)


def test_gp6p_dlt_matches_jax(rng):
    """test_gp6p_dlt's stereo rays: the port within 1e-4 of the JAX
    package, and both at that test's accuracy."""
    q_gt = _random_quat(rng, 0.3)
    t_gt = rng.normal(size=3)
    n = 24
    X = rng.uniform(-2, 2, (n, 3)) + np.asarray([0, 0, 6.0])
    origins = np.where(rng.random((n, 1)) < 0.5, 0.0, 0.4) * np.asarray([[1.0, 0, 0]])
    d = np_geom.se3_apply(q_gt, t_gt, X) - origins
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    origins, X = origins.astype(np.float32), X.astype(np.float32)
    q_j, t_j = solvers_j.gp6p_dlt(jnp.asarray(origins), jnp.asarray(d), jnp.asarray(X))
    q_t, t_t = solvers_t.gp6p_dlt(_t(origins), _t(d), _t(X))
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=1e-4)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-4)
    assert np_geom.angle_between(q_t.numpy().astype(np.float64), q_gt) < 1e-3
    np.testing.assert_allclose(t_t.numpy(), t_gt, atol=5e-3)


@pytest.mark.parametrize("seed,n,noise,key,rot_bar,t_bar", [
    (0, 8, 0.0, 1, 2e-2, 5e-2),  # test_gr6p_minimal_clean
    (3, 60, 1e-4, 2, 3e-2, 8e-2),  # test_gr6p_nonminimal_weighted
])
def test_gr6p_matches_jax(seed, n, noise, key, rot_bar, t_bar):
    """gr6p from the JAX package's restart perturbations: the rotation
    within 1e-3 of the JAX package's, and both within that test's error of
    the truth (one translation candidate too)."""
    f1, c1, f2, c2, q_gt, t_gt = _make_ray_scene(np.random.default_rng(seed), n_pts=n, noise=noise)
    k = jax.random.PRNGKey(key)
    q_j, ts_j, ok_j = solvers_j.gr6p(f1, c1, f2, c2, key=k)
    perturb = jax.random.uniform(k, (4, 3), jnp.float32, -0.3, 0.3).at[0].set(0.0)
    q_t, ts_t, ok_t = solvers_t.gr6p(_t(f1), _t(c1), _t(f2), _t(c2), perturb=_t(perturb))
    assert _rot_err(q_t.numpy(), q_j) < 1e-3
    for q, ts, ok in ((np.asarray(q_j), np.asarray(ts_j), np.asarray(ok_j)),
                      (q_t.numpy(), ts_t.numpy(), ok_t.numpy())):
        assert _rot_err(q, q_gt) < rot_bar
        assert min(np.linalg.norm(t - t_gt) for t, o in zip(ts, ok) if o) < t_bar


def test_generalized_sampson_error_matches_jax():
    """Zero at the truth (test_gr6p_sampson_zero_at_gt's bar) and the JAX
    package's values at a perturbed pose within 1e-4 relative."""
    f1, c1, f2, c2, q_gt, t_gt = _make_ray_scene(np.random.default_rng(5), n_pts=40)
    rays_t = [_t(x) for x in (f1, c1, f2, c2)]
    assert float(solvers_t.generalized_sampson_error(_t(q_gt.astype(np.float32)), _t(t_gt.astype(np.float32)),
                                                     *rays_t).max()) < 1e-8
    q = np_geom.quat_mul(np_geom.so3_exp_quat(np.asarray([0.01, -0.02, 0.005])), q_gt).astype(np.float32)
    t = (t_gt + 0.05).astype(np.float32)
    e_j = np.asarray(solvers_j.generalized_sampson_error(jnp.asarray(q), jnp.asarray(t), f1, c1, f2, c2))
    e_t = solvers_t.generalized_sampson_error(_t(q), _t(t), *rays_t).numpy()
    np.testing.assert_allclose(e_t, e_j, rtol=1e-4, atol=1e-4 * e_j.max())


@pytest.mark.parametrize("qx,tx", [(0.1, 0.2), (0.3, 0.4)])
def test_gr6p_bank_matches_jax(qx, tx):
    """test_gr6p_ransac_with_outliers's bank with the JAX package's sample
    indices and restart perturbations: the same inlier mask except rays
    whose error lies within 1e-6 (relative) of the threshold, the rotation
    within 1e-3 of the JAX package's, and that test's bars."""
    f1, c1, f2, c2, q_gt, t_gt = _make_ray_scene(
        np.random.default_rng(7), n_pts=100, qx=qx, tx=tx, noise=5e-5, n_outliers=25
    )
    valid = jnp.ones(100, jnp.float32)
    key = jax.random.PRNGKey(11)
    opts_j = ransac_j.RansacOptions(max_error=2e-3, num_hypotheses=128, lo_rounds=2)
    res_j = ransac_j.ransac_generalized_relative_pose(f1, c1, f2, c2, valid, key, opts_j)
    idx = ransac_j._draw_samples(key, valid, 32, 8)
    perturb = jax.vmap(lambda k: jax.random.uniform(k, (2, 3), jnp.float32, -0.3, 0.3).at[0].set(0.0))(
        jax.random.split(key, 32))
    res_t = ransac_t.ransac_generalized_relative_pose(
        _t(f1), _t(c1), _t(f2), _t(c2), _t(valid), None, ransac_t.RansacOptions(**opts_j._asdict()),
        sample_idx=_t(idx).long(), perturb=_t(perturb),
    )
    e_j = np.asarray(solvers_j.generalized_sampson_error(res_j.q, res_j.t, f1, c1, f2, c2))
    thr2 = opts_j.max_error**2
    differ = res_t.inlier_mask.numpy() != np.asarray(res_j.inlier_mask)
    assert np.all(np.abs(e_j[differ] / thr2 - 1.0) < 1e-6), np.nonzero(differ)
    assert _rot_err(res_t.q.numpy(), res_j.q) < 1e-3
    assert int(res_t.num_inliers) >= 60
    assert _rot_err(res_t.q.numpy(), q_gt) < 5e-2
    assert np.linalg.norm(res_t.t.numpy() - t_gt) < 0.1


@pytest.fixture
def jax_rig_problem(monkeypatch):
    """(JAX RigBAProblem, RigBAConfig) of test_rig_ba_refines_relative_pose's
    scene with 0.5 px of noise, image poses and the rig calibration
    perturbed, as the JAX package's RigBundleAdjuster builds it, with the
    first snapshot held (a unique solution)."""
    rng = np.random.default_rng(0)
    rec, rig, _, _, (rel_q2, rel_t2) = _make_rig_scene(rng, n_snapshots=8, noise=0.5)
    for iid in rec.registered_ids[2:]:
        img = rec.images[iid]
        img.qvec = np_geom.quat_mul(_random_quat(rng, 0.01), img.qvec)
        img.tvec = img.tvec + rng.normal(size=3) * 0.05
    rig.rel_poses[2] = (np_geom.quat_mul(_random_quat(rng, 0.01), rel_q2), rel_t2 + rng.normal(size=3) * 0.03)
    built = {}
    solve = rig_ba_j.solve

    def capture(problem, cfg):
        fixed = np.asarray(problem.rig_fixed).copy()
        fixed[0] = 1.0
        built["problem"] = problem._replace(rig_fixed=jnp.asarray(fixed))
        built["cfg"] = cfg
        return solve(built["problem"], cfg)

    monkeypatch.setattr(adjuster_j.rig_ba, "solve", capture)
    adjuster_j.RigBundleAdjuster(adjuster_j.RigBAOptions(max_iterations=60)).solve(rec, [rig])
    monkeypatch.undo()
    return built["problem"], built["cfg"]


def _port_problem(problem_j):
    return convert.rig_ba_problem_from_numpy(device="cpu", **{k: np.asarray(v) for k, v in problem_j._asdict().items()})


def test_rig_obs_jacobians_match_jax(jax_rig_problem):
    """Forward-mode Jacobians of the rig tangent, the relative-pose tangent
    and the point at 1e-4 relative to the largest entry of each block."""
    pj, cfg_j = jax_rig_problem
    pt = _port_problem(pj)
    cfg_t = rig_ba_t.RigBAConfig(**cfg_j._asdict())
    jacobians_j = jax.jit(rig_ba_j._obs_jacobians, static_argnums=1)
    out_j = jacobians_j(pj, cfg_j, pj.rig_q, pj.rig_t, pj.rel_q, pj.rel_t, pj.points)
    out_t = rig_ba_t._obs_jacobians(pt, cfg_t, pt.rig_q, pt.rig_t, pt.rel_q, pt.rel_t, pt.points)
    for a, b in zip(out_j, out_t):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-4 * np.abs(a).max())


def test_rig_ba_solve_matches_jax(jax_rig_problem):
    """The same padded problem through both LM loops (test_torch_ba.py's
    bars): costs within 1e-3 relative, rig and relative poses within 1e-4,
    points within 1e-3 relative; one host read per iteration."""
    pj, cfg_j = jax_rig_problem
    rj = rig_ba_j.solve(pj, cfg_j)
    rt = rig_ba_t.solve(_port_problem(pj), rig_ba_t.RigBAConfig(**cfg_j._asdict()))
    assert float(rt.final_cost) < 0.01 * float(rt.initial_cost)
    np.testing.assert_allclose(float(rt.initial_cost), float(rj.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(rt.final_cost), float(rj.final_cost), rtol=1e-3)
    for name in ("rig_q", "rig_t", "rel_q", "rel_t"):
        np.testing.assert_allclose(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)), atol=1e-4)
    np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points), rtol=1e-3)
    assert rt.host_syncs == rt.iterations


def test_rig_bundle_adjuster_cli_matches_jax(tmp_path):
    """Both packages' `rig_bundle_adjuster --RigBundleAdjustment.
    refine_relative_poses 1` on one model: the written image poses within
    1e-4 and the points within 1e-3 relative of the JAX package's."""
    model, cfg = _model_files(tmp_path)
    outs = {}
    for name, main, extra in (("jax", main_j, []), ("port", main_t, ["--device", "cpu"])):
        out = tmp_path / name
        out.mkdir()
        assert main(["rig_bundle_adjuster", "--input_path", model, "--output_path", str(out),
                     "--rig_config_path", cfg, "--RigBundleAdjustment.refine_relative_poses", "1", *extra]) == 0
        outs[name] = Reconstruction.read(str(out))
    a, b = outs["jax"], outs["port"]
    assert b.num_reg_images == a.num_reg_images == 8
    for iid, img in a.images.items():
        np.testing.assert_allclose(b.images[iid].qvec, img.qvec, atol=1e-4)
        np.testing.assert_allclose(b.images[iid].tvec, img.tvec, atol=1e-4)
    for pid, p in a.points3D.items():
        np.testing.assert_allclose(b.points3D[pid].xyz, p.xyz, rtol=1e-3)


def test_rig_bundle_adjuster_never_imports_jax(tmp_path):
    """`rig_bundle_adjuster` in a fresh interpreter where `import jax` fails
    loudly; and without a device the adjuster asks for CUDA, which raises
    where there is none."""
    model, cfg = _model_files(tmp_path, noise=0.0)
    argv = ["rig_bundle_adjuster", "--input_path", model, "--output_path", str(tmp_path),
            "--rig_config_path", cfg, "--RigBundleAdjustment.refine_relative_poses", "0", "--device", "cpu"]
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from colmap_pcd_tpu_torch import cli\n"
        f"rc = cli.main({argv!r})\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'colmap_pcd_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None), 'jax imported'\n"
        "sys.exit(rc)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "rig 0: 2 cameras, 4 snapshots" in proc.stdout
    assert Reconstruction.read(str(tmp_path)).num_reg_images == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            RigBundleAdjuster()
