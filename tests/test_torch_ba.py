"""Parity of the port's bundle adjuster with the JAX package: the
per-observation Jacobians (forward mode in both) and full LM solves on one
problem built by the JAX `make_problem` and carried over with
`convert.ba_problem_from_numpy`."""

import numpy as np
import pytest
import torch

from colmap_pcd_tpu.ops import ba as ba_j
from colmap_pcd_tpu.ops import camera_models as cm_j
from colmap_pcd_tpu_torch import convert
from colmap_pcd_tpu_torch.ops import ba as ba_t
from colmap_pcd_tpu_torch.ops import np_geom

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

PINHOLE, OPENCV = 1, 4
PARAMS = {
    PINHOLE: [500.0, 505.0, 320.0, 240.0],
    OPENCV: [500.0, 505.0, 320.0, 240.0, 0.02, -0.005, 0.001, -0.001],
}


def _problem(model_id, seed=0, n_cams=5, n_pts=120, lidar=True):
    """Cameras stepping down +z looking at points on a wall (x = 4) and the
    ground (y = 2); noisy observations, perturbed poses and points, lidar
    planes on the wall and ground points, camera 0 fixed."""
    rng = np.random.default_rng(seed)
    params = np.asarray(PARAMS[model_id], np.float64)
    padded = np.pad(params, (0, 12 - params.size)).astype(np.float32)
    on_wall = rng.random(n_pts) < 0.5
    X = np.where(
        on_wall[:, None],
        np.stack([np.full(n_pts, 4.0), rng.uniform(-2, 2, n_pts), rng.uniform(6, 20, n_pts)], -1),
        np.stack([rng.uniform(-4, 4, n_pts), np.full(n_pts, 2.0), rng.uniform(6, 20, n_pts)], -1),
    )
    qs, ts, obs_cam, obs_pt, obs_uv = [], [], [], [], []
    for c in range(n_cams):
        yaw = 0.03 * np.sin(c)
        q = np.asarray([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0])
        t = -np_geom.quat_to_rotmat(q) @ np.asarray([0.2 * np.sin(c), 0.1 * c, 1.0 * c])
        xy, z = np_geom.project(model_id, padded, q, t, X)
        vis = (z > 1.0) & (xy[:, 0] > 0) & (xy[:, 0] < 640) & (xy[:, 1] > 0) & (xy[:, 1] < 480)
        for p in np.nonzero(vis)[0]:
            obs_cam.append(c)
            obs_pt.append(p)
            obs_uv.append(xy[p] + rng.normal(0, 0.5, 2))
        qs.append(q)
        ts.append(t)
    qs = np.asarray(qs)
    ts = np.asarray(ts)
    # perturb every pose but the fixed first one, and the points
    dq = rng.normal(0, 0.01, (n_cams, 3))
    qs_p = np.asarray([np_geom.quat_mul(np.concatenate([[1.0], 0.5 * d]), q) for d, q in zip(dq, qs)])
    qs_p /= np.linalg.norm(qs_p, axis=-1, keepdims=True)
    ts_p = ts + rng.normal(0, 0.05, ts.shape)
    qs_p[0], ts_p[0] = qs[0], ts[0]
    X_p = X + rng.normal(0, 0.05, X.shape)
    plane = np.where(on_wall[:, None], [[-1.0, 0, 0, 4.0]], [[0, -1.0, 0, 2.0]])
    lidar_w = np.where(rng.random(n_pts) < 0.6, 10.0, 0.0) if lidar else np.zeros(n_pts)
    pose_fixed = np.zeros(n_cams)
    pose_fixed[0] = 1.0
    track = np.bincount(obs_pt, minlength=n_pts).max()
    return ba_j.make_problem(
        qs_p, ts_p, padded, X_p, np.asarray(obs_cam), np.asarray(obs_pt), np.asarray(obs_uv),
        track_len=int(track), lidar_plane=plane, lidar_w=lidar_w, pose_fixed=pose_fixed,
    )


def _port(problem_j):
    fields = {k: np.asarray(v) for k, v in problem_j._asdict().items()}
    return convert.ba_problem_from_numpy(device="cpu", **fields)


@pytest.mark.parametrize("refine_intrinsics", [False, True])
@pytest.mark.parametrize("model_id", [PINHOLE, OPENCV])
def test_obs_jacobians_parity(model_id, refine_intrinsics):
    """Forward-mode Jacobians of both implementations at 1e-4 relative to
    the largest entry of each block (f32 chains through the camera model)."""
    pj = _problem(model_id)
    pt = _port(pj)
    cfg_j = ba_j.BAConfig(model_id=model_id, refine_intrinsics=refine_intrinsics,
                          loss_type=ba_j.LOSS_CAUCHY, loss_scale=2.0)
    cfg_t = ba_t.BAConfig(**cfg_j._asdict())
    out_j = ba_j._obs_jacobians(pj, cfg_j, pj.cam_q, pj.cam_t, pj.intr, pj.points)
    out_t = ba_t._obs_jacobians(pt, cfg_t, pt.cam_q, pt.cam_t, pt.intr, pt.points)
    for a, b in zip(out_j, out_t):
        if a is None:
            assert b is None
            continue
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-4 * np.abs(a).max())


@pytest.mark.parametrize("lidar", [True, False])
@pytest.mark.parametrize("model_id", [PINHOLE, OPENCV])
def test_solve_parity(model_id, lidar):
    """Same padded problem, same LM schedule: final cost within 1e-3
    relative and poses within 1e-4. Points are compared at 1e-3 relative:
    far, low-parallax points move along a flat cost valley, and the two
    implementations stop on the function tolerance a few iterations apart."""
    pj = _problem(model_id, seed=1, lidar=lidar)
    pt = _port(pj)
    cfg_j = ba_j.BAConfig(model_id=model_id, max_iterations=30, point_chunk=64)
    cfg_t = ba_t.BAConfig(**cfg_j._asdict())
    rj = ba_j.solve(pj, cfg_j)
    rt = ba_t.solve(pt, cfg_t)
    assert float(rt.final_cost) < 0.5 * float(rt.initial_cost)
    np.testing.assert_allclose(float(rt.initial_cost), float(rj.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(rt.final_cost), float(rj.final_cost), rtol=1e-3)
    np.testing.assert_allclose(rt.cam_q.numpy(), np.asarray(rj.cam_q), atol=1e-4)
    np.testing.assert_allclose(rt.cam_t.numpy(), np.asarray(rj.cam_t), atol=1e-4)
    np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points), rtol=1e-3)
    assert rt.host_syncs == rt.iterations


def test_solve_parity_refining_intrinsics():
    """The three-role Schur layout (pose + two intrinsics blocks; off the
    mapper's path). Final cost within 1e-3 relative and rotations within
    1e-4; focal length and camera depth trade along a valley that is flat
    to 1e-5 in cost here, so translations and intrinsics are held to 1e-2
    relative to their scale."""
    pj = _problem(OPENCV, seed=2)
    pt = _port(pj)
    cfg_j = ba_j.BAConfig(model_id=OPENCV, max_iterations=30, refine_intrinsics=True,
                          loss_type=ba_j.LOSS_SOFT_L1, loss_scale=1.0)
    rj = ba_j.solve(pj, cfg_j)
    rt = ba_t.solve(pt, ba_t.BAConfig(**cfg_j._asdict()))
    np.testing.assert_allclose(float(rt.final_cost), float(rj.final_cost), rtol=1e-3)
    np.testing.assert_allclose(rt.cam_q.numpy(), np.asarray(rj.cam_q), atol=1e-4)
    np.testing.assert_allclose(rt.cam_t.numpy(), np.asarray(rj.cam_t), atol=1e-2)
    np.testing.assert_allclose(rt.intr.numpy() / 500.0, np.asarray(rj.intr) / 500.0, atol=1e-2)


def test_pcg_tier_raises():
    """The PCG tier raised NotImplementedError until it was ported. Now it
    solves without raising: the cost falls as the dense tier's does, and
    the CG blocks' host reads are counted beside the LM loop's
    (tests/test_torch_sfm_tools.py holds it to the dense tier and to JAX)."""
    pt = _port(_problem(PINHOLE))
    dense = ba_t.solve(pt, ba_t.BAConfig(camera_solver="dense", max_iterations=10))
    pcg = ba_t.solve(pt, ba_t.BAConfig(camera_solver="pcg", max_iterations=10))
    assert ba_t.uses_pcg(pt, ba_t.BAConfig(camera_solver="pcg"))
    assert float(pcg.final_cost) < 0.5 * float(pcg.initial_cost)
    np.testing.assert_allclose(float(pcg.final_cost), float(dense.final_cost), rtol=1e-2)
    assert pcg.host_syncs > pcg.iterations


@pytest.mark.parametrize("camera_solver", ["dense", "pcg"])
def test_padding_slots_are_inert(camera_solver):
    """The mapper builds its problems at the data's size. The same problem
    padded as the mapper once padded it (16 pose slots, 2048 point slots,
    8192 observations, tracks of 16; the extra poses and points frozen, the
    extra observations invalid, the identity pose layout) solves to the
    same poses, points and final cost at test_solve_parity's bars, on
    either camera tier."""
    f = {k: np.asarray(v) for k, v in _problem(PINHOLE, seed=1)._asdict().items()}
    C, P, N = len(f["cam_q"]), len(f["points"]), len(f["obs_cam"])
    var = f["pose_fixed"] == 0
    prob = ba_t.make_problem(
        f["cam_q"], f["cam_t"], f["intr"], f["points"], f["obs_cam"], f["obs_pt"], f["obs_uv"],
        cam_blk=np.where(var, np.cumsum(var) - 1, 0), track_len=f["pt_obs"].shape[1],
        lidar_plane=f["lidar_plane"], lidar_w=f["lidar_w"], pose_fixed=f["pose_fixed"],
        point_fixed=f["point_fixed"], device="cpu",
    )

    def pad(a, n, fill=0.0):
        return np.concatenate([a, np.full((n - len(a),) + a.shape[1:], fill, a.dtype)])

    ident = np.tile(np.float32([1, 0, 0, 0]), (16 - C, 1))
    padded = ba_t.make_problem(
        np.concatenate([f["cam_q"], ident]), pad(f["cam_t"], 16), f["intr"], pad(f["points"], 2048),
        pad(f["obs_cam"], 8192, 0), pad(f["obs_pt"], 8192, 0), pad(f["obs_uv"], 8192),
        obs_valid=pad(np.ones(N, np.float32), 8192), track_len=16,
        lidar_plane=pad(f["lidar_plane"], 2048), lidar_w=pad(f["lidar_w"], 2048),
        pose_fixed=pad(f["pose_fixed"], 16, 1.0), point_fixed=pad(f["point_fixed"], 2048, 1.0),
        device="cpu",
    )
    cfg = dict(model_id=PINHOLE, max_iterations=30, camera_solver=camera_solver)
    r = ba_t.solve(prob, ba_t.BAConfig(num_pose_blocks=int(var.sum()), **cfg))
    rp = ba_t.solve(padded, ba_t.BAConfig(**cfg))
    assert float(r.final_cost) < 0.5 * float(r.initial_cost)
    np.testing.assert_allclose(float(r.initial_cost), float(rp.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(r.final_cost), float(rp.final_cost), rtol=1e-3)
    np.testing.assert_allclose(r.cam_q.numpy(), rp.cam_q[:C].numpy(), atol=1e-4)
    np.testing.assert_allclose(r.cam_t.numpy(), rp.cam_t[:C].numpy(), atol=1e-4)
    np.testing.assert_allclose(r.points.numpy(), rp.points[:P].numpy(), rtol=1e-3)


def test_reprojection_errors_parity():
    pj = _problem(OPENCV, seed=3)
    pt = _port(pj)
    cfg = ba_j.BAConfig(model_id=OPENCV)
    ej = np.asarray(ba_j.reprojection_errors(pj, cfg))
    et = ba_t.reprojection_errors(pt, ba_t.BAConfig(**cfg._asdict())).numpy()
    np.testing.assert_allclose(et, ej, atol=1e-3)
    assert cm_j.NUM_PARAMS[OPENCV] == len(PARAMS[OPENCV])
