"""The port's multi-device layer (colmap_pcd_tpu_torch/parallel) against the
JAX package's parallel/ on the CPU: the JAX side on conftest's 8 virtual CPU
devices, the port on meshes of one repeated CPU device
(`make_mesh(n, devices=["cpu"] * n)`), both fed the same numpy inputs.
The JAX package's tests of the same functions (tests/test_dist_ba.py,
test_dist_ba_pcg.py, test_parallel_extras.py and
test_stereo.py::test_dense_sharded_matches_sequential) have their twins
here at their own bars; the bars against JAX are stated in each test."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_pcd_tpu.models import mvs as mvs_j
from colmap_pcd_tpu.models import reconstruction as rec_j
from colmap_pcd_tpu.ops import ba as ba_j
from colmap_pcd_tpu.ops import se3 as se3_j
from colmap_pcd_tpu.parallel import dist_ba as dist_ba_j
from colmap_pcd_tpu.parallel import dist_matching as dist_matching_j
from colmap_pcd_tpu_torch import convert
from colmap_pcd_tpu_torch.models import mvs as mvs_t
from colmap_pcd_tpu_torch.models import reconstruction as rec_t
from colmap_pcd_tpu_torch.ops import ba as ba_t
from colmap_pcd_tpu_torch.parallel import dist_ba, dist_matching, dryrun, mesh as mesh_lib
from colmap_pcd_tpu_torch.utils.logging_utils import PHASES

from conftest import cpu_mesh
from test_ba import make_synthetic
from test_ba_pcg import _corridor_problem
from test_dist_ba import _problem as _dist_problem
from test_matching import make_descriptors
from test_stereo import H, W
from test_torch_ba import PINHOLE
from test_torch_ba import _problem as _torch_ba_problem
from test_torch_stereo import _workspaces

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

_SHARDED = ("points", "obs_cam", "obs_pt", "obs_uv", "obs_valid", "pt_obs", "lidar_plane", "lidar_w",
            "point_fixed")


def _cpu_mesh(n):
    return mesh_lib.make_mesh(n, devices=["cpu"] * n)


def _port(problem_j):
    return convert.ba_problem_from_numpy(device="cpu", **{k: np.asarray(v) for k, v in problem_j._asdict().items()})


def _lidar_problem(rng):
    """test_distributed_with_lidar's problem: fixed poses, points 0.2 m off
    their lidar planes."""
    qs, ts, intr, pts, oc, op, ouv = make_synthetic(rng, n_cams=4, n_pts=128)
    pts_n = pts.copy()
    pts_n[:, 2] += 0.2
    planes = np.zeros((len(pts), 4), np.float32)
    planes[:, 2] = 1.0
    planes[:, 3] = -pts[:, 2]
    prob = ba_j.make_problem(
        qs, ts, intr, pts_n, oc, op, ouv, pose_fixed=np.ones(len(qs), np.float32),
        lidar_plane=planes, lidar_w=np.full(len(pts), 10.0, np.float32), track_len=8,
    )
    return prob, pts


# ------------------------------------------------------------------ the mesh


def test_mesh_collectives_on_repeated_devices():
    """reduce_sum sums in shard order on the root, broadcast puts the sum
    on every shard, gather concatenates in shard order."""
    m = _cpu_mesh(3)
    assert m.size == 3 and m.root == torch.device("cpu")
    parts = [torch.full((2, 2), float(s + 1)) for s in range(3)]
    assert torch.equal(m.reduce_sum(parts), torch.full((2, 2), 6.0))
    assert all(torch.equal(x, torch.full((2, 2), 6.0)) for x in m.broadcast(m.reduce_sum(parts)))
    assert torch.equal(m.gather(parts)[:, 0], torch.tensor([1.0, 1.0, 2.0, 2.0, 3.0, 3.0]))
    with pytest.raises(ValueError):
        m.reduce_sum(parts[:2])


def test_mesh_never_shrinks_and_needs_cuda_by_default():
    """Without CUDA, make_mesh() raises as device.resolve(None) does; asking
    for more shards than the devices given raises; one process needs no
    process group, and more processes raise (a mesh spans one process)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh_lib.make_mesh()
    with pytest.raises(ValueError):
        mesh_lib.make_mesh(4, devices=["cpu"] * 2)
    assert mesh_lib.make_mesh(2, devices=["cpu"] * 4).size == 2
    mesh_lib.initialize_multihost(num_processes=1)
    mesh_lib.initialize_multihost()
    assert not torch.distributed.is_initialized()
    with pytest.raises(NotImplementedError):
        mesh_lib.initialize_multihost("localhost:1234", num_processes=2, process_id=0)


# ------------------------------------------------------------- shard_problem


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_problem_matches_jax(rng, n):
    """Every field of every shard equals the JAX package's: integers exact,
    floats bit-equal."""
    pj, _ = _lidar_problem(rng)
    sj = dist_ba_j.shard_problem(pj, n)
    shards = dist_ba.shard_problem(_port(pj), n, _cpu_mesh(n))
    assert len(shards) == n
    for s, st in enumerate(shards):
        for f, vj in sj._asdict().items():
            a = np.asarray(vj)[s] if f in _SHARDED else np.asarray(vj)
            b = getattr(st, f).numpy()
            assert a.shape == b.shape, (f, a.shape, b.shape)
            if a.dtype.kind == "f":
                assert np.array_equal(a.view(np.uint32), b.astype(np.float32).view(np.uint32)), f
            else:
                assert np.array_equal(a.astype(np.int64), b), f


def test_shard_problem_refuses_a_track_beyond_T(rng):
    """A track longer than the problem's table width T raises in both
    packages rather than dropping observations."""
    pj, _ = _lidar_problem(rng)
    narrow = pj._replace(pt_obs=jnp.asarray(np.asarray(pj.pt_obs)[:, :2]))
    with pytest.raises(AssertionError):
        dist_ba_j.shard_problem(narrow, 2)
    with pytest.raises(ValueError, match="exceeds pt_obs capacity"):
        dist_ba.shard_problem(_port(narrow), 2)


# ------------------------------------------------------------ distributed BA


@pytest.mark.parametrize("n_pts", [256, 251])
def test_distributed_matches_single(rng, n_pts):
    """tests/test_dist_ba.py's twin at its bars (8 shards): converges to the
    ground truth and agrees with the port's one-shard solve (cam_t within
    1e-3, points within 1e-2). At 251 points the shards' equal blocks hold
    five frozen padding points that the result does not return."""
    pj, qs, ts, pts = _dist_problem(rng, n_pts=n_pts)
    pt = _port(pj)
    cfg = ba_t.BAConfig(model_id=1, max_iterations=20)
    res_d = dist_ba.solve_distributed(pt, cfg, _cpu_mesh(8))
    res_s = ba_t.solve(pt, cfg)
    assert float(res_d.final_cost) < 1e-2, float(res_d.final_cost)
    for i in range(2, len(qs)):
        ang = float(se3_j.angle_between(jnp.asarray(res_d.cam_q[i].numpy()), jnp.asarray(qs[i])))
        assert ang < 1e-3
        assert np.linalg.norm(res_d.cam_t[i].numpy() - ts[i]) < 5e-3
    np.testing.assert_allclose(res_d.cam_t.numpy(), res_s.cam_t.numpy(), atol=1e-3)
    assert res_d.points.shape == (n_pts, 3)
    assert np.abs(res_d.points.numpy() - pts).max() < 1e-2
    assert np.abs(res_d.points.numpy() - res_s.points.numpy()).max() < 1e-2


def test_distributed_with_lidar(rng):
    """tests/test_dist_ba.py's lidar twin (4 shards): every point back on its
    plane within 1e-2 m, and within 1e-2 of the one-shard solve's."""
    pj, pts = _lidar_problem(rng)
    pt = _port(pj)
    cfg = ba_t.BAConfig(model_id=1, max_iterations=25)
    res = dist_ba.solve_distributed(pt, cfg, _cpu_mesh(4))
    d = np.abs(res.points.numpy()[:, 2] - pts[:, 2]).max()
    assert d < 1e-2, d
    assert np.abs(res.points.numpy() - ba_t.solve(pt, cfg).points.numpy()).max() < 1e-2


@pytest.mark.parametrize("camera_solver", ["dense", "pcg"])
def test_distributed_matches_jax_and_one_shard(camera_solver):
    """The port's 8-shard solve against the JAX package's solve_distributed
    and against its own one-shard solve, on tests/test_torch_ba.py's noisy
    lidar problem (0.5 px noise, so that the final cost, ~200, lies far above
    the f32 rounding floor where the noise-free problems above end): cam_t
    within 1e-3, points within 1e-2, final costs within 1e-3 relative,
    initial costs within 1e-5."""
    pj = _torch_ba_problem(PINHOLE, seed=1, n_pts=128)
    pt = _port(pj)
    cfg_j = ba_j.BAConfig(model_id=PINHOLE, max_iterations=30, point_chunk=64, camera_solver=camera_solver)
    cfg = ba_t.BAConfig(**cfg_j._asdict())
    res = dist_ba.solve_distributed(pt, cfg, _cpu_mesh(8))
    res_j = dist_ba_j.solve_distributed(pj, cfg_j, cpu_mesh((8,), ("work",)), axis="work")
    res_s = ba_t.solve(pt, cfg)
    assert float(res.final_cost) < 0.5 * float(res.initial_cost)
    for other in ((np.asarray(res_j.cam_t), np.asarray(res_j.points), res_j.initial_cost, res_j.final_cost),
                  (res_s.cam_t.numpy(), res_s.points.numpy(), res_s.initial_cost, res_s.final_cost)):
        np.testing.assert_allclose(res.cam_t.numpy(), other[0], atol=1e-3)
        assert np.abs(res.points.numpy() - other[1]).max() < 1e-2
        np.testing.assert_allclose(float(res.initial_cost), float(other[2]), rtol=1e-5)
        np.testing.assert_allclose(float(res.final_cost), float(other[3]), rtol=1e-3)


def test_distributed_pcg_matches_local_dense(rng):
    """tests/test_dist_ba_pcg.py's twin (48 cameras, 8 shards, PCG): both
    reach 1% of their initial cost, cam_t within 2e-2 of the truth and 1e-2
    of the one-shard dense solve; and within 1e-2 of the JAX package's
    sharded PCG solve."""
    n_cams = 48
    qs, ts, intr, pts, oc, op, ouv = _corridor_problem(rng, n_cams)
    ts_n = ts.copy()
    ts_n[2:] += rng.normal(0, 0.02, ts_n[2:].shape).astype(np.float32)
    pts_n = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)
    pose_fixed = np.zeros(n_cams, np.float32)
    pose_fixed[:2] = 1.0
    pj = ba_j.make_problem(qs, ts_n, intr, pts_n, oc, op, ouv, pose_fixed=pose_fixed, track_len=8)
    pt = _port(pj)
    res_p = dist_ba.solve_distributed(pt, ba_t.BAConfig(model_id=1, max_iterations=15, camera_solver="pcg"),
                                      _cpu_mesh(8))
    res_d = ba_t.solve(pt, ba_t.BAConfig(model_id=1, max_iterations=15, camera_solver="dense"))
    assert float(res_p.final_cost) < float(res_p.initial_cost) * 1e-2
    assert float(res_d.final_cost) < float(res_d.initial_cost) * 1e-2
    t_p, t_d = res_p.cam_t.numpy(), res_d.cam_t.numpy()
    assert np.abs(t_p - ts).max() < 2e-2, np.abs(t_p - ts).max()
    assert np.abs(t_p - t_d).max() < 1e-2, np.abs(t_p - t_d).max()
    res_j = dist_ba_j.solve_distributed(pj, ba_j.BAConfig(model_id=1, max_iterations=15, camera_solver="pcg"),
                                        cpu_mesh((8,), ("work",)), axis="work")
    assert np.abs(t_p - np.asarray(res_j.cam_t)).max() < 1e-2


def _reductions(fn):
    before = {k: PHASES.counts.get(k, 0) for k in ("ba_reductions", "ba_reduced_bytes")}
    out = fn()
    return out, {k: PHASES.counts.get(k, 0) - v for k, v in before.items()}


@pytest.mark.parametrize("n_pts", [64, 256])
def test_dense_tier_reduces_one_system_per_iteration(n_pts):
    """The dense tier reduces, per LM iteration, S, b and diag B (D^2 + 2D
    floats, D = 6 per camera) and the new cost: 4 (D^2 + 2D) + 4 bytes in two
    reductions, whatever the point count; plus the initial cost once."""
    pj, _, _, _ = _dist_problem(np.random.default_rng(3), n_pts=n_pts)
    res, red = _reductions(lambda: dist_ba.solve_distributed(
        _port(pj), ba_t.BAConfig(model_id=1, max_iterations=6), _cpu_mesh(4)))
    D = 6 * pj.cam_q.shape[0]
    it = res.iterations
    assert it >= 2
    assert red["ba_reductions"] == 1 + 2 * it
    assert red["ba_reduced_bytes"] == 4 + it * (4 * (D * D + 2 * D) + 4)


def test_pcg_tier_reduces_once_per_cg_step():
    """The PCG tier reduces its gradient and both preconditioner block sets
    (78 floats per camera) once per LM iteration, the cost once, and one
    [nb,6] matvec per CG step, none of it sized by the points."""
    pj, _, _, _ = _dist_problem(np.random.default_rng(4))
    res, red = _reductions(lambda: dist_ba.solve_distributed(
        _port(pj), ba_t.BAConfig(model_id=1, max_iterations=6, camera_solver="pcg"), _cpu_mesh(4)))
    nb = pj.cam_q.shape[0]
    it = res.iterations
    cg_steps = red["ba_reductions"] - 1 - 2 * it
    assert cg_steps >= it
    assert red["ba_reduced_bytes"] == 4 + it * (4 * 78 * nb + 4) + cg_steps * 4 * 6 * nb


# ------------------------------------------------------------------ matching


def _pairs_batch(rng, B=8, N=128):
    d1 = np.zeros((B, N, 128), np.float32)
    d2 = np.zeros((B, N, 128), np.float32)
    perms = []
    for b in range(B):
        base = make_descriptors(rng, N)
        perm = rng.permutation(N)
        noisy = base[perm] + rng.normal(0, 0.05, (N, 128)).astype(np.float32)
        noisy /= np.linalg.norm(noisy, axis=1, keepdims=True)
        d1[b] = base
        d2[b] = noisy
        perms.append(perm)
    return d1, d2, np.ones((B, N), np.float32), perms


def test_match_pairs_batch_sharded(rng):
    """test_parallel_extras.py's twin (8 pairs on 4 shards): > 80% matched
    per pair, > 98% of them right; (idx, ok) equal to the JAX package's."""
    d1, d2, v, perms = _pairs_batch(rng)
    idx, ok = dist_matching.match_pairs_batch(d1, d2, v, v, mesh=_cpu_mesh(4))
    for b in range(len(perms)):
        sel = ok[b]
        assert sel.sum() > d1.shape[1] * 0.8, sel.sum()
        assert (perms[b][idx[b][sel]] == np.nonzero(sel)[0]).mean() > 0.98
    idx_j, ok_j = dist_matching_j.match_pairs_batch(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v), jnp.asarray(v), mesh=cpu_mesh((4,), ("work",)))
    np.testing.assert_array_equal(ok, np.asarray(ok_j))
    np.testing.assert_array_equal(idx, np.asarray(idx_j))
    with pytest.raises(ValueError, match="not divisible"):
        dist_matching.match_pairs_batch(d1[:6], d2[:6], v[:6], v[:6], mesh=_cpu_mesh(4))


def test_match_pair_list(rng):
    """test_parallel_extras.py's twin: identical images 1 and 2 match row
    for row (> 90 of 100); the matches equal the JAX package's."""
    descs = {i: (make_descriptors(rng, 100) * 255).astype(np.float32) for i in range(1, 4)}
    descs[2] = descs[1].copy()
    out = dist_matching.match_pair_list(descs, [(1, 2), (1, 3)], mesh=_cpu_mesh(2), cap=128)
    m12 = out[(1, 2)]
    assert len(m12) > 90
    assert (m12[:, 0] == m12[:, 1]).all()
    out_j = dist_matching_j.match_pair_list(descs, [(1, 2), (1, 3)], mesh=cpu_mesh((2,), ("work",)), cap=128)
    for key in out_j:
        np.testing.assert_array_equal(out[key], out_j[key])


def test_match_pool_sharded_matches_local(rng):
    """test_parallel_extras.py's twin: 5 pairs on 4 shards (a padded batch)
    give exactly the unsharded pool's (idx, ok), every pair matches, and
    both equal the JAX package's sharded pool."""
    base = make_descriptors(rng, 100)
    descs = {i: ((base + rng.normal(0, 0.03, base.shape)) * 255).astype(np.float32) for i in range(1, 7)}
    pairs = [(1, 2), (2, 3), (3, 4), (4, 5), (5, 6)]
    idx_m, ok_m = dist_matching.MatchPool(descs, mesh=_cpu_mesh(4), cap=128).match_pairs(pairs)
    idx_l, ok_l = dist_matching.MatchPool(descs, cap=128, device="cpu").match_pairs(pairs)
    np.testing.assert_array_equal(ok_m, ok_l)
    np.testing.assert_array_equal(idx_m, idx_l)
    assert ok_m.shape[0] == len(pairs)
    assert ok_m.any(axis=1).all()
    idx_j, ok_j = dist_matching_j.MatchPool(descs, mesh=cpu_mesh((4,), ("work",)), cap=128).match_pairs(pairs)
    np.testing.assert_array_equal(ok_m, np.asarray(ok_j))
    np.testing.assert_array_equal(idx_m[ok_m], np.asarray(idx_j)[ok_m])


# -------------------------------------------------------------------- stereo

# test_stereo.py's sharded-stereo scene: 4 views, 32 depths, 3 sources
_DENSE = dict(max_image_size=max(H, W), num_depths=32, num_src_images=3)


def _depth(ws, i):
    return np.load(os.path.join(ws, "stereo", "depth_maps", f"v{i}.png.npy"))


@pytest.fixture(scope="module")
def port_sharded(tmp_path_factory):
    """The port's stereo (both passes) on the scene over 4 CPU shards."""
    rec, images, ws = _workspaces(tmp_path_factory.mktemp("sharded"), rec_t)
    n = mvs_t.run_patch_match_stereo(ws, mvs_t.DenseOptions(**_DENSE), rec=rec, images=images,
                                     mesh=_cpu_mesh(4))
    return n, ws


def test_dense_sharded_matches_sequential(tmp_path, port_sharded):
    """test_stereo.py's twin at its bar: each view's sharded depth map
    within 1e-3 of the sequential one at > 99% of the pixels; and, as the
    port pads nothing, equal to it exactly."""
    n2, ws_sh = port_sharded
    rec, images, ws_seq = _workspaces(tmp_path, rec_t)
    n1 = mvs_t.run_patch_match_stereo(ws_seq, mvs_t.DenseOptions(**_DENSE), rec=rec, images=images, device="cpu")
    assert n1 == n2 == 4
    for i in range(1, 5):
        agree = np.abs(_depth(ws_seq, i) - _depth(ws_sh, i)) < 1e-3
        assert agree.mean() > 0.99, agree.mean()
        np.testing.assert_array_equal(_depth(ws_seq, i), _depth(ws_sh, i))


def test_dense_sharded_matches_jax(tmp_path, port_sharded):
    """The port's sharded depth maps against the JAX package's sharded ones
    on the same scene: identical on >= 99% of each view's pixels, the bar
    of tests/test_torch_stereo.py against JAX."""
    _, ws_t = port_sharded
    rec, images, ws_j = _workspaces(tmp_path, rec_j)
    n = mvs_j.run_patch_match_stereo(ws_j, mvs_j.DenseOptions(**_DENSE), rec=rec, images=images,
                                     mesh=cpu_mesh((4,), ("work",)))
    assert n == 4
    for i in range(1, 5):
        same = (_depth(ws_t, i) == _depth(ws_j, i)).mean()
        assert same >= 0.99, (i, same)


def test_dense_sharded_pads_the_batch(tmp_path):
    """4 views on 3 shards: a group of 3 views, then a last group of one,
    and no padding of the batch; every view's depth equals the sequential
    run's."""
    opts = mvs_t.DenseOptions(max_image_size=max(H, W), num_depths=8, num_src_images=3)
    maps = {}
    for label, kw in (("seq", dict(device="cpu")), ("sh", dict(mesh=_cpu_mesh(3)))):
        rec, images, ws = _workspaces(tmp_path / label, rec_t)
        assert mvs_t.run_patch_match_stereo(ws, opts, rec=rec, images=images, **kw) == 4
        maps[label] = [_depth(ws, i) for i in range(1, 5)]
    for a, b in zip(maps["seq"], maps["sh"]):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------- dry run


def test_dryrun_multichip_on_four_cpu_shards():
    """The counterpart of __graft_entry__.dryrun_multichip: sharded matching,
    a mapper round with every BA solve distributed, a stereo fan-out."""
    out = dryrun.dryrun_multichip(4, device="cpu")
    assert out == {"registered": 3, "points": out["points"], "mesh": 4}
    assert out["points"] > 0
