"""The port's twins of the JAX package's controller tests:
tests/test_checkpoint.py (pose priors, snapshot and resume, GPS),
tests/test_multi_model.py (initialization gates and retries, several models,
the manager, the watermark test) and tests/test_batch_ba.py (whole-map BA),
with those tests' bars, on `synthetic_torch` worlds and the CPU. Where the
answer is deterministic (the pose PLY, clone_skeleton, the manager's files,
the watermark cases, the GPS conversions, the resumed mapper's inputs) the
port is also held to the JAX package on the same inputs. Last, the CLI's
own resume: `mapper` with snapshots, then `mapper --input_path`."""

import math
import os

import numpy as np
import pytest
import torch

import synthetic
import synthetic_torch
from colmap_pcd_tpu import cli as cli_j
from colmap_pcd_tpu.models import reconstruction as reconstruction_j
from colmap_pcd_tpu.models import reconstruction_manager as manager_j
from colmap_pcd_tpu.models import two_view as two_view_j
from colmap_pcd_tpu.utils import gps as gps_j
from colmap_pcd_tpu_torch import cli
from colmap_pcd_tpu_torch.models import two_view
from colmap_pcd_tpu_torch.models.controllers import (
    BundleAdjustmentController,
    ControllerOptions,
    IncrementalMapperController,
)
from colmap_pcd_tpu_torch.models.database import Database
from colmap_pcd_tpu_torch.models.incremental_mapper import IncrementalMapper, MapperOptions
from colmap_pcd_tpu_torch.models.reconstruction import (
    Image,
    Reconstruction,
    load_image_poses,
    save_image_poses,
)
from colmap_pcd_tpu_torch.models.reconstruction_manager import (
    ReconstructionManager,
    clone_skeleton,
)
from colmap_pcd_tpu_torch.models.triangulator import TriangulatorOptions
from colmap_pcd_tpu_torch.ops import np_geom
from colmap_pcd_tpu_torch.utils import gps

from synthetic_torch import ate_rmse, make_world

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

CPU = "cpu"


def _lidar_opts(**kw):
    return MapperOptions(
        if_add_lidar_constraint=True, init_image_id1=1, init_image_id2=2,
        abs_pose_min_num_inliers=15, init_min_num_inliers=50, num_ransac_hypotheses=1024, **kw,
    )


def _classic_opts(**kw):
    base = dict(
        if_add_lidar_constraint=False,
        if_add_lidar_corresponding=False,
        init_image_id1=-1,
        init_image_id2=-1,
        abs_pose_min_num_inliers=15,
        init_min_num_inliers=30,
        init_min_tri_angle=1.0,
        init_max_forward_motion=2.0,  # corridor world moves forward
        num_ransac_hypotheses=1024,
    )
    base.update(kw)
    return MapperOptions(**base)


def _controller(rec, graph, opts, lmap=None, priors=None, **copts):
    return IncrementalMapperController(
        rec, graph, opts, ControllerOptions(verbose=False, **copts),
        lidar_map=lmap, pose_priors=priors, device=CPU,
    )


# ------------------------------------------------------------- checkpoints
def test_pose_ply_roundtrip(rng, tmp_path):
    """save_image_poses -> load_image_poses keeps each registered pose and
    skips the unregistered image's nan row; the file is the JAX package's
    byte for byte."""
    rec, _, _, gt = make_world(rng, n_images=5, n_points=200)
    rec_j = reconstruction_j.Reconstruction()
    for i, (q, t) in enumerate(gt, 1):
        rec.images[i].qvec = q
        rec.images[i].tvec = t
        rec_j.add_image(reconstruction_j.Image(i, f"{i}", 1, q, t))
        if i != 3:  # leave one unregistered -> nan row
            rec.register_image(i)
            rec_j.register_image(i)
    path, path_j = str(tmp_path / "pose.ply"), str(tmp_path / "pose_j.ply")
    save_image_poses(path, rec)
    reconstruction_j.save_image_poses(path_j, rec_j)
    assert open(path).read() == open(path_j).read()
    loaded = load_image_poses(path)
    assert 3 not in loaded  # nan row skipped
    for i in (1, 2, 4, 5):
        q, t = loaded[i]
        assert float(np_geom.angle_between(q, gt[i - 1][0])) < 1e-3
        np.testing.assert_allclose(t, gt[i - 1][1], atol=1e-3)


def test_pose_ply_reference_convention(tmp_path):
    """A pose.ply row imports with the reference's convention (LoadPose,
    controllers/incremental_mapper.cc:953-976): R_wc = Ry(-yaw)Rx(-pitch)Rz(roll)
    in radians, as init_pose_from_options implements it for the init flags;
    the JAX package reads the same pose."""
    x, y, z = 1.5, -0.7, 0.3
    roll, pitch, yaw = 0.1, -0.25, 0.8  # radians
    path = str(tmp_path / "pose.ply")
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 1\n")
        for prop in ("x", "y", "z", "roll", "pitch", "yaw"):
            f.write(f"property float {prop}\n")
        f.write("end_header\n")
        f.write(f"{x} {y} {z} {roll} {pitch} {yaw}\n")
    q, t = load_image_poses(path)[1]
    q_j, t_j = reconstruction_j.load_image_poses(path)[1]
    np.testing.assert_array_equal(q, q_j)
    np.testing.assert_array_equal(t, t_j)

    def rot(axis, a):  # the reference's LoadPose math, independently
        c, s = math.cos(a), math.sin(a)
        if axis == "x":
            return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        if axis == "y":
            return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    R_cw = (rot("y", -yaw) @ rot("x", -pitch) @ rot("z", roll)).T
    np.testing.assert_allclose(np_geom.quat_to_rotmat(q), R_cw, atol=1e-9)
    np.testing.assert_allclose(t, -R_cw @ np.array([-y, -z, x]), atol=1e-9)

    # init flags with the same (degree-converted) values give the same pose
    flags = dict(init_image_x=x, init_image_y=y, init_image_z=z, init_image_roll=math.degrees(roll),
                 init_image_pitch=math.degrees(pitch), init_image_yaw=math.degrees(yaw))
    mapper = IncrementalMapper.__new__(IncrementalMapper)
    q2, t2 = IncrementalMapper.init_pose_from_options(mapper, MapperOptions(**flags))
    assert float(np_geom.angle_between(q, q2)) < 1e-6
    np.testing.assert_allclose(t, t2, atol=1e-9)

    # save -> load round-trip preserves the pose exactly
    q3, t3 = np_geom.lidar_pose_to_cam(*np_geom.cam_pose_to_lidar(q, t))
    assert float(np_geom.angle_between(q, q3)) < 1e-9
    np.testing.assert_allclose(t, t3, atol=1e-9)


def test_snapshot_and_resume(rng, tmp_path):
    """Reconstruct partially, write the model, reload it, and continue
    (mapper --input_path semantics, the model rebuilt by hand)."""
    rec, graph, lmap, gt = make_world(rng, n_images=8, n_points=600, noise_px=0.3)
    opts = _lidar_opts()
    ctl = _controller(rec, graph, opts, lmap, {1: gt[0]})
    assert ctl.initialize()
    for _ in range(2):  # register two more images, then snapshot
        nxt = ctl.mapper.find_next_images(opts)
        assert nxt
        assert ctl.mapper.register_next_image(opts, nxt[0])
        ctl.mapper.triangulator.triangulate_image(TriangulatorOptions(), nxt[0])
        ctl.iterative_local_refinement(nxt[0])
    snap = str(tmp_path / "snap")
    rec.write(snap)
    n_before = rec.num_reg_images
    assert n_before >= 4

    rec2 = Reconstruction.read(snap)
    # re-attach unregistered images (snapshot stores registered only)
    for iid, img in rec.images.items():
        if iid not in rec2.images:
            rec2.add_image(Image(iid, img.name, img.camera_id, xys=img.xys.copy()))
        else:
            rec2.images[iid].xys = img.xys.copy()
    ctl2 = _controller(rec2, graph, opts, lmap, {1: gt[0]})
    assert ctl2.reconstruct()
    assert rec2.num_reg_images > n_before
    assert ate_rmse(rec2, gt) < 0.12


def test_gps_conversions():
    ecef = gps.lla_to_ecef(0.0, 0.0, 0.0)  # equator, prime meridian
    np.testing.assert_allclose(ecef, [6378137.0, 0, 0], atol=1e-3)
    enu = gps.lla_to_enu(0.001, 0.0, 0.0, 0.0, 0.0, 0.0)  # ~111 m per 0.001 deg north
    assert abs(enu[1] - 110.57) < 1.0, enu
    assert abs(enu[0]) < 1e-6
    enu = gps.lla_to_enu(0.0, 0.001, 0.0, 0.0, 0.0, 0.0)  # east
    assert abs(enu[0] - 111.3) < 1.0, enu
    enu = gps.lla_to_enu(0.0, 0.0, 5.0, 0.0, 0.0, 0.0)  # up
    np.testing.assert_allclose(enu[2], 5.0, atol=1e-6)
    # away from the axes, the JAX package's numbers exactly
    lla = (47.3769, 8.5417, 408.0)
    np.testing.assert_array_equal(gps.lla_to_ecef(*lla), gps_j.lla_to_ecef(*lla))
    args = (47.3771, 8.5421, 411.5, *lla)
    np.testing.assert_array_equal(gps.lla_to_enu(*args), gps_j.lla_to_enu(*args))


# -------------------------------------------------------------- multi-model
def test_forward_motion_gate_rejects_corridor():
    """With the reference default init_max_forward_motion=0.95, every pair of
    the forward-moving corridor fails verification -> no init pair found."""
    rec, graph, _, _ = make_world(np.random.default_rng(3), n_images=5, n_points=400, noise_px=0.2)
    mapper = IncrementalMapper(rec, graph, device=CPU)
    assert mapper.find_initial_image_pair(_classic_opts(init_max_forward_motion=0.95)) == (-1, -1)


def test_init_search_accepts_with_relaxed_gate():
    rec, graph, _, _ = make_world(np.random.default_rng(3), n_images=5, n_points=400, noise_px=0.2)
    mapper = IncrementalMapper(rec, graph, device=CPU)
    id1, id2 = mapper.find_initial_image_pair(_classic_opts())
    assert id1 > 0 and id2 > 0
    # the verified geometry is cached for register_initial_image_pair
    assert mapper._prev_init_geometry is not None


def test_relaxation_recovers_from_strict_inliers():
    """run() halves init_min_num_inliers when no model is produced
    (controllers/incremental_mapper.cc:466-489)."""
    rec, graph, _, _ = make_world(np.random.default_rng(5), n_images=6, n_points=500, noise_px=0.2)
    max_m = max(graph.num_matches(i, j) for i in range(1, 7) for j in range(i + 1, 7))
    ctl = _controller(rec, graph, _classic_opts(init_min_num_inliers=int(1.6 * max_m)), min_model_size=3)
    manager = ctl.run()
    assert manager.size() >= 1
    assert ctl.rec.num_reg_images >= 4


def _two_components(shift=100):
    """Two disconnected worlds in one reconstruction + graph."""
    rec1, graph1, _, _ = make_world(np.random.default_rng(9), n_images=5, n_points=450, noise_px=0.2)
    rec2, graph2, _, _ = make_world(np.random.default_rng(13), n_images=5, n_points=450, noise_px=0.2)
    for iid, im in sorted(rec2.images.items()):
        rec1.add_image(Image(iid + shift, f"b_{im.name}", im.camera_id, xys=im.xys.copy()))
        graph1.add_image(iid + shift, im.xys.shape[0])
    for i in sorted(rec2.images):
        for j in sorted(rec2.images):
            m = graph2.matches_between(i, j)
            if j > i and len(m):
                graph1.add_matches(i + shift, j + shift, np.asarray(m, np.int32))
    return rec1, graph1


def test_multi_model_disconnected_components():
    """A database with two disconnected components yields two models
    (max_num_models / min_model_size, :887-901)."""
    rec, graph = _two_components()
    manager = _controller(rec, graph, _classic_opts(), min_model_size=3).run()
    assert manager.size() == 2, manager.size()
    sizes = sorted(m.num_reg_images for m in manager)
    assert sizes[0] >= 3 and sizes[1] >= 3, sizes
    ids_a = set(manager.get(0).registered_ids)  # disjoint image id ranges
    ids_b = set(manager.get(1).registered_ids)
    assert not (ids_a & ids_b)
    assert (max(ids_a) < 100) != (max(ids_b) < 100)


def test_single_model_option_stops_after_first():
    rec, graph = _two_components()
    manager = _controller(rec, graph, _classic_opts(), min_model_size=3, multiple_models=False).run()
    assert manager.size() == 1


def test_clone_skeleton_is_fresh():
    """A fresh skeleton with deep-copied keypoints, as the JAX package's
    clone of the same world."""
    rec, _, _, _ = make_world(np.random.default_rng(2), n_images=4, n_points=300, noise_px=0.2)
    rec_j, _, _, _ = synthetic.make_world(np.random.default_rng(2), n_images=4, n_points=300, noise_px=0.2)
    rec.images[1].registered = True
    out = clone_skeleton(rec)
    out_j = manager_j.clone_skeleton(rec_j)
    assert set(out.images) == set(rec.images) == set(out_j.images)
    assert out.num_reg_images == 0
    assert not out.points3D
    for iid, im in out.images.items():
        np.testing.assert_array_equal(im.xys, out_j.images[iid].xys)
        np.testing.assert_array_equal(im.point3D_ids, out_j.images[iid].point3D_ids)
    for cid, cam in out.cameras.items():
        np.testing.assert_array_equal(cam.params, out_j.cameras[cid].params)
    out.images[2].xys[0, 0] = -1.0
    assert rec.images[2].xys[0, 0] != -1.0  # deep-copied keypoints


def test_reconstruction_manager_basics(tmp_path):
    """add/get/best/write/delete; the written model is the JAX package's
    manager's byte for byte."""
    man, man_j = ReconstructionManager(), manager_j.ReconstructionManager()
    rec, _, _, gt = make_world(np.random.default_rng(2), n_images=3, n_points=200, noise_px=0.2)
    rec_j, _, _, _ = synthetic.make_world(np.random.default_rng(2), n_images=3, n_points=200, noise_px=0.2)
    for r in (rec, rec_j):
        for i, (q, t) in enumerate(gt, 1):
            r.images[i].qvec, r.images[i].tvec = q, t
            r.register_image(i)
    idx = man.add(rec)
    man_j.add(rec_j)
    assert man.size() == 1 and man.get(idx) is rec
    man.add()
    man_j.add()
    assert man.best_index() == man_j.best_index() == 0
    man.write(str(tmp_path / "t"))
    man_j.write(str(tmp_path / "j"))
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "t" / "0" / name).read_bytes() == (tmp_path / "j" / "0" / name).read_bytes()
    man.delete(1)
    assert man.size() == 1


def _watermark_case(case):
    rng = np.random.default_rng(0)
    n, w = 200, 1000
    if case == "border translation":  # a strip along the bottom edge
        uv1 = np.column_stack([rng.uniform(0, w, n), rng.uniform(w - 40, w - 1, n)])
        return uv1, uv1 + np.array([1.5, -0.5]), True
    if case == "centre points":
        uv1 = np.column_stack([rng.uniform(300, 700, n), rng.uniform(300, 700, n)])
        return uv1, uv1 + np.array([1.5, -0.5]), False
    uv1 = np.column_stack([rng.uniform(0, w, n), rng.uniform(0, 40, n)])  # non-rigid border
    return uv1, uv1 + rng.uniform(-30, 30, (n, 2)), False


@pytest.mark.parametrize("case", ["border translation", "centre points", "non-rigid border"])
def test_detect_watermark(case):
    uv1, uv2, expect = _watermark_case(case)
    mask = np.ones(len(uv1), bool)
    got = two_view.detect_watermark(uv1, uv2, mask, (1000, 1000), (1000, 1000))
    assert got == two_view_j.detect_watermark(uv1, uv2, mask, (1000, 1000), (1000, 1000)) == expect


# ------------------------------------------------------------ whole-map BA
def test_whole_map_ba_with_intrinsics_refinement(rng):
    rec, graph, lmap, gt = make_world(rng, n_images=6, n_points=500, noise_px=0.3)
    opts = _lidar_opts()
    assert _controller(rec, graph, opts, lmap, {1: gt[0]}).reconstruct()
    ate0 = ate_rmse(rec, gt)
    # corrupt the focal length by 1%, then whole-map BA with refinement;
    # the forward corridor makes joint pose + focal refinement a dolly zoom,
    # so the poses are trusted (refine_extrinsics=False)
    cam = rec.cameras[1]
    true_f = cam.params[0]
    cam.params = cam.params.copy()
    cam.params[:2] *= 1.01
    bac = BundleAdjustmentController(
        rec, opts, lidar_map=lmap, refine_intrinsics=True, refine_extrinsics=False, device=CPU
    )
    assert bac.run()
    f_out = rec.cameras[1].params[0]
    assert abs(f_out - true_f) / true_f < 0.005, (f_out, true_f)
    assert ate_rmse(rec, gt) < max(0.12, ate0 * 1.5)  # trajectory untouched


def test_whole_map_ba_no_lidar_gauge(rng):
    rec, graph, lmap, gt = make_world(rng, n_images=5, n_points=400, noise_px=0.2)
    assert _controller(rec, graph, _lidar_opts(), lmap, {1: gt[0]}).reconstruct()
    # batch BA without lidar: the classic gauge (first pose + a tvec component fixed)
    opts2 = MapperOptions(if_add_lidar_constraint=False, if_add_lidar_corresponding=False)
    assert BundleAdjustmentController(rec, opts2, lidar_map=None, device=CPU).run()
    assert rec.mean_reprojection_error() < 1.0


# ------------------------------------------------------------ the CLI resume
_CLI_FLAGS = (
    "--Mapper.abs_pose_min_num_inliers", "15",
    "--Mapper.init_min_num_inliers", "50",
    "--Mapper.multiple_models", "0",
)


def test_cli_mapper_resumes_from_snapshot(tmp_path):
    """`mapper` writes snapshots every 3 registrations; the one holding the
    fewest images (by its registered count read back, not by folder name)
    is resumed with `mapper --input_path`, the same lidar map and pose
    prior. The resumed mapper's inputs are the JAX package's (cameras, the
    model's images with every database keypoint in database order, their
    points); the resumed model grows past the snapshot and meets
    test_cli_mapper_lidar_world's bars."""
    rec, graph, lmap, gt = make_world(np.random.default_rng(7), n_images=8, n_points=600, noise_px=0.3)
    paths = synthetic_torch.write_world(rec, graph, lmap, gt, str(tmp_path))
    snap = tmp_path / "snapshots"
    argv = synthetic_torch.mapper_argv(paths, str(tmp_path / "full"), *_CLI_FLAGS, "--device", "cpu",
                                       "--Mapper.snapshot_path", str(snap),
                                       "--Mapper.snapshot_images_freq", "3")
    assert cli.main(argv) == 0
    snaps = {d: Reconstruction.read(str(snap / d)).num_reg_images for d in os.listdir(snap)}
    start = min(snaps, key=snaps.get)
    assert 3 <= snaps[start] < 7, snaps
    model = str(snap / start)

    # the resumed mapper's inputs, as both packages load them
    _, load_argv = cli._split(synthetic_torch.mapper_argv(paths, "", *_CLI_FLAGS)[1:], "output_path")
    om, _ = cli._opt(load_argv)
    om_j, _ = cli_j._opt(load_argv)
    rec_t, graph_t, _, priors_t = cli._load_mapper_inputs(om, model, CPU)
    rec_j, graph_j, _, priors_j = cli_j._load_mapper_inputs(om_j, model)
    db = Database(paths["database"])
    assert set(rec_t.images) == set(rec_j.images) == set(db.images())
    assert sorted(rec_t.registered_ids) == sorted(rec_j.registered_ids)
    assert len(rec_t.registered_ids) == snaps[start]
    for iid, im in rec_t.images.items():
        kp = db.read_keypoints(iid)
        np.testing.assert_array_equal(im.xys, kp[:, :2].astype(np.float64))
        np.testing.assert_array_equal(im.xys, rec_j.images[iid].xys)
        np.testing.assert_array_equal(im.point3D_ids, rec_j.images[iid].point3D_ids)
    db.close()
    for cid, cam in rec_t.cameras.items():
        np.testing.assert_array_equal(cam.params, rec_j.cameras[cid].params)
    assert sorted(graph_t.image_pairs()) == sorted(graph_j.image_pairs())
    assert set(priors_t) == set(priors_j) == {1}

    out = tmp_path / "resumed"
    argv = synthetic_torch.mapper_argv(paths, str(out), *_CLI_FLAGS, "--device", "cpu",
                                       "--input_path", model)
    assert cli.main(argv) == 0
    res = Reconstruction.read(str(out / "0"))
    assert res.num_reg_images > snaps[start]
    assert res.num_reg_images >= 7, res.num_reg_images
    assert ate_rmse(res, gt) < 0.10
    assert synthetic_torch.scale_error(res, gt) < 0.02
