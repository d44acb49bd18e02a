"""The port's CLI beyond the mapping path: the twins of tests/test_cli.py and
tests/test_model_formats.py's command tests, each through the port's
`cli.main(..., "--device", "cpu")` with the same asserts; the device rule
(CUDA unless the CPU is asked for by name); and the new commands in an
interpreter where `import jax` fails."""

import base64
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

import synthetic_torch
from colmap_pcd_tpu_torch import cli
from colmap_pcd_tpu_torch.io import ply as ply_io
from colmap_pcd_tpu_torch.models.database import Database
from colmap_pcd_tpu_torch.models.reconstruction import Camera, Image, LidarAssoc, Point3D, Reconstruction
from colmap_pcd_tpu_torch.ops import np_geom

from test_sift import make_texture

torch.set_num_threads(1)  # the suite runs several workers on few cores

REPO = pathlib.Path(__file__).resolve().parents[1]


def run(*argv) -> int:
    return cli.main([*argv, "--device", "cpu"])


# ------------------------------------------------------- registry + device
def test_cli_help_lists_the_ported_commands(capsys):
    assert cli.main([]) == 0
    listed = capsys.readouterr().out.split("commands:")[1].strip().split(", ")
    assert len(listed) == 43 and "bundle_adjuster" in listed and "hierarchical_mapper" in listed
    for cmd in ("vocab_tree_matcher", "vocab_tree_builder", "vocab_tree_retriever", "rig_bundle_adjuster",
                "patch_match_stereo", "stereo_fusion", "poisson_mesher", "delaunay_mesher"):
        assert cmd in listed
    for cmd in ("poisson_mesher", "delaunay_mesher"):  # without their paths: the usage line
        assert run(cmd) == 1
        assert "usage" in capsys.readouterr().out
    assert cli.main(["frobnicate"]) == 1


def test_cli_device_rule(tmp_path, capsys):
    """Without `--device cpu` a command computes on CUDA, so on a machine
    without CUDA it raises instead of falling back to the CPU; the flag is
    taken from anywhere on the line."""
    _, d = _toy_model(tmp_path, np.random.default_rng(0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["model_analyzer", "--path", d])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["model_analyzer", "--path", d, "--device", "cuda"])
    assert cli.main(["model_analyzer", "--device", "cpu", "--path", d]) == 0
    assert "registered_images: 6" in capsys.readouterr().out
    with pytest.raises(ValueError, match="cuda or cpu"):
        cli.main(["model_analyzer", "--path", d, "--device", "tpu"])


# ------------------------------------------------- twins of tests/test_cli.py
@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """test_pipeline.py's four overlapping 256x256 crops of one texture."""
    big = make_texture(np.random.default_rng(3), H=420, W=640, n_blobs=400)
    d = tmp_path_factory.mktemp("imgs")
    for i in range(4):
        crop = big[i * 40 : i * 40 + 256, i * 60 : i * 60 + 256]
        PILImage.fromarray((crop * 255).astype(np.uint8)).save(d / f"im{i:02d}.png")
    return str(d)


def test_cli_workflow(image_dir, tmp_path):
    dbp = str(tmp_path / "w.db")
    assert run(
        "feature_extractor", "--database_path", dbp, "--image_path", image_dir,
        "--SiftExtraction.max_num_features", "512", "--SiftExtraction.first_octave", "0",
        "--SiftExtraction.num_octaves", "3", "--SiftExtraction.max_image_size", "512",
    ) == 0
    assert run("exhaustive_matcher", "--database_path", dbp, "--SiftMatching.min_num_inliers", "10") == 0
    db = Database(dbp)
    assert len(db.all_two_view_pair_ids()) >= 3
    db.close()


def test_cli_model_roundtrip(tmp_path, capsys):
    rec = Reconstruction()
    rec.add_camera(Camera(1, 1, 640, 480, np.asarray([500.0, 500, 320, 240])))
    im = Image(1, "a.png", 1, xys=np.asarray([[10.0, 10.0], [20.0, 20.0]]))
    rec.add_image(im)
    rec.add_image(Image(2, "b.png", 1, xys=np.asarray([[11.0, 10.0], [21.0, 20.0]])))
    rec.register_image(1)
    rec.register_image(2)
    rec.add_point3D([0, 0, 5.0], [(1, 0), (2, 0)])
    model_dir = str(tmp_path / "model")
    rec.write(model_dir)
    rec2 = Reconstruction.read(model_dir)
    assert len(rec2.points3D) == 1 and rec2.images[1].name == "a.png"
    np.testing.assert_allclose(rec2.images[1].xys, im.xys)

    txt_dir = str(tmp_path / "txt")
    assert run("model_converter", "--input_path", model_dir, "--output_path", txt_dir, "--output_type", "TXT") == 0
    assert len(Reconstruction.read(txt_dir).points3D) == 1
    ply = str(tmp_path / "m.ply")
    assert run("model_converter", "--input_path", model_dir, "--output_path", ply, "--output_type", "PLY") == 0
    assert os.path.exists(ply)
    assert run("model_analyzer", "--path", model_dir) == 0
    assert "registered_images: 2" in capsys.readouterr().out


def _centers_model(tmp_path, rng, n):
    rec = Reconstruction()
    rec.add_camera(Camera(1, 1, 640, 480, np.asarray([500.0, 500, 320, 240])))
    centers = rng.normal(size=(n, 3)) * 3
    for i, c in enumerate(centers, 1):
        rec.add_image(Image(i, f"i{i}.png", 1, tvec=-c))  # identity rotation: t = -C
        rec.register_image(i)
    d = str(tmp_path / "in")
    rec.write(d)
    return centers, d


def test_cli_model_aligner_transformer(tmp_path):
    centers, d = _centers_model(tmp_path, np.random.default_rng(0), 5)
    ref = str(tmp_path / "refs.txt")
    with open(ref, "w") as f:
        for i, c in enumerate(centers, 1):
            x, y, z = 2 * c + [1, 2, 3]
            f.write(f"i{i}.png {x} {y} {z}\n")
    out = str(tmp_path / "out")
    # the robust path needs a positive max_error (reference exe/model.cc:307)
    assert run("model_aligner", "--input_path", d, "--output_path", out, "--ref_images_path", ref) == 1
    assert run("model_aligner", "--input_path", d, "--output_path", out, "--ref_images_path", ref,
               "--robust_alignment_max_error", "0.5") == 0
    rec2 = Reconstruction.read(out)
    for i, c in enumerate(centers, 1):
        np.testing.assert_allclose(rec2.images[i].projection_center(), 2 * c + [1, 2, 3], atol=1e-2)
    assert run("model_aligner", "--input_path", d, "--output_path", out, "--ref_images_path", ref,
               "--robust_alignment", "0") == 0
    # model_transformer with the same similarity as a 3x4 text file
    M = np.concatenate([2.0 * np.eye(3), [[1.0], [2.0], [3.0]]], 1)
    tf = str(tmp_path / "sim.txt")
    np.savetxt(tf, M)
    out2 = str(tmp_path / "out2")
    assert run("model_transformer", "--input_path", d, "--output_path", out2, "--transform_path", tf) == 0
    rec3 = Reconstruction.read(out2)
    for i, c in enumerate(centers, 1):
        np.testing.assert_allclose(rec3.images[i].projection_center(), 2 * c + [1, 2, 3], atol=1e-4)


def test_cli_model_aligner_robust_outlier(tmp_path):
    """A single corrupt reference row must not corrupt the similarity fit
    (reference AlignRobust: RANSAC<SimilarityTransformEstimator>)."""
    centers, d = _centers_model(tmp_path, np.random.default_rng(0), 8)
    ref = str(tmp_path / "refs.txt")
    with open(ref, "w") as f:
        for i, c in enumerate(centers, 1):
            x, y, z = 2 * c + [1, 2, 3]
            if i == 3:  # gross outlier row
                x, y, z = 500.0, -900.0, 1234.0
            f.write(f"i{i}.png {x} {y} {z}\n")
    out = str(tmp_path / "out")
    assert run("model_aligner", "--input_path", d, "--output_path", out, "--ref_images_path", ref,
               "--robust_alignment_max_error", "0.5") == 0
    rec2 = Reconstruction.read(out)
    for i, c in enumerate(centers, 1):
        if i != 3:
            np.testing.assert_allclose(rec2.images[i].projection_center(), 2 * c + [1, 2, 3], atol=5e-2)


def test_cli_model_viewer(tmp_path):
    from colmap_pcd_tpu_torch.io.viewer import export_viewer_html

    rng = np.random.default_rng(0)
    rec = Reconstruction()
    rec.add_camera(Camera(1, 1, 640, 480, np.asarray([500.0, 500, 320, 240])))
    for i in range(1, 4):
        rec.add_image(Image(i, f"i{i}.png", 1, tvec=np.asarray([0.0, 0, -i]), xys=rng.uniform(0, 400, (20, 2))))
        rec.register_image(i)
    pts = rng.normal(size=(20, 3)) + [0, 0, 5]
    for k, x in enumerate(pts):
        pid = rec.add_point3D(x, [(1, k), (2, k)])
        if k < 5:
            n = np.asarray([0.0, 1.0, 0.0])
            rec.lidar_points[pid] = LidarAssoc(type=k % 3, point=x + 0.05,
                                               plane=np.asarray([*n, -np.dot(n, x + 0.05)]))
    d = str(tmp_path / "model")
    rec.write(d)
    lidar = str(tmp_path / "map.ply")
    ply_io.write_ply(lidar, rng.normal(size=(100, 3)).astype(np.float32), None, None)
    out = str(tmp_path / "viewer.html")
    assert run("model_viewer", "--input_path", d, "--output_path", out, "--lidar_path", lidar) == 0
    html = open(out).read()
    assert "webgl" in html
    payload = json.loads(re.search(r"const D=(\{.*?\});\n", html).group(1))
    assert payload["n_sfm"] == 20 and payload["n_cam"] == 3 * 8 * 2 and payload["n_lidar"] == 100
    assert payload["n_assoc"] == 0  # associations are not persisted in the model format
    xyz = np.frombuffer(base64.b64decode(payload["sfm_xyz"]), np.float32).reshape(-1, 3)
    np.testing.assert_allclose(xyz, pts.astype(np.float32), atol=1e-5)
    out2 = str(tmp_path / "viewer_assoc.html")
    export_viewer_html(rec, out2)
    payload2 = json.loads(re.search(r"const D=(\{.*?\});\n", open(out2).read()).group(1))
    assert payload2["n_assoc"] == 10
    seg = np.frombuffer(base64.b64decode(payload2["assoc_xyz"]), np.float32).reshape(-1, 2, 3)
    np.testing.assert_allclose(seg[:, 1] - seg[:, 0], 0.05, atol=1e-5)


def _toy_model(tmp_path, rng, n_images=6, n_points=40):
    """tests/test_cli.py's registered model with synthetic observations."""
    rec = Reconstruction()
    rec.add_camera(Camera(1, 1, 64, 48, np.asarray([50.0, 50.0, 32.0, 24.0])))
    pts = rng.normal(size=(n_points, 3)) * 0.5 + [0, 0, 5.0]
    for i in range(1, n_images + 1):
        t = np.asarray([0.1 * i, 0.0, 0.0])
        uv = (pts[:, :2] - t[None, :2]) / (pts[:, 2:]) * 50.0 + [32.0, 24.0]
        rec.add_image(Image(i, f"im{i:02d}.png", 1, tvec=-t, xys=uv))
        rec.register_image(i)
    for k in range(n_points):
        rec.add_point3D(pts[k], [(i, k) for i in range(1, n_images + 1)])
    d = str(tmp_path / "toy_model")
    rec.write(d)
    return rec, d


def test_cli_image_deleter(tmp_path):
    _, d = _toy_model(tmp_path, np.random.default_rng(0))
    ids = tmp_path / "ids.txt"
    ids.write_text("2\n99\n")
    names = tmp_path / "names.txt"
    names.write_text("im03.png\nnope.png\n")
    out = str(tmp_path / "out")
    assert run("image_deleter", "--input_path", d, "--output_path", out,
               "--image_ids_path", str(ids), "--image_names_path", str(names)) == 0
    rec2 = Reconstruction.read(out)
    assert rec2.num_reg_images == 4
    reg = {rec2.images[i].name for i in rec2.registered_ids}
    assert "im02.png" not in reg and "im03.png" not in reg


def test_cli_image_filterer(tmp_path):
    _, d = _toy_model(tmp_path, np.random.default_rng(0))
    out = str(tmp_path / "out")
    assert run("image_filterer", "--input_path", d, "--output_path", out, "--min_num_observations", "1000") == 0
    assert Reconstruction.read(out).num_reg_images == 0
    assert run("image_filterer", "--input_path", d, "--output_path", out, "--min_num_observations", "1") == 0
    assert Reconstruction.read(out).num_reg_images == 6


def test_cli_point_filtering(tmp_path):
    rec, d = _toy_model(tmp_path, np.random.default_rng(0))
    out = str(tmp_path / "out")
    assert run("point_filtering", "--input_path", d, "--output_path", out,
               "--max_reproj_error", "0.5", "--min_tri_angle", "0.0") == 0
    assert len(Reconstruction.read(out).points3D) <= len(rec.points3D)
    assert run("point_filtering", "--input_path", d, "--output_path", out, "--min_track_len", "100") == 0
    assert len(Reconstruction.read(out).points3D) == 0


def test_cli_project_generator(tmp_path):
    from colmap_pcd_tpu_torch.utils.config import OptionManager

    out = str(tmp_path / "project.ini")
    assert run("project_generator", "--output_path", out, "--quality", "low") == 0
    om = OptionManager()
    om.read_ini(out)
    assert om.sift_extraction.max_image_size == 1000
    assert run("project_generator", "--output_path", out, "--quality", "bogus") == 1
    assert run("project_generator", "--output_path", out, "--quality", "extreme") == 0
    om2 = OptionManager()
    om2.read_ini(out)
    assert om2.sift_extraction.domain_size_pooling is True


def test_cli_color_extractor(tmp_path):
    _, d = _toy_model(tmp_path, np.random.default_rng(0))
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i in range(1, 7):  # constant-colour images: every point gets that colour
        PILImage.fromarray(np.full((48, 64, 3), [10 * i, 20, 200], np.uint8)).save(img_dir / f"im{i:02d}.png")
    out = str(tmp_path / "out")
    assert run("color_extractor", "--image_path", str(img_dir), "--input_path", d, "--output_path", out) == 0
    colored = [p for p in Reconstruction.read(out).points3D.values() if p.color.any()]
    assert len(colored) > 0
    for p in colored:
        assert p.color[2] == 200


def test_cli_feature_importer(tmp_path, image_dir):
    dbp = str(tmp_path / "imp.db")
    import_dir = tmp_path / "feats"
    import_dir.mkdir()
    rng = np.random.default_rng(0)
    for name in sorted(os.listdir(image_dir)):
        n, dim = 20, 128
        rows = np.concatenate([rng.uniform(5, 250, size=(n, 2)), rng.uniform(1, 4, size=(n, 1)),
                               rng.uniform(0, 6.28, size=(n, 1)), rng.integers(0, 256, size=(n, dim))], axis=1)
        with open(import_dir / (name + ".txt"), "w") as f:
            f.write(f"{n} {dim}\n")
            np.savetxt(f, rows, fmt="%.3f")
    assert run("feature_importer", "--database_path", dbp, "--image_path", image_dir,
               "--import_path", str(import_dir)) == 0
    db = Database(dbp)
    assert len(db.images()) == 4
    for iid in db.images():
        assert db.read_keypoints(iid).shape[0] == 20
        assert db.read_descriptors(iid).shape == (20, 128)
    db.close()


def test_cli_image_undistorter_standalone(tmp_path):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    arr = (np.linspace(0, 255, 64 * 48 * 3).reshape(48, 64, 3)).astype(np.uint8)
    PILImage.fromarray(arr).save(img_dir / "a.png")
    lst = tmp_path / "cams.txt"
    lst.write_text("a.png OPENCV 50 50 32 24 0.1 -0.05 0.001 0.001\n")
    out = str(tmp_path / "und")
    assert run("image_undistorter_standalone", "--image_path", str(img_dir), "--input_file", str(lst),
               "--output_path", out) == 0
    assert os.path.exists(os.path.join(out, "a.png"))


def test_cli_image_rectifier(tmp_path):
    rng = np.random.default_rng(0)
    _, d = _toy_model(tmp_path, rng, n_images=2)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i in (1, 2):
        PILImage.fromarray(rng.uniform(0, 255, size=(48, 64, 3)).astype(np.uint8)).save(img_dir / f"im{i:02d}.png")
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("im01.png im02.png\n")
    out = str(tmp_path / "rect")
    assert run("image_rectifier", "--image_path", str(img_dir), "--input_path", d, "--output_path", out,
               "--stereo_pairs_list", str(pairs)) == 0
    assert os.path.exists(os.path.join(out, "im01-im02_1.png"))
    assert os.path.exists(os.path.join(out, "im01-im02_2.png"))


def test_rectification_row_alignment():
    """After rectification the same 3D point lands on the same image row in
    both views."""
    from colmap_pcd_tpu_torch.models.undistortion import rectify_stereo_cameras

    rng = np.random.default_rng(0)
    cam = Camera(1, 1, 640, 480, np.asarray([500.0, 500.0, 320.0, 240.0]))
    w = np.asarray([0.02, -0.03, 0.01])
    th = np.linalg.norm(w)
    q = np.concatenate([[np.cos(th / 2)], w / th * np.sin(th / 2)])
    t = np.asarray([1.0, 0.05, -0.02])
    H1, H2, _ = rectify_stereo_cameras(cam, cam, q, t)
    X = rng.normal(size=(50, 3)) * 2 + [0, 0, 10.0]
    X2 = X @ np_geom.quat_to_rotmat(q).T + t
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    p1 = (K @ X.T).T
    p2 = (K @ X2.T).T
    h1 = (H1 @ (p1 / p1[:, 2:]).T).T
    h2 = (H2 @ (p2 / p2[:, 2:]).T).T
    np.testing.assert_allclose(h1[:, 1] / h1[:, 2], h2[:, 1] / h2[:, 2], atol=1e-6)


def test_cli_image_registrator(tmp_path):
    """PnP-register database images into an existing model without running
    the mapper (RunImageRegistrator, exe/image.cc:239)."""
    from colmap_pcd_tpu_torch.models.controllers import ControllerOptions, IncrementalMapperController
    from colmap_pcd_tpu_torch.models.incremental_mapper import MapperOptions

    rec, graph, lmap, gt = synthetic_torch.make_world(np.random.default_rng(5), n_images=7, n_points=500)
    opts = MapperOptions(if_add_lidar_constraint=True, init_image_id1=1, init_image_id2=2,
                         abs_pose_min_num_inliers=15, init_min_num_inliers=50, num_ransac_hypotheses=1024)
    ctl = IncrementalMapperController(rec, graph, opts, ControllerOptions(verbose=False),
                                      lidar_map=lmap, pose_priors={1: gt[0]})
    assert ctl.reconstruct() and rec.num_reg_images == 7
    for iid in (6, 7):  # drop the last two images from the model, keep them in the database
        rec.deregister_image(iid)
    model_dir = str(tmp_path / "model")
    rec.write(model_dir)
    paths = synthetic_torch.write_world(rec, graph, lmap, gt, str(tmp_path))
    out_dir = str(tmp_path / "registered")
    assert run("image_registrator", "--database_path", paths["database"], "--input_path", model_dir,
               "--output_path", out_dir, "--Mapper.abs_pose_min_num_inliers", "15",
               "--Mapper.if_add_lidar_constraint", "0") == 0
    rec2 = Reconstruction.read(out_dir)
    assert rec2.num_reg_images == 7
    for iid in (6, 7):
        assert rec2.images[iid].registered
        np.testing.assert_allclose(rec2.images[iid].projection_center(),
                                   np_geom.projection_center(*gt[iid - 1]), atol=0.05)


# ---------------------------------- twin of tests/test_model_formats.py (CLI)
def test_cli_model_converter_formats(tmp_path):
    from test_torch_sfm_tools import _toy_model as formats_model

    rec = formats_model(Camera, Image, Reconstruction, n_images=4, n_points=25)
    d = str(tmp_path / "model")
    rec.write(d)
    nvm = str(tmp_path / "m.nvm")
    assert run("model_converter", "--input_path", d, "--output_path", nvm, "--output_type", "NVM") == 0
    out = str(tmp_path / "fromnvm")
    assert run("model_converter", "--input_path", nvm, "--output_path", out, "--output_type", "BIN") == 0
    assert Reconstruction.read(out).num_reg_images == 4
    assert run("model_converter", "--input_path", d, "--output_path", str(tmp_path / "b"),
               "--output_type", "BUNDLER") == 0
    assert os.path.exists(tmp_path / "b.bundle.out")
    assert run("model_converter", "--input_path", d, "--output_path", str(tmp_path / "camdir"),
               "--output_type", "CAM") == 0
    assert run("model_converter", "--input_path", d, "--output_path", str(tmp_path / "v.wrl"),
               "--output_type", "VRML") == 0
    assert os.path.exists(tmp_path / "v.points3D.wrl")


# --------------------------------------- the commands of the model tools
def test_cli_model_tools_commands(tmp_path, capsys, dense_run):
    """model_merger, model_cropper, model_splitter, model_comparer,
    model_orientation_aligner, database_creator/cleaner/merger, gui and
    the mesh of automatic_reconstructor --dense 1 (run by `dense_run`)."""
    rec, d = _toy_model(tmp_path, np.random.default_rng(1))
    out = tmp_path / "o"
    assert run("model_merger", "--input_path1", d, "--input_path2", d, "--output_path", str(out / "merged")) == 0
    assert Reconstruction.read(str(out / "merged")).num_reg_images == 6
    lo, hi = rec.compute_bounding_box()
    box = ",".join(str(v) for v in [*lo, *((np.asarray(lo) + np.asarray(hi)) / 2)])
    assert run("model_cropper", "--input_path", d, "--output_path", str(out / "crop"), "--boundary", box) == 0
    assert len(Reconstruction.read(str(out / "crop")).points3D) < len(rec.points3D)
    assert run("model_splitter", "--input_path", d, "--output_path", str(out / "split"), "--num_parts", "2",
               "--axis", "2") == 0
    assert sorted(os.listdir(out / "split")) == ["0", "1"]
    capsys.readouterr()
    assert run("model_comparer", "--input_path1", d, "--input_path2", str(out / "merged")) == 0
    assert "num_common_images: 6" in capsys.readouterr().out
    for method in ("image-orientation", "principal"):
        assert run("model_orientation_aligner", "--input_path", d, "--output_path", str(out / method),
                   "--method", method) == 0
        assert Reconstruction.read(str(out / method)).num_reg_images == 6
    assert run("model_orientation_aligner", "--input_path", d, "--output_path", str(out / "m")) == 1
    dbs = [str(tmp_path / f"{k}.db") for k in "abc"]
    assert run("database_creator", "--database_path", dbs[0]) == 0
    db = Database(dbs[1])
    cid = db.add_camera(1, 64, 48, [50.0, 50.0, 32.0, 24.0])
    for name in ("x.png", "y.png"):
        iid = db.add_image(name, cid)
        db.write_keypoints(iid, np.zeros((3, 4), np.float32))
        db.write_descriptors(iid, np.zeros((3, 128), np.uint8))
    db.write_matches(1, 2, np.asarray([[0, 1]], np.uint32))
    db.write_two_view_geometry(1, 2, np.asarray([[0, 1]], np.uint32), 2)
    db.commit()
    db.close()
    assert run("database_merger", "--database_path1", dbs[0], "--database_path2", dbs[1],
               "--merged_database_path", dbs[2]) == 0
    merged = Database(dbs[2])
    assert len(merged.images()) == 2 and len(merged.all_two_view_pair_ids()) == 1
    merged.close()
    assert run("database_cleaner", "--database_path", dbs[2], "--type", "matches") == 0
    merged = Database(dbs[2])
    assert len(merged.images()) == 2 and merged.all_two_view_pair_ids() == []
    merged.close()
    capsys.readouterr()
    assert run("gui") == 0
    assert "PyTorch package" in capsys.readouterr().out
    verts, faces = ply_io.read_ply_mesh(os.path.join(dense_run["auto"], "dense", "meshed-poisson.ply"))
    assert len(verts) > 100 and len(faces) > 100


# ------------------------------------- the new commands without JAX
def test_sfm_commands_never_import_jax(tmp_path):
    """`spatial_matcher`, `mapper`, `bundle_adjuster` with the lidar map,
    `model_aligner`, `image_undistorter` and `hierarchical_mapper` on a
    6-image descriptor world, in a fresh interpreter where `import jax`
    fails loudly."""
    rec, graph, lmap, gt, desc, _ = synthetic_torch.make_descriptor_world(
        np.random.default_rng(11), n_images=6, n_points=500, noise_px=0.2)
    paths = synthetic_torch.write_world(rec, graph, lmap, gt, str(tmp_path), descriptors=desc)
    centers = {rec.images[i].name: np_geom.projection_center(*gt[i - 1]) for i in rec.images}
    loc = tmp_path / "loc.txt"
    loc.write_text("".join(f"{n} {c[0]} {c[1]} {c[2]}\n" for n, c in centers.items()))
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for n in centers:
        PILImage.fromarray(np.full((48, 64, 3), 128, np.uint8)).save(img_dir / n)
    lidar = ["--Mapper.lidar_pointcloud_path", paths["lidar"]]
    flags = ["--Mapper.abs_pose_min_num_inliers", "15", "--Mapper.init_min_num_inliers", "50",
             "--Mapper.multiple_models", "0", "--device", "cpu"]
    model, out = str(tmp_path / "model"), str(tmp_path / "out")
    runs = [
        ["spatial_matcher", "--database_path", paths["database"], "--location_path", str(loc), "--device", "cpu"],
        synthetic_torch.mapper_argv(paths, model, *flags),
        ["bundle_adjuster", "--input_path", os.path.join(model, "0"), "--output_path", out + "/ba", *lidar,
         "--device", "cpu"],
        ["model_aligner", "--input_path", out + "/ba", "--output_path", out + "/aligned",
         "--ref_images_path", str(loc), "--robust_alignment_max_error", "0.05", "--device", "cpu"],
        ["image_undistorter", "--image_path", str(img_dir), "--input_path", out + "/aligned",
         "--output_path", out + "/dense", "--device", "cpu"],
        ["hierarchical_mapper", "--database_path", paths["database"], "--output_path", out + "/hier",
         "--leaf_max_num_images", "4", "--image_overlap", "2", *lidar[:2],
         "--Mapper.if_import_pose_prior", "1", "--Mapper.image_pose_prior_path", paths["poses"], *flags],
    ]
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from colmap_pcd_tpu_torch import cli\n"
        f"for argv in {runs!r}:\n"
        "    assert cli.main(argv) == 0, argv[0]\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'colmap_pcd_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None), 'jax imported'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Verified" in proc.stdout and "Bundle adjustment succeeded" in proc.stdout
    assert Reconstruction.read(out + "/aligned").num_reg_images >= 5
    assert len(os.listdir(out + "/dense/images")) >= 5
    assert Reconstruction.read(out + "/hier/0").num_reg_images >= 4


# ------------------------------------------- the dense commands without JAX
def _analytic_workspace(root) -> str:
    """tests/test_stereo.py's 4-view plane scene as files: 160x120 PNGs and
    a sparse model with a few plane points seen by every view."""
    from test_stereo import F as f, H as h, W as w, render_plane

    ws = root / "plane"
    (ws / "images").mkdir(parents=True)
    rec = Reconstruction()
    rec.add_camera(Camera(1, 1, w, h, np.asarray([f, f, w / 2, h / 2])))
    centers = [np.zeros(3), np.asarray([0.35, 0.0, 0.0]), np.asarray([0.0, 0.3, 0.0]), np.asarray([0.3, 0.3, 0.0])]
    for i, c in enumerate(centers, 1):
        rec.add_image(Image(i, f"v{i}.png", 1, xys=np.zeros((8, 2)), qvec=np.asarray([1.0, 0, 0, 0]), tvec=-c))
        rec.register_image(i)
        PILImage.fromarray((render_plane(c, 10.0) * 255).astype(np.uint8)).save(ws / "images" / f"v{i}.png")
    for k in range(6):
        rec.add_point3D(np.asarray([(k % 3 - 1) * 2.0, (k // 3 - 0.5) * 1.5, 10.0]), [(i, k) for i in range(1, 5)])
    rec.write(str(ws / "sparse"))
    return str(ws)


def _ring_workspace(root) -> str:
    """tests/test_meshing.py's Delaunay scene as a dense workspace: a sparse
    model of 8 cameras on a ring of radius 5 around 220 unit-sphere points
    (each seen by the 3 nearest), and fused.ply of 600 other sphere points."""
    rng = np.random.default_rng(0)
    rec = Reconstruction()
    rec.add_camera(Camera(1, 1, 640, 480, np.asarray([500.0, 500, 320, 240])))
    centers = {}
    for i in range(1, 9):
        a = 2 * np.pi * i / 8
        centers[i] = np.asarray([5 * np.cos(a), 0.2, 5 * np.sin(a)])
        rec.add_image(Image(i, f"v{i}.png", 1, xys=np.zeros((0, 2)), qvec=np.asarray([1.0, 0, 0, 0]),
                            tvec=-centers[i]))
        rec.register_image(i)
    u = rng.normal(size=(820, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    for k in range(220):
        near = sorted(centers, key=lambda i: np.linalg.norm(centers[i] - u[k]))[:3]
        rec.points3D[k + 1] = Point3D(xyz=u[k], track=[(i, 0) for i in near])
    ws = root / "ring"
    rec.write(str(ws / "sparse"))
    ply_io.write_ply(str(ws / "fused.ply"), u[220:].astype(np.float32), u[220:].astype(np.float32))
    return str(ws)


@pytest.fixture(scope="module")
def dense_run(tmp_path_factory):
    """In a fresh interpreter where `import jax` fails: automatic_reconstructor
    --dense 1 on four 320x240 views of the rendered corridor with the lidar
    mapper's flags (extraction, matching, mapping, then undistortion,
    stereo, fusion and the Poisson mesh), then the four dense commands by
    name: patch_match_stereo and stereo_fusion on the analytic 4-view
    workspace, poisson_mesher with its three flags on that cloud, and
    delaunay_mesher in dense and sparse mode with its two on the ring
    workspace."""
    root = tmp_path_factory.mktemp("dense_cli")
    n, w, h, f = 4, 320, 240, 250.0
    gt = synthetic_torch.make_trajectory(n)
    (root / "imgs").mkdir()
    synthetic_torch.render_images(str(root / "imgs"), gt, w, h, f)
    pts, nrm = synthetic_torch.build_corridor_map(np.random.default_rng(0), length=n * 0.8 + 25)
    paths = synthetic_torch.write_lidar_files(pts, nrm, gt, str(root))
    auto, plane, ring = str(root / "auto"), _analytic_workspace(root), _ring_workspace(root)
    mapper = synthetic_torch.mapper_argv(dict(paths, database=""), "")[3:-2]  # the lidar and prior flags
    cpu = ["--device", "cpu"]
    runs = [
        ["automatic_reconstructor", "--workspace_path", auto, "--image_path", str(root / "imgs"), "--dense", "1",
         "--ImageReader.camera_model", "PINHOLE", "--ImageReader.camera_params", f"{f},{f},{w / 2},{h / 2}",
         "--SiftExtraction.max_num_features", "1024", "--SiftExtraction.first_octave", "0",
         "--SiftExtraction.num_octaves", "3", "--Mapper.init_min_num_inliers", "40",
         "--Mapper.abs_pose_min_num_inliers", "12", "--Mapper.abs_pose_min_inlier_ratio", "0.15",
         "--Mapper.filter_max_reproj_error", "6.0", "--Mapper.multiple_models", "0", *mapper, *cpu],
        ["patch_match_stereo", "--workspace_path", plane, *cpu],
        ["stereo_fusion", "--workspace_path", plane, "--output_path", plane + "/fused.ply", *cpu],
        ["poisson_mesher", "--input_path", plane + "/fused.ply", "--output_path", plane + "/poisson.ply",
         "--PoissonMeshing.depth", "6", "--PoissonMeshing.trim", "5", "--PoissonMeshing.point_weight", "2", *cpu],
        ["delaunay_mesher", "--input_path", ring, "--output_path", ring + "/delaunay-dense.ply",
         "--DelaunayMeshing.quality_regularization", "0.5", "--DelaunayMeshing.visibility_sigma", "2", *cpu],
        ["delaunay_mesher", "--input_path", ring + "/sparse", "--output_path", ring + "/delaunay-sparse.ply",
         "--input_type", "sparse", *cpu],
    ]
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from colmap_pcd_tpu_torch import cli\n"
        f"for argv in {runs!r}:\n"
        "    assert cli.main(argv) == 0, argv[0]\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'colmap_pcd_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None), 'jax imported'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(root),
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {"auto": auto, "plane": plane, "ring": ring, "stdout": proc.stdout}


def test_dense_commands_never_import_jax(dense_run):
    auto, plane, ring, out = dense_run["auto"], dense_run["plane"], dense_run["ring"], dense_run["stdout"]
    assert Reconstruction.read(os.path.join(auto, "sparse", "0")).num_reg_images >= 3
    assert "Computed depth/normal maps for 4 views" in out
    for view in range(1, 5):
        for kind in ("depth_maps", "normal_maps", "cost_maps"):
            assert os.path.exists(os.path.join(plane, "stereo", kind, f"v{view}.png.npy"))
    fused = ply_io.read_ply(os.path.join(plane, "fused.ply"))
    assert len(fused.xyz) > 3000 and np.median(np.abs(fused.xyz[:, 2] - 10.0)) < 0.2
    for mesh in (plane + "/poisson.ply", ring + "/delaunay-dense.ply", ring + "/delaunay-sparse.ply"):
        verts, faces = ply_io.read_ply_mesh(mesh)
        assert len(faces) > 0, mesh


def test_dense_commands_take_colmap_widths(tmp_path, capsys):
    """patch_match_stereo and stereo_fusion take COLMAP's --PatchMatchStereo.*
    and --StereoFusion.* flags for DenseOptions' fields, and those whose
    values the plane sweep holds fixed at that value (another value, or a
    flag the port has no counterpart of, raises; without flags the defaults
    hold), and the widths reach the stage: the whole view (max_image_size
    -1), one pass kept under both names, a bank of 8 depths."""
    from colmap_pcd_tpu_torch.models.mvs import DenseOptions
    from test_stereo import F, H, W, render_plane

    assert cli._dense_options(["--workspace_path", "w"]) == (DenseOptions(), ["--workspace_path", "w"])
    opts, rest = cli._dense_options(["--PatchMatchStereo.window_radius", "5", "--workspace_path", "w",
                                     "--PatchMatchStereo.geom_consistency", "0",
                                     "--PatchMatchStereo.filter_min_num_consistent", "3",
                                     "--PatchMatchStereo.max_image_size", "-1",
                                     "--PatchMatchStereo.geom_consistency_regularizer", "0.3",
                                     "--PatchMatchStereo.geom_consistency_max_cost", "3",
                                     "--PatchMatchStereo.filter_min_ncc", "0.1", "--StereoFusion.max_depth_error",
                                     "0.01"])
    assert rest == ["--workspace_path", "w"]
    assert opts == DenseOptions(window_radius=5, geom_consistency=False, min_consistent=3, max_image_size=-1)
    with pytest.raises(ValueError, match="fixed at 0.01"):
        cli._dense_options(["--StereoFusion.max_depth_error", "0.02"])
    with pytest.raises(ValueError, match="unknown option"):
        cli._dense_options(["--PatchMatchStereo.num_samples", "15"])

    ws = tmp_path / "ws"
    rec = Reconstruction()
    rec.add_camera(Camera(1, 1, W, H, np.asarray([F, F, W / 2, H / 2])))
    os.makedirs(ws / "images")
    for i, c in enumerate([np.zeros(3), np.asarray([0.35, 0.0, 0.0]), np.asarray([0.0, 0.3, 0.0])], 1):
        rec.add_image(Image(i, f"v{i}.png", 1, qvec=np.asarray([1.0, 0, 0, 0]), tvec=-c, xys=np.zeros((4, 2))))
        rec.register_image(i)
        PILImage.fromarray((render_plane(c, 10.0) * 255).astype(np.uint8)).save(ws / "images" / f"v{i}.png")
    for k in range(4):
        rec.add_point3D(np.asarray([(k % 2 - 0.5) * 2.0, (k // 2 - 0.5) * 1.5, 10.0]), [(1, k), (2, k), (3, k)])
    rec.write(str(ws / "sparse"))
    assert run("patch_match_stereo", "--workspace_path", str(ws), "--PatchMatchStereo.max_image_size", "-1",
               "--PatchMatchStereo.num_depths", "8", "--PatchMatchStereo.window_radius", "2",
               "--PatchMatchStereo.geom_consistency", "false") == 0
    assert run("stereo_fusion", "--workspace_path", str(ws), "--output_path", str(ws / "fused.ply"),
               "--PatchMatchStereo.filter_min_num_consistent", "1") == 0
    out = capsys.readouterr().out
    assert "Computed depth/normal maps for 3 views" in out
    for i in (1, 2, 3):
        depth = np.load(ws / "stereo" / "depth_maps" / f"v{i}.png.npy")
        assert depth.shape == (H, W) and len(np.unique(depth)) <= 8
        np.testing.assert_array_equal(depth, np.load(ws / "stereo" / "depth_maps" / f"v{i}.png.photometric.npy"))
    fused = int(re.search(r"Fused (\d+) points", out).group(1))
    assert fused == len(ply_io.read_ply(str(ws / "fused.ply")).xyz) > 1000
