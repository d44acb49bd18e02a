"""The port's feature extraction pipeline on files (CPU): the twins of
tests/test_pipeline.py::test_extract_and_match and
tests/test_overlap.py::test_overlapped_frontend_matches_sequential, both
packages' extractors and importers on the same files, the CLI commands in
an interpreter without JAX, and the path from rendered pixels to a
lidar-registered model."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import synthetic_torch
from colmap_pcd_tpu.models import feature_pipeline as fp_j
from colmap_pcd_tpu.models.database import Database as DatabaseJ
from colmap_pcd_tpu.utils.config import SiftExtractionConfig as ExtractJ
from colmap_pcd_tpu_torch import cli
from colmap_pcd_tpu_torch.models import feature_pipeline as fp_t
from colmap_pcd_tpu_torch.models.database import Database
from colmap_pcd_tpu_torch.models.overlap import run_overlapped_frontend
from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction
from colmap_pcd_tpu_torch.ops import camera_models as cm
from colmap_pcd_tpu_torch.utils.config import SiftExtractionConfig, SiftMatchingConfig

from test_sift import make_texture

torch.set_num_threads(1)  # the suite runs several workers on few cores

REPO = pathlib.Path(__file__).resolve().parents[1]

EXTRACT_KW = dict(max_num_features=512, first_octave=0, num_octaves=3, max_image_size=512)
EXTRACT = SiftExtractionConfig(**EXTRACT_KW)
MATCH = SiftMatchingConfig(min_num_inliers=10)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """test_pipeline.py's four overlapping 256x256 crops of one texture."""
    from PIL import Image as PILImage

    big = make_texture(np.random.default_rng(3), H=420, W=640, n_blobs=400)
    d = tmp_path_factory.mktemp("imgs")
    for i in range(4):
        crop = big[i * 40 : i * 40 + 256, i * 60 : i * 60 + 256]
        PILImage.fromarray((crop * 255).astype(np.uint8)).save(d / f"im{i:02d}.png")
    return str(d)


def test_numerics_policy_is_set_on_import():
    """The extractor's one matrix product, and any convolution a later
    change may bring, must not run in TF32."""
    import colmap_pcd_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_extract_and_match(image_dir, tmp_path):
    dbp = str(tmp_path / "test.db")
    assert fp_t.run_feature_extractor(dbp, image_dir, EXTRACT, device="cpu") == 4
    db = Database(dbp)
    imgs = db.images()
    assert len(imgs) == 4
    for iid in imgs:
        kp = db.read_keypoints(iid)
        desc = db.read_descriptors(iid)
        assert kp.shape[0] == desc.shape[0]
        assert kp.shape[0] > 50, kp.shape
        assert desc.dtype == np.uint8
    db.close()

    n_pairs = fp_t.run_sequential_matcher(dbp, MATCH, overlap=2, quadratic_overlap=False, device="cpu")
    assert n_pairs >= 3, n_pairs
    db = Database(dbp)
    assert db.read_matches(1, 2).shape[0] > 30
    g = db.read_two_view_geometry(1, 2)
    assert g is not None and len(g["inlier_matches"]) > 20
    db.close()


def test_overlapped_frontend_matches_sequential(image_dir, tmp_path):
    """The overlapped frontend must produce the same verified pairs as the
    sequential extractor -> matcher pipeline."""
    db_seq = str(tmp_path / "seq.db")
    fp_t.run_feature_extractor(db_seq, image_dir, EXTRACT, device="cpu")
    fp_t.run_sequential_matcher(db_seq, MATCH, overlap=3, quadratic_overlap=False, device="cpu")
    db = Database(db_seq)
    seq_pairs = {
        (i, j): len(db.read_two_view_geometry(i, j)["inlier_matches"])
        for i, j in db.all_two_view_pair_ids()
    }
    db.close()

    feed, t_extract, t_match = run_overlapped_frontend(
        str(tmp_path / "ovl.db"), image_dir, EXTRACT, MATCH, overlap=3, quadratic_overlap=False,
        device="cpu",
    )
    t_extract.join(timeout=300)
    t_match.join(timeout=300)
    assert not t_extract.is_alive() and not t_match.is_alive()
    assert feed.done and feed.error is None
    imgs, cams, pairs = feed.drain()
    assert len(imgs) == 4
    assert len(cams) == 1
    got = {(i, j): len(m) for i, j, m in pairs}
    # identical inputs -> identical matcher output
    assert got == seq_pairs
    assert feed.extract_s > 0 and feed.match_busy_s > 0


def test_extractor_error_reaches_the_caller(tmp_path):
    """An unreadable image raises from run_feature_extractor instead of
    hanging the staged pipeline, and closes the database."""
    d = tmp_path / "imgs"
    d.mkdir()
    (d / "broken.png").write_bytes(b"not a png")
    with pytest.raises(Exception):
        fp_t.run_feature_extractor(str(tmp_path / "x.db"), str(d), EXTRACT, device="cpu")
    assert fp_t.run_feature_extractor(str(tmp_path / "y.db"), str(tmp_path / "none"), EXTRACT) == 0


def test_mixed_shapes_and_resize(tmp_path):
    """Images of different shapes in one batch go through one by one; an
    image above max_image_size is resized and its keypoints scaled back."""
    from PIL import Image as PILImage

    tex = make_texture(np.random.default_rng(5), H=300, W=300, n_blobs=120)
    d = tmp_path / "imgs"
    d.mkdir()
    PILImage.fromarray((tex[:256, :256] * 255).astype(np.uint8)).save(d / "a.png")
    PILImage.fromarray((tex[:200, :240] * 255).astype(np.uint8)).save(d / "b.png")
    PILImage.fromarray((tex * 255).astype(np.uint8)).resize((600, 600)).save(d / "c.png")
    cfg = SiftExtractionConfig(max_num_features=256, first_octave=0, num_octaves=2, max_image_size=300)
    dbp = str(tmp_path / "m.db")
    assert fp_t.run_feature_extractor(dbp, str(d), cfg, device="cpu") == 3
    db = Database(dbp)
    assert [c["width"] for c in db.cameras().values()] == [256, 240, 600]
    kp_c = db.read_keypoints(3)
    # keypoints of the resized image are in original pixels
    assert kp_c.shape[0] > 30 and kp_c[:, 0].max() > 300
    db.close()


def _partner_share(kp_a, kp_b):
    d, j = cKDTree(kp_b[:, :2]).query(kp_a[:, :2])
    return float(np.mean(d <= 0.01)), j, d <= 0.01


def test_extractor_parity_with_jax(image_dir, tmp_path):
    """Both packages' run_feature_extractor on the same PNGs: the same
    cameras and images rows, and keypoint sets that agree as the whole
    `extract` does in tests/test_torch_sift.py (>= 98% of each side's
    keypoints with a partner within 0.01 px; of the partners, >= 90% with
    the same uint8 descriptor within +-1 on >= 99% of its entries: the
    crops hold exactly symmetric blobs, whose orientation 1e-6 in the
    pyramid decides; measured 0.945 to 0.97 per image)."""
    db_j, db_t = str(tmp_path / "jax.db"), str(tmp_path / "torch.db")
    assert fp_j.run_feature_extractor(db_j, image_dir, ExtractJ(**EXTRACT_KW)) == 4
    assert fp_t.run_feature_extractor(db_t, image_dir, EXTRACT, device="cpu") == 4
    dj, dt = DatabaseJ(db_j), Database(db_t)
    cams_j, cams_t = dj.cameras(), dt.cameras()
    assert cams_j.keys() == cams_t.keys()
    for cid in cams_j:
        for key in ("model_id", "width", "height", "prior_focal"):
            assert cams_j[cid][key] == cams_t[cid][key]
        np.testing.assert_array_equal(cams_j[cid]["params"], cams_t[cid]["params"])
    assert dj.images() == dt.images()
    for iid in dj.images():
        kp_j, kp_t = dj.read_keypoints(iid), dt.read_keypoints(iid)
        share, j, ok = _partner_share(kp_j, kp_t)
        back = _partner_share(kp_t, kp_j)[0]
        assert share >= 0.98 and back >= 0.98, (iid, share, back)
        d_j = dj.read_descriptors(iid)[ok].astype(np.int32)
        d_t = dt.read_descriptors(iid)[j[ok]].astype(np.int32)
        same = (np.abs(d_j - d_t) <= 1).mean(axis=1) >= 0.99
        assert same.mean() >= 0.90, (iid, same.mean())
        print(f"image {iid}: partners {share:.4f} / {back:.4f}, same descriptor {same.mean():.4f}")
    dj.close()
    dt.close()


def _write_feature_files(image_dir, import_dir, rng):
    os.makedirs(import_dir)
    for n, name in enumerate(sorted(os.listdir(image_dir))[:3]):
        num = 0 if n == 2 else 40 + n
        kp = rng.uniform(0, 255, (num, 4))
        desc = rng.integers(0, 256, (num, 128))
        with open(os.path.join(import_dir, name + ".txt"), "w") as f:
            f.write(f"{num} 128\n")
            for k, d in zip(kp, desc):
                f.write(" ".join(f"{v:.6f}" for v in k) + " " + " ".join(str(v) for v in d) + "\n")


def test_feature_importer_equals_jax(image_dir, tmp_path):
    """Host code only: both packages write byte-identical rows (an image
    without a feature file is skipped, an empty file gives empty blobs)."""
    import_dir = str(tmp_path / "feats")
    _write_feature_files(image_dir, import_dir, np.random.default_rng(9))
    db_j, db_t = str(tmp_path / "jax.db"), str(tmp_path / "torch.db")
    reader = dict(camera_model="SIMPLE_RADIAL", single_camera=False)
    n_j = fp_j.run_feature_importer(db_j, image_dir, import_dir, fp_j.ImageReaderConfig(**reader))
    n_t = fp_t.run_feature_importer(db_t, image_dir, import_dir, fp_t.ImageReaderConfig(**reader))
    assert n_j == n_t == 3
    dj, dt = DatabaseJ(db_j), Database(db_t)
    assert dj.images() == dt.images() and len(dt.images()) == 3
    assert len(dt.cameras()) == 3
    for cid, cam in dj.cameras().items():
        assert cam["model_id"] == dt.cameras()[cid]["model_id"]
        np.testing.assert_array_equal(cam["params"], dt.cameras()[cid]["params"])
    for table in ("keypoints", "descriptors"):
        rows_j = dj.conn.execute(f"SELECT image_id, rows, cols, data FROM {table} ORDER BY image_id").fetchall()
        rows_t = dt.conn.execute(f"SELECT image_id, rows, cols, data FROM {table} ORDER BY image_id").fetchall()
        assert rows_j == rows_t
    dj.close()
    dt.close()


def test_cli_extractor_and_importer_never_import_jax(image_dir, tmp_path):
    """`feature_extractor`, `sequential_matcher` on its database, and
    `feature_importer`, in a fresh interpreter where `import jax` fails."""
    import_dir = str(tmp_path / "feats")
    _write_feature_files(image_dir, import_dir, np.random.default_rng(9))
    db_e, db_i = str(tmp_path / "extract.db"), str(tmp_path / "import.db")
    extract_argv = [
        "feature_extractor", "--database_path", db_e, "--image_path", image_dir,
        "--ImageReader.camera_model", "PINHOLE", "--ImageReader.camera_params", "300,300,128,128",
        "--SiftExtraction.max_num_features", "512", "--SiftExtraction.first_octave", "0",
        "--SiftExtraction.num_octaves", "3", "--SiftExtraction.max_image_size", "512",
    ]
    match_argv = ["sequential_matcher", "--database_path", db_e, "--SequentialMatching.overlap", "2",
                  "--SiftMatching.min_num_inliers", "10"]
    import_argv = ["feature_importer", "--database_path", db_i, "--image_path", image_dir,
                   "--import_path", import_dir]
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from colmap_pcd_tpu_torch import cli\n"
        f"assert cli.main({extract_argv!r}) == 0\n"
        f"assert cli.main({match_argv!r}) == 0\n"
        f"rc = cli.main({import_argv!r})\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'colmap_pcd_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None), 'jax imported'\n"
        "sys.exit(rc)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Extracted features for 4 images" in proc.stdout
    assert "Imported features for 3 images" in proc.stdout
    db = Database(db_e)
    cam = db.cameras()[1]
    assert cam["model_id"] == 1 and cam["prior_focal"]
    np.testing.assert_array_equal(cam["params"], [300, 300, 128, 128])
    assert len(db.all_two_view_pair_ids()) >= 3
    db.close()


@pytest.mark.parametrize("make,model", [
    ("Canon", "Canon EOS 5D Mark III"), ("NIKON CORPORATION", "NIKON D750"), ("canon", "EOS-5D-Mark-II"),
    ("Apple", "iPhone 8"), ("Acme", "Model9000"), ("", ""),
])
def test_carried_camera_database_answers_as_the_original(make, model):
    from colmap_pcd_tpu.utils import camera_database as cdb_j
    from colmap_pcd_tpu_torch.utils import camera_database as cdb_t

    assert cdb_t.query_sensor_width(make, model) == cdb_j.query_sensor_width(make, model)


def test_carried_image_utils_and_exif_focal(tmp_path):
    """imread_gray(_u8), resize_max and exif_focal_length of the port equal
    the JAX package's on the same file."""
    from PIL import ExifTags
    from PIL import Image as PILImage

    from colmap_pcd_tpu.utils import camera_database as cdb_j
    from colmap_pcd_tpu.utils import image as image_j
    from colmap_pcd_tpu_torch.utils import camera_database as cdb_t
    from colmap_pcd_tpu_torch.utils import image as image_t

    tex = (make_texture(np.random.default_rng(2), H=90, W=120, n_blobs=30) * 255).astype(np.uint8)
    exif = PILImage.Exif()
    exif[ExifTags.IFD.Exif] = {41989: 50}  # FocalLengthIn35mmFilm
    path = str(tmp_path / "a.jpg")
    PILImage.fromarray(np.stack([tex, tex // 2, tex // 3], -1)).save(path, exif=exif)
    np.testing.assert_array_equal(image_t.imread_gray_u8(path), image_j.imread_gray_u8(path))
    np.testing.assert_array_equal(image_t.imread_gray(path), image_j.imread_gray(path))
    np.testing.assert_array_equal(image_t.imread_rgb(path), image_j.imread_rgb(path))
    for img in (image_j.imread_gray_u8(path), image_j.imread_gray(path)):
        for size in (64, 200):
            got, ref = image_t.resize_max(img, size), image_j.resize_max(img, size)
            np.testing.assert_array_equal(got[0], ref[0])
            assert got[1] == ref[1] and got[0].dtype == ref[0].dtype
    assert cdb_t.exif_focal_length(path, 120, 90) == cdb_j.exif_focal_length(path, 120, 90) == pytest.approx(50 / 35 * 120)
    # the extractor takes the EXIF focal as the camera's prior
    dbp = str(tmp_path / "exif.db")
    cfg = SiftExtractionConfig(max_num_features=64, first_octave=0, num_octaves=2, max_image_size=200)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    os.rename(path, img_dir / "a.jpg")
    assert fp_t.run_feature_extractor(dbp, str(img_dir), cfg, fp_t.ImageReaderConfig("SIMPLE_PINHOLE"), device="cpu") == 1
    db = Database(dbp)
    cam = db.cameras()[1]
    db.close()
    assert cam["prior_focal"] and cam["params"][0] == pytest.approx(50 / 35 * 120)
    np.testing.assert_array_equal(cam["params"][1:], [60.0, 45.0])


def test_drain_feed_updates_graph_and_visibility():
    """Twin of tests/test_overlap.py::test_drain_feed_updates_graph_and_visibility:
    the controller ingests streamed images and pairs and replays late
    matches into the visibility ranking (a late image must register)."""
    from colmap_pcd_tpu_torch.models.controllers import ControllerOptions, IncrementalMapperController
    from colmap_pcd_tpu_torch.models.correspondence_graph import CorrespondenceGraph
    from colmap_pcd_tpu_torch.models.incremental_mapper import MapperOptions
    from colmap_pcd_tpu_torch.models.overlap import PairFeed

    rec_full, graph_full, lmap, gt = synthetic_torch.make_world(
        np.random.default_rng(3), n_images=6, n_points=400
    )
    rec = Reconstruction()
    for c in rec_full.cameras.values():
        rec.add_camera(c)
    graph = CorrespondenceGraph()
    for iid, img in rec_full.images.items():
        if iid != 6:
            rec.add_image(img)
            graph.add_image(iid, img.xys.shape[0])
    for i, j in graph_full.image_pairs():
        if 6 not in (i, j):
            graph.add_matches(i, j, graph_full.matches_between(i, j))

    feed = PairFeed()
    opts = MapperOptions(
        if_add_lidar_constraint=True, init_image_id1=1, init_image_id2=2,
        abs_pose_min_num_inliers=15, init_min_num_inliers=50, num_ransac_hypotheses=1024,
    )
    ctl = IncrementalMapperController(
        rec, graph, opts, ControllerOptions(verbose=False),
        lidar_map=lmap, pose_priors={1: gt[0]}, pair_feed=feed,
    )
    img6 = rec_full.images[6]
    feed.push_image(6, img6.name, img6.camera_id, img6.xys)
    for i, j in graph_full.image_pairs():
        if 6 in (i, j):
            feed.push_pair(i, j, graph_full.matches_between(i, j))
    feed.mark_done()
    assert feed.wait_for_images(1, timeout=1.0) and feed.n_pairs_verified > 0

    assert ctl.reconstruct()
    assert rec.num_reg_images == 6
    assert rec.images[6].registered


def test_pipeline_map_surfaces_errors_of_each_stage():
    """A failing producer, device stage or writer raises on the caller's
    thread, and a dead writer cannot block the bounded queue for ever."""
    from colmap_pcd_tpu_torch.utils.threading_utils import pipeline_map

    seen = []
    pipeline_map(range(20), lambda i: i * 2, lambda i, r: seen.append((i, r)), lambda i, d: d + 1,
                 num_io_threads=3, queue_size=2)
    assert seen == [(i, 2 * i + 1) for i in range(20)]

    def boom(*_):
        raise ValueError("boom")

    for kw in (dict(produce=boom), dict(device_stage=boom), dict(consume=boom)):
        stages = dict(produce=lambda i: i, consume=lambda i, r: None, device_stage=lambda i, d: d)
        stages.update(kw)
        with pytest.raises(ValueError, match="boom"):
            pipeline_map(range(30), stages["produce"], stages["consume"], stages["device_stage"],
                         num_io_threads=2, queue_size=2)


# --------------------------------------------------------- pixels -> model
_MAPPER_FLAGS = (
    "--Mapper.init_min_num_inliers", "40", "--Mapper.abs_pose_min_num_inliers", "12",
    "--Mapper.abs_pose_min_inlier_ratio", "0.15", "--Mapper.filter_max_reproj_error", "6.0",
    "--Mapper.multiple_models", "0",
)


def _pixels_to_model(tmp_path, n_images, width, height, focal, features, model="PINHOLE", dist=()):
    """Render the corridor, then `feature_extractor`, `sequential_matcher`
    and the lidar `mapper` through cli.main on the files. Returns the model
    and the ground truth."""
    params = [focal, focal, width / 2, height / 2, *dist]
    gt = synthetic_torch.make_trajectory(n_images)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    synthetic_torch.render_images(
        str(img_dir), gt, width, height, focal,
        model_id=None if not dist else cm.MODEL_IDS[model], params=params if dist else None,
    )
    pts, nrm = synthetic_torch.build_corridor_map(np.random.default_rng(0), length=n_images * 0.8 + 25)
    paths = synthetic_torch.write_lidar_files(pts, nrm, gt, str(tmp_path))
    paths["database"] = str(tmp_path / "db.db")
    assert cli.main([
        "feature_extractor", "--database_path", paths["database"], "--image_path", str(img_dir),
        "--ImageReader.camera_model", model,
        "--ImageReader.camera_params", ",".join(repr(float(p)) for p in params),
        "--SiftExtraction.max_num_features", str(features), "--SiftExtraction.first_octave", "0",
        "--SiftExtraction.num_octaves", "3", "--SiftExtraction.max_image_size", str(width),
    ]) == 0
    assert cli.main([
        "sequential_matcher", "--database_path", paths["database"],
        "--SequentialMatching.overlap", "3", "--SiftMatching.min_num_inliers", "15",
    ]) == 0
    db = Database(paths["database"])
    assert len(db.all_two_view_pair_ids()) >= n_images - 1
    db.close()
    out = tmp_path / "out"
    assert cli.main(synthetic_torch.mapper_argv(paths, str(out), *_MAPPER_FLAGS)) == 0
    return Reconstruction.read(str(out / "0")), gt


def test_pixels_to_model_small(tmp_path):
    """Five 320x240 views from pixels to a lidar-registered model."""
    rec, gt = _pixels_to_model(tmp_path, 5, 320, 240, 250.0, 1024)
    assert rec.num_reg_images >= 4, rec.num_reg_images
    ate = synthetic_torch.ate_rmse(rec, gt)
    assert ate < 0.25, f"ATE {ate:.3f} m"


@pytest.mark.slow
def test_full_stack_from_pixels(tmp_path):
    """Twin of tests/test_full_stack.py::test_full_stack_from_pixels."""
    rec, gt = _pixels_to_model(tmp_path, 6, 640, 480, 500.0, 2048)
    assert rec.num_reg_images >= 5, rec.num_reg_images
    ate = synthetic_torch.ate_rmse(rec, gt)
    print(f"pixels->model PINHOLE: {rec.num_reg_images}/6 registered, ATE {ate:.4f} m")
    assert ate < 0.25, f"ATE {ate:.3f} m"


@pytest.mark.slow
def test_full_stack_from_pixels_opencv(tmp_path):
    """Twin of test_full_stack_from_pixels_opencv: render, keypoints, PnP,
    triangulation, depth projection and BA through the OPENCV distortion."""
    rec, gt = _pixels_to_model(
        tmp_path, 6, 640, 480, 500.0, 2048, model="OPENCV", dist=(-0.12, 0.05, 0.001, -0.0005)
    )
    assert rec.num_reg_images >= 5, rec.num_reg_images
    ate = synthetic_torch.ate_rmse(rec, gt)
    print(f"pixels->model OPENCV: {rec.num_reg_images}/6 registered, ATE {ate:.4f} m")
    assert ate < 0.25, f"ATE {ate:.3f} m"
