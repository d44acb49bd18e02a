"""The matching slice end to end on the CPU: the port's matcher commands
against the JAX package's on copies of one synthetic database, and the
port's classic (lidar-free) mapper on matcher-written geometries."""

import shutil

import numpy as np
import pytest
import torch

import synthetic_torch
from colmap_pcd_tpu.models import feature_pipeline as pipeline_j
from colmap_pcd_tpu.utils.config import SiftMatchingConfig as MatchingConfigJ
from colmap_pcd_tpu_torch import cli
from colmap_pcd_tpu_torch.models import feature_pipeline as pipeline_t
from colmap_pcd_tpu_torch.models.database import Database
from colmap_pcd_tpu_torch.models.reconstruction import Reconstruction
from colmap_pcd_tpu_torch.utils.config import SiftMatchingConfig as MatchingConfigT

torch.set_num_threads(1)  # tier-1 runs several workers on few cores


def _world(tmp_path, seed, n_images, n_points, noise_px=0.3):
    rec, graph, lmap, gt, desc, point_ids = synthetic_torch.make_descriptor_world(
        np.random.default_rng(seed), n_images=n_images, n_points=n_points, noise_px=noise_px
    )
    paths = synthetic_torch.write_world(rec, graph, lmap, gt, str(tmp_path), descriptors=desc)
    return paths, gt, point_ids


def test_unported_matcher_options_raise(tmp_path):
    """Every matcher option is ported now (loop detection through
    retrieval): on an empty database the loop-detecting sequential matcher
    verifies nothing on the CPU, and without a device it asks for CUDA,
    which raises where there is none instead of falling back to the CPU."""
    assert pipeline_t.run_feature_extractor(str(tmp_path / "db.db"), str(tmp_path), device="cpu") == 0
    assert pipeline_t.run_sequential_matcher(str(tmp_path / "db.db"), MatchingConfigT(), loop_detection=True,
                                             device="cpu") == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pipeline_t.run_sequential_matcher(str(tmp_path / "db.db"), MatchingConfigT(), loop_detection=True)


def test_sequential_matcher_matches_jax(tmp_path):
    """Both packages' run_sequential_matcher on copies of one database of 7
    images with ~300 keypoints each: raw matches identical except at most
    0.5% of rows (near-ties), the same pairs verify, inlier counts within
    5% per pair (RANSAC draws differ: torch.Generator vs jax.random)."""
    paths, _, point_ids = _world(tmp_path, 5, 7, 420)
    db_t = paths["database"]
    db_j = str(tmp_path / "jax.db")
    shutil.copy(db_t, db_j)
    n_t = pipeline_t.run_sequential_matcher(db_t, MatchingConfigT(), overlap=3, device="cpu")
    n_j = pipeline_j.run_sequential_matcher(db_j, MatchingConfigJ(), overlap=3)
    assert n_t == n_j > 0
    dt, dj = Database(db_t), Database(db_j)
    try:
        assert sorted(dt.all_two_view_pair_ids()) == sorted(dj.all_two_view_pair_ids())
        rows = differ = 0
        for i, j in dj.all_two_view_pair_ids():
            mt = {tuple(r) for r in dt.read_matches(i, j)}
            mj = {tuple(r) for r in dj.read_matches(i, j)}
            rows += len(mj)
            differ += len(mt ^ mj)
            nt = len(dt.read_two_view_geometry(i, j)["inlier_matches"])
            nj = len(dj.read_two_view_geometry(i, j)["inlier_matches"])
            assert abs(nt - nj) <= 0.05 * nj, (i, j, nt, nj)
        assert differ <= 0.005 * rows, (differ, rows)
    finally:
        dt.close()
        dj.close()
    pr = synthetic_torch.match_precision_recall(db_t, point_ids)
    assert pr["precision"] > 0.99 and pr["recall"] > 0.9, pr


def test_classic_mapper_on_matcher_geometries(tmp_path):
    """`sequential_matcher` then `mapper` without a lidar map on
    test_e2e_classic_no_lidar's world (6 images, 0.2 px, init pair (1, 3)),
    with its bars: >= 5 registered, median reprojection error < 1 px."""
    paths, gt, _ = _world(tmp_path, 11, 6, 500, noise_px=0.2)
    argv = ["sequential_matcher", "--database_path", paths["database"],
            "--SequentialMatching.overlap", "5", "--device", "cpu"]
    assert cli.main(argv) == 0
    out = tmp_path / "out"
    assert cli.main(synthetic_torch.classic_mapper_argv(
        paths, str(out), (1, 3), "--Mapper.init_min_tri_angle", "2",
        "--Mapper.init_min_num_inliers", "30", "--Mapper.abs_pose_min_num_inliers", "15",
        "--Mapper.multiple_models", "0", "--device", "cpu",
    )) == 0
    rec = Reconstruction.read(str(out / "0"))
    assert rec.num_reg_images >= 5, rec.num_reg_images
    rec.update_point_errors()
    errs = [p.error for p in rec.points3D.values() if p.error >= 0]
    assert np.median(errs) < 1.0, np.median(errs)


def _verified(database):
    db = Database(database)
    try:
        return {p: len(db.read_two_view_geometry(*p)["inlier_matches"]) for p in db.all_two_view_pair_ids()}
    finally:
        db.close()


def test_exhaustive_and_transitive_matchers(tmp_path):
    """exhaustive_matcher verifies every overlapping pair of a 4-image
    world; transitive_matcher, run after a sequential pass of overlap 1,
    closes the graph to the same pairs."""
    paths, _, _ = _world(tmp_path, 3, 4, 300)
    db_seq = str(tmp_path / "seq.db")
    shutil.copy(paths["database"], db_seq)
    assert cli.main(["exhaustive_matcher", "--database_path", paths["database"], "--device", "cpu"]) == 0
    full = _verified(paths["database"])
    assert sorted(full) == [(i, j) for i in range(1, 5) for j in range(i + 1, 5)]
    assert pipeline_t.run_sequential_matcher(db_seq, MatchingConfigT(), overlap=1,
                                             quadratic_overlap=False, device="cpu") == 3
    assert cli.main(["transitive_matcher", "--database_path", db_seq, "--device", "cpu"]) == 0
    assert sorted(_verified(db_seq)) == sorted(full)


@pytest.mark.parametrize("match_type", ["pairs", "raw", "inliers"])
def test_matches_importer(tmp_path, match_type):
    """matches_importer: a list of image pairs to match, raw feature-index
    matches to verify, or inlier matches taken as verified."""
    paths, _, point_ids = _world(tmp_path, 4, 3, 300)
    names = {1: "img0001.png", 2: "img0002.png", 3: "img0003.png"}
    listing = tmp_path / "list.txt"
    if match_type == "pairs":
        listing.write_text("img0001.png img0002.png\nimg0002.png img0003.png\n")
    else:
        blocks = []
        for i, j in ((1, 2), (2, 3)):
            a, b = point_ids[i], point_ids[j]
            common = np.intersect1d(a[a >= 0], b[b >= 0])
            rows = [f"{np.nonzero(a == p)[0][0]} {np.nonzero(b == p)[0][0]}" for p in common]
            blocks.append("\n".join([f"{names[i]} {names[j]}"] + rows))
        listing.write_text("\n\n".join(blocks) + "\n")
    argv = ["matches_importer", "--database_path", paths["database"],
            "--match_list_path", str(listing), "--match_type", match_type, "--device", "cpu"]
    assert cli.main(argv) == 0
    verified = _verified(paths["database"])
    assert sorted(verified) == [(1, 2), (2, 3)]
    assert min(verified.values()) > 100


def test_guided_matching_takes_the_per_pair_path(tmp_path):
    """guided_matching=True matches pair by pair and re-matches guided by
    F, as in the JAX package: the same pairs verify as on the batched path,
    with at least as many inliers."""
    paths, _, point_ids = _world(tmp_path, 6, 4, 300)
    db_guided = str(tmp_path / "guided.db")
    shutil.copy(paths["database"], db_guided)
    cfg = MatchingConfigT()
    assert pipeline_t.run_sequential_matcher(paths["database"], cfg, overlap=2, device="cpu") == 5
    guided = MatchingConfigT(guided_matching=True)
    assert pipeline_t.run_sequential_matcher(db_guided, guided, overlap=2, device="cpu") == 5
    plain, with_guide = _verified(paths["database"]), _verified(db_guided)
    assert sorted(plain) == sorted(with_guide)
    assert all(with_guide[p] >= plain[p] for p in plain)
    assert synthetic_torch.match_precision_recall(db_guided, point_ids)["precision"] > 0.99


@pytest.mark.parametrize("relaxed", [True, False])
def test_initial_pair_verification_matches_jax(relaxed):
    """estimate_initial_two_view_geometry on the classic world's pair
    (1, 3): both packages accept it with relaxed gates and reject it with
    the default forward-motion and triangulation-angle gates; an accepted
    geometry is cached for register_initial_image_pair."""
    import synthetic
    from colmap_pcd_tpu.models import incremental_mapper as mapper_j
    from colmap_pcd_tpu_torch.models import incremental_mapper as mapper_t

    kw = dict(init_max_forward_motion=1.0, init_min_tri_angle=1.0, init_min_num_inliers=30) if relaxed else {}
    verdicts = []
    for make_world, mapper in ((synthetic.make_world, mapper_j), (synthetic_torch.make_world, mapper_t)):
        rec, graph, _, _ = make_world(np.random.default_rng(11), n_images=6, n_points=500, noise_px=0.2)
        m = mapper.IncrementalMapper(rec, graph, **({"device": "cpu"} if mapper is mapper_t else {}))
        opts = mapper.MapperOptions(if_add_lidar_constraint=False, **kw)
        verdicts.append((m.estimate_initial_two_view_geometry(opts, 1, 3), m._prev_init_pair))
    assert verdicts[0] == verdicts[1] == ((True, (1, 3)) if relaxed else (False, None))


def test_batched_matcher_takes_the_uint8_path(tmp_path, monkeypatch):
    """The chunked matcher hands the database's uint8 descriptors and their
    inverse norms to match_descriptors_u8 (on a GPU: the tensor-core kernel)
    and never normalizes to float; guided matching keeps the float route."""
    from colmap_pcd_tpu_torch.ops import matching as matching_ops

    paths, _, point_ids = _world(tmp_path, 8, 4, 300)
    db_guided = str(tmp_path / "guided.db")
    shutil.copy(paths["database"], db_guided)
    calls = {"u8": 0, "float": 0}
    u8, flt = matching_ops.match_descriptors_u8, matching_ops.match_descriptors

    def count_u8(d1, d2, inv1, inv2, v1, v2, opts):
        assert d1.dtype == d2.dtype == torch.uint8 and inv1.dtype == torch.float32
        assert d1.shape[:2] == inv1.shape == v1.shape and d2.shape[:2] == inv2.shape == v2.shape
        # padding rows carry inverse norm 0 and are not valid
        assert bool(((inv1 > 0) == (v1 > 0)).all()) and bool(((inv2 > 0) == (v2 > 0)).all())
        calls["u8"] += 1
        return u8(d1, d2, inv1, inv2, v1, v2, opts)

    def count_float(*args):
        calls["float"] += 1
        return flt(*args)

    monkeypatch.setattr(matching_ops, "match_descriptors_u8", count_u8)
    monkeypatch.setattr(matching_ops, "match_descriptors", count_float)
    assert pipeline_t.run_sequential_matcher(paths["database"], MatchingConfigT(), overlap=2, device="cpu") == 5
    assert calls == {"u8": 1, "float": 0}  # 5 pairs, one chunk
    assert synthetic_torch.match_precision_recall(paths["database"], point_ids)["precision"] > 0.99
    guided = MatchingConfigT(guided_matching=True)
    assert pipeline_t.run_sequential_matcher(db_guided, guided, overlap=2, device="cpu") == 5
    assert calls == {"u8": 1, "float": 5}
