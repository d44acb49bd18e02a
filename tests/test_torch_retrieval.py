"""Retrieval in the port against the JAX package on the CPU: k-means, VLAD,
visual words, query rankings, vote-and-verify re-ranking, the vocab-tree
matcher and the sequential matcher's loop detection, and the retrieval
commands in an interpreter where `import jax` fails.

Both packages get the same inputs from numpy; the k-means init is the one
random draw, so the port is handed the JAX package's
`jax.random.choice(PRNGKey(seed), N, (k,), replace=False)` indices."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import synthetic_torch
from colmap_pcd_tpu.models import feature_pipeline as pipeline_j
from colmap_pcd_tpu.ops import retrieval as retrieval_j
from colmap_pcd_tpu.ops import vote_verify as vv_j
from colmap_pcd_tpu.utils.config import SiftMatchingConfig as MatchingConfigJ
from colmap_pcd_tpu_torch import convert
from colmap_pcd_tpu_torch.models import feature_pipeline as pipeline_t
from colmap_pcd_tpu_torch.models.database import Database
from colmap_pcd_tpu_torch.ops import retrieval as retrieval_t
from colmap_pcd_tpu_torch.ops import vote_verify as vv_t
from colmap_pcd_tpu_torch.utils.config import SiftMatchingConfig as MatchingConfigT

from test_retrieval_recall import _make_synthetic_descs, _repetitive_scene

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

REPO = pathlib.Path(__file__).resolve().parents[1]

# VLADs and centroids: f32 sums in another order (the port sums gathered
# residuals in one product, the JAX package an [N, k, D] tensor)
VLAD_ATOL = 1e-5
# the scene of test_vote_and_verify_scores_consistent_above_shuffled, at
# its own options
VV_OPTS = dict(max_image_size=512.0, max_transfer_error=15.0**2)


def _jax_init(n: int, k: int, seed: int = 0) -> torch.Tensor:
    return torch.as_tensor(np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (k,), replace=False)))


@pytest.fixture
def jax_kmeans_init(monkeypatch):
    """The port's build_index draws its k-means init as the JAX package
    does (the only random draw of an index)."""
    kmeans = retrieval_t.kmeans

    def with_jax_init(desc, k=64, iters=10, seed=0, init_idx=None):
        return kmeans(desc, k, iters, init_idx=_jax_init(desc.shape[0], k, seed))

    monkeypatch.setattr(retrieval_t, "kmeans", with_jax_init)


def _unit_train(descs):
    train = np.concatenate([descs[i] for i in sorted(descs)]).astype(np.float32)
    return train / np.maximum(np.linalg.norm(train, axis=1, keepdims=True), 1e-8)


def test_kmeans_vlad_and_words_match_jax():
    """Lloyd k-means from the same init: centroids within 1e-5; on those
    centroids VLAD (padded rows masked out) within 1e-5 and the words
    equal."""
    train = _unit_train(_make_synthetic_descs())
    cent_j = np.asarray(retrieval_j.kmeans(jax.numpy.asarray(train), jax.random.PRNGKey(0), k=16))
    cent_t = retrieval_t.kmeans(torch.as_tensor(train), k=16, init_idx=_jax_init(train.shape[0], 16))
    np.testing.assert_allclose(cent_t.numpy(), cent_j, atol=VLAD_ATOL)
    d = np.zeros((256, 128), np.float32)
    d[:120] = train[:120]
    v = np.zeros(256, np.float32)
    v[:120] = 1.0
    vlad_j = np.asarray(retrieval_j.vlad(jax.numpy.asarray(d), jax.numpy.asarray(v), jax.numpy.asarray(cent_j)))
    cent = torch.as_tensor(cent_j)
    vlad_t = retrieval_t.vlad(torch.as_tensor(d), torch.as_tensor(v), cent).numpy()
    np.testing.assert_allclose(vlad_t, vlad_j, atol=VLAD_ATOL)
    np.testing.assert_array_equal(
        retrieval_t.assign_words(torch.as_tensor(d), cent).numpy(),
        np.asarray(retrieval_j.assign_words(jax.numpy.asarray(d), jax.numpy.asarray(cent_j))),
    )


def test_query_rankings_match_jax(jax_kmeans_init):
    """test_vlad_recall_synthetic's scene with an image without descriptors
    added (its VLAD is zero and ties with every image): the port's own
    index within 1e-5 of the JAX package's and every image's full ranking
    equal, and so are the rankings of the JAX index carried across."""
    descs = _make_synthetic_descs()
    descs[17] = np.zeros((0, 128), np.float32)
    index_j = retrieval_j.build_index(descs, k=16)
    index_t = retrieval_t.build_index(descs, k=16, device="cpu")
    np.testing.assert_allclose(index_t.vlads.numpy(), index_j.vlads, atol=VLAD_ATOL)
    np.testing.assert_allclose(index_t.centroids.numpy(), index_j.centroids, atol=VLAD_ATOL)
    assert not index_t.vlads[-1].any()
    carried = convert.retrieval_index_from_numpy(index_j.ids, index_j.vlads, index_j.centroids, device="cpu")
    for i in sorted(descs):
        want = retrieval_j.query(index_j, i, len(descs))
        assert retrieval_t.query(index_t, i, len(descs)) == want, i
        assert retrieval_t.query(carried, i, len(descs)) == want, i


@pytest.mark.parametrize("seed", range(6))
def test_vote_and_verify_matches_jax(seed, jax_kmeans_init):
    """_repetitive_scene: the true candidate and the shuffled impostor get
    the JAX package's effective inlier counts exactly, twice the same (and
    one candidate alone through `vote_and_verify` as in the batch), and the
    re-ranked query puts the true candidate first, as
    test_rerank_fixes_repetitive_confusion asks of the JAX package."""
    descs, geoms = _repetitive_scene(seed=seed)
    index_j = retrieval_j.build_index(descs, k=12, geoms_by_image=geoms)
    index_t = retrieval_t.build_index(descs, k=12, geoms_by_image=geoms, device="cpu")
    np.testing.assert_array_equal(index_t.words.numpy(), index_j.words)
    jn = jax.numpy
    want = np.asarray(vv_j.vote_and_verify_batch(
        jn.asarray(index_j.geoms[0]), jn.asarray(index_j.words[0]), jn.asarray(index_j.valids[0]),
        jn.asarray(index_j.geoms[1:]), jn.asarray(index_j.words[1:]), jn.asarray(index_j.valids[1:]),
        vv_j.VoteVerifyOptions(**VV_OPTS),
    ))
    opts = vv_t.VoteVerifyOptions(**VV_OPTS)
    args = (index_t.geoms[0], index_t.words[0], index_t.valids[0],
            index_t.geoms[1:], index_t.words[1:], index_t.valids[1:], opts)
    got = vv_t.vote_and_verify_batch(*args).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(vv_t.vote_and_verify_batch(*args).numpy(), got)
    one = vv_j.vote_and_verify(*(jn.asarray(a[0]) for a in (index_j.geoms, index_j.words, index_j.valids)),
                               *(jn.asarray(a[1]) for a in (index_j.geoms, index_j.words, index_j.valids)),
                               vv_j.VoteVerifyOptions(**VV_OPTS))
    assert int(vv_t.vote_and_verify(*args[:3], *(a[0] for a in args[3:6]), opts)) == int(one) == got[0]
    assert got[0] >= 20 and got[0] >= 4 * max(got[1], 1), got
    assert retrieval_t.query(index_t, 1, 2, rerank=True, num_verify=2, vv_opts=opts)[0] == 2


def _matcher_world(tmp_path):
    """A descriptor world of 6 images whose keypoints carry a scale and an
    orientation (vote-and-verify reads them), each world point's the same
    in every view."""
    rec, graph, lmap, gt, desc, point_ids = synthetic_torch.make_descriptor_world(
        np.random.default_rng(21), n_images=6, n_points=300, noise_px=0.3
    )
    paths = synthetic_torch.write_world(rec, graph, lmap, gt, str(tmp_path), descriptors=desc)
    db = Database(paths["database"])
    rng = np.random.default_rng(22)
    scale, angle = rng.uniform(1.5, 3.0, 100_000), rng.uniform(-np.pi, np.pi, 100_000)
    for iid in db.images():
        kp = db.read_keypoints(iid)[:, :4]
        pid = np.where(point_ids[iid] >= 0, point_ids[iid], rng.integers(0, 100_000, len(kp)))
        kp[:, 2], kp[:, 3] = scale[pid], angle[pid]
        db.write_keypoints(iid, kp)
    db.commit()
    db.close()
    return paths["database"]


def _copies(path: str, *names: str) -> list:
    out = []
    for name in names:
        out.append(os.path.join(os.path.dirname(path), name))
        shutil.copy(path, out[-1])
    return out


def _same_verified_pairs(db_t: str, db_j: str):
    """The same pairs tried and verified, inlier counts within 5% per pair
    (RANSAC draws differ: torch.Generator vs jax.random)."""
    dt, dj = Database(db_t), Database(db_j)
    try:
        pairs = sorted(dj.all_two_view_pair_ids())
        assert sorted(dt.all_two_view_pair_ids()) == pairs
        for i, j in pairs:
            nt = len(dt.read_two_view_geometry(i, j)["inlier_matches"])
            nj = len(dj.read_two_view_geometry(i, j)["inlier_matches"])
            assert abs(nt - nj) <= 0.05 * nj, (i, j, nt, nj)
        return pairs
    finally:
        dt.close()
        dj.close()


def test_retrieval_matchers_match_jax(tmp_path, jax_kmeans_init):
    """Both packages' vocab-tree matcher (3 neighbours, re-ranked) and then
    loop-detecting sequential matcher (overlap 1, a query every 2nd image,
    re-ranked) on copies of one database: the same pairs tried and
    verified, inlier counts within 5%."""
    db_t, db_j, seq_t, seq_j = _copies(_matcher_world(tmp_path), "vt_t.db", "vt_j.db", "seq_t.db", "seq_j.db")
    cfg_t, cfg_j = MatchingConfigT(min_num_inliers=15), MatchingConfigJ(min_num_inliers=15)
    n_t = pipeline_t.run_vocab_tree_matcher(db_t, cfg_t, num_images=3, spatial_rerank=True, device="cpu")
    n_j = pipeline_j.run_vocab_tree_matcher(db_j, cfg_j, num_images=3, spatial_rerank=True)
    assert n_t == n_j > 0
    assert len(_same_verified_pairs(db_t, db_j)) >= 5
    kw = dict(overlap=1, quadratic_overlap=False, loop_detection=True, loop_detection_period=2,
              loop_detection_num_images=3, loop_spatial_rerank=True)
    n_t = pipeline_t.run_sequential_matcher(seq_t, cfg_t, device="cpu", **kw)
    n_j = pipeline_j.run_sequential_matcher(seq_j, cfg_j, **kw)
    assert n_t == n_j > 0
    assert len(_same_verified_pairs(seq_t, seq_j)) > 5  # the loop pairs beside the 5 sequential ones


def test_retrieval_needs_a_device_by_name():
    """Without a device the index asks for CUDA: where there is none it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        retrieval_t.build_index({1: np.ones((4, 128), np.float32)})


def test_retrieval_commands_never_import_jax(tmp_path):
    """vocab_tree_builder, vocab_tree_retriever, vocab_tree_matcher and the
    loop-detecting sequential_matcher in a fresh interpreter where
    `import jax` fails loudly."""
    db_t = _matcher_world(tmp_path)
    vocab = str(tmp_path / "vocab.npz")
    db = ["--database_path", db_t, "--device", "cpu"]
    commands = [
        ["vocab_tree_builder", "--vocab_tree_path", vocab, *db],
        ["vocab_tree_retriever", "--num_images", "3", *db],
        ["vocab_tree_matcher", "--VocabTreeMatching.num_images", "3",
         "--VocabTreeMatching.spatial_rerank", "1", "--SiftMatching.min_num_inliers", "15", *db],
        ["sequential_matcher", "--SequentialMatching.overlap", "1", "--SequentialMatching.loop_detection", "1",
         "--SequentialMatching.spatial_rerank", "1", "--SiftMatching.min_num_inliers", "15", *db],
    ]
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch; torch.set_num_threads(1)\n"
        "from colmap_pcd_tpu_torch import cli\n"
        f"for argv in {commands!r}:\n"
        "    assert cli.main(argv) == 0, argv\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'colmap_pcd_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None), 'jax imported'\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert np.load(vocab)["centroids"].shape == (64, 128)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("img") and ": " in ln]
    assert len(lines) == 6 and all(len(ln.split(": ")[1].split(", ")) == 3 for ln in lines), lines
    assert "retrieved pairs" in proc.stdout and "Verified" in proc.stdout


@pytest.mark.slow
def test_vlad_recall_vs_exhaustive_sift():
    """The port's twin of test_vlad_recall_vs_exhaustive_sift: SIFT on 8
    rendered corridor views (320x240), and VLAD's top 3 must recover at
    least 60% of the top 3 by the count of matches exhaustive descriptor
    matching finds (the oracle retrieval replaces)."""
    from render_torch import render_corridor

    from colmap_pcd_tpu_torch.ops import matching, sift

    gt = synthetic_torch.make_trajectory(8, step=0.9)
    opts = sift.SiftOptions(max_num_features=1024, first_octave=0, num_octaves=3)
    imgs = np.stack([render_corridor(q, t, 320, 240, 260.0) for q, t in gt])
    kp, desc, _, valid = sift.extract_batch(torch.as_tensor(imgs), opts)
    descs = {i + 1: desc[i][valid[i]].numpy().astype(np.float32) for i in range(len(gt))}
    index = retrieval_t.build_index(descs, k=16, device="cpu")

    def nmatches(a, b):
        d = [matching.normalize_descriptors(torch.as_tensor(descs[x])) for x in (a, b)]
        v = [torch.ones(x.shape[0]) for x in d]
        return int(matching.match_descriptors(d[0], d[1], v[0], v[1])[1].sum())

    K, ids = 3, sorted(descs)
    hits = 0
    for i in ids:
        oracle = sorted((j for j in ids if j != i), key=lambda j: -nmatches(i, j))[:K]
        hits += len(set(oracle) & set(retrieval_t.query(index, i, K)))
    assert hits / (K * len(ids)) >= 0.6, hits
