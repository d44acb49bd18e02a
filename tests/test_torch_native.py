"""The port's native host runtime (cpp/native.cpp through ctypes) and its
ControllableThread: the twins of tests/test_native.py's five cases on the
port's wrappers, each kd-tree and graph case also on the numpy fallback
that a machine without a toolchain takes; the radius search against the
JAX package's wrapper, the bulk graph against the port's
CorrespondenceGraph on a written database, and the thread's protocol."""

import threading
import time

import numpy as np
import pytest

from colmap_pcd_tpu.utils import native as native_j
from colmap_pcd_tpu_torch.models.correspondence_graph import CorrespondenceGraph
from colmap_pcd_tpu_torch.models.database import Database
from colmap_pcd_tpu_torch.utils import native
from colmap_pcd_tpu_torch.utils.threading_utils import ControllableThread

import synthetic_torch

BACKENDS = ["native", "numpy"]


def _tree(points, backend):
    tree = native.NativeKdTree(points)
    if backend == "numpy":
        tree.handle = None  # the fallback of a machine without the library
    return tree


def _graph(backend):
    g = native.NativeCorrGraph()
    if backend == "numpy":
        g.handle = None
    return g


def test_native_lib_builds():
    lib = native.get_lib()
    assert lib is not None, "g++ build of cpp/native.cpp failed"


@pytest.mark.parametrize("backend", BACKENDS)
def test_kdtree_nn_exact(rng, backend):
    pts = rng.normal(size=(5000, 3)).astype(np.float32)
    tree = _tree(pts, backend)
    q = rng.normal(size=(200, 3)).astype(np.float32)
    idx, dist = tree.nn(q)
    d = np.linalg.norm(pts[None] - q[:, None], axis=-1)
    oracle = np.argmin(d, axis=1)
    np.testing.assert_array_equal(idx, oracle)
    np.testing.assert_allclose(dist, d[np.arange(200), oracle], rtol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_kdtree_radius(rng, backend):
    pts = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    tree = _tree(pts, backend)
    q = np.zeros((1, 3), np.float32)
    idx, cnt = tree.radius(q, 0.3, cap=512)
    d = np.linalg.norm(pts, axis=1)
    assert set(idx[0, : cnt[0]].tolist()) == set(np.nonzero(d <= 0.3)[0].tolist())


def test_kdtree_radius_matches_jax_wrapper(rng):
    """Many queries, a cap that some of them reach: the same counts and the
    same index sets as the JAX package's wrapper of the same library."""
    pts = rng.uniform(-5, 5, (20000, 3)).astype(np.float32)
    q = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    idx_t, cnt_t = native.NativeKdTree(pts).radius(q, 0.8, cap=48)
    idx_j, cnt_j = native_j.NativeKdTree(pts).radius(q, 0.8, cap=48)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    assert (cnt_t == 48).any() and (cnt_t < 48).any()
    for i in range(len(q)):
        assert sorted(idx_t[i, : cnt_t[i]]) == sorted(idx_j[i, : cnt_j[i]])


@pytest.mark.parametrize("backend", BACKENDS)
def test_corr_graph_batch(backend):
    g = _graph(backend)
    g.add_matches(1, 2, np.asarray([[0, 5], [1, 6], [2, 7]], np.int32))
    g.add_matches(1, 3, np.asarray([[0, 9], [3, 4]], np.int32))
    imgs, feats, cnt = g.find_batch(1, np.asarray([0, 1, 3, 50]))
    # feature 0 of image 1 corresponds to (2,5) and (3,9)
    assert cnt[0] == 2
    assert {(int(imgs[0, k]), int(feats[0, k])) for k in range(cnt[0])} == {(2, 5), (3, 9)}
    assert cnt[1] == 1 and (imgs[1, 0], feats[1, 0]) == (2, 6)
    assert cnt[2] == 1 and (imgs[2, 0], feats[2, 0]) == (3, 4)
    assert cnt[3] == 0
    imgs, feats, cnt = g.find_batch(2, np.asarray([5]))  # the reverse direction
    assert cnt[0] == 1 and (imgs[0, 0], feats[0, 0]) == (1, 0)


def test_pack_key_round_trip():
    ids = np.asarray([1, 7, 4095], np.int64)
    feats = np.asarray([0, 123456, (1 << native.FEAT_BITS) - 1], np.int64)
    key = native.pack_key(ids, feats)
    np.testing.assert_array_equal(key, native_j.pack_key(ids, feats))
    back = native.unpack_key(key)
    np.testing.assert_array_equal(back[0], ids)
    np.testing.assert_array_equal(back[1], feats)


@pytest.mark.parametrize("backend", BACKENDS)
def test_corr_graph_matches_correspondence_graph(tmp_path, backend):
    """The bulk graph over a written database's verified matches answers
    every feature of every image as the port's CorrespondenceGraph does."""
    rec, graph, lmap, gt = synthetic_torch.make_world(
        np.random.default_rng(3), n_images=5, n_points=300, noise_px=0.2
    )
    paths = synthetic_torch.write_world(rec, graph, lmap, gt, str(tmp_path))
    db = Database(paths["database"])
    n_feat = {iid: db.read_keypoints(iid).shape[0] for iid in db.images()}
    bulk, ref = _graph(backend), CorrespondenceGraph()
    for i, j in db.all_two_view_pair_ids():
        m = db.read_two_view_geometry(i, j)["inlier_matches"].astype(np.int32)
        bulk.add_matches(i, j, m)
        ref.add_matches(i, j, m)
    db.close()
    for iid, n in n_feat.items():
        feats = np.arange(n)
        imgs, nbr, cnt = bulk.find_batch(iid, feats, cap=16)
        assert cnt.max() < 16
        qid, r_img, r_feat = ref.find_batch(iid, feats)
        got = {(f, int(imgs[f, k]), int(nbr[f, k])) for f in range(n) for k in range(cnt[f])}
        assert got == set(zip(qid.tolist(), r_img.tolist(), r_feat.tolist()))
        assert len(got) == int(cnt.sum()) > n  # several views see each feature


def test_kdtree_perf_smoke(rng):
    """500k points, 10k queries: must finish quickly (the FLANN role)."""
    pts = rng.uniform(-50, 50, (500_000, 3)).astype(np.float32)
    t0 = time.time()
    tree = native.NativeKdTree(pts)
    build = time.time() - t0
    q = rng.uniform(-50, 50, (10_000, 3)).astype(np.float32)
    t0 = time.time()
    idx, dist = tree.nn(q)
    query = time.time() - t0
    assert build < 5.0, build
    assert query < 2.0, query
    assert (idx >= 0).all()


def test_controllable_thread_protocol():
    """start, pause (the target blocks at its next check), resume, stop,
    wait; callbacks run in order with their arguments."""
    steps = []
    finished = threading.Event()
    calls = []

    def target(th):
        while not th.is_stopped():
            th.block_if_paused()
            steps.append(len(steps))
            th.callback("step", len(steps))
            time.sleep(0.002)
        th.callback("finished")

    th = ControllableThread(target)
    th.add_callback("step", lambda n: calls.append(("step", n)))
    th.add_callback("finished", lambda: calls.append(("finished",)))
    th.add_callback("finished", finished.set)
    th.start()
    deadline = time.time() + 10
    while len(steps) < 5 and time.time() < deadline:
        time.sleep(0.005)
    assert len(steps) >= 5
    th.pause()
    time.sleep(0.05)  # at most one step already past its check
    held = len(steps)
    time.sleep(0.1)
    assert len(steps) == held
    th.resume()
    while len(steps) < held + 5 and time.time() < deadline:
        time.sleep(0.005)
    assert len(steps) >= held + 5
    th.pause()
    th.stop()  # a stop releases a paused target
    th.wait()
    assert th.is_stopped() and finished.is_set()
    assert calls[-1] == ("finished",)
    assert [c[1] for c in calls[:-1]] == list(range(1, len(steps) + 1))
