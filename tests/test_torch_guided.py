"""The matcher's guided re-match on the batched uint8 path, on the CPU.

The guided kernel's plain version (`match_kernel.match_top2_u8_guided_reference`,
through `matching.match_guided_u8`) against the float guided matcher
`matching.match_guided` and the JAX package's `match_guided`, pair by pair;
the matcher's guided stage (which pairs it re-matches, its replacement rule,
its counters); and the ATen operations of an unguided chunk, which the guided
stage must leave as they were.

The float matchers form their similarities from normalized f32 descriptors
and their Sampson errors in another order, so a row is compared only where
the float64 computation decides it: no two candidates within SIM_EPS of
each other at a decision, no deciding candidate within ERR_EPS (relative)
of the Sampson threshold, no test within DIST_EPS of its boundary.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic_torch
from colmap_pcd_tpu.ops import matching as matching_j
from colmap_pcd_tpu_torch.models import feature_pipeline as pipeline_t
from colmap_pcd_tpu_torch.models.database import Database
from colmap_pcd_tpu_torch.ops import match_kernel
from colmap_pcd_tpu_torch.ops import matching as matching_t
from colmap_pcd_tpu_torch.utils.config import SiftMatchingConfig
from colmap_pcd_tpu_torch.utils.logging_utils import PHASES

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

T = torch.as_tensor
# f32 similarities of unit vectors differ from float64 by a few ulps of 1;
# f32 keypoints up to 640 px put the Sampson error some 1e-6 (relative) off
SIM_EPS, ERR_EPS, DIST_EPS = 1e-5, 1e-4, 1e-4
OPTS = matching_t.MatchingOptions(guided_max_error=4.0)
# ATen operations of the unguided 5-pair chunk of `_world(8)` on the CPU, its
# second run, counted on the tree before the guided stage existed
UNGUIDED_CHUNK_OPS = 7817


def _sift_u8(rng, n):
    d = rng.normal(size=(n, 128)) ** 2
    d = d / np.linalg.norm(d, axis=-1, keepdims=True) * 512
    return np.clip(np.round(d), 0, 255).astype(np.uint8)


def _rot(rng, angle):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    K = np.asarray([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _pair(rng, n1, n2, width=640, height=480, focal=500.0, dup=False):
    """Two views of random points (x2^T F x1 = 0 in pixels): d2 holds
    noisy copies of most of d1's rows at their points' projections, plus
    clutter anywhere. With `dup`, exact duplicates of rows of d1 and of
    columns of d2 (descriptor and keypoint alike)."""
    K = np.asarray([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]])
    R, t = _rot(rng, 0.1), np.asarray([1.0, 0.1, 0.05]) + rng.normal(0, 0.05, 3)
    shared = min(n1, n2) * 3 // 4
    X = np.stack([rng.uniform(-4, 4, n1), rng.uniform(-3, 3, n1), rng.uniform(4, 12, n1)], -1)
    x1 = X @ K.T
    uv1 = x1[:, :2] / x1[:, 2:]
    x2 = (X[:shared] @ R.T + t) @ K.T
    uv2 = np.concatenate([x2[:, :2] / x2[:, 2:] + rng.normal(0, 0.7, (shared, 2)),
                          rng.uniform([0, 0], [width, height], (n2 - shared, 2))])
    d1 = _sift_u8(rng, n1)
    noisy = np.clip(d1[:shared].astype(np.int64) + rng.integers(-6, 7, (shared, 128)), 0, 255)
    d2 = np.concatenate([noisy.astype(np.uint8), _sift_u8(rng, n2 - shared)])
    perm = rng.permutation(n2)
    d2, uv2 = d2[perm], uv2[perm]
    if dup:
        d1[n1 // 2: n1 // 2 + 8], uv1[n1 // 2: n1 // 2 + 8] = d1[:8], uv1[:8]
        d2[n2 - 8:], uv2[n2 - 8:] = d2[:8], uv2[:8]
    tx = np.asarray([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    F = np.linalg.inv(K).T @ tx @ R @ np.linalg.inv(K)
    return d1, d2, uv1.astype(np.float32), uv2.astype(np.float32), F / np.abs(F).max()


def _undecided(d1, d2, uv1, uv2, F, v1, v2, opts=OPTS) -> np.ndarray:
    """Rows [N1] whose guided outcome float64 does not decide (see the
    module's docstring)."""
    a = d1.astype(np.float64)
    b = d2.astype(np.float64)
    sim = (a / np.linalg.norm(a, axis=1, keepdims=True)) @ (b / np.linalg.norm(b, axis=1, keepdims=True)).T
    h1 = np.concatenate([uv1.astype(np.float64), np.ones((len(uv1), 1))], 1)
    h2 = np.concatenate([uv2.astype(np.float64), np.ones((len(uv2), 1))], 1)
    l1, l2 = h1 @ F.T, h2 @ F
    err = (l1 @ h2.T) ** 2 / ((l1[:, :2] ** 2).sum(1)[:, None] + (l2[:, :2] ** 2).sum(1)[None, :])
    thr = opts.guided_max_error ** 2
    near_thr = np.abs(err - thr) < ERR_EPS * thr
    sim = np.where((err < thr) & (v2[None, :] > 0) & (v1[:, None] > 0), sim, -2.0)
    order = np.sort(sim, axis=1)
    s1, s2 = order[:, -1], order[:, -2]
    idx = np.argmax(sim, axis=1)
    dist1, dist2 = np.arccos(np.clip(s1, -1, 1)), np.arccos(np.clip(s2, -1, 1))
    cols = np.sort(sim, axis=0)
    c1, c2 = cols[-1], cols[-2]
    out = (s1 - s2 < SIM_EPS) & (s1 > -1.5)
    out |= (np.abs(dist1 - opts.max_ratio * dist2) < DIST_EPS) | (np.abs(dist1 - opts.max_distance) < DIST_EPS)
    out |= ((c1 - c2)[idx] < SIM_EPS) & (s1 > -1.5)
    rows_near = np.any(near_thr & (sim >= s2[:, None] - SIM_EPS), axis=1)
    cols_near = np.any(near_thr & (sim >= (c2 - SIM_EPS)[None, :]), axis=0)[idx]
    return out | rows_near | cols_near


def _cases():
    rng = np.random.default_rng(22)
    return [
        ("square", [_pair(rng, 256, 256) for _ in range(3)], None, None),
        ("ragged masks", [_pair(rng, 300, 420) for _ in range(4)], [300, 211, 97, 300], [420, 333, 420, 5]),
        ("duplicates", [_pair(rng, 200, 260, dup=True) for _ in range(2)], None, None),
    ]


def _batch(pairs, n1s, n2s):
    d1, d2, uv1, uv2, F = (np.stack(x) for x in zip(*pairs))
    B, N1, N2 = d1.shape[0], d1.shape[1], d2.shape[1]
    v1 = (np.arange(N1)[None, :] < np.asarray(n1s or [N1] * B)[:, None]).astype(np.float32)
    v2 = (np.arange(N2)[None, :] < np.asarray(n2s or [N2] * B)[:, None]).astype(np.float32)
    return d1, d2, uv1, uv2, F, v1, v2


@pytest.mark.parametrize("label,pairs,n1s,n2s", _cases(), ids=lambda x: x if isinstance(x, str) else "")
def test_plain_guided_u8_equals_match_guided(label, pairs, n1s, n2s):
    """The batched uint8 guided matcher's plain route equals
    ops/matching.match_guided (normalized f32 descriptors, one pair at a
    time) on every row float64 decides, and the JAX package's match_guided
    likewise."""
    d1, d2, uv1, uv2, F, v1, v2 = _batch(pairs, n1s, n2s)
    u1, u2 = T(d1), T(d2)
    inv1, inv2 = match_kernel.inverse_norms(u1), match_kernel.inverse_norms(u2)
    idx, ok = (x.numpy() for x in matching_t.match_guided_u8(u1, u2, inv1, inv2, T(v1), T(v2), T(uv1), T(uv2),
                                                            T(F), OPTS))
    held = compared = 0
    for b in range(len(pairs)):
        keep = ~_undecided(d1[b], d2[b], uv1[b], uv2[b], F[b], v1[b], v2[b])
        n1 = matching_t.normalize_descriptors(T(d1[b]))
        n2 = matching_t.normalize_descriptors(T(d2[b]))
        ti, tok = (x.numpy() for x in matching_t.match_guided(n1, n2, T(uv1[b]), T(uv2[b]), T(v1[b]), T(v2[b]),
                                                               T(F[b], dtype=torch.float32), OPTS))
        ji, jok = (np.asarray(x) for x in matching_j.match_guided(
            jnp.asarray(n1.numpy()), jnp.asarray(n2.numpy()), jnp.asarray(uv1[b]), jnp.asarray(uv2[b]),
            jnp.asarray(v1[b]), jnp.asarray(v2[b]), jnp.asarray(F[b], jnp.float32),
            matching_j.MatchingOptions(guided_max_error=OPTS.guided_max_error)))
        for other_i, other_ok in ((ti, tok), (ji, jok)):
            np.testing.assert_array_equal(ok[b][keep], other_ok[keep])
            both = keep & ok[b]
            np.testing.assert_array_equal(idx[b][both], other_i[both])
        held += int(keep.sum())
        compared += int((keep & ok[b]).sum())
        assert not ok[b][v1[b] == 0].any()
        assert (v2[b][idx[b][ok[b]]] > 0).all()
    assert held >= 0.85 * sum(int(v.sum()) for v in v1)
    assert compared > 0.3 * held


def test_guided_mask_transposes_and_ties_take_the_lowest_column():
    """The point records' mask of (d2, d1) is the transpose of (d1, d2)'s,
    bit for bit; the plain version keeps the lowest of exactly equal
    columns."""
    d1, d2, uv1, uv2, F = _pair(np.random.default_rng(5), 200, 260, dup=True)
    g1, g2 = match_kernel.point_records(T(uv1), T(uv2), T(F), 4.0)
    assert torch.equal(match_kernel.epipolar_mask(g1, g2), match_kernel.epipolar_mask(g2, g1).T)
    u1, u2 = T(d1), T(d2)
    inv1, inv2 = match_kernel.inverse_norms(u1), match_kernel.inverse_norms(u2)
    s1, s2, idx = match_kernel.match_top2_u8_guided(u1, u2, inv1, inv2, g1, g2, torch.ones(260))
    # columns 252-259 repeat columns 0-7, rows 100-107 repeat rows 0-7
    assert bool((idx < 252).all()) and bool((s1 == s2)[torch.isin(idx, torch.arange(8))].all())
    assert torch.equal(s1[:8], s1[100:108]) and torch.equal(idx[:8], idx[100:108])


def _world(tmp_path, seed, n_images=4, n_points=300):
    rec, graph, lmap, gt, desc, point_ids = synthetic_torch.make_descriptor_world(
        np.random.default_rng(seed), n_images=n_images, n_points=n_points, noise_px=0.3)
    return synthetic_torch.write_world(rec, graph, lmap, gt, str(tmp_path), descriptors=desc), point_ids


def _chunk(worker, db):
    prep = worker._prep(pipeline_t.sequential_pair_list(sorted(db.images()), 2, True))
    asm, _ = worker._assemble_pure(prep, worker._dev_match(prep))
    vfetched, vctx = worker._dev_verify(asm)
    return prep, worker._classify_pure(asm, vctx, vfetched)[0]


def test_guided_stage_pairs_and_replacement(tmp_path):
    """The guided stage re-matches the pairs that have an F and at least
    min_num_inliers inliers, and no other: a pair without an F and a pair
    under the least count pass through as they came. A re-matched pair's
    guided matches equal match_guided's on its rows that float64 decides,
    and replace its inliers where they are more. Counters: pairs, kernel
    pairs (none on the CPU), similarities formed, points, replacements."""
    paths, _ = _world(tmp_path, 8)
    db = Database(paths["database"])
    try:
        cfg = SiftMatchingConfig(guided_matching=True)
        worker = pipeline_t._MatchWorker(db, cfg, "cpu")
        prep, writes = _chunk(worker, db)
        assert len(writes) == 5 and all(w[3].F is not None for w in writes)
        writes[0] = (*writes[0][:3], dataclasses.replace(writes[0][3], F=None))
        writes[1] = (*writes[1][:2], writes[1][2][: cfg.min_num_inliers - 1], writes[1][3])
        # a pair left with the least count, so that its guided matches outnumber it
        writes[2] = (*writes[2][:2], writes[2][2][: cfg.min_num_inliers], writes[2][3])
        PHASES.counts.clear()
        out = worker._dev_guided(prep, writes)
        assert out[0] is writes[0] and out[1] is writes[1]
        sims = points = replaced = 0
        for k in range(2, 5):
            id1, id2, inliers, g = writes[k]
            f1, f2 = worker._feats_host(id1), worker._feats_host(id2)
            n1, n2 = f1[3], f2[3]
            d1, d2 = f1[1][:n1], f2[1][:n2]
            uv1, uv2 = f1[0][:n1, :2], f2[0][:n2, :2]
            v1, v2 = np.ones(n1, np.float32), np.ones(n2, np.float32)
            gi, gok = matching_t.match_guided(
                matching_t.normalize_descriptors(T(d1)), matching_t.normalize_descriptors(T(d2)), T(uv1),
                T(uv2), T(v1), T(v2), T(g.F, dtype=torch.float32), worker._mopts())
            expect = matching_t.matches_to_pairs(gi, gok)
            keep = ~_undecided(d1, d2, uv1, uv2, g.F, v1, v2, worker._mopts())
            if len(expect) > len(inliers):
                got = out[k][2]
                replaced += 1
                assert {tuple(r) for r in got if keep[r[0]]} == {tuple(r) for r in expect if keep[r[0]]}
            else:
                assert out[k][2] is inliers
            sims += n1 * n2
            points += n1 + n2
        assert replaced > 0 and PHASES.counts["match.guided"] == 1
        counters = {k: v for k, v in PHASES.counts.items() if k.startswith("guided_")}
        assert counters == {"guided_pairs": 3, "guided_kernel_pairs": 0, "guided_sims": sims,
                            "guided_points": points, "guided_replaced": replaced}
    finally:
        db.close()


class _Count(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_unguided_chunk_dispatches_what_it_did(tmp_path):
    """An unguided chunk dispatches the ATen operations it did before the
    guided stage existed; a guided chunk adds only its guided stage's."""
    paths, _ = _world(tmp_path, 8)
    db = Database(paths["database"])
    try:
        counts = {}
        for guided in (False, True):
            worker = pipeline_t._MatchWorker(db, SiftMatchingConfig(guided_matching=guided), "cpu")
            prep = worker._prep(pipeline_t.sequential_pair_list(sorted(db.images()), 2, True))
            for _ in range(2):  # the second time: no operation of a first call's lazy set-up
                with _Count() as whole:
                    _, writes, _ = worker._process_chunk(prep)
            counts[guided] = whole.n
        with _Count() as stage:
            worker._dev_guided(prep, writes)
        assert counts[False] == UNGUIDED_CHUNK_OPS
        assert counts[True] - stage.n == UNGUIDED_CHUNK_OPS
    finally:
        db.close()
