"""Parity of the port's descriptor matching with the JAX package on the same
inputs: the top-2 kernel's plain version against the Pallas kernel (in
interpret mode) and `_best2`, and match_descriptors / match_guided. Inputs
are made with numpy from a seed and handed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colmap_pcd_tpu.ops import matching as matching_j
from colmap_pcd_tpu.ops import pallas_kernels as pallas_j
from colmap_pcd_tpu_torch.ops import match_kernel
from colmap_pcd_tpu_torch.ops import matching as matching_t

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

T = torch.as_tensor
# similarities are f32 dot products of unit vectors summed in another
# order: a few ulps of 1
SIM_ATOL = 1e-6


def _unit(rng, n, d=128):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _pair(rng, n1, n2, noise=0.05):
    """d2 holds noisy copies of most of d1's rows, permuted, plus clutter."""
    d1 = _unit(rng, n1)
    shared = min(n1, n2) * 3 // 4
    src = np.concatenate([d1[rng.permutation(n1)[:shared]], _unit(rng, n2 - shared)])
    d2 = src[rng.permutation(n2)] + rng.normal(0, noise, (n2, 128)).astype(np.float32)
    return d1, (d2 / np.linalg.norm(d2, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("n1,n2,tq,tn", [(128, 256, 64, 128), (256, 256, 128, 256)])
def test_top2_reference_matches_pallas_kernel(n1, n2, tq, tn):
    """The plain version against the Pallas kernel run in interpret mode at
    tile-multiple shapes (all columns valid: the Pallas kernel has no mask)."""
    rng = np.random.default_rng(n1 + n2)
    d1, d2 = _pair(rng, n1, n2)
    b1, b2, i1 = (
        np.asarray(x)
        for x in pallas_j.match_top2(jnp.asarray(d1), jnp.asarray(d2), tile_q=tq, tile_n=tn, interpret=True)
    )
    s1, s2, idx = (x.numpy() for x in match_kernel.match_top2_reference(T(d1), T(d2), T(np.ones(n2, np.float32))))
    np.testing.assert_allclose(s1, b1, atol=SIM_ATOL)
    np.testing.assert_allclose(s2, b2, atol=SIM_ATOL)
    sep = (b1 - b2) > SIM_ATOL
    np.testing.assert_array_equal(idx[sep], i1[sep])
    assert idx.dtype == np.int32


def test_top2_reference_matches_best2_with_mask():
    """Batched plain version against the JAX `_best2` of each pair, with
    ragged invalid columns counted as -2."""
    rng = np.random.default_rng(3)
    B, n1, n2 = 3, 96, 160
    d1 = np.stack([_pair(rng, n1, n2)[0] for _ in range(B)])
    d2 = np.stack([_unit(rng, n2) for _ in range(B)])
    v2 = (rng.uniform(size=(B, n2)) > 0.3).astype(np.float32)
    s1, s2, idx = (x.numpy() for x in match_kernel.match_top2_reference(T(d1), T(d2), T(v2)))
    for b in range(B):
        sim = jnp.asarray(d1[b]) @ jnp.asarray(d2[b]).T
        j1, j2, ji = (np.asarray(x) for x in matching_j._best2(sim, jnp.asarray(v2[b])))
        np.testing.assert_allclose(s1[b], j1, atol=SIM_ATOL)
        np.testing.assert_allclose(s2[b], j2, atol=SIM_ATOL)
        sep = (j1 - j2) > SIM_ATOL
        np.testing.assert_array_equal(idx[b][sep], ji[sep])


def test_top2_ties_go_to_the_lowest_column():
    rng = np.random.default_rng(4)
    d2 = _unit(rng, 64)
    d2[40] = d2[7]  # exact duplicate at a higher column
    d1 = d2[[7, 40, 3]] + 0.0
    s1, s2, idx = match_kernel.match_top2(T(d1), T(d2), T(np.ones(64, np.float32)))
    assert idx.tolist() == [7, 7, 3]
    assert float(s1[0]) == float(s2[0])  # the twin is the second best


def test_top2_wrapper_checks_inputs():
    d = torch.zeros((4, 128))
    with pytest.raises(ValueError):
        match_kernel.match_top2(d.double(), d.double(), torch.ones(4))
    with pytest.raises(ValueError):
        match_kernel.match_top2(d, torch.zeros((4, 64)), torch.ones(4))
    with pytest.raises(ValueError):
        match_kernel.match_top2(d, d, torch.ones(5))
    with pytest.raises(ValueError):
        match_kernel.match_top2(d, torch.zeros((0, 128)), torch.ones(0))


def _sift_like_pairs(rng, B, n1, n2, dup=True):
    """Unit SIFT-like descriptors for B pairs (non-negative, as chip_smoke's
    `_k1_case` makes them): d2 holds noisy copies of three quarters of d1's
    rows in another order plus fresh ones; with `dup`, exact duplicates of the first eighth
    of the rows and of the columns sit in the upper half (ties); ragged
    valid masks with holes."""
    d1 = np.empty((B, n1, 128), np.float32)
    d2 = np.empty((B, n2, 128), np.float32)
    v1 = (rng.uniform(size=(B, n1)) > 0.15).astype(np.float32)
    v2 = (rng.uniform(size=(B, n2)) > 0.15).astype(np.float32)
    for b in range(B):
        base = rng.normal(size=(n1 + n2, 128)) ** 2
        a = base[:n1] + rng.normal(0, 0.02, (n1, 128))
        shared = min(n1, n2) * 3 // 4
        src = np.concatenate([base[rng.permutation(n1)[:shared]], base[n1 : n1 + n2 - shared]])
        c = src[rng.permutation(n2)] + rng.normal(0, 0.02, (n2, 128))
        if dup:
            a[n1 // 2 : n1 // 2 + n1 // 8] = a[: n1 // 8]
            c[n2 // 2 : n2 // 2 + n2 // 8] = c[: n2 // 8]
        a, c = np.maximum(a, 0.0), np.maximum(c, 0.0)
        d1[b] = a / np.linalg.norm(a, axis=-1, keepdims=True)
        d2[b] = c / np.linalg.norm(c, axis=-1, keepdims=True)
        v1[b, rng.integers(n1 * 3 // 4, n1 + 1):] = 0.0
        v2[b, rng.integers(n2 * 3 // 4, n2 + 1):] = 0.0
        v1[b, : n1 // 8] = 1.0  # the lower twins take part
        v2[b, : n2 // 8] = 1.0
    return d1, d2, v1, v2


@pytest.mark.parametrize("n1,n2", [(200, 150), (97, 256)])
def test_top2_cross_reference_matches_jax(n1, n2):
    """The fused call's plain twin against the JAX package on the same
    inputs, sizes off the CUDA kernel's 128 tiles: s1, s2 within 1e-6 (f32
    sums in another order), idx and back (the best valid row of every
    column, invalid rows at -2) equal wherever best and second best differ
    by more than 1e-6 or are exact twins (ties go to the lowest index in
    both); the accept decisions of match_descriptors equal to the JAX
    match_descriptors and to its Pallas K1 run in interpret mode (rows at a
    near-tie or within 1e-6 of a threshold excepted)."""
    rng = np.random.default_rng(n1 * n2)
    B = 2
    d1, d2, v1, v2 = _sift_like_pairs(rng, B, n1, n2)
    s1, s2, idx, back = (x.numpy() for x in match_kernel.match_top2_cross_reference(T(d1), T(d2), T(v1), T(v2)))
    assert idx.dtype == np.int32 and back.dtype == np.int32 and back.shape == (B, n2)
    opts_t, opts_j = matching_t.MatchingOptions(), matching_j.MatchingOptions()
    ok_t = matching_t.match_descriptors(T(d1), T(d2), T(v1), T(v2), opts_t)[1].numpy()
    for b in range(B):
        sim = jnp.asarray(d1[b]) @ jnp.asarray(d2[b]).T
        j1, j2, ji = (np.asarray(x) for x in matching_j._best2(sim, jnp.asarray(v2[b])))
        jback = np.asarray(jnp.argmax(jnp.where(jnp.asarray(v1[b])[:, None] > 0, sim, -2.0), axis=0))
        np.testing.assert_allclose(s1[b], j1, atol=SIM_ATOL)
        np.testing.assert_allclose(s2[b], j2, atol=SIM_ATOL)
        rows = ((j1 - j2) > SIM_ATOL) | (j1 == j2)
        np.testing.assert_array_equal(idx[b][rows], ji[rows])
        simT = np.where(v1[b][:, None] > 0, np.asarray(sim), -2.0)
        top2 = -np.sort(-simT, axis=0)[:2]
        cols = ((top2[0] - top2[1]) > SIM_ATOL) | (top2[0] == top2[1])
        np.testing.assert_array_equal(back[b][cols], jback[cols])
        # exact twins: no pick has an equal, lower-indexed twin
        for pick, other, n in ((idx[b], d2[b], n2), (back[b], d1[b], n1)):
            twin = pick - n // 2
            has_twin = (twin >= 0) & (twin < n // 8)
            assert not (has_twin & (other[np.maximum(twin, 0)] == other[pick]).all(-1)).any()
        assert ((j1 == j2) & (v1[b] > 0)).any()  # the data holds exact ties
        # the accept decision, against both JAX routes
        _, jok, _ = matching_j.match_descriptors(
            jnp.asarray(d1[b]), jnp.asarray(d2[b]), jnp.asarray(v1[b]), jnp.asarray(v2[b]), opts_j)
        _, pok = pallas_j.match_descriptors_pallas(
            jnp.asarray(d1[b]), jnp.asarray(d2[b]), jnp.asarray(v1[b]), jnp.asarray(v2[b]), opts_j,
            interpret=True)
        exempt = _near_threshold(s1[b], s2[b], opts_t) | ~rows | ~np.take(cols, idx[b])
        np.testing.assert_array_equal(ok_t[b][~exempt], np.asarray(jok)[~exempt])
        np.testing.assert_array_equal(ok_t[b][~exempt], np.asarray(pok)[~exempt])
        assert ok_t[b].sum() > n1 // 8  # not vacuous: twins fail the ratio test


def test_top2_cross_wrapper_on_the_cpu():
    """match_top2_cross on CPU tensors is its plain twin ([N, D] as a batch
    of one); its rows equal match_top2's; no valid row gives back row 0, as
    argmax over all -2 does; it checks valid1's shape."""
    rng = np.random.default_rng(9)
    d1, d2, v1, v2 = (T(x[0]) for x in _sift_like_pairs(rng, 1, 60, 90))
    s1, s2, idx, back = match_kernel.match_top2_cross(d1, d2, v1, v2)
    r = match_kernel.match_top2_cross_reference(d1[None], d2[None], v1[None], v2[None])
    for got, want in zip((s1, s2, idx, back), r):
        assert torch.equal(got, want[0])
    for got, want in zip((s1, s2, idx), match_kernel.match_top2(d1, d2, v2)):
        assert torch.equal(got, want)
    assert int(match_kernel.match_top2_cross(d1, d2, torch.zeros(60), v2)[3].abs().max()) == 0
    with pytest.raises(ValueError):
        match_kernel.match_top2_cross(d1, d2, torch.ones(59), v2)


def _rna_tf32(x: np.ndarray) -> np.ndarray:
    """f32 to TF32 (10 mantissa bits), to nearest with ties away from zero,
    as `cvt.rna.tf32.f32`: integer rounding of the magnitude bits."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_3xtf32_split_holds_sim_atol_on_the_cpu():
    """3xTF32 as a CPU emulation on unit SIFT-like descriptors at 1024 x
    2048: hi = rna(x), lo = rna(x - hi); sim = sum_k lo1 hi2 + hi1 lo2 + hi1
    hi2, the products exact, summed in float64 and, in the order a `wgmma`
    chain would take (per 8-deep k step: lo*hi, hi*lo, hi*hi), in an f32
    accumulator that rounds to nearest: both within SIM_ATOL = 1e-6 of the
    float64 similarity of the f32 inputs. The split is sound; the card's
    TF32 accumulator truncates instead, and lands 1.9-2.0e-6 away, which no
    CPU emulation shows (scripts/torch_k1_numerics.py): so the float K1
    keeps f32 FMAs."""
    rng = np.random.default_rng(12)
    d1, d2, _, _ = _sift_like_pairs(rng, 1, 1024, 2048, dup=False)
    d1, d2 = d1[0], d2[0]
    h1, h2 = _rna_tf32(d1), _rna_tf32(d2)
    l1, l2 = _rna_tf32(d1 - h1), _rna_tf32(d2 - h2)
    assert not (h1.view(np.uint32) & 0x1FFF).any() and not (l1.view(np.uint32) & 0x1FFF).any()
    ref = d1.astype(np.float64) @ d2.astype(np.float64).T
    H1, H2, L1, L2 = (x.astype(np.float64) for x in (h1, h2, l1, l2))
    exact = L1 @ H2.T + H1 @ L2.T + H1 @ H2.T
    assert np.abs(exact - ref).max() <= SIM_ATOL
    acc = np.zeros(ref.shape, np.float32)
    for k0 in range(0, 128, 8):
        for a, c in ((L1, H2), (H1, L2), (H1, H2)):  # one k step's three products, exact
            acc = (acc.astype(np.float64) + a[:, k0 : k0 + 8] @ c[:, k0 : k0 + 8].T).astype(np.float32)
    assert np.abs(acc - ref).max() <= SIM_ATOL


def test_normalize_descriptors_parity():
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, (50, 128)).astype(np.uint8)
    u8[3] = 0
    np.testing.assert_allclose(
        matching_t.normalize_descriptors(T(u8)).numpy(),
        np.asarray(matching_j.normalize_descriptors(jnp.asarray(u8))), atol=1e-7,
    )


@pytest.mark.parametrize("cross_check", [True, False])
def test_match_descriptors_parity(cross_check):
    """A batch of pairs through the port against JAX pair by pair: idx and
    ok equal, s1 within 1e-6 (rows at a near-tie or within 1e-6 of a
    threshold excepted: there are none in this data)."""
    rng = np.random.default_rng(6)
    B, n1, n2 = 3, 100, 120
    pairs = [_pair(rng, n1, n2) for _ in range(B)]
    d1 = np.stack([p[0] for p in pairs])
    d2 = np.stack([p[1] for p in pairs])
    v1 = np.ones((B, n1), np.float32)
    v2 = np.ones((B, n2), np.float32)
    v1[:, 90:] = 0.0  # padding rows, as the matcher's chunks have
    v2[1, 100:] = 0.0
    opts_t = matching_t.MatchingOptions(cross_check=cross_check)
    opts_j = matching_j.MatchingOptions(cross_check=cross_check)
    idx, ok, s1 = (x.numpy() for x in matching_t.match_descriptors(T(d1), T(d2), T(v1), T(v2), opts_t))
    for b in range(B):
        ji, jok, js1 = (
            np.asarray(x)
            for x in matching_j.match_descriptors(
                jnp.asarray(d1[b]), jnp.asarray(d2[b]), jnp.asarray(v1[b]), jnp.asarray(v2[b]), opts_j
            )
        )
        np.testing.assert_array_equal(idx[b], ji)
        np.testing.assert_array_equal(ok[b], jok)
        np.testing.assert_allclose(s1[b], js1, atol=SIM_ATOL)
        assert ok[b].sum() > 40


def test_match_guided_parity():
    rng = np.random.default_rng(7)
    n = 64
    base = _unit(rng, n)
    d1 = base + rng.normal(0, 0.02, base.shape).astype(np.float32)
    d2 = base + rng.normal(0, 0.02, base.shape).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    uv1 = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    uv2 = uv1 + np.asarray([20.0, 0.0], np.float32) + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    # pure x-translation: F = [t]x for t = (1, 0, 0) in pixels
    F = np.asarray([[0, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)
    v = np.ones(n, np.float32)
    opts_t = matching_t.MatchingOptions(guided_max_error=3.0)
    opts_j = matching_j.MatchingOptions(guided_max_error=3.0)
    idx, ok = (x.numpy() for x in matching_t.match_guided(T(d1), T(d2), T(uv1), T(uv2), T(v), T(v), T(F), opts_t))
    ji, jok = (
        np.asarray(x)
        for x in matching_j.match_guided(
            jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(uv1), jnp.asarray(uv2),
            jnp.asarray(v), jnp.asarray(v), jnp.asarray(F), opts_j,
        )
    )
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_array_equal(ok, jok)
    assert ok.sum() > 40
    np.testing.assert_array_equal(
        matching_t.matches_to_pairs(T(idx), T(ok)), matching_j.matches_to_pairs(ji, jok)
    )


# ---------------------------------------------------------------------------
# the uint8 path: descriptors as the database holds them, exact dot products


def _sift_u8(rng, n):
    """SIFT-like uint8 descriptors: non-negative, unit norm x 512, clipped."""
    d = rng.normal(size=(n, 128)) ** 2
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.clip(np.round(d * 512.0), 0, 255).astype(np.uint8)


def _pair_u8(rng, n1, n2, noise=6.0):
    """u2 holds noisy copies of most of u1's rows, permuted, plus clutter."""
    u1 = _sift_u8(rng, n1)
    shared = min(n1, n2) * 3 // 4
    src = np.concatenate([u1[rng.permutation(n1)[:shared]], _sift_u8(rng, n2 - shared)])
    u2 = src[rng.permutation(n2)].astype(np.float64) + rng.normal(0, noise, (n2, 128))
    return u1, np.clip(np.round(u2), 0, 255).astype(np.uint8)


def _near_threshold(s1, s2, opts, atol=SIM_ATOL):
    """Rows whose accept decision a 1e-6 change of a similarity could flip."""
    dist1 = np.arccos(np.clip(s1, -1, 1))
    dist2 = np.arccos(np.clip(s2, -1, 1))
    return (np.abs(dist1 - opts.max_distance) < 10 * atol) | (
        np.abs(dist1 - opts.max_ratio * dist2) < 10 * atol
    )


@pytest.mark.parametrize("n1,n2", [(96, 160), (300, 257)])
def test_top2_u8_reference_matches_float_reference(n1, n2):
    """match_top2_u8_reference against match_top2_reference on the normalized
    copies of the same uint8 descriptors: similarities within 1e-6 (the
    float version rounds every normalized entry, the uint8 one only the
    final scale), indices equal wherever best and second differ by more."""
    rng = np.random.default_rng(n1)
    B = 2
    pairs = [_pair_u8(rng, n1, n2) for _ in range(B)]
    u1 = T(np.stack([p[0] for p in pairs]))
    u2 = T(np.stack([p[1] for p in pairs]))
    v2 = T((rng.uniform(size=(B, n2)) > 0.2).astype(np.float32))
    inv1, inv2 = match_kernel.inverse_norms(u1), match_kernel.inverse_norms(u2)
    s1, s2, idx = match_kernel.match_top2_u8_reference(u1, u2, inv1, inv2, v2)
    r1, r2, ridx = match_kernel.match_top2_reference(
        matching_t.normalize_descriptors(u1), matching_t.normalize_descriptors(u2), v2
    )
    np.testing.assert_allclose(s1.numpy(), r1.numpy(), atol=SIM_ATOL)
    np.testing.assert_allclose(s2.numpy(), r2.numpy(), atol=SIM_ATOL)
    sep = (r1 - r2).numpy() > SIM_ATOL
    np.testing.assert_array_equal(idx.numpy()[sep], ridx.numpy()[sep])
    assert idx.dtype == torch.int32 and sep.mean() > 0.9


@pytest.mark.parametrize("cross_check", [True, False])
def test_match_descriptors_u8_parity_with_jax(cross_check):
    """The uint8 match_descriptors against the JAX match_descriptors on the
    JAX-normalized copies of the same uint8 descriptors: accept decisions
    and indices equal except within 1e-5 of a threshold or at a near-tie."""
    rng = np.random.default_rng(16)
    B, n1, n2 = 3, 120, 150
    pairs = [_pair_u8(rng, n1, n2) for _ in range(B)]
    u1 = np.stack([p[0] for p in pairs])
    u2 = np.stack([p[1] for p in pairs])
    v1 = np.ones((B, n1), np.float32)
    v2 = np.ones((B, n2), np.float32)
    v1[:, 100:] = 0.0
    u1[:, 100:] = 0  # padding rows, as the matcher's chunks have
    v2[1, 130:] = 0.0
    opts_t = matching_t.MatchingOptions(cross_check=cross_check)
    opts_j = matching_j.MatchingOptions(cross_check=cross_check)
    inv1, inv2 = match_kernel.inverse_norms(T(u1)), match_kernel.inverse_norms(T(u2))
    idx, ok, s1 = (
        x.numpy() for x in matching_t.match_descriptors_u8(T(u1), T(u2), inv1, inv2, T(v1), T(v2), opts_t)
    )
    _, s2, _ = match_kernel.match_top2_u8_reference(T(u1), T(u2), inv1, inv2, T(v2))
    for b in range(B):
        ji, jok, js1 = (
            np.asarray(x)
            for x in matching_j.match_descriptors(
                matching_j.normalize_descriptors(jnp.asarray(u1[b])),
                matching_j.normalize_descriptors(jnp.asarray(u2[b])),
                jnp.asarray(v1[b]), jnp.asarray(v2[b]), opts_j,
            )
        )
        rows = v1[b] > 0
        exempt = _near_threshold(s1[b], s2[b].numpy(), opts_t) | ((s1[b] - s2[b].numpy()) <= SIM_ATOL)
        np.testing.assert_array_equal(ok[b][~exempt], jok[~exempt])
        np.testing.assert_array_equal(idx[b][rows & ~exempt], ji[rows & ~exempt])
        np.testing.assert_allclose(s1[b][rows], js1[rows], atol=SIM_ATOL)
        assert ok[b].sum() > 40 and exempt[rows].mean() < 0.05
        # rows that are not valid report (0, False, -2)
        assert not ok[b][~rows].any() and (idx[b][~rows] == 0).all() and (s1[b][~rows] == -2).all()


def test_similarity_u8_is_exact_and_transposes_bit_for_bit():
    """The integer dot product has no summation order: the similarity equals
    the int64 dot product scaled once, and the transposed call gives the
    transposed matrix bit for bit, so the cross-check cannot flip."""
    rng = np.random.default_rng(17)
    u1, u2 = _pair_u8(rng, 70, 90)
    u1[5] = 255  # the largest dot products stay exact: 255^2 * 128 < 2^24
    u2[9] = 255
    inv1, inv2 = match_kernel.inverse_norms(T(u1)), match_kernel.inverse_norms(T(u2))
    sim = match_kernel.similarity_u8(T(u1), T(u2), inv1, inv2)
    simT = match_kernel.similarity_u8(T(u2), T(u1), inv2, inv1)
    assert torch.equal(sim, simT.mT)
    dot = u1.astype(np.int64) @ u2.astype(np.int64).T
    want = dot.astype(np.float32) * (inv1.numpy()[:, None] * inv2.numpy()[None, :])
    np.testing.assert_array_equal(sim.numpy(), want)
    # both directions of the cross-check see the same floats
    s1, _, idx = match_kernel.match_top2_u8(T(u1), T(u2), inv1, inv2, T(np.ones(90, np.float32)))
    t1, _, tidx = match_kernel.match_top2_u8(T(u2), T(u1), inv2, inv1, T(np.ones(70, np.float32)))
    mutual = tidx[idx.long()] == torch.arange(70)
    assert mutual.sum() > 30 and torch.equal(t1[idx.long()][mutual], s1[mutual])


def test_top2_u8_ties_masks_and_zero_rows():
    """Duplicated columns resolve to the lowest; a run of invalid columns as
    long as a kernel tile counts as -2 and is never picked; all columns
    invalid gives (-2, -2, 0); a zero-norm row has similarity 0 to every
    column, as the normalized float path gives; rows masked by valid1
    report (-2, -2, 0)."""
    rng = np.random.default_rng(18)
    u2 = _sift_u8(rng, 400)
    u2[300] = u2[7]  # exact duplicate at a higher column
    u1 = np.concatenate([u2[[7, 300, 3]], np.zeros((1, 128), np.uint8)])
    inv1, inv2 = match_kernel.inverse_norms(T(u1)), match_kernel.inverse_norms(T(u2))
    assert float(inv1[3]) == 0.0
    v2 = np.ones(400, np.float32)
    s1, s2, idx = match_kernel.match_top2_u8(T(u1), T(u2), inv1, inv2, T(v2))
    assert idx.tolist() == [7, 7, 3, 0]
    assert float(s1[0]) == float(s2[0])  # the twin is the second best
    assert float(s1[3]) == 0.0 and float(s2[3]) == 0.0
    f1, f2, _ = match_kernel.match_top2_reference(
        matching_t.normalize_descriptors(T(u1)), matching_t.normalize_descriptors(T(u2)), T(v2)
    )
    assert float(f1[3]) == 0.0 and float(f2[3]) == 0.0
    v2[0:256] = 0.0  # two whole 128-column tiles, with columns 3 and 7 in them
    s1, s2, idx = match_kernel.match_top2_u8(T(u1), T(u2), inv1, inv2, T(v2))
    assert idx[0] == 300 and idx[1] == 300 and idx[2] >= 256
    s1, s2, idx = match_kernel.match_top2_u8(T(u1), T(u2), inv1, inv2, T(np.zeros(400, np.float32)))
    assert s1.tolist() == [-2.0] * 4 and s2.tolist() == [-2.0] * 4 and idx.tolist() == [0] * 4
    v1 = T(np.asarray([1, 0, 1, 0], np.float32))
    s1, s2, idx = match_kernel.match_top2_u8(T(u1), T(u2), inv1, inv2, T(np.ones(400, np.float32)), v1)
    assert idx.tolist() == [7, 0, 3, 0] and s1[1] == -2 and s2[1] == -2 and s1[3] == -2


def test_top2_u8_wrapper_checks_inputs():
    u = torch.zeros((4, 128), dtype=torch.uint8)
    inv = torch.zeros(4)
    ok = torch.ones(4)
    with pytest.raises(ValueError):
        match_kernel.match_top2_u8(u.float(), u.float(), inv, inv, ok)
    with pytest.raises(ValueError):
        match_kernel.match_top2_u8(u, torch.zeros((4, 64), dtype=torch.uint8), inv, inv, ok)
    with pytest.raises(ValueError):
        match_kernel.match_top2_u8(u, u, inv, torch.zeros(5), ok)
    with pytest.raises(ValueError):
        match_kernel.match_top2_u8(u, u, inv, inv, ok, torch.ones(3))
    with pytest.raises(ValueError):
        match_kernel.match_top2_u8(u, u, inv.double(), inv.double(), ok)
    with pytest.raises(ValueError):
        match_kernel.match_top2_u8(u, torch.zeros((0, 128), dtype=torch.uint8), inv, torch.zeros(0), torch.ones(0))


@pytest.mark.parametrize("blocks,n2,tile,wanted", [(256, 2048, 128, 1), (64, 8192, 128, 4), (8, 1537, 128, 33), (1, 100, 64, 528)])
def test_split_columns_covers_the_columns(blocks, n2, tile, wanted):
    """The column split the wrappers hand to the kernels: tile-multiple
    chunks that cover every column, no empty split."""
    chunk, splits = match_kernel.split_columns(n2, tile, wanted)
    assert chunk % tile == 0 and splits >= 1
    assert splits * chunk >= n2 > (splits - 1) * chunk
    assert splits <= max(1, wanted)
