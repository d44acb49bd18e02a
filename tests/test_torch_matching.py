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
