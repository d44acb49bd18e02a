"""The port against the JAX package at the options of the reference feature
scale (bench.py with BENCH_REF_SCALE=1: 1280x960 images, f = 1000, 8192
features, 4 octaves, first octave 0), on the same numpy inputs on the CPU:
SIFT on a rendered corridor view, the matcher's plain uint8 top-2 on a
chunk padded to cap 8192, and the two-view RANSAC banks of one pair with
thousands of correspondences on shared sample indices. Tolerances are
those of tests/test_torch_sift.py, tests/test_torch_matching.py and
tests/test_torch_two_view.py, restated where they are used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from colmap_pcd_tpu.ops import matching as matching_j
from colmap_pcd_tpu.ops import ransac as ransac_j
from colmap_pcd_tpu.ops import se3 as se3_j
from colmap_pcd_tpu.ops import sift as sift_j
from colmap_pcd_tpu_torch.ops import match_kernel
from colmap_pcd_tpu_torch.ops import matching as matching_t
from colmap_pcd_tpu_torch.ops import ransac as ransac_t
from colmap_pcd_tpu_torch.ops import sift as sift_t
from render_torch import render_corridor
from synthetic_torch import make_trajectory

torch.set_num_threads(1)  # tier-1 runs several workers on few cores

T = torch.as_tensor
J = jnp.asarray

REF_OPTS = dict(max_num_features=8192, first_octave=0, num_octaves=4)

# SIFT (tests/test_torch_sift.py's whole-extract parity): PARTNER_SHARE of
# each side's valid keypoints have a partner within PARTNER_PX pixels and
# PARTNER_SCALE relative scale; of the partners, GOOD_SHARE have the same
# orientation (ORI_ATOL rad) and descriptor cosine >= PARTNER_COS
PARTNER_PX, PARTNER_SCALE, PARTNER_SHARE = 0.01, 1e-3, 0.98
ORI_ATOL, PARTNER_COS, GOOD_SHARE = 1e-4, 0.995, 0.99
# similarities: f32 dot products of unit vectors summed in another order
SIM_ATOL = 1e-6


@pytest.mark.parametrize("width,height,focal", [(640, 480, 500.0), (1280, 960, 1000.0)])
def test_sift_parity_at_the_reference_options(width, height, focal):
    """Whole `extract` of one rendered corridor view (the pixel world's
    third pose) with 4 octaves and the 8192 cap: no parity test ran either
    before. The corridor gives ~450 keypoints at 640x480 and ~750 at
    1280x960, far below the cap, so every candidate above the threshold is
    kept in both packages."""
    img = render_corridor(*make_trajectory(3)[2], width, height, focal)
    ref = tuple(np.asarray(a) for a in sift_j.extract(J(img), sift_j.SiftOptions(**REF_OPTS)))
    got = tuple(a.numpy() for a in sift_t.extract(T(img), sift_t.SiftOptions(**REF_OPTS)))
    (kp_r, d_r, _, v_r), (kp_g, d_g, _, v_g) = ref, got
    assert kp_g.shape == kp_r.shape == (8192, 4) and v_g.shape == v_r.shape
    kp_r, d_r, kp_g, d_g = kp_r[v_r], d_r[v_r], kp_g[v_g], d_g[v_g]
    assert len(kp_r) > 300 and len(kp_g) > 300

    def partners(a, b):
        d, j = cKDTree(b[:, :2]).query(a[:, :2])
        return j, (d <= PARTNER_PX) & (np.abs(b[j, 2] / a[:, 2] - 1.0) <= PARTNER_SCALE)

    j, ok = partners(kp_r, kp_g)
    _, ok_back = partners(kp_g, kp_r)
    assert ok.mean() >= PARTNER_SHARE and ok_back.mean() >= PARTNER_SHARE, (ok.mean(), ok_back.mean())
    a, b = d_r[ok], d_g[j[ok]]
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    same_ori = np.abs(np.angle(np.exp(1j * (kp_r[ok, 3] - kp_g[j[ok], 3])))) <= ORI_ATOL
    good = same_ori & (cos >= PARTNER_COS)
    print(f"[{width}x{height}] valid {len(kp_r)} vs {len(kp_g)}, partners {ok.mean():.4f} / "
          f"{ok_back.mean():.4f}, good {good.mean():.4f}")
    assert good.mean() >= GOOD_SHARE, (good.mean(), np.sort(cos)[:6])
    # the coarsest octave detects too: the fourth octave is in use
    assert kp_r[:, 2].max() > 8 * 1.6 and kp_g[:, 2].max() > 8 * 1.6


def _sift_u8(rng, n):
    """SIFT-like uint8 descriptors: non-negative, unit norm x 512, clipped."""
    d = rng.normal(size=(n, 128)) ** 2
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.clip(np.round(d * 512.0), 0, 255).astype(np.uint8)


def _padded_pair(rng, cap, n1, n2, noise=6.0):
    """A pair padded to `cap` rows as the matcher pads a chunk: u2 holds
    noisy copies of most of u1's valid rows, permuted, plus clutter."""
    u1 = _sift_u8(rng, n1)
    shared = min(n1, n2) * 3 // 4
    src = np.concatenate([u1[rng.permutation(n1)[:shared]], _sift_u8(rng, n2 - shared)])
    u2 = np.clip(np.round(src[rng.permutation(n2)] + rng.normal(0, noise, (n2, 128))), 0, 255)
    p1, p2 = np.zeros((cap, 128), np.uint8), np.zeros((cap, 128), np.uint8)
    p1[:n1], p2[:n2] = u1, u2.astype(np.uint8)
    v1, v2 = np.zeros(cap, np.float32), np.zeros(cap, np.float32)
    v1[:n1], v2[:n2] = 1.0, 1.0
    return p1, p2, v1, v2


@pytest.mark.parametrize("cross_check", [True, False])
def test_uint8_top2_at_cap_8192_matches_jax(cross_check):
    """The matcher's plain uint8 K1 twin (match_descriptors_u8 on the CPU)
    on a chunk of two pairs padded to cap 8192, one with the reference
    scale run's ~800 keypoints per view and one near the cap, against the
    JAX match_descriptors on the JAX-normalized copies of the same padded
    pairs: indices and accept decisions equal, except at rows within 1e-5
    of a threshold or whose best and second best lie within 1e-6 (f32 sums
    in another order; tests/test_torch_matching.py's rule), which must stay
    under 1% of the valid rows; similarities within 1e-6."""
    rng = np.random.default_rng(8192 + cross_check)
    cap = 8192
    pairs = [_padded_pair(rng, cap, 800, 850), _padded_pair(rng, cap, 8000, 7500)]
    u1, u2, v1, v2 = (np.stack(x) for x in zip(*pairs))
    opts_t = matching_t.MatchingOptions(cross_check=cross_check)
    opts_j = matching_j.MatchingOptions(cross_check=cross_check)
    inv1, inv2 = match_kernel.inverse_norms(T(u1)), match_kernel.inverse_norms(T(u2))
    idx, ok, s1 = (x.numpy() for x in matching_t.match_descriptors_u8(
        T(u1), T(u2), inv1, inv2, T(v1), T(v2), opts_t))
    _, s2, _ = (x.numpy() for x in match_kernel.match_top2_u8_reference(T(u1), T(u2), inv1, inv2, T(v2)))
    assert idx.shape == ok.shape == (2, cap)
    for b in range(2):
        ji, jok, js1 = (np.asarray(x) for x in matching_j.match_descriptors(
            matching_j.normalize_descriptors(J(u1[b])), matching_j.normalize_descriptors(J(u2[b])),
            J(v1[b]), J(v2[b]), opts_j,
        ))
        rows = v1[b] > 0
        dist1, dist2 = np.arccos(np.clip(s1[b], -1, 1)), np.arccos(np.clip(s2[b], -1, 1))
        exempt = ((np.abs(dist1 - opts_t.max_distance) < 1e-5)
                  | (np.abs(dist1 - opts_t.max_ratio * dist2) < 1e-5) | ((s1[b] - s2[b]) <= SIM_ATOL))
        np.testing.assert_array_equal(ok[b][~exempt], jok[~exempt])
        np.testing.assert_array_equal(idx[b][rows & ~exempt], ji[rows & ~exempt])
        np.testing.assert_allclose(s1[b][rows], js1[rows], atol=SIM_ATOL)
        assert ok[b].sum() > 0.4 * rows.sum() and exempt[rows].mean() < 0.01, (ok[b].sum(), exempt[rows].mean())
        # the padding rows report (0, False, -2)
        assert not ok[b][~rows].any() and (idx[b][~rows] == 0).all() and (s1[b][~rows] == -2).all()


def _many_matches(rng, kind, n, cap, outliers=0.2, noise=0.3):
    """n correspondences of a rigid scene (a plane for the homography) seen
    from two views, in pixels (f = 800), a share of them outliers, padded
    to cap; for the essential bank in normalized coordinates."""
    R = np.asarray(se3_j.quat_to_rotmat(se3_j.so3_exp_quat(J(rng.normal(size=3) * 0.05, jnp.float32))))
    t = np.asarray([1.0, 0.1, 0.05]) + rng.normal(0, 0.1, 3)
    X = rng.uniform(-3, 3, (n, 3)) + np.asarray([0, 0, 10.0])
    if kind == "homography":
        X[:, 2] = 10.0
    Xc = X @ R.T + t
    x1, x2 = X[:, :2] / X[:, 2:], Xc[:, :2] / Xc[:, 2:]
    if kind != "essential":
        x1 = x1 * 800.0 + np.asarray([320.0, 240.0])
        x2 = x2 * 800.0 + np.asarray([320.0, 240.0]) + rng.normal(0, noise, (n, 2))
    bad = rng.uniform(size=n) < outliers
    span = (0.4, -0.4) if kind == "essential" else (640.0, 0.0)
    x2[bad] = rng.uniform(0, 1, (bad.sum(), 2)) * span[0] + span[1]
    p1, p2 = np.zeros((cap, 2), np.float32), np.zeros((cap, 2), np.float32)
    p1[:n], p2[:n] = x1, x2
    return p1, p2, (np.arange(cap) < n).astype(np.float32)


@pytest.mark.parametrize("kind", ["fundamental", "essential", "homography"])
def test_ransac_bank_with_thousands_of_matches_on_shared_samples(kind):
    """One pair of 4 000 correspondences padded to cap 4096 (a matcher
    chunk at the reference scale holds a few thousand matches per pair at
    most) through the port's bank, fed the indices JAX's _draw_samples
    draws with the key the JAX bank uses, at the matcher's 1024 hypotheses:
    the model agrees up to sign and scale within 2e-3 and the inlier count
    within 1 (tests/test_torch_two_view.py's tolerances). The essential
    bank gets exact correspondences and no outliers: five-point roots
    differ in their last f32 digits between the two eigh bases, and at
    4 000 correspondences with 20% uniform outliers the 4 px threshold
    keeps a few outliers that the LO refits follow, so both packages land
    0.003-0.11 from the true E and up to 0.11 apart, with inlier counts
    within 2 (measured over seeds 5-7 and 18); with exact data both land
    within 1e-3 of the truth."""
    rng = np.random.default_rng({"fundamental": 17, "essential": 18, "homography": 19}[kind])
    hyps = 1024
    opts_j = ransac_j.RansacOptions(max_error=4.0, num_hypotheses=hyps)
    opts_t = ransac_t.RansacOptions(max_error=4.0, num_hypotheses=hyps)
    k, per = {"fundamental": (7, 3), "essential": (5, 10), "homography": (4, 1)}[kind]
    exact = kind == "essential"
    p1, p2, valid = _many_matches(rng, kind, 4000, 4096, outliers=0.0 if exact else 0.2,
                                  noise=0.0 if exact else 0.3)
    key = jax.random.PRNGKey(3)
    idx = np.asarray(ransac_j._draw_samples(key, J(valid), hyps // per, k))
    extra_j = {"max_error": 4.0 / 800.0} if kind == "essential" else {}
    res_j = getattr(ransac_j, f"ransac_{kind}")(J(p1), J(p2), J(valid), key, opts_j, **extra_j)
    extra_t = {"max_error": T(np.full(1, 4.0 / 800.0, np.float32))} if kind == "essential" else {}
    res_t = getattr(ransac_t, f"ransac_{kind}")(
        T(p1[None]), T(p2[None]), T(valid[None]), None, opts_t, sample_idx=T(idx[None]), **extra_t)
    a = res_t.model[0].numpy().astype(np.float64).ravel()
    b = np.asarray(res_j.model, np.float64).ravel()
    a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
    assert min(np.abs(a - b).max(), np.abs(a + b).max()) < 2e-3
    n_t, n_j = int(res_t.num_inliers[0]), int(res_j.num_inliers)
    assert abs(n_t - n_j) <= 1, (n_t, n_j)
    assert n_t > 2800, n_t
