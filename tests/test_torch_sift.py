"""SIFT of the PyTorch port against the JAX package on the same numpy
inputs (CPU), stage by stage and as a whole, and the behaviours of
tests/test_sift.py on the port alone.

Tolerances are stated where they are used. Detection parity is a parity of
keypoint SETS: differences of ~1e-7 in the pyramid move a few extrema
across a threshold, and a near-tied orientation histogram may peak in
another bin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage
from scipy.spatial import cKDTree

from colmap_pcd_tpu.ops import sift as jsift
from colmap_pcd_tpu_torch.ops import matching as tmatching
from colmap_pcd_tpu_torch.ops import sift as tsift

from test_sift import make_texture

torch.set_num_threads(1)  # the suite runs several workers on few cores

OPTS = dict(max_num_features=512, max_per_octave=512, first_octave=0, num_octaves=3)

# (a) stages: absolute, on images in [0, 1]
STAGE_ATOL = 2e-6
# (b) orientation + descriptor on identical inputs: orientation within
# ORI_ATOL rad on ORI_SHARE of the keypoints (measured: 1.2e-6 rad on 99.25%),
# float descriptors within DESC_ATOL max-abs there (measured 5.0e-6), uint8
# codes within +-1 on U8_SHARE of the entries (measured: all; 99.98% equal)
ORI_ATOL, ORI_SHARE = 1e-4, 0.99
DESC_ATOL = 1e-4
U8_SHARE = 0.999
# (c) whole extract: PARTNER_SHARE of each side's valid keypoints have a
# partner within PARTNER_PX pixels and PARTNER_SCALE relative scale (measured:
# all, within 1.4e-3 px and 1.4e-4), with descriptor cosine >= PARTNER_COS
PARTNER_PX, PARTNER_SCALE, PARTNER_SHARE = 0.01, 1e-3, 0.98
PARTNER_COS = 0.995


def _texture(size, seed=0):
    if size == 64:  # the dense middle of a 128x128 texture
        return make_texture(np.random.default_rng(seed), H=128, W=128, n_blobs=160)[32:96, 32:96].copy()
    return make_texture(np.random.default_rng(seed), H=size, W=size, n_blobs=80 if size >= 256 else 40)


def _both(**kw):
    return jsift.SiftOptions(**kw), tsift.SiftOptions(**kw)


# ------------------------------------------------------------------ (a) stages
@pytest.mark.parametrize("size", [128, 256])
def test_blur_and_upsample_parity(size):
    img = _texture(size)
    for sigma in (1.2263, 1.5199, 3.0901):
        ref = np.asarray(jsift._blur(jnp.asarray(img), sigma))
        got = tsift._blur(torch.as_tensor(img), sigma).numpy()
        assert np.abs(got - ref).max() <= STAGE_ATOL, sigma
    # a batch blurs each image for itself
    stack = np.stack([img, img[::-1].copy()])
    got = tsift._blur(torch.as_tensor(stack), 1.5199).numpy()
    np.testing.assert_array_equal(got[0], tsift._blur(torch.as_tensor(img), 1.5199).numpy())
    ref = np.asarray(jsift._upsample2(jnp.asarray(img)))
    got = tsift._upsample2(torch.as_tensor(img)).numpy()
    assert got.shape == ref.shape == (2 * size, 2 * size)
    assert np.abs(got - ref).max() <= STAGE_ATOL
    # the borders: half-pixel centres repeat the edge pixel
    for edge in (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]):
        assert np.abs(got[edge] - ref[edge]).max() <= STAGE_ATOL


def _jax_octave(img, opts):
    """One octave's level stack and DoG, as the JAX `extract` builds them."""
    S = opts.octave_resolution
    extra = float(np.sqrt(max(opts.sigma0**2 - opts.init_blur**2, 0.01)))
    levels = [jsift._blur(jnp.asarray(img), extra)]
    for s in range(1, S + 3):
        prev, cur = opts.sigma0 * 2 ** ((s - 1) / S), opts.sigma0 * 2 ** (s / S)
        levels.append(jsift._blur(levels[-1], float(np.sqrt(cur**2 - prev**2))))
    G = jnp.stack(levels)
    return np.asarray(G), np.asarray(G[1:] - G[:-1])


def _gate_margins(dog, opts):
    """Per pixel of the S inner levels, how far (float64) each gate of
    `_extrema_candidates` is from flipping: the peak threshold, the
    extremum test against the 26 neighbours, the edge test (relative)."""
    d = dog.astype(np.float64)
    c = d[1:-1]
    others = np.ones((3, 3, 3), bool)
    others[1, 1, 1] = False
    mx = ndimage.maximum_filter(d, footprint=others, mode="constant", cval=-np.inf)[1:-1]
    mn = ndimage.minimum_filter(d, footprint=others, mode="constant", cval=np.inf)[1:-1]
    peak = np.abs(np.abs(c) - opts.peak_threshold)
    extremum = np.minimum(np.abs(c - mx), np.abs(c - mn))
    p = np.pad(c, ((0, 0), (1, 1), (1, 1)))
    dxx = p[:, 1:-1, 2:] + p[:, 1:-1, :-2] - 2 * c
    dyy = p[:, 2:, 1:-1] + p[:, :-2, 1:-1] - 2 * c
    dxy = 0.25 * (p[:, 2:, 2:] + p[:, :-2, :-2] - p[:, 2:, :-2] - p[:, :-2, 2:])
    tr, det = dxx + dyy, dxx * dyy - dxy * dxy
    r = opts.edge_threshold
    lhs, rhs = tr * tr * r, (r + 1) ** 2 * det
    edge = np.abs(lhs - rhs) / np.maximum(np.maximum(np.abs(lhs), np.abs(rhs)), 1e-30)
    return peak, extremum, edge


@pytest.mark.parametrize("size", [128, 256])
def test_scale_space_and_extrema_parity(size):
    jo, to = _both(**OPTS)
    img = _texture(size)
    G_ref, dog_ref = _jax_octave(img, jo)
    Gs = tsift._detect(torch.as_tensor(img)[None], to)[0]
    G = Gs[0][0].numpy()
    assert G.shape == G_ref.shape
    assert np.abs(G - G_ref).max() <= STAGE_ATOL
    dog = G[1:] - G[:-1]
    assert np.abs(dog - dog_ref).max() <= STAGE_ATOL
    # the next octave starts from level S, every second pixel
    np.testing.assert_array_equal(Gs[1][0, 0].numpy(), G[to.octave_resolution][::2, ::2])

    # the score map: on the SAME DoG both packages must find the same
    # support, except at pixels where a gate is within 1e-5 of flipping
    # (the edge gate: within 1e-5 relative); there, and only there, an
    # f32 rounding may decide
    s_ref = np.asarray(jsift._extrema_candidates(jnp.asarray(dog_ref), jo))
    s_got = tsift._extrema_candidates(torch.as_tensor(dog_ref)[None], to)[0].numpy()
    assert (s_ref > 0).sum() > 20
    differ = (s_ref > 0) != (s_got > 0)
    peak, extremum, edge = _gate_margins(dog_ref, jo)
    near = (peak < 1e-5) | (extremum < 1e-5) | (edge < 1e-5)
    assert not (differ & ~near).any(), int((differ & ~near).sum())
    same = (s_ref > 0) & (s_got > 0)
    np.testing.assert_array_equal(s_got[same], s_ref[same])
    # and on each package's own DoG (2e-6 apart), except near a gate
    s_own = tsift._extrema_candidates(torch.as_tensor(dog)[None], to)[0].numpy()
    differ = (s_ref > 0) != (s_own > 0)
    near = (peak < 1e-5) | (extremum < 1e-5) | (edge < 1e-2)
    assert not (differ & ~near).any(), int((differ & ~near).sum())


def test_pack_bilinear_table_parity():
    rng = np.random.default_rng(1)
    mag = rng.uniform(0, 0.3, (3, 20, 24)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (3, 20, 24)).astype(np.float32)
    ref = np.asarray(jsift._pack_bilinear_table(jnp.asarray(mag), jnp.asarray(ang)).astype(jnp.float32))
    got = tsift._pack_bilinear_table(torch.as_tensor(mag), torch.as_tensor(ang))
    assert got.dtype == torch.bfloat16
    # bfloat16 rounds to nearest even in both frameworks: equal bits
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_top_k_takes_the_lowest_index_among_equals():
    score = torch.tensor([[0.0, 3.0, 1.0, 3.0, 0.0, 1.0, 2.0, 0.0]])
    top, idx = tsift._top_k(score, 6)
    ref_top, ref_idx = jax.lax.top_k(jnp.asarray(score.numpy()), 6)
    np.testing.assert_array_equal(top.numpy(), np.asarray(ref_top))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


# ------------------------------------- (b) orientation + descriptor, same inputs
def _detected(img, to):
    """The port's detection half as numpy, with the level stacks also padded
    to the base plane as the JAX package lays them out."""
    Gs, kx, ky, sigma_rel, lev, wh, mul, top, valid = tsift._detect(torch.as_tensor(img)[None], to)
    H0, W0 = Gs[0].shape[-2:]
    Gall = np.concatenate([
        np.pad(G[0].numpy(), ((0, 0), (0, H0 - G.shape[-2]), (0, W0 - G.shape[-1]))) for G in Gs
    ])
    return Gs, Gall, (kx, ky, sigma_rel, lev, wh), valid[0].numpy()


@pytest.mark.parametrize("name,size,variant", [
    ("default", 256, {}),
    ("upright_l2", 128, dict(upright=True, l1_root=False)),
    ("dsp_affine", 128, dict(domain_size_pooling=True, dsp_num_scales=5, estimate_affine_shape=True)),
])
def test_orientation_and_descriptor_parity(name, size, variant):
    jo, to = _both(**OPTS, **variant)
    Gs, Gall, (kx, ky, sigma_rel, lev, wh), valid = _detected(_texture(size), to)
    assert valid.sum() > 40

    @jax.jit
    def ref_fn(G, kx, ky, sr, lev, wl, hl):
        return jsift._orientation_and_descriptor(G, kx, ky, sr, jo, lidx=lev, wh=(wl, hl))

    ori_ref, desc_ref = (np.asarray(a) for a in ref_fn(
        jnp.asarray(Gall), jnp.asarray(kx[0].numpy()), jnp.asarray(ky[0].numpy()),
        jnp.asarray(sigma_rel[0].numpy()), jnp.asarray(lev[0].numpy().astype(np.int32)),
        jnp.asarray(wh[0][0].numpy().astype(np.int32)), jnp.asarray(wh[1][0].numpy().astype(np.int32)),
    ))
    ori, desc = tsift._orientation_and_descriptor(Gs, kx, ky, sigma_rel, to, lidx=lev, wh=wh)
    # the levels laid end to end read the same rows as the padded stack
    ori_p, desc_p = tsift._orientation_and_descriptor(
        torch.as_tensor(Gall)[None], kx, ky, sigma_rel, to, lidx=lev, wh=wh
    )
    assert torch.equal(ori, ori_p) and torch.equal(desc, desc_p)

    ori, desc = ori[0].numpy()[valid], desc[0].numpy()[valid]
    ori_ref, desc_ref = ori_ref[valid], desc_ref[valid]
    d_ori = np.abs(np.angle(np.exp(1j * (ori - ori_ref))))
    same = d_ori <= ORI_ATOL
    # the rest are near-tied histogram peaks (another bin, or the clamp of
    # the parabola): their descriptors are rotated and not comparable
    assert same.mean() >= ORI_SHARE, (same.mean(), np.sort(d_ori)[-5:])
    err = np.abs(desc[same] - desc_ref[same]).max()
    assert err <= DESC_ATOL, err
    u8 = tsift.descriptors_to_uint8(torch.as_tensor(desc[same])).numpy().astype(np.int32)
    u8_ref = np.asarray(jsift.descriptors_to_uint8(jnp.asarray(desc_ref[same]))).astype(np.int32)
    assert (np.abs(u8 - u8_ref) <= 1).mean() >= U8_SHARE
    print(f"[{name}] orientation share {same.mean():.4f}, max |ori| diff there "
          f"{d_ori[same].max():.3g}, max |desc| diff {err:.3g}, uint8 within 1: "
          f"{(np.abs(u8 - u8_ref) <= 1).mean():.5f}, equal: {(u8 == u8_ref).mean():.5f}")


def test_descriptors_to_uint8_rounds_half_to_even():
    d = np.asarray([[0.5 / 512, 1.5 / 512, 2.5 / 512, 0.6, -0.1, 0.25]], np.float32)
    got = tsift.descriptors_to_uint8(torch.as_tensor(d))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsift.descriptors_to_uint8(jnp.asarray(d))))
    np.testing.assert_array_equal(got.numpy(), [[0, 2, 2, 255, 0, 128]])


# ------------------------------------------------------------ (c) whole extract
def _partners(kp_a, kp_b):
    """For each keypoint of a, its nearest in b, and whether it lies within
    PARTNER_PX and PARTNER_SCALE (relative)."""
    d, j = cKDTree(kp_b[:, :2]).query(kp_a[:, :2])
    ok = (d <= PARTNER_PX) & (np.abs(kp_b[j, 2] / kp_a[:, 2] - 1.0) <= PARTNER_SCALE)
    return j, ok


def _assert_extract_parity(ref, got, label, good_share=ORI_SHARE):
    (kp_r, d_r, s_r, v_r), (kp_g, d_g, s_g, v_g) = ref, got
    assert kp_g.shape == kp_r.shape and d_g.shape == d_r.shape and v_g.shape == v_r.shape
    kp_r, d_r, kp_g, d_g = kp_r[v_r], d_r[v_r], kp_g[v_g], d_g[v_g]
    assert len(kp_r) > 20 and len(kp_g) > 20
    j, ok = _partners(kp_r, kp_g)
    _, ok_back = _partners(kp_g, kp_r)
    assert ok.mean() >= PARTNER_SHARE and ok_back.mean() >= PARTNER_SHARE, (ok.mean(), ok_back.mean())
    a, b = d_r[ok], d_g[j[ok]]
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    same_ori = np.abs(np.angle(np.exp(1j * (kp_r[ok, 3] - kp_g[j[ok], 3])))) <= ORI_ATOL
    # a partner whose orientation histogram peaked in another bin carries a
    # rotated descriptor: it counts against the share
    good = same_ori & (cos >= PARTNER_COS)
    print(f"[{label}] valid {len(kp_r)} vs {len(kp_g)}, partners {ok.mean():.4f} / {ok_back.mean():.4f}, "
          f"same orientation {same_ori.mean():.4f}, cosine >= {PARTNER_COS} at the same orientation "
          f"{good.mean():.4f}, min cosine there {cos[same_ori].min():.6f}")
    # the share, or all but one where the keypoints are few
    assert (~good).sum() <= max(1, int((1.0 - good_share) * len(good))), (good.mean(), np.sort(cos)[:6])


def _extract_both(img, jo, to):
    ref = tuple(np.asarray(a) for a in jsift.extract(jnp.asarray(img), jo))
    got = tuple(a.numpy() for a in tsift.extract(torch.as_tensor(img), to))
    return ref, got


@pytest.mark.parametrize("name,good_share", [("blobs128", 0.99), ("blobs256", 0.95), ("corridor", 0.99)])
def test_extract_parity(name, good_share):
    """Whole `extract`. The 256x256 blob texture holds exactly symmetric
    blobs centred on pixels: their orientation histograms are flat and their
    angle samples lie on the +-pi wrap, where 1e-6 in the pyramid decides,
    so 95% is asked there (measured 0.9624) and 99% on the 128x128 texture
    and on a rendered corridor view (measured 1.0 and 0.9946)."""
    if name == "corridor":
        from render_torch import render_corridor

        img = render_corridor(np.asarray([1.0, 0, 0, 0]), np.zeros(3), 320, 240, 260.0)
    else:
        img = _texture(int(name[5:]))
    jo, to = _both(**OPTS)
    ref, got = _extract_both(img, jo, to)
    _assert_extract_parity(ref, got, name, good_share)


@pytest.mark.parametrize("name,variant", [
    ("upright", dict(upright=True)),
    ("l2", dict(l1_root=False)),
    ("first_octave_-1", dict(first_octave=-1, num_octaves=3)),
])
def test_extract_parity_variants(name, variant):
    """64x64 inputs; first_octave=-1 runs the 2x upsampled base octave."""
    kw = dict(max_num_features=128, max_per_octave=128, first_octave=0, num_octaves=2)
    kw.update(variant)
    jo, to = _both(**kw)
    ref, got = _extract_both(_texture(64, seed=3), jo, to)
    _assert_extract_parity(ref, got, name)
    if name == "upright":
        assert not got[0][..., 3].any()


# -------------------------------------- (d) test_sift.py's behaviours on the port
TOPTS = tsift.SiftOptions(**OPTS)


def _extract(img, opts=TOPTS):
    return tsift.extract(torch.as_tensor(img), opts)


def _match(d1, d2, v1, v2, **kw):
    idx, ok, _ = tmatching.match_descriptors_reference(
        d1, d2, v1.float(), v2.float(), tmatching.MatchingOptions(**kw)
    )
    return idx.numpy(), ok.numpy()


def test_detects_blobs(rng):
    img = make_texture(rng)
    kp, desc, score, valid = (a.numpy() for a in _extract(img))
    assert valid.sum() >= 50, valid.sum()
    assert (kp[valid][:, 0] >= 0).all() and (kp[valid][:, 0] < 256).all()
    norms = np.linalg.norm(desc[valid], axis=1)
    assert np.all(norms < 1.5) and np.median(norms) > 0.5
    # scores descend and the valid rows come first
    assert (np.diff(score) <= 0).all() and valid[: valid.sum()].all()


def test_shift_covariance(rng):
    img = make_texture(rng)
    shift = 16
    img2 = np.roll(img, (shift, shift), axis=(0, 1))
    kp1, d1, _, v1 = _extract(img)
    kp2, d2, _, v2 = _extract(img2)
    idx, ok = _match(d1, d2, v1, v2, max_ratio=0.8, cross_check=True)
    assert ok.sum() >= 30, ok.sum()
    err = np.abs(kp2.numpy()[idx[ok], :2] - kp1.numpy()[ok, :2] - shift)
    assert (err.max(axis=1) < 1.5).mean() > 0.8


def test_rotation_matching(rng):
    """90-degree rotation: descriptors must still match via orientation
    normalization (exact rotation so no resampling blur)."""
    img = make_texture(rng)
    img2 = np.rot90(img).copy()
    kp1, d1, _, v1 = _extract(img)
    kp2, d2, _, v2 = _extract(img2)
    idx, ok = _match(d1, d2, v1, v2, max_ratio=0.85, cross_check=True)
    assert ok.sum() >= 20, ok.sum()
    W = img.shape[1]
    kp1, kp2 = kp1.numpy(), kp2.numpy()
    err = np.hypot(kp2[idx[ok], 0] - kp1[ok, 1], kp2[idx[ok], 1] - (W - 1 - kp1[ok, 0]))
    assert (err < 2.0).mean() > 0.7, (err < 2.0).mean()


def test_uint8_roundtrip(rng):
    img = make_texture(rng)
    _, d1, _, v1 = _extract(img)
    u8 = tsift.descriptors_to_uint8(d1)
    assert u8.dtype == torch.uint8
    idx, ok = _match(
        tmatching.normalize_descriptors(u8), tmatching.normalize_descriptors(d1 * 512), v1, v1
    )
    v = v1.numpy()
    assert (idx[v & ok] == np.nonzero(v & ok)[0]).mean() > 0.95


def test_dsp_sift_descriptors(rng):
    img = make_texture(rng, H=128, W=128, n_blobs=40)
    base = tsift.SiftOptions(max_num_features=256, num_octaves=2, first_octave=0, max_per_octave=256)
    dsp = base._replace(domain_size_pooling=True, dsp_num_scales=5)
    kp1, d1, _, v1 = (a.numpy() for a in _extract(img, base))
    kp2, d2, _, v2 = (a.numpy() for a in _extract(img, dsp))
    assert v2.sum() > 10
    np.testing.assert_allclose(kp1[v2], kp2[v2], atol=1e-5)
    np.testing.assert_allclose((d2[v2] ** 2).sum(-1), 1.0, atol=1e-3)
    assert np.abs(d2[v2] - d1[v2]).max() > 1e-3


def test_affine_shape_extraction():
    from render_torch import render_corridor

    q = np.asarray([1.0, 0, 0, 0])
    img1 = render_corridor(q, np.zeros(3), 320, 240, 260.0)
    img2 = render_corridor(q, np.asarray([0.0, 0, -0.4]), 320, 240, 260.0)
    opts = tsift.SiftOptions(
        max_num_features=512, first_octave=0, num_octaves=3, estimate_affine_shape=True
    )
    _, d1, _, v1 = _extract(img1, opts)
    _, d2, _, v2 = _extract(img2, opts)
    assert int(v1.sum()) > 100
    _, ok = _match(tmatching.normalize_descriptors(d1), tmatching.normalize_descriptors(d2), v1, v2)
    assert int(ok.sum()) > 40, int(ok.sum())


def test_render_torch_equals_render():
    """tests/render_torch.py draws the same pixels as tests/render.py."""
    import render
    import render_torch

    q = np.asarray([np.cos(0.01), 0.0, np.sin(0.01), 0.0])
    t = np.asarray([0.2, -0.1, -0.8])
    np.testing.assert_array_equal(
        render_torch.render_corridor(q, t, 160, 120, 130.0), render.render_corridor(q, t, 160, 120, 130.0)
    )
    params = np.asarray([130.0, 130.0, 80.0, 60.0, -0.12, 0.05, 0.001, -0.0005])
    np.testing.assert_array_equal(
        render_torch.render_corridor(q, t, 160, 120, 130.0, model_id=4, params=params),
        render.render_corridor(q, t, 160, 120, 130.0, model_id=4, params=params),
    )


# ------------------------------------------------------------- (e) the batch
def test_extract_batch_equals_single_extracts_and_is_not_padded():
    imgs = np.stack([_texture(128, seed=s) for s in (0, 1, 2)])
    opts = tsift.SiftOptions(max_num_features=256, max_per_octave=256, first_octave=0, num_octaves=2)
    batch = tsift.extract_batch(torch.as_tensor(imgs), opts)
    assert [tuple(a.shape) for a in batch] == [(3, 256, 4), (3, 256, 128), (3, 256), (3, 256)]
    for b in range(3):
        for got, ref in zip(batch, tsift.extract(torch.as_tensor(imgs[b]), opts)):
            assert torch.equal(got[b], ref)


def test_uint8_input_equals_float_input():
    u8 = (np.clip(_texture(128), 0, 1) * 255).astype(np.uint8)
    opts = tsift.SiftOptions(max_num_features=256, max_per_octave=256, first_octave=0, num_octaves=2)
    from_u8 = tsift.extract(torch.as_tensor(u8), opts)
    from_f32 = tsift.extract(torch.as_tensor(u8.astype(np.float32) * np.float32(1.0 / 255.0)), opts)
    for a, b in zip(from_u8, from_f32):
        assert torch.equal(a, b)
    # and, as the JAX package divides, within rounding of x / 255
    kp = tsift.extract(torch.as_tensor(u8.astype(np.float32) / 255.0), opts)[0]
    assert from_u8[3].sum() > 20 and torch.allclose(kp, from_u8[0], atol=1e-3)


def test_fewer_candidates_than_features_are_padded_invalid():
    opts = tsift.SiftOptions(max_num_features=4096, max_per_octave=512, first_octave=0, num_octaves=2)
    kp, desc, score, valid = tsift.extract(torch.as_tensor(_texture(64, seed=3)), opts)
    assert kp.shape == (4096, 4) and desc.shape == (4096, 128)
    assert 0 < int(valid.sum()) < 1024 and not valid[1024:].any() and not score[1024:].any()


def test_solve3_against_linalg_solve():
    from colmap_pcd_tpu_torch.ops.solvers import solve3

    rng = np.random.default_rng(5)
    A = rng.normal(size=(200, 3, 3))
    M = torch.as_tensor(A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3), dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=(200, 3)), dtype=torch.float32)
    ref = torch.linalg.solve(M.double(), b.double()[..., None])[..., 0]
    assert (solve3(M, b).double() - ref).abs().max() < 1e-3 * ref.abs().max()
