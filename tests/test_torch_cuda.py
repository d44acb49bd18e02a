"""Tests of the port that need an NVIDIA GPU (marked `cuda`; they skip
without one). This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from colmap_pcd_tpu_torch.ops import match_kernel, matching, nn_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("Q", [37, 4096])
def test_nn_kernel_matches_plain_version(cuda_device, Q):
    """The hand-written kernel against its plain version at the mapper's
    query counts and a ragged ~0-105 m map: distances to 1e-5 relative,
    indices equal except where both points are equally near."""
    rng = np.random.default_rng(Q)
    p = rng.uniform([-4, -2, 0], [4, 2, 105], (200_003, 3)).astype(np.float32)
    q = (p[rng.integers(0, len(p), Q)] + rng.normal(0, 0.2, (Q, 3))).astype(np.float32)
    qt = torch.as_tensor(q, device=cuda_device)
    pt = torch.as_tensor(p, device=cuda_device)
    before = nn_kernel.nn_argmin.launches
    idx, dist = nn_kernel.nn_argmin(qt, pt)
    torch.cuda.synchronize()
    assert nn_kernel.nn_argmin.launches == before + 1
    ref_idx, ref_dist = nn_kernel.nn_argmin_reference(qt, pt)
    idx, dist, ref_idx, ref_dist = (a.cpu().numpy() for a in (idx, dist, ref_idx, ref_dist))
    np.testing.assert_allclose(dist, ref_dist, rtol=1e-5, atol=1e-6)
    mism = idx != ref_idx
    d_k = np.linalg.norm(p[idx[mism]].astype(np.float64) - q[mism], axis=-1)
    d_r = np.linalg.norm(p[ref_idx[mism]].astype(np.float64) - q[mism], axis=-1)
    np.testing.assert_allclose(d_k, d_r, rtol=1e-5)


def test_nn_kernel_rejects_mixed_devices(cuda_device):
    q = torch.zeros((4, 3), device=cuda_device)
    with pytest.raises(ValueError):
        nn_kernel.nn_argmin(q, torch.zeros((8, 3)))
    with pytest.raises(ValueError):
        nn_kernel.nn_argmin(q, torch.zeros((0, 3), device=cuda_device))


def test_mapper_on_gpu_goes_through_the_kernel(cuda_device):
    """The small corridor world mapped on the GPU: the thresholds of
    tests/test_e2e.py, and the lidar NN association launched the kernel."""
    from colmap_pcd_tpu_torch.models.controllers import (
        ControllerOptions,
        IncrementalMapperController,
    )
    from colmap_pcd_tpu_torch.models.incremental_mapper import MapperOptions
    from synthetic_torch import ate_rmse, make_world, scale_error

    rec, graph, lmap, gt = make_world(
        np.random.default_rng(7), n_images=8, n_points=600, noise_px=0.3, device=cuda_device
    )
    opts = MapperOptions(
        if_add_lidar_constraint=True, init_image_id1=1, init_image_id2=2,
        abs_pose_min_num_inliers=15, init_min_num_inliers=50, num_ransac_hypotheses=1024,
    )
    ctl = IncrementalMapperController(
        rec, graph, opts, ControllerOptions(verbose=False), lidar_map=lmap, pose_priors={1: gt[0]}
    )
    before = nn_kernel.nn_argmin.launches
    assert ctl.reconstruct()
    assert nn_kernel.nn_argmin.launches > before
    assert rec.num_reg_images >= 7
    assert ate_rmse(rec, gt) < 0.10
    assert scale_error(rec, gt) < 0.02


def test_match_kernel_matches_plain_version(cuda_device):
    """K1 against its plain version at the matcher's chunk (16 pairs at cap
    2048, ragged valid rows): similarities to 1e-6, indices equal away
    from near-ties, and match_descriptors' decisions equal away from them."""
    rng = np.random.default_rng(0)
    B, cap = 16, 2048
    d = rng.normal(size=(B, 2 * cap, 128)) ** 2
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    v1 = np.zeros((B, cap), np.float32)
    v2 = np.zeros((B, cap), np.float32)
    for b in range(B):
        v1[b, : rng.integers(1500, cap + 1)] = 1.0
        v2[b, : rng.integers(1500, cap + 1)] = 1.0
    d1 = torch.as_tensor((d[:, :cap] * v1[..., None]).astype(np.float32), device=cuda_device)
    noisy = d[:, :cap] + rng.normal(0, 0.02, (B, cap, 128))
    noisy /= np.linalg.norm(noisy, axis=-1, keepdims=True)
    d2 = torch.as_tensor((noisy[:, rng.permutation(cap)] * v2[..., None]).astype(np.float32), device=cuda_device)
    v1t, v2t = torch.as_tensor(v1, device=cuda_device), torch.as_tensor(v2, device=cuda_device)
    before = match_kernel.match_top2.launches
    s1, s2, idx = match_kernel.match_top2(d1, d2, v2t)
    torch.cuda.synchronize()
    assert match_kernel.match_top2.launches == before + 1
    r1, r2, ridx = match_kernel.match_top2_reference(d1, d2, v2t)
    assert float((s1 - r1).abs().max()) <= 1e-6
    assert float((s2 - r2).abs().max()) <= 1e-6
    sep = (r1 - r2) > 1e-6
    assert bool((idx[sep] == ridx[sep]).all())
    _, ok, _ = matching.match_descriptors(d1, d2, v1t, v2t)
    _, ok_ref, _ = matching.match_descriptors_reference(d1, d2, v1t, v2t)
    assert int(((ok != ok_ref) & sep).sum()) == 0
    assert int(ok.sum()) > 1000


@pytest.mark.parametrize("B,n1,n2", [(16, 1024, 1024), (1, 1000, 1537), (1, 300, 8200), (3, 40, 70)])
def test_match_kernel_cross_matches_plain_version(cuda_device, B, n1, n2):
    """The fused launch (rows and the cross-check's column bests) against its
    plain twin, with exact duplicate rows and columns (ties to the lowest
    index), invalid rows and columns, B = 1 and sizes off the 128 tiles:
    rows bit-identical to the rows-only launch and within 1e-6 of the plain
    version, column bests equal wherever a column's best and second-best
    valid rows differ by more than 1e-6, and no invalid row ever chosen."""
    rng = np.random.default_rng(n1 + n2)
    d1 = rng.normal(size=(B, n1, 128)) ** 2
    d2 = d1[:, rng.integers(0, n1, n2)] + rng.normal(0, 0.02, (B, n2, 128))
    d2[:, n2 // 2 : n2 // 2 + n2 // 8] = d2[:, : n2 // 8]  # duplicate columns
    d1[:, n1 // 2 : n1 // 2 + n1 // 8] = d1[:, : n1 // 8]  # duplicate rows
    d1 = np.maximum(d1, 0.0)
    d2 = np.maximum(d2, 0.0)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    v1 = (rng.uniform(size=(B, n1)) > 0.2).astype(np.float32)
    v2 = (rng.uniform(size=(B, n2)) > 0.2).astype(np.float32)
    v1[0, : n1 // 8] = 1.0  # the lower twins vote
    T = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=cuda_device)  # noqa: E731
    d1t, d2t, v1t, v2t = T(d1), T(d2), T(v1), T(v2)
    before = match_kernel.match_top2.launches
    s1, s2, idx, back = match_kernel.match_top2_cross(d1t, d2t, v1t, v2t)
    torch.cuda.synchronize()
    assert match_kernel.match_top2.launches == before + 1
    f1, f2, fidx = match_kernel.match_top2(d1t, d2t, v2t)
    assert torch.equal(s1, f1) and torch.equal(s2, f2) and torch.equal(idx, fidx)
    r1, r2, ridx, rback = match_kernel.match_top2_cross_reference(d1t, d2t, v1t, v2t)
    assert float((s1 - r1).abs().max()) <= 1e-6 and float((s2 - r2).abs().max()) <= 1e-6
    sep = (r1 - r2) > 1e-6
    assert bool((idx[sep] == ridx[sep]).all())
    bt1, bt2, _ = match_kernel.match_top2_reference(d2t, d1t, v1t)
    col_sep = (bt1 - bt2) > 1e-6
    assert bool((back[col_sep] == rback[col_sep]).all())
    assert bool((torch.gather(v1t, -1, back.long()) > 0).all())
    # a duplicated column's best row among twins is the lowest: the twins'
    # similarities are equal, so no column picks the upper twin of a lower one
    twin = back[0].long() - n1 // 2
    has_twin = (twin >= 0) & (twin < n1 // 8)
    assert not bool((has_twin & (d1t[0, twin.clamp(min=0)] == d1t[0, back[0].long()]).all(-1)).any())


def test_match_descriptors_cross_check_is_one_launch(cuda_device):
    """A cross-checked match_descriptors launches the float K1 once (the
    fused launch), one without the cross-check once too; no valid row gives
    back row 0 for every column, as the plain argmax over all -2 does."""
    rng = np.random.default_rng(11)
    d = rng.normal(size=(2, 500, 128)) ** 2
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d1 = torch.as_tensor(d[0], dtype=torch.float32, device=cuda_device)
    d2 = torch.as_tensor(d[1], dtype=torch.float32, device=cuda_device)
    v = torch.ones(500, device=cuda_device)
    r1, r2, _ = match_kernel.match_top2_reference(d1, d2, v)
    sep = (r1 - r2) > 1e-6
    for cross_check in (True, False):
        opts = matching.MatchingOptions(cross_check=cross_check)
        before = match_kernel.match_top2.launches
        idx, ok, _ = matching.match_descriptors(d1, d2, v, v, opts)
        assert match_kernel.match_top2.launches == before + 1
        ridx, rok, _ = matching.match_descriptors_reference(d1, d2, v, v, opts)
        assert int(((ok != rok) & sep).sum()) == 0 and torch.equal(idx[sep], ridx[sep])
    *_, back = match_kernel.match_top2_cross(d1, d2, torch.zeros(500, device=cuda_device), v)
    assert int(back.abs().max()) == 0


def test_sequential_matcher_on_gpu_goes_through_the_kernel(cuda_device, tmp_path):
    """`sequential_matcher` on the GPU launches the uint8 K1 and writes
    precise verified matches."""
    from colmap_pcd_tpu_torch import cli
    from synthetic_torch import make_descriptor_world, match_precision_recall, write_world

    rec, graph, lmap, gt, desc, point_ids = make_descriptor_world(
        np.random.default_rng(5), n_images=6, n_points=420
    )
    paths = write_world(rec, graph, lmap, gt, str(tmp_path), descriptors=desc)
    before = match_kernel.match_top2_u8.launches
    assert cli.main(["sequential_matcher", "--database_path", paths["database"]]) == 0
    assert match_kernel.match_top2_u8.launches > before
    pr = match_precision_recall(paths["database"], point_ids)
    assert pr["pairs_verified"] > 0 and pr["precision"] > 0.99, pr


def _sift_u8(rng, shape):
    d = rng.normal(size=shape + (128,)) ** 2
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.clip(np.round(d * 512.0), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("B,n1,n2", [(16, 2048, 2048), (1, 1000, 1537), (2, 40, 70), (1, 8192, 4100)])
def test_match_kernel_u8_equals_plain_version(cuda_device, B, n1, n2):
    """The tensor-core K1 against its plain version, exactly: similarity
    error 0 and no index mismatch, with ragged valid rows and columns, row
    tiles without a valid row, shapes below one tile and column splits."""
    rng = np.random.default_rng(n1 + n2)
    u1 = _sift_u8(rng, (B, n1))
    src = np.concatenate([u1[:, rng.permutation(n1)[: min(n1, n2) // 2]],
                          _sift_u8(rng, (B, n2 - min(n1, n2) // 2))], axis=1)
    u2 = np.clip(src[:, rng.permutation(n2)] + rng.normal(0, 6.0, (B, n2, 128)), 0, 255).round().astype(np.uint8)
    v1 = np.zeros((B, n1), np.float32)
    v2 = np.zeros((B, n2), np.float32)
    for b in range(B):
        v1[b, : rng.integers(n1 // 2, n1 + 1)] = 1.0
        v2[b, : rng.integers(n2 // 2, n2 + 1)] = 1.0
    v2[0, 3] = 0.0  # a hole in the valid columns
    u1, u2, v1, v2 = (torch.as_tensor(x, device=cuda_device) for x in (u1 * v1[..., None].astype(np.uint8), u2, v1, v2))
    inv1, inv2 = match_kernel.inverse_norms(u1), match_kernel.inverse_norms(u2)
    before = match_kernel.match_top2_u8.launches
    s1, s2, idx = match_kernel.match_top2_u8(u1, u2, inv1, inv2, v2, v1)
    torch.cuda.synchronize()
    assert match_kernel.match_top2_u8.launches == before + 1
    r1, r2, ridx = match_kernel.match_top2_u8_reference(u1, u2, inv1, inv2, v2, v1)
    assert torch.equal(s1, r1) and torch.equal(s2, r2) and torch.equal(idx, ridx)
    # without the row mask: every row computed, still exactly the plain version
    s1, s2, idx = match_kernel.match_top2_u8(u1, u2, inv1, inv2, v2)
    r1, r2, ridx = match_kernel.match_top2_u8_reference(u1, u2, inv1, inv2, v2)
    assert torch.equal(s1, r1) and torch.equal(s2, r2) and torch.equal(idx, ridx)
    out = matching.match_descriptors_u8(u1, u2, inv1, inv2, v1, v2)
    ref = matching.match_descriptors_u8_reference(u1, u2, inv1, inv2, v1, v2)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert int(out[1].sum()) > 0


def test_match_kernel_u8_exactness_properties(cuda_device):
    """On the card: the launch on the transpose forms bit-identical
    similarities; duplicated columns resolve to the lowest; whole tiles of
    invalid columns count as -2; zero-norm rows have similarity 0."""
    rng = np.random.default_rng(21)
    u2 = _sift_u8(rng, (600,))
    u2[400:450] = u2[:50]  # exact duplicates at higher columns
    u1 = np.concatenate([u2[rng.permutation(600)[:300]], np.zeros((20, 128), np.uint8)])
    u1, u2 = torch.as_tensor(u1, device=cuda_device), torch.as_tensor(u2, device=cuda_device)
    inv1, inv2 = match_kernel.inverse_norms(u1), match_kernel.inverse_norms(u2)
    ones1, ones2 = torch.ones(320, device=cuda_device), torch.ones(600, device=cuda_device)
    s1, s2, idx = match_kernel.match_top2_u8(u1, u2, inv1, inv2, ones2)
    t1, _, tidx = match_kernel.match_top2_u8(u2, u1, inv2, inv1, ones1)
    j = idx.long()
    mutual = tidx.long()[j] == torch.arange(320, device=cuda_device)
    assert int(mutual.sum()) > 100 and torch.equal(t1[j][mutual], s1[mutual])
    assert not bool(((j >= 400) & (j < 450))[:300].any())  # never the higher twin
    assert bool((s1[300:] == 0).all()) and bool((s2[300:] == 0).all()) and bool((idx[300:] == 0).all())
    v2 = ones2.clone()
    v2[128:384] = 0.0  # two whole column tiles
    s1, s2, idx = match_kernel.match_top2_u8(u1, u2, inv1, inv2, v2)
    r1, r2, ridx = match_kernel.match_top2_u8_reference(u1, u2, inv1, inv2, v2)
    assert torch.equal(s1, r1) and torch.equal(s2, r2) and torch.equal(idx, ridx)
    assert not bool(((idx >= 128) & (idx < 384)).any())
    s1, s2, idx = match_kernel.match_top2_u8(u1, u2, inv1, inv2, torch.zeros(600, device=cuda_device))
    assert bool((s1 == -2).all()) and bool((s2 == -2).all()) and bool((idx == 0).all())
    with pytest.raises(ValueError):
        match_kernel.match_top2_u8(u1, u2.cpu(), inv1, inv2.cpu(), ones2.cpu())


@pytest.mark.parametrize("Q", [1, 37, 384, 385, 5000])
def test_nn_kernel_packed_map_ties_at_map_scale(cuda_device, Q):
    """The redesigned K2 on the packed [N,4] map at ~50 m coordinates,
    through both of its scans: distances to 1e-5 relative against the plain
    version, exact hits at distance 0, and of duplicated points the lowest
    index, across threads, map splits and the final merge."""
    rng = np.random.default_rng(Q)
    p = rng.uniform([-40, -5, 20], [40, 5, 100], (150_001, 3)).astype(np.float32)
    p[140_000:140_016] = p[500:516]  # duplicates in another map split
    p[600:616] = p[500:516]  # and in the same one
    q = (p[rng.integers(0, len(p), Q)] + rng.normal(0, 0.3, (Q, 3))).astype(np.float32)
    q[: min(Q, 16)] = p[500 : 500 + min(Q, 16)]
    q[-1] = p[-1]  # the map's ragged last group
    qt = torch.as_tensor(q, device=cuda_device)
    p4 = nn_kernel.pack_points(torch.as_tensor(p, device=cuda_device))
    idx, dist = nn_kernel.nn_argmin(qt, p4)
    torch.cuda.synchronize()
    ref_idx, ref_dist = nn_kernel.nn_argmin_reference(qt, p4)
    idx, dist, ref_idx, ref_dist = (a.cpu().numpy() for a in (idx, dist, ref_idx, ref_dist))
    np.testing.assert_allclose(dist, ref_dist, rtol=1e-5, atol=1e-6)
    n = min(Q, 16) if Q > 1 else 0
    np.testing.assert_array_equal(idx[:n], np.arange(500, 500 + n))
    assert idx[-1] == len(p) - 1 and dist[-1] == 0.0
    mism = idx != ref_idx
    d_k = np.linalg.norm(p[idx[mism]].astype(np.float64) - q[mism], axis=-1)
    d_r = np.linalg.norm(p[ref_idx[mism]].astype(np.float64) - q[mism], axis=-1)
    np.testing.assert_allclose(d_k, d_r, rtol=1e-5)
    # an unpacked [N,3] map is packed by the wrapper: the same answers
    idx3, dist3 = nn_kernel.nn_argmin(qt, torch.as_tensor(p, device=cuda_device))
    np.testing.assert_array_equal(idx3.cpu().numpy(), idx)


def _blob_images(n, size=192):
    """Blob textures as uint8 (numpy only: this file imports no JAX)."""
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:size, 0:size]
    out = []
    for _ in range(n):
        img = np.zeros((size, size), np.float32)
        for _ in range(70):
            y, x = rng.uniform(15, size - 15, 2)
            s = rng.uniform(1.5, 4.0)
            img += rng.uniform(0.3, 1.0) * np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * s * s))
        out.append((img / img.max() * 255).astype(np.uint8))
    return np.stack(out)


@pytest.mark.parametrize("variant", [{}, dict(first_octave=-1), dict(estimate_affine_shape=True),
                                     dict(domain_size_pooling=True, dsp_num_scales=4)])
def test_sift_on_gpu_matches_cpu_and_repeats(cuda_device, variant):
    """SIFT on the card: two runs give identical bytes, and the keypoints
    equal the CPU's (the pyramid and the refinement are elementwise IEEE
    operations in one order) up to the transcendental functions' last bits:
    positions within 0.01 px, and at least 97% of the descriptors with a
    cosine >= 0.995 (symmetric blobs have ill-defined orientations)."""
    from colmap_pcd_tpu_torch.ops import sift

    kw = dict(max_num_features=512, max_per_octave=512, first_octave=0, num_octaves=3)
    kw.update(variant)
    opts = sift.SiftOptions(**kw)
    imgs = torch.as_tensor(_blob_images(3))
    on_card = sift.extract_batch(imgs.to(cuda_device), opts)
    again = sift.extract_batch(imgs.to(cuda_device), opts)
    v = on_card[3]
    assert torch.equal(v, again[3]) and int(v.sum()) > 100
    for a, b in zip(on_card[:3], again[:3]):
        assert torch.equal(a[v], b[v])
    on_cpu = sift.extract_batch(imgs, opts)
    assert torch.equal(v.cpu(), on_cpu[3])
    kp, kp_cpu = on_card[0].cpu()[on_cpu[3]], on_cpu[0][on_cpu[3]]
    assert float((kp[:, :2] - kp_cpu[:, :2]).abs().max()) <= 0.01
    d, d_cpu = on_card[1].cpu()[on_cpu[3]], on_cpu[1][on_cpu[3]]
    cos = torch.nn.functional.cosine_similarity(d, d_cpu, dim=-1)
    assert float((cos >= 0.995).float().mean()) >= 0.97


def _sweep_inputs(rng, H=240, W=320, S=4, D=64):
    """A textured fronto-parallel plane at 8 m seen by a reference and S
    shifted sources, with a prior depth map per source."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    f = 250.0
    K = np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    freq = rng.uniform(0.5, 4.0, (6, 2))

    def view(cx, cy):
        wx, wy = cx + (xs - W / 2) / f * 8.0, cy + (ys - H / 2) / f * 8.0
        return sum(np.sin(a * wx + 0.7 * k) * np.cos(b * wy) for k, (a, b) in enumerate(freq)).astype(np.float32) / 12 + 0.5

    c = rng.normal(0, 0.3, (S, 2))
    srcs = np.stack([view(x, y) for x, y in c])
    t = np.concatenate([-c, np.zeros((S, 1))], 1).astype(np.float32)
    depths = (1.0 / np.linspace(1 / 16.0, 1 / 4.0, D)).astype(np.float32)
    prior = (8.0 + rng.normal(0, 0.05, (S, H, W))).astype(np.float32)
    return (view(0.0, 0.0), srcs, K, np.stack([K] * S), np.stack([np.eye(3, dtype=np.float32)] * S), t, depths,
            prior)


def test_plane_sweep_on_gpu_equals_cpu_and_repeats(cuda_device):
    """Both passes of the sweep: the card computes the CPU's floats (the
    same IEEE operations in the same order), and twice the same bytes."""
    from colmap_pcd_tpu_torch.ops import stereo

    inputs = _sweep_inputs(np.random.default_rng(0))

    def run(dev):
        t = [torch.as_tensor(a, device=dev) for a in inputs]
        return [a.cpu().numpy() for a in (*stereo.plane_sweep(*t[:7]),
                                          *stereo.plane_sweep(*t[:7], src_depths=t[7], use_geom=True))]

    card, card2, cpu = run(cuda_device), run(cuda_device), run("cpu")
    for a, b in zip(card, card2):
        np.testing.assert_array_equal(a, b)
    for k in (0, 3):
        same = card[k] == cpu[k]
        assert same.mean() >= 0.995, same.mean()
        assert np.abs(card[k + 1] - cpu[k + 1])[same].max() <= 1e-4


def test_poisson_on_gpu_repeats_and_matches_cpu(cuda_device):
    """The fixed-point splat gives the same bytes on every run despite the
    atomics; the mesh matches the CPU's by face count and vertex distance."""
    from colmap_pcd_tpu_torch.ops import meshing

    rng = np.random.default_rng(1)
    v = rng.normal(size=(200_000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pts, nrm = v.astype(np.float32), v.astype(np.float32)
    p01 = torch.as_tensor((pts + 1.25) / 2.5, device=cuda_device)
    w = torch.ones(len(pts), device=cuda_device)
    a = meshing._indicator_grid(p01, torch.as_tensor(nrm, device=cuda_device), w, 128, 1.5, 1e-3)
    b = meshing._indicator_grid(p01, torch.as_tensor(nrm, device=cuda_device), w, 128, 1.5, 1e-3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    vg, fg = meshing.poisson_mesh(pts, nrm, meshing.PoissonOptions(depth=7), device=cuda_device)
    vc, fc = meshing.poisson_mesh(pts, nrm, meshing.PoissonOptions(depth=7), device="cpu")
    assert abs(len(fg) - len(fc)) <= 0.01 * len(fc)
    from scipy.spatial import cKDTree

    assert cKDTree(vc).query(vg)[0].max() < 1e-3


def _noisy_ba_problem(device, n_pts=128, n_cams=5, seed=1):
    """tests/test_torch_ba.py's problem built with the port's make_problem:
    cameras stepping down +z looking at points on a wall and the ground,
    0.5 px noise, perturbed poses and points, lidar planes on 60% of the
    points, camera 0 fixed."""
    from colmap_pcd_tpu_torch.ops import ba as ba_t
    from colmap_pcd_tpu_torch.ops import np_geom

    rng = np.random.default_rng(seed)
    params = np.asarray([500.0, 505.0, 320.0, 240.0], np.float32)
    on_wall = rng.random(n_pts) < 0.5
    X = np.where(
        on_wall[:, None],
        np.stack([np.full(n_pts, 4.0), rng.uniform(-2, 2, n_pts), rng.uniform(6, 20, n_pts)], -1),
        np.stack([rng.uniform(-4, 4, n_pts), np.full(n_pts, 2.0), rng.uniform(6, 20, n_pts)], -1),
    )
    qs, ts, obs_cam, obs_pt, obs_uv = [], [], [], [], []
    for c in range(n_cams):
        yaw = 0.03 * np.sin(c)
        q = np.asarray([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0])
        t = -np_geom.quat_to_rotmat(q) @ np.asarray([0.2 * np.sin(c), 0.1 * c, 1.0 * c])
        xy, z = np_geom.project(1, np.pad(params, (0, 8)), q, t, X)
        vis = (z > 1.0) & (xy[:, 0] > 0) & (xy[:, 0] < 640) & (xy[:, 1] > 0) & (xy[:, 1] < 480)
        for p in np.nonzero(vis)[0]:
            obs_cam.append(c)
            obs_pt.append(p)
            obs_uv.append(xy[p] + rng.normal(0, 0.5, 2))
        qs.append(q)
        ts.append(t)
    qs, ts = np.asarray(qs), np.asarray(ts)
    dq = rng.normal(0, 0.01, (n_cams, 3))
    qs_p = np.asarray([np_geom.quat_mul(np.concatenate([[1.0], 0.5 * d]), q) for d, q in zip(dq, qs)])
    qs_p /= np.linalg.norm(qs_p, axis=-1, keepdims=True)
    ts_p = ts + rng.normal(0, 0.05, ts.shape)
    qs_p[0], ts_p[0] = qs[0], ts[0]
    plane = np.where(on_wall[:, None], [[-1.0, 0, 0, 4.0]], [[0, -1.0, 0, 2.0]])
    pose_fixed = np.zeros(n_cams)
    pose_fixed[0] = 1.0
    return ba_t.make_problem(
        qs_p, ts_p, params, X + rng.normal(0, 0.05, X.shape), np.asarray(obs_cam), np.asarray(obs_pt),
        np.asarray(obs_uv), device=device, track_len=int(np.bincount(obs_pt).max()), lidar_plane=plane,
        lidar_w=np.where(rng.random(n_pts) < 0.6, 10.0, 0.0), pose_fixed=pose_fixed,
    )


def test_distributed_ba_on_card_equals_cpu(cuda_device):
    """A 2-shard solve_distributed on the card (cuda repeated twice) against
    the same 2-shard solve on the CPU, at tests/test_torch_parallel.py's
    bars: cam_t within 1e-3, points within 1e-2, final costs within 1e-3
    relative."""
    from colmap_pcd_tpu_torch.ops import ba as ba_t
    from colmap_pcd_tpu_torch.parallel import dist_ba
    from colmap_pcd_tpu_torch.parallel import mesh as mesh_lib

    cfg = ba_t.BAConfig(model_id=1, max_iterations=30, point_chunk=64)
    cpu = dist_ba.solve_distributed(_noisy_ba_problem("cpu"), cfg, mesh_lib.make_mesh(2, devices=["cpu"] * 2))
    card = dist_ba.solve_distributed(_noisy_ba_problem(cuda_device), cfg,
                                     mesh_lib.make_mesh(2, devices=[cuda_device] * 2))
    assert card.points.device.type == "cuda"
    assert float(card.final_cost) < 0.5 * float(card.initial_cost)
    np.testing.assert_allclose(card.cam_t.cpu().numpy(), cpu.cam_t.numpy(), atol=1e-3)
    assert np.abs(card.points.cpu().numpy() - cpu.points.numpy()).max() < 1e-2
    np.testing.assert_allclose(float(card.final_cost), float(cpu.final_cost), rtol=1e-3)


def test_match_pool_sharded_on_card_goes_through_the_float_kernel(cuda_device):
    """A MatchPool sharded over the card twice launches the float K1 and
    gives exactly the unsharded pool's (idx, ok): the kernel forms each
    pair's similarities in one fixed k order, whatever the batch."""
    from colmap_pcd_tpu_torch.parallel import dist_matching
    from colmap_pcd_tpu_torch.parallel import mesh as mesh_lib

    rng = np.random.default_rng(0)
    base = rng.normal(size=(300, 128))
    base /= np.linalg.norm(base, axis=-1, keepdims=True)
    descs = {i: ((base + rng.normal(0, 0.03, base.shape)) * 255).astype(np.float32) for i in range(1, 9)}
    pairs = [(i, j) for i in range(1, 9) for j in range(i + 1, min(i + 4, 9))]  # 15: a padded batch
    before = match_kernel.match_top2.launches
    mesh = mesh_lib.make_mesh(2, devices=[cuda_device] * 2)
    idx_m, ok_m = dist_matching.MatchPool(descs, mesh=mesh, cap=512).match_pairs(pairs)
    assert match_kernel.match_top2.launches > before
    idx_l, ok_l = dist_matching.MatchPool(descs, cap=512, device=cuda_device).match_pairs(pairs)
    np.testing.assert_array_equal(ok_m, ok_l)
    np.testing.assert_array_equal(idx_m, idx_l)
    assert ok_m.shape[0] == len(pairs) and ok_m.any(axis=1).all()
