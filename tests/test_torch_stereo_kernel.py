"""The plane sweep's kernel route seen from the CPU: CPU tensors take the
plain route and neither build nor launch the hand kernel
(ops/stereo_kernel.py, csrc/plane_sweep.cu); the dense stage counts the
view-passes the kernel swept; the kernel's wrapper refuses what it does not
take before it builds anything. The kernel itself is held against the plain
route on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from colmap_pcd_tpu_torch.ops import cuda_build, stereo, stereo_kernel
from colmap_pcd_tpu_torch.utils.logging_utils import PHASES

torch.set_num_threads(1)  # the suite runs several workers on few cores


def _inputs(H=24, W=32, S=2, D=5):
    rng = np.random.default_rng(0)
    f = 30.0
    K = np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    t = np.concatenate([rng.normal(0, 0.1, (S, 2)), np.zeros((S, 1))], 1)
    return [torch.as_tensor(np.asarray(a, np.float32)) for a in (
        rng.random((H, W)), rng.random((S, H, W)), K, np.stack([K] * S), np.stack([np.eye(3)] * S), t,
        np.linspace(4.0, 8.0, D), np.full((S, H, W), 6.0))]


def _kernel_state():
    """What a launch or a build would change: the launch count, the loaded
    library, the sources this process compiled."""
    return stereo_kernel.plane_sweep_cuda.launches, stereo_kernel._lib, dict(cuda_build.BUILD_SECONDS)


def test_cpu_sweep_builds_and_launches_nothing():
    t = _inputs()
    before = _kernel_state()
    photo = stereo.plane_sweep(*t[:7])
    geom = stereo.plane_sweep(*t[:7], src_depths=t[7], use_geom=True)
    assert _kernel_state() == before
    for maps in (photo, geom):
        assert maps[0].device.type == "cpu" and maps[0].shape == (24, 32) and maps[2].shape == (24, 32, 3)
    # the CPU's route is the plain route
    for a, b in zip(geom, stereo.plane_sweep_plain(*t[:7], src_depths=t[7], use_geom=True)):
        assert torch.equal(a, b)


def test_dense_stage_on_cpu_counts_no_kernel_passes(tmp_path):
    """run_patch_match_stereo on the CPU: both passes over three views are
    six view-passes, none swept by the kernel (the counter is there, at 0)."""
    from colmap_pcd_tpu_torch.models import mvs
    from colmap_pcd_tpu_torch.models.reconstruction import Camera, Image, Reconstruction
    from test_stereo import F, H, W, render_plane

    rec = Reconstruction()
    rec.add_camera(Camera(1, 1, W, H, np.asarray([F, F, W / 2, H / 2])))
    images = {}
    for i, c in enumerate([np.zeros(3), np.asarray([0.35, 0.0, 0.0]), np.asarray([0.0, 0.3, 0.0])], 1):
        rec.add_image(Image(i, f"v{i}.png", 1, qvec=np.asarray([1.0, 0, 0, 0]), tvec=-c, xys=np.zeros((4, 2))))
        rec.register_image(i)
        images[i] = render_plane(c, 10.0)
    for k in range(4):
        rec.add_point3D(np.asarray([(k % 2 - 0.5) * 2.0, (k // 2 - 0.5) * 1.5, 10.0]), [(1, k), (2, k), (3, k)])
    counters = ("stereo_view_passes", "stereo_kernel_passes")
    before = {k: PHASES.counts.get(k, 0) for k in counters}
    state = _kernel_state()
    n = mvs.run_patch_match_stereo(str(tmp_path), mvs.DenseOptions(max_image_size=-1, num_depths=4, window_radius=1),
                                   rec=rec, images=images, device="cpu")
    assert n == 3
    assert "stereo_kernel_passes" in PHASES.counts
    assert {k: PHASES.counts[k] - before[k] for k in counters} == {"stereo_view_passes": 6, "stereo_kernel_passes": 0}
    assert _kernel_state() == state


def _wrapper_args(**change):
    """plane_sweep_cuda's arguments for a bilateral sweep of _inputs(), as
    CPU tensors, with `change` applied."""
    ref, srcs, K, Ks, R, t, depths, _ = _inputs()
    opts = stereo.StereoOptions(window_radius=2)
    w, *terms = stereo._bilateral_ref_terms(ref, opts)
    args = dict(ref=ref, srcs=srcs, homographies=stereo._plane_homography(stereo._inv3(K), Ks, R, t, depths),
                depths=depths, radius=2, weights=w, ref_terms=tuple(terms), k=2, big=2.001)
    args.update(change)
    return args


@pytest.mark.parametrize("change,message", [
    ({}, "the kernel runs on CUDA only"),
    (dict(depths=torch.ones(5, dtype=torch.float64)), "depths must be float32"),
    (dict(homographies=torch.zeros((5, 3, 3, 3))), "homographies has shape"),
    (dict(weights=torch.zeros((9, 24, 32))), "weights has shape"),
    (dict(ref_terms=(torch.zeros((24, 32)),) * 2), "2 reference terms"),
    (dict(ref_terms=(torch.zeros((24, 31)),) * 3), r"ref_terms\[0\] has shape"),
    (dict(k=3), "k = 3 with 2 sources"),
    (dict(srcs=torch.zeros((2, 32, 24)).mT), "srcs must be contiguous"),
], ids=["cpu", "dtype", "homographies", "weights", "terms", "term_shape", "k", "contiguous"])
def test_kernel_wrapper_refuses_before_building(change, message):
    args = _wrapper_args(**change)
    before = _kernel_state()
    with pytest.raises(ValueError, match=message):
        stereo_kernel.plane_sweep_cuda(**args)
    assert _kernel_state() == before


def test_geometric_inputs_pack_in_the_kernels_layout():
    """[S, 21] (K_src^-1, R, t a source, row-major) then K_ref [9]."""
    S = 3
    rng = np.random.default_rng(1)
    Ki, R, K = (torch.as_tensor(rng.random(s), dtype=torch.float32) for s in ((S, 3, 3), (S, 3, 3), (3, 3)))
    t = torch.as_tensor(rng.random((S, 3)), dtype=torch.float32)
    g = stereo_kernel.Geometric(torch.zeros((S, 4, 5)), Ki, R, t, K, 0.3, 3.0)
    packed = g.packed.reshape(-1)
    assert packed.shape == (21 * S + 9,) and packed.is_contiguous()
    for s in range(S):
        row = packed[21 * s : 21 * (s + 1)]
        assert torch.equal(row[:9], Ki[s].reshape(-1)) and torch.equal(row[9:18], R[s].reshape(-1))
        assert torch.equal(row[18:], t[s])
    assert torch.equal(packed[21 * S :], K.reshape(-1))
