"""The port's SIFT `extract` against the JAX package's run eagerly
(`jax.disable_jit()`), on test_torch_sift.py's 320x240 corridor view.

Jitted, the JAX package's `_blur` differs from its own eager run on 37-39% of
the pixels, by up to 1.8e-7, at every sigma: XLA on the CPU contracts the
taps' products and sums into fused multiply-adds, and those last bits cross
the bf16 rounding of the gradient corner table (`_pack_bilinear_table`) on a
few keypoints. The eager run rounds each product and each sum, as the port's
stencil does, and equals it bit for bit. So the JAX package does not agree
with itself: jit against eager gives 0.9946 same orientation on this view
(the share test_torch_sift.py::test_extract_parity measures for the port
against JAX jit, under its 99% bar) and 0.9855, with 482 against 483 valid
keypoints, on a 640x480, f = 500 corridor view at the pixel world's options
(2048 features, 3 octaves). Against the eager run the port holds much
tighter bars, stated below; the orientation and descriptor bars are ~10x
the measured worst (9.5e-7 rad, 1.1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from colmap_pcd_tpu.ops import sift as jsift
from colmap_pcd_tpu_torch.ops import sift as tsift

from render_torch import render_corridor
from test_torch_sift import OPTS, _partners

torch.set_num_threads(1)  # the suite runs several workers on few cores

# orientation within EAGER_ORI_ATOL rad on EAGER_ORI_SHARE of the partners
# (measured: all, within 9.5e-7); float descriptors within EAGER_DESC_ATOL
# max-abs on those partners (measured 1.1e-5)
EAGER_ORI_ATOL, EAGER_ORI_SHARE = 1e-5, 0.995
EAGER_DESC_ATOL = 1e-4


def test_extract_matches_eager_jax_on_the_corridor_view():
    img = render_corridor(np.asarray([1.0, 0, 0, 0]), np.zeros(3), 320, 240, 260.0)
    with jax.disable_jit():
        kp_r, d_r, _, v_r = (np.asarray(a) for a in jsift.extract(jnp.asarray(img), jsift.SiftOptions(**OPTS)))
    kp_g, d_g, _, v_g = (a.numpy() for a in tsift.extract(torch.as_tensor(img), tsift.SiftOptions(**OPTS)))
    assert v_r.sum() == v_g.sum() > 100
    kp_r, d_r, kp_g, d_g = kp_r[v_r], d_r[v_r], kp_g[v_g], d_g[v_g]
    j, ok = _partners(kp_r, kp_g)
    _, ok_back = _partners(kp_g, kp_r)
    assert ok.all() and ok_back.all(), (ok.mean(), ok_back.mean())
    dtheta = np.abs(np.angle(np.exp(1j * (kp_r[:, 3] - kp_g[j, 3]))))
    same = dtheta <= EAGER_ORI_ATOL
    print(f"valid {len(kp_r)}, max px {np.abs(kp_r[:, :2] - kp_g[j, :2]).max():.3g}, same orientation "
          f"{same.mean():.4f} (max {dtheta[same].max():.3g} rad), descriptor max-abs "
          f"{np.abs(d_r[same] - d_g[j[same]]).max():.3g}")
    assert same.mean() >= EAGER_ORI_SHARE, same.mean()
    assert np.abs(d_r[same] - d_g[j[same]]).max() <= EAGER_DESC_ATOL
