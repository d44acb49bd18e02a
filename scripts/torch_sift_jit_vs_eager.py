#!/usr/bin/env python3
"""SIFT orientation agreement on pixel-world views: the JAX package jitted,
the JAX package eager (`jax.disable_jit()`) and the port, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_sift_jit_vs_eager.py [--views 0 15 39 71 99]
        [--n-images 100] [--threads 4]

Renders the named views of the pixel world as chip_smoke.render_pixel_world
does (the corridor trajectory of --n-images views at 640x480, f = 500, saved
as uint8 PNGs and read back) and extracts each with the pixel world's
options (2048 features, first octave 0, 3 octaves) three ways. For each pair
of runs it prints the valid counts, the share of keypoints with a partner
(0.01 px, 1e-3 relative scale, the smaller of the two ways) and the share of
partners with the same orientation (1e-4 rad; each partner at the closest
orientation at its location), and the largest orientation and descriptor
differences among those. The last line is one JSON object with the numbers.

The JAX package's jitted blur contracts its taps into fused multiply-adds
on the CPU; the eager run rounds each product and sum, as the port does
(tests/test_torch_sift_eager.py). An eager 640x480 extraction takes ~20-30 s.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from chip_smoke import PIXEL_F, PIXEL_FEATURES, PIXEL_H, PIXEL_OCTAVES, PIXEL_STEP, PIXEL_W  # noqa: E402


def agreement(a, b) -> dict:
    """Run a against run b, each (kp [N,4] = x, y, scale, orientation;
    descriptors [N,128]) of the valid keypoints."""
    from scipy.spatial import cKDTree

    def one(p, q):
        d, j = cKDTree(q[0][:, :2]).query(p[0][:, :2], k=4)
        ok = (d <= 0.01) & (np.abs(q[0][j, 2] / p[0][:, 2, None] - 1.0) <= 1e-3)
        dtheta = np.where(ok, np.abs(np.angle(np.exp(1j * (p[0][:, 3, None] - q[0][j, 3])))), np.inf)
        k = np.argmin(dtheta, axis=1)
        return ok.any(1), dtheta[np.arange(len(k)), k], j[np.arange(len(k)), k]

    partnered, dtheta, j = one(a, b)
    back, _, _ = one(b, a)
    same = partnered & (dtheta <= 1e-4)
    return {
        "valid": [len(a[0]), len(b[0])],
        "partner_share": float(min(partnered.mean(), back.mean())),
        "same_orientation_share": float(same[partnered].mean()),
        "max_orientation_diff_same": float(dtheta[same].max()) if same.any() else None,
        "max_desc_diff_same": float(np.abs(a[1][same] - b[1][j[same]]).max()) if same.any() else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, nargs="+", default=[0, 15, 39, 71, 99])
    ap.add_argument("--n-images", type=int, default=100)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    torch.set_num_threads(args.threads)
    from colmap_pcd_tpu.ops import sift as jsift
    from colmap_pcd_tpu_torch.ops import sift as tsift
    from colmap_pcd_tpu_torch.utils.image import imread_gray_u8
    from synthetic_torch import make_trajectory, render_images

    kw = dict(max_num_features=PIXEL_FEATURES, first_octave=0, num_octaves=PIXEL_OCTAVES)
    jo, to = jsift.SiftOptions(**kw), tsift.SiftOptions(**kw)
    gt = make_trajectory(args.n_images, PIXEL_STEP)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for v in args.views:
            render_images(tmp, [gt[v]], PIXEL_W, PIXEL_H, PIXEL_F)  # writes v0000.png
            img = imread_gray_u8(os.path.join(tmp, "v0000.png")).astype(np.float32) / 255.0

            def valid(run):
                kp, desc, _, ok = (np.asarray(x) for x in run)
                return kp[ok], desc[ok]

            t0 = time.perf_counter()
            jit = valid(jsift.extract(jnp.asarray(img), jo))
            t1 = time.perf_counter()
            with jax.disable_jit():
                eager = valid(jsift.extract(jnp.asarray(img), jo))
            t2 = time.perf_counter()
            port = valid(tuple(x.numpy() for x in tsift.extract(torch.as_tensor(img), to)))
            res = {"jit vs eager": agreement(jit, eager), "port vs eager": agreement(port, eager),
                   "port vs jit": agreement(port, jit), "jit_s": t1 - t0, "eager_s": t2 - t1}
            out[f"v{v:04d}"] = res
            for k in ("jit vs eager", "port vs eager", "port vs jit"):
                r = res[k]
                print(f"[v{v:04d}] {k}: valid {r['valid'][0]} / {r['valid'][1]}, partners "
                      f"{r['partner_share']:.4f}, same orientation {r['same_orientation_share']:.4f} "
                      f"(max {r['max_orientation_diff_same']:.3g} rad there, descriptors within "
                      f"{r['max_desc_diff_same']:.3g})", flush=True)
            print(f"[v{v:04d}] jit {res['jit_s']:.1f} s, eager {res['eager_s']:.1f} s", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
