#!/usr/bin/env python3
"""Device profile of the port's SIFT extractor on one NVIDIA GPU.

    python3 scripts/torch_profile_extractor.py [--n-images 32]

Renders chip_smoke.py's pixel world (640x480 corridor views), then prints:
the device time of one batch of 8 split into its detection half
(`sift._detect`: scale space, extrema, refinement, top-k) and its
orientation + descriptor half, by CUDA events, at the light scale (2048
features, 3 octaves) and, on 4 views rendered at 1280x960, at the reference
scale (8192 features, 4 octaves); the wall seconds of `run_feature_extractor`
over the images, twice without a profiler (the first run of a process also
pays CUDA library loads) and once under `torch.profiler`; the device's busy
share of that run (the sum of kernel times over the profiled wall time),
the number of kernels launched per batch, and the ten kernels that took
most, with the share of the row gather (`index_select`, PyTorch's
`vectorized_gather_kernel`) of `_bilinear_ma`.
The first line is the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def _halves_ms(sift, imgs, opts, reps: int = 3) -> tuple[float, float]:
    """(detection ms, orientation + descriptor ms) of one batch, CUDA events,
    mean of `reps` after one warm-up."""
    import torch

    def both():
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        Gs, kx, ky, sigma_rel, lev, wh, *_ = sift._detect(imgs, opts)
        marks[1].record()
        sift._orientation_and_descriptor(Gs, kx, ky, sigma_rel, opts, lidx=lev, wh=wh)
        marks[2].record()
        torch.cuda.synchronize()
        return marks[0].elapsed_time(marks[1]), marks[1].elapsed_time(marks[2])

    both()
    times = [both() for _ in range(reps)]
    return sum(t[0] for t in times) / reps, sum(t[1] for t in times) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-images", type=int, default=32)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_extractor: no CUDA device")
    import bench_torch
    import chip_smoke as cs
    from colmap_pcd_tpu_torch.models.feature_pipeline import _EXTRACT_BATCH, ImageReaderConfig, run_feature_extractor
    from colmap_pcd_tpu_torch.ops import sift
    from synthetic_torch import make_trajectory, render_images

    print(f"[env] nvidia-smi: {bench_torch.nvidia_smi()}", flush=True)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="profile_extractor_") as tmp:
        gt = make_trajectory(args.n_images, cs.PIXEL_STEP)
        img_dir, ref_dir = os.path.join(tmp, "images"), os.path.join(tmp, "images_ref")
        os.makedirs(img_dir)
        os.makedirs(ref_dir)
        render_images(img_dir, gt, cs.PIXEL_W, cs.PIXEL_H, cs.PIXEL_F, workers=6)
        render_images(ref_dir, gt[:4], cs.REF_W, cs.REF_H, cs.REF_F, workers=4)

        for label, directory, n, opts in (
            (f"batch of 8 at {cs.PIXEL_W}x{cs.PIXEL_H}", img_dir, 8, sift.SiftOptions(
                max_num_features=cs.PIXEL_FEATURES, first_octave=0, num_octaves=cs.PIXEL_OCTAVES)),
            (f"batch of 4 at {cs.REF_W}x{cs.REF_H}", ref_dir, 4, sift.SiftOptions(
                max_num_features=cs.REF_FEATURES, first_octave=0, num_octaves=cs.REF_OCTAVES)),
        ):
            imgs = torch.as_tensor(cs._read_stack(directory, n), device=dev)
            detect_ms, describe_ms = _halves_ms(sift, imgs, opts)
            print(f"[halves] {label}, {opts.max_num_features} features, {opts.num_octaves} octaves: "
                  f"detection {detect_ms:.3f} ms, orientation + descriptor {describe_ms:.3f} ms "
                  f"(CUDA events, mean of 3)", flush=True)

        reader = ImageReaderConfig(
            camera_model="PINHOLE",
            camera_params=f"{cs.PIXEL_F},{cs.PIXEL_F},{cs.PIXEL_W / 2},{cs.PIXEL_H / 2}",
        )

        def run(tag: str) -> float:
            t0 = time.perf_counter()
            n = run_feature_extractor(os.path.join(tmp, f"{tag}.db"), img_dir, cs._extraction_config(), reader)
            torch.cuda.synchronize()
            if n != args.n_images:
                raise RuntimeError(f"extracted {n} of {args.n_images} images")
            return time.perf_counter() - t0

        print(f"[extractor] {args.n_images} images: first run {run('first'):.3f} s, second run "
              f"{run('second'):.3f} s (host clock, no profiler)", flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = run("profiled")
        kernels = []
        for item in prof.key_averages():
            device_us = getattr(item, "self_device_time_total", None)
            if device_us is None:
                device_us = item.self_cuda_time_total
            if device_us > 0 and str(item.device_type).endswith("CUDA"):
                kernels.append((device_us, item.count, item.key))
        if not kernels:
            raise RuntimeError("the profile shows no device time: CUPTI tracing is not available here")
        busy = sum(k[0] for k in kernels) / 1e6
        launches = sum(k[1] for k in kernels)
        batches = -(-args.n_images // _EXTRACT_BATCH)
        print(f"[profile] {wall:.3f} s wall under the profiler ({args.n_images / wall:.2f} images/s); "
              f"kernels ran {busy:.3f} s: busy {100 * busy / wall:.1f}%, idle "
              f"{100 * (1 - busy / wall):.1f}%; {launches} kernels, {launches / batches:.0f} per batch of "
              f"{_EXTRACT_BATCH}, {1e3 * busy / batches:.3f} ms of device time per batch", flush=True)
        gathers = [(us, count) for us, count, key in kernels if "vectorized_gather_kernel" in key]
        gather_us = sum(us for us, _ in gathers)
        print(f"[profile] row gathers of the corner table (index_select): {gather_us / 1e3:.3f} ms over "
              f"{sum(c for _, c in gathers)} launches, {100 * gather_us / 1e6 / busy:.1f}% of device time",
              flush=True)
        for us, count, key in sorted(kernels, reverse=True)[:10]:
            print(f"[profile] {us / 1e3:10.3f} ms {count:7d} x  {key[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
