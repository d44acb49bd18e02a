#!/usr/bin/env python3
"""Device profile of the port's sequential matcher on one NVIDIA GPU.

    python3 scripts/torch_profile_matcher.py [--n-images 100] [--seed 0]

Builds chip_smoke.py's 100-image descriptor world, runs `sequential_matcher
--SequentialMatching.overlap 5` through `cli.main` twice on copies of its
database without a profiler (the first run of a process also pays CUDA
library loads and the kernels' build), then once under `torch.profiler`,
and prints: the wall seconds of each run; the device's busy share (the sum
of kernel times over the profiled wall time) and idle share; the number of
kernels launched and of host synchronizations; the device time and launch
count of the top-2 kernels (K1) and of the ten kernels that took most.
The first line is the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-images", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_matcher: no CUDA device")
    import bench_torch
    from colmap_pcd_tpu_torch import cli
    from colmap_pcd_tpu_torch.utils.logging_utils import PHASES
    from synthetic_torch import make_descriptor_world, write_world

    print(f"[env] nvidia-smi: {bench_torch.nvidia_smi()}", flush=True)
    with tempfile.TemporaryDirectory(prefix="profile_matcher_") as tmp:
        rec, graph, lmap, gt, desc, _ = make_descriptor_world(
            np.random.default_rng(args.seed), n_images=args.n_images, n_points=110 * args.n_images,
            noise_px=0.4, step=0.8, distractor_share=0.05,
        )
        paths = write_world(rec, graph, lmap, gt, tmp, descriptors=desc)

        def run(tag: str) -> float:
            db = os.path.join(tmp, f"{tag}.db")
            shutil.copy(paths["database"], db)
            t0 = time.perf_counter()
            rc = cli.main(["sequential_matcher", "--database_path", db,
                           "--SequentialMatching.overlap", "5"])
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"sequential_matcher exited with {rc}")
            return time.perf_counter() - t0

        print(f"[matcher] first run {run('first'):.3f} s, second run {run('second'):.3f} s "
              f"(host clock, no profiler)", flush=True)
        PHASES.counts.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = run("profiled")
        kernels = []
        syncs = 0
        for item in prof.key_averages():
            device_us = getattr(item, "self_device_time_total", None)
            if device_us is None:
                device_us = item.self_cuda_time_total
            if "Synchronize" in item.key:
                syncs += item.count
            if device_us > 0 and str(item.device_type).endswith("CUDA"):
                kernels.append((device_us, item.count, item.key))
        if not kernels:
            raise RuntimeError("the profile shows no device time: CUPTI tracing is not available here")
        busy = sum(k[0] for k in kernels) / 1e6
        launches = sum(k[1] for k in kernels)
        print(f"[profile] {wall:.3f} s wall under the profiler; kernels ran {busy:.3f} s: busy "
              f"{100 * busy / wall:.1f}%, idle {100 * (1 - busy / wall):.1f}%; {launches} kernels, "
              f"{syncs} synchronize calls, {PHASES.counts.get('linalg_syncs', 0)} linalg_syncs",
              flush=True)
        for us, count, key in sorted(kernels, reverse=True):
            if "top2" in key:
                print(f"[profile] K1 {key[:60]}: {us / 1e3:.3f} ms over {count} launches, "
                      f"{100 * us / 1e6 / busy:.2f}% of device time", flush=True)
        for us, count, key in sorted(kernels, reverse=True)[:10]:
            print(f"[profile] {us / 1e3:10.3f} ms {count:7d} x  {key[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
