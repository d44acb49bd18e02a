#!/usr/bin/env python3
"""The JAX package's bench.py default run (the overlapped front end into
the lidar controller, at the bench's light scale) through the port on one
NVIDIA GPU, twice.

    python3 scripts/torch_bench_overlapped.py

It renders the pixel world's corridor over 100 views at 640x480, f = 500,
once, and runs chip_smoke.py's phase 7b function on it twice:
`run_overlapped_frontend` with 2048 features and 3 octaves and the
reader's defaults (bench.py gives none), feeding
IncrementalMapperController with bench.py's MapperOptions, the known
PINHOLE camera and the pose prior of image 1. Each run prints phase 7b's
lines and holds them to its bars, its ATE beside the JAX package's
18.0 mm (BENCH_r05.json). Needs CUDA and nvcc.
"""

from __future__ import annotations

import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import chip_smoke as cs  # noqa: E402

N_IMAGES = 100
RUNS = 2


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_overlapped: no CUDA device")
    from colmap_pcd_tpu_torch.ops import match_kernel, nn_kernel

    cs._log(f"[env] nvidia-smi: {cs._nvidia_smi()}")
    nn_kernel.build()
    match_kernel.build_u8()
    with tempfile.TemporaryDirectory(prefix="bench_overlapped_") as tmp:
        os.makedirs(os.path.join(tmp, "world"))
        world = cs.render_reference_world(N_IMAGES, os.path.join(tmp, "world"), cs.LIGHT_SCALE)
        W, H, F, features, octaves = cs.LIGHT_SCALE
        cs._log(f"[world] {N_IMAGES} views at {W}x{H}, f = {F:g}, {features} features, {octaves} octaves; "
                f"rendered in {world['seconds']:.2f} s")
        for run in range(RUNS):
            out = os.path.join(tmp, f"run{run}")
            os.makedirs(out)
            cs._log(f"[run {run}]")
            res = cs.run_overlapped_bench(world, out)
            cs._log_reference_scale(res, cs.REFERENCE_ATE_MM, tag="light scale")
            cs._require_reference_scale(res, N_IMAGES)
    return 0


if __name__ == "__main__":
    sys.exit(main())
