#!/usr/bin/env python3
"""CPU rehearsal of chip_smoke.py's phase 12 (the dense stage).

    python3 scripts/torch_rehearse_dense.py [--n-images 14] [--threads 6] [--out DIR]

Renders chip_smoke.py's pixel world at --n-images views, maps it (phase 6:
feature_extractor, the sequential matcher, the lidar mapper), undistorts
the model's images, and runs `chip_smoke.run_dense` on the CPU: the
device is resolved to the CPU, the CUDA memory and timing calls return
nothing, so every command of the phase runs as on the card but its times
are the host's. Prints the phase's numbers, among them the fused cloud's
and the mesh's median point-to-plane distance to the lidar map from which
chip_smoke.py's FUSED_P2P_M and MESH_P2P_M are set (x 1.25). At 640x480
the sweep costs ~11 s per view-pass on 6 CPU threads, so 14 views take
~15 minutes. Imports nothing of JAX.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-images", type=int, default=14)
    ap.add_argument("--threads", type=int, default=6)
    ap.add_argument("--out", default=None, help="working directory (default: a temporary one)")
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(args.threads)
    from colmap_pcd_tpu_torch import device

    device.resolve = lambda d=None: torch.device("cpu")
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.memory_allocated = lambda *a, **k: 0
    import chip_smoke as cs

    cs._cuda_ms = lambda fn, reps: float("nan")
    cs._graph_ms = lambda fn, reps: float("nan")
    cs._count_kernels = lambda fn: None
    from colmap_pcd_tpu_torch import cli

    with tempfile.TemporaryDirectory(prefix="rehearse_dense_") as tmp:
        work = args.out or tmp
        os.makedirs(os.path.join(work, "pixels"))
        smoke_args = argparse.Namespace(n_images=args.n_images, seed=0, dense_views=args.n_images)
        t0 = time.perf_counter()
        world = cs.render_pixel_world(smoke_args, os.path.join(work, "pixels"))
        px = cs.run_pixel_world(world, work)
        print(f"pixel world: {px['registered']}/{args.n_images} registered, ATE {px['ate_m'] * 1e3:.3f} mm, "
              f"{time.perf_counter() - t0:.1f} s")
        undistorted = os.path.join(work, "undistorted")
        if cli.main(["image_undistorter", "--image_path", world["paths"]["images"],
                     "--input_path", cs._largest_model_dir(px["model_root"]), "--output_path", undistorted]) != 0:
            raise RuntimeError("image_undistorter failed")
        os.makedirs(os.path.join(work, "dense"))
        t0 = time.perf_counter()
        dn = cs.run_dense(smoke_args, world, {"undistorted_workspace": undistorted}, os.path.join(work, "dense"))
        print(f"phase 12: {time.perf_counter() - t0:.1f} s")
        for key, value in dn.items():
            if key != "commands":
                print(f"  {key}: {value}")
        for label, c in dn["commands"].items():
            print(f"  {label}: {c['seconds']:.3f} s, host fetches {c['phases']}")
        print(f"bars x 1.25: fused {dn['p2p_fused_m'][0] * 1.25:.6f} m, mesh {dn['p2p_mesh_m'][0] * 1.25:.6f} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
