"""Multi-device dense stereo: per-reference-view plane sweeps sharded over
the mesh.

Port of colmap_pcd_tpu/parallel/dist_mvs.py. The reference fans
per-reference PatchMatch problems out over a ThreadPool, round-robin over
GPUs (src/mvs/patch_match.cc:197-213). Here B reference-view problems are
split into one contiguous block per mesh device, and each device runs
`ops/stereo.plane_sweep` on its block view by view: one view of 640x480 at
64 depths already peaks near 8 GiB, so the views are not stacked into one
tensor. Since every view is swept on its own, views may differ in source
count and in shape, and B need not divide by the mesh size: nothing is
padded (the JAX package pads S and B to its static sharded shapes), so a
view's maps are those of the one-device sweep. No collectives; the maps
are gathered on the mesh's root device.
"""

from __future__ import annotations

import torch

from ..ops import stereo as stereo_ops
from .mesh import Mesh, shard_devices


def plane_sweep_batch(
    refs,  # B x [H, W]
    srcs,  # B x [S, H, W]
    K_ref,  # B x [3, 3]
    K_srcs,  # B x [S, 3, 3]
    R_rel,  # B x [S, 3, 3]
    t_rel,  # B x [S, 3]
    depths,  # B x [D]
    opts: stereo_ops.StereoOptions = stereo_ops.StereoOptions(),
    mesh: Mesh | None = None,
    src_depths=None,  # B x [S, H, W]
    use_geom: bool = False,
    device=None,
):
    """Sweep B reference views; with a mesh of n devices, view k runs on
    mesh.devices[k * n // B] (contiguous blocks whose sizes differ by at
    most one), without one all on `device` (None meaning CUDA). Each argument holds one entry per view: a stacked
    array or tensor, or a list of them (so S may differ between views).

    Returns three lists of B per-view maps (depth [H,W], cost [H,W],
    normal [H,W,3]) on the mesh's root device (or on `device`)."""
    devs = shard_devices(mesh, device)
    with_geom = use_geom and src_depths is not None
    args = (refs, srcs, K_ref, K_srcs, R_rel, t_rel, depths)
    B = len(refs)
    out = ([], [], [])
    for k in range(B):
        dev = devs[k * len(devs) // B]
        one = [torch.as_tensor(a[k], dtype=torch.float32, device=dev) for a in args]
        geom = {}
        if with_geom:
            geom = dict(src_depths=torch.as_tensor(src_depths[k], dtype=torch.float32, device=dev),
                        use_geom=True)
        for maps, m in zip(out, stereo_ops.plane_sweep(*one, opts, **geom)):
            maps.append(m)
    # every view launched before any copy to the root, so distinct cards overlap
    return tuple([m.to(devs[0]) for m in maps] for maps in out)
