"""A dry run of every sharded path over an n-device mesh.

Counterpart of the JAX package's `__graft_entry__.dryrun_multichip`:

    python -c "from colmap_pcd_tpu_torch.parallel import dryrun; dryrun.dryrun_multichip(2, 'cuda:0')"

It runs (a) one sharded matching batch (parallel/dist_matching), (b) one
mapper round on utils/synthetic_world.py's lidar world (4 images, 260
points): the lidar-seeded init, one registration with its triangulation and
local refinement, and the spherical global BA, with every BA solve routed
through the distributed Schur solver (parallel/dist_ba), and (c) a stereo
fan-out (parallel/dist_mvs).
"""

from __future__ import annotations

import numpy as np

from .. import device as device_mod
from . import dist_matching, dist_mvs
from .mesh import make_mesh


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The three sharded paths over a mesh of n_devices: the visible CUDA
    devices (raises where fewer are visible), or with `device` that one
    device repeated n_devices times. Raises on any failed check; returns
    what it counted."""
    if device is None:
        mesh = make_mesh(n_devices)
    else:
        mesh = make_mesh(n_devices, devices=[device_mod.resolve(device)] * n_devices)

    # (a) sharded matching: one pair batch across the mesh
    rng = np.random.default_rng(0)
    B, N, D = n_devices, 128, 128
    d = rng.normal(size=(2 * B, N, D)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    v = np.ones((B, N), np.float32)
    idx, ok = dist_matching.match_pairs_batch(d[:B], d[B:], v, v, mesh=mesh)
    if ok.shape != (B, N):
        raise AssertionError(f"sharded matching returned {ok.shape}, not {(B, N)}")

    # (b) a mapper round on a tiny synthetic world, dist-BA on every solve
    from ..models.controllers import ControllerOptions, IncrementalMapperController
    from ..models.incremental_mapper import MapperOptions
    from ..models.triangulator import TriangulatorOptions
    from ..utils.synthetic_world import make_world

    rec, graph, lmap, gt = make_world(
        np.random.default_rng(5), n_images=4, n_points=260, noise_px=0.2, map_spacing=0.25,
        device=mesh.root,
    )
    opts = MapperOptions(
        if_add_lidar_constraint=True,
        init_image_id1=1, init_image_id2=2,
        init_min_num_inliers=30, abs_pose_min_num_inliers=12,
        num_ransac_hypotheses=512,
        ba_local_max_num_iterations=3, ba_global_max_num_iterations=3,
    )
    ctl = IncrementalMapperController(
        rec, graph, opts, ControllerOptions(verbose=False), lidar_map=lmap, pose_priors={1: gt[0]},
    )
    ctl.mapper.dist_mesh = mesh
    if not ctl.initialize():
        raise AssertionError("dry run: mapper init failed")
    # one registration: PnP + triangulation + local BA (association +
    # distributed Schur solve) + spherical global BA
    nxt = ctl.mapper.find_next_images(opts)
    if not (nxt and ctl.mapper.register_next_image(opts, nxt[0])):
        raise AssertionError("dry run: no image registered")
    ctl.mapper.triangulator.triangulate_image(TriangulatorOptions(), nxt[0])
    ctl.iterative_local_refinement(nxt[0])
    ctl.mapper.adjust_global_bundle_by_lidar(opts)

    # (c) dense stereo fan-out: per-view plane sweeps sharded over the mesh
    Hs, Ws, S, Dn = 32, 48, 2, 8
    refs = rng.uniform(0, 1, (n_devices, Hs, Ws)).astype(np.float32)
    srcs = rng.uniform(0, 1, (n_devices, S, Hs, Ws)).astype(np.float32)
    Km = np.tile(np.asarray([[40.0, 0, Ws / 2], [0, 40.0, Hs / 2], [0, 0, 1]], np.float32), (n_devices, 1, 1))
    Ks = np.tile(Km[:, None], (1, S, 1, 1))
    Rr = np.tile(np.eye(3, dtype=np.float32), (n_devices, S, 1, 1))
    tr = rng.normal(0, 0.1, (n_devices, S, 3)).astype(np.float32)
    depths = np.tile(np.linspace(2.0, 8.0, Dn, dtype=np.float32), (n_devices, 1))
    dm, _, _ = dist_mvs.plane_sweep_batch(refs, srcs, Km, Ks, Rr, tr, depths, mesh=mesh)
    if [tuple(d.shape) for d in dm] != [(Hs, Ws)] * n_devices:
        raise AssertionError(f"stereo fan-out returned {[tuple(d.shape) for d in dm]}")
    if rec.num_reg_images != 3:
        raise AssertionError(f"dry run: {rec.num_reg_images} images registered, not 3")
    print(f"dryrun_multichip({n_devices}): mapper round ok — {rec.num_reg_images} images, "
          f"{len(rec.points3D)} points, matching batch {B}x{N} + stereo fan-out on mesh "
          f"{[str(d) for d in mesh.devices]}")
    return {"registered": rec.num_reg_images, "points": len(rec.points3D), "mesh": mesh.size}
