"""Dense reconstruction pipeline: per-view plane-sweep stereo + fusion.

Port of colmap_pcd_tpu/models/mvs.py (parity with src/mvs/patch_match.{h,cc},
PatchMatchController's per-reference problems, and src/mvs/fusion.{h,cc},
StereoFusion): on an undistorted workspace (models/undistortion.py output),
depth/normal/cost maps per registered view with ops/stereo.plane_sweep in
two passes (photometric, then with the geometric-consistency term), then
the consistency mask of every view and the fused, coloured cloud with
normals (fused.ply).

Each image is read and uploaded once; a view's maps come back to the host
in one fetch per pass. The first pass's maps are kept as
`<name>.photometric.npy` beside the last pass's `<name>.npy` (COLMAP's
`.photometric` and `.geometric` maps), which fusion reads. PHASES spans:
`stereo.problem` (a view's sources, depth range and uploads),
`stereo.sweep` (one view-pass, or a mesh group's, through the fetch of its
maps, `stereo_fetch`), `stereo.write`, and in fusion `fusion.mask` (the
consistency mask through its fetch, `fusion_fetch`) and `fusion.points`
(back-projection and the PLY). Counters of the sweeps' work:
`stereo_view_passes`; `stereo_hyp`, the (pixel, source, depth) hypotheses
H*W*S*D; `stereo_tap_hyp`, those times the (2r+1)^2 window taps;
`stereo_hyp_geom`, the hypotheses of the geometric pass; `stereo_bytes`,
the images (and source depth maps) read once and the maps written once.
Both passes sweep the views through parallel/dist_mvs.py, in groups of
one view per device of `mesh=` (parallel/mesh.py; without a mesh one view
at a time), as the JAX package's `_run_patch_match_sharded` fans them
out, but without its padding of sources and views, so every view's maps
equal the one-device run's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as device_mod
from ..io import ply as ply_io
from ..ops import np_geom
from ..ops import stereo as stereo_ops
from ..parallel import dist_mvs
from ..utils import image as image_utils
from ..utils.logging_utils import PHASES
from .reconstruction import Reconstruction


@dataclass
class DenseOptions:
    max_image_size: int = 640  # <= 0 keeps the views whole (COLMAP's -1)
    num_depths: int = 64
    num_src_images: int = 4
    window_radius: int = 3
    min_consistent: int = 2
    depth_min: float = 0.0  # 0 = auto from sparse points
    depth_max: float = 0.0
    # Bilaterally weighted NCC (patch_match.h:81-83); <=0 disables.
    sigma_color: float = 0.2
    sigma_spatial: float = -1.0
    # Two-pass stereo with a geometric-consistency term in the second pass
    # (patch_match.h:101-111, PatchMatchController's geom-consistent rerun).
    geom_consistency: bool = True


def _pose(img):
    return np.asarray(img.qvec, np.float32), np.asarray(img.tvec, np.float32)


def _K_of(cam, scale):
    from ..ops import camera_models as cm

    fi, fj, ci, cj = cm._FOCAL_IDX[cam.model_id]
    p = cam.params
    return np.asarray(
        [[p[fi] * scale, 0, p[ci] * scale], [0, p[fj] * scale, p[cj] * scale], [0, 0, 1]],
        np.float32,
    )


def _select_sources(rec: Reconstruction, ref_id: int, n: int) -> list[int]:
    """Source views by shared-point covisibility (patch_match.cc source
    selection via sparse model)."""
    ref = rec.images[ref_id]
    shared: dict[int, int] = {}
    for pid in ref.point3D_ids[ref.point3D_ids >= 0]:
        p = rec.points3D.get(int(pid))
        if p is None:
            continue
        for iid, _ in p.track:
            if iid != ref_id:
                shared[iid] = shared.get(iid, 0) + 1
    ranked = sorted(shared.items(), key=lambda kv: -kv[1])
    return [i for i, _ in ranked[:n]]


def _depth_range(rec: Reconstruction, ref_id: int) -> tuple[float, float]:
    """Depth bounds from the sparse points visible in the view
    (patch_match.cc depth_min/max from sparse model)."""
    img = rec.images[ref_id]
    q, t = _pose(img)
    zs = []
    for pid in img.point3D_ids[img.point3D_ids >= 0]:
        p = rec.points3D.get(int(pid))
        if p is None:
            continue
        z = float(np_geom.se3_apply(q, t, p.xyz)[2])
        if z > 0:
            zs.append(z)
    if not zs:
        return 0.5, 50.0
    zs = np.asarray(zs)
    return float(np.percentile(zs, 2) * 0.8), float(np.percentile(zs, 98) * 1.25)


def _relative(rec: Reconstruction, ref_id: int, other_id: int) -> tuple[np.ndarray, np.ndarray]:
    """(R, t) with x_other = R x_ref + t."""
    q_r, t_r = _pose(rec.images[ref_id])
    q_o, t_o = _pose(rec.images[other_id])
    q_rel, t_rel = np_geom.se3_compose(q_o, t_o, *np_geom.se3_inverse(q_r, t_r))
    return np_geom.quat_to_rotmat(q_rel).astype(np.float32), np.asarray(t_rel, np.float32)


def _fit(x: torch.Tensor, shape) -> torch.Tensor:
    """x zero-padded or cropped to `shape` (the reference's static shape)."""
    if tuple(x.shape) == tuple(shape):
        return x
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    h = min(shape[0], x.shape[0])
    w = min(shape[1], x.shape[1])
    out[:h, :w] = x[:h, :w]
    return out


def run_patch_match_stereo(
    workspace: str,
    options: DenseOptions = DenseOptions(),
    rec: Reconstruction | None = None,
    images: dict[int, np.ndarray] | None = None,
    device=None,
    mesh=None,
) -> int:
    """Compute depth/normal/cost maps for every registered view with a
    source view, on `device` (None: CUDA; with a mesh, its root device), or
    with `mesh` sharded over its devices.

    workspace/sparse = undistorted model; workspace/images = undistorted
    images (run_image_undistorter layout). Writes workspace/stereo/
    {depth_maps,normal_maps,cost_maps}/<name>.npy (the last pass) and
    <name>.photometric.npy (the first). Returns the view count.
    """
    dev = mesh.root if mesh is not None and device is None else device_mod.resolve(device)
    if rec is None:
        rec = Reconstruction.read(os.path.join(workspace, "sparse"))
    sdir = os.path.join(workspace, "stereo")
    for d in ("depth_maps", "normal_maps", "cost_maps"):
        os.makedirs(os.path.join(sdir, d), exist_ok=True)

    loaded: dict[int, tuple[torch.Tensor, float]] = {}

    def load_image(iid):
        if iid not in loaded:
            if images is not None:
                img = images[iid]
            else:
                img = image_utils.imread_gray(os.path.join(workspace, "images", rec.images[iid].name))
            img, scale = image_utils.resize_max(img, options.max_image_size)
            loaded[iid] = (torch.as_tensor(np.asarray(img, np.float32), device=dev), scale)
        return loaded[iid]

    sopts = stereo_ops.StereoOptions(
        num_depths=options.num_depths,
        window_radius=options.window_radius,
        min_consistent=options.min_consistent,
        sigma_color=options.sigma_color,
        sigma_spatial=options.sigma_spatial,
    )
    taps = (2 * options.window_radius + 1) ** 2

    def view_problem(ref_id):
        """The per-reference problem: (sources, then plane_sweep's inputs)."""
        srcs = _select_sources(rec, ref_id, options.num_src_images)
        if len(srcs) < 1:
            return None
        ref_img, scale = load_image(ref_id)
        K_ref = _K_of(rec.cameras[rec.images[ref_id].camera_id], scale)
        src_imgs, K_srcs, R_rels, t_rels = [], [], [], []
        for sid in srcs:
            s_img, s_scale = load_image(sid)
            src_imgs.append(_fit(s_img, ref_img.shape))
            R, t = _relative(rec, ref_id, sid)
            R_rels.append(R)
            t_rels.append(t)
            K_srcs.append(_K_of(rec.cameras[rec.images[sid].camera_id], s_scale))
        dmin, dmax = (options.depth_min, options.depth_max)
        if dmin <= 0 or dmax <= 0:
            dmin, dmax = _depth_range(rec, ref_id)
        # inverse-depth spacing
        depths = 1.0 / np.linspace(1.0 / dmax, 1.0 / dmin, options.num_depths)

        def put(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        return (
            srcs, ref_img, torch.stack(src_imgs), put(K_ref), put(np.stack(K_srcs)),
            put(np.stack(R_rels)), put(np.stack(t_rels)), put(depths),
        )

    def fetch(depth, cost, normal) -> np.ndarray:
        with PHASES.phase("stereo_fetch"):
            return torch.cat([depth[..., None], cost[..., None], normal], -1).cpu().numpy()

    def write_maps(ref_id, maps, suffixes):
        name = rec.images[ref_id].name.replace("/", "_")
        for suffix in suffixes:
            np.save(os.path.join(sdir, "depth_maps", name + suffix), np.ascontiguousarray(maps[..., 0]))
            np.save(os.path.join(sdir, "normal_maps", name + suffix), np.ascontiguousarray(maps[..., 2:]))
            np.save(os.path.join(sdir, "cost_maps", name + suffix), np.ascontiguousarray(maps[..., 1]))

    def count_work(ref_id, geom):
        H, W = problems[ref_id][1].shape
        hyp = H * W * len(problems[ref_id][0]) * options.num_depths
        images = H * W * (1 + len(problems[ref_id][0]) * (2 if geom else 1))
        PHASES.count("stereo_view_passes")
        PHASES.count("stereo_hyp", hyp)
        PHASES.count("stereo_tap_hyp", hyp * taps)
        PHASES.count("stereo_bytes", 4 * (images + 5 * H * W))
        if geom:
            PHASES.count("stereo_hyp_geom", hyp)

    problems = {}
    for ref_id in rec.registered_ids:
        with PHASES.phase("stereo.problem"):
            prob = view_problem(ref_id)
        if prob is not None:
            problems[ref_id] = prob

    # both passes sweep the views in groups of one per mesh device (without
    # a mesh: one view at a time), each group's maps saved before the next
    ids = list(problems)
    n = mesh.size if mesh is not None else 1

    def sweep(suffixes, src_depths_of=None) -> dict:
        depth_of = {}
        for g in range(0, len(ids), n):
            group = ids[g : g + n]
            batch = [[problems[i][f] for i in group] for f in range(1, 8)]
            geom = {}
            if src_depths_of is not None:
                geom = dict(src_depths=[src_depths_of(i) for i in group], use_geom=True)
            with PHASES.phase("stereo.sweep"):
                maps = dist_mvs.plane_sweep_batch(*batch, sopts, mesh=mesh, device=dev, **geom)
                fetched = [fetch(*m) for m in zip(*maps)]
            with PHASES.phase("stereo.write"):
                for i, m in zip(group, fetched):
                    write_maps(i, m, suffixes)
            for i, depth in zip(group, maps[0]):
                count_work(i, src_depths_of is not None)
                depth_of[i] = depth
        return depth_of

    # pass 1: photometric-only sweeps (the reference's non-geom first run),
    # kept as <name>.photometric.npy; without a second pass they are final
    photo_depth = sweep([".photometric.npy"] if options.geom_consistency else [".photometric.npy", ".npy"])

    # pass 2: rerun with the geometric-consistency term against the sources'
    # pass-1 depth maps (PatchMatchController geom-consistent rerun)
    if options.geom_consistency:
        def src_depths_of(ref_id):
            shape = problems[ref_id][1].shape
            return torch.stack([
                _fit(photo_depth[s], shape) if s in photo_depth
                else torch.zeros(shape, dtype=torch.float32, device=dev)
                for s in problems[ref_id][0]
            ])

        sweep([".npy"], src_depths_of)
    return len(problems)


def run_stereo_fusion(
    workspace: str,
    output_path: str | None = None,
    options: DenseOptions = DenseOptions(),
    rec: Reconstruction | None = None,
    images: dict[int, np.ndarray] | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fuse per-view depth maps into a consistent colored cloud with normals.
    Returns (points [N,3], normals [N,3], colors [N,3]); writes fused.ply.

    As in the JAX package, each reference is checked against the first four
    other views in `registered_ids` order (not its neighbours), and without
    `images` the camera is taken at scale 1.0 even where max_image_size
    shrank the maps (ROADMAP queue 3). Prints the fused points per tenth of
    the views. The consistency masks run on `device` (None: CUDA)."""
    dev = device_mod.resolve(device)
    if rec is None:
        rec = Reconstruction.read(os.path.join(workspace, "sparse"))
    sdir = os.path.join(workspace, "stereo")
    sopts = stereo_ops.StereoOptions(min_consistent=options.min_consistent)

    maps = {}
    for ref_id in rec.registered_ids:
        name = rec.images[ref_id].name.replace("/", "_")
        dp = os.path.join(sdir, "depth_maps", name + ".npy")
        if os.path.exists(dp):
            maps[ref_id] = (
                np.load(dp),
                np.load(os.path.join(sdir, "normal_maps", name + ".npy")),
                np.load(os.path.join(sdir, "cost_maps", name + ".npy")),
            )
    on_device: dict[int, torch.Tensor] = {}

    def depth_on_device(iid):
        if iid not in on_device:
            on_device[iid] = torch.as_tensor(maps[iid][0], device=dev)
        return on_device[iid]

    all_pts, all_nrm, all_col = [], [], []
    counts = []
    ids = list(maps.keys())
    for ref_id in ids:
        depth, normal, cost = maps[ref_id]
        H, W = depth.shape
        others = [i for i in ids if i != ref_id][:4]
        if not others:
            counts.append(0)
            continue
        q_r, t_r = _pose(rec.images[ref_id])
        scale = 1.0
        if images is not None:
            img0 = images[ref_id]
            scale = W / img0.shape[1]
        K = _K_of(rec.cameras[rec.images[ref_id].camera_id], scale)
        R_os, t_os = zip(*(_relative(rec, ref_id, oid) for oid in others))
        d_os = torch.stack([_fit(depth_on_device(oid), (H, W)) for oid in others])

        def put(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        with PHASES.phase("fusion.mask"):
            mask_d = stereo_ops.consistency_mask(
                depth_on_device(ref_id), put(cost), d_os, put(K), put(np.stack(R_os)), put(np.stack(t_os)), sopts,
            )
            with PHASES.phase("fusion_fetch"):
                mask = mask_d.cpu().numpy()
        ys, xs = np.nonzero(mask)
        counts.append(int(ys.size))
        if ys.size == 0:
            continue
        with PHASES.phase("fusion.points"):
            z = depth[ys, xs]
            Kinv = np.linalg.inv(K)
            pix = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float32)
            x_cam = (pix @ Kinv.T) * z[:, None]
            qi, ti = np_geom.se3_inverse(q_r, t_r)
            x_w = np_geom.quat_rotate(qi, x_cam) + np_geom.projection_center(q_r, t_r)
            n_w = np_geom.quat_rotate(qi, normal[ys, xs])
            if images is not None:
                img0 = images[ref_id]
                rows = np.minimum((ys / scale).astype(int), img0.shape[0] - 1)
                cols = np.minimum((xs / scale).astype(int), img0.shape[1] - 1)
                g = np.clip(img0[rows, cols] * 255, 0, 255).astype(np.uint8)
                col = np.stack([g, g, g], -1)
            else:
                col = np.full((ys.size, 3), 128, np.uint8)
        all_pts.append(x_w)
        all_nrm.append(n_w)
        all_col.append(col)
    if counts:
        tenths = np.array_split(np.asarray(counts), min(10, len(counts)))
        print("stereo_fusion: fused points per tenth of the views: "
              + ", ".join(str(int(t.sum())) for t in tenths))
    if not all_pts:
        return np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3), np.uint8)
    pts = np.concatenate(all_pts)
    nrm = np.concatenate(all_nrm)
    col = np.concatenate(all_col)
    with PHASES.phase("fusion.points"):
        out = output_path or os.path.join(workspace, "fused.ply")
        ply_io.write_ply(out, pts, nrm, col)
    return pts, nrm, col
