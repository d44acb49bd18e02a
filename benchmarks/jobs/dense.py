"""Job kind `dense`: one capture's sparse model densified as COLMAP's dense
stage runs it, through the port's entry points in the CLI's order:
run_image_undistorter, run_patch_match_stereo (a photometric pass, then a
geometric one) and run_stereo_fusion, each with the configuration's `dense`
group as its DenseOptions, in a fresh workspace.

The sparse models are made in set-up. The warm-up (index -1), the one
set-up hook a job kind has, maps its own capture and every rendered job's
capture (the `job*` directories beside its own) with jobs/pipeline.py's
`run` at the configuration's front-end and mapper options, writes each
model beside its images (`sparse/`, and its arrays as `model.npz` for the
judge), then densifies its own capture. A window job densifies its
capture's model; the deadline is checked between the stages. It counts as
registered the views whose maps fusion read.

The judge holds each finished job to benchmarks/reference/stereo.py (float64,
on the job's device). The reference reads the rendered views themselves;
the undistorter's copies (PINHOLE: the views unchanged) are held to them
in grey levels (`undistort_grey`), and the sparse model's camera centres,
which give both sides their poses, sources and depth bank, to the truth
within the configuration's pose tolerance. Stereo: 512 seeded pixels of
every view in each pass, the first pass against the sources' views, the
second also against the program's own first-pass depth maps
(`<name>.photometric.npy`), the sources and the depth bank worked out again
from the sparse model. A sampled pixel's plane is held where the
reference's two least costs differ by more than TIE and its window's
variance exceeds FLAT (a flat window's NCC is 0 / 0: the sky above the
corridor); where the planes agree, the cost map is held to the
reference's photometric cost of that plane (its 99th percentile error).
Fusion: the reference's test of every pixel of every view on the
program's final depth and cost maps (against the first four other views
in registration order, the port's rule) gives the fused count, which the
program's fused cloud has to match wherever the test is decided (further
than TIE from its boundaries). The
true depth of each sampled pixel comes from check.surface_points, and every
fused point is held to the corridor's planes.

The widths that the program holds fixed (ops/stereo.StereoOptions) are the
configuration's `dense_fixed`; the warm-up checks them, and that the
program keeps a view whole at the configuration's max_image_size, before
any work. It also has the program's PHASES spans recorded over a traced
window (benchmarks/spans.py), from which the judge takes the seconds in
which the card ran inside the plane sweeps (`sweep_busy_s`).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from benchmarks import harness
from benchmarks.reference import check, stereo as reference

SAMPLES = 512  # pixels a view and pass
TIE = 1e-4  # least gap between the reference's two best costs at which a plane is held
FLAT = 1e-6  # least variance of the reference's window at which a plane is held (NCC 0 / 0 below)
# the percentile of the cost errors compared: f32 sums of 121 taps leave a few samples in a thousand of
# a low-variance window 1e-3 or more from the float64 cost (CPU rehearsal: 99th 5.9e-5, max 2.1e-3)
COST_PCT = 99
SEED = 5_100_217
_TRACED = {}  # from the warm-up to the judge: benchmarks/spans.py's recording


def _dense_options(ctx):
    """The configuration's DenseOptions, after checking that the program
    holds its other widths (`dense_fixed`) and keeps a view whole at its
    max_image_size."""
    from colmap_pcd_tpu_torch.models.mvs import DenseOptions
    from colmap_pcd_tpu_torch.ops.stereo import StereoOptions
    from colmap_pcd_tpu_torch.utils.image import resize_max

    held = StereoOptions()._asdict()
    for key, value in ctx.cell.config["dense_fixed"].items():
        if held[key] != value:
            raise RuntimeError(f"the plane sweep holds {key} at {held[key]}, the configuration states {value}")
    options = ctx.options("dense", DenseOptions(**ctx.cell.config["dense"]))
    view = np.zeros((9, 12), np.float32)
    kept, scale = resize_max(view, options.max_image_size)
    if kept.shape != view.shape or scale != 1.0:
        raise RuntimeError(f"the program does not keep a view whole at max_image_size {options.max_image_size}")
    return options


def _record_program_spans() -> None:
    if "recording" not in _TRACED:
        from benchmarks import spans

        recording = spans.record_program_spans()
        _TRACED.update(recording=recording, held=recording.__enter__())


def _sweep_busy_s() -> float | None:
    """The seconds of the traced window in which an operation ran on the
    card inside the program's `stereo.sweep` spans, or None without a
    traced window; ends the recording."""
    from benchmarks import spans

    recording, held = _TRACED.pop("recording", None), _TRACED.pop("held", {})
    if recording is None:
        return None
    recording.__exit__(None, None, None)
    row = held.get("span_table", {}).get("stereo.sweep")
    if row is None:
        return None
    sweeps = spans.union((s, e) for name, s, e, _parent, _thread in held["program_spans"] if name == "stereo.sweep")
    return sum(e - s for s, e in sweeps) * 1e-9 - row["idle_s"]


def _write_model(model: dict, cfg: dict, job_dir: str) -> None:
    """The pipeline's model (pipeline.model_of's arrays) as a COLMAP model
    in `job_dir`/sparse, each image holding its observed keypoints, and the
    arrays as `job_dir`/model.npz."""
    from colmap_pcd_tpu_torch.models.reconstruction import Camera, Image, Reconstruction

    rec = Reconstruction()
    for cid, (model_id, params) in model["cameras"].items():
        rec.add_camera(Camera(cid, model_id, cfg["image_width"], cfg["image_height"], params))
    names = sorted(model["poses"])
    ids = {n: i + 1 for i, n in enumerate(names)}
    obs_image = np.asarray(model["obs_image"])
    track_of = []
    for n in names:
        sel = np.nonzero(obs_image == n)[0]
        q, t = model["poses"][n]
        rec.add_image(Image(ids[n], n, model["camera_of"][n], q, t, xys=model["obs_xy"][sel]))
        rec.register_image(ids[n])
        track_of += [(row, ids[n], k) for k, row in enumerate(model["obs_point"][sel])]
    tracks = {}
    for row, iid, k in track_of:
        tracks.setdefault(int(row), []).append((iid, k))
    for row, track in sorted(tracks.items()):
        rec.add_point3D(model["points"][row], track)
    rec.write(os.path.join(job_dir, "sparse"))
    cam = rec.cameras[rec.images[1].camera_id]
    np.savez(os.path.join(job_dir, "model.npz"), names=np.asarray(names),
             q=np.stack([model["poses"][n][0] for n in names]), t=np.stack([model["poses"][n][1] for n in names]),
             camera=np.asarray(cam.params[:4], np.float64), points=model["points"],
             obs_point=model["obs_point"], obs_image=obs_image)


def _map_captures(ctx) -> None:
    """Every capture of the run mapped with jobs/pipeline.py into a model
    beside its images."""
    pipeline = harness.job_kind("pipeline", ctx.cell.root)
    cfg = ctx.cell.config
    world = ctx.cell.world()
    root = os.path.dirname(os.path.dirname(ctx.image_dir))
    for name in sorted(os.listdir(root)):
        job_dir = os.path.join(root, name)
        image_dir = os.path.join(job_dir, "images")
        if not name.startswith("job") or not os.path.isdir(image_dir):
            continue
        views = sum(f.endswith(".png") for f in os.listdir(image_dir))
        work = os.path.join(job_dir, "map")
        os.makedirs(work)
        sub = harness.JobContext(ctx.cell, ctx.index, views, image_dir, work, world.trajectory(views, cfg["step_m"]),
                                 ctx.device, ctx.spans, None, ctx.control)
        mapped = pipeline.run(sub)
        if mapped["registered"] < 2:
            raise RuntimeError(f"{name}: the mapper registered {mapped['registered']} of {views} views")
        _write_model(mapped["model"], cfg, job_dir)


def run(ctx) -> dict:
    from colmap_pcd_tpu_torch.models.mvs import run_patch_match_stereo, run_stereo_fusion
    from colmap_pcd_tpu_torch.models.undistortion import run_image_undistorter

    options = _dense_options(ctx)  # first: a program without these widths fails here, before any mapping
    if ctx.index < 0:
        _record_program_spans()
        _map_captures(ctx)
    job_dir = os.path.dirname(ctx.image_dir)
    workspace = os.path.join(ctx.work_dir, "dense")
    record = {"index": ctx.index, "views": ctx.views, "image_dir": ctx.image_dir, "workspace": workspace,
              "stopped": False,
              "device": str(ctx.device), "dense": dataclasses.asdict(options), "registered": 0,
              "t_start": time.perf_counter()}
    try:
        with ctx.spans.span("undistort"):
            t0 = time.perf_counter()
            run_image_undistorter(ctx.image_dir, os.path.join(job_dir, "sparse"), workspace, device=ctx.device)
            record["undistort_s"] = time.perf_counter() - t0
        ctx.check_deadline()
        with ctx.spans.span("stereo"):
            t0 = time.perf_counter()
            views = run_patch_match_stereo(workspace, options, device=ctx.device)
            record["stereo_s"] = time.perf_counter() - t0
        ctx.check_deadline()
        with ctx.spans.span("fusion"):
            t0 = time.perf_counter()
            points, _, _ = run_stereo_fusion(workspace, os.path.join(workspace, "fused.ply"), options,
                                             device=ctx.device)
            record["fusion_s"] = time.perf_counter() - t0
        ctx.check_deadline()
        record.update(registered=views, fused_points=len(points))
    except harness.Deadline:
        record["stopped"] = True
    record["t_end"] = time.perf_counter()
    with np.load(os.path.join(job_dir, "model.npz")) as z:
        record["model"] = {k: z[k] for k in z.files}
    return record


def _sources(model: dict, v: int, n: int) -> list[int]:
    """The views that share most sparse points with view v, most first (at
    most n)."""
    names, obs_image, obs_point = model["names"], model["obs_image"], model["obs_point"]
    mine = set(obs_point[obs_image == names[v]].tolist())
    shared = {}
    for row, name in zip(obs_point.tolist(), obs_image.tolist()):
        if name != names[v] and row in mine:
            shared[name] = shared.get(name, 0) + 1
    index = {name: i for i, name in enumerate(names.tolist())}
    return [index[name] for name, _ in sorted(shared.items(), key=lambda kv: -kv[1])[:n]]


def _bank(model: dict, v: int, num_depths: int) -> np.ndarray:
    """The depth bank of view v: inverse-depth spacing between the 2nd
    percentile of its sparse points' depths x 0.8 and the 98th x 1.25."""
    rows = model["obs_point"][model["obs_image"] == model["names"][v]]
    z = (model["points"][rows] @ check._rotmat(model["q"][v]).T + model["t"][v])[:, 2]
    z = z[z > 0]
    dmin, dmax = (np.percentile(z, 2) * 0.8, np.percentile(z, 98) * 1.25) if len(z) else (0.5, 50.0)
    return 1.0 / np.linspace(1.0 / dmax, 1.0 / dmin, num_depths)


def _read_gray(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"), np.float64) / 255.0


def _ply_xyz(path: str) -> np.ndarray:
    """The vertices' x, y, z of a binary little-endian PLY."""
    types = {"float": "f4", "double": "f8", "uchar": "u1", "int": "i4", "uint": "u4"}
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    n, props = 0, []
    for line in data[:end].decode("ascii").splitlines():
        tok = line.split()
        if tok[:2] == ["element", "vertex"]:
            n = int(tok[2])
        elif tok and tok[0] == "property":
            props.append((tok[2], "<" + types[tok[1]]))
    arr = np.frombuffer(data, np.dtype(props), count=n, offset=end)
    return np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float64)


def _relative(model: dict, a: int, b: int) -> tuple[np.ndarray, np.ndarray]:
    """(R, t) that take camera a's points to camera b's."""
    R_a, R_b = check._rotmat(model["q"][a]), check._rotmat(model["q"][b])
    R = R_b @ R_a.T
    return R, model["t"][b] - R @ model["t"][a]


def _check_view(r: dict, cfg: dict, v: int, truth, rng) -> dict:
    """One view of a finished job against the reference: each pass's held,
    tied and mismatched samples and its cost error where the planes agree,
    the float16 reference's mismatches and cost error, and the final
    depths' error against the truth."""
    model, opts, fixed, ws = r["model"], r["dense"], cfg["dense_fixed"], r["workspace"]
    names = model["names"].tolist()
    maps = os.path.join(ws, "stereo", "depth_maps")
    srcs = _sources(model, v, opts["num_src_images"])
    fx, fy, cx, cy = model["camera"]
    K = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    ref = _read_gray(os.path.join(r["image_dir"], names[v]))
    H, W = ref.shape
    R_rel, t_rel = zip(*(_relative(model, v, s) for s in srcs))
    bank = _bank(model, v, opts["num_depths"])
    xs, ys = rng.integers(0, W, SAMPLES), rng.integers(0, H, SAMPLES)
    dev = torch.device(r["device"])
    args = (ref, np.stack([_read_gray(os.path.join(r["image_dir"], names[s])) for s in srcs]), K,
            np.stack([K] * len(srcs)), np.stack(R_rel), np.stack(t_rel), bank, xs, ys)
    kw = dict(window_radius=opts["window_radius"], sigma_spatial=opts["sigma_spatial"],
              sigma_color=opts["sigma_color"], top_k=fixed["top_k"], geom_regularizer=fixed["geom_regularizer"],
              geom_max_cost=fixed["geom_max_cost"], device=dev)
    defined = reference.window_variance(ref, xs, ys, window_radius=opts["window_radius"],
                                        sigma_spatial=opts["sigma_spatial"],
                                        sigma_color=opts["sigma_color"]).numpy() > FLAT
    out = {"cost_err": [], "half_cost_err": []}
    passes = [("photometric", ".photometric.npy", None)]
    if opts["geom_consistency"]:
        src_depths = np.stack([np.load(os.path.join(maps, names[s] + ".photometric.npy")) for s in srcs])
        passes.append(("geometric", ".npy", src_depths))
    rows = np.arange(SAMPLES)
    for label, suffix, src_depths in passes:
        depth = np.load(os.path.join(maps, names[v] + suffix))[ys, xs].astype(np.float64)
        cost = np.load(os.path.join(ws, "stereo", "cost_maps", names[v] + suffix))[ys, xs].astype(np.float64)
        total, photo = reference.plane_costs(*args, src_depths=src_depths, **kw)
        plane, gap = (a.cpu().numpy() for a in reference.best_plane(total))
        photo = photo.cpu().numpy()[rows, plane]
        chosen = np.argmin(np.abs(1.0 / depth[:, None] - 1.0 / bank[None]), 1)
        held = (gap > TIE) & defined
        out[label] = {"sampled": SAMPLES, "held": int(held.sum()),
                      "mismatched": int(np.sum(held & (chosen != plane)))}
        out["cost_err"] += np.abs(cost - photo)[held & (chosen == plane)].tolist()
        if src_depths is None:  # the same reference at float16, the precision below the program's
            half_total, half_photo = reference.plane_costs(*args, dtype=torch.float16, **kw)
            half_plane = torch.argmin(half_total, 1).cpu().numpy()
            out["half_mismatched"] = int(np.sum(held & (half_plane != plane)))
            half_photo = half_photo.double().cpu().numpy()[rows, plane]
            out["half_cost_err"] += np.nan_to_num(np.abs(half_photo - photo), nan=np.inf)[held].tolist()
    final = np.load(os.path.join(maps, names[v] + ".npy"))[ys, xs].astype(np.float64)
    cost = np.load(os.path.join(ws, "stereo", "cost_maps", names[v] + ".npy"))[ys, xs]
    xyz, hit = check.surface_points(truth[check.view_index(names[v])], np.stack([xs, ys], -1).astype(np.float64),
                                    cfg["focal_length"], cfg["image_width"], cfg["image_height"])
    q_t, t_t = truth[check.view_index(names[v])]
    z_true = (xyz @ check._rotmat(q_t).T + t_t)[:, 2]
    keep = hit & (cost < 1 - fixed["min_ncc"])
    out["depth_err"] = (np.abs(final - z_true)[keep] / z_true[keep]).tolist()
    return out


def _check_fusion(r: dict, cfg: dict, have: list, fused: int) -> dict:
    """Fusion's test by the reference on every pixel of the program's final
    maps: the fused counts it allows (`lo`: the pixels it fuses where it is
    decided; `hi`: those and every undecided pixel), the same test's count
    at float16, and how far a count lies outside [lo, hi], in % of hi, for
    the program's cloud and for the float16 test."""
    model, opts, fixed, ws = r["model"], r["dense"], cfg["dense_fixed"], r["workspace"]
    names = model["names"].tolist()
    dev = torch.device(r["device"])
    fx, fy, cx, cy = model["camera"]
    K = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    def load(kind, v):
        return torch.as_tensor(np.load(os.path.join(ws, "stereo", kind, names[v] + ".npy")), device=dev)

    depth = {v: load("depth_maps", v) for v in have}
    lo = hi = half = 0
    for v in have:
        others = [o for o in have if o != v][:4]
        if not others:
            continue
        R_o, t_o = zip(*(_relative(model, v, o) for o in others))
        test = (depth[v], load("cost_maps", v), torch.stack([depth[o] for o in others]), K, np.stack(R_o),
                np.stack(t_o))
        gates = dict(min_consistent=opts["min_consistent"], max_depth_error=fixed["max_depth_error"],
                     min_ncc=fixed["min_ncc"])
        mask, margin = reference.consistency_mask(*test, **gates)
        decided = margin > TIE
        lo += int((mask & decided).sum())
        hi += int((mask | ~decided).sum())
        half += int(reference.consistency_mask(*test, dtype=torch.float16, **gates)[0].sum())

    def outside(n):
        return 100.0 * max(lo - n, n - hi, 0) / max(hi, 1)

    return {"fused_ref_lo": lo, "fused_ref_hi": hi, "fused_count_pct": outside(fused),
            "half_fused_count_pct": outside(half)}


def _undistort_grey(r: dict) -> float:
    """The largest difference, in grey levels, between an undistorted view
    and its source (inf where the undistorter wrote none)."""
    worst = 0.0
    for name in r["model"]["names"].tolist():
        out = os.path.join(r["workspace"], "images", name)
        if not os.path.exists(out):
            return float("inf")
        diff = np.abs(_read_gray(out) - _read_gray(os.path.join(r["image_dir"], name)))
        worst = max(worst, 255.0 * float(diff.max()))
    return worst


def _check_job(r: dict, cfg: dict, truth) -> dict:
    t0 = time.perf_counter()
    model = r["model"]
    names = model["names"].tolist()
    maps = os.path.join(r["workspace"], "stereo", "depth_maps")
    have = [v for v, n in enumerate(names) if os.path.exists(os.path.join(maps, n + ".npy"))]
    row = {"views_without_maps": len(truth) - len(have), "sampled": 0, "held": 0, "mismatched": 0,
           "half_mismatched": 0,
           "held_photometric": 0, "mismatched_photometric": 0, "held_geometric": 0, "mismatched_geometric": 0}
    centres = np.asarray([check.center(q, t) for q, t in zip(model["q"], model["t"])])
    true_centres = np.asarray([check.center(*truth[check.view_index(n)]) for n in names])
    row["pose_err_mm"] = 1e3 * float(np.linalg.norm(centres - true_centres, axis=1).max())
    row["undistort_grey"] = _undistort_grey(r)
    errs, cost_err, half_cost_err = [], [], []
    for v in have:
        rng = np.random.default_rng([SEED, r["world"], v])
        out = _check_view(r, cfg, v, truth, rng)
        for label in ("photometric", "geometric"):
            if label in out:
                row["sampled"] += out[label]["sampled"]
                for key in ("held", "mismatched"):
                    row[key] += out[label][key]
                    row[f"{key}_{label}"] += out[label][key]
        row["half_mismatched"] += out["half_mismatched"]
        errs += out["depth_err"]
        cost_err += out["cost_err"]
        half_cost_err += out["half_cost_err"]
    row["depth_err_pct"] = 100.0 * float(np.median(errs)) if errs else float("inf")
    row["ref_cost_err"] = float(np.percentile(cost_err, COST_PCT)) if cost_err else float("inf")
    row["half_cost_err"] = float(np.percentile(half_cost_err, COST_PCT)) if half_cost_err else float("inf")
    fused = os.path.join(r["workspace"], "fused.ply")
    xyz = _ply_xyz(fused) if os.path.exists(fused) else np.zeros((0, 3))
    row["fused_points"] = len(xyz)
    row.update(_check_fusion(r, cfg, have, len(xyz)))
    dist = np.min(np.stack([np.abs(xyz[:, 0] + check.WALL_X), np.abs(xyz[:, 0] - check.WALL_X),
                            np.abs(xyz[:, 1] - check.GROUND_Y)]), 0)
    row["fused_plane_mm"] = 1e3 * float(np.median(dist)) if len(xyz) else float("inf")
    row["check_s"] = time.perf_counter() - t0
    return row


def judge(cell, jobs: list, truths: dict, deadline: float) -> dict:
    """The reference's numbers over the window's finished jobs: the share
    of held samples whose plane differs from the reference's, both passes
    pooled (`ref_mismatch_pct`), the 99th percentile of the cost error
    where the planes agree (`ref_cost_err`, worst job), how far a job's fused count lies outside what
    the reference's fusion test allows (`fused_count_pct`, worst job), the
    fused points' median distance to the corridor (`fused_plane_mm`, worst
    job), the views without maps and the jobs without fused points
    (`missing`), the sparse models' worst camera centre (`pose_err_mm`),
    the undistorted views' largest difference from their sources
    (`undistort_grey`), and whether the first job ended after the deadline.
    Beside them: each pass's share, the float16 reference's readings, the
    samples whose plane is not determined (tied or flat), the depth error
    against the truth, the fused points, and with a traced window the
    card's busy seconds inside the plane sweeps (`sweep_busy_s`)."""
    sweep_busy_s = _sweep_busy_s()
    rows = [_check_job(r, cell.config, truths[r["index"]]) for r in jobs if not r["stopped"]]
    held = sum(p["held"] for p in rows)

    def pct(key, base):
        return 100.0 * sum(p[key] for p in rows) / max(base, 1)

    def worst(key):
        return max((p[key] for p in rows), default=float("inf"))

    numbers = {
        "ref_mismatch_pct": pct("mismatched", held),
        "ref_cost_err": worst("ref_cost_err"),
        "fused_count_pct": worst("fused_count_pct"),
        "fused_plane_mm": worst("fused_plane_mm"),
        "missing": float(sum(p["views_without_maps"] + (p["fused_points"] == 0) for p in rows)),
        "pose_err_mm": worst("pose_err_mm"),
        "undistort_grey": worst("undistort_grey"),
        "first_job_late": float(jobs[0]["t_end"] > deadline),
        "ref_mismatch_pct.photometric": pct("mismatched_photometric", sum(p["held_photometric"] for p in rows)),
        "ref_mismatch_pct.geometric": pct("mismatched_geometric", sum(p["held_geometric"] for p in rows)),
        "half_mismatch_pct": pct("half_mismatched", sum(p["held_photometric"] for p in rows)),
        "half_cost_err": worst("half_cost_err"),
        "half_fused_count_pct": worst("half_fused_count_pct"),
        "undetermined_pct": 100.0 - pct("held", sum(p["sampled"] for p in rows)),
        "depth_err_pct": worst("depth_err_pct"),
        "fused_points": float(sum(p["fused_points"] for p in rows)),
    }
    if sweep_busy_s is not None:
        numbers["sweep_busy_s"] = sweep_busy_s
    return {"numbers": numbers, "per_job": rows, "partial": [], "first_job": rows[0] if rows else {},
            "failed_images": sum(p["views_without_maps"] for p in rows)}
