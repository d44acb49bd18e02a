"""The plain reference that decides `correct`: NumPy and sqlite3 only.

It judges what the timed jobs produced against the generator's truth,
worked out again here from the world's definition (the corridor's three
planes, each view's pose and the configuration's intrinsics), and takes
nothing that the program derived:

- keypoints and matches, read from each job's database as the COLMAP
  schema stores them: every verified inlier match is held to the pair's
  true epipolar geometry (off it when either keypoint lies more than
  `epipolar_tol` pixels from its epipolar line), and carried through
  the scene (the keypoint's ray in one view cast onto the corridor,
  projected into the other): wrong when it lands more than `transfer_px`
  from its partner in either direction;
- the model: each registered image's camera centre against the truth in
  the map frame with no alignment (ATE), the distance from the first to the
  last registered view against the truth (scale), each point's distance to
  the nearest corridor surface, and the reprojection of each track;
- what never came: an image without keypoints, a keypoint outside its
  image, a pair of neighbouring views without a verified geometry, a view
  that the model did not register.

Imports nothing of the program.
"""

from __future__ import annotations

import sqlite3

import numpy as np

MAX_IMAGE_ID = 2147483647
# multiples of the epipolar tolerance at which off-line matches are counted
# (the tolerance itself, x1, decides; the others are printed)
EPIPOLAR_STEPS = (0.25, 0.5, 1, 2, 4)
WALL_X, GROUND_Y = 4.0, 2.0


def _rotmat(q) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def center(q, t) -> np.ndarray:
    return -_rotmat(q).T @ np.asarray(t, np.float64)


def view_index(name: str) -> int:
    """The view of an image file called v0000.png, v0001.png, ..."""
    return int(name.split(".")[0][1:])


def surface_points(pose, xy: np.ndarray, focal: float, width: int, height: int):
    """Where the rays of pixels `xy` [N,2] of a view at `pose` meet the
    corridor, as the renderer casts them: ([N,3] points, [N] hit)."""
    R = _rotmat(pose[0])
    C = -R.T @ np.asarray(pose[1], np.float64)
    dirs = np.stack([(xy[:, 0] - width / 2) / focal, (xy[:, 1] - height / 2) / focal,
                     np.ones(len(xy))], -1) @ R  # world frame: R^T d
    best = np.full(len(xy), np.inf)
    out = np.zeros((len(xy), 3))
    for axis, value in ((0, -WALL_X), (0, WALL_X), (1, GROUND_Y)):
        denom = dirs[:, axis]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(np.abs(denom) > 1e-9, (value - C[axis]) / denom, np.inf)
        p = C + np.where(np.isfinite(t), t, 0.0)[:, None] * dirs
        ok = (t > 0.05) & (t < best) & (p[:, 2] > -1.0) & (p[:, 2] < 500.0)
        if axis == 0:
            ok &= (p[:, 1] > -2.5) & (p[:, 1] < 2.05)
        else:
            ok &= (p[:, 0] > -4.05) & (p[:, 0] < 4.05)
        out[ok] = p[ok]
        best[ok] = t[ok]
    return out, np.isfinite(best)


def project(pose, X: np.ndarray, focal: float, width: int, height: int) -> np.ndarray:
    Xc = X @ _rotmat(pose[0]).T + np.asarray(pose[1], np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.stack([focal * Xc[:, 0] / Xc[:, 2] + width / 2, focal * Xc[:, 1] / Xc[:, 2] + height / 2], -1)


def _skew(v) -> np.ndarray:
    return np.asarray([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def epipolar_px(pose1, pose2, x1: np.ndarray, x2: np.ndarray, focal: float, width: int, height: int):
    """Each correspondence's larger distance (pixels) to its epipolar line
    in either view under the true relative pose: F = K^-T [t]x R K^-1."""
    R1, R2 = _rotmat(pose1[0]), _rotmat(pose2[0])
    R = R2 @ R1.T
    t = np.asarray(pose2[1], np.float64) - R @ np.asarray(pose1[1], np.float64)
    K = np.asarray([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1.0]])
    Ki = np.linalg.inv(K)
    F = Ki.T @ _skew(t) @ R @ Ki
    h1 = np.concatenate([x1, np.ones((len(x1), 1))], 1)
    h2 = np.concatenate([x2, np.ones((len(x2), 1))], 1)
    l2, l1 = h1 @ F.T, h2 @ F  # lines in view 2 and view 1
    num = np.abs(np.sum(h2 * l2, axis=1))
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.maximum(num / np.hypot(l2[:, 0], l2[:, 1]), num / np.hypot(l1[:, 0], l1[:, 1]))


def read_database(path: str) -> dict:
    """Images, keypoints and the verified inlier matches of a COLMAP-schema
    database."""
    conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        names = dict(conn.execute("SELECT image_id, name FROM images"))
        keypoints = {}
        for iid, rows, cols, data in conn.execute("SELECT image_id, rows, cols, data FROM keypoints"):
            keypoints[iid] = np.frombuffer(data, np.float32).reshape(rows, cols) if rows else np.zeros((0, cols))
        inliers = {}
        for pid, rows, data in conn.execute("SELECT pair_id, rows, data FROM two_view_geometries"):
            i2 = int(pid) % MAX_IMAGE_ID
            i1 = (int(pid) - i2) // MAX_IMAGE_ID
            m = np.frombuffer(data, np.uint32).reshape(rows, 2) if rows else np.zeros((0, 2), np.uint32)
            inliers[(i1, i2)] = m.astype(np.int64)
    finally:
        conn.close()
    return {"names": names, "keypoints": keypoints, "inliers": inliers}


def check_front(db: dict, truth: list, config: dict, workload: dict) -> dict:
    """The keypoints' and matches' numbers of one job (see the module's
    docstring). `truth` holds each view's world-to-camera (q, t); the
    configuration gives the camera and the least inlier count of a verified
    pair, the workload the tolerances."""
    width, height, focal = config["image_width"], config["image_height"], config["focal_length"]
    min_inliers = config["matching"]["min_num_inliers"]
    transfer_px, epipolar_tol = workload["transfer_px"], workload["epipolar_px"]
    names, kps = db["names"], db["keypoints"]
    views = len(truth)
    by_view = {view_index(n): iid for iid, n in names.items()}
    missing = sum(1 for v in range(views) if v not in by_view or len(kps.get(by_view[v], ())) == 0)
    outside = 0
    for kp in kps.values():
        xy = kp[:, :2]
        outside += int(np.sum(~np.isfinite(xy).all(1) | (xy[:, 0] < 0) | (xy[:, 0] > width)
                              | (xy[:, 1] < 0) | (xy[:, 1] > height)))
    unverified = 0
    for v in range(views - 1):
        a, b = by_view.get(v), by_view.get(v + 1)
        if a is None or b is None or len(db["inliers"].get((min(a, b), max(a, b)), ())) < min_inliers:
            unverified += 1
    checked = wrong = unknown = total = 0
    off_epipolar = np.zeros(len(EPIPOLAR_STEPS), np.int64)
    for (i1, i2), m in db["inliers"].items():
        if len(m) == 0:
            continue
        p1, p2 = truth[view_index(names[i1])], truth[view_index(names[i2])]
        x1, x2 = kps[i1][m[:, 0], :2].astype(np.float64), kps[i2][m[:, 1], :2].astype(np.float64)
        total += len(m)
        dist = epipolar_px(p1, p2, x1, x2, focal, width, height)
        off_epipolar += np.asarray([np.sum(~(dist <= s * epipolar_tol)) for s in EPIPOLAR_STEPS])
        X1, hit1 = surface_points(p1, x1, focal, width, height)
        X2, hit2 = surface_points(p2, x2, focal, width, height)
        err = np.maximum(np.linalg.norm(project(p2, X1, focal, width, height) - x2, axis=1),
                         np.linalg.norm(project(p1, X2, focal, width, height) - x1, axis=1))
        known = hit1 & hit2 & np.isfinite(err)
        checked += int(known.sum())
        unknown += int((~known).sum())
        wrong += int(np.sum(known & (err > transfer_px)))
    return {"images_without_keypoints": missing, "keypoints_outside": outside,
            "neighbours_unverified": unverified, "inliers": total,
            "inliers_off_epipolar": int(off_epipolar[EPIPOLAR_STEPS.index(1)]),
            "inliers_off_epipolar_by_step": {f"x{s:g}": int(n) for s, n in zip(EPIPOLAR_STEPS, off_epipolar)},
            "inliers_checked": checked, "inliers_wrong": wrong, "inliers_off_surface": unknown}


def missing(row: dict) -> int:
    """What never came in one job's front end: images without keypoints,
    keypoints outside their image, neighbours without a verified geometry."""
    return row["images_without_keypoints"] + row["keypoints_outside"] + row["neighbours_unverified"]


def match_numbers(rows: list) -> dict:
    """The inlier matches of all `rows` (check_front's): the share off their
    true epipolar line, and the share that the scene carries elsewhere."""
    checked = sum(p["inliers_checked"] for p in rows)
    total = sum(p["inliers"] for p in rows)
    return {"wrong_match_pct": 100.0 * sum(p["inliers_wrong"] for p in rows) / max(checked, 1),
            "off_epipolar_pct": 100.0 * sum(p["inliers_off_epipolar"] for p in rows) / max(total, 1)}


def check_model(model: dict, truth: list, pose_tolerance_mm: float) -> dict:
    """The model's numbers of one job: ATE, the worst camera-centre error and
    scale error against the truth, the registered images whose centre lies
    more than `pose_tolerance_mm` from the truth, points' distance to the
    corridor, reprojection, and the views it did not register."""
    poses = {view_index(n): p for n, p in model["poses"].items()}
    views = sorted(v for v in poses if v < len(truth))
    out = {"unregistered": len(truth) - len(views)}
    if not views:
        return {**out, "ate_mm": float("inf"), "worst_mm": float("inf"), "images_off": 0,
                "scale_err_pct": float("inf"), "plane_mm": float("inf"), "reproj_px": float("inf")}
    est = np.asarray([center(*poses[v]) for v in views])
    gt = np.asarray([center(*truth[v]) for v in views])
    err_mm = np.linalg.norm(est - gt, axis=1) * 1e3
    out["ate_mm"] = float(np.sqrt(np.mean(err_mm ** 2)))
    out["worst_mm"] = float(err_mm.max())
    out["images_off"] = int(np.sum(~(err_mm <= pose_tolerance_mm)))
    d_gt = np.linalg.norm(gt[-1] - gt[0])
    out["scale_err_pct"] = (float(abs(np.linalg.norm(est[-1] - est[0]) - d_gt) / d_gt) * 100
                            if len(views) > 1 else float("inf"))
    X = model["points"]
    if len(X):
        dist = np.min(np.stack([np.abs(X[:, 0] + WALL_X), np.abs(X[:, 0] - WALL_X), np.abs(X[:, 1] - GROUND_Y)]), 0)
        out["plane_mm"] = float(np.median(dist)) * 1e3
    else:
        out["plane_mm"] = float("inf")
    errs = []
    names = np.asarray(model["obs_image"])
    for name in set(model["obs_image"]):
        sel = names == name
        model_id, params = model["cameras"][model["camera_of"][name]]
        fx, fy, cx, cy = params[:4]
        q, t = model["poses"][name]
        Xc = X[model["obs_point"][sel]] @ _rotmat(q).T + t
        uv = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx, fy * Xc[:, 1] / Xc[:, 2] + cy], -1)
        errs.append(np.linalg.norm(uv - model["obs_xy"][sel], axis=1))
    out["reproj_px"] = float(np.median(np.concatenate(errs))) if errs else float("inf")
    return out
