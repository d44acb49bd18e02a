"""Job kind `frontend_hq`: one capture through the front end at COLMAP's
high-quality preset.

As `frontend`: run_feature_extractor into a fresh database, then
run_sequential_matcher, no mapper, each job run to its end; but the
extraction takes the configuration's `estimate_affine_shape` too, and the
matching its `guided_matching`. Judged on its keypoints and inlier matches
as a `frontend` job (reference/check.py), and on its guided re-match:
GUIDED_PAIRS seeded pairs of each job that have an F and at least
min_num_inliers inliers, their keypoints, uint8 descriptors, F, raw and
written inlier matches read from the job's database, held to the float64
guided matcher of reference/guided.py under the replacement rule
(`guided_mismatch_pct`: the decided rows on which they differ, of the
decided rows matched by either; the reference's margins are stated there).
A control's `reference` group sets the reference's similarity dtype.
"""

from __future__ import annotations

import os
import sqlite3
import time

import numpy as np

from benchmarks.harness import SIFT_KEYS
from benchmarks.reference import check as reference
from benchmarks.reference import guided as guided_reference

GUIDED_PAIRS = 16
SEED = 2215


def run(ctx) -> dict:
    from colmap_pcd_tpu_torch.models.database import Database
    from colmap_pcd_tpu_torch.models.feature_pipeline import (
        ImageReaderConfig,
        run_feature_extractor,
        run_sequential_matcher,
    )
    from colmap_pcd_tpu_torch.utils.config import SiftExtractionConfig, SiftMatchingConfig

    cfg = ctx.cell.config
    extraction = SiftExtractionConfig(**{k: cfg[k] for k in SIFT_KEYS},
                                      estimate_affine_shape=cfg["estimate_affine_shape"])
    matching = ctx.options("matching", SiftMatchingConfig(**cfg["matching"]))
    database = os.path.join(ctx.work_dir, "database.db")
    control = ctx.cell.workload["controls"][ctx.control] if ctx.control else {}
    record = {"index": ctx.index, "views": ctx.views, "database": database, "stopped": False,
              "device": str(ctx.device), "reference": dict(control.get("reference", {})),
              "t_start": time.perf_counter()}
    with ctx.spans.span("extract"):
        t0 = time.perf_counter()
        run_feature_extractor(database, ctx.image_dir, extraction, ImageReaderConfig(), device=ctx.device)
        record["extract_s"] = time.perf_counter() - t0
    with ctx.spans.span("match"):
        t0 = time.perf_counter()
        record["pairs_verified"] = run_sequential_matcher(database, matching, **cfg["sequential_matching"],
                                                          device=ctx.device)
        record["match_s"] = time.perf_counter() - t0
    db = Database(database)
    try:
        record["pairs_matched"] = db.conn.execute("SELECT COUNT(*) FROM matches").fetchone()[0]
    finally:
        db.close()
    record["t_end"] = time.perf_counter()
    return record


def _pairs(conn, table: str) -> dict:
    """{(image_id1, image_id2): [M, 2] int64} of a matches table."""
    out = {}
    for pid, rows, data in conn.execute(f"SELECT pair_id, rows, data FROM {table}"):
        i2 = int(pid) % reference.MAX_IMAGE_ID
        i1 = (int(pid) - i2) // reference.MAX_IMAGE_ID
        out[(i1, i2)] = (np.frombuffer(data, np.uint32).reshape(rows, 2).astype(np.int64) if rows
                         else np.zeros((0, 2), np.int64))
    return out


def _blob(conn, table: str, iid: int, dtype) -> np.ndarray:
    rows, cols, data = conn.execute(f"SELECT rows, cols, data FROM {table} WHERE image_id = ?", (iid,)).fetchone()
    return np.frombuffer(data, dtype).reshape(rows, cols).copy() if rows else np.zeros((0, cols), dtype)


def check_guided(r: dict, config: dict) -> dict:
    """The guided comparison of one job (see the module's docstring)."""
    import torch

    m = config["matching"]
    dtype = getattr(torch, r["reference"].get("dtype", "float64"))
    conn = sqlite3.connect(f"file:{r['database']}?mode=ro", uri=True)
    try:
        written, raw = _pairs(conn, "two_view_geometries"), _pairs(conn, "matches")
        Fs = {}
        for pid, F in conn.execute("SELECT pair_id, F FROM two_view_geometries"):
            i2 = int(pid) % reference.MAX_IMAGE_ID
            Fs[((int(pid) - i2) // reference.MAX_IMAGE_ID, i2)] = np.frombuffer(F, np.float64).reshape(3, 3).copy()
        # the pairs the matcher re-matched: an F and at least the least count
        # of inliers (a guided re-match only adds to a pair that had them)
        candidates = sorted(p for p, F in Fs.items() if np.any(F) and len(written[p]) >= m["min_num_inliers"])
        rng = np.random.default_rng([SEED, r["world"], r["index"]])
        chosen = [candidates[k] for k in sorted(rng.choice(len(candidates), min(GUIDED_PAIRS, len(candidates)),
                                                           replace=False))]
        row = {"guided_checked": len(chosen), "guided_held": 0, "guided_mismatched": 0, "guided_kept": 0}
        for i1, i2 in chosen:
            # keypoints in the frame of the stored F, the program's array
            # coordinates: COLMAP's stored pixel-centre coordinates less 0.5
            kp1, kp2 = (_blob(conn, "keypoints", i, np.float32)[:, :2] - np.float32(0.5) for i in (i1, i2))
            d1, d2 = (_blob(conn, "descriptors", i, np.uint8) for i in (i1, i2))
            ref = guided_reference.guided_matches(
                d1, d2, kp1, kp2, Fs[(i1, i2)], m["max_error"], m["max_ratio"], m["max_distance"],
                m["cross_check"], sim_dtype=dtype, device=r["device"])
            out = guided_reference.compare(ref["match"], ref["decided"], written[(i1, i2)],
                                           raw.get((i1, i2), np.zeros((0, 2), np.int64)))
            row["guided_held"] += out["held"]
            row["guided_mismatched"] += out["mismatched"]
            row["guided_kept"] += out["kept"]
    finally:
        conn.close()
    return row


def judge(cell, jobs: list, truths: dict, deadline: float) -> dict:
    """`frontend`'s numbers over every job of the window, and the guided
    comparison's `guided_mismatch_pct`; beside them the pairs checked, the
    decided rows held and the pairs that kept their verified inliers."""
    rows = []
    for r in jobs:
        row = reference.check_front(reference.read_database(r["database"]), truths[r["index"]], cell.config,
                                    cell.workload)
        row.update(check_guided(r, cell.config))
        rows.append(row)
    numbers = reference.match_numbers(rows)
    numbers["missing"] = float(sum(reference.missing(p) for p in rows))
    held = sum(p["guided_held"] for p in rows)
    numbers["guided_mismatch_pct"] = 100.0 * sum(p["guided_mismatched"] for p in rows) / held if held else float("inf")
    numbers["guided_held"] = float(held)
    numbers["guided_pairs_checked"] = float(sum(p["guided_checked"] for p in rows))
    numbers["guided_pairs_kept"] = float(sum(p["guided_kept"] for p in rows))
    return {"numbers": numbers, "per_job": rows, "partial": [], "first_job": {},
            "failed_images": sum(p["images_without_keypoints"] for p in rows)}
