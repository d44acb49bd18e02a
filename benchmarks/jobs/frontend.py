"""Job kind `frontend`: one capture through the front end alone.

run_feature_extractor into a fresh database, then run_sequential_matcher
with the configuration's sequential-matching and matching options. No
mapper. A front-end job runs to its end once started: the harness starts
none after the deadline. Judged on its keypoints and inlier matches.
"""

from __future__ import annotations

import os
import time

from benchmarks.harness import SIFT_KEYS
from benchmarks.reference import check as reference


def run(ctx) -> dict:
    from colmap_pcd_tpu_torch.models.database import Database
    from colmap_pcd_tpu_torch.models.feature_pipeline import (
        ImageReaderConfig,
        run_feature_extractor,
        run_sequential_matcher,
    )
    from colmap_pcd_tpu_torch.utils.config import SiftExtractionConfig, SiftMatchingConfig

    cfg = ctx.cell.config
    extraction = SiftExtractionConfig(**{k: cfg[k] for k in SIFT_KEYS})
    matching = ctx.options("matching", SiftMatchingConfig(**cfg["matching"]))
    database = os.path.join(ctx.work_dir, "database.db")
    record = {"index": ctx.index, "views": ctx.views, "database": database, "stopped": False,
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


def judge(cell, jobs: list, truths: dict, deadline: float) -> dict:
    """The reference's numbers over every job of the window (each ran to its
    end): the inlier matches against the true geometry, and what never
    came."""
    rows = [reference.check_front(reference.read_database(r["database"]), truths[r["index"]], cell.config,
                                  cell.workload) for r in jobs]
    numbers = reference.match_numbers(rows)
    numbers["missing"] = float(sum(reference.missing(p) for p in rows))
    return {"numbers": numbers, "per_job": rows, "partial": [], "first_job": {},
            "failed_images": sum(p["images_without_keypoints"] for p in rows)}
