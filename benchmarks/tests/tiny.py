"""A cell cut to a size the CPU runs in seconds, for the benchmark's tests:
320x240 views at f = 250, 1024 features, 3 octaves, 6-view jobs, one
rendered world, and a window so short that it holds the first job alone
(which always runs to its end). Its limits are the tests' own: the cell's
limits hold the full size on the card, and a CPU run at this size reads
other numbers (`LIMITS`, set from CPU runs of the sound program and of its
control at this size; the first job's lateness is the CPU's pace, and is
not compared here)."""

from __future__ import annotations

from benchmarks import harness, run

SEED = 12345678901
LIMITS = {
    "pipeline": {"plane_mm": 1.0, "off_epipolar_pct": 2.0, "missing": 0.0, "images_off": 0.0},
    "frontend": {"off_epipolar_pct": 2.0, "missing": 0.0},
}


def cell(name: str, **workload) -> harness.Cell:
    """The cell `name` cut to the tests' size; `workload` overrides keys of
    its workload file (a front end, say)."""
    c = harness.load_cell(name)
    c.config.update(image_width=320, image_height=240, focal_length=250.0, max_num_features=1024, num_octaves=3)
    # 6 views at a quarter of the pixels place a camera some 0.2 m off at worst
    c.config["guarantees"] = dict(c.config["guarantees"], pose_tolerance_mm=500.0)
    c.workload.update(views=6, warm_views=4, jobs_rendered=1, limits=dict(LIMITS[c.workload["job"]]), **workload)
    return c


def execute(name: str, seconds: float = 0.001, trace: bool = False, control: str | None = None, seed: int = SEED,
            **workload) -> dict:
    return run.execute(cell(name, **workload), seed, seconds, trace, "cpu", control)
