"""The `dense` job kind (benchmarks/jobs/dense.py) and the cell that runs it,
`dense.stereo`, at a size the CPU runs: the manifest sees the cell, its
configuration, its metrics and their readers; a whole run (set-up that maps
every capture, the warm-up densified, one window job, the reference's
judgement, the readers) is correct; the same run with the port's answer
altered where it is produced (the planes, the costs, fusion's mask, the
undistorted views) is not; the readers give back what a traced run
on the card printed (fixtures/record_dense_stereo_traced.json, written by
`run.py --dump` on an NVIDIA H100 80GB HBM3 at 700 W) and nothing where a
record holds nothing to read.

The cut (`cell`): tiny.py's 320x240 views at f = 250, 1024 features and 3
octaves, 4-view jobs with a 3-view warm-up and 16 planes; the widths of
the configuration (the whole view, r = 5, every covisible source) stand.
Its limits are this file's, set from CPU runs of the sound program at this
size (LIMITS); the first job's lateness is the CPU's pace and is not
compared."""

import json
import os

import numpy as np
import pytest
import torch

from benchmarks import harness, run, stereo_roofline
from benchmarks.tests import tiny

CELL = "dense.stereo"
METRICS = {"stereo.sweep_s_per_image", "stereo.host_s_per_image", "fusion.s_per_image", "device.idle_pct.dense",
           "stereo.roofline_pct"}
DEVICE_METRICS = {"device.idle_pct.dense", "stereo.roofline_pct"}
LIMITS = {"ref_mismatch_pct": 1.0, "ref_cost_err": 1e-3, "fused_count_pct": 0.1, "fused_plane_mm": 150.0,
          "missing": 0.0, "pose_err_mm": 500.0, "undistort_grey": 1.0}
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "record_dense_stereo_traced.json")
# what that run printed (seed 6018000101)
PRINTED = {"stereo.sweep_s_per_image": 3.2071645859, "stereo.host_s_per_image": 0.33604462310000005,
           "fusion.s_per_image": 0.3790666272999985, "device.idle_pct.dense": 27.293437036780876,
           "stereo.roofline_pct": 0.3049983409075801, "images_per_s": 10 / 43.193160107}


def cell() -> harness.Cell:
    c = harness.load_cell(CELL)
    c.config.update(image_width=320, image_height=240, focal_length=250.0, max_num_features=1024, num_octaves=3)
    c.config["guarantees"] = dict(c.config["guarantees"], pose_tolerance_mm=500.0)
    c.config["dense"] = dict(c.config["dense"], num_depths=16)
    c.workload.update(views=4, warm_views=3, jobs_rendered=1, limits=dict(LIMITS))
    return c


def test_manifest_has_the_cell_and_its_metrics():
    manifest = harness.load_json(harness.ROOT + "/BENCHMARK.json")
    c = harness.load_cell(CELL)
    assert c.entry["chips"] == 1 and c.config["name"] == "corridor_dense" and c.workload["job"] == "dense"
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "images_per_s"}
    assert {m["name"] for m in c.per_layer} == METRICS
    assert all(m["moves"] == "images_per_s" and m["workloads"] == [CELL] for m in c.per_layer)
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.metric_reader(m["name"]).read)
    # the configuration states COLMAP's widths; the control coarsens the bank alone
    dense, fixed = c.config["dense"], c.config["dense_fixed"]
    assert (dense["max_image_size"], dense["window_radius"], dense["num_src_images"], dense["sigma_color"],
            dense["geom_consistency"], dense["min_consistent"]) == (-1, 5, 20, 0.2, True, 2)
    assert fixed == {"geom_regularizer": 0.3, "geom_max_cost": 3.0, "min_ncc": 0.1, "max_depth_error": 0.01,
                     "top_k": 2}
    assert c.workload["controls"] == {"coarse_bank": {"dense": {"num_depths": 8}}}
    assert set(c.workload["limits"]) == set(LIMITS) | {"first_job_late"}
    assert c.workload["limits"]["pose_err_mm"] == c.config["guarantees"]["pose_tolerance_mm"]
    assert manifest["workloads"][-1]["name"] == CELL


@pytest.fixture(scope="module")
def sound():
    torch.set_num_threads(2)
    return run.execute(cell(), tiny.SEED, 0.001, True, "cpu")


def test_rehearsal(sound):
    line = sound
    assert line["correct"], line["check"]
    printed = json.loads(run.result_line(line))
    assert set(printed["check"]) == set(LIMITS) and printed["attempted"] == 4 and printed["failed"] == 0
    numbers = line["_judged"]["numbers"]
    assert numbers["ref_mismatch_pct"] <= LIMITS["ref_mismatch_pct"] and numbers["missing"] == 0
    assert numbers["half_mismatch_pct"] > 10 * max(numbers["ref_mismatch_pct"], 0.1)
    record = line["_record"]
    assert record["registered"] == 4 and record["jobs"][0]["fused_points"] > 0
    counts = record["phases"]["counts"]
    assert counts["stereo_view_passes"] == 8 and counts["stereo_hyp_geom"] * 2 == counts["stereo_hyp"]
    assert counts["stereo_tap_hyp"] == 121 * counts["stereo_hyp"] and stereo_roofline.least_s(counts) > 0
    # a CPU run writes no device metric: the readers find no device time
    assert set(printed["metrics"]) == METRICS - DEVICE_METRICS
    assert printed["device"]["platform"] == "cpu" and printed["device"]["busy_s"] == 0


def _plant(monkeypatch, fault: str) -> None:
    """The port's answer altered where it is produced: every depth the
    sweep returns moved to its neighbouring plane of the bank (`planes`),
    every cost it returns raised by 0.01 (`costs`), every tenth pixel that
    fusion's consistency mask keeps dropped (`fusion`), the undistorted
    views shifted by a pixel (`undistorter`)."""
    from colmap_pcd_tpu_torch.models import undistortion
    from colmap_pcd_tpu_torch.ops import stereo

    sweep, mask, undistort = stereo.plane_sweep, stereo.consistency_mask, undistortion.undistort_image

    def shifted_planes(ref, srcs, K_ref, K_srcs, R_rel, t_rel, depths, *args, **kw):
        depth, cost, normal = sweep(ref, srcs, K_ref, K_srcs, R_rel, t_rel, depths, *args, **kw)
        index = torch.argmin(torch.abs(depth[..., None] - depths), -1)
        return depths[(index + 1) % len(depths)], cost, normal

    def raised_costs(*args, **kw):
        depth, cost, normal = sweep(*args, **kw)
        return depth, cost + 0.01, normal

    def thinned(*args):
        kept = mask(*args)
        return kept & (torch.arange(kept.numel()).reshape(kept.shape) % 10 != 0)

    def shifted_views(*args, **kw):
        return np.roll(undistort(*args, **kw), 1, axis=1)

    if fault == "planes":
        monkeypatch.setattr(stereo, "plane_sweep", shifted_planes)
    elif fault == "costs":
        monkeypatch.setattr(stereo, "plane_sweep", raised_costs)
    elif fault == "fusion":
        monkeypatch.setattr(stereo, "consistency_mask", thinned)
    else:
        monkeypatch.setattr(undistortion, "undistort_image", shifted_views)


# each fault and the number that tells it, at least how far past its limit
FAULTS = {"planes": ("ref_mismatch_pct", 50.0), "costs": ("ref_cost_err", 5e-3), "fusion": ("fused_count_pct", 5.0),
          "undistorter": ("undistort_grey", 10.0)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_altered_answer_is_not_correct(monkeypatch, fault):
    """Each planted fault comes out not correct, told apart by its number."""
    _plant(monkeypatch, fault)
    line = run.execute(cell(), tiny.SEED, 0.001, False, "cpu")
    assert not line["correct"], line["check"]
    number, least = FAULTS[fault]
    assert line["check"][number][0] > least, line["check"]


def test_readers_without_their_records(sound):
    record = json.loads(json.dumps(sound["_record"], default=float))
    record["phases"] = {"totals": {}, "counts": {}}
    record["trace"] = None
    for name in METRICS - {"fusion.s_per_image"}:
        assert harness.metric_reader(name).read(record) is None, name
    record["jobs"] = [{k: v for k, v in j.items() if k != "fusion_s"} for j in record["jobs"]]
    assert harness.metric_reader("fusion.s_per_image").read(record) is None


@pytest.mark.parametrize("metric", sorted(PRINTED))
def test_readers_give_back_the_card_run(metric):
    with open(FIXTURE) as f:
        record = json.load(f)
    assert harness.metric_reader(metric).read(record) == pytest.approx(PRINTED[metric], rel=1e-12)
    assert 0 < harness.metric_reader("stereo.roofline_pct").read(record) <= 100
