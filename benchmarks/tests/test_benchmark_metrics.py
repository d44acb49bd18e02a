"""Each metric reader on records of traced runs on the card (fixtures/,
written by `run.py --dump` on an NVIDIA H100 80GB HBM3 at 700 W): the
reader gives back what that run printed; it gives nothing where the record
holds nothing to read. And the trace's arithmetic on hand-made events."""

import json
import os

import pytest

from benchmarks import harness, trace

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
EXPECTED = json.load(open(os.path.join(FIXTURES, "expected_metrics.json")))
CASES = [(f, name, value) for f, metrics in EXPECTED.items() for name, value in metrics.items()
         if not name.startswith("_")]


def _record(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("fixture,metric,value", CASES)
def test_reader_gives_back_the_run(fixture, metric, value):
    assert harness.metric_reader(metric).read(_record(fixture)) == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize("fixture", sorted(EXPECTED))
def test_end_to_end_readers(fixture):
    rec = _record(fixture)
    assert harness.metric_reader("setup_s").read(rec) == rec["setup_s"] > 0
    if "frontend" in fixture or "front25" in fixture:
        views = sum(j["views"] for j in rec["jobs"])
        assert harness.metric_reader("frontend_images_per_s").read(rec) == pytest.approx(views / rec["window_s"])
    else:
        assert harness.metric_reader("images_per_s").read(rec) == rec["registered"] / rec["window_s"]
        assert harness.metric_reader("ate_mm").read(rec) == rec["check"]["first_job"]["ate_mm"]


@pytest.mark.parametrize("metric", ["k2.roofline_pct", "k1u8.roofline_pct", "device.idle_pct.map",
                                    "device.idle_pct.front"])
def test_device_readers_without_a_trace(metric):
    rec = _record("record_ref_capture8_seq_traced.json")
    rec["trace"] = None
    assert harness.metric_reader(metric).read(rec) is None
    rec = _record("record_ref_front25_default_traced.json")
    rec["trace"].update(busy_s=0.0, kernel_s={})
    assert harness.metric_reader(metric).read(rec) is None


def test_rooflines_stay_under_100():
    for fixture, metrics in EXPECTED.items():
        for name, value in metrics.items():
            if name.endswith("roofline_pct"):
                assert 0 < value <= 100


def test_summarize():
    spans = harness.Spans()
    spans.epoch_offset_ns = 0
    spans.items = [["job0", 0.0, 10.0, -1], ["map", 1.0, 9.0, 0]]
    s = 1_000_000_000
    events = [("k_a", 0, 2 * s), ("k_b", s, 3 * s), ("k_a", 5 * s, 6 * s), ("k_c", 11 * s, 12 * s)]
    out = trace.summarize(events, 0, 10 * s, spans)
    assert out["busy_s"] == pytest.approx(4.0) and out["window_s"] == pytest.approx(10.0)
    assert out["kernel_s"] == pytest.approx({"k_a": 3.0, "k_b": 2.0})
    assert out["idle_gaps"] == [["map", pytest.approx(4.0)], ["map", pytest.approx(2.0)]]
    assert out["device_ops"][0] == ["k_a", pytest.approx(3.0)]
