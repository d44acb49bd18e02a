"""The program's spans against the device trace (benchmarks/spans.py): the
span table and the idle gaps' labels on hand-made events, the clock that
program spans and profiler events share, a traced CPU rehearsal with the
spans recorded, and every reader on records of traced runs on the card
(fixtures/record_*_spans.json, written by benchmarks/tools/traced_spans.py
on an NVIDIA H100 80GB HBM3 at 700 W)."""

import json
import os

import pytest

from benchmarks import harness, spans, trace
from benchmarks.tests import tiny
from benchmarks.tools import traced_spans
from benchmarks.tools.traced_spans import SPAN_METRICS

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
EXPECTED_PATH = os.path.join(FIXTURES, "expected_metrics_spans.json")
EXPECTED = json.load(open(EXPECTED_PATH)) if os.path.exists(EXPECTED_PATH) else {}
CASES = [(f, name, value) for f, metrics in EXPECTED.items() for name, value in metrics.items()
         if not name.startswith("_")]
S = 1_000_000_000


def _harness_spans():
    h = harness.Spans()
    h.epoch_offset_ns = 0
    h.items = [["job0", 0.0, 10.0, -1], ["map", 1.0, 9.0, 0]]
    return h


# thread 1: outer [0, 8] s holding inner [1, 3] and inner [5, 6]; thread 2: other [2, 7]
PROGRAM = [["outer", 0, 8 * S, -1, 1], ["inner", 1 * S, 3 * S, 0, 1], ["other", 2 * S, 7 * S, -1, 2],
           ["inner", 5 * S, 6 * S, 0, 1]]
# busy [0, 3] and [5, 6] s; a copy at 6.5 s; after the window, [11, 12]
EVENTS = [("k_a", 0, 2 * S), ("k_b", S, 3 * S), ("k_a", 5 * S, 6 * S), ("Memcpy HtoD", 6_500_000_000, 6_600_000_000),
          ("k_c", 11 * S, 12 * S)]


def test_span_table():
    table = spans.span_table(PROGRAM, EVENTS, 0, 10 * S)
    # idle [3, 5], [6, 6.5] and [6.6, 10] s; the copy keeps the card busy and is no kernel
    assert table["outer"] == pytest.approx({"total_s": 8.0, "self_s": 5.0, "count": 1, "idle_s": 3.9, "kernels": 3})
    assert table["inner"] == pytest.approx({"total_s": 3.0, "self_s": 3.0, "count": 2, "idle_s": 0.0, "kernels": 2})
    assert table["other"] == pytest.approx({"total_s": 5.0, "self_s": 5.0, "count": 1, "idle_s": 2.9, "kernels": 1})


def test_in_window_clips_shifts_and_reindexes():
    recorded = [("before", 0, 10, -1, 1), ("outer", 20, 100, -1, 1), ("inner", 30, 40, 1, 1), ("late", 200, 300, -1, 1)]
    assert spans.in_window(recorded, 1025, 1130, 1000) == [["outer", 1025, 1100, -1, 1], ["inner", 1030, 1040, 0, 1]]


def test_idle_gaps_labels_and_coverage():
    gaps = spans.idle_gaps(EVENTS, 0, 10 * S, _harness_spans(), PROGRAM)
    # the gaps as trace.summarize finds them, with the program's innermost spans of each thread
    assert gaps == [["map", pytest.approx(3.4)], ["map/other|outer", pytest.approx(2.0)],
                    ["map/other|outer", pytest.approx(0.5)]]
    assert [g[1] for g in gaps] == pytest.approx([g[1] for g in trace.summarize(EVENTS, 0, 10 * S, _harness_spans())[
        "idle_gaps"]])
    assert spans.label("match", PROGRAM, int(2.5 * S)) == "match/inner|other"
    assert spans.label("match", PROGRAM, 9 * S) == "match"
    assert len(spans.label("x", [[f"name{k}" * 5, 0, S, -1, k] for k in range(20)], 1)) == spans.LABEL_CHARS
    cov = spans.coverage(PROGRAM, EVENTS, 0, 10 * S, _harness_spans())
    assert cov["idle_s"] == pytest.approx(5.9) and cov["covered_share"] == pytest.approx(3.9 / 5.9)
    assert cov["uncovered_s"] == pytest.approx({"map": 2.0})


def test_program_spans_share_the_profilers_clock():
    """Under trace.start on the CPU, a PHASES span around a torch operator
    contains the operator's profiler event once the harness's epoch offset
    is applied."""
    import torch

    from colmap_pcd_tpu_torch.utils.logging_utils import PhaseTimer

    pt = PhaseTimer()
    a = torch.randn(256, 256)
    prof = trace.start(torch.device("cpu"))
    pt.start_recording()
    with pt.phase("op"):
        torch.mm(a, a)
    recorded = pt.stop_recording()
    prof.__exit__(None, None, None)
    offset = harness.Spans().epoch_offset_ns
    (name, start, end, _parent, _thread), = recorded
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    slack = 1_000_000  # the two clocks are read a moment apart
    assert start + offset - slack <= mm[0].start_ns() <= mm[0].start_ns() + mm[0].duration_ns() <= end + offset + slack


def test_traced_rehearsal_with_program_spans():
    """The front cell's traced CPU rehearsal with the program's spans
    recorded (benchmarks/tools/traced_spans.py's run): the three
    program_span metrics are printed, the span table holds the front end's
    spans, and the gaps carry their names."""
    line = traced_spans.execute(tiny.cell("ref.front25.default"), tiny.SEED, 0.001, "cpu")
    held = line["_record"]
    assert line["correct"], line["check"]
    assert {"sift.ms_per_image", "two_view.verify_ms_per_pair", "match.host_ms_per_pair"} <= set(line["metrics"])
    table = held["span_table"]
    for name in ("extract.device", "sift.detect", "match.k1", "two_view.verify", "match.write"):
        assert table[name]["count"] >= 1 and table[name]["self_s"] <= table[name]["total_s"], name
    assert table["extract.device"]["self_s"] < table["extract.device"]["total_s"]  # SIFT's stages inside
    assert 0 < held["coverage"]["covered_share"] <= 1
    labels = [g[0] for g in line["breakdown"]["idle_gaps"]]
    assert any("/" in lab for lab in labels), labels
    assert held["count_calls"] == {} and len(held["program_spans"]) >= 11
    assert not set(SPAN_METRICS) & set(line["metrics"])  # no device time on the CPU: nothing to read


@pytest.mark.parametrize("fixture,metric,value", CASES)
def test_reader_gives_back_the_run(fixture, metric, value):
    with open(os.path.join(FIXTURES, fixture)) as f:
        record = json.load(f)
    assert harness.metric_reader(metric).read(record) == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_readers_without_a_span_table(metric):
    """The records of run.py itself (which keeps no program spans) give
    the span table's readers nothing to read."""
    for fixture in ("record_ref_capture8_seq_traced.json", "record_ref_front25_default_traced.json"):
        with open(os.path.join(FIXTURES, fixture)) as f:
            assert harness.metric_reader(metric).read(json.load(f)) is None
