"""PHASES, the port's one trace (CPU): spans nest per thread and are kept
as intervals only while recording; counters are exact under threads; a
span closes however its block is left; the front end's layers open
their spans where their work happens; and the triangulator's screens count
what they scan and flag."""

import threading
import time

import numpy as np
import pytest
import torch

import synthetic_torch
from benchmarks import spans as span_mod
from colmap_pcd_tpu_torch.models import controllers, incremental_mapper, triangulator
from colmap_pcd_tpu_torch.models import feature_pipeline as fp_t
from colmap_pcd_tpu_torch.utils.config import SiftExtractionConfig, SiftMatchingConfig
from colmap_pcd_tpu_torch.utils.logging_utils import PHASES, PhaseTimer

from test_sift import make_texture
from test_torch_track_screen import NEW_IMAGE, whole_tracks_world

torch.set_num_threads(1)  # the suite runs several workers on few cores


def _table(spans):
    """benchmarks/spans.py's table of recorded spans, without a device."""
    return span_mod.span_table([list(s) for s in spans], [], 0, 2**62)


def test_nested_spans_parents_and_self_times():
    pt = PhaseTimer()
    pt.start_recording()
    before = time.perf_counter_ns()
    with pt.phase("outer"):
        time.sleep(0.02)
        with pt.phase("inner"):
            time.sleep(0.03)
            with pt.phase("leaf"):
                time.sleep(0.01)
        with pt.phase("inner"):
            pass
    after = time.perf_counter_ns()
    spans = pt.stop_recording()
    assert [(s[0], s[3]) for s in spans] == [("outer", -1), ("inner", 0), ("leaf", 1), ("inner", 0)]
    assert all(before <= s[1] <= s[2] <= after for s in spans)  # the perf_counter clock
    for name, start, end, parent, thread in spans:
        assert thread == threading.get_ident()
        if parent >= 0:
            assert spans[parent][1] <= start <= end <= spans[parent][2]
    table = _table(spans)
    assert table["inner"]["count"] == 2 and table["leaf"]["count"] == 1
    leaf = spans[2][2] - spans[2][1]
    assert table["inner"]["self_s"] == pytest.approx(table["inner"]["total_s"] - leaf * 1e-9)
    assert table["outer"]["self_s"] == pytest.approx(table["outer"]["total_s"] - table["inner"]["total_s"])
    assert 0.02 <= table["outer"]["self_s"] < table["outer"]["total_s"]
    assert pt.counts == {"outer": 1, "inner": 2, "leaf": 1}
    assert pt.totals["outer"] == pytest.approx(table["outer"]["total_s"])


def test_threads_keep_separate_stacks():
    pt = PhaseTimer()
    pt.start_recording()
    barrier = threading.Barrier(4)

    def work(k):
        with pt.phase(f"outer{k}"):
            barrier.wait()
            with pt.phase(f"inner{k}"):
                barrier.wait()
            barrier.wait()

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = pt.stop_recording()
    assert len(spans) == 8
    by_name = {s[0]: (k, s) for k, s in enumerate(spans)}
    for k in range(4):
        outer_index, outer = by_name[f"outer{k}"]
        _, inner = by_name[f"inner{k}"]
        assert outer[3] == -1 and inner[3] == outer_index and inner[4] == outer[4]
    assert len({s[4] for s in spans}) == 4
    # every open span overlapped the other threads' spans, which a single stack would have taken as parents
    assert span_mod.open_at([list(s) for s in spans], by_name["inner0"][1][1]) != []


def test_counters_are_exact_under_threads():
    pt = PhaseTimer()

    def work():
        for _ in range(10_000):
            pt.count("n")
        for _ in range(500):
            with pt.phase("s"):
                pass

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert pt.counts["n"] == 80_000 and pt.counts["s"] == 4_000
    assert "n" not in pt.totals  # a counter has no seconds
    pt.count("bytes", 4096)
    assert pt.counts["bytes"] == 4096


def test_spans_close_on_exception_and_early_return():
    pt = PhaseTimer()
    pt.start_recording()

    def leaves_early():
        with pt.phase("early"):
            return 1

    with pytest.raises(ValueError):
        with pt.phase("raises"):
            raise ValueError("x")
    assert leaves_early() == 1
    with pt.phase("after"):
        pass
    spans = pt.stop_recording()
    assert [(s[0], s[3]) for s in spans] == [("raises", -1), ("early", -1), ("after", -1)]
    assert pt.counts == {"raises": 1, "early": 1, "after": 1}
    assert pt._local.stack == []


def test_recording_off_keeps_no_intervals_and_the_same_totals():
    def calls(pt):
        for _ in range(3):
            with pt.phase("a"):
                with pt.phase("b"):
                    pt.count("c", 2)

    off, on = PhaseTimer(), PhaseTimer()
    calls(off)
    assert off.stop_recording() == [] and off._recorded is None
    on.start_recording()
    calls(on)
    assert len(on.stop_recording()) == 6
    assert off.counts == on.counts == {"a": 3, "b": 3, "c": 6}
    assert set(off.totals) == set(on.totals) == {"a", "b"}
    # a span left open when recording stops is left out, and its parent link does not leak into the next recording
    on.start_recording()
    with on.phase("open"):
        first = on.stop_recording()
        on.start_recording()
        with on.phase("child"):
            pass
    assert first == [] and [(s[0], s[3]) for s in on.stop_recording()] == [("child", -1)]
    on.reset()
    assert on.totals == {} and on.counts == {}


def test_report_lists_counters_apart():
    pt = PhaseTimer()
    with pt.phase("span_a"):
        pass
    pt.count("counter_b", 7)
    lines = pt.report().splitlines()
    assert lines[0].startswith("  span_a") and lines[0].rstrip().endswith("s  x1")
    assert lines[1] == "  counters:"
    assert lines[2].split() == ["counter_b", "7"]
    assert "0.000s" not in "\n".join(lines[1:])


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    from PIL import Image as PILImage

    big = make_texture(np.random.default_rng(3), H=420, W=640, n_blobs=400)
    d = tmp_path_factory.mktemp("imgs")
    for i in range(4):
        crop = big[i * 40 : i * 40 + 256, i * 60 : i * 60 + 256]
        PILImage.fromarray((crop * 255).astype(np.uint8)).save(d / f"im{i:02d}.png")
    return str(d)


FRONT_SPANS = {
    "extract.read", "extract.device", "sift.detect", "sift.describe", "extract.write",
    "match.prep", "match.k1", "match.assemble", "two_view.verify", "two_view.classify", "match.write",
}


def test_front_end_spans_where_the_work_happens(image_dir, tmp_path):
    """The extractor and the sequential matcher open their layers' spans on
    the threads that do the work: SIFT's stages inside the device stage,
    the reads on the IO threads, K1 and the banks on the matcher's pool."""
    dbp = str(tmp_path / "t.db")
    PHASES.start_recording()
    try:
        fp_t.run_feature_extractor(dbp, image_dir, SiftExtractionConfig(
            max_num_features=512, first_octave=0, num_octaves=3, max_image_size=512), device="cpu")
        fp_t.run_sequential_matcher(dbp, SiftMatchingConfig(min_num_inliers=10), overlap=2,
                                    quadratic_overlap=False, device="cpu")
    finally:
        spans = PHASES.stop_recording()
    names = {s[0] for s in spans}
    assert FRONT_SPANS <= names, FRONT_SPANS - names
    caller = threading.get_ident()
    for name, start, end, parent, thread in spans:
        if name in ("sift.detect", "sift.describe"):
            assert spans[parent][0] == "extract.device"
        if parent >= 0:
            assert spans[parent][4] == thread and spans[parent][1] <= start <= end <= spans[parent][2]
        if name in ("extract.device", "match.prep", "match.write"):
            assert thread == caller, name
        if name in ("extract.read", "extract.write", "match.k1", "two_view.verify"):
            assert thread != caller, name


def _screen_counts():
    return PHASES.counts.get("track_screen_pts", 0), PHASES.counts.get("track_screen_flagged", 0)


def test_track_screen_counters():
    """The triangulator's screens count the points (or features) they scan
    and those they flag for the walks: after the local refinements of a
    mapping on the synthetic world both counters are in the report, with
    flagged <= scanned; on whole tracks (each feature in its world point's
    track) nothing can be merged or completed and nothing is flagged."""
    rec, graph, lmap, gt = synthetic_torch.make_world(
        np.random.default_rng(7), n_images=5, n_points=300, noise_px=0.5
    )
    ctl = controllers.IncrementalMapperController(
        rec, graph,
        incremental_mapper.MapperOptions(
            if_add_lidar_constraint=True, init_image_id1=1, init_image_id2=2,
            abs_pose_min_num_inliers=15, init_min_num_inliers=50, num_ransac_hypotheses=1024,
        ),
        controllers.ControllerOptions(verbose=False), lidar_map=lmap, pose_priors={1: gt[0]},
    )
    pts0, flagged0 = _screen_counts()
    refinements0 = PHASES.counts.get("track_merge_complete", 0)
    assert ctl.reconstruct()
    pts, flagged = _screen_counts()
    assert PHASES.counts["track_merge_complete"] > refinements0
    assert 0 <= flagged - flagged0 <= pts - pts0 and pts > pts0
    report = PHASES.report()
    assert "track_screen_pts" in report and "track_screen_flagged" in report

    rec, graph = whole_tracks_world(5)
    tri = triangulator.IncrementalTriangulator(rec, graph)
    opts = triangulator.TriangulatorOptions()
    ids = list(rec.points3D)
    free = int(np.sum(rec.images[NEW_IMAGE].point3D_ids == triangulator.INVALID_POINT3D))
    pts0, flagged0 = _screen_counts()
    assert tri.merge_tracks(opts, ids) == tri.complete_tracks(opts, ids) == 0
    assert tri.complete_image(opts, NEW_IMAGE) == 0
    pts, flagged = _screen_counts()
    assert pts - pts0 == 2 * len(ids) + free and flagged == flagged0


def test_dense_spans_and_counters(tmp_path):
    """The dense stage opens its layers' spans (a view's problem, each
    view-pass's sweep through its fetch, the writes; fusion's mask through
    its fetch and the points) and counts the sweeps' work: view-passes,
    the H*W*S*D hypotheses of both passes, those times the window's taps,
    the geometric pass's hypotheses and the bytes read and written once."""
    from colmap_pcd_tpu_torch.models import mvs
    from colmap_pcd_tpu_torch.models.reconstruction import Camera, Image, Reconstruction
    from test_stereo import F, H, W, render_plane

    centers = [np.zeros(3), np.asarray([0.35, 0.0, 0.0]), np.asarray([0.0, 0.3, 0.0])]
    rec = Reconstruction()
    rec.add_camera(Camera(1, 1, W, H, np.asarray([F, F, W / 2, H / 2])))
    images = {}
    for i, c in enumerate(centers, 1):
        rec.add_image(Image(i, f"v{i}.png", 1, qvec=np.asarray([1.0, 0, 0, 0]), tvec=-c, xys=np.zeros((4, 2))))
        rec.register_image(i)
        images[i] = render_plane(c, 10.0)
    for k in range(4):
        rec.add_point3D(np.asarray([(k % 2 - 0.5) * 2.0, (k // 2 - 0.5) * 1.5, 10.0]), [(1, k), (2, k), (3, k)])
    opts = mvs.DenseOptions(max_image_size=-1, num_depths=8, window_radius=2)
    counters = ("stereo_view_passes", "stereo_hyp", "stereo_tap_hyp", "stereo_hyp_geom", "stereo_bytes")
    before = {k: PHASES.counts.get(k, 0) for k in counters}
    PHASES.start_recording()
    try:
        mvs.run_patch_match_stereo(str(tmp_path), opts, rec=rec, images=images, device="cpu")
        mvs.run_stereo_fusion(str(tmp_path), options=opts, rec=rec, images=images, device="cpu")
    finally:
        spans = PHASES.stop_recording()
    table = _table(spans)
    assert {k: table[k]["count"] for k in ("stereo.problem", "stereo.sweep", "stereo.write", "stereo_fetch",
                                           "fusion.mask", "fusion_fetch")} == {
        "stereo.problem": 3, "stereo.sweep": 6, "stereo.write": 6, "stereo_fetch": 6, "fusion.mask": 3,
        "fusion_fetch": 3}
    assert table["fusion.points"]["count"] == 4  # each view's points, then the PLY
    for name, start, end, parent, thread in spans:
        if name in ("stereo_fetch", "fusion_fetch"):
            assert spans[parent][0] == {"stereo_fetch": "stereo.sweep", "fusion_fetch": "fusion.mask"}[name]
    added = {k: PHASES.counts.get(k, 0) - before[k] for k in counters}
    hyp = H * W * 2 * 8  # two sources, eight depths a view
    assert added == {"stereo_view_passes": 6, "stereo_hyp": 6 * hyp, "stereo_tap_hyp": 6 * hyp * 25,
                     "stereo_hyp_geom": 3 * hyp, "stereo_bytes": 4 * H * W * (3 * (1 + 2) + 3 * (1 + 4) + 6 * 5)}
