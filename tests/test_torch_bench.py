"""bench_torch.py, the port's counterpart of bench.py, on the CPU: its world
against bench.py's, its rate arithmetic, error profile and line against
bench.py's (written out here: bench.py computes them inline in `main`),
both branches from pixels to a model, and its refusal to run without a card
unless the CPU is asked for. The slow test runs both scripts end to end."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402  (its top level imports only numpy)
import bench_torch  # noqa: E402
from colmap_pcd_tpu_torch.models.reconstruction import Camera, Image, Reconstruction  # noqa: E402

BENCH_KEYS = bench_torch.bench_py_line_keys()


def test_trajectory_equals_bench_make_gt():
    ours = bench_torch.make_trajectory(450, bench_torch.STEP)
    theirs = bench.make_gt(450, 0.8)
    assert len(ours) == len(theirs) == 450
    for (q, t), (q_ref, t_ref) in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(q), np.asarray(q_ref))
        np.testing.assert_array_equal(np.asarray(t), np.asarray(t_ref))


# (reg_times, n_reg, map_s) -> (steady, first half, sliding-window curve), by
# bench.py:290-308 worked by hand
_RATE_CASES = {
    # fewer than 4 registrations: n_reg / map_s for both, no curve
    "three": ([(2, 1.0), (3, 2.0), (4, 4.0)], 4, 8.0, 0.5, 0.5, []),
    # exactly 4: mid = 2; steady (5-4)/(8-4), first half (4-2)/(4-1);
    # each window starts at k0 = 0
    "four": ([(2, 1.0), (3, 2.0), (4, 4.0), (5, 8.0)], 5, 9.0, 0.25, 2.0 / 3.0, [1.0, 0.667, 0.429]),
}
# 30 registrations, image k + 2 at 0.5 k + 0.01 k^2 seconds: mid = 15; the
# window of 10 slides from k = 10 on
_T30 = [0.5 * k + 0.01 * k * k for k in range(30)]
_RATE_CASES["thirty"] = (
    [(k + 2, _T30[k]) for k in range(30)], 31, 30.0,
    14 / (_T30[29] - _T30[15]), 15 / (_T30[15] - _T30[0]),
    [round(k / _T30[k], 3) for k in range(1, 11)]
    + [round(10 / (_T30[k] - _T30[k - 10]), 3) for k in range(11, 30)],
)


@pytest.mark.parametrize("case", sorted(_RATE_CASES))
def test_rates_follow_bench_py(case):
    reg_times, n_reg, map_s, steady, first, curve = _RATE_CASES[case]
    got = bench_torch.rates(reg_times, n_reg, map_s)
    assert got[0] == pytest.approx(steady, rel=1e-12)
    assert got[1] == pytest.approx(first, rel=1e-12)
    assert got[2] == curve
    if case == "thirty":  # 10 / (0.5 * 10 + 0.01 * (2k - 10) * 10) at k = 20
        assert got[2][19] == round(10 / (5 + 0.1 * 30), 3) == 1.25


def test_error_profile_and_line_follow_bench_py():
    """Three registered images off their true centres by 3, 4 and 12 mm (one
    unregistered), and the line bench.py would print from them."""
    gt = bench_torch.make_trajectory(4, bench_torch.STEP)
    rec = Reconstruction()
    rec.add_camera(Camera(1, 1, 640, 480, np.asarray([500.0, 500.0, 320.0, 240.0])))
    for i, (q, t) in enumerate(gt, start=1):
        rec.add_image(Image(i, f"v{i:04d}.png", 1))
        img = rec.images[i]
        img.qvec, img.tvec = np.asarray(q), np.asarray(t)
        # t = -R c: a centre moved by d along x moves t by -R d
        d = {1: 0.003, 2: 0.004, 4: 0.012}.get(i)
        if d is not None:
            R = bench_torch.np_geom.quat_to_rotmat(q)
            img.tvec = img.tvec - R @ np.asarray([d, 0.0, 0.0])
            img.registered = True
    errs = bench_torch.error_profile(rec, gt)
    assert [i for i, _ in errs] == [1, 2, 4]
    np.testing.assert_allclose([e for _, e in errs], [0.003, 0.004, 0.012], atol=1e-12)
    res = {"n_images": 4, "registered": 3, "ate_m": 0.0075277, "errors": errs,
           "steady_frames_per_s": 0.5, "first_half_fps": 0.25, "rate_curve": [1.0] * 81,
           "extract_seconds": 2.0, "match_seconds": 4.0, "match_busy_seconds": 0.0, "pairs_verified": 6,
           "seconds": 10.004, "wall_seconds": 12.345}
    line = bench_torch.bench_line(res, bench_torch.REF_SCALE, "cpu")
    assert set(line) == BENCH_KEYS - set(bench_torch.DROPPED_KEYS)
    assert line["value"] == 0.5 and line["vs_baseline"] == round(0.5 * 180 / 25, 2) == 3.6
    assert line["ate_m"] == 0.0075
    # p50 4.0, p90 the 0.9 quantile between 4 and 12 mm: 4 + 0.8 * 8
    assert line["ate_profile_mm"] == {"p50": 4.0, "p90": 10.4, "max": 12.0}
    assert line["err_curve_mm"] == [3.0, 4.0, 12.0]
    assert line["reg_s_curve"] == [1.0] * 41  # every 81 // 40 = 2nd
    assert line["extract_img_per_s"] == 2.0
    # no busy time recorded: the busy rate falls back to the wall (bench.py:336-338)
    assert line["match_pairs_per_s"] == line["match_pairs_per_s_busy"] == 1.5
    assert (line["match_wall_s"], line["mapping_wall_s"], line["e2e_wall_s"]) == (4.0, 10.0, 12.35)
    assert line["feature_scale"] == {"max_num_features": 8192, "image_wh": [1280, 960], "ref_scale": True}
    res["errors"] = []
    assert bench_torch.bench_line(res, bench_torch.LIGHT_SCALE, "cpu")["ate_profile_mm"] is None


@pytest.mark.parametrize("overlapped", [True, False], ids=["overlapped", "sequential"])
def test_branch_from_pixels_to_a_model(tmp_path, overlapped):
    """Each of bench.py's branches through bench_torch.run_bench on the CPU: five
    320x240 views (f = 250, 1024 features), at test_pixels_to_model_small's
    bars, and the line built from the run."""
    scale = (320, 240, 250.0, 1024, 3)
    world = bench_torch.render_world(5, str(tmp_path), scale, workers=2)
    res = bench_torch.run_bench(world, str(tmp_path), overlapped=overlapped, device="cpu")
    assert res["registered"] >= 4, res["registered"]
    assert res["ate_m"] < 0.25, f"ATE {res['ate_m']:.3f} m"
    assert res["pairs_verified"] >= 4 and len(res["keypoints"]) == 5
    assert res["peak_mem_bytes"] is None  # no device memory on the CPU
    assert sum(res["launches"].values()) == 0  # the CPU takes the plain versions
    assert 0 < res["seconds"] < res["wall_seconds"]
    line = bench_torch.bench_line(res, scale, "cpu")
    assert set(line) == BENCH_KEYS - set(bench_torch.DROPPED_KEYS)
    assert line["device"] == "cpu" and line["registered"] == res["registered"] and line["n_images"] == 5
    assert line["value"] > 0 and np.isfinite(line["value"])
    json.dumps(line)


def test_main_without_a_card_prints_the_error_line(monkeypatch, capsys):
    monkeypatch.delenv("BENCH_CPU", raising=False)
    monkeypatch.setattr(bench_torch.torch.cuda, "is_available", lambda: False)
    assert bench_torch.main() == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "error"}
    assert line["value"] == 0.0 and line["error"].startswith("device unavailable")


def test_import_never_imports_jax(tmp_path):
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import bench_torch\n"
        "assert not any(m == 'jax' or m == 'colmap_pcd_tpu' or m.startswith(('jax.', 'colmap_pcd_tpu.'))"
        " for m in sys.modules if sys.modules[m] is not None), 'jax imported'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def _script(name, env):
    # from the repo's root: bench.py finds tests/ by a relative path
    proc = subprocess.run([sys.executable, name], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=3000)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    pairs = int(re.search(r"matching(?: thread)?: (\d+) verified pairs", proc.stderr).group(1))
    return line, pairs


@pytest.mark.slow
def test_bench_py_and_bench_torch_agree_on_the_cpu(tmp_path):
    """bench.py and bench_torch.py on six light-scale views on the CPU (JAX's
    compiles make this slow): the same registered count, both ATEs under
    0.10 m, verified pair counts within one pair."""
    env = dict(os.environ, BENCH_CPU="1", BENCH_N_IMAGES="6", BENCH_VERBOSE="0", TMPDIR=str(tmp_path),
               COLMAP_PCD_TPU_CACHE=str(tmp_path / "jax_cache"),
               COLMAP_PCD_TPU_SHAPE_JOURNAL=str(tmp_path / "shape_journal.json"))
    ref, ref_pairs = _script("bench.py", env)
    ours, our_pairs = _script("bench_torch.py", env)
    assert set(ours) == set(ref) - set(bench_torch.DROPPED_KEYS)
    assert ours["registered"] == ref["registered"], (ours["registered"], ref["registered"])
    assert ours["ate_m"] < 0.10 and ref["ate_m"] < 0.10, (ours["ate_m"], ref["ate_m"])
    assert abs(our_pairs - ref_pairs) <= 1, (our_pairs, ref_pairs)
    assert ours["device"] == "cpu"
