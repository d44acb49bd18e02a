"""Tiny CPU rehearsals of each job kind through the harness's whole run
(set-up, window, reference, metric readers), the result line's keys, the
refusal without a card, and what the benchmark's processes may import."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from benchmarks import harness, run
from benchmarks.tests import tiny

ROOT = harness.ROOT
DEVICE_METRICS = {"k2.roofline_pct", "k1u8.roofline_pct", "device.idle_pct.map", "device.idle_pct.front"}
PIPELINE, FRONT = "ref.capture8.seq", "ref.front25.default"
ALLOWED = ["correct", "attempted", "failed", "metrics", "device", "breakdown", "check"]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    return env


@pytest.mark.parametrize("name,trace,workload", [
    (PIPELINE, False, {}),
    (PIPELINE, True, {"front_end": "overlapped"}),
    (FRONT, False, {}),
    (FRONT, True, {}),
])
def test_rehearsal(name, trace, workload):
    """Each job kind (and the pipeline's overlapped front end, which a cell
    can name in its workload file) through a whole run."""
    line = tiny.execute(name, trace=trace, **workload)
    cell = tiny.cell(name)
    assert line["correct"], line["check"]
    assert line["attempted"] >= 6 and line["failed"] == 0
    printed = json.loads(run.result_line(line))
    assert list(printed) == [k for k in ALLOWED if k in printed] and list(printed)[-1] == "check"
    assert set(printed["check"]) == set(cell.workload["limits"])
    expected = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    # a CPU run writes no device metric: the readers find no device time
    assert set(printed["metrics"]) <= expected - DEVICE_METRICS
    assert set(printed["metrics"]) >= expected - DEVICE_METRICS - {"two_view.linalg_syncs_per_pair"}
    assert printed["device"]["platform"] == "cpu"
    if trace:
        assert printed["device"]["busy_s"] == 0 and printed["device"]["window_s"] > 0
        assert len(printed["breakdown"]["idle_gaps"]) <= 10
    else:
        assert "breakdown" not in printed and printed["metrics"]["setup_s"]["value"] > 0


def test_no_card_no_result():
    """Without CUDA the run prints nothing on stdout and exits 2: it never
    falls back to the CPU."""
    proc = subprocess.run([sys.executable, "benchmarks/run.py", "--workload", "ref.capture8.seq", "--seed", "3",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          env=_env(), timeout=300)
    assert proc.returncode == 2 and proc.stdout == "" and "CUDA" in proc.stderr


def test_without_the_program_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files the
    run cannot import the program and ends without a result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmarks"), tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmarks import run, harness;"
            "run.execute(harness.load_cell('ref.front25.default', root='.'), 1, 1.0, False, 'cpu')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                          env=_env(), timeout=300)
    assert proc.returncode != 0 and "colmap_pcd_tpu_torch" in proc.stderr and proc.stdout == ""


def test_no_jax_in_a_run():
    """A rehearsal with JAX and the JAX package made unimportable runs, and
    leaves no module of theirs loaded (compared by whole top-level names)."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'colmap_pcd_tpu'): sys.modules[m] = None\n"
            "from benchmarks.tests import tiny\n"
            "from benchmarks import harness\n"
            "import torch; torch.set_num_threads(2)\n"
            "line = tiny.execute('ref.capture8.seq', front_end='overlapped')\n"
            "loaded = [m for m, v in sys.modules.items() if v is not None]\n"
            "print(harness.forbidden_loaded(loaded), line['correct'])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, env=_env(),
                          timeout=1500)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_are_whole():
    assert harness.forbidden_loaded(["colmap_pcd_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_loaded(["colmap_pcd_tpu.ops", "jax.numpy", "flax"]) == ["colmap_pcd_tpu.ops", "flax",
                                                                                        "jax.numpy"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_what_the_benchmark_imports():
    """Nothing under benchmarks/ (its tests aside) imports the JAX package,
    bench.py, bench_torch.py, chip_smoke.py or tests/; the reference imports
    nothing of the program."""
    bad = {"jax", "jaxlib", "flax", "colmap_pcd_tpu", "bench", "bench_torch", "chip_smoke", "tests",
           "synthetic_torch", "render_torch"}
    for path in glob.glob(os.path.join(ROOT, "benchmarks", "**", "*.py"), recursive=True):
        if os.sep + "tests" + os.sep in path:
            continue
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & bad, (path, tops & bad)
        if os.sep + "reference" + os.sep in path:
            assert "colmap_pcd_tpu_torch" not in tops, path
    proc = subprocess.run([sys.executable, "-c", "import sys; import benchmarks.reference.check;"
                           "print(sorted({m.split('.')[0] for m in sys.modules} & {'colmap_pcd_tpu_torch', 'torch'}))"],
                          cwd=ROOT, capture_output=True, text=True, env=_env(), timeout=120)
    assert proc.stdout.strip() == "[]", proc.stderr
