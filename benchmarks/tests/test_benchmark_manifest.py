"""BENCHMARK.json against the benchmark's contract, and the data-driven
layout: every cell resolves its configuration, job kind and metric readers
by name, and a cell or a metric is added by new files and entries alone."""

import json
import os
import re
import shutil

import pytest

from benchmarks import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion", "experts_per")


@pytest.fixture(scope="module")
def manifest():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    return harness.load_json(path)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(manifest["command"]) <= 32 and all(_line(w) for w in manifest["command"])
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/") and not p.endswith("_torch")
        assert os.path.isdir(os.path.join(ROOT, p))
    for word in manifest["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in manifest["paths"]), word
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # the full check of 24 cells fits its 12 hours
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(manifest, section):
    names = [e["name"] for e in manifest[section]]
    assert len(names) == len(set(names))
    for e in manifest[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in manifest[section]:
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), e["name"]


def test_metrics(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert "workloads" in m and set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:  # every cell that reports it reports what it moves
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
    for m in manifest["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in manifest["per_layer"]:  # one layer, one name: a module named twice is named alike
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_cells(manifest):
    configs = {c["name"] for c in manifest["configs"]}
    used = set()
    pairs = set()
    for w in manifest["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        e2e = harness.metrics_of(manifest, "end_to_end", w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert harness.metrics_of(manifest, "per_layer", w["name"])
    assert used == configs
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)


def test_configs(manifest):
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert any(c["file"].startswith(p + "/") for p in manifest["paths"])
        assert len(c["reduced"]) <= 16
        data = harness.load_json(os.path.join(ROOT, c["file"]))
        assert data["source"] == c["source"]
        assert set(c["reduced"]) == set(data["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key) and key in data
            assert not key.endswith(("_dim", "_rank")) and not any(w in key for w in WIDTH_WORDS), key


def test_file_names():
    for dirpath, dirs, files in os.walk(os.path.join(ROOT, "benchmarks")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert PATH.match(rel), rel
            assert not re.match(r"^bench.*\.json$|^bench_.*\.log$", f), rel


CELLS = [w["name"] for w in harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.load_cell(cell)
    kind = harness.job_kind(c.workload["job"])
    assert callable(kind.run) and callable(kind.judge)
    world = c.world()
    assert all(callable(getattr(world, f)) for f in ("world_key", "trajectory", "render_u8", "build_corridor_map"))
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.metric_reader(m["name"]).read)
    assert set(c.workload["limits"]) and all(isinstance(v, float) for v in c.workload["limits"].values())
    assert c.workload["views"] == c.config["capture_images"]


EXTRACT_JOB = '''"""Job kind `extract`: one capture through the feature extractor alone."""

import os
import time

from benchmarks import harness
from benchmarks.reference import check as reference


def run(ctx):
    from colmap_pcd_tpu_torch.models.feature_pipeline import ImageReaderConfig, run_feature_extractor
    from colmap_pcd_tpu_torch.utils.config import SiftExtractionConfig

    database = os.path.join(ctx.work_dir, "database.db")
    t0 = time.perf_counter()
    extraction = SiftExtractionConfig(**{k: ctx.cell.config[k] for k in harness.SIFT_KEYS})
    run_feature_extractor(database, ctx.image_dir, extraction, ImageReaderConfig(), device=ctx.device)
    return {"index": ctx.index, "views": ctx.views, "database": database, "stopped": False, "t_start": t0,
            "t_end": time.perf_counter()}


def judge(cell, jobs, truths, deadline):
    counts = [len(kp) for r in jobs for kp in reference.read_database(r["database"])["keypoints"].values()]
    short = sum(len(truths[r["index"]]) for r in jobs) - len(counts)
    return {"numbers": {"images_without_keypoints": float(short + sum(c == 0 for c in counts))},
            "per_job": [], "partial": [], "first_job": {}, "failed_images": short}
'''


def test_new_config_cell_kind_and_metric_from_files_alone(tmp_path):
    """A later change adds a configuration, a cell with a job kind of its own
    and a metric by new files and entries: nothing of the harness is edited,
    and a run of the new cell goes through (at a size the CPU runs)."""
    from benchmarks import run

    shutil.copytree(os.path.join(ROOT, "benchmarks"), tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmarks"
    manifest = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    config = harness.load_json(os.path.join(ROOT, "benchmarks", "configs", "corridor_ref.json"))
    config.update(name="corridor_small", image_width=160, image_height=120, focal_length=125.0, capture_images=3,
                  max_num_features=512, num_octaves=2, reduced={"capture_images": "3 views"})
    (bench / "configs" / "corridor_small.json").write_text(json.dumps(config))
    manifest["configs"].append({"name": "corridor_small", "source": config["source"],
                                "file": "benchmarks/configs/corridor_small.json", "reduced": ["capture_images"],
                                "why": "a small capture"})
    (bench / "jobs" / "extract.py").write_text(EXTRACT_JOB)
    (bench / "workloads" / "small.extract3.json").write_text(json.dumps(
        {"config": "corridor_small", "job": "extract", "views": 3, "warm_views": 2, "jobs_rendered": 1,
         "controls": {}, "limits": {"images_without_keypoints": 0.0}}))
    manifest["workloads"].append({"name": "small.extract3", "config": "corridor_small", "traffic": "extract3",
                                  "chips": 1, "why": "extraction alone"})
    (bench / "metrics" / "extract.jobs.py").write_text("def read(record):\n    return float(len(record['jobs']))\n")
    manifest["per_layer"].append({"name": "extract.jobs", "unit": "jobs", "better": "higher",
                                  "source": "host_clock", "layer": "extractor", "moves": "setup_s",
                                  "workloads": ["small.extract3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = harness.load_cell("small.extract3", root=str(tmp_path))
    assert cell.config["name"] == "corridor_small" and cell.world().__name__.endswith("corridor_fine")
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"] and [m["name"] for m in cell.per_layer] == [
        "extract.jobs"]
    line = run.execute(cell, 2**33 + 5, 0.001, True, "cpu")
    assert line["correct"] and line["check"] == {"images_without_keypoints": [0.0, 0.0]}
    assert line["metrics"] == {"extract.jobs": {"value": 1.0, "unit": "jobs"}} and line["attempted"] == 3
    old = harness.load_cell("ref.front25.default", root=str(tmp_path))
    assert old.workload == harness.load_cell("ref.front25.default").workload
