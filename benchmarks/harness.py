"""What the benchmark's run, its job kinds and its metric readers share.

The benchmark is driven by data: `BENCHMARK.json` names the cells and the
metrics, and each cell, configuration, job kind and metric reader sits in a
file of its own that is found by its name:

    benchmarks/workloads/<cell>.json    configuration, job kind, traffic,
                                        controls, limits
    benchmarks/configs/<config>.json    the deployment's sizes as run, and
                                        the world that stands in for its data
    benchmarks/world/<world>.py         trajectory, map and views of a world
    benchmarks/jobs/<kind>.py           run(ctx) -> the job's record;
                                        judge(...) -> the numbers compared
    benchmarks/metrics/<metric>.py      read(record) -> number or None

A metric is reported in the cells that its `workloads` list in
`BENCHMARK.json` names. Imports nothing of the program: the job kinds
import it when they run.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import time
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no process of the benchmark may hold: JAX and
# the JAX package (compared whole: the port's name begins with the latter's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "colmap_pcd_tpu")
# a configuration's keys that are the program's SiftExtractionConfig
SIFT_KEYS = ("max_image_size", "max_num_features", "first_octave", "num_octaves", "octave_resolution",
             "peak_threshold", "edge_threshold")


def forbidden_loaded(modules) -> list[str]:
    """The names among `modules` whose top-level name is forbidden."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the Python file at `path` as a module called `name` (metric
    files carry dots in their names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One cell as the files describe it."""

    name: str
    entry: dict  # its entry in BENCHMARK.json's workloads
    workload: dict  # benchmarks/workloads/<name>.json
    config: dict  # benchmarks/configs/<config>.json
    end_to_end: list  # BENCHMARK.json's end-to-end metrics reported here
    per_layer: list  # BENCHMARK.json's per-layer metrics reported here
    root: str = ROOT  # the checkout whose files these are

    def world(self):
        """The module of the world that stands in for the configuration's data."""
        return world(self.config["world"], self.root)


def metrics_of(manifest: dict, kind: str, cell: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics reported in `cell`:
    those whose `workloads` name it, or that have no such list."""
    return [m for m in manifest[kind] if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """Resolve a cell of `root`'s BENCHMARK.json by its name."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    bench_dir = os.path.join(root, "benchmarks")
    workload = load_json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    if workload["config"] != entry["config"]:
        raise ValueError(f"{name}: the workload file names {workload['config']!r}, BENCHMARK.json {entry['config']!r}")
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(os.path.join(root, configs[entry["config"]]["file"]))
    return Cell(name, entry, workload, config, metrics_of(manifest, "end_to_end", name),
                metrics_of(manifest, "per_layer", name), root)


def job_kind(kind: str, root: str = ROOT):
    return load_module(os.path.join(root, "benchmarks", "jobs", f"{kind}.py"), f"_bench_job_{kind}")


def world(name: str, root: str = ROOT):
    return load_module(os.path.join(root, "benchmarks", "world", f"{name}.py"), f"_bench_world_{name}")


def metric_reader(name: str, root: str = ROOT):
    return load_module(os.path.join(root, "benchmarks", "metrics", f"{name}.py"),
                       "_bench_metric_" + name.replace(".", "_"))


class Deadline(Exception):
    """Raised inside a job when the window's deadline has passed."""


class Spans:
    """The harness's own spans: (name, start, end, parent index) on the
    host's perf_counter clock, with its offset to the epoch clock that the
    profiler's device events carry."""

    def __init__(self):
        self.items: list[list] = []
        self._open: list[int] = []
        self.epoch_offset_ns = time.time_ns() - time.perf_counter_ns()

    def span(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        parent = self.spans._open[-1] if self.spans._open else -1
        self.index = len(self.spans.items)
        self.spans.items.append([self.name, time.perf_counter(), 0.0, parent])
        self.spans._open.append(self.index)
        return self

    def __exit__(self, *exc):
        self.spans.items[self.index][2] = time.perf_counter()
        self.spans._open.pop()
        return False


@dataclass
class JobContext:
    """What a job kind gets: the cell, the job's world on disk and the
    deadline (perf_counter seconds; None for the warm-up and the first job,
    which run to their end)."""

    cell: Cell
    index: int
    views: int
    image_dir: str
    work_dir: str
    truth: list  # world-to-camera (q, t) of each view, in view order
    device: object
    spans: Spans
    deadline: float | None = None
    control: str | None = None  # the name of one of the workload's `controls`, or None

    def options(self, group: str, base):
        """The dataclass `base` with the control's changes to its `group`."""
        if self.control is None:
            return base
        return dataclasses.replace(base, **self.cell.workload["controls"][self.control].get(group, {}))

    def check_deadline(self):
        if self.deadline is not None and time.perf_counter() > self.deadline:
            raise Deadline()
