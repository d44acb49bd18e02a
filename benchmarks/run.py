#!/usr/bin/env python3
"""The benchmark of colmap_pcd_tpu_torch on one NVIDIA GPU.

    python3 benchmarks/run.py --workload ref.capture8.seq --seed 7 --seconds 51 --trace 0

One run is one process: set-up (imports, the kernels loaded from the
program's build cache, every job's views rendered on the card and written
as PNG into a temporary directory, one warm-up job through the cell's own
path), then a window of `--seconds` in which capture jobs (the workload's
`views` each) run back to back, one after another, each with its own database, map and model,
then the reference's check of what the window's jobs produced.

The last line of stdout is one JSON object: `correct`, `attempted` and
`failed` (images), `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics, read under `torch.profiler`), `device`,
with `--trace 1` a `breakdown`, and last `check`: each number the reference
compared, with its limit. The same numbers close stderr, after the
program's phase report, the kernels' launches and the card's name and power
limit. Without a card (or with fewer than the cell asks for) it prints no
result and exits 2; it never falls back to the CPU. `--control <name>` runs
one of the cell's controls (its workload's `controls`: a guarantee of the
configuration broken), which has to come out not correct; the benchmark's
own runs never name one. The job kind judges its jobs (`jobs/<kind>.py`'s `judge`);
this file applies the workload's `limits` to the numbers it returns.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks import harness  # noqa: E402

RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "check")


def _log(msg: str):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _write_png(path: str, view):
    from PIL import Image

    Image.fromarray(view).save(path, compress_level=1)


def render_jobs(cell, seed: int, indices, views: int, tmp: str, device, anchor: bool = True) -> dict:
    """Each job's views ray-cast on `device` and written as v0000.png ...
    into its own directory. Job 0 is the anchor capture, the world of
    (seed 0, job 0) at every seed, so that the first job's ATE (an end-to-end
    metric) reads the same capture in every run; every other job, and the
    warm-up (-1), renders the textures of (seed, job) on the same trajectory.
    Without `anchor`, job 0 too renders its seed's world (the readings that
    a limit is set from, benchmarks/tools/readings.py). Returns {job:
    (image dir, truth)}."""
    cfg = cell.config
    world = cell.world()
    out = {}
    with ThreadPoolExecutor(max_workers=4) as pool:
        writes = []
        for j in indices:
            offset = world.world_key(0 if j == 0 and anchor else seed, j)
            n = views if j >= 0 else cell.workload["warm_views"]
            truth = world.trajectory(n, cfg["step_m"])
            img_dir = os.path.join(tmp, f"job{j}", "images")
            os.makedirs(img_dir)
            rendered = world.render_u8(truth, cfg["image_width"], cfg["image_height"], cfg["focal_length"],
                                          offset, device)
            writes += [pool.submit(_write_png, os.path.join(img_dir, f"v{i:04d}.png"), rendered[i])
                       for i in range(n)]
            out[j] = (img_dir, truth)
        for w in writes:
            w.result()
    return out


def _phases():
    from colmap_pcd_tpu_torch.utils.logging_utils import PHASES

    return PHASES


def _prepare_program(device):
    """The program's kernels and native runtime, loaded (or built on the
    first run of a checkout) from their caches inside the checkout."""
    from colmap_pcd_tpu_torch.ops import match_kernel, nn_kernel
    from colmap_pcd_tpu_torch.utils import native

    if device.type == "cuda":
        nn_kernel.build()
        match_kernel.build_u8()
    native.get_lib()


def execute(cell, seed: int, seconds: float, trace: bool, device: str = "cuda", control: str | None = None,
            anchor: bool = True) -> dict:
    """One run of `cell` in this process (with `control`, the named control
    of its workload; without `anchor`, the first job on its seed's world);
    returns the result's line (the dict printed last) and, under "_record",
    what the metric readers read."""
    import numpy as np
    import torch

    dev = torch.device(device)
    kind = harness.job_kind(cell.workload["job"], cell.root)
    wl = cell.workload
    views, n_jobs = wl["views"], wl["jobs_rendered"]
    spans = harness.Spans()
    tmp = tempfile.mkdtemp(prefix="colmap_bench_")
    try:
        _prepare_program(dev)
        with spans.span("render"):
            worlds = render_jobs(cell, seed, [-1, *range(n_jobs)], views, tmp, dev, anchor)
        truths = {j: truth for j, (_, truth) in worlds.items()}

        def context(j: int, index: int, deadline) -> harness.JobContext:
            img_dir, truth = worlds[j]
            work = os.path.join(tmp, f"run{index}")
            os.makedirs(work)
            return harness.JobContext(cell, index, len(truth), img_dir, work, truth, dev, spans, deadline, control)

        with spans.span("warm"):
            warm = kind.run(context(-1, -1, None))
            if hasattr(kind, "finish"):
                kind.finish(warm)
        _sync(dev)
        phases = _phases()
        phases.totals.clear()
        phases.counts.clear()
        shapes = prof = None
        if trace:
            from benchmarks import kernels
            from benchmarks import trace as trace_mod

            shapes = kernels.KernelShapes().install()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        if trace:
            prof = trace_mod.start(dev)
        t0 = time.perf_counter()
        setup_s = t0 - T_START
        deadline = t0 + seconds
        # the window ends with the last capture that finished: what the
        # readers read is taken as it stood then (a capture stopped at the
        # deadline is left out, its work and its time alike)
        # the first job, the anchor capture, always runs to its end (the check
        # holds it to the deadline); no job starts after the deadline
        jobs, index, snapshot = [], 0, None
        usage0, load0 = resource.getrusage(resource.RUSAGE_SELF), os.getloadavg()
        while index == 0 or time.perf_counter() < deadline:
            j = index % n_jobs  # past the rendered jobs the captures repeat, each into a fresh database
            with spans.span(f"job{index}"):
                record = kind.run(context(j, index, deadline if index else None))
            record["world"] = j
            jobs.append(record)
            index += 1
            if record["stopped"]:
                break
            snapshot = (record["t_end"], dict(phases.totals), dict(phases.counts),
                        (len(shapes.k2), len(shapes.k1u8)) if shapes is not None else None)
        _sync(dev)
        t1 = time.perf_counter()
        usage1, load1 = resource.getrusage(resource.RUSAGE_SELF), os.getloadavg()
        if prof is not None:
            prof.__exit__(None, None, None)
            shapes.restore()
        if hasattr(kind, "finish"):
            for record in jobs:
                kind.finish(record)
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        te, phase_totals, phase_counts, launched = snapshot or (t1, {}, {}, (0, 0))
        finished = [r for r in jobs if not r["stopped"]]
        traced = None
        if prof is not None:
            events = trace_mod.device_events(prof)
            del prof
            off = spans.epoch_offset_ns
            traced = trace_mod.summarize(events, int(t0 * 1e9) + off, int(te * 1e9) + off, spans)
        truths_by_index = {r["index"]: truths[r["world"]] for r in jobs}
        with spans.span("check"):
            judged = kind.judge(cell, jobs, truths_by_index, deadline)
        kernel_shapes = None
        if shapes is not None:
            kernel_shapes = shapes.fetched()
            kernel_shapes = {"k2": kernel_shapes["k2"][:launched[0]], "k1u8": kernel_shapes["k1u8"][:launched[1]]}
        record = {
            "cell": cell.name, "seconds": seconds, "setup_s": setup_s, "window_s": te - t0,
            "registered": sum(r.get("registered", 0) for r in finished),
            "jobs": [{k: v for k, v in r.items() if k != "model"} for r in finished],
            "stopped_jobs": len(jobs) - len(finished),
            "phases": {"totals": phase_totals, "counts": phase_counts},
            "spans": [list(s) for s in spans.items], "trace": traced, "kernels": kernel_shapes,
            "check": {"first_job": judged["first_job"], "numbers": judged["numbers"]},
            "host": {"cpus": os.cpu_count(), "load_1min": [load0[0], load1[0]],
                     "cpu_user_s": usage1.ru_utime - usage0.ru_utime, "cpu_sys_s": usage1.ru_stime - usage0.ru_stime,
                     "involuntary_switches": usage1.ru_nivcsw - usage0.ru_nivcsw, "loop_s": t1 - t0},
        }
        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = harness.metric_reader(m["name"], cell.root).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        limits = wl["limits"]
        numbers = judged["numbers"]
        compared = {k: [numbers.get(k, float("inf")), float(v)] for k, v in limits.items()}
        correct = all(np.isfinite(x) and x <= lim for x, lim in compared.values())
        device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                       "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                       "count": 1, "memory_peak_bytes": int(peak)}
        line = {"correct": bool(correct),
                "attempted": int(sum(r["views"] for r in finished)),
                "failed": int(judged["failed_images"]),
                "metrics": metrics, "device": device_info}
        if traced is not None:
            device_info.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
            line["breakdown"] = {"device_ops": traced["device_ops"], "idle_gaps": traced["idle_gaps"]}
        line["check"] = compared
        line["_record"] = record
        line["_judged"] = judged
        line["_phases_report"] = "\n".join(
            f"  {k:<30s} {phase_totals[k]:8.3f}s  x{phase_counts.get(k, 0)}"
            for k in sorted(phase_totals, key=lambda k: -phase_totals[k]))
        return line
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _nvidia_smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def result_line(line: dict) -> str:
    """The result's JSON line: the contract's keys only, `check` last."""
    return json.dumps({k: line[k] for k in RESULT_KEYS if k in line})


def report(line: dict) -> None:
    """The run's account on stderr, its compared numbers last."""
    record, judged = line["_record"], line["_judged"]
    _log("the program's PHASES over the window (host clock):\n" + line["_phases_report"])
    for r in record["jobs"]:
        keys = ("index", "world", "views", "registered", "pairs_matched", "pairs_verified",
                "extract_s", "match_s", "match_busy_s")
        _log("job " + json.dumps({k: r[k] for k in keys if k in r}) + f" wall {r['t_end'] - r['t_start']:.3f} s")
    for k, row in enumerate(judged["per_job"]):
        _log(f"reference, finished job {k}: " + json.dumps(row))
    for row in judged["partial"]:
        _log("reference, job stopped at the deadline: " + json.dumps(row))
    _log("reference, first job as it stands: " + json.dumps(judged["first_job"]))
    if record["kernels"] is not None:
        _log(f"launches in the window: K2 {len(record['kernels']['k2'])}, K1 uint8 {len(record['kernels']['k1u8'])}")
    _log(f"setup {record['setup_s']:.3f} s, window {record['window_s']:.3f} s to the end of the last finished job "
         f"({record['stopped_jobs']} stopped at the deadline), {record['registered']} registered; "
         f"peak device memory {line['device']['memory_peak_bytes'] / 2**20:.1f} MiB")
    _log("host over the loop: " + json.dumps(record["host"]))
    _log("informational: " + json.dumps({k: v for k, v in judged["numbers"].items() if k not in line["check"]}))
    for name, (value, limit) in line["check"].items():
        _log(f"check {name} = {value!r} (limit {limit!r}): {'ok' if value <= limit else 'FAILED'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default="", help="run the workload's control of this name (for its readings)")
    ap.add_argument("--dump", default="", help="also write the metric readers' record here (JSON)")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    chips = cell.entry["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmarks/run.py: {args.workload} needs {chips} CUDA device(s), found {found}; "
              "no result (the benchmark never runs on the CPU)", file=sys.stderr)
        return 2
    _log(f"{args.workload} seed {args.seed}, {args.seconds:g} s, trace {args.trace}, control {args.control or '-'}; "
         f"card {_nvidia_smi()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    line = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", args.control or None)
    report(line)
    if args.dump:
        os.makedirs(os.path.dirname(os.path.abspath(args.dump)), exist_ok=True)
        with open(args.dump, "w") as f:
            json.dump(line["_record"], f, default=float)
    found = harness.forbidden_loaded(sys.modules)
    if found:
        print(f"benchmarks/run.py: forbidden modules loaded: {', '.join(found)}; no result", file=sys.stderr)
        return 3
    print(result_line(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
