#!/usr/bin/env python3
"""A traced run of one cell with the program's own spans recorded: what
`run.py --trace 1` prints, plus the span table, the idle time that the
program's spans cover, and every per-layer metric that reads them.

    python3 benchmarks/tools/traced_spans.py --workload ref.front25.default --seed 7 --seconds 51 \\
        --dump runs/record.json

PHASES records over the traced window (benchmarks/spans.py); the record
gains `program_spans`, `span_table`, `coverage` and `count_calls` (the
calls of each PHASES counter in the window), the idle gaps carry the
program's span names, and the four readers of the span table join the
line's metrics. `--span-cost N` first times N spans and counter
increments on this host, with recording off and on. The benchmark's own
runs never use this.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks import harness, run, spans  # noqa: E402

# the readers of the span table, with their units (run.py keeps no program spans, so BENCHMARK.json lists none)
SPAN_METRICS = {"ba.idle_s_per_image": "s/image", "lidar.proj_idle_s_per_image": "s/image",
                "sift.kernels_per_image": "kernels/image", "two_view.idle_ms_per_pair": "ms/pair"}


def span_cost(n: int) -> dict:
    """ns per span (enter and exit), recording off and on, and per counter
    increment, on a fresh PhaseTimer in this thread."""
    from colmap_pcd_tpu_torch.utils.logging_utils import PhaseTimer

    pt = PhaseTimer()
    out = {}
    for key in ("span_off_ns", "span_on_ns"):
        if key == "span_on_ns":
            pt.start_recording()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with pt.phase("x"):
                pass
        out[key] = (time.perf_counter_ns() - t0) / n
        pt.stop_recording()
    t0 = time.perf_counter_ns()
    for _ in range(n):
        pt.count("c")
    out["count_ns"] = (time.perf_counter_ns() - t0) / n
    return out


def execute(cell, seed: int, seconds: float, device: str = "cuda") -> dict:
    """`run.execute` of `cell` traced with the program's spans recorded; the
    span table's readers are run on the record and added to the line's."""
    from colmap_pcd_tpu_torch.utils.logging_utils import PHASES

    calls = collections.Counter()
    count = PHASES.count

    def counted(name, n=1):
        calls[name] += 1
        count(name, n)

    PHASES.count = counted
    try:
        with spans.record_program_spans() as held:
            line = run.execute(cell, seed, seconds, True, device)
    finally:
        del PHASES.count
    record = line["_record"]
    record.update(held, count_calls=dict(calls))
    for name, unit in SPAN_METRICS.items():
        value = harness.metric_reader(name, cell.root).read(record)
        if value is not None:
            line["metrics"][name] = {"value": float(value), "unit": unit}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--dump", default="", help="also write the record here (JSON)")
    ap.add_argument("--span-cost", type=int, default=0, help="time this many spans first")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("traced_spans.py: no CUDA device", file=sys.stderr)
        return 2
    if args.span_cost:
        print("[spans] cost " + json.dumps(span_cost(args.span_cost)), file=sys.stderr, flush=True)
    cell = harness.load_cell(args.workload)
    line = execute(cell, args.seed, args.seconds)
    run.report(line)
    record = line["_record"]
    table = sorted(record["span_table"].items(), key=lambda kv: -kv[1]["total_s"])
    for name, row in table:
        print(f"[spans] {name:<30s} " + json.dumps(row), file=sys.stderr)
    print("[spans] coverage " + json.dumps(record["coverage"]), file=sys.stderr)
    print(f"[spans] {len(record['program_spans'])} spans, counter calls {json.dumps(record['count_calls'])}",
          file=sys.stderr, flush=True)
    if args.dump:
        os.makedirs(os.path.dirname(os.path.abspath(args.dump)), exist_ok=True)
        with open(args.dump, "w") as f:
            json.dump(record, f, default=float)
    print(run.result_line(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
