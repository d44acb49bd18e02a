#!/usr/bin/env python3
"""The readings that a cell's limits are set from: sound runs and controls
on many seeds, one after another in one process (set-up's imports and
kernels paid once), each with its first job on its own seed's world.

    python3 benchmarks/tools/readings.py --out runs/readings \\
        ref.capture8.seq:101:1 ref.capture8.seq:102:1:lidar_weight_0 ref.front25.default:103:12

Each argument is `workload:seed:seconds[:control]`. Prints one line a run
(its compared numbers, then the reference's other numbers) and writes
`<out>/summary.json` in the shape of benchmarks/tools/series.py's, which
benchmarks/tools/spread.py reads. The benchmark's own runs never use this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks import harness, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings.py: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    results = []
    for spec in args.runs:
        workload, seed, seconds, *rest = spec.split(":")
        control = rest[0] if rest else None
        t0 = time.perf_counter()
        try:
            line = run.execute(harness.load_cell(workload), int(seed), float(seconds), False, "cuda", control,
                               anchor=False)
        except Exception:  # a control that crashes has failed; keep the others' readings
            traceback.print_exc()
            results.append({"spec": f"{workload}:{seed}:{seconds}:0" + (f":{control}" if control else ""),
                            "rc": 1, "line": None, "numbers": {}})
            _write(args.out, results)
            continue
        numbers = line["_judged"]["numbers"]
        short = {k: v for k, v in line.items() if not k.startswith("_") and k != "breakdown"}
        print(f"[readings] {spec}: {time.perf_counter() - t0:.1f} s, {json.dumps(short)}; "
              f"numbers {json.dumps(numbers)}", flush=True)
        results.append({"spec": f"{workload}:{seed}:{seconds}:0" + (f":{control}" if control else ""),
                        "rc": 0, "line": short, "numbers": numbers})
        _write(args.out, results)
    return 0


def _write(out: str, results: list) -> None:
    """summary.json after every run: a cut call keeps the runs it made."""
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump({"card": run._nvidia_smi(), "runs": results}, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
