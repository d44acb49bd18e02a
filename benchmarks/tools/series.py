#!/usr/bin/env python3
"""Run the benchmark several times, each run a process of its own, one
after another, and keep every run's output.

    python3 benchmarks/tools/series.py --out runs/series \\
        ref.capture8.seq:101:51:0 ref.capture8.seq:102:51:1 ref.capture8.seq:103:51:0:lidar_weight_0

Each argument is `workload:seed:seconds:trace[:control]`, the control
named as in the workload's `controls`. Each run's stdout and stderr go to
`<out>/<n>_<workload>_<seed>_<trace>[_<control>].{out,err}`; a run that
outlasts `--timeout` seconds is ended and counted as failed;
stdout gets one summary line a run: its exit code, wall seconds, result line
(without the breakdown) and the compared numbers, and at the end the card's
name and power limit and a summary of all result lines as JSON in
`<out>/summary.json`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"[series] card: {smi.stdout.strip()}", flush=True)
    results = []
    for n, spec in enumerate(args.runs):
        parts = spec.split(":")
        workload, seed, seconds, trace = parts[:4]
        control = parts[4] if len(parts) > 4 else ""
        tag = f"{n:02d}_{workload}_{seed}_{trace}" + (f"_{control}" if control else "")
        cmd = [sys.executable, os.path.join(ROOT, "benchmarks", "run.py"), "--workload", workload, "--seed", seed,
               "--seconds", seconds, "--trace", trace, "--control", control]
        if trace == "1" and not control:
            cmd += ["--dump", os.path.join(args.out, f"{tag}.record.json")]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=args.timeout)
        except subprocess.TimeoutExpired as e:
            out = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
            err = e.stderr.decode() if isinstance(e.stderr, bytes) else (e.stderr or "")
            proc = subprocess.CompletedProcess(cmd, 124, out, err + f"\n[series] ended after {args.timeout:g} s")
        wall = time.perf_counter() - t0
        with open(os.path.join(args.out, f"{tag}.out"), "w") as f:
            f.write(proc.stdout)
        with open(os.path.join(args.out, f"{tag}.err"), "w") as f:
            f.write(proc.stderr)
        lines = proc.stdout.strip().splitlines()
        line = None
        if proc.returncode == 0 and lines:
            line = json.loads(lines[-1])
        checks = [ln for ln in proc.stderr.splitlines() if ln.startswith("[bench] check ")]
        numbers = {}
        for ln in proc.stderr.splitlines():
            if ln.startswith("[bench] informational: "):
                numbers.update(json.loads(ln.split(": ", 1)[1]))
        numbers.update({k: v for k, (v, _) in (line or {}).get("check", {}).items()})
        short = {k: v for k, v in (line or {}).items() if k != "breakdown"}
        print(f"[series] {tag}: rc {proc.returncode}, {wall:.1f} s, {json.dumps(short)}", flush=True)
        if proc.returncode != 0:
            print("\n".join(proc.stderr.splitlines()[-25:]), flush=True)
        results.append({"spec": spec, "rc": proc.returncode, "wall_s": wall, "line": line, "checks": checks,
                        "numbers": numbers})
        with open(os.path.join(args.out, "summary.json"), "w") as f:  # after every run: a cut series keeps its runs
            json.dump({"card": smi.stdout.strip(), "runs": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
