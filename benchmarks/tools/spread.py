#!/usr/bin/env python3
"""Spreads of the end-to-end metrics over series of runs, as the bounds are
set from them.

    python3 benchmarks/tools/spread.py runs/set1/summary.json runs/set2/summary.json

Each summary file (benchmarks/tools/series.py's) is one set. For every
workload and metric of the untraced, uncontrolled runs it prints each set's
median and spread (the distance between the first and the third quartile of
`statistics.quantiles(values, n=4)`, as a share of the median), the wider
spread, five times it, and every value; then the compared numbers' largest
readings over the sound runs, and the smallest of each control.
"""

from __future__ import annotations

import collections
import json
import statistics
import sys


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(paths) -> int:
    sets = []
    for path in paths:
        with open(path) as f:
            sets.append(json.load(f)["runs"])
    by = collections.defaultdict(lambda: collections.defaultdict(list))  # (workload, metric) -> set -> values
    checks = collections.defaultdict(lambda: collections.defaultdict(list))  # workload -> number -> values
    controls = collections.defaultdict(lambda: collections.defaultdict(list))
    for k, runs in enumerate(sets):
        for r in runs:
            workload, _seed, _seconds, trace, *rest = r["spec"].split(":")
            line = r["line"]
            if line is None:
                print(f"no result: {r['spec']} rc {r['rc']}")
                continue
            control = rest[0] if rest else ""
            numbers = r.get("numbers") or {k: v for k, (v, _) in line["check"].items()}
            for name, value in numbers.items():
                (controls[f"{workload}:{control}"] if control else checks[workload])[name].append(value)
            if trace == "0" and not control:
                for name, m in line["metrics"].items():
                    by[(workload, name)][k].append(m["value"])
                print(f"{r['spec']}: correct {line['correct']}, "
                      + ", ".join(f"{n} {m['value']:.6g}" for n, m in line["metrics"].items()))
    for (workload, name), per_set in sorted(by.items()):
        rows = []
        for k, values in sorted(per_set.items()):
            if len(values) >= 2:
                rows.append((k, statistics.median(values), spread(values), values))
        if not rows:
            continue
        widest = max(s for _, _, s, _ in rows)
        print(f"{workload} {name}: widest spread {widest:.4f}, x5 = {5 * widest:.4f}")
        for k, med, s, values in rows:
            print(f"    set {k}: median {med:.6g}, spread {s:.4f}, values {[round(v, 6) for v in values]}")
    for workload in sorted(checks):
        for name in sorted(checks[workload]):
            sound = checks[workload][name]
            print(f"{workload} {name}: sound max {max(sound)!r} (n {len(sound)})")
    for key in sorted(controls):
        for name in sorted(controls[key]):
            ctl = controls[key][name]
            print(f"{key} {name}: control min {min(ctl)!r} (n {len(ctl)})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
