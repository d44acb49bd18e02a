"""The program's own spans (PHASES, recorded over a traced window) against
the device trace.

`span_table` gives, per span name: the summed seconds of its intervals in
the window (`total_s`), those seconds less what its children cover on the
same thread (`self_s`), its calls (`count`), the device-idle seconds inside
the union of its intervals across threads (`idle_s`), and the device
kernels that start inside that union (`kernels`). `idle_gaps` labels each
idle gap `<harness span>/<innermost program span of each thread at its
midpoint, joined by |>`, or with the harness's label alone where no
program span is open. `coverage` is the share of the window's idle seconds
that lie inside some program span.

PHASES reads `time.perf_counter_ns()`; the profiler's device events carry
the epoch clock, and `harness.Spans.epoch_offset_ns` maps the one onto the
other. `record_program_spans` runs `run.execute` with PHASES recording over
the traced window, and adds `program_spans`, `span_table` and `coverage`
to the record and the new labels to the breakdown.
"""

from __future__ import annotations

import bisect
import collections
import contextlib

from benchmarks import trace

LABEL_CHARS = 120
NOT_KERNELS = ("Memcpy", "Memset")


def in_window(program_spans, t0_ns: int, t1_ns: int, offset_ns: int) -> list[list]:
    """The spans that overlap [t0_ns, t1_ns] (epoch), on the epoch clock and
    clipped to the window, as [name, start, end, parent, thread] with the
    parents re-indexed (-1 where the parent lies outside)."""
    index, out = {}, []
    for old, (name, start, end, parent, thread) in enumerate(program_spans):
        start, end = max(start + offset_ns, t0_ns), min(end + offset_ns, t1_ns)
        if end > start:
            index[old] = len(out)
            out.append([name, start, end, index.get(parent, -1), thread])
    return out


def union(intervals) -> list[tuple[int, int]]:
    """The intervals merged into disjoint ones, in order."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _overlap_ns(a, b) -> int:
    """The length of the intersection of two merged interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(events, t0_ns: int, t1_ns: int) -> list[tuple[int, int]]:
    """The window's intervals in which no operation ran on the device."""
    busy = union((max(s, t0_ns), min(e, t1_ns)) for _name, s, e in events if min(e, t1_ns) > max(s, t0_ns))
    out, cursor = [], t0_ns
    for s, e in busy:
        if s > cursor:
            out.append((cursor, s))
        cursor = e
    if t1_ns > cursor:
        out.append((cursor, t1_ns))
    return out


def span_table(spans, events, t0_ns: int, t1_ns: int) -> dict:
    """Per span name: total_s, self_s, count, idle_s and kernels (see the
    module's doc); `spans` as `in_window` gives them."""
    gaps = idle(events, t0_ns, t1_ns)
    child_ns = collections.Counter()
    for name, s, e, parent, _thread in spans:
        if parent >= 0:
            child_ns[parent] += e - s
    by_name = collections.defaultdict(list)
    table = {}
    for k, (name, s, e, _parent, _thread) in enumerate(spans):
        row = table.setdefault(name, {"total_s": 0.0, "self_s": 0.0, "count": 0})
        row["total_s"] += (e - s) * 1e-9
        row["self_s"] += (e - s - child_ns[k]) * 1e-9
        row["count"] += 1
        by_name[name].append((s, e))
    starts = sorted(s for name, s, _e in events if t0_ns <= s < t1_ns and not name.startswith(NOT_KERNELS))
    for name, intervals in by_name.items():
        merged = union(intervals)
        table[name]["idle_s"] = _overlap_ns(merged, gaps) * 1e-9
        table[name]["kernels"] = _count_inside(starts, merged)
    return table


def _count_inside(sorted_points, merged) -> int:
    return sum(bisect.bisect_left(sorted_points, e) - bisect.bisect_left(sorted_points, s) for s, e in merged)


def open_at(spans, t_ns: int) -> list[str]:
    """The innermost program span open at `t_ns` on each thread, by name,
    each name once, sorted."""
    innermost = {}
    for name, s, e, _parent, thread in spans:
        if s <= t_ns < e and (thread not in innermost or s >= innermost[thread][0]):
            innermost[thread] = (s, name)
    return sorted({name for _s, name in innermost.values()})


def label(harness_label: str, spans, t_ns: int) -> str:
    names = open_at(spans, t_ns)
    if not names:
        return harness_label
    return f"{harness_label}/{'|'.join(names)}"[:LABEL_CHARS]


def idle_gaps(events, t0_ns: int, t1_ns: int, harness_spans, spans, top: int = 10) -> list[list]:
    """The `top` longest idle gaps inside the window as [label, seconds],
    labelled at their midpoints (trace.summarize's gaps, finer labels)."""
    gaps = sorted(idle(events, t0_ns, t1_ns), key=lambda g: (g[1] - g[0], g[0]), reverse=True)[:top]
    return [[label(trace._label(harness_spans, (s + e) // 2), spans, (s + e) // 2), (e - s) * 1e-9] for s, e in gaps]


def coverage(spans, events, t0_ns: int, t1_ns: int, harness_spans) -> dict:
    """The window's idle seconds, the share of them inside some program
    span, and the uncovered idle seconds by the harness span around them."""
    gaps = idle(events, t0_ns, t1_ns)
    covered = union((s, e) for _n, s, e, _p, _t in spans)
    idle_ns = sum(e - s for s, e in gaps)
    inside = _overlap_ns(gaps, covered)
    uncovered = collections.defaultdict(float)
    for s, e in gaps:
        rest = (e - s) - _overlap_ns([(s, e)], covered)
        if rest > 0:
            uncovered[trace._label(harness_spans, (s + e) // 2)] += rest * 1e-9
    return {"idle_s": idle_ns * 1e-9, "covered_share": inside / idle_ns if idle_ns else 1.0,
            "uncovered_s": dict(sorted(uncovered.items(), key=lambda kv: -kv[1]))}


@contextlib.contextmanager
def record_program_spans():
    """Around `run.execute(..., trace=True)`: PHASES records from the
    profiler's start; the trace's summary then also gives the program's
    spans in the window. Yields a dict that holds, after the run,
    `program_spans`, `span_table` and `coverage` (add them to the record
    before its readers read it)."""
    from colmap_pcd_tpu_torch.utils.logging_utils import PHASES

    start, summarize = trace.start, trace.summarize
    held = {}

    def start_recording(device):
        prof = start(device)
        PHASES.start_recording()
        return prof

    def summarize_with_spans(events, t0_ns, t1_ns, harness_spans, top=10):
        out = summarize(events, t0_ns, t1_ns, harness_spans, top)
        spans = in_window(PHASES.stop_recording(), t0_ns, t1_ns, harness_spans.epoch_offset_ns)
        held.update(program_spans=spans, span_table=span_table(spans, events, t0_ns, t1_ns),
                    coverage=coverage(spans, events, t0_ns, t1_ns, harness_spans))
        out["idle_gaps"] = idle_gaps(events, t0_ns, t1_ns, harness_spans, spans, top)
        return out

    trace.start, trace.summarize = start_recording, summarize_with_spans
    try:
        yield held
    finally:
        trace.start, trace.summarize = start, summarize
        PHASES.stop_recording()
