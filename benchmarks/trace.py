"""The device trace of a `--trace 1` run and what the harness reads from it.

`torch.profiler` records the card's activity (kernels, copies, sets) over
the window; nothing of the host's operators is recorded, which keeps the
cost of tracing to the device's own records. `summarize` turns the raw
events into: the seconds in which an operation ran on the device (the
union of their intervals inside the window), each kernel's device seconds
by name, the operations that took most (by `short_name`), and the longest
idle gaps, each
labelled by the harness's innermost span around it. Profiler and harness
share the epoch clock (Spans.epoch_offset_ns maps the harness's
perf_counter onto it).
"""

from __future__ import annotations

import collections
import re


def start(device):
    """The profiler, started, over the card's activity (over the host's
    operators for a rehearsal on the CPU, which records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU])
    prof.__enter__()
    return prof


def device_events(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every device activity the profiler kept."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its template arguments and parameters, with
    the functor that a templated PyTorch kernel applies in brackets."""
    n = name[5:] if name.startswith("void ") else name
    if "<" not in n and len(n) <= 100:
        return n
    head = re.split(r"[<(]", n, maxsplit=1)[0]
    rest = n[len(head):]
    m = re.search(r"\w*Functor\w*(?:<[\w:, ]*>)?", rest) or re.search(r"\w+_impl\w*", rest)
    return (head + (f"[{m.group(0)}]" if m else ""))[:160]


def _label(spans, t_ns: int) -> str:
    """The name of the innermost harness span around epoch time `t_ns`."""
    t = (t_ns - spans.epoch_offset_ns) * 1e-9
    best, best_start = "between_jobs", -1.0
    for name, start, end, _parent in spans.items:
        if start <= t <= (end or float("inf")) and start > best_start:
            best, best_start = name, start
    return best


def summarize(events, t0_ns: int, t1_ns: int, spans, top: int = 10) -> dict:
    """busy_s, window_s, kernel seconds by name, the `top` operations by
    device time and the `top` longest idle gaps inside [t0_ns, t1_ns]."""
    by_name = collections.defaultdict(float)
    intervals = []
    for name, s, e in events:
        s, e = max(s, t0_ns), min(e, t1_ns)
        if e <= s:
            continue
        by_name[name] += (e - s) * 1e-9
        intervals.append((s, e))
    intervals.sort()
    busy_ns, gaps, cursor = 0, [], t0_ns
    for s, e in intervals:
        if s > cursor:
            gaps.append((s - cursor, cursor))
        if e > cursor:
            busy_ns += e - max(s, cursor)
            cursor = e
    if t1_ns > cursor:
        gaps.append((t1_ns - cursor, cursor))
    gaps.sort(reverse=True)
    by_short = collections.defaultdict(float)
    for name, seconds in by_name.items():
        by_short[short_name(name)] += seconds
    ops = sorted(by_short.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": busy_ns * 1e-9,
        "window_s": (t1_ns - t0_ns) * 1e-9,
        "kernel_s": dict(by_name),
        "device_ops": [[name, seconds] for name, seconds in ops],
        "idle_gaps": [[_label(spans, start + length // 2), length * 1e-9] for length, start in gaps[:top]],
    }

