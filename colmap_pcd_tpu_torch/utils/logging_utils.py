"""Logging and the port's one trace, PHASES (replaces the glog wrappers of
util/logging.{h,cc} and the ad-hoc util/timer.h Timers)."""

from __future__ import annotations

import logging
import sys
import threading
import time


def init_logging(level: str = "INFO", to_stderr: bool = True):
    logging.basicConfig(
        stream=sys.stderr if to_stderr else sys.stdout,
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(levelname).1s%(asctime)s %(name)s] %(message)s",
        datefmt="%m%d %H:%M:%S",
    )


class PhaseTimer:
    """Named spans and counters of the whole process (the replacement
    SURVEY.md §5.1 calls for: the reference sprinkles ad-hoc Timers; here
    every timed section is one named span).

    `totals[name]` sums a span's seconds and `counts[name]` its calls; a
    counter (`count`) adds to `counts` alone. Both are exact under threads.
    Spans read `time.perf_counter_ns()`. Between `start_recording()` and
    `stop_recording()` every span is also kept as an interval with its
    parent (the innermost span open on its thread) and its thread. With
    recording off a span costs two clock reads, one attribute test and the
    locked update of the two dicts. No span synchronises the device."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._lock = threading.Lock()
        # while recording: [name, start_ns, end_ns or None, parent, thread] per span, in opening order
        self._recorded: list | None = None
        self._local = threading.local()

    def phase(self, name: str):
        return _Phase(self, name)

    def count(self, name: str, n: int = 1):
        """Add `n` to the counter `name`."""
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def reset(self):
        """Forget every total and count (recording goes on as it was)."""
        with self._lock:
            self.totals.clear()
            self.counts.clear()

    def start_recording(self):
        """Keep the intervals of the spans that open from now on."""
        self._recorded = []

    def stop_recording(self) -> list[tuple[str, int, int, int, int]]:
        """The spans opened and closed since `start_recording`, in opening
        order, each as (name, start_ns, end_ns, parent, thread): `parent` is
        the index in this list of the innermost span open on the same
        thread when it opened, or -1; `thread` is `threading.get_ident()`.
        Spans still open are left out."""
        recorded, self._recorded = self._recorded, None
        if recorded is None:
            return []
        with self._lock:
            entries = list(recorded)
        index, out = {}, []
        for old, (name, start, end, parent, thread) in enumerate(entries):
            if end is not None:
                index[old] = len(out)
                out.append((name, start, end, index.get(parent, -1), thread))
        return out

    def report(self) -> str:
        """One line a span (seconds, calls), longest first; then the
        counters."""
        with self._lock:
            totals, counts = dict(self.totals), dict(self.counts)
        lines = [f"  {k:<30s} {totals[k]:8.3f}s  x{counts.get(k, 0)}"
                 for k in sorted(totals, key=lambda k: -totals[k])]
        counters = sorted(k for k in counts if k not in totals)
        if counters:
            lines.append("  counters:")
            lines += [f"  {k:<30s} {counts[k]:>9d}" for k in counters]
        return "\n".join(lines)


class _Phase:
    __slots__ = ("pt", "name", "t0", "entry")

    def __init__(self, pt: PhaseTimer, name: str):
        self.pt = pt
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        recorded = self.pt._recorded
        self.entry = None if recorded is None else self._open(recorded)
        return self

    def _open(self, recorded: list) -> list:
        """Record this span's opening: its parent is the innermost span of
        the same recording still open on this thread."""
        stack = getattr(self.pt._local, "stack", None)
        if stack is None:
            stack = self.pt._local.stack = []
        parent = stack[-1][1] if stack and stack[-1][0] is recorded else -1
        entry = [self.name, self.t0, None, parent, threading.get_ident()]
        with self.pt._lock:
            stack.append((recorded, len(recorded)))
            recorded.append(entry)
        return entry

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        pt, name = self.pt, self.name
        with pt._lock:
            pt.totals[name] = pt.totals.get(name, 0.0) + (t1 - self.t0) * 1e-9
            pt.counts[name] = pt.counts.get(name, 0) + 1
        if self.entry is not None:
            self.entry[2] = t1
            pt._local.stack.pop()
        return False


# process-global spans and counters (SURVEY.md §5.1); controllers, the
# mapper, the front end and the benchmark all use this one instance
PHASES = PhaseTimer()
