"""Logging + timing (replaces glog wrappers util/logging.{h,cc} and
util/timer.h Timer)."""

from __future__ import annotations

import logging
import sys
import time


def init_logging(level: str = "INFO", to_stderr: bool = True):
    logging.basicConfig(
        stream=sys.stderr if to_stderr else sys.stdout,
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(levelname).1s%(asctime)s %(name)s] %(message)s",
        datefmt="%m%d %H:%M:%S",
    )


class Timer:
    """Start/pause/resume/elapsed parity with util/timer.h:39."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._start = None
        self._accum = 0.0

    def start(self):
        if self._start is None:
            self._start = time.time()

    def restart(self):
        self.reset()
        self.start()

    def pause(self):
        if self._start is not None:
            self._accum += time.time() - self._start
            self._start = None

    def resume(self):
        self.start()

    def elapsed_seconds(self) -> float:
        cur = time.time() - self._start if self._start is not None else 0.0
        return self._accum + cur

    def elapsed_minutes(self) -> float:
        return self.elapsed_seconds() / 60.0

    def print_seconds(self, label: str = "Elapsed time"):
        print(f"{label}: {self.elapsed_seconds():.3f} [seconds]")

    def print_minutes(self, label: str = "Elapsed time"):
        print(f"{label}: {self.elapsed_minutes():.3f} [minutes]")


class PhaseTimer:
    """Structured per-phase timing (the replacement SURVEY.md §5.1 calls for:
    the reference sprinkles ad-hoc Timers; we accumulate named phases)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def phase(self, name: str):
        return _Phase(self, name)

    def report(self) -> str:
        lines = []
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            lines.append(
                f"  {k:<30s} {self.totals[k]:8.3f}s  x{self.counts[k]}"
            )
        return "\n".join(lines)


class _Phase:
    def __init__(self, pt: PhaseTimer, name: str):
        self.pt = pt
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *a):
        dt = time.time() - self.t0
        self.pt.totals[self.name] = self.pt.totals.get(self.name, 0.0) + dt
        self.pt.counts[self.name] = self.pt.counts.get(self.name, 0) + 1


# process-global phase accounting (SURVEY.md §5.1); controllers and the
# mapper both record into this one instance, bench.py prints the report
PHASES = PhaseTimer()
