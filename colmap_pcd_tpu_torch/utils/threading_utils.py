"""Host-side pipeline runtime: a bounded job queue, a staged pipeline and a
controllable thread wrapper.

Carried from colmap_pcd_tpu/utils/threading_utils.py (parity with
src/util/threading.{h,cc} JobQueue): the feature-extraction pipeline's
read -> extract -> write stages (feature/extraction.h:50-148) map onto
`pipeline_map`, with the device-facing stage single-threaded and the IO
stage fanned out. `ControllableThread` is the Thread protocol
(threading.h:99-139).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable

_STOP = object()


class _ProducerError:
    """Sentinel carrying an exception from an IO producer to the main thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class JobQueue:
    """Bounded MPMC queue with push/pop/wait semantics (threading.h:261)."""

    def __init__(self, max_size: int = 0):
        self.q: queue.Queue = queue.Queue(maxsize=max_size)
        self._stopped = threading.Event()

    def push(self, item) -> bool:
        if self._stopped.is_set():
            return False
        self.q.put(item)
        return True

    def pop(self):
        item = self.q.get()
        if item is _STOP:
            return None
        return item

    def stop(self):
        self._stopped.set()
        self.q.put(_STOP)

    def wait(self):
        self.q.join()


class ControllableThread:
    """Start/Stop/Pause/Resume/Wait + callbacks (threading.h:99-139): the
    protocol controllers expose so a UI or a calling program can manage them. The
    target receives the thread and polls `is_stopped` / `block_if_paused`."""

    def __init__(self, target: Callable[["ControllableThread"], Any]):
        self._target = target
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._pause = threading.Event()
        self._resume = threading.Event()
        self._resume.set()
        self.callbacks: dict[str, list[Callable]] = {}

    def add_callback(self, name: str, fn: Callable):
        self.callbacks.setdefault(name, []).append(fn)

    def callback(self, name: str, *args):
        for fn in self.callbacks.get(name, []):
            fn(*args)

    def start(self):
        self._thread = threading.Thread(target=self._target, args=(self,), daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._resume.set()

    def pause(self):
        self._resume.clear()
        self._pause.set()

    def resume(self):
        self._pause.clear()
        self._resume.set()

    def wait(self):
        if self._thread is not None:
            self._thread.join()

    def is_stopped(self) -> bool:
        return self._stop.is_set()

    def block_if_paused(self):
        self._resume.wait()


def pipeline_map(
    items: Iterable,
    produce: Callable,
    consume: Callable,
    device_stage: Callable,
    num_io_threads: int = 4,
    queue_size: int = 8,
):
    """read(parallel) -> device(serial) -> write(serial) staged pipeline.

    `produce(item)` runs on IO threads, `device_stage(item, produced)` on the
    caller thread (one device stream, overlapped with IO), `consume(item,
    result)` on a single writer thread (e.g. SQLite, which wants one writer:
    the topology of SiftFeatureExtractor's resizer/extractor/writer stages).
    """
    items = list(items)
    produced: dict[int, Any] = {}
    lock = threading.Condition()

    def producer(idx_item):
        # a raising produce() (corrupt image, unreadable file) must still
        # publish SOMETHING, or the main thread waits on `lock` forever:
        # store the exception as the produced value and re-raise it there
        idx, item = idx_item
        try:
            out = produce(item)
        except BaseException as e:  # noqa: BLE001: surfaced on the main thread
            out = _ProducerError(e)
        with lock:
            produced[idx] = out
            lock.notify_all()

    results_q: JobQueue = JobQueue(queue_size)
    write_done = threading.Event()
    errors: list[BaseException] = []

    def writer():
        try:
            while True:
                got = results_q.pop()
                if got is None:
                    break
                consume(*got)
        except BaseException as e:  # surfaced at the end
            errors.append(e)
        finally:
            write_done.set()

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    with ThreadPoolExecutor(max_workers=num_io_threads) as ex:
        futs = [ex.submit(producer, (i, it)) for i, it in enumerate(items)]
        for i, item in enumerate(items):
            with lock:
                while i not in produced:
                    lock.wait()
                data = produced.pop(i)
            if isinstance(data, _ProducerError):
                results_q.stop()
                write_done.wait()
                raise data.exc
            res = device_stage(item, data)
            # a writer that died leaves the bounded queue full for ever:
            # push with a timeout and surface its error instead of blocking
            while True:
                if write_done.is_set():
                    raise errors[0]
                try:
                    results_q.q.put((item, res), timeout=0.5)
                    break
                except queue.Full:
                    continue
        for f in futs:
            f.result()
    results_q.stop()
    write_done.wait()
    if errors:
        raise errors[0]
