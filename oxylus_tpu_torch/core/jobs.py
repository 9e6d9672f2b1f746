"""Host-side job manager: worker pool, barriers, parallel-for (a copy of
`oxylus_tpu/core/jobs.py`).

Analog of `JobManager` (`Oxylus/include/Core/JobManager.hpp:131-253`). The per-frame
parallelism lives in the card's kernels; this pool serves the *host* side (asset
baking, IO, scene serialization), the work the reference offloads to its worker
threads. Includes the reference's `for_each` chunking policy (chunks = size /
(threads*4)) and a `JobTracker` exposing in-flight job names. A job runs on a worker
thread: one that touches a CUDA tensor must set the device (`torch.cuda.set_device`)
itself; the runner's tensors belong to the runner's thread.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Iterable, Sequence


class JobTracker:
    """Introspection over in-flight jobs (reference `JobTracker`,
    `JobManager.hpp:51-123`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._active: dict[int, str] = {}
        self._next = 1

    def begin(self, name: str) -> int:
        with self._lock:
            jid = self._next
            self._next += 1
            self._active[jid] = name
            return jid

    def end(self, jid: int) -> None:
        with self._lock:
            self._active.pop(jid, None)

    def active_jobs(self) -> list[str]:
        with self._lock:
            return list(self._active.values())


class Barrier:
    """Completion barrier over a set of futures (reference `Barrier` semantics)."""

    def __init__(self) -> None:
        self._futures: list[Future] = []

    def add(self, fut: Future) -> None:
        self._futures.append(fut)

    def wait(self) -> None:
        for f in self._futures:
            f.result()

    @property
    def pending(self) -> int:
        return sum(1 for f in self._futures if not f.done())


class JobManager:
    def __init__(self, workers: int | None = None) -> None:
        import os

        self.num_workers = workers or min(32, (os.cpu_count() or 4))
        self._pool: ThreadPoolExecutor | None = None
        self.tracker = JobTracker()

    def init(self) -> None:
        self._pool = ThreadPoolExecutor(max_workers=self.num_workers, thread_name_prefix="ox-job")

    def deinit(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def submit(self, fn: Callable[[], Any], name: str = "job", barrier: Barrier | None = None) -> Future:
        assert self._pool is not None, "JobManager not initialized"
        jid = self.tracker.begin(name)

        def run():
            try:
                return fn()
            finally:
                self.tracker.end(jid)

        fut = self._pool.submit(run)
        if barrier is not None:
            barrier.add(fut)
        return fut

    def for_each(self, items: Sequence, fn: Callable[[Any], Any], name: str = "for_each") -> list:
        """Parallel map with the reference's chunking (size / (workers*4) per chunk)."""
        n = len(items)
        if n == 0:
            return []
        chunk = max(1, n // (self.num_workers * 4))
        ranges = [(i, min(i + chunk, n)) for i in range(0, n, chunk)]
        out: list = [None] * n

        def run_range(lo_hi):
            lo, hi = lo_hi
            for i in range(lo, hi):
                out[i] = fn(items[i])

        barrier = Barrier()
        for r in ranges:
            self.submit(lambda r=r: run_range(r), name=name, barrier=barrier)
        barrier.wait()
        return out

    def for_each_async(self, items: Sequence, fn: Callable[[Any], Any], name: str = "for_each") -> Barrier:
        chunk = max(1, len(items) // (self.num_workers * 4))
        barrier = Barrier()
        for lo in range(0, len(items), chunk):
            hi = min(lo + chunk, len(items))

            def run_range(lo=lo, hi=hi):
                for i in range(lo, hi):
                    fn(items[i])

            self.submit(run_range, name=name, barrier=barrier)
        return barrier

    def wait(self) -> None:
        # drain: re-init pool after full shutdown
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers, thread_name_prefix="ox-job")
