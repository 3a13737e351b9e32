"""Search backpressure: admission control + overrun cancellation.

Counterpart of opensearch_tpu/search/backpressure.py, a copy with its
imports rewritten (the reference's SearchBackpressureService and its
admission-control package). Single-node model: a concurrency gate sheds
load at admission (429) and a reaper cancels searches that exceed the
runtime budget, through the task manager's cooperative cancellation.
"""

from __future__ import annotations

import threading

from opensearch_tpu_torch.common.errors import (
    RejectedExecutionException,
    ResourceNotFoundException,
)

DEFAULT_MAX_CONCURRENT = 256
DEFAULT_MAX_RUNTIME_MS = 60_000
SEARCH_ACTION = "indices:data/read/search"


class SearchBackpressureService:
    def __init__(self, task_manager, max_concurrent: int = DEFAULT_MAX_CONCURRENT,
                 max_runtime_ms: int = DEFAULT_MAX_RUNTIME_MS):
        self._tasks = task_manager
        self.max_concurrent = max_concurrent
        self.max_runtime_ms = max_runtime_ms
        # admit() runs on every searching thread at once (the parallel
        # search pool, the data worker's scroll/PIT path, and the http
        # search pool all call it); the counters are read-modify-write
        self._stats_lock = threading.Lock()
        self.rejections = 0
        self.cancellations = 0

    def _active_searches(self):
        return [
            t for t in self._tasks.list_tasks(SEARCH_ACTION) if not t.cancelled
        ]

    def admit(self) -> None:
        """Called before registering a new search task."""
        if len(self._active_searches()) >= self.max_concurrent:
            # before shedding, try to reclaim capacity from overrunners
            if not self.cancel_overrunning():
                with self._stats_lock:
                    self.rejections += 1
                raise RejectedExecutionException(
                    "rejected execution of search: node search capacity "
                    f"saturated [{self.max_concurrent} concurrent searches]"
                )

    def cancel_overrunning(self) -> list[int]:
        """Cancel searches past the runtime budget (worst offender first)."""
        overrunners = sorted(
            (
                t for t in self._active_searches()
                if t.running_time_nanos > self.max_runtime_ms * 1_000_000
            ),
            key=lambda t: -t.running_time_nanos,
        )
        cancelled: list[int] = []
        for t in overrunners:
            try:
                cancelled.extend(self._tasks.cancel(
                    t.id,
                    reason="elapsed time exceeded the search backpressure budget",
                ))
            except ResourceNotFoundException:
                pass  # finished between list and cancel: capacity freed anyway
        with self._stats_lock:
            self.cancellations += len(cancelled)
        return cancelled

    def stats(self) -> dict:
        with self._stats_lock:
            rejections, cancellations = self.rejections, self.cancellations
        return {
            "mode": "enforced",
            "active_searches": len(self._active_searches()),
            "limits": {
                "max_concurrent": self.max_concurrent,
                "max_runtime_ms": self.max_runtime_ms,
            },
            "rejections": rejections,
            "cancellations": cancellations,
        }
