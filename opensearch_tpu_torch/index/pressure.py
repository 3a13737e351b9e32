"""Bounded-queue admission control for the kNN dispatch batcher.

Counterpart of opensearch_tpu/index/pressure.py, for the part the port
runs: :class:`QueuePressure`. ``IndexingPressure`` (the write-path byte
budget) is not ported yet.
"""

from __future__ import annotations

import threading

from opensearch_tpu_torch.common.errors import RejectedExecutionException


class QueuePressure:
    """Slot budgets that reject instead of letting a queue grow without
    bound: producers acquire one slot per queued item and release it when
    the item is dequeued, so `current` is the live queue depth and the
    limit is the hard bound the queue can never exceed. Crossing it raises
    RejectedExecutionException (HTTP 429)."""

    def __init__(self, limit: int, operation: str = "queued work"):
        self.limit = int(limit)
        self.operation = operation
        self.current = 0
        self.total = 0
        self.rejections = 0
        self._lock = threading.Lock()

    def acquire(self, n: int = 1) -> None:
        with self._lock:
            if self.current + n > self.limit:
                self.rejections += 1
                raise RejectedExecutionException(
                    f"rejected execution of {self.operation}: queue depth "
                    f"[{self.current + n}] would exceed the bound "
                    f"[{self.limit}]"
                )
            self.current += n
            self.total += n

    def release(self, n: int = 1) -> None:
        with self._lock:
            self.current = max(0, self.current - n)

    def set_limit(self, limit: int) -> None:
        with self._lock:
            self.limit = int(limit)

    def stats(self) -> dict:
        with self._lock:  # the three counters must snapshot consistently
            return {
                "current": self.current,
                "total": self.total,
                "rejections": self.rejections,
                "limit": self.limit,
            }
