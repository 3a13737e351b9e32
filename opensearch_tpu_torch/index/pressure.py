"""Bounded-queue admission control for the kNN dispatch batcher, and
indexing pressure.

Counterpart of opensearch_tpu/index/pressure.py: :class:`QueuePressure`
and the write path's byte budget, :class:`IndexingPressure`, whose
counters are the `indexing_pressure` section of `_nodes/stats`.
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


DEFAULT_LIMIT_BYTES = 512 << 20  # 10% of a 5G budget, reference default style


class IndexingPressure:
    def __init__(self, limit_bytes: int = DEFAULT_LIMIT_BYTES):
        self.limit = int(limit_bytes)
        self.current_bytes = 0
        self.total_bytes = 0
        self.rejections = 0
        self._lock = threading.Lock()

    def acquire(self, bytes_: int, operation: str = "indexing") -> "_Release":
        bytes_ = int(bytes_)
        with self._lock:
            if self.current_bytes + bytes_ > self.limit:
                self.rejections += 1
                raise RejectedExecutionException(
                    f"rejected execution of {operation} operation "
                    f"[coordinating_and_primary_bytes="
                    f"{self.current_bytes + bytes_}, "
                    f"max_coordinating_and_primary_bytes={self.limit}]"
                )
            self.current_bytes += bytes_
            self.total_bytes += bytes_
        return _Release(self, bytes_)

    def _release(self, bytes_: int) -> None:
        with self._lock:
            self.current_bytes = max(0, self.current_bytes - bytes_)

    def stats(self) -> dict:
        # snapshot under the lock acquire()/_release() hold: the three
        # counters must be mutually consistent in one stats read
        with self._lock:
            current = self.current_bytes
            total = self.total_bytes
            rejections = self.rejections
        return {
            "memory": {
                "current": {
                    "combined_coordinating_and_primary_in_bytes": current,
                    "coordinating_in_bytes": current,
                    "primary_in_bytes": 0,
                    "replica_in_bytes": 0,
                    "all_in_bytes": current,
                },
                "total": {
                    "combined_coordinating_and_primary_in_bytes": total,
                    "coordinating_in_bytes": total,
                    "primary_in_bytes": 0,
                    "replica_in_bytes": 0,
                    "all_in_bytes": total,
                    "coordinating_rejections": rejections,
                    "primary_rejections": 0,
                    "replica_rejections": 0,
                },
                "limit_in_bytes": self.limit,
            }
        }


class _Release:
    def __init__(self, pressure: IndexingPressure, bytes_: int):
        self._pressure = pressure
        self._bytes = bytes_

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def close(self) -> None:
        if self._pressure is not None:
            self._pressure._release(self._bytes)
            self._pressure = None
