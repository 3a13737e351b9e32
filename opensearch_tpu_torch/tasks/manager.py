"""Task management: registry, tree-wide cancellation, resource tracking.

Counterpart of opensearch_tpu/tasks/manager.py, a copy with its imports
rewritten (the reference's TaskManager.java, TaskCancellationService and
TaskResourceTrackingService). Every node-level operation that can run
long registers a task; a cancellable task polls ``ensure_not_cancelled``
at phase boundaries, the reference's cooperative model. On the card that
means before a kernel launch, never between a launch and its readback: a
launched kernel is not interruptible.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field as dc_field

from opensearch_tpu_torch.common.timeutil import epoch_millis

from opensearch_tpu_torch.common.errors import (
    ResourceNotFoundException,
    TaskCancelledException,
)


@dataclass
class Task:
    id: int
    action: str
    description: str = ""
    cancellable: bool = True
    parent_id: int = -1
    node: str = "node-0"
    start_time_millis: int = 0
    _start_perf: float = 0.0
    _start_thread_ns: int = 0
    _start_alloc: int = 0
    cancelled: bool = False
    cancellation_reason: str | None = None
    # resource tracking (TaskResourceTrackingService analog):
    # cpu_time_nanos = CPU consumed by the executing thread (thread_time,
    # not wall — a task blocked on IO accrues none); peak_alloc_bytes =
    # peak traced allocation delta while the task ran (real only when
    # tracemalloc is active, the ThreadMXBean-allocated-bytes stand-in);
    # thread_executions counts distinct enter/exit cycles
    cpu_time_nanos: int = 0
    peak_alloc_bytes: int = 0
    thread_executions: int = 0
    children: list[int] = dc_field(default_factory=list)

    def ensure_not_cancelled(self) -> None:
        if self.cancelled:
            raise TaskCancelledException(
                f"task [{self.id}] was cancelled"
                + (f": {self.cancellation_reason}" if self.cancellation_reason else "")
            )

    @property
    def running_time_nanos(self) -> int:
        return int((time.perf_counter() - self._start_perf) * 1e9)

    def resource_stats(self) -> dict:
        """The `resource_stats` section of _tasks?detailed
        (TaskResourceStats shape: total across executing threads)."""
        return {
            "total": {
                "cpu_time_in_nanos": self.cpu_time_nanos,
                "memory_in_bytes": self.peak_alloc_bytes,
            },
            "thread_info": {
                "thread_executions": self.thread_executions,
                "active_threads": 1,
            },
        }

    def to_dict(self) -> dict:
        return {
            "node": self.node,
            "id": self.id,
            "type": "transport",
            "action": self.action,
            "description": self.description,
            "start_time_in_millis": self.start_time_millis,
            "running_time_in_nanos": self.running_time_nanos,
            "cancellable": self.cancellable,
            "cancelled": self.cancelled,
            **({"parent_task_id": f"{self.node}:{self.parent_id}"}
               if self.parent_id >= 0 else {}),
        }


class TaskManager:
    """Thread-safe registry with parent->child cancellation fan-out."""

    def __init__(self, node_name: str = "node-0"):
        self._node = node_name
        self._seq = itertools.count(1)
        self._tasks: dict[int, Task] = {}
        self._completed_tasks: dict[int, Task] = {}
        self._lock = threading.Lock()
        # cumulative counters for stats
        self.completed = 0
        self.cancelled_count = 0

    def register(self, action: str, description: str = "",
                 cancellable: bool = True, parent_id: int = -1) -> Task:
        task = Task(
            id=next(self._seq),
            action=action,
            description=description,
            cancellable=cancellable,
            parent_id=parent_id,
            node=self._node,
            start_time_millis=epoch_millis(),
            _start_perf=time.perf_counter(),
        )
        with self._lock:
            self._tasks[task.id] = task
            parent = self._tasks.get(parent_id)
            if parent is not None:
                parent.children.append(task.id)
                # joining a cancelled tree: born cancelled (the ban-marker
                # behavior of TaskCancellationService)
                if parent.cancelled:
                    task.cancelled = True
                    task.cancellation_reason = parent.cancellation_reason
        return task

    # finished tasks retained for GET _tasks/{id} (the reference persists
    # results to the .tasks system index); bounded so long-lived nodes
    # don't accumulate
    _COMPLETED_CAP = 256

    def unregister(self, task: Task) -> None:
        with self._lock:
            self._tasks.pop(task.id, None)
            self.completed += 1
            self._completed_tasks[task.id] = task
            while len(self._completed_tasks) > self._COMPLETED_CAP:
                self._completed_tasks.pop(
                    next(iter(self._completed_tasks)))

    def get_any(self, task_id: int) -> tuple[Task, bool]:
        """(task, completed) — running tasks first, then the retained
        completed set; missing ids raise like get()."""
        with self._lock:
            task = self._tasks.get(task_id)
            if task is not None:
                return task, False
            task = self._completed_tasks.get(task_id)
            if task is not None:
                return task, True
        raise ResourceNotFoundException(
            f"task [{self._node}:{task_id}] not found")

    def get(self, task_id: int) -> Task:
        task = self._tasks.get(task_id)
        if task is None:
            raise ResourceNotFoundException(f"task [{self._node}:{task_id}] not found")
        return task

    def cancel(self, task_id: int, reason: str = "by user request") -> list[int]:
        """Cancel a task and its whole subtree; returns cancelled ids."""
        with self._lock:
            root = self._tasks.get(task_id)
            if root is None:
                raise ResourceNotFoundException(
                    f"task [{self._node}:{task_id}] not found"
                )
            if not root.cancellable:
                from opensearch_tpu_torch.common.errors import IllegalArgumentException

                raise IllegalArgumentException(
                    f"task [{task_id}] is not cancellable"
                )
            out: list[int] = []
            stack = [task_id]
            while stack:
                tid = stack.pop()
                t = self._tasks.get(tid)
                if t is None or t.cancelled:
                    continue
                t.cancelled = True
                t.cancellation_reason = reason
                out.append(tid)
                stack.extend(t.children)
            self.cancelled_count += len(out)
            return out

    def cancel_matching(self, actions: str | None = None,
                        reason: str = "by user request") -> list[int]:
        import fnmatch

        with self._lock:
            roots = [
                t.id for t in self._tasks.values()
                if t.cancellable and not t.cancelled
                and (actions is None or any(
                    fnmatch.fnmatch(t.action, p) for p in actions.split(",")
                ))
            ]
        out: list[int] = []
        for tid in roots:
            try:
                out.extend(self.cancel(tid, reason))
            except ResourceNotFoundException:
                pass
        return out

    def list_tasks(self, actions: str | None = None) -> list[Task]:
        import fnmatch

        with self._lock:
            tasks = list(self._tasks.values())
        if actions:
            patterns = actions.split(",")
            tasks = [
                t for t in tasks
                if any(fnmatch.fnmatch(t.action, p) for p in patterns)
            ]
        return sorted(tasks, key=lambda t: t.id)

    def task_scope(self, action: str, description: str = "",
                   cancellable: bool = True, parent_id: int = -1):
        """Context manager: register on enter, unregister on exit, with
        resource tracking (CPU thread-time + peak allocation delta) over
        the scope — the TaskResourceTrackingService sampling, collapsed to
        enter/exit because handlers run a task on one worker thread."""
        manager = self

        class _Scope:
            def __enter__(self):
                self.task = manager.register(
                    action, description, cancellable, parent_id
                )
                self.task._start_thread_ns = time.thread_time_ns()
                self.task._start_alloc = _traced_alloc()
                return self.task

            def __exit__(self, exc_type, exc, tb):
                self.task.cpu_time_nanos += max(
                    time.thread_time_ns() - self.task._start_thread_ns, 0
                )
                alloc = _traced_alloc()
                if alloc > self.task._start_alloc:
                    self.task.peak_alloc_bytes = max(
                        self.task.peak_alloc_bytes,
                        alloc - self.task._start_alloc,
                    )
                self.task.thread_executions += 1
                manager.unregister(self.task)
                return False

        return _Scope()


def _traced_alloc() -> int:
    """Peak traced bytes when tracemalloc is active, else 0 — per-task
    allocation accounting has no cheap always-on source in CPython."""
    import tracemalloc

    if not tracemalloc.is_tracing():
        return 0
    return tracemalloc.get_traced_memory()[1]
