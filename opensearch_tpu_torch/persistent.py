"""Persistent tasks: cluster-state tasks that survive restarts.

Counterpart of opensearch_tpu/persistent.py, a host copy with its own
executor registry.

The analog of the reference's persistent-task framework
(server/src/main/java/org/opensearch/persistent/ —
PersistentTasksService, PersistentTasksCustomMetadata,
PersistentTasksNodeService + AllocatedPersistentTask): a task is
registered durably BEFORE it runs, assigned to a node, executed by a
registered executor, and — critically — REASSIGNED and restarted if its
node dies mid-flight. In this single-process engine the durable metadata
lives in `persistent_tasks.json`; a process restart replays every
incomplete task through its executor (the reassignment path collapsed to
"the one node came back").
"""

from __future__ import annotations

import json
import threading
import uuid
from pathlib import Path
from typing import Any, Callable

from opensearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    ResourceNotFoundException,
)

# task_name -> executor(params, task_api) run on assignment; registered by
# subsystems at import time (the PersistentTasksExecutor registry)
_EXECUTORS: dict[str, Callable[[dict, "AllocatedTask"], None]] = {}


def register_executor(task_name: str,
                      fn: Callable[[dict, "AllocatedTask"], None]) -> None:
    _EXECUTORS[task_name] = fn


class AllocatedTask:
    """Handle the executor uses to report progress/completion
    (AllocatedPersistentTask.updatePersistentTaskState/markAsCompleted)."""

    def __init__(self, service: "PersistentTasksService", task_id: str):
        self._service = service
        self.task_id = task_id

    def update_state(self, state: dict) -> None:
        self._service._update(self.task_id, state=state)

    def complete(self) -> None:
        self._service.complete(self.task_id)

    def fail(self, reason: str) -> None:
        self._service._update(self.task_id, failure=reason)


class PersistentTasksService:
    def __init__(self, path: Path):
        self._file = Path(path)
        self._lock = threading.Lock()
        self.tasks: dict[str, dict] = {}
        if self._file.exists():
            self.tasks = json.loads(self._file.read_text())

    def _save(self) -> None:
        self._file.parent.mkdir(parents=True, exist_ok=True)
        self._file.write_text(json.dumps(self.tasks))

    # -- lifecycle ---------------------------------------------------------

    def start(self, task_name: str, params: dict | None = None) -> str:
        """Durably register, then execute (sendStartRequest: the metadata
        write precedes the node-side start, so a crash between the two
        still resumes the task on recovery)."""
        if task_name not in _EXECUTORS:
            raise IllegalArgumentException(
                f"no persistent task executor registered for [{task_name}]"
            )
        task_id = uuid.uuid4().hex[:20]
        with self._lock:
            self.tasks[task_id] = {
                "id": task_id,
                "task_name": task_name,
                "params": params or {},
                "state": None,
                "status": "started",
                "failure": None,
            }
            self._save()
        self._run(task_id)
        return task_id

    def _run(self, task_id: str) -> None:
        task = self.tasks[task_id]
        fn = _EXECUTORS.get(task["task_name"])
        if fn is None:
            return  # executor not registered in this process: stays pending
        try:
            fn(task["params"], AllocatedTask(self, task_id))
        except Exception as e:  # noqa: BLE001 - executor failures are recorded
            self._update(task_id, failure=f"{type(e).__name__}: {e}")

    def resume_incomplete(self) -> int:
        """Replay every non-completed task (PersistentTasksNodeService's
        startTask on cluster-state application after restart)."""
        with self._lock:
            pending = [
                tid for tid, t in self.tasks.items()
                if t["status"] == "started" and t["task_name"] in _EXECUTORS
            ]
        for tid in pending:
            self._run(tid)
        return len(pending)

    def complete(self, task_id: str) -> None:
        with self._lock:
            if task_id not in self.tasks:
                raise ResourceNotFoundException(
                    f"persistent task [{task_id}] not found"
                )
            self.tasks[task_id]["status"] = "completed"
            self._save()

    def remove(self, task_id: str) -> None:
        with self._lock:
            if task_id not in self.tasks:
                raise ResourceNotFoundException(
                    f"persistent task [{task_id}] not found"
                )
            del self.tasks[task_id]
            self._save()

    def _update(self, task_id: str, state: dict | None = None,
                failure: str | None = None) -> None:
        with self._lock:
            task = self.tasks.get(task_id)
            if task is None:
                return
            if state is not None:
                task["state"] = state
            if failure is not None:
                task["failure"] = failure
                task["status"] = "failed"
            self._save()

    def get(self, task_id: str) -> dict:
        task = self.tasks.get(task_id)
        if task is None:
            raise ResourceNotFoundException(
                f"persistent task [{task_id}] not found"
            )
        return dict(task)

    def list(self) -> list[dict]:
        with self._lock:
            return [dict(t) for t in self.tasks.values()]
