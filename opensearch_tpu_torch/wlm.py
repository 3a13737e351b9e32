"""Workload management: query groups with resource limits.

Counterpart of opensearch_tpu/wlm.py, a copy with its imports rewritten
(the reference's wlm package: QueryGroupService and the query-group CRUD
of the workload-management plugin). Named groups carry resource_limits;
requests tagged with a group id are tracked and rejected when the group
exceeds its share: in-flight search concurrency against the cpu share,
in-flight bulk requests against the memory share.
"""

from __future__ import annotations

import json
import threading
import uuid
from pathlib import Path
from typing import Any, Callable

from opensearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    RejectedExecutionException,
    ResourceNotFoundException,
)

# one process-wide concurrency budget the cpu shares divide up
TOTAL_SEARCH_PERMITS = 64

# bulk admission budget: in-flight bulk REQUESTS a group may hold open at
# once. Shares of this pool are carved by the group's memory (else cpu)
# resource limit and enforced through index/pressure.QueuePressure — the
# same bound-and-shed contract as IndexingPressure (429 instead of an
# unbounded queue), so a bulk flood tagged to a group sheds at its share
# before it can starve interactive search traffic.
TOTAL_BULK_SLOTS = 64

# search admission budget (the bulk twin): in-flight SEARCH
# requests a group may hold open across the cluster fan-out. Shares carve
# by the group's cpu (else memory) limit; enforced groups shed 429 BEFORE
# the coordinator fans out — a tagged search flood burns no transport/
# device work past its share.
TOTAL_SEARCH_SLOTS = 64


class QueryGroupService:
    """Query group registry + per-group admission control."""

    def __init__(self, path: Path):
        self._file = Path(path)
        self._lock = threading.Lock()
        self.groups: dict[str, dict] = {}
        if self._file.exists():
            self.groups = json.loads(self._file.read_text())
        self._in_flight: dict[str, int] = {}
        # per-group bulk/search slot budgets (QueuePressure), built lazily
        # for enforced groups — see admit_bulk / admit_search
        self._bulk_pressure: dict[str, Any] = {}
        self._search_pressure: dict[str, Any] = {}
        # lifetime counters per group (WlmStats.WorkloadGroupStats);
        # untagged requests account to the default group like the reference
        self._totals: dict[str, dict[str, int]] = {}

    DEFAULT_GROUP = "DEFAULT_WORKLOAD_GROUP"

    def _tally(self, gid: str | None, key: str) -> None:
        with self._lock:
            t = self._totals.setdefault(gid or self.DEFAULT_GROUP, {
                "total_completions": 0, "total_rejections": 0,
                "total_cancellations": 0,
            })
            t[key] += 1

    def totals(self) -> dict[str, dict[str, int]]:
        """Per-group lifetime counters; always includes the default group
        and every registered group."""
        with self._lock:
            out: dict[str, dict[str, int]] = {}
            zero = {"total_completions": 0, "total_rejections": 0,
                    "total_cancellations": 0}
            for gid in [self.DEFAULT_GROUP, *self.groups]:
                out[gid] = dict(self._totals.get(gid, zero))
            for gid, t in self._totals.items():
                out.setdefault(gid, dict(t))
            return out

    def _save(self) -> None:
        self._file.parent.mkdir(parents=True, exist_ok=True)
        self._file.write_text(json.dumps(self.groups))

    # -- CRUD (plugins/workload-management REST surface) -------------------

    def put(self, body: dict) -> dict:
        body = body or {}
        name = body.get("name")
        if not name:
            raise IllegalArgumentException("query group requires [name]")
        mode = body.get("resiliency_mode", "soft")
        if mode not in ("soft", "enforced", "monitor"):
            raise IllegalArgumentException(
                f"invalid resiliency_mode [{mode}]"
            )
        limits = body.get("resource_limits") or {}
        for key, value in limits.items():
            if key not in ("cpu", "memory"):
                raise IllegalArgumentException(
                    f"unknown resource [{key}] in resource_limits"
                )
            v = float(value)
            if not 0.0 < v <= 1.0:
                raise IllegalArgumentException(
                    f"resource_limits.{key} must be in (0, 1]"
                )
        with self._lock:
            existing = next(
                (g for g in self.groups.values() if g["name"] == name), None
            )
            if existing is not None:
                existing.update(
                    {"resiliency_mode": mode, "resource_limits": limits}
                )
                self._save()
                return {"query_group": dict(existing)}
            gid = uuid.uuid4().hex[:20]
            group = {
                "_id": gid,
                "name": name,
                "resiliency_mode": mode,
                "resource_limits": limits,
                "updated_at": 0,
            }
            self.groups[gid] = group
            self._save()
            return {"query_group": dict(group)}

    def get(self, name: str | None = None) -> dict:
        with self._lock:
            groups = list(self.groups.values())
        if name:
            groups = [g for g in groups if g["name"] == name]
            if not groups:
                raise ResourceNotFoundException(
                    f"no query group exists with name [{name}]"
                )
        return {"query_groups": groups}

    def delete(self, name: str) -> dict:
        with self._lock:
            gid = next((i for i, g in self.groups.items()
                        if g["name"] == name), None)
            if gid is None:
                raise ResourceNotFoundException(
                    f"no query group exists with name [{name}]"
                )
            del self.groups[gid]
            # the slot budgets die with the group — a re-created group
            # gets a fresh _id, so a kept entry would be an unbounded
            # ghost in bulk_stats/search_slot_stats (TPU009's
            # bound-or-evict contract)
            self._bulk_pressure.pop(gid, None)
            self._search_pressure.pop(gid, None)
            self._save()
        return {"acknowledged": True}

    # -- admission (QueryGroupService.rejectIfNeeded) ----------------------

    def admit(self, group_id: str | None):
        """Context manager guarding one search on behalf of `group_id` —
        the SINGLE-NODE in-process concurrency check (TpuNode.search):
        in-flight count against the cpu share of TOTAL_SEARCH_PERMITS.
        The cluster fan-out path uses :meth:`admit_search` instead (the
        QueuePressure slot budget taken BEFORE any transport work); the
        two guard different execution models by design and keep separate
        books — see admit_search's docstring."""
        return _Admission(self, group_id)

    # -- bulk admission (QueuePressure-backed slot budget) ------------------

    def _resolve(self, group_id: str | None) -> dict | None:
        with self._lock:
            return self.groups.get(group_id) or next(
                (g for g in self.groups.values()
                 if g["name"] == group_id), None
            )

    def _bulk_pressure_for(self, group: dict):
        """Lazily build (and resize on limit change) the group's bulk slot
        budget. Only `enforced` groups shed; soft/monitor run unconstrained
        (the reference's resiliency-mode contract)."""
        from opensearch_tpu_torch.index.pressure import QueuePressure

        limits = group.get("resource_limits") or {}
        share = limits.get("memory", limits.get("cpu"))
        if group.get("resiliency_mode") != "enforced" or share is None:
            return None
        slots = max(1, int(TOTAL_BULK_SLOTS * float(share)))
        with self._lock:
            p = self._bulk_pressure.get(group["_id"])
            if p is None:
                p = self._bulk_pressure[group["_id"]] = QueuePressure(
                    slots, operation=f"bulk [{group['name']}]"
                )
            elif p.limit != slots:
                p.set_limit(slots)
        return p

    def admit_bulk(self, group_id: str | None) -> "Callable[[], None]":
        """Admit one bulk request for `group_id`; returns the release
        callable. Raises RejectedExecutionException (HTTP 429) when the
        group is past its slot share — the caller must shed, not queue."""
        group = self._resolve(group_id) if group_id else None
        if group is None:
            return lambda: None
        pressure = self._bulk_pressure_for(group)
        if pressure is None:
            return lambda: None
        try:
            pressure.acquire()
        except RejectedExecutionException:
            self._tally(group["_id"], "total_rejections")
            raise
        released = [False]

        def release() -> None:
            if not released[0]:
                released[0] = True
                pressure.release()

        return release

    def bulk_stats(self) -> dict:
        with self._lock:
            pressures = dict(self._bulk_pressure)
        return {
            gid: p.stats() for gid, p in pressures.items()
        }

    # -- search admission (QueuePressure-backed slot budget) ------

    def _search_pressure_for(self, group: dict):
        """Lazily build (and resize on limit change) the group's search
        slot budget — the bulk twin, carved by the cpu (else memory)
        share. Only `enforced` groups shed; soft/monitor run
        unconstrained."""
        from opensearch_tpu_torch.index.pressure import QueuePressure

        limits = group.get("resource_limits") or {}
        share = limits.get("cpu", limits.get("memory"))
        if group.get("resiliency_mode") != "enforced" or share is None:
            return None
        slots = max(1, int(TOTAL_SEARCH_SLOTS * float(share)))
        with self._lock:
            p = self._search_pressure.get(group["_id"])
            if p is None:
                p = self._search_pressure[group["_id"]] = QueuePressure(
                    slots, operation=f"search [{group['name']}]"
                )
            elif p.limit != slots:
                p.set_limit(slots)
        return p

    def admit_search(self, group_id: str | None) -> "Callable[[], None]":
        """Admit one search on behalf of `group_id` BEFORE the coordinator
        fans out; returns the release callable (idempotent — completion
        paths may overlap under degradation). Raises
        RejectedExecutionException (HTTP 429) past the group's slot share:
        the caller must shed, never queue.

        This is the CLUSTER-path guard (ClusterNode.search / facade) —
        a slot covers the whole distributed operation including its
        transport legs, so it must be a held-until-callback budget, not
        the with-statement concurrency check :meth:`admit` applies on the
        single-node synchronous path. Shares deliberately resolve
        cpu-else-memory (search is compute-shaped) where the bulk twin
        resolves memory-else-cpu; rejections from either book land in
        the group's total_rejections tally."""
        group = self._resolve(group_id) if group_id else None
        if group is None:
            return lambda: None
        pressure = self._search_pressure_for(group)
        if pressure is None:
            return lambda: None
        try:
            pressure.acquire()
        except RejectedExecutionException:
            self._tally(group["_id"], "total_rejections")
            raise
        released = [False]

        def release() -> None:
            if not released[0]:
                released[0] = True
                pressure.release()

        return release

    def search_slot_stats(self) -> dict:
        with self._lock:
            pressures = dict(self._search_pressure)
        return {
            gid: p.stats() for gid, p in pressures.items()
        }

    def _try_enter(self, group_id: str | None) -> str | None:
        if not group_id:
            return None
        with self._lock:
            group = self.groups.get(group_id) or next(
                (g for g in self.groups.values()
                 if g["name"] == group_id), None
            )
            if group is None:
                return None  # untagged/unknown groups run unconstrained
            gid = group["_id"]
            if group.get("resiliency_mode") == "enforced":
                cpu_share = float(
                    (group.get("resource_limits") or {}).get("cpu", 1.0)
                )
                permits = max(1, int(TOTAL_SEARCH_PERMITS * cpu_share))
                if self._in_flight.get(gid, 0) >= permits:
                    t = self._totals.setdefault(gid, {
                        "total_completions": 0, "total_rejections": 0,
                        "total_cancellations": 0,
                    })
                    t["total_rejections"] += 1
                    raise RejectedExecutionException(
                        f"query group [{group['name']}] is at its cpu "
                        f"limit: {permits} concurrent searches"
                    )
            self._in_flight[gid] = self._in_flight.get(gid, 0) + 1
            return gid

    def _leave(self, gid: str | None) -> None:
        if gid is None:
            return
        with self._lock:
            self._in_flight[gid] = max(0, self._in_flight.get(gid, 1) - 1)

    def stats(self) -> dict:
        with self._lock:
            return {
                gid: {
                    "name": g["name"],
                    "in_flight": self._in_flight.get(gid, 0),
                    "resiliency_mode": g.get("resiliency_mode"),
                }
                for gid, g in self.groups.items()
            }


class _Admission:
    def __init__(self, service: QueryGroupService, group_id: str | None):
        self.service = service
        self.group_id = group_id
        self._gid: str | None = None

    def __enter__(self) -> "_Admission":
        self._gid = self.service._try_enter(self.group_id)
        return self

    def __exit__(self, *exc: Any) -> None:
        self.service._leave(self._gid)
        if not exc or exc[0] is None:
            self.service._tally(self._gid, "total_completions")
        else:
            from opensearch_tpu_torch.common.errors import TaskCancelledException

            if isinstance(exc[1], TaskCancelledException):
                self.service._tally(self._gid, "total_cancellations")
            # other failures count as neither completion nor cancellation
