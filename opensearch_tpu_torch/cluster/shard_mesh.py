"""Shard-mesh registry: a node's device-resident shards as ONE stacked slab.

The residency layer behind the single-launch-per-node kNN path: every
(index, field) whose shards live on this node is flattened into one
[S, n_flat, d] slab (search/distributed_serving._build_bundle), so a
multi-shard query is a single launch — per-shard scan + top-k over the
stacked shard axis, then the on-device merge
(parallel/distributed.build_knn_serving_step) — instead of a serialized
per-shard Python loop with a host merge.

Residency is keyed by READER GENERATION: the registry key embeds each
shard's engine instance id, snapshot generation and segment count, so a
refresh mid-flight can never be answered from another snapshot's slab — a
bumped generation is a different key, a different bundle, a different
launch. One bundle stays live per (index, field); superseded generations
are evicted on insert.

The registry enforces a BYTE budget — ``search.mesh.hbm_budget_bytes`` —
with LRU-by-bytes eviction.

The registry is process-wide (one process == one device), and nodes
sharing an interpreter share it safely because engine instance ids keep
their keys disjoint.
"""

from __future__ import annotations

import threading
from typing import Any

from opensearch_tpu_torch.common.settings import Property, Setting, parse_bytes


def _validate_budget(v: int) -> None:
    if v < 0:
        raise ValueError(
            f"search.mesh.hbm_budget_bytes must be >= 0 (0 disables the "
            f"byte bound), got [{v}]")


# default one GiB of mesh-bundle residency; "1gb"-style values accepted
# (parse_bytes), 0 disables the byte bound
MESH_HBM_BUDGET_SETTING = Setting(
    "search.mesh.hbm_budget_bytes", 1 << 30, parse_bytes,
    Property.NODE_SCOPE, Property.DYNAMIC, validator=_validate_budget,
)


def _bundle_nbytes(bundle: Any) -> int:
    return int(getattr(bundle, "nbytes", 0) or 0)


class ShardMeshRegistry:
    """Tracks device-resident shard bundles keyed by reader generation,
    bounded by a device-memory byte budget (LRU-by-bytes)."""

    def __init__(self, hbm_budget_bytes: int | None = None):
        from opensearch_tpu_torch.common.settings import Settings

        self.hbm_budget_bytes = (
            hbm_budget_bytes if hbm_budget_bytes is not None
            else MESH_HBM_BUDGET_SETTING.default(Settings.EMPTY))
        self._lock = threading.Lock()
        # insertion-ordered dict as LRU: hits re-insert, eviction pops head
        self._bundles: dict[tuple, Any] = {}
        self._mem = {"resident_bytes": 0}
        self._launch_seq = 0
        self.stats = {
            "builds": 0,          # slabs uploaded (cold generations)
            "hits": 0,            # launches served by a resident bundle
            "evictions": 0,       # superseded generations + budget pressure
            "evicted_bytes": 0,   # bytes released by those evictions
            "launches": 0,        # stacked device launches issued
            "fused_launches": 0,  # launches served by the fused per-shard
            #                       scan (search.knn.kernel = pallas)
        }
        self.last_kernel: str | None = None
        self.last_score_precision: str | None = None

    # -- keys ---------------------------------------------------------------

    @staticmethod
    def residency_key(index: str, field: str, shards: list, snaps: list) -> tuple:
        """Generation-pinned identity of one node's shard set for a field.

        Engine instance ids make the key immune to delete+recreate cycles
        (generations restart at 0 on a fresh engine); the generation tuple
        is the refresh-isolation invariant — a refresh never merges across
        snapshots because it can never share a key."""
        return (
            index, field, len(shards),
            tuple(sh.engine.instance_id for sh in shards),
            tuple(snap.generation for snap in snaps),
            tuple(len(snap.segments) for snap in snaps),
        )

    # -- bundle cache -------------------------------------------------------

    def get(self, key: tuple) -> Any | None:
        with self._lock:
            bundle = self._bundles.get(key)
            if bundle is not None:
                self.stats["hits"] += 1
                # LRU touch
                del self._bundles[key]
                self._bundles[key] = bundle
            return bundle

    def _evict_locked(self, key: tuple) -> None:
        bundle = self._bundles.pop(key)
        nbytes = _bundle_nbytes(bundle)
        self._mem["resident_bytes"] -= nbytes
        self.stats["evictions"] += 1
        self.stats["evicted_bytes"] += nbytes

    def _enforce_budget_locked(self, incoming: int) -> None:
        """LRU-by-bytes: evict from the cold end until `incoming` more
        bytes fit the budget. A single bundle larger than the whole budget
        is still admitted (the query must be served; everything else
        evicts)."""
        budget = self.hbm_budget_bytes
        if budget <= 0:
            return
        while self._bundles and \
                self._mem["resident_bytes"] + incoming > budget:
            self._evict_locked(next(iter(self._bundles)))

    def put(self, key: tuple, bundle: Any) -> Any:
        """Insert a freshly built bundle; returns the WINNING bundle (an
        entry another thread raced in first wins, so callers always launch
        against the cached slab)."""
        with self._lock:
            existing = self._bundles.get(key)
            if existing is not None:
                return existing
            # one live bundle per residency SLOT — (index, field, engine
            # instance ids): a refresh bumps the generations but keeps the
            # engines, so the old generation's bundle evicts now, not at
            # budget pressure
            for stale in [k for k in self._bundles
                          if k[:2] == key[:2] and k[3] == key[3]]:
                self._evict_locked(stale)
            self._enforce_budget_locked(incoming=_bundle_nbytes(bundle))
            self._bundles[key] = bundle
            self._mem["resident_bytes"] += _bundle_nbytes(bundle)
            self.stats["builds"] += 1
            return bundle

    # -- launch bookkeeping -------------------------------------------------

    def next_launch_id(self) -> int:
        with self._lock:
            self._launch_seq += 1
            self.stats["launches"] += 1
            return self._launch_seq

    def record_launch_kernel(self, kernel: str, precision: str) -> None:
        """Per-launch exact-path policy attribution (search.knn.kernel):
        counts launches the fused per-shard scan served and pins the last
        resolved kernel/precision into the stats surface."""
        with self._lock:
            if kernel == "pallas":
                self.stats["fused_launches"] += 1
            self.last_kernel = kernel
            self.last_score_precision = precision

    def invalidate_index(self, index: str) -> int:
        """Drop every bundle of `index` (its node closed it or deleted it),
        releasing their device memory; returns the number dropped."""
        with self._lock:
            stale = [k for k in self._bundles if k[0] == index]
            for k in stale:
                self._evict_locked(k)
            return len(stale)


# process-wide default registry, adopted by serving nodes
default_registry = ShardMeshRegistry()
