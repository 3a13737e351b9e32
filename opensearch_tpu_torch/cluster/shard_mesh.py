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
with LRU-by-bytes eviction. Every eviction frees the bundle's
device-residency-ledger allocation (telemetry/device_ledger.py) and lands
a ``mesh.evict`` span EVENT on whichever request triggered it.

The registry is process-wide (one process, its serving devices: a
bundle's slabs may lie on several cards, one a slot, and an eviction
frees every slot's allocation), and nodes sharing an interpreter share it
safely because engine instance ids keep their keys disjoint.
"""

from __future__ import annotations

import threading
from typing import Any

from opensearch_tpu_torch.common.settings import Property, Setting, parse_bytes

# registered metric name for the fenced sharded-launch wall (metric names
# are constants, never built at the record site)
MESH_LAUNCH_WALL_MS = "mesh.launch.wall_ms"

# -- settings (registered dynamic in cluster/cluster_settings.py) -----------


def _validate_budget(v: int) -> None:
    if v < 0:
        raise ValueError(
            f"search.mesh.hbm_budget_bytes must be >= 0 (0 disables the "
            f"byte bound), got [{v}]")


# default one GiB of mesh-bundle residency; "1gb"-style values accepted on
# PUT (parse_bytes), 0 disables the byte bound
MESH_HBM_BUDGET_SETTING = Setting(
    "search.mesh.hbm_budget_bytes", 1 << 30, parse_bytes,
    Property.NODE_SCOPE, Property.DYNAMIC, validator=_validate_budget,
)

MESH_SETTINGS = (MESH_HBM_BUDGET_SETTING,)


def _bundle_nbytes(bundle: Any) -> int:
    return int(getattr(bundle, "nbytes", 0) or 0)


def _free_bundle(bundle: Any, reason: str) -> None:
    """Free every slot's ledger allocation of `bundle` (one a slot)."""
    for alloc in bundle.allocations:
        alloc.free(reason=reason)


class ShardMeshRegistry:
    """Tracks device-resident shard bundles keyed by reader generation,
    bounded by an HBM byte budget (LRU-by-bytes)."""

    def __init__(self, hbm_budget_bytes: int | None = None):
        from opensearch_tpu_torch.common.settings import Settings

        self.hbm_budget_bytes = (
            hbm_budget_bytes if hbm_budget_bytes is not None
            else MESH_HBM_BUDGET_SETTING.default(Settings.EMPTY))
        self.metrics = None  # MetricsRegistry sink (a TorchNode attaches)
        self._lock = threading.Lock()
        # insertion-ordered dict as LRU: hits re-insert, eviction pops head
        self._bundles: dict[tuple, Any] = {}
        # dict cell (not a bare attribute) so the *_locked helpers mutate
        # it by subscript under the caller-held lock
        self._mem = {"resident_bytes": 0}
        self._launch_seq = 0
        self.stats = {
            "builds": 0,          # slabs uploaded (cold generations)
            "hits": 0,            # launches served by a resident bundle
            "evictions": 0,       # superseded generations + budget pressure
            "evicted_bytes": 0,   # bytes released by those evictions
            "invalidations": 0,   # index-level drops (shard left the node)
            "invalidated_bytes": 0,  # bytes released by those drops
            "launches": 0,        # sharded device launches issued
            "fused_launches": 0,  # launches served by the fused per-shard
            #                       scan (search.knn.kernel = pallas)
        }
        # last resolved exact-path policy a launch ran under (attribution
        # for _nodes/stats; the roofline report names the kernel family,
        # this names the policy that picked it)
        self.last_kernel: str | None = None
        self.last_score_precision: str | None = None

    # -- config --------------------------------------------------------------

    def configure(self, *, hbm_budget_bytes: int | None = None) -> None:
        if hbm_budget_bytes is None:
            return
        # plain atomic rebind read racily by design (the dynamic-settings
        # contract, same as the batcher's config fields); the eviction pass
        # below then enforces the new bound under the lock
        self.hbm_budget_bytes = max(0, int(hbm_budget_bytes))
        with self._lock:
            self._enforce_budget_locked(incoming=0)

    def apply_settings(self, flat: dict) -> None:
        """Pick this registry's keys out of a flat effective-settings map
        (the cluster-settings update consumer — same adapter shape as the
        kNN batcher's)."""
        from opensearch_tpu_torch.common.settings import Settings

        s = Settings.from_flat({
            st.key: flat[st.key] for st in MESH_SETTINGS if st.key in flat
        })
        self.configure(hbm_budget_bytes=MESH_HBM_BUDGET_SETTING.get(s))

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

    def _evict_locked(self, key: tuple, reason: str) -> None:
        bundle = self._bundles.pop(key)
        nbytes = _bundle_nbytes(bundle)
        self._mem["resident_bytes"] -= nbytes
        self.stats["evictions"] += 1
        self.stats["evicted_bytes"] += nbytes
        _free_bundle(bundle, reason=reason)
        # the eviction decision rides the triggering request's trace as a
        # span EVENT (no-op outside a span): budget pressure is diagnosable
        # from the trace that paid for it, not only from counters
        from opensearch_tpu_torch.telemetry.tracing import add_span_event

        add_span_event("mesh.evict", {
            "index": key[0], "field": key[1], "reason": reason,
            "bytes": nbytes,
        })

    def _enforce_budget_locked(self, incoming: int) -> None:
        """LRU-by-bytes: evict from the cold end until `incoming` more
        bytes fit the budget. A single bundle larger than the whole budget
        is still admitted (the query must be served; everything else
        evicts) — the stats make that state visible."""
        budget = self.hbm_budget_bytes
        if budget <= 0:
            return
        while self._bundles and \
                self._mem["resident_bytes"] + incoming > budget:
            self._evict_locked(next(iter(self._bundles)), "hbm-budget")

    def put(self, key: tuple, bundle: Any) -> Any:
        """Insert a freshly built bundle; returns the WINNING bundle (an
        entry another thread raced in first wins, so callers always launch
        against the cached slab — the losing duplicate's ledger allocation
        is freed here)."""
        with self._lock:
            existing = self._bundles.get(key)
            if existing is not None:
                if existing is not bundle:
                    _free_bundle(bundle, reason="duplicate-build")
                return existing
            # one live bundle per residency SLOT — (index, field, engine
            # instance ids), i.e. per node's shard set: a refresh bumps
            # the generations but keeps the engines, so the old
            # generation's bundle evicts now, not at budget pressure.
            # Keying the slot by engine ids (not just index/field) lets
            # in-process sim nodes hold their OWN copies' bundles side by
            # side — the residency-aware router depends on a warm copy
            # STAYING warm while another node serves its disjoint shards.
            for stale in [k for k in self._bundles
                          if k[:2] == key[:2] and k[3] == key[3]]:
                self._evict_locked(stale, "superseded")
            self._enforce_budget_locked(incoming=_bundle_nbytes(bundle))
            self._bundles[key] = bundle
            self._mem["resident_bytes"] += _bundle_nbytes(bundle)
            self.stats["builds"] += 1
            return bundle

    def warm_for(self, index: str, field: str,
                 engine_ids: set | frozenset) -> bool:
        """True when a resident bundle serves (index, field) for shards
        whose engines are all in `engine_ids` — the node-side residency
        truth the coordinator's replica router learns from (a bundle
        keyed to ANOTHER node's engine instances in a shared-process sim
        never counts as this node's warmth). Pure read: no LRU touch, no
        hit accounting — consulting residency is not serving from it."""
        with self._lock:
            return any(
                k[0] == index and k[1] == field
                and set(k[3]) <= set(engine_ids)
                for k in self._bundles
            )

    def warm_pairs(self, engine_ids: set | frozenset) -> list[tuple]:
        """Every (index, field) with a resident bundle keyed to engines in
        `engine_ids` — THIS node's warm set, advertised on stats/join
        traffic so a fresh coordinator's ResidencyBoard seeds before the
        first stamped partial. Pure read, like warm_for."""
        ids = set(engine_ids)
        with self._lock:
            return sorted({
                (k[0], k[1]) for k in self._bundles if set(k[3]) <= ids
            })

    def invalidate_index(self, index: str, engine_ids=()) -> int:
        """Drop every bundle of `index` (its shards left this node or the
        index was deleted), and every bundle holding one of `engine_ids`
        (the index's engines): a search over several indices keys its
        bundle by the first index's name. Returns the number of bundles
        dropped."""
        engines = set(engine_ids)
        with self._lock:
            stale = [k for k in self._bundles
                     if k[0] == index or engines & set(k[3])]
            stale_bytes = sum(
                _bundle_nbytes(self._bundles[k]) for k in stale)
            for k in stale:
                self._evict_locked(k, "invalidated")
            if stale:
                # invalidations are their own counters; _evict_locked
                # already counted them as evictions (count AND bytes), so
                # rebalance both — evicted_bytes must reconcile with the
                # evictions counter it documents
                self.stats["evictions"] -= len(stale)
                self.stats["evicted_bytes"] -= stale_bytes
                self.stats["invalidations"] += len(stale)
                self.stats["invalidated_bytes"] = (
                    self.stats.get("invalidated_bytes", 0) + stale_bytes)
            return len(stale)

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

    def record_launch_wall(self, wall_ns: int) -> None:
        """Feed the fenced launch wall into the EXECUTING node's metrics
        (the activate() scope its request handler opened — so in-process
        sim nodes don't all record into the last-attached sink), falling
        back to the attached MetricsRegistry; records an exemplar-linked
        `mesh.launch.wall_ms` histogram point."""
        from opensearch_tpu_torch.telemetry.tracing import active_metrics

        metrics = active_metrics() or self.metrics
        if metrics is not None:
            metrics.histogram(MESH_LAUNCH_WALL_MS).record(wall_ns / 1e6)

    # -- introspection ------------------------------------------------------

    def resident(self) -> list[dict]:
        """What is device-resident right now (for node stats / debugging):
        one row per bundle with its byte size."""
        with self._lock:
            return [
                {"index": k[0], "field": k[1], "shards": k[2],
                 "generations": list(k[4]),
                 "bytes": _bundle_nbytes(b)}
                for k, b in self._bundles.items()
            ]

    def resident_bytes(self) -> int:
        with self._lock:
            return self._mem["resident_bytes"]

    def snapshot_stats(self) -> dict:
        with self._lock:
            out = dict(self.stats)
            out["resident_bundles"] = len(self._bundles)
            out["resident_bytes"] = self._mem["resident_bytes"]
            out["hbm_budget_bytes"] = self.hbm_budget_bytes
            if self.last_kernel is not None:
                out["last_kernel"] = self.last_kernel
                out["last_score_precision"] = self.last_score_precision
        return out

    def clear(self) -> None:
        with self._lock:
            for bundle in self._bundles.values():
                _free_bundle(bundle, reason="cleared")
            self._bundles.clear()
            # fixed-key accounting cell, not a growing buffer
            self._mem["resident_bytes"] = 0  # tpulint: disable=TPU009

    def reset_stats(self) -> None:
        """Test hook: zero the counters (never the resident bundles)."""
        with self._lock:
            zeroed = dict.fromkeys(self.stats, 0)
            self.stats.clear()
            self.stats.update(zeroed)


# process-wide default registry, adopted by serving nodes
default_registry = ShardMeshRegistry()
