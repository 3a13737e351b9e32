"""Residency-aware replica routing: land each shard's launch on the warm copy.

Counterpart of opensearch_tpu/cluster/residency.py, a copy with its
imports rewritten. A data node reads its own device-ledger and
shard-mesh registry rows after serving a kNN partial and stamps the
response with its residency; a coordinator collects those stamps in a
:class:`ResidencyBoard` and prefers the copy whose structures are warm,
else round-robin. The board is per coordinator and bounded (LRU).

``search.routing.residency`` (dynamic) is the switch. One node has no
replica to route to: the setting validates and applies, and nothing here
serves a request until the port has a cluster.
"""

from __future__ import annotations

import threading
from typing import Any

from opensearch_tpu_torch.common.settings import Property, Setting

# -- settings (registered dynamic in cluster/cluster_settings.py) -----------

RESIDENCY_ROUTING_SETTING = Setting.bool_setting(
    "search.routing.residency", True,
    Property.NODE_SCOPE, Property.DYNAMIC,
)

ROUTING_SETTINGS = (RESIDENCY_ROUTING_SETTING,)


class RoutingConfig:
    """Process-wide routing policy toggle (the lane-config adapter
    shape); read racily by design like every dynamic knob."""

    def __init__(self, enabled: bool | None = None):
        from opensearch_tpu_torch.common.settings import Settings

        self.enabled = (enabled if enabled is not None
                        else RESIDENCY_ROUTING_SETTING.default(Settings.EMPTY))

    def configure(self, *, enabled: bool | None = None) -> None:
        if enabled is not None:
            self.enabled = bool(enabled)

    def apply_settings(self, flat: dict) -> None:
        from opensearch_tpu_torch.common.settings import Settings

        s = Settings.from_flat({
            st.key: flat[st.key] for st in ROUTING_SETTINGS if st.key in flat
        })
        self.configure(enabled=RESIDENCY_ROUTING_SETTING.get(s))


default_config = RoutingConfig()


def knn_query_field(body: dict | None) -> str | None:
    """The single kNN field of a bare knn body ({"query": {"knn": {f:
    ...}}}), or None — residency facts are per (index, field)."""
    if not isinstance(body, dict):
        return None
    query = body.get("query")
    if not isinstance(query, dict) or set(query) != {"knn"}:
        return None
    knn = query["knn"]
    if isinstance(knn, dict) and len(knn) == 1:
        return next(iter(knn))
    return None


# board entries are per (node, index, field); a serving tier holds a few
# indices x a few vector fields x a few dozen nodes — 512 is generous,
# and LRU eviction keeps a pathological workload bounded (TPU009)
MAX_BOARD_ENTRIES = 512


class ResidencyBoard:
    """Coordinator-side map of which copies are warm, learned from the
    ``_residency`` stamps data nodes attach to kNN partials."""

    def __init__(self, max_entries: int = MAX_BOARD_ENTRIES):
        self._lock = threading.Lock()
        self.max_entries = max_entries
        # insertion-ordered dict as LRU: observe re-inserts, prune pops
        self._warm: dict[tuple[str, str, str], bool] = {}
        self.stats = {
            "warm_hits": 0,     # fan-outs where >= 1 shard landed warm
            "cold_routes": 0,   # fan-outs routed with no warm copy known
            "observations": 0,  # residency stamps consumed
        }

    # -- learning ----------------------------------------------------------

    def observe(self, node_id: str, index: str, field: str,
                warm: bool) -> None:
        key = (node_id, index, field)
        with self._lock:
            self.stats["observations"] += 1
            self._warm.pop(key, None)
            self._warm[key] = bool(warm)
            while len(self._warm) > self.max_entries:
                self._warm.pop(next(iter(self._warm)))

    def warm_nodes(self, index: str, field: str) -> set[str]:
        with self._lock:
            return {nid for (nid, idx, f), warm in self._warm.items()
                    if warm and idx == index and f == field}

    def prune(self, live_nodes: set[str] | None = None,
              live_indices: set[str] | None = None) -> None:
        """Drop entries for departed nodes / deleted indices (cluster-state
        application): a dead node must never look warm to the router."""
        with self._lock:
            stale = [
                k for k in self._warm
                if (live_nodes is not None and k[0] not in live_nodes)
                or (live_indices is not None and k[1] not in live_indices)
            ]
            for k in stale:
                del self._warm[k]

    # -- routing -----------------------------------------------------------

    def record_route(self, warm: bool) -> None:
        with self._lock:
            if warm:
                self.stats["warm_hits"] += 1
            else:
                self.stats["cold_routes"] += 1

    def snapshot_stats(self) -> dict:
        with self._lock:
            out = dict(self.stats)
            out["entries"] = len(self._warm)
            out["warm_entries"] = sum(1 for w in self._warm.values() if w)
        out["enabled"] = default_config.enabled
        return out


def choose_copies(board: ResidencyBoard | None, index: str,
                  field: str | None,
                  candidates_by_shard: dict[int, list],
                  rr_seq: int) -> tuple[dict[int, Any], bool]:
    """Pick one serving copy per shard. With residency routing on and a
    kNN field known: a candidate on a warm node wins (the launch lands on
    the resident slab); with no warm copy, every shard routes to the SAME
    round-robin rank so the node-grouped fan-out stays one-RPC-per-node
    and the first build lands on one replica set, not scattered. Returns
    (shard -> routing entry, any_warm)."""
    targets: dict[int, Any] = {}
    if (board is None or field is None or not default_config.enabled):
        for num, cands in candidates_by_shard.items():
            targets[num] = next(
                (r for r in cands if r.primary), cands[0])
        return targets, False
    warm = board.warm_nodes(index, field)
    any_warm = False
    for num, cands in sorted(candidates_by_shard.items()):
        ordered = sorted(cands, key=lambda r: (not r.primary, r.node_id))
        hot = next((r for r in ordered if r.node_id in warm), None)
        if hot is not None:
            targets[num] = hot
            any_warm = True
        else:
            targets[num] = ordered[rr_seq % len(ordered)]
    board.record_route(any_warm)
    return targets, any_warm
