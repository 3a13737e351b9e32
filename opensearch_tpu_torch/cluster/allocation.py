"""Shard allocation: deciders + balanced allocator.

The analog of the reference's allocation service
(server/src/main/java/org/opensearch/cluster/routing/allocation/ —
AllocationService.reroute, BalancedShardsAllocator, and the decider chain
under allocation/decider/). Implemented deciders (of the reference's 25):

- SameShardAllocationDecider: never two copies of a shard on one node
- FilterAllocationDecider: index.routing.allocation.{require,exclude}._name
- ThrottlingAllocationDecider: bounded concurrent recoveries per node
- MaxRetryAllocationDecider analog is implicit (unassigned stays unassigned)

The allocator assigns primaries first (availability), then replicas, always
to the data node with the fewest shards that all deciders approve
(BalancedShardsAllocator's weight function reduced to shard count; the
full weight function with index-level balance is a later refinement).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from opensearch_tpu_torch.cluster.state import (
    ClusterState,
    ShardRoutingEntry,
)


def _parse_pct(v, default: float) -> float:
    if v is None:
        return default
    return float(str(v).rstrip("%"))


@dataclass
class AllocationSettings:
    max_concurrent_recoveries_per_node: int = 4
    # DiskThresholdDecider: no NEW shard above low; shards DRAIN above high
    disk_low_watermark_pct: float = 85.0
    disk_high_watermark_pct: float = 90.0
    # AwarenessAllocationDecider: spread copies across these node attrs
    awareness_attributes: tuple[str, ...] = ()
    # BalancedShardsAllocator: move replicas until spread <= threshold
    rebalance_enabled: bool = True
    rebalance_threshold: int = 1
    # per-node observed disk usage pct (fs stats fed by heartbeats)
    disk_usage: dict[str, float] = field(default_factory=dict)
    # cluster-level FilterAllocationDecider: node NAMES being drained
    # (cluster.routing.allocation.exclude._name) — no new copies land
    # there and existing copies relocate off (graceful decommission)
    exclude_names: tuple[str, ...] = ()

    @staticmethod
    def from_cluster(state: ClusterState,
                     disk_usage: dict[str, float] | None = None
                     ) -> "AllocationSettings":
        """Resolve from the dynamic cluster settings (transient over
        persistent over default — ClusterSettings.java:205)."""
        eff = {**state.settings, **state.transient_settings}
        aw = eff.get("cluster.routing.allocation.awareness.attributes")
        excl = eff.get("cluster.routing.allocation.exclude._name")
        return AllocationSettings(
            max_concurrent_recoveries_per_node=int(eff.get(
                "cluster.routing.allocation.node_concurrent_recoveries", 4
            )),
            disk_low_watermark_pct=_parse_pct(eff.get(
                "cluster.routing.allocation.disk.watermark.low"), 85.0),
            disk_high_watermark_pct=_parse_pct(eff.get(
                "cluster.routing.allocation.disk.watermark.high"), 90.0),
            awareness_attributes=tuple(
                a.strip() for a in str(aw).split(",") if a.strip()
            ) if aw else (),
            rebalance_enabled=str(eff.get(
                "cluster.routing.rebalance.enable", "all"
            )).lower() != "none",
            disk_usage=dict(disk_usage or {}),
            exclude_names=tuple(
                n.strip() for n in str(excl).split(",") if n.strip()
            ) if excl else (),
        )


def _decide(
    state: ClusterState,
    entry: ShardRoutingEntry,
    node_id: str,
    assignments: list[ShardRoutingEntry],
    settings: AllocationSettings,
) -> bool:
    node = state.nodes.get(node_id)
    if node is None or not node.is_data:
        return False
    # SameShardAllocationDecider
    for r in assignments:
        if (
            r.index == entry.index
            and r.shard == entry.shard
            and r.node_id == node_id
            and r.state != "UNASSIGNED"
        ):
            return False
    # FilterAllocationDecider
    meta = state.indices.get(entry.index)
    if meta is not None:
        require = meta.settings.get("routing.allocation.require._name")
        if require is not None and node.name != require:
            return False
        exclude = meta.settings.get("routing.allocation.exclude._name")
        if exclude is not None and node.name in str(exclude).split(","):
            return False
    # cluster-level FilterAllocationDecider: a node being drained takes no
    # new copies (the evacuation pass moves existing ones off it); matches
    # the node name, falling back to the id for unnamed nodes
    if (node.name or node.node_id) in settings.exclude_names:
        return False
    # DiskThresholdDecider (low watermark): no NEW shard on a filling node
    usage = settings.disk_usage.get(node_id)
    if usage is not None and usage >= settings.disk_low_watermark_pct:
        return False
    # AwarenessAllocationDecider: copies of one shard spread across the
    # configured attribute's values (at most ceil(copies / n_values) per
    # value)
    for attr in settings.awareness_attributes:
        values = {
            n.attr_map.get(attr) for n in state.nodes.values()
            if n.is_data and n.attr_map.get(attr) is not None
        }
        if len(values) < 2:
            continue
        my_value = node.attr_map.get(attr)
        same_value = sum(
            1 for r in assignments
            if r.index == entry.index and r.shard == entry.shard
            and r.node_id is not None and r.state != "UNASSIGNED"
            and state.nodes.get(r.node_id) is not None
            and state.nodes[r.node_id].attr_map.get(attr) == my_value
        )
        meta = state.indices.get(entry.index)
        copies = 1 + (meta.num_replicas if meta else 0)
        if same_value + 1 > math.ceil(copies / len(values)):
            return False
    # ThrottlingAllocationDecider: cap INITIALIZING shards per node
    initializing = sum(
        1 for r in assignments
        if r.node_id == node_id and r.state == "INITIALIZING"
    )
    if initializing >= settings.max_concurrent_recoveries_per_node:
        return False
    return True


def reroute(state: ClusterState, settings: AllocationSettings | None = None) -> ClusterState:
    """Compute a new routing table: build desired shard copies from index
    metadata, keep valid existing assignments, allocate the rest."""
    settings = settings or AllocationSettings()
    new_routing: list[ShardRoutingEntry] = []
    data_nodes = [n.node_id for n in state.nodes.values() if n.is_data]

    def node_load(node_id: str) -> int:
        return sum(1 for r in new_routing if r.node_id == node_id)

    for index_name in sorted(state.indices):
        meta = state.indices[index_name]
        for shard in range(meta.num_shards):
            # keep currently assigned copies whose node still exists
            current = [
                r for r in state.routing
                if r.index == index_name and r.shard == shard
                and r.node_id in state.nodes and r.state != "UNASSIGNED"
            ]
            # repair half-dead relocation pairs: a RELOCATING source whose
            # target died reverts to a plain STARTED copy (relocation
            # cancelled); a shadow target whose source died continues as a
            # plain INITIALIZING replica recovering from the primary
            # (RoutingNodes.cancelRelocation semantics). Mates must be in
            # the matching STATE, not just point at each other — a stale
            # entry shape must never leave an unpairable source behind.
            sources = {
                (r.node_id, r.relocating_node) for r in current
                if r.state == "RELOCATING"
            }
            targets = {
                (r.node_id, r.relocating_node) for r in current
                if r.is_relocation_target
            }
            repaired = []
            for r in current:
                if r.state == "RELOCATING" and (
                    r.relocating_node, r.node_id
                ) not in targets:
                    r = ShardRoutingEntry(r.index, r.shard, r.node_id,
                                          r.primary, "STARTED")
                elif r.is_relocation_target and (
                    r.relocating_node, r.node_id
                ) not in sources:
                    r = ShardRoutingEntry(r.index, r.shard, r.node_id,
                                          r.primary, "INITIALIZING")
                repaired.append(r)
            current = repaired
            current_primary = next((r for r in current if r.primary), None)
            # group replicas into UNITS: a RELOCATING source and its shadow
            # target are ONE logical copy and must be kept (or dropped)
            # together, or the replica count double-books the pair
            replicas = [r for r in current if not r.primary]
            paired: dict[int, int] = {}  # id(target) -> id(source)
            for r in replicas:
                if r.state == "RELOCATING":
                    mate = next(
                        (x for x in replicas if x.is_relocation_target
                         and x.node_id == r.relocating_node), None)
                    if mate is not None:
                        paired[id(mate)] = id(r)
            units: list[list[ShardRoutingEntry]] = []
            for r in replicas:
                if id(r) in paired:
                    continue  # emitted with its source below
                if r.state == "RELOCATING":
                    mate = next(
                        x for x in replicas if x.is_relocation_target
                        and x.node_id == r.relocating_node)
                    units.append([r, mate])
                else:
                    units.append([r])

            if current_primary is not None:
                new_routing.append(current_primary)
                kept_units = units[: meta.num_replicas]
            else:
                # promote a started (or relocating — it serves too) replica
                # to primary (failover) before allocating a fresh one (the
                # in-sync promotion path)
                promoted_unit = next(
                    (u for u in units
                     if u[0].state in ("STARTED", "RELOCATING")), None
                )
                if promoted_unit is not None:
                    units.remove(promoted_unit)
                    src = promoted_unit[0]
                    new_routing.append(
                        ShardRoutingEntry(index_name, shard, src.node_id,
                                          primary=True, state="STARTED")
                    )
                    if len(promoted_unit) == 2:
                        # the promoted copy's in-flight relocation cancels;
                        # its shadow keeps recovering as a plain replica
                        t = promoted_unit[1]
                        units.append([ShardRoutingEntry(
                            index_name, shard, t.node_id, primary=False,
                            state="INITIALIZING")])
                    kept_units = units[: meta.num_replicas]
                else:
                    # fresh primary allocation; the deciders must also see
                    # the replicas we are about to keep, or the primary can
                    # land on a node already holding a copy of this shard
                    # (SameShardAllocationDecider violation)
                    kept_units = units[: meta.num_replicas]
                    kept_flat = [r for u in kept_units for r in u]
                    candidates = sorted(
                        (nid for nid in data_nodes
                         if _decide(state, ShardRoutingEntry(index_name, shard, None, True),
                                    nid, new_routing + kept_flat, settings)),
                        key=lambda nid: (node_load(nid), nid),
                    )
                    if candidates:
                        new_routing.append(
                            ShardRoutingEntry(index_name, shard, candidates[0],
                                              primary=True, state="INITIALIZING")
                        )
                    else:
                        new_routing.append(
                            ShardRoutingEntry(index_name, shard, None,
                                              primary=True, state="UNASSIGNED")
                        )

            for u in kept_units:
                new_routing.extend(u)
            for _ in range(meta.num_replicas - len(kept_units)):
                entry = ShardRoutingEntry(index_name, shard, None, primary=False)
                candidates = sorted(
                    (nid for nid in data_nodes
                     if _decide(state, entry, nid, new_routing, settings)),
                    key=lambda nid: (node_load(nid), nid),
                )
                if candidates:
                    new_routing.append(
                        ShardRoutingEntry(index_name, shard, candidates[0],
                                          primary=False, state="INITIALIZING")
                    )
                else:
                    new_routing.append(entry)  # UNASSIGNED

    # evacuation (DiskThresholdDecider high watermark + cluster exclude
    # filter) runs before the balance pass; at most one topology change
    # per publication, so a reshape converges over successive publications
    evacuated = _evacuate(state, new_routing, data_nodes, settings)
    if evacuated is not new_routing:
        new_routing = evacuated
    elif settings.rebalance_enabled:
        new_routing = _rebalance(state, new_routing, data_nodes, settings)
    return state.with_(routing=tuple(new_routing))


def _evacuate(state: ClusterState, routing: list[ShardRoutingEntry],
              data_nodes: list[str],
              settings: AllocationSettings) -> list[ShardRoutingEntry]:
    """Move shard copies OFF nodes that must not hold them: nodes at or
    above the disk high watermark (replicas evacuate; primaries stay put —
    moving the only authoritative copy on a full disk trades availability
    for space) and nodes named by the cluster exclude filter (graceful
    decommission: replicas relocate off, primaries hand their ROLE to a
    started replica elsewhere first, and a node holding the only serving
    copy of a shard is REFUSED — the copy stays until another exists).

    Every move is a real relocation: the source keeps serving in state
    RELOCATING while the shadow target recovers, and `mark_shard_started`
    performs the atomic swap — per-shard unavailability stays bounded by
    the swap itself, not the copy duration. One move per publication."""
    if any(r.state == "RELOCATING" or r.is_relocation_target
           for r in routing):
        return routing
    over = {
        nid for nid, pct in settings.disk_usage.items()
        if pct >= settings.disk_high_watermark_pct
    }
    excluded = {
        nid for nid in data_nodes
        if (state.nodes[nid].name or nid) in settings.exclude_names
    }
    leaving = over | excluded
    if not leaving:
        return routing

    def load(nid: str) -> int:
        return sum(1 for r in routing if r.node_id == nid)

    for i, r in enumerate(routing):
        if r.node_id not in leaving or r.primary or r.state != "STARTED":
            continue
        others = [x for j, x in enumerate(routing) if j != i]
        candidates = sorted(
            (nid for nid in data_nodes
             if nid not in leaving
             and _decide(state, r, nid, others, settings)),
            key=lambda nid: (load(nid), nid),
        )
        if candidates:
            target = candidates[0]
            routing = list(routing)
            routing[i] = ShardRoutingEntry(
                r.index, r.shard, r.node_id, primary=False,
                state="RELOCATING", relocating_node=target,
            )
            routing.append(ShardRoutingEntry(
                r.index, r.shard, target, primary=False,
                state="INITIALIZING", relocating_node=r.node_id,
            ))
            return routing
        if r.node_id in over:
            # no decider-approved target but the disk is critical: drop
            # the replica to free space — but NEVER the only serving copy
            serving_elsewhere = any(
                x.index == r.index and x.shard == r.shard
                and x.state in ("STARTED", "RELOCATING")
                for x in others
            )
            if serving_elsewhere:
                return [x for j, x in enumerate(routing) if j != i]
    # primaries on EXCLUDED nodes (decommission only — watermark leaves
    # primaries in place): swap the primary role onto a started replica
    # on a staying node; the demoted copy becomes a replica the next
    # round relocates
    for i, r in enumerate(routing):
        if not (r.node_id in excluded and r.primary
                and r.state == "STARTED"):
            continue
        for j, other in enumerate(routing):
            if (other.index == r.index and other.shard == r.shard
                    and not other.primary and other.state == "STARTED"
                    and other.node_id is not None
                    and other.node_id not in leaving):
                routing = list(routing)
                routing[i] = ShardRoutingEntry(
                    r.index, r.shard, r.node_id, primary=False,
                    state="STARTED",
                )
                routing[j] = ShardRoutingEntry(
                    other.index, other.shard, other.node_id, primary=True,
                    state="STARTED",
                )
                return routing
    return routing


def _rebalance(state: ClusterState, routing: list[ShardRoutingEntry],
               data_nodes: list[str],
               settings: AllocationSettings) -> list[ShardRoutingEntry]:
    """BalancedShardsAllocator's rebalance pass, reduced to the shard-count
    weight: relocate ONE started replica per round from the most- to the
    least-loaded node when the spread exceeds the threshold; successive
    publications (each shard-started triggers one) converge the layout.

    A move is a real RELOCATION: the source copy keeps serving in state
    RELOCATING (relocating_node = target) while a shadow target copy
    recovers on the destination; `mark_shard_started` performs the atomic
    routing swap when the target catches up."""
    if len(data_nodes) < 2:
        return routing
    # one relocation at a time: an in-flight pair double-counts node load
    # and occupies recovery bandwidth — let it finish before planning more
    if any(r.state == "RELOCATING" or r.is_relocation_target
           for r in routing):
        return routing

    def load(nid: str) -> int:
        return sum(1 for r in routing if r.node_id == nid)

    by_load = sorted(data_nodes, key=lambda nid: (load(nid), nid))
    light, heavy = by_load[0], by_load[-1]
    if load(heavy) - load(light) <= settings.rebalance_threshold:
        return routing
    for i, r in enumerate(routing):
        if (r.node_id == heavy and not r.primary and r.state == "STARTED"
                and _decide(state, r, light,
                            [x for j, x in enumerate(routing) if j != i],
                            settings)):
            routing = list(routing)
            routing[i] = ShardRoutingEntry(
                r.index, r.shard, heavy, primary=False, state="RELOCATING",
                relocating_node=light,
            )
            routing.append(ShardRoutingEntry(
                r.index, r.shard, light, primary=False,
                state="INITIALIZING", relocating_node=heavy,
            ))
            return routing
    # no movable replica on the heavy node (all primaries): swap the
    # primary ROLE with a started replica on a lighter node (flag-only —
    # both copies hold the data and stay STARTED), which turns the heavy
    # node's copy into a replica a later round CAN move
    for i, r in enumerate(routing):
        if not (r.node_id == heavy and r.primary and r.state == "STARTED"):
            continue
        for j, other in enumerate(routing):
            if (other.index == r.index and other.shard == r.shard
                    and not other.primary and other.state == "STARTED"
                    and other.node_id is not None
                    and load(other.node_id) < load(heavy)):
                routing = list(routing)
                routing[i] = ShardRoutingEntry(
                    r.index, r.shard, r.node_id, primary=False,
                    state="STARTED",
                )
                routing[j] = ShardRoutingEntry(
                    other.index, other.shard, other.node_id, primary=True,
                    state="STARTED",
                )
                return routing
    return routing


def mark_shard_started(
    state: ClusterState, index: str, shard: int, node_id: str
) -> ClusterState:
    """shard-started master task (ShardStateAction analog). When the
    started copy is a RELOCATION TARGET, this is the atomic routing swap:
    in ONE published state the source's RELOCATING entry disappears and
    the target becomes the plain STARTED copy — readers never observe a
    moment with zero (or two independent) serving copies."""
    started = next(
        (r for r in state.routing
         if r.index == index and r.shard == shard and r.node_id == node_id),
        None,
    )
    if started is not None and started.is_relocation_target:
        source = started.relocating_node
        routing = tuple(
            ShardRoutingEntry(r.index, r.shard, r.node_id, r.primary,
                              "STARTED")
            if r is started else r
            for r in state.routing
            if not (r.index == index and r.shard == shard
                    and r.node_id == source and r.state == "RELOCATING"
                    and r.relocating_node == node_id)
        )
        return state.with_(routing=routing)
    routing = tuple(
        r if not (r.index == index and r.shard == shard and r.node_id == node_id)
        else ShardRoutingEntry(r.index, r.shard, r.node_id, r.primary, "STARTED")
        for r in state.routing
    )
    return state.with_(routing=routing)


def mark_shard_failed(
    state: ClusterState, index: str, shard: int, node_id: str
) -> ClusterState:
    routing = tuple(
        r if not (r.index == index and r.shard == shard and r.node_id == node_id)
        else ShardRoutingEntry(r.index, r.shard, None, r.primary, "UNASSIGNED")
        for r in state.routing
    )
    return reroute(state.with_(routing=routing))
