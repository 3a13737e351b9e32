"""Cluster state: the immutable, versioned snapshot every node applies.

The analog of the reference's ClusterState + Metadata + RoutingTable
(server/src/main/java/org/opensearch/cluster/ClusterState.java,
cluster/metadata/Metadata.java, cluster/routing/RoutingTable.java) with the
same versioning semantics: `term` advances with elections, `version` with
every published state; diffs ship (version N -> N+1) deltas so repeated
publications don't reserialize whole states (DiffableUtils analog).

Plain dataclasses + dict serialization — the control plane is host-side
Python; nothing here touches JAX.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field, replace
from typing import Any


@dataclass(frozen=True)
class DiscoveryNode:
    node_id: str
    name: str = ""
    address: str = ""
    roles: tuple[str, ...] = ("cluster_manager", "data")
    # node attributes for awareness allocation (node.attr.* in the
    # reference, e.g. {"zone": "us-east-1a"})
    attrs: tuple = ()

    @property
    def is_cluster_manager_eligible(self) -> bool:
        return "cluster_manager" in self.roles

    @property
    def is_data(self) -> bool:
        return "data" in self.roles

    @property
    def attr_map(self) -> dict:
        return dict(self.attrs)

    def to_dict(self) -> dict:
        return {"node_id": self.node_id, "name": self.name,
                "address": self.address, "roles": list(self.roles),
                "attrs": [list(kv) for kv in self.attrs]}

    @staticmethod
    def from_dict(d: dict) -> "DiscoveryNode":
        return DiscoveryNode(d["node_id"], d.get("name", ""), d.get("address", ""),
                             tuple(d.get("roles", ("cluster_manager", "data"))),
                             tuple(tuple(kv) for kv in d.get("attrs", [])))


@dataclass(frozen=True)
class VotingConfiguration:
    """The quorum set (CoordinationMetadata.VotingConfiguration)."""

    node_ids: frozenset[str] = frozenset()

    def has_quorum(self, votes: set[str]) -> bool:
        if not self.node_ids:
            return False
        return len(votes & self.node_ids) * 2 > len(self.node_ids)

    def to_dict(self) -> list:
        return sorted(self.node_ids)

    @staticmethod
    def of(*node_ids: str) -> "VotingConfiguration":
        return VotingConfiguration(frozenset(node_ids))


@dataclass(frozen=True)
class ShardRoutingEntry:
    """One shard copy's assignment (ShardRouting).

    A relocation is modeled as the reference does: the serving copy moves
    to state RELOCATING with `relocating_node` = the target node, and a
    shadow target entry appears on the target node in state INITIALIZING
    with `relocating_node` = the source node. The pair is ONE logical copy;
    when the target reports started, the swap drops the source entry and
    the target becomes a plain STARTED copy (ShardRouting.relocatingNodeId
    + RoutingNodes.relocateShard semantics)."""

    index: str
    shard: int
    node_id: str | None            # None = unassigned
    primary: bool
    state: str = "UNASSIGNED"      # UNASSIGNED | INITIALIZING | STARTED | RELOCATING
    relocating_node: str | None = None

    @property
    def is_relocation_target(self) -> bool:
        return self.state == "INITIALIZING" and self.relocating_node is not None

    def to_dict(self) -> dict:
        return {"index": self.index, "shard": self.shard, "node_id": self.node_id,
                "primary": self.primary, "state": self.state,
                "relocating_node": self.relocating_node}

    @staticmethod
    def from_dict(d: dict) -> "ShardRoutingEntry":
        return ShardRoutingEntry(d["index"], d["shard"], d.get("node_id"),
                                 d["primary"], d.get("state", "UNASSIGNED"),
                                 d.get("relocating_node"))


@dataclass(frozen=True)
class IndexMeta:
    name: str
    num_shards: int
    num_replicas: int
    settings: dict = field(default_factory=dict)
    mappings: dict = field(default_factory=dict)
    version: int = 1               # bumped on every mapping/settings change

    def to_dict(self) -> dict:
        return {"name": self.name, "num_shards": self.num_shards,
                "num_replicas": self.num_replicas, "settings": self.settings,
                "mappings": self.mappings, "version": self.version}

    @staticmethod
    def from_dict(d: dict) -> "IndexMeta":
        return IndexMeta(d["name"], d["num_shards"], d["num_replicas"],
                         d.get("settings", {}), d.get("mappings", {}),
                         d.get("version", 1))


@dataclass(frozen=True)
class ClusterState:
    term: int = 0
    version: int = 0
    cluster_uuid: str = "_na_"
    leader_id: str | None = None
    nodes: dict[str, DiscoveryNode] = field(default_factory=dict)
    indices: dict[str, IndexMeta] = field(default_factory=dict)
    routing: tuple[ShardRoutingEntry, ...] = ()
    last_committed_config: VotingConfiguration = field(default_factory=VotingConfiguration)
    last_accepted_config: VotingConfiguration = field(default_factory=VotingConfiguration)
    # dynamic cluster settings (ClusterSettings.java:205): persistent
    # survives full-cluster restart; transient is dropped on restart
    # (stripped by the gateway at recovery). Effective = transient over
    # persistent over default.
    settings: dict = field(default_factory=dict)
    transient_settings: dict = field(default_factory=dict)

    # -- builders ---------------------------------------------------------

    def with_(self, **kwargs) -> "ClusterState":
        return replace(self, **kwargs)

    def next_version(self, **kwargs) -> "ClusterState":
        return replace(self, version=self.version + 1, **kwargs)

    # -- views ------------------------------------------------------------

    def shards_for_node(self, node_id: str) -> list[ShardRoutingEntry]:
        return [r for r in self.routing if r.node_id == node_id]

    def shards_for_index(self, index: str) -> list[ShardRoutingEntry]:
        return [r for r in self.routing if r.index == index]

    # name used by the REST-facing views (RoutingTable.index(...) analog)
    routing_for_index = shards_for_index

    def primary(self, index: str, shard: int) -> ShardRoutingEntry | None:
        for r in self.routing:
            if r.index == index and r.shard == shard and r.primary:
                return r
        return None

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "term": self.term,
            "version": self.version,
            "cluster_uuid": self.cluster_uuid,
            "leader_id": self.leader_id,
            "nodes": {nid: n.to_dict() for nid, n in self.nodes.items()},
            "indices": {name: m.to_dict() for name, m in self.indices.items()},
            "routing": [r.to_dict() for r in self.routing],
            "last_committed_config": self.last_committed_config.to_dict(),
            "last_accepted_config": self.last_accepted_config.to_dict(),
            "settings": self.settings,
            "transient_settings": self.transient_settings,
        }

    @staticmethod
    def from_dict(d: dict) -> "ClusterState":
        return ClusterState(
            term=d["term"],
            version=d["version"],
            cluster_uuid=d.get("cluster_uuid", "_na_"),
            leader_id=d.get("leader_id"),
            nodes={nid: DiscoveryNode.from_dict(n) for nid, n in d["nodes"].items()},
            indices={k: IndexMeta.from_dict(v) for k, v in d["indices"].items()},
            routing=tuple(ShardRoutingEntry.from_dict(r) for r in d["routing"]),
            last_committed_config=VotingConfiguration(frozenset(d["last_committed_config"])),
            last_accepted_config=VotingConfiguration(frozenset(d["last_accepted_config"])),
            settings=d.get("settings", {}),
            transient_settings=d.get("transient_settings", {}),
        )



ACTIVE_STATES = ("STARTED", "RELOCATING")


def routing_health(copies) -> str:
    """ClusterStateHealth's status of a set of shard copies: red while a
    primary is not active (a RELOCATING copy is active: a started copy
    that is moving), yellow while a copy is unassigned or initializing
    (a relocation target aside: it is the moving copy's shadow, not a
    missing copy), else green."""
    copies = list(copies)
    if any(r.primary and r.state not in ACTIVE_STATES for r in copies):
        return "red"
    if any(r.state == "UNASSIGNED"
           or (r.state == "INITIALIZING" and not r.is_relocation_target)
           for r in copies):
        return "yellow"
    return "green"

def diff_states(prev: ClusterState, new: ClusterState) -> dict:
    """Version-to-version delta (Diffable machinery analog). Receivers that
    have `prev.version` apply the diff; others request the full state."""
    d: dict[str, Any] = {
        "from_version": prev.version,
        "to_version": new.version,
        "term": new.term,
        "leader_id": new.leader_id,
        "cluster_uuid": new.cluster_uuid,
        "last_committed_config": new.last_committed_config.to_dict(),
        "last_accepted_config": new.last_accepted_config.to_dict(),
    }
    d["nodes_added"] = {
        nid: n.to_dict() for nid, n in new.nodes.items() if nid not in prev.nodes
    }
    d["nodes_removed"] = [nid for nid in prev.nodes if nid not in new.nodes]
    d["indices_changed"] = {
        name: m.to_dict() for name, m in new.indices.items()
        if name not in prev.indices or prev.indices[name] != m
    }
    d["indices_removed"] = [n for n in prev.indices if n not in new.indices]
    if new.routing != prev.routing:
        d["routing"] = [r.to_dict() for r in new.routing]
    if new.settings != prev.settings:
        d["settings"] = new.settings
    if new.transient_settings != prev.transient_settings:
        d["transient_settings"] = new.transient_settings
    return d


def apply_diff(prev: ClusterState, diff: dict) -> ClusterState:
    if diff["from_version"] != prev.version:
        raise ValueError(
            f"diff from version {diff['from_version']} cannot apply to {prev.version}"
        )
    nodes = dict(prev.nodes)
    for nid in diff["nodes_removed"]:
        nodes.pop(nid, None)
    for nid, n in diff["nodes_added"].items():
        nodes[nid] = DiscoveryNode.from_dict(n)
    indices = dict(prev.indices)
    for name in diff["indices_removed"]:
        indices.pop(name, None)
    for name, m in diff["indices_changed"].items():
        indices[name] = IndexMeta.from_dict(m)
    routing = (
        tuple(ShardRoutingEntry.from_dict(r) for r in diff["routing"])
        if "routing" in diff
        else prev.routing
    )
    return ClusterState(
        term=diff["term"],
        version=diff["to_version"],
        cluster_uuid=diff.get("cluster_uuid", prev.cluster_uuid),
        leader_id=diff.get("leader_id"),
        nodes=nodes,
        indices=indices,
        routing=routing,
        last_committed_config=VotingConfiguration(frozenset(diff["last_committed_config"])),
        last_accepted_config=VotingConfiguration(frozenset(diff["last_accepted_config"])),
        settings=diff.get("settings", prev.settings),
        transient_settings=diff.get("transient_settings", prev.transient_settings),
    )
