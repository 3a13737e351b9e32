"""ClusterNode: a full node — coordinator + data shards + action handlers.

Ties the control plane to the data plane the way the reference wires
Node.java: the Coordinator publishes cluster states; every node's
IndicesClusterStateService analog (`_apply_cluster_state`) creates/removes
local IndexShards to match the routing table and runs replica recovery;
write operations route to the primary and fan out to started replicas
(TransportReplicationAction / ReplicationOperation.java:77 semantics);
search scatter-gathers over one copy of each shard (SURVEY.md §3.2).

Transport actions (names mirror the reference's):
    cluster:admin/create_index, cluster:admin/delete_index   (leader)
    internal:cluster/shard_started                           (leader)
    indices:data/write[p]  indices:data/write[r]             (data)
    indices:data/read/get, indices:data/read/search[shard]   (data)
    internal:index/shard/recovery/start                      (data: source)

Recovery model (v1, ops-based): the replica pulls a full live-doc dump +
seq_nos from the primary (the retention-lease ops path of
RecoverySourceHandler.recoverToTarget:171 reduced to its logical core),
then reports shard-started to the leader. Segment(-file) replication is the
planned physical path (indices/replication/ analog) once transport carries
binary payloads.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Any, Callable

from opensearch_tpu_torch.common.errors import (
    IndexNotFoundException,
    OpenSearchTpuException,
    RejectedExecutionException,
    ShardNotFoundException,
)
from opensearch_tpu_torch.common.hashing import shard_id_for_routing
from opensearch_tpu_torch.cluster import residency as residency_mod
from opensearch_tpu_torch.cluster.allocation import (
    mark_shard_started,
    reroute,
)
from opensearch_tpu_torch.cluster.coordinator import Coordinator, Mode
from opensearch_tpu_torch.cluster.state import (
    ClusterState,
    DiscoveryNode,
    IndexMeta,
    ShardRoutingEntry,
    routing_health,
)
from opensearch_tpu_torch.index.mapper import MapperService
from opensearch_tpu_torch.index.shard import IndexShard, ShardId
from opensearch_tpu_torch.search import query_dsl
from opensearch_tpu_torch.telemetry import tracing


def _wall_ms() -> int:
    """Epoch wall-clock ms for retention-lease timestamps — deliberately
    NOT ClusterNode._now_ms (monotonic): lease timestamps persist in the
    commit point and must stay comparable across restarts."""
    from opensearch_tpu_torch.common.timeutil import epoch_millis

    return epoch_millis()
from opensearch_tpu_torch.search.executor import execute_query_phase
from opensearch_tpu_torch.search.service import _source_filter


def _release_then(release: Callable[[], None],
                  callback: Callable[[dict], None]) -> Callable[[dict], None]:
    """Wrap a response callback so an admission slot releases exactly once,
    right before the caller sees the response."""
    def wrapped(resp: dict) -> None:
        release()
        callback(resp)
    return wrapped


class ClusterNode:
    def __init__(
        self,
        node_id: str,
        data_path: str | Path,
        transport,
        scheduler,
        peers: list[str],
        roles: tuple[str, ...] = ("cluster_manager", "data"),
        persisted=None,
        device="cuda",
    ):
        from opensearch_tpu_torch import backend

        self.node_id = node_id
        # every shard this node opens lives on this device: the card
        # unless the caller asks for the CPU
        self.device = backend.resolve_device(device)
        self.data_path = Path(data_path)
        self.transport = transport
        self.scheduler = scheduler
        self.node = DiscoveryNode(node_id=node_id, name=node_id, roles=roles)
        # per-node telemetry: spans land in THIS node's ring (the tracer
        # name prefixes span ids so traces stitched across sim nodes stay
        # unambiguous); trace ids ride transport headers between nodes
        from opensearch_tpu_torch.telemetry.tracing import Telemetry

        self.telemetry = Telemetry(name=node_id)
        # fs stats feeding the disk-threshold decider; tests override
        # disk_usage_pct directly (the FsHealthService probe analog)
        self.disk_usage_pct: float | None = None
        self._node_disk: dict[str, float] = {}
        # fault-injection hooks (testing/soak.py FaultScheduler): a clock
        # skew offsets THIS node's monotonic reads (the timeutil clock is
        # process-global under the sim, so skew must be per-node here);
        # a worker delay stalls the serial data executor's jobs
        self.clock_skew_ms: int = 0
        self.data_worker_delay_ms: int = 0
        # leader-side watermark classification per node (low/high) — a
        # crossing triggers a reroute publication (DiskThresholdMonitor)
        self._disk_classes: dict[str, tuple[bool, bool]] = {}
        from opensearch_tpu_torch.cluster.allocation import AllocationSettings

        def transform(state: ClusterState) -> ClusterState:
            disk = dict(self._node_disk)
            own = self._disk_usage()
            if own is not None:
                disk[node_id] = own
            return reroute(state, AllocationSettings.from_cluster(state, disk))

        self.coordinator = Coordinator(
            self.node, peers, transport, scheduler,
            persisted=persisted,
            on_state_applied=self._apply_cluster_state,
            # every publication passes through allocation: node joins/leaves
            # re-assign shards, promote replicas, fill replica slots;
            # allocation settings resolve from the DYNAMIC cluster settings
            # in the state being published
            state_transform=transform,
        )
        self.coordinator.tracer = self.telemetry.tracer
        self.coordinator.check_extras = lambda: {
            "disk_used_pct": self._disk_usage()
        }

        def on_extras(peer: str, extras: dict) -> None:
            pct = extras.get("disk_used_pct")
            if pct is not None:
                self._node_disk[peer] = float(pct)
                self._maybe_reroute_on_disk(peer, float(pct))

        self.coordinator.on_follower_extras = on_extras
        # addSettingsUpdateConsumer registry, notified at state application
        from opensearch_tpu_torch.cluster.cluster_settings import (
            SettingsUpdateConsumers,
        )

        self.settings_consumers = SettingsUpdateConsumers()
        # kNN dispatch batcher: process-wide scheduler (one process == one
        # device); this node wires its metrics sink and subscribes its
        # settings keys to the cluster-state settings consumer, so dynamic
        # updates reach the data plane in cluster mode too
        from opensearch_tpu_torch.search import batcher as _batcher_mod

        self.knn_batcher = _batcher_mod.default_batcher
        self.knn_batcher.metrics = self.telemetry.metrics
        self.settings_consumers.register(
            "search.knn.batch.", self.knn_batcher.apply_settings
        )
        # roofline recorder: process-wide like the batcher; this node
        # becomes its fallback metrics sink (active_metrics() still wins
        # per request, so in-process sims attribute per executing node).
        # Peaks calibrate at boot (cached per platform; a sim's stub
        # wins) — never lazily inside a stats poll.
        from opensearch_tpu_torch.telemetry import roofline as _roofline_mod

        _roofline_mod.default_recorder.metrics = self.telemetry.metrics
        _roofline_mod.ensure_peaks(self.device)
        # kNN serving knobs (search/ann.py): process-wide like the batcher,
        # applied live the same way. The prefix is "search.knn." (not
        # ".ann.") because the exact-path policy keys — search.knn.kernel
        # and search.knn.score_precision — sit directly under it;
        # apply_settings re-derives every field from the effective map, so
        # firing on an unrelated search.knn.batch.* change is a no-op
        from opensearch_tpu_torch.search import ann as _ann_mod

        self.settings_consumers.register(
            "search.knn.", _ann_mod.default_config.apply_settings
        )
        # shard-mesh HBM byte budget (cluster/shard_mesh.py): dynamic
        # search.mesh.hbm_budget_bytes reaches the registry at state
        # application, so a PUT retunes residency pressure cluster-wide
        from opensearch_tpu_torch.cluster.shard_mesh import default_registry

        self.settings_consumers.register(
            "search.mesh.", default_registry.apply_settings
        )
        # span exporter: per-node (its ring is per-node); dynamic
        # telemetry.tracing.* updates rebuild/retune it at state application
        from opensearch_tpu_torch.telemetry.export import apply_tracing_settings

        self.settings_consumers.register(
            "telemetry.tracing.",
            lambda eff: apply_tracing_settings(
                self.telemetry, eff, self.data_path, service_name=node_id),
        )
        # priority lanes (search/lanes.py): process-wide policy like the
        # batcher; dynamic search.lanes.* retunes the pool split + the
        # background queue bound at state application
        from opensearch_tpu_torch.search import lanes as _lanes_mod

        self.settings_consumers.register(
            "search.lanes.", _lanes_mod.default_config.apply_settings
        )
        self.lane_tracker = _lanes_mod.LaneTracker()
        # residency-aware replica routing (cluster/residency.py): this
        # node's COORDINATOR-side board of warm copies, fed by the
        # _residency stamps kNN partials carry back; the dynamic toggle
        # rides the settings consumer like the lanes
        self.settings_consumers.register(
            "search.routing.", residency_mod.default_config.apply_settings
        )
        self.residency_board = residency_mod.ResidencyBoard()
        # heat/touch accounting (telemetry/device_ledger.py): the ledger
        # is process-wide like the batcher; dynamic telemetry.heat.*
        # (enabled, advisor ring size) reaches it at state application
        from opensearch_tpu_torch.telemetry.device_ledger import (
            default_ledger as _heat_ledger,
        )

        self.settings_consumers.register(
            "telemetry.heat.", _heat_ledger.apply_heat_settings
        )
        # cross-node residency advertisement (ISSUE 15): a fresh
        # coordinator seeds its board from the data nodes' warm sets
        # piggybacked on the light stats RPC — fired once, at the first
        # state application that shows other nodes (join traffic), so
        # cold-start routing stops round-robining onto warm copies
        self._residency_seeded = False
        # last advertisement seen per node, so a pair that DROPS OUT of a
        # node's warm set (bundle evicted under budget pressure) is
        # observed cold — an advertise-only board would latch stale
        # warmth forever; pruned with the board at state application
        self._advertised_residency: dict[str, set] = {}
        self._advertised_lock = threading.Lock()
        # round-robin sequence for cold routing decisions (no warm copy
        # known yet): one draw per fan-out keeps the shard set on one
        # replica rank instead of scattering the first build
        import itertools as _it

        self._route_rr = _it.count(0)
        # extra per-node stats sections for the cluster-wide _nodes/stats
        # fan-out: coordinator-side services (the facade's request cache)
        # register a provider here so the node RPC can report them
        self.stats_providers: dict[str, Callable[[], dict]] = {}
        # workload-management groups: one registry per node, shared with the
        # REST facade; bulk admission (wlm.admit_bulk) sheds tagged bulk
        # traffic past its group's slot share with 429 BEFORE fan-out
        from opensearch_tpu_torch.wlm import QueryGroupService

        self.query_groups = QueryGroupService(
            self.data_path / "query_groups.json"
        )
        self.local_shards: dict[tuple[str, int], IndexShard] = {}
        self._mapper_services: dict[str, MapperService] = {}
        self._index_versions: dict[str, int] = {}
        # primary-side recovery tracking (ReplicationTracker.initiateTracking
        # analog): targets that requested recovery receive concurrent writes
        # even before the routing table shows them STARTED — otherwise ops
        # arriving between the recovery dump and shard-started are lost
        self._tracked_targets: dict[tuple[str, int], set[str]] = {}
        # recovery-source mode counters (tests assert ops-based recovery
        # ships zero segment bytes when a retention lease holds)
        self.recovery_stats = {"ops_based": 0, "segment_based": 0,
                               "dump_based": 0}
        # recovery subsystem (indices/recovery/ analog): source-side chunk
        # sessions + target-side progress records (RecoveryState), exposed
        # via indices:monitor/recovery[node] for _cat/recovery
        from opensearch_tpu_torch.index.recovery import RecoverySourceSessions

        self._recovery_sources = RecoverySourceSessions()
        self._recovery_drivers: dict[tuple[str, int], Any] = {}
        self.recoveries: dict[tuple[str, int], Any] = {}
        # last routing state THIS node observed for its own copies: a
        # STARTED -> INITIALIZING transition on the same key means the
        # leader reset the copy while we were dark (see
        # _apply_cluster_state's assignment-epoch check)
        self._last_routing_state: dict[tuple[str, int], str] = {}

        reg = transport.register
        reg(node_id, "cluster:admin/create_index", self._on_create_index)
        reg(node_id, "cluster:admin/settings/update", self._on_update_settings)
        reg(node_id, "cluster:admin/delete_index", self._on_delete_index)
        reg(node_id, "cluster:admin/put_mapping", self._on_put_mapping)
        reg(node_id, "internal:cluster/shard_started", self._on_shard_started)
        reg(node_id, "internal:cluster/shard_failed", self._on_shard_failed)
        reg(node_id, "indices:data/write[p]", self._on_primary_write)
        reg(node_id, "indices:data/write[r]", self._on_replica_write)
        reg(node_id, "indices:data/write[p][bulk]", self._on_primary_bulk)
        reg(node_id, "indices:data/write[r][bulk]", self._on_replica_bulk)
        reg(node_id, "indices:data/read/get", self._on_get)
        reg(node_id, "indices:data/read/explain", self._on_explain)
        reg(node_id, "indices:data/read/search[shard]", self._on_shard_search)
        reg(node_id, "indices:data/read/search[node]", self._on_node_search)
        reg(node_id, "indices:data/read/msearch[node]", self._on_node_msearch)
        reg(node_id, "indices:data/read/search[ctx]", self._on_ctx_search)
        reg(node_id, "indices:data/read/ctx_close", self._on_ctx_close)
        reg(node_id, "indices:admin/refresh[shard]", self._on_shard_refresh)
        reg(node_id, "indices:admin/flush[node]", self._on_node_flush)
        reg(node_id, "indices:admin/forcemerge[node]", self._on_node_forcemerge)
        reg(node_id, "indices:monitor/stats[node]", self._on_node_stats)
        reg(node_id, "cluster:admin/otel/flush[node]", self._on_otel_flush)
        reg(node_id, "indices:replication/checkpoint", self._on_replication_checkpoint)
        reg(node_id, "indices:replication/get_segments", self._on_get_segments)
        reg(node_id, "internal:index/shard/recovery/start", self._on_start_recovery)
        reg(node_id, "internal:index/shard/recovery/file_chunk",
            self._on_recovery_file_chunk)
        reg(node_id, "internal:index/shard/recovery/ops_chunk",
            self._on_recovery_ops_chunk)
        reg(node_id, "internal:index/shard/recovery/finalize",
            self._on_recovery_finalize)
        reg(node_id, "indices:monitor/recovery[node]", self._on_node_recovery)
        reg(node_id, "internal:snapshot/shard_dump", self._on_snapshot_shard_dump)
        reg(node_id, "internal:snapshot/restore_dump",
            self._on_snapshot_restore_dump)
        # per-node reader contexts (scroll/PIT pin snapshots node-side; the
        # coordinator's scroll id maps node -> local ctx — ReaderContext
        # .java:64 semantics distributed)
        self._reader_contexts: dict[str, dict] = {}
        # heavy query phases run OFF the transport loop so a slow search
        # cannot stall heartbeats/elections (VERDICT r2 weak #9); one worker
        # keeps the engine's single-writer discipline for WRITE/engine work
        self._data_executor = None
        # read-only searches get a PARALLEL pool (the reference's `search`
        # threadpool; same split rest/http.py uses): they execute against
        # immutable acquired snapshots, so they need no single-writer
        # discipline — and serializing them behind the data worker meant
        # concurrent search[node] requests could never reach the kNN
        # dispatch batcher together, so cross-request coalescing (and the
        # shard-mesh launch amortization) never engaged in cluster mode.
        # Background-lane work (msearch[node] fan-outs and anything the
        # coordinator marked background) runs its OWN smaller pool so a
        # flood of it can never occupy the interactive workers (ISSUE 11).
        self._search_executor = None
        self._bg_search_executor = None
        # ctx ids mint on the parallel pool: itertools.count is atomic
        # under the GIL where `self._ctx_seq += 1` is read-modify-write
        # (_it imported above for the routing round-robin)
        self._ctx_counter = _it.count(1)
        # device-resident shard bundles for the mesh kNN path, keyed by
        # reader generation (cluster/shard_mesh.py); process-wide like the
        # batcher — invalidated when this node's shards leave
        from opensearch_tpu_torch.cluster.shard_mesh import default_registry

        self.shard_mesh = default_registry
        # mesh launch walls land in this node's histograms (exemplar-linked
        # like the batcher's queue-wait: a p99 launch links to its trace)
        self.shard_mesh.metrics = self.telemetry.metrics

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        # recovered durable state: recreate local shards BEFORE elections so
        # a restarted node serves its recovered data (GatewayService state
        # recovery; shard data itself replays from translog/commits in the
        # Engine constructor)
        if self.applied_state.indices:
            self._apply_cluster_state(self.applied_state)
        self.coordinator.start()
        self._schedule_shard_state_tick()

    # ShardStateAction resend loop: a shard-started message can be LOST
    # (leader change, half-open link) and with no further publication the
    # copy would sit INITIALIZING forever. Periodically re-report local
    # copies that finished recovering until the routing table shows them
    # STARTED (the reference resends via ShardStateAction retries).
    _SHARD_STATE_TICK_MS = 2_000

    def _schedule_shard_state_tick(self) -> None:
        if getattr(self, "_closed", False):
            return
        self._shard_tick_timer = self.scheduler.schedule(
            self._SHARD_STATE_TICK_MS, self._shard_state_tick
        )

    def _maybe_reroute_on_disk(self, nid: str, pct: float | None) -> None:
        """DiskThresholdMonitor analog: disk stats arrive on heartbeat
        acks, but reroute only runs INSIDE a publication — without a
        trigger, a node filling past the high watermark would sit full
        until some unrelated state change. A watermark-classification
        crossing (below/above low, below/above high, either direction)
        on any node submits an identity task so the publication
        transform's reroute evaluates the new disk picture."""
        if not self.is_leader:
            return
        from opensearch_tpu_torch.cluster.allocation import AllocationSettings

        s = AllocationSettings.from_cluster(self.applied_state)
        cls = (False, False) if pct is None else (
            pct >= s.disk_low_watermark_pct,
            pct >= s.disk_high_watermark_pct,
        )
        if self._disk_classes.get(nid, (False, False)) == cls:
            return
        self._disk_classes[nid] = cls
        from opensearch_tpu_torch.cluster.coordination import CoordinationError

        try:
            self.coordinator.submit_state_update(lambda st: st)
        except CoordinationError:
            pass

    def _allocator_pending(self) -> bool:
        """Would the publication transform's reroute change the applied
        routing table? Uses the same disk picture the transform uses, so
        a True here means the next publication makes progress."""
        from opensearch_tpu_torch.cluster.allocation import (
            AllocationSettings,
            reroute,
        )

        state = self.applied_state
        disk = dict(self._node_disk)
        own = self._disk_usage()
        if own is not None:
            disk[self.node_id] = own
        out = reroute(state, AllocationSettings.from_cluster(state, disk))
        return set(out.routing) != set(state.routing)

    def _shard_state_tick(self) -> None:
        if getattr(self, "_closed", False):
            return
        # expired reader contexts reap on a TICK, not only on the next
        # search[node] arrival: a node whose copies stop being query
        # targets (all-replica holder, post-relocation) would otherwise
        # pin expired scroll/PIT snapshots forever (the reference runs a
        # dedicated keep-alive reaper thread for the same reason)
        self._reap_reader_contexts()
        # the leader's OWN disk crossing a watermark must trigger a
        # reroute too (no heartbeat carries it back to itself)
        if self.is_leader:
            self._maybe_reroute_on_disk(self.node_id, self._disk_usage())
            # RoutingService analog: multi-step reshapes (rebalance chains,
            # primary-role swaps, evacuations) apply ONE change per
            # publication and rely on a follow-up to continue — but the
            # last change of a chain has no natural follow-up event. If
            # the allocator still wants changes against the applied state,
            # nudge a publication so the chain converges instead of
            # stalling one step short.
            if self._allocator_pending():
                from opensearch_tpu_torch.cluster.coordination import (
                    CoordinationError,
                )

                try:
                    self.coordinator.submit_state_update(lambda st: st)
                except CoordinationError:
                    pass
        for r in self.applied_state.shards_for_node(self.node_id):
            if r.state != "INITIALIZING":
                continue
            shard = self.local_shards.get((r.index, r.shard))
            if shard is not None and (
                r.primary or getattr(shard, "recovery_done", False)
            ):
                self._report_shard_started(r.index, r.shard)
        self._schedule_shard_state_tick()

    def bootstrap(self, voting_ids: list[str]) -> None:
        self.coordinator.bootstrap(voting_ids)

    @property
    def applied_state(self) -> ClusterState:
        return self.coordinator.applied_state

    @property
    def is_leader(self) -> bool:
        return self.coordinator.mode == Mode.LEADER

    # ------------------------------------------------------------------ #
    # cluster state application (IndicesClusterStateService analog)
    # ------------------------------------------------------------------ #

    def _mapper_for(self, index: str, state: ClusterState) -> MapperService:
        meta = state.indices[index]
        ms = self._mapper_services.get(index)
        if ms is None or self._index_versions.get(index, -1) < meta.version:
            ms = MapperService(meta.mappings or None)
            self._mapper_services[index] = ms
            self._index_versions[index] = meta.version
        return ms

    def _apply_cluster_state(self, state: ClusterState) -> None:
        from opensearch_tpu_torch.cluster.cluster_settings import effective

        self.settings_consumers.apply(
            effective(state.settings, state.transient_settings)
        )
        # disk stats ride follower-check acks keyed by node id; departed
        # nodes must not accrete entries forever (TPU009: every long-lived
        # map on the sim/serving path needs eviction)
        self._node_disk = {
            nid: pct for nid, pct in self._node_disk.items()
            if nid in state.nodes
        }
        self._disk_classes = {
            nid: cls for nid, cls in self._disk_classes.items()
            if nid in state.nodes
        }
        # residency-routing board: a departed node or deleted index must
        # never look warm to the replica router (candidates re-filter by
        # routing state anyway — this is the memory bound + staleness cut)
        self.residency_board.prune(
            live_nodes=set(state.nodes),
            live_indices=set(state.indices),
        )
        with self._advertised_lock:
            for nid in [n for n in self._advertised_residency
                        if n not in state.nodes]:
                del self._advertised_residency[nid]
        my_shards = {
            (r.index, r.shard): r for r in state.shards_for_node(self.node_id)
        }
        # remove shards no longer assigned here (or whose index is deleted)
        for key in list(self.local_shards):
            if key not in my_shards or key[0] not in state.indices:
                shard = self.local_shards.pop(key)
                # a departing shard invalidates the index's device-resident
                # mesh bundles: the residency key pins engine instance ids,
                # so a stale bundle could never serve wrong data — this
                # just releases HBM promptly instead of waiting on LRU
                self.shard_mesh.invalidate_index(key[0])
                self._tracked_targets.pop(key, None)
                driver = self._recovery_drivers.pop(key, None)
                if driver is not None:
                    driver.cancel()
                # the recovery record leaves the node with its shard, like
                # the reference's per-shard RecoveryState
                self.recoveries.pop(key, None)
                shard.close()
                # a copy that MOVED AWAY (relocation swap completed, or the
                # allocator rebalanced it) deletes its local files when the
                # cluster holds another live copy — IndicesStore
                # .deleteShardIfExistElseWhere. A plain node-left keeps the
                # files: a returning node recovers far cheaper from them
                # (ops-based path off the local checkpoint).
                if key[0] in state.indices and any(
                    r.node_id not in (None, self.node_id)
                    and r.state in ("STARTED", "RELOCATING")
                    for r in state.routing if (r.index, r.shard) == key
                ):
                    import shutil

                    shutil.rmtree(
                        self.data_path / "indices" / key[0] / str(key[1]),
                        ignore_errors=True,
                    )
        # recovery progress records and source sessions die with their index
        for key in [k for k in self.recoveries if k[0] not in state.indices]:
            del self.recoveries[key]
        # drop tracked recovery targets that are no longer assigned copies,
        # and release their retention leases — a departed copy must not pin
        # translog history forever (ReplicationTracker removes peer leases
        # when the routing table drops the copy)
        for key, targets in list(self._tracked_targets.items()):
            assigned = {
                r.node_id for r in state.routing
                if (r.index, r.shard) == key and r.node_id is not None
            }
            gone = targets - assigned
            local = self.local_shards.get(key)
            if gone and local is not None and local.primary:
                for nid in gone:
                    local.engine.retention_leases.remove(
                        f"peer_recovery/{nid}")
            for nid in gone:
                # a departed target's chunk session stops pinning blobs
                self._recovery_sources.drop_target(key[0], key[1], nid)
            targets &= assigned
            if not targets:
                self._tracked_targets.pop(key, None)
        for index_name in list(self._mapper_services):
            if index_name not in state.indices:
                self._mapper_services.pop(index_name, None)
                self._index_versions.pop(index_name, None)
        # create newly assigned shards
        for (index_name, shard_num), entry in my_shards.items():
            if index_name not in state.indices:
                continue
            if (index_name, shard_num) not in self.local_shards:
                ms = self._mapper_for(index_name, state)
                path = self.data_path / "indices" / index_name / str(shard_num)
                from opensearch_tpu_torch.index.shard import (
                    replication_type,
                    translog_durability,
                )

                shard = IndexShard(
                    ShardId(index_name, shard_num), path, ms,
                    durability=translog_durability(
                        state.indices[index_name].settings
                    ),
                    replication=replication_type(
                        state.indices[index_name].settings
                    ),
                    device=self.device,
                )
                shard.primary = entry.primary
                self.local_shards[(index_name, shard_num)] = shard
                if entry.state == "INITIALIZING":
                    if entry.primary:
                        # local (possibly empty) store is authoritative
                        from opensearch_tpu_torch.index.recovery import (
                            RecoveryProgress,
                        )

                        p = RecoveryProgress(
                            index_name, shard_num, self.node_id,
                            recovery_type=(
                                "EXISTING_STORE" if shard.num_docs
                                else "EMPTY_STORE"),
                        )
                        p.done()
                        self.recoveries[(index_name, shard_num)] = p
                        self._report_shard_started(index_name, shard_num)
                    else:
                        self._start_replica_recovery(index_name, shard_num, state)
                elif not entry.primary:
                    # entry says STARTED but we just CREATED this shard
                    # object (e.g. a wiped node rejoined under its old id
                    # while never evicted): local content is unknown —
                    # re-sync from the primary before trusting it
                    self._start_replica_recovery(index_name, shard_num, state)
            else:
                shard = self.local_shards[(index_name, shard_num)]
                was_primary = shard.primary
                shard.primary = entry.primary
                prev_state = self._last_routing_state.get(
                    (index_name, shard_num))
                if (entry.state == "INITIALIZING" and not entry.primary
                        and prev_state in ("STARTED", "RELOCATING")
                        and getattr(shard, "recovery_done", False)):
                    # the leader RESET this copy: we last saw ourselves
                    # STARTED, now we are INITIALIZING again — we were
                    # evicted while dark (kill/partition) and re-assigned
                    # the same slot. recovery_done belongs to the previous
                    # assignment epoch; trusting it would report a copy
                    # that MISSED acked writes as started (permanent
                    # divergence — the chaos soak's copy-agreement
                    # invariant caught this). Re-sync from the primary.
                    shard.recovery_done = False
                    shard.recovery_inflight = False
                if (entry.primary and not was_primary
                        and shard.replication == "SEGMENT"):
                    # promotion of a segrep replica: translog ops not yet
                    # covered by replicated segments must become searchable
                    # (the reference's NRT replica -> InternalEngine swap)
                    def promote(s=shard):
                        s.engine.replay_translog_tail()
                        s.refresh()

                    self._offload(promote)
                if entry.state == "INITIALIZING":
                    # re-report on every publication until the leader records
                    # STARTED — a lost shard-started message (timeout, old
                    # leader died) must not leave the copy INITIALIZING
                    # forever (ShardStateAction resend semantics)
                    if entry.primary or getattr(shard, "recovery_done", False):
                        self._report_shard_started(index_name, shard_num)
                    elif not getattr(shard, "recovery_inflight", False):
                        # a pre-existing local copy (e.g. recreated from
                        # persisted state after a restart) assigned
                        # INITIALIZING must still re-sync from the primary —
                        # its local data may be arbitrarily stale
                        shard.recovery_inflight = True
                        self._start_replica_recovery(
                            index_name, shard_num, state
                        )
        self._last_routing_state = {
            key: entry.state for key, entry in my_shards.items()
        }
        # cross-node residency advertisement (ISSUE 15): a coordinator
        # seeing other nodes for the first time (its own join, or theirs)
        # seeds its ResidencyBoard from their advertised warm sets
        self._maybe_seed_residency_board()

    # -- shard started / recovery ------------------------------------------

    def _report_shard_started(self, index: str, shard: int) -> None:
        leader = self.applied_state.leader_id or self.coordinator.leader_id
        if leader is None:
            return
        self.transport.send(
            self.node_id, leader, "internal:cluster/shard_started",
            {"index": index, "shard": shard, "node_id": self.node_id},
            on_response=None, on_failure=lambda e: None,
        )

    def _on_shard_started(self, sender: str, payload: dict) -> dict:
        if not self.is_leader:
            raise OpenSearchTpuException("not the leader")
        self.coordinator.submit_state_update(
            lambda s: mark_shard_started(
                s, payload["index"], payload["shard"], payload["node_id"]
            )
        )
        return {"ack": True}

    def _after_offload(self, fn, cb) -> None:
        """Run `fn` on the data worker; `cb(ok: bool)` fires back on the
        transport execution context (synchronously under the sim)."""
        out = self._offload(fn)
        from opensearch_tpu_torch.transport.base import DeferredResponse

        if isinstance(out, DeferredResponse):
            out.on_done(lambda d: cb(d.error is None and bool(d.result)))
        else:
            cb(bool(out))

    def _start_replica_recovery(self, index: str, shard: int, state: ClusterState) -> None:
        """Target-side peer recovery (RecoveryTarget analog): request a
        manifest from the primary, stream what it names in bounded chunks
        (per-chunk timeout + exponential-backoff retry), catch up live
        writes via the seqno handoff, then report shard-started."""
        local = self.local_shards.get((index, shard))
        if local is not None:
            local.recovery_inflight = True
        primary = state.primary(index, shard)
        if primary is None or primary.node_id is None or primary.state != "STARTED":
            # retry later — the primary may still be initializing
            self.scheduler.schedule(
                500, lambda: self._retry_recovery(index, shard)
            )
            return
        from opensearch_tpu_torch.index.recovery import (
            RecoveryProgress,
            RecoveryTargetDriver,
        )

        entry = next(
            (r for r in state.shards_for_node(self.node_id)
             if r.index == index and r.shard == shard), None
        )
        progress = RecoveryProgress(
            index, shard, self.node_id, primary.node_id,
            recovery_type=(
                "RELOCATION" if entry is not None and entry.relocating_node
                else "PEER"
            ),
        )
        self.recoveries[(index, shard)] = progress
        old = self._recovery_drivers.pop((index, shard), None)
        if old is not None:
            old.cancel()
        # target-side root span for this recovery attempt: every chunk,
        # retry and finalize request joins its trace (a retried attempt is
        # a FRESH span/trace — each attempt's tree stays self-consistent)
        rec_span = self.telemetry.tracer.begin_span(
            "recovery.target",
            {"index": index, "shard": shard, "node": self.node_id,
             "source": primary.node_id, "type": progress.recovery_type},
        )
        rec_trace = {"trace_id": rec_span.trace_id,
                     "span_id": rec_span.span_id}
        span_open = [True]

        def finish_span(outcome: str) -> None:
            if span_open[0]:
                span_open[0] = False
                rec_span.set_attribute("outcome", outcome)
                self.telemetry.tracer.end_span(rec_span)

        driver = RecoveryTargetDriver(
            self.transport, self.scheduler, self.node_id, primary.node_id,
            index, shard, progress, trace=rec_trace, root_span=rec_span,
        )
        self._recovery_drivers[(index, shard)] = driver

        def fail_and_retry(_e: Exception | None = None) -> None:
            if driver.cancelled:
                finish_span("cancelled")
                return
            progress.failed()
            finish_span("failed")
            if self._recovery_drivers.get((index, shard)) is driver:
                self._recovery_drivers.pop((index, shard), None)
            self.scheduler.schedule(
                1000, lambda: self._retry_recovery(index, shard)
            )

        def succeed() -> None:
            if driver.cancelled:
                # superseded mid-install (shard evicted/recreated): the
                # fresh driver owns the shard's fate — marking recovery_done
                # here would report a possibly-empty copy as STARTED
                finish_span("cancelled")
                return
            lcl = self.local_shards.get((index, shard))
            if lcl is not None:
                lcl.recovery_done = True
                lcl.recovery_inflight = False
            progress.done()
            finish_span("done")
            if self._recovery_drivers.get((index, shard)) is driver:
                self._recovery_drivers.pop((index, shard), None)
            self._report_shard_started(index, shard)

        def finalize_then(done_fn) -> None:
            lcl = self.local_shards.get((index, shard))
            if lcl is None:
                fail_and_retry()
                return
            driver.finalize(
                lambda: lcl.engine.local_checkpoint,
                lambda ok: done_fn() if ok else fail_and_retry(),
            )

        def on_manifest(resp) -> None:
            if driver.cancelled or not isinstance(resp, dict):
                fail_and_retry()
                return
            mode = resp.get("mode")
            if mode == "ops":
                self._recover_from_ops(index, shard, resp, progress,
                                       succeed, fail_and_retry)
            elif mode == "segment":
                self._recover_from_segments(
                    index, shard, resp, driver, progress,
                    lambda: finalize_then(succeed), fail_and_retry,
                )
            elif mode == "dump":
                self._recover_from_dump(
                    index, shard, resp, driver, progress,
                    lambda: finalize_then(succeed), fail_and_retry,
                )
            else:
                fail_and_retry()

        with tracing.restore_trace_context(rec_trace):
            self.transport.send(
                self.node_id, primary.node_id,
                "internal:index/shard/recovery/start",
                {"index": index, "shard": shard, "target": self.node_id,
                 # the target's recovered-from-disk progress: with a valid
                 # retention lease the source answers with an OPS-ONLY replay
                 # from here instead of a segment copy
                 "local_checkpoint": (
                     local.engine.local_checkpoint if local is not None else -1
                 )},
                on_response=on_manifest,
                on_failure=fail_and_retry,
                # the manifest itself is small; the bulk ships as chunks
                timeout_ms=60_000,
            )

    def _recover_from_ops(self, index: str, shard: int, resp: dict,
                          progress, succeed, fail) -> None:
        """Ops-only replay (retention-lease fast path): small by
        construction, applied in one offloaded step."""
        ops = resp.get("ops") or []
        progress.stage = "TRANSLOG"
        progress.ops_total = len(ops)

        def apply() -> bool:
            local = self.local_shards.get((index, shard))
            if local is None:
                return False
            for op in ops:
                if op["op"] == "index":
                    local.apply_index_on_replica(
                        op["id"], op["source"], op["seq_no"],
                        op.get("routing"),
                    )
                else:
                    local.apply_delete_on_replica(op["id"], op["seq_no"])
            # replayed history must survive a crash of this node
            local.engine.translog.sync()
            local.refresh()
            progress.ops_recovered = len(ops)
            return True

        self._after_offload(apply, lambda ok: succeed() if ok else fail())

    def _recover_from_segments(self, index: str, shard: int, resp: dict,
                               driver, progress, succeed, fail) -> None:
        """File-based recovery target: stream the primary's changed
        segments in byte-range chunks, install them verbatim (no
        re-analysis), append the translog tail, then FLUSH — the recovered
        state must survive a crash of this node (segments + commit +
        translog on disk)."""
        local = self.local_shards.get((index, shard))
        if local is None:
            fail()
            return
        have = local.engine.segment_sigs()
        want_sigs = resp.get("sigs") or {}
        order = list(resp["order"])
        need = [n for n in order if have.get(n) != want_sigs.get(n)]
        tail_ops = resp.get("ops") or []

        def after_files(ok: bool, blobs: dict) -> None:
            if not ok:
                fail()
                return

            def install() -> bool:
                from opensearch_tpu_torch.index.segment import unpack_segment

                lcl = self.local_shards.get((index, shard))
                if lcl is None:
                    return False
                hosts = [unpack_segment(blobs[n]) for n in need if n in blobs]
                lcl.engine.install_replicated_segments(hosts, order)
                for op in tail_ops:
                    entry = lcl.engine.version_map.get(op["id"])
                    if entry is not None and entry.seq_no >= op["seq_no"]:
                        continue  # covered by an installed segment
                    lcl.engine.append_translog_op(op)
                # segments + tail form a point-in-time copy at max_seq_no;
                # superseded ops' seq-no holes must not pin the checkpoint
                # below the handoff (same contract as the dump path)
                lcl.engine.tracker.fast_forward_processed(
                    int(resp.get("max_seq_no", -1)))
                # durability: the recovered copy must survive a crash
                # BEFORE its first local flush (installed segments existed
                # only in memory until here)
                lcl.engine.flush()
                progress.ops_recovered = len(tail_ops)
                return True

            self._after_offload(install,
                                lambda ok2: succeed() if ok2 else fail())

        progress.ops_total = len(tail_ops)
        driver.fetch_files(need, resp.get("sizes") or {}, after_files)

    def _recover_from_dump(self, index: str, shard: int, resp: dict,
                           driver, progress, succeed, fail) -> None:
        """Logical live-doc dump, pulled in bounded batches and applied as
        each lands (document-replication fresh target)."""
        total = int(resp.get("total_ops", 0))

        def apply_batch(batch: list, cont) -> None:
            def run() -> bool:
                lcl = self.local_shards.get((index, shard))
                if lcl is None:
                    return False
                for op in batch:
                    if op["op"] == "index":
                        lcl.apply_index_on_replica(
                            op["id"], op["source"], op["seq_no"],
                            op.get("routing"),
                        )
                    else:
                        lcl.apply_delete_on_replica(op["id"], op["seq_no"])
                return True

            self._after_offload(run, cont)

        def after_ops(ok: bool) -> None:
            if not ok:
                fail()
                return

            def finish() -> bool:
                lcl = self.local_shards.get((index, shard))
                if lcl is None:
                    return False
                # the dump is a point-in-time snapshot at max_seq_no: ops
                # superseded before the snapshot (overwritten/deleted docs)
                # left seq-no holes no future op can fill — jump the local
                # checkpoint over them or the FINALIZE handoff wedges
                lcl.engine.tracker.fast_forward_processed(
                    int(resp.get("max_seq_no", -1)))
                lcl.engine.translog.sync()
                lcl.refresh()
                return True

            self._after_offload(finish,
                                lambda ok2: succeed() if ok2 else fail())

        driver.fetch_ops(total, apply_batch, after_ops)

    def _retry_recovery(self, index: str, shard: int) -> None:
        if (index, shard) in self.local_shards and not self.local_shards[(index, shard)].primary:
            entry = next(
                (r for r in self.applied_state.shards_for_node(self.node_id)
                 if r.index == index and r.shard == shard), None
            )
            if entry is not None and entry.state == "INITIALIZING":
                self._start_replica_recovery(index, shard, self.applied_state)

    def _on_start_recovery(self, sender: str, payload: dict):
        def run() -> dict:
            with tracing.activate(self.telemetry.tracer), \
                    self.telemetry.tracer.start_span("recovery.source_start", {
                        "index": payload["index"],
                        "shard": payload["shard"],
                        "target": payload.get("target"),
                        "node": self.node_id}):
                return self._start_recovery_local(payload)

        return self._offload(run)

    def _start_recovery_local(self, payload: dict) -> dict:
        """Primary-side recovery source. OPS-BASED fast path first
        (RecoverySourceHandler.recoverToTarget:171: when a peer-recovery
        retention lease retains history from the target's checkpoint,
        phase1 file copy is SKIPPED entirely and phase2 replays the ops);
        otherwise SEGMENT replication ships the sealed segment files +
        translog tail, and DOCUMENT replication the logical live-doc dump."""
        shard = self._local_shard(payload["index"], payload["shard"])
        target = payload["target"]
        target_ckpt = int(payload.get("local_checkpoint", -1))
        # a target that died mid-transfer without being evicted must not
        # pin packed blobs forever
        self._recovery_sources.reap()
        # ops-based recovery serves DOCUMENT replication; a segrep replica's
        # searchable state is the primary's segment set, so its recovery
        # stays the sig-diff file sync (only changed segments transfer)
        if target_ckpt >= 0 and shard.replication != "SEGMENT":
            # track BEFORE snapshotting history (same invariant as the
            # full-dump path below): a write landing in between must reach
            # the target through the fan-out
            self._tracked_targets.setdefault(
                (payload["index"], payload["shard"]), set()
            ).add(target)
            ops = shard.engine.history_ops_from(target_ckpt + 1)
            if ops is not None:
                shard.engine.retention_leases.add_or_renew(
                    f"peer_recovery/{target}", target_ckpt + 1,
                    _wall_ms(),
                )
                self.recovery_stats["ops_based"] += 1
                return {"mode": "ops", "ops": ops,
                        "max_seq_no": shard.engine.max_seq_no}
        if shard.replication == "SEGMENT":
            self._tracked_targets.setdefault(
                (payload["index"], payload["shard"]), set()
            ).add(payload["target"])
            self.recovery_stats["segment_based"] += 1
            # phase1 manifest only — the target pulls each needed segment
            # as byte-range chunks from the session opened here (bounded
            # frame sizes); phase2 = the translog tail in the manifest
            session = self._recovery_sources.open(
                payload["index"], payload["shard"], target,
                mode="segment",
                max_seq_no=shard.engine.max_seq_no,
            )
            # immutable host refs captured NOW; chunks pack lazily from them
            session["hosts"] = {
                h.name: h for h, _dev in shard.engine._segments
            }
            return {
                "mode": "segment",
                "order": shard.engine.segment_names(),
                "sigs": shard.engine.segment_sigs(),
                "ops": shard.engine.translog_tail_ops(),
                "max_seq_no": shard.engine.max_seq_no,
            }
        # track the target BEFORE snapshotting: every write from here on is
        # fanned out to it, and the seq_no stale-op check on the target makes
        # the dump/fan-out overlap idempotent in either arrival order
        self._tracked_targets.setdefault(
            (payload["index"], payload["shard"]), set()
        ).add(payload["target"])
        # establish the peer lease NOW: a flush landing between this dump
        # and the copy's first write-ack must not trim the history its next
        # ops-based recovery would need
        shard.engine.retention_leases.add_or_renew(
            f"peer_recovery/{target}", shard.engine.max_seq_no + 1,
            _wall_ms(),
        )
        engine = shard.engine
        ops: list[dict] = []
        snapshot = engine.acquire_searcher()
        # buffered (not yet refreshed) docs
        seen: set[str] = set()
        for entry in engine._buffer:
            if entry is None:
                continue
            parsed, seq = entry
            ops.append({"op": "index", "id": parsed.doc_id, "source": parsed.source,
                        "seq_no": seq, "routing": parsed.routing})
            seen.add(parsed.doc_id)
        for host, _dev in snapshot.segments:
            for d in range(host.n_docs):
                if not host.live[d]:
                    continue
                doc_id = host.doc_ids[d]
                if doc_id in seen:
                    continue
                entry2 = engine.version_map.get(doc_id)
                ops.append({
                    "op": "index", "id": doc_id,
                    "source": json.loads(host.sources[d]),
                    "seq_no": entry2.seq_no if entry2 else 0,
                    "routing": None,
                })
        # tombstones make the dump a COMPLETE logical point-in-time copy:
        # a STALE target (an old replica re-recovering after a fault) may
        # still hold docs deleted here while it was away — live docs alone
        # can't tell it, and the checkpoint fast-forward at the end of the
        # dump apply would jump the delete's seq_no without ever applying
        # it (a lost delete: the doc resurrects on the replica). Shipping
        # each retained tombstone at its TRUE seq_no lets the target apply
        # the miss; the per-doc stale check keeps replays idempotent.
        ops.extend(sorted(
            ({"op": "delete", "id": doc_id, "seq_no": entry3.seq_no}
             for doc_id, entry3 in engine.version_map.items()
             if entry3.deleted),
            key=lambda o: o["seq_no"],
        ))
        # the dump stays on the source as a SESSION; the target pulls it in
        # bounded batches (chunked phase2 instead of one giant frame)
        self.recovery_stats["dump_based"] += 1
        self._recovery_sources.open(
            payload["index"], payload["shard"], target,
            mode="dump", ops=ops, max_seq_no=engine.max_seq_no,
        )
        return {"mode": "dump", "total_ops": len(ops),
                "max_seq_no": engine.max_seq_no}

    # -- recovery chunk serving (source side) -------------------------------

    def _on_recovery_file_chunk(self, sender: str, payload: dict):
        def run() -> dict:
            with tracing.activate(self.telemetry.tracer), \
                    self.telemetry.tracer.start_span("recovery.file_chunk", {
                        "index": payload["index"],
                        "shard": payload["shard"],
                        "name": payload.get("name"),
                        "offset": payload.get("offset", 0),
                        "node": self.node_id}):
                return self._file_chunk_local(payload)

        return self._offload(run)

    def _file_chunk_local(self, payload: dict) -> dict:
        key = (payload["index"], payload["shard"], payload["target"])
        session = self._recovery_sources.get(*key)
        if session is None:
            raise OpenSearchTpuException(
                f"no recovery session for [{payload['index']}]"
                f"[{payload['shard']}] -> {payload['target']}"
            )
        name = payload["name"]
        if name not in session["blobs"]:
            host = (session.get("hosts") or {}).get(name)
            if host is None:
                raise OpenSearchTpuException(
                    f"segment [{name}] not in recovery session"
                )
            from opensearch_tpu_torch.index.segment import pack_segment

            # pack lazily, once; retried chunks re-read the same bytes
            session["blobs"][name] = pack_segment(host)
        from opensearch_tpu_torch.index.recovery import DEFAULT_CHUNK_BYTES

        return self._recovery_sources.file_chunk(
            payload["index"], payload["shard"], payload["target"],
            name, int(payload.get("offset", 0)),
            int(payload.get("length") or 0) or DEFAULT_CHUNK_BYTES,
        )

    def _on_recovery_ops_chunk(self, sender: str, payload: dict) -> dict:
        with tracing.activate(self.telemetry.tracer), \
                self.telemetry.tracer.start_span("recovery.ops_chunk", {
                    "index": payload["index"], "shard": payload["shard"],
                    "from": payload.get("from", 0), "node": self.node_id}):
            try:
                return self._recovery_sources.ops_batch(
                    payload["index"], payload["shard"], payload["target"],
                    int(payload.get("from", 0)),
                    int(payload.get("size", 0) or 500),
                )
            except KeyError as e:
                raise OpenSearchTpuException(str(e)) from e

    def _on_recovery_finalize(self, sender: str, payload: dict) -> dict:
        """Seqno handoff: report the primary's max_seq_no so the target can
        verify it caught up before the routing swap; the chunk session is
        done (fan-out to the tracked target carries everything newer)."""
        with self.telemetry.tracer.start_span("recovery.finalize", {
                "index": payload["index"], "shard": payload["shard"],
                "target": payload.get("target"), "node": self.node_id}):
            shard = self._local_shard(payload["index"], payload["shard"])
            self._recovery_sources.close(
                payload["index"], payload["shard"], payload["target"]
            )
            return {"max_seq_no": shard.engine.max_seq_no}

    def _on_node_recovery(self, sender: str, payload: dict) -> dict:
        """Per-node recovery progress records (RecoveryState collection
        backing GET [/{index}]/_recovery and _cat/recovery)."""
        want = payload.get("indices")
        return {"recoveries": [
            p.to_dict() for (index, _shard), p in sorted(
                self.recoveries.items())
            if want is None or index in want
        ]}

    # -- cluster snapshots (ClusterSnapshotsService orchestrates) -----------

    def _on_snapshot_shard_dump(self, sender: str, payload: dict):
        """Logical point-in-time live-doc set of a local shard copy: the
        unrefreshed buffer (later write wins), segment live docs, minus
        anything the version map says is deleted. Runs on the data worker
        so the engine's single-writer discipline holds while we walk the
        buffer."""

        def run() -> dict:
            shard = self._local_shard(payload["index"], payload["shard"])
            engine = shard.engine
            by_id: dict[str, Any] = {}
            for entry in engine._buffer:
                if entry is None:
                    continue
                parsed, _seq = entry
                by_id[parsed.doc_id] = parsed.source
            snapshot = engine.acquire_searcher()
            for host, _dev in snapshot.segments:
                for d in range(host.n_docs):
                    if not host.live[d]:
                        continue
                    doc_id = host.doc_ids[d]
                    if doc_id not in by_id:
                        by_id[doc_id] = json.loads(host.sources[d])
            for doc_id, vme in engine.version_map.items():
                if vme.deleted:
                    by_id.pop(doc_id, None)
            return {
                "docs": [{"id": i, "source": by_id[i]} for i in sorted(by_id)],
                "max_seq_no": engine.max_seq_no,
            }

        return self._offload(run)

    def _on_snapshot_restore_dump(self, sender: str, payload: dict):
        """Install a snapshot shard's doc set into a freshly created
        primary (restore targets are replicas=0, so primary-only install
        is the complete copy)."""

        def run() -> dict:
            shard = self._local_shard(payload["index"], payload["shard"])
            if not shard.primary:
                raise OpenSearchTpuException(
                    f"restore target [{payload['index']}][{payload['shard']}]"
                    f" on [{self.node_id}] is not the primary"
                )
            for op in payload["docs"]:
                shard.apply_index_on_primary(op["id"], op["source"])
            shard.engine.translog.sync()
            shard.refresh()
            return {"restored": len(payload["docs"])}

        return self._offload(run)

    # ------------------------------------------------------------------ #
    # metadata APIs (routed to the leader)
    # ------------------------------------------------------------------ #

    def _leader_or_raise(self) -> str:
        leader = self.coordinator.leader_id
        if leader is None:
            raise OpenSearchTpuException("no elected cluster manager")
        return leader

    def create_index(self, name: str, body: dict | None,
                     callback: Callable[[dict], None]) -> None:
        self.transport.send(
            self.node_id, self._leader_or_raise(), "cluster:admin/create_index",
            {"name": name, "body": body or {}},
            on_response=callback,
            on_failure=lambda e: callback({"error": str(e)}),
        )

    def delete_index(self, name: str, callback: Callable[[dict], None]) -> None:
        self.transport.send(
            self.node_id, self._leader_or_raise(), "cluster:admin/delete_index",
            {"name": name},
            on_response=callback,
            on_failure=lambda e: callback({"error": str(e)}),
        )

    def put_mapping(self, name: str, mappings: dict,
                    callback: Callable[[dict], None]) -> None:
        self.transport.send(
            self.node_id, self._leader_or_raise(), "cluster:admin/put_mapping",
            {"name": name, "mappings": mappings},
            on_response=callback,
            on_failure=lambda e: callback({"error": str(e)}),
        )

    def _disk_usage(self) -> float | None:
        if self.disk_usage_pct is not None:
            return self.disk_usage_pct
        try:
            import shutil

            du = shutil.disk_usage(self.data_path)
            return 100.0 * (du.total - du.free) / du.total
        except OSError:
            return None

    def _on_update_settings(self, sender: str, payload: dict) -> dict:
        """PUT /_cluster/settings routed to the leader: validate, then a
        cluster-state task merges persistent/transient (null deletes) —
        the two-phase apply of ClusterSettings.java:205."""
        if not self.is_leader:
            raise OpenSearchTpuException("not the leader")
        from opensearch_tpu_torch.cluster.cluster_settings import (
            flatten,
            merge,
            validate_settings,
        )

        persistent = flatten(payload.get("persistent") or {})
        transient = flatten(payload.get("transient") or {})
        validate_settings(persistent)
        validate_settings(transient)

        def task(state: ClusterState) -> ClusterState:
            return state.with_(
                settings=merge(state.settings, persistent),
                transient_settings=merge(state.transient_settings, transient),
            )

        self.coordinator.submit_state_update(task)
        return {
            "acknowledged": True,
            "persistent": persistent,
            "transient": transient,
        }

    def _on_create_index(self, sender: str, payload: dict) -> dict:
        if not self.is_leader:
            raise OpenSearchTpuException("not the leader")
        name = payload["name"]
        body = payload["body"]
        settings = body.get("settings") or {}
        index_settings = settings.get("index", settings)
        # the create body's aliases ride the index metadata, where the
        # REST facade reads them (``_aliases``, kept out of _settings)
        aliases = {a: dict(conf or {})
                   for a, conf in (body.get("aliases") or {}).items()}
        if aliases:
            index_settings = {**index_settings, "_aliases": aliases}

        def task(state: ClusterState) -> ClusterState:
            if name in state.indices:
                return state
            meta = IndexMeta(
                name=name,
                num_shards=int(index_settings.get("number_of_shards", 1)),
                num_replicas=int(index_settings.get("number_of_replicas", 1)),
                settings=index_settings,
                mappings=body.get("mappings") or {},
            )
            return reroute(state.with_(indices={**state.indices, name: meta}))

        self.coordinator.submit_state_update(task)
        return {"acknowledged": True, "index": name}

    def _on_delete_index(self, sender: str, payload: dict) -> dict:
        if not self.is_leader:
            raise OpenSearchTpuException("not the leader")
        name = payload["name"]

        def task(state: ClusterState) -> ClusterState:
            if name not in state.indices:
                return state
            indices = {k: v for k, v in state.indices.items() if k != name}
            routing = tuple(r for r in state.routing if r.index != name)
            return state.with_(indices=indices, routing=routing)

        self.coordinator.submit_state_update(task)
        return {"acknowledged": True}

    def _on_put_mapping(self, sender: str, payload: dict) -> dict:
        if not self.is_leader:
            raise OpenSearchTpuException("not the leader")
        name, mappings = payload["name"], payload["mappings"]

        def task(state: ClusterState) -> ClusterState:
            meta = state.indices.get(name)
            if meta is None:
                return state
            # validate by merging into a scratch mapper service
            ms = MapperService(meta.mappings or None)
            ms.merge(mappings)
            new_meta = IndexMeta(
                meta.name, meta.num_shards, meta.num_replicas, meta.settings,
                ms.to_dict(), meta.version + 1,
            )
            return state.with_(indices={**state.indices, name: new_meta})

        self.coordinator.submit_state_update(task)
        return {"acknowledged": True}

    # ------------------------------------------------------------------ #
    # write path (TransportReplicationAction analog)
    # ------------------------------------------------------------------ #

    def _routing_for_doc(self, index: str, doc_id: str, routing: str | None):
        state = self.applied_state
        meta = state.indices.get(index)
        if meta is None:
            raise IndexNotFoundException(index)
        shard_num = shard_id_for_routing(routing or doc_id, meta.num_shards)
        primary = state.primary(index, shard_num)
        if primary is None or primary.node_id is None:
            raise ShardNotFoundException(f"no primary for [{index}][{shard_num}]")
        return shard_num, primary

    # transient write-routing retry: a relocation swap or primary failover
    # can make the routed primary reject the write with
    # ShardNotFoundException ("not on node ..." — the copy moved away) or
    # leave the routing table momentarily without a primary. Both heal
    # within one or two cluster-state publications, so the coordinator
    # retries with RE-RESOLVED routing under exponential backoff instead of
    # surfacing a 5xx for a perfectly healthy cluster. Only routing-shaped
    # failures retry — the write provably never applied, so the retry
    # cannot double-apply.
    WRITE_RETRY_ATTEMPTS = 5
    WRITE_RETRY_BASE_MS = 100

    @staticmethod
    def _is_transient_routing_error(err) -> bool:
        text = str(err)
        return ("ShardNotFoundException" in type(err).__name__
                or "not on node" in text or "no primary for" in text)

    def _write_with_retry(self, build_payload, callback, attempt: int = 0):
        """`build_payload()` re-resolves routing and returns (primary_node,
        payload); raises ShardNotFoundException while routing is in flux."""
        def retry_or_fail(err) -> None:
            if (attempt + 1 < self.WRITE_RETRY_ATTEMPTS
                    and self._is_transient_routing_error(err)
                    and not getattr(self, "_closed", False)):
                self.scheduler.schedule(
                    self.WRITE_RETRY_BASE_MS * (2 ** attempt),
                    lambda: self._write_with_retry(
                        build_payload, callback, attempt + 1),
                )
            else:
                callback({"error": str(err)})

        try:
            primary_node, payload = build_payload()
        except OpenSearchTpuException as e:
            retry_or_fail(e)
            return

        def on_response(resp: dict) -> None:
            # the primary answers routing staleness as an error response
            # (handler raises travel back through on_failure; loopback
            # handlers may surface them as {"error"} dicts)
            if (isinstance(resp, dict) and "error" in resp
                    and self._is_transient_routing_error(
                        RuntimeError(resp["error"]))):
                retry_or_fail(RuntimeError(resp["error"]))
            else:
                callback(resp)

        self.transport.send(
            self.node_id, primary_node, "indices:data/write[p]", payload,
            on_response=on_response, on_failure=retry_or_fail,
        )

    def index_doc(self, index: str, doc_id: str, source: dict,
                  callback: Callable[[dict], None], routing: str | None = None,
                  if_seq_no: int | None = None,
                  op_type: str | None = None) -> None:
        def build():
            shard_num, primary = self._routing_for_doc(index, doc_id, routing)
            return primary.node_id, {
                "index": index, "shard": shard_num, "op": "index",
                "id": doc_id, "source": source, "routing": routing,
                "if_seq_no": if_seq_no, "op_type": op_type}

        self._write_with_retry(build, callback)

    def delete_doc(self, index: str, doc_id: str,
                   callback: Callable[[dict], None], routing: str | None = None) -> None:
        def build():
            shard_num, primary = self._routing_for_doc(index, doc_id, routing)
            return primary.node_id, {
                "index": index, "shard": shard_num, "op": "delete",
                "id": doc_id, "routing": routing}

        self._write_with_retry(build, callback)

    def bulk(self, operations: list[tuple[str, dict, dict | None]],
             callback: Callable[[dict], None],
             query_group: str | None = None) -> None:
        """TransportBulkAction analog: group items by owning SHARD and send
        ONE shard-bulk RPC per (shard, primary) — TransportShardBulkAction's
        batching (one replication round per shard, not per document). Item
        order is preserved in the response regardless of completion order.

        `query_group` tags the request for wlm admission: an enforced group
        past its bulk slot share sheds the WHOLE request with a 429-shaped
        error before any fan-out (no queue slots, no pending callbacks)."""
        from opensearch_tpu_torch.common.timeutil import monotonic_millis

        from opensearch_tpu_torch.common.errors import RejectedExecutionException

        try:
            release_admission = self.query_groups.admit_bulk(query_group)
        except RejectedExecutionException as e:
            # typed-name prefix so facade._on_loop rehydrates the 429
            callback({"error": f"RejectedExecutionException: {e}",
                      "status": 429})
            return
        callback = _release_then(release_admission, callback)

        t0 = monotonic_millis()
        n = len(operations)
        if n == 0:
            callback({"took": 0, "errors": False, "items": []})
            return
        items: list[dict | None] = [None] * n
        state = {"errors": False}

        # group by (index, shard): [(item_idx, action, op_payload)]
        groups: dict[tuple[str, int], list] = {}
        group_primary: dict[tuple[str, int], str] = {}
        for i, (action, meta, source) in enumerate(operations):
            index = meta.get("_index")
            doc_id = meta.get("_id")
            routing = meta.get("routing") or meta.get("_routing")
            try:
                if action not in ("index", "create", "delete"):
                    raise OpenSearchTpuException(
                        f"unsupported bulk action [{action}]"
                    )
                shard_num, primary = self._routing_for_doc(
                    index, doc_id, routing
                )
            except OpenSearchTpuException as e:
                state["errors"] = True
                items[i] = {action: {"error": str(e), "status": 500}}
                continue
            key = (index, shard_num)
            group_primary[key] = primary.node_id
            op = {"op": "index" if action in ("index", "create") else "delete",
                  "id": doc_id, "routing": routing}
            if action in ("index", "create"):
                op["source"] = source
                if action == "create":
                    op["op_type"] = "create"
            groups.setdefault(key, []).append((i, action, op))

        pending = {"n": len(groups)}

        def done_if_last() -> None:
            pending["n"] -= 1
            if pending["n"] == 0:
                callback({
                    "took": monotonic_millis() - t0,
                    "errors": state["errors"],
                    "items": items,
                })

        if not groups:
            callback({"took": monotonic_millis() - t0,
                      "errors": state["errors"], "items": items})
            return

        for key, group in groups.items():
            index, shard_num = key

            def on_response(g=group):
                def handle(resp: dict) -> None:
                    results = (resp or {}).get("items", [])
                    for (i, action, _op), r in zip(g, results):
                        if "error" in r:
                            state["errors"] = True
                            items[i] = {action: {"error": r["error"],
                                                 "status": r.get("status", 500)}}
                        else:
                            status = (201 if r.get("result") == "created"
                                      else 200)
                            items[i] = {action: {**r, "status": status}}
                    done_if_last()
                return handle

            def on_failure(g=group):
                def handle(e: Exception) -> None:
                    state["errors"] = True
                    for (i, action, _op) in g:
                        items[i] = {action: {"error": str(e), "status": 500}}
                    done_if_last()
                return handle

            self.transport.send(
                self.node_id, group_primary[key], "indices:data/write[p][bulk]",
                {"index": index, "shard": shard_num,
                 "ops": [op for _i, _a, op in group]},
                on_response=on_response(), on_failure=on_failure(),
            )

    def cluster_health(self) -> dict:
        """Computed from the applied state on ANY node (ClusterStateHealth
        analog) — no leader round-trip needed for a health read."""
        state = self.applied_state
        total = len(state.routing)
        # a RELOCATING copy is a fully started copy that happens to be
        # moving — it serves reads and counts active (ClusterStateHealth)
        active = sum(1 for r in state.routing
                     if r.state in ("STARTED", "RELOCATING"))
        active_primaries = sum(
            1 for r in state.routing
            if r.primary and r.state in ("STARTED", "RELOCATING")
        )
        unassigned = sum(1 for r in state.routing if r.state == "UNASSIGNED")
        relocating = sum(1 for r in state.routing if r.state == "RELOCATING")
        initializing = sum(
            1 for r in state.routing
            if r.state == "INITIALIZING" and not r.is_relocation_target
        )
        return {
            "cluster_name": "opensearch-tpu",
            "status": routing_health(state.routing),
            "number_of_nodes": len(state.nodes),
            "number_of_data_nodes": sum(
                1 for nd in state.nodes.values() if nd.is_data
            ),
            "active_primary_shards": active_primaries,
            "active_shards": active,
            "relocating_shards": relocating,
            "initializing_shards": initializing,
            "unassigned_shards": unassigned,
            "cluster_manager_node": state.leader_id,
            "active_shards_percent_as_number": (
                100.0 * active / total if total else 100.0
            ),
        }

    def _local_shard(self, index: str, shard: int) -> IndexShard:
        local = self.local_shards.get((index, shard))
        if local is None:
            raise ShardNotFoundException(f"[{index}][{shard}] not on node {self.node_id}")
        return local

    def _on_primary_write(self, sender: str, payload: dict):
        """Primary write: apply + fsync locally (on the data worker, off
        the transport loop), fan out to every assigned replica copy, and —
        crucially — ACK ONLY AFTER EVERY COPY ANSWERED
        (ReplicationOperation.java:77: the response waits for all in-sync
        copies; a replica that fails is evicted via a shard-failed leader
        task before the ack, so an acknowledged write can never be lost by
        promoting that stale copy)."""
        applied = self._offload(lambda: self._apply_primary_local(payload))
        from opensearch_tpu_torch.transport.base import DeferredResponse

        if not isinstance(applied, DeferredResponse):  # sim: synchronous
            return self._continue_primary_write(payload, applied)
        final = DeferredResponse()

        def after(d: DeferredResponse) -> None:
            if d.error is not None:
                final.set_exception(d.error)
                return
            try:
                cont = self._continue_primary_write(payload, d.result)
            except Exception as e:  # noqa: BLE001 - must fail the listener
                # a raise here runs on the transport loop's completion
                # callback: nobody above us would resolve `final`, and the
                # client's write would wedge until (sim: forever) timeout
                final.set_exception(e)
                return
            if isinstance(cont, DeferredResponse):
                cont.on_done(lambda c: (
                    final.set_exception(c.error) if c.error is not None
                    else final.set_result(c.result)
                ))
            else:
                final.set_result(cont)

        applied.on_done(after)
        return final

    def _apply_primary_local(self, payload: dict):
        shard = self._local_shard(payload["index"], payload["shard"])
        if payload["op"] == "index":
            if payload.get("op_type") == "create":
                existing = shard.get(payload["id"])
                if existing is not None:
                    from opensearch_tpu_torch.common.errors import (
                        VersionConflictException,
                    )

                    raise VersionConflictException(
                        f"[{payload['id']}]: version conflict, document "
                        f"already exists"
                    )
            result = shard.apply_index_on_primary(
                payload["id"], payload["source"], payload.get("routing"),
                if_seq_no=payload.get("if_seq_no"),
            )
        else:
            result = shard.apply_delete_on_primary(
                payload["id"], if_seq_no=payload.get("if_seq_no")
            )
        shard.maybe_sync_translog()
        return result

    def _continue_primary_write(self, payload: dict, result):
        index, shard_num = payload["index"], payload["shard"]
        # fan out to every assigned replica copy — STARTED, RELOCATING and
        # recovering alike (performOnReplicas sends to all in-sync + tracked
        # copies; a recovering replica dedups via seq_no)
        state = self.applied_state
        target_nodes = {
            r.node_id for r in state.shards_for_index(index)
            if r.shard == shard_num and not r.primary
            and r.state in ("STARTED", "INITIALIZING", "RELOCATING")
            and r.node_id is not None
        }
        target_nodes |= self._tracked_targets.get((index, shard_num), set())
        target_nodes.discard(self.node_id)

        def response(failed: int) -> dict:
            return {
                "_index": index, "_id": payload["id"],
                "_version": result.version, "_seq_no": result.seq_no,
                "result": result.result,
                "_shards": {"total": 1 + len(target_nodes),
                            "successful": 1 + len(target_nodes) - failed,
                            "failed": failed},
            }

        if not target_nodes:
            return response(0)

        from opensearch_tpu_torch.transport.base import DeferredResponse

        deferred = DeferredResponse()
        pending = {"n": len(target_nodes), "failed": 0}
        replica_payload = dict(payload, seq_no=result.seq_no, version=result.version)

        def one_done() -> None:
            pending["n"] -= 1
            if pending["n"] == 0:
                deferred.set_result(response(pending["failed"]))

        def make_on_ack(nid: str):
            def on_ack(resp: Any) -> None:
                self._renew_peer_lease(index, shard_num, nid, resp)
                one_done()
            return on_ack

        def make_on_fail(nid: str):
            def on_fail(_e: Exception) -> None:
                # evict the unreachable copy BEFORE acking (ShardStateAction
                # shard-failed; the leader reroutes and the copy must
                # re-recover). If the leader is unreachable too the ack
                # still proceeds — the election path removes dead nodes.
                pending["failed"] += 1
                self._report_shard_failed(index, shard_num, nid, one_done)
            return on_fail

        for nid in sorted(target_nodes):
            self.transport.send(
                self.node_id, nid, "indices:data/write[r]", replica_payload,
                on_response=make_on_ack(nid), on_failure=make_on_fail(nid),
            )
        return deferred

    def _renew_peer_lease(self, index: str, shard_num: int, nid: str,
                          resp: Any) -> None:
        """Advance the replica's peer-recovery retention lease to its acked
        local checkpoint + 1: everything at or below the checkpoint is
        durable on that copy, so history above it is all a future ops-based
        recovery would need (ReplicationTracker.renewRetentionLease)."""
        if not isinstance(resp, dict) or "local_checkpoint" not in resp:
            return
        local = self.local_shards.get((index, shard_num))
        if local is None or not local.primary:
            return
        local.engine.retention_leases.add_or_renew(
            f"peer_recovery/{nid}", int(resp["local_checkpoint"]) + 1,
            _wall_ms(),
        )

    # -- shard-level bulk (TransportShardBulkAction.performOnPrimary) -------

    def _on_primary_bulk(self, sender: str, payload: dict):
        """Apply a batch of ops on the primary, then ONE batched replica
        round per copy; ack after every copy answered."""
        applied = self._offload(lambda: self._apply_primary_bulk_local(payload))
        from opensearch_tpu_torch.transport.base import DeferredResponse

        if not isinstance(applied, DeferredResponse):
            return self._continue_primary_bulk(payload, applied)
        final = DeferredResponse()

        def after(d: DeferredResponse) -> None:
            if d.error is not None:
                final.set_exception(d.error)
                return
            try:
                cont = self._continue_primary_bulk(payload, d.result)
            except Exception as e:  # noqa: BLE001 - must fail the listener
                # same leak class as the single-doc path: an unresolved
                # `final` never ships a response frame
                final.set_exception(e)
                return
            if isinstance(cont, DeferredResponse):
                cont.on_done(lambda c: (
                    final.set_exception(c.error) if c.error is not None
                    else final.set_result(c.result)
                ))
            else:
                final.set_result(cont)

        applied.on_done(after)
        return final

    def _apply_primary_bulk_local(self, payload: dict) -> list[dict]:
        shard = self._local_shard(payload["index"], payload["shard"])
        results: list[dict] = []
        for op in payload["ops"]:
            try:
                r = self._apply_primary_local(
                    {"index": payload["index"], "shard": payload["shard"],
                     **op}
                )
                results.append({
                    "_index": payload["index"], "_id": op["id"],
                    "_version": r.version, "_seq_no": r.seq_no,
                    "result": r.result, "seq_no": r.seq_no,
                    "version": r.version,
                })
            except OpenSearchTpuException as e:
                results.append({"error": str(e), "_id": op["id"],
                                "status": getattr(e, "status", 500)})
        shard.maybe_sync_translog()
        return results

    def _continue_primary_bulk(self, payload: dict, results: list[dict]):
        index, shard_num = payload["index"], payload["shard"]
        state = self.applied_state
        target_nodes = {
            r.node_id for r in state.shards_for_index(index)
            if r.shard == shard_num and not r.primary
            and r.state in ("STARTED", "INITIALIZING", "RELOCATING")
            and r.node_id is not None
        }
        target_nodes |= self._tracked_targets.get((index, shard_num), set())
        target_nodes.discard(self.node_id)

        def response(failed: int) -> dict:
            n_copies = 1 + len(target_nodes)
            items = []
            for r in results:
                if "error" in r:
                    items.append(r)
                else:
                    items.append({
                        "_index": r["_index"], "_id": r["_id"],
                        "_version": r["_version"], "_seq_no": r["_seq_no"],
                        "result": r["result"],
                        "_shards": {"total": n_copies,
                                    "successful": n_copies - failed,
                                    "failed": failed},
                    })
            return {"items": items}

        if not target_nodes:
            return response(0)
        from opensearch_tpu_torch.transport.base import DeferredResponse

        deferred = DeferredResponse()
        pending = {"n": len(target_nodes), "failed": 0}
        # replicate only the ops that applied (with their seq_nos)
        rep_ops = [
            {**op, "seq_no": r["seq_no"], "version": r["version"]}
            for op, r in zip(payload["ops"], results) if "error" not in r
        ]
        rep_payload = {"index": index, "shard": shard_num, "ops": rep_ops}

        def one_done() -> None:
            pending["n"] -= 1
            if pending["n"] == 0:
                deferred.set_result(response(pending["failed"]))

        def make_on_fail(nid: str):
            def on_fail(_e: Exception) -> None:
                pending["failed"] += 1
                self._report_shard_failed(index, shard_num, nid, one_done)
            return on_fail

        def make_on_ack(nid: str):
            def on_ack(resp: Any) -> None:
                self._renew_peer_lease(index, shard_num, nid, resp)
                one_done()
            return on_ack

        for nid in sorted(target_nodes):
            self.transport.send(
                self.node_id, nid, "indices:data/write[r][bulk]", rep_payload,
                on_response=make_on_ack(nid),
                on_failure=make_on_fail(nid),
            )
        return deferred

    def _on_replica_bulk(self, sender: str, payload: dict):
        def run() -> dict:
            shard = self._local_shard(payload["index"], payload["shard"])
            for op in payload["ops"]:
                if shard.replication == "SEGMENT":
                    top = {"op": op["op"], "id": op["id"],
                           "seq_no": op["seq_no"],
                           "version": op.get("version", 1)}
                    if op["op"] == "index":
                        top["source"] = op["source"]
                        top["routing"] = op.get("routing")
                    shard.engine.append_translog_op(top)
                elif op["op"] == "index":
                    shard.apply_index_on_replica(
                        op["id"], op["source"], op["seq_no"],
                        op.get("routing"),
                    )
                else:
                    shard.apply_delete_on_replica(op["id"], op["seq_no"])
            shard.maybe_sync_translog()
            return {"ack": True,
                    "local_checkpoint": shard.engine.local_checkpoint}

        return self._offload(run)

    # a lost shard-failed report must be RETRIED: the failing copy missed
    # a write, and if no leader ever learns, it stays STARTED with stale
    # data forever — permanent copy divergence (the chaos soak's
    # copy-agreement invariant caught exactly this under one-way drops
    # that also severed the primary -> leader path)
    _SHARD_FAILED_RETRY_MS = 1_000
    _SHARD_FAILED_MAX_RETRIES = 30

    def _report_shard_failed(self, index: str, shard: int, node_id: str,
                             done: Callable[[], None],
                             _attempt: int = 0) -> None:
        leader = self.coordinator.leader_id

        def settle_and_retry(_e: Exception | None = None) -> None:
            done()
            self._retry_shard_failed(index, shard, node_id, _attempt)

        if leader is None:
            settle_and_retry()
            return
        self.transport.send(
            self.node_id, leader, "internal:cluster/shard_failed",
            {"index": index, "shard": shard, "node_id": node_id},
            on_response=lambda _r: done(),
            on_failure=settle_and_retry,
        )

    def _retry_shard_failed(self, index: str, shard: int, node_id: str,
                            attempt: int) -> None:
        if getattr(self, "_closed", False) or \
                attempt >= self._SHARD_FAILED_MAX_RETRIES:
            return

        def tick() -> None:
            if getattr(self, "_closed", False):
                return
            entry = next(
                (r for r in self.applied_state.shards_for_index(index)
                 if r.shard == shard and r.node_id == node_id
                 and r.state in ("STARTED", "RELOCATING")), None)
            if entry is None:
                return  # the leader evicted/moved the copy — resolved
            self._report_shard_failed(index, shard, node_id,
                                      lambda: None, attempt + 1)

        self.scheduler.schedule(self._SHARD_FAILED_RETRY_MS, tick)

    def _on_shard_failed(self, sender: str, payload: dict) -> dict:
        if not self.is_leader:
            raise OpenSearchTpuException("not the leader")
        from opensearch_tpu_torch.cluster.allocation import mark_shard_failed

        self.coordinator.submit_state_update(
            lambda s: mark_shard_failed(
                s, payload["index"], payload["shard"], payload["node_id"]
            )
        )
        return {"ack": True}

    def _on_replica_write(self, sender: str, payload: dict):
        def run() -> dict:
            shard = self._local_shard(payload["index"], payload["shard"])
            if shard.replication == "SEGMENT":
                # segrep replica: durability only — the op reaches the
                # searchable set via the primary's segment checkpoints
                op = {"op": payload["op"], "id": payload["id"],
                      "seq_no": payload["seq_no"],
                      "version": payload.get("version", 1)}
                if payload["op"] == "index":
                    op["source"] = payload["source"]
                    op["routing"] = payload.get("routing")
                shard.engine.append_translog_op(op)
            elif payload["op"] == "index":
                shard.apply_index_on_replica(
                    payload["id"], payload["source"], payload["seq_no"],
                    payload.get("routing"),
                )
            else:
                shard.apply_delete_on_replica(payload["id"], payload["seq_no"])
            # replica acks are durability promises too (the primary counts
            # this copy in-sync based on them): fsync before responding
            shard.maybe_sync_translog()
            # the ack carries the replica's local checkpoint so the primary
            # can advance this copy's retention lease (the reference
            # piggybacks it on every ReplicationResponse)
            return {"ack": True,
                    "local_checkpoint": shard.engine.local_checkpoint}

        return self._offload(run)

    # ------------------------------------------------------------------ #
    # read path
    # ------------------------------------------------------------------ #

    def get_doc(self, index: str, doc_id: str,
                callback: Callable[[dict], None], routing: str | None = None) -> None:
        shard_num, primary = self._routing_for_doc(index, doc_id, routing)
        self.transport.send(
            self.node_id, primary.node_id, "indices:data/read/get",
            {"index": index, "shard": shard_num, "id": doc_id},
            on_response=callback,
            on_failure=lambda e: callback({"error": str(e)}),
        )

    def _on_get(self, sender: str, payload: dict):
        def run() -> dict:
            shard = self._local_shard(payload["index"], payload["shard"])
            got = shard.get(payload["id"])
            if got is None:
                return {"_index": payload["index"], "_id": payload["id"],
                        "found": False}
            return {"_index": payload["index"], "_id": payload["id"],
                    "found": True, "_source": got["_source"],
                    "_seq_no": got["_seq_no"], "_version": got["_version"]}

        return self._offload(run)

    def explain(self, index: str, doc_id: str, body: dict,
                callback: Callable[[dict], None],
                routing: str | None = None) -> None:
        """_explain on the node holding the doc's shard, routed as a GET
        is (to the primary); a failure reaches `callback` as
        ``{"error": exception}``."""
        shard_num, primary = self._routing_for_doc(index, doc_id, routing)
        self.transport.send(
            self.node_id, primary.node_id, "indices:data/read/explain",
            {"index": index, "shard": shard_num, "id": doc_id,
             "body": body},
            on_response=callback,
            on_failure=lambda e: callback({"error": e, "status": 500}),
        )

    def _on_explain(self, sender: str, payload: dict):
        def run() -> dict:
            from opensearch_tpu_torch.node import explain_on_shard

            shard = self._local_shard(payload["index"], payload["shard"])
            return explain_on_shard(payload["index"], payload["id"], shard,
                                    shard.mapper_service,
                                    payload.get("body") or {})

        return self._offload(run)

    def refresh(self, index: str, callback: Callable[[dict], None]) -> None:
        """Broadcast refresh to every shard copy (BroadcastReplicationAction)."""
        state = self.applied_state
        targets = [
            r for r in state.shards_for_index(index)
            if r.node_id is not None and r.state in ("STARTED", "RELOCATING")
        ]
        if not targets:
            callback({"_shards": {"total": 0, "successful": 0, "failed": 0}})
            return
        remaining = [len(targets)]

        def one_done(_resp: Any) -> None:
            remaining[0] -= 1
            if remaining[0] == 0:
                callback({"_shards": {"total": len(targets),
                                      "successful": len(targets), "failed": 0}})

        for r in targets:
            self.transport.send(
                self.node_id, r.node_id, "indices:admin/refresh[shard]",
                {"index": index, "shard": r.shard},
                on_response=one_done, on_failure=one_done,
            )

    def _on_shard_refresh(self, sender: str, payload: dict):
        shard = self._local_shard(payload["index"], payload["shard"])
        deferred = self._offload(lambda: (shard.refresh(), {"ack": True})[1])
        if shard.primary and shard.replication == "SEGMENT":
            from opensearch_tpu_torch.transport.base import DeferredResponse

            if isinstance(deferred, DeferredResponse):
                deferred.on_done(lambda d: (
                    self._publish_checkpoint(payload["index"], payload["shard"])
                    if d.error is None else None
                ))
            else:
                self._publish_checkpoint(payload["index"], payload["shard"])
        return deferred

    # -- segment replication (indices/replication/ analog) ------------------

    def _publish_checkpoint(self, index: str, shard_num: int) -> None:
        """Primary: after refresh, tell every replica copy which segments
        now exist (checkpoint/PublishCheckpointAction)."""
        shard = self.local_shards.get((index, shard_num))
        if shard is None:
            return
        checkpoint = {
            "index": index, "shard": shard_num,
            "segments": shard.engine.segment_names(),
            "sigs": shard.engine.segment_sigs(),
            "generation": shard.engine._refresh_generation,
            "max_seq_no": shard.engine.max_seq_no,
            "primary": self.node_id,
        }
        state = self.applied_state
        for r in state.shards_for_index(index):
            if (r.shard == shard_num and not r.primary
                    and r.node_id not in (None, self.node_id)
                    and r.state in ("STARTED", "RELOCATING")):
                self.transport.send(
                    self.node_id, r.node_id,
                    "indices:replication/checkpoint", checkpoint,
                    on_response=None, on_failure=lambda e: None,
                )

    def _on_replication_checkpoint(self, sender: str, payload: dict) -> dict:
        """Replica: diff the checkpoint against local segments, fetch the
        missing ones (SegmentReplicationTargetService.onNewCheckpoint:298)."""
        shard = self.local_shards.get((payload["index"], payload["shard"]))
        if shard is None or shard.primary:
            return {"ack": False}
        have = shard.engine.segment_sigs()
        want = list(payload["segments"])
        want_sigs = payload.get("sigs") or {}
        # a same-name segment with a different signature is stale (e.g. a
        # crash-restarted replica's locally rebuilt bootstrap segment)
        missing = [n for n in want
                   if have.get(n) != want_sigs.get(n)]
        if not missing and set(want) == set(have):
            return {"ack": True, "fetched": 0}
        self._fetch_and_install(
            payload["index"], payload["shard"], payload["primary"],
            want, missing, done=None,
        )
        return {"ack": True, "fetched": len(missing)}

    def _fetch_and_install(self, index: str, shard_num: int,
                           primary_id: str, order: list[str],
                           names: list[str], done) -> None:
        """Fetch the named segments from the primary ONE per request (the
        MultiChunkTransfer idea at segment granularity — a whole-shard
        bundle could exceed the transport's frame cap), then install the
        set on the data worker. `done(ok: bool)` fires on the loop."""
        blobs: list[bytes] = []

        def finish_install() -> None:
            def run() -> bool:
                from opensearch_tpu_torch.index.segment import unpack_segment

                hosts = [unpack_segment(b) for b in blobs]
                shard = self.local_shards.get((index, shard_num))
                if shard is None:
                    return False
                shard.engine.install_replicated_segments(hosts, order)
                return True

            deferred = self._offload(run)
            from opensearch_tpu_torch.transport.base import DeferredResponse

            if done is None:
                return
            if isinstance(deferred, DeferredResponse):
                deferred.on_done(lambda d: done(
                    d.error is None and bool(d.result)
                ))
            else:
                done(bool(deferred))

        def fetch(i: int) -> None:
            if i >= len(names):
                finish_install()
                return
            self.transport.send(
                self.node_id, primary_id,
                "indices:replication/get_segments",
                {"index": index, "shard": shard_num, "names": [names[i]]},
                on_response=lambda resp: (
                    blobs.append(resp["_binary"]), fetch(i + 1)
                ) if isinstance(resp, dict) and resp.get("_binary")
                else (done(False) if done else None),
                on_failure=lambda e: done(False) if done else None,
                # large bundles take longer than control messages
                # (RecoverySettings' dedicated recovery timeouts)
                timeout_ms=180_000,
            )

        fetch(0)

    def _on_get_segments(self, sender: str, payload: dict):
        """Primary: serve sealed segment bundles as binary blobs
        (RecoverySourceHandler phase1's file chunks over binary frames;
        callers request one segment per round to stay under MAX_FRAME)."""
        shard = self._local_shard(payload["index"], payload["shard"])

        def run() -> dict:
            from opensearch_tpu_torch.index.segment import pack_segment

            names = set(payload["names"])
            blobs: list[tuple[str, bytes]] = []
            for host, _dev in shard.engine._segments:
                if host.name in names:
                    blobs.append((host.name, pack_segment(host)))
            manifest = [[n, len(b)] for n, b in blobs]
            return {"manifest": manifest,
                    "segments": shard.engine.segment_names(),
                    "_binary": b"".join(b for _n, b in blobs)}

        return self._offload(run)

    # -- distributed search (scatter-gather, SURVEY §3.2) -------------------

    def search(self, index: str, body: dict | None,
               callback: Callable[[dict], None],
               query_group: str | None = None,
               lane: str | None = None) -> None:
        # wlm search admission BEFORE the fan-out (the bulk twin): an
        # enforced group past its slot share sheds a typed 429 here and
        # burns no transport or device work; the slot releases exactly
        # once when the (possibly degraded) response completes
        try:
            release_admission = self.query_groups.admit_search(query_group)
        except RejectedExecutionException as e:
            callback({"error": f"{type(e).__name__}: {e}", "status": 429})
            return
        inner_callback = callback

        def callback(resp: dict) -> None:  # noqa: F811 - admission wrapper
            release_admission()
            inner_callback(resp)

        state = self.applied_state
        meta = state.indices.get(index)
        if meta is None:
            callback({"error": f"no such index [{index}]"})
            return
        body = dict(body or {})
        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        sort = body.get("sort")
        if isinstance(sort, (str, dict)):
            # normalize once and forward the normalized form — shards and
            # coordinator must agree on the sort spec
            sort = [sort]
            body["sort"] = sort
        # candidate copies per shard (every STARTED/RELOCATING copy)
        candidates: dict[int, list[ShardRoutingEntry]] = {}
        for r in state.shards_for_index(index):
            # RELOCATING sources keep serving reads until the routing swap
            if r.state not in ("STARTED", "RELOCATING") or r.node_id is None:
                continue
            candidates.setdefault(r.shard, []).append(r)
        missing = meta.num_shards - len(candidates)
        if not candidates:
            callback({"error": "not all shards available"})
            return
        # device-kNN bodies route through the shard-mesh data plane: ONE
        # search[node] RPC per node holding target shards — the node runs
        # a single sharded launch over all of them (cluster/shard_mesh.py)
        # — instead of one RPC per shard with a host-Python merge; the
        # coordinator stream-merges the pre-merged node partials
        # (search/reduce.py). Ineligible bodies keep the per-shard path.
        # RESIDENCY-AWARE ROUTING (ISSUE 11): for the kNN path, each
        # shard's launch lands on the copy whose mesh bundle / IVF-PQ slab
        # is already HBM-resident (the board learned it from earlier
        # partials' _residency stamps); no warm copy -> round-robin.
        if self._mesh_search_eligible(body):
            field = residency_mod.knn_query_field(body)
            targets, _warm = residency_mod.choose_copies(
                self.residency_board, index, field, candidates,
                next(self._route_rr))
            self._search_node_grouped(
                index, body, targets, missing, size, from_, callback,
                lane=lane, field=field,
            )
            return
        # non-mesh bodies keep the legacy prefer-primary selection
        targets: dict[int, ShardRoutingEntry] = {}
        for num, cands in candidates.items():
            targets[num] = next((r for r in cands if r.primary), cands[0])
        # shards with no serving copy (mid-failover) degrade the response
        # instead of refusing it: the reachable shards answer and the
        # missing ones count into _shards.failed
        # (allow_partial_search_results=true semantics)
        results: dict[int, dict] = {}
        remaining = [len(targets)]
        tracer = self.telemetry.tracer
        # coordinator ROOT span covers the whole distributed operation —
        # begin_span/end_span because responses arrive in later scheduled
        # callbacks where the lexical scope is long gone (same recipe as
        # the recovery.target root)
        root = tracer.begin_span(
            "search.coordinator",
            {"index": index, "node": self.node_id, "shards": len(targets)},
        )
        ctx = {"trace_id": root.trace_id, "span_id": root.span_id}

        def one_result(shard_num: int):
            def handle(resp: dict) -> None:
                results[shard_num] = resp
                remaining[0] -= 1
                if remaining[0] == 0:
                    # re-enter the trace so coordinator -> shard -> reduce
                    # share one trace_id
                    try:
                        with tracing.restore_trace_context(ctx), \
                                tracer.start_span("search.reduce", {
                                    "index": index, "node": self.node_id,
                                    "shards": len(results)}):
                            merged = self._merge_search_results(
                                results, size, from_, sort,
                                extra_failed=missing)
                    except Exception as e:  # noqa: BLE001
                        # a reduce failure runs inside a transport
                        # completion callback — raising here leaks the
                        # listener and wedges the search forever (TPU008's
                        # failure class); fail it instead
                        merged = {"error": f"{type(e).__name__}: {e}"}
                    tracer.end_span(root)
                    callback(merged)
            return handle

        # the fan-out sends capture the root context, so the per-shard
        # handler spans on remote nodes parent under it
        with tracing.restore_trace_context(ctx):
            for shard_num, r in sorted(targets.items()):
                self.transport.send(
                    self.node_id, r.node_id, "indices:data/read/search[shard]",
                    {"index": index, "shard": shard_num, "body": body},
                    on_response=one_result(shard_num),
                    on_failure=one_result(shard_num),  # missing shard
                )

    # -- shard-mesh search fan-out (one sharded launch per node) ------------

    # body keys the node-grouped device-kNN path accepts: a bare knn query
    # plus paging/_source/profile — everything else (sort, aggs, rescore,
    # highlight, ...) keeps the per-shard scatter-gather
    _MESH_SEARCH_KEYS = frozenset({
        "query", "size", "from", "_source", "track_total_hits",
        "version", "seq_no_primary_term", "profile",
    })

    @classmethod
    def _mesh_search_eligible(cls, body: dict) -> bool:
        if not isinstance(body, dict) or set(body) - cls._MESH_SEARCH_KEYS:
            return False
        query = body.get("query")
        return isinstance(query, dict) and set(query) == {"knn"}

    def _search_node_grouped(self, index: str, body: dict, targets: dict,
                             missing: int, size: int, from_: int,
                             callback: Callable[[dict], None],
                             lane: str | None = None,
                             field: str | None = None) -> None:
        """Device-kNN fan-out grouped BY NODE: each data node receives one
        search[node] request covering every target shard it holds, executes
        them as one shard_map launch (service.search -> shard-mesh path),
        and the coordinator reduces the pre-merged partials. A node RPC
        failure — or a shard copy missing on the node — degrades that
        node's shards to per-shard search[shard] execution against another
        serving copy (allow_partial_search_results semantics when none
        exists)."""
        from opensearch_tpu_torch.search.reduce import reduce_search_responses

        by_node: dict[str, list[int]] = {}
        for num, r in sorted(targets.items()):
            by_node.setdefault(r.node_id, []).append(num)
        track_total = body.get("track_total_hits", True)
        node_body = dict(body)
        node_body["from"] = 0
        node_body["size"] = from_ + size
        node_body["track_total_hits"] = True
        tracer = self.telemetry.tracer
        # coordinator ROOT span: begin/end because partials arrive in later
        # scheduled callbacks (same recipe as the per-shard coordinator)
        root = tracer.begin_span(
            "search.coordinator",
            {"index": index, "node": self.node_id, "mesh": True,
             "fanout": len(by_node), "shards": len(targets)},
        )
        ctx = {"trace_id": root.trace_id, "span_id": root.span_id}
        partials: list[dict] = []
        extra_failed = [missing]
        pending = [len(by_node)]

        def finish() -> None:
            try:
                with tracing.restore_trace_context(ctx), \
                        tracer.start_span("search.reduce", {
                            "index": index, "node": self.node_id,
                            "partials": len(partials)}):
                    resp = reduce_search_responses(
                        body, partials, size=size, from_=from_,
                        track_total=track_total,
                    )
                resp["_shards"]["total"] += extra_failed[0]
                resp["_shards"]["failed"] += extra_failed[0]
            except Exception as e:  # noqa: BLE001 - a reduce failure inside
                # a transport completion callback must FAIL the search, not
                # leak the caller (TPU008's failure class)
                resp = {"error": f"{type(e).__name__}: {e}"}
            tracer.end_span(root)
            callback(resp)

        def one_node_done() -> None:
            pending[0] -= 1
            if pending[0] == 0:
                finish()

        def make_handlers(nid: str, nums: list[int]):
            def handle(resp: Any) -> None:
                if not isinstance(resp, dict) or "hits" not in resp:
                    # whole-node failure: every shard degrades to the
                    # per-shard path on another copy
                    self._per_shard_fallback(
                        index, node_body, nums, nid, partials,
                        extra_failed, one_node_done)
                    return
                # residency stamp: the data node consulted its ledger/
                # registry rows after serving — the board learns which
                # copies are warm so the NEXT fan-out lands on them
                res = resp.pop("_residency", None)
                if isinstance(res, dict) and res.get("field"):
                    self.residency_board.observe(
                        nid, index, res["field"], bool(res.get("warm")))
                failed_nums = resp.pop("_failed_shards", None)
                if failed_nums:
                    # hand the missing copies to the fallback instead of
                    # double-counting them (the partial already bumped its
                    # _shards for them)
                    resp["_shards"]["total"] -= len(failed_nums)
                    resp["_shards"]["failed"] -= len(failed_nums)
                partials.append(resp)
                if failed_nums:
                    self._per_shard_fallback(
                        index, node_body, failed_nums, nid, partials,
                        extra_failed, one_node_done)
                else:
                    one_node_done()

            def fail(_e: Exception) -> None:
                self._per_shard_fallback(
                    index, node_body, nums, nid, partials,
                    extra_failed, one_node_done)

            return handle, fail

        with tracing.restore_trace_context(ctx):
            for nid, nums in sorted(by_node.items()):
                handle, fail = make_handlers(nid, nums)
                payload = {"index": index, "shards": nums,
                           "body": node_body}
                if lane is not None:
                    payload["lane"] = lane
                self.transport.send(
                    self.node_id, nid, "indices:data/read/search[node]",
                    payload,
                    on_response=handle, on_failure=fail,
                )

    def _per_shard_fallback(self, index: str, node_body: dict,
                            nums: list[int], failed_node: str,
                            partials: list[dict], extra_failed: list[int],
                            done: Callable[[], None]) -> None:
        """Mesh-path degrade: re-execute `nums` through per-shard
        search[shard] against another serving copy (the failed node is
        excluded); shards with no other copy count into _shards.failed."""
        state = self.applied_state
        remaining = [len(nums)]

        def one_done() -> None:
            remaining[0] -= 1
            if remaining[0] == 0:
                done()

        def make_shard_handlers(num: int):
            def handle(resp: Any) -> None:
                if isinstance(resp, dict) and "hits" in resp:
                    partials.append(self._shard_resp_as_partial(num, resp))
                else:
                    extra_failed[0] += 1
                one_done()

            def fail(_e: Exception) -> None:
                extra_failed[0] += 1
                one_done()

            return handle, fail

        for num in nums:
            alt = next(
                (r for r in state.shards_for_index(index)
                 if r.shard == num and r.node_id not in (None, failed_node)
                 and r.state in ("STARTED", "RELOCATING")), None)
            if alt is None:
                extra_failed[0] += 1
                one_done()
                continue
            handle, fail = make_shard_handlers(num)
            self.transport.send(
                self.node_id, alt.node_id, "indices:data/read/search[shard]",
                {"index": index, "shard": num, "body": node_body},
                on_response=handle, on_failure=fail,
            )

    @staticmethod
    def _shard_resp_as_partial(shard_num: int, resp: dict) -> dict:
        """Wrap a per-shard search[shard] response as a reduce-compatible
        partial. `_tb` = [shard, 0, rank] preserves the merge order exactly:
        within one shard, rank order IS (segment, doc) order for equal
        scores, and cross-shard ties compare on the shard number first."""
        hits = []
        for i, h in enumerate(resp.get("hits") or []):
            h = dict(h)
            h["_tb"] = [shard_num, 0, i]
            hits.append(h)
        return {
            "took": 0, "timed_out": False,
            "_shards": {"total": 1, "successful": 1, "skipped": 0,
                        "failed": 0},
            "hits": {"total": {"value": resp.get("total", 0),
                               "relation": "eq"},
                     "max_score": resp.get("max_score"),
                     "hits": hits},
        }

    # -- per-node search partials (the QuerySearchResult wire analog) -------

    # bounded search pool: enough parallelism for the dispatch batcher to
    # see concurrent requests, small enough that one node cannot starve
    # the host (the reference's fixed `search` threadpool sizing)
    _SEARCH_POOL_WORKERS = 4

    def _offload(self, fn):
        """Run `fn` on the serial data worker thread (engine single-writer
        discipline), resolving a DeferredResponse on the transport loop.
        Falls back to synchronous execution under the deterministic sim
        (no loop, no threads)."""
        loop = getattr(self.scheduler, "loop", None)
        if loop is None:
            delay = self.data_worker_delay_ms
            if delay <= 0:
                return fn()
            # slow-data-worker fault injection: the job runs after a
            # virtual-time stall, resolving the same DeferredResponse the
            # threaded path uses (every consumer isinstance-checks it)
            from opensearch_tpu_torch.transport.base import DeferredResponse

            deferred = DeferredResponse()

            def run() -> None:
                try:
                    result = fn()
                except Exception as e:  # noqa: BLE001 - travels back as error
                    deferred.set_exception(e)
                else:
                    deferred.set_result(result)

            self.scheduler.schedule(delay, run)
            return deferred
        from concurrent.futures import ThreadPoolExecutor

        if self._data_executor is None:
            self._data_executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"{self.node_id}-data"
            )
        return self._submit_deferred(loop, self._data_executor, fn)

    # background lane pool: half the interactive width (min 1) — enough to
    # keep msearch/bulk-adjacent fan-outs flowing, small enough that a
    # flood of them leaves the interactive workers untouched
    _BG_POOL_WORKERS = 2

    def _offload_search(self, fn, lane: str | None = None):
        """Run read-only query work on the BOUNDED PARALLEL search pool:
        executions touch only immutable acquired snapshots, so concurrent
        search[node] requests proceed side by side — which is what lets the
        kNN dispatch batcher coalesce them into one shard-mesh launch (and
        what parallelizes the non-mesh per-shard fallback path).

        `lane` (search/lanes.py) picks the pool: background-lane work runs
        a separate, smaller executor so a background flood can saturate
        only its own workers — an interactive search[node] always finds an
        interactive slot. Lanes disabled -> everything shares the
        interactive pool (the pre-lane behavior)."""
        from opensearch_tpu_torch.search import lanes as lanes_mod

        lane = lane or lanes_mod.INTERACTIVE
        loop = getattr(self.scheduler, "loop", None)
        if loop is None:
            # deterministic sim: synchronous, but the lane scope still
            # rides into the batcher and the tracker still counts
            self.lane_tracker.try_submit(lane)
            try:
                with lanes_mod.lane_scope(lane):
                    return fn()
            finally:
                self.lane_tracker.complete(lane)
        from concurrent.futures import ThreadPoolExecutor

        background = (lanes_mod.default_config.enabled
                      and lane == lanes_mod.BACKGROUND)
        if background:
            if self._bg_search_executor is None:
                self._bg_search_executor = ThreadPoolExecutor(
                    max_workers=self._BG_POOL_WORKERS,
                    thread_name_prefix=f"{self.node_id}-search-bg",
                )
            executor = self._bg_search_executor
        else:
            if self._search_executor is None:
                self._search_executor = ThreadPoolExecutor(
                    max_workers=self._SEARCH_POOL_WORKERS,
                    thread_name_prefix=f"{self.node_id}-search",
                )
            executor = self._search_executor
        self.lane_tracker.try_submit(lane)
        lanes_mod.record_lane_metrics(
            self.telemetry.metrics, lane, self.lane_tracker.depth(lane))

        def tracked():
            try:
                with lanes_mod.lane_scope(lane):
                    return fn()
            finally:
                self.lane_tracker.complete(lane)

        return self._submit_deferred(loop, executor, tracked)

    @staticmethod
    def _submit_deferred(loop, executor, fn):
        from opensearch_tpu_torch.transport.base import DeferredResponse

        deferred = DeferredResponse()
        # carry the contextvars context (restored trace context, active
        # tracer) onto the worker thread so spans opened by offloaded work
        # stitch into the caller's trace (same recipe as rest/http.py)
        import contextvars as _cv

        ctx = _cv.copy_context()

        def run() -> None:
            try:
                result = ctx.run(fn)
            except Exception as e:  # noqa: BLE001 - travels back as error
                loop.call_soon_threadsafe(deferred.set_exception, e)
            else:
                loop.call_soon_threadsafe(deferred.set_result, result)

        executor.submit(run)
        return deferred

    def _on_node_search(self, sender: str, payload: dict):
        """Execute the FULL per-shard search service over this node's local
        shards of one index, returning a wire partial
        (search/service.search(partial=True)). Optionally pins the
        snapshots in a reader context for scroll/PIT.

        A requested shard whose local copy is MISSING (stale routing: the
        copy moved/failed while the coordinator's fan-out was in flight)
        degrades the partial instead of failing the whole node: the present
        shards answer (mesh launch or per-shard fallback over the present
        subset) and the missing ones ride back in `_failed_shards` /
        `_shards.failed` — allow_partial_search_results semantics at the
        node level. A scroll-pinning request still needs every shard, so
        `keep_context` keeps the strict behavior."""
        index = payload["index"]
        nums = list(payload["shards"])
        body = payload.get("body") or {}
        lane = payload.get("lane")
        keep = bool(payload.get("keep_context"))
        keep_alive_ms = int(payload.get("keep_alive_ms") or 60_000)
        self._reap_reader_contexts()

        shards, present, missing = [], [], []
        for n in nums:
            local = self.local_shards.get((index, n))
            if local is None and not keep:
                missing.append(n)
                continue
            shards.append(self._local_shard(index, n))
            present.append(n)
        if not shards:
            raise ShardNotFoundException(
                f"no copy of [{index}]{nums} on node {self.node_id}"
            )
        snaps = [s.acquire_searcher() for s in shards]

        def run() -> dict:
            from opensearch_tpu_torch.search import service as search_service

            with tracing.activate(self.telemetry.tracer), \
                    self.telemetry.tracer.start_span("search.node_partial", {
                        "index": index, "node": self.node_id,
                        "shards": len(present)}):
                resp = search_service.search(
                    shards, body, acquired=snaps, partial=True,
                    shard_numbers=present,
                )
            # residency stamp for the coordinator's replica router: after
            # serving, consult THIS node's registry/ledger rows — a kNN
            # body leaves the mesh bundle (or finds the IVF-PQ slab)
            # HBM-resident, so the stamp teaches the board this copy is
            # the warm one for the next fan-out. The kill switch disables
            # the bookkeeping too: routing off must cost nothing on the
            # hot path (no warm_for scan, no extra wire bytes).
            if residency_mod.default_config.enabled:
                field = residency_mod.knn_query_field(body)
                if field is not None:
                    resp["_residency"] = self._residency_stamp(
                        index, field, shards, snaps)
            if missing:
                resp["_shards"]["total"] += len(missing)
                resp["_shards"]["failed"] += len(missing)
                resp["_failed_shards"] = missing
            if keep:
                # register only on success — a failed first search must not
                # leak a context whose id never reaches the coordinator
                ctx_id = f"{self.node_id}#{next(self._ctx_counter)}"
                self._reader_contexts[ctx_id] = {
                    "index": index, "nums": present, "shards": shards,
                    "snaps": snaps, "body": body,
                    "keep_alive_ms": keep_alive_ms,
                    "expires_at": self._now_ms() + keep_alive_ms,
                }
                resp["_ctx_id"] = ctx_id
            return resp

        return self._offload_search(run, lane=lane)

    def _residency_advertisement(self) -> list[tuple]:
        """This node's warm (index, field) set: mesh bundles keyed to OUR
        engines (in-process sims share the registry, so the engine filter
        keeps another node's bundles out), plus published IVF-PQ
        structures (their slabs are device-resident from publish to
        retirement) — the same two signals as _residency_stamp, for the
        whole node instead of one query's shards."""
        engines = {
            sh.engine.instance_id for sh in self.local_shards.values()
        }
        pairs = set(self.shard_mesh.warm_pairs(engines))
        for (index, _num), shard in list(self.local_shards.items()):
            for _host, dev in list(shard.engine._segments):
                for fname, vf in dev.vector_fields.items():
                    if vf.ann is not None:
                        pairs.add((index, fname))
        return sorted(pairs)

    def _observe_residency(self, node_id: str, resp: Any) -> None:
        """Feed a stats answer's piggybacked warm set into the board.
        The advertisement is the node's WHOLE warm set, so a pair that
        dropped out since the last answer (its bundle evicted under
        budget pressure) is observed COLD — advertise-only learning
        would latch stale warmth and route launches onto a copy that
        must rebuild the slab."""
        pairs = resp.get("residency") if isinstance(resp, dict) else None
        if pairs is None:
            return
        warm = {
            (pair[0], pair[1]) for pair in pairs
            if isinstance(pair, (list, tuple)) and len(pair) == 2
        }
        with self._advertised_lock:
            gone = self._advertised_residency.get(node_id, set()) - warm
            self._advertised_residency[node_id] = warm
        for index, field in sorted(gone):
            self.residency_board.observe(node_id, index, field, False)
        for index, field in sorted(warm):
            self.residency_board.observe(node_id, index, field, True)

    def _maybe_seed_residency_board(self) -> None:
        """Cold-start seeding (ISSUE 15): at the first state application
        that shows other data nodes, fan ONE light stats RPC per node and
        learn their advertised warm sets — a coordinator that just joined
        a warm cluster routes its first kNN fan-out onto the copies that
        already hold the mesh bundles instead of round-robining a
        duplicate build. Best-effort: failures are ignored (the stamped
        partials keep teaching the board as before)."""
        if self._residency_seeded or not residency_mod.default_config.enabled:
            return
        others = [nid for nid in sorted(self.applied_state.nodes)
                  if nid != self.node_id]
        if not others:
            return
        self._residency_seeded = True
        for nid in others:
            self.transport.send(
                self.node_id, nid, "indices:monitor/stats[node]", {},
                on_response=(
                    lambda r, nid=nid: self._observe_residency(nid, r)),
                on_failure=lambda e: None,
            )

    def _residency_stamp(self, index: str, field: str, shards: list,
                         snaps: list) -> dict:
        """This node's residency truth for (index, field): a mesh bundle
        keyed to these shards' engines resident in the registry, or a
        published IVF-PQ structure (its slab is device-resident from
        publish to retirement)."""
        engines = {sh.engine.instance_id for sh in shards}
        mesh_warm = self.shard_mesh.warm_for(index, field, engines)
        ann_warm = any(
            (vf := dev.vector_fields.get(field)) is not None
            and vf.ann is not None
            for snap in snaps for _host, dev in snap.segments
        )
        # both signals ARE ledger-backed residency: a registry bundle
        # holds its ledger allocation until eviction frees it, and a
        # published ANN structure's slab is registered at build and freed
        # at segment retirement — so no per-query scan of the ledger's
        # full live-allocation table is needed (it grows with every
        # resident column and this runs on the hot serving path)
        return {"field": field, "warm": bool(mesh_warm or ann_warm)}

    def _on_node_msearch(self, sender: str, payload: dict):
        """Execute several search bodies over this node's local shards of
        one index, returning one wire partial per body. Bodies that are all
        bare knn queries run their query phase as ONE batched device
        dispatch (search_service.try_batched_knn_msearch); otherwise each
        body runs exactly like search[node]. msearch fan-outs are
        BACKGROUND-lane work unless the coordinator says otherwise."""
        from opensearch_tpu_torch.search import lanes as lanes_mod

        index = payload["index"]
        nums = list(payload["shards"])
        bodies = list(payload.get("bodies") or [])
        lane = payload.get("lane") or lanes_mod.BACKGROUND

        shards = [self._local_shard(index, n) for n in nums]
        snaps = [s.acquire_searcher() for s in shards]

        def run() -> dict:
            from opensearch_tpu_torch.search import service as search_service

            batched = search_service.try_batched_knn_msearch(
                shards, bodies, snaps
            )
            out = []
            for bi, body in enumerate(bodies):
                try:
                    out.append(search_service.search(
                        shards, body, acquired=snaps, partial=True,
                        shard_numbers=nums,
                        precomputed_results=(
                            batched[bi] if batched is not None else None
                        ),
                    ))
                except Exception as e:  # noqa: BLE001 - per-body error slot
                    out.append({"error": f"{type(e).__name__}: {e}"})
            return {"responses": out}

        return self._offload_search(run, lane=lane)

    def _now_ms(self) -> int:
        # injectable clock: the deterministic sim controls context expiry.
        # clock_skew_ms shifts only THIS node's reads (the fault-injection
        # hook: the sim's clock is process-global, so per-node skew lives
        # here) — expiry decisions degrade gracefully, never wedge
        from opensearch_tpu_torch.common.timeutil import monotonic_millis

        return monotonic_millis() + self.clock_skew_ms

    def _reap_reader_contexts(self) -> None:
        now = self._now_ms()
        # snapshot first: registration happens on the search pool while
        # this runs on the transport loop — iterating the live dict could
        # see a concurrent insert mid-walk
        for cid, x in list(self._reader_contexts.items()):
            if x["expires_at"] < now:
                self._reader_contexts.pop(cid, None)

    def _on_ctx_search(self, sender: str, payload: dict):
        """Search against a pinned reader context (scroll page / PIT
        search). `body` overrides the stored one (PIT); from/size override
        paging (scroll deepening)."""
        self._reap_reader_contexts()
        ctx = self._reader_contexts.get(payload["ctx_id"])
        if ctx is None:
            from opensearch_tpu_torch.common.errors import (
                SearchContextMissingException,
            )

            raise SearchContextMissingException(
                f"no search context [{payload['ctx_id']}]"
            )
        ctx["expires_at"] = self._now_ms() + ctx["keep_alive_ms"]
        if payload.get("body") is not None:
            body = dict(payload["body"])  # PIT: fresh body, aggs included
        else:
            # scroll page: stored body minus aggs (computed on page 1 only)
            body = dict(ctx["body"] or {})
            body.pop("aggs", None)
            body.pop("aggregations", None)
        if "from" in payload:
            body["from"] = int(payload["from"])
        if "size" in payload:
            body["size"] = int(payload["size"])
        shards, snaps, nums = ctx["shards"], ctx["snaps"], ctx["nums"]

        def run() -> dict:
            from opensearch_tpu_torch.search import service as search_service

            with tracing.activate(self.telemetry.tracer), \
                    self.telemetry.tracer.start_span("search.node_partial", {
                        "index": ctx["index"], "node": self.node_id,
                        "shards": len(nums), "pinned": True}):
                return search_service.search(
                    shards, body, acquired=snaps, partial=True,
                    shard_numbers=nums,
                )

        return self._offload_search(run)

    def _on_ctx_close(self, sender: str, payload: dict) -> dict:
        freed = 0
        for cid in payload.get("ctx_ids", []):
            if self._reader_contexts.pop(cid, None) is not None:
                freed += 1
        return {"freed": freed}

    def _on_node_flush(self, sender: str, payload: dict):
        names = payload.get("indices")  # resolved list from the coordinator

        def run() -> dict:
            flushed = 0
            for (index, num), shard in list(self.local_shards.items()):
                if names is None or index in names:
                    shard.flush()
                    flushed += 1
            return {"ack": True, "flushed": flushed}

        return self._offload(run)

    def _on_node_forcemerge(self, sender: str, payload: dict):
        names = payload.get("indices")

        def run() -> dict:
            merged = []
            for (index, num), shard in list(self.local_shards.items()):
                if names is not None and index not in names:
                    continue
                if shard.replication == "SEGMENT" and not shard.primary:
                    # segrep replicas never merge locally — the primary's
                    # merged segment arrives via the next checkpoint
                    continue
                shard.engine.force_merge(
                    max_num_segments=int(payload.get("max_num_segments", 1)),
                )
                if shard.primary and shard.replication == "SEGMENT":
                    merged.append((index, num))
            return {"ack": True, "_publish": merged}

        deferred = self._offload(run)
        from opensearch_tpu_torch.transport.base import DeferredResponse

        def publish_after(d):
            if d.error is None and isinstance(d.result, dict):
                for index, num in d.result.get("_publish", []):
                    self._publish_checkpoint(index, num)

        if isinstance(deferred, DeferredResponse):
            deferred.on_done(publish_after)
        return deferred

    def _on_node_stats(self, sender: str, payload: dict) -> dict:
        out = {}
        for (index, num), shard in self.local_shards.items():
            out[f"{index}#{num}"] = {
                "index": index, "shard": num,
                "primary": bool(shard.primary),
                "docs": shard.num_docs,
            }
            if payload.get("store"):
                # the copy's bytes as a single node's _cat/indices counts
                # them: its translog and every stored source
                out[f"{index}#{num}"]["store_bytes"] = \
                    shard.engine.translog.stats()["size_in_bytes"] + sum(
                        sum(len(x) for x in host.sources)
                        for host, _dev in shard.engine._segments)
        resp: dict[str, Any] = {
            "shards": out,
            "shard_mesh": self.shard_mesh.snapshot_stats(),
        }
        # cross-node residency advertisement (ISSUE 15): this node's warm
        # (index, field) set piggybacks on EVERY stats answer — light and
        # full — so any coordinator that talks stats to us learns which
        # copies are warm without waiting for a stamped kNN partial. The
        # kill switch drops it (routing off must cost nothing).
        if residency_mod.default_config.enabled:
            resp["residency"] = [
                list(p) for p in self._residency_advertisement()
            ]
        if payload.get("full"):
            # the cluster-wide _nodes/stats fan-out: this node's whole
            # telemetry surface rides back to the coordinator — metrics
            # with exemplars, the spans-ring tail, exporter accounting,
            # batcher stats and any coordinator-registered extras (the
            # facade's request cache). The light form (no flag) stays cheap
            # for index_stats' per-shard doc counts. An optional "sections"
            # list narrows the payload: a recurring Prometheus scrape asks
            # for ["metrics"] alone instead of shipping ~100 serialized
            # spans per node over the transport every 15 seconds.
            sections = payload.get("sections")

            def want(section: str) -> bool:
                return sections is None or section in sections

            telemetry: dict[str, Any] = dict(self.telemetry.metrics.stats())
            if want("spans"):
                telemetry["spans"] = [
                    s.to_dict()
                    for s in self.telemetry.tracer.finished_spans()[-100:]
                ]
                exporter = self.telemetry.tracer.exporter
                if exporter is not None:
                    telemetry["exporter"] = exporter.snapshot_stats()
            resp["name"] = self.node_id
            resp["telemetry"] = telemetry
            if want("knn_batch"):
                resp["knn_batch"] = self.knn_batcher.snapshot_stats()
            if want("device"):
                # device-memory residency (telemetry/device_ledger.py):
                # per-structure HBM bytes, the accounting identity, and the
                # per-kernel-family compile table. Process-wide — in-process
                # sim nodes report the shared ledger, like the batcher.
                from opensearch_tpu_torch.telemetry import device_ledger

                resp["device"] = device_ledger.stats_section()
            if want("device_totals"):
                # lightweight per-device byte totals for the recurring
                # federated Prometheus scrape (the full structure rows stay
                # off that path, like the span-ring narrowing)
                from opensearch_tpu_torch.telemetry.device_ledger import (
                    default_ledger as _ledger,
                )

                resp["device_totals"] = _ledger.device_totals()
            if want("tail"):
                resp["tail"] = self.tail_stats()
            if want("roofline"):
                # kernel roofline accounting (telemetry/roofline.py):
                # per-family achieved FLOP/s + roofline fractions against
                # the calibrated peaks. Process-wide — in-process sim
                # nodes report the shared recorder, like the ledger.
                from opensearch_tpu_torch.telemetry import roofline

                resp["roofline"] = roofline.stats_section()
            if want("heat"):
                # structure access heat (telemetry/device_ledger.py touch
                # accounting): per-structure touch/recency/class rows the
                # tiering advisor replays. Process-wide, like the ledger.
                from opensearch_tpu_torch.telemetry import device_ledger

                resp["heat"] = device_ledger.heat_section()
            if want("providers"):
                for name, provider in list(self.stats_providers.items()):
                    try:
                        resp[name] = provider()
                    except Exception as e:  # noqa: BLE001 - never fail stats
                        import logging

                        logging.getLogger(__name__).warning(
                            "stats provider [%s] failed: %s", name, e)
        return resp

    def tail_stats(self) -> dict:
        """The `tail` stats section (ISSUE 11): lane queue depths + shed
        counts, residency-routing decisions, and wlm search-slot budgets —
        the whole tail-latency control plane in one read. `lanes` is the
        data-plane (search-pool) tracker; `http_lanes` — present when a
        REST facade is attached — is the HTTP boundary's, which is where
        the bounded background queue sheds 429s."""
        from opensearch_tpu_torch.search import lanes as lanes_mod

        out = {
            "lanes": {
                "enabled": lanes_mod.default_config.enabled,
                "background_max_queue":
                    lanes_mod.default_config.background_max_queue,
                **self.lane_tracker.snapshot(),
            },
            "routing": self.residency_board.snapshot_stats(),
            "wlm_search": self.query_groups.search_slot_stats(),
        }
        http_tracker = getattr(self, "http_lane_tracker", None)
        if http_tracker is not None:
            out["http_lanes"] = http_tracker.snapshot()
        return out

    def _on_otel_flush(self, sender: str, payload: dict) -> dict:
        """`POST /_otel/flush` per-node leg: force the span exporter to
        decide + drain everything it holds, then report the exporter
        ledger and the device-residency snapshot — the admin's "show me
        the telemetry truth right now" button."""
        from opensearch_tpu_torch.telemetry import device_ledger

        exporter = self.telemetry.tracer.exporter
        if exporter is not None:
            exporter.flush()
        return {
            "name": self.node_id,
            "flushed": exporter is not None,
            "exporter": (exporter.snapshot_stats()
                         if exporter is not None else None),
            "device": device_ledger.stats_section(),
        }

    def _on_shard_search(self, sender: str, payload: dict):
        def run() -> dict:
            # shard query-phase span: the transport restored the sender's
            # trace context, so this parents under the coordinator span
            with tracing.activate(self.telemetry.tracer), \
                    self.telemetry.tracer.start_span("search.shard_query", {
                        "index": payload["index"],
                        "shard": payload["shard"],
                        "node": self.node_id}):
                return self._shard_search_local(payload)

        return self._offload_search(run, lane=payload.get("lane"))

    def _shard_search_local(self, payload: dict) -> dict:
        """Per-shard query+fetch (the combined phase; split q/f is the
        optimization path). Returns hits with _id/_score/_source; with
        `"profile": true` a deep per-operator profile entry rides along
        (device kernel time, transfer bytes, retrace flag)."""
        from opensearch_tpu_torch.search import profile as search_profile

        shard = self._local_shard(payload["index"], payload["shard"])
        body = payload.get("body") or {}
        node = query_dsl.parse_query(body.get("query"))
        size = int(body.get("size", 10)) + int(body.get("from", 0))
        sort = body.get("sort")
        if isinstance(sort, (str, dict)):
            sort = [sort]
        snapshot = shard.acquire_searcher()
        prof = (search_profile.ShardProfiler()
                if body.get("profile") else None)
        with search_profile.profiling(prof):
            result = execute_query_phase(
                snapshot, shard.mapper_service, node, size=size,
                sort=sort,
            )
        src_filter = _source_filter(body.get("_source", True))
        hits = []
        for h in result.hits:
            host = snapshot.segments[h.segment][0]
            hit = {"_id": host.doc_ids[h.doc], "_score": h.score,
                   "_index": payload["index"]}
            src = src_filter(json.loads(host.sources[h.doc]))
            if src is not None:
                hit["_source"] = src
            if h.sort_values:
                hit["sort"] = h.sort_values
            hits.append(hit)
        out = {"total": result.total, "hits": hits,
               "max_score": result.max_score}
        if prof is not None:
            out["profile"] = {
                "id": f"[{payload['index']}][{payload['shard']}]",
                "searches": [{
                    "query": prof.query_entries(),
                    "rewrite_time": prof.rewrite_ns,
                    "collector": [{
                        "name": "SimpleTopDocsCollector",
                        "reason": "search_top_hits",
                        "time_in_nanos": prof.collect_ns,
                    }],
                }],
                "tpu": prof.tpu_summary(),
                "aggregations": [],
            }
        return out

    def _merge_search_results(
        self, results: dict[int, dict], size: int,
        from_: int = 0, sort: list | None = None,
        extra_failed: int = 0,
    ) -> dict:
        total = 0
        max_score = None
        merged = []
        failed = 0
        profile_shards = []
        for shard_num in sorted(results):
            resp = results[shard_num]
            if not isinstance(resp, dict) or "hits" not in resp:
                failed += 1
                continue
            total += resp["total"]
            if resp["max_score"] is not None and (
                max_score is None or resp["max_score"] > max_score
            ):
                max_score = resp["max_score"]
            if "profile" in resp:
                profile_shards.append(resp["profile"])
            for h in resp["hits"]:
                merged.append((shard_num, h))
        if sort:
            # k-way merge on per-hit sort values (SearchPhaseController
            # mergeTopDocs for field sorts), shard index as tie-break
            from opensearch_tpu_torch.search.service import _values_key

            merged.sort(
                key=lambda sh: (_values_key(sort, sh[1].get("sort", [])),
                                sh[0], sh[1]["_id"])
            )
        else:
            merged.sort(key=lambda sh: (-(sh[1]["_score"] or 0.0), sh[0], sh[1]["_id"]))
        out = {
            "took": 0,
            "timed_out": False,
            "_shards": {"total": len(results) + extra_failed,
                        "successful": len(results) - failed,
                        "skipped": 0, "failed": failed + extra_failed},
            "hits": {
                "total": {"value": total, "relation": "eq"},
                "max_score": max_score,
                "hits": [h for _, h in merged[from_: from_ + size]],
            },
        }
        if profile_shards:
            # per-shard profiles merge into the standard response shape
            # (each data node already built its shard entry)
            out["profile"] = {"shards": sorted(
                profile_shards, key=lambda s: s.get("id", ""))}
        return out

    def close(self) -> None:
        self._closed = True
        # flush-on-shutdown: pending trace fragments decide + drain before
        # the rest of the node tears down
        from opensearch_tpu_torch.telemetry.export import close_exporter

        close_exporter(self.telemetry)
        timer = getattr(self, "_shard_tick_timer", None)
        if timer is not None:
            timer.cancel()
        for driver in self._recovery_drivers.values():
            driver.cancel()
        self._recovery_drivers.clear()
        self.coordinator.stop()
        if self._data_executor is not None:
            self._data_executor.shutdown(wait=False)
        if self._search_executor is not None:
            self._search_executor.shutdown(wait=False)
        if self._bg_search_executor is not None:
            self._bg_search_executor.shutdown(wait=False)
        self._reader_contexts.clear()
        # the registry of stacked bundles is process-wide: drop the ones
        # holding this node's engines (other nodes' bundles of the same
        # indices stay), so a closed node leaves no device memory behind
        from opensearch_tpu_torch.cluster.shard_mesh import default_registry

        default_registry.invalidate_index(
            None, [shard.engine.instance_id
                   for shard in self.local_shards.values()])
        for shard in self.local_shards.values():
            shard.close()
