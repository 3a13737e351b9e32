"""ClusterFacade: the TorchNode API surface served by a cluster.

The reference funnels every request through ONE RestController + NodeClient
in front of one action registry regardless of cluster size
(rest/RestController.java:285, action/ActionModule.java:527). This module
is that unification for the port: rest/handlers.py's 128 routes run
unchanged against this object — its methods carry TorchNode's signatures but
execute with cluster semantics:

- metadata ops route to the elected leader and ride cluster-state
  publication;
- document ops route to primaries by murmur3(_routing) % shards and ack
  after full replication (TransportReplicationAction semantics);
- searches fan out ONE request per data node holding shards of the target
  index (search[node] returns a wire partial over all its local shards)
  and reduce on the coordinator (search/reduce.py:
  SearchPhaseController.mergeTopDocs + InternalAggregations.reduce);
- scroll/PIT pin per-node reader contexts; the cluster scroll id encodes
  {node -> ctx} so ANY node can continue a scroll.

Threading: facade methods are called from the HTTP executor thread and
bridge onto the transport event loop (call_soon_threadsafe + futures); the
loop thread never blocks in here.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
from concurrent.futures import Future
from typing import Any, Callable

from opensearch_tpu_torch import __version__
from opensearch_tpu_torch.common.errors import (
    DocumentMissingException,
    IllegalArgumentException,
    IndexNotFoundException,
    OpenSearchTpuException,
    ResourceAlreadyExistsException,
    SearchContextMissingException,
    VersionConflictException,
)
from opensearch_tpu_torch.common.settings import (
    Settings,
    setting_str,
    settings_section as _settings_section,
)
from opensearch_tpu_torch.cluster.state import routing_health
from opensearch_tpu_torch.index.mapper import MapperService

logger = logging.getLogger(__name__)

RPC_TIMEOUT_S = 30.0

# transport errors arrive as "ExceptionName: reason" strings; map the names
# back to typed exceptions so REST status codes survive the wire
_ERROR_TYPES = {}


def _register_error_types() -> None:
    import opensearch_tpu_torch.common.errors as err_mod

    for name in dir(err_mod):
        obj = getattr(err_mod, name)
        if isinstance(obj, type) and issubclass(obj, OpenSearchTpuException):
            _ERROR_TYPES[name] = obj


_register_error_types()


def rehydrate_error(message) -> OpenSearchTpuException:
    # loopback sends deliver the exception object itself — keep its type
    if isinstance(message, OpenSearchTpuException):
        return message
    if isinstance(message, Exception):
        message = str(message)
    name, _, reason = str(message).partition(":")
    cls = _ERROR_TYPES.get(name.strip())
    if cls is not None:
        try:
            return cls(reason.strip())
        except TypeError:
            pass
    return OpenSearchTpuException(str(message))


class _IndexView:
    """Read-only IndexService stand-in built from cluster state."""

    def __init__(self, meta, mapper_service: MapperService):
        self.name = meta.name
        self.num_shards = meta.num_shards
        self.num_replicas = meta.num_replicas
        self.settings = dict(meta.settings or {})
        self.mapper_service = mapper_service
        self.aliases: dict[str, dict] = dict(
            (meta.settings or {}).get("_aliases", {})
        )
        self.shards: dict[int, Any] = {}
        self.closed = False  # a cluster has no close / open yet
        # the cluster state keeps neither an index's uuid nor its creation
        # date: _cat/indices shows these stand-ins
        self.uuid = "_na_"
        self.creation_date = 0
        self._flat_settings: dict | None = None

    def setting(self, key: str, default=None):
        """An index setting by dotted key, bare or "index."-prefixed, as
        the single node's IndexService answers it; the metadata's own
        ``_``-keys (aliases) are not settings."""
        if self._flat_settings is None:
            self._flat_settings = Settings.from_nested(
                {k: v for k, v in self.settings.items()
                 if not k.startswith("_")}).as_dict()
        flat = self._flat_settings
        if key in flat:
            return flat[key]
        return flat.get(f"index.{key}", default)


class ClusterFacade:
    def __init__(self, cluster_node, loop):
        self.node = cluster_node
        self.loop = loop
        self.node_name = cluster_node.node_id
        self._mapper_cache: dict[tuple[str, int], MapperService] = {}
        # node-local services (the reference's are node-local too)
        from opensearch_tpu_torch.tasks.manager import TaskManager

        self.task_manager = TaskManager(cluster_node.node_id)
        # one telemetry per node process: facade (coordinator role) spans
        # and the data-plane handler spans share this node's ring, so
        # _nodes/stats and /_prometheus/metrics see both
        self.telemetry = cluster_node.telemetry
        from opensearch_tpu_torch.index.request_cache import (
            CACHE_SIZE_SETTING,
            RequestCache,
        )

        self.request_cache = RequestCache()

        def _apply_cache_size(eff: dict) -> None:
            from opensearch_tpu_torch.common.settings import Settings

            self.request_cache.set_max_bytes(
                CACHE_SIZE_SETTING.get(Settings.from_flat(eff)))

        cluster_node.settings_consumers.register(
            CACHE_SIZE_SETTING.key, _apply_cache_size)
        # the request cache is coordinator-side (it lives with the REST
        # surface, not the data plane): register it as a stats provider so
        # the cluster-wide _nodes/stats fan-out reports THIS node's cache
        # alongside the data-plane sections
        cluster_node.stats_providers["request_cache"] = \
            self.request_cache.stats
        # the kNN dispatch batcher is process-wide (one process == one
        # device); the facade shares it so cluster-mode stats see the same
        # coalescing the data plane performs
        from opensearch_tpu_torch.search import batcher as _batcher_mod

        self.knn_batcher = _batcher_mod.default_batcher
        from opensearch_tpu_torch.common.monitor import MonitorService

        self.monitor = MonitorService(cluster_node.data_path)
        # one wlm registry per node process: the facade (search admission)
        # and the cluster node (bulk admission) must see the same groups
        # and share the same slot budgets
        self.query_groups = cluster_node.query_groups
        # the facade keeps its OWN lane tracker for the HTTP boundary:
        # sharing the cluster node's cells would double-count every
        # coordinator-local request (once at REST submit, again when its
        # search[node]/msearch[node] leg lands on this node's search
        # pools) and halve the effective background_max_queue shed bound.
        # The node's `tail` stats section reports BOTH trackers (the
        # boundary one as `http_lanes` — that is where the bounded
        # background queue actually sheds).
        from opensearch_tpu_torch.search import lanes as _lanes_mod

        self.lane_tracker = _lanes_mod.LaneTracker()
        cluster_node.http_lane_tracker = self.lane_tracker
        self.tail_stats = cluster_node.tail_stats
        from opensearch_tpu_torch.persistent import PersistentTasksService

        self.persistent_tasks = PersistentTasksService(
            cluster_node.data_path / "persistent_tasks.json"
        )

    # ------------------------------------------------------------------ #
    # loop bridging
    # ------------------------------------------------------------------ #

    def _on_loop(self, fn: Callable[[Callable[[dict], None]], None]) -> dict:
        """Run callback-style `fn(callback)` on the transport loop; block
        this (executor) thread for the response."""
        fut: Future = Future()

        def run() -> None:
            try:
                fn(lambda resp: fut.done() or fut.set_result(resp))
            except Exception as e:  # noqa: BLE001
                if not fut.done():
                    fut.set_exception(e)

        self.loop.call_soon_threadsafe(run)
        resp = fut.result(timeout=RPC_TIMEOUT_S)
        if isinstance(resp, dict) and "error" in resp and set(resp) <= {
            "error", "status"
        }:
            raise rehydrate_error(resp["error"])
        return resp

    def _rpc(self, target: str, action: str, payload: dict) -> dict:
        """One transport round-trip from the executor thread."""
        def fn(callback):
            self.node.transport.send(
                self.node.node_id, target, action, payload,
                on_response=callback,
                on_failure=lambda e: callback(
                    {"error": e if isinstance(e, OpenSearchTpuException)
                     else str(e), "status": 500}
                ),
            )
        return self._on_loop(fn)

    def _rpc_many(self, calls: list[tuple[str, str, dict]]) -> list[dict]:
        """Concurrent fan-out; preserves call order in the result list."""
        fut: Future = Future()
        results: list = [None] * len(calls)
        remaining = [len(calls)]

        def run() -> None:
            def one(i: int):
                def ok(resp) -> None:
                    results[i] = resp
                    remaining[0] -= 1
                    if remaining[0] == 0 and not fut.done():
                        fut.set_result(results)

                def fail(e: Exception) -> None:
                    ok({"error": e if isinstance(e, OpenSearchTpuException)
                        else str(e), "status": 500})

                return ok, fail

            for i, (target, action, payload) in enumerate(calls):
                ok, fail = one(i)
                self.node.transport.send(
                    self.node.node_id, target, action, payload,
                    on_response=ok, on_failure=fail,
                )

        if not calls:
            return []
        self.loop.call_soon_threadsafe(run)
        return fut.result(timeout=RPC_TIMEOUT_S)

    # ------------------------------------------------------------------ #
    # state views
    # ------------------------------------------------------------------ #

    @property
    def state(self):
        return self.node.applied_state

    def _meta(self, index: str):
        meta = self.state.indices.get(index)
        if meta is None:
            raise IndexNotFoundException(index)
        return meta

    def _mapper_for(self, index: str) -> MapperService:
        meta = self._meta(index)
        key = (index, meta.version)
        ms = self._mapper_cache.get(key)
        if ms is None:
            ms = MapperService(meta.mappings or None)
            self._mapper_cache[key] = ms
            for k in [k for k in self._mapper_cache
                      if k[0] == index and k[1] != meta.version]:
                del self._mapper_cache[k]
        return ms

    @property
    def indices(self) -> dict[str, _IndexView]:
        return {
            name: _IndexView(meta, self._mapper_for(name))
            for name, meta in self.state.indices.items()
        }

    def resolve_indices(self, expr: str | None, *,
                        ignore_unavailable: bool = False,
                        allow_no_indices: bool = True,
                        expand_wildcards: str = "open") -> list[str]:
        """The single node's resolution (node.resolve_index_names:
        `ignore_unavailable`, `allow_no_indices`, `expand_wildcards`, "-"
        exclusions, aliases expanded to their members, hidden indices)
        over the cluster state's index views."""
        from opensearch_tpu_torch.node import resolve_index_names

        return resolve_index_names(
            "" if expr is None else str(expr), self.indices,
            ignore_unavailable=ignore_unavailable,
            allow_no_indices=allow_no_indices,
            expand_wildcards=expand_wildcards)

    def get_alias(self, index_expr: str | None = None,
                  alias_expr: str | None = None,
                  expand_wildcards: str = "all") -> dict:
        """GET [/{index}]/_alias[/{name}] as TorchNode.get_alias answers
        it, over the aliases in the cluster state's index metadata (a
        cluster has no closed index, so `expand_wildcards` selects all)."""
        from opensearch_tpu_torch.node import get_alias_response

        names = (self.resolve_indices(index_expr) if index_expr
                 else sorted(self.state.indices))
        views = self.indices
        return get_alias_response(names, lambda n: views[n].aliases,
                                  alias_expr)

    def explain(self, index: str, doc_id: str, body: dict,
                routing: str | None = None) -> dict:
        """_explain as TorchNode.explain answers it, run by the node
        holding the doc's shard, which a GET of the doc would reach."""
        from opensearch_tpu_torch.node import write_target

        body = body or {}
        if body and "query" not in body:
            raise IllegalArgumentException(
                "request body must contain a [query] element")
        views = self.indices
        concrete = write_target(index, [
            (name, view.aliases[index])
            for name, view in sorted(views.items()) if index in view.aliases])
        if concrete != index and routing is None:
            conf = views[concrete].aliases.get(index) or {}
            routing = conf.get("index_routing", conf.get("routing"))
        self._meta(concrete)
        return self._on_loop(lambda cb: self.node.explain(
            concrete, doc_id, body, cb, routing=routing))

    # ------------------------------------------------------------------ #
    # index lifecycle (leader-routed)
    # ------------------------------------------------------------------ #

    def create_index(self, name: str, body: dict | None = None) -> dict:
        if name in self.state.indices:
            raise ResourceAlreadyExistsException(
                f"index [{name}] already exists"
            )
        leader = self._leader()
        resp = self._rpc(leader, "cluster:admin/create_index",
                         {"name": name, "body": body or {}})
        self._wait_active_primaries(name)
        return resp

    def delete_index(self, name: str, *, ignore_unavailable: bool = False,
                     allow_no_indices: bool = True) -> dict:
        """DELETE /{index} with TorchNode.delete_index's resolution
        (node.delete_targets) over the cluster state's indices and their
        aliases; each target is one leader-routed delete."""
        from opensearch_tpu_torch.node import delete_targets

        aliases: dict[str, list[str]] = {}
        for idx, view in sorted(self.indices.items()):
            for alias in view.aliases:
                aliases.setdefault(alias, []).append(idx)
        for n in delete_targets(name, sorted(self.state.indices), aliases,
                                ignore_unavailable=ignore_unavailable,
                                allow_no_indices=allow_no_indices):
            self._rpc(self._leader(), "cluster:admin/delete_index",
                      {"name": n})
        return {"acknowledged": True}

    def put_mapping(self, index: str, body: dict) -> dict:
        return self._rpc(self._leader(), "cluster:admin/put_mapping",
                         {"name": index, "mappings": body or {}})

    def get_mapping(self, index: str, *, ignore_unavailable: bool = False,
                    allow_no_indices: bool = True,
                    expand_wildcards: str = "open") -> dict:
        names = self.resolve_indices(index)
        return {
            name: {"mappings": self._mapper_for(name).to_dict()}
            for name in names
        }

    def get_settings(self, index: str, *, name: str | None = None,
                     flat: bool = False, include_defaults: bool = False,
                     expand_wildcards: str = "all") -> dict:
        """Same contract as TorchNode.get_settings (name filter, flat vs
        nested shape, defaults section, the index's creation date, uuid
        and provided name) over the replicated metadata, via the shared
        index_settings_entry shaping. The cluster state keeps neither a
        uuid nor a creation date: the index view's stand-ins, as
        _cat/indices shows them."""
        from opensearch_tpu_torch.node import index_settings_entry

        out = {}
        for idx_name in self.resolve_indices(index):
            meta = self._meta(idx_name)
            view = _IndexView(meta, None)
            raw = {k: v for k, v in (meta.settings or {}).items()
                   if not k.startswith("_")}
            out[idx_name] = index_settings_entry(
                raw, num_shards=meta.num_shards,
                num_replicas=meta.num_replicas,
                name=name, flat=flat, include_defaults=include_defaults,
                extra={"index.creation_date": str(view.creation_date),
                       "index.uuid": view.uuid,
                       "index.provided_name": idx_name},
            )
        return out

    def _leader(self) -> str:
        leader = self.node.coordinator.leader_id
        if leader is None:
            raise OpenSearchTpuException("no elected cluster manager")
        return leader

    def _wait_active_primaries(self, index: str, timeout_s: float = 10.0) -> None:
        # real-thread poll against live TCP nodes; the facade never runs
        # under the virtual-time sim, and the deadline must track REAL
        # time here — reading the injectable clock would freeze this loop
        # if another component installs a VirtualClock process-wide
        import time as _t

        deadline = _t.monotonic() + timeout_s  # tpulint: disable=TPU004
        while _t.monotonic() < deadline:  # tpulint: disable=TPU004
            entries = [r for r in self.state.routing
                       if r.index == index and r.primary]
            if entries and all(r.state == "STARTED" for r in entries):
                return
            _t.sleep(0.05)  # tpulint: disable=TPU004

    # ------------------------------------------------------------------ #
    # documents
    # ------------------------------------------------------------------ #

    def _auto_id(self) -> str:
        """Auto document ids draw from the node's scheduler RNG — the
        injectable entropy source (seeded under the deterministic sim,
        time-seeded by LoopScheduler in production). uuid4/os.urandom
        would defeat sim replayability (tpulint TPU006)."""
        return "%020x" % self.node.scheduler.random.getrandbits(80)

    def index_doc(self, index: str, doc_id: str | None, source: dict,
                  routing: str | None = None, if_seq_no: int | None = None,
                  refresh: bool = False, op_type: str | None = None,
                  pipeline: str | None = None, version: int | None = None,
                  version_type: str = "internal",
                  if_primary_term: int | None = None) -> dict:
        if if_primary_term is not None and int(if_primary_term) != 1:
            raise VersionConflictException(
                f"[{doc_id}]: version conflict, required primaryTerm "
                f"[{if_primary_term}], current primaryTerm [1]"
            )
        if pipeline is not None:
            self._unsupported("ingest pipelines")
        if version is not None:
            self._unsupported("explicit document versions in cluster mode")
        if doc_id is None:
            doc_id = self._auto_id()
        resp = self._on_loop(lambda cb: self.node.index_doc(
            index, doc_id, source, cb, routing=routing,
            if_seq_no=if_seq_no, op_type=op_type,
        ))
        if refresh:
            self.refresh(index)
        return resp

    def get_doc(self, index: str, doc_id: str,
                routing: str | None = None, realtime: bool = True,
                version: int | None = None, refresh: bool = False) -> dict:
        got = self._on_loop(lambda cb: self.node.get_doc(
            index, doc_id, cb, routing=routing
        ))
        if version is not None and got.get("found") \
                and got.get("_version") != version:
            from opensearch_tpu_torch.common.errors import VersionConflictException

            raise VersionConflictException(
                f"[{doc_id}]: version conflict, current version "
                f"[{got.get('_version')}] is different than the one "
                f"provided [{version}]"
            )
        return got

    def delete_doc(self, index: str, doc_id: str, routing: str | None = None,
                   refresh: bool = False, if_seq_no: int | None = None,
                   version: int | None = None,
                   version_type: str = "internal") -> dict:
        if version is not None or if_seq_no is not None:
            self._unsupported("versioned deletes in cluster mode")
        resp = self._on_loop(lambda cb: self.node.delete_doc(
            index, doc_id, cb, routing=routing
        ))
        if refresh:
            self.refresh(index)
        return resp

    def update_doc(self, index: str, doc_id: str, body: dict,
                   routing: str | None = None, refresh: bool = False,
                   if_seq_no: int | None = None,
                   require_alias: bool = False) -> dict:
        """Coordinator-side read-modify-write with optimistic concurrency
        (UpdateHelper semantics over the cluster write path)."""
        current = self.get_doc(index, doc_id, routing=routing)
        if if_seq_no is not None:
            current_seq = current.get("_seq_no") if current.get("found") else -1
            if current_seq != if_seq_no:
                from opensearch_tpu_torch.common.errors import (
                    VersionConflictException,
                )

                raise VersionConflictException(
                    f"[{doc_id}]: version conflict, required seqNo "
                    f"[{if_seq_no}], current document has seqNo "
                    f"[{current_seq}]"
                )
        exists = current.get("found")
        if "script" in body:
            from opensearch_tpu_torch.script import default_script_service

            if not exists:
                if "upsert" in body:
                    return self.index_doc(index, doc_id, body["upsert"],
                                          routing=routing, refresh=refresh)
                raise DocumentMissingException(f"[{doc_id}]: document missing")
            ctx = {"_source": dict(current["_source"]), "op": "index",
                   "_index": index, "_id": doc_id}
            ast, params = default_script_service.compile(body["script"])
            default_script_service.execute_update(ast, params, ctx)
            if ctx.get("op") in ("none", "noop"):
                return {"_index": index, "_id": doc_id, "result": "noop",
                        "_shards": {"total": 0, "successful": 0, "failed": 0}}
            if ctx.get("op") == "delete":
                return self.delete_doc(index, doc_id, routing=routing,
                                       refresh=refresh)
            out = self.index_doc(index, doc_id, ctx["_source"],
                                 routing=routing, refresh=refresh,
                                 if_seq_no=current.get("_seq_no"))
            out["result"] = "updated"
            return out
        if "doc" in body:
            if not exists:
                if body.get("doc_as_upsert"):
                    return self.index_doc(index, doc_id, body["doc"],
                                          routing=routing, refresh=refresh)
                raise DocumentMissingException(f"[{doc_id}]: document missing")
            merged = _deep_merge(dict(current["_source"]), body["doc"])
            out = self.index_doc(index, doc_id, merged, routing=routing,
                                 refresh=refresh,
                                 if_seq_no=current.get("_seq_no"))
            out["result"] = "updated"
            return out
        if "upsert" in body and not exists:
            return self.index_doc(index, doc_id, body["upsert"],
                                  routing=routing, refresh=refresh)
        raise IllegalArgumentException("update requires [doc] or [upsert]")

    def bulk(self, operations, refresh: bool = False,
             pipeline: str | None = None,
             payload_bytes: int | None = None,
             query_group: str | None = None) -> dict:
        if pipeline is not None:
            self._unsupported("ingest pipelines")
        ops = []
        for action, meta, source in operations:
            meta = dict(meta)
            if action in ("index", "create") and not meta.get("_id"):
                meta["_id"] = self._auto_id()
            ops.append((action, meta, source))
        resp = self._on_loop(
            lambda cb: self.node.bulk(ops, cb, query_group=query_group))
        if refresh:
            touched = {m.get("_index") for _a, m, _s in ops if m.get("_index")}
            for idx in touched:
                try:
                    self.refresh(idx)
                except OpenSearchTpuException:
                    pass
        return resp

    def mget(self, index: str | None, body: dict,
             realtime: bool = True, refresh: bool = False,
             stored_fields: list | None = None) -> dict:
        docs_spec = body.get("docs")
        if docs_spec is None and "ids" in body:
            docs_spec = [{"_id": i} for i in body["ids"]]
        if docs_spec is None:
            raise IllegalArgumentException("mget requires docs or ids")
        docs = []
        for spec in docs_spec:
            idx = spec.get("_index", index)
            try:
                docs.append(self.get_doc(idx, spec["_id"],
                                         routing=spec.get("routing")))
            except OpenSearchTpuException as e:
                docs.append({"_index": idx, "_id": spec.get("_id"),
                             "error": e.to_dict()})
        return {"docs": docs}

    # ------------------------------------------------------------------ #
    # search (per-node fan-out + coordinator reduce)
    # ------------------------------------------------------------------ #

    def _node_assignments(
        self, names: list[str], body: dict | None = None,
    ) -> list[tuple[str, str, list[int]]]:
        """[(node_id, index, [shard_nums])] — one entry per (node, index).
        Bare-kNN bodies route RESIDENCY-AWARE (cluster/residency.py): each
        shard's launch lands on the copy whose mesh bundle / IVF-PQ slab
        the board knows to be HBM-resident, round-robin when no copy is
        warm; everything else keeps the prefer-primary selection."""
        from opensearch_tpu_torch.cluster import residency as residency_mod

        state = self.state
        field = residency_mod.knn_query_field(body) if body else None
        out: dict[tuple[str, str], list[int]] = {}
        for name in names:
            meta = self._meta(name)
            candidates: dict[int, list] = {}
            for r in state.shards_for_index(name):
                # RELOCATING sources still serve until the routing swap
                if r.state not in ("STARTED", "RELOCATING") or r.node_id is None:
                    continue
                candidates.setdefault(r.shard, []).append(r)
            if len(candidates) < meta.num_shards:
                raise OpenSearchTpuException(
                    f"not all shards of [{name}] are available"
                )
            if field is not None:
                targets, _warm = residency_mod.choose_copies(
                    self.node.residency_board, name, field, candidates,
                    next(self.node._route_rr))
            else:
                targets = {
                    num: next((r for r in cands if r.primary), cands[0])
                    for num, cands in candidates.items()
                }
            for num, r in targets.items():
                out.setdefault((r.node_id, name), []).append(num)
        return [(nid, idx, sorted(nums)) for (nid, idx), nums in
                sorted(out.items())]

    def search(self, index: str | None = None, body: dict | None = None,
               scroll: str | None = None,
               search_pipeline: str | None = None,
               ignore_unavailable: bool = False,
               request_cache: bool | None = None,
               query_group: str | None = None,
               allow_partial_search_results: bool = True) -> dict:
        from opensearch_tpu_torch.search.reduce import (
            check_cluster_aggs_supported,
            reduce_search_responses,
        )

        body = dict(body or {})
        if "pit" in body:
            return self._pit_search(body)
        if search_pipeline is not None:
            raise IllegalArgumentException(
                "search pipelines are not yet supported in cluster mode"
            )
        if "suggest" in body:
            raise IllegalArgumentException(
                "suggest is not yet supported in cluster mode"
            )
        query = body.get("query") or {}
        if "hybrid" in query:
            raise IllegalArgumentException(
                "hybrid queries are not yet supported in cluster mode"
            )
        aggs_body = body.get("aggs") or body.get("aggregations")
        check_cluster_aggs_supported(aggs_body)

        names = self.resolve_indices(index if index is not None else "_all")
        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        track_total = body.get("track_total_hits", True)
        keep = scroll is not None
        if keep and from_ > 0:
            raise IllegalArgumentException(
                "[from] is not allowed in a scroll context"
            )
        keep_alive_ms = (
            _parse_keep_alive_ms(scroll) if keep else None
        )

        node_body = dict(body)
        node_body["from"] = 0
        node_body["size"] = from_ + size
        node_body["track_total_hits"] = True  # coordinator applies the cap
        # wlm search admission BEFORE the fan-out (the bulk twin): an
        # enforced group past its slot share sheds a typed 429 here —
        # RejectedExecutionException surfaces through the REST envelope —
        # and burns no transport or device work
        release_admission = self.query_groups.admit_search(query_group)
        try:
            return self._search_fanned(
                names, body, node_body, size, from_, track_total, keep,
                keep_alive_ms, index, allow_partial_search_results)
        finally:
            release_admission()

    def _search_fanned(self, names, body, node_body, size, from_,
                       track_total, keep, keep_alive_ms, index,
                       allow_partial_search_results) -> dict:
        from opensearch_tpu_torch.search.reduce import reduce_search_responses

        from opensearch_tpu_torch.search import lanes as lanes_mod

        assignments = self._node_assignments(names, body)
        lane = lanes_mod.active_lane()
        from opensearch_tpu_torch.telemetry import tracing

        tracer = self.telemetry.tracer
        with tracing.activate(tracer), tracer.start_span(
            "search.coordinator",
            {"indices": ",".join(names), "node": self.node_name,
             "fanout": len(assignments)},
        ):
            # the per-node RPCs capture this span's context
            # (call_soon_threadsafe copies the executor thread's context)
            partials = self._rpc_many([
                (nid, "indices:data/read/search[node]",
                 {"index": idx, "shards": nums, "body": node_body,
                  "keep_context": keep, "keep_alive_ms": keep_alive_ms,
                  "lane": lane})
                for nid, idx, nums in assignments
            ])
            # residency stamps teach the coordinator's board which copies
            # are warm BEFORE the next fan-out routes (pop so the stamp
            # never reaches the reduce)
            for (nid, idx, _nums), p in zip(assignments, partials):
                if isinstance(p, dict):
                    res = p.pop("_residency", None)
                    if isinstance(res, dict) and res.get("field"):
                        self.node.residency_board.observe(
                            nid, idx, res["field"], bool(res.get("warm")))
            # a scroll must pin a context on EVERY node, so partial
            # tolerance only applies to plain searches
            if keep or not allow_partial_search_results:
                self._raise_partial_errors(partials)
            ok, failures = self._split_partials(assignments, partials)
            if failures and not ok:
                self._raise_partial_errors(partials)
            with tracer.start_span("search.reduce", {
                "node": self.node_name, "partials": len(ok),
            }):
                resp = reduce_search_responses(
                    body, [p for _a, p in ok], size=size, from_=from_,
                    track_total=track_total
                )
            if failures:
                # degrade, don't wedge: unreachable nodes' shards count as
                # failed (allow_partial_search_results=true semantics) and
                # the per-shard failure reasons ride along
                failed_shards = sum(len(nums) for (_n, _i, nums), _e
                                    in failures)
                resp["_shards"]["total"] += failed_shards
                resp["_shards"]["failed"] += failed_shards
                # one failures entry PER SHARD (the reference's shape),
                # so the list length matches the failed count
                resp["_shards"]["failures"] = [
                    {"node": nid, "index": idx, "shard": num,
                     "reason": {"reason": str(err)}}
                    for (nid, idx, nums), err in failures
                    for num in (nums or [-1])
                ]
            # same request metrics the single-node path records, so
            # /_prometheus/metrics is useful in cluster mode too; INSIDE
            # the coordinator span so the histogram exemplar captures this
            # trace id (a p99 bucket links straight to the trace)
            self.telemetry.metrics.counter("search.total").add(1)
            self.telemetry.metrics.histogram("search.took_ms").record(
                resp.get("took", 0))
            # per-index series under the same constant name (labels, not
            # names — TPU013; the registry bounds label cardinality)
            if index and "*" not in str(index) and "," not in str(index):
                self.telemetry.metrics.histogram(
                    "search.took_ms", labels={"index": str(index)},
                ).record(resp.get("took", 0))
            # per-LANE series (ISSUE 11): interactive vs background tails
            # separate under the same constant family name
            self.telemetry.metrics.histogram(
                "search.took_ms", labels={"lane": lane},
            ).record(resp.get("took", 0))
        if keep:
            contexts = {
                f"{nid}|{idx}": p["_ctx_id"]
                for (nid, idx, _nums), p in zip(assignments, partials)
            }
            seen = len(resp["hits"]["hits"])
            resp["_scroll_id"] = _encode_scroll_id({
                "ctx": contexts, "seen": seen, "size": size,
                "sort": body.get("sort"),
            })
        return resp

    @staticmethod
    def _raise_partial_errors(partials: list[dict]) -> None:
        for p in partials:
            if isinstance(p, dict) and "error" in p and "hits" not in p:
                raise rehydrate_error(p["error"])

    @staticmethod
    def _split_partials(
        assignments: list[tuple], partials: list[dict],
    ) -> tuple[list[tuple], list[tuple]]:
        """Partition per-node partials into (ok, failures): ok entries are
        (assignment, partial), failures are (assignment, error). Query-shape
        errors (parse failures — every node rejects identically) are raised
        immediately: degrading them to partial results would mask a client
        bug as a transient outage."""
        ok: list[tuple] = []
        failures: list[tuple] = []
        for a, p in zip(assignments, partials):
            if isinstance(p, dict) and "error" in p and "hits" not in p:
                err = rehydrate_error(p["error"])
                if isinstance(err, (IllegalArgumentException,)) or \
                        "ParsingException" in str(p["error"]):
                    raise err
                failures.append((a, err))
            else:
                ok.append((a, p))
        return ok, failures

    def scroll(self, scroll_id: str, scroll: str | None = None) -> dict:
        from opensearch_tpu_torch.search.reduce import reduce_hits

        state = _decode_scroll_id(scroll_id)
        seen, size = state["seen"], state["size"]
        calls = []
        for key, ctx_id in state["ctx"].items():
            nid, _, idx = key.partition("|")
            calls.append((nid, "indices:data/read/search[ctx]",
                          {"ctx_id": ctx_id, "from": 0,
                           "size": seen + size}))
        partials = self._rpc_many(calls)
        self._raise_partial_errors(partials)
        sort = state.get("sort")
        if isinstance(sort, (str, dict)):
            sort = [sort]
        hits_obj = reduce_hits(partials, size=size, from_=seen, sort=sort,
                               track_total=True)
        state["seen"] = seen + len(hits_obj["hits"])
        shards_total = sum(
            (p.get("_shards") or {}).get("total", 0) for p in partials
        )
        return {
            "took": 0, "timed_out": False,
            "_shards": {"total": shards_total, "successful": shards_total,
                        "skipped": 0, "failed": 0},
            "hits": hits_obj,
            "_scroll_id": _encode_scroll_id(state),
        }

    def clear_scroll(self, scroll_ids: list[str] | None) -> dict:
        freed = 0
        for sid in scroll_ids or []:
            try:
                state = _decode_scroll_id(sid)
            except Exception as e:  # noqa: BLE001 - malformed id: skip
                logger.debug("clear_scroll: malformed scroll id: %s", e)
                continue
            by_node: dict[str, list[str]] = {}
            for key, ctx_id in state["ctx"].items():
                nid = key.partition("|")[0]
                by_node.setdefault(nid, []).append(ctx_id)
            results = self._rpc_many([
                (nid, "indices:data/read/ctx_close", {"ctx_ids": ids})
                for nid, ids in by_node.items()
            ])
            freed += sum(r.get("freed", 0) for r in results
                         if isinstance(r, dict))
        return {"succeeded": True, "num_freed": freed}

    def open_pit(self, index: str, keep_alive: str) -> dict:
        names = self.resolve_indices(index)
        assignments = self._node_assignments(names)
        partials = self._rpc_many([
            (nid, "indices:data/read/search[node]",
             {"index": idx, "shards": nums,
              "body": {"query": {"match_all": {}}, "size": 0},
              "keep_context": True,
              "keep_alive_ms": _parse_keep_alive_ms(keep_alive)})
            for nid, idx, nums in assignments
        ])
        self._raise_partial_errors(partials)
        contexts = {
            f"{nid}|{idx}": p["_ctx_id"]
            for (nid, idx, _nums), p in zip(assignments, partials)
        }
        total = sum((p.get("_shards") or {}).get("total", 0)
                    for p in partials)
        pit_id = "cpit_" + _encode_scroll_id({"ctx": contexts})
        from opensearch_tpu_torch.common.timeutil import epoch_millis

        return {"pit_id": pit_id,
                "_shards": {"total": total, "successful": total,
                            "skipped": 0, "failed": 0},
                "creation_time": epoch_millis()}

    def close_pit(self, pit_ids: list[str] | None) -> dict:
        pits = []
        for pid in pit_ids or []:
            ok = True
            try:
                state = _decode_scroll_id(pid.removeprefix("cpit_"))
                by_node: dict[str, list[str]] = {}
                for key, ctx_id in state["ctx"].items():
                    by_node.setdefault(key.partition("|")[0], []).append(ctx_id)
                self._rpc_many([
                    (nid, "indices:data/read/ctx_close", {"ctx_ids": ids})
                    for nid, ids in by_node.items()
                ])
            except Exception as e:  # noqa: BLE001
                logger.debug("delete_pit: context close failed: %s", e)
                ok = False
            pits.append({"pit_id": pid, "successful": ok})
        return {"pits": pits}

    def _pit_search(self, body: dict) -> dict:
        from opensearch_tpu_torch.search.reduce import reduce_search_responses

        pit = body.pop("pit")
        pit_id = pit["id"] if isinstance(pit, dict) else pit
        state = _decode_scroll_id(str(pit_id).removeprefix("cpit_"))
        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        track_total = body.get("track_total_hits", True)
        node_body = dict(body)
        node_body["from"] = 0
        node_body["size"] = from_ + size
        node_body["track_total_hits"] = True
        calls = [
            (key.partition("|")[0], "indices:data/read/search[ctx]",
             {"ctx_id": ctx_id, "body": node_body})
            for key, ctx_id in state["ctx"].items()
        ]
        partials = self._rpc_many(calls)
        self._raise_partial_errors(partials)
        resp = reduce_search_responses(
            body, partials, size=size, from_=from_, track_total=track_total
        )
        resp["pit_id"] = pit_id
        return resp

    def msearch(self, searches: list[tuple[dict, dict]]) -> dict:
        """Runs of consecutive bare-knn sub-searches against the SAME index
        ship to each data node as ONE msearch[node] RPC, whose query phase
        is a single batched device dispatch (B query vectors in one program
        launch); everything else fans out per sub-search like the
        reference's TransportMultiSearchAction."""
        from opensearch_tpu_torch.search.service import msearch_groups

        responses: list[dict | None] = [None] * len(searches)
        for group in msearch_groups(searches):
            index = searches[group[0]][0].get("index")
            grouped = None
            if len(group) > 1:
                grouped = self._msearch_knn_group(
                    index, [searches[g][1] for g in group]
                )
            if grouped is not None:
                for g, resp in zip(group, grouped):
                    responses[g] = resp
                continue
            # whole group serial (each member still eligible for the
            # single-query device path on its data node)
            for g in group:
                try:
                    responses[g] = self.search(
                        searches[g][0].get("index"), searches[g][1])
                except OpenSearchTpuException as e:
                    responses[g] = {"error": e.to_dict(), "status": e.status}
        return {"took": 0, "responses": responses}

    def _msearch_knn_group(
        self, index: str, bodies: list[dict]
    ) -> list[dict] | None:
        """One msearch[node] RPC per data node for a batchable knn group;
        reduce each body's partials exactly like search(). Returns None to
        send the group down the serial path (e.g. resolution errors)."""
        from opensearch_tpu_torch.search.reduce import reduce_search_responses

        try:
            names = self.resolve_indices(index)
            # residency routing sees the first body (the group shares one
            # knn field); msearch fan-outs are background-lane work
            assignments = self._node_assignments(names, bodies[0])
            node_bodies = []
            for body in bodies:
                nb = dict(body)
                nb["from"] = 0
                nb["size"] = int(body.get("from", 0)) + int(body.get("size", 10))
                nb["track_total_hits"] = True
                node_bodies.append(nb)
            from opensearch_tpu_torch.search import lanes as lanes_mod

            partials_per_node = self._rpc_many([
                (nid, "indices:data/read/msearch[node]",
                 {"index": idx, "shards": nums, "bodies": node_bodies,
                  "lane": lanes_mod.BACKGROUND})
                for nid, idx, nums in assignments
            ])
        except OpenSearchTpuException:
            return None
        out = []
        for bi, body in enumerate(bodies):
            body_partials = []
            for node_resp in partials_per_node:
                if not isinstance(node_resp, dict) or "responses" not in node_resp:
                    body_partials.append(node_resp)  # transport-level error
                else:
                    body_partials.append(node_resp["responses"][bi])
            try:
                self._raise_partial_errors(body_partials)
                out.append(reduce_search_responses(
                    body, body_partials,
                    size=int(body.get("size", 10)),
                    from_=int(body.get("from", 0)),
                    track_total=body.get("track_total_hits", True),
                ))
            except OpenSearchTpuException as e:
                out.append({"error": e.to_dict(), "status": e.status})
        return out

    def count(self, index: str, body: dict | None = None) -> dict:
        body = dict(body or {})
        body["size"] = 0
        resp = self.search(index, body)
        return {"count": resp["hits"]["total"]["value"],
                "_shards": resp["_shards"]}

    # ------------------------------------------------------------------ #
    # maintenance
    # ------------------------------------------------------------------ #

    def refresh(self, index: str = "_all") -> dict:
        total = {"total": 0, "successful": 0, "failed": 0}
        for name in self.resolve_indices(index):
            resp = self._on_loop(lambda cb, n=name: self.node.refresh(n, cb))
            for k in total:
                total[k] += resp.get("_shards", {}).get(k, 0)
        return {"_shards": total}

    def flush(self, index: str = "_all") -> dict:
        names = self.resolve_indices(index)  # raises on missing indices
        nodes = sorted(self.state.nodes)
        results = self._rpc_many([
            (nid, "indices:admin/flush[node]", {"indices": names})
            for nid in nodes
        ])
        ok = sum(1 for r in results
                 if isinstance(r, dict) and r.get("ack"))
        return {"_shards": {"total": len(nodes), "successful": ok,
                            "failed": len(nodes) - ok}}

    def force_merge(self, index: str = "_all", max_num_segments: int = 1,
                    only_expunge_deletes: bool = False,
                    flush: bool = True) -> dict:
        names = self.resolve_indices(index)
        nodes = sorted(self.state.nodes)
        results = self._rpc_many([
            (nid, "indices:admin/forcemerge[node]",
             {"indices": names, "max_num_segments": max_num_segments})
            for nid in nodes
        ])
        ok = sum(1 for r in results
                 if isinstance(r, dict) and r.get("ack"))
        return {"_shards": {"total": len(nodes), "successful": ok,
                            "failed": len(nodes) - ok}}

    # ------------------------------------------------------------------ #
    # cluster / stats
    # ------------------------------------------------------------------ #

    def cluster_health(self, index: str | None = None,
                       level: str = "cluster",
                       expand_wildcards: str = "all") -> dict:
        return self.node.cluster_health()

    def put_cluster_settings(self, body: dict, *, flat: bool = False) -> dict:
        from opensearch_tpu_torch.cluster.cluster_settings import flatten, merge

        resp = self._rpc(self._leader(), "cluster:admin/settings/update",
                         body or {})
        # echo the EFFECTIVE sections in the same shape as the single-node
        # path (the leader ack carries only the update maps; the merged
        # result is current state + this update)
        state = self.state
        persistent = merge(state.settings,
                           flatten((body or {}).get("persistent") or {}))
        transient = merge(state.transient_settings,
                          flatten((body or {}).get("transient") or {}))
        return {
            "acknowledged": bool(resp.get("acknowledged", True)),
            "persistent": _settings_section(persistent, flat),
            "transient": _settings_section(transient, flat),
        }

    def cluster_state(self, metrics: list[str] | None = None,
                      index: str | None = None,
                      expand_wildcards: str = "all",
                      ignore_unavailable: bool = False,
                      allow_no_indices: bool = True) -> dict:
        """GET /_cluster/state rendered from the REAL replicated cluster
        state (nodes, routing table, index metadata) instead of the
        single-node projection."""
        want = set(metrics or ["_all"])
        everything = "_all" in want

        def on(metric: str) -> bool:
            return everything or metric in want

        state = self.state
        names = (self.resolve_indices(index) if index
                 else sorted(state.indices))
        leader = state.leader_id or self.node.coordinator.leader_id
        out: dict[str, Any] = {
            "cluster_name": "opensearch-tpu",
            "cluster_uuid": state.cluster_uuid,
            "state_uuid": f"state-{state.term}-{state.version}",
        }
        if on("version"):
            out["version"] = state.version
        if on("master_node"):
            out["master_node"] = leader
        if on("cluster_manager_node"):
            out["cluster_manager_node"] = leader
        if on("nodes"):
            out["nodes"] = {
                nid: {"name": n.name or nid,
                      "transport_address": n.address,
                      "attributes": dict(n.attrs)}
                for nid, n in state.nodes.items()
            }
        if on("blocks"):
            out["blocks"] = {}
        if on("metadata"):
            out["metadata"] = {
                "cluster_coordination": {
                    "term": state.term,
                    "last_committed_config":
                        sorted(state.last_committed_config.node_ids),
                    "last_accepted_config":
                        sorted(state.last_accepted_config.node_ids),
                    "voting_config_exclusions":
                        list(getattr(self, "_voting_exclusions", [])),
                },
                "indices": {
                    name: {
                        "state": "open",
                        "settings": {"index": dict(
                            state.indices[name].settings or {})},
                        "mappings": state.indices[name].mappings or {},
                    }
                    for name in names
                },
            }
        if on("routing_table"):
            table: dict[str, Any] = {}
            for name in names:
                shards: dict[str, list] = {}
                for r in state.routing_for_index(name):
                    shards.setdefault(str(r.shard), []).append({
                        "state": r.state, "primary": r.primary,
                        "node": r.node_id,
                        "relocating_node": r.relocating_node,
                        "shard": r.shard, "index": r.index,
                    })
                table[name] = {"shards": shards}
            out["routing_table"] = {"indices": table}
        if on("routing_nodes"):
            assigned: dict[str, list] = {nid: [] for nid in state.nodes}
            unassigned = []
            for r in state.routing:
                entry = {"state": r.state, "primary": r.primary,
                         "node": r.node_id,
                         "relocating_node": r.relocating_node,
                         "shard": r.shard, "index": r.index}
                if r.node_id is None:
                    unassigned.append(entry)
                else:
                    assigned.setdefault(r.node_id, []).append(entry)
            out["routing_nodes"] = {"unassigned": unassigned,
                                    "nodes": assigned}
        return out

    def pending_cluster_tasks(self) -> dict:
        return {"tasks": []}

    def add_voting_config_exclusions(self, node_ids: str | None = None,
                                     node_names: str | None = None) -> dict:
        provided = [p for p in (node_ids, node_names) if p]
        if len(provided) != 1:
            raise IllegalArgumentException(
                "Please set node identifiers correctly. One and only one "
                "of [node_name], [node_names] and [node_ids] has to be set"
            )
        if not hasattr(self, "_voting_exclusions"):
            self._voting_exclusions = []
        if node_ids:
            entries = [{"node_id": nid.strip(), "node_name": "_absent_"}
                       for nid in str(node_ids).split(",") if nid.strip()]
        else:
            entries = [{"node_id": "_absent_", "node_name": nm.strip()}
                       for nm in str(node_names).split(",") if nm.strip()]
        for e in entries:
            if e not in self._voting_exclusions:
                self._voting_exclusions.append(e)
        return {}

    def clear_voting_config_exclusions(self) -> dict:
        self._voting_exclusions = []
        return {}

    def cluster_reroute(self, body: dict | None, *, explain: bool = False,
                        dry_run: bool = False,
                        metrics: list[str] | None = None) -> dict:
        default_metrics = ["version", "master_node", "cluster_manager_node",
                           "nodes", "routing_table", "routing_nodes",
                           "blocks"]
        state = self.cluster_state(metrics=metrics or default_metrics)
        state.pop("cluster_name", None)
        out: dict[str, Any] = {"acknowledged": True, "state": state}
        if explain or (body or {}).get("commands") is not None:
            out["explanations"] = []
        return out

    def allocation_explain(self, body: dict | None,
                           include_disk_info: bool = False) -> dict:
        body = body or {}
        state = self.state
        index = body.get("index")
        if index is not None:
            shard = int(body.get("shard", 0))
            primary = bool(body.get("primary", False))
            entry = next(
                (r for r in state.routing_for_index(index)
                 if r.shard == shard and r.primary == primary), None)
        else:
            entry = next((r for r in state.routing if r.node_id is None),
                         None)
            if entry is None:
                raise IllegalArgumentException(
                    "unable to find any unassigned shards to explain "
                    "[ClusterAllocationExplainRequest["
                    "useAnyUnassignedShard=true]"
                )
        if entry is None:
            raise IllegalArgumentException(
                f"cannot find shard [{body.get('index')}][{body.get('shard')}]"
            )
        out: dict[str, Any] = {
            "index": entry.index,
            "shard": entry.shard,
            "primary": entry.primary,
            "current_state": entry.state.lower(),
        }
        if entry.node_id is not None:
            n = state.nodes.get(entry.node_id)
            out["current_node"] = {
                "id": entry.node_id,
                "name": (n.name or entry.node_id) if n else entry.node_id,
            }
            out["can_remain_on_current_node"] = "yes"
            out["can_rebalance_cluster"] = "yes"
            out["can_rebalance_to_other_node"] = "no"
            out["rebalance_explanation"] = (
                "cannot rebalance as no target node exists that can both "
                "allocate this shard and improve the cluster balance")
        else:
            out["can_allocate"] = "no"
            out["allocate_explanation"] = (
                "cannot allocate because allocation is not permitted to "
                "any of the nodes")
        return out

    def list_all_pits(self) -> dict:
        # cluster PIT ids are stateless {node -> ctx} encodings; there is
        # no central registry to enumerate (reader contexts live on the
        # data nodes and expire there)
        return {"pits": []}

    def get_cluster_settings(self, *, flat: bool = False,
                             include_defaults: bool = False) -> dict:
        from opensearch_tpu_torch.node import TorchNode

        state = self.state

        def view(flat_map: dict) -> dict:
            out = {k: setting_str(v) for k, v in flat_map.items()}
            return out if flat else Settings.from_flat(out).as_nested()

        out = {"persistent": view(state.settings),
               "transient": view(state.transient_settings)}
        if include_defaults:
            out["defaults"] = view({
                k: v for k, v in TorchNode._CLUSTER_SETTING_DEFAULTS.items()
                if k not in state.settings
                and k not in state.transient_settings})
        return out

    def cluster_nodes_stats(self, metrics: list[str] | None = None) -> dict:
        """Cluster-wide `_nodes/stats`: ONE fan-out RPC per node
        (TransportNodesStatsAction), merging every node's telemetry ring,
        exporter accounting, kNN-batch stats, shard-mesh stats and
        registered extras (request cache) into one response. A node that
        fails to answer counts in `_nodes.failed` instead of failing the
        whole call — stats must work mid-chaos. A metric filter narrows
        the RPC payload via the same `sections` mechanism the federated
        Prometheus scrape uses — `_nodes/stats/knn_batch` must not ship
        every node's span ring over the transport just to discard it."""
        payload: dict[str, Any] = {"full": True}
        if metrics and "_all" not in metrics:
            section_of = {"telemetry": "spans", "knn_batch": "knn_batch",
                          "indices": "providers", "device": "device",
                          "tail": "tail", "roofline": "roofline",
                          "heat": "heat"}
            payload["sections"] = sorted(
                {section_of[m] for m in metrics if m in section_of})
        nodes = sorted(self.state.nodes)
        results = self._rpc_many([
            (nid, "indices:monitor/stats[node]", dict(payload))
            for nid in nodes
        ])
        entries: dict[str, dict] = {}
        failed = 0
        for nid, r in zip(nodes, results):
            if not isinstance(r, dict) or set(r) <= {"error", "status"}:
                failed += 1
                continue
            # piggybacked residency advertisement (ISSUE 15): every stats
            # fan-out refreshes the coordinator's warm-copy board for free
            self.node._observe_residency(nid, r)
            entries[nid] = {
                "name": r.get("name", nid),
                "roles": ["cluster_manager", "data"],
                "telemetry": r.get("telemetry", {}),
                "knn_batch": r.get("knn_batch", {}),
                "shard_mesh": r.get("shard_mesh", {}),
                "device": r.get("device", {}),
                "tail": r.get("tail", {}),
                "roofline": r.get("roofline", {}),
                "heat": r.get("heat", {}),
                "indices": {
                    "request_cache": r.get("request_cache", {}),
                },
                "shards": r.get("shards", {}),
            }
        return {
            "_nodes": {"total": len(nodes), "successful": len(entries),
                       "failed": failed},
            "cluster_name": "opensearch-tpu",
            "nodes": entries,
        }

    def cluster_metrics(self) -> dict[str, dict]:
        """Per-node metrics registries (counters + exemplar-carrying
        histograms) for the federated `/_prometheus/metrics?cluster=true`
        view: node id -> MetricsRegistry.stats() shape. Scrapes recur
        every few seconds, so the fan-out asks each node for its metrics
        SECTION only — no span ring, exporter ledger, batcher or provider
        payloads ride the transport just to be discarded here."""
        nodes = sorted(self.state.nodes)
        results = self._rpc_many([
            (nid, "indices:monitor/stats[node]",
             {"full": True,
              "sections": ["metrics", "device_totals", "roofline",
                           "heat"]})
            for nid in nodes
        ])
        out: dict[str, dict] = {}
        for nid, r in zip(nodes, results):
            if not isinstance(r, dict) or set(r) <= {"error", "status"}:
                continue
            tel = r.get("telemetry", {})
            out[nid] = {"counters": tel.get("counters", {}),
                        "histograms": tel.get("histograms", {}),
                        # per-device resident-byte totals: the federated
                        # exposition renders them as labeled gauges
                        "device": r.get("device_totals", {}),
                        # per-family roofline fractions/FLOP/s, rendered
                        # as {family=,node=}-labeled gauges
                        "roofline": r.get("roofline", {}),
                        # per-structure heat classes, rendered as
                        # {kind=,index=,node=}-labeled gauges
                        "heat": r.get("heat", {})}
        return out

    def cluster_otel_flush(self) -> dict:
        """`POST /_otel/flush`: force every node's span exporter to decide
        and drain, and collect each node's exporter ledger + device-memory
        snapshot. Nodes that fail to answer count in `_nodes.failed` —
        the flush must work mid-chaos, like stats."""
        nodes = sorted(self.state.nodes)
        results = self._rpc_many([
            (nid, "cluster:admin/otel/flush[node]", {}) for nid in nodes
        ])
        entries: dict[str, dict] = {}
        failed = 0
        for nid, r in zip(nodes, results):
            if not isinstance(r, dict) or set(r) <= {"error", "status"}:
                failed += 1
                continue
            entries[nid] = r
        return {
            "_nodes": {"total": len(nodes), "successful": len(entries),
                       "failed": failed},
            "cluster_name": "opensearch-tpu",
            "nodes": entries,
        }

    def _all_shard_stats(self) -> dict[str, dict]:
        nodes = sorted(self.state.nodes)
        results = self._rpc_many([
            (nid, "indices:monitor/stats[node]", {}) for nid in nodes
        ])
        out: dict[str, dict] = {}
        for nid, r in zip(nodes, results):
            if isinstance(r, dict):
                # piggybacked residency advertisement (ISSUE 15)
                self.node._observe_residency(nid, r)
                for key, s in (r.get("shards") or {}).items():
                    if s.get("primary") or key not in out:
                        out[key] = s
        return out

    def cat_index_summary(self) -> dict[str, dict]:
        """_cat/indices' cluster columns of each index: its health from
        the routing table (by cluster_health's rule, ``routing_health``),
        its docs from the primaries' shard stats, and its store bytes from
        every copy's (``store``) and the primaries' (``pri_store``)."""
        state = self.state
        out: dict[str, dict] = {
            name: {"health": routing_health(state.shards_for_index(name)),
                   "docs": 0, "store": 0, "pri_store": 0}
            for name in state.indices}
        nodes = sorted(state.nodes)
        results = self._rpc_many([
            (nid, "indices:monitor/stats[node]", {"store": True})
            for nid in nodes])
        for r in results:
            if not isinstance(r, dict):
                continue
            for s in (r.get("shards") or {}).values():
                row = out.get(s["index"])
                if row is None:
                    continue
                row["store"] += s.get("store_bytes", 0)
                if s.get("primary"):
                    row["docs"] += s["docs"]
                    row["pri_store"] += s.get("store_bytes", 0)
        return out

    def index_stats(self, index: str = "_all", **_kw) -> dict:
        # the cluster facade reports the docs core; metric filtering and
        # per-section detail are the single-node TorchNode.index_stats's
        names = self.resolve_indices(index)
        shard_stats = self._all_shard_stats()
        per_index: dict[str, int] = {}
        for s in shard_stats.values():
            if s.get("primary"):
                per_index[s["index"]] = per_index.get(s["index"], 0) + s["docs"]
        total = sum(per_index.get(n, 0) for n in names)
        out = {
            "_all": {"primaries": {"docs": {"count": total}},
                     "total": {"docs": {"count": total}}},
            "indices": {
                n: {"primaries": {"docs": {"count": per_index.get(n, 0)}}}
                for n in names
            },
        }
        return out

    def field_caps(self, index: str | None, fields: str,
                   include_unmapped: bool = False,
                   index_filter: dict | None = None) -> dict:
        """Cluster field_caps over the replicated index metadata (the
        shared merge in node.build_field_caps — mappings are in the
        cluster state, so no per-node fan-out is needed; index_filter
        falls back to a cluster count per index)."""
        from opensearch_tpu_torch.node import build_field_caps

        names = self.resolve_indices(index if index is not None else "_all")
        patterns = [p.strip() for p in str(fields or "").split(",")
                    if p.strip()]
        if not patterns:
            raise IllegalArgumentException("[field_caps] requires [fields]")
        if index_filter:
            names = [
                name for name in names
                if self.count(name, {"query": index_filter}).get("count", 0)
            ]
        return build_field_caps(names, self._mapper_for, patterns,
                                include_unmapped=include_unmapped)

    def recovery_records(self, index: str | None = None) -> list[dict]:
        """Cluster-wide recovery progress (RecoveryState collection behind
        GET [/{index}]/_recovery and _cat/recovery): every node reports its
        target-side records; peer recoveries, relocation transfers and
        local store bootstraps all appear with live stage/bytes/ops."""
        names = self.resolve_indices(index) if index else None
        nodes = sorted(self.state.nodes)
        results = self._rpc_many([
            (nid, "indices:monitor/recovery[node]", {"indices": names})
            for nid in nodes
        ])
        out: list[dict] = []
        for r in results:
            if isinstance(r, dict):
                out.extend(r.get("recoveries") or [])
        return sorted(
            out, key=lambda p: (p["index"], p["shard"],
                                str(p.get("target_node")))
        )

    # unsupported-surface markers (clear 400s beat silent wrong answers)

    _UNSUPPORTED_SERVICES = {
        "ingest", "snapshots", "search_pipelines", "script",
        "indexing_pressure", "search_backpressure", "search_slowlog",
        "indexing_slowlog", "reindex",
    }

    # -- node-local stored scripts + search templates ------------------- #

    def _scripts_file(self):
        return self.node.data_path / "stored_scripts.json"

    def _load_scripts(self) -> dict:
        if self._scripts_file().exists():
            return json.loads(self._scripts_file().read_text())
        return {}

    def put_stored_script(self, script_id: str, body: dict) -> dict:
        script = (body or {}).get("script")
        if not isinstance(script, dict) or "source" not in script:
            raise IllegalArgumentException(
                "stored script requires [script] with [source]"
            )
        data = self._load_scripts()
        data[script_id] = {"lang": script.get("lang", "painless"),
                           "source": script["source"]}
        self._scripts_file().parent.mkdir(parents=True, exist_ok=True)
        self._scripts_file().write_text(json.dumps(data))
        return {"acknowledged": True}

    def get_stored_script(self, script_id: str) -> dict:
        data = self._load_scripts()
        if script_id not in data:
            return {"_id": script_id, "found": False}
        return {"_id": script_id, "found": True, "script": data[script_id]}

    def delete_stored_script(self, script_id: str) -> dict:
        from opensearch_tpu_torch.common.errors import ResourceNotFoundException

        data = self._load_scripts()
        if script_id not in data:
            raise ResourceNotFoundException(
                f"stored script [{script_id}] does not exist"
            )
        del data[script_id]
        self._scripts_file().write_text(json.dumps(data))
        return {"acknowledged": True}

    def render_search_template(self, body: dict,
                               template_id: str | None = None) -> dict:
        from opensearch_tpu_torch.common.errors import ResourceNotFoundException
        from opensearch_tpu_torch.script.mustache import render_search_template

        body = body or {}
        source = body.get("source")
        sid = template_id or body.get("id")
        if source is None and sid is not None:
            stored = self.get_stored_script(str(sid))
            if not stored.get("found"):
                raise ResourceNotFoundException(
                    f"search template [{sid}] does not exist"
                )
            source = stored["script"]["source"]
        if source is None:
            raise IllegalArgumentException(
                "search template requires [source] or [id]"
            )
        return render_search_template(source, body.get("params"))

    def search_template(self, index: str | None, body: dict,
                        template_id: str | None = None, **kwargs) -> dict:
        rendered = self.render_search_template(body, template_id)
        return self.search(index, rendered, **kwargs)

    def _unsupported(self, what: str):
        raise IllegalArgumentException(
            f"{what} is not yet supported in cluster mode"
        )

    def __getattr__(self, name: str):
        if name in self._UNSUPPORTED_SERVICES:
            # handlers dereference these services directly; a clear 400
            # beats an opaque AttributeError 500
            self._unsupported(f"[{name}]")
        # attributes probed via getattr(..., default) (breakers, telemetry)
        # must keep AttributeError semantics
        raise AttributeError(name)


def _encode_scroll_id(state: dict) -> str:
    return base64.urlsafe_b64encode(
        json.dumps(state, separators=(",", ":")).encode()
    ).decode()


def _decode_scroll_id(scroll_id: str) -> dict:
    try:
        return json.loads(base64.urlsafe_b64decode(scroll_id.encode()))
    except Exception as e:  # noqa: BLE001
        raise SearchContextMissingException(
            f"malformed scroll id [{scroll_id[:32]}...]"
        ) from e


def _parse_keep_alive_ms(value: str | None) -> int:
    from opensearch_tpu_torch.common.settings import parse_time_millis

    if value is None:
        return 60_000
    return int(parse_time_millis(value))


def _deep_merge(base: dict, overlay: dict) -> dict:
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out
