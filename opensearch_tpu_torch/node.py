"""TorchNode: a single search node of the PyTorch port.

Counterpart of opensearch_tpu/node.py's ``TpuNode``, for the slice ported
so far: the index lifecycle (``create_index``, ``delete_index``,
``get_mapping``, ``get_settings``, ``resolve_indices``), single-document
and bulk writes (``index_doc``, ``get_doc``, ``delete_doc``,
``update_doc`` with a partial ``doc``, ``doc_as_upsert``, ``upsert``,
``detect_noop``, a painless ``script`` and ``scripted_upsert``; ``bulk``
with index, create, update and delete), ``refresh``, ``search`` (the
whole query DSL with sort, search_after, rescore, collapse, named
queries, the fetch options, ``script_fields``, ``suggest`` and ``slice``;
a ``more_like_this`` doc reference resolved to its text first; the
``search_pipeline`` parameter, a body key of that name or the index's
``search.default_pipeline`` applying a search pipeline's request and
response processors and fusing a ``hybrid`` query), stored scripts
(``put_stored_script``, ``get_stored_script``, ``delete_stored_script``,
kept in the data path's ``stored_scripts.json``) and search templates
(``render_search_template``, ``search_template``), the search pipelines
of ``search_pipelines`` (search/pipeline.py), ``count``,
``msearch`` (runs of bare kNN bodies in one stacked launch),
``cluster_health`` and ``close``. Every shard publishes its segments to the
node's device; searches run the stacked serving step on it
(search/distributed_serving.py), or the per-shard route, whose launches
coalesce across concurrent searches in ``knn_batcher``
(search/batcher.py).

Telemetry (telemetry/): each node has its own ``telemetry`` (a tracer and
a metrics registry; every search is one ``search`` span with the
``search.total`` / ``search.took_ms`` metrics), a search and an indexing
slow log configured from the indices' ``search.slowlog`` /
``indexing.slowlog`` thresholds, and is the metrics sink of the
process-wide batcher, shard-mesh registry and roofline recorder, whose
peaks it calibrates on its device at construction.
:meth:`TorchNode.apply_dynamic_settings` applies the shard-mesh budget
and the heat settings from a flat settings map (the ``_cluster/settings``
API is not ported yet).

Still raising "not yet ported": wildcard index expressions, aliases,
ingest pipelines, scroll and point-in-time reads.

The device is the card unless the caller asks for the CPU::

    node = TorchNode(path)                 # CUDA; raises without a card
    node = TorchNode(path, device="cpu")   # the CPU, as the tests run it
"""

from __future__ import annotations

import base64
import copy
import difflib
import json
import os
import shutil
import time
import uuid
from pathlib import Path
from typing import Any

import torch

from opensearch_tpu_torch import backend
from opensearch_tpu_torch.cluster import shard_mesh
from opensearch_tpu_torch.common.errors import (
    ActionRequestValidationException,
    DocumentMissingException,
    IllegalArgumentException,
    IndexNotFoundException,
    OpenSearchTpuException,
    ParsingException,
    ResourceAlreadyExistsException,
    ResourceNotFoundException,
    VersionConflictException,
)
from opensearch_tpu_torch.common.hashing import shard_id_for_routing
from opensearch_tpu_torch.common.settings import (
    Settings,
    setting_str,
    settings_section,
)
from opensearch_tpu_torch.index.analysis import AnalysisRegistry
from opensearch_tpu_torch.index.mapper import MapperService
from opensearch_tpu_torch.index.shard import IndexShard, ShardId, translog_durability
from opensearch_tpu_torch.search import batcher
from opensearch_tpu_torch.search import service as search_service
from opensearch_tpu_torch.search.distributed_serving import not_yet_ported
from opensearch_tpu_torch.search.fetch import _flatten_source
from opensearch_tpu_torch.search.pipeline import SearchPipelineService

# ASCII, not starting with _ - + (MetadataCreateIndexService.validateIndexName)
_INVALID_INDEX_CHARS = set(' "*\\<>|,/?#:')

# defaults surfaced by ?include_defaults (IndexScopedSettings defaults)
INDEX_SETTING_DEFAULTS = {
    "index.refresh_interval": "1s",
    "index.max_result_window": "10000",
    "index.max_inner_result_window": "100",
    "index.max_rescore_window": "10000",
    "index.max_docvalue_fields_search": "100",
    "index.max_script_fields": "32",
    "index.max_ngram_diff": "1",
    "index.max_shingle_diff": "3",
    "index.max_terms_count": "65536",
    "index.requests.cache.enable": "true",
    "index.translog.durability": "REQUEST",
    "index.translog.flush_threshold_size": "512mb",
}


def _valid_index_name(name: str) -> bool:
    if not name or name in (".", ".."):
        return False
    if any(c in _INVALID_INDEX_CHARS for c in name):
        return False
    if any("A" <= c <= "Z" for c in name):
        return False
    return not name.startswith(("_", "-", "+"))


def _has_wildcard(part: str) -> bool:
    return "*" in part or "?" in part


def index_settings_entry(raw_settings: dict, *, num_shards: int,
                         num_replicas: int, name: str | None = None,
                         flat: bool = False, include_defaults: bool = False,
                         extra: dict | None = None) -> dict:
    """One index's GET _settings entry: values stringified, `name` filters
    by flat dotted key (wildcards OK), flat vs nested, and the defaults
    section."""
    import fnmatch

    patterns = None
    if name and name not in ("_all", "*"):
        patterns = [p.strip() for p in str(name).split(",") if p.strip()]

    def select(flat_map: dict) -> dict:
        if patterns is None:
            return flat_map
        return {k: v for k, v in flat_map.items()
                if any(fnmatch.fnmatch(k, p) for p in patterns)}

    norm: dict[str, Any] = {}
    for k, v in Settings.from_nested(raw_settings or {}).as_dict().items():
        key = k if k.startswith("index.") else f"index.{k}"
        norm[key] = setting_str(v)
    norm["index.number_of_shards"] = str(num_shards)
    norm["index.number_of_replicas"] = str(num_replicas)
    norm.update(extra or {})
    entry = {"settings": settings_section(select(norm), flat)}
    if include_defaults:
        defaults = {k: v for k, v in INDEX_SETTING_DEFAULTS.items()
                    if k not in norm}
        entry["defaults"] = settings_section(select(defaults), flat)
    return entry


def _deep_merge(base: dict, overlay: dict) -> dict:
    """Recursive dict merge, overlay wins (a partial update's doc)."""
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


class IndexService:
    """Per-index container (index module + its shards)."""

    def __init__(self, name: str, path: Path, settings: dict,
                 mappings: dict | None, device: torch.device):
        self.name = name
        self.path = path
        self.settings = settings
        analysis = AnalysisRegistry.from_index_settings(
            (settings.get("analysis")
             if isinstance(settings.get("analysis"), dict) else None)
        )
        self.mapper_service = MapperService(mappings, analysis)
        self.num_shards = int(settings.get("number_of_shards", 1))
        self.num_replicas = int(settings.get("number_of_replicas", 1))
        self.creation_date = int(time.time() * 1000)
        # index UUID (IndexMetadata.INDEX_UUID): 22-char url-safe base64
        self.uuid = base64.urlsafe_b64encode(os.urandom(16)).decode()[:22]
        durability = translog_durability(settings)
        self.shards: dict[int, IndexShard] = {
            s: IndexShard(ShardId(name, s), path / str(s),
                          self.mapper_service, durability=durability,
                          device=device)
            for s in range(self.num_shards)
        }

    def shard_for(self, doc_id: str, routing: str | None) -> IndexShard:
        return self.shards[shard_id_for_routing(routing or doc_id,
                                                self.num_shards)]

    def close(self) -> None:
        for shard in self.shards.values():
            shard.close()


class TorchNode:
    def __init__(self, data_path: str | Path,
                 device: torch.device | str = "cuda",
                 node_name: str = "node-0"):
        self.device = backend.resolve_device(device)
        self.data_path = Path(data_path)
        self.node_name = node_name
        self.indices: dict[str, IndexService] = {}
        from opensearch_tpu_torch.telemetry import roofline
        from opensearch_tpu_torch.telemetry.slowlog import SlowLog
        from opensearch_tpu_torch.telemetry.tracing import Telemetry

        self.telemetry = Telemetry()  # per node: metrics must not leak
        # the process-wide kNN dispatch batcher the per-shard route uses;
        # the last-constructed node is its fallback metrics sink (a search
        # records into its own node's registry through activate())
        self.knn_batcher = batcher.default_batcher
        self.knn_batcher.metrics = self.telemetry.metrics
        shard_mesh.default_registry.metrics = self.telemetry.metrics
        # the roofline recorder is process-wide like the batcher; its peaks
        # calibrate HERE on this node's device, once per process and
        # platform (a stub installed earlier wins), never inside a stats
        # read
        roofline.default_recorder.metrics = self.telemetry.metrics
        roofline.ensure_peaks(self.device)
        self.search_pipelines = SearchPipelineService(
            self.data_path / "search_pipelines.json")
        self.search_slowlog = SlowLog("search")
        self.indexing_slowlog = SlowLog("indexing")
        self._configure_slowlogs()

    def _configure_slowlogs(self) -> None:
        """Pick up index.search.slowlog.threshold.query.* and
        index.indexing.slowlog.threshold.index.* from any index's settings
        (node-wide loggers; the reference scopes them per index).
        Thresholds reset first so a deleted or changed index leaves no
        stale level."""
        from opensearch_tpu_torch.telemetry.slowlog import LEVELS

        for sl in (self.search_slowlog, self.indexing_slowlog):
            sl.thresholds = {lvl: -1 for lvl in LEVELS}
        for svc in self.indices.values():
            s = svc.settings
            q = (((s.get("search") or {}).get("slowlog") or {})
                 .get("threshold") or {}).get("query") or {}
            if q:
                self.search_slowlog.configure(q)
            i = (((s.get("indexing") or {}).get("slowlog") or {})
                 .get("threshold") or {}).get("index") or {}
            if i:
                self.indexing_slowlog.configure(i)

    def apply_dynamic_settings(self, flat: dict) -> None:
        """Apply the dynamic node settings this port honours from a flat
        settings map: ``search.mesh.hbm_budget_bytes`` (the shard-mesh
        registry) and ``telemetry.heat.*`` (the residency ledger's touch
        accounting), each only where the map names one of its keys. Both
        are process-wide, like the batcher."""
        from opensearch_tpu_torch.telemetry.device_ledger import (
            HEAT_SETTINGS,
            default_ledger,
        )

        if any(st.key in flat for st in shard_mesh.MESH_SETTINGS):
            shard_mesh.default_registry.apply_settings(flat)
        if any(st.key in flat for st in HEAT_SETTINGS):
            default_ledger.apply_heat_settings(flat)

    # -- index lifecycle ---------------------------------------------------

    def create_index(self, name: str, body: dict | None = None) -> dict:
        if not _valid_index_name(name):
            raise IllegalArgumentException(f"invalid index name [{name}]")
        if name in self.indices:
            raise ResourceAlreadyExistsException(f"index [{name}] already exists")
        body = body or {}
        unknown = set(body) - {"settings", "mappings"}
        if unknown:
            raise not_yet_ported(f"create-index keys {sorted(unknown)}")
        # accept both flat ("index.number_of_shards") and nested forms
        flat = Settings.from_nested(body.get("settings") or {}).as_dict()
        norm = {(k[len("index."):] if k.startswith("index.") else k): v
                for k, v in flat.items()}
        nested = Settings.from_flat(norm).as_nested()
        self.indices[name] = IndexService(
            name, self._index_path(name), nested, body.get("mappings"),
            self.device)
        self._configure_slowlogs()
        return {"acknowledged": True, "shards_acknowledged": True, "index": name}

    def _index_path(self, name: str) -> Path:
        return self.data_path / "indices" / name

    def delete_index(self, expr: str, *, ignore_unavailable: bool = False,
                     allow_no_indices: bool = True) -> dict:
        """DELETE /{index}: every named index (or every index for `_all`
        and `*`) closes, leaves the node, has its stacked serving slabs
        released from device memory and its files removed."""
        targets: list[str] = []
        matched_any = False
        for part in expr.split(","):
            part = part.strip()
            if part in ("_all", "*"):
                targets.extend(list(self.indices))
                matched_any = True
            elif _has_wildcard(part):
                raise not_yet_ported("wildcard index expressions")
            elif part in self.indices:
                targets.append(part)
                matched_any = True
            elif not ignore_unavailable:
                raise IndexNotFoundException(part)
        if not matched_any and not allow_no_indices:
            raise IndexNotFoundException(expr)
        for name in dict.fromkeys(targets):
            self._get_index(name).close()
            del self.indices[name]
            shard_mesh.default_registry.invalidate_index(name)
            shutil.rmtree(self._index_path(name), ignore_errors=True)
        self._configure_slowlogs()
        return {"acknowledged": True}

    def _get_index(self, name: str) -> IndexService:
        svc = self.indices.get(name)
        if svc is None:
            raise IndexNotFoundException(name)
        return svc

    def _get_or_autocreate(self, name: str) -> IndexService:
        if name not in self.indices:
            self.create_index(name, {})
        return self.indices[name]

    def resolve_indices(self, expr: str, *, ignore_unavailable: bool = False,
                        allow_no_indices: bool = True,
                        expand_wildcards: str = "open") -> list[str]:
        """Index name resolution: a comma list of concrete names, or every
        index for `_all`, `*` and the empty expression. Wildcard patterns
        and aliases are not ported; `ignore_unavailable` drops missing
        names instead of a 404; an empty result 404s when
        `allow_no_indices` is false."""
        expand = {w.strip() for w in str(expand_wildcards).split(",")}
        if expr in ("_all", "*", ""):
            names = sorted(self.indices) if "none" not in expand else []
            if not names and not allow_no_indices:
                raise IndexNotFoundException(expr or "_all")
            return names
        names: list[str] = []
        for part in expr.split(","):
            part = part.strip()
            if _has_wildcard(part):
                raise not_yet_ported("wildcard index expressions")
            if part not in self.indices:
                if ignore_unavailable:
                    continue
                raise IndexNotFoundException(part)
            names.append(part)
        if not names and not allow_no_indices:
            raise IndexNotFoundException(expr)
        return list(dict.fromkeys(names))

    def get_mapping(self, index: str, *, ignore_unavailable: bool = False,
                    allow_no_indices: bool = True,
                    expand_wildcards: str = "open") -> dict:
        return {
            name: {"mappings": self._get_index(name).mapper_service.to_dict()}
            for name in self.resolve_indices(
                index, ignore_unavailable=ignore_unavailable,
                allow_no_indices=allow_no_indices,
                expand_wildcards=expand_wildcards)
        }

    def get_settings(self, index: str, *, name: str | None = None,
                     flat: bool = False, include_defaults: bool = False,
                     expand_wildcards: str = "all") -> dict:
        """GET [/{index}]/_settings[/{name}]: values stringified, `name`
        filters by flat dotted key (wildcards OK), `flat_settings` keeps
        dotted keys, `include_defaults` adds the unset defaults."""
        out = {}
        for idx_name in self.resolve_indices(
                index, expand_wildcards=expand_wildcards):
            svc = self._get_index(idx_name)
            out[idx_name] = index_settings_entry(
                svc.settings or {},
                num_shards=svc.num_shards, num_replicas=svc.num_replicas,
                name=name, flat=flat, include_defaults=include_defaults,
                extra={
                    "index.creation_date": str(svc.creation_date),
                    "index.uuid": svc.uuid,
                    "index.provided_name": idx_name,
                },
            )
        return out

    # -- document APIs -------------------------------------------------------
    #
    # Each public write fsyncs the translog of the shards it touched once,
    # before its response, as the reference does under durability=request.

    def index_doc(self, index: str, doc_id: str | None, source: dict,
                  routing: str | None = None, if_seq_no: int | None = None,
                  refresh: bool = False, op_type: str | None = "index",
                  pipeline: str | None = None, version: int | None = None,
                  version_type: str = "internal",
                  if_primary_term: int | None = None) -> dict:
        if pipeline is not None:
            raise not_yet_ported("ingest pipelines")
        t0 = time.monotonic()
        resp, shard = self._index_doc(
            index, doc_id, source, routing, op_type or "index", if_seq_no,
            version, version_type, if_primary_term)
        shard.maybe_sync_translog()
        if refresh:
            shard.refresh()
        self.indexing_slowlog.maybe_log(
            (time.monotonic() - t0) * 1000, index, f"id[{resp['_id']}]")
        return resp

    def _index_doc(self, index: str, doc_id: str | None, source: dict,
                   routing: str | None, op_type: str,
                   if_seq_no: int | None = None, version: int | None = None,
                   version_type: str = "internal",
                   if_primary_term: int | None = None
                   ) -> tuple[dict, IndexShard]:
        if if_primary_term is not None and if_seq_no is None:
            raise ActionRequestValidationException(
                "Validation Failed: 1: ifSeqNo is unassigned, but "
                "primary_term is [%s];" % if_primary_term)
        if if_primary_term is not None and int(if_primary_term) != 1:
            # single-term engine: any other required term conflicts
            raise VersionConflictException(
                f"[{doc_id}]: version conflict, required primaryTerm "
                f"[{if_primary_term}], current primaryTerm [1]")
        if version is not None and op_type == "create" and \
                version_type != "internal":
            raise ActionRequestValidationException(
                "Validation Failed: 1: create operations only support "
                "internal versioning. use index instead;")
        svc = self._get_or_autocreate(index)
        doc_id = uuid.uuid4().hex[:20] if doc_id is None else str(doc_id)
        if len(doc_id.encode()) > 512:
            raise IllegalArgumentException(
                f"id is too long, must be no longer than 512 bytes but "
                f"was: {len(doc_id.encode())}")
        shard = svc.shard_for(doc_id, routing)
        if op_type == "create" and shard.get(doc_id) is not None:
            raise VersionConflictException(
                f"[{doc_id}]: version conflict, document already exists "
                "(current version [1])")
        result = shard.apply_index_on_primary(
            doc_id, source, routing, if_seq_no=if_seq_no, version=version,
            version_type=version_type)
        return self._write_response(index, doc_id, result), shard

    def get_doc(self, index: str, doc_id: str, routing: str | None = None,
                realtime: bool = True, version: int | None = None,
                refresh: bool = False) -> dict:
        """Realtime GET through the shard's version map and buffer
        (IndexShard.get); `refresh` refreshes the shard first."""
        shard = self._get_index(index).shard_for(doc_id, routing)
        if refresh:
            shard.refresh()
        got = shard.get(doc_id, realtime=realtime)
        if got is None:
            return {"_index": index, "_id": doc_id, "found": False}
        if version is not None and got["_version"] != version:
            raise VersionConflictException(
                f"[{doc_id}]: version conflict, current version "
                f"[{got['_version']}] is different than the one provided "
                f"[{version}]")
        out = {
            "_index": index, "_id": doc_id, "_version": got["_version"],
            "_seq_no": got["_seq_no"], "_primary_term": 1, "found": True,
            "_source": got["_source"],
        }
        if got.get("_routing") is not None:
            out["_routing"] = got["_routing"]
        return out

    def delete_doc(self, index: str, doc_id: str, routing: str | None = None,
                   refresh: bool = False, if_seq_no: int | None = None,
                   version: int | None = None,
                   version_type: str = "internal") -> dict:
        resp, shard = self._delete_doc(index, doc_id, routing, if_seq_no,
                                       version, version_type)
        shard.maybe_sync_translog()
        if refresh:
            shard.refresh()
        return resp

    def _delete_doc(self, index: str, doc_id: str, routing: str | None,
                    if_seq_no: int | None = None, version: int | None = None,
                    version_type: str = "internal"
                    ) -> tuple[dict, IndexShard]:
        shard = self._get_index(index).shard_for(doc_id, routing)
        result = shard.apply_delete_on_primary(
            doc_id, if_seq_no=if_seq_no, version=version,
            version_type=version_type)
        return self._write_response(index, doc_id, result), shard

    @staticmethod
    def _write_response(index: str, doc_id: str, result) -> dict:
        return {
            "_index": index, "_id": doc_id, "_version": result.version,
            "result": result.result,
            "_shards": {"total": 1, "successful": 1, "failed": 0},
            "_seq_no": result.seq_no, "_primary_term": 1,
        }

    def update_doc(self, index: str, doc_id: str, body: dict,
                   routing: str | None = None, refresh: bool = False,
                   if_seq_no: int | None = None,
                   require_alias: bool = False) -> dict:
        """Partial update by a doc merge, a painless script or an upsert
        (action/update/UpdateHelper.java)."""
        if require_alias:
            # no aliases on this node: the target is never one
            e = IndexNotFoundException(index)
            e.reason = (
                f"no such index [{index}] and [require_alias] request "
                f"flag is [true] and [{index}] is not an alias")
            raise e
        out, shard = self._update_doc(index, doc_id, body, routing, if_seq_no)
        if shard is not None:
            shard.maybe_sync_translog()
            if refresh:
                shard.refresh()
        return out


    _UPDATE_KEYS = {"script", "doc", "upsert", "doc_as_upsert",
                    "detect_noop", "scripted_upsert", "_source", "fields",
                    "lang", "params"}

    def _update_doc(self, index: str, doc_id: str, body: dict,
                    routing: str | None, if_seq_no: int | None = None
                    ) -> tuple[dict, IndexShard | None]:
        """(response, the shard written or None for a noop). A `_source`
        in the body returns the updated document's source under `get`."""
        out, shard = self._apply_update(index, doc_id, body, routing,
                                        if_seq_no)
        src_spec = (body or {}).get("_source")
        if src_spec and out.get("result") != "noop":
            got = self.get_doc(index, doc_id, routing=routing)
            if got.get("found"):
                out["get"] = {
                    "found": True,
                    "_source": search_service._source_filter(src_spec)(
                        got["_source"]),
                    "_seq_no": got.get("_seq_no"),
                    "_primary_term": got.get("_primary_term", 1),
                }
        return out, shard

    def _apply_update(self, index: str, doc_id: str, body: dict,
                      routing: str | None, if_seq_no: int | None
                      ) -> tuple[dict, IndexShard | None]:
        for key in body or {}:
            if key not in self._UPDATE_KEYS:
                near = difflib.get_close_matches(key, self._UPDATE_KEYS, 1)
                hint = f" did you mean [{near[0]}]?" if near else ""
                raise IllegalArgumentException(
                    f"[UpdateRequest] unknown field [{key}]{hint}")
        # updates auto-create the target index like index ops do
        svc = self._get_or_autocreate(index)
        shard = svc.shard_for(doc_id, routing)
        current = shard.get(doc_id)
        if if_seq_no is not None:
            if current is None and not (
                    body.get("upsert") or body.get("doc_as_upsert")):
                raise DocumentMissingException(f"[{doc_id}]: document missing")
            current_seq = current["_seq_no"] if current is not None else -1
            if current_seq != if_seq_no:
                raise VersionConflictException(
                    f"[{doc_id}]: version conflict, required seqNo "
                    f"[{if_seq_no}], current document has seqNo "
                    f"[{current_seq}]")
        if "script" in body:
            return self._scripted_update(index, doc_id, body, routing,
                                         current, shard)
        if "doc" in body:
            if current is None:
                if body.get("doc_as_upsert"):
                    return self._index_doc(index, doc_id, body["doc"],
                                           routing, "index")
                if "upsert" in body:
                    return self._index_doc(index, doc_id, body["upsert"],
                                           routing, "index")
                raise DocumentMissingException(f"[{doc_id}]: document missing")
            merged = _deep_merge(current["_source"], body["doc"])
            if merged == current["_source"] and body.get("detect_noop") \
                    is not False:
                eng = shard.engine
                eng.stats["noop_update_total"] = \
                    eng.stats.get("noop_update_total", 0) + 1
                return {"_index": index, "_id": doc_id, "result": "noop",
                        "_version": current["_version"],
                        "_seq_no": current["_seq_no"], "_primary_term": 1,
                        "_shards": {"total": 0, "successful": 0,
                                    "failed": 0}}, None
            out, shard = self._index_doc(index, doc_id, merged, routing,
                                         "index")
            out["result"] = "updated"
            return out, shard
        if "upsert" in body and current is None:
            return self._index_doc(index, doc_id, body["upsert"], routing,
                                   "index")
        raise IllegalArgumentException("update requires [doc] or [upsert]")

    def _scripted_update(self, index: str, doc_id: str, body: dict,
                         routing: str | None, current: dict | None,
                         shard: IndexShard
                         ) -> tuple[dict, IndexShard | None]:
        """An update by a painless script over ``ctx._source``: the script
        may set ``ctx.op`` to "none" (a noop) or "delete"; a missing doc
        takes the ``upsert`` document, run through the script first under
        ``scripted_upsert``."""
        from opensearch_tpu_torch.script import default_script_service

        noop_shards = {"total": 0, "successful": 0, "failed": 0}
        if current is None:
            if "upsert" not in body:
                raise DocumentMissingException(f"[{doc_id}]: document missing")
            if not body.get("scripted_upsert"):
                return self._index_doc(index, doc_id, body["upsert"],
                                       routing, "index")
            ctx = {"_source": dict(body["upsert"]), "op": "create",
                   "_index": index, "_id": doc_id}
            ast, params = default_script_service.compile(body["script"])
            default_script_service.execute_update(ast, params, ctx)
            if ctx.get("op") in ("none", "noop"):
                return {"_index": index, "_id": doc_id, "result": "noop",
                        "_shards": noop_shards}, None
            return self._index_doc(index, doc_id, ctx["_source"], routing,
                                   "index")
        ctx = {"_source": dict(current["_source"]), "op": "index",
               "_index": index, "_id": doc_id,
               "_version": current["_version"], "_seq_no": current["_seq_no"]}
        ast, params = default_script_service.compile(body["script"])
        default_script_service.execute_update(ast, params, ctx)
        op = ctx.get("op", "index")
        if op in ("none", "noop"):
            eng = shard.engine
            eng.stats["noop_update_total"] = \
                eng.stats.get("noop_update_total", 0) + 1
            return {"_index": index, "_id": doc_id, "result": "noop",
                    "_version": current["_version"],
                    "_seq_no": current["_seq_no"], "_primary_term": 1,
                    "_shards": noop_shards}, None
        if op == "delete":
            return self._delete_doc(index, doc_id, routing)
        out, shard = self._index_doc(index, doc_id, ctx["_source"], routing,
                                     "index")
        out["result"] = "updated"
        return out, shard

    def bulk(self, operations: list[tuple[str, dict, dict | None]],
             refresh: bool = False, pipeline: str | None = None) -> dict:
        """operations: [(action, metadata, source)]; action in
        index|create|update|delete. The translog is fsynced once per
        request for every shard it touched, before the response, as the
        reference does under durability=request."""
        if pipeline is not None:
            raise not_yet_ported("ingest pipelines")
        t0 = time.monotonic()
        items = []
        errors = False
        touched: dict[int, IndexShard] = {}
        for action, meta, source in operations:
            index = meta.get("_index")
            doc_id = meta.get("_id")
            if doc_id is not None and not isinstance(doc_id, str):
                doc_id = str(doc_id)
            routing = meta.get("routing") or meta.get("_routing")
            if routing is not None:
                routing = str(routing)
            try:
                if doc_id == "":
                    raise IllegalArgumentException(
                        "if _id is specified it must not be empty")
                if meta.get("pipeline") is not None:
                    raise not_yet_ported("ingest pipelines")
                if meta.get("require_alias") in (True, "true"):
                    e = IndexNotFoundException(index)
                    e.reason = (
                        f"no such index [{index}] and [require_alias] "
                        f"request flag is [true] and [{index}] is not an "
                        f"alias")
                    raise e
                if action == "index" and meta.get("op_type") == "create":
                    action = "create"
                shard = None
                if action in ("index", "create"):
                    m_seq = meta.get("if_seq_no")
                    m_pt = meta.get("if_primary_term")
                    resp, shard = self._index_doc(
                        index, doc_id, source, routing, action,
                        if_seq_no=int(m_seq) if m_seq is not None else None,
                        if_primary_term=(int(m_pt) if m_pt is not None
                                         else None))
                    status = 201 if resp["result"] == "created" else 200
                elif action == "update":
                    if meta.get("_source") is not None and \
                            isinstance(source, dict) \
                            and "_source" not in source:
                        source = {**source, "_source": meta["_source"]}
                    m_seq = meta.get("if_seq_no")
                    if m_seq is not None and index in self.indices and \
                            self.indices[index].shard_for(
                                str(doc_id), routing).get(str(doc_id)) is None:
                        # bulk CAS on a missing doc conflicts (the
                        # item-level contract differs from the single
                        # update API's 404)
                        raise VersionConflictException(
                            f"[{doc_id}]: version conflict, required "
                            f"seqNo [{m_seq}], but no document was found")
                    resp, shard = self._update_doc(
                        index, doc_id, source, routing,
                        if_seq_no=int(m_seq) if m_seq is not None else None)
                    status = 200
                elif action == "delete":
                    resp, shard = self._delete_doc(index, doc_id, routing)
                    status = 200 if resp["result"] == "deleted" else 404
                else:
                    raise IllegalArgumentException(
                        f"unknown bulk action [{action}]")
                if shard is not None:
                    touched[id(shard)] = shard
                items.append({action: {**resp, "status": status}})
            except OpenSearchTpuException as e:
                errors = True
                items.append({action: {"_index": index, "_id": doc_id,
                                       "status": e.status,
                                       "error": e.to_dict()}})
        for shard in touched.values():
            shard.maybe_sync_translog()
            if refresh:
                shard.refresh()
        return {"took": int((time.monotonic() - t0) * 1000),
                "errors": errors, "items": items}

    # -- stored scripts and search templates ---------------------------------

    def _scripts_file(self) -> Path:
        return self.data_path / "stored_scripts.json"

    def _load_scripts(self) -> dict:
        if self._scripts_file().exists():
            return json.loads(self._scripts_file().read_text())
        return {}

    def put_stored_script(self, script_id: str, body: dict) -> dict:
        script = (body or {}).get("script")
        if not isinstance(script, dict) or "source" not in script:
            raise IllegalArgumentException(
                "stored script requires [script] with [source]")
        data = self._load_scripts()
        data[script_id] = {
            "lang": script.get("lang", "painless"),
            "source": script["source"],
            **({"options": script["options"]} if "options" in script
               else {}),
        }
        self.data_path.mkdir(parents=True, exist_ok=True)
        self._scripts_file().write_text(json.dumps(data))
        return {"acknowledged": True}

    def get_stored_script(self, script_id: str) -> dict:
        data = self._load_scripts()
        if script_id not in data:
            return {"_id": script_id, "found": False}
        return {"_id": script_id, "found": True, "script": data[script_id]}

    def delete_stored_script(self, script_id: str) -> dict:
        data = self._load_scripts()
        if script_id not in data:
            raise ResourceNotFoundException(
                f"stored script [{script_id}] does not exist")
        del data[script_id]
        self._scripts_file().write_text(json.dumps(data))
        return {"acknowledged": True}

    def render_search_template(self, body: dict,
                               template_id: str | None = None) -> dict:
        """A template (inline ``source`` or a stored ``id``) and its
        ``params`` rendered to a search body (script/mustache.py)."""
        from opensearch_tpu_torch.script.mustache import (
            render_search_template,
        )

        body = body or {}
        source = body.get("source")
        sid = template_id or body.get("id")
        if source is None and sid is not None:
            stored = self.get_stored_script(str(sid))
            if not stored.get("found"):
                raise ResourceNotFoundException(
                    f"search template [{sid}] does not exist")
            source = stored["script"]["source"]
        if source is None:
            raise IllegalArgumentException(
                "search template requires [source] or [id]")
        return render_search_template(source, body.get("params"))

    def search_template(self, index: str | None, body: dict,
                        template_id: str | None = None, **kwargs) -> dict:
        return self.search(index, self.render_search_template(
            body, template_id), **kwargs)

    # -- refresh / search ----------------------------------------------------

    def refresh(self, index: str = "_all") -> dict:
        count = 0
        for name in self.resolve_indices(index):
            for shard in self._get_index(name).shards.values():
                shard.refresh()
                count += 1
        return {"_shards": {"total": count, "successful": count, "failed": 0}}

    def _search_shards(self, index: str | None,
                       ignore_unavailable: bool = False) -> list[IndexShard]:
        return [shard for name in self.resolve_indices(
                    index or "_all", ignore_unavailable=ignore_unavailable)
                for shard in self._get_index(name).shards.values()]

    def search(self, index: str | None = None, body: dict | None = None,
               precomputed_results: list | None = None,
               ignore_unavailable: bool = False,
               search_pipeline: str | None = None) -> dict:
        body = dict(body or {})
        # the body key is always taken out; the parameter wins over it
        body_pipeline = body.pop("search_pipeline", None)
        pipeline_id = search_pipeline or body_pipeline
        # per-request stat groups feed indices.stats in the reference,
        # which is not ported: the key is checked and accepted
        stat_groups = body.get("stats")
        if stat_groups is not None and not isinstance(stat_groups, list):
            raise ParsingException("[stats] must be an array of group names")
        sort_spec = body.get("sort")
        for spec in ([sort_spec] if isinstance(sort_spec, (str, dict))
                     else sort_spec or []):
            fname = spec if isinstance(spec, str) else next(iter(spec), None)
            if fname == "_shard_doc":
                raise ActionRequestValidationException(
                    "Validation Failed: 1: [_shard_doc] sort field is only "
                    "supported with point-in-time (PIT) searches;")
        shards = self._search_shards(index, ignore_unavailable)
        if body.get("indices_boost") is not None:
            body["indices_boost"] = self._resolve_indices_boost(
                body["indices_boost"], ignore_unavailable=ignore_unavailable)
        names = sorted({sh.shard_id.index for sh in shards})
        expr = ",".join(names) or "_none"
        body = self._resolve_mlt_doc_refs(body, names)
        pl, pr_config = self._resolve_search_pipeline(pipeline_id, names)
        pl_ctx = {}
        if pl is not None:
            body = self.search_pipelines.transform_request(pl, body)
            if "_original_size" in body:
                pl_ctx["_original_size"] = body.pop("_original_size")
        from opensearch_tpu_torch.search import lanes as lanes_mod
        from opensearch_tpu_torch.telemetry import tracing

        # activate() scopes library spans and the process-wide singletons'
        # metrics to THIS node; the slowlog and the metrics record inside
        # the span, so the slowlog entry and the histogram exemplar carry
        # its trace id
        metrics = self.telemetry.metrics
        with tracing.activate(self.telemetry.tracer), \
                self.telemetry.tracer.start_span(
                    "search", {"indices": expr}) as span:
            resp = search_service.search(shards, body, precomputed_results,
                                         phase_results_config=pr_config)
            took = resp.get("took", 0)
            span.set_attribute("took_ms", took)
            self.search_slowlog.maybe_log(
                took, expr, json.dumps(body.get("query") or {}))
            metrics.counter("search.total").add(1)
            metrics.histogram("search.took_ms").record(took)
            # per-index and per-lane series under the same metric name
            if len(names) == 1:
                metrics.histogram("search.took_ms",
                                  labels={"index": expr}).record(took)
            metrics.histogram(
                "search.took_ms",
                labels={"lane": lanes_mod.active_lane()}).record(took)
        if pl is not None:
            resp = self.search_pipelines.transform_response(
                pl, {**body, **pl_ctx}, resp)
        return resp

    def _resolve_search_pipeline(self, pipeline_id: str | None,
                                 index_names: list[str]
                                 ) -> tuple[dict | None, dict | None]:
        """(pipeline, its phase-results config): the explicit
        ``search_pipeline`` over ``index.search.default_pipeline``;
        "_none" is none."""
        if pipeline_id == "_none":
            return None, None
        if pipeline_id is None:
            for name in index_names:
                svc = self.indices.get(name)
                default = ((svc.settings.get("search") or {}).get(
                    "default_pipeline") if svc else None)
                if default and default != "_none":
                    pipeline_id = default
                    break
        if pipeline_id is None:
            return None, None
        pl = self.search_pipelines.get(pipeline_id)
        return pl, self.search_pipelines.phase_results_config(pl)

    def _resolve_mlt_doc_refs(self, body: dict,
                              index_names: list[str] | None = None) -> dict:
        """A more_like_this ``like`` doc reference ({_index, _id}) replaced
        by the doc's field texts before the shards run (the two-phase
        rewrite of MoreLikeThisQueryBuilder, which multi-gets the docs)."""

        def likes_of(mlt: dict) -> list:
            like = mlt.get("like")
            return (like if isinstance(like, list)
                    else [like] if like is not None else [])

        def has_refs(obj) -> bool:
            if isinstance(obj, dict):
                mlt = obj.get("more_like_this")
                if isinstance(mlt, dict) and any(
                        isinstance(x, dict) for x in likes_of(mlt)):
                    return True
                return any(has_refs(v) for v in obj.values())
            if isinstance(obj, list):
                return any(has_refs(x) for x in obj)
            return False

        if not has_refs(body):
            return body
        body = copy.deepcopy(body)
        default_index = (index_names or [""])[0]

        def resolve(obj) -> None:
            if isinstance(obj, dict):
                mlt = obj.get("more_like_this")
                if isinstance(mlt, dict):
                    likes = likes_of(mlt)
                    texts = [x for x in likes if isinstance(x, str)]
                    fields = mlt.get("fields")
                    for ref in (x for x in likes if isinstance(x, dict)):
                        try:
                            got = self.get_doc(
                                str(ref.get("_index", default_index)),
                                str(ref.get("_id", "")))
                        except OpenSearchTpuException:
                            continue
                        if not got.get("found"):
                            continue
                        for fname, val in _flatten_source(
                                got["_source"]).items():
                            if fields and fname not in fields:
                                continue
                            vals = val if isinstance(val, list) else [val]
                            texts.extend(str(v) for v in vals)
                    mlt["like"] = texts
                for v in obj.values():
                    resolve(v)
            elif isinstance(obj, list):
                for x in obj:
                    resolve(x)

        resolve(body)
        return body

    def _resolve_indices_boost(self, spec,
                               ignore_unavailable: bool = False) -> dict:
        """indices_boost: {index: boost} or [{index-or-pattern: boost}, ...]
        resolved to concrete index names; an unknown name is a 404, as in
        the reference (SearchService.resolveIndexBoosts)."""
        if isinstance(spec, dict):
            entries = [(k, float(v)) for k, v in spec.items()]
        elif isinstance(spec, list):
            entries = []
            for item in spec:
                if not isinstance(item, dict) or len(item) != 1:
                    raise IllegalArgumentException(
                        "[indices_boost] must contain one entry per object")
                k, v = next(iter(item.items()))
                entries.append((k, float(v)))
        else:
            raise IllegalArgumentException(
                "[indices_boost] must be an object or an array")
        out: dict[str, float] = {}
        for name, boost in entries:
            for concrete in self.resolve_indices(
                    name, ignore_unavailable=ignore_unavailable):
                out.setdefault(concrete, boost)  # the first match wins
        return out

    def count(self, index: str, body: dict | None = None) -> dict:
        """``_count``: the search's total at size 0."""
        body = dict(body or {})
        body["size"] = 0
        resp = self.search(index, body)
        return {"count": resp["hits"]["total"]["value"],
                "_shards": resp["_shards"]}

    def msearch(self, searches: list[tuple[dict, dict]]) -> dict:
        """Runs of consecutive bare-knn sub-searches against the SAME index
        run their query phase as ONE stacked launch
        (search_service.try_batched_knn_msearch: B query vectors in one
        launch); everything else runs one by one, as the reference's
        TransportMultiSearchAction fans out a sub-request at a time. An
        error of this API (an OpenSearchTpuException) fills its own slot;
        a body outside the port raises "not yet ported", as search does."""
        responses: list[dict | None] = [None] * len(searches)
        for group in search_service.msearch_groups(searches):
            index = searches[group[0]][0].get("index")
            precomputed = None
            if len(group) > 1:
                precomputed = self._try_msearch_knn_batch(
                    index, [searches[g][1] for g in group])
            # precomputed None: the whole run one by one (each member still
            # eligible for the single-query stacked step)
            for slot, g in enumerate(group):
                try:
                    responses[g] = self.search(
                        searches[g][0].get("index"), searches[g][1],
                        precomputed_results=(precomputed[slot]
                                             if precomputed else None))
                except OpenSearchTpuException as e:
                    responses[g] = {"error": e.to_dict(), "status": e.status}
        return {"took": 0, "responses": responses}

    def _try_msearch_knn_batch(self, index: str,
                               bodies: list[dict]) -> list[list] | None:
        """Resolve `index` once, pin one set of searcher snapshots, and run
        the batched knn query phase over them. Returns per-body
        precomputed_results for search(), or None (the bodies one by one).
        An index with a default search pipeline keeps the run on its
        serial path, where the pipeline rewrites each request first (a
        body with its own ``search_pipeline`` key is never batchable); the
        reference's filtered-alias check does not apply (no aliases)."""
        try:
            shards = self._search_shards(index)
        except OpenSearchTpuException:
            return None  # the serial path reports the error per sub-search
        for name in {sh.shard_id.index for sh in shards}:
            if (self.indices[name].settings.get("search") or {}).get(
                    "default_pipeline"):
                return None
        snaps = [s.acquire_searcher() for s in shards]
        return search_service.try_batched_knn_msearch(shards, bodies, snaps)

    # -- cluster -------------------------------------------------------------

    def cluster_health(self, index: str | None = None,
                       level: str = "cluster",
                       expand_wildcards: str = "all") -> dict:
        """GET _cluster/health. Single-node truth: every primary is active
        on this node and every configured replica is unassigned (no peer
        to hold it), so an index with replicas > 0 reports yellow."""
        names = (sorted(self.indices) if index in (None, "", "_all")
                 else self.resolve_indices(index,
                                           expand_wildcards=expand_wildcards))
        active = 0
        unassigned = 0
        per_index: dict[str, Any] = {}
        worst = "green"
        for name in names:
            svc = self.indices[name]
            idx_active = svc.num_shards
            idx_unassigned = svc.num_shards * svc.num_replicas
            active += idx_active
            unassigned += idx_unassigned
            status = "yellow" if idx_unassigned else "green"
            if status == "yellow":
                worst = "yellow"
            entry: dict[str, Any] = {
                "status": status,
                "number_of_shards": svc.num_shards,
                "number_of_replicas": svc.num_replicas,
                "active_primary_shards": idx_active,
                "active_shards": idx_active,
                "relocating_shards": 0,
                "initializing_shards": 0,
                "unassigned_shards": idx_unassigned,
            }
            if level == "shards":
                entry["shards"] = {
                    str(s): {
                        "status": status,
                        "primary_active": True,
                        "active_shards": 1,
                        "relocating_shards": 0,
                        "initializing_shards": 0,
                        "unassigned_shards": svc.num_replicas,
                    }
                    for s in range(svc.num_shards)
                }
            per_index[name] = entry
        total = active + unassigned
        out = {
            "cluster_name": "opensearch-tpu",
            "status": worst,
            "timed_out": False,
            "number_of_nodes": 1,
            "number_of_data_nodes": 1,
            "discovered_master": True,
            "discovered_cluster_manager": True,
            "active_primary_shards": active,
            "active_shards": active,
            "relocating_shards": 0,
            "initializing_shards": 0,
            "unassigned_shards": unassigned,
            "delayed_unassigned_shards": 0,
            "number_of_pending_tasks": 0,
            "number_of_in_flight_fetch": 0,
            "task_max_waiting_in_queue_millis": 0,
            "active_shards_percent_as_number":
                (100.0 * active / total) if total else 100.0,
        }
        if level in ("indices", "shards"):
            out["indices"] = per_index
        return out

    def close(self) -> None:
        for name, svc in self.indices.items():
            svc.close()
            # the stacked serving slabs of this index leave device memory
            shard_mesh.default_registry.invalidate_index(name)
        self.indices.clear()
