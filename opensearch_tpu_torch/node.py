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

Search contexts, aliases and admission, as the reference's ``search``
runs them: a point in time (``open_pit``, ``list_all_pits``,
``close_pit``, a body's ``pit``) and a scroll (``search(scroll=)``,
``scroll``, ``clear_scroll``) pin one set of searcher snapshots in the
reader-context registry, and every page or PIT search reads them; aliases
(``update_aliases``, ``put_alias``, ``delete_alias``, ``get_alias``,
``create_index``'s ``aliases``) resolve for searches, with a filtered
alias's filter ANDed into its shards' queries (one filtered K1 launch on
the stacked step), and for writes through a write alias with its routing;
the request cache (index/request_cache.py) answers a repeated ``size: 0``
body keyed by the pinned snapshots' generations; each search runs as a
task (``task_manager``, tasks/manager.py, cancellable before each
launch) behind search backpressure (``search_backpressure``) and its
workload group's admission (``query_groups``, wlm.py); ``breakers``
(common/breaker.py) carries the HTTP server's in-flight bytes;
``flush`` and ``force_merge`` call the engines'.

The index registry (``indices.json``: each index's settings, mappings and
aliases) is written on every change; ``TorchNode(path)`` reopens every
index from it, each shard from its commit and translog, on the node's
device. ``put_cluster_settings`` / ``get_cluster_settings`` keep the
persistent section in ``cluster_settings.json`` (re-applied at boot) and
a transient one in memory, and apply them to the batcher, the ANN config,
the lanes, the residency routing, the shard-mesh budget and the heat
ledger (process-wide: each only where its keys are named), the request
cache's budget and the span exporter (telemetry/export.py, closed in
``close``).

Telemetry (telemetry/): each node has its own ``telemetry`` (a tracer and
a metrics registry; every search is one ``search`` span with the
``search.total`` / ``search.took_ms`` metrics), a search and an indexing
slow log configured from the indices' ``search.slowlog`` /
``indexing.slowlog`` thresholds, and is the metrics sink of the
process-wide batcher, shard-mesh registry and roofline recorder, whose
peaks it calibrates on its device at construction.

Index expressions (``resolve_indices``, ``resolve_search_shards``,
``delete_index``) take comma lists of names, aliases, ``*`` / ``?``
patterns over both, ``-`` exclusions after a pattern, date-math names and
``expand_wildcards`` (a pattern skips an ``index.hidden`` index unless
``hidden`` or ``all`` is asked; every index is open, so ``closed`` alone
matches nothing). Ingest pipelines (ingest/, ``ingest``, kept in
``ingest_pipelines.json``) run before a document is indexed: the
request's ``pipeline``, else ``index.default_pipeline``, then the landing
index's ``index.final_pipeline``, with ``drop`` and ``_index`` /
``_routing`` reroutes, on single writes and each ``_bulk`` item.
Composable, component and legacy index templates (``templates.json``)
layer under ``create_index``'s body, an auto-created index's too. The
node's stats: ``monitor`` (common/monitor.py), ``index_stats`` (the
``_stats`` API, per-index search counters as the reference counts them)
and the sections ``rest/handlers.py`` assembles for ``_nodes/stats``,
``_cat`` and ``_prometheus/metrics``.

The device is the card unless the caller asks for the CPU::

    node = TorchNode(path)                 # CUDA; raises without a card
    node = TorchNode(path, device="cpu")   # the CPU, as the tests run it
"""

from __future__ import annotations

import base64
import copy
import difflib
import fnmatch
import json
import re
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
    SearchContextMissingException,
    VersionConflictException,
)
from opensearch_tpu_torch.common.hashing import shard_id_for_routing
from opensearch_tpu_torch.common.settings import (
    Settings,
    setting_str,
    settings_section,
)
from opensearch_tpu_torch.common.timeutil import (
    now_millis,
    parse_time_value_millis,
)
from opensearch_tpu_torch.index.analysis import AnalysisRegistry
from opensearch_tpu_torch.index.mapper import MapperService
from opensearch_tpu_torch.index.shard import IndexShard, ShardId, translog_durability
from opensearch_tpu_torch.search import batcher
from opensearch_tpu_torch.search import service as search_service
from opensearch_tpu_torch.search.executor import not_yet_ported
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


def simple_match(name: str, pattern: str) -> bool:
    """`*`-only wildcard match (the reference's Regex.simpleMatch): unlike
    fnmatch, `?` and `[...]` are literal characters, so an alias named
    `logs-[old]` can be addressed exactly."""
    parts = pattern.split("*")
    if len(parts) == 1:
        return name == pattern
    if not name.startswith(parts[0]) or not name.endswith(parts[-1]):
        return False
    pos = len(parts[0])
    for mid in parts[1:-1]:
        i = name.find(mid, pos,
                      len(name) - len(parts[-1]) if parts[-1] else None)
        if i < 0:
            return False
        pos = i + len(mid)
    return pos + len(parts[-1]) <= len(name)


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
        # alias name -> config ({"filter":..., "routing":...,
        # "is_write_index":...}); the per-index slice of AliasMetadata
        self.aliases: dict[str, dict] = {}
        # the _stats API's index-level search totals and stat groups
        self.search_stats = {"query_total": 0, "fetch_total": 0}
        self.search_group_stats: dict[str, dict] = {}
        durability = translog_durability(settings)
        self.shards: dict[int, IndexShard] = {
            s: IndexShard(ShardId(name, s), path / str(s),
                          self.mapper_service, durability=durability,
                          device=device)
            for s in range(self.num_shards)
        }

    def setting(self, key: str, default=None):
        """An index setting by dotted key, bare or "index."-prefixed
        (IndexSettings.getValue); `self.settings` holds the nested form."""
        flat = Settings.from_nested(self.settings or {}).as_dict()
        if key in flat:
            return flat[key]
        return flat.get(f"index.{key}", default)

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
        # scroll and PIT reader contexts (SearchService's ReaderContext
        # registry): each pins one searcher snapshot a shard
        self._reader_contexts: dict[str, dict] = {}
        self._state_file = self.data_path / "indices.json"
        # every registered index reopens on this node's device, each shard
        # from its commit and translog
        self._recover_indices()
        from opensearch_tpu_torch.common.breaker import HierarchyBreakerService
        from opensearch_tpu_torch.index.request_cache import RequestCache
        from opensearch_tpu_torch.search.backpressure import (
            SearchBackpressureService,
        )
        from opensearch_tpu_torch.tasks import TaskManager
        from opensearch_tpu_torch.wlm import QueryGroupService

        self.task_manager = TaskManager(node_name)
        self.breakers = HierarchyBreakerService()
        self.search_backpressure = SearchBackpressureService(
            self.task_manager)
        self.query_groups = QueryGroupService(
            self.data_path / "query_groups.json")
        self.request_cache = RequestCache()
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
        from opensearch_tpu_torch.common.monitor import MonitorService
        from opensearch_tpu_torch.ingest import IngestService

        from opensearch_tpu_torch.index.pressure import IndexingPressure

        self.ingest = IngestService(self.data_path / "ingest_pipelines.json")
        self.monitor = MonitorService(self.data_path)
        # every write entry point accounts its bytes (IndexingPressure)
        self.indexing_pressure = IndexingPressure()
        from opensearch_tpu_torch.search import lanes

        # the priority lanes' depths and sheds: the HTTP server submits
        # against this tracker, the `tail` stats section reads it
        self.lane_tracker = lanes.LaneTracker()
        self.search_slowlog = SlowLog("search")
        self.indexing_slowlog = SlowLog("indexing")
        self._configure_slowlogs()
        # the persisted dynamic settings re-apply at boot
        self.get_cluster_settings()
        self._apply_dynamic_node_settings()

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

    # -- index lifecycle ---------------------------------------------------

    def _persist_index_registry(self) -> None:
        self.data_path.mkdir(parents=True, exist_ok=True)
        registry = {
            name: {
                "settings": svc.settings,
                "mappings": svc.mapper_service.to_dict(),
                "aliases": svc.aliases,
            }
            for name, svc in list(self.indices.items())
        }
        self._state_file.write_text(json.dumps(registry))

    def _recover_indices(self) -> None:
        """Reopen every index of the registry: each shard's engine loads
        its committed segments to the node's device, under the residency
        ledger's upload_scope (index/engine.py ``_recover``), and replays
        its translog tail."""
        if not self._state_file.exists():
            return
        registry = json.loads(self._state_file.read_text())
        for name, meta in registry.items():
            svc = IndexService(name, self._index_path(name),
                               meta["settings"], meta["mappings"],
                               self.device)
            svc.aliases = meta.get("aliases", {})
            self.indices[name] = svc

    def create_index(self, name: str, body: dict | None = None) -> dict:
        if not _valid_index_name(name):
            raise IllegalArgumentException(f"invalid index name [{name}]")
        if name in self.indices:
            raise ResourceAlreadyExistsException(f"index [{name}] already exists")
        body = body or {}
        unknown = set(body) - {"settings", "mappings", "aliases"}
        if unknown:
            raise not_yet_ported(f"create-index keys {sorted(unknown)}")
        settings = body.get("settings") or {}
        mappings = body.get("mappings")
        aliases = dict(body.get("aliases") or {})
        # composable index templates: the template layers under the body
        tmpl = self._template_for_index(name)
        if tmpl is not None:
            settings = _deep_merge(tmpl["settings"], settings)
            mappings = _deep_merge(tmpl["mappings"], mappings or {}) or None
            aliases = {**tmpl["aliases"], **aliases}
        # accept both flat ("index.number_of_shards") and nested forms
        flat = Settings.from_nested(settings).as_dict()
        norm = {(k[len("index."):] if k.startswith("index.") else k): v
                for k, v in flat.items()}
        nested = Settings.from_flat(norm).as_nested()
        svc = IndexService(
            name, self._index_path(name), nested, mappings, self.device)
        for alias, conf in aliases.items():
            if alias in self.indices:
                svc.close()
                raise IllegalArgumentException(
                    f"alias [{alias}] clashes with an index name")
            svc.aliases[alias] = dict(conf or {})
        self.indices[name] = svc
        self._persist_index_registry()
        self._configure_slowlogs()
        return {"acknowledged": True, "shards_acknowledged": True, "index": name}

    def _index_path(self, name: str) -> Path:
        return self.data_path / "indices" / name

    def delete_index(self, expr: str, *, ignore_unavailable: bool = False,
                     allow_no_indices: bool = True) -> dict:
        """DELETE /{index}: every named index (every index for `_all` and
        `*`, the concrete indices a pattern matches, less a later "-"
        exclusion) closes, leaves the node, has its stacked serving slabs
        released from device memory and its files removed; an alias name
        is refused (strict concrete-index resolution)."""
        alias_map = self._alias_map()
        targets: list[str] = []
        matched_any = False
        wildcard_seen = False
        for part in expr.split(","):
            part = part.strip()
            if part in ("_all", "*"):
                targets.extend(list(self.indices))
                matched_any = True
            elif part.startswith("-") and wildcard_seen:
                # an exclusion after a pattern drops what it names
                targets = [n for n in targets
                           if not fnmatch.fnmatch(n, part[1:])]
            elif _has_wildcard(part):
                wildcard_seen = True
                hits = [n for n in list(self.indices)
                        if fnmatch.fnmatch(n, part)]
                targets.extend(hits)
                matched_any = matched_any or bool(hits)
                if not hits and not allow_no_indices:
                    # per expression: an empty pattern fails fast
                    raise IndexNotFoundException(part)
            elif part in alias_map:
                if ignore_unavailable:
                    continue
                raise IllegalArgumentException(
                    f"The provided expression [{part}] matches an alias, "
                    f"specify the corresponding concrete indices instead.")
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
        self._persist_index_registry()
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

    @staticmethod
    def _resolve_date_math_name(name: str) -> str:
        """"<logstash-{now/M}>" -> "logstash-2026.07.01"
        (IndexNameExpressionResolver.DateMathExpressionResolver; default
        format uuuu.MM.dd, rounding by the date-math unit)."""
        if not (name.startswith("<") and name.endswith(">")):
            return name
        import datetime as _dt

        inner = name[1:-1]

        def repl(m):
            expr = m.group(1)
            fmt = "%Y.%m.%d"
            if "{" in expr:  # a custom format: {now/M{yyyy.MM}}
                expr, _, f = expr.partition("{")
                f = f.rstrip("}")
                fmt = (f.replace("yyyy", "%Y").replace("uuuu", "%Y")
                       .replace("MM", "%m").replace("dd", "%d"))
            now = _dt.datetime.now(_dt.timezone.utc)
            rest = expr[3:] if expr.startswith("now") else ""
            while rest:
                m2 = re.match(r"([+-]\d+[yMwdhHms]|/[yMwdhHms])", rest)
                if not m2:
                    break
                op = m2.group(1)
                rest = rest[len(op):]
                if op.startswith("/"):
                    unit = op[1:]
                    if unit == "M":
                        now = now.replace(day=1, hour=0, minute=0,
                                          second=0, microsecond=0)
                    elif unit == "d":
                        now = now.replace(hour=0, minute=0, second=0,
                                          microsecond=0)
                    elif unit == "y":
                        now = now.replace(month=1, day=1, hour=0, minute=0,
                                          second=0, microsecond=0)
                else:
                    sign = 1 if op[0] == "+" else -1
                    n_, unit = int(op[1:-1]), op[-1]
                    delta = {"d": _dt.timedelta(days=n_),
                             "w": _dt.timedelta(weeks=n_),
                             "h": _dt.timedelta(hours=n_),
                             "H": _dt.timedelta(hours=n_),
                             "m": _dt.timedelta(minutes=n_),
                             "s": _dt.timedelta(seconds=n_)}.get(
                        unit, _dt.timedelta())
                    now = now + sign * delta
            return now.strftime(fmt)

        return re.sub(r"\{([^}]*(?:\{[^}]*\})?)\}", repl, inner)

    def _is_hidden(self, name: str) -> bool:
        return str(self.indices[name].setting("hidden", False)).lower() \
            == "true"

    def _expression_names(self, expr: str, alias_map: dict,
                          expand: set[str], *, ignore_unavailable: bool,
                          allow_no_indices: bool
                          ) -> list[tuple[str, bool, set[str]]]:
        """(index or alias name, named explicitly, its member indices an
        exclusion dropped) for each part of a comma expression, in order
        (IndexNameExpressionResolver): a concrete name or alias as it
        stands (a missing one 404s unless `ignore_unavailable`), a `*` /
        `?` pattern over index and alias names, and after a pattern a
        "-name" or "-pattern" exclusion of the concrete indices it names
        from everything selected before it. A pattern skips an
        `index.hidden` index (or an `is_hidden` alias) unless `expand`
        holds hidden or all; a dot pattern still reaches a dot-prefixed
        hidden index."""
        wildcards_on = "none" not in expand
        show_hidden = bool(expand & {"hidden", "all"})
        candidates = sorted(set(self.indices) | set(alias_map))
        selected: dict[str, tuple[bool, set[str]]] = {}
        wildcard_seen = False
        for part in expr.split(","):
            part = self._resolve_date_math_name(part.strip())
            if part.startswith("-") and wildcard_seen:
                pat = part[1:]
                dropped = {m for n in candidates
                           if fnmatch.fnmatch(n, pat)
                           for m in alias_map.get(n, [n])}
                for _explicit, drops in selected.values():
                    drops |= dropped
                continue
            if _has_wildcard(part):
                wildcard_seen = True
                if not wildcards_on:
                    continue
                matched = False
                for n in candidates:
                    if not fnmatch.fnmatch(n, part):
                        continue
                    if not show_hidden and self._hidden_name(
                            n, alias_map) and not (
                            part.startswith(".") and n.startswith(".")):
                        continue
                    selected[n] = (selected.get(n, (False,))[0], set())
                    matched = True
                if not matched and not allow_no_indices:
                    raise IndexNotFoundException(part)
            elif part in alias_map or part in self.indices:
                selected[part] = (True, set())
            elif not ignore_unavailable:
                raise IndexNotFoundException(part)
        return [(n, explicit, drops)
                for n, (explicit, drops) in selected.items()]

    def _hidden_name(self, name: str, alias_map: dict) -> bool:
        if name in alias_map:
            return any(str((self.indices[m].aliases.get(name) or {}).get(
                "is_hidden", False)).lower() == "true"
                for m in alias_map[name] if m in self.indices)
        return self._is_hidden(name)

    def resolve_indices(self, expr: str, *, ignore_unavailable: bool = False,
                        allow_no_indices: bool = True,
                        expand_wildcards: str = "open") -> list[str]:
        """Index name, pattern and alias resolution (comma lists, `*` / `?`
        patterns over index AND alias names, "-" exclusions, date math,
        `_all`); aliases expand to their member indices, as the
        reference's IndexNameExpressionResolver does.
        `ignore_unavailable` drops missing concrete names instead of a
        404; `expand_wildcards=none` turns patterns off, `hidden` / `all`
        lets them reach hidden indices, and every index is open (close is
        not ported), so `closed` alone matches nothing; an empty result
        404s when `allow_no_indices` is false."""
        alias_map = self._alias_map()
        expand = {w.strip() for w in str(expand_wildcards).split(",")}
        # every index is open: a pattern selects it unless only closed
        # indices are asked for
        open_ok = "open" in expand or "all" in expand or \
            not (expand & {"open", "closed"})
        if expr in ("_all", "*", ""):
            names = ([n for n in sorted(self.indices)
                      if not self._is_hidden(n)
                      or expand & {"hidden", "all"}]
                     if "none" not in expand and open_ok else [])
            if not names and not allow_no_indices:
                raise IndexNotFoundException(expr or "_all")
            return names
        names: list[str] = []
        for name, explicit, dropped in self._expression_names(
                expr, alias_map, expand,
                ignore_unavailable=ignore_unavailable,
                allow_no_indices=allow_no_indices):
            if not explicit and not open_ok:
                continue
            names.extend(m for m in alias_map.get(name, [name])
                         if m not in dropped)
        if not names and not allow_no_indices:
            raise IndexNotFoundException(expr)
        return list(dict.fromkeys(names))

    # -- aliases (AliasMetadata + TransportIndicesAliasesAction) -------------

    def _alias_map(self) -> dict[str, list[str]]:
        """alias name -> sorted member index names, over a list() snapshot:
        searches resolve aliases on the parallel pool while the serial
        data worker may be inserting or deleting indices."""
        out: dict[str, list[str]] = {}
        for name, svc in list(self.indices.items()):
            for alias in list(svc.aliases):
                out.setdefault(alias, []).append(name)
        return {a: sorted(ns) for a, ns in out.items()}

    def update_aliases(self, body: dict) -> dict:
        """POST /_aliases: add, remove and remove_index actions, validated
        and staged first, then applied at once (one cluster-state update in
        the reference); a remove naming no existing alias fails the whole
        request with 404 unless `must_exist` is false."""
        actions = (body or {}).get("actions")
        if not isinstance(actions, list) or not actions:
            raise IllegalArgumentException("[aliases] requires [actions]")
        staged: list[tuple[str, str, str, dict | None]] = []
        # indices removed by THIS request: an added alias may take a name
        # a remove_index in the same atomic batch is freeing
        removing_indices: set[str] = set()
        for action in actions:
            if isinstance(action, dict) and "remove_index" in action:
                conf0 = action["remove_index"]
                if isinstance(conf0, dict):
                    for iexpr in (conf0.get("indices")
                                  or ([conf0["index"]]
                                      if conf0.get("index") else [])):
                        try:
                            removing_indices.update(self.resolve_indices(
                                iexpr, expand_wildcards="all"))
                        except OpenSearchTpuException:
                            pass
        for action in actions:
            if not isinstance(action, dict) or len(action) != 1:
                raise IllegalArgumentException(
                    "each alias action must be a single-key object")
            kind, conf = next(iter(action.items()))
            if kind not in ("add", "remove", "remove_index"):
                raise IllegalArgumentException(f"unknown alias action [{kind}]")
            if not isinstance(conf, dict):
                raise IllegalArgumentException(
                    f"[aliases] action [{kind}] requires an object body")
            indices = conf.get("indices") or (
                [conf["index"]] if conf.get("index") else [])
            aliases = conf.get("aliases") or (
                [conf["alias"]] if conf.get("alias") else [])
            resolved: list[str] = []
            for iexpr in indices:
                resolved.extend(self.resolve_indices(
                    iexpr, expand_wildcards="all"))
            if not resolved:
                raise IllegalArgumentException(
                    f"[aliases] action [{kind}] requires an index")
            if kind == "remove_index":
                staged.extend((kind, name, "", None) for name in resolved)
                continue
            if not aliases:
                if "aliases" in conf:
                    raise IllegalArgumentException("[aliases] can't be empty")
                raise IllegalArgumentException(
                    f"[aliases] action [{kind}] requires an alias")
            for name in resolved:
                for alias in aliases:
                    if kind == "add" and alias in self.indices \
                            and alias not in removing_indices:
                        raise IllegalArgumentException(
                            f"alias [{alias}] clashes with an index name")
                    staged.append((kind, name, alias, conf))
        # removes must name an alias that exists somewhere in the action's
        # scope: the whole request fails with aliases_not_found (404) before
        # anything changes (must_exist=false opts out)
        remove_matched: dict[str, bool] = {}
        remove_opt_out: set[str] = set()
        for kind, name, alias, conf in staged:
            if kind != "remove":
                continue
            if (conf or {}).get("must_exist") is False:
                remove_opt_out.add(alias)
            svc = self._get_index(name)
            hit = alias in svc.aliases or any(
                simple_match(a, alias) for a in svc.aliases)
            remove_matched[alias] = remove_matched.get(alias, False) or hit
        missing = sorted(a for a, hit in remove_matched.items()
                         if not hit and a not in remove_opt_out)
        if missing:
            raise ResourceNotFoundException(
                f"aliases [{','.join(missing)}] missing")
        # alias changes first, index deletions last: a remove_index in the
        # middle of the list must not invalidate later staged actions
        to_delete = [n for k, n, _, _ in staged if k == "remove_index"]
        for kind, name, alias, conf in staged:
            if kind == "remove_index":
                continue
            svc = self._get_index(name)
            if kind == "add":
                entry: dict = {}
                for key in ("filter", "routing", "index_routing",
                            "search_routing", "is_write_index", "is_hidden"):
                    if conf.get(key) is not None:
                        entry[key] = conf[key]
                svc.aliases[alias] = entry
            else:
                for a in list(svc.aliases):
                    if a == alias or simple_match(a, alias):
                        del svc.aliases[a]
        for name in to_delete:
            # by CONCRETE name: an add in this batch may have just taken
            # the name as an alias
            svc = self.indices.pop(name, None)
            if svc is not None:
                svc.close()
                shard_mesh.default_registry.invalidate_index(name)
                shutil.rmtree(self._index_path(name), ignore_errors=True)
        if to_delete:
            self._configure_slowlogs()
        self._persist_index_registry()
        return {"acknowledged": True}

    def put_alias(self, index_expr: str, alias: str,
                  body: dict | None = None) -> dict:
        conf = dict(body or {})
        conf["alias"] = alias
        conf["indices"] = self.resolve_indices(index_expr,
                                               expand_wildcards="all")
        return self.update_aliases({"actions": [{"add": conf}]})

    def delete_alias(self, index_expr: str, alias_expr: str) -> dict:
        names = self.resolve_indices(index_expr, expand_wildcards="all")
        removed = False
        for name in names:
            svc = self._get_index(name)
            for alias in list(svc.aliases):
                if alias_expr in ("_all", "*") or fnmatch.fnmatch(
                        alias, alias_expr):
                    del svc.aliases[alias]
                    removed = True
        if not removed:
            raise ResourceNotFoundException(
                f"aliases [{alias_expr}] missing on indices {names}")
        self._persist_index_registry()
        return {"acknowledged": True}

    def get_alias(self, index_expr: str | None = None,
                  alias_expr: str | None = None,
                  expand_wildcards: str = "all") -> dict:
        """GET [/{index}]/_alias[/{name}] (TransportGetAliasesAction):
        `name` takes comma lists, wildcards and "-pattern" exclusions
        applied in order; a CONCRETE requested alias that resolves to
        nothing makes the whole response a 404 that still carries the
        found entries (the handler reads the `status` / `error` riders)."""
        names = (self.resolve_indices(index_expr,
                                      expand_wildcards=expand_wildcards)
                 if index_expr else sorted(self.indices))

        def echo(conf: dict) -> dict:
            # "routing" renders as index_routing + search_routing
            # (AliasMetadata's response shape); routing values are strings
            conf = dict(conf or {})
            if "routing" in conf:
                conf.setdefault("index_routing", str(conf["routing"]))
                conf.setdefault("search_routing", str(conf["routing"]))
                del conf["routing"]
            for k in ("index_routing", "search_routing"):
                if k in conf:
                    conf[k] = str(conf[k])
            return conf

        all_alias_names = {
            a for name in names for a in self._get_index(name).aliases}
        if alias_expr in ("_all", "*"):
            alias_expr = "*"  # explicit catch-all: alias-less indices drop
        parts = ([p.strip() for p in str(alias_expr).split(",") if p.strip()]
                 if alias_expr not in (None, "") else None)
        missing: list[str] = []
        selected: set | None = None
        if parts is not None:
            selected = set()
            # a leading "-name" with nothing selected yet is a LITERAL
            # alias request (dash included) and 404s; once any wildcard or
            # plain part appeared, "-x" is a plain exclusion
            active = False
            for part in parts:
                wildcard = "*" in part or "?" in part
                if part.startswith("-"):
                    pat = part[1:]
                    hits = {a for a in selected if fnmatch.fnmatch(a, pat)}
                    if hits:
                        selected -= hits
                    elif not wildcard and not active:
                        missing.append(part)
                    if wildcard:
                        active = True
                elif wildcard:
                    selected |= {a for a in all_alias_names
                                 if fnmatch.fnmatch(a, part)}
                    active = True
                else:
                    active = True
                    if part in all_alias_names:
                        selected.add(part)
                    else:
                        missing.append(part)
        out: dict[str, Any] = {}
        for name in names:
            svc = self._get_index(name)
            matched = {a: echo(c) for a, c in svc.aliases.items()
                       if selected is None or a in selected}
            if matched or parts is None:
                out[name] = {"aliases": matched}
        if missing:
            missing.sort()
            label = "aliases" if len(missing) > 1 else "alias"
            out["error"] = f"{label} [{','.join(missing)}] missing"
            out["status"] = 404
        return out

    def resolve_write_target(self, name: str, for_write: bool = True) -> str:
        """Alias -> its write index (TransportBulkAction's write-alias
        resolution); a concrete name passes through (and may autocreate).
        Reads (`for_write=False`) ignore write-index designations."""
        targets = self._alias_targets(name)
        if not targets:
            return name
        if len(targets) == 1:
            if for_write and targets[0][1].get("is_write_index") is False:
                raise IllegalArgumentException(
                    f"no write index is defined for alias [{name}]. The "
                    f"write index may be explicitly disabled using "
                    f"is_write_index=false or the alias points to multiple "
                    f"indices without one being designated as a write index")
            return targets[0][0]
        writes = [n for n, c in targets if c.get("is_write_index")]
        if not for_write and len(writes) != 1:
            names_l = ", ".join(sorted(n for n, _c in targets))
            raise IllegalArgumentException(
                f"alias [{name}] has more than one index associated with "
                f"it [{names_l}], can't execute a single index op")
        if len(writes) != 1:
            raise IllegalArgumentException(
                f"no write index is defined for alias [{name}]. The write "
                f"index may be explicitly disabled using is_write_index="
                f"false or the alias points to multiple indices without one "
                f"being designated as a write index")
        return writes[0]

    def _resolve_write_alias(self, index: str, routing: str | None,
                             for_write: bool = True
                             ) -> tuple[str, str | None]:
        """(concrete index, effective routing) for a write or a read by
        id: the alias's write index, and its index routing where the
        request names none."""
        concrete = self.resolve_write_target(index, for_write=for_write)
        if concrete != index and routing is None:
            conf = self.indices[concrete].aliases.get(index) or {}
            routing = conf.get("index_routing", conf.get("routing"))
        return concrete, routing

    def _alias_targets(self, alias: str) -> list[tuple[str, dict]]:
        return [(name, svc.aliases[alias])
                for name, svc in sorted(list(self.indices.items()))
                if alias in svc.aliases]

    def resolve_search_shards(self, expr: str,
                              ignore_unavailable: bool = False
                              ) -> tuple[list, list, list]:
        """(shards, per-shard alias filter bodies, index names) for a
        search expression. A filtered alias contributes its filter to
        exactly its member shards (the per-shard aliasFilter of
        ShardSearchRequest); an unfiltered route to an index drops its
        filters, and two filtered aliases of one index OR theirs."""
        alias_map = self._alias_map()
        per_index_filters: dict[str, list] = {}
        names: list[str] = []

        def add_index(name: str, filt: dict | None) -> None:
            if name not in per_index_filters:
                names.append(name)
                per_index_filters[name] = []
            if filt is not None:
                per_index_filters[name].append(filt)
            else:
                per_index_filters[name] = [None]

        if expr in ("_all", "*", ""):
            for name in self.resolve_indices(expr):
                add_index(name, None)
        else:
            for name, _explicit, dropped in self._expression_names(
                    expr, alias_map, {"open"},
                    ignore_unavailable=ignore_unavailable,
                    allow_no_indices=True):
                if name in alias_map:
                    for member, conf in self._alias_targets(name):
                        if member not in dropped:
                            add_index(member, conf.get("filter"))
                elif name not in dropped:
                    add_index(name, None)
        shards: list = []
        filters: list = []
        for name in names:
            flist = per_index_filters[name]
            if None in flist or not flist:
                filt = None
            elif len(flist) == 1:
                filt = flist[0]
            else:
                filt = {"bool": {"should": flist, "minimum_should_match": 1}}
            for shard in self._get_index(name).shards.values():
                shards.append(shard)
                filters.append(filt)
        return shards, filters, names

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
        t0 = time.monotonic()
        with self.indexing_pressure.acquire(
                len(json.dumps(source)) if source is not None else 0,
                "index"):
            resp, shard = self._index_doc(
                index, doc_id, source, routing, op_type or "index",
                if_seq_no, version, version_type, if_primary_term,
                pipeline=pipeline)
            if shard is None:  # an ingest drop: nothing was written
                return resp
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
                   if_primary_term: int | None = None,
                   pipeline: str | None = None
                   ) -> tuple[dict, IndexShard | None]:
        """(response, the shard written): the write runs the ingest
        pipelines first (``_run_pipelines``), so the shard is the one the
        document landed on after an ``_index`` / ``_routing`` reroute, and
        None when a ``drop`` discarded it."""
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
        index, routing = self._resolve_write_alias(index, routing)
        landed = self._run_pipelines(pipeline, index, doc_id, source, routing)
        if landed is None:
            return {
                "_index": index, "_id": doc_id, "_version": -3,
                "result": "noop",
                "_shards": {"total": 0, "successful": 0, "failed": 0},
                "_seq_no": 0, "_primary_term": 0,
            }, None
        index, doc_id, source, routing = landed
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
        mappers_before = len(svc.mapper_service.mappers)
        result = shard.apply_index_on_primary(
            doc_id, source, routing, if_seq_no=if_seq_no, version=version,
            version_type=version_type)
        if len(svc.mapper_service.mappers) != mappers_before:
            # a dynamic mapping update: the registry keeps the new fields
            # for a restart
            self._persist_index_registry()
        return self._write_response(index, doc_id, result), shard

    def _run_pipelines(self, pipeline: str | None, index: str,
                       doc_id: str | None, source: dict,
                       routing: str | None) -> tuple | None:
        """The ingest chain of a write, resolved BEFORE any auto-creation
        (so a drop or an ``_index`` reroute leaves no stray empty index):
        the request's pipeline, else the target's
        ``index.default_pipeline`` ("_none" is none), then the
        ``index.final_pipeline`` of the index the document lands in. An
        index the write will auto-create takes them from the template
        that will create it (IngestService.resolvePipelines reads the
        matching template), where the reference reads none.
        (index, id, source, routing) after the pipelines, or None for a
        drop."""
        def setting_of(name: str, key: str):
            svc = self.indices.get(name)
            if svc is not None:
                return _index_setting(svc.settings, key)
            tmpl = self._template_for_index(name)
            return (_index_setting(tmpl["settings"], key)
                    if tmpl is not None else None)

        resolved = pipeline
        if resolved is None:
            resolved = setting_of(index, "default_pipeline")
        if resolved == "_none":
            resolved = None
        chain = [resolved] if resolved else []
        ran_final = False
        while chain or not ran_final:
            if chain:
                pipe_id = chain.pop(0)
            else:
                ran_final = True
                pipe_id = setting_of(index, "final_pipeline")
                if not pipe_id or pipe_id == "_none":
                    break
            out = self.ingest.execute(pipe_id, index, doc_id, source,
                                      routing)
            if out is None:
                return None
            source = out.source
            index = out.meta["_index"]
            doc_id = out.meta["_id"]
            routing = out.meta["_routing"]
        return index, doc_id, source, routing

    def get_doc(self, index: str, doc_id: str, routing: str | None = None,
                realtime: bool = True, version: int | None = None,
                refresh: bool = False) -> dict:
        """Realtime GET through the shard's version map and buffer
        (IndexShard.get); `refresh` refreshes the shard first. An alias
        with one member reads from it."""
        index, routing = self._resolve_write_alias(index, routing,
                                                   for_write=False)
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
        # a delete carries no source: a small fixed cost is accounted
        with self.indexing_pressure.acquire(64, "delete"):
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
        index, routing = self._resolve_write_alias(index, routing)
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
        if require_alias and index not in self._alias_map():
            e = IndexNotFoundException(index)
            e.reason = (
                f"no such index [{index}] and [require_alias] request "
                f"flag is [true] and [{index}] is not an alias")
            raise e
        with self.indexing_pressure.acquire(len(json.dumps(body)), "update"):
            out, shard = self._update_doc(index, doc_id, body, routing,
                                          if_seq_no)
            if shard is not None:
                shard.maybe_sync_translog()
        if shard is not None and refresh:
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
        index, routing = self._resolve_write_alias(index, routing)
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
             refresh: bool = False, pipeline: str | None = None,
             query_group: str | None = None,
             payload_bytes: int | None = None) -> dict:
        """operations: [(action, metadata, source)]; action in
        index|create|update|delete. The translog is fsynced once per
        request for every shard it touched, before the response, as the
        reference does under durability=request. `query_group` tags the
        request for its workload group's bulk admission (a 429 past the
        group's slot share); the request runs as a non-cancellable
        ``indices:data/write/bulk`` task. Its bytes (`payload_bytes`, the
        HTTP body's size, else the sources serialized) count against the
        indexing pressure budget."""
        t0 = time.monotonic()
        if payload_bytes is None:
            payload_bytes = sum(len(json.dumps(source))
                                for _, _, source in operations
                                if source is not None)
        release_admission = self.query_groups.admit_bulk(query_group)
        try:
            with self.indexing_pressure.acquire(int(payload_bytes), "bulk"), \
                    self.task_manager.task_scope(
                        "indices:data/write/bulk",
                        description=f"requests[{len(operations)}]",
                        cancellable=False):
                return self._bulk_inner(operations, refresh, pipeline, t0)
        finally:
            release_admission()

    def _bulk_inner(self, operations: list, refresh: bool,
                    pipeline: str | None, t0: float) -> dict:
        """Each item as the reference's bulk runs it; an index or create
        item takes its own ``pipeline`` over the request's. The shards
        touched are the ones the documents landed on after the pipelines'
        reroutes, and only those are synced and refreshed."""
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
                if meta.get("require_alias") in (True, "true") and \
                        index not in self._alias_map():
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
                                         else None),
                        pipeline=meta.get("pipeline", pipeline))
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

    # -- index templates (MetadataIndexTemplateService: composable
    # templates, component templates and legacy /_template ones) ------------

    def _templates_file(self) -> Path:
        return self.data_path / "templates.json"

    def _load_templates(self) -> dict:
        if self._templates_file().exists():
            return json.loads(self._templates_file().read_text())
        return {"index_templates": {}, "component_templates": {}}

    def _save_templates(self, data: dict) -> None:
        self.data_path.mkdir(parents=True, exist_ok=True)
        self._templates_file().write_text(json.dumps(data))

    def put_index_template(self, name: str, body: dict) -> dict:
        body = body or {}
        patterns = body.get("index_patterns")
        if not isinstance(patterns, list) or not patterns:
            raise IllegalArgumentException(
                "index template requires [index_patterns]"
            )
        data = self._load_templates()
        for comp in body.get("composed_of") or []:
            if comp not in data["component_templates"]:
                raise IllegalArgumentException(
                    f"component template [{comp}] not found"
                )
        data["index_templates"][name] = body
        self._save_templates(data)
        return {"acknowledged": True}

    def get_index_template(self, name: str | None = None) -> dict:
        data = self._load_templates()
        if name is None:
            items = data["index_templates"]
        else:
            items = {
                n: t for n, t in data["index_templates"].items()
                if fnmatch.fnmatch(n, name)
            }
            if not items and "*" not in name:
                raise ResourceNotFoundException(
                    f"index template matching [{name}] not found"
                )
        return {"index_templates": [
            {"name": n, "index_template": t} for n, t in sorted(items.items())
        ]}

    def delete_index_template(self, name: str) -> dict:
        data = self._load_templates()
        if name not in data["index_templates"]:
            raise ResourceNotFoundException(
                f"index template matching [{name}] not found"
            )
        del data["index_templates"][name]
        self._save_templates(data)
        return {"acknowledged": True}

    def put_component_template(self, name: str, body: dict) -> dict:
        if not isinstance((body or {}).get("template"), dict):
            raise IllegalArgumentException(
                "component template requires [template]"
            )
        data = self._load_templates()
        data["component_templates"][name] = body
        self._save_templates(data)
        return {"acknowledged": True}

    def get_component_template(self, name: str | None = None) -> dict:
        data = self._load_templates()
        items = data["component_templates"]
        if name is not None:
            if name not in items:
                raise ResourceNotFoundException(
                    f"component template matching [{name}] not found"
                )
            items = {name: items[name]}
        return {"component_templates": [
            {"name": n, "component_template": t} for n, t in sorted(items.items())
        ]}

    def delete_component_template(self, name: str) -> dict:
        data = self._load_templates()
        if name not in data["component_templates"]:
            raise ResourceNotFoundException(
                f"component template matching [{name}] not found"
            )
        del data["component_templates"][name]
        self._save_templates(data)
        return {"acknowledged": True}

    # -- legacy (v1) templates: /_template (MetadataIndexTemplateService
    # legacy API; composable /_index_template templates shadow these) ------

    def put_legacy_template(self, name: str, body: dict,
                            create: bool = False) -> dict:
        body = body or {}
        patterns = body.get("index_patterns")
        if isinstance(patterns, str):
            patterns = [patterns]
        if not patterns:
            raise IllegalArgumentException(
                f"index_template [{name}] index patterns are missing"
            )
        data = self._load_templates()
        legacy = data.setdefault("legacy_templates", {})
        if create and name in legacy:
            raise IllegalArgumentException(
                f"index_template [{name}] already exists"
            )
        # settings persist FLAT with the index. prefix and string values
        # (IndexTemplateMetadata stores Settings; GET re-nests by default)
        flat_settings = {}
        for k, v in Settings.from_nested(
                body.get("settings") or {}).as_dict().items():
            if not k.startswith("index."):
                k = f"index.{k}"
            flat_settings[k] = str(v) if not isinstance(v, (dict, list)) \
                else v
        aliases = {}
        for aname, conf in (body.get("aliases") or {}).items():
            conf = dict(conf or {})
            routing = conf.pop("routing", None)
            if routing is not None:
                conf.setdefault("index_routing", str(routing))
                conf.setdefault("search_routing", str(routing))
            aliases[aname] = conf
        entry: dict[str, Any] = {
            "order": int(body.get("order", 0)),
            "index_patterns": list(patterns),
            "settings": flat_settings,
            "mappings": body.get("mappings") or {},
            "aliases": aliases,
        }
        if body.get("version") is not None:
            entry["version"] = int(body["version"])
        legacy[name] = entry
        self._save_templates(data)
        return {"acknowledged": True}

    def get_legacy_templates(self, name: str | None = None) -> dict:
        legacy = self._load_templates().get("legacy_templates", {})
        if name is None:
            return dict(sorted(legacy.items()))
        out = {}
        for pat in str(name).split(","):
            for n, t in legacy.items():
                if fnmatch.fnmatch(n, pat):
                    out[n] = t
        if not out and not any(c in str(name) for c in "*,?"):
            raise ResourceNotFoundException(
                f"index_template [{name}] missing"
            )
        return dict(sorted(out.items()))

    def delete_legacy_template(self, name: str) -> dict:
        data = self._load_templates()
        legacy = data.setdefault("legacy_templates", {})
        victims = [n for n in legacy if fnmatch.fnmatch(n, name)]
        if not victims and not any(c in name for c in "*?"):
            raise ResourceNotFoundException(
                f"index_template [{name}] missing"
            )
        for n in victims:
            del legacy[n]
        self._save_templates(data)
        return {"acknowledged": True}

    def _legacy_template_for_index(self, name: str) -> dict | None:
        """Merged {settings, mappings, aliases} of matching v1 templates,
        ascending order (higher order overrides)."""
        legacy = self._load_templates().get("legacy_templates", {})
        matching = sorted(
            (t for t in legacy.values()
             if any(fnmatch.fnmatch(name, p) for p in t["index_patterns"])),
            key=lambda t: int(t.get("order", 0)),
        )
        if not matching:
            return None
        merged: dict = {"settings": {}, "mappings": {}, "aliases": {}}
        for t in matching:
            merged["settings"] = _deep_merge(
                merged["settings"], t.get("settings") or {})
            merged["mappings"] = _deep_merge(
                merged["mappings"], t.get("mappings") or {})
            merged["aliases"].update(t.get("aliases") or {})
        return merged

    def _template_for_index(self, name: str) -> dict | None:
        """Composed {settings, mappings, aliases} of the highest-priority
        matching template (components first, template's own last).
        Composable templates shadow legacy /_template ones entirely."""
        data = self._load_templates()
        best = None
        best_prio = -1
        for tmpl in data["index_templates"].values():
            if any(fnmatch.fnmatch(name, p) for p in tmpl["index_patterns"]):
                prio = int(tmpl.get("priority", 0))
                if prio > best_prio:
                    best, best_prio = tmpl, prio
        if best is None:
            return self._legacy_template_for_index(name)
        merged: dict = {"settings": {}, "mappings": {}, "aliases": {}}
        layers = [
            data["component_templates"].get(c, {}).get("template", {})
            for c in best.get("composed_of") or []
        ]
        layers.append(best.get("template") or {})
        for layer in layers:
            merged["settings"] = _deep_merge(
                merged["settings"], layer.get("settings") or {}
            )
            merged["mappings"] = _deep_merge(
                merged["mappings"], layer.get("mappings") or {}
            )
            merged["aliases"].update(layer.get("aliases") or {})
        return merged

    # -- refresh / search ----------------------------------------------------

    def refresh(self, index: str = "_all") -> dict:
        count = 0
        for name in self.resolve_indices(index):
            for shard in self._get_index(name).shards.values():
                shard.refresh()
                count += 1
        return {"_shards": {"total": count, "successful": count, "failed": 0}}

    def flush(self, index: str = "_all") -> dict:
        """POST [/{index}]/_flush: each shard's engine commits (refresh,
        segments and commit point to disk, translog rolled)."""
        count = 0
        for name in self.resolve_indices(index):
            for shard in self._get_index(name).shards.values():
                shard.flush()
                count += 1
        return {"_shards": {"total": count, "successful": count, "failed": 0}}

    def force_merge(self, index: str = "_all", max_num_segments: int = 1,
                    only_expunge_deletes: bool = False,
                    flush: bool = True) -> dict:
        """POST [/{index}]/_forcemerge: each shard's engine fuses its
        segments down to `max_num_segments` (the merged segment published
        to the device), then flushes unless `flush` is false."""
        count = 0
        for name in self.resolve_indices(index):
            for shard in self._get_index(name).shards.values():
                shard.engine.force_merge(
                    max_num_segments=max_num_segments,
                    only_expunge_deletes=only_expunge_deletes)
                if flush:
                    shard.flush()
                count += 1
        return {"_shards": {"total": count, "successful": count, "failed": 0}}

    def search(self, index: str | None = None, body: dict | None = None,
               precomputed_results: list | None = None,
               ignore_unavailable: bool = False,
               search_pipeline: str | None = None,
               scroll: str | None = None,
               query_group: str | None = None,
               request_cache: bool | None = None) -> dict:
        """One search, as the reference's ``search`` runs it: a body's
        ``pit`` reads the point in time's pinned snapshots; otherwise the
        expression resolves to shards and their alias filters, a
        ``scroll`` starts a scroll context, a cacheable body is answered
        from the request cache (keyed by the snapshots acquired first),
        and the search runs behind search backpressure, its workload
        group's admission and an ``indices:data/read/search`` task."""
        body = dict(body or {})
        # per-request stat groups ("stats": [...]) feed the _stats API's
        # search.groups counters (SearchRequest.stats)
        stat_groups = body.get("stats")
        if stat_groups is not None and not isinstance(stat_groups, list):
            raise ParsingException("[stats] must be an array of group names")
        self._count_search(index, stat_groups)
        # the body key is always taken out; the parameter wins over it
        body_pipeline = body.pop("search_pipeline", None)
        pipeline_id = search_pipeline or body_pipeline
        pit = body.pop("pit", None)
        if pit is not None:
            if scroll is not None:
                raise IllegalArgumentException(
                    "[scroll] cannot be used with a point-in-time")
            if index is not None:
                raise IllegalArgumentException(
                    "[pit] cannot be used with an index in the request path")
            ctx = self._resolve_reader_context(str(pit.get("id", "")), "pit")
            if pit.get("keep_alive"):
                ctx["expires_at"] = now_millis() + parse_time_value_millis(
                    pit["keep_alive"], "keep_alive", positive=True)
            pit_names = sorted({s.shard_id.index for s in ctx["shards"]})
            self.search_backpressure.admit()
            with self.task_manager.task_scope(
                    "indices:data/read/search",
                    description=f"pit[{ctx['id']}]") as task:
                resp = self._search_with_pipeline(
                    pipeline_id, pit_names, ctx["shards"], body,
                    acquired=ctx["snapshots"],
                    shard_filters=ctx.get("shard_filters"), task=task)
            resp["pit_id"] = ctx["id"]
            return resp
        sort_spec = body.get("sort")
        for spec in ([sort_spec] if isinstance(sort_spec, (str, dict))
                     else sort_spec or []):
            fname = spec if isinstance(spec, str) else next(iter(spec), None)
            if fname == "_shard_doc":
                raise ActionRequestValidationException(
                    "Validation Failed: 1: [_shard_doc] sort field is only "
                    "supported with point-in-time (PIT) searches;")
        expr = index if index is not None else "_all"
        shards, shard_filters, names = self.resolve_search_shards(
            expr, ignore_unavailable=ignore_unavailable)
        if body.get("indices_boost") is not None:
            body["indices_boost"] = self._resolve_indices_boost(
                body["indices_boost"], ignore_unavailable=ignore_unavailable)
        if scroll is not None:
            if int(body.get("from", 0)) > 0:
                raise IllegalArgumentException(
                    "[from] is not supported with scroll")
            if body.get("search_after") is not None:
                raise IllegalArgumentException(
                    "[search_after] is not supported with scroll")
            if int(body.get("size", search_service.DEFAULT_SIZE)) == 0:
                raise IllegalArgumentException(
                    "[size] cannot be [0] in a scroll context")
            return self._start_scroll(shards, body, scroll,
                                      pipeline_id=pipeline_id, names=names,
                                      shard_filters=shard_filters)
        from opensearch_tpu_torch.index.request_cache import RequestCache

        cache_on = request_cache
        if cache_on is None:
            for n in names:
                svc = self.indices.get(n)
                if svc is not None and str(svc.setting(
                        "requests.cache.enable", True)).lower() == "false":
                    cache_on = False
                    break
        cache_key = None
        cache_snaps = None
        if RequestCache.cacheable(body, cache_on) and \
                precomputed_results is None:
            # acquire the snapshots FIRST and key by THEIR generations: a
            # refresh between a separate generation read and the acquire
            # could cache a pre-refresh response under the post-refresh key
            cache_snaps = [s.acquire_searcher() for s in shards]
            cache_key = RequestCache.key(
                tuple(sorted(names)),
                [(s.shard_id.index, s.shard_id.shard, s.engine.engine_uuid)
                 for s in shards],
                [snap.generation for snap in cache_snaps], body)
            cached = self.request_cache.get(cache_key)
            if cached is not None:
                return json.loads(cached)
        self.search_backpressure.admit()
        with self.query_groups.admit(query_group), \
                self.task_manager.task_scope(
                    "indices:data/read/search",
                    description=f"indices[{expr}]") as task:
            resp = self._search_with_pipeline(
                pipeline_id, names, shards, body, acquired=cache_snaps,
                shard_filters=shard_filters, task=task,
                precomputed_results=precomputed_results)
        if cache_key is not None:
            self.request_cache.put(cache_key, json.dumps(resp, default=str))
        return resp

    def _count_search(self, index: str | None,
                      stat_groups: list | None) -> None:
        """One search on each index its expression names (`_all` for none,
        as a PIT search is too): the index-level query and fetch totals
        and the request's stat groups the _stats API reports, counted as
        the reference counts them, once a search whatever its route (the
        stacked step or the per-shard one)."""
        try:
            for name in self.resolve_indices(
                    index if index is not None else "_all",
                    ignore_unavailable=True):
                svc = self.indices.get(name)
                if svc is None:
                    continue
                svc.search_stats["query_total"] += 1
                svc.search_stats["fetch_total"] += 1
                for g in stat_groups or ():
                    e = svc.search_group_stats.setdefault(str(g), {
                        "query_total": 0, "query_time_in_millis": 0,
                        "query_current": 0, "fetch_total": 0,
                        "fetch_time_in_millis": 0, "fetch_current": 0})
                    e["query_total"] += 1
                    e["fetch_total"] += 1
        except OpenSearchTpuException:
            pass  # stats accounting never fails a search

    def _search_with_pipeline(self, pipeline_id: str | None,
                              index_names: list[str], shards: list,
                              body: dict, acquired: list | None = None,
                              shard_filters: list | None = None, task=None,
                              precomputed_results: list | None = None
                              ) -> dict:
        """search_service.search wrapped in the search pipeline's request
        and response steps. The telemetry (span, metrics, slow log) lives
        here, so PIT and scroll searches are covered too."""
        from opensearch_tpu_torch.search import lanes as lanes_mod
        from opensearch_tpu_torch.telemetry import tracing

        expr = ",".join(index_names) or "_pit"
        body = self._resolve_mlt_doc_refs(body, index_names)
        pl, pr_config = self._resolve_search_pipeline(pipeline_id,
                                                      index_names)
        pl_ctx = {}
        if pl is not None:
            body = self.search_pipelines.transform_request(pl, body)
            if "_original_size" in body:
                pl_ctx["_original_size"] = body.pop("_original_size")
        # activate() scopes library spans and the process-wide singletons'
        # metrics to THIS node; the slowlog and the metrics record inside
        # the span, so the slowlog entry and the histogram exemplar carry
        # its trace id
        metrics = self.telemetry.metrics
        with tracing.activate(self.telemetry.tracer), \
                self.telemetry.tracer.start_span(
                    "search", {"indices": expr}) as span:
            resp = search_service.search(
                shards, body, precomputed_results,
                phase_results_config=pr_config, acquired=acquired,
                shard_filters=shard_filters, task=task)
            took = resp.get("took", 0)
            span.set_attribute("took_ms", took)
            self.search_slowlog.maybe_log(
                took, expr, json.dumps(body.get("query") or {}))
            metrics.counter("search.total").add(1)
            metrics.histogram("search.took_ms").record(took)
            # per-index and per-lane series under the same metric name
            if len(index_names) == 1:
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

    # -- reader contexts: scroll and point in time (ReaderContext registry) --
    #
    # A context holds its shards, one pinned searcher snapshot a shard and
    # its alias filters. The snapshots keep their segments' device tensors
    # alive after a merge or refresh has retired them from the engine (the
    # residency ledger counts the engine's published set, so it
    # under-counts device memory while a context is open, as the
    # reference's does); closing the context drops the last reference.

    def _check_keep_alive(self, keep_ms: int, raw: str) -> None:
        """search.max_keep_alive cap (SearchService.validateKeepAlives)."""
        max_raw = self.effective_cluster_setting("search.max_keep_alive",
                                                 "24h")
        max_ms = parse_time_value_millis(str(max_raw), "search.max_keep_alive",
                                         positive=True)
        if keep_ms > max_ms:
            raise IllegalArgumentException(
                f"Keep alive for request ({raw}) is too large. It must be "
                f"less than ({max_raw}). This limit can be set by changing "
                f"the [search.max_keep_alive] cluster level setting.")

    def _reap_expired_contexts(self) -> None:
        now = now_millis()
        # searches run on the parallel pool: iterate a list() snapshot and
        # pop(), so a context a concurrent reap removed is simply gone
        for cid, ctx in list(self._reader_contexts.items()):
            if ctx["expires_at"] < now:
                self._reader_contexts.pop(cid, None)

    def _resolve_reader_context(self, cid: str, kind: str) -> dict:
        self._reap_expired_contexts()
        ctx = self._reader_contexts.get(cid)
        if ctx is None or ctx["kind"] != kind:
            raise SearchContextMissingException(cid)
        return ctx

    def _start_scroll(self, shards: list, body: dict, scroll: str,
                      pipeline_id: str | None = None,
                      names: list[str] | None = None,
                      shard_filters: list | None = None) -> dict:
        self._reap_expired_contexts()
        keep_ms = parse_time_value_millis(scroll, "scroll", positive=True)
        self._check_keep_alive(keep_ms, scroll)
        cid = f"scroll_{uuid.uuid4().hex}"
        snapshots = [s.acquire_searcher() for s in shards]
        size = int(body.get("size", search_service.DEFAULT_SIZE))
        ctx = {
            "id": cid, "kind": "scroll", "shards": shards,
            "snapshots": snapshots, "body": body, "seen": size,
            "size": size, "keep_alive_ms": keep_ms,
            "expires_at": now_millis() + keep_ms,
            "pipeline_id": pipeline_id, "names": names or [],
            "shard_filters": shard_filters,
        }
        self.search_backpressure.admit()
        with self.task_manager.task_scope(
                "indices:data/read/search",
                description=f"scroll[{cid}]") as task:
            resp = self._search_with_pipeline(
                pipeline_id, names or [], shards, body, acquired=snapshots,
                shard_filters=shard_filters, task=task)
        self._reader_contexts[cid] = ctx
        resp["_scroll_id"] = cid
        return resp

    def scroll(self, scroll_id: str, scroll: str | None = None) -> dict:
        """The next scroll page. Pages deepen from + size against the
        PINNED snapshots (a deterministic order on an immutable view), as
        the reference's do: a kNN scroll's page p is one query phase at
        fetch depth (p + 1) * size."""
        ctx = self._resolve_reader_context(scroll_id, "scroll")
        if scroll is not None:
            keep_ms = parse_time_value_millis(scroll, "scroll", positive=True)
            self._check_keep_alive(keep_ms, scroll)
            ctx["keep_alive_ms"] = keep_ms
        ctx["expires_at"] = now_millis() + ctx["keep_alive_ms"]
        page_body = {k: v for k, v in ctx["body"].items()
                     if k not in ("aggs", "aggregations")}
        page_body["from"] = ctx["seen"]
        page_body["size"] = ctx["size"]
        self.search_backpressure.admit()
        with self.task_manager.task_scope(
                "indices:data/read/search",
                description=f"scroll[{scroll_id}]") as task:
            resp = self._search_with_pipeline(
                ctx.get("pipeline_id"), ctx.get("names", []), ctx["shards"],
                page_body, acquired=ctx["snapshots"],
                shard_filters=ctx.get("shard_filters"), task=task)
        ctx["seen"] += len(resp["hits"]["hits"])
        resp["_scroll_id"] = scroll_id
        return resp

    def clear_scroll(self, scroll_ids: list[str] | None) -> dict:
        self._reap_expired_contexts()
        freed = 0
        ids = scroll_ids or [c for c, x in list(self._reader_contexts.items())
                             if x["kind"] == "scroll"]
        for cid in list(ids):
            if self._reader_contexts.pop(cid, None) is not None:
                freed += 1
        return {"succeeded": True, "num_freed": freed}

    def open_pit(self, index: str, keep_alive: str) -> dict:
        self._reap_expired_contexts()
        keep_ms = parse_time_value_millis(keep_alive, "keep_alive",
                                          positive=True)
        shards, shard_filters, _ = self.resolve_search_shards(index)
        cid = f"pit_{uuid.uuid4().hex}"
        created = int(time.time() * 1000)
        self._reader_contexts[cid] = {
            "id": cid, "kind": "pit", "shards": shards,
            "snapshots": [s.acquire_searcher() for s in shards],
            "shard_filters": shard_filters,
            "keep_alive_ms": keep_ms, "expires_at": now_millis() + keep_ms,
            "creation_time": created,
        }
        return {"pit_id": cid, "_shards": {"total": len(shards),
                                           "successful": len(shards),
                                           "skipped": 0, "failed": 0},
                "creation_time": created}

    def list_all_pits(self) -> dict:
        """GET /_search/point_in_time/_all (RestGetAllPitsAction): every
        live PIT with its keep_alive and creation time."""
        self._reap_expired_contexts()
        return {"pits": [
            {"pit_id": cid, "creation_time": ctx.get("creation_time", 0),
             "keep_alive": ctx["keep_alive_ms"]}
            for cid, ctx in list(self._reader_contexts.items())
            if ctx["kind"] == "pit"]}

    def close_pit(self, pit_ids: list[str] | None) -> dict:
        self._reap_expired_contexts()
        ids = pit_ids or [c for c, x in list(self._reader_contexts.items())
                          if x["kind"] == "pit"]
        pits = []
        for cid in list(ids):
            ok = self._reader_contexts.pop(cid, None) is not None
            pits.append({"pit_id": cid, "successful": ok})
        return {"pits": pits}

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
                        # no index (None) keeps a PIT body legal
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
        body with its own ``search_pipeline`` key is never batchable). A
        shard with an alias filter keeps the run on the serial path too:
        each sub-search is still one filtered launch of the stacked
        step."""
        try:
            shards, shard_filters, names = self.resolve_search_shards(index)
        except OpenSearchTpuException:
            return None  # the serial path reports the error per sub-search
        if any(f is not None for f in shard_filters):
            return None
        for name in names:
            if self.indices[name].setting("search.default_pipeline"):
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

    # -- cluster settings (single node) ---------------------------------------

    def effective_cluster_setting(self, key: str, default=None):
        """transient over persistent over default (ClusterSettings.get)."""
        t = getattr(self, "_transient_cluster_settings", {}) or {}
        p = getattr(self, "_cluster_settings", {}) or {}
        return t.get(key, p.get(key, default))

    def _settings_view(self, flat_map: dict, flat: bool) -> dict:
        return settings_section(flat_map, flat)

    # the reference test cluster starts nodes with node.attr.testattr=test;
    # surfaced by ?include_defaults
    _CLUSTER_SETTING_DEFAULTS = {
        "node.attr.testattr": "test",
        "cluster.routing.allocation.enable": "all",
        "search.max_buckets": "65536",
        "search.allow_expensive_queries": "true",
    }

    def _apply_dynamic_node_settings(self, changed=()) -> None:
        """Push the effective dynamic cluster settings into the components
        that read them (the addSettingsUpdateConsumer of one node).

        The batcher, the ANN config, the lanes, the residency routing, the
        shard-mesh budget and the heat ledger are PROCESS-wide, so each is
        touched only when this node's effective settings carry one of its
        keys or this update (`changed`, the keys just PUT, null deletions
        included) names one: another node of the process updating an
        unrelated key, or merely booting, must not reset live
        configuration to its defaults. A null deletion restores the
        default: the deleted key is in `changed`, and apply_settings
        resolves an absent key to its default. The request cache's budget
        and the span exporter are per node and apply unconditionally."""
        from opensearch_tpu_torch.cluster import residency
        from opensearch_tpu_torch.cluster.cluster_settings import effective
        from opensearch_tpu_torch.index.request_cache import (
            CACHE_SIZE_SETTING,
        )
        from opensearch_tpu_torch.search import ann, lanes
        from opensearch_tpu_torch.search.batcher import BATCH_SETTINGS
        from opensearch_tpu_torch.telemetry.device_ledger import (
            HEAT_SETTINGS,
            default_ledger,
        )
        from opensearch_tpu_torch.telemetry.export import (
            apply_tracing_settings,
        )

        eff = effective(getattr(self, "_cluster_settings", {}),
                        getattr(self, "_transient_cluster_settings", {}))

        def named(settings) -> bool:
            return any(st.key in eff or st.key in changed for st in settings)

        if named(BATCH_SETTINGS):
            self.knn_batcher.apply_settings(eff)
        if named(ann.ANN_SETTINGS):
            ann.default_config.apply_settings(eff)
        if named(shard_mesh.MESH_SETTINGS):
            shard_mesh.default_registry.apply_settings(eff)
        if named(lanes.LANE_SETTINGS):
            lanes.default_config.apply_settings(eff)
        if named(residency.ROUTING_SETTINGS):
            residency.default_config.apply_settings(eff)
        if named(HEAT_SETTINGS):
            default_ledger.apply_heat_settings(eff)
        self.request_cache.set_max_bytes(
            CACHE_SIZE_SETTING.get(Settings.from_flat(eff)))
        # absent keys resolve to the "none" exporter: a null deletion
        # detaches a live one
        apply_tracing_settings(self.telemetry, eff, self.data_path,
                               service_name=self.node_name)

    def put_cluster_settings(self, body: dict, *, flat: bool = False) -> dict:
        """Single-node /_cluster/settings: validated, merged into the
        persistent and transient sections (null deletes a key), applied,
        and the persistent section written to ``cluster_settings.json``.
        The response echoes both sections after the update."""
        from opensearch_tpu_torch.cluster.cluster_settings import (
            flatten,
            merge,
            validate_settings,
        )

        persistent = flatten((body or {}).get("persistent") or {})
        transient = flatten((body or {}).get("transient") or {})
        validate_settings(persistent)
        validate_settings(transient)
        self._cluster_settings = merge(
            getattr(self, "_cluster_settings", {}), persistent)
        self._transient_cluster_settings = merge(
            getattr(self, "_transient_cluster_settings", {}), transient)
        self._apply_dynamic_node_settings(
            changed=set(persistent) | set(transient))
        self.data_path.mkdir(parents=True, exist_ok=True)
        (self.data_path / "cluster_settings.json").write_text(
            json.dumps(self._cluster_settings))
        return {
            "acknowledged": True,
            "persistent": self._settings_view(self._cluster_settings, flat),
            "transient": self._settings_view(
                self._transient_cluster_settings, flat),
        }

    def get_cluster_settings(self, *, flat: bool = False,
                             include_defaults: bool = False) -> dict:
        if not hasattr(self, "_cluster_settings"):
            path = self.data_path / "cluster_settings.json"
            self._cluster_settings = (json.loads(path.read_text())
                                      if path.exists() else {})
        transient = getattr(self, "_transient_cluster_settings", {})
        out = {
            "persistent": self._settings_view(self._cluster_settings, flat),
            "transient": self._settings_view(transient, flat),
        }
        if include_defaults:
            out["defaults"] = self._settings_view(
                {k: v for k, v in self._CLUSTER_SETTING_DEFAULTS.items()
                 if k not in self._cluster_settings and k not in transient},
                flat)
        return out

    # -- the _stats API (IndicesStatsAction / CommonStats) ---------------------

    _STATS_SECTIONS = (
        "docs", "store", "indexing", "get", "search", "merges", "refresh",
        "flush", "warmer", "query_cache", "fielddata", "completion",
        "segments", "translog", "request_cache", "recovery",
    )
    # REST metric name -> response section (IndicesStatsRequest flags)
    _METRIC_ALIASES = {"merge": "merges"}

    @staticmethod
    def _field_bytes(shard, field: str) -> int:
        """Estimated columnar (fielddata-class) bytes for one field across
        a shard's sealed segments."""
        total = 0
        for host, _dev in shard.engine._segments:
            kf = host.keyword_fields.get(field)
            if kf is not None:
                total += int(kf.mv_ords.nbytes + kf.first_ord.nbytes)
            nf = host.numeric_fields.get(field)
            if nf is not None:
                total += 8 * host.n_docs
            tf = host.text_fields.get(field)
            if tf is not None:
                total += int(tf.doc_len.nbytes)
        return total

    def _completion_fields_of(self, svc) -> list[str]:
        # completion fields store keyword-style with mapper.completion=True
        return [n for n, m in svc.mapper_service.mappers.items()
                if m.type == "completion" or getattr(m, "completion", False)]

    def _full_shard_stats(self, svc, shard, *, f_pats, c_pats,
                          groups, file_sizes, human) -> dict:
        eng = shard.engine
        seg = eng.segment_stats()
        tlog = eng.translog.stats()
        store_bytes = tlog["size_in_bytes"]
        for host, _dev in eng._segments:
            store_bytes += sum(len(s) for s in host.sources)
        st: dict[str, Any] = {
            "docs": {"count": eng.num_docs,
                     "deleted": max(seg["docs"] - seg["live_docs"], 0)},
            "store": {"size_in_bytes": store_bytes, "reserved_in_bytes": 0},
            "indexing": {
                "index_total": eng.stats["index_total"],
                "index_time_in_millis": int(eng.stats["index_time_ms"]),
                "index_current": 0, "index_failed": 0,
                "delete_total": eng.stats["delete_total"],
                "delete_time_in_millis": 0, "delete_current": 0,
                "noop_update_total": eng.stats.get("noop_update_total", 0),
                "is_throttled": False, "throttle_time_in_millis": 0,
            },
            "get": {"total": 0, "time_in_millis": 0, "exists_total": 0,
                    "exists_time_in_millis": 0, "missing_total": 0,
                    "missing_time_in_millis": 0, "current": 0},
            "search": {"open_contexts": 0, "query_total": 0,
                       "query_time_in_millis": 0, "query_current": 0,
                       "fetch_total": 0, "fetch_time_in_millis": 0,
                       "fetch_current": 0, "scroll_total": 0,
                       "scroll_time_in_millis": 0, "scroll_current": 0},
            "merges": {"current": 0, "current_docs": 0,
                       "current_size_in_bytes": 0, "total": 0,
                       "total_time_in_millis": 0, "total_docs": 0,
                       "total_size_in_bytes": 0},
            "refresh": {"total": eng.stats["refresh_total"],
                        "total_time_in_millis": 0,
                        "external_total": eng.stats["refresh_total"],
                        "external_total_time_in_millis": 0, "listeners": 0},
            "flush": {"total": eng.stats["flush_total"], "periodic": 0,
                      "total_time_in_millis": 0},
            "warmer": {"current": 0, "total": 0, "total_time_in_millis": 0},
            "query_cache": {"memory_size_in_bytes": 0, "total_count": 0,
                            "hit_count": 0, "miss_count": 0,
                            "cache_size": 0, "cache_count": 0,
                            "evictions": 0},
            "fielddata": {
                # resident column bytes across this shard's fields — the
                # engine's analog of loaded fielddata (always resident here)
                "memory_size_in_bytes": sum(
                    self._field_bytes(shard, fname)
                    for fname, m in svc.mapper_service.mappers.items()
                    if not getattr(m, "completion", False)),
                "evictions": 0,
            },
            "completion": {"size_in_bytes": 0},
            "segments": {
                "count": seg["count"],
                "memory_in_bytes": 0, "terms_memory_in_bytes": 0,
                "stored_fields_memory_in_bytes": 0,
                "term_vectors_memory_in_bytes": 0,
                "norms_memory_in_bytes": 0, "points_memory_in_bytes": 0,
                "doc_values_memory_in_bytes": 0,
                "index_writer_memory_in_bytes": 0,
                "version_map_memory_in_bytes": 0,
                "fixed_bit_set_memory_in_bytes": 0,
                "max_unsafe_auto_id_timestamp": -1,
                "file_sizes": {},
            },
            "translog": tlog,
            "request_cache": {"memory_size_in_bytes": 0, "evictions": 0,
                              "hit_count": 0, "miss_count": 0},
            "recovery": {"current_as_source": 0, "current_as_target": 0,
                         "throttle_time_in_millis": 0},
        }
        if human:
            st["get"]["time"] = "0s"
            st["get"]["getTime"] = "0s"
        if file_sizes:
            st["segments"]["file_sizes"] = {
                "src": {"size_in_bytes": store_bytes,
                        "description": "source documents"},
            }
        # per-field fielddata/completion breakdowns (?fields= patterns)
        if f_pats:
            fields = {}
            for fname in sorted(svc.mapper_service.mappers):
                m = svc.mapper_service.mappers[fname]
                if getattr(m, "completion", False):
                    continue
                if any(fnmatch.fnmatch(fname, p) for p in f_pats):
                    b = self._field_bytes(shard, fname)
                    fields[fname] = {"memory_size_in_bytes": max(b, 1)}
            if fields:
                st["fielddata"]["fields"] = fields
                st["fielddata"]["memory_size_in_bytes"] = sum(
                    f["memory_size_in_bytes"] for f in fields.values())
        comp_total = 0
        comp_fields = {}
        for fname in self._completion_fields_of(svc):
            size = 0
            for host, _dev in shard.engine._segments:
                w = host.completion_weights.get(fname)
                if w:
                    size += sum(len(k) + 8 for k in w)
            if size == 0:
                # no explicit inputs: the FST size scales with the
                # completion column's stored values
                size = self._field_bytes(shard, fname)
            comp_total += size
            if c_pats and any(fnmatch.fnmatch(fname, p) for p in c_pats):
                comp_fields[fname] = {"size_in_bytes": max(size, 1)}
        st["completion"]["size_in_bytes"] = comp_total
        if comp_fields:
            st["completion"]["fields"] = comp_fields
        return st

    @staticmethod
    def _merge_stats(a: dict, b: dict) -> dict:
        out = dict(a)
        for k, v in b.items():
            cur = out.get(k)
            if isinstance(v, dict):
                out[k] = TorchNode._merge_stats(cur or {}, v)
            elif isinstance(v, (int, float)) and not isinstance(v, bool) \
                    and isinstance(cur, (int, float)):
                out[k] = cur + v
            elif cur is None:
                out[k] = v
        return out

    def index_stats(self, index: str = "_all", *, metrics=None, fields=None,
                    completion_fields=None, fielddata_fields=None,
                    groups=None, level: str = "indices",
                    include_segment_file_sizes: bool = False,
                    human: bool = False) -> dict:
        """GET [/{index}]/_stats[/{metric}] (IndicesStatsAction /
        CommonStats; reference rest-api-spec indices.stats)."""
        sections = set(self._STATS_SECTIONS)
        if metrics:
            want = set()
            for m in metrics:
                m = self._METRIC_ALIASES.get(m, m)
                if m == "_all":
                    want = set(self._STATS_SECTIONS)
                    break
                if m not in self._STATS_SECTIONS:
                    msg = (f"request [/_stats/{','.join(metrics)}] contains "
                           f"unrecognized metric: [{m}]")
                    close = difflib.get_close_matches(
                        m, self._STATS_SECTIONS, n=3)
                    if close:
                        msg += " -> did you mean " + (
                            f"[{close[0]}]?" if len(close) == 1
                            else f"any of {sorted(close)}?")
                    raise IllegalArgumentException(msg)
                want.add(m)
            sections = want
        f_pats = [p for p in (fields or "").split(",") if p] or \
            [p for p in (fielddata_fields or "").split(",") if p]
        c_pats = [p for p in (fields or "").split(",") if p] or \
            [p for p in (completion_fields or "").split(",") if p]
        group_list = [g for g in (groups or "").split(",") if g]

        out: dict[str, Any] = {
            "_shards": {"total": 0, "successful": 0, "failed": 0},
            "_all": {"primaries": {}, "total": {}},
            "indices": {},
        }
        all_prim: dict = {}
        for name in self.resolve_indices(index):
            svc = self._get_index(name)
            prim: dict = {}
            shards_out: dict = {}
            for sid, shard in sorted(svc.shards.items()):
                sstats = self._full_shard_stats(
                    svc, shard, f_pats=f_pats, c_pats=c_pats,
                    groups=group_list,
                    file_sizes=include_segment_file_sizes, human=human)
                sstats = {k: v for k, v in sstats.items() if k in sections}
                prim = self._merge_stats(prim, sstats)
                # total counts every targeted copy (primaries + replicas);
                # successful counts the copies that reported (primaries on
                # this single node)
                out["_shards"]["total"] += 1 + svc.num_replicas
                out["_shards"]["successful"] += 1
                if level == "shards":
                    entry = dict(sstats)
                    entry["routing"] = {
                        "state": "STARTED", "primary": True,
                        "node": self.node_name,
                    }
                    entry["commit"] = {
                        "id": shard.engine.engine_uuid,
                        "generation": shard.engine.translog.checkpoint.generation,
                        "num_docs": shard.engine.num_docs,
                        "user_data": {},
                    }
                    shards_out[str(sid)] = [entry]
            # search totals and stat-group counters are INDEX-level (the
            # per-shard merge would multiply them by shard count)
            if "search" in sections and "search" in prim:
                totals = svc.search_stats
                prim["search"]["query_total"] = totals["query_total"]
                prim["search"]["fetch_total"] = totals["fetch_total"]
                if group_list:
                    tracked = svc.search_group_stats
                    matched = {
                        g: dict(c) for g, c in tracked.items()
                        if any(fnmatch.fnmatch(g, p) for p in group_list)
                    }
                    if matched:
                        prim["search"]["groups"] = matched
            idx_entry: dict[str, Any] = {
                "uuid": svc.uuid,
                "primaries": prim,
                "total": prim,
            }
            if level == "shards":
                idx_entry["shards"] = shards_out
            out["indices"][name] = idx_entry
            all_prim = self._merge_stats(all_prim, prim)
        out["_all"] = {"primaries": all_prim, "total": all_prim}
        if level == "cluster":
            out.pop("indices")
        return out

    def close(self) -> None:
        # flush on shutdown: buffered trace fragments decide and drain
        from opensearch_tpu_torch.telemetry.export import close_exporter

        close_exporter(self.telemetry)
        # open scroll and PIT contexts pin snapshots: they end with the node
        self._reader_contexts.clear()
        for name, svc in self.indices.items():
            svc.close()
            # the stacked serving slabs of this index leave device memory
            shard_mesh.default_registry.invalidate_index(name)
        self.indices.clear()


def _index_setting(settings: dict, name: str):
    """An index-scoped setting from the flat ("index.default_pipeline"),
    nested ({"index": {"default_pipeline": ...}}) or top-level shape."""
    v = settings.get(name)
    if v is None:
        v = settings.get(f"index.{name}")
    if v is None:
        nested = settings.get("index")
        if isinstance(nested, dict):
            v = nested.get(name)
    return v
