"""REST API handlers: the OpenSearch HTTP surface over a TorchNode.

Counterpart of opensearch_tpu/rest/handlers.py. :func:`build_router`
registers every (method, path) of the reference's router. The handlers of
the API the port serves are copies of the reference's: the root info, the
index lifecycle (create, delete, get, HEAD, mappings, settings), document
writes and reads (index, create, auto-id index, get, HEAD, `_source`,
delete, `_update`), NDJSON `_bulk`, `_refresh`, `_search`, `_count`,
`_msearch` (each taking ``?search_pipeline``), stored scripts
(`_scripts/{id}`, `_script_context`, `_script_language`), search
templates (`_search/template`, `_render/template`), search pipelines
(`_search/pipeline`), `_cluster/health`, the kernel roofline report and its
re-calibration (`GET /_roofline`, `POST /_roofline/calibrate`), the
what-if tiering advisor (`GET /_tiering/advise`), and the search contexts,
aliases and admission: scroll (`_search/scroll`), point in time
(`_search/point_in_time`), `_flush`, `_forcemerge`, `_cache/clear`,
`_aliases` and `_alias`, `_tasks` (list, get, cancel), the workload groups
(`_wlm/query_group`, `_wlm/stats`, `_list/wlm_stats`),
`_cluster/settings` and `_otel/flush`; `_search` reads `scroll`,
`query_group` and `request_cache`, `_bulk` reads `query_group`; ingest
pipelines (`_ingest/pipeline`, with `_simulate`), index templates
(`_template`, `_index_template`, `_component_template`), `_segments`,
`_stats`, `_cluster/stats`, `_nodes` (info and stats by metric, with the
`ingest`, `device`, `knn_batch`, `roofline` and `heat` sections),
`_prometheus/metrics` and `_cat`, each stats read from host counters
only;
index management (`_mapping` updates and `_mapping/field`, `_settings`
updates, `_block`, `_upgrade`, `_shrink`, `_split`, `_clone`,
`_rollover`, `_close`, `_open`, `_analyze`) and the document reads and
query tools (`_mget`, `_explain`, `_field_caps`, `_termvectors`,
`_mtermvectors`, `_validate/query`, `_search_shards`); snapshots and
repositories (`_snapshot`, with `_restore`, `_status` and `_cleanup`), the
remote segment store (`_remotestore`), `_rank_eval` and the reindex family
(`_reindex`, `_update_by_query`, `_delete_by_query`); and the control
plane as the reference's single node serves it (`_cluster/state`,
`_cluster/pending_tasks`, `_cluster/voting_config_exclusions`,
`_cluster/reroute`, `_cluster/allocation/explain`, `_shard_stores`,
`_recovery`, `_remote/info`, `_cat/recovery`, `_cat/pending_tasks`).
Handlers receive (node, params, query, body) and return (status, payload);
the HTTP server is transport-only.
"""

from __future__ import annotations

import copy
import difflib
import fnmatch
import json
import logging
import os
import re
import resource
import threading
import time
from datetime import datetime, timezone
from typing import Any

from opensearch_tpu_torch import __version__
from opensearch_tpu_torch.common.errors import (
    DocumentMissingException,
    IllegalArgumentException,
    IndexClosedException,
    IndexNotFoundException,
    OpenSearchTpuException,
    ResourceNotFoundException,
    SnapshotMissingException,
)
from opensearch_tpu_torch.common.settings import Settings
from opensearch_tpu_torch.node import TorchNode, alias_map_of
from opensearch_tpu_torch.rest.router import Router
from opensearch_tpu_torch.search.service import _source_filter
from opensearch_tpu_torch.telemetry import device_ledger, roofline

logger = logging.getLogger(__name__)


def apply_filter_path(payload: Any, spec: str) -> Any:
    """?filter_path=a.b,-c.* response shaping (the reference's
    XContent filtering layer, common.xcontent.support.filtering): keep
    only matching paths; leading '-' excludes; '*' matches one key,
    '**' any depth."""
    if not isinstance(payload, (dict, list)) or not spec:
        return payload
    includes = [p.strip() for p in spec.split(",")
                if p.strip() and not p.strip().startswith("-")]
    excludes = [p.strip()[1:] for p in spec.split(",")
                if p.strip().startswith("-")]

    def match_parts(parts: list[str], pattern: list[str]) -> str:
        """'full' match, 'prefix' (keep descending), or 'no'."""
        if not pattern:
            return "full"
        if not parts:
            return "prefix"
        head, *rest_p = pattern
        tok, *rest_t = parts
        if head == "**":
            for skip in range(len(parts) + 1):
                r = match_parts(parts[skip:], rest_p)
                if r != "no":
                    return r
            return "prefix"
        if head == "*" or head == tok or (
            "*" in head and fnmatch.fnmatch(tok, head)
        ):
            return match_parts(rest_t, rest_p)
        return "no"

    def filter_obj(obj: Any, path: list[str], patterns: list[list[str]],
                   exclude: bool) -> Any:
        if isinstance(obj, dict):
            out = {}
            for k, v in obj.items():
                sub = path + [str(k)]
                states = [match_parts(sub, pt) for pt in patterns]
                if exclude:
                    if any(st == "full" for st in states):
                        continue
                    if any(st == "prefix" for st in states):
                        fv = filter_obj(v, sub, patterns, exclude)
                        if fv is not None:
                            out[k] = fv
                    else:
                        out[k] = v
                else:
                    if any(st == "full" for st in states):
                        out[k] = v
                    elif any(st == "prefix" for st in states):
                        fv = filter_obj(v, sub, patterns, exclude)
                        if fv not in (None, {}, []):
                            out[k] = fv
            return out if (out or exclude) else ({} if exclude else None)
        if isinstance(obj, list):
            items = [filter_obj(x, path, patterns, exclude) for x in obj]
            if exclude:
                return [x for x in items if x is not None]
            return [x for x in items if x not in (None, {}, [])]
        return obj if exclude else None

    result = payload
    if includes:
        result = filter_obj(
            result, [], [p.split(".") for p in includes], exclude=False
        ) or {}
    if excludes:
        result = filter_obj(
            result, [], [p.split(".") for p in excludes], exclude=True
        )
    return result


def build_router() -> Router:
    r = Router()
    reg = r.register

    reg("GET", "/", root_info)
    # index lifecycle
    reg("PUT", "/{index}", create_index)
    reg("DELETE", "/{index}", delete_index)
    reg("GET", "/{index}", get_index)
    reg("HEAD", "/{index}", index_exists)
    reg("GET", "/_mapping", get_mapping)
    reg("GET", "/{index}/_mapping", get_mapping)
    reg("GET", "/_settings", get_settings)
    reg("GET", "/_settings/{name}", get_settings)
    reg("GET", "/{index}/_settings", get_settings)
    reg("GET", "/{index}/_settings/{name}", get_settings)
    reg("GET", "/_mapping/field/{fields}", get_field_mapping)
    reg("GET", "/{index}/_mapping/field/{fields}", get_field_mapping)
    reg("PUT", "/{index}/_mapping", put_mapping)
    reg("POST", "/{index}/_mapping", put_mapping)
    reg("PUT", "/{index}/_settings", put_index_settings)
    reg("PUT", "/_settings", put_all_settings)
    # index management: blocks, _upgrade, resize, rollover, close / open,
    # _analyze
    reg("PUT", "/{index}/_block/{block}", add_index_block)
    reg("POST", "/_upgrade", indices_upgrade)
    reg("POST", "/{index}/_upgrade", indices_upgrade)
    reg("GET", "/_upgrade", indices_upgrade)
    reg("GET", "/{index}/_upgrade", indices_upgrade)
    reg("PUT", "/{index}/_shrink/{target}", shrink_index)
    reg("POST", "/{index}/_shrink/{target}", shrink_index)
    reg("PUT", "/{index}/_split/{target}", split_index)
    reg("POST", "/{index}/_split/{target}", split_index)
    reg("PUT", "/{index}/_clone/{target}", clone_index)
    reg("POST", "/{index}/_clone/{target}", clone_index)
    reg("POST", "/{index}/_rollover", rollover)
    reg("POST", "/{index}/_rollover/{new_index}", rollover_named)
    reg("POST", "/{index}/_close", close_index)
    reg("POST", "/{index}/_open", open_index)
    reg("GET", "/{index}/_analyze", analyze_index)
    reg("POST", "/{index}/_analyze", analyze_index)
    reg("GET", "/_analyze", analyze_global)
    reg("POST", "/_analyze", analyze_global)
    # documents
    reg("PUT", "/{index}/_doc/{id}", index_doc)
    reg("POST", "/{index}/_doc/{id}", index_doc)
    reg("POST", "/{index}/_doc", index_doc_auto_id)
    reg("PUT", "/{index}/_create/{id}", create_doc)
    reg("POST", "/{index}/_create/{id}", create_doc)
    reg("GET", "/{index}/_doc/{id}", get_doc)
    reg("HEAD", "/{index}/_doc/{id}", doc_exists)
    reg("GET", "/{index}/_source/{id}", get_source)
    reg("HEAD", "/{index}/_source/{id}", source_exists)
    reg("DELETE", "/{index}/_doc/{id}", delete_doc)
    reg("POST", "/{index}/_update/{id}", update_doc)
    # document reads and query tools
    reg("GET", "/_mget", mget_all)
    reg("POST", "/_mget", mget_all)
    reg("GET", "/{index}/_mget", mget)
    reg("POST", "/{index}/_mget", mget)
    reg("GET", "/{index}/_explain/{id}", explain_doc)
    reg("POST", "/{index}/_explain/{id}", explain_doc)
    reg("GET", "/_field_caps", field_caps_all)
    reg("POST", "/_field_caps", field_caps_all)
    reg("GET", "/{index}/_field_caps", field_caps)
    reg("POST", "/{index}/_field_caps", field_caps)
    reg("GET", "/{index}/_termvectors/{id}", termvectors)
    reg("POST", "/{index}/_termvectors/{id}", termvectors)
    reg("GET", "/_mtermvectors", mtermvectors)
    reg("POST", "/_mtermvectors", mtermvectors)
    reg("GET", "/{index}/_mtermvectors", mtermvectors)
    reg("POST", "/{index}/_mtermvectors", mtermvectors)
    reg("GET", "/_search_shards", search_shards_handler)
    reg("POST", "/_search_shards", search_shards_handler)
    reg("GET", "/{index}/_search_shards", search_shards_handler)
    reg("POST", "/{index}/_search_shards", search_shards_handler)
    reg("GET", "/_validate/query", validate_query)
    reg("POST", "/_validate/query", validate_query)
    reg("GET", "/{index}/_validate/query", validate_query)
    reg("POST", "/{index}/_validate/query", validate_query)
    reg("POST", "/_bulk", bulk)
    reg("PUT", "/_bulk", bulk)
    reg("POST", "/{index}/_bulk", bulk)
    # search
    reg("GET", "/{index}/_search", search)
    reg("POST", "/{index}/_search", search)
    reg("GET", "/_search", search_all)
    reg("POST", "/_search", search_all)
    reg("GET", "/_msearch", msearch)
    reg("POST", "/_msearch", msearch)
    reg("POST", "/{index}/_msearch", msearch)
    reg("GET", "/{index}/_count", count)
    reg("POST", "/{index}/_count", count)
    reg("GET", "/_count", count_all)
    reg("POST", "/_count", count_all)
    # search contexts: scroll and point in time
    reg("GET", "/_search/scroll", scroll)
    reg("POST", "/_search/scroll", scroll)
    reg("GET", "/_search/scroll/{scroll_id}", scroll)
    reg("POST", "/_search/scroll/{scroll_id}", scroll)
    reg("DELETE", "/_search/scroll", clear_scroll)
    reg("DELETE", "/_search/scroll/{scroll_id}", clear_scroll)
    reg("POST", "/{index}/_search/point_in_time", open_pit)
    reg("DELETE", "/_search/point_in_time", close_pit)
    reg("DELETE", "/_search/point_in_time/_all", close_all_pits)
    reg("GET", "/_search/point_in_time/_all", get_all_pits)
    # maintenance
    reg("POST", "/{index}/_refresh", refresh)
    reg("GET", "/{index}/_refresh", refresh)
    reg("POST", "/_refresh", refresh_all)
    reg("POST", "/{index}/_flush", flush)
    reg("POST", "/_flush", flush_all)
    reg("POST", "/{index}/_forcemerge", forcemerge)
    reg("POST", "/_forcemerge", forcemerge)
    reg("POST", "/{index}/_cache/clear", clear_cache)
    reg("POST", "/_cache/clear", clear_cache_all)
    # aliases
    reg("POST", "/_aliases", update_aliases)
    reg("PUT", "/{index}/_alias/{name}", put_alias)
    reg("POST", "/{index}/_alias/{name}", put_alias)
    reg("PUT", "/{index}/_alias", put_alias)
    reg("POST", "/{index}/_alias", put_alias)
    reg("PUT", "/_alias/{name}", put_alias)
    reg("POST", "/_alias/{name}", put_alias)
    reg("PUT", "/_alias", put_alias)
    reg("POST", "/_alias", put_alias)
    reg("PUT", "/{index}/_aliases/{name}", put_alias)
    reg("DELETE", "/{index}/_alias/{name}", delete_alias)
    reg("DELETE", "/{index}/_aliases/{name}", delete_alias)
    reg("GET", "/_alias", get_alias_all)
    reg("GET", "/_alias/{name}", get_alias_by_name)
    reg("GET", "/{index}/_alias", get_alias_index)
    reg("GET", "/{index}/_alias/{name}", get_alias_index_name)
    reg("HEAD", "/_alias/{name}", exists_alias)
    reg("HEAD", "/{index}/_alias/{name}", exists_alias)
    # span export
    reg("POST", "/_otel/flush", otel_flush)
    # tasks
    reg("GET", "/_tasks", list_tasks)
    reg("GET", "/_tasks/{task_id}", get_task)
    reg("POST", "/_tasks/_cancel", cancel_tasks)
    reg("POST", "/_tasks/{task_id}/_cancel", cancel_task)
    # cluster
    reg("GET", "/_cluster/health", cluster_health)
    reg("GET", "/_cluster/health/{index}", cluster_health)
    reg("GET", "/_cluster/settings", get_cluster_settings)
    reg("PUT", "/_cluster/settings", put_cluster_settings)
    # workload management (query groups)
    reg("PUT", "/_wlm/query_group", put_query_group)
    reg("GET", "/_wlm/query_group", get_query_groups)
    reg("GET", "/_wlm/query_group/{name}", get_query_group)
    reg("DELETE", "/_wlm/query_group/{name}", delete_query_group)
    reg("GET", "/_wlm/stats", wlm_stats)
    reg("GET", "/_list/wlm_stats", wlm_stats_list)
    # kernel roofline report (telemetry/roofline.py): families ranked by
    # lost time, plus the re-calibration button
    reg("GET", "/_roofline", roofline_report)
    reg("POST", "/_roofline/calibrate", roofline_calibrate)
    # what-if tiering advisor (telemetry/device_ledger.py): replay the
    # recorded access stream against a candidate device-memory budget
    reg("GET", "/_tiering/advise", tiering_advise)
    # stored scripts and search templates (the lang-mustache module)
    reg("PUT", "/_scripts/{id}", put_stored_script)
    reg("POST", "/_scripts/{id}", put_stored_script)
    reg("GET", "/_scripts/{id}", get_stored_script)
    reg("DELETE", "/_scripts/{id}", delete_stored_script)
    reg("GET", "/_script_context", get_script_context)
    reg("GET", "/_script_language", get_script_languages)
    reg("GET", "/_search/template", search_template_all)
    reg("POST", "/_search/template", search_template_all)
    reg("GET", "/{index}/_search/template", search_template)
    reg("POST", "/{index}/_search/template", search_template)
    reg("GET", "/_render/template", render_template)
    reg("POST", "/_render/template", render_template)
    reg("GET", "/_render/template/{id}", render_template)
    reg("POST", "/_render/template/{id}", render_template)
    # search pipelines
    reg("PUT", "/_search/pipeline/{id}", put_search_pipeline)
    reg("GET", "/_search/pipeline", get_search_pipelines)
    reg("GET", "/_search/pipeline/{id}", get_search_pipeline)
    reg("DELETE", "/_search/pipeline/{id}", delete_search_pipeline)
    # ingest pipelines
    reg("PUT", "/_ingest/pipeline/{id}", put_pipeline)
    reg("GET", "/_ingest/pipeline", get_pipelines)
    reg("GET", "/_ingest/pipeline/{id}", get_pipeline)
    reg("DELETE", "/_ingest/pipeline/{id}", delete_pipeline)
    reg("POST", "/_ingest/pipeline/{id}/_simulate", simulate_pipeline)
    reg("GET", "/_ingest/pipeline/{id}/_simulate", simulate_pipeline)
    reg("POST", "/_ingest/pipeline/_simulate", simulate_inline)
    reg("GET", "/_ingest/pipeline/_simulate", simulate_inline)
    # index templates: legacy, composable and component
    reg("PUT", "/_template/{name}", put_legacy_template)
    reg("POST", "/_template/{name}", put_legacy_template)
    reg("GET", "/_template", get_legacy_templates)
    reg("GET", "/_template/{name}", get_legacy_templates)
    reg("HEAD", "/_template/{name}", legacy_template_exists)
    reg("DELETE", "/_template/{name}", delete_legacy_template)
    reg("PUT", "/_index_template/{name}", put_index_template)
    reg("POST", "/_index_template/{name}", put_index_template)
    reg("GET", "/_index_template", get_index_templates)
    reg("GET", "/_index_template/{name}", get_index_template)
    reg("DELETE", "/_index_template/{name}", delete_index_template)
    reg("PUT", "/_component_template/{name}", put_component_template)
    reg("POST", "/_component_template/{name}", put_component_template)
    reg("GET", "/_component_template", get_component_templates)
    reg("GET", "/_component_template/{name}", get_component_template)
    reg("DELETE", "/_component_template/{name}", delete_component_template)
    # the node's stats: _stats, _segments, _cluster/stats, _nodes,
    # Prometheus and _cat
    reg("GET", "/_segments", indices_segments)
    reg("GET", "/{index}/_segments", indices_segments)
    reg("GET", "/_prometheus/metrics", prometheus_metrics)
    reg("GET", "/_cluster/stats", cluster_stats)
    reg("GET", "/_stats", all_stats)
    reg("GET", "/_stats/{metric}", all_stats)
    reg("GET", "/{index}/_stats", index_stats)
    reg("GET", "/{index}/_stats/{metric}", index_stats)
    reg("GET", "/_nodes", nodes_info)
    reg("GET", "/_nodes/stats", nodes_stats)
    reg("GET", "/_nodes/{node_id}/stats", nodes_stats)
    reg("GET", "/_nodes/stats/{metric}", nodes_stats)
    reg("GET", "/_nodes/stats/{metric}/{index_metric}", nodes_stats)
    reg("GET", "/_nodes/{node_id}/stats/{metric}", nodes_stats)
    reg("GET", "/_nodes/{node_id}/stats/{metric}/{index_metric}",
        nodes_stats)
    reg("GET", "/_nodes/{node_id}", nodes_info)
    reg("GET", "/_nodes/{node_id}/{metric}", nodes_info)
    reg("GET", "/_cat", cat_help)
    reg("GET", "/_cat/indices", cat_indices)
    reg("GET", "/_cat/indices/{index}", cat_indices)
    reg("GET", "/_cat/health", cat_health)
    reg("GET", "/_cat/shards", cat_shards)
    reg("GET", "/_cat/shards/{index}", cat_shards)
    reg("GET", "/_cat/count", cat_count)
    reg("GET", "/_cat/count/{index}", cat_count)
    reg("GET", "/_cat/aliases", cat_aliases)
    reg("GET", "/_cat/aliases/{name}", cat_aliases)
    reg("GET", "/_cat/allocation", cat_allocation)
    reg("GET", "/_cat/allocation/{node_id}", cat_allocation)
    reg("GET", "/_cat/nodes", cat_nodes)
    reg("GET", "/_cat/master", cat_master)
    reg("GET", "/_cat/cluster_manager", cat_master)
    reg("GET", "/_cat/nodeattrs", cat_nodeattrs)
    reg("GET", "/_cat/plugins", cat_plugins)
    reg("GET", "/_cat/templates", cat_templates)
    reg("GET", "/_cat/templates/{name}", cat_templates)
    reg("GET", "/_cat/thread_pool", cat_thread_pool)
    reg("GET", "/_cat/thread_pool/{pattern}", cat_thread_pool)
    reg("GET", "/_cat/segments", cat_segments)
    reg("GET", "/_cat/segments/{index}", cat_segments)
    reg("GET", "/_cat/tasks", cat_tasks)
    reg("GET", "/_cat/fielddata", cat_fielddata)
    reg("GET", "/_cat/fielddata/{fields}", cat_fielddata)
    reg("GET", "/_cat/repositories", cat_repositories)
    reg("GET", "/_cat/snapshots", cat_snapshots)
    reg("GET", "/_cat/snapshots/{repo}", cat_snapshots)
    # snapshots and repositories
    reg("PUT", "/_snapshot/{repo}", put_repository)
    reg("POST", "/_snapshot/{repo}", put_repository)
    reg("GET", "/_snapshot", get_repositories)
    reg("GET", "/_snapshot/{repo}", get_repository)
    reg("DELETE", "/_snapshot/{repo}", delete_repository)
    reg("POST", "/_snapshot/{repo}/_cleanup", cleanup_repository)
    reg("PUT", "/_snapshot/{repo}/{snapshot}", create_snapshot)
    reg("POST", "/_snapshot/{repo}/{snapshot}", create_snapshot)
    reg("GET", "/_snapshot/{repo}/{snapshot}", get_snapshot)
    reg("DELETE", "/_snapshot/{repo}/{snapshot}", delete_snapshot)
    reg("POST", "/_snapshot/{repo}/{snapshot}/_restore", restore_snapshot)
    reg("GET", "/_snapshot/{repo}/{snapshot}/_status", snapshot_status)
    # the remote segment store
    reg("POST", "/_remotestore/_restore", remotestore_restore)
    reg("POST", "/{index}/_remotestore/_sync", remotestore_sync)
    reg("GET", "/_remotestore/stats/{index}", remotestore_stats)
    # rank evaluation
    reg("GET", "/{index}/_rank_eval", rank_eval_handler)
    reg("POST", "/{index}/_rank_eval", rank_eval_handler)
    reg("GET", "/_rank_eval", rank_eval_all)
    reg("POST", "/_rank_eval", rank_eval_all)
    # the reindex family
    reg("POST", "/_reindex", reindex_handler)
    reg("POST", "/{index}/_update_by_query", update_by_query_handler)
    reg("POST", "/{index}/_delete_by_query", delete_by_query_handler)
    # the control plane on the single node
    reg("GET", "/_shard_stores", indices_shard_stores)
    reg("GET", "/{index}/_shard_stores", indices_shard_stores)
    reg("GET", "/_recovery", indices_recovery)
    reg("GET", "/{index}/_recovery", indices_recovery)
    reg("GET", "/_cluster/state", cluster_state_metric)
    reg("GET", "/_cluster/state/{metric}", cluster_state_metric)
    reg("GET", "/_cluster/state/{metric}/{index}", cluster_state_metric)
    reg("GET", "/_cluster/pending_tasks", cluster_pending_tasks)
    reg("POST", "/_cluster/voting_config_exclusions",
        post_voting_config_exclusions)
    reg("DELETE", "/_cluster/voting_config_exclusions",
        delete_voting_config_exclusions)
    reg("POST", "/_cluster/reroute", cluster_reroute)
    reg("GET", "/_cluster/allocation/explain", allocation_explain)
    reg("POST", "/_cluster/allocation/explain", allocation_explain)
    reg("GET", "/_remote/info", remote_info)
    reg("GET", "/_cat/recovery", cat_recovery)
    reg("GET", "/_cat/recovery/{index}", cat_recovery)
    reg("GET", "/_cat/pending_tasks", cat_pending_tasks)
    return r


# -- info --------------------------------------------------------------------


def root_info(node: TorchNode, params, query, body):
    return 200, {
        "name": node.node_name,
        "cluster_name": "opensearch-tpu",
        "cluster_uuid": "tpu-native",
        "version": {
            "distribution": "opensearch-tpu-torch",
            "number": __version__,
            "minimum_wire_compatibility_version": "7.10.0",
            "minimum_index_compatibility_version": "7.0.0",
        },
        "tagline": "The OpenSearch Project: PyTorch and CUDA engine",
    }


# -- index lifecycle ---------------------------------------------------------


def create_index(node: TorchNode, params, query, body):
    return 200, node.create_index(params["index"], body)


def delete_index(node: TorchNode, params, query, body):
    return 200, node.delete_index(
        params["index"],
        ignore_unavailable=str(query.get("ignore_unavailable", "false"))
        in ("true", ""),
        allow_no_indices=str(query.get("allow_no_indices", "true")) != "false",
    )


def _alias_echo(conf: dict | None) -> dict:
    """An index's alias as GET /{index} shows it: `routing` as
    index_routing and search_routing."""
    c = dict(conf or {})
    if "routing" in c:
        c.setdefault("index_routing", c["routing"])
        c.setdefault("search_routing", c["routing"])
        del c["routing"]
    return c


def get_index(node: TorchNode, params, query, body):
    out = {}
    for name in node.resolve_indices(
        params["index"],
        ignore_unavailable=str(query.get("ignore_unavailable", "false"))
        in ("true", ""),
        allow_no_indices=str(query.get("allow_no_indices", "true")) != "false",
    ):
        out[name] = {
            "aliases": {a: _alias_echo(c)
                        for a, c in node.indices[name].aliases.items()},
            "mappings": node.indices[name].mapper_service.to_dict(),
            "settings": node.get_settings(name)[name]["settings"],
        }
    return 200, out


def get_mapping(node: TorchNode, params, query, body):
    return 200, node.get_mapping(
        params.get("index", "_all"),
        ignore_unavailable=str(query.get("ignore_unavailable", "false")) in ("true", ""),
        allow_no_indices=str(query.get("allow_no_indices", "true")) != "false",
        expand_wildcards=str(query.get("expand_wildcards", "open")),
    )


def get_settings(node: TorchNode, params, query, body):
    return 200, node.get_settings(
        params.get("index", "_all"),
        name=params.get("name") or query.get("name"),
        flat=str(query.get("flat_settings", "false")) in ("true", ""),
        include_defaults=str(query.get("include_defaults", "false"))
        in ("true", ""),
        expand_wildcards=str(query.get("expand_wildcards", "all")),
    )


def index_exists(node: TorchNode, params, query, body):
    try:
        names = node.resolve_indices(params["index"])
    except OpenSearchTpuException:
        return 404, ""
    return (200 if names else 404), ""


# -- documents ---------------------------------------------------------------


def _routing_param(query):
    r = query.get("routing")
    return str(r) if r is not None else None


def _refresh_param(query) -> bool:
    v = query.get("refresh", "false")
    return v in ("true", "", "wait_for")


def _check_require_alias(node: TorchNode, index: str, query) -> None:
    """require_alias: the write target must be an alias, never a concrete
    (or auto-created) index (RestIndexAction / DocWriteRequest)."""
    if query.get("require_alias") not in ("true", ""):
        return
    if index not in alias_map_of(node.indices):
        raise IndexNotFoundException(
            f"[{index}] is not an alias and require_alias is set")


def _forced_refresh(resp: dict, query) -> dict:
    # forced_refresh: true only for an IMMEDIATE refresh (refresh=true or
    # the bare param); wait_for reports false (RestStatusToXContentListener)
    if query.get("refresh") in ("true", ""):
        return {**resp, "forced_refresh": True}
    return resp


def _version_params(query) -> dict:
    out = {}
    if "version" in query:
        out["version"] = int(query["version"])
    if "version_type" in query:
        vt = str(query["version_type"])
        # VersionType.fromString knows internal/external/external_gt/
        # external_gte only: "force" was removed and must 400
        if vt == "external_gt":
            vt = "external"
        if vt not in ("internal", "external", "external_gte"):
            raise IllegalArgumentException(f"No version type match [{vt}]")
        out["version_type"] = vt
    elif "version" in query:
        out["version_type"] = "internal"
    return out


def index_doc(node: TorchNode, params, query, body):
    if body is None:
        raise IllegalArgumentException("request body is required")
    if_seq_no = query.get("if_seq_no")
    if_pt = query.get("if_primary_term")
    _check_require_alias(node, params["index"], query)
    resp = node.index_doc(
        params["index"], params["id"], body,
        routing=_routing_param(query),
        if_seq_no=int(if_seq_no) if if_seq_no is not None else None,
        if_primary_term=int(if_pt) if if_pt is not None else None,
        refresh=_refresh_param(query),
        op_type="create" if query.get("op_type") == "create" else None,
        pipeline=query.get("pipeline"),
        **_version_params(query),
    )
    resp = _forced_refresh(resp, query)
    return (201 if resp["result"] == "created" else 200), resp


def index_doc_auto_id(node: TorchNode, params, query, body):
    if body is None:
        raise IllegalArgumentException("request body is required")
    _check_require_alias(node, params["index"], query)
    resp = node.index_doc(
        params["index"], None, body,
        routing=_routing_param(query), refresh=_refresh_param(query),
        pipeline=query.get("pipeline"),
    )
    return 201, _forced_refresh(resp, query)


def create_doc(node: TorchNode, params, query, body):
    if body is None:
        raise IllegalArgumentException("request body is required")
    resp = node.index_doc(
        params["index"], params["id"], body,
        routing=_routing_param(query), refresh=_refresh_param(query),
        op_type="create", pipeline=query.get("pipeline"),
        **_version_params(query),
    )
    return 201, _forced_refresh(resp, query)


def _realtime_param(query) -> bool:
    return str(query.get("realtime", "true")) != "false"


def _apply_get_params(resp, query):
    """_source filtering + stored_fields rendering on GET responses
    (RestGetAction's FetchSourceContext/storedFields handling)."""
    if not resp.get("found"):
        return resp
    src = resp.get("_source")
    includes = query.get("_source_includes") or query.get("_source_include")
    excludes = query.get("_source_excludes") or query.get("_source_exclude")
    if includes or excludes:
        spec = {
            **({"includes": str(includes).split(",")} if includes else {}),
            **({"excludes": str(excludes).split(",")} if excludes else {}),
        }
        resp = {**resp, "_source": _source_filter(spec)(src)}
    elif "_source" in query:
        v = str(query["_source"])
        if v == "false":
            resp = {k: x for k, x in resp.items() if k != "_source"}
        elif v not in ("true", ""):
            resp = {**resp, "_source": _source_filter(v.split(","))(src)}
    if "stored_fields" in query and src is not None:
        wanted = str(query["stored_fields"]).split(",")
        fields = {}
        for f in wanted:
            if f in src:
                v = src[f]
                fields[f] = v if isinstance(v, list) else [v]
        if fields:
            resp = {**resp, "fields": fields}
        keep_source = "_source" in wanted or (
            "_source" in query
            and str(query["_source"]) in ("true", "")
        )
        if not keep_source:
            resp = {k: x for k, x in resp.items() if k != "_source"}
    return resp


def get_doc(node: TorchNode, params, query, body):
    resp = node.get_doc(params["index"], params["id"],
                        routing=_routing_param(query),
                        realtime=_realtime_param(query),
                        refresh=str(query.get("refresh", "false"))
                        in ("true", ""),
                        version=(int(query["version"])
                                 if "version" in query else None))
    return (200 if resp.get("found") else 404), _apply_get_params(resp, query)


def doc_exists(node: TorchNode, params, query, body):
    try:
        resp = node.get_doc(params["index"], params["id"],
                            routing=_routing_param(query),
                            realtime=_realtime_param(query))
    except OpenSearchTpuException:
        return 404, ""
    return (200 if resp.get("found") else 404), ""


def source_exists(node: TorchNode, params, query, body):
    try:
        resp = node.get_doc(params["index"], params["id"],
                            routing=_routing_param(query),
                            realtime=_realtime_param(query))
    except OpenSearchTpuException:
        return 404, ""
    return (200 if resp.get("found") and "_source" in resp else 404), ""


def get_source(node: TorchNode, params, query, body):
    resp = node.get_doc(params["index"], params["id"],
                        routing=_routing_param(query),
                        realtime=_realtime_param(query),
                        refresh=str(query.get("refresh", "false"))
                        in ("true", ""))
    # a hit without stored _source (mapping `_source.enabled: false`) is a
    # 404 for this endpoint, like RestGetSourceAction
    source_enabled = True
    svc = node.indices.get(resp.get("_index", params["index"]))
    if svc is not None:
        source_enabled = getattr(svc.mapper_service, "_source_enabled", True)
    if not resp.get("found") or resp.get("_source") is None \
            or not source_enabled:
        return 404, {"error": f"document [{params['id']}] not found"}
    src = resp["_source"]
    includes = query.get("_source_includes") or query.get("_source_include")
    excludes = query.get("_source_excludes") or query.get("_source_exclude")
    if includes or excludes:
        spec = {
            **({"includes": str(includes).split(",")} if includes else {}),
            **({"excludes": str(excludes).split(",")} if excludes else {}),
        }
        src = _source_filter(spec)(src)
    return 200, src


def delete_doc(node: TorchNode, params, query, body):
    if_seq_no = query.get("if_seq_no")
    resp = node.delete_doc(
        params["index"], params["id"],
        routing=_routing_param(query), refresh=_refresh_param(query),
        if_seq_no=int(if_seq_no) if if_seq_no is not None else None,
        **_version_params(query),
    )
    resp = _forced_refresh(resp, query)
    return (200 if resp["result"] == "deleted" else 404), resp


def update_doc(node: TorchNode, params, query, body):
    if_seq_no = query.get("if_seq_no")
    body = dict(body or {})
    if "_source" in query and "_source" not in body:
        v = str(query["_source"])
        body["_source"] = (True if v in ("true", "")
                           else False if v == "false" else v.split(","))
    resp = node.update_doc(
        params["index"], params["id"], body,
        routing=_routing_param(query), refresh=_refresh_param(query),
        if_seq_no=int(if_seq_no) if if_seq_no is not None else None,
        require_alias=query.get("require_alias") in ("true", ""),
    )
    return 200, _forced_refresh(resp, query)


def bulk(node: TorchNode, params, query, body):
    if not isinstance(body, list):
        raise IllegalArgumentException("bulk body must be NDJSON lines")
    default_index = params.get("index")
    ops: list[tuple[str, dict, dict | None]] = []
    i = 0
    while i < len(body):
        action_line = body[i]
        i += 1
        if not isinstance(action_line, dict) or len(action_line) != 1:
            raise IllegalArgumentException(
                f"Malformed action/metadata line [{i}], expected a single action"
            )
        action, meta = next(iter(action_line.items()))
        if action not in ("index", "create", "update", "delete"):
            raise IllegalArgumentException(f"Unknown bulk action [{action}]")
        meta = dict(meta or {})
        meta.setdefault("_index", default_index)
        if query.get("require_alias") in ("true", ""):
            meta.setdefault("require_alias", True)
        if meta.get("_index") is None:
            raise IllegalArgumentException(
                f"action [{action}] requires [_index] (line {i})"
            )
        source = None
        if action != "delete":
            if i >= len(body):
                raise IllegalArgumentException(
                    f"missing source line for [{action}] (line {i})"
                )
            source = body[i]
            i += 1
        ops.append((action, meta, source))
    return 200, node.bulk(ops, refresh=_refresh_param(query),
                          pipeline=query.get("pipeline"),
                          query_group=query.get("query_group"),
                          payload_bytes=query.get("_payload_bytes"))


# -- search ------------------------------------------------------------------


def _body_with_query_params(query, body):
    body = dict(body or {})
    if "q" in query:
        # URI search: the query_string mini-language (RestSearchAction's
        # q= handling, with df/default_operator)
        qs: dict = {"query": query["q"]}
        if "default_operator" in query:
            qs["default_operator"] = str(query["default_operator"]).lower()
        if "df" in query:
            qs["default_field"] = query["df"]
        if "analyze_wildcard" in query:
            qs["analyze_wildcard"] = str(query["analyze_wildcard"]) in (
                "true", "")
        body.setdefault("query", {"query_string": qs})
    for key in ("size", "from"):
        if key in query:
            body.setdefault(key, int(query[key]))
    if "sort" in query:
        body.setdefault("sort", [
            ({s.split(":")[0]: s.split(":")[1]} if ":" in s else s)
            for s in str(query["sort"]).split(",")
        ])
    # _source family as URL params (RestSearchAction / FetchSourceContext)
    includes = query.get("_source_includes") or query.get("_source_include")
    excludes = query.get("_source_excludes") or query.get("_source_exclude")
    if includes or excludes:
        body["_source"] = {
            **({"includes": str(includes).split(",")} if includes else {}),
            **({"excludes": str(excludes).split(",")} if excludes else {}),
        }
    elif "_source" in query:
        v = str(query["_source"])
        if v in ("true", ""):
            body.setdefault("_source", True)
        elif v == "false":
            body.setdefault("_source", False)
        else:
            body.setdefault("_source", v.split(","))
    if "stored_fields" in query:
        body.setdefault("stored_fields", str(query["stored_fields"]).split(","))
    if "docvalue_fields" in query:
        body.setdefault(
            "docvalue_fields", str(query["docvalue_fields"]).split(",")
        )
    if "include_named_queries_score" in query:
        body.setdefault("include_named_queries_score",
                        str(query["include_named_queries_score"]))
    if str(query.get("seq_no_primary_term", "false")) in ("true", ""):
        body.setdefault("seq_no_primary_term", True)
    if str(query.get("version", "false")) in ("true", ""):
        body.setdefault("version", True)
    if "pre_filter_shard_size" in query:
        body.setdefault("pre_filter_shard_size",
                        int(query["pre_filter_shard_size"]))
    if "track_total_hits" in query:
        v = str(query["track_total_hits"])
        body.setdefault(
            "track_total_hits",
            True if v in ("true", "") else False if v == "false" else int(v),
        )
    return body


def _totals_as_int(resp: dict, query) -> dict:
    """?rest_total_hits_as_int=true: hits.total as a plain integer (the
    pre-7.0 shape many YAML suites assert); applies to inner_hits too."""
    if str(query.get("rest_total_hits_as_int", "false")) not in ("true", ""):
        return resp

    def convert(obj):
        if isinstance(obj, dict):
            out = {}
            for k, v in obj.items():
                if k == "hits" and isinstance(v, dict):
                    if isinstance(v.get("total"), dict):
                        v = {**v, "total": v["total"].get("value", 0)}
                    elif "total" not in v and "hits" in v:
                        # track_total_hits=false renders total -1 as int
                        v = {**v, "total": -1}
                out[k] = convert(v)
            return out
        if isinstance(obj, list):
            return [convert(x) for x in obj]
        return obj

    return convert(resp)


def _agg_type_of(spec: dict) -> tuple[str, dict] | None:
    for k, v in spec.items():
        if k in ("aggs", "aggregations", "meta"):
            continue
        return k, v if isinstance(v, dict) else {}
    return None


def _typed_name(typ: str, conf: dict, result, ftype=None) -> str:
    """InternalAggregation.getWriteableName: the `type#name` prefix emitted
    with ?typed_keys=true."""
    if typ == "terms":
        if ftype is not None and ftype(conf.get("field")) == "unsigned_long":
            return "ulterms"
        keys = [b.get("key") for b in (result or {}).get("buckets", [])
                if isinstance(b, dict)]
        real = [k for k in keys if not isinstance(k, bool)]
        if real and all(isinstance(k, int) for k in real):
            return "lterms"
        if real and all(isinstance(k, (int, float)) for k in real):
            return "dterms"
        return "sterms"
    if typ in ("percentiles", "percentile_ranks"):
        engine = "hdr" if "hdr" in conf else "tdigest"
        return f"{engine}_{typ}"
    if typ in ("max_bucket", "min_bucket"):
        return "bucket_metric_value"
    if typ in ("avg_bucket", "sum_bucket", "bucket_script",
               "cumulative_sum", "serial_diff", "moving_fn", "moving_avg"):
        return "simple_value"
    if typ == "significant_terms":
        return "sigsterms"
    if typ == "rare_terms":
        return "srareterms"
    return typ


def _rename_typed_container(c: dict, sub_body: dict, ftype=None) -> dict:
    out = dict(c)
    for name, spec in sub_body.items():
        if name not in out or not isinstance(spec, dict):
            continue
        result = out.pop(name)
        t = _agg_type_of(spec)
        deeper = spec.get("aggs") or spec.get("aggregations")
        if isinstance(result, dict) and deeper:
            b = result.get("buckets")
            result = dict(result)
            if isinstance(b, list):
                result["buckets"] = [
                    _rename_typed_container(x, deeper, ftype)
                    if isinstance(x, dict) else x for x in b
                ]
            elif isinstance(b, dict):
                result["buckets"] = {
                    k: _rename_typed_container(x, deeper, ftype)
                    if isinstance(x, dict) else x for k, x in b.items()
                }
            else:  # single-bucket agg: sub results inline
                result = _rename_typed_container(result, deeper, ftype)
        out[f"{_typed_name(t[0], t[1], result, ftype)}#{name}"
            if t else name] = result
    return out


def _apply_typed_keys(resp: dict, query, body, node=None,
                      index_expr=None) -> dict:
    """?typed_keys=true: suggestion and aggregation names prefixed with
    their kind (the port's search serves aggregations; suggestions are not
    ported yet, so a response has none to rename)."""
    if str(query.get("typed_keys", "false")) not in ("true", ""):
        return resp
    sug_body = (body or {}).get("suggest")
    sug_resp = resp.get("suggest")
    if isinstance(sug_body, dict) and isinstance(sug_resp, dict):
        renamed = {}
        for name, entries in sug_resp.items():
            conf = sug_body.get(name)
            kind = None
            if isinstance(conf, dict):
                kind = next((k for k in ("term", "phrase", "completion")
                             if k in conf), None)
            renamed[f"{kind}#{name}" if kind else name] = entries
        resp = {**resp, "suggest": renamed}
    aggs_body = (body or {}).get("aggs") or (body or {}).get("aggregations")
    aggs_resp = resp.get("aggregations")
    if not aggs_body or not isinstance(aggs_resp, dict):
        return resp

    def ftype(field):
        if node is None or not field:
            return None
        try:
            names = (node.resolve_indices(index_expr) if index_expr
                     else sorted(node.indices))
            for n in names:
                m = node.indices[n].mapper_service.field_mapper(field)
                if m is not None:
                    return m.original_type or m.type
        except Exception as e:  # noqa: BLE001
            logger.debug("typed-keys field-type lookup failed: %s", e)
            return None
        return None

    return {**resp, "aggregations":
            _rename_typed_container(aggs_resp, aggs_body, ftype)}


def _with_reduce_phases(resp, query):
    """num_reduce_phases when a batched reduce was requested
    (QueryPhaseResultConsumer: one merge per (batch-1) results)."""
    if "batched_reduce_size" not in query or "_shards" not in resp:
        return resp
    b = int(query["batched_reduce_size"])
    n = int(resp["_shards"].get("total", 1))
    if b >= n or b < 2:
        phases = 1
    else:
        phases = -(-(n - 1) // (b - 1))
    return {**resp, "num_reduce_phases": phases}


def _validate_search_params(query, body=None):
    """Request-param validation (SearchRequest.validate analogs)."""
    if "pre_filter_shard_size" in query:
        if int(query["pre_filter_shard_size"]) < 1:
            raise IllegalArgumentException(
                "preFilterShardSize must be >= 1"
            )
    if str(query.get("rest_total_hits_as_int", "false")) in ("true", ""):
        tth = (body or {}).get("track_total_hits", True)
        if tth not in (True, False):
            raise IllegalArgumentException(
                f"[rest_total_hits_as_int] cannot be used if the tracking "
                f"of total hits is not accurate, got {tth}"
            )
    if "search_type" in query:
        st = str(query["search_type"])
        if st not in ("query_then_fetch", "dfs_query_then_fetch"):
            raise IllegalArgumentException(
                f"No search type for [{st}]"
            )
    if "batched_reduce_size" in query:
        if int(query["batched_reduce_size"]) < 2:
            raise IllegalArgumentException("batchedReduceSize must be >= 2")
    if query.get("scroll") is not None:
        size = (body or {}).get("size", query.get("size"))
        if size is not None and int(size) == 0:
            raise IllegalArgumentException(
                "[size] cannot be [0] in a scroll context"
            )
        if str(query.get("request_cache", "")).lower() == "true":
            raise IllegalArgumentException(
                "[request_cache] cannot be used in a scroll context"
            )


def search(node: TorchNode, params, query, body):
    _validate_search_params(query, body)
    rc = query.get("request_cache")
    resp = node.search(params["index"], _body_with_query_params(query, body),
                       scroll=query.get("scroll"),
                       search_pipeline=query.get("search_pipeline"),
                       ignore_unavailable=str(
                           query.get("ignore_unavailable", "false")
                       ) in ("true", ""),
                       query_group=query.get("query_group"),
                       request_cache=(None if rc is None
                                      else str(rc) in ("true", "")))
    resp = _with_reduce_phases(resp, query)
    resp = _apply_typed_keys(resp, query, body, node, params.get("index"))
    return 200, _totals_as_int(resp, query)


def search_all(node: TorchNode, params, query, body):
    # index=None (not "_all"): a PIT body carries its own shard set and is
    # only legal without an index in the path
    _validate_search_params(query, body)
    resp = node.search(None, _body_with_query_params(query, body),
                       scroll=query.get("scroll"),
                       search_pipeline=query.get("search_pipeline"))
    resp = _with_reduce_phases(resp, query)
    resp = _apply_typed_keys(resp, query, body, node)
    return 200, _totals_as_int(resp, query)


def count(node: TorchNode, params, query, body):
    return 200, node.count(params["index"], _body_with_query_params(query, body))


def count_all(node: TorchNode, params, query, body):
    return 200, node.count("_all", _body_with_query_params(query, body))


def msearch(node: TorchNode, params, query, body):
    if not isinstance(body, list):
        raise IllegalArgumentException("msearch body must be NDJSON lines")
    default_index = params.get("index")
    searches = []
    for i in range(0, len(body) - 1, 2):
        header = body[i] or {}
        if default_index is not None:
            header.setdefault("index", default_index)
        searches.append((header, body[i + 1]))
    as_int = str(query.get("rest_total_hits_as_int", "false")) in ("true", "")
    if as_int:
        # the coordinator validates EVERY sub-request up front
        # (RestMultiSearchAction + SearchRequest.validate)
        for _header, sbody in searches:
            tth = (sbody or {}).get("track_total_hits", True)
            if tth not in (True, False):
                raise IllegalArgumentException(
                    f"[rest_total_hits_as_int] cannot be used if the "
                    f"tracking of total hits is not accurate, got {tth}"
                )
    resp = node.msearch(searches)
    out = []
    for (header, sbody), r in zip(searches, resp["responses"]):
        if isinstance(r, dict) and "error" in r and "hits" not in r:
            err = r["error"]
            if isinstance(err, dict) and "root_cause" not in err:
                r = {"error": {"root_cause": [err], **err},
                     "status": r.get("status", 500)}
        else:
            r = _apply_typed_keys(r, query, sbody, node, header.get("index"))
            r = _totals_as_int(r, query)
            r = {**r, "status": 200}
        out.append(r)
    return 200, {**resp, "responses": out}


# -- stored scripts and search templates -------------------------------------


def put_stored_script(node: TorchNode, params, query, body):
    return 200, node.put_stored_script(params["id"], body or {})


def get_stored_script(node: TorchNode, params, query, body):
    resp = node.get_stored_script(params["id"])
    return (200 if resp.get("found") else 404), resp


def delete_stored_script(node: TorchNode, params, query, body):
    return 200, node.delete_stored_script(params["id"])


def get_script_context(node: TorchNode, params, query, body):
    """GET /_script_context (GetScriptContextAction): the contexts the
    painless subset serves."""
    return 200, {"contexts": [
        {"name": name, "methods": [{"name": "execute",
                                    "return_type": return_type,
                                    "params": []}]}
        for name, return_type in (
            ("aggs", "java.lang.Object"),
            ("aggs_combine", "java.lang.Object"),
            ("field", "java.lang.Object"),
            ("filter", "boolean"),
            ("ingest", "void"),
            ("score", "double"),
            ("update", "void"))]}


def get_script_languages(node: TorchNode, params, query, body):
    """GET /_script_language (GetScriptLanguageAction)."""
    return 200, {
        "types_allowed": ["inline", "stored"],
        "language_contexts": [
            {"language": "mustache", "contexts": ["template"]},
            {"language": "painless", "contexts": [
                "aggs", "field", "filter", "ingest", "score", "update"]},
        ],
    }


def search_template(node: TorchNode, params, query, body):
    resp = node.search_template(
        params["index"], body or {}, scroll=query.get("scroll"),
        search_pipeline=query.get("search_pipeline"))
    return 200, _totals_as_int(resp, query)


def search_template_all(node: TorchNode, params, query, body):
    resp = node.search_template(
        None, body or {}, scroll=query.get("scroll"),
        search_pipeline=query.get("search_pipeline"))
    return 200, _totals_as_int(resp, query)


def render_template(node: TorchNode, params, query, body):
    return 200, {"template_output": node.render_search_template(
        body or {}, params.get("id"))}


# -- search pipelines ---------------------------------------------------------


def put_search_pipeline(node: TorchNode, params, query, body):
    node.search_pipelines.put(params["id"], body or {})
    return 200, {"acknowledged": True}


def get_search_pipelines(node: TorchNode, params, query, body):
    return 200, dict(node.search_pipelines.pipelines)


def get_search_pipeline(node: TorchNode, params, query, body):
    return 200, {params["id"]: node.search_pipelines.get(params["id"])}


def delete_search_pipeline(node: TorchNode, params, query, body):
    node.search_pipelines.delete(params["id"])
    return 200, {"acknowledged": True}


# -- maintenance -------------------------------------------------------------


def refresh(node: TorchNode, params, query, body):
    return 200, node.refresh(params["index"])


def refresh_all(node: TorchNode, params, query, body):
    return 200, node.refresh("_all")


# -- cluster -----------------------------------------------------------------


_HEALTH_RANK = {"green": 0, "yellow": 1, "red": 2}


def cluster_health(node: TorchNode, params, query, body):
    resp = node.cluster_health(
        params.get("index"),
        level=str(query.get("level", "cluster")),
        expand_wildcards=str(query.get("expand_wildcards", "all")),
    )
    want = query.get("wait_for_status")
    if want in _HEALTH_RANK and \
            _HEALTH_RANK[resp["status"]] > _HEALTH_RANK[want]:
        # the single-node state is static: an unreachable status times out
        # immediately (RestClusterHealthAction returns 408 + timed_out)
        resp = {**resp, "timed_out": True}
        return 408, resp
    if "wait_for_nodes" in query:
        spec = str(query["wait_for_nodes"])
        n = resp["number_of_nodes"]
        m = re.fullmatch(r"(>=|<=|>|<|==)?(\d+)", spec)
        ok = False
        if m:
            op, num = m.group(1) or "==", int(m.group(2))
            ok = {"==": n == num, ">=": n >= num, "<=": n <= num,
                  ">": n > num, "<": n < num}[op]
        if not ok:
            return 408, {**resp, "timed_out": True}
    if "wait_for_active_shards" in query:
        spec = str(query["wait_for_active_shards"])
        if spec != "all" and spec.isdigit() \
                and resp["active_shards"] < int(spec):
            return 408, {**resp, "timed_out": True}
    return 200, resp


def roofline_report(node: TorchNode, params, query, body):
    """GET /_roofline — kernel families ranked by LOST TIME (cumulative
    fenced wall x gap-to-roofline) against the calibrated peaks. The
    recorder is process-wide (one process == one device), so nodes in one
    process share one report."""
    from opensearch_tpu_torch.telemetry import roofline

    return 200, roofline.default_recorder.report()


def roofline_calibrate(node: TorchNode, params, query, body):
    """POST /_roofline/calibrate — re-run the one-shot product/copy probe
    on the node's device and swap the peak table every roofline fraction
    divides by."""
    from opensearch_tpu_torch.telemetry import roofline

    peaks = roofline.calibrate(force=True, device=node.device)
    return 200, {"acknowledged": True, "peaks": peaks.to_dict()}


def tiering_advise(node: TorchNode, params, query, body):
    """GET /_tiering/advise?hbm_budget=... — the what-if tiering advisor
    (telemetry/device_ledger.py): replay the recorded structure-access
    stream against a device-memory tier of the given budget (the
    shard-mesh registry's LRU-by-bytes semantics) and report projected hit
    bytes, re-upload traffic and estimated added latency per structure,
    with an HBM / host-RAM / evicted tier recommendation. `hbm_budget`
    accepts human-readable sizes ("512mb"); absent, the current
    `search.mesh.hbm_budget_bytes` is simulated."""
    from opensearch_tpu_torch.cluster.shard_mesh import default_registry
    from opensearch_tpu_torch.common.settings import parse_bytes
    from opensearch_tpu_torch.telemetry.device_ledger import default_ledger

    raw = query.get("hbm_budget")
    if raw in (None, ""):
        budget = default_registry.hbm_budget_bytes
    else:
        try:
            budget = parse_bytes(raw)
        except (ValueError, TypeError):
            raise IllegalArgumentException(
                f"failed to parse [hbm_budget] value [{raw}]")
        if budget < 0:
            raise IllegalArgumentException(
                f"[hbm_budget] must be >= 0 (0 simulates an unbounded "
                f"tier), got [{raw}]")
    return 200, default_ledger.advise_tiering(budget)


# -- search contexts ----------------------------------------------------------


def scroll(node: TorchNode, params, query, body):
    body = body or {}
    # body params override path/query (RestSearchScrollAction)
    scroll_id = (body.get("scroll_id") or params.get("scroll_id")
                 or query.get("scroll_id"))
    if not scroll_id:
        raise IllegalArgumentException("scroll_id is required")
    keep = body.get("scroll") or query.get("scroll")
    return 200, _totals_as_int(node.scroll(str(scroll_id), keep), query)


def clear_scroll(node: TorchNode, params, query, body):
    body = body or {}
    ids = (body.get("scroll_id") or params.get("scroll_id")
           or query.get("scroll_id"))
    if not ids:
        raise IllegalArgumentException(
            "scroll_id is required (use _all to clear every scroll)")
    if isinstance(ids, str):
        ids = None if ids == "_all" else ids.split(",")
    resp = node.clear_scroll(ids)
    # explicit ids that freed nothing -> 404 (RestClearScrollAction status)
    status = 404 if ids and resp.get("num_freed", 0) == 0 else 200
    return status, resp


def open_pit(node: TorchNode, params, query, body):
    keep_alive = query.get("keep_alive")
    if not keep_alive:
        raise IllegalArgumentException(
            "[keep_alive] is required to open a PIT")
    return 200, node.open_pit(params["index"], keep_alive)


def close_pit(node: TorchNode, params, query, body):
    body = body or {}
    ids = body.get("pit_id")
    if not ids:
        raise IllegalArgumentException(
            "pit_id is required (DELETE /_search/point_in_time/_all closes "
            "all)")
    if isinstance(ids, str):
        ids = [ids]
    return 200, node.close_pit(ids)


def close_all_pits(node: TorchNode, params, query, body):
    return 200, node.close_pit(None)


def get_all_pits(node: TorchNode, params, query, body):
    return 200, node.list_all_pits()


# -- flush, force merge, request cache ----------------------------------------


def flush(node: TorchNode, params, query, body):
    return 200, node.flush(params["index"])


def flush_all(node: TorchNode, params, query, body):
    return 200, node.flush("_all")


def forcemerge(node: TorchNode, params, query, body):
    return 200, node.force_merge(
        params.get("index", "_all"),
        max_num_segments=int(query.get("max_num_segments", 1)),
        only_expunge_deletes=(
            str(query.get("only_expunge_deletes", "false")).lower() == "true"),
        flush=str(query.get("flush", "true")).lower() != "false")


def clear_cache(node: TorchNode, params, query, body):
    n = node.request_cache.clear(params.get("index"))
    return 200, {"_shards": {"total": 1, "successful": 1, "failed": 0},
                 "cleared": n}


def clear_cache_all(node: TorchNode, params, query, body):
    n = node.request_cache.clear(None)
    return 200, {"_shards": {"total": 1, "successful": 1, "failed": 0},
                 "cleared": n}


# -- aliases -------------------------------------------------------------------


def update_aliases(node: TorchNode, params, query, body):
    return 200, node.update_aliases(body or {})


def put_alias(node: TorchNode, params, query, body):
    # the body's index/alias OVERRIDE the path parts (RestIndexPutAliasAction
    # reads both forms); one of each must resolve
    body = body or {}
    if not isinstance(body, dict):
        raise IllegalArgumentException(
            "put alias request body must be an object")
    index = body.get("index") or params.get("index")
    name = body.get("alias") or params.get("name")
    if not index or not name:
        raise IllegalArgumentException(
            "put alias requires an index and an alias name")
    if any(c in str(name) for c in '*?"<>| ,#'):
        raise IllegalArgumentException(f"invalid alias name [{name}]")
    conf = {k: v for k, v in body.items() if k not in ("index", "alias")}
    unknown = set(conf) - {"filter", "routing", "index_routing",
                           "search_routing", "is_write_index", "is_hidden",
                           "must_exist"}
    if unknown:
        raise IllegalArgumentException(
            f"unknown field [{sorted(unknown)[0]}]")
    return 200, node.put_alias(str(index), str(name), conf)


def delete_alias(node: TorchNode, params, query, body):
    return 200, node.delete_alias(params["index"], params["name"])


def _alias_response(resp: dict):
    # the 404 body KEEPS the status/error riders beside the found aliases;
    # "status" and "error" are legal INDEX names too, whose entries are
    # dicts
    status = resp.get("status")
    if isinstance(status, int) and isinstance(resp.get("error"), str):
        return status, resp
    return 200, resp


def exists_alias(node: TorchNode, params, query, body):
    resp = node.get_alias(
        index_expr=params.get("index"), alias_expr=params["name"],
        expand_wildcards=str(query.get("expand_wildcards", "all")))
    found = any(v.get("aliases") for v in resp.values()
                if isinstance(v, dict))
    missed = isinstance(resp.get("error"), str) and \
        isinstance(resp.get("status"), int)
    return (200 if found and not missed else 404), ""


def get_alias_all(node: TorchNode, params, query, body):
    return _alias_response(node.get_alias(
        expand_wildcards=str(query.get("expand_wildcards", "all"))))


def get_alias_by_name(node: TorchNode, params, query, body):
    return _alias_response(node.get_alias(
        alias_expr=params["name"],
        expand_wildcards=str(query.get("expand_wildcards", "all"))))


def get_alias_index(node: TorchNode, params, query, body):
    return _alias_response(node.get_alias(
        index_expr=params["index"],
        expand_wildcards=str(query.get("expand_wildcards", "all"))))


def get_alias_index_name(node: TorchNode, params, query, body):
    return _alias_response(node.get_alias(
        index_expr=params["index"], alias_expr=params["name"],
        expand_wildcards=str(query.get("expand_wildcards", "all"))))


# -- tasks -----------------------------------------------------------------------


def _parse_task_id(raw: str) -> int:
    # accepts both "<id>" and "<node>:<id>" forms
    try:
        return int(raw.rsplit(":", 1)[-1])
    except ValueError:
        raise IllegalArgumentException(f"malformed task id [{raw}]") from None


def list_tasks(node: TorchNode, params, query, body):
    # the listing request itself runs as a task
    # (TransportListTasksAction registers), so the map is never empty
    detailed = str(query.get("detailed", "false")) in ("true", "")
    with node.task_manager.task_scope(
            "cluster:monitor/tasks/lists", description="task list"):
        tasks = node.task_manager.list_tasks(query.get("actions"))
        task_map = {}
        for t in tasks:
            d = t.to_dict()
            full = t.resource_stats()
            rs = {"total": {
                # a still-running task has accrued no scope CPU yet;
                # floor at 1ns like the reference's sampled minimum
                "cpu_time_in_nanos": max(
                    full["total"]["cpu_time_in_nanos"], 1),
                "memory_in_bytes": full["total"]["memory_in_bytes"],
            }}
            if detailed:
                rs["thread_info"] = dict(
                    full["thread_info"],
                    thread_executions=max(
                        full["thread_info"]["thread_executions"], 1))
            d.setdefault("resource_stats", rs)
            task_map[f"{t.node}:{t.id}"] = d
    group_by = str(query.get("group_by", "nodes"))
    if group_by == "none":
        # ListTasksResponse renders an ARRAY for group_by=none
        return 200, {"tasks": list(task_map.values())}
    if group_by == "parents":
        return 200, {"tasks": task_map}
    return 200, {"nodes": {node.node_name: {
        "name": node.node_name,
        "transport_address": "127.0.0.1:9300",
        "host": "127.0.0.1",
        "ip": "127.0.0.1:9300",
        "roles": ["cluster_manager", "data", "ingest",
                  "remote_cluster_client"],
        "tasks": task_map,
    }}}


def get_task(node: TorchNode, params, query, body):
    raw = str(params["task_id"])
    owner = raw.rsplit(":", 1)[0] if ":" in raw else node.node_name
    if owner not in (node.node_name, "node-0"):
        raise ResourceNotFoundException(
            f"task [{raw}] belongs to the node [{owner}] which isn't part "
            f"of the cluster and there is no record of the task")
    task, completed = node.task_manager.get_any(
        _parse_task_id(params["task_id"]))
    return 200, {"completed": completed, "task": task.to_dict()}


def cancel_tasks(node: TorchNode, params, query, body):
    cancelled = node.task_manager.cancel_matching(query.get("actions"))
    # nodes with nothing cancelled are omitted (TransportTasksAction only
    # reports nodes that matched)
    nodes = ({node.node_name: {"cancelled_task_ids": cancelled}}
             if cancelled else {})
    return 200, {"nodes": nodes, "node_failures": [], "task_failures": []}


def cancel_task(node: TorchNode, params, query, body):
    cancelled = node.task_manager.cancel(_parse_task_id(params["task_id"]))
    return 200, {"nodes": {node.node_name: {"cancelled_task_ids": cancelled}},
                 "node_failures": [], "task_failures": []}


# -- cluster settings, span export --------------------------------------------


def get_cluster_settings(node: TorchNode, params, query, body):
    return 200, node.get_cluster_settings(
        flat=str(query.get("flat_settings", "false")) in ("true", ""),
        include_defaults=str(query.get("include_defaults", "false"))
        in ("true", ""))


def put_cluster_settings(node: TorchNode, params, query, body):
    return 200, node.put_cluster_settings(
        body or {},
        flat=str(query.get("flat_settings", "false")) in ("true", ""))


def otel_flush(node: TorchNode, params, query, body):
    """POST /_otel/flush: the span exporter decides every pending trace
    fragment and drains to its sink; the response carries the exporter's
    ledger and the device-memory residency snapshot; on a cluster node
    (cluster/facade.py) every node's."""
    cluster_flush = getattr(node, "cluster_otel_flush", None)
    if cluster_flush is not None:
        return 200, cluster_flush()
    from opensearch_tpu_torch.telemetry import device_ledger

    exporter = node.telemetry.tracer.exporter
    if exporter is not None:
        exporter.flush()
    return 200, {
        "_nodes": {"total": 1, "successful": 1, "failed": 0},
        "cluster_name": "opensearch-tpu",
        "nodes": {"node-0": {
            "name": node.node_name,
            "flushed": exporter is not None,
            "exporter": (exporter.snapshot_stats()
                         if exporter is not None else None),
            "device": device_ledger.stats_section(),
        }},
    }


# -- workload management ---------------------------------------------------------


def put_query_group(node: TorchNode, params, query, body):
    return 200, node.query_groups.put(body or {})


def get_query_groups(node: TorchNode, params, query, body):
    return 200, node.query_groups.get()


def get_query_group(node: TorchNode, params, query, body):
    return 200, node.query_groups.get(params["name"])


def delete_query_group(node: TorchNode, params, query, body):
    return 200, node.query_groups.delete(params["name"])


def wlm_stats(node: TorchNode, params, query, body):
    return 200, {"query_groups": node.query_groups.stats()}


def wlm_stats_list(node: TorchNode, params, query, body):
    """GET /_list/wlm_stats (the workload-management plugin's paginated
    list): a text table of per-(node, workload group) lifetime counters."""
    if query.get("size") is not None:
        try:
            size = int(query["size"])
        except ValueError:
            size = -1
        if not 1 <= size <= 100:
            raise IllegalArgumentException(
                "Invalid value for 'size'. Allowed range: 1 to 100")
    else:
        size = 10
    sort = str(query.get("sort", "node_id"))
    if sort not in ("node_id", "workload_group"):
        raise IllegalArgumentException(
            "Invalid value for 'sort'. Allowed: 'node_id', 'workload_group'")
    order = str(query.get("order", "asc"))
    if order not in ("asc", "desc"):
        raise IllegalArgumentException(
            "Invalid value for 'order'. Allowed: 'asc', 'desc'")
    if query.get("next_token"):
        # the single-node list never hands out a token, so any presented
        # token is from a previous pagination epoch
        return 400, {
            "error": "Pagination state has changed (e.g., new workload "
                     "groups added or removed). Please restart pagination "
                     "from the beginning by omitting the 'next_token' "
                     "parameter.",
            "status": 400,
        }
    rows = [
        {"NODE_ID": "node-0",
         "WORKLOAD_GROUP_ID": gid,
         "TOTAL_COMPLETIONS": t["total_completions"],
         "TOTAL_REJECTIONS": t["total_rejections"],
         "TOTAL_CANCELLATIONS": t["total_cancellations"]}
        for gid, t in node.query_groups.totals().items()
    ]
    key = "NODE_ID" if sort == "node_id" else "WORKLOAD_GROUP_ID"
    rows.sort(key=lambda r: str(r[key]), reverse=(order == "desc"))
    return 200, _cat_format(query, rows[:size])


def _cat_format(query, rows: list[dict], cols: list[str] | None = None,
                aliases: dict[str, str] | None = None,
                help_cols: list[str] | None = None) -> Any:
    """Render a _cat table (rest/action/cat/ RestTable): `help` lists the
    columns (help_cols may include hidden non-default ones), `h`
    selects/orders them (accepting per-API column aliases), `s` sorts
    rows, `v` adds headers."""
    cols = cols or (list(rows[0].keys()) if rows else [])
    if str(query.get("help", "false")) in ("true", ""):
        return "".join(f"{c} | | \n" for c in (help_cols or cols))
    if query.get("format") == "json":
        return rows
    def _listy(v):
        return [str(x) for x in v] if isinstance(v, list) \
            else [x.strip() for x in str(v).split(",")]

    if query.get("s"):
        for key in reversed(_listy(query["s"])):
            key, _, order = key.partition(":")
            key = (aliases or {}).get(key, key)
            rows = sorted(rows, key=lambda r: str(r.get(key, "")),
                          reverse=(order == "desc"))
    disp = None
    if query.get("h"):
        # wildcard selections expand against EVERY available column (row
        # keys), not just the default display set; headers echo the
        # REQUESTED name (aliases stay aliases in the header row)
        universe = list(rows[0].keys()) if rows else cols
        sel = []
        disp = []
        for raw in _listy(query["h"]):
            c = (aliases or {}).get(raw, raw)
            if "*" in c:
                import fnmatch as _fnm

                for u in universe:
                    if _fnm.fnmatch(u, c):
                        sel.append(u)
                        disp.append(u)
            elif c:
                sel.append(c)
                disp.append(raw)
        cols = sel
    show_header = str(query.get("v", "false")) in ("true", "")
    if not rows and not show_header:
        return ""
    disp = disp or cols
    widths = {
        c: max(len(str(d)) if show_header else 0,
               *(len(str(r.get(c, ""))) for r in rows), 0)
        for c, d in zip(cols, disp)
    }

    import re as _re

    def _numeric_cell(v) -> bool:
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return True
        # byte-size / percent strings right-justify like numbers
        return bool(_re.fullmatch(r"-?\d+(\.\d+)?([kmgtp]?b|%)?", str(v)))

    def render(values, header=False):
        # every cell pads to column width EXCEPT the last (RestTable emits
        # no trailing pad after the final cell); numbers right-justify
        cells = []
        for c, v in zip(cols, values):
            cells.append(str(v).rjust(widths[c])
                         if _numeric_cell(v) and not header
                         else str(v).ljust(widths[c]))
        if cells and (header or not _numeric_cell(values[-1])):
            cells[-1] = str(values[-1])
        return " ".join(cells)

    lines = []
    if show_header:
        lines.append(render(disp, header=True))
    for r in rows:
        lines.append(render([r.get(c, "") for c in cols]))
    return "\n".join(lines) + "\n"


# -- ingest, templates, segments and the node's stats ---------------------


def put_pipeline(node: TorchNode, params, query, body):
    if not isinstance(body, dict):
        raise IllegalArgumentException("request body is required")
    return 200, node.ingest.put_pipeline(params["id"], body)


def get_pipelines(node: TorchNode, params, query, body):
    return 200, node.ingest.get_pipeline(None)


def get_pipeline(node: TorchNode, params, query, body):
    return 200, node.ingest.get_pipeline(params["id"])


def delete_pipeline(node: TorchNode, params, query, body):
    return 200, node.ingest.delete_pipeline(params["id"])


def simulate_pipeline(node: TorchNode, params, query, body):
    verbose = str(query.get("verbose", "false")) in ("true", "")
    return 200, node.ingest.simulate(body or {}, pipeline_id=params["id"],
                                     verbose=verbose)


def simulate_inline(node: TorchNode, params, query, body):
    verbose = str(query.get("verbose", "false")) in ("true", "")
    return 200, node.ingest.simulate(body or {}, verbose=verbose)


def put_index_template(node: TorchNode, params, query, body):
    return 200, node.put_index_template(params["name"], body or {})


def put_legacy_template(node: TorchNode, params, query, body):
    return 200, node.put_legacy_template(
        params["name"], body or {},
        create=str(query.get("create", "false")) in ("true", ""))


def get_legacy_templates(node: TorchNode, params, query, body):
    out = node.get_legacy_templates(params.get("name"))
    if str(query.get("flat_settings", "false")) not in ("true", ""):
        out = {n: {**t, "settings":
                   Settings.from_flat(t.get("settings") or {}).as_nested()}
               for n, t in out.items()}
    return 200, out


def legacy_template_exists(node: TorchNode, params, query, body):
    try:
        node.get_legacy_templates(params["name"])
        return 200, ""
    except ResourceNotFoundException:
        return 404, ""


def delete_legacy_template(node: TorchNode, params, query, body):
    return 200, node.delete_legacy_template(params["name"])


def get_index_templates(node: TorchNode, params, query, body):
    return 200, node.get_index_template()


def get_index_template(node: TorchNode, params, query, body):
    return 200, node.get_index_template(params["name"])


def delete_index_template(node: TorchNode, params, query, body):
    return 200, node.delete_index_template(params["name"])


def put_component_template(node: TorchNode, params, query, body):
    return 200, node.put_component_template(params["name"], body or {})


def get_component_templates(node: TorchNode, params, query, body):
    return 200, node.get_component_template()


def get_component_template(node: TorchNode, params, query, body):
    return 200, node.get_component_template(params["name"])


def delete_component_template(node: TorchNode, params, query, body):
    return 200, node.delete_component_template(params["name"])


def _admin_indices(node: TorchNode, params, query,
                   expand_default: str = "open") -> list[str]:
    return node.resolve_indices(
        params.get("index", "_all"),
        ignore_unavailable=str(query.get("ignore_unavailable", "false"))
        in ("true", ""),
        allow_no_indices=str(query.get("allow_no_indices", "true"))
        in ("true", ""),
        expand_wildcards=str(query.get("expand_wildcards", expand_default)),
    )


def indices_segments(node: TorchNode, params, query, body):
    """GET [/{index}]/_segments (IndicesSegmentsAction): the sealed
    segment inventory per shard; a closed index named outright is a 400
    unless `ignore_unavailable`, one a pattern reaches is skipped."""
    explicit = params.get("index") and not any(
        c in str(params["index"]) for c in "*?")
    ignore = str(query.get("ignore_unavailable", "false")) in ("true", "")
    names = []
    for n in _admin_indices(node, params, query):
        if node.indices[n].closed:
            if explicit and not ignore:
                raise IndexClosedException(n)
            continue
        names.append(n)
    out_indices = {}
    n_shards = 0
    for name in names:
        svc = node.indices[name]
        shards_out = {}
        for sid, shard in sorted(svc.shards.items()):
            n_shards += 1
            segments = {}
            for gen, (host, _dev) in enumerate(shard.engine._segments):
                live = int(host.live.sum())
                segments[f"_{gen}"] = {
                    "generation": gen,
                    "num_docs": live,
                    "deleted_docs": host.n_docs - live,
                    "size_in_bytes": sum(len(s) for s in host.sources),
                    "committed": True,
                    "search": True,
                    "version": "10.3.0",
                    "compound": True,
                }
            shards_out[str(sid)] = [{
                "routing": {"state": "STARTED", "primary": True,
                            "node": "node-0"},
                "num_committed_segments": len(segments),
                "num_search_segments": len(segments),
                "segments": segments,
            }]
        out_indices[name] = {"shards": shards_out}
    return 200, {
        "_shards": {"total": n_shards, "successful": n_shards, "failed": 0},
        "indices": out_indices,
    }


def cluster_stats(node: TorchNode, params, query, body):
    stats = node.index_stats("_all")
    doc_count = (stats["_all"]["primaries"].get("docs") or {}).get("count", 0)
    return 200, {
        "cluster_name": "opensearch-tpu",
        "status": "green",
        "indices": {
            "count": len(node.indices),
            "docs": {"count": doc_count},
            "shards": {
                "total": sum(s.num_shards for s in node.indices.values()),
            },
        },
        "nodes": {
            "count": {"total": 1, "data": 1, "cluster_manager": 1,
                      "master": 1, "ingest": 1,
                      "remote_cluster_client": 1, "coordinating_only": 0,
                      "search": 0, "warm": 0},
            "versions": [__version__],
            "discovery_types": {"zen": 1},
            "packaging_types": [{"type": "tar", "count": 1}],
        },
    }


_STATS_PARAMS = {
    "fields", "completion_fields", "fielddata_fields", "groups", "level",
    "include_segment_file_sizes", "include_unloaded_segments",
    "forbid_closed_indices", "expand_wildcards", "ignore_unavailable",
    "human", "error_trace", "pretty", "filter_path",
}


def _do_stats(node: TorchNode, params, query):
    bad = [k for k in query if k not in _STATS_PARAMS]
    if bad:
        raise IllegalArgumentException(
            f"request [/_stats] contains unrecognized parameter: [{bad[0]}]"
        )
    metric = params.get("metric")
    return 200, node.index_stats(
        params.get("index", "_all"),
        metrics=(str(metric).split(",") if metric else None),
        fields=query.get("fields"),
        completion_fields=query.get("completion_fields"),
        fielddata_fields=query.get("fielddata_fields"),
        groups=query.get("groups"),
        level=str(query.get("level", "indices")),
        include_segment_file_sizes=str(
            query.get("include_segment_file_sizes", "false")) in ("true", ""),
        human=str(query.get("human", "false")) in ("true", ""),
    )


def all_stats(node: TorchNode, params, query, body):
    return _do_stats(node, params, query)


def index_stats(node: TorchNode, params, query, body):
    return _do_stats(node, params, query)


def _prom_name(name: str) -> str:
    return "opensearch_tpu_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def _prom_fmt(v) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _prom_labels(labels: dict | None, extra: dict | None = None) -> str:
    merged = {**(labels or {}), **(extra or {})}
    if not merged:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in merged.items())
    return "{" + inner + "}"


def _prom_registry_lines(stats: dict, labels: dict | None,
                         declare_types: bool,
                         want_exemplars: bool) -> list[str]:
    """Render one MetricsRegistry.stats() snapshot. With `want_exemplars`,
    histogram buckets that carry an exemplar append it in OpenMetrics
    exemplar syntax — `... # {trace_id="..."} value` — so a p99 bucket
    links directly to the trace the span exporter can ship (the closed
    telemetry loop). That suffix is only legal in the OpenMetrics format,
    so it is opt-in: the default exposition stays classic-text-parseable
    by a stock Prometheus scrape."""
    lines: list[str] = []
    for name in sorted(stats.get("counters", {})):
        m = _prom_name(name)
        if declare_types:
            lines.append(f"# TYPE {m} counter")
        lines.append(
            f"{m}{_prom_labels(labels)} {_prom_fmt(stats['counters'][name])}")

    def histogram_series(m: str, h: dict, series_labels: dict | None,
                         with_minmax: bool) -> None:
        exemplars = ({e["le"]: e for e in h.get("exemplars", [])}
                     if want_exemplars else {})

        def bucket_line(le_text, count, le_key):
            line = (f'{m}_bucket'
                    f'{_prom_labels(series_labels, {"le": le_text})} '
                    f"{_prom_fmt(count)}")
            ex = exemplars.get(le_key)
            if ex is not None:
                line += (f' # {{trace_id="{ex["trace_id"]}"}} '
                         f'{_prom_fmt(ex["value"])}')
            return line

        for b in h.get("buckets", []):
            lines.append(bucket_line(_prom_fmt(b["le"]), b["count"], b["le"]))
        lines.append(bucket_line("+Inf", h["count"], "+Inf"))
        lines.append(
            f"{m}_count{_prom_labels(series_labels)} {_prom_fmt(h['count'])}")
        lines.append(
            f"{m}_sum{_prom_labels(series_labels)} {_prom_fmt(h['sum'])}")
        if not with_minmax:
            return
        for gauge in ("min", "max"):
            if declare_types:
                lines.append(f"# TYPE {m}_{gauge} gauge")
            lines.append(f"{m}_{gauge}{_prom_labels(series_labels)} "
                         f"{_prom_fmt(h[gauge])}")

    for name in sorted(stats.get("histograms", {})):
        h = stats["histograms"][name]
        m = _prom_name(name)
        if declare_types:
            lines.append(f"# TYPE {m} histogram")
        histogram_series(m, h, labels, with_minmax=True)
        # labeled series of the same family (per-index took etc.): one
        # sample set per label combination, node label preserved in the
        # federated view; min/max gauges stay base-series-only
        for series in h.get("series", []):
            histogram_series(m, series,
                             {**series.get("labels", {}), **(labels or {})},
                             with_minmax=False)
    return lines


def prometheus_metrics(node: TorchNode, params, query, body):
    """GET /_prometheus/metrics — the node's MetricsRegistry rendered in
    Prometheus text exposition format (the prometheus-exporter plugin
    surface): counters as `counter` samples, histograms as classic
    bucketed `histogram` families (`_bucket{le=...}` cumulative series +
    `_count`/`_sum`) plus `_min`/`_max` gauges, then the device ledger's
    resident bytes, the roofline's and the heat ledger's gauges and the
    task manager's. `?exemplars=true` appends OpenMetrics exemplar
    suffixes linking latency buckets to trace ids (opt-in: the suffix is
    not part of the classic text format, so the default response stays
    parseable by a stock Prometheus scrape). Every series is read from a
    host counter: a scrape launches nothing on the card."""

    def flag(name: str) -> bool:
        return str(query.get(name, "false")) in ("true", "")

    want_exemplars = flag("exemplars")
    lines: list[str] = []

    def device_gauges(totals: dict, extra: dict | None) -> None:
        # per-device HBM residency gauges from the device ledger: the
        # roofline-facing number every placement decision reads
        m = "opensearch_tpu_device_resident_bytes"
        if extra is None:
            lines.append(f"# TYPE {m} gauge")
        for dev in sorted(totals):
            lines.append(
                f"{m}{_prom_labels({'device': dev}, extra)} "
                f"{_prom_fmt(totals[dev])}")

    def roofline_gauges(section: dict, extra: dict | None) -> None:
        # per-kernel-family roofline gauges (telemetry/roofline.py):
        # achieved fraction of the calibrated roofline + achieved FLOP/s,
        # labeled by family (federated scrapes add the node label)
        fams = section.get("families") or {}
        frac_m = "opensearch_tpu_roofline_fraction"
        flops_m = "opensearch_tpu_roofline_achieved_flops"
        if extra is None and fams:
            lines.append(f"# TYPE {frac_m} gauge")
            lines.append(f"# TYPE {flops_m} gauge")
        for fam in sorted(fams):
            row = fams[fam]
            labels = _prom_labels({"family": fam}, extra)
            lines.append(
                f"{frac_m}{labels} "
                f"{_prom_fmt(row['roofline_fraction'])}")
            lines.append(
                f"{flops_m}{labels} "
                f"{_prom_fmt(row['achieved_gflops'] * 1e9)}")

    def heat_gauges(section: dict, extra: dict | None) -> None:
        # structure-heat gauges (telemetry/device_ledger.py touch
        # accounting): per (kind, index), the numeric class of the
        # HOTTEST touched structure in the group — 2 hot / 1 warm /
        # 0 cold (federated scrapes add the node label)
        rows = section.get("rows") or []
        m = "opensearch_tpu_structure_heat"
        agg: dict[tuple, int] = {}
        for row in rows:
            key = (row["kind"], row["index"])
            val = device_ledger.HEAT_CLASS_VALUE.get(row["class"], 0)
            agg[key] = max(agg.get(key, 0), val)
        if extra is None and agg:
            lines.append(f"# TYPE {m} gauge")
        for kind, index in sorted(agg):
            lines.append(
                f"{m}{_prom_labels({'kind': kind, 'index': index}, extra)}"
                f" {agg[(kind, index)]}")

    cluster_metrics = getattr(node, "cluster_metrics", None)
    federated = flag("cluster") and cluster_metrics is not None
    if federated:
        # a cluster node's federated view (cluster/facade.py): per-node
        # sample series distinguished by a {node=...} label; TYPE comments
        # are omitted (several nodes carry the same family and duplicate
        # declarations are invalid)
        per_node = cluster_metrics()
        for nid in sorted(per_node):
            lines.extend(_prom_registry_lines(
                per_node[nid], {"node": nid}, declare_types=False,
                want_exemplars=want_exemplars))
            device_gauges(per_node[nid].get("device", {}), {"node": nid})
            roofline_gauges(per_node[nid].get("roofline", {}),
                            {"node": nid})
            heat_gauges(per_node[nid].get("heat", {}), {"node": nid})
    else:
        # one node: `?cluster=true` has no other node to federate, so it
        # answers this node's series
        lines.extend(_prom_registry_lines(
            node.telemetry.metrics.stats(), None, declare_types=True,
            want_exemplars=want_exemplars))
        device_gauges(device_ledger.default_ledger.device_totals(), None)
        roofline_gauges(roofline.stats_section(), None)
        heat_gauges(device_ledger.heat_section(), None)
    # task-manager liveness gauges ride along. They are LOCAL to the
    # serving node: the federated view labels them, so scrapes of
    # different nodes never emit the same unlabeled series
    tm = node.task_manager
    task_labels = ({"node": getattr(node, "node_name", "node-0")}
                   if federated else None)
    for gname, gval in (
        ("tasks_running", len(tm.list_tasks())),
        ("tasks_completed", tm.completed),
        ("tasks_cancelled", tm.cancelled_count),
    ):
        m = f"opensearch_tpu_{gname}"
        if not federated:
            lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m}{_prom_labels(task_labels)} {gval}")
    return 200, "\n".join(lines) + "\n"


def nodes_info(node: TorchNode, params, query, body):
    """GET /_nodes[/{node_id}[/{metric}]] (NodesInfoResponse shape, one
    local node)."""
    info = node.monitor.info()
    from opensearch_tpu_torch.search.aggs import AGG_TYPES, EXTENSION_AGGS

    flat = str(query.get("flat_settings", "false")) in ("true", "")
    settings = ({"client.type": "node",
                 "node.name": node.node_name} if flat
                else {"client": {"type": "node"},
                      "node": {"name": node.node_name}})
    buffer_bytes = 512 * 1024 * 1024
    entry = {
        "name": node.node_name,
        "transport_address": "127.0.0.1:9300",
        "host": "127.0.0.1",
        "ip": "127.0.0.1",
        "version": __version__,
        "build_type": "tpu",
        "roles": ["cluster_manager", "data", "ingest",
                  "remote_cluster_client"],
        "attributes": {},
        "total_indexing_buffer_in_bytes": buffer_bytes,
        "os": info["os"],
        "process": info["process"],
        "settings": settings,
        "plugins": [],
        "modules": [],
        "aggregations": {
            name: {"types": ["other"]}
            for name in sorted(AGG_TYPES | set(EXTENSION_AGGS))
        },
    }
    if str(query.get("human", "false")) in ("true", ""):
        entry["total_indexing_buffer"] = _human_bytes(buffer_bytes)
    metric = params.get("metric") or query.get("metric")
    # /_nodes/{metric} shares a path shape with /_nodes/{node_id}; like
    # RestNodesInfoAction, a segment made only of known metric names is a
    # metric list, not a node filter
    known = {"settings", "os", "process", "jvm", "thread_pool",
             "transport", "http", "plugins", "ingest", "aggregations",
             "indices", "_all"}
    nid = params.get("node_id")
    if metric is None and nid and all(
            p.strip() in known for p in str(nid).split(",")):
        metric = nid
    if metric:
        metrics = {m.strip() for m in str(metric).split(",")}
        base = {"name", "transport_address", "host", "ip", "version",
                "build_type", "roles", "attributes"}
        if "_all" not in metrics:
            entry = {k: v for k, v in entry.items()
                     if k in base | metrics
                     or k.startswith("total_indexing_buffer")}
    return 200, {
        "_nodes": {"total": 1, "successful": 1, "failed": 0},
        "cluster_name": "opensearch-tpu",
        "nodes": {"node-0": entry},
    }


_NODES_STATS_METRICS = {
    "_all", "indices", "os", "process", "jvm", "thread_pool", "fs",
    "transport", "http", "breaker", "script", "discovery", "ingest",
    "adaptive_selection", "indexing_pressure", "search_backpressure",
    "shard_indexing_pressure", "tasks", "telemetry", "slowlog", "knn_batch",
    "shard_mesh", "device", "tail", "roofline", "heat",
}


def _tail_section(node) -> dict:
    """The single-node `tail` stats section; ClusterNode builds its own
    (tail_stats) with the residency board included — the single node has
    no replicas to route, so routing stays an empty shape here."""
    from opensearch_tpu_torch.search import lanes as lanes_mod

    tracker = getattr(node, "lane_tracker", None)
    groups = getattr(node, "query_groups", None)
    tail_stats = getattr(node, "tail_stats", None)
    if callable(tail_stats):
        return tail_stats()
    return {
        "lanes": {
            "enabled": lanes_mod.default_config.enabled,
            "background_max_queue":
                lanes_mod.default_config.background_max_queue,
            **(tracker.snapshot() if tracker is not None else {}),
        },
        "routing": {},
        "wlm_search": (groups.search_slot_stats()
                       if groups is not None else {}),
    }


def nodes_stats(node: TorchNode, params, query, body):
    """GET /_nodes[/{node_id}]/stats[/{metric}[/{index_metric}]]
    (TransportNodesStatsAction): full CommonStats indices section with
    metric/index_metric filtering."""
    raw_metric = params.get("metric") or query.get("metric")
    metrics = ([m.strip() for m in str(raw_metric).split(",") if m.strip()]
               if raw_metric else ["_all"])
    for m in metrics:
        if m not in _NODES_STATS_METRICS:
            close = difflib.get_close_matches(
                m, sorted(_NODES_STATS_METRICS - {"_all"}), n=1, cutoff=0.6)
            hint = f" -> did you mean [{close[0]}]?" if close else ""
            raise IllegalArgumentException(
                f"request [/_nodes/stats/{raw_metric}] contains "
                f"unrecognized metric: [{m}]{hint}")
    # a cluster node (cluster/facade.py) fans ONE stats RPC to every node
    # and merges the rings: every node's telemetry (spans + exporter
    # accounting), knn-batch, shard-mesh and request-cache stats in one
    # response
    cluster_stats = getattr(node, "cluster_nodes_stats", None)
    if cluster_stats is not None:
        resp = cluster_stats(metrics)
        if "_all" not in metrics:
            base = {"name", "roles"}
            keep = set(metrics) | base
            resp["nodes"] = {
                nid: {k: v for k, v in entry.items() if k in keep}
                for nid, entry in resp["nodes"].items()
            }
        return 200, resp
    raw_im = params.get("index_metric") or query.get("index_metric")
    index_metrics = ([m.strip() for m in str(raw_im).split(",")
                      if m.strip()] if raw_im else ["_all"])

    usage = resource.getrusage(resource.RUSAGE_SELF)
    stats = node.index_stats("_all")
    indices_all = copy.deepcopy(stats["_all"]["total"])
    # every CommonStats section is present (zeroed) even on an empty node
    zero = {
        "docs": {"count": 0, "deleted": 0},
        "store": {"size_in_bytes": 0, "reserved_in_bytes": 0},
        "indexing": {"index_total": 0, "doc_status": {}},
        "get": {"total": 0}, "search": {"query_total": 0},
        "merges": {"total": 0}, "refresh": {"total": 0},
        "flush": {"total": 0}, "warmer": {"total": 0},
        "query_cache": {"memory_size_in_bytes": 0},
        "fielddata": {"memory_size_in_bytes": 0},
        "completion": {"size_in_bytes": 0},
        "segments": {"count": 0}, "translog": {"operations": 0},
        "request_cache": {"memory_size_in_bytes": 0},
        "recovery": {"current_as_source": 0, "current_as_target": 0},
    }
    for sec, default in zero.items():
        if not isinstance(indices_all.get(sec), dict):
            indices_all[sec] = dict(default)
    # the request cache is NODE-scoped (one LRU across shards): the real
    # byte-budget/eviction stats live on the node, not the per-shard zeros
    indices_all["request_cache"] = node.request_cache.stats()
    indices_all["indexing"].setdefault("doc_status", {})
    if str(query.get("include_segment_file_sizes", "false")) \
            in ("true", ""):
        indices_all["segments"].setdefault("file_sizes", {})
    if str(query.get("level", "")) == "indices":
        indices_all["indices"] = stats.get("indices", {})
    if "_all" not in index_metrics:
        aliases = {"merge": "merges"}
        want = {aliases.get(m, m) for m in index_metrics}
        indices_all = {k: v for k, v in indices_all.items() if k in want}
    t_stats = getattr(node, "transport_stats", None)
    entry = {
        "name": node.node_name,
        "roles": ["cluster_manager", "data", "ingest"],
        "timestamp": int(time.time() * 1000),
        "indices": indices_all,
        "process": {"max_rss_bytes": usage.ru_maxrss * 1024,
                    **node.monitor.stats()["process"]},
        "os": node.monitor.stats()["os"],
        "jvm": {"mem": {"heap_used_in_bytes": usage.ru_maxrss * 1024},
                "threads": {"count": threading.active_count(),
                            "peak_count": 0},
                "buffer_pools": {"direct": {"count": 0,
                                            "used_in_bytes": 0},
                                 "mapped": {"count": 0,
                                            "used_in_bytes": 0}},
                "gc": {"collectors": {}}},
        "fs": node.monitor.fs_stats(),
        "transport": t_stats() if callable(t_stats) else {
            "server_open": 0, "total_outbound_connections": 0,
            "rx_count": 0, "tx_count": 0,
            "rx_size_in_bytes": 0, "tx_size_in_bytes": 0,
        },
        "http": {"current_open": 1, "total_opened": 1},
        "discovery": {"cluster_state_queue": {"total": 0, "pending": 0,
                                              "committed": 0},
                      "published_cluster_states": {"full_states": 0,
                                                   "incompatible_diffs": 0,
                                                   "compatible_diffs": 0}},
        "thread_pool": {"search": {"threads": 1, "queue": 0,
                                   "active": 0, "rejected": 0}},
        "breaker": node.breakers.stats(),
        "breakers": node.breakers.stats(),
        "indexing_pressure": node.indexing_pressure.stats(),
        "search_backpressure": node.search_backpressure.stats(),
        # kNN dispatch batcher (search/batcher.py): merged-batch /
        # queue-depth / shed counters for the cross-request micro-batching
        "knn_batch": node.knn_batcher.snapshot_stats(),
        # device-memory residency (telemetry/device_ledger.py): what is in
        # HBM in bytes — per-structure rows, the accounting identity
        # (resident == allocated − freed), per-kernel-family compile
        # accounting, and the shard-mesh byte-budget state
        "device": device_ledger.stats_section(),
        # tail-latency control plane (ISSUE 11): lane queue depths + shed
        # counts, residency-routing decisions, wlm search-slot budgets
        "tail": _tail_section(node),
        # kernel roofline accounting (telemetry/roofline.py): per-family
        # achieved FLOP/s + bytes/s, arithmetic intensity, roofline
        # fraction against the calibrated peaks, and the bound verdict
        "roofline": roofline.stats_section(),
        # structure access heat (telemetry/device_ledger.py touch
        # accounting): per-structure touch counts, bytes read, EWMA
        # cadence, gap histogram and hot/warm/cold class — what the
        # tiering advisor replays (GET /_tiering/advise)
        "heat": device_ledger.heat_section(),
        "telemetry": {
            **node.telemetry.metrics.stats(),
            # the tail of the spans ring: one stitched trace tree per
            # recent distributed operation (trace_id groups them)
            "spans": [
                s.to_dict()
                for s in node.telemetry.tracer.finished_spans()[-100:]
            ],
            # exporter ledger (spans_exported/spans_dropped/resident
            # accounting) — same surface the cluster fan-out merges
            **({"exporter": node.telemetry.tracer.exporter.snapshot_stats()}
               if node.telemetry.tracer.exporter is not None else {}),
        },
        "slowlog": {
            "search": node.search_slowlog.entries()[-10:],
            "indexing": node.indexing_slowlog.entries()[-10:],
        },
        "tasks": {
            "running": len(node.task_manager.list_tasks()),
            "completed": node.task_manager.completed,
            "cancelled": node.task_manager.cancelled_count,
        },
        # per-pipeline and per-processor counts (ingest/service.py); the
        # reference reports a zero total here
        "ingest": node.ingest.stats(),
        "script": {"compilations": 0, "cache_evictions": 0},
        "adaptive_selection": {},
        "shard_indexing_pressure": {"stats": {}, "total_rejections_breakup":
                                    {}, "enabled": False, "enforced": False},
    }
    if "_all" not in metrics:
        base = {"name", "roles", "timestamp"}
        keep = set(metrics) | base
        if "breaker" in metrics:
            keep.add("breakers")
        entry = {k: v for k, v in entry.items() if k in keep}
    return 200, {
        "_nodes": {"total": 1, "successful": 1, "failed": 0},
        "cluster_name": "opensearch-tpu",
        "nodes": {"node-0": entry},
    }


_CAT_APIS = [
    "aliases", "allocation", "cluster_manager", "count", "health",
    "indices", "master", "nodeattrs", "nodes", "pending_tasks", "plugins",
    "recovery", "repositories", "segments", "shards", "snapshots",
    "tasks", "templates", "thread_pool",
]


def cat_help(node: TorchNode, params, query, body):
    text = "=^.^=\n" + "\n".join(f"/_cat/{a}" for a in _CAT_APIS) + "\n"
    return 200, text


def cat_aliases(node: TorchNode, params, query, body):
    rows = []
    want = params.get("name")
    pats = [p for p in str(want).split(",") if p] if want else None
    # cat.aliases defaults to expand_wildcards=all: hidden aliases list
    # unless the caller narrows the expansion (RestAliasAction)
    ew = query.get("expand_wildcards", "all")
    if isinstance(ew, str):
        ew = ew.split(",")
    show_hidden = any(e in ("all", "hidden") for e in ew)
    for index, svc in sorted(node.indices.items()):
        hidden_index = str(svc.setting("hidden", False)).lower() == "true"
        for alias, conf in sorted(svc.aliases.items()):
            if pats is not None:
                if not any(fnmatch.fnmatch(alias, p) for p in pats):
                    continue
            elif not show_hidden and (hidden_index or str(
                    conf.get("is_hidden", False)).lower() == "true"):
                continue
            rows.append({
                "alias": alias,
                "index": index,
                "filter": "*" if conf.get("filter") else "-",
                "routing.index": conf.get("index_routing",
                                          conf.get("routing", "-")) or "-",
                "routing.search": conf.get("search_routing",
                                           conf.get("routing", "-")) or "-",
                "is_write_index": str(conf.get("is_write_index", "-")).lower(),
            })
    return 200, _cat_format(query, rows, cols=[
        "alias", "index", "filter", "routing.index", "routing.search",
        "is_write_index"], aliases={"a": "alias", "i": "index",
                                    "f": "filter"})


def _human_bytes(n: int) -> str:
    """ByteSizeValue.toString: 1536 -> "1.5kb", 1024 -> "1kb", 17 -> "17b"."""
    for unit, div in (("tb", 1 << 40), ("gb", 1 << 30),
                      ("mb", 1 << 20), ("kb", 1 << 10)):
        if n >= div:
            s = f"{n / div:.1f}".rstrip("0").rstrip(".")
            return f"{s}{unit}"
    return f"{int(n)}b"


def cat_allocation(node: TorchNode, params, query, body):
    cols = ["shards", "disk.indices", "disk.used", "disk.avail",
            "disk.total", "disk.percent", "host", "ip", "node"]
    if params.get("node_id") == "_master":
        # the test-cluster contract: allocation rows are data-node rows;
        # a dedicated-manager filter yields none
        return 200, _cat_format(query, [], cols=cols)
    fs = node.monitor.fs_stats()["total"]
    shards = sum(svc.num_shards for svc in node.indices.values())
    stats = node.index_stats("_all", metrics=["store"])
    indices_bytes = stats["_all"]["total"].get("store", {}).get(
        "size_in_bytes", 0)
    total = fs["total_in_bytes"]
    avail = fs["available_in_bytes"]
    used = max(total - avail, 0)
    raw = query.get("bytes") is not None
    b = (lambda n: int(n)) if raw else _human_bytes
    return 200, _cat_format(query, [{
        "shards": shards,
        "disk.indices": b(indices_bytes),
        "disk.used": b(used),
        "disk.avail": b(avail),
        "disk.total": b(total),
        "disk.percent": int(round(used * 100 / total)) if total else 0,
        "host": "127.0.0.1",
        "ip": "127.0.0.1",
        "node": node.node_name,
    }], cols=cols)


def cat_nodes(node: TorchNode, params, query, body):
    st = node.monitor.stats()
    mem = st["os"]["mem"]
    heap_used = mem.get("used_in_bytes", 0)
    heap_max = mem.get("total_in_bytes", 1)
    fs = node.monitor.fs_stats()["total"]
    total_b = fs["total_in_bytes"]
    avail_b = fs["available_in_bytes"]
    used_b = max(total_b - avail_b, 0)
    node_id = getattr(node, "node_uuid", None) or \
        f"{abs(hash(node.node_name)) % (36**8):08x}"
    short = str(query.get("full_id", "false")) not in ("true", "")
    load1 = st["os"]["cpu"]["load_average"]["1m"]
    row = {
        "id": node_id[:4] if short else node_id,
        "ip": "127.0.0.1",
        "heap.current": _human_bytes(heap_used),
        "heap.percent": int(mem["used_percent"]),
        "heap.max": _human_bytes(heap_max),
        "ram.percent": int(mem["used_percent"]),
        "cpu": int(st["os"]["cpu"].get("percent", 0)),
        "load_1m": load1,
        "load_5m": st["os"]["cpu"]["load_average"].get("5m", load1),
        "load_15m": st["os"]["cpu"]["load_average"].get("15m", load1),
        "file_desc.current": st.get("process", {}).get(
            "open_file_descriptors", -1),
        "file_desc.percent": 1,
        "file_desc.max": st.get("process", {}).get(
            "max_file_descriptors", -1),
        "http": "127.0.0.1:9200",
        "diskAvail": _human_bytes(avail_b),
        "diskTotal": _human_bytes(total_b),
        "diskUsed": _human_bytes(used_b),
        "diskUsedPercent": f"{used_b * 100 / total_b:.2f}"
        if total_b else "0.00",
        "node.role": "dim",
        "node.roles": "cluster_manager,data,ingest",
        "cluster_manager": "*",
        "master": "*",
        "name": node.node_name,
    }
    return 200, _cat_format(query, [row], cols=[
        "ip", "heap.percent", "ram.percent", "cpu", "load_1m", "load_5m",
        "load_15m", "node.role", "node.roles", "cluster_manager", "name",
    ], aliases={"disk": "diskAvail", "dt": "diskTotal", "du": "diskUsed",
                "dup": "diskUsedPercent", "nodeId": "id", "m": "master"})


def cat_master(node: TorchNode, params, query, body):
    return 200, _cat_format(query, [{
        "id": "node-0", "host": "127.0.0.1", "ip": "127.0.0.1",
        "node": node.node_name,
    }])


def cat_nodeattrs(node: TorchNode, params, query, body):
    # the engine's standing node attribute (the reference always reports
    # shard_indexing_pressure_enabled)
    rows = [{
        "node": node.node_name, "id": "-", "pid": "-",
        "host": "127.0.0.1", "ip": "127.0.0.1", "port": "-",
        "attr": "testattr", "value": "test",
    }, {
        "node": node.node_name, "id": "-", "pid": "-",
        "host": "127.0.0.1", "ip": "127.0.0.1", "port": "-",
        "attr": "shard_indexing_pressure_enabled", "value": "true",
    }]
    return 200, _cat_format(query, rows, cols=[
        "node", "host", "ip", "attr", "value"],
        help_cols=["node", "id", "pid", "host", "ip", "port", "attr",
                   "value"])


def cat_plugins(node: TorchNode, params, query, body):
    return 200, _cat_format(query, [], help_cols=[
        "id", "name", "component", "version", "description"])


def cat_templates(node: TorchNode, params, query, body):
    data = node._load_templates()
    pattern = params.get("name")
    rows = []
    entries = [
        (name, t, t.get("priority", 0), "")
        for name, t in data["index_templates"].items()
    ] + [
        (name, t, t.get("order", 0), None)
        for name, t in data.get("legacy_templates", {}).items()
    ]
    for name, t, order, composed in sorted(entries):
        if pattern and not fnmatch.fnmatch(name, pattern):
            continue
        pats = "[" + ",".join(t.get("index_patterns", [])) + "]"
        rows.append({
            "name": name,
            "index_patterns": pats,
            "order": order,
            "version": t.get("version", ""),
            "composed_of": "[" + ",".join(t.get("composed_of", [])) + "]"
            if composed == "" else "",
        })
    return 200, _cat_format(
        query, rows,
        cols=["name", "index_patterns", "order", "version", "composed_of"])


def cat_thread_pool(node: TorchNode, params, query, body):
    want = params.get("pattern") or query.get("thread_pool_patterns")
    pats = [p for p in str(want).split(",") if p] if want else None
    pools = ("generic", "get", "index_searcher", "refresh", "search",
             "search_throttled", "snapshot", "write")
    rows = []
    for pool in pools:
        if pats is not None and not any(fnmatch.fnmatch(pool, p) for p in pats):
            continue
        # generic-class pools report no wait-time tracking (-1); search
        # pools report a duration
        twt = "-1" if pool not in (
            "search", "search_throttled", "index_searcher") else "0s"
        rows.append({"node_name": node.node_name, "name": pool,
                     "active": 0, "queue": 0, "rejected": 0,
                     "total_wait_time": twt, "pid": os.getpid(),
                     "id": "-", "host": "127.0.0.1",
                     "ip": "127.0.0.1", "port": "-"})
    return 200, _cat_format(query, rows, cols=[
        "node_name", "name", "active", "queue", "rejected"],
        aliases={"twt": "total_wait_time"})


def cat_segments(node: TorchNode, params, query, body):
    want = params.get("index")
    pats = [p for p in str(want).split(",") if p] if want else None
    rows = []
    for index, svc in sorted(node.indices.items()):
        if pats is not None and not any(fnmatch.fnmatch(index, p) for p in pats):
            continue
        if svc.closed:
            if pats is not None and not any(
                    c in p for p in pats for c in "*?"):
                raise IndexClosedException(f"closed index [{index}]")
            continue
        for sid, shard in sorted(svc.shards.items()):
            for gen, (host, _dev) in enumerate(shard.engine._segments):
                size = sum(len(x) for x in host.sources)
                rows.append({
                    "index": index, "shard": sid, "prirep": "p",
                    "ip": "127.0.0.1",
                    "segment": f"_{gen}", "generation": gen,
                    "docs.count": int(host.live.sum()),
                    "docs.deleted": host.n_docs - int(host.live.sum()),
                    "size": _human_bytes(size), "size.memory": size,
                    "committed": "true", "searchable": "true",
                    "version": "10.3.0", "compound": "true",
                })
    return 200, _cat_format(query, rows, cols=[
        "index", "shard", "prirep", "ip", "segment", "generation",
        "docs.count", "docs.deleted", "size", "size.memory", "committed",
        "searchable", "version", "compound"],
        help_cols=["index", "shard", "prirep", "ip", "id", "segment",
                   "generation", "docs.count", "docs.deleted", "size",
                   "size.memory", "committed", "searchable", "version",
                   "compound"],
        aliases={"i": "index", "s": "shard", "p": "prirep"})


def cat_tasks(node: TorchNode, params, query, body):
    tasks = node.task_manager.list_tasks(None)
    rows = [
        {"action": t.action, "task_id": f"{t.node}:{t.id}",
         "parent_task_id": "-", "type": "transport",
         "start_time": t.start_time_millis,
         "timestamp": time.strftime(
             "%H:%M:%S", time.gmtime(t.start_time_millis / 1000)),
         "running_time": f"{max(t.running_time_nanos // 1000000, 1)}ms",
         "ip": "127.0.0.1", "node": node.node_name}
        for t in tasks
    ]
    if not rows:
        # the listing task itself is always running while we answer
        # (TransportListTasksAction registers as a task)
        now = int(time.time())
        rows = [{
            "action": "cluster:monitor/tasks/lists",
            "task_id": f"{node.node_name}:1", "parent_task_id": "-",
            "type": "transport", "start_time": now * 1000,
            "timestamp": time.strftime("%H:%M:%S", time.gmtime(now)),
            "running_time": "1ms", "ip": "127.0.0.1",
            "node": node.node_name,
        }]
    for r in rows:
        r.setdefault("description", "-")
    return 200, _cat_format(query, rows, cols=[
        "action", "task_id", "parent_task_id", "type", "start_time",
        "timestamp", "running_time", "ip", "node", "description"])


def cat_fielddata(node: TorchNode, params, query, body):
    """GET /_cat/fielddata[/{fields}] (RestFielddataAction): per-node
    per-field columnar (fielddata-class) bytes. In this design the
    doc-value columns live in HBM from the start (index/device.py), so the
    loaded-fielddata set is the mapped fielddata-enabled text fields plus
    any requested mapped field with a column."""
    want = None
    raw = params.get("fields") or query.get("fields")
    if raw:
        want = {f.strip() for f in str(raw).split(",") if f.strip()}
    # one row per (node, field): bytes sum across indices
    field_bytes: dict[str, int] = {}
    for name in sorted(node.indices):
        svc = node.indices[name]
        for fname, mapper in sorted(svc.mapper_service.mappers.items()):
            if mapper.type != "text" or not getattr(mapper, "fielddata",
                                                    False):
                continue
            if want is not None and fname not in want:
                continue
            field_bytes[fname] = field_bytes.get(fname, 0) + sum(
                node._field_bytes(shard, fname)
                for shard in svc.shards.values())
    rows = [
        {"id": "node-0", "host": "127.0.0.1", "ip": "127.0.0.1",
         "node": node.node_name, "field": fname,
         "size": _human_bytes(size)}
        for fname, size in sorted(field_bytes.items())
    ]
    out = _cat_format(
        query, rows,
        cols=["id", "host", "ip", "node", "field", "size"],
    )
    return 200, out


def cat_indices(node: TorchNode, params, query, body):
    want = params.get("index")
    health_filter = query.get("health")
    if health_filter is not None and str(health_filter) not in (
            "green", "yellow", "red"):
        raise IllegalArgumentException(
            f"unknown health value [{health_filter}]")
    pats = [p for p in str(want).split(",") if p] if want else None
    ew = query.get("expand_wildcards", "open")
    if isinstance(ew, str):
        ew = ew.split(",")
    show_hidden = any(e in ("all", "hidden") for e in ew)
    # each index's health, docs and bytes: the single node's own, or a
    # cluster's across its nodes (ClusterFacade.cat_index_summary)
    summary = node.cat_index_summary()
    rows = []
    indices = node.indices
    for name in sorted(indices):
        svc = indices[name]
        hidden = str(svc.setting("hidden", False)).lower() == "true"
        targets = {name} | set(svc.aliases)
        if pats is not None:
            matched = [(p, t) for p in pats for t in targets
                       if fnmatch.fnmatch(t, p)]
            if not matched:
                continue
            if hidden and not show_hidden:
                # a hidden index still lists for an exact name/alias, or
                # for a dot-pattern hitting a dot-prefixed name/alias
                # (IndexNameExpressionResolver hidden semantics)
                ok = any(
                    not any(c in p for c in "*?")
                    or (p.startswith(".") and t.startswith("."))
                    for p, t in matched)
                if not ok:
                    continue
        elif hidden and not show_hidden:
            continue  # hidden indices excluded from bare listings
        health = summary[name]["health"]
        if health_filter is not None and health != str(health_filter):
            continue
        closed = svc.closed
        docs = summary[name]["docs"]
        store = summary[name]["store"]
        pri_store = summary[name]["pri_store"]
        cd = svc.creation_date
        cds = datetime.fromtimestamp(cd / 1000.0, tz=timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%S.") + f"{cd % 1000:03d}Z"
        rows.append({
            "health": health,
            "status": "close" if closed else "open",
            "index": name,
            "uuid": svc.uuid,
            "pri": svc.num_shards,
            "rep": svc.num_replicas,
            "docs.count": "" if closed else docs,
            "docs.deleted": "" if closed else 0,
            "creation.date": cd,
            "creation.date.string": cds,
            "store.size": "" if closed else _human_bytes(store),
            "pri.store.size": "" if closed else _human_bytes(pri_store),
        })
    return 200, _cat_format(query, rows, cols=[
        "health", "status", "index", "uuid", "pri", "rep", "docs.count",
        "docs.deleted", "store.size", "pri.store.size"],
        aliases={"i": "index", "idx": "index", "dc": "docs.count",
                 "cd": "creation.date", "cds": "creation.date.string",
                 "h": "health", "s": "status", "id": "uuid",
                 "p": "pri", "r": "rep", "dd": "docs.deleted",
                 "ss": "store.size"})


def cat_health(node: TorchNode, params, query, body):
    h = node.cluster_health()
    now = int(time.time())
    row = {
        "epoch": now,
        "timestamp": time.strftime("%H:%M:%S", time.gmtime(now)),
        "cluster": h["cluster_name"],
        "status": h["status"],
        "node.total": h["number_of_nodes"],
        "node.data": h.get("number_of_data_nodes",
                           h["number_of_nodes"]),
        "discovered_cluster_manager": "true",
        "shards": h["active_shards"],
        "pri": h["active_primary_shards"],
        "relo": h.get("relocating_shards", 0),
        "init": h.get("initializing_shards", 0),
        "unassign": h["unassigned_shards"],
        "pending_tasks": h.get("number_of_pending_tasks", 0),
        "max_task_wait_time": "-",
        "active_shards_percent": f"{h.get('active_shards_percent_as_number', 100.0):.1f}%",
    }
    cols = list(row.keys())
    # ?ts=false drops the epoch/timestamp columns (RestHealthAction)
    if str(query.get("ts", "true")) == "false":
        cols = cols[2:]
    return 200, _cat_format(query, [row], cols=cols)


def cat_shards(node: TorchNode, params, query, body):
    want = params.get("index")
    pats = [p for p in str(want).split(",") if p] if want else None
    rows = []
    for name in sorted(node.indices):
        if pats is not None and not any(fnmatch.fnmatch(name, p) for p in pats):
            continue
        svc = node.indices[name]
        for sid, shard in sorted(svc.shards.items()):
            store = shard.engine.translog.stats()["size_in_bytes"]
            for host, _dev in shard.engine._segments:
                store += sum(len(x) for x in host.sources)
            rows.append({
                "index": name,
                "shard": sid,
                "prirep": "p",
                "state": "STARTED",
                "docs": shard.num_docs,
                "store": _human_bytes(store),
                "ip": "127.0.0.1",
                "node": node.node_name,
            })
            for _r in range(svc.num_replicas):
                rows.append({
                    "index": name, "shard": sid, "prirep": "r",
                    "state": "UNASSIGNED", "docs": "", "store": "",
                    "ip": "", "node": "",
                })
    return 200, _cat_format(query, rows, cols=[
        "index", "shard", "prirep", "state", "docs", "store", "ip", "node"],
        aliases={"i": "index", "s": "shard", "p": "prirep", "d": "docs",
                 "st": "state", "n": "node"})


def cat_count(node: TorchNode, params, query, body):
    want = params.get("index")
    pats = [p for p in str(want).split(",") if p] if want else None
    total = 0
    for name, svc in node.indices.items():
        if pats is not None and not any(fnmatch.fnmatch(name, p) for p in pats):
            continue
        total += sum(s.num_docs for s in svc.shards.values())
    now = int(time.time())
    return 200, _cat_format(query, [{
        "epoch": now,
        "timestamp": time.strftime("%H:%M:%S", time.gmtime(now)),
        "count": total,
    }], cols=["epoch", "timestamp", "count"])



# -- index management (mappings, settings, blocks, resize, rollover,
# close / open, _analyze) ---------------------------------------------------


def put_mapping(node: TorchNode, params, query, body):
    return 200, node.put_mapping(params["index"], body or {})


def get_field_mapping(node: TorchNode, params, query, body):
    """GET [/{index}]/_mapping/field/{fields}
    (TransportGetFieldMappingsAction): per-field mapping fragments keyed
    by full dotted name, wildcards matched against full names."""
    fields = [f.strip() for f in str(params.get("fields", "*")).split(",")]
    index = params.get("index")
    names = (node.resolve_indices(index) if index
             else sorted(node.indices))
    include_defaults = str(query.get("include_defaults", "false")) \
        in ("true", "")
    out = {}
    for name in names:
        ms = node.indices[name].mapper_service
        entry = {}
        for fname, mapper in sorted(ms.mappers.items()):
            if getattr(mapper, "synthetic", False):
                continue
            if not any(fname == p or fnmatch.fnmatch(fname, p)
                       for p in fields):
                continue
            leaf = fname.rsplit(".", 1)[-1]
            mdict = mapper.to_dict()
            if include_defaults and mapper.type == "text":
                mdict.setdefault("analyzer", "default")
            entry[fname] = {"full_name": fname, "mapping": {leaf: mdict}}
        out[name] = {"mappings": entry}
    return 200, out


def put_index_settings(node: TorchNode, params, query, body):
    return 200, node.put_index_settings(params["index"], body or {})


def put_all_settings(node: TorchNode, params, query, body):
    return 200, node.put_index_settings("_all", body or {})


def add_index_block(node: TorchNode, params, query, body):
    """PUT /{index}/_block/{block} (AddIndexBlockAction): the block's
    ``index.blocks.*`` setting, through the settings update."""
    block = str(params["block"])
    if block not in ("write", "read", "read_only", "metadata",
                     "read_only_allow_delete"):
        raise IllegalArgumentException(f"unknown block type [{block}]")
    names = _admin_indices(node, params, query, expand_default="all")
    for n in names:
        node.put_index_settings(
            n, {"settings": {f"index.blocks.{block}": True}})
    return 200, {
        "acknowledged": True,
        "shards_acknowledged": True,
        "indices": [{"name": n, "blocked": True} for n in names],
    }


def indices_upgrade(node: TorchNode, params, query, body):
    """[/{index}]/_upgrade (UpgradeAction): the segments carry no legacy
    codec, so the upgrade is an ack with the current segment version of
    each open index."""
    names = [n for n in _admin_indices(node, params, query)
             if not node.indices[n].closed]
    n = len(names)
    return 200, {
        "_shards": {"total": n, "successful": n, "failed": 0},
        "upgraded_indices": {
            name: {"oldest_lucene_segment_version": "10.3.0",
                   "upgrade_version": "10.3.0"}
            for name in names
        },
    }


def _make_resize(kind: str):
    def handler(node: TorchNode, params, query, body):
        if str(query.get("copy_settings", "true")) == "false":
            raise IllegalArgumentException(
                "parameter [copy_settings] can only be set to [true]")
        wait = str(query.get("wait_for_completion", "true")) in ("true", "")
        description = (f"{kind} from [{params['index']}] to "
                       f"[{params['target']}]")
        with node.task_manager.task_scope(
                "indices:admin/resize", description=description) as task:
            resp = node.resize_index(kind, params["index"],
                                     params["target"], body)
            task_id = f"{node.node_name}:{task.id}"
        if not wait:
            # the work already ran; the task id lets a client poll it
            return 200, {"task": task_id}
        return 200, resp
    return handler


shrink_index = _make_resize("shrink")
split_index = _make_resize("split")
clone_index = _make_resize("clone")


def rollover(node: TorchNode, params, query, body):
    body = dict(body or {})
    if query.get("dry_run") in ("", "true", True):
        body["dry_run"] = True
    return 200, node.rollover(params["index"], body)


def rollover_named(node: TorchNode, params, query, body):
    body = dict(body or {})
    body["new_index"] = params["new_index"]
    if query.get("dry_run") in ("", "true", True):
        body["dry_run"] = True
    return 200, node.rollover(params["index"], body)


def close_index(node: TorchNode, params, query, body):
    return 200, node.close_index(params["index"])


def open_index(node: TorchNode, params, query, body):
    return 200, node.open_index(params["index"])


def analyze_index(node: TorchNode, params, query, body):
    return 200, node.analyze(params["index"], body or {})


def analyze_global(node: TorchNode, params, query, body):
    return 200, node.analyze(None, body or {})


# -- document reads and query tools ------------------------------------------


def _mget_deprecated_check(body):
    for spec in (body or {}).get("docs", []) or []:
        if isinstance(spec, dict) and ("_type" in spec or "fields" in spec):
            raise IllegalArgumentException(
                f"Unsupported field [{'_type' if '_type' in spec else 'fields'}] "
                f"used in multi get request"
            )


def mget(node: TorchNode, params, query, body):
    _mget_deprecated_check(body)
    sf = query.get("stored_fields")
    return 200, node.mget(params["index"], body or {},
                          realtime=_realtime_param(query),
                          refresh=str(query.get("refresh", "false"))
                          in ("true", ""),
                          stored_fields=sf.split(",") if sf else None)


def mget_all(node: TorchNode, params, query, body):
    _mget_deprecated_check(body)
    return 200, node.mget(None, body or {},
                          realtime=_realtime_param(query),
                          refresh=str(query.get("refresh", "false"))
                          in ("true", ""))


def explain_doc(node: TorchNode, params, query, body):
    b = _body_with_query_params(query, body)
    lenient = str(query.get("lenient", "false")) in ("true", "")
    try:
        resp = node.explain(params["index"], params["id"], b,
                            routing=_routing_param(query))
    except (DocumentMissingException, IndexNotFoundException):
        raise
    except Exception:  # noqa: BLE001 - ?lenient swallows parse failures
        if not lenient:
            raise
        resp = {"_index": params["index"], "_id": params["id"],
                "matched": False,
                "explanation": {"value": 0.0,
                                "description": "lenient parse failure",
                                "details": []}}
    # _source on the GetResult rider: false drops it, a pattern list
    # filters it (?_source=a.b is shorthand for includes)
    get = resp.get("get")
    if isinstance(get, dict):
        src_param = str(query.get("_source", "true"))
        includes = (query.get("_source_includes")
                    or query.get("_source_include"))
        excludes = (query.get("_source_excludes")
                    or query.get("_source_exclude"))
        if src_param == "false":
            get = {k: v for k, v in get.items() if k != "_source"}
        else:
            if src_param not in ("true", "") and not includes:
                includes = src_param
            if includes or excludes:
                spec = {
                    **({"includes": str(includes).split(",")}
                       if includes else {}),
                    **({"excludes": str(excludes).split(",")}
                       if excludes else {}),
                }
                get = {**get, "_source": _source_filter(spec)(
                    get.get("_source"))}
        resp = {**resp, "get": get}
    return 200, resp


def _field_caps_of(node: TorchNode, index, query, body):
    fields = query.get("fields") or (body or {}).get("fields", "")
    if isinstance(fields, list):
        fields = ",".join(fields)
    return 200, node.field_caps(
        index, fields,
        include_unmapped=str(query.get("include_unmapped",
                                       "false")) in ("true", ""),
        index_filter=(body or {}).get("index_filter"))


def field_caps(node: TorchNode, params, query, body):
    return _field_caps_of(node, params["index"], query, body)


def field_caps_all(node: TorchNode, params, query, body):
    return _field_caps_of(node, None, query, body)


def termvectors(node: TorchNode, params, query, body):
    b = dict(body or {})
    if query.get("term_statistics") in ("", "true", True):
        b["term_statistics"] = True
    for flag in ("field_statistics", "offsets", "positions"):
        if str(query.get(flag, "true")) == "false":
            b[flag] = False
    return 200, node.termvectors(
        params["index"], params["id"], b,
        fields=query.get("fields"),
        realtime=str(query.get("realtime", "true")) in ("true", ""),
        routing=_routing_param(query))


def mtermvectors(node: TorchNode, params, query, body):
    return 200, node.mtermvectors(
        body or {},
        index=params.get("index") or query.get("index"),
        ids=query.get("ids"),
        term_statistics=str(query.get("term_statistics", "false"))
        in ("true", ""),
        realtime=str(query.get("realtime", "true")) in ("true", ""))


def search_shards_handler(node: TorchNode, params, query, body):
    return 200, node.search_shards(
        index=params.get("index") or query.get("index"),
        routing=query.get("routing"),
        body=body,
        preference=query.get("preference"))


def validate_query(node: TorchNode, params, query, body):
    """[/{index}]/_validate/query (ValidateQueryAction): the query is
    parsed, never run; `explain` adds a rendering, the reference's
    ApproximateScoreQuery wrapper for match_all."""
    from opensearch_tpu_torch.search import query_dsl as qd

    index = params.get("index")
    names = node.resolve_indices(index) if index else sorted(node.indices)
    explain = str(query.get("explain", "false")) in ("true", "")
    body = body or {}
    qbody = body.get("query")
    if qbody is None and set(body):
        # a body not wrapped in {"query": ...} is invalid; the error text
        # shows only with explain
        out = {"valid": False,
               "_shards": {"total": 1, "successful": 1, "failed": 0}}
        if explain:
            out["error"] = (f"request does not support "
                            f"[{next(iter(body))}]")
        return 200, out
    if qbody is None and query.get("q"):
        qbody = {"query_string": {"query": str(query["q"])}}
    try:
        parsed = qd.parse_query(qbody)
    except OpenSearchTpuException as e:
        out = {"valid": False,
               "_shards": {"total": 1, "successful": 1, "failed": 0}}
        if explain:
            out["error"] = f"ParsingException[{e}]"
        return 200, out
    out = {"valid": True,
           "_shards": {"total": 1, "successful": 1, "failed": 0}}
    if explain:
        if isinstance(parsed, qd.MatchAllQuery):
            rendering = ("ApproximateScoreQuery(originalQuery=*:*, "
                         "approximationQuery=Approximate(*:*))")
        else:
            rendering = json.dumps(qbody, sort_keys=True)
        out["explanations"] = [
            {"index": name, "valid": True, "explanation": rendering}
            for name in names]
    return 200, out


# -- snapshots and repositories ---------------------------------------------


def put_repository(node: TorchNode, params, query, body):
    return 200, node.snapshots.put_repository(params["repo"], body or {})


def get_repositories(node: TorchNode, params, query, body):
    return 200, node.snapshots.get_repository(None)


def get_repository(node: TorchNode, params, query, body):
    return 200, node.snapshots.get_repository(params["repo"])


def delete_repository(node: TorchNode, params, query, body):
    return 200, node.snapshots.delete_repository(params["repo"])


def create_snapshot(node: TorchNode, params, query, body):
    return 200, node.snapshots.create_snapshot(
        params["repo"], params["snapshot"], body
    )


def get_snapshot(node: TorchNode, params, query, body):
    return 200, node.snapshots.get_snapshot(
        params["repo"], params["snapshot"],
        verbose=str(query.get("verbose", "true")) in ("true", ""),
        ignore_unavailable=str(query.get("ignore_unavailable", "false"))
        in ("true", ""),
    )


def delete_snapshot(node: TorchNode, params, query, body):
    return 200, node.snapshots.delete_snapshot(params["repo"],
                                               params["snapshot"])


def restore_snapshot(node: TorchNode, params, query, body):
    return 200, node.snapshots.restore_snapshot(
        params["repo"], params["snapshot"], body
    )


def snapshot_status(node: TorchNode, params, query, body):
    try:
        return 200, node.snapshots.snapshot_status(params["repo"],
                                                   params["snapshot"])
    except SnapshotMissingException:
        if str(query.get("ignore_unavailable", "false")) in ("true", ""):
            return 200, {"snapshots": []}
        raise


def cleanup_repository(node: TorchNode, params, query, body):
    """POST /_snapshot/{repo}/_cleanup (CleanupRepositoryAction): the
    content-addressed store garbage-collects on delete, so cleanup finds
    nothing stale."""
    node.snapshots.get_repository(params["repo"])  # 404 on missing repo
    return 200, {"results": {"deleted_bytes": 0, "deleted_blobs": 0}}


def cat_repositories(node: TorchNode, params, query, body):
    rows = [{"id": name, "type": conf.get("type", "fs")}
            for name, conf in sorted(node.snapshots.repositories.items())]
    return 200, _cat_format(query, rows, cols=["id", "type"])


def cat_snapshots(node: TorchNode, params, query, body):
    cols = ["id", "status", "start_epoch", "start_time", "end_epoch",
            "end_time", "duration", "indices", "successful_shards",
            "failed_shards", "total_shards"]
    help_cols = cols + ["reason"]
    repo = params.get("repo")
    if repo is None:
        return 200, _cat_format(query, [], cols=cols, help_cols=help_cols)
    snaps = node.snapshots.get_snapshot(repo, "_all")
    rows = []
    for sn in snaps.get("snapshots", []):
        start_s = sn.get("start_time_in_millis", 0) // 1000
        end_s = sn.get("end_time_in_millis", 0) // 1000
        shards = sn.get("shards") or {}
        rows.append({
            "id": sn.get("snapshot"),
            "status": sn.get("state", "SUCCESS"),
            "start_epoch": start_s,
            "start_time": time.strftime("%H:%M:%S", time.gmtime(start_s)),
            "end_epoch": end_s,
            "end_time": time.strftime("%H:%M:%S", time.gmtime(end_s)),
            "duration": f"{max(end_s - start_s, 0)}s",
            "indices": len(sn.get("indices", [])),
            "successful_shards": shards.get("successful", 0),
            "failed_shards": shards.get("failed", 0),
            "total_shards": shards.get("total", 0),
        })
    return 200, _cat_format(query, rows, cols=cols, help_cols=help_cols)


# -- the remote segment store -----------------------------------------------


def remotestore_restore(node: TorchNode, params, query, body):
    indices = (body or {}).get("indices") or []
    if isinstance(indices, str):
        indices = indices.split(",")
    if not indices:
        raise IllegalArgumentException("[indices] is required for restore")
    return 200, node.remote_store.restore(indices)


def remotestore_sync(node: TorchNode, params, query, body):
    return 200, {"shards": node.remote_store.sync_index(params["index"])}


def remotestore_stats(node: TorchNode, params, query, body):
    return 200, node.remote_store.stats(params.get("index"))


# -- rank evaluation and the reindex family ---------------------------------


def rank_eval_handler(node: TorchNode, params, query, body):
    from opensearch_tpu_torch.search.rank_eval import rank_eval

    return 200, rank_eval(node, params["index"], body or {})


def rank_eval_all(node: TorchNode, params, query, body):
    from opensearch_tpu_torch.search.rank_eval import rank_eval

    return 200, rank_eval(node, None, body or {})


def reindex_handler(node: TorchNode, params, query, body):
    from opensearch_tpu_torch.reindex import reindex as do_reindex

    return 200, do_reindex(node, body or {}, refresh=_refresh_param(query))


def update_by_query_handler(node: TorchNode, params, query, body):
    from opensearch_tpu_torch.reindex import update_by_query

    return 200, update_by_query(
        node, params["index"], body or {},
        conflicts=query.get("conflicts"),
        refresh=_refresh_param(query),
    )


def delete_by_query_handler(node: TorchNode, params, query, body):
    from opensearch_tpu_torch.reindex import delete_by_query

    return 200, delete_by_query(
        node, params["index"], body or {},
        conflicts=query.get("conflicts"),
        refresh=_refresh_param(query),
    )


# -- the control plane on the single node ------------------------------------


def cluster_state_metric(node: TorchNode, params, query, body):
    """GET /_cluster/state[/{metric}[/{index}]] (ClusterStateAction)."""
    metrics = str(params.get("metric", "_all")).split(",")
    index = params.get("index") or query.get("index")
    return 200, node.cluster_state(
        metrics=metrics, index=index,
        expand_wildcards=str(query.get("expand_wildcards", "all")),
        ignore_unavailable=str(query.get("ignore_unavailable", "false"))
        in ("true", ""),
        allow_no_indices=str(query.get("allow_no_indices", "true"))
        in ("true", ""),
    )


def cluster_pending_tasks(node: TorchNode, params, query, body):
    return 200, node.pending_cluster_tasks()


def post_voting_config_exclusions(node: TorchNode, params, query, body):
    return 200, node.add_voting_config_exclusions(
        node_ids=query.get("node_ids"), node_names=query.get("node_names")
    )


def delete_voting_config_exclusions(node: TorchNode, params, query, body):
    return 200, node.clear_voting_config_exclusions()


def cluster_reroute(node: TorchNode, params, query, body):
    metrics = None
    if query.get("metric"):
        metrics = [m.strip() for m in str(query["metric"]).split(",")]
    return 200, node.cluster_reroute(
        body,
        explain=str(query.get("explain", "false")) in ("true", ""),
        dry_run=str(query.get("dry_run", "false")) in ("true", ""),
        metrics=metrics,
    )


def allocation_explain(node: TorchNode, params, query, body):
    return 200, node.allocation_explain(
        body,
        include_disk_info=str(query.get("include_disk_info", "false"))
        in ("true", ""),
    )


def indices_shard_stores(node: TorchNode, params, query, body):
    """GET [/{index}]/_shard_stores (IndicesShardStoresAction)."""
    names = [n for n in _admin_indices(node, params, query)
             if not node.indices[n].closed]
    out_indices = {}
    for name in names:
        svc = node.indices[name]
        shards_out = {}
        for sid in range(svc.num_shards):
            shards_out[str(sid)] = {"stores": [{
                "node-0": {
                    "name": node.node_name,
                    "ephemeral_id": node.cluster_uuid,
                    "transport_address": "127.0.0.1:9300",
                    "attributes": {},
                },
                "allocation_id": f"{name}#{sid}",
                "allocation": "primary",
            }]}
        out_indices[name] = {"shards": shards_out}
    return 200, {"indices": out_indices}


def remote_info(node: TorchNode, params, query, body):
    from opensearch_tpu_torch.cluster.remote import RemoteClusterService

    return 200, RemoteClusterService(node).info()


def cat_pending_tasks(node: TorchNode, params, query, body):
    return 200, _cat_format(query, [])


def _recovery_record_stats(p: dict) -> tuple[str, str, str]:
    """(bytes_percent, ops_percent, api_type) for one RecoveryProgress
    record — the shared shaping for /_recovery and _cat/recovery.
    Relocation transfers are peer recoveries wearing a different routing
    hat (the reference reports them as PEER too)."""
    pct_bytes = (100.0 * p["bytes_recovered"] / p["bytes_total"]
                 if p["bytes_total"] else 100.0)
    pct_ops = (100.0 * p["ops_recovered"] / p["ops_total"]
               if p["ops_total"] else 100.0)
    api_type = {"RELOCATION": "PEER"}.get(p["type"], p["type"])
    return f"{pct_bytes:.1f}%", f"{pct_ops:.1f}%", api_type


def _cluster_recovery_shards(node, index_expr):
    """Shape cluster-wide RecoveryProgress records (facade.recovery_records)
    into the /_recovery per-shard entries."""
    import time as _time

    out: dict[str, list] = {}
    for p in node.recovery_records(index_expr):
        pct_bytes, pct_ops, api_type = _recovery_record_stats(p)
        out.setdefault(p["index"], []).append({
            "id": p["shard"],
            "type": api_type,
            "stage": p["stage"],
            "primary": p["type"] in ("EMPTY_STORE", "EXISTING_STORE"),
            "start_time": _time.strftime(
                "%Y-%m-%dT%H:%M:%S.000Z",
                _time.gmtime(p["start_ms"] / 1000)),
            "start_time_in_millis": p["start_ms"],
            "total_time_in_millis": p["total_time_ms"],
            "source": ({"id": p["source_node"], "name": p["source_node"]}
                       if p.get("source_node") else {}),
            "target": {"id": p["target_node"], "name": p["target_node"]},
            "index": {
                "files": {"total": p["files_total"],
                          "reused": 0,
                          "recovered": p["files_recovered"],
                          "percent": pct_bytes},
                "size": {"total_in_bytes": p["bytes_total"],
                         "reused_in_bytes": 0,
                         "recovered_in_bytes": p["bytes_recovered"],
                         "percent": pct_bytes},
                "source_throttle_time_in_millis": 0,
                "target_throttle_time_in_millis": 0,
            },
            "translog": {"recovered": p["ops_recovered"],
                         "total": p["ops_total"],
                         "total_on_start": p["ops_total"],
                         "total_time_in_millis": 0,
                         "percent": pct_ops},
            "verify_index": {"check_index_time_in_millis": 0,
                             "total_time_in_millis": 0},
            "retries": p.get("retries", 0),
        })
    return out

def indices_recovery(node: TorchNode, params, query, body):
    """GET [/{index}]/_recovery (RecoveryAction): per-shard recovery
    state; local shards report their store bootstrap as a DONE
    EMPTY_STORE/EXISTING_STORE recovery. On a cluster node (the
    ClusterFacade of cluster/facade.py) the REAL peer-recovery and
    relocation progress records are aggregated from every node."""
    import time as _time

    if hasattr(node, "recovery_records"):
        active_only = str(query.get("active_only", "false")) in ("true", "")
        shards_by_index = _cluster_recovery_shards(node, params.get("index"))
        return 200, {
            name: {"shards": [
                s for s in shards
                if not active_only or s["stage"] not in ("DONE", "FAILED")
            ]}
            for name, shards in sorted(shards_by_index.items())
        }

    names = _admin_indices(node, params, query, expand_default="all")
    out = {}
    for name in names:
        svc = node.indices[name]
        shards = []
        for sid, shard in sorted(svc.shards.items()):
            nfiles = len(shard.engine._segments)
            nbytes = sum(
                sum(len(s) for s in h.sources)
                for h, _d in shard.engine._segments)
            ops = shard.engine.translog.stats()["operations"] \
                if hasattr(shard.engine.translog, "stats") else 0
            existing = (node.data_path / "indices" / name / str(sid) /
                        "commit.json").exists()
            from_snap = getattr(svc, "restored_from_snapshot", None)
            if from_snap:
                # SNAPSHOT recovery reports the restored Lucene files —
                # an empty index still restores its one commit point
                nfiles = max(nfiles, 1)
                nbytes = max(nbytes, 1)
            recovered_files = nfiles if from_snap else 0
            reused_files = 0 if from_snap else nfiles
            shards.append({
                "id": sid,
                "type": ("SNAPSHOT" if from_snap
                         else "EXISTING_STORE" if existing
                         else "EMPTY_STORE"),
                "stage": "DONE",
                "primary": True,
                "start_time": _time.strftime(
                    "%Y-%m-%dT%H:%M:%S.000Z",
                    _time.gmtime(svc.creation_date / 1000)),
                "start_time_in_millis": svc.creation_date,
                "total_time_in_millis": 0,
                "source": {},
                "target": {
                    "id": "node-0", "host": "127.0.0.1",
                    "transport_address": "127.0.0.1:9300",
                    "ip": "127.0.0.1", "name": node.node_name,
                },
                "index": {
                    "files": {"total": nfiles, "reused": reused_files,
                              "recovered": recovered_files,
                              "percent": "100.0%",
                              **({"details": []} if str(query.get(
                                  "detailed", "false")) in ("true", "")
                                 else {})},
                    "size": {"total_in_bytes": nbytes,
                             "reused_in_bytes": 0 if from_snap else nbytes,
                             "recovered_in_bytes":
                                 nbytes if from_snap else 0,
                             "percent": "100.0%"},
                    "source_throttle_time_in_millis": 0,
                    "target_throttle_time_in_millis": 0,
                },
                "translog": {"recovered": ops, "total": ops,
                             "total_on_start": ops,
                             "total_time_in_millis": 0, "percent": "100.0%"},
                "verify_index": {"check_index_time_in_millis": 0,
                                 "total_time_in_millis": 0},
            })
        out[name] = {"shards": shards}
    return 200, out


def cat_recovery(node: TorchNode, params, query, body):
    import fnmatch as _fn

    want = params.get("index")
    pats = [p for p in str(want).split(",") if p] if want else None
    rows = []
    if hasattr(node, "recovery_records"):
        # cluster mode: real recovery/relocation progress from every node
        for p in node.recovery_records(want):
            pct_b, pct_o, api_type = _recovery_record_stats(p)
            rows.append({
                "index": p["index"], "shard": p["shard"],
                "time": f"{p['total_time_ms']}ms",
                "type": api_type.lower(),
                "stage": p["stage"].lower(),
                "source_host": p.get("source_node") or "-",
                "source_node": p.get("source_node") or "-",
                "target_host": p["target_node"],
                "target_node": p["target_node"],
                "repository": "n/a", "snapshot": "n/a",
                "files": p["files_total"],
                "files_recovered": p["files_recovered"],
                "files_percent": pct_b,
                "files_total": p["files_total"],
                "bytes": _human_bytes(p["bytes_total"]),
                "bytes_recovered": _human_bytes(p["bytes_recovered"]),
                "bytes_percent": pct_b,
                "bytes_total": _human_bytes(p["bytes_total"]),
                "translog_ops": p["ops_total"],
                "translog_ops_recovered": p["ops_recovered"],
                "translog_ops_percent": pct_o,
            })
        return 200, _cat_format(query, rows, aliases={
            "i": "index", "s": "shard", "t": "time", "ty": "type",
            "st": "stage", "shost": "source_host", "thost": "target_host",
            "rep": "repository", "snap": "snapshot", "f": "files",
            "fr": "files_recovered", "fp": "files_percent",
            "tf": "files_total", "b": "bytes", "br": "bytes_recovered",
            "bp": "bytes_percent", "tb": "bytes_total",
            "to": "translog_ops", "tor": "translog_ops_recovered",
            "top": "translog_ops_percent"})
    for index, svc in sorted(node.indices.items()):
        if pats is not None and not any(_fn.fnmatch(index, p) for p in pats):
            continue
        from_snap = getattr(svc, "restored_from_snapshot", None)
        for sid, shard in sorted(svc.shards.items()):
            nfiles = len(shard.engine._segments)
            nbytes = sum(sum(len(x) for x in h.sources)
                         for h, _d in shard.engine._segments)
            ops = shard.engine.translog.stats()["operations"]
            rows.append({
                "index": index, "shard": sid, "time": "1ms",
                "type": ("snapshot" if from_snap
                         else "existing_store" if svc.closed
                         else "empty_store"),
                "stage": "done",
                "source_host": "-", "source_node": "-",
                "target_host": "127.0.0.1", "target_node": node.node_name,
                "repository": "n/a",
                "snapshot": from_snap or "n/a",
                "files": nfiles, "files_recovered": nfiles,
                "files_percent": "100.0%", "files_total": nfiles,
                "bytes": _human_bytes(nbytes),
                "bytes_recovered": _human_bytes(nbytes),
                "bytes_percent": "100.0%",
                "bytes_total": _human_bytes(nbytes),
                "translog_ops": ops, "translog_ops_recovered": ops,
                "translog_ops_percent": "100.0%",
            })
    return 200, _cat_format(query, rows, aliases={
        "i": "index", "s": "shard", "t": "time", "ty": "type",
        "st": "stage", "shost": "source_host", "thost": "target_host",
        "rep": "repository", "snap": "snapshot", "f": "files",
        "fr": "files_recovered", "fp": "files_percent",
        "tf": "files_total", "b": "bytes", "br": "bytes_recovered",
        "bp": "bytes_percent", "tb": "bytes_total",
        "to": "translog_ops", "tor": "translog_ops_recovered",
        "top": "translog_ops_percent"})
