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
`query_group` and `request_cache`, `_bulk` reads `query_group`. Every
other route answers through
:func:`_not_yet_ported`, which raises "<METHOD> <path> is not yet ported
to opensearch_tpu_torch" (the HTTP server's 500 envelope). Handlers
receive (node, params, query, body) and return (status, payload); the
HTTP server is transport-only.
"""

from __future__ import annotations

import fnmatch
import logging
import re
from typing import Any

from opensearch_tpu_torch import __version__
from opensearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    IndexNotFoundException,
    OpenSearchTpuException,
    ResourceNotFoundException,
)
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.rest.router import Router
from opensearch_tpu_torch.search.executor import not_yet_ported
from opensearch_tpu_torch.search.service import _source_filter

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
    # the rest of the reference's surface
    for method, template in UNPORTED_ROUTES:
        reg(method, template, _not_yet_ported(method, template))
    return r


def _not_yet_ported(method: str, template: str):
    """The handler of a route the port does not serve yet."""

    def handler(node: TorchNode, params, query, body):
        raise not_yet_ported(f"{method} {template}")

    return handler


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


def get_index(node: TorchNode, params, query, body):
    out = {}
    for name in node.resolve_indices(
        params["index"],
        ignore_unavailable=str(query.get("ignore_unavailable", "false"))
        in ("true", ""),
        allow_no_indices=str(query.get("allow_no_indices", "true")) != "false",
    ):
        out[name] = {
            # aliases are not ported: an index has none
            "aliases": {},
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


def _check_require_alias(index: str, query) -> None:
    """require_alias: the write target must be an alias, never a concrete
    (or auto-created) index (RestIndexAction / DocWriteRequest). The port
    has no aliases, so the flag always refuses."""
    if query.get("require_alias") not in ("true", ""):
        return
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
    _check_require_alias(params["index"], query)
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
    _check_require_alias(params["index"], query)
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
                          query_group=query.get("query_group"))


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
    ledger and the device-memory residency snapshot."""
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


# every (method, path) of the reference's router that the port does not
# serve yet: each answers "not yet ported" (a 500), never a 404 or 405
UNPORTED_ROUTES = (
    ("GET", "/_mapping/field/{fields}"),
    ("GET", "/{index}/_mapping/field/{fields}"),
    ("PUT", "/{index}/_mapping"),
    ("POST", "/{index}/_mapping"),
    ("PUT", "/{index}/_settings"),
    ("PUT", "/_settings"),
    ("GET", "/_mget"),
    ("POST", "/_mget"),
    ("GET", "/{index}/_mget"),
    ("POST", "/{index}/_mget"),
    ("GET", "/{index}/_explain/{id}"),
    ("POST", "/{index}/_explain/{id}"),
    ("GET", "/_field_caps"),
    ("POST", "/_field_caps"),
    ("GET", "/{index}/_field_caps"),
    ("POST", "/{index}/_field_caps"),
    ("GET", "/{index}/_termvectors/{id}"),
    ("POST", "/{index}/_termvectors/{id}"),
    ("GET", "/_mtermvectors"),
    ("POST", "/_mtermvectors"),
    ("GET", "/{index}/_mtermvectors"),
    ("POST", "/{index}/_mtermvectors"),
    ("PUT", "/_ingest/pipeline/{id}"),
    ("GET", "/_ingest/pipeline"),
    ("GET", "/_ingest/pipeline/{id}"),
    ("DELETE", "/_ingest/pipeline/{id}"),
    ("POST", "/_ingest/pipeline/{id}/_simulate"),
    ("GET", "/_ingest/pipeline/{id}/_simulate"),
    ("POST", "/_ingest/pipeline/_simulate"),
    ("GET", "/_ingest/pipeline/_simulate"),
    ("PUT", "/_template/{name}"),
    ("POST", "/_template/{name}"),
    ("GET", "/_template"),
    ("GET", "/_template/{name}"),
    ("HEAD", "/_template/{name}"),
    ("DELETE", "/_template/{name}"),
    ("PUT", "/_index_template/{name}"),
    ("POST", "/_index_template/{name}"),
    ("GET", "/_index_template"),
    ("GET", "/_index_template/{name}"),
    ("DELETE", "/_index_template/{name}"),
    ("PUT", "/_component_template/{name}"),
    ("POST", "/_component_template/{name}"),
    ("GET", "/_component_template"),
    ("GET", "/_component_template/{name}"),
    ("DELETE", "/_component_template/{name}"),
    ("PUT", "/{index}/_block/{block}"),
    ("GET", "/_segments"),
    ("GET", "/{index}/_segments"),
    ("GET", "/_shard_stores"),
    ("GET", "/{index}/_shard_stores"),
    ("GET", "/_recovery"),
    ("GET", "/{index}/_recovery"),
    ("POST", "/_upgrade"),
    ("POST", "/{index}/_upgrade"),
    ("GET", "/_upgrade"),
    ("GET", "/{index}/_upgrade"),
    ("PUT", "/{index}/_shrink/{target}"),
    ("POST", "/{index}/_shrink/{target}"),
    ("PUT", "/{index}/_split/{target}"),
    ("POST", "/{index}/_split/{target}"),
    ("PUT", "/{index}/_clone/{target}"),
    ("POST", "/{index}/_clone/{target}"),
    ("POST", "/{index}/_rollover"),
    ("POST", "/{index}/_rollover/{new_index}"),
    ("POST", "/{index}/_close"),
    ("POST", "/{index}/_open"),
    ("GET", "/{index}/_analyze"),
    ("POST", "/{index}/_analyze"),
    ("GET", "/_analyze"),
    ("POST", "/_analyze"),
    ("PUT", "/_snapshot/{repo}"),
    ("POST", "/_snapshot/{repo}"),
    ("GET", "/_snapshot"),
    ("GET", "/_snapshot/{repo}"),
    ("DELETE", "/_snapshot/{repo}"),
    ("POST", "/_snapshot/{repo}/_cleanup"),
    ("PUT", "/_snapshot/{repo}/{snapshot}"),
    ("POST", "/_snapshot/{repo}/{snapshot}"),
    ("GET", "/_snapshot/{repo}/{snapshot}"),
    ("DELETE", "/_snapshot/{repo}/{snapshot}"),
    ("POST", "/_snapshot/{repo}/{snapshot}/_restore"),
    ("GET", "/_snapshot/{repo}/{snapshot}/_status"),
    ("GET", "/{index}/_rank_eval"),
    ("POST", "/{index}/_rank_eval"),
    ("GET", "/_rank_eval"),
    ("POST", "/_rank_eval"),
    ("POST", "/_reindex"),
    ("POST", "/{index}/_update_by_query"),
    ("POST", "/{index}/_delete_by_query"),
    ("GET", "/_prometheus/metrics"),
    ("GET", "/_cluster/stats"),
    ("GET", "/_stats"),
    ("GET", "/_stats/{metric}"),
    ("GET", "/{index}/_stats"),
    ("GET", "/{index}/_stats/{metric}"),
    ("GET", "/_cluster/state"),
    ("GET", "/_cluster/state/{metric}"),
    ("GET", "/_cluster/state/{metric}/{index}"),
    ("GET", "/_cluster/pending_tasks"),
    ("POST", "/_cluster/voting_config_exclusions"),
    ("DELETE", "/_cluster/voting_config_exclusions"),
    ("POST", "/_cluster/reroute"),
    ("GET", "/_cluster/allocation/explain"),
    ("POST", "/_cluster/allocation/explain"),
    ("GET", "/_search_shards"),
    ("POST", "/_search_shards"),
    ("GET", "/{index}/_search_shards"),
    ("POST", "/{index}/_search_shards"),
    ("GET", "/_validate/query"),
    ("POST", "/_validate/query"),
    ("GET", "/{index}/_validate/query"),
    ("POST", "/{index}/_validate/query"),
    ("GET", "/_remote/info"),
    ("POST", "/_remotestore/_restore"),
    ("POST", "/{index}/_remotestore/_sync"),
    ("GET", "/_remotestore/stats/{index}"),
    ("GET", "/_nodes"),
    ("GET", "/_nodes/stats"),
    ("GET", "/_nodes/{node_id}/stats"),
    ("GET", "/_nodes/stats/{metric}"),
    ("GET", "/_nodes/stats/{metric}/{index_metric}"),
    ("GET", "/_nodes/{node_id}/stats/{metric}"),
    ("GET", "/_nodes/{node_id}/stats/{metric}/{index_metric}"),
    ("GET", "/_nodes/{node_id}"),
    ("GET", "/_nodes/{node_id}/{metric}"),
    ("GET", "/_cat"),
    ("GET", "/_cat/indices"),
    ("GET", "/_cat/indices/{index}"),
    ("GET", "/_cat/health"),
    ("GET", "/_cat/shards"),
    ("GET", "/_cat/shards/{index}"),
    ("GET", "/_cat/count"),
    ("GET", "/_cat/count/{index}"),
    ("GET", "/_cat/aliases"),
    ("GET", "/_cat/aliases/{name}"),
    ("GET", "/_cat/allocation"),
    ("GET", "/_cat/allocation/{node_id}"),
    ("GET", "/_cat/nodes"),
    ("GET", "/_cat/master"),
    ("GET", "/_cat/cluster_manager"),
    ("GET", "/_cat/nodeattrs"),
    ("GET", "/_cat/plugins"),
    ("GET", "/_cat/templates"),
    ("GET", "/_cat/templates/{name}"),
    ("GET", "/_cat/thread_pool"),
    ("GET", "/_cat/thread_pool/{pattern}"),
    ("GET", "/_cat/segments"),
    ("GET", "/_cat/segments/{index}"),
    ("GET", "/_cat/recovery"),
    ("GET", "/_cat/recovery/{index}"),
    ("GET", "/_cat/pending_tasks"),
    ("GET", "/_cat/repositories"),
    ("GET", "/_cat/snapshots"),
    ("GET", "/_cat/snapshots/{repo}"),
    ("GET", "/_cat/tasks"),
    ("GET", "/_cat/fielddata"),
    ("GET", "/_cat/fielddata/{fields}"),
)
