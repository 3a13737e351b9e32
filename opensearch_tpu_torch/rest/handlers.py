"""REST API handlers: the OpenSearch HTTP surface over a TorchNode.

Counterpart of opensearch_tpu/rest/handlers.py. :func:`build_router`
registers every (method, path) of the reference's router. The handlers of
the API the port serves are copies of the reference's: the root info, the
index lifecycle (create, delete, get, HEAD, mappings, settings), document
writes and reads (index, create, auto-id index, get, HEAD, `_source`,
delete, `_update`), NDJSON `_bulk`, `_refresh`, `_search`, `_msearch`
and `_cluster/health`. Every other route answers through
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
)
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.rest.router import Router
from opensearch_tpu_torch.search.distributed_serving import not_yet_ported
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
    # maintenance
    reg("POST", "/{index}/_refresh", refresh)
    reg("GET", "/{index}/_refresh", refresh)
    reg("POST", "/_refresh", refresh_all)
    # cluster
    reg("GET", "/_cluster/health", cluster_health)
    reg("GET", "/_cluster/health/{index}", cluster_health)
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
                          pipeline=query.get("pipeline"))


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
    their kind (the port's search serves neither yet, so until they are
    ported a response passes through unchanged)."""
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


def _unported_search_params(query) -> None:
    """The search parameters whose machinery the port does not have yet
    (scroll contexts, search pipelines, workload groups) raise; a request
    cache hint is accepted (the port caches nothing, and a cached
    response is the same response)."""
    for param, what in (("scroll", "scroll"),
                        ("search_pipeline", "search pipelines"),
                        ("query_group", "workload management")):
        if query.get(param) is not None:
            raise not_yet_ported(what)


def search(node: TorchNode, params, query, body):
    _validate_search_params(query, body)
    _unported_search_params(query)
    resp = node.search(params["index"], _body_with_query_params(query, body),
                       ignore_unavailable=str(
                           query.get("ignore_unavailable", "false")
                       ) in ("true", ""))
    resp = _with_reduce_phases(resp, query)
    resp = _apply_typed_keys(resp, query, body, node, params.get("index"))
    return 200, _totals_as_int(resp, query)


def search_all(node: TorchNode, params, query, body):
    _validate_search_params(query, body)
    _unported_search_params(query)
    resp = node.search(None, _body_with_query_params(query, body))
    resp = _with_reduce_phases(resp, query)
    resp = _apply_typed_keys(resp, query, body, node)
    return 200, _totals_as_int(resp, query)


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
    ("GET", "/{index}/_count"),
    ("POST", "/{index}/_count"),
    ("GET", "/_count"),
    ("POST", "/_count"),
    ("GET", "/_search/scroll"),
    ("POST", "/_search/scroll"),
    ("GET", "/_search/scroll/{scroll_id}"),
    ("POST", "/_search/scroll/{scroll_id}"),
    ("DELETE", "/_search/scroll"),
    ("DELETE", "/_search/scroll/{scroll_id}"),
    ("POST", "/{index}/_search/point_in_time"),
    ("DELETE", "/_search/point_in_time"),
    ("DELETE", "/_search/point_in_time/_all"),
    ("GET", "/_search/point_in_time/_all"),
    ("POST", "/{index}/_flush"),
    ("POST", "/_flush"),
    ("POST", "/{index}/_forcemerge"),
    ("POST", "/_forcemerge"),
    ("POST", "/{index}/_cache/clear"),
    ("POST", "/_cache/clear"),
    ("PUT", "/_ingest/pipeline/{id}"),
    ("GET", "/_ingest/pipeline"),
    ("GET", "/_ingest/pipeline/{id}"),
    ("DELETE", "/_ingest/pipeline/{id}"),
    ("POST", "/_ingest/pipeline/{id}/_simulate"),
    ("GET", "/_ingest/pipeline/{id}/_simulate"),
    ("POST", "/_ingest/pipeline/_simulate"),
    ("GET", "/_ingest/pipeline/_simulate"),
    ("POST", "/_aliases"),
    ("PUT", "/{index}/_alias/{name}"),
    ("POST", "/{index}/_alias/{name}"),
    ("PUT", "/{index}/_alias"),
    ("POST", "/{index}/_alias"),
    ("PUT", "/_alias/{name}"),
    ("POST", "/_alias/{name}"),
    ("PUT", "/_alias"),
    ("POST", "/_alias"),
    ("PUT", "/{index}/_aliases/{name}"),
    ("DELETE", "/{index}/_alias/{name}"),
    ("DELETE", "/{index}/_aliases/{name}"),
    ("GET", "/_alias"),
    ("GET", "/_alias/{name}"),
    ("GET", "/{index}/_alias"),
    ("GET", "/{index}/_alias/{name}"),
    ("HEAD", "/_alias/{name}"),
    ("HEAD", "/{index}/_alias/{name}"),
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
    ("PUT", "/_scripts/{id}"),
    ("POST", "/_scripts/{id}"),
    ("GET", "/_scripts/{id}"),
    ("DELETE", "/_scripts/{id}"),
    ("GET", "/_script_context"),
    ("GET", "/_script_language"),
    ("GET", "/_search/template"),
    ("POST", "/_search/template"),
    ("GET", "/{index}/_search/template"),
    ("POST", "/{index}/_search/template"),
    ("GET", "/_render/template"),
    ("POST", "/_render/template"),
    ("GET", "/_render/template/{id}"),
    ("POST", "/_render/template/{id}"),
    ("PUT", "/_search/pipeline/{id}"),
    ("GET", "/_search/pipeline"),
    ("GET", "/_search/pipeline/{id}"),
    ("DELETE", "/_search/pipeline/{id}"),
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
    ("POST", "/_otel/flush"),
    ("GET", "/_roofline"),
    ("POST", "/_roofline/calibrate"),
    ("GET", "/_tiering/advise"),
    ("GET", "/_tasks"),
    ("GET", "/_tasks/{task_id}"),
    ("POST", "/_tasks/_cancel"),
    ("POST", "/_tasks/{task_id}/_cancel"),
    ("GET", "/_cluster/settings"),
    ("PUT", "/_cluster/settings"),
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
    ("PUT", "/_wlm/query_group"),
    ("GET", "/_wlm/query_group"),
    ("GET", "/_wlm/query_group/{name}"),
    ("DELETE", "/_wlm/query_group/{name}"),
    ("GET", "/_wlm/stats"),
    ("GET", "/_list/wlm_stats"),
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
