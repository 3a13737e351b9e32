"""Search service: query phase -> merge -> fetch phase -> response.

Counterpart of opensearch_tpu/search/service.py, for the slice the port
serves so far: a top-level ``knn`` query, then the fetch of the winning
docs with the reference's fetch options; and msearch's batching of bare
kNN bodies (:func:`msearch_groups`, :func:`try_batched_knn_msearch`: B
bodies' query phase in one stacked launch, handed to :func:`search` as
``precomputed_results``). The route is the reference's
``_try_distributed_query_phase`` choice: the stacked serving step
(search/distributed_serving.mesh_knn_batch) unless it is switched off, a
``min_score`` is set, or the step declines (an ANN-indexed column); then
the per-shard route (search/executor.execute_query_phase per shard, which
serves IVF-PQ, and whose launches go through the dispatch batcher) and
the host merge by (-score, shard, segment, doc). A request key the
reference does not know is a ParsingException (400), as there; every
other query or request key raises "not yet ported".

The fetch phase is the reference's (its sub-phases in search/fetch.py):
``_source`` includes / excludes, ``stored_fields`` (``_none_`` drops
``_id`` and ``_source``; stored fields without an explicit ``_source``
suppress it), ``docvalue_fields``, ``fields``, ``highlight``, ``explain``,
``version`` and ``seq_no_primary_term`` (read from the snapshot's
seal-time doc values). ``"profile": true`` builds the reference's
``profile.shards[*]`` tree (search/profile.py): the stacked step's one
launch shared across its shards (``record_sharded_launch``), or the
per-shard route's operators and batched launches, and the fetch
sub-phases. The response has the reference's shape.
"""

from __future__ import annotations

import fnmatch
import json
import time
from typing import Any

from opensearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    ParsingException,
)
from opensearch_tpu_torch.search import distributed_serving, fetch, query_dsl
from opensearch_tpu_torch.search import profile as search_profile
from opensearch_tpu_torch.search.executor import execute_query_phase

DEFAULT_SIZE = 10
# request keys the reference knows (opensearch_tpu/search/service.py:91-98)
KNOWN_KEYS = {
    "query", "size", "from", "sort", "_source", "aggs", "aggregations",
    "track_total_hits", "min_score", "search_after", "timeout", "version",
    "seq_no_primary_term", "stored_fields", "explain", "highlight",
    "docvalue_fields", "fields", "script_fields", "suggest", "profile",
    "rescore", "collapse", "slice", "indices_boost",
    "include_named_queries_score", "pre_filter_shard_size",
    "stats",  # per-request stat groups (surfaced by indices.stats)
}
# request keys this slice serves: paging and totals, the fetch options
# that apply to a kNN query, min_score, timeout, stats and profile
SUPPORTED_KEYS = {
    "query", "size", "from", "_source", "track_total_hits", "min_score",
    "timeout", "version", "seq_no_primary_term", "stored_fields",
    "explain", "highlight", "docvalue_fields", "fields", "profile",
    "stats",
}


def search(shards: list, body: dict | None,
           precomputed_results: list | None = None) -> dict[str, Any]:
    """Run one knn search over `shards` (IndexShard objects).
    `precomputed_results`, one (shard, snapshot, ShardQueryResult) a shard
    in order, is this body's query phase already run by a batched msearch
    launch (:func:`try_batched_knn_msearch`): the search merges and fetches
    from it, on its snapshots, and runs no query phase."""
    t0 = time.monotonic()
    body = body or {}
    unknown = set(body) - KNOWN_KEYS
    if unknown:
        raise ParsingException(f"unknown search request keys {sorted(unknown)}")
    unsupported = set(body) - SUPPORTED_KEYS
    if unsupported:
        raise distributed_serving.not_yet_ported(
            f"search request keys {sorted(unsupported)}")
    node = query_dsl.parse_query(body.get("query"))
    if not isinstance(node, query_dsl.KnnQuery):
        raise distributed_serving.not_yet_ported(
            f"query [{type(node).__name__}] (only a top-level knn query is "
            f"served)")
    if any(n.name for n in query_dsl.iter_query_nodes(node)):
        raise distributed_serving.not_yet_ported(
            "named queries (matched_queries)")
    size = int(body.get("size", DEFAULT_SIZE))
    from_ = int(body.get("from", 0))
    if size < 0 or from_ < 0:
        raise ParsingException("[size] and [from] must be >= 0")
    track_total = body.get("track_total_hits", True)
    min_score = body.get("min_score")
    want_profile = bool(body.get("profile"))
    fetch_k = from_ + size

    # one deep profiler per shard (search/profile.ShardProfiler)
    shard_profilers: list = []
    shard_query_ns: list[int] = []
    premerged = None
    if precomputed_results is not None:
        per_shard_results = precomputed_results
    else:
        snaps = [s.acquire_searcher() for s in shards]
        out = _try_distributed_query_phase(shards, snaps, node, fetch_k,
                                           min_score)
        if out is not None:
            premerged = out.premerged[0]
            per_shard_results = list(zip(shards, snaps, out.per_query[0]))
            if want_profile:
                # each shard's share of the ONE stacked launch, with the
                # shared launch_id
                desc = search_profile.describe_node(node)
                for _ in per_shard_results:
                    prof = search_profile.ShardProfiler()
                    prof.record_sharded_launch(
                        type(node).__name__, desc, name="shard_mesh_knn",
                        launch_id=out.launch_id, shards=out.shards,
                        wall_ns=out.wall_ns,
                        transfer_bytes=4 * len(node.vector),
                        retraced=out.retraced)
                    shard_profilers.append(prof)
                    shard_query_ns.append(out.wall_ns // max(out.shards, 1))
        else:
            # the per-shard route. can_match is not ported: for a knn query
            # the reference's pre-filter always matches (search/phases.py:68)
            per_shard_results = []
            for shard, snap in zip(shards, snaps):
                prof = (search_profile.ShardProfiler()
                        if want_profile else None)
                t_q = time.perf_counter_ns()
                with search_profile.profiling(prof):
                    result = execute_query_phase(
                        snap, shard.mapper_service, node, size=fetch_k,
                        min_score=(float(min_score) if min_score is not None
                                   else None))
                if want_profile:
                    shard_query_ns.append(time.perf_counter_ns() - t_q)
                    shard_profilers.append(prof)
                per_shard_results.append((shard, snap, result))

    # ---- reduce: the device merge's order, or the host merge by
    # (-score, shard, segment, doc) ----
    total = 0
    max_score = None
    merged: list = []
    for shard_idx, (_shard, _snap, result) in enumerate(per_shard_results):
        total += result.total
        if result.max_score is not None and (
                max_score is None or result.max_score > max_score):
            max_score = result.max_score
        merged.extend((shard_idx, h) for h in result.hits)
    if premerged is not None:
        merged = premerged
    else:
        merged.sort(key=lambda sh: (-sh[1].score, sh[0], sh[1].segment,
                                    sh[1].doc))
    page = merged[from_: from_ + size]

    fetch_prof = (search_profile.FetchProfiler(len(per_shard_results))
                  if want_profile else None)
    hits_json = _fetch_phase(body, node, shards, per_shard_results, page,
                             fetch_prof)

    hits_obj: dict[str, Any] = {"max_score": max_score, "hits": hits_json}
    # track_total_hits: True -> exact; int N -> capped with relation gte;
    # False -> no total object
    if track_total is True:
        hits_obj["total"] = {"value": total, "relation": "eq"}
    elif track_total is not False:
        cap = int(track_total)
        hits_obj["total"] = (
            {"value": cap, "relation": "gte"} if total > cap
            else {"value": total, "relation": "eq"}
        )
    response: dict[str, Any] = {
        "took": int((time.monotonic() - t0) * 1000),
        "timed_out": False,
        "_shards": {"total": len(shards), "successful": len(shards),
                    "skipped": 0, "failed": 0},
        "hits": hits_obj,
    }
    if want_profile:
        response["profile"] = _profile_response(
            body, node, per_shard_results, shard_profilers, shard_query_ns,
            fetch_prof)
    return response


def _fetch_phase(body: dict, node, shards: list, per_shard_results: list,
                 page: list, fetch_prof) -> list[dict]:
    """The reference's fetch phase for the winning docs: each hit's
    metadata, then the sub-phases the request asks for (search/fetch.py),
    timed per shard when `fetch_prof` is set."""
    fields_specs = body.get("fields")
    stored_specs = body.get("stored_fields")
    if isinstance(stored_specs, str):
        stored_specs = [stored_specs]
    stored_none = stored_specs == ["_none_"]
    if stored_none:
        stored_specs = None
    if fields_specs:
        for sh in shards:
            if not sh.mapper_service._source_enabled:
                raise IllegalArgumentException(
                    f"Unable to retrieve the requested [fields] since "
                    f"_source is disabled in the mappings for index "
                    f"[{sh.shard_id.index}]"
                )
        for spec in fields_specs:
            if isinstance(spec, dict) and spec.get("format"):
                fname = spec.get("field", "")
                for sh in shards:
                    m = sh.mapper_service.field_mapper(fname)
                    if m is not None and m.type not in ("date",):
                        raise IllegalArgumentException(
                            f"Field [{fname}] of type "
                            f"[{m.original_type or m.type}] doesn't "
                            f"support formats."
                        )
    # stored_fields without an explicit _source suppresses _source in hits
    # (RestSearchAction's storedFieldsContext default)
    src_spec = body.get(
        "_source",
        True if (stored_specs is None and not stored_none)
        or (stored_specs and "_source" in stored_specs) else False,
    )
    source_filter = _source_filter(src_spec)
    highlight_conf = body.get("highlight")
    docvalue_specs = body.get("docvalue_fields")
    want_explain = bool(body.get("explain"))
    want_version = bool(body.get("version"))
    want_seqno = bool(body.get("seq_no_primary_term"))
    preds_by_field: dict = {}
    if highlight_conf:
        preds_by_field = fetch.field_term_predicates(
            node, _MultiMapperView([s.mapper_service for s in shards]))
    now_ns = time.perf_counter_ns
    hits_json = []
    for shard_idx, h in page:
        shard, snapshot, _result = per_shard_results[shard_idx]
        host = snapshot.segments[h.segment][0]
        ms = shard.mapper_service
        if fetch_prof is not None:
            fetch_prof.hit(shard_idx)
        hit: dict[str, Any] = {
            "_index": shard.shard_id.index,
            "_id": host.doc_ids[h.doc],
            "_score": h.score,
        }
        if stored_none:
            # stored_fields: _none_ drops per-hit metadata (_id/_source)
            hit.pop("_id", None)
        doc_routing = host.doc_routings[h.doc] if host.doc_routings else None
        if doc_routing is not None:
            hit["_routing"] = doc_routing
        ig = host.keyword_fields.get("_ignored")
        if ig is not None:
            s_, e_ = int(ig.mv_offsets[h.doc]), int(ig.mv_offsets[h.doc + 1])
            if e_ > s_:
                hit["_ignored"] = sorted(
                    ig.ord_values[int(o)] for o in ig.mv_ords[s_:e_])
        t0 = now_ns() if fetch_prof is not None else 0
        raw_source = json.loads(host.sources[h.doc])
        src = source_filter(raw_source)
        if src is not None:
            hit["_source"] = src
        if fetch_prof is not None:
            fetch_prof.add(shard_idx, "load_source", t0)
        if docvalue_specs:
            t0 = now_ns() if fetch_prof is not None else 0
            dv = fetch.docvalue_fields_for_doc(docvalue_specs, host, h.doc, ms)
            if dv:
                hit.setdefault("fields", {}).update(dv)
            if fetch_prof is not None:
                fetch_prof.add(shard_idx, "docvalue_fields", t0)
        if fields_specs:
            t0 = now_ns() if fetch_prof is not None else 0
            fv = fetch.fields_option_for_doc(fields_specs, raw_source, host,
                                             h.doc, ms)
            if fv:
                hit.setdefault("fields", {}).update(fv)
            if fetch_prof is not None:
                fetch_prof.add(shard_idx, "fields", t0)
        if stored_specs:
            # explicitly stored fields surface under "fields" (read from the
            # segment's columns)
            t0 = now_ns() if fetch_prof is not None else 0
            for sf in stored_specs:
                if sf in ("_source", "_id", "_routing", "*"):
                    continue
                m_sf = ms.field_mapper(sf)
                if m_sf is None or not m_sf.store:
                    continue
                vals = fetch._doc_column_values(host, h.doc, sf, ms, None)
                if vals:
                    hit.setdefault("fields", {})[sf] = vals
            if fetch_prof is not None:
                fetch_prof.add(shard_idx, "stored_fields", t0)
        if highlight_conf:
            t0 = now_ns() if fetch_prof is not None else 0
            hl = fetch.compute_highlight(highlight_conf, preds_by_field,
                                         raw_source, ms)
            if hl:
                hit["highlight"] = hl
            if fetch_prof is not None:
                fetch_prof.add(shard_idx, "highlight", t0)
        if want_explain:
            t0 = now_ns() if fetch_prof is not None else 0
            hit["_explanation"] = fetch.explain_for_hit(h.score, node)
            if fetch_prof is not None:
                fetch_prof.add(shard_idx, "explain", t0)
        # read from the pinned snapshot's seal-time doc values, not the
        # live version map: a hit reports the version of the _source it
        # carries
        if want_version:
            hit["_version"] = int(host.doc_versions[h.doc])
        if want_seqno:
            hit["_seq_no"] = int(host.doc_seq_nos[h.doc])
            hit["_primary_term"] = 1
        hits_json.append(hit)
    return hits_json


def _profile_response(body: dict, node, per_shard_results: list,
                      shard_profilers: list, shard_query_ns: list,
                      fetch_prof) -> dict:
    """The reference's ``profile`` section: per shard the operator tree,
    rewrite and collector times, the device rollup (under the reference's
    ``tpu`` key) and the fetch sub-phases. ``device`` lists the
    residency ledger's rows, which the port does not keep yet."""
    profs = shard_profilers or [None] * len(per_shard_results)
    shards_profile = []
    for shard_idx, ((shard, _snap, _r), prof) in enumerate(
            zip(per_shard_results, profs)):
        t_ns = (shard_query_ns[shard_idx]
                if shard_idx < len(shard_query_ns) else 0)
        query_entries = prof.query_entries() if prof is not None else []
        if not query_entries:
            # a precomputed query phase: one zeroed entry keeps the shape
            query_entries = [{
                "type": type(node).__name__,
                "description": json.dumps(body.get("query") or {}),
                "time_in_nanos": t_ns,
                "breakdown": {
                    "create_weight": 0, "create_weight_count": 0,
                    "build_scorer": 0, "build_scorer_count": 0,
                    "score": t_ns, "score_count": 0,
                    "next_doc": 0, "next_doc_count": 0,
                },
                "device_time_in_nanos": 0,
                "transfer_bytes": 0,
                "retraced": False,
            }]
        shards_profile.append({
            "id": f"[{shard.shard_id.index}][{shard.shard_id.shard}]",
            "fetch": (fetch_prof.entry(shard_idx)
                      if fetch_prof is not None else None),
            "searches": [{
                "query": query_entries,
                "rewrite_time": prof.rewrite_ns if prof else 0,
                "collector": [{
                    "name": "SimpleTopDocsCollector",
                    "reason": "search_top_hits",
                    "time_in_nanos": (prof.collect_ns if prof is not None
                                      else t_ns),
                }],
            }],
            "tpu": (prof.tpu_summary() if prof is not None else
                    {"device_time_in_nanos": 0, "transfer_bytes": 0,
                     "jit_retrace": False}),
            "aggregations": [],
        })
    return {"shards": shards_profile, "device": []}


def _try_distributed_query_phase(shards: list, snaps: list, node,
                                 fetch_k: int, min_score=None):
    """The stacked serving step's launch outcome for this query, or None
    when the per-shard route must answer it: no shards, a ``min_score``
    (the reference's step declines it too), the step switched off
    (``distributed_serving.enabled``), or the step declining the shard
    set (``distributed_serving._can_serve``: among others, an unfiltered
    query on an ANN-indexed column)."""
    if (not shards or min_score is not None
            or not distributed_serving.enabled):
        return None
    return distributed_serving.mesh_knn_batch(shards, snaps, [node], fetch_k)


# the request keys a bare kNN msearch body may carry and still share a
# batched launch (the reference's set)
_BATCHABLE_KNN_KEYS = {
    "query", "size", "from", "track_total_hits", "_source",
    "version", "seq_no_primary_term",
}


def msearch_knn_batchable(body) -> bool:
    """Cheap structural test for msearch batch grouping: a bare top-level
    knn query with only paging and source keys. The deep validation (the
    same field and k, no filter, parseable) runs in
    :func:`try_batched_knn_msearch`."""
    if not isinstance(body, dict):
        return False
    if set(body) - _BATCHABLE_KNN_KEYS:
        return False
    query = body.get("query")
    return isinstance(query, dict) and set(query) == {"knn"}


def msearch_groups(searches: list) -> list[list[int]]:
    """Partition msearch positions into runs: consecutive batchable kNN
    sub-searches against the same index group together (one device
    launch); everything else is a run of one."""
    groups: list[list[int]] = []
    i = 0
    while i < len(searches):
        header, body = searches[i]
        index = header.get("index")
        group = [i]
        if index is not None and msearch_knn_batchable(body):
            j = i + 1
            while (j < len(searches)
                   and searches[j][0].get("index") == index
                   and msearch_knn_batchable(searches[j][1])):
                group.append(j)
                j += 1
        groups.append(group)
        i = group[-1] + 1
    return groups


def try_batched_knn_msearch(shards: list, bodies: list[dict],
                            acquired: list) -> list[list] | None:
    """The query phase of an msearch run whose bodies are all bare knn
    queries on one index with the same field and k and no filter: ONE
    stacked launch scores all B query vectors
    (distributed_serving.try_distributed_knn_batch) instead of B launches.
    Returns, per body, the [(shard, snapshot, result)] list :func:`search`
    takes as ``precomputed_results``, or None when a body is not batchable
    or the stacked step declines (the caller runs the bodies one by one,
    each still eligible for the single-query stacked step)."""
    if len(bodies) < 2 or not shards or not distributed_serving.enabled:
        return None
    nodes = []
    fetch_k = 0
    for body in bodies:
        if not isinstance(body, dict) or set(body) - _BATCHABLE_KNN_KEYS:
            return None
        try:
            node = query_dsl.parse_query(body.get("query"))
        except Exception:  # noqa: BLE001 - the serial path reports it
            return None
        if not isinstance(node, query_dsl.KnnQuery) or node.filter is not None:
            return None
        nodes.append(node)
        fetch_k = max(fetch_k, int(body.get("from", 0))
                      + int(body.get("size", DEFAULT_SIZE)))
    first = nodes[0]
    if any(n.field != first.field or int(n.k) != int(first.k)
           for n in nodes[1:]):
        return None
    batched = distributed_serving.try_distributed_knn_batch(
        shards, acquired, nodes, fetch_k)
    if batched is None:
        return None
    return [[(shard, snap, res)
             for shard, snap, res in zip(shards, acquired, per_shard)]
            for per_shard in batched]


class _MultiMapperView:
    """Read-only MapperService facade over several indices' mappings."""

    def __init__(self, services: list):
        # dedupe while preserving order
        seen: set[int] = set()
        self.services = [
            s for s in services if not (id(s) in seen or seen.add(id(s)))
        ]

    def field_mapper(self, name: str):
        for s in self.services:
            m = s.field_mapper(name)
            if m is not None:
                return m
        return None

    @property
    def mappers(self) -> dict:
        merged: dict = {}
        for s in reversed(self.services):
            merged.update(s.mappers)
        return merged

    def analyze_query_text(self, field: str, text: str) -> list[str]:
        for s in self.services:
            if s.field_mapper(field) is not None:
                return s.analyze_query_text(field, text)
        if self.services:
            return self.services[0].analyze_query_text(field, text)
        return [text]


def _source_filter(spec: Any):
    if spec is False:
        return lambda src: None
    if spec is True or spec is None:
        return lambda src: src
    if isinstance(spec, str):
        spec = [spec]
    if isinstance(spec, list):
        includes, excludes = spec, []
    elif isinstance(spec, dict):
        includes = spec.get("includes") or spec.get("include") or []
        excludes = spec.get("excludes") or spec.get("exclude") or []
        if isinstance(includes, str):
            includes = [includes]
        if isinstance(excludes, str):
            excludes = [excludes]
    else:
        raise ParsingException(f"invalid _source spec [{spec!r}]")

    def apply(src: dict) -> dict:
        flat = _flatten(src)
        out: dict[str, Any] = {}
        for key, value in flat.items():
            if includes and not any(_match(key, p) for p in includes):
                continue
            if excludes and any(_match(key, p) for p in excludes):
                continue
            _put_nested(out, key, value)
        return out

    return apply


def _match(key: str, pattern: str) -> bool:
    # "user.*" matches nested keys; "user" matches the whole subtree
    return (
        fnmatch.fnmatch(key, pattern)
        or fnmatch.fnmatch(key, pattern + ".*")
        or key.startswith(pattern + ".")
    )


def _flatten(obj: dict, prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in obj.items():
        full = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, f"{full}."))
        else:
            out[full] = v
    return out


def _put_nested(out: dict, key: str, value: Any) -> None:
    parts = key.split(".")
    node = out
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value
