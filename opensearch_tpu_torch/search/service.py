"""Search service: query phase -> merge -> fetch phase -> response.

Counterpart of opensearch_tpu/search/service.py, for the slice the port
serves so far: a top-level ``knn`` query, then the fetch of the winning
docs; and msearch's batching of bare kNN bodies (:func:`msearch_groups`,
:func:`try_batched_knn_msearch`: B bodies' query phase in one stacked
launch, handed to :func:`search` as ``precomputed_results``). The route is the reference's ``_try_distributed_query_phase``
choice: the stacked serving step (search/distributed_serving.
mesh_knn_batch) unless it is switched off or declines (an ANN-indexed
column); then the per-shard route (search/executor.execute_query_phase per
shard, which serves IVF-PQ, and whose launches go through the dispatch
batcher) and the host merge by (-score, shard, segment, doc). A request
key the reference does not know is a ParsingException (400), as there;
every other query or request key raises "not yet ported".

The response has the reference's shape: ``hits.total``, ``max_score`` and
per hit ``_index``, ``_id``, ``_score`` and ``_source``.
"""

from __future__ import annotations

import fnmatch
import json
import time
from typing import Any

from opensearch_tpu_torch.common.errors import ParsingException
from opensearch_tpu_torch.search import distributed_serving, query_dsl
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
# request keys this slice serves
SUPPORTED_KEYS = {"query", "size", "from", "_source", "track_total_hits"}


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
    size = int(body.get("size", DEFAULT_SIZE))
    from_ = int(body.get("from", 0))
    if size < 0 or from_ < 0:
        raise ParsingException("[size] and [from] must be >= 0")
    track_total = body.get("track_total_hits", True)
    fetch_k = from_ + size

    merged: list = []
    total = 0
    max_score = None
    results = None
    out = None
    if precomputed_results is not None:
        snaps = [snap for _shard, snap, _res in precomputed_results]
        results = [res for _shard, _snap, res in precomputed_results]
    else:
        snaps = [s.acquire_searcher() for s in shards]
        out = _try_distributed_query_phase(shards, snaps, node, fetch_k)
    if out is not None:
        merged, results = out.premerged[0], out.per_query[0]
    elif shards:
        if results is None:
            # the per-shard route. can_match is not ported: for a knn query
            # the reference's pre-filter always matches (search/phases.py:68)
            results = [
                execute_query_phase(snap, shard.mapper_service, node,
                                    size=fetch_k)
                for shard, snap in zip(shards, snaps)
            ]
        # the host merge, the device merge's order: (-score, shard,
        # segment, doc)
        merged = [(shard_idx, h) for shard_idx, result in enumerate(results)
                  for h in result.hits]
        merged.sort(key=lambda sh: (-sh[1].score, sh[0], sh[1].segment,
                                    sh[1].doc))
    for result in results or ():
        total += result.total
        if result.max_score is not None and (
                max_score is None or result.max_score > max_score):
            max_score = result.max_score
    page = merged[from_: from_ + size]

    source_filter = _source_filter(body.get("_source", True))
    hits_json = []
    for shard_idx, h in page:
        shard, snapshot = shards[shard_idx], snaps[shard_idx]
        host = snapshot.segments[h.segment][0]
        hit: dict[str, Any] = {
            "_index": shard.shard_id.index,
            "_id": host.doc_ids[h.doc],
            "_score": h.score,
        }
        doc_routing = host.doc_routings[h.doc] if host.doc_routings else None
        if doc_routing is not None:
            hit["_routing"] = doc_routing
        src = source_filter(json.loads(host.sources[h.doc]))
        if src is not None:
            hit["_source"] = src
        hits_json.append(hit)

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
    return {
        "took": int((time.monotonic() - t0) * 1000),
        "timed_out": False,
        "_shards": {"total": len(shards), "successful": len(shards),
                    "skipped": 0, "failed": 0},
        "hits": hits_obj,
    }


def _try_distributed_query_phase(shards: list, snaps: list, node,
                                 fetch_k: int):
    """The stacked serving step's launch outcome for this query, or None
    when the per-shard route must answer it: no shards, the step switched
    off (``distributed_serving.enabled``), or the step declining the shard
    set (``distributed_serving._can_serve``: among others, an unfiltered
    query on an ANN-indexed column)."""
    if not shards or not distributed_serving.enabled:
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
