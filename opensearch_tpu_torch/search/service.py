"""Search service: query phase -> merge -> fetch phase -> response.

Counterpart of opensearch_tpu/search/service.py, for the slice the port
serves so far: a top-level ``knn`` query, then the fetch of the winning
docs. The route is the reference's ``_try_distributed_query_phase``
choice: the stacked serving step (search/distributed_serving.
mesh_knn_batch) unless it is switched off or declines (an ANN-indexed
column); then the per-shard route (search/executor.execute_query_phase per
shard, which serves IVF-PQ) and the host merge by
(-score, shard, segment, doc). Launches are solo (no batcher), as in the
reference with ``search.knn.batch.enabled=false``. Every other query or
request key raises "not yet ported".

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
# request keys this slice serves
SUPPORTED_KEYS = {"query", "size", "from", "_source", "track_total_hits"}


def search(shards: list, body: dict | None) -> dict[str, Any]:
    """Run one knn search over `shards` (IndexShard objects)."""
    t0 = time.monotonic()
    body = body or {}
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
    snaps = [s.acquire_searcher() for s in shards]
    results = None
    out = _try_distributed_query_phase(shards, snaps, node, fetch_k)
    if out is not None:
        merged, results = out.premerged[0], out.per_query[0]
    elif shards:
        # the per-shard route. can_match is not ported: for a knn query the
        # reference's pre-filter always matches (search/phases.py:68)
        results = [
            execute_query_phase(snap, shard.mapper_service, node, size=fetch_k)
            for shard, snap in zip(shards, snaps)
        ]
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
