"""Coordinator-side reduce of per-node search partials.

The cluster analog of the reference's reduce pipeline
(action/search/SearchPhaseController.java:224 mergeTopDocs +
search/aggregations/InternalAggregations.java:162 reduce): each data node
runs search/service.search(partial=True) over its local shards and returns
a JSON partial — hits annotated with a [shard, segment, doc] tie-break
triple, aggregations decorated with `_p_*` reduce extras (sum+count for
avg, raw value lists for cardinality/percentiles, full counts for
rare_terms). This module merges those partials into the final response:
k-way hit merge with the OpenSearch tie-break (score desc / sort values,
then shard asc, segment asc, doc asc), type-directed aggregation reduce
driven by the REQUEST body (the coordinator knows every agg's type), then
pipeline aggregations once over the reduced tree.

Aggregation types whose final JSON is not losslessly mergeable and that
carry no partial decoration yet (composite, sampler, significant_terms,
scripted_metric, matrix_stats, auto_date_histogram, top_hits) raise a
clear unsupported error in cluster mode rather than returning wrong
numbers.
"""

from __future__ import annotations

import heapq
import math
from typing import Any

import numpy as np

from opensearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    ParsingException,
)

# agg types the cross-node reduce handles exactly
_BUCKET_MERGE = {
    "terms", "multi_terms", "histogram", "date_histogram", "range",
    "date_range", "filters", "adjacency_matrix",
}
_SINGLE_BUCKET = {"filter", "missing", "global"}
_PASSTHROUGH_METRICS = {"min", "max", "sum", "value_count", "stats",
                        "extended_stats"}
_DECORATED_METRICS = {"avg", "cardinality", "percentiles",
                      "percentile_ranks", "median_absolute_deviation",
                      "weighted_avg"}
_SPECIAL = {"rare_terms"}
UNSUPPORTED_CLUSTER_AGGS = {
    "composite", "sampler", "diversified_sampler", "significant_terms",
    "scripted_metric", "matrix_stats", "auto_date_histogram", "top_hits",
    "geo_distance", "nested", "reverse_nested",
}


def check_cluster_aggs_supported(aggs_body: dict | None) -> None:
    """Raise early (before any fan-out) for agg types the cross-node
    reduce cannot merge exactly."""
    if not aggs_body:
        return
    for name, body in aggs_body.items():
        for key, val in body.items():
            if key in ("aggs", "aggregations"):
                check_cluster_aggs_supported(val)
            elif key in UNSUPPORTED_CLUSTER_AGGS:
                raise IllegalArgumentException(
                    f"aggregation type [{key}] (in [{name}]) is not yet "
                    f"supported for cross-node reduce in cluster mode"
                )


def _agg_type_of(body: dict) -> tuple[str, dict, dict | None]:
    from opensearch_tpu_torch.search.aggs import AGG_TYPES, EXTENSION_AGGS

    sub = body.get("aggs") or body.get("aggregations")
    keys = [k for k in body if k in AGG_TYPES or k in EXTENSION_AGGS]
    if len(keys) != 1:
        raise ParsingException(
            f"aggregation must have exactly one known type, got {sorted(body)}"
        )
    return keys[0], body[keys[0]], sub


# --------------------------------------------------------------------- #
# hits
# --------------------------------------------------------------------- #


def reduce_hits(
    partials: list[dict],
    *,
    size: int,
    from_: int,
    sort: list | None,
    track_total: Any,
    collapse_field: str | None = None,
) -> dict:
    """Merge per-node hit lists. Each partial is a full search response
    whose hits carry `_tb` = [shard, segment, doc]. With `collapse_field`,
    per-node collapsed hits are re-collapsed across nodes (first-per-group
    survives both levels).

    Partials flagged `_premerged` (the shard-mesh launch already produced
    them in the canonical (-score, _tb) order — search/service.py) are
    k-way STREAM-merged with a heap instead of globally re-sorted: the
    launch did the per-node merge on device, so the coordinator only
    interleaves S sorted streams."""
    from opensearch_tpu_torch.search.service import _values_key

    streams: list[list[tuple[Any, dict]]] = []
    total = 0
    max_score = None
    all_premerged = bool(partials) and not sort
    for p in partials:
        h = p.get("hits") or {}
        t = h.get("total")
        if isinstance(t, dict):
            total += int(t.get("value", 0))
        ms = h.get("max_score")
        if ms is not None and (max_score is None or ms > max_score):
            max_score = ms
        if not p.get("_premerged"):
            all_premerged = False
        stream: list[tuple[Any, dict]] = []
        for hit in h.get("hits") or []:
            tb = tuple(hit.get("_tb") or [0, 0, 0])
            if sort:
                key = (_values_key(sort, hit.get("sort") or []), *tb)
            else:
                score = hit.get("_score") or 0.0
                key = (-score, *tb)
            stream.append((key, hit))
        streams.append(stream)
    if all_premerged:
        rows = list(heapq.merge(*streams, key=lambda r: r[0]))
    else:
        rows = [r for stream in streams for r in stream]
        rows.sort(key=lambda r: r[0])
    if collapse_field is not None:
        seen: set = set()
        deduped = []
        for key, hit in rows:
            value = (hit.get("fields") or {}).get(collapse_field, [None])[0]
            if value is not None:
                hv = tuple(value) if isinstance(value, list) else value
                if hv in seen:
                    continue
                seen.add(hv)
            deduped.append((key, hit))
        rows = deduped
    page = []
    for _key, hit in rows[from_: from_ + size]:
        hit = dict(hit)
        hit.pop("_tb", None)
        page.append(hit)

    hits_obj: dict[str, Any] = {
        "max_score": max_score if not sort else None,
        "hits": page,
    }
    if track_total is True:
        hits_obj["total"] = {"value": total, "relation": "eq"}
    elif track_total is not False:
        cap = int(track_total)
        hits_obj["total"] = (
            {"value": cap, "relation": "gte"} if total > cap
            else {"value": total, "relation": "eq"}
        )
    return hits_obj


# --------------------------------------------------------------------- #
# aggregations
# --------------------------------------------------------------------- #


def reduce_aggs(aggs_body: dict, partials: list[dict]) -> dict:
    """Reduce per-node aggregation partials (each the `aggregations` object
    of one node's partial response) into the final tree, then apply
    pipeline aggregations."""
    from opensearch_tpu_torch.search.aggs_pipeline import (
        PIPELINE_TYPES,
        apply_pipeline_aggs,
    )

    out: dict[str, Any] = {}
    for name, body in aggs_body.items():
        if any(k in PIPELINE_TYPES for k in body):
            continue
        parts = [p[name] for p in partials if name in p]
        out[name] = _reduce_one(body, parts)
    apply_pipeline_aggs(aggs_body, out)
    return out


def _reduce_one(body: dict, parts: list[dict]) -> dict:
    typ, conf, sub = _agg_type_of(body)
    if not parts:
        return _empty_result(typ, conf, sub)
    if typ in _PASSTHROUGH_METRICS:
        return _reduce_metric(typ, conf, parts)
    if typ in _DECORATED_METRICS:
        return _reduce_decorated(typ, conf, parts)
    if typ in _SINGLE_BUCKET:
        merged = {"doc_count": sum(int(p.get("doc_count", 0)) for p in parts)}
        if sub:
            merged.update(_reduce_sub(sub, parts))
        return merged
    if typ in _BUCKET_MERGE:
        return _reduce_buckets(typ, conf, sub, parts)
    if typ == "rare_terms":
        return _reduce_rare_terms(conf, sub, parts)
    raise IllegalArgumentException(
        f"aggregation type [{typ}] is not yet supported for cross-node "
        f"reduce in cluster mode"
    )


def _empty_result(typ: str, conf: dict, sub: dict | None) -> dict:
    """Canonical zero-doc shapes (what the single-node path returns over an
    empty mask) — used for reduce-side gap-filled buckets."""
    if typ in ("min", "max", "avg", "weighted_avg",
               "median_absolute_deviation", "cardinality"):
        return {"value": 0 if typ == "cardinality" else None}
    if typ == "sum":
        return {"value": 0.0}
    if typ == "value_count":
        return {"value": 0}
    if typ == "stats":
        return {"count": 0, "min": None, "max": None, "avg": None,
                "sum": 0.0}
    if typ in _BUCKET_MERGE or typ == "rare_terms":
        out: dict[str, Any] = {"buckets": []}
        if typ in ("terms", "multi_terms"):
            out = {"doc_count_error_upper_bound": 0,
                   "sum_other_doc_count": 0, "buckets": []}
        return out
    if typ in _SINGLE_BUCKET:
        merged: dict[str, Any] = {"doc_count": 0}
        if sub:
            merged.update(_reduce_sub(sub, []))
        return merged
    return {}


def _reduce_sub(sub: dict, bucket_parts: list[dict]) -> dict:
    """Reduce the sub-aggregations embedded in same-key buckets."""
    out: dict[str, Any] = {}
    from opensearch_tpu_torch.search.aggs_pipeline import PIPELINE_TYPES

    for name, body in sub.items():
        if any(k in PIPELINE_TYPES for k in body):
            continue
        parts = [b[name] for b in bucket_parts if name in b]
        out[name] = _reduce_one(body, parts)
    return out


def _reduce_metric(typ: str, conf: dict, parts: list[dict]) -> dict:
    if typ == "value_count":
        return {"value": sum(int(p.get("value", 0)) for p in parts)}
    if typ in ("min", "max"):
        vals = [p.get("value") for p in parts if p.get("value") is not None]
        if not vals:
            return {"value": None}
        return {"value": (min if typ == "min" else max)(vals)}
    if typ == "sum":
        return {"value": float(sum(p.get("value") or 0.0 for p in parts))}
    if typ == "stats":
        count = sum(int(p.get("count", 0)) for p in parts)
        if count == 0:
            return {"count": 0, "min": None, "max": None, "avg": None,
                    "sum": 0.0}
        mins = [p["min"] for p in parts if p.get("min") is not None]
        maxs = [p["max"] for p in parts if p.get("max") is not None]
        s = float(sum(p.get("sum") or 0.0 for p in parts))
        return {"count": count, "min": min(mins), "max": max(maxs),
                "avg": s / count, "sum": s}
    # extended_stats: recompute the variance family from merged moments
    count = sum(int(p.get("count", 0)) for p in parts)
    sigma = float(conf.get("sigma", 2.0))
    if count == 0:
        return next(p for p in parts)  # the canonical empty shape
    mins = [p["min"] for p in parts if p.get("min") is not None]
    maxs = [p["max"] for p in parts if p.get("max") is not None]
    s = float(sum(p.get("sum") or 0.0 for p in parts))
    sos = float(sum(p.get("sum_of_squares") or 0.0 for p in parts))
    avg = s / count
    var_pop = max(sos / count - avg * avg, 0.0)
    var_samp = var_pop * count / (count - 1) if count > 1 else float("nan")
    std_pop = math.sqrt(var_pop)
    std_samp = math.sqrt(var_samp) if count > 1 else float("nan")

    def _clean(x):
        return None if isinstance(x, float) and math.isnan(x) else x

    return {
        "count": count, "min": min(mins), "max": max(maxs), "avg": avg,
        "sum": s, "sum_of_squares": sos,
        "variance": var_pop, "variance_population": var_pop,
        "variance_sampling": _clean(var_samp),
        "std_deviation": std_pop, "std_deviation_population": std_pop,
        "std_deviation_sampling": _clean(std_samp),
        "std_deviation_bounds": {
            "upper": avg + sigma * std_pop,
            "lower": avg - sigma * std_pop,
            "upper_population": avg + sigma * std_pop,
            "lower_population": avg - sigma * std_pop,
            "upper_sampling": (
                _clean(avg + sigma * std_samp) if count > 1 else None
            ),
            "lower_sampling": (
                _clean(avg - sigma * std_samp) if count > 1 else None
            ),
        },
    }


def _reduce_decorated(typ: str, conf: dict, parts: list[dict]) -> dict:
    if typ == "avg":
        n = sum(int(p.get("_p_count", 0)) for p in parts)
        s = float(sum(p.get("_p_sum", 0.0) or 0.0 for p in parts))
        return {"value": s / n if n else None}
    if typ == "cardinality":
        seen: set = set()
        for p in parts:
            seen.update(tuple(v) if isinstance(v, list) else v
                        for v in p.get("_p_values", []))
        return {"value": len(seen)}
    if typ == "weighted_avg":
        num = float(sum(p.get("_p_num", 0.0) or 0.0 for p in parts))
        den = float(sum(p.get("_p_den", 0.0) or 0.0 for p in parts))
        return {"value": num / den if den else None}
    # value-shipping metrics: recompute over the concatenated values with
    # the exact same formulas the single-node path uses
    vals = np.asarray(
        [v for p in parts for v in p.get("_p_values", [])], np.float64
    )
    keyed = bool(conf.get("keyed", True))
    if typ == "percentiles":
        from opensearch_tpu_torch.search.aggs_ext import _DEFAULT_PERCENTS

        percents = [float(x) for x in conf.get("percents", _DEFAULT_PERCENTS)]
        if len(vals) == 0:
            results = [(p, None) for p in percents]
        else:
            qs = np.percentile(vals, percents)
            results = [(p, float(q)) for p, q in zip(percents, qs)]
        if keyed:
            return {"values": {str(float(p)): v for p, v in results}}
        return {"values": [{"key": p, "value": v} for p, v in results]}
    if typ == "percentile_ranks":
        targets = [float(x) for x in conf["values"]]
        n = len(vals)
        results = [
            (t, float((vals <= t).sum()) * 100.0 / n if n else None)
            for t in targets
        ]
        if keyed:
            return {"values": {f"{t}": r for t, r in results}}
        return {"values": [{"key": t, "value": r} for t, r in results]}
    # median_absolute_deviation
    if len(vals) == 0:
        return {"value": None}
    med = float(np.median(vals))
    return {"value": float(np.median(np.abs(vals - med)))}


def _bucket_key(typ: str, bucket: dict) -> Any:
    key = bucket.get("key")
    return tuple(key) if isinstance(key, list) else key


def _reduce_buckets(typ: str, conf: dict, sub: dict | None,
                    parts: list[dict]) -> dict:
    # keyed filters/range come back as {"buckets": {name: bucket}}
    keyed_out = all(isinstance(p.get("buckets"), dict) for p in parts)
    merged: dict[Any, list[dict]] = {}
    order_seen: list[Any] = []
    for p in parts:
        buckets = p.get("buckets")
        items = buckets.items() if isinstance(buckets, dict) else [
            (_bucket_key(typ, b), b) for b in (buckets or [])
        ]
        for key, b in items:
            if key not in merged:
                merged[key] = []
                order_seen.append(key)
            merged[key].append(b)

    out_buckets = []
    for key in order_seen:
        group = merged[key]
        nb: dict[str, Any] = {}
        # carry key fields from the first occurrence (key/key_as_string/
        # from/to for ranges)
        for field in ("key", "key_as_string", "from", "from_as_string",
                      "to", "to_as_string"):
            if field in group[0]:
                nb[field] = group[0][field]
        nb["doc_count"] = sum(int(b.get("doc_count", 0)) for b in group)
        if sub:
            nb.update(_reduce_sub(sub, group))
        out_buckets.append((key, nb))

    if typ in ("terms", "multi_terms"):
        size = int(conf.get("size", 10))
        order_conf = conf.get("order", {"_count": "desc"})
        out_buckets = _sort_term_buckets(out_buckets, order_conf)
        total_count = sum(b["doc_count"] for _, b in out_buckets)
        prior_other = sum(
            int(p.get("sum_other_doc_count", 0)) for p in parts
        )
        top = out_buckets[:size]
        other = prior_other + sum(
            b["doc_count"] for _, b in out_buckets[size:]
        )
        return {
            "doc_count_error_upper_bound": 0,
            "sum_other_doc_count": other,
            "buckets": [b for _, b in top],
        }
    if typ in ("histogram", "date_histogram"):
        out_buckets.sort(key=lambda kb: kb[0])
        out_buckets = _gap_fill_histogram(typ, conf, sub, out_buckets)
    if keyed_out:
        return {"buckets": {k: b for k, b in out_buckets}}
    return {"buckets": [b for _, b in out_buckets]}


def _gap_fill_histogram(typ: str, conf: dict, sub: dict | None,
                        out_buckets: list[tuple[Any, dict]]):
    """min_doc_count=0 must yield a CONTIGUOUS key range after the
    cross-node merge — each node only gap-fills its local [min, max]
    (InternalHistogram.addEmptyBuckets runs at reduce time in the
    reference, so this is exactly where it belongs)."""
    date = typ == "date_histogram"
    min_doc_count = int(conf.get("min_doc_count", 0 if date else 1))
    if min_doc_count != 0 or len(out_buckets) < 2:
        return out_buckets
    from opensearch_tpu_torch.search.aggs import _CALENDAR_UNITS, _calendar_next
    from opensearch_tpu_torch.common.settings import parse_time_millis

    if date:
        interval_conf = (
            conf.get("fixed_interval") or conf.get("calendar_interval")
            or conf.get("interval")
        )
        calendar = (str(interval_conf) in _CALENDAR_UNITS
                    or conf.get("calendar_interval") in _CALENDAR_UNITS)
        step = None if calendar else float(parse_time_millis(interval_conf))
    else:
        calendar = False
        step = float(conf["interval"])

    def next_key(k: float) -> float:
        if calendar:
            return _calendar_next(k, str(interval_conf))
        return k + step

    def fmt(k: float) -> dict:
        import datetime as _dt

        b: dict[str, Any] = {"key": int(k) if date else k, "doc_count": 0}
        if date:
            b["key_as_string"] = (
                _dt.datetime.fromtimestamp(k / 1000, _dt.timezone.utc)
                .isoformat().replace("+00:00", "Z")
            )
        if sub:
            b.update(_reduce_sub(sub, []))
        return b

    filled: list[tuple[Any, dict]] = []
    present = {k for k, _ in out_buckets}
    for i, (key, bucket) in enumerate(out_buckets):
        filled.append((key, bucket))
        if i + 1 < len(out_buckets):
            k = next_key(float(key))
            guard = 0
            while k < float(out_buckets[i + 1][0]) - 1e-9:
                if k not in present:
                    filled.append((k, fmt(k)))
                k = next_key(k)
                guard += 1
                if guard > 65_536:
                    break
    return filled


def _sort_term_buckets(out_buckets: list[tuple[Any, dict]],
                       order_conf: Any) -> list[tuple[Any, dict]]:
    from opensearch_tpu_torch.search.aggs import _KeyOrd

    if isinstance(order_conf, dict):
        order_specs = list(order_conf.items())
    elif isinstance(order_conf, list):
        order_specs = [next(iter(o.items())) for o in order_conf]
    else:
        raise ParsingException(f"invalid terms order [{order_conf!r}]")

    def path_value(bucket: dict, path: str) -> Any:
        name, _, prop = path.partition(".")
        result = bucket.get(name)
        if result is None:
            raise ParsingException(
                f"terms order references unknown agg [{path}]"
            )
        v = result.get(prop or "value")
        return v if v is not None else float("-inf")

    def sort_key(kb):
        key, bucket = kb
        parts = []
        for okey, odir in order_specs:
            desc = odir == "desc"
            if okey == "_count":
                parts.append(-bucket["doc_count"] if desc
                             else bucket["doc_count"])
            elif okey == "_key":
                parts.append(_KeyOrd(key, desc))
            else:
                v = path_value(bucket, okey)
                parts.append(-v if desc else v)
        parts.append(_KeyOrd(key, False))
        return tuple(parts)

    return sorted(out_buckets, key=sort_key)


def _reduce_rare_terms(conf: dict, sub: dict | None,
                       parts: list[dict]) -> dict:
    max_doc_count = int(conf.get("max_doc_count", 1))
    counts: dict[Any, int] = {}
    for p in parts:
        for key, c in p.get("_p_counts", []):
            k = tuple(key) if isinstance(key, list) else key
            counts[k] = counts.get(k, 0) + int(c)
    rare_keys = [(k, c) for k, c in counts.items() if c <= max_doc_count]
    rare_keys.sort(key=lambda kv: (kv[1], str(kv[0])))
    # collect the partial buckets (with sub-aggs) for surviving keys
    by_key: dict[Any, list[dict]] = {}
    for p in parts:
        for b in p.get("buckets", []):
            k = _bucket_key("rare_terms", b)
            by_key.setdefault(k, []).append(b)
    buckets = []
    for key, count in rare_keys:
        nb: dict[str, Any] = {"key": key, "doc_count": count}
        group = by_key.get(key, [])
        if sub and group:
            nb.update(_reduce_sub(sub, group))
        buckets.append(nb)
    return {"buckets": buckets}


# --------------------------------------------------------------------- #
# full response
# --------------------------------------------------------------------- #


def reduce_search_responses(
    body: dict,
    partials: list[dict],
    *,
    size: int,
    from_: int,
    track_total: Any,
) -> dict:
    """Merge per-node partial responses into the final SearchResponse."""
    sort = body.get("sort")
    if isinstance(sort, (str, dict)):
        sort = [sort]
    took = max((p.get("took", 0) for p in partials), default=0)
    shards_total = sum(
        (p.get("_shards") or {}).get("total", 0) for p in partials
    )
    shards_ok = sum(
        (p.get("_shards") or {}).get("successful", 0) for p in partials
    )
    out: dict[str, Any] = {
        "took": took,
        "timed_out": any(p.get("timed_out") for p in partials),
        "_shards": {
            "total": shards_total,
            "successful": shards_ok,
            "skipped": sum(
                (p.get("_shards") or {}).get("skipped", 0) for p in partials
            ),
            "failed": shards_total - shards_ok,
        },
        "hits": reduce_hits(
            partials, size=size, from_=from_, sort=sort,
            track_total=track_total,
            collapse_field=(body.get("collapse") or {}).get("field"),
        ),
    }
    aggs_body = body.get("aggs") or body.get("aggregations")
    if aggs_body:
        out["aggregations"] = reduce_aggs(
            aggs_body, [p.get("aggregations") or {} for p in partials]
        )
    if any("profile" in p for p in partials):
        out["profile"] = {"shards": [
            s for p in partials for s in (p.get("profile") or {}).get("shards", [])
        ]}
    return out
