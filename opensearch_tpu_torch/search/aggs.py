"""Aggregations: per-segment partials + reduce.

The analog of the reference's two-tier aggregation compute
(search/aggregations/: per-shard Aggregator collectors produce
InternalAggregation partials; InternalAggregations.reduce:162 merges them on
the coordinator). Here: per-segment numpy partials over exact host columns
(int64/float64 — no float32 truncation of dates/longs), restricted by the
query-phase match masks, merged shard-side; the same merge functions serve
the cross-shard reduce in the coordinator layer.

Implemented: terms (keyword/numeric/boolean), min, max, sum, avg,
value_count, stats, cardinality (exact), histogram, date_histogram
(fixed + calendar month/quarter/year), range, filter, filters, missing,
global — all with arbitrarily nested sub-aggregations.

Device offload note: the masks arrive from the device query phase; the
bucket/metric math here is host numpy for exactness. The hot aggregations
(terms on keyword ords = bincount, stats = masked reductions) have direct
device formulations planned in ops/ for the large-corpus path.
"""

from __future__ import annotations

import datetime as _dt
import logging
import time
from typing import Any, Callable

import numpy as np

from opensearch_tpu_torch.common.errors import IllegalArgumentException, ParsingException
from opensearch_tpu_torch.index.mapper import MapperService, parse_date_millis
from opensearch_tpu_torch.index.segment import HostSegment
from opensearch_tpu_torch.common.settings import parse_time_millis

logger = logging.getLogger(__name__)

AGG_TYPES = {
    "terms", "min", "max", "sum", "avg", "value_count", "stats", "cardinality",
    "histogram", "date_histogram", "range", "filter", "filters", "missing", "global",
    "nested", "reverse_nested",
}

# extension registry populated by aggs_ext (extended metric/bucket families);
# fn(conf, sub, segments, ms, masks, filter_fn, ext)
EXTENSION_AGGS: dict[str, Callable] = {}

# the reference's search.max_buckets MultiBucketConsumerService limit
MAX_BUCKETS = 65_536

# cross-node exact-merge cap for value-shipping partials (cardinality,
# percentiles) — beyond this the wire cost of exactness is unreasonable and
# a sketch (HLL++/TDigest) is the right tool
MAX_PARTIAL_VALUES = 100_000


class TooManyBucketsException(IllegalArgumentException):
    error_type = "too_many_buckets_exception"

    def __init__(self, limit: int):
        super().__init__(
            f"Trying to create too many buckets. Must be less than or equal "
            f"to: [{limit}]."
        )

# executor callback: (query_node_body, segment_index) -> bool mask [n_docs]
FilterFn = Callable[[dict, int], np.ndarray]


def compute_aggs(
    segments: list[HostSegment],
    mapper_service: MapperService,
    aggs_body: dict,
    masks: list[np.ndarray],
    filter_fn: FilterFn | None = None,
    ext: dict | None = None,
) -> dict:
    from opensearch_tpu_torch.search.aggs_pipeline import PIPELINE_TYPES
    from opensearch_tpu_torch.search import profile as search_profile

    prof = search_profile.active()
    out = {}
    for name, body in aggs_body.items():
        # pipeline aggs run at final reduce (aggs_pipeline.apply_pipeline_aggs),
        # mirroring the reference where they reduce coordinator-side
        if any(k in PIPELINE_TYPES for k in body):
            continue
        t0 = time.perf_counter_ns() if prof is not None else 0
        out[name] = _compute_one(
            name, body, segments, mapper_service, masks, filter_fn, ext
        )
        if prof is not None:
            # real per-aggregation collector wall time for the profile
            # response (replaces the emulated constants)
            prof.record_agg(name, time.perf_counter_ns() - t0)
    return out


def _split_body(body: dict) -> tuple[str, dict, dict | None]:
    sub = body.get("aggs") or body.get("aggregations")
    agg_keys = [k for k in body if k in AGG_TYPES or k in EXTENSION_AGGS]
    if len(agg_keys) != 1:
        raise ParsingException(
            f"aggregation must have exactly one known type, got {sorted(body)}"
        )
    return agg_keys[0], body[agg_keys[0]], sub


def _column(seg: HostSegment, field: str, ms: MapperService | None):
    """(values, present) for a numeric column. unsigned_long is STORED
    biased by -2^63 so the int64 column keeps 64-bit order (mapper.py);
    every aggregation read must unbias back to uint64 here — raw biased
    values surface as huge negatives (the r4 full-suite sweep's largest
    failure cluster)."""
    nf = seg.numeric_fields.get(field)
    if nf is None:
        return None, None
    vals = nf.values_i64 if nf.kind == "int" else nf.values_f64
    if nf.kind == "int" and ms is not None:
        mapper = ms.field_mapper(field) if hasattr(ms, "field_mapper") else None
        if getattr(mapper, "original_type", None) == "unsigned_long":
            vals = vals.view(np.uint64) + np.uint64(1 << 63)
    return vals, nf.present


def _field_values(
    seg: HostSegment, field: str, mask: np.ndarray, mapper_service: MapperService
) -> np.ndarray:
    """Masked exact values of a numeric-ish field (int64/float64/uint64)."""
    vals, present = _column(seg, field, mapper_service)
    if vals is not None:
        return vals[mask & present]
    return np.zeros(0)


def _compute_one(
    name: str,
    body: dict,
    segments: list[HostSegment],
    ms: MapperService,
    masks: list[np.ndarray],
    filter_fn: FilterFn | None,
    ext: dict | None = None,
) -> dict:
    typ, conf, sub = _split_body(body)
    # parameter-validation errors quote the aggregation name
    ext = dict(ext) if ext else {}
    ext["agg_name"] = name
    out = _dispatch_one(typ, conf, sub, segments, ms, masks, filter_fn, ext)
    # meta echoes back verbatim on every aggregation response
    # (InternalAggregation.getMetadata)
    meta = body.get("meta")
    if meta is not None and isinstance(out, dict):
        out["meta"] = meta
    return out


def _dispatch_one(
    typ: str,
    conf: dict,
    sub: dict | None,
    segments: list[HostSegment],
    ms: MapperService,
    masks: list[np.ndarray],
    filter_fn: FilterFn | None,
    ext: dict | None = None,
) -> dict:
    if typ in ("min", "max", "sum", "avg", "value_count", "stats"):
        return _metric(typ, conf, segments, ms, masks, ext)
    if typ == "cardinality":
        return _cardinality(conf, segments, ms, masks, ext)
    if typ == "terms":
        return _terms(conf, sub, segments, ms, masks, filter_fn, ext)
    if typ == "histogram":
        return _histogram(conf, sub, segments, ms, masks, filter_fn, ext, date=False)
    if typ == "date_histogram":
        return _histogram(conf, sub, segments, ms, masks, filter_fn, ext, date=True)
    if typ == "range":
        return _range_agg(conf, sub, segments, ms, masks, filter_fn, ext)
    if typ == "filter":
        return _filter_agg(conf, sub, segments, ms, masks, filter_fn, ext)
    if typ == "filters":
        return _filters_agg(conf, sub, segments, ms, masks, filter_fn, ext)
    if typ == "missing":
        return _missing_agg(conf, sub, segments, ms, masks, filter_fn, ext)
    if typ == "nested":
        return _nested_agg(conf, sub, segments, ms, masks, filter_fn, ext)
    if typ == "reverse_nested":
        return _reverse_nested_agg(conf, sub, segments, ms, masks,
                                   filter_fn, ext)
    if typ == "global":
        g_masks = [s.live.copy() for s in segments]
        out = {"doc_count": int(sum(m.sum() for m in g_masks))}
        if sub:
            out.update(compute_aggs(segments, ms, sub, g_masks, filter_fn, ext))
        return out
    fn = EXTENSION_AGGS.get(typ)
    if fn is not None:
        return fn(conf, sub, segments, ms, masks, filter_fn, ext or {})
    raise ParsingException(f"unknown aggregation type [{typ}]")


def _sub_aggs(
    sub: dict | None,
    segments: list[HostSegment],
    ms: MapperService,
    bucket_masks: list[np.ndarray],
    filter_fn: FilterFn | None,
    ext: dict | None = None,
) -> dict:
    if not sub:
        return {}
    return compute_aggs(segments, ms, sub, bucket_masks, filter_fn, ext)


# -- metrics ----------------------------------------------------------------


def _metric(typ, conf, segments, ms, masks, ext=None) -> dict:
    field = conf.get("field")
    if field is None:
        raise IllegalArgumentException(
            f"Required one of fields [field, script], but none were "
            f"specified. [{(ext or {}).get('agg_name', typ)}]")
    chunks = [
        _field_values(seg, field, masks[i], ms) for i, seg in enumerate(segments)
    ]
    vals = np.concatenate(chunks) if chunks else np.zeros(0)
    mapper = ms.field_mapper(field)
    is_date = mapper is not None and mapper.type == "date"
    # numeric-only metric aggs over non-numeric columns 400 in the
    # reference (ValuesSourceConfig type resolution); value_count counts
    # values of ANY type
    if typ != "value_count" and mapper is not None and \
            mapper.type in ("text", "keyword") and \
            not any(seg.numeric_fields.get(field) is not None
                    for seg in segments):
        raise IllegalArgumentException(
            f"Field [{field}] of type [{mapper.original_type or mapper.type}]"
            f" is not supported for aggregation [{typ}]"
        )
    if typ == "value_count" and mapper is not None and \
            mapper.type in ("text", "keyword"):
        count = 0
        for i, seg in enumerate(segments):
            kf = seg.keyword_fields.get(field)
            if kf is not None:
                count += int(masks[i][kf.mv_docs].sum())
                continue
            tf = seg.text_fields.get(field)
            if tf is not None:
                pres = getattr(tf, "present", None)
                if pres is not None:
                    count += int((masks[i] & pres).sum())
        return {"value": count}
    # `missing` substitutes a value for every in-bucket doc without one
    # (ValuesSourceConfig.missing)
    missing_val = conf.get("missing")
    if missing_val is not None:
        n_miss = 0
        for i, seg in enumerate(segments):
            nf = seg.numeric_fields.get(field)
            pres = nf.present if nf is not None \
                else np.zeros(seg.n_docs, bool)
            n_miss += int((masks[i] & ~pres).sum())
        if n_miss:
            if is_date and isinstance(missing_val, str):
                mv = float(parse_date_millis(missing_val))
            else:
                mv = float(missing_val)
            vals = np.concatenate(
                [vals.astype(np.float64), np.full(n_miss, mv)])
    n = len(vals)
    # cross-node partial mode (InternalAvg carries sum+count on the wire;
    # the coordinator reduce divides — search/reduce.py strips the key)
    partial = bool(ext and ext.get("partial"))

    def fmt(v):
        if v is None:
            return None
        return float(v)

    if typ == "value_count":
        return {"value": n}
    if n == 0:
        if typ == "stats":
            return {"count": 0, "min": None, "max": None, "avg": None, "sum": 0.0}
        out = {"value": None if typ != "sum" else 0.0}
        if typ == "avg" and partial:
            out["_p_count"] = 0
            out["_p_sum"] = 0.0
        return out
    s = float(vals.sum(dtype=np.float64))
    if typ == "min":
        return {"value": fmt(vals.min())}
    if typ == "max":
        return {"value": fmt(vals.max())}
    if typ == "sum":
        return {"value": s}
    if typ == "avg":
        out = {"value": s / n}
        if partial:
            out["_p_count"] = n
            out["_p_sum"] = s
        return out
    return {
        "count": n,
        "min": fmt(vals.min()),
        "max": fmt(vals.max()),
        "avg": s / n,
        "sum": s,
    }


def _cardinality(conf, segments, ms, masks, ext=None) -> dict:
    field = conf["field"]
    pt = conf.get("precision_threshold")
    if pt is not None and int(pt) < 0:
        name = (ext or {}).get("agg_name", "cardinality")
        raise IllegalArgumentException(
            f"[precisionThreshold] must be greater than or equal to 0. "
            f"Found [{int(pt)}] in [{name}]")
    # exact distinct count (the reference uses HLL++ with precision_threshold;
    # HLL sketch merge is the planned device path for large corpora)
    seen: set = set()
    missing_val = conf.get("missing")
    for i, seg in enumerate(segments):
        kf = seg.keyword_fields.get(field)
        if kf is not None:
            m = masks[i]
            entry_mask = m[kf.mv_docs]
            for o in np.unique(kf.mv_ords[entry_mask]):
                seen.add(kf.ord_values[int(o)])
            if missing_val is not None and bool(
                    (m & ~(kf.first_ord >= 0)).any()):
                seen.add(missing_val)
            continue
        vals = _field_values(seg, field, masks[i], ms)
        seen.update(vals.tolist())
        if missing_val is not None:
            nf = seg.numeric_fields.get(field)
            pres = nf.present if nf is not None \
                else np.zeros(seg.n_docs, bool)
            if bool((masks[i] & ~pres).any()):
                seen.add(missing_val)
    out: dict[str, Any] = {"value": len(seen)}
    if ext and ext.get("partial"):
        # wire partial: the distinct-value set itself (exact; the reference
        # ships HLL++ sketches — sketch merge is the large-corpus path)
        if len(seen) > MAX_PARTIAL_VALUES:
            raise IllegalArgumentException(
                f"cardinality over [{len(seen)}] distinct values exceeds the "
                f"cross-node exact-merge cap [{MAX_PARTIAL_VALUES}]"
            )
        out["_p_values"] = sorted(seen, key=lambda v: (str(type(v)), v))
    return out


# -- terms ------------------------------------------------------------------


def _terms(conf, sub, segments, ms, masks, filter_fn, ext=None) -> dict:
    field = conf["field"]
    size = int(conf.get("size", 10))
    min_doc_count = int(conf.get("min_doc_count", 1))
    if ext and ext.get("partial"):
        # per-node over-fetch so the coordinator cut is accurate — the
        # reference's shard_size default (size * 1.5 + 10)
        size = int(conf.get("shard_size", size + (size >> 1) + 10))
    # merge per-segment counts keyed by value
    counts: dict[Any, int] = {}
    is_keyword = any(field in seg.keyword_fields for seg in segments)
    for i, seg in enumerate(segments):
        kf = seg.keyword_fields.get(field)
        if kf is not None:
            entry_mask = masks[i][kf.mv_docs]
            seg_counts = np.bincount(
                kf.mv_ords[entry_mask], minlength=len(kf.ord_values)
            )
            for o in np.nonzero(seg_counts)[0]:
                key = kf.ord_values[int(o)]
                counts[key] = counts.get(key, 0) + int(seg_counts[o])
        else:
            vals = _field_values(seg, field, masks[i], ms)
            uniq, c = np.unique(vals, return_counts=True)
            for v, n in zip(uniq.tolist(), c.tolist()):
                counts[v] = counts.get(v, 0) + n

    mapper = ms.field_mapper(field)
    vt = conf.get("value_type")
    is_bool = (mapper is not None and mapper.type == "boolean") \
        or vt == "boolean"
    is_date = (mapper is not None and mapper.type == "date") or vt == "date"

    # `missing`: docs in the bucket without a value count under the
    # substitute key (also the whole story for unmapped fields, where
    # `value_type` declares the key's rendering); the per-segment missing
    # masks stick around so the bucket's sub-aggs run over those docs
    missing_conf = conf.get("missing")
    missing_key = None
    missing_masks: list[np.ndarray] | None = None
    if missing_conf is not None:
        missing_masks = []
        for i, seg in enumerate(segments):
            kf = seg.keyword_fields.get(field)
            nf = seg.numeric_fields.get(field)
            if kf is not None:
                present = np.zeros(seg.n_docs, bool)
                present[kf.mv_docs] = True
            elif nf is not None:
                present = nf.present[:seg.n_docs]
            else:
                present = np.zeros(seg.n_docs, bool)
            missing_masks.append(masks[i] & ~present)
        n_missing = int(sum(m.sum() for m in missing_masks))
        if n_missing:
            key = missing_conf
            if is_bool or isinstance(key, bool):
                key = 1.0 if key in (True, "true", 1) else 0.0
            elif is_date and isinstance(key, str):
                key = float(parse_date_millis(key))
            elif isinstance(key, (int, float)):
                key = float(key)
            missing_key = key
            counts[key] = counts.get(key, 0) + n_missing

    # include/exclude: exact lists, regex strings, or the partition form
    # (IncludeExclude; partitions hash the term like the reference so a
    # term lands in exactly one partition)

    def _match_key(k) -> str:
        # date terms include/exclude by formatted value; compare in ms;
        # integral doubles canonicalize like the partition hash does
        if is_date and not isinstance(k, str):
            return str(int(k))
        if isinstance(k, float) and k.is_integer():
            return str(int(k))
        return str(k)

    def _spec_values(vals) -> set:
        if is_date:
            return {str(parse_date_millis(v)) for v in vals}
        return {str(v) for v in vals}

    include = conf.get("include")
    exclude = conf.get("exclude")
    if isinstance(include, dict):
        num = int(include.get("num_partitions", 1))
        part = int(include.get("partition", 0))
        from opensearch_tpu_torch.common.hashing import murmur3_x86_32

        def _pkey(k) -> str:
            # numeric terms hash their canonical long/double string form
            if isinstance(k, float) and k.is_integer():
                return str(int(k))
            return str(k)

        # seed 31 = IncludeExclude.HASH_PARTITIONING_SEED; floorMod over
        # the SIGNED 32-bit hash, matching the reference exactly
        def _part(k) -> int:
            h = murmur3_x86_32(_pkey(k).encode(), seed=31)
            if h >= 1 << 31:
                h -= 1 << 32
            return h % num

        counts = {k: c for k, c in counts.items() if _part(k) == part}
    elif isinstance(include, list):
        want = _spec_values(include)
        counts = {k: c for k, c in counts.items() if _match_key(k) in want}
    elif isinstance(include, str):
        import re as _re

        rx = _re.compile(include)
        counts = {k: c for k, c in counts.items()
                  if rx.fullmatch(str(k))}
    if isinstance(exclude, list):
        drop = _spec_values(exclude)
        counts = {k: c for k, c in counts.items()
                  if _match_key(k) not in drop}
    elif isinstance(exclude, str):
        import re as _re

        rx = _re.compile(exclude)
        counts = {k: c for k, c in counts.items()
                  if not rx.fullmatch(str(k))}
    if min_doc_count > 0:
        counts = {k: c for k, c in counts.items() if c >= min_doc_count}
    # order: {"_count": "desc"} | {"_key": "asc"} | {"<sub-agg-path>": dir},
    # or a list of such single-entry dicts (multi-criteria)
    order_conf = conf.get("order", {"_count": "desc"})
    if isinstance(order_conf, dict):
        order_specs = list(order_conf.items())
    elif isinstance(order_conf, list):
        order_specs = [next(iter(o.items())) for o in order_conf]
    else:
        raise ParsingException(f"invalid terms order [{order_conf!r}]")
    needs_sub_order = any(k not in ("_count", "_key") for k, _ in order_specs)

    def _bucket_masks_for(key) -> list[np.ndarray]:
        bm = _value_masks(segments, field, key, masks, ms)
        if missing_key is not None and key == missing_key:
            # the missing bucket's sub-aggs cover the value-less docs too
            bm = [b | mm for b, mm in zip(bm, missing_masks)]
        return bm

    # compute sub-aggs per bucket up-front when ordering needs them (or
    # lazily after the cut otherwise)
    sub_results: dict[Any, dict] = {}
    if sub and needs_sub_order:
        for key in counts:
            sub_results[key] = _sub_aggs(
                sub, segments, ms, _bucket_masks_for(key), filter_fn, ext)

    def _agg_path_value(key: Any, path: str) -> Any:
        name, _, prop = path.partition(".")
        result = sub_results.get(key, {}).get(name)
        if result is None:
            raise ParsingException(f"terms order references unknown agg [{path}]")
        v = result.get(prop or "value")
        return v if v is not None else float("-inf")

    def sort_key(kv):
        key, count = kv
        parts = []
        for okey, odir in order_specs:
            desc = odir == "desc"
            if okey == "_count":
                parts.append(-count if desc else count)
            elif okey == "_key":
                parts.append(_KeyOrd(key, desc))
            else:
                v = _agg_path_value(key, okey)
                parts.append(-v if desc else v)
        parts.append(_KeyOrd(key, False))  # stable tiebreak: key asc
        return tuple(parts)

    items = sorted(counts.items(), key=sort_key)
    top = items[:size]
    other = sum(c for _, c in items[size:])

    buckets = []
    for key, count in top:
        bucket: dict[str, Any] = {}
        if is_bool:
            bucket["key"] = int(key)
            bucket["key_as_string"] = "true" if key else "false"
        elif is_date and not isinstance(key, str):
            bucket["key"] = int(key)
            bucket["key_as_string"] = _iso_ms(int(key))
        elif isinstance(key, str):
            bucket["key"] = key
        else:
            bucket["key"] = int(key) if float(key).is_integer() and not is_keyword else key
        bucket["doc_count"] = count
        if sub:
            if key in sub_results:
                bucket.update(sub_results[key])
            else:
                bucket.update(_sub_aggs(
                    sub, segments, ms, _bucket_masks_for(key), filter_fn,
                    ext))
        buckets.append(bucket)
    return {
        "doc_count_error_upper_bound": 0,
        "sum_other_doc_count": other,
        "buckets": buckets,
    }


def _iso_ms(ms_val: int) -> str:
    """Epoch ms -> "2016-05-03T00:00:00.000Z" (the date formatter the
    reference renders bucket key_as_string with)."""
    import datetime as _dt

    kdt = _dt.datetime.fromtimestamp(ms_val / 1000, _dt.timezone.utc)
    return kdt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{ms_val % 1000:03d}Z"


class _KeyOrd:
    """Orderable wrapper for bucket keys (str or numeric) with direction."""

    __slots__ = ("v", "desc")

    def __init__(self, v, desc: bool):
        self.v = v
        self.desc = desc

    def __lt__(self, other: "_KeyOrd") -> bool:
        return (self.v > other.v) if self.desc else (self.v < other.v)

    def __eq__(self, other) -> bool:
        return isinstance(other, _KeyOrd) and self.v == other.v


def _value_masks(segments, field, key, masks,
                 ms=None) -> list[np.ndarray]:
    out = []
    for i, seg in enumerate(segments):
        kf = seg.keyword_fields.get(field)
        if kf is not None:
            o = kf.ord_dict.get(key if isinstance(key, str) else str(key))
            m = np.zeros(seg.n_docs, bool)
            if o is not None:
                hit_docs = kf.mv_docs[kf.mv_ords == o]
                m[hit_docs] = True
            out.append(masks[i] & m)
            continue
        vals, present = _column(seg, field, ms)
        if vals is not None:
            out.append(masks[i] & present & (vals == key))
        else:
            out.append(np.zeros(seg.n_docs, bool))
    return out


# -- histogram --------------------------------------------------------------

_CALENDAR_UNITS = {"month", "1M", "quarter", "1q", "year", "1y",
                   "week", "1w"}
# calendar word units with fixed duration: translate to fixed-interval form
_CALENDAR_FIXED = {"second": "1s", "minute": "1m", "hour": "1h", "day": "1d"}


def _histogram(conf, sub, segments, ms, masks, filter_fn, ext=None, date: bool = False) -> dict:
    field = conf["field"]
    if date:
        interval_conf = (
            conf.get("fixed_interval") or conf.get("calendar_interval")
            or conf.get("interval")
        )
        if interval_conf is None:
            raise ParsingException("date_histogram requires an interval")
        # calendar word units of fixed duration ("day", "hour", ...)
        # translate to the fixed-interval form
        interval_conf = _CALENDAR_FIXED.get(str(interval_conf),
                                            interval_conf)
        calendar = str(interval_conf) in _CALENDAR_UNITS or conf.get("calendar_interval") in _CALENDAR_UNITS
    else:
        interval_conf = conf["interval"]
        calendar = False
    raw_offset = conf.get("offset", 0)
    # date offsets come as duration strings ("6h", "-1d"); numeric histograms
    # take plain numbers
    offset = float(parse_time_millis(raw_offset)) if date else float(raw_offset)
    min_doc_count = int(conf.get("min_doc_count", 1 if not date else 0))
    interval = None
    if not calendar:
        interval = parse_time_millis(interval_conf) if date else float(interval_conf)

    hard = conf.get("hard_bounds") or None
    if hard is not None and date:
        hard = {k: parse_date_millis(v) for k, v in hard.items()}

    # RANGE-typed fields: each doc's [lo, hi] interval counts in EVERY
    # bucket it intersects (RangeHistogramAggregator); hard_bounds clamps
    # the enumerated span
    field_mapper = ms.field_mapper(field) if hasattr(ms, "field_mapper") \
        else None
    from opensearch_tpu_torch.index.mapper import RANGE_TYPES as _RT

    if field_mapper is not None and field_mapper.type in _RT:
        return _histogram_over_ranges(
            conf, sub, segments, ms, masks, filter_fn, ext,
            field=field, date=date, calendar=calendar,
            interval_conf=interval_conf, interval=interval, offset=offset,
            hard=hard)

    # collect (key -> count) and per-key masks lazily for sub-aggs
    key_counts: dict[float, int] = {}
    per_seg_keys: list[np.ndarray] = []   # bucket key per masked doc
    per_seg_docs: list[np.ndarray] = []
    for i, seg in enumerate(segments):
        col, present = _column(seg, field, ms)
        if col is None:
            per_seg_keys.append(np.zeros(0))
            per_seg_docs.append(np.zeros(0, np.int64))
            continue
        m = masks[i] & present
        docs = np.nonzero(m)[0]
        vals = col[docs]
        if date:
            mapper = ms.field_mapper(field) if hasattr(ms, "field_mapper") else None
            if mapper is not None and \
                    getattr(mapper, "resolution", "millis") == "nanos":
                # bucket date_nanos in MILLIS space like the reference
                # (nanos keys would explode the bucket count)
                vals = vals // 1_000_000
        if calendar:
            keys = _calendar_keys(vals, str(interval_conf))
        else:
            keys = np.floor((vals.astype(np.float64) - offset) / interval) * interval + offset
        per_seg_keys.append(keys)
        per_seg_docs.append(docs)
        uniq, c = np.unique(keys, return_counts=True)
        for k_, n_ in zip(uniq.tolist(), c.tolist()):
            key_counts[k_] = key_counts.get(k_, 0) + n_

    # empty-bucket fill: min_doc_count=0 emits every bucket between the
    # observed (or extended_bounds) min and max key, like the reference's
    # InternalHistogram.addEmptyBuckets at reduce time
    if min_doc_count == 0:
        eb = conf.get("extended_bounds") or {}
        eb_min = eb.get("min")
        eb_max = eb.get("max")
        if date:
            eb_min = parse_date_millis(eb_min) if eb_min is not None else None
            eb_max = parse_date_millis(eb_max) if eb_max is not None else None

        def _floor_key(v: float) -> float:
            if calendar:
                return float(_calendar_keys(np.asarray([v]), str(interval_conf))[0])
            return float(np.floor((v - offset) / interval) * interval + offset)

        lo = min(key_counts) if key_counts else None
        hi = max(key_counts) if key_counts else None
        if eb_min is not None:
            lo = _floor_key(eb_min) if lo is None else min(lo, _floor_key(eb_min))
        if eb_max is not None:
            hi = _floor_key(eb_max) if hi is None else max(hi, _floor_key(eb_max))
        if lo is not None and hi is not None:
            if calendar:
                unit = str(interval_conf)
                k = lo
                n_fill = 0
                while k <= hi:
                    key_counts.setdefault(k, 0)
                    k = _calendar_next(k, unit)
                    n_fill += 1
                    if n_fill > MAX_BUCKETS:
                        raise TooManyBucketsException(MAX_BUCKETS)
            else:
                # integer bucket ordinals so fill keys are bit-identical to
                # the floor-computed doc keys (no arange accumulation drift)
                n0 = int(round((lo - offset) / interval))
                n1 = int(round((hi - offset) / interval))
                if n1 - n0 + 1 > MAX_BUCKETS:
                    raise TooManyBucketsException(MAX_BUCKETS)
                for k in (np.arange(n0, n1 + 1) * interval + offset).tolist():
                    key_counts.setdefault(k, 0)
    if len(key_counts) > MAX_BUCKETS:
        raise TooManyBucketsException(MAX_BUCKETS)

    buckets = []
    for key in sorted(key_counts):
        count = key_counts[key]
        if count < min_doc_count:
            continue
        bucket: dict[str, Any] = {"key": int(key) if date else key, "doc_count": count}
        if date:
            kdt = _dt.datetime.fromtimestamp(key / 1000, _dt.timezone.utc)
            bucket["key_as_string"] = (
                kdt.strftime("%Y-%m-%dT%H:%M:%S.")
                + f"{int(key) % 1000:03d}Z"
            )
        if sub:
            bucket_masks = []
            for i, seg in enumerate(segments):
                bm = np.zeros(seg.n_docs, bool)
                sel = per_seg_docs[i][per_seg_keys[i] == key]
                bm[sel] = True
                bucket_masks.append(bm)
            bucket.update(_sub_aggs(sub, segments, ms, bucket_masks, filter_fn, ext))
        buckets.append(bucket)
    return {"buckets": buckets}


def _calendar_next(key_ms: float, unit: str) -> float:
    if unit in ("week", "1w"):
        return key_ms + 7 * 86_400_000
    dt = _dt.datetime.fromtimestamp(key_ms / 1000, _dt.timezone.utc)
    months = {"month": 1, "1M": 1, "quarter": 3, "1q": 3}.get(unit, 12)
    month0 = dt.month - 1 + months
    nxt = dt.replace(year=dt.year + month0 // 12, month=month0 % 12 + 1)
    return nxt.timestamp() * 1000


def _histogram_over_ranges(conf, sub, segments, ms, masks, filter_fn, ext,
                           *, field, date, calendar, interval_conf,
                           interval, offset, hard) -> dict:
    """(date_)histogram over a RANGE field: the doc's stored [lo, hi]
    interval contributes to every bucket it intersects
    (RangeHistogramAggregator); hard_bounds clamps the span AND enumerates
    every bucket inside the bounds (empties included)."""
    lo_f, hi_f = f"{field}#lo", f"{field}#hi"
    hmin = hard.get("min") if hard else None
    hmax = hard.get("max") if hard else None

    def bucket_of(v: float) -> float:
        if calendar:
            return float(_calendar_keys(np.asarray([v]),
                                        str(interval_conf))[0])
        return float(np.floor((v - offset) / interval) * interval + offset)

    def next_key(k: float) -> float:
        if calendar:
            return _calendar_next(k, str(interval_conf))
        return k + interval

    key_counts: dict[float, int] = {}
    doc_lists: dict[float, list] = {}
    for i, seg in enumerate(segments):
        lo_nf = seg.numeric_fields.get(lo_f)
        hi_nf = seg.numeric_fields.get(hi_f)
        if lo_nf is None or hi_nf is None:
            continue
        lo_vals = lo_nf.values_i64 if lo_nf.kind == "int" else lo_nf.values_f64
        hi_vals = hi_nf.values_i64 if hi_nf.kind == "int" else hi_nf.values_f64
        m = masks[i] & lo_nf.present[:seg.n_docs]
        for d in np.nonzero(m)[0].tolist():
            lo, hi = float(lo_vals[d]), float(hi_vals[d])
            if hmin is not None:
                lo = max(lo, float(hmin))
            if hmax is not None:
                hi = min(hi, float(hmax))
            if hi < lo:
                continue
            if hmin is None and hmax is None and (hi - lo) > 1e15:
                # unbounded side without hard_bounds would enumerate the
                # whole int64 domain; clamp like the reference refuses
                raise IllegalArgumentException(
                    f"[{field}] range is unbounded; set [hard_bounds] on "
                    f"the histogram")
            k = bucket_of(lo)
            n_keys = 0
            while k <= hi:
                key_counts[k] = key_counts.get(k, 0) + 1
                doc_lists.setdefault(k, []).append((i, d))
                k = next_key(k)
                n_keys += 1
                if n_keys > MAX_BUCKETS:
                    raise TooManyBucketsException(MAX_BUCKETS)
    # hard bounds enumerate the FULL bounded span, empties included
    if hmin is not None and hmax is not None:
        k = bucket_of(float(hmin))
        n_keys = 0
        while k <= float(hmax):
            key_counts.setdefault(k, 0)
            k = next_key(k)
            n_keys += 1
            if n_keys > MAX_BUCKETS:
                raise TooManyBucketsException(MAX_BUCKETS)

    buckets = []
    for key in sorted(key_counts):
        bucket: dict[str, Any] = {
            "key": int(key) if date else key,
            "doc_count": key_counts[key],
        }
        if date:
            bucket["key_as_string"] = _iso_ms(int(key))
        if sub:
            bucket_masks = [np.zeros(s.n_docs, bool) for s in segments]
            for i, d in doc_lists.get(key, []):
                bucket_masks[i][d] = True
            bucket.update(_sub_aggs(sub, segments, ms, bucket_masks,
                                    filter_fn, ext))
        buckets.append(bucket)
    return {"buckets": buckets}


def _calendar_keys(vals_ms: np.ndarray, unit: str) -> np.ndarray:
    out = np.empty(len(vals_ms), np.float64)
    for i, v in enumerate(vals_ms):
        dt = _dt.datetime.fromtimestamp(float(v) / 1000, _dt.timezone.utc)
        if unit in ("month", "1M"):
            key_dt = dt.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
        elif unit in ("week", "1w"):
            # ISO weeks snap to Monday (DateHistogramInterval.WEEK)
            key_dt = (dt - _dt.timedelta(days=dt.weekday())).replace(
                hour=0, minute=0, second=0, microsecond=0)
        elif unit in ("quarter", "1q"):
            key_dt = dt.replace(
                month=(dt.month - 1) // 3 * 3 + 1,
                day=1, hour=0, minute=0, second=0, microsecond=0,
            )
        else:  # year
            key_dt = dt.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
        out[i] = key_dt.timestamp() * 1000
    return out


# -- range / filter family --------------------------------------------------


def _range_agg(conf, sub, segments, ms, masks, filter_fn, ext=None) -> dict:
    field = conf["field"]
    ranges = conf["ranges"]
    mapper = ms.field_mapper(field)
    is_date = mapper is not None and mapper.type == "date"
    buckets = []
    for r in ranges:
        frm = r.get("from")
        to = r.get("to")
        if is_date:
            frm = parse_date_millis(frm) if frm is not None else None
            to = parse_date_millis(to) if to is not None else None
        count = 0
        bucket_masks = []
        for i, seg in enumerate(segments):
            vals, present = _column(seg, field, ms)
            if vals is None:
                bucket_masks.append(np.zeros(seg.n_docs, bool))
                continue
            m = masks[i] & present
            if frm is not None:
                m = m & (vals >= frm)
            if to is not None:
                m = m & (vals < to)
            bucket_masks.append(m)
            count += int(m.sum())
        key = r.get("key")
        if key is None:
            # numeric range keys render bounds as doubles ("*-50.0",
            # InternalRange.Bucket key generation); dates keep raw form
            def _kfmt(v):
                if v is None:
                    return "*"
                if not is_date and isinstance(v, (int, float)):
                    return str(float(v))
                return str(v)
            key = f"{_kfmt(frm)}-{_kfmt(to)}"
        bucket: dict[str, Any] = {"key": key, "doc_count": count}
        if frm is not None:
            bucket["from"] = float(frm)
        if to is not None:
            bucket["to"] = float(to)
        if sub:
            bucket.update(_sub_aggs(sub, segments, ms, bucket_masks, filter_fn, ext))
        buckets.append(bucket)
    return {"buckets": buckets}


def _run_filter(filter_fn, body, segments, masks) -> list[np.ndarray]:
    if filter_fn is None:
        raise IllegalArgumentException("filter aggregations need a filter executor")
    return [
        masks[i] & filter_fn(body, i)[: seg.n_docs] for i, seg in enumerate(segments)
    ]


def _filter_agg(conf, sub, segments, ms, masks, filter_fn, ext=None) -> dict:
    f_masks = _run_filter(filter_fn, conf, segments, masks)
    out = {"doc_count": int(sum(m.sum() for m in f_masks))}
    out.update(_sub_aggs(sub, segments, ms, f_masks, filter_fn, ext))
    return out


def _filters_agg(conf, sub, segments, ms, masks, filter_fn, ext=None) -> dict:
    named = conf.get("filters")
    other = conf.get("other_bucket") or conf.get("other_bucket_key")
    anonymous = isinstance(named, list)
    entries = (list(enumerate(named)) if anonymous
               else list(named.items()))
    buckets: dict[str, Any] = {}
    ordered: list[dict] = []
    matched_any = [np.zeros(seg.n_docs, bool) for seg in segments]
    for fname, body in entries:
        f_masks = _run_filter(filter_fn, body, segments, masks)
        for i, m in enumerate(f_masks):
            matched_any[i] |= m
        bucket = {"doc_count": int(sum(m.sum() for m in f_masks))}
        bucket.update(_sub_aggs(sub, segments, ms, f_masks, filter_fn, ext))
        if anonymous:
            ordered.append(bucket)
        else:
            buckets[fname] = bucket
    if other:
        rest = [masks[i] & ~matched_any[i] for i in range(len(segments))]
        bucket = {"doc_count": int(sum(m.sum() for m in rest))}
        bucket.update(_sub_aggs(sub, segments, ms, rest, filter_fn, ext))
        key = (conf.get("other_bucket_key")
               if isinstance(conf.get("other_bucket_key"), str) else "_other_")
        if anonymous:
            ordered.append(bucket)
        else:
            buckets[key] = bucket
    # anonymous form renders a bucket ARRAY (FiltersAggregator.Keyed=false)
    return {"buckets": ordered if anonymous else buckets}


def _count_nested_objects(obj, parts: list[str]) -> int:
    """Number of nested objects reachable at `parts` inside one _source."""
    if not parts:
        if isinstance(obj, dict):
            return 1
        if isinstance(obj, list):
            return sum(1 for x in obj if isinstance(x, dict))
        return 0
    head = parts[0]
    if isinstance(obj, dict):
        return _count_nested_objects(obj.get(head), parts[1:])
    if isinstance(obj, list):
        return sum(_count_nested_objects(x, parts) for x in obj)
    return 0


def _nested_agg(conf, sub, segments, ms, masks, filter_fn, ext=None) -> dict:
    """nested aggregation (bucket/nested/NestedAggregator). This engine
    flattens nested docs into the parent (index/mapper.py nested_paths);
    doc_count here is the REAL nested-object count (from _source), while
    sub-aggregations run over the flattened multi-valued columns — which
    preserves per-object value attribution for terms/metrics."""
    import json as _json

    path = conf.get("path")
    if not path:
        raise ParsingException("[nested] requires [path]")
    paths = set(getattr(ms, "nested_paths", None) or set())
    # multi-index views: any index mapping the path as nested qualifies
    if hasattr(ms, "services"):
        for svc in ms.services:
            paths |= getattr(svc, "nested_paths", set())
    if path not in paths:
        raise IllegalArgumentException(
            f"[nested] nested object under path [{path}] is not of nested "
            f"type")
    parts = path.split(".")
    total = 0
    for i, seg in enumerate(segments):
        for d in np.nonzero(masks[i])[0]:
            try:
                src = _json.loads(seg.sources[int(d)])
            except Exception as e:  # noqa: BLE001 - malformed _source: skip
                logger.debug(
                    "nested agg: unparseable _source for doc %d: %s", d, e)
                continue
            total += _count_nested_objects(src, parts)
    out = {"doc_count": total}
    if sub:
        out.update(compute_aggs(segments, ms, sub, masks, filter_fn, ext))
    return out


def _reverse_nested_agg(conf, sub, segments, ms, masks, filter_fn,
                        ext=None) -> dict:
    """reverse_nested: join back to parent docs. Flattened storage means
    the masks already address parent docs — doc_count is the parent-doc
    count of the enclosing bucket."""
    out = {"doc_count": int(sum(int(m.sum()) for m in masks))}
    if sub:
        out.update(compute_aggs(segments, ms, sub, masks, filter_fn, ext))
    return out


def _missing_agg(conf, sub, segments, ms, masks, filter_fn, ext=None) -> dict:
    field = conf["field"]
    m_masks = []
    for i, seg in enumerate(segments):
        present = np.zeros(seg.n_docs, bool)
        nf = seg.numeric_fields.get(field)
        if nf is not None:
            present |= nf.present
        kf = seg.keyword_fields.get(field)
        if kf is not None:
            present |= kf.first_ord >= 0
        tf = seg.text_fields.get(field)
        if tf is not None:
            present |= tf.doc_len > 0
        vf = seg.vector_fields.get(field)
        if vf is not None:
            present |= vf.present
        m_masks.append(masks[i] & ~present)
    out = {"doc_count": int(sum(m.sum() for m in m_masks))}
    out.update(_sub_aggs(sub, segments, ms, m_masks, filter_fn, ext))
    return out


# register extended aggregation families (populates EXTENSION_AGGS)
from opensearch_tpu_torch.search import aggs_ext as _aggs_ext  # noqa: E402,F401
