"""Extended aggregations: the remaining metric & bucket families.

Completes the inventory of search/aggregations/ in the reference
(SURVEY.md §2.2 — bucket/ ~35 types, metrics/ ~25): extended_stats,
percentiles / percentile_ranks (exact — strict-quality superset of the
reference's TDigest/HDR approximations), median_absolute_deviation,
weighted_avg, top_hits, scripted_metric, matrix_stats
(modules/aggs-matrix-stats), multi_terms, rare_terms, significant_terms
(JLH heuristic, search/aggregations/bucket/terms/SignificantTermsAggregator),
sampler / diversified_sampler, adjacency_matrix, date_range (with date
math), composite (after-key pagination,
search/aggregations/bucket/composite/), auto_date_histogram.

All register into aggs.EXTENSION_AGGS with signature
(conf, sub, segments, ms, masks, filter_fn, ext) where ext carries
optional per-segment score arrays and segment metadata (owning index).
"""

from __future__ import annotations

import datetime as _dt
import json
import math
from typing import Any

import numpy as np

from opensearch_tpu_torch.common.errors import IllegalArgumentException, ParsingException
from opensearch_tpu_torch.common.settings import parse_time_millis
from opensearch_tpu_torch.common.timeutil import parse_date_math
from opensearch_tpu_torch.index.mapper import parse_date_millis
from opensearch_tpu_torch.search.aggs import (
    _CALENDAR_UNITS,
    EXTENSION_AGGS,
    _calendar_keys,
    _field_values,
    _run_filter,
    _sub_aggs,
    _value_masks,
)


def _collect(segments, ms, masks, field, missing=None) -> np.ndarray:
    chunks = [_field_values(seg, field, masks[i], ms) for i, seg in enumerate(segments)]
    vals = np.concatenate(chunks) if chunks else np.zeros(0)
    if missing is not None:
        # ValuesSourceConfig.missing: docs in the bucket without a value
        # aggregate the substitute instead; date fields accept date strings
        n_miss = 0
        for i, seg in enumerate(segments):
            nf = seg.numeric_fields.get(field)
            pres = nf.present if nf is not None else np.zeros(seg.n_docs, bool)
            n_miss += int((masks[i] & ~pres).sum())
        if n_miss:
            mapper = ms.field_mapper(field) if hasattr(ms, "field_mapper") \
                else None
            if getattr(mapper, "type", None) == "date" and \
                    isinstance(missing, str):
                mv = float(parse_date_millis(missing))
            else:
                mv = float(missing)
            vals = np.concatenate(
                [vals.astype(np.float64), np.full(n_miss, mv)])
    return vals


def _seg_numeric(seg, field, ms=None):
    # _column applies the unsigned_long unbias (stored biased -2^63)
    from opensearch_tpu_torch.search.aggs import _column

    return _column(seg, field, ms)


def _iso(ms_val: float) -> str:
    return (
        _dt.datetime.fromtimestamp(ms_val / 1000, _dt.timezone.utc)
        .isoformat()
        .replace("+00:00", "Z")
    )


# -- metrics ----------------------------------------------------------------


def _extended_stats(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    vals = _collect(segments, ms, masks, conf["field"], conf.get("missing"))
    sigma = float(conf.get("sigma", 2.0))
    if sigma < 0:
        name = (ext or {}).get("agg_name", "extended_stats")
        raise IllegalArgumentException(
            f"[sigma] must be greater than or equal to 0. "
            f"Found [{sigma}] in [{name}]")
    n = len(vals)
    if n == 0:
        return {
            "count": 0, "min": None, "max": None, "avg": None, "sum": 0.0,
            "sum_of_squares": None, "variance": None,
            "variance_population": None, "variance_sampling": None,
            "std_deviation": None, "std_deviation_population": None,
            "std_deviation_sampling": None,
            "std_deviation_bounds": {
                "upper": None, "lower": None,
                "upper_population": None, "lower_population": None,
                "upper_sampling": None, "lower_sampling": None,
            },
        }
    v = vals.astype(np.float64)
    s = float(v.sum())
    avg = s / n
    sos = float((v * v).sum())
    # the reference's exact double expression (ExtendedStatsAggregator:
    # (sumOfSqrs - sum*sum/count)/count) — a different association loses
    # the last ulp and fails exact-match compliance tests
    var_pop = max((sos - s * s / n) / n, 0.0)
    var_samp = max((sos - s * s / n) / (n - 1), 0.0) \
        if n > 1 else float("nan")
    std_pop = math.sqrt(var_pop)
    std_samp = math.sqrt(var_samp) if n > 1 else float("nan")

    def _clean(x):
        return None if isinstance(x, float) and math.isnan(x) else x

    return {
        "count": n,
        "min": float(v.min()),
        "max": float(v.max()),
        "avg": avg,
        "sum": s,
        "sum_of_squares": sos,
        "variance": var_pop,
        "variance_population": var_pop,
        "variance_sampling": _clean(var_samp),
        "std_deviation": std_pop,
        "std_deviation_population": std_pop,
        "std_deviation_sampling": _clean(std_samp),
        "std_deviation_bounds": {
            "upper": avg + sigma * std_pop,
            "lower": avg - sigma * std_pop,
            "upper_population": avg + sigma * std_pop,
            "lower_population": avg - sigma * std_pop,
            "upper_sampling": _clean(avg + sigma * std_samp) if n > 1 else None,
            "lower_sampling": _clean(avg - sigma * std_samp) if n > 1 else None,
        },
    }


_DEFAULT_PERCENTS = [1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0]


def _hdr_value_at(sorted_vals: np.ndarray, p: float, digits: int) -> float:
    """HdrHistogram.getValueAtPercentile emulation (plugins use the real
    library; reference: search/aggregations/metrics/ HDR percentiles).

    DoubleHistogram auto-ranges so the smallest recorded value lands at
    sub_bucket_half_count in the backing integer histogram; the returned
    quantile is the HIGHEST equivalent value of the rank-selected sample,
    converted back through the same scale — reproducing the reference's
    exact doubles (e.g. 51.0302734375 for p50 of [1,51,101,151] at 3
    significant digits)."""
    import math as _m

    n = len(sorted_vals)
    rank = max(1, int(_m.ceil(p / 100.0 * n)))
    v = float(sorted_vals[min(rank, n) - 1])
    positive = sorted_vals[sorted_vals > 0]
    if len(positive) == 0 or v <= 0:
        return v
    sub_count = 1 << max(int(_m.ceil(_m.log2(2 * 10 ** digits))), 1)
    half = sub_count // 2
    scale_pow = _m.floor(_m.log2(float(positive[0])))
    scale = half / (2.0 ** scale_pow)
    lv = int(v * scale)
    if lv < sub_count:
        unit = 1
    else:
        unit = 1 << (lv.bit_length() - sub_count.bit_length() + 1)
    highest = (lv // unit + 1) * unit - 1
    return highest / scale


def _validate_percentile_params(conf, ext) -> int | None:
    """Returns HDR significant digits when the hdr engine is selected;
    raises the reference's parameter errors."""
    name = (ext or {}).get("agg_name", "percentiles")
    td = conf.get("tdigest")
    if td is not None:
        comp = td.get("compression")
        if comp is not None:
            if not isinstance(comp, (int, float)):
                raise ParsingException("[compression] must be a number")
            if float(comp) < 0:
                raise IllegalArgumentException(
                    f"[compression] must be greater than or equal to 0. "
                    f"Found [{float(comp)}] in [{name}]")
    hdr = conf.get("hdr")
    if hdr is None:
        return None
    digits = hdr.get("number_of_significant_value_digits", 3)
    if digits is None or not isinstance(digits, int) \
            or isinstance(digits, bool):
        raise ParsingException(
            "[number_of_significant_value_digits] must be an integer")
    if not 0 <= digits <= 5:
        raise IllegalArgumentException(
            f"[numberOfSignificantValueDigits] must be between 0 and 5 "
            f"when calculating percentiles. Found [{digits}] in [{name}]")
    return digits


def _require_numeric_field(conf, ms, segments, typ, ext) -> None:
    """Numeric-only metric aggs 400 on keyword/text fields
    (ValuesSourceConfig type resolution)."""
    field = conf.get("field")
    mapper = ms.field_mapper(field) if field else None
    if mapper is not None and mapper.type in ("text", "keyword") and \
            not any(seg.numeric_fields.get(field) is not None
                    for seg in segments):
        raise IllegalArgumentException(
            f"Field [{field}] of type "
            f"[{mapper.original_type or mapper.type}] is not supported "
            f"for aggregation [{typ}]")


def _percentiles(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    hdr_digits = _validate_percentile_params(conf, ext)
    _require_numeric_field(conf, ms, segments, "percentiles", ext)
    vals = _collect(segments, ms, masks, conf["field"], conf.get("missing"))
    raw_percents = conf.get("percents", _DEFAULT_PERCENTS)
    if not isinstance(raw_percents, list) or not raw_percents:
        raise IllegalArgumentException(
            "[percents] must not be empty")
    try:
        percents = [float(p) for p in raw_percents]
    except (TypeError, ValueError):
        raise ParsingException("[percents] values must be numbers")
    if any(p < 0 or p > 100 for p in percents):
        raise IllegalArgumentException(
            "percent must be in [0,100]")
    keyed = bool(conf.get("keyed", True))
    if len(vals) == 0:
        results = [(p, None) for p in percents]
    elif hdr_digits is not None:
        sv = np.sort(vals.astype(np.float64))
        results = [(p, _hdr_value_at(sv, p, hdr_digits)) for p in percents]
    else:
        qs = np.percentile(vals.astype(np.float64), percents)
        results = [(p, float(q)) for p, q in zip(percents, qs)]
    if keyed:
        out = {"values": {str(float(p)): v for p, v in results}}
    else:
        out = {"values": [{"key": p, "value": v} for p, v in results]}
    _attach_value_partial(out, vals, ext)
    return out


def _percentile_ranks(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    vals = _collect(segments, ms, masks, conf["field"], conf.get("missing")).astype(np.float64)
    targets = [float(x) for x in conf["values"]]
    keyed = bool(conf.get("keyed", True))
    n = len(vals)
    results = []
    for t in targets:
        rank = float((vals <= t).sum()) * 100.0 / n if n else None
        results.append((t, rank))
    if keyed:
        out = {"values": {f"{t}": r for t, r in results}}
    else:
        out = {"values": [{"key": t, "value": r} for t, r in results]}
    _attach_value_partial(out, vals, ext)
    return out


def _median_absolute_deviation(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    comp = conf.get("compression")
    if comp is not None and float(comp) <= 0:
        raise IllegalArgumentException(
            f"[compression] must be greater than 0. "
            f"Found [{float(comp)}] in [{(ext or {}).get('agg_name', 'mad')}]")
    _require_numeric_field(conf, ms, segments,
                           "median_absolute_deviation", ext)
    vals = _collect(segments, ms, masks, conf["field"], conf.get("missing")).astype(np.float64)
    if len(vals) == 0:
        out = {"value": None}
        _attach_value_partial(out, vals, ext)
        return out
    med = float(np.median(vals))
    out = {"value": float(np.median(np.abs(vals - med)))}
    _attach_value_partial(out, vals, ext)
    return out


def _attach_value_partial(out: dict, vals, ext) -> None:
    """Cross-node partial: ship the raw masked values (exact merge; capped —
    the reference ships TDigest/HDR sketches for this class of metric)."""
    if not (ext and ext.get("partial")):
        return
    from opensearch_tpu_torch.search.aggs import MAX_PARTIAL_VALUES

    if len(vals) > MAX_PARTIAL_VALUES:
        raise IllegalArgumentException(
            f"metric over [{len(vals)}] values exceeds the cross-node "
            f"exact-merge cap [{MAX_PARTIAL_VALUES}]"
        )
    out["_p_values"] = np.asarray(vals, np.float64).tolist()


def _weighted_avg(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    v_conf = conf.get("value") or {}
    w_conf = conf.get("weight") or {}
    v_field, w_field = v_conf.get("field"), w_conf.get("field")
    if not v_field or not w_field:
        raise ParsingException("weighted_avg requires value.field and weight.field")
    v_missing = v_conf.get("missing")
    num = 0.0
    den = 0.0
    for i, seg in enumerate(segments):
        vv, vp = _seg_numeric(seg, v_field, ms)
        wv, wp = _seg_numeric(seg, w_field, ms)
        if wv is None:
            continue
        base = masks[i] & wp
        if vv is not None:
            both = base & vp
            num += float((vv[both].astype(np.float64) * wv[both]).sum())
            den += float(wv[both].astype(np.float64).sum())
            if v_missing is not None:
                only_w = base & ~vp
                num += float(v_missing) * float(wv[only_w].astype(np.float64).sum())
                den += float(wv[only_w].astype(np.float64).sum())
        elif v_missing is not None:
            num += float(v_missing) * float(wv[base].astype(np.float64).sum())
            den += float(wv[base].astype(np.float64).sum())
    out = {"value": num / den if den else None}
    if ext and ext.get("partial"):
        out["_p_num"] = num
        out["_p_den"] = den
    return out


def _top_hits(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    size = int(conf.get("size", 3))
    from_ = int(conf.get("from", 0))
    sort = conf.get("sort")
    if isinstance(sort, (str, dict)):
        sort = [sort]
    scores = ext.get("scores")
    seg_meta = ext.get("seg_meta")

    rows = []  # (sort_key_tuple, flat_idx, doc)
    total = 0
    for i, seg in enumerate(segments):
        docs = np.nonzero(masks[i])[0]
        total += len(docs)
        seg_scores = scores[i] if scores is not None and i < len(scores) else None
        for d in docs.tolist():
            sc = float(seg_scores[d]) if seg_scores is not None else 0.0
            if sort:
                key = _hit_sort_key(sort, seg, d, sc, ms) + (i, d)
            else:
                key = (-sc, i, d)
            rows.append((key, i, d, sc))
    rows.sort(key=lambda r: r[0])
    page = rows[from_: from_ + size]
    hits = []
    max_score = None
    for _, i, d, sc in page:
        seg = segments[i]
        hit = {
            "_index": (seg_meta[i].get("index") if seg_meta else "_na_"),
            "_id": seg.doc_ids[d],
            "_score": sc if not sort else None,
            "_source": json.loads(seg.sources[d]),
        }
        if sort:
            hit["sort"] = list(_hit_sort_values(sort, seg, d, sc, ms))
        if not sort and (max_score is None or sc > max_score):
            max_score = sc
        hits.append(hit)
    return {
        "hits": {
            "total": {"value": total, "relation": "eq"},
            "max_score": max_score,
            "hits": hits,
        }
    }


def _hit_sort_values(sort, seg, doc, score, ms) -> tuple:
    out = []
    for spec in sort:
        if isinstance(spec, str):
            fname = spec
        else:
            fname = next(iter(spec))
        if fname == "_score":
            out.append(score)
            continue
        if fname == "_doc":
            out.append(doc)
            continue
        vals, present = _seg_numeric(seg, fname, ms)
        if vals is not None and present[doc]:
            v = vals[doc]
            out.append(int(v) if float(v).is_integer() else float(v))
            continue
        kf = seg.keyword_fields.get(fname)
        if kf is not None and kf.first_ord[doc] >= 0:
            out.append(kf.ord_values[int(kf.first_ord[doc])])
            continue
        out.append(None)
    return tuple(out)


class _RevStr:
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return self.v > other.v

    def __eq__(self, other):
        return isinstance(other, _RevStr) and self.v == other.v


def _hit_sort_key(sort, seg, doc, score, ms) -> tuple:
    vals = _hit_sort_values(sort, seg, doc, score, ms)
    key = []
    for spec, v in zip(sort, vals):
        if isinstance(spec, str):
            order = "desc" if spec == "_score" else "asc"
        else:
            body = next(iter(spec.values()))
            order = body.get("order", "asc") if isinstance(body, dict) else body
        desc = order == "desc"
        if v is None:
            key.append((1, 0))
        elif isinstance(v, str):
            key.append((0, _RevStr(v) if desc else v))
        else:
            key.append((0, -v if desc else v))
    return tuple(key)


def _scripted_metric(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    from opensearch_tpu_torch.script.painless import DocView, Evaluator
    from opensearch_tpu_torch.script.service import default_script_service as svc

    params = conf.get("params") or {}
    init_s = conf.get("init_script")
    map_s = conf.get("map_script")
    combine_s = conf.get("combine_script")
    reduce_s = conf.get("reduce_script")
    if map_s is None:
        raise ParsingException("scripted_metric requires map_script")
    scores = ext.get("scores")
    states = []
    for i, seg in enumerate(segments):
        state: dict = {}
        if init_s:
            ast, p = svc.compile(init_s)
            Evaluator({"params": {**params, **p}, "state": state}).run(ast)
        map_ast, map_p = svc.compile(map_s)
        seg_scores = scores[i] if scores is not None and i < len(scores) else None
        for d in np.nonzero(masks[i])[0].tolist():
            env = {
                "params": {**params, **map_p},
                "state": state,
                "doc": DocView(seg, d, ms),
                "_score": float(seg_scores[d]) if seg_scores is not None else 0.0,
            }
            Evaluator(env).run(map_ast)
        if combine_s:
            ast, p = svc.compile(combine_s)
            state = Evaluator({"params": {**params, **p}, "state": state}).run(ast)
        states.append(state)
    if reduce_s:
        ast, p = svc.compile(reduce_s)
        value = Evaluator({"params": {**params, **p}, "states": states}).run(ast)
    else:
        value = states
    return {"value": value}


def _matrix_stats(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    fields = conf.get("fields") or []
    if not fields:
        raise ParsingException("matrix_stats requires fields")
    cols = {}
    present_cols = {}
    for f in fields:
        vals_parts, pres_parts = [], []
        for i, seg in enumerate(segments):
            vv, vp = _seg_numeric(seg, f, ms)
            n = seg.n_docs
            if vv is None:
                vals_parts.append(np.zeros(n))
                pres_parts.append(np.zeros(n, bool))
            else:
                vals_parts.append(vv.astype(np.float64))
                pres_parts.append(masks[i] & vp)
        cols[f] = np.concatenate(vals_parts) if vals_parts else np.zeros(0)
        present_cols[f] = (
            np.concatenate(pres_parts) if pres_parts else np.zeros(0, bool)
        )
    out_fields = []
    doc_count = 0
    for f in fields:
        m = present_cols[f]
        v = cols[f][m]
        n = len(v)
        doc_count = max(doc_count, n)
        if n == 0:
            continue
        mean = float(v.mean())
        var = float(v.var(ddof=1)) if n > 1 else 0.0
        std = math.sqrt(var)
        centered = v - mean
        skew = (
            float((centered**3).mean()) / (std**3) if n > 2 and std > 0 else 0.0
        )
        kurt = (
            float((centered**4).mean()) / (var**2) if n > 3 and var > 0 else 0.0
        )
        cov_row, corr_row = {}, {}
        for g in fields:
            both = present_cols[f] & present_cols[g]
            nb = int(both.sum())
            if nb < 2:
                cov_row[g] = 0.0
                corr_row[g] = 0.0
                continue
            a = cols[f][both]
            b = cols[g][both]
            cov = float(np.cov(a, b, ddof=1)[0, 1])
            cov_row[g] = cov
            sa, sb = a.std(ddof=1), b.std(ddof=1)
            corr_row[g] = cov / (sa * sb) if sa > 0 and sb > 0 else 0.0
        out_fields.append({
            "name": f,
            "count": n,
            "mean": mean,
            "variance": var,
            "skewness": skew,
            "kurtosis": kurt,
            "covariance": cov_row,
            "correlation": corr_row,
        })
    return {"doc_count": doc_count, "fields": out_fields}


# -- buckets ----------------------------------------------------------------


def _seg_key_values(seg, field, ms):
    """Per-doc scalar key (first value) + presence for terms-like bucketing."""
    kf = seg.keyword_fields.get(field)
    if kf is not None:
        present = kf.first_ord >= 0
        return kf, present, "keyword"
    vals, pres = _seg_numeric(seg, field, ms)
    if vals is not None:
        return vals, pres, "numeric"
    return None, np.zeros(seg.n_docs, bool), "none"


def _multi_terms(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    from opensearch_tpu_torch.search.aggs import _KeyOrd, _iso_ms

    terms_conf = conf.get("terms") or []
    fields = [t["field"] for t in terms_conf]
    missings = [t.get("missing") for t in terms_conf]
    if len(fields) < 2:
        raise ParsingException("multi_terms requires at least 2 terms sources")
    size = int(conf.get("size", 10))
    min_doc_count = int(conf.get("min_doc_count", 1))
    if ext and ext.get("partial"):
        size = int(conf.get("shard_size", size + (size >> 1) + 10))

    # per-component rendering kind (boolean -> JSON true/false,
    # date -> ISO string, like MultiTermsAggregator's per-source formats)
    kinds = []
    for f in fields:
        mapper = ms.field_mapper(f)
        if mapper is not None and mapper.type == "boolean":
            kinds.append("boolean")
        elif mapper is not None and mapper.type == "date":
            kinds.append("date")
        else:
            kinds.append("value")

    # coerce per-source `missing` values to the source's kind up-front so
    # key tuples stay type-uniform (mixed str/float slots break the sort)
    coerced_missing: list = []
    for m_, kind in zip(missings, kinds):
        if m_ is None:
            coerced_missing.append(None)
        elif kind == "boolean":
            coerced_missing.append(1 if m_ in (True, "true", 1) else 0)
        elif kind == "date" and isinstance(m_, str):
            coerced_missing.append(int(parse_date_millis(m_)))
        else:
            coerced_missing.append(m_)

    counts: dict[tuple, int] = {}
    doc_lists: dict[tuple, list] = {}
    for i, seg in enumerate(segments):
        per_field = [_seg_key_values(seg, f, ms) for f in fields]
        docs = np.nonzero(masks[i])[0]
        for d in docs.tolist():
            key_parts = []
            ok = True
            for fi, (src, present, kind) in enumerate(per_field):
                if kind == "none" or not present[d]:
                    if coerced_missing[fi] is not None:
                        key_parts.append(coerced_missing[fi])
                        continue
                    ok = False
                    break
                if kind == "keyword":
                    key_parts.append(src.ord_values[int(src.first_ord[d])])
                else:
                    v = src[d]
                    key_parts.append(int(v) if float(v).is_integer() else float(v))
            if not ok:
                continue
            key = tuple(key_parts)
            counts[key] = counts.get(key, 0) + 1
            doc_lists.setdefault(key, []).append((i, d))

    if min_doc_count > 0:
        counts = {k: c for k, c in counts.items() if c >= min_doc_count}

    # order: single dict or list of {"_count"|"_key"|"<agg-path>": dir}
    order_conf = conf.get("order", {"_count": "desc"})
    order_specs = (list(order_conf.items()) if isinstance(order_conf, dict)
                   else [next(iter(o.items())) for o in order_conf])
    sub_results: dict[tuple, dict] = {}

    def bucket_sub(key) -> dict:
        if key not in sub_results:
            bucket_masks = [np.zeros(s.n_docs, bool) for s in segments]
            for i, d in doc_lists.get(key, []):
                bucket_masks[i][d] = True
            sub_results[key] = _sub_aggs(sub, segments, ms, bucket_masks,
                                         filter_fn, ext)
        return sub_results[key]

    def sort_key(kv):
        key, count = kv
        parts = []
        for okey, odir in order_specs:
            desc = odir == "desc"
            if okey == "_count":
                parts.append(-count if desc else count)
            elif okey == "_key":
                parts.append(tuple(_KeyOrd(k, desc) for k in key))
            else:
                name, _, prop = okey.partition(".")
                result = (bucket_sub(key) if sub else {}).get(name)
                if result is None:
                    raise ParsingException(
                        f"multi_terms order references unknown agg [{okey}]")
                v = result.get(prop or "value")
                v = v if v is not None else float("-inf")
                parts.append(-v if desc else v)
        parts.append(tuple(_KeyOrd(k, False) for k in key))
        return tuple(parts)

    items = sorted(counts.items(), key=sort_key)
    top = items[:size]
    other = sum(c for _, c in items[size:])

    def render(k, kind):
        if kind == "boolean":
            return bool(k)
        if kind == "date" and not isinstance(k, str):
            return _iso_ms(int(k))
        return k

    def render_str(k, kind):
        if kind == "boolean":
            return "true" if k else "false"
        if kind == "date" and not isinstance(k, str):
            return _iso_ms(int(k))
        return str(k)

    buckets = []
    for key, count in top:
        bucket = {
            "key": [render(k, kind) for k, kind in zip(key, kinds)],
            "key_as_string": "|".join(
                render_str(k, kind) for k, kind in zip(key, kinds)),
            "doc_count": count,
        }
        if sub:
            bucket.update(bucket_sub(key))
        buckets.append(bucket)
    return {
        "doc_count_error_upper_bound": 0,
        "sum_other_doc_count": other,
        "buckets": buckets,
    }


def _rare_terms(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    field = conf["field"]
    max_doc_count = int(conf.get("max_doc_count", 1))
    counts: dict[Any, int] = {}
    for i, seg in enumerate(segments):
        kf = seg.keyword_fields.get(field)
        if kf is not None:
            entry_mask = masks[i][kf.mv_docs]
            seg_counts = np.bincount(kf.mv_ords[entry_mask], minlength=len(kf.ord_values))
            for o in np.nonzero(seg_counts)[0]:
                key = kf.ord_values[int(o)]
                counts[key] = counts.get(key, 0) + int(seg_counts[o])
        else:
            vals = _field_values(seg, field, masks[i], ms)
            uniq, c = np.unique(vals, return_counts=True)
            for v, n in zip(uniq.tolist(), c.tolist()):
                counts[v] = counts.get(v, 0) + n
    rare = [(k, c) for k, c in counts.items() if c <= max_doc_count]
    rare.sort(key=lambda kv: (kv[1], str(kv[0])))
    buckets = []
    for key, count in rare:
        bucket = {"key": key, "doc_count": count}
        if sub:
            bucket_masks = _value_masks(segments, field, key, masks, ms)
            bucket.update(_sub_aggs(sub, segments, ms, bucket_masks, filter_fn, ext))
        buckets.append(bucket)
    out = {"buckets": buckets}
    if ext and ext.get("partial"):
        # a term rare here may be common on another node: ship the FULL
        # local counts so the coordinator filter sees global totals
        from opensearch_tpu_torch.search.aggs import MAX_PARTIAL_VALUES

        if len(counts) > MAX_PARTIAL_VALUES:
            raise IllegalArgumentException(
                f"rare_terms over [{len(counts)}] terms exceeds the "
                f"cross-node exact-merge cap [{MAX_PARTIAL_VALUES}]"
            )
        out["_p_counts"] = [[k, c] for k, c in counts.items()]
    return out


def _significant_terms(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    field = conf["field"]
    size = int(conf.get("size", 10))
    min_doc_count = int(conf.get("min_doc_count", 3))
    fg_counts: dict[Any, int] = {}
    bg_counts: dict[Any, int] = {}
    fg_total = 0
    bg_total = 0
    for i, seg in enumerate(segments):
        fg_total += int(masks[i].sum())
        bg_total += int(seg.live.sum())
        kf = seg.keyword_fields.get(field)
        if kf is None:
            continue
        fg_entry = masks[i][kf.mv_docs]
        bg_entry = seg.live[kf.mv_docs]
        fg_c = np.bincount(kf.mv_ords[fg_entry], minlength=len(kf.ord_values))
        bg_c = np.bincount(kf.mv_ords[bg_entry], minlength=len(kf.ord_values))
        for o in np.nonzero(bg_c)[0]:
            key = kf.ord_values[int(o)]
            bg_counts[key] = bg_counts.get(key, 0) + int(bg_c[o])
            if fg_c[o]:
                fg_counts[key] = fg_counts.get(key, 0) + int(fg_c[o])
    scored = []
    for key, fg in fg_counts.items():
        if fg < min_doc_count or fg_total == 0:
            continue
        bg = bg_counts.get(key, fg)
        fg_pct = fg / fg_total
        bg_pct = bg / bg_total if bg_total else 0.0
        if fg_pct <= bg_pct or bg_pct == 0:
            continue
        # JLH: (fg% - bg%) * (fg% / bg%)
        score = (fg_pct - bg_pct) * (fg_pct / bg_pct)
        scored.append((score, key, fg, bg))
    scored.sort(key=lambda t: (-t[0], str(t[1])))
    buckets = []
    for score, key, fg, bg in scored[:size]:
        bucket = {"key": key, "doc_count": fg, "score": score, "bg_count": bg}
        if sub:
            bucket_masks = _value_masks(segments, field, key, masks, ms)
            bucket.update(_sub_aggs(sub, segments, ms, bucket_masks, filter_fn, ext))
        buckets.append(bucket)
    return {"doc_count": fg_total, "bg_count": bg_total, "buckets": buckets}


def _sampler(conf, sub, segments, ms, masks, filter_fn, ext, diversify=False) -> dict:
    shard_size = int(conf.get("shard_size", 100))
    scores = ext.get("scores")
    rows = []
    for i, seg in enumerate(segments):
        seg_scores = scores[i] if scores is not None and i < len(scores) else None
        for d in np.nonzero(masks[i])[0].tolist():
            sc = float(seg_scores[d]) if seg_scores is not None else 0.0
            rows.append((-sc, i, d))
    rows.sort()
    sel_masks = [np.zeros(s.n_docs, bool) for s in segments]
    taken = 0
    seen_values: dict[Any, int] = {}
    max_per_value = int(conf.get("max_docs_per_value", 1)) if diversify else None
    div_field = conf.get("field") if diversify else None
    for _, i, d in rows:
        if taken >= shard_size:
            break
        if diversify and div_field:
            seg = segments[i]
            key = None
            kf = seg.keyword_fields.get(div_field)
            if kf is not None and kf.first_ord[d] >= 0:
                key = kf.ord_values[int(kf.first_ord[d])]
            else:
                vals, pres = _seg_numeric(seg, div_field, ms)
                if vals is not None and pres[d]:
                    key = float(vals[d])
            if key is not None:
                if seen_values.get(key, 0) >= max_per_value:
                    continue
                seen_values[key] = seen_values.get(key, 0) + 1
        sel_masks[i][d] = True
        taken += 1
    out = {"doc_count": taken}
    out.update(_sub_aggs(sub, segments, ms, sel_masks, filter_fn, ext))
    return out


def _diversified_sampler(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    return _sampler(conf, sub, segments, ms, masks, filter_fn, ext, diversify=True)


def _adjacency_matrix(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    named = conf.get("filters") or {}
    sep = conf.get("separator", "&")
    names = sorted(named)
    f_masks = {
        name: _run_filter(filter_fn, named[name], segments, masks) for name in names
    }
    buckets = []
    for idx, name in enumerate(names):
        count = int(sum(m.sum() for m in f_masks[name]))
        if count > 0:
            bucket = {"key": name, "doc_count": count}
            if sub:
                bucket.update(
                    _sub_aggs(sub, segments, ms, f_masks[name], filter_fn, ext)
                )
            buckets.append(bucket)
        for name2 in names[idx + 1:]:
            inter = [a & b for a, b in zip(f_masks[name], f_masks[name2])]
            count2 = int(sum(m.sum() for m in inter))
            if count2 > 0:
                bucket = {"key": f"{name}{sep}{name2}", "doc_count": count2}
                if sub:
                    bucket.update(_sub_aggs(sub, segments, ms, inter, filter_fn, ext))
                buckets.append(bucket)
    buckets.sort(key=lambda b: b["key"])
    return {"buckets": buckets}


def _date_field_out_fmt(ms_service, field, conf) -> str | None:
    """Output/parse format for date_range values: agg-level `format` wins,
    else the FIELD's mapping format (first alternative), else default."""
    if conf.get("format"):
        return str(conf["format"])
    mapper = ms_service.field_mapper(field) if ms_service else None
    fmt = getattr(mapper, "format", None)
    if fmt:
        return str(fmt).split("||")[0]
    return None


def _parse_date_by_fmt(v, fmt: str | None) -> int:
    """-> epoch millis; epoch_second-formatted fields read bare numbers as
    SECONDS (the reference resolves numeric input through the field's
    DateFormatter)."""
    if fmt == "epoch_second" and (
            isinstance(v, (int, float)) or str(v).lstrip("-").isdigit()):
        return int(v) * 1000
    return parse_date_math(v)


def _format_date_by_fmt(ms_val: float, fmt: str | None) -> str:
    if fmt == "epoch_second":
        return str(int(ms_val) // 1000)
    from opensearch_tpu_torch.search.fetch import _format_date_ms

    if fmt in (None, "strict_date_optional_time", "date_optional_time"):
        return _format_date_ms(int(ms_val), None)
    return str(_format_date_ms(int(ms_val), fmt))


def _date_range(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    field = conf["field"]
    ranges = conf["ranges"]
    keyed = bool(conf.get("keyed", False))
    fmt = _date_field_out_fmt(ms, field, conf)
    missing_raw = conf.get("missing")
    missing_ms = _parse_date_by_fmt(missing_raw, fmt) \
        if missing_raw is not None else None
    entries = []
    for r in ranges:
        frm = _parse_date_by_fmt(r["from"], fmt) \
            if r.get("from") is not None else None
        to = _parse_date_by_fmt(r["to"], fmt) \
            if r.get("to") is not None else None
        count = 0
        bucket_masks = []
        for i, seg in enumerate(segments):
            vals, pres = _seg_numeric(seg, field, ms)
            if vals is None:
                vals = np.zeros(seg.n_docs)
                pres = np.zeros(seg.n_docs, bool)
            m = masks[i] & pres
            if frm is not None:
                m = m & (vals >= frm)
            if to is not None:
                m = m & (vals < to)
            if missing_ms is not None:
                # docs without the field take the substitute value
                m_miss = masks[i] & ~pres
                if (frm is None or missing_ms >= frm) and \
                        (to is None or missing_ms < to):
                    m = m | m_miss
            bucket_masks.append(m)
            count += int(m.sum())
        key = r.get("key")
        if key is None:
            key = (f"{_format_date_by_fmt(frm, fmt) if frm is not None else '*'}"
                   f"-{_format_date_by_fmt(to, fmt) if to is not None else '*'}")
        bucket: dict[str, Any] = {"key": key, "doc_count": count}
        if frm is not None:
            bucket["from"] = float(frm)
            bucket["from_as_string"] = _format_date_by_fmt(frm, fmt)
        if to is not None:
            bucket["to"] = float(to)
            bucket["to_as_string"] = _format_date_by_fmt(to, fmt)
        if sub:
            bucket.update(_sub_aggs(sub, segments, ms, bucket_masks, filter_fn, ext))
        entries.append((frm, to, bucket))
    # InternalDateRange sorts buckets by (from asc nulls-first, to asc)
    entries.sort(key=lambda e: (
        e[0] if e[0] is not None else float("-inf"),
        e[1] if e[1] is not None else float("inf"),
    ))
    buckets = [b for _f, _t, b in entries]
    if keyed:
        return {"buckets": {b["key"]: {k: v for k, v in b.items() if k != "key"}
                            for b in buckets}}
    return {"buckets": buckets}


# -- composite --------------------------------------------------------------


def _composite(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    sources = conf.get("sources") or []
    if not sources:
        # both message forms appear across reference versions; the suite
        # greps for either
        raise ParsingException(
            "Required [sources]: Composite [sources] cannot be null or "
            "empty")
    size = int(conf.get("size", 10))
    after = conf.get("after")
    specs = []  # (name, type, conf)
    for s in sources:
        if len(s) != 1:
            raise ParsingException("each composite source must have one name")
        name = next(iter(s))
        body = s[name]
        typ = next(iter(body))
        if typ not in ("terms", "histogram", "date_histogram"):
            raise ParsingException(f"unsupported composite source type [{typ}]")
        specs.append((name, typ, body[typ]))

    counts: dict[tuple, int] = {}
    doc_lists: dict[tuple, list] = {}
    for i, seg in enumerate(segments):
        per_src = []
        for name, typ, sconf in specs:
            field = sconf["field"]
            # composite buckets EVERY value of a multi-valued field
            # (CompositeValuesSource iterates all ords per doc); the
            # keyword CSR (mv_offsets into mv_ords) gives per-doc slices
            kf = seg.keyword_fields.get(field)
            per_src.append(
                (_seg_key_values(seg, field, ms), typ, sconf, kf))
        import itertools as _it

        for d in np.nonzero(masks[i])[0].tolist():
            # list of alternatives per source; None = missing_bucket slot
            parts_options: list[list] = []
            ok = True
            for (src, present, kind), typ, sconf, kf in per_src:
                if not present[d]:
                    if sconf.get("missing_bucket"):
                        parts_options.append([None])
                        continue
                    ok = False
                    break
                if kind == "keyword":
                    if kf is not None:
                        s_, e_ = (int(kf.mv_offsets[d]),
                                  int(kf.mv_offsets[d + 1]))
                        vals = [kf.ord_values[int(o)]
                                for o in kf.mv_ords[s_:e_]]
                    else:
                        vals = []
                else:
                    nf = seg.numeric_fields.get(sconf["field"])
                    if nf is not None and nf.mv_offsets is not None:
                        # every value of a multi-valued numeric buckets
                        vals = [float(x) for x in nf.doc_values(d)]
                    else:
                        vals = [float(src[d])]
                opts = []
                for v in vals:
                    if typ == "histogram":
                        interval = float(sconf["interval"])
                        v = math.floor(v / interval) * interval
                    elif typ == "date_histogram":
                        from opensearch_tpu_torch.search.aggs import (
                            _CALENDAR_FIXED,
                        )

                        iv = str(sconf.get("fixed_interval") or sconf.get("calendar_interval") or sconf.get("interval"))
                        iv = _CALENDAR_FIXED.get(iv, iv)
                        off = float(parse_time_millis(
                            sconf.get("offset", 0)))
                        if iv in _CALENDAR_UNITS:
                            v = int(_calendar_keys(np.asarray([v]), iv)[0])
                        else:
                            interval = float(parse_time_millis(iv))
                            v = int(math.floor((v - off) / interval)
                                    * interval + off)
                    elif kind == "numeric" and float(v).is_integer():
                        v = int(v)
                    if v not in opts:
                        opts.append(v)
                parts_options.append(opts)
            if not ok:
                continue
            for combo in _it.product(*parts_options):
                key = tuple(combo)
                counts[key] = counts.get(key, 0) + 1
                doc_lists.setdefault(key, []).append((i, d))

    orders = [
        -1 if (spec[2].get("order", "asc") == "desc") else 1 for spec in specs
    ]

    missing_orders = [spec[2].get("missing_order", "first")
                      for spec in specs]

    def key_sortable(key: tuple) -> tuple:
        parts = []
        for v, o, mo in zip(key, orders, missing_orders):
            if v is None:
                # missing buckets sort first unless missing_order=last
                parts.append((2 if mo == "last" else -1, 0))
            elif isinstance(v, str):
                parts.append((0, _RevStr(v) if o < 0 else v))
            else:
                parts.append((1, -v if o < 0 else v))
        return tuple(parts)

    ordered = sorted(counts, key=key_sortable)
    if after is not None:
        parts = []
        for name, typ, sconf in specs:
            v = after.get(name)
            # a formatted after value round-trips back to epoch ms
            if typ == "date_histogram" and isinstance(v, str):
                try:
                    v = int(parse_date_millis(v))
                except ValueError:
                    pass
            parts.append(v)
        cutoff = key_sortable(tuple(parts))
        ordered = [k for k in ordered if key_sortable(k) > cutoff]
    page = ordered[:size]

    _NAMED_FORMATS = {
        "strict_date": "yyyy-MM-dd", "date": "yyyy-MM-dd",
        "basic_date": "yyyyMMdd",
        "strict_date_time": "yyyy-MM-dd'T'HH:mm:ss.SSSZ",
    }

    def render_part(v, spec):
        _name, typ, sconf = spec
        if v is None or typ != "date_histogram":
            return v
        fmt = sconf.get("format")
        if not fmt:
            return v
        if fmt == "epoch_millis":
            return str(int(v))
        from opensearch_tpu_torch.search.aggs import _iso_ms

        if fmt == "iso8601":
            return _iso_ms(int(v))
        from opensearch_tpu_torch.search.fetch import _JODA_MAP

        py_fmt = _NAMED_FORMATS.get(str(fmt), str(fmt))
        for jd, st in _JODA_MAP:
            py_fmt = py_fmt.replace(jd, st)
        py_fmt = py_fmt.replace("'T'", "T").replace("SSS", "{ms}") \
            .replace("Z", "Z")
        kdt = _dt.datetime.fromtimestamp(v / 1000, _dt.timezone.utc)
        out_s = kdt.strftime(py_fmt)
        return out_s.replace("{ms}", f"{int(v) % 1000:03d}")

    def render_key(key) -> dict:
        return {spec[0]: render_part(v, spec)
                for spec, v in zip(specs, key)}

    buckets = []
    for key in page:
        bucket = {
            "key": render_key(key),
            "doc_count": counts[key],
        }
        if sub:
            bucket_masks = [np.zeros(s.n_docs, bool) for s in segments]
            for i, d in doc_lists[key]:
                bucket_masks[i][d] = True
            bucket.update(_sub_aggs(sub, segments, ms, bucket_masks, filter_fn, ext))
        buckets.append(bucket)
    out: dict[str, Any] = {"buckets": buckets}
    if page:
        out["after_key"] = render_key(page[-1])
    return out


# -- auto_date_histogram ----------------------------------------------------

_AUTO_LADDER_MS = [
    ("1s", 1000), ("5s", 5000), ("10s", 10_000), ("30s", 30_000),
    ("1m", 60_000), ("5m", 300_000), ("10m", 600_000), ("30m", 1_800_000),
    ("1h", 3_600_000), ("3h", 10_800_000), ("12h", 43_200_000),
    ("1d", 86_400_000), ("7d", 604_800_000), ("30d", 2_592_000_000),
    ("90d", 7_776_000_000), ("365d", 31_536_000_000),
]


def _auto_date_histogram(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    field = conf["field"]
    target = int(conf.get("buckets", 10))
    all_vals = _collect(segments, ms, masks, field)
    if len(all_vals) == 0:
        return {"buckets": [], "interval": "1s"}
    lo, hi = float(all_vals.min()), float(all_vals.max())
    chosen, interval = _AUTO_LADDER_MS[-1]
    for name, iv in _AUTO_LADDER_MS:
        if (math.floor(hi / iv) - math.floor(lo / iv) + 1) <= target:
            chosen, interval = name, iv
            break
    # multi-day intervals anchor at the first DAY-rounded data point, not
    # at the epoch (the reference's RoundingInfo innerIntervals: values
    # round to the base unit, then group into interval-sized runs)
    day = 86_400_000
    if interval > day and interval % day == 0:
        anchor = math.floor(lo / day) * day
    else:
        anchor = 0.0
    key_counts: dict[float, int] = {}
    per_seg_keys, per_seg_docs = [], []
    for i, seg in enumerate(segments):
        vals, pres = _seg_numeric(seg, field, ms)
        if vals is None:
            per_seg_keys.append(np.zeros(0))
            per_seg_docs.append(np.zeros(0, np.int64))
            continue
        m = masks[i] & pres
        docs = np.nonzero(m)[0]
        keys = (np.floor((vals[docs].astype(np.float64) - anchor)
                         / interval) * interval + anchor)
        per_seg_keys.append(keys)
        per_seg_docs.append(docs)
        uniq, c = np.unique(keys, return_counts=True)
        for k_, n_ in zip(uniq.tolist(), c.tolist()):
            key_counts[k_] = key_counts.get(k_, 0) + n_
    from opensearch_tpu_torch.search.aggs import _iso_ms

    buckets = []
    for key in sorted(key_counts):
        bucket: dict[str, Any] = {
            "key": int(key),
            "key_as_string": _iso_ms(int(key)),
            "doc_count": key_counts[key],
        }
        if sub:
            bucket_masks = []
            for i, seg in enumerate(segments):
                bm = np.zeros(seg.n_docs, bool)
                bm[per_seg_docs[i][per_seg_keys[i] == key]] = True
                bucket_masks.append(bm)
            bucket.update(_sub_aggs(sub, segments, ms, bucket_masks, filter_fn, ext))
        buckets.append(bucket)
    return {"buckets": buckets, "interval": chosen}


def _significant_text(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    """significant_text (bucket/terms/SignificantTextAggregationBuilder):
    significant_terms over a text field's analyzed terms — foreground =
    matched docs' postings, background = all live docs'. JLH scoring like
    _significant_terms."""
    field = conf["field"]
    size = int(conf.get("size", 10))
    min_doc_count = int(conf.get("min_doc_count", 3))
    dedup = bool(conf.get("filter_duplicate_text", False))
    fg_counts: dict[str, int] = {}
    bg_counts: dict[str, int] = {}
    fg_total = 0
    bg_total = 0
    seen_shingles: set = set()
    for i, seg in enumerate(segments):
        fg_total += int(masks[i].sum())
        bg_total += int(seg.live.sum())
        tf = seg.text_fields.get(field)
        if tf is None:
            continue
        for tid, term in enumerate(tf.terms):
            off = int(tf.term_offsets[tid])
            end = int(tf.term_offsets[tid + 1])
            docs = tf.postings_docs[off:end]
            bg = int(seg.live[docs].sum())
            if bg:
                bg_counts[term] = bg_counts.get(term, 0) + bg
            if not dedup:
                fg = int(masks[i][docs].sum())
                if fg:
                    fg_counts[term] = fg_counts.get(term, 0) + fg
        if dedup:
            # filter_duplicate_text: prune tokens inside any 6-gram window
            # already seen in an earlier foreground doc (Lucene
            # DeDuplicatingTokenFilter's DuplicateSequenceSpotter, window 6)
            for fg_c in _dedup_fg_counts(tf, masks[i], seen_shingles):
                fg_counts[fg_c] = fg_counts.get(fg_c, 0) + 1
    scored = []
    for key, fg in fg_counts.items():
        if fg < min_doc_count or fg_total == 0:
            continue
        bg = bg_counts.get(key, fg)
        fg_pct = fg / fg_total
        bg_pct = bg / bg_total if bg_total else 0.0
        if fg_pct <= bg_pct or bg_pct == 0:
            continue
        score = (fg_pct - bg_pct) * (fg_pct / bg_pct)  # JLH
        scored.append((score, key, fg, bg))
    scored.sort(key=lambda t: (-t[0], str(t[1])))
    buckets = [
        {"key": key, "doc_count": fg, "score": score, "bg_count": bg}
        for score, key, fg, bg in scored[:size]
    ]
    return {"doc_count": fg_total, "bg_count": bg_total, "buckets": buckets}


def _dedup_fg_counts(tf, mask, seen_shingles: set):
    """Yields one term per (doc, term) foreground count surviving the
    duplicate-6-gram prune. Rebuilds each doc's token stream from position
    postings."""
    W = 6
    for d in np.nonzero(mask)[0]:
        d = int(d)
        seq: dict[int, str] = {}
        for tid, term in enumerate(tf.terms):
            for pos in tf.term_positions(term, d):
                seq[int(pos)] = term
        ordered = [seq[p] for p in sorted(seq)]
        pruned = [False] * len(ordered)
        if len(ordered) >= W:
            for s in range(len(ordered) - W + 1):
                gram = tuple(ordered[s:s + W])
                if gram in seen_shingles:
                    for j in range(s, s + W):
                        pruned[j] = True
                else:
                    seen_shingles.add(gram)
        elif ordered:
            gram = tuple(ordered)
            if gram in seen_shingles:
                pruned = [True] * len(ordered)
            else:
                seen_shingles.add(gram)
        yield from {t for t, pr in zip(ordered, pruned) if not pr}


def _ip_range(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    """ip_range (bucket/range/IpRangeAggregationBuilder): ranges/CIDR masks
    over ip columns (stored as keyword ordinals here)."""
    import ipaddress

    field = conf["field"]
    ranges = conf.get("ranges")
    if not isinstance(ranges, list) or not ranges:
        raise ParsingException("[ip_range] requires [ranges]")
    keyed = bool(conf.get("keyed", False))

    def ip_int(v):
        a = ipaddress.ip_address(str(v))
        # the reference compares 16-byte IPv6 forms; v4 sorts at its
        # v4-mapped position (::ffff:a.b.c.d), so ::1 < any v4 address
        if a.version == 4:
            return (0xFFFF << 32) | int(a)
        return int(a)

    # per-segment int value per doc (first value)
    seg_vals = []
    for seg in segments:
        kf = seg.keyword_fields.get(field)
        if kf is None:
            seg_vals.append(None)
            continue
        ord_ints = [ip_int(v) if v else None for v in kf.ord_values]
        vals = np.full(seg.n_docs, -1, dtype=object)
        for d in range(seg.n_docs):
            o = int(kf.first_ord[d])
            vals[d] = ord_ints[o] if o >= 0 else None
        seg_vals.append(vals)

    buckets = []
    for r in ranges:
        frm = to = None
        key = r.get("key")
        mask_from_str = mask_to_str = None
        if "mask" in r:
            net = ipaddress.ip_network(str(r["mask"]), strict=False)
            frm = ip_int(net.network_address)
            to = ip_int(net.broadcast_address) + 1
            if key is None:
                key = str(r["mask"])
            # mask buckets report their bounds as addresses: from = network
            # address (omitted when ::), to = broadcast+1 (exclusive)
            if int(net.network_address) != 0:
                mask_from_str = str(net.network_address)
            upper = int(net.broadcast_address) + 1
            if net.version == 4:
                if upper < (1 << 32):
                    mask_to_str = str(ipaddress.IPv4Address(upper))
            elif upper < (1 << 128):
                mask_to_str = str(ipaddress.IPv6Address(upper))
        else:
            if r.get("from") is not None:
                frm = ip_int(r["from"])
            if r.get("to") is not None:
                to = ip_int(r["to"])
        count = 0
        bucket_masks = []
        for i, seg in enumerate(segments):
            vals = seg_vals[i]
            if vals is None:
                bucket_masks.append(np.zeros(seg.n_docs, bool))
                continue
            m = masks[i].copy()
            for d in np.nonzero(m)[0]:
                v = vals[int(d)]
                if v is None or (frm is not None and v < frm) \
                        or (to is not None and v >= to):
                    m[d] = False
            bucket_masks.append(m)
            count += int(m.sum())
        bucket: dict[str, Any] = {"doc_count": count}
        if "mask" in r:
            bkey = key
        else:
            bkey = key or (f"{r.get('from', '*')}-{r.get('to', '*')}")
        bucket["key"] = bkey
        if "mask" in r:
            if mask_from_str is not None:
                bucket["from"] = mask_from_str
            if mask_to_str is not None:
                bucket["to"] = mask_to_str
        else:
            if r.get("from") is not None:
                bucket["from"] = str(r["from"])
            if r.get("to") is not None:
                bucket["to"] = str(r["to"])
        if sub:
            bucket.update(_sub_aggs(sub, segments, ms, bucket_masks,
                                    filter_fn, ext))
        buckets.append(bucket)
    if keyed:
        return {"buckets": {b["key"]: {k: v for k, v in b.items()
                                       if k != "key"} for b in buckets}}
    return {"buckets": buckets}


# -- geo aggregations (bucket/geogrid + metric geo aggs) ---------------------
# Cell ids and distances are integer/float array ops over the synthetic
# {field}#lat/#lon columns — the naturally-vectorizable OLAP shape
# (GeoHashGridAggregator / GeoTileGridAggregator / GeoDistanceAggregator /
# GeoBoundsAggregator / GeoCentroidAggregator).


def _geo_latlon(segments, field):
    """Per-segment (lat, lon, present) float arrays, or None entries when
    the segment lacks the field's columns."""
    out = []
    for seg in segments:
        lat_f = seg.numeric_fields.get(f"{field}#lat")
        lon_f = seg.numeric_fields.get(f"{field}#lon")
        if lat_f is None or lon_f is None:
            out.append(None)
            continue
        out.append((
            lat_f.values_f64[:seg.n_docs],
            lon_f.values_f64[:seg.n_docs],
            lat_f.present[:seg.n_docs],
        ))
    return out


def _geo_distance_agg(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    from opensearch_tpu_torch.search.executor import (
        _haversine_m,
        _parse_geo_origin,
    )

    field = conf["field"]
    origin = conf.get("origin")
    if origin is None:
        raise ParsingException("[geo_distance] requires [origin]")
    ranges = conf.get("ranges")
    if not isinstance(ranges, list) or not ranges:
        raise ParsingException("[geo_distance] requires [ranges]")
    o_lat, o_lon = _parse_geo_origin(origin)
    keyed = bool(conf.get("keyed", False))
    # from/to are in `unit` (default meters); distances compare in meters
    # (GeoDistanceAggregationBuilder + DistanceUnit)
    unit_m = {
        "mm": 0.001, "cm": 0.01, "m": 1.0, "km": 1000.0,
        "in": 0.0254, "ft": 0.3048, "yd": 0.9144,
        "mi": 1609.344, "nmi": 1852.0, "NM": 1852.0,
    }.get(str(conf.get("unit", "m")), 1.0)
    cols = _geo_latlon(segments, field)

    # per-segment distance array (NaN = absent)
    dists = []
    for i, seg in enumerate(segments):
        if cols[i] is None:
            dists.append(None)
            continue
        lat, lon, present = cols[i]
        d = _haversine_m(o_lat, o_lon, lat, lon)
        dists.append(np.where(present, d, np.nan))

    buckets = []
    for r in ranges:
        frm = float(r["from"]) if r.get("from") is not None else None
        to = float(r["to"]) if r.get("to") is not None else None
        key = r.get("key")
        if key is None:
            key = (f"{frm if frm is not None else '*'}-"
                   f"{to if to is not None else '*'}")
        bucket_masks = []
        count = 0
        for i, seg in enumerate(segments):
            if dists[i] is None:
                bucket_masks.append(np.zeros(seg.n_docs, bool))
                continue
            d = dists[i]
            m = masks[i] & ~np.isnan(d)
            if frm is not None:
                m = m & (d >= frm * unit_m)
            if to is not None:
                m = m & (d < to * unit_m)
            bucket_masks.append(m)
            count += int(m.sum())
        bucket = {"key": key, "doc_count": count}
        if frm is not None:
            bucket["from"] = frm
        if to is not None:
            bucket["to"] = to
        bucket.update(_sub_aggs(sub, segments, ms, bucket_masks, filter_fn,
                                ext))
        buckets.append(bucket)
    if keyed:
        return {"buckets": {b.pop("key"): b for b in buckets}}
    return {"buckets": buckets}


_GEOHASH32 = "0123456789bcdefghjkmnpqrstuvwxyz"


def _geohash_cells(lat: np.ndarray, lon: np.ndarray,
                   precision: int) -> np.ndarray:
    """Vectorized geohash encode: 5*precision bisection steps as array ops
    (the bit-interleave of GeoHashUtils.longEncode), then one decode pass
    from packed int64 cell ids to strings."""
    nbits = 5 * precision
    packed = np.zeros(lat.shape, np.int64)
    lat_lo = np.full(lat.shape, -90.0)
    lat_hi = np.full(lat.shape, 90.0)
    lon_lo = np.full(lat.shape, -180.0)
    lon_hi = np.full(lat.shape, 180.0)
    for b in range(nbits):
        if b % 2 == 0:  # even bit: longitude
            mid = (lon_lo + lon_hi) / 2
            hi_half = lon >= mid
            lon_lo = np.where(hi_half, mid, lon_lo)
            lon_hi = np.where(hi_half, lon_hi, mid)
        else:
            mid = (lat_lo + lat_hi) / 2
            hi_half = lat >= mid
            lat_lo = np.where(hi_half, mid, lat_lo)
            lat_hi = np.where(hi_half, lat_hi, mid)
        packed = (packed << 1) | hi_half.astype(np.int64)
    cells = np.empty(lat.shape, object)
    shifts = [(precision - 1 - i) * 5 for i in range(precision)]
    for idx in range(lat.size):
        v = int(packed[idx])
        cells[idx] = "".join(
            _GEOHASH32[(v >> s) & 0x1F] for s in shifts)
    return cells


def _geotile_cells(lat: np.ndarray, lon: np.ndarray,
                   zoom: int) -> np.ndarray:
    """Vectorized web-mercator tile keys "z/x/y"
    (GeoTileUtils.longEncode)."""
    n = 1 << zoom
    x = np.clip(((lon + 180.0) / 360.0 * n).astype(np.int64), 0, n - 1)
    lat_r = np.radians(np.clip(lat, -85.05112878, 85.05112878))
    y_frac = (1.0 - np.log(np.tan(lat_r) + 1.0 / np.cos(lat_r))
              / np.pi) / 2.0
    y = np.clip((y_frac * n).astype(np.int64), 0, n - 1)
    cells = np.empty(lat.shape, object)
    for idx in range(lat.size):
        cells[idx] = f"{zoom}/{x[idx]}/{y[idx]}"
    return cells


def _geo_grid_agg(conf, sub, segments, ms, masks, filter_fn, ext,
                  cells_fn, default_precision) -> dict:
    field = conf["field"]
    precision = int(conf.get("precision", default_precision))
    size = int(conf.get("size", 10_000))
    cols = _geo_latlon(segments, field)

    # one vectorized cell-id pass per segment, then a bucket per distinct
    # cell (masks by array equality, no per-doc Python)
    seg_cells = []
    counts: dict[str, int] = {}
    for i, seg in enumerate(segments):
        if cols[i] is None:
            seg_cells.append(None)
            continue
        lat, lon, present = cols[i]
        m = masks[i] & present
        cells = np.empty(seg.n_docs, object)
        if m.any():
            cells[m] = cells_fn(lat[m], lon[m], precision)
        seg_cells.append((cells, m))
        uniq, cnt = np.unique(cells[m].astype(str), return_counts=True)
        for k, c in zip(uniq, cnt):
            counts[str(k)] = counts.get(str(k), 0) + int(c)
    ordered = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:size]
    buckets = []
    for key, count in ordered:
        bucket_masks = []
        for i, seg in enumerate(segments):
            if seg_cells[i] is None:
                bucket_masks.append(np.zeros(seg.n_docs, bool))
                continue
            cells, m = seg_cells[i]
            bucket_masks.append(m & (cells == key))
        bucket = {"key": key, "doc_count": count}
        bucket.update(_sub_aggs(sub, segments, ms, bucket_masks, filter_fn,
                                ext))
        buckets.append(bucket)
    return {"buckets": buckets}


def _geohash_grid(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    return _geo_grid_agg(conf, sub, segments, ms, masks, filter_fn, ext,
                         _geohash_cells, default_precision=5)


def _geotile_grid(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    return _geo_grid_agg(conf, sub, segments, ms, masks, filter_fn, ext,
                         _geotile_cells, default_precision=7)


def _geo_bounds(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    field = conf["field"]
    cols = _geo_latlon(segments, field)
    lats, lons = [], []
    for i, seg in enumerate(segments):
        if cols[i] is None:
            continue
        lat, lon, present = cols[i]
        m = masks[i] & present
        lats.append(lat[m])
        lons.append(lon[m])
    lat_all = np.concatenate(lats) if lats else np.zeros(0)
    lon_all = np.concatenate(lons) if lons else np.zeros(0)
    if lat_all.size == 0:
        return {}
    return {"bounds": {
        "top_left": {"lat": float(lat_all.max()),
                     "lon": float(lon_all.min())},
        "bottom_right": {"lat": float(lat_all.min()),
                         "lon": float(lon_all.max())},
    }}


def _geo_centroid(conf, sub, segments, ms, masks, filter_fn, ext) -> dict:
    field = conf["field"]
    cols = _geo_latlon(segments, field)
    lats, lons = [], []
    for i, seg in enumerate(segments):
        if cols[i] is None:
            continue
        lat, lon, present = cols[i]
        m = masks[i] & present
        lats.append(lat[m])
        lons.append(lon[m])
    lat_all = np.concatenate(lats) if lats else np.zeros(0)
    lon_all = np.concatenate(lons) if lons else np.zeros(0)
    if lat_all.size == 0:
        return {"count": 0}
    return {
        "location": {"lat": float(lat_all.mean()),
                     "lon": float(lon_all.mean())},
        "count": int(lat_all.size),
    }


EXTENSION_AGGS.update({
    "geo_distance": _geo_distance_agg,
    "geohash_grid": _geohash_grid,
    "geotile_grid": _geotile_grid,
    "geo_bounds": _geo_bounds,
    "geo_centroid": _geo_centroid,
})


EXTENSION_AGGS.update({
    "significant_text": _significant_text,
    "ip_range": _ip_range,
    "extended_stats": _extended_stats,
    "percentiles": _percentiles,
    "percentile_ranks": _percentile_ranks,
    "median_absolute_deviation": _median_absolute_deviation,
    "weighted_avg": _weighted_avg,
    "top_hits": _top_hits,
    "scripted_metric": _scripted_metric,
    "matrix_stats": _matrix_stats,
    "multi_terms": _multi_terms,
    "rare_terms": _rare_terms,
    "significant_terms": _significant_terms,
    "sampler": _sampler,
    "diversified_sampler": _diversified_sampler,
    "adjacency_matrix": _adjacency_matrix,
    "date_range": _date_range,
    "composite": _composite,
    "auto_date_histogram": _auto_date_histogram,
})
