"""Pipeline aggregations: reduce-time transforms over bucket streams.

The analog of search/aggregations/pipeline/ in the reference (~30 types,
SURVEY.md §2.2): sibling pipelines (avg_bucket, sum_bucket, min_bucket,
max_bucket, stats_bucket, extended_stats_bucket, percentiles_bucket)
compute a metric over another multi-bucket agg's values; parent pipelines
(derivative, cumulative_sum, moving_fn/moving_avg, serial_diff,
bucket_script, bucket_selector, bucket_sort) run inside a multi-bucket agg
and transform its bucket list in place.

Like the reference, pipelines run at final coordinator reduce
(InternalAggregations.topLevelReduce → pipeline aggregators), never
shard-side: apply_pipeline_aggs(aggs_body, results) is called once after
compute_aggs.
"""

from __future__ import annotations

import math
from typing import Any

from opensearch_tpu_torch.common.errors import IllegalArgumentException, ParsingException

PARENT_TYPES = {
    "derivative", "cumulative_sum", "moving_fn", "moving_avg", "serial_diff",
    "bucket_script", "bucket_selector", "bucket_sort",
}
SIBLING_TYPES = {
    "avg_bucket", "sum_bucket", "min_bucket", "max_bucket", "stats_bucket",
    "extended_stats_bucket", "percentiles_bucket",
}
PIPELINE_TYPES = PARENT_TYPES | SIBLING_TYPES


def validate_pipeline_aggs(aggs_body: dict, top: bool = True) -> None:
    """Request-time parameter/placement validation for pipeline aggs
    (AbstractPipelineAggregationBuilder.validate): parent pipelines cannot
    sit at the top level, and moving windows must be positive."""
    if not isinstance(aggs_body, dict):
        return
    for name, body in aggs_body.items():
        if not isinstance(body, dict):
            continue
        typ = _agg_type(body)
        if typ in PARENT_TYPES:
            conf = body.get(typ) or {}
            # parameter errors outrank placement errors (the reference
            # validates the builder before tree placement)
            if typ in ("moving_fn", "moving_avg") and \
                    int(conf.get("window", 5)) <= 0:
                raise IllegalArgumentException(
                    "[window] must be a positive, non-zero integer.")
            if top:
                raise IllegalArgumentException(
                    f"{typ} aggregation [{name}] must be declared inside "
                    f"of another aggregation")
        sub = body.get("aggs") or body.get("aggregations")
        if sub:
            validate_pipeline_aggs(sub, top=False)


def apply_pipeline_aggs(aggs_body: dict, results: dict) -> None:
    """Walk the request body and materialize pipeline aggs into `results`
    (mutated in place)."""
    if not aggs_body or not isinstance(results, dict):
        return
    # 1. recurse into sub-aggregations of concrete aggs first (inner
    #    pipelines must resolve before outer ones that may reference them)
    for name, body in aggs_body.items():
        typ = _agg_type(body)
        if typ in PIPELINE_TYPES:
            continue
        sub = body.get("aggs") or body.get("aggregations")
        target = results.get(name)
        if not sub or target is None:
            continue
        buckets = target.get("buckets")
        if isinstance(buckets, list):
            for bucket in buckets:
                apply_pipeline_aggs(sub, bucket)
            # 2. parent pipelines declared in this agg's sub level
            _apply_parent_pipelines(sub, target)
        elif isinstance(buckets, dict):  # keyed filters agg
            for bucket in buckets.values():
                apply_pipeline_aggs(sub, bucket)
        else:
            # single-bucket agg (filter/missing/global/sampler): results
            # are inlined into the agg's own dict
            apply_pipeline_aggs(sub, target)
    # 3. sibling pipelines at this level
    for name, body in aggs_body.items():
        typ = _agg_type(body)
        if typ in SIBLING_TYPES:
            results[name] = _compute_sibling(typ, body[typ], results)


def _agg_type(body: dict) -> str | None:
    for k in body:
        if k not in ("aggs", "aggregations", "meta"):
            return k
    return None


def _bucket_value(bucket: dict, path: str) -> Any:
    """Resolve "metric", "metric.prop", "agg>agg.metric", "_count" within
    one bucket (AggregationPath semantics: '>' descends into single-bucket
    sub-aggregations)."""
    if path == "_count":
        return bucket.get("doc_count")
    if path == "_key":
        return bucket.get("key")
    node: Any = bucket
    segments = path.split(">")
    for seg in segments[:-1]:
        node = node.get(seg.strip()) if isinstance(node, dict) else None
        if node is None:
            raise IllegalArgumentException(
                f"no aggregation found for path [{path}]"
            )
    name, _, prop = segments[-1].strip().partition(".")
    node = node.get(name) if isinstance(node, dict) else None
    if node is None:
        raise IllegalArgumentException(f"no aggregation found for path [{path}]")
    return node.get(prop or "value")


def _resolve_sibling_values(path: str, results: dict) -> tuple[list, list]:
    """Resolve "multi_bucket_agg>metric[.prop]" to (keys, values)."""
    segments = path.split(">")
    if len(segments) == 1 and "." in segments[0]:
        # AggregationPath also accepts "agg.metric" dotted form when the
        # head is a multi-bucket aggregation (reference: "range.v")
        head, _, tail = segments[0].partition(".")
        if isinstance(results.get(head.strip()), dict) and \
                "buckets" in results[head.strip()]:
            segments = [head, tail]
    node = results
    for seg in segments[:-1]:
        node = node.get(seg.strip()) if isinstance(node, dict) else None
        if node is None:
            raise IllegalArgumentException(f"no aggregation found for path [{path}]")
    buckets = node.get("buckets") if isinstance(node, dict) else None
    if not isinstance(buckets, list):
        raise IllegalArgumentException(
            f"buckets_path [{path}] must reference a multi-bucket aggregation"
        )
    metric = segments[-1].strip()
    keys, vals = [], []
    for b in buckets:
        keys.append(b.get("key"))
        # BucketHelpers.resolveBucketValue: an EMPTY bucket resolves to
        # NaN under the default skip gap policy (doc_count counts as a
        # value only for the _count metric)
        if metric != "_count" and b.get("doc_count") == 0:
            vals.append(None)
            continue
        vals.append(_bucket_value(b, metric))
    return keys, vals


def _skip(vals: list) -> list[float]:
    return [float(v) for v in vals if v is not None and not (
        isinstance(v, float) and math.isnan(v))]


def _compute_sibling(typ: str, conf: dict, results: dict) -> dict:
    path = conf["buckets_path"]
    keys, raw = _resolve_sibling_values(path, results)
    vals = _skip(raw)
    if typ == "avg_bucket":
        return {"value": sum(vals) / len(vals) if vals else None}
    if typ == "sum_bucket":
        return {"value": sum(vals) if vals else 0.0}
    if typ in ("min_bucket", "max_bucket"):
        if not vals:
            return {"value": None, "keys": []}
        best = min(vals) if typ == "min_bucket" else max(vals)
        best_keys = [
            _key_str(k) for k, v in zip(keys, raw)
            if v is not None and float(v) == best
        ]
        return {"value": best, "keys": best_keys}
    if typ == "stats_bucket":
        if not vals:
            return {"count": 0, "min": None, "max": None, "avg": None, "sum": 0.0}
        return {
            "count": len(vals), "min": min(vals), "max": max(vals),
            "avg": sum(vals) / len(vals), "sum": sum(vals),
        }
    if typ == "extended_stats_bucket":
        n = len(vals)
        if n == 0:
            return {"count": 0, "min": None, "max": None, "avg": None,
                    "sum": 0.0, "sum_of_squares": None, "variance": None,
                    "std_deviation": None}
        s = sum(vals)
        avg = s / n
        sos = sum(v * v for v in vals)
        var = max(sos / n - avg * avg, 0.0)
        sigma = float(conf.get("sigma", 2.0))
        std = math.sqrt(var)
        return {
            "count": n, "min": min(vals), "max": max(vals), "avg": avg,
            "sum": s, "sum_of_squares": sos, "variance": var,
            "std_deviation": std,
            "std_deviation_bounds": {"upper": avg + sigma * std,
                                     "lower": avg - sigma * std},
        }
    if typ == "percentiles_bucket":
        percents = [float(p) for p in conf.get("percents", [1, 5, 25, 50, 75, 95, 99])]
        out = {}
        sv = sorted(vals)
        for p in percents:
            if not sv:
                out[f"{p}"] = None
            else:
                idx = min(int(round((p / 100.0) * len(sv) + 0.5)) - 1, len(sv) - 1)
                out[f"{p}"] = sv[max(idx, 0)]
        return {"values": out}
    raise ParsingException(f"unknown sibling pipeline [{typ}]")


def _key_str(k: Any) -> str:
    return str(k)


def _apply_parent_pipelines(sub_body: dict, parent_result: dict) -> None:
    buckets = parent_result.get("buckets")
    if not isinstance(buckets, list):
        return
    for name, body in sub_body.items():
        typ = _agg_type(body)
        if typ not in PARENT_TYPES:
            continue
        conf = body[typ]
        if typ == "derivative":
            _derivative(name, conf, buckets)
        elif typ == "cumulative_sum":
            _cumulative_sum(name, conf, buckets)
        elif typ in ("moving_fn", "moving_avg"):
            _moving_fn(name, conf, buckets, legacy_avg=(typ == "moving_avg"))
        elif typ == "serial_diff":
            _serial_diff(name, conf, buckets)
        elif typ == "bucket_script":
            _bucket_script(name, conf, buckets)
        elif typ == "bucket_selector":
            _bucket_selector(conf, buckets, parent_result)
        elif typ == "bucket_sort":
            _bucket_sort(conf, buckets, parent_result)


def _path_values(buckets: list, path: str) -> list:
    return [_bucket_value(b, path) for b in buckets]


def _derivative(name: str, conf: dict, buckets: list) -> None:
    path = conf["buckets_path"]
    unit_ms = None
    if conf.get("unit"):
        from opensearch_tpu_torch.common.settings import parse_time_millis

        unit_ms = float(parse_time_millis(conf["unit"]))
    vals = _path_values(buckets, path)
    for i, b in enumerate(buckets):
        if i == 0 or vals[i] is None or vals[i - 1] is None:
            continue
        diff = float(vals[i]) - float(vals[i - 1])
        entry = {"value": diff}
        if unit_ms is not None:
            key_diff = float(buckets[i]["key"]) - float(buckets[i - 1]["key"])
            if key_diff > 0:
                entry["normalized_value"] = diff / (key_diff / unit_ms)
        b[name] = entry


def _cumulative_sum(name: str, conf: dict, buckets: list) -> None:
    path = conf["buckets_path"]
    total = 0.0
    for b in buckets:
        v = _bucket_value(b, path)
        if v is not None:
            total += float(v)
        b[name] = {"value": total}


def _serial_diff(name: str, conf: dict, buckets: list) -> None:
    path = conf["buckets_path"]
    lag = int(conf.get("lag", 1))
    vals = _path_values(buckets, path)
    for i, b in enumerate(buckets):
        if i < lag or vals[i] is None or vals[i - lag] is None:
            continue
        b[name] = {"value": float(vals[i]) - float(vals[i - lag])}


class _MovingFunctions:
    """The MovingFunctions builtin namespace for moving_fn scripts."""

    @staticmethod
    def _call(name: str, args: list):
        values = [v for v in (args[0] if args else []) if v is not None]
        if name == "max":
            return max(values) if values else None
        if name == "min":
            return min(values) if values else None
        if name == "sum":
            return sum(values) if values else 0.0
        if name == "unweightedAvg":
            return sum(values) / len(values) if values else None
        if name == "stdDev":
            if not values:
                return None
            avg = args[1] if len(args) > 1 else sum(values) / len(values)
            return math.sqrt(sum((v - avg) ** 2 for v in values) / len(values))
        if name == "linearWeightedAvg":
            if not values:
                return None
            num = sum(v * (i + 1) for i, v in enumerate(values))
            den = sum(range(1, len(values) + 1))
            return num / den
        if name == "ewma":
            if not values:
                return None
            alpha = args[1] if len(args) > 1 else 0.3
            avg = values[0]
            for v in values[1:]:
                avg = alpha * v + (1 - alpha) * avg
            return avg
        if name == "holt":
            if len(values) < 2:
                return values[0] if values else None
            alpha = args[1] if len(args) > 1 else 0.3
            beta = args[2] if len(args) > 2 else 0.1
            level, trend = values[0], values[1] - values[0]
            for v in values[1:]:
                last = level
                level = alpha * v + (1 - alpha) * (level + trend)
                trend = beta * (level - last) + (1 - beta) * trend
            return level + trend
        raise IllegalArgumentException(f"unknown MovingFunctions.{name}")

    def methods(self, name: str, args: list):
        return self._call(name, args)


def _moving_fn(name: str, conf: dict, buckets: list, legacy_avg: bool = False) -> None:
    from opensearch_tpu_torch.script.painless import Evaluator
    from opensearch_tpu_torch.script.service import default_script_service as svc

    path = conf["buckets_path"]
    window = int(conf.get("window", 5))
    shift = int(conf.get("shift", 0))
    vals = _path_values(buckets, path)
    if legacy_avg:
        script_src = "MovingFunctions.unweightedAvg(values)"
        params: dict = {}
    else:
        script = conf.get("script")
        if script is None:
            raise ParsingException("moving_fn requires a script")
        script_src = script if isinstance(script, str) else script.get("source", "")
        params = {} if isinstance(script, str) else (script.get("params") or {})
    ast, p = svc.compile(script_src)
    mf = _MovingFunctions()
    for i, b in enumerate(buckets):
        lo = max(0, i - window + shift)
        hi = max(0, i + shift)
        win = [float(v) for v in vals[lo:hi] if v is not None]
        env = {"values": win, "MovingFunctions": mf, "params": {**params, **p}}
        out = Evaluator(env).run(ast)
        b[name] = {"value": out if win else None}


def _bucket_script(name: str, conf: dict, buckets: list) -> None:
    from opensearch_tpu_torch.script.painless import Evaluator
    from opensearch_tpu_torch.script.service import default_script_service as svc

    paths = conf["buckets_path"]
    if not isinstance(paths, dict):
        paths = {"_value": paths}
    script = conf.get("script")
    script_src = script if isinstance(script, str) else (script or {}).get("source", "")
    s_params = {} if isinstance(script, str) else ((script or {}).get("params") or {})
    ast, p = svc.compile(script_src)
    gap_policy = conf.get("gap_policy", "skip")
    for b in buckets:
        params = {**s_params, **p}
        missing = False
        for var, path in paths.items():
            v = _bucket_value(b, path)
            if v is None:
                if gap_policy == "insert_zeros":
                    v = 0.0
                else:
                    missing = True
                    break
            params[var] = float(v)
        if missing:
            continue
        env = {"params": params}
        if "_value" in params:
            env["_value"] = params["_value"]
        out = Evaluator(env).run(ast)
        if out is not None:
            b[name] = {"value": float(out)}


def _bucket_selector(conf: dict, buckets: list, parent_result: dict) -> None:
    from opensearch_tpu_torch.script.painless import Evaluator
    from opensearch_tpu_torch.script.service import default_script_service as svc

    paths = conf["buckets_path"]
    if not isinstance(paths, dict):
        paths = {"_value": paths}
    script = conf.get("script")
    script_src = script if isinstance(script, str) else (script or {}).get("source", "")
    s_params = {} if isinstance(script, str) else ((script or {}).get("params") or {})
    ast, p = svc.compile(script_src)
    keep = []
    for b in buckets:
        params = {**s_params, **p}
        missing = False
        for var, path in paths.items():
            v = _bucket_value(b, path)
            if v is None:
                missing = True
                break
            params[var] = float(v)
        if missing:
            continue
        env = {"params": params}
        if "_value" in params:
            env["_value"] = params["_value"]
        if Evaluator(env).run(ast):
            keep.append(b)
    parent_result["buckets"] = keep


def _bucket_sort(conf: dict, buckets: list, parent_result: dict) -> None:
    sorts = conf.get("sort") or []
    if isinstance(sorts, (str, dict)):
        sorts = [sorts]
    from_ = int(conf.get("from", 0))
    size = conf.get("size")

    def sort_key(b):
        parts = []
        for s in sorts:
            if isinstance(s, str):
                path, order = s, "asc"
            else:
                path = next(iter(s))
                body = s[path]
                order = body.get("order", "asc") if isinstance(body, dict) else body
            v = _bucket_value(b, path)
            desc = order == "desc"
            if v is None:
                parts.append((1, 0))
            else:
                parts.append((0, -float(v) if desc else float(v)))
        return tuple(parts)

    out = sorted(buckets, key=sort_key) if sorts else list(buckets)
    out = out[from_:]
    if size is not None:
        out = out[: int(size)]
    parent_result["buckets"] = out
