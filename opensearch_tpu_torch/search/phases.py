"""Coordinator-adjacent search phases: can_match, rescore, collapse.

Counterpart of opensearch_tpu/search/phases.py, a host-only copy with its
imports pointed at this package; the reference's tracing spans around
each phase are left out with the rest of its telemetry.

- can_match: shard skipping by provable non-match — range/term constraints
  against per-segment numeric min/max (the reference's coordinator
  pre-filter, action/search/CanMatchPreFilterSearchPhase.java, backed by
  the min/max rewrite of range queries over BKD metadata).
- rescore: second-pass re-ranking of the top window
  (search/rescore/RescorePhase.java + QueryRescorer: combined =
  query_weight * first + rescore_query_weight * second per score_mode).
- collapse: first-hit-per-group on a field (search/collapse/
  CollapseContext.java reduced to its serving core).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from opensearch_tpu_torch.common.errors import ParsingException
from opensearch_tpu_torch.search import query_dsl as q


# --------------------------------------------------------------------- #
# can_match
# --------------------------------------------------------------------- #


def _range_constraints(node: Any) -> list[q.RangeQuery]:
    """Conjunctive range constraints provable from the query root."""
    if isinstance(node, q.RangeQuery):
        return [node]
    if isinstance(node, q.BoolQuery):
        out: list[q.RangeQuery] = []
        for child in list(node.must) + list(node.filter):
            out.extend(_range_constraints(child))
        return out
    return []


def _segment_minmax(host, field: str) -> tuple[float, float] | None:
    cache = getattr(host, "_minmax_cache", None)
    if cache is None:
        cache = {}
        host._minmax_cache = cache
    if field in cache:
        return cache[field]
    nf = host.numeric_fields.get(field)
    out = None
    if nf is not None:
        vals = nf.values_i64 if nf.kind == "int" else nf.values_f64
        present = nf.present & host.live[: len(nf.present)]
        if present.any():
            v = vals[present]
            # int columns stay python ints: epoch NANOS overflow float64's
            # mantissa and a rounded max can wrongly prove "no match"
            if nf.kind == "int":
                out = (int(v.min()), int(v.max()))
            else:
                out = (float(v.min()), float(v.max()))
        else:
            out = "empty"
    cache[field] = out
    return out


def can_match(snapshot, mapper_service, node: Any) -> bool:
    """False only when the shard PROVABLY has no matching doc. Unknown
    fields/types return True (conservative, like the reference's rewrite
    returning MatchAllDocs when it cannot prove otherwise)."""
    constraints = _range_constraints(node)
    if not constraints:
        return True
    return _can_match_constrained(snapshot, mapper_service, constraints)


def _can_match_constrained(snapshot, mapper_service, constraints) -> bool:
    if not snapshot.segments:
        # a shard with buffered-but-unrefreshed docs still can't serve them;
        # empty searchable set only provably non-matching if no constraint
        # is needed — keep executing (cheap on an empty shard)
        return True
    for rq in constraints:
        mapper = mapper_service.field_mapper(rq.field)
        if mapper is None or mapper.type not in (
            "long", "integer", "short", "byte", "double", "float", "date",
        ):
            continue
        lo, hi = None, None
        try:
            if mapper.type == "date":
                from opensearch_tpu_torch.index.mapper import (
                    parse_date_millis,
                    parse_date_nanos,
                )

                conv = (parse_date_nanos
                        if getattr(mapper, "resolution", "millis") == "nanos"
                        else parse_date_millis)
            elif getattr(mapper, "original_type", None) == "unsigned_long":
                # biased int64 storage (see mapper unsigned_long handling)
                conv = lambda v: int(str(v), 10) - 2**63  # noqa: E731
            else:
                conv = float
            if rq.gte is not None:
                lo = conv(rq.gte)
            if rq.gt is not None:
                lo = conv(rq.gt)
            if rq.lte is not None:
                hi = conv(rq.lte)
            if rq.lt is not None:
                hi = conv(rq.lt)
        except (TypeError, ValueError):
            continue
        any_segment_matches = False
        for host, _dev in snapshot.segments:
            mm = _segment_minmax(host, rq.field)
            if mm is None:
                # field absent in this segment: range can't match here
                continue
            if mm == "empty":
                continue
            smin, smax = mm
            if lo is not None:
                bound_ok = smax > lo if rq.gt is not None else smax >= lo
                if not bound_ok:
                    continue
            if hi is not None:
                bound_ok = smin < hi if rq.lt is not None else smin <= hi
                if not bound_ok:
                    continue
            any_segment_matches = True
            break
        if not any_segment_matches:
            return False
    return True


# --------------------------------------------------------------------- #
# rescore
# --------------------------------------------------------------------- #

_SCORE_MODES = {
    "total": lambda a, b: a + b,
    "multiply": lambda a, b: a * b,
    "avg": lambda a, b: (a + b) / 2.0,
    "max": max,
    "min": min,
}


def apply_rescore(rescore_body, merged, per_shard_results, shards):
    """Re-rank the top window of `merged` ([(shard_idx, ShardHit)] sorted by
    score desc). Each rescore stage computes the rescore query's scores for
    window docs and combines per score_mode; hits outside the window keep
    their order below the window (RescorePhase contract)."""
    stages = rescore_body if isinstance(rescore_body, list) else [rescore_body]
    return _apply_rescore_stages(stages, merged, per_shard_results, shards)


def _apply_rescore_stages(stages, merged, per_shard_results, shards):
    from opensearch_tpu_torch.search.executor import (
        SegmentExecutor,
        ShardContext,
    )

    for stage in stages:
        if not isinstance(stage, dict) or "query" not in stage:
            raise ParsingException("[rescore] requires a [query] object")
        window = int(stage.get("window_size", 10))
        conf = stage["query"]
        rq_body = conf.get("rescore_query")
        if rq_body is None:
            raise ParsingException("[rescore] requires [query.rescore_query]")
        qw = float(conf.get("query_weight", 1.0))
        rw = float(conf.get("rescore_query_weight", 1.0))
        mode = str(conf.get("score_mode", "total"))
        combine = _SCORE_MODES.get(mode)
        if combine is None:
            raise ParsingException(f"unknown rescore score_mode [{mode}]")
        rq_node = q.parse_query(rq_body)

        # lazily computed rescore scores per (shard_idx, segment)
        score_cache: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}

        def rescore_scores(shard_idx: int, seg_idx: int):
            key = (shard_idx, seg_idx)
            if key not in score_cache:
                shard, snapshot, _res = per_shard_results[shard_idx]
                host, dev = snapshot.segments[seg_idx]
                ctx = ShardContext(snapshot, shard.mapper_service)
                result = SegmentExecutor(ctx, host, dev).execute(rq_node)
                score_cache[key] = (
                    result.scores.cpu().numpy(), result.mask.cpu().numpy()
                )
            return score_cache[key]

        head = merged[:window]
        rescored = []
        for shard_idx, hit in head:
            scores, mask = rescore_scores(shard_idx, hit.segment)
            if mask[hit.doc]:
                new = combine(qw * hit.score, rw * float(scores[hit.doc]))
            else:
                new = qw * hit.score
            from dataclasses import replace

            rescored.append((shard_idx, replace(hit, score=new)))
        rescored.sort(
            key=lambda sh: (-sh[1].score, sh[0], sh[1].segment, sh[1].doc)
        )
        merged = rescored + merged[window:]
    return merged


# --------------------------------------------------------------------- #
# collapse
# --------------------------------------------------------------------- #


def doc_field_value(host, field: str, doc: int, mapper_service):
    kf = host.keyword_fields.get(field)
    if kf is not None:
        o = int(kf.first_ord[doc])
        return kf.ord_values[o] if o >= 0 else None
    nf = host.numeric_fields.get(field)
    if nf is not None:
        if not nf.present[doc]:
            return None
        v = nf.values_i64[doc] if nf.kind == "int" else nf.values_f64[doc]
        return int(v) if nf.kind == "int" else float(v)
    return None


def apply_collapse(collapse_body, merged, per_shard_results):
    """Keep the first (best-ranked) hit per distinct field value; docs
    without the field each form their own group (reference: null group).
    `inner_hits` specs expand each kept hit's group (CollapseContext +
    ExpandSearchPhase — here the group members are already in hand, so the
    expansion is a sort+slice instead of a follow-up msearch)."""
    if not isinstance(collapse_body, dict) or not collapse_body.get("field"):
        raise ParsingException("[collapse] requires a [field]")
    return _apply_collapse_inner(collapse_body, merged, per_shard_results)


def _apply_collapse_inner(collapse_body, merged, per_shard_results):
    field = collapse_body["field"]
    inner_specs = collapse_body.get("inner_hits") or []
    if isinstance(inner_specs, dict):
        inner_specs = [inner_specs]
    groups: dict = {}
    hit_values = []
    for shard_idx, hit in merged:
        shard, snapshot, _res = per_shard_results[shard_idx]
        host, _dev = snapshot.segments[hit.segment]
        value = doc_field_value(host, field, hit.doc, shard.mapper_service)
        hit_values.append(value)
        if value is not None:
            groups.setdefault(value, []).append((shard_idx, hit))
    seen: set = set()
    out = []
    values = []
    inner = []
    for (shard_idx, hit), value in zip(merged, hit_values):
        if value is not None:
            if value in seen:
                continue
            seen.add(value)
        out.append((shard_idx, hit))
        values.append(value)
        if not inner_specs:
            inner.append(None)
            continue
        members = groups.get(value, [(shard_idx, hit)])
        per_name = {}
        for spec in inner_specs:
            if "collapse" in spec:
                from opensearch_tpu_torch.common.errors import ParseException

                raise ParseException(
                    "cannot use `collapse` inside `inner_hits`"
                )
            name = spec.get("name") or field
            cand = list(members)
            sort = spec.get("sort")
            if sort:
                sort_l = [sort] if isinstance(sort, (str, dict)) else list(sort)
                cand.sort(key=_inner_sort_key(sort_l, per_shard_results))
            else:
                cand.sort(key=lambda sh: (-sh[1].score, sh[0],
                                          sh[1].segment, sh[1].doc))
            frm = int(spec.get("from", 0))
            sel = cand[frm: frm + int(spec.get("size", 3))]
            per_name[name] = {"total": len(members), "hits": sel,
                              "spec": spec}
        inner.append(per_name)
    return out, field, values, inner


def _inner_sort_key(sort_l, per_shard_results):
    from opensearch_tpu_torch.search.executor import _sort_spec, _StrKey

    specs = [_sort_spec(sp) for sp in sort_l]

    def key(sh):
        s_i, h_ = sh
        shard, snapshot, _res = per_shard_results[s_i]
        host, _dev = snapshot.segments[h_.segment]
        parts = []
        for fname, order, missing in specs:
            if fname == "_score":
                parts.append(-h_.score if order == "desc" else h_.score)
                continue
            v = doc_field_value(host, fname, h_.doc, shard.mapper_service)
            if v is None:
                parts.append((-1, 0) if missing == "_first" else (1, 0))
            elif isinstance(v, str):
                parts.append((0, _StrKey(v, order == "desc")))
            else:
                parts.append((0, -v if order == "desc" else v))
        parts.append((s_i, h_.segment, h_.doc))
        return tuple(parts)

    return key
