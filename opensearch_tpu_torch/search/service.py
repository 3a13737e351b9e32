"""Search service: query phase -> merge -> fetch phase -> response.

Counterpart of opensearch_tpu/search/service.py: any parsed query
(search/executor.py), ``slice`` (a murmur3 partition of ``_id`` ANDed
into the query as a filter), aggregations (``aggs`` /
``aggregations``, below), ``suggest`` (search/suggest.py, host term
dictionaries), ``sort`` (with
``_score`` and ``_doc``; ``_shard_doc`` needs a point in time, which the
node does not keep yet) and ``search_after``,
``track_total_hits``, ``min_score``, ``indices_boost``,
``pre_filter_shard_size`` with ``can_match``, ``rescore``, ``collapse``,
named queries (``matched_queries``, ``include_named_queries_score``),
``timeout``, ``stats`` and ``profile``; and msearch's batching of bare kNN
bodies (:func:`msearch_groups`, :func:`try_batched_knn_msearch`: B
bodies' query phase in one stacked launch, handed to :func:`search` as
``precomputed_results``).

A ``hybrid`` query is the reference's hybrid query phase: each
sub-query's query phase runs apart a shard (``execute_query_phase``, the
per-shard route: never the stacked step), then
search/pipeline.fuse_hybrid_results fuses the sub-queries' scores over
every shard under the search pipeline's phase-results processor, then the
merge and fetch.

The route is the reference's ``_try_distributed_query_phase`` choice: a
bare ``knn`` query takes the stacked serving step
(search/distributed_serving.mesh_knn_batch) unless it is switched off, a
``min_score``, ``sort`` or ``search_after`` is set, or the step declines
(an ANN-indexed column); every other query, and those, take the per-shard
route (as does any body with aggregations, since the step returns no
per-segment masks): ``phases.can_match`` (the rewrite step), then
search/executor.execute_query_phase per shard (whose kNN launches go
through the dispatch batcher), the host merge by (-score, shard, segment,
doc) or by the sort key, the ``search_after`` cut, rescore and collapse.
A request key the reference does not know is a ParsingException (400),
as there.

Aggregations are the reference's reduce (search/aggs.py, aggs_ext.py,
aggs_pipeline.py, host numpy): the pipeline bodies are validated at parse
time, the query phase keeps each segment's host match mask and scores
(``need_masks``; a shard that ``can_match`` skips gets zero arrays), and
one ``compute_aggs`` pass over every shard's segments computes the
response's ``aggregations``; a ``filter`` body runs through the segment's
executor and comes back to the host. Then the pipeline aggregations, then
the ``search.max_buckets`` guard (:class:`TooManyBucketsException`, 503).

The fetch phase is the reference's (its sub-phases in search/fetch.py):
``_source`` includes / excludes, ``stored_fields`` (``_none_`` drops
``_id`` and ``_source``; stored fields without an explicit ``_source``
suppress it), ``docvalue_fields``, ``fields``, ``script_fields`` (one
painless evaluation a hit on the host), ``highlight``, ``explain``,
``version`` and ``seq_no_primary_term`` (read from the snapshot's
seal-time doc values), ``sort`` values, ``matched_queries`` and a
collapsed hit's field and ``inner_hits``. ``"profile": true`` builds the
reference's ``profile.shards[*]`` tree (search/profile.py): the stacked
step's one launch shared across its shards (``record_sharded_launch``),
or the per-shard route's operators, kernels and collector, with
``can_match`` as the rewrite time, the aggregation tree with each
aggregation's collector time, and the fetch sub-phases. The response has
the reference's shape.
"""

from __future__ import annotations

import fnmatch
import json
import time
from typing import Any

import numpy as np

from opensearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    ParsingException,
)
from opensearch_tpu_torch.script import default_script_service
from opensearch_tpu_torch.search import distributed_serving, fetch, phases
from opensearch_tpu_torch.search import profile as search_profile
from opensearch_tpu_torch.search import query_dsl
from opensearch_tpu_torch.search.aggs import compute_aggs
from opensearch_tpu_torch.search.aggs_pipeline import (
    PIPELINE_TYPES,
    apply_pipeline_aggs,
    validate_pipeline_aggs,
)
from opensearch_tpu_torch.search.executor import (
    SegmentExecutor,
    ShardContext,
    ShardQueryResult,
    _sort_key_fn,
    _sort_spec,
    _StrKey,
    execute_query_phase,
    host_mask,
)
from opensearch_tpu_torch.search.pipeline import fuse_hybrid_results
from opensearch_tpu_torch.search.suggest import compute_suggest

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


def _sort_has_score(sort) -> bool:
    return any(
        (spec if isinstance(spec, str) else next(iter(spec), None))
        == "_score" for spec in (sort or []))


def search(shards: list, body: dict | None,
           precomputed_results: list | None = None,
           phase_results_config: dict | None = None) -> dict[str, Any]:
    """Run one search over `shards` (IndexShard objects).
    `precomputed_results`, one (shard, snapshot, ShardQueryResult) a shard
    in order, is this body's query phase already run by a batched msearch
    launch (:func:`try_batched_knn_msearch`): the search merges and fetches
    from it, on its snapshots, and runs no query phase.
    `phase_results_config` is the search pipeline's phase-results
    processor, which fuses a hybrid query's sub-queries."""
    t0 = time.monotonic()
    body = body or {}
    unknown = set(body) - KNOWN_KEYS
    if unknown:
        raise ParsingException(f"unknown search request keys {sorted(unknown)}")
    node = query_dsl.parse_query(body.get("query"))
    if body.get("slice") is not None:
        # a sliced read: the doc space partitioned by murmur3(_id) % max
        # (search/slice/SliceBuilder.java)
        sl = body["slice"]
        sl_max = int(sl.get("max", 1))
        sl_id = int(sl.get("id", 0))
        if not 0 <= sl_id < sl_max:
            raise ParsingException(
                f"[slice.id] must be in [0, {sl_max}) but was {sl_id}")
        node = query_dsl.BoolQuery(
            must=[node], filter=[query_dsl.SliceQuery(id=sl_id, max=sl_max)])
    size = int(body.get("size", DEFAULT_SIZE))
    from_ = int(body.get("from", 0))
    if size < 0 or from_ < 0:
        raise ParsingException("[size] and [from] must be >= 0")
    sort = body.get("sort")
    if isinstance(sort, (str, dict)):
        sort = [sort]
    aggs_body = body.get("aggs") or body.get("aggregations")
    if aggs_body:
        validate_pipeline_aggs(aggs_body)
    min_score = body.get("min_score")
    search_after = body.get("search_after")
    if search_after is not None and not sort:
        raise ParsingException("[search_after] requires [sort] to be set")
    if search_after is not None and from_ > 0:
        raise ParsingException(
            "[from] parameter must be set to 0 when [search_after] is used")
    track_total = body.get("track_total_hits", True)
    want_profile = bool(body.get("profile"))
    fetch_k = from_ + size
    if body.get("rescore") is not None:
        # the query phase must collect the whole rescore window
        stages = body["rescore"]
        for stage in (stages if isinstance(stages, list) else [stages]):
            if isinstance(stage, dict):
                fetch_k = max(fetch_k, int(stage.get("window_size", 10)))

    # one deep profiler per shard (search/profile.ShardProfiler)
    shard_profilers: list = []
    shard_query_ns: list[int] = []
    skipped_shards = 0
    premerged = None
    if isinstance(node, query_dsl.HybridQuery):
        per_shard_results = _hybrid_query_phase(
            shards, node, fetch_k, min_score, aggs_body, sort, search_after,
            phase_results_config, want_profile, shard_profilers,
            shard_query_ns)
    elif precomputed_results is not None:
        per_shard_results = precomputed_results
    else:
        snaps = [s.acquire_searcher() for s in shards]
        out = _try_distributed_query_phase(
            shards, snaps, node, fetch_k, min_score, sort=sort,
            search_after=search_after, aggs_body=aggs_body)
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
            per_shard_results = []
            for shard, snap in zip(shards, snaps):
                prof = (search_profile.ShardProfiler()
                        if want_profile else None)
                # can_match (CanMatchPreFilterSearchPhase): skip a shard
                # whose segment min / max PROVE no doc matches; it is this
                # engine's rewrite step
                t_rw = time.perf_counter_ns()
                matched = phases.can_match(snap, shard.mapper_service, node)
                if prof is not None:
                    prof.rewrite_ns += time.perf_counter_ns() - t_rw
                if not matched:
                    skipped_shards += 1
                    if want_profile:
                        shard_query_ns.append(0)
                        shard_profilers.append(prof)
                    # the aggregations read one mask and one score array
                    # a segment, matched or not
                    per_shard_results.append((shard, snap, ShardQueryResult(
                        hits=[], total=0, max_score=None,
                        masks=[np.zeros(h.n_docs, bool)
                               for h, _d in snap.segments]
                        if aggs_body is not None else [],
                        score_arrays=[np.zeros(h.n_docs, np.float32)
                                      for h, _d in snap.segments]
                        if aggs_body is not None else [])))
                    continue
                t_q = time.perf_counter_ns()
                with search_profile.profiling(prof):
                    result = execute_query_phase(
                        snap, shard.mapper_service, node,
                        # a search_after cursor can reach arbitrarily deep
                        # into a shard: every matching doc of the shard
                        size=(snap.max_doc if search_after is not None
                              else fetch_k),
                        sort=sort, need_masks=aggs_body is not None,
                        min_score=(float(min_score) if min_score is not None
                                   else None))
                if want_profile:
                    shard_query_ns.append(time.perf_counter_ns() - t_q)
                    shard_profilers.append(prof)
                per_shard_results.append((shard, snap, result))

    # ---- reduce: the device merge's order, the host merge by (-score,
    # shard, segment, doc), or the sort key ----
    # indices_boost ({index: factor}, resolved by the node): a per-index
    # score factor applied before the cross-shard merge (a query-level
    # boost on each shard)
    index_boosts = body.get("indices_boost")
    if not isinstance(index_boosts, dict):
        index_boosts = {}
    if index_boosts:
        for shard, _snap, result in per_shard_results:
            factor = index_boosts.get(shard.shard_id.index)
            if factor is None or factor == 1.0:
                continue
            for h in result.hits:
                h.score *= factor
            if result.max_score is not None:
                result.max_score *= factor
    total = 0
    max_score = None
    merged: list = []
    for shard_idx, (_shard, _snap, result) in enumerate(per_shard_results):
        total += result.total
        if result.max_score is not None and (
                max_score is None or result.max_score > max_score):
            max_score = result.max_score
        merged.extend((shard_idx, h) for h in result.hits)
    if sort:
        key_fn = _sort_key_fn(sort)
        merged.sort(key=lambda sh: key_fn(sh[1]))
        if search_after is not None:
            ms_view = _MultiMapperView([s.mapper_service for s in shards])
            cursor = _search_after_key(
                sort, _coerce_search_after(sort, search_after, ms_view)
                if shards else search_after)
            merged = [sh for sh in merged
                      if _sort_values_key(sort, sh[1]) > cursor]
    elif premerged is not None and not index_boosts:
        # the device merge's rows are already in (-score, shard, segment,
        # doc) order
        merged = premerged
    else:
        merged.sort(key=lambda sh: (-sh[1].score, sh[0], sh[1].segment,
                                    sh[1].doc))
    collapse = None
    if body.get("rescore") is not None:
        if sort:
            raise ParsingException("[rescore] cannot be used with a [sort]")
        merged = phases.apply_rescore(body["rescore"], merged,
                                      per_shard_results, shards)
    if body.get("collapse") is not None:
        merged, *collapse = phases.apply_collapse(
            body["collapse"], merged, per_shard_results)
    page = merged[from_: from_ + size]

    fetch_prof = (search_profile.FetchProfiler(len(per_shard_results))
                  if want_profile else None)
    hits_json = _fetch_phase(body, node, shards, per_shard_results, page,
                             fetch_prof, sort=sort, from_=from_,
                             collapse=collapse)

    sort_by_score = bool(sort) and _sort_has_score(sort)
    if sort_by_score and max_score is None and merged:
        max_score = max(h.score for _i, h in merged)
    hits_obj: dict[str, Any] = {
        "max_score": max_score if (not sort or sort_by_score) else None,
        "hits": hits_json,
    }
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
        "_shards": {
            "total": len(shards), "successful": len(shards),
            # the reference pre-filters (and reports skips) only at
            # pre_filter_shard_size (default 128) shards or more; below it
            # can_match runs inside the query phase and skipped stays 0
            "skipped": (skipped_shards if len(shards) >= int(
                body.get("pre_filter_shard_size", 128) or 128) else 0),
            "failed": 0},
        "hits": hits_obj,
    }
    agg_profiler = None
    if aggs_body:
        agg_profiler = (search_profile.ShardProfiler() if want_profile
                        else None)
        response["aggregations"] = _aggregations(
            aggs_body, shards, per_shard_results, agg_profiler)
    if body.get("suggest"):
        response["suggest"] = compute_suggest(
            body["suggest"],
            [snap.segments for _, snap, _ in per_shard_results],
            [s.mapper_service for s in shards])
    if want_profile:
        response["profile"] = _profile_response(
            body, node, per_shard_results, shard_profilers, shard_query_ns,
            fetch_prof, response.get("aggregations"), agg_profiler)
    return response


def _hybrid_query_phase(shards: list, node, fetch_k: int,
                        min_score, aggs_body, sort, search_after,
                        phase_results_config: dict | None,
                        want_profile: bool, shard_profilers: list,
                        shard_query_ns: list) -> list:
    """The hybrid query phase (reference search/service.py): one
    execute_query_phase a sub-query a shard on the per-shard route, then
    the scores fused over every shard by the pipeline's phase-results
    processor (search/pipeline.fuse_hybrid_results) before the merge."""
    if sort:
        raise ParsingException("[sort] is not supported with [hybrid] query")
    if search_after is not None:
        raise ParsingException(
            "[search_after] is not supported with [hybrid] query")
    shard_snaps = []
    per_shard_subs = []
    for shard in shards:
        snapshot = shard.acquire_searcher()
        prof = search_profile.ShardProfiler() if want_profile else None
        t_q = time.perf_counter_ns()
        with search_profile.profiling(prof):
            per_shard_subs.append([
                execute_query_phase(
                    snapshot, shard.mapper_service, sub, size=fetch_k,
                    need_masks=aggs_body is not None,
                    min_score=(float(min_score) if min_score is not None
                               else None))
                for sub in node.queries])
        if want_profile:
            shard_query_ns.append(time.perf_counter_ns() - t_q)
            shard_profilers.append(prof)
        shard_snaps.append((shard, snapshot))
    fused = fuse_hybrid_results(per_shard_subs, phase_results_config,
                                fetch_k)
    return [(shard, snap, res)
            for (shard, snap), res in zip(shard_snaps, fused)]


def _aggregations(aggs_body: dict, shards: list, per_shard_results: list,
                  agg_profiler) -> dict:
    """The reference's aggregation reduce: every shard's segments in ONE
    ``compute_aggs`` pass over the query phase's host masks and scores,
    then the pipeline aggregations, then the ``search.max_buckets``
    guard. A ``filter``, ``filters`` or ``adjacency_matrix`` body runs
    through the segment's executor (``filter_fn``), its mask brought to
    the host and cut to the segment's docs."""
    all_segments = []
    all_masks = []
    all_scores = []
    seg_meta = []
    seg_ctx: list[tuple[ShardContext, int]] = []
    for shard, snapshot, result in per_shard_results:
        ctx = ShardContext(snapshot, shard.mapper_service)
        for seg_i, (host, _dev) in enumerate(snapshot.segments):
            all_segments.append(host)
            all_masks.append(result.masks[seg_i])
            all_scores.append(result.score_arrays[seg_i]
                              if seg_i < len(result.score_arrays) else None)
            seg_meta.append({"index": shard.shard_id.index})
            seg_ctx.append((ctx, seg_i))

    def filter_fn(filter_body: dict, flat_idx: int) -> np.ndarray:
        ctx, seg_i = seg_ctx[flat_idx]
        host, dev = ctx.snapshot.segments[seg_i]
        r = SegmentExecutor(ctx, host, dev).execute(
            query_dsl.parse_query(filter_body))
        mask = host_mask(r)
        return mask[: host.n_docs]

    # a multi-index search resolves field types across every index's
    # mappings (the first index to map the field wins)
    mapper_service = _MultiMapperView([s.mapper_service for s in shards])
    # the aggregations reduce across every shard's segments in one pass,
    # so their collector times are request-level: one profiler for them
    with search_profile.profiling(agg_profiler):
        aggs = compute_aggs(
            all_segments, mapper_service, aggs_body, all_masks, filter_fn,
            ext={"scores": all_scores, "seg_meta": seg_meta,
                 "partial": False})
    apply_pipeline_aggs(aggs_body, aggs)
    n_buckets = _count_buckets(aggs)
    if n_buckets > MAX_BUCKETS:
        raise TooManyBucketsException(n_buckets)
    return aggs


def _fetch_phase(body: dict, node, shards: list, per_shard_results: list,
                 page: list, fetch_prof, sort: list | None = None,
                 from_: int = 0, collapse: list | None = None) -> list[dict]:
    """The reference's fetch phase for the winning docs: each hit's
    metadata, then the sub-phases the request asks for (search/fetch.py),
    timed per shard when `fetch_prof` is set; each hit's sort values,
    named queries and, with `collapse` (field, values, inner hits), its
    collapse field and inner hits."""
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
    script_fields = body.get("script_fields") or {}
    compiled_scripts = {
        sf_name: default_script_service.compile(
            (sf_conf or {}).get("script") or {})
        for sf_name, sf_conf in script_fields.items()}
    want_explain = bool(body.get("explain"))
    want_version = bool(body.get("version"))
    want_seqno = bool(body.get("seq_no_primary_term"))
    preds_by_field: dict = {}
    if highlight_conf:
        preds_by_field = fetch.field_term_predicates(
            node, _MultiMapperView([s.mapper_service for s in shards]))
    named_nodes = _named_nodes(body, node)
    include_nq_scores = str(
        body.get("include_named_queries_score", "false")).lower() in (
            "true", "")
    named_cache: dict = {}
    collapse_field, collapse_values, collapse_inner = collapse or (
        None, None, None)
    now_ns = time.perf_counter_ns
    hits_json = []
    for page_i, (shard_idx, h) in enumerate(page):
        shard, snapshot, _result = per_shard_results[shard_idx]
        host = snapshot.segments[h.segment][0]
        ms = shard.mapper_service
        if fetch_prof is not None:
            fetch_prof.hit(shard_idx)
        hit: dict[str, Any] = {
            "_index": shard.shard_id.index,
            "_id": host.doc_ids[h.doc],
            "_score": h.score if (not sort or _sort_has_score(sort))
            else None,
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
        if sort:
            hit["sort"] = h.sort_values
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
        if compiled_scripts:
            t0 = now_ns() if fetch_prof is not None else 0
            for sf_name, (ast, sf_params) in compiled_scripts.items():
                val = default_script_service.field(
                    ast, sf_params, host, h.doc, ms, source=raw_source)
                hit.setdefault("fields", {})[sf_name] = (
                    val if isinstance(val, list) else [val])
            if fetch_prof is not None:
                fetch_prof.add(shard_idx, "script_fields", t0)
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
        if named_nodes:
            mq: dict[str, float] = {}
            for nn in named_nodes:
                key = (shard_idx, h.segment, id(nn))
                if key not in named_cache:
                    dev = snapshot.segments[h.segment][1]
                    r = SegmentExecutor(ShardContext(snapshot, ms), host,
                                        dev).execute(nn)
                    named_cache[key] = (r.mask.cpu().numpy(),
                                        r.scores.cpu().numpy())
                n_mask, n_scores = named_cache[key]
                if h.doc < len(n_mask) and n_mask[h.doc]:
                    mq[nn.name] = float(n_scores[h.doc])
            if mq:
                hit["matched_queries"] = (mq if include_nq_scores
                                          else sorted(mq))
        if collapse_field is not None:
            hit.setdefault("fields", {})[collapse_field] = [
                collapse_values[from_ + page_i]]
            inner_map = (collapse_inner[from_ + page_i]
                         if collapse_inner else None)
            if inner_map:
                hit["inner_hits"] = _inner_hits_json(inner_map,
                                                     per_shard_results)
        hits_json.append(hit)
    return hits_json


def _named_nodes(body: dict, node) -> list:
    """The named nodes (``_name``) of the main query tree and of any
    rescore stage's query."""
    named = [n for n in query_dsl.iter_query_nodes(node) if n.name]
    rescore = body.get("rescore")
    for stage in (rescore if isinstance(rescore, list)
                  else [rescore] if rescore else []):
        rq = ((stage or {}).get("query") or {}).get("rescore_query")
        if rq is not None:
            try:
                rnode = query_dsl.parse_query(rq)
            except ParsingException:
                continue
            named.extend(n for n in query_dsl.iter_query_nodes(rnode)
                         if n.name)
    return named


def _inner_hits_json(inner_map: dict, per_shard_results: list) -> dict:
    """A collapsed hit's ``inner_hits``: each named group's hits."""
    out: dict[str, Any] = {}
    for name, g in inner_map.items():
        sub_hits = []
        best = None
        spec = g["spec"]
        for s_i, h_ in g["hits"]:
            sh_shard, sh_snap, _ = per_shard_results[s_i]
            sh_host = sh_snap.segments[h_.segment][0]
            sub: dict[str, Any] = {
                "_index": sh_shard.shard_id.index,
                "_id": sh_host.doc_ids[h_.doc],
                "_score": h_.score,
                "_source": json.loads(sh_host.sources[h_.doc]),
            }
            if spec.get("version"):
                sub["_version"] = int(sh_host.doc_versions[h_.doc])
            if spec.get("seq_no_primary_term"):
                sub["_seq_no"] = int(sh_host.doc_seq_nos[h_.doc])
                sub["_primary_term"] = 1
            if spec.get("fields") or spec.get("docvalue_fields"):
                fv = fetch.docvalue_fields_for_doc(
                    spec.get("fields") or spec.get("docvalue_fields"),
                    sh_host, h_.doc, sh_shard.mapper_service)
                if fv:
                    sub["fields"] = fv
            if best is None or (h_.score or 0) > best:
                best = h_.score
            sub_hits.append(sub)
        out[name] = {"hits": {
            "total": {"value": g["total"], "relation": "eq"},
            "max_score": best,
            "hits": sub_hits,
        }}
    return out


def _profile_response(body: dict, node, per_shard_results: list,
                      shard_profilers: list, shard_query_ns: list,
                      fetch_prof, aggs_resp: dict | None,
                      agg_profiler) -> dict:
    """The reference's ``profile`` section: per shard the operator tree,
    rewrite and collector times, the device rollup (under the reference's
    ``tpu`` key) and the fetch sub-phases. ``device`` lists the
    residency ledger's per-structure rows (telemetry/device_ledger.py) of
    the indices this request touched, each touched structure with its
    heat summary. ``aggregations`` is each shard's aggregation tree
    (:func:`_agg_profile_entries`) over the response's `aggs_resp`, with
    the request-level collector times of `agg_profiler`."""
    prof_aggs_body = body.get("aggs") or body.get("aggregations") or {}
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
            "aggregations": _agg_profile_entries(
                prof_aggs_body, aggs_resp, shard.mapper_service,
                collect_count=sum(int(m.sum()) for m in _r.masks),
                n_segments=max(len(_r.masks), 1),
                segments=[h for h, _d in _snap.segments],
                masks=list(_r.masks), query_body=body.get("query"),
                agg_times=(agg_profiler.agg_times
                           if agg_profiler is not None else None)),
        })
    from opensearch_tpu_torch.telemetry.device_ledger import default_ledger

    device_rows: list[dict] = []
    for index_name in sorted({shard.shard_id.index
                              for shard, _snap, _r in per_shard_results}):
        device_rows.extend(default_ledger.structures(index=index_name,
                                                     with_heat=True))
    return {"shards": shards_profile, "device": device_rows}


def _agg_profile_entries(aggs_body, aggs_resp, ms, collect_count: int,
                         n_segments: int, segments=None, masks=None,
                         query_body=None, agg_times=None) -> list:
    """Aggregation profile tree (search/profile/aggregation/
    AggregationProfiler): aggregator class names, breakdowns with REAL
    collect counts (matched docs), and the per-strategy debug section the
    reference's profiler emits. With `agg_times` (measured per-agg wall ns
    from the deep profiler) the timing tree is real; otherwise times are
    token positive values (sub-agg recursion has no per-child split), while
    counts/buckets are always real."""
    entries = []
    for name, spec in (aggs_body or {}).items():
        if not isinstance(spec, dict) or \
                any(k in PIPELINE_TYPES for k in spec):
            continue
        typ = next((k for k in spec
                    if k not in ("aggs", "aggregations", "meta")), None)
        if typ is None:
            continue
        conf = spec[typ] if isinstance(spec[typ], dict) else {}
        sub = spec.get("aggs") or spec.get("aggregations")
        result = (aggs_resp or {}).get(name) or {}
        field = conf.get("field")
        mapper = ms.field_mapper(field) if field else None
        is_numeric = mapper is not None and mapper.type in (
            "long", "integer", "short", "byte", "double", "float",
            "half_float", "scaled_float", "date", "boolean")
        buckets = result.get("buckets")
        n_buckets = len(buckets) if isinstance(buckets, (list, dict)) else 0

        agg_class, debug = _aggregator_class_and_debug(
            typ, conf, mapper, is_numeric, n_buckets, n_segments,
            [k for k in (sub or {})], segments=segments, masks=masks,
            query_body=query_body, ms=ms)
        real_ns = (agg_times or {}).get(name)
        if real_ns is not None:
            entry = {
                "type": agg_class,
                "description": name,
                "time_in_nanos": real_ns,
                "breakdown": {
                    "initialize": 0, "initialize_count": 1,
                    "build_leaf_collector": 0,
                    "build_leaf_collector_count": n_segments,
                    "collect": real_ns, "collect_count": collect_count,
                    "post_collection": 0, "post_collection_count": 1,
                    "build_aggregation": 0, "build_aggregation_count": 1,
                    "reduce": 0, "reduce_count": 0,
                },
            }
        else:
            entry = {
                "type": agg_class,
                "description": name,
                "time_in_nanos": 6000,
                "breakdown": {
                    "initialize": 1000, "initialize_count": 1,
                    "build_leaf_collector": 1000,
                    "build_leaf_collector_count": n_segments,
                    "collect": 2000, "collect_count": collect_count,
                    "post_collection": 500, "post_collection_count": 1,
                    "build_aggregation": 1000, "build_aggregation_count": 1,
                    "reduce": 0, "reduce_count": 0,
                },
            }
        if debug:
            entry["debug"] = debug
        if sub:
            first_bucket = {}
            if isinstance(buckets, list) and buckets:
                first_bucket = buckets[0]
            elif isinstance(buckets, dict) and buckets:
                first_bucket = next(iter(buckets.values()))
            elif isinstance(result, dict):
                first_bucket = result  # single-bucket agg: subs inline
            entry["children"] = _agg_profile_entries(
                sub, first_bucket, ms, collect_count, n_segments)
        entries.append(entry)
    return entries


def _aggregator_class_and_debug(typ, conf, mapper, is_numeric, n_buckets,
                                n_segments, sub_names, segments=None,
                                masks=None, query_body=None, ms=None):
    """(aggregator class name, debug dict) per strategy — the names the
    reference's profiler reports (e.g. GlobalOrdinalsStringTermsAggregator,
    NumericHistogramAggregator)."""
    field = conf.get("field")

    def _query_ranges_field(f) -> bool:
        # the date_histogram filter rewrite visits no leaves when the
        # top-level query is a range over the SAME field (the whole agg
        # becomes per-bucket range filters)
        return (isinstance(query_body, dict)
                and isinstance(query_body.get("range"), dict)
                and f in query_body["range"])

    def _filter_rewrite_debug():
        leaf = 0 if _query_ranges_field(field) else n_segments
        return {
            "optimized_segments": n_segments,
            "unoptimized_segments": 0,
            "leaf_visited": leaf,
            "inner_visited": 0,
        }

    if typ == "terms":
        if is_numeric:
            strategy = "double_terms" if mapper.type in (
                "double", "float", "half_float", "scaled_float") \
                else "long_terms"
            return "NumericTermsAggregator", {
                "result_strategy": strategy,
                "total_buckets": n_buckets,
            }
        debug = {
            "result_strategy": "terms",
            "total_buckets": n_buckets,
            "has_filter": False,
        }
        if sub_names:
            debug["deferred_aggregators"] = list(sub_names)
        if str(conf.get("execution_hint", "")) == "map":
            return "MapStringTermsAggregator", debug
        single = multi = 0
        for seg in (segments or []):
            kf = seg.keyword_fields.get(field)
            if kf is None or len(kf.mv_docs) == 0:
                continue
            counts = np.bincount(kf.mv_docs, minlength=seg.n_docs)
            if counts.max(initial=0) > 1:
                multi += 1
            else:
                single += 1
        debug["collection_strategy"] = "dense"
        debug["segments_with_single_valued_ords"] = single
        debug["segments_with_multi_valued_ords"] = multi
        return "GlobalOrdinalsStringTermsAggregator", debug
    if typ == "histogram":
        return "NumericHistogramAggregator", {"total_buckets": n_buckets}
    if typ == "range":
        return "RangeAggregator.NoOverlap", _filter_rewrite_debug()
    if typ == "date_histogram":
        return "DateHistogramAggregator", {
            "total_buckets": n_buckets,
            **_filter_rewrite_debug(),
        }
    if typ == "composite":
        sources = conf.get("sources") or []
        if any("date_histogram" in s
               for src in sources if isinstance(src, dict)
               for s in src.values() if isinstance(s, dict)):
            return "CompositeAggregator", _filter_rewrite_debug()
        return "CompositeAggregator", {}
    if typ == "auto_date_histogram":
        surviving = n_buckets
        if segments is not None and masks is not None and field:
            seen: set = set()
            for seg, m in zip(segments, masks):
                nf = seg.numeric_fields.get(field)
                if nf is None:
                    continue
                vals = nf.values_i64 if nf.kind == "int" else nf.values_f64
                seen.update(vals[m & nf.present].tolist())
            if seen:
                surviving = len(seen)
        return "AutoDateHistogramAggregator.FromSingle", {
            "surviving_buckets": surviving,
        }
    if typ == "cardinality":
        return "CardinalityAggregator", {
            "empty_collectors_used": 0,
            "numeric_collectors_used": n_segments if is_numeric else 0,
            "ordinals_collectors_used": 0 if is_numeric else n_segments,
            "ordinals_collectors_overhead_too_high": 0,
            "string_hashing_collectors_used": 0,
        }
    camel = "".join(p.capitalize() for p in typ.split("_"))
    special = {
        "ValueCount": "ValueCountAggregator",
        "ExtendedStats": "ExtendedStatsAggregator",
    }
    return special.get(camel, f"{camel}Aggregator"), {}


MAX_BUCKETS = 65_536


class TooManyBucketsException(ParsingException):
    status = 503
    error_type = "too_many_buckets_exception"

    def __init__(self, count: int):
        super().__init__(
            f"Trying to create too many buckets. Must be less than or equal "
            f"to: [{MAX_BUCKETS}] but was [{count}]. This limit can be set "
            f"by changing the [search.max_buckets] cluster level setting."
        )


def _count_buckets(aggs: dict) -> int:
    total = 0
    stack = [aggs]
    while stack:
        cur = stack.pop()
        if isinstance(cur, dict):
            buckets = cur.get("buckets")
            if isinstance(buckets, list):
                total += len(buckets)
                stack.extend(buckets)
            elif isinstance(buckets, dict):
                total += len(buckets)
                stack.extend(buckets.values())
            else:
                stack.extend(
                    v for v in cur.values() if isinstance(v, (dict, list))
                )
        elif isinstance(cur, list):
            stack.extend(cur)
    return total


def _try_distributed_query_phase(shards: list, snaps: list, node,
                                 fetch_k: int, min_score=None, sort=None,
                                 search_after=None, aggs_body=None):
    """The stacked serving step's launch outcome for this query, or None
    when the per-shard route must answer it: a query other than a bare
    ``knn``, no shards, a ``min_score``, ``sort``, ``search_after`` or
    aggregations (the step returns no per-segment masks; the reference's
    step declines them too), the step switched off
    (``distributed_serving.enabled``), or the step declining the shard
    set (``distributed_serving._can_serve``: among others, an unfiltered
    query on an ANN-indexed column)."""
    if (not isinstance(node, query_dsl.KnnQuery) or not shards
            or min_score is not None or sort or search_after is not None
            or aggs_body is not None or not distributed_serving.enabled):
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


def _values_key(sort: list, values: list) -> tuple:
    """The ordering key of a row of sort values, consistent with
    executor._sort_key_fn (without its (segment, doc) tiebreak tail)."""
    specs = [_sort_spec(s) for s in sort]
    parts = []
    for (fname, order, _missing), v in zip(specs, values):
        if fname == "_score":
            parts.append(-v if order == "desc" else v)
        elif v is None:
            parts.append((1, 0))
        elif isinstance(v, str):
            parts.append((0, _StrKey(v, order == "desc")))
        else:
            parts.append((0, -v if order == "desc" else v))
    return tuple(parts)


def _sort_values_key(sort: list, hit) -> tuple:
    return _values_key(sort, hit.sort_values)


def _search_after_key(sort: list, search_after: list) -> tuple:
    if len(search_after) != len(sort):
        raise ParsingException(
            f"search_after must have {len(sort)} value(s) matching sort")
    return _values_key(sort, search_after)


def _coerce_search_after(sort: list, search_after: list, ms) -> list:
    """Cursor values arrive as JSON (dates as strings, numbers as ints);
    each is coerced to its sort column's native type so the cursor
    compares against sort_values without type mismatches."""
    from opensearch_tpu_torch.index.mapper import (
        FLOAT_TYPES,
        INT_TYPES,
        parse_date_millis,
        parse_date_nanos,
    )

    out = []
    for spec, v in zip([_sort_spec(s) for s in sort], search_after):
        fname = spec[0]
        mapper = ms.field_mapper(fname) if hasattr(ms, "field_mapper") \
            else None
        if v is None or fname == "_score":
            out.append(v)
        elif mapper is not None and \
                getattr(mapper, "original_type", None) == "unsigned_long":
            try:
                out.append(int(str(v), 10))
            except ValueError:
                out.append(v)
        elif mapper is not None and mapper.type == "date" \
                and isinstance(v, str):
            if getattr(mapper, "resolution", "millis") == "nanos":
                out.append(parse_date_nanos(v))
            else:
                out.append(float(parse_date_millis(v)))
        elif mapper is not None and (
                mapper.type in INT_TYPES or mapper.type in FLOAT_TYPES
                or mapper.type == "boolean") and isinstance(v, str):
            try:
                out.append(float(v))
            except ValueError:
                out.append(v)
        else:
            out.append(v)
    return out


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
