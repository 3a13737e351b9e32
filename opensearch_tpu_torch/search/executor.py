"""Per-shard query execution: query node tree -> device score and mask.

Counterpart of opensearch_tpu/search/executor.py. Each query node runs
against each segment's device columns and gives a dense (scores [n_pad]
f32, mask [n_pad] bool) pair, a :class:`NodeResult`; a bool query composes
its children elementwise. Scoring follows Lucene: BM25 (ops/bm25.py) with
shard-level statistics (idf over the summed per-segment doc freqs, avgdl
over all segments), a constant ``boost`` for filter-like queries in
scoring position, 0 for filter-only bools. Multi-term queries (prefix,
wildcard, regexp, fuzzy) walk the term dictionary on the host and send
one doc mask to the device; a phrase verifies positions on the host.

The kNN query (``ShardContext.shard_knn_selection``) takes one of four
branches per segment, as the reference does, counted in
``knn_path_stats``:

- ``ann`` (the column has an IVF-PQ structure): ``ops/ivfpq.search_index``
  under the resolved ``search.knn.ann.kernel`` ("pallas": host probe
  selection + the fused pipeline whose scan is K2; "xla": the monolithic
  lowering), at the live ADC precision and rescore multiplier;
- exact, for segments below ``min_train`` or without ANN:
  - ``fused``: the fused exact kNN (``ops/knn_fused.knn_fused_auto``, K1)
    when ``search.knn.kernel`` resolves to "pallas" and the k bucket is at
    most ``FUSED_MAX_K``;
  - ``streaming``: otherwise ``ops/fused.knn_topk_streaming`` for segments
    of at least ``STREAMING_MIN_DOCS`` docs whose n_pad is a multiple of the
    chunk and whose k bucket fits in it;
  - ``materializing``: otherwise the [B, n_pad] scores of
    ``ops/knn.exact_knn_scores`` and a host argpartition.

Then the shard cut: the k best of all segments of the shard, by
(-score, segment, doc). k and nprobe are bucketed to powers of two as the
reference buckets them, so the results are the reference's. Every launch
goes through the dispatch batcher (search/batcher.py) with the
reference's batch keys, so concurrent queries over one segment column and
reader generation coalesce into one launch. The selection comes back as a
:class:`HostNodeResult`; a knn inside a bool, a rescore or a function
score reads it as device tensors.

Filtered kNN (a ``filter`` inside the ``knn`` clause): the filter is any
executable node, and its ``execute(node).mask`` is ANDed into ``valid``,
as the reference's ``shard_knn_selection`` does, so the same exact scan
runs on the narrower set; a filtered query never takes ANN and gets batch
key None on every branch, so it never merges with another query.

:func:`execute_query_phase` cuts each segment's masked scores with
``ops/topk.segment_top_k`` (or, for a bare knn, reads the host selection),
counts the total on the host, applies ``min_score`` to hits and total,
and sorts by fields on the host's exact int64 / float64 columns.

The rest of the DSL runs as in the reference: ``terms_set``,
``distance_feature``, ``rank_feature`` (the default pivot a float64 mean
over every segment of the shard, on the host), the ``geo_*`` queries over
the point columns (haversine in float64 on the host), ``slice`` (murmur3
of ``_id``, cached on the host segment), ``nested`` (flattened),
``more_like_this`` (a tf-idf rewrite to a ``bool`` of terms, once per
shard), ``percolate`` (each stored query run against a throwaway segment
of the documents on the node's device, freed from the residency ledger
after the query), ``has_child`` / ``has_parent`` / ``parent_id`` (masks
over the shard's join columns), ``script`` and the generic
``script_score`` (one painless evaluation a doc on the host), the vector
``script_score`` forms (``ops/knn`` products on the device) and
``hybrid`` without a pipeline (a dis_max; with one, search/service.py
runs each sub-query apart). Every node can serve as a kNN filter.

Under ``"profile": true`` (search/profile.py) every executed node is an
operator of the shard's profile tree, BM25 records its fenced launch under
``bm25_term_scores``, each batched kNN launch records its share of the
fenced launch wall under the reference's kernel names
(``knn_fused_pallas``, ``knn_topk_streaming``, ``knn_exact_scores``,
``ivfpq_adc_pallas`` / ``ivfpq_search``), and the top-k cut or field sort
is the collector time. Each batched launch, profiled or not, folds its
fenced wall into the roofline (telemetry/roofline.py) under its family's
cost model and records a heat touch of the structures it read (the vector
column, the live bitmap and, on the IVF-PQ route, the slab) in the
device-residency ledger, where its padded query batch is a transient
upload.
"""

from __future__ import annotations

import copy
import json
import math
import re
import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Any

import numpy as np
import torch

from opensearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    ParsingException,
)
from opensearch_tpu_torch.common.hashing import murmur3_x86_32
from opensearch_tpu_torch.index.mapper import (
    FLOAT_TYPES,
    INT_TYPES,
    RANGE_TYPES,
    parse_date_millis,
    parse_date_nanos,
)
from opensearch_tpu_torch.index.segment import i64_query_words, pad_window
from opensearch_tpu_torch.ops import bm25, filters
from opensearch_tpu_torch.search import batcher, profile
from opensearch_tpu_torch.search import query_dsl as q
from opensearch_tpu_torch.search.fetch import (
    _edit_distance_at_most,
    _fuzziness_distance,
)
from opensearch_tpu_torch.telemetry import roofline
from opensearch_tpu_torch.telemetry.device_ledger import (
    KIND_QUERY_BATCH,
    default_ledger,
)

I64_MIN = -(2**63)
I64_MAX = 2**63 - 1

# exact-kNN scan strategy when the fused kernel does not serve: segments of
# at least STREAMING_MIN_DOCS docs score through the chunked streaming scan,
# smaller ones materialize their scores. Tests patch both.
STREAMING_MIN_DOCS = 16_384
STREAMING_CHUNK = 32_768

# which branch served _exec_KnnQuery selections
knn_path_stats = {"streaming": 0, "materializing": 0, "ann": 0, "fused": 0}
_knn_path_stats_lock = threading.Lock()


def _count_knn_path(kind: str) -> None:
    with _knn_path_stats_lock:
        knn_path_stats[kind] += 1


def not_yet_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to opensearch_tpu_torch")


def _pad_query_batch(rows: list) -> np.ndarray:
    """Stack per-request query vectors into a [B_pad, d] batch, B padded to
    the next power of two with zero rows (the caller slices them off). The
    padded batch is a per-launch upload: the residency ledger counts it as
    transient (allocated and freed in one step)."""
    b = len(rows)
    b_pad = 1 << (b - 1).bit_length()
    out = np.zeros((b_pad, len(rows[0])), np.float32)
    for i, row in enumerate(rows):
        out[i] = row
    default_ledger.record_transient(KIND_QUERY_BATCH, out.nbytes)
    return out


def _touch_targets(dev, field: str, ann=None) -> list:
    """The ledger allocations a kNN launch over this segment READS: the
    vector column, the live bitmap and (IVF-PQ route) the slab. The launch
    closures record a heat touch against them with the launch's modeled
    bytes."""
    allocs = dev.allocations or {}
    out = [allocs.get(field), allocs.get("_live")]
    if ann is not None:
        out.append(ann.allocation)
    return [a for a in out if a is not None]


def _account_launch(family: str, t0_ns: int, touch: list,
                    touch_family: str | None = None, **params) -> None:
    """One fenced launch of `family` since `t0_ns`: fold it into the
    roofline under the family's cost model, and touch the structures it
    read with the bytes of the same model."""
    roofline.record_launch(family, time.perf_counter_ns() - t0_ns, **params)
    default_ledger.touch(touch, family=touch_family or family, params=params)


@dataclass
class ShardHit:
    score: float
    segment: int          # index into snapshot.segments
    doc: int              # local doc id
    sort_values: list = dc_field(default_factory=list)


@dataclass
class ShardQueryResult:
    hits: list[ShardHit]
    total: int
    max_score: float | None
    # per-segment match masks (host bool arrays) for the aggs phase
    masks: list[np.ndarray] = dc_field(default_factory=list)
    # per-segment score arrays (host f32, n_docs)
    score_arrays: list[np.ndarray] = dc_field(default_factory=list)


class HostNodeResult:
    """NodeResult duck type for a host-resident selection (the bare-kNN
    path): the shard cut already picked <= k winners on the host, so a
    top-level consumer (execute_query_phase's host fast path) reads them
    here. A compound parent (knn inside bool, a rescore, ...) reading
    ``.scores`` / ``.mask`` gets device tensors, copied once on first use
    and kept, so query semantics never change."""

    __slots__ = ("host_scores", "host_mask", "scoring", "device",
                 "_dev_scores", "_dev_mask")

    def __init__(self, host_scores: np.ndarray, host_mask: np.ndarray,
                 scoring: bool = True, device=None):
        self.host_scores = host_scores    # f32 [n_pad], 0 where unselected
        self.host_mask = host_mask        # bool [n_pad]
        self.scoring = scoring
        self.device = device
        self._dev_scores = None
        self._dev_mask = None

    @property
    def scores(self) -> torch.Tensor:
        if self._dev_scores is None:
            self._dev_scores = torch.from_numpy(
                np.ascontiguousarray(self.host_scores)).to(self.device)
        return self._dev_scores

    @property
    def mask(self) -> torch.Tensor:
        if self._dev_mask is None:
            self._dev_mask = torch.from_numpy(
                np.ascontiguousarray(self.host_mask)).to(self.device)
        return self._dev_mask


def host_mask(r) -> np.ndarray:
    """A node result's mask on the host (a host selection's own array)."""
    return r.host_mask if isinstance(r, HostNodeResult) \
        else r.mask.cpu().numpy()


def host_scores(r) -> np.ndarray:
    """A node result's scores on the host."""
    return r.host_scores if isinstance(r, HostNodeResult) \
        else r.scores.cpu().numpy()


class ShardContext:
    def __init__(self, snapshot, mapper_service):
        self.snapshot = snapshot
        self.mapper_service = mapper_service
        # knn nodes select k docs PER SHARD (k-NN plugin semantics), so the
        # top-k cut spans all segments of the shard; cached per query node
        self._knn_cache: dict[int, list] = {}
        # query_string trees are parsed once per shard, not per segment
        self._qs_cache: dict[int, Any] = {}

    def rewritten_query_string(self, node) -> Any:
        """A query_string / simple_query_string node's text parsed once per
        shard into a query tree (QueryStringQueryBuilder's rewrite)."""
        cached = self._qs_cache.get(id(node))
        if cached is not None:
            return cached
        from opensearch_tpu_torch.search.query_string import (
            parse_query_string,
            parse_simple_query_string,
        )

        fields = node.fields or self.default_text_fields()
        if isinstance(node, q.SimpleQueryStringQuery):
            tree = parse_simple_query_string(node.query, fields,
                                             node.default_operator)
        else:
            tree = parse_query_string(node.query, fields,
                                      node.default_operator)
        self._qs_cache[id(node)] = tree
        return tree

    def default_text_fields(self) -> list[str]:
        fields = [name for name, m in self.mapper_service.mappers.items()
                  if m.type in ("text", "keyword")]
        for host, _dev in self.snapshot.segments:
            for name in host.text_fields:
                if name not in fields:
                    fields.append(name)
        return fields or ["_all_absent_"]

    # -- shard-level statistics (Lucene's collection statistics) -----------

    def text_stats(self, field: str) -> tuple[int, float]:
        """(doc_count, avgdl) across all segments of the shard."""
        doc_count = 0
        total_terms = 0.0
        for host, _ in self.snapshot.segments:
            tf = host.text_fields.get(field)
            if tf is not None:
                doc_count += tf.docs_with_field
                total_terms += tf.total_terms
        if doc_count == 0:
            return 0, 1.0
        return doc_count, total_terms / doc_count

    def text_df(self, field: str, term: str) -> int:
        return sum(host.text_fields[field].doc_freq(term)
                   for host, _ in self.snapshot.segments
                   if field in host.text_fields)

    def keyword_df(self, field: str, value: str) -> int:
        df = 0
        for host, _ in self.snapshot.segments:
            kf = host.keyword_fields.get(field)
            if kf is None:
                continue
            o = kf.ord_dict.get(value)
            if o is not None:
                df += int(np.sum(kf.mv_ords == o))
        return df

    def keyword_doc_count(self, field: str) -> int:
        return sum(int((host.keyword_fields[field].first_ord >= 0).sum())
                   for host, _ in self.snapshot.segments
                   if field in host.keyword_fields)

    # -- shard-level rewrites and masks ------------------------------------

    def mlt_rewrite(self, node) -> Any:
        """MoreLikeThisQuery -> a bool of should term queries, picked by
        tf-idf over the shard's statistics (MoreLikeThisQueryBuilder's term
        selection); cached per shard."""
        cached = self._qs_cache.get(("mlt", id(node)))
        if cached is not None:
            return cached
        fields = node.fields or [
            f for f, m in self.mapper_service.mappers.items()
            if m.type == "text"]
        total_docs = max(self.snapshot.num_docs, 1)
        scored: list[tuple[float, str, str]] = []
        for field in fields:
            tf_counts: dict[str, int] = {}
            for text in node.like_texts:
                for term in self.mapper_service.analyze_query_text(field,
                                                                   text):
                    tf_counts[term] = tf_counts.get(term, 0) + 1
            for term, tf in tf_counts.items():
                if tf < node.min_term_freq:
                    continue
                df = self.text_df(field, term)
                if df < node.min_doc_freq or df == 0:
                    continue  # an absent term can never match this shard
                idf = math.log(1.0 + total_docs / df)
                scored.append((tf * idf, field, term))
        scored.sort(key=lambda s: (-s[0], s[1], s[2]))
        should = [q.TermQuery(field=f, value=t, boost=w)
                  for w, f, t in scored[: node.max_query_terms]]
        msm = node.minimum_should_match
        try:
            if isinstance(msm, str) and msm.endswith("%"):
                msm_n = int(len(should) * int(msm[:-1]) / 100)
            else:
                msm_n = int(msm)
        except ValueError:
            raise ParsingException(
                f"unsupported [minimum_should_match] value [{msm}] for "
                "[more_like_this] (use an integer or \"N%\")") from None
        tree = q.BoolQuery(should=should, minimum_should_match=max(msm_n, 1),
                           boost=node.boost) if should else q.MatchNoneQuery()
        self._qs_cache[("mlt", id(node))] = tree
        return tree

    def _device(self):
        segs = self.snapshot.segments
        return segs[0][1].live.device if segs else torch.device("cpu")

    def percolate_masks(self, node) -> list:
        """Per-segment host masks of a PercolateQuery: the live docs whose
        stored query (at node.field in _source) matches ANY of the given
        documents. The documents make one throwaway segment on the node's
        device, against which each stored query runs (the percolator
        module's memory index); its residency-ledger entries are freed
        when the masks are made. Cached per shard."""
        cached = self._qs_cache.get(("perc", id(node)))
        if cached is not None:
            return cached
        from opensearch_tpu_torch.index.device import to_device
        from opensearch_tpu_torch.index.engine import SearcherSnapshot
        from opensearch_tpu_torch.index.segment import SegmentBuilder

        # a search never changes the index's mappings: the documents parse
        # against a copy, so their dynamic fields stay with this query
        tmp_ms = copy.copy(self.mapper_service)
        tmp_ms.mappers = dict(self.mapper_service.mappers)
        builder = SegmentBuilder(tmp_ms, "_percolate_tmp")
        for i, doc in enumerate(node.documents):
            builder.add(tmp_ms.parse_document(f"_tmp_{i}", doc), seq_no=i)
        tmp_host = builder.build()
        tmp_dev = to_device(tmp_host, self._device())
        tmp_ex = SegmentExecutor(
            ShardContext(SearcherSnapshot(segments=[(tmp_host, tmp_dev)],
                                          generation=0), tmp_ms),
            tmp_host, tmp_dev)
        try:
            masks = []
            for host, dev in self.snapshot.segments:
                mask = np.zeros(dev.n_pad, bool)
                for d in range(host.n_docs):
                    if not host.live[d]:
                        continue
                    stored = json.loads(host.sources[d]).get(node.field)
                    if not isinstance(stored, dict):
                        continue
                    try:
                        r = tmp_ex.execute(q.parse_query(stored))
                        if bool(host_mask(r)[: tmp_host.n_docs].any()):
                            mask[d] = True
                    except Exception:  # noqa: BLE001
                        # a stored query that cannot run never matches
                        continue
                masks.append(mask)
        finally:
            tmp_dev.free_allocations(reason="percolate-transient")
        self._qs_cache[("perc", id(node))] = masks
        return masks

    def join_masks(self, node) -> list:
        """Per-segment host masks of has_child / has_parent / parent_id.
        Children are routed to their parent's shard, so the join closes
        over this shard's segments (the parent-join module's invariant);
        cached per shard."""
        cached = self._qs_cache.get(("join", id(node)))
        if cached is not None:
            return cached
        join_field = next((f for f, m in self.mapper_service.mappers.items()
                           if m.type == "join"), None)

        def column(host, suffix: str) -> list:
            """The join column's value of each doc (None where absent)."""
            kf = (host.keyword_fields.get(f"{join_field}#{suffix}")
                  if join_field else None)
            if kf is None:
                return [None] * host.n_docs
            return [kf.ord_values[o] if o >= 0 else None
                    for o in kf.first_ord[: host.n_docs].tolist()]

        masks = []
        segments = self.snapshot.segments
        if isinstance(node, q.ParentIdQuery):
            for host, dev in segments:
                mask = np.zeros(dev.n_pad, bool)
                for d, (rel, par) in enumerate(zip(column(host, "name"),
                                                   column(host, "parent"))):
                    if host.live[d] and rel == node.type and par == node.id:
                        mask[d] = True
                masks.append(mask)
        elif isinstance(node, q.HasChildQuery):
            # the relations whose children include node.type (a mid-level
            # relation of a multi-level join is a child and a parent)
            join_mapper = self.mapper_service.mappers.get(join_field)
            parent_names = {
                p for p, children in ((join_mapper.relations or {})
                                      if join_mapper else {}).items()
                if node.type in children}
            # pass 1: the matching children's parent ids, over all segments
            parent_counts: dict[str, int] = {}
            for host, dev in segments:
                child = host_mask(SegmentExecutor(self, host, dev).execute(
                    node.query))
                for d, (rel, par) in enumerate(zip(column(host, "name"),
                                                   column(host, "parent"))):
                    if host.live[d] and child[d] and rel == node.type \
                            and par is not None:
                        parent_counts[par] = parent_counts.get(par, 0) + 1
            wanted = {p for p, c in parent_counts.items()
                      if node.min_children <= c <= node.max_children}
            # pass 2: docs of a parent relation whose _id is in the set
            for host, dev in segments:
                mask = np.zeros(dev.n_pad, bool)
                for d, rel in enumerate(column(host, "name")):
                    if host.live[d] and host.doc_ids[d] in wanted \
                            and rel in parent_names:
                        mask[d] = True
                masks.append(mask)
        elif isinstance(node, q.HasParentQuery):
            # pass 1: the matching parents' _ids
            parent_ids: set[str] = set()
            for host, dev in segments:
                pmask = host_mask(SegmentExecutor(self, host, dev).execute(
                    node.query))
                for d, rel in enumerate(column(host, "name")):
                    if host.live[d] and pmask[d] \
                            and rel == node.parent_type:
                        parent_ids.add(host.doc_ids[d])
            # pass 2: the children pointing at them
            for host, dev in segments:
                mask = np.zeros(dev.n_pad, bool)
                for d, par in enumerate(column(host, "parent")):
                    if host.live[d] and par in parent_ids:
                        mask[d] = True
                masks.append(mask)
        self._qs_cache[("join", id(node))] = masks
        return masks

    def shard_knn_selection(self, node) -> list:
        """Per-segment (sel_mask bool[n_pad], scores f32[n_pad]) numpy pairs
        for a KnnQuery, with the top-k cut applied across the whole shard.
        Scores are -inf outside the candidates a segment's launch returned."""
        cached = self._knn_cache.get(id(node))
        if cached is not None:
            return cached
        from opensearch_tpu_torch.ops import knn as knn_ops

        filtered = node.filter is not None
        per_seg_scores: list[np.ndarray | None] = []
        candidates: list[tuple[float, int, int]] = []
        for seg_idx, (host, dev) in enumerate(self.snapshot.segments):
            vf = dev.vector_fields.get(node.field)
            if vf is None:
                per_seg_scores.append(None)
                continue
            valid = vf.present & dev.live
            if filtered:
                # efficient filtering: the same scan on a narrower set
                valid = valid & SegmentExecutor(self, host, dev).execute(
                    node.filter).mask
            qv = np.asarray(node.vector, np.float32)
            sim = knn_ops.canonical_similarity(vf.similarity)
            k_req = max(1, min(int(node.k), host.n_docs))
            # k is bucketed to the next power of two as in the reference
            # (its programs are shape-specialized, and equal buckets share
            # a batch); the shard cut below still takes exactly node.k
            k_bucket = 1 << (k_req - 1).bit_length()
            if vf.ann is not None and not filtered:
                a_vals, a_ids = self._ann_dispatch(dev, vf, valid, qv, node,
                                                   k_bucket, sim)
                _count_knn_path("ann")
                scores = np.full(dev.n_pad, -np.inf, np.float32)
                hit = a_ids >= 0
                scores[a_ids[hit]] = a_vals[hit]
                # the launch returned its candidates sorted: feed the best
                # node.k to the shard cut directly
                per_seg_scores.append(scores)
                for v, d in zip(a_vals[hit][: node.k], a_ids[hit][: node.k]):
                    if np.isfinite(v):
                        candidates.append((float(v), seg_idx, int(d)))
                continue
            scores = self._exact_dispatch(host, dev, vf, valid, qv, node.field,
                                          k_bucket, sim, filtered)
            per_seg_scores.append(scores)
            n_take = min(node.k, host.n_docs)
            top = np.argpartition(-scores[: host.n_docs],
                                  min(n_take, host.n_docs - 1))[:n_take]
            for d in top:
                if np.isfinite(scores[d]):
                    candidates.append((float(scores[d]), seg_idx, int(d)))
        candidates.sort(key=lambda c: (-c[0], c[1], c[2]))
        winners = candidates[: node.k]
        out = []
        for seg_idx, (_host, dev) in enumerate(self.snapshot.segments):
            scores = per_seg_scores[seg_idx]
            sel = np.zeros(dev.n_pad, bool)
            if scores is not None:
                for _s, si, d in winners:
                    if si == seg_idx:
                        sel[d] = True
            out.append((sel, scores))
        self._knn_cache[id(node)] = out
        return out

    def _ann_dispatch(self, dev, vf, valid, qv: np.ndarray, node,
                      k_bucket: int,
                      sim: str):
        """The IVF-PQ launch for this query through the batcher: (vals, ids)
        numpy rows of at least k_bucket candidates, under the live ANN
        policy, precision and rescore multiplier. The key carries the index
        build generation and the reader generation, so neither a rebuild
        nor a refresh can merge into an old batch."""
        from opensearch_tpu_torch.ops import ivfpq
        from opensearch_tpu_torch.search import ann as ann_mod

        cfg = ann_mod.default_config
        precision = cfg.adc_precision
        mult = cfg.rescore_multiplier
        kernel = ann_mod.resolve_kernel(cfg.kernel)
        nprobe_req = int((node.method_parameters or {}).get(
            "nprobe", vf.nprobe_default))
        nprobe = ann_mod.bucket_nprobe(nprobe_req, vf.ann.params.nlist)
        gen = self.snapshot.generation
        # the profiler's kernel family: the scan K2 serves, or the
        # monolithic lowering
        family = "ivfpq_adc_pallas" if kernel == "pallas" else "ivfpq_search"

        def ann_key(kb: int):
            return ("ivfpq", id(vf), vf.ann.build_generation, gen, kb, nprobe,
                    sim, precision, mult, kernel)

        rescore = ivfpq.rescore_pool(vf.ann, k_bucket, nprobe,
                                     ivfpq.default_rerank(k_bucket, mult))
        touch = _touch_targets(dev, node.field, ann=vf.ann)

        def launch_ann(rows):
            q_batch = _pad_query_batch(rows)
            t0 = time.perf_counter_ns()
            with profile.profiling(None):
                b_vals, b_ids = ivfpq.search_index(
                    vf.ann, vf.vectors, vf.norms_sq, valid, q_batch,
                    k=k_bucket, nprobe=nprobe, similarity=vf.similarity,
                    adc_precision=precision, rescore_multiplier=mult,
                    kernel=kernel)
            out = _rows(b_vals, b_ids, len(rows))
            # one fenced launch against the variant's cost model, keyed per
            # ADC precision
            _account_launch(
                f"{family}[{precision}]", t0, touch,
                b=int(q_batch.shape[0]), nlist=vf.ann.params.nlist,
                d=vf.ann.params.d, m=vf.ann.params.m, ks=vf.ann.params.ks,
                nprobe=nprobe, l_pad=vf.ann.l_pad, rescore=rescore,
                adc_precision=precision)
            return out, profile.signature_retraced(
                "ivfpq_search", (vf.vectors, q_batch),
                (k_bucket, nprobe, precision, mult, kernel))

        # cross-k coalescing: this request may ride a forming batch of the
        # next-larger k buckets (its rows truncate for free); it never
        # creates one
        out = batcher.dispatch(
            ann_key(k_bucket), qv, launch_ann, kind="ann", rank=k_bucket,
            alt_keys=(ann_key(k_bucket * 2), ann_key(k_bucket * 4)),
            family=family,
            tune_key=("ivfpq", id(self.mapper_service), node.field, k_bucket),
        )
        _record_kernel(family, out, qv, {
            "adc_precision": precision, "rescore_candidates": rescore,
            "nprobe": nprobe, "kernel": kernel})
        return out.value

    def _exact_dispatch(self, host, dev, vf, valid, qv: np.ndarray,
                        field: str, k_bucket: int, sim: str,
                        filtered: bool = False) -> np.ndarray:
        """The exact scan of one segment for this query through the
        batcher: the fused kernel, the streaming or the materializing scan,
        as the reference picks them. A filtered query's `valid` is its own,
        so its key is None on every branch: it never merges. Returns the
        segment's scores f32 [n_pad], -inf outside the launch's
        candidates."""
        from opensearch_tpu_torch.ops import fused, knn_fused
        from opensearch_tpu_torch.ops import knn as knn_ops
        from opensearch_tpu_torch.search.ann import (
            default_config as ann_config,
            resolve_kernel,
        )

        n_pad = dev.n_pad
        chunk = min(STREAMING_CHUNK, n_pad)
        gen = self.snapshot.generation
        exact_kernel = resolve_kernel(ann_config.exact_kernel)
        score_precision = ann_config.score_precision
        # generation-free key family of the wait tuner: a refresh must not
        # reset what it learned
        tune = (id(self.mapper_service), field)
        touch = _touch_targets(dev, field)
        n_rows, dims = int(vf.vectors.shape[0]), int(vf.vectors.shape[1])
        scores = np.full(n_pad, -np.inf, np.float32)
        if exact_kernel == "pallas" and k_bucket <= knn_fused.FUSED_MAX_K:

            def fused_key(kb: int):
                if filtered:
                    return None
                return ("knn_fused", id(vf), gen, kb, sim, score_precision,
                        exact_kernel)

            def launch_fused(rows):
                q_batch = torch.from_numpy(_pad_query_batch(rows)).to(
                    vf.vectors.device)
                t0 = time.perf_counter_ns()
                with profile.profiling(None):
                    b_vals, b_ids = knn_fused.knn_fused_auto(
                        vf.vectors, vf.norms_sq, valid, q_batch, k=k_bucket,
                        similarity=sim, score_precision=score_precision,
                        impl=exact_kernel)
                out = _rows(b_vals, b_ids, len(rows))
                _account_launch(
                    f"knn_fused_pallas[{score_precision}]", t0, touch,
                    touch_family="knn_fused_pallas",
                    b=int(q_batch.shape[0]), n=n_rows, d=dims, k=k_bucket,
                    r=knn_fused.fused_pool_width(k_bucket, score_precision),
                    precision=score_precision)
                return out, profile.signature_retraced(
                        "knn_fused_pallas", (vf.vectors, q_batch),
                        (k_bucket, sim, score_precision, exact_kernel))

            out = batcher.dispatch(
                fused_key(k_bucket), qv, launch_fused, rank=k_bucket,
                alt_keys=tuple(fused_key(kb)
                               for kb in (k_bucket * 2, k_bucket * 4)
                               if kb <= knn_fused.FUSED_MAX_K
                               and not filtered),
                family="knn_fused_pallas",
                tune_key=("knn_fused", *tune, k_bucket))
            _record_kernel("knn_fused_pallas", out, qv, {
                "score_precision": score_precision, "kernel": exact_kernel})
            vals, ids = out.value
            hit = ids >= 0
            scores[ids[hit]] = vals[hit]
            _count_knn_path("fused")
        elif (host.n_docs >= STREAMING_MIN_DOCS and n_pad % chunk == 0
                and k_bucket <= chunk):
            scan = fused.cached_knn_streaming(k_bucket, sim, chunk)

            def stream_key(kb: int):
                if filtered:
                    return None
                return ("knn_topk_streaming", id(vf), gen, kb, sim, chunk)

            def launch_streaming(rows):
                q_batch = torch.from_numpy(_pad_query_batch(rows)).to(
                    vf.vectors.device)
                t0 = time.perf_counter_ns()
                with profile.profiling(None):
                    b_vals, b_ids = scan(vf.vectors, vf.norms_sq, valid,
                                         q_batch)
                out = _rows(b_vals, b_ids, len(rows))
                _account_launch("knn_topk_streaming", t0, touch,
                                b=int(q_batch.shape[0]), n=n_rows, d=dims,
                                k=k_bucket)
                return out, profile.signature_retraced(
                        "knn_topk_streaming", (vf.vectors, q_batch),
                        (k_bucket, sim, chunk))

            out = batcher.dispatch(
                stream_key(k_bucket), qv, launch_streaming, rank=k_bucket,
                alt_keys=tuple(stream_key(kb)
                               for kb in (k_bucket * 2, k_bucket * 4)
                               if kb <= chunk and not filtered),
                family="knn_topk_streaming",
                tune_key=("knn_topk_streaming", *tune, k_bucket))
            _record_kernel("knn_topk_streaming", out, qv)
            vals, ids = out.value
            finite = np.isfinite(vals)
            scores[ids[finite]] = vals[finite]
            _count_knn_path("streaming")
        else:

            def launch_exact(rows):
                q_batch = torch.from_numpy(_pad_query_batch(rows)).to(
                    vf.vectors.device)
                t0 = time.perf_counter_ns()
                with profile.profiling(None):
                    b_scores = knn_ops.exact_knn_scores(
                        q_batch, vf.vectors, vf.norms_sq, valid,
                        vf.similarity).cpu().numpy()
                _account_launch("knn_exact_scores", t0, touch,
                                b=int(q_batch.shape[0]), n=n_rows, d=dims)
                return [b_scores[i] for i in range(len(rows))], \
                    profile.signature_retraced(
                        "knn_exact_scores", (vf.vectors, q_batch), (sim,))

            out = batcher.dispatch(
                None if filtered else ("knn_exact_scores", id(vf), gen, sim),
                qv, launch_exact, family="knn_exact_scores",
                tune_key=("knn_exact_scores", *tune))
            _record_kernel("knn_exact_scores", out, qv)
            scores = out.value
            _count_knn_path("materializing")
        return scores


def _record_kernel(name: str, out, qv: np.ndarray,
                   annotations: dict | None = None) -> None:
    """A batched launch's share of its fenced wall, on the active
    profiler's current operator (a merged launch splits evenly)."""
    prof = profile.active()
    if prof is not None:
        prof.record_kernel(name, out.kernel_share_ns, int(qv.nbytes),
                           out.retraced, annotations)


def _rows(b_vals: torch.Tensor, b_ids: torch.Tensor, n: int) -> list:
    """The first n rows of a batch launch as (vals, ids) numpy pairs;
    copying them to the host is the fence for the launch."""
    vals, ids = b_vals[:n].cpu().numpy(), b_ids[:n].cpu().numpy()
    return [(vals[i], ids[i]) for i in range(n)]



# --------------------------------------------------------------------------
# Node execution against one segment
# --------------------------------------------------------------------------


def _phrase_match(lists: list, slop: int, terms: list | None = None) -> bool:
    """True iff one position per term can be chosen with total displacement
    cost sum |p_i - p_{i-1} - 1| <= slop (slop 0 = exact adjacency; adjacent
    swaps cost 2, Lucene's sloppy-phrase distance). Repeated query terms
    must land on distinct positions (SloppyPhraseScorer repeats)."""
    if any(len(lst) == 0 for lst in lists):
        return False
    if terms is not None and len(set(terms)) < len(terms):
        # exhaustive search with the distinct-position constraint for
        # repeated terms; per-doc tf keeps the space tiny, but cap it
        def rec(i: int, prev_p: int | None, cost: int,
                used: dict[str, set], budget: list[int]) -> bool:
            if budget[0] <= 0:
                return False
            if cost > slop:
                return False
            if i == len(lists):
                return True
            t = terms[i]
            for p in lists[i]:
                p = int(p)
                if p in used.get(t, ()):
                    continue
                budget[0] -= 1
                step = 0 if prev_p is None else abs(p - prev_p - 1)
                used.setdefault(t, set()).add(p)
                if rec(i + 1, p, cost + step, used, budget):
                    return True
                used[t].discard(p)
            return False

        return rec(0, None, 0, {}, [200_000])
    prev = {int(p): 0 for p in lists[0]}
    for lst in lists[1:]:
        cur: dict[int, int] = {}
        for p in lst:
            p = int(p)
            cur[p] = min(c + abs(p - pq - 1) for pq, c in prev.items())
        prev = cur
        if min(prev.values()) > slop:
            return False  # costs only grow downstream
    return min(prev.values()) <= slop


@dataclass
class NodeResult:
    scores: torch.Tensor           # f32 [n_pad], 0 where not matching
    mask: torch.Tensor             # bool [n_pad]
    scoring: bool                  # False => pure filter (score ignored)


def _f32(x: float, device) -> torch.Tensor:
    """A float32 scalar on `device`: the reference's jnp.float32(x)."""
    return torch.tensor(np.float32(x), dtype=torch.float32, device=device)


def _const_result(mask: torch.Tensor, boost: float,
                  scoring: bool) -> NodeResult:
    # a fill with the boost already rounded to float32: the reference's
    # bits, with no host-to-device copy (which would wait for the stream)
    scores = torch.where(mask, float(np.float32(boost)), 0.0)
    return NodeResult(scores=scores, mask=mask, scoring=scoring)


def _empty(dev) -> NodeResult:
    device = dev.live.device
    return NodeResult(
        scores=torch.zeros(dev.n_pad, dtype=torch.float32, device=device),
        mask=torch.zeros(dev.n_pad, dtype=torch.bool, device=device),
        scoring=False)


class SegmentExecutor:
    """Executes a query node tree against one segment's device columns."""

    def __init__(self, ctx: ShardContext, host, dev):
        self.ctx = ctx
        self.host = host
        self.dev = dev
        self.device = dev.live.device

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- text scoring ------------------------------------------------------

    def _bm25(self, field: str, terms: list[str],
              boost: float) -> tuple[NodeResult, torch.Tensor]:
        """Returns (result, per-doc matched-term counts)."""
        dev_tf = self.dev.text_fields.get(field)
        host_tf = self.host.text_fields.get(field)
        if dev_tf is None or host_tf is None or not terms:
            return _empty(self.dev), torch.zeros(
                self.dev.n_pad, dtype=torch.int32, device=self.device)
        doc_count, avgdl = self.ctx.text_stats(field)
        offs, lens, idfs = [], [], []
        for t in terms:
            tid = host_tf.term_dict.get(t)
            if tid is None:
                offs.append(0)
                lens.append(0)
                idfs.append(0.0)
            else:
                offs.append(int(host_tf.term_offsets[tid]))
                lens.append(int(host_tf.term_offsets[tid + 1]
                                - host_tf.term_offsets[tid]))
                idfs.append(bm25.idf(self.ctx.text_df(field, t), doc_count))
        window = pad_window(max(lens) if lens else 1)
        # the per-term rows stay host numpy: they are the path's only
        # per-query transfer (the postings live on the device), and the
        # profiler counts transfer bytes from host-typed arguments
        scores, counts = bm25.bm25_term_scores(
            dev_tf.postings_docs, dev_tf.postings_tfs, dev_tf.doc_len,
            np.asarray(offs, np.int32), np.asarray(lens, np.int32),
            np.asarray(idfs, np.float32), np.float32(avgdl),
            n_pad=self.dev.n_pad, window=window)
        mask = counts > 0
        return NodeResult(scores=scores * boost, mask=mask,
                          scoring=True), counts

    # -- dispatch ----------------------------------------------------------

    def execute(self, node: q.QueryNode) -> NodeResult:
        name = type(node).__name__
        method = getattr(self, f"_exec_{name}", None)
        if method is None:
            raise ParsingException(f"unexecutable query node [{name}]")
        prof = profile.active()
        if prof is None:
            return method(node)
        # nested execute() calls (bool children, rescore, function_score
        # inners) build the operator tree; the same node across segments
        # accumulates into one operator
        with prof.operator(name, profile.describe_node(node)):
            return method(node)

    def _exec_MatchAllQuery(self, node: q.MatchAllQuery) -> NodeResult:
        return _const_result(self.dev.live, node.boost, scoring=True)

    def _exec_MatchNoneQuery(self, node: q.MatchNoneQuery) -> NodeResult:
        return _empty(self.dev)

    def _exec_MatchQuery(self, node: q.MatchQuery) -> NodeResult:
        ms = self.ctx.mapper_service
        mapper = ms.field_mapper(node.field)
        if (mapper is None and ms.flat_object_parent(node.field)) or (
                mapper is not None and mapper.type != "text"):
            # match on a non-text field is a term query (no analysis)
            return self._exec_TermQuery(q.TermQuery(
                field=node.field, value=node.query, boost=node.boost))
        terms = ms.analyze_query_text(node.field, node.query)
        if not terms:
            # zero analyzed tokens (all stopwords) match nothing, like the
            # reference's MatchNoDocsQuery rewrite
            return _empty(self.dev)
        result, counts = self._bm25(node.field, terms, node.boost)
        mask = result.mask
        if node.operator == "and":
            mask = counts >= len(terms)
        elif node.minimum_should_match is not None:
            mask = counts >= node.minimum_should_match
        return NodeResult(result.scores, mask & self.dev.live, True)

    def _exec_MatchPhraseQuery(self, node: q.MatchPhraseQuery) -> NodeResult:
        # the device conjunction narrows the candidates; the host segment's
        # positions CSR verifies adjacency (Lucene's PhraseQuery)
        terms = self.ctx.mapper_service.analyze_query_text(node.field,
                                                           node.query)
        if not terms:
            return _empty(self.dev)
        result, counts = self._bm25(node.field, terms, node.boost)
        conj = (counts >= len(terms)) & self.dev.live
        host_tf = self.host.text_fields.get(node.field)
        if len(terms) <= 1 or host_tf is None or not host_tf.has_positions:
            # one term, or a segment without positions: the conjunction is
            # the best available answer
            return NodeResult(result.scores, conj, True)
        cand = np.nonzero(conj.cpu().numpy()[: self.host.n_docs])[0]
        verified = np.zeros(self.dev.n_pad, bool)
        for d in cand:
            lists = [host_tf.term_positions(t, int(d)) for t in terms]
            if _phrase_match(lists, node.slop, terms):
                verified[d] = True
        mask = self._to_device(verified)
        return NodeResult(torch.where(mask, result.scores, 0.0), mask, True)

    def _exec_IntervalsQuery(self, node: q.IntervalsQuery) -> NodeResult:
        from opensearch_tpu_torch.search import intervals as iv

        host_tf = self.host.text_fields.get(node.field)
        if host_tf is None or not host_tf.has_positions:
            return _empty(self.dev)
        ms = self.ctx.mapper_service

        def analyze(text: str, analyzer: str | None) -> list[str]:
            if analyzer:
                return ms.analysis.get(analyzer).analyze(text)
            return ms.analyze_query_text(node.field, text)

        ctx = iv.IntervalContext(
            analyze=analyze,
            vocab=host_tf.terms,
            positions=lambda t, d: host_tf.term_positions(t, d),
            edit_distance_at_most=_edit_distance_at_most,
            fuzziness_distance=_fuzziness_distance,
        )
        # candidate docs: the union of every involved term's postings
        cand: set[int] = set()
        for t in ctx.leaf_terms(node.source):
            tid = host_tf.term_dict.get(t)
            if tid is None:
                continue
            off = int(host_tf.term_offsets[tid])
            end = int(host_tf.term_offsets[tid + 1])
            cand.update(int(d) for d in host_tf.postings_docs[off:end])
        live = self.dev.live.cpu().numpy()
        mask = np.zeros(self.dev.n_pad, bool)
        for d in sorted(cand):
            if live[d] and iv.evaluate(node.source, ctx, d):
                mask[d] = True
        return _const_result(self._to_device(mask), node.boost, scoring=True)

    def _exec_MultiMatchQuery(self, node: q.MultiMatchQuery) -> NodeResult:
        msm = node.minimum_should_match

        def fboost(f: str) -> float:
            return node.boost * node.field_boosts.get(f, 1.0)

        if node.type == "bool_prefix":
            per_field = [
                self._exec_MatchBoolPrefixQuery(q.MatchBoolPrefixQuery(
                    field=f, query=node.query, operator=node.operator,
                    minimum_should_match=msm, fuzziness=node.fuzziness,
                    analyzer=node.analyzer, boost=fboost(f)))
                for f in node.fields]
        elif node.type == "phrase":
            per_field = [
                self._exec_MatchPhraseQuery(q.MatchPhraseQuery(
                    field=f, query=node.query, slop=node.slop,
                    boost=fboost(f)))
                for f in node.fields]
        elif node.type == "phrase_prefix":
            per_field = [
                self._exec_MatchPhrasePrefixQuery(q.MatchPhrasePrefixQuery(
                    field=f, query=node.query, boost=fboost(f)))
                for f in node.fields]
        else:
            per_field = None
        if per_field is not None:
            if not per_field:
                return _empty(self.dev)
            mask = per_field[0].mask
            scores = per_field[0].scores
            for s in per_field[1:]:
                mask = mask | s.mask
                scores = torch.maximum(scores, s.scores)
            return NodeResult(scores=scores, mask=mask, scoring=True)
        subs = [
            self._exec_MatchQuery(q.MatchQuery(
                field=f, query=node.query, boost=fboost(f),
                operator=node.operator,
                minimum_should_match=(
                    int(msm) if isinstance(msm, int) or
                    (isinstance(msm, str) and msm.lstrip("-").isdigit())
                    else None)))
            for f in node.fields]
        if not subs:
            return _empty(self.dev)
        mask = subs[0].mask
        for s in subs[1:]:
            mask = mask | s.mask
        if node.type == "most_fields":
            scores = subs[0].scores
            for s in subs[1:]:
                scores = scores + s.scores
        else:  # best_fields: max over fields
            scores = subs[0].scores
            for s in subs[1:]:
                scores = torch.maximum(scores, s.scores)
        return NodeResult(scores=scores, mask=mask, scoring=True)

    def _normalize_kw(self, field: str, value: str) -> str:
        mapper = self.ctx.mapper_service.field_mapper(field)
        if mapper is not None and mapper.normalizer == "lowercase":
            return value.lower()
        return value

    def _exec_TermQuery(self, node: q.TermQuery) -> NodeResult:
        field, value = node.field, node.value
        if field == "_id":
            return self._exec_IdsQuery(q.IdsQuery(values=[str(value)],
                                                  boost=node.boost))
        ms = self.ctx.mapper_service
        mapper = ms.field_mapper(field)
        if mapper is None:
            # a flat_object sub-path: a term on the shared "{root}#paths"
            # column with a "sub.path=value" entry
            flat = ms.flat_object_parent(field)
            if flat is not None:
                root, subpath = flat
                return self._exec_TermQuery(q.TermQuery(
                    field=f"{root}#paths", value=f"{subpath}={value}",
                    case_insensitive=node.case_insensitive,
                    boost=node.boost))
        ftype = mapper.type if mapper else None
        if ftype == "flat_object":
            ftype = "keyword"
        if mapper is not None and mapper.normalizer == "lowercase" \
                and isinstance(value, str):
            value = value.lower()
        if ftype == "text":
            result, _counts = self._bm25(field, [str(value)], node.boost)
            return NodeResult(result.scores, result.mask & self.dev.live,
                              True)
        if ftype == "keyword" or (ftype is None
                                  and field in self.host.keyword_fields):
            if node.case_insensitive:
                want = str(value).lower()
                return self._multi_term_result(
                    field, lambda t: t.lower() == want, node.boost)
            if mapper is not None and mapper.original_type == "ip" \
                    and "/" in str(value):
                # a CIDR term: any stored address inside the subnet
                import ipaddress

                try:
                    net = ipaddress.ip_network(str(value), strict=False)
                except ValueError as e:
                    raise IllegalArgumentException(
                        f"invalid IP subnet [{value}]: {e}") from None
                return self._multi_term_result(
                    field,
                    lambda t: (lambda a: a is not None and a in net)(
                        _try_ip(t)),
                    node.boost)
            kf_dev = self.dev.keyword_fields.get(field)
            kf_host = self.host.keyword_fields.get(field)
            if kf_dev is None:
                return _empty(self.dev)
            qord = kf_host.ord_dict.get(str(value), -3)
            mask = filters.term_mask_keyword(
                kf_dev.mv_ords, kf_dev.mv_docs, qord,
                self.dev.n_pad) & self.dev.live
            # keyword term scoring: norms omitted, idf * tf / (tf + k1), tf 1
            df = self.ctx.keyword_df(field, str(value))
            doc_count = max(self.ctx.keyword_doc_count(field), 1)
            score = (bm25.idf(df, doc_count) / (1.0 + bm25.K1_DEFAULT)
                     if df else 0.0)
            return _const_result(mask, score * node.boost, scoring=True)
        if ftype == "boolean":
            want = 1 if value in (True, "true", 1) else 0
            return self._numeric_range(field, want, None, want, None,
                                       node.boost)
        if ftype == "date":
            ms_v = (parse_date_nanos(value) if mapper.resolution == "nanos"
                    else parse_date_millis(value))
            return self._numeric_range(field, ms_v, None, ms_v, None,
                                       node.boost)
        if ftype in INT_TYPES or ftype in FLOAT_TYPES or ftype is None:
            return self._numeric_range(field, value, None, value, None,
                                       node.boost)
        raise IllegalArgumentException(
            f"term query on unsupported field [{field}]")

    def _exec_TermsQuery(self, node: q.TermsQuery) -> NodeResult:
        if node.field == "_id":
            return self._exec_IdsQuery(q.IdsQuery(
                values=[str(v) for v in node.values], boost=node.boost))
        ms = self.ctx.mapper_service
        mapper = ms.field_mapper(node.field)
        if mapper is None:
            flat = ms.flat_object_parent(node.field)
            if flat is not None:
                root, subpath = flat
                return self._exec_TermsQuery(q.TermsQuery(
                    field=f"{root}#paths",
                    values=[f"{subpath}={v}" for v in node.values],
                    boost=node.boost))
        ftype = mapper.type if mapper else None
        if ftype in ("keyword", "flat_object"):
            kf_dev = self.dev.keyword_fields.get(node.field)
            kf_host = self.host.keyword_fields.get(node.field)
            if kf_dev is None:
                return _empty(self.dev)
            ords = [kf_host.ord_dict.get(
                self._normalize_kw(node.field, str(v)), -3)
                for v in node.values]
            t_pad = max(pad_window(len(ords)), 8)
            ords_arr = np.full(t_pad, -3, np.int32)
            ords_arr[: len(ords)] = ords
            mask = filters.terms_mask_keyword(
                kf_dev.mv_ords, kf_dev.mv_docs, self._to_device(ords_arr),
                self.dev.n_pad) & self.dev.live
            return _const_result(mask, node.boost, scoring=True)
        # numeric / text: the OR of term queries
        out: NodeResult | None = None
        for v in node.values:
            r = self._exec_TermQuery(q.TermQuery(field=node.field, value=v,
                                                 boost=node.boost))
            out = r if out is None else NodeResult(
                torch.maximum(out.scores, r.scores), out.mask | r.mask, True)
        return out if out is not None else _empty(self.dev)

    def _exec_range_field(self, node: q.RangeQuery, mapper) -> NodeResult:
        """A range query against a range field (doc values are intervals in
        the `{field}#lo` / `{field}#hi` columns):
          intersects: doc.lo <= q.hi AND doc.hi >= q.lo
          contains:   doc.lo <= q.lo AND doc.hi >= q.hi
          within:     doc.lo >= q.lo AND doc.hi <= q.hi"""
        from opensearch_tpu_torch.index.mapper import range_value_bounds

        try:
            q_lo, q_hi = range_value_bounds(
                mapper.type,
                {"gte": node.gte, "gt": node.gt,
                 "lte": node.lte, "lt": node.lt},
                mapper.format)
        except (ValueError, TypeError) as e:
            raise IllegalArgumentException(
                f"failed to parse range query on [{node.field}]: {e}"
            ) from None
        lo_f, hi_f = f"{node.field}#lo", f"{node.field}#hi"
        relation = node.relation or "intersects"
        if relation == "contains":
            a = self._numeric_range(lo_f, None, None, q_lo, None, 1.0)
            b = self._numeric_range(hi_f, q_hi, None, None, None, 1.0)
        elif relation == "within":
            a = self._numeric_range(lo_f, q_lo, None, None, None, 1.0)
            b = self._numeric_range(hi_f, None, None, q_hi, None, 1.0)
        elif relation == "intersects":
            a = self._numeric_range(lo_f, None, None, q_hi, None, 1.0)
            b = self._numeric_range(hi_f, q_lo, None, None, None, 1.0)
        else:
            raise IllegalArgumentException(
                f"[range] unknown relation [{relation}]")
        mask = a.mask & b.mask & self.dev.live
        return _const_result(mask, node.boost, scoring=True)

    def _numeric_range(self, field: str, gte: Any, gt: Any, lte: Any,
                       lt: Any, boost: float) -> NodeResult:
        nf_dev = self.dev.numeric_fields.get(field)
        nf_host = self.host.numeric_fields.get(field)
        if nf_dev is None:
            return _empty(self.dev)
        mapper = self.ctx.mapper_service.field_mapper(field)
        is_date = mapper is not None and mapper.type == "date"
        nanos = is_date and mapper.resolution == "nanos"
        unsigned = mapper is not None and \
            mapper.original_type == "unsigned_long"

        def conv(v: Any) -> Any:
            if v is None:
                return None
            if nanos:
                return parse_date_nanos(v)
            if unsigned:
                return int(str(v), 10) - 2**63  # biased storage
            return parse_date_millis(v) if is_date else v

        gte, gt, lte, lt = conv(gte), conv(gt), conv(lte), conv(lt)
        if nf_host is not None and nf_host.mv_offsets is not None:
            # multi-valued docs: a doc matches if ANY value is in range
            # (SortedNumericDocValues), a host scan of the CSR
            mv = nf_host.mv_values
            if nf_host.kind == "int":
                lo_b = I64_MIN if gte is None and gt is None else (
                    int(gte) if gte is not None else int(gt) + 1)
                hi_b = I64_MAX if lte is None and lt is None else (
                    int(lte) if lte is not None else int(lt) - 1)
                sel = (mv >= lo_b) & (mv <= hi_b)
            else:
                lo_v = float(gte) if gte is not None else (
                    float(gt) if gt is not None else -np.inf)
                hi_v = float(lte) if lte is not None else (
                    float(lt) if lt is not None else np.inf)
                sel = np.ones(len(mv), bool)
                sel &= (mv > lo_v) if gt is not None else (mv >= lo_v)
                sel &= (mv < hi_v) if lt is not None else (mv <= hi_v)
            mask_host = np.zeros(self.dev.n_pad, bool)
            idx = np.nonzero(sel)[0]
            if len(idx):
                # entry index -> owning doc through the CSR offsets
                doc_of = np.searchsorted(nf_host.mv_offsets, idx,
                                         side="right") - 1
                mask_host[np.unique(doc_of)] = True
            return _const_result(self._to_device(mask_host) & self.dev.live,
                                 boost, scoring=True)
        if nf_dev.kind == "int":
            lo_bound = I64_MIN if gte is None and gt is None else (
                int(gte) if gte is not None else int(gt) + 1)
            hi_bound = I64_MAX if lte is None and lt is None else (
                int(lte) if lte is not None else int(lt) - 1)
            mask = filters.range_mask_i64(
                nf_dev.hi, nf_dev.lo, nf_dev.present,
                *i64_query_words(lo_bound), *i64_query_words(hi_bound))
        else:
            lo_v = float(gte) if gte is not None else (
                float(gt) if gt is not None else -np.inf)
            hi_v = float(lte) if lte is not None else (
                float(lt) if lt is not None else np.inf)
            mask = filters.range_mask_f32(
                nf_dev.values, nf_dev.present, lo_v, hi_v, gt is not None,
                lt is not None)
        return _const_result(mask & self.dev.live, boost, scoring=True)

    def _exec_RangeQuery(self, node: q.RangeQuery) -> NodeResult:
        ms = self.ctx.mapper_service
        mapper = ms.field_mapper(node.field)
        if mapper is not None and mapper.type in RANGE_TYPES:
            return self._exec_range_field(node, mapper)
        if mapper is not None and mapper.type == "flat_object":
            # the root column is keyword-shaped: a lexicographic range
            from opensearch_tpu_torch.index.mapper import FieldMapper

            mapper = FieldMapper(node.field, "keyword")
        if mapper is None:
            flat = ms.flat_object_parent(node.field)
            if flat is not None:
                root, sub = flat
                # a lexicographic range inside the "sub=value" entries; the
                # constant "sub=" prefix keeps the bounds in this sub-path
                return self._exec_RangeQuery(q.RangeQuery(
                    field=f"{root}#paths",
                    gte=(f"{sub}={node.gte}" if node.gte is not None
                         else f"{sub}="),
                    gt=f"{sub}={node.gt}" if node.gt is not None else None,
                    lte=(f"{sub}={node.lte}" if node.lte is not None
                         else f"{sub}=\uffff"),
                    lt=f"{sub}={node.lt}" if node.lt is not None else None,
                    boost=node.boost))
        if mapper is not None and mapper.type == "keyword":
            # a lexicographic range over the sorted ordinals
            import bisect

            kf_host = self.host.keyword_fields.get(node.field)
            kf_dev = self.dev.keyword_fields.get(node.field)
            if kf_host is None:
                return _empty(self.dev)
            vals = kf_host.ord_values
            lo, hi = 0, len(vals) - 1
            if node.gte is not None:
                lo = bisect.bisect_left(vals, str(node.gte))
            if node.gt is not None:
                lo = max(lo, bisect.bisect_right(vals, str(node.gt)))
            if node.lte is not None:
                hi = bisect.bisect_right(vals, str(node.lte)) - 1
            if node.lt is not None:
                hi = min(hi, bisect.bisect_left(vals, str(node.lt)) - 1)
            if hi < lo:
                return _empty(self.dev)
            in_range = (kf_dev.mv_ords >= lo) & (kf_dev.mv_ords <= hi)
            mask = filters._docs_any(in_range, kf_dev.mv_docs,
                                     self.dev.n_pad) & self.dev.live
            return _const_result(mask, node.boost, scoring=True)
        return self._numeric_range(node.field, node.gte, node.gt, node.lte,
                                   node.lt, node.boost)

    def _exec_ExistsQuery(self, node: q.ExistsQuery) -> NodeResult:
        field = node.field
        ms = self.ctx.mapper_service
        flat = ms.flat_object_parent(field)
        if flat is not None and ms.mappers.get(field) is None:
            root, subpath = flat
            # a sub-path exists: any "{subpath}=value" entry in #paths, or
            # any deeper "{subpath}.x=value" entry
            r1 = self._exec_PrefixQuery(q.PrefixQuery(
                field=f"{root}#paths", value=f"{subpath}=", boost=node.boost))
            r2 = self._exec_PrefixQuery(q.PrefixQuery(
                field=f"{root}#paths", value=f"{subpath}.", boost=node.boost))
            return NodeResult(torch.maximum(r1.scores, r2.scores),
                              r1.mask | r2.mask, True)
        dev = self.dev
        if all(field not in cols for cols in (
                dev.numeric_fields, dev.vector_fields, dev.keyword_fields,
                dev.text_fields)):
            # an object prefix: exists == any mapped child exists
            children = [name for name in ms.mappers
                        if name.startswith(f"{field}.")]
            out = None
            for child in children:
                r = self._exec_ExistsQuery(q.ExistsQuery(field=child,
                                                         boost=node.boost))
                out = r if out is None else NodeResult(
                    torch.maximum(out.scores, r.scores), out.mask | r.mask,
                    True)
            if out is not None:
                return out
        masks = []
        for cols in (dev.numeric_fields, dev.vector_fields):
            if field in cols:
                masks.append(filters.exists_mask(cols[field].present))
        if field in dev.keyword_fields:
            masks.append(dev.keyword_fields[field].first_ord >= 0)
        if field in dev.text_fields:
            masks.append(dev.text_fields[field].doc_len > 0)
        if not masks:
            return _empty(dev)
        mask = masks[0]
        for m in masks[1:]:
            mask = mask | m
        return _const_result(mask & dev.live, node.boost, scoring=True)

    def _exec_IdsQuery(self, node: q.IdsQuery) -> NodeResult:
        mask_host = np.zeros(self.dev.n_pad, dtype=bool)
        for doc_id in node.values:
            # doc_index (not local_doc): liveness comes from the snapshot's
            # device mask, so a pinned reader stays point-in-time
            d = self.host.doc_index(doc_id)
            if d is not None:
                mask_host[d] = True
        return _const_result(self._to_device(mask_host) & self.dev.live,
                             node.boost, True)

    def _exec_ConstantScoreQuery(self,
                                 node: q.ConstantScoreQuery) -> NodeResult:
        inner = self.execute(node.filter)
        return _const_result(inner.mask, node.boost, scoring=True)

    def _exec_BoolQuery(self, node: q.BoolQuery) -> NodeResult:
        n_pad = self.dev.n_pad
        mask = self.dev.live
        scores = torch.zeros(n_pad, dtype=torch.float32, device=self.device)
        any_scoring = False
        for sub in node.must:
            r = self.execute(sub)
            mask = mask & r.mask
            if r.scoring:
                any_scoring = True
            scores = scores + r.scores
        for sub in node.filter:
            mask = mask & self.execute(sub).mask
        for sub in node.must_not:
            mask = mask & ~self.execute(sub).mask
        if node.should:
            should_results = [self.execute(sub) for sub in node.should]
            should_count = torch.zeros(n_pad, dtype=torch.int32,
                                       device=self.device)
            for r in should_results:
                should_count = should_count + r.mask.to(torch.int32)
                scores = scores + torch.where(r.mask, r.scores, 0.0)
                if r.scoring:
                    any_scoring = True
            msm = node.minimum_should_match
            if msm is None:
                msm = 1 if not (node.must or node.filter) else 0
            if msm > 0:
                mask = mask & (should_count >= msm)
        # the scores of non-matching docs are zeroed (a must_not can strike
        # a doc that a should scored)
        scores = torch.where(mask, scores, 0.0) * node.boost
        return NodeResult(scores=scores, mask=mask, scoring=any_scoring)

    def _exec_KnnQuery(self, node: q.KnnQuery) -> NodeResult:
        # k applies per SHARD: the ShardContext caches the shard-wide
        # selection per query node
        selections = self.ctx.shard_knn_selection(node)
        seg_idx = next(
            i for i, (_h, d) in enumerate(self.ctx.snapshot.segments)
            if d is self.dev)
        sel_host, scores_host = selections[seg_idx]
        if scores_host is None:
            return _empty(self.dev)
        # a host-resident result: the shard cut already chose the winners;
        # device tensors are made only if a compound parent reads them
        out_scores = np.where(
            sel_host & np.isfinite(scores_host), scores_host, 0.0
        ).astype(np.float32)
        if node.boost != 1.0:
            out_scores *= np.float32(node.boost)
        return HostNodeResult(out_scores, sel_host, scoring=True,
                              device=self.device)

    # -- the rest of the DSL -------------------------------------------------
    # Per-doc values come from the host segment's exact columns (float64
    # and int64), as the reference computes them in numpy; the mask or
    # the float32 scores go to the device once.

    def _host_result(self, mask_host: np.ndarray, boost: float,
                     scoring: bool = True) -> NodeResult:
        """A constant-score result over a host mask of the segment's docs
        (or of its n_pad slots), ANDed with the live bitmap."""
        mask = np.zeros(self.dev.n_pad, bool)
        mask[: len(mask_host)] = mask_host
        return _const_result(self._to_device(mask) & self.dev.live, boost,
                             scoring)

    def _host_scores(self, scores: np.ndarray,
                     mask_host: np.ndarray) -> NodeResult:
        """A scoring result from float32 host scores [n_pad] and a host
        mask of the segment's docs, ANDed with the live bitmap."""
        mask = np.zeros(self.dev.n_pad, bool)
        mask[: len(mask_host)] = mask_host
        mask_d = self._to_device(mask) & self.dev.live
        return NodeResult(torch.where(mask_d, self._to_device(scores), 0.0),
                          mask_d, True)

    def _exec_SliceQuery(self, node: q.SliceQuery) -> NodeResult:
        """A sliced read: murmur3(_id) % max == id (SliceBuilder's default
        partitioning by _id); each doc's hash made once a segment."""
        host = self.host
        cache = getattr(host, "_slice_hash_cache", None)
        if cache is None:
            cache = np.asarray([murmur3_x86_32(i.encode()) & 0xFFFFFFFF
                                for i in host.doc_ids], np.uint32)
            host._slice_hash_cache = cache
        return self._host_result((cache % np.uint32(node.max)) == node.id,
                                 node.boost, scoring=False)

    def _exec_TermsSetQuery(self, node: q.TermsSetQuery) -> NodeResult:
        """Each doc's matching terms counted against its own
        minimum_should_match (TermsSetQueryBuilder -> CoveringQuery)."""
        field = node.field
        ms = self.ctx.mapper_service
        mapper = ms.field_mapper(field)
        if mapper is None:
            flat = ms.flat_object_parent(field)
            if flat is not None:
                root, subpath = flat
                return self._exec_TermsSetQuery(q.TermsSetQuery(
                    field=f"{root}#paths",
                    terms=[f"{subpath}={t}" for t in node.terms],
                    minimum_should_match_field=node.minimum_should_match_field,
                    minimum_should_match_script=(
                        node.minimum_should_match_script),
                    boost=node.boost))
        n = self.host.n_docs
        kf_host = self.host.keyword_fields.get(field)
        counts = np.zeros(n, np.int64)
        if kf_host is not None:
            for v in node.terms:
                o = kf_host.ord_dict.get(self._normalize_kw(field, str(v)))
                if o is None:
                    continue
                np.add.at(counts, kf_host.mv_docs[kf_host.mv_ords == o], 1)
        elif mapper is not None and mapper.type == "text":
            tf_host = self.host.text_fields.get(field)
            if tf_host is not None:
                for v in node.terms:
                    tid = tf_host.term_dict.get(str(v))
                    if tid is None:
                        continue
                    off = int(tf_host.term_offsets[tid])
                    end = int(tf_host.term_offsets[tid + 1])
                    counts[tf_host.postings_docs[off:end]] += 1
        if node.minimum_should_match_field:
            nf = self.host.numeric_fields.get(node.minimum_should_match_field)
            if nf is None:
                return _empty(self.dev)
            msm = np.where(nf.present[:n],
                           (nf.values_i64 if nf.kind == "int"
                            else nf.values_f64)[:n],
                           np.iinfo(np.int32).max)
        elif node.minimum_should_match_script:
            src = str(node.minimum_should_match_script.get("source", ""))
            # the common forms: params.num_terms, or a constant
            if "num_terms" in src:
                msm = np.full(n, len(node.terms))
            else:
                try:
                    msm = np.full(n, int(float(src)))
                except ValueError:
                    msm = np.full(n, 1)
        else:
            raise IllegalArgumentException(
                "[terms_set] requires [minimum_should_match_field] or "
                "[minimum_should_match_script]")
        return self._host_result((counts >= msm) & (counts > 0), node.boost)

    def _exec_DistanceFeatureQuery(self,
                                   node: q.DistanceFeatureQuery) -> NodeResult:
        """score = boost * pivot / (pivot + distance(origin, value)), in
        float64 on the host, rounded to float32 once."""
        field = node.field
        mapper = self.ctx.mapper_service.field_mapper(field)
        n = self.host.n_docs
        lat_f = self.host.numeric_fields.get(f"{field}#lat")
        if mapper is not None and mapper.type == "geo_point" \
                or lat_f is not None:
            lon_f = self.host.numeric_fields.get(f"{field}#lon")
            if lat_f is None or lon_f is None:
                return _empty(self.dev)
            o_lat, o_lon = _parse_geo_origin(node.origin)
            pivot_m = _parse_distance_meters(node.pivot)
            dist = _haversine_m(o_lat, o_lon, lat_f.values_f64[:n],
                                lon_f.values_f64[:n])
            score = np.where(lat_f.present[:n], pivot_m / (pivot_m + dist),
                             0.0)
        else:
            nf = self.host.numeric_fields.get(field)
            if nf is None:
                return _empty(self.dev)
            is_date = mapper is not None and mapper.type == "date"
            if is_date and getattr(mapper, "resolution", "millis") == "nanos":
                origin = float(parse_date_nanos(str(node.origin)))
                pivot = float(_duration_millis(node.pivot)) * 1e6
            elif is_date:
                origin = float(_parse_date_or_now(node.origin))
                pivot = float(_duration_millis(node.pivot))
            else:
                origin = float(node.origin)
                pivot = float(node.pivot)
            vals = (nf.values_i64 if nf.kind == "int" else nf.values_f64)[:n]
            dist = np.abs(vals.astype(np.float64) - origin)
            score = np.where(nf.present[:n], pivot / (pivot + dist), 0.0)
        scores = np.zeros(self.dev.n_pad, np.float32)
        scores[:n] = score * node.boost
        return self._host_scores(scores, scores > 0)

    def _exec_RankFeatureQuery(self, node: q.RankFeatureQuery) -> NodeResult:
        """saturation: v / (v + pivot), the default pivot the mean over
        the whole shard; log: ln(scaling_factor + v); sigmoid: v^e /
        (v^e + pivot^e); linear: v. float64 on the host."""
        nf = self.host.numeric_fields.get(node.field)
        if nf is None:
            return _empty(self.dev)
        n = self.host.n_docs
        vals = (nf.values_i64 if nf.kind == "int" else nf.values_f64)[:n]
        vals = vals.astype(np.float64)
        present = nf.present[:n]

        def default_pivot() -> float:
            # over the WHOLE shard in float64, as the reference sums it (a
            # per-segment pivot would rank equal features apart)
            total, count = 0.0, 0
            for h, _d in self.ctx.snapshot.segments:
                f = h.numeric_fields.get(node.field)
                if f is None:
                    continue
                v = (f.values_i64 if f.kind == "int" else f.values_f64)[
                    : h.n_docs]
                p = f.present[: h.n_docs]
                total += float(v[p].sum())
                count += int(p.sum())
            return max(total / count if count else 1.0, 1e-9)

        if node.function == "log":
            score = np.log(np.maximum(node.scaling_factor + vals, 1e-12))
        elif node.function == "linear":
            score = vals
        elif node.function == "sigmoid":
            pivot = node.pivot if node.pivot is not None else default_pivot()
            ve = np.power(vals, node.exponent)
            score = ve / (ve + pivot ** node.exponent)
        else:  # saturation
            pivot = node.pivot if node.pivot is not None else default_pivot()
            score = vals / (vals + pivot)
        scores = np.zeros(self.dev.n_pad, np.float32)
        scores[:n] = np.where(present, score, 0.0) * node.boost
        return self._host_scores(scores, present)

    def _geo_match_docs(self, field: str, point_pred) -> np.ndarray | None:
        """bool [n_docs]: a doc matches if ANY of its points satisfies
        `point_pred(lat_array, lon_array)` (a multi-valued geo_point keeps
        parallel lat / lon CSRs)."""
        lat_f = self.host.numeric_fields.get(f"{field}#lat")
        lon_f = self.host.numeric_fields.get(f"{field}#lon")
        if lat_f is None or lon_f is None:
            return None
        n = self.host.n_docs
        out = np.zeros(n, bool)
        if lat_f.mv_offsets is not None and lon_f.mv_offsets is not None:
            idx = np.nonzero(point_pred(lat_f.mv_values, lon_f.mv_values))[0]
            if len(idx):
                doc_of = np.searchsorted(lat_f.mv_offsets, idx,
                                         side="right") - 1
                out[np.unique(doc_of)] = True
            return out
        sel = point_pred(lat_f.values_f64[:n], lon_f.values_f64[:n])
        out[:n] = lat_f.present[:n] & sel
        return out

    def _geo_result(self, field: str, point_pred, boost: float) -> NodeResult:
        sel = self._geo_match_docs(field, point_pred)
        if sel is None:
            return _empty(self.dev)
        return self._host_result(sel, boost)

    def _exec_GeoDistanceQuery(self, node: q.GeoDistanceQuery) -> NodeResult:
        o_lat, o_lon = _parse_geo_origin(node.point)
        radius = _parse_distance_meters(node.distance)
        return self._geo_result(
            node.field,
            lambda la, lo: _haversine_m(o_lat, o_lon, la, lo) <= radius,
            node.boost)

    def _exec_GeoShapeQuery(self, node: q.GeoShapeQuery) -> NodeResult:
        """geo_shape over point columns: the shape's bounding box is the
        region (exact for an envelope or a point; a polygon matches by its
        box, the reference's stated approximation)."""
        shape = node.shape or {}
        styp = str(shape.get("type", "")).lower()
        coords = shape.get("coordinates")
        if styp == "point":
            lons, lats = [coords[0]], [coords[1]]
        elif styp == "envelope":
            (tl_lon, tl_lat), (br_lon, br_lat) = coords
            lons, lats = [tl_lon, br_lon], [tl_lat, br_lat]
        elif styp in ("polygon", "multipoint", "linestring"):
            flat = coords[0] if styp == "polygon" else coords
            lons = [c[0] for c in flat]
            lats = [c[1] for c in flat]
        else:
            raise IllegalArgumentException(
                f"[geo_shape] unsupported shape type [{styp}]")
        lat_hi, lat_lo = max(lats), min(lats)
        lon_hi, lon_lo = max(lons), min(lons)

        def pred(la, lo):
            inside = (la >= lat_lo) & (la <= lat_hi) \
                & (lo >= lon_lo) & (lo <= lon_hi)
            return ~inside if node.relation == "disjoint" else inside

        return self._geo_result(node.field, pred, node.boost)

    def _exec_GeoBoundingBoxQuery(self,
                                  node: q.GeoBoundingBoxQuery) -> NodeResult:
        tl_lat, tl_lon = _parse_geo_origin(node.top_left)
        br_lat, br_lon = _parse_geo_origin(node.bottom_right)

        def pred(la, lo):
            box = (la <= tl_lat) & (la >= br_lat)
            if tl_lon <= br_lon:
                return box & (lo >= tl_lon) & (lo <= br_lon)
            return box & ((lo >= tl_lon) | (lo <= br_lon))

        return self._geo_result(node.field, pred, node.boost)

    def _exec_NestedQuery(self, node: q.NestedQuery) -> NodeResult:
        # flattened: arrays of objects are multi-valued dotted columns, so
        # the inner query already addresses path.field
        r = self.execute(node.query)
        return NodeResult(r.scores * node.boost, r.mask, r.scoring)

    def _exec_MoreLikeThisQuery(self, node: q.MoreLikeThisQuery) -> NodeResult:
        return self.execute(self.ctx.mlt_rewrite(node))

    def _seg_index(self) -> int:
        for i, (host, _dev) in enumerate(self.ctx.snapshot.segments):
            if host is self.host:
                return i
        return 0

    def _exec_PercolateQuery(self, node: q.PercolateQuery) -> NodeResult:
        return self._host_result(
            self.ctx.percolate_masks(node)[self._seg_index()], node.boost)

    def _join_result(self, node) -> NodeResult:
        return self._host_result(
            self.ctx.join_masks(node)[self._seg_index()], node.boost)

    _exec_HasChildQuery = _join_result
    _exec_HasParentQuery = _join_result
    _exec_ParentIdQuery = _join_result

    def _exec_HybridQuery(self, node: q.HybridQuery) -> NodeResult:
        # without a search pipeline: the sub-queries' best score (with one,
        # search/service.py runs each sub-query apart and fuses them)
        return self._exec_DisMaxQuery(q.DisMaxQuery(
            queries=node.queries, tie_breaker=0.0, boost=node.boost))

    # -- script nodes --------------------------------------------------------

    def _inner_or_all(self, inner) -> NodeResult:
        return self.execute(inner) if inner else \
            self._exec_MatchAllQuery(q.MatchAllQuery())

    def _exec_ScriptScoreQuery(self, node: q.ScriptScoreQuery) -> NodeResult:
        """The k-NN scoring-script forms: knn_score, cosineSimilarity,
        dotProduct and l2Squared over the inner query's docs, one float32
        product of the query vector with the segment's vector column on
        the device (ops/knn)."""
        from opensearch_tpu_torch.ops import knn as knn_ops

        inner = self._inner_or_all(node.query)
        vf = self.dev.vector_fields.get(node.field)
        if vf is None:
            return _empty(self.dev)
        valid = vf.present & inner.mask
        qv = self._to_device(np.asarray([node.query_vector], np.float32))
        if node.function == "knn_score":
            scores = knn_ops.exact_knn_scores(qv, vf.vectors, vf.norms_sq,
                                              valid, node.space_type)[0]
            scores = torch.where(valid, scores, 0.0)
        else:
            raw = knn_ops.raw_similarity(
                qv, vf.vectors, vf.norms_sq,
                "l2_norm" if node.space_type == "l2_raw"
                else node.space_type)[0]
            if node.space_type == "l2_raw":
                raw = torch.clamp(-raw, min=0.0)  # l2Squared: the distance
            scores = torch.where(valid, raw + node.add_constant, 0.0)
        return NodeResult(scores * node.boost, valid, True)

    def _exec_GenericScriptScoreQuery(
            self, node: q.GenericScriptScoreQuery) -> NodeResult:
        """One painless evaluation a matching doc on the host (the
        reference's ScriptScoreFunction runs a script a collected doc)."""
        from opensearch_tpu_torch.script import default_script_service

        inner = self._inner_or_all(node.query)
        ast, params = default_script_service.compile(node.script)
        n = self.host.n_docs
        mask_host = host_mask(inner)[:n]
        base = host_scores(inner)[:n]
        scores = np.zeros(self.dev.n_pad, np.float32)
        ms = self.ctx.mapper_service
        for d in np.nonzero(mask_host)[0]:
            scores[d] = default_script_service.score(
                ast, params, self.host, int(d), ms, score=float(base[d]))
        return NodeResult(self._to_device(scores) * node.boost, inner.mask,
                          True)

    def _exec_ScriptQuery(self, node: q.ScriptQuery) -> NodeResult:
        """Keeps the live docs for which the script is true: one painless
        evaluation a live doc on the host."""
        from opensearch_tpu_torch.script import default_script_service

        ast, params = default_script_service.compile(node.script)
        live = self.dev.live.cpu().numpy()[: self.host.n_docs]
        mask = np.zeros(self.dev.n_pad, bool)
        ms = self.ctx.mapper_service
        for d in np.nonzero(live)[0]:
            if default_script_service.field(ast, params, self.host, int(d),
                                            ms):
                mask[d] = True
        return _const_result(self._to_device(mask), node.boost, True)

    # -- multi-term (term-enumeration) queries -----------------------------
    # Rewritten to constant score over the matching term set (Lucene's
    # CONSTANT_SCORE_REWRITE): the term dictionary walk runs on the host,
    # and only the final doc mask goes to the device.

    def _host_mask_for_terms(self, field: str, match_fn) -> np.ndarray:
        mask = np.zeros(self.dev.n_pad, bool)
        host_tf = self.host.text_fields.get(field)
        if host_tf is not None:
            for tid, term in enumerate(host_tf.terms):
                if match_fn(term):
                    off = int(host_tf.term_offsets[tid])
                    end = int(host_tf.term_offsets[tid + 1])
                    mask[host_tf.postings_docs[off:end]] = True
        kf = self.host.keyword_fields.get(field)
        if kf is not None:
            ords = [o for o, v in enumerate(kf.ord_values) if match_fn(v)]
            if ords:
                sel = np.isin(kf.mv_ords, np.asarray(ords, kf.mv_ords.dtype))
                mask[kf.mv_docs[sel]] = True
        return mask

    def _multi_term_result(self, field: str, match_fn,
                           boost: float) -> NodeResult:
        mask = self._to_device(self._host_mask_for_terms(field, match_fn)) \
            & self.dev.live
        return _const_result(mask, boost, scoring=True)

    def _flat_node(self, node, make):
        """A multi-term query on a flat_object sub-path, rewritten onto the
        "{root}#paths" column with a "sub.path=value" pattern, or None."""
        ms = self.ctx.mapper_service
        if ms.field_mapper(node.field) is not None:
            return None
        flat = ms.flat_object_parent(node.field)
        if flat is None:
            return None
        root, subpath = flat
        return make(f"{root}#paths", f"{subpath}={node.value}")

    def _exec_PrefixQuery(self, node: q.PrefixQuery) -> NodeResult:
        flat = self._flat_node(node, lambda f, v: q.PrefixQuery(
            field=f, value=v, case_insensitive=node.case_insensitive,
            boost=node.boost))
        if flat is not None:
            return self._exec_PrefixQuery(flat)
        prefix = self._normalize_kw(node.field, node.value)
        if node.case_insensitive:
            prefix = prefix.lower()
            return self._multi_term_result(
                node.field, lambda t: t.lower().startswith(prefix),
                node.boost)
        return self._multi_term_result(
            node.field, lambda t: t.startswith(prefix), node.boost)

    def _exec_WildcardQuery(self, node: q.WildcardQuery) -> NodeResult:
        flat = self._flat_node(node, lambda f, v: q.WildcardQuery(
            field=f, value=v, case_insensitive=node.case_insensitive,
            boost=node.boost))
        if flat is not None:
            return self._exec_WildcardQuery(flat)
        wc_value = self._normalize_kw(node.field, node.value)
        m_wc = self.ctx.mapper_service.field_mapper(node.field)
        if m_wc is not None and m_wc.type == "text":
            # wildcard patterns normalize through the analyzer chain
            # (lowercase), like the classic parser's multi-term handling
            wc_value = wc_value.lower()
        rx = _wildcard_to_regex(wc_value, node.case_insensitive)
        return self._multi_term_result(
            node.field, lambda t: rx.match(t) is not None, node.boost)

    def _exec_RegexpQuery(self, node: q.RegexpQuery) -> NodeResult:
        value = self._normalize_kw(node.field, node.value)
        m = self.ctx.mapper_service.field_mapper(node.field)
        if m is not None and m.type == "text":
            # analyzed text is lowercased; the classic parser normalizes
            # multi-term patterns through the analyzer chain
            value = value.lower()
        if len(value) > 1000:
            raise IllegalArgumentException(
                f"The length of regex [{len(value)}] used in the "
                f"Regexp Query request has exceeded the allowed maximum "
                f"of [1000]. This maximum can be set by changing the "
                f"[index.max_regex_length] index level setting.")
        try:
            rx = re.compile(value,
                            re.IGNORECASE if node.case_insensitive else 0)
        except re.error as e:
            raise IllegalArgumentException(f"invalid regexp [{value}]: {e}")
        return self._multi_term_result(
            node.field, lambda t: rx.fullmatch(t) is not None, node.boost)

    def _exec_FuzzyQuery(self, node: q.FuzzyQuery) -> NodeResult:
        value = node.value
        max_d = _fuzziness_distance(node.fuzziness, value)
        plen = node.prefix_length

        def match(t: str) -> bool:
            if plen and t[:plen] != value[:plen]:
                return False
            if abs(len(t) - len(value)) > max_d:
                return False
            return _edit_distance_at_most(value, t, max_d)

        return self._multi_term_result(node.field, match, node.boost)

    def _exec_MatchPhrasePrefixQuery(
            self, node: q.MatchPhrasePrefixQuery) -> NodeResult:
        terms = self.ctx.mapper_service.analyze_query_text(node.field,
                                                           node.query)
        if not terms:
            return _empty(self.dev)
        *body_terms, last = terms
        result = None
        if body_terms:
            r, counts = self._bm25(node.field, body_terms, node.boost)
            result = NodeResult(r.scores, counts >= len(body_terms), True)
        # the final term expands as a prefix, bounded by max_expansions
        # (MultiPhrasePrefixQuery's expansion)
        expansions = 0

        def match(t: str) -> bool:
            nonlocal expansions
            if expansions >= node.max_expansions:
                return False
            if t.startswith(last):
                expansions += 1
                return True
            return False

        prefix_mask = self._to_device(
            self._host_mask_for_terms(node.field, match))
        if result is None:
            return _const_result(prefix_mask & self.dev.live, node.boost,
                                 True)
        mask = result.mask & prefix_mask & self.dev.live
        return NodeResult(torch.where(mask, result.scores, 0.0), mask, True)

    def _exec_MatchBoolPrefixQuery(
            self, node: q.MatchBoolPrefixQuery) -> NodeResult:
        ms = self.ctx.mapper_service
        if node.analyzer:
            terms = ms.analysis.get(node.analyzer).analyze(node.query)
        else:
            terms = ms.analyze_query_text(node.field, node.query)
        if not terms:
            return _empty(self.dev)
        *body_terms, last = terms

        def term_clause(t: str) -> q.QueryNode:
            if node.fuzziness is not None:
                return q.FuzzyQuery(field=node.field, value=t,
                                    fuzziness=node.fuzziness)
            return q.TermQuery(field=node.field, value=t)

        subs: list[q.QueryNode] = [term_clause(t) for t in body_terms]
        subs.append(q.PrefixQuery(field=node.field, value=last))
        if node.operator == "and":
            return self._exec_BoolQuery(q.BoolQuery(must=subs,
                                                    boost=node.boost))
        msm = node.minimum_should_match
        if msm is not None:
            try:
                msm = int(str(msm).rstrip("%"))
                if str(node.minimum_should_match).endswith("%"):
                    msm = max(1, (len(subs) * msm) // 100)
            except ValueError:
                msm = None
        return self._exec_BoolQuery(q.BoolQuery(
            should=subs, minimum_should_match=msm, boost=node.boost))

    # -- query-string family -----------------------------------------------

    def _exec_QueryStringQuery(self, node: q.QueryStringQuery) -> NodeResult:
        r = self.execute(self.ctx.rewritten_query_string(node))
        return NodeResult(r.scores * node.boost, r.mask, r.scoring)

    def _exec_SimpleQueryStringQuery(
            self, node: q.SimpleQueryStringQuery) -> NodeResult:
        r = self.execute(self.ctx.rewritten_query_string(node))
        return NodeResult(r.scores * node.boost, r.mask, r.scoring)

    # -- compound scoring queries ------------------------------------------

    def _exec_BoostingQuery(self, node: q.BoostingQuery) -> NodeResult:
        pos = self.execute(node.positive)
        neg = self.execute(node.negative)
        scores = torch.where(
            neg.mask, pos.scores * _f32(node.negative_boost, self.device),
            pos.scores)
        return NodeResult(scores * node.boost, pos.mask, True)

    def _exec_DisMaxQuery(self, node: q.DisMaxQuery) -> NodeResult:
        if not node.queries:
            return _empty(self.dev)
        subs = [self.execute(sq) for sq in node.queries]
        mask = subs[0].mask
        best = subs[0].scores
        total = subs[0].scores
        for s in subs[1:]:
            mask = mask | s.mask
            best = torch.maximum(best, s.scores)
            total = total + s.scores
        scores = best + _f32(node.tie_breaker, self.device) * (total - best)
        return NodeResult(torch.where(mask, scores, 0.0) * node.boost, mask,
                          True)

    def _exec_FunctionScoreQuery(self,
                                 node: q.FunctionScoreQuery) -> NodeResult:
        base = self.execute(node.query)
        n_pad = self.dev.n_pad
        dev = self.device
        f32 = torch.float32
        fvals: list[tuple[torch.Tensor, torch.Tensor]] = []  # (value, applies)
        for fn in node.functions:
            applies = base.mask
            if fn.filter is not None:
                applies = applies & self.execute(fn.filter).mask
            val = self._function_value(fn)
            if fn.weight is not None:
                val = val * _f32(fn.weight, dev)
            fvals.append((val, applies))

        if not fvals:
            factor = torch.ones(n_pad, dtype=f32, device=dev)
        else:
            mode = node.score_mode
            if mode == "first":
                factor = torch.ones(n_pad, dtype=f32, device=dev)
                assigned = torch.zeros(n_pad, dtype=torch.bool, device=dev)
                for val, applies in fvals:
                    take = applies & ~assigned
                    factor = torch.where(take, val, factor)
                    assigned = assigned | applies
            elif mode in ("sum", "avg"):
                total = torch.zeros(n_pad, dtype=f32, device=dev)
                cnt = torch.zeros(n_pad, dtype=f32, device=dev)
                for val, applies in fvals:
                    total = total + torch.where(applies, val, 0.0)
                    cnt = cnt + applies.to(f32)
                factor = torch.where(cnt > 0, total, 1.0)
                if mode == "avg":
                    factor = torch.where(
                        cnt > 0, total / torch.clamp(cnt, min=1.0), 1.0)
            elif mode in ("max", "min"):
                acc = torch.full((n_pad,), -np.inf if mode == "max"
                                 else np.inf, dtype=f32, device=dev)
                pick = torch.maximum if mode == "max" else torch.minimum
                for val, applies in fvals:
                    acc = torch.where(applies, pick(acc, val), acc)
                factor = torch.where(torch.isfinite(acc), acc, 1.0)
            else:  # multiply (the default)
                factor = torch.ones(n_pad, dtype=f32, device=dev)
                for val, applies in fvals:
                    factor = factor * torch.where(applies, val, 1.0)
        if np.isfinite(node.max_boost):
            factor = torch.minimum(factor, _f32(node.max_boost, dev))

        qs = base.scores
        bm = node.boost_mode
        if bm == "replace":
            scores = factor
        elif bm == "sum":
            scores = qs + factor
        elif bm == "avg":
            scores = (qs + factor) / 2.0
        elif bm == "max":
            scores = torch.maximum(qs, factor)
        elif bm == "min":
            scores = torch.minimum(qs, factor)
        else:  # multiply
            scores = qs * factor
        mask = base.mask
        if node.min_score is not None:
            mask = mask & (scores >= _f32(node.min_score, dev))
        scores = torch.where(mask, scores, 0.0) * node.boost
        return NodeResult(scores, mask, True)

    def _function_value(self, fn: q.ScoreFunction) -> torch.Tensor:
        n_pad = self.dev.n_pad
        dev = self.device
        if fn.kind == "weight":
            return torch.ones(n_pad, dtype=torch.float32, device=dev)
        if fn.kind == "random_score":
            # a deterministic per-doc hash in uint32 arithmetic (the
            # reference's seeded random_score), carried in int64
            idx = torch.arange(n_pad, dtype=torch.int64, device=dev)
            salt = (fn.seed * 40503 + 1) % 2**32
            h = (idx * 2654435761 + salt) % 2**32 & 0x7FFFFFFF
            return h.to(torch.float32) / _f32(0x7FFFFFFF, dev)
        if fn.kind == "field_value_factor":
            vals, present = self._numeric_doc_values(fn.field)
            if fn.missing is not None:
                vals = torch.where(present, vals, _f32(fn.missing, dev))
            else:
                vals = torch.where(present, vals, 1.0)
            v = vals * _f32(fn.factor, dev)
            m = fn.modifier
            if m == "log":
                v = torch.log10(torch.clamp(v, min=1e-9))
            elif m == "log1p":
                v = torch.log10(v + 1.0)
            elif m == "log2p":
                v = torch.log10(v + 2.0)
            elif m == "ln":
                v = torch.log(torch.clamp(v, min=1e-9))
            elif m == "ln1p":
                v = torch.log1p(v)
            elif m == "ln2p":
                v = torch.log(v + 2.0)
            elif m == "square":
                v = v * v
            elif m == "sqrt":
                v = torch.sqrt(torch.clamp(v, min=0.0))
            elif m == "reciprocal":
                v = 1.0 / torch.clamp(v, min=1e-9)
            return v
        if fn.kind == "decay":
            mapper = self.ctx.mapper_service.field_mapper(fn.field)
            if mapper is not None and mapper.type == "date":
                origin = (float(parse_date_millis(fn.origin))
                          if fn.origin is not None else 0.0)
                scale = float(_duration_millis(fn.scale))
                offset = (float(_duration_millis(fn.offset)) if fn.offset
                          else 0.0)
            else:
                origin = float(fn.origin if fn.origin is not None else 0.0)
                scale = float(fn.scale)
                offset = float(fn.offset or 0.0)
            vals, present = self._numeric_doc_values(fn.field)
            dist = torch.clamp(torch.abs(vals - _f32(origin, dev))
                               - _f32(offset, dev), min=0.0)
            if fn.decay_type == "gauss":
                sigma2 = -(scale ** 2) / (2.0 * np.log(fn.decay))
                out = torch.exp(-(dist ** 2) / _f32(2 * sigma2, dev))
            elif fn.decay_type == "exp":
                lam = np.log(fn.decay) / scale
                out = torch.exp(_f32(lam, dev) * dist)
            else:  # linear
                s = scale / (1.0 - fn.decay)
                out = torch.clamp((_f32(s, dev) - dist) / _f32(s, dev),
                                  min=0.0)
            return torch.where(present, out, 1.0)
        raise IllegalArgumentException(f"unknown score function [{fn.kind}]")

    def _numeric_doc_values(self, field: str
                            ) -> tuple[torch.Tensor, torch.Tensor]:
        """(float32 values, present) of a numeric or date field here."""
        nf_dev = self.dev.numeric_fields.get(field)
        nf_host = self.host.numeric_fields.get(field)
        if nf_dev is None or nf_host is None:
            return (torch.zeros(self.dev.n_pad, dtype=torch.float32,
                                device=self.device),
                    torch.zeros(self.dev.n_pad, dtype=torch.bool,
                                device=self.device))
        n = self.host.n_docs
        vals = np.zeros(self.dev.n_pad, np.float32)
        if nf_host.kind == "int":
            vals[:n] = nf_host.values_i64.astype(np.float64)[:n]
        else:
            vals[:n] = nf_host.values_f64[:n]
        return self._to_device(vals), nf_dev.present


def _wildcard_to_regex(pattern: str, case_insensitive: bool) -> re.Pattern:
    out = []
    for ch in pattern:
        if ch == "*":
            out.append(".*")
        elif ch == "?":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("".join(out) + r"\Z",
                      re.IGNORECASE if case_insensitive else 0)


def _try_ip(value: str):
    import ipaddress

    try:
        return ipaddress.ip_address(value)
    except ValueError:
        return None


# host helpers of the geo queries, which are not ported yet; the
# geo_distance aggregation (search/aggs_ext.py) reads them now
def _parse_geo_origin(origin: Any) -> tuple[float, float]:
    """(lat, lon) from the geo_point literal forms."""
    if isinstance(origin, dict) and "lat" in origin and "lon" in origin:
        return float(origin["lat"]), float(origin["lon"])
    if isinstance(origin, list) and len(origin) >= 2:
        return float(origin[1]), float(origin[0])  # [lon, lat]
    if isinstance(origin, str) and "," in origin:
        parts = origin.split(",")
        return float(parts[0]), float(parts[1])
    raise IllegalArgumentException(f"invalid geo origin [{origin!r}]")


def _parse_distance_meters(v: Any) -> float:
    """"5km" / "500m" / "1mi" ... -> meters (DistanceUnit)."""
    if isinstance(v, (int, float)):
        return float(v)
    m = re.fullmatch(
        r"\s*(\d+(?:\.\d+)?)\s*(mm|cm|m|km|mi|miles|yd|ft|in|nmi|NM)\s*",
        str(v),
    )
    if not m:
        raise IllegalArgumentException(f"invalid distance [{v}]")
    mult = {"mm": 0.001, "cm": 0.01, "m": 1.0, "km": 1000.0,
            "mi": 1609.344, "miles": 1609.344, "yd": 0.9144,
            "ft": 0.3048, "in": 0.0254, "nmi": 1852.0, "NM": 1852.0}
    return float(m.group(1)) * mult[m.group(2)]


def _haversine_m(lat1: float, lon1: float, lat2, lon2):
    """Great-circle distance in meters (GeoUtils.arcDistance)."""
    r = 6371008.8
    p1, p2 = np.radians(lat1), np.radians(lat2)
    dp = p2 - p1
    dl = np.radians(lon2) - np.radians(lon1)
    a = np.sin(dp / 2.0) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dl / 2.0) ** 2
    return 2.0 * r * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


def _parse_date_or_now(v: Any) -> int:
    """A date literal, or date math anchored at now ("now", "now-7d")."""
    s = str(v).strip() if not hasattr(v, "isoformat") else v.isoformat()
    if s.startswith("now"):
        base = int(time.time() * 1000)
        rest = s[3:]
        if not rest:
            return base
        sign = 1 if rest[0] == "+" else -1
        return base + sign * _duration_millis(rest[1:].split("/")[0])
    return parse_date_millis(v)


def _duration_millis(v: Any) -> int:
    """A date-math duration like "10d", "2h", "30m" in milliseconds."""
    if isinstance(v, (int, float)):
        return int(v)
    m = re.fullmatch(r"(\d+(?:\.\d+)?)(nanos|micros|ms|s|m|h|d|w)",
                     str(v).strip())
    if not m:
        raise IllegalArgumentException(f"invalid duration [{v}]")
    n = float(m.group(1))
    mult = {"nanos": 1e-6, "micros": 1e-3, "ms": 1, "s": 1000, "m": 60_000,
            "h": 3_600_000, "d": 86_400_000, "w": 604_800_000}[m.group(2)]
    return int(n * mult) if m.group(2) not in ("nanos", "micros") \
        else n * mult


# --------------------------------------------------------------------------
# Shard-level query phase
# --------------------------------------------------------------------------


def execute_query_phase(snapshot, mapper_service, query_node, size: int,
                        sort: list | None = None, need_masks: bool = False,
                        min_score: float | None = None) -> ShardQueryResult:
    """The query phase of one shard: every segment's result, the total
    (counted on the host from each segment's mask), and the shard's best
    `size` hits, by (-score, segment, doc) through ``segment_top_k`` or by
    `sort` on the host columns. `min_score` drops docs below it from the
    hits AND the total, as the reference's query phase does. A bare knn's
    host selection is read on the host (the reference's fast path)."""
    from opensearch_tpu_torch.ops.topk import segment_top_k

    ctx = ShardContext(snapshot, mapper_service)
    masks: list[np.ndarray] = []
    score_arrays: list[np.ndarray] = []
    total = 0
    max_score: float | None = None
    all_hits: list[ShardHit] = []
    prof = profile.active()
    for seg_idx, (host, dev) in enumerate(snapshot.segments):
        result = SegmentExecutor(ctx, host, dev).execute(query_node)
        if isinstance(result, HostNodeResult) and not sort:
            t_collect = time.perf_counter_ns()
            mask_h = result.host_mask
            scores_h = result.host_scores
            if min_score is not None:
                mask_h = mask_h & (scores_h >= np.float32(min_score))
            if need_masks:
                masks.append(mask_h[: host.n_docs])
                score_arrays.append(scores_h[: host.n_docs])
            total += int(mask_h.sum())
            if size > 0:
                for d in np.nonzero(mask_h)[0]:
                    v = float(scores_h[d])
                    all_hits.append(ShardHit(v, seg_idx, int(d)))
                    if max_score is None or v > max_score:
                        max_score = v
            if prof is not None:
                # the shard's top-k cut is this engine's collector
                prof.collect_ns += time.perf_counter_ns() - t_collect
            continue
        mask = result.mask & dev.live
        if min_score is not None:
            # min_score excludes docs from hits AND total (QueryPhase's
            # MinScoreCollectorContext runs before counting)
            mask = mask & (result.scores >= _f32(min_score, mask.device))
        mask_host = mask.cpu().numpy()[: host.n_docs]
        if need_masks:
            masks.append(mask_host)
            score_arrays.append(result.scores.cpu().numpy()[: host.n_docs])
        total += int(mask_host.sum())
        t_collect = time.perf_counter_ns()
        if size > 0:
            if not sort:
                k = min(size, dev.n_pad)
                masked = torch.where(mask, result.scores, float("-inf"))
                vals, ids = segment_top_k(masked, k)
                vals_h, ids_h = vals.cpu().numpy(), ids.cpu().numpy()
                for v, d in zip(vals_h, ids_h):
                    if np.isfinite(v):
                        all_hits.append(ShardHit(float(v), seg_idx, int(d)))
                        if max_score is None or v > max_score:
                            max_score = float(v)
            else:
                scores_h = result.scores.cpu().numpy()[: host.n_docs]
                all_hits.extend(_sorted_segment_hits(
                    host, mask_host, scores_h, sort, size, seg_idx,
                    mapper_service))
        if prof is not None:
            # the top-k cut or the field sort is this engine's collector
            prof.collect_ns += time.perf_counter_ns() - t_collect
    t_final = time.perf_counter_ns()
    if not sort:
        all_hits.sort(key=lambda h: (-h.score, h.segment, h.doc))
    else:
        all_hits.sort(key=_sort_key_fn(sort))
    all_hits = all_hits[:size]
    if prof is not None:
        prof.collect_ns += time.perf_counter_ns() - t_final
    return ShardQueryResult(hits=all_hits, total=total, max_score=max_score,
                            masks=masks, score_arrays=score_arrays)


def _field_sort_values(host, field: str, docs: np.ndarray, mapper_service,
                       mode: str | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """(values int64 / float64, present bool) for the requested docs. A
    field absent from the whole segment means every doc's value is missing
    (sorted by the `missing` policy, not an error). `mode` picks the
    multi-value reduction (SortedNumericSortField's min / max / sum / avg /
    median; the caller defaults to min asc, max desc)."""
    nf = host.numeric_fields.get(field)
    if nf is not None:
        mapper = mapper_service.field_mapper(field)
        unsigned = mapper is not None and \
            getattr(mapper, "original_type", None) == "unsigned_long"
        vals = nf.values_i64 if nf.kind == "int" else nf.values_f64
        if unsigned:
            # unbias in exact python-int space (np int64 would overflow)
            def _avg_exact(vv):
                # unsigned_long reduces in BigInteger space: exact half-up
                s_ = sum(vv)
                n_ = len(vv)
                return (2 * s_ + n_) // (2 * n_)

            def _median_exact(vv):
                sv = sorted(vv)
                n_ = len(sv)
                if n_ % 2:
                    return sv[n_ // 2]
                return (sv[n_ // 2 - 1] + sv[n_ // 2] + 1) // 2

            def _sum_wrap(vv):
                return sum(vv) % 2**64  # unsigned sums wrap at 2^64

            red = {"min": min, "max": max, "sum": _sum_wrap,
                   "avg": _avg_exact, "median": _median_exact,
                   }.get(mode or "min", min)
            out = np.empty(len(docs), dtype=object)
            for i, d in enumerate(docs):
                if nf.present[d]:
                    vv = [int(x) + 2**63 for x in nf.doc_values(int(d))]
                    out[i] = red(vv) if vv else 0
                else:
                    out[i] = 0
            return out, nf.present[docs]
        if mode and nf.mv_offsets is not None:
            is_int = nf.kind == "int"

            def _sum(a):
                if not is_int:
                    return np.sum(a)
                return sum(int(x) for x in a)  # exact python-int sum

            def _avg(a):
                if not is_int:
                    return float(np.mean(a))
                # long avg: exact sum -> double -> truncated to long
                return int(float(_sum(a)) / len(a))

            def _median(a):
                sa = np.sort(a)
                n_ = len(sa)
                if n_ % 2:
                    return sa[n_ // 2]
                lo_, hi_ = sa[n_ // 2 - 1], sa[n_ // 2]
                if not is_int:
                    return (float(lo_) + float(hi_)) / 2.0
                return int(float(int(lo_) + int(hi_)) / 2.0)

            red = {"min": np.min, "max": np.max, "sum": _sum,
                   "avg": _avg, "median": _median}.get(mode, np.min)
            out = np.array([
                red(nf.doc_values(int(d))) if nf.present[d] else 0
                for d in docs])
            return out, nf.present[docs]
        return vals[docs], nf.present[docs]
    kf = host.keyword_fields.get(field)
    if kf is not None:
        # segment ordinals do not order across segments: the caller turns
        # them into the string values
        ords = kf.first_ord[docs]
        return ords, ords >= 0
    return np.zeros(len(docs)), np.zeros(len(docs), bool)


def _sorted_segment_hits(host, mask: np.ndarray, scores: np.ndarray,
                         sort: list, size: int, seg_idx: int,
                         mapper_service) -> list[ShardHit]:
    docs = np.nonzero(mask)[0]
    if len(docs) == 0:
        return []
    hits = []
    sort_cols = []
    for spec in sort:
        fname, order, _missing = _sort_spec(spec)
        if fname == "_score":
            sort_cols.append((scores[docs], np.ones(len(docs), bool), order,
                              None))
        elif fname in ("_doc", "_shard_doc"):
            sort_cols.append((docs.astype(np.float64),
                              np.ones(len(docs), bool), order, None))
        else:
            spec_conf = spec if isinstance(spec, dict) else {}
            conf = (spec_conf.get(fname)
                    if isinstance(spec_conf.get(fname), dict) else {})
            mode = conf.get("mode") or ("max" if order == "desc" else "min")
            vals, present = _field_sort_values(host, fname, docs,
                                               mapper_service, mode=mode)
            kf = host.keyword_fields.get(fname)
            sort_cols.append((vals, present, order,
                              kf.ord_values if kf is not None else None))
    for i, d in enumerate(docs):
        sv = []
        for vals, present, _order, ord_values in sort_cols:
            if not present[i]:
                sv.append(None)
            elif ord_values is not None:
                sv.append(ord_values[int(vals[i])])
            else:
                v = vals[i]
                sv.append(int(v) if isinstance(v, (np.integer, int))
                          else float(v))
        hits.append(ShardHit(float(scores[d]), seg_idx, int(d),
                             sort_values=sv))
    hits.sort(key=_sort_key_fn(sort))
    return hits[:size]


def _sort_spec(spec: dict | str) -> tuple[str, str, Any]:
    if isinstance(spec, str):
        return spec, ("desc" if spec == "_score" else "asc"), None
    if len(spec) != 1:
        raise ParsingException("each sort entry must have a single field")
    fname, conf = next(iter(spec.items()))
    if isinstance(conf, str):
        return fname, conf, None
    return (fname, conf.get("order", "desc" if fname == "_score" else "asc"),
            conf.get("missing"))


def _sort_key_fn(sort: list):
    specs = [_sort_spec(s) for s in sort]

    def key(hit: ShardHit):
        parts = []
        for i, (fname, order, missing) in enumerate(specs):
            if fname == "_score":
                v = hit.score
                parts.append(-v if order == "desc" else v)
                continue
            if fname == "_doc":
                parts.append((hit.segment, hit.doc) if order == "asc"
                             else (-hit.segment, -hit.doc))
                continue
            v = hit.sort_values[i] if i < len(hit.sort_values) else None
            if v is None and missing not in (None, "_last", "_first"):
                v = missing  # the user-provided missing value
            if v is None:
                # _last (the default) sorts after every real value in
                # either order; _first before
                parts.append((-1, 0) if missing == "_first" else (1, 0))
            elif isinstance(v, str):
                # desc string order through a reflected comparison
                parts.append((0, _StrKey(v, order == "desc")))
            else:
                parts.append((0, -v if order == "desc" else v))
        parts.append((hit.segment, hit.doc))
        return tuple(parts)

    return key


class _StrKey:
    __slots__ = ("v", "desc")

    def __init__(self, v: str, desc: bool):
        self.v = v
        self.desc = desc

    def __lt__(self, other: "_StrKey") -> bool:
        return (self.v > other.v) if self.desc else (self.v < other.v)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, _StrKey) and self.v == other.v
