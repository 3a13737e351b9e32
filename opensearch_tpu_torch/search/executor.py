"""Per-shard query execution, for the kNN query.

Counterpart of the kNN part of opensearch_tpu/search/executor.py: the
shard-wide kNN selection (``ShardContext.shard_knn_selection``), the
segment executor as far as a ``knn`` query needs it, and
``execute_query_phase`` for the unsorted path. The service runs this per
shard when the stacked serving step declines the query (an ANN column, or
``distributed_serving.enabled`` off).

Per segment, ``shard_knn_selection`` takes one of four branches, as the
reference does, counted in ``knn_path_stats``:

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
reference buckets them, so the results are the reference's.

Every launch goes through the dispatch batcher (search/batcher.py) with
the reference's batch keys, so concurrent queries over one segment column
and reader generation coalesce into one launch.

Filtered kNN (a ``filter`` inside the ``knn`` clause, the k-NN plugin's
efficient filtering): the filter's device mask is ANDed into ``valid``,
so the same exact scan runs on the narrower set; a filtered query never
takes ANN (the segment runs exactly, through K1 where the policy picks
it) and gets batch key None on every branch, so it never merges with
another query. :class:`SegmentExecutor` computes the filter-context masks
of ``term`` (keyword, numeric, date, boolean, ``_id``, and a text field
through its postings), ``terms``, ``range`` (numeric, date and keyword),
``exists``, ``ids``, ``bool``, ``constant_score``, ``match_all`` and
``match_none``, as the reference's ``execute(node).mask``; any other node
in a kNN filter raises "not yet ported" with its name. Their scores come
with BM25.

Under ``"profile": true`` (search/profile.py) every executed node is an
operator of the shard's profile tree, each batched launch records its
share of the fenced launch wall under the reference's kernel names
(``knn_fused_pallas``, ``knn_topk_streaming``, ``knn_exact_scores``,
``ivfpq_adc_pallas`` / ``ivfpq_search``), and the shard's top-k cut is
its collector time. The roofline and residency-ledger calls of the
reference are left out.
"""

from __future__ import annotations

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
from opensearch_tpu_torch.index.mapper import (
    FLOAT_TYPES,
    INT_TYPES,
    RANGE_TYPES,
    parse_date_millis,
    parse_date_nanos,
)
from opensearch_tpu_torch.index.segment import i64_query_words, pad_window
from opensearch_tpu_torch.ops import filters
from opensearch_tpu_torch.search import batcher, profile
from opensearch_tpu_torch.search import query_dsl as q

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
    the next power of two with zero rows (the caller slices them off)."""
    b = len(rows)
    b_pad = 1 << (b - 1).bit_length()
    out = np.zeros((b_pad, len(rows[0])), np.float32)
    for i, row in enumerate(rows):
        out[i] = row
    return out


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
    """A host-resident selection (the bare-kNN path): the shard cut already
    picked <= k winners on the host, so the query phase reads them here."""

    __slots__ = ("host_scores", "host_mask", "scoring")

    def __init__(self, host_scores: np.ndarray, host_mask: np.ndarray,
                 scoring: bool = True):
        self.host_scores = host_scores    # f32 [n_pad], 0 where unselected
        self.host_mask = host_mask        # bool [n_pad]
        self.scoring = scoring


class ShardContext:
    def __init__(self, snapshot, mapper_service):
        self.snapshot = snapshot
        self.mapper_service = mapper_service
        # knn nodes select k docs PER SHARD (k-NN plugin semantics), so the
        # top-k cut spans all segments of the shard; cached per query node
        self._knn_cache: dict[int, list] = {}

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
                valid = valid & SegmentExecutor(self, host, dev).filter_mask(
                    node.filter)
            qv = np.asarray(node.vector, np.float32)
            sim = knn_ops.canonical_similarity(vf.similarity)
            k_req = max(1, min(int(node.k), host.n_docs))
            # k is bucketed to the next power of two as in the reference
            # (its programs are shape-specialized, and equal buckets share
            # a batch); the shard cut below still takes exactly node.k
            k_bucket = 1 << (k_req - 1).bit_length()
            if vf.ann is not None and not filtered:
                a_vals, a_ids = self._ann_dispatch(vf, valid, qv, node,
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

    def _ann_dispatch(self, vf, valid, qv: np.ndarray, node, k_bucket: int,
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

        def launch_ann(rows):
            q_batch = _pad_query_batch(rows)
            with profile.profiling(None):
                b_vals, b_ids = ivfpq.search_index(
                    vf.ann, vf.vectors, vf.norms_sq, valid, q_batch,
                    k=k_bucket, nprobe=nprobe, similarity=vf.similarity,
                    adc_precision=precision, rescore_multiplier=mult,
                    kernel=kernel)
            return _rows(b_vals, b_ids, len(rows)), profile.signature_retraced(
                "ivfpq_search", (vf.vectors, q_batch),
                (k_bucket, nprobe, precision, mult, kernel))

        # cross-k coalescing: this request may ride a forming batch of the
        # next-larger k buckets (its rows truncate for free); it never
        # creates one
        out = batcher.dispatch(
            ann_key(k_bucket), qv, launch_ann, kind="ann", rank=k_bucket,
            alt_keys=(ann_key(k_bucket * 2), ann_key(k_bucket * 4)),
            tune_key=("ivfpq", id(self.mapper_service), node.field, k_bucket),
        )
        _record_kernel(family, out, qv, {
            "adc_precision": precision,
            "rescore_candidates": ivfpq.rescore_pool(
                vf.ann, k_bucket, nprobe,
                ivfpq.default_rerank(k_bucket, mult)),
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
                with profile.profiling(None):
                    b_vals, b_ids = knn_fused.knn_fused_auto(
                        vf.vectors, vf.norms_sq, valid, q_batch, k=k_bucket,
                        similarity=sim, score_precision=score_precision,
                        impl=exact_kernel)
                return _rows(b_vals, b_ids, len(rows)), \
                    profile.signature_retraced(
                        "knn_fused_pallas", (vf.vectors, q_batch),
                        (k_bucket, sim, score_precision, exact_kernel))

            out = batcher.dispatch(
                fused_key(k_bucket), qv, launch_fused, rank=k_bucket,
                alt_keys=tuple(fused_key(kb)
                               for kb in (k_bucket * 2, k_bucket * 4)
                               if kb <= knn_fused.FUSED_MAX_K
                               and not filtered),
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
                with profile.profiling(None):
                    b_vals, b_ids = scan(vf.vectors, vf.norms_sq, valid,
                                         q_batch)
                return _rows(b_vals, b_ids, len(rows)), \
                    profile.signature_retraced(
                        "knn_topk_streaming", (vf.vectors, q_batch),
                        (k_bucket, sim, chunk))

            out = batcher.dispatch(
                stream_key(k_bucket), qv, launch_streaming, rank=k_bucket,
                alt_keys=tuple(stream_key(kb)
                               for kb in (k_bucket * 2, k_bucket * 4)
                               if kb <= chunk and not filtered),
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
                with profile.profiling(None):
                    b_scores = knn_ops.exact_knn_scores(
                        q_batch, vf.vectors, vf.norms_sq, valid,
                        vf.similarity).cpu().numpy()
                return [b_scores[i] for i in range(len(rows))], \
                    profile.signature_retraced(
                        "knn_exact_scores", (vf.vectors, q_batch), (sim,))

            out = batcher.dispatch(
                None if filtered else ("knn_exact_scores", id(vf), gen, sim),
                qv, launch_exact,
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


class SegmentExecutor:
    """Executes a query node against one segment: the kNN query, and the
    filter-context masks a kNN filter names (:meth:`filter_mask`)."""

    def __init__(self, ctx: ShardContext, host, dev):
        self.ctx = ctx
        self.host = host
        self.dev = dev

    # -- filter context ----------------------------------------------------

    def filter_mask(self, node) -> torch.Tensor:
        """The device bool [n_pad] mask of a filter-context node: the
        reference's ``execute(node).mask``."""
        method = getattr(self, f"_filter_{type(node).__name__}", None)
        if method is None:
            raise not_yet_ported(
                f"query [{type(node).__name__}] inside a kNN filter")
        return method(node)

    def _none(self) -> torch.Tensor:
        return torch.zeros(self.dev.n_pad, dtype=torch.bool,
                           device=self.dev.live.device)

    def _host_mask(self, mask: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(mask).to(self.dev.live.device) & self.dev.live

    def _filter_MatchAllQuery(self, node) -> torch.Tensor:
        return self.dev.live

    def _filter_MatchNoneQuery(self, node) -> torch.Tensor:
        return self._none()

    def _filter_IdsQuery(self, node) -> torch.Tensor:
        mask = np.zeros(self.dev.n_pad, dtype=bool)
        for doc_id in node.values:
            # doc_index (not local_doc): liveness comes from the snapshot's
            # device mask, so a pinned reader stays point-in-time
            d = self.host.doc_index(doc_id)
            if d is not None:
                mask[d] = True
        return self._host_mask(mask)

    def _filter_ConstantScoreQuery(self, node) -> torch.Tensor:
        return self.filter_mask(node.filter)

    def _filter_BoolQuery(self, node) -> torch.Tensor:
        mask = self.dev.live
        for sub in (*node.must, *node.filter):
            mask = mask & self.filter_mask(sub)
        for sub in node.must_not:
            mask = mask & ~self.filter_mask(sub)
        if node.should:
            count = torch.zeros(self.dev.n_pad, dtype=torch.int32,
                                device=mask.device)
            for sub in node.should:
                count = count + self.filter_mask(sub).to(torch.int32)
            msm = node.minimum_should_match
            if msm is None:
                msm = 1 if not (node.must or node.filter) else 0
            if msm > 0:
                mask = mask & (count >= msm)
        return mask

    def _filter_ExistsQuery(self, node) -> torch.Tensor:
        field = node.field
        ms = self.ctx.mapper_service
        if ms.flat_object_parent(field) is not None \
                and ms.mappers.get(field) is None:
            raise not_yet_ported("[exists] on a flat_object sub-path inside "
                                 "a kNN filter")
        dev = self.dev
        if all(field not in cols for cols in (
                dev.numeric_fields, dev.vector_fields, dev.keyword_fields,
                dev.text_fields)):
            # object prefix: exists == any mapped child exists
            children = [name for name in ms.mappers
                        if name.startswith(f"{field}.")]
            if children:
                mask = self._none()
                for child in children:
                    mask = mask | self._filter_ExistsQuery(
                        q.ExistsQuery(field=child))
                return mask
        masks = []
        for cols in (dev.numeric_fields, dev.vector_fields):
            if field in cols:
                masks.append(filters.exists_mask(cols[field].present))
        if field in dev.keyword_fields:
            masks.append(dev.keyword_fields[field].first_ord >= 0)
        if field in dev.text_fields:
            masks.append(dev.text_fields[field].doc_len > 0)
        if not masks:
            return self._none()
        mask = masks[0]
        for m in masks[1:]:
            mask = mask | m
        return mask & dev.live

    def _mapper(self, field: str, what: str):
        """The field's mapper; a flat_object field or sub-path, or a range
        field, raises "not yet ported"."""
        ms = self.ctx.mapper_service
        mapper = ms.field_mapper(field)
        if (mapper is None and ms.flat_object_parent(field) is not None) or (
                mapper is not None and mapper.type in (
                    "flat_object", *RANGE_TYPES)):
            raise not_yet_ported(f"[{what}] on field [{field}] of type "
                                 f"[{mapper.type if mapper else 'flat_object'}]"
                                 f" inside a kNN filter")
        return mapper

    def _keyword_value(self, mapper, value):
        if mapper is not None and mapper.normalizer == "lowercase" \
                and isinstance(value, str):
            return value.lower()
        return value

    def _text_term(self, field: str, term: str) -> torch.Tensor:
        """Docs holding `term` in text field `field` (its postings)."""
        dev_tf = self.dev.text_fields.get(field)
        host_tf = self.host.text_fields.get(field)
        if dev_tf is None or host_tf is None:
            return self._none()
        tid = host_tf.term_dict.get(term)
        if tid is None:
            return self._none()
        off = int(host_tf.term_offsets[tid])
        length = int(host_tf.term_offsets[tid + 1]) - off
        return filters.docs_mask_from_postings(
            dev_tf.postings_docs, off, length, self.dev.n_pad,
            pad_window(length)) & self.dev.live

    def _filter_TermQuery(self, node) -> torch.Tensor:
        field, value = node.field, node.value
        if field == "_id":
            return self._filter_IdsQuery(q.IdsQuery(values=[str(value)]))
        mapper = self._mapper(field, "term")
        ftype = mapper.type if mapper else None
        value = self._keyword_value(mapper, value)
        if ftype == "text":
            return self._text_term(field, str(value))
        if ftype == "keyword" or (ftype is None
                                  and field in self.host.keyword_fields):
            if node.case_insensitive:
                raise not_yet_ported("[term] with case_insensitive inside a "
                                     "kNN filter")
            if mapper is not None and mapper.original_type == "ip" \
                    and "/" in str(value):
                raise not_yet_ported("[term] on an ip subnet inside a kNN "
                                     "filter")
            kf_dev = self.dev.keyword_fields.get(field)
            kf_host = self.host.keyword_fields.get(field)
            if kf_dev is None:
                return self._none()
            qord = kf_host.ord_dict.get(str(value), -3)
            return filters.term_mask_keyword(
                kf_dev.mv_ords, kf_dev.mv_docs, qord,
                self.dev.n_pad) & self.dev.live
        if ftype == "boolean":
            want = 1 if value in (True, "true", 1) else 0
            return self._numeric_range(field, want, None, want, None)
        if ftype == "date":
            ms = (parse_date_nanos(value) if mapper.resolution == "nanos"
                  else parse_date_millis(value))
            return self._numeric_range(field, ms, None, ms, None)
        if ftype in INT_TYPES or ftype in FLOAT_TYPES or ftype is None:
            return self._numeric_range(field, value, None, value, None)
        raise IllegalArgumentException(
            f"term query on unsupported field [{field}]")

    def _filter_TermsQuery(self, node) -> torch.Tensor:
        if node.field == "_id":
            return self._filter_IdsQuery(
                q.IdsQuery(values=[str(v) for v in node.values]))
        mapper = self._mapper(node.field, "terms")
        if mapper is not None and mapper.type == "keyword":
            kf_dev = self.dev.keyword_fields.get(node.field)
            kf_host = self.host.keyword_fields.get(node.field)
            if kf_dev is None:
                return self._none()
            ords = [kf_host.ord_dict.get(
                str(self._keyword_value(mapper, str(v))), -3)
                for v in node.values]
            t_pad = max(pad_window(len(ords)), 8)
            ords_arr = np.full(t_pad, -3, np.int32)
            ords_arr[: len(ords)] = ords
            return filters.terms_mask_keyword(
                kf_dev.mv_ords, kf_dev.mv_docs,
                torch.from_numpy(ords_arr).to(kf_dev.mv_ords.device),
                self.dev.n_pad) & self.dev.live
        # numeric / text: the OR of term queries
        mask = self._none()
        for v in node.values:
            mask = mask | self._filter_TermQuery(
                q.TermQuery(field=node.field, value=v))
        return mask

    def _filter_RangeQuery(self, node) -> torch.Tensor:
        mapper = self._mapper(node.field, "range")
        if mapper is not None and mapper.type == "keyword":
            # lexicographic range over the sorted ordinals
            import bisect

            kf_host = self.host.keyword_fields.get(node.field)
            kf_dev = self.dev.keyword_fields.get(node.field)
            if kf_host is None:
                return self._none()
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
                return self._none()
            hit = (kf_dev.mv_ords >= lo) & (kf_dev.mv_ords <= hi)
            return filters._docs_any(hit, kf_dev.mv_docs, self.dev.n_pad) \
                & self.dev.live
        return self._numeric_range(node.field, node.gte, node.gt, node.lte,
                                   node.lt)

    def _numeric_range(self, field: str, gte: Any, gt: Any, lte: Any,
                       lt: Any) -> torch.Tensor:
        nf_dev = self.dev.numeric_fields.get(field)
        nf_host = self.host.numeric_fields.get(field)
        if nf_dev is None:
            return self._none()
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
            mask = np.zeros(self.dev.n_pad, bool)
            idx = np.nonzero(sel)[0]
            if len(idx):
                doc_of = np.searchsorted(nf_host.mv_offsets, idx,
                                         side="right") - 1
                mask[np.unique(doc_of)] = True
            return self._host_mask(mask)
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
        return mask & self.dev.live

    def execute(self, node) -> HostNodeResult:
        method = getattr(self, f"_exec_{type(node).__name__}", None)
        if method is None:
            raise ParsingException(
                f"unexecutable query node [{type(node).__name__}]")
        prof = profile.active()
        if prof is None:
            return method(node)
        # the same node across segments accumulates into one operator
        with prof.operator(type(node).__name__, profile.describe_node(node)):
            return method(node)

    def _exec_KnnQuery(self, node) -> HostNodeResult:
        # k applies per SHARD: the ShardContext caches the shard-wide
        # selection per query node
        selections = self.ctx.shard_knn_selection(node)
        seg_idx = next(
            i for i, (_h, d) in enumerate(self.ctx.snapshot.segments)
            if d is self.dev
        )
        sel_host, scores_host = selections[seg_idx]
        if scores_host is None:
            return HostNodeResult(np.zeros(self.dev.n_pad, np.float32),
                                  np.zeros(self.dev.n_pad, bool),
                                  scoring=False)
        out_scores = np.where(
            sel_host & np.isfinite(scores_host), scores_host, 0.0
        ).astype(np.float32)
        if node.boost != 1.0:
            out_scores *= np.float32(node.boost)
        return HostNodeResult(out_scores, sel_host, scoring=True)


def execute_query_phase(snapshot, mapper_service, query_node,
                        size: int,
                        min_score: float | None = None) -> ShardQueryResult:
    """The query phase of one shard, for the unsorted kNN path: every
    segment's selection, the total, and the shard's best `size` hits by
    (-score, segment, doc). `min_score` drops docs below it from the hits
    AND the total, as the reference's query phase does."""
    ctx = ShardContext(snapshot, mapper_service)
    total = 0
    max_score: float | None = None
    all_hits: list[ShardHit] = []
    prof = profile.active()
    for seg_idx, (host, dev) in enumerate(snapshot.segments):
        result = SegmentExecutor(ctx, host, dev).execute(query_node)
        t_collect = time.perf_counter_ns()
        mask_h = result.host_mask
        scores_h = result.host_scores
        if min_score is not None:
            mask_h = mask_h & (scores_h >= np.float32(min_score))
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
    t_final = time.perf_counter_ns()
    all_hits.sort(key=lambda h: (-h.score, h.segment, h.doc))
    if prof is not None:
        prof.collect_ns += time.perf_counter_ns() - t_final
    return ShardQueryResult(hits=all_hits[:size], total=total,
                            max_score=max_score)


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
