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
and reader generation coalesce into one launch. Not yet ported, and raised
as such: filtered kNN. The profiler, roofline and residency-ledger calls of
the reference are left out.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field as dc_field
from typing import Any

import numpy as np
import torch

from opensearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    ParsingException,
)
from opensearch_tpu_torch.search import batcher

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

        if node.filter is not None:
            raise not_yet_ported("filtered kNN")
        per_seg_scores: list[np.ndarray | None] = []
        candidates: list[tuple[float, int, int]] = []
        for seg_idx, (host, dev) in enumerate(self.snapshot.segments):
            vf = dev.vector_fields.get(node.field)
            if vf is None:
                per_seg_scores.append(None)
                continue
            valid = vf.present & dev.live
            qv = np.asarray(node.vector, np.float32)
            sim = knn_ops.canonical_similarity(vf.similarity)
            k_req = max(1, min(int(node.k), host.n_docs))
            # k is bucketed to the next power of two as in the reference
            # (its programs are shape-specialized, and equal buckets share
            # a batch); the shard cut below still takes exactly node.k
            k_bucket = 1 << (k_req - 1).bit_length()
            if vf.ann is not None:
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
                                          k_bucket, sim)
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

        def ann_key(kb: int):
            return ("ivfpq", id(vf), vf.ann.build_generation, gen, kb, nprobe,
                    sim, precision, mult, kernel)

        def launch_ann(rows):
            b_vals, b_ids = ivfpq.search_index(
                vf.ann, vf.vectors, vf.norms_sq, valid, _pad_query_batch(rows),
                k=k_bucket, nprobe=nprobe, similarity=vf.similarity,
                adc_precision=precision, rescore_multiplier=mult,
                kernel=kernel)
            return _rows(b_vals, b_ids, len(rows))

        # cross-k coalescing: this request may ride a forming batch of the
        # next-larger k buckets (its rows truncate for free); it never
        # creates one
        return batcher.dispatch(
            ann_key(k_bucket), qv, launch_ann, kind="ann", rank=k_bucket,
            alt_keys=(ann_key(k_bucket * 2), ann_key(k_bucket * 4)),
            tune_key=("ivfpq", id(self.mapper_service), node.field, k_bucket),
        ).value

    def _exact_dispatch(self, host, dev, vf, valid, qv: np.ndarray,
                        field: str, k_bucket: int, sim: str) -> np.ndarray:
        """The exact scan of one segment for this query through the
        batcher: the fused kernel, the streaming or the materializing scan,
        as the reference picks them. Returns the segment's scores f32
        [n_pad], -inf outside the launch's candidates."""
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
                return ("knn_fused", id(vf), gen, kb, sim, score_precision,
                        exact_kernel)

            def launch_fused(rows):
                q_batch = torch.from_numpy(_pad_query_batch(rows)).to(
                    vf.vectors.device)
                b_vals, b_ids = knn_fused.knn_fused_auto(
                    vf.vectors, vf.norms_sq, valid, q_batch, k=k_bucket,
                    similarity=sim, score_precision=score_precision,
                    impl=exact_kernel)
                return _rows(b_vals, b_ids, len(rows))

            vals, ids = batcher.dispatch(
                fused_key(k_bucket), qv, launch_fused, rank=k_bucket,
                alt_keys=tuple(fused_key(kb)
                               for kb in (k_bucket * 2, k_bucket * 4)
                               if kb <= knn_fused.FUSED_MAX_K),
                tune_key=("knn_fused", *tune, k_bucket)).value
            hit = ids >= 0
            scores[ids[hit]] = vals[hit]
            _count_knn_path("fused")
        elif (host.n_docs >= STREAMING_MIN_DOCS and n_pad % chunk == 0
                and k_bucket <= chunk):
            scan = fused.cached_knn_streaming(k_bucket, sim, chunk)

            def stream_key(kb: int):
                return ("knn_topk_streaming", id(vf), gen, kb, sim, chunk)

            def launch_streaming(rows):
                q_batch = torch.from_numpy(_pad_query_batch(rows)).to(
                    vf.vectors.device)
                b_vals, b_ids = scan(vf.vectors, vf.norms_sq, valid, q_batch)
                return _rows(b_vals, b_ids, len(rows))

            vals, ids = batcher.dispatch(
                stream_key(k_bucket), qv, launch_streaming, rank=k_bucket,
                alt_keys=tuple(stream_key(kb)
                               for kb in (k_bucket * 2, k_bucket * 4)
                               if kb <= chunk),
                tune_key=("knn_topk_streaming", *tune, k_bucket)).value
            finite = np.isfinite(vals)
            scores[ids[finite]] = vals[finite]
            _count_knn_path("streaming")
        else:

            def launch_exact(rows):
                q_batch = torch.from_numpy(_pad_query_batch(rows)).to(
                    vf.vectors.device)
                b_scores = knn_ops.exact_knn_scores(
                    q_batch, vf.vectors, vf.norms_sq, valid,
                    vf.similarity).cpu().numpy()
                return [b_scores[i] for i in range(len(rows))]

            scores = batcher.dispatch(
                ("knn_exact_scores", id(vf), gen, sim), qv, launch_exact,
                tune_key=("knn_exact_scores", *tune)).value
            _count_knn_path("materializing")
        return scores


def _rows(b_vals: torch.Tensor, b_ids: torch.Tensor, n: int) -> list:
    """The first n rows of a batch launch as (vals, ids) numpy pairs;
    copying them to the host is the fence for the launch."""
    vals, ids = b_vals[:n].cpu().numpy(), b_ids[:n].cpu().numpy()
    return [(vals[i], ids[i]) for i in range(n)]


class SegmentExecutor:
    """Executes a query node against one segment; only the kNN query is
    ported."""

    def __init__(self, ctx: ShardContext, host, dev):
        self.ctx = ctx
        self.host = host
        self.dev = dev

    def execute(self, node) -> HostNodeResult:
        method = getattr(self, f"_exec_{type(node).__name__}", None)
        if method is None:
            raise ParsingException(
                f"unexecutable query node [{type(node).__name__}]")
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
                        size: int) -> ShardQueryResult:
    """The query phase of one shard, for the unsorted kNN path: every
    segment's selection, the total, and the shard's best `size` hits by
    (-score, segment, doc)."""
    ctx = ShardContext(snapshot, mapper_service)
    total = 0
    max_score: float | None = None
    all_hits: list[ShardHit] = []
    for seg_idx, (host, dev) in enumerate(snapshot.segments):
        result = SegmentExecutor(ctx, host, dev).execute(query_node)
        mask_h = result.host_mask
        scores_h = result.host_scores
        total += int(mask_h.sum())
        if size > 0:
            for d in np.nonzero(mask_h)[0]:
                v = float(scores_h[d])
                all_hits.append(ShardHit(v, seg_idx, int(d)))
                if max_score is None or v > max_score:
                    max_score = v
    all_hits.sort(key=lambda h: (-h.score, h.segment, h.doc))
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
