"""Per-shard query execution, for the kNN query.

Counterpart of the kNN part of opensearch_tpu/search/executor.py: the
shard-wide kNN selection (``ShardContext.shard_knn_selection``), the
segment executor as far as a ``knn`` query needs it, and
``execute_query_phase`` for the unsorted path. The service runs this per
shard when the stacked serving step declines the query (an ANN column, or
``distributed_serving.enabled`` off).

Per segment, ``shard_knn_selection`` takes one of two branches:

- ANN (the column has an IVF-PQ structure and the query no filter):
  ``ops/ivfpq.search_index`` under the resolved ``search.knn.ann.kernel``
  ("pallas": host probe selection + the fused pipeline whose scan is K2;
  "xla": the monolithic lowering), at the live ADC precision and rescore
  multiplier;
- exact, for segments below ``min_train`` or without ANN: the fused exact
  kNN (``ops/knn_fused.knn_fused_auto``, K1) under ``search.knn.kernel``.

Then the shard cut: the k best of all segments of the shard, by
(-score, segment, doc). k and nprobe are bucketed to powers of two as the
reference buckets them, so the results are the reference's.

Dispatch is solo: each launch serves one query, as the reference does with
``search.knn.batch.enabled=false`` (the dispatch batcher is not ported
yet). Not yet ported, and raised as such: filtered kNN, the exact branch
past ``FUSED_MAX_K``, and the streaming / materializing exact scans. The
profiler, roofline and residency-ledger calls of the reference are left
out.
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

# which branch served _exec_KnnQuery selections
knn_path_stats = {"ann": 0, "fused": 0}
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
            qv = np.asarray([node.vector], np.float32)
            sim = knn_ops.canonical_similarity(vf.similarity)
            k_req = max(1, min(int(node.k), host.n_docs))
            # k is bucketed to the next power of two as in the reference
            # (its programs are shape-specialized); the shard cut below
            # still takes exactly node.k
            k_bucket = 1 << (k_req - 1).bit_length()
            if vf.ann is not None:
                a_vals, a_ids = self._ann_launch(vf, valid, qv, node,
                                                 k_bucket)
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
            vals, ids = self._fused_launch(vf, valid, qv, sim, k_bucket)
            scores = np.full(dev.n_pad, -np.inf, np.float32)
            hit = ids >= 0
            scores[ids[hit]] = vals[hit]
            _count_knn_path("fused")
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

    @staticmethod
    def _ann_launch(vf, valid, qv: np.ndarray, node, k_bucket: int):
        """One solo IVF-PQ launch: (vals [k_bucket], ids [k_bucket]) numpy,
        under the live ANN policy, precision and rescore multiplier."""
        from opensearch_tpu_torch.ops import ivfpq
        from opensearch_tpu_torch.search import ann as ann_mod

        cfg = ann_mod.default_config
        kernel = ann_mod.resolve_kernel(cfg.kernel)
        nprobe_req = int((node.method_parameters or {}).get(
            "nprobe", vf.nprobe_default))
        nprobe = ann_mod.bucket_nprobe(nprobe_req, vf.ann.params.nlist)
        q_batch = _pad_query_batch([qv[0]])
        b_vals, b_ids = ivfpq.search_index(
            vf.ann, vf.vectors, vf.norms_sq, valid, q_batch,
            k=k_bucket, nprobe=nprobe, similarity=vf.similarity,
            adc_precision=cfg.adc_precision,
            rescore_multiplier=cfg.rescore_multiplier, kernel=kernel)
        # copying the results to the host is the fence for this launch
        return b_vals[0].cpu().numpy(), b_ids[0].cpu().numpy()

    @staticmethod
    def _fused_launch(vf, valid, qv: np.ndarray, sim: str, k_bucket: int):
        """One solo exact launch through the fused kernel's policy front
        door (K1): (vals [k_bucket], ids [k_bucket]) numpy."""
        from opensearch_tpu_torch.ops import knn_fused
        from opensearch_tpu_torch.search.ann import (
            default_config as ann_config,
            resolve_kernel,
        )

        exact_kernel = resolve_kernel(ann_config.exact_kernel)
        if k_bucket > knn_fused.FUSED_MAX_K:
            raise not_yet_ported(
                f"exact kNN on the per-shard route at k > "
                f"{knn_fused.FUSED_MAX_K} (the streaming and materializing "
                f"scans)")
        q_batch = torch.from_numpy(_pad_query_batch([qv[0]])).to(
            vf.vectors.device)
        b_vals, b_ids = knn_fused.knn_fused_auto(
            vf.vectors, vf.norms_sq, valid, q_batch, k=k_bucket,
            similarity=sim, score_precision=ann_config.score_precision,
            impl=exact_kernel)
        return b_vals[0].cpu().numpy(), b_ids[0].cpu().numpy()


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
