"""Fused single-segment query programs: the hybrid BM25 + exact-kNN
program, and exact kNN that streams the corpus through a running top-k.

Counterpart of opensearch_tpu/ops/fused.py (``hybrid_score_topk``,
``jit_hybrid``, ``_vector_scores``, ``knn_topk_streaming``,
``cached_knn_streaming``). The reference computes these in XLA, outside
any Pallas kernel, so here they are plain PyTorch: the [B, d] x [m, d]
product is ``torch.matmul`` in full float32 (backend.py pins TF32 off) and
the selection is ops/topk.py. The hybrid program's BM25 sum is
deterministic on the card (:func:`lexical_scores`: a stable sort of the
postings window's (doc, contribution) pairs by doc, then each doc's run
summed in order by ``torch.segment_reduce``, whose CUDA kernel adds a
segment's values one after another with no atomics), so the same inputs
give the same bits run after run, which a float ``index_add_`` on the card
does not. The materializing ``knn_topk`` is left out: no serving route
calls it (the executor's materializing branch is ops/knn.exact_knn_scores
and a host cut).
"""

from __future__ import annotations

import functools

import torch

from opensearch_tpu_torch import backend  # noqa: F401  (pins float32)
from opensearch_tpu_torch.ops import topk as topk_ops

_NEG_INF = float("-inf")


def _vector_scores(queries, vectors, norms_sq, similarity: str):
    """Exact similarity scores [B, m] for one corpus block, in the
    reference's score-space forms (cosine divides by the clamped product of
    the norms, unlike the Pallas kernels' per-norm clamp)."""
    dots = queries @ vectors.to(queries.dtype).T
    if similarity == "l2_norm":
        q_sq = (queries * queries).sum(dim=-1, keepdim=True)
        d_sq = torch.clamp(q_sq - 2.0 * dots + norms_sq[None, :], min=0.0)
        return 1.0 / (1.0 + d_sq)
    if similarity == "cosine":
        q_norm = torch.sqrt((queries * queries).sum(dim=-1, keepdim=True))
        return (1.0 + dots / torch.clamp(
            q_norm * torch.sqrt(norms_sq)[None, :], min=1e-12)) / 2.0
    return torch.where(dots >= 0, dots + 1.0, 1.0 / (1.0 - dots))


def knn_topk_streaming(vectors, norms_sq, valid, queries, *, k: int,
                       similarity: str = "l2_norm", chunk: int = 32_768):
    """Exact kNN that never holds the [B, n] score matrix: the corpus is
    scanned in [chunk]-doc blocks, each reduced to its top-k at once and
    folded into a running [B, k] state. The merge puts the carried entries
    (lower doc ids) before the new block and takes a stable top-k, so ties
    go to the lower doc id across chunks as within one. n must be a
    multiple of `chunk`. Slots past the valid count carry (-inf, 0) or a
    masked doc's id, as in the reference: callers keep finite slots."""
    n_pad = vectors.shape[0]
    B = queries.shape[0]
    if n_pad % chunk:
        raise ValueError(f"n [{n_pad}] must be a multiple of chunk [{chunk}]")
    best_v = torch.full((B, k), _NEG_INF, dtype=torch.float32,
                        device=queries.device)
    best_i = torch.zeros((B, k), dtype=torch.int64, device=queries.device)
    for base in range(0, n_pad, chunk):
        s = _vector_scores(queries, vectors[base:base + chunk],
                           norms_sq[base:base + chunk], similarity)
        s = torch.where(valid[None, base:base + chunk], s, _NEG_INF)
        cv, ci = topk_ops.blockwise_topk(s, min(k, chunk))
        allv = torch.cat([best_v, cv], dim=1)
        alli = torch.cat([best_i, ci + base], dim=1)
        best_v, sel = topk_ops.stable_topk(allv, k)
        best_i = torch.gather(alli, 1, sel)
    return best_v, best_i


@functools.lru_cache(maxsize=64)
def cached_knn_streaming(k: int, similarity: str, chunk: int):
    """The streaming program bound to (k, similarity, chunk), as the
    serving path asks for it per segment. PyTorch runs eagerly, so this is
    a cached partial, not a compiled program."""
    return functools.partial(knn_topk_streaming, k=k, similarity=similarity,
                             chunk=chunk)


def lexical_scores(postings_docs, postings_tfs, doc_len, offsets, lengths,
                   idfs, avgdl, *, n_pad: int, window: int, k1: float = 1.2,
                   b: float = 0.75) -> torch.Tensor:
    """The BM25 sum [n_pad] of Q query terms, each a window of up to
    `window` postings from ``offsets[q]`` (``lengths[q]`` of them live),
    as the reference's masked gather and scatter-add compute it: a window
    index past the postings is clamped to the last one (XLA's gather), a
    doc id past the slots reads the last slot's length (the same) and adds
    nothing (XLA's scatter drops it), a dead window slot adds 0 to doc 0.
    Each
    doc's contributions are added in the reference's update order (term by
    term, window slot by slot) from 0, the same order on the CPU and the
    card: the pairs are sorted by doc, stable, and each doc's run summed by
    ``torch.segment_reduce``."""
    device = postings_docs.device
    p_pad = postings_docs.shape[0]
    win = torch.arange(window, dtype=torch.int64, device=device)
    tvalid = win[None, :] < lengths.long()[:, None]             # [Q, W]
    idx = torch.where(tvalid, offsets.long()[:, None] + win[None, :], 0)
    idx = torch.clamp(idx, max=p_pad - 1)
    docs = postings_docs[idx].long()
    tfs = postings_tfs[idx]
    dl = doc_len[torch.clamp(docs, 0, n_pad - 1)]
    tvalid = tvalid & (docs < n_pad)
    avgdl = torch.clamp(torch.as_tensor(avgdl, dtype=torch.float32,
                                        device=device), min=1e-6)
    denom = tfs + k1 * (1.0 - b + b * dl / avgdl)
    contrib = idfs[:, None] * tfs / torch.clamp(denom, min=1e-9)
    contrib = torch.where(tvalid, contrib, 0.0).reshape(-1)
    docs = torch.where(tvalid, docs, 0).reshape(-1)
    order = torch.sort(docs, stable=True).indices
    run_docs, counts = torch.unique_consecutive(docs[order],
                                                return_counts=True)
    sums = torch.segment_reduce(contrib[order], "sum", lengths=counts)
    lex = torch.zeros(n_pad, dtype=torch.float32, device=device)
    lex[run_docs] = sums
    return lex


def hybrid_score_topk(postings_docs, postings_tfs, doc_len, vectors,
                      norms_sq, valid, offsets, lengths, idfs, avgdl,
                      queries, lexical_weight, vector_weight, *, k: int,
                      window: int, similarity: str = "l2_norm",
                      k1: float = 1.2, b: float = 0.75):
    """The hybrid BM25 + exact-kNN program over one segment's arrays:
    (scores [B, k] f32, doc ids [B, k] int64), the reference's contract.

    postings_docs int32 [p_pad], postings_tfs f32 [p_pad], doc_len f32
    [n_pad], vectors f32 or bf16 [n_pad, d] (cast to the queries' dtype, as
    the reference does), norms_sq f32 [n_pad], valid bool [n_pad], offsets,
    lengths int32 [Q] and idfs f32 [Q] (one term set for the batch), avgdl
    and the weights f32 scalars, queries f32 [B, d]. Every query's score of
    a doc is ``vector_weight * vec + lexical_weight * lex``: vec the l2,
    cosine or inner-product transform of one fp32 product (no TF32), lex
    :func:`lexical_scores`; dead docs are -inf; ops/topk.blockwise_topk
    gives the k best, ties to the lower id."""
    n_pad = doc_len.shape[0]
    lex = lexical_scores(postings_docs, postings_tfs, doc_len, offsets,
                         lengths, idfs, avgdl, n_pad=n_pad, window=window,
                         k1=k1, b=b)
    vec = _vector_scores(queries, vectors, norms_sq, similarity)
    scores = vector_weight * vec + lexical_weight * lex[None, :]
    scores = torch.where(valid[None, :], scores, _NEG_INF)
    return topk_ops.blockwise_topk(scores, k)


@functools.lru_cache(maxsize=64)
def jit_hybrid(k: int, window: int, similarity: str = "l2_norm"):
    """The hybrid program bound to (k, window, similarity), cached as the
    reference caches its jitted program. PyTorch runs eagerly, so this is
    a cached partial, not a compiled program."""
    return functools.partial(hybrid_score_topk, k=k, window=window,
                             similarity=similarity)
