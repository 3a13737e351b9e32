"""Exact kNN that streams the corpus through a running top-k.

Counterpart of the kNN half of opensearch_tpu/ops/fused.py
(``_vector_scores``, ``knn_topk_streaming``, ``cached_knn_streaming``). The
reference computes these in XLA, outside any Pallas kernel, so here they
are plain PyTorch: the [B, d] x [m, d] product is ``torch.matmul`` in full
float32 (backend.py pins TF32 off) and the selection is ops/topk.py. The
materializing ``knn_topk`` is left out: no serving route calls it (the
executor's materializing branch is ops/knn.exact_knn_scores and a host
cut). ``hybrid_score_topk`` is not ported yet.
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
