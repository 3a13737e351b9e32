"""Exact k-NN scoring: matmul + similarity transform, in plain torch.

Counterpart of opensearch_tpu/ops/knn.py. Score spaces match the k-NN
plugin's conventions so `_score` values are drop-in comparable:
  l2        -> 1 / (1 + d^2)
  cosine    -> (1 + cos) / 2     ("cosinesimil")
  dot/inner -> d >= 0 ? d + 1 : 1 / (1 - d)  ("innerproduct")

float32 products run in full float32 (backend.pin_float32): TF32 would
flip near-tie neighbours on the exact path. Both entry points are
profiled (search/profile.profiled_kernel) under the reference's names.
"""

from __future__ import annotations

import torch

from opensearch_tpu_torch import backend  # noqa: F401  (pins float32)
from opensearch_tpu_torch.search.profile import profiled_kernel

L2 = "l2_norm"
COSINE = "cosine"
DOT = "dot_product"

_ALIASES = {
    "l2": L2, "l2_norm": L2,
    "cosine": COSINE, "cosinesimil": COSINE,
    "dot_product": DOT, "innerproduct": DOT, "dot": DOT, "max_inner_product": DOT,
}


def canonical_similarity(name: str) -> str:
    sim = _ALIASES.get(name)
    if sim is None:
        raise ValueError(f"unknown vector similarity [{name}]")
    return sim


@profiled_kernel("knn_raw_similarity")
def raw_similarity(
    queries: torch.Tensor,     # [B, d] float32
    vectors: torch.Tensor,     # [n_pad, d] float32
    norms_sq: torch.Tensor,    # [n_pad] float32 precomputed ||v||^2
    similarity: str,
) -> torch.Tensor:
    """[B, n_pad] raw similarity, higher = closer, before score-space map."""
    sim = canonical_similarity(similarity)
    dots = queries @ vectors.T
    if sim == L2:
        q_sq = (queries * queries).sum(dim=-1, keepdim=True)          # [B,1]
        # negative squared distance: monotonic for ranking
        return -(q_sq - 2.0 * dots + norms_sq[None, :])
    if sim == COSINE:
        q_norm = torch.sqrt((queries * queries).sum(dim=-1, keepdim=True))
        v_norm = torch.sqrt(norms_sq)[None, :]
        return dots / torch.clamp(q_norm * v_norm, min=1e-12)
    return dots  # DOT


def knn_score(raw: torch.Tensor, similarity: str) -> torch.Tensor:
    """Map raw similarity to the OpenSearch k-NN plugin score space."""
    sim = canonical_similarity(similarity)
    if sim == L2:
        d_sq = torch.clamp(-raw, min=0.0)
        return 1.0 / (1.0 + d_sq)
    if sim == COSINE:
        return (1.0 + raw) / 2.0
    return torch.where(raw >= 0, raw + 1.0, 1.0 / (1.0 - raw))


@profiled_kernel("knn_exact_scores")
def exact_knn_scores(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    norms_sq: torch.Tensor,
    valid: torch.Tensor,       # bool [n_pad]: present & live & not padding
    similarity: str,
) -> torch.Tensor:
    """[B, n_pad] k-NN scores with invalid docs pushed to -inf."""
    raw = raw_similarity(queries, vectors, norms_sq, similarity)
    scores = knn_score(raw, similarity)
    return torch.where(valid[None, :], scores, float("-inf"))
