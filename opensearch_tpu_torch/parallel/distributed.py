"""The exact-kNN serving step: per-shard scan + on-device cross-shard merge.

Counterpart of opensearch_tpu/parallel/distributed.py's
``build_knn_serving_step`` (only that function is ported). The reference
runs one ``shard_map`` program over a device mesh; on one card the S
shards are one stacked [S, n_flat, d] batch, scanned in one launch, and
merged on the device with no host round-trip in between.
"""

from __future__ import annotations

import torch

from opensearch_tpu_torch import backend  # noqa: F401  (pins float32)
from opensearch_tpu_torch.ops import knn_fused as knn_fused_mod
from opensearch_tpu_torch.ops.topk import stable_topk


def _einsum_scan(vectors, norms_sq, valid, queries, *, k_shard: int,
                 similarity: str):
    """The ("xla", "fp32") branch: full [S, B, n] fp32 scores, per-shard
    stable top-k. Slots past a shard's valid count keep -inf scores and
    whatever position the sort left there."""
    dots = torch.einsum("bd,snd->sbn", queries, vectors)
    q_sq = (queries * queries).sum(dim=-1)[None, :, None]
    if similarity == "l2_norm":
        d_sq = torch.clamp(q_sq - 2.0 * dots + norms_sq[:, None, :], min=0.0)
        scores = 1.0 / (1.0 + d_sq)
    elif similarity == "cosine":
        denom = torch.sqrt(q_sq) * torch.sqrt(norms_sq)[:, None, :]
        scores = (1.0 + dots / torch.clamp(denom, min=1e-12)) / 2.0
    else:  # dot_product
        scores = torch.where(dots >= 0, dots + 1.0, 1.0 / (1.0 - dots))
    scores = torch.where(valid[:, None, :], scores, float("-inf"))
    # per-shard top-k (k-NN plugin: k applies per shard)
    return stable_topk(scores, k_shard)


def build_knn_serving_step(*, k_shard: int, k_final: int, similarity: str,
                           kernel: str = "xla", score_precision: str = "fp32"):
    """Exact k-NN over S stacked shards on one device.

    fn(vectors [S, n, d], norms_sq [S, n], valid [S, n], queries [B, d])
      -> (scores [B, k_final], global_ids [B, k_final], counts [S, B])

    global id = shard_idx * n + flat_doc; counts[s, b] = number of finite
    per-shard winners (<= k_shard). At (kernel="xla", score_precision=
    "fp32") scoring is the plain einsum branch; any other combination runs
    every shard's scan through ops/knn_fused.knn_fused_stacked in ONE scan
    (the hand-written kernel for kernel="pallas" on the card, its plain
    version for "xla" or on the CPU), with explicit -1 global ids for empty
    fused slots. The merge orders candidates (shard asc, rank asc) and takes
    a stable top-k, which reproduces the host merge's
    (-score, shard, segment, doc) order exactly."""
    fused = (kernel, score_precision) != ("xla", "fp32")

    def step(vectors, norms_sq, valid, queries):
        s, n_flat, _d = vectors.shape
        if fused:
            vals, ids = knn_fused_mod.knn_fused_stacked(
                vectors, norms_sq, valid, queries, k=k_shard,
                similarity=similarity, score_precision=score_precision,
                impl=kernel,
            )
        else:
            vals, ids = _einsum_scan(vectors, norms_sq, valid, queries,
                                     k_shard=k_shard, similarity=similarity)
        counts = torch.isfinite(vals).sum(dim=-1)               # [S, B]
        offsets = (torch.arange(s, device=vectors.device) * n_flat)[:, None, None]
        ids = ids.long()
        if fused:
            # fused scans mark empty slots id -1: keep them explicit
            # instead of wrapping them into a neighbouring shard's range
            gids = torch.where(ids >= 0, ids + offsets, -1)
        else:
            gids = ids + offsets
        b = vals.shape[1]
        all_vals = vals.permute(1, 0, 2).reshape(b, s * k_shard)
        all_ids = gids.permute(1, 0, 2).reshape(b, s * k_shard)
        top_vals, pos = stable_topk(all_vals, k_final)
        return top_vals, torch.gather(all_ids, 1, pos), counts

    return step
