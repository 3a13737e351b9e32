"""The tensor-parallel hybrid search program and the exact-kNN serving
step: per-shard scan + on-device cross-shard merge.

Counterpart of opensearch_tpu/parallel/distributed.py. The reference runs
each as one ``shard_map`` program over a device mesh; the port runs the
same arithmetic on one card (parallel/mesh.py):

- :func:`build_distributed_search` is the hybrid BM25 + kNN program over a
  [n_data, n_model] mesh. The data axis is the leading [S] dim of every
  array (S = n_data); the model axis splits d into n_model equal slices,
  each slice's partial product one fp32 ``torch.matmul`` (TF32 off), the
  partials added in rank order from rank 0, as the reference's ``psum``.
  Each shard's BM25 is ops/bm25.py's deterministic sum (``doc_sums``) in
  place of the reference's float scatter-add, which on the card gives other
  bits from run to run. The merge is the reference's all-gather (the
  per-shard pools in shard order, one stable top-k) or its ring (S - 1
  steps, each slot merging its left neighbour's buffer into its running
  top-k); the ring's answer is data slot 0's, which is how the reference's
  replicated output reads.
- :func:`build_knn_serving_step` is exact kNN over S stacked shards: every
  shard's scan in one launch over a [S, n_flat, d] batch, merged on the
  device with no host round-trip in between.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from opensearch_tpu_torch import backend  # noqa: F401  (pins float32)
from opensearch_tpu_torch.ops import bm25
from opensearch_tpu_torch.ops import knn_fused as knn_fused_mod
from opensearch_tpu_torch.ops.topk import blockwise_topk, stable_topk
from opensearch_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

_NEG_INF = float("-inf")


class ShardedSegments(NamedTuple):
    """Per-shard segment arrays stacked along a leading shard axis [S, ...]."""

    vectors: torch.Tensor        # [S, n_pad, d] f32
    norms_sq: torch.Tensor       # [S, n_pad] f32
    valid: torch.Tensor          # [S, n_pad] bool
    postings_docs: torch.Tensor  # [S, p_pad] int32
    postings_tfs: torch.Tensor   # [S, p_pad] f32
    doc_len: torch.Tensor        # [S, n_pad] f32


class QueryArgs(NamedTuple):
    """Per-query arrays (the reference replicates them over the mesh).
    term_idfs and avgdl carry per-shard statistics (shard-local IDF and
    average doc length); k1 and b come from the index's similarity."""

    query_vectors: torch.Tensor  # [B, d] f32
    term_offsets: torch.Tensor   # [S, Q] int32 (per shard: offsets differ)
    term_lengths: torch.Tensor   # [S, Q] int32
    term_idfs: torch.Tensor      # [S, Q] f32
    avgdl: torch.Tensor          # [S] f32
    lexical_weight: Any          # scalar f32 (hybrid mix)
    vector_weight: Any           # scalar f32
    k1: Any = 1.2                # BM25 k1 (scalar)
    b: Any = 0.75                # BM25 b (scalar)


def _merge_topk(vals_a, ids_a, vals_b, ids_b, k: int):
    """The k best of [a, b] along the last dim, ties to a (the lower
    position), as ``lax.top_k`` over the concatenation."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    ids = torch.cat([ids_a, ids_b], dim=-1)
    top_vals, pos = stable_topk(vals, k)
    return top_vals, torch.gather(ids, -1, pos)


def _vector_dots(queries, vectors, n_model: int):
    """(dots [B, n], |q|^2 [B, 1]) of one shard with d split into n_model
    slices: each slice's partial product is one fp32 matmul and the
    partials, like each slice's partial |q|^2, are added in rank order
    from rank 0 (the reference's psum over the model axis)."""
    d = vectors.shape[-1]
    if d % n_model:
        raise ValueError(f"d [{d}] is not a multiple of the model axis "
                         f"[{n_model}]")
    width = d // n_model
    dots = q_sq = None
    for rank in range(n_model):
        q_r = queries[:, rank * width:(rank + 1) * width]
        partial = torch.matmul(q_r, vectors[:, rank * width:
                                            (rank + 1) * width].T)
        part_sq = (q_r * q_r).sum(dim=-1, keepdim=True)
        dots = partial if dots is None else dots + partial
        q_sq = part_sq if q_sq is None else q_sq + part_sq
    return dots, q_sq


def _vector_scores(dots, q_sq, norms, similarity: str):
    """The reference's score transforms of one shard's dots [B, n]."""
    if similarity == "l2_norm":
        # the reference's -(-(q^2 - 2 q.v + |v|^2)), exact without the
        # two negations
        d_sq = torch.clamp(q_sq - 2.0 * dots + norms[None, :], min=0.0)
        return 1.0 / (1.0 + d_sq)
    if similarity == "cosine":
        q_norm = torch.sqrt(q_sq)
        v_norm = torch.sqrt(norms)[None, :]
        return (1.0 + dots / torch.clamp(q_norm * v_norm, min=1e-12)) / 2.0
    return torch.where(dots >= 0, dots + 1.0, 1.0 / (1.0 - dots))


def _shard_lexical(segs: ShardedSegments, q: QueryArgs, s: int, *,
                   window: int) -> torch.Tensor:
    """Shard s's BM25 sum [n_pad] under its own term offsets, lengths,
    IDFs and avgdl (clamped at 1e-6): ops/bm25.py's window gather and
    per-slot scores, summed by ``doc_sums`` in the reference's update
    order."""
    n_pad = segs.doc_len.shape[1]
    device = segs.doc_len.device
    idx, docs, live = bm25.postings_window(
        segs.postings_docs[s], q.term_offsets[s], q.term_lengths[s],
        n_pad=n_pad, window=window)
    avgdl = torch.clamp(torch.as_tensor(q.avgdl, dtype=torch.float32,
                                        device=device)[s], min=1e-6)
    contrib = bm25.bm25_contributions(
        segs.postings_tfs[s], segs.doc_len[s], idx, docs, live,
        q.term_idfs[s], avgdl, q.k1, q.b)
    return bm25.doc_sums(docs, contrib, live, n_pad)[0]


def _shard_query_phase(segs: ShardedSegments, q: QueryArgs, s: int,
                       lex: torch.Tensor, *, k: int, similarity: str,
                       n_model: int):
    """Data slot s's query phase given its BM25 column `lex` [n_pad]: the
    hybrid scores of its shard and their top-k, as (vals [B, k], global
    ids [B, k] = shard id + s * n_pad)."""
    n_pad = segs.vectors.shape[1]
    dots, q_sq = _vector_dots(q.query_vectors, segs.vectors[s], n_model)
    vec = _vector_scores(dots, q_sq, segs.norms_sq[s], similarity)
    del dots
    scores = q.vector_weight * vec + q.lexical_weight * lex[None, :]
    del vec
    scores = torch.where(segs.valid[s][None, :], scores, _NEG_INF)
    top_vals, top_ids = blockwise_topk(scores, k)
    return top_vals, top_ids + s * n_pad


def _allgather_merge(top_vals, global_ids, k: int):
    """Every slot's [B, k] pool side by side in shard order ([S, B, k] in),
    then one stable top-k: ties go to the lower shard, then the lower
    rank, as ``lax.top_k`` over the all-gather."""
    s, b, kk = top_vals.shape
    all_vals = top_vals.permute(1, 0, 2).reshape(b, s * kk)
    all_ids = global_ids.permute(1, 0, 2).reshape(b, s * kk)
    vals, pos = stable_topk(all_vals, k)
    return vals, torch.gather(all_ids, 1, pos)


def _ring_merge(top_vals, global_ids, k: int, n_shards: int):
    """S - 1 ring steps over the [S, B, k] pools: at each, every slot
    receives its left neighbour's send buffer (a roll along the shard
    axis), merges [running, received] by a stable top-k and passes the
    received buffer on. Returns data slot 0's running top-k."""
    vals, ids = top_vals, global_ids
    send_vals, send_ids = top_vals, global_ids
    for _step in range(n_shards - 1):
        recv_vals = torch.roll(send_vals, 1, dims=0)
        recv_ids = torch.roll(send_ids, 1, dims=0)
        vals, ids = _merge_topk(vals, ids, recv_vals, recv_ids, k)
        send_vals, send_ids = recv_vals, recv_ids
    return vals[0], ids[0]


def _on(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def build_distributed_search(mesh: Mesh, *, k: int, window: int,
                             similarity: str = "l2_norm", ring: bool = False):
    """fn(segments: ShardedSegments, q: QueryArgs) -> (scores [B, k],
    global doc ids [B, k]) over the mesh's [n_data, n_model] slots on its
    device. The segments must have n_data shards (see
    :func:`shard_arrays_to_mesh`) and d a multiple of n_model (else
    ValueError). Every shard's BM25 column comes first: the sum's sort
    waits for its run lengths on the host, which costs little while the
    card's queue is short, and the shards' products and passes then queue
    with no wait between them. The shards are scored one after another,
    so one shard's [B, n_pad] score matrix is live at a time."""
    n_shards = mesh.shape[DATA_AXIS]
    n_model = mesh.shape[MODEL_AXIS]

    def step(segs: ShardedSegments, q: QueryArgs):
        if segs.vectors.shape[0] != n_shards:
            raise ValueError(
                f"segments have {segs.vectors.shape[0]} shards, the mesh's "
                f"data axis has {n_shards}")
        if segs.vectors.shape[-1] % n_model:
            raise ValueError(
                f"d [{segs.vectors.shape[-1]}] is not a multiple of the "
                f"model axis [{n_model}]")
        device = segs.vectors.device
        q = QueryArgs(*(_on(x, device) for x in q))
        lexs = [_shard_lexical(segs, q, s, window=window)
                for s in range(n_shards)]
        pools = [_shard_query_phase(segs, q, s, lexs[s], k=k,
                                    similarity=similarity, n_model=n_model)
                 for s in range(n_shards)]
        top_vals = torch.stack([v for v, _i in pools])       # [S, B, k]
        global_ids = torch.stack([i for _v, i in pools])
        if ring:
            return _ring_merge(top_vals, global_ids, k, n_shards)
        return _allgather_merge(top_vals, global_ids, k)

    return step


def shard_arrays_to_mesh(mesh: Mesh,
                         segments: ShardedSegments) -> ShardedSegments:
    """Every array on the mesh's device (numpy arrays are converted); the
    [S] axis is the data axis, d is sliced by the program. Registers
    nothing in the residency ledger, as in the reference."""
    return ShardedSegments(*(
        torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)
        if isinstance(a, np.ndarray) else a.to(mesh.device)
        for a in segments))


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
