"""The tensor-parallel hybrid search program and the exact-kNN serving
step: per-shard scan + cross-shard merge over a mesh of device slots.

Counterpart of opensearch_tpu/parallel/distributed.py. The reference runs
each as one ``shard_map`` program over a device mesh; the port runs the
same arithmetic slot by slot (parallel/mesh.py), each slot's work on its
slot's device, and copies what the reference's collectives carry to the
device that consumes it:

- :func:`build_distributed_search` is the hybrid BM25 + kNN program over a
  [n_data, n_model] mesh. The data axis is the leading [S] dim of every
  array (S = n_data); the model axis splits d into n_model equal slices,
  each slice's partial product one fp32 ``torch.matmul`` (TF32 off) on its
  slot's device, the partials copied to the data row's first slot and
  added there in rank order from rank 0, as the reference's ``psum``.
  Each shard's BM25 is ops/bm25.py's deterministic sum (``doc_sums``) in
  place of the reference's float scatter-add, which on the card gives other
  bits from run to run. The merge is the reference's all-gather (the
  per-shard pools in shard order on slot (0, 0)'s device, one stable
  top-k) or its ring (S - 1 steps, each slot merging its left neighbour's
  buffer, copied to its device, into its running top-k); the ring's answer
  is data slot 0's, which is how the reference's replicated output reads.
- :func:`build_knn_serving_step` is exact kNN over S stacked shards on n
  slots: each slot's S / n shards scanned in one launch on its device,
  then each slot's pools, ids and counts copied to slot 0's device and
  merged there (the reference's all-gather + ``top_k``), with no host
  round-trip in between. The merged rows are the one-slot step's bits.

A mesh whose slots all name one device (a one-device list, or a device
repeated) runs every slot there, and the copies are no-ops.
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
    """Per-shard segment arrays stacked along a leading shard axis [S, ...]
    (the shapes below). :func:`shard_arrays_to_mesh` lays them out on a
    mesh: each field becomes a tuple of the S shards' rows, and vectors
    of each shard's n_model column slices, each on its slot's device."""

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


def _partial_sums(queries, parts, home):
    """(dots [B, n], |q|^2 [B, 1]) on device `home` of one shard whose
    vectors are the model ranks' [n, d / n_model] column slices `parts`,
    each on its slot's device: each slice's partial product is one fp32
    matmul on that device and the partials, like each slice's partial
    |q|^2, are copied to `home` and added there in rank order from rank 0
    (the reference's psum over the model axis)."""
    dots = q_sq = None
    col = 0
    for part in parts:
        width = part.shape[-1]
        q_r = queries[:, col:col + width].to(part.device)
        col += width
        partial = torch.matmul(q_r, part.T).to(home)
        part_sq = (q_r * q_r).sum(dim=-1, keepdim=True).to(home)
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
    n_pad = segs.doc_len[s].shape[-1]
    device = segs.doc_len[s].device
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
                       lex: torch.Tensor, parts: list, *, k: int,
                       similarity: str):
    """Data slot s's query phase on its first slot's device (where its
    norms, validity and BM25 column `lex` [n_pad] live), its vectors the
    model ranks' column slices `parts`: the hybrid scores of its shard and
    their top-k, as (vals [B, k], global ids [B, k] = shard id + s *
    n_pad)."""
    norms = segs.norms_sq[s]
    n_pad = norms.shape[-1]
    dots, q_sq = _partial_sums(q.query_vectors, parts, norms.device)
    vec = _vector_scores(dots, q_sq, norms, similarity)
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


def _ring_merge(pools: list, k: int):
    """S - 1 ring steps over the data slots' pools [(vals [B, k], ids [B,
    k])], each on its slot's device: at each, slot j receives its left
    neighbour's send buffer (copied to slot j's device), merges [running,
    received] by a stable top-k and passes the received buffer on.
    Returns data slot 0's running top-k."""
    n = len(pools)
    running = list(pools)
    send = list(pools)
    for _step in range(n - 1):
        recv = [tuple(t.to(running[j][0].device) for t in send[j - 1])
                for j in range(n)]
        running = [_merge_topk(*running[j], *recv[j], k) for j in range(n)]
        send = recv
    return running[0]


def _on(x, device) -> torch.Tensor:
    """`x` (a tensor, a numpy array or a scalar) as a tensor on `device`."""
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
    return torch.as_tensor(x).to(device)


def build_distributed_search(mesh: Mesh, *, k: int, window: int,
                             similarity: str = "l2_norm", ring: bool = False):
    """fn(segments: ShardedSegments, q: QueryArgs) -> (scores [B, k],
    global doc ids [B, k]) on slot (0, 0)'s device, over the mesh's
    [n_data, n_model] slots. The segments are laid out on the mesh by
    :func:`shard_arrays_to_mesh` (n_data shards, n_model column slices
    each; else ValueError). Every shard's BM25 column comes first: the
    sum's sort waits for its run lengths on the host, which costs little
    while the card's queue is short, and the shards' products and passes
    then queue with no wait between them. The shards are scored one after
    another, so one shard's [B, n_pad] score matrix is live at a time."""
    n_shards = mesh.shape[DATA_AXIS]
    n_model = mesh.shape[MODEL_AXIS]

    def step(segs: ShardedSegments, q: QueryArgs):
        if len(segs.vectors) != n_shards:
            raise ValueError(
                f"segments have {len(segs.vectors)} shards, the mesh's "
                f"data axis has {n_shards}")
        if any(isinstance(row, torch.Tensor) or len(row) != n_model
               for row in segs.vectors):
            raise ValueError(f"segments are not laid out on the mesh's "
                             f"model axis [{n_model}]: see "
                             f"shard_arrays_to_mesh")
        homes = [segs.norms_sq[s].device for s in range(n_shards)]
        # the query's arrays, replicated: one copy on each data row's device
        q_on = {}
        for dev in dict.fromkeys(homes):
            q_on[dev] = QueryArgs(*(_on(x, dev) for x in q))
        lexs = [_shard_lexical(segs, q_on[homes[s]], s, window=window)
                for s in range(n_shards)]
        pools = [_shard_query_phase(segs, q_on[homes[s]], s, lexs[s],
                                    segs.vectors[s], k=k,
                                    similarity=similarity)
                 for s in range(n_shards)]
        if ring:
            return _ring_merge(pools, k)
        top_vals = torch.stack([v.to(homes[0]) for v, _i in pools])
        global_ids = torch.stack([i.to(homes[0]) for _v, i in pools])
        return _allgather_merge(top_vals, global_ids, k)

    return step


def shard_arrays_to_mesh(mesh: Mesh,
                         segments: ShardedSegments) -> ShardedSegments:
    """The stacked [S, ...] segments laid out slot by slot on the mesh
    (numpy arrays are converted), as the reference's
    ``P(DATA_AXIS, None, MODEL_AXIS)``: vectors become, for each shard s,
    the tuple of its n_model column slices [n_pad, d / n_model], each on
    slot (s, m)'s device; every other array the tuple of its shards' rows,
    row s on slot (s, 0)'s device. Where a slot's device is the array's
    own, a row is a view and a column slice a copy only for n_model > 1.
    Registers nothing in the residency ledger, as in the reference."""
    n_data, n_model = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    vectors = segments.vectors
    if vectors.shape[0] != n_data:
        raise ValueError(f"segments have {vectors.shape[0]} shards, the "
                         f"mesh's data axis has {n_data}")
    d = vectors.shape[-1]
    if d % n_model:
        raise ValueError(f"d [{d}] is not a multiple of the model axis "
                         f"[{n_model}]")
    width = d // n_model
    slots = tuple(
        tuple(_on(vectors[s, :, r * width:(r + 1) * width],
                  mesh.slot(s, r)).contiguous()
              for r in range(n_model))
        for s in range(n_data))
    rows = [tuple(_on(a[s], mesh.slot(s)) for s in range(n_data))
            for a in segments[1:]]
    return ShardedSegments(slots, *rows)


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
    """Exact k-NN over S stacked shards on n slots.

    fn(vectors, norms_sq, valid, queries [B, d])
      -> (scores [B, k_final], global_ids [B, k_final], counts [S, B])

    vectors, norms_sq and valid are lists of n slot groups (the serving
    bundle's slabs): slot i's [S / n, n_flat, d], [S / n, n_flat] and
    [S / n, n_flat] tensors on its device, S / n consecutive shards. A
    device may repeat (several slots on one card); one group is one slot.
    The results lie on slot 0's device.

    global id = shard_idx * n_flat + flat_doc, the first shard of slot i
    being i * S / n; counts[s, b] = number of finite per-shard winners (<=
    k_shard). At (kernel="xla", score_precision="fp32") scoring is the
    plain einsum branch; any other combination runs each slot's shards
    through ops/knn_fused.knn_fused_stacked in ONE scan on its device (the
    hand-written kernel for kernel="pallas" on the card, its plain version
    for "xla" or on the CPU), with explicit -1 global ids for empty fused
    slots. Each slot's pools, ids and counts are copied to slot 0's device
    and merged there: the merge orders candidates (shard asc, rank asc) and
    takes a stable top-k, which reproduces the host merge's
    (-score, shard, segment, doc) order exactly, so the result is the
    one-slot step's bits."""
    fused = (kernel, score_precision) != ("xla", "fp32")

    def scan(vectors, norms_sq, valid, queries):
        if fused:
            return knn_fused_mod.knn_fused_stacked(
                vectors, norms_sq, valid, queries, k=k_shard,
                similarity=similarity, score_precision=score_precision,
                impl=kernel,
            )
        return _einsum_scan(vectors, norms_sq, valid, queries,
                            k_shard=k_shard, similarity=similarity)

    def step(vectors, norms_sq, valid, queries):
        if not len(vectors) == len(norms_sq) == len(valid) >= 1:
            raise ValueError(f"slot groups: {len(vectors)} vectors, "
                             f"{len(norms_sq)} norms, {len(valid)} valid")
        home = vectors[0].device
        parts = []
        shard0 = 0
        for v, nrm, ok in zip(vectors, norms_sq, valid):
            dev = v.device
            s_local, n_flat, _d = v.shape
            vals, ids = scan(v, nrm, ok, queries.to(dev))
            counts = torch.isfinite(vals).sum(dim=-1)           # [s, B]
            offsets = ((shard0 + torch.arange(s_local, device=dev))
                       * n_flat)[:, None, None]
            ids = ids.long()
            if fused:
                # fused scans mark empty slots id -1: keep them explicit
                # instead of wrapping them into a neighbouring shard's range
                gids = torch.where(ids >= 0, ids + offsets, -1)
            else:
                gids = ids + offsets
            parts.append(tuple(t.to(home) for t in (vals, gids, counts)))
            shard0 += s_local
        vals, gids, counts = (parts[0] if len(parts) == 1 else
                              [torch.cat(ts) for ts in zip(*parts)])
        b = vals.shape[1]
        all_vals = vals.permute(1, 0, 2).reshape(b, shard0 * k_shard)
        all_ids = gids.permute(1, 0, 2).reshape(b, shard0 * k_shard)
        top_vals, pos = stable_topk(all_vals, k_final)
        return top_vals, torch.gather(all_ids, 1, pos), counts

    return step
