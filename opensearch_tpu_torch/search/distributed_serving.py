"""Exact-kNN serving over a node's stacked shards: the on-device merge in
_search.

Counterpart of opensearch_tpu/search/distributed_serving.py. A kNN query
over S shards runs ONE serving step (parallel/distributed.
build_knn_serving_step): every shard's scan in one launch over a stacked
[S, n_flat, d] slab, then the on-device merge, replacing the host-side
k-way merge of the reference's SearchPhaseController.mergeTopDocs.

Layout: at first use after a refresh, each shard's segment vector columns
are flattened into one [n_flat, d] slab (segment-ascending, doc-ascending —
the host merge's tie-break order), stacked to [S, n_flat, d] and copied to
the shards' device. The slabs are cached per (index, field, per-shard
segment generations) in the shard-mesh registry; a refresh makes a new key.

The step declines (``mesh_knn_batch`` returns None, and the service runs
the per-shard route of search/executor.py) where the reference declines:
an unfiltered query on an ANN-indexed column (the per-shard route answers
it with IVF-PQ), and shard sets the stacked path cannot serve (no shard
maps the field, or mixed similarities or dims); each decline counts in
``stats["fallbacks"]``.

Filtered kNN: the filter's mask is built on the device by the per-shard
route's own SegmentExecutor (:func:`_filter_valid_mask`), laid out like
the bundle's slabs, and ANDed into ``valid``, so K1 scans the narrower
set; a filtered query serves ANN-indexed columns exactly, as the
per-shard route does under a filter; ``stats["filtered"]`` counts such
launches. A batch's queries share their filter by identity. Aliases are
not ported (``TorchNode`` has none), so a filtered alias raises.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np
import torch

from opensearch_tpu_torch.cluster.shard_mesh import default_registry as registry
from opensearch_tpu_torch.index.device import vector_norms_sq
from opensearch_tpu_torch.parallel.distributed import build_knn_serving_step
from opensearch_tpu_torch.search.executor import (
    ShardHit,
    ShardQueryResult,
    not_yet_ported,
)

# observability: tests and chip_smoke.py assert the serving path ran.
# Increment via _count(): a bare `dict[k] += 1` drops counts under
# concurrent read-modify-write.
stats = {
    "distributed_searches": 0,
    "fallbacks": 0,
    "filtered": 0,          # dispatches that carried a filter mask
    "single_shard": 0,      # dispatches with s == 1
    "batched_queries": 0,   # total query vectors sent in B>1 dispatches
}
_STATS_LOCK = threading.Lock()


def _count(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        stats[key] += n


# kill switch (tests compare the stacked step with the per-shard route)
enabled = True

_PROGRAM_CACHE: dict[tuple, Any] = {}
_CACHE_LOCK = threading.Lock()


class MeshLaunchOutcome:
    """What ONE stacked launch produced, for every query it served.

    `per_query[q]` is the per-shard ShardQueryResult list; `premerged[q]`
    is the same winning hits as a flat [(shard_idx, ShardHit)] list in the
    DEVICE merge order, which equals the host merge's
    (-score, shard, segment, doc) ordering exactly."""

    __slots__ = ("per_query", "premerged", "launch_id", "wall_ns",
                 "retraced", "shards")

    def __init__(self, per_query, premerged, launch_id, wall_ns, retraced,
                 shards):
        self.per_query = per_query
        self.premerged = premerged
        self.launch_id = launch_id
        self.wall_ns = wall_ns
        self.retraced = retraced
        self.shards = shards


class _IndexBundle:
    """[S, n_flat, d] device slabs + host-side flat->segment maps."""

    def __init__(self, vectors, norms_sq, valid, n_flat: int,
                 seg_offsets: list[list[tuple[int, int, int]]]):
        self.vectors = vectors          # torch [S, n_flat, d] on the device
        self.norms_sq = norms_sq        # torch [S, n_flat]
        self.valid = valid              # torch [S, n_flat] bool
        self.n_flat = n_flat
        # per shard: [(flat_start, seg_idx, n_docs)] in segment order
        self.seg_offsets = seg_offsets

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.vectors, self.norms_sq, self.valid))

    def locate(self, shard_idx: int, flat: int) -> tuple[int, int]:
        for start, seg_idx, n_docs in self.seg_offsets[shard_idx]:
            if start <= flat < start + n_docs:
                return seg_idx, flat - start
        raise IndexError(f"flat doc {flat} out of range for shard {shard_idx}")


def _can_serve(snaps: list, field: str, *,
               filtered: bool = False) -> tuple[str, int] | None:
    """(similarity, dims) when every shard can be served exactly by the
    stacked step, else None. ANN-indexed segments decline an unfiltered
    query: the per-shard route answers it with IVF-PQ, and this step must
    give what that route gives. Under a filter that route scans exactly
    (executor.shard_knn_selection takes ANN only unfiltered), so ANN
    columns are served here too."""
    from opensearch_tpu_torch.ops.knn import canonical_similarity

    similarity = None
    dims = None
    for snap in snaps:
        for _host, dev in snap.segments:
            vf = dev.vector_fields.get(field)
            if vf is None:
                continue
            if vf.ann is not None and not filtered:
                return None
            sim = canonical_similarity(vf.similarity)
            if similarity is None:
                similarity, dims = sim, vf.dims
            elif sim != similarity or vf.dims != dims:
                return None
    if similarity is None:
        return None
    return similarity, dims


def _build_bundle(snaps: list, field: str, dims: int,
                  device: torch.device) -> _IndexBundle:
    per_shard_vecs: list[np.ndarray] = []
    per_shard_norms: list[np.ndarray] = []
    per_shard_valid: list[np.ndarray] = []
    seg_offsets: list[list[tuple[int, int, int]]] = []
    for snap in snaps:
        chunks_v, chunks_n, chunks_ok = [], [], []
        offsets: list[tuple[int, int, int]] = []
        pos = 0
        for seg_idx, (host, dev) in enumerate(snap.segments):
            n = host.n_docs
            hvf = host.vector_fields.get(field)
            if hvf is None:
                chunks_v.append(np.zeros((n, dims), np.float32))
                chunks_n.append(np.zeros(n, np.float32))
                chunks_ok.append(np.zeros(n, bool))
            else:
                v = np.asarray(hvf.vectors[:n], np.float32)
                chunks_v.append(v)
                # the segment upload's norm formula: scores match the
                # reference bit for bit
                chunks_n.append(vector_norms_sq(v))
                # dev.live, not host.live: deletes flip host.live in place
                # before refresh, but queries see the PUBLISHED bitmap
                chunks_ok.append(
                    np.asarray(hvf.present[:n], bool)
                    & dev.live[:n].cpu().numpy()
                )
            offsets.append((pos, seg_idx, n))
            pos += n
        seg_offsets.append(offsets)
        per_shard_vecs.append(
            np.concatenate(chunks_v) if chunks_v else np.zeros((0, dims), np.float32)
        )
        per_shard_norms.append(
            np.concatenate(chunks_n) if chunks_n else np.zeros(0, np.float32)
        )
        per_shard_valid.append(
            np.concatenate(chunks_ok) if chunks_ok else np.zeros(0, bool)
        )

    max_docs = max((v.shape[0] for v in per_shard_vecs), default=1)
    # bucket to the next power of two, as the reference does: a refresh
    # that grows a shard slightly keeps the slab shape
    n_flat = 1 << max(int(max_docs - 1).bit_length(), 3)

    def stack(arrays: list[np.ndarray], fill=0) -> torch.Tensor:
        out = np.full((len(arrays), n_flat, *arrays[0].shape[1:]), fill,
                      dtype=arrays[0].dtype)
        for i, a in enumerate(arrays):
            out[i, : a.shape[0]] = a
        return torch.from_numpy(out).to(device)

    return _IndexBundle(
        vectors=stack(per_shard_vecs),
        norms_sq=stack(per_shard_norms),
        valid=stack(per_shard_valid, fill=False),
        n_flat=n_flat,
        seg_offsets=seg_offsets,
    )


def _filter_valid_mask(shards: list, snaps: list, knn_filter, n_flat: int,
                       device: torch.device) -> torch.Tensor:
    """[S, n_flat] bool on the device: the docs the kNN filter admits, laid
    out like the bundle's slabs (segment-ascending, doc-ascending, padding
    False). Each segment's mask comes from the SegmentExecutor the
    per-shard route runs for the same filter, so both routes filter
    alike."""
    from opensearch_tpu_torch.search.executor import (
        SegmentExecutor,
        ShardContext,
    )

    out = torch.zeros((len(snaps), n_flat), dtype=torch.bool, device=device)
    for si, (shard, snap) in enumerate(zip(shards, snaps)):
        ctx = ShardContext(snap, shard.mapper_service)
        pos = 0
        for host, dev in snap.segments:
            n = host.n_docs
            mask = SegmentExecutor(ctx, host, dev).filter_mask(knn_filter)
            out[si, pos:pos + n] = mask[:n].to(device)
            pos += n
    return out


def try_distributed_knn_batch(shards: list, snaps: list, nodes: list,
                              fetch_k: int, alias_filters: list | None = None
                              ) -> list[list[ShardQueryResult]] | None:
    """:func:`mesh_knn_batch`'s per-query per-shard results alone (the
    msearch batching path), or None where the step declines."""
    out = mesh_knn_batch(shards, snaps, nodes, fetch_k,
                         alias_filters=alias_filters)
    return None if out is None else out.per_query


def mesh_knn_batch(
    shards: list,
    snaps: list,
    nodes: list,
    fetch_k: int,
    alias_filters: list | None = None,
) -> MeshLaunchOutcome | None:
    """Execute B KnnQuery nodes (same field, k and filter object) in ONE
    device launch. Returns the per-query per-shard results, the
    device-merged row order and the launch attribution; None when the step
    declines the shard set (see :func:`_can_serve`). Raises for what is
    not yet ported."""
    if not shards or len(shards) != len(snaps) or not nodes:
        raise ValueError("mesh_knn_batch needs shards, their snapshots and "
                         "at least one query")
    s = len(shards)
    first = nodes[0]
    for node in nodes:
        # the filter by identity, as the reference compares it: equal
        # filters that are distinct objects do not share a launch
        if (node.field != first.field or int(node.k) != int(first.k)
                or node.filter is not first.filter):
            raise ValueError("a batch must share its field, k and filter")
    if alias_filters is not None and any(f is not None for f in alias_filters):
        raise not_yet_ported("kNN through a filtered alias")
    filtered = first.filter is not None
    served = _can_serve(snaps, first.field, filtered=filtered)
    if served is None:
        _count("fallbacks")
        return None
    similarity, dims = served
    for node in nodes:
        if len(node.vector) != dims:
            raise ValueError(
                f"query vector has {len(node.vector)} dims, field "
                f"[{first.field}] has {dims}")

    device = shards[0].engine.device
    index_name = shards[0].shard_id.index
    # generation-pinned residency key: a refresh mid-flight is a different
    # key, so no query is ever merged against another snapshot's slab
    cache_key = registry.residency_key(index_name, first.field, shards, snaps)
    bundle = registry.get(cache_key)
    if bundle is None:
        bundle = registry.put(
            cache_key, _build_bundle(snaps, first.field, dims, device))

    valid = bundle.valid
    if filtered:
        valid = valid & _filter_valid_mask(shards, snaps, first.filter,
                                           bundle.n_flat, device)

    b = len(nodes)
    q_host = np.zeros((b, dims), np.float32)
    for i, node in enumerate(nodes):
        q_host[i] = np.asarray(node.vector, np.float32)

    k_shard = max(1, min(int(first.k), bundle.n_flat))
    k_final = min(max(k_shard, int(fetch_k)), s * k_shard)
    # exact-path kernel policy (search.knn.kernel / score_precision): the
    # RESOLVED kernel + precision are part of the program key
    from opensearch_tpu_torch.search.ann import (
        default_config as ann_config,
        resolve_kernel,
    )

    exact_kernel = resolve_kernel(ann_config.exact_kernel)
    score_precision = ann_config.score_precision
    prog_key = (s, bundle.n_flat, dims, k_shard, k_final, similarity,
                exact_kernel, score_precision)
    with _CACHE_LOCK:
        program = _PROGRAM_CACHE.get(prog_key)
        retraced = program is None
        if program is None:
            program = build_knn_serving_step(
                k_shard=k_shard, k_final=k_final, similarity=similarity,
                kernel=exact_kernel, score_precision=score_precision,
            )
            _PROGRAM_CACHE[prog_key] = program

    queries = torch.from_numpy(q_host).to(device)
    t0 = time.perf_counter_ns()
    vals, gids, counts = program(
        bundle.vectors, bundle.norms_sq, valid, queries)
    # copying the results to the host is the fence for this launch
    vals = vals.cpu().numpy()            # [b, k_final]
    gids = gids.cpu().numpy()
    counts = counts.cpu().numpy()        # [s, b]
    wall_ns = time.perf_counter_ns() - t0
    launch_id = registry.next_launch_id()
    registry.record_launch_kernel(exact_kernel, score_precision)
    _count("distributed_searches")
    if filtered:
        _count("filtered")
    if s == 1:
        _count("single_shard")
    if b > 1:
        _count("batched_queries", b)

    out: list[list[ShardQueryResult]] = []
    premerged: list[list[tuple[int, ShardHit]]] = []
    for qi, node in enumerate(nodes):
        boost = np.float32(getattr(node, "boost", 1.0))
        per_shard_hits: list[list[ShardHit]] = [[] for _ in range(s)]
        # device row order IS the final merged order: (-score, shard asc,
        # segment asc, doc asc)
        rows: list[tuple[int, ShardHit]] = []
        for v, g in zip(vals[qi], gids[qi]):
            if not np.isfinite(v):
                continue
            shard_idx, flat = int(g) // bundle.n_flat, int(g) % bundle.n_flat
            seg_idx, doc = bundle.locate(shard_idx, flat)
            hit = ShardHit(float(np.float32(v) * boost), seg_idx, doc)
            per_shard_hits[shard_idx].append(hit)
            rows.append((shard_idx, hit))
        results = []
        for shard_idx in range(s):
            hits = per_shard_hits[shard_idx]
            results.append(ShardQueryResult(
                hits=hits,
                total=int(counts[shard_idx, qi]),
                max_score=max((h.score for h in hits), default=None),
            ))
        out.append(results)
        premerged.append(rows)
    return MeshLaunchOutcome(out, premerged, launch_id, wall_ns, retraced, s)
