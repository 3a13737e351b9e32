"""Exact-kNN serving over a node's stacked shards: the on-device merge in
_search.

Counterpart of opensearch_tpu/search/distributed_serving.py. A kNN query
over S shards runs ONE serving step (parallel/distributed.
build_knn_serving_step) over n slots, n the largest divisor of S no
greater than the node's serving devices (``backend.serving_devices``, the
counterpart of ``jax.devices()``): each slot's S / n shards scanned in one
launch on its slot's device over a stacked [S / n, n_flat, d] slab, then
the merge on slot 0's device, replacing the host-side k-way merge of the
reference's SearchPhaseController.mergeTopDocs. A one-card node has one
slot: one launch a search.

Layout: at first use after a refresh, each shard's segment vector columns
are flattened into one [n_flat, d] slab (segment-ascending, doc-ascending —
the host merge's tie-break order), stacked by slot to [S / n, n_flat, d]
and copied to the slot's device. The slabs are cached per (index, field,
per-shard segment generations) in the shard-mesh registry; a refresh
makes a new key.

The step declines (``mesh_knn_batch`` returns None, and the service runs
the per-shard route of search/executor.py) where the reference declines:
an unfiltered query on an ANN-indexed column (the per-shard route answers
it with IVF-PQ), and shard sets the stacked path cannot serve (no shard
maps the field, or mixed similarities or dims); each decline counts in
``stats["fallbacks"]``.

Filtered kNN: the filter's mask is built on the device by the per-shard
route's own SegmentExecutor (:func:`_filter_valid_mask`), each slot's part
on its slot's device, laid out like the bundle's slabs, and ANDed into
``valid``, so K1 scans the narrower set; a filtered query serves
ANN-indexed columns exactly, as the per-shard route does under a filter;
``stats["filtered"]`` counts such launches. A batch's queries share their
filter by identity. A filtered alias gives each shard its own filter
(``alias_filters``, one parsed node or None a shard): the mask ANDs each
shard's alias filter with the kNN filter, so a kNN through a filtered
alias is one mesh launch, counted in ``stats["filtered"]`` like a body
filter.

Telemetry, as in the reference: each slot's slab is one
device-residency-ledger allocation labelled with its device (all freed by
the shard-mesh registry on eviction), the query batch and a filter mask
are transient uploads, and each launch feeds the registry's launch wall,
the roofline (family ``mesh_knn`` for the plain einsum branch,
``mesh_knn_fused[<precision>]`` for K1, bounded by the peaks of the
distinct cards the slots name), a heat touch of the bundle and, on a
program-cache miss, the ledger's compile table.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np
import torch

from opensearch_tpu_torch import backend
from opensearch_tpu_torch.cluster.shard_mesh import default_registry as registry
from opensearch_tpu_torch.index.device import vector_norms_sq
from opensearch_tpu_torch.parallel.distributed import build_knn_serving_step
from opensearch_tpu_torch.parallel.mesh import Mesh, build_mesh
from opensearch_tpu_torch.search.executor import (
    ShardHit,
    ShardQueryResult,
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
    """One [S / n, n_flat, d] device slab a slot (n slots, each on its
    slot's device; S / n consecutive shards each) + host-side flat->segment
    maps."""

    def __init__(self, vectors: list, norms_sq: list, valid: list,
                 n_flat: int, seg_offsets: list[list[tuple[int, int, int]]],
                 allocations: list | None = None):
        # per slot: torch [S / n, n_flat, d], [S / n, n_flat], bool
        self.slot_vectors = list(vectors)
        self.slot_norms_sq = list(norms_sq)
        self.slot_valid = list(valid)
        self.n_flat = n_flat
        # per shard: [(flat_start, seg_idx, n_docs)] in segment order
        self.seg_offsets = seg_offsets
        # device-residency ledger handles, one a slot; the
        # ShardMeshRegistry frees them on eviction/invalidation (and on a
        # lost duplicate-build race)
        self.allocations = list(allocations or [])

    @property
    def devices(self) -> list[torch.device]:
        return [v.device for v in self.slot_vectors]

    def slot_nbytes(self, i: int) -> int:
        return sum(a.numel() * a.element_size() for a in (
            self.slot_vectors[i], self.slot_norms_sq[i], self.slot_valid[i]))

    @property
    def nbytes(self) -> int:
        return sum(self.slot_nbytes(i) for i in range(len(self.slot_vectors)))

    def locate(self, shard_idx: int, flat: int) -> tuple[int, int]:
        for start, seg_idx, n_docs in self.seg_offsets[shard_idx]:
            if start <= flat < start + n_docs:
                return seg_idx, flat - start
        raise IndexError(f"flat doc {flat} out of range for shard {shard_idx}")


def _largest_divisor_at_most(s: int, cap: int) -> int:
    """The number of slots S shards spread over: the largest divisor of S
    no greater than the number of serving devices, as in the reference."""
    for d in range(min(s, cap), 0, -1):
        if s % d == 0:
            return d
    return 1


_MESH_CACHE: dict[tuple, Mesh] = {}


def _serving_mesh(n_devices: int, serving: list) -> Mesh:
    """The [n_devices, 1] mesh over the first n_devices serving devices,
    cached by its slots."""
    slots = tuple(serving[:n_devices])
    with _CACHE_LOCK:
        mesh = _MESH_CACHE.get(slots)
        if mesh is None:
            mesh = _MESH_CACHE[slots] = build_mesh(n_devices, 1,
                                                   devices=list(slots))
    return mesh


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


def _build_bundle(snaps: list, field: str, dims: int, devices: list,
                  index_name: str = "_unattributed",
                  generations: tuple = ()) -> _IndexBundle:
    """The bundle of `snaps` over the slots `devices` names: one slab a
    slot of S / n consecutive shards, uploaded to its slot's device and
    registered in the residency ledger as one allocation labelled with
    that device."""
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

    s_local = len(snaps) // len(devices)

    def stack(arrays: list[np.ndarray], slot: int, fill=0) -> torch.Tensor:
        group = arrays[slot * s_local:(slot + 1) * s_local]
        out = np.full((s_local, n_flat, *group[0].shape[1:]), fill,
                      dtype=group[0].dtype)
        for i, a in enumerate(group):
            out[i, : a.shape[0]] = a
        return torch.from_numpy(out).to(devices[slot])

    bundle = _IndexBundle(
        vectors=[stack(per_shard_vecs, i) for i in range(len(devices))],
        norms_sq=[stack(per_shard_norms, i) for i in range(len(devices))],
        valid=[stack(per_shard_valid, i, fill=False)
               for i in range(len(devices))],
        n_flat=n_flat,
        seg_offsets=seg_offsets,
    )
    # device residency: each slot's slab stays on its device until the
    # registry evicts the bundle (superseded generation, byte budget,
    # invalidation), which frees every slot's allocation
    from opensearch_tpu_torch.telemetry.device_ledger import (
        KIND_MESH_BUNDLE,
        default_ledger,
    )

    bundle.allocations = [
        default_ledger.register(
            KIND_MESH_BUNDLE, bundle.slot_nbytes(i), index=index_name,
            field=field, generation=tuple(generations),
            device=str(torch.device(dev)))
        for i, dev in enumerate(devices)]
    return bundle


def _filter_valid_mask(shards: list, snaps: list, knn_filter,
                       alias_filters: list | None, n_flat: int,
                       devices: list) -> list[torch.Tensor]:
    """One [S / n, n_flat] bool part a slot of `devices` (the bundle's
    slot devices), built on its slot's device: the docs the kNN filter and
    each shard's alias filter admit, laid out like the bundle's slabs
    (segment-ascending, doc-ascending, padding False). Each segment's mask
    comes from the SegmentExecutor the per-shard route runs for the same
    filter, so both routes filter alike."""
    from opensearch_tpu_torch.search.executor import (
        SegmentExecutor,
        ShardContext,
    )

    s_local = len(snaps) // len(devices)
    parts = [torch.zeros((s_local, n_flat), dtype=torch.bool, device=d)
             for d in devices]
    for si, (shard, snap) in enumerate(zip(shards, snaps)):
        device = devices[si // s_local]
        fnodes = [f for f in (knn_filter,
                              alias_filters[si] if alias_filters else None)
                  if f is not None]
        ctx = ShardContext(snap, shard.mapper_service)
        pos = 0
        for host, dev in snap.segments:
            n = host.n_docs
            mask = torch.ones(n, dtype=torch.bool, device=device)
            for fnode in fnodes:
                mask &= SegmentExecutor(ctx, host, dev).execute(
                    fnode).mask[:n].to(device)
            parts[si // s_local][si % s_local, pos:pos + n] = mask
            pos += n
    return parts


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
    device launch, each shard narrowed by its alias filter
    (`alias_filters`). Returns the per-query per-shard results, the
    device-merged row order and the launch attribution; None when the step
    declines the shard set (see :func:`_can_serve`)."""
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
    filtered = first.filter is not None or (
        alias_filters is not None
        and any(f is not None for f in alias_filters))
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

    # the slots: S shards over the largest divisor of S no greater than
    # the node's serving devices (one slot on a one-card node)
    serving = backend.serving_devices(shards[0].engine.device)
    n_devices = _largest_divisor_at_most(s, len(serving))
    slots = list(_serving_mesh(n_devices, serving).devices[:, 0])
    index_name = shards[0].shard_id.index
    # generation-pinned residency key: a refresh mid-flight is a different
    # key, so no query is ever merged against another snapshot's slab; the
    # slots close the key, so a bundle laid out over other slots is
    # another key, which supersedes it
    cache_key = (registry.residency_key(index_name, first.field, shards,
                                        snaps)
                 + (tuple(str(d) for d in slots),))
    bundle = registry.get(cache_key)
    if bundle is None:
        # built outside the registry lock; a same-key race wastes one
        # upload at worst, and registry.put frees the loser's allocation
        bundle = registry.put(
            cache_key, _build_bundle(snaps, first.field, dims, slots,
                                     index_name=index_name,
                                     generations=cache_key[4]))

    from opensearch_tpu_torch.telemetry.device_ledger import (
        KIND_QUERY_BATCH,
        default_ledger,
        group_key,
    )

    valid = bundle.slot_valid
    if filtered:
        fmasks = _filter_valid_mask(shards, snaps, first.filter,
                                    alias_filters, bundle.n_flat,
                                    bundle.devices)
        # per-request mask, consumed by this launch: transient in the
        # residency ledger (allocated and freed in one step)
        default_ledger.record_transient(
            KIND_QUERY_BATCH,
            sum(m.numel() * m.element_size() for m in fmasks))
        valid = [ok & m for ok, m in zip(valid, fmasks)]

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
    fused = (exact_kernel, score_precision) != ("xla", "fp32")
    prog_key = (s, bundle.n_flat, dims, k_shard, k_final, similarity,
                exact_kernel, score_precision, tuple(bundle.devices))
    with _CACHE_LOCK:
        program = _PROGRAM_CACHE.get(prog_key)
        retraced = program is None
        if program is None:
            program = build_knn_serving_step(
                k_shard=k_shard, k_final=k_final, similarity=similarity,
                kernel=exact_kernel, score_precision=score_precision,
            )
            _PROGRAM_CACHE[prog_key] = program

    queries = torch.from_numpy(q_host).to(bundle.devices[0])
    t0 = time.perf_counter_ns()
    vals, gids, counts = program(
        bundle.slot_vectors, bundle.slot_norms_sq, valid, queries)
    # copying the results to the host is the fence for this launch
    vals = vals.cpu().numpy()            # [b, k_final]
    gids = gids.cpu().numpy()
    counts = counts.cpu().numpy()        # [s, b]
    wall_ns = time.perf_counter_ns() - t0
    launch_id = registry.next_launch_id()
    registry.record_launch_wall(wall_ns)
    registry.record_launch_kernel(exact_kernel, score_precision)
    # roofline accounting: ONE mesh launch against the mesh cost model
    # (every shard's scan + the merge over the slots), bounded by the
    # peaks of the distinct cards it ran on
    from opensearch_tpu_torch.telemetry import roofline

    cards = len(set(bundle.devices))
    launch_params = dict(b=b, s=s, n_flat=bundle.n_flat, d=dims,
                         k_shard=k_shard, devices=n_devices)
    if fused:
        from opensearch_tpu_torch.ops.knn_fused import fused_pool_width

        launch_params.update(
            precision=score_precision,
            r=fused_pool_width(k_shard, score_precision),
            kernel=exact_kernel,
        )
        mesh_family = "mesh_knn_fused"
        roofline.default_recorder.record(
            f"mesh_knn_fused[{score_precision}]", wall_ns,
            params=launch_params, cards=cards)
    else:
        mesh_family = "mesh_knn"
        roofline.default_recorder.record("mesh_knn", wall_ns,
                                         params=launch_params, cards=cards)
    default_ledger.record_transient(KIND_QUERY_BATCH, q_host.nbytes)
    # heat touch against the bundle this launch scanned, bytes from the
    # same cost model the roofline fold used: one touch a structure (the
    # slots' allocations on one device are one structure)
    default_ledger.touch(
        list({group_key(a): a for a in bundle.allocations}.values()),
        family=mesh_family, params=launch_params)
    if retraced:
        # program-cache miss: a fresh entry for the mesh kernel family; the
        # first launch wall includes any kernel build
        default_ledger.record_compile(mesh_family, wall_ns)
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


def clear_caches() -> None:
    """Drop every stacked bundle (freeing its device memory) and every
    cached program key."""
    registry.clear()
    with _CACHE_LOCK:
        _PROGRAM_CACHE.clear()
        _MESH_CACHE.clear()
