"""The port's flagship forward step, as ``__graft_entry__.entry()`` gives
the reference's.

``entry(device=None)`` returns ``(fn, example_args)``: ``fn`` is the
hybrid BM25 + exact-kNN score and top-k over one segment's arrays
(ops/fused.hybrid_score_topk, bound to k = 10, window = 128, l2), and
``example_args`` the reference's example inputs (the same numpy generator,
seed and shapes: 2,048 docs of 64 dims, 4,096 postings, 8 query terms, 4
queries) as tensors on the card, or on the CPU where ``device="cpu"`` is
passed. With no device it is the card, and it raises where there is none.

``dryrun_multichip(n_devices, device=None)`` is the reference's dry run
of its two mesh programs over the node's serving devices
(``backend.serving_devices``: every card, or the list
``backend.set_serving_devices`` set, such as ``[cuda:0] * 8``, the slot
form on one card): (1) the serving path, a ``min(4, n_devices)``-shard kNN
``_search`` through TorchNode that must take the stacked serving step, its
shards over the largest divisor of the shard count no greater than the
serving devices (on the card: one launch of K1 a slot), and (2) the
tensor-parallel hybrid program (parallel/distributed.
build_distributed_search) over a [n_data, n_model] mesh of those devices,
n_model 2 where n_devices is even and at least 4. It prints the
reference's two "OK" lines.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from opensearch_tpu_torch import backend
from opensearch_tpu_torch.ops.fused import hybrid_score_topk


def entry(device: torch.device | str | None = None):
    dev = backend.resolve_device(device)
    rng = np.random.default_rng(0)
    n_pad, d, p_pad, Q, B, k, window = 2048, 64, 4096, 8, 4, 10, 128

    postings_docs = rng.integers(0, n_pad, p_pad).astype(np.int32)
    postings_tfs = rng.integers(1, 5, p_pad).astype(np.float32)
    doc_len = rng.integers(5, 80, n_pad).astype(np.float32)
    vectors = rng.standard_normal((n_pad, d)).astype(np.float32)
    norms_sq = (vectors**2).sum(-1).astype(np.float32)
    valid = np.ones(n_pad, bool)
    offsets = (rng.integers(0, p_pad - window, Q)).astype(np.int32)
    lengths = rng.integers(0, window, Q).astype(np.int32)
    idfs = rng.uniform(0.5, 3.0, Q).astype(np.float32)
    queries = rng.standard_normal((B, d)).astype(np.float32)

    fn = functools.partial(hybrid_score_topk, k=k, window=window,
                           similarity="l2_norm")
    example_args = tuple(
        torch.from_numpy(a).to(dev) for a in (
            postings_docs, postings_tfs, doc_len, vectors, norms_sq, valid,
            offsets, lengths, idfs)) + (
        torch.tensor(40.0, device=dev),
        torch.from_numpy(queries).to(dev),
        torch.tensor(1.0, device=dev),
        torch.tensor(1.0, device=dev),
    )
    return fn, example_args


def dryrun_multichip(n_devices: int,
                     device: torch.device | str | None = None) -> None:
    """The reference's dry run of the serving path and the tensor-parallel
    program (see the module docstring), on the card unless `device` names
    the CPU. Raises AssertionError where a check fails."""
    import tempfile
    from pathlib import Path

    from opensearch_tpu_torch.interop import (
        query_args_from_numpy,
        sharded_segments_from_numpy,
    )
    from opensearch_tpu_torch.node import TorchNode
    from opensearch_tpu_torch.ops import knn_fused
    from opensearch_tpu_torch.parallel.distributed import (
        build_distributed_search,
        shard_arrays_to_mesh,
    )
    from opensearch_tpu_torch.parallel.mesh import build_mesh
    from opensearch_tpu_torch.search import distributed_serving

    dev = backend.resolve_device(device)

    # ---- 1) the serving path: a multi-shard knn _search through
    # TorchNode -> search/service -> the stacked serving step with the
    # on-device merge ----
    n_shards = min(4, n_devices)
    with tempfile.TemporaryDirectory() as tmp:
        node = TorchNode(Path(tmp) / "data", device=dev)
        try:
            node.create_index("vecs", {
                "settings": {"number_of_shards": n_shards},
                "mappings": {"properties": {
                    "v": {"type": "knn_vector", "dimension": 16,
                          "space_type": "l2"},
                }},
            })
            rng = np.random.default_rng(0)
            node.bulk([
                ("index", {"_index": "vecs", "_id": f"d{i}"},
                 {"v": rng.standard_normal(16).round(3).tolist()})
                for i in range(64)
            ], refresh=True)
            serving = backend.serving_devices(dev)
            slots = distributed_serving._largest_divisor_at_most(
                n_shards, len(serving))
            before = distributed_serving.stats["distributed_searches"]
            k1_before = knn_fused.launches.count
            resp = node.search("vecs", {
                "query": {"knn": {"v": {
                    "vector": rng.standard_normal(16).round(3).tolist(),
                    "k": 5,
                }}},
                "size": 5,
            })
            k1_launches = knn_fused.launches.count - k1_before
        finally:
            node.close()
    assert distributed_serving.stats["distributed_searches"] == before + 1, \
        "serving search did not take the stacked serving step"
    assert len(resp["hits"]["hits"]) == 5
    if dev.type == "cuda":
        assert k1_launches == slots, \
            (f"the serving search launched K1 {k1_launches} times, not "
             f"once on each of its {slots} slots")
    used = ", ".join(str(d) for d in dict.fromkeys(serving[:slots]))
    print(f"serving path OK: {n_shards}-shard knn _search merged "
          f"on-device over {slots} device{'s' if slots > 1 else ''} "
          f"({used})")

    # ---- 2) the TP/hybrid program: model-axis partial sums + data-axis
    # merge ----
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    n_data = n_devices // n_model
    mesh = build_mesh(n_data=n_data, n_model=n_model,
                      devices=backend.serving_devices(dev))

    rng = np.random.default_rng(0)
    n_pad, d, p_pad, Q, B, k, window = 128, 16, 256, 4, 2, 5, 16
    vectors = rng.standard_normal((n_data, n_pad, d)).astype(np.float32)
    segs = sharded_segments_from_numpy(
        vectors, (vectors**2).sum(-1).astype(np.float32),
        np.ones((n_data, n_pad), bool),
        rng.integers(0, n_pad, (n_data, p_pad)).astype(np.int32),
        rng.integers(1, 4, (n_data, p_pad)).astype(np.float32),
        rng.integers(5, 50, (n_data, n_pad)).astype(np.float32), device=dev)
    qargs = query_args_from_numpy(
        rng.standard_normal((B, d)).astype(np.float32),
        np.zeros((n_data, Q), np.int32),
        np.tile([8, 4, 0, 0], (n_data, 1)).astype(np.int32),
        np.full((n_data, Q), 1.5, np.float32),
        np.full(n_data, 25.0, np.float32), 0.5, 1.0, device=dev)
    segs = shard_arrays_to_mesh(mesh, segs)
    fn = build_distributed_search(mesh, k=k, window=window,
                                  similarity="l2_norm")
    vals, ids = fn(segs, qargs)
    assert vals.device == mesh.device
    assert tuple(vals.shape) == (B, k) and tuple(ids.shape) == (B, k)
    assert bool(torch.isfinite(vals).all())
    print(
        f"dryrun_multichip OK: mesh data={n_data} x model={n_model}, "
        f"top-{k} scores for {B} queries over {n_data * n_pad} docs"
    )
