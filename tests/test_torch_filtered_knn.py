"""Filtered kNN (a ``filter`` inside the ``knn`` clause) on TorchNode(device=
"cpu") against TpuNode, on the same bulk and the same bodies.

The index is modelled on the k-NN plugin perf-tool's filtering specs: each
doc has a vector and three attributes, ``age`` (integer 0-99), ``color``
(keyword, 6 values) and ``taste`` (keyword, 4 values), made from a seed;
one and four shards, two refreshes and deletes. The filters: "relaxed"
(about 40% of docs: a bool filter of an age range and a terms over 4
colours), "restrictive" (about 1%: an age range, one colour, and must_not
one taste), and an ids filter of fewer docs than k. Each body runs with
the stacked step on and off, at fp32, bf16 and int8, and on an IVF-PQ
indexed field, where a filtered query scans exactly on both packages.
Hit ids must be equal; scores within rtol 1e-5 / atol 1e-4, as
tests/test_torch_node_knn.py states (the two frameworks sum d products in
another order, and l2 cancels near a neighbour). Then: the filtered
searches of the stacked step count in ``filtered``, a filtered query never
merges in the dispatch batcher, and a batch's queries must share their
filter object.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu.search import ann as jax_ann
from opensearch_tpu.search import distributed_serving as jax_serving
from opensearch_tpu.telemetry import roofline
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.search import ann as torch_ann
from opensearch_tpu_torch.search import distributed_serving as torch_serving
from opensearch_tpu_torch.search import executor, query_dsl

DIM = 16
N_DOCS = 600
COLORS = ("red", "green", "blue", "yellow", "white", "black")
TASTES = ("sweet", "salty", "sour", "bitter")
DELETED = ("5", "77", "300", "599")
RELAXED = {"bool": {"filter": [
    {"range": {"age": {"gte": 20, "lt": 80}}},
    {"terms": {"color": list(COLORS[:4])}}]}}
RESTRICTIVE = {"bool": {"filter": [
    {"range": {"age": {"gte": 30, "lt": 40}}},
    {"term": {"color": "red"}}],
    "must_not": [{"term": {"taste": "sour"}}]}}
FEW_IDS = {"ids": {"values": ["1", "2", "3", "5", "400"]}}
FILTERS = {"relaxed": RELAXED, "restrictive": RESTRICTIVE, "ids": FEW_IDS}
ANN_METHOD = {"name": "ivf_pq", "parameters": {"nlist": 8, "m": 4,
                                               "min_train": 200}}


def _mapping(shards: int, ann: bool) -> dict:
    vec = {"type": "knn_vector", "dimension": DIM, "similarity": "l2_norm"}
    if ann:
        vec["method"] = ANN_METHOD
    return {"settings": {"number_of_shards": shards},
            "mappings": {"properties": {
                "v": vec, "age": {"type": "integer"},
                "color": {"type": "keyword"}, "taste": {"type": "keyword"}}}}


INDICES = {"f1": (1, False), "f4": (4, False), "fann": (1, True)}


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    prev_peaks = roofline.current_peaks()
    roofline.set_peaks(roofline.stub_peaks(seed=3))
    rng = np.random.default_rng(21)
    centers = rng.standard_normal((8, DIM)) * 4
    data = (centers[rng.integers(0, 8, N_DOCS)]
            + rng.standard_normal((N_DOCS, DIM))).astype(np.float32)
    attrs = [{"age": int(rng.integers(0, 100)),
              "color": COLORS[int(rng.integers(0, 6))],
              "taste": TASTES[int(rng.integers(0, 4))]}
             for _ in range(N_DOCS)]
    ref = TpuNode(tmp_path_factory.mktemp("tpu"))
    port = TorchNode(tmp_path_factory.mktemp("torch"), device="cpu")
    for node in (ref, port):
        for name, (shards, ann) in INDICES.items():
            node.create_index(name, _mapping(shards, ann))
            ops = [("index", {"_index": name, "_id": str(i)},
                    {"v": data[i].tolist(), **attrs[i]})
                   for i in range(N_DOCS)]
            # the ANN index: one segment past min_train (IVF-PQ built)
            cut = N_DOCS if ann else N_DOCS // 2
            node.bulk(ops[:cut])
            node.refresh(name)
            node.bulk(ops[cut:] + [("delete", {"_index": name, "_id": d},
                                    None) for d in DELETED])
            node.refresh(name)
    yield ref, port, data, attrs
    ref.close()
    port.close()
    if prev_peaks is not None:
        roofline.set_peaks(prev_peaks)


def _body(q, k: int, flt: dict, size: int | None = None) -> dict:
    return {"query": {"knn": {"v": {"vector": q.tolist(), "k": k,
                                    "filter": flt}}},
            "size": k if size is None else size}


def _eligible(attrs, flt_name: str) -> set:
    """The filter's docs by its definition, for a semantic check beside the
    reference's."""
    out = set()
    for i, a in enumerate(attrs):
        if str(i) in DELETED:
            continue
        if flt_name == "relaxed":
            ok = 20 <= a["age"] < 80 and a["color"] in COLORS[:4]
        elif flt_name == "restrictive":
            ok = 30 <= a["age"] < 40 and a["color"] == "red" \
                and a["taste"] != "sour"
        else:
            ok = str(i) in FEW_IDS["ids"]["values"]
        if ok:
            out.add(str(i))
    return out


def _compare(ref, port, index, body):
    r, t = ref.search(index, body), port.search(index, body)
    rh, th = r["hits"]["hits"], t["hits"]["hits"]
    assert [h["_id"] for h in th] == [h["_id"] for h in rh]
    np.testing.assert_allclose([h["_score"] for h in th],
                               [h["_score"] for h in rh], rtol=1e-5,
                               atol=1e-4)
    assert t["hits"]["total"] == r["hits"]["total"]
    return [h["_id"] for h in th]


@pytest.fixture(params=(True, False), ids=("stacked", "per_shard"))
def stacked(request, monkeypatch):
    monkeypatch.setattr(torch_serving, "enabled", request.param)
    monkeypatch.setattr(jax_serving, "enabled", request.param)
    return request.param


@pytest.mark.parametrize("flt_name", sorted(FILTERS))
@pytest.mark.parametrize("index", sorted(INDICES))
def test_filtered_knn_matches_reference(nodes, stacked, index, flt_name):
    ref, port, data, attrs = nodes
    rng = np.random.default_rng(len(index) * 10 + len(flt_name))
    eligible = _eligible(attrs, flt_name)
    before = (torch_serving.stats["filtered"],
              torch_serving.stats["distributed_searches"])
    for q in (data[11], data[int(rng.integers(N_DOCS))] + 0.1):
        for k in (3, 10):
            ids = _compare(ref, port, index, _body(q, k, FILTERS[flt_name]))
            # k per shard, size k: min(k, eligible) hits, all eligible
            assert set(ids) <= eligible
            assert len(ids) == min(k, len(eligible))
    served = torch_serving.stats["distributed_searches"] - before[1]
    filtered = torch_serving.stats["filtered"] - before[0]
    assert filtered == served == (4 if stacked else 0)


def test_fewer_eligible_docs_than_k_returns_exactly_them(nodes, stacked):
    ref, port, data, _attrs = nodes
    for index in INDICES:
        ids = _compare(ref, port, index, _body(data[0], 10, FEW_IDS))
        assert sorted(ids) == ["1", "2", "3", "400"]


@pytest.mark.parametrize("precision", ("bf16", "int8"))
def test_reduced_precision_filtered_matches_reference(nodes, stacked,
                                                      precision):
    ref, port, data, _attrs = nodes
    jax_ann.default_config.configure(exact_kernel="xla",
                                     score_precision=precision)
    torch_ann.default_config.configure(score_precision=precision)
    try:
        for index in ("f1", "f4"):
            for flt in (RELAXED, RESTRICTIVE):
                _compare(ref, port, index, _body(data[42], 10, flt))
    finally:
        jax_ann.default_config.configure(exact_kernel="auto",
                                         score_precision="fp32")
        torch_ann.default_config.configure(score_precision="fp32")


def test_filtered_ann_column_scans_exactly(nodes, stacked):
    """A filtered query on an IVF-PQ column never takes ANN: on the
    per-shard route the segment runs through the exact branch, and the
    stacked step serves the column itself."""
    ref, port, data, _attrs = nodes
    (shard,) = port.indices["fann"].shards.values()
    (_host, dev), = shard.acquire_searcher().segments
    assert dev.vector_fields["v"].ann is not None
    ann0, fused0 = executor.knn_path_stats["ann"], \
        executor.knn_path_stats["fused"]
    _compare(ref, port, "fann", _body(data[9], 10, RELAXED))
    assert executor.knn_path_stats["ann"] == ann0
    assert executor.knn_path_stats["fused"] - fused0 == (0 if stacked else 1)


def test_filtered_queries_never_merge_in_the_batcher(nodes, monkeypatch):
    ref, port, data, _attrs = nodes
    monkeypatch.setattr(torch_serving, "enabled", False)
    bodies = [_body(data[i], 5, RELAXED) for i in range(8)]
    solo = [port.search("f1", b) for b in bodies]
    port.knn_batcher.configure(enabled=True, max_batch_size=8,
                               max_wait_ms=200, auto_tune=False)
    port.knn_batcher.reset()
    out = [None] * len(bodies)
    barrier = threading.Barrier(len(bodies))

    def run(i):
        barrier.wait()
        out[i] = port.search("f1", bodies[i])

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(bodies))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        st = port.knn_batcher.snapshot_stats()
    finally:
        port.knn_batcher.configure(max_batch_size=32, max_wait_ms=2,
                                   auto_tune=True)
    # two segments a search, each its own launch
    assert st["max_batch"] == 1 and st["dispatches"] == 2 * len(bodies)
    for got, want in zip(out, solo):
        assert got["hits"]["hits"] == want["hits"]["hits"]


def test_a_batch_shares_its_filter_object(nodes):
    _ref, port, data, _attrs = nodes
    shards = list(port.indices["f4"].shards.values())
    snaps = [s.acquire_searcher() for s in shards]
    flt = query_dsl.parse_query(RELAXED)
    same = [query_dsl.KnnQuery(field="v", vector=data[i].tolist(), k=5,
                               filter=flt) for i in range(3)]
    f0 = torch_serving.stats["filtered"]
    out = torch_serving.mesh_knn_batch(shards, snaps, same, 5)
    assert len(out.per_query) == 3
    assert torch_serving.stats["filtered"] - f0 == 1
    other = query_dsl.KnnQuery(field="v", vector=data[0].tolist(), k=5,
                               filter=query_dsl.parse_query(RELAXED))
    with pytest.raises(ValueError, match="filter"):
        torch_serving.mesh_knn_batch(shards, snaps, [same[0], other], 5)
