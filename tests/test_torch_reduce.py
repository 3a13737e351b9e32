"""The coordinator's reduce (search/reduce.py) and ``merge_shard_hits``
(ops/topk.py): the port's against the reference's.

A TpuNode and a TorchNode(device="cpu") hold the same seeded index of 4
shards; each package's ``search.service.search(..., partial=True,
shard_numbers=...)`` makes three node partials (shards {0, 2}, {1} and
{3}), and each package's ``reduce_search_responses`` merges its own. The
two final responses are equal (``took`` left out; l2 scores to rtol 1e-5 /
atol 1e-4, the tolerance tests/test_torch_node_knn.py states), and the
port's reduce of the reference's partials is the reference's reduce of
them exactly. The bodies: hits with ties (``match_all``, a
``constant_score`` term, broken by the ``_tb`` triple), a page past
``from``, a capped and an exact total, a sort, a kNN, and aggregations
(terms with a sub-metric, a histogram with empty buckets, ``avg`` and
``cardinality`` partials, and the pipeline aggregations ``max_bucket``
and ``derivative``, which run at the coordinator only).

``merge_shard_hits`` takes seeded per-shard (scores, docs) with ties and
-inf padding, as numpy arrays and as tensors.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu.ops.topk import merge_shard_hits as ref_merge
from opensearch_tpu.search import reduce as ref_reduce
from opensearch_tpu.search import service as ref_service
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.ops.topk import merge_shard_hits
from opensearch_tpu_torch.search import reduce as port_reduce
from opensearch_tpu_torch.search import service as port_service

from test_torch_cluster_data import assert_same

DIM, N_DOCS, SHARDS = 8, 80, 4
GROUPS = ([0, 2], [1], [3])
RTOL, ATOL = 1e-5, 1e-4

BODIES = {
    "match_all_ties": {"query": {"match_all": {}}, "size": 7, "from": 2},
    "constant_ties": {"query": {"constant_score": {
        "filter": {"term": {"tag": "t1"}}, "boost": 2.0}}, "size": 30,
        "track_total_hits": 5},
    "sorted": {"query": {"range": {"n": {"gte": 10}}},
               "sort": [{"n": "desc"}], "size": 6},
    "knn": {"query": {"knn": {"v": {"vector": [0.5] * DIM, "k": 6}}},
            "size": 6},
    "aggs": {"size": 0, "aggs": {
        "tags": {"terms": {"field": "tag"},
                 "aggs": {"mean": {"avg": {"field": "n"}}}},
        "hist": {"histogram": {"field": "n", "interval": 5,
                               "min_doc_count": 0}},
        "uniq": {"cardinality": {"field": "n"}},
        "mean": {"avg": {"field": "n"}},
        "top": {"max_bucket": {"buckets_path": "hist>_count"}},
    }},
    "derivative": {"size": 0, "aggs": {"hist": {
        "histogram": {"field": "n", "interval": 10},
        "aggs": {"d": {"derivative": {"buckets_path": "_count"}}}}}},
}


def _fill(node):
    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((N_DOCS, DIM)).astype(np.float32)
    node.create_index("r", {
        "settings": {"number_of_shards": SHARDS},
        "mappings": {"properties": {
            "v": {"type": "knn_vector", "dimension": DIM},
            "tag": {"type": "keyword"}, "n": {"type": "long"}}}})
    # n leaves holes the histogram fills with empty buckets
    ns = rng.choice(np.r_[0:20, 40:60], N_DOCS)
    node.bulk([("index", {"_index": "r", "_id": str(i)},
                {"v": vecs[i].tolist(), "tag": f"t{i % 4}", "n": int(ns[i])})
               for i in range(N_DOCS)])
    node.refresh("r")


def _partials(node, service, body) -> list[dict]:
    shards = node.indices["r"].shards
    return [service.search([shards[i] for i in group], dict(body),
                           partial=True, shard_numbers=list(group))
            for group in GROUPS]


def _reduce(reduce_mod, body, partials):
    return reduce_mod.reduce_search_responses(
        body, partials, size=int(body.get("size", 10)),
        from_=int(body.get("from", 0)),
        track_total=body.get("track_total_hits", True))


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    ref = TpuNode(tmp_path_factory.mktemp("ref"))
    port = TorchNode(tmp_path_factory.mktemp("port"), device="cpu")
    _fill(ref)
    _fill(port)
    yield ref, port
    ref.close()
    port.close()


@pytest.mark.parametrize("name", sorted(BODIES))
def test_reduce_of_node_partials(nodes, name):
    ref, port = nodes
    body = BODIES[name]
    ref_parts = _partials(ref, ref_service, body)
    port_parts = _partials(port, port_service, body)
    # the node partials themselves: same hits, tie-break triples and
    # aggregation extras
    for a, b in zip(ref_parts, port_parts):
        assert [h["_id"] for h in a["hits"]["hits"]] == \
            [h["_id"] for h in b["hits"]["hits"]]
        assert [h["_tb"][0] for h in a["hits"]["hits"]] == \
            [h["_tb"][0] for h in b["hits"]["hits"]]
        assert set(a.get("_generations", {})) == \
            set(b.get("_generations", {}))
    want = _reduce(ref_reduce, body, ref_parts)
    got = _reduce(port_reduce, body, port_parts)
    assert_same(want, got, rtol=RTOL, atol=ATOL)
    # the port's reduce of the reference's partials is the reference's
    assert_same(want, _reduce(port_reduce, body, ref_parts), rtol=0.0)
    if name == "aggs":
        hist = got["aggregations"]["hist"]["buckets"]
        assert any(b["doc_count"] == 0 for b in hist)
        assert "value" in got["aggregations"]["top"]
    if name == "constant_ties":
        assert got["hits"]["total"] == {"value": 5, "relation": "gte"}


@pytest.mark.parametrize("as_tensor", [False, True])
def test_merge_shard_hits(as_tensor):
    rng = np.random.default_rng(5)
    per_shard = []
    for _ in range(4):
        scores = rng.integers(0, 4, 8).astype(np.float32)   # many ties
        scores[rng.random(8) < 0.25] = -np.inf               # no hit
        docs = rng.permutation(50)[:8]
        per_shard.append((scores, docs))
    want = ref_merge(per_shard, 12)
    arg = ([(torch.from_numpy(s), torch.from_numpy(d)) for s, d in per_shard]
           if as_tensor else per_shard)
    got = merge_shard_hits(arg, 12)
    assert got == want
    assert len(got) == 12 and all(np.isfinite(s) for s, _i, _d in got)
