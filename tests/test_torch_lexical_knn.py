"""kNN beside the lexical query phase on TorchNode(device="cpu") against
TpuNode: a ``knn`` clause inside a ``bool`` (must, should, filter, beside
a BM25 ``match`` and filters), and a ``knn`` query whose ``filter`` is one
of the nodes this slice ports (``match``, ``match_phrase``, ``prefix``,
``wildcard``, ``query_string``, ``multi_match`` and a ``bool`` of them).

The index: a few hundred docs made from a numpy seed, each with Zipf-drawn
words in ``body``, a keyword ``tag``, an integer ``views`` and a 16-d
clustered vector ``v`` (l2), in one and in three shards, written in two
refreshes with deletes. A filtered knn runs on the stacked step and on the
per-shard route; a knn inside a bool always takes the per-shard route,
through ``ShardContext.shard_knn_selection`` and K1's wrapper (the
``fused`` branch: on the CPU its plain version, on the card the kernel).
Hit ids and totals must be equal; scores within rtol 1e-5 / atol 1e-4, the
tolerance of tests/test_torch_filtered_knn.py (the two frameworks sum the
d products in another order); BM25 halves of a sum are bit-equal.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu.search import distributed_serving as jax_serving
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.search import distributed_serving as torch_serving
from opensearch_tpu_torch.search import executor
from test_torch_lexical import _word

DIM = 16
N_DOCS = 360
DELETED = ("4", "90", "200", "359")


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    rng = np.random.default_rng(31)
    centers = rng.standard_normal((6, DIM)) * 3
    data = (centers[rng.integers(0, 6, N_DOCS)]
            + rng.standard_normal((N_DOCS, DIM))).astype(np.float32)
    p = np.arange(1, 201, dtype=np.float64) ** -1.07
    p /= p.sum()
    docs = [{"body": " ".join(_word(int(w)) for w in rng.choice(
                200, int(rng.integers(3, 20)), p=p)),
             "tag": f"t{int(rng.integers(0, 9))}",
             "views": int(rng.integers(0, 500)),
             "v": data[i].tolist()} for i in range(N_DOCS)]
    ref = TpuNode(tmp_path_factory.mktemp("tpu"))
    port = TorchNode(tmp_path_factory.mktemp("torch"), device="cpu")
    for node in (ref, port):
        for name, shards in (("k1", 1), ("k3", 3)):
            node.create_index(name, {
                "settings": {"number_of_shards": shards},
                "mappings": {"properties": {
                    "body": {"type": "text"}, "tag": {"type": "keyword"},
                    "views": {"type": "integer"},
                    "v": {"type": "knn_vector", "dimension": DIM,
                          "similarity": "l2_norm"}}}})
            ops = [("index", {"_index": name, "_id": str(i)}, docs[i])
                   for i in range(N_DOCS)]
            node.bulk(ops[: N_DOCS // 2])
            node.refresh(name)
            node.bulk(ops[N_DOCS // 2:] + [
                ("delete", {"_index": name, "_id": d}, None)
                for d in DELETED])
            node.refresh(name)
    yield ref, port, data
    ref.close()
    port.close()


def _knn(q, k: int = 10, flt: dict | None = None) -> dict:
    clause = {"vector": q.tolist(), "k": k}
    if flt is not None:
        clause["filter"] = flt
    return {"knn": {"v": clause}}


def _compare(ref, port, index, body):
    r, t = ref.search(index, body), port.search(index, body)
    rh, th = r["hits"]["hits"], t["hits"]["hits"]
    assert [h["_id"] for h in th] == [h["_id"] for h in rh]
    np.testing.assert_allclose([h["_score"] for h in th],
                               [h["_score"] for h in rh], rtol=1e-5,
                               atol=1e-4)
    assert t["hits"]["total"] == r["hits"]["total"]
    return [h["_id"] for h in th]


def _bool_bodies(q):
    return {
        "should_match_knn": {"bool": {"should": [
            {"match": {"body": f"{_word(0)} {_word(3)}"}}, _knn(q)]}},
        "must_knn_filter_term": {"bool": {
            "must": [_knn(q, 20)], "filter": [{"term": {"tag": "t2"}}]}},
        "must_match_should_knn": {"bool": {
            "must": [{"match": {"body": _word(1)}}],
            "should": [_knn(q, 15)]}},
        "filter_knn": {"bool": {"filter": [_knn(q, 12)],
                                "must_not": [{"range": {"views": {
                                    "lt": 100}}}]}},
        "knn_boost_in_dis_max": {"dis_max": {"queries": [
            {"match": {"body": _word(2)}},
            {"knn": {"v": {"vector": q.tolist(), "k": 8, "boost": 2.0}}}],
            "tie_breaker": 0.5}},
    }


FILTERS = {
    "match": {"match": {"body": f"{_word(0)} {_word(5)}"}},
    "match_phrase": {"match_phrase": {"body": f"{_word(0)} {_word(1)}"}},
    "prefix": {"prefix": {"tag": "t1"}},
    "wildcard": {"wildcard": {"body": "b*"}},
    "query_string": {"query_string": {
        "query": f"{_word(2)} OR tag:t3", "fields": ["body"]}},
    "multi_match": {"multi_match": {"query": _word(4),
                                    "fields": ["body", "tag"]}},
    "bool_of_them": {"bool": {"must": [{"match": {"body": _word(0)}}],
                              "must_not": [{"prefix": {"tag": "t4"}}]}},
}


@pytest.mark.parametrize("name", sorted(_bool_bodies(np.zeros(DIM))))
@pytest.mark.parametrize("index", ("k1", "k3"))
def test_knn_inside_bool_matches_reference(nodes, index, name):
    ref, port, data = nodes
    fused0 = executor.knn_path_stats["fused"]
    for qi in (7, 123):
        body = {"query": _bool_bodies(data[qi] + 0.05)[name], "size": 15}
        ids = _compare(ref, port, index, body)
        assert ids
    # every segment's selection went through K1's wrapper, once a query
    # and segment (a bool reads the host selection as device tensors)
    shards = port.indices[index].shards.values()
    n_segments = sum(len(s.acquire_searcher().segments) for s in shards)
    assert executor.knn_path_stats["fused"] - fused0 == 2 * n_segments


@pytest.fixture(params=(True, False), ids=("stacked", "per_shard"))
def stacked(request, monkeypatch):
    monkeypatch.setattr(torch_serving, "enabled", request.param)
    monkeypatch.setattr(jax_serving, "enabled", request.param)
    return request.param


@pytest.mark.parametrize("flt", sorted(FILTERS))
@pytest.mark.parametrize("index", ("k1", "k3"))
def test_knn_filtered_by_a_ported_node_matches_reference(nodes, stacked,
                                                         index, flt):
    ref, port, data = nodes
    before = (torch_serving.stats["filtered"],
              executor.knn_path_stats["fused"])
    for qi in (2, 250):
        assert _compare(ref, port, index,
                        {"query": _knn(data[qi], 10, FILTERS[flt]),
                         "size": 10})
    filtered = torch_serving.stats["filtered"] - before[0]
    fused = executor.knn_path_stats["fused"] - before[1]
    assert filtered == (2 if stacked else 0)
    assert (fused > 0) == (not stacked)


def test_filtered_knn_hits_satisfy_the_filter(nodes):
    """The filter's own hits bound the filtered knn's: every hit of a knn
    filtered by a match is a hit of that match."""
    _ref, port, data = nodes
    flt = FILTERS["match"]
    allowed = {h["_id"] for h in port.search(
        "k3", {"query": flt, "size": N_DOCS})["hits"]["hits"]}
    got = port.search("k3", {"query": _knn(data[17], 10, flt)})
    ids = {h["_id"] for h in got["hits"]["hits"]}
    assert ids and ids <= allowed


def test_bool_knn_selection_reaches_the_device_once_a_segment(
        nodes, monkeypatch):
    """A knn child inside a bool copies its host selection to the device
    once a segment, however often the bool reads it."""
    _ref, port, data = nodes
    copies = []
    real = executor.HostNodeResult.scores.fget

    def counting(self):
        if self._dev_scores is None:
            copies.append(1)
        return real(self)

    monkeypatch.setattr(executor.HostNodeResult, "scores",
                        property(counting))
    body = {"query": {"bool": {"must": [_knn(data[3])],
                               "should": [{"match": {"body": _word(0)}}]}}}
    port.search("k1", body)
    (shard,) = port.indices["k1"].shards.values()
    assert len(copies) == len(shard.acquire_searcher().segments)
