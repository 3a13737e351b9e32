"""Search pipelines and the hybrid query in the port against the JAX
reference, on the CPU: the bodies of tests/test_search_pipeline.py's 23
tests, each through a TpuNode and a TorchNode(device="cpu") built from
the same writes (one and three shards), and the normalization and
combination functions on the same inputs.

Hits, totals and errors (class, status and message) must be equal; the
fused scores agree to rtol 1e-6 (BM25 adds in). A fused score is
recomputed here from the two sub-queries' own results on the same route
(the per-shard route: a hybrid query never takes the stacked step), by
the normalization and combination formulas in float64 numpy.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.search import pipeline as ref_pipeline
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.search import pipeline as port_pipeline
from test_torch_dsl import answer, pair, same

HYBRID = {"hybrid": {"queries": [
    {"match": {"title": "apple"}},
    {"knn": {"vec": {"vector": [1.0, 0.0, 0.0, 0.0], "k": 3}}}]}}
PIPELINES = {
    "only_red": {"request_processors": [{"filter_query": {
        "query": {"match": {"title": "red"}}}}]},
    "os": {"request_processors": [{"oversample": {"sample_factor": 2.0}}],
           "response_processors": [{"truncate_hits": {}}]},
    "rn": {"response_processors": [{"rename_field": {
        "field": "title", "target_field": "name"}}]},
    "srt": {"response_processors": [{"sort": {
        "field": "tags", "order": "desc"}}]},
    "norm": {"phase_results_processors": [{"normalization-processor": {
        "normalization": {"technique": "l2"},
        "combination": {"technique": "arithmetic_mean",
                        "parameters": {"weights": [0.3, 0.7]}}}}]},
    "mm": {"phase_results_processors": [{"normalization-processor": {
        "normalization": {"technique": "min_max"},
        "combination": {"technique": "arithmetic_mean",
                        "parameters": {"weights": [0.3, 0.7]}}}}]},
    "zg": {"phase_results_processors": [{"normalization-processor": {
        "normalization": {"technique": "z_score"},
        "combination": {"technique": "geometric_mean"}}}]},
    "mh": {"phase_results_processors": [{"normalization-processor": {
        "normalization": {"technique": "min_max"},
        "combination": {"technique": "harmonic_mean",
                        "parameters": {"weights": [2.0, 1.0]}}}}]},
    "rrf": {"phase_results_processors": [{"score-ranker-processor": {
        "combination": {"technique": "rrf", "rank_constant": 60}}}]},
    "t1": {"response_processors": [{"truncate_hits": {"target_size": 1}}]},
    "t3": {"response_processors": [{"truncate_hits": {"target_size": 3}}]},
}


def _corpus(node, index: str, shards: int) -> None:
    node.create_index(index, {
        "settings": {"index": {"number_of_shards": shards}},
        "mappings": {"properties": {
            "title": {"type": "text"}, "tags": {"type": "keyword"},
            "vec": {"type": "dense_vector", "dims": 4,
                    "similarity": "l2_norm"}}}})
    for _id, title, vec in (
            ("1", "red apple pie", [1.0, 0.0, 0.0, 0.0]),
            ("2", "green apple tart", [0.9, 0.1, 0.0, 0.0]),
            ("3", "red fire truck", [0.0, 1.0, 0.0, 0.0]),
            ("4", "blue ocean water", [0.0, 0.0, 1.0, 0.0]),
            ("5", "apple orchard visit", [0.8, 0.2, 0.1, 0.0])):
        node.index_doc(index, _id, {"title": title, "vec": vec,
                                    "tags": ["b", "c", "a"][: int(_id) % 3
                                                            + 1]})
    node.refresh(index)


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    ref, port = pair(tmp_path_factory, "pipelines")
    for node in (ref, port):
        _corpus(node, "hyb", 1)
        _corpus(node, "hyb2", 3)
        for pid, body in PIPELINES.items():
            node.search_pipelines.put(pid, body)
        node.search_pipelines.put("dflt", {"response_processors": [
            {"truncate_hits": {"target_size": 1}}]})
        node.create_index("auto", {
            "settings": {"index": {"search": {"default_pipeline": "dflt"}}},
            "mappings": {"properties": {"t": {"type": "keyword"}}}})
        for i in range(4):
            node.index_doc("auto", str(i), {"t": "x"})
        node.refresh("auto")
    yield ref, port
    ref.close()
    port.close()


# -- TestNormalizeCombine ----------------------------------------------------


@pytest.mark.parametrize("all_scores,scores,technique", [
    ([1.0, 3.0, 5.0], [1.0, 3.0, 5.0], "min_max"),
    ([2.0], [2.0], "min_max"),
    ([3.0, 4.0], [3.0, 4.0], "l2"),
    ([1.0, 2.0, 6.0], [2.0, 6.0], "z_score"),
])
def test_normalize_is_the_references(all_scores, scores, technique):
    assert port_pipeline._normalize(all_scores, scores, technique) == \
        ref_pipeline._normalize(all_scores, scores, technique)


@pytest.mark.parametrize("subs,technique,weights", [
    ([0.8, None], "arithmetic_mean", []),
    ([1.0, 0.5], "arithmetic_mean", [3.0, 1.0]),
    ([0.5, None], "harmonic_mean", []),
    ([0.25, 1.0], "geometric_mean", []),
    ([0.25, 0.0, 1.0], "geometric_mean", [1.0, 2.0]),
])
def test_combine_is_the_references(subs, technique, weights):
    assert port_pipeline._combine(subs, technique, weights) == \
        ref_pipeline._combine(subs, technique, weights)


# -- TestPipelineCrud --------------------------------------------------------


def test_put_get_delete(nodes):
    ref, port = nodes
    body = {"request_processors": [{"filter_query": {
        "query": {"match_all": {}}}}]}
    for call in (lambda n: n.search_pipelines.put("p1", body),
                 lambda n: n.search_pipelines.get("p1"),
                 lambda n: n.search_pipelines.delete("p1"),
                 lambda n: n.search_pipelines.get("p1"),
                 lambda n: n.search_pipelines.delete("p1"),
                 lambda n: n.search_pipelines.put("bad", {
                     "request_processors": [{"nope": {}}]}),
                 lambda n: n.search_pipelines.put("bad", {
                     "response_processors": [{"a": {}, "b": {}}]})):
        out = answer(ref, port, call)
        if out is not None:
            assert out[1] == out[0]


def test_persistence(tmp_path):
    n1 = TorchNode(tmp_path / "n", device="cpu")
    n1.search_pipelines.put("keep", {"response_processors": [
        {"truncate_hits": {"target_size": 1}}]})
    n2 = TorchNode(tmp_path / "n", device="cpu")
    assert n2.search_pipelines.pipelines == n1.search_pipelines.pipelines
    assert (tmp_path / "n" / "search_pipelines.json").exists()
    n1.close()
    n2.close()


# -- request and response processors, hybrid ---------------------------------


@pytest.mark.parametrize("index", ["hyb", "hyb2"])
@pytest.mark.parametrize("body,pipeline", [
    ({"query": {"match_all": {}}}, "only_red"),
    ({"size": 2, "query": {"match_all": {}}}, "os"),
    ({"query": {"ids": {"values": ["1"]}}}, "rn"),
    ({"query": {"match_all": {}}}, "srt"),
    ({"query": HYBRID}, None),
    ({"query": HYBRID}, "norm"),
    ({"query": HYBRID}, "mm"),
    ({"query": HYBRID}, "zg"),
    ({"query": HYBRID}, "mh"),
    ({"query": HYBRID}, "rrf"),
    ({"query": HYBRID, "size": 2, "from": 1}, "mm"),
    ({"query": HYBRID, "min_score": 0.5}, "mm"),
    ({"query": {"hybrid": {"queries": [
        {"match": {"title": "apple"}},
        {"knn": {"vec": {"vector": [1.0, 0.0, 0.0, 0.0], "k": 5}}}]}}},
     None),
    ({"query": HYBRID, "sort": [{"_id": "asc"}]}, None),
    ({"query": HYBRID, "sort": [{"tags": "asc"}], "search_after": ["a"]},
     None),
    ({"query": {"bool": {"must": [{"hybrid": {"queries": [
        {"match": {"title": "apple"}}]}}]}}}, None),
    ({"query": {"hybrid": {"queries": [{"match": {"title": "apple"}},
                                       {"match": {"title": "red"}}]}},
      "aggs": {"n": {"value_count": {"field": "title"}}}}, None),
    ({"query": {"match_all": {}}, "search_pipeline": "t3"}, "t1"),
    ({"query": {"match_all": {}}, "search_pipeline": "t3"}, None),
    ({"query": {"match_all": {}}}, "nope"),
])
def test_body_matches_reference(nodes, index, body, pipeline):
    ref, port = nodes
    got = same(ref, port, index, body, search_pipeline=pipeline)
    if got is not None and "hybrid" in str(body.get("query")):
        assert got["hits"]["hits"]


@pytest.mark.parametrize("pipeline", [None, "_none"])
def test_default_pipeline_setting(nodes, pipeline):
    ref, port = nodes
    got = same(ref, port, "auto", {"query": {"match_all": {}}},
               search_pipeline=pipeline)
    assert len(got["hits"]["hits"]) == (1 if pipeline is None else 4)


def test_default_pipeline_keeps_msearch_off_the_batch(nodes):
    """An index with a default pipeline: its bare-knn msearch run is not
    merged into one stacked launch, and each body is truncated by the
    pipeline."""
    ref, port = nodes
    port.search_pipelines.put("dflt2", {"response_processors": [
        {"truncate_hits": {"target_size": 1}}]})
    port.create_index("autov", {
        "settings": {"index": {"search": {"default_pipeline": "dflt2"}}},
        "mappings": {"properties": {"v": {"type": "knn_vector",
                                          "dimension": 2}}}})
    port.bulk([("index", {"_index": "autov", "_id": str(i)},
                {"v": [float(i), 1.0]}) for i in range(6)], refresh=True)
    assert port._try_msearch_knn_batch("autov", [
        {"query": {"knn": {"v": {"vector": [1.0, 1.0], "k": 3}}}}] * 2) \
        is None
    resp = port.msearch([({"index": "autov"}, {"query": {"knn": {"v": {
        "vector": [1.0, 1.0], "k": 3}}}})] * 2)
    assert [len(r["hits"]["hits"]) for r in resp["responses"]] == [1, 1]


def _numpy_fusion(sub_hits: list, config: dict, n_sub: int) -> dict:
    """The fused score of each doc from the sub-queries' own hits ({id:
    score} each), in float64: min_max over every hit of a sub-query (a
    floor of 0.001), then the weighted arithmetic mean, absent scores 0."""
    comb = (config.get("combination") or {})
    weights = (comb.get("parameters") or {}).get("weights") or [1.0] * n_sub
    normed = []
    for hits in sub_hits:
        vals = np.asarray(list(hits.values()), np.float64)
        lo, hi = vals.min(), vals.max()
        normed.append({d: (max((s - lo) / (hi - lo), 0.001) if hi > lo
                           else 1.0) for d, s in hits.items()})
    docs = set().union(*sub_hits)
    return {d: sum(w * nh.get(d, 0.0) for w, nh in zip(weights, normed))
            / sum(weights) for d in docs}


@pytest.mark.parametrize("index", ["hyb", "hyb2"])
def test_fused_scores_are_the_sub_queries_fused(nodes, index):
    """mm's fused scores against a numpy fusion of each sub-query's own
    hits on the same (per-shard) route."""
    from opensearch_tpu_torch.search import distributed_serving

    _ref, port = nodes
    got = port.search(index, {"query": HYBRID}, search_pipeline="mm")
    subs = []
    distributed_serving.enabled = False
    try:
        for sub in HYBRID["hybrid"]["queries"]:
            hits = port.search(index, {"query": sub, "size": 10})["hits"]
            subs.append({h["_id"]: h["_score"] for h in hits["hits"]})
    finally:
        distributed_serving.enabled = True
    want = _numpy_fusion(
        subs, PIPELINES["mm"]["phase_results_processors"][0][
            "normalization-processor"], 2)
    for h in got["hits"]["hits"]:
        np.testing.assert_allclose(h["_score"], want[h["_id"]], rtol=1e-6)
    assert {h["_id"] for h in got["hits"]["hits"]} <= set(want)
