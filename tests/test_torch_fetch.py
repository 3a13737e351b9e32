"""The fetch options of a kNN `_search`: TorchNode(device="cpu") against
TpuNode on the same bodies.

One bulk (with an update, deletes and two refreshes) goes into both nodes
for 1 and 4 shards and the l2 and cosine similarities; each request adds
one fetch key to a kNN body: `version`, `seq_no_primary_term`,
`stored_fields` (a stored field, `_source` beside it, and `_none_`),
`docvalue_fields` (with formats), `fields` (a wildcard and a date format),
`explain`, `highlight`, `_source` includes / excludes, `min_score` (which
takes the per-shard route in both packages), `timeout`, `stats` and
`track_total_hits`. The responses must be equal with `took` removed and
floats to rtol 1e-5 / atol 1e-4 (tests/test_torch_node_knn.py explains
the tolerance). An msearch run of bodies with `version` and
`seq_no_primary_term` (batched in one stacked launch) is held to the
reference's the same way.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu.telemetry import roofline
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.search import distributed_serving as torch_serving

from test_torch_rest import _assert_same, _strip

DIM = 6
N_DOCS = 120
SIMS = ("l2_norm", "cosine")
SHARDS = (1, 4)
COLORS = ("red", "green", "blue", "black")


def _index(shards: int, sim: str) -> str:
    return f"f-{shards}-{sim.replace('_', '-')}"


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    prev_peaks = roofline.current_peaks()
    roofline.set_peaks(roofline.stub_peaks(seed=3))
    rng = np.random.default_rng(21)
    data = rng.standard_normal((N_DOCS, DIM)).astype(np.float32).round(4)
    ref = TpuNode(tmp_path_factory.mktemp("tpu"))
    port = TorchNode(tmp_path_factory.mktemp("torch"), device="cpu")
    for node in (ref, port):
        for shards in SHARDS:
            for sim in SIMS:
                name = _index(shards, sim)
                node.create_index(name, {
                    "settings": {"number_of_shards": shards},
                    "mappings": {"properties": {
                        "v": {"type": "knn_vector", "dimension": DIM,
                              "similarity": sim},
                        "age": {"type": "integer"},
                        "tag": {"type": "keyword", "store": True},
                        "color": {"type": "keyword"},
                        "title": {"type": "text"},
                        "created": {"type": "date"},
                        "user": {"properties": {
                            "name": {"type": "keyword"},
                            "rank": {"type": "integer"}}}}},
                })
                ops = [("index", {"_index": name, "_id": str(i)}, {
                    "v": data[i].tolist(), "age": i % 70,
                    "tag": f"t{i % 5}", "color": [COLORS[i % 4],
                                                  COLORS[(i + 1) % 4]],
                    "title": f"red fish number {i}",
                    "created": f"2023-0{1 + i % 9}-2{i % 8}T10:00:00Z",
                    "user": {"name": f"u{i % 7}", "rank": i}})
                    for i in range(N_DOCS)]
                node.bulk(ops[:N_DOCS // 2])
                node.refresh(name)
                node.bulk(ops[N_DOCS // 2:] + [
                    ("update", {"_index": name, "_id": "5"},
                     {"doc": {"age": 99}}),
                    ("delete", {"_index": name, "_id": "9"}, None),
                    ("delete", {"_index": name, "_id": "77"}, None)])
                node.refresh(name)
    yield ref, port, data
    ref.close()
    port.close()
    if prev_peaks is not None:
        roofline.set_peaks(prev_peaks)


FETCH_OPTIONS = {
    "version": {"version": True},
    "seq_no_primary_term": {"seq_no_primary_term": True},
    "version_and_seq_no": {"version": True, "seq_no_primary_term": True},
    "stored_fields": {"stored_fields": ["tag"]},
    "stored_fields_with_source": {"stored_fields": ["tag", "_source"]},
    "stored_fields_none": {"stored_fields": "_none_"},
    "stored_fields_explicit_source": {"stored_fields": ["tag"],
                                      "_source": ["age"]},
    "docvalue_fields": {"docvalue_fields": [
        "age", "color", {"field": "created", "format": "epoch_millis"},
        {"field": "age", "format": "#.0"}]},
    "fields": {"fields": ["a*", "user.*",
                          {"field": "created", "format": "yyyy"}]},
    "fields_and_docvalues": {"fields": ["tag"], "docvalue_fields": ["age"],
                             "_source": False},
    "explain": {"explain": True},
    "highlight": {"highlight": {"fields": {"title": {}}}},
    "source_includes": {"_source": {"includes": ["user.*", "age"]}},
    "source_excludes": {"_source": {"excludes": ["v", "title"]}},
    "source_list": {"_source": ["tag", "user.name"]},
    "source_false": {"_source": False},
    "min_score": {"min_score": 0.2},
    "min_score_high": {"min_score": 0.9},
    "timeout": {"timeout": "5s"},
    "stats": {"stats": ["group_a", "group_b"]},
    "track_total_hits": {"track_total_hits": 3},
    "everything": {"version": True, "seq_no_primary_term": True,
                   "docvalue_fields": ["age"], "fields": ["user.*"],
                   "explain": True, "_source": {"excludes": ["v"]},
                   "min_score": 0.1},
}


@pytest.mark.parametrize("option", sorted(FETCH_OPTIONS))
@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("shards", SHARDS)
def test_fetch_option_matches_reference(nodes, shards, sim, option):
    ref, port, data = nodes
    name = _index(shards, sim)
    q = (data[17] + 0.1).tolist()
    body = {"query": {"knn": {"v": {"vector": q, "k": 12}}}, "size": 8,
            **FETCH_OPTIONS[option]}
    want = ref.search(name, dict(body))
    got = port.search(name, dict(body))
    assert got["hits"]["hits"] or option == "min_score_high"
    _assert_same(_strip(want), _strip(got))


def test_min_score_takes_the_per_shard_route(nodes):
    """The stacked step declines a min_score (as the reference's does):
    the search is served, and no stacked launch ran."""
    _ref, port, data = nodes
    before = torch_serving.stats["distributed_searches"]
    got = port.search(_index(1, "l2_norm"), {"query": {"knn": {"v": {
        "vector": data[3].tolist(), "k": 5}}}, "min_score": 0.0})
    assert torch_serving.stats["distributed_searches"] == before
    assert [h["_id"] for h in got["hits"]["hits"]][0] == "3"


def test_stats_must_be_a_list(nodes):
    """The reference means a ParsingException here (opensearch_tpu/node.py
    raises ParsingException("[stats] must be an array of group names"))
    but never imports the name, so it raises NameError; the port raises
    the exception the reference's code names."""
    ref, port, data = nodes
    body = {"query": {"knn": {"v": {"vector": data[3].tolist(), "k": 2}}},
            "stats": "group"}
    with pytest.raises(NameError, match="ParsingException"):
        ref.search(_index(1, "l2_norm"), dict(body))
    from opensearch_tpu_torch.common.errors import ParsingException

    with pytest.raises(ParsingException,
                       match=r"^\[stats\] must be an array of group names$"):
        port.search(_index(1, "l2_norm"), dict(body))


def test_named_knn_query_is_not_yet_ported(nodes):
    """Named queries are served now: a named knn's hits carry the
    reference's ``matched_queries``, with and without their scores."""
    ref, port, data = nodes
    for extra in ({}, {"include_named_queries_score": True}):
        body = {"query": {"knn": {"v": {
            "vector": data[3].tolist(), "k": 2, "_name": "near"}}}, **extra}
        want = ref.search(_index(1, "l2_norm"), dict(body))
        got = port.search(_index(1, "l2_norm"), dict(body))
        for w, g in zip(want["hits"]["hits"], got["hits"]["hits"]):
            mq_w, mq_g = w.pop("matched_queries"), g.pop("matched_queries")
            if isinstance(mq_w, dict):
                # kNN scores: the two frameworks sum d products in another
                # order (tests/test_torch_node_knn.py's tolerance)
                assert set(mq_g) == set(mq_w)
                for k in mq_w:
                    assert mq_g[k] == pytest.approx(mq_w[k], rel=1e-5,
                                                    abs=1e-4)
            else:
                assert mq_g == mq_w == ["near"]
        _assert_same(_strip(want), _strip(got))


@pytest.mark.parametrize("shards", SHARDS)
def test_batched_msearch_fetch_matches_reference(nodes, shards):
    """A run of bodies with `version` and `seq_no_primary_term` shares one
    stacked launch in both packages, and its fetch is the reference's."""
    ref, port, data = nodes
    name = _index(shards, "l2_norm")
    searches = [({"index": name}, {
        "query": {"knn": {"v": {"vector": (data[i] - 0.05).tolist(),
                                "k": 6}}},
        "size": 6, "version": True, "seq_no_primary_term": True})
        for i in (2, 40, 63, 101)]
    before = torch_serving.stats["batched_queries"]
    got = port.msearch(searches)
    assert torch_serving.stats["batched_queries"] - before == len(searches)
    want = ref.msearch(searches)
    _assert_same(_strip(want), _strip(got))
