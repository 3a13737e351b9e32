"""Batched ``_msearch`` kNN (opensearch_tpu_torch/node.py ``msearch``,
search/service.py ``msearch_groups`` / ``try_batched_knn_msearch``,
search/distributed_serving.py ``try_distributed_knn_batch``) against the
reference's (opensearch_tpu/node.py, search/service.py), on the CPU.

The reference's own cases (tests/test_distributed_serving.py
``test_msearch_batches_knn_queries``, ``test_msearch_mixed_bodies_still_
correct``) run on a reference TpuNode and a TorchNode(device="cpu") over
the same docs: the grouping rule, one stacked launch for a run of bare knn
bodies (``batched_queries`` rises by the run's size), the serial path for a
filter, another k and another field, an error in its own slot, and every
batched hit list equal to its solo search and to the reference's: ids
equal, scores to rtol 1e-5 / atol 1e-4 against the reference (as
tests/test_torch_node_knn.py states) and to rtol 1e-6 / atol 1e-7 against
the solo search (here the stacked step runs K1's plain version, whose
batched product lets the library order each dot's sum by the batch; on the
card the kernels sum in one order, and chip_smoke.py's msearch phase holds
a batch to its solo searches bit for bit).
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu.search import distributed_serving as jax_serving
from opensearch_tpu.search import service as jax_service
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.search import distributed_serving as torch_serving
from opensearch_tpu_torch.search import service as torch_service

DIMS = 8
N_DOCS = 80


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((N_DOCS, DIMS)).round(3)
    other = rng.standard_normal((N_DOCS, DIMS)).round(3)
    ref = TpuNode(tmp_path_factory.mktemp("tpu"))
    port = TorchNode(tmp_path_factory.mktemp("torch"), device="cpu")
    for node in (ref, port):
        node.create_index("vecs", {
            "settings": {"number_of_shards": 4},
            "mappings": {"properties": {
                "v": {"type": "knn_vector", "dimension": DIMS},
                "w": {"type": "knn_vector", "dimension": DIMS},
                "n": {"type": "long"}}}})
        node.bulk([("index", {"_index": "vecs", "_id": f"d{i}"},
                    {"v": vecs[i].tolist(), "w": other[i].tolist(), "n": i})
                   for i in range(N_DOCS)], refresh=True)
    yield ref, port
    ref.close()
    port.close()


def _knn(vector, k, size=10, field="v", **extra):
    clause = {"vector": list(vector), "k": k, **extra}
    return {"query": {"knn": {field: clause}}, "size": size}


def _queries(n, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(DIMS).round(3).tolist() for _ in range(n)]


def _hits(resp):
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


def _same_as_solo(got, solo):
    assert [h[0] for h in got] == [h[0] for h in solo]
    np.testing.assert_allclose([h[1] for h in got], [h[1] for h in solo],
                               rtol=1e-6, atol=1e-7)


def _same_as_reference(got, want):
    assert [h[0] for h in got] == [h[0] for h in want]
    np.testing.assert_allclose([h[1] for h in got], [h[1] for h in want],
                               rtol=1e-5, atol=1e-4)


def _counts():
    return (torch_serving.stats["distributed_searches"],
            torch_serving.stats["batched_queries"])


def test_msearch_batches_knn_queries(nodes):
    """Three bare knn bodies on one index: ONE stacked launch of B = 3, each
    response its solo search's hits and the reference's."""
    ref, port = nodes
    searches = [({"index": "vecs"}, _knn(q, k=5, size=5))
                for q in _queries(3)]
    before = _counts()
    batched = port.msearch(searches)
    after = _counts()
    assert after[0] - before[0] == 1, "3 knn bodies must share ONE launch"
    assert after[1] - before[1] == 3
    ref_resp = ref.msearch(searches)
    for got, (header, body), want in zip(batched["responses"], searches,
                                         ref_resp["responses"]):
        solo = port.search(header["index"], body)
        _same_as_solo(_hits(got), _hits(solo))
        assert got["hits"]["total"] == solo["hits"]["total"]
        np.testing.assert_allclose(got["hits"]["max_score"],
                                   solo["hits"]["max_score"], rtol=1e-6)
        _same_as_reference(_hits(got), _hits(want))
        assert got["hits"]["total"] == want["hits"]["total"]


@pytest.mark.parametrize("extra", [{"from": 2, "size": 4},
                                   {"_source": False},
                                   {"track_total_hits": 3}])
def test_batched_paging_and_source_equal_solo(nodes, extra):
    """Bodies of one run asking for different pages and source: the batch
    fetches the run's largest page, each body cuts its own."""
    _ref, port = nodes
    qs = _queries(4, seed=8)
    bodies = [_knn(qs[0], k=6, size=6), {**_knn(qs[1], k=6), **extra},
              _knn(qs[2], k=6, size=2), {**_knn(qs[3], k=6), **extra}]
    before = _counts()
    batched = port.msearch([({"index": "vecs"}, b) for b in bodies])
    assert _counts()[0] - before[0] == 1
    for got, body in zip(batched["responses"], bodies):
        solo = port.search("vecs", body)
        _same_as_solo(_hits(got), _hits(solo))
        assert got["hits"].get("total") == solo["hits"].get("total")
        assert [("_source" in h) for h in got["hits"]["hits"]] == \
            [("_source" in h) for h in solo["hits"]["hits"]]


@pytest.mark.parametrize("odd", ["filter", "k", "field"])
def test_unbatchable_runs_go_one_by_one(nodes, odd):
    """A filter inside one body's knn clause, another k, or another field
    keeps the run on the serial path: one stacked launch a body, none
    batched, every answer the solo one's and the reference's."""
    ref, port = nodes
    qs = _queries(3, seed=9)
    bodies = [_knn(q, k=4, size=4) for q in qs]
    if odd == "filter":
        bodies[1] = _knn(qs[1], k=4, size=4,
                         filter={"range": {"n": {"gte": 20}}})
    elif odd == "k":
        bodies[1] = _knn(qs[1], k=7, size=4)
    else:
        bodies[1] = _knn(qs[1], k=4, size=4, field="w")
    searches = [({"index": "vecs"}, b) for b in bodies]
    assert torch_service.msearch_groups(searches) == [[0, 1, 2]]
    before = _counts()
    resp = port.msearch(searches)
    after = _counts()
    assert after[0] - before[0] == 3
    assert after[1] == before[1]
    ref_resp = ref.msearch(searches)
    for got, body, want in zip(resp["responses"], bodies,
                               ref_resp["responses"]):
        assert _hits(got) == _hits(port.search("vecs", body))
        _same_as_reference(_hits(got), _hits(want))
    if odd == "filter":
        assert all(int(h[0][1:]) >= 20 for h in _hits(resp["responses"][1]))


def test_msearch_mixed_bodies_still_correct(nodes):
    """A batchable run, then a body on a missing index: every slot in
    order, the run batched, the error in its own slot as the reference
    reports it."""
    ref, port = nodes
    q1, q2 = [0.1] * DIMS, [0.9] * DIMS
    searches = [
        ({"index": "vecs"}, _knn(q1, k=3, size=3)),
        ({"index": "vecs"}, _knn(q2, k=3, size=3)),
        ({"index": "missing_idx"}, _knn(q1, k=3, size=3)),
        ({"index": "vecs"}, _knn(q2, k=2, size=2)),
    ]
    before = _counts()
    resp = port.msearch(searches)
    after = _counts()
    assert len(resp["responses"]) == 4
    assert after[0] - before[0] == 2 and after[1] - before[1] == 2
    ref_resp = ref.msearch(searches)
    for i in (0, 1, 3):
        assert resp["responses"][i]["hits"]["hits"]
        _same_as_reference(_hits(resp["responses"][i]),
                           _hits(ref_resp["responses"][i]))
    err, ref_err = resp["responses"][2], ref_resp["responses"][2]
    assert err["status"] == ref_err["status"] == 404
    assert err["error"]["type"] == ref_err["error"]["type"]


@pytest.mark.parametrize("searches", [
    [],
    [({"index": "a"}, {"query": {"knn": {}}})],
    [({"index": "a"}, {"query": {"knn": {}}}),
     ({"index": "a"}, {"query": {"knn": {}}, "size": 3}),
     ({"index": "b"}, {"query": {"knn": {}}}),
     ({"index": "b"}, {"query": {"knn": {}}, "aggs": {}}),
     ({"index": "b"}, {"query": {"match_all": {}}}),
     ({}, {"query": {"knn": {}}}),
     ({}, {"query": {"knn": {}}}),
     ({"index": "b"}, "not a body"),
     ({"index": "b"}, {"query": {"knn": {}}, "version": True}),
     ({"index": "b"}, {"query": {"knn": {}, "bool": {}}})],
])
def test_grouping_rule_is_the_reference(searches):
    assert torch_service.msearch_groups(searches) == \
        jax_service.msearch_groups(searches)
    for _header, body in searches:
        assert torch_service.msearch_knn_batchable(body) == \
            jax_service.msearch_knn_batchable(body)


def test_stacked_step_off_runs_one_by_one(nodes):
    """With the stacked step switched off the run takes the per-shard
    route one body at a time, as the reference's does."""
    _ref, port = nodes
    searches = [({"index": "vecs"}, _knn(q, k=5, size=5))
                for q in _queries(2, seed=10)]
    before = _counts()
    torch_serving.enabled = False
    try:
        resp = port.msearch(searches)
        solo = [port.search("vecs", b) for _h, b in searches]
    finally:
        torch_serving.enabled = True
    assert _counts() == before
    assert [_hits(r) for r in resp["responses"]] == [_hits(s) for s in solo]


def test_body_outside_the_port_raises(nodes):
    _ref, port = nodes
    with pytest.raises(NotImplementedError, match="not yet ported"):
        port.msearch([({"index": "vecs"}, {"query": {"match_all": {}}})])


def test_reference_counts_one_launch_too(nodes):
    """The reference's own contract on the same run, beside the port's."""
    ref, _port = nodes
    searches = [({"index": "vecs"}, _knn(q, k=5, size=5))
                for q in _queries(3, seed=11)]
    before = jax_serving.stats["batched_queries"]
    ref.msearch(searches)
    assert jax_serving.stats["batched_queries"] - before == 3
