"""Rank evaluation: TorchNode against TpuNode.

The cases of tests/test_modules_parity.py's TestRankEval (6) run on a
TpuNode and a TorchNode(device="cpu"), each package calling its own
rank_eval: the responses must be equal (tolerance 0 for ids, ratings and
metric scores; a hit's l2 `_score` to rtol 1e-5 / atol 1e-4, the
tolerance tests/test_torch_node_knn.py states). Then every metric
(precision, recall, mean_reciprocal_rank, dcg plain and normalized,
expected_reciprocal_rank, and an unknown one) over one set of rated
requests, per-request failures, `knn` requests on an exact column (one K1
launch a request) and on an IVF-PQ column (one K2 launch a request),
whose recall against a numpy brute force's top 10 is each search's own,
and the four REST handlers. Data is made from a numpy seed.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.rest import handlers as ref_handlers
from opensearch_tpu.search.rank_eval import rank_eval as ref_rank_eval
from opensearch_tpu_torch.ops import adc_scan, knn_fused
from opensearch_tpu_torch.rest import handlers as port_handlers
from opensearch_tpu_torch.search.rank_eval import rank_eval as port_rank_eval

from test_torch_scroll_pit import Pair, observe

DIM = 8


def _docs_corpus(node) -> None:
    """TestRankEval's corpus."""
    node.create_index("docs", {"mappings": {"properties": {
        "t": {"type": "text"}}}})
    for i, text in enumerate([
        "alpha beta", "alpha gamma", "beta gamma", "delta epsilon",
    ]):
        node.index_doc("docs", str(i), {"t": text})
    node.refresh("docs")


class Both:
    def __init__(self, pair: Pair):
        self.pair = pair

    def call(self, index, body) -> tuple:
        """rank_eval on each node, observed and compared; the port's."""
        return self.pair.flow(lambda n: [observe(lambda: (
            port_rank_eval if n is self.pair.port else ref_rank_eval)(
                n, index, body))])[0]


@pytest.fixture()
def corpus(tmp_path):
    p = Pair(tmp_path)
    for n in p.nodes:
        _docs_corpus(n)
    yield Both(p)
    p.close()


# ---------------------------------------------------------------------------
# tests/test_modules_parity.py: TestRankEval
# ---------------------------------------------------------------------------


class TestRankEval:
    def test_precision_at_k(self, corpus):
        got = corpus.call("docs", {
            "requests": [{
                "id": "q1",
                "request": {"query": {"match": {"t": "alpha"}}},
                "ratings": [
                    {"_index": "docs", "_id": "0", "rating": 1},
                    {"_index": "docs", "_id": "1", "rating": 0},
                ],
            }],
            "metric": {"precision": {"k": 2}},
        })[1]
        # 2 hits (docs 0,1), one rated relevant -> P@2 = 0.5
        assert got["metric_score"] == pytest.approx(0.5)
        assert got["details"]["q1"]["metric_score"] == pytest.approx(0.5)

    def test_mrr(self, corpus):
        got = corpus.call("docs", {
            "requests": [{
                "id": "q",
                "request": {"query": {"match": {"t": "gamma"}}},
                "ratings": [{"_index": "docs", "_id": "2", "rating": 1}],
            }],
            "metric": {"mean_reciprocal_rank": {"k": 5}},
        })[1]
        assert 0 < got["metric_score"] <= 1.0

    def test_dcg_normalized(self, corpus):
        got = corpus.call("docs", {
            "requests": [{
                "id": "q",
                "request": {"query": {"match": {"t": "alpha"}}},
                "ratings": [
                    {"_index": "docs", "_id": "0", "rating": 3},
                    {"_index": "docs", "_id": "1", "rating": 2},
                ],
            }],
            "metric": {"dcg": {"k": 5, "normalize": True}},
        })[1]
        assert 0 < got["metric_score"] <= 1.0

    def test_err(self, corpus):
        got = corpus.call("docs", {
            "requests": [{
                "id": "q",
                "request": {"query": {"match": {"t": "beta"}}},
                "ratings": [{"_index": "docs", "_id": "0", "rating": 3}],
            }],
            "metric": {"expected_reciprocal_rank": {"maximum_relevance": 3}},
        })[1]
        assert got["metric_score"] > 0

    def test_unrated_docs_reported(self, corpus):
        got = corpus.call("docs", {
            "requests": [{
                "id": "q",
                "request": {"query": {"match": {"t": "alpha"}}},
                "ratings": [{"_index": "docs", "_id": "0", "rating": 1}],
            }],
            "metric": {"precision": {"k": 5}},
        })[1]
        unrated = got["details"]["q"]["unrated_docs"]
        assert {u["_id"] for u in unrated} == {"1"}

    def test_requires_requests(self, corpus):
        got = corpus.call("docs", {})
        assert got[:3] == ("error", "IllegalArgumentException", 400)


# ---------------------------------------------------------------------------
# every metric, failures, and kNN requests
# ---------------------------------------------------------------------------

METRICS = [
    {"precision": {"k": 3}},
    {"precision": {"k": 5, "relevant_rating_threshold": 2}},
    {"recall": {"k": 3}},
    {"recall": {"k": 10, "relevant_rating_threshold": 2}},
    {"mean_reciprocal_rank": {"k": 5}},
    {"dcg": {"k": 4}},
    {"dcg": {"k": 4, "normalize": True}},
    {"expected_reciprocal_rank": {"k": 5, "maximum_relevance": 2}},
    {"nope": {}},
    {"precision": {}, "recall": {}},
    None,
]


@pytest.mark.parametrize("metric", METRICS,
                         ids=[next(iter(m or {"default": 0})) + str(i)
                              for i, m in enumerate(METRICS)])
def test_every_metric_is_the_references(corpus, metric):
    body = {"requests": [
        {"id": "alpha", "request": {"query": {"match": {"t": "alpha"}}},
         "ratings": [{"_index": "docs", "_id": "0", "rating": 2},
                     {"_index": "docs", "_id": "1", "rating": 1},
                     {"_index": "docs", "_id": "3", "rating": 3}]},
        {"id": "gamma", "request": {"query": {"match": {"t": "gamma"}},
                                    "size": 1},
         "ratings": [{"_index": "docs", "_id": "2", "rating": 1}]},
        {"request": {"query": {"match_all": {}}},
         "ratings": []},
        {"id": "bad", "request": {"query": {"bogus": {}}},
         "ratings": [{"_index": "docs", "_id": "0", "rating": 1}]},
    ]}
    if metric is not None:
        body["metric"] = metric
    corpus.call("docs", body)


DOC_VECS = 300


def _vectors(n=DOC_VECS, seed=41):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((6, DIM)).astype(np.float32)
    pick = rng.integers(0, 6, n)
    return (centers[pick] + 0.3 * rng.standard_normal((n, DIM))).astype(
        np.float32).round(3)


def _queries(vecs, n=6, seed=43):
    rng = np.random.default_rng(seed)
    return vecs[rng.choice(len(vecs), n, replace=False)] + \
        0.05 * rng.standard_normal((n, DIM)).astype(np.float32)


def _knn(vec, k=10):
    return {"query": {"knn": {"v": {"vector": list(map(float, vec)),
                                    "k": k}}}}


@pytest.fixture()
def knn_pair(tmp_path):
    p = Pair(tmp_path)
    vecs = _vectors()
    for n in p.nodes:
        n.create_index("exact", {"settings": {"number_of_shards": 2},
                                 "mappings": {"properties": {"v": {
                                     "type": "knn_vector", "dimension": DIM,
                                     "space_type": "l2"}}}})
        n.create_index("ann", {"settings": {"number_of_shards": 1},
                               "mappings": {"properties": {"v": {
                                   "type": "knn_vector", "dimension": DIM,
                                   "similarity": "cosine",
                                   "method": {"name": "ivf_pq",
                                              "parameters": {
                                                  "nlist": 4, "m": 4,
                                                  "nprobe": 2,
                                                  "min_train": 64}}}}}})
        for name in ("exact", "ann"):
            n.bulk([("index", {"_index": name, "_id": str(i)},
                     {"v": vecs[i].tolist()}) for i in range(DOC_VECS)],
                   refresh=True)
    b = Both(p)
    b.vecs = vecs
    yield b
    p.close()


def _brute_top(vecs, q, k, similarity):
    if similarity == "l2":
        d = ((vecs.astype(np.float64) - q.astype(np.float64)) ** 2).sum(1)
        return [str(i) for i in np.argsort(d, kind="stable")[:k]]
    vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q)
    return [str(i) for i in np.argsort(-(vn.astype(np.float64) @ qn),
                                       kind="stable")[:k]]


def _rated(index, ids):
    return [{"_index": index, "_id": i, "rating": 1} for i in ids]


@pytest.mark.parametrize("metric", ["precision", "recall"])
def test_exact_knn_requests_score_one_and_launch_k1_each(knn_pair,
                                                         monkeypatch,
                                                         metric):
    """Rated by the brute force's top 10, exact kNN scores 1.0 under
    precision and recall; each request is one K1 launch."""
    qs = _queries(knn_pair.vecs)
    calls = []
    scan = knn_fused.pool_scan
    monkeypatch.setattr(knn_fused, "pool_scan",
                        lambda *a, **k: calls.append(1) or scan(*a, **k))
    body = {"requests": [
        {"id": f"q{i}", "request": _knn(q),
         "ratings": _rated("exact", _brute_top(knn_pair.vecs, q, 10, "l2"))}
        for i, q in enumerate(qs)], "metric": {metric: {"k": 10}}}
    ref = observe(lambda: ref_rank_eval(knn_pair.pair.ref, "exact", body))
    calls.clear()
    port = observe(lambda: port_rank_eval(knn_pair.pair.port, "exact", body))
    assert len(calls) == len(qs)
    knn_pair.pair.flow(lambda n: [ref if n is knn_pair.pair.ref else port])
    got = port[1]
    assert got["metric_score"] == 1.0 and not got["failures"]
    assert {d["metric_score"] for d in got["details"].values()} == {1.0}


def test_ivf_pq_knn_requests_recall_is_each_searches(knn_pair,
                                                     monkeypatch):
    """Under recall, each request's metric_score is its search's recall@10
    against the cosine brute force; each request is one K2 launch."""
    qs = _queries(knn_pair.vecs)
    calls = []
    scan = adc_scan.adc_pool_scan
    monkeypatch.setattr(adc_scan, "adc_pool_scan",
                        lambda *a, **k: calls.append(1) or scan(*a, **k))
    truth = [_brute_top(knn_pair.vecs, q, 10, "cosine") for q in qs]
    body = {"requests": [
        {"id": f"q{i}", "request": _knn(q), "ratings": _rated("ann", t)}
        for i, (q, t) in enumerate(zip(qs, truth))],
        "metric": {"recall": {"k": 10}}}
    port_node = knn_pair.pair.port
    own = [[h["_id"] for h in port_node.search(
        "ann", {**_knn(q), "size": 10})["hits"]["hits"]] for q in qs]
    calls.clear()
    got = knn_pair.call("ann", body)[1]
    assert len(calls) == len(qs)
    for i, ids in enumerate(own):
        assert got["details"][f"q{i}"]["metric_score"] == \
            len(set(ids) & set(truth[i])) / 10
    assert 0 < got["metric_score"] <= 1.0


def test_rank_eval_handlers_are_the_references(knn_pair):
    q = _queries(knn_pair.vecs, 1)[0]
    ratings = _rated("exact", _brute_top(knn_pair.vecs, q, 10, "l2"))
    body = {"requests": [{"id": "q", "request": _knn(q),
                          "ratings": ratings}],
            "metric": {"dcg": {"k": 10, "normalize": True}}}

    def calls(n):
        mod = ref_handlers if n is knn_pair.pair.ref else port_handlers

        def h(name, params, b):
            return observe(lambda: getattr(mod, name)(n, params, {}, b))

        return [h("rank_eval_handler", {"index": "exact"}, body),
                h("rank_eval_handler", {"index": "nope"}, body),
                h("rank_eval_all", {}, body),
                h("rank_eval_all", {}, None)]

    out = knn_pair.pair.flow(calls)
    assert out[0][1][1]["metric_score"] == 1.0
    assert out[3][:3] == ("error", "IllegalArgumentException", 400)
