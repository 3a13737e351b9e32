"""The request cache (index/request_cache.py) on TorchNode against
TpuNode.

The cases of tests/test_request_cache.py: each runs on both nodes over the
same docs and the observations must be equal (tests/test_torch_scroll_pit
.Pair), and the cache's own LRU byte budget on both packages' classes. Then
the port alone: a cache hit equals the miss that filled it as JSON on a
body with float aggregations (avg, stats, percentiles, a histogram over a
float field) beside a kNN, and the hit runs no query phase; the cache is
keyed by the generations of the snapshots acquired first; the
`request_cache` parameter and `index.requests.cache.enable` are honoured;
`_cache/clear` over HTTP.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.index import request_cache as ref_cache
from opensearch_tpu_torch.index import request_cache as port_cache
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.search import distributed_serving

from test_torch_scroll_pit import Pair, observe


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    for n in p.nodes:
        n.create_index("c", {"mappings": {"properties": {
            "tag": {"type": "keyword"}}}})
        n.index_doc("c", "1", {"tag": "a"}, refresh=True)
    yield p
    p.close()


def test_size0_cached_and_invalidated_by_refresh(pair):
    body = {"size": 0, "query": {"term": {"tag": "a"}}}

    def scenario(node):
        r1 = node.search("c", body)
        h0 = node.request_cache.hits
        r2 = node.search("c", body)
        assert node.request_cache.hits == h0 + 1
        # a refresh moves the generation: the stale entry is unreachable
        node.index_doc("c", "2", {"tag": "a"}, refresh=True)
        r3 = node.search("c", body)
        assert r3["hits"]["total"]["value"] == 2
        return [r1, r2, r3]

    pair.flow(scenario)


def test_fetching_requests_not_cached_by_default(pair):
    def scenario(node):
        body = {"query": {"term": {"tag": "a"}}}
        node.search("c", body)
        m0 = node.request_cache.misses
        node.search("c", body)
        assert node.request_cache.misses == m0  # never consulted
        return [node.request_cache.stats()]

    pair.flow(scenario)


def test_explicit_opt_in_and_clear(pair):
    def scenario(node):
        body = {"query": {"term": {"tag": "a"}}}
        node.search("c", body, request_cache=True)
        h0 = node.request_cache.hits
        node.search("c", body, request_cache=True)
        assert node.request_cache.hits == h0 + 1
        cleared = node.request_cache.clear("c")
        assert cleared >= 1
        return [cleared, node.request_cache.stats()]

    pair.flow(scenario)


@pytest.mark.parametrize("mod", [ref_cache, port_cache],
                         ids=["reference", "port"])
def test_byte_budget_evicts_lru(mod):
    cache = mod.RequestCache(max_bytes=100)
    cache.put(("a",), "x" * 40)
    cache.put(("b",), "y" * 40)
    assert cache.stats()["memory_size_in_bytes"] == 80
    cache.get(("a",))                     # a becomes most-recent
    cache.put(("c",), "z" * 40)           # 120 > 100: LRU (b) goes
    st = cache.stats()
    assert st["entries"] == 2 and st["evictions"] == 1
    assert cache.get(("b",)) is None
    assert cache.get(("a",)) == "x" * 40
    assert st["memory_size_in_bytes"] == 80


@pytest.mark.parametrize("mod", [ref_cache, port_cache],
                         ids=["reference", "port"])
def test_oversized_response_never_cached_and_replace_accounts_bytes(mod):
    cache = mod.RequestCache(max_bytes=50)
    cache.put(("big",), "x" * 51)         # larger than the whole budget
    assert cache.stats()["entries"] == 0
    cache.put(("k",), "a" * 10)
    cache.put(("k",), "b" * 30)           # a replacement must not double-count
    assert cache.stats()["memory_size_in_bytes"] == 30


def test_cache_size_setting_shrinks_live_cache(pair):
    def scenario(node):
        body = {"size": 0, "query": {"term": {"tag": "a"}}}
        node.search("c", body)
        assert node.request_cache.stats()["entries"] == 1
        put = node.put_cluster_settings({"persistent": {"indices": {
            "requests": {"cache": {"size": "1b"}}}}})
        assert node.request_cache.max_bytes == 1
        assert node.request_cache.stats()["entries"] == 0
        node.search("c", body)
        node.search("c", body)
        assert node.request_cache.stats()["entries"] == 0
        return [put, node.request_cache.stats()]

    pair.flow(scenario)


def test_cache_size_null_delete_restores_default(pair):
    def scenario(node):
        node.put_cluster_settings({"persistent": {"indices": {
            "requests": {"cache": {"size": "1b"}}}}})
        small = node.request_cache.max_bytes
        node.put_cluster_settings({"persistent": {"indices": {
            "requests": {"cache": {"size": None}}}}})
        return [small, node.request_cache.max_bytes]

    assert pair.flow(scenario) == [1, port_cache.DEFAULT_MAX_BYTES]


def test_cache_size_setting_rejects_garbage(pair):
    got = pair.call("put_cluster_settings", {"persistent": {"indices": {
        "requests": {"cache": {"size": "not-a-size"}}}}})
    assert got[:3] == ("error", "IllegalArgumentException", 400)


# -- the port alone ------------------------------------------------------------

DIM = 6


@pytest.fixture()
def node(tmp_path):
    n = TorchNode(tmp_path, device="cpu")
    rng = np.random.default_rng(5)
    n.create_index("f", {"settings": {"number_of_shards": 2}, "mappings": {
        "properties": {"v": {"type": "knn_vector", "dimension": DIM},
                       "price": {"type": "float"},
                       "color": {"type": "keyword"}}}})
    vecs = rng.standard_normal((80, DIM)).astype(np.float32)
    prices = rng.uniform(0, 100, 80)
    n.bulk([("index", {"_index": "f", "_id": str(i)},
             {"v": vecs[i].tolist(), "price": float(prices[i]),
              "color": ("red", "blue", "green")[i % 3]})
            for i in range(80)], refresh=True)
    n.test_vectors = vecs
    yield n
    n.close()


FLOAT_AGGS = {"avg_price": {"avg": {"field": "price"}},
              "price_stats": {"stats": {"field": "price"}},
              "pct": {"percentiles": {"field": "price",
                                      "percents": [5, 50, 95]}},
              "hist": {"histogram": {"field": "price", "interval": 7.5}},
              "colors": {"terms": {"field": "color"},
                         "aggs": {"max_price": {"max": {"field": "price"}}}}}


def test_hit_equals_its_miss_with_float_aggregations(node, monkeypatch):
    from opensearch_tpu_torch.search import service

    body = {"size": 0, "aggs": FLOAT_AGGS, "query": {"knn": {"v": {
        "vector": node.test_vectors[3].tolist(), "k": 30}}}}
    miss = node.search("f", body)
    calls = []
    real = service.execute_query_phase
    monkeypatch.setattr(service, "execute_query_phase",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    hit = node.search("f", body)
    assert calls == []                    # no query phase ran
    assert node.request_cache.hits == 1
    # the hit is the miss, as JSON: a numpy or torch scalar left in the
    # response would come back from the cache as a string
    assert json.dumps(hit, sort_keys=True) == \
        json.dumps(json.loads(json.dumps(miss)), sort_keys=True)
    assert isinstance(hit["aggregations"]["avg_price"]["value"], float)


def test_cache_is_keyed_by_the_acquired_generations(node):
    body = {"size": 0, "query": {"match_all": {}},
            "aggs": {"n": {"value_count": {"field": "price"}}}}
    first = node.search("f", body)
    node.index_doc("f", "new", {"price": 1.0, "color": "red",
                                "v": [0.0] * DIM})
    # no refresh: the same generations, the cached answer
    assert node.search("f", body) == json.loads(json.dumps(first))
    node.refresh("f")
    after = node.search("f", body)
    assert after["aggregations"]["n"]["value"] == 81
    assert node.request_cache.hits == 1 and node.request_cache.misses == 2


def test_request_cache_param_and_index_setting(node, tmp_path):
    body = {"size": 0, "query": {"match_all": {}}}
    node.search("f", body, request_cache=False)
    assert node.request_cache.stats()["entries"] == 0
    node.create_index("off", {"settings": {
        "index.requests.cache.enable": False}})
    node.index_doc("off", "1", {"price": 2.0}, refresh=True)
    node.search("off", body)
    assert node.request_cache.stats()["entries"] == 0
    # the request's explicit request_cache=true wins over the index
    # setting, as in the reference
    node.search("off", body, request_cache=True)
    assert node.request_cache.stats()["entries"] == 1


def test_knn_hit_runs_no_stacked_launch(node):
    body = {"size": 0, "query": {"knn": {"v": {
        "vector": node.test_vectors[9].tolist(), "k": 5}}},
        "track_total_hits": True}
    first = node.search("f", body, request_cache=True)
    served = distributed_serving.stats["distributed_searches"]
    again = node.search("f", body, request_cache=True)
    assert distributed_serving.stats["distributed_searches"] == served
    assert again == json.loads(json.dumps(first))


def test_cache_clear_over_http(node):
    from opensearch_tpu_torch.rest.http import HttpServer

    from test_torch_rest import Client

    node.search("f", {"size": 0, "query": {"match_all": {}}})
    srv = HttpServer(node, "127.0.0.1", 0)
    srv.start_in_thread()
    try:
        c = Client(srv.port)
        assert c("POST", "/f/_cache/clear") == (200, {
            "_shards": {"total": 1, "successful": 1, "failed": 0},
            "cleared": 1})
        node.search("f", {"size": 0, "query": {"match_all": {}}})
        status, body = c("POST", "/_cache/clear")
        assert status == 200 and body["cleared"] == 1
        assert node.request_cache.stats()["entries"] == 0
    finally:
        srv.stop_thread()


def test_errors_are_not_cached(pair):
    got = pair.call("search", "c", {"size": 0, "query": {"nope": {}}})
    assert got[0] == "error"
    assert pair.port.request_cache.stats()["entries"] == 0
    assert observe(lambda: pair.port.search("c", {"size": 0}))[0] == "ok"
