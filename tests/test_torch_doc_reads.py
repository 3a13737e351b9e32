"""Document reads and query tools on a TorchNode against a TpuNode:
`_mget`, `_explain`, `_field_caps`, `_termvectors`, `_mtermvectors`,
`_validate/query` and `_search_shards`.

The cases of tests/test_fetch_apis.py's TestMget, TestExplain,
TestFieldCaps and TestTermvectors run on a TpuNode and a
TorchNode(device="cpu") over the same library of documents through
:class:`test_torch_scroll_pit.Pair`: each scenario's observations
(results, or an error's class, status and message) must be equal, with
`took`, uuids and the node's ephemeral id left out and floats to the
tolerance tests/test_torch_rest.py states. Then the slice's own cases the
same way: `_mtermvectors`, the `_validate/query`, `_explain` and
`_field_caps` handlers with their query parameters, `_search_shards` with
aliases, routing, preference and slices, a closed index in each, and
`_explain` of a `knn` query (the reference's restricted query phase: a
doc outside the top k does not match). Data is made from a numpy seed.

The port alone: `_explain` of a kNN hit gives the hit's `_score`, and
`_validate/query` and `_search_shards` launch nothing.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu.rest import handlers as ref_handlers
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.ops import knn_fused
from opensearch_tpu_torch.rest import handlers as port_handlers

from test_torch_scroll_pit import Pair, observe

DIM = 8
# the node's ephemeral id is random in both packages
VOLATILE = {"ephemeral_id"}

LIB_DOCS = [
    ("1", "the quick brown fox", "animal", 2001, "quick fox"),
    ("2", "quality quartz quarry", "mineral", 2005, "quality stone"),
    ("3", "quiet quill writing", "craft", 2010, "quill pen"),
]


def _lib(node):
    """tests/test_fetch_apis.py's fixture."""
    node.create_index("lib", {"mappings": {"properties": {
        "title": {"type": "text"},
        "genre": {"type": "keyword"},
        "year": {"type": "long"},
        "sugg": {"type": "completion"},
    }}})
    for _id, title, genre, year, sugg in LIB_DOCS:
        node.index_doc("lib", _id, {"title": title, "genre": genre,
                                    "year": year, "sugg": sugg})
    node.refresh("lib")


def _vecs(n, seed=5):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, DIM)).astype(np.float32).round(3)


def _seed_vecs(node, shards=2, n_docs=40):
    node.create_index("vx", {"settings": {"number_of_shards": shards},
                             "mappings": {"properties": {
                                 "v": {"type": "knn_vector",
                                       "dimension": DIM, "space_type": "l2"},
                                 "title": {"type": "text"},
                                 "tag": {"type": "keyword"}}}})
    vecs = _vecs(n_docs)
    node.bulk([("index", {"_index": "vx", "_id": f"d{i}"},
                {"v": vecs[i].tolist(), "tag": "ab"[i % 2],
                 "title": f"vector doc {i}"}) for i in range(n_docs)],
              refresh=True)
    return vecs


def _knn(vec, k=5):
    return {"knn": {"v": {"vector": list(map(float, vec)), "k": k}}}


def _no_volatile(obj):
    if isinstance(obj, dict):
        return {k: _no_volatile(v) for k, v in obj.items()
                if k not in VOLATILE}
    if isinstance(obj, (list, tuple)):
        return [_no_volatile(v) for v in obj]
    return obj


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    for n in p.nodes:
        _lib(n)
    yield p
    p.close()


def _both_handlers(pair, name, params, query=None, body=None):
    """The same REST handler call on each node, observed and compared."""
    obs = [_no_volatile(observe(lambda n=n, mod=mod: getattr(mod, name)(
        n, params, query or {}, body)))
        for n, mod in ((pair.ref, ref_handlers),
                       (pair.port, port_handlers))]
    pair.flow(lambda n: [obs[0] if n is pair.ref else obs[1]])
    return obs[1]


# ---------------------------------------------------------------------------
# tests/test_fetch_apis.py: TestMget, TestExplain, TestFieldCaps,
# TestTermvectors
# ---------------------------------------------------------------------------


class TestMget:
    def test_ids_form(self, pair):
        obs = pair.call("mget", "lib", {"ids": ["1", "3", "missing"]})
        assert [d.get("found") for d in obs[1]["docs"]] == [True, True,
                                                            False]

    def test_docs_form_cross_index(self, pair):
        def scenario(node):
            node.create_index("other", {})
            node.index_doc("other", "x", {"v": 1})
            return [node.mget(None, {"docs": [
                {"_index": "lib", "_id": "2"},
                {"_index": "other", "_id": "x"},
                {"_index": "nope", "_id": "y"},
            ]})]
        obs = pair.flow(scenario)
        assert obs[0]["docs"][2]["error"]["type"] == \
            "index_not_found_exception"

    def test_source_filtering(self, pair):
        obs = pair.call("mget", "lib", {"docs": [
            {"_id": "1", "_source": ["genre"]},
            {"_id": "2", "_source": False},
            {"_id": "3", "stored_fields": ["genre", "year"]}]})
        assert obs[1]["docs"][0]["_source"] == {"genre": "animal"}

    def test_requires_body(self, pair):
        for body in ({}, {"docs": []}, {"docs": "x"}, {"ids": "1"},
                     {"docs": [{"_index": "lib"}, {"_id": "1"}]}):
            pair.call("mget", "lib", body)
        pair.call("mget", None, {"ids": ["1"]})


class TestExplain:
    def test_matching(self, pair):
        obs = pair.call("explain", "lib", "1",
                        {"query": {"match": {"title": "fox"}}})
        assert obs[1]["matched"] is True

    def test_not_matching(self, pair):
        obs = pair.call("explain", "lib", "2",
                        {"query": {"match": {"title": "fox"}}})
        assert obs[1]["matched"] is False

    def test_missing_doc(self, pair):
        assert pair.call("explain", "lib", "999",
                         {"query": {"match_all": {}}})[1] == \
            "DocumentMissingException"

    def test_body_without_query(self, pair):
        pair.call("explain", "lib", "1", {"size": 3})


class TestFieldCaps:
    def test_wildcard(self, pair):
        obs = pair.call("field_caps", "lib", "t*,year")
        assert obs[1]["fields"]["title"]["text"]["searchable"] is True

    def test_conflicting_types_across_indices(self, pair):
        def scenario(node):
            node.create_index("conf", {"mappings": {"properties": {
                "year": {"type": "keyword", "meta": {"unit": "y"}}}}})
            return [node.field_caps("lib,conf", "year"),
                    node.field_caps("lib,conf", "*", include_unmapped=True),
                    node.field_caps(None, "ye*", index_filter={
                        "term": {"genre": "animal"}})]
        obs = pair.flow(scenario)
        assert set(obs[0]["fields"]["year"]) == {"long", "keyword"}

    def test_requires_fields(self, pair):
        assert pair.call("field_caps", "lib", "")[1] == \
            "IllegalArgumentException"


class TestTermvectors:
    def test_basic(self, pair):
        obs = pair.call("termvectors", "lib", "1")
        assert obs[1]["term_vectors"]["title"]["terms"]["quick"][
            "term_freq"] == 1

    def test_term_statistics(self, pair):
        pair.call("termvectors", "lib", "1", {"term_statistics": True,
                                              "offsets": False})

    def test_missing(self, pair):
        assert pair.call("termvectors", "lib", "999")[1]["found"] is False

    def test_field_filter(self, pair):
        assert pair.call("termvectors", "lib", "1",
                         fields="nope")[1]["term_vectors"] == {}


# ---------------------------------------------------------------------------
# the slice's own cases
# ---------------------------------------------------------------------------


def test_mtermvectors(pair):
    for body, kwargs in [
            ({"docs": [{"_index": "lib", "_id": "1"},
                       {"_index": "lib", "_id": "2",
                        "term_statistics": True, "fields": ["title"]}]}, {}),
            ({"ids": ["1", "3"]}, {"index": "lib"}),
            ({}, {"index": "lib", "ids": "2,9", "term_statistics": True}),
            ({"docs": [{"_id": "1"}]}, {}),
            ({"docs": [{"_index": "lib", "_id": "1", "termStatistics": 1}]},
             {}),
            ({"docs": "x"}, {})]:
        pair.call("mtermvectors", body, **kwargs)


def test_closed_index_in_each_read(pair):
    def scenario(node):
        node.create_index("shut", {})
        node.index_doc("shut", "1", {"a": 1}, refresh=True)
        node.close_index("shut")
        return [node.mget(None, {"docs": [{"_index": "shut", "_id": "1"},
                                          {"_index": "lib", "_id": "1"}]}),
                observe(lambda: node.explain("shut", "1", {
                    "query": {"match_all": {}}})),
                observe(lambda: node.termvectors("shut", "1")),
                node.field_caps(None, "*"),
                _no_volatile(node.search_shards("*")),
                _no_volatile(node.search_shards("shut"))]
    pair.flow(scenario)


@pytest.mark.parametrize("query,body", [
    ({}, {"query": {"match": {"title": "fox"}}}),
    ({"_source": "false"}, {"query": {"match_all": {}}}),
    ({"_source": "genre"}, {"query": {"match_all": {}}}),
    ({"_source_includes": "ti*", "_source_excludes": "x"},
     {"query": {"term": {"genre": "animal"}}}),
    ({"q": "title:fox"}, None),
    ({}, {"query": {"bogus": {}}}),
    ({"lenient": "true"}, {"query": {"bogus": {}}}),
], ids=["match", "no_source", "source_list", "includes", "q", "bad_query",
        "lenient"])
def test_explain_route(pair, query, body):
    _both_handlers(pair, "explain_doc", {"index": "lib", "id": "1"}, query,
                   body)


@pytest.mark.parametrize("params,query,body", [
    ({}, {}, {"query": {"match": {"title": "fox"}}}),
    ({"index": "lib"}, {"explain": "true"},
     {"query": {"match": {"title": "fox"}}}),
    ({"index": "lib"}, {"explain": "true"}, {"query": {"match_all": {}}}),
    ({}, {"explain": "true"}, {"query": {"bogus": {}}}),
    ({}, {}, {"query": {"bogus": {}}}),
    ({}, {"explain": "true"}, {"size": 3}),
    ({"index": "lib"}, {"q": "title:fox", "explain": "true"}, None),
    ({"index": "lib"}, {"explain": "true"},
     {"query": _knn([0.1] * DIM)}),
], ids=["plain", "explain", "match_all", "bad_explain", "bad", "no_query",
        "q", "knn"])
def test_validate_query_route(pair, params, query, body):
    _both_handlers(pair, "validate_query", params, query, body)


@pytest.mark.parametrize("name,params,query,body", [
    ("field_caps", {"index": "lib"}, {"fields": "*"}, None),
    ("field_caps", {"index": "lib"}, {}, {"fields": ["ti*", "genre"]}),
    ("field_caps_all", {}, {"fields": "year", "include_unmapped": "true"},
     None),
    ("field_caps_all", {}, {"fields": "*"},
     {"index_filter": {"range": {"year": {"gte": 2009}}}}),
    ("termvectors", {"index": "lib", "id": "2"},
     {"term_statistics": "true", "positions": "false"}, None),
    ("termvectors", {"index": "lib", "id": "3"},
     {"fields": "title", "realtime": "false"}, None),
    ("mtermvectors", {"index": "lib"}, {"ids": "1,2"}, None),
    ("mtermvectors", {}, {}, {"docs": [{"_index": "lib", "_id": "3"}]}),
    ("mget", {"index": "lib"}, {"stored_fields": "genre"},
     {"ids": ["1", "2"]}),
    ("mget", {"index": "lib"}, {}, {"docs": [{"_id": "1", "_type": "x"}]}),
    ("mget_all", {}, {"refresh": "true"},
     {"docs": [{"_index": "lib", "_id": "3"}]}),
], ids=["caps_index", "caps_body", "caps_all_unmapped", "caps_filter",
        "tv_stats", "tv_fields", "mtv_ids", "mtv_docs", "mget_stored",
        "mget_type", "mget_all"])
def test_read_routes(pair, name, params, query, body):
    _both_handlers(pair, name, params, query, body)


def test_search_shards(pair):
    def scenario(node):
        _seed_vecs(node, shards=3)
        node.put_alias("vx", "reds", {"filter": {"term": {"tag": "a"}}})
        node.put_alias("lib", "reds", {"filter": {"term": {"genre": "x"}}})
        node.put_alias("vx", "blues", {"filter": {"term": {"tag": "b"}}})
        return [_no_volatile(x) for x in (
            node.search_shards("vx"),
            node.search_shards(None),
            node.search_shards("reds"),
            node.search_shards("reds,blues"),
            node.search_shards("r*"),
            node.search_shards("vx", routing="d4"),
            node.search_shards("vx", preference="_shards:0,2"),
            node.search_shards("vx", body={"slice": {"id": 1, "max": 2}}),
            node.search_shards("vx", preference="_shards:0,2",
                               body={"slice": {"id": 0, "max": 2}}))] + [
            observe(lambda: node.search_shards("nope"))]
    pair.flow(scenario)
    for params, query in [({"index": "lib"}, {}), ({}, {"index": "lib"}),
                          ({"index": "lib"}, {"routing": "1"})]:
        _both_handlers(pair, "search_shards_handler", params, query)


def test_explain_of_a_knn_query(pair):
    """The reference's restricted query phase, bool(must=[knn],
    filter=[ids]): each of the top k matches with its search score; a doc
    outside the top k does not match."""
    def scenario(node):
        vecs = _seed_vecs(node)
        out = []
        for i in (0, 11, 27):
            q = {"query": _knn(vecs[i], k=3)}
            hits = node.search("vx", {**q, "size": 3})["hits"]["hits"]
            out.append([(h["_id"], h["_score"]) for h in hits])
            for h in hits:
                out.append(node.explain("vx", h["_id"], q))
            far = max(range(40), key=lambda j: float(
                np.sum((vecs[j] - vecs[i]) ** 2)))
            out.append(node.explain("vx", f"d{far}", q))
        return out
    obs = pair.flow(scenario)
    assert obs[1]["matched"] and not obs[4]["matched"]


def test_explain_value_is_the_search_score_and_tools_launch_nothing(
        tmp_path, monkeypatch):
    node = TorchNode(tmp_path / "n", device="cpu")
    vecs = _seed_vecs(node, shards=1)
    calls = []
    scan = knn_fused.pool_scan
    monkeypatch.setattr(knn_fused, "pool_scan",
                        lambda *a, **k: calls.append(1) or scan(*a, **k))
    for i in (2, 19):
        q = {"query": _knn(vecs[i], k=4)}
        hit = node.search("vx", {**q, "size": 4})["hits"]["hits"][0]
        n0 = len(calls)
        ex = node.explain("vx", hit["_id"], q)
        # one launch: the knn's query phase on the doc's shard
        assert len(calls) == n0 + 1
        assert ex["matched"] and ex["explanation"]["value"] == hit["_score"]
    n0 = len(calls)
    port_handlers.validate_query(node, {"index": "vx"}, {"explain": "true"},
                                 {"query": _knn(vecs[0])})
    node.search_shards("vx")
    node.analyze("vx", {"field": "title", "text": "vector doc"})
    assert len(calls) == n0
    node.close()


def test_reads_over_the_ports_http_server(tmp_path):
    """One route of each group over the port's HTTP server, each equal to
    the library call."""
    import http.client
    import json

    from opensearch_tpu_torch.rest.http import HttpServer

    node = TorchNode(tmp_path / "h", device="cpu")
    _lib(node)
    srv = HttpServer(node, "127.0.0.1", 0)
    srv.start_in_thread()
    try:
        def call(method, path, body=None):
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=60)
            conn.request(method, path,
                         body=json.dumps(body) if body is not None else None,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            out = resp.status, json.loads(resp.read())
            conn.close()
            return out
        assert call("POST", "/lib/_mget", {"ids": ["1", "2"]}) == (
            200, node.mget("lib", {"ids": ["1", "2"]}))
        status, ex = call("POST", "/lib/_explain/1",
                          {"query": {"match": {"title": "fox"}}})
        assert status == 200 and ex == node.explain(
            "lib", "1", {"query": {"match": {"title": "fox"}}})
        assert call("GET", "/lib/_field_caps?fields=t*") == (
            200, node.field_caps("lib", "t*"))
        status, tv = call("GET", "/lib/_termvectors/1")
        assert status == 200 and tv["term_vectors"] == \
            node.termvectors("lib", "1")["term_vectors"]
        status, val = call("POST", "/lib/_validate/query?explain=true",
                           {"query": {"match_all": {}}})
        assert status == 200 and val["valid"] is True
        status, ss = call("GET", "/lib/_search_shards")
        assert status == 200 and len(ss["shards"]) == 1
        status, an = call("POST", "/_analyze", {"text": "Quick Fox"})
        assert an == node.analyze(None, {"text": "Quick Fox"})
        assert call("POST", "/lib/_close")[0] == 200
        status, err = call("POST", "/lib/_search", {})
        assert status == 400 and err["error"]["type"] == \
            "index_closed_exception"
        assert call("POST", "/lib/_open")[0] == 200
    finally:
        srv.stop_thread()
        node.close()


def test_ports_restart_keeps_reads(tmp_path):
    """A restarted node answers the reads as before (the registry reopens
    every index)."""
    p = Pair(tmp_path)
    for n in p.nodes:
        _lib(n)
        n.flush("lib")
    p.close()
    p2 = Pair(tmp_path, TpuNode(tmp_path / "ref"),
              TorchNode(tmp_path / "port", device="cpu"))
    p2.flow(lambda n: [n.mget("lib", {"ids": ["1", "2"]}),
                       n.termvectors("lib", "2"),
                       n.field_caps("lib", "*")])
    p2.close()
