"""Index management on a TorchNode against a TpuNode: mappings, settings,
blocks, close / open, rollover, resize, `_upgrade` and `_analyze`.

The cases of tests/test_metadata_apis.py's TestRollover, TestOpenClose
(with test_closed_survives_restart) and TestAnalyze run on a TpuNode and a
TorchNode(device="cpu") through :class:`test_torch_scroll_pit.Pair`: each
scenario's observations (results, or an error's class, status and message)
must be equal, with `took`, uuids, creation dates and context ids left
out and floats to the tolerance tests/test_torch_rest.py states. Then the
slice's own cases the same way: mapping updates (a new keyword field, a
new `knn_vector` whose kNN sees only the documents written after it, a
type change refused; a `dimension` change is taken, as the reference
takes it), settings updates (replicas, `number_of_shards` refused, a
`default_pipeline` that the next write runs, the slow log, the result
window and the other search limits a search is held to), `_block`
(a write refused with the reference's block error, reads and kNN still
served, the block lifted by `_settings`), `_shrink` / `_split` / `_clone`
with a kNN on the target and every refusal the reference makes,
`_upgrade`, and the REST handlers of `_mapping/field`. Data is made from a
numpy seed.

The port alone: a closed index keeps its device columns (the close's
flush moves the reader generation, so the first kNN after `_open` builds
the stacked step's bundle once), a search on it raises before any launch,
and a kNN on a field added by `PUT _mapping` never returns a
document of a segment sealed before the update.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.rest import handlers as ref_handlers
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.ops import knn_fused
from opensearch_tpu_torch.rest import handlers as port_handlers
from opensearch_tpu_torch.search import distributed_serving

from test_torch_scroll_pit import Pair, observe

DIM = 8


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def _seed(node, name, docs=None, **create_kw):
    """tests/test_metadata_apis.py's _seed."""
    node.create_index(name, {
        "mappings": {"properties": {
            "tag": {"type": "keyword"}, "n": {"type": "long"}}},
        **create_kw,
    })
    for i, d in enumerate(docs or []):
        node.index_doc(name, str(i), d)
    node.refresh(name)


def _vectors(n, seed=3, dim=DIM):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, dim)).astype(np.float32).round(3)


VEC_MAPPING = {"properties": {
    "v": {"type": "knn_vector", "dimension": DIM, "space_type": "l2"},
    "tag": {"type": "keyword"}, "n": {"type": "long"},
    "title": {"type": "text"}}}


def _seed_vecs(node, name="vx", n_docs=40, shards=2, seed=3):
    node.create_index(name, {"settings": {"number_of_shards": shards},
                             "mappings": VEC_MAPPING})
    vecs = _vectors(n_docs, seed)
    node.bulk([("index", {"_index": name, "_id": f"d{i}"},
                {"v": vecs[i].tolist(), "tag": "ab"[i % 2], "n": i,
                 "title": f"doc {i} of {name}"}) for i in range(n_docs)],
              refresh=True)
    return vecs


def _knn(vec, k=5, field="v", size=None):
    return {"query": {"knn": {field: {"vector": list(map(float, vec)),
                                      "k": k}}},
            "size": k if size is None else size}


def _ids(resp):
    return [h["_id"] for h in resp["hits"]["hits"]]


def _handler(mod, node, name, params, query=None, body=None):
    """A REST handler of either package, observed: (status, payload) or
    the error's observation."""
    return observe(lambda: getattr(mod, name)(node, params, query or {},
                                              body))


def _both_handlers(pair, name, params, query=None, body=None):
    ref = _handler(ref_handlers, pair.ref, name, params, query, body)
    port = _handler(port_handlers, pair.port, name, params, query, body)
    pair.flow(lambda n: [ref if n is pair.ref else port])
    return port


# ---------------------------------------------------------------------------
# tests/test_metadata_apis.py: TestRollover, TestOpenClose, TestAnalyze
# ---------------------------------------------------------------------------


class TestRollover:
    def test_rollover_unconditional(self, pair):
        def scenario(node):
            _seed(node, "roll-000001", [{"n": 1}])
            node.put_alias("roll-000001", "roll", {"is_write_index": True})
            res = node.rollover("roll")
            node.index_doc("roll", "new", {"n": 2})
            node.refresh("_all")
            return [res, node.get_doc("roll-000002", "new"),
                    node.search("roll", {"query": {"match_all": {}}}),
                    node.get_alias(None, "roll")]
        obs = pair.flow(scenario)
        assert obs[0]["rolled_over"] and obs[0]["new_index"] == "roll-000002"
        assert obs[2]["hits"]["total"]["value"] == 2

    def test_conditions_not_met(self, pair):
        def scenario(node):
            _seed(node, "c-000001", [{"n": 1}])
            node.put_alias("c-000001", "c")
            return [node.rollover("c", {"conditions": {"max_docs": 100}}),
                    "c-000002" in node.indices]
        obs = pair.flow(scenario)
        assert not obs[0]["rolled_over"] and obs[1] is False

    def test_conditions_met(self, pair):
        def scenario(node):
            _seed(node, "d-000001", [{"n": i} for i in range(5)])
            node.put_alias("d-000001", "d")
            return [node.rollover("d", {"conditions": {
                "max_docs": 3, "max_age": "30d"}}),
                node.get_alias("d-*")]
        assert pair.flow(scenario)[0]["rolled_over"]

    def test_dry_run(self, pair):
        def scenario(node):
            _seed(node, "e-000001", [{"n": 1}])
            node.put_alias("e-000001", "e")
            return [node.rollover("e", {"dry_run": True}),
                    "e-000002" in node.indices]
        obs = pair.flow(scenario)
        assert obs[0]["dry_run"] and not obs[0]["rolled_over"]

    def test_non_alias_rejected(self, pair):
        def scenario(node):
            _seed(node, "plain-1")
            return [observe(lambda: node.rollover("plain-1")),
                    observe(lambda: node.rollover("nope"))]
        assert pair.flow(scenario)[0][1] == "IllegalArgumentException"

    def test_named_and_no_number(self, pair):
        def scenario(node):
            _seed(node, "logs-a", [{"n": 1}])
            node.put_alias("logs-a", "la")
            return [observe(lambda: node.rollover("la")),
                    node.rollover("la", {"new_index": "logs-b",
                                         "settings": {"number_of_shards": 2}}),
                    node.get_settings("logs-b", name="index.number_of_shards"),
                    node.get_alias(None, "la")]
        obs = pair.flow(scenario)
        assert obs[0][0] == "error" and obs[1]["new_index"] == "logs-b"


class TestOpenClose:
    def test_closed_index_rejects_ops(self, pair):
        def scenario(node):
            _seed(node, "cl", [{"n": 1}])
            out = [node.close_index("cl")]
            for fn in (lambda: node.search("cl", {"query": {"match_all": {}}}),
                       lambda: node.index_doc("cl", "2", {"n": 2}),
                       lambda: node.get_doc("cl", "0"),
                       lambda: node.delete_doc("cl", "0"),
                       lambda: node.count("cl"),
                       lambda: node.mget("cl", {"ids": ["0"]}),
                       lambda: node.bulk([("index", {"_index": "cl",
                                                     "_id": "9"},
                                           {"n": 9})])):
                out.append(observe(fn))
            out.append(node.open_index("cl"))
            out.append(node.search("cl", {"query": {"match_all": {}}}))
            return out
        obs = pair.flow(scenario)
        assert obs[1][1] == "IndexClosedException"
        assert obs[-1]["hits"]["total"]["value"] == 1

    def test_wildcard_search_skips_closed(self, pair):
        def scenario(node):
            _seed(node, "sk-1", [{"n": 1}])
            _seed(node, "sk-2", [{"n": 2}])
            node.close_index("sk-2")
            res = node.search("sk-*", {"query": {"match_all": {}}})
            return [{h["_index"] for h in res["hits"]["hits"]},
                    node.resolve_indices("sk-*"),
                    node.resolve_indices("sk-*", expand_wildcards="closed"),
                    node.resolve_indices("sk-*", expand_wildcards="all"),
                    node.resolve_indices("_all", expand_wildcards="closed"),
                    node.resolve_indices("sk-2"),
                    node.get_alias(),
                    node.get_alias(None, None, expand_wildcards="open"),
                    observe(lambda: node.refresh("sk-2"))]
        obs = pair.flow(scenario)
        assert obs[0] == {"sk-1"} and obs[2] == ["sk-2"]

    def test_closed_survives_restart(self, tmp_path):
        from opensearch_tpu.node import TpuNode

        p = Pair(tmp_path)
        for n in p.nodes:
            n.create_index("z", {})
            n.close_index("z")
        p.close()
        p2 = Pair(tmp_path, TpuNode(tmp_path / "ref"),
                  TorchNode(tmp_path / "port", device="cpu"))
        obs = p2.flow(lambda n: [n.indices["z"].closed,
                                 observe(lambda: n.get_doc("z", "1")),
                                 n.open_index("z"),
                                 n.indices["z"].closed])
        assert obs[0] is True and obs[3] is False
        p2.close()

    def test_close_flushes_and_reopen_serves_knn(self, pair):
        def scenario(node):
            vecs = _seed_vecs(node)
            node.index_doc("vx", "late", {"v": vecs[3].tolist(), "n": 99})
            before = node.search("vx", _knn(vecs[3]))
            out = [node.close_index("vx"),
                   observe(lambda: node.search("vx", _knn(vecs[3]))),
                   node.open_index("vx")]
            after = node.search("vx", _knn(vecs[3]))
            return out + [_ids(before), _ids(after),
                          after["hits"]["total"]]
        obs = pair.flow(scenario)
        assert obs[1][1] == "IndexClosedException"
        # the close's flush refreshed: the unrefreshed write shows after
        assert "late" not in obs[3] and obs[4][0] == "late"


class TestAnalyze:
    def test_global_standard(self, pair):
        obs = pair.call("analyze", None, {"text": "The QUICK brown-Fox"})
        assert [t["token"] for t in obs[1]["tokens"]] == [
            "the", "quick", "brown", "fox"]

    def test_field_analyzer(self, pair):
        def scenario(node):
            node.create_index("an", {"mappings": {"properties": {
                "t": {"type": "text"}, "k": {"type": "keyword"}}}})
            return [node.analyze("an", {"field": "t", "text": "Hello World"}),
                    node.analyze("an", {"field": "k", "text": "Hello World"})]
        obs = pair.flow(scenario)
        assert [t["token"] for t in obs[1]["tokens"]] == ["Hello World"]

    def test_text_array_position_gap(self, pair):
        obs = pair.call("analyze", None, {"text": ["one two", "three"]})
        assert obs[1]["tokens"][2]["position"] > 100

    def test_missing_text_rejected(self, pair):
        assert pair.call("analyze", None, {})[1] == \
            "IllegalArgumentException"

    @pytest.mark.parametrize("body", [
        {"text": "The Quick fox", "explain": True},
        {"text": "The Quick fox", "analyzer": "whitespace"},
        {"text": "a the quick quick fox", "tokenizer": "standard",
         "filter": ["lowercase", "stop", "unique"], "explain": True},
        {"text": "Quick fox", "tokenizer": "whitespace",
         "filter": [{"type": "lowercase"}], "explain": True},
        {"text": "x", "tokenizer": "nope"},
        {"text": "x", "filter": [{"stopwords": ["x"]}]},
    ], ids=["explain", "whitespace", "custom_chain", "anonymous_filter",
            "unknown_tokenizer", "filter_without_type"])
    def test_analyze_bodies(self, pair, body):
        pair.call("analyze", None, body)

    def test_index_analyzer_and_token_limit(self, pair):
        def scenario(node):
            node.create_index("al", {"settings": {
                "analyze": {"max_token_count": 3},
                "analysis": {"analyzer": {"my": {
                    "type": "custom", "tokenizer": "whitespace",
                    "filter": ["lowercase"]}}}},
                "mappings": {"properties": {
                    "t": {"type": "text", "analyzer": "my"}}}})
            return [node.analyze("al", {"analyzer": "my", "text": "A B"}),
                    node.analyze("al", {"field": "t", "text": "Foo-Bar"}),
                    observe(lambda: node.analyze(
                        "al", {"text": "one two three four"})),
                    observe(lambda: node.analyze("missing", {"text": "x"}))]
        obs = pair.flow(scenario)
        assert obs[2][1] == "IllegalArgumentException"


# ---------------------------------------------------------------------------
# mapping updates
# ---------------------------------------------------------------------------


def test_put_mapping_adds_fields_open_and_closed(pair):
    def scenario(node):
        _seed(node, "m1", [{"n": 1}])
        _seed(node, "m2", [{"n": 2}])
        node.close_index("m2")
        out = [node.put_mapping("m*", {"properties": {
            "color": {"type": "keyword"},
            "obj": {"properties": {"a": {"type": "long"}}}}}),
            node.get_mapping("m1"),
            node.get_mapping("m2")]
        node.index_doc("m1", "c", {"color": "red", "obj": {"a": 4}},
                       refresh=True)
        out.append(node.search("m1", {"query": {"term": {"color": "red"}}}))
        out.append(observe(lambda: node.put_mapping(
            "m1", {"properties": {"color": {"type": "long"}}})))
        out.append(observe(lambda: node.put_mapping(
            "nope", {"properties": {"x": {"type": "long"}}})))
        out.append(observe(lambda: node.put_mapping(
            "m1", {"properties": {"x": {}}})))
        return out
    obs = pair.flow(scenario)
    assert obs[3]["hits"]["total"]["value"] == 1
    assert obs[4][1] == "IllegalArgumentException"


def test_put_mapping_new_knn_vector_sees_only_later_docs(pair):
    """`v2` added by PUT _mapping: the docs written before it have no
    column for it, so the kNN on `v2` returns only the docs that carry it;
    the kNN on `v` answers as before the update."""
    new = _vectors(12, seed=9, dim=4)

    def scenario(node):
        vecs = _seed_vecs(node)
        q = vecs[5]
        before = node.search("vx", _knn(q, k=10))
        out = [node.put_mapping("vx", {"properties": {"v2": {
            "type": "knn_vector", "dimension": 4, "space_type": "l2"}}}),
            node.get_mapping("vx")]
        node.bulk([("index", {"_index": "vx", "_id": f"w{i}"},
                    {"v2": new[i].tolist()}) for i in range(12)],
                  refresh=True)
        got = node.search("vx", _knn(new[0], k=5, field="v2"))
        wide = node.search("vx", _knn(new[0], k=30, field="v2", size=30))
        after = node.search("vx", _knn(q, k=10))
        return out + [got, wide, before, after]
    obs = pair.flow(scenario)
    got, wide, before, after = obs[2:]
    assert _ids(got)[0] == "w0"
    assert sorted(_ids(wide)) == sorted(f"w{i}" for i in range(12))
    assert _ids(before) == _ids(after)
    assert [h["_score"] for h in before["hits"]["hits"]] == \
        [h["_score"] for h in after["hits"]["hits"]]


def test_put_mapping_changes_a_knn_vector_as_the_reference(pair):
    """The reference's mapper merge replaces a `knn_vector`'s dimension and
    space type (OpenSearch would refuse: ROADMAP's Differences met); a
    change of type is refused."""
    def scenario(node):
        node.create_index("kv", {"mappings": {"properties": {
            "v": {"type": "knn_vector", "dimension": 3}}}})
        return [observe(lambda: node.put_mapping("kv", {"properties": {
                    "v": {"type": "knn_vector", "dimension": 4}}})),
                observe(lambda: node.put_mapping("kv", {"properties": {
                    "v": {"type": "knn_vector", "dimension": 3,
                          "space_type": "innerproduct"}}})),
                observe(lambda: node.put_mapping("kv", {"properties": {
                    "v": {"type": "keyword"}}})),
                node.get_mapping("kv")]
    obs = pair.flow(scenario)
    assert obs[2][1] == "IllegalArgumentException"


def test_new_knn_field_is_its_own_bundle(tmp_path):
    """The stacked step's bundle for `v` is not rebuilt by a mapping change
    to `v2` (no refresh), and `v2` gets its own bundle."""
    node = TorchNode(tmp_path / "n", device="cpu")
    vecs = _seed_vecs(node)
    distributed_serving.registry.reset_stats()
    node.search("vx", _knn(vecs[0]))
    builds = distributed_serving.registry.snapshot_stats()["builds"]
    node.put_mapping("vx", {"properties": {"v2": {
        "type": "knn_vector", "dimension": DIM}}})
    node.search("vx", _knn(vecs[1]))
    assert distributed_serving.registry.snapshot_stats()["builds"] == builds
    node.bulk([("index", {"_index": "vx", "_id": "w"},
                {"v2": vecs[2].tolist()})], refresh=True)
    got = node.search("vx", _knn(vecs[2], k=3, field="v2"))
    assert _ids(got) == ["w"]
    assert distributed_serving.registry.snapshot_stats()["builds"] > builds
    node.close()


def test_field_mapping_routes(pair):
    for n in pair.nodes:
        n.create_index("fm", {"mappings": {"properties": {
            "title": {"type": "text", "fields": {"raw": {"type": "keyword"}}},
            "obj": {"properties": {"a": {"type": "long"}}},
            "v": {"type": "knn_vector", "dimension": 3}}}})
    for params, query in [
            ({"fields": "title"}, {}),
            ({"index": "fm", "fields": "t*,obj.a"}, {}),
            ({"index": "fm", "fields": "title"}, {"include_defaults": "true"}),
            ({"fields": "v"}, {}),
            ({"index": "missing", "fields": "x"}, {})]:
        _both_handlers(pair, "get_field_mapping", params, query)


# ---------------------------------------------------------------------------
# settings updates and blocks
# ---------------------------------------------------------------------------


def test_put_index_settings(pair):
    def scenario(node):
        _seed(node, "s1", [{"n": 1}])
        _seed(node, "s2", [{"n": 2}])
        out = [node.put_index_settings("s1", {"index": {
            "number_of_replicas": 0, "refresh_interval": "5s"}}),
            node.get_settings("s1", flat=True),
            node.cluster_health("s1"),
            observe(lambda: node.put_index_settings(
                "s1", {"number_of_shards": 3})),
            node.put_index_settings("s*", {"settings": {
                "index.requests.cache.enable": False,
                "index.max_result_window": 5}}),
            node.get_settings("s2", name="index.requests.*"),
            node.search("s2", {"size": 0, "query": {"match_all": {}}}),
            node.request_cache.stats(),
            observe(lambda: node.search("s2", {
                "size": 4, "from": 2, "query": {"match_all": {}}})),
            observe(lambda: node.search("s2", {"size": 5}))]
        return out
    obs = pair.flow(scenario)
    assert obs[3][1] == "IllegalArgumentException"


def test_settings_update_reaches_the_pipelines_and_slowlog(pair):
    def scenario(node):
        _seed(node, "p1")
        node.ingest.put_pipeline("tagger", {"processors": [
            {"set": {"field": "tag", "value": "piped"}}]})
        node.index_doc("p1", "a", {"n": 1})
        out = [node.put_index_settings("p1", {"index.default_pipeline":
                                              "tagger"})]
        node.index_doc("p1", "b", {"n": 2})
        out.append(node.get_doc("p1", "a")["_source"])
        out.append(node.get_doc("p1", "b")["_source"])
        node.put_index_settings("p1", {"index": {
            "default_pipeline": "_none",
            "search": {"slowlog": {"threshold": {"query": {
                "warn": "0ms"}}}}}})
        node.index_doc("p1", "c", {"n": 3})
        out.append(node.get_doc("p1", "c")["_source"])
        out.append(node.search_slowlog.thresholds["warn"])
        return out
    obs = pair.flow(scenario)
    assert obs[2] == {"n": 2, "tag": "piped"} and obs[3] == {"n": 3}
    assert obs[4] == 0


@pytest.mark.parametrize("body,scroll", [
    ({"from": -1}, None), ({"size": -2}, None), ({"size": 2**31}, None),
    ({"size": 10, "from": 9995}, None), ({"size": 10001}, "1m"),
    ({"rescore": {"window_size": 20000, "query": {
        "rescore_query": {"match_all": {}}}}}, None),
    ({"docvalue_fields": [f"f{i}" for i in range(101)]}, None),
    ({"script_fields": {f"s{i}": {"script": "1"} for i in range(33)}}, None),
    ({"collapse": {"field": "tag"}, "rescore": {"query": {
        "rescore_query": {"match_all": {}}}}}, None),
    ({"collapse": {"field": "tag"}}, "1m"),
    ({"collapse": {"field": "tag"}, "sort": ["n"], "search_after": [1]},
     None),
], ids=["from", "size", "size_int", "window", "scroll_batch", "rescore",
        "docvalue", "script_fields", "collapse_rescore", "collapse_scroll",
        "collapse_search_after"])
def test_search_request_limits_are_the_references(pair, body, scroll):
    """The index-level limits a search is held to (result and rescore
    windows, field caps, collapse rules), read through the settings a
    `PUT _settings` may change."""
    def scenario(node):
        _seed(node, "lim", [{"n": i, "tag": "ab"[i % 2]} for i in range(4)])
        return [observe(lambda: node.search("lim", dict(body),
                                            scroll=scroll))]
    pair.flow(scenario)


@pytest.mark.parametrize("query", [
    {"prefix": {"tag": "a"}}, {"range": {"tag": {"gte": "a"}}},
    {"range": {"n": {"gte": 1}}}, {"wildcard": {"tag": "a*"}},
    {"query_string": {"query": "a*"}}, {"match_all": {}},
], ids=["prefix", "keyword_range", "numeric_range", "wildcard",
        "query_string", "match_all"])
def test_expensive_queries_setting_is_the_references(pair, query):
    def scenario(node):
        _seed(node, "exp", [{"n": 1, "tag": "a"}])
        node.put_cluster_settings({"transient": {
            "search.allow_expensive_queries": False}})
        try:
            return [observe(lambda: node.search("exp", {"query": query}))]
        finally:
            node.put_cluster_settings({"transient": {
                "search.allow_expensive_queries": None}})
    pair.flow(scenario)


@pytest.mark.parametrize("block", ["write", "read_only", "read", "metadata",
                                   "read_only_allow_delete", "bogus"])
def test_block_route_and_enforcement(pair, block):
    for n in pair.nodes:
        _seed_vecs(n, shards=1)
    _both_handlers(pair, "add_index_block", {"index": "vx", "block": block})

    def scenario(node):
        vec = _vectors(1, seed=5)[0]
        return [observe(lambda: node.index_doc("vx", "nb", {"n": 1})),
                node.bulk([("index", {"_index": "vx", "_id": "nb2"},
                            {"n": 2})]),
                observe(lambda: node.update_doc(
                    "vx", "d1", {"doc": {"n": 5}})),
                observe(lambda: node.delete_doc("vx", "d2")),
                node.get_doc("vx", "d1"),
                node.count("vx"),
                _ids(node.search("vx", _knn(vec))),
                node.get_settings("vx", name="index.blocks.*")]
    pair.flow(scenario)


def test_block_lifted_by_settings(pair):
    def scenario(node):
        _seed_vecs(node, shards=1)
        node.put_index_settings("vx", {"index.blocks.write": True})
        refused = observe(lambda: node.index_doc("vx", "x", {"n": 1}))
        node.put_index_settings("vx", {"index.blocks.write": False})
        return [refused, node.index_doc("vx", "x", {"n": 1}),
                node.count("vx")]
    obs = pair.flow(scenario)
    assert obs[0][1] == "ClusterBlockException"


# ---------------------------------------------------------------------------
# resize, rollover through templates, _upgrade
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,src_shards,settings", [
    ("split", 2, {"index.number_of_shards": 4}),
    ("split", 1, {}),
    ("shrink", 4, {"index.number_of_shards": 2}),
    ("shrink", 2, {}),
    ("clone", 2, {}),
])
def test_resize_then_knn_on_the_target(pair, kind, src_shards, settings):
    """The target holds the source's live docs (a delete and an unrefreshed
    write included) and answers a kNN as the reference's target does."""
    def scenario(node):
        vecs = _seed_vecs(node, shards=src_shards, n_docs=48)
        node.delete_doc("vx", "d7")
        node.index_doc("vx", "fresh", {"v": vecs[9].tolist(), "n": 100})
        node.put_index_settings("vx", {"index.blocks.write": True})
        out = [node.resize_index(kind, "vx", "tgt",
                                 {"settings": settings}),
               node.get_settings("tgt", flat=True)["tgt"]["settings"].get(
                   "index.number_of_shards"),
               node.get_settings("tgt", name="index.blocks.write"),
               node.count("tgt")]
        for i in (0, 9, 30):
            out.append(node.search("tgt", _knn(vecs[i], k=10)))
            out.append(node.search("tgt", _knn(vecs[i], k=40, size=40)))
        out.append(observe(lambda: node.index_doc("tgt", "x", {"n": 1})))
        out.append(node.search("tgt", {"query": {"match": {"title": "doc"}},
                                       "size": 5}))
        return out
    obs = pair.flow(scenario)
    assert obs[3]["count"] == 48
    assert obs[-2][1] == "ClusterBlockException"


def test_resize_refusals(pair):
    def scenario(node):
        _seed_vecs(node, shards=2, n_docs=8)
        out = [observe(lambda: node.resize_index("split", "vx", "t1")),
               observe(lambda: node.resize_index("split", "nope", "t1"))]
        node.put_index_settings("vx", {"index.blocks.write": True})
        for kind, tgt, body in [
                ("split", "t1", {"settings": {"index.number_of_shards": 3}}),
                ("shrink", "t1", {"settings": {"index.number_of_shards": 3}}),
                ("clone", "t1", {"settings": {"index.number_of_shards": 4}}),
                ("clone", "vx", {}),
                ("clone", "Bad", {}),
                ("clone", "t1", {"settings": {
                    "index.number_of_routing_shards": 8}}),
                ("clone", "t1", {"settings": {"index.blocks.read_only":
                                              True}}),
                ("clone", "t2", {"settings": {"index.blocks.write": None}})]:
            out.append(observe(lambda kind=kind, tgt=tgt, body=body:
                               node.resize_index(kind, "vx", tgt, body)))
        out.append(node.get_settings("t2", name="index.blocks.*"))
        return out
    obs = pair.flow(scenario)
    assert obs[0][1] == "IllegalStateException"


@pytest.mark.parametrize("route", ["shrink_index", "split_index",
                                   "clone_index"])
def test_resize_routes(pair, route):
    for n in pair.nodes:
        _seed_vecs(n, shards=2, n_docs=8)
        n.put_index_settings("vx", {"index.blocks.write": True})
    body = {"settings": {"index.number_of_shards":
                         {"shrink_index": 1, "split_index": 4,
                          "clone_index": 2}[route]}}
    _both_handlers(pair, route, {"index": "vx", "target": "t"},
                   {"copy_settings": "false"}, body)
    _both_handlers(pair, route, {"index": "vx", "target": "t"}, {}, body)
    _both_handlers(pair, route, {"index": "vx", "target": "t"}, {}, body)


def test_rollover_through_a_template_moves_the_write_alias(pair):
    def scenario(node):
        node.put_index_template("vec", {
            "index_patterns": ["vec-*"],
            "template": {"settings": {"number_of_shards": 2},
                         "mappings": VEC_MAPPING}})
        vecs = _vectors(30, seed=4)
        node.create_index("vec-000001", {"aliases": {
            "vec-w": {"is_write_index": True}}})
        node.bulk([("index", {"_index": "vec-w", "_id": f"a{i}"},
                    {"v": vecs[i].tolist()}) for i in range(15)],
                  refresh=True)
        out = [node.rollover("vec-w", {"conditions": {"max_docs": 10}}),
               node.get_mapping("vec-000002"),
               node.get_alias(None, "vec-w")]
        node.bulk([("index", {"_index": "vec-w", "_id": f"b{i}"},
                    {"v": vecs[i].tolist()}) for i in range(15, 30)],
                  refresh=True)
        out += [node.count("vec-000001"), node.count("vec-000002"),
                node.search("vec-w", _knn(vecs[20], k=10)),
                node.search("vec-w", _knn(vecs[3], k=10))]
        return out
    obs = pair.flow(scenario)
    assert obs[0]["rolled_over"] and obs[3]["count"] == 15
    assert _ids(obs[5])[0] == "b20" and _ids(obs[6])[0] == "a3"


def test_upgrade_route(pair):
    for n in pair.nodes:
        _seed(n, "u1", [{"n": 1}])
        _seed(n, "u2", [{"n": 1}])
        n.close_index("u2")
    for params, query in [({}, {}), ({"index": "u1"}, {}),
                          ({"index": "u*"}, {"expand_wildcards": "all"}),
                          ({"index": "missing"}, {})]:
        _both_handlers(pair, "indices_upgrade", params, query)


# ---------------------------------------------------------------------------
# the port alone: device residency across close / open, launches
# ---------------------------------------------------------------------------


def test_closed_index_keeps_its_bundle_and_launches_nothing(tmp_path,
                                                            monkeypatch):
    node = TorchNode(tmp_path / "n", device="cpu")
    vecs = _seed_vecs(node)
    calls = []
    scan = knn_fused.pool_scan
    monkeypatch.setattr(knn_fused, "pool_scan",
                        lambda *a, **k: calls.append(1) or scan(*a, **k))
    distributed_serving.registry.reset_stats()
    before = node.search("vx", _knn(vecs[4], k=10))
    assert len(calls) == 1
    resident = distributed_serving.registry.resident_bytes()
    builds = distributed_serving.registry.snapshot_stats()["builds"]
    node.close_index("vx")
    assert distributed_serving.registry.resident_bytes() == resident
    with pytest.raises(Exception) as err:
        node.search("vx", _knn(vecs[4], k=10))
    assert type(err.value).__name__ == "IndexClosedException"
    assert len(calls) == 1
    node.open_index("vx")
    after = node.search("vx", _knn(vecs[4], k=10))
    assert len(calls) == 2
    # the close's flush refreshed each shard, a new reader generation: the
    # first search after the open builds the bundle once more, as the
    # reference's stacked step would
    assert distributed_serving.registry.snapshot_stats()["builds"] == \
        builds + 1
    assert [(h["_id"], h["_score"]) for h in before["hits"]["hits"]] == \
        [(h["_id"], h["_score"]) for h in after["hits"]["hits"]]
    node.close()
