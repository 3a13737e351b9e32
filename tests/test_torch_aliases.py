"""Aliases on TorchNode against TpuNode.

`TestAliases`, `TestAliasRegressions` (rollover aside: not ported) and
`TestAliasRemoveMustExist` of tests/test_metadata_apis.py, each scenario on
both nodes over the same docs with the observations equal (responses, or
an error's class, status and message). Then the port alone: a kNN through
a filtered alias runs on the stacked step as ONE filtered K1 launch
(``distributed_serving.stats["filtered"]``) whose hits are the same kNN
with the filter in ``knn.filter``, bit for bit, on 1 and 3 shards, with a
filter of its own ANDed in; two filtered aliases of one index OR their
filters; an `_msearch` through a filtered alias declines the batched
launch; `require_alias` and a write alias's routing; aliases in
`create_index`.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.search import distributed_serving

from test_torch_scroll_pit import Pair, observe


def _seed(node, name, docs=None, **create_kw):
    node.create_index(name, {
        "mappings": {"properties": {
            "tag": {"type": "keyword"}, "n": {"type": "long"}}},
        **create_kw})
    for i, d in enumerate(docs or []):
        node.index_doc(name, str(i), d)
    node.refresh(name)


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


class TestAliases:
    def test_add_remove_get(self, pair):
        def scenario(node):
            _seed(node, "logs-1", [{"tag": "a", "n": 1}])
            out = [node.update_aliases({"actions": [
                {"add": {"index": "logs-1", "alias": "logs"}}]}),
                node.get_alias(alias_expr="logs"),
                node.search("logs", {"query": {"match_all": {}}}),
                node.update_aliases({"actions": [
                    {"remove": {"index": "logs-1", "alias": "logs"}}]}),
                observe(lambda: node.search("logs", {"query": {
                    "match_all": {}}}))]
            return out

        out = pair.flow(scenario)
        assert out[1] == {"logs-1": {"aliases": {"logs": {}}}}
        assert out[4][:3] == ("error", "IndexNotFoundException", 404)

    def test_write_through_alias(self, pair):
        def scenario(node):
            _seed(node, "w-1")
            node.put_alias("w-1", "w")
            put = node.index_doc("w", "x", {"tag": "via-alias", "n": 9})
            node.refresh("w")
            got = node.get_doc("w", "x")
            assert got["found"] and got["_index"] == "w-1"
            upd = node.update_doc("w", "x", {"doc": {"n": 10}})
            deleted = node.delete_doc("w", "x")
            return [put, got, upd, deleted]

        pair.flow(scenario)

    def test_write_index_selection(self, pair):
        def scenario(node):
            _seed(node, "r-1")
            _seed(node, "r-2")
            node.update_aliases({"actions": [
                {"add": {"index": "r-1", "alias": "r"}},
                {"add": {"index": "r-2", "alias": "r",
                         "is_write_index": True}}]})
            put = node.index_doc("r", "d", {"tag": "t", "n": 1})
            node.refresh("_all")
            return [put, node.get_doc("r-2", "d"),
                    node.search("r", {"query": {"match_all": {}}}),
                    observe(lambda: node.get_doc("r", "d"))]

        out = pair.flow(scenario)
        assert {h["_index"] for h in out[2]["hits"]["hits"]} == {"r-2"}
        # a read by id through the alias goes to its one write index
        assert out[3][1]["_index"] == "r-2"

    def test_multi_target_alias_without_write_index_rejects_writes(self,
                                                                   pair):
        def scenario(node):
            _seed(node, "m-1")
            _seed(node, "m-2")
            node.update_aliases({"actions": [
                {"add": {"indices": ["m-1", "m-2"], "alias": "m"}}]})
            return [observe(lambda: node.index_doc("m", "d", {"n": 1})),
                    node.bulk([("index", {"_index": "m", "_id": "d"},
                                {"n": 1})])]

        out = pair.flow(scenario)
        assert out[0][1] == "IllegalArgumentException"
        assert out[1]["errors"]

    def test_filtered_alias_search(self, pair):
        def scenario(node):
            _seed(node, "ev", [{"tag": "err", "n": 1}, {"tag": "ok", "n": 2},
                               {"tag": "err", "n": 3}])
            node.put_alias("ev", "errors",
                           {"filter": {"term": {"tag": "err"}}})
            res = node.search("errors", {"query": {"match_all": {}}})
            assert res["hits"]["total"]["value"] == 2
            aggs = node.search("errors", {
                "size": 0, "query": {"match_all": {}},
                "aggs": {"s": {"sum": {"field": "n"}}}})
            assert aggs["aggregations"]["s"]["value"] == 4.0
            both = node.search("ev,errors", {"query": {"match_all": {}}})
            assert both["hits"]["total"]["value"] == 3
            return [res, aggs, both, node.count("errors")]

        pair.flow(scenario)

    def test_alias_clash_with_index_name(self, pair):
        def scenario(node):
            _seed(node, "a-1")
            _seed(node, "a-2")
            return [observe(lambda: node.put_alias("a-1", "a-2")),
                    observe(lambda: node.create_index(
                        "a-3", {"aliases": {"a-1": {}}}))]

        out = pair.flow(scenario)
        assert out[0][1] == "IllegalArgumentException"

    def test_alias_routing_applies(self, pair):
        def scenario(node):
            node.create_index("rt", {
                "settings": {"index": {"number_of_shards": 4}},
                "mappings": {"properties": {"n": {"type": "long"}}}})
            node.put_alias("rt", "rt-a", {"routing": "fixed"})
            put = node.index_doc("rt-a", "k", {"n": 1})
            svc = node.indices["rt"]
            assert svc.shard_for("ignored-id", "fixed").get("k") is not None
            return [put, node.get_alias(index_expr="rt")]

        out = pair.flow(scenario)
        assert out[1]["rt"]["aliases"]["rt-a"] == {
            "index_routing": "fixed", "search_routing": "fixed"}

    def test_atomic_swap(self, pair):
        def scenario(node):
            _seed(node, "v1", [{"n": 1}])
            _seed(node, "v2", [{"n": 2}])
            node.put_alias("v1", "current")
            node.update_aliases({"actions": [
                {"remove": {"index": "v1", "alias": "current"}},
                {"add": {"index": "v2", "alias": "current"}}]})
            return [node.search("current", {"query": {"match_all": {}}})]

        out = pair.flow(scenario)
        assert {h["_index"] for h in out[0]["hits"]["hits"]} == {"v2"}

    def test_persistence(self, tmp_path):
        pair = Pair(tmp_path)
        for n in pair.nodes:
            n.create_index("p-1", {})
            n.put_alias("p-1", "p")
        pair.close()
        again = Pair(tmp_path)
        try:
            out = again.call("get_alias", alias_expr="p")
            assert out[1]["p-1"]["aliases"] == {"p": {}}
        finally:
            again.close()


class TestAliasRegressions:
    def test_bulk_refresh_through_alias(self, pair):
        def scenario(node):
            _seed(node, "br-1")
            node.put_alias("br-1", "br")
            resp = node.bulk([("index", {"_index": "br", "_id": "1"},
                               {"n": 1})], refresh=True)
            assert not resp["errors"]
            return [resp, node.search("br", {"query": {"match_all": {}}})]

        out = pair.flow(scenario)
        assert out[1]["hits"]["total"]["value"] == 1

    def test_pit_respects_alias_filter(self, pair):
        def scenario(node):
            _seed(node, "pf", [{"tag": "x", "n": 1}, {"tag": "y", "n": 2}])
            node.put_alias("pf", "pf-x", {"filter": {"term": {"tag": "x"}}})
            pid = node.open_pit("pf-x", "1m")["pit_id"]
            res = node.search(None, {"pit": {"id": pid},
                                     "query": {"match_all": {}}})
            assert res["hits"]["total"]["value"] == 1
            assert res["hits"]["hits"][0]["_source"]["tag"] == "x"
            return [res]

        pair.flow(scenario)

    def test_remove_index_applies_last(self, pair):
        def scenario(node):
            _seed(node, "ra")
            _seed(node, "rb")
            resp = node.update_aliases({"actions": [
                {"add": {"index": "ra", "alias": "x"}},
                {"remove_index": {"index": "rb"}},
                {"add": {"index": "rb", "alias": "y"}}]})
            assert "rb" not in node.indices
            return [resp, node.get_alias(alias_expr="x")]

        out = pair.flow(scenario)
        assert out[1]["ra"]["aliases"] == {"x": {}}

    @pytest.mark.parametrize("body", [
        {"actions": [{"add": None}]},
        {"actions": []},
        {},
        {"actions": [{"rename": {"index": "q", "alias": "z"}}]},
        {"actions": [{"add": {"index": "q"}}]},
        {"actions": [{"add": {"alias": "z"}}]},
        {"actions": [{"add": {"index": "q", "aliases": []}}]},
        {"actions": [{"add": {"index": "q", "alias": "z"},
                      "remove": {"index": "q", "alias": "z"}}]},
    ], ids=["none_body", "empty", "no_actions", "unknown_action",
            "no_alias", "no_index", "empty_aliases", "two_keys"])
    def test_malformed_action_body_rejected(self, pair, body):
        def scenario(node):
            _seed(node, "q")
            return [observe(lambda: node.update_aliases(body))]

        out = pair.flow(scenario)
        assert out[0][1] == "IllegalArgumentException"

    def test_delete_index_through_an_alias_is_rejected(self, pair):
        def scenario(node):
            _seed(node, "di")
            node.put_alias("di", "di-a")
            return [observe(lambda: node.delete_index("di-a")),
                    node.delete_index("di-a", ignore_unavailable=True),
                    node.get_alias()]

        out = pair.flow(scenario)
        assert out[0][1] == "IllegalArgumentException"

    def test_get_alias_patterns_and_missing(self, pair):
        def scenario(node):
            _seed(node, "g1")
            _seed(node, "g2")
            node.update_aliases({"actions": [
                {"add": {"index": "g1", "alias": "ga"}},
                {"add": {"index": "g1", "alias": "gb"}},
                {"add": {"index": "g2", "alias": "gc",
                         "filter": {"term": {"tag": "z"}},
                         "index_routing": 3, "search_routing": "1,2"}}]})
            return [node.get_alias(), node.get_alias(alias_expr="g*"),
                    node.get_alias(alias_expr="g*,-gb"),
                    node.get_alias(alias_expr="ga,nope"),
                    node.get_alias(alias_expr="-ga"),
                    node.get_alias(index_expr="g2"),
                    node.get_alias(index_expr="g1", alias_expr="_all"),
                    node.delete_alias("g1", "g*"),
                    observe(lambda: node.delete_alias("g1", "ga"))]

        out = pair.flow(scenario)
        assert out[3]["status"] == 404 and out[3]["error"] == \
            "alias [nope] missing"


class TestAliasRemoveMustExist:
    def test_remove_missing_alias_404(self, pair):
        def scenario(node):
            _seed(node, "ar-1")
            return [observe(lambda: node.update_aliases({"actions": [
                {"remove": {"index": "ar-1", "alias": "nope"}}]}))]

        assert pair.flow(scenario)[0][1:3] == (
            "ResourceNotFoundException", 404)

    def test_remove_missing_alias_must_exist_false_ok(self, pair):
        def scenario(node):
            _seed(node, "ar-2")
            return [node.update_aliases({"actions": [
                {"remove": {"index": "ar-2", "alias": "nope",
                            "must_exist": False}}]})]

        assert pair.flow(scenario) == [{"acknowledged": True}]

    def test_atomic_no_partial_apply(self, pair):
        def scenario(node):
            _seed(node, "ar-3")
            err = observe(lambda: node.update_aliases({"actions": [
                {"add": {"index": "ar-3", "alias": "ok"}},
                {"remove": {"index": "ar-3", "alias": "nope"}}]}))
            return [err, node.get_alias(alias_expr="ok")]

        out = pair.flow(scenario)
        assert out[1].get("status") == 404
        assert not any(isinstance(v, dict) and v.get("aliases")
                       for v in out[1].values())


# -- the port alone: kNN through a filtered alias on the stacked step ---------

DIM = 8


def _knn_node(tmp_path, shards: int, n: int = 120):
    node = TorchNode(tmp_path, device="cpu")
    rng = np.random.default_rng(11)
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    node.create_index("kv", {"settings": {"number_of_shards": shards},
                             "mappings": {"properties": {
                                 "v": {"type": "knn_vector",
                                       "dimension": DIM},
                                 "color": {"type": "keyword"},
                                 "age": {"type": "integer"}}}})
    node.bulk([("index", {"_index": "kv", "_id": str(i)},
                {"v": vecs[i].tolist(), "color": ("red", "blue")[i % 2],
                 "age": int(i % 50)}) for i in range(n)], refresh=True)
    return node, vecs


RED = {"term": {"color": "red"}}
YOUNG = {"range": {"age": {"lt": 20}}}


def _hits(resp):
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("k", [5, 40])
def test_filtered_alias_knn_is_one_filtered_launch(tmp_path, shards, k):
    node, vecs = _knn_node(tmp_path, shards)
    node.put_alias("kv", "reds", {"filter": RED})
    for i in (0, 7, 33):
        body = {"query": {"knn": {"v": {"vector": vecs[i].tolist(),
                                        "k": k}}}, "size": k}
        f0 = dict(distributed_serving.stats)
        through = node.search("reds", body)
        f1 = dict(distributed_serving.stats)
        assert f1["distributed_searches"] - f0["distributed_searches"] == 1
        assert f1["filtered"] - f0["filtered"] == 1
        body_filtered = node.search("kv", {"query": {"knn": {"v": {
            "vector": vecs[i].tolist(), "k": k, "filter": RED}}}, "size": k})
        assert _hits(through) == _hits(body_filtered)
        assert through["hits"]["total"] == body_filtered["hits"]["total"]
        assert all(int(h) % 2 == 0 for h, _s in _hits(through))
        # the per-shard route ANDs the alias filter into the query as a
        # bool filter beside the knn, as the reference's does: the top k
        # of every doc, then the alias's among them (the stacked step
        # narrows K1's valid mask instead: the top k of the alias's docs)
        distributed_serving.enabled = False
        try:
            per_shard = node.search("reds", body)
            unfiltered = node.search("kv", body)
        finally:
            distributed_serving.enabled = True
        assert all(int(h) % 2 == 0 for h, _s in _hits(per_shard))
        if shards == 1:
            assert [h for h, _s in _hits(per_shard)] == \
                [h for h, _s in _hits(unfiltered) if int(h) % 2 == 0]
        # an alias filter AND a knn.filter
        both = node.search("reds", {"query": {"knn": {"v": {
            "vector": vecs[i].tolist(), "k": k, "filter": YOUNG}}},
            "size": k})
        assert all(int(h) % 2 == 0 and int(h) % 50 < 20
                   for h, _s in _hits(both))
        want = node.search("kv", {"query": {"knn": {"v": {
            "vector": vecs[i].tolist(), "k": k, "filter": {"bool": {
                "filter": [RED, YOUNG]}}}}}, "size": k})
        assert _hits(both) == _hits(want)
    node.close()


def test_two_filtered_aliases_or_their_filters(tmp_path):
    node, vecs = _knn_node(tmp_path, 2)
    node.update_aliases({"actions": [
        {"add": {"index": "kv", "alias": "reds", "filter": RED}},
        {"add": {"index": "kv", "alias": "young", "filter": YOUNG}}]})
    body = {"query": {"knn": {"v": {"vector": vecs[4].tolist(), "k": 30}}},
            "size": 30}
    got = node.search("reds,young", body)
    want = node.search("kv", {"query": {"knn": {"v": {
        "vector": vecs[4].tolist(), "k": 30, "filter": {"bool": {
            "should": [RED, YOUNG], "minimum_should_match": 1}}}}},
        "size": 30})
    assert _hits(got) == _hits(want)
    # an unfiltered route to the index drops the alias filters
    assert _hits(node.search("reds,kv", body)) == _hits(node.search(
        "kv", body))
    node.close()


def test_msearch_through_a_filtered_alias_declines_the_batch(tmp_path):
    node, vecs = _knn_node(tmp_path, 1)
    node.put_alias("kv", "reds", {"filter": RED})
    bodies = [{"query": {"knn": {"v": {"vector": vecs[i].tolist(),
                                       "k": 5}}}} for i in range(4)]
    b0 = distributed_serving.stats["batched_queries"]
    f0 = distributed_serving.stats["filtered"]
    out = node.msearch([({"index": "reds"}, b) for b in bodies])
    assert distributed_serving.stats["batched_queries"] == b0
    assert distributed_serving.stats["filtered"] - f0 == 4
    for b, r in zip(bodies, out["responses"]):
        assert _hits(r) == _hits(node.search("reds", b))
    # an unfiltered alias still batches
    node.put_alias("kv", "all")
    node.msearch([({"index": "all"}, b) for b in bodies])
    assert distributed_serving.stats["batched_queries"] == b0 + 4
    node.close()


def test_require_alias_and_create_index_aliases(tmp_path):
    node = TorchNode(tmp_path, device="cpu")
    node.create_index("ci", {"aliases": {"ci-w": {"is_write_index": True},
                                         "ci-f": {"filter": RED}}})
    assert node.get_alias(index_expr="ci") == {"ci": {"aliases": {
        "ci-w": {"is_write_index": True}, "ci-f": {"filter": RED}}}}
    node.update_doc("ci-w", "1", {"doc": {"color": "red"},
                                  "doc_as_upsert": True},
                    require_alias=True)
    err = observe(lambda: node.update_doc("ci", "1", {"doc": {}},
                                          require_alias=True))
    assert err[1:3] == ("IndexNotFoundException", 404)
    resp = node.bulk([("index", {"_index": "ci-w", "_id": "2",
                                 "require_alias": True}, {"color": "blue"}),
                      ("index", {"_index": "ci", "_id": "3",
                                 "require_alias": True}, {"color": "red"})],
                     refresh=True)
    assert [list(it.values())[0]["status"] for it in resp["items"]] == \
        [201, 404]
    assert node.count("ci-f")["count"] == 1
    node.close()
