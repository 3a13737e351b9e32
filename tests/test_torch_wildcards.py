"""Wildcard index expressions on the port against the reference.

`*` and `?` patterns over index and alias names, comma lists,
`expand_wildcards` (open, closed, all, none), `allow_no_indices`,
`ignore_unavailable`, date-math names and a filtered alias a pattern
reaches, through `resolve_indices`, `get_mapping`, `get_settings`,
`search`, `count`, `delete_index` and `_stats`: each scenario on a TpuNode
and a TorchNode(device="cpu") with the observations equal (errors by class,
status and message), `took` and index uuids left out.

Then what the port adds, each against what OpenSearch answers: a "-name"
or "-pattern" exclusion after a pattern (the reference treats "-name" as a
missing index), `index.hidden` indices (a pattern reaches one only under
`expand_wildcards=hidden` or `all`, or by a dot pattern for a dot name;
the reference has no hidden indices); and a kNN through `vec-*` or
`vec-*,-vec-twin` takes the stacked step exactly as the concrete name:
one dispatch and the same hits, bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu_torch.common.errors import IndexNotFoundException
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.search import distributed_serving

from test_torch_scroll_pit import Pair, observe

DIM = 8


def _seed(node):
    rng = np.random.default_rng(3)
    mapping = {"properties": {"v": {"type": "knn_vector", "dimension": DIM},
                              "tag": {"type": "keyword"}}}
    for name, shards in (("logs-a", 1), ("logs-b", 2), ("metrics-1", 1),
                         ("other", 1)):
        node.create_index(name, {"settings": {"number_of_shards": shards},
                                 "mappings": mapping})
        vecs = rng.standard_normal((20, DIM)).astype(np.float32).round(3)
        node.bulk([("index", {"_index": name, "_id": f"{name}-{i}"},
                    {"v": vecs[i].tolist(), "tag": ("x", "y")[i % 2]})
                   for i in range(20)], refresh=True)
    node.update_aliases({"actions": [
        {"add": {"index": "logs-a", "alias": "logs-all"}},
        {"add": {"index": "logs-b", "alias": "logs-all"}},
        {"add": {"index": "metrics-1", "alias": "mx",
                 "filter": {"term": {"tag": "x"}}}}]})


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


EXPRESSIONS = [
    ("logs-*", {}), ("log?-a", {}), ("logs-*,metrics-*", {}),
    ("*-all", {}), ("m*", {}), ("logs-a,logs-*", {}), ("*", {}),
    ("_all", {}), ("", {}), ("nomatch-*", {}),
    ("nomatch-*", {"allow_no_indices": False}),
    ("logs-*,nomatch-*", {"allow_no_indices": False}),
    ("logs-*", {"expand_wildcards": "none"}),
    ("logs-*", {"expand_wildcards": "all"}),
    ("logs-*", {"expand_wildcards": "open,closed"}),
    ("logs-*,missing", {}),
    ("logs-*,missing", {"ignore_unavailable": True}),
    ("*", {"expand_wildcards": "none", "allow_no_indices": False}),
]


@pytest.mark.parametrize("expr,kw", EXPRESSIONS,
                         ids=[f"{e or 'empty'}-{'-'.join(map(str, kw.values()))}"
                              for e, kw in EXPRESSIONS])
def test_resolve_indices_is_the_references(pair, expr, kw):
    def scenario(node):
        _seed(node)
        return [observe(lambda: node.resolve_indices(expr, **kw))]

    pair.flow(scenario)


def test_reads_over_patterns_are_the_references(pair):
    def scenario(node):
        _seed(node)
        q = {"query": {"knn": {"v": {"vector": [0.1] * DIM, "k": 5}}},
             "size": 5}
        return [node.get_mapping("logs-*"), node.get_settings("l*,m*"),
                node.search("logs-*", q), node.search("*-all", q),
                node.search("m*", q), node.search("logs-*,mx", q),
                node.count("*")["count"],
                node.count("m?")["count"],
                node.search("nomatch-*", q),
                observe(lambda: node.search("logs-*,nope", q)),
                node.search("logs-*,nope", q, ignore_unavailable=True),
                node.index_stats("logs-*", metrics=["docs"]),
                node.cluster_health("logs-*", level="indices")]

    out = pair.flow(scenario)
    assert out[6] == 80
    # a pattern reaching a filtered alias keeps its filter
    assert out[7] == 10


def test_date_math_names_are_the_references(pair):
    import datetime as dt

    today = dt.datetime.now(dt.timezone.utc).strftime("%Y.%m.%d")

    def scenario(node):
        node.create_index(f"daily-{today}")
        return [node.resolve_indices("<daily-{now/d}>"),
                observe(lambda: node.resolve_indices("<daily-{now-1d/d}>"))]

    out = pair.flow(scenario)
    assert out[0] == [f"daily-{today}"]


def test_delete_over_patterns_is_the_references(pair):
    def scenario(node):
        _seed(node)
        return [node.delete_index("logs-*"), sorted(node.indices),
                observe(lambda: node.delete_index(
                    "nomatch-*", allow_no_indices=False)),
                observe(lambda: node.delete_index("mx")),
                node.delete_index("*"), sorted(node.indices)]

    out = pair.flow(scenario)
    assert out[1] == ["metrics-1", "other"] and out[5] == []


# -- the port's additions ----------------------------------------------------


@pytest.fixture()
def node(tmp_path):
    n = TorchNode(tmp_path, device="cpu")
    _seed(n)
    yield n
    n.close()


@pytest.mark.parametrize("expr,want", [
    ("logs-*,-logs-b", ["logs-a"]),
    ("*,-logs-*", ["metrics-1", "other"]),
    ("*,-*-1,-other", ["logs-a", "logs-b"]),
    ("logs-*,-logs-all", []),
    ("logs-*,-logs-all,logs-b", ["logs-b"]),
    ("*-all,-logs-all", []),
    ("logs-*,-nomatch", ["logs-a", "logs-b"]),
])
def test_exclusions_after_a_pattern(node, expr, want):
    """OpenSearch's resolver: after a pattern, "-x" drops the concrete
    indices it names (an alias its members) from everything selected so
    far; a later part may select them again."""
    assert node.resolve_indices(expr) == want


def test_a_leading_dash_is_a_name(node, tmp_path):
    """With no pattern before it, "-x" is a literal name, as in
    OpenSearch and the reference: a missing index."""
    from opensearch_tpu.node import TpuNode

    with pytest.raises(IndexNotFoundException, match="-logs-a"):
        node.resolve_indices("-logs-a,logs-*")
    ref = TpuNode(tmp_path / "ref")
    try:
        ref.create_index("logs-a")
        # the reference has no exclusions: "-logs-b" after a pattern is a
        # missing index there too
        with pytest.raises(Exception, match="-logs-b"):
            ref.resolve_indices("logs-*,-logs-b")
    finally:
        ref.close()


def test_exclusions_in_search_count_and_delete(node):
    q = {"query": {"knn": {"v": {"vector": [0.2] * DIM, "k": 50}}},
         "size": 50}
    hits = node.search("logs-*,-logs-b", q)["hits"]["hits"]
    assert {h["_index"] for h in hits} == {"logs-a"}
    # metrics-1 is reached by its own name too: its alias filter drops
    assert node.count("*,-logs-*")["count"] == 40
    node.delete_index("logs-*,-logs-a")
    assert sorted(node.indices) == ["logs-a", "metrics-1", "other"]


def test_hidden_indices_and_expand_wildcards(tmp_path):
    node = TorchNode(tmp_path, device="cpu")
    try:
        node.create_index("vis")
        node.create_index("hid", {"settings": {"index.hidden": True}})
        node.create_index(".sys", {"settings": {"index": {"hidden": True}}})
        node.update_aliases({"actions": [{"add": {
            "index": "vis", "alias": "hidden-alias", "is_hidden": True}}]})
        assert node.resolve_indices("*") == ["vis"]
        assert node.resolve_indices("_all") == ["vis"]
        assert node.resolve_indices("h*") == []
        assert node.resolve_indices("h*", expand_wildcards="open,hidden") == [
            "hid", "vis"]
        assert node.resolve_indices("*", expand_wildcards="all") == [
            ".sys", "hid", "vis"]
        # a dot pattern reaches a dot-prefixed hidden index
        assert node.resolve_indices(".s*") == [".sys"]
        # a name always resolves, hidden or not
        assert node.resolve_indices("hid,hidden-alias") == ["hid", "vis"]
        # every index is open: closed alone selects nothing
        assert node.resolve_indices("*", expand_wildcards="closed") == []
        assert node.resolve_indices("vis", expand_wildcards="closed") == [
            "vis"]
        with pytest.raises(IndexNotFoundException):
            node.resolve_indices("*", expand_wildcards="closed",
                                 allow_no_indices=False)
    finally:
        node.close()


@pytest.mark.parametrize("k", [10, 100])
def test_knn_over_a_pattern_takes_the_stacked_step(tmp_path, k):
    """vec-* and vec-*,-vec-twin reach one index: one dispatch of the
    stacked step each, the hits of the concrete name bit for bit."""
    node = TorchNode(tmp_path, device="cpu")
    try:
        rng = np.random.default_rng(21)
        vecs = rng.standard_normal((400, DIM)).astype(np.float32)
        mapping = {"properties": {"v": {"type": "knn_vector",
                                        "dimension": DIM}}}
        for name in ("vec-2026.10", "vec-twin"):
            node.create_index(name, {"settings": {"number_of_shards": 2},
                                     "mappings": mapping})
            node.bulk([("index", {"_index": name, "_id": str(i)},
                        {"v": vecs[i].tolist()}) for i in range(400)],
                      refresh=True)
        node.delete_index("vec-twin")
        node.create_index("vec-twin", {"mappings": mapping})
        for i in range(3):
            body = {"query": {"knn": {"v": {"vector": vecs[i].tolist(),
                                            "k": k}}}, "size": k}
            runs = []
            for expr in ("vec-2026.10", "vec-*,-vec-twin", "vec-2*"):
                s0 = dict(distributed_serving.stats)
                hits = node.search(expr, body)["hits"]["hits"]
                s1 = dict(distributed_serving.stats)
                assert s1["distributed_searches"] - \
                    s0["distributed_searches"] == 1, expr
                assert s1["fallbacks"] == s0["fallbacks"], expr
                runs.append([(h["_index"], h["_id"], h["_score"])
                             for h in hits])
            assert runs[0] == runs[1] == runs[2]
            assert len(runs[0]) == k
    finally:
        node.close()
