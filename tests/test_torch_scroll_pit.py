"""Scroll and point-in-time reader contexts: TorchNode against TpuNode.

The cases of tests/test_scroll_pit.py run on a TpuNode and on a
TorchNode(device="cpu") over the same docs (made from a numpy seed): each
scenario's observations (responses, or an error's class name, status and
message) must be equal, with `took`, context ids and creation times left
out and floats to the tolerance tests/test_torch_rest.py states. Then the
port alone: a kNN through a PIT after deletes and a refresh returns the
pre-delete hits bit for bit on the stacked step while the live index
returns the post-delete ones, search_after on `_shard_doc` pages a k = 20
kNN, a kNN scroll's pages concatenate to the one-shot hits, and a closed
context leaves no reference to its snapshots.

:class:`Pair` and :func:`observe` are the harness the other parity files
of the search-contexts slice import.
"""

from __future__ import annotations

import gc
import time
import weakref

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.search import distributed_serving

from test_torch_rest import _assert_same, _strip

# what two runs legitimately differ in beyond `took` and an index's uuid
CONTEXT_KEYS = {"pit_id", "_scroll_id", "creation_time", "creation_date"}


def strip_contexts(obj):
    obj = _strip(obj)
    if isinstance(obj, dict):
        return {k: strip_contexts(v) for k, v in obj.items()
                if k not in CONTEXT_KEYS}
    if isinstance(obj, (list, tuple)):
        return [strip_contexts(v) for v in obj]
    return obj


def observe(fn):
    """("ok", the result) or ("error", class name, status, message) for an
    error of the API (either package's OpenSearchTpuException)."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - compared, or raised again
        if hasattr(e, "status") and hasattr(e, "error_type"):
            return ("error", type(e).__name__, e.status, str(e))
        raise


class Pair:
    """A TpuNode and a TorchNode(device="cpu") taking the same calls."""

    def __init__(self, tmp_path, ref_node=None, port_node=None):
        self.ref = ref_node or TpuNode(tmp_path / "ref")
        self.port = port_node or TorchNode(tmp_path / "port", device="cpu")

    @property
    def nodes(self):
        return (self.ref, self.port)

    def close(self) -> None:
        for n in self.nodes:
            n.close()

    def flow(self, scenario) -> list:
        """scenario(node) -> a list of observations, on each node; the two
        lists must be equal. Returns the port's."""
        ref = scenario(self.ref)
        port = scenario(self.port)
        _assert_same(strip_contexts(ref), strip_contexts(port))
        return port

    def call(self, method: str, *args, **kwargs):
        """One call on each node, observed and compared; the port's."""
        return self.flow(lambda n: [observe(
            lambda: getattr(n, method)(*args, **kwargs))])[0]


DIM = 8


def seeded_docs(n: int, seed: int = 7) -> list[dict]:
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, DIM)).astype(np.float32).round(3)
    return [{"n": i, "msg": f"event number {i}", "v": vecs[i].tolist(),
             "tag": ("a", "b", "c")[i % 3]} for i in range(n)]


LOGS_MAPPING = {"properties": {"n": {"type": "long"},
                               "msg": {"type": "text"},
                               "tag": {"type": "keyword"},
                               "v": {"type": "knn_vector", "dimension": DIM}}}


def _seed_logs(node, n_docs: int = 25) -> None:
    node.create_index("logs", {"settings": {"number_of_shards": 2},
                               "mappings": LOGS_MAPPING})
    for i, d in enumerate(seeded_docs(n_docs)):
        node.index_doc("logs", str(i), d)
    node.refresh("logs")


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    for n in p.nodes:
        _seed_logs(n)
    yield p
    p.close()


def _ns(resp):
    return [h["_source"]["n"] for h in resp["hits"]["hits"]]


def _scroll_all(node, first: dict) -> list:
    pages = [first]
    while pages[-1]["hits"]["hits"]:
        pages.append(node.scroll(first["_scroll_id"]))
    return pages


def test_scroll_iterates_everything_in_order(pair):
    def scenario(node):
        first = node.search("logs", {"sort": [{"n": "asc"}], "size": 10},
                            scroll="1m")
        pages = _scroll_all(node, first)
        collected = [n for p in pages for n in _ns(p)]
        assert collected == list(range(25))
        return pages + [node.clear_scroll([first["_scroll_id"]])]

    pair.flow(scenario)


def test_scroll_sees_point_in_time_view(pair):
    def scenario(node):
        first = node.search("logs", {"sort": [{"n": "asc"}], "size": 5},
                            scroll="1m")
        # writes and a refresh after the scroll began must not appear
        for i in range(100, 110):
            node.index_doc("logs", str(i), {"n": i, "msg": "late"})
        node.refresh("logs")
        pages = _scroll_all(node, first)
        assert [n for p in pages for n in _ns(p)] == list(range(25))
        return pages

    pair.flow(scenario)


def test_scroll_score_order_without_sort(pair):
    def scenario(node):
        first = node.search("logs", {"query": {"match": {"msg": "event"}},
                                     "size": 7}, scroll="1m")
        seen = [h["_id"] for p in _scroll_all(node, first)
                for h in p["hits"]["hits"]]
        assert sorted(seen, key=int) == [str(i) for i in range(25)]
        return seen

    pair.flow(scenario)


def test_scroll_expiry_and_missing(pair):
    def scenario(node):
        resp = node.search("logs", {"size": 5}, scroll="1ms")
        time.sleep(0.05)
        return [observe(lambda: node.scroll(resp["_scroll_id"]))[:3],
                observe(lambda: node.scroll("scroll_nonexistent"))]

    out = pair.flow(scenario)
    assert out[0][:3] == ("error", "SearchContextMissingException", 404)


@pytest.mark.parametrize("body,scroll", [
    ({"from": 5}, "1m"),
    ({"size": 0}, "1m"),
    ({"search_after": [1], "sort": [{"n": "asc"}]}, "1m"),
    ({"size": 5}, "-1m"),
], ids=["from", "size_zero", "search_after", "negative_keep_alive"])
def test_scroll_rejections(pair, body, scroll):
    got = pair.call("search", "logs", body, scroll=scroll)
    assert got[0] == "error" and got[2] == 400


def test_clear_scroll(pair):
    def scenario(node):
        resp = node.search("logs", {"size": 5}, scroll="1m")
        return [node.clear_scroll([resp["_scroll_id"]]),
                observe(lambda: node.scroll(resp["_scroll_id"]))[:3],
                node.clear_scroll(None)]

    assert pair.flow(scenario)[0] == {"succeeded": True, "num_freed": 1}


def test_pit_search_and_search_after(pair):
    def scenario(node):
        pid = node.open_pit("logs", "1m")["pit_id"]
        node.index_doc("logs", "999", {"n": 999, "msg": "nope"})
        node.refresh("logs")
        pages, after = [], None
        while True:
            body = {"pit": {"id": pid}, "sort": [{"n": "asc"}], "size": 10}
            if after is not None:
                body["search_after"] = after
            resp = node.search(None, body)
            assert resp["pit_id"] == pid
            pages.append(resp)
            if not resp["hits"]["hits"]:
                break
            after = resp["hits"]["hits"][-1]["sort"]
        assert [n for p in pages for n in _ns(p)] == list(range(25))
        closed = node.close_pit([pid])
        assert closed["pits"][0]["successful"] is True
        live = node.search("logs", {"query": {"term": {"n": 999}}})
        return pages + [closed, live]

    pair.flow(scenario)


def test_pit_rejections(pair):
    def scenario(node):
        pid = node.open_pit("logs", "1m")["pit_id"]
        out = [observe(lambda: node.search("logs", {"pit": {"id": pid}})),
               observe(lambda: node.search(None, {"pit": {"id": pid}},
                                           scroll="1m")),
               observe(lambda: node.search(None, {"pit": {"id": "nope"}})),
               observe(lambda: node.open_pit("logs", "0s"))]
        node.close_pit([pid])
        return out

    assert [o[:3] for o in pair.flow(scenario)] == [
        ("error", "IllegalArgumentException", 400)] * 2 + [
        ("error", "SearchContextMissingException", 404),
        ("error", "IllegalArgumentException", 400)]


def test_shard_doc_sort_needs_a_pit(pair):
    got = pair.call("search", "logs", {"sort": ["_shard_doc"]})
    assert got[1] == "ActionRequestValidationException"


def test_close_and_list_all_pits(pair):
    def scenario(node):
        node.open_pit("logs", "1m")
        node.open_pit("logs", "2m")
        listed = node.list_all_pits()
        return [listed, node.close_pit(None), node.list_all_pits()]

    out = pair.flow(scenario)
    assert len(out[0]["pits"]) == 2 and len(out[1]["pits"]) == 2
    assert out[2] == {"pits": []}


def test_pit_version_is_snapshot_consistent(pair):
    def scenario(node):
        node.index_doc("logs", "v1", {"n": 500, "msg": "first"})
        node.refresh("logs")
        pid = node.open_pit("logs", "1m")["pit_id"]
        node.index_doc("logs", "v1", {"n": 501, "msg": "second"})
        node.refresh("logs")
        r = node.search(None, {"pit": {"id": pid},
                               "query": {"ids": {"values": ["v1"]}},
                               "version": True})
        h = r["hits"]["hits"][0]
        assert h["_source"]["n"] == 500 and h["_version"] == 1
        return [r]

    pair.flow(scenario)


def test_pit_via_msearch(pair):
    def scenario(node):
        pid = node.open_pit("logs", "1m")["pit_id"]
        out = node.msearch([({}, {"pit": {"id": pid}, "size": 1}),
                            ({}, {"pit": {"id": "gone"}, "size": 1})])
        node.close_pit([pid])
        return [out]

    out = pair.flow(scenario)[0]
    assert "error" not in out["responses"][0]
    assert out["responses"][1]["status"] == 404


def test_pit_keep_alive_cap(pair):
    """search.max_keep_alive caps a PIT's and a scroll's keep-alive."""
    def scenario(node):
        node.put_cluster_settings({"transient": {
            "search.max_keep_alive": "1m"}})
        return [observe(lambda: node.search("logs", {"size": 5},
                                            scroll="2m"))]

    assert pair.flow(scenario)[0][:3] == (
        "error", "IllegalArgumentException", 400)


def test_knn_through_a_pit_after_deletes(pair):
    """kNN through a PIT: the pre-delete hits after deletes and a refresh;
    the live index the post-delete ones; both nodes equal."""
    q = seeded_docs(25)[3]["v"]
    body = {"query": {"knn": {"v": {"vector": q, "k": 5}}}, "size": 5}

    def scenario(node):
        pre = node.search("logs", body)
        pid = node.open_pit("logs", "1m")["pit_id"]
        for h in pre["hits"]["hits"][:3]:
            node.delete_doc("logs", h["_id"])
        node.refresh("logs")
        through = node.search(None, {"pit": {"id": pid}, **body})
        live = node.search("logs", body)
        assert [h["_id"] for h in through["hits"]["hits"]] == \
            [h["_id"] for h in pre["hits"]["hits"]]
        assert not {h["_id"] for h in pre["hits"]["hits"][:3]} & \
            {h["_id"] for h in live["hits"]["hits"]}
        node.close_pit([pid])
        return [pre, through, live]

    pre, through, _live = pair.flow(scenario)
    # on the port the PIT's hits are the pre-delete bits, from the stacked
    # step over the pinned generation
    assert [(h["_id"], h["_score"]) for h in through["hits"]["hits"]] == \
        [(h["_id"], h["_score"]) for h in pre["hits"]["hits"]]


def test_pit_knn_runs_on_the_stacked_step(tmp_path):
    node = TorchNode(tmp_path, device="cpu")
    _seed_logs(node, 40)
    q = seeded_docs(40)[5]["v"]
    body = {"query": {"knn": {"v": {"vector": q, "k": 10}}}, "size": 10}
    pre = node.search("logs", body)
    pid = node.open_pit("logs", "1m")["pit_id"]
    for h in pre["hits"]["hits"][:4]:
        node.delete_doc("logs", h["_id"])
    node.refresh("logs")
    served0 = distributed_serving.stats["distributed_searches"]
    through = node.search(None, {"pit": {"id": pid}, **body})
    live = node.search("logs", body)
    assert distributed_serving.stats["distributed_searches"] - served0 == 2
    assert [(h["_id"], h["_score"]) for h in through["hits"]["hits"]] == \
        [(h["_id"], h["_score"]) for h in pre["hits"]["hits"]]
    assert [h["_id"] for h in live["hits"]["hits"]][:6] == \
        [h["_id"] for h in pre["hits"]["hits"]][4:]
    # search_after on [_score, _shard_doc] pages the k = 20 kNN
    sort = [{"_score": "desc"}, {"_shard_doc": "asc"}]
    knn20 = {"query": {"knn": {"v": {"vector": q, "k": 20}}}, "sort": sort}
    whole = node.search(None, {"pit": {"id": pid}, **knn20, "size": 20})
    pages, after = [], None
    for _ in range(4):
        extra = {} if after is None else {"search_after": after}
        page = node.search(None, {"pit": {"id": pid}, **knn20, "size": 5,
                                  **extra})
        pages.extend(page["hits"]["hits"])
        after = page["hits"]["hits"][-1]["sort"]
    assert [h["_id"] for h in pages] == \
        [h["_id"] for h in whole["hits"]["hits"]]
    assert len(pages) == 20
    assert [h["_id"] for h in whole["hits"]["hits"]][:10] == \
        [h["_id"] for h in pre["hits"]["hits"]]
    node.close()


def test_knn_scroll_pages_concatenate_to_the_one_shot(tmp_path):
    node = TorchNode(tmp_path, device="cpu")
    _seed_logs(node, 60)
    q = seeded_docs(60)[9]["v"]
    body = {"query": {"knn": {"v": {"vector": q, "k": 40}}}}
    # k a shard over 2 shards: up to 80 hits, as the one-shot size 80 has
    one = node.search("logs", {**body, "size": 80})
    first = node.search("logs", {**body, "size": 10}, scroll="1m")
    pages = _scroll_all(node, first)
    got = [(h["_id"], h["_score"]) for p in pages for h in p["hits"]["hits"]]
    assert got == [(h["_id"], h["_score"]) for h in one["hits"]["hits"]]
    assert [len(p["hits"]["hits"]) for p in pages] == [10] * 6 + [0]
    node.close()


def test_a_closed_context_releases_its_snapshots(tmp_path):
    """No reference to a closed PIT's or scroll's snapshots stays in the
    context registry, the request cache or the shard-mesh registry."""
    node = TorchNode(tmp_path, device="cpu")
    _seed_logs(node, 30)
    q = seeded_docs(30)[2]["v"]
    body = {"query": {"knn": {"v": {"vector": q, "k": 5}}}, "size": 5}
    node.search("logs", body)
    pid = node.open_pit("logs", "1m")["pit_id"]
    first = node.search("logs", {**body, "size": 2}, scroll="1m")
    pinned = [weakref.ref(snap) for ctx in node._reader_contexts.values()
              for snap in ctx["snapshots"]]
    node.delete_doc("logs", "2")
    node.force_merge("logs")
    node.search(None, {"pit": {"id": pid}, **body})
    node.scroll(first["_scroll_id"])
    node.search("logs", {**body, "size": 0})
    node.search("logs", body)   # the live generation's slab evicts the PIT's
    node.close_pit([pid])
    node.clear_scroll(None)
    del first
    gc.collect()
    assert node._reader_contexts == {}
    assert all(r() is None for r in pinned)
    node.close()
