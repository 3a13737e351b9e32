"""_reindex, _update_by_query and _delete_by_query: TorchNode against
TpuNode.

The 20 cases of tests/test_reindex.py run on a TpuNode and a
TorchNode(device="cpu") through :class:`test_torch_scroll_pit.Pair`, each
package calling its own reindex module: each scenario's observations (the
responses less `took`, counts, sources, or an error's class, status and
message) must be equal, tolerance 0. Then the slice's own cases, data made
from a numpy seed, l2 scores compared to rtol 1e-5 / atol 1e-4 (the
tolerance tests/test_torch_node_knn.py states) against the reference and
bit for bit within the port: a `knn_vector` index reindexed into a
pre-created copy (its kNN hits the source's), an `_update_by_query` whose
scripted tag filters a kNN, a `_delete_by_query` whose deleted ids never
come back from a kNN on the stacked step or on the per-shard route (the
deletes reach K1's dead-doc mask), a task cancelled mid-scan that leaves
no scroll context open, and the REST handlers of the three routes.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu import reindex as ref_reindex
from opensearch_tpu.node import TpuNode
from opensearch_tpu.rest import handlers as ref_handlers
from opensearch_tpu_torch import reindex as port_reindex
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.ops import knn_fused
from opensearch_tpu_torch.rest import handlers as port_handlers
from opensearch_tpu_torch.search import distributed_serving

from test_torch_scroll_pit import Pair, observe

DIM = 8


def _src(n) -> None:
    """tests/test_reindex.py's fixture."""
    n.create_index("src", {"mappings": {"properties": {
        "tag": {"type": "keyword"}, "n": {"type": "long"}}}})
    for i in range(25):
        n.index_doc("src", str(i), {"tag": "even" if i % 2 == 0 else "odd",
                                    "n": i})
    n.refresh("src")


class Both:
    """A Pair whose scenarios take (node, that package's reindex module)."""

    def __init__(self, pair: Pair):
        self.pair = pair

    def mod(self, node):
        return port_reindex if node is self.pair.port else ref_reindex

    def flow(self, scenario) -> list:
        return self.pair.flow(lambda n: scenario(n, self.mod(n)))


@pytest.fixture()
def both(tmp_path):
    p = Pair(tmp_path)
    for n in p.nodes:
        _src(n)
    yield Both(p)
    p.close()


# ---------------------------------------------------------------------------
# tests/test_reindex.py
# ---------------------------------------------------------------------------


class TestReindex:
    def test_full_copy(self, both):
        def scenario(node, rx):
            res = rx.reindex(node, {"source": {"index": "src"},
                                    "dest": {"index": "dst"}})
            assert res["total"] == 25 and res["created"] == 25
            assert not res["failures"]
            node.refresh("dst")
            assert node.count("dst")["count"] == 25
            return [res, node.count("dst")]

        both.flow(scenario)

    def test_query_filtered(self, both):
        def scenario(node, rx):
            res = rx.reindex(node, {
                "source": {"index": "src",
                           "query": {"term": {"tag": "even"}}},
                "dest": {"index": "evens"},
            })
            assert res["created"] == 13
            node.refresh("evens")
            assert node.count("evens")["count"] == 13
            return [res]

        both.flow(scenario)

    def test_max_docs_and_batches(self, both):
        def scenario(node, rx):
            res = rx.reindex(node, {
                "source": {"index": "src", "size": 10},
                "dest": {"index": "some"},
                "max_docs": 15,
            })
            assert res["total"] == 15 and res["batches"] >= 2
            return [res]

        both.flow(scenario)

    def test_script_transform_and_noop(self, both):
        def scenario(node, rx):
            res = rx.reindex(node, {
                "source": {"index": "src"},
                "dest": {"index": "scripted"},
                "script": {"source": (
                    "if (ctx._source.n < 5) { ctx.op = 'noop' } "
                    "else { ctx._source.tag = 'big' }"
                )},
            })
            assert res["noops"] == 5 and res["created"] == 20
            node.refresh("scripted")
            hit = node.search("scripted", {
                "size": 1, "query": {"ids": {"values": ["7"]}}})
            assert hit["hits"]["hits"][0]["_source"]["tag"] == "big"
            return [res, hit]

        both.flow(scenario)

    def test_op_type_create_conflicts(self, both):
        def scenario(node, rx):
            node.index_doc("dst2", "3", {"tag": "pre", "n": -1})
            node.refresh("dst2")
            res = rx.reindex(node, {
                "conflicts": "proceed",
                "source": {"index": "src"},
                "dest": {"index": "dst2", "op_type": "create"},
            })
            assert res["version_conflicts"] == 1
            assert res["created"] == 24
            return [res]

        both.flow(scenario)

    def test_missing_args(self, both):
        out = both.flow(lambda node, rx: [observe(lambda: rx.reindex(
            node, {"source": {"index": "src"}, "dest": {}}))])
        assert out[0][:3] == ("error", "IllegalArgumentException", 400)

    def test_runs_as_task(self, both):
        def scenario(node, rx):
            rx.reindex(node, {"source": {"index": "src"},
                              "dest": {"index": "t"}})
            # task unregistered after completion
            got = node.task_manager.list_tasks("indices:data/write/reindex")
            assert got == []
            return [len(got)]

        both.flow(scenario)

    def test_source_equals_dest_rejected(self, both):
        def scenario(node, rx):
            out = [observe(lambda: rx.reindex(node, {
                "source": {"index": "src"}, "dest": {"index": "src"}}))]
            # ...including through a write alias of the source
            node.put_alias("src", "src-w")
            out.append(observe(lambda: rx.reindex(node, {
                "source": {"index": "src"}, "dest": {"index": "src-w"}})))
            return out

        out = both.flow(scenario)
        assert [o[:3] for o in out] == [
            ("error", "IllegalArgumentException", 400)] * 2


def _scan_then_modify(node):
    """tests/test_reindex.py's: wrap node.search so the doc is modified
    right after the scroll pins its snapshot."""
    orig_search = node.search

    def patched(index=None, body=None, scroll=None, **kw):
        resp = orig_search(index, body, scroll=scroll, **kw)
        if scroll is not None:
            node.index_doc("src", "0", {"tag": "modified", "n": 0})
            node.search = orig_search
        return resp

    node.search = patched
    return patched


class TestDeleteByQueryCAS:
    def test_stale_scan_does_not_destroy_newer_write(self, both):
        def scenario(node, rx):
            _scan_then_modify(node)
            res = rx.delete_by_query(node, "src", {
                "query": {"ids": {"values": ["0"]}}}, conflicts="proceed",
                refresh=True)
            assert res["version_conflicts"] == 1 and res["deleted"] == 0
            got = node.get_doc("src", "0")
            assert got["found"] and got["_source"]["tag"] == "modified"
            return [res, got]

        both.flow(scenario)


class TestUpdateByQuery:
    def test_script_update(self, both):
        def scenario(node, rx):
            res = rx.update_by_query(node, "src", {
                "query": {"term": {"tag": "odd"}},
                "script": {"source": "ctx._source.n = ctx._source.n * 100"},
            }, refresh=True)
            assert res["updated"] == 12
            out = node.search("src", {"size": 1,
                                      "query": {"ids": {"values": ["3"]}}})
            assert out["hits"]["hits"][0]["_source"]["n"] == 300
            return [res, out]

        both.flow(scenario)

    def test_delete_op_via_script(self, both):
        def scenario(node, rx):
            res = rx.update_by_query(node, "src", {
                "query": {"term": {"tag": "even"}},
                "script": {"source": "ctx.op = 'delete'"},
            }, refresh=True)
            assert res["deleted"] == 13
            assert node.count("src")["count"] == 12
            return [res]

        both.flow(scenario)

    def test_no_script_reindexes_in_place(self, both):
        def scenario(node, rx):
            res = rx.update_by_query(node, "src",
                                     {"query": {"match_all": {}}},
                                     refresh=True)
            assert res["updated"] == 25 and res["version_conflicts"] == 0
            return [res]

        both.flow(scenario)


class TestDeleteByQuery:
    def test_delete_matching(self, both):
        def scenario(node, rx):
            res = rx.delete_by_query(node, "src", {
                "query": {"range": {"n": {"gte": 20}}}}, refresh=True)
            assert res["deleted"] == 5
            assert node.count("src")["count"] == 20
            return [res]

        both.flow(scenario)

    def test_requires_query(self, both):
        out = both.flow(lambda node, rx: [observe(
            lambda: rx.delete_by_query(node, "src", {}))])
        assert out[0][:3] == ("error", "IllegalArgumentException", 400)

    def test_max_docs(self, both):
        def scenario(node, rx):
            res = rx.delete_by_query(node, "src", {
                "query": {"match_all": {}}, "max_docs": 7}, refresh=True)
            assert res["deleted"] == 7
            assert node.count("src")["count"] == 18
            return [res]

        both.flow(scenario)


class TestRoutingPreserved:
    """The reindex family carries _routing so routed docs are CAS-checked
    and re-written on their owning shard."""

    @pytest.fixture()
    def routed(self, tmp_path):
        p = Pair(tmp_path)
        for n in p.nodes:
            n.create_index("r_src", {"settings": {"number_of_shards": 4},
                                     "mappings": {"properties": {
                                         "n": {"type": "long"}}}})
            for i in range(12):
                n.index_doc("r_src", f"d{i}", {"n": i}, routing="rk")
            n.refresh("r_src")
        yield Both(p)
        p.close()

    def test_search_hits_expose_routing(self, routed):
        def scenario(node, rx):
            resp = node.search("r_src", {"query": {"match_all": {}},
                                         "size": 5})
            for hit in resp["hits"]["hits"]:
                assert hit["_routing"] == "rk"
            return [resp]

        routed.flow(scenario)

    def test_get_exposes_routing(self, routed):
        def scenario(node, rx):
            got = node.get_doc("r_src", "d0", routing="rk")
            assert got["found"] and got["_routing"] == "rk"
            return [got]

        routed.flow(scenario)

    def test_delete_by_query_routed(self, routed):
        def scenario(node, rx):
            res = rx.delete_by_query(node, "r_src",
                                     {"query": {"range": {"n": {"lt": 6}}}},
                                     refresh=True)
            assert res["deleted"] == 6 and not res["failures"]
            assert res["version_conflicts"] == 0
            assert node.count("r_src")["count"] == 6
            return [res]

        routed.flow(scenario)

    def test_update_by_query_routed(self, routed):
        def scenario(node, rx):
            res = rx.update_by_query(
                node, "r_src",
                {"script": {"source": "ctx._source.n = ctx._source.n + 100"}},
                refresh=True,
            )
            assert res["updated"] == 12 and not res["failures"]
            # no duplicate copies on the _id-hashed shard
            assert node.count("r_src")["count"] == 12
            got = node.get_doc("r_src", "d3", routing="rk")
            assert got["_source"]["n"] == 103
            return [res, got]

        routed.flow(scenario)

    def test_reindex_routed(self, routed):
        def scenario(node, rx):
            res = rx.reindex(node, {"source": {"index": "r_src"},
                                    "dest": {"index": "r_dst"}},
                             refresh=True)
            assert res["created"] == 12
            # the copy is addressable with the original routing key
            got = node.get_doc("r_dst", "d1", routing="rk")
            assert got["found"] and got["_source"]["n"] == 1
            assert got["_routing"] == "rk"
            return [res, got]

        routed.flow(scenario)


# ---------------------------------------------------------------------------
# kNN over reindexed and by-query-updated indices
# ---------------------------------------------------------------------------

VEC_MAPPING = {"properties": {
    "v": {"type": "knn_vector", "dimension": DIM, "space_type": "l2"},
    "tag": {"type": "keyword"}, "n": {"type": "long"}}}
N_VECS = 120


def _vectors(n=N_VECS, seed=13):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, DIM)).astype(np.float32).round(3)


def _queries(vecs, n=6, seed=29):
    rng = np.random.default_rng(seed)
    return vecs[rng.choice(len(vecs), n, replace=False)] + \
        0.05 * rng.standard_normal((n, DIM)).astype(np.float32)


def _knn(vec, k=10, **extra):
    return {"query": {"knn": {"v": {"vector": list(map(float, vec)),
                                    "k": k, **extra}}}, "size": k}


def _hits(resp):
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


@pytest.fixture()
def vec_both(tmp_path):
    p = Pair(tmp_path)
    vecs = _vectors()
    for n in p.nodes:
        n.create_index("vsrc", {"settings": {"number_of_shards": 2},
                                "mappings": VEC_MAPPING})
        n.bulk([("index", {"_index": "vsrc", "_id": f"d{i}"},
                 {"v": vecs[i].tolist(), "tag": "plain", "n": i})
                for i in range(N_VECS)], refresh=True)
        n.create_index("vcopy", {"settings": {"number_of_shards": 2},
                                 "mappings": VEC_MAPPING})
    b = Both(p)
    b.vecs = vecs
    yield b
    p.close()


def _count_k1(monkeypatch) -> list:
    calls = []
    scan = knn_fused.pool_scan
    monkeypatch.setattr(knn_fused, "pool_scan",
                        lambda *a, **k: calls.append(1) or scan(*a, **k))
    return calls


def test_knn_vector_reindex(vec_both, monkeypatch):
    qs = _queries(vec_both.vecs)
    calls = _count_k1(monkeypatch)
    seen = {}

    def scenario(node, rx):
        out = [rx.reindex(node, {"source": {"index": "vsrc", "size": 50},
                                 "dest": {"index": "vcopy"}}, refresh=True)]
        src = [node.search("vsrc", _knn(q)) for q in qs]
        calls.clear()
        copy = [node.search("vcopy", _knn(q)) for q in qs]
        seen[node is vec_both.pair.port] = (src, copy, len(calls))
        return out + copy

    out = vec_both.flow(scenario)
    assert out[0]["created"] == N_VECS and out[0]["batches"] == 3
    src, copy, k1 = seen[True]
    # the copy holds the source's vectors: its hits are the source's, ids
    # and scores bit for bit, each one K1 launch on the stacked step
    assert [_hits(r) for r in copy] == [_hits(r) for r in src]
    assert k1 == len(qs)


def test_update_by_query_tag_filters_a_knn(vec_both, monkeypatch):
    qs = _queries(vec_both.vecs)
    calls = _count_k1(monkeypatch)
    seen = {}

    def scenario(node, rx):
        rx.reindex(node, {"source": {"index": "vsrc"},
                          "dest": {"index": "vcopy"}}, refresh=True)
        out = [rx.update_by_query(node, "vcopy", {
            "query": {"range": {"n": {"gte": 30, "lt": 75}}},
            "script": {"source": "ctx._source.tag = 'picked'"}},
            refresh=True)]
        f0 = distributed_serving.stats["filtered"]
        calls.clear()
        tagged = [node.search("vcopy", _knn(q, filter={
            "term": {"tag": "picked"}})) for q in qs]
        launches = (len(calls), distributed_serving.stats["filtered"] - f0)
        ranged = [node.search("vsrc", _knn(q, filter={
            "range": {"n": {"gte": 30, "lt": 75}}})) for q in qs]
        seen[node is vec_both.pair.port] = (tagged, ranged, launches)
        return out + tagged

    out = vec_both.flow(scenario)
    assert out[0]["updated"] == 45
    tagged, ranged, launches = seen[True]
    assert [_hits(r) for r in tagged] == [_hits(r) for r in ranged]
    assert all(30 <= int(h["_id"][1:]) < 75 for r in tagged
               for h in r["hits"]["hits"])
    # one filtered K1 launch a search on the stacked step
    assert launches == (len(qs), len(qs))


@pytest.mark.parametrize("route", ["stacked", "per_shard"])
def test_deleted_ids_never_come_back_from_a_knn(vec_both, monkeypatch,
                                                route):
    qs = _queries(vec_both.vecs)
    monkeypatch.setattr(distributed_serving, "enabled", route == "stacked")
    calls = _count_k1(monkeypatch)
    seen = {}

    def scenario(node, rx):
        rx.reindex(node, {"source": {"index": "vsrc"},
                          "dest": {"index": "vcopy"}}, refresh=True)
        before = [node.search("vcopy", _knn(q, 20)) for q in qs]
        gone = sorted({h["_id"] for r in before
                       for h in r["hits"]["hits"][::2]})
        out = [rx.delete_by_query(node, "vcopy", {
            "query": {"ids": {"values": gone}}}, refresh=True)]
        d0 = distributed_serving.stats["distributed_searches"]
        calls.clear()
        after = [node.search("vcopy", _knn(q, 20)) for q in qs]
        stacked = distributed_serving.stats["distributed_searches"] - d0
        k1 = len(calls)
        survivors = [node.search("vsrc", _knn(q, 20, filter={
            "bool": {"must_not": {"ids": {"values": gone}}}})) for q in qs]
        seen[node is vec_both.pair.port] = (gone, after, survivors, k1,
                                            stacked)
        return out + after

    out = vec_both.flow(scenario)
    gone, after, survivors, k1, stacked = seen[True]
    assert out[0]["deleted"] == len(gone) > 10
    assert not {h["_id"] for r in after for h in r["hits"]["hits"]} & \
        set(gone)
    assert [_hits(r) for r in after] == [_hits(r) for r in survivors]
    if route == "stacked":
        assert (k1, stacked) == (len(qs), len(qs))
    else:
        # the per-shard route: one K1 launch a shard's segment
        assert stacked == 0 and k1 >= len(qs)


def test_cancelled_scan_leaves_no_scroll_context(both):
    """A task cancelled mid-scan: the scan raises before its next batch,
    the scroll is cleared in its `finally`, and no reader context stays
    open (an open one would pin device snapshots the ledger has freed)."""
    def scenario(node, rx):
        orig = node.scroll

        def cancelling(sid, *a, **kw):
            for task in node.task_manager.list_tasks(rx.service.TASK_REINDEX):
                node.task_manager.cancel(task.id)
            return orig(sid, *a, **kw)

        node.scroll = cancelling
        try:
            got = observe(lambda: rx.reindex(node, {
                "source": {"index": "src", "size": 10},
                "dest": {"index": "dst"}}))
        finally:
            node.scroll = orig
        node.refresh("dst")
        return [got[:3], node.count("dst")["count"],
                len(node._reader_contexts),
                node.task_manager.list_tasks(rx.service.TASK_REINDEX)]

    out = both.flow(scenario)
    assert out[0][:2] == ("error", "TaskCancelledException")
    assert out[1:] == [10, 0, []]


def test_reindex_handlers_are_the_references(vec_both):
    def calls(n):
        mod = ref_handlers if n is vec_both.pair.ref else port_handlers

        def h(name, params, query, body):
            return observe(lambda: getattr(mod, name)(n, params, query,
                                                      body))

        return [
            h("reindex_handler", {}, {"refresh": "true"},
              {"source": {"index": "vsrc", "query": {"range": {
                  "n": {"lt": 40}}}}, "dest": {"index": "vcopy"}}),
            h("reindex_handler", {}, {}, {"source": {"index": "vsrc"},
                                          "dest": {"index": "vsrc"}}),
            h("reindex_handler", {}, {}, None),
            h("update_by_query_handler", {"index": "vcopy"},
              {"refresh": "true", "conflicts": "proceed"},
              {"query": {"term": {"tag": "plain"}},
               "script": {"source": "ctx._source.n += 1000"}}),
            h("update_by_query_handler", {"index": "nope"}, {}, None),
            h("delete_by_query_handler", {"index": "vcopy"},
              {"refresh": "true"}, {"query": {"range": {
                  "n": {"gte": 1020}}}}),
            h("delete_by_query_handler", {"index": "vcopy"}, {}, {}),
            n.count("vcopy"),
            _hits(n.search("vcopy", _knn(vec_both.vecs[5], 10))),
        ]

    out = vec_both.pair.flow(calls)
    assert out[0][1][1]["created"] == 40
    assert out[5][1][1]["deleted"] == 20 and out[7]["count"] == 20


def test_write_pressure_scope_is_per_thread(tmp_path):
    """Concurrent single-doc writes each account their own bytes in their
    own thread's scope (none rides another thread's outer scope), the
    budget returns to 0, and a batch scope accounts its bytes once for
    the writes nested in it."""
    import json
    import sys
    import threading

    node = TorchNode(tmp_path, device="cpu")
    node.create_index("w", {"settings": {"number_of_shards": 2}})
    pressure = node.indexing_pressure
    docs = [{"n": i, "pad": "x" * (i % 7)} for i in range(400)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def write(lo):
            for i in range(lo, len(docs), 8):
                node.index_doc("w", str(i), docs[i])

        threads = [threading.Thread(target=write, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert pressure.current_bytes == 0
    assert pressure.total_bytes == sum(len(json.dumps(d)) for d in docs)
    before = pressure.total_bytes
    with node._write_pressure(1000, "batch"):
        for i in range(5):
            node.delete_doc("w", str(i))
    assert pressure.total_bytes == before + 1000
    assert pressure.current_bytes == 0
    node.refresh("w")
    assert node.count("w")["count"] == len(docs) - 5
    node.close()
