"""The index registry, restart, flush and force merge: TorchNode against
TpuNode.

Both nodes take the same writes (docs from a numpy seed), `_flush`, and
are closed and reopened on their paths: the indices, their settings,
mappings (a dynamic field too), aliases, doc counts and the persistent
cluster settings come back, and the kNN, lexical and filtered searches
answer as before (the port's kNN bit for bit). Writes after the last flush
come back from the translog. `force_merge` leaves one segment a shard
and the same hits; `flush` and `force_merge` over an alias and their
responses equal the reference's. A deleted index stays deleted. The
reopened port node recovers on its node's device (the CPU here, the card
on the chip), with each recovered segment registered in the residency
ledger under its index and shard.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.telemetry.device_ledger import default_ledger

from test_torch_scroll_pit import Pair, observe, strip_contexts

DIM = 8
MAPPING = {"properties": {"v": {"type": "knn_vector", "dimension": DIM},
                          "color": {"type": "keyword"},
                          "n": {"type": "long"},
                          "body": {"type": "text"}}}


def _docs(n: int, seed: int = 3) -> list[dict]:
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, DIM)).astype(np.float32).round(4)
    words = ("alpha", "beta", "gamma", "delta")
    return [{"v": vecs[i].tolist(), "color": ("red", "blue")[i % 2],
             "n": i, "body": f"{words[i % 4]} {words[(i * 3) % 4]}"}
            for i in range(n)]


def _fill(node) -> None:
    docs = _docs(90)
    node.create_index("ka", {"settings": {"number_of_shards": 2,
                                          "number_of_replicas": 0},
                             "mappings": MAPPING,
                             "aliases": {"ka-red": {"filter": {
                                 "term": {"color": "red"}}}}})
    node.create_index("kb", {"mappings": MAPPING})
    node.bulk([("index", {"_index": "ka", "_id": str(i)}, docs[i])
               for i in range(60)], refresh=True)
    node.bulk([("index", {"_index": "kb", "_id": str(i)}, docs[i])
               for i in range(60, 90)], refresh=True)
    node.bulk([("delete", {"_index": "ka", "_id": str(i)}, None)
               for i in range(0, 60, 7)], refresh=True)
    # a second segment and a dynamic field
    node.index_doc("ka", "extra", {"v": docs[5]["v"], "color": "red",
                                   "n": 999, "added": "dyn"}, refresh=True)
    node.put_cluster_settings({
        "persistent": {"search.max_keep_alive": "2h"},
        "transient": {"indices.requests.cache.size": "1mb"}})


def _searches(node) -> list:
    docs = _docs(90)
    out = []
    for i in (3, 11, 40):
        knn = {"query": {"knn": {"v": {"vector": docs[i]["v"], "k": 6}}},
               "size": 6}
        out.append(node.search("ka", knn))
        out.append(node.search("ka-red", knn))
        out.append(node.search("kb", knn))
    out.append(node.search("ka", {"query": {"match": {"body": "gamma"}},
                                  "size": 20}))
    out.append(node.search("ka", {"query": {"term": {"added": "dyn"}}}))
    out.append(node.count("ka"))
    out.append(node.count("ka-red"))
    return out


def _state(node) -> list:
    return [sorted(node.indices), node.get_alias(),
            node.get_mapping("ka"), node.get_settings("ka,kb"),
            node.get_cluster_settings(flat=True)]


def _knn_bits(resp) -> list:
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


def test_restart_recovers_registry_and_hits(tmp_path):
    pair = Pair(tmp_path)
    for n in pair.nodes:
        _fill(n)
    before = pair.flow(lambda n: _searches(n) + _state(n)
                       + [n.flush("ka"), n.flush()])
    port_before = pair.port.get_settings("ka")["ka"]["settings"]["index"][
        "uuid"]
    pair.close()
    again = Pair(tmp_path)
    try:
        after = again.flow(lambda n: _searches(n) + _state(n))
        # the port's kNN hits are the pre-restart bits
        for b, a in zip(before[:9], after[:9]):
            assert _knn_bits(a) == _knn_bits(b)
        assert strip_contexts(after[:13]) == strip_contexts(before[:13])
        assert after[-1] == {"persistent": {"search.max_keep_alive": "2h"},
                             "transient": {}}
        # a new index uuid: the registry keeps settings, not identity
        assert again.port.get_settings("ka")["ka"]["settings"]["index"][
            "uuid"] != port_before
    finally:
        again.close()


def test_unflushed_writes_come_back_from_the_translog(tmp_path):
    pair = Pair(tmp_path)
    docs = _docs(20)
    for n in pair.nodes:
        n.create_index("t", {"mappings": MAPPING})
        n.bulk([("index", {"_index": "t", "_id": str(i)}, docs[i])
                for i in range(10)], refresh=True)
        n.flush("t")
        n.bulk([("index", {"_index": "t", "_id": str(i)}, docs[i])
                for i in range(10, 20)])
        n.delete_doc("t", "3")
    pair.close()
    again = Pair(tmp_path)
    try:
        out = again.flow(lambda n: [
            n.count("t"), n.get_doc("t", "15"), n.get_doc("t", "3"),
            n.search("t", {"query": {"knn": {"v": {
                "vector": docs[12]["v"], "k": 3}}}})])
        assert out[0]["count"] == 19
        assert out[3]["hits"]["hits"][0]["_id"] == "12"
    finally:
        again.close()


def test_force_merge_and_flush_answer_as_the_reference(tmp_path):
    pair = Pair(tmp_path)
    try:
        for n in pair.nodes:
            _fill(n)
        out = pair.flow(lambda n: [
            _searches(n), n.force_merge("ka", max_num_segments=1),
            n.flush("ka-red"), n.force_merge("_all", flush=False),
            n.force_merge("kb", only_expunge_deletes=True),
            _searches(n)])
        for b, a in zip(out[0][:9], out[-1][:9]):
            assert _knn_bits(a) == _knn_bits(b)
        for shard in pair.port.indices["ka"].shards.values():
            assert len(shard.acquire_searcher().segments) == 1
        errs = pair.flow(lambda n: [observe(lambda: n.flush("nope")),
                                    observe(lambda: n.force_merge("nope"))])
        assert errs[0][1:3] == ("IndexNotFoundException", 404)
    finally:
        pair.close()


def test_deleted_index_stays_deleted(tmp_path):
    pair = Pair(tmp_path)
    for n in pair.nodes:
        _fill(n)
        n.delete_index("kb")
        n.update_aliases({"actions": [{"remove_index": {"index": "ka"}}]})
    pair.close()
    again = Pair(tmp_path)
    try:
        assert again.flow(lambda n: [sorted(n.indices)]) == [[]]
    finally:
        again.close()


def test_recovery_runs_on_the_node_device_under_the_ledger(tmp_path):
    node = TorchNode(tmp_path, device="cpu")
    _fill(node)
    node.flush()
    node.close()
    reopened = TorchNode(tmp_path, device="cpu")
    try:
        devices = {str(seg.vector_fields["v"].vectors.device)
                   for svc in reopened.indices.values()
                   for shard in svc.shards.values()
                   for _h, seg in shard.acquire_searcher().segments}
        assert devices == {"cpu"}
        rows = {(r["index"], r["shard"]) for r in
                (a.row() for a in default_ledger.live_allocations())
                if r["index"] in ("ka", "kb")}
        assert rows >= {("ka", 0), ("ka", 1), ("kb", 0)}
    finally:
        reopened.close()


def test_reopened_node_defaults_to_the_card(tmp_path, monkeypatch):
    import torch

    node = TorchNode(tmp_path, device="cpu")
    node.create_index("x", {})
    node.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchNode(tmp_path)


def test_reference_registry_shape_is_readable(tmp_path):
    """The registry file keeps each index's settings, mappings and aliases
    under the reference's keys."""
    import json

    for cls, kw in ((TpuNode, {}), (TorchNode, {"device": "cpu"})):
        path = tmp_path / cls.__name__
        node = cls(path, **kw)
        _fill(node)
        node.close()
        reg = json.loads((path / "indices.json").read_text())
        assert set(reg) == {"ka", "kb"}
        assert {"settings", "mappings", "aliases"} <= set(reg["ka"])
        assert reg["ka"]["aliases"] == {"ka-red": {"filter": {
            "term": {"color": "red"}}}}
