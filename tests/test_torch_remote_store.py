"""The remote segment store: TorchNode against TpuNode.

tests/test_remote_store.py's case runs on a TpuNode and a
TorchNode(device="cpu"), each with its own object-store directory: sync,
stats, a total loss of the node's data directory, then a restore from the
store; each step's observations must be equal (tolerance 0: ids, counts,
sources). Then a `knn_vector` index (data from a numpy seed) restored
after its data directory is removed: its kNN hits are the reference's
(ids exact, l2 scores to rtol 1e-5 / atol 1e-4, the tolerance
tests/test_torch_node_knn.py states) and the port's are its own hits of
before the loss bit for bit, from segments that carry the vector column
and its norms (`pack_segment` / `unpack_segment`), so the first kNN needs
no rebuild. The store's REST handlers answer as the reference's.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu.rest import handlers as ref_handlers
from opensearch_tpu_torch.index.segment import pack_segment, unpack_segment
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.rest import handlers as port_handlers

from test_torch_scroll_pit import Pair, observe

DIM = 8
VEC_MAPPING = {"properties": {
    "v": {"type": "knn_vector", "dimension": DIM, "space_type": "l2"},
    "n": {"type": "long"}}}


def _restart_pair(tmp_path, wipe: bool) -> Pair:
    if wipe:
        for side in ("ref", "port"):
            shutil.rmtree(tmp_path / side)
    return Pair(tmp_path, TpuNode(tmp_path / "ref"),
                TorchNode(tmp_path / "port", device="cpu"))


def _register(pair: Pair, tmp_path) -> None:
    for node, side in ((pair.ref, "ref"), (pair.port, "port")):
        node.snapshots.put_repository("objstore", {
            "type": "fs",
            "settings": {"location": str(tmp_path / "remote" / side)}})


def test_remote_store_sync_and_restore(tmp_path):
    pair = Pair(tmp_path)
    _register(pair, tmp_path)

    def before(n):
        n.create_index("rs", {
            "settings": {"index.remote_store.enabled": True,
                         "index.remote_store.segment.repository":
                             "objstore"},
            "mappings": {"properties": {"msg": {"type": "text"}}},
        })
        for i in range(5):
            n.index_doc("rs", str(i), {"msg": f"event {i}"}, refresh=True)
        shards = n.remote_store.sync_index("rs")
        assert shards and shards[0]["segments_uploaded"] >= 1
        stats = n.remote_store.stats("rs")
        assert stats["rs"]["shards"]["0"]["segments_uploaded"] >= 1
        return [shards, stats]

    pair.flow(before)
    pair.close()
    # simulate total local data loss, keep only the remote objects
    pair = _restart_pair(tmp_path, wipe=True)
    _register(pair, tmp_path)
    try:
        def after(n):
            # index gone locally
            assert "rs" not in n.indices
            out = n.remote_store.restore(["rs"])
            assert out["indices"] == ["rs"]
            r = n.search("rs", {"query": {"match": {"msg": "event"}}})
            assert r["hits"]["total"]["value"] == 5
            got = n.get_doc("rs", "3")
            assert got["found"] and got["_source"]["msg"] == "event 3"
            return [out, r, got]

        pair.flow(after)
    finally:
        pair.close()


def _vectors(n, seed=21):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, DIM)).astype(np.float32).round(3)


def _knn(vec, k=5):
    return {"query": {"knn": {"v": {"vector": list(map(float, vec)),
                                    "k": k}}}, "size": k}


def _hits(resp):
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


def test_knn_index_restored_after_its_data_directory_is_removed(tmp_path):
    vecs = _vectors(80)
    rng = np.random.default_rng(4)
    qs = vecs[rng.choice(80, 6, replace=False)] + \
        0.05 * rng.standard_normal((6, DIM)).astype(np.float32)
    pair = Pair(tmp_path)
    _register(pair, tmp_path)
    seen = {}

    def before(n):
        n.create_index("vrs", {
            "settings": {"number_of_shards": 2,
                         "index.remote_store.enabled": True,
                         "index.remote_store.segment.repository":
                             "objstore"},
            "mappings": VEC_MAPPING})
        # two refreshes: two segments a shard, one with a deleted doc
        for lo, hi in ((0, 50), (50, 80)):
            n.bulk([("index", {"_index": "vrs", "_id": f"d{i}"},
                     {"v": vecs[i].tolist(), "n": i})
                    for i in range(lo, hi)], refresh=True)
        n.delete_doc("vrs", "d3", refresh=True)
        out = [n.remote_store.sync_index("vrs")]
        out += [n.search("vrs", _knn(q, k)) for q in qs for k in (5, 30)]
        seen[n is pair.port] = [_hits(r) for r in out[1:]]
        return out

    pair.flow(before)
    dev_before = {
        sid: [(h.name, d.vector_fields["v"].vectors.clone(),
               d.vector_fields["v"].norms_sq.clone(), d.live.clone())
              for h, d in sh.acquire_searcher().segments]
        for sid, sh in pair.port.indices["vrs"].shards.items()}
    pair.close()
    pair = _restart_pair(tmp_path, wipe=True)
    _register(pair, tmp_path)
    try:
        def after(n):
            out = [n.remote_store.restore(["vrs"])]
            out += [n.search("vrs", _knn(q, k)) for q in qs
                    for k in (5, 30)]
            assert "d3" not in {h["_id"] for r in out[1:]
                                for h in r["hits"]["hits"]}
            return out

        port = pair.flow(after)
        assert [_hits(r) for r in port[1:]] == seen[True]
        # the restored device columns are the uploaded ones: vectors,
        # norms and the live mask, segment by segment
        for sid, sh in pair.port.indices["vrs"].shards.items():
            segs = sh.acquire_searcher().segments
            assert [h.name for h, _d in segs] == \
                [name for name, *_ in dev_before[sid]]
            for (_h, d), (_n, v, nrm, live) in zip(segs, dev_before[sid]):
                vf = d.vector_fields["v"]
                assert torch.equal(vf.vectors, v)
                assert torch.equal(vf.norms_sq, nrm)
                assert torch.equal(d.live, live)
    finally:
        pair.close()


def test_packed_segment_carries_the_vector_column(tmp_path):
    node = TorchNode(tmp_path, device="cpu")
    vecs = _vectors(20)
    node.create_index("p", {"mappings": VEC_MAPPING})
    node.bulk([("index", {"_index": "p", "_id": str(i)},
                {"v": vecs[i].tolist(), "n": i}) for i in range(20)],
              refresh=True)
    (host, _dev), = node.indices["p"].shards[0].acquire_searcher().segments
    back = unpack_segment(pack_segment(host))
    assert back.name == host.name and back.doc_ids == host.doc_ids
    assert back.vector_fields.keys() == host.vector_fields.keys() == {"v"}
    for field, col in host.vector_fields.items():
        got = back.vector_fields[field]
        np.testing.assert_array_equal(got.vectors, col.vectors)
        np.testing.assert_array_equal(got.present, col.present)
        assert (got.dims, got.similarity) == (col.dims, col.similarity)
    node.close()


def test_remote_store_handlers_are_the_references(tmp_path):
    pair = Pair(tmp_path)
    _register(pair, tmp_path)
    try:
        for n in pair.nodes:
            n.create_index("vrs", {
                "settings": {"index.remote_store.enabled": True,
                             "index.remote_store.segment.repository":
                                 "objstore"},
                "mappings": VEC_MAPPING})
            n.create_index("plain", {"mappings": VEC_MAPPING})
            n.bulk([("index", {"_index": "vrs", "_id": str(i)},
                     {"v": _vectors(4)[i].tolist()}) for i in range(4)],
                   refresh=True)

        def calls(n):
            mod = ref_handlers if n is pair.ref else port_handlers

            def h(name, params, body=None):
                return observe(lambda: getattr(mod, name)(n, params, {},
                                                          body))

            return [h("remotestore_sync", {"index": "vrs"}),
                    h("remotestore_sync", {"index": "plain"}),
                    h("remotestore_sync", {"index": "nope"}),
                    h("remotestore_stats", {"index": "vrs"}),
                    h("remotestore_stats", {"index": "plain"}),
                    h("remotestore_restore", {}, {}),
                    h("remotestore_restore", {}, {"indices": "nope"}),
                    h("remotestore_restore", {}, {"indices": "vrs"}),
                    h("remotestore_stats", {"index": "vrs"})]

        out = pair.flow(calls)
        assert out[5][:3] == ("error", "IllegalArgumentException", 400)
        assert out[6][:3] == ("error", "ResourceNotFoundException", 404)
    finally:
        pair.close()
