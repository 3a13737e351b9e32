"""Cross-cluster search: a local node federates a remote node over HTTP,
the port's TorchNode against the reference's TpuNode.

tests/test_cross_cluster.py's case runs on each package: a local node
registers the remote under ``cluster.remote.c2.seeds`` and searches
``c2:logs`` and ``logs,c2:logs`` over the remote's HTTP server (each
package's own, on a free port). The two packages' responses are equal,
``took`` left out. Then a cross-cluster kNN: the
remote holds a ``knn_vector`` index, and ``c2:remote-vecs`` through the
local node gives the remote node's own hits, ids equal and l2 scores
equal (the JSON round trip keeps each float), and the reference's hits
to rtol 1e-5 / atol 1e-4 (tests/test_torch_node_knn.py's tolerance).
"""

from __future__ import annotations

import asyncio
import socket
import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu.rest.http import HttpServer as RefHttpServer
from opensearch_tpu_torch.cluster.remote import RemoteClusterService
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.rest import handlers as port_handlers
from opensearch_tpu_torch.rest.http import HttpServer

from test_torch_cluster_data import assert_same

DIM, N_DOCS, K = 8, 50, 5
RTOL, ATOL = 1e-5, 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _RefServer:
    """The reference's server on a free port, on a loop of its own."""

    def __init__(self, node):
        self.srv = RefHttpServer(node, "127.0.0.1", _free_port())
        self.port = self.srv.port
        self.loop = asyncio.new_event_loop()

        def run():
            asyncio.set_event_loop(self.loop)
            try:
                self.loop.run_until_complete(self.srv.serve_forever())
            except RuntimeError:
                pass  # loop.stop() at teardown interrupts serve_forever

        threading.Thread(target=run, daemon=True).start()
        for _ in range(200):
            try:
                with socket.create_connection(("127.0.0.1", self.port), 1):
                    break
            except OSError:
                time.sleep(0.05)

    def stop(self):
        self.loop.call_soon_threadsafe(self.loop.stop)


class _PortServer:
    def __init__(self, node):
        self.srv = HttpServer(node, "127.0.0.1", 0)
        self.srv.start_in_thread()
        self.port = self.srv.port

    def stop(self):
        self.srv.stop_thread()


def _vectors():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((N_DOCS, DIM)).astype(np.float32),
            rng.standard_normal((3, DIM)).astype(np.float32))


def _fill_remote(node):
    node.create_index("logs", {"mappings": {"properties": {
        "msg": {"type": "text"}}}})
    node.index_doc("logs", "r1", {"msg": "remote error event"}, refresh=True)
    node.index_doc("logs", "r2", {"msg": "remote info event"}, refresh=True)
    vecs, _ = _vectors()
    node.create_index("remote-vecs", {
        "settings": {"number_of_shards": 2},
        "mappings": {"properties": {"v": {"type": "knn_vector",
                                          "dimension": DIM}}}})
    node.bulk([("index", {"_index": "remote-vecs", "_id": str(i)},
                {"v": vecs[i].tolist()}) for i in range(N_DOCS)])
    node.refresh("remote-vecs")


def _fill_local(node):
    node.create_index("logs", {"mappings": {"properties": {
        "msg": {"type": "text"}}}})
    node.index_doc("logs", "l1", {"msg": "local error event"}, refresh=True)


def _scenario(local, remote, port: int) -> list:
    """tests/test_cross_cluster.py's steps and the kNN, observed."""
    out = []
    local.put_cluster_settings({"persistent": {"cluster": {"remote": {
        "c2": {"seeds": f"127.0.0.1:{port}"}}}}})
    out.append(local.search("c2:logs", {"query": {"match": {"msg": "error"}}}))
    out.append(local.search("logs,c2:logs",
                            {"query": {"match": {"msg": "event"}}}))
    _, queries = _vectors()
    for q in queries:
        body = {"query": {"knn": {"v": {"vector": q.tolist(), "k": K}}},
                "size": K}
        fed = local.search("c2:remote-vecs", body)
        own = remote.search("remote-vecs", body)
        assert [h["_id"] for h in fed["hits"]["hits"]] == \
            [h["_id"] for h in own["hits"]["hits"]]
        assert [h["_score"] for h in fed["hits"]["hits"]] == \
            [h["_score"] for h in own["hits"]["hits"]]
        assert {h["_index"] for h in fed["hits"]["hits"]} == \
            {"c2:remote-vecs"}
        out.append(fed)
    return out


def _run(tmp_path, node_cls, server_cls, **kw):
    remote = node_cls(tmp_path / "remote", **kw)
    local = node_cls(tmp_path / "local", **kw)
    srv = None
    try:
        _fill_remote(remote)
        _fill_local(local)
        srv = server_cls(remote)
        return _scenario(local, remote, srv.port)
    finally:
        if srv is not None:
            srv.stop()
        remote.close()
        local.close()


def test_cross_cluster_search(tmp_path):
    ref = _run(tmp_path / "ref", TpuNode, _RefServer)
    port = _run(tmp_path / "port", TorchNode, _PortServer, device="cpu")
    # tests/test_cross_cluster.py's assertions, on the port
    assert port[0]["hits"]["total"]["value"] == 1
    assert port[0]["hits"]["hits"][0]["_index"] == "c2:logs"
    assert port[0]["_clusters"]["successful"] == 1
    assert port[1]["hits"]["total"]["value"] == 3
    assert {h["_index"] for h in port[1]["hits"]["hits"]} == {
        "logs", "c2:logs"}
    assert port[1]["_clusters"]["total"] == 2
    assert_same(ref[:2], port[:2])
    for a, b in zip(ref[2:], port[2:]):
        assert [h["_id"] for h in a["hits"]["hits"]] == \
            [h["_id"] for h in b["hits"]["hits"]]
        np.testing.assert_allclose(
            [h["_score"] for h in b["hits"]["hits"]],
            [h["_score"] for h in a["hits"]["hits"]], rtol=RTOL, atol=ATOL)
        assert a["_clusters"] == b["_clusters"]


def test_remote_info_lists_the_registered_seeds(tmp_path):
    node = TorchNode(tmp_path, device="cpu")
    try:
        node.put_cluster_settings({"persistent": {"cluster": {"remote": {
            "c2": {"seeds": "127.0.0.1:9"}}}}})
        assert RemoteClusterService(node).registered() == {
            "c2": ["127.0.0.1:9"]}
        status, info = port_handlers.remote_info(node, {}, {}, None)
        assert status == 200
        assert info["c2"]["seeds"] == ["127.0.0.1:9"]
        assert info["c2"]["connected"] is True
    finally:
        node.close()
