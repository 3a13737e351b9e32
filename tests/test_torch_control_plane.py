"""The control plane on the single node: the 17 routes of the reference's
TpuNode, through both REST routers, on one transcript.

A TpuNode and a TorchNode(device="cpu") take the same writes (a
``knn_vector`` index of 2 shards and 1 replica, docs, a refresh, a second
index closed), then every control-plane route is resolved by each
package's router and its handler called with the same params, query and
body; the (status, body) pairs must be equal. Left out, because they are
read off a clock or a uuid (:data:`VOLATILE`): ``cluster_uuid``,
``ephemeral_id`` (the node's uuid), an index's ``uuid`` and
``creation_date`` settings, ``at`` (an unassigned shard's wall time),
``start_time`` and ``start_time_in_millis`` (the index's creation
clock), and ``cluster_info`` (the host's disk). The voting exclusions
added over POST show up in ``/_cluster/state``'s metadata and leave with
DELETE, the reroute's explanations and state come back, and the shard
routes report the single node's copies.

Each route is also served over the port's HTTP server on one kept-alive
connection, answering 200 with the router's body.
"""

from __future__ import annotations

import http.client
import json

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu.rest import handlers as ref_handlers
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.rest import handlers as port_handlers
from opensearch_tpu_torch.rest.http import HttpServer

DIM, N_DOCS = 4, 12
VOLATILE = {"cluster_uuid", "ephemeral_id", "at", "start_time",
            "start_time_in_millis", "cluster_info", "uuid", "creation_date"}

# (method, path, query, body) in transcript order: all 17 routes
CALLS = [
    ("GET", "/_cluster/state", {}, None),
    ("GET", "/_cluster/state/metadata,routing_table", {}, None),
    ("GET", "/_cluster/state/metadata/docs", {}, None),
    ("GET", "/_cluster/pending_tasks", {}, None),
    ("POST", "/_cluster/voting_config_exclusions",
     {"node_names": "node-1,node-2"}, None),
    ("GET", "/_cluster/state/metadata", {}, None),
    ("DELETE", "/_cluster/voting_config_exclusions", {}, None),
    ("GET", "/_cluster/state/version,metadata", {}, None),
    ("POST", "/_cluster/reroute", {"explain": "true"}, {"commands": [
        {"move": {"index": "docs", "shard": 0, "from_node": "node-0",
                  "to_node": "node-1"}},
        {"allocate_replica": {"index": "docs", "shard": 1,
                              "node": "node-1"}}]}),
    ("POST", "/_cluster/reroute", {"metric": "routing_table"}, None),
    ("GET", "/_cluster/allocation/explain", {}, None),
    ("POST", "/_cluster/allocation/explain", {"include_disk_info": "true"},
     {"index": "docs", "shard": 1, "primary": True}),
    ("GET", "/_shard_stores", {}, None),
    ("GET", "/docs/_shard_stores", {}, None),
    ("GET", "/_recovery", {}, None),
    ("GET", "/docs/_recovery", {"detailed": "true"}, None),
    ("GET", "/_remote/info", {}, None),
    ("GET", "/_cat/recovery", {"v": "true"}, None),
    ("GET", "/_cat/recovery/docs", {"format": "json"}, None),
    ("GET", "/_cat/pending_tasks", {"v": "true"}, None),
]
ROUTES = {
    ("GET", "/_shard_stores"), ("GET", "/{index}/_shard_stores"),
    ("GET", "/_recovery"), ("GET", "/{index}/_recovery"),
    ("GET", "/_cluster/state"), ("GET", "/_cluster/state/{metric}"),
    ("GET", "/_cluster/state/{metric}/{index}"),
    ("GET", "/_cluster/pending_tasks"),
    ("POST", "/_cluster/voting_config_exclusions"),
    ("DELETE", "/_cluster/voting_config_exclusions"),
    ("POST", "/_cluster/reroute"),
    ("GET", "/_cluster/allocation/explain"),
    ("POST", "/_cluster/allocation/explain"),
    ("GET", "/_remote/info"), ("GET", "/_cat/recovery"),
    ("GET", "/_cat/recovery/{index}"), ("GET", "/_cat/pending_tasks"),
}


def strip(obj):
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [strip(v) for v in obj]
    return obj


def _transcript(node) -> None:
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((N_DOCS, DIM)).astype(np.float32)
    node.create_index("docs", {
        "settings": {"number_of_shards": 2, "number_of_replicas": 1},
        "mappings": {"properties": {
            "v": {"type": "knn_vector", "dimension": DIM},
            "tag": {"type": "keyword"}}}})
    node.bulk([("index", {"_index": "docs", "_id": str(i)},
                {"v": vecs[i].tolist(), "tag": f"t{i % 3}"})
               for i in range(N_DOCS)])
    node.refresh("docs")
    node.create_index("shut", {"settings": {"number_of_shards": 1,
                                            "number_of_replicas": 0}})
    node.index_doc("shut", "a", {"tag": "x"}, refresh=True)
    node.close_index("shut")
    # the uuid a node draws at boot: the same on both, so every body that
    # carries it compares whole
    node.cluster_uuid = "control-plane-test"


def _answers(node, router) -> list:
    out = []
    for method, path, query, body in CALLS:
        handler, params = router.resolve(method, path)
        out.append(handler(node, params, dict(query), body))
    return out


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    ref = TpuNode(tmp_path_factory.mktemp("ref"))
    port = TorchNode(tmp_path_factory.mktemp("port"), device="cpu")
    try:
        _transcript(ref)
        _transcript(port)
        yield (_answers(ref, ref_handlers.build_router()),
               _answers(port, port_handlers.build_router()))
    finally:
        ref.close()
        port.close()


def test_the_calls_cover_the_17_routes():
    ref_router = ref_handlers.build_router()
    port_router = port_handlers.build_router()
    assert len(ROUTES) == 17
    for method, path, _q, _b in CALLS:
        ref_handler, ref_params = ref_router.resolve(method, path)
        handler, params = port_router.resolve(method, path)
        assert params == ref_params
        assert handler is getattr(port_handlers, ref_handler.__name__)
    # every route's handler is reached (a handler serves 1-3 routes)
    assert {port_router.resolve(m, t)[0] for m, t in ROUTES} <= {
        port_router.resolve(m, p)[0] for m, p, _q, _b in CALLS}
    assert not hasattr(port_handlers, "UNPORTED_ROUTES")


@pytest.mark.parametrize("i", range(len(CALLS)),
                         ids=[f"{m} {p}" for m, p, _q, _b in CALLS])
def test_route_answers_as_the_reference(answers, i):
    ref, port = answers
    ref_status, ref_body = ref[i]
    status, body = port[i]
    assert status == ref_status == 200
    assert strip(body) == strip(ref_body)


def test_voting_exclusions_and_reroute_reach_the_state(answers):
    _ref, port = answers
    excl = port[5][1]["metadata"]["cluster_coordination"][
        "voting_config_exclusions"]
    assert [e["node_name"] for e in excl] == ["node-1", "node-2"]
    after = port[7][1]
    assert after["metadata"]["cluster_coordination"][
        "voting_config_exclusions"] == []
    assert after["version"] == 3   # each exclusion call bumps the version
    explanations = port[8][1]["explanations"]
    assert [e["command"] for e in explanations] == ["move",
                                                    "allocate_replica"]
    assert all(d["decision"] == "NO" for e in explanations
               for d in e["decisions"])
    routing = port[9][1]["state"]["routing_table"]["indices"]["docs"]
    assert sorted(routing["shards"]) == ["0", "1"]
    assert [c["state"] for c in routing["shards"]["0"]] == [
        "STARTED", "UNASSIGNED"]


def test_routes_over_http_on_one_connection(tmp_path):
    node = TorchNode(tmp_path, device="cpu")
    srv = HttpServer(node, "127.0.0.1", 0)
    srv.start_in_thread()
    try:
        _transcript(node)
        router = port_handlers.build_router()
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        for method, path, query, body in CALLS:
            qs = "&".join(f"{k}={v}" for k, v in query.items())
            conn.request(method, path + (f"?{qs}" if qs else ""),
                         body=json.dumps(body) if body is not None else None,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read()
            assert resp.status == 200, (path, raw)
            handler, params = router.resolve(method, path)
            _s, want = handler(node, params, dict(query), body)
            got = (raw.decode() if isinstance(want, str)
                   else json.loads(raw))
            assert strip(got) == strip(want), path
        conn.close()
    finally:
        srv.stop_thread()
        node.close()
