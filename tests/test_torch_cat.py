"""The `_cat` tables on the port against the reference.

Every ported `_cat` handler (indices, health, shards, count, aliases,
allocation, nodes, master / cluster_manager, nodeattrs, plugins,
templates, thread_pool, segments, tasks, fielddata and the `/_cat` help)
on a TpuNode and a TorchNode(device="cpu") that took the same writes,
aliases and templates, under the table options (`v`, `h`, `s`, `help`,
`format=json`, `bytes`, `health`, `expand_wildcards`): the text must be
equal with the volatile columns masked (tests/test_torch_rest.py
`masked_cat`: index uuids, clocks, the host's load, memory, cpu and disk
figures, byte sizes and running times), a JSON table equal with the
same columns left out (uuid, creation dates, epoch and timestamp, pid,
store and segment sizes), and errors equal by class, status and
message.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.rest import handlers as ref_handlers
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.rest import handlers as port_handlers

from test_torch_rest import masked_cat
from test_torch_scroll_pit import Pair, observe

DIM = 4


def _h(node):
    return port_handlers if isinstance(node, TorchNode) else ref_handlers


def _seed(node):
    rng = np.random.default_rng(29)
    vecs = rng.standard_normal((30, DIM)).astype(np.float32).round(3)
    mapping = {"properties": {
        "v": {"type": "knn_vector", "dimension": DIM},
        "tag": {"type": "keyword"},
        "title": {"type": "text", "fielddata": True}}}
    node.create_index("idx-a", {"settings": {"number_of_shards": 2},
                                "mappings": mapping})
    node.create_index("idx-b", {"settings": {"number_of_replicas": 0},
                                "mappings": mapping})
    node.create_index(".hid", {"settings": {"index": {"hidden": True}}})
    node.bulk([("index", {"_index": ("idx-a", "idx-b")[i % 2],
                          "_id": str(i)},
                {"v": vecs[i].tolist(), "tag": "t", "title": f"w{i}"})
               for i in range(30)], refresh=True)
    node.update_aliases({"actions": [
        {"add": {"index": "idx-a", "alias": "al", "routing": "1",
                 "is_write_index": True}},
        {"add": {"index": "idx-b", "alias": "al-f",
                 "filter": {"term": {"tag": "t"}}}},
        {"add": {"index": ".hid", "alias": "al-h", "is_hidden": True}}]})
    node.put_index_template("tpl", {"index_patterns": ["idx-*"],
                                    "priority": 3, "composed_of": [],
                                    "version": 2})
    node.put_legacy_template("leg", {"index_patterns": ["x*"], "order": 4})


CAT_CALLS = [
    ("cat_help", {}, {}),
    ("cat_indices", {}, {}),
    ("cat_indices", {}, {"v": "true", "s": "index"}),
    ("cat_indices", {"index": "idx-*"}, {"h": "index,pri,rep,docs.count"}),
    ("cat_indices", {"index": "al"}, {"h": "i,dc"}),
    ("cat_indices", {}, {"expand_wildcards": "all", "s": "index:desc"}),
    ("cat_indices", {"index": ".h*"}, {}),
    ("cat_indices", {}, {"health": "green", "h": "index"}),
    ("cat_indices", {}, {"health": "purple"}),
    ("cat_indices", {}, {"help": "true"}),
    ("cat_health", {}, {}),
    ("cat_health", {}, {"v": "true", "ts": "false"}),
    ("cat_shards", {}, {"s": "index,shard"}),
    ("cat_shards", {"index": "idx-a"}, {"v": "true", "h": "i,s,p,st,d"}),
    ("cat_count", {}, {}),
    ("cat_count", {"index": "idx-b"}, {"v": "true"}),
    ("cat_aliases", {}, {"v": "true"}),
    ("cat_aliases", {}, {"expand_wildcards": "open"}),
    ("cat_aliases", {"name": "al*"}, {"h": "a,i,f"}),
    ("cat_allocation", {}, {"h": "shards,host,ip,node"}),
    ("cat_allocation", {"node_id": "_master"}, {"v": "true"}),
    ("cat_nodes", {}, {"h": "ip,node.role,node.roles,cluster_manager,name"}),
    ("cat_nodes", {}, {"help": "true"}),
    ("cat_master", {}, {"v": "true"}),
    ("cat_nodeattrs", {}, {"v": "true"}),
    ("cat_nodeattrs", {}, {"help": "true"}),
    ("cat_plugins", {}, {"v": "true"}),
    ("cat_templates", {}, {"v": "true", "s": "name"}),
    ("cat_templates", {"name": "t*"}, {}),
    ("cat_thread_pool", {}, {}),
    ("cat_thread_pool", {"pattern": "s*"}, {"v": "true",
                                            "h": "name,active,twt"}),
    ("cat_segments", {}, {"v": "true"}),
    ("cat_segments", {"index": "idx-b"}, {"h": "index,shard,docs.count"}),
    ("cat_segments", {}, {"help": "true"}),
    ("cat_tasks", {}, {"h": "action,type,ip,node"}),
    ("cat_fielddata", {}, {"v": "true"}),
    ("cat_fielddata", {"fields": "title"}, {}),
]


@pytest.mark.parametrize("name,params,query", CAT_CALLS,
                         ids=[f"{i}-{n}" for i, (n, _p, _q)
                              in enumerate(CAT_CALLS)])
def test_cat_table_is_the_references(pair, name, params, query):
    def scenario(node):
        _seed(node)
        got = observe(lambda: getattr(_h(node), name)(
            node, dict(params), dict(query), None))
        if got[0] == "ok":
            return [got[1][0], masked_cat(got[1][1])]
        return [got]

    out = pair.flow(scenario)
    if out[0] == 200 and name != "cat_tasks":
        assert out[1], name  # a table, not an empty answer


@pytest.mark.parametrize("name,params", [
    ("cat_indices", {}), ("cat_shards", {"index": "idx-a"}),
    ("cat_segments", {}), ("cat_aliases", {}), ("cat_templates", {}),
    ("cat_count", {}), ("cat_health", {}), ("cat_thread_pool", {}),
])
def test_cat_json_is_the_references(pair, name, params):
    def scenario(node):
        _seed(node)
        status, rows = getattr(_h(node), name)(
            node, dict(params), {"format": "json"}, None)
        drop = {"uuid", "creation.date", "creation.date.string", "epoch",
                "timestamp", "pid", "store.size", "pri.store.size", "store",
                "size", "size.memory"}
        return [status, [{k: v for k, v in r.items() if k not in drop}
                         for r in rows]]

    out = pair.flow(scenario)
    assert out[0] == 200 and out[1]


def test_cat_indices_over_http_masks_nothing_else(tmp_path):
    """One table through the port's HTTP server: text/plain, and the
    rows the handler renders."""
    import http.client

    from opensearch_tpu_torch.rest.http import HttpServer

    node = TorchNode(tmp_path, device="cpu")
    srv = HttpServer(node, "127.0.0.1", 0)
    srv.start_in_thread()
    try:
        _seed(node)
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("GET", "/_cat/indices?v=true&s=index&h=index,docs.count")
        resp = conn.getresponse()
        text = resp.read().decode()
        assert resp.status == 200
        assert resp.getheader("content-type").startswith("text/plain")
        assert text.splitlines() == ["index docs.count",
                                     "idx-a         15",
                                     "idx-b         15"]
    finally:
        srv.stop_thread()
        node.close()


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()
