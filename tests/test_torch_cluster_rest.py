"""The REST surface through a 3-node TCP cluster: the port's ClusterFacade
behind its HttpServer against the reference's.

One cluster of each package for the module (:func:`rest_clusters`: the
reference fixture's index ``items``, 3 shards x 1 replica, its 60 docs
bulked through n1, n0 elected), each node's disk pinned to 50% and the
reference's coordinator with the port's one change
(tests/test_torch_tcp_cluster.py says why). Each of the 18 cases of tests/test_cluster_rest.py runs on the
reference's cluster, then on the port's, as the reference wrote it, so
both pass its assertions (the aggregations against a single-node
reference ``TpuNode`` over the same docs, as that file requires); every
HTTP exchange of the two runs is recorded, and the port's must be the
reference's (:func:`assert_exchanges`): the same requests, in order, with
the same statuses, and bodies equal once the values read off a clock, an
id generator are masked (:data:`VOLATILE`, :data:`TIMING`).

Then the REST layer's repairs for a cluster node: a request through a
``ClusterFacade`` (which has no breakers) is charged to no breaker and
raises nothing, and the cluster branches of rest/handlers.py answer as
the reference's over the two clusters: ``_cat/recovery``, ``_recovery``,
``_nodes/stats/transport``, ``_cat/nodes`` and
``_prometheus/metrics?cluster=true``.
"""

from __future__ import annotations

import asyncio
import importlib
import inspect
import json
import math
import re

import pytest

pytest.importorskip("jax")

from test_torch_tcp_cluster import PACKAGES, boot_cluster, harness, \
    reference_module

REFERENCE = "test_cluster_rest"
CASES = [name for name, fn in vars(importlib.import_module(REFERENCE)).items()
         if name.startswith("test_") and inspect.isfunction(fn)]
# values read off a clock or an id generator
VOLATILE = {
    "took", "time", "epoch", "_scroll_id", "pit_id", "timestamp",
    "start_time",
}
TIMING = re.compile(r"(_nanos|_ns|_ms|_millis|_time|_seconds)$")


class RestClusters:
    def __init__(self, tmp_path):
        self.loop = asyncio.new_event_loop()
        self.ref = importlib.import_module(REFERENCE)
        self.mods = {p: reference_module(p) for p in PACKAGES}
        self._harness = [harness(mod) for mod in self.mods.values()]
        for h in self._harness:
            h.__enter__()
        self.clusters: dict = {}
        try:
            for p, mod in self.mods.items():
                self.clusters[p] = self.loop.run_until_complete(
                    self.boot(mod, tmp_path / p))
        except BaseException:
            self.close()
            raise
        self.ports = {p: dict(c.http_ports) for p, c in self.clusters.items()}

    async def boot(self, mod, tmp_path):
        """The reference fixture's cluster (cluster_ports)."""
        cluster = await boot_cluster(mod, tmp_path)
        http = self.ref.http
        status, resp = await http(
            cluster.http_ports["n0"], "PUT", "/items",
            {"settings": {"number_of_shards": 3, "number_of_replicas": 1},
             "mappings": {"properties": {
                 "title": {"type": "text"},
                 "n": {"type": "long"},
                 "price": {"type": "float"},
                 "tag": {"type": "keyword"},
             }}},
        )
        assert status == 200, resp
        await cluster.wait_health(cluster.http_ports["n0"], "green")
        nd = "".join(
            json.dumps(x) + "\n"
            for i, d in enumerate(self.ref.DOCS)
            for x in ({"index": {"_index": "items", "_id": f"i{i}"}}, d)
        )
        status, resp = await http(
            cluster.http_ports["n1"], "POST", "/_bulk?refresh=true", nd)
        assert status == 200 and not resp["errors"], resp
        return cluster

    def req(self, package: str, nid: str, method: str, path: str,
            body=None):
        return self.loop.run_until_complete(self.ref.http(
            self.ports[package][nid], method, path, body))

    def text(self, package: str, nid: str, path: str) -> str:
        return self.loop.run_until_complete(self.ref._http_text(
            self.ports[package][nid], path))

    def close(self) -> None:
        for cluster in self.clusters.values():
            self.loop.run_until_complete(cluster.stop())
        for h in reversed(self._harness):
            h.__exit__(None, None, None)
        self.loop.close()


@pytest.fixture(scope="module")
def rest_clusters(tmp_path_factory):
    c = RestClusters(tmp_path_factory.mktemp("cluster_rest"))
    yield c
    c.close()


def run_recorded(rc: RestClusters, package: str, case: str, tmp_path):
    """One reference case on ``package``'s cluster; its exchanges."""
    ref = rc.ref
    exchanges: list = []
    http, http_text = ref.http, ref._http_text

    async def recorded(port, method, path, body=None, **kw):
        status, payload = await http(port, method, path, body, **kw)
        exchanges.append((method, path, status, payload))
        return status, payload

    async def recorded_text(port, path, **kw):
        text = await http_text(port, path, **kw)
        exchanges.append(("GET", path, 200, text))
        return text

    mp = pytest.MonkeyPatch()
    mp.setattr(ref, "http", recorded)
    mp.setattr(ref, "_http_text", recorded_text)
    try:
        fn = getattr(ref, case)
        args = {"cluster_ports": (rc.loop, rc.ports[package]),
                "tmp_path": tmp_path}
        fn(**{a: args[a] for a in inspect.signature(fn).parameters})
    finally:
        mp.undo()
    return exchanges


def _masked(key) -> bool:
    return isinstance(key, str) and (key in VOLATILE or bool(TIMING.search(
        key)))


def assert_same_body(ref, port, path="$"):
    """Equal bodies, masked keys left out; floats to rtol 1e-6."""
    if isinstance(ref, dict):
        assert isinstance(port, dict), (path, ref, port)
        rk = {k for k in ref if not _masked(k)}
        pk = {k for k in port if not _masked(k)}
        assert rk == pk, (path, sorted(rk ^ pk, key=str))
        for k in rk:
            assert_same_body(ref[k], port[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(ref) == len(port), (
            path, ref, port)
        for i, (a, b) in enumerate(zip(ref, port)):
            assert_same_body(a, b, f"{path}[{i}]")
    elif isinstance(ref, float) and not isinstance(ref, bool):
        assert isinstance(port, (int, float)), (path, ref, port)
        assert math.isclose(ref, port, rel_tol=1e-6, abs_tol=1e-9), (
            path, ref, port)
    else:
        assert ref == port, (path, ref, port)


def assert_exchanges(ref: list, port: list) -> None:
    assert [e[:3] for e in ref] == [e[:3] for e in port]
    for (method, path, _s, a), (_m, _p, _s2, b) in zip(ref, port):
        where = f"{method} {path}"
        if isinstance(a, str):
            # a Prometheus exposition: each node's registry holds this
            # process's counters, which the earlier cases moved by
            # different amounts; the node labels are the federation's
            assert isinstance(b, str), where
            nodes = {f'node="{n}"' for n in ("n0", "n1", "n2")}
            assert {n for n in nodes if n in a} == \
                {n for n in nodes if n in b}, where
        elif path.startswith("/_nodes/stats") and _s < 400:
            # every node's section, with the reference's keys; the values
            # are this host's and this process's
            assert set(a) == set(b), where
            assert set(a["nodes"]) == set(b["nodes"]), where
            for nid in a["nodes"]:
                assert set(a["nodes"][nid]) == set(b["nodes"][nid]), (
                    where, nid, set(a["nodes"][nid]) ^ set(b["nodes"][nid]))
        else:
            assert_same_body(a, b, where)


@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, rest_clusters, tmp_path):
    runs = {}
    for package in PACKAGES:
        (tmp_path / package).mkdir()
        runs[package] = run_recorded(rest_clusters, package, case,
                                     tmp_path / package)
    assert_exchanges(runs["opensearch_tpu"], runs["opensearch_tpu_torch"])


def test_the_eighteen_cases():
    assert len(CASES) == 18


# -- the REST layer's repairs for a cluster node ------------------------------


def test_facade_request_charges_no_breaker(rest_clusters):
    cluster = rest_clusters.clusters["opensearch_tpu_torch"]
    facade = cluster.servers["n0"].facade
    assert not hasattr(facade, "breakers")
    # a body through the facade: no breaker to charge, nothing raised
    status, resp = rest_clusters.req("opensearch_tpu_torch", "n0", "POST",
                                     "/items/_count",
                                     {"query": {"term": {"tag": "red"}}})
    assert status == 200 and resp["count"] == 20, resp
    # the request's span lands on the facade's telemetry, its node's
    spans = [sp for sp in facade.telemetry.tracer.finished_spans()
             if sp.name == "http_request"
             and sp.attributes.get("path") == "/items/_count"]
    assert spans, "no http_request span on the node's tracer"


def test_dispatch_without_breakers_or_telemetry():
    """HttpServer over a node with neither ``breakers`` nor ``telemetry``
    (the reference's getattr shape): a request is served, charged to
    nothing, under the process's default telemetry."""
    from opensearch_tpu_torch.rest.http import HttpServer
    from opensearch_tpu_torch.tasks.manager import TaskManager

    class Bare:
        node_name = "bare"
        task_manager = TaskManager("bare")

    srv = HttpServer(Bare(), "127.0.0.1", 0)

    def handler(node, params, query, body):
        return 200, {"echo": body}

    srv.router.resolve = lambda method, path: (handler, {})
    try:
        status, payload, ctype = asyncio.run(srv._dispatch(
            "POST", "/x/_doc", {}, b'{"a": 1}'))
    finally:
        asyncio.run(srv.stop())
    assert (status, payload, ctype) == (200, {"echo": {"a": 1}},
                                        "application/json")


@pytest.mark.parametrize("path", [
    "/_cat/recovery?format=json", "/items/_recovery", "/_recovery",
    "/_nodes/stats/transport", "/_cat/nodes?format=json&full_id=true"])
def test_cluster_branch_answers_as_reference(rest_clusters, path):
    ref = rest_clusters.req("opensearch_tpu", "n1", "GET", path)
    port = rest_clusters.req("opensearch_tpu_torch", "n1", "GET", path)
    assert ref[0] == port[0] == 200, (ref, port)
    a, b = ref[1], port[1]
    if path.startswith("/_cat/recovery"):
        rows = [sorted((r["index"], r["shard"], r["type"], r["stage"],
                        r["target_node"]) for r in x) for x in (a, b)]
        assert rows[0] == rows[1]
        assert {r["type"] for r in b} >= {"peer"}
        assert [sorted(r) for r in a] == [sorted(r) for r in b]
    elif path.startswith("/_cat/nodes"):
        # the serving node's row, with the reference's columns and id; the
        # other columns are this host's (heap, load, disk)
        assert [sorted(r) for r in a] == [sorted(r) for r in b]
        assert [(r["id"], r["name"]) for r in a] == \
            [(r["id"], r["name"]) for r in b] == [(r["id"], "n1") for r in b]
    elif "_recovery" in path:
        assert set(a) == set(b) == {"items"}
        recs = [sorted((s["id"], s["type"], s["stage"], s["primary"],
                        s["target"]["id"]) for s in x["items"]["shards"])
                for x in (a, b)]
        assert recs[0] == recs[1]
        assert {"PEER", "EMPTY_STORE"} <= {r[1] for r in recs[1]}
        for sa, sb in zip(sorted(a["items"]["shards"], key=_rec_key),
                          sorted(b["items"]["shards"], key=_rec_key)):
            assert_same_body(sa, sb, path)
    else:
        # the cluster's fan-out (cluster_nodes_stats), filtered to the
        # metric as the reference filters it
        assert set(a["nodes"]) == set(b["nodes"]) == {"n0", "n1", "n2"}
        assert_same_body(a, b, path)


def _rec_key(s: dict) -> tuple:
    return (s["id"], s["type"], s["target"]["id"])


def test_federated_prometheus_answers_as_reference(rest_clusters):
    path = "/_prometheus/metrics?cluster=true"
    texts = {p: rest_clusters.text(p, "n2", path) for p in PACKAGES}
    for p, text in texts.items():
        for nid in ("n0", "n1", "n2"):
            assert f'node="{nid}"' in text, (p, nid)
        # federated: no TYPE comments, every sample labeled by its node
        assert not [ln for ln in text.splitlines() if ln.startswith("#")]
        assert all('node="' in ln for ln in text.splitlines() if ln), p
    tasks = [sorted(ln.split(" ")[0] for ln in text.splitlines()
                    if ln.startswith("opensearch_tpu_tasks_"))
             for text in texts.values()]
    assert tasks[0] == tasks[1]
    single = {p: rest_clusters.text(p, "n2", "/_prometheus/metrics")
              for p in PACKAGES}
    for text in single.values():
        assert "# TYPE opensearch_tpu_tasks_running gauge" in text


# -- three routes that answered 500 through a cluster -------------------------
#
# ``_cat/indices``, ``GET [/{index}]/_alias[/{name}]`` and ``_explain``
# through the port's 3-node cluster equal a single TorchNode's answers on
# the same indices and docs: two indices of this section's own, created
# through the cluster and on the single node alike (the fixture's
# ``items`` is left alone: the reference's cases above write to it). The
# reference's cluster still answers each with a 500 (its facade has no
# ``get_alias`` / ``explain`` and its index view no ``setting``): a stated
# difference, asserted below.

ALIASED = "aliased"
EXPLAINED = "explained"
MINE = (ALIASED, EXPLAINED)
BODIES = {
    ALIASED: {
        "settings": {"number_of_shards": 2, "number_of_replicas": 1},
        "mappings": {"properties": {"title": {"type": "text"}}},
        "aliases": {"read-a": {}, "write-a": {"is_write_index": True},
                    "routed-a": {"routing": "7"}},
    },
    EXPLAINED: {
        "settings": {"number_of_shards": 3, "number_of_replicas": 1},
        "mappings": {"properties": {
            "title": {"type": "text"}, "n": {"type": "long"},
            "tag": {"type": "keyword"}}},
    },
}
DOCS = {
    ALIASED: [(f"a{i}", {"title": f"{w} doc"})
              for i, w in enumerate(("first", "second", "third"))],
    EXPLAINED: [(f"e{i}", {"title": f"doc number {i} "
                           + ("alpha" if i % 3 == 0 else "beta"),
                           "n": i, "tag": ["red", "green", "blue"][i % 3]})
                for i in range(30)],
}
# what a single node and a cluster hold alike: health and the store's
# bytes are each deployment's own (a single node leaves replicas
# unassigned; a cluster's copies and segments are its own)
CAT_INDICES_COLUMNS = ("index", "status", "pri", "rep", "docs.count",
                       "docs.deleted")
# paths naming no index list every index of the cluster, the reference
# cases' too: their answers are compared on this section's indices
ALIAS_PATHS = ("/_alias", f"/{EXPLAINED}/_alias", f"/{ALIASED}/_alias",
               f"/{ALIASED}/_alias/read-a", f"/{ALIASED}/_alias/read-*,-r*",
               "/_alias/write-a,routed-a", f"/{ALIASED}/_alias/missing",
               "/_alias/read-a,missing", f"/{ALIASED},{EXPLAINED}/_alias")
EXPLAIN_BODIES = (
    (EXPLAINED, "e3", {"query": {"match": {"title": "alpha"}}}),
    (EXPLAINED, "e4", {"query": {"match": {"title": "alpha"}}}),
    (EXPLAINED, "e5", {"query": {"term": {"tag": "blue"}}}),
    (EXPLAINED, "e20", {"query": {"range": {"n": {"gte": 10}}}}),
    (EXPLAINED, "nope", {"query": {"match_all": {}}}),
    (EXPLAINED, "e1", {"size": 1}),
    (ALIASED, "a1", {"query": {"match": {"title": "first"}}}),
    ("write-a", "a2", {"query": {"match_all": {}}}),
)


@pytest.fixture(scope="module")
def single_items(rest_clusters, tmp_path_factory):
    """This section's indices on a single TorchNode on the CPU, behind the
    port's HttpServer, and through the port's cluster."""
    from opensearch_tpu_torch.node import TorchNode
    from opensearch_tpu_torch.rest.http import HttpServer

    node = TorchNode(tmp_path_factory.mktemp("single_items"), device="cpu")
    port = "opensearch_tpu_torch"
    cluster = rest_clusters.clusters[port]
    for name in MINE:
        node.create_index(name, BODIES[name])
        node.bulk([("index", {"_index": name, "_id": i}, d)
                   for i, d in DOCS[name]])
        status, resp = rest_clusters.req(port, "n0", "PUT", f"/{name}",
                                         BODIES[name])
        assert status == 200, resp
        rest_clusters.loop.run_until_complete(
            cluster.wait_health(cluster.http_ports["n0"], "green"))
        nd = "".join(json.dumps(x) + "\n" for i, d in DOCS[name]
                     for x in ({"index": {"_index": name, "_id": i}}, d))
        status, resp = rest_clusters.req(port, "n1", "POST",
                                         "/_bulk?refresh=true", nd)
        assert status == 200 and not resp["errors"], resp
    node.refresh("_all")
    server = HttpServer(node, "127.0.0.1", 0)
    server.start_in_thread()
    try:
        yield server.port
    finally:
        server.stop_thread()
        node.close()


def _single(rest_clusters, port, method, path, body=None):
    return rest_clusters.loop.run_until_complete(
        rest_clusters.ref.http(port, method, path, body))


@pytest.mark.parametrize("nid", ["n0", "n1", "n2"])
def test_cat_indices_through_cluster_equals_single_node(rest_clusters,
                                                        single_items, nid):
    path = "/_cat/indices?format=json"
    single = _single(rest_clusters, single_items, "GET", path)
    got = rest_clusters.req("opensearch_tpu_torch", nid, "GET", path)
    assert single[0] == got[0] == 200, (single, got)

    def rows(payload):
        return sorted(tuple(r[c] for c in CAT_INDICES_COLUMNS)
                      for r in payload if r["index"] in MINE)

    assert rows(got[1]) == rows(single[1]) and len(rows(single[1])) == 2
    # every index of the cluster, each green on three nodes
    status, state = rest_clusters.req("opensearch_tpu_torch", nid, "GET",
                                      "/_cluster/state/metadata")
    assert status == 200, state
    assert sorted(r["index"] for r in got[1]) == \
        sorted(state["metadata"]["indices"])
    assert {r["health"] for r in got[1]} == {"green"}


@pytest.mark.parametrize("path", ALIAS_PATHS)
def test_get_alias_through_cluster_equals_single_node(rest_clusters,
                                                      single_items, path):
    single = _single(rest_clusters, single_items, "GET", path)
    for nid in ("n0", "n1", "n2"):
        status, body = rest_clusters.req("opensearch_tpu_torch", nid, "GET",
                                         path)
        if path.startswith("/_alias"):
            # the other indices of the cluster hold no alias
            assert all(body[k] == {"aliases": {}} for k in body
                       if k not in MINE and k not in ("error", "status"))
            body = {k: v for k, v in body.items()
                    if k in MINE or k in ("error", "status")}
        assert (status, body) == single, (nid, path, status, body, single)


@pytest.mark.parametrize("index,doc_id,body", EXPLAIN_BODIES,
                         ids=[f"{i}-{d}" for i, d, _b in EXPLAIN_BODIES])
def test_explain_through_cluster_equals_single_node(rest_clusters,
                                                    single_items, index,
                                                    doc_id, body):
    path = f"/{index}/_explain/{doc_id}"
    single = _single(rest_clusters, single_items, "POST", path, body)
    for nid in ("n0", "n1", "n2"):
        got = rest_clusters.req("opensearch_tpu_torch", nid, "POST", path,
                                body)
        assert got[0] == single[0], (nid, got, single)
        assert_same_body(single[1], got[1], f"{nid} {path}")


def test_reference_cluster_still_answers_500(rest_clusters):
    """The stated difference: the reference's facade keeps the four
    faults the port's repairs."""
    for method, path, body in (
            ("GET", "/_cat/indices?format=json", None),
            ("GET", "/_alias", None),
            ("POST", "/items/_explain/i3",
             {"query": {"match": {"title": "alpha"}}})):
        status, _resp = rest_clusters.req("opensearch_tpu", "n1", method,
                                          path, body)
        assert status == 500, (path, status)
    # DELETE /{index}: the reference's facade takes neither
    # ignore_unavailable nor allow_no_indices, which its handler passes
    for path in ("/no-such-index", "/no-such-*"):
        status, _resp = rest_clusters.req("opensearch_tpu", "n1", "DELETE",
                                          path)
        assert status == 500, (path, status)


def _routing(*copies):
    from opensearch_tpu_torch.cluster.state import ShardRoutingEntry

    return tuple(ShardRoutingEntry("items", shard, node, primary, st, reloc)
                 for shard, node, primary, st, reloc in copies)


# the routing of one 2-shard x 1-replica index at moments the cluster goes
# through, and the health both reads must give it: a replica moving
# (rebalance, drain, disk evacuation) is a started copy and its shadow
HEALTH_MOMENTS = {
    "started": ("green", _routing(
        (0, "n0", True, "STARTED", None), (0, "n1", False, "STARTED", None),
        (1, "n1", True, "STARTED", None), (1, "n2", False, "STARTED", None))),
    "replica_relocating": ("green", _routing(
        (0, "n0", True, "STARTED", None),
        (0, "n1", False, "RELOCATING", "n2"),
        (0, "n2", False, "INITIALIZING", "n1"),
        (1, "n1", True, "STARTED", None), (1, "n2", False, "STARTED", None))),
    "replica_recovering": ("yellow", _routing(
        (0, "n0", True, "STARTED", None),
        (0, "n1", False, "INITIALIZING", None),
        (1, "n1", True, "STARTED", None), (1, "n2", False, "STARTED", None))),
    "replica_unassigned": ("yellow", _routing(
        (0, "n0", True, "STARTED", None), (0, None, False, "UNASSIGNED", None),
        (1, "n1", True, "STARTED", None),
        (1, "n1", False, "RELOCATING", "n2"),
        (1, "n2", False, "INITIALIZING", "n1"))),
    "primary_unassigned": ("red", _routing(
        (0, None, True, "UNASSIGNED", None), (0, "n1", False, "STARTED", None),
        (1, "n1", True, "STARTED", None), (1, "n2", False, "STARTED", None))),
}


@pytest.mark.parametrize("moment", sorted(HEALTH_MOMENTS))
def test_cat_indices_health_is_cluster_healths(moment):
    """``_cat/indices`` through a cluster (``cat_index_summary``) reads an
    index's health by ``_cluster/health``'s rule at every moment of its
    routing, a relocation's included: a relocation target is the moving
    copy's shadow, not a missing copy."""
    from types import SimpleNamespace

    from opensearch_tpu_torch.cluster.cluster_node import ClusterNode
    from opensearch_tpu_torch.cluster.facade import ClusterFacade
    from opensearch_tpu_torch.cluster.state import ClusterState, IndexMeta

    want, routing = HEALTH_MOMENTS[moment]
    state = ClusterState(indices={"items": IndexMeta("items", 2, 1)},
                         routing=routing)
    node = SimpleNamespace(applied_state=state)
    facade = SimpleNamespace(state=state,
                             _rpc_many=lambda calls: [None] * len(calls))
    assert ClusterNode.cluster_health(node)["status"] == want
    assert ClusterFacade.cat_index_summary(facade)["items"]["health"] == want


DOOMED = "doomed"
# DELETE /{index} through a cluster and on a single node: an existing
# index, a missing one with and without ignore_unavailable, a pattern that
# matches nothing with and without allow_no_indices, and an alias
DELETES = (
    f"/{DOOMED}", "/no-such-index", "/no-such-index?ignore_unavailable=true",
    "/no-such-*", "/no-such-*?allow_no_indices=false", "/read-a",
    f"/{DOOMED},no-such-index?ignore_unavailable=true",
)
CAT = "/_cat/indices?format=json"


@pytest.mark.parametrize("path", DELETES)
def test_delete_index_through_cluster_equals_single_node(rest_clusters,
                                                         single_items, path):
    """Each node of the port's 3-node cluster answers DELETE /{index} as a
    single TorchNode does on the same indices (status and body), and an
    index it deletes is gone from both."""
    port = "opensearch_tpu_torch"
    body = {"settings": {"number_of_shards": 2, "number_of_replicas": 1}}
    for nid in ("n0", "n1", "n2"):
        if DOOMED in path:
            assert _single(rest_clusters, single_items, "PUT", f"/{DOOMED}",
                           body)[0] == 200
            status, resp = rest_clusters.req(port, "n0", "PUT", f"/{DOOMED}",
                                             body)
            assert status == 200, resp
        single = _single(rest_clusters, single_items, "DELETE", path)
        got = rest_clusters.req(port, nid, "DELETE", path)
        assert got == single, (nid, path, got, single)
        for status, rows in (
                _single(rest_clusters, single_items, "GET", CAT),
                rest_clusters.req(port, nid, "GET", CAT)):
            assert status == 200, rows
            assert DOOMED not in {r["index"] for r in rows}, (nid, path)
    assert single[0] == (404 if path in ("/no-such-index",
                                         "/no-such-*?allow_no_indices=false")
                         else 400 if path == "/read-a" else 200), single


# GET /{index} through a cluster and on a single node: each index of this
# section, both by a comma list, a pattern, an alias, and a missing name
# with and without ignore_unavailable (and beside an existing one)
GET_INDEX_PATHS = (
    f"/{ALIASED}", f"/{EXPLAINED}", f"/{ALIASED},{EXPLAINED}", "/alias*",
    "/expl*,aliased", "/read-a", "/no-such-index",
    "/no-such-index?ignore_unavailable=true",
    f"/{EXPLAINED},no-such-index?ignore_unavailable=true",
    "/no-such-*?allow_no_indices=false",
)


@pytest.mark.parametrize("path", GET_INDEX_PATHS)
def test_get_index_through_cluster_equals_single_node(rest_clusters,
                                                      single_items, path):
    """Each node of the port's 3-node cluster answers GET /{index} as a
    single TorchNode does on the same indices (status and body). The
    reference's cluster answers 500: its facade's resolve_indices takes
    neither ignore_unavailable nor allow_no_indices, which its handler
    passes (a stated difference)."""
    single = _single(rest_clusters, single_items, "GET", path)

    def own(body):
        # an index's uuid and creation date are each deployment's own (a
        # cluster's state keeps neither: its stand-ins); the keys stay
        for entry in (body.values() if single[0] == 200 else ()):
            idx = entry["settings"]["index"]
            for key in ("uuid", "creation_date"):
                idx[key] = type(idx[key]).__name__
        return body

    for nid in ("n0", "n1", "n2"):
        got = rest_clusters.req("opensearch_tpu_torch", nid, "GET", path)
        assert got[0] == single[0], (nid, path, got, single)
        assert_same_body(own(single[1]), own(got[1]), f"{nid} {path}")
    assert single[0] == (404 if path.startswith("/no-such-index")
                         and "ignore_unavailable" not in path
                         or "allow_no_indices=false" in path else 200), single
    status, _resp = rest_clusters.req("opensearch_tpu", "n1", "GET", path)
    assert status == 500, (path, status)
