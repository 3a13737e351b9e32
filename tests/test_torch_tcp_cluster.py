"""The cluster over sockets: three ClusterServers on loopback TCP, the
port's against the reference's.

The reference's scenarios of tests/test_tcp_cluster.py (boot, elect, write
and search through any node; kill the leader with no acked-write loss;
kill the leader mid-bulk) run on a 3-node cluster of each package: as the
reference wrote them, and as the port's copy
(:func:`test_torch_cluster_data.port_module`, every ``ClusterServer`` on
the CPU). Both runs pass the reference's assertions, and every HTTP
exchange of a run is recorded (:func:`harness`):

- boot: every exchange but the health polls, in order, equal (status and
  body; ``took`` left out);
- leader kill: the same acked ids and the same count after the failover;
- mid-bulk kill: how many writes ack before the kill depends on the
  socket timing, so each run's acked ids are held to its own read-back
  (no acked id lost), as the reference holds them.

Then a 3-shard, 1-replica kNN index (d = 16, 600 docs) on one cluster of
each package, module-scoped and led by n0 (:func:`boot_cluster`): a bare ``knn`` through every node gives the
numpy brute force's ids, the reference cluster's hits and a single
``TorchNode``'s over the same docs (ids equal, l2 scores to rtol 1e-5 /
atol 1e-4, the tolerance tests/test_torch_node_knn.py states); an
``_msearch`` of bare kNN equals its solo searches and takes one
``msearch[node]`` RPC a data node; and a kill of the port cluster's leader
loses no doc, serves the next kNN from the promoted replicas and leaves no
stacked bundle holding the killed node's engines.

Every node's disk reading is pinned to 50% (``disk_usage_pct``) in both
packages: on a host disk over 90% full the disk-threshold decider leaves
every replica unassigned and no cluster goes green. The reference's
coordinator takes the port's one change to it
(:func:`test_torch_cluster_data.publication_fix`). A ``ClusterServer``
start that meets EADDRINUSE (two workers drew the same free port) retries
on fresh ports (:func:`harness`).
"""

from __future__ import annotations

import asyncio
import contextlib
import errno
import functools
import importlib
import json

import numpy as np
import pytest

pytest.importorskip("jax")

from test_torch_cluster_data import assert_same, cases, port_module, \
    publication_fix, run_case

REFERENCE = "test_tcp_cluster"
PACKAGES = ("opensearch_tpu", "opensearch_tpu_torch")
DISK_PCT = 50.0
BOOT_ATTEMPTS = 5
KNN_DIM, KNN_DOCS, KNN_K = 16, 600, 10
KNN_RTOL, KNN_ATOL = 1e-5, 1e-4
SCENARIOS = ("test_boot_elect_write_search_any_node",
             "test_leader_kill_no_acked_write_loss",
             "test_leader_kill_mid_bulk")


def reference_module(package: str):
    """tests/test_tcp_cluster.py on ``package``."""
    if package == "opensearch_tpu":
        return importlib.import_module(REFERENCE)
    return port_module(REFERENCE)


@contextlib.contextmanager
def pinned_disk():
    """Every ClusterNode of both packages reads its disk as DISK_PCT, and
    the reference's coordinator takes the port's one change to it
    (:func:`test_torch_cluster_data.publication_fix`)."""
    mp = pytest.MonkeyPatch()
    try:
        publication_fix(mp)
        for package in PACKAGES:
            cnode = importlib.import_module(f"{package}.cluster.cluster_node")
            init = cnode.ClusterNode.__init__

            def pinned_init(node, *a, __init=init, **kw):
                __init(node, *a, **kw)
                node.disk_usage_pct = DISK_PCT

            mp.setattr(cnode.ClusterNode, "__init__", pinned_init)
        yield
    finally:
        mp.undo()


async def start_retrying(cluster, start, free_ports) -> None:
    """``TcpCluster.start``, again on fresh ports after EADDRINUSE."""
    n = len(cluster.node_ids)
    for attempt in range(BOOT_ATTEMPTS):
        try:
            return await start(cluster)
        except OSError as e:
            if e.errno != errno.EADDRINUSE or attempt == BOOT_ATTEMPTS - 1:
                raise
            await cluster.stop()
            cluster.servers.clear()
            ports = free_ports(2 * n)
            cluster.seeds = {nid: ("127.0.0.1", ports[i])
                             for i, nid in enumerate(cluster.node_ids)}
            cluster.http_ports = {nid: ports[n + i]
                                  for i, nid in enumerate(cluster.node_ids)}


@contextlib.contextmanager
def harness(mod, exchanges: list | None = None):
    """Disk pinned, boots retried on EADDRINUSE, and (with ``exchanges``)
    every ``http`` call of ``mod`` recorded as (method, path, status,
    body)."""
    mp = pytest.MonkeyPatch()
    start = mod.TcpCluster.start

    async def retrying(cluster):
        await start_retrying(cluster, start, mod.free_ports)

    mp.setattr(mod.TcpCluster, "start", retrying)
    if exchanges is not None:
        http = mod.http

        async def recorded(port, method, path, body=None, **kw):
            status, payload = await http(port, method, path, body, **kw)
            exchanges.append((method, path, status, payload))
            return status, payload

        mp.setattr(mod, "http", recorded)
    try:
        with pinned_disk():
            yield
    finally:
        mp.undo()


def _case(name: str):
    (case,) = [c for c in cases(importlib.import_module(REFERENCE))
               if c.values[0][1] == name]
    return case.values[0]


def run_scenario(name: str, package: str, tmp_path) -> list:
    mod = reference_module(package)
    exchanges: list = []
    tmp_path.mkdir()
    with harness(mod, exchanges):
        run_case(mod, _case(name), tmp_path)
    return exchanges


def _acked(exchanges: list) -> list:
    return sorted(path.rsplit("/", 1)[1]
                  for method, path, status, body in exchanges
                  if method == "PUT" and "/_doc/" in path
                  and status in (200, 201) and isinstance(body, dict)
                  and body.get("_shards", {}).get("failed") == 0)


def _last_total(exchanges: list) -> int:
    return [b["hits"]["total"]["value"] for m, p, s, b in exchanges
            if p.endswith("/_search") and s == 200][-1]


def test_boot_elect_write_search_any_node(tmp_path):
    name = "test_boot_elect_write_search_any_node"
    ref = run_scenario(name, "opensearch_tpu", tmp_path / "ref")
    port = run_scenario(name, "opensearch_tpu_torch", tmp_path / "port")
    # the health polls run until green: their number is the clock's
    ref = [e for e in ref if e[1] != "/_cluster/health"]
    port = [e for e in port if e[1] != "/_cluster/health"]
    assert [e[:3] for e in ref] == [e[:3] for e in port]
    assert_same([e[3] for e in ref], [e[3] for e in port], "$exchanges")


def test_leader_kill_no_acked_write_loss(tmp_path):
    name = "test_leader_kill_no_acked_write_loss"
    ref = run_scenario(name, "opensearch_tpu", tmp_path / "ref")
    port = run_scenario(name, "opensearch_tpu_torch", tmp_path / "port")
    assert _acked(ref) == _acked(port) == sorted(f"k{i}" for i in range(20))
    assert _last_total(ref) == _last_total(port) == 20
    reads = [[e for e in run if e[0] == "GET" and "/_doc/" in e[1]][-3:]
             for run in (ref, port)]
    assert_same(reads[0], reads[1], "$reads")


def test_leader_kill_mid_bulk(tmp_path):
    for package in PACKAGES:
        run = run_scenario("test_leader_kill_mid_bulk", package,
                           tmp_path / package)
        acked = set(_acked(run))
        read = {p.rsplit("/", 1)[1] for m, p, s, b in run
                if m == "GET" and "/_doc/" in p and s == 200}
        assert acked and acked <= read, (package, sorted(acked - read))


@pytest.mark.slow
@pytest.mark.chaos
def test_tcp_elastic_topology_soak(tmp_path):
    """testing/soak_tcp.py's reshape (join, rebalance, disk ramp and
    evacuation, drain and depart, under live HTTP traffic) through the
    reference's own case on each package; slow and chaos, as the
    reference marks its twin."""
    name = "test_tcp_elastic_topology_soak"
    milestones = {}
    for package in PACKAGES:
        mod = reference_module(package)
        soak = importlib.import_module(f"{package}.testing.soak_tcp")
        reports = []
        run = soak.TcpSoak.run

        async def recorded(self, __run=run, __out=reports):
            __out.append(await __run(self))
            return __out[-1]

        mp = pytest.MonkeyPatch()
        mp.setattr(soak.TcpSoak, "run", recorded)
        try:
            (tmp_path / package).mkdir()
            with pinned_disk():
                run_case(mod, _case(name), tmp_path / package)
        finally:
            mp.undo()
        (report,) = reports
        assert report["writes_acked"] > 0 and report["searches_ok"] > 0
        milestones[package] = [m["event"] for m in report["milestones"]]
    assert milestones["opensearch_tpu"] == milestones["opensearch_tpu_torch"]


def test_scenarios_cover_the_reference():
    names = {c.values[0][1] for c in cases(importlib.import_module(REFERENCE))}
    assert set(SCENARIOS) <= names


# -- a kNN index on a cluster of each package --------------------------------


def knn_data(seed: int = 25):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((KNN_DOCS, KNN_DIM)).astype(np.float32)
    queries = rng.standard_normal((6, KNN_DIM)).astype(np.float32)
    return vecs, queries


def brute_ids(vecs, q, k):
    d = ((vecs.astype(np.float64) - q.astype(np.float64)) ** 2).sum(1)
    return [str(i) for i in np.argsort(d, kind="stable")[:k]]


def knn_body(q, k=KNN_K) -> dict:
    return {"query": {"knn": {"v": {"vector": q.tolist(), "k": k}}},
            "size": k}


KNN_INDEX = {
    "settings": {"number_of_shards": 3, "number_of_replicas": 1},
    "mappings": {"properties": {"v": {
        "type": "knn_vector", "dimension": KNN_DIM,
        "similarity": "l2_norm"}}},
}


async def start_one_bootstrap(package: str, cluster) -> None:
    """``TcpCluster.start`` with the voting configuration bootstrapped on
    the first node alone: the others join it, so it is the elected node
    in both packages and the answers that name the elected node
    compare."""
    server = importlib.import_module(f"{package}.server")
    kw = {"device": "cpu"} if package == "opensearch_tpu_torch" else {}
    for i, nid in enumerate(cluster.node_ids):
        srv = server.ClusterServer(
            nid, cluster.tmp_path / nid, "127.0.0.1", cluster.seeds[nid][1],
            cluster.http_ports[nid], cluster.seeds,
            loop=asyncio.get_running_loop(), **kw)
        cluster.servers[nid] = srv
        await srv.start(bootstrap=cluster.node_ids if i == 0 else None)


async def boot_cluster(mod, tmp_path) -> object:
    """A 3-node cluster of ``mod``'s package led by n0."""
    package = ("opensearch_tpu" if mod.__name__ == REFERENCE
               else "opensearch_tpu_torch")
    cluster = mod.TcpCluster(tmp_path)
    await start_retrying(cluster,
                         functools.partial(start_one_bootstrap, package),
                         mod.free_ports)
    assert await cluster.wait_leader() == "n0"
    return cluster


async def boot_knn(mod, tmp_path, vecs) -> object:
    """A 3-node cluster of ``mod``'s package with ``vecs`` in index v."""
    cluster = await boot_cluster(mod, tmp_path)
    port = cluster.http_ports["n0"]
    status, resp = await mod.http(port, "PUT", "/v", KNN_INDEX)
    assert status == 200, resp
    await cluster.wait_health(port, "green")
    nd = "".join(json.dumps(x) + "\n" for i in range(KNN_DOCS)
                 for x in ({"index": {"_index": "v", "_id": str(i)}},
                           {"v": vecs[i].tolist()}))
    status, resp = await mod.http(port, "POST", "/_bulk?refresh=true", nd,
                                  timeout=60.0)
    assert status == 200 and not resp["errors"], str(resp)[:300]
    return cluster


class Clusters:
    """The module's two clusters on one event loop, and the actions every
    port node's transport sent."""

    def __init__(self, tmp_path):
        self.loop = asyncio.new_event_loop()
        self.vecs, self.queries = knn_data()
        self.mods = {p: reference_module(p) for p in PACKAGES}
        self.sends: dict[str, int] = {}
        self._stack = contextlib.ExitStack()
        for mod in self.mods.values():
            self._stack.enter_context(harness(mod))
        tcp = importlib.import_module("opensearch_tpu_torch.transport.tcp")
        send = tcp.TcpTransport.send
        sends = self.sends

        def counted(t, sender, target, action, *a, **kw):
            sends[action] = sends.get(action, 0) + 1
            return send(t, sender, target, action, *a, **kw)

        mp = pytest.MonkeyPatch()
        mp.setattr(tcp.TcpTransport, "send", counted)
        self._stack.callback(mp.undo)
        self.clusters = {}
        try:
            for p, mod in self.mods.items():
                self.clusters[p] = self.run(
                    boot_knn(mod, tmp_path / p, self.vecs))
        except BaseException:
            self.close()
            raise

    def run(self, coro):
        return self.loop.run_until_complete(coro)

    def http(self, package: str, nid: str, method: str, path: str,
             body=None):
        cluster = self.clusters[package]
        return self.run(self.mods[package].http(
            cluster.http_ports[nid], method, path, body, timeout=60.0))

    def close(self) -> None:
        for cluster in self.clusters.values():
            self.run(cluster.stop())
        self._stack.close()
        self.loop.close()


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    c = Clusters(tmp_path_factory.mktemp("tcp_knn"))
    yield c
    c.close()


@pytest.fixture(scope="module")
def single(clusters, tmp_path_factory):
    from opensearch_tpu_torch.node import TorchNode

    node = TorchNode(tmp_path_factory.mktemp("single"), device="cpu")
    node.create_index("v", KNN_INDEX)
    node.bulk([("index", {"_index": "v", "_id": str(i)},
                {"v": clusters.vecs[i].tolist()}) for i in range(KNN_DOCS)],
              refresh=True)
    yield node
    node.close()


def _hits(resp: dict) -> list:
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


def assert_hits(got: list, want: list) -> None:
    assert [i for i, _ in got] == [i for i, _ in want], (got, want)
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=KNN_RTOL, atol=KNN_ATOL)


@pytest.mark.parametrize("via", ["n0", "n1", "n2"])
def test_knn_through_every_node(clusters, single, via):
    for q in clusters.queries:
        body = knn_body(q)
        ref = clusters.http("opensearch_tpu", via, "POST", "/v/_search", body)
        port = clusters.http("opensearch_tpu_torch", via, "POST",
                             "/v/_search", body)
        assert ref[0] == port[0] == 200, (ref, port)
        assert port[1]["_shards"] == {"total": 3, "successful": 3,
                                      "skipped": 0, "failed": 0}
        assert [i for i, _ in _hits(port[1])] == brute_ids(
            clusters.vecs, q, KNN_K)
        assert_hits(_hits(port[1]), _hits(ref[1]))
        assert_hits(_hits(port[1]), _hits(single.search("v", body)))


def test_msearch_of_bare_knn_equals_solo(clusters):
    bodies = [knn_body(q) for q in clusters.queries]
    nd = "".join(json.dumps({"index": "v"}) + "\n" + json.dumps(b) + "\n"
                 for b in bodies)
    solo = {p: [_hits(clusters.http(p, "n2", "POST", "/v/_search", b)[1])
                for b in bodies] for p in PACKAGES}
    before = dict(clusters.sends)
    got = {p: clusters.http(p, "n2", "POST", "/_msearch", nd)
           for p in PACKAGES}
    moved = {a: n - before.get(a, 0) for a, n in clusters.sends.items()
             if n != before.get(a, 0)}
    for p in PACKAGES:
        status, resp = got[p]
        assert status == 200, resp
        assert len(resp["responses"]) == len(bodies)
        for r, want in zip(resp["responses"], solo[p]):
            assert_hits(_hits(r), want)
    for r, want in zip(got["opensearch_tpu_torch"][1]["responses"],
                       solo["opensearch_tpu"]):
        assert_hits(_hits(r), want)
    # one msearch[node] RPC a data node, no search[node]
    assert moved.get("indices:data/read/msearch[node]") == 3, moved
    assert "indices:data/read/search[node]" not in moved, moved


def test_leader_kill_keeps_every_doc_and_drops_its_bundles(clusters):
    """Last of the module: the port cluster's leader is killed."""
    from opensearch_tpu_torch.cluster.shard_mesh import (_bundle_nbytes,
                                                         default_registry)
    from opensearch_tpu_torch.telemetry.device_ledger import default_ledger

    p = "opensearch_tpu_torch"
    cluster = clusters.clusters[p]
    leader = clusters.run(cluster.wait_leader())
    srv = cluster.servers[leader]
    engines = {sh.engine.instance_id for sh in srv.node.local_shards.values()}
    with default_registry._lock:
        held = [k for k in default_registry._bundles if engines & set(k[3])]
        held_bytes = sum(_bundle_nbytes(default_registry._bundles[k])
                         for k in held)
    assert held, "the leader served no partial before the kill"
    before = sum(default_ledger.device_totals().values())
    clusters.run(srv.aclose())
    del cluster.servers[leader]
    with default_registry._lock:
        assert not [k for k in default_registry._bundles
                    if engines & set(k[3])]
    # the ledger drops the killed node's bundles and its shards' columns
    fell = before - sum(default_ledger.device_totals().values())
    assert fell >= held_bytes > 0, (fell, held_bytes)
    new_leader = clusters.run(cluster.wait_leader())
    assert new_leader != leader
    via = new_leader
    health = None
    for _ in range(600):
        status, health = clusters.http(p, via, "GET", "/_cluster/health")
        # the killed node has left the leader's state, and every
        # primary is active again
        if health["status"] in ("green", "yellow") and \
                health["number_of_nodes"] == 2 and \
                health["active_primary_shards"] == 3:
            break
        clusters.run(asyncio.sleep(0.1))
    assert health["active_primary_shards"] == 3, health
    status, resp = clusters.http(p, via, "POST", "/v/_count", {})
    assert status == 200 and resp["count"] == KNN_DOCS, resp
    status, resp = clusters.http(p, via, "POST", "/_mget", {
        "docs": [{"_index": "v", "_id": str(i)} for i in range(0, KNN_DOCS,
                                                               37)]})
    assert status == 200 and all(d["found"] for d in resp["docs"]), resp
    for q in clusters.queries:
        status, resp = clusters.http(p, via, "POST", "/v/_search",
                                     knn_body(q))
        assert status == 200 and resp["_shards"]["failed"] == 0, resp
        assert [i for i, _ in _hits(resp)] == brute_ids(clusters.vecs, q,
                                                        KNN_K)
