"""Workload management (wlm.py) on TorchNode against TpuNode.

The cases of tests/test_wlm.py, each on both nodes with the observations
equal (a group's random `_id` left out): query-group CRUD and its errors,
enforced search admission, soft and untagged groups, the bulk slot budgets
and their resize, a tagged `_bulk` shed with the 429, and a deleted group's
budget. Then the port alone: `search(query_group=)` under concurrency
sheds with the 429 while every admitted search returns its solo bits and
no task stays registered; the `_wlm` routes and `_list/wlm_stats` over
HTTP.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.wlm import TOTAL_BULK_SLOTS, TOTAL_SEARCH_PERMITS

from test_torch_scroll_pit import Pair, observe


def _no_ids(obj):
    """A query group's `_id` is random: leave it out."""
    if isinstance(obj, dict):
        return {k: _no_ids(v) for k, v in obj.items() if k != "_id"}
    if isinstance(obj, (list, tuple)):
        return [_no_ids(v) for v in obj]
    return obj


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def test_query_group_crud(pair):
    def scenario(node):
        qg = node.query_groups
        out = qg.put({"name": "analytics", "resiliency_mode": "enforced",
                      "resource_limits": {"cpu": 0.5}})
        gid = out["query_group"]["_id"]
        got = qg.get("analytics")
        assert got["query_groups"][0]["_id"] == gid
        # an update by name keeps the id
        out2 = qg.put({"name": "analytics", "resiliency_mode": "soft",
                       "resource_limits": {"cpu": 0.25}})
        assert out2["query_group"]["_id"] == gid
        return _no_ids([
            out, got, out2, qg.get(), qg.delete("analytics"),
            observe(lambda: qg.get("analytics")),
            observe(lambda: qg.delete("analytics")),
            observe(lambda: qg.put({"name": "x",
                                    "resource_limits": {"cpu": 2.0}})),
            observe(lambda: qg.put({"name": "x",
                                    "resiliency_mode": "strict"})),
            observe(lambda: qg.put({"name": "x",
                                    "resource_limits": {"disk": 0.5}})),
            observe(lambda: qg.put({}))])

    out = pair.flow(scenario)
    assert out[5][:3] == ["error", "ResourceNotFoundException", 404]


def test_enforced_group_rejects_over_limit(pair):
    def scenario(node):
        node.query_groups.put({
            "name": "tiny", "resiliency_mode": "enforced",
            "resource_limits": {"cpu": 1.0 / TOTAL_SEARCH_PERMITS}})
        first = node.query_groups.admit("tiny")
        first.__enter__()
        try:
            second = observe(lambda: node.query_groups.admit(
                "tiny").__enter__())
        finally:
            first.__exit__(None, None, None)
        with node.query_groups.admit("tiny"):
            pass
        return _no_ids([second, list(node.query_groups.stats().values()),
                        sorted(node.query_groups.totals().values(),
                               key=str)])

    out = pair.flow(scenario)
    assert out[0][:3] == ["error", "RejectedExecutionException", 429]


def test_soft_group_and_untagged_run_free(pair):
    def scenario(node):
        node.query_groups.put({"name": "soft-group",
                               "resource_limits": {"cpu": 0.01}})
        for _ in range(3):
            with node.query_groups.admit("soft-group"):
                pass
        with node.query_groups.admit(None):
            pass
        return _no_ids([list(node.query_groups.stats().values())])

    pair.flow(scenario)


def test_bulk_admission_sheds_past_slot_share(pair):
    def scenario(node):
        qg = node.query_groups
        qg.put({"name": "flood", "resiliency_mode": "enforced",
                "resource_limits": {"memory": 1.5 / TOTAL_BULK_SLOTS}})
        release = qg.admit_bulk("flood")
        try:
            shed = observe(lambda: qg.admit_bulk("flood"))
            stats = list(qg.bulk_stats().values())
            totals = sorted(qg.totals().values(), key=str)
        finally:
            release()
            release()  # idempotent: a double release frees once
        qg.admit_bulk("flood")()
        return [shed, stats, totals, list(qg.bulk_stats().values())]

    out = pair.flow(scenario)
    assert out[1][0]["current"] == 1 and out[1][0]["rejections"] == 1
    assert out[3][0]["current"] == 0


def test_bulk_admission_soft_and_untagged_unconstrained(pair):
    def scenario(node):
        qg = node.query_groups
        qg.put({"name": "softy", "resiliency_mode": "soft",
                "resource_limits": {"memory": 0.001}})
        for _ in range(5):
            qg.admit_bulk("softy")()
        qg.admit_bulk(None)()
        qg.admit_bulk("no-such-group")()
        return [qg.bulk_stats()]

    assert pair.flow(scenario) == [{}]


def test_bulk_admission_resizes_on_limit_change(pair):
    def scenario(node):
        qg = node.query_groups
        qg.put({"name": "grow", "resiliency_mode": "enforced",
                "resource_limits": {"memory": 1.5 / TOTAL_BULK_SLOTS}})
        r1 = qg.admit_bulk("grow")
        shed = observe(lambda: qg.admit_bulk("grow"))
        qg.put({"name": "grow", "resiliency_mode": "enforced",
                "resource_limits": {"memory": 3.5 / TOTAL_BULK_SLOTS}})
        r2 = qg.admit_bulk("grow")
        r1()
        r2()
        return [shed, list(qg.bulk_stats().values())]

    pair.flow(scenario)


def test_rest_bulk_sheds_429_for_enforced_group(pair):
    def scenario(node):
        node.query_groups.put({
            "name": "bflood", "resiliency_mode": "enforced",
            "resource_limits": {"memory": 1.5 / TOTAL_BULK_SLOTS}})
        node.create_index("wb", {})
        held = node.query_groups.admit_bulk("bflood")
        try:
            shed = observe(lambda: node.bulk(
                [("index", {"_index": "wb", "_id": "1"}, {"n": 1})],
                query_group="bflood"))
        finally:
            held()
        resp = node.bulk([("index", {"_index": "wb", "_id": "1"}, {"n": 1})],
                         query_group="bflood")
        return [shed, resp, list(node.query_groups.bulk_stats().values())]

    out = pair.flow(scenario)
    assert out[0][:3] == ("error", "RejectedExecutionException", 429)
    assert not out[1]["errors"] and out[2][0]["current"] == 0


def test_delete_group_drops_its_bulk_budget(pair):
    def scenario(node):
        qg = node.query_groups
        qg.put({"name": "gone", "resiliency_mode": "enforced",
                "resource_limits": {"memory": 0.05}})
        qg.admit_bulk("gone")()
        before = bool(qg.bulk_stats())
        qg.delete("gone")
        return [before, qg.bulk_stats()]

    assert pair.flow(scenario) == [True, {}]


# -- the port alone ------------------------------------------------------------


def test_concurrent_searches_under_an_enforced_group(tmp_path):
    node = TorchNode(tmp_path, device="cpu")
    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((200, 8)).astype(np.float32)
    node.create_index("w", {"mappings": {"properties": {
        "v": {"type": "knn_vector", "dimension": 8}}}})
    node.bulk([("index", {"_index": "w", "_id": str(i)},
                {"v": vecs[i].tolist()}) for i in range(200)], refresh=True)
    gid = node.query_groups.put({
        "name": "few", "resiliency_mode": "enforced",
        "resource_limits": {"cpu": 2.5 / TOTAL_SEARCH_PERMITS}})[
        "query_group"]["_id"]
    bodies = [{"query": {"knn": {"v": {"vector": vecs[t].tolist(),
                                       "k": 5}}}} for t in range(8)]
    solo = [node.search("w", b)["hits"]["hits"] for b in bodies]
    barrier = threading.Barrier(8)
    results: dict = {}

    def worker(t: int) -> None:
        got = []
        for _ in range(6):
            barrier.wait()
            got.append(observe(lambda: node.search(
                "w", bodies[t], query_group="few")))
        results[t] = got

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    admitted = rejected = 0
    for t, got in results.items():
        for obs in got:
            if obs[0] == "ok":
                assert obs[1]["hits"]["hits"] == solo[t]
                admitted += 1
            else:
                assert obs[1:3] == ("RejectedExecutionException", 429)
                rejected += 1
    assert admitted + rejected == 48 and admitted > 0
    assert node.task_manager.list_tasks() == []
    totals = node.query_groups.totals()[gid]
    assert totals["total_completions"] == admitted
    assert totals["total_rejections"] == rejected
    assert node.query_groups.stats()[gid]["in_flight"] == 0
    node.close()


def test_wlm_routes_over_http(tmp_path):
    from opensearch_tpu_torch.rest.http import HttpServer

    from test_torch_rest import Client

    node = TorchNode(tmp_path, device="cpu")
    srv = HttpServer(node, "127.0.0.1", 0)
    srv.start_in_thread()
    try:
        c = Client(srv.port)
        status, made = c("PUT", "/_wlm/query_group", {
            "name": "g1", "resiliency_mode": "enforced",
            "resource_limits": {"cpu": 0.5}})
        assert status == 200 and made["query_group"]["name"] == "g1"
        gid = made["query_group"]["_id"]
        assert c("GET", "/_wlm/query_group")[1]["query_groups"][0]["_id"] \
            == gid
        assert c("GET", "/_wlm/query_group/g1")[0] == 200
        assert c("GET", "/_wlm/query_group/none")[0] == 404
        c("PUT", "/i/_doc/1?refresh=true", {"n": 1})
        assert c("POST", "/i/_search?query_group=g1", {})[0] == 200
        assert c("GET", "/_wlm/stats")[1] == {"query_groups": {gid: {
            "name": "g1", "in_flight": 0, "resiliency_mode": "enforced"}}}
        rows = c("GET", "/_list/wlm_stats?format=json")[1]
        assert {"NODE_ID": "node-0", "WORKLOAD_GROUP_ID": gid,
                "TOTAL_COMPLETIONS": 1, "TOTAL_REJECTIONS": 0,
                "TOTAL_CANCELLATIONS": 0} in rows
        assert c("GET", "/_list/wlm_stats?size=0")[0] == 400
        assert c("DELETE", "/_wlm/query_group/g1") == (
            200, {"acknowledged": True})
    finally:
        srv.stop_thread()
        node.close()
