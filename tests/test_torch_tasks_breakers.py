"""Tasks, circuit breakers and search backpressure: the port against the
reference.

The cases of tests/test_tasks_breakers.py that the slice ports (the task
manager, the breakers, search backpressure, the counters under contention,
a search as a task) run on both packages' classes. Then the port alone:

- a search runs as an ``indices:data/read/search`` task and leaves none;
  a PIT and a scroll page too;
- a search cancelled as its task registers raises the reference's
  TaskCancelledException and runs no query phase (no stacked launch, no
  per-shard launch); one cancelled between two shards of the per-shard
  route stops before the second shard's launch; neither leaves a task, a
  batcher slot or a bundle behind;
- backpressure sheds a search with the reference's 429 before its task;
- the HTTP server charges the in-flight breaker with each body and
  releases it on every way out: a response, an error, a "not yet ported"
  500, a tripped breaker's 429 and the background lane's 429;
- the `_tasks` routes answer as the reference's handlers.
"""

from __future__ import annotations

import threading
import types

import numpy as np
import pytest

pytest.importorskip("jax")

import opensearch_tpu.common.breaker as ref_breaker
import opensearch_tpu.common.errors as ref_errors
import opensearch_tpu.search.backpressure as ref_backpressure
import opensearch_tpu.tasks as ref_tasks
import opensearch_tpu_torch.common.breaker as port_breaker
import opensearch_tpu_torch.common.errors as port_errors
import opensearch_tpu_torch.search.backpressure as port_backpressure
import opensearch_tpu_torch.tasks as port_tasks
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.search import distributed_serving

from test_torch_scroll_pit import Pair, observe

PACKAGES = {
    "reference": types.SimpleNamespace(
        TaskManager=ref_tasks.TaskManager, errors=ref_errors,
        HierarchyBreakerService=ref_breaker.HierarchyBreakerService,
        SearchBackpressureService=(
            ref_backpressure.SearchBackpressureService)),
    "port": types.SimpleNamespace(
        TaskManager=port_tasks.TaskManager, errors=port_errors,
        HierarchyBreakerService=port_breaker.HierarchyBreakerService,
        SearchBackpressureService=(
            port_backpressure.SearchBackpressureService)),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


class TestTaskManager:
    def test_register_list_unregister(self, pkg):
        tm = pkg.TaskManager()
        t = tm.register("indices:data/read/search", "test")
        assert tm.list_tasks()[0].id == t.id
        tm.unregister(t)
        assert tm.list_tasks() == [] and tm.completed == 1

    def test_cancel_tree(self, pkg):
        tm = pkg.TaskManager()
        root = tm.register("a")
        child = tm.register("a[s]", parent_id=root.id)
        grandchild = tm.register("a[s][f]", parent_id=child.id)
        assert set(tm.cancel(root.id, "test")) == {
            root.id, child.id, grandchild.id}
        with pytest.raises(pkg.errors.TaskCancelledException):
            grandchild.ensure_not_cancelled()

    def test_child_of_cancelled_parent_is_born_cancelled(self, pkg):
        tm = pkg.TaskManager()
        root = tm.register("a")
        tm.cancel(root.id)
        assert tm.register("a[s]", parent_id=root.id).cancelled

    def test_not_cancellable(self, pkg):
        tm = pkg.TaskManager()
        t = tm.register("x", cancellable=False)
        with pytest.raises(pkg.errors.IllegalArgumentException):
            tm.cancel(t.id)

    def test_cancel_matching_by_action(self, pkg):
        tm = pkg.TaskManager()
        s = tm.register("indices:data/read/search")
        b = tm.register("indices:data/write/bulk")
        assert tm.cancel_matching("indices:data/read/*") == [s.id]
        assert not b.cancelled

    def test_missing_task(self, pkg):
        with pytest.raises(pkg.errors.ResourceNotFoundException):
            pkg.TaskManager().get(42)

    def test_task_dicts_agree(self):
        dicts = []
        for name in sorted(PACKAGES):
            tm = PACKAGES[name].TaskManager("n1")
            t = tm.register("indices:data/read/search", "d")
            d = t.to_dict()
            dicts.append({k: v for k, v in d.items()
                          if k not in ("start_time_in_millis",
                                       "running_time_in_nanos")})
        assert dicts[0] == dicts[1]


class TestCircuitBreakers:
    def test_child_trips(self, pkg):
        svc = pkg.HierarchyBreakerService(total_bytes=1000)
        svc.request.add_estimate_and_maybe_break(500, "a")
        with pytest.raises(pkg.errors.CircuitBreakingException) as e:
            svc.request.add_estimate_and_maybe_break(200, "b")
        assert e.value.status == 429
        assert svc.request.trip_count == 1
        assert svc.request.used == 500
        svc.request.release(500)
        assert svc.request.used == 0

    def test_parent_trips_across_children(self, pkg):
        svc = pkg.HierarchyBreakerService(total_bytes=1000, settings={
            "request_limit_bytes": 900, "fielddata_limit_bytes": 900,
            "parent_limit_bytes": 1000})
        svc.request.add_estimate_and_maybe_break(600, "a")
        with pytest.raises(pkg.errors.CircuitBreakingException):
            svc.fielddata.add_estimate_and_maybe_break(600, "b")
        assert svc.fielddata.used == 0 and svc.parent_trip_count == 1

    def test_stats_agree(self):
        stats = [PACKAGES[n].HierarchyBreakerService().stats()
                 for n in sorted(PACKAGES)]
        assert stats[0] == stats[1]
        assert {"request", "fielddata", "in_flight_requests",
                "parent"} <= set(stats[0])


class TestSearchBackpressure:
    def test_admission_rejects_when_saturated(self, pkg):
        tm = pkg.TaskManager()
        bp = pkg.SearchBackpressureService(tm, max_concurrent=2)
        tm.register("indices:data/read/search")
        tm.register("indices:data/read/search")
        with pytest.raises(pkg.errors.RejectedExecutionException):
            bp.admit()
        assert bp.rejections == 1

    def test_overrunner_cancelled_to_reclaim_capacity(self, pkg):
        tm = pkg.TaskManager()
        bp = pkg.SearchBackpressureService(tm, max_concurrent=1,
                                           max_runtime_ms=0)
        stuck = tm.register("indices:data/read/search")
        bp.admit()
        assert stuck.cancelled and bp.cancellations >= 1

    def test_stats(self, pkg):
        bp = pkg.SearchBackpressureService(pkg.TaskManager())
        assert bp.stats()["active_searches"] == 0


class TestCounterRaces:
    @pytest.fixture(autouse=True)
    def _tight_switch_interval(self):
        import sys

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        yield
        sys.setswitchinterval(old)

    def test_backpressure_rejections_exact_under_contention(self, pkg):
        tm = pkg.TaskManager()
        bp = pkg.SearchBackpressureService(tm, max_concurrent=1,
                                           max_runtime_ms=60_000)
        tm.register("indices:data/read/search")
        start = threading.Barrier(8)

        def hammer():
            start.wait()
            for _ in range(100):
                with pytest.raises(pkg.errors.RejectedExecutionException):
                    bp.admit()

        workers = [threading.Thread(target=hammer) for _ in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        assert bp.rejections == 800

    def test_parent_trip_count_exact_under_contention(self, pkg):
        svc = pkg.HierarchyBreakerService(total_bytes=1000, settings={
            "request_limit_bytes": 1 << 30, "parent_limit_bytes": 100})
        svc.request.used = 500
        start = threading.Barrier(8)

        def hammer():
            start.wait()
            for _ in range(100):
                with pytest.raises(pkg.errors.CircuitBreakingException):
                    svc.check_parent("hammer")

        workers = [threading.Thread(target=hammer) for _ in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        assert svc.parent_trip_count == 800


def test_search_runs_as_task_on_both_nodes(tmp_path):
    pair = Pair(tmp_path)
    try:
        def scenario(node):
            node.create_index("t", {"mappings": {"properties": {
                "n": {"type": "long"}}}})
            for i in range(5):
                node.index_doc("t", str(i), {"n": i})
            node.refresh("t")
            resp = node.search("t", {"query": {"match_all": {}}})
            assert node.task_manager.list_tasks(
                "indices:data/read/search") == []
            return [resp, node.task_manager.completed]

        pair.flow(scenario)
    finally:
        pair.close()


# -- the port alone --------------------------------------------------------------

DIM = 8


@pytest.fixture()
def node(tmp_path):
    n = TorchNode(tmp_path, device="cpu")
    rng = np.random.default_rng(9)
    vecs = rng.standard_normal((90, DIM)).astype(np.float32)
    n.create_index("s3", {"settings": {"number_of_shards": 3},
                          "mappings": {"properties": {
                              "v": {"type": "knn_vector", "dimension": DIM},
                              "n": {"type": "long"}}}})
    n.bulk([("index", {"_index": "s3", "_id": str(i)},
             {"v": vecs[i].tolist(), "n": i}) for i in range(90)],
           refresh=True)
    n.test_vectors = vecs
    yield n
    n.close()


def _knn(node, i=0, k=5):
    return {"query": {"knn": {"v": {"vector": node.test_vectors[i].tolist(),
                                    "k": k}}}}


def _register_cancelled(node, monkeypatch):
    """Cancel every task as it registers: the cancellation lands before the
    search's first check, deterministically."""
    tm = node.task_manager
    register = tm.register

    def register_cancelled(*a, **kw):
        task = register(*a, **kw)
        tm.cancel(task.id, "test")
        return task

    monkeypatch.setattr(tm, "register", register_cancelled)


def _no_leftovers(node) -> None:
    assert node.task_manager.list_tasks() == []
    assert node.knn_batcher.pressure.current == 0


@pytest.mark.parametrize("route", ["stacked", "per_shard"])
def test_cancelled_search_launches_nothing(node, monkeypatch, route):
    from opensearch_tpu_torch.search import service

    node.search("s3", _knn(node))          # the bundle is built
    from opensearch_tpu_torch.cluster.shard_mesh import default_registry

    bundles = dict(default_registry._bundles)
    served = distributed_serving.stats["distributed_searches"]
    calls = []
    real = service.execute_query_phase
    monkeypatch.setattr(service, "execute_query_phase",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _register_cancelled(node, monkeypatch)
    distributed_serving.enabled = route == "stacked"
    try:
        got = observe(lambda: node.search("s3", _knn(node)))
    finally:
        distributed_serving.enabled = True
    assert got[1:3] == ("TaskCancelledException", 400)
    assert "was cancelled" in got[3]
    assert calls == []
    assert distributed_serving.stats["distributed_searches"] == served
    assert dict(default_registry._bundles) == bundles
    _no_leftovers(node)


def test_cancel_between_shards_stops_before_the_next(node, monkeypatch):
    from opensearch_tpu_torch.search import service

    calls = []
    real = service.execute_query_phase

    def first_then_cancel(*a, **kw):
        calls.append(1)
        out = real(*a, **kw)
        for t in node.task_manager.list_tasks("indices:data/read/search"):
            node.task_manager.cancel(t.id, "between shards")
        return out

    monkeypatch.setattr(service, "execute_query_phase", first_then_cancel)
    distributed_serving.enabled = False
    try:
        got = observe(lambda: node.search("s3", _knn(node)))
    finally:
        distributed_serving.enabled = True
    assert got[1] == "TaskCancelledException"
    assert calls == [1]                   # shard 0 ran, shards 1 and 2 not
    _no_leftovers(node)


def test_pit_and_scroll_pages_run_as_tasks(node, monkeypatch):
    pid = node.open_pit("s3", "1m")["pit_id"]
    first = node.search("s3", {**_knn(node, 1, 20), "size": 5}, scroll="1m")
    actions = []
    register = node.task_manager.register

    def record(action, description="", *a, **kw):
        actions.append((action, description.split("[")[0]))
        return register(action, description, *a, **kw)

    monkeypatch.setattr(node.task_manager, "register", record)
    node.search(None, {"pit": {"id": pid}, **_knn(node)})
    node.scroll(first["_scroll_id"])
    assert actions == [("indices:data/read/search", "pit"),
                       ("indices:data/read/search", "scroll")]
    _no_leftovers(node)


def test_backpressure_sheds_before_the_task(node):
    node.search_backpressure.max_concurrent = 0
    node.search_backpressure.max_runtime_ms = 60_000
    try:
        got = observe(lambda: node.search("s3", _knn(node)))
    finally:
        node.search_backpressure.max_concurrent = 256
    assert got[1:3] == ("RejectedExecutionException", 429)
    _no_leftovers(node)


def test_http_in_flight_breaker_is_released_on_every_path(node):
    from opensearch_tpu_torch.rest.http import HttpServer
    from opensearch_tpu_torch.search import lanes

    from test_torch_rest import Client

    srv = HttpServer(node, "127.0.0.1", 0)
    srv.start_in_thread()
    breaker = node.breakers.in_flight_requests
    try:
        c = Client(srv.port)
        body = _knn(node)
        assert c("POST", "/s3/_search", body)[0] == 200
        assert breaker.used == 0
        assert c("POST", "/s3/_search", {"query": {"nope": {}}})[0] == 400
        assert breaker.used == 0
        # a 500: a create-index key the port does not serve raises
        assert c("PUT", "/s3-new", {"bogus": {}})[0] == 500
        assert breaker.used == 0
        lines = []
        for i in range(32):
            lines += [{"index": "s3"}, _knn(node, i)]
        status, resp = c("POST", "/_msearch", ndjson=lines)
        assert status == 200 and len(resp["responses"]) == 32
        assert breaker.used == 0
        # a tripped breaker: the reference's 429, nothing held
        limit = breaker.limit
        breaker.limit = 10
        try:
            status, resp = c("POST", "/s3/_search", body)
        finally:
            breaker.limit = limit
        assert status == 429
        assert resp["error"]["type"] == "circuit_breaking_exception"
        assert breaker.used == 0
        # the background lane's bounded queue sheds with a 429
        cfg = lanes.default_config
        old = (cfg.enabled, cfg.background_max_queue)
        cfg.configure(enabled=True, background_max_queue=0)
        try:
            status, resp = c("POST", "/_msearch", ndjson=lines[:2])
        finally:
            cfg.configure(enabled=old[0], background_max_queue=old[1])
        assert status == 429
        assert resp["error"]["type"] == "rejected_execution_exception"
        assert breaker.used == 0
        assert node.task_manager.list_tasks() == []
    finally:
        srv.stop_thread()


def test_tasks_routes_answer_as_the_references(tmp_path):
    from opensearch_tpu.rest import handlers as ref_h
    from opensearch_tpu_torch.rest import handlers as port_h

    pair = Pair(tmp_path)
    try:
        def call(name, params, query):
            def scenario(node):
                h = getattr(ref_h if node is pair.ref else port_h, name)
                got = observe(lambda: h(node, params, query, None))
                if got[0] == "ok":
                    got = ("ok", _no_times(got[1]))
                return [got]
            return pair.flow(scenario)[0]

        listed = call("list_tasks", {}, {})
        (tasks,) = [n["tasks"] for n in listed[1][1]["nodes"].values()]
        assert [t["action"] for t in tasks.values()] == [
            "cluster:monitor/tasks/lists"]
        call("list_tasks", {}, {"group_by": "none", "detailed": "true"})
        call("list_tasks", {}, {"group_by": "parents",
                                "actions": "indices:*"})
        assert call("get_task", {"task_id": "abc"}, {})[1:3] == (
            "IllegalArgumentException", 400)
        assert call("get_task", {"task_id": "other:3"}, {})[2] == 404
        assert call("get_task", {"task_id": "node-0:999"}, {})[2] == 404
        call("get_task", {"task_id": "node-0:1"}, {})
        call("cancel_tasks", {}, {"actions": "indices:data/read/*"})
        assert call("cancel_task", {"task_id": "12345"}, {})[2] == 404
    finally:
        pair.close()


def _no_times(obj):
    """Wall and CPU clocks differ between two runs: leave them out."""
    if isinstance(obj, dict):
        return {k: _no_times(v) for k, v in obj.items()
                if k not in ("start_time_in_millis", "running_time_in_nanos",
                             "resource_stats")}
    if isinstance(obj, (list, tuple)):
        return [_no_times(v) for v in obj]
    return obj
