"""The port's tracing, metrics and slow logs (opensearch_tpu_torch/
telemetry/{tracing,slowlog}.py) against the reference's: the single-node
cases of tests/test_telemetry.py (span tree, metrics, trace context, slow
log thresholds), each run on both packages' classes and on a TorchNode,
and the port's own wiring (the search span, the HTTP request span, the
batcher's flush events and metrics)."""

from __future__ import annotations

import json
import urllib.request

import numpy as np
import pytest

from opensearch_tpu.telemetry import slowlog as ref_slowlog
from opensearch_tpu.telemetry import tracing as ref_tracing
from opensearch_tpu_torch.cluster.shard_mesh import (
    MESH_LAUNCH_WALL_MS,
    ShardMeshRegistry,
)
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.search import batcher as batcher_mod
from opensearch_tpu_torch.telemetry import slowlog as port_slowlog
from opensearch_tpu_torch.telemetry import tracing as port_tracing

PACKAGES = {"reference": (ref_tracing, ref_slowlog),
            "port": (port_tracing, port_slowlog)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture()
def node(tmp_path):
    n = TorchNode(tmp_path / "node", device="cpu")
    n.create_index("t", {"mappings": {"properties": {
        "msg": {"type": "text"}}}})
    for i in range(5):
        n.index_doc("t", str(i), {"msg": f"message number {i}"})
    n.refresh("t")
    yield n
    n.close()


def _span_rows(spans) -> list:
    """Spans without their clock: name, ids, parent and attributes."""
    return [(s.name, s.span_id, s.parent_id, s.trace_id,
             dict(s.attributes)) for s in spans]


# -- tracer ----------------------------------------------------------------


def _span_tree(tracing):
    tracer = tracing.Tracer(name="n1")
    with tracer.start_span("outer", {"a": 1}) as outer:
        assert tracer.current_span() is outer
        with tracer.start_span("inner") as inner:
            assert inner.parent_id == outer.span_id
            assert inner.trace_id == outer.trace_id
            inner.set_attribute("k", "v")
            tracing.add_span_event("ev", {"x": 1})
    assert tracer.current_span() is None
    with pytest.raises(ValueError):
        with tracer.start_span("boom"):
            raise ValueError("kaput")
    finished = tracer.finished_spans()
    assert all(s.duration_ns >= 0 for s in finished)
    return _span_rows(finished), [
        [(e["name"], e["attributes"]) for e in s.events] for s in finished]


def test_span_tree_is_the_references():
    want = _span_tree(ref_tracing)
    got = _span_tree(port_tracing)
    assert got == want
    rows, events = got
    assert [r[0] for r in rows] == ["inner", "outer", "boom"]
    assert rows[0][4] == {"k": "v"} and rows[2][4] == {"error": "kaput"}
    assert events[0] == [("ev", {"x": 1})]


def test_span_events_are_bounded(pkg):
    tracing, _ = pkg
    tracer = tracing.Tracer()
    with tracer.start_span("s") as span:
        for i in range(tracing.MAX_SPAN_EVENTS + 5):
            tracing.add_span_event("e", {"i": i})
    assert len(span.events) == tracing.MAX_SPAN_EVENTS
    assert span.dropped_events == 5
    assert span.to_dict()["dropped_events"] == 5
    # outside any span: a no-op
    tracing.add_span_event("nowhere")


# -- trace context ---------------------------------------------------------


def test_restore_context_stitches_across_tracers(pkg):
    tracing, _ = pkg
    t_a, t_b = tracing.Tracer(name="nodeA"), tracing.Tracer(name="nodeB")
    with t_a.start_span("coordinator") as coord:
        ctx = tracing.current_trace_context()
    assert ctx == {"trace_id": coord.trace_id, "span_id": coord.span_id}
    with tracing.restore_trace_context(ctx):
        with t_b.start_span("shard") as shard:
            assert shard.trace_id == coord.trace_id
            assert shard.parent_id == coord.span_id
    assert coord.span_id.startswith("nodeA-")
    assert shard.span_id.startswith("nodeB-")


def test_malformed_context_is_noop(pkg):
    tracing, _ = pkg
    t = tracing.Tracer()
    for bad in (None, {}, {"trace_id": "x"}, "junk"):
        with tracing.restore_trace_context(bad):
            with t.start_span("orphan") as span:
                assert span.parent_id is None


def test_begin_end_span_joins_ring(pkg):
    tracing, _ = pkg
    tracer = tracing.Tracer(name="n1")
    span = tracer.begin_span("recovery.target", {"index": "i"})
    assert span.end_ns == 0
    tracer.end_span(span)
    assert tracer.finished_spans()[-1] is span
    assert span.duration_ns >= 0


# -- metrics ---------------------------------------------------------------


def _metrics_stats(tracing) -> dict:
    m = tracing.MetricsRegistry()
    m.counter("c").add(2)
    m.counter("c").add(3)
    for v in (1, 3, 9, 40, 70_000):
        m.histogram("h").record(v, trace_id="t-1")
    m.histogram("h", labels={"index": "a"}).record(10)
    for i in range(tracing.MAX_LABEL_SETS + 3):
        m.histogram("wide", labels={"i": i}).record(1)
    return m.stats()


def test_metrics_stats_are_the_references():
    got = _metrics_stats(port_tracing)
    assert got == _metrics_stats(ref_tracing)
    assert got["counters"]["c"] == 5
    h = got["histograms"]["h"]
    by_le = {b["le"]: b["count"] for b in h["buckets"]}
    assert (by_le[1], by_le[5], by_le[10], by_le[50], by_le[60_000]) == \
        (1, 2, 3, 4, 4)
    assert h["count"] == 5 and h["exemplars"][-1]["le"] == "+Inf"
    assert got["histograms"]["wide"]["label_sets_dropped"] == 3


def test_singleton_metrics_attribute_to_executing_node():
    """The process-wide registry records into the node handling the
    current request, and its exemplar resolves in that node's ring."""
    tel_a, tel_b = port_tracing.Telemetry("na"), port_tracing.Telemetry("nb")
    registry = ShardMeshRegistry()
    registry.metrics = tel_b.metrics
    with port_tracing.activate(tel_a.tracer), \
            tel_a.tracer.start_span("search"):
        assert port_tracing.active_metrics() is tel_a.metrics
        registry.record_launch_wall(7_000_000)
    hist_a = tel_a.metrics.stats()["histograms"]
    assert MESH_LAUNCH_WALL_MS in hist_a
    assert MESH_LAUNCH_WALL_MS not in tel_b.metrics.stats()["histograms"]
    ring = {s.trace_id for s in tel_a.tracer.finished_spans()}
    exemplars = hist_a[MESH_LAUNCH_WALL_MS]["exemplars"]
    assert exemplars and all(ex["trace_id"] in ring for ex in exemplars)
    assert port_tracing.active_metrics() is None
    registry.record_launch_wall(3_000_000)
    assert MESH_LAUNCH_WALL_MS in tel_b.metrics.stats()["histograms"]


# -- slow logs -------------------------------------------------------------


def _slowlog_run(slowlog, tracing) -> list:
    sl = slowlog.SlowLog("search")
    assert sl.maybe_log(10_000, "i", "x") is None  # disabled by default
    sl.configure({"warn": 100, "info": "10ms", "debug": -1})
    levels = [sl.maybe_log(t, "i", f"q{t}") for t in (5, 50, 500)]
    sl.configure({"warn": "1s"})
    assert sl.thresholds["warn"] == 1000
    tracer = tracing.Tracer()
    with tracer.start_span("search") as span:
        sl.maybe_log(5_000, "i", "traced")
    entries = sl.entries()
    assert entries[-1]["trace_id"] == span.trace_id
    assert "trace_id" not in entries[0]
    return levels + [{k: v for k, v in e.items() if k != "trace_id"}
                     for e in entries]


def test_slowlog_thresholds_are_the_references():
    got = _slowlog_run(port_slowlog, port_tracing)
    assert got == _slowlog_run(ref_slowlog, ref_tracing)
    assert got[:3] == [None, "info", "warn"]


def test_index_settings_configure_node_slowlog(tmp_path):
    n = TorchNode(tmp_path / "n", device="cpu")
    n.create_index("sl", {"settings": {"index": {
        "search": {"slowlog": {"threshold": {"query": {"warn": "0ms"}}}},
        "indexing": {"slowlog": {"threshold": {"index": {"info": "0ms"}}}},
    }}, "mappings": {"properties": {"x": {"type": "keyword"}}}})
    n.index_doc("sl", "1", {"x": "y"})
    n.refresh("sl")
    n.search("sl", {"query": {"match_all": {}}})
    assert n.search_slowlog.entries(), "0ms warn threshold must log"
    assert n.indexing_slowlog.entries()[-1]["detail"] == "id[1]"
    # the index leaves: its thresholds leave with it
    n.delete_index("sl")
    assert set(n.search_slowlog.thresholds.values()) == {-1}
    n.close()


# -- the node's wiring -----------------------------------------------------


def test_search_emits_one_span_and_metrics(node):
    node.telemetry.tracer.clear()
    before = node.telemetry.metrics.counter("search.total").value
    node.search("t", {"query": {"match": {"msg": "message"}}})
    node.count("t", {"query": {"match_all": {}}})
    spans = [s for s in node.telemetry.tracer.finished_spans()
             if s.name == "search"]
    assert len(spans) == 2
    assert spans[0].attributes["indices"] == "t"
    assert "took_ms" in spans[0].attributes
    m = node.telemetry.metrics
    assert m.counter("search.total").value == before + 2
    stats = m.stats()["histograms"]["search.took_ms"]
    assert stats["count"] == 2
    assert {tuple(sorted(s["labels"].items())) for s in stats["series"]} == \
        {(("index", "t"),), (("lane", "interactive"),)}


def test_real_search_slowlog_entry_carries_trace_id(node):
    node.search_slowlog.configure({"info": 0})
    node.telemetry.tracer.clear()
    node.search("t", {"query": {"match": {"msg": "message"}}})
    entry = node.search_slowlog.entries()[-1]
    search_span = next(s for s in node.telemetry.tracer.finished_spans()
                       if s.name == "search")
    assert entry["trace_id"] == search_span.trace_id


def test_http_request_span_parents_the_search_span(node):
    from opensearch_tpu_torch.rest.http import HttpServer

    srv = HttpServer(node, "127.0.0.1", 0)
    srv.start_in_thread()
    try:
        node.telemetry.tracer.clear()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/t/_search",
            data=json.dumps({"query": {"match_all": {}}}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 200
    finally:
        srv.stop_thread()
    spans = {s.name: s for s in node.telemetry.tracer.finished_spans()}
    http, search = spans["http_request"], spans["search"]
    assert http.attributes["method"] == "POST"
    assert http.attributes["path"] == "/t/_search"
    assert http.attributes["status"] == 200
    assert search.parent_id == http.span_id
    assert search.trace_id == http.trace_id


def test_batcher_flush_event_and_metrics():
    """A coalesced batch rides the leader's span as a knn.batch.flush
    event and records its size, waits and dispatch count into the
    executing node's metrics; a solo launch emits no event."""
    tel = port_tracing.Telemetry("b")
    b = batcher_mod.KnnDispatchBatcher(max_batch_size=2, max_wait_ms=1000)
    b._ewma = 10.0  # no solo fast path: the second arrival flushes by size
    import threading

    results = {}

    def launch(payloads):
        return [p * 2 for p in payloads]

    def run(i):
        with port_tracing.activate(tel.tracer), \
                tel.tracer.start_span(f"req{i}"):
            results[i] = b.dispatch("k", i, launch, tune_key=None).value

    b.configure(auto_tune=False)
    threads = [threading.Thread(target=run, args=(i,)) for i in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert results == {1: 2, 2: 4}
    events = [e for s in tel.tracer.finished_spans() for e in s.events]
    assert [(e["name"], e["attributes"]["merged"]) for e in events] == \
        [("knn.batch.flush", 2)]
    stats = tel.metrics.stats()
    assert stats["counters"]["knn.batch.dispatches"] == 1
    assert stats["histograms"]["knn.batch.size"]["max"] == 2
    assert stats["histograms"]["knn.batch.queue_wait_ms"]["count"] == 2
    # solo: no event
    with port_tracing.activate(tel.tracer), tel.tracer.start_span("solo") \
            as span:
        b.dispatch(None, 3, launch)
    assert span.events == []


def test_batcher_first_signature_counts_a_compile_entry():
    from opensearch_tpu_torch.telemetry.device_ledger import default_ledger

    b = batcher_mod.KnnDispatchBatcher()
    before = default_ledger.compile_stats().get("fam_x", {}).get(
        "entries", 0)
    b.dispatch(None, 1, lambda p: (list(p), True), family="fam_x")
    b.dispatch(None, 1, lambda p: (list(p), False), family="fam_x")
    b.dispatch(None, 1, lambda p: (list(p), True))  # no family: not counted
    assert default_ledger.compile_stats()["fam_x"]["entries"] == before + 1


def test_knn_search_records_batcher_metrics(tmp_path):
    """A per-shard kNN launch records into the node's registry."""
    from opensearch_tpu_torch.search import distributed_serving

    n = TorchNode(tmp_path / "k", device="cpu")
    n.create_index("v", {"mappings": {"properties": {"v": {
        "type": "knn_vector", "dimension": 4}}}})
    rng = np.random.default_rng(0)
    n.bulk([("index", {"_index": "v", "_id": str(i)},
             {"v": rng.standard_normal(4).tolist()}) for i in range(20)],
           refresh=True)
    distributed_serving.enabled = False
    try:
        n.search("v", {"query": {"knn": {"v": {"vector": [0.1] * 4,
                                                "k": 3}}}})
    finally:
        distributed_serving.enabled = True
    counters = n.telemetry.metrics.stats()["counters"]
    assert counters["knn.batch.dispatches"] >= 1
    assert counters["knn.dispatch.exact"] >= 1
    n.close()
