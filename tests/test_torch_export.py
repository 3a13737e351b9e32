"""Span export (telemetry/export.py) in the port against the reference.

The single-node cases of tests/test_export.py run on both packages'
modules (the port's export, tracing and randutil beside the reference's):
the OTLP round trip, the file sink, an injected HTTP transport and its
failures, the tail-keeping sampler under a fixed seed, the bounded
accounting, the settings adapter and the settings' validation; each case's
result is compared between the packages. Then the port alone: an HTTP
exporter without a transport opens no socket and counts every span
dropped; a TorchNode whose cluster settings name the file exporter writes
its search spans as OTLP-JSON lines that `POST /_otel/flush` drains, with
the same span names as the reference node's; `close` flushes and detaches
the exporter.
"""

from __future__ import annotations

import json
import random
import socket
import types

import pytest

pytest.importorskip("jax")

import opensearch_tpu.cluster.cluster_settings as ref_settings
import opensearch_tpu.common.errors as ref_errors
import opensearch_tpu.common.randutil as ref_randutil
import opensearch_tpu.telemetry.export as ref_export
import opensearch_tpu.telemetry.tracing as ref_tracing
import opensearch_tpu_torch.cluster.cluster_settings as port_settings
import opensearch_tpu_torch.common.errors as port_errors
import opensearch_tpu_torch.common.randutil as port_randutil
import opensearch_tpu_torch.telemetry.export as port_export
import opensearch_tpu_torch.telemetry.tracing as port_tracing
from opensearch_tpu_torch.telemetry import device_ledger as port_ledger
from opensearch_tpu_torch.node import TorchNode

from test_torch_scroll_pit import Pair

PACKAGES = {
    "reference": types.SimpleNamespace(
        export=ref_export, tracing=ref_tracing, randutil=ref_randutil,
        settings=ref_settings, errors=ref_errors),
    "port": types.SimpleNamespace(
        export=port_export, tracing=port_tracing, randutil=port_randutil,
        settings=port_settings, errors=port_errors),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _exporter(pkg, sink=None, **kw):
    sink = sink if sink is not None else pkg.export.MemorySink()
    kw.setdefault("synchronous", True)
    kw.setdefault("sample_ratio", 0.0)
    kw.setdefault("slow_threshold_ms", 1_000)
    kw.setdefault("rng", random.Random(0))
    return pkg.export.SpanExporter(sink, service_name="n1", **kw), sink


def _fast_trace(tracer, name="fast"):
    with tracer.start_span(name) as s:
        pass
    return s


def _slow_trace(tracer, ms: float, name="slow"):
    # a planted duration: begin, then a forged end, through the ring and
    # the export path
    span = tracer.begin_span(name)
    span.end_ns = span.start_ns + int(ms * 1e6)
    tracer._finished.append(span)
    if tracer.exporter is not None:
        tracer.exporter.on_span_end(span, tracer.name)
    return span


def _stats(exp) -> dict:
    return {k: v for k, v in exp.snapshot_stats().items()
            if not k.endswith("_ms") and k != "sink"}


def test_ids_parents_attributes_survive(pkg):
    Span = pkg.tracing.Span
    spans = [Span("trace-t", "n1-s000001", None, "root",
                  {"k": "v", "n": 3, "f": 1.5, "b": True},
                  start_ns=10, end_ns=20),
             Span("trace-t", "n1-s000002", "n1-s000001", "child",
                  {"error": "boom"}, start_ns=12, end_ns=15)]
    doc = pkg.export.spans_to_otlp(spans, "n1")
    back = pkg.export.parse_otlp(json.loads(json.dumps(doc)))
    assert [(s.trace_id, s.span_id, s.parent_id, s.name, s.start_ns,
             s.end_ns, s.attributes) for s in back] == \
        [(s.trace_id, s.span_id, s.parent_id, s.name, s.start_ns,
          s.end_ns, s.attributes) for s in spans]
    otlp = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert otlp[0]["status"]["code"] == 1
    assert otlp[1]["status"] == {"code": 2, "message": "boom"}
    # the same document from both packages
    other = PACKAGES["reference"].export.spans_to_otlp(spans, "n1")
    assert doc == other


def test_file_sink_ndjson(pkg, tmp_path):
    sink = pkg.export.FileSink(tmp_path / "otel" / "spans.jsonl")
    exp, _ = _exporter(pkg, sink, slow_threshold_ms=0)
    tracer = pkg.tracing.Tracer(name="n1")
    tracer.exporter = exp
    _fast_trace(tracer, "a")
    _fast_trace(tracer, "b")
    exp.flush()
    lines = (tmp_path / "otel" / "spans.jsonl").read_text().splitlines()
    assert len(lines) == 2
    names = [s.name for line in lines
             for s in pkg.export.parse_otlp(json.loads(line))]
    assert names == ["a", "b"]
    assert sink.stats()["requests"] == 2


def test_http_sink_posts_and_failures_drop(pkg):
    posted = []
    sink = pkg.export.HttpSink(
        "http://collector:4318/v1/traces",
        post=lambda url, body: posted.append((url, json.loads(body))))
    exp, _ = _exporter(pkg, sink, slow_threshold_ms=0)
    tracer = pkg.tracing.Tracer(name="n1")
    tracer.exporter = exp
    _fast_trace(tracer)
    exp.flush()
    assert posted and posted[0][0] == "http://collector:4318/v1/traces"
    assert exp.snapshot_stats()["spans_exported"] == 1

    def post_fail(url, body):
        raise OSError("connection refused")

    exp2, _ = _exporter(pkg, pkg.export.HttpSink("http://x", post=post_fail),
                        slow_threshold_ms=0)
    tracer2 = pkg.tracing.Tracer(name="n1")
    tracer2.exporter = exp2
    _fast_trace(tracer2)
    exp2.flush()
    st = exp2.snapshot_stats()
    assert st["spans_dropped_export_error"] == 1
    assert st["export_errors"] == 1
    assert st["spans_seen"] == st["spans_exported"] + st["spans_dropped"]


def test_error_trace_always_kept(pkg):
    exp, sink = _exporter(pkg, sample_ratio=0.0)
    tracer = pkg.tracing.Tracer(name="n1")
    tracer.exporter = exp
    with pytest.raises(ValueError):
        with tracer.start_span("boom"):
            raise ValueError("x")
    exp.flush()
    assert [s.name for s in sink.spans()] == ["boom"]
    assert exp.snapshot_stats()["traces_kept_error"] == 1


def _sampled_run(pkg):
    exp, sink = _exporter(pkg, rng=None, sample_ratio=0.25,
                          slow_threshold_ms=500)
    tracer = pkg.tracing.Tracer(name="n1")
    tracer.exporter = exp
    with pkg.randutil.rng_scope(random.Random(42)):
        for i in range(20):
            _fast_trace(tracer, f"fast-{i}")
        _slow_trace(tracer, 800.0)
    exp.flush()
    return {s.name for s in sink.spans()}, _stats(exp)


def test_slow_trace_kept_fast_sampled_out(pkg):
    exported, st = _sampled_run(pkg)
    rng = random.Random(42)
    expected = {f"fast-{i}" for i in range(20) if rng.random() < 0.25}
    assert exported == expected | {"slow"}
    assert st["traces_kept_slow"] == 1
    assert st["traces_kept_sampled"] == len(expected)
    # the same decisions, the same ledger, in both packages
    assert (exported, st) == _sampled_run(PACKAGES["reference"])


def test_dynamic_threshold_applies_live(pkg):
    exp, sink = _exporter(pkg, slow_threshold_ms=10_000, sample_ratio=0.0)
    tracer = pkg.tracing.Tracer(name="n1")
    tracer.exporter = exp
    _slow_trace(tracer, 50.0, "before")
    exp.configure(slow_threshold_ms=20)
    _slow_trace(tracer, 50.0, "after")
    exp.flush()
    assert [s.name for s in sink.spans()] == ["after"]


def test_late_fragment_follows_cached_verdict(pkg):
    exp, sink = _exporter(pkg, slow_threshold_ms=0)
    tracer = pkg.tracing.Tracer(name="n1")
    tracer.exporter = exp
    root = _fast_trace(tracer, "root")
    late = pkg.tracing.Span(root.trace_id, "n1-s9999ff", root.span_id,
                            "late", start_ns=1, end_ns=2)
    tracer._finished.append(late)
    exp.on_span_end(late, "n1")
    exp.flush()
    assert [s.name for s in sink.spans()] == ["root", "late"]


def _accounting_holds(exp) -> None:
    st = exp.snapshot_stats()
    resident = st["pending_spans"] + st["queued_spans"]
    assert st["spans_seen"] == \
        st["spans_exported"] + st["spans_dropped"] + resident, st


def test_queue_overflow_drops_with_counter(pkg):
    exp, _ = _exporter(pkg, pkg.export.MemorySink(), slow_threshold_ms=0,
                       max_queue=2)
    tracer = pkg.tracing.Tracer(name="n1")
    tracer.exporter = exp
    with tracer.start_span("root"):
        with tracer.start_span("a"):
            pass
        with tracer.start_span("b"):
            pass
    assert exp.snapshot_stats()["spans_dropped_overflow"] == 3
    _accounting_holds(exp)


def test_pending_buffer_evicts_oldest(pkg):
    exp, _sink = _exporter(pkg, slow_threshold_ms=0)
    tracer = pkg.tracing.Tracer(name="n1")
    tracer.exporter = exp
    for i in range(pkg.export.MAX_PENDING_TRACES + 5):
        s = pkg.tracing.Span(f"trace-orphan-{i}", f"n1-s{i:06x}",
                             "n1-s777777", "orphan", start_ns=1, end_ns=2)
        tracer._finished.append(s)
        exp.on_span_end(s, "n1")
    st = exp.snapshot_stats()
    assert st["pending_traces"] <= pkg.export.MAX_PENDING_TRACES
    assert st["spans_exported"] >= 5
    _accounting_holds(exp)
    exp.flush()
    st = exp.snapshot_stats()
    assert st["pending_spans"] == 0 and st["queued_spans"] == 0


def test_flush_on_shutdown_drains_pending(pkg):
    exp, sink = _exporter(pkg, slow_threshold_ms=0)
    tracer = pkg.tracing.Tracer(name="n1")
    tracer.exporter = exp
    s = pkg.tracing.Span("trace-x", "n1-s000001", "n1-s000099", "fragment",
                         start_ns=1, end_ns=2)
    tracer._finished.append(s)
    exp.on_span_end(s, "n1")
    assert exp.snapshot_stats()["pending_spans"] == 1
    exp.close()
    assert [x.name for x in sink.spans()] == ["fragment"]


def test_apply_cycle_none_file_retune_none(pkg, tmp_path):
    tel = pkg.tracing.Telemetry(name="nodeX")
    pkg.export.apply_tracing_settings(tel, {}, tmp_path)
    assert tel.tracer.exporter is None
    flat = {"telemetry.tracing.exporter": "file",
            "telemetry.tracing.slow_threshold_ms": "250ms",
            "telemetry.tracing.sample_ratio": "0.5"}
    pkg.export.apply_tracing_settings(tel, flat, tmp_path)
    exp = tel.tracer.exporter
    assert exp is not None and exp.mode == "file"
    assert exp.slow_threshold_ms == 250 and exp.sample_ratio == 0.5
    assert str(tmp_path) in exp.sink.stats()["path"]
    flat["telemetry.tracing.slow_threshold_ms"] = "2s"
    pkg.export.apply_tracing_settings(tel, flat, tmp_path)
    assert tel.tracer.exporter is exp and exp.slow_threshold_ms == 2_000
    pkg.export.apply_tracing_settings(
        tel, {"telemetry.tracing.exporter": "none"}, tmp_path)
    assert tel.tracer.exporter is None


def test_settings_registered_and_validated(pkg):
    for key in ("telemetry.tracing.exporter",
                "telemetry.tracing.slow_threshold_ms",
                "telemetry.tracing.sample_ratio"):
        assert key in pkg.settings.DYNAMIC_CLUSTER_SETTINGS
    pkg.settings.validate_settings({"telemetry.tracing.exporter": "file",
                                    "telemetry.tracing.sample_ratio": 0.25})
    for bad in ({"telemetry.tracing.exporter": "carrier"},
                {"telemetry.tracing.sample_ratio": 1.5}):
        with pytest.raises(pkg.errors.IllegalArgumentException):
            pkg.settings.validate_settings(bad)
    assert set(pkg.settings.DYNAMIC_CLUSTER_SETTINGS) == \
        set(ref_settings.DYNAMIC_CLUSTER_SETTINGS)


# -- the port alone --------------------------------------------------------------


def test_http_export_without_a_transport_opens_no_socket(monkeypatch):
    def no_socket(*a, **kw):
        raise AssertionError("a socket was opened")

    monkeypatch.setattr(socket, "socket", no_socket)
    monkeypatch.setattr(socket, "create_connection", no_socket)
    tel = port_tracing.Telemetry(name="n1")
    port_export.apply_tracing_settings(
        tel, {"telemetry.tracing.exporter": "http://collector:4318/v1/x",
              "telemetry.tracing.slow_threshold_ms": 0}, "/nonexistent")
    exp = tel.tracer.exporter
    exp._synchronous = True
    _fast_trace(tel.tracer)
    exp.flush()
    st = exp.snapshot_stats()
    assert st["spans_exported"] == 0
    assert st["spans_seen"] == st["spans_dropped"] == 1
    port_export.close_exporter(tel)


def _spans_file(node) -> list:
    path = node.data_path / "otel" / f"spans-{node.node_name}.jsonl"
    return [s for line in path.read_text().splitlines()
            for s in port_export.parse_otlp(json.loads(line))]


def test_node_exports_its_search_spans(tmp_path):
    pair = Pair(tmp_path)
    try:
        for n in pair.nodes:
            n.put_cluster_settings({"transient": {
                "telemetry.tracing.exporter": "file",
                "telemetry.tracing.slow_threshold_ms": "0ms"}})
            n.create_index("t", {"mappings": {"properties": {
                "msg": {"type": "text"}}}})
            n.index_doc("t", "1", {"msg": "hello"}, refresh=True)
            n.search("t", {"query": {"match": {"msg": "hello"}}})
            n.telemetry.tracer.exporter.flush()
        names = [sorted({s.name for s in _spans_file(n)})
                 for n in pair.nodes]
        assert "search" in names[1]
        assert names[0] == names[1]
        from opensearch_tpu_torch.rest.handlers import otel_flush

        status, body = otel_flush(pair.port, {}, {}, None)
        exp = body["nodes"]["node-0"]
        assert status == 200 and exp["flushed"] is True
        assert exp["exporter"]["spans_exported"] > 0
        assert exp["device"] == port_ledger.stats_section()
    finally:
        pair.close()
    # close() flushed and detached the exporter
    assert pair.port.telemetry.tracer.exporter is None


def test_otel_flush_without_an_exporter(tmp_path):
    from opensearch_tpu.node import TpuNode
    from opensearch_tpu.rest.handlers import otel_flush as ref_flush
    from opensearch_tpu_torch.rest.handlers import otel_flush

    port = TorchNode(tmp_path / "p", device="cpu")
    ref = TpuNode(tmp_path / "r")
    try:
        (s1, b1), (s2, b2) = otel_flush(port, {}, {}, None), \
            ref_flush(ref, {}, {}, None)
        assert s1 == s2 == 200
        for b in (b1, b2):
            b["nodes"]["node-0"].pop("device")
        assert b1 == b2
    finally:
        port.close()
        ref.close()
