"""OTel span export: tail-keeping sampler + bounded queue + OTLP-JSON sinks.

Counterpart of opensearch_tpu/telemetry/export.py, a copy with its
imports rewritten (the reference's telemetry-otel plugin: a
BatchSpanProcessor in front of an OTLP exporter):

- :class:`SpanExporter` hangs off a ``Tracer`` (tracing.py calls
  ``on_span_end`` for every finished span) and ships whole traces through
  a bounded queue to a sink, with ``spans_exported`` / ``spans_dropped``
  accounting: every span offered is exported, dropped (with a reason) or
  still resident, and ``snapshot_stats()`` shows it.
- Tail-keeping sampling: the decision runs at trace completion over the
  buffered spans. Any error span, or any span slower than the dynamic
  ``telemetry.tracing.slow_threshold_ms``, keeps the whole trace; the rest
  sample at ``telemetry.tracing.sample_ratio`` through
  :mod:`opensearch_tpu_torch.common.randutil`. A fragment's local root (a
  span whose parent is remote or absent) triggers the decision; late
  fragments of a decided trace follow the cached verdict.
- Sinks: :class:`FileSink` appends one OTLP-JSON export request a line,
  :class:`HttpSink` POSTs the same document through an injected transport
  (nothing here opens a socket by itself), :class:`MemorySink` collects
  in process for tests.

Span and trace ids stay the tracer's string ids (``n1-s0000a3``), so the
export rebuilds the ring's trace tree exactly; ``parse_otlp`` round-trips
them.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable

from opensearch_tpu_torch.common import randutil
from opensearch_tpu_torch.common.settings import Property, Setting
from opensearch_tpu_torch.telemetry.tracing import Span

logger = logging.getLogger(__name__)

# -- settings (registered dynamic in cluster/cluster_settings.py) -----------


def _validate_exporter(v: str) -> None:
    if v in ("none", "file") or v.startswith(("http://", "https://")):
        return
    raise ValueError(
        f"telemetry.tracing.exporter must be 'none', 'file', or an "
        f"http(s):// OTLP endpoint, got [{v}]"
    )


EXPORTER_SETTING = Setting(
    "telemetry.tracing.exporter", "none", str,
    Property.NODE_SCOPE, Property.DYNAMIC, validator=_validate_exporter,
)
SLOW_THRESHOLD_SETTING = Setting.time_setting(
    "telemetry.tracing.slow_threshold_ms", 1_000,
    Property.NODE_SCOPE, Property.DYNAMIC,
)


def _validate_ratio(v: float) -> None:
    if not 0.0 <= v <= 1.0:
        raise ValueError(
            f"telemetry.tracing.sample_ratio must be in [0, 1], got [{v}]"
        )


SAMPLE_RATIO_SETTING = Setting(
    "telemetry.tracing.sample_ratio", 0.1, float,
    Property.NODE_SCOPE, Property.DYNAMIC, validator=_validate_ratio,
)

TRACING_SETTINGS = (
    EXPORTER_SETTING, SLOW_THRESHOLD_SETTING, SAMPLE_RATIO_SETTING,
)


# -- OTLP-JSON encoding ------------------------------------------------------


def _otlp_value(v: Any) -> dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _from_otlp_value(v: dict) -> Any:
    if "boolValue" in v:
        return bool(v["boolValue"])
    if "intValue" in v:
        return int(v["intValue"])
    if "doubleValue" in v:
        return float(v["doubleValue"])
    return v.get("stringValue")


def span_to_otlp(span: Span) -> dict:
    out = {
        "traceId": span.trace_id,
        "spanId": span.span_id,
        "name": span.name,
        "startTimeUnixNano": str(span.start_ns),
        "endTimeUnixNano": str(span.end_ns),
        "attributes": [
            {"key": k, "value": _otlp_value(v)}
            for k, v in span.attributes.items()
        ],
        "status": (
            {"code": 2, "message": str(span.attributes["error"])}
            if "error" in span.attributes else {"code": 1}
        ),
    }
    if span.parent_id is not None:
        out["parentSpanId"] = span.parent_id
    # span EVENTS (per-span logs) ride the export in the OTLP event shape;
    # the bound lives at record time (tracing.MAX_SPAN_EVENTS) and the
    # overflow count survives as droppedEventsCount
    if span.events:
        out["events"] = [
            {"timeUnixNano": str(e["ts_ns"]), "name": e["name"],
             "attributes": [
                 {"key": k, "value": _otlp_value(v)}
                 for k, v in e["attributes"].items()
             ]}
            for e in span.events
        ]
    if span.dropped_events:
        out["droppedEventsCount"] = span.dropped_events
    return out


def spans_to_otlp(spans: list[Span], service_name: str) -> dict:
    """One OTLP/HTTP-JSON ExportTraceServiceRequest for a batch of spans."""
    return {
        "resourceSpans": [{
            "resource": {"attributes": [
                {"key": "service.name",
                 "value": {"stringValue": service_name}},
            ]},
            "scopeSpans": [{
                "scope": {"name": "opensearch_tpu"},
                "spans": [span_to_otlp(s) for s in spans],
            }],
        }],
    }


def parse_otlp(doc: dict) -> list[Span]:
    """Reconstruct Span objects from one export request (the round-trip
    proof: ids, parents, names, attributes and times all survive)."""
    out: list[Span] = []
    for rs in doc.get("resourceSpans", []):
        for ss in rs.get("scopeSpans", []):
            for s in ss.get("spans", []):
                out.append(Span(
                    trace_id=s["traceId"],
                    span_id=s["spanId"],
                    parent_id=s.get("parentSpanId"),
                    name=s["name"],
                    attributes={
                        a["key"]: _from_otlp_value(a["value"])
                        for a in s.get("attributes", [])
                    },
                    start_ns=int(s["startTimeUnixNano"]),
                    end_ns=int(s["endTimeUnixNano"]),
                    events=[
                        {"name": e["name"],
                         "ts_ns": int(e["timeUnixNano"]),
                         "attributes": {
                             a["key"]: _from_otlp_value(a["value"])
                             for a in e.get("attributes", [])
                         }}
                        for e in s.get("events", [])
                    ],
                    dropped_events=int(s.get("droppedEventsCount", 0)),
                ))
    return out


# -- sinks -------------------------------------------------------------------


class MemorySink:
    """Collects export requests in-process (tests, deterministic soak)."""

    def __init__(self) -> None:
        self.docs: list[dict] = []

    def write(self, doc: dict) -> None:
        self.docs.append(doc)

    def spans(self) -> list[Span]:
        return [s for doc in self.docs for s in parse_otlp(doc)]

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def stats(self) -> dict:
        return {"kind": "memory", "requests": len(self.docs)}


class FileSink:
    """Appends one OTLP-JSON export request per line (ndjson): the file
    receiver / `otlp-stdout` shape, greppable by trace id."""

    def __init__(self, path) -> None:
        from pathlib import Path

        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # line-buffered: every export request reaches the file as soon as
        # it is written, so a tail -f / crash post-mortem sees the trace
        self._fh = open(self.path, "a", encoding="utf-8", buffering=1)
        self._lock = threading.Lock()
        self.requests_written = 0

    def write(self, doc: dict) -> None:
        line = json.dumps(doc, separators=(",", ":"))
        with self._lock:
            self._fh.write(line + "\n")
            self.requests_written += 1

    def flush(self) -> None:
        with self._lock:
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            try:
                self._fh.flush()
                self._fh.close()
            except ValueError:  # already closed
                pass

    def stats(self) -> dict:
        with self._lock:
            requests = self.requests_written
        return {"kind": "file", "path": str(self.path),
                "requests": requests}


class HttpSink:
    """POSTs export requests to an OTLP/HTTP endpoint through an injected
    transport (`post(url, body_bytes)`). The port opens no socket of its
    own: without a transport every POST raises "not yet ported", and the
    exporter counts the spans as dropped, as it does for any failing
    POST."""

    def __init__(self, url: str,
                 post: Callable[[str, bytes], None] | None = None) -> None:
        self.url = url
        self._post = post or self._no_transport
        self.requests_sent = 0

    @staticmethod
    def _no_transport(url: str, body: bytes) -> None:
        raise NotImplementedError(
            "OTLP/HTTP span export is not yet ported to opensearch_tpu_torch")

    def write(self, doc: dict) -> None:
        self._post(self.url, json.dumps(doc).encode())
        self.requests_sent += 1

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def stats(self) -> dict:
        return {"kind": "http", "url": self.url,
                "requests": self.requests_sent}


# -- the exporter ------------------------------------------------------------

# bounds: a node buffers at most MAX_PENDING_TRACES undecided trace
# fragments of MAX_SPANS_PER_TRACE spans each, and at most max_queue spans
# sit between the sampler and the sink. Overflow always DROPS with a
# counter, never blocks the serving path or grows without bound (TPU009).
MAX_PENDING_TRACES = 256
MAX_SPANS_PER_TRACE = 512
MAX_DECIDED_TRACES = 4096


class SpanExporter:
    """Tail-keeping sampler + bounded background export queue.

    ``on_span_end`` is the only producer-side entry point; it buffers the
    span under its trace id and, when the trace's LOCAL ROOT finishes (a
    span whose parent id is missing or minted by another node's tracer),
    decides the whole fragment at once:

      keep if any span errored                (keep_error)
      keep if any span >= slow_threshold_ms   (keep_slow)
      keep with P(sample_ratio) via randutil  (keep_sampled)
      drop otherwise                          (spans_dropped_sampled)

    Kept spans enqueue toward the sink; a worker thread drains the queue
    (``synchronous=True`` drains inline for the deterministic sim).
    ``flush()`` force-decides every pending fragment and drains — the
    node-shutdown hook, so a crash investigation never loses the tail.
    """

    def __init__(self, sink, *, service_name: str = "node",
                 slow_threshold_ms: float = 1_000.0,
                 sample_ratio: float = 0.1,
                 max_queue: int = 2_048,
                 rng=None, synchronous: bool = False,
                 mode: str = "file") -> None:
        self.sink = sink
        self.service_name = service_name
        self.slow_threshold_ms = float(slow_threshold_ms)
        self.sample_ratio = float(sample_ratio)
        self.max_queue = int(max_queue)
        self.mode = mode
        self._rng = rng
        self._synchronous = synchronous
        self._lock = threading.Lock()
        self._pending: OrderedDict[str, list[Span]] = OrderedDict()
        self._decided: OrderedDict[str, bool] = OrderedDict()
        # flat span queue: len() must be O(1) — the wake/cap checks run
        # once per finished span on the serving path
        self._queue: deque[Span] = deque()
        # spans popped by a drain but not yet through the sink: still
        # RESIDENT for the accounting identity (seen == exported + dropped
        # + pending + queued + exporting)
        self._exporting = 0
        self._wake = threading.Event()
        self._closed = False
        self.counters = {
            "spans_seen": 0, "spans_exported": 0,
            "spans_dropped_sampled": 0, "spans_dropped_overflow": 0,
            "spans_dropped_export_error": 0,
            "traces_kept_error": 0, "traces_kept_slow": 0,
            "traces_kept_sampled": 0, "traces_dropped": 0,
            "export_errors": 0,
        }
        self._worker: threading.Thread | None = None
        if not synchronous:
            self._worker = threading.Thread(
                target=self._worker_loop, name=f"otel-export-{service_name}",
                daemon=True,
            )
            self._worker.start()

    # -- producer side -----------------------------------------------------

    def on_span_end(self, span: Span, tracer_name: str) -> None:
        if self._closed:
            return
        local_prefix = f"{tracer_name}-"
        with self._lock:
            self.counters["spans_seen"] += 1
            tid = span.trace_id
            if tid in self._decided:
                # a late fragment of an already-decided trace follows the
                # cached verdict so one trace is never half-exported
                self._decided.move_to_end(tid)
                if self._decided[tid]:
                    self._enqueue_locked([span])
                else:
                    self.counters["spans_dropped_sampled"] += 1
            else:
                buf = self._pending.setdefault(tid, [])
                if len(buf) >= MAX_SPANS_PER_TRACE:
                    self.counters["spans_dropped_overflow"] += 1
                else:
                    buf.append(span)
                local_root = (span.parent_id is None
                              or not span.parent_id.startswith(local_prefix))
                if local_root:
                    self._decide_locked(tid)
                while len(self._pending) > MAX_PENDING_TRACES:
                    # decide the oldest fragment now rather than dropping
                    # it silently: its local root may never end (leaked
                    # span, killed node) but its spans still count
                    oldest = next(iter(self._pending))
                    self._decide_locked(oldest)
            # the worker polls on a short timer; an explicit wake is only
            # needed when the queue nears its cap (waking per span would
            # context-switch the GIL away from the serving threads — the
            # measured difference between ~5 and ~100+ us per span)
            wake = len(self._queue) > self.max_queue // 2
        if self._synchronous:
            self._drain()
        elif wake:
            self._wake.set()

    def _decide_locked(self, trace_id: str) -> None:
        spans = self._pending.pop(trace_id, [])
        if not spans:
            return
        keep, reason = self._decision(spans)
        self._decided[trace_id] = keep
        self._decided.move_to_end(trace_id)
        while len(self._decided) > MAX_DECIDED_TRACES:
            self._decided.popitem(last=False)
        if keep:
            self.counters[f"traces_kept_{reason}"] += 1
            self._enqueue_locked(spans)
        else:
            self.counters["traces_dropped"] += 1
            self.counters["spans_dropped_sampled"] += len(spans)

    def _decision(self, spans: list[Span]) -> tuple[bool, str]:
        if any("error" in s.attributes for s in spans):
            return True, "error"
        threshold_ns = self.slow_threshold_ms * 1e6
        if any(s.duration_ns >= threshold_ns for s in spans):
            return True, "slow"
        rng = self._rng if self._rng is not None else randutil.get_rng()
        if rng.random() < self.sample_ratio:
            return True, "sampled"
        return False, "sampled_out"

    def _enqueue_locked(self, spans: list[Span]) -> None:
        if len(self._queue) + len(spans) > self.max_queue:
            self.counters["spans_dropped_overflow"] += len(spans)
            return
        self._queue.extend(spans)

    # -- consumer side -----------------------------------------------------

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._queue:
                    return
                # everything queued leaves as ONE export request: an OTLP
                # request carries any number of spans, and per-trace writes
                # would pay the serialization+IO round-trip per trace
                batch = list(self._queue)
                self._queue.clear()
                self._exporting += len(batch)
            try:
                self.sink.write(spans_to_otlp(batch, self.service_name))
            except Exception as e:  # noqa: BLE001 - sink failure == drop
                with self._lock:
                    self.counters["export_errors"] += 1
                    self.counters["spans_dropped_export_error"] += len(batch)
                    self._exporting -= len(batch)
                logger.warning("otel span export failed: %s", e)
            else:
                with self._lock:
                    self.counters["spans_exported"] += len(batch)
                    self._exporting -= len(batch)

    # worker poll period: spans reach the sink within this bound without
    # a per-span wakeup on the serving path
    _POLL_S = 0.05

    def _worker_loop(self) -> None:
        while not self._closed:
            self._wake.wait(timeout=self._POLL_S)
            self._wake.clear()
            self._drain()
        self._drain()

    # -- control surface ---------------------------------------------------

    def configure(self, *, slow_threshold_ms: float | None = None,
                  sample_ratio: float | None = None) -> None:
        """Live-apply the dynamic sampler settings (the batcher-settings
        adapter pattern: one consumer per component). Plain float rebinds
        — each is read once per decision, so no lock is needed and a
        mid-update decision simply uses one old and one new knob."""
        if slow_threshold_ms is not None:
            self.slow_threshold_ms = float(slow_threshold_ms)
        if sample_ratio is not None:
            self.sample_ratio = float(sample_ratio)

    def flush(self, timeout_s: float = 2.0) -> None:
        """Force-decide every pending fragment (their roots may never end:
        shutdown, killed peer) and push everything through the sink,
        waiting out any batch a concurrent drain holds in flight."""
        with self._lock:
            for tid in list(self._pending):
                self._decide_locked(tid)
        self._drain()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._exporting == 0 and not self._queue:
                    break
            time.sleep(0.005)
        self.sink.flush()

    def close(self) -> None:
        self.flush()
        self._closed = True
        self._wake.set()
        worker = self._worker
        if worker is not None and worker.is_alive() \
                and worker is not threading.current_thread():
            worker.join(timeout=2)
        self.sink.close()

    def snapshot_stats(self) -> dict:
        with self._lock:
            pending = sum(len(v) for v in self._pending.values())
            out = {
                **self.counters,
                "spans_dropped": (
                    self.counters["spans_dropped_sampled"]
                    + self.counters["spans_dropped_overflow"]
                    + self.counters["spans_dropped_export_error"]),
                "pending_spans": pending,
                "pending_traces": len(self._pending),
                "queued_spans": len(self._queue) + self._exporting,
                "max_queue": self.max_queue,
                "max_pending_traces": MAX_PENDING_TRACES,
                "slow_threshold_ms": self.slow_threshold_ms,
                "sample_ratio": self.sample_ratio,
                "mode": self.mode,
            }
        out["sink"] = self.sink.stats()
        return out


# -- settings application (the addSettingsUpdateConsumer adapter) -----------


def apply_tracing_settings(telemetry, flat: dict, data_path,
                           service_name: str | None = None) -> None:
    """Build/retire/retune the tracer's exporter from a flat effective
    cluster-settings map — the same adapter shape the kNN batcher uses, so
    `PUT /_cluster/settings` reconfigures span export live on every node.

    Modes: "none" detaches (and closes) the exporter; "file" appends
    OTLP-JSON lines under ``<data_path>/otel/``; an http(s) URL POSTs to
    that OTLP endpoint. A mode change swaps the exporter atomically; a
    sampler-only change retunes the live one in place.
    """
    from pathlib import Path

    from opensearch_tpu_torch.common.settings import Settings

    s = Settings.from_flat({
        st.key: flat[st.key] for st in TRACING_SETTINGS if st.key in flat
    })
    mode = EXPORTER_SETTING.get(s)
    slow = SLOW_THRESHOLD_SETTING.get(s)
    ratio = SAMPLE_RATIO_SETTING.get(s)
    tracer = telemetry.tracer
    current: SpanExporter | None = tracer.exporter
    name = service_name or tracer.name
    if mode == "none":
        if current is not None:
            tracer.exporter = None
            current.close()
        return
    if current is not None and current.mode == mode:
        current.configure(slow_threshold_ms=slow, sample_ratio=ratio)
        return
    if mode == "file":
        sink = FileSink(Path(data_path) / "otel" / f"spans-{name}.jsonl")
    else:
        sink = HttpSink(mode)
    exporter = SpanExporter(
        sink, service_name=name, slow_threshold_ms=slow,
        sample_ratio=ratio, mode=mode,
    )
    tracer.exporter = exporter
    if current is not None:
        current.close()


def close_exporter(telemetry) -> None:
    """Node-shutdown hook: flush + detach the exporter if one is live."""
    exporter = getattr(telemetry.tracer, "exporter", None)
    if exporter is not None:
        telemetry.tracer.exporter = None
        exporter.close()
