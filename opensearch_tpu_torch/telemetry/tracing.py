"""Telemetry: tracing spans + metrics registry.

Counterpart of opensearch_tpu/telemetry/tracing.py, a host-only copy (the
analog of the reference's libs/telemetry Telemetry / Tracer /
MetricsRegistry SPI):

- Tracer.start_span is a context manager; the current span propagates via
  contextvars, so child spans parent automatically across the executor
  boundaries the HTTP server uses.
- Spans collect into a bounded in-memory ring; tests and stats surfaces
  read the ring, and an attached exporter (telemetry/export.py, set by
  the ``telemetry.tracing.*`` cluster settings) is offered every finished
  span.
- MetricsRegistry: counters + histograms with label support and
  exemplars.
- `current_trace_context()` serializes the active (trace_id, span_id) pair
  and `restore_trace_context()` re-installs it, so work handed across
  threads or processes stitches into one trace tree. Span ids come from a
  per-tracer counter prefixed with the tracer name: deterministic, yet
  unique across the tracers of one process.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field as dc_field
from typing import Any

_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "opensearch_tpu_torch_current_span", default=None
)
_active_tracer: contextvars.ContextVar["Tracer | None"] = contextvars.ContextVar(
    "opensearch_tpu_torch_active_tracer", default=None
)


# per-span event cap (OTel's default span event limit ballpark): a span
# that witnesses hundreds of evictions/retries keeps the first window and
# counts the rest, so one hot span can never balloon the ring or export
MAX_SPAN_EVENTS = 32


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: str | None
    name: str
    attributes: dict[str, Any] = dc_field(default_factory=dict)
    start_ns: int = 0
    end_ns: int = 0
    # span EVENTS (per-span logs): point-in-time records riding the span —
    # batcher flush reasons, mesh/ledger evictions, recovery chunk retries.
    # Bounded by MAX_SPAN_EVENTS; overflow counts into dropped_events.
    events: list[dict] = dc_field(default_factory=list)
    dropped_events: int = 0

    @property
    def duration_ns(self) -> int:
        return max(self.end_ns - self.start_ns, 0)

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, attributes: dict | None = None) -> None:
        if len(self.events) >= MAX_SPAN_EVENTS:
            self.dropped_events += 1
            return
        self.events.append({
            "name": name,
            "ts_ns": time.perf_counter_ns(),
            "attributes": dict(attributes or {}),
        })

    def to_dict(self) -> dict:
        out = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "attributes": dict(self.attributes),
            "duration_ns": self.duration_ns,
        }
        if self.events:
            out["events"] = [dict(e) for e in self.events]
        if self.dropped_events:
            out["dropped_events"] = self.dropped_events
        return out


class _SpanScope:
    __slots__ = ("_tracer", "_name", "_attributes", "span", "_token")

    def __init__(self, tracer: "Tracer", name: str, attributes: dict | None):
        self._tracer = tracer
        self._name = name
        self._attributes = attributes

    def __enter__(self) -> Span:
        self.span = self._tracer.begin_span(self._name, self._attributes)
        self._token = _current_span.set(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.span.attributes["error"] = str(exc)
        _current_span.reset(self._token)
        self._tracer.end_span(self.span)
        return False


class _RemoteContextScope:
    """Installs a synthetic parent span restored from transport headers so
    spans opened on the receiving node stitch into the sender's trace."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: dict | None):
        self._ctx = ctx if (
            isinstance(ctx, dict) and ctx.get("trace_id") and ctx.get("span_id")
        ) else None

    def __enter__(self):
        if self._ctx is None:
            self._token = None
            return None
        remote = Span(
            trace_id=str(self._ctx["trace_id"]),
            span_id=str(self._ctx["span_id"]),
            parent_id=None,
            name="<remote>",
        )
        self._token = _current_span.set(remote)
        return remote

    def __exit__(self, exc_type, exc, tb):
        if self._token is not None:
            _current_span.reset(self._token)
        return False


def current_trace_context() -> dict | None:
    """The active (trace_id, span_id) pair as a wire-ready header dict, or
    None when no span is open (messages outside any trace stay bare)."""
    span = _current_span.get()
    if span is None:
        return None
    return {"trace_id": span.trace_id, "span_id": span.span_id}


def restore_trace_context(ctx: dict | None) -> _RemoteContextScope:
    """Context manager re-installing a propagated trace context (receiving
    node side, or re-entering a stored context across scheduler callbacks).
    A None/malformed ctx yields a no-op scope."""
    return _RemoteContextScope(ctx)


class _ActivateScope:
    __slots__ = ("_tracer", "_token")

    def __init__(self, tracer: "Tracer"):
        self._tracer = tracer

    def __enter__(self) -> "Tracer":
        self._token = _active_tracer.set(self._tracer)
        return self._tracer

    def __exit__(self, exc_type, exc, tb):
        _active_tracer.reset(self._token)
        return False


def activate(tracer: "Tracer") -> _ActivateScope:
    """Scope the 'active tracer' (the node handling the current request) so
    library code (search phases, recovery) can open spans into the right
    node's ring without threading a tracer through every signature."""
    return _ActivateScope(tracer)


def active_tracer() -> "Tracer":
    return _active_tracer.get() or default_telemetry.tracer


def active_metrics() -> "MetricsRegistry | None":
    """MetricsRegistry of the node handling the current request, or None
    outside an activate() scope. Process-wide singletons (the kNN dispatch
    batcher, the shard-mesh registry) record through this so that in
    multi-node in-process sims a launch lands in the EXECUTING node's
    histograms — and its exemplar trace_id resolves in the same node's
    span ring — instead of whichever node attached its sink last."""
    tracer = _active_tracer.get()
    owner = getattr(tracer, "owner", None) if tracer is not None else None
    return owner.metrics if owner is not None else None


def span(name: str, attributes: dict | None = None):
    """Open a span on the active tracer (see `activate`)."""
    return active_tracer().start_span(name, attributes)


def add_span_event(name: str, attributes: dict | None = None) -> None:
    """Attach a span EVENT to the current span, if one is open (library
    code — the batcher, the mesh registry — records what happened inside
    whoever's request is executing; a no-op outside any span). Remote
    placeholder spans restored from transport headers are skipped: their
    events would never reach a ring or the exporter."""
    current = _current_span.get()
    if current is None or current.name == "<remote>":
        return
    current.add_event(name, attributes)


class Tracer:
    """Span factory with contextvar propagation and a bounded ring of
    finished spans (the exporter slot). `name` prefixes span ids so traces
    stitched across several tracers (sim cluster nodes) stay unambiguous.

    When an exporter (telemetry/export.py SpanExporter) is attached, every
    finished span is also offered to it; the exporter's tail-keeping
    sampler decides which traces leave the process as OTLP-JSON."""

    def __init__(self, max_finished: int = 2048, enabled: bool = True,
                 name: str = "t0"):
        self.enabled = enabled
        self.name = name
        self.max_finished = max_finished
        self.exporter = None  # SpanExporter | None (export.py)
        self.owner = None  # Telemetry backref (set by Telemetry.__init__)
        self._ids = itertools.count(1)
        self._finished: deque[Span] = deque(maxlen=max_finished)
        self._lock = threading.Lock()

    def start_span(self, name: str, attributes: dict | None = None):
        return _SpanScope(self, name, attributes)

    def begin_span(self, name: str, attributes: dict | None = None) -> Span:
        """Start a span WITHOUT installing it as the current context — for
        operations that live across scheduler callbacks (a recovery). Pair
        with end_span; propagate via restore_trace_context({"trace_id":
        span.trace_id, "span_id": span.span_id})."""
        parent = _current_span.get()
        sid = f"{self.name}-s{next(self._ids):06x}"
        return Span(
            trace_id=parent.trace_id if parent else f"trace-{sid}",
            span_id=sid,
            parent_id=parent.span_id if parent else None,
            name=name,
            attributes=dict(attributes or {}),
            start_ns=time.perf_counter_ns(),
        )

    def end_span(self, span: Span) -> None:
        span.end_ns = time.perf_counter_ns()
        if self.enabled:
            with self._lock:
                self._finished.append(span)
            exporter = self.exporter
            if exporter is not None:
                # outside self._lock: the exporter takes its own lock and
                # may call back into sinks
                exporter.on_span_end(span, self.name)

    def current_span(self) -> Span | None:
        return _current_span.get()

    def finished_spans(self) -> list[Span]:
        with self._lock:
            return list(self._finished)

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()


class _Counter:
    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def add(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


# default histogram bucket upper bounds: a 1-2-5 decade ladder wide enough
# for both millisecond latencies and batch sizes; the terminal +Inf bucket
# is implicit (Prometheus classic-histogram convention)
DEFAULT_BUCKETS = (
    1, 2, 5, 10, 25, 50, 100, 250, 500, 1_000, 2_500, 5_000, 10_000,
    30_000, 60_000,
)


# an exemplar covers this many observations before it is considered stale
# and any fresh observation (not only a larger one) may replace it: a p99
# spike from an hour ago must not shadow today's outliers forever
EXEMPLAR_WINDOW = 1024


class _Histogram:
    def __init__(self, buckets: tuple = DEFAULT_BUCKETS):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.buckets = tuple(sorted(buckets))
        # cumulative counts per upper bound (le semantics); +Inf == count
        self.bucket_counts = [0] * len(self.buckets)
        # bucket index (len(buckets) == +Inf) -> the max-latency observation
        # of the current window with the trace that produced it, so a p99
        # bucket links straight to an exportable trace (OpenMetrics
        # exemplars; OTel's exemplar reservoir with a keep-max policy)
        self.exemplars: dict[int, dict] = {}
        self._lock = threading.Lock()

    def record(self, value: float, trace_id: str | None = None) -> None:
        if trace_id is None:
            span = _current_span.get()
            trace_id = span.trace_id if span is not None else None
        with self._lock:
            self.count += 1
            self.total += value
            self.min = min(self.min, value)
            self.max = max(self.max, value)
            bucket_idx = len(self.buckets)  # +Inf unless a bound catches it
            for i, le in enumerate(self.buckets):
                if value <= le:
                    self.bucket_counts[i] += 1
                    bucket_idx = min(bucket_idx, i)
            if trace_id is not None:
                window = self.count // EXEMPLAR_WINDOW
                cur = self.exemplars.get(bucket_idx)
                if cur is None or cur["window"] != window \
                        or value >= cur["value"]:
                    self.exemplars[bucket_idx] = {
                        "value": value, "trace_id": trace_id,
                        "window": window,
                    }

    def _exemplars_locked(self) -> list[dict]:
        out = []
        for i in sorted(self.exemplars):
            e = self.exemplars[i]
            out.append({
                "le": self.buckets[i] if i < len(self.buckets) else "+Inf",
                "value": e["value"], "trace_id": e["trace_id"],
            })
        return out

    def stats(self) -> dict:
        with self._lock:  # consistent snapshot: record() holds this too
            if self.count == 0:
                return {"count": 0, "sum": 0.0, "avg": 0.0,
                        "min": 0.0, "max": 0.0,
                        "buckets": [
                            {"le": le, "count": 0} for le in self.buckets
                        ]}
            out = {
                "count": self.count, "sum": self.total,
                "avg": self.total / self.count,
                "min": self.min, "max": self.max,
                "buckets": [
                    {"le": le, "count": c}
                    for le, c in zip(self.buckets, self.bucket_counts)
                ],
            }
            exemplars = self._exemplars_locked()
            if exemplars:
                out["exemplars"] = exemplars
            return out


# labeled-series cardinality bound per histogram family: beyond this many
# distinct label sets, new ones record into the base (unlabeled) series and
# a dropped counter ticks — an unbounded label value (doc ids, trace ids)
# must never mint unbounded Prometheus series (the TPU013 concern, enforced
# at runtime for the label dimension)
MAX_LABEL_SETS = 64
# reserved label set collecting observations past the cap: one visible
# overflow bucket instead of a 65th+ series
OVERFLOW_LABEL_KEY = (("_overflow", "true"),)


class MetricsRegistry:
    def __init__(self):
        self._counters: dict[str, _Counter] = {}
        self._histograms: dict[str, _Histogram] = {}
        # family name -> sorted-label-tuple -> series (histogram LABEL
        # support: per-index `search.took_ms{index=...}` under a constant
        # metric name — vary labels, never names)
        self._labeled: dict[str, dict[tuple, _Histogram]] = {}
        self._labels_dropped: dict[str, int] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> _Counter:
        with self._lock:
            return self._counters.setdefault(name, _Counter())

    def histogram(self, name: str, labels: dict | None = None) -> _Histogram:
        with self._lock:
            if labels:
                family = self._labeled.setdefault(name, {})
                key = tuple(sorted(
                    (str(k), str(v)) for k, v in labels.items()))
                series = family.get(key)
                if series is None:
                    if len(family) >= MAX_LABEL_SETS:
                        # cardinality bound: overflow collects in ONE
                        # reserved series (not the base — record sites feed
                        # base AND labeled, so routing overflow to base
                        # would double-count it there), visibly counted
                        self._labels_dropped[name] = (
                            self._labels_dropped.get(name, 0) + 1)
                        overflow = family.get(OVERFLOW_LABEL_KEY)
                        if overflow is None:
                            overflow = family[OVERFLOW_LABEL_KEY] = \
                                _Histogram()
                        return overflow
                    series = family[key] = _Histogram()
                return series
            return self._histograms.setdefault(name, _Histogram())

    def stats(self) -> dict:
        with self._lock:
            histograms: dict[str, dict] = {
                n: h.stats() for n, h in self._histograms.items()
            }
            for name, family in self._labeled.items():
                entry = histograms.setdefault(name, _Histogram().stats())
                entry["series"] = [
                    {"labels": dict(key), **series.stats()}
                    for key, series in family.items()
                ]
                dropped = self._labels_dropped.get(name)
                if dropped:
                    entry["label_sets_dropped"] = dropped
            return {
                "counters": {n: c.value for n, c in self._counters.items()},
                "histograms": histograms,
            }


class Telemetry:
    def __init__(self, name: str = "t0"):
        self.tracer = Tracer(name=name)
        self.metrics = MetricsRegistry()
        # backref so active_metrics() can resolve the executing node's
        # registry from the activate() scope its request handlers open
        self.tracer.owner = self


default_telemetry = Telemetry()
