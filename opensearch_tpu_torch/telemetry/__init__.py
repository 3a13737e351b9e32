"""Telemetry of the PyTorch port: tracing spans, metrics, the slow logs,
the device-residency ledger and the kernel roofline.

Counterpart of opensearch_tpu/telemetry/. Span export
(telemetry/export.py: the tail-keeping sampler and the OTLP-JSON file
sink) is ported; the Prometheus exposition is not yet.
"""

from opensearch_tpu_torch.telemetry.tracing import (
    MetricsRegistry,
    Span,
    Telemetry,
    Tracer,
    activate,
    active_metrics,
    add_span_event,
    current_trace_context,
    default_telemetry,
    restore_trace_context,
    span,
)

__all__ = [
    "MetricsRegistry", "Span", "Telemetry", "Tracer", "activate",
    "active_metrics", "add_span_event", "current_trace_context",
    "default_telemetry", "restore_trace_context", "span",
]
