"""Telemetry of the PyTorch port: tracing spans, metrics, the slow logs,
the device-residency ledger and the kernel roofline.

Counterpart of opensearch_tpu/telemetry/. The span exporters
(telemetry/export.py: OTLP, Prometheus) are not ported yet.
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
