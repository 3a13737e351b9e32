"""Transport contracts shared by the real TCP transport and the sim.

The interface both implement (established by testing/sim.MockTransport so
Coordinator/ClusterNode run unchanged over either):

    register(node_id, action, handler)   handler(sender, payload) -> result
    send(sender, target, action, payload, on_response=None, on_failure=None)

plus the scheduler contract (schedule(delay_ms, fn) -> cancellable with
.cancel(), and .random: random.Random) established by
testing/sim.DeterministicTaskQueue.

`DeferredResponse` extends the handler contract for operations that cannot
answer synchronously — the primary of a replicated write must wait for
replica acks before acknowledging (the reference's ReplicationOperation:
respond only when all in-sync copies answered, TransportReplicationAction
.java:111). A handler returns a DeferredResponse instead of a dict; the
transport ships the response frame when set_result fires.
"""

from __future__ import annotations

from typing import Any, Callable

# transport message header key carrying the trace context (trace_id +
# span_id). Both transports inject it at send() and restore it around the
# receiving handler — the ThreadContext header relay of the reference,
# reduced to the one header distributed tracing needs.
TRACE_HEADER = "_trace"


def trace_header() -> dict | None:
    """The sender-side trace context to attach to an outgoing message
    (None when the send happens outside any span)."""
    from opensearch_tpu_torch.telemetry.tracing import current_trace_context

    return current_trace_context()


def handler_trace_scope(trace_ctx: dict | None):
    """Receiver-side scope restoring a propagated trace context around the
    handler invocation; no-op for untraced messages."""
    from opensearch_tpu_torch.telemetry.tracing import restore_trace_context

    return restore_trace_context(trace_ctx)


class DeferredResponse:
    """A response the handler will produce later (on the same event loop /
    task queue — no cross-thread use)."""

    def __init__(self) -> None:
        self._done = False
        self._result: Any = None
        self._error: Exception | None = None
        self._listeners: list[Callable[["DeferredResponse"], None]] = []

    def set_result(self, result: Any) -> None:
        if self._done:
            return
        self._done = True
        self._result = result
        for listener in self._listeners:
            listener(self)

    def set_exception(self, error: Exception) -> None:
        if self._done:
            return
        self._done = True
        self._error = error
        for listener in self._listeners:
            listener(self)

    # -- transport side ----------------------------------------------------

    def on_done(self, listener: Callable[["DeferredResponse"], None]) -> None:
        """Register a completion listener (multiple allowed: the transport
        ships the response AND the handler may chain follow-up work)."""
        self._listeners.append(listener)
        if self._done:
            listener(self)

    @property
    def error(self) -> Exception | None:
        return self._error

    @property
    def result(self) -> Any:
        return self._result
