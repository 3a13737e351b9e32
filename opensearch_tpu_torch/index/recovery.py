"""Peer recovery: chunked shard streaming between nodes.

The analog of the reference's recovery subsystem
(server/src/main/java/org/opensearch/indices/recovery/ —
RecoverySourceHandler.java:112 `recoverToTarget`:171, RecoveryTarget,
MultiChunkTransfer, RecoveriesCollection):

- the SOURCE (primary) side keeps one session per recovering target
  (`RecoverySourceSessions`): a point-in-time snapshot of what must ship
  (packed segment blobs or a logical op dump) that chunk requests read
  from, so a retried chunk re-reads identical bytes even while the
  primary keeps indexing;
- the TARGET side drives the transfer (`RecoveryTargetDriver`): segments
  stream in bounded byte-range CHUNKS and op dumps in bounded BATCHES,
  each chunk with its own timeout and exponential-backoff retry
  (RecoverySettings' chunk size + retryDelayStateSync), so one lost frame
  costs one chunk, not the whole recovery;
- the handoff is SEQNO-BASED: the source tracks the target from session
  open (concurrent writes fan out to it), and `finalize` returns the
  primary's max_seq_no so the target only reports shard-started once its
  own local checkpoint covers the handoff point — acked writes landing
  mid-recovery are provably on the new copy before the routing swap.

Transport-agnostic: everything is callback-style over the duck-typed
transport (MockTransport in the sim, TcpTransport in production, where
chunk payloads ride the `_KIND_BINARY` out-of-band frame path).

`RecoveryProgress` is the RecoveryState analog backing
GET [/{index}]/_recovery and GET /_cat/recovery.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Any, Callable

from opensearch_tpu_torch.common.timeutil import epoch_millis

logger = logging.getLogger(__name__)

# chunk/batch bounds (RecoverySettings.INDICES_RECOVERY_CHUNK_SIZE analog;
# far under the transport's MAX_FRAME so a chunk can never poison a stream)
DEFAULT_CHUNK_BYTES = 512 * 1024
DEFAULT_OPS_BATCH = 500

# per-chunk retry policy (retryDelayNetwork with exponential backoff)
MAX_CHUNK_RETRIES = 5
BACKOFF_BASE_MS = 200
BACKOFF_CAP_MS = 5_000


def backoff_delay_ms(attempt: int, base_ms: int = BACKOFF_BASE_MS,
                     cap_ms: int = BACKOFF_CAP_MS) -> int:
    """Exponential backoff for the Nth retry (attempt starts at 1)."""
    return min(cap_ms, base_ms * (2 ** max(attempt - 1, 0)))


def _now_ms() -> int:
    # routed through the injectable clock so the deterministic sim
    # controls recovery timestamps (tpulint TPU004)
    return epoch_millis()


@dataclass
class RecoveryProgress:
    """One recovery's observable state (RecoveryState analog)."""

    index: str
    shard: int
    target_node: str
    source_node: str | None = None
    # PEER (replica recovery / relocation transfer), LOCAL (store bootstrap)
    recovery_type: str = "PEER"
    # INIT -> INDEX (file/dump copy) -> TRANSLOG (op replay) ->
    # FINALIZE (seqno handoff) -> DONE | FAILED
    stage: str = "INIT"
    files_total: int = 0
    files_recovered: int = 0
    bytes_total: int = 0
    bytes_recovered: int = 0
    ops_total: int = 0
    ops_recovered: int = 0
    retries: int = 0
    start_ms: int = field(default_factory=_now_ms)
    stop_ms: int | None = None

    def done(self) -> None:
        self.stage = "DONE"
        self.stop_ms = _now_ms()

    def failed(self) -> None:
        self.stage = "FAILED"
        self.stop_ms = _now_ms()

    @property
    def total_time_ms(self) -> int:
        return (self.stop_ms or _now_ms()) - self.start_ms

    def to_dict(self) -> dict:
        return {
            "index": self.index, "shard": self.shard,
            "target_node": self.target_node, "source_node": self.source_node,
            "type": self.recovery_type, "stage": self.stage,
            "files_total": self.files_total,
            "files_recovered": self.files_recovered,
            "bytes_total": self.bytes_total,
            "bytes_recovered": self.bytes_recovered,
            "ops_total": self.ops_total, "ops_recovered": self.ops_recovered,
            "retries": self.retries,
            "start_ms": self.start_ms, "stop_ms": self.stop_ms,
            "total_time_ms": self.total_time_ms,
        }

class RecoverySourceSessions:
    """Source-side session registry (RecoveriesCollection for the source).

    One session per (index, shard, target): an immutable snapshot of the
    bytes/ops this recovery ships. Chunk requests are pure reads of the
    snapshot — a retried chunk returns byte-identical data no matter what
    the live engine did in between (the reference holds the Lucene commit
    via a retention lock; here the packed blobs themselves are retained).

    Thread contract: the registry is touched from TWO domains —
    recovery starts and file-chunk packing run on the data worker
    (``_offload`` in cluster_node), while ops batches, finalize, and
    cluster-state target drops run inline on the transport loop — so
    every registry operation holds ``_lock`` (the whole-program TPU018/
    TPU019 pass surfaced the torn ``reap`` walk vs a concurrent
    ``close``, and the evict scan in ``open`` racing the same pop).
    """

    # sessions idle longer than this are reaped (a target that died without
    # finalizing must not pin segment blobs forever)
    SESSION_TTL_MS = 10 * 60 * 1000
    # hard count bound on concurrently open sessions: each pins packed
    # segment blobs / op dumps in memory, so a storm of recovery starts
    # (chaos restarts, flapping targets) must evict the stalest instead of
    # accreting snapshots until OOM (TPU009's bound-or-evict contract).
    # An evicted target's next chunk request fails -> its driver retries
    # the recovery from scratch, which reopens a fresh session.
    MAX_SESSIONS = 64

    def __init__(self):
        self._sessions: dict[tuple[str, int, str], dict] = {}
        self._lock = threading.Lock()

    def open(self, index: str, shard: int, target: str, *,
             mode: str, blobs: dict[str, bytes] | None = None,
             ops: list[dict] | None = None, max_seq_no: int = -1) -> dict:
        session = {
            "mode": mode,
            "blobs": blobs or {},
            "ops": ops or [],
            "max_seq_no": max_seq_no,
            "touched_ms": _now_ms(),
        }
        key = (index, shard, target)
        with self._lock:
            # evict-then-insert under ONE hold: the stalest scan and its
            # del must not interleave with a transport-loop close()
            while len(self._sessions) >= self.MAX_SESSIONS and \
                    key not in self._sessions:
                stalest = min(self._sessions,
                              key=lambda k: self._sessions[k]["touched_ms"])
                del self._sessions[stalest]
            self._sessions[key] = session
        return session

    def get(self, index: str, shard: int, target: str) -> dict | None:
        with self._lock:
            s = self._sessions.get((index, shard, target))
        if s is not None:
            s["touched_ms"] = _now_ms()
        return s

    def close(self, index: str, shard: int, target: str) -> None:
        with self._lock:
            self._sessions.pop((index, shard, target), None)

    def drop_target(self, index: str, shard: int, target: str) -> None:
        self.close(index, shard, target)

    def reap(self, now_ms: int | None = None) -> list[tuple]:
        now = now_ms if now_ms is not None else _now_ms()
        with self._lock:
            dead = [k for k, s in self._sessions.items()
                    if now - s["touched_ms"] > self.SESSION_TTL_MS]
            for k in dead:
                del self._sessions[k]
        return dead

    # -- chunk reads --------------------------------------------------------

    def file_chunk(self, index: str, shard: int, target: str,
                   name: str, offset: int,
                   length: int = DEFAULT_CHUNK_BYTES) -> dict:
        """One byte-range of one packed segment blob."""
        session = self.get(index, shard, target)
        if session is None:
            raise KeyError(
                f"no recovery session for [{index}][{shard}] -> {target}"
            )
        blob = session["blobs"].get(name)
        if blob is None:
            raise KeyError(f"segment [{name}] not in recovery session")
        chunk = blob[offset: offset + max(int(length), 1)]
        return {
            "name": name, "offset": offset, "total": len(blob),
            "last": offset + len(chunk) >= len(blob),
            "_binary": bytes(chunk),
        }

    def ops_batch(self, index: str, shard: int, target: str,
                  start: int, size: int = DEFAULT_OPS_BATCH) -> dict:
        session = self.get(index, shard, target)
        if session is None:
            raise KeyError(
                f"no recovery session for [{index}][{shard}] -> {target}"
            )
        ops = session["ops"]
        batch = ops[start: start + max(int(size), 1)]
        return {
            "ops": batch, "start": start, "total": len(ops),
            "last": start + len(batch) >= len(ops),
            "max_seq_no": session["max_seq_no"],
        }


class RecoveryTargetDriver:
    """Target-side pull loop: sequential chunk/batch requests, each with a
    per-request timeout and exponential-backoff retry. Callback style so it
    runs unchanged under the deterministic sim and the asyncio transport.
    """

    def __init__(self, transport, scheduler, node_id: str, source_id: str,
                 index: str, shard: int, progress: RecoveryProgress,
                 *, chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 ops_batch: int = DEFAULT_OPS_BATCH,
                 max_retries: int = MAX_CHUNK_RETRIES,
                 chunk_timeout_ms: int = 30_000,
                 trace: dict | None = None,
                 root_span=None):
        self.transport = transport
        self.scheduler = scheduler
        self.node_id = node_id
        self.source_id = source_id
        self.index = index
        self.shard = shard
        self.progress = progress
        self.chunk_bytes = chunk_bytes
        self.ops_batch = ops_batch
        self.max_retries = max_retries
        self.chunk_timeout_ms = chunk_timeout_ms
        self.cancelled = False
        # the recovery's trace context ({"trace_id", "span_id"} of the
        # target-side root span): every chunk/finalize request — retries
        # included — re-enters it, so one recovery is ONE trace tree even
        # across scheduler callbacks where contextvars don't survive
        self.trace = trace
        # the root Span OBJECT (when the owner holds one): chunk retries
        # land on it as span EVENTS, so the exported recovery trace shows
        # every backoff without a span per retry
        self.root_span = root_span

    def cancel(self) -> None:
        self.cancelled = True

    # -- retry plumbing -----------------------------------------------------

    def _request_with_retry(self, action: str, payload: dict,
                            on_ok: Callable[[Any], None],
                            on_give_up: Callable[[Exception], None],
                            attempt: int = 0) -> None:
        if self.cancelled:
            on_give_up(RuntimeError("recovery cancelled"))
            return

        def fail(e: Exception) -> None:
            if self.cancelled:
                on_give_up(RuntimeError("recovery cancelled"))
                return
            if attempt + 1 >= self.max_retries:
                on_give_up(e)
                return
            self.progress.retries += 1
            if self.root_span is not None:
                # per-span log of the retry (bounded by the span's event
                # cap): the exported trace shows what backed off and why
                self.root_span.add_event("recovery.chunk_retry", {
                    "action": action, "attempt": attempt + 1,
                    "error": str(e),
                })
            self.scheduler.schedule(
                backoff_delay_ms(attempt + 1),
                lambda: self._request_with_retry(
                    action, payload, on_ok, on_give_up, attempt + 1
                ),
            )

        from opensearch_tpu_torch.telemetry.tracing import restore_trace_context

        with restore_trace_context(self.trace):
            self.transport.send(
                self.node_id, self.source_id, action, payload,
                on_response=on_ok, on_failure=fail,
                timeout_ms=self.chunk_timeout_ms,
            )

    # -- segment file streaming --------------------------------------------

    def fetch_files(self, names: list[str], sizes: dict[str, int],
                    on_done: Callable[[bool, dict[str, bytes]], None]) -> None:
        """Pull each named segment blob as a sequence of byte-range chunks.
        `on_done(ok, {name: blob})` fires on the scheduler's execution
        context once every file arrived (or a chunk exhausted its retries).
        """
        self.progress.stage = "INDEX"
        self.progress.files_total = len(names)
        self.progress.bytes_total = sum(sizes.get(n, 0) for n in names)
        blobs: dict[str, bytes] = {}
        parts: list[bytes] = []

        def next_file(fi: int) -> None:
            if fi >= len(names):
                on_done(True, blobs)
                return
            parts.clear()
            fetch_chunk(fi, 0)

        def fetch_chunk(fi: int, offset: int) -> None:
            name = names[fi]

            def ok(resp: Any) -> None:
                if not isinstance(resp, dict) or resp.get("_binary") is None:
                    give_up(RuntimeError(f"bad chunk response for [{name}]"))
                    return
                chunk = resp["_binary"]
                if offset == 0 and name not in sizes:
                    # the manifest couldn't know packed sizes up front (the
                    # source packs lazily); learn them from chunk 1
                    self.progress.bytes_total += int(resp.get("total", 0))
                parts.append(bytes(chunk))
                self.progress.bytes_recovered += len(chunk)
                if resp.get("last"):
                    blobs[name] = b"".join(parts)
                    self.progress.files_recovered += 1
                    next_file(fi + 1)
                else:
                    fetch_chunk(fi, offset + len(chunk))

            def give_up(e: Exception) -> None:
                on_done(False, blobs)

            self._request_with_retry(
                "internal:index/shard/recovery/file_chunk",
                {"index": self.index, "shard": self.shard,
                 "target": self.node_id, "name": name,
                 "offset": offset, "length": self.chunk_bytes},
                ok, give_up,
            )

        next_file(0)

    # -- op dump streaming --------------------------------------------------

    def fetch_ops(self, total: int,
                  apply_batch: Callable[[list[dict], Callable[[bool], None]], None],
                  on_done: Callable[[bool], None]) -> None:
        """Pull the source's op dump in batches (phase2's translog replay
        windowing). `apply_batch(batch, cont)` applies one batch — possibly
        on another executor — and calls `cont(ok)`; the next batch is only
        requested after the previous one applied (bounded memory, and the
        source sees backpressure for free)."""
        self.progress.stage = "TRANSLOG"
        self.progress.ops_total = total

        def fetch(start: int) -> None:
            if start >= total:
                on_done(True)
                return

            def ok(resp: Any) -> None:
                if not isinstance(resp, dict) or "ops" not in resp:
                    on_done(False)
                    return
                batch = resp["ops"]

                def applied(ok2: bool) -> None:
                    if not ok2:
                        on_done(False)
                        return
                    self.progress.ops_recovered += len(batch)
                    if resp.get("last") or not batch:
                        on_done(True)
                    else:
                        fetch(start + len(batch))

                try:
                    apply_batch(batch, applied)
                except Exception as e:  # noqa: BLE001 - a bad batch fails recovery
                    logger.warning(
                        "recovery [%s][%s]: applying ops batch failed: %s",
                        self.index, self.shard, e)
                    on_done(False)

            self._request_with_retry(
                "internal:index/shard/recovery/ops_chunk",
                {"index": self.index, "shard": self.shard,
                 "target": self.node_id, "from": start,
                 "size": self.ops_batch},
                ok, lambda e: on_done(False),
            )

        fetch(0)

    # -- seqno handoff ------------------------------------------------------

    def finalize(self, local_checkpoint_fn: Callable[[], int],
                 on_done: Callable[[bool], None],
                 _waits: int = 0) -> None:
        """Ask the source for its max_seq_no and wait (bounded) until this
        copy's local checkpoint covers it: every write acked before the
        routing swap is provably on this copy (the
        RecoverySourceHandler.finalizeRecovery handoff point)."""
        self.progress.stage = "FINALIZE"

        def ok(resp: Any) -> None:
            if not isinstance(resp, dict):
                on_done(False)
                return
            handoff = int(resp.get("max_seq_no", -1))

            def check(waits: int) -> None:
                if self.cancelled:
                    on_done(False)
                    return
                if local_checkpoint_fn() >= handoff:
                    on_done(True)
                    return
                if waits >= 50:  # ~10s of virtual/wall time at 200ms steps
                    # concurrent fan-out never caught up — recovery restarts
                    on_done(False)
                    return
                self.scheduler.schedule(200, lambda: check(waits + 1))

            check(0)

        self._request_with_retry(
            "internal:index/shard/recovery/finalize",
            {"index": self.index, "shard": self.shard,
             "target": self.node_id},
            ok, lambda e: on_done(False),
        )
