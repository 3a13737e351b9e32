"""TcpTransport: the real L2 layer — asyncio TCP RPC between node processes.

The production implementation of the interface established by
testing/sim.MockTransport, so Coordinator/ClusterNode run over real
sockets unchanged. Reimplements the semantics of the reference's netty
transport (transport/TcpTransport.java:119 framing, TransportService.java:
sendRequest:923 request/response correlation + timeouts, handler registry
:336, TransportHandshaker; modules/transport-netty4/Netty4Transport.java:92)
as a from-scratch asyncio design:

- frames: [u32 big-endian length][JSON body]; body carries
  {"t": "req"|"res"|"err", "id": corr-id, "action": name,
   "sender": node-id, "payload": ...}
- one persistent outbound connection per target node, opened lazily and
  re-opened on failure (ClusterConnectionManager analog); a HANDSHAKE
  frame is exchanged on connect and validates cluster name + protocol
  version before any request flows
- request/response correlation by id with a per-request timeout timer;
  timed-out ids are tombstoned so a late response is dropped, not
  delivered to a recycled callback
- handlers run on the event loop, single-threaded — the same execution
  model the sim's task queue provides; a handler may return a
  DeferredResponse to answer later (replicated-write acks)

Everything is callback-style (on_response/on_failure), matching the
coordinator's continuation-passing design; `LoopScheduler` is the
wall-clock twin of the sim's DeterministicTaskQueue.
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import struct
from typing import Any, Callable

from opensearch_tpu_torch.transport.base import (
    TRACE_HEADER,
    DeferredResponse,
    handler_trace_scope,
    trace_header,
)

logger = logging.getLogger(__name__)

PROTOCOL_VERSION = 2
_LEN = struct.Struct(">I")
MAX_FRAME = 256 * 1024 * 1024  # hard cap, like the reference's 2GB guard

# pending-reply backlog bound (TPU009: every long-lived transport buffer
# needs a bound + shed). Each entry holds two callbacks and a timer; a
# peer that stops answering must shed new requests fast instead of
# accreting correlation state until the process dies.
DEFAULT_MAX_PENDING = 10_000


class TransportBacklogFull(Exception):
    """Shed signal: the pending-reply table is at capacity."""

# frame kinds (first byte after the length prefix)
_KIND_JSON = 0x00    # [len][0x00][json]
_KIND_BINARY = 0x01  # [len][0x01][u32 json_len][json][raw bytes]
# a JSON payload/result dict may carry raw bytes under this key; the codec
# ships them out-of-band (no base64) — the data-plane path segment
# replication needs (VERDICT r2 weak #9 / missing #2)
BINARY_KEY = "_binary"


class RemoteTransportException(Exception):
    """An error raised by the remote handler, carried back over the wire."""


class LoopScheduler:
    """scheduler contract (schedule + .random) on an asyncio loop."""

    class _Handle:
        def __init__(self, timer: asyncio.TimerHandle):
            self._timer = timer

        def cancel(self) -> None:
            self._timer.cancel()

        @property
        def cancelled(self) -> bool:
            return self._timer.cancelled()

    def __init__(self, loop: asyncio.AbstractEventLoop, seed: int | None = None):
        self.loop = loop
        self.random = random.Random(seed)

    def schedule(self, delay_ms: int, fn: Callable[[], None]) -> "LoopScheduler._Handle":
        return self._Handle(self.loop.call_later(max(delay_ms, 0) / 1000.0, fn))


class _Connection:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.peer_id: str | None = None
        self.closed = False

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            try:
                self.writer.close()
            except Exception as e:  # noqa: BLE001 - best-effort close
                logger.debug("connection close failed: %s", e)


def _extract_binary(body: dict) -> tuple[dict, bytes | None]:
    """Pull raw bytes out of payload/result dicts (one level deep)."""
    blob = None
    out = body
    for key in ("payload", "result"):
        inner = body.get(key)
        if isinstance(inner, dict) and isinstance(inner.get(BINARY_KEY), (bytes, bytearray)):
            inner = dict(inner)
            blob = bytes(inner.pop(BINARY_KEY))
            out = dict(body)
            out[key] = inner
            out["_bin_at"] = key
            return out, blob
    if isinstance(body.get(BINARY_KEY), (bytes, bytearray)):
        out = dict(body)
        blob = bytes(out.pop(BINARY_KEY))
        out["_bin_at"] = "."
    return out, blob


def encode_frame(body: dict) -> bytes:
    body, blob = _extract_binary(body)
    payload = json.dumps(body, separators=(",", ":")).encode()
    if blob is None:
        if len(payload) + 1 > MAX_FRAME:
            raise ValueError(
                f"frame of {len(payload)} bytes exceeds MAX_FRAME — "
                "chunk the payload"
            )
        return _LEN.pack(len(payload) + 1) + bytes([_KIND_JSON]) + payload
    total = 1 + 4 + len(payload) + len(blob)
    if total > MAX_FRAME:
        # fail on the SENDER with a clear error instead of poisoning the
        # receiver's stream (callers chunk large transfers per segment)
        raise ValueError(
            f"binary frame of {total} bytes exceeds MAX_FRAME — "
            "chunk the payload"
        )
    return (
        _LEN.pack(total)
        + bytes([_KIND_BINARY])
        + _LEN.pack(len(payload))
        + payload
        + blob
    )


async def read_frame(reader: asyncio.StreamReader) -> dict | None:
    try:
        header = await reader.readexactly(_LEN.size)
    except (asyncio.IncompleteReadError, ConnectionError, OSError):
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME:
        raise ValueError(f"frame of {length} bytes exceeds MAX_FRAME")
    try:
        raw = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionError, OSError):
        return None
    kind, raw = raw[0], raw[1:]
    if kind == _KIND_JSON:
        return json.loads(raw)
    (jlen,) = _LEN.unpack(raw[:4])
    body = json.loads(raw[4: 4 + jlen])
    blob = raw[4 + jlen:]
    at = body.pop("_bin_at", ".")
    if at == ".":
        body[BINARY_KEY] = blob
    else:
        body[at][BINARY_KEY] = blob
    return body


class TcpTransport:
    """One per node process. `seeds` maps node_id -> (host, port) — the
    file-based seed-hosts provider analog (DiscoveryModule.java:85)."""

    def __init__(
        self,
        node_id: str,
        host: str,
        port: int,
        seeds: dict[str, tuple[str, int]],
        *,
        loop: asyncio.AbstractEventLoop | None = None,
        timeout_ms: int = 10_000,
        cluster_name: str = "opensearch-tpu",
        max_pending: int = DEFAULT_MAX_PENDING,
    ):
        self.node_id = node_id
        self.host = host
        self.port = port
        self.seeds = dict(seeds)
        self.timeout_ms = timeout_ms
        self.cluster_name = cluster_name
        self.max_pending = max_pending
        self.loop = loop or asyncio.get_event_loop()
        self.handlers: dict[str, Callable[[str, Any], Any]] = {}
        self._server: asyncio.base_events.Server | None = None
        self._outbound: dict[str, _Connection] = {}
        self._connecting: dict[str, asyncio.Future] = {}
        self._inbound: set[_Connection] = set()
        self._pending: dict[int, tuple[Callable | None, Callable | None, Any]] = {}
        self._req_id = 0
        self.stats = {"sent": 0, "dropped": 0, "delivered": 0, "rx": 0,
                      "late_dropped": 0, "shed": 0}
        self._closed = False

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._accept, self.host, self.port
        )

    async def aclose(self) -> None:
        self._closed = True
        # close live connections BEFORE awaiting the listener: inbound
        # handler tasks only exit when their socket dies, and (Python 3.12)
        # Server.wait_closed blocks until every handler finished
        for conn in list(self._outbound.values()) + list(self._inbound):
            conn.close()
        self._outbound.clear()
        self._inbound.clear()
        if self._server is not None:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 5.0)
            except asyncio.TimeoutError:
                pass
        for rid in list(self._pending):
            self._fail_pending(rid, ConnectionError("transport closed"))

    # -- interface parity with MockTransport -------------------------------

    def register(self, node_id: str, action: str, handler: Callable) -> None:
        # signature kept identical to the sim's (node_id first) so wiring
        # code is transport-agnostic; a TcpTransport only serves one node
        assert node_id == self.node_id, f"{node_id} != {self.node_id}"
        self.handlers[action] = handler

    def send(
        self,
        sender: str,
        target: str,
        action: str,
        payload: Any,
        on_response: Callable[[Any], None] | None = None,
        on_failure: Callable[[Exception], None] | None = None,
        timeout_ms: int | None = None,
    ) -> None:
        if self._closed:
            # a closed transport must behave like a dead process: nothing
            # leaves the node (otherwise a shut-down leader keeps
            # heartbeating over fresh dials and drags followers back)
            if on_failure is not None:
                self.loop.call_soon(
                    on_failure, ConnectionError("transport closed")
                )
            return
        self.stats["sent"] += 1
        if target == self.node_id:
            # loopback: dispatch on the loop without a socket (the
            # reference's localNodeConnection)
            self.loop.call_soon(self._dispatch_local, sender, action, payload,
                               on_response, on_failure)
            return
        if len(self._pending) >= self.max_pending:
            # shed instead of accreting correlation state without bound
            # (the QueuePressure contract at the transport layer): the
            # caller gets an immediate failure it can retry/degrade on
            self.stats["shed"] += 1
            if on_failure is not None:
                self.loop.call_soon(on_failure, TransportBacklogFull(
                    f"{len(self._pending)} requests in flight "
                    f"(max_pending={self.max_pending})"
                ))
            return
        self._req_id += 1
        rid = self._req_id
        timer = self.loop.call_later(
            (timeout_ms or self.timeout_ms) / 1000.0,
            lambda: self._fail_pending(
                rid, TimeoutError(f"{action} to {target} timed out")
            ),
        )
        self._pending[rid] = (on_response, on_failure, timer)
        body = {
            "t": "req", "id": rid, "action": action,
            "sender": sender, "payload": payload,
        }
        trace = trace_header()
        if trace is not None:
            body[TRACE_HEADER] = trace
        try:
            frame = encode_frame(body)
        except Exception as e:  # noqa: BLE001 - any encode failure
            # oversized payload (ValueError) or unserializable payload
            # (TypeError from json.dumps): fail THIS request's listener
            # now — a raise escaping send() would leave the pending entry
            # (and the caller's callbacks) dangling until the timeout
            # timer, then fail the request a second time through it
            # (the callback-leak class TPU008 hunts)
            self._fail_pending(rid, e)
            return
        self.loop.create_task(self._send_frame(target, rid, frame))

    # -- outbound ----------------------------------------------------------

    async def _send_frame(self, target: str, rid: int, frame: bytes) -> None:
        try:
            conn = await self._get_connection(target)
            conn.writer.write(frame)
            await conn.writer.drain()
        except Exception as e:  # noqa: BLE001 - any IO failure fails the req
            self._drop_connection(target)
            self._fail_pending(rid, ConnectionError(f"send to {target}: {e}"))

    async def _get_connection(self, target: str) -> _Connection:
        conn = self._outbound.get(target)
        if conn is not None and not conn.closed:
            return conn
        # collapse concurrent dials into one
        fut = self._connecting.get(target)
        if fut is None:
            fut = self.loop.create_task(self._dial(target))
            self._connecting[target] = fut
            fut.add_done_callback(
                lambda _: self._connecting.pop(target, None)
            )
        return await asyncio.shield(fut)

    async def _dial(self, target: str) -> _Connection:
        if self._closed:
            raise ConnectionError("transport closed")
        addr = self.seeds.get(target)
        if addr is None:
            raise ConnectionError(f"no address for node [{target}]")
        reader, writer = await asyncio.open_connection(addr[0], addr[1])
        conn = _Connection(reader, writer)
        # handshake before any request (TransportHandshaker analog)
        conn.writer.write(encode_frame({
            "t": "handshake", "sender": self.node_id,
            "cluster": self.cluster_name, "version": PROTOCOL_VERSION,
        }))
        await conn.writer.drain()
        reply = await asyncio.wait_for(read_frame(conn.reader),
                                       self.timeout_ms / 1000.0)
        if (
            reply is None
            or reply.get("t") != "handshake"
            or reply.get("cluster") != self.cluster_name
            or reply.get("version") != PROTOCOL_VERSION
        ):
            conn.close()
            raise ConnectionError(f"handshake with {target} failed: {reply}")
        conn.peer_id = reply.get("sender")
        self._outbound[target] = conn
        self.loop.create_task(self._read_responses(target, conn))
        return conn

    def _drop_connection(self, target: str) -> None:
        conn = self._outbound.pop(target, None)
        if conn is not None:
            conn.close()

    async def _read_responses(self, target: str, conn: _Connection) -> None:
        """Response frames come back on the same connection the request
        went out on (full-duplex, pipelined — no per-request socket)."""
        try:
            while not conn.closed:
                frame = await read_frame(conn.reader)
                if frame is None:
                    break
                self._handle_response(frame)
        except ValueError:
            # oversized/corrupt frame: the stream is unrecoverable — drop
            # the connection (a fresh dial resyncs) instead of leaving a
            # dead reader behind a live-looking socket
            pass
        finally:
            self._drop_connection(target)

    def _handle_response(self, frame: dict) -> None:
        rid = frame.get("id")
        entry = self._pending.pop(rid, None)
        if entry is None:
            # timed out earlier; the id is tombstoned (popped) so the late
            # response is dropped instead of firing a recycled callback
            self.stats["late_dropped"] += 1
            return
        on_response, on_failure, timer = entry
        timer.cancel()
        if frame.get("t") == "err":
            if on_failure is not None:
                on_failure(RemoteTransportException(str(frame.get("error"))))
        elif on_response is not None:
            on_response(frame.get("payload"))

    def _fail_pending(self, rid: int, error: Exception) -> None:
        entry = self._pending.pop(rid, None)
        if entry is None:
            return
        self.stats["dropped"] += 1
        on_response, on_failure, timer = entry
        timer.cancel()
        if on_failure is not None:
            on_failure(error)

    # -- inbound -----------------------------------------------------------

    async def _accept(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        conn = _Connection(reader, writer)
        self._inbound.add(conn)
        try:
            hello = await asyncio.wait_for(read_frame(reader),
                                           self.timeout_ms / 1000.0)
            if (
                hello is None
                or hello.get("t") != "handshake"
                or hello.get("cluster") != self.cluster_name
                or hello.get("version") != PROTOCOL_VERSION
            ):
                return
            conn.peer_id = hello.get("sender")
            writer.write(encode_frame({
                "t": "handshake", "sender": self.node_id,
                "cluster": self.cluster_name, "version": PROTOCOL_VERSION,
            }))
            await writer.drain()
            while not conn.closed:
                frame = await read_frame(reader)
                if frame is None:
                    break
                if frame.get("t") == "req":
                    self._handle_request(conn, frame)
        except (asyncio.TimeoutError, ConnectionError, OSError, ValueError):
            pass
        finally:
            self._inbound.discard(conn)
            conn.close()

    def _handle_request(self, conn: _Connection, frame: dict) -> None:
        self.stats["rx"] += 1
        rid = frame["id"]
        action = frame.get("action")
        sender = frame.get("sender", "?")
        handler = self.handlers.get(action)

        def respond(result: Any, error: Exception | None) -> None:
            if conn.closed:
                return
            if error is not None:
                body = {"t": "err", "id": rid, "error": f"{type(error).__name__}: {error}"}
            else:
                body = {"t": "res", "id": rid, "payload": result}
            try:
                frame = encode_frame(body)
            except ValueError as e:
                # unshippable response (e.g. over MAX_FRAME): tell the
                # caller instead of dying silently
                frame = encode_frame({"t": "err", "id": rid,
                                      "error": f"ValueError: {e}"})
            conn.writer.write(frame)
            # no drain await: the loop flushes; backpressure is handled by
            # the OS buffer for responses (they are small control messages)

        if handler is None:
            respond(None, RuntimeError(f"no handler for {action} on {self.node_id}"))
            return
        self.stats["delivered"] += 1
        try:
            # restore the sender's trace context so spans the handler opens
            # stitch into the caller's trace tree (cross-node propagation)
            with handler_trace_scope(frame.get(TRACE_HEADER)):
                result = handler(sender, frame.get("payload"))
        except Exception as e:  # noqa: BLE001 - remote errors travel back
            respond(None, e)
            return
        if isinstance(result, DeferredResponse):
            result.on_done(lambda d: respond(d.result, d.error))
        else:
            respond(result, None)

    # -- loopback ----------------------------------------------------------

    def _dispatch_local(self, sender: str, action: str, payload: Any,
                        on_response, on_failure) -> None:
        handler = self.handlers.get(action)
        if handler is None:
            if on_failure is not None:
                on_failure(RuntimeError(f"no handler for {action}"))
            return
        self.stats["delivered"] += 1
        try:
            result = handler(sender, payload)
        except Exception as e:  # noqa: BLE001
            if on_failure is not None:
                on_failure(e)
            return

        def finish(res: Any, err: Exception | None) -> None:
            if err is not None:
                if on_failure is not None:
                    on_failure(err)
            elif on_response is not None:
                on_response(res)

        if isinstance(result, DeferredResponse):
            result.on_done(lambda d: finish(d.result, d.error))
        else:
            finish(result, None)
