"""Asyncio HTTP/1.1 server hosting the REST layer over a TorchNode.

Counterpart of opensearch_tpu/rest/http.py: stdlib asyncio streams,
keep-alive, content-length bodies, NDJSON detection for _bulk/_msearch,
the 413 bound on a body, and the OpenSearch error envelope
({"error": {...}, "status": N}). A request the port does not serve yet
raises NotImplementedError ("... is not yet ported to
opensearch_tpu_torch"), which the generic guard answers as the
reference's 500 envelope on a connection that stays open.

Executors, as the reference's: one serial data worker (writes and
everything else), one management worker (`_tasks`), and a parallel
search pool split by priority lane (search/lanes.py), so concurrent HTTP
searches reach the stacked serving step and the kNN dispatch batcher
together; the lane rides a contextvar into the batcher. Each request is one
``http_request`` span on the node's tracer (node.telemetry), under which
a handler's spans parent. Each request's body bytes are charged to the
node's in-flight request breaker (``node.breakers``, common/breaker.py)
before it is dispatched, and released once on every way out: a response,
the bounded background lane's 429, an error, or an exception.

Run (on the card; ``--device cpu`` runs it on the CPU)::

    python -m opensearch_tpu_torch.rest.http --port 9200 --data /tmp/data

``port=0`` binds an ephemeral port; :attr:`HttpServer.port` is the bound
one once the server has started.
"""

from __future__ import annotations

import argparse
import asyncio
import contextvars
import json
import logging
import os
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any
from urllib.parse import parse_qsl, unquote, urlsplit

from opensearch_tpu_torch.common.errors import OpenSearchTpuException
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.rest.handlers import apply_filter_path, build_router
from opensearch_tpu_torch.search import lanes as lanes_mod

MAX_BODY = 100 * 1024 * 1024  # the reference's http.max_content_length default


class _BadRequest(Exception):
    pass


class _EntityTooLarge(Exception):
    pass


class HttpServer:
    def __init__(self, node: TorchNode, host: str = "127.0.0.1",
                 port: int = 9200):
        self.node = node
        self.host = host
        self.port = port
        self.router = build_router()
        self._server: asyncio.AbstractServer | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        # writes run on a single worker: the engine is single-writer. The
        # _tasks APIs get their OWN worker (the reference's management
        # pool)
        self._executor = ThreadPoolExecutor(max_workers=1)
        self._mgmt_executor = ThreadPoolExecutor(max_workers=1)
        # read-only searches get a PARALLEL pool (the reference's search
        # pool): they run against immutable acquired snapshots, so N
        # concurrent clients reach the stacked step and the batcher
        # together. Background-classified requests (_msearch, ?lane=
        # background) run a smaller pool with a BOUNDED queue, so a
        # background flood can never occupy every interactive slot.
        self._search_executor = ThreadPoolExecutor(
            max_workers=min(8, (os.cpu_count() or 2)),
            thread_name_prefix="search",
        )
        self._background_executor = ThreadPoolExecutor(
            max_workers=max(2, min(4, (os.cpu_count() or 2) // 2)),
            thread_name_prefix="search-bg",
        )
        self.lane_tracker = (getattr(node, "lane_tracker", None)
                             or lanes_mod.LaneTracker())

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port
        )
        # port 0 asked for an ephemeral port: expose the bound one
        self.port = self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        # release the worker pools: embedders and tests boot many servers
        # per process
        for pool in (self._executor, self._mgmt_executor,
                     self._search_executor, self._background_executor):
            pool.shutdown(wait=False)

    # -- serving from a thread ----------------------------------------------

    def start_in_thread(self, timeout: float = 30.0) -> None:
        """Serve from a daemon thread with its own event loop; returns once
        the socket is bound (:attr:`port` is then the bound port)."""
        bound = threading.Event()
        failure: list[BaseException] = []
        self._loop = asyncio.new_event_loop()

        def run() -> None:
            asyncio.set_event_loop(self._loop)
            try:
                self._loop.run_until_complete(self.start())
            except BaseException as e:  # noqa: BLE001 - reported below
                failure.append(e)
                bound.set()
                return
            bound.set()
            self._loop.run_forever()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="http-server")
        self._thread.start()
        if not bound.wait(timeout):
            raise TimeoutError("the HTTP server did not bind in time")
        if failure:
            raise failure[0]

    def stop_thread(self, timeout: float = 30.0) -> None:
        """Stop a server started by :meth:`start_in_thread`: close the
        listener and every open connection, then join the thread."""
        if self._loop is None:
            return

        async def shutdown() -> None:
            current = asyncio.current_task()
            # the open keep-alive connections end with their handlers
            handlers = [t for t in asyncio.all_tasks() if t is not current]
            for task in handlers:
                task.cancel()
            await asyncio.gather(*handlers, return_exceptions=True)
            await self.stop()

        asyncio.run_coroutine_threadsafe(shutdown(), self._loop).result(
            timeout)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout)
        self._loop.close()
        self._loop = None

    # -- connection handling ----------------------------------------------

    async def _handle_connection(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while True:
                try:
                    request = await self._read_request(reader)
                except _BadRequest as e:
                    await self._write_response(
                        writer, 400,
                        {"error": {"type": "parse_exception", "reason": str(e)},
                         "status": 400},
                        "application/json", keep_alive=False, head=False,
                    )
                    break
                except _EntityTooLarge:
                    await self._write_response(
                        writer, 413,
                        {"error": {"type": "content_too_large_exception",
                                   "reason": "request entity too large"},
                         "status": 413},
                        "application/json", keep_alive=False, head=False,
                    )
                    break
                if request is None:
                    break
                method, path, query, headers, body = request
                status, payload, content_type = await self._dispatch(
                    method, path, query, body
                )
                keep_alive = headers.get("connection", "keep-alive") != "close"
                await self._write_response(
                    writer, status, payload, content_type,
                    keep_alive=keep_alive, head=(method == "HEAD"),
                )
                if not keep_alive:
                    break
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception as e:  # noqa: BLE001 - best-effort close
                logging.getLogger(__name__).debug(
                    "http connection close failed: %s", e)

    async def _read_request(self, reader: asyncio.StreamReader):
        try:
            request_line = await reader.readline()
        except (ConnectionResetError, asyncio.LimitOverrunError):
            return None
        if not request_line:
            return None
        try:
            method, target, _version = request_line.decode("latin1").split(" ", 2)
        except ValueError:
            return None
        headers: dict[str, str] = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            name, _, value = line.decode("latin1").partition(":")
            headers[name.strip().lower()] = value.strip()
        try:
            length = int(headers.get("content-length", 0))
        except ValueError as e:
            raise _BadRequest("invalid Content-Length header") from e
        if length > MAX_BODY:
            raise _EntityTooLarge()
        body = await reader.readexactly(length) if length else b""
        split = urlsplit(target)
        query = dict(parse_qsl(split.query, keep_blank_values=True))
        return method, unquote(split.path), query, headers, body

    # -- dispatch ----------------------------------------------------------

    @staticmethod
    def _is_parallel_search(path: str, query: dict) -> bool:
        """Read-only search requests eligible for the parallel pool. A
        scroll start stays on the serial data worker, as in the
        reference."""
        if "scroll" in query:
            return False
        tail = path.rsplit("/", 1)[-1]
        return tail in ("_search", "_msearch", "_count")

    async def _dispatch(
        self, method: str, path: str, query: dict, raw_body: bytes
    ) -> tuple[int, Any, str]:
        try:
            handler, params = self.router.resolve(method, path)
            body = _parse_body(path, raw_body)
            # the transport knows the payload size: bulk accounts it
            # against indexing pressure without serializing every document
            if path.endswith("/_bulk") or path == "/_bulk":
                query["_payload_bytes"] = len(raw_body)
            # in-flight request bytes against the breaker (the reference's
            # in_flight_requests child tracks transport payload bytes); a
            # trip raises CircuitBreakingException (429) with nothing held
            breakers = self.node.breakers
            charged = len(raw_body)
            if charged:
                breakers.in_flight_requests.add_estimate_and_maybe_break(
                    charged, "<http_request>")
            try:
                status, payload = await self._run_handler(
                    handler, params, method, path, query, body)
            finally:
                if charged:
                    breakers.in_flight_requests.release(charged)
            if "filter_path" in query and status < 400:
                payload = apply_filter_path(payload, query["filter_path"])
            content_type = (
                "text/plain" if isinstance(payload, str) else "application/json"
            )
            return status, payload, content_type
        except OpenSearchTpuException as e:
            return e.status, _error_envelope(e), "application/json"
        except json.JSONDecodeError as e:
            return 400, {
                "error": {"type": "parse_exception", "reason": str(e)},
                "status": 400,
            }, "application/json"
        except Exception as e:  # noqa: BLE001 - top-level 500 guard
            if not isinstance(e, NotImplementedError):
                traceback.print_exc()
            return 500, {
                "error": {"type": "exception", "reason": str(e)},
                "status": 500,
            }, "application/json"

    async def _run_handler(self, handler, params, method: str, path: str,
                           query: dict, body) -> tuple[int, Any]:
        """Pick the executor (the management worker for `_tasks`, the
        search pool of the request's priority lane, or the serial data
        worker) and run the handler there under an ``http_request`` span.
        The bounded background lane sheds with a 429 instead of queueing."""
        telemetry = self.node.telemetry
        metrics = telemetry.metrics
        lane_cfg = lanes_mod.default_config
        lane = (lanes_mod.classify_rest(path, query)
                if lane_cfg.enabled else lanes_mod.INTERACTIVE)
        # the lane reaches handlers through the lane_scope contextvar
        # below, never the query dict (strict handlers reject unknown
        # parameters)
        tracked = False
        if path.startswith("/_tasks"):
            executor = self._mgmt_executor
        elif self._is_parallel_search(path, query):
            if lane_cfg.enabled and lane == lanes_mod.BACKGROUND:
                executor = self._background_executor
                if not self.lane_tracker.try_submit(
                        lane, lane_cfg.background_max_queue):
                    # bounded background lane: shed, never queue without
                    # bound
                    lanes_mod.record_lane_shed(metrics, lane)
                    return 429, {
                        "error": {
                            "type": "rejected_execution_exception",
                            "reason": "background lane queue is full",
                        },
                        "status": 429,
                    }
            else:
                executor = self._search_executor
                self.lane_tracker.try_submit(lane)
            tracked = True
        else:
            executor = self._executor
        try:
            if tracked:
                lanes_mod.record_lane_metrics(
                    metrics, lane, self.lane_tracker.depth(lane))
            with telemetry.tracer.start_span(
                    "http_request", {"method": method, "path": path,
                                     "lane": lane}) as span:
                # handlers are synchronous work; run them off the event
                # loop so slow searches don't stall socket IO. The
                # contextvars context is copied into the worker thread, so
                # handler spans parent under this span and the lane scope
                # rides it into the dispatch batcher.
                def run_handler():
                    with lanes_mod.lane_scope(lane):
                        return handler(self.node, params, query, body)

                ctx = contextvars.copy_context()
                status, payload = await asyncio.get_running_loop(
                ).run_in_executor(executor, ctx.run, run_handler)
                span.set_attribute("status", status)
        finally:
            if tracked:
                self.lane_tracker.complete(lane)
        return status, payload

    async def _write_response(
        self, writer, status: int, payload: Any, content_type: str,
        keep_alive: bool, head: bool,
    ) -> None:
        if isinstance(payload, str):
            data = payload.encode()
        else:
            data = json.dumps(payload).encode()
        reason = {200: "OK", 201: "Created", 400: "Bad Request", 404: "Not Found",
                  405: "Method Not Allowed", 409: "Conflict",
                  413: "Content Too Large", 429: "Too Many Requests",
                  500: "Internal Server Error",
                  503: "Service Unavailable"}.get(status, "OK")
        head_lines = (
            f"HTTP/1.1 {status} {reason}\r\n"
            f"content-type: {content_type}; charset=UTF-8\r\n"
            f"content-length: {len(data)}\r\n"
            f"connection: {'keep-alive' if keep_alive else 'close'}\r\n\r\n"
        )
        writer.write(head_lines.encode() + (b"" if head else data))
        await writer.drain()


def _parse_body(path: str, raw: bytes) -> Any:
    if not raw:
        return None
    # NDJSON only when the LAST path segment is the bulk/msearch endpoint
    # (a doc id like "report_bulk" must not trigger NDJSON parsing)
    if path.rstrip("/").rsplit("/", 1)[-1] in ("_bulk", "_msearch"):
        lines = []
        for line in raw.split(b"\n"):
            line = line.strip()
            if line:
                lines.append(json.loads(line))
        return lines
    return json.loads(raw)


def _error_envelope(e: OpenSearchTpuException) -> dict:
    detail = e.to_dict()
    return {
        "error": {
            "root_cause": [detail],
            **detail,
        },
        "status": e.status,
    }


def main() -> None:
    parser = argparse.ArgumentParser(description="opensearch-tpu-torch node")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=9200)
    parser.add_argument("--data", default="./data")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                             "cpu")
    args = parser.parse_args()
    node = TorchNode(args.data, device=args.device)
    server = HttpServer(node, args.host, args.port)

    async def serve() -> None:
        await server.start()
        print(f"opensearch-tpu-torch listening on "
              f"http://{args.host}:{server.port} ({node.device})", flush=True)
        assert server._server is not None
        async with server._server:
            await server._server.serve_forever()

    try:
        asyncio.run(serve())
    except KeyboardInterrupt:
        pass
    finally:
        node.close()


if __name__ == "__main__":
    main()
