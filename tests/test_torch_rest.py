"""The port's REST server against the reference's, over real HTTP.

A TpuNode behind opensearch_tpu.rest.http.HttpServer and a
TorchNode(device="cpu") behind opensearch_tpu_torch.rest.http.HttpServer,
each on an ephemeral port (the test files run in parallel), take the same
request sequence: root info, the index lifecycle, HEAD, document CRUD with
versions, 404 and 409, `_update` with `doc` / `doc_as_upsert` / `upsert`
and `detect_noop`, an NDJSON `_bulk` with an update action, `_refresh`,
kNN `_search` (GET and POST, URL `size` / `from` / `_source`), `_msearch`,
`filter_path`, `rest_total_hits_as_int`, a 413, a malformed
Content-Length and `_cluster/health`. Each step's JSON bodies must be
equal with `took` removed (and an index's uuid and creation date, which
are random): floats (`_score`, `max_score`, an explanation's value) to
rtol 1e-5 / atol 1e-4, the tolerance tests/test_torch_node_knn.py states
and explains (the frameworks sum the d products in other orders, and l2
cancels near a neighbour). `GET /` differs only where it names the
package.

Every (method, path) of the reference's router resolves in the port's: to
the same ported handler, or to one that answers "not yet ported" (the
500 envelope), never to a 404 or 405.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import re
import socket
import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu.rest import handlers as ref_handlers
from opensearch_tpu.rest.http import HttpServer as RefHttpServer
from opensearch_tpu.telemetry import roofline
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.rest import handlers as port_handlers
from opensearch_tpu_torch.rest.http import HttpServer

DIM = 8
N_DOCS = 60
RTOL, ATOL = 1e-5, 1e-4
RANDOM_SETTINGS = ("uuid", "creation_date", "index.uuid",
                   "index.creation_date")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_reference(node) -> tuple:
    srv = RefHttpServer(node, "127.0.0.1", _free_port())
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(srv.serve_forever())
        except RuntimeError:
            pass  # loop.stop() at teardown interrupts serve_forever

    threading.Thread(target=run, daemon=True).start()
    for _ in range(200):
        try:
            with socket.create_connection(("127.0.0.1", srv.port), 1):
                break
        except OSError:
            time.sleep(0.05)
    return srv, loop


class Client:
    """One keep-alive connection; JSON or NDJSON bodies."""

    def __init__(self, port: int):
        self.port = port
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)

    def __call__(self, method: str, path: str, body=None, ndjson=None):
        data = None
        headers = {"Content-Type": "application/json"}
        if ndjson is not None:
            data = ("\n".join(json.dumps(x) for x in ndjson) + "\n").encode()
            headers["Content-Type"] = "application/x-ndjson"
        elif body is not None:
            data = json.dumps(body).encode()
        self.conn.request(method, path, body=data, headers=headers)
        resp = self.conn.getresponse()
        raw = resp.read()
        if resp.getheader("connection") == "close":
            self.conn.close()
        return resp.status, (json.loads(raw) if raw else None)

    def raw(self, request: bytes):
        """A hand-written request on a fresh socket: (status, body)."""
        with socket.create_connection(("127.0.0.1", self.port), 30) as s:
            s.sendall(request)
            data = b""
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                data += chunk
        head, _, body = data.partition(b"\r\n\r\n")
        status = int(head.split(b" ", 2)[1])
        return status, json.loads(body) if body else None


def _docs(seed: int = 5) -> list[dict]:
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((N_DOCS, DIM)).astype(np.float32)
    colors = ("red", "green", "blue")
    return [{"v": vecs[i].round(4).tolist(), "age": int(rng.integers(0, 90)),
             "color": colors[i % 3], "title": f"doc number {i}",
             "created": f"2024-0{1 + i % 9}-1{i % 10}T00:00:00Z"}
            for i in range(N_DOCS)]


MAPPING = {"properties": {
    "v": {"type": "knn_vector", "dimension": DIM, "similarity": "l2_norm"},
    "age": {"type": "integer"}, "color": {"type": "keyword"},
    "title": {"type": "text"}, "created": {"type": "date"}}}


def _knn(q, k=5, **extra) -> dict:
    return {"query": {"knn": {"v": {"vector": q, "k": k}}}, **extra}


def _sequence(c: Client) -> list[tuple[str, int, object]]:
    """The request sequence, run against one server: (label, status,
    body) a step, in order."""
    out = []
    docs = _docs()
    rng = np.random.default_rng(11)
    qs = [rng.standard_normal(DIM).round(4).tolist() for _ in range(6)]

    def step(label, method, path, body=None, ndjson=None):
        status, payload = c(method, path, body, ndjson)
        out.append((label, status, payload))

    step("root", "GET", "/")
    step("create", "PUT", "/vecs", {
        "settings": {"index": {"number_of_shards": 2}}, "mappings": MAPPING})
    step("create_green", "PUT", "/green", {
        "settings": {"number_of_shards": 1, "number_of_replicas": 0}})
    step("create_again", "PUT", "/vecs", {"mappings": MAPPING})
    step("create_bad_name", "PUT", "/Bad", {})
    step("head_index", "HEAD", "/vecs")
    step("head_missing", "HEAD", "/missing")
    step("get_index", "GET", "/vecs")
    step("get_mapping", "GET", "/vecs/_mapping")
    step("get_mapping_all", "GET", "/_mapping")
    step("get_settings", "GET", "/vecs/_settings")
    step("get_settings_name", "GET", "/vecs/_settings/index.number_of_*")
    step("get_settings_flat", "GET", "/_settings?flat_settings=true")
    step("health_yellow", "GET", "/_cluster/health")
    step("health_green_index", "GET", "/_cluster/health/green?level=shards")
    step("health_wait_green", "GET", "/_cluster/health?wait_for_status=green")
    step("delete_green", "DELETE", "/green")
    step("get_deleted", "GET", "/green")
    # documents, with versions and seq_nos
    step("index_a1", "PUT", "/vecs/_doc/a1", docs[0])
    step("reindex_a1", "PUT", "/vecs/_doc/a1?refresh=true", docs[1])
    step("get_a1", "GET", "/vecs/_doc/a1")
    step("get_a1_includes", "GET", "/vecs/_doc/a1?_source_includes=age,color")
    step("get_a1_no_source", "GET", "/vecs/_doc/a1?_source=false")
    step("get_a1_stored", "GET", "/vecs/_doc/a1?stored_fields=age")
    step("get_a1_version", "GET", "/vecs/_doc/a1?version=1")
    step("source_a1", "GET", "/vecs/_source/a1?_source_excludes=v")
    step("head_a1", "HEAD", "/vecs/_doc/a1")
    step("head_source_a1", "HEAD", "/vecs/_source/a1")
    step("head_doc_missing", "HEAD", "/vecs/_doc/zz")
    step("get_missing", "GET", "/vecs/_doc/zz")
    step("get_missing_index", "GET", "/nope/_doc/zz")
    step("create_conflict", "PUT", "/vecs/_create/a1", docs[2])
    step("cas_conflict", "PUT",
         "/vecs/_doc/a1?if_seq_no=999&if_primary_term=1", docs[2])
    step("term_conflict", "PUT",
         "/vecs/_doc/a1?if_seq_no=1&if_primary_term=3", docs[2])
    step("create_a2", "POST", "/vecs/_create/a2", docs[3])
    step("external_a3", "PUT", "/vecs/_doc/a3?version=7&version_type=external",
         docs[4])
    step("external_stale", "PUT",
         "/vecs/_doc/a3?version=5&version_type=external", docs[4])
    step("bad_version_type", "PUT", "/vecs/_doc/a3?version=9&version_type=force",
         docs[4])
    step("delete_a2", "DELETE", "/vecs/_doc/a2")
    step("delete_a2_again", "DELETE", "/vecs/_doc/a2")
    step("no_body", "PUT", "/vecs/_doc/a9")
    # _update: doc, doc_as_upsert, upsert, detect_noop, _source
    step("update_missing", "POST", "/vecs/_update/u1", {"doc": {"age": 1}})
    step("update_doc_as_upsert", "POST", "/vecs/_update/u1",
         {"doc": docs[5], "doc_as_upsert": True})
    step("update_upsert", "POST", "/vecs/_update/u2",
         {"doc": {"age": 2}, "upsert": docs[6]})
    step("update_partial", "POST", "/vecs/_update/u2", {"doc": {"age": 3}})
    step("update_noop", "POST", "/vecs/_update/u2", {"doc": {"age": 3}})
    step("update_no_detect", "POST", "/vecs/_update/u2",
         {"doc": {"age": 3}, "detect_noop": False})
    step("update_source", "POST", "/vecs/_update/u2?_source=age,color",
         {"doc": {"color": "blue"}})
    step("update_unknown_key", "POST", "/vecs/_update/u2", {"dok": {}})
    step("update_cas", "POST", "/vecs/_update/u2?if_seq_no=0", {"doc": {"a": 1}})
    step("get_u2", "GET", "/vecs/_doc/u2")
    # NDJSON bulk with an update action and item errors
    lines = []
    for i, d in enumerate(docs):
        lines += [{"index": {"_index": "vecs", "_id": str(i)}}, d]
    lines += [{"update": {"_index": "vecs", "_id": "7"}}, {"doc": {"age": 70}},
              {"update": {"_id": "nope", "_index": "vecs"}}, {"doc": {"age": 1}},
              {"update": {"_index": "vecs", "_id": "u3"}},
              {"doc": {"age": 5}, "doc_as_upsert": True},
              {"delete": {"_index": "vecs", "_id": "8"}},
              {"delete": {"_index": "vecs", "_id": "never"}},
              {"create": {"_index": "vecs", "_id": "9"}}, docs[9]]
    step("bulk", "POST", "/_bulk", ndjson=lines)
    step("bulk_default_index", "POST", "/vecs/_bulk", ndjson=[
        {"index": {"_id": "b1"}}, docs[10], {"update": {"_id": "b1"}},
        {"doc": {"color": "red"}}])
    step("bulk_malformed", "POST", "/_bulk", ndjson=[{"index": {}, "x": 1}])
    step("refresh", "POST", "/vecs/_refresh")
    step("refresh_get", "GET", "/vecs/_refresh")
    step("refresh_all", "POST", "/_refresh")
    # kNN _search
    step("search_post", "POST", "/vecs/_search", _knn(qs[0]))
    step("search_get", "GET", "/vecs/_search", _knn(qs[1], k=8, size=8))
    step("search_url_paging", "POST",
         "/vecs/_search?size=3&from=2&_source=false", _knn(qs[2], k=6))
    step("search_url_source", "POST",
         "/vecs/_search?_source_includes=age,color&version=true"
         "&seq_no_primary_term=true", _knn(qs[3]))
    step("search_url_source_list", "POST", "/vecs/_search?_source=age",
         _knn(qs[3]))
    step("search_all", "POST", "/_search", _knn(qs[4], k=4, size=4))
    step("search_total_int", "POST", "/vecs/_search?rest_total_hits_as_int=true",
         _knn(qs[5]))
    step("search_total_int_bad", "POST",
         "/vecs/_search?rest_total_hits_as_int=true",
         _knn(qs[5], track_total_hits=3))
    step("search_filter_path", "POST",
         "/vecs/_search?filter_path=hits.hits._id,hits.total,-hits.hits._score",
         _knn(qs[0]))
    step("search_track_total", "POST", "/vecs/_search",
         _knn(qs[0], track_total_hits=4))
    step("search_unknown_key", "POST", "/vecs/_search",
         _knn(qs[0], bogus=1))
    step("search_missing_index", "POST", "/nope/_search", _knn(qs[0]))
    step("search_ignore_unavailable", "POST",
         "/vecs,nope/_search?ignore_unavailable=true", _knn(qs[0], k=3))
    step("search_bad_search_type", "POST",
         "/vecs/_search?search_type=scan", _knn(qs[0]))
    # _msearch
    step("msearch", "POST", "/_msearch", ndjson=[
        {"index": "vecs"}, _knn(qs[0], k=5, size=5),
        {"index": "vecs"}, _knn(qs[1], k=5, size=5),
        {"index": "vecs"}, _knn(qs[2], k=5, size=5, version=True),
        {"index": "nope"}, _knn(qs[3])])
    step("msearch_index_path", "POST", "/vecs/_msearch", ndjson=[
        {}, _knn(qs[4], k=3, size=3), {}, _knn(qs[5], k=3, size=3)])
    step("msearch_total_int", "POST", "/vecs/_msearch?rest_total_hits_as_int=true",
         ndjson=[{}, _knn(qs[4], k=2, size=2)])
    # the transport's own answers
    status, body = c.raw(b"POST /vecs/_doc/big HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Length: 200000000\r\n\r\n")
    out.append(("too_large", status, body))
    status, body = c.raw(b"POST /vecs/_search HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Length: abc\r\n\r\n")
    out.append(("bad_content_length", status, body))
    c.conn.request("POST", "/vecs/_search", body=b"{not json",
                   headers={"Content-Type": "application/json"})
    resp = c.conn.getresponse()
    out.append(("malformed_json", resp.status, json.loads(resp.read())))
    step("no_handler", "GET", "/vecs/_doc")
    step("wrong_method", "DELETE", "/_bulk")
    step("health_end", "GET", "/_cluster/health?level=indices")
    step("delete_index", "DELETE", "/vecs")
    step("delete_missing", "DELETE", "/vecs")
    step("delete_missing_ignored", "DELETE", "/vecs?ignore_unavailable=true")
    return out


@pytest.fixture(scope="module")
def transcripts(tmp_path_factory):
    prev_peaks = roofline.current_peaks()
    roofline.set_peaks(roofline.stub_peaks(seed=3))
    ref_node = TpuNode(tmp_path_factory.mktemp("ref"))
    port_node = TorchNode(tmp_path_factory.mktemp("port"), device="cpu")
    ref_srv, loop = _start_reference(ref_node)
    port_srv = HttpServer(port_node, "127.0.0.1", 0)
    port_srv.start_in_thread()
    try:
        ref = _sequence(Client(ref_srv.port))
        port = _sequence(Client(port_srv.port))
    finally:
        port_srv.stop_thread()
        loop.call_soon_threadsafe(loop.stop)
        ref_node.close()
        port_node.close()
        if prev_peaks is not None:
            roofline.set_peaks(prev_peaks)
    assert [s[0] for s in ref] == [s[0] for s in port]
    return {label: (r, p) for (label, *r), (_l, *p) in zip(ref, port)}


def _strip(obj):
    """Drop what legitimately differs between two runs: `took`, and an
    index's uuid and creation date."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k != "took" and k not in RANDOM_SETTINGS}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _assert_same(ref, port, path="$"):
    if isinstance(ref, float) or isinstance(port, float):
        assert isinstance(port, (int, float)) and not isinstance(port, bool), path
        assert np.isclose(port, ref, rtol=RTOL, atol=ATOL), (path, port, ref)
        return
    assert type(port) is type(ref), (path, port, ref)
    if isinstance(ref, dict):
        assert list(port) == list(ref), (path, list(port), list(ref))
        for k in ref:
            _assert_same(ref[k], port[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert len(port) == len(ref), (path, port, ref)
        for i, (a, b) in enumerate(zip(ref, port)):
            _assert_same(a, b, f"{path}[{i}]")
    else:
        assert port == ref, (path, port, ref)


STEPS = [
    "create", "create_green", "create_again", "create_bad_name",
    "head_index", "head_missing", "get_index", "get_mapping",
    "get_mapping_all", "get_settings", "get_settings_name",
    "get_settings_flat", "health_yellow", "health_green_index",
    "health_wait_green", "delete_green", "get_deleted", "index_a1",
    "reindex_a1", "get_a1", "get_a1_includes", "get_a1_no_source",
    "get_a1_stored", "get_a1_version", "source_a1", "head_a1",
    "head_source_a1", "head_doc_missing", "get_missing", "get_missing_index",
    "create_conflict", "cas_conflict", "term_conflict", "create_a2",
    "external_a3", "external_stale", "bad_version_type", "delete_a2",
    "delete_a2_again", "no_body", "update_missing", "update_doc_as_upsert",
    "update_upsert", "update_partial", "update_noop", "update_no_detect",
    "update_source", "update_unknown_key", "update_cas", "get_u2", "bulk",
    "bulk_default_index", "bulk_malformed", "refresh", "refresh_get",
    "refresh_all", "search_post", "search_get", "search_url_paging",
    "search_url_source", "search_url_source_list", "search_all",
    "search_total_int", "search_total_int_bad", "search_filter_path",
    "search_track_total", "search_unknown_key", "search_missing_index",
    "search_ignore_unavailable", "search_bad_search_type", "msearch",
    "msearch_index_path", "msearch_total_int", "too_large",
    "bad_content_length", "malformed_json", "no_handler",
    "wrong_method", "health_end", "delete_index", "delete_missing",
    "delete_missing_ignored",
]


@pytest.mark.parametrize("label", STEPS)
def test_response_equals_the_references(transcripts, label):
    (ref_status, ref_body), (port_status, port_body) = transcripts[label]
    assert port_status == ref_status, (port_body, ref_body)
    _assert_same(_strip(ref_body), _strip(port_body))


def test_every_step_is_compared(transcripts):
    assert set(STEPS) | {"root"} == set(transcripts)


def test_root_info_names_the_port(transcripts):
    (ref_status, ref_body), (port_status, port_body) = transcripts["root"]
    assert ref_status == port_status == 200
    assert list(port_body) == list(ref_body)
    assert list(port_body["version"]) == list(ref_body["version"])
    assert port_body["version"]["distribution"] == "opensearch-tpu-torch"
    from opensearch_tpu_torch import __version__

    assert port_body["version"]["number"] == __version__


def test_searches_found_hits(transcripts):
    """The kNN steps compared above are not vacuous."""
    for label in ("search_post", "search_get", "search_all"):
        _ref, (status, body) = transcripts[label]
        assert status == 200 and body["hits"]["hits"], label
    _ref, (_s, body) = transcripts["msearch"]
    assert [r["status"] for r in body["responses"]] == [200, 200, 200, 404]


# -- the route table ---------------------------------------------------------


def _reference_routes() -> list[tuple[str, str, str]]:
    """(method, template, handler name) of every registration in the
    reference's build_router, in its order."""
    out = []

    class Recorder:
        def register(self, method, template, handler):
            out.append((method, template, handler.__name__))

    router = ref_handlers.Router
    ref_handlers.Router = Recorder
    try:
        ref_handlers.build_router()
    finally:
        ref_handlers.Router = router
    return out


REF_ROUTES = _reference_routes()
PORT_ROUTER = port_handlers.build_router()
REF_ROUTER = ref_handlers.build_router()


def _concrete(template: str) -> str:
    return re.sub(r"\{(\w+)\}", lambda m: f"x{m.group(1)}", template)


def test_the_reference_has_its_routes():
    assert len(REF_ROUTES) == 267
    assert len({(m, t) for m, t, _h in REF_ROUTES}) == len(REF_ROUTES)


@pytest.mark.parametrize("method,template,name", REF_ROUTES,
                         ids=[f"{m} {t}" for m, t, _n in REF_ROUTES])
def test_every_reference_route_resolves_in_the_port(method, template, name):
    path = _concrete(template)
    ref_handler, ref_params = REF_ROUTER.resolve(method, path)
    handler, params = PORT_ROUTER.resolve(method, path)
    assert params == ref_params
    if ref_handler.__name__ in port_handlers.__dict__ and \
            getattr(port_handlers, ref_handler.__name__) is handler:
        return  # a ported handler: the sequence above compares its answers
    with pytest.raises(NotImplementedError,
                       match=rf"^{method} .* is not yet ported to "
                             rf"opensearch_tpu_torch$"):
        handler(None, params, {}, None)


def test_unported_routes_answer_the_500_envelope_and_keep_the_connection(
        tmp_path):
    node = TorchNode(tmp_path, device="cpu")
    srv = HttpServer(node, "127.0.0.1", 0)
    srv.start_in_thread()
    try:
        c = Client(srv.port)
        c("PUT", "/v", {"mappings": {"properties": {
            "v": {"type": "knn_vector", "dimension": 2}}}})
        c("PUT", "/v/_doc/1?refresh=true", {"v": [1.0, 0.0]})
        for method, path, body in (
                ("GET", "/_cat/indices", None),
                ("POST", "/v/_search", {"query": {"script": {
                    "script": {"source": "true"}}}}),
                ("GET", "/v/_stats", None),
                ("POST", "/v/_update/1", {"script": "ctx._source.a = 1"}),
                ("POST", "/v/_search?scroll=1m", {"query": {"knn": {"v": {
                    "vector": [1.0, 0.0], "k": 1}}}})):
            status, payload = c(method, path, body)
            assert status == 500, (path, payload)
            assert payload["status"] == 500
            assert payload["error"]["type"] == "exception"
            assert "not yet ported to opensearch_tpu_torch" in \
                payload["error"]["reason"]
            # the same keep-alive connection still serves a search
            status, payload = c("POST", "/v/_search", {"query": {"knn": {
                "v": {"vector": [1.0, 0.0], "k": 1}}}})
            assert status == 200 and payload["hits"]["hits"][0]["_id"] == "1"
    finally:
        srv.stop_thread()
        node.close()


def test_port_zero_binds_an_ephemeral_port(tmp_path):
    node = TorchNode(tmp_path, device="cpu")
    srv = HttpServer(node, "127.0.0.1", 0)
    srv.start_in_thread()
    try:
        assert srv.port > 0
        assert Client(srv.port)("GET", "/_cluster/health")[0] == 200
    finally:
        srv.stop_thread()
        node.close()


def test_server_without_a_card_raises(tmp_path, monkeypatch):
    """No fallback: the server's node is on the card unless asked."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchNode(tmp_path)


def test_concurrent_http_searches_equal_their_solo_ones(tmp_path):
    """More HTTP clients than search workers, a short switch interval: every
    response is the solo search's (the stacked step runs each search as
    its own launch, so the scores are the same bits too)."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(4)
    data = rng.standard_normal((300, DIM)).astype(np.float32).round(4)
    node = TorchNode(tmp_path, device="cpu")
    node.create_index("c", {"settings": {"number_of_shards": 2},
                            "mappings": MAPPING})
    node.bulk([("index", {"_index": "c", "_id": str(i)},
                {"v": data[i].tolist()}) for i in range(300)], refresh=True)
    bodies = [_knn((data[i] + 0.01).tolist(), k=5) for i in range(48)]
    solo = [node.search("c", b)["hits"]["hits"] for b in bodies]
    srv = HttpServer(node, "127.0.0.1", 0)
    srv.start_in_thread()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(t: int) -> list:
            c = Client(srv.port)
            return [(i, c("POST", "/c/_search", bodies[i])[1]["hits"]["hits"])
                    for i in range(t, len(bodies), 16)]

        with ThreadPoolExecutor(16) as pool:
            futures = [pool.submit(client, t) for t in range(16)]
            results = [r for f in futures for r in f.result(timeout=120)]
    finally:
        sys.setswitchinterval(interval)
        srv.stop_thread()
        node.close()
    assert len(results) == len(bodies)
    for i, hits in results:
        assert hits == solo[i], i
