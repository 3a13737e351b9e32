"""The port's REST server against the reference's, over real HTTP.

A TpuNode behind opensearch_tpu.rest.http.HttpServer and a
TorchNode(device="cpu") behind opensearch_tpu_torch.rest.http.HttpServer,
each on an ephemeral port (the test files run in parallel), take the same
request sequence: root info, the index lifecycle, HEAD, document CRUD with
versions, 404 and 409, `_update` with `doc` / `doc_as_upsert` / `upsert`
and `detect_noop`, an NDJSON `_bulk` with an update action, `_refresh`,
kNN `_search` (GET and POST, URL `size` / `from` / `_source`), `_msearch`,
stored scripts, `_render/template` and `_search/template`, search
pipelines (their CRUD, `?search_pipeline`, a body's `search_pipeline` in
`_msearch`), scripted `_update` and `scripted_upsert`,
`filter_path`, `rest_total_hits_as_int`, a 413, a malformed
Content-Length and `_cluster/health`. Each step's JSON bodies must be
equal with `took` removed (and an index's uuid and creation date, which
are random): floats (`_score`, `max_score`, an explanation's value) to
rtol 1e-5 / atol 1e-4, the tolerance tests/test_torch_node_knn.py states
and explains (the frameworks sum the d products in other orders, and l2
cancels near a neighbour). `GET /` differs only where it names the
package.

The search-context, alias and admission steps (`_context_steps`) follow:
`_flush` and `_forcemerge`, the request cache and `_cache/clear`, every
alias route (filtered, routed and write aliases, 404 riders, HEAD),
scroll and point in time through each of their routes, `_tasks`,
`_cluster/settings`, the workload-group routes with a tagged search and
`_bulk`, and `_otel/flush`; context ids, task clocks, workload-group ids
and the device-ledger section are left out of the comparison.

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

    def step(label, method, path, body=None, ndjson=None, norm=None):
        status, payload = c(method, path, body, ndjson)
        out.append((label, status,
                    norm(payload) if norm and payload else payload))
        return payload

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
    # stored scripts, search templates, search pipelines, scripted updates
    step("put_script", "PUT", "/_scripts/by_color", {"script": {
        "lang": "mustache",
        "source": '{"query": {"term": {"color": "{{c}}"}}, "size": {{n}}}'}})
    step("get_script", "GET", "/_scripts/by_color")
    step("get_script_missing", "GET", "/_scripts/nope")
    step("put_script_bad", "POST", "/_scripts/bad", {"script": {"lang": "x"}})
    step("script_context", "GET", "/_script_context")
    step("script_language", "GET", "/_script_language")
    step("render_stored", "POST", "/_render/template/by_color",
         {"params": {"c": "red", "n": 3}})
    step("render_inline", "GET", "/_render/template", {
        "source": {"query": {"match": {"title": "{{t}}"}}},
        "params": {"t": "number"}})
    step("render_missing", "POST", "/_render/template", {"id": "nope"})
    step("search_template", "POST", "/vecs/_search/template",
         {"id": "by_color", "params": {"c": "blue", "n": 4}})
    step("search_template_all", "GET", "/_search/template?rest_total_hits_"
         "as_int=true", {"source": {"query": {"term": {"color": "{{c}}"}}},
                        "params": {"c": "green"}})
    step("delete_script", "DELETE", "/_scripts/by_color")
    step("delete_script_again", "DELETE", "/_scripts/by_color")
    step("put_pipeline", "PUT", "/_search/pipeline/trunc", {
        "request_processors": [{"filter_query": {"query": {
            "term": {"color": "red"}}}}],
        "response_processors": [{"truncate_hits": {"target_size": 2}}]})
    step("put_pipeline_bad", "PUT", "/_search/pipeline/bad", {
        "response_processors": [{"nope": {}}]})
    step("get_pipelines", "GET", "/_search/pipeline")
    step("get_pipeline", "GET", "/_search/pipeline/trunc")
    step("search_pipeline_param", "POST", "/vecs/_search?search_pipeline="
         "trunc", _knn(qs[0], k=6, size=6))
    step("search_pipeline_missing", "POST", "/vecs/_search?search_pipeline="
         "nope", _knn(qs[0]))
    step("msearch_pipeline_key", "POST", "/vecs/_msearch", ndjson=[
        {}, {**_knn(qs[1], k=6, size=6), "search_pipeline": "trunc"},
        {}, _knn(qs[2], k=3, size=3)])
    step("delete_pipeline", "DELETE", "/_search/pipeline/trunc")
    step("get_pipeline_deleted", "GET", "/_search/pipeline/trunc")
    step("update_script", "POST", "/vecs/_update/7", {"script": {
        "source": "ctx._source.age += params.d", "params": {"d": 5}}})
    step("update_script_noop", "POST", "/vecs/_update/7", {"script": {
        "source": "ctx.op = 'none'"}})
    step("update_scripted_upsert", "POST", "/vecs/_update/s1", {
        "scripted_upsert": True, "upsert": {"age": 1},
        "script": {"source": "ctx._source.age += 100"}})
    step("get_s1", "GET", "/vecs/_doc/s1")
    step("get_7", "GET", "/vecs/_doc/7")
    _context_steps(step, docs, qs)
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


def _no_context_ids(obj):
    """Context ids and creation times differ between two servers."""
    if isinstance(obj, dict):
        return {k: _no_context_ids(v) for k, v in obj.items()
                if k not in ("pit_id", "_scroll_id", "creation_time")}
    if isinstance(obj, list):
        return [_no_context_ids(v) for v in obj]
    return obj


def _no_task_clocks(obj):
    """A task's clocks and id differ between two servers: a task map keyed
    by "<node>:<id>" becomes the list of its tasks."""
    if isinstance(obj, dict):
        if obj and all(re.fullmatch(r"node-0:\d+", k) for k in obj):
            return [_no_task_clocks(v) for v in obj.values()]
        return {k: _no_task_clocks(v) for k, v in obj.items()
                if k not in ("id", "start_time_in_millis",
                             "running_time_in_nanos", "resource_stats")}
    if isinstance(obj, list):
        return [_no_task_clocks(v) for v in obj]
    return obj


def _no_group_ids(obj):
    """A workload group's `_id` is random."""
    if isinstance(obj, dict):
        if "query_groups" in obj and isinstance(obj["query_groups"], dict):
            return {"query_groups": sorted(obj["query_groups"].values(),
                                           key=str)}
        return {k: _no_group_ids(v) for k, v in obj.items() if k != "_id"}
    if isinstance(obj, list):
        rows = [_no_group_ids(v) for v in obj]
        for r in rows:
            if isinstance(r, dict) and r.get("WORKLOAD_GROUP_ID") not in (
                    None, "DEFAULT_WORKLOAD_GROUP"):
                r["WORKLOAD_GROUP_ID"] = "<group>"
        return sorted(rows, key=str) if all(
            isinstance(r, dict) for r in rows) else rows
    return obj


def _no_device(obj):
    """`_otel/flush`'s device-ledger section differs between packages."""
    for node in obj.get("nodes", {}).values():
        node.pop("device", None)
    return obj


# the search-context, alias and admission steps (the 47 routes the port
# serves since the search-contexts slice), run after the kNN steps
CONTEXT_STEPS = []


def _context_steps(step, docs, qs) -> None:
    def ctx(label, *args, **kw):
        if label not in CONTEXT_STEPS:
            CONTEXT_STEPS.append(label)
        return step(label, *args, **kw)

    # flush, force merge, the request cache
    ctx("ctx_flush", "POST", "/vecs/_flush")
    ctx("ctx_flush_all", "POST", "/_flush")
    ctx("ctx_flush_missing", "POST", "/nope/_flush")
    ctx("ctx_forcemerge", "POST", "/vecs/_forcemerge?max_num_segments=1")
    ctx("ctx_forcemerge_all", "POST", "/_forcemerge?flush=false")
    cached = {"size": 0, "query": {"term": {"color": "red"}},
              "aggs": {"a": {"avg": {"field": "age"}}}}
    ctx("ctx_cache_fill", "POST", "/vecs/_search?request_cache=true", cached)
    ctx("ctx_cache_hit", "POST", "/vecs/_search", cached)
    ctx("ctx_cache_clear", "POST", "/vecs/_cache/clear")
    ctx("ctx_cache_clear_all", "POST", "/_cache/clear")
    # aliases: every route
    ctx("ctx_aliases", "POST", "/_aliases", {"actions": [{"add": {
        "index": "vecs", "alias": "reds",
        "filter": {"term": {"color": "red"}}}}]})
    ctx("ctx_aliases_missing", "POST", "/_aliases", {"actions": [
        {"remove": {"index": "vecs", "alias": "nope"}}]})
    ctx("ctx_aliases_malformed", "POST", "/_aliases", {"actions": [
        {"add": None}]})
    ctx("ctx_put_alias", "PUT", "/vecs/_alias/al1")
    ctx("ctx_post_alias", "POST", "/vecs/_alias/al2", {"routing": "1"})
    ctx("ctx_put_alias_body", "PUT", "/vecs/_alias", {"alias": "al3"})
    ctx("ctx_post_alias_body", "POST", "/vecs/_alias",
        {"alias": "al4", "is_write_index": True})
    ctx("ctx_put_alias_name", "PUT", "/_alias/al5", {"index": "vecs"})
    ctx("ctx_post_alias_name", "POST", "/_alias/al6",
        {"index": "vecs", "search_routing": "2"})
    ctx("ctx_put_alias_bare", "PUT", "/_alias",
        {"index": "vecs", "alias": "al7"})
    ctx("ctx_post_alias_bare", "POST", "/_alias",
        {"index": "vecs", "alias": "al8"})
    ctx("ctx_put_aliases", "PUT", "/vecs/_aliases/al9")
    ctx("ctx_put_alias_no_index", "PUT", "/_alias", {"alias": "x"})
    ctx("ctx_put_alias_bad_name", "PUT", "/vecs/_alias/bad*name")
    ctx("ctx_put_alias_unknown_key", "PUT", "/vecs/_alias/al0",
        {"bogus": 1})
    ctx("ctx_get_alias_all", "GET", "/_alias")
    ctx("ctx_get_alias_name", "GET", "/_alias/al1")
    ctx("ctx_get_alias_index", "GET", "/vecs/_alias")
    ctx("ctx_get_alias_index_name", "GET", "/vecs/_alias/al*,-al3")
    ctx("ctx_get_alias_missing", "GET", "/_alias/al1,nope")
    ctx("ctx_head_alias", "HEAD", "/_alias/al1")
    ctx("ctx_head_alias_missing", "HEAD", "/vecs/_alias/nope")
    ctx("ctx_delete_alias", "DELETE", "/vecs/_alias/al1")
    ctx("ctx_delete_aliases", "DELETE", "/vecs/_aliases/al2")
    ctx("ctx_delete_alias_missing", "DELETE", "/vecs/_alias/al1")
    ctx("ctx_search_filtered_alias", "POST", "/reds/_search",
        _knn(qs[0], k=6, size=6))
    ctx("ctx_count_filtered_alias", "GET", "/reds/_count")
    ctx("ctx_write_alias", "PUT", "/al4/_doc/wa?refresh=true", docs[11])
    ctx("ctx_get_write_alias", "GET", "/al4/_doc/wa")
    ctx("ctx_delete_index_via_alias", "DELETE", "/al4")
    # scroll
    norm = _no_context_ids
    first = ctx("ctx_scroll_start", "POST", "/vecs/_search?scroll=1m",
                _knn(qs[0], k=12, size=5), norm=norm)
    sid = first["_scroll_id"]
    ctx("ctx_scroll_get_body", "GET", "/_search/scroll", {"scroll_id": sid},
        norm=norm)
    ctx("ctx_scroll_post_body", "POST", "/_search/scroll",
        {"scroll_id": sid, "scroll": "2m"}, norm=norm)
    ctx("ctx_scroll_get_path", "GET", f"/_search/scroll/{sid}", norm=norm)
    ctx("ctx_scroll_post_path", "POST", f"/_search/scroll/{sid}?scroll=1m",
        norm=norm)
    ctx("ctx_scroll_clear_path", "DELETE", f"/_search/scroll/{sid}")
    ctx("ctx_scroll_clear_again", "DELETE", "/_search/scroll",
        {"scroll_id": [sid]})
    ctx("ctx_scroll_missing", "POST", "/_search/scroll",
        {"scroll_id": "scroll_gone"})
    ctx("ctx_scroll_no_id", "DELETE", "/_search/scroll")
    ctx("ctx_scroll_size_zero", "POST", "/vecs/_search?scroll=1m&size=0", {})
    ctx("ctx_scroll_restart", "POST", "/vecs/_search?scroll=1m",
        {"size": 3, "query": {"term": {"color": "green"}}}, norm=norm)
    ctx("ctx_scroll_clear_all", "DELETE", "/_search/scroll",
        {"scroll_id": "_all"})
    # point in time
    pid = ctx("ctx_pit_open", "POST",
              "/vecs/_search/point_in_time?keep_alive=1m", norm=norm)
    pid = pid["pit_id"]
    ctx("ctx_pit_search", "POST", "/_search",
        {"pit": {"id": pid}, **_knn(qs[2], k=5, size=5)}, norm=norm)
    ctx("ctx_pit_with_index", "POST", "/vecs/_search", {"pit": {"id": pid}})
    ctx("ctx_pit_list", "GET", "/_search/point_in_time/_all", norm=norm)
    ctx("ctx_pit_close", "DELETE", "/_search/point_in_time",
        {"pit_id": pid}, norm=norm)
    ctx("ctx_pit_close_no_id", "DELETE", "/_search/point_in_time")
    ctx("ctx_pit_reopen", "POST",
        "/vecs/_search/point_in_time?keep_alive=2m", norm=norm)
    ctx("ctx_pit_close_all", "DELETE", "/_search/point_in_time/_all",
        norm=norm)
    ctx("ctx_pit_no_keep_alive", "POST", "/vecs/_search/point_in_time")
    # tasks
    ctx("ctx_tasks", "GET", "/_tasks", norm=_no_task_clocks)
    ctx("ctx_tasks_none", "GET", "/_tasks?group_by=none&detailed=true",
        norm=_no_task_clocks)
    ctx("ctx_task_malformed", "GET", "/_tasks/abc")
    ctx("ctx_task_missing", "GET", "/_tasks/node-0:99999")
    ctx("ctx_tasks_cancel", "POST", "/_tasks/_cancel?actions=indices:*")
    ctx("ctx_task_cancel_missing", "POST", "/_tasks/99999/_cancel")
    # cluster settings
    ctx("ctx_settings_get", "GET", "/_cluster/settings")
    ctx("ctx_settings_put", "PUT", "/_cluster/settings", {
        "persistent": {"search.max_keep_alive": "1h"},
        "transient": {"search": {"knn": {"batch": {"max_wait_ms": "3ms"}}}}})
    ctx("ctx_settings_get_flat", "GET",
        "/_cluster/settings?flat_settings=true&include_defaults=true")
    ctx("ctx_settings_unknown", "PUT", "/_cluster/settings",
        {"persistent": {"x.y": 1}})
    ctx("ctx_settings_invalid", "PUT", "/_cluster/settings",
        {"transient": {"search.knn.batch.max_batch_size": 0}})
    ctx("ctx_settings_delete", "PUT", "/_cluster/settings?flat_settings=true",
        {"persistent": {"search.max_keep_alive": None},
         "transient": {"search.knn.batch.max_wait_ms": None}})
    # workload management
    groups = _no_group_ids
    ctx("ctx_wlm_put", "PUT", "/_wlm/query_group", {
        "name": "g1", "resiliency_mode": "enforced",
        "resource_limits": {"cpu": 0.5}}, norm=groups)
    ctx("ctx_wlm_put_bad", "PUT", "/_wlm/query_group", {
        "name": "g2", "resource_limits": {"cpu": 7}})
    ctx("ctx_wlm_get", "GET", "/_wlm/query_group", norm=groups)
    ctx("ctx_wlm_get_name", "GET", "/_wlm/query_group/g1", norm=groups)
    ctx("ctx_wlm_get_missing", "GET", "/_wlm/query_group/none")
    ctx("ctx_search_group", "POST", "/vecs/_search?query_group=g1",
        _knn(qs[1]))
    ctx("ctx_bulk_group", "POST", "/_bulk?query_group=g1&refresh=true",
        ndjson=[{"index": {"_index": "vecs", "_id": "g"}}, docs[12]])
    ctx("ctx_wlm_stats", "GET", "/_wlm/stats", norm=groups)
    ctx("ctx_wlm_list", "GET", "/_list/wlm_stats?format=json", norm=groups)
    ctx("ctx_wlm_list_bad", "GET", "/_list/wlm_stats?size=0")
    ctx("ctx_wlm_delete", "DELETE", "/_wlm/query_group/g1")
    # span export
    ctx("ctx_otel_flush", "POST", "/_otel/flush", norm=_no_device)


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
    "msearch_index_path", "msearch_total_int", "put_script", "get_script",
    "get_script_missing", "put_script_bad", "script_context",
    "script_language", "render_stored", "render_inline", "render_missing",
    "search_template", "search_template_all", "delete_script",
    "delete_script_again", "put_pipeline", "put_pipeline_bad",
    "get_pipelines", "get_pipeline", "search_pipeline_param",
    "search_pipeline_missing", "msearch_pipeline_key", "delete_pipeline",
    "get_pipeline_deleted", "update_script", "update_script_noop",
    "update_scripted_upsert", "get_s1", "get_7", "too_large",
    "bad_content_length", "malformed_json", "no_handler",
    "wrong_method", "health_end", "delete_index", "delete_missing",
    "delete_missing_ignored",
]


CONTEXT_LABELS = [
    "ctx_flush", "ctx_flush_all", "ctx_flush_missing", "ctx_forcemerge",
    "ctx_forcemerge_all", "ctx_cache_fill", "ctx_cache_hit",
    "ctx_cache_clear", "ctx_cache_clear_all", "ctx_aliases",
    "ctx_aliases_missing", "ctx_aliases_malformed", "ctx_put_alias",
    "ctx_post_alias", "ctx_put_alias_body", "ctx_post_alias_body",
    "ctx_put_alias_name", "ctx_post_alias_name", "ctx_put_alias_bare",
    "ctx_post_alias_bare", "ctx_put_aliases", "ctx_put_alias_no_index",
    "ctx_put_alias_bad_name", "ctx_put_alias_unknown_key",
    "ctx_get_alias_all", "ctx_get_alias_name", "ctx_get_alias_index",
    "ctx_get_alias_index_name", "ctx_get_alias_missing", "ctx_head_alias",
    "ctx_head_alias_missing", "ctx_delete_alias", "ctx_delete_aliases",
    "ctx_delete_alias_missing", "ctx_search_filtered_alias",
    "ctx_count_filtered_alias", "ctx_write_alias", "ctx_get_write_alias",
    "ctx_delete_index_via_alias", "ctx_scroll_start", "ctx_scroll_get_body",
    "ctx_scroll_post_body", "ctx_scroll_get_path", "ctx_scroll_post_path",
    "ctx_scroll_clear_path", "ctx_scroll_clear_again", "ctx_scroll_missing",
    "ctx_scroll_no_id", "ctx_scroll_size_zero", "ctx_scroll_restart",
    "ctx_scroll_clear_all", "ctx_pit_open", "ctx_pit_search",
    "ctx_pit_with_index", "ctx_pit_list", "ctx_pit_close",
    "ctx_pit_close_no_id", "ctx_pit_reopen", "ctx_pit_close_all",
    "ctx_pit_no_keep_alive", "ctx_tasks", "ctx_tasks_none",
    "ctx_task_malformed", "ctx_task_missing", "ctx_tasks_cancel",
    "ctx_task_cancel_missing", "ctx_settings_get", "ctx_settings_put",
    "ctx_settings_get_flat", "ctx_settings_unknown", "ctx_settings_invalid",
    "ctx_settings_delete", "ctx_wlm_put", "ctx_wlm_put_bad", "ctx_wlm_get",
    "ctx_wlm_get_name", "ctx_wlm_get_missing", "ctx_search_group",
    "ctx_bulk_group", "ctx_wlm_stats", "ctx_wlm_list", "ctx_wlm_list_bad",
    "ctx_wlm_delete", "ctx_otel_flush",
]


@pytest.mark.parametrize("label", STEPS + CONTEXT_LABELS)
def test_response_equals_the_references(transcripts, label):
    (ref_status, ref_body), (port_status, port_body) = transcripts[label]
    assert port_status == ref_status, (port_body, ref_body)
    _assert_same(_strip(ref_body), _strip(port_body))


def test_every_step_is_compared(transcripts):
    assert set(STEPS) | set(CONTEXT_LABELS) | {"root"} == set(transcripts)
    assert CONTEXT_STEPS == CONTEXT_LABELS


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
                ("POST", "/v/_update_by_query", {"script": {
                    "source": "ctx._source.a = 1"}}),
                ("GET", "/v/_stats", None),
                ("GET", "/_cluster/pending_tasks", None),
                ("POST", "/_reindex", {"source": {"index": "v"},
                                       "dest": {"index": "w"}})):
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


def test_scripts_templates_and_pipelines_are_served(transcripts):
    """The script, template and pipeline steps compared above are the
    served answers, not errors."""
    for label in ("put_script", "get_script", "render_stored",
                  "search_template", "search_template_all", "put_pipeline",
                  "get_pipeline", "search_pipeline_param", "update_script",
                  "update_scripted_upsert"):
        _ref, (status, _body) = transcripts[label]
        assert status == 200, label
    _ref, (_s, body) = transcripts["search_pipeline_param"]
    hits = body["hits"]["hits"]
    assert len(hits) == 2 and all(h["_source"]["color"] == "red"
                                  for h in hits)
    _ref, (_s, body) = transcripts["msearch_pipeline_key"]
    assert [len(r["hits"]["hits"]) for r in body["responses"]] == [2, 3]
    _ref, (_s, body) = transcripts["search_template"]
    assert body["hits"]["hits"] and len(body["hits"]["hits"]) <= 4
    _ref, (_s, body) = transcripts["get_s1"]
    assert body["_source"]["age"] == 101
    _ref, (_s, body) = transcripts["update_script_noop"]
    assert body["result"] == "noop"


# the 47 routes the search-contexts slice serves: each resolves to a ported
# handler (the sequence above compares its answers with the reference's)
CONTEXT_ROUTES = (
    ("GET", "/_search/scroll"), ("POST", "/_search/scroll"),
    ("GET", "/_search/scroll/{scroll_id}"),
    ("POST", "/_search/scroll/{scroll_id}"),
    ("DELETE", "/_search/scroll"), ("DELETE", "/_search/scroll/{scroll_id}"),
    ("POST", "/{index}/_search/point_in_time"),
    ("DELETE", "/_search/point_in_time"),
    ("DELETE", "/_search/point_in_time/_all"),
    ("GET", "/_search/point_in_time/_all"),
    ("POST", "/{index}/_flush"), ("POST", "/_flush"),
    ("POST", "/{index}/_forcemerge"), ("POST", "/_forcemerge"),
    ("POST", "/{index}/_cache/clear"), ("POST", "/_cache/clear"),
    ("POST", "/_aliases"), ("PUT", "/{index}/_alias/{name}"),
    ("POST", "/{index}/_alias/{name}"), ("PUT", "/{index}/_alias"),
    ("POST", "/{index}/_alias"), ("PUT", "/_alias/{name}"),
    ("POST", "/_alias/{name}"), ("PUT", "/_alias"), ("POST", "/_alias"),
    ("PUT", "/{index}/_aliases/{name}"), ("DELETE", "/{index}/_alias/{name}"),
    ("DELETE", "/{index}/_aliases/{name}"), ("GET", "/_alias"),
    ("GET", "/_alias/{name}"), ("GET", "/{index}/_alias"),
    ("GET", "/{index}/_alias/{name}"), ("HEAD", "/_alias/{name}"),
    ("HEAD", "/{index}/_alias/{name}"), ("POST", "/_otel/flush"),
    ("GET", "/_tasks"), ("GET", "/_tasks/{task_id}"),
    ("POST", "/_tasks/_cancel"), ("POST", "/_tasks/{task_id}/_cancel"),
    ("GET", "/_cluster/settings"), ("PUT", "/_cluster/settings"),
    ("PUT", "/_wlm/query_group"), ("GET", "/_wlm/query_group"),
    ("GET", "/_wlm/query_group/{name}"),
    ("DELETE", "/_wlm/query_group/{name}"), ("GET", "/_wlm/stats"),
    ("GET", "/_list/wlm_stats"),
)


def test_context_routes_are_served():
    assert len(CONTEXT_ROUTES) == len(set(CONTEXT_ROUTES)) == 47
    assert len(port_handlers.UNPORTED_ROUTES) == 158
    assert not set(CONTEXT_ROUTES) & set(port_handlers.UNPORTED_ROUTES)
    assert ("GET", "/_cluster/pending_tasks") in port_handlers.UNPORTED_ROUTES
    assert ("GET", "/_cat/pending_tasks") in port_handlers.UNPORTED_ROUTES
    for method, template in CONTEXT_ROUTES:
        ref_handler, _ = REF_ROUTER.resolve(method, _concrete(template))
        handler, _ = PORT_ROUTER.resolve(method, _concrete(template))
        assert getattr(port_handlers, ref_handler.__name__) is handler


def test_context_steps_are_not_vacuous(transcripts):
    """The context steps compared above answered what they should."""
    def port(label):
        return transcripts[label][1]

    assert port("ctx_search_filtered_alias")[0] == 200
    hits = port("ctx_search_filtered_alias")[1]["hits"]["hits"]
    assert hits and all(h["_source"]["color"] == "red" for h in hits)
    assert port("ctx_cache_clear")[1]["cleared"] == 1
    assert len(port("ctx_scroll_get_body")[1]["hits"]["hits"]) == 5
    assert port("ctx_scroll_clear_path")[1] == {"succeeded": True,
                                                "num_freed": 1}
    assert port("ctx_scroll_clear_again")[0] == 404
    assert port("ctx_scroll_missing")[0] == 404
    assert port("ctx_pit_search")[0] == 200 and \
        port("ctx_pit_search")[1]["hits"]["hits"]
    assert port("ctx_get_alias_missing")[0] == 404
    assert port("ctx_head_alias")[0] == 200
    assert port("ctx_head_alias_missing")[0] == 404
    assert port("ctx_get_write_alias")[1]["_index"] == "vecs"
    assert port("ctx_settings_unknown")[0] == 400
    assert port("ctx_task_malformed")[0] == 400
    assert port("ctx_wlm_list")[0] == 200
