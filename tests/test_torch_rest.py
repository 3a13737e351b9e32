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

The ingest, template and stats steps (`_ops_steps`) follow: the
`_ingest/pipeline` CRUD and `_simulate`, `pipeline=` on a write and a
`_bulk`, component, composable and legacy templates with an index a write
auto-creates, index patterns, `_segments`, `_stats`, `_cluster/stats`,
`_nodes` info and stats by metric, `_prometheus/metrics` and the `_cat`
tables; the volatile fields each mask names (NODE_VOLATILE,
_CAT_VOLATILE, `_no_prom_values`) are left out of the comparison.

The index-management and document-read steps (`_admin_steps`) follow,
then the backup steps (`_backup_steps`): repositories, snapshots and
their `_status`, restores renamed, refused over an open index and over a
closed one, `_cat/repositories` and `_cat/snapshots`, the remote store's
sync, stats and restore, `_reindex`, `_update_by_query`,
`_delete_by_query` and `_rank_eval`, with a kNN after each restore and
write; snapshot clocks and the remote store's location (each server's
own directory) are left out of the comparison.

Every (method, path) of the reference's router resolves in the port's, to
the port handler named after the reference's.
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
        if (resp.getheader("content-type") or "").startswith("text/plain"):
            return resp.status, raw.decode()  # a _cat table, Prometheus text
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


def _sequence(c: Client, scratch) -> list[tuple[str, int, object]]:
    """The request sequence, run against one server: (label, status,
    body) a step, in order. `scratch` is this server's own directory (the
    remote store's object repository)."""
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
    _ops_steps(step, docs)
    _admin_steps(step, docs, qs)
    _backup_steps(step, docs, qs, scratch)
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


# what a stats read differs in by nature between two runs of the same
# sequence, masked by name: clocks and uptimes, the os / process / jvm /
# fs probes of the host, the device sections (byte sizes of device
# tensors, the roofline's and heat ledger's kernel families, which name
# each package's own kernels), the telemetry ring's span and took
# timings, and the slow log's timings
NODE_VOLATILE = {"timestamp", "os", "process", "jvm", "fs", "device",
                 "roofline", "heat", "telemetry", "slowlog", "threads",
                 "uptime_in_millis", "start_time_in_millis"}
# and what differs by design: the `ingest` section (the port counts each
# pipeline and processor, IngestStats, where the reference reports a zero
# total)
NODE_DIFFERENT = {"ingest"}
# the `knn_batch` section's values read off a clock (the wait tuner's
# measured waits and arrival gaps, and the window derived from them) and
# the IVF-PQ build counters other suites in the process move
KNN_BATCH_CLOCKED = {"ewma_wait_ms", "ewma_gap_ms", "effective_wait_ms",
                     "index_builds"}


def knn_batch_trace(section: dict) -> dict:
    """The `knn_batch` section less its clock values, with the wait tuner's
    table cut to the stacked step's keys (the reference's names). The
    per-shard route's keys name the scan each package's `auto` policy
    takes on the CPU, an object id among them: the reference's XLA scan
    keys no k bucket, the port's K1 plain version one a bucket, so their
    number differs by design."""
    def strip(obj):
        if isinstance(obj, dict):
            return {k: strip(v) for k, v in obj.items()
                    if k not in KNN_BATCH_CLOCKED}
        return obj

    out = strip(section)
    stacked = {k: v for k, v in out["auto_tune"]["keys"].items()
               if k.startswith("('distributed_knn'")}
    out["auto_tune"]["keys"] = stacked
    out["auto_tune"]["tuned_keys"] = len(stacked)
    return out


def _no_timings(obj):
    """Every `*time_in_millis` of a stats body is a wall-clock timing."""
    if isinstance(obj, dict):
        return {k: _no_timings(v) for k, v in obj.items()
                if "time_in_millis" not in k}
    if isinstance(obj, list):
        return [_no_timings(v) for v in obj]
    return obj


def _no_node_probes(obj):
    if isinstance(obj, dict):
        # the request cache's bytes measure the cached responses, whose
        # `took` is a clock
        if "hit_count" in obj and "memory_size_in_bytes" in obj:
            obj = {k: v for k, v in obj.items()
                   if k != "memory_size_in_bytes"}
        return {k: _no_node_probes(knn_batch_trace(v) if k == "knn_batch"
                                   else v)
                for k, v in _no_timings(obj).items()
                if k not in NODE_VOLATILE | NODE_DIFFERENT}
    if isinstance(obj, list):
        return [_no_node_probes(v) for v in obj]
    return obj


def _no_commit_ids(obj):
    """`level=shards`: a shard's commit id is its engine's random uuid."""
    obj = _no_timings(obj)
    for shards in (obj.get("indices") or {}).values():
        for copies in (shards.get("shards") or {}).values():
            for c in copies:
                c.get("commit", {}).pop("id", None)
    return obj


def _no_cat_dates(rows):
    """A `_cat/indices?format=json` row's creation date is a clock."""
    return [{k: v for k, v in r.items()
             if k not in ("creation.date", "creation.date.string")}
            for r in rows]


def _no_ingest_clock(obj):
    """`_ingest.timestamp` is the clock at the pipeline's run."""
    if isinstance(obj, dict):
        return {k: (_no_ingest_clock({x: y for x, y in v.items()
                                      if x != "timestamp"})
                    if k == "_ingest" and isinstance(v, dict)
                    else _no_ingest_clock(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_no_ingest_clock(v) for v in obj]
    return obj


# _cat columns that differ by nature, masked in the text: an index's
# uuid (22 url-safe characters), clocks (epoch seconds and milliseconds,
# HH:MM:SS), the host's load, memory, cpu and disk figures (`_cat/nodes`,
# `_cat/allocation`), the process id (`_cat/thread_pool?h=pid`) and a
# running task's time
_CAT_VOLATILE = (
    (re.compile(r"(?<![\w-])[\w-]{22}(?![\w-])"), "<uuid>"),
    (re.compile(r"\b\d{13}\b"), "<ms>"),
    (re.compile(r"\b\d{10}\b"), "<epoch>"),
    (re.compile(r"\b\d{2}:\d{2}:\d{2}\b"), "<hh:mm:ss>"),
    (re.compile(r"\b\d+(\.\d+)?[kmgt]?b\b"), "<bytes>"),
    (re.compile(r"\b\d+\.\d+\b"), "<float>"),
    (re.compile(r"\b\d+ms\b"), "<ms>"),
)


def masked_cat(text):
    if not isinstance(text, str):
        return text
    for pattern, token in _CAT_VOLATILE:
        text = pattern.sub(token, text)
    return re.sub(r" +", " ", text)


def _no_prom_values(text):
    """Prometheus text with each sample's value masked where it is a
    time, a byte size or a gauge of the device (the series names and
    labels, and the counters', stay)."""
    out = []
    for line in text.splitlines():
        name = (line.split()[2] if line.startswith("# TYPE")
                else line.split("{")[0].split(" ")[0])
        if name.startswith(("opensearch_tpu_knn_batch",
                            "opensearch_tpu_knn_dispatch")):
            continue  # the batcher's series: NODE_DIFFERENT's knn_batch
        if "roofline" in name:
            continue  # its `family` labels name each package's kernels
        if name == "opensearch_tpu_device_resident_bytes":
            continue  # its `device` labels name each package's devices
        if name == "opensearch_tpu_structure_heat":
            continue  # the heat ledger is process-wide: other nodes' rows
        if not line.startswith("#") and any(w in name for w in (
                "took", "_ms", "seconds", "bytes", "roofline", "heat")):
            line = line.rsplit(" ", 1)[0] + " <v>"
        out.append(line)
    return "\n".join(out)


def _ops_steps(step, docs) -> None:
    """Ingest pipelines, index templates and the node's stats: one step at
    least for each of the 67 routes this slice serves, over the `vecs`
    index the steps above built, with the named volatile fields masked."""
    def st(label, method, path, body=None, ndjson=None, norm=None):
        if label not in OPS_STEPS:
            OPS_STEPS.append(label)
        return step(label, method, path, body, ndjson, norm)

    # ingest pipelines: CRUD, _simulate, pipeline= on writes and _bulk
    tagger = {"description": "tags a doc", "processors": [
        {"uppercase": {"field": "color", "target_field": "color_up"}},
        {"set": {"field": "ingested", "value": "yes"}},
        {"drop": {"if": "ctx.age > 85"}}]}
    st("ops_ing_put", "PUT", "/_ingest/pipeline/tagger", tagger)
    st("ops_ing_put_bad", "PUT", "/_ingest/pipeline/bad",
       {"processors": [{"nope": {}}]})
    st("ops_ing_get_all", "GET", "/_ingest/pipeline")
    st("ops_ing_get", "GET", "/_ingest/pipeline/tagger")
    st("ops_ing_get_missing", "GET", "/_ingest/pipeline/nope")
    sim_docs = {"docs": [{"_source": docs[0]}, {"_source": {"age": 99}}]}
    st("ops_ing_sim", "POST", "/_ingest/pipeline/tagger/_simulate",
       sim_docs, norm=_no_ingest_clock)
    st("ops_ing_sim_get", "GET",
       "/_ingest/pipeline/tagger/_simulate?verbose=true", sim_docs,
       norm=_no_ingest_clock)
    st("ops_ing_sim_inline", "POST", "/_ingest/pipeline/_simulate",
       {"pipeline": tagger, **sim_docs}, norm=_no_ingest_clock)
    st("ops_ing_sim_inline_get", "GET", "/_ingest/pipeline/_simulate",
       sim_docs)
    st("ops_ing_index", "PUT", "/vecs/_doc/p1?pipeline=tagger&refresh=true",
       docs[13])
    st("ops_ing_get_doc", "GET", "/vecs/_doc/p1")
    st("ops_ing_bulk", "POST", "/_bulk?pipeline=tagger&refresh=true", ndjson=[
        {"index": {"_index": "vecs", "_id": "p2"}}, docs[14],
        {"index": {"_index": "vecs", "_id": "p3", "pipeline": "_none"}},
        docs[15], {"index": {"_index": "vecs", "_id": "p4"}},
        {**docs[16], "age": 99}])
    st("ops_ing_get_bulk_doc", "GET", "/vecs/_doc/p2")
    st("ops_ing_missing_pipeline", "PUT", "/vecs/_doc/p5?pipeline=nope",
       docs[17])
    # templates: component, composable and legacy
    st("ops_tpl_comp_put", "PUT", "/_component_template/base", {"template": {
        "settings": {"number_of_shards": 1, "number_of_replicas": 0},
        "mappings": {"properties": {
            "v": {"type": "knn_vector", "dimension": DIM}}}}})
    st("ops_tpl_comp_post", "POST", "/_component_template/extra",
       {"template": {"mappings": {"properties": {
           "tag": {"type": "keyword"}}}}})
    st("ops_tpl_comp_bad", "PUT", "/_component_template/bad", {})
    st("ops_tpl_comp_get_all", "GET", "/_component_template")
    st("ops_tpl_comp_get", "GET", "/_component_template/base")
    st("ops_tpl_comp_get_missing", "GET", "/_component_template/nope")
    st("ops_tpl_put", "PUT", "/_index_template/logs", {
        "index_patterns": ["logs-*"], "composed_of": ["base", "extra"],
        "priority": 5, "template": {"aliases": {"all-logs": {}}}})
    st("ops_tpl_post", "POST", "/_index_template/logs2",
       {"index_patterns": ["logs-x*"], "priority": 1})
    st("ops_tpl_put_bad", "PUT", "/_index_template/bad",
       {"index_patterns": ["z*"], "composed_of": ["nope"]})
    st("ops_tpl_get_all", "GET", "/_index_template")
    st("ops_tpl_get", "GET", "/_index_template/logs*")
    st("ops_tpl_get_missing", "GET", "/_index_template/nope")
    st("ops_tpl_auto_create", "PUT", "/logs-1/_doc/1?refresh=true",
       {"v": docs[0]["v"], "tag": "a"})
    st("ops_tpl_get_index", "GET", "/logs-1")
    st("ops_tpl_search_alias", "POST", "/all-logs/_search",
       _knn(docs[0]["v"], k=1))
    st("ops_leg_put", "PUT", "/_template/old", {
        "index_patterns": ["old-*"], "order": 1,
        "settings": {"number_of_shards": 2},
        "aliases": {"olds": {"routing": "1"}}})
    st("ops_leg_post_create", "POST", "/_template/old?create=true",
       {"index_patterns": ["old-*"]})
    st("ops_leg_get_all", "GET", "/_template")
    st("ops_leg_get", "GET", "/_template/old?flat_settings=true")
    st("ops_leg_get_missing", "GET", "/_template/nope")
    st("ops_leg_head", "HEAD", "/_template/old")
    st("ops_leg_head_missing", "HEAD", "/_template/nope")
    st("ops_leg_create_index", "PUT", "/old-1", {})
    st("ops_leg_get_index", "GET", "/old-1")
    # wildcard expressions
    # (a "-" exclusion is the port's alone: tests/test_torch_wildcards.py)
    st("ops_wild_search", "POST", "/v*,logs-*/_search",
       _knn(docs[1]["v"], k=3))
    st("ops_wild_count", "GET", "/*/_count")
    st("ops_wild_mapping", "GET", "/l*/_mapping")
    st("ops_wild_none", "GET", "/zz*/_mapping?allow_no_indices=false")
    # _segments, _stats, _cluster/stats
    st("ops_segments", "GET", "/_segments")
    st("ops_segments_index", "GET", "/vecs/_segments")
    st("ops_stats", "GET", "/_stats", norm=_no_timings)
    st("ops_stats_metric", "GET", "/_stats/docs,search", norm=_no_timings)
    st("ops_stats_index", "GET", "/vecs/_stats", norm=_no_timings)
    st("ops_stats_index_metric", "GET",
       "/vecs/_stats/indexing,refresh?level=shards", norm=_no_commit_ids)
    st("ops_stats_bad_metric", "GET", "/_stats/bogus")
    st("ops_stats_bad_param", "GET", "/_stats?nope=1")
    st("ops_stats_pattern", "GET", "/logs-*,old-*/_stats/docs")
    st("ops_cluster_stats", "GET", "/_cluster/stats")
    # _nodes: info and stats
    st("ops_nodes", "GET", "/_nodes", norm=_no_node_probes)
    st("ops_nodes_id", "GET", "/_nodes/node-0", norm=_no_node_probes)
    st("ops_nodes_metric", "GET", "/_nodes/node-0/settings",
       norm=_no_node_probes)
    st("ops_nodes_stats", "GET", "/_nodes/stats", norm=_no_node_probes)
    st("ops_nodes_id_stats", "GET", "/_nodes/node-0/stats",
       norm=_no_node_probes)
    st("ops_nodes_stats_metric", "GET", "/_nodes/stats/indices,breaker",
       norm=_no_node_probes)
    st("ops_nodes_stats_index_metric", "GET",
       "/_nodes/stats/indices/docs,search", norm=_no_node_probes)
    st("ops_nodes_id_stats_metric", "GET", "/_nodes/node-0/stats/tasks",
       norm=_no_node_probes)
    st("ops_nodes_id_stats_index_metric", "GET",
       "/_nodes/node-0/stats/indices/indexing", norm=_no_node_probes)
    st("ops_nodes_stats_bad", "GET", "/_nodes/stats/knn_batc")
    st("ops_prometheus", "GET", "/_prometheus/metrics",
       norm=_no_prom_values)
    # _cat
    cat = masked_cat
    st("ops_cat", "GET", "/_cat")
    st("ops_cat_indices", "GET", "/_cat/indices?v=true&s=index", norm=cat)
    st("ops_cat_indices_json", "GET",
       "/_cat/indices/logs-*?format=json&h=index,docs.count,pri",
       norm=_no_cat_dates)
    st("ops_cat_health", "GET", "/_cat/health?v=true", norm=cat)
    st("ops_cat_shards", "GET", "/_cat/shards?s=index,shard,prirep",
       norm=cat)
    st("ops_cat_shards_index", "GET", "/_cat/shards/vecs?v=true", norm=cat)
    st("ops_cat_count", "GET", "/_cat/count?h=count")
    st("ops_cat_count_index", "GET", "/_cat/count/vecs?h=count")
    st("ops_cat_aliases", "GET", "/_cat/aliases?v=true&s=alias")
    st("ops_cat_aliases_name", "GET", "/_cat/aliases/all-*")
    st("ops_cat_allocation", "GET", "/_cat/allocation?h=shards,node")
    st("ops_cat_allocation_node", "GET", "/_cat/allocation/_master?v=true")
    st("ops_cat_nodes", "GET", "/_cat/nodes?h=ip,node.role,name",
       norm=cat)
    st("ops_cat_master", "GET", "/_cat/master")
    st("ops_cat_cluster_manager", "GET", "/_cat/cluster_manager?v=true")
    st("ops_cat_nodeattrs", "GET", "/_cat/nodeattrs")
    st("ops_cat_plugins", "GET", "/_cat/plugins?v=true")
    st("ops_cat_templates", "GET", "/_cat/templates?v=true&s=name")
    st("ops_cat_templates_name", "GET", "/_cat/templates/log*")
    st("ops_cat_thread_pool", "GET", "/_cat/thread_pool")
    st("ops_cat_thread_pool_pattern", "GET", "/_cat/thread_pool/sea*?v=true")
    st("ops_cat_segments", "GET", "/_cat/segments?s=index,shard", norm=cat)
    st("ops_cat_segments_index", "GET",
       "/_cat/segments/vecs?h=index,shard,docs.count")
    st("ops_cat_tasks", "GET", "/_cat/tasks?h=action,type,node")
    st("ops_cat_fielddata", "GET", "/_cat/fielddata")
    st("ops_cat_fielddata_fields", "GET", "/_cat/fielddata/title?v=true")
    # clean-up: pipelines and templates deleted, the made indices too
    st("ops_ing_delete", "DELETE", "/_ingest/pipeline/tagger")
    st("ops_ing_delete_missing", "DELETE", "/_ingest/pipeline/tagger")
    st("ops_tpl_delete", "DELETE", "/_index_template/logs")
    st("ops_tpl_delete_missing", "DELETE", "/_index_template/logs")
    st("ops_tpl_comp_delete", "DELETE", "/_component_template/extra")
    st("ops_leg_delete", "DELETE", "/_template/ol*")
    st("ops_delete_made", "DELETE", "/logs-*,old-1")
    st("ops_get_made", "GET", "/logs-1")


OPS_STEPS: list[str] = []


def _no_ephemeral(obj):
    """The node's ephemeral id is random in each package."""
    if isinstance(obj, dict):
        return {k: _no_ephemeral(v) for k, v in obj.items()
                if k != "ephemeral_id"}
    if isinstance(obj, list):
        return [_no_ephemeral(v) for v in obj]
    return obj


def _admin_steps(step, docs, qs) -> None:
    """Index management and document reads: one step at least for each of
    the 49 routes this slice serves, over `vecs` and the indices the steps
    make (a split, a shrink, a clone, a rollover series), then the
    `knn_batch` stats of the whole sequence. The steps leave `vecs` as
    they found it, less the fields the mapping update added."""
    def st(label, method, path, body=None, ndjson=None, norm=None):
        if label not in ADMIN_STEPS:
            ADMIN_STEPS.append(label)
        return step(label, method, path, body, ndjson, norm)

    v2 = np.random.default_rng(17).standard_normal((6, 4)).round(3)
    # mappings: a new knn_vector reaches the device at the next refresh
    st("adm_put_mapping", "PUT", "/vecs/_mapping", {"properties": {
        "v2": {"type": "knn_vector", "dimension": 4, "space_type": "l2"},
        "note": {"type": "keyword"}}})
    st("adm_post_mapping", "POST", "/vecs/_mapping", {"properties": {
        "remark": {"type": "text"}}})
    st("adm_put_mapping_conflict", "PUT", "/vecs/_mapping", {"properties": {
        "age": {"type": "keyword"}}})
    st("adm_field_mapping", "GET", "/_mapping/field/v*")
    st("adm_field_mapping_index", "GET",
       "/vecs/_mapping/field/title,age?include_defaults=true")
    st("adm_bulk_v2", "POST", "/_bulk?refresh=true", ndjson=[
        x for i in range(6) for x in (
            {"index": {"_index": "vecs", "_id": f"w{i}"}},
            {"v2": v2[i].tolist(), "note": "n", "remark": f"row {i}"})])
    st("adm_knn_v2", "POST", "/vecs/_search", {"query": {"knn": {"v2": {
        "vector": v2[2].tolist(), "k": 3}}}, "size": 10})
    st("adm_knn_v", "POST", "/vecs/_search", _knn(qs[3], k=8, size=8))
    # settings and blocks
    st("adm_put_settings", "PUT", "/vecs/_settings", {"index": {
        "refresh_interval": "2s"}})
    st("adm_put_settings_shards", "PUT", "/vecs/_settings", {
        "index.number_of_shards": 3})
    st("adm_put_all_settings", "PUT", "/_settings", {"index": {
        "max_ngram_diff": 2}})
    st("adm_get_settings", "GET", "/vecs/_settings/index.refresh*")
    st("adm_block", "PUT", "/vecs/_block/write")
    st("adm_block_bad", "PUT", "/vecs/_block/nope")
    st("adm_block_write", "PUT", "/vecs/_doc/blocked", docs[20])
    st("adm_block_bulk", "POST", "/_bulk", ndjson=[
        {"index": {"_index": "vecs", "_id": "blocked"}}, docs[20]])
    st("adm_block_knn", "POST", "/vecs/_search", _knn(qs[4]))
    # resize: the source is write-blocked; each target answers a kNN
    st("adm_split", "PUT", "/vecs/_split/vsplit", {"settings": {
        "index.number_of_shards": 4}})
    st("adm_split_again", "POST", "/vecs/_split/vsplit")
    st("adm_split_knn", "POST", "/vsplit/_search", _knn(qs[3], k=8, size=8))
    st("adm_split_count", "GET", "/vsplit/_count")
    st("adm_shrink", "PUT", "/vsplit/_shrink/vshrink", {"settings": {
        "index.number_of_shards": 1, "index.number_of_replicas": 0}})
    st("adm_shrink_copy", "POST",
       "/vsplit/_shrink/vshrink2?copy_settings=false")
    st("adm_shrink_bad", "POST", "/vsplit/_shrink/vshrink3", {"settings": {
        "index.number_of_shards": 3}})
    st("adm_clone", "PUT", "/vshrink/_clone/vclone")
    st("adm_clone_bad", "POST", "/vshrink/_clone/vclone2", {"settings": {
        "index.number_of_shards": 2}})
    st("adm_clone_knn", "POST", "/vclone/_search", _knn(qs[5], k=4))
    # close and open
    st("adm_close", "POST", "/vclone/_close")
    st("adm_close_search", "POST", "/vclone/_search", _knn(qs[5], k=4))
    st("adm_close_get", "GET", "/vclone/_doc/a1")
    st("adm_close_cat", "GET", "/_cat/indices/v*?h=status,index&s=index")
    st("adm_close_pattern", "POST", "/v*/_count")
    st("adm_open", "POST", "/vclone/_open")
    st("adm_open_knn", "POST", "/vclone/_search", _knn(qs[5], k=4))
    # rollover of a write alias
    st("adm_roll_create", "PUT", "/r-000001", {"aliases": {
        "rw": {"is_write_index": True}}})
    st("adm_roll_index", "PUT", "/rw/_doc/1?refresh=true", docs[21])
    st("adm_rollover", "POST", "/rw/_rollover", {"conditions": {
        "max_docs": 1, "max_age": "7d"}})
    st("adm_rollover_dry", "POST", "/rw/_rollover/r-custom?dry_run=true")
    st("adm_rollover_named", "POST", "/rw/_rollover/r-custom")
    st("adm_rollover_not_alias", "POST", "/vecs/_rollover")
    st("adm_roll_alias", "GET", "/_alias/rw")
    # _upgrade
    st("adm_upgrade", "POST", "/_upgrade")
    st("adm_upgrade_index", "POST", "/vecs/_upgrade")
    st("adm_upgrade_get", "GET", "/_upgrade")
    st("adm_upgrade_get_index", "GET", "/r-*/_upgrade")
    # _analyze
    st("adm_analyze_get", "GET", "/_analyze", {"text": "The Quick fox"})
    st("adm_analyze_post", "POST", "/_analyze", {
        "tokenizer": "standard", "filter": ["lowercase", "stop"],
        "text": ["The A fox", "b"], "explain": True})
    st("adm_analyze_index_get", "GET", "/vecs/_analyze", {
        "field": "title", "text": "Doc Number 4"})
    st("adm_analyze_index_post", "POST", "/vecs/_analyze", {
        "analyzer": "whitespace", "text": "x Y", "explain": True})
    st("adm_analyze_bad", "POST", "/_analyze", {})
    # document reads
    st("adm_mget_get", "GET", "/_mget", {"docs": [
        {"_index": "vecs", "_id": "a1"}, {"_index": "vsplit", "_id": "a3"},
        {"_index": "nope", "_id": "x"}]})
    st("adm_mget_post", "POST", "/_mget", {"docs": [
        {"_index": "vecs", "_id": "7", "_source": ["age"]}]})
    st("adm_mget_index_get", "GET", "/vecs/_mget", {"ids": ["a1", "zz"]})
    st("adm_mget_index_post", "POST", "/vecs/_mget?stored_fields=age",
       {"ids": ["a1", "s1"]})
    st("adm_mget_bad", "POST", "/vecs/_mget", {})
    st("adm_explain_get", "GET", "/vecs/_explain/a1", {"query": {
        "match": {"title": "doc"}}})
    st("adm_explain_post", "POST", "/vsplit/_explain/a1?_source=age",
       _knn(docs[1]["v"], k=3))
    st("adm_explain_missing", "POST", "/vecs/_explain/zz", {"query": {
        "match_all": {}}})
    st("adm_caps_get", "GET", "/_field_caps?fields=v*")
    st("adm_caps_post", "POST", "/_field_caps", {"fields": ["age", "note"]})
    st("adm_caps_index_get", "GET", "/vecs/_field_caps?fields=*")
    st("adm_caps_index_post", "POST", "/v*/_field_caps?fields=title", {
        "index_filter": {"term": {"color": "red"}}})
    st("adm_tv_get", "GET", "/vecs/_termvectors/a1")
    st("adm_tv_post", "POST",
       "/vecs/_termvectors/w1?term_statistics=true&offsets=false")
    st("adm_mtv_get", "GET", "/_mtermvectors", {"docs": [
        {"_index": "vecs", "_id": "a1"}, {"_index": "vsplit", "_id": "7"}]})
    st("adm_mtv_post", "POST", "/_mtermvectors", {"docs": [
        {"_index": "vecs", "_id": "w2", "fields": ["remark"]}]})
    st("adm_mtv_index_get", "GET", "/vecs/_mtermvectors?ids=a1,zz")
    st("adm_mtv_index_post", "POST", "/vecs/_mtermvectors", {
        "ids": ["7"], "term_statistics": True})
    st("adm_shards_get", "GET", "/_search_shards", norm=_no_ephemeral)
    st("adm_shards_post", "POST", "/_search_shards?index=vsplit",
       norm=_no_ephemeral)
    st("adm_shards_index_get", "GET", "/vsplit/_search_shards?routing=a1",
       norm=_no_ephemeral)
    st("adm_shards_index_post", "POST",
       "/vsplit/_search_shards?preference=_shards:1,3",
       {"slice": {"id": 0, "max": 2}}, norm=_no_ephemeral)
    st("adm_validate_get", "GET", "/_validate/query?explain=true", {
        "query": {"match": {"title": "doc"}}})
    st("adm_validate_post", "POST", "/_validate/query", {
        "query": {"bogus": {}}})
    st("adm_validate_index_get", "GET",
       "/vecs/_validate/query?q=title:doc&explain=true")
    st("adm_validate_index_post", "POST", "/vecs/_validate/query?explain=true",
       _knn(qs[0]))
    # clean-up, then the batcher's counters of the whole sequence
    st("adm_unblock", "PUT", "/vecs/_settings", {"index.blocks.write": False})
    st("adm_delete_made", "DELETE", "/vsplit,vshrink,vclone,r-*")
    st("adm_knn_batch", "GET", "/_nodes/stats/knn_batch",
       norm=_no_node_probes)


ADMIN_STEPS: list[str] = []

SNAPSHOT_CLOCKS = {"start_time_in_millis", "end_time_in_millis",
                   "duration_in_millis", "time_in_millis"}


def _no_snapshot_clocks(obj):
    """A snapshot response less its wall clocks, and a repository's
    location (the remote store's is each server's own directory)."""
    if isinstance(obj, dict):
        return {k: ("<location>" if k == "location"
                    else _no_snapshot_clocks(v))
                for k, v in obj.items() if k not in SNAPSHOT_CLOCKS}
    if isinstance(obj, list):
        return [_no_snapshot_clocks(v) for v in obj]
    return obj


CAT_SNAPSHOT_COLS = ("id,status,indices,successful_shards,failed_shards,"
                     "total_shards")


def _backup_steps(step, docs, qs, scratch) -> None:
    """Snapshots and repositories, the remote segment store, the reindex
    family and rank evaluation: one step at least for each of the 25
    routes this slice serves, over `vecs` and the indices the steps make
    (each deleted at the end). A kNN follows each restore, reindex and
    by-query write. `vecs` is left as it was found."""
    def st(label, method, path, body=None, ndjson=None,
           norm=_no_snapshot_clocks):
        if label not in BACKUP_STEPS:
            BACKUP_STEPS.append(label)
        return step(label, method, path, body, ndjson, norm)

    # repositories: a relative location lands under each node's data path
    st("bk_put_repo", "PUT", "/_snapshot/bk", {
        "type": "fs", "settings": {"location": "bk"}})
    st("bk_post_repo", "POST", "/_snapshot/bk2", {
        "type": "fs", "settings": {"location": "bk2"}})
    st("bk_put_repo_bad_type", "PUT", "/_snapshot/bad", {
        "type": "s3", "settings": {}})
    st("bk_put_repo_no_location", "PUT", "/_snapshot/bad", {"type": "fs"})
    st("bk_get_repos", "GET", "/_snapshot")
    st("bk_get_repo", "GET", "/_snapshot/bk")
    st("bk_get_repo_missing", "GET", "/_snapshot/nope")
    st("bk_cleanup", "POST", "/_snapshot/bk/_cleanup")
    st("bk_cleanup_missing", "POST", "/_snapshot/nope/_cleanup")
    st("bk_cat_repos", "GET", "/_cat/repositories?v=true")
    # snapshots
    st("bk_snap_put", "PUT", "/_snapshot/bk/s1", {"indices": "vecs"})
    st("bk_snap_post", "POST", "/_snapshot/bk/s2", {
        "indices": "vecs", "metadata": {"taken_by": "test"},
        "include_global_state": False})
    st("bk_snap_again", "PUT", "/_snapshot/bk/s1")
    st("bk_snap_bad_name", "PUT", "/_snapshot/bk/S1")
    st("bk_snap_missing_index", "PUT", "/_snapshot/bk/s3", {
        "indices": "nope"})
    st("bk_snap_get", "GET", "/_snapshot/bk/s1")
    st("bk_snap_get_all", "GET", "/_snapshot/bk/_all?verbose=false")
    st("bk_snap_get_pattern", "GET",
       "/_snapshot/bk/s*,zz?ignore_unavailable=true")
    st("bk_snap_get_missing", "GET", "/_snapshot/bk/zz")
    st("bk_snap_status", "GET", "/_snapshot/bk/s1/_status")
    st("bk_snap_status_missing", "GET", "/_snapshot/bk/zz/_status")
    st("bk_snap_status_ignored", "GET",
       "/_snapshot/bk/zz/_status?ignore_unavailable=true")
    st("bk_cat_snaps", "GET",
       f"/_cat/snapshots/bk?v=true&h={CAT_SNAPSHOT_COLS}")
    st("bk_cat_snaps_no_repo", "GET", "/_cat/snapshots?v=true")
    # restores: renamed beside the live index, refused over an open one,
    # over a closed one
    st("bk_restore_rename", "POST", "/_snapshot/bk/s1/_restore", {
        "indices": "vecs", "rename_pattern": "v(.+)",
        "rename_replacement": "restored-$1"})
    st("bk_restore_rename_knn", "POST", "/restored-ecs/_search",
       _knn(qs[1], k=6, size=6))
    st("bk_restore_open", "POST", "/_snapshot/bk/s1/_restore")
    st("bk_restore_missing", "POST", "/_snapshot/bk/zz/_restore")
    st("bk_close_restored", "POST", "/restored-ecs/_close")
    st("bk_restore_closed", "POST", "/_snapshot/bk/s2/_restore", {
        "rename_pattern": "vecs", "rename_replacement": "restored-ecs"})
    st("bk_restore_closed_knn", "POST", "/restored-ecs/_search",
       _knn(qs[2], k=6, size=6))
    st("bk_snap_delete", "DELETE", "/_snapshot/bk/s2")
    st("bk_snap_delete_missing", "DELETE", "/_snapshot/bk/s2")
    st("bk_repo_delete", "DELETE", "/_snapshot/bk2")
    st("bk_repo_delete_missing", "DELETE", "/_snapshot/bk2")
    # the remote segment store
    st("bk_rs_repo", "PUT", "/_snapshot/obj", {
        "type": "fs", "settings": {"location": str(scratch / "obj")}})
    st("bk_rs_create", "PUT", "/vrs", {"settings": {
        "number_of_shards": 2, "index.remote_store.enabled": True,
        "index.remote_store.segment.repository": "obj"},
        "mappings": MAPPING})
    st("bk_rs_bulk", "POST", "/_bulk?refresh=true", ndjson=[
        x for i in range(30) for x in (
            {"index": {"_index": "vrs", "_id": f"r{i}"}}, docs[i])])
    st("bk_rs_sync", "POST", "/vrs/_remotestore/_sync")
    st("bk_rs_stats", "GET", "/_remotestore/stats/vrs")
    st("bk_rs_delete", "DELETE", "/vrs")
    st("bk_rs_restore", "POST", "/_remotestore/_restore", {
        "indices": ["vrs"]})
    st("bk_rs_restore_none", "POST", "/_remotestore/_restore", {})
    st("bk_rs_knn", "POST", "/vrs/_search", _knn(qs[3], k=6, size=6))
    # the reindex family
    st("bk_copy_create", "PUT", "/vcopy", {"settings": {
        "number_of_shards": 2}, "mappings": MAPPING})
    st("bk_reindex", "POST", "/_reindex?refresh=true", {
        "source": {"index": "vecs", "size": 20},
        "dest": {"index": "vcopy"}})
    st("bk_reindex_same", "POST", "/_reindex", {
        "source": {"index": "vecs"}, "dest": {"index": "vecs"}})
    st("bk_reindex_no_dest", "POST", "/_reindex", {
        "source": {"index": "vecs"}})
    st("bk_reindex_knn", "POST", "/vcopy/_search", _knn(qs[4], k=6, size=6))
    st("bk_ubq", "POST", "/vcopy/_update_by_query?refresh=true", {
        "query": {"range": {"age": {"lt": 45}}},
        "script": {"source": "ctx._source.color = 'picked'"}})
    st("bk_ubq_knn", "POST", "/vcopy/_search", {"query": {"knn": {"v": {
        "vector": qs[4], "k": 6, "filter": {"term": {"color": "picked"}}}}},
        "size": 6})
    st("bk_dbq", "POST", "/vcopy/_delete_by_query?refresh=true", {
        "query": {"term": {"color": "picked"}}})
    st("bk_dbq_no_query", "POST", "/vcopy/_delete_by_query", {})
    st("bk_dbq_knn", "POST", "/vcopy/_search", _knn(qs[4], k=6, size=6))
    # rank evaluation: kNN requests rated by the unfiltered kNN's top 3
    rated = [{"_index": "vecs", "_id": d, "rating": 1}
             for d in ("a1", "7", "12")]
    requests = [{"id": f"q{i}", "request": _knn(qs[i], k=5),
                 "ratings": rated} for i in range(3)]
    st("bk_rank_eval_post", "POST", "/vecs/_rank_eval", {
        "requests": requests, "metric": {"precision": {"k": 5}}})
    st("bk_rank_eval_get", "GET", "/vecs/_rank_eval", {
        "requests": requests, "metric": {"dcg": {"normalize": True}}})
    st("bk_rank_eval_all_post", "POST", "/_rank_eval", {
        "requests": requests, "metric": {"mean_reciprocal_rank": {}}})
    st("bk_rank_eval_all_get", "GET", "/_rank_eval", {
        "requests": requests, "metric": {"recall": {"k": 5}}})
    st("bk_rank_eval_bad", "POST", "/vecs/_rank_eval", {"requests": []})
    # clean-up
    st("bk_delete_made", "DELETE", "/restored-ecs,vrs,vcopy")
    st("bk_cat_repos_end", "GET", "/_cat/repositories?format=json")


BACKUP_STEPS: list[str] = []


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
        # each package's process-wide kNN batcher starts the sequence
        # empty, so its `knn_batch` stats are this sequence's
        ref_node.knn_batcher.reset()
        ref = _sequence(Client(ref_srv.port),
                        tmp_path_factory.mktemp("ref-scratch"))
        port_node.knn_batcher.reset()
        port = _sequence(Client(port_srv.port),
                         tmp_path_factory.mktemp("port-scratch"))
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


OPS_LABELS = [
    "ops_ing_put", "ops_ing_put_bad", "ops_ing_get_all", "ops_ing_get",
    "ops_ing_get_missing", "ops_ing_sim", "ops_ing_sim_get",
    "ops_ing_sim_inline", "ops_ing_sim_inline_get", "ops_ing_index",
    "ops_ing_get_doc", "ops_ing_bulk", "ops_ing_get_bulk_doc",
    "ops_ing_missing_pipeline", "ops_tpl_comp_put", "ops_tpl_comp_post",
    "ops_tpl_comp_bad", "ops_tpl_comp_get_all", "ops_tpl_comp_get",
    "ops_tpl_comp_get_missing", "ops_tpl_put", "ops_tpl_post",
    "ops_tpl_put_bad", "ops_tpl_get_all", "ops_tpl_get",
    "ops_tpl_get_missing", "ops_tpl_auto_create", "ops_tpl_get_index",
    "ops_tpl_search_alias", "ops_leg_put", "ops_leg_post_create",
    "ops_leg_get_all", "ops_leg_get", "ops_leg_get_missing", "ops_leg_head",
    "ops_leg_head_missing", "ops_leg_create_index", "ops_leg_get_index",
    "ops_wild_search", "ops_wild_count", "ops_wild_mapping", "ops_wild_none",
    "ops_segments", "ops_segments_index", "ops_stats", "ops_stats_metric",
    "ops_stats_index", "ops_stats_index_metric", "ops_stats_bad_metric",
    "ops_stats_bad_param", "ops_stats_pattern", "ops_cluster_stats",
    "ops_nodes", "ops_nodes_id", "ops_nodes_metric", "ops_nodes_stats",
    "ops_nodes_id_stats", "ops_nodes_stats_metric",
    "ops_nodes_stats_index_metric", "ops_nodes_id_stats_metric",
    "ops_nodes_id_stats_index_metric", "ops_nodes_stats_bad",
    "ops_prometheus", "ops_cat", "ops_cat_indices", "ops_cat_indices_json",
    "ops_cat_health", "ops_cat_shards", "ops_cat_shards_index",
    "ops_cat_count", "ops_cat_count_index", "ops_cat_aliases",
    "ops_cat_aliases_name", "ops_cat_allocation", "ops_cat_allocation_node",
    "ops_cat_nodes", "ops_cat_master", "ops_cat_cluster_manager",
    "ops_cat_nodeattrs", "ops_cat_plugins", "ops_cat_templates",
    "ops_cat_templates_name", "ops_cat_thread_pool",
    "ops_cat_thread_pool_pattern", "ops_cat_segments",
    "ops_cat_segments_index", "ops_cat_tasks", "ops_cat_fielddata",
    "ops_cat_fielddata_fields", "ops_ing_delete", "ops_ing_delete_missing",
    "ops_tpl_delete", "ops_tpl_delete_missing", "ops_tpl_comp_delete",
    "ops_leg_delete", "ops_delete_made", "ops_get_made",
]


ADMIN_LABELS = [
    "adm_put_mapping", "adm_post_mapping", "adm_put_mapping_conflict",
    "adm_field_mapping", "adm_field_mapping_index", "adm_bulk_v2",
    "adm_knn_v2", "adm_knn_v", "adm_put_settings", "adm_put_settings_shards",
    "adm_put_all_settings", "adm_get_settings", "adm_block", "adm_block_bad",
    "adm_block_write", "adm_block_bulk", "adm_block_knn", "adm_split",
    "adm_split_again", "adm_split_knn", "adm_split_count", "adm_shrink",
    "adm_shrink_copy", "adm_shrink_bad", "adm_clone", "adm_clone_bad",
    "adm_clone_knn", "adm_close", "adm_close_search", "adm_close_get",
    "adm_close_cat", "adm_close_pattern", "adm_open", "adm_open_knn",
    "adm_roll_create", "adm_roll_index", "adm_rollover", "adm_rollover_dry",
    "adm_rollover_named", "adm_rollover_not_alias", "adm_roll_alias",
    "adm_upgrade", "adm_upgrade_index", "adm_upgrade_get",
    "adm_upgrade_get_index", "adm_analyze_get", "adm_analyze_post",
    "adm_analyze_index_get", "adm_analyze_index_post", "adm_analyze_bad",
    "adm_mget_get", "adm_mget_post", "adm_mget_index_get",
    "adm_mget_index_post", "adm_mget_bad", "adm_explain_get",
    "adm_explain_post", "adm_explain_missing", "adm_caps_get",
    "adm_caps_post", "adm_caps_index_get", "adm_caps_index_post",
    "adm_tv_get", "adm_tv_post", "adm_mtv_get", "adm_mtv_post",
    "adm_mtv_index_get", "adm_mtv_index_post", "adm_shards_get",
    "adm_shards_post", "adm_shards_index_get", "adm_shards_index_post",
    "adm_validate_get", "adm_validate_post", "adm_validate_index_get",
    "adm_validate_index_post", "adm_unblock", "adm_delete_made",
    "adm_knn_batch",
]


BACKUP_LABELS = [
    "bk_put_repo", "bk_post_repo", "bk_put_repo_bad_type",
    "bk_put_repo_no_location", "bk_get_repos", "bk_get_repo",
    "bk_get_repo_missing", "bk_cleanup", "bk_cleanup_missing", "bk_cat_repos",
    "bk_snap_put", "bk_snap_post", "bk_snap_again", "bk_snap_bad_name",
    "bk_snap_missing_index", "bk_snap_get", "bk_snap_get_all",
    "bk_snap_get_pattern", "bk_snap_get_missing", "bk_snap_status",
    "bk_snap_status_missing", "bk_snap_status_ignored", "bk_cat_snaps",
    "bk_cat_snaps_no_repo", "bk_restore_rename", "bk_restore_rename_knn",
    "bk_restore_open", "bk_restore_missing", "bk_close_restored",
    "bk_restore_closed", "bk_restore_closed_knn", "bk_snap_delete",
    "bk_snap_delete_missing", "bk_repo_delete", "bk_repo_delete_missing",
    "bk_rs_repo", "bk_rs_create", "bk_rs_bulk", "bk_rs_sync", "bk_rs_stats",
    "bk_rs_delete", "bk_rs_restore", "bk_rs_restore_none", "bk_rs_knn",
    "bk_copy_create", "bk_reindex", "bk_reindex_same", "bk_reindex_no_dest",
    "bk_reindex_knn", "bk_ubq", "bk_ubq_knn", "bk_dbq", "bk_dbq_no_query",
    "bk_dbq_knn", "bk_rank_eval_post", "bk_rank_eval_get",
    "bk_rank_eval_all_post", "bk_rank_eval_all_get", "bk_rank_eval_bad",
    "bk_delete_made", "bk_cat_repos_end",
]


@pytest.mark.parametrize("label", STEPS + CONTEXT_LABELS + OPS_LABELS
                         + ADMIN_LABELS + BACKUP_LABELS)
def test_response_equals_the_references(transcripts, label):
    (ref_status, ref_body), (port_status, port_body) = transcripts[label]
    assert port_status == ref_status, (port_body, ref_body)
    _assert_same(_strip(ref_body), _strip(port_body))


def test_every_step_is_compared(transcripts):
    assert set(STEPS) | set(CONTEXT_LABELS) | set(OPS_LABELS) \
        | set(ADMIN_LABELS) | set(BACKUP_LABELS) | {"root"} == \
        set(transcripts)
    assert CONTEXT_STEPS == CONTEXT_LABELS
    assert OPS_STEPS == OPS_LABELS
    assert ADMIN_STEPS == ADMIN_LABELS
    assert BACKUP_STEPS == BACKUP_LABELS


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


def _ref_name(ref_handler) -> str:
    """The reference module's name for a handler: its __name__, or for a
    handler a factory made (the resize routes' closures) the module-level
    name bound to it."""
    for name, value in vars(ref_handlers).items():
        if value is ref_handler:
            return name
    return ref_handler.__name__


@pytest.mark.parametrize("method,template,name", REF_ROUTES,
                         ids=[f"{m} {t}" for m, t, _n in REF_ROUTES])
def test_every_reference_route_resolves_in_the_port(method, template, name):
    path = _concrete(template)
    ref_handler, ref_params = REF_ROUTER.resolve(method, path)
    handler, params = PORT_ROUTER.resolve(method, path)
    assert params == ref_params
    # a ported handler: the sequences above compare its answers
    assert getattr(port_handlers, _ref_name(ref_handler)) is handler


def test_unported_routes_answer_the_500_envelope_and_keep_the_connection(
        tmp_path):
    """The control plane's routes, once the unported ones: each resolves
    to the port handler named after the reference's and answers the
    reference's 200 on one kept-alive connection, which then still serves
    a search."""
    node = TorchNode(tmp_path, device="cpu")
    srv = HttpServer(node, "127.0.0.1", 0)
    srv.start_in_thread()
    try:
        c = Client(srv.port)
        c("PUT", "/v", {"mappings": {"properties": {
            "v": {"type": "knn_vector", "dimension": 2}}}})
        c("PUT", "/v/_doc/1?refresh=true", {"v": [1.0, 0.0]})
        for method, path, body in (
                ("GET", "/_cat/recovery", None),
                ("GET", "/_cluster/state", None),
                ("GET", "/v/_recovery", None),
                ("GET", "/_cluster/pending_tasks", None),
                ("GET", "/_recovery", None)):
            ref_handler, _ = REF_ROUTER.resolve(method, path)
            handler, _ = PORT_ROUTER.resolve(method, path)
            assert getattr(port_handlers, _ref_name(ref_handler)) is handler
            status, payload = c(method, path, body)
            assert status == 200, (path, payload)
            if path == "/_cluster/state":
                assert payload["routing_table"]["indices"]["v"]["shards"]
            if path.endswith("_recovery"):
                assert payload["v"]["shards"][0]["stage"] == "DONE"
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
    assert not hasattr(port_handlers, "UNPORTED_ROUTES")
    _assert_served("GET", "/_cluster/pending_tasks")
    _assert_served("GET", "/_cat/pending_tasks")
    for method, template in CONTEXT_ROUTES:
        ref_handler, _ = REF_ROUTER.resolve(method, _concrete(template))
        handler, _ = PORT_ROUTER.resolve(method, _concrete(template))
        assert getattr(port_handlers, ref_handler.__name__) is handler


# the 67 routes of the ingest, templates and stats slice: each resolves
# to a ported handler (the `ops_` steps above compare its answers)
OPS_ROUTES = (
    ("PUT", "/_ingest/pipeline/{id}"), ("GET", "/_ingest/pipeline"),
    ("GET", "/_ingest/pipeline/{id}"), ("DELETE", "/_ingest/pipeline/{id}"),
    ("POST", "/_ingest/pipeline/{id}/_simulate"),
    ("GET", "/_ingest/pipeline/{id}/_simulate"),
    ("POST", "/_ingest/pipeline/_simulate"),
    ("GET", "/_ingest/pipeline/_simulate"),
    ("PUT", "/_template/{name}"), ("POST", "/_template/{name}"),
    ("GET", "/_template"), ("GET", "/_template/{name}"),
    ("HEAD", "/_template/{name}"), ("DELETE", "/_template/{name}"),
    ("PUT", "/_index_template/{name}"), ("POST", "/_index_template/{name}"),
    ("GET", "/_index_template"), ("GET", "/_index_template/{name}"),
    ("DELETE", "/_index_template/{name}"),
    ("PUT", "/_component_template/{name}"),
    ("POST", "/_component_template/{name}"),
    ("GET", "/_component_template"), ("GET", "/_component_template/{name}"),
    ("DELETE", "/_component_template/{name}"),
    ("GET", "/_segments"), ("GET", "/{index}/_segments"),
    ("GET", "/_prometheus/metrics"), ("GET", "/_cluster/stats"),
    ("GET", "/_stats"), ("GET", "/_stats/{metric}"),
    ("GET", "/{index}/_stats"), ("GET", "/{index}/_stats/{metric}"),
    ("GET", "/_nodes"), ("GET", "/_nodes/stats"),
    ("GET", "/_nodes/{node_id}/stats"), ("GET", "/_nodes/stats/{metric}"),
    ("GET", "/_nodes/stats/{metric}/{index_metric}"),
    ("GET", "/_nodes/{node_id}/stats/{metric}"),
    ("GET", "/_nodes/{node_id}/stats/{metric}/{index_metric}"),
    ("GET", "/_nodes/{node_id}"), ("GET", "/_nodes/{node_id}/{metric}"),
    ("GET", "/_cat"), ("GET", "/_cat/indices"),
    ("GET", "/_cat/indices/{index}"), ("GET", "/_cat/health"),
    ("GET", "/_cat/shards"), ("GET", "/_cat/shards/{index}"),
    ("GET", "/_cat/count"), ("GET", "/_cat/count/{index}"),
    ("GET", "/_cat/aliases"), ("GET", "/_cat/aliases/{name}"),
    ("GET", "/_cat/allocation"), ("GET", "/_cat/allocation/{node_id}"),
    ("GET", "/_cat/nodes"), ("GET", "/_cat/master"),
    ("GET", "/_cat/cluster_manager"), ("GET", "/_cat/nodeattrs"),
    ("GET", "/_cat/plugins"), ("GET", "/_cat/templates"),
    ("GET", "/_cat/templates/{name}"), ("GET", "/_cat/thread_pool"),
    ("GET", "/_cat/thread_pool/{pattern}"), ("GET", "/_cat/segments"),
    ("GET", "/_cat/segments/{index}"), ("GET", "/_cat/tasks"),
    ("GET", "/_cat/fielddata"), ("GET", "/_cat/fielddata/{fields}"),
)


def test_ops_routes_are_served():
    """The slice's 67 routes, each resolving to the port handler named
    after the reference's; so do the `_cat` tables of the control plane."""
    assert len(OPS_ROUTES) == len(set(OPS_ROUTES)) == 67
    for route in (("GET", "/_cat/recovery"), ("GET", "/_cat/pending_tasks"),
                  ("GET", "/_cat/recovery/{index}"),
                  ("GET", "/_cluster/pending_tasks")):
        _assert_served(*route)
    for method, template in OPS_ROUTES:
        ref_handler, _ = REF_ROUTER.resolve(method, _concrete(template))
        handler, _ = PORT_ROUTER.resolve(method, _concrete(template))
        assert getattr(port_handlers, ref_handler.__name__) is handler


def test_ops_steps_are_not_vacuous(transcripts):
    """The ingest, template and stats steps answered what they should."""
    def port(label):
        return transcripts[label][1]

    assert port("ops_ing_get_doc")[1]["_source"]["color_up"] == \
        port("ops_ing_get_doc")[1]["_source"]["color"].upper()
    bulk = port("ops_ing_bulk")[1]["items"]
    assert [i["index"]["result"] for i in bulk] == ["created", "created",
                                                    "noop"]
    assert port("ops_ing_get_bulk_doc")[1]["_source"]["ingested"] == "yes"
    mapping = port("ops_tpl_get_index")[1]["logs-1"]["mappings"]
    assert set(mapping["properties"]) == {"v", "tag"}
    assert port("ops_tpl_get_index")[1]["logs-1"]["aliases"] == {
        "all-logs": {}}
    assert port("ops_tpl_search_alias")[1]["hits"]["hits"]
    assert port("ops_leg_get_index")[1]["old-1"]["aliases"] == {
        "olds": {"index_routing": "1", "search_routing": "1"}}
    assert port("ops_stats")[1]["_all"]["primaries"]["docs"]["count"] > 0
    assert "opensearch_tpu_search_total" in port("ops_prometheus")[1]
    assert "vecs" in port("ops_cat_indices")[1]
    assert port("ops_get_made")[0] == 404


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


# the 49 routes of the index-management and document-reads slice: each
# resolves to a ported handler (the `adm_` steps above compare its answers)
ADMIN_ROUTES = (
    ("GET", "/_mapping/field/{fields}"),
    ("GET", "/{index}/_mapping/field/{fields}"),
    ("PUT", "/{index}/_mapping"), ("POST", "/{index}/_mapping"),
    ("PUT", "/{index}/_settings"), ("PUT", "/_settings"),
    ("PUT", "/{index}/_block/{block}"),
    ("POST", "/_upgrade"), ("POST", "/{index}/_upgrade"),
    ("GET", "/_upgrade"), ("GET", "/{index}/_upgrade"),
    ("PUT", "/{index}/_shrink/{target}"),
    ("POST", "/{index}/_shrink/{target}"),
    ("PUT", "/{index}/_split/{target}"), ("POST", "/{index}/_split/{target}"),
    ("PUT", "/{index}/_clone/{target}"), ("POST", "/{index}/_clone/{target}"),
    ("POST", "/{index}/_rollover"), ("POST", "/{index}/_rollover/{new_index}"),
    ("POST", "/{index}/_close"), ("POST", "/{index}/_open"),
    ("GET", "/{index}/_analyze"), ("POST", "/{index}/_analyze"),
    ("GET", "/_analyze"), ("POST", "/_analyze"),
    ("GET", "/_mget"), ("POST", "/_mget"), ("GET", "/{index}/_mget"),
    ("POST", "/{index}/_mget"),
    ("GET", "/{index}/_explain/{id}"), ("POST", "/{index}/_explain/{id}"),
    ("GET", "/_field_caps"), ("POST", "/_field_caps"),
    ("GET", "/{index}/_field_caps"), ("POST", "/{index}/_field_caps"),
    ("GET", "/{index}/_termvectors/{id}"),
    ("POST", "/{index}/_termvectors/{id}"),
    ("GET", "/_mtermvectors"), ("POST", "/_mtermvectors"),
    ("GET", "/{index}/_mtermvectors"), ("POST", "/{index}/_mtermvectors"),
    ("GET", "/_search_shards"), ("POST", "/_search_shards"),
    ("GET", "/{index}/_search_shards"), ("POST", "/{index}/_search_shards"),
    ("GET", "/_validate/query"), ("POST", "/_validate/query"),
    ("GET", "/{index}/_validate/query"), ("POST", "/{index}/_validate/query"),
)


def test_admin_routes_are_served():
    """The slice's 49 routes, each resolving to the port handler named
    after the reference's; so do the control plane's shard and state
    routes."""
    assert len(ADMIN_ROUTES) == len(set(ADMIN_ROUTES)) == 49
    for route in (("GET", "/_recovery"), ("GET", "/_shard_stores"),
                  ("GET", "/_remote/info"), ("GET", "/_cluster/state")):
        _assert_served(*route)
    for method, template in ADMIN_ROUTES:
        ref_handler, _ = REF_ROUTER.resolve(method, _concrete(template))
        handler, _ = PORT_ROUTER.resolve(method, _concrete(template))
        assert getattr(port_handlers, _ref_name(ref_handler)) is handler


def test_admin_steps_are_not_vacuous(transcripts):
    """The index-management and document-read steps answered what they
    should, and the batcher merged the stacked step's launches."""
    def port(label):
        return transcripts[label][1]

    assert list(port("adm_put_mapping")) == [200, {"acknowledged": True}]
    # the kNN on v2 reaches only the docs written after the update
    v2_hits = [h["_id"] for h in port("adm_knn_v2")[1]["hits"]["hits"]]
    # (k = 3 a shard, two shards)
    assert v2_hits[0] == "w2" and 3 <= len(v2_hits) <= 6
    assert all(i.startswith("w") for i in v2_hits)
    assert not any(h["_id"].startswith("w") for h in
                   port("adm_knn_v")[1]["hits"]["hits"])
    assert port("adm_block_write")[1]["error"]["type"] == \
        "cluster_block_exception"
    assert port("adm_block_knn")[1]["hits"]["hits"]
    assert port("adm_split_knn")[1]["hits"]["hits"] and \
        [h["_id"] for h in port("adm_split_knn")[1]["hits"]["hits"]] == \
        [h["_id"] for h in port("adm_knn_v")[1]["hits"]["hits"]]
    assert port("adm_close_search")[1]["error"]["type"] == \
        "index_closed_exception"
    assert "close vclone" in port("adm_close_cat")[1]
    assert port("adm_rollover")[1]["rolled_over"] is True
    assert port("adm_rollover_named")[1]["new_index"] == "r-custom"
    assert port("adm_mget_get")[1]["docs"][0]["found"] is True
    assert port("adm_explain_post")[1]["matched"] is True
    assert "knn_vector" in str(port("adm_caps_get")[1]) or \
        "dense_vector" in str(port("adm_caps_get")[1])
    assert port("adm_validate_index_post")[1]["valid"] is True
    assert len(port("adm_shards_index_post")[1]["shards"]) == 1
    batch = port("adm_knn_batch")[1]["nodes"]["node-0"]["knn_batch"]
    assert batch["cross_shard_launches"] > 0
    assert "('distributed_knn', 'vecs', 'v', 5)" in batch["auto_tune"]["keys"]


BACKUP_ROUTES = (
    ("PUT", "/_snapshot/{repo}"), ("POST", "/_snapshot/{repo}"),
    ("GET", "/_snapshot"), ("GET", "/_snapshot/{repo}"),
    ("DELETE", "/_snapshot/{repo}"), ("POST", "/_snapshot/{repo}/_cleanup"),
    ("PUT", "/_snapshot/{repo}/{snapshot}"),
    ("POST", "/_snapshot/{repo}/{snapshot}"),
    ("GET", "/_snapshot/{repo}/{snapshot}"),
    ("DELETE", "/_snapshot/{repo}/{snapshot}"),
    ("POST", "/_snapshot/{repo}/{snapshot}/_restore"),
    ("GET", "/_snapshot/{repo}/{snapshot}/_status"),
    ("GET", "/{index}/_rank_eval"), ("POST", "/{index}/_rank_eval"),
    ("GET", "/_rank_eval"), ("POST", "/_rank_eval"),
    ("POST", "/_reindex"), ("POST", "/{index}/_update_by_query"),
    ("POST", "/{index}/_delete_by_query"),
    ("POST", "/_remotestore/_restore"),
    ("POST", "/{index}/_remotestore/_sync"),
    ("GET", "/_remotestore/stats/{index}"),
    ("GET", "/_cat/repositories"), ("GET", "/_cat/snapshots"),
    ("GET", "/_cat/snapshots/{repo}"),
)

# the control plane's routes: the only ones left unported
CONTROL_PLANE_ROUTES = (
    ("GET", "/_shard_stores"), ("GET", "/{index}/_shard_stores"),
    ("GET", "/_recovery"), ("GET", "/{index}/_recovery"),
    ("GET", "/_cluster/state"), ("GET", "/_cluster/state/{metric}"),
    ("GET", "/_cluster/state/{metric}/{index}"),
    ("GET", "/_cluster/pending_tasks"),
    ("POST", "/_cluster/voting_config_exclusions"),
    ("DELETE", "/_cluster/voting_config_exclusions"),
    ("POST", "/_cluster/reroute"),
    ("GET", "/_cluster/allocation/explain"),
    ("POST", "/_cluster/allocation/explain"),
    ("GET", "/_remote/info"),
    ("GET", "/_cat/recovery"), ("GET", "/_cat/recovery/{index}"),
    ("GET", "/_cat/pending_tasks"),
)


def _assert_served(method: str, template: str) -> None:
    """The route resolves to the port handler named after the
    reference's."""
    ref_handler, _ = REF_ROUTER.resolve(method, _concrete(template))
    handler, _ = PORT_ROUTER.resolve(method, _concrete(template))
    assert getattr(port_handlers, _ref_name(ref_handler)) is handler


def test_backup_routes_are_served():
    """The slice's 25 routes and the control plane's 17, each resolving to
    the port handler named after the reference's."""
    assert len(BACKUP_ROUTES) == len(set(BACKUP_ROUTES)) == 25
    assert len(CONTROL_PLANE_ROUTES) == len(set(CONTROL_PLANE_ROUTES)) == 17
    assert not hasattr(port_handlers, "UNPORTED_ROUTES")
    for route in CONTROL_PLANE_ROUTES:
        _assert_served(*route)
    for method, template in BACKUP_ROUTES:
        ref_handler, _ = REF_ROUTER.resolve(method, _concrete(template))
        handler, _ = PORT_ROUTER.resolve(method, _concrete(template))
        assert getattr(port_handlers, _ref_name(ref_handler)) is handler


def test_backup_steps_are_not_vacuous(transcripts):
    """The snapshot, remote-store, reindex and rank-eval steps answered
    what they should: each kNN after a restore, a reindex or a by-query
    write found hits, and no deleted doc came back."""
    def port(label):
        return transcripts[label][1]

    assert port("bk_snap_put")[1]["snapshot"]["state"] == "SUCCESS"
    assert port("bk_snap_again")[0] == 400
    assert port("bk_restore_rename")[1]["snapshot"]["indices"] == [
        "restored-ecs"]
    assert port("bk_restore_open")[0] == 400
    assert port("bk_restore_closed")[0] == 200
    for label in ("bk_restore_rename_knn", "bk_restore_closed_knn",
                  "bk_rs_knn", "bk_reindex_knn", "bk_ubq_knn",
                  "bk_dbq_knn"):
        status, body = port(label)
        assert status == 200 and len(body["hits"]["hits"]) == 6, label
    assert port("bk_rs_restore")[1] == {"accepted": True,
                                        "indices": ["vrs"]}
    reindexed = port("bk_reindex")[1]
    assert reindexed["created"] == reindexed["total"] > 20
    assert reindexed["batches"] > 1
    picked = port("bk_ubq")[1]["updated"]
    assert picked > 0 and port("bk_dbq")[1]["deleted"] == picked
    assert {h["_source"]["color"] for h in
            port("bk_ubq_knn")[1]["hits"]["hits"]} == {"picked"}
    assert "picked" not in {h["_source"]["color"] for h in
                            port("bk_dbq_knn")[1]["hits"]["hits"]}
    assert port("bk_rank_eval_post")[1]["metric_score"] > 0
    assert port("bk_rank_eval_bad")[0] == 400
