"""Ingest pipelines on the port against the reference.

Every processor case of tests/test_ingest.py runs through both packages'
`build_processor` on the same source, and each pipeline, simulate and
node case through an IngestService or a TpuNode and a
TorchNode(device="cpu") taking the same calls: the results (the source
and metadata, or an error's class, status and message) must be equal as
JSON, with `took`, index uuids and `_ingest.timestamp` (the clock at the
pipeline's run) left out. Then the writes: `default_pipeline`,
`final_pipeline`, an `_index` and a `_routing` reroute with `refresh=true`
touching the shards the documents landed on, `drop` leaving no live hole
(`docs.count` and `_count` agree), and a kNN over a pipeline-fed index
(vectors parsed from strings by `json`, views converted) whose hits are
its twin's bit for bit, the twin fed the same documents without a
pipeline. Last, the `ingest` section of `_nodes/stats`, which the port
keeps per pipeline and processor.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.ingest import IngestDocument as RefDocument
from opensearch_tpu.ingest import IngestService as RefService
from opensearch_tpu.ingest.processors import build_processor as ref_build
from opensearch_tpu_torch.ingest import IngestDocument, IngestService
from opensearch_tpu_torch.ingest.processors import build_processor

from test_torch_rest import _assert_same
from test_torch_scroll_pit import Pair, observe, strip_contexts


def _run(build, document, definition, source, index="idx", doc_id="1"):
    doc = document(index, doc_id, json.loads(json.dumps(source)))
    build(definition).run(doc)
    return {"source": doc.source, "meta": doc.meta}


# (definition, source) of every processor case of tests/test_ingest.py
PROC_CASES = [
    ({"set": {"field": "a.b", "value": 5}}, {}),
    ({"set": {"field": "greet", "value": "hi {{name}}"}}, {"name": "bob"}),
    ({"append": {"field": "tags", "value": ["x", "y"]}}, {"tags": "a"}),
    ({"remove": {"field": "a"}}, {"a": 1, "b": 2}),
    ({"rename": {"field": "a", "target_field": "z.w"}}, {"a": 1}),
    ({"convert": {"field": "n", "type": "integer"}}, {"n": "42"}),
    ({"convert": {"field": "b", "type": "boolean"}}, {"b": "true"}),
    ({"convert": {"field": "x", "type": "auto"}}, {"x": "3.5"}),
    ({"convert": {"field": "v", "type": "float"}}, {"v": ["0.5", "1.25"]}),
    ({"lowercase": {"field": "s"}}, {"s": "ABC"}),
    ({"uppercase": {"field": "s", "target_field": "t"}}, {"s": "abc"}),
    ({"trim": {"field": "s"}}, {"s": "  x  "}),
    ({"gsub": {"field": "s", "pattern": r"\.", "replacement": "-"}},
     {"s": "1.2.3"}),
    ({"split": {"field": "s", "separator": ","}}, {"s": "a,b,c"}),
    ({"join": {"field": "s", "separator": "-"}}, {"s": ["a", "b"]}),
    ({"html_strip": {"field": "s"}}, {"s": "<b>hi</b> &amp; bye"}),
    ({"bytes": {"field": "s"}}, {"s": "2kb"}),
    ({"urldecode": {"field": "s"}}, {"s": "a%20b"}),
    ({"kv": {"field": "msg", "field_split": " ", "value_split": "="}},
     {"msg": "ip=1.2.3.4 error=REFUSED"}),
    ({"json": {"field": "raw", "target_field": "parsed"}},
     {"raw": '{"a": 1}'}),
    ({"json": {"field": "vs", "target_field": "v"}},
     {"vs": "[0.1, -2.5, 3e-3]"}),
    ({"csv": {"field": "row", "target_fields": ["a", "b", "c"]}},
     {"row": 'x,"y,z",w'}),
    ({"date": {"field": "t", "formats": ["UNIX_MS"]}},
     {"t": "1704067200000"}),
    ({"date": {"field": "t", "formats": ["yyyy/MM/dd"]}}, {"t": "2024/02/03"}),
    ({"date_index_name": {"field": "t", "index_name_prefix": "logs-",
                          "date_rounding": "M",
                          "date_formats": ["ISO8601"]}},
     {"t": "2024-03-15T10:00:00Z"}),
    ({"grok": {"field": "message",
               "patterns": ["%{IP:client} %{WORD:method} %{URIPATH:path} "
                            "%{NUMBER:bytes:int}"]}},
     {"message": "55.3.244.1 GET /index.html 15824"}),
    ({"grok": {"field": "m", "patterns": ["%{ID:id}"],
               "pattern_definitions": {"ID": r"[A-Z]{2}\d{4}"}}},
     {"m": "ref AB1234 done"}),
    ({"grok": {"field": "m", "patterns": ["%{IP:ip}"]}}, {"m": "no ip here"}),
    ({"dissect": {"field": "message",
                  "pattern": "%{clientip} %{ident} %{auth} [%{timestamp}]"}},
     {"message": "1.2.3.4 - admin [30/Apr/1998:22:00:52 +0000]"}),
    ({"uri_parts": {"field": "u"}},
     {"u": "https://user:pw@example.com:8080/a/b.txt?q=1#frag"}),
    ({"user_agent": {"field": "ua"}},
     {"ua": "Mozilla/5.0 (Windows NT 10.0) Chrome/120.0.0.0 Safari/537.36"}),
    ({"foreach": {"field": "vals",
                  "processor": {"uppercase": {"field": "_ingest._value"}}}},
     {"vals": ["a", "b"]}),
    ({"sort": {"field": "v", "order": "desc"}}, {"v": [1, 3, 2]}),
    ({"script": {"source": "ctx.total = ctx.a + ctx.b"}}, {"a": 2, "b": 3}),
    ({"script": {"source": "ctx.score = ctx.views * params.w",
                 "params": {"w": 0.5}}}, {"views": 7}),
    ({"fingerprint": {"fields": ["a", "b"]}}, {"a": 1, "b": 2}),
    ({"fingerprint": {"fields": ["b", "a"]}}, {"b": 2, "a": 1}),
    ({"dot_expander": {"field": "a.b"}}, {"a.b": 5}),
    ({"set": {"field": "x", "value": 1, "if": "ctx.kind == 'a'"}},
     {"kind": "b"}),
    ({"fail": {"message": "boom",
               "on_failure": [{"set": {"field": "err",
                                       "value": "handled"}}]}}, {}),
    ({"fail": {"message": "boom", "ignore_failure": True}}, {}),
    ({"fail": {"message": "boom"}}, {}),
    ({"nope": {}}, {}),
]


@pytest.mark.parametrize("definition,source", PROC_CASES,
                         ids=[f"{i}-{next(iter(d))}"
                              for i, (d, _s) in enumerate(PROC_CASES)])
def test_processor_is_the_references(definition, source):
    ref = observe(lambda: _run(ref_build, RefDocument, definition, source))
    port = observe(lambda: _run(build_processor, IngestDocument, definition,
                                source))
    assert port == ref


def _services(tmp_path):
    return (RefService(tmp_path / "ref.json"),
            IngestService(tmp_path / "port.json"))


def _both(tmp_path, scenario):
    ref, port = _services(tmp_path)
    a, b = scenario(ref), scenario(port)
    _assert_same(_no_clock(a), _no_clock(b))
    return b


def _no_clock(obj):
    if isinstance(obj, dict):
        return {k: (_no_clock({x: y for x, y in v.items() if x != "timestamp"})
                    if k == "_ingest" and isinstance(v, dict) else _no_clock(v))
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_no_clock(v) for v in obj]
    return obj


def test_pipeline_crud_execute_and_persistence(tmp_path):
    def scenario(svc):
        out = [svc.put_pipeline("p1", {"processors": [
            {"set": {"field": "via", "value": "p1"}}]}),
            svc.get_pipeline("p1"), svc.get_pipeline(None),
            observe(lambda: svc.put_pipeline("bad", {"processors": [
                {"set": {}}]})),
            observe(lambda: svc.get_pipeline("nope"))]
        again = type(svc)(svc.state_file)
        out.append(again.execute("p1", "idx", "1", {"a": 1}).source)
        out.append(again.delete_pipeline("p1"))
        out.append(observe(lambda: again.get_pipeline("p1")))
        out.append(observe(lambda: again.delete_pipeline("p1")))
        out.append(observe(lambda: again.execute("p1", "i", "1", {})))
        return out

    out = _both(tmp_path, scenario)
    assert out[5] == {"a": 1, "via": "p1"}


def test_nested_pipeline_and_drop(tmp_path):
    def scenario(svc):
        svc.put_pipeline("inner", {"processors": [
            {"set": {"field": "inner", "value": True}}]})
        svc.put_pipeline("outer", {"processors": [
            {"pipeline": {"name": "inner"}},
            {"drop": {"if": "ctx.skip == true"}}]})
        kept = svc.execute("outer", "idx", "1", {"skip": False})
        return [kept.source, kept.meta,
                svc.execute("outer", "idx", "2", {"skip": True})]

    assert _both(tmp_path, scenario)[2] is None


@pytest.mark.parametrize("verbose", [False, True])
def test_simulate(tmp_path, verbose):
    body = {"pipeline": {"processors": [
        {"set": {"field": "x", "value": 1}},
        {"fail": {"message": "stop", "if": "ctx.bad == true"}},
        {"drop": {"if": "ctx.gone == true"}}]},
        "docs": [{"_index": "i", "_id": "1", "_source": {"bad": False}},
                 {"_index": "i", "_id": "2", "_source": {"bad": True}},
                 {"_source": {"gone": True}}]}

    def scenario(svc):
        svc.put_pipeline("stored", body["pipeline"])
        return [svc.simulate(body, verbose=verbose),
                svc.simulate({"docs": body["docs"]}, pipeline_id="stored",
                             verbose=verbose),
                observe(lambda: svc.simulate({"docs": []})),
                observe(lambda: svc.simulate({}, pipeline_id="nope"))]

    _both(tmp_path, scenario)


# -- the node's writes -------------------------------------------------------


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def test_default_pipeline_none_redirect_and_drop(pair):
    def scenario(node):
        node.ingest.put_pipeline("stamp", {"processors": [
            {"set": {"field": "stamped", "value": True}}]})
        node.create_index("logs", {"settings": {
            "number_of_shards": 1, "index": {"default_pipeline": "stamp"}}})
        out = [node.index_doc("logs", "1", {"m": "hello"}),
               node.index_doc("logs", "2", {"m": "raw"}, pipeline="_none")]
        node.ingest.put_pipeline("redirect", {"processors": [
            {"date_index_name": {"field": "t", "index_name_prefix": "logs-",
                                 "date_rounding": "M",
                                 "date_formats": ["ISO8601"]}}]})
        out.append(node.index_doc("logs", "3", {"t": "2024-03-15T10:00:00Z"},
                                  pipeline="redirect"))
        node.ingest.put_pipeline("dropper", {"processors": [{"drop": {}}]})
        out.append(node.index_doc("logs", "4", {"m": "x"},
                                  pipeline="dropper"))
        out.append(observe(lambda: node.index_doc("logs", "5", {"m": "y"},
                                                  pipeline="nope")))
        node.refresh("_all")
        out += [node.get_doc("logs", "1"), node.get_doc("logs", "2"),
                node.get_doc("logs-2024-03", "3"), node.get_doc("logs", "4"),
                sorted(node.indices)]
        # an update goes through the index's default pipeline, as the
        # reference's update_doc does
        out.append(node.update_doc("logs", "2", {"doc": {"m": "raw2"}}))
        out.append(node.get_doc("logs", "2"))
        return out

    out = pair.flow(scenario)
    assert out[5]["_source"]["stamped"] is True
    assert "stamped" not in out[6]["_source"]
    assert out[2]["_index"] == "logs-2024-03" and out[7]["found"]
    assert out[3]["result"] == "noop" and not out[8]["found"]
    assert out[4][:2] == ("error", "IllegalArgumentException")
    assert out[11]["_source"]["stamped"] is True


def test_final_pipeline_runs_on_the_landing_index(pair):
    """final_pipeline runs after the request or default pipeline, and it
    is the LANDING index's after an `_index` reroute."""
    def scenario(node):
        node.ingest.put_pipeline("first", {"processors": [
            {"set": {"field": "order", "value": "first"}}]})
        node.ingest.put_pipeline("last", {"processors": [
            {"append": {"field": "trail", "value": "{{_index}}"}}]})
        node.ingest.put_pipeline("move", {"processors": [
            {"set": {"field": "_index", "value": "dest"}}]})
        node.create_index("src", {"settings": {"index": {
            "default_pipeline": "first", "final_pipeline": "last"}}})
        node.create_index("dest", {"settings": {"index": {
            "final_pipeline": "last"}}})
        out = [node.index_doc("src", "1", {"a": 1}),
               node.index_doc("src", "2", {"a": 2}, pipeline="move"),
               node.index_doc("src", "3", {"a": 3},
                              pipeline="_none")]
        node.refresh("_all")
        return out + [node.get_doc("src", "1"), node.get_doc("dest", "2"),
                      node.get_doc("src", "3")]

    out = pair.flow(scenario)
    assert out[3]["_source"] == {"a": 1, "order": "first", "trail": ["src"]}
    assert out[4]["_source"] == {"a": 2, "trail": ["dest"]}
    assert out[5]["_source"] == {"a": 3, "trail": ["src"]}


def test_bulk_reroutes_refresh_the_landing_shards(pair):
    """A per-item pipeline over the request's, `_index` and `_routing`
    rewritten by the pipeline: `refresh=true` makes every landed document
    searchable on the shard it landed on."""
    def scenario(node):
        node.ingest.put_pipeline("tagit", {"processors": [
            {"set": {"field": "tagged", "value": True}}]})
        node.ingest.put_pipeline("route", {"processors": [
            {"set": {"field": "_index", "value": "routed"}},
            {"set": {"field": "_routing", "value": "{{user}}"}}]})
        node.create_index("routed", {"settings": {"number_of_shards": 3}})
        out = node.bulk([
            ("index", {"_index": "b", "_id": "1"}, {"v": 1}),
            ("index", {"_index": "b", "_id": "2", "pipeline": "_none"},
             {"v": 2}),
            ("index", {"_index": "b", "_id": "3", "pipeline": "route"},
             {"v": 3, "user": "u7"}),
            ("create", {"_index": "b", "_id": "4", "pipeline": "route"},
             {"v": 4, "user": "u9"}),
            ("index", {"_index": "b", "_id": "5", "pipeline": "nope"},
             {"v": 5})], refresh=True, pipeline="tagit")
        return [out, node.count("b"), node.count("routed"),
                node.search("routed", {"query": {"match_all": {}},
                                       "sort": ["v"]}),
                node.get_doc("routed", "3", routing="u7")]

    out = pair.flow(scenario)
    assert out[0]["errors"] and out[1]["count"] == 2
    assert out[2]["count"] == 2
    assert [h["_routing"] for h in out[3]["hits"]["hits"]] == ["u7", "u9"]


def test_on_failure_and_script_processor_on_writes(pair):
    def scenario(node):
        node.ingest.put_pipeline("p", {"processors": [
            {"convert": {"field": "views", "type": "long"}},
            {"script": {"source": "ctx.double = ctx.views * 2"}}],
            "on_failure": [{"set": {"field": "error",
                                    "value": "{{_ingest.on_failure_message}}"}},
                           {"remove": {"field": "views"}}]})
        out = [node.index_doc("w", "1", {"views": "21"}, pipeline="p"),
               node.index_doc("w", "2", {"views": "many"}, pipeline="p")]
        node.refresh("w")
        return out + [node.get_doc("w", "1"), node.get_doc("w", "2")]

    out = pair.flow(scenario)
    assert out[2]["_source"] == {"views": 21, "double": 42}
    assert "error" in out[3]["_source"]


# -- a kNN over a pipeline-fed index against its twin ------------------------

DIM = 16
N = 300


def _feed(node, rng_seed=5):
    rng = np.random.default_rng(rng_seed)
    vecs = rng.standard_normal((N, DIM)).astype(np.float32)
    tags = np.where(rng.random(N) < 0.05, "spam", "ham")
    mapping = {"properties": {
        "v": {"type": "knn_vector", "dimension": DIM,
              "similarity": "l2_norm"},
        "tag": {"type": "keyword"}, "views": {"type": "long"}}}
    node.ingest.put_pipeline("vec-in", {"processors": [
        {"json": {"field": "v_json", "target_field": "v"}},
        {"remove": {"field": "v_json"}},
        {"convert": {"field": "views", "type": "long"}},
        {"drop": {"if": "ctx.tag == 'spam'"}}]})
    node.create_index("fed", {"settings": {
        "number_of_shards": 2, "index": {"default_pipeline": "vec-in"}},
        "mappings": mapping})
    node.create_index("twin", {"settings": {"number_of_shards": 2},
                               "mappings": mapping})
    raw = [{"v_json": json.dumps(vecs[i].tolist()), "tag": str(tags[i]),
            "views": str(i)} for i in range(N)]
    plain = [{"v": vecs[i].tolist(), "tag": str(tags[i]), "views": i}
             for i in range(N)]
    fed = node.bulk([("index", {"_index": "fed", "_id": str(i)}, raw[i])
                     for i in range(N)], refresh=True)
    node.bulk([("index", {"_index": "twin", "_id": str(i)}, plain[i])
               for i in range(N)], refresh=True)
    return vecs, tags, fed


def test_knn_over_the_pipeline_fed_index_holds_the_twins_hits(pair):
    def scenario(node):
        vecs, tags, fed = _feed(node)
        qs = np.random.default_rng(9).standard_normal((6, DIM)).astype(
            np.float32)
        out = [sum(1 for i in fed["items"]
                   if i["index"]["result"] == "noop"),
               node.count("fed")["count"],
               node.index_stats("fed")["_all"]["primaries"]["docs"]]
        for q in qs:
            body = {"size": 10, "query": {"knn": {"v": {
                "vector": q.tolist(), "k": 10}}}}
            twin_body = {"size": 10, "query": {"knn": {"v": {
                "vector": q.tolist(), "k": 10,
                "filter": {"bool": {"must_not": [
                    {"term": {"tag": "spam"}}]}}}}}}
            got = node.search("fed", body)["hits"]["hits"]
            want = node.search("twin", twin_body)["hits"]["hits"]
            out.append([(h["_id"], h["_score"]) for h in got])
            assert [(h["_id"], h["_score"]) for h in got] == \
                [(h["_id"], h["_score"]) for h in want]
        return out

    out = pair.flow(scenario)
    rng = np.random.default_rng(5)
    rng.standard_normal((N, DIM))
    n_spam = int((rng.random(N) < 0.05).sum())
    assert out[0] == n_spam > 0
    assert out[1] == out[2]["count"] == N - n_spam


def test_pipeline_vectors_land_as_the_twins_bits(tmp_path):
    """The vector a `json` processor parsed is the same float32 bits in
    the port's device segment as the twin's, and a dropped doc leaves no
    slot the stacked step scans as live."""
    from opensearch_tpu_torch.node import TorchNode

    node = TorchNode(tmp_path, device="cpu")
    try:
        vecs, tags, _ = _feed(node)
        keep = np.flatnonzero(tags != "spam")

        def slab(index):
            out = {}
            for shard in node.indices[index].shards.values():
                for host, dev in shard.engine._segments:
                    field = dev.vector_fields["v"]
                    live = host.live.copy()
                    for d, doc_id in enumerate(host.doc_ids):
                        if live[d]:
                            out[doc_id] = field.vectors[d].numpy()
                    assert int(host.live.sum()) == len(
                        [i for i in host.doc_ids if i in out])
            return out

        fed, twin = slab("fed"), slab("twin")
        assert sorted(fed, key=int) == [str(i) for i in keep]
        for doc_id, v in fed.items():
            assert v.dtype == np.float32
            assert v.tobytes() == twin[doc_id].tobytes()
            assert v.tobytes() == vecs[int(doc_id)].tobytes()
    finally:
        node.close()


def test_nodes_stats_ingest_section_counts_pipelines_and_processors(tmp_path):
    from opensearch_tpu_torch.node import TorchNode
    from opensearch_tpu_torch.rest import handlers

    node = TorchNode(tmp_path, device="cpu")
    try:
        _vecs, tags, _ = _feed(node)
        status, body = handlers.nodes_stats(
            node, {"metric": "ingest"}, {}, None)
        ingest = body["nodes"]["node-0"]["ingest"]
        n_spam = int((tags == "spam").sum())
        assert status == 200 and set(body["nodes"]["node-0"]) == {
            "name", "roles", "timestamp", "ingest"}
        assert ingest["total"]["count"] == N and \
            ingest["total"]["failed"] == 0 and ingest["total"]["current"] == 0
        pipe = ingest["pipelines"]["vec-in"]
        assert pipe["count"] == N
        assert [next(iter(p)) for p in pipe["processors"]] == [
            "json", "remove", "convert", "drop"]
        assert [p[t]["stats"]["count"] for p in pipe["processors"]
                for t in p] == [N, N, N, N]
        # the drop processor ran on every doc and dropped the spam ones
        assert node.count("fed")["count"] == N - n_spam
        node.ingest.simulate({"docs": [{"_source": {"v_json": "[1]"}}]},
                             pipeline_id="vec-in")
        again = handlers.nodes_stats(node, {"metric": "ingest"}, {}, None)[1]
        assert again["nodes"]["node-0"]["ingest"]["pipelines"]["vec-in"][
            "count"] == N  # _simulate counts nothing
    finally:
        node.close()


def test_ingest_strip_helper_masks_only_the_clock():
    doc = {"_ingest": {"timestamp": "t", "x": 1}, "a": [{"_ingest": {
        "timestamp": "u"}}]}
    assert _no_clock(doc) == {"_ingest": {"x": 1}, "a": [{"_ingest": {}}]}
    assert strip_contexts({"took": 1, "a": 2}) == {"a": 2}
