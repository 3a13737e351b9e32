"""The rest of the query DSL in the port against the JAX reference, on the
CPU: terms_set, distance_feature, rank_feature, the geo queries, slice,
nested, more_like_this, percolate, has_child / has_parent / parent_id and
the hybrid query without a pipeline.

Each body runs through a TpuNode and a TorchNode(device="cpu") built from
the same writes:
- the bodies of tests/test_query_dsl_extended.py (``nested``, the
  ``hybrid`` fallback), of tests/test_templates_geo.py (templates, geo,
  date_nanos, rank_feature) and of tests/test_modules_parity.py's
  more_like_this, percolator and parent-join classes;
- a corpus made from a numpy seed, in one and in three shards, written in
  two refreshes with deletes: a text ``body``, a keyword ``tag``, a date
  ``ts``, a geo_point ``loc`` (city centres with jitter), a rank_feature
  ``pop`` (Zipf), a long ``need`` (1-3, terms_set's per-doc count), an
  8-d ``v`` in eighths, a join field ``qa`` (questions and their routed
  answers) and nested ``comments`` on the answers. Each node runs alone,
  inside a ``bool`` beside a ``match``, and as a ``knn`` filter.

Ids, totals, suggestions and errors (class, status and message) must be
equal; scores agree to rtol 1e-6 (BM25 adds in), hits whose scores tie
within it may swap (tests/test_torch_lexical.assert_same_hits).
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu_torch.node import TorchNode
from test_torch_lexical import RTOL, _word, assert_same_hits

N_DOCS = 240
DELETED = ("7", "64", "150", "201")
CENTRES = ((52.52, 13.405), (48.8566, 2.3522), (40.4168, -3.7038),
           (41.9028, 12.4964), (51.5074, -0.1278), (59.3293, 18.0686))
TS0 = 1_700_000_000_000
DAY = 86_400_000


def answer(ref, port, call):
    """call(node) on both nodes: the responses, or the same error (class
    name, status and message), which is then returned as None."""
    try:
        want = call(ref)
    except Exception as e:  # noqa: BLE001 - the reference's error is the answer
        with pytest.raises(Exception) as got:
            call(port)
        assert type(got.value).__name__ == type(e).__name__
        assert str(got.value) == str(e)
        assert getattr(got.value, "status", None) == getattr(e, "status",
                                                             None)
        return None
    return want, call(port)


def same(ref, port, index, body, **kwargs) -> dict | None:
    """The body's response on both nodes: the same hits (or error), the
    same suggestions and the same aggregations; the port's response."""
    out = answer(ref, port, lambda n: n.search(index, dict(body), **kwargs))
    if out is None:
        return None
    want, got = out
    assert_same_hits(want, got)
    assert got.get("suggest") == want.get("suggest")
    assert got.get("aggregations") == want.get("aggregations")
    return got


def pair(tmp_path_factory, name: str):
    return (TpuNode(tmp_path_factory.mktemp(f"{name}-tpu")),
            TorchNode(tmp_path_factory.mktemp(f"{name}-torch"), device="cpu"))


# -- the seeded corpus ------------------------------------------------------

MAPPINGS = {"properties": {
    "body": {"type": "text"}, "tag": {"type": "keyword"},
    "ts": {"type": "date"}, "loc": {"type": "geo_point"},
    "pop": {"type": "rank_feature"}, "need": {"type": "long"},
    "v": {"type": "knn_vector", "dimension": 8, "similarity": "l2_norm"},
    "qa": {"type": "join", "relations": {"question": "answer"}},
    "comments": {"type": "nested", "properties": {
        "author": {"type": "keyword"}, "stars": {"type": "long"}}}}}


def corpus_ops(index: str, seed: int = 18) -> list:
    """(action, meta, source) of the corpus: every fifth doc a question,
    the rest answers routed to the question before them."""
    rng = np.random.default_rng(seed)
    p = np.arange(1, 61, dtype=np.float64) ** -1.07
    p /= p.sum()
    ops = []
    for i in range(N_DOCS):
        lat, lon = CENTRES[int(rng.integers(0, len(CENTRES)))]
        doc = {
            "body": " ".join(_word(int(w))
                             for w in rng.choice(60, int(rng.integers(3, 12)),
                                                 p=p)),
            "tag": f"t{int(rng.zipf(1.6)) % 6}",
            "ts": int(TS0 + rng.integers(0, 60) * DAY),
            "loc": {"lat": float(np.round(lat + rng.normal(0, 0.05), 6)),
                    "lon": float(np.round(lon + rng.normal(0, 0.05), 6))},
            "pop": float(rng.zipf(1.8)),
            "need": int(rng.integers(1, 4)),
            "v": (np.round(rng.standard_normal(8) * 8) / 8).tolist(),
        }
        meta = {"_index": index, "_id": str(i)}
        if i % 5 == 0:
            doc["qa"] = "question"
        else:
            parent = str(i - i % 5)
            doc["qa"] = {"name": "answer", "parent": parent}
            doc["comments"] = [
                {"author": f"u{int(rng.integers(0, 4))}",
                 "stars": int(rng.integers(1, 6))}
                for _ in range(int(rng.integers(1, 3)))]
            meta["routing"] = parent
        ops.append(("index", meta, doc))
    return ops


def build_corpus(node, index: str, shards: int) -> None:
    node.create_index(index, {"settings": {"number_of_shards": shards},
                              "mappings": MAPPINGS})
    ops = corpus_ops(index)
    half = len(ops) // 2
    node.bulk(ops[:half])
    node.refresh(index)
    deletes = [("delete", {"_index": index, "_id": d,
                           "routing": str(int(d) - int(d) % 5)}, None)
               for d in DELETED]
    node.bulk(ops[half:] + deletes)
    node.refresh(index)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    ref, port = pair(tmp_path_factory, "corpus")
    for node in (ref, port):
        build_corpus(node, "c1", 1)
        build_corpus(node, "c3", 3)
    yield ref, port
    ref.close()
    port.close()


NODES = {
    "geo_distance": {"geo_distance": {"distance": "8km",
                                      "loc": {"lat": 52.52, "lon": 13.405}}},
    "geo_distance_str": {"geo_distance": {"distance": "12000m",
                                          "loc": "48.85,2.35"}},
    "geo_bounding_box": {"geo_bounding_box": {"loc": {
        "top_left": {"lat": 53.0, "lon": 12.0},
        "bottom_right": {"lat": 48.0, "lon": 14.0}}}},
    "geo_shape_envelope": {"geo_shape": {"loc": {"shape": {
        "type": "envelope", "coordinates": [[-1.0, 52.0], [3.0, 48.0]]}}}},
    "geo_shape_disjoint": {"geo_shape": {"loc": {"shape": {
        "type": "envelope", "coordinates": [[-1.0, 52.0], [3.0, 48.0]]},
        "relation": "disjoint"}}},
    "geo_shape_polygon": {"geo_shape": {"loc": {"shape": {
        "type": "polygon", "coordinates": [[[10, 40], [20, 40], [20, 60],
                                            [10, 60], [10, 40]]]}}}},
    "distance_feature_ts": {"distance_feature": {
        "field": "ts", "origin": "2023-12-01T00:00:00Z", "pivot": "7d"}},
    "distance_feature_loc": {"distance_feature": {
        "field": "loc", "origin": {"lat": 51.5, "lon": -0.12},
        "pivot": "300km"}},
    "rank_feature": {"rank_feature": {"field": "pop"}},
    "rank_feature_pivot": {"rank_feature": {
        "field": "pop", "saturation": {"pivot": 3}}},
    "rank_feature_log": {"rank_feature": {
        "field": "pop", "log": {"scaling_factor": 2}}},
    "rank_feature_sigmoid": {"rank_feature": {
        "field": "pop", "sigmoid": {"pivot": 2, "exponent": 0.6}}},
    "rank_feature_linear": {"rank_feature": {"field": "pop", "linear": {}}},
    "terms_set": {"terms_set": {"body": {
        "terms": [_word(0), _word(1), _word(2), _word(3)],
        "minimum_should_match_field": "need"}}},
    "terms_set_script": {"terms_set": {"tag": {
        "terms": ["t1", "t2"],
        "minimum_should_match_script": {"source": "1"}}}},
    "terms_set_num_terms": {"terms_set": {"body": {
        "terms": [_word(0), _word(1)],
        "minimum_should_match_script": {"source": "params.num_terms"}}}},
    "more_like_this": {"more_like_this": {
        "fields": ["body"], "like": f"{_word(2)} {_word(5)} {_word(9)} "
                                    f"{_word(5)} {_word(2)}",
        "min_term_freq": 1, "min_doc_freq": 2}},
    "more_like_this_doc": {"more_like_this": {
        "fields": ["body"], "like": [{"_id": "10"}],
        "min_term_freq": 1, "min_doc_freq": 1}},
    "script": {"script": {"script": {
        "source": "doc['need'].value >= params.n", "params": {"n": 3}}}},
    "nested": {"nested": {"path": "comments", "query": {
        "term": {"comments.author": "u1"}}}},
    "has_child": {"has_child": {"type": "answer", "query": {
        "match": {"body": _word(1)}}}},
    "has_child_min": {"has_child": {"type": "answer", "min_children": 3,
                                    "query": {"match_all": {}}}},
    "has_parent": {"has_parent": {"parent_type": "question", "query": {
        "match": {"body": _word(0)}}}},
    "parent_id": {"parent_id": {"type": "answer", "id": "10"}},
    "hybrid": {"hybrid": {"queries": [{"term": {"tag": "t1"}},
                                      {"match": {"body": _word(3)}}]}},
}


def _form(form: str, node: dict) -> dict:
    if form == "alone":
        return {"query": node, "size": 20}
    if form == "bool":
        return {"query": {"bool": {"must": [{"match": {"body": _word(0)}}],
                                   "should": [node]}}, "size": 20}
    return {"query": {"knn": {"v": {"vector": [0.5, -0.25, 0.125, 1.0, 0.0,
                                               -0.5, 0.25, 0.75],
                                    "k": 7, "filter": node}}}}


@pytest.mark.parametrize("index", ["c1", "c3"])
@pytest.mark.parametrize("form", ["alone", "bool", "knn_filter"])
@pytest.mark.parametrize("name", list(NODES))
def test_corpus_node_matches_reference(corpus, index, form, name):
    ref, port = corpus
    got = same(ref, port, index, _form(form, NODES[name]))
    if form == "alone" and name not in ("geo_shape_polygon",):
        assert got is not None and got["hits"]["total"]["value"] > 0, name


@pytest.mark.parametrize("index", ["c1", "c3"])
@pytest.mark.parametrize("sl_id", [0, 1, 2])
def test_slice_partitions_the_live_docs(corpus, index, sl_id):
    ref, port = corpus
    body = {"query": {"match_all": {}}, "size": 0,
            "slice": {"id": sl_id, "max": 3}}
    same(ref, port, index, body)
    totals = [port.search(index, {**body, "slice": {"id": s, "max": 3}})[
        "hits"]["total"]["value"] for s in range(3)]
    assert sum(totals) == N_DOCS - len(DELETED)


def test_slice_id_out_of_range_is_the_references(corpus):
    ref, port = corpus
    assert same(ref, port, "c1", {"slice": {"id": 3, "max": 3}}) is None


def test_rank_feature_pivot_spans_the_shard(corpus):
    """The default pivot is a float64 mean over every segment of the
    shard: the same score bits on one segment and on two."""
    ref, port = corpus
    got = same(ref, port, "c1", {"query": NODES["rank_feature"],
                                 "size": 300})
    want = ref.search("c1", {"query": NODES["rank_feature"], "size": 300})
    assert [h["_score"] for h in got["hits"]["hits"]] == \
        [h["_score"] for h in want["hits"]["hits"]]


# -- tests/test_query_dsl_extended.py ----------------------------------------

EXT_DOCS = [
    {"id": "1", "title": "the quick brown fox", "tag": "animal", "price": 10},
    {"id": "2", "title": "the lazy brown dog sleeps", "tag": "animal",
     "price": 25},
    {"id": "3", "title": "quick quick quick fox jumps", "tag": "speed",
     "price": 30},
    {"id": "4", "title": "an unrelated essay", "tag": "other", "price": 7},
    {"id": "5", "title": "brown bears eat fish", "tag": "animols",
     "price": 50},
]


@pytest.fixture(scope="module")
def ext(tmp_path_factory):
    ref, port = pair(tmp_path_factory, "ext")
    for node in (ref, port):
        node.create_index("items", {"settings": {"number_of_shards": 2},
                                    "mappings": {"properties": {
                                        "title": {"type": "text"},
                                        "tag": {"type": "keyword"},
                                        "price": {"type": "long"}}}})
        for d in EXT_DOCS:
            doc = dict(d)
            node.index_doc("items", doc.pop("id"), doc)
        node.refresh("items")
    yield ref, port
    ref.close()
    port.close()


@pytest.mark.parametrize("query", [
    {"nested": {"path": "meta", "query": {"term": {"tag": "speed"}}}},
    {"hybrid": {"queries": [{"term": {"tag": "speed"}},
                            {"match": {"title": "essay"}}]}},
    {"bool": {"must": [{"hybrid": {"queries": [
        {"match": {"title": "brown"}}]}}]}},
])
def test_extended_bodies_match_reference(ext, query):
    ref, port = ext
    got = same(ref, port, "items", {"query": query})
    assert got["hits"]["hits"]


# -- tests/test_templates_geo.py ----------------------------------------------


@pytest.fixture()
def geo(tmp_path_factory):
    ref, port = pair(tmp_path_factory, "geo")
    for node in (ref, port):
        node.create_index("places", {"mappings": {"properties": {
            "location": {"type": "geo_point"}}}})
        node.index_doc("places", "berlin",
                       {"location": {"lat": 52.52, "lon": 13.405}})
        node.index_doc("places", "paris", {"location": [2.3522, 48.8566]})
        node.index_doc("places", "sydney",
                       {"location": "-33.8688,151.2093"}, refresh=True)
        node.create_index("logs", {"mappings": {"properties": {
            "level": {"type": "keyword"}}}})
        node.index_doc("logs", "1", {"level": "error"})
        node.index_doc("logs", "2", {"level": "info"}, refresh=True)
        node.create_index("rf", {"mappings": {"properties": {
            "pagerank": {"type": "rank_feature"},
            "features": {"type": "rank_features"},
            "body": {"type": "text"}}}})
        node.index_doc("rf", "1", {"pagerank": 10.0, "body": "hello",
                                   "features": {"politics": 5.0}})
        node.index_doc("rf", "2", {"pagerank": 100.0, "body": "hello"},
                       refresh=True)
        node.create_index("ns", {"mappings": {"properties": {
            "ts": {"type": "date_nanos"}}}})
        node.index_doc("ns", "1", {"ts": "2018-10-29T12:12:12.123456789Z"})
        node.index_doc("ns", "2", {"ts": "2018-10-29T12:12:12.987654321Z"},
                       refresh=True)
    yield ref, port
    ref.close()
    port.close()


@pytest.mark.parametrize("index,query", [
    ("places", {"geo_distance": {"distance": "1000km",
                                 "location": {"lat": 52.52, "lon": 13.405}}}),
    ("places", {"geo_bounding_box": {"location": {
        "top_left": {"lat": 55.0, "lon": 0.0},
        "bottom_right": {"lat": 45.0, "lon": 20.0}}}}),
    ("places", {"geo_bounding_box": {"location": {
        "top_left": [170.0, 0.0], "bottom_right": [160.0, -60.0]}}}),
    ("places", {"distance_feature": {
        "field": "location", "origin": {"lat": 52.0, "lon": 13.0},
        "pivot": "500km"}}),
    ("places", {"geo_distance": {"distance": "10 parsecs",
                                 "location": {"lat": 0, "lon": 0}}}),
    ("places", {"geo_shape": {"location": {"shape": {
        "type": "circle", "coordinates": [0, 0]}}}}),
    ("rf", {"rank_feature": {"field": "pagerank"}}),
    ("rf", {"rank_feature": {"field": "pagerank",
                             "log": {"scaling_factor": 2}}}),
    ("rf", {"rank_feature": {"field": "features.politics"}}),
    ("ns", {"distance_feature": {"field": "ts", "pivot": "1s",
                                 "origin": "2018-10-29T12:12:12.5Z"}}),
])
def test_templates_geo_bodies_match_reference(geo, index, query):
    ref, port = geo
    same(ref, port, index, {"query": query})


def test_search_template_end_to_end(geo):
    ref, port = geo
    body = {"source": {"query": {"term": {"level": "{{lvl}}"}}},
            "params": {"lvl": "error"}}
    want, got = answer(ref, port, lambda n: n.search_template("logs", body))
    assert_same_hits(want, got)
    stored = {"script": {"lang": "mustache", "source":
                         '{"query": {"term": {"level": "{{lvl}}"}}}'}}
    assert answer(ref, port, lambda n: n.put_stored_script(
        "by_level", stored)) == ({"acknowledged": True},) * 2
    want, got = answer(ref, port, lambda n: n.search_template(
        "logs", {"id": "by_level", "params": {"lvl": "info"}}))
    assert_same_hits(want, got)
    assert got["hits"]["total"]["value"] == 1
    want, got = answer(ref, port, lambda n: n.render_search_template(
        {"id": "by_level", "params": {"lvl": "x"}}))
    assert got == want == {"query": {"term": {"level": "x"}}}
    want, got = answer(ref, port, lambda n: n.get_stored_script("by_level"))
    assert got == want and got["found"]
    answer(ref, port, lambda n: n.delete_stored_script("by_level"))
    want, got = answer(ref, port, lambda n: n.get_stored_script("by_level"))
    assert got == want and not got["found"]
    assert answer(ref, port, lambda n: n.delete_stored_script(
        "by_level")) is None
    assert answer(ref, port, lambda n: n.search_template(
        "logs", {"id": "by_level"})) is None


# -- tests/test_modules_parity.py: more_like_this, percolate, join -----------


@pytest.fixture()
def modules(tmp_path_factory):
    ref, port = pair(tmp_path_factory, "modules")
    for node in (ref, port):
        node.create_index("art", {"mappings": {"properties": {
            "body": {"type": "text"}}}})
        for _id, body in (
                ("1", "machine learning models learn patterns from data"),
                ("2", "deep learning models use neural networks and data"),
                ("3", "gardening tips for growing tomato plants at home"),
                ("4", "neural networks learn hierarchical data patterns"),
                ("5", "tomato plants need water sunlight and patience")):
            node.index_doc("art", _id, {"body": body})
        node.refresh("art")
        node.create_index("alerts", {"mappings": {"properties": {
            "q": {"type": "percolator"}, "msg": {"type": "text"},
            "level": {"type": "keyword"}}}})
        node.index_doc("alerts", "err", {"q": {"match": {"msg": "error"}}})
        node.index_doc("alerts", "crit", {"q": {"bool": {"must": [
            {"match": {"msg": "error"}}, {"term": {"level": "critical"}}]}}})
        node.index_doc("alerts", "disk", {"q": {"match": {"msg": "disk full"}}})
        node.index_doc("alerts", "bad", {"q": {"bogus_query": {}}})
        node.refresh("alerts")
        node.create_index("qa", {
            "settings": {"index": {"number_of_shards": 2}},
            "mappings": {"properties": {
                "rel": {"type": "join", "relations": {"question": "answer"}},
                "text": {"type": "text"}, "votes": {"type": "long"}}}})
        node.index_doc("qa", "q1", {"rel": "question",
                                    "text": "how do tpus work"})
        node.index_doc("qa", "q2", {"rel": "question", "text": "what is jax"})
        for _id, parent, text, votes in (
                ("a1", "q1", "systolic arrays multiply matrices", 10),
                ("a2", "q1", "they use matrix units", 2),
                ("a3", "q2", "jax is a numerical library", 5)):
            node.index_doc("qa", _id, {
                "rel": {"name": "answer", "parent": parent}, "text": text,
                "votes": votes}, routing=parent)
        node.refresh("qa")
        node.create_index("ml", {"mappings": {"properties": {
            "rel": {"type": "join", "relations": {"a": "b", "b": "c"}},
            "t": {"type": "keyword"}}}})
        node.index_doc("ml", "A", {"rel": "a", "t": "top"})
        node.index_doc("ml", "B", {"rel": {"name": "b", "parent": "A"},
                                   "t": "mid"}, routing="A")
        node.index_doc("ml", "C", {"rel": {"name": "c", "parent": "B"},
                                   "t": "leaf"}, routing="A")
        node.refresh("ml")
    yield ref, port
    ref.close()
    port.close()


@pytest.mark.parametrize("index,query", [
    ("art", {"more_like_this": {
        "fields": ["body"], "like": "learning models data neural patterns",
        "min_term_freq": 1, "min_doc_freq": 1}}),
    ("art", {"more_like_this": {
        "fields": ["body"], "like": [{"_index": "art", "_id": "1"}],
        "min_term_freq": 1, "min_doc_freq": 1}}),
    ("art", {"more_like_this": {
        "like": [{"_id": "2"}, "tomato"], "min_term_freq": 1,
        "min_doc_freq": 1, "minimum_should_match": "60%"}}),
    ("art", {"more_like_this": {"fields": ["body"], "like": "data",
                                "minimum_should_match": "most"}}),
    ("art", {"more_like_this": {"fields": ["body"]}}),
    ("alerts", {"percolate": {"field": "q", "document": {
        "msg": "an error occurred", "level": "warn"}}}),
    ("alerts", {"percolate": {"field": "q", "document": {
        "msg": "disk full error", "level": "critical"}}}),
    ("alerts", {"percolate": {"field": "q", "documents": [
        {"msg": "all fine"}, {"msg": "disk full"}]}}),
    ("alerts", {"percolate": {"field": "q"}}),
    ("qa", {"has_child": {"type": "answer",
                          "query": {"match": {"text": "matrix"}}}}),
    ("qa", {"has_child": {"type": "answer", "query": {"match_all": {}},
                          "min_children": 2}}),
    ("qa", {"has_parent": {"parent_type": "question",
                           "query": {"match": {"text": "jax"}}}}),
    ("qa", {"parent_id": {"type": "answer", "id": "q1"}}),
    ("ml", {"has_child": {"type": "c", "query": {"term": {"t": "leaf"}}}}),
])
def test_modules_bodies_match_reference(modules, index, query):
    ref, port = modules
    same(ref, port, index, {"query": query})


def test_percolate_leaves_no_mapping_and_no_device_bytes(modules):
    """A percolated document's new field stays out of the mapping, and the
    throwaway segment's residency-ledger entries are freed."""
    from opensearch_tpu_torch.telemetry.device_ledger import default_ledger

    ref, port = modules
    before = default_ledger.resident_bytes()
    got = same(ref, port, "alerts", {"query": {"percolate": {
        "field": "q", "document": {"brand_new_field": "x",
                                   "msg": "error"}}}})
    assert {h["_id"] for h in got["hits"]["hits"]} == {"err"}
    assert default_ledger.resident_bytes() == before
    mapping = port.indices["alerts"].mapper_service.to_dict()["properties"]
    assert "brand_new_field" not in mapping
