"""The lexical query phase of the port (search/executor.py, ops/bm25.py,
search/phases.py, search/service.py) against the JAX reference, on the CPU.

Each body runs through a TpuNode and a TorchNode(device="cpu") built from
the same bulk: the documents of tests/test_search_e2e.py (2 shards, and
one shard for exact BM25 ranking), of tests/test_query_dsl_extended.py,
the 40 docs of tests/test_search_phases.py, and a corpus of a few hundred
docs made from a numpy seed (Zipf-drawn words in ``body`` and ``title``,
a keyword ``tag``, ``views``, a date ``ts``) in one and in three shards,
written in two refreshes with deletes. The bodies are those suites' query,
sort, paging, ``search_after``, ``min_score``, ``track_total_hits``,
rescore, collapse and named-query bodies (without aggregations, scripts,
``nested`` and ``hybrid``), and the same query types on the seeded corpus.

Ids, totals, sort values, ``matched_queries`` and collapse fields must be
equal; scores agree to rtol 1e-6, as BM25's two summation orders may round
apart (the sum itself is the reference's order, term by term from 0,
and on the CPU every score of these bodies has come out bit-equal; XLA may
contract ``tf + k1 * (...)`` into a fused multiply-add where PyTorch does
not). Hits whose scores tie within that tolerance may swap places (the
tie-aware check of the kNN parity tests). ``search_after`` pages are held
to the reference's page by page, the cursor taken from each package's own
previous page.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu_torch.node import TorchNode

RTOL = 1e-6

E2E_DOCS = [
    {"id": "1", "title": "the quick brown fox", "tag": "animal", "price": 10,
     "rating": 4.5, "created": "2024-01-05T00:00:00Z", "in_stock": True,
     "vec": [1.0, 0.0, 0.0, 0.0]},
    {"id": "2", "title": "the lazy brown dog sleeps", "tag": "animal",
     "price": 25, "rating": 3.0, "created": "2024-02-10T00:00:00Z",
     "in_stock": False, "vec": [0.0, 1.0, 0.0, 0.0]},
    {"id": "3", "title": "quick quick quick fox jumps", "tag": "speed",
     "price": 30, "rating": 5.0, "created": "2024-02-20T00:00:00Z",
     "in_stock": True, "vec": [0.9, 0.1, 0.0, 0.0]},
    {"id": "4", "title": "an unrelated essay", "tag": "other", "price": 7,
     "rating": 1.0, "created": "2024-03-01T12:30:00Z", "in_stock": True,
     "vec": [0.0, 0.0, 1.0, 0.0]},
    {"id": "5", "title": "brown bears eat fish", "tag": "animal", "price": 50,
     "rating": 2.5, "created": "2023-12-25T00:00:00Z", "in_stock": False,
     "vec": [0.1, 0.2, 0.3, 0.9]},
]
E2E_MAPPINGS = {"properties": {
    "title": {"type": "text"}, "tag": {"type": "keyword"},
    "price": {"type": "long"}, "rating": {"type": "float"},
    "created": {"type": "date"}, "in_stock": {"type": "boolean"},
    "vec": {"type": "dense_vector", "dims": 4, "similarity": "l2_norm"}}}

DSL_DOCS = [
    {"id": "1", "title": "the quick brown fox", "tag": "animal", "price": 10,
     "views": 100, "created": "2024-01-05T00:00:00Z"},
    {"id": "2", "title": "the lazy brown dog sleeps", "tag": "animal",
     "price": 25, "views": 10, "created": "2024-02-10T00:00:00Z"},
    {"id": "3", "title": "quick quick quick fox jumps", "tag": "speed",
     "price": 30, "views": 1000, "created": "2024-02-20T00:00:00Z"},
    {"id": "4", "title": "an unrelated essay", "tag": "other", "price": 7,
     "views": 1, "created": "2024-03-01T12:30:00Z"},
    {"id": "5", "title": "brown bears eat fish", "tag": "animols",
     "price": 50, "views": 50, "created": "2023-12-25T00:00:00Z"},
]
DSL_MAPPINGS = {"properties": {
    "title": {"type": "text"}, "tag": {"type": "keyword"},
    "price": {"type": "long"}, "views": {"type": "long"},
    "created": {"type": "date"}}}

PHASES_MAPPINGS = {"properties": {
    "title": {"type": "text"}, "n": {"type": "long"},
    "grp": {"type": "keyword"}}}

CORPUS_MAPPINGS = {"properties": {
    "body": {"type": "text"}, "title": {"type": "text"},
    "tag": {"type": "keyword"}, "views": {"type": "long"},
    "ts": {"type": "date"}}}
N_CORPUS = 400
CORPUS_DELETED = ("3", "100", "257", "399")


def _word(i: int) -> str:
    """The i-th synthetic word: letters only, so the standard analyzer
    keeps it whole."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    out = ""
    i += 27
    while i:
        out = letters[i % 26] + out
        i //= 26
    return out


def corpus_docs(seed: int = 5) -> list[dict]:
    rng = np.random.default_rng(seed)
    vocab = 300
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -1.07
    p /= p.sum()
    docs = []
    for i in range(N_CORPUS):
        n_body = int(rng.integers(3, 25))
        body = " ".join(_word(int(w)) for w in rng.choice(vocab, n_body, p=p))
        n_title = int(rng.integers(2, 6))
        title = " ".join(_word(int(w))
                         for w in rng.choice(vocab, n_title, p=p))
        docs.append({"body": body, "title": title,
                     "tag": f"t{int(rng.zipf(1.5)) % 12}",
                     "views": int(rng.integers(0, 1000)),
                     "ts": int(1_700_000_000_000
                               + rng.integers(0, 10_000) * 60_000)})
    return docs


def _build(node, seed_docs: list[dict]) -> None:
    node.create_index("items", {"settings": {"number_of_shards": 2},
                                "mappings": E2E_MAPPINGS})
    node.create_index("r1", {"settings": {"number_of_shards": 1},
                             "mappings": E2E_MAPPINGS})
    for name in ("items", "r1"):
        node.bulk([("index", {"_index": name, "_id": d["id"]},
                    {k: v for k, v in d.items() if k != "id"})
                   for d in E2E_DOCS])
    node.create_index("qdsl", {"settings": {"number_of_shards": 2},
                               "mappings": DSL_MAPPINGS})
    node.bulk([("index", {"_index": "qdsl", "_id": d["id"]},
                {k: v for k, v in d.items() if k != "id"})
               for d in DSL_DOCS])
    node.create_index("phases", {"settings": {"number_of_shards": 1},
                                 "mappings": PHASES_MAPPINGS})
    node.bulk([("index", {"_index": "phases", "_id": f"i{i}"},
                {"title": f"doc {'alpha' if i % 2 == 0 else 'beta'} {i}",
                 "n": i, "grp": f"g{i % 4}"}) for i in range(40)])
    for name, shards in (("c1", 1), ("c3", 3)):
        node.create_index(name, {"settings": {"number_of_shards": shards},
                                 "mappings": CORPUS_MAPPINGS})
        ops = [("index", {"_index": name, "_id": str(i)}, d)
               for i, d in enumerate(seed_docs)]
        half = len(ops) // 2
        node.bulk(ops[:half])
        node.refresh(name)
        node.bulk(ops[half:] + [("delete", {"_index": name, "_id": d}, None)
                                for d in CORPUS_DELETED])
    node.refresh("_all")


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    docs = corpus_docs()
    ref = TpuNode(tmp_path_factory.mktemp("tpu"))
    port = TorchNode(tmp_path_factory.mktemp("torch"), device="cpu")
    for node in (ref, port):
        _build(node, docs)
    yield ref, port, docs
    ref.close()
    port.close()


E2E_BODIES = [
    {"query": {"match_all": {}}},
    {"query": {"match": {"title": "quick fox"}}},
    {"query": {"match": {"title": {"query": "brown fox"}}}},
    {"query": {"match": {"title": {"query": "brown fox",
                                   "operator": "and"}}}},
    {"query": {"term": {"tag": "animal"}}},
    {"query": {"terms": {"tag": ["speed", "other"]}}},
    {"query": {"term": {"tag": "nope"}}},
    {"query": {"range": {"price": {"gte": 25, "lt": 50}}}},
    {"query": {"range": {"created": {"gte": "2024-02-01T00:00:00Z"}}}},
    {"query": {"range": {"rating": {"gt": 4.5}}}},
    {"query": {"bool": {"must": [{"match": {"title": "brown"}}],
                        "filter": [{"range": {"price": {"lte": 30}}}],
                        "must_not": [{"term": {"tag": "speed"}}]}}},
    {"query": {"bool": {"should": [{"term": {"tag": "animal"}},
                                   {"range": {"price": {"gte": 40}}}],
                        "minimum_should_match": 2}}},
    {"query": {"term": {"in_stock": True}}},
    {"query": {"exists": {"field": "vec"}}},
    {"query": {"ids": {"values": ["2", "4", "zzz"]}}},
    {"sort": [{"price": "desc"}]},
    {"sort": [{"created": {"order": "asc"}}]},
    {"sort": [{"tag": "asc"}, {"price": "desc"}]},
    {"sort": [{"price": "asc"}], "size": 2},
    {"sort": [{"price": "asc"}], "size": 2, "from": 2},
    {"query": {"ids": {"values": ["1"]}}, "_source": ["title", "price"]},
    {"query": {"ids": {"values": ["1"]}}, "_source": False},
    {"query": {"match": {"title": "brown"}}, "min_score": 0.15},
    {"track_total_hits": False},
    {"track_total_hits": 3},
    {"track_total_hits": 10},
    {"query": {"match": {"title": "quick"}}, "sort": ["_score",
                                                      {"price": "asc"}]},
    {"query": {"match_all": {}}, "sort": [{"rating": {"order": "desc",
                                                      "missing": "_last"}},
                                          "_doc"]},
    {"query": {"knn": {"vec": {"vector": [1.0, 0.0, 0.0, 0.0], "k": 2,
                               "filter": {"term": {"tag": "animal"}}}}}},
    {"query": {"bool": {"must": [{"match": {"title": {"query": "brown",
                                                      "_name": "m"}}}],
                        "should": [{"term": {"tag": {"value": "animal",
                                                     "_name": "t"}}}]}}},
    {"query": {"bool": {"should": [
        {"match": {"title": {"query": "fox", "_name": "fox"}}},
        {"range": {"price": {"gte": 30, "_name": "pricey"}}}]}},
     "include_named_queries_score": True},
    {"query": {"match": {"title": "brown"}}, "indices_boost": {"items": 2.0}},
    {"query": {"match": {"title": "brown"}},
     "highlight": {"fields": {"title": {}}}},
    {"query": {"query_string": {"query": "quick AND fox",
                                "fields": ["title"]}},
     "highlight": {"fields": {"title": {}}}},
    {"query": {"match": {"title": "fox"}}, "explain": True, "version": True},
    {"query": {"constant_score": {"filter": {"term": {"tag": "animal"}},
                                  "boost": 1.5}}},
    {"query": {"match_phrase": {"title": "brown fox"}}},
    {"query": {"match_phrase": {"title": {"query": "quick fox",
                                          "slop": 2}}}},
    {"query": {"multi_match": {"query": "brown quick",
                               "fields": ["title", "tag"]}}},
    {"query": {"multi_match": {"query": "brown quick", "type": "most_fields",
                               "fields": ["title^2", "tag"]}}},
    {"query": {"intervals": {"title": {"match": {"query": "quick fox",
                                                 "ordered": True}}}}},
]

DSL_BODIES = [
    {"query": {"prefix": {"title": {"value": "qui"}}}},
    {"query": {"prefix": {"tag": "anim"}}},
    {"query": {"prefix": {"tag": {"value": "ANIM",
                                  "case_insensitive": True}}}},
    {"query": {"prefix": {"tag": {"value": "ANIM"}}}},
    {"query": {"wildcard": {"title": "qu*k"}}},
    {"query": {"wildcard": {"tag": {"value": "anim?l"}}}},
    {"query": {"wildcard": {"tag": {"value": "anim*"}}}},
    {"query": {"regexp": {"tag": "anim[ao]ls?"}}},
    {"query": {"fuzzy": {"tag": {"value": "animals"}}}},
    {"query": {"fuzzy": {"tag": {"value": "animal", "fuzziness": "0"}}}},
    {"query": {"fuzzy": {"title": "fix"}}},
    {"query": {"match_phrase_prefix": {"title": "brown d"}}},
    {"query": {"match_phrase_prefix": {"title": "qui"}}},
    {"query": {"match_bool_prefix": {"title": "jumps qu"}}},
    {"query": {"query_string": {"query": "quick AND fox",
                                "fields": ["title"]}}},
    {"query": {"query_string": {"query": "fox OR bears",
                                "fields": ["title"]}}},
    {"query": {"query_string": {"query": "brown NOT dog",
                                "fields": ["title"]}}},
    {"query": {"query_string": {"query": "tag:speed OR title:essay"}}},
    {"query": {"query_string": {"query": "title:(dog OR essay)"}}},
    {"query": {"query_string": {"query": '"brown fox"',
                                "fields": ["title"]}}},
    {"query": {"query_string": {"query": "qu*ck", "fields": ["title"]}}},
    {"query": {"query_string": {"query": "brown -title:dog",
                                "fields": ["title"]}}},
    {"query": {"query_string": {"query": "-tag:animal"}}},
    {"query": {"query_string": {"query": "speed"}}},
    {"query": {"simple_query_string": {"query": "quick +fox",
                                       "fields": ["title"]}}},
    {"query": {"simple_query_string": {"query": "brown -dog",
                                       "fields": ["title"]}}},
    {"query": {"simple_query_string": {"query": "fox | bears",
                                       "fields": ["title"]}}},
    {"query": {"simple_query_string": {"query": "fox (((",
                                       "fields": ["title"]}}},
    {"query": {"dis_max": {"queries": [{"term": {"tag": "speed"}},
                                       {"match": {"title": "essay"}}]}}},
    {"query": {"dis_max": {"queries": [{"match": {"title": "brown"}},
                                       {"match": {"title": "fox"}}],
                           "tie_breaker": 0.3}}},
    {"query": {"boosting": {"positive": {"match": {"title": "brown"}},
                            "negative": {"match": {"title": "dog"}},
                            "negative_boost": 0.1}}},
    {"query": {"function_score": {
        "query": {"match": {"title": "brown"}},
        "functions": [{"filter": {"term": {"tag": "animal"}}, "weight": 10}],
        "boost_mode": "replace"}}},
    {"query": {"function_score": {
        "query": {"match_all": {}},
        "field_value_factor": {"field": "views", "modifier": "log1p",
                               "factor": 1.0},
        "boost_mode": "replace"}}},
    {"query": {"function_score": {
        "query": {"match_all": {}},
        "gauss": {"price": {"origin": 10, "scale": 20}},
        "boost_mode": "replace"}}},
    {"query": {"function_score": {
        "query": {"match_all": {}},
        "exp": {"created": {"origin": "2024-02-01T00:00:00Z",
                            "scale": "10d"}},
        "boost_mode": "multiply"}}},
    {"query": {"function_score": {
        "query": {"match_all": {}}, "random_score": {"seed": 7},
        "boost_mode": "replace"}}},
    {"query": {"function_score": {
        "query": {"match": {"title": "brown quick"}},
        "functions": [{"filter": {"term": {"tag": "animal"}}, "weight": 2},
                      {"field_value_factor": {"field": "price",
                                              "modifier": "sqrt"}}],
        "score_mode": "sum", "boost_mode": "sum", "max_boost": 6}}},
]

PHASES_BODIES = [
    {"query": {"match": {"title": "alpha"}}},
    {"query": {"range": {"n": {"gte": 10_000}}}},
    {"query": {"match": {"title": "doc"}},
     "rescore": {"window_size": 40, "query": {
         "rescore_query": {"range": {"n": {"gte": 30}}},
         "query_weight": 0.0, "rescore_query_weight": 2.0,
         "score_mode": "total"}}, "size": 10},
    {"query": {"match_all": {}},
     "rescore": {"window_size": 5, "query": {
         "rescore_query": {"match_all": {}}, "score_mode": "multiply"}}},
    {"query": {"match": {"title": "alpha beta"}},
     "rescore": [{"window_size": 8, "query": {
         "rescore_query": {"match": {"title": {"query": "7",
                                               "_name": "seven"}}},
         "score_mode": "max"}}], "size": 12},
    {"query": {"match_all": {}}, "sort": [{"n": "asc"}],
     "collapse": {"field": "grp"}, "size": 10},
    {"query": {"match": {"title": "alpha"}}, "collapse": {
        "field": "grp", "inner_hits": {"name": "top", "size": 2,
                                       "sort": [{"n": "desc"}]}}},
]


def _corpus_bodies(docs: list[dict]) -> list[dict]:
    body3 = docs[11]["body"].split()
    phrase = " ".join(body3[:2])
    return [
        {"query": {"match": {"body": f"{_word(0)} {_word(7)} {_word(40)}"}}},
        {"query": {"match": {"body": {"query": f"{_word(1)} {_word(3)}",
                                      "operator": "and"}}}, "size": 25},
        {"query": {"match": {"body": {"query": f"{_word(2)} {_word(5)} {_word(9)}",
                                      "minimum_should_match": 2}}}},
        {"query": {"match_phrase": {"body": phrase}}},
        {"query": {"multi_match": {"query": f"{_word(4)} {_word(12)}",
                                   "fields": ["body", "title"]}}},
        {"query": {"term": {"tag": "t1"}}, "size": 30},
        {"query": {"terms": {"tag": ["t2", "t3", "t9"]}}},
        {"query": {"range": {"views": {"gte": 100, "lt": 400}}}},
        {"query": {"range": {"ts": {"gte": 1_700_100_000_000}}}},
        {"query": {"bool": {
            "must": [{"match": {"body": f"{_word(0)} {_word(6)}"}}],
            "filter": [{"term": {"tag": "t1"}},
                       {"range": {"views": {"lt": 800}}}],
            "must_not": [{"match": {"title": _word(1)}}]}}},
        {"query": {"prefix": {"tag": "t1"}}},
        {"query": {"wildcard": {"tag": "t?"}}},
        {"query": {"query_string": {
            "query": f"body:{_word(3)} AND NOT title:{_word(0)}"}}},
        {"query": {"match_all": {}}, "sort": [{"ts": "desc"}], "size": 15},
        {"query": {"match": {"body": _word(2)}}, "rescore": {
            "window_size": 50, "query": {"rescore_query": {
                "match_phrase": {"body": f"{_word(0)} {_word(1)}"}}}}},
        {"query": {"match": {"body": f"{_word(0)} {_word(5)}"}},
         "collapse": {"field": "tag"}, "size": 12},
        {"query": {"match": {"body": _word(8)}}, "min_score": 1.0,
         "track_total_hits": 5},
    ]


def _cases():
    out = []
    for i, b in enumerate(E2E_BODIES):
        index = "r1" if i in (1, 26) else "items"
        out.append(pytest.param(index, b, id=f"e2e-{i}"))
    for i, b in enumerate(DSL_BODIES):
        out.append(pytest.param("qdsl", b, id=f"dsl-{i}"))
    for i, b in enumerate(PHASES_BODIES):
        out.append(pytest.param("phases", b, id=f"phases-{i}"))
    for i in range(len(_corpus_bodies(corpus_docs()))):
        for index in ("c1", "c3"):
            out.append(pytest.param(index, i, id=f"corpus-{index}-{i}"))
    return out


def _same_score(a, b) -> bool:
    if a is None or b is None:
        return a is b
    return abs(a - b) <= RTOL * max(abs(a), abs(b), 1e-30)


def assert_same_hits(want: dict, got: dict) -> None:
    """Totals, max_score and each hit's id, score, sort values and fetch
    keys; hits whose scores tie within RTOL may swap places."""
    assert got["hits"].get("total") == want["hits"].get("total")
    assert _same_score(want["hits"]["max_score"], got["hits"]["max_score"])
    wh, gh = want["hits"]["hits"], got["hits"]["hits"]
    assert len(wh) == len(gh), ([h["_id"] for h in wh],
                                [h["_id"] for h in gh])
    for w, g in zip(wh, gh):
        assert _same_score(w["_score"], g["_score"]), (w, g)
        if w["_id"] != g["_id"]:
            # a swap is allowed only inside a tie
            ties = {h["_id"] for h in wh if _same_score(h["_score"],
                                                        w["_score"])}
            assert g["_id"] in ties or len(wh) == len(ties), (w, g)
        else:
            for key in ("sort", "_source", "fields", "highlight",
                        "_version", "_explanation"):
                assert g.get(key) == w.get(key), (key, w, g)
            if "matched_queries" in w:
                mq_w, mq_g = w["matched_queries"], g["matched_queries"]
                if isinstance(mq_w, dict):
                    assert set(mq_w) == set(mq_g)
                    for k in mq_w:
                        assert _same_score(mq_w[k], mq_g[k])
                else:
                    assert mq_g == mq_w
            if "inner_hits" in w:
                for name, ih in w["inner_hits"].items():
                    gi = g["inner_hits"][name]["hits"]
                    assert gi["total"] == ih["hits"]["total"]
                    assert [h["_id"] for h in gi["hits"]] == \
                        [h["_id"] for h in ih["hits"]["hits"]]


@pytest.mark.parametrize("index,body", _cases())
def test_body_matches_reference(nodes, index, body):
    ref, port, docs = nodes
    if isinstance(body, int):
        body = _corpus_bodies(docs)[body]
    want = ref.search(index, dict(body))
    got = port.search(index, dict(body))
    assert_same_hits(want, got)
    assert got["_shards"] == want["_shards"]


@pytest.mark.parametrize("index,sort", [
    ("items", [{"price": "asc"}]),
    ("c3", [{"ts": "desc"}, {"views": "asc"}]),
    ("c1", [{"tag": "asc"}, {"views": "desc"}]),
    ("c3", ["_score", {"ts": "asc"}]),
])
def test_search_after_pages_match_reference(nodes, index, sort):
    """Three pages of `size` through search_after, each package's cursor
    from its own previous page."""
    ref, port, _docs = nodes
    query = ({"match": {"body": f"{_word(0)} {_word(2)}"}} if index != "items"
             else {"match_all": {}})
    cursors = [None, None]
    for _page in range(3):
        resps = []
        for i, node in enumerate((ref, port)):
            body = {"query": query, "sort": sort, "size": 4}
            if cursors[i] is not None:
                body["search_after"] = cursors[i]
            resps.append(node.search(index, body))
        assert_same_hits(*resps)
        for i, r in enumerate(resps):
            if r["hits"]["hits"]:
                cursors[i] = r["hits"]["hits"][-1]["sort"]


def test_errors_match_reference(nodes):
    ref, port, _docs = nodes
    from opensearch_tpu.common.errors import OpenSearchTpuException as RefExc
    from opensearch_tpu_torch.common.errors import OpenSearchTpuException

    for body in ({"search_after": [10]},
                 {"sort": [{"price": "asc"}], "from": 5,
                  "search_after": [10]},
                 {"query": {"match_all": {}}, "sort": [{"price": "asc"}],
                  "rescore": {"query": {"rescore_query": {
                      "match_all": {}}}}},
                 {"query": {"range": {"price": {"gte": 1, "bogus": 2}}}},
                 {"sort": ["_shard_doc"]}):
        with pytest.raises(RefExc) as want:
            ref.search("items", dict(body))
        with pytest.raises(OpenSearchTpuException) as got:
            port.search("items", dict(body))
        assert str(got.value) == str(want.value)
        assert got.value.status == want.value.status


@pytest.mark.parametrize("index,body", [
    ("items", {"query": {"match": {"title": "brown"}}}),
    ("c3", {"query": {"bool": {"must": [{"match": {"body": _word(0)}}],
                               "filter": [{"term": {"tag": "t1"}}]}}}),
    ("c1", None),
])
def test_count_matches_reference(nodes, index, body):
    ref, port, _docs = nodes
    want = ref.count(index, body)
    got = port.count(index, body)
    assert got == want
    assert got["count"] == port.search(index, dict(body or {}))[
        "hits"]["total"]["value"]


@pytest.mark.parametrize("body", [
    {"script": {"script": {"source": "doc['price'].value > 10"}}},
    {"script_score": {"query": {"match_all": {}},
                      "script": {"source": "_score * 2"}}},
    {"terms_set": {"tag": {"terms": ["animal"],
                           "minimum_should_match_field": "price"}}},
    {"geo_distance": {"distance": "10km", "loc": {"lat": 0, "lon": 0}}},
    {"geo_bounding_box": {"loc": {"top_left": {"lat": 1, "lon": 0},
                                  "bottom_right": {"lat": 0, "lon": 1}}}},
    {"nested": {"path": "meta", "query": {"match_all": {}}}},
    {"has_child": {"type": "c", "query": {"match_all": {}}}},
    {"has_parent": {"parent_type": "p", "query": {"match_all": {}}}},
    {"parent_id": {"type": "c", "id": "1"}},
    {"more_like_this": {"fields": ["title"], "like": "brown fox"}},
    {"hybrid": {"queries": [{"match_all": {}}]}},
    {"rank_feature": {"field": "price"}},
    {"distance_feature": {"field": "created", "origin": "now",
                          "pivot": "7d"}},
    {"percolate": {"field": "q", "document": {"title": "brown"}}},
])
def test_unported_nodes_raise_by_name(nodes, body, monkeypatch):
    """These nodes are ported now: each answers as the reference does
    (the same ids, totals and scores, or the same error), the clock fixed
    for ``distance_feature``'s "now"."""
    import time as time_mod

    ref, port, _docs = nodes
    monkeypatch.setattr(time_mod, "time", lambda: 1_709_251_200.0)
    request = {"query": body}
    try:
        want = ref.search("items", dict(request))
    except Exception as e:  # noqa: BLE001 - the reference's error is the answer
        with pytest.raises(Exception) as got:
            port.search("items", dict(request))
        assert type(got.value).__name__ == type(e).__name__
        assert str(got.value) == str(e)
        assert getattr(got.value, "status", None) == getattr(e, "status",
                                                             None)
        return
    got = port.search("items", dict(request))
    assert got["hits"]["total"] == want["hits"]["total"]
    assert [h["_id"] for h in got["hits"]["hits"]] == \
        [h["_id"] for h in want["hits"]["hits"]]
    np.testing.assert_allclose(
        [h["_score"] for h in got["hits"]["hits"]],
        [h["_score"] for h in want["hits"]["hits"]], rtol=RTOL)


def test_count_and_lexical_search_over_http(nodes):
    """``_count`` and a lexical ``_search`` over the port's HTTP server give
    the in-process answers (hits and scores bit for bit: JSON round-trips
    float repr) and the reference's count."""
    from opensearch_tpu_torch.rest.http import HttpServer
    from test_torch_rest import Client

    ref, port, _docs = nodes
    srv = HttpServer(port, "127.0.0.1", 0)
    srv.start_in_thread()
    try:
        c = Client(srv.port)
        query = {"bool": {"must": [{"match": {"body": f"{_word(0)} {_word(4)}"}}],
                          "filter": [{"range": {"views": {"lt": 700}}}]}}
        for method in ("GET", "POST"):
            status, payload = c(method, "/c3/_count", {"query": query})
            assert status == 200
            assert payload == ref.count("c3", {"query": query})
        status, payload = c("POST", "/_count", None)
        assert status == 200 and payload == port.count("_all")
        body = {"query": query, "size": 7, "sort": ["_score",
                                                    {"ts": "desc"}]}
        status, payload = c("POST", "/c3/_search", body)
        assert status == 200
        want = port.search("c3", dict(body))
        assert payload["hits"] == want["hits"]
        assert payload["hits"]["total"]["value"] == payload_count(c, query)
    finally:
        srv.stop_thread()


def payload_count(c, query) -> int:
    status, payload = c("POST", "/c3/_count", {"query": query})
    assert status == 200
    return payload["count"]


@pytest.mark.parametrize("live", [[3772], [5, 4100], [0, 1, 2, 262_143]])
def test_segment_top_k_returns_each_doc_once(live):
    """A segment of 2^18 slots whose mask admits fewer docs than k, all in
    the first blocks: each doc comes back once, best first, then -inf
    slots (a match_phrase of one hit on index L returned its doc ten times
    on the card before the candidate blocks were made distinct)."""
    import torch

    from opensearch_tpu_torch.ops.topk import segment_top_k

    scores = torch.full((262_144,), float("-inf"))
    scores[live] = torch.arange(len(live), 0, -1, dtype=torch.float32)
    vals, ids = segment_top_k(scores, 10)
    finite = torch.isfinite(vals)
    assert ids[finite].tolist() == live
    assert int(finite.sum()) == len(live)
