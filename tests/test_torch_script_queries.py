"""Scripts in search and update, stored scripts and templates in the port
against the JAX reference, on the CPU.

The five node tests of tests/test_scripting.py (``script_fields``, the
generic ``script_score``, the ``script`` filter, a scripted update with
its noop and delete paths, ``scripted_upsert``), the four ``script_score``
vector forms of the k-NN plugin (``knn_score`` with its three spaces,
``cosineSimilarity``, ``dotProduct`` and ``l2Squared``, over a
``match_all``, a ``match`` and a ``knn`` inner query), stored scripts and
``_render/template``. Each runs through a TpuNode and a
TorchNode(device="cpu") built from the same writes, in one and in three
shards. The vectors are eighths, so every product is exact in float32 in
any order: the vector forms' scores are equal bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from test_torch_dsl import answer, pair, same
from test_torch_lexical import assert_same_hits

N_DOCS = 60


@pytest.fixture(scope="module")
def items(tmp_path_factory):
    ref, port = pair(tmp_path_factory, "scripts")
    for node in (ref, port):
        node.create_index("items", {"mappings": {"properties": {
            "name": {"type": "keyword"}, "price": {"type": "long"},
            "rating": {"type": "float"}}}})
        for i, (name, price, rating) in enumerate(
                [("a", 10, 4.0), ("b", 20, 3.0), ("c", 30, 5.0)]):
            node.index_doc("items", str(i + 1), {
                "name": name, "price": price, "rating": rating})
        node.refresh("items")
    yield ref, port
    ref.close()
    port.close()


def test_script_fields(items):
    ref, port = items
    got = same(ref, port, "items", {
        "query": {"match_all": {}},
        "script_fields": {
            "double_price": {"script": {"source": "doc['price'].value * 2"}},
            "label": {"script": {
                "source": "doc['name'].value + ':' + params.tag",
                "params": {"tag": "x"}}}}})
    by_id = {h["_id"]: h["fields"] for h in got["hits"]["hits"]}
    assert by_id["1"]["double_price"] == [20]
    assert by_id["2"]["label"] == ["b:x"]


def test_generic_script_score(items):
    ref, port = items
    got = same(ref, port, "items", {"query": {"script_score": {
        "query": {"match_all": {}},
        "script": {"source":
                   "doc['price'].value * 0.1 + doc['rating'].value"}}}})
    assert [h["_id"] for h in got["hits"]["hits"]][0] == "3"


def test_script_filter_query(items):
    ref, port = items
    got = same(ref, port, "items", {"query": {"bool": {"filter": [
        {"script": {"script": {"source": "doc['price'].value >= params.min",
                               "params": {"min": 20}}}}]}}})
    assert sorted(h["_id"] for h in got["hits"]["hits"]) == ["2", "3"]


@pytest.fixture()
def writable(tmp_path_factory):
    ref, port = pair(tmp_path_factory, "updates")
    for node in (ref, port):
        node.create_index("items", {"mappings": {"properties": {
            "price": {"type": "long"}}}})
        for i, price in enumerate((10, 20, 30)):
            node.index_doc("items", str(i + 1), {"price": price})
        node.refresh("items")
    yield ref, port
    ref.close()
    port.close()


def _same_write(ref, port, call) -> dict:
    out = answer(ref, port, call)
    if out is None:
        return None
    want, got = out
    for key in ("result", "_id", "_version", "_seq_no"):
        assert got.get(key) == want.get(key), key
    return got


def test_scripted_update(writable):
    ref, port = writable
    _same_write(ref, port, lambda n: n.update_doc("items", "1", {"script": {
        "source": "ctx._source.price += params.d", "params": {"d": 5}}}))
    assert port.get_doc("items", "1")["_source"]["price"] == 15
    out = _same_write(ref, port, lambda n: n.update_doc("items", "1", {
        "script": {"source":
                   "if (ctx._source.price > 10) { ctx.op = 'none' }"}}))
    assert out["result"] == "noop"
    out = _same_write(ref, port, lambda n: n.update_doc("items", "2", {
        "script": {"source": "ctx.op = 'delete'"}}))
    assert out["result"] == "deleted"
    for node in (ref, port):
        assert node.get_doc("items", "2")["found"] is False
    assert _same_write(ref, port, lambda n: n.update_doc("items", "9", {
        "script": {"source": "ctx._source.price = 1"}})) is None
    assert _same_write(ref, port, lambda n: n.update_doc("items", "3", {
        "script": {"source": "ctx._source.price = Math.sqrt(0 - 1)"}})) \
        is None


def test_scripted_upsert(writable):
    ref, port = writable
    _same_write(ref, port, lambda n: n.update_doc("items", "9", {
        "scripted_upsert": True, "upsert": {"price": 1},
        "script": {"source": "ctx._source.price += 100"}}))
    assert port.get_doc("items", "9")["_source"]["price"] == 101
    _same_write(ref, port, lambda n: n.update_doc("items", "8", {
        "upsert": {"price": 7},
        "script": {"source": "ctx._source.price += 100"}}))
    assert port.get_doc("items", "8")["_source"]["price"] == 7
    # scripted updates in _bulk, refreshed and searched
    ops = [("update", {"_index": "items", "_id": str(i)}, {"script": {
        "source": "ctx._source.price *= 2"}}) for i in (1, 3, 9)]
    want, got = answer(ref, port, lambda n: n.bulk(ops, refresh=True))
    assert [next(iter(i.values()))["result"] for i in got["items"]] == \
        [next(iter(i.values()))["result"] for i in want["items"]]
    same(ref, port, "items", {"query": {"range": {"price": {"gte": 40}}}})


# -- the k-NN plugin's scoring-script forms ----------------------------------


def _vectors(seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.round(rng.standard_normal((N_DOCS, 8)) * 8) / 8


@pytest.fixture(scope="module")
def vecs(tmp_path_factory):
    ref, port = pair(tmp_path_factory, "vecs")
    data = _vectors()
    for node in (ref, port):
        for name, shards in (("v1", 1), ("v3", 3)):
            node.create_index(name, {
                "settings": {"number_of_shards": shards},
                "mappings": {"properties": {
                    "v": {"type": "knn_vector", "dimension": 8},
                    "t": {"type": "text"}}}})
            ops = [("index", {"_index": name, "_id": str(i)},
                    {"v": data[i].tolist(),
                     "t": "even" if i % 2 == 0 else "odd"})
                   for i in range(N_DOCS)]
            node.bulk(ops[:30])
            node.refresh(name)
            node.bulk(ops[30:] + [("delete", {"_index": name, "_id": "11"},
                                   None)])
            node.refresh(name)
    yield ref, port
    ref.close()
    port.close()


QV = [0.5, -0.25, 1.0, 0.125, 0.0, -0.75, 0.25, 0.5]
INNER = {"match_all": {"match_all": {}},
         "match": {"match": {"t": "even"}},
         "knn": {"knn": {"v": {"vector": QV, "k": 9}}}}
SCRIPTS = {
    "knn_score_l2": {"source": "knn_score", "lang": "knn", "params": {
        "field": "v", "query_value": QV, "space_type": "l2"}},
    "knn_score_cosine": {"source": "knn_score", "lang": "knn", "params": {
        "field": "v", "query_value": QV, "space_type": "cosinesimil"}},
    "knn_score_dot": {"source": "knn_score", "lang": "knn", "params": {
        "field": "v", "query_value": QV, "space_type": "innerproduct"}},
    "cosineSimilarity": {"source": "cosineSimilarity(params.query_vector, "
                                   "doc['v']) + 1.0",
                         "params": {"query_vector": QV}},
    "dotProduct": {"source": "dotProduct(params.qv, doc['v'])",
                   "params": {"qv": QV}},
    "l2Squared": {"source": "l2Squared(params.qv, doc['v'])",
                  "params": {"qv": QV}},
}


@pytest.mark.parametrize("index", ["v1", "v3"])
@pytest.mark.parametrize("inner", list(INNER))
@pytest.mark.parametrize("script", list(SCRIPTS))
def test_vector_script_score_matches_reference(vecs, index, inner, script):
    ref, port = vecs
    body = {"size": 20, "query": {"script_score": {
        "query": INNER[inner], "script": SCRIPTS[script], "boost": 2.0}}}
    want = ref.search(index, body)
    got = port.search(index, body)
    assert_same_hits(want, got)
    assert [(h["_id"], h["_score"]) for h in got["hits"]["hits"]] == \
        [(h["_id"], h["_score"]) for h in want["hits"]["hits"]]
    assert got["hits"]["hits"]


def test_unknown_vector_form_is_the_references(vecs):
    ref, port = vecs
    assert same(ref, port, "v1", {"query": {"script_score": {
        "query": {"match_all": {}}, "script": {
            "source": "cosineSimilarity(params.nope, doc['v'])",
            "params": {}}}}}) is None


# -- stored scripts and _render/template -------------------------------------


def test_stored_scripts_and_render(tmp_path_factory):
    ref, port = pair(tmp_path_factory, "stored")
    try:
        for call in (
                lambda n: n.put_stored_script("s1", {"script": {
                    "lang": "painless",
                    "source": "doc['price'].value * params.f"}}),
                lambda n: n.put_stored_script("t1", {"script": {
                    "lang": "mustache", "source": {
                        "query": {"match": {"t": "{{q}}"}},
                        "size": "{{n}}"}}}),
                lambda n: n.get_stored_script("s1"),
                lambda n: n.get_stored_script("t1"),
                lambda n: n.get_stored_script("zz"),
                lambda n: n.put_stored_script("bad", {"script": {}}),
                lambda n: n.render_search_template(
                    {"id": "t1", "params": {"q": "x y", "n": 3}}),
                lambda n: n.render_search_template(
                    {"source": '{"query": {"terms": {"t": {{#toJson}}v'
                               '{{/toJson}}}}}', "params": {"v": ["a"]}}),
                lambda n: n.render_search_template({"params": {}}),
                lambda n: n.render_search_template({}, "zz"),
                lambda n: n.delete_stored_script("s1"),
                lambda n: n.delete_stored_script("s1")):
            out = answer(ref, port, call)
            if out is not None:
                assert out[1] == out[0]
        # the scripts live in the data path: a new node on it reads them
        from opensearch_tpu_torch.node import TorchNode

        again = TorchNode(port.data_path, device="cpu")
        assert again.get_stored_script("t1") == port.get_stored_script("t1")
        again.close()
    finally:
        ref.close()
        port.close()
