"""The filter primitives and the filter-context SegmentExecutor of the port
(opensearch_tpu_torch/ops/filters.py, search/executor.py) against the JAX
reference (opensearch_tpu/ops/filters.py, search/executor.py), on the CPU.

1. Each ops/filters.py function and its reference counterpart on the same
   numpy inputs made from a seed: int64 ranges at I64_MIN, I64_MAX and the
   2^31 boundaries (the two-int32-word encoding of segment.split_i64), f32
   ranges with open and closed bounds, keyword term and terms masks over CSR
   entries with empty docs and padded entries (ordinal -2, doc 0), exists,
   and text postings windows of zero and full length. The masks must be
   equal.
2. Each filter-context node a kNN filter may name, parsed from the same
   JSON by both packages, against the reference ``SegmentExecutor.execute(
   node).mask`` on the same segments, built by a TpuNode and a TorchNode
   from one bulk (two refreshes, deletes, missing and multi-valued fields):
   term (keyword, integer, float, date, boolean, _id, text), terms, range
   (integer with int64 sentinels, float, date, keyword), exists, ids, bool
   (must, filter, must_not, should with minimum_should_match),
   constant_score, match_all and match_none. Every mask must be equal; a
   node the port does not execute yet (nested, geo, more_like_this)
   raises "not yet ported".
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from opensearch_tpu.node import TpuNode
from opensearch_tpu.ops import filters as jf
from opensearch_tpu.search import executor as jax_executor
from opensearch_tpu.search import query_dsl as jax_dsl
from opensearch_tpu_torch.index.segment import i64_query_words, split_i64
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.ops import filters as tf
from opensearch_tpu_torch.search import executor as torch_executor
from opensearch_tpu_torch.search import query_dsl as torch_dsl

I64_MIN, I64_MAX = -(2**63), 2**63 - 1
EDGES = (I64_MIN, I64_MIN + 1, -(2**31) - 1, -(2**31), -(2**31) + 1, -1, 0,
         1, 2**31 - 1, 2**31, 2**31 + 1, 2**32, I64_MAX - 1, I64_MAX)


def _i64_column(rng, n: int) -> np.ndarray:
    vals = rng.integers(-(2**40), 2**40, n, dtype=np.int64)
    vals[: len(EDGES)] = EDGES
    return vals


@pytest.mark.parametrize("lo,hi", [
    (I64_MIN, I64_MAX), (I64_MIN, -1), (0, I64_MAX), (-(2**31), 2**31 - 1),
    (-(2**31) + 1, 2**31), (2**31, 2**31), (-1, 1), (I64_MAX, I64_MAX),
    (I64_MIN, I64_MIN), (5, 4), (-(2**40), 2**39)])
def test_range_mask_i64_matches_reference(lo, hi):
    rng = np.random.default_rng(1)
    vals = _i64_column(rng, 256)
    present = rng.random(256) >= 0.1
    h, l = split_i64(vals)
    words = (*i64_query_words(lo), *i64_query_words(hi))
    want = np.asarray(jf.range_mask_i64(
        jnp.asarray(h), jnp.asarray(l), jnp.asarray(present),
        *(jnp.int32(w) for w in words)))
    got = tf.range_mask_i64(torch.from_numpy(h), torch.from_numpy(l),
                            torch.from_numpy(present), *words).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, present & (vals >= lo) & (vals <= hi))


@pytest.mark.parametrize("gte,lte,gt_open,lt_open", [
    (-1.0, 1.0, False, False), (-1.0, 1.0, True, True), (0.0, 0.0, False,
                                                         False),
    (-np.inf, 0.5, False, True), (0.1, np.inf, True, False),
    (1e-8, 3.4e38, False, False), (2.5, -2.5, False, False)])
def test_range_mask_f32_matches_reference(gte, lte, gt_open, lt_open):
    rng = np.random.default_rng(2)
    vals = rng.standard_normal(300).astype(np.float32)
    vals[:6] = (0.0, -0.0, 1.0, -1.0, 0.1, 0.5)
    present = rng.random(300) >= 0.1
    want = np.asarray(jf.range_mask_f32(
        jnp.asarray(vals), jnp.asarray(present), jnp.float32(gte),
        jnp.float32(lte), jnp.asarray(gt_open), jnp.asarray(lt_open)))
    got = tf.range_mask_f32(torch.from_numpy(vals), torch.from_numpy(present),
                            gte, lte, gt_open, lt_open).numpy()
    np.testing.assert_array_equal(got, want)


def _csr(rng, n_docs: int, n_ords: int, e_pad: int):
    """CSR keyword entries: 0-3 ordinals a doc (some docs none), then
    padding entries (ordinal -2, doc 0) up to e_pad."""
    ords, docs = [], []
    for d in range(n_docs):
        for o in sorted(rng.choice(n_ords, rng.integers(0, 4), replace=False)):
            ords.append(o)
            docs.append(d)
    pad = e_pad - len(ords)
    assert pad >= 0
    return (np.asarray(ords + [-2] * pad, np.int32),
            np.asarray(docs + [0] * pad, np.int32))


@pytest.mark.parametrize("query_ord", (0, 3, 7, -3, -2))
def test_term_mask_keyword_matches_reference(query_ord):
    rng = np.random.default_rng(3)
    ords, docs = _csr(rng, 100, 8, 512)
    want = np.asarray(jf.term_mask_keyword(
        jnp.asarray(ords), jnp.asarray(docs), jnp.int32(query_ord), 128))
    got = tf.term_mask_keyword(torch.from_numpy(ords), torch.from_numpy(docs),
                               query_ord, 128).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("query", ([0], [1, 5], [7, -3, -3], [-3] * 4,
                                   [0, 1, 2, 3, 4, 5, 6, 7]))
def test_terms_mask_keyword_matches_reference(query):
    rng = np.random.default_rng(4)
    ords, docs = _csr(rng, 100, 8, 512)
    q = np.full(8, -3, np.int32)
    q[: len(query)] = query
    want = np.asarray(jf.terms_mask_keyword(
        jnp.asarray(ords), jnp.asarray(docs), jnp.asarray(q), 128))
    got = tf.terms_mask_keyword(torch.from_numpy(ords), torch.from_numpy(docs),
                                torch.from_numpy(q), 128).numpy()
    np.testing.assert_array_equal(got, want)


def test_exists_mask_is_presence():
    present = np.random.default_rng(5).random(128) >= 0.5
    np.testing.assert_array_equal(
        tf.exists_mask(torch.from_numpy(present)).numpy(),
        np.asarray(jf.exists_mask(jnp.asarray(present))))


@pytest.mark.parametrize("offset,length,window", [
    (0, 0, 8), (0, 5, 8), (10, 37, 64), (100, 156, 256), (250, 6, 8)])
def test_docs_mask_from_postings_matches_reference(offset, length, window):
    rng = np.random.default_rng(6)
    postings = np.concatenate([np.sort(rng.choice(128, 40, replace=False))
                               for _ in range(7)]).astype(np.int32)
    postings = np.concatenate([postings, np.zeros(512 - len(postings),
                                                  np.int32)])
    want = np.asarray(jf.docs_mask_from_postings(
        jnp.asarray(postings), jnp.int32(offset), jnp.int32(length), 128,
        window))
    got = tf.docs_mask_from_postings(torch.from_numpy(postings), offset,
                                     length, 128, window).numpy()
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# the filter-context nodes against the reference's SegmentExecutor
# --------------------------------------------------------------------------

MAPPING = {"mappings": {"properties": {
    "v": {"type": "knn_vector", "dimension": 4},
    "tag": {"type": "keyword"},
    "name": {"type": "keyword", "normalizer": "lowercase"},
    "age": {"type": "integer"},
    "big": {"type": "long"},
    "price": {"type": "float"},
    "when": {"type": "date"},
    "flag": {"type": "boolean"},
    "title": {"type": "text"},
    "obj": {"properties": {"a": {"type": "integer"},
                           "b": {"type": "keyword"}}},
}}}
N_DOCS = 300
DELETED = ("7", "150", "299")


def _doc(rng, i: int) -> dict:
    doc = {"v": rng.standard_normal(4).round(3).tolist()}
    if i % 7:
        doc["tag"] = (["red", "blue"] if i % 11 == 0
                      else f"t{i % 6}")
    if i % 5:
        doc["name"] = ("Alice", "BOB", "carol")[i % 3]
    if i % 9:
        doc["age"] = [i % 100, (i * 7) % 100] if i % 13 == 0 else i % 100
    if i % 4:
        doc["big"] = int(EDGES[i % len(EDGES)]) if i % 3 == 0 else i * 10**9
    if i % 6:
        doc["price"] = float(np.float32(rng.standard_normal() * 10))
    if i % 8:
        doc["when"] = f"2024-01-{1 + i % 28:02d}T00:00:00Z"
    if i % 10:
        doc["flag"] = bool(i % 2)
    if i % 3:
        doc["title"] = ("quick brown fox", "lazy dog", "brown dog jumps")[i % 3]
    if i % 2:
        doc["obj"] = {"a": i % 4, "b": f"x{i % 3}"}
    return doc


@pytest.fixture(scope="module")
def segments(tmp_path_factory):
    """(reference, port) per-segment executors over the same segments of
    one shard: two refreshes and deletes."""
    rng = np.random.default_rng(7)
    docs = [_doc(rng, i) for i in range(N_DOCS)]
    ref = TpuNode(tmp_path_factory.mktemp("tpu"))
    port = TorchNode(tmp_path_factory.mktemp("torch"), device="cpu")
    for node in (ref, port):
        node.create_index("f", MAPPING)
        ops = [("index", {"_index": "f", "_id": str(i)}, docs[i])
               for i in range(N_DOCS)]
        node.bulk(ops[:N_DOCS // 2])
        node.refresh("f")
        node.bulk(ops[N_DOCS // 2:] + [("delete", {"_index": "f", "_id": d},
                                        None) for d in DELETED])
        node.refresh("f")
    rshard = ref.indices["f"].shards[0]
    pshard = port.indices["f"].shards[0]
    rsnap, psnap = rshard.acquire_searcher(), pshard.acquire_searcher()
    rctx = jax_executor.ShardContext(rsnap, rshard.mapper_service)
    pctx = torch_executor.ShardContext(psnap, pshard.mapper_service)
    pairs = [(jax_executor.SegmentExecutor(rctx, rh, rd),
              torch_executor.SegmentExecutor(pctx, ph, pd))
             for (rh, rd), (ph, pd) in zip(rsnap.segments, psnap.segments)]
    assert len(pairs) == 2
    yield pairs
    ref.close()
    port.close()


FILTERS = [
    {"term": {"tag": "t3"}}, {"term": {"tag": "red"}},
    {"term": {"tag": "absent"}}, {"term": {"name": "ALICE"}},
    {"term": {"age": 42}}, {"term": {"age": "17"}},
    {"term": {"price": 1.5}}, {"term": {"when": "2024-01-05T00:00:00Z"}},
    {"term": {"flag": True}}, {"term": {"flag": "false"}},
    {"term": {"_id": "42"}}, {"term": {"_id": "7"}},
    {"term": {"title": "brown"}}, {"term": {"title": "cat"}},
    {"term": {"obj.b": "x1"}},
    {"terms": {"tag": ["t1", "t2", "blue"]}}, {"terms": {"tag": []}},
    {"terms": {"name": ["bob", "Carol"]}}, {"terms": {"age": [1, 2, 3, 99]}},
    {"terms": {"_id": ["1", "2", "150", "nope"]}},
    {"terms": {"title": ["lazy", "fox"]}},
    {"range": {"age": {"gte": 20, "lt": 80}}},
    {"range": {"age": {"gt": 30, "lte": 40}}}, {"range": {"age": {"lt": 0}}},
    {"range": {"big": {"gte": I64_MIN, "lte": -1}}},
    {"range": {"big": {"gt": 2**31 - 1}}},
    {"range": {"big": {"gte": -(2**31), "lt": 2**31}}},
    {"range": {"big": {"lte": I64_MAX}}},
    {"range": {"price": {"gte": -1.5, "lte": 2.25}}},
    {"range": {"price": {"gt": 0}}},
    {"range": {"when": {"gte": "2024-01-10T00:00:00Z",
                        "lt": "2024-01-20T00:00:00Z"}}},
    {"range": {"when": {"lte": 1704412800000}}},
    {"range": {"tag": {"gte": "t2", "lt": "t5"}}},
    {"range": {"tag": {"gt": "zzz"}}},
    {"exists": {"field": "age"}}, {"exists": {"field": "tag"}},
    {"exists": {"field": "title"}}, {"exists": {"field": "v"}},
    {"exists": {"field": "nothing"}}, {"exists": {"field": "obj"}},
    {"ids": {"values": ["0", "5", "7", "200", "missing"]}},
    {"bool": {"filter": [{"range": {"age": {"gte": 20, "lt": 80}}},
                         {"terms": {"tag": ["t0", "t1", "t2", "t3"]}}]}},
    {"bool": {"filter": [{"range": {"age": {"gte": 30, "lt": 40}}},
                         {"term": {"tag": "t1"}}],
              "must_not": [{"term": {"name": "bob"}}]}},
    {"bool": {"should": [{"term": {"tag": "t1"}}, {"term": {"tag": "t2"}},
                         {"range": {"age": {"lt": 50}}}],
              "minimum_should_match": 2}},
    {"bool": {"should": [{"term": {"tag": "t1"}}, {"term": {"flag": True}}]}},
    {"bool": {"must": [{"exists": {"field": "price"}}],
              "should": [{"term": {"tag": "t4"}}]}},
    {"bool": {"must_not": [{"exists": {"field": "tag"}}]}},
    {"constant_score": {"filter": {"term": {"tag": "t5"}}}},
    {"match_all": {}}, {"match_none": {}},
]


@pytest.mark.parametrize("body", FILTERS, ids=lambda b: str(b)[:60])
def test_filter_mask_matches_reference(segments, body):
    rnode = jax_dsl.parse_query(body)
    pnode = torch_dsl.parse_query(body)
    for ref_ex, port_ex in segments:
        want = np.asarray(ref_ex.execute(rnode).mask)
        got = port_ex.execute(pnode).mask
        assert got.dtype == torch.bool and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("body", [
    {"nested": {"path": "obj", "query": {"match_all": {}}}},
    {"geo_distance": {"distance": "10km", "loc": {"lat": 0, "lon": 0}}},
    {"bool": {"filter": [{"more_like_this": {"fields": ["title"],
                                             "like": "brown"}}]}}])
def test_other_nodes_in_a_knn_filter_raise(segments, body):
    node = torch_dsl.parse_query(body)
    _ref, port_ex = segments[0]
    with pytest.raises(NotImplementedError, match="not yet ported"):
        port_ex.execute(node)


def test_filter_columns_are_on_the_device_and_counted(segments):
    _ref, port_ex = segments[0]
    dev = port_ex.dev
    assert {"tag", "name", "obj.b"} <= set(dev.keyword_fields)
    assert {"age", "big", "price", "when", "flag", "obj.a"} <= set(
        dev.numeric_fields)
    assert "title" in dev.text_fields
    nbytes = dev.column_nbytes()
    assert set(nbytes) == {"vector", "keyword", "numeric", "text", "live"}
    assert nbytes["vector"] == dev.n_pad * (4 * 4 + 4 + 1)
    assert nbytes["live"] == dev.n_pad
    assert all(v > 0 for v in nbytes.values())
