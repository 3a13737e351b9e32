"""Aggregations of the port (search/aggs.py, aggs_ext.py, aggs_pipeline.py
and their wiring in search/service.py) against the JAX reference, on the
CPU.

Each body runs through a TpuNode and a TorchNode(device="cpu") built from
the same bulk:

- every aggregation body of tests/test_aggs_extended.py (its ``sales``,
  ``cities`` and ``netblocks`` indices), one case per reference test, and
  the aggregation bodies of tests/test_search_e2e.py;
- a corpus of a few hundred docs made from a numpy seed, in one and in
  three shards, written in two refreshes with deletes: a multi-valued
  keyword, a long, a float, a date, a text field, an ip, a geo_point, a
  nested object and an 8-d ``knn_vector`` in eighths (every kNN score is
  exact in f32), under the scopes ``match_all``, ``match``, a ``range``
  that ``can_match`` skips on two of the three shards, ``knn`` and
  ``bool`` + ``knn``; and one small ``ivf_pq`` index built at its
  ``min_train``.

Aggregations compare equal as JSON, key and bucket order included. The
one exception is ``top_hits``' ``_score`` / ``max_score``, held at rtol
1e-6 (the BM25 tolerance of tests/test_torch_lexical.py) where BM25 adds
to the score; under the bare kNN scopes they compare bit for bit. Errors
(a bad ``buckets_path``, a parent pipeline at the top level, too many
buckets in one histogram and across nested ones, an unknown type, a
negative ``precision_threshold``) must give the same exception class,
status and message; ``terms`` on a text field, an empty bucket list in
the reference, the same answer. ``"profile": true`` must give the same
aggregation entries (names, types, descriptions, breakdown keys) with
positive times; ``_search`` and ``_msearch`` over both packages' HTTP
servers the same aggregations with ``typed_keys``.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

pytest.importorskip("jax")

from test_aggs_extended import DOCS as SALES_DOCS
from test_aggs_extended import MAPPINGS as SALES_MAPPINGS
from test_search_e2e import DOCS as E2E_DOCS
from test_search_e2e import MAPPINGS as E2E_MAPPINGS

from opensearch_tpu.node import TpuNode
from opensearch_tpu_torch.common.hashing import shard_id_for_routing
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.search import distributed_serving as torch_serving
from opensearch_tpu_torch.search import executor as torch_executor

RTOL = 1e-6
SCORE_KEYS = ("_score", "max_score")

CITIES = [
    ("nyc", 40.7128, -74.0060, 8_623_000),
    ("la", 34.0522, -118.2437, 4_000_000),
    ("chi", 41.8781, -87.6298, 2_716_000),
    ("sf", 37.7749, -122.4194, 884_000),
]

N_CORPUS = 300
CORPUS_DELETED = ("4", "77", "150", "211", "299")
CORPUS_MAPPINGS = {"properties": {
    "seq": {"type": "long"}, "tags": {"type": "keyword"},
    "views": {"type": "long"}, "price": {"type": "float"},
    "ts": {"type": "date"}, "body": {"type": "text"},
    "ip": {"type": "ip"}, "loc": {"type": "geo_point"},
    "comments": {"type": "nested", "properties": {
        "author": {"type": "keyword"}, "stars": {"type": "long"}}},
    "v": {"type": "knn_vector", "dimension": 8}}}
ANN_METHOD = {"name": "ivf_pq",
              "parameters": {"nlist": 4, "m": 2, "nprobe": 4,
                             "min_train": 128}}


def _word(i: int) -> str:
    letters = "abcdefghijklmnopqrstuvwxyz"
    out = ""
    i += 27
    while i:
        out = letters[i % 26] + out
        i //= 26
    return out


WORDS = [_word(i) for i in range(30)]


def corpus_docs(seed: int = 7) -> list[dict]:
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(N_CORPUS):
        tags = [f"g{int(t)}" for t in rng.integers(0, 9, rng.integers(1, 4))]
        doc = {
            "seq": i,
            "tags": tags if len(tags) > 1 else tags[0],
            "views": int(rng.integers(0, 500)),
            "price": float(rng.integers(0, 4000)) / 16.0,
            "ts": int(1_704_067_200_000
                      + int(rng.integers(0, 200)) * 86_400_000
                      + int(rng.integers(0, 86_400)) * 1000),
            "body": " ".join(WORDS[int(w)] for w in
                             rng.zipf(1.4, int(rng.integers(2, 9))) % 30),
            "ip": (f"10.{int(rng.integers(0, 4))}.{int(rng.integers(0, 256))}"
                   f".{int(rng.integers(1, 255))}"),
            "loc": {"lat": float(rng.integers(-800, 800)) / 10.0,
                    "lon": float(rng.integers(-1700, 1700)) / 10.0},
            "comments": [{"author": f"a{int(rng.integers(0, 5))}",
                          "stars": int(rng.integers(1, 6))}
                         for _ in range(int(rng.integers(0, 3)))],
            "v": (rng.integers(-8, 9, 8) / 8.0).tolist(),
        }
        if i % 7 == 3:
            del doc["views"]
        if i % 11 == 5:
            del doc["price"]
        docs.append(doc)
    return docs


def _routing_for_shard(shard: int, n_shards: int = 3) -> str:
    """A routing value that lands on `shard` (the reference's hash)."""
    for j in range(1000):
        if shard_id_for_routing(f"r{j}", n_shards) == shard:
            return f"r{j}"
    raise AssertionError("no routing value found")


def _build(node, docs: list[dict]) -> None:
    node.create_index("sales", {"settings": {"number_of_shards": 2},
                                "mappings": SALES_MAPPINGS})
    for d in SALES_DOCS:
        doc = dict(d)
        node.index_doc("sales", doc.pop("id"), doc)
    node.refresh("sales")
    node.create_index("items", {"settings": {"number_of_shards": 2},
                                "mappings": E2E_MAPPINGS})
    for d in E2E_DOCS:
        doc = dict(d)
        node.index_doc("items", doc.pop("id"), doc)
    node.refresh("items")
    node.create_index("cities", {"mappings": {"properties": {
        "location": {"type": "geo_point"}, "population": {"type": "long"}}}})
    node.bulk([("index", {"_index": "cities", "_id": cid},
                {"location": {"lat": lat, "lon": lon}, "population": pop})
               for cid, lat, lon, pop in CITIES], refresh=True)
    node.create_index("netblocks", {"mappings": {"properties": {
        "block": {"type": "ip_range"}}}})
    node.bulk([
        ("index", {"_index": "netblocks", "_id": "v6"},
         {"block": {"gte": "2001:db8::1", "lte": "2001:db8::ffff"}}),
        ("index", {"_index": "netblocks", "_id": "v4single"},
         {"block": "192.168.0.7"})], refresh=True)
    # the seeded corpus: c3's docs are routed by thirds of seq, so a range
    # on seq's last third is one that can_match skips on two shards
    routes = [_routing_for_shard(s) for s in range(3)]
    for name, shards in (("c1", 1), ("c3", 3)):
        node.create_index(name, {"settings": {"number_of_shards": shards},
                                 "mappings": CORPUS_MAPPINGS})
        ops = []
        for i, d in enumerate(docs):
            meta = {"_index": name, "_id": str(i)}
            if shards == 3:
                meta["routing"] = routes[i * 3 // N_CORPUS]
            ops.append(("index", meta, d))
        half = len(ops) // 2
        node.bulk(ops[:half])
        node.refresh(name)
        deletes = []
        for d in CORPUS_DELETED:
            meta = {"_index": name, "_id": d}
            if shards == 3:
                meta["routing"] = routes[int(d) * 3 // N_CORPUS]
            deletes.append(("delete", meta, None))
        node.bulk(ops[half:] + deletes)
        node.refresh(name)
    node.create_index("ann", {"mappings": {"properties": {
        "v": {"type": "knn_vector", "dimension": 8, "method": ANN_METHOD},
        "tags": {"type": "keyword"}, "views": {"type": "long"}}}})
    rng = np.random.default_rng(3)
    data = rng.standard_normal((ANN_METHOD["parameters"]["min_train"], 8))
    node.bulk([("index", {"_index": "ann", "_id": str(i)},
                {"v": data[i].round(3).tolist(), "tags": f"g{i % 5}",
                 "views": int(i * 7 % 100)})
               for i in range(len(data))], refresh=True)


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    docs = corpus_docs()
    ref = TpuNode(tmp_path_factory.mktemp("tpu"))
    port = TorchNode(tmp_path_factory.mktemp("torch"), device="cpu")
    for node in (ref, port):
        _build(node, docs)
    yield ref, port
    ref.close()
    port.close()


def assert_same(want, got, rtol: float = RTOL, path: str = "") -> None:
    """JSON equality, key and list order included; the top_hits scores at
    `rtol` (0: bit for bit)."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert list(got) == list(want), path
        for k in want:
            if k in SCORE_KEYS and want[k] is not None and rtol:
                assert got[k] is not None, f"{path}.{k}"
                assert math.isclose(got[k], want[k], rel_tol=rtol), \
                    (f"{path}.{k}", want[k], got[k])
            else:
                assert_same(want[k], got[k], rtol, f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_same(w, g, rtol, f"{path}[{i}]")
    elif isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got), path
    else:
        assert type(got) is type(want) and got == want, (path, want, got)


def _both(nodes, index: str, body: dict, rtol: float = RTOL) -> tuple:
    ref, port = nodes
    want = ref.search(index, body)
    got = port.search(index, body)
    assert_same(want["hits"]["total"], got["hits"]["total"])
    assert_same(want.get("aggregations"), got.get("aggregations"), rtol)
    return want, got


# -- tests/test_aggs_extended.py: one case per reference test ----------------

def _sales(aggs: dict) -> dict:
    return {"size": 0, "aggs": aggs}


_MONTHS = {"date_histogram": {"field": "created",
                              "calendar_interval": "month"}}

EXTENDED_CASES = {
    "test_extended_stats": ("sales", [
        _sales({"s": {"extended_stats": {"field": "price"}}})]),
    "test_percentiles_and_ranks": ("sales", [
        _sales({"p": {"percentiles": {"field": "price",
                                      "percents": [50, 95]}}}),
        _sales({"p": {"percentile_ranks": {"field": "price",
                                           "values": [30]}}})]),
    "test_median_absolute_deviation": ("sales", [
        _sales({"m": {"median_absolute_deviation": {"field": "price"}}})]),
    "test_weighted_avg": ("sales", [
        _sales({"w": {"weighted_avg": {"value": {"field": "price"},
                                       "weight": {"field": "qty"}}}})]),
    "test_top_hits_in_terms": ("sales", [
        _sales({"tags": {
            "terms": {"field": "tag", "order": {"_key": "asc"}},
            "aggs": {"top": {"top_hits": {
                "size": 1, "sort": [{"price": {"order": "desc"}}]}}}}})]),
    "test_scripted_metric": ("sales", [
        _sales({"t": {"scripted_metric": {
            "init_script": "state.total = 0",
            "map_script": "state.total += doc['price'].value",
            "combine_script": "return state.total",
            "reduce_script": (
                "def s = 0; for (t in states) { s += t } return s")}}})]),
    "test_matrix_stats": ("sales", [
        _sales({"mx": {"matrix_stats": {"fields": ["price", "qty"]}}})]),
    "test_multi_terms": ("sales", [
        _sales({"mt": {"multi_terms": {
            "terms": [{"field": "tag"}, {"field": "color"}]}}})]),
    "test_rare_terms": ("sales", [
        _sales({"r": {"rare_terms": {"field": "color"}}})]),
    "test_significant_terms": ("sales", [{
        "size": 0, "query": {"match": {"title": "quick"}},
        "aggs": {"sig": {"significant_terms": {
            "field": "color", "min_doc_count": 1}}}}]),
    "test_sampler_and_diversified": ("sales", [
        _sales({"s": {"sampler": {"shard_size": 3},
                      "aggs": {"mx": {"max": {"field": "price"}}}}}),
        _sales({"s": {"diversified_sampler": {
            "shard_size": 5, "field": "color", "max_docs_per_value": 1},
            "aggs": {"c": {"value_count": {"field": "price"}}}}})]),
    "test_adjacency_matrix": ("sales", [
        _sales({"adj": {"adjacency_matrix": {"filters": {
            "cheap": {"range": {"price": {"lte": 20}}},
            "red": {"term": {"color": "red"}}}}}})]),
    "test_date_range_with_date_math": ("sales", [
        _sales({"dr": {"date_range": {"field": "created", "ranges": [
            {"to": "2024-02-01"}, {"from": "2024-02-01"},
            {"from": "2024-01-01||+1M/M", "key": "feb_onward"}]}}})]),
    "test_composite_pagination": ("sales", [
        _sales({"c": {"composite": {"size": 2, "sources": [
            {"t": {"terms": {"field": "tag"}}},
            {"col": {"terms": {"field": "color"}}}]}}})]),
    "test_composite_with_sub_aggs": ("sales", [
        _sales({"c": {"composite": {"size": 10, "sources": [
            {"t": {"terms": {"field": "tag"}}}]},
            "aggs": {"total": {"sum": {"field": "price"}}}}})]),
    "test_auto_date_histogram": ("sales", [
        _sales({"h": {"auto_date_histogram": {"field": "created",
                                              "buckets": 5}}})]),
    "test_histogram_empty_bucket_fill": ("sales", [
        _sales({"h": {"histogram": {"field": "price", "interval": 10,
                                    "min_doc_count": 0}}}),
        _sales({"h": {"histogram": {
            "field": "price", "interval": 10, "min_doc_count": 0,
            "extended_bounds": {"min": 0, "max": 70}}}})]),
    "test_sibling_pipelines": ("sales", [_sales({
        "months": {**_MONTHS, "aggs": {"sales": {"sum": {"field": "price"}}}},
        "avg_monthly": {"avg_bucket": {"buckets_path": "months>sales"}},
        "max_monthly": {"max_bucket": {"buckets_path": "months>sales"}},
        "total": {"sum_bucket": {"buckets_path": "months>sales"}},
        "stats_m": {"stats_bucket": {"buckets_path": "months>sales"}}})]),
    "test_parent_pipelines": ("sales", [_sales({"months": {**_MONTHS, "aggs": {
        "sales": {"sum": {"field": "price"}},
        "cum": {"cumulative_sum": {"buckets_path": "sales"}},
        "deriv": {"derivative": {"buckets_path": "sales"}},
        "diff": {"serial_diff": {"buckets_path": "sales", "lag": 1}}}}})]),
    "test_moving_fn": ("sales", [_sales({"months": {**_MONTHS, "aggs": {
        "sales": {"sum": {"field": "price"}},
        "mov": {"moving_fn": {
            "buckets_path": "sales", "window": 2,
            "script": "MovingFunctions.unweightedAvg(values)"}}}}})]),
    "test_bucket_script_and_selector": ("sales", [_sales({"tags": {
        "terms": {"field": "tag", "order": {"_key": "asc"}},
        "aggs": {
            "sales": {"sum": {"field": "price"}},
            "per_doc": {"bucket_script": {
                "buckets_path": {"s": "sales", "n": "_count"},
                "script": "params.s / params.n"}},
            "keep_big": {"bucket_selector": {
                "buckets_path": {"s": "sales"},
                "script": "params.s > 40"}}}}})]),
    "test_bucket_sort": ("sales", [_sales({"tags": {
        "terms": {"field": "tag", "order": {"_key": "asc"}},
        "aggs": {"sales": {"sum": {"field": "price"}},
                 "srt": {"bucket_sort": {
                     "sort": [{"sales": {"order": "desc"}}],
                     "size": 2}}}}})]),
    "test_geo_distance_agg": ("cities", [_sales({"rings": {"geo_distance": {
        "field": "location", "origin": "35.7796, -78.6382",
        "ranges": [{"to": 1_000_000}, {"from": 1_000_000, "to": 5_000_000},
                   {"from": 5_000_000}]}}})]),
    "test_geo_distance_agg_km_unit": ("cities", [_sales({"rings": {
        "geo_distance": {"field": "location", "origin": "35.7796, -78.6382",
                         "unit": "km",
                         "ranges": [{"to": 1000}, {"from": 1000}]}}})]),
    "test_geohash_and_geotile_grid": ("cities", [
        _sales({"cells": {"geohash_grid": {"field": "location",
                                           "precision": 3}}}),
        _sales({"cells": {"geotile_grid": {"field": "location",
                                           "precision": 6}}})]),
    "test_geo_bounds_and_centroid": ("cities", [_sales({
        "box": {"geo_bounds": {"field": "location"}},
        "mid": {"geo_centroid": {"field": "location"}}})]),
    "test_range_field_ipv6_and_open_bounds": ("netblocks", [
        {"query": {"range": {"block": {"gte": "2001:db8::5"}}}},
        {"query": {"range": {"block": {"gte": "192.168.0.7",
                                       "lte": "192.168.0.7"}}}},
        _sales({"n": {"value_count": {"field": "block"}}})]),
}


def _hit_ids(resp: dict) -> list:
    return [h["_id"] for h in resp["hits"]["hits"]]


@pytest.mark.parametrize("case", list(EXTENDED_CASES))
def test_extended_aggs_case(nodes, case):
    index, bodies = EXTENDED_CASES[case]
    for body in bodies:
        want, got = _both(nodes, index, body)
        assert _hit_ids(got) == _hit_ids(want)


def test_composite_pages_to_the_end(nodes):
    """Each node pages the composite with its own previous after_key."""
    ref, port = nodes
    conf = {"size": 2, "sources": [{"t": {"terms": {"field": "tag"}}},
                                   {"col": {"terms": {"field": "color"}}}]}
    after = {"ref": None, "port": None}
    pages = 0
    while True:
        outs = {}
        for name, node in (("ref", ref), ("port", port)):
            c = dict(conf)
            if after[name] is not None:
                c["after"] = after[name]
            outs[name] = node.search("sales", _sales(
                {"c": {"composite": c}}))["aggregations"]["c"]
        assert_same(outs["ref"], outs["port"])
        pages += 1
        if not outs["ref"]["buckets"]:
            break
        after = {k: v.get("after_key") for k, v in outs.items()}
        if after["ref"] is None:
            break
    assert pages >= 3


# -- tests/test_search_e2e.py's aggregation bodies ---------------------------

E2E_CASES = {
    "test_aggs_terms_with_sub": [{"size": 0, "aggs": {"by_tag": {
        "terms": {"field": "tag"},
        "aggs": {"avg_price": {"avg": {"field": "price"}}}}}}],
    "test_aggs_metrics_and_query_scoped": [{
        "size": 0, "query": {"term": {"tag": "animal"}},
        "aggs": {"stats_price": {"stats": {"field": "price"}},
                 "n_tags": {"cardinality": {"field": "tag"}}}}],
    "test_aggs_histogram_and_date_histogram": [{"size": 0, "aggs": {
        "price_hist": {"histogram": {"field": "price", "interval": 20}},
        "monthly": {"date_histogram": {"field": "created",
                                       "calendar_interval": "month"}}}}],
    "test_aggs_range_and_filter": [{"size": 0, "aggs": {
        "price_ranges": {"range": {"field": "price", "ranges": [
            {"to": 20}, {"from": 20, "to": 40}, {"from": 40}]}},
        "cheap_animals": {"filter": {"term": {"tag": "animal"}},
                          "aggs": {"max_price": {"max": {"field": "price"}}}}}}],
    "test_terms_agg_order_by_subagg_and_key": [
        {"size": 0, "aggs": {"by_tag": {
            "terms": {"field": "tag", "order": {"avg_price": "desc"}},
            "aggs": {"avg_price": {"avg": {"field": "price"}}}}}},
        {"size": 0, "aggs": {"by_tag": {
            "terms": {"field": "tag", "order": {"_key": "asc"}}}}}],
    "test_date_histogram_offset_duration": [{"size": 0, "aggs": {"d": {
        "date_histogram": {"field": "created", "fixed_interval": "30d",
                           "offset": "6h"}}}}],
    "test_profile_agg_timings_are_real": [{
        "size": 0, "query": {"match_all": {}},
        "aggs": {"tags": {"terms": {"field": "tag"}},
                 "avg_price": {"avg": {"field": "price"}}}}],
}


@pytest.mark.parametrize("case", list(E2E_CASES))
def test_e2e_aggs_case(nodes, case):
    for body in E2E_CASES[case]:
        _both(nodes, "items", body)


# -- the seeded corpus under every scope -------------------------------------

Q8 = [0.5, -0.25, 0.125, 1.0, -0.5, 0.0, 0.75, -0.125]
KNN = {"knn": {"v": {"vector": Q8, "k": 25}}}
SCOPES = {
    "match_all": {"match_all": {}},
    "match": {"match": {"body": f"{WORDS[6]} {WORDS[11]}"}},
    "range": {"range": {"seq": {"gte": 2 * N_CORPUS // 3 + 5}}},
    "knn": KNN,
    "bool_knn": {"bool": {"should": [{"match": {"body": WORDS[2]}}, KNN]}},
}
# the scopes whose top_hits scores are kNN's alone (eighths: exact)
EXACT_SCOPES = ("match_all", "range", "knn")

AGG_GROUPS = {
    "metrics": {
        "mn": {"min": {"field": "price"}}, "mx": {"max": {"field": "ts"}},
        "sm": {"sum": {"field": "views"}}, "av": {"avg": {"field": "price"}},
        "vc": {"value_count": {"field": "tags"}},
        "st": {"stats": {"field": "views"}},
        "es": {"extended_stats": {"field": "price"}},
        "card_tags": {"cardinality": {"field": "tags"}},
        "card_views": {"cardinality": {"field": "views"}},
        "card_ip": {"cardinality": {"field": "ip"}},
        "pc": {"percentiles": {"field": "views",
                               "percents": [1, 25, 50, 75, 99]}},
        "pr": {"percentile_ranks": {"field": "price", "values": [50, 200]}},
        "mad": {"median_absolute_deviation": {"field": "views"}},
        "wa": {"weighted_avg": {"value": {"field": "price"},
                                "weight": {"field": "views"}}},
        "mxs": {"matrix_stats": {"fields": ["views", "price"]}},
    },
    "buckets": {
        "tags": {"terms": {"field": "tags", "order": {"avg_views": "desc"}},
                 "aggs": {"avg_views": {"avg": {"field": "views"}}}},
        "tags_key": {"terms": {"field": "tags", "size": 4,
                               "order": {"_key": "desc"}}},
        "views_terms": {"terms": {"field": "views", "size": 5}},
        "vh": {"histogram": {"field": "views", "interval": 50}},
        "ph": {"histogram": {"field": "price", "interval": 25,
                             "min_doc_count": 0}},
        "months": {"date_histogram": {"field": "ts",
                                      "calendar_interval": "month"}},
        "days": {"date_histogram": {
            "field": "ts", "fixed_interval": "1d", "min_doc_count": 0,
            "extended_bounds": {"min": "2024-01-01", "max": "2024-08-01"}}},
        "pr": {"range": {"field": "price", "ranges": [
            {"to": 50}, {"from": 50, "to": 150}, {"from": 150}]}},
        "dr": {"date_range": {"field": "ts", "ranges": [
            {"to": "2024-03-01"}, {"from": "2024-03-01", "to": "2024-05-01"},
            {"from": "2024-05-01"}]}},
        "ipr": {"ip_range": {"field": "ip", "ranges": [
            {"to": "10.1.0.0"}, {"from": "10.1.0.0", "to": "10.3.0.0"},
            {"from": "10.3.0.0"}]}},
        "no_views": {"missing": {"field": "views"}},
        "f": {"filter": {"range": {"views": {"gte": 250}}},
              "aggs": {"t": {"terms": {"field": "tags"}}}},
        "fs": {"filters": {"filters": {
            "one": {"match": {"body": WORDS[1]}},
            "two": {"match": {"body": WORDS[3]}}},
            "other_bucket": True}},
        "all": {"global": {}, "aggs": {"n": {"value_count": {
            "field": "seq"}}}},
    },
    "ext": {
        "mt": {"multi_terms": {"terms": [{"field": "tags"},
                                         {"field": "views"}], "size": 6}},
        "rare": {"rare_terms": {"field": "tags", "max_doc_count": 40}},
        "sig": {"significant_terms": {"field": "tags", "min_doc_count": 1}},
        "samp": {"sampler": {"shard_size": 20},
                 "aggs": {"m": {"max": {"field": "views"}}}},
        "div": {"diversified_sampler": {"shard_size": 30, "field": "tags",
                                        "max_docs_per_value": 2},
                "aggs": {"c": {"value_count": {"field": "seq"}}}},
        "adj": {"adjacency_matrix": {"filters": {
            "cheap": {"range": {"price": {"lte": 60}}},
            "busy": {"range": {"views": {"gte": 300}}},
            "g1": {"term": {"tags": "g1"}}}}},
        "comp": {"composite": {"size": 500, "sources": [
            {"t": {"terms": {"field": "tags"}}},
            {"m": {"date_histogram": {"field": "ts",
                                      "calendar_interval": "month"}}}]},
            "aggs": {"v": {"sum": {"field": "views"}}}},
        "auto": {"auto_date_histogram": {"field": "ts", "buckets": 6}},
    },
    "geo_nested": {
        "gh": {"geohash_grid": {"field": "loc", "precision": 2}},
        "gt": {"geotile_grid": {"field": "loc", "precision": 3}},
        "gb": {"geo_bounds": {"field": "loc"}},
        "gc": {"geo_centroid": {"field": "loc"}},
        "gd": {"geo_distance": {"field": "loc", "origin": "10.0, 20.0",
                                "unit": "km", "ranges": [
                                    {"to": 3000}, {"from": 3000, "to": 8000},
                                    {"from": 8000}]}},
        "cm": {"nested": {"path": "comments"}, "aggs": {
            "authors": {"terms": {"field": "comments.author"},
                        "aggs": {"stars": {"avg": {
                            "field": "comments.stars"}},
                                 "back": {"reverse_nested": {}, "aggs": {
                                     "v": {"max": {"field": "views"}}}}}}}},
    },
    "pipelines": {
        "months": {"date_histogram": {"field": "ts",
                                      "calendar_interval": "month"},
                   "aggs": {
                       "v": {"sum": {"field": "views"}},
                       "cum": {"cumulative_sum": {"buckets_path": "v"}},
                       "der": {"derivative": {"buckets_path": "v"}},
                       "mov": {"moving_fn": {
                           "buckets_path": "v", "window": 3,
                           "script": "MovingFunctions.unweightedAvg(values)"}},
                       "per": {"bucket_script": {
                           "buckets_path": {"s": "v", "n": "_count"},
                           "script": "params.s / params.n"}},
                       "sel": {"bucket_selector": {
                           "buckets_path": {"n": "_count"},
                           "script": "params.n > 1"}},
                       "srt": {"bucket_sort": {
                           "sort": [{"v": {"order": "desc"}}],
                           "size": 4}}}},
        "avg_m": {"avg_bucket": {"buckets_path": "months>v"}},
        "max_m": {"max_bucket": {"buckets_path": "months>v"}},
        "stats_m": {"stats_bucket": {"buckets_path": "months>v"}},
        "pct_m": {"percentiles_bucket": {"buckets_path": "months>v"}},
    },
    "top_hits": {
        "tags": {"terms": {"field": "tags", "size": 5}, "aggs": {
            "top": {"top_hits": {"size": 3}},
            "by_views": {"top_hits": {
                "size": 2, "sort": [{"views": {"order": "desc"}}],
                "_source": ["seq", "views"]}}}},
        "sm": {"scripted_metric": {
            "init_script": "state.n = 0",
            "map_script": "state.n += 1",
            "combine_script": "return state.n",
            "reduce_script": "def s = 0; for (t in states) { s += t } "
                             "return s"}},
    },
}


@pytest.mark.parametrize("group", list(AGG_GROUPS))
@pytest.mark.parametrize("scope", list(SCOPES))
@pytest.mark.parametrize("index", ["c1", "c3"])
def test_corpus_scope(nodes, index, scope, group):
    body = {"size": 0, "query": SCOPES[scope], "aggs": AGG_GROUPS[group],
            "pre_filter_shard_size": 1}
    want, got = _both(nodes, index, body,
                      rtol=0 if scope in EXACT_SCOPES else RTOL)
    assert got["_shards"] == want["_shards"]
    if index == "c3" and scope == "range":
        assert got["_shards"]["skipped"] == 2


def test_bare_knn_with_aggs_takes_the_per_shard_route(nodes):
    """A bare knn with aggs declines the stacked step (it returns no
    masks) and its kNN runs on the per-shard route."""
    _ref, port = nodes
    before = dict(torch_serving.stats)
    fused = torch_executor.knn_path_stats["fused"]
    body = {"size": 0, "query": KNN, "aggs": AGG_GROUPS["buckets"]}
    _both(nodes, "c3", body, rtol=0)
    assert torch_serving.stats == before
    assert torch_executor.knn_path_stats["fused"] > fused
    # without aggs the same query takes the stacked step
    port.search("c3", {"size": 3, "query": KNN})
    assert (torch_serving.stats["distributed_searches"]
            == before["distributed_searches"] + 1)


def test_hits_and_aggs_in_one_body(nodes):
    body = {"size": 7, "query": SCOPES["bool_knn"],
            "aggs": AGG_GROUPS["top_hits"]}
    want, got = _both(nodes, "c3", body)
    assert _hit_ids(got) == _hit_ids(want)


@pytest.mark.parametrize("group", ["buckets", "top_hits"])
def test_ann_scope(nodes, group):
    """kNN + aggs on an IVF-PQ column (the ANN route)."""
    ann = torch_executor.knn_path_stats["ann"]
    q = np.random.default_rng(9).standard_normal(8).round(3).tolist()
    aggs = ({"t": {"terms": {"field": "tags"}},
             "h": {"histogram": {"field": "views", "interval": 10}}}
            if group == "buckets" else
            {"t": {"terms": {"field": "tags"},
                   "aggs": {"top": {"top_hits": {"size": 2}}}}})
    body = {"size": 0, "query": {"knn": {"v": {"vector": q, "k": 20}}},
            "aggs": aggs}
    ref, port = nodes
    want = ref.search("ann", body)
    got = port.search("ann", body)
    # the ANN rescore's l2 form rounds apart by a few ulps (the tolerance
    # of tests/test_torch_node_ann.py); everything else is equal
    assert_same(want["aggregations"], got["aggregations"], rtol=1e-5)
    assert torch_executor.knn_path_stats["ann"] > ann


# -- errors -------------------------------------------------------------------

# (index, body, whether the reference raises): a terms aggregation on a
# text field is an empty bucket list in the reference, not an error
ERROR_CASES = {
    "bad_buckets_path": ("sales", _sales({
        "months": {**_MONTHS, "aggs": {"s": {"sum": {"field": "price"}}}},
        "a": {"avg_bucket": {"buckets_path": "months>nope"}}}), True),
    "parent_pipeline_at_top": ("sales", _sales({
        "d": {"derivative": {"buckets_path": "x"}}}), True),
    "terms_on_text": ("sales", _sales({"t": {"terms": {"field": "title"}}}),
                      False),
    "too_many_buckets": ("c1", _sales({"h": {"histogram": {
        "field": "views", "interval": 0.001, "min_doc_count": 0}}}), True),
    # each histogram under the limit, their buckets together over it: the
    # service's search.max_buckets guard (503)
    "too_many_buckets_nested": ("c1", _sales({"d": {"date_histogram": {
        "field": "ts", "fixed_interval": "1d", "min_doc_count": 0},
        "aggs": {"h": {"histogram": {
            "field": "views", "interval": 1, "min_doc_count": 0,
            "extended_bounds": {"min": 0, "max": 499}}}}}}), True),
    "unknown_type": ("sales", _sales({"x": {"bogus": {"field": "price"}}}),
                     True),
    "negative_precision_threshold": ("sales", _sales({"c": {"cardinality": {
        "field": "tag", "precision_threshold": -1}}}), True),
}


def assert_same_outcome(nodes, index: str, body: dict) -> bool:
    """The port answers as the reference does, or raises the same
    exception class with the same message and status. True when the
    reference raised."""
    ref, port = nodes
    try:
        want = ref.search(index, body)
    except Exception as e:  # noqa: BLE001 - the outcome under test
        with pytest.raises(Exception) as got:
            port.search(index, body)
        assert type(got.value).__name__ == type(e).__name__
        assert str(got.value) == str(e)
        assert getattr(got.value, "status", None) == \
            getattr(e, "status", None)
        assert not isinstance(got.value, NotImplementedError)
        return True
    got = port.search(index, body)
    assert_same(want["hits"], got["hits"])
    assert_same(want.get("aggregations"), got.get("aggregations"))
    return False


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_error_is_the_references(nodes, case):
    index, body, raises = ERROR_CASES[case]
    assert assert_same_outcome(nodes, index, body) is raises


# -- profile -------------------------------------------------------------------

def _shape(entries: list) -> list:
    return [(e["type"], e["description"], sorted(e["breakdown"]),
             e.get("debug"), _shape(e.get("children", [])))
            for e in entries]


@pytest.mark.parametrize("index,body", [
    ("items", E2E_CASES["test_profile_agg_timings_are_real"][0]),
    ("c3", {"size": 0, "query": SCOPES["range"],
            "aggs": {k: AGG_GROUPS["buckets"][k]
                     for k in ("tags", "vh", "months", "pr", "f")}}),
], ids=["e2e", "corpus_range"])
def test_profile_aggregation_entries(nodes, index, body):
    ref, port = nodes
    body = {**body, "profile": True}
    want, got = _both(nodes, index, body)
    w_shards = want["profile"]["shards"]
    g_shards = got["profile"]["shards"]
    assert [s["id"] for s in g_shards] == [s["id"] for s in w_shards]
    for w, g in zip(w_shards, g_shards):
        assert _shape(g["aggregations"]) == _shape(w["aggregations"])
        for e in g["aggregations"]:
            assert e["time_in_nanos"] > 0
            assert e["breakdown"]["collect"] == e["time_in_nanos"]
            assert e["breakdown"]["collect_count"] == next(
                x for x in w["aggregations"]
                if x["description"] == e["description"]
            )["breakdown"]["collect_count"]


# -- over HTTP -------------------------------------------------------------------

def test_aggs_over_http_with_typed_keys(nodes):
    """``_search`` and ``_msearch`` with aggregations over each package's
    HTTP server: the port's aggregations are the reference's, typed_keys
    prefixes included, and the port's HTTP answer is its in-process one."""
    from test_torch_rest import Client, _start_reference

    from opensearch_tpu_torch.rest.http import HttpServer

    ref, port = nodes
    body = {"size": 0, "query": SCOPES["bool_knn"], "aggs": {
        **{k: AGG_GROUPS["buckets"][k] for k in ("tags", "vh", "pr", "fs")},
        **{k: AGG_GROUPS["metrics"][k] for k in ("pc", "card_tags")},
        "sig": AGG_GROUPS["ext"]["sig"],
        "months": AGG_GROUPS["pipelines"]["months"],
        "avg_m": AGG_GROUPS["pipelines"]["avg_m"],
        "max_m": AGG_GROUPS["pipelines"]["max_m"]}}
    ref_srv, loop = _start_reference(ref)
    port_srv = HttpServer(port, "127.0.0.1", 0)
    port_srv.start_in_thread()
    try:
        out = {}
        for name, srv_port in (("ref", ref_srv.port), ("port", port_srv.port)):
            c = Client(srv_port)
            out[name] = [
                c("POST", "/c3/_search?typed_keys=true", body),
                c("POST", "/c3/_search", body),
                c("POST", "/_msearch?typed_keys=true", ndjson=[
                    {"index": "c3"}, body, {"index": "c1"},
                    {"size": 0, "query": KNN, "aggs": AGG_GROUPS["top_hits"]}]),
            ]
    finally:
        port_srv.stop_thread()
        loop.call_soon_threadsafe(loop.stop)
    (w_typed, w_plain, w_multi), (g_typed, g_plain, g_multi) = (
        out["ref"], out["port"])
    assert g_typed[0] == w_typed[0] == 200
    assert "sterms#tags" in g_typed[1]["aggregations"]
    assert_same(w_typed[1]["aggregations"], g_typed[1]["aggregations"])
    assert_same(w_plain[1]["aggregations"], g_plain[1]["aggregations"])
    assert_same(port.search("c3", body)["aggregations"],
                g_plain[1]["aggregations"], rtol=0)
    assert g_multi[0] == w_multi[0] == 200
    for w, g in zip(w_multi[1]["responses"], g_multi[1]["responses"]):
        assert g["status"] == w["status"] == 200
        assert_same(w["aggregations"], g["aggregations"])
