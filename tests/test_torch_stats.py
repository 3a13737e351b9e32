"""The node's stats surface on the port against the reference.

`_stats` (every metric, `level`, `groups`, `fields`), `_nodes` info and
`_nodes/stats` by metric and index metric, `_cluster/stats`, `_segments`
and `_prometheus/metrics`, each through both packages' handlers on a
TpuNode and a TorchNode(device="cpu") that took the same writes and kNN
searches: equal as JSON, with the named volatile fields left out (the
masks of tests/test_torch_rest.py: NODE_VOLATILE, NODE_DIFFERENT and
`*time_in_millis`), and the Prometheus text equal series by series (names,
labels and counter values) outside the named families.

The search counters: after the same kNN searches (on the port the stacked
step, which bypasses the per-shard executor), `query_total` and
`fetch_total` move index by index as the reference's do, once a search
whatever its route and shard count, with the request's stat groups.

A stats read launches nothing and calibrates nothing: no K1 call, no
roofline measurement, across every read.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.rest import handlers as ref_handlers
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.ops import knn_fused
from opensearch_tpu_torch.rest import handlers as port_handlers
from opensearch_tpu_torch.search import distributed_serving
from opensearch_tpu_torch.telemetry import roofline

from test_torch_rest import (
    _no_commit_ids,
    _no_node_probes,
    _no_prom_values,
    _no_timings,
    _strip,
)
from test_torch_scroll_pit import Pair, observe

DIM = 8


def _h(node):
    return port_handlers if isinstance(node, TorchNode) else ref_handlers


def _seed(node):
    rng = np.random.default_rng(17)
    vecs = rng.standard_normal((90, DIM)).astype(np.float32).round(4)
    mapping = {"properties": {
        "v": {"type": "knn_vector", "dimension": DIM},
        "tag": {"type": "keyword"}, "views": {"type": "long"},
        "title": {"type": "text", "fielddata": True}}}
    node.create_index("a", {"settings": {"number_of_shards": 1},
                            "mappings": mapping})
    node.create_index("b", {"settings": {"number_of_shards": 3,
                                         "number_of_replicas": 0},
                            "mappings": mapping})
    for name, lo in (("a", 0), ("b", 40)):
        node.bulk([("index", {"_index": name, "_id": str(i)},
                    {"v": vecs[i].tolist(), "tag": ("x", "y")[i % 2],
                     "views": i, "title": f"doc {i}"})
                   for i in range(lo, lo + 40)], refresh=True)
    node.delete_doc("a", "3", refresh=True)
    return vecs


def _searches(node, vecs):
    for i in range(4):
        node.search("a", {"query": {"knn": {"v": {
            "vector": vecs[i].tolist(), "k": 5}}}})
    node.search("b", {"query": {"knn": {"v": {"vector": vecs[5].tolist(),
                                              "k": 10}}},
                      "stats": ["kNN", "front"]})
    node.search("a,b", {"query": {"knn": {"v": {"vector": vecs[6].tolist(),
                                                "k": 3}}}, "stats": ["kNN"]})
    node.search("*", {"query": {"match": {"title": "doc"}}})
    node.count("b")
    node.msearch([({"index": "a"}, {"query": {"knn": {"v": {
        "vector": vecs[j].tolist(), "k": 2}}}}) for j in range(3)])


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    p.close()


def test_search_counters_move_as_the_references(pair):
    """query_total / fetch_total are index-level and count each search
    once, on the stacked step as on the per-shard route."""
    def scenario(node):
        vecs = _seed(node)
        before = node.index_stats("_all", metrics=["search"])
        d0 = dict(distributed_serving.stats)
        _searches(node, vecs)
        after = node.index_stats("_all", metrics=["search"],
                                 groups="kNN,fr*")
        if isinstance(node, TorchNode):
            # the port's kNN searches took the stacked step
            assert distributed_serving.stats["distributed_searches"] > \
                d0["distributed_searches"]
        return [_no_timings(before), _no_timings(after)]

    out = pair.flow(scenario)
    search = {n: out[1]["indices"][n]["primaries"]["search"]
              for n in ("a", "b")}
    assert search["a"]["query_total"] == 4 + 1 + 1 + 3
    assert search["b"]["query_total"] == 1 + 1 + 1 + 1
    assert search["b"]["groups"]["kNN"]["query_total"] == 2
    assert search["b"]["groups"]["front"]["query_total"] == 1
    assert out[1]["_all"]["primaries"]["search"]["query_total"] == 13


STATS_CALLS = [
    ({}, {}), ({"metric": "docs"}, {}), ({"metric": "docs,store,indexing"},
                                         {}),
    ({"metric": "_all"}, {}), ({"metric": "merge"}, {}),
    ({"index": "b"}, {"level": "shards"}), ({"index": "a"},
                                            {"level": "cluster"}),
    ({"index": "a,b", "metric": "fielddata"}, {"fields": "title,tag"}),
    ({"index": "b", "metric": "completion"}, {"completion_fields": "*"}),
    ({"metric": "segments"}, {"include_segment_file_sizes": "true"}),
    ({"index": "*"}, {"human": "true"}),
    ({"metric": "docz"}, {}), ({}, {"bogus": "1"}),
    ({"index": "nope"}, {}),
]


@pytest.mark.parametrize("params,query", STATS_CALLS,
                         ids=[f"{i}" for i in range(len(STATS_CALLS))])
def test_stats_api_is_the_references(pair, params, query):
    def scenario(node):
        vecs = _seed(node)
        _searches(node, vecs)
        fn = _h(node).index_stats if "index" in params else \
            _h(node).all_stats
        return [observe(lambda: _no_commit_ids(
            fn(node, dict(params), dict(query), None)[1]))]

    pair.flow(scenario)


NODES_STATS_CALLS = [
    {}, {"metric": "indices"}, {"metric": "indices", "index_metric": "docs"},
    {"metric": "indices", "index_metric": "merge,search"},
    {"node_id": "node-0", "metric": "breaker"}, {"metric": "tasks,tail"},
    {"metric": "indexing_pressure,search_backpressure,script"},
    {"metric": "thread_pool,transport,http,discovery"},
    {"metric": "adaptive_selection,shard_indexing_pressure,shard_mesh"},
    {"metric": "_all"}, {"metric": "indeces"}, {"metric": "nope"},
]


@pytest.mark.parametrize("params", NODES_STATS_CALLS,
                         ids=[f"{i}" for i in range(len(NODES_STATS_CALLS))])
def test_nodes_stats_by_metric_is_the_references(pair, params):
    def scenario(node):
        vecs = _seed(node)
        _searches(node, vecs)
        return [observe(lambda: _no_node_probes(_h(node).nodes_stats(
            node, dict(params), {"level": "indices"}, None)[1]))]

    pair.flow(scenario)


@pytest.mark.parametrize("params,query", [
    ({}, {}), ({"node_id": "node-0"}, {}),
    ({"node_id": "settings,os"}, {}), ({"node_id": "node-0",
                                       "metric": "aggregations"}, {}),
    ({}, {"flat_settings": "true", "human": "true"}),
])
def test_nodes_info_is_the_references(pair, params, query):
    def scenario(node):
        return [_no_node_probes(_h(node).nodes_info(
            node, dict(params), dict(query), None)[1])]

    pair.flow(scenario)


def test_cluster_stats_and_segments_are_the_references(pair):
    def scenario(node):
        vecs = _seed(node)
        _searches(node, vecs)
        h = _h(node)
        return [h.cluster_stats(node, {}, {}, None)[1],
                h.indices_segments(node, {}, {}, None)[1],
                h.indices_segments(node, {"index": "b"}, {}, None)[1],
                observe(lambda: h.indices_segments(
                    node, {"index": "nope"}, {}, None))]

    out = pair.flow(scenario)
    assert out[0]["indices"]["docs"]["count"] == 79


def _prom(node, query=None):
    return _h(node).prometheus_metrics(node, {}, query or {}, None)[1]


def test_prometheus_series_are_the_references(pair):
    """Every series name, label set and counter value, outside the named
    families (`_no_prom_values`)."""
    def scenario(node):
        vecs = _seed(node)
        _searches(node, vecs)
        return [_no_prom_values(_prom(node))]

    out = pair.flow(scenario)
    assert "opensearch_tpu_search_total 11" in out[0]
    assert '# TYPE opensearch_tpu_search_took_ms histogram' in out[0]


def test_prometheus_exemplars_name_traces(tmp_path):
    """`?exemplars=true` appends an OpenMetrics exemplar to the buckets
    that hold one (trace ids and bucket counts are clocks: the port's
    alone)."""
    node = TorchNode(tmp_path, device="cpu")
    try:
        vecs = _seed(node)
        _searches(node, vecs)
        plain, ex = _prom(node), _prom(node, {"exemplars": "true"})
        assert "# {trace_id=" not in plain
        tagged = [x for x in ex.splitlines() if ' # {trace_id="' in x]
        assert tagged and all(x.split(" # ")[0].split("{")[0].endswith(
            "_bucket") for x in tagged)
    finally:
        node.close()


def _knn_batch_series(text: str) -> dict:
    series = {}
    for line in text.splitlines():
        if line.startswith("opensearch_tpu_knn_batch_") and "{" not in line:
            name, value = line.rsplit(" ", 1)
            series[name[len("opensearch_tpu_knn_batch_"):]] = float(value)
    return series


def test_prometheus_knn_batch_series_equal_nodes_stats(tmp_path):
    """The `opensearch_tpu_knn_batch_*` counters move as the batcher's
    snapshot `_nodes/stats/knn_batch` reports (the batcher is process-wide,
    the node's registry its metrics sink: both read before and after)."""
    node = TorchNode(tmp_path, device="cpu")
    try:
        vecs = _seed(node)

        def read():
            snap = port_handlers.nodes_stats(
                node, {"metric": "knn_batch"}, {}, None)[1]["nodes"][
                    "node-0"]["knn_batch"]
            return snap, _knn_batch_series(_prom(node))

        snap0, prom0 = read()
        distributed_serving.enabled = False  # the per-shard route batches
        try:
            _searches(node, vecs)
        finally:
            distributed_serving.enabled = True
        snap1, prom1 = read()
        dispatches = snap1["dispatches"] - snap0["dispatches"]
        assert dispatches > 0
        assert prom1["dispatches"] - prom0.get("dispatches", 0) == dispatches
        assert prom1["size_count"] - prom0.get("size_count", 0) == dispatches
        assert prom1["size_sum"] - prom0.get("size_sum", 0) == \
            snap1["merged_queries"] - snap0["merged_queries"]
    finally:
        node.close()


def test_a_stats_read_launches_and_calibrates_nothing(tmp_path, monkeypatch):
    node = TorchNode(tmp_path, device="cpu")
    try:
        vecs = _seed(node)
        _searches(node, vecs)
        calls = []
        real = knn_fused.pool_scan

        def counted(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        def no_measure(*a, **kw):
            raise AssertionError("a stats read measured the roofline")

        monkeypatch.setattr(knn_fused, "pool_scan", counted)
        monkeypatch.setattr(roofline, "_measure_peaks", no_measure)
        node.search("a", {"query": {"knn": {"v": {
            "vector": vecs[0].tolist(), "k": 3}}}})
        assert calls  # the counter sees a search's launch
        calls.clear()
        h = port_handlers
        for fn, params, query in (
                (h.nodes_stats, {}, {}),
                (h.nodes_stats, {"metric": "device,knn_batch,ingest"}, {}),
                (h.all_stats, {}, {}), (h.cluster_stats, {}, {}),
                (h.prometheus_metrics, {}, {}),
                (h.cat_indices, {}, {"format": "json"}),
                (h.cat_shards, {}, {}), (h.cat_segments, {}, {}),
                (h.cat_health, {}, {}), (h.nodes_info, {}, {}),
                (h.indices_segments, {}, {})):
            status, _body = fn(node, params, query, None)
            assert status == 200
        assert calls == []
    finally:
        node.close()


def test_strip_helpers_mask_only_what_they_name():
    assert _strip({"took": 3, "uuid": "u", "x": 1}) == {"x": 1}
    assert _no_timings({"query_time_in_millis": 5, "query_total": 2}) == {
        "query_total": 2}
    body = {"nodes": {"n": {"os": 1, "ingest": 2, "knn_batch": 3,
                            "indices": {"docs": {"count": 4}}}}}
    assert _no_node_probes(body) == {"nodes": {"n": {
        "indices": {"docs": {"count": 4}}}}}
