"""The port's shard-mesh registry and stacked serving step: the single-node
cases of tests/test_shard_mesh.py (the device merge order is the host
merge order, the stacked top-k equals the per-shard route's, refresh
generation isolation, residency hits and stats, one launch record a
profile), each against the reference's TpuNode on the same documents, and
each registry member the port gained (``configure``, ``apply_settings``,
``warm_for``, ``warm_pairs``, ``record_launch_wall``, ``resident``,
``resident_bytes``, ``snapshot_stats``, ``clear``, ``reset_stats``, the
``evicted_bytes`` / ``invalidated_bytes`` / ``fused_launches`` counters
and the eviction reasons).

The reference's cross-shard batcher case runs on both nodes: the stacked
launch rides the dispatch batcher with ``shards=``, and the batcher's
stats section (``knn_batch`` in ``_nodes/stats``) equals the reference's
after the same trace, less what ``test_torch_rest.knn_batch_trace``
leaves out (the values read off a clock and the per-shard route's tuner
keys). The premerged-reduce case waits for search/reduce.py.
"""

from __future__ import annotations

import numpy as np
import pytest

from opensearch_tpu.node import TpuNode
from opensearch_tpu.search import distributed_serving as ref_serving
from opensearch_tpu_torch.cluster.shard_mesh import (
    MESH_LAUNCH_WALL_MS,
    ShardMeshRegistry,
)
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.search import distributed_serving, query_dsl
from opensearch_tpu_torch.telemetry.device_ledger import default_ledger
from opensearch_tpu_torch.telemetry.tracing import MetricsRegistry

from test_torch_rest import knn_batch_trace

DIMS = 8


@pytest.fixture(autouse=True)
def _clear():
    distributed_serving.registry.clear()
    distributed_serving.registry.reset_stats()
    distributed_serving.enabled = True
    yield
    distributed_serving.enabled = True
    distributed_serving.registry.clear()


def _docs(n_docs, seed):
    rng = np.random.default_rng(seed)
    return [("index", {"_index": "vecs", "_id": f"d{i}"},
             {"v": rng.standard_normal(DIMS).round(3).tolist()})
            for i in range(n_docs)]


def _body(n_shards):
    return {"settings": {"number_of_shards": n_shards},
            "mappings": {"properties": {"v": {
                "type": "knn_vector", "dimension": DIMS,
                "space_type": "l2"}}}}


def _mk_nodes(tmp_path, n_shards=4, n_docs=64, seed=0):
    ref = TpuNode(tmp_path / "ref")
    port = TorchNode(tmp_path / "port", device="cpu")
    for node in (ref, port):
        node.create_index("vecs", _body(n_shards))
        node.bulk(_docs(n_docs, seed), refresh=True)
    return ref, port


def _knn(vector, k=5, size=10):
    return {"query": {"knn": {"v": {"vector": vector, "k": k}}},
            "size": size}


def _hits(resp):
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_device_merge_order_is_host_merge_order(tmp_path, n_shards):
    _ref, node = _mk_nodes(tmp_path, n_shards=n_shards)
    svc = node.indices["vecs"]
    shards = [svc.shards[i] for i in sorted(svc.shards)]
    snaps = [s.acquire_searcher() for s in shards]
    rng = np.random.default_rng(1)
    for _ in range(3):
        qnode = query_dsl.parse_query({"knn": {"v": {
            "vector": rng.standard_normal(DIMS).tolist(), "k": 5}}})
        out = distributed_serving.mesh_knn_batch(shards, snaps, [qnode], 10)
        assert out.shards == n_shards
        premerged = out.premerged[0]
        assert premerged
        rows = [(si, h) for si, res in enumerate(out.per_query[0])
                for h in res.hits]
        rows.sort(key=lambda sh: (-sh[1].score, sh[0], sh[1].segment,
                                  sh[1].doc))
        assert [(si, h.score, h.segment, h.doc) for si, h in premerged] == \
            [(si, h.score, h.segment, h.doc) for si, h in rows]
    node.close()


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_stacked_topk_is_the_references_and_the_per_shard_routes(
        tmp_path, n_shards):
    ref, node = _mk_nodes(tmp_path, n_shards=n_shards, seed=n_shards)
    rng = np.random.default_rng(7)
    for _ in range(3):
        body = _knn(rng.standard_normal(DIMS).round(3).tolist())
        before = distributed_serving.stats["distributed_searches"]
        stacked = node.search("vecs", body)
        assert distributed_serving.stats["distributed_searches"] == \
            before + 1
        want = ref.search("vecs", body)
        assert [h for h, _s in _hits(stacked)] == \
            [h for h, _s in _hits(want)]
        np.testing.assert_allclose([s for _h, s in _hits(stacked)],
                                   [s for _h, s in _hits(want)], rtol=1e-6)
        distributed_serving.enabled = False
        per_shard = node.search("vecs", body)
        distributed_serving.enabled = True
        assert _hits(per_shard) == _hits(stacked)
    node.close()
    ref.close()


def test_refresh_generation_isolation(tmp_path):
    _ref, node = _mk_nodes(tmp_path, n_shards=2, n_docs=20)
    svc = node.indices["vecs"]
    shards = [svc.shards[i] for i in sorted(svc.shards)]
    old_snaps = [s.acquire_searcher() for s in shards]
    old_key = ShardMeshRegistry.residency_key("vecs", "v", shards, old_snaps)
    node.index_doc("vecs", "winner", {"v": [0.0] * DIMS})
    node.refresh("vecs")
    new_snaps = [s.acquire_searcher() for s in shards]
    new_key = ShardMeshRegistry.residency_key("vecs", "v", shards, new_snaps)
    assert old_key != new_key
    qnode = query_dsl.parse_query(
        {"knn": {"v": {"vector": [0.0] * DIMS, "k": 3}}})
    old_out = distributed_serving.mesh_knn_batch(shards, old_snaps, [qnode], 5)
    new_out = distributed_serving.mesh_knn_batch(shards, new_snaps, [qnode], 5)

    def ids(out, snaps):
        return [snaps[si].segments[h.segment][0].doc_ids[h.doc]
                for si, res in enumerate(out.per_query[0]) for h in res.hits]

    assert "winner" not in ids(old_out, old_snaps)
    assert "winner" in ids(new_out, new_snaps)
    stats = distributed_serving.registry.snapshot_stats()
    assert stats["builds"] == 2 and stats["evictions"] >= 1
    assert stats["evicted_bytes"] > 0
    node.close()


def test_registry_residency_hits_and_stats(tmp_path):
    _ref, node = _mk_nodes(tmp_path, n_shards=2, n_docs=16)
    body = _knn([0.1] * DIMS, k=3, size=3)
    node.search("vecs", body)
    node.search("vecs", body)
    reg = distributed_serving.registry
    stats = reg.snapshot_stats()
    assert stats["builds"] == 1 and stats["hits"] >= 1
    assert stats["launches"] >= 2 and stats["resident_bundles"] == 1
    # K1's policy (auto -> the hand-written kernel, its plain version on
    # the CPU) serves every stacked launch
    assert stats["fused_launches"] == stats["launches"]
    assert stats["last_kernel"] == "pallas"
    assert stats["last_score_precision"] == "fp32"
    (row,) = reg.resident()
    assert row["index"] == "vecs" and row["shards"] == 2
    assert row["bytes"] == reg.resident_bytes() == stats["resident_bytes"]
    ledger_rows = [r for r in default_ledger.structures("vecs")
                   if r["kind"] == "mesh_bundle"]
    assert [r["bytes"] for r in ledger_rows] == [row["bytes"]]
    node.close()


def test_profile_reports_one_launch_record(tmp_path):
    _ref, node = _mk_nodes(tmp_path, n_shards=4)
    body = _knn([0.2] * DIMS)
    node.search("vecs", body)  # warm: upload and first signature
    resp = node.search("vecs", {**body, "profile": True})
    launch_ids = set()
    for sp in resp["profile"]["shards"]:
        (rec,) = sp["tpu"]["launches"]
        assert rec["name"] == "shard_mesh_knn" and rec["shards"] == 4
        assert rec["retraced"] is False
        launch_ids.add(rec["launch_id"])
        (entry,) = sp["searches"][0]["query"]
        assert entry["type"] == "KnnQuery"
        assert entry["kernels"][0]["name"] == "shard_mesh_knn"
    assert len(launch_ids) == 1
    node.close()


# -- the registry members ----------------------------------------------------


class _Bundle:
    def __init__(self, nbytes, name="x"):
        self.nbytes = nbytes
        self.allocation = default_ledger.register(
            "mesh_bundle", nbytes, index=name, field="v", generation=(1,),
            device="cpu")
        # the registry frees a bundle's allocations, one a slot
        self.allocations = [self.allocation]


def _key(index, engines, gen=0, field="v"):
    return (index, field, len(engines), tuple(engines),
            tuple(gen for _ in engines), tuple(1 for _ in engines))


def test_configure_and_apply_settings():
    reg = ShardMeshRegistry(hbm_budget_bytes=1000)
    a, b = _Bundle(400), _Bundle(400)
    reg.put(_key("a", [1]), a)
    reg.put(_key("b", [2]), b)
    reg.configure()  # nothing named: nothing changes
    assert reg.hbm_budget_bytes == 1000
    reg.configure(hbm_budget_bytes=700)
    assert reg.resident_bytes() == 400 and a.allocation.freed
    reg.apply_settings({"search.mesh.hbm_budget_bytes": "2kb",
                        "unrelated.key": 1})
    assert reg.hbm_budget_bytes == 2048
    reg.apply_settings({})  # absent key: the default
    assert reg.hbm_budget_bytes == 1 << 30
    with pytest.raises(Exception):
        reg.apply_settings({"search.mesh.hbm_budget_bytes": "-5"})
    reg.clear()


def test_warm_for_and_warm_pairs_are_pure_reads():
    reg = ShardMeshRegistry()
    reg.put(_key("i", [1, 2]), _Bundle(10))
    reg.put(_key("j", [3], field="w"), _Bundle(10))
    hits = reg.snapshot_stats()["hits"]
    assert reg.warm_for("i", "v", {1, 2, 9})
    assert not reg.warm_for("i", "v", {1})
    assert not reg.warm_for("i", "w", {1, 2})
    assert reg.warm_pairs({1, 2, 3}) == [("i", "v"), ("j", "w")]
    assert reg.warm_pairs({3}) == [("j", "w")]
    assert reg.snapshot_stats()["hits"] == hits  # no hit accounting
    reg.clear()


def test_record_launch_wall_feeds_the_attached_sink():
    reg = ShardMeshRegistry()
    reg.record_launch_wall(5_000_000)  # no sink: a no-op
    reg.metrics = MetricsRegistry()
    reg.record_launch_wall(5_000_000)
    reg.record_launch_wall(1_000_000)
    h = reg.metrics.stats()["histograms"][MESH_LAUNCH_WALL_MS]
    assert h["count"] == 2 and h["max"] == 5.0 and h["min"] == 1.0


def test_evictions_invalidations_clear_and_reset_stats():
    reg = ShardMeshRegistry(hbm_budget_bytes=0)  # no byte bound
    first, second = _Bundle(100, "i"), _Bundle(150, "i")
    reg.put(_key("i", [1], gen=0), first)
    reg.put(_key("i", [1], gen=1), second)  # supersedes the first
    assert first.allocation.freed_reason == "superseded"
    other = _Bundle(70, "j")
    reg.put(_key("j", [2]), other)
    assert reg.invalidate_index("j") == 1
    assert other.allocation.freed_reason == "invalidated"
    st = reg.snapshot_stats()
    assert (st["evictions"], st["evicted_bytes"]) == (1, 100)
    assert (st["invalidations"], st["invalidated_bytes"]) == (1, 70)
    assert st["resident_bytes"] == reg.resident_bytes() == 150
    reg.record_launch_kernel("pallas", "bf16")
    reg.record_launch_kernel("xla", "fp32")
    assert reg.snapshot_stats()["fused_launches"] == 1
    reg.clear()
    assert second.allocation.freed_reason == "cleared"
    assert reg.resident() == [] and reg.resident_bytes() == 0
    reg.reset_stats()
    st = reg.snapshot_stats()
    assert all(st[k] == 0 for k in reg.stats)
    assert st["resident_bundles"] == 0


def test_invalidate_index_drops_bundles_holding_its_engines():
    """A search over several indices keys its bundle by the first index's
    name: invalidating another of them by its engine ids drops it too."""
    reg = ShardMeshRegistry(hbm_budget_bytes=0)
    own, multi, other = (_Bundle(100, "a"), _Bundle(200, "a"),
                         _Bundle(50, "c"))
    reg.put(_key("a", [1]), own)
    reg.put(_key("a", [1, 2]), multi)
    reg.put(_key("c", [3]), other)
    assert reg.invalidate_index("b", engine_ids=[2]) == 1
    assert multi.allocation.freed_reason == "invalidated"
    assert own.allocation.freed is False and other.allocation.freed is False
    assert reg.resident_bytes() == 150
    reg.clear()


def test_deleting_an_index_releases_a_multi_index_bundle(tmp_path):
    """A kNN over two indices is one stacked launch over both indices'
    shards, its bundle keyed by the first index's name; deleting the
    second index releases that bundle (its columns are gone), and the
    first index's own bundle stays."""
    node = TorchNode(tmp_path, device="cpu")
    for name, seed in (("a", 0), ("b", 1)):
        node.create_index(name, _body(1))
        node.bulk([(op, {**meta, "_index": name}, src)
                   for op, meta, src in _docs(32, seed)], refresh=True)
    registry = distributed_serving.registry
    q = _knn([0.2] * DIMS)
    node.search("a", q)
    node.search("a,b", q)
    b_engines = {sh.engine.instance_id
                 for sh in node.indices["b"].shards.values()}
    held = [k for k in registry._bundles if b_engines & set(k[3])]
    assert len(held) == 1 and held[0][0] == "a"
    multi_bytes = registry._bundles[held[0]].nbytes
    resident = default_ledger.resident_bytes()
    own = [k for k in registry._bundles if k[0] == "a" and k not in held]
    node.delete_index("b")
    assert not [k for k in registry._bundles if b_engines & set(k[3])]
    assert [k for k in registry._bundles if k[0] == "a"] == own
    b_columns = resident - default_ledger.resident_bytes() - multi_bytes
    assert b_columns > 0
    assert _hits(node.search("a", q)) == _hits(node.search("a", q))
    node.close()


def test_the_references_registry_counters_match_on_one_trace(tmp_path):
    """The same searches on both nodes leave the same registry counters
    (builds, hits, launches, evictions, resident bundles)."""
    ref_serving.registry.clear()
    ref_serving.registry.reset_stats()
    ref, node = _mk_nodes(tmp_path, n_shards=2, n_docs=24)
    for n in (ref, node):
        for v in ([0.1] * DIMS, [0.2] * DIMS):
            n.search("vecs", _knn(v))
        n.index_doc("vecs", "late", {"v": [0.3] * DIMS})
        n.refresh("vecs")
        n.search("vecs", _knn([0.3] * DIMS))
    want = ref_serving.registry.snapshot_stats()
    got = distributed_serving.registry.snapshot_stats()
    for key in ("builds", "hits", "launches", "evictions",
                "resident_bundles", "invalidations"):
        assert got[key] == want[key], key
    ref.close()
    node.close()


# -- batcher: cross-shard launch accounting ----------------------------------


def test_batcher_counts_cross_shard_launches(tmp_path):
    """tests/test_shard_mesh.py's case on both nodes: a kNN over 4 shards
    is one stacked launch the batcher counts as cross-shard."""
    ref, node = _mk_nodes(tmp_path, n_shards=4)
    for n in (ref, node):
        n.knn_batcher.reset()
        n.search("vecs", _knn([0.3] * DIMS))
    want = ref.knn_batcher.snapshot_stats()
    got = node.knn_batcher.snapshot_stats()
    assert got["cross_shard_launches"] == want["cross_shard_launches"] == 1
    assert got["cross_shard_queries"] == want["cross_shard_queries"] == 1
    ref.close()
    node.close()


def test_knn_batch_stats_are_the_references_after_one_trace(tmp_path):
    """Bare kNN searches at two k, a filtered one, a bool + kNN on the
    per-shard route, a refresh and a search after it: the same counters
    and tuner state on both nodes."""
    ref, node = _mk_nodes(tmp_path, n_shards=2, n_docs=40)
    for n in (ref, node):
        n.knn_batcher.reset()
        for v in ([0.1] * DIMS, [0.2] * DIMS, [0.3] * DIMS):
            n.search("vecs", _knn(v))
        n.search("vecs", _knn([0.1] * DIMS, k=8))
        n.search("vecs", {"query": {"knn": {"v": {
            "vector": [0.1] * DIMS, "k": 5,
            "filter": {"ids": {"values": ["d1", "d2"]}}}}}})
        n.search("vecs", {"query": {"bool": {"must": [
            {"knn": {"v": {"vector": [0.4] * DIMS, "k": 5}}}]}}})
        n.index_doc("vecs", "late", {"v": [0.3] * DIMS})
        n.refresh("vecs")
        n.search("vecs", _knn([0.3] * DIMS))
    want = knn_batch_trace(ref.knn_batcher.snapshot_stats())
    got = knn_batch_trace(node.knn_batcher.snapshot_stats())
    assert got == want
    assert want["cross_shard_launches"] == 5
    ref.close()
    node.close()
