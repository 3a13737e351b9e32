"""The port's kNN dispatch batcher (opensearch_tpu_torch/search/batcher.py)
and its use on the per-shard route, on the CPU: the scenarios of the
reference's tests/test_knn_batcher.py and tests/test_ann_batch.py, run
against the port's batcher and TorchNode(device="cpu").

Properties: K concurrent searches over one segment column coalesce into at
most ceil(K / max_batch_size) launches and answer as the same searches run
one at a time (same ids in the same order; scores to rtol 1e-6, because a
batch of B queries goes through a [B, d] x [d, n] product whose float32
sums PyTorch's CPU kernels may order by B); the pending queue sheds with a
429 instead of growing; keys that differ in reader or build generation
never share a launch; key=None runs solo; a small-k request rides a forming
larger-k batch and never opens one; a frozen clock cannot hang a wait.

The stacked serving step through the batcher (the reference's
``dispatch(key, ..., shards=)``): concurrent bare kNN searches over two
shards share launches, each counted cross-shard, and answer with the
bits of the same searches run alone at fp32 k = 10 and 100 and at bf16
and int8 (int8 queries of one quantization scale: queries of other
scales never share a launch); a filtered or alias-filtered search launches alone, outside
the batcher; a PIT's pinned generation and the live one never share a
launch; an unfiltered query on an ANN column never queues under the
stacked key.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np
import pytest

from opensearch_tpu_torch.common import timeutil
from opensearch_tpu_torch.common.errors import RejectedExecutionException
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.ops import knn_fused
from opensearch_tpu_torch.search import ann as ann_mod
from opensearch_tpu_torch.search import batcher as batcher_mod
from opensearch_tpu_torch.search import distributed_serving, executor
from opensearch_tpu_torch.search.batcher import KnnDispatchBatcher

DIM = 4
ANN_DIM = 16


def _restore(n: TorchNode) -> None:
    n.knn_batcher.configure(enabled=True, max_batch_size=32, max_wait_ms=2,
                            max_queue=1024, auto_tune=True)
    ann_mod.default_config.configure(exact_kernel="auto", kernel="auto")


@pytest.fixture()
def node(tmp_path, monkeypatch):
    # the per-shard route, with the streaming scan made eligible for the
    # tiny corpus (n_pad 128: four 32-doc chunks)
    monkeypatch.setattr(distributed_serving, "enabled", False)
    monkeypatch.setattr(executor, "STREAMING_MIN_DOCS", 8)
    monkeypatch.setattr(executor, "STREAMING_CHUNK", 32)
    n = TorchNode(tmp_path / "node", device="cpu")
    n.create_index("v", {
        "settings": {"number_of_shards": 1},
        "mappings": {"properties": {"x": {
            "type": "knn_vector", "dimension": DIM, "space_type": "l2"}}},
    })
    rng = np.random.default_rng(7)
    n.bulk([("index", {"_index": "v", "_id": str(i)},
             {"x": rng.standard_normal(DIM).round(3).tolist()})
            for i in range(96)], refresh=True)
    yield n
    _restore(n)
    n.close()


def _clustered(rng, n, d, n_centers=8, spread=5.0):
    centers = rng.standard_normal((n_centers, d)) * spread
    return (centers[rng.integers(0, n_centers, n)]
            + rng.standard_normal((n, d))).astype(np.float32)


@pytest.fixture()
def ann_node(tmp_path):
    n = TorchNode(tmp_path / "ann", device="cpu")
    n.create_index("av", {
        "settings": {"number_of_shards": 1},
        "mappings": {"properties": {"x": {
            "type": "knn_vector", "dimension": ANN_DIM,
            "method": {"name": "ivf_pq", "parameters": {
                "nlist": 8, "m": 4, "nprobe": 8, "min_train": 100}}}}},
    })
    data = _clustered(np.random.default_rng(7), 600, ANN_DIM)
    n.bulk([("index", {"_index": "av", "_id": str(i)},
             {"x": data[i].round(3).tolist()}) for i in range(600)],
           refresh=True)
    n._test_data = data
    yield n
    _restore(n)
    n.close()


def _queries(k: int) -> list:
    rng = np.random.default_rng(21)
    return [rng.standard_normal(DIM).round(3).tolist() for _ in range(k)]


def _body(vec, k=5, field="x"):
    return {"query": {"knn": {field: {"vector": vec, "k": k}}}, "size": k}


def _concurrent(node, index, bodies):
    out = [None] * len(bodies)
    errs = []
    barrier = threading.Barrier(len(bodies))

    def run(i):
        barrier.wait()
        try:
            out[i] = node.search(index, bodies[i])
        except Exception as e:  # noqa: BLE001 - surfaced via errs
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    return out


def _assert_same_hits(got, want):
    g, w = got["hits"]["hits"], want["hits"]["hits"]
    assert [h["_id"] for h in g] == [h["_id"] for h in w]
    np.testing.assert_allclose([h["_score"] for h in g],
                               [h["_score"] for h in w], rtol=1e-6, atol=0)
    assert got["hits"]["total"] == want["hits"]["total"]


# ---------------------------------------------------------------------------
# coalescing on the node: one launch per batch, the solo answers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy,branch", [("auto", "fused"),
                                           ("xla", "streaming")])
def test_concurrent_searches_coalesce_and_equal_solo(node, policy, branch):
    K, B = 8, 8
    ann_mod.default_config.configure(exact_kernel=policy)
    qs = _queries(K)
    node.knn_batcher.configure(enabled=False)
    ref = [node.search("v", _body(q)) for q in qs]

    node.knn_batcher.configure(enabled=True, max_batch_size=B,
                               max_wait_ms=2000)
    node.knn_batcher.reset()
    s0 = executor.knn_path_stats[branch]
    out = _concurrent(node, "v", [_body(q) for q in qs])
    st = node.knn_batcher.snapshot_stats()
    assert st["dispatches"] <= math.ceil(K / B)
    assert st["merged_queries"] == K and st["mean_merged_batch"] > 1
    assert st["exact_dispatches"] == st["dispatches"]
    assert executor.knn_path_stats[branch] - s0 == K
    for got, want in zip(out, ref):
        _assert_same_hits(got, want)


def test_dispatch_count_respects_max_batch_size(node, monkeypatch):
    """K searches in batches of at most B. The first launch waits until all
    K have queued, so a backlog never flushes early behind it (continuous
    batching) and the flushes are the size-bound ones: ceil(K / B)."""
    K, B = 8, 4
    node.knn_batcher.configure(enabled=True, max_batch_size=B,
                               max_wait_ms=2000)
    node.knn_batcher.reset()
    launch = knn_fused.knn_fused_auto

    def gated(*args, **kwargs):
        deadline = time.monotonic() + 30
        while (node.knn_batcher.pressure.total < K
               and time.monotonic() < deadline):
            time.sleep(0.001)
        return launch(*args, **kwargs)

    monkeypatch.setattr(knn_fused, "knn_fused_auto", gated)
    _concurrent(node, "v", [_body(q) for q in _queries(K)])
    st = node.knn_batcher.snapshot_stats()
    assert st["dispatches"] == math.ceil(K / B)
    assert st["merged_queries"] == K
    assert st["max_batch"] <= B


def test_kill_switch_disables_coalescing(node):
    node.knn_batcher.configure(enabled=False)
    node.knn_batcher.reset()
    _concurrent(node, "v", [_body(q) for q in _queries(4)])
    st = node.knn_batcher.snapshot_stats()
    assert st["dispatches"] == 4
    assert st["coalesced_batches"] == 0
    assert st["queue"]["total"] == 0


def test_refresh_mid_stream_serves_fresh_snapshot(node):
    """A refresh between two batched searches bumps the reader generation,
    a different key: the second search sees the new document."""
    node.knn_batcher.configure(enabled=True, max_batch_size=8,
                               max_wait_ms=50)
    node.knn_batcher.reset()
    target = [9.0, 9.0, 9.0, 9.0]
    r1 = node.search("v", _body(target, k=3))
    assert "bullseye" not in [h["_id"] for h in r1["hits"]["hits"]]
    node.bulk([("index", {"_index": "v", "_id": "bullseye"},
                {"x": target})], refresh=True)
    r2 = node.search("v", _body(target, k=3))
    assert r2["hits"]["hits"][0]["_id"] == "bullseye"
    assert node.knn_batcher.snapshot_stats()["dispatches"] >= 2


def test_ann_concurrent_searches_single_dispatch(ann_node):
    data = ann_node._test_data
    K, B = 8, 8
    ann_node.knn_batcher.configure(enabled=False)
    ref = [ann_node.search("av", _body(data[i].tolist())) for i in range(K)]
    ann_node.knn_batcher.configure(enabled=True, max_batch_size=B,
                                   max_wait_ms=2000)
    ann_node.knn_batcher.reset()
    a0 = executor.knn_path_stats["ann"]
    out = _concurrent(ann_node, "av",
                      [_body(data[i].tolist()) for i in range(K)])
    st = ann_node.knn_batcher.snapshot_stats()
    assert st["dispatches"] <= math.ceil(K / B)
    assert st["merged_queries"] == K
    assert st["ann_dispatches"] == st["dispatches"]
    assert st["exact_dispatches"] == 0
    assert executor.knn_path_stats["ann"] - a0 == K
    for i, (got, want) in enumerate(zip(out, ref)):
        _assert_same_hits(got, want)
        assert got["hits"]["hits"][0]["_id"] == str(i)


def test_mixed_k_concurrent_traffic_each_k_correct(ann_node):
    """Concurrent k=3 and k=8 ANN searches come back with their own k and
    the unbatched ids, whether or not the small-k ones rode a bigger
    launch."""
    data = ann_node._test_data
    ks = [3, 8, 3, 8, 3, 8]
    ann_node.knn_batcher.configure(enabled=False)
    ref = [ann_node.search("av", _body(data[i].tolist(), k=k))
           for i, k in enumerate(ks)]
    ann_node.knn_batcher.configure(enabled=True, max_batch_size=8,
                                   max_wait_ms=2000)
    ann_node.knn_batcher.reset()
    out = _concurrent(ann_node, "av", [_body(data[i].tolist(), k=k)
                                       for i, k in enumerate(ks)])
    for got, want, k in zip(out, ref, ks):
        assert len(got["hits"]["hits"]) == k
        _assert_same_hits(got, want)


# ---------------------------------------------------------------------------
# the batcher alone
# ---------------------------------------------------------------------------


def _echo(payloads):
    return [f"r-{p}" for p in payloads]


def _wait_queued(batcher, depth: int) -> None:
    for _ in range(5_000):
        if batcher.pressure.current == depth:
            return
        time.sleep(0.001)
    raise AssertionError(f"queue never reached depth {depth}")


@pytest.mark.parametrize("kind", ("exact", "ann"))
def test_queue_bound_sheds_with_429(kind):
    batcher = KnnDispatchBatcher(max_batch_size=2, max_wait_ms=10_000,
                                 max_queue=1)
    key = ("ivfpq", 1, 1, 0, 8, 8, "l2_norm", "fp32", 4, "pallas")
    results = {}
    t = threading.Thread(target=lambda: results.update(
        a=batcher.dispatch(key, "a", _echo, kind=kind).value))
    t.start()
    _wait_queued(batcher, 1)
    with pytest.raises(RejectedExecutionException) as exc:
        batcher.dispatch(key, "shed-me", _echo, kind=kind)
    assert exc.value.status == 429
    assert batcher.snapshot_stats()["rejections"] == 1
    # capacity restored: the next arrival fills the bucket and flushes it
    batcher.configure(max_queue=2)
    out = batcher.dispatch(key, "b", _echo, kind=kind)
    t.join(timeout=10)
    assert not t.is_alive()
    assert results["a"] == "r-a"
    assert out.value == "r-b" and out.merged == 2
    assert batcher.snapshot_stats()[f"{kind}_dispatches"] == 1


@pytest.mark.parametrize("keys", [
    # reader generations
    (("knn_fused", 1, "gen1"), ("knn_fused", 1, "gen2")),
    # IVF-PQ index-build generations, all else equal
    (("ivfpq", 1234, 1, 0, 8, 8, "l2_norm", "fp32", 4, "pallas"),
     ("ivfpq", 1234, 2, 0, 8, 8, "l2_norm", "fp32", 4, "pallas")),
])
def test_distinct_generations_never_merge(keys):
    batcher = KnnDispatchBatcher(max_batch_size=8, max_wait_ms=300)
    seen: dict[int, list] = {}
    lock = threading.Lock()

    def launch_for(gen):
        def launch(payloads):
            with lock:
                seen.setdefault(gen, []).append(sorted(payloads))
            return [f"g{gen}:{p}" for p in payloads]
        return launch

    barrier = threading.Barrier(4)
    out = {}

    def run(gen, payload):
        barrier.wait()
        out[(gen, payload)] = batcher.dispatch(keys[gen], payload,
                                               launch_for(gen)).value

    threads = [threading.Thread(target=run, args=args) for args in [
        (0, "a"), (0, "b"), (1, "c"), (1, "d")]]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert out == {(0, "a"): "g0:a", (0, "b"): "g0:b",
                   (1, "c"): "g1:c", (1, "d"): "g1:d"}
    for gen, batches in seen.items():
        for batch in batches:
            assert all(p in (("a", "b"), ("c", "d"))[gen] for p in batch)


def test_key_none_runs_solo():
    batcher = KnnDispatchBatcher(max_batch_size=8, max_wait_ms=5_000)
    out = batcher.dispatch(None, "x", _echo)
    assert out.value == "r-x" and out.merged == 1
    st = batcher.snapshot_stats()
    assert st["dispatches"] == 1 and st["queue"]["total"] == 0


def test_cross_k_joins_forming_bigger_k_batch():
    batcher = KnnDispatchBatcher(max_batch_size=8, max_wait_ms=5_000)
    launches: list[tuple[int, list]] = []
    lock = threading.Lock()

    def launch_for(k):
        def launch(payloads):
            with lock:
                launches.append((k, sorted(payloads)))
            return [f"k{k}:{p}" for p in payloads]
        return launch

    k8_key, k4_key = ("ivfpq", 1, 1, 8), ("ivfpq", 1, 1, 4)
    out = {}
    t = threading.Thread(target=lambda: out.update(
        big=batcher.dispatch(k8_key, "big", launch_for(8), kind="ann",
                             rank=8).value))
    t.start()
    _wait_queued(batcher, 1)
    # the k=4 arrival names the k=8 family as an alt key: it rides that
    # batch, which the k=8 closure launches
    small = batcher.dispatch(k4_key, "small", launch_for(4), kind="ann",
                             rank=4, alt_keys=(k8_key,))
    t.join(timeout=10)
    assert not t.is_alive()
    assert small.merged == 2
    assert out["big"] == "k8:big"
    assert small.value == "k8:small"
    assert launches == [(8, ["big", "small"])]
    assert batcher.snapshot_stats()["cross_k_served"] == 1


def test_cross_k_never_creates_a_bigger_bucket():
    batcher = KnnDispatchBatcher(max_batch_size=8, max_wait_ms=0)
    out = batcher.dispatch(("k", 4), "solo", _echo, rank=4,
                           alt_keys=(("k", 8), ("k", 16)))
    assert out.value == "r-solo"
    assert batcher.snapshot_stats()["cross_k_served"] == 0


def test_adaptive_solo_fast_path_engages_for_sequential_traffic():
    batcher = KnnDispatchBatcher(max_batch_size=8, max_wait_ms=30)
    for i in range(8):
        assert batcher.dispatch("k", i, list).value == i
    st = batcher.snapshot_stats()
    assert st["dispatches"] == 8
    assert st["solo_fast_path"] >= 1
    assert st["coalesced_batches"] == 0


class _FrozenClock(timeutil.Clock):
    def monotonic_millis(self) -> int:
        return 1_000


def test_frozen_clock_dispatch_does_not_hang():
    batcher = KnnDispatchBatcher(max_batch_size=8, max_wait_ms=50)
    with timeutil.clock_scope(_FrozenClock()):
        out = batcher.dispatch("k", 21, lambda ps: [p * 2 for p in ps])
    assert out.value == 42
    assert batcher.snapshot_stats()["dispatches"] == 1


def test_deadline_flush_waits_the_configured_window():
    """With auto-tuning off and recent concurrency (no solo fast path), a
    lone entry waits out max_wait_ms before its deadline flush, and the
    wait it reports covers the window."""
    batcher = KnnDispatchBatcher(max_batch_size=8, max_wait_ms=40,
                                 auto_tune=False)
    batcher._ewma = 10.0
    t0 = time.monotonic()
    out = batcher.dispatch("k", 1, list)
    assert out.value == 1 and out.merged == 1
    assert 40 <= out.wait_ms < 1000
    assert time.monotonic() - t0 >= 0.039


def test_settings_and_stats_surface(tmp_path):
    node = TorchNode(tmp_path, device="cpu")
    assert node.knn_batcher is batcher_mod.default_batcher
    node.close()
    batcher = KnnDispatchBatcher()
    assert (batcher.max_wait_ms, batcher.max_batch_size, batcher.enabled,
            batcher.auto_tune, batcher.pressure.limit) == (2, 32, True, True,
                                                           1024)
    assert [s.key for s in (
        batcher_mod.MAX_WAIT_MS_SETTING, batcher_mod.MAX_BATCH_SIZE_SETTING,
        batcher_mod.MAX_QUEUE_SETTING, batcher_mod.ENABLED_SETTING,
        batcher_mod.AUTO_TUNE_SETTING)] == [
        "search.knn.batch.max_wait_ms", "search.knn.batch.max_batch_size",
        "search.knn.batch.max_queue", "search.knn.batch.enabled",
        "search.knn.batch.auto_tune"]
    batcher.configure(max_wait_ms=7, max_batch_size=0, max_queue=64,
                      enabled=False, auto_tune=False)
    # a batch bound below 1 clamps to 1
    assert (batcher.max_wait_ms, batcher.max_batch_size, batcher.enabled,
            batcher.auto_tune, batcher.pressure.limit) == (7, 1, False,
                                                           False, 64)
    # arguments left out keep their values
    batcher.configure(enabled=True)
    assert (batcher.max_wait_ms, batcher.max_batch_size,
            batcher.enabled) == (7, 1, True)
    st = batcher.snapshot_stats()
    assert {"dispatches", "mean_merged_batch", "auto_tune", "queue", "ann",
            "cross_k_served"} <= set(st)


# ---------------------------------------------------------------------------
# the stacked serving step through the batcher (search/service.py)
# ---------------------------------------------------------------------------

STACKED_DIM = 16


@pytest.fixture()
def stacked(tmp_path):
    """Two shards on the stacked step (distributed_serving on), 600 docs
    with a keyword for filters and an alias with a filter."""
    n = TorchNode(tmp_path / "stacked", device="cpu")
    n.create_index("s", {
        "settings": {"number_of_shards": 2},
        "mappings": {"properties": {
            "x": {"type": "knn_vector", "dimension": STACKED_DIM,
                  "space_type": "l2"},
            "tag": {"type": "keyword"}}},
    })
    rng = np.random.default_rng(5)
    data = rng.standard_normal((600, STACKED_DIM)).round(3)
    n.bulk([("index", {"_index": "s", "_id": str(i)},
             {"x": data[i].tolist(), "tag": "ab"[i % 2]})
            for i in range(600)], refresh=True)
    n.put_alias("s", "evens", {"filter": {"term": {"tag": "a"}}})
    n._test_queries = [rng.standard_normal(STACKED_DIM).round(3).tolist()
                       for _ in range(8)]
    yield n
    _restore(n)
    ann_mod.default_config.configure(score_precision="fp32")
    n.close()


def _bits(resp):
    return [(h["_index"], h["_id"], h["_score"])
            for h in resp["hits"]["hits"]]


@pytest.mark.parametrize("precision,k", [("fp32", 10), ("fp32", 100),
                                         ("bf16", 10), ("int8", 10),
                                         ("bf16", 100), ("int8", 100)])
def test_stacked_concurrent_searches_merge_and_equal_solo_bits(
        stacked, precision, k):
    """Concurrent bare kNN searches share stacked launches through
    batcher.dispatch(..., shards=2) and each answers with the bits of the
    same search run alone (the list scan at k = 10, the wide tier at
    k = 100, the reduced-precision rescore; at int8 the queries share one
    quantization scale)."""
    ann_mod.default_config.configure(score_precision=precision)
    qs = stacked._test_queries
    if precision == "int8":
        # one int8 scale (max|q| = 2): the stacked step merges int8 queries
        # of one scale only (the next test)
        qs = [(np.asarray(q) * (2.0 / np.abs(q).max())).round(3).tolist()
              for q in qs]
    bodies = [{"query": {"knn": {"x": {"vector": q, "k": k}}}, "size": k}
              for q in qs]
    stacked.knn_batcher.configure(enabled=False)
    solo = [stacked.search("s", b) for b in bodies]
    stacked.knn_batcher.configure(enabled=True, max_batch_size=32,
                                  max_wait_ms=2000)
    stacked.knn_batcher.reset()
    d0 = distributed_serving.stats["distributed_searches"]
    out = _concurrent(stacked, "s", bodies)
    st = stacked.knn_batcher.snapshot_stats()
    assert st["merged_queries"] == len(qs)
    assert st["dispatches"] < len(qs) and st["mean_merged_batch"] > 1
    assert st["cross_shard_launches"] == st["dispatches"]
    assert st["cross_shard_queries"] == len(qs)
    # one stacked-step dispatch a launch
    assert distributed_serving.stats["distributed_searches"] - d0 == \
        st["dispatches"]
    for got, want in zip(out, solo):
        assert _bits(got) == _bits(want)
        assert got["hits"]["total"] == want["hits"]["total"]


def test_int8_queries_of_other_scales_never_merge(stacked):
    """An int8 batch is quantized with one scale, max|q| / 127 over the
    batch: the stacked key carries each query's own scale, so queries of
    other scales launch apart and each answers as alone."""
    ann_mod.default_config.configure(score_precision="int8")
    qs = stacked._test_queries
    assert len({knn_fused.int8_query_scale(q) for q in qs}) == len(qs)
    bodies = [{"query": {"knn": {"x": {"vector": q, "k": 10}}}, "size": 10}
              for q in qs]
    stacked.knn_batcher.configure(enabled=False)
    solo = [stacked.search("s", b) for b in bodies]
    stacked.knn_batcher.configure(enabled=True, max_batch_size=32,
                                  max_wait_ms=200, auto_tune=False)
    stacked.knn_batcher.reset()
    out = _concurrent(stacked, "s", bodies)
    st = stacked.knn_batcher.snapshot_stats()
    assert st["dispatches"] == len(qs) and st["coalesced_batches"] == 0
    assert [_bits(r) for r in out] == [_bits(r) for r in solo]


def _launched_solo(node, index, bodies):
    node.knn_batcher.configure(enabled=True, max_batch_size=32,
                               max_wait_ms=2000)
    node.knn_batcher.reset()
    _concurrent(node, index, bodies)
    return node.knn_batcher.snapshot_stats()


def test_filtered_and_alias_filtered_searches_never_merge(stacked):
    """A knn.filter or an alias filter makes the valid mask the request's
    own: as in the reference, the stacked step launches for it alone,
    outside the batcher, one filtered launch a search."""
    qs = stacked._test_queries[:4]
    filtered = [{"query": {"knn": {"x": {"vector": q, "k": 5, "filter": {
        "term": {"tag": "b"}}}}}, "size": 5} for q in qs]
    bare = [{"query": {"knn": {"x": {"vector": q, "k": 5}}}, "size": 5}
            for q in qs]
    for index, bodies in (("s", filtered), ("evens", bare)):
        d0 = dict(distributed_serving.stats)
        st = _launched_solo(stacked, index, bodies)
        assert st["dispatches"] == 0 and st["queue"]["total"] == 0
        for key in ("distributed_searches", "filtered"):
            assert distributed_serving.stats[key] - d0[key] == 4


def test_searches_across_a_refresh_never_share_a_launch(stacked):
    """A PIT pins the pre-refresh generations: its searches and the live
    index's are other keys, never one launch, and each answers from its
    own snapshot."""
    target = [9.0] * STACKED_DIM
    pit = stacked.open_pit("s", "1m")["pit_id"]
    stacked.bulk([("index", {"_index": "s", "_id": "bullseye"},
                   {"x": target, "tag": "a"})], refresh=True)
    body = {"query": {"knn": {"x": {"vector": target, "k": 3}}}, "size": 3}
    pit_body = {**body, "pit": {"id": pit}}
    stacked.knn_batcher.configure(enabled=True, max_batch_size=32,
                                  max_wait_ms=300)
    stacked.knn_batcher.reset()
    out = [None, None]
    barrier = threading.Barrier(2)

    def run(i, b):
        barrier.wait()
        out[i] = stacked.search(None if i else "s", b)

    threads = [threading.Thread(target=run, args=(0, body)),
               threading.Thread(target=run, args=(1, pit_body))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    st = stacked.knn_batcher.snapshot_stats()
    assert st["coalesced_batches"] == 0 and st["dispatches"] == 2
    assert out[0]["hits"]["hits"][0]["_id"] == "bullseye"
    assert "bullseye" not in [h["_id"] for h in out[1]["hits"]["hits"]]
    stacked.close_pit([pit])


def test_ann_column_skips_the_stacked_batcher(ann_node):
    """An unfiltered query on an ANN column declines the stacked step
    before any batcher round trip: only the per-shard route's ANN
    launches are dispatched."""
    data = ann_node._test_data
    ann_node.knn_batcher.reset()
    d0 = dict(distributed_serving.stats)
    ann_node.search("av", _body(data[0].tolist()))
    st = ann_node.knn_batcher.snapshot_stats()
    assert st["dispatches"] == st["ann_dispatches"] == 1
    assert st["cross_shard_launches"] == 0
    assert "('distributed_knn'" not in str(st["auto_tune"]["keys"])
    assert distributed_serving.stats["distributed_searches"] == \
        d0["distributed_searches"]


def test_stacked_batches_over_http_on_a_small_search_pool(stacked,
                                                          monkeypatch):
    """8 HTTP clients on a 2-thread interactive pool: a batch's leader
    waits out its window and launches what has queued, never a member
    still queued behind it in the pool, so every search completes with
    its solo bits; the lane admits and completes each search once."""
    import http.client
    import json
    import os

    from opensearch_tpu_torch.rest.http import HttpServer

    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    srv = HttpServer(stacked, "127.0.0.1", 0)
    srv.start_in_thread()
    qs = stacked._test_queries
    bodies = [{"query": {"knn": {"x": {"vector": q, "k": 10}}}, "size": 10}
              for q in qs * 2]
    solo = [_bits(stacked.search("s", b)) for b in bodies]
    stacked.knn_batcher.configure(enabled=True, max_batch_size=32,
                                  max_wait_ms=20)
    stacked.knn_batcher.reset()
    lanes0 = srv.lane_tracker.snapshot()["interactive"]
    got = [None] * len(bodies)
    errs = []

    def client(t):
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        try:
            for i in range(t, len(bodies), 8):
                conn.request("POST", "/s/_search",
                             body=json.dumps(bodies[i]),
                             headers={"Content-Type": "application/json"})
                resp = json.loads(conn.getresponse().read())
                got[i] = [(h["_index"], h["_id"], h["_score"])
                          for h in resp["hits"]["hits"]]
        except Exception as e:  # noqa: BLE001 - surfaced via errs
            errs.append(e)
        finally:
            conn.close()

    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errs and not any(t.is_alive() for t in threads)
        assert got == solo
        st = stacked.knn_batcher.snapshot_stats()
        assert st["merged_queries"] == len(bodies)
        assert st["cross_shard_queries"] == len(bodies)
        lanes1 = srv.lane_tracker.snapshot()["interactive"]
        assert lanes1["submitted"] - lanes0["submitted"] == len(bodies)
        assert lanes1["completed"] - lanes0["completed"] == len(bodies)
        assert lanes1["depth"] == 0
    finally:
        srv.stop_thread()


def test_a_task_cancelled_in_the_batcher_leaves_its_neighbours(stacked):
    """As in the reference, a search is checked for cancellation before
    its dispatch, never between its dispatch and the launch's readback: a
    task cancelled while it waits in a batch rides the launch, and its
    neighbour in the batch gets its solo hits."""
    qs = stacked._test_queries[:2]
    bodies = [{"query": {"knn": {"x": {"vector": q, "k": 10}}}, "size": 10}
              for q in qs]
    solo = [_bits(stacked.search("s", b)) for b in bodies]
    stacked.knn_batcher.configure(enabled=True, max_batch_size=32,
                                  max_wait_ms=400, auto_tune=False)
    stacked.knn_batcher.reset()
    out = [None, None]

    def run(i):
        out[i] = stacked.search("s", bodies[i])

    first = threading.Thread(target=run, args=(0,))
    first.start()
    deadline = time.monotonic() + 10
    while stacked.knn_batcher.pressure.total < 1 and \
            time.monotonic() < deadline:
        time.sleep(0.001)
    (task,) = stacked.task_manager.list_tasks("indices:data/read/search")
    stacked.task_manager.cancel(task.id)
    second = threading.Thread(target=run, args=(1,))
    second.start()
    first.join()
    second.join()
    st = stacked.knn_batcher.snapshot_stats()
    assert st["dispatches"] == 1 and st["merged_queries"] == 2
    assert [_bits(r) for r in out] == solo
