"""TorchNode(device="cpu") against TpuNode on IVF-PQ (ANN) kNN `_search`.

Both nodes index the same docs under the same `ivf_pq` mapping, for 1 and
2 shards and for l2 and cosine, and each builds its own IVF-PQ index at
refresh (the port's k-means reproduces the reference's on this corpus; see
tests/test_torch_ivfpq.py). The ANN policy (search.knn.ann.kernel and
adc_precision) is set on both with `ann.default_config.configure`, then
restored. The same `knn` bodies must give the same hit `_id`s in the same
order and the same `hits.total`; `_score`s agree to rtol 1e-5 / atol 1e-4
(the exact rescore's l2 form |q|^2 - 2 q.v + |v|^2 cancels near a
neighbour, so the few ulps by which the two frameworks' dots differ reach
the score whole). Also: a shard holding an ANN segment beside one below
min_train (the exact branch, K1's wrapper), and the per-shard route for
exact kNN with the stacked step switched off.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu.search import ann as jax_ann
from opensearch_tpu.search import distributed_serving as jax_serving
from opensearch_tpu.telemetry import roofline
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.ops import adc_scan
from opensearch_tpu_torch.search import ann as torch_ann
from opensearch_tpu_torch.search import distributed_serving as torch_serving
from opensearch_tpu_torch.search import executor as torch_executor

DIM = 16
N_DOCS = 800
SHARDS = (1, 2)
SIMS = ("l2_norm", "cosine")
KERNELS = ("pallas", "xla")
PRECISIONS = ("fp32", "bf16", "int8")
METHOD = {"name": "ivf_pq",
          "parameters": {"nlist": 8, "m": 4, "nprobe": 4, "min_train": 100}}


def _index(shards: int, sim: str) -> str:
    return f"ann-{shards}-{sim.replace('_', '-')}"


def _mapping(sim: str, method: dict | None = METHOD) -> dict:
    field = {"type": "knn_vector", "dimension": DIM, "similarity": sim}
    if method is not None:
        field["method"] = method
    return {"properties": {"v": field, "tag": {"type": "keyword"}}}


def _ops(name: str, data: np.ndarray, lo: int, hi: int) -> list:
    return [("index", {"_index": name, "_id": str(i)},
             {"v": data[i].tolist(), "tag": f"t{i % 5}"})
            for i in range(lo, hi)]


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    prev_peaks = roofline.current_peaks()
    roofline.set_peaks(roofline.stub_peaks(seed=3))
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((8, DIM)) * 5
    data = (centers[rng.integers(0, 8, N_DOCS)]
            + rng.standard_normal((N_DOCS, DIM))).astype(np.float32)
    ref = TpuNode(tmp_path_factory.mktemp("tpu"))
    port = TorchNode(tmp_path_factory.mktemp("torch"), device="cpu")
    for node in (ref, port):
        for shards in SHARDS:
            for sim in SIMS:
                name = _index(shards, sim)
                node.create_index(name, {
                    "settings": {"number_of_shards": shards},
                    "mappings": _mapping(sim)})
                node.bulk(_ops(name, data, 0, N_DOCS), refresh=True)
        # one shard, two segments: 600 docs build IVF-PQ at the default
        # min_train (512), then 150 more stay exact
        node.create_index("mixed", {
            "settings": {"number_of_shards": 1},
            "mappings": _mapping("l2_norm", {
                "name": "ivf_pq", "parameters": {"nlist": 8, "m": 4}})})
        node.bulk(_ops("mixed", data, 0, 600), refresh=True)
        node.bulk(_ops("mixed", data, 600, 750), refresh=True)
        # exact kNN for the route switch
        node.create_index("exact", {
            "settings": {"number_of_shards": 2},
            "mappings": _mapping("l2_norm", None)})
        node.bulk(_ops("exact", data, 0, 400), refresh=True)
    yield ref, port, data
    ref.close()
    port.close()
    if prev_peaks is not None:
        roofline.set_peaks(prev_peaks)


@pytest.fixture()
def policy():
    """Sets the same ANN policy on both packages; restores the defaults."""
    def configure(**kw):
        jax_ann.default_config.configure(**kw)
        torch_ann.default_config.configure(**kw)
    yield configure
    configure(kernel="auto", adc_precision="fp32", rescore_multiplier=4)


def _queries(data, seed: int, n: int = 3) -> list:
    rng = np.random.default_rng(seed)
    return [data[int(rng.integers(N_DOCS))],
            (data[int(rng.integers(N_DOCS))]
             + 0.3 * rng.standard_normal(DIM)).astype(np.float32),
            rng.standard_normal(DIM).astype(np.float32) * 5][:n]


def _assert_same(r: dict, t: dict) -> None:
    rh, th = r["hits"]["hits"], t["hits"]["hits"]
    assert [h["_id"] for h in th] == [h["_id"] for h in rh]
    np.testing.assert_allclose([h["_score"] for h in th],
                               [h["_score"] for h in rh], rtol=1e-5,
                               atol=1e-4)
    assert [h.get("_source") for h in th] == [h.get("_source") for h in rh]
    assert t["hits"].get("total") == r["hits"].get("total")
    if rh:
        np.testing.assert_allclose(t["hits"]["max_score"],
                                   r["hits"]["max_score"], rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("shards", SHARDS)
def test_ann_search_matches_reference(nodes, policy, shards, sim, kernel,
                                      precision):
    ref, port, data = nodes
    policy(kernel=kernel, adc_precision=precision)
    stats0 = dict(torch_executor.knn_path_stats)
    served0 = torch_serving.stats["distributed_searches"]
    queries = _queries(data, shards * 7 + len(sim))
    for q in queries:
        body = {"query": {"knn": {"v": {"vector": q.tolist(), "k": 10}}},
                "size": 10, "_source": ["tag"]}
        _assert_same(ref.search(_index(shards, sim), body),
                     port.search(_index(shards, sim), body))
    # every shard's one segment took the ANN branch, once per search; the
    # stacked step declined every search
    assert (torch_executor.knn_path_stats["ann"] - stats0["ann"]
            == shards * len(queries))
    assert torch_executor.knn_path_stats["fused"] == stats0["fused"]
    assert torch_serving.stats["distributed_searches"] == served0


def test_pages_and_totals_match_reference(nodes, policy):
    ref, port, data = nodes
    policy(kernel="pallas")
    name = _index(2, "l2_norm")
    for extra in ({"from": 4, "size": 6}, {"from": 15, "size": 10},
                  {"track_total_hits": 5}, {"track_total_hits": False},
                  {"_source": False}, {"size": 0}):
        body = {"query": {"knn": {"v": {"vector": data[10].tolist(),
                                        "k": 12}}}, **extra}
        _assert_same(ref.search(name, body), port.search(name, body))


@pytest.mark.parametrize("nprobe", (1, 3, 8))
def test_nprobe_method_parameter_matches_reference(nodes, policy, nprobe):
    ref, port, data = nodes
    policy(kernel="pallas", adc_precision="int8")
    body = {"query": {"knn": {"v": {
        "vector": (data[3] + 0.5).tolist(), "k": 5,
        "method_parameters": {"nprobe": nprobe}}}}}
    _assert_same(ref.search(_index(1, "cosine"), body),
                 port.search(_index(1, "cosine"), body))


@pytest.mark.parametrize("kernel", KERNELS)
def test_ann_segment_beside_an_exact_one(nodes, policy, kernel):
    """A shard whose second refresh added fewer than min_train docs: that
    segment takes the exact branch (the fused kNN wrapper), the first the
    ANN branch, and the shard cut merges both as the reference does."""
    ref, port, data = nodes
    policy(kernel=kernel)
    (shard,) = port.indices["mixed"].shards.values()
    anns = [dev.vector_fields["v"].ann is not None
            for _h, dev in shard.acquire_searcher().segments]
    assert anns == [True, False]
    stats0 = dict(torch_executor.knn_path_stats)
    queries = [data[650], data[20], (data[700] + data[30]) / 2]
    for q in queries:
        body = {"query": {"knn": {"v": {"vector": q.tolist(), "k": 10}}}}
        _assert_same(ref.search("mixed", body), port.search("mixed", body))
    assert torch_executor.knn_path_stats["ann"] - stats0["ann"] == 3
    assert torch_executor.knn_path_stats["fused"] - stats0["fused"] == 3


def test_exact_knn_per_shard_route_matches_reference(nodes):
    """With the stacked step switched off on both packages, exact kNN takes
    the per-shard route (the fused kNN wrapper per segment, then the host
    merge) and answers as the reference does; switched back on, the same
    bodies take the stacked step again."""
    ref, port, data = nodes
    bodies = [{"query": {"knn": {"v": {"vector": (data[i] + 0.1).tolist(),
                                       "k": k}}}, "size": size}
              for i, k, size in ((5, 10, 10), (99, 4, 8), (250, 16, 3))]
    jax_serving.enabled = torch_serving.enabled = False
    try:
        stats0 = dict(torch_executor.knn_path_stats)
        served0 = torch_serving.stats["distributed_searches"]
        off = [port.search("exact", b) for b in bodies]
        for body, t in zip(bodies, off):
            _assert_same(ref.search("exact", body), t)
        assert torch_serving.stats["distributed_searches"] == served0
        # two shards, one segment each
        assert (torch_executor.knn_path_stats["fused"] - stats0["fused"]
                == 2 * len(bodies))
    finally:
        jax_serving.enabled = torch_serving.enabled = True
    served0 = torch_serving.stats["distributed_searches"]
    for body, t in zip(bodies, off):
        on = port.search("exact", body)
        assert [h["_id"] for h in on["hits"]["hits"]] == \
            [h["_id"] for h in t["hits"]["hits"]]
        assert on["hits"]["total"] == t["hits"]["total"]
    assert torch_serving.stats["distributed_searches"] - served0 == 3


def test_ann_policy_settings_surface():
    cfg = torch_ann.AnnServingConfig()
    assert (cfg.kernel, cfg.adc_precision, cfg.rescore_multiplier) == (
        "auto", "fp32", 4)
    assert torch_ann.resolve_kernel(cfg.kernel) == "pallas"
    with pytest.raises(ValueError):
        cfg.configure(adc_precision="int4")
    with pytest.raises(ValueError):
        cfg.configure(kernel="mosaic")
    cfg.configure(rescore_multiplier=0)
    assert cfg.rescore_multiplier == 1
    snap = cfg.snapshot()
    assert set(snap["index_builds"]) == {"builds", "build_wall_ns",
                                         "last_generation"}
    for nprobe, nlist in ((1, 8), (3, 8), (5, 8), (9, 8), (0, 4), (6, 64)):
        assert (torch_ann.bucket_nprobe(nprobe, nlist)
                == jax_ann.bucket_nprobe(nprobe, nlist))
    for setting in ("ADC_PRECISION_SETTING", "RESCORE_MULTIPLIER_SETTING",
                    "KERNEL_SETTING"):
        assert (getattr(torch_ann, setting).key
                == getattr(jax_ann, setting).key)
    # the plain scan on CPU tensors is never counted as a kernel launch
    assert adc_scan.launches.count == 0
