"""TorchNode(device="cpu") against TpuNode on the same kNN `_search`s.

One bulk (with a few deletes, across two refreshes) goes into both nodes,
for 1 and 4 shards and each similarity; the same `knn` bodies must give the
same hit `_id`s in the same order, the same `hits.total`, and `_score`s to
rtol 1e-5 / atol 1e-4: the two frameworks sum the d products in another
order, and l2's |q|^2 - 2 q.v + |v|^2 cancels near a neighbour, so the
few ulps of |q|^2 ~ 300 (3e-5 each) that the orders differ by reach d^2
whole. Both packages' serving paths
must have run.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu.search import distributed_serving as jax_serving
from opensearch_tpu.telemetry import roofline
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.search import distributed_serving as torch_serving

DIM = 16
N_DOCS = 400
SIMS = ("l2_norm", "cosine", "dot_product")
SHARDS = (1, 4)
DELETED = ("3", "17", "250", "399")


def _index(shards: int, sim: str) -> str:
    return f"knn-{shards}-{sim.replace('_', '-')}"


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    prev_peaks = roofline.current_peaks()
    roofline.set_peaks(roofline.stub_peaks(seed=3))
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((8, DIM)) * 4
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
                    "mappings": {"properties": {
                        "v": {"type": "knn_vector", "dimension": DIM,
                              "similarity": sim},
                        "tag": {"type": "keyword"}}},
                })
                ops = [("index", {"_index": name, "_id": str(i)},
                        {"v": data[i].tolist(), "tag": f"t{i % 5}"})
                       for i in range(N_DOCS)]
                node.bulk(ops[:N_DOCS // 2])
                node.refresh(name)
                node.bulk(ops[N_DOCS // 2:] + [
                    ("delete", {"_index": name, "_id": d}, None)
                    for d in DELETED])
                node.refresh(name)
    yield ref, port, data
    ref.close()
    port.close()
    if prev_peaks is not None:
        roofline.set_peaks(prev_peaks)


@pytest.mark.parametrize("size,k", ((5, 10), (12, 8), (3, 3)))
@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("shards", SHARDS)
def test_knn_search_matches_reference(nodes, shards, sim, size, k):
    ref, port, data = nodes
    rng = np.random.default_rng(shards * 100 + k)
    queries = [data[3], data[int(rng.integers(N_DOCS))] + 0.1,
               rng.standard_normal(DIM).astype(np.float32) * 4]
    before = (jax_serving.stats["distributed_searches"],
              torch_serving.stats["distributed_searches"])
    for q in queries:
        body = {"query": {"knn": {"v": {"vector": q.tolist(), "k": k}}},
                "size": size, "_source": ["tag"]}
        r = ref.search(_index(shards, sim), body)
        t = port.search(_index(shards, sim), body)
        rh, th = r["hits"]["hits"], t["hits"]["hits"]
        assert [h["_id"] for h in th] == [h["_id"] for h in rh]
        assert not set(DELETED) & {h["_id"] for h in th}
        np.testing.assert_allclose([h["_score"] for h in th],
                                   [h["_score"] for h in rh], rtol=1e-5,
                                   atol=1e-4)
        assert [h["_source"] for h in th] == [h["_source"] for h in rh]
        assert [h["_index"] for h in th] == [h["_index"] for h in rh]
        assert t["hits"]["total"] == r["hits"]["total"]
        np.testing.assert_allclose(t["hits"]["max_score"],
                                   r["hits"]["max_score"], rtol=1e-5,
                                   atol=1e-4)
    assert jax_serving.stats["distributed_searches"] - before[0] == 3
    assert torch_serving.stats["distributed_searches"] - before[1] == 3


def test_from_and_track_total_hits_match_reference(nodes):
    ref, port, data = nodes
    name = _index(4, "l2_norm")
    for extra in ({"from": 4, "size": 6}, {"track_total_hits": 5},
                  {"track_total_hits": False}, {"_source": False}):
        body = {"query": {"knn": {"v": {"vector": data[10].tolist(),
                                        "k": 10}}}, **extra}
        r, t = ref.search(name, body), port.search(name, body)
        assert [h["_id"] for h in t["hits"]["hits"]] == \
            [h["_id"] for h in r["hits"]["hits"]]
        assert t["hits"].get("total") == r["hits"].get("total")
        assert [("_source" in h) for h in t["hits"]["hits"]] == \
            [("_source" in h) for h in r["hits"]["hits"]]


@pytest.mark.parametrize("precision", ("bf16", "int8"))
def test_reduced_precision_policy_matches_reference(nodes, precision):
    """search.knn.score_precision applied to both packages: the widened
    pool plus exact rescore answers as the reference does."""
    from opensearch_tpu.search import ann as jax_ann
    from opensearch_tpu_torch.search import ann as torch_ann

    ref, port, data = nodes
    jax_ann.default_config.configure(exact_kernel="xla",
                                     score_precision=precision)
    torch_ann.default_config.configure(score_precision=precision)
    try:
        for sim in SIMS:
            body = {"query": {"knn": {"v": {"vector": data[42].tolist(),
                                            "k": 10}}}}
            r = ref.search(_index(4, sim), body)
            t = port.search(_index(4, sim), body)
            assert [h["_id"] for h in t["hits"]["hits"]] == \
                [h["_id"] for h in r["hits"]["hits"]]
            np.testing.assert_allclose(
                [h["_score"] for h in t["hits"]["hits"]],
                [h["_score"] for h in r["hits"]["hits"]], rtol=1e-5,
                atol=1e-4)
    finally:
        jax_ann.default_config.configure(exact_kernel="auto",
                                         score_precision="fp32")
        torch_ann.default_config.configure(score_precision="fp32")


def test_close_releases_the_serving_slabs(tmp_path):
    from opensearch_tpu_torch.cluster.shard_mesh import default_registry
    from opensearch_tpu_torch.search.ann import resolve_kernel

    node = TorchNode(tmp_path, device="cpu")
    node.create_index("gone", {"mappings": {"properties": {
        "v": {"type": "knn_vector", "dimension": 2}}}})
    node.bulk([("index", {"_index": "gone", "_id": "a"}, {"v": [1.0, 2.0]})],
              refresh=True)
    node.search("gone", {"query": {"knn": {"v": {"vector": [1, 2], "k": 1}}}})
    assert any(k[0] == "gone" for k in default_registry._bundles)
    node.close()
    assert not any(k[0] == "gone" for k in default_registry._bundles)
    assert resolve_kernel("auto") == "pallas"
    with pytest.raises(ValueError):
        resolve_kernel("cuda")
