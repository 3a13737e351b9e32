"""The port's streaming and materializing exact-kNN scans against the JAX
reference, on the CPU: the selection helpers (opensearch_tpu_torch/ops/
topk.py), the scan programs (ops/fused.py) and the per-shard executor's
three-way exact branch (search/executor.py), mirroring the reference's
tests/test_knn_streaming.py.

Selection runs on the same score bits in both packages, so values and ids
must be equal. The scans score in full float32 in both, summing the d
products in another order: ids must be equal, scores agree to rtol 1e-5
(atol 2e-5 for l2, whose |q|^2 - 2 q.v + |v|^2 cancels near a neighbour).
Through the nodes, hits must be the same ids in the same order with scores
to rtol 1e-5 / atol 1e-4, and both executors must count the same branch.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from opensearch_tpu.node import TpuNode
from opensearch_tpu.ops import fused as jax_fused
from opensearch_tpu.ops import topk as jax_topk
from opensearch_tpu.search import ann as jax_ann
from opensearch_tpu.search import distributed_serving as jax_serving
from opensearch_tpu.search import executor as jax_executor
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.ops import fused as torch_fused
from opensearch_tpu_torch.ops import topk as torch_topk
from opensearch_tpu_torch.search import ann as torch_ann
from opensearch_tpu_torch.search import distributed_serving as torch_serving
from opensearch_tpu_torch.search import executor as torch_executor

SIMS = ("l2_norm", "cosine", "dot_product")


def _same_selection(scores: np.ndarray, k: int, **kw) -> None:
    jv, ji = jax_topk.blockwise_topk(jnp.asarray(scores), k, **kw)
    tv, ti = torch_topk.blockwise_topk(torch.from_numpy(scores), k, **kw)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("n,k,block_size", [
    (40_000, 10, 512),     # the pruned two-stage branch
    (40_000, 10, 4096),    # nb <= 2k: one sort
    (40_000, 200, 512),    # k > MAX_ITERATIVE_K: one sort
    (5, 8, 4096),          # k > n: (-inf, padding position) tail
    (1000, 4, 4096),       # n < BLOCKWISE_MIN_N: one sort
])
def test_blockwise_topk_matches_reference(n, k, block_size):
    """Integer scores with many planted ties and -inf holes: ties go to
    the lower doc id on every branch, as in the reference."""
    rng = np.random.default_rng(n + k)
    scores = rng.integers(0, 50, (3, n)).astype(np.float32)
    scores[:, rng.choice(n, n // 10, replace=False)] = -np.inf
    if n > 2 * block_size:
        scores[1, -1] = scores[1, block_size + 3] = 99.0   # across blocks
    _same_selection(scores, k, block_size=block_size)


def test_pruned_branch_with_fewer_live_blocks_than_k():
    scores = np.full((2, 40_000), -np.inf, np.float32)
    scores[0, [7, 600, 39_999]] = [3.0, 5.0, 5.0]
    _same_selection(scores, 6, block_size=512)


def test_pruned_branch_leaves_the_scores_untouched():
    """The argmax-and-mask passes work on copies: the caller's scores come
    back as they went in, and a second call answers the same."""
    rng = np.random.default_rng(3)
    scores = rng.integers(0, 9, (2, 40_000)).astype(np.float32)
    t = torch.from_numpy(scores.copy())
    first = torch_topk.blockwise_topk(t, 12, block_size=512)
    np.testing.assert_array_equal(t.numpy(), scores)
    second = torch_topk.blockwise_topk(t, 12, block_size=512)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _same_selection(scores, 12, block_size=512)


def _corpus(n: int, d: int, n_dup: int = 0, seed: int = 0):
    """The reference test's corpus: n_pad (next power of two) rows, the
    tail dead; n_dup duplicated rows force exact ties across chunks."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d)).astype(np.float32)
    if n_dup:
        v[rng.integers(0, n, n_dup)] = v[rng.integers(0, n, n_dup)]
    n_pad = 1 << (n - 1).bit_length()
    vp = np.zeros((n_pad, d), np.float32)
    vp[:n] = v
    norms = (vp.astype(np.float64) ** 2).sum(1).astype(np.float32)
    return vp, norms, np.arange(n_pad) < n


def _both(fn_name: str, arrays, **kw):
    jv, ji = getattr(jax_fused, fn_name)(*(jnp.asarray(a) for a in arrays),
                                         **kw)
    tv, ti = getattr(torch_fused, fn_name)(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), **kw)
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


@pytest.mark.parametrize("similarity", SIMS)
@pytest.mark.parametrize("chunk", (512, 4096))
def test_scans_match_reference(chunk, similarity):
    """Eight chunks, and the whole 4096-row corpus as one."""
    vp, norms, valid = _corpus(3000, 16)
    q = np.random.default_rng(1).standard_normal((7, 16)).astype(np.float32)
    (jv, ji), (tv, ti) = _both("knn_topk_streaming", (vp, norms, valid, q),
                               k=5, similarity=similarity, chunk=chunk)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5,
                               atol=2e-5 if similarity == "l2_norm" else 0)


def test_streaming_tiebreak_across_chunks():
    vp, norms, valid = _corpus(2048, 8, n_dup=1500, seed=3)
    q = np.random.default_rng(4).standard_normal((5, 8)).astype(np.float32)
    (jv, ji), (tv, ti) = _both("knn_topk_streaming", (vp, norms, valid, q),
                               k=10, chunk=256)
    np.testing.assert_array_equal(ti, ji)
    # and the port's streaming scan equals the reference's materializing one
    mv, mi = jax_fused.knn_topk(*(jnp.asarray(a) for a in
                                  (vp, norms, valid, q)), k=10)
    np.testing.assert_array_equal(ti, np.asarray(mi))
    np.testing.assert_allclose(tv, np.asarray(mv), rtol=1e-5, atol=2e-5)


def test_streaming_fewer_docs_than_k():
    vp, norms, valid = _corpus(3, 4)
    q = np.ones((2, 4), np.float32)
    (jv, ji), (tv, ti) = _both("knn_topk_streaming", (vp, norms, valid, q),
                               k=8, chunk=2)
    finite = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), finite)
    np.testing.assert_array_equal(ti[finite], ji[finite])


def test_streaming_needs_a_chunk_multiple():
    vp, norms, valid = _corpus(100, 4)
    with pytest.raises(ValueError, match="multiple"):
        torch_fused.knn_topk_streaming(
            *(torch.from_numpy(a) for a in (vp, norms, valid)),
            torch.ones((1, 4)), k=3, chunk=96)
    assert torch_fused.cached_knn_streaming(8, "l2_norm", 32) is \
        torch_fused.cached_knn_streaming(8, "l2_norm", 32)


# ---------------------------------------------------------------------------
# the executor's exact branches, TorchNode(device="cpu") against TpuNode
# ---------------------------------------------------------------------------

# one shard: n_pad 2048, two 1024-doc chunks; two shards: n_pad 640 each,
# one chunk (the chunk is min(STREAMING_CHUNK, n_pad))
N_DOCS = 1100
DIM = 8
INDICES = {"l2": ("l2_norm", 1), "cos": ("cosine", 2)}


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    rng = np.random.default_rng(7)
    data = rng.standard_normal((N_DOCS, DIM)).round(3).astype(np.float32)
    ref = TpuNode(tmp_path_factory.mktemp("tpu"))
    port = TorchNode(tmp_path_factory.mktemp("torch"), device="cpu")
    for node in (ref, port):
        for name, (sim, shards) in INDICES.items():
            node.create_index(name, {
                "settings": {"number_of_shards": shards},
                "mappings": {"properties": {"v": {
                    "type": "knn_vector", "dimension": DIM,
                    "similarity": sim}}}})
            node.bulk([("index", {"_index": name, "_id": f"d{i}"},
                        {"v": data[i].tolist()}) for i in range(N_DOCS)],
                      refresh=True)
    yield ref, port, data
    ref.close()
    port.close()


@pytest.fixture()
def per_shard_route(monkeypatch):
    """Both packages on the per-shard route with the streaming threshold
    and chunk patched down to the test corpus; returns a setter of the
    exact-path kernel policy, restored after the test."""
    for serving in (jax_serving, torch_serving):
        monkeypatch.setattr(serving, "enabled", False)
    for ex in (jax_executor, torch_executor):
        monkeypatch.setattr(ex, "STREAMING_CHUNK", 1024)

    def setup(policy: str, min_docs: int):
        for ex in (jax_executor, torch_executor):
            monkeypatch.setattr(ex, "STREAMING_MIN_DOCS", min_docs)
        for ann in (jax_ann, torch_ann):
            ann.default_config.configure(exact_kernel=policy)

    yield setup
    for ann in (jax_ann, torch_ann):
        ann.default_config.configure(exact_kernel="auto")


@pytest.mark.parametrize("branch", ("streaming", "materializing"))
@pytest.mark.parametrize("policy,k", [("xla", 7), ("xla", 200),
                                      ("pallas", 200)])
@pytest.mark.parametrize("index", sorted(INDICES))
def test_exact_branches_match_reference(nodes, per_shard_route, index,
                                        policy, k, branch):
    """search.knn.kernel=xla, or a k bucket past FUSED_MAX_K, takes the
    streaming scan (segments of STREAMING_MIN_DOCS docs or more) or the
    materializing one (smaller), as in the reference: the same hits and
    the same knn_path_stats key."""
    ref, port, data = nodes
    per_shard_route(policy, 8 if branch == "streaming" else 10**9)
    ref0, port0 = dict(jax_executor.knn_path_stats), \
        dict(torch_executor.knn_path_stats)
    rng = np.random.default_rng(k)
    queries = [data[5] + 0.01, rng.standard_normal(DIM).astype(np.float32)]
    for qv in queries:
        body = {"query": {"knn": {"v": {"vector": qv.tolist(), "k": k}}},
                "size": 12}
        r, t = ref.search(index, body), port.search(index, body)
        rh, th = r["hits"]["hits"], t["hits"]["hits"]
        assert [h["_id"] for h in th] == [h["_id"] for h in rh]
        np.testing.assert_allclose([h["_score"] for h in th],
                                   [h["_score"] for h in rh], rtol=1e-5,
                                   atol=1e-4)
        assert t["hits"]["total"] == r["hits"]["total"]
    shards = INDICES[index][1]
    for stats, before in ((jax_executor.knn_path_stats, ref0),
                          (torch_executor.knn_path_stats, port0)):
        moved = {key: stats[key] - before[key] for key in stats}
        assert moved[branch] == shards * len(queries), moved
        assert sum(moved.values()) == moved[branch], moved


def test_exact_knn_past_fused_max_k_is_served(nodes, monkeypatch):
    """No "not yet ported" past FUSED_MAX_K: the default policy serves k =
    500 through the per-shard route (the segment's 1100 docs are below the
    real STREAMING_MIN_DOCS, so it materializes)."""
    _ref, port, data = nodes
    monkeypatch.setattr(torch_serving, "enabled", False)
    before = torch_executor.knn_path_stats["materializing"]
    r = port.search("l2", {"query": {"knn": {"v": {
        "vector": data[9].tolist(), "k": 500}}}, "size": 3})
    assert r["hits"]["hits"][0]["_id"] == "d9"
    assert r["hits"]["total"]["value"] == 500
    assert torch_executor.knn_path_stats["materializing"] == before + 1
