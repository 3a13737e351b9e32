"""K1's large-r tier (opensearch_tpu_torch/csrc/knn_large.cuh: fp32 at
r > 1024; csrc/knn_large_mma.cuh: bf16 and int8 at r > 1024, the
tensor-core tier's dots feeding the same select), on the CPU.

The stacked serving step asks K1 for r = k_shard = min(k, n_flat), with no
cap, as the reference's does (opensearch_tpu/search/distributed_serving.py,
opensearch_tpu/parallel/distributed.py). The CUDA kernels run only on the
card (``chip_smoke.py`` holds them bit for bit against a brute force summed
in their order). Here:

1. Their rule, emulated in numpy as the kernels take it: every live doc's
   order-preserving score key above ~doc id; the threshold of the r best
   by the wide tier's radix select (tests/test_torch_wide.py's emulation of
   it) when more than r docs are live, else every live doc; the winners
   sorted by key and padded with (-inf, -1). It must equal
   ``ops/knn_fused.plain_pool`` bit for bit on sixteenths (every dot exact
   in f32) at r = 1025, 2000, the shard's size and past it, one and four
   shards (one with 5 live docs), the three similarities; and the JAX
   reference's ``_fused_xla_pool`` at r = 1025 and 2000. At bf16 and
   int8 the same rule over the reduced-precision dots must equal
   ``plain_pool`` at that precision, and its first 1024 slots the pool
   at r = 1024 (the tensor-core tier's).
2. The plan arithmetic: the scan keeps no pool, so its ring and 8-query
   tile fit the card's shared memory at d = 128 and 768 whatever r is; the
   select's scratch fits at every r from 1025 to n_flat (2^18 and 2^20 at
   d = 128 and 768), its winners sorted in shared memory up to 16,384 and
   in device scratch rows above; the wrapper names the tier by (precision,
   r) alone and never loads the library for CPU tensors. The tensor-core
   scan's plan (ring and padded query tile of 32-bit words) fits at
   d = 128 and 768 at both precisions.
3. The stacked step at k = 1025 and 2000 over 768-d docs (sixteenths, so
   the deep ranks' near ties are the same scores in both frameworks):
   TorchNode (device="cpu") against TpuNode's ``mesh_knn_batch``, ids
   equal, scores to rtol 1e-5 / atol 1e-4 (as tests/test_torch_node_knn.py
   states); the same at bf16 and int8 (the reference's XLA pool, R = k
   past 512, then the exact fp32 rescore).
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from opensearch_tpu.node import TpuNode
from opensearch_tpu.ops import pallas_knn
from opensearch_tpu.search import distributed_serving as jax_serving
from opensearch_tpu.telemetry import roofline
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.ops import cuda_lib, knn_fused
from opensearch_tpu_torch.search import distributed_serving as torch_serving

from test_torch_wide import N_DOCS, SIMS, _case, _pair_key, _radix_threshold

F32 = np.float32
QT = knn_fused.WIDE_QUERY_TILE
STEP = knn_fused.WIDE_STEP


def _emulated_large(s: int, b: int, r: int, similarity: str,
                    precision: str = "fp32"):
    """(vals [s, b, r], ids [s, b, r]) by the large-r tier's rule, over the
    dots at `precision` (the operands prepped as knn_fused_stacked preps
    them)."""
    v, norms, valid, q = _case(s, b)
    qsq = (torch.from_numpy(q) ** 2).sum(1)
    v_x, q_x, scale = knn_fused._prep_operands(
        torch.from_numpy(v), torch.from_numpy(q), precision)
    dots = knn_fused._fused_dots(q_x, v_x, precision, scale)
    scores = knn_fused._transform_scores(
        dots, qsq[None, :, None], torch.from_numpy(norms)[:, None, :],
        similarity).numpy()
    vals = np.full((s, b, r), -np.inf, F32)
    ids = np.full((s, b, r), -1, np.int32)
    for si in range(s):
        for bi in range(b):
            live = np.nonzero(valid[si])[0]
            keys = [_pair_key(scores[si, bi, d], int(d)) for d in live]
            t = _radix_threshold(keys, r) if len(keys) > r else 1
            won = sorted(((k, int(d)) for k, d in zip(keys, live) if k >= t),
                         reverse=True)
            assert len(won) == min(len(keys), r)
            for j, (_k, d) in enumerate(won):
                vals[si, bi, j] = scores[si, bi, d]
                ids[si, bi, j] = d
    return vals, ids


def _plain(s: int, b: int, r: int, similarity: str,
           precision: str = "fp32"):
    v, norms, valid, q = (torch.from_numpy(a) for a in _case(s, b))
    v_x, q_x, scale = knn_fused._prep_operands(v, q, precision)
    return knn_fused.plain_pool(v_x, norms, valid, q_x, (q * q).sum(1),
                                scale, r=r, similarity=similarity,
                                score_precision=precision)


@pytest.mark.parametrize("similarity", SIMS)
@pytest.mark.parametrize("r", (1025, 2000, N_DOCS, N_DOCS + 500))
def test_emulated_large_tier_equals_plain_pool(r, similarity):
    got_v, got_i = _emulated_large(1, 3, r, similarity)
    pv, pi = _plain(1, 3, r, similarity)
    np.testing.assert_array_equal(got_i, pi.numpy())
    np.testing.assert_array_equal(got_v, pv.numpy())


@pytest.mark.parametrize("r", (1025, N_DOCS + 500))
def test_emulated_large_tier_over_four_shards(r):
    """Four shards, the last with 5 live docs: fewer than r, so its row is
    every live doc and then (-inf, -1)."""
    got_v, got_i = _emulated_large(4, 2, r, "l2_norm")
    pv, pi = _plain(4, 2, r, "l2_norm")
    np.testing.assert_array_equal(got_i, pi.numpy())
    np.testing.assert_array_equal(got_v, pv.numpy())
    assert (got_i[3] >= 0).sum(axis=1).tolist() == [5, 5]


@pytest.mark.parametrize("similarity", SIMS)
@pytest.mark.parametrize("r", (1025, 2000, N_DOCS + 500))
@pytest.mark.parametrize("precision", ("bf16", "int8"))
def test_emulated_reduced_large_tier_equals_plain_pool(precision, r,
                                                       similarity):
    """The tensor-core scan's keys (the dots at bf16 or int8, the same
    transform) through the same select: plain_pool at that precision bit
    for bit."""
    got_v, got_i = _emulated_large(1, 3, r, similarity, precision)
    pv, pi = _plain(1, 3, r, similarity, precision)
    np.testing.assert_array_equal(got_i, pi.numpy())
    np.testing.assert_array_equal(got_v, pv.numpy())


@pytest.mark.parametrize("precision", ("bf16", "int8"))
def test_reduced_large_pool_extends_the_tensor_core_pool(precision):
    """A doc's score is the same in both tiers, so the first 1024 slots of
    the large-r pool at r = 1025 are the r = 1024 pool (the tensor-core
    tier's), bit for bit, and slot 1025 comes after them."""
    big_v, big_i = _emulated_large(1, 3, 1025, "l2_norm", precision)
    pv, pi = _plain(1, 3, 1024, "l2_norm", precision)
    np.testing.assert_array_equal(big_i[:, :, :1024], pi.numpy())
    np.testing.assert_array_equal(big_v[:, :, :1024], pv.numpy())
    assert (big_v[:, :, 1024] <= big_v[:, :, 1023]).all()


@pytest.mark.parametrize("r", (1025, 2000))
def test_emulated_large_tier_equals_reference_xla_pool(r):
    """Against the JAX reference's XLA pool on the same numpy inputs: ids
    equal; scores to rtol 1e-6 (XLA may fuse the transform's operations,
    which the port and the kernels round one at a time)."""
    v, norms, valid, q = _case(1, 2)
    qj = jnp.asarray(q)
    jv, ji = pallas_knn._fused_xla_pool(
        jnp.asarray(v[0]), jnp.asarray(norms[0]), jnp.asarray(valid[0]), qj,
        jnp.sum(qj * qj, axis=1, keepdims=True), jnp.ones((1,), jnp.float32),
        r=r, similarity="l2_norm", score_precision="fp32")
    got_v, got_i = _emulated_large(1, 2, r, "l2_norm")
    np.testing.assert_array_equal(got_i[0], np.asarray(ji))
    np.testing.assert_allclose(got_v[0], np.asarray(jv), rtol=1e-6, atol=0)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------


def _scan_smem(stages, floats, d):
    """csrc/knn_large.cuh scan_smem_bytes: the ring and the 8-query tile (d
    cut into whole chunks); 0 for a ring with no kernel."""
    if (stages, floats) not in knn_fused.WIDE_RINGS:
        return 0
    dc = floats // STEP
    return 4 * (stages * floats + QT * (-(-d // dc) * dc))


def _sort_slots(r: int) -> int:
    """csrc/knn_large.cuh sort_slots: the winners' power of two where it
    exceeds 16,384 (they sort in a device scratch row), else 0."""
    p = max(32, 1 << (r - 1).bit_length())
    return p if p > 16384 else 0


def _select_smem(r: int) -> int:
    """csrc/knn_large.cuh select_smem_bytes: two keys a warp of 16, a
    256-bin histogram and eight ints, and the winners' power of two of
    (score, id) slots where they sort in shared memory."""
    p = max(32, 1 << (r - 1).bit_length())
    return 8 * 2 * 16 + 4 * (256 + 8) + (0 if _sort_slots(r) else 8 * p)


@pytest.mark.parametrize("d,want", [(1, (3, 16384)), (128, (3, 16384)),
                                    (768, (3, 16384)), (1200, (2, 16384)),
                                    (4000, (2, 8192))])
def test_large_plan_fits_the_shared_memory(d, want):
    plan = knn_fused.large_plan(d, _scan_smem)
    assert plan == want
    assert _scan_smem(*plan, d) <= knn_fused._MAX_SMEM


def _mma_scan_smem(prec: str, stages: int, words: int, d: int) -> int:
    """csrc/knn_large_mma.cuh scan_smem_bytes: the ring and the 8-query
    tile of 32-bit words (2 bf16 or 4 int8 a word; the row cut into whole
    chunks of words / 1024, plus 4 words of padding); 0 for a ring with no
    kernel."""
    if (stages, words) not in knn_fused.WIDE_RINGS:
        return 0
    w = -(-d * {"bf16": 2, "int8": 1}[prec] // 4)
    dc = words // STEP
    return 4 * (stages * words + QT * (-(-w // dc) * dc + 4))


@pytest.mark.parametrize("precision,d,want", [
    ("bf16", 128, (3, 16384)), ("bf16", 768, (3, 16384)),
    ("int8", 128, (3, 16384)), ("int8", 768, (3, 16384)),
    ("bf16", 2400, (2, 16384)), ("int8", 4800, (2, 16384)),
    ("bf16", 8000, (2, 8192))])
def test_large_mma_plan_fits_the_shared_memory(precision, d, want):
    """The tensor-core scan keeps no pool: its ring and query tile fit at
    the serving widths at either precision, the 3 x 64 KB ring first (an
    int8 row is half a bf16 row's words, so it steps down at twice the
    width)."""
    model = functools.partial(_mma_scan_smem, precision)
    plan = knn_fused.large_plan(d, model, precision)
    assert plan == want
    assert model(*plan, d) <= knn_fused._MAX_SMEM


def test_large_mma_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="bf16 d=20000"):
        knn_fused.large_plan(20_000, functools.partial(_mma_scan_smem,
                                                       "bf16"), "bf16")


def test_large_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        knn_fused.large_plan(8192, _scan_smem)


@pytest.mark.parametrize("n_flat", (1 << 18, 1 << 20))
@pytest.mark.parametrize("d", (128, 768))
def test_a_plan_exists_for_every_r_up_to_n_flat(d, n_flat):
    """Every r the stacked step can ask for at fp32 past the wide tier
    (1025 <= r <= n_flat) is the large-r tier's, with a scan plan (r plays
    no part in it) and a select whose scratch fits shared memory; the
    winners sort in shared memory exactly up to 16,384 of them."""
    stages, floats = knn_fused.large_plan(d, _scan_smem)
    assert _scan_smem(stages, floats, d) <= knn_fused._MAX_SMEM
    rs = np.arange(1025, n_flat + 1)
    p2 = np.maximum(32, 1 << np.ceil(np.log2(rs)).astype(np.int64))
    assert (p2 >= rs).all() and (p2 < 2 * rs).all()
    smem = 8 * 2 * 16 + 4 * (256 + 8) + np.where(p2 <= 16384, 8 * p2, 0)
    assert smem.max() <= knn_fused._MAX_SMEM
    for r in (1025, 16384, 16385, n_flat):
        assert knn_fused.scan_tier("fp32", r) == "large"
        assert (_sort_slots(r) == 0) == (r <= 16384)
        assert _sort_slots(r) == 0 or r <= _sort_slots(r) < 2 * r
        assert _select_smem(r) <= knn_fused._MAX_SMEM


@pytest.mark.parametrize("precision,r,want", [
    ("fp32", 1024, "wide"), ("fp32", 1025, "large"), ("fp32", 10_000, "large"),
    ("fp32", 1 << 20, "large"), ("bf16", 1025, "large_mma"),
    ("int8", 2000, "large_mma")])
def test_tier_past_the_wide_tier(precision, r, want):
    assert knn_fused.scan_tier(precision, r) == want


@pytest.mark.parametrize("n_flat", (1 << 18, 1 << 20))
@pytest.mark.parametrize("d", (128, 768))
@pytest.mark.parametrize("precision", ("bf16", "int8"))
def test_every_reduced_r_past_1024_has_a_design(precision, d, n_flat):
    """Every r the stacked step can ask for at bf16 and int8 past the
    tensor-core tier (1025 <= r <= n_flat: R = k there) is the large-r
    tier's tensor-core scan, with a scan plan that fits and the select's
    scratch of the fp32 tier; no r reaches the tile scan."""
    model = functools.partial(_mma_scan_smem, precision)
    stages, words = knn_fused.large_plan(d, model, precision)
    assert model(stages, words, d) <= knn_fused._MAX_SMEM
    for r in (1025, 1461, 2000, 4096, 16384, 16385, n_flat):
        assert knn_fused.scan_tier(precision, r) == "large_mma"
        assert _select_smem(r) <= knn_fused._MAX_SMEM
    assert knn_fused.scan_tier(precision, 1024) == "mma"


def test_cpu_tensors_take_plain_pool_at_large_r():
    """A CPU tensor at r past 1024 takes plain_pool: no launch of any
    design is counted, and no kernel library is built or loaded."""
    v, norms, valid, q = (torch.from_numpy(a) for a in _case(1, 3))
    counters = (knn_fused.launches, knn_fused.large_launches)
    before = [c.count for c in counters]
    libs = dict(cuda_lib._libs)
    got = knn_fused.pool_scan(v, norms, valid, q, (q * q).sum(1),
                              torch.ones(1), r=2000, similarity="l2_norm",
                              score_precision="fp32")
    want = _plain(1, 3, 2000, "l2_norm")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [c.count for c in counters] == before
    assert cuda_lib._libs == libs


@pytest.mark.parametrize("precision", ("bf16", "int8"))
def test_cpu_tensors_take_plain_pool_at_reduced_large_r(precision):
    v, norms, valid, q = (torch.from_numpy(a) for a in _case(1, 3))
    v_x, q_x, scale = knn_fused._prep_operands(v, q, precision)
    counters = (knn_fused.launches, knn_fused.large_launches,
                knn_fused.large_mma_launches, knn_fused.tile_launches)
    before = [c.count for c in counters]
    libs = dict(cuda_lib._libs)
    got = knn_fused.pool_scan(v_x, norms, valid, q_x, (q * q).sum(1), scale,
                              r=2000, similarity="cosine",
                              score_precision=precision)
    want = _plain(1, 3, 2000, "cosine", precision)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [c.count for c in counters] == before
    assert cuda_lib._libs == libs


# --------------------------------------------------------------------------
# the stacked step at k > 1024 against the reference
# --------------------------------------------------------------------------

LARGE_DIM = 768
LARGE_DOCS = 2500


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    prev_peaks = roofline.current_peaks()
    roofline.set_peaks(roofline.stub_peaks(seed=3))
    rng = np.random.default_rng(31)
    centers = rng.standard_normal((16, LARGE_DIM))
    # sixteenths: every dot and |v|^2 exact in f32 in either framework's
    # order, so the deep ranks (near ties among thousands of 768-d docs)
    # are the same scores on both sides and ties go to the lower id
    data = np.round((centers[rng.integers(0, 16, LARGE_DOCS)]
                     + 0.5 * rng.standard_normal((LARGE_DOCS, LARGE_DIM)))
                    * 16).astype(F32) / 16
    ref = TpuNode(tmp_path_factory.mktemp("tpu"))
    port = TorchNode(tmp_path_factory.mktemp("torch"), device="cpu")
    for node in (ref, port):
        node.create_index("big", {"mappings": {"properties": {"v": {
            "type": "knn_vector", "dimension": LARGE_DIM,
            "similarity": "l2_norm"}}}})
        node.bulk([("index", {"_index": "big", "_id": str(i)},
                    {"v": data[i].tolist()}) for i in range(LARGE_DOCS)]
                  + [("delete", {"_index": "big", "_id": "9"}, None)],
                  refresh=True)
    yield ref, port, data
    ref.close()
    port.close()
    if prev_peaks is not None:
        roofline.set_peaks(prev_peaks)


@pytest.mark.parametrize("k", (1025, 2000))
def test_stacked_step_at_large_k_matches_reference(nodes, k):
    ref, port, data = nodes
    before = (jax_serving.stats["distributed_searches"],
              torch_serving.stats["distributed_searches"])
    body = {"query": {"knn": {"v": {"vector": (data[3] + 0.0625).tolist(),
                                    "k": k}}},
            "size": k, "_source": False}
    r, t = ref.search("big", body), port.search("big", body)
    rh, th = r["hits"]["hits"], t["hits"]["hits"]
    assert len(th) == k
    assert [h["_id"] for h in th] == [h["_id"] for h in rh]
    np.testing.assert_allclose([h["_score"] for h in th],
                               [h["_score"] for h in rh], rtol=1e-5,
                               atol=1e-4)
    assert t["hits"]["total"] == r["hits"]["total"]
    assert jax_serving.stats["distributed_searches"] - before[0] == 1
    assert torch_serving.stats["distributed_searches"] - before[1] == 1


def test_k_past_n_flat_returns_every_live_doc(nodes):
    _ref, port, data = nodes
    resp = port.search("big", {"query": {"knn": {"v": {
        "vector": data[0].tolist(), "k": 5000}}}, "size": 5000,
        "_source": False})
    ids = [h["_id"] for h in resp["hits"]["hits"]]
    assert len(ids) == LARGE_DOCS - 1 and "9" not in ids


@pytest.mark.parametrize("k", (1025, 2000))
@pytest.mark.parametrize("precision", ("bf16", "int8"))
def test_reduced_stacked_step_at_large_k_matches_reference(nodes, precision,
                                                           k):
    """search.knn.score_precision bf16 and int8 past k = 1024 (R = k: the
    large-r tier's tensor-core scan on the card, plain_pool here) against
    the reference's stacked step: ids equal, scores as above."""
    from opensearch_tpu.search import ann as jax_ann
    from opensearch_tpu_torch.search import ann as torch_ann

    ref, port, data = nodes
    jax_ann.default_config.configure(exact_kernel="xla",
                                     score_precision=precision)
    torch_ann.default_config.configure(score_precision=precision)
    try:
        body = {"query": {"knn": {"v": {
            "vector": (data[7] - 0.125).tolist(), "k": k}}},
            "size": k, "_source": False}
        r, t = ref.search("big", body), port.search("big", body)
    finally:
        jax_ann.default_config.configure(exact_kernel="auto",
                                         score_precision="fp32")
        torch_ann.default_config.configure(score_precision="fp32")
    rh, th = r["hits"]["hits"], t["hits"]["hits"]
    assert len(th) == k
    assert [h["_id"] for h in th] == [h["_id"] for h in rh]
    np.testing.assert_allclose([h["_score"] for h in th],
                               [h["_score"] for h in rh], rtol=1e-5,
                               atol=1e-4)
