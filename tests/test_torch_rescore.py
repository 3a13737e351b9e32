"""The fixed-order rescore and |q|^2 (opensearch_tpu_torch/ops/knn_rescore.py,
csrc/knn_rescore.cu), on the CPU.

The reference's batcher promises results bit-identical to the unbatched
path (tests/test_knn_batcher.py). A batched einsum cannot keep it on the
card: the library picks its summation order by the batch. The port sums
every dot of d products in one order, whatever the batch: lane l of 32
sums elements l, l + 32, ... in ascending order, each product rounded
and then added, then the 32 lane sums meet in a butterfly (xor 16, 8, 4,
2, 1). The CUDA kernels run only on the card (``chip_smoke.py`` holds
them bit for bit against these plain versions). Here:

1. The plain versions follow that order: equal bit for bit to a numpy
   emulation of it, written lane by lane, at d = 1, 30, 32, 100, 128 and
   768 (the last chunk ragged or whole).
2. A batch of B gives each query the bits of its solo call: |q|^2, the
   rescored scores, and the rescore's top k (``knn_fused._fused_rescore``),
   at B = 1-33, one and four shards, the three similarities, with -1
   candidates and dead docs.
3. The wrapper takes the plain versions for CPU tensors without counting a
   launch or loading the library, and refuses other devices.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from opensearch_tpu_torch.ops import cuda_lib, knn_fused, knn_rescore

F32 = np.float32
SIMS = ("l2_norm", "cosine", "dot_product")


def _lane_order_dot(a: np.ndarray, b: np.ndarray) -> F32:
    """The kernels' order, lane by lane, in f32."""
    lanes = [F32(0.0)] * 32
    for e in range(len(a)):
        lanes[e % 32] = F32(lanes[e % 32] + F32(a[e] * b[e]))
    for o in (16, 8, 4, 2, 1):
        lanes = [F32(lanes[l] + lanes[l ^ o]) for l in range(32)]
    return lanes[0]


@pytest.mark.parametrize("d", (1, 30, 32, 100, 128, 768))
def test_fixed_order_dots_follow_the_lane_order(d):
    rng = np.random.default_rng(d)
    a = rng.standard_normal((6, d)).astype(F32)
    b = rng.standard_normal((6, d)).astype(F32) * 3
    got = knn_rescore.fixed_order_dots(torch.from_numpy(a),
                                       torch.from_numpy(b)).numpy()
    want = np.array([_lane_order_dot(x, y) for x, y in zip(a, b)], F32)
    np.testing.assert_array_equal(got, want)
    sq = knn_rescore.plain_query_sq(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(
        sq, np.array([_lane_order_dot(x, x) for x in a], F32))


def _operands(s: int, n: int, d: int, b: int, r: int, seed: int):
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.standard_normal((s, n, d)).astype(F32) * 2)
    nrm = (v.double() ** 2).sum(2).float()
    ok = torch.from_numpy(rng.random((s, n)) >= 0.05)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(F32) * 2)
    cand = rng.integers(0, n, (s, b, r)).astype(np.int32)
    cand[rng.random((s, b, r)) < 0.1] = -1
    return q, v, nrm, ok, torch.from_numpy(cand)


@pytest.mark.parametrize("d", (30, 128, 768))
@pytest.mark.parametrize("b", (1, 5, 33))
def test_query_sq_of_a_batch_is_each_solo_call(b, d):
    q = torch.from_numpy(np.random.default_rng(b + d).standard_normal(
        (b, d)).astype(F32))
    batch = knn_rescore.query_sq(q)
    for i in range(b):
        assert torch.equal(knn_rescore.query_sq(q[i:i + 1])[0], batch[i])


@pytest.mark.parametrize("similarity", SIMS)
@pytest.mark.parametrize("s,d", ((1, 128), (4, 100), (1, 768)))
def test_rescore_of_a_batch_is_each_solo_call(s, d, similarity):
    q, v, nrm, ok, cand = _operands(s, 700, d, 9, 40, s * 1000 + d)
    batch = knn_rescore.rescore(q, knn_rescore.query_sq(q), v, nrm, ok, cand,
                                similarity=similarity)
    assert batch.shape == (s, 9, 40)
    assert torch.isinf(batch[cand < 0]).all()
    for i in range(9):
        qi = q[i:i + 1]
        solo = knn_rescore.rescore(qi, knn_rescore.query_sq(qi), v, nrm, ok,
                                   cand[:, i:i + 1].contiguous(),
                                   similarity=similarity)
        assert torch.equal(solo[:, 0], batch[:, i])
    # the top k of the rescore, as the serving step takes it
    vals, ids = knn_fused._fused_rescore(q, v, nrm, ok, cand, k=10,
                                         similarity=similarity)
    for i in range(9):
        sv, si = knn_fused._fused_rescore(q[i:i + 1], v, nrm, ok,
                                          cand[:, i:i + 1], k=10,
                                          similarity=similarity)
        assert torch.equal(sv[:, 0], vals[:, i])
        assert torch.equal(si[:, 0], ids[:, i])


def test_rescore_scores_are_the_exact_transform_of_the_dot():
    """Against an f64 witness: each live candidate's score within 1e-6
    relative of its f64 score (the f32 sum of 128 products), -inf for a
    -1 id or a dead doc."""
    q, v, nrm, ok, cand = _operands(2, 500, 128, 4, 64, 5)
    got = knn_rescore.plain_rescore(q, knn_rescore.plain_query_sq(q), v, nrm,
                                    ok, cand, similarity="l2_norm")
    for s, b, j in np.ndindex(*cand.shape):
        c = int(cand[s, b, j])
        if c < 0 or not bool(ok[s, c]):
            assert got[s, b, j] == float("-inf")
            continue
        d2 = float(((q[b].double() - v[s, c].double()) ** 2).sum())
        want = 1.0 / (1.0 + d2)
        assert abs(float(got[s, b, j]) - want) <= 1e-6 * want + 1e-9


def test_cpu_tensors_never_load_the_library():
    q, v, nrm, ok, cand = _operands(1, 200, 16, 3, 8, 9)
    before = (knn_rescore.launches.count, knn_rescore.sq_launches.count)
    libs = dict(cuda_lib._libs)
    knn_rescore.rescore(q, knn_rescore.query_sq(q), v, nrm, ok, cand,
                        similarity="cosine")
    assert (knn_rescore.launches.count,
            knn_rescore.sq_launches.count) == before
    assert cuda_lib._libs == libs


def test_other_devices_raise():
    q = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        knn_rescore.query_sq(q)
    v = torch.zeros((1, 3, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        knn_rescore.rescore(q, torch.zeros(2, device="meta"), v,
                            torch.zeros((1, 3), device="meta"),
                            torch.zeros((1, 3), dtype=torch.bool,
                                        device="meta"),
                            torch.zeros((1, 2, 2), dtype=torch.int32,
                                        device="meta"),
                            similarity="l2_norm")
