"""The port's exact-scan family (opensearch_tpu_torch/ops/knn_blocks.py: K3
``knn_topk_auto``, K4 ``knn_blocktopk_auto``, K5 ``knn_sbmax_auto``)
against the JAX reference (opensearch_tpu/ops/pallas_knn.py), on the CPU.

The same numpy inputs go through the reference's entry points, whose Pallas
kernels run in interpret mode here, and through the port's, which take the
plain versions for CPU tensors. Ids must be equal. Scores agree to rtol
1e-5, with atol 2e-5 for l2 (|q|^2 - 2 q.v + |v|^2 cancels near a
neighbour, where |q|^2 ~ 32 and the two frameworks sum the d products in
another order) and 1e-6 for cosine and dot. ``exact=False`` means bf16
operands on the TPU but fp32 in the reference's CPU run, so there the port
is held to a float64 brute force on bf16-rounded operands, and to a recall
floor against the reference. Sizes stay small (n <= 2 * 2048 + 100,
d <= 32, k <= 10) so the interpret-mode kernels run in about a second.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from opensearch_tpu.ops import pallas_knn
from opensearch_tpu_torch.ops import knn_blocks

SIMS = ("l2_norm", "cosine", "dot_product")
ENTRIES = ("knn_topk_auto", "knn_blocktopk_auto", "knn_sbmax_auto")
N_DOCS = 2 * 2048 + 100      # past both block sizes, ragged
DIM = 32
DUP_SRC, DUP_DST = 2040, 2053  # across the 1024- and the 2048-doc boundary


def _atol(similarity: str) -> float:
    return 2e-5 if similarity == "l2_norm" else 1e-6


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """Numpy operands (vectors, norms, valid, queries) of a named case."""
    rng = np.random.default_rng(
        {"ragged": 1, "few_valid": 2, "block_multiple": 3,
         "many_queries": 4}[name])
    if name == "ragged":
        v = rng.standard_normal((N_DOCS, DIM)).astype(np.float32)
        v[DUP_DST] = v[DUP_SRC]
        valid = np.ones(N_DOCS, bool)
        valid[rng.choice(N_DOCS, 120, replace=False)] = False
        valid[[DUP_SRC, DUP_DST]] = True
        q = rng.standard_normal((5, DIM)).astype(np.float32)
        q[0] = v[DUP_SRC]
    elif name == "few_valid":
        v = rng.standard_normal((300, 16)).astype(np.float32)
        valid = np.zeros(300, bool)
        valid[[4, 150, 299]] = True
        q = rng.standard_normal((2, 16)).astype(np.float32)
    elif name == "many_queries":
        # 40 queries: three of the kernels' 16-query tiles, the last partial
        v = rng.standard_normal((N_DOCS, 16)).astype(np.float32)
        valid = rng.random(N_DOCS) >= 0.03
        q = rng.standard_normal((40, 16)).astype(np.float32)
        q[::7] = v[rng.choice(np.nonzero(valid)[0], 6, replace=False)]
    else:  # "block_multiple": self queries over exactly two 2048-doc blocks
        v = rng.standard_normal((2 * 2048, 16)).astype(np.float32)
        valid = np.ones(2 * 2048, bool)
        q = v[[0, 2047, 2048]].copy()
    norms = (v.astype(np.float64) ** 2).sum(1).astype(np.float32)
    return v, norms, valid, q


@functools.lru_cache(maxsize=None)
def _reference(entry: str, case: str, k: int, similarity: str,
               exact: bool = True):
    kw = {} if entry == "knn_topk_auto" else {"exact": exact}
    vals, ids = getattr(pallas_knn, entry)(
        *(jnp.asarray(a) for a in _case(case)), k=k, similarity=similarity,
        **kw)
    return np.asarray(vals), np.asarray(ids)


def _port(entry: str, case: str, k: int, similarity: str, exact: bool = True):
    kw = {} if entry == "knn_topk_auto" else {"exact": exact}
    vals, ids = getattr(knn_blocks, entry)(
        *(torch.from_numpy(a) for a in _case(case)), k=k,
        similarity=similarity, **kw)
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    return vals.numpy(), ids.numpy()


def _assert_match(entry, case, k, similarity):
    jv, ji = _reference(entry, case, k, similarity)
    tv, ti = _port(entry, case, k, similarity)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(np.isneginf(tv), np.isneginf(jv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=1e-5,
                               atol=_atol(similarity))
    return tv, ti


@pytest.mark.parametrize("similarity", SIMS)
@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_match_reference(entry, similarity):
    """Ragged n past both block sizes, 120 dead docs and a duplicate across
    the block boundaries: the same ids as the reference, best first."""
    _tv, ti = _assert_match(entry, "ragged", 10, similarity)
    # the duplicate query scores both copies alike: the lower id first
    if similarity != "dot_product":
        assert ti[0, :2].tolist() == [DUP_SRC, DUP_DST]


@pytest.mark.parametrize("entry", ENTRIES)
def test_fewer_valid_than_k_pads_with_minus_one(entry):
    tv, ti = _assert_match(entry, "few_valid", 8, "l2_norm")
    assert sorted(ti[0, :3].tolist()) == [4, 150, 299]
    assert np.all(ti[:, 3:] == -1) and np.all(np.isneginf(tv[:, 3:]))


@pytest.mark.parametrize("entry", ENTRIES)
def test_exact_block_multiple_self_queries(entry):
    tv, ti = _assert_match(entry, "block_multiple", 5, "l2_norm")
    assert ti[:, 0].tolist() == [0, 2047, 2048]
    np.testing.assert_allclose(tv[:, 0], 1.0, atol=1e-4)


@pytest.mark.parametrize("entry", ENTRIES)
def test_many_queries_match_reference(entry):
    """B = 40, past one 16-query tile of the port's kernels and padded to
    40 by both packages: every row answers as the reference's."""
    tv, ti = _assert_match(entry, "many_queries", 10, "l2_norm")
    assert ti.shape == (40, 10)
    v, _norms, _valid, q = _case("many_queries")
    for b in range(0, 40, 7):
        assert ti[b, 0] == np.flatnonzero((v == q[b]).all(1))[0]


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).double().numpy()


@pytest.mark.parametrize("similarity", SIMS)
@pytest.mark.parametrize("entry", ("knn_blocktopk_auto", "knn_sbmax_auto"))
def test_inexact_scan_rounds_operands_to_bf16(entry, similarity):
    """exact=False: the port's answer is the float64 brute force over
    bf16-rounded operands (|q|^2 and |v|^2 from the f32 inputs, as the
    reference's kernels take them), and keeps recall@10 >= 0.9 against the
    reference, which runs DEFAULT in fp32 on the CPU."""
    v, norms, valid, q = _case("ragged")
    tv, ti = _port(entry, "ragged", 10, similarity, exact=False)
    dots = _bf16(q) @ _bf16(v).T
    qsq = (q * q).sum(1).astype(np.float64)[:, None]
    nsq = norms.astype(np.float64)[None, :]
    if similarity == "l2_norm":
        scores = 1.0 / (1.0 + np.maximum(qsq - 2.0 * dots + nsq, 0.0))
    elif similarity == "cosine":
        scores = (1.0 + dots / (np.sqrt(qsq) * np.sqrt(nsq))) / 2.0
    else:
        scores = np.where(dots >= 0, dots + 1.0, 1.0 / (1.0 - dots))
    scores = np.where(valid[None, :], scores, -np.inf)
    want = np.argsort(-scores, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(ti, want)
    np.testing.assert_allclose(tv, np.take_along_axis(scores, want, 1),
                               rtol=1e-5, atol=_atol(similarity))
    _jv, ji = _reference(entry, "ragged", 10, similarity, exact=False)
    recall = np.mean([len(set(ti[b]) & set(ji[b])) / 10
                      for b in range(len(q))])
    assert recall >= 0.9


def test_cpu_tensors_never_launch():
    counters = (knn_blocks.block_launches, knn_blocks.pb_launches,
                knn_blocks.sbmax_launches)
    before = [c.count for c in counters]
    for entry in ENTRIES:
        _port(entry, "few_valid", 2, "cosine")
    assert [c.count for c in counters] == before


@pytest.mark.parametrize("entry,k", [
    ("knn_topk_auto", knn_blocks.BLOCK_MAX_K + 1),
    ("knn_blocktopk_auto", knn_blocks.PB_MAX_K + 1),
    # 300 docs pad to one 2048-doc block: 16 sub-blocks
    ("knn_sbmax_auto", 17),
    ("knn_topk_auto", 0),
])
def test_k_past_the_stated_limit_raises(entry, k):
    with pytest.raises(ValueError, match="k <="):
        _port(entry, "few_valid", k, "l2_norm")


def test_operand_checks_raise():
    v, norms, valid, q = (torch.from_numpy(a) for a in _case("few_valid"))
    with pytest.raises(ValueError, match="valid"):
        knn_blocks.knn_topk_auto(v, norms, valid.float(), q, k=2)
    with pytest.raises(ValueError, match="queries"):
        knn_blocks.knn_blocktopk_auto(v, norms, valid, q[:, :4], k=2)
    with pytest.raises(ValueError, match="similarity"):
        knn_blocks.knn_sbmax_auto(v, norms, valid, q, k=2, similarity="l1")


@pytest.mark.parametrize("b,qtile,want", [
    (1, None, 8), (9, None, 16), (5, 128, 8), (128, 128, 128),
    (129, 128, 256), (200, None, 200)])
def test_query_padding_follows_the_reference(b, qtile, want):
    """B pads to a multiple of 8 (at least 8), or of PB_QTILE above it, with
    zero rows, as the reference's wrappers pad it."""
    q = torch.ones((b, 4))
    out = knn_blocks._pad_queries(q, qtile)
    assert tuple(out.shape) == (want, 4)
    assert torch.equal(out[:b], q) and not out[b:].any()
