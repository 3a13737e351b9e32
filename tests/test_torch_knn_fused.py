"""The port's fused exact-kNN (opensearch_tpu_torch/ops/knn_fused.py)
against the JAX reference (opensearch_tpu/ops/pallas_knn.py), on the CPU.

The same numpy inputs go through the reference's Pallas kernel (interpret
mode) and XLA pool, and through the port's wrapper on CPU tensors, which
takes the CUDA kernel's plain version. Tolerances: int8 pools and results
are bit-equal (integer dots, one scalar multiply); fp32 and bf16 ids are
equal and scores agree to rtol 1e-5 (fp32) / 1e-3 (bf16), because the two
frameworks sum the d products in another order. Pools are compared on the
same bits, |q|^2 included (XLA and torch sum it in another order); the
end-to-end int8 results end in the exact fp32 rescore, so there they are
held to the fp32 tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from opensearch_tpu.ops import pallas_knn
from opensearch_tpu_torch.ops import knn_fused

DIM = 16
N_DOCS = 700
SIMS = ("l2_norm", "cosine", "dot_product")
PRECISIONS = ("fp32", "bf16", "int8")
RTOL = {"fp32": 1e-5, "bf16": 1e-3, "int8": 1e-5}


def _corpus(rng, n, d, n_centers=8, spread=5.0):
    centers = rng.standard_normal((n_centers, d)) * spread
    return (
        centers[rng.integers(0, n_centers, n)] + rng.standard_normal((n, d))
    ).astype(np.float32)


def _operands(seed, n=N_DOCS, d=DIM, b=6, n_dead=25):
    rng = np.random.default_rng(seed)
    vecs = _corpus(rng, n, d)
    norms = (vecs.astype(np.float64) ** 2).sum(1).astype(np.float32)
    valid = np.ones(n, bool)
    valid[rng.choice(n, n_dead, replace=False)] = False
    queries = _corpus(rng, b, d)
    return vecs, norms, valid, queries


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_match(tv, ti, jv, ji, precision, pool=False):
    tv, ti = tv.numpy(), ti.numpy()
    jv, ji = np.asarray(jv), np.asarray(ji)
    np.testing.assert_array_equal(ti, ji)
    if pool and precision == "int8":
        np.testing.assert_array_equal(tv, jv)
    else:
        np.testing.assert_allclose(tv, jv, rtol=RTOL[precision], atol=0)


def _jax_pool(vecs, norms, valid, queries, r, similarity, precision):
    """The reference's XLA pool and its Pallas kernel (interpret mode) on
    the reference's own prepped operands, and the |q|^2 they used."""
    v, q = jnp.asarray(vecs), jnp.asarray(queries)
    qsq = jnp.sum(q * q, axis=1, keepdims=True)
    v_x, q_x, scale = pallas_knn._prep_operands(v, q, precision)
    xla = pallas_knn._fused_xla_pool(
        v_x, jnp.asarray(norms), jnp.asarray(valid), q_x, qsq, scale,
        r=r, similarity=similarity, score_precision=precision)
    n_pad = -(-len(vecs) // pallas_knn.FK_BLOCK) * pallas_knn.FK_BLOCK
    pad = n_pad - len(vecs)
    b_pad = -(-len(queries) // 8) * 8
    kern = pallas_knn.pallas_knn_fused(
        jnp.pad(v_x, ((0, pad), (0, 0))), jnp.pad(jnp.asarray(norms), (0, pad)),
        jnp.pad(jnp.asarray(valid), (0, pad)),
        jnp.pad(q_x, ((0, b_pad - len(queries)), (0, 0))),
        jnp.pad(qsq, ((0, b_pad - len(queries)), (0, 0))), scale,
        r=r, similarity=similarity, score_precision=precision, interpret=True)
    return xla, (kern[0][: len(queries)], kern[1][: len(queries)]), qsq


@pytest.mark.parametrize("similarity", SIMS)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_pool_matches_reference_pool_and_kernel(precision, similarity):
    """The port's pool scan (plain version, CPU tensors) equals the
    reference's XLA pool and its interpret-mode Pallas kernel."""
    vecs, norms, valid, queries = _operands(3)
    r = knn_fused.fused_pool_width(10, precision)
    (xv, xi), (kv, ki), qsq = _jax_pool(vecs, norms, valid, queries, r,
                                        similarity, precision)
    v, nrm, ok, q = _torch(vecs, norms, valid, queries)
    v_x, q_x, scale = knn_fused._prep_operands(v[None], q, precision)
    before = knn_fused.launches.count
    tv, ti = knn_fused.pool_scan(
        v_x, nrm[None], ok[None], q_x, torch.from_numpy(np.array(qsq)[:, 0]),
        scale, r=r, similarity=similarity, score_precision=precision)
    assert knn_fused.launches.count == before  # CPU tensors: no launch
    _assert_match(tv[0], ti[0], xv, xi, precision, pool=True)
    _assert_match(tv[0], ti[0], kv, ki, precision, pool=True)


@pytest.mark.parametrize("similarity", SIMS)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_knn_fused_end_to_end_parity(precision, similarity):
    """knn_fused(device="cpu" tensors) vs the reference's knn_fused with the
    interpret-mode kernel: same [B, k] contract at every precision."""
    vecs, norms, valid, queries = _operands(5)
    jv, ji = pallas_knn.knn_fused(
        jnp.asarray(vecs), jnp.asarray(norms), jnp.asarray(valid),
        jnp.asarray(queries), k=10, similarity=similarity,
        score_precision=precision, impl="pallas", interpret=True)
    for impl in ("pallas", "xla"):
        tv, ti = knn_fused.knn_fused(
            *_torch(vecs, norms, valid, queries), k=10,
            similarity=similarity, score_precision=precision, impl=impl)
        _assert_match(tv, ti, jv, ji, precision)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_fewer_live_docs_than_k_pads(precision):
    rng = np.random.default_rng(5)
    n, k = 300, 16
    vecs = _corpus(rng, n, DIM)
    norms = (vecs.astype(np.float64) ** 2).sum(1).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[:5] = True
    queries = _corpus(rng, 3, DIM)
    tv, ti = knn_fused.knn_fused(*_torch(vecs, norms, valid, queries), k=k,
                                 score_precision=precision)
    jv, ji = pallas_knn.knn_fused(
        jnp.asarray(vecs), jnp.asarray(norms), jnp.asarray(valid),
        jnp.asarray(queries), k=k, score_precision=precision,
        impl="pallas", interpret=True)
    assert tuple(tv.shape) == (3, k) and tuple(ti.shape) == (3, k)
    assert torch.all(ti[:, 5:] == -1)
    assert torch.all(torch.isneginf(tv[:, 5:]))
    for b in range(3):
        assert set(ti[b, :5].tolist()) == {0, 1, 2, 3, 4}
    _assert_match(tv, ti, jv, ji, precision)


def test_tie_break_prefers_lower_doc_id():
    """Duplicate vectors across the reference's block boundary: ties go to
    the lower doc id, as in the reference at every precision."""
    rng = np.random.default_rng(7)
    n = pallas_knn.FK_BLOCK + 64
    vecs = rng.standard_normal((n, 8)).astype(np.float32)
    dup = vecs[3].copy()
    vecs[pallas_knn.FK_BLOCK + 11] = dup
    norms = (vecs.astype(np.float64) ** 2).sum(1).astype(np.float32)
    valid = np.ones(n, bool)
    queries = dup[None, :] + 0.0
    for precision in PRECISIONS:
        _tv, ti = knn_fused.knn_fused(*_torch(vecs, norms, valid, queries),
                                      k=4, score_precision=precision)
        _jv, ji = pallas_knn.knn_fused(
            jnp.asarray(vecs), jnp.asarray(norms), jnp.asarray(valid),
            jnp.asarray(queries), k=4, score_precision=precision,
            impl="pallas", interpret=True)
        ids = ti[0].tolist()
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert ids.index(3) < ids.index(pallas_knn.FK_BLOCK + 11), precision


def test_quantize_symmetric_int8_bit_equal():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((32, DIM)).astype(np.float32) * 3
    x[0, 0] = 2.5 * float(np.abs(x).max()) / 2.5   # exact max element
    tq, ts = knn_fused.quantize_symmetric_int8(torch.from_numpy(x))
    jq, js = pallas_knn.quantize_symmetric_int8(jnp.asarray(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)
    assert int(tq.abs().max()) <= 127
    np.testing.assert_allclose(tq.numpy() * ts.item(), x, atol=ts.item())


def test_kernel_wrapper_rejects_what_it_does_not_take():
    """The kernel's own operand checks raise before any build or launch."""
    v = torch.zeros((1, 8, 4))
    args = (v, torch.zeros((1, 8)), torch.ones((1, 8), dtype=torch.bool),
            torch.zeros((2, 4)), torch.zeros(2), torch.ones(1))
    knn_fused._check_kernel_operands(*args, 4, "l2_norm", "fp32")
    with pytest.raises(ValueError, match="expected"):
        knn_fused._check_kernel_operands(*args, 4, "l2_norm", "int8")
    bad = list(args)
    bad[2] = torch.ones((1, 8), dtype=torch.float32)
    with pytest.raises(ValueError, match="valid"):
        knn_fused._check_kernel_operands(*bad, 4, "l2_norm", "fp32")
    with pytest.raises(ValueError, match="contiguous"):
        knn_fused._check_kernel_operands(
            torch.zeros((1, 4, 8)).transpose(1, 2), *args[1:], 4, "l2_norm",
            "fp32")


def test_stable_topk_ties_and_short_rows():
    from opensearch_tpu_torch.ops.topk import stable_topk

    scores = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, pos = stable_topk(scores, 4)
    assert pos.tolist() == [[1, 2, 4, 3]]
    vals, pos = stable_topk(scores, 7)
    assert torch.isneginf(vals[0, 5:]).all() and pos[0, :5].tolist() == [1, 2, 4, 3, 0]


@pytest.mark.parametrize("similarity", SIMS)
def test_exact_knn_scores_match_reference(similarity):
    """ops/knn.exact_knn_scores: the plain scoring of the exact path, with
    dead docs at -inf, against the reference on the same inputs."""
    from opensearch_tpu.ops import knn as jax_knn
    from opensearch_tpu_torch.ops import knn as torch_knn

    vecs, norms, valid, queries = _operands(13)
    ts = torch_knn.exact_knn_scores(*_torch(queries, vecs, norms, valid),
                                    similarity)
    js = np.asarray(jax_knn.exact_knn_scores(
        jnp.asarray(queries), jnp.asarray(vecs), jnp.asarray(norms),
        jnp.asarray(valid), similarity))
    assert np.array_equal(np.isneginf(ts.numpy()), np.isneginf(js))
    live = np.isfinite(js)
    # l2 cancels near a neighbour: a few ulps of |q|^2 reach d^2 whole
    np.testing.assert_allclose(ts.numpy()[live], js[live], rtol=1e-5,
                               atol=1e-4)
    assert torch_knn.canonical_similarity("cosinesimil") == "cosine"


@pytest.mark.parametrize("impl", (None, "auto", "xla"))
def test_knn_fused_auto_policy_on_cpu_tensors(impl):
    """The front door takes the kernel's wrapper for None/"auto" (its plain
    version here, on CPU tensors, with no launch) and the plain version
    for "xla": the same answer as the reference either way."""
    vecs, norms, valid, queries = _operands(17)
    before = knn_fused.launches.count
    tv, ti = knn_fused.knn_fused_auto(*_torch(vecs, norms, valid, queries),
                                      k=7, impl=impl)
    assert knn_fused.launches.count == before
    jv, ji = pallas_knn.knn_fused(
        jnp.asarray(vecs), jnp.asarray(norms), jnp.asarray(valid),
        jnp.asarray(queries), k=7, impl="xla")
    _assert_match(tv, ti, jv, ji, "fp32")
