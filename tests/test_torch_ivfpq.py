"""The port's IVF-PQ build and search (opensearch_tpu_torch/ops/ivfpq.py)
against the JAX reference (opensearch_tpu/ops/ivfpq.py), on the CPU.

Inputs are the reference's own fixture shape (tests/test_pallas_adc.py):
well-separated clusters, nlist no larger than the number of clusters.
There the port's k-means reproduces the reference's bit for bit: the same
numpy generator draws the sample and the seeds, and the centroid update
sums each cluster's points in index order as XLA's segment_sum does.
Over-clustered corpora can drift by summation order: with ks = 256 PQ
centroids over 1,024 sample points (many of them duplicates), XLA's fused
k-means loop rounds a few means one or two ulp away from an exact division,
and a near-tie argmin can then flip. Those cases are held to a stated
tolerance below, and the encode's near-tie flips are counted.

Search parity runs both packages on ONE build carried across as numpy
(interop.ivfpq_index_from_numpy): ids equal, scores to atol 1e-6 (the
exact rescore's dots are summed in another order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from opensearch_tpu.ops import ivfpq as jax_ivfpq
from opensearch_tpu_torch import interop
from opensearch_tpu_torch.ops import ivfpq

DIM = 16
N_DOCS = 600
PRECISIONS = ("fp32", "bf16", "int8")
SIMS = ("l2_norm", "cosine")


def _clustered(rng, n, d, n_centers=8, spread=5.0):
    centers = rng.standard_normal((n_centers, d)) * spread
    return (
        centers[rng.integers(0, n_centers, n)] + rng.standard_normal((n, d))
    ).astype(np.float32)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


@pytest.fixture(scope="module")
def built():
    """The reference's fixture: a JAX build over clustered data, the same
    build carried into the port, the padded corpus and six queries."""
    rng = np.random.default_rng(11)
    data = _clustered(rng, N_DOCS, DIM)
    index = jax_ivfpq.build(data, nlist=8, m=4, iters=3, seed=2)
    n_pad = 1 << (N_DOCS - 1).bit_length()
    vecs = np.pad(data, ((0, n_pad - N_DOCS), (0, 0)))
    norms = (vecs * vecs).sum(1)
    valid = np.arange(n_pad) < N_DOCS
    queries = _clustered(rng, 6, DIM)
    port = _carry(index)
    return index, port, data, (vecs, norms, valid), queries


def _carry(index, normalized=False):
    return interop.ivfpq_index_from_numpy(
        np.asarray(index.params.coarse), np.asarray(index.params.codebooks),
        np.asarray(index.codes), np.asarray(index.ids),
        np.asarray(index.mask), l_pad=index.l_pad, n=index.n,
        normalized=normalized, device="cpu")


# ---------------------------------------------------------------------------
# build parity
# ---------------------------------------------------------------------------


def test_assign_matches_reference():
    rng = np.random.default_rng(4)
    data = _clustered(rng, 500, DIM)
    cents = data[rng.choice(500, 8, replace=False)]
    ref = np.asarray(jax_ivfpq._assign(jnp.asarray(data), jnp.asarray(cents)))
    got = ivfpq._assign(_t(data), _t(cents)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", range(3))
def test_kmeans_matches_reference_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    data = _clustered(rng, 1000, DIM)
    init = data[rng.choice(1000, 8, replace=False)]
    for iters in (1, 3, 10):
        ref = np.asarray(jax_ivfpq.kmeans(jnp.asarray(data),
                                          jnp.asarray(init), k=8,
                                          iters=iters))
        got = ivfpq.kmeans(_t(data), _t(init), k=8, iters=iters).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ks", (16, 64))
@pytest.mark.parametrize("seed", range(3))
def test_train_matches_reference_bit_for_bit(seed, ks):
    """PQ codebooks below the duplicate-point regime: coarse and codebooks
    equal to the bit."""
    data = _clustered(np.random.default_rng(seed), N_DOCS, DIM)
    ref = jax_ivfpq.train(data, nlist=8, m=4, ks=ks, iters=3, seed=2)
    got = ivfpq.train(data, nlist=8, m=4, ks=ks, iters=3, seed=2,
                      device="cpu")
    np.testing.assert_array_equal(got.coarse.numpy(), np.asarray(ref.coarse))
    np.testing.assert_array_equal(got.codebooks.numpy(),
                                  np.asarray(ref.codebooks))
    assert (got.nlist, got.m, got.ks, got.d) == (ref.nlist, ref.m, ref.ks,
                                                 ref.d)


@pytest.mark.parametrize("seed", range(3))
def test_train_at_ks_256_drifts_only_by_rounding(seed):
    """ks = 256 over 1,024 sample points: coarse still bit-equal; the
    over-clustered codebooks agree to 1e-6 (a few means of duplicate points
    round one or two ulp apart in XLA's fused loop), on under 1% of
    entries."""
    data = _clustered(np.random.default_rng(seed), N_DOCS, DIM)
    ref = jax_ivfpq.train(data, nlist=8, m=4, iters=3, seed=2)
    got = ivfpq.train(data, nlist=8, m=4, iters=3, seed=2, device="cpu")
    np.testing.assert_array_equal(got.coarse.numpy(), np.asarray(ref.coarse))
    cb_ref = np.asarray(ref.codebooks)
    cb = got.codebooks.numpy()
    np.testing.assert_allclose(cb, cb_ref, rtol=0, atol=1e-6)
    assert (cb != cb_ref).mean() < 0.01


def _residual_dist(data, params, lists, codes):
    """float64 squared distance of each residual subvector to its code."""
    coarse = np.asarray(params.coarse, np.float64)
    cb = np.asarray(params.codebooks, np.float64)
    m, _ks, dsub = cb.shape
    res = (data.astype(np.float64) - coarse[lists]).reshape(-1, m, dsub)
    chosen = cb[np.arange(m)[None, :], codes.astype(np.int64)]
    return ((res - chosen) ** 2).sum(-1)


def test_encode_matches_reference_up_to_near_ties(built):
    """On one set of trained parameters, list ids are equal and codes are
    equal except where two PQ centroids are within float rounding of each
    other (the two frameworks sum the [n, dsub] x [dsub, ks] products in
    another order); those flips are counted and each is a near tie."""
    index, port, data, _corpus, _q = built
    ref_lists, ref_codes = jax_ivfpq.encode(data, index.params)
    lists, codes = ivfpq.encode(data, port.params)
    np.testing.assert_array_equal(lists, ref_lists)
    flips = codes != ref_codes
    assert flips.mean() < 0.005, f"{int(flips.sum())} code flips"
    d_ref = _residual_dist(data, index.params, ref_lists, ref_codes)
    d_got = _residual_dist(data, index.params, lists, codes)
    np.testing.assert_allclose(d_got[flips], d_ref[flips], rtol=1e-4,
                               atol=1e-6)


def test_build_layout_matches_reference():
    """Same data through both builds: the same lists, padding, ids and
    mask (coarse is bit-equal), codes equal up to near-tie flips."""
    data = _clustered(np.random.default_rng(7), N_DOCS, DIM)
    ids = np.arange(1000, 1000 + N_DOCS, dtype=np.int32)
    ref = jax_ivfpq.build(data, ids, nlist=8, m=4, iters=3, seed=2)
    got = ivfpq.build(data, ids, nlist=8, m=4, iters=3, seed=2, device="cpu")
    assert (got.l_pad, got.n, got.normalized) == (ref.l_pad, ref.n,
                                                  ref.normalized)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    assert (got.codes.numpy() != np.asarray(ref.codes)).mean() < 0.005
    np.testing.assert_array_equal(got.coarse_host, ref.coarse_host)
    np.testing.assert_array_equal(got.coarse_sq_host, ref.coarse_sq_host)
    assert got.build_generation > 0
    assert got.nbytes == sum(t.numel() * t.element_size() for t in (
        got.codes, got.ids, got.mask, got.params.coarse,
        got.params.codebooks))


def test_build_normalizes_for_cosine():
    data = _clustered(np.random.default_rng(8), N_DOCS, DIM)
    got = ivfpq.build(data, nlist=8, m=4, iters=2, normalized=True,
                      device="cpu")
    np.testing.assert_allclose(
        np.linalg.norm(got.coarse_host, axis=1), 1.0, atol=0.2)
    assert got.normalized


def test_build_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _clustered(np.random.default_rng(9), 64, DIM)
    with pytest.raises(RuntimeError, match="cuda"):
        ivfpq.build(data, nlist=4, m=4)


# ---------------------------------------------------------------------------
# search parity on one carried build
# ---------------------------------------------------------------------------


def test_host_probe_select_matches_reference(built):
    index, port, _data, _corpus, queries = built
    for nprobe in (1, 3, 8, 20):
        np.testing.assert_array_equal(
            ivfpq.host_probe_select(port, queries, nprobe),
            jax_ivfpq.host_probe_select(index, queries, nprobe))


def test_lut_for_probes_matches_reference(built):
    index, port, _data, _corpus, queries = built
    probes = jax_ivfpq.host_probe_select(index, queries, 4)
    ref = np.asarray(jax_ivfpq.lut_for_probes(
        jnp.asarray(queries), index.params.coarse, index.params.codebooks,
        jnp.asarray(probes)))
    got = ivfpq.lut_for_probes(_t(queries), port.params.coarse,
                               port.params.codebooks, _t(probes)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("sim", SIMS)
def test_exact_rescore_matches_reference(built, sim):
    """-1 candidates, dead docs and a planted tie (the same doc twice in
    the pool: the earlier pool position wins)."""
    _index, _port, _data, (vecs, norms, valid), queries = built
    rng = np.random.default_rng(2)
    cand = rng.integers(0, N_DOCS, (len(queries), 24)).astype(np.int32)
    cand[:, -3:] = -1
    cand[:, 5] = cand[:, 2]
    dead = valid.copy()
    dead[cand[0, :4]] = False
    ref_v, ref_i = jax_ivfpq.exact_rescore(
        jnp.asarray(queries), jnp.asarray(cand), jnp.asarray(vecs),
        jnp.asarray(norms), jnp.asarray(dead), similarity=sim, k_eff=10)
    got_v, got_i = ivfpq.exact_rescore(
        _t(queries), _t(cand), _t(vecs), _t(norms), _t(dead),
        similarity=sim, k_eff=10)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("kernel", ("pallas", "xla"))
@pytest.mark.parametrize("sim", SIMS)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_search_index_matches_reference(built, precision, sim, kernel):
    """search_index under both policies: "xla" is the monolithic search,
    "pallas" the cooperative split (on CPU tensors the kernel's plain
    version; the reference runs its Pallas kernel in interpret mode)."""
    index, port, _data, (vecs, norms, valid), queries = built
    ref_v, ref_i = jax_ivfpq.search_index(
        index, jnp.asarray(vecs), jnp.asarray(norms), jnp.asarray(valid),
        jnp.asarray(queries), k=10, nprobe=4, similarity=sim,
        adc_precision=precision, kernel=kernel)
    got_v, got_i = ivfpq.search_index(
        port, _t(vecs), _t(norms), _t(valid), queries, k=10, nprobe=4,
        similarity=sim, adc_precision=precision, kernel=kernel)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_monolithic_search_matches_reference(built, precision):
    """ops/ivfpq.search itself, with its per-(query, probe) int8 affine, a
    rerank wider than the candidates, k past the candidate count (pads)
    and a query batch that is not a multiple of the chunk."""
    index, port, _data, (vecs, norms, valid), queries = built
    q = np.concatenate([queries, queries[:3] + 0.5])
    cap = 2 * index.l_pad
    args = dict(k=cap + 5, nprobe=2, rerank=cap + 100,
                similarity="l2_norm", adc_precision=precision)
    ref_v, ref_i = jax_ivfpq.search(
        index.params.coarse, index.params.codebooks, index.codes, index.ids,
        index.mask, jnp.asarray(vecs), jnp.asarray(norms),
        jnp.asarray(valid), jnp.asarray(q), **args)
    got_v, got_i = ivfpq.search(
        port.params.coarse, port.params.codebooks, port.codes, port.ids,
        port.mask, _t(vecs), _t(norms), _t(valid), _t(q), **args)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), rtol=0,
                               atol=1e-6)
    assert np.all(got_i.numpy()[:, -5:] == -1)


def test_pool_width_helpers_match_reference(built):
    index, port, *_ = built
    for k in (1, 10, 100, 1024):
        for mult in (None, 1, 8):
            rerank = ivfpq.default_rerank(k, mult)
            assert rerank == jax_ivfpq.default_rerank(k, mult)
            for nprobe in (1, 4, 64):
                assert (ivfpq.rescore_pool(port, k, nprobe, rerank)
                        == jax_ivfpq.rescore_pool(index, k, nprobe, rerank))


def test_unknown_precision_raises(built):
    _index, port, _data, (vecs, norms, valid), queries = built
    for kernel in ("pallas", "xla"):
        with pytest.raises(ValueError, match="adc_precision"):
            ivfpq.search_index(port, _t(vecs), _t(norms), _t(valid), queries,
                               k=5, nprobe=4, adc_precision="int4",
                               kernel=kernel)
