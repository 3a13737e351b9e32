"""The IVF-PQ route summed in one order whatever the batch
(opensearch_tpu_torch/ops/adc_lut.py, csrc/adc_lut.cu; the dots of
ops/ivfpq.exact_rescore through ops/knn_rescore; host_probe_select one
product a row), on the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it bit for
bit against its plain version). Here:

1. The plain fixed-order LUT against the reference's
   ``opensearch_tpu/ops/ivfpq.py::lut_for_probes``: rtol 1e-5 / atol 1e-4,
   the tolerance tests/test_torch_ivfpq.py states (the reference sums in
   XLA's order); against a float64 LUT within the f32 error of its sums.
2. Its order written out: each entry equals a scalar loop that adds the
   dsub products one after another from zero, in f32, bit for bit.
3. Batches: the LUTs, the probe tables, the rescored scores and the whole
   fused pipeline of a batch of B equal those of B solo calls bit for bit.
4. Dispatch: CPU tensors take the plain versions and launch nothing.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from opensearch_tpu.ops import ivfpq as jax_ivfpq
from opensearch_tpu_torch import interop
from opensearch_tpu_torch.ops import adc_lut, adc_scan, cuda_lib, ivfpq
from opensearch_tpu_torch.ops import knn_rescore

DIM = 24
N_DOCS = 800
SIMS = ("l2_norm", "cosine")
PRECISIONS = ("fp32", "bf16", "int8")
F32 = np.float32


def _clustered(rng, n, d, n_centers=8, spread=5.0):
    centers = rng.standard_normal((n_centers, d)) * spread
    return (centers[rng.integers(0, n_centers, n)]
            + rng.standard_normal((n, d))).astype(F32)


@pytest.fixture(scope="module")
def built():
    """A JAX build (nlist 8, m 6: dsub 4) carried into the port, the padded
    corpus and nine queries."""
    rng = np.random.default_rng(21)
    data = _clustered(rng, N_DOCS, DIM)
    index = jax_ivfpq.build(data, nlist=8, m=6, iters=3, seed=4)
    port = interop.ivfpq_index_from_numpy(
        np.asarray(index.params.coarse), np.asarray(index.params.codebooks),
        np.asarray(index.codes), np.asarray(index.ids),
        np.asarray(index.mask), l_pad=index.l_pad, n=index.n,
        normalized=False, device="cpu")
    n_pad = 1 << (N_DOCS - 1).bit_length()
    vecs = np.pad(data, ((0, n_pad - N_DOCS), (0, 0)))
    norms = (vecs * vecs).sum(1)
    valid = np.arange(n_pad) < N_DOCS
    queries = _clustered(rng, 9, DIM)
    return index, port, (vecs, norms, valid), queries


def _lut(port, queries, probes):
    return adc_lut.lut(torch.from_numpy(queries), port.params.coarse,
                       port.params.codebooks,
                       torch.from_numpy(np.ascontiguousarray(probes)))


def test_plain_lut_matches_reference(built):
    index, port, _corpus, queries = built
    probes = jax_ivfpq.host_probe_select(index, queries, 4)
    ref = np.asarray(jax_ivfpq.lut_for_probes(
        jnp.asarray(queries), index.params.coarse, index.params.codebooks,
        jnp.asarray(probes)))
    got = _lut(port, queries, probes).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_plain_lut_within_f32_error_of_float64(built):
    """Against the LUT in float64: each entry within the error bound of its
    f32 sums (gamma_dsub over the absolute terms, doubled for the three
    sums and the final additions), so no term is dropped or reordered
    wrongly."""
    _index, port, _corpus, queries = built
    probes = ivfpq.host_probe_select(port, queries, 3)
    got = _lut(port, queries, probes).numpy().astype(np.float64)
    coarse = port.params.coarse.numpy().astype(np.float64)
    cb = port.params.codebooks.numpy().astype(np.float64)
    m, ks, dsub = cb.shape
    r = (queries.astype(np.float64)[:, None, :] - coarse[probes]).reshape(
        len(queries), probes.shape[1], m, dsub)
    exact = ((r * r).sum(-1)[..., None] - 2 * np.einsum("bpms,mks->bpmk",
                                                        r, cb)
             + (cb * cb).sum(-1)[None, None])
    mag = ((r * r).sum(-1)[..., None] + 2 * np.einsum(
        "bpms,mks->bpmk", np.abs(r), np.abs(cb)) + (cb * cb).sum(-1))
    u = 2.0 ** -24
    bound = 4 * (dsub + 2) * u * mag + 1e-30
    assert (np.abs(got - exact) <= bound).all()


def test_plain_lut_sums_in_ascending_order(built):
    """A scalar loop in f32 over the dsub products from zero gives every
    entry's bits."""
    _index, port, _corpus, queries = built
    probes = ivfpq.host_probe_select(port, queries[:2], 2)
    got = _lut(port, queries[:2], probes).numpy()
    coarse = port.params.coarse.numpy()
    cb = port.params.codebooks.numpy()
    m, ks, dsub = cb.shape
    for b in range(2):
        for p in range(2):
            res = (queries[b] - coarse[probes[b, p]]).astype(F32)
            for j in range(m):
                rs = res[j * dsub:(j + 1) * dsub]
                rsq = F32(0)
                for s in range(dsub):
                    rsq = F32(rsq + F32(rs[s] * rs[s]))
                for c in (0, 1, ks // 2, ks - 1):
                    dot = csq = F32(0)
                    for s in range(dsub):
                        dot = F32(dot + F32(rs[s] * cb[j, c, s]))
                        csq = F32(csq + F32(cb[j, c, s] * cb[j, c, s]))
                    want = F32(F32(rsq - F32(F32(2) * dot)) + csq)
                    assert got[b, p, j, c].tobytes() == want.tobytes()


def test_probe_rows_are_their_solo_rows(built):
    """host_probe_select takes one product a row, so a batch's table is its
    rows' solo tables, and it still equals the reference's."""
    index, port, _corpus, queries = built
    for nprobe in (1, 3, 8):
        batch = ivfpq.host_probe_select(port, queries, nprobe)
        solo = np.concatenate([ivfpq.host_probe_select(port, q[None], nprobe)
                               for q in queries])
        np.testing.assert_array_equal(batch, solo)
        np.testing.assert_array_equal(
            batch, jax_ivfpq.host_probe_select(index, queries, nprobe))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_batched_luts_are_solo_luts(built, precision):
    _index, port, _corpus, queries = built
    probes = ivfpq.host_probe_select(port, queries, 4)
    q, pr = torch.from_numpy(queries), torch.from_numpy(probes)
    args = (port.params.coarse, port.params.codebooks)
    batch = adc_scan.build_luts(q, *args, pr, adc_precision=precision)
    for i in range(len(queries)):
        solo = adc_scan.build_luts(q[i:i + 1], *args, pr[i:i + 1],
                                   adc_precision=precision)
        assert torch.equal(batch[i:i + 1], solo)


@pytest.mark.parametrize("sim", SIMS)
def test_batched_rescore_is_solo_rescore(built, sim):
    """exact_rescore's dots and |q|^2 in one order: each batch row's scores
    and ids are its solo call's bits, under both impls (the same plain
    versions on the CPU)."""
    _index, _port, (vecs, norms, valid), queries = built
    rng = np.random.default_rng(5)
    cand = rng.integers(0, N_DOCS, (len(queries), 40)).astype(np.int32)
    cand[:, -2:] = -1
    args = (torch.from_numpy(vecs), torch.from_numpy(norms),
            torch.from_numpy(valid))
    q, c = torch.from_numpy(queries), torch.from_numpy(cand)
    for impl in ("pallas", "xla"):
        bv, bi = ivfpq.exact_rescore(q, c, *args, similarity=sim, k_eff=12,
                                     impl=impl)
        for i in range(len(queries)):
            sv, si = ivfpq.exact_rescore(q[i:i + 1], c[i:i + 1], *args,
                                         similarity=sim, k_eff=12, impl=impl)
            assert torch.equal(bv[i:i + 1], sv) and torch.equal(bi[i:i + 1],
                                                                 si)


def test_rescore_dots_take_the_fixed_order():
    rng = np.random.default_rng(6)
    v = torch.from_numpy(rng.standard_normal((2, 50, 70)).astype(F32))
    q = torch.from_numpy(rng.standard_normal((3, 70)).astype(F32))
    cand = torch.from_numpy(rng.integers(-1, 50, (2, 3, 9)).astype(np.int32))
    got = knn_rescore.rescore_dots(q, v, cand)
    safe = cand.long().clamp(min=0)
    rows = v[torch.arange(2)[:, None, None], safe]
    want = knn_rescore.fixed_order_dots(q[None, :, None, :], rows)
    want = torch.where(cand >= 0, want, 0.0)
    assert torch.equal(got, want)
    exact = np.einsum("sbrd,bd->sbr", rows.double().numpy(),
                      q.double().numpy())
    live = (cand >= 0).numpy()
    np.testing.assert_allclose(got.numpy()[live], exact[live], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("sim", SIMS)
def test_batched_fused_search_is_solo_search(built, sim, precision):
    """The fused pipeline (LUT, scan, rescore) of a batch: each row's
    scores and ids its solo search's bits."""
    _index, port, (vecs, norms, valid), queries = built
    probes = ivfpq.host_probe_select(port, queries, 4)
    corpus = (torch.from_numpy(vecs), torch.from_numpy(norms),
              torch.from_numpy(valid))

    def run(qs, pr):
        return adc_scan.adc_topr_auto(
            port.params.coarse, port.params.codebooks, port.codes, port.ids,
            port.mask, *corpus, torch.from_numpy(qs), pr, k=7, rerank=30,
            similarity=sim, adc_precision=precision)

    bv, bi = run(queries, probes)
    for i in range(len(queries)):
        sv, si = run(queries[i:i + 1], probes[i:i + 1])
        assert torch.equal(bv[i:i + 1], sv) and torch.equal(bi[i:i + 1], si)


def test_cpu_tensors_take_the_plain_versions(built):
    """No launch counted and no library loaded for CPU tensors."""
    _index, port, (vecs, norms, valid), queries = built
    counters = (adc_lut.launches, knn_rescore.launches,
                knn_rescore.sq_launches)
    before = [c.count for c in counters]
    libs = dict(cuda_lib._libs)
    probes = ivfpq.host_probe_select(port, queries, 2)
    got = _lut(port, queries, probes)
    want = ivfpq.lut_for_probes(torch.from_numpy(queries), port.params.coarse,
                                port.params.codebooks,
                                torch.from_numpy(probes))
    assert torch.equal(got, want)
    ivfpq.exact_rescore(torch.from_numpy(queries),
                        torch.zeros((len(queries), 5), dtype=torch.int32),
                        torch.from_numpy(vecs), torch.from_numpy(norms),
                        torch.from_numpy(valid), similarity="l2_norm",
                        k_eff=3, impl="pallas")
    assert [c.count for c in counters] == before
    assert cuda_lib._libs == libs


def test_lut_wrapper_raises_on_other_devices(built):
    _index, port, _corpus, queries = built
    with pytest.raises(ValueError, match="unsupported device"):
        adc_lut.lut(torch.from_numpy(queries).to("meta"), port.params.coarse,
                    port.params.codebooks,
                    torch.zeros((len(queries), 2), dtype=torch.int32))
