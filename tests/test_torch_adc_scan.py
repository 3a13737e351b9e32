"""The port's ADC scan (opensearch_tpu_torch/ops/adc_scan.py) against the
JAX reference (opensearch_tpu/ops/pallas_adc.py), on the CPU.

The LUT is built once with the reference's ``build_luts`` and handed to
both packages as numpy, so the scans see the same bits. On CPU tensors the
port's wrapper runs the kernel's plain version (``plain_adc_pool``); the
reference runs ``adc_scan_xla`` and its Pallas kernel in interpret mode.
Tolerances: int8 pools are bit-equal (integer sums); fp32 and bf16 ids are
equal and scores agree to atol 1e-5 (with numpy's default rtol 1e-5, as the
reference's own kernel test): the Pallas kernel sums the subspaces as a
one-hot matmul, in another order than the port's subspace-by-subspace
sum (which ``adc_scan_xla`` matches to the bit here).

The CUDA kernel itself (csrc/adc_scan.cu) runs only on the card: chip_smoke.py
holds it against ``plain_adc_pool`` there.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from opensearch_tpu.ops import ivfpq as jax_ivfpq
from opensearch_tpu.ops import pallas_adc
from opensearch_tpu_torch import interop
from opensearch_tpu_torch.ops import adc_scan

DIM = 16
N_DOCS = 600
PRECISIONS = ("fp32", "bf16", "int8")
_TORCH_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16,
                "int8": torch.uint8}


def _clustered(rng, n, d, n_centers=8, spread=5.0):
    centers = rng.standard_normal((n_centers, d)) * spread
    return (
        centers[rng.integers(0, n_centers, n)] + rng.standard_normal((n, d))
    ).astype(np.float32)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(11)
    data = _clustered(rng, N_DOCS, DIM)
    index = jax_ivfpq.build(data, nlist=8, m=4, iters=3, seed=2)
    n_pad = 1 << (N_DOCS - 1).bit_length()
    vecs = np.pad(data, ((0, n_pad - N_DOCS), (0, 0)))
    corpus = (vecs, (vecs * vecs).sum(1), np.arange(n_pad) < N_DOCS)
    queries = _clustered(rng, 6, DIM)
    return index, corpus, queries


def _lut_to_torch(lut, precision):
    """A JAX LUT as the port's tensor of the same width (bf16 goes through
    f32, which holds every bf16 value exactly)."""
    if precision == "bf16":
        return _t(np.asarray(lut.astype(jnp.float32))).to(torch.bfloat16)
    return _t(np.asarray(lut), None).to(_TORCH_DTYPE[precision])


def _slab(index):
    return (_t(np.asarray(index.codes)), _t(np.asarray(index.ids)),
            _t(np.asarray(index.mask)))


def _scan_inputs(index, queries, nprobe, precision):
    probes = jax_ivfpq.host_probe_select(index, queries, nprobe)
    lut = pallas_adc.build_luts(
        jnp.asarray(queries), index.params.coarse, index.params.codebooks,
        jnp.asarray(probes), adc_precision=precision)
    return lut, probes


def _reference_pools(lut, codes, ids, maskf, probes, r, l_blk):
    xv, xi = pallas_adc.adc_scan_xla(lut, codes, ids, maskf,
                                     jnp.asarray(probes), r=r)
    pv, pi = pallas_adc.pallas_adc_topr(lut, codes, ids, maskf,
                                        jnp.asarray(probes), r=r,
                                        l_blk=l_blk, interpret=True)
    return tuple(map(np.asarray, (xv, xi, pv, pi)))


def _assert_pool(got_v, got_i, ref_v, ref_i, precision):
    np.testing.assert_array_equal(got_i, ref_i)
    if precision == "int8":
        np.testing.assert_array_equal(got_v, ref_v)
    else:
        assert np.allclose(got_v, ref_v, atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("l_blk", (8, 256))
@pytest.mark.parametrize("precision", PRECISIONS)
def test_pool_parity_on_one_lut(built, precision, l_blk):
    """plain_adc_pool vs adc_scan_xla and the interpret-mode kernel, on the
    reference's LUT; l_blk 8 splits every probed list over several of the
    Pallas kernel's blocks."""
    index, _corpus, queries = built
    lut, probes = _scan_inputs(index, queries, 4, precision)
    xv, xi, pv, pi = _reference_pools(
        lut, index.codes, index.ids, index.mask.astype(jnp.float32), probes,
        32, min(l_blk, index.l_pad))
    codes, ids, mask = _slab(index)
    gv, gi = adc_scan.plain_adc_pool(_lut_to_torch(lut, precision), codes,
                                     ids, mask, _t(probes), r=32)
    assert gi.dtype == torch.int32 and gv.dtype == torch.float32
    _assert_pool(gv.numpy(), gi.numpy(), xv, xi, precision)
    _assert_pool(gv.numpy(), gi.numpy(), pv, pi, precision)


def _ragged_slab(rng, nlist=6, l_pad=32, m=4, ks=16,
                 fills=(0, 1, 3, 32, 7, 20)):
    codes = rng.integers(0, ks, (nlist, l_pad, m), dtype=np.uint8)
    ids = np.arange(nlist * l_pad, dtype=np.int32).reshape(nlist, l_pad)
    mask = np.zeros((nlist, l_pad), bool)
    for li, fill in enumerate(fills):
        mask[li, :fill] = True
        ids[li, fill:] = -1
    return codes, ids, mask


@pytest.mark.parametrize("precision", PRECISIONS)
def test_pool_ragged_and_empty_lists(precision):
    """The reference's synthetic slab: ragged lists and one EMPTY list.
    Masked slots never enter the pool, and the slots past the live
    candidate count carry (-inf, -1)."""
    rng = np.random.default_rng(5)
    codes, ids, mask = _ragged_slab(rng)
    fills = mask.sum(1)
    B, P, m, ks, r = 3, 4, 4, 16, 16
    probes = np.stack([rng.choice(6, P, replace=False)
                       for _ in range(B)]).astype(np.int32)
    probes[0] = [0, 1, 2, 4]          # only sparse lists: 11 candidates < r
    lut_f = rng.standard_normal((B, P, m, ks)).astype(np.float32)
    if precision == "int8":
        lut = rng.integers(0, 256, (B, P, m, ks)).astype(np.uint8)
    elif precision == "bf16":
        lut = np.asarray(jnp.asarray(lut_f).astype(jnp.bfloat16))
    else:
        lut = lut_f
    xv, xi, pv, pi = _reference_pools(
        jnp.asarray(lut), jnp.asarray(codes), jnp.asarray(ids),
        jnp.asarray(mask.astype(np.float32)), probes, r, 8)
    gv, gi = adc_scan.plain_adc_pool(
        _lut_to_torch(jnp.asarray(lut), precision), _t(codes), _t(ids),
        _t(mask), _t(probes), r=r)
    gv, gi = gv.numpy(), gi.numpy()
    _assert_pool(gv, gi, xv, xi, precision)
    _assert_pool(gv, gi, pv, pi, precision)
    n_cand = int(sum(fills[li] for li in probes[0]))
    assert n_cand < r
    assert np.all(gi[0, n_cand:] == -1)
    assert np.all(np.isneginf(gv[0, n_cand:]))
    live_ids = {int(i) for i in ids[mask].ravel()}
    assert {int(i) for i in gi.ravel() if i >= 0} <= live_ids


@pytest.mark.parametrize("precision", PRECISIONS)
def test_planted_identical_codes_tie_to_the_earlier_probe(precision):
    """Two docs with identical codes in two probed lists give bit-identical
    ADC sums; the doc of the EARLIER probe must rank first (probe-major
    position), whatever the doc ids."""
    rng = np.random.default_rng(6)
    codes, ids, mask = _ragged_slab(rng, fills=(32, 32, 32, 32, 32, 32))
    ids = (10_000 - np.arange(6 * 32, dtype=np.int32)).reshape(6, 32)
    # list 4 is probed before list 1; the two planted rows share codes that
    # the LUT makes the best of every candidate
    codes[4, 9] = codes[1, 3] = [0, 0, 0, 0]
    probes = np.array([[4, 1, 2, 0]], np.int32)
    lut = (rng.random((1, 4, 4, 16)) * 50 + 10).astype(np.float32)
    lut[:, :, :, 0] = 0.0
    if precision == "int8":
        lut = np.clip(np.round(lut), 0, 255).astype(np.uint8)
    jlut = jnp.asarray(lut)
    if precision == "bf16":
        jlut = jlut.astype(jnp.bfloat16)
    xv, xi, pv, pi = _reference_pools(
        jlut, jnp.asarray(codes), jnp.asarray(ids),
        jnp.asarray(mask.astype(np.float32)), probes, 8, 8)
    gv, gi = adc_scan.plain_adc_pool(
        _lut_to_torch(jlut, precision), _t(codes), _t(ids), _t(mask),
        _t(probes), r=8)
    assert gv[0, 0] == gv[0, 1] == 0.0
    assert gi[0, :2].tolist() == [int(ids[4, 9]), int(ids[1, 3])]
    _assert_pool(gv.numpy(), gi.numpy(), xv, xi, precision)
    _assert_pool(gv.numpy(), gi.numpy(), pv, pi, precision)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_build_luts_matches_reference(built, precision):
    """fp32 and bf16 LUTs agree to float tolerance; uint8 LUTs are equal
    except where the f32 value sits at a rounding boundary (the two
    frameworks' f32 LUTs differ by an ulp there). Those are counted."""
    index, _corpus, queries = built
    probes = jax_ivfpq.host_probe_select(index, queries, 4)
    ref = pallas_adc.build_luts(
        jnp.asarray(queries), index.params.coarse, index.params.codebooks,
        jnp.asarray(probes), adc_precision=precision)
    port = interop.ivfpq_index_from_numpy(
        np.asarray(index.params.coarse), np.asarray(index.params.codebooks),
        np.asarray(index.codes), np.asarray(index.ids),
        np.asarray(index.mask), l_pad=index.l_pad, n=index.n,
        normalized=False, device="cpu")
    got = adc_scan.build_luts(_t(queries), port.params.coarse,
                              port.params.codebooks, _t(probes),
                              adc_precision=precision)
    assert got.dtype == _TORCH_DTYPE[precision]
    if precision == "fp32":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-4)
    elif precision == "bf16":
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   rtol=1e-2, atol=1e-2)
    else:
        f32 = np.asarray(jax_ivfpq.lut_for_probes(
            jnp.asarray(queries), index.params.coarse,
            index.params.codebooks, jnp.asarray(probes)))
        lo = f32.min(axis=(1, 2, 3), keepdims=True)
        hi = f32.max(axis=(1, 2, 3), keepdims=True)
        frac = (f32 - lo) / (np.maximum(hi - lo, 1e-12) / 255.0)
        at_boundary = np.abs(frac - np.floor(frac) - 0.5) < 1e-3
        diff = got.numpy().astype(np.int32) - np.asarray(ref).astype(np.int32)
        assert np.abs(diff).max() <= 1
        assert np.all(at_boundary[diff != 0]), "a flip away from a boundary"
        assert (diff != 0).sum() <= at_boundary.sum()


@pytest.mark.parametrize("sim", ("l2_norm", "cosine"))
@pytest.mark.parametrize("precision", PRECISIONS)
def test_fused_adc_search_matches_reference(built, precision, sim):
    """LUTs, scan, exact rescore, pad: the port's fused pipeline (the
    kernel's wrapper and the plain scan) against the reference's, with the
    Pallas kernel (interpret) and its XLA fallback, on one carried build;
    k past the candidate count exercises the pad."""
    index, (vecs, norms, valid), queries = built
    if sim == "cosine":
        queries = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    port = interop.ivfpq_index_from_numpy(
        np.asarray(index.params.coarse), np.asarray(index.params.codebooks),
        np.asarray(index.codes), np.asarray(index.ids),
        np.asarray(index.mask), l_pad=index.l_pad, n=index.n,
        normalized=False, device="cpu")
    probes = jax_ivfpq.host_probe_select(index, queries, 2)
    for k in (10, 2 * index.l_pad + 3):
        refs = [pallas_adc.fused_adc_search(
            index.params.coarse, index.params.codebooks, index.codes,
            index.ids, index.mask, jnp.asarray(vecs), jnp.asarray(norms),
            jnp.asarray(valid), jnp.asarray(queries), jnp.asarray(probes),
            k=k, rerank=48, similarity=sim, adc_precision=precision,
            use_pallas=use, interpret=use) for use in (True, False)]
        for impl in ("pallas", "xla", None):
            got_v, got_i = adc_scan.adc_topr_auto(
                port.params.coarse, port.params.codebooks, port.codes,
                port.ids, port.mask, _t(vecs), _t(norms), _t(valid),
                _t(queries), probes, k=k, rerank=48, similarity=sim,
                adc_precision=precision, impl=impl)
            assert got_i.shape == (len(queries), k)
            for ref_v, ref_i in refs:
                np.testing.assert_array_equal(got_i.numpy(),
                                              np.asarray(ref_i))
                np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v),
                                           rtol=0, atol=1e-6)


def test_wrapper_takes_the_plain_version_on_cpu_only(built):
    """A CPU tensor runs plain_adc_pool and counts no launch; operands the
    kernel does not take are refused by name before any launch."""
    index, _corpus, queries = built
    lut, probes = _scan_inputs(index, queries, 4, "int8")
    codes, ids, mask = _slab(index)
    lut_t = _lut_to_torch(lut, "int8")
    before = adc_scan.launches.count
    got = adc_scan.adc_pool_scan(lut_t, codes, ids, mask, _t(probes), r=16)
    want = adc_scan.plain_adc_pool(lut_t, codes, ids, mask, _t(probes), r=16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert adc_scan.launches.count == before
    check = adc_scan._check_kernel_operands
    check(lut_t, codes, ids, mask, _t(probes), 16)
    bad = {
        "lut": (lut_t.to(torch.int32), codes, ids, mask, _t(probes)),
        "codes": (lut_t, codes.to(torch.int32), ids, mask, _t(probes)),
        "ids": (lut_t, codes, ids.long(), mask, _t(probes)),
        "mask": (lut_t, codes, ids, mask.float(), _t(probes)),
        "probes": (lut_t, codes, ids, mask, _t(probes).long()),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError, match=name):
            check(*args, 16)
    with pytest.raises(ValueError, match="contiguous"):
        check(lut_t, codes.transpose(0, 1), ids.T, mask.T, _t(probes), 16)


def test_bad_policy_and_probes_are_refused(built):
    index, (vecs, norms, valid), queries = built
    port = interop.ivfpq_index_from_numpy(
        np.asarray(index.params.coarse), np.asarray(index.params.codebooks),
        np.asarray(index.codes), np.asarray(index.ids),
        np.asarray(index.mask), l_pad=index.l_pad, n=index.n,
        normalized=False, device="cpu")
    args = (port.params.coarse, port.params.codebooks, port.codes, port.ids,
            port.mask, _t(vecs), _t(norms), _t(valid), _t(queries))
    probes = jax_ivfpq.host_probe_select(index, queries, 2)
    with pytest.raises(ValueError, match="impl"):
        adc_scan.adc_topr_auto(*args, probes, k=5, rerank=16, impl="cuda")
    with pytest.raises(ValueError, match="adc_precision"):
        adc_scan.adc_topr_auto(*args, probes, k=5, rerank=16,
                               adc_precision="int4")
    with pytest.raises(ValueError, match="probe ids"):
        adc_scan.adc_topr_auto(*args, probes + index.params.nlist, k=5,
                               rerank=16)
