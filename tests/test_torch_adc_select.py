"""K2's two-stage select (opensearch_tpu_torch/csrc/adc_scan.cu), emulated
step for step in numpy on the CPU, against the port's plain version and the
JAX reference; and the wrapper's planning functions.

The emulation follows the kernel: every score becomes a 32-bit key that
orders like the score (-0.0 and +0.0 one key, -inf key 0); stage 1 cuts
each probed list into parts of `span` slots, stops each part at its last
live slot, and keeps the part's best min(R, live) keys by radix-histogram
passes (from the highest bit in which the part's keys differ) to a
threshold key, ranking the keys equal to it by position, then compacts the
survivors' keys and doc ids in slot order; stage 2 concatenates the
parts' survivors in part order (which is position order, so a candidate's
index breaks ties), runs the same select and sorts what is left by
(key desc, index asc). Tolerances are those of
tests/test_torch_adc_scan.py: ids equal; int8 pools bit-equal; fp32 and
bf16 scores to atol 1e-5 against the reference (whose Pallas kernel sums
the subspaces in another order), bit-equal against ``plain_adc_pool``
(same order). The CUDA kernels themselves run only on the card:
chip_smoke.py holds them against ``plain_adc_pool`` there.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from opensearch_tpu.ops import pallas_adc
from opensearch_tpu_torch.ops import adc_scan, cuda_lib

PRECISIONS = ("fp32", "bf16", "int8")
H100_SMS = 132


# ---------------------------------------------------------------- emulation


def score_keys(scores: np.ndarray) -> np.ndarray:
    """The kernel's score_key: uint32 keys ordering like the scores."""
    s = np.asarray(scores, np.float32).copy()
    s[s == 0.0] = 0.0                                  # -0.0 -> +0.0
    u = s.view(np.uint32)
    keys = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    keys[np.isneginf(scores)] = 0
    return keys


def key_scores(keys: np.ndarray) -> np.ndarray:
    """The kernel's key_score: the inverse map, key 0 to -inf."""
    keys = np.asarray(keys, np.uint32)
    u = np.where(keys & 0x80000000, keys & 0x7FFFFFFF, ~keys).astype(
        np.uint32)
    out = u.view(np.float32).copy()
    out[keys == 0] = -np.inf
    return out


def radix_select(keys: np.ndarray, want: int, bits: int):
    """(t, need_eq) of the best `want` nonzero keys, as radix_select in the
    kernel: the kept set is every key > t and the first need_eq keys equal
    to t in index order. Also returns the number of histogram passes."""
    live = keys[keys != 0]
    assert want < live.size
    kmax, kmin = int(live.max()), int(live.min())
    if kmax == kmin:
        return kmax, want, 0
    hi = (kmax ^ kmin).bit_length() - 1
    msk = 0 if hi == 31 else ~((2 << hi) - 1) & 0xFFFFFFFF
    prefix = kmax & msk
    need, passes = want, 0
    k64 = keys.astype(np.int64)
    while True:
        w = min(hi + 1, bits)
        shift = hi + 1 - w
        dmask = (1 << w) - 1
        sel = (k64 != 0) & ((k64 & msk) == prefix)
        hist = np.bincount((k64[sel] >> shift) & dmask, minlength=1 << bits)
        passes += 1
        at_or_above = np.cumsum(hist[::-1])[::-1]     # keys with digit >= d
        d = int(np.nonzero(at_or_above >= need)[0].max())
        need -= int(at_or_above[d] - hist[d])
        prefix |= d << shift
        msk |= dmask << shift
        if hist[d] == need:
            return (prefix - 1 if prefix else 0), 0, passes
        if shift == 0:
            return prefix, need, passes
        hi = shift - 1


def compact(keys: np.ndarray, pos: np.ndarray, t: int, need_eq: int):
    """The kept (key, position) pairs in index order."""
    eq = keys == t
    rank = np.cumsum(eq) - 1
    take = (keys > t) | (eq & (rank < need_eq))
    return keys[take], pos[take]


def select(keys, payload, want: int, bits: int):
    """The kernel's exact select of the best `want` of keys, each with its
    payload: (kept keys, kept payloads) in index order."""
    n_live = int((keys != 0).sum())
    if want >= n_live:
        return compact(keys, payload, 0, 0)
    t, need_eq, _ = radix_select(keys, want, bits)
    return compact(keys, payload, t, need_eq)


def adc_scores(lut: np.ndarray, codes: np.ndarray, mask: np.ndarray,
               probes: np.ndarray) -> np.ndarray:
    """[B, P, L_pad] scores -adc (-inf where masked), summed as decode_row:
    subspaces in order, uint8 in int32, bf16 (given as f32) and fp32 in
    f32 with round-to-nearest adds."""
    pc = codes[probes]                                   # [B, P, L, m]
    B, P, L, m = pc.shape
    acc = None
    for mi in range(m):
        term = np.take_along_axis(lut[:, :, mi, :], pc[..., mi], axis=2)
        if lut.dtype == np.uint8:
            term = term.astype(np.int32)
            acc = term if acc is None else acc + term
        else:
            term = term.astype(np.float32)
            acc = term if acc is None else (acc + term).astype(np.float32)
    adc = acc.astype(np.float32)
    return np.where(mask[probes], -adc, np.float32(-np.inf)).astype(
        np.float32)


def emulate(lut, codes, ids, mask, probes, r: int, span: int,
            bits: int = 11):
    """Both stages of the kernel in numpy: (vals [B, r], ids [B, r])."""
    scores = adc_scores(lut, codes, mask, probes)
    B, P, l_pad = scores.shape
    n_parts = -(-l_pad // span)
    rp = min(r, span)
    out_v = np.full((B, r), -np.inf, np.float32)
    out_i = np.full((B, r), -1, np.int32)
    for b in range(B):
        cand_k, cand_i, cand_pos = [], [], []
        for p in range(P):
            li = probes[b, p]
            for c in range(n_parts):          # stage 1, one CTA a part
                l0 = c * span
                live = np.nonzero(mask[li, l0:l0 + span])[0]
                if live.size == 0:
                    continue
                n = int(live.max()) + 1
                keys = score_keys(scores[b, p, l0:l0 + n])
                slots = l0 + np.arange(n)
                want = min(rp, int((keys != 0).sum()))
                if want:
                    k, sl = select(keys, slots, want, bits)
                    assert k.size == want and np.all(np.diff(sl) > 0)
                    cand_k.append(k)
                    cand_i.append(ids[li, sl])     # the part writes doc ids
                    cand_pos.append(p * l_pad + sl)
        if not cand_k:                        # stage 2, one CTA a query
            continue
        ck, ci = np.concatenate(cand_k), np.concatenate(cand_i)
        assert np.all(np.diff(np.concatenate(cand_pos)) > 0), \
            "parts concatenate in position order"
        want = min(r, ck.size)
        k, e = select(ck, np.arange(ck.size), want, bits)
        order = np.lexsort((e, -k.astype(np.int64)))   # key desc, index asc
        out_v[b, :want] = key_scores(k[order])
        out_i[b, :want] = ci[e[order]]
    return out_v, out_i


# -------------------------------------------------------------------- cases


def _slab(rng, nlist: int, l_pad: int, m: int, ks: int, fills):
    codes = rng.integers(0, ks, (nlist, l_pad, m), dtype=np.uint8)
    ids = rng.permutation(nlist * l_pad).astype(np.int32).reshape(
        nlist, l_pad)
    mask = np.zeros((nlist, l_pad), bool)
    for li, fill in enumerate(fills):
        mask[li, :fill] = True
    ids[~mask] = -1
    return codes, ids, mask


def _lut(rng, shape, precision: str):
    """(LUT as numpy for the emulation, as a torch tensor for the port, as a
    JAX array for the reference); bf16 values go to numpy as f32."""
    f32 = (rng.random(shape) * 8.0).astype(np.float32)
    if precision == "int8":
        u8 = rng.integers(0, 256, shape).astype(np.uint8)
        return u8, torch.from_numpy(u8), jnp.asarray(u8)
    t = torch.from_numpy(f32)
    if precision == "bf16":
        t = t.to(torch.bfloat16)
        return t.float().numpy(), t, jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16)
    return f32, t, jnp.asarray(f32)


def _check(case, r: int, span: int, precision: str, bits: int = 11):
    lut_np, lut_t, lut_j, codes, ids, mask, probes = case
    ev, ei = emulate(lut_np, codes, ids, mask, probes, r, span, bits)
    pv, pi = adc_scan.plain_adc_pool(
        lut_t, torch.from_numpy(codes), torch.from_numpy(ids),
        torch.from_numpy(mask), torch.from_numpy(probes), r=r)
    np.testing.assert_array_equal(ei, pi.numpy())
    np.testing.assert_array_equal(ev, pv.numpy())
    xv, xi = pallas_adc.adc_scan_xla(
        lut_j, jnp.asarray(codes), jnp.asarray(ids),
        jnp.asarray(mask.astype(np.float32)), jnp.asarray(probes), r=r)
    np.testing.assert_array_equal(ei, np.asarray(xi))
    if precision == "int8":
        np.testing.assert_array_equal(ev, np.asarray(xv))
    else:
        assert np.allclose(ev, np.asarray(xv), atol=1e-5, equal_nan=True)
    return ev, ei


def _ragged_case(precision: str, seed: int = 3, B: int = 3, P: int = 4,
                 m: int = 4, ks: int = 16):
    rng = np.random.default_rng(seed)
    fills = (0, 1, 3, 64, 17, 40, 64, 9)
    codes, ids, mask = _slab(rng, len(fills), 64, m, ks, fills)
    mask[5, 11] = mask[6, 30] = False              # holes inside lists
    ids[~mask] = -1
    probes = np.stack([rng.choice(len(fills), P, replace=False)
                       for _ in range(B)]).astype(np.int32)
    probes[0] = [0, 1, 2, 7]                       # 13 live slots
    return (*_lut(rng, (B, P, m, ks), precision), codes, ids, mask, probes)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("span", (4, 16, 64))
@pytest.mark.parametrize("r", (1, 5, 13, 40, 256))
def test_emulated_select_equals_plain_and_reference(precision, span, r):
    """Ragged lists (one empty, holes, one full), parts of 4 to 64 slots,
    R from 1 to past every query's live count (13 for query 0)."""
    case = _ragged_case(precision)
    ev, ei = _check(case, r, span, precision)
    assert np.all(ei[0, 13:] == -1) and np.all(np.isneginf(ev[0, 13:]))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("r", (1, 7, 100))
def test_all_tie_scores_rank_by_position(precision, r):
    """Every code identical and the LUT's column 0 zero: every live slot
    scores -0.0, one key, so the kept set and its order are the lowest
    probe-major positions, across parts and probes."""
    rng = np.random.default_rng(4)
    codes, ids, mask = _slab(rng, 6, 32, 4, 16, (32, 5, 32, 0, 20, 32))
    codes[:] = 0
    B, P = 2, 4
    probes = np.array([[2, 0, 1, 4], [4, 3, 5, 2]], np.int32)
    lut_np, lut_t, lut_j = _lut(rng, (B, P, 4, 16), precision)
    lut_np[..., 0] = 0
    lut_t[..., 0] = 0
    lut_j = lut_j.at[..., 0].set(0)
    case = (lut_np, lut_t, lut_j, codes, ids, mask, probes)
    for span in (8, 32):
        ev, ei = _check(case, r, span, precision)
        want = [int(ids[li, l]) for li in probes[0] for l in range(32)
                if mask[li, l]][:r]
        assert ei[0, :len(want)].tolist() == want
        assert np.all(ev[0, :len(want)] == 0.0)


def test_signed_zero_shares_a_key():
    s = np.array([-0.0, 0.0, -1.0, 1.0, -np.inf, np.inf, -3e38, 1e-45],
                 np.float32)
    k = score_keys(s)
    assert k[0] == k[1] and k[4] == 0
    order = np.argsort(k, kind="stable")
    assert s[order].tolist() == sorted(s.tolist())
    back = key_scores(k)
    assert back[0] == 0.0 and not np.signbit(back[0])
    np.testing.assert_array_equal(back[2:], s[2:])


@pytest.mark.parametrize("bits", (8, 11))
def test_radix_select_finds_the_exact_threshold(bits):
    """On random keys with heavy ties, the kept set is the `want` best by
    (key desc, index asc), at either radix width."""
    rng = np.random.default_rng(9)
    for trial in range(40):
        n = int(rng.integers(2, 600))
        base = rng.standard_normal(n).astype(np.float32)
        if trial % 3 == 0:
            base = np.round(base * 2) / 2               # many equal scores
        base[rng.random(n) < 0.2] = -np.inf
        keys = score_keys(base)
        live = int((keys != 0).sum())
        if live < 2:
            continue
        want = int(rng.integers(1, live))
        _k, ps = select(keys, np.arange(n), want, bits)
        order = np.lexsort((np.arange(n), -keys.astype(np.int64)))[:want]
        assert sorted(ps.tolist()) == sorted(order.tolist())


@pytest.mark.parametrize("precision", PRECISIONS)
def test_emulated_select_on_an_ivf_build(precision):
    """A clustered IVF-PQ build (the reference's LUTs), R 32 and past the
    candidates, at the kernel's planned span and at 8-slot parts."""
    from opensearch_tpu.ops import ivfpq as jax_ivfpq

    rng = np.random.default_rng(11)
    centers = rng.standard_normal((8, 16)) * 5.0
    data = (centers[rng.integers(0, 8, 600)]
            + rng.standard_normal((600, 16))).astype(np.float32)
    index = jax_ivfpq.build(data, nlist=8, m=4, iters=3, seed=2)
    queries = data[:5] + 0.1
    probes = jax_ivfpq.host_probe_select(index, queries, 4).astype(np.int32)
    lut_j = pallas_adc.build_luts(
        jnp.asarray(queries), index.params.coarse, index.params.codebooks,
        jnp.asarray(probes), adc_precision=precision)
    lut_f = np.array(lut_j.astype(jnp.float32))
    lut_t = torch.from_numpy(lut_f)
    if precision == "bf16":
        lut_t = lut_t.to(torch.bfloat16)
    elif precision == "int8":
        lut_f = np.array(lut_j)
        lut_t = torch.from_numpy(lut_f)
    case = (lut_f, lut_t, lut_j, np.array(index.codes),
            np.array(index.ids), np.array(index.mask), probes)
    span, _n_parts, _smem = adc_scan.scan_plan(
        5, 4, index.l_pad, 4, 256, lut_t.element_size(), H100_SMS)
    for r in (32, 4 * index.l_pad):
        for sp in (span, 8):
            _check(case, r, sp, precision)


# ----------------------------------------------------------------- planning


@pytest.mark.parametrize("b,p,l_pad", [(1, 8, 8192), (32, 8, 8192),
                                       (1, 8, 1024), (8, 8, 1024),
                                       (129, 3, 37), (2, 5, 1), (1, 1, 9000)])
@pytest.mark.parametrize("sms", (1, 132))
def test_parts_cover_every_slot_once(b, p, l_pad, sms):
    span, n_parts, _smem = adc_scan.scan_plan(b, p, l_pad, 20, 256, 4, sms)
    assert span & (span - 1) == 0
    assert (n_parts - 1) * span < l_pad <= n_parts * span
    hits = np.zeros(l_pad, int)
    for c in range(n_parts):
        hits[c * span:min((c + 1) * span, l_pad)] += 1
    assert np.all(hits == 1)


def test_span_fills_the_card_and_prefers_whole_lists():
    """Two CTAs an SM where halving down to MIN_SPAN can reach it: glove-100
    (L_pad 8192, P = 8) takes 4096-slot parts at B = 32, 512 at B = 1."""
    assert adc_scan.scan_plan(32, 8, 8192, 20, 256, 4, 132)[:2] == (4096, 2)
    assert adc_scan.scan_plan(1, 8, 8192, 20, 256, 4, 132)[:2] == (512, 16)
    assert adc_scan.scan_plan(128, 8, 8192, 20, 256, 4, 132)[:2] == (8192, 1)
    assert adc_scan.scan_plan(8, 8, 1024, 20, 256, 4, 132)[:2] == (512, 2)
    assert adc_scan.scan_plan(1, 8, 100, 20, 256, 4, 132)[:2] == (128, 1)


@pytest.mark.parametrize("m,elem", [(96, 4), (96, 2), (96, 1), (20, 4),
                                    (8, 4), (30, 1), (200, 4)])
def test_shared_memory_fits_up_to_m_96_at_fp32(m, elem):
    for b in (1, 32, 129):
        span, _n, smem = adc_scan.scan_plan(b, 8, 8192, m, 256, elem, 132)
        assert smem == adc_scan.scan_smem_bytes(elem, m, 256, span)
        assert smem <= adc_scan.SMEM_BUDGET
        assert adc_scan.MIN_SPAN <= span <= adc_scan.MAX_SPAN


def test_scan_plan_raises_when_the_lut_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        adc_scan.scan_plan(1, 8, 8192, 256, 256, 4, 132)
    with pytest.raises(ValueError, match="grid too large"):
        adc_scan.scan_plan(1, 1, 2**26, 8, 256, 1, 132, span=512)


@pytest.mark.parametrize("parts,rp,r", [(128, 64, 64), (16, 64, 64),
                                        (128, 512, 4096), (8, 1, 1),
                                        (20000, 64, 64), (16, 8192, 30000)])
def test_merge_plan_fits_and_never_overlaps(parts, rp, r):
    plan = adc_scan.merge_plan(parts, rp, r)
    assert plan.smem <= adc_scan.SMEM_BUDGET
    assert plan.s_cap >= r and plan.s_cap & (plan.s_cap - 1) == 0
    regions = [(plan.cand_at, 8 * plan.cand_cap)]
    if plan.off_at >= 0:
        regions.append((plan.off_at, 4 * parts))
    if plan.sort_at >= 0:
        regions.append((plan.sort_at, 8 * plan.s_cap))
    regions.sort()
    for (a, na), (b, _nb) in zip(regions, regions[1:]):
        assert a + na <= b
    assert all(at % 16 == 0 for at, _n in regions)
    assert plan.cand_scratch == (parts * rp > plan.cand_cap)
    assert plan.cand_cap <= parts * rp


def test_merge_plan_keeps_glove_in_shared_memory():
    """glove-100 at B = 1 (128 parts of 64): every candidate in shared
    memory; R = 4096 over 128 parts of 512 spills to device scratch."""
    plan = adc_scan.merge_plan(128, 64, 64)
    assert not plan.cand_scratch and plan.off_at == 0 and plan.sort_at >= 0
    big = adc_scan.merge_plan(128, 512, 4096)
    assert big.cand_scratch and big.sort_at >= 0


def test_cpu_tensors_never_load_the_library(monkeypatch):
    """On CPU tensors the wrapper runs plain_adc_pool: it never builds or
    loads the kernel library and counts no launch."""
    def refuse(name):
        raise AssertionError(f"loaded {name} on CPU tensors")

    monkeypatch.setattr(cuda_lib, "load", refuse)
    monkeypatch.setattr(cuda_lib, "build", refuse)
    case = _ragged_case("fp32")
    _lut_np, lut_t, _lut_j, codes, ids, mask, probes = case
    args = (lut_t, torch.from_numpy(codes), torch.from_numpy(ids),
            torch.from_numpy(mask), torch.from_numpy(probes))
    before = adc_scan.launches.count
    got = adc_scan.adc_pool_scan(*args, r=16)
    want = adc_scan.plain_adc_pool(*args, r=16)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert adc_scan.launches.count == before
