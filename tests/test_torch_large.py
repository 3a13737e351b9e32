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
2. The multi-CTA select that serves the tier, emulated as its kernels take
   it: the row cut into G slices (G = 1, 7, 128); at each of three radix
   levels (12, 12 and 8 bits of the score key) every slice's histogram of
   the digit of its live keys that match the prefix so far, added into the
   row's; the bin holding the need-th key from the top; the row decided
   when that bin holds exactly the keys still needed (or every live key
   wins), else past the last level the keys that tie on the bin's score
   taken in doc order, each slice offset by the ties before it; the
   winners compacted in any order (shuffled from a seed); then the plan's
   sort: tiles of 4,096 sorted and merge
   rounds cut at merge-path diagonals into 2,048-key chunks and 8 keys a
   thread, or each winner's rank counted over C slices of the winners. It
   must equal ``plain_pool`` and rule 1 bit for bit at every r and
   similarity of rule 1, at G = 1, 7 and 128, at fp32, bf16 and int8; and
   the brute force and ``plain_large_select`` on rows chosen to stress it:
   every live doc one score (every key ties: doc order decides),
   a threshold bin holding exactly the keys needed, r equal to the live
   count and past it, four shards (one with 5 live docs), and rows of
   30,000 at r = 10,000 and 20,000 (merge rounds), by both sorts.
3. The plan arithmetic: the scan keeps no pool, so its ring and 8-query
   tile fit the card's shared memory at d = 128 and 768 whatever r is; the
   select's shared memory is the same at every r from 1025 to n_flat (2^18
   and 2^20 at d = 128 and 768), every row is cut over at least two CTAs
   and every sort past 4,096 winners over many; the wrapper names the tier
   by (precision, r) alone and never loads the library for CPU tensors.
   The tensor-core scan's plan (ring and padded query tile of 32-bit
   words) fits at d = 128 and 768 at both precisions.
4. The stacked step at k = 1025 and 2000 over 768-d docs (sixteenths, so
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


def _scores(s: int, b: int, similarity: str, precision: str = "fp32"):
    """(scores [s, b, n] f32, valid [s, n]) of _case(s, b) over the dots at
    `precision` (the operands prepped as knn_fused_stacked preps them)."""
    v, norms, valid, q = _case(s, b)
    qsq = (torch.from_numpy(q) ** 2).sum(1)
    v_x, q_x, scale = knn_fused._prep_operands(
        torch.from_numpy(v), torch.from_numpy(q), precision)
    dots = knn_fused._fused_dots(q_x, v_x, precision, scale)
    scores = knn_fused._transform_scores(
        dots, qsq[None, :, None], torch.from_numpy(norms)[:, None, :],
        similarity).numpy()
    return scores, valid


@functools.lru_cache(maxsize=None)
def _emulated_large(s: int, b: int, r: int, similarity: str,
                    precision: str = "fp32"):
    """(vals [s, b, r], ids [s, b, r]) by the large-r tier's rule, over the
    dots at `precision`."""
    scores, valid = _scores(s, b, similarity, precision)
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


@functools.lru_cache(maxsize=None)
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
# the multi-CTA select (csrc/knn_large.cuh: knn_large_pass_kernel,
# knn_large_collect_kernel, then the tile and merge or rank and place
# kernels)
# --------------------------------------------------------------------------

# (lowest bit, bits) of each radix level's digit of the 64-bit key: the
# score key's 12, 12 and 8 bits
LEVELS = ((52, 12), (40, 12), (32, 8))
BINS = 4096
TILE = knn_fused.LARGE_TILE
MERGE_CHUNK = 2048      # outputs a merge CTA
MERGE_PER = 8           # outputs a merge thread
SMS = 132
U64 = np.uint64


def _score_keys(scores, live) -> np.ndarray:
    """csrc/knn_wide.cuh score_key of f32 scores (-0.0 as +0.0), uint32;
    0 for -inf and for a dead doc."""
    f = np.asarray(scores, F32)
    u = np.where(f == 0, 0, f.view(np.uint32)).astype(np.uint32)
    sk = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    sk[(f == -np.inf) | ~np.asarray(live, bool)] = 0
    return sk


def _keys64(sk) -> np.ndarray:
    """The select's 64-bit keys of a row of score keys: the score key above
    ~doc id, 0 for a dead doc."""
    e = np.arange(len(sk), dtype=U64)
    k = (sk.astype(U64) << U64(32)) | (~e & U64(0xFFFFFFFF))
    return np.where(sk == 0, U64(0), k)


def _parts(k64, G: int):
    """The row cut into G slices of ceil(n / G) docs, one a CTA."""
    chunk = -(-len(k64) // G)
    return [k64[g * chunk:(g + 1) * chunk] for g in range(G)]


def _multi_cta_threshold(k64, r: int, G: int):
    """(threshold, level the row was decided at, -1 where every live key
    wins; ties): each level's histogram the sum of the G slices'
    histograms of the digit of their live keys that match the prefix so
    far; the bin holding the need-th key from the top; decided when that
    bin holds exactly the keys still needed. Past the last level the bin's
    keys tie on their score: ties is then (the keys still needed, each
    slice's count of them), else None."""
    parts = _parts(k64, G)
    msk = prefix = 0
    need = r
    for level, (lo, bits) in enumerate(LEVELS):
        dmask = (1 << bits) - 1
        hists = []
        for part in parts:
            mine = part[(part != 0) & ((part & U64(msk)) == U64(prefix))]
            hists.append(np.bincount(((mine >> U64(lo)) & U64(dmask))
                                     .astype(np.int64), minlength=BINS))
        hist = np.sum(hists, axis=0)
        if level == 0 and hist.sum() <= r:
            return 1, -1, None
        from_top = np.cumsum(hist[::-1])
        j = int(np.searchsorted(from_top, need))
        digit = BINS - 1 - j
        c = int(hist[digit])
        left = need - (int(from_top[j]) - c)
        prefix |= digit << lo
        msk |= dmask << lo
        if c == left:
            return prefix, level, None
        if level == len(LEVELS) - 1:
            return prefix, level, (left, [int(h[digit]) for h in hists])
        need = left
    raise AssertionError("unreachable")


def _compacted(k64, t: int, ties, G: int, rng) -> np.ndarray:
    """The winners of every slice, in an order shuffled from rng (the
    warps' atomics give any order): the live keys >= t; or, with ties, the
    keys above t's score and the first `need` tied keys in doc order, each
    slice offset by the tied keys of the slices before it."""
    won = []
    for g, part in enumerate(_parts(k64, G)):
        if ties is None:
            won.append(part[(part != 0) & (part >= U64(t))])
            continue
        need, counts = ties
        sk, ts = part >> U64(32), U64(t >> 32)
        tie = sk == ts
        rank = sum(counts[:g]) + np.cumsum(tie) - tie
        won.append(part[(sk > ts) | (tie & (rank < need))])
    won = np.concatenate(won)
    return won[rng.permutation(len(won))]


def _merge_path(a, b, d: int) -> int:
    """The keys of a among the first d of the descending merge of a and b,
    a first on ties (csrc/knn_large.cuh merge_path)."""
    lo, hi = max(0, d - len(b)), min(d, len(a))
    while lo < hi:
        mid = (lo + hi) // 2
        if a[mid] >= b[d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _tile_merge_sort(won, r: int) -> np.ndarray:
    """r slots: tiles of TILE keys (0 past the winners) sorted in
    descending order (one tile: its power of two), then merge rounds of
    run pairs, each cut into MERGE_CHUNK outputs at merge-path diagonals
    and each chunk into MERGE_PER outputs a thread at its own."""
    buf = np.zeros(r, U64)
    buf[:len(won)] = won
    n_tiles = -(-r // TILE)
    p = TILE if n_tiles > 1 else max(32, 1 << (r - 1).bit_length())
    for t in range(n_tiles):
        tile = np.zeros(p, U64)
        seg = buf[t * TILE:t * TILE + p]
        tile[:len(seg)] = seg
        buf[t * TILE:t * TILE + len(seg)] = np.sort(tile)[::-1][:len(seg)]
    w = TILE
    while w < r:
        out = np.empty(r, U64)
        for o0 in range(0, r, MERGE_CHUNK):
            o1 = min(r, o0 + MERGE_CHUNK)
            p0 = o0 // (2 * w) * (2 * w)
            a = buf[p0:min(r, p0 + w)]
            b = buf[min(r, p0 + w):min(r, p0 + 2 * w)]
            i0, i1 = _merge_path(a, b, o0 - p0), _merge_path(a, b, o1 - p0)
            sa, sb = a[i0:i1], b[o0 - p0 - i0:o1 - p0 - i1]
            for d0 in range(0, o1 - o0, MERGE_PER):
                i = _merge_path(sa, sb, d0)
                j = d0 - i
                for d in range(d0, min(o1 - o0, d0 + MERGE_PER)):
                    if j >= len(sb) or (i < len(sa) and sa[i] >= sb[j]):
                        out[o0 + d] = sa[i]
                        i += 1
                    else:
                        out[o0 + d] = sb[j]
                        j += 1
        buf = out
        w *= 2
    return buf


def _rank_sort(won, r: int, slices: int) -> np.ndarray:
    """r slots: each winner at its rank, the count of winners with a larger
    key summed over the slices [c * span, (c + 1) * span) of the winners;
    0 past them."""
    span = -(-r // slices)
    rank = np.zeros(len(won), np.int64)
    for c0 in range(0, len(won), span):
        part = np.sort(won[c0:c0 + span])
        rank += len(part) - np.searchsorted(part, won, side="right")
    out = np.zeros(r, U64)
    out[rank] = won
    return out


def _decoded(slots):
    """(scores f32, ids int32) of 64-bit keys: (-inf, -1) for 0."""
    hi = (slots >> U64(32)).astype(np.uint32)
    bits = np.where(hi & 0x80000000, hi & 0x7FFFFFFF, ~hi).astype(np.uint32)
    vals = np.where(hi == 0, F32(-np.inf), bits.view(F32))
    ids = (~slots & U64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return vals.astype(F32), np.where(slots == 0, -1, ids).astype(np.int32)


def _multi_cta_select(scores, valid, r: int, G: int, sort: str,
                      seed: int = 0):
    """(vals [s, b, r], ids [s, b, r], levels [s, b]) of the multi-CTA
    select over scores [s, b, n] with valid [s, n]."""
    s, b, _n = scores.shape
    rng = np.random.default_rng(seed)
    vals = np.empty((s, b, r), F32)
    ids = np.empty((s, b, r), np.int32)
    levels = np.empty((s, b), np.int64)
    for si in range(s):
        for bi in range(b):
            k64 = _keys64(_score_keys(scores[si, bi], valid[si]))
            t, levels[si, bi], ties = _multi_cta_threshold(k64, r, G)
            won = _compacted(k64, t, ties, G, rng)
            assert len(won) == min(int((k64 != 0).sum()), r)
            slots = (_tile_merge_sort(won, r) if sort == "merge" else
                     _rank_sort(won, r, knn_fused.rank_slices(s, b, r, SMS)))
            vals[si, bi], ids[si, bi] = _decoded(slots)
    return vals, ids, levels


def _brute(scores, valid, r: int):
    """The r best of each row under (score desc, doc id asc), padded."""
    s, b, n = scores.shape
    vals = np.full((s, b, r), -np.inf, F32)
    ids = np.full((s, b, r), -1, np.int32)
    for si in range(s):
        for bi in range(b):
            live = np.nonzero(valid[si] & (scores[si, bi] > -np.inf))[0]
            order = live[np.lexsort((live, -scores[si, bi, live]))][:r]
            vals[si, bi, :len(order)] = scores[si, bi, order]
            ids[si, bi, :len(order)] = order
    return vals, ids


def _plain_select(scores, valid, r: int):
    """knn_fused.plain_large_select over the rows' score keys (int32)."""
    keys = np.stack([np.stack([_score_keys(scores[si, bi], valid[si])
                               for bi in range(scores.shape[1])])
                     for si in range(scores.shape[0])])
    pv, pi = knn_fused.plain_large_select(
        torch.from_numpy(keys.view(np.int32)), r)
    return pv.numpy(), pi.numpy()


@pytest.mark.parametrize("precision", ("fp32", "bf16", "int8"))
@pytest.mark.parametrize("G", (1, 7, 128))
@pytest.mark.parametrize("similarity", SIMS)
@pytest.mark.parametrize("r", (1025, 2000, N_DOCS, N_DOCS + 500))
def test_multi_cta_select_equals_plain_pool(r, similarity, G, precision):
    """The serving select (its plan's sort) over the keys of either scan:
    plain_pool and today's rule (rule 1) bit for bit."""
    scores, valid = _scores(1, 3, similarity, precision)
    got_v, got_i, _levels = _multi_cta_select(
        scores, valid, r, G, knn_fused.large_sort_plan(r), seed=G)
    pv, pi = _plain(1, 3, r, similarity, precision)
    np.testing.assert_array_equal(got_i, pi.numpy())
    np.testing.assert_array_equal(got_v, pv.numpy())
    ev, ei = _emulated_large(1, 3, r, similarity, precision)
    np.testing.assert_array_equal(got_i, ei)
    np.testing.assert_array_equal(got_v, ev)


def _stress(kind: str):
    """(scores [1, 1, n], valid [1, n], r, levels allowed) of a row chosen
    to stress the select."""
    rng = np.random.default_rng(77)
    n = N_DOCS
    valid = np.ones((1, n), bool)
    if kind == "all_equal":
        # every live doc one score: every level keeps every key, and the
        # compaction takes the first r in doc order
        return np.full((1, 1, n), F32(0.5)), valid, 1500, (2,)
    if kind == "exact_bin":
        # 200 docs above 0.75, 1,000 in [0.5, 0.5625) (one bin of the
        # first level: exponent and three mantissa bits), the rest below
        # 0.25: at r = 1200 that bin holds exactly the keys still needed
        sc = rng.uniform(0.0, 0.25, n).astype(F32)
        sc[:200] = rng.uniform(0.75, 1.0, 200)
        sc[200:1200] = rng.uniform(0.5, 0.56, 1000)
        return sc[None, None].astype(F32), valid, 1200, (0,)
    sc = (np.round(rng.uniform(0, 1, n) * 512) / 512).astype(F32)
    valid[0, rng.choice(n, 90, replace=False)] = False
    live = int(valid.sum())
    if kind == "r_is_live":
        return sc[None, None], valid, live, (-1,)
    assert kind == "past_live"
    return sc[None, None], valid, live + 500, (-1,)


@pytest.mark.parametrize("sort", knn_fused.LARGE_SORTS)
@pytest.mark.parametrize("G", (1, 7, 128))
@pytest.mark.parametrize("kind", ("all_equal", "exact_bin", "r_is_live",
                                  "past_live"))
def test_multi_cta_select_on_stressing_rows(kind, G, sort):
    scores, valid, r, levels = _stress(kind)
    got_v, got_i, got_levels = _multi_cta_select(scores, valid, r, G, sort,
                                                 seed=5)
    assert set(got_levels.ravel().tolist()) <= set(levels)
    bv, bi = _brute(scores, valid, r)
    np.testing.assert_array_equal(got_i, bi)
    np.testing.assert_array_equal(got_v, bv)
    pv, pi = _plain_select(scores, valid, r)
    np.testing.assert_array_equal(pi, bi)
    np.testing.assert_array_equal(pv, bv)
    if kind == "all_equal":
        assert got_i[0, 0].tolist() == list(range(r))


@pytest.mark.parametrize("sort", knn_fused.LARGE_SORTS)
@pytest.mark.parametrize("G", (1, 7, 128))
@pytest.mark.parametrize("r", (1025, N_DOCS + 500))
def test_multi_cta_select_over_four_shards(r, G, sort):
    """Four shards, the last with 5 live docs (fewer than r: every live
    doc, then (-inf, -1)), by both sorts: plain_pool bit for bit."""
    scores, valid = _scores(4, 2, "l2_norm")
    got_v, got_i, levels = _multi_cta_select(scores, valid, r, G, sort)
    pv, pi = _plain(4, 2, r, "l2_norm")
    np.testing.assert_array_equal(got_i, pi.numpy())
    np.testing.assert_array_equal(got_v, pv.numpy())
    assert (got_i[3] >= 0).sum(axis=1).tolist() == [5, 5]
    assert levels[3].tolist() == [-1, -1]


@pytest.mark.parametrize("sort", knn_fused.LARGE_SORTS)
@pytest.mark.parametrize("G", (7, 128))
@pytest.mark.parametrize("r", (10_000, 20_000))
def test_multi_cta_select_past_one_tile(r, G, sort):
    """Rows of 30,000 docs whose scores tie in runs (ninths of 1/512) and
    2% dead, at r past one tile: 3 and 5 tiles, 2 and 3 merge rounds, or
    the rank over slices. The brute force and plain_large_select bit for
    bit."""
    rng = np.random.default_rng(r + G)
    n = 30_000
    scores = (np.round(rng.uniform(0, 1, (1, 2, n)) * 4608) / 4608).astype(F32)
    valid = rng.random((1, n)) >= 0.02
    got_v, got_i, _levels = _multi_cta_select(scores, valid, r, G, sort)
    bv, bi = _brute(scores, valid, r)
    np.testing.assert_array_equal(got_i, bi)
    np.testing.assert_array_equal(got_v, bv)
    pv, pi = _plain_select(scores, valid, r)
    np.testing.assert_array_equal(pi, bi)
    np.testing.assert_array_equal(pv, bv)


def test_key_scores_invert_the_score_key():
    """plain_large_select's decode: the score of every key the scans write
    (-0.0 as +0.0; -inf for 0), over positive, negative and extreme f32."""
    f = np.array([0.0, -0.0, 1.0, 0.5, 1e-30, 3.4e38, -1.0, -2.5e-12,
                  -3.4e38, np.inf, -np.inf, 0.9999999], F32)
    sk = _score_keys(f, np.ones(len(f), bool))
    got = knn_fused.key_scores(torch.from_numpy(sk.view(np.int32))).numpy()
    want = np.where(f == 0, F32(0.0), f)
    np.testing.assert_array_equal(got, want)
    assert not np.signbit(got[:2]).any()


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


def _select_smem() -> int:
    """csrc/knn_large.cuh multi_select_smem_bytes: the most shared memory
    (all static) a kernel of the select takes, whatever r: a merge CTA's
    staged inputs and outputs (2 x 2,048 keys and two cuts) or a tile of
    4,096 keys."""
    return max(8 * 2 * MERGE_CHUNK + 8, 8 * TILE)


def _select_ctas(r: int, sort: str) -> int:
    """CTAs a row of the select's sort at r: the tiles and each merge
    round's chunks, or the rank CTAs."""
    if sort == "rank":
        blocks = -(-r // 1024)
        return blocks * knn_fused.rank_slices(1, 1, r, SMS)
    return max(-(-r // TILE), -(-r // MERGE_CHUNK) if r > TILE else 1)


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
    no part in it) and a select whose shared memory is the same at every r
    and fits the 48 KB a CTA has without opting in; its row is cut over at
    least two CTAs, and its sort past 4,096 winners runs over many CTAs a
    row (tiles and merge rounds of whole 2,048-key chunks, or the rank),
    never one network."""
    stages, floats = knn_fused.large_plan(d, _scan_smem)
    assert _scan_smem(stages, floats, d) <= knn_fused._MAX_SMEM
    assert _select_smem() <= 48 * 1024
    G, chunk = knn_fused.large_select_geometry(1, n_flat, 1, SMS)
    assert G >= 2 and G * chunk >= n_flat
    rs = np.arange(1025, n_flat + 1)
    tiles = -(-rs // TILE)
    rounds = np.ceil(np.log2(tiles)).astype(np.int64)
    # the rounds' runs cover the row, and each round is needed
    assert ((TILE << rounds) >= rs).all()
    assert ((rounds == 0) | ((TILE << np.maximum(rounds - 1, 0)) < rs)).all()
    assert (2 * TILE) % MERGE_CHUNK == 0
    for r in (1025, 4096, 4097, 16384, 16385, n_flat):
        assert knn_fused.scan_tier("fp32", r) == "large"
        sort = knn_fused.large_sort_plan(r)
        assert sort in knn_fused.LARGE_SORTS
        assert r <= TILE or _select_ctas(r, sort) >= 2
        # the scratch a row: state and histogram, the winners, the merge's
        # second buffer or the ranks
        row = 4 * (8 + BINS) + 8 * r + (8 * r if sort == "merge" else 4 * r)
        assert row <= 24 << 20


@pytest.mark.parametrize("S,B,n", [(1, 1, 1 << 18), (1, 1, 1 << 20),
                                   (1, 1, 1500), (1, 9, 20_000),
                                   (1, 33, 60_000), (4, 9, 12_000),
                                   (4, 33, 12_000), (1, 128, 32_768),
                                   (8, 128, 1 << 20)])
def test_select_geometry_cuts_every_row_over_many_ctas(S, B, n):
    """G slices of chunk docs (a multiple of 32) cover each row, at least
    two a row, and the grid of all rows is at least a wave of the card's
    SMs (or every 32 docs of the row has its CTA)."""
    G, chunk = knn_fused.large_select_geometry(S, n, B, SMS)
    assert chunk % 32 == 0 and (G - 1) * chunk < n <= G * chunk
    assert G >= 2 and G * S * B >= min(SMS, -(-n // 32) * S * B)
    assert G <= -(-2 * SMS // (S * B)) + 1 or G == 2


@pytest.mark.parametrize("r", (1025, 4096, 10_000, 20_000, 1 << 20))
def test_rank_slices_fill_the_card(r):
    """The rank's CTAs (blocks of 1,024 winners x slices) are about two
    waves where the winners allow it, each slice at least 64 winners."""
    blocks = -(-r // 1024)
    c = knn_fused.rank_slices(1, 1, r, SMS)
    assert 1 <= c <= -(-r // 64)
    assert blocks * c >= min(2 * SMS, blocks * -(-r // 64))


def test_sort_plan_names_one_sort_per_range_of_r():
    rs = (1025, knn_fused.LARGE_RANK_MAX_R, knn_fused.LARGE_RANK_MAX_R + 1,
          1 << 20)
    assert [knn_fused.large_sort_plan(r) for r in rs] == [
        "rank" if r <= knn_fused.LARGE_RANK_MAX_R else "merge" for r in rs]


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
    tier's tensor-core scan, with a scan plan that fits and the fp32
    tier's select; no r reaches the tile scan."""
    model = functools.partial(_mma_scan_smem, precision)
    stages, words = knn_fused.large_plan(d, model, precision)
    assert model(stages, words, d) <= knn_fused._MAX_SMEM
    for r in (1025, 1461, 2000, 4096, 16384, 16385, n_flat):
        assert knn_fused.scan_tier(precision, r) == "large_mma"
        assert _select_smem() <= knn_fused._MAX_SMEM
    assert knn_fused.scan_tier(precision, 1024) == "mma"


def test_cpu_tensors_take_plain_pool_at_large_r():
    """A CPU tensor at r past 1024 takes plain_pool: no launch of any
    design is counted, and no kernel library is built or loaded."""
    v, norms, valid, q = (torch.from_numpy(a) for a in _case(1, 3))
    counters = (knn_fused.launches, knn_fused.large_launches,
                knn_fused.large_select_launches,
                knn_fused.yardstick_launches)
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
