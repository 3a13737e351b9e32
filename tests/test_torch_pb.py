"""K4 of the port (opensearch_tpu_torch/ops/knn_blocks.py
``knn_blocktopk_auto``: every 2048-doc block's top-k, then the block-major
merge) against the JAX reference (opensearch_tpu/ops/pallas_knn.py
``knn_blocktopk_auto``, its Pallas kernel in interpret mode), on the CPU,
where the port takes its plain versions.

The same numpy inputs go through both. Ids must be equal; scores agree to
rtol 1e-5 with atol 2e-5 for l2 (``|q|^2 - 2 q.v + |v|^2`` cancels near a
neighbour and the two frameworks sum the d products in another order) and
1e-6 for cosine and dot. The batch sizes cover each of the stage-1
kernel's query tiles (8, 32, 128), full and partial, and B past one
128-query tile.

The CUDA kernels run only on the card (``chip_smoke.py`` holds both bit
for bit against ``plain_pb_topk`` and ``pb_merge``). Their selection rules
are emulated here in numpy, step for step as the kernels take them, and
held bit for bit against the plain versions on data whose dots are exact
in f32 (sixteenths): the list tier's per-warp lists behind the goodness
filter, with the group's bound and the first step's bound from the lanes'
maxima, then the merge of a group's lists; the scores tier's radix select,
ordered compaction and ranks; and the merge kernel's select over the
block-major row.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from opensearch_tpu.ops import pallas_knn
from opensearch_tpu_torch.ops import knn_blocks

BLOCK = knn_blocks.PB_BLOCK
N_DOCS = 2 * BLOCK + 100          # three blocks, the last ragged
DIM = 16
RUN = tuple(range(2100, 2112))    # 12 equal vectors inside block 1
EDGE = (2040, 2053)               # a duplicate across the block 0 / 1 edge
SPARSE = range(0, 40)             # block 0 keeps few live docs at k past them


def _atol(similarity: str) -> float:
    return 2e-5 if similarity == "l2_norm" else 1e-6


@functools.lru_cache(maxsize=None)
def _case(b: int, sixteenths: bool = False):
    """Numpy operands: ragged n, 3% dead docs, the planted RUN and EDGE
    copies, and b queries of which the first two are the EDGE and RUN
    vectors. ``sixteenths`` rounds every coordinate to a multiple of 1/16,
    so every dot is exact in f32 in any order."""
    rng = np.random.default_rng(600 + b)
    v = rng.standard_normal((N_DOCS, DIM)).astype(np.float32)
    if sixteenths:
        v = np.round(v * 16) / 16
    v[list(EDGE)] = v[EDGE[0]]
    v[list(RUN)] = v[RUN[0]]
    valid = rng.random(N_DOCS) >= 0.03
    valid[[*EDGE, *RUN]] = True
    q = v[rng.choice(N_DOCS, b)].copy()
    q[0] = v[EDGE[0]]
    if b > 1:
        q[1] = v[RUN[0]]
    norms = (v.astype(np.float64) ** 2).sum(1).astype(np.float32)
    return v, norms, valid, q


@functools.lru_cache(maxsize=None)
def _reference(b: int, k: int, similarity: str):
    vals, ids = pallas_knn.knn_blocktopk_auto(
        *(jnp.asarray(a) for a in _case(b)), k=k, similarity=similarity)
    return np.asarray(vals), np.asarray(ids)


@pytest.mark.parametrize("b,similarity", [
    (1, "l2_norm"), (8, "cosine"), (9, "dot_product"), (32, "l2_norm"),
    (33, "cosine"), (128, "l2_norm"), (129, "dot_product")])
def test_entry_point_matches_reference_at_each_query_tile(b, similarity):
    """B = 1 and 8 (tile 8), 9 and 32 (tile 32), 33 and 128 (tile 128) and
    129 (two 128-query tiles): the reference's ids, best first, the planted
    copies in id order."""
    jv, ji = _reference(b, 10, similarity)
    tv, ti = knn_blocks.knn_blocktopk_auto(
        *(torch.from_numpy(a) for a in _case(b)), k=10, similarity=similarity)
    tv, ti = tv.numpy(), ti.numpy()
    assert ti.shape == (b, 10) and ti.dtype == np.int32
    np.testing.assert_array_equal(ti, ji)
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=1e-5,
                               atol=_atol(similarity))
    if similarity != "dot_product":
        assert ti[0, :2].tolist() == list(EDGE)
        if b > 1:
            assert ti[1, :10].tolist() == list(RUN[:10])


def test_k_past_a_blocks_live_count_matches_reference():
    """A block with 3 live docs at k = 10: its pools pad with (-inf, block
    base), which the merge turns into -1 past the valid count."""
    v, norms, valid, q = (a.copy() for a in _case(5))
    valid[:] = False
    valid[[7, 1500, 2047]] = True
    jv, ji = pallas_knn.knn_blocktopk_auto(
        *(jnp.asarray(a) for a in (v, norms, valid, q)), k=10)
    tv, ti = knn_blocks.knn_blocktopk_auto(
        *(torch.from_numpy(a) for a in (v, norms, valid, q)), k=10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti[:, 3:] == -1).all() and torch.isneginf(tv[:, 3:]).all()
    vals, ids = knn_blocks.plain_pb_topk(
        *(torch.from_numpy(a) for a in (v, norms, valid, q)), k=10,
        similarity="l2_norm")
    assert torch.isneginf(vals[0, :, 3:]).all()
    assert (ids[1:, :, :] == torch.arange(1, 3)[:, None, None] * BLOCK).all()


# --------------------------------------------------------------------------
# the kernels' rules, emulated in numpy
# --------------------------------------------------------------------------

F32 = np.float32
REL, ABS = F32(2.0 ** -12), F32(2.0 ** -20)


def _better(av, ai, bv, bi) -> bool:
    return av > bv or (av == bv and ai < bi)


def _sorted(pairs, k):
    """The k best (score, column) pairs under (score desc, column asc)."""
    return sorted(pairs, key=lambda p: (-p[0], p[1]))[:k]


def _goodness(a, qq, ns, similarity):
    """The kernel's pre-transform goodness in f32, one rounding an
    operation."""
    if similarity == "l2_norm":
        t = F32(F32(qq - F32(F32(2.0) * a)) + ns)
        return -max(t, F32(0.0))
    if similarity == "cosine":
        return F32(a * F32(F32(1.0) / np.sqrt(max(ns, F32(1e-24)))))
    return a


def _slack(g, qn, similarity):
    return F32(abs(g) * REL + (F32(2.0) * REL * qn if similarity == "cosine"
                               else ABS))


def _threshold_goodness(thr, qn, similarity):
    if not np.isfinite(thr):
        return F32(-np.inf)
    if similarity == "l2_norm":
        g = -F32(F32(F32(1.0) / thr) - F32(1.0))
    elif similarity == "cosine":
        g = F32(F32(F32(2.0) * thr - F32(1.0)) * qn)
    else:
        g = F32(thr - 1) if thr >= 1 else F32(F32(1.0) - F32(F32(1.0) / thr))
    return F32(g - _slack(g, qn, similarity))


def _emulated_lists(dots, scores, ns, valid, qq, k, similarity, qt):
    """The list tier's stage 1 for one query over every block: the kernel's
    warps of one 8-query group at query tile qt (subs_per_step sub-blocks a
    step), each filtering its sub-block's docs on the goodness bound, then
    inserting the passers into its own list; the group's bound rises with
    every list's k-th entry. Returns (vals [nb, k], ids [nb, k], passers)."""
    sps = {8: 8, 32: 4, 128: 1}[qt]
    steps = BLOCK // (sps * 128)
    qn = np.sqrt(max(qq, F32(1e-24)))
    nb = dots.shape[0] // BLOCK
    out_v = np.empty((nb, k), F32)
    out_i = np.empty((nb, k), np.int32)
    passers = 0
    for blk in range(nb):
        base = blk * BLOCK
        lists = [[(F32(-np.inf), base)] * k for _ in range(sps)]
        low = F32(-np.inf)
        for step in range(steps):
            for w in range(sps):
                doc0 = base + (step * sps + w) * 128
                docs = np.arange(doc0, doc0 + 128)
                live = valid[docs]
                g = np.array([_goodness(dots[j], qq, ns[j], similarity)
                              if live[i] else F32(-np.inf)
                              for i, j in enumerate(docs)], F32)
                lower = low
                if step == 0:
                    lane_max = g.reshape(4, 32).max(axis=0)
                    g0 = np.sort(lane_max)[::-1][k - 1]
                    lower = max(lower, F32(g0 - _slack(g0, qn, similarity)))
                take = live & (g >= lower)
                passers += int(take.sum())
                cand = [(scores[j], int(j)) for j in docs[take]]
                lists[w] = _sorted(lists[w] + cand, k)
                low = max(low, _threshold_goodness(lists[w][k - 1][0], qn,
                                                   similarity))
        merged = _sorted([p for lst in lists for p in lst], k)
        out_v[blk] = [p[0] for p in merged]
        out_i[blk] = [p[1] for p in merged]
    return out_v, out_i, passers


def _plain_operands(b, similarity):
    v, norms, valid, q = (torch.from_numpy(a) for a in _case(b, True))
    qp = knn_blocks._pad_queries(q, knn_blocks.PB_QTILE)
    n_pad = -(-N_DOCS // BLOCK) * BLOCK
    scores = knn_blocks._plain_scores(v, norms, valid, qp,
                                      similarity=similarity, exact=True,
                                      n_pad=n_pad).numpy()
    dots = np.zeros((qp.shape[0], n_pad), F32)
    dots[:, :N_DOCS] = (qp @ v.T).numpy()
    ns = np.zeros(n_pad, F32)
    ns[:N_DOCS] = norms.numpy()
    live = np.zeros(n_pad, bool)
    live[:N_DOCS] = valid.numpy()
    qsq = (qp * qp).sum(1).numpy()
    return (v, norms, valid, qp), scores, dots, ns, live, qsq


@pytest.mark.parametrize("qt,k", [(8, 10), (32, 10), (128, 10), (32, 32),
                                  (128, 1)])
@pytest.mark.parametrize("similarity", ("l2_norm", "cosine", "dot_product"))
def test_emulated_list_tier_equals_plain_stage1(similarity, qt, k):
    """The list tier's rule at each query tile's warp layout gives
    plain_pb_topk's pools bit for bit (ids on finite slots), the planted
    RUN and EDGE ties included, and lets through far fewer docs than a
    block holds."""
    args, scores, dots, ns, live, qsq = _plain_operands(2, similarity)
    want_v, want_i = knn_blocks.plain_pb_topk(*args, k=k,
                                              similarity=similarity)
    for b in range(2):
        got_v, got_i, passers = _emulated_lists(
            dots[b], scores[b], ns, live, qsq[b], k, similarity, qt)
        np.testing.assert_array_equal(got_v, want_v[:, b].numpy())
        fin = np.isfinite(got_v)
        np.testing.assert_array_equal(got_i[fin], want_i[:, b].numpy()[fin])
        assert passers < 0.5 * N_DOCS


def _order_keys(x: np.ndarray) -> np.ndarray:
    """Order-preserving uint32 keys of f32 values, -0.0 folded to +0.0 (the
    kernels' order_key)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    neg = (u & 0x80000000) != 0
    return np.where(neg, ~u, u | 0x80000000).astype(np.uint32)


def _radix_select(keys: np.ndarray, k: int) -> tuple[int, int]:
    """(key of the k-th largest, how many equal to it a stable top-k takes)
    by four 8-bit passes, most significant first."""
    prefix, mask, kr = 0, 0, k
    for shift in (24, 16, 8, 0):
        match = keys[(keys & np.uint32(mask)) == prefix]
        hist = np.bincount((match >> shift) & 255, minlength=256)
        above = 0
        for digit in range(255, -1, -1):
            if above < kr <= above + hist[digit]:
                break
            above += hist[digit]
        prefix |= digit << shift
        mask |= 255 << shift
        kr -= above
    return prefix, kr


def _select_ranked(x: np.ndarray, k: int) -> np.ndarray:
    """Positions of the k winners of x, best first: the ordered compaction
    (every key above the threshold, the first `need` equal to it, in
    position order), then each winner's rank counted against the others."""
    keys = _order_keys(x)
    thr, need = _radix_select(keys, k)
    eq = keys == thr
    win = np.nonzero((keys > thr) | (eq & (np.cumsum(eq) - eq < need)))[0]
    assert len(win) == k
    wk = keys[win]
    rank = [int(((wk > wk[i]) | ((wk == wk[i]) & (win < win[i]))).sum())
            for i in range(k)]
    out = np.empty_like(win)
    out[rank] = win
    return out


@pytest.mark.parametrize("k", [33, 100, BLOCK])
def test_emulated_scores_tier_equals_plain_stage1(k):
    """The scores tier (k > 32): per block and query, the radix select and
    the ordered compaction over the block's 2048 scores, ranked; -inf slots
    carry the block's first doc id. Bit-equal to plain_pb_topk."""
    args, scores, _dots, _ns, _live, _qsq = _plain_operands(9, "l2_norm")
    want_v, want_i = knn_blocks.plain_pb_topk(*args, k=k,
                                              similarity="l2_norm")
    for b in (0, 1, 8):
        for blk in range(scores.shape[1] // BLOCK):
            row = scores[b, blk * BLOCK:(blk + 1) * BLOCK]
            win = _select_ranked(row, k)
            vals = row[win]
            ids = np.where(vals > -np.inf, blk * BLOCK + win, blk * BLOCK)
            np.testing.assert_array_equal(vals, want_v[blk, b].numpy())
            np.testing.assert_array_equal(ids, want_i[blk, b].numpy())


def _pools(nb: int, b: int, k: int):
    """Stage-1 pools with planted equal scores across blocks and ranks,
    -inf slots, and signed zeros."""
    rng = np.random.default_rng(nb * 100 + k)
    vals = np.sort(np.round(rng.standard_normal((nb, b, k)) * 2) / 2,
                   axis=-1)[..., ::-1].astype(np.float32)
    vals[1, :, -3:] = -np.inf
    vals[2, 0, :] = -np.inf
    vals[0, 1, :2] = [0.0, -0.0]
    vals[3, 1, :2] = [0.0, -0.0]
    ids = (np.arange(nb)[:, None, None] * BLOCK
           + np.sort(rng.choice(BLOCK, (nb, b, k)), axis=-1)).astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(vals)), torch.from_numpy(ids)


@pytest.mark.parametrize("nb,k", [(4, 3), (5, 10), (7, 32)])
def test_emulated_merge_equals_pb_merge(nb, k):
    """The merge kernel's rule, one query at a time over its nb * k
    candidates in block-major order (radix select, ordered compaction,
    ranks; id -1 for a non-finite winner), gives pb_merge's values and ids
    bit for bit: ties go to the lower block, then the lower rank."""
    vals, ids = _pools(nb, 3, k)
    want_v, want_i = knn_blocks.pb_merge(vals, ids, k)
    for b in range(3):
        row = vals[:, b].reshape(-1).numpy()
        win = _select_ranked(row, k)
        got_v = row[win]
        got_i = np.where(np.isfinite(got_v), ids[:, b].reshape(-1).numpy()[win],
                         -1)
        np.testing.assert_array_equal(got_v.view(np.uint32),
                                      want_v[b].numpy().view(np.uint32))
        np.testing.assert_array_equal(got_i, want_i[b].numpy())


# --------------------------------------------------------------------------
# the wrapper's choices on the CPU
# --------------------------------------------------------------------------


def test_odd_width_pads_without_changing_the_answer():
    """rows_in_16_bytes pads d = 30 to 32 with zero columns: the plain
    stage 1 and the entry point give the same bits on the padded operands
    (norms and |q|^2 stay the unpadded ones)."""
    rng = np.random.default_rng(30)
    v = torch.from_numpy(np.round(rng.standard_normal((3000, 30)) * 16)
                         .astype(np.float32) / 16)
    q = v[:9] + 0.25
    norms = (v.double() ** 2).sum(1).float()
    valid = torch.ones(3000, dtype=torch.bool)
    pv, pq = knn_blocks.rows_in_16_bytes(v, q)
    assert pv.shape == (3000, 32) and pq.shape == (9, 32)
    assert not pv[:, 30:].any() and not pq[:, 30:].any()
    for sim in ("l2_norm", "cosine", "dot_product"):
        for exact in (True, False):
            want = knn_blocks.plain_pb_topk(v, norms, valid, q, k=10,
                                            similarity=sim, exact=exact)
            got = knn_blocks.plain_pb_topk(pv, norms, valid, pq, k=10,
                                           similarity=sim, exact=exact)
            assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_unaligned_operands_are_copied_and_aligned_ones_kept():
    flat = torch.zeros(64 * 8 + 1)
    view = flat[1:].view(64, 8)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    q = torch.ones((2, 8))
    pv, pq = knn_blocks.rows_in_16_bytes(view, q)
    assert pv.data_ptr() % 16 == 0 and torch.equal(pv, view)
    assert pq is q
    v = torch.ones((64, 8))
    pv, pq = knn_blocks.rows_in_16_bytes(v, q)
    assert pv is v and pq is q


@pytest.mark.parametrize("b_pad,k,want", [
    (8, 10, (8, 0)), (32, 10, (32, 0)), (128, 10, (128, 0)),
    (128, 32, (8, 0)), (40, 33, (8, 1)), (256, 2048, (8, 1))])
def test_plan_picks_the_list_tier_then_the_scores_tier(b_pad, k, want):
    """The list tier at k <= PB_LIST_K, its query tile stepped down until
    the shared memory fits (here a stand-in that fits 8 rows always and
    larger tiles only at k <= 10); the scores tier above."""
    def smem(qt, tier, d, kk):
        return 1 if tier == 1 or qt == 8 or kk <= 10 else 10 ** 9
    assert knn_blocks.pb_plan(b_pad, 128, k, smem) == want


def test_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        knn_blocks.pb_plan(8, 10_000, 10, lambda qt, tier, d, k: 10 ** 9)


def test_cpu_tensors_never_launch():
    """On CPU tensors both stages and the entry point take the plain
    versions and count no launch."""
    v, norms, valid, q = (torch.from_numpy(a) for a in _case(8))
    before = (knn_blocks.pb_launches.count,
              knn_blocks.pb_merge_launches.count)
    pools = knn_blocks.pb_topk(v, norms, valid, q, k=5)
    want = knn_blocks.plain_pb_topk(v, norms, valid, q, k=5,
                                    similarity="l2_norm")
    assert all(torch.equal(a, w) for a, w in zip(pools, want))
    got = knn_blocks.pb_select(*pools, 5)
    assert all(torch.equal(a, w)
               for a, w in zip(got, knn_blocks.pb_merge(*pools, 5)))
    knn_blocks.knn_blocktopk_auto(v, norms, valid, q, k=5)
    assert (knn_blocks.pb_launches.count,
            knn_blocks.pb_merge_launches.count) == before
