"""The wide tier of K1's and K3's list scan
(opensearch_tpu_torch/csrc/knn_wide.cuh), on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them bit for
bit against ``plain_pool`` and ``plain_block_topk``). Their rule is
emulated here in numpy, step for step as the kernels take it: each shard
cut into contiguous ranges at 128-doc multiples by the wrapper's own
geometry for 8-query tiles; in each range, per query, steps of 1,024 docs;
the conservative pre-transform filter, loose by 2^-12, against the pool's
r-th score (-inf until the pool holds r); the step's passers appended to a
buffer of the plan's capacity; a flush when the pool can fill, when the
next step could overflow the buffer and at the range's end, which keeps
the r best of pool and buffer by the kernels' radix select over 64-bit
keys (the score's order-preserving key above ~doc id, so ties go by id);
the sorted range pools; then the split merge: the r-th best key of the
pools' first slots, each pool's prefix at or above it, and the r best of
those by the same select. The emulation must equal
``ops/knn_fused.plain_pool`` bit for bit (ids, and values on data whose
dots are exact in f32: sixteenths) at
r = 33, 64, 100, 128 and 1024, one and four shards, the three
similarities, planted duplicates (ties to the lower id, across a range
edge and within a sub-block), dead docs and a shard with fewer live docs
than r; and, in one case each, the JAX reference's ``_fused_xla_pool`` and
``pallas_knn_topk`` (opensearch_tpu/ops/pallas_knn.py, in interpret mode as
tests/test_pallas_knn.py runs it) on the same numpy inputs.

Then the wrapper: its plan fits the card's shared memory at r up to 1024
and d up to 768, or raises; a CPU tensor never loads the library.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from opensearch_tpu.ops import pallas_knn
from opensearch_tpu_torch.ops import cuda_lib, knn_blocks, knn_fused

F32 = np.float32
REL, ABS = F32(2.0 ** -12), F32(2.0 ** -20)
STEP = knn_fused.WIDE_STEP          # docs a step (8 warps x 128)
QT = knn_fused.WIDE_QUERY_TILE      # queries a CTA
N_DOCS = 3000
DIM = 16
COPIES = (1535, 1536)               # a duplicate across a range edge
RUN = tuple(range(700, 740))        # 40 equal vectors in sub-block 5
SIMS = ("l2_norm", "cosine", "dot_product")
MASK64 = (1 << 64) - 1
MERGE_STAGE = 16384                 # the merge's candidates in shared memory


@functools.lru_cache(maxsize=None)
def _case(s: int, b: int):
    """Numpy operands: s shards of N_DOCS sixteenths (every dot exact in
    f32), 3% dead docs, COPIES and RUN planted live in every shard, and
    with four shards only 5 live docs in the last; b queries, the first
    the COPIES vector and the second the RUN vector."""
    rng = np.random.default_rng(900 + 10 * s + b)
    v = (np.round(rng.standard_normal((s, N_DOCS, DIM)) * 16) / 16).astype(F32)
    v[:, list(COPIES)] = v[:, COPIES[:1]]
    v[:, list(RUN)] = v[:, RUN[:1]]
    valid = rng.random((s, N_DOCS)) >= 0.03
    valid[:, [*COPIES, *RUN]] = True
    if s == 4:
        valid[3] = False
        valid[3, rng.choice(N_DOCS, 5, replace=False)] = True
    q = v[0, rng.choice(N_DOCS, b)].copy()
    q[0] = v[0, COPIES[0]]
    if b > 1:
        q[1] = v[0, RUN[0]]
    norms = (v.astype(np.float64) ** 2).sum(2).astype(F32)
    return v, norms, valid, q


def _plain(s, b, r, similarity):
    v, norms, valid, q = (torch.from_numpy(a) for a in _case(s, b))
    qsq = (q * q).sum(1)
    return knn_fused.plain_pool(v, norms, valid, q, qsq, torch.ones(s),
                                r=r, similarity=similarity,
                                score_precision="fp32")


# --------------------------------------------------------------------------
# the kernels' rule, emulated in numpy
# --------------------------------------------------------------------------


def _goodness(a, qq, ns, similarity):
    """The kernels' pre-transform goodness in f32, one rounding an
    operation (vectorised over docs)."""
    if similarity == "l2_norm":
        t = (qq - F32(2.0) * a).astype(F32) + ns
        return -np.maximum(t.astype(F32), F32(0.0))
    if similarity == "cosine":
        rvn = (F32(1.0) / np.sqrt(np.maximum(ns, F32(1e-24)))).astype(F32)
        return (a * rvn).astype(F32)
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


def _pair_key(score, doc: int) -> int:
    """The kernels' 64-bit key of (score desc, doc id asc): the score's
    order-preserving 32 bits (-0.0 as +0.0, -inf as 0) above ~doc id;
    (-inf, -1) is 0."""
    s = F32(score)
    if s == -np.inf:
        sk = 0
    else:
        u = 0 if s == 0 else int(np.array(s, F32).view(np.uint32))
        sk = (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000
    return (sk << 32) | (~doc & 0xFFFFFFFF)


def _radix_threshold(keys, want: int) -> int:
    """The kernels' select (csrc/knn_wide.cuh warp_select, and the merge's
    block-wide one) on the nonzero keys, more than `want` of them and
    distinct: 8-bit passes from the highest bit in which the largest and
    least differ, each a histogram of the keys that match the digits found
    so far, the bin holding the want-th key from the top picked, until that
    bin is kept whole. Exactly `want` keys are >= the threshold returned."""
    live = [k for k in keys if k]
    kmax, kmin = max(live), min(live)
    hi = (kmax ^ kmin).bit_length() - 1
    msk = 0 if hi == 63 else MASK64 & ~((2 << hi) - 1)
    prefix = kmax & msk
    need = want
    while True:
        w = min(hi + 1, 8)
        shift = hi + 1 - w
        dmask = (1 << w) - 1
        hist = [0] * 256
        for k in live:
            if k & msk == prefix:
                hist[(k >> shift) & dmask] += 1
        above = 0
        for digit in range(255, -1, -1):
            if above + hist[digit] >= need:
                break
            above += hist[digit]
        need -= above
        prefix |= digit << shift
        msk |= dmask << shift
        if hist[digit] == need or shift == 0:
            return prefix
        hi = shift - 1


def _keep_best(pairs, r: int):
    """The r best (score, doc) pairs by the select: every pair whose key is
    at least the threshold (all of them when there are no more than r)."""
    keys = [_pair_key(v, i) for v, i in pairs]
    t = _radix_threshold(keys, r) if len(pairs) > r else 0
    kept = [p for p, k in zip(pairs, keys) if k >= t]
    assert len(kept) == min(len(pairs), r)
    return kept


def _sorted_slots(pairs, r: int):
    """pairs by key, best first, padded with (-inf, -1) to r slots."""
    pairs = sorted(pairs, key=lambda p: -_pair_key(*p))
    return pairs + [(F32(-np.inf), -1)] * (r - len(pairs))


def _emulated_range(dots, scores, ns, live, qq, start, end, r, similarity,
                    cap, stats):
    """One query's sorted pool of r slots over docs [start, end) of one
    shard, as a CTA of the wide tier builds it."""
    qn = np.sqrt(np.maximum(qq, F32(1e-24)))
    pool, buf = [], []
    lower = F32(-np.inf)
    steps = -(-(end - start) // STEP)
    for step in range(steps):
        docs = np.arange(start + step * STEP, min(end, start + (step + 1)
                                                  * STEP))
        ok = live[docs]
        g = np.where(ok, _goodness(dots[docs], qq, ns[docs], similarity),
                     F32(-np.inf)).astype(F32)
        take = ok & (g >= lower)
        buf += [(scores[j], int(j)) for j in docs[take]]
        stats["passers"] += int(take.sum())
        assert len(buf) <= cap
        last = step == steps - 1
        if buf and (last or len(buf) > cap - STEP or (
                len(pool) < r and len(pool) + len(buf) >= r)):
            m = len(pool) + len(buf)
            pool, buf = _keep_best(pool + buf, r), []
            stats["flushes"] += 1
            if m >= r:
                least = min(pool, key=lambda p: _pair_key(*p))
                lower = _threshold_goodness(least[0], qn, similarity)
    return _sorted_slots(pool, r)


def _emulated_merge(pools, r: int, stats, stage: int = MERGE_STAGE):
    """The split merge over the ranges' sorted pools of r slots: the r-th
    best key t0 of their first merge_prefix slots (every live one when no
    more than r), each pool's slots at or above t0 (a prefix), and the r
    best of those by the select (of every slot, read from device memory,
    where they would not fit the `stage` candidates of shared memory),
    sorted, (-inf, -1) past the live count."""
    n_split = len(pools)
    pre = min(r, 4 * -(-r // n_split))              # merge_prefix
    first = [_pair_key(*c) for pool in pools for c in pool[:pre]]
    first = [k for k in first if k]
    t0 = _radix_threshold(first, r) if len(first) > r else 1
    cands = []
    for pool in pools:
        keys = [_pair_key(*c) for c in pool]
        length = sum(k >= t0 for k in keys)
        assert all(k >= t0 for k in keys[:length])  # a prefix
        cands += pool[:length]
    stats["merge_candidates"] = max(stats.get("merge_candidates", 0),
                                    len(cands))
    if len(cands) > min(n_split * r, stage):        # merge_cap
        stats["merge_from_device"] = True
        cands = [c for pool in pools for c in pool if c[1] >= 0]
    return _sorted_slots(_keep_best(cands, r), r)


def _emulated_pool(s, b, r, similarity, sms, cap, stage=MERGE_STAGE):
    """The wide tier's (vals [S, B, r], ids [S, B, r], stats) on _case(s,
    b): the wrapper's ranges, each range's sorted pools, then the
    range-major split merge with `stage` candidates of shared memory."""
    v, norms, valid, q = _case(s, b)
    qsq = (torch.from_numpy(q) ** 2).sum(1)
    chunk, n_split = knn_fused.list_geometry(s, N_DOCS, -(-b // QT), sms)
    out_v = np.empty((s, b, r), F32)
    out_i = np.empty((s, b, r), np.int32)
    stats = {"passers": 0, "flushes": 0, "ranges": n_split,
             "merge_from_device": False}
    for shard in range(s):
        dots = q @ v[shard].T                       # exact: sixteenths
        scores = knn_fused._transform_scores(
            torch.from_numpy(dots), qsq[:, None],
            torch.from_numpy(norms[shard])[None], similarity).numpy()
        for qi in range(b):
            pools = [_emulated_range(
                dots[qi], scores[qi], norms[shard], valid[shard],
                qsq[qi].numpy(), split * chunk,
                min(N_DOCS, (split + 1) * chunk), r, similarity, cap, stats)
                for split in range(n_split)]
            merged = _emulated_merge(pools, r, stats, stage)
            for j, (sv, si) in enumerate(merged):
                out_v[shard, qi, j] = sv
                out_i[shard, qi, j] = si
    return out_v, out_i, stats


def _assert_plain(got_v, got_i, s, b, r, similarity):
    want_v, want_i = _plain(s, b, r, similarity)
    np.testing.assert_array_equal(got_i, want_i.numpy())
    np.testing.assert_array_equal(got_v.view(np.uint32),
                                  want_v.numpy().view(np.uint32))


@pytest.mark.parametrize("s", (1, 4))
@pytest.mark.parametrize("r", (33, 64, 100, 128, 1024))
@pytest.mark.parametrize("similarity", SIMS)
def test_emulated_wide_tier_equals_plain_pool(similarity, r, s):
    """Two ranges a shard of two steps each (1,024 + 512 docs), a buffer of
    one step: plain_pool's pools bit for bit, the planted copies in id
    order across the range edge, the run of 40 equal vectors in id order,
    the dead docs out, (-inf, -1) past the live count of the sparse shard;
    the filter lets through fewer docs than it sees once a pool can
    fill."""
    b = 3
    got_v, got_i, stats = _emulated_pool(s, b, r, similarity,
                                         sms=2 * s, cap=STEP)
    _assert_plain(got_v, got_i, s, b, r, similarity)
    if similarity != "dot_product":
        assert got_i[0, 0, :2].tolist() == list(COPIES)
        run = min(r, len(RUN))
        assert got_i[0, 1, :run].tolist() == list(RUN[:run])
    if s == 4:
        assert (got_i[3, :, 5:] == -1).all() and (
            got_v[3, :, 5:] == -np.inf).all()
    if r <= 128:
        assert stats["passers"] < 0.8 * s * b * N_DOCS


@pytest.mark.parametrize("sms,ranges,r,cap", [
    (2, 1, 100, STEP), (2, 1, 100, 4 * STEP), (6, 3, 100, 2 * STEP),
    (132, 24, 256, STEP), (132, 24, 1024, 4 * STEP), (4, 2, 1024, STEP)])
def test_emulated_wide_tier_at_other_cuts(sms, ranges, r, cap):
    """Nine queries (two 8-query tiles) over one range a shard (three
    steps), three, two, and one range a sub-block (the card's 132 SMs over
    3,000 docs: 24 ranges of 128, each shorter than r), with buffers of one
    to four steps: the cut and the buffer change the passers and the
    flushes, never the pools."""
    got_v, got_i, stats = _emulated_pool(1, 9, r, "l2_norm", sms, cap)
    _assert_plain(got_v, got_i, 1, 9, r, "l2_norm")
    assert stats["ranges"] == ranges
    assert stats["flushes"] >= 9 * ranges
    # the merge's second stage reads far fewer slots than the pools hold
    assert stats["merge_candidates"] <= max(2 * r, ranges * r // 4)


@pytest.mark.parametrize("sms,r", [(6, 100), (4, 1024), (132, 33)])
def test_emulated_merge_from_device_memory_equals_plain_pool(sms, r):
    """The merge's fallback (knn_wide_merge_kernel reads every slot from
    device memory when the prefixes overflow its shared memory), forced
    with one candidate of shared memory: plain_pool's pools all the
    same."""
    got_v, got_i, stats = _emulated_pool(1, 9, r, "l2_norm", sms, STEP,
                                         stage=1)
    _assert_plain(got_v, got_i, 1, 9, r, "l2_norm")
    assert stats["merge_from_device"]


def test_merge_overflows_its_stage_when_near_docs_fill_ranges():
    """The layout chip_smoke.py's merge_fallback_check gives the card: 131
    ranges of 2,304 docs (300,000 over 132 SMs), r = 1024, and the near
    docs filling 24 whole ranges from the third. The first bound t0 falls
    among the far ranges' first 32 slots, so each near range gives all its
    1024 slots: past the 16,384 candidates of shared memory, the merge
    reads every slot from device memory, and keeps the 1024 best of all,
    ties (many equal near scores) by id."""
    chunk, n_split = knn_fused.list_geometry(1, 300_000, 1, 132)
    assert (chunk, n_split) == (2304, 131)
    r = 1024
    rng = np.random.default_rng(7)
    pools, every = [], []
    for p in range(n_split):
        near = 2 <= p < 26
        scores = (F32(0.5) + rng.integers(0, 64, r).astype(F32) / F32(256)
                  if near else rng.random(r).astype(F32) / F32(16))
        pairs = [(F32(v), p * chunk + j) for j, v in enumerate(scores)]
        every += pairs
        pools.append(_sorted_slots(pairs, r))
    stats = {}
    merged = _emulated_merge(pools, r, stats)
    assert stats["merge_candidates"] >= 24 * r > MERGE_STAGE
    assert stats["merge_from_device"]
    assert merged == _sorted_slots(sorted(every, key=lambda c: -_pair_key(
        *c))[:r], r)


@pytest.mark.parametrize("kind", ("random", "shared_high_bits", "ties_by_id",
                                  "few"))
@pytest.mark.parametrize("want", (1, 33, 100, 1024))
def test_radix_threshold_keeps_exactly_want(kind, want):
    """The select on distinct keys: exactly `want` keys at or above its
    threshold, and they are the `want` largest; on keys that share their
    high 40 bits, on equal scores told apart by id alone, and on barely
    more keys than wanted."""
    rng = np.random.default_rng(want)
    m = want + 1 if kind == "few" else 3 * want + 50
    if kind == "random":
        keys = rng.integers(1, 1 << 63, m, dtype=np.int64).tolist()
    elif kind == "shared_high_bits":
        keys = [(0xABCDE << 40) | int(x) for x in
                rng.choice(1 << 40, m, replace=False)]
    elif kind == "ties_by_id":
        keys = [_pair_key(F32(0.5), int(i)) for i in
                rng.choice(10 * m, m, replace=False)]
    else:
        keys = [_pair_key(F32(x), int(i)) for i, x in
                enumerate(rng.standard_normal(m))]
    keys = list(dict.fromkeys(keys))
    t = _radix_threshold(keys, want)
    assert sorted(k for k in keys if k >= t) == sorted(keys)[-want:]


def test_pair_key_orders_by_score_then_id():
    """Larger key, better pair: a higher score, or an equal one at a lower
    doc id; -0.0 and +0.0 tie; (-inf, -1) is 0, below every live pair."""
    pairs = [(F32(2.0), 5), (F32(2.0), 7), (F32(1.0), 0), (F32(0.0), 3),
             (F32(-0.0), 4), (F32(-1.0), 1), (F32(-3e38), 2)]
    keys = [_pair_key(v, i) for v, i in pairs]
    assert keys == sorted(keys, reverse=True)
    assert _pair_key(F32(0.0), 9) == _pair_key(F32(-0.0), 9)
    assert _pair_key(F32(-np.inf), -1) == 0 < min(keys)


@pytest.mark.parametrize("similarity", SIMS)
def test_emulated_wide_tier_equals_reference_xla_pool(similarity):
    """The emulation against the JAX reference's XLA pool at r = 100 on the
    same numpy inputs: ids equal; scores to rtol 1e-6 (XLA may fuse the
    transform's operations, which the port and the kernels round one at a
    time)."""
    v, norms, valid, q = _case(1, 5)
    qj = jnp.asarray(q)
    jv, ji = pallas_knn._fused_xla_pool(
        jnp.asarray(v[0]), jnp.asarray(norms[0]), jnp.asarray(valid[0]), qj,
        jnp.sum(qj * qj, axis=1, keepdims=True), jnp.ones((1,), jnp.float32),
        r=100, similarity=similarity, score_precision="fp32")
    got_v, got_i, _stats = _emulated_pool(1, 5, 100, similarity, sms=2,
                                          cap=STEP)
    np.testing.assert_array_equal(got_i[0], np.asarray(ji))
    np.testing.assert_allclose(got_v[0], np.asarray(jv), rtol=1e-6, atol=0)


def test_emulated_wide_tier_equals_reference_block_kernel():
    """K3's wide tier is the same emulation at r = k over one shard: at
    k = 100 it equals the reference's Pallas kernel ``pallas_knn_topk``
    (through its ``knn_topk_auto``, in interpret mode on the CPU) and the
    port's ``plain_block_topk`` on the same numpy inputs: ids equal;
    scores bit-equal to the port's, to rtol 1e-6 against the reference."""
    v, norms, valid, q = _case(1, 9)
    jv, ji = pallas_knn.knn_topk_auto(
        jnp.asarray(v[0]), jnp.asarray(norms[0]), jnp.asarray(valid[0]),
        jnp.asarray(q), k=100, similarity="l2_norm")
    got_v, got_i, _stats = _emulated_pool(1, 9, 100, "l2_norm", sms=4,
                                          cap=STEP)
    np.testing.assert_array_equal(got_i[0], np.asarray(ji))
    np.testing.assert_allclose(got_v[0], np.asarray(jv), rtol=1e-6, atol=0)
    pv, pi = knn_blocks.plain_block_topk(
        *(torch.from_numpy(a) for a in (v[0], norms[0], valid[0], q)),
        k=100, similarity="l2_norm")
    np.testing.assert_array_equal(got_i[0], pi.numpy())
    np.testing.assert_array_equal(got_v[0].view(np.uint32),
                                  pv.numpy().view(np.uint32))


# --------------------------------------------------------------------------
# the wrapper on the CPU
# --------------------------------------------------------------------------


def _wide_smem(stages, floats, d, r, rows, cap):
    """csrc/knn_wide.cuh scan_smem_bytes: the ring, the 8-query tile (d cut
    into whole chunks), eight words a warp of select scratch, five words a
    query, a 256-bin histogram a warp, and rows queries' pools of r and
    buffers of cap pairs."""
    if (stages, floats) not in knn_fused.WIDE_RINGS:
        return 0
    dc = floats // STEP
    dp = -(-d // dc) * dc
    return 4 * (stages * floats + QT * dp + 8 * 8 + 5 * QT + 8 * 256
                + 2 * rows * (r + cap))


@pytest.mark.parametrize("b,d,r,want", [
    (1, 128, 100, (3, 16384, 2688)), (1, 128, 1024, (3, 16384, 1792)),
    (8, 128, 100, (2, 16384, 1280)), (8, 128, 128, (2, 16384, 1152)),
    (9, 128, 100, (2, 16384, 1280)), (129, 128, 64, (2, 16384, 1280)),
    (8, 128, 1024, (2, 8192, 1280)), (8, 768, 1024, (2, 8192, 1024)),
    (129, 30, 1024, (2, 8192, 1408)), (1, 768, 33, (2, 16384, 4096)),
    (1, 16, 33, (3, 16384, 3200))])
def test_wide_plan_fits_the_shared_memory(b, d, r, want):
    """The first ring beside which min(8, b) queries' pools and buffers of
    at least one step fit 232,448 bytes, the buffer as large as the rest
    allows in whole 128s, up to 4,096."""
    plan = knn_fused.wide_plan(b, d, r, _wide_smem)
    assert plan == want
    stages, floats, cap = plan
    rows = min(QT, b)
    assert cap >= STEP and cap % 128 == 0
    assert _wide_smem(stages, floats, d, r, rows, cap) <= knn_fused._MAX_SMEM
    assert cap == knn_fused.WIDE_MAX_CAP or _wide_smem(
        stages, floats, d, r, rows, cap + 128) > knn_fused._MAX_SMEM


@pytest.mark.parametrize("d", (1, 30, 128, 512, 768))
@pytest.mark.parametrize("r", (33, 100, 1024))
@pytest.mark.parametrize("b", (1, 8, 129))
def test_wide_plan_takes_every_supported_shape(b, d, r):
    """r up to 1024 and d up to 768 always have a plan."""
    stages, floats, cap = knn_fused.wide_plan(b, d, r, _wide_smem)
    assert _wide_smem(stages, floats, d, r, min(QT, b), cap) \
        <= knn_fused._MAX_SMEM


def test_wide_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        knn_fused.wide_plan(8, 4096, 1024, _wide_smem)


def test_wide_grid_limits_raise():
    """More shards than a grid's y dimension takes raise before anything
    is launched."""
    s = knn_fused._MAX_GRID + 1
    v, norms = torch.zeros((s, 1, 4)), torch.zeros((s, 1))
    valid, q = torch.ones((s, 1), dtype=torch.bool), torch.zeros((1, 4))
    with pytest.raises(ValueError, match="grid too large"):
        knn_fused.launch_wide(None, _wide_smem, v, norms, valid, q,
                              torch.zeros(1), r=100, similarity="l2_norm")


def test_cpu_tensors_never_load_the_library():
    """K1's wrapper at r = 100 and 1024, its stacked entry point at k = 100
    and K3's at k = 100 take the plain versions on CPU tensors: the
    answers are plain_pool's, no launch of any design is counted, and no
    kernel library is built or loaded."""
    v, norms, valid, q = (torch.from_numpy(a) for a in _case(1, 3))
    counters = (knn_fused.launches, knn_fused.list_launches,
                knn_fused.wide_launches, knn_blocks.block_launches,
                knn_blocks.block_list_launches,
                knn_blocks.block_wide_launches)
    before = [c.count for c in counters]
    qsq = (q * q).sum(1)
    for r in (100, 1024):
        got = knn_fused.pool_scan(v, norms, valid, q, qsq, torch.ones(1),
                                  r=r, similarity="l2_norm",
                                  score_precision="fp32")
        want = _plain(1, 3, r, "l2_norm")
        assert all(torch.equal(a, w) for a, w in zip(got, want))
    knn_fused.knn_fused_stacked(v, norms, valid, q, k=100)
    knn_blocks.knn_topk_auto(v[0], norms[0], valid[0], q, k=100)
    assert [c.count for c in counters] == before
    assert not {"knn_fused", "knn_block"} & set(cuda_lib._libs)
