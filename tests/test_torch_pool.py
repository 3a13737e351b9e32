"""The list scan of K1 and K3 (opensearch_tpu_torch/csrc/knn_pool.cuh), on
the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it bit for
bit against ``plain_pool`` and ``plain_block_topk``). Its selection rule is
emulated here in numpy, step for step as the kernel takes it: each shard
cut into contiguous ranges at 128-doc multiples by the wrapper's own
geometry; in each range, per 8-query group, one list of the r best
(score, doc id) pairs per warp, fed by 128-doc sub-blocks and carried
across the whole range; the conservative pre-transform filter, loose by
2^-12, with the group's bound from every warp's r-th entry and, in the
range's first step, from the r-th largest of the lanes' maxima; the merge
of a group's lists at the range's end; then the split merge over the
ranges. The emulation must equal ``ops/knn_fused.plain_pool`` bit for bit
(ids, and values on data whose dots are exact in f32: sixteenths) at each
query tile's warp layout, r = 1, 10 and 32, one and four shards, a ragged
n, the three similarities, planted duplicates (ties to the lower id), dead
docs and a shard with fewer live docs than r; and, in one case, the JAX
reference's ``_fused_xla_pool`` (opensearch_tpu/ops/pallas_knn.py) on the
same numpy inputs.

Then the wrapper's choices: the ranges cover every shard once, the design
is chosen by (precision, r) for K1 (the list scan, its wide tier at fp32
with 32 < r <= 1024, tests/test_torch_wide.py, the wide tier's tensor-core
scan at bf16 and int8 with r <= 1024, tests/test_torch_wide_mma.py, or the
tile scan past r = 1024) and by k for K3, the plans fit the card's shared memory, and a CPU tensor never
launches.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from opensearch_tpu.ops import pallas_knn
from opensearch_tpu_torch.ops import knn_blocks, knn_fused

F32 = np.float32
REL, ABS = F32(2.0 ** -12), F32(2.0 ** -20)
SUB = knn_fused.LIST_SUB
N_DOCS = 3000                      # 23 sub-blocks and a ragged 56 docs
DIM = 16
COPIES = (1535, 1536)              # a duplicate across a range edge
RUN = tuple(range(700, 740))       # 40 equal vectors in sub-block 5
SIMS = ("l2_norm", "cosine", "dot_product")
# warps a group has, each on its own sub-block of a step (subs_per_step)
SUBS_PER_STEP = {8: 8, 32: 4, 128: 1}


@functools.lru_cache(maxsize=None)
def _case(s: int, b: int):
    """Numpy operands: s shards of N_DOCS sixteenths (every dot exact in
    f32), 3% dead docs, COPIES and RUN planted live in every shard, and
    with four shards only 5 live docs in the last; b queries, the first
    the COPIES vector and the second the RUN vector."""
    rng = np.random.default_rng(700 + 10 * s + b)
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
# the kernel's rule, emulated in numpy
# --------------------------------------------------------------------------


def _goodness(a, qq, ns, similarity):
    """The kernel's pre-transform goodness in f32, one rounding an
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


def _best(pairs, r):
    """The r best (score, id) pairs under (score desc, id asc)."""
    return sorted(pairs, key=lambda p: (-p[0], p[1]))[:r]


def _emulated_range(dots, scores, ns, live, qq, start, end, r, similarity,
                    qt):
    """One query's pool over docs [start, end) of one shard: the warps of
    its group at query tile qt, each with a list carried across the range,
    behind the filter. Returns (pool [(score, id)] * r, passers)."""
    sps = SUBS_PER_STEP[qt]
    qn = np.sqrt(max(qq, F32(1e-24)))
    lists = [[(F32(-np.inf), -1)] * r for _ in range(sps)]
    low = F32(-np.inf)
    passers = 0
    steps = -(-(end - start) // (sps * SUB))
    for step in range(steps):
        for w in range(sps):
            doc0 = start + (step * sps + w) * SUB
            if doc0 >= end:
                continue          # a sub-block wholly past the range's end
            docs = np.arange(doc0, doc0 + SUB)
            inside = docs < end
            safe = np.minimum(docs, end - 1)
            ok = inside & live[safe]
            g = np.where(ok, _goodness(dots[safe], qq, ns[safe], similarity),
                         F32(-np.inf)).astype(F32)
            lower = low
            if step == 0:
                lane_max = g.reshape(4, 32).max(axis=0)
                g0 = np.sort(lane_max)[::-1][r - 1]
                lower = max(lower, F32(g0 - _slack(g0, qn, similarity)))
            take = ok & (g >= lower)
            passers += int(take.sum())
            cand = [(scores[j], int(j)) for j in docs[take]]
            lists[w] = _best(lists[w] + cand, r)
            low = max(low, _threshold_goodness(lists[w][r - 1][0], qn,
                                               similarity))
    return _best([p for lst in lists for p in lst], r), passers


def _emulated_pool(s, b, r, similarity, qt, sms):
    """The list scan's (vals [S, B, r], ids [S, B, r], passers) on _case(s,
    b): the wrapper's ranges, each range's pools, then the split merge
    (non-finite winners as (-inf, -1))."""
    v, norms, valid, q = _case(s, b)
    qsq = (torch.from_numpy(q) ** 2).sum(1)
    n_qt = -(-b // qt)
    chunk, n_split = knn_fused.list_geometry(s, N_DOCS, n_qt, sms)
    out_v = np.empty((s, b, r), F32)
    out_i = np.empty((s, b, r), np.int32)
    passers = 0
    for shard in range(s):
        dots = q @ v[shard].T                       # exact: sixteenths
        scores = knn_fused._transform_scores(
            torch.from_numpy(dots), qsq[:, None],
            torch.from_numpy(norms[shard])[None], similarity).numpy()
        for qi in range(b):
            pools = []
            for split in range(n_split):
                start = split * chunk
                pool, n_pass = _emulated_range(
                    dots[qi], scores[qi], norms[shard], valid[shard],
                    qsq[qi].numpy(), start, min(N_DOCS, start + chunk), r,
                    similarity, qt)
                pools += pool
                passers += n_pass
            merged = _best(pools, r)
            for j, (sv, si) in enumerate(merged):
                hit = sv > -np.inf
                out_v[shard, qi, j] = sv if hit else -np.inf
                out_i[shard, qi, j] = si if hit else -1
    return out_v, out_i, passers


@pytest.mark.parametrize("s", (1, 4))
@pytest.mark.parametrize("r", (1, 10, 32))
@pytest.mark.parametrize("qt", knn_fused.QUERY_TILES)
@pytest.mark.parametrize("similarity", SIMS)
def test_emulated_list_scan_equals_plain_pool(similarity, qt, r, s):
    """The list scan's rule at each query tile's warp layout gives
    plain_pool's pools bit for bit: the planted copies in id order, the
    dead docs out, (-inf, -1) past the live count of the sparse shard; and
    its filter lets through far fewer docs than it sees."""
    b = 3
    want_v, want_i = _plain(s, b, r, similarity)
    # two ranges a shard a query tile, so each range runs several steps
    got_v, got_i, passers = _emulated_pool(s, b, r, similarity, qt,
                                           sms=2 * s * -(-b // qt))
    np.testing.assert_array_equal(got_i, want_i.numpy())
    np.testing.assert_array_equal(got_v.view(np.uint32),
                                  want_v.numpy().view(np.uint32))
    if similarity != "dot_product" and r > 1:
        assert got_i[0, 0, :2].tolist() == list(COPIES)
        assert got_i[0, 1, :r].tolist() == list(RUN[:r])
    if s == 4:
        assert (got_i[3, :, 5:] == -1).all() and (got_v[3, :, 5:] == -np.inf
                                                  ).all()
    assert passers < 0.5 * s * b * N_DOCS


@pytest.mark.parametrize("sms", (1, 3, 132))
def test_emulated_list_scan_at_other_cuts(sms):
    """One range a shard, three, and one range a sub-block (the card's 132
    SMs over 3,000 docs): the cut changes the passers, never the pools."""
    want_v, want_i = _plain(1, 9, 10, "l2_norm")
    got_v, got_i, _passers = _emulated_pool(1, 9, 10, "l2_norm", 32, sms)
    np.testing.assert_array_equal(got_i, want_i.numpy())
    np.testing.assert_array_equal(got_v, want_v.numpy())


@pytest.mark.parametrize("similarity", SIMS)
def test_emulated_list_scan_equals_reference_xla_pool(similarity):
    """The emulation against the JAX reference's XLA pool on the same numpy
    inputs: ids equal; scores to rtol 1e-6 (XLA may fuse the transform's
    operations, which the port and the kernel round one at a time)."""
    v, norms, valid, q = _case(1, 5)
    qj = jnp.asarray(q)
    jv, ji = pallas_knn._fused_xla_pool(
        jnp.asarray(v[0]), jnp.asarray(norms[0]), jnp.asarray(valid[0]), qj,
        jnp.sum(qj * qj, axis=1, keepdims=True), jnp.ones((1,), jnp.float32),
        r=10, similarity=similarity, score_precision="fp32")
    got_v, got_i, _passers = _emulated_pool(1, 5, 10, similarity, 8, sms=4)
    np.testing.assert_array_equal(got_i[0], np.asarray(ji))
    np.testing.assert_allclose(got_v[0], np.asarray(jv), rtol=1e-6, atol=0)


# --------------------------------------------------------------------------
# the wrapper's choices on the CPU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("s,n,n_qt,sms", [
    (1, 1_000_000, 1, 132), (1, 200_000, 1, 132), (1, 262_144, 1, 132),
    (4, 5_000, 1, 132), (4, 8_192, 1, 132), (1, 300_001, 2, 132),
    (3, 1_000, 1, 132), (200, 10_000, 1, 132), (1, 5, 1, 132),
    (2, 129, 3, 7)])
def test_ranges_cover_each_shard_once(s, n, n_qt, sms):
    """Ranges are whole sub-blocks but the last, cover [0, n) once, and the
    grid is never more than one wave of one CTA an SM (one range a shard
    when the shards and query tiles alone fill the card)."""
    chunk, n_split = knn_fused.list_geometry(s, n, n_qt, sms)
    assert chunk % SUB == 0 and chunk >= SUB
    starts = [i * chunk for i in range(n_split)]
    ends = [min(n, a + chunk) for a in starts]
    assert starts[0] == 0 and ends[-1] == n
    assert all(e == a for e, a in zip(ends, starts[1:]))
    assert all(a < e for a, e in zip(starts, ends))
    assert n_split * s * n_qt <= max(sms, s * n_qt)


def test_serving_shapes_fill_the_card():
    """Cell A's stacked step (one shard of 2^18 slots, B = 1) runs 128
    ranges of 2,048 docs on 132 SMs; the SIFT-1M shape 131 ranges of 7,680
    docs; 200,000 docs 131 ranges of 1,536, where 2,048-doc blocks would
    be 98 units and leave 34 SMs idle."""
    assert knn_fused.list_geometry(1, 1 << 18, 1, 132) == (2048, 128)
    assert knn_fused.list_geometry(1, 1_000_000, 1, 132) == (7680, 131)
    assert knn_fused.list_geometry(1, 200_000, 1, 132) == (1536, 131)


@pytest.mark.parametrize("precision,r,want", [
    ("fp32", 1, "lists"), ("fp32", 10, "lists"), ("fp32", 32, "lists"),
    ("fp32", 33, "wide"), ("fp32", 128, "wide"), ("bf16", 10, "mma"),
    ("bf16", 40, "mma"), ("int8", 32, "mma"), ("int8", 512, "mma"),
    ("fp32", 100, "wide"), ("fp32", 1024, "wide"), ("fp32", 1025, "large"),
    ("fp32", 4096, "large"), ("bf16", 400, "mma"), ("int8", 40, "mma"),
    ("int8", 400, "mma")])
def test_k1_design_is_chosen_by_precision_and_r(precision, r, want):
    assert knn_fused.scan_tier(precision, r) == want


@pytest.mark.parametrize("k,want", [(1, "lists"), (10, "lists"),
                                    (32, "lists"), (33, "wide"),
                                    (1024, "wide"), (64, "wide"),
                                    (100, "wide"), (128, "wide"),
                                    (256, "wide")])
def test_k3_design_is_chosen_by_k(k, want):
    assert knn_blocks.block_tier(k) == want


def _smem(qt, stages, d, r):
    """csrc/knn_pool.cuh scan_smem_bytes: the ring, the query tile (d cut
    into whole chunks), |q|^2, |q| and the bound a query, the warps'
    lists."""
    threads = 512 if qt >= 32 else 256
    stage = 16384 if qt <= 32 else 8192
    dc = stage // (threads // 32 // (qt // 8) * SUB)
    dp = -(-d // dc) * dc
    return 4 * (stages * stage + qt * dp + 3 * qt + 2 * threads // 32 * 8 * r)


@pytest.mark.parametrize("b,d,r,want", [
    (1, 128, 10, (8, 3)), (8, 128, 32, (8, 3)), (9, 128, 10, (32, 3)),
    (32, 128, 10, (32, 3)), (32, 128, 32, (8, 3)), (33, 128, 10, (128, 4)),
    (129, 128, 32, (128, 4)), (129, 768, 10, (8, 3)),
    (1, 768, 32, (8, 2)), (129, 32, 1, (128, 4))])
def test_plan_fits_the_shared_memory(b, d, r, want):
    """The query tile of the batch, stepped down until its shared memory
    fits 232,448 bytes; the two-stage ring at 8 queries for rows too wide
    for three."""
    assert knn_fused.list_plan(b, d, r, _smem) == want
    assert _smem(*want, d, r) <= knn_fused._MAX_SMEM


def test_grid_limits_raise():
    """More shards than a grid's y dimension takes (65,535) raise before
    anything is planned on the card: in K1's operand check and in the list
    scan's own."""
    s = knn_fused._MAX_GRID + 1
    v, norms = torch.zeros((s, 1, 4)), torch.zeros((s, 1))
    valid, q = torch.ones((s, 1), dtype=torch.bool), torch.zeros((1, 4))
    qsq = torch.zeros(1)
    with pytest.raises(ValueError, match="grid too large"):
        knn_fused._check_kernel_operands(v, norms, valid, q, qsq,
                                         torch.ones(s), 1, "l2_norm", "fp32")
    with pytest.raises(ValueError, match="grid too large"):
        knn_fused.launch_lists(None, _smem, v, norms, valid, q, qsq, r=1,
                               similarity="l2_norm")


def test_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        knn_fused.list_plan(1, 20_000, 10, _smem)


@pytest.mark.parametrize("b,want", [(1, 8), (8, 8), (9, 32), (32, 32),
                                    (33, 128), (129, 128)])
def test_query_tile_follows_the_batch(b, want):
    assert knn_fused.query_tile(b) == want


def test_cpu_tensors_never_launch():
    """K1's wrapper, its stacked and policy entry points, and K3's take the
    plain versions on CPU tensors and count no launch of either design."""
    v, norms, valid, q = (torch.from_numpy(a) for a in _case(1, 3))
    counters = (knn_fused.launches, knn_fused.list_launches,
                knn_blocks.block_launches, knn_blocks.block_list_launches)
    before = [c.count for c in counters]
    qsq = (q * q).sum(1)
    got = knn_fused.pool_scan(v, norms, valid, q, qsq, torch.ones(1), r=10,
                              similarity="l2_norm", score_precision="fp32")
    want = _plain(1, 3, 10, "l2_norm")
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    knn_fused.knn_fused_stacked(v, norms, valid, q, k=10)
    knn_fused.knn_fused_auto(v[0], norms[0], valid[0], q, k=10)
    knn_blocks.knn_topk_auto(v[0], norms[0], valid[0], q, k=10)
    assert [c.count for c in counters] == before
