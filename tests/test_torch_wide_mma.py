"""The wide tier's tensor-core scan, K1 at bf16 and int8
(opensearch_tpu_torch/csrc/knn_wide_mma.cuh), on the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it bit for
bit against ``plain_pool``). Its rule is the wide tier's
(tests/test_torch_wide.py, whose numpy emulation this file reuses) on other
dots: each shard cut into contiguous ranges at 128-doc multiples by the
wrapper's geometry for 8-query tiles; in each range, per query, steps of
1,024 docs; the conservative pre-transform filter, loose by 2^-12; the
appends to a buffer of the plan's capacity, the flushes by the radix
select over 64-bit keys and the split merge. The dots are the tensor
cores': bf16 operands with f32 accumulation, exact on sixteenths (every
product and partial sum is a multiple of 2^-8 far inside f32's 24 bits),
and int8 operands summed exactly in int32, then times the shard's scale in
f32. The emulation must equal ``ops/knn_fused.plain_pool`` bit for bit at
r = 32, 40, 400 and 512, one and four shards (the last with fewer live
docs than r), the three similarities, planted duplicates and dead docs;
and, in one case each at bf16 and int8, the JAX reference's
``_fused_xla_pool`` and ``pallas_knn_fused`` (in interpret mode, as
tests/test_pallas_knn.py runs it) on the same numpy inputs.

Then the kernel's own layout, in numpy: the m16n8 accumulator regrouped by
quad shuffles gives each lane 4 docs x 8 queries, each doc of the warp's
sub-block once; the ldmatrix and fragment reads fall in distinct banks. Then the wrapper: the design chosen by
(precision, r), its plan fits the card's shared memory at d up to 768 and
r up to 1024 or raises, the rows it copies into whole 16-byte units add
exact zeros, and a CPU tensor never loads the library.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from opensearch_tpu.ops import pallas_knn
from opensearch_tpu_torch.ops import cuda_lib, knn_fused
from test_torch_wide import (COPIES, N_DOCS, QT, RUN, SIMS, STEP, _case,
                             _emulated_merge, _emulated_range)

F32 = np.float32
PRECISIONS = ("bf16", "int8")


def _operands(s: int, b: int, prec: str):
    """_case(s, b) (sixteenths, 3% dead docs, planted copies) as torch
    tensors with the operands prepped as knn_fused_stacked preps them:
    (v, norms, valid, q, qsq, v_x, q_x, scale)."""
    v, norms, valid, q = (torch.from_numpy(a) for a in _case(s, b))
    v_x, q_x, scale = knn_fused._prep_operands(v, q, prec)
    return v, norms, valid, q, (q * q).sum(1), v_x, q_x, scale


def _tensor_core_dots(q_x, v_x, scale, prec: str) -> np.ndarray:
    """One shard's [B, n] dots as the tensor cores give them: int8 summed
    exactly in int32, then __int2float_rn and one f32 multiply by the
    scale; bf16 products summed in f32, exact here (every partial sum of
    sixteenths of this size is a multiple of 2^-8 below 2^12), so taken in
    f64 and rounded once."""
    exact = q_x.double() @ v_x.double().T
    if prec == "int8":
        ints = exact.to(torch.int64)
        assert bool((ints.abs() < 2 ** 31).all())
        return (ints.to(torch.int32).to(torch.float32) * scale).numpy()
    assert bool((exact.abs() < 2 ** 12).all())
    assert torch.equal(exact, (exact * 256).round() / 256)
    return exact.to(torch.float32).numpy()


def _emulated_mma_pool(s, b, r, similarity, prec, sms, cap):
    """The tensor-core tier's (vals [S, B, r], ids [S, B, r], stats) on
    _case(s, b): the wrapper's ranges for 8-query tiles, each range's
    sorted pools on the tensor cores' dots, then the split merge."""
    (_v, norms, valid, _q, qsq, v_x, q_x, scale) = _operands(s, b, prec)
    chunk, n_split = knn_fused.list_geometry(s, N_DOCS, -(-b // QT), sms)
    out_v = np.empty((s, b, r), F32)
    out_i = np.empty((s, b, r), np.int32)
    stats = {"passers": 0, "flushes": 0, "ranges": n_split,
             "merge_from_device": False}
    for shard in range(s):
        dots = _tensor_core_dots(q_x, v_x[shard], scale[shard], prec)
        scores = knn_fused._transform_scores(
            torch.from_numpy(dots), qsq[:, None], norms[shard][None],
            similarity).numpy()
        for qi in range(b):
            pools = [_emulated_range(
                dots[qi], scores[qi], norms[shard].numpy(),
                valid[shard].numpy(), qsq[qi].numpy(), split * chunk,
                min(N_DOCS, (split + 1) * chunk), r, similarity, cap, stats)
                for split in range(n_split)]
            for j, (sv, si) in enumerate(_emulated_merge(pools, r, stats)):
                out_v[shard, qi, j] = sv
                out_i[shard, qi, j] = si
    return out_v, out_i, stats


def _plain(s, b, r, similarity, prec):
    (_v, norms, valid, _q, qsq, v_x, q_x, scale) = _operands(s, b, prec)
    return knn_fused.plain_pool(v_x, norms, valid, q_x, qsq, scale, r=r,
                                similarity=similarity, score_precision=prec)


def _assert_plain(got_v, got_i, s, b, r, similarity, prec):
    want_v, want_i = _plain(s, b, r, similarity, prec)
    np.testing.assert_array_equal(got_i, want_i.numpy())
    np.testing.assert_array_equal(got_v.view(np.uint32),
                                  want_v.numpy().view(np.uint32))


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("s", (1, 4))
@pytest.mark.parametrize("r", (32, 40, 400, 512))
@pytest.mark.parametrize("similarity", SIMS)
def test_emulated_mma_tier_equals_plain_pool(similarity, r, s, prec):
    """Two ranges a shard of two steps each (1,024 + 512 docs), a buffer of
    one step: plain_pool's pools bit for bit at the reduced precision, the
    planted copies in id order across the range edge, the run of 40 equal
    vectors in id order, the dead docs out, (-inf, -1) past the live count
    of the sparse shard; the filter lets through fewer docs than it sees
    once a pool can fill."""
    b = 3
    got_v, got_i, stats = _emulated_mma_pool(s, b, r, similarity, prec,
                                             sms=2 * s, cap=STEP)
    _assert_plain(got_v, got_i, s, b, r, similarity, prec)
    if similarity != "dot_product":
        assert got_i[0, 0, :2].tolist() == list(COPIES)
        run = min(r, len(RUN))
        assert got_i[0, 1, :run].tolist() == list(RUN[:run])
    if s == 4:
        assert (got_i[3, :, 5:] == -1).all() and (
            got_v[3, :, 5:] == -np.inf).all()
    if r <= 40:
        assert stats["passers"] < 0.8 * s * b * N_DOCS


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("sms,ranges,r,cap", [
    (2, 1, 40, STEP), (6, 3, 400, 2 * STEP), (132, 24, 512, STEP)])
def test_emulated_mma_tier_at_other_cuts(sms, ranges, r, cap, prec):
    """Nine queries (two 8-query tiles) over one range a shard, three, and
    one a sub-block (the card's 132 SMs over 3,000 docs: ranges of 128
    docs, each shorter than r): the cut and the buffer change the passers
    and the flushes, never the pools."""
    got_v, got_i, stats = _emulated_mma_pool(1, 9, r, "l2_norm", prec, sms,
                                             cap)
    _assert_plain(got_v, got_i, 1, 9, r, "l2_norm", prec)
    assert stats["ranges"] == ranges
    assert stats["flushes"] >= 9 * ranges


def _reference_pools(prec: str, r: int, similarity: str):
    """The JAX reference's pools of _case(1, 8) at `prec`: its own operand
    prep on the rows padded to whole 1,024-doc blocks (dead), then
    (_fused_xla_pool, pallas_knn_fused in interpret mode), and the port's
    prepped operands, which must be the reference's bits."""
    v, norms, valid, q = _case(1, 8)
    pad = -N_DOCS % pallas_knn.FK_BLOCK
    vj = jnp.pad(jnp.asarray(v[0]), ((0, pad), (0, 0)))
    nj = jnp.pad(jnp.asarray(norms[0]), (0, pad))
    okj = jnp.pad(jnp.asarray(valid[0]), (0, pad))
    qj = jnp.asarray(q)
    qsq = jnp.sum(qj * qj, axis=1, keepdims=True)
    v_x, q_x, scale = pallas_knn._prep_operands(vj, qj, prec)
    (_v, _n, _ok, _q, _qsq, pv_x, pq_x, pscale) = _operands(1, 8, prec)
    view = np.int8 if prec == "int8" else np.uint16
    np.testing.assert_array_equal(
        np.asarray(v_x[:N_DOCS]).view(view),
        pv_x[0].view(torch.int16 if prec == "bf16" else torch.int8)
        .numpy().view(view))
    np.testing.assert_array_equal(
        np.asarray(q_x).view(view),
        pq_x.view(torch.int16 if prec == "bf16" else torch.int8)
        .numpy().view(view))
    assert np.float32(scale) == pscale.numpy()[0]
    xla = pallas_knn._fused_xla_pool(v_x, nj, okj, q_x, qsq, scale, r=r,
                                     similarity=similarity,
                                     score_precision=prec)
    kernel = pallas_knn.pallas_knn_fused(v_x, nj, okj, q_x, qsq, scale, r=r,
                                         similarity=similarity,
                                         score_precision=prec,
                                         interpret=True)
    return xla, kernel


@pytest.mark.parametrize("prec,similarity", [("bf16", "l2_norm"),
                                             ("int8", "cosine")])
def test_emulated_mma_tier_equals_reference(prec, similarity):
    """The emulation against the JAX reference at r = 40 (k = 10 at a
    reduced precision) on the same numpy inputs: the XLA pool and the
    Pallas kernel, run in interpret mode. Ids equal; scores to rtol 1e-6
    (XLA may fuse the transform's operations, which the port and the
    kernel round one at a time)."""
    got_v, got_i, _stats = _emulated_mma_pool(1, 8, 40, similarity, prec,
                                              sms=2, cap=STEP)
    for jv, ji in _reference_pools(prec, 40, similarity):
        np.testing.assert_array_equal(got_i[0], np.asarray(ji))
        np.testing.assert_allclose(got_v[0], np.asarray(jv), rtol=1e-6,
                                   atol=0)


# --------------------------------------------------------------------------
# the kernel's layout, in numpy
# --------------------------------------------------------------------------

LANES = np.arange(32)


def _accumulator():
    """The m16n8 accumulators of a warp's eight m16 tiles, as (doc, query)
    labels: lane l's value e of tile j is doc 16 j + l / 4 + 8 (e >= 2),
    query 2 (l % 4) + e % 2 (the PTX fragment layout of D). Shape
    [32 lanes, 8 tiles, 4 values, 2]."""
    g, t = LANES >> 2, LANES & 3
    out = np.empty((32, 8, 4, 2), np.int64)
    for j in range(8):
        for e in range(4):
            out[:, j, e, 0] = 16 * j + g + 8 * (e >> 1)
            out[:, j, e, 1] = 2 * t + (e & 1)
    return out


def _shfl_xor(x, mask):
    return x[LANES ^ mask]


def _quad_transpose(v):
    """knn_wide_mma.cuh quad_transpose over the warp: v [32 lanes, 4, ...]."""
    t = LANES & 3
    v = v.copy()
    for o in range(2):
        send = np.where(((t & 2) != 0)[:, None], v[:, o], v[:, o + 2])
        got = _shfl_xor(send, 2)
        v[:, o] = np.where(((t & 2) != 0)[:, None], got, v[:, o])
        v[:, o + 2] = np.where(((t & 2) != 0)[:, None], v[:, o + 2], got)
    for b in range(2):
        send = np.where(((t & 1) != 0)[:, None], v[:, 2 * b], v[:, 2 * b + 1])
        got = _shfl_xor(send, 1)
        v[:, 2 * b] = np.where(((t & 1) != 0)[:, None], got, v[:, 2 * b])
        v[:, 2 * b + 1] = np.where(((t & 1) != 0)[:, None], v[:, 2 * b + 1],
                                   got)
    return v


def _doc_of(lane, i):
    """knn_wide_mma.cuh doc_of."""
    return 16 * ((lane & 3) + 4 * (i >> 1)) + (lane >> 2) + 8 * (i & 1)


def test_quad_regroup_gives_each_lane_four_docs_by_eight_queries():
    """regroup's quad shuffles: afterwards lane l's acc[i][u] is doc
    doc_of(l, i) against query u, and the warp's 32 x 4 docs are its
    sub-block's 128, each once."""
    f = _accumulator()
    acc = np.empty((32, 4, 8, 2), np.int64)
    for jj in range(2):
        for e in range(4):
            x = _quad_transpose(f[:, 4 * jj:4 * jj + 4, e])
            for s in range(4):
                acc[:, 2 * jj + (e >> 1), 2 * s + (e & 1)] = x[:, s]
    for lane in range(32):
        for i in range(4):
            assert (acc[lane, i, :, 0] == _doc_of(lane, i)).all()
            assert acc[lane, i, :, 1].tolist() == list(range(8))
    docs = sorted(_doc_of(lane, i) for lane in range(32)
                  for i in range(4))
    assert docs == list(range(128))


def _swizzle(row: int, kdc: int) -> int:
    """pool::Ring::swizzle for a row of kdc 32-bit words."""
    ku = kdc // 4
    rpl = 1 if ku >= 8 else 8 // ku
    return (row // rpl) & ((8 if ku >= 8 else ku) - 1)


@pytest.mark.parametrize("kdc", (8, 16, 32))
def test_ldmatrix_reads_of_the_ring_meet_no_bank_twice(kdc):
    """The A fragments: each of an ldmatrix.x4's four 8-row matrices (8
    lanes' 16-byte rows) covers the 32 banks once at every m16 tile and
    k-step of a stage, for the rings' d chunks of 8, 16 and 32 words; and
    the swizzle of a lane's row is the same at every tile, as the kernel
    assumes."""
    for warp in (0, 5):
        for lane in range(32):
            arow = warp * 128 + (lane & 7) + 8 * ((lane >> 3) & 1)
            assert all(_swizzle(arow + 16 * j, kdc) == _swizzle(arow, kdc)
                       for j in range(8))
        for j in range(8):
            for ks in range(kdc // 8):
                words = []
                for lane in range(32):
                    arow = warp * 128 + (lane & 7) + 8 * ((lane >> 3) & 1)
                    unit = (2 * ks + (lane >> 4)) ^ _swizzle(arow, kdc)
                    words.append((arow + 16 * j) * kdc + 4 * unit)
                for m in range(4):
                    banks = {(w + k) % 32 for w in words[8 * m:8 * m + 8]
                             for k in range(4)}
                    assert len(banks) == 32


@pytest.mark.parametrize("stage_words,w", [(16384, 64), (16384, 32),
                                           (8192, 384), (16384, 4),
                                           (8192, 12)])
def test_fragment_reads_of_the_query_tile_meet_no_bank_twice(stage_words,
                                                             w):
    """The B fragments: lane (g, t) reads word t of each 16-byte half of a
    k-step of query g; the tile's rows, padded by 16 bytes past whole d
    chunks, put the 32 lanes' words in 32 banks."""
    kdc = stage_words // STEP
    qw = -(-w // kdc) * kdc + 4
    for half in (0, 4):
        banks = {((lane >> 2) * qw + half + (lane & 3)) % 32
                 for lane in range(32)}
        assert len(banks) == 32


# --------------------------------------------------------------------------
# the wrapper on the CPU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("precision,r,want", [
    ("bf16", 32, "mma"), ("bf16", 40, "mma"), ("bf16", 400, "mma"),
    ("bf16", 512, "mma"), ("bf16", 1024, "mma"), ("int8", 1, "mma"),
    ("int8", 40, "mma"), ("int8", 512, "mma"), ("int8", 1024, "mma"),
    ("bf16", 1025, "large_mma"), ("int8", 4096, "large_mma"),
    ("fp32", 32, "lists"),
    ("fp32", 40, "wide"), ("fp32", 1024, "wide"), ("fp32", 1025, "large")])
def test_tier_by_precision_and_r(precision, r, want):
    assert knn_fused.scan_tier(precision, r) == want


@pytest.mark.parametrize("k,prec", [(k, p) for k in (1, 8, 10, 100, 128)
                                    for p in PRECISIONS])
def test_every_reduced_serving_pool_takes_the_mma_tier(k, prec):
    """R = max(k, min(max(4k, 32), 512)) at every k the serving routes
    take (k <= FUSED_MAX_K = 128) lies in the tier's 32 <= r <= 512."""
    r = knn_fused.fused_pool_width(k, prec)
    assert 32 <= r <= 512
    assert knn_fused.scan_tier(prec, r) == "mma"


def _mma_smem(prec, stages, words, d, r, rows, cap):
    """csrc/knn_wide_mma.cuh mma_smem_bytes: the ring, the 8-query tile of
    rows of d prec elements in 32-bit words (whole d chunks plus 16
    bytes), eight words a warp of select scratch, five words a query, a
    256-bin histogram a warp, and rows queries' pools of r and buffers of
    cap pairs; 0 for a ring or a precision with no kernel."""
    eb = {knn_fused._PREC_CODE["bf16"]: 2,
          knn_fused._PREC_CODE["int8"]: 1}.get(prec)
    if eb is None or (stages, words) not in knn_fused.WIDE_RINGS:
        return 0
    w = -(-d * eb // 4)
    dc = words // STEP
    qw = -(-w // dc) * dc + 4
    return 4 * (stages * words + QT * qw + 8 * 8 + 5 * QT + 8 * 256
                + 2 * rows * (r + cap))


@pytest.mark.parametrize("b,d,r,prec,want", [
    (1, 128, 40, "bf16", (3, 16384, 3072)),
    (1, 128, 400, "int8", (3, 16384, 2816)),
    (1, 128, 512, "bf16", (3, 16384, 2560)),
    (8, 128, 40, "bf16", (2, 16384, 1280)),
    (8, 128, 512, "bf16", (2, 8192, 1920)),
    (8, 768, 512, "int8", (2, 8192, 1792)),
    (8, 128, 1024, "int8", (2, 8192, 1408)),
    (9, 768, 1024, "bf16", (2, 8192, 1152)),
    (1, 32, 32, "int8", (3, 16384, 3200))])
def test_wide_mma_plan_fits_the_shared_memory(b, d, r, prec, want):
    """The first ring beside which min(8, b) queries' pools and buffers of
    at least one step fit 232,448 bytes, the buffer as large as the rest
    allows in whole 128s, up to 4,096."""
    plan = knn_fused.wide_mma_plan(b, d, r, prec, _mma_smem)
    assert plan == want
    stages, words, cap = plan
    rows = min(QT, b)
    code = knn_fused._PREC_CODE[prec]
    assert cap >= STEP and cap % 128 == 0
    assert _mma_smem(code, stages, words, d, r, rows, cap) \
        <= knn_fused._MAX_SMEM
    assert cap == knn_fused.WIDE_MAX_CAP or _mma_smem(
        code, stages, words, d, r, rows, cap + 128) > knn_fused._MAX_SMEM


@pytest.mark.parametrize("prec", PRECISIONS)
@pytest.mark.parametrize("d", (30, 100, 128, 768))
@pytest.mark.parametrize("r", (32, 40, 400, 512, 1024))
@pytest.mark.parametrize("b", (1, 8, 129))
def test_wide_mma_plan_takes_every_supported_shape(b, r, d, prec):
    """r up to 1024 and d up to 768 (as the wrapper pads it to whole
    16-byte rows) always have a plan."""
    dp = d + -d % (16 // {"bf16": 2, "int8": 1}[prec])
    stages, words, cap = knn_fused.wide_mma_plan(b, dp, r, prec, _mma_smem)
    assert _mma_smem(knn_fused._PREC_CODE[prec], stages, words, dp, r,
                     min(QT, b), cap) <= knn_fused._MAX_SMEM


def test_wide_mma_plan_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        knn_fused.wide_mma_plan(8, 16384, 1024, "bf16", _mma_smem)
    with pytest.raises(ValueError, match="shared memory"):
        knn_fused.wide_mma_plan(8, 128, 1024, "fp32", _mma_smem)


@pytest.mark.parametrize("prec,d,want", [
    ("bf16", 30, 32), ("bf16", 100, 104), ("bf16", 128, 128),
    ("int8", 30, 32), ("int8", 100, 112), ("int8", 768, 768)])
def test_rows_are_copied_into_whole_16_byte_units(prec, d, want):
    """rows_in_16_bytes pads bf16 rows to a multiple of 8 and int8 rows to
    a multiple of 16 with zero columns, and plain_pool on the padded
    operands is plain_pool on the rows as given, bit for bit: a zero
    column adds an exact zero to every dot. Whole rows at an aligned
    address are not copied."""
    rng = np.random.default_rng(d)
    v = torch.from_numpy((np.round(rng.standard_normal((2, 300, d)) * 16)
                          / 16).astype(F32))
    q = v[0, :5] + 0.25
    v_x, q_x, scale = knn_fused._prep_operands(v, q, prec)
    pv, pq = knn_fused.rows_in_16_bytes(v_x, q_x)
    assert pv.shape[-1] == pq.shape[-1] == want
    assert pv.dtype == v_x.dtype and pq.dtype == q_x.dtype
    assert pv.shape[-1] * pv.element_size() % 16 == 0
    if want == d:
        assert pv.data_ptr() == v_x.data_ptr()
    else:
        assert not pv[..., d:].any() and not pq[..., d:].any()
    norms = (v.double() ** 2).sum(2).float()
    valid = torch.ones((2, 300), dtype=torch.bool)
    qsq = (q * q).sum(1)
    for sim in SIMS:
        a = knn_fused.plain_pool(v_x, norms, valid, q_x, qsq, scale, r=40,
                                 similarity=sim, score_precision=prec)
        z = knn_fused.plain_pool(pv, norms, valid, pq, qsq, scale, r=40,
                                 similarity=sim, score_precision=prec)
        assert all(torch.equal(x, y) for x, y in zip(a, z))


def test_unaligned_rows_are_copied_to_an_aligned_address():
    """A view 2 bytes past a 16-byte boundary is copied; the copy holds the
    same values at an aligned address."""
    flat = torch.zeros(8 * 16 + 1, dtype=torch.bfloat16)
    view = flat[1:].view(8, 16)
    view.copy_(torch.arange(128, dtype=torch.float32).view(8, 16))
    assert view.data_ptr() % 16 != 0
    pv, pq = knn_fused.rows_in_16_bytes(view[None], view[:2])
    assert pv.data_ptr() % 16 == 0 and pq.data_ptr() % 16 == 0
    assert torch.equal(pv[0], view) and torch.equal(pq, view[:2])


def test_cpu_tensors_never_load_the_library():
    """K1's wrapper at bf16 and int8, r = 32, 40 and 512, and its stacked
    entry point at k = 10 and 100, take the plain versions on CPU tensors:
    the answers are plain_pool's, no launch of any design is counted, and
    no kernel library is built or loaded."""
    counters = (knn_fused.launches, knn_fused.list_launches,
                knn_fused.wide_launches, knn_fused.mma_launches)
    before = [c.count for c in counters]
    for prec in PRECISIONS:
        (v, norms, valid, q, qsq, v_x, q_x, scale) = _operands(1, 3, prec)
        for r in (32, 40, 512):
            got = knn_fused.pool_scan(v_x, norms, valid, q_x, qsq, scale,
                                      r=r, similarity="l2_norm",
                                      score_precision=prec)
            want = _plain(1, 3, r, "l2_norm", prec)
            assert all(torch.equal(a, w) for a, w in zip(got, want))
        for k in (10, 100):
            knn_fused.knn_fused_stacked(v, norms, valid, q, k=k,
                                        score_precision=prec)
    assert [c.count for c in counters] == before
    assert "knn_fused" not in cuda_lib._libs
