"""K5 of the port (opensearch_tpu_torch/ops/knn_blocks.py ``knn_sbmax_auto``:
sub-block maxima, then the selection and rescore) against the JAX reference
(opensearch_tpu/ops/pallas_knn.py ``knn_sbmax_auto``, its Pallas kernel in
interpret mode), on the CPU, where the port takes its plain versions.

The same numpy inputs go through both. Ids must be equal; scores agree to
rtol 1e-5 with atol 2e-5 for l2 (``|q|^2 - 2 q.v + |v|^2`` cancels near a
neighbour and the two frameworks sum the d products in another order) and
1e-6 for cosine and dot. The batch sizes cover each of the kernel's query
tiles (8, 32, 128), full and partial, and B past one 128-query tile.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them bit for
bit against the plain versions). Their selection rule is emulated here in
numpy, step for step as the stage-2 kernel takes it (four 8-bit radix
passes over order-preserving keys, an ordered compaction, a rank count),
and held against the plain version's stable top-k and sort.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from opensearch_tpu.ops import pallas_knn
from opensearch_tpu_torch.ops import knn_blocks
from opensearch_tpu_torch.ops.topk import stable_topk

N_DOCS = 2 * 2048 + 100      # three 2048-doc blocks, the last ragged
N_SUB = 3 * 16               # their 128-doc sub-blocks
DIM = 16
COPIES = (100, 700, 2100, 2500, 4150)  # one vector in five sub-blocks, three blocks
DEAD_SUB = range(2048 + 128, 2048 + 256)  # an all-dead sub-block


def _atol(similarity: str) -> float:
    return 2e-5 if similarity == "l2_norm" else 1e-6


@functools.lru_cache(maxsize=None)
def _case(b: int):
    """Numpy operands: ragged n, 3% dead docs, one all-dead sub-block, one
    vector planted in five sub-blocks of three blocks, and b queries of
    which the first is that vector."""
    rng = np.random.default_rng(500 + b)
    v = rng.standard_normal((N_DOCS, DIM)).astype(np.float32)
    v[list(COPIES)] = v[COPIES[0]]
    valid = rng.random(N_DOCS) >= 0.03
    valid[list(DEAD_SUB)] = False
    valid[list(COPIES)] = True
    q = rng.standard_normal((b, DIM)).astype(np.float32)
    q[0] = v[COPIES[0]]
    q[1::5] = v[rng.choice(np.nonzero(valid)[0], len(q[1::5]), replace=False)]
    norms = (v.astype(np.float64) ** 2).sum(1).astype(np.float32)
    return v, norms, valid, q


@functools.lru_cache(maxsize=None)
def _reference(b: int, k: int, similarity: str):
    vals, ids = pallas_knn.knn_sbmax_auto(
        *(jnp.asarray(a) for a in _case(b)), k=k, similarity=similarity)
    return np.asarray(vals), np.asarray(ids)


def _port(b: int, k: int, similarity: str):
    vals, ids = knn_blocks.knn_sbmax_auto(
        *(torch.from_numpy(a) for a in _case(b)), k=k, similarity=similarity)
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    return vals.numpy(), ids.numpy()


def _assert_match(b: int, k: int, similarity: str):
    jv, ji = _reference(b, k, similarity)
    tv, ti = _port(b, k, similarity)
    assert ti.shape == (b, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(np.isneginf(tv), np.isneginf(jv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=1e-5,
                               atol=_atol(similarity))
    return tv, ti


@pytest.mark.parametrize("b,similarity", [
    (1, "l2_norm"), (8, "cosine"), (9, "dot_product"), (33, "l2_norm"),
    (129, "l2_norm")])
def test_entry_point_matches_reference_at_each_query_tile(b, similarity):
    """B = 1 and 8 (tile 8), 9 (pads to 16, tile 32), 33 (pads to 40, tile
    128) and 129 (two 128-query tiles, the second nearly empty)."""
    _tv, ti = _assert_match(b, 10, similarity)
    # the planted vector: its copies first, lower ids first (a dot product
    # may rank a longer vector above them)
    if similarity != "dot_product":
        assert ti[0, :len(COPIES)].tolist() == list(COPIES)


@pytest.mark.parametrize("similarity", ("l2_norm", "cosine"))
def test_k_equal_to_the_sub_block_count(similarity):
    """k = n_sub takes every sub-block, the all-dead one and the ones past
    n included: the answer is the brute-force top-k."""
    tv, ti = _assert_match(9, N_SUB, similarity)
    n_valid = int(_case(9)[2].sum())
    assert N_SUB < n_valid and (ti >= 0).all()


def test_planted_maxima_ties_go_to_the_lower_sub_block():
    """Five sub-blocks share the top maximum; at k = 3 the selection keeps
    the three lowest, and the rescore's top 3 are their copies in id order.
    The all-dead sub-block reports -inf."""
    v, norms, valid, q = (torch.from_numpy(a) for a in _case(1))
    qp = knn_blocks._pad_queries(q, knn_blocks.PB_QTILE)
    submax = knn_blocks.plain_sbmax(v, norms, valid, qp,
                                    similarity="l2_norm")
    flat = submax.permute(1, 0, 2).reshape(qp.shape[0], -1)
    top = flat[0].max()
    assert [i for i in range(N_SUB) if flat[0, i] == top] == \
        sorted({c // 128 for c in COPIES})
    assert torch.isneginf(flat[:, DEAD_SUB.start // 128]).all()
    tv, ti = _assert_match(1, 3, "l2_norm")
    assert ti[0].tolist() == list(COPIES[:3])


@pytest.mark.parametrize("b,b_pad,qt", [
    (1, 8, 8), (8, 8, 8), (9, 16, 32), (32, 32, 32), (33, 40, 128),
    (128, 128, 128), (129, 256, 128), (300, 384, 128)])
def test_query_tile_follows_the_padded_batch(b, b_pad, qt):
    """Stage 1's query tile is the smallest of 8, 32 and 128 that holds the
    reference's padded batch, 128 above."""
    qp = knn_blocks._pad_queries(torch.ones((b, 4)), knn_blocks.PB_QTILE)
    assert qp.shape[0] == b_pad
    assert knn_blocks.sbmax_query_tile(b_pad) == qt


# --------------------------------------------------------------------------
# the stage-2 kernel's selection rule, emulated
# --------------------------------------------------------------------------


def _order_keys(x: np.ndarray) -> np.ndarray:
    """Order-preserving uint32 keys of f32 values, -0.0 folded to +0.0 (the
    kernel's order_key)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    neg = (u & 0x80000000) != 0
    return np.where(neg, ~u, u | 0x80000000).astype(np.uint32)


def _radix_select(keys: np.ndarray, k: int) -> tuple[int, int]:
    """(key of the k-th largest, how many equal to it a stable top-k takes)
    by four 8-bit passes, most significant first, as the kernel runs it."""
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


def _select_compact(x: np.ndarray, k: int) -> np.ndarray:
    """Indices, ascending, of every key above the threshold and the first
    `need` equal to it (the kernel's ordered compaction)."""
    keys = _order_keys(x)
    thr, need = _radix_select(keys, k)
    eq = keys == thr
    take = (keys > thr) | (eq & (np.cumsum(eq) - eq < need))
    out = np.nonzero(take)[0]
    assert len(out) == k
    return out


def _ranked(x: np.ndarray, picked: np.ndarray) -> np.ndarray:
    """`picked` ordered by (value desc, position asc): each one's rank
    counted against the others."""
    keys = _order_keys(x[picked])
    rank = [int(((keys > keys[i]) | ((keys == keys[i]) & (picked < picked[i])))
                .sum()) for i in range(len(picked))]
    out = np.empty_like(picked)
    out[rank] = picked
    return out


def _rows():
    rng = np.random.default_rng(7)
    ties = np.round(rng.random((3, 64)) * 4) / 4         # many equal values
    ties[0, [5, 17, 40]] = 2.0
    ties[1, ::3] = -np.inf
    zeros = np.tile(np.float32([0.0, -0.0, 0.5, -0.0, 0.0, -1.0]), 4)[None]
    return {"ties": ties.astype(np.float32),
            "all_minus_inf": np.full((2, 48), -np.inf, np.float32),
            "signed_zeros": zeros.astype(np.float32),
            "spread": rng.standard_normal((2, 300)).astype(np.float32)}


@pytest.mark.parametrize("k", [1, 3, 10, "n"])
@pytest.mark.parametrize("name", ["ties", "all_minus_inf", "signed_zeros",
                                  "spread"])
def test_threshold_compaction_equals_stable_topk_then_sort(name, k):
    x = _rows()[name]
    k = x.shape[1] if k == "n" else k
    _vals, pos = stable_topk(torch.from_numpy(x), k)
    want = torch.sort(pos, dim=1).values.numpy()
    for r in range(x.shape[0]):
        got = _select_compact(x[r], k)
        np.testing.assert_array_equal(got, want[r])
        # the winners' order is the stable top-k's own
        np.testing.assert_array_equal(_ranked(x[r], got), pos[r].numpy())


def _emulated_stage2(submax, v, norms, valid, q, k, similarity):
    """Stage 2 as the kernel computes it, in numpy over the plain scores."""
    nb, B, subs = submax.shape
    n = v.shape[0]
    flat = submax.permute(1, 0, 2).reshape(B, nb * subs).numpy()
    scores = knn_blocks._plain_scores(v, norms, valid, q,
                                      similarity=similarity, exact=True,
                                      n_pad=nb * 2048).numpy()
    vals = np.empty((B, k), np.float32)
    ids = np.empty((B, k), np.int32)
    for b in range(B):
        sel = _select_compact(flat[b], k)
        cand = (sel[:, None] * 128 + np.arange(128)[None]).reshape(-1)
        sc = np.where(cand < n, scores[b, np.minimum(cand, nb * 2048 - 1)],
                      -np.inf).astype(np.float32)
        win = _ranked(sc, _select_compact(sc, k))
        vals[b] = sc[win]
        ids[b] = np.where(np.isfinite(sc[win]), cand[win], -1)
    return vals, ids


@pytest.mark.parametrize("k", [3, 10, N_SUB])
def test_emulated_stage2_equals_the_plain_rescore(k):
    """The kernel's rule end to end (the planted ties, the dead sub-block,
    pad rows, k = n_sub) gives the plain stage 2's values and ids. The
    operands are sixteenths, so every dot is exact in f32 whichever order
    the plain scores and the plain rescore sum it in."""
    v, norms, valid, q = (torch.from_numpy(a) for a in _case(9))
    v, q = torch.round(v * 16) / 16, torch.round(q * 16) / 16
    norms = (v.double() ** 2).sum(1).float()
    qp = knn_blocks._pad_queries(q, knn_blocks.PB_QTILE)
    submax = knn_blocks.plain_sbmax(v, norms, valid, qp,
                                    similarity="l2_norm")
    pv, pi = knn_blocks.sbmax_rescore(submax, v, norms, valid, qp, k=k,
                                      similarity="l2_norm")
    ev, ei = _emulated_stage2(submax, v, norms, valid, qp, k, "l2_norm")
    np.testing.assert_array_equal(ei, pi.numpy())
    np.testing.assert_array_equal(ev, pv.numpy())


def test_cpu_stages_take_the_plain_versions():
    """On CPU tensors both stages run the plain versions and launch
    nothing."""
    v, norms, valid, q = (torch.from_numpy(a) for a in _case(8))
    before = (knn_blocks.sbmax_launches.count,
              knn_blocks.sbmax_select_launches.count)
    sm = knn_blocks.sbmax(v, norms, valid, q)
    assert torch.equal(sm, knn_blocks.plain_sbmax(v, norms, valid, q,
                                                  similarity="l2_norm"))
    got = knn_blocks.sbmax_select(sm, v, norms, valid, q, k=5)
    want = knn_blocks.sbmax_rescore(sm, v, norms, valid, q, k=5,
                                    similarity="l2_norm")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (knn_blocks.sbmax_launches.count,
            knn_blocks.sbmax_select_launches.count) == before


def test_odd_width_pads_without_changing_the_answer():
    """The stage kernels read rows in 16-byte units: rows_in_16_bytes pads
    d = 30 to 32 with zero columns (norms and |q|^2 stay the unpadded
    ones). On the CPU both plain stages give the same bits on the padded
    operands, at exact and not."""
    rng = np.random.default_rng(30)
    v = torch.from_numpy(np.round(rng.standard_normal((N_DOCS, 30)) * 16)
                         .astype(np.float32) / 16)
    q = knn_blocks._pad_queries(v[:9] + 0.25, knn_blocks.PB_QTILE)
    norms = (v.double() ** 2).sum(1).float()
    valid = torch.from_numpy(_case(9)[2])
    pv, pq = knn_blocks.rows_in_16_bytes(v, q)
    assert pv.shape[1] == pq.shape[1] == 32
    for sim in ("l2_norm", "cosine", "dot_product"):
        for exact in (True, False):
            sm = knn_blocks.plain_sbmax(v, norms, valid, q, similarity=sim,
                                        exact=exact)
            assert torch.equal(sm, knn_blocks.plain_sbmax(
                pv, norms, valid, pq, similarity=sim, exact=exact))
            want = knn_blocks.sbmax_rescore(sm, v, norms, valid, q, k=10,
                                            similarity=sim, exact=exact)
            got = knn_blocks.sbmax_rescore(sm, pv, norms, valid, pq, k=10,
                                           similarity=sim, exact=exact)
            assert all(torch.equal(a, w) for a, w in zip(got, want))
