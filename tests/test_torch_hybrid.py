"""The hybrid BM25 + exact-kNN program (opensearch_tpu_torch/ops/fused.py
``hybrid_score_topk``, ``jit_hybrid``, ``lexical_scores``) and the port's
graft entry (opensearch_tpu_torch/graft_entry.py) against the reference
(opensearch_tpu/ops/fused.py, __graft_entry__.py), on the CPU.

The same numpy inputs, made from a seed, go through both programs. Scores
must agree to rtol 1e-5 / atol 1e-6: the two frameworks sum the [B, d]
product and the BM25 contributions in their own orders, which moves a
score by a few ulps. Ids must be equal at every rank whose score is
further than that tolerance from its neighbours' (at a closer pair either
order is right); -inf slots (k above the live count) carry the same ids
too, as both top-k's give the same order to equal scores.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import __graft_entry__
from opensearch_tpu.ops import fused as jax_fused
from opensearch_tpu_torch import graft_entry
from opensearch_tpu_torch.ops import fused

RTOL, ATOL = 1e-5, 1e-6
SIMS = ("l2_norm", "cosine", "dot_product")


def _inputs(seed: int, *, n_pad=2048, d=32, p_pad=4096, Q=8, B=5,
            window=64, dead=0.0, bf16=False, empty_term=False,
            past_end=False):
    """Numpy arguments of hybrid_score_topk (the reference's order) and its
    avgdl and weights."""
    rng = np.random.default_rng(seed)
    postings_docs = rng.integers(0, n_pad, p_pad).astype(np.int32)
    postings_tfs = rng.integers(1, 5, p_pad).astype(np.float32)
    doc_len = rng.integers(5, 80, n_pad).astype(np.float32)
    vectors = rng.standard_normal((n_pad, d)).astype(np.float32)
    if bf16:
        # bf16-representable values, so both frameworks hold the same
        vectors = np.array(jnp.asarray(vectors, jnp.bfloat16)
                           .astype(jnp.float32))
    norms_sq = (vectors.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    valid = rng.random(n_pad) >= dead
    offsets = rng.integers(0, p_pad - window, Q).astype(np.int32)
    lengths = rng.integers(1, window + 1, Q).astype(np.int32)
    if empty_term:
        lengths[2] = 0
    if past_end:
        offsets[-1] = p_pad - window // 3
        lengths[-1] = window
    idfs = rng.uniform(0.5, 3.0, Q).astype(np.float32)
    queries = rng.standard_normal((B, d)).astype(np.float32)
    return [postings_docs, postings_tfs, doc_len, vectors, norms_sq, valid,
            offsets, lengths, idfs, np.float32(41.5), queries,
            np.float32(0.3), np.float32(1.0)]


def _reference(args, *, k, window, similarity, bf16=False):
    jargs = [jnp.asarray(a) for a in args]
    if bf16:
        jargs[3] = jargs[3].astype(jnp.bfloat16)
    v, i = jax_fused.hybrid_score_topk(*jargs, k=k, window=window,
                                       similarity=similarity)
    return np.asarray(v), np.asarray(i)


def _port(args, *, k, window, similarity, bf16=False):
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    if bf16:
        targs[3] = targs[3].to(torch.bfloat16)
    v, i = fused.jit_hybrid(k, window, similarity)(*targs)
    return v.numpy(), i.numpy()


def _assert_matches(got, want):
    """Scores to RTOL / ATOL; ids equal at every rank whose score stands
    further than the tolerance from both neighbours'."""
    gv, gi = got
    wv, wi = want
    np.testing.assert_array_equal(np.isfinite(gv), np.isfinite(wv))
    fin = np.isfinite(wv)
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(gi[~fin], wi[~fin])
    tol = ATOL + RTOL * np.abs(wv)
    close = np.zeros_like(fin)
    with np.errstate(invalid="ignore"):   # -inf - -inf past the live docs
        gap = np.abs(np.diff(wv, axis=1)) <= tol[:, 1:]
    close[:, 1:] |= gap
    close[:, :-1] |= gap
    sure = fin & ~close
    np.testing.assert_array_equal(gi[sure], wi[sure])
    assert sure.sum() >= 0.8 * fin.sum()


@pytest.mark.parametrize("similarity", SIMS)
def test_hybrid_matches_reference(similarity):
    args = _inputs(1)
    _assert_matches(_port(args, k=10, window=64, similarity=similarity),
                    _reference(args, k=10, window=64, similarity=similarity))


@pytest.mark.parametrize("similarity", SIMS)
def test_hybrid_bf16_vectors_match_reference(similarity):
    """bf16 vectors, cast to the queries' f32 before the product in both."""
    args = _inputs(2, bf16=True)
    _assert_matches(
        _port(args, k=10, window=64, similarity=similarity, bf16=True),
        _reference(args, k=10, window=64, similarity=similarity, bf16=True))


@pytest.mark.parametrize("similarity", ("l2_norm", "cosine"))
def test_hybrid_edges_match_reference(similarity):
    """A term with no postings, a window running past the postings' end
    (the index clamped to the last posting, as XLA's gather does), and a
    third of the docs dead."""
    args = _inputs(3, dead=0.33, empty_term=True, past_end=True)
    _assert_matches(_port(args, k=16, window=64, similarity=similarity),
                    _reference(args, k=16, window=64, similarity=similarity))


def test_hybrid_k_above_the_live_count():
    """Six live docs and k = 20: six finite slots, then -inf, ids as the
    reference's."""
    args = _inputs(4, n_pad=1024)
    valid = np.zeros(1024, bool)
    valid[[3, 99, 500, 501, 900, 1023]] = True
    args[5] = valid
    got = _port(args, k=20, window=64, similarity="l2_norm")
    _assert_matches(got, _reference(args, k=20, window=64,
                                    similarity="l2_norm"))
    assert np.isfinite(got[0]).sum(axis=1).tolist() == [6] * 5
    assert set(got[1][0, :6].tolist()) == {3, 99, 500, 501, 900, 1023}


@pytest.mark.parametrize("window", (16, 128))
def test_lexical_scores_match_a_float64_sum(window):
    """The BM25 sum alone against a float64 loop over the same postings:
    within the f32 rounding of each contribution and of the sums."""
    args = _inputs(5, window=window, empty_term=True, past_end=True)
    (pdocs, ptfs, dl, _v, _n, _ok, offs, lens, idfs, avgdl, *_rest) = args
    got = fused.lexical_scores(*(torch.from_numpy(a) for a in (
        pdocs, ptfs, dl, offs, lens, idfs)), float(avgdl),
        n_pad=dl.shape[0], window=window).numpy()
    want = np.zeros(dl.shape[0])
    for t in range(len(offs)):
        for j in range(int(lens[t])):
            p = min(int(offs[t]) + j, len(pdocs) - 1)
            doc, tf = int(pdocs[p]), float(ptfs[p])
            denom = tf + 1.2 * (1 - 0.75 + 0.75 * float(dl[doc]) / float(avgdl))
            want[doc] += float(idfs[t]) * tf / denom
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_lexical_sum_gives_the_same_bits_every_call():
    """Postings with repeated docs in one window (each doc's run summed in
    order): the same inputs give the same bits on repeated calls, and a
    doc past the slots adds nothing, as the reference's scatter drops it."""
    args = _inputs(6, n_pad=256, p_pad=2048, window=128)
    pdocs, ptfs, dl, *_ = args
    pdocs = pdocs.copy()
    pdocs[5] = 300
    targs = [torch.from_numpy(a) for a in (pdocs, ptfs, dl, args[6],
                                            args[7], args[8])]
    first = fused.lexical_scores(*targs, 41.5, n_pad=256, window=128)
    for _ in range(3):
        assert torch.equal(fused.lexical_scores(*targs, 41.5, n_pad=256,
                                                window=128), first)
    ref_lex = _reference_lex(pdocs, ptfs, dl, args[6], args[7], args[8],
                             41.5, 128)
    np.testing.assert_allclose(first.numpy(), ref_lex, rtol=1e-6, atol=1e-6)


def _reference_lex(pdocs, ptfs, dl, offs, lens, idfs, avgdl, window):
    """The reference's lexical sum (its lines of hybrid_score_topk), in
    JAX: zero vectors and unit weights leave lex + vec with vec = 1."""
    n_pad = dl.shape[0]
    v, i = jax_fused.hybrid_score_topk(
        jnp.asarray(pdocs), jnp.asarray(ptfs), jnp.asarray(dl),
        jnp.zeros((n_pad, 4), jnp.float32), jnp.zeros(n_pad, jnp.float32),
        jnp.ones(n_pad, bool), jnp.asarray(offs), jnp.asarray(lens),
        jnp.asarray(idfs), jnp.float32(avgdl), jnp.zeros((1, 4), jnp.float32),
        jnp.float32(1.0), jnp.float32(0.0), k=n_pad, window=window,
        similarity="dot_product")
    lex = np.zeros(n_pad, np.float32)
    lex[np.asarray(i)[0]] = np.asarray(v)[0]
    return lex


def test_graft_entry_matches_reference():
    """Both entry()s on their own example inputs (the same seed and
    shapes): the port's on the CPU when asked, its answer the reference's."""
    fn, args = graft_entry.entry(device="cpu")
    ref_fn, ref_args = __graft_entry__.entry()
    assert len(args) == len(ref_args) == 13
    for a, r in zip(args, ref_args):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    got = fn(*args)
    want = ref_fn(*ref_args)
    _assert_matches((got[0].numpy(), got[1].numpy()),
                    (np.asarray(want[0]), np.asarray(want[1])))


def test_graft_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.entry()


def test_jit_hybrid_is_cached():
    assert fused.jit_hybrid(10, 128, "l2_norm") is \
        fused.jit_hybrid(10, 128, "l2_norm")
    assert fused.jit_hybrid(10, 128, "l2_norm") is not \
        fused.jit_hybrid(10, 64, "l2_norm")
