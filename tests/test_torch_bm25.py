"""ops/bm25.py of the port against opensearch_tpu/ops/bm25.py on the CPU.

The same postings CSR (docs, term frequencies), doc lengths and per-term
rows (offset, length, idf), made from a numpy seed, go through both
``bm25_term_scores`` and ``constant_term_scores`` at several windows and
term counts: terms longer than, shorter than and equal to the window,
empty terms, a doc in many terms' postings. The match counts are equal;
the scores agree to rtol 1e-6 and on these inputs come out bit-equal (both
sum each doc's contributions term by term from 0; XLA could contract
``tf + k1 * (...)`` into a fused multiply-add where PyTorch does not).

Then the port's sum is held to its own contract: permuting the postings
inside each term's window (a doc still appears once per term) leaves every
score's bits as they were, since each doc's contributions are added in
term order whatever the order of the pairs; and ops/fused.lexical_scores,
the hybrid program's lexical half, is the same sum.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from opensearch_tpu.ops import bm25 as ref_bm25
from opensearch_tpu_torch.ops import bm25, fused

N_PAD = 512
N_DOCS = 450


def _postings(seed: int, n_terms: int, max_len: int):
    """A CSR of `n_terms` terms: each term's docs sorted and distinct, tfs
    1-6; lengths from 0 to max_len. Returns (docs, tfs, offsets, lengths,
    doc_len, idfs)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_len + 1, n_terms)
    lengths[0] = max_len                       # one term fills the window
    if n_terms > 2:
        lengths[1] = 0                         # one term is absent
    docs, tfs, offsets = [], [], []
    pos = 0
    for n in lengths:
        offsets.append(pos)
        docs.append(np.sort(rng.choice(N_DOCS, int(n), replace=False)))
        tfs.append(rng.integers(1, 7, int(n)))
        pos += int(n)
    p_pad = max(pos, 1) + 7
    pd = np.zeros(p_pad, np.int32)
    pt = np.zeros(p_pad, np.float32)
    pd[:pos] = np.concatenate(docs)
    pt[:pos] = np.concatenate(tfs)
    doc_len = np.zeros(N_PAD, np.float32)
    doc_len[:N_DOCS] = rng.integers(1, 60, N_DOCS)
    idfs = rng.uniform(0.1, 4.0, n_terms).astype(np.float32)
    return (pd, pt, np.asarray(offsets, np.int32),
            lengths.astype(np.int32), doc_len, idfs)


CASES = [(1, 8, 8), (3, 16, 32), (5, 64, 64), (8, 40, 128), (12, 200, 256)]


@pytest.mark.parametrize("n_terms,max_len,window", CASES)
def test_bm25_term_scores_match_reference(n_terms, max_len, window):
    pd, pt, offs, lens, dl, idfs = _postings(n_terms * 7 + window, n_terms,
                                             max_len)
    avgdl = np.float32(dl[:N_DOCS].mean())
    want_s, want_c = ref_bm25.bm25_term_scores(
        jnp.asarray(pd), jnp.asarray(pt), jnp.asarray(dl), jnp.asarray(offs),
        jnp.asarray(lens), jnp.asarray(idfs), jnp.float32(avgdl),
        n_pad=N_PAD, window=window)
    got_s, got_c = bm25.bm25_term_scores(
        torch.from_numpy(pd), torch.from_numpy(pt), torch.from_numpy(dl),
        offs, lens, idfs, avgdl, n_pad=N_PAD, window=window)
    assert got_s.dtype == torch.float32 and got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6)
    # bit-equal on these inputs (see the module docstring)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert (got_c.numpy() > 0).sum() > 0


@pytest.mark.parametrize("n_terms,max_len,window", CASES)
def test_constant_term_scores_match_reference(n_terms, max_len, window):
    pd, _pt, offs, lens, _dl, weights = _postings(n_terms + window, n_terms,
                                                  max_len)
    want_s, want_c = ref_bm25.constant_term_scores(
        jnp.asarray(pd), jnp.asarray(offs), jnp.asarray(lens),
        jnp.asarray(weights), n_pad=N_PAD, window=window)
    got_s, got_c = bm25.constant_term_scores(
        torch.from_numpy(pd), offs, lens, weights, n_pad=N_PAD,
        window=window)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("n_terms,max_len,window", CASES[1:])
def test_permuted_postings_window_gives_the_same_bits(n_terms, max_len,
                                                      window):
    pd, pt, offs, lens, dl, idfs = _postings(n_terms * 3, n_terms, max_len)
    rng = np.random.default_rng(99)
    pd2, pt2 = pd.copy(), pt.copy()
    for o, n in zip(offs, lens):
        perm = o + rng.permutation(int(n))
        pd2[o:o + n], pt2[o:o + n] = pd[perm], pt[perm]
    outs = [bm25.bm25_term_scores(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(dl),
        offs, lens, idfs, np.float32(20.5), n_pad=N_PAD, window=window)
        for a, b in ((pd, pt), (pd2, pt2))]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_hybrid_lexical_half_is_the_same_sum():
    pd, pt, offs, lens, dl, idfs = _postings(4, 6, 48)
    args = (torch.from_numpy(pd), torch.from_numpy(pt), torch.from_numpy(dl),
            torch.from_numpy(offs), torch.from_numpy(lens),
            torch.from_numpy(idfs))
    lex = fused.lexical_scores(*args, np.float32(17.0), n_pad=N_PAD,
                               window=64)
    scores, _counts = bm25.bm25_term_scores(*args, np.float32(17.0),
                                            n_pad=N_PAD, window=64)
    assert torch.equal(lex, scores)


def test_idf_is_lucenes():
    assert bm25.idf(3, 100) == ref_bm25.idf(3, 100)
    assert bm25.idf(0, 1) == pytest.approx(np.log(1 + 1.5 / 0.5))
