"""BM25 lexical scoring over a segment's device postings.

Counterpart of opensearch_tpu/ops/bm25.py (``idf``, ``bm25_term_scores``,
``constant_term_scores``). For each query term (one row of offsets,
lengths and idfs) a window of its postings (docs, tfs) is gathered,
``idf * tf / (tf + k1 * (1 - b + b * dl / avgdl))`` is computed for each,
and the contributions are summed into a dense [n_pad] score column, with
the count of matching terms a doc beside it. Only (offset, length, idf)
per term crosses from the host at query time; the postings live on the
device (index/device.DeviceTextField).

The reference sums with a float scatter-add. On the card a float
``index_add_`` gives other bits from run to run, so the sum here is
:func:`doc_sums`: the window's (doc, contribution) pairs are sorted by doc,
stable, and each doc's run is added in order by ``torch.segment_reduce``,
whose CUDA kernel adds a segment's values one after another with no
atomics. That is the reference's update order (term by term, window slot
by slot, from 0), on the CPU and on the card. The hybrid program's
lexical half (ops/fused.lexical_scores) goes through the same two
helpers, so the port has one deterministic BM25 sum. The length of each
doc's run is its match count, so the sort gives the counts too. This is
XLA outside any Pallas kernel in the reference, so it is plain PyTorch
here.
"""

from __future__ import annotations

import math

import torch

from opensearch_tpu_torch.search.profile import profiled_kernel

K1_DEFAULT = 1.2
B_DEFAULT = 0.75


def idf(doc_freq: int, doc_count: int) -> float:
    """Lucene BM25Similarity.idfExplain."""
    return math.log(1.0 + (doc_count - doc_freq + 0.5) / (doc_freq + 0.5))


def _as_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(  # tpulint: disable=TPU014 - per-query operand
        x, dtype=dtype).to(device)


def postings_window(postings_docs: torch.Tensor, offsets, lengths, *,
                    n_pad: int, window: int):
    """The gather of Q terms' postings windows: (idx [Q, W] int64 into the
    postings, docs [Q, W] int64, valid [Q, W] bool). A window slot past a
    term's length is dead and reads posting 0, as the reference's masked
    gather does; an index past the postings is clamped to the last one
    (XLA's gather) and a doc id past the slots is dead (XLA's scatter drops
    it). Dead slots carry doc 0."""
    device = postings_docs.device
    p_pad = postings_docs.shape[0]
    offsets = _as_tensor(offsets, torch.int64, device)
    lengths = _as_tensor(lengths, torch.int64, device)
    win = torch.arange(window, dtype=torch.int64, device=device)
    valid = win[None, :] < lengths[:, None]                      # [Q, W]
    idx = torch.where(valid, offsets[:, None] + win[None, :], 0)
    idx = torch.clamp(idx, max=p_pad - 1)
    docs = postings_docs[idx].long()
    valid = valid & (docs < n_pad)
    return idx, torch.where(valid, docs, 0), valid


def bm25_contributions(postings_tfs, doc_len, idx, docs, valid, idfs,
                       avgdl, k1: float, b: float) -> torch.Tensor:
    """Each window slot's BM25 term score [Q, W] f32, 0 on dead slots, in
    the reference's operation order."""
    device = postings_tfs.device
    tfs = postings_tfs[idx]
    dl = doc_len[docs]
    idfs = _as_tensor(idfs, torch.float32, device)
    avgdl = _as_tensor(avgdl, torch.float32, device)
    denom = tfs + k1 * (1.0 - b + b * dl / avgdl)
    contrib = idfs[:, None] * tfs / torch.clamp(denom, min=1e-9)
    return torch.where(valid, contrib, 0.0)


def doc_sums(docs: torch.Tensor, contrib: torch.Tensor, valid: torch.Tensor,
             n_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense sums of `contrib` by `docs` over the live slots (`valid`), any
    shape, each doc's values added in their given order from 0: (sums
    [n_pad] f32, counts [n_pad] int32, the live slots a doc has). A stable
    sort by doc, dead slots keyed past the last doc, then
    ``torch.segment_reduce`` over each doc's run, whose length is its
    count. The same bits on the CPU and the card, run after run."""
    keys = torch.where(valid, docs, n_pad).reshape(-1)
    contrib = contrib.reshape(-1)
    sums = torch.zeros(n_pad + 1, dtype=torch.float32, device=contrib.device)
    counts = torch.zeros(n_pad + 1, dtype=torch.int32, device=contrib.device)
    if keys.numel():
        order = torch.sort(keys, stable=True).indices
        run_docs, lengths = torch.unique_consecutive(keys[order],
                                                     return_counts=True)
        sums[run_docs] = torch.segment_reduce(contrib[order], "sum",
                                              lengths=lengths)
        counts[run_docs] = lengths.to(torch.int32)
    return sums[:n_pad], counts[:n_pad]


@profiled_kernel("bm25_term_scores")
def bm25_term_scores(postings_docs: torch.Tensor,   # int32 [P_pad]
                     postings_tfs: torch.Tensor,    # float32 [P_pad]
                     doc_len: torch.Tensor,         # float32 [n_pad]
                     offsets,                       # int32 [Q]
                     lengths,                       # int32 [Q]
                     idfs,                          # float32 [Q]
                     avgdl,                         # float32 scalar
                     n_pad: int, window: int, k1: float = K1_DEFAULT,
                     b: float = B_DEFAULT):
    """Returns (scores [n_pad] f32, match_counts [n_pad] int32).

    match_counts[d] is the number of query terms matching doc d, the bool
    building block (must: count == terms; should: count >= minimum). The
    per-term rows may arrive as host numpy arrays (the only per-query
    transfer of the path) or tensors."""
    idx, docs, valid = postings_window(postings_docs, offsets, lengths,
                                       n_pad=n_pad, window=window)
    contrib = bm25_contributions(postings_tfs, doc_len, idx, docs, valid,
                                 idfs, avgdl, k1, b)
    return doc_sums(docs, contrib, valid, n_pad)


@profiled_kernel("constant_term_scores")
def constant_term_scores(postings_docs: torch.Tensor, offsets, lengths,
                         weights, n_pad: int, window: int):
    """Constant-score variant (a term in filter or constant-score
    context): each matching doc gets `weight` per term, no tf or norm
    math. Returns (scores [n_pad] f32, match_counts [n_pad] int32)."""
    device = postings_docs.device
    _idx, docs, valid = postings_window(postings_docs, offsets, lengths,
                                        n_pad=n_pad, window=window)
    weights = _as_tensor(weights, torch.float32, device)
    contrib = torch.where(valid, weights[:, None], 0.0)
    return doc_sums(docs, contrib, valid, n_pad)
