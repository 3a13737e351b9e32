"""Doc-values filter primitives: boolean masks over the dense doc column.

Counterpart of opensearch_tpu/ops/filters.py. Every filter compiles to an
[n_pad] bool mask on the segment's device; a bool query composes them
elementwise (&, |, &~). These are elementwise torch operations, as the
reference's are jnp ones: no Pallas kernel stands behind them.

int64 columns keep the reference's two-int32-word encoding
(index/segment.split_i64): a range compares (hi, lo) lexicographically,
with lo pre-offset so that a signed compare orders it as unsigned, which
is exact int64 semantics at I64_MIN, I64_MAX and every 2^31 boundary. The
reference's scatter-max of a CSR entry's hit into its owning doc becomes
``scatter_reduce_(..., "amax")``, which is deterministic (a max does not
depend on the order it meets its inputs).
"""

from __future__ import annotations

import torch


def i64_ge(hi, lo, qhi: int, qlo: int) -> torch.Tensor:
    return (hi > qhi) | ((hi == qhi) & (lo >= qlo))


def i64_le(hi, lo, qhi: int, qlo: int) -> torch.Tensor:
    return (hi < qhi) | ((hi == qhi) & (lo <= qlo))


def range_mask_i64(hi: torch.Tensor, lo: torch.Tensor, present: torch.Tensor,
                   gte_hi: int, gte_lo: int, lte_hi: int,
                   lte_lo: int) -> torch.Tensor:
    """Closed-interval int64 range over int32 words hi / lo [n_pad]; callers
    encode open or absent bounds as int64 min / max sentinels (gt x is
    gte x + 1, lt x is lte x - 1)."""
    return (present & i64_ge(hi, lo, gte_hi, gte_lo)
            & i64_le(hi, lo, lte_hi, lte_lo))


def range_mask_f32(values: torch.Tensor, present: torch.Tensor, gte: float,
                   lte: float, gt_open: bool, lt_open: bool) -> torch.Tensor:
    """Range over f32 values [n_pad]; strict bounds where gt_open / lt_open.
    The bounds are rounded to f32 first, as the reference's jnp.float32
    scalars are."""
    lo = torch.tensor(  # tpulint: disable=TPU014 - per-launch scalar bound
        gte, dtype=torch.float32, device=values.device)
    hi = torch.tensor(  # tpulint: disable=TPU014 - per-launch scalar bound
        lte, dtype=torch.float32, device=values.device)
    lower = values > lo if gt_open else values >= lo
    upper = values < hi if lt_open else values <= hi
    return present & lower & upper


def _docs_any(hit: torch.Tensor, mv_docs: torch.Tensor,
              n_pad: int) -> torch.Tensor:
    """[n_pad] bool: docs owning at least one hit entry (a scatter-max of
    the entries' hits into their docs)."""
    mask = torch.zeros(n_pad, dtype=torch.int32, device=hit.device)
    mask.scatter_reduce_(0, mv_docs.long(), hit.to(torch.int32), "amax")
    return mask.bool()


def term_mask_keyword(mv_ords: torch.Tensor, mv_docs: torch.Tensor,
                      query_ord: int, n_pad: int) -> torch.Tensor:
    """Docs with an ordinal equal to query_ord in the CSR entries mv_ords
    [E_pad] (pad -2) owned by mv_docs [E_pad] (pad 0); query_ord -3 is a
    term not in the segment's dictionary."""
    return _docs_any(mv_ords == query_ord, mv_docs, n_pad)


def terms_mask_keyword(mv_ords: torch.Tensor, mv_docs: torch.Tensor,
                       query_ords: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Docs with any ordinal in query_ords [T_pad] (pad slots -3)."""
    hit = (mv_ords[:, None] == query_ords[None, :]).any(dim=1)
    return _docs_any(hit, mv_docs, n_pad)


def exists_mask(present: torch.Tensor) -> torch.Tensor:
    """Docs with a value in a column whose presence flags are `present`
    [n_pad] (a numeric or vector column's own)."""
    return present


def docs_mask_from_postings(postings_docs: torch.Tensor, offset: int,
                            length: int, n_pad: int,
                            window: int) -> torch.Tensor:
    """Docs holding one text term: the postings window [offset, offset +
    length) of postings_docs, read through a window of `window` slots."""
    dev = postings_docs.device
    win = torch.arange(window, dtype=torch.int64, device=dev)
    valid = win < length
    idx = torch.where(valid, offset + win, 0)
    docs = torch.where(valid, postings_docs[idx].long(), 0)
    return _docs_any(valid, docs, n_pad)
