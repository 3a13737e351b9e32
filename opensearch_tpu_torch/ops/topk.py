"""Top-k selection with the doc-id-ascending tie-break.

Counterpart of opensearch_tpu/ops/topk.py. The contract (reference
ops/topk.py:3-6,81-83): among equal scores the LOWER position wins, which
reproduces Lucene/OpenSearch's doc-id-ascending tie-break because the
score column is indexed by local doc id. ``torch.topk`` promises no order
on ties, so selection here is a stable sort of the negated scores and a
slice.
"""

from __future__ import annotations

import torch


def stable_topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values [..., k], positions [..., k]) over the last dim, best first,
    ties to the lower position. k may exceed the row length: the tail is
    padded with (-inf, position of the padding) like the reference's
    blockwise_topk, and callers drop non-finite slots."""
    n = scores.shape[-1]
    if k > n:
        pad = scores.new_full((*scores.shape[:-1], k - n), float("-inf"))
        scores = torch.cat([scores, pad], dim=-1)
    order = torch.sort(-scores, dim=-1, stable=True).indices[..., :k]
    return torch.gather(scores, -1, order), order

