"""Top-k selection with the doc-id-ascending tie-break.

Counterpart of opensearch_tpu/ops/topk.py, without ``segment_top_k`` and
``merge_shard_hits``: no code of the port calls them yet (the per-shard
query phase cuts on the host, and search/service.py merges by (-score,
shard, segment, doc)). The contract (reference
ops/topk.py:3-6,81-83): among equal scores the LOWER position wins, which
reproduces Lucene/OpenSearch's doc-id-ascending tie-break because the
score column is indexed by local doc id. ``torch.topk`` promises no order
on ties, so the reference's ``lax.top_k`` becomes :func:`stable_topk`, a
stable sort of the negated scores and a slice.

:func:`blockwise_topk` keeps the reference's two-stage block-max pruning
and its policy gate (``BLOCKWISE_MIN_N``, ``MAX_ITERATIVE_K``), so the two
packages take the same branch for the same shape; both branches return the
same answer.
"""

from __future__ import annotations

import torch

# the reference's gate: below this row count, above this k, or when the
# candidate blocks cover most of the row, one sort replaces the two stages
BLOCKWISE_MIN_N = 32_768
MAX_ITERATIVE_K = 128


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


def _iterative_topk(s: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the last dim of [B, m] by k argmax-and-mask passes
    (the reference's small-k strategy). ``torch.argmax`` returns the first
    maximal index, which is the doc-id-ascending tie-break. Works on a copy:
    the caller's scores are left as they were."""
    B = s.shape[0]
    s = s.clone()
    rows = torch.arange(B, device=s.device)
    vals = torch.full((B, k), float("-inf"), dtype=s.dtype, device=s.device)
    ids = torch.zeros((B, k), dtype=torch.int64, device=s.device)
    for i in range(k):
        idx = torch.argmax(s, dim=-1)
        vals[:, i] = s[rows, idx]
        ids[:, i] = idx
        s[rows, idx] = float("-inf")
    return vals, ids


def blockwise_topk(scores: torch.Tensor, k: int,
                   block_size: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over [B, n] by block-max pruning: the k blocks with the
    largest maxima (ties to the lower block) hold every top-k doc under
    (score desc, doc id asc), so (1) per-block maxima, (2) k argmax passes
    pick the candidate blocks, sorted ascending so the candidate layout is
    block-id-major, (3) k argmax passes over the k*block_size candidates.
    Outside the reference's gate one stable sort answers instead. Ties go
    to the lower doc id end to end; k > n pads with (-inf, padding
    position) as the reference does. Returns (vals [B, k], ids [B, k]
    int64)."""
    B, n = scores.shape
    if k > n:
        pad = scores.new_full((B, k - n), float("-inf"))
        scores = torch.cat([scores, pad], dim=1)
        n = k
    nb = -(-n // block_size)
    if n < BLOCKWISE_MIN_N or k > MAX_ITERATIVE_K or nb <= 2 * k:
        return stable_topk(scores, k)
    pad = nb * block_size - n
    if pad:
        scores = torch.cat([scores, scores.new_full((B, pad), float("-inf"))],
                           dim=1)
    sb = scores.reshape(B, nb, block_size)
    _, blk_ids = _iterative_topk(sb.amax(dim=-1), k)           # [B, k]
    blk_ids = torch.sort(blk_ids, dim=1).values
    cand = torch.gather(sb, 1, blk_ids[:, :, None].expand(B, k, block_size))
    vals, flat = _iterative_topk(cand.reshape(B, k * block_size), k)
    slot, off = flat // block_size, flat % block_size
    return vals, torch.gather(blk_ids, 1, slot) * block_size + off
