"""Top-k selection with the doc-id-ascending tie-break.

Counterpart of opensearch_tpu/ops/topk.py. :func:`merge_shard_hits` is the
host k-way merge of per-shard hit lists (search/service.py merges one
node's shards by (-score, shard, segment, doc)). :func:`segment_top_k` is the general query
phase's cut of one segment's masked score column. The contract (reference
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

import numpy as np
import torch

# the reference's gate: below this row count, above this k, or when the
# candidate blocks cover most of the row, one sort replaces the two stages
BLOCKWISE_MIN_N = 32_768
MAX_ITERATIVE_K = 128


def segment_top_k(scores: torch.Tensor,
                  k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values [k], local doc ids [k]) of a [n_pad] score column, or [B, k]
    of a [B, n_pad] batch; non-matching, deleted and padding docs must
    already be -inf. Ties go to the lower doc id."""
    if scores.dim() == 1:
        vals, ids = blockwise_topk(scores[None, :], k)
        return vals[0], ids[0]
    return blockwise_topk(scores, k)


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
    """Exact top-k over the last dim of [B, m] scores of at most float32
    precision by k argmax-and-mask passes (the reference's small-k
    strategy). ``torch.argmax`` returns the first
    maximal index, which is the doc-id-ascending tie-break. The passes run
    on int32 keys that order as the float scores do (-0.0 taken as 0.0),
    so a picked slot is masked below every score, -inf included: a row
    with fewer than k finite scores fills its tail with its lowest -inf
    positions, each once, as one stable sort does. (The reference masks
    with -inf and so picks its first -inf position again and again.) The
    caller's scores are left as they were."""
    B = s.shape[0]
    bits = (s.float() + 0.0).view(torch.int32)
    keys = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    rows = torch.arange(B, device=s.device)
    ids = torch.zeros((B, k), dtype=torch.int64, device=s.device)
    for i in range(k):
        idx = torch.argmax(keys, dim=-1)
        ids[:, i] = idx
        keys[rows, idx] = torch.iinfo(torch.int32).min
    return torch.gather(s, 1, ids), ids


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


def merge_shard_hits(
    per_shard: list[tuple],  # [(scores[k], docs[k]) ...], tensors or arrays
    k: int,
) -> list[tuple[float, int, int]]:
    """Host k-way merge with OpenSearch tie-break: score desc, then shard
    index asc, then doc id asc. Returns [(score, shard_idx, doc)] with
    -inf (= no hit) entries dropped."""
    rows: list[tuple[float, int, int]] = []
    for shard_idx, (scores, docs) in enumerate(per_shard):
        s = _host(scores)
        d = _host(docs)
        for i in range(len(s)):
            if np.isfinite(s[i]):
                rows.append((float(s[i]), shard_idx, int(d[i])))
    rows.sort(key=lambda r: (-r[0], r[1], r[2]))
    return rows[:k]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
