"""The port's flagship forward step, as ``__graft_entry__.entry()`` gives
the reference's.

``entry(device=None)`` returns ``(fn, example_args)``: ``fn`` is the
hybrid BM25 + exact-kNN score and top-k over one segment's arrays
(ops/fused.hybrid_score_topk, bound to k = 10, window = 128, l2), and
``example_args`` the reference's example inputs (the same numpy generator,
seed and shapes: 2,048 docs of 64 dims, 4,096 postings, 8 query terms, 4
queries) as tensors on the card, or on the CPU where ``device="cpu"`` is
passed. With no device it is the card, and it raises where there is none.
The reference's ``dryrun_multichip`` (the tensor-parallel hybrid step over
a device mesh) is not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from opensearch_tpu_torch import backend
from opensearch_tpu_torch.ops.fused import hybrid_score_topk


def entry(device: torch.device | str | None = None):
    dev = backend.resolve_device(device)
    rng = np.random.default_rng(0)
    n_pad, d, p_pad, Q, B, k, window = 2048, 64, 4096, 8, 4, 10, 128

    postings_docs = rng.integers(0, n_pad, p_pad).astype(np.int32)
    postings_tfs = rng.integers(1, 5, p_pad).astype(np.float32)
    doc_len = rng.integers(5, 80, n_pad).astype(np.float32)
    vectors = rng.standard_normal((n_pad, d)).astype(np.float32)
    norms_sq = (vectors**2).sum(-1).astype(np.float32)
    valid = np.ones(n_pad, bool)
    offsets = (rng.integers(0, p_pad - window, Q)).astype(np.int32)
    lengths = rng.integers(0, window, Q).astype(np.int32)
    idfs = rng.uniform(0.5, 3.0, Q).astype(np.float32)
    queries = rng.standard_normal((B, d)).astype(np.float32)

    fn = functools.partial(hybrid_score_topk, k=k, window=window,
                           similarity="l2_norm")
    example_args = tuple(
        torch.from_numpy(a).to(dev) for a in (
            postings_docs, postings_tfs, doc_len, vectors, norms_sq, valid,
            offsets, lengths, idfs)) + (
        torch.tensor(40.0, device=dev),
        torch.from_numpy(queries).to(dev),
        torch.tensor(1.0, device=dev),
        torch.tensor(1.0, device=dev),
    )
    return fn, example_args
