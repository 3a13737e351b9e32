"""Carry the JAX package's state into the port, as numpy arrays.

The parity tests feed both packages the same bits: they take arrays out of
opensearch_tpu (or make them with numpy) and build the port's structures
from them here. Nothing in this module imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from opensearch_tpu_torch.index.device import (
    DeviceVectorField,
    vector_field_from_numpy,
)
from opensearch_tpu_torch.search.distributed_serving import _IndexBundle


def bundle_from_numpy(vectors: np.ndarray, norms_sq: np.ndarray,
                      valid: np.ndarray, device: torch.device | str,
                      seg_offsets: list | None = None) -> _IndexBundle:
    """The serving bundle for stacked shards: vectors [S, n, d] f32,
    norms_sq [S, n] f32, valid [S, n] bool. `seg_offsets` defaults to one
    segment per shard covering all n rows."""
    vectors = np.ascontiguousarray(vectors, np.float32)
    s, n, _d = vectors.shape
    return _IndexBundle(
        vectors=torch.from_numpy(vectors).to(device),
        norms_sq=torch.from_numpy(
            np.ascontiguousarray(norms_sq, np.float32)).to(device),
        valid=torch.from_numpy(np.ascontiguousarray(valid, bool)).to(device),
        n_flat=n,
        seg_offsets=seg_offsets or [[(0, 0, n)] for _ in range(s)],
    )


def segment_vectors_from_numpy(vectors: np.ndarray, present: np.ndarray, *,
                               similarity: str, device: torch.device | str,
                               n_pad: int | None = None) -> DeviceVectorField:
    """One segment's vector column (vectors [n, d], present [n]) as the
    port's DeviceVectorField, padded to n_pad rows (default: n)."""
    vectors = np.asarray(vectors, np.float32)
    return vector_field_from_numpy(
        vectors, present, similarity=similarity,
        n_pad=vectors.shape[0] if n_pad is None else n_pad, device=device)
