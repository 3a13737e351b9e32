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
from opensearch_tpu_torch.ops.ivfpq import IVFPQIndex, IVFPQParams
from opensearch_tpu_torch.parallel.distributed import QueryArgs, ShardedSegments
from opensearch_tpu_torch.search.distributed_serving import _IndexBundle


def bundle_from_numpy(vectors: np.ndarray, norms_sq: np.ndarray,
                      valid: np.ndarray, device: torch.device | str,
                      seg_offsets: list | None = None) -> _IndexBundle:
    """The one-slot serving bundle for stacked shards: vectors [S, n, d]
    f32, norms_sq [S, n] f32, valid [S, n] bool. `seg_offsets` defaults to
    one segment per shard covering all n rows."""
    vectors = np.ascontiguousarray(vectors, np.float32)
    s, n, _d = vectors.shape
    return _IndexBundle(
        vectors=[torch.from_numpy(vectors).to(device)],
        norms_sq=[torch.from_numpy(
            np.ascontiguousarray(norms_sq, np.float32)).to(device)],
        valid=[torch.from_numpy(
            np.ascontiguousarray(valid, bool)).to(device)],
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
        n_pad=vectors.shape[0] if n_pad is None else n_pad,
        put=lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device))


def ivfpq_index_from_numpy(coarse: np.ndarray, codebooks: np.ndarray,
                           codes: np.ndarray, ids: np.ndarray,
                           mask: np.ndarray, *, l_pad: int, n: int,
                           normalized: bool, device: torch.device | str,
                           build_generation: int = 0) -> IVFPQIndex:
    """An IVF-PQ build carried across as numpy arrays (coarse [nlist, d],
    codebooks [m, ks, dsub], codes [nlist, L_pad, m] uint8, ids and mask
    [nlist, L_pad]), so both packages search the same build."""
    coarse = np.ascontiguousarray(coarse, np.float32)
    codebooks = np.ascontiguousarray(codebooks, np.float32)
    nlist, d = coarse.shape
    m, ks, _dsub = codebooks.shape
    put = lambda a, dt: torch.from_numpy(np.array(a, dtype=dt)).to(device)
    return IVFPQIndex(
        params=IVFPQParams(coarse=put(coarse, np.float32),
                           codebooks=put(codebooks, np.float32),
                           nlist=nlist, m=m, ks=ks, d=d),
        codes=put(codes, np.uint8),
        ids=put(ids, np.int32),
        mask=put(mask, bool),
        l_pad=int(l_pad),
        n=int(n),
        normalized=bool(normalized),
        build_generation=build_generation,
        coarse_host=coarse,
        coarse_sq_host=np.sum(coarse * coarse, axis=1),
    )


def sharded_segments_from_numpy(vectors: np.ndarray, norms_sq: np.ndarray,
                                valid: np.ndarray, postings_docs: np.ndarray,
                                postings_tfs: np.ndarray, doc_len: np.ndarray,
                                *, device: torch.device | str
                                ) -> ShardedSegments:
    """The tensor-parallel program's segments from the numpy arrays the
    reference's ShardedSegments holds: vectors [S, n_pad, d] f32, norms_sq
    [S, n_pad] f32, valid [S, n_pad] bool, postings_docs [S, p_pad] int32,
    postings_tfs [S, p_pad] f32, doc_len [S, n_pad] f32."""
    put = lambda a, dt: torch.from_numpy(
        np.ascontiguousarray(a, dtype=dt)).to(device)
    return ShardedSegments(
        vectors=put(vectors, np.float32), norms_sq=put(norms_sq, np.float32),
        valid=put(valid, bool), postings_docs=put(postings_docs, np.int32),
        postings_tfs=put(postings_tfs, np.float32),
        doc_len=put(doc_len, np.float32))


def query_args_from_numpy(query_vectors: np.ndarray, term_offsets: np.ndarray,
                          term_lengths: np.ndarray, term_idfs: np.ndarray,
                          avgdl: np.ndarray, lexical_weight: float,
                          vector_weight: float, *, k1: float = 1.2,
                          b: float = 0.75,
                          device: torch.device | str) -> QueryArgs:
    """The tensor-parallel program's query arguments from numpy: queries
    [B, d] f32, per-shard term offsets and lengths [S, Q] int32, IDFs
    [S, Q] f32, avgdl [S] f32; the weights, k1 and b as f32 scalars."""
    put = lambda a, dt: torch.from_numpy(
        np.ascontiguousarray(a, dtype=dt)).to(device)
    scalar = lambda x: torch.tensor(np.float32(x), device=device)
    return QueryArgs(
        query_vectors=put(query_vectors, np.float32),
        term_offsets=put(term_offsets, np.int32),
        term_lengths=put(term_lengths, np.int32),
        term_idfs=put(term_idfs, np.float32),
        avgdl=put(np.reshape(avgdl, -1), np.float32),
        lexical_weight=scalar(lexical_weight),
        vector_weight=scalar(vector_weight),
        k1=scalar(k1), b=scalar(b))
