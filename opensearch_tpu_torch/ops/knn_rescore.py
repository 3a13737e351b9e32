"""The exact fp32 rescore of a reduced-precision pool, and |q|^2, each dot
summed in one fixed order: the kernels of ``csrc/knn_rescore.cu`` and
their plain versions.

No Pallas kernel is replaced: the reference rescores in XLA (a gather and
an einsum inside ``opensearch_tpu/ops/pallas_knn.py::knn_fused``). A
batched einsum lets the library pick its summation order by the batch, so
a query merged into a batch by the dispatch batcher could get other last
bits than alone, which breaks the batcher's contract of results
bit-identical to the unbatched path. Here every dot of d products has one
order, whatever the batch: lane l (of 32) sums the products of elements
l, l + 32, l + 64, ... in ascending order, each product rounded and then
added (no fused multiply-add), and the 32 lane sums meet in a butterfly
(xor 16, 8, 4, 2, 1). The plain versions take the same order with
elementwise operations, so kernel and plain version agree bit for bit.

The IVF-PQ route's exact rescore (ops/ivfpq.exact_rescore) keeps the
reference's transform and takes only the dots, from the same kernel
(:func:`rescore_dots`, the plain :func:`plain_rescore_dots`).

Dispatch: a CUDA tensor launches the kernel (or raises), a CPU tensor
takes the plain version. Launches are counted on ``launches`` (the
rescore and its dots alone) and ``sq_launches`` (|q|^2).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from opensearch_tpu_torch.ops import cuda_lib

_SIM_CODE = {"l2_norm": 0, "cosine": 1, "dot_product": 2}
# the kernel's `sim` for the dots alone (kRawDots in csrc/knn_rescore.cu)
_RAW_DOTS = 3
_NEG_INF = float("-inf")
LANES = 32

launches = cuda_lib.LaunchCounter()
sq_launches = cuda_lib.LaunchCounter()


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_lib.load("knn_rescore")
    lib.knn_query_sq_launch.restype = ctypes.c_int
    lib.knn_query_sq_launch.argtypes = ([ctypes.c_void_p] * 2
                                        + [ctypes.c_int] * 2
                                        + [ctypes.c_void_p])
    lib.knn_rescore_launch.restype = ctypes.c_int
    lib.knn_rescore_launch.argtypes = ([ctypes.c_void_p] * 7
                                       + [ctypes.c_int] * 6
                                       + [ctypes.c_void_p])
    return lib


def fixed_order_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dots of a and b over their last axis (broadcast against each other)
    in the kernels' order: the products, zero-padded to whole 32s, summed
    in 32 lanes a chunk at a time from zero, then the lane butterfly; the
    result is lane 0's."""
    prod = a * b
    d = prod.shape[-1]
    pad = -d % LANES
    if pad:
        prod = torch.nn.functional.pad(prod, (0, pad))
    chunks = prod.reshape(*prod.shape[:-1], -1, LANES)
    acc = torch.zeros(chunks.shape[:-2] + (LANES,), dtype=prod.dtype,
                      device=prod.device)
    for c in range(chunks.shape[-2]):
        acc = acc + chunks[..., c, :]
    lane = torch.arange(LANES, device=prod.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ o]
    return acc[..., 0]


def plain_query_sq(queries: torch.Tensor) -> torch.Tensor:
    """|q|^2 of [B, d] f32 rows in the kernel's order: [B]."""
    return fixed_order_dots(queries, queries)


def query_sq(queries: torch.Tensor) -> torch.Tensor:
    """|q|^2 of [B, d] f32 rows, the same bits for a row whatever the
    batch: the kernel for a CUDA tensor, :func:`plain_query_sq` for a CPU
    tensor."""
    if queries.device.type == "cpu":
        return plain_query_sq(queries)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device [{queries.device}]")
    if queries.dtype != torch.float32 or queries.dim() != 2:
        raise ValueError(f"queries must be f32 [B, d], got "
                         f"{queries.dtype}{tuple(queries.shape)}")
    q = queries.contiguous()
    B, d = q.shape
    out = torch.empty(B, dtype=torch.float32, device=q.device)
    err = _library().knn_query_sq_launch(
        q.data_ptr(), out.data_ptr(), B, d,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn_query_sq launch failed: cudaError {err}")
    sq_launches.add()
    return out


def plain_rescore(queries, qsq, vectors, norms_sq, valid, cand, *,
                  similarity: str) -> torch.Tensor:
    """Scores [S, B, R] of candidates cand [S, B, R] (shard-local ids, -1
    empty) against queries [B, d]: the fixed-order fp32 dot, the transform,
    -inf where the id is -1 or the doc is dead. -1 ids are clamped before
    the gather (negative indices wrap in torch) and masked after it. The
    transform is the serving one, one eager operation at a time, which the
    kernel rounds alike."""
    # imported here: ops/knn_fused imports this module
    from opensearch_tpu_torch.ops.knn_fused import _transform_scores

    cand = cand.long()
    safe = torch.clamp(cand, min=0)
    shard = torch.arange(vectors.shape[0], device=vectors.device)[:, None, None]
    cvec = vectors[shard, safe]                            # [S, B, R, d]
    dots = fixed_order_dots(queries[None, :, None, :], cvec)
    scores = _transform_scores(dots, qsq[None, :, None],
                               norms_sq[shard, safe], similarity)
    ok = (cand >= 0) & valid[shard, safe]
    return torch.where(ok, scores, _NEG_INF)


def rescore(queries, qsq, vectors, norms_sq, valid, cand, *,
            similarity: str) -> torch.Tensor:
    """Scores [S, B, R] of pool candidates: the kernel for CUDA tensors (or
    a raise), :func:`plain_rescore` for CPU tensors. queries [B, d] f32,
    qsq [B] (:func:`query_sq`), vectors [S, n, d] f32, norms_sq [S, n],
    valid [S, n] bool, cand [S, B, R] int32."""
    if vectors.device.type == "cpu":
        return plain_rescore(queries, qsq, vectors, norms_sq, valid, cand,
                             similarity=similarity)
    if vectors.device.type != "cuda":
        raise ValueError(f"unsupported device [{vectors.device}]")
    S, n, d = vectors.shape
    B = queries.shape[0]
    R = cand.shape[-1]
    want = {"queries": (queries, (B, d), torch.float32),
            "qsq": (qsq, (B,), torch.float32),
            "vectors": (vectors, (S, n, d), torch.float32),
            "norms_sq": (norms_sq, (S, n), torch.float32),
            "valid": (valid, (S, n), torch.bool),
            "cand": (cand, (S, B, R), torch.int32)}
    for name, (t, shape, dtype) in want.items():
        if t.device != vectors.device or tuple(t.shape) != shape \
                or t.dtype != dtype:
            raise ValueError(f"[{name}] is {t.dtype}{tuple(t.shape)} on "
                             f"{t.device}, expected {dtype}{shape} on "
                             f"{vectors.device}")
    if similarity not in _SIM_CODE:
        raise ValueError(f"unknown similarity [{similarity}]")
    if S > 65_535 or B > 65_535:
        raise ValueError(f"grid too large: S={S} B={B} (at most 65,535 "
                         f"each: the rescore's grid is (R / 32, B, S))")
    if 4 * d > 232_448:
        raise ValueError(f"the rescore keeps a query of d={d} floats in "
                         f"shared memory: at most 58,112")
    args = [t.contiguous() for t in (queries, qsq, vectors, norms_sq, valid,
                                     cand)]
    out = torch.empty((S, B, R), dtype=torch.float32, device=vectors.device)
    err = _library().knn_rescore_launch(
        *(t.data_ptr() for t in args), out.data_ptr(), S, n, d, B, R,
        _SIM_CODE[similarity],
        torch.cuda.current_stream(vectors.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn_rescore launch failed: cudaError {err}")
    launches.add()
    return out


def plain_rescore_dots(queries, vectors, cand) -> torch.Tensor:
    """Dots [S, B, R] of candidates cand [S, B, R] (shard-local ids, -1
    empty: 0 there) against queries [B, d], in the kernel's order."""
    cand = cand.long()
    safe = torch.clamp(cand, min=0)
    shard = torch.arange(vectors.shape[0], device=vectors.device)[:, None, None]
    dots = fixed_order_dots(queries[None, :, None, :], vectors[shard, safe])
    return torch.where(cand >= 0, dots, 0.0)


def rescore_dots(queries, vectors, cand) -> torch.Tensor:
    """The dots of :func:`rescore` without its transform and mask: the
    kernel for CUDA tensors (or a raise), :func:`plain_rescore_dots` for
    CPU tensors. queries [B, d] f32, vectors [S, n, d] f32, cand [S, B, R]
    int32."""
    if vectors.device.type == "cpu":
        return plain_rescore_dots(queries, vectors, cand)
    if vectors.device.type != "cuda":
        raise ValueError(f"unsupported device [{vectors.device}]")
    S, n, d = vectors.shape
    B = queries.shape[0]
    R = cand.shape[-1]
    for name, t, shape, dtype in (
            ("queries", queries, (B, d), torch.float32),
            ("vectors", vectors, (S, n, d), torch.float32),
            ("cand", cand, (S, B, R), torch.int32)):
        if t.device != vectors.device or tuple(t.shape) != shape \
                or t.dtype != dtype:
            raise ValueError(f"[{name}] is {t.dtype}{tuple(t.shape)} on "
                             f"{t.device}, expected {dtype}{shape} on "
                             f"{vectors.device}")
    if S > 65_535 or B > 65_535 or 4 * d > 232_448:
        raise ValueError(f"unsupported shape S={S} B={B} d={d}")
    q, v, c = (t.contiguous() for t in (queries, vectors, cand))
    out = torch.empty((S, B, R), dtype=torch.float32, device=vectors.device)
    err = _library().knn_rescore_launch(
        q.data_ptr(), None, v.data_ptr(), None, None, c.data_ptr(),
        out.data_ptr(), S, n, d, B, R, _RAW_DOTS,
        torch.cuda.current_stream(vectors.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn_rescore launch failed: cudaError {err}")
    launches.add()
    return out
