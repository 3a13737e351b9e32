"""The exact-scan family: three exact-kNN scans over an [n, d] fp32 slab,
their kernels for Hopper, their plain versions and their entry points.

Counterpart of opensearch_tpu/ops/pallas_knn.py:49-567:

  K3  ``knn_topk_auto``      running top-k scan (csrc/knn_block.cu: K1's
                             list scan, csrc/knn_pool.cuh, at k <= 32,
                             and its wide tier, csrc/knn_wide.cuh,
                             above, two kernels a call either way);
  K4  ``knn_blocktopk_auto`` top-k of every 2048-doc block, then a stable
                             block-major merge: two kernels (csrc/knn_pb.cu,
                             stage 1 ``pb_topk`` and stage 2 ``pb_select``);
  K5  ``knn_sbmax_auto``     maximum of every 128-doc sub-block, then the k
                             best sub-blocks rescored exactly: two kernels
                             (csrc/knn_sbmax.cu, stage 1 ``sbmax`` and
                             stage 2 ``sbmax_select``).

Each returns (scores [B, k] f32, ids [B, k] int32), best first under
(score desc, doc id asc), with (-inf, -1) past the valid-doc count. The
entry points keep the reference's padding arithmetic: n rounds up to the
kernel's block (``BLOCK`` or ``PB_BLOCK``) and B to a multiple of 8 (of
``PB_QTILE`` above it). Pad queries are zero rows, sliced off (K3's kernels
take the caller's rows unpadded, K4's kernels select and write only the
caller's rows); pad docs are dead, so
the kernels take the unpadded slab and score rows past n as -inf instead
of copying it.

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor runs
the plain version in this module (``plain_block_topk``, ``plain_pb_topk``,
``pb_merge``, ``plain_sbmax``, ``sbmax_rescore``). A k past a kernel's
stated limit raises ValueError on either device. K4's merge and K5's
selection and rescore are each a second kernel on CUDA.

K3, K4 and K5 read rows in 16-byte units (cp.async, float4):
on CUDA :func:`rows_in_16_bytes` pads d to a multiple of 4 and copies an
unaligned operand first.

``exact=False`` (the reference's Precision.DEFAULT, one bf16 MXU pass on
the TPU) means bf16-rounded operands with f32 accumulation, in K4's and
K5's scan and in K5's rescore; the kernels and the plain versions compute
it the same way, never as TF32.
"""

from __future__ import annotations

import ctypes

import torch

from opensearch_tpu_torch import backend  # noqa: F401  (pins float32)
from opensearch_tpu_torch.ops import cuda_lib
from opensearch_tpu_torch.ops.knn_fused import (
    _MAX_SMEM,
    _SIM_CODE,
    LIST_MAX_R,
    _launch_geometry,
    _transform_scores,
    launch_lists,
    launch_wide,
    rows_in_16_bytes,
)
from opensearch_tpu_torch.ops.knn_fused import QUERY_TILES as SBMAX_QTILES
from opensearch_tpu_torch.ops.knn_fused import query_tile as sbmax_query_tile
from opensearch_tpu_torch.ops.topk import stable_topk

BLOCK = 1024       # K3's doc block
PB_BLOCK = 2048    # K4's and K5's doc block
PB_QTILE = 128     # the reference's query tile (B pads to it above 128)
SUB = 128          # K5's sub-block
SBMAX_SELECT_SMEM = 200_000  # K5 stage 2 keeps its row of maxima and its
                             # k * 130 words in shared memory up to here
PB_LIST_K = 32     # K4 stage 1 keeps per-warp lists up to this k
PB_MERGE_SMEM = 200_000  # K4 stage 2 stages a query's nb * k candidates in
                         # shared memory up to here
BLOCK_MAX_K = 1024  # K3: the wide tier's largest pool (WIDE_MAX_R)
PB_MAX_K = PB_BLOCK  # K4: a block holds no more than PB_BLOCK docs

_NEG_INF = float("-inf")

# launches of each kernel, counted where its wrapper launches it (K3:
# either design, and the list scan and its wide tier alone)
block_launches = cuda_lib.LaunchCounter()
block_list_launches = cuda_lib.LaunchCounter()
block_wide_launches = cuda_lib.LaunchCounter()
pb_launches = cuda_lib.LaunchCounter()            # K4 stage 1
pb_merge_launches = cuda_lib.LaunchCounter()      # K4 stage 2
sbmax_launches = cuda_lib.LaunchCounter()         # K5 stage 1
sbmax_select_launches = cuda_lib.LaunchCounter()  # K5 stage 2


def _check_operands(vectors, norms_sq, valid, queries) -> None:
    dev = vectors.device
    if vectors.ndim != 2:
        raise ValueError(f"[vectors] must be [n, d], got {tuple(vectors.shape)}")
    n, d = vectors.shape
    B = queries.shape[0]
    want = {
        "vectors": (vectors, (n, d), torch.float32),
        "norms_sq": (norms_sq, (n,), torch.float32),
        "valid": (valid, (n,), torch.bool),
        "queries": (queries, (B, d), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if t.device != dev:
            raise ValueError(f"[{name}] is on {t.device}, expected {dev}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"[{name}] is {t.dtype}{tuple(t.shape)}, expected "
                f"{dtype}{shape}")
    if n < 1 or B < 1 or d < 1:
        raise ValueError(f"unsupported shape n={n} B={B} d={d}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device [{dev}]")


def _check_k(k: int, limit: int, what: str) -> None:
    if not 1 <= k <= limit:
        raise ValueError(f"{what} takes 1 <= k <= {limit}, got k={k}")


def _pad_queries(queries, qtile: int | None):
    """Zero rows up to the reference's batch: a multiple of 8 (at least 8),
    or of `qtile` above it."""
    B = queries.shape[0]
    if qtile is None or B <= qtile:
        b_pad = max(8, -(-B // 8) * 8)
    else:
        b_pad = -(-B // qtile) * qtile
    if b_pad == B:
        return queries.contiguous()
    return torch.cat([queries, queries.new_zeros((b_pad - B,
                                                  queries.shape[1]))])


def _operand(x, exact: bool):
    """A product operand at the scan precision: as it is, or rounded to
    bf16 and held in f32, so that every product of two operands is exact in
    f32 and only the sum rounds."""
    return x if exact else x.to(torch.bfloat16).to(torch.float32)


def _plain_scores(vectors, norms_sq, valid, queries, *, similarity: str,
                  exact: bool, n_pad: int):
    """[B, n_pad] scores as the kernels compute them, dead and pad docs at
    -inf."""
    qsq = (queries * queries).sum(dim=1)
    dots = _operand(queries, exact) @ _operand(vectors, exact).T
    scores = _transform_scores(dots, qsq[:, None], norms_sq[None, :],
                               similarity)
    scores = torch.where(valid[None, :], scores, _NEG_INF)
    pad = n_pad - vectors.shape[0]
    if pad:
        scores = torch.cat([scores, scores.new_full((scores.shape[0], pad),
                                                    _NEG_INF)], dim=1)
    return scores


_declared: dict[str, ctypes.CDLL] = {}


def _library(name: str, signature: dict) -> ctypes.CDLL:
    """csrc/<name>.cu's library with its C signatures declared, once."""
    lib = _declared.get(name)
    if lib is None:
        lib = cuda_lib.load(name)
        for fn, (restype, argtypes) in signature.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _declared[name] = lib
    return lib


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# --------------------------------------------------------------------------
# K3: running top-k scan
# --------------------------------------------------------------------------


def plain_block_topk(vectors, norms_sq, valid, queries, *, k: int,
                     similarity: str):
    """Plain K3: the full scores and a stable top-k. (vals [B, k],
    ids [B, k] int32) with (-inf, -1) past the valid count."""
    n_pad = -(-vectors.shape[0] // BLOCK) * BLOCK
    scores = _plain_scores(vectors, norms_sq, valid, queries,
                           similarity=similarity, exact=True, n_pad=n_pad)
    vals, ids = stable_topk(scores, k)
    return vals, torch.where(vals > _NEG_INF, ids, -1).to(torch.int32)


def block_tier(k: int) -> str:
    """K3's kernel design, K1's at fp32 r = k: "lists" (the list scan of
    csrc/knn_pool.cuh) at k <= LIST_MAX_R, else "wide" (its wide tier,
    csrc/knn_wide.cuh, up to BLOCK_MAX_K). A choice by shape alone."""
    return "lists" if k <= LIST_MAX_R else "wide"


def _block_library() -> ctypes.CDLL:
    """csrc/knn_block.cu's library: K3's tile scan, list scan and wide
    tier."""
    return _library("knn_block", {
        "knn_block_smem_bytes": (ctypes.c_size_t, [ctypes.c_int] * 2),
        "knn_block_launch": (ctypes.c_int, [ctypes.c_void_p] * 9
                             + [ctypes.c_int] * 7 + [ctypes.c_void_p]),
        "knn_block_lists_smem_bytes": (ctypes.c_size_t, [ctypes.c_int] * 4),
        "knn_block_lists_launch": (ctypes.c_int, [ctypes.c_void_p] * 9
                                   + [ctypes.c_int] * 10 + [ctypes.c_void_p]),
        "knn_block_wide_smem_bytes": (ctypes.c_size_t, [ctypes.c_int] * 6),
        "knn_block_wide_launch": (ctypes.c_int, [ctypes.c_void_p] * 9
                                  + [ctypes.c_int] * 11 + [ctypes.c_void_p]),
    })


def _launch_block(vectors, norms_sq, valid, queries, *, k: int,
                  similarity: str):
    """Launch the design :func:`block_tier` picks."""
    lib = _block_library()
    qsq = (queries * queries).sum(dim=1)
    if block_tier(k) == "lists":
        vals, ids = launch_lists(lib.knn_block_lists_launch,
                                 lib.knn_block_lists_smem_bytes,
                                 vectors[None], norms_sq[None], valid[None],
                                 queries, qsq, r=k, similarity=similarity)
        block_list_launches.add()
    else:
        vals, ids = launch_wide(lib.knn_block_wide_launch,
                                lib.knn_block_wide_smem_bytes, vectors[None],
                                norms_sq[None], valid[None], queries, qsq,
                                r=k, similarity=similarity)
        block_wide_launches.add()
    block_launches.add()
    return vals[0], ids[0]


def _launch_block_tile(  # tpulint: disable=TPU016 - timing yardstick, CUDA only
        vectors, norms_sq, valid, queries, *, k: int, similarity: str):
    """Launch K3's tile scan (csrc/knn_tile.cuh), at any k <= 1024: no
    longer chosen by :func:`block_tier`, it is the yardstick the wide tier
    is timed against. Counted on ``block_launches``."""
    lib = _block_library()
    n, d = vectors.shape
    B = queries.shape[0]
    smem = lib.knn_block_smem_bytes(d, k)
    if smem > _MAX_SMEM:
        raise ValueError(f"knn_block needs {smem} bytes of shared memory at "
                         f"d={d}, k={k} (at most {_MAX_SMEM})")
    dev = vectors.device
    chunk, n_split = _launch_geometry(1, n, B, dev)
    qsq = (queries * queries).sum(dim=1)
    part_v = torch.empty((n_split, B, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_split, B, k), dtype=torch.int32, device=dev)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.knn_block_launch(
            vectors.data_ptr(), norms_sq.data_ptr(), valid.data_ptr(),
            queries.data_ptr(), qsq.data_ptr(), part_v.data_ptr(),
            part_i.data_ptr(), vals.data_ptr(), ids.data_ptr(),
            n, d, B, k, _SIM_CODE[similarity], chunk, n_split, _stream(dev))
    if err != 0:
        raise RuntimeError(f"knn_block launch failed: cudaError {err}")
    block_launches.add()
    return vals, ids


def block_topk(vectors, norms_sq, valid, queries, *, k: int,
               similarity: str = "l2_norm"):
    """K3 over the batch: the kernel for CUDA tensors (the list scan at
    k <= 32, its wide tier above: :func:`block_tier`), the plain version
    for CPU tensors."""
    if vectors.device.type == "cuda":
        return _launch_block(vectors, norms_sq, valid, queries, k=k,
                             similarity=similarity)
    return plain_block_topk(vectors, norms_sq, valid, queries, k=k,
                            similarity=similarity)


def knn_topk_auto(vectors, norms_sq, valid, queries, *, k: int,
                  similarity: str = "l2_norm"):
    """Exact kNN through K3: (scores [B, k], ids [B, k] int32)."""
    _check_operands(vectors, norms_sq, valid, queries)
    _check_k(k, BLOCK_MAX_K, "knn_topk_auto")
    if similarity not in _SIM_CODE:
        raise ValueError(f"unknown similarity [{similarity}]")
    B = queries.shape[0]
    # the kernels take the caller's rows; the plain version the reference's
    # padded batch
    if vectors.device.type != "cuda":
        queries = _pad_queries(queries, None)
    vals, ids = block_topk(vectors.contiguous(), norms_sq.contiguous(),
                           valid.contiguous(), queries.contiguous(), k=k,
                           similarity=similarity)
    return vals[:B], ids[:B]


# --------------------------------------------------------------------------
# K4: per-block top-k, then the block-major merge
# --------------------------------------------------------------------------


def plain_pb_topk(vectors, norms_sq, valid, queries, *, k: int,
                  similarity: str, exact: bool = True):
    """Plain K4 stage 1: every 2048-doc block's own top-k, first maximum
    first, as (vals [nb, B, k], ids [nb, B, k] int32); -inf slots carry the
    block's first doc id, as the TPU kernel's argmax of an all -inf row
    does."""
    n_pad = -(-vectors.shape[0] // PB_BLOCK) * PB_BLOCK
    nb = n_pad // PB_BLOCK
    B = queries.shape[0]
    scores = _plain_scores(vectors, norms_sq, valid, queries,
                           similarity=similarity, exact=exact, n_pad=n_pad)
    vals, pos = stable_topk(scores.reshape(B, nb, PB_BLOCK), k)
    pos = torch.where(vals > _NEG_INF, pos, 0)
    base = torch.arange(nb, device=pos.device)[None, :, None] * PB_BLOCK
    return (vals.permute(1, 0, 2).contiguous(),
            (base + pos).to(torch.int32).permute(1, 0, 2).contiguous())


def pb_plan(b_pad: int, d: int, k: int, smem_bytes) -> tuple[int, int]:
    """Stage 1's (query tile, tier) for a padded batch: the list tier (0)
    at k <= PB_LIST_K, with the query tile of :func:`sbmax_query_tile`
    stepped down until ``smem_bytes(qt, tier, d, k)`` fits; else the
    scores-in-shared-memory tier (1) at 8 queries."""
    if k <= PB_LIST_K:
        qt = sbmax_query_tile(b_pad)
        for tile in reversed(SBMAX_QTILES[:SBMAX_QTILES.index(qt) + 1]):
            if smem_bytes(tile, 0, d, k) <= _MAX_SMEM:
                return tile, 0
    smem = smem_bytes(SBMAX_QTILES[0], 1, d, k)
    if smem <= _MAX_SMEM:
        return SBMAX_QTILES[0], 1
    raise ValueError(f"knn_pb needs {smem} bytes of shared memory at d={d} "
                     f"(at most {_MAX_SMEM})")


def _check_rows(rows: int, B: int) -> None:
    if not 1 <= rows <= B:
        raise ValueError(f"rows must be in [1, {B}], got {rows}")


def _pb_library() -> ctypes.CDLL:
    return _library("knn_pb", {
        "knn_pb_smem_bytes": (ctypes.c_size_t, [ctypes.c_int] * 4),
        "knn_pb_launch": (ctypes.c_int, [ctypes.c_void_p] * 7
                          + [ctypes.c_int] * 10 + [ctypes.c_void_p]),
        "knn_pb_merge_smem_bytes": (ctypes.c_size_t, [ctypes.c_int] * 3),
        "knn_pb_merge_launch": (ctypes.c_int, [ctypes.c_void_p] * 4
                                + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
    })


def _launch_pb(vectors, norms_sq, valid, queries, *, k: int, similarity: str,
               exact: bool, rows: int):
    lib = _pb_library()
    qsq = (queries * queries).sum(dim=1)
    vectors, queries = rows_in_16_bytes(vectors, queries)
    n, d = vectors.shape
    B = queries.shape[0]
    _check_rows(rows, B)
    qt, tier = pb_plan(B, d, k, lib.knn_pb_smem_bytes)
    nb = -(-n // PB_BLOCK)
    dev = vectors.device
    vals = torch.empty((nb, B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((nb, B, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.knn_pb_launch(
            vectors.data_ptr(), norms_sq.data_ptr(), valid.data_ptr(),
            queries.data_ptr(), qsq.data_ptr(), vals.data_ptr(),
            ids.data_ptr(), n, d, B, rows, nb, k, qt, tier,
            _SIM_CODE[similarity], int(exact), _stream(dev))
    if err != 0:
        raise RuntimeError(f"knn_pb launch failed: cudaError {err}")
    pb_launches.add()
    return vals, ids


def pb_topk(vectors, norms_sq, valid, queries, *, k: int,
            similarity: str = "l2_norm", exact: bool = True,
            rows: int | None = None):
    """K4 stage 1 over the (padded) batch: the kernel for CUDA tensors, the
    plain version for CPU tensors. ``rows`` (default all) limits the kernel
    to the first queries: the rows past it, pad rows the caller drops, are
    left unwritten."""
    if vectors.device.type == "cuda":
        return _launch_pb(vectors, norms_sq, valid, queries, k=k,
                          similarity=similarity, exact=exact,
                          rows=queries.shape[0] if rows is None else rows)
    return plain_pb_topk(vectors, norms_sq, valid, queries, k=k,
                         similarity=similarity, exact=exact)


def pb_merge(vals, ids, k: int):
    """Plain K4 stage 2: a stable top-k over [B, nb * k] in block-major
    order, so a tie goes to the lower block, then the lower rank inside it;
    non-finite winners get id -1."""
    nb, B, _k = vals.shape
    fv = vals.permute(1, 0, 2).reshape(B, nb * k)
    fi = ids.permute(1, 0, 2).reshape(B, nb * k)
    top_vals, pos = stable_topk(fv, k)
    top_ids = torch.gather(fi, 1, pos)
    return top_vals, torch.where(torch.isfinite(top_vals), top_ids, -1)


def _launch_pb_merge(vals, ids, k: int, rows: int):
    lib = _pb_library()
    nb, B, _k = vals.shape
    _check_rows(rows, B)
    row = int(lib.knn_pb_merge_smem_bytes(nb, k, 1) <= PB_MERGE_SMEM)
    dev = vals.device
    top_vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    top_ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.knn_pb_merge_launch(vals.data_ptr(), ids.data_ptr(),
                                      top_vals.data_ptr(), top_ids.data_ptr(),
                                      B, rows, nb, k, row, _stream(dev))
    if err != 0:
        raise RuntimeError(f"knn_pb merge launch failed: cudaError {err}")
    pb_merge_launches.add()
    return top_vals, top_ids


def pb_select(vals, ids, k: int, rows: int | None = None):
    """K4 stage 2 over the (padded) batch: the merge kernel for CUDA
    tensors, :func:`pb_merge` for CPU tensors. ``rows`` as for
    :func:`pb_topk`."""
    if vals.device.type == "cuda":
        return _launch_pb_merge(vals.contiguous(), ids.contiguous(), k,
                                vals.shape[1] if rows is None else rows)
    return pb_merge(vals, ids, k)


def knn_blocktopk_auto(vectors, norms_sq, valid, queries, *, k: int,
                       similarity: str = "l2_norm", exact: bool = True):
    """Exact kNN through K4 and its merge: (scores [B, k], ids [B, k]
    int32)."""
    _check_operands(vectors, norms_sq, valid, queries)
    _check_k(k, PB_MAX_K, "knn_blocktopk_auto")
    if similarity not in _SIM_CODE:
        raise ValueError(f"unknown similarity [{similarity}]")
    B = queries.shape[0]
    vals, ids = pb_topk(vectors.contiguous(), norms_sq.contiguous(),
                        valid.contiguous(), _pad_queries(queries, PB_QTILE),
                        k=k, similarity=similarity, exact=exact, rows=B)
    vals, ids = pb_select(vals, ids, k, rows=B)
    return vals[:B], ids[:B]


# --------------------------------------------------------------------------
# K5: sub-block maxima, then selection and an exact rescore
# --------------------------------------------------------------------------


def plain_sbmax(vectors, norms_sq, valid, queries, *, similarity: str,
                exact: bool = True):
    """Plain K5 stage 1: the maximum score of every 128-doc sub-block, as
    [nb, B, PB_BLOCK // SUB] f32."""
    n_pad = -(-vectors.shape[0] // PB_BLOCK) * PB_BLOCK
    nb = n_pad // PB_BLOCK
    B = queries.shape[0]
    scores = _plain_scores(vectors, norms_sq, valid, queries,
                           similarity=similarity, exact=exact, n_pad=n_pad)
    submax = scores.reshape(B, nb, PB_BLOCK // SUB, SUB).amax(dim=-1)
    return submax.permute(1, 0, 2).contiguous()


def _sbmax_library() -> ctypes.CDLL:
    return _library("knn_sbmax", {
        "knn_sbmax_smem_bytes": (ctypes.c_size_t, [ctypes.c_int] * 2),
        "knn_sbmax_launch": (ctypes.c_int, [ctypes.c_void_p] * 6
                             + [ctypes.c_int] * 7 + [ctypes.c_void_p]),
        "knn_sbmax_select_smem_bytes": (ctypes.c_size_t, [ctypes.c_int] * 5),
        "knn_sbmax_select_launch": (ctypes.c_int, [ctypes.c_void_p] * 11
                                    + [ctypes.c_int] * 8
                                    + [ctypes.c_void_p]),
    })


def _launch_sbmax(vectors, norms_sq, valid, queries, qsq, *, similarity: str,
                  exact: bool):
    lib = _sbmax_library()
    vectors, queries = rows_in_16_bytes(vectors, queries)
    n, d = vectors.shape
    B = queries.shape[0]
    qt = sbmax_query_tile(B)
    # a wide row may not fit the large tiles: step down, 8 rows at least
    while lib.knn_sbmax_smem_bytes(qt, d) > _MAX_SMEM and qt > SBMAX_QTILES[0]:
        qt = SBMAX_QTILES[SBMAX_QTILES.index(qt) - 1]
    smem = lib.knn_sbmax_smem_bytes(qt, d)
    if smem > _MAX_SMEM:
        raise ValueError(f"knn_sbmax needs {smem} bytes of shared memory at "
                         f"d={d} (at most {_MAX_SMEM})")
    nb = -(-n // PB_BLOCK)
    dev = vectors.device
    out = torch.empty((nb, B, PB_BLOCK // SUB), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        err = lib.knn_sbmax_launch(
            vectors.data_ptr(), norms_sq.data_ptr(), valid.data_ptr(),
            queries.data_ptr(), qsq.data_ptr(), out.data_ptr(),
            n, d, B, nb, qt, _SIM_CODE[similarity], int(exact), _stream(dev))
    if err != 0:
        raise RuntimeError(f"knn_sbmax launch failed: cudaError {err}")
    sbmax_launches.add()
    return out


def sbmax(vectors, norms_sq, valid, queries, *, similarity: str = "l2_norm",
          exact: bool = True, qsq=None):
    """K5 stage 1 over the (padded) batch: the kernel for CUDA tensors, the
    plain version for CPU tensors. ``qsq`` ([B] |q|^2), when the caller has
    it, spares the kernel path a reduction; the plain version computes its
    own."""
    if vectors.device.type == "cuda":
        if qsq is None:
            qsq = (queries * queries).sum(dim=1)
        return _launch_sbmax(vectors, norms_sq, valid, queries, qsq,
                             similarity=similarity, exact=exact)
    return plain_sbmax(vectors, norms_sq, valid, queries,
                       similarity=similarity, exact=exact)


def _launch_sbmax_select(submax, vectors, norms_sq, valid, queries, qsq, *,
                         k: int, similarity: str, exact: bool):
    lib = _sbmax_library()
    vectors, queries = rows_in_16_bytes(vectors, queries)
    n, d = vectors.shape
    nb, B, _subs = submax.shape
    dev = vectors.device
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    ids = torch.empty((B, k), dtype=torch.int32, device=dev)
    n_sub = nb * (PB_BLOCK // SUB)
    # shared memory first for the row of maxima, then for the k arrays
    row, use_scratch = next(
        ((r, sc) for r, sc in ((1, 0), (1, 1), (0, 1))
         if lib.knn_sbmax_select_smem_bytes(d, k, n_sub, r, sc)
         <= SBMAX_SELECT_SMEM), (0, 1))
    smem = lib.knn_sbmax_select_smem_bytes(d, k, n_sub, row, use_scratch)
    if smem > _MAX_SMEM:
        raise ValueError(f"knn_sbmax selection needs {smem} bytes of shared "
                         f"memory at d={d} (at most {_MAX_SMEM})")
    scratch = (None, None, None)
    if use_scratch:
        # the selected sub-blocks, candidate scores and winners of each
        # query go to device memory
        scratch = (torch.empty((B, k), dtype=torch.int32, device=dev),
                   torch.empty((B, k * SUB), dtype=torch.float32, device=dev),
                   torch.empty((B, k), dtype=torch.int32, device=dev))
    with torch.cuda.device(dev):
        err = lib.knn_sbmax_select_launch(
            submax.data_ptr(), vectors.data_ptr(), norms_sq.data_ptr(),
            valid.data_ptr(), queries.data_ptr(), qsq.data_ptr(),
            vals.data_ptr(), ids.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in scratch),
            n, d, B, nb, k, _SIM_CODE[similarity], int(exact), row,
            _stream(dev))
    if err != 0:
        raise RuntimeError(f"knn_sbmax selection launch failed: cudaError "
                           f"{err}")
    sbmax_select_launches.add()
    return vals, ids


def sbmax_select(submax, vectors, norms_sq, valid, queries, *, k: int,
                 similarity: str = "l2_norm", exact: bool = True, qsq=None):
    """K5 stage 2 over the (padded) batch: the selection kernel for CUDA
    tensors, :func:`sbmax_rescore` for CPU tensors."""
    if vectors.device.type == "cuda":
        if qsq is None:
            qsq = (queries * queries).sum(dim=1)
        return _launch_sbmax_select(submax.contiguous(), vectors, norms_sq,
                                    valid, queries, qsq, k=k,
                                    similarity=similarity, exact=exact)
    return sbmax_rescore(submax, vectors, norms_sq, valid, queries, k=k,
                         similarity=similarity, exact=exact)


def sbmax_rescore(submax, vectors, norms_sq, valid, queries, *, k: int,
                  similarity: str, exact: bool = True):
    """Plain K5 stage 2: the k sub-blocks with the largest maxima (ties to
    the lower one) hold every top-k doc; their ids sorted ascending keep the
    candidates doc-id-major, so the stable top-k of the rescored
    candidates sends ties to the lower doc id. Candidates past n are pad
    rows: dead, and clamped before the gather."""
    nb, B, subs = submax.shape
    n = vectors.shape[0]
    flat = submax.permute(1, 0, 2).reshape(B, nb * subs)
    _, sb_ids = stable_topk(flat, k)
    sb_ids = torch.sort(sb_ids, dim=1).values
    cand = (sb_ids[:, :, None] * SUB
            + torch.arange(SUB, device=sb_ids.device)[None, None, :])
    cand = cand.reshape(B, k * SUB)
    safe = torch.clamp(cand, max=n - 1)
    dots = torch.einsum("bd,bcd->bc", _operand(queries, exact),
                        _operand(vectors[safe], exact))
    qsq = (queries * queries).sum(dim=1, keepdim=True)
    scores = _transform_scores(dots, qsq, norms_sq[safe], similarity)
    scores = torch.where((cand < n) & valid[safe], scores, _NEG_INF)
    vals, pos = stable_topk(scores, k)
    ids = torch.gather(cand, 1, pos)
    return vals, torch.where(torch.isfinite(vals), ids, -1).to(torch.int32)


def knn_sbmax_auto(vectors, norms_sq, valid, queries, *, k: int,
                   similarity: str = "l2_norm", exact: bool = True):
    """Exact kNN through K5, its selection and its rescore: (scores [B, k],
    ids [B, k] int32). k may not exceed the sub-block count, as the
    reference's top_k over the maxima would not."""
    _check_operands(vectors, norms_sq, valid, queries)
    n_sub = -(-vectors.shape[0] // PB_BLOCK) * (PB_BLOCK // SUB)
    _check_k(k, n_sub, "knn_sbmax_auto")
    if similarity not in _SIM_CODE:
        raise ValueError(f"unknown similarity [{similarity}]")
    B = queries.shape[0]
    vectors, norms_sq, valid = (vectors.contiguous(), norms_sq.contiguous(),
                                valid.contiguous())
    q = _pad_queries(queries, PB_QTILE)
    qsq = (q * q).sum(dim=1)
    submax = sbmax(vectors, norms_sq, valid, q, similarity=similarity,
                   exact=exact, qsq=qsq)
    vals, ids = sbmax_select(submax, vectors, norms_sq, valid, q, k=k,
                             similarity=similarity, exact=exact, qsq=qsq)
    return vals[:B], ids[:B]
