"""Fused exact kNN: the scan kernel for Hopper, its plain version, and the
end-to-end wrappers.

Counterpart of opensearch_tpu/ops/pallas_knn.py (the fused path: the
Pallas kernel ``_knn_fused_kernel`` and ``knn_fused`` /
``knn_fused_shard`` / ``knn_fused_auto`` around it). The kernel is
``csrc/knn_fused.cu``; its note says what bounds it and how it is laid
out.

A scan returns, per shard and query, the top-R pool under
(score desc, doc id asc) with (-inf, -1) past the valid-doc count. Three
score precisions:

  fp32  full float32 dots, R = k, no rescore;
  bf16  operands cast to bf16, f32 accumulate; R = 4k (floor 32, cap 512)
        and an exact fp32 rescore;
  int8  symmetric per-tensor int8, exact int32 dots times one scalar;
        R = 4k and an exact fp32 rescore.

Returned scores are in the serving fp32 score space at every precision.

Dispatch: :func:`pool_scan` launches the kernel for CUDA tensors (or
raises) and runs :func:`plain_pool` for CPU tensors. The policy value
"pallas" means the kernel, "xla" the plain version, as in the reference.

The kernel has five designs, chosen by (precision, r) in
:func:`scan_tier`, never on failure: at fp32 with r <= ``LIST_MAX_R`` the
list scan (``csrc/knn_pool.cuh``: a cp.async ring, 4 x 8 FFMA micro-tiles,
per-warp lists carried across each CTA's contiguous doc range, then a
CTA-per-query split merge), counted on ``list_launches`` too; at fp32 with
LIST_MAX_R < r <= ``WIDE_MAX_R`` its wide tier (``csrc/knn_wide.cuh``: the
same scan at 8-query tiles, a CTA-wide pool of r a query fed through a
candidate buffer and a radix select, then a select-then-sort split merge),
counted on ``wide_launches`` too; at bf16 and int8 with r <= WIDE_MAX_R
(every reduced-precision serving search) the wide tier's tensor-core scan
(``csrc/knn_wide_mma.cuh``: the same ring, step, selection and merge, the
dots by ``mma.sync``), counted on ``mma_launches`` too; at fp32 with
r > WIDE_MAX_R its large-r tier (``csrc/knn_large.cuh``: the same scan
storing each (query, doc)'s score key, then a radix select and sort of
the r best of each (shard, query) row by many CTAs a row,
:func:`large_select`), counted on ``large_launches`` too; at bf16
and int8 with r > WIDE_MAX_R (a reduced-precision k above 1024) the
large-r tier behind the tensor-core tier's dots
(``csrc/knn_large_mma.cuh``: each key is the bits the tensor-core tier
scores the doc with, then the same select), counted on
``large_launches`` and ``large_mma_launches`` too. The stacked serving
step reaches the large-r tier, since it asks for r = k_shard =
min(k, n_flat) with no cap, as the reference does. The tile scan
(``csrc/knn_tile.cuh``, :func:`_launch_tile`, counted on
``tile_launches``) serves no shape: it is the yardstick timed beside the
designs. The range scans read rows in 16-byte units:
:func:`rows_in_16_bytes` pads d with zero columns to whole units and
copies an unaligned operand first.

The exact fp32 rescore of a reduced-precision pool and every |q|^2 go
through ``ops/knn_rescore`` (``csrc/knn_rescore.cu``), which sums each dot
in one order whatever the batch, so a batched search gets the bits of a
solo one.

:func:`knn_fused_stacked` and :func:`knn_fused_auto` are profiled
(search/profile.profiled_kernel) as the reference's "knn_fused_pallas".
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from opensearch_tpu_torch import backend  # noqa: F401  (pins float32)
from opensearch_tpu_torch.ops import cuda_lib, knn_rescore
from opensearch_tpu_torch.ops.topk import stable_topk
from opensearch_tpu_torch.search.profile import profiled_kernel

FK_BLOCK = 1024   # the reference's doc block: fixes n_pad, hence k_eff and R
FUSED_MAX_K = 128
FUSED_RESCORE_MULT = 4
SCORE_PRECISIONS = ("fp32", "bf16", "int8")
KERNEL_IMPLS = ("pallas", "xla")

_PREC_CODE = {"fp32": 0, "bf16": 1, "int8": 2}
_SIM_CODE = {"l2_norm": 0, "cosine": 1, "dot_product": 2}
_OPERAND_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16,
                  "int8": torch.int8}
_NEG_INF = float("-inf")
# shared memory one CTA may use on Hopper (opt-in maximum)
_MAX_SMEM = 232_448
# the tile scan's query tile and doc tile (kQB, kTD in csrc/knn_tile.cuh)
_QUERY_TILE = 16
_DOC_TILE = 64
# the list scan (csrc/knn_pool.cuh): its largest r, its query tiles, its
# (query tile, ring stages) plans, and the sub-block its ranges are cut at
LIST_MAX_R = 32
QUERY_TILES = (8, 32, 128)
LIST_PLANS = ((8, 3), (8, 2), (32, 3), (128, 4))
LIST_SUB = 128
_MAX_GRID = 65_535
# the wide tier (csrc/knn_wide.cuh) and its tensor-core scan
# (csrc/knn_wide_mma.cuh): their largest r, their query tile, their rings
# (stages, 32-bit words a stage: f32, or 2 bf16 or 4 int8) in order of
# preference, the docs of one step (the least buffer a query: no step can
# overflow it) and the largest buffer they are given
WIDE_MAX_R = 1024
WIDE_QUERY_TILE = 8
WIDE_RINGS = ((3, 16384), (2, 16384), (2, 8192))
WIDE_STEP = 1024
WIDE_MAX_CAP = 4096
# the large-r tier's select (csrc/knn_large.cuh): its sorts (the C code's
# order), the keys a tile CTA sorts, the winners a rank CTA counts for and
# the least slice it counts them over, and the largest r its plan sorts
# by rank (on the card the rank's r^2 compares beat the tiles and merge
# rounds at 10,000 winners and lose at 20,000: PERF.md)
LARGE_SORTS = ("merge", "rank")
LARGE_TILE = 4096
_RANK_BLOCK = 1024
_RANK_MIN_SPAN = 64
LARGE_RANK_MAX_R = 3 * LARGE_TILE

# launches of the kernel made by pool_scan or _launch_tile (any design),
# and of the list scan, of its wide tier, of the wide tier's tensor-core
# scan, of the large-r tier (any precision), of the large-r tier's
# tensor-core scan, of the tile scan alone, of the large-r tier's
# multi-CTA select and of its one-CTA yardstick
launches = cuda_lib.LaunchCounter()
list_launches = cuda_lib.LaunchCounter()
wide_launches = cuda_lib.LaunchCounter()
mma_launches = cuda_lib.LaunchCounter()
large_launches = cuda_lib.LaunchCounter()
large_mma_launches = cuda_lib.LaunchCounter()
tile_launches = cuda_lib.LaunchCounter()
large_select_launches = cuda_lib.LaunchCounter()
yardstick_launches = cuda_lib.LaunchCounter()


def fused_pool_width(k: int, score_precision: str) -> int:
    """Pool width R carried through the scan. fp32 needs no rescore slack;
    reduced precisions keep a 4x pool (floor 32) so quantization rank
    noise around position k stays inside the exact-rescore candidate set."""
    if score_precision == "fp32":
        return k
    return max(k, min(max(FUSED_RESCORE_MULT * k, 32), 512))


def _check_precision(score_precision: str) -> None:
    if score_precision not in SCORE_PRECISIONS:
        raise ValueError(
            f"unknown score precision [{score_precision}]; "
            f"expected one of {SCORE_PRECISIONS}"
        )


def quantize_symmetric_int8(x: torch.Tensor):
    """Per-tensor symmetric int8: scale = max|x| / 127 (zero-guarded).
    Returns (q int8, scale f32 scalar) with x ~= q * scale. torch.round
    rounds half to even, as jnp.round does."""
    scale = torch.clamp(x.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)
    return q, scale.to(torch.float32)


def int8_query_scale(vector) -> float:
    """The scale :func:`quantize_symmetric_int8` gives one query row
    alone (max|q| / 127 in float32, zero-guarded): a batch of rows that
    share it quantizes each row as it would be quantized alone."""
    peak = np.float32(np.abs(np.asarray(vector, np.float32)).max(initial=0))
    return float(max(peak, np.float32(1e-30)) / np.float32(127.0))


def _prep_operands(vectors, queries, score_precision: str):
    """Cast/quantize the matmul operands once, OUTSIDE the kernel, so the
    kernel and the plain version consume bit-identical inputs.
    vectors is [S, n, d]; each shard is quantized on its own (the reference
    scans shard by shard). Returns (v_x [S, n, d], q_x [B, d], scale [S])
    where dots_f32 = dot(q_x, v_x[s]) * scale[s]."""
    S = vectors.shape[0]
    if score_precision == "int8":
        q_x, sq = quantize_symmetric_int8(queries)
        per = [quantize_symmetric_int8(vectors[s]) for s in range(S)]
        v_x = torch.stack([p[0] for p in per])
        scale = torch.stack([sq * p[1] for p in per])
        return v_x, q_x, scale
    one = torch.ones(S, dtype=torch.float32, device=vectors.device)
    if score_precision == "bf16":
        return vectors.to(torch.bfloat16), queries.to(torch.bfloat16), one
    return vectors, queries, one


def _fused_dots(q_x, v_x, score_precision: str, scale):
    """[B, d] x [S, n, d] -> [S, B, n] f32 dots under the scan precision.
    int8 contracts exactly (float64 holds every int8 dot of d < 2^37
    exactly; torch has no CUDA int32 matmul), then one scalar multiply per
    shard; bf16 products are exact in f32 and sum in f32; fp32 is full
    float32. On the CPU, where this version serves searches, the f32 sums
    take one product a query, so a query's dots are the same bits whatever
    batch it rides in, and a shard's dots are one product of its own
    [n, d] rows, the same bits whatever shards it is stacked with (a
    mesh slot's group or the whole node's), as the kernel's are on the
    card (there this version is the kernel's yardstick and keeps the one
    batched product)."""
    if score_precision == "int8":
        dots = torch.einsum("bd,snd->sbn", q_x.to(torch.float64),
                            v_x.to(torch.float64))
        return dots.to(torch.int32).to(torch.float32) * scale[:, None, None]
    v_f = v_x.to(torch.float32)
    q_f = q_x.to(torch.float32)
    if v_f.device.type != "cpu" or q_f.shape[0] == 0:
        return torch.einsum("bd,snd->sbn", q_f, v_f)
    return torch.stack([torch.stack([torch.mv(v_s, q) for v_s in v_f])
                        for q in q_f], 1)


def _transform_scores(dots, qsq, nsq, similarity: str):
    """OpenSearch k-NN score-space transforms, one eager operation at a
    time (the kernel rounds the same way). qsq and nsq broadcast against
    dots."""
    if similarity == "l2_norm":
        d_sq = torch.clamp(qsq - 2.0 * dots + nsq, min=0.0)
        return 1.0 / (1.0 + d_sq)
    if similarity == "cosine":
        q_norm = torch.sqrt(torch.clamp(qsq, min=1e-24))
        v_norm = torch.sqrt(torch.clamp(nsq, min=1e-24))
        return (1.0 + dots / (q_norm * v_norm)) / 2.0
    return torch.where(dots >= 0, dots + 1.0, 1.0 / (1.0 - dots))


def plain_pool(v_x, norms_sq, valid, q_x, qsq, scale, *, r: int,
               similarity: str, score_precision: str):
    """Plain PyTorch pool scan (counterpart of ``_fused_xla_pool``): full
    [S, B, n] scores and a stable top-r. Returns (vals [S, B, r],
    ids [S, B, r] int32) with (-inf, -1) past the valid count."""
    dots = _fused_dots(q_x, v_x, score_precision, scale)
    scores = _transform_scores(dots, qsq[None, :, None], norms_sq[:, None, :],
                               similarity)
    scores = torch.where(valid[:, None, :], scores, _NEG_INF)
    vals, ids = stable_topk(scores, r)
    ids = torch.where(vals > _NEG_INF, ids, -1).to(torch.int32)
    return vals, ids


def _check_kernel_operands(v_x, norms_sq, valid, q_x, qsq, scale, r,
                           similarity, score_precision) -> None:
    dev = v_x.device
    S, n, d = v_x.shape
    B = q_x.shape[0]
    want = {
        "v_x": (v_x, (S, n, d), _OPERAND_DTYPE[score_precision]),
        "norms_sq": (norms_sq, (S, n), torch.float32),
        "valid": (valid, (S, n), torch.bool),
        "q_x": (q_x, (B, d), _OPERAND_DTYPE[score_precision]),
        "qsq": (qsq, (B,), torch.float32),
        "scale": (scale, (S,), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if t.device != dev:
            raise ValueError(f"[{name}] is on {t.device}, expected {dev}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"[{name}] is {t.dtype}{tuple(t.shape)}, expected "
                f"{dtype}{shape}")
        if not t.is_contiguous():
            raise ValueError(f"[{name}] must be contiguous")
    if similarity not in _SIM_CODE:
        raise ValueError(f"unknown similarity [{similarity}]")
    if n < 1 or B < 1 or d < 1 or r < 1:
        raise ValueError(f"unsupported shape n={n} B={B} d={d} r={r}")
    if S > 65_535 or -(-B // _QUERY_TILE) > 65_535:
        raise ValueError(f"grid too large: S={S} B={B}")


def scan_tier(score_precision: str, r: int) -> str:
    """The kernel design for a scan: "lists" (the list scan) at fp32 with
    r <= LIST_MAX_R, "wide" (its wide tier) at fp32 with r <= WIDE_MAX_R,
    "large" (the large-r tier) at fp32 past that, "mma" (the wide tier's
    tensor-core scan) at bf16 and int8 with r <= WIDE_MAX_R, "large_mma"
    (the large-r tier's tensor-core scan) at bf16 and int8 past that. A
    choice by shape alone."""
    if r > WIDE_MAX_R:
        return "large" if score_precision == "fp32" else "large_mma"
    if score_precision != "fp32":
        return "mma"
    return "lists" if r <= LIST_MAX_R else "wide"


def query_tile(b: int) -> int:
    """The list scan's query tile for a batch of b: the smallest of
    ``QUERY_TILES`` that holds it, the largest above."""
    for qt in QUERY_TILES:
        if b <= qt:
            return qt
    return QUERY_TILES[-1]


def list_plan(b: int, d: int, r: int, smem_bytes) -> tuple[int, int]:
    """(query tile, ring stages) of the list scan: the query tile of
    :func:`query_tile`, stepped down until ``smem_bytes(qt, stages, d, r)``
    fits, the two-stage ring at 8 queries last; raises ValueError when no
    plan fits."""
    qt = query_tile(b)
    plans = [p for p in LIST_PLANS if p[0] <= qt
             and 0 < smem_bytes(p[0], p[1], d, r) <= _MAX_SMEM]
    if not plans:
        raise ValueError(f"the list scan needs more than {_MAX_SMEM} bytes "
                         f"of shared memory at d={d}, r={r}")
    return max(plans, key=lambda p: (p[0], p[1]))


def _ring_plan(b: int, smem_bytes, what: str) -> tuple[int, int, int]:
    """The first ring (stages, 32-bit words a stage) of ``WIDE_RINGS``
    beside which min(8, b) queries' pools and buffers of at least
    ``WIDE_STEP`` pairs fit ``smem_bytes(stages, words, rows, cap)``, with
    the buffer capacity as large as the rest allows, in whole 128s, up to
    ``WIDE_MAX_CAP``; raises ValueError when none fits."""
    rows = min(WIDE_QUERY_TILE, b)
    for stages, words in WIDE_RINGS:
        base = smem_bytes(stages, words, rows, 0)
        if base <= 0:
            continue
        per = smem_bytes(stages, words, rows, 1) - base
        cap = min(WIDE_MAX_CAP, (_MAX_SMEM - base) // per // 128 * 128)
        if cap >= WIDE_STEP:
            return stages, words, cap
    raise ValueError(f"{what} needs more than {_MAX_SMEM} bytes of shared "
                     f"memory")


def wide_plan(b: int, d: int, r: int, smem_bytes) -> tuple[int, int, int]:
    """(ring stages, floats a stage, buffer capacity) of the wide tier for a
    batch of b over f32 rows of d: :func:`_ring_plan` under
    ``smem_bytes(stages, floats, d, r, rows, cap)``."""
    return _ring_plan(
        b, lambda stages, floats, rows, cap: smem_bytes(
            stages, floats, d, r, rows, cap),
        f"the wide tier at d={d}, r={r}")


def wide_mma_plan(b: int, d: int, r: int, score_precision: str,
                  smem_bytes) -> tuple[int, int, int]:
    """(ring stages, words a stage, buffer capacity) of the wide tier's
    tensor-core scan for a batch of b over rows of d bf16 or int8 elements:
    :func:`_ring_plan` under ``smem_bytes(prec, stages, words, d, r, rows,
    cap)`` (the C entry point's, prec its code). A stage's words hold 1,024
    rows of a d chunk of 32-bit words: 2 bf16 or 4 int8 elements each."""
    prec = _PREC_CODE[score_precision]
    return _ring_plan(
        b, lambda stages, words, rows, cap: smem_bytes(
            prec, stages, words, d, r, rows, cap),
        f"the tensor-core tier at {score_precision} d={d}, r={r}")


def large_plan(d: int, smem_bytes,
               score_precision: str = "fp32") -> tuple[int, int]:
    """(ring stages, 32-bit words a stage) of the large-r tier's scan over
    rows of d elements: the first ring of ``WIDE_RINGS`` whose ring and
    8-query tile fit ``smem_bytes(stages, words, d)`` (at bf16 and int8
    the tensor-core scan's C entry point with its precision code bound
    first); raises ValueError when none does. r plays no part: the scan
    keeps no pool."""
    for stages, words in WIDE_RINGS:
        if 0 < smem_bytes(stages, words, d) <= _MAX_SMEM:
            return stages, words
    raise ValueError(f"the large-r tier's scan needs more than {_MAX_SMEM} "
                     f"bytes of shared memory for an 8-query tile at "
                     f"{score_precision} d={d}")


def list_geometry(S: int, n: int, n_qtiles: int, sms: int) -> tuple[int, int]:
    """(chunk, n_split) of the list scan: each shard cut into n_split
    contiguous ranges of chunk docs (a multiple of ``LIST_SUB``; the last
    range ragged), so that the (n_split, S, n_qtiles) grid is about one
    wave of one CTA an SM (its shared memory allows no second) and never
    more than one."""
    per_shard = max(1, sms // (S * n_qtiles))
    n_split = max(1, min(-(-n // LIST_SUB), per_shard))
    chunk = -(-(-(-n // n_split)) // LIST_SUB) * LIST_SUB
    return chunk, -(-n // chunk)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The card's SM count (read once a device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def rows_in_16_bytes(vectors, queries):
    """(vectors, queries) as the cp.async kernels read them: rows of whole
    16-byte units at 16-byte aligned addresses. A width that is not whole
    units pads with zero columns to a multiple of 4 f32, 8 bf16 or 16 int8
    (a zero column adds exact zero terms to every dot: bf16(0) and int8 0
    are zero); an operand that is not 16-byte aligned is copied. With whole
    units and aligned operands nothing is copied. Norms and |q|^2 are the
    caller's, from the unpadded rows. Vectors may carry a leading shard
    axis."""
    pad = -vectors.shape[-1] % (16 // vectors.element_size())
    if pad:
        return (torch.nn.functional.pad(vectors, (0, pad)),
                torch.nn.functional.pad(queries, (0, pad)))
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (vectors, queries))


def _launch_geometry(S: int, n: int, B: int, device) -> tuple[int, int]:
    """(chunk, n_split) of the tile scan: docs per CTA, a multiple of the
    64-doc tile, with about four CTAs per SM in the grid."""
    sms = sm_count(device)
    qtiles = -(-B // _QUERY_TILE)
    max_split = -(-n // _DOC_TILE)
    n_split = max(1, min(max_split, -(-4 * sms // (S * qtiles))))
    chunk = -(-(-(-n // n_split)) // _DOC_TILE) * _DOC_TILE
    return chunk, -(-n // chunk)


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (once: the
    declarations cost host time on every launch of a serving step)."""
    lib = cuda_lib.load("knn_fused")
    lib.knn_fused_smem_bytes.restype = ctypes.c_size_t
    lib.knn_fused_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.knn_fused_launch.restype = ctypes.c_int
    lib.knn_fused_launch.argtypes = ([ctypes.c_void_p] * 10
                                     + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.knn_fused_lists_smem_bytes.restype = ctypes.c_size_t
    lib.knn_fused_lists_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.knn_fused_lists_launch.restype = ctypes.c_int
    lib.knn_fused_lists_launch.argtypes = ([ctypes.c_void_p] * 9
                                           + [ctypes.c_int] * 10
                                           + [ctypes.c_void_p])
    lib.knn_fused_wide_smem_bytes.restype = ctypes.c_size_t
    lib.knn_fused_wide_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.knn_fused_wide_launch.restype = ctypes.c_int
    lib.knn_fused_wide_launch.argtypes = ([ctypes.c_void_p] * 9
                                          + [ctypes.c_int] * 11
                                          + [ctypes.c_void_p])
    lib.knn_fused_mma_smem_bytes.restype = ctypes.c_size_t
    lib.knn_fused_mma_smem_bytes.argtypes = [ctypes.c_int] * 7
    lib.knn_fused_mma_launch.restype = ctypes.c_int
    lib.knn_fused_mma_launch.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                                         + [ctypes.c_void_p] * 9
                                         + [ctypes.c_int] * 11
                                         + [ctypes.c_void_p])
    lib.knn_fused_large_smem_bytes.restype = ctypes.c_size_t
    lib.knn_fused_large_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.knn_fused_large_select_smem_bytes.restype = ctypes.c_size_t
    lib.knn_fused_large_select_smem_bytes.argtypes = []
    lib.knn_fused_large_state_words.restype = ctypes.c_int
    lib.knn_fused_large_state_words.argtypes = []
    lib.knn_fused_large_slice_bins.restype = ctypes.c_int
    lib.knn_fused_large_slice_bins.argtypes = []
    lib.knn_fused_large_scan_launch.restype = ctypes.c_int
    lib.knn_fused_large_scan_launch.argtypes = ([ctypes.c_void_p] * 6
                                                + [ctypes.c_int] * 9
                                                + [ctypes.c_void_p])
    lib.knn_fused_large_select_launch.restype = ctypes.c_int
    lib.knn_fused_large_select_launch.argtypes = ([ctypes.c_void_p] * 8
                                                  + [ctypes.c_int] * 8
                                                  + [ctypes.c_void_p])
    lib.knn_fused_large_yardstick_smem_bytes.restype = ctypes.c_size_t
    lib.knn_fused_large_yardstick_smem_bytes.argtypes = [ctypes.c_int]
    lib.knn_fused_large_yardstick_slots.restype = ctypes.c_int
    lib.knn_fused_large_yardstick_slots.argtypes = [ctypes.c_int]
    lib.knn_fused_large_yardstick_launch.restype = ctypes.c_int
    lib.knn_fused_large_yardstick_launch.argtypes = ([ctypes.c_void_p] * 5
                                                     + [ctypes.c_int] * 4
                                                     + [ctypes.c_void_p])
    lib.knn_fused_large_mma_smem_bytes.restype = ctypes.c_size_t
    lib.knn_fused_large_mma_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.knn_fused_large_mma_scan_launch.restype = ctypes.c_int
    lib.knn_fused_large_mma_scan_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
        + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    return lib


def _launch_ranges(launch, what: str, v, norms_sq, valid, q, qsq, *, r: int,
                   similarity: str, qt: int, plan: tuple):
    """One launch of a range scan (the list scan, its wide tier or the
    wide tier's tensor-core scan) on rows already in 16-byte units: the
    shards cut into ranges of about one wave for query tiles of qt,
    scratch and outputs allocated, and ``launch`` called with the plan's
    integers before (chunk, n_split)."""
    S, n, d = v.shape
    B = q.shape[0]
    if S > _MAX_GRID or -(-B // qt) > _MAX_GRID:
        raise ValueError(f"grid too large: S={S} B={B}")
    dev = v.device
    chunk, n_split = list_geometry(S, n, -(-B // qt), sm_count(dev))
    part_v = torch.empty((S, n_split, B, r), dtype=torch.float32, device=dev)
    part_i = torch.empty((S, n_split, B, r), dtype=torch.int32, device=dev)
    vals = torch.empty((S, B, r), dtype=torch.float32, device=dev)
    ids = torch.empty((S, B, r), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = launch(
            v.data_ptr(), norms_sq.data_ptr(), valid.data_ptr(),
            q.data_ptr(), qsq.data_ptr(), part_v.data_ptr(),
            part_i.data_ptr(), vals.data_ptr(), ids.data_ptr(), S, n, d, B,
            r, _SIM_CODE[similarity], *plan, chunk, n_split,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")
    return vals, ids


def launch_lists(launch, smem_bytes, v, norms_sq, valid, q, qsq, *, r: int,
                 similarity: str):
    """The list scan over [S, n, d] f32 shards through the C entry point
    ``launch`` (K1's or K3's): (vals [S, B, r], ids [S, B, r]). Pads and
    aligns the rows, plans the query tile and ring, and cuts the shards
    into ranges of about one wave."""
    v, q = rows_in_16_bytes(v, q)
    qt, stages = list_plan(q.shape[0], v.shape[2], r, smem_bytes)
    return _launch_ranges(launch, "list scan", v, norms_sq, valid, q, qsq,
                          r=r, similarity=similarity, qt=qt,
                          plan=(qt, stages))


def launch_wide(launch, smem_bytes, v, norms_sq, valid, q, qsq, *, r: int,
                similarity: str):
    """The wide tier over [S, n, d] f32 shards through the C entry point
    ``launch`` (K1's or K3's): (vals [S, B, r], ids [S, B, r]). Pads and
    aligns the rows, plans the ring and the buffer (:func:`wide_plan`), and
    cuts the shards into ranges of about one wave for 8-query tiles."""
    v, q = rows_in_16_bytes(v, q)
    plan = wide_plan(q.shape[0], v.shape[2], r, smem_bytes)
    return _launch_ranges(launch, "wide tier", v, norms_sq, valid, q, qsq,
                          r=r, similarity=similarity, qt=WIDE_QUERY_TILE,
                          plan=plan)


def launch_wide_mma(lib, v_x, norms_sq, valid, q_x, qsq, scale, *, r: int,
                    similarity: str, score_precision: str):
    """The wide tier's tensor-core scan over [S, n, d] bf16 or int8 shards
    through ``lib`` (K1's library): (vals [S, B, r], ids [S, B, r]). Pads
    and aligns the rows, plans the ring and the buffer
    (:func:`wide_mma_plan`), and cuts the shards into ranges of about one
    wave for 8-query tiles."""
    v, q = rows_in_16_bytes(v_x, q_x)
    plan = wide_mma_plan(q.shape[0], v.shape[2], r, score_precision,
                         lib.knn_fused_mma_smem_bytes)
    launch = functools.partial(lib.knn_fused_mma_launch, scale.data_ptr(),
                               _PREC_CODE[score_precision])
    return _launch_ranges(launch, "tensor-core tier", v, norms_sq, valid, q,
                          qsq, r=r, similarity=similarity,
                          qt=WIDE_QUERY_TILE, plan=plan)


def large_select_geometry(S: int, n: int, B: int,
                          sms: int) -> tuple[int, int]:
    """(G, chunk) of the large-r tier's multi-CTA select: each of the S * B
    rows cut into G slices of chunk docs (a multiple of 32; the last
    slice ragged), G about two waves of CTAs over the rows and at least 2
    wherever a row has more than 32 docs."""
    want = max(2, -(-2 * sms // (S * B)))
    chunk = -(-(-(-n // want)) // 32) * 32
    return -(-n // chunk), chunk


def large_sort_plan(r: int) -> str:
    """The select's sort at r: "rank" (each winner's slot counted by many
    CTAs, then placed) up to ``LARGE_RANK_MAX_R`` winners, "merge" (tiles of
    ``LARGE_TILE`` sorted in shared memory, then merge rounds) above."""
    return "rank" if r <= LARGE_RANK_MAX_R else "merge"


def rank_slices(S: int, B: int, r: int, sms: int) -> int:
    """C, the slices of the winners a rank CTA counts over: about two waves
    of CTAs in all (each CTA ``_RANK_BLOCK`` winners against one slice),
    with slices of at least ``_RANK_MIN_SPAN`` winners, so the ranks take
    few atomics."""
    blocks = -(-r // _RANK_BLOCK)
    return max(1, min(-(-r // _RANK_MIN_SPAN),
                      -(-2 * sms // (blocks * S * B))))


def large_keys(lib, v, norms_sq, valid, q, qsq, scale=None, *,
               similarity: str, score_precision: str = "fp32"):
    """The large-r tier's scan over [S, n, d] shards through ``lib`` (K1's
    library): every (query, doc)'s score key, keys [S, B, n] int32 (the
    u32 bits; 0 for a dead doc). f32 rows take its FFMA scan, bf16 and int8
    rows (with their per-shard ``scale``) its tensor-core scan. Pads and
    aligns the rows, plans the ring (:func:`large_plan`) and cuts the
    shards into ranges of about one wave for 8-query tiles."""
    v, q = rows_in_16_bytes(v, q)
    S, n, d = v.shape
    B = q.shape[0]
    if S > _MAX_GRID or -(-B // WIDE_QUERY_TILE) > _MAX_GRID:
        raise ValueError(f"grid too large: S={S} B={B}")
    if score_precision == "fp32":
        launch = lib.knn_fused_large_scan_launch
        stages, words = large_plan(d, lib.knn_fused_large_smem_bytes)
    else:
        prec = _PREC_CODE[score_precision]
        launch = functools.partial(lib.knn_fused_large_mma_scan_launch,
                                   scale.data_ptr(), prec)
        stages, words = large_plan(
            d, functools.partial(lib.knn_fused_large_mma_smem_bytes, prec),
            score_precision)
    dev = v.device
    chunk, n_split = list_geometry(S, n, -(-B // WIDE_QUERY_TILE),
                                   sm_count(dev))
    keys = torch.empty((S, B, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = launch(
            v.data_ptr(), norms_sq.data_ptr(), valid.data_ptr(),
            q.data_ptr(), qsq.data_ptr(), keys.data_ptr(), S, n, d, B,
            _SIM_CODE[similarity], stages, words, chunk, n_split,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"large-r tier scan failed: cudaError {err}")
    return keys


def large_select(lib, keys, r: int, sort: str | None = None):
    """The large-r tier's multi-CTA select through ``lib``: the r best of
    every (shard, query) row of keys [S, B, n] under (score desc, doc id
    asc), sorted, (vals [S, B, r], ids [S, B, r]) with (-inf, -1) past the
    live count. G CTAs a row (:func:`large_select_geometry`); the sort by
    :func:`large_sort_plan` unless ``sort`` names one. Allocates the rows'
    state (zeroed), each CTA's histogram of the last level, the winners
    and the sort's scratch."""
    S, B, n = keys.shape
    if S > _MAX_GRID or B > _MAX_GRID or r < 1:
        raise ValueError(f"unsupported select S={S} B={B} r={r}")
    smem = lib.knn_fused_large_select_smem_bytes()
    if smem > _MAX_SMEM:
        raise ValueError(f"the large-r tier's select needs {smem} bytes of "
                         f"shared memory (at most {_MAX_SMEM})")
    sort = sort or large_sort_plan(r)
    dev = keys.device
    sms = sm_count(dev)
    G, chunk = large_select_geometry(S, n, B, sms)
    # the rows' state and, for the rank, the ranks: one zeroed buffer
    words = S * B * lib.knn_fused_large_state_words()
    zeroed = torch.zeros(words + (S * B * r if sort == "rank" else 0),
                         dtype=torch.int32, device=dev)
    state = zeroed[:words]
    rank = zeroed[words:] if sort == "rank" else None
    last_bins = torch.empty((S, B, G, lib.knn_fused_large_slice_bins()),
                            dtype=torch.int32, device=dev)
    win = torch.empty((S, B, r), dtype=torch.int64, device=dev)
    tmp = None
    n_slices = 1
    if sort == "rank":
        n_slices = rank_slices(S, B, r, sms)
    elif r > LARGE_TILE:
        tmp = torch.empty((S, B, r), dtype=torch.int64, device=dev)
    vals = torch.empty((S, B, r), dtype=torch.float32, device=dev)
    ids = torch.empty((S, B, r), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.knn_fused_large_select_launch(
            keys.data_ptr(), state.data_ptr(), last_bins.data_ptr(),
            win.data_ptr(),
            tmp.data_ptr() if tmp is not None else None,
            rank.data_ptr() if rank is not None else None,
            vals.data_ptr(), ids.data_ptr(), S, n, B, r, G, chunk,
            LARGE_SORTS.index(sort), n_slices,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"large-r tier select failed: cudaError {err}")
    large_select_launches.add()
    return vals, ids


def large_select_yardstick(lib, keys, r: int):
    """The earlier one-CTA-a-row select over the same keys: the yardstick timed
    beside :func:`large_select`; no shape takes it. Allocates its device
    sort rows where its winners pass 16,384."""
    S, B, n = keys.shape
    smem = lib.knn_fused_large_yardstick_smem_bytes(r)
    if smem > _MAX_SMEM:
        raise ValueError(f"the yardstick select needs {smem} bytes of "
                         f"shared memory at r={r} (at most {_MAX_SMEM})")
    dev = keys.device
    slots = lib.knn_fused_large_yardstick_slots(r)
    sort_v = sort_i = None
    if slots:
        sort_v = torch.empty((S, B, slots), dtype=torch.float32, device=dev)
        sort_i = torch.empty((S, B, slots), dtype=torch.int32, device=dev)
    vals = torch.empty((S, B, r), dtype=torch.float32, device=dev)
    ids = torch.empty((S, B, r), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.knn_fused_large_yardstick_launch(
            keys.data_ptr(),
            sort_v.data_ptr() if sort_v is not None else None,
            sort_i.data_ptr() if sort_i is not None else None,
            vals.data_ptr(), ids.data_ptr(), S, n, B, r,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"yardstick select failed: cudaError {err}")
    yardstick_launches.add()
    return vals, ids


def key_scores(keys):
    """The f32 scores of order-preserving score keys (int32 holding the u32
    bits, as the large-r scan writes them): -inf for 0."""
    neg = keys < 0  # the top bit: a score >= +0.0
    bits = torch.where(neg, keys & 0x7FFFFFFF, ~keys)
    return torch.where(keys == 0, _NEG_INF, bits.view(torch.float32))


def plain_large_select(keys, r: int):
    """Plain PyTorch version of :func:`large_select`: the keys' scores and a
    stable top-r (ties to the lower doc id), (-inf, -1) past the live
    count."""
    vals, ids = stable_topk(key_scores(keys), r)
    ids = torch.where(vals > _NEG_INF, ids, -1).to(torch.int32)
    return vals, ids


def _launch_kernel(v_x, norms_sq, valid, q_x, qsq, scale, *, r, similarity,
                   score_precision):
    """Launch the design :func:`scan_tier` picks."""
    _check_kernel_operands(v_x, norms_sq, valid, q_x, qsq, scale, r,
                           similarity, score_precision)
    tier = scan_tier(score_precision, r)
    lib = _library()
    if tier in ("large", "large_mma"):
        keys = large_keys(lib, v_x, norms_sq, valid, q_x, qsq, scale,
                          similarity=similarity,
                          score_precision=score_precision)
        vals, ids = large_select(lib, keys, r)
        large_launches.add()
        if tier == "large_mma":
            large_mma_launches.add()
    elif tier == "mma":
        vals, ids = launch_wide_mma(lib, v_x, norms_sq, valid, q_x, qsq,
                                    scale, r=r, similarity=similarity,
                                    score_precision=score_precision)
        mma_launches.add()
    elif tier == "lists":
        vals, ids = launch_lists(lib.knn_fused_lists_launch,
                                 lib.knn_fused_lists_smem_bytes, v_x,
                                 norms_sq, valid, q_x, qsq, r=r,
                                 similarity=similarity)
        list_launches.add()
    else:
        vals, ids = launch_wide(lib.knn_fused_wide_launch,
                                lib.knn_fused_wide_smem_bytes, v_x, norms_sq,
                                valid, q_x, qsq, r=r, similarity=similarity)
        wide_launches.add()
    launches.add()
    return vals, ids


def _launch_tile(  # tpulint: disable=TPU016 - timing yardstick, CUDA only
        v_x, norms_sq, valid, q_x, qsq, scale, *, r, similarity,
        score_precision):
    """Launch the tile scan (csrc/knn_tile.cuh) on checked operands, at any
    precision and r whose pools fit shared memory: no shape takes it, it
    is the yardstick timed beside the designs."""
    lib = _library()
    S, n, d = v_x.shape
    B = q_x.shape[0]
    prec = _PREC_CODE[score_precision]
    smem = lib.knn_fused_smem_bytes(prec, d, r)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"the tile scan keeps a pool of r={r} for each of its 16 "
            f"queries, and its doc tile at d={d}, in shared memory: "
            f"{smem} bytes, past the card's {_MAX_SMEM} a CTA")
    dev = v_x.device
    chunk, n_split = _launch_geometry(S, n, B, dev)
    part_v = torch.empty((S, n_split, B, r), dtype=torch.float32, device=dev)
    part_i = torch.empty((S, n_split, B, r), dtype=torch.int32, device=dev)
    vals = torch.empty((S, B, r), dtype=torch.float32, device=dev)
    ids = torch.empty((S, B, r), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.knn_fused_launch(
            v_x.data_ptr(), norms_sq.data_ptr(), valid.data_ptr(),
            q_x.data_ptr(), qsq.data_ptr(), scale.data_ptr(),
            part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
            ids.data_ptr(), S, n, d, B, r, prec, _SIM_CODE[similarity],
            chunk, n_split, stream,
        )
    if err != 0:
        raise RuntimeError(f"knn_fused launch failed: cudaError {err}")
    tile_launches.add()
    launches.add()
    return vals, ids


def pool_scan(v_x, norms_sq, valid, q_x, qsq, scale, *, r: int,
              similarity: str, score_precision: str):
    """The pool scan over stacked shards: (vals [S, B, r], ids [S, B, r]).
    CUDA tensors launch the kernel (the list scan at fp32 with r <= 32, its
    wide tier at fp32 with r <= 1024, the wide tier's tensor-core scan at
    bf16 and int8 with r <= 1024, the large-r tier past r = 1024, behind
    FFMA dots at fp32 and the tensor-core tier's at bf16 and int8:
    :func:`scan_tier`) or raise; CPU tensors take :func:`plain_pool`."""
    if v_x.device.type == "cuda":
        return _launch_kernel(v_x, norms_sq, valid, q_x, qsq, scale, r=r,
                              similarity=similarity,
                              score_precision=score_precision)
    if v_x.device.type != "cpu":
        raise ValueError(f"unsupported device [{v_x.device}]")
    return plain_pool(v_x, norms_sq, valid, q_x, qsq, scale, r=r,
                      similarity=similarity, score_precision=score_precision)


def _fused_rescore(queries, vectors, norms_sq, valid, cand, *, k, similarity,
                   qsq=None, impl: str = "pallas"):
    """Exact fp32 rescore of pool candidates [S, B, R] -> top-k per shard:
    every dot summed in one order whatever the batch (ops/knn_rescore: the
    kernel for impl="pallas" on the card, its plain version for "xla" or
    on the CPU), then a stable top-k, so score ties keep pool order
    (scan-score rank)."""
    plain = impl == "xla"
    if qsq is None:
        qsq = (knn_rescore.plain_query_sq if plain
               else knn_rescore.query_sq)(queries)
    score = knn_rescore.plain_rescore if plain else knn_rescore.rescore
    scores = score(queries.contiguous(), qsq, vectors.contiguous(),
                   norms_sq.contiguous(), valid.contiguous(),
                   cand.to(torch.int32).contiguous(), similarity=similarity)
    vals, pos = stable_topk(scores, k)
    ids = torch.gather(cand.long(), 2, pos)
    ids = torch.where(torch.isfinite(vals), ids, -1).to(torch.int32)
    return vals, ids


@profiled_kernel("knn_fused_pallas")
def knn_fused_stacked(
    vectors: torch.Tensor,    # [S, n, d] f32
    norms_sq: torch.Tensor,   # [S, n] f32
    valid: torch.Tensor,      # [S, n] bool
    queries: torch.Tensor,    # [B, d] f32
    *,
    k: int,
    similarity: str = "l2_norm",
    score_precision: str = "fp32",
    impl: str = "pallas",
):
    """Fused exact kNN over S shards in one scan: prep operands -> pool
    scan (the kernel's wrapper for impl="pallas", the plain version for
    impl="xla") -> exact fp32 rescore at reduced precisions. Returns
    (scores [S, B, k], ids [S, B, k] int32) with (-inf, -1) past each
    shard's valid-doc count. k_eff and R follow the reference's padding
    arithmetic (n rounded up to a 1024-doc block), though no row is
    padded here."""
    _check_precision(score_precision)
    if impl not in KERNEL_IMPLS:
        raise ValueError(f"unknown impl [{impl}] (one of {KERNEL_IMPLS})")
    S, n, _d = vectors.shape
    B = queries.shape[0]
    n_pad = -(-n // FK_BLOCK) * FK_BLOCK
    k_eff = min(k, n_pad)
    r = min(fused_pool_width(k_eff, score_precision), n_pad)
    # |q|^2 summed in one order whatever the batch, so a batched search's
    # scores are a solo one's bits
    qsq = (knn_rescore.query_sq if impl == "pallas"
           else knn_rescore.plain_query_sq)(queries)
    v_x, q_x, scale = _prep_operands(vectors, queries, score_precision)
    scan = pool_scan if impl == "pallas" else plain_pool
    pv, pi = scan(v_x.contiguous(), norms_sq.contiguous(),
                  valid.contiguous(), q_x.contiguous(), qsq, scale,
                  r=r, similarity=similarity, score_precision=score_precision)
    if score_precision == "fp32":
        vals, ids = pv[:, :, :k_eff], pi[:, :, :k_eff]
    else:
        vals, ids = _fused_rescore(queries, vectors, norms_sq, valid, pi,
                                   k=k_eff, similarity=similarity, qsq=qsq,
                                   impl=impl)
    if k_eff < k:
        vals = torch.cat([vals, vals.new_full((S, B, k - k_eff), _NEG_INF)], 2)
        ids = torch.cat([ids, ids.new_full((S, B, k - k_eff), -1)], 2)
    return vals, ids


def knn_fused(vectors, norms_sq, valid, queries, *, k: int,
              similarity: str = "l2_norm", score_precision: str = "fp32",
              impl: str = "pallas"):
    """One shard ([n, d] vectors): (scores [B, k], ids [B, k])."""
    vals, ids = knn_fused_stacked(
        vectors[None], norms_sq[None], valid[None], queries, k=k,
        similarity=similarity, score_precision=score_precision, impl=impl)
    return vals[0], ids[0]


def knn_fused_shard(vectors, norms_sq, valid, queries, *, k: int,
                    similarity: str = "l2_norm",
                    score_precision: str = "fp32", impl: str = "pallas"):
    """Per-shard fused scan, same contract as :func:`knn_fused`."""
    return knn_fused(vectors, norms_sq, valid, queries, k=k,
                     similarity=similarity, score_precision=score_precision,
                     impl=impl)


@profiled_kernel("knn_fused_pallas")
def knn_fused_auto(vectors, norms_sq, valid, queries, *, k: int,
                   similarity: str = "l2_norm",
                   score_precision: str = "fp32",
                   impl: str | None = None):
    """Policy front door: impl None/"auto"/"pallas" -> the kernel's
    wrapper (the kernel on CUDA tensors, its plain version on CPU
    tensors); "xla" -> the plain version."""
    use = "xla" if impl == "xla" else "pallas"
    return knn_fused(vectors, norms_sq, valid, queries, k=k,
                     similarity=similarity, score_precision=score_precision,
                     impl=use)
