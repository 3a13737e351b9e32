"""IVF-PQ ADC scan: the kernel K2 for Hopper, its plain version, and the
fused pipeline around it.

Counterpart of opensearch_tpu/ops/pallas_adc.py (the Pallas kernel
``_adc_scan_kernel`` and ``build_luts`` / ``adc_scan_xla`` /
``fused_adc_search`` / ``adc_topr_auto`` around it). The kernel is
``csrc/adc_scan.cu``; its note says what bounds it and how it is laid out.

A scan takes per-(query, probe) LUTs [B, P, m, ks] at their native width
(fp32, bf16, or uint8 with one affine per query), the code slab
[nlist, L_pad, m] uint8, its ids [nlist, L_pad] int32 and mask
[nlist, L_pad] bool, and the host-chosen probe table [B, P]. It returns
the top-R pool per query of scores -adc, under (score desc, probe-major
position asc), with (-inf, -1) past the live-candidate count.

Dispatch: :func:`adc_pool_scan` launches the kernel for CUDA tensors (or
raises) and runs :func:`plain_adc_pool` for CPU tensors. The policy value
"pallas" means the kernel's wrapper, "xla" the plain scan, as in the
reference. :func:`adc_topr_auto` is profiled
(search/profile.profiled_kernel) as the reference's "ivfpq_adc_pallas".
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from opensearch_tpu_torch import backend  # noqa: F401  (pins float32)
from opensearch_tpu_torch.ops import adc_lut, cuda_lib, ivfpq
from opensearch_tpu_torch.ops import knn as knn_ops
from opensearch_tpu_torch.ops.topk import stable_topk
from opensearch_tpu_torch.search.profile import profiled_kernel

_NEG_INF = float("-inf")
_PREC_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
# shared memory one CTA may use on Hopper (opt-in maximum), less the
# kernels' static shared memory (the select's histogram and counters)
_MAX_SMEM = 232_448
_STATIC_SMEM = 9 * 1024
SMEM_BUDGET = _MAX_SMEM - _STATIC_SMEM
# list slots one stage-1 CTA walks at most, and at least when the grid is
# small
MAX_SPAN = 8192
MIN_SPAN = 512
# the merge keeps the parts' offsets and its sort buffer in shared memory
# up to these sizes, else in device scratch
_MERGE_OFF_SMEM = 32 * 1024
_MERGE_SORT_SMEM = 128 * 1024

# launches of the kernel made by adc_pool_scan
launches = cuda_lib.LaunchCounter()


def plain_adc_pool(lut, codes, ids, mask, probes, *, r: int):
    """Plain PyTorch ADC scan (counterpart of ``adc_scan_xla``): gather the
    probed code blocks, sum the LUT entries (uint8 in int32, bf16 widened
    to f32, f32 in order), then a stable top-r over the probe-major
    flattened [B, P * L_pad] axis. Returns (vals [B, r] f32, ids [B, r]
    int32) with (-inf, -1) past the live-candidate count."""
    B = lut.shape[0]
    probes = probes.long()
    pcodes = codes[probes].long().permute(0, 1, 3, 2)        # [B, P, m, L]
    pids = ids[probes]                                        # [B, P, L]
    pmask = mask[probes]
    wide = torch.int32 if lut.dtype == torch.uint8 else torch.float32
    adc = ivfpq.sum_subspaces(torch.gather(lut.to(wide), 3, pcodes))
    score = torch.where(pmask, -adc.to(torch.float32), _NEG_INF)
    vals, pos = stable_topk(score.reshape(B, -1), r)
    out_ids = torch.gather(pids.reshape(B, -1), 1,
                           torch.clamp(pos, max=pids[0].numel() - 1))
    out_ids = torch.where(vals > _NEG_INF, out_ids, -1)
    return vals, out_ids.to(torch.int32)


def _check_kernel_operands(lut, codes, ids, mask, probes, r: int) -> None:
    dev = lut.device
    if lut.dim() != 4 or codes.dim() != 3:
        raise ValueError(
            f"lut must be [B, P, m, ks] and codes [nlist, L_pad, m]; got "
            f"{tuple(lut.shape)} and {tuple(codes.shape)}")
    B, P, m, ks = lut.shape
    nlist, l_pad, m_codes = codes.shape
    if lut.dtype not in _PREC_CODE:
        raise ValueError(f"[lut] is {lut.dtype}; expected float32, bfloat16 "
                         f"or uint8")
    want = {
        "lut": (lut, (B, P, m, ks), lut.dtype),
        "codes": (codes, (nlist, l_pad, m), torch.uint8),
        "ids": (ids, (nlist, l_pad), torch.int32),
        "mask": (mask, (nlist, l_pad), torch.bool),
        "probes": (probes, (B, P), torch.int32),
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
    if m_codes != m or not 1 <= ks <= 256:
        raise ValueError(f"lut has m={m}, ks={ks}; codes have m={m_codes} "
                         f"(ks must be 1..256)")
    if min(B, P, nlist, l_pad, m) < 1 or r < 1:
        raise ValueError(f"unsupported shape B={B} P={P} nlist={nlist} "
                         f"l_pad={l_pad} m={m} r={r}")
    if B > 65_535 or P > 65_535 or P * l_pad >= 2**31:
        raise ValueError(f"grid too large: B={B} P={P} l_pad={l_pad}")


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def _align16(x: int) -> int:
    return (x + 15) & ~15


def scan_smem_bytes(elem_bytes: int, m: int, ks: int, span: int) -> int:
    """Dynamic shared memory of one stage-1 CTA: the (b, p) LUT at its
    native width, then a 32-bit key and a mask byte a list slot of its
    range."""
    return _align16(m * ks * elem_bytes) + 5 * span


@functools.lru_cache(maxsize=None)
def scan_plan(B: int, P: int, l_pad: int, m: int, ks: int, elem_bytes: int,
              sms: int, span: int | None = None) -> tuple[int, int, int]:
    """(span, n_parts, smem) of stage 1: list slots a CTA walks, a power of
    two of at most MAX_SPAN, halved (to no less than MIN_SPAN) while the
    grid (P, B, n_parts) holds fewer than two CTAs per SM or the keys do not
    fit beside the LUT, and no larger than l_pad needs. Part c of a probe
    covers slots [c * span, (c + 1) * span). `span` forces the size."""
    if span is None:
        span = min(MAX_SPAN, _next_pow2(l_pad))
        while span > MIN_SPAN and (
                B * P * -(-l_pad // span) < 2 * sms
                or scan_smem_bytes(elem_bytes, m, ks, span) > SMEM_BUDGET):
            span //= 2
    smem = scan_smem_bytes(elem_bytes, m, ks, span)
    if -(-l_pad // span) > 65_535:
        raise ValueError(f"grid too large: {-(-l_pad // span)} parts of "
                         f"{span} slots a list")
    if smem > SMEM_BUDGET:
        raise ValueError(
            f"adc_scan needs {smem} bytes of shared memory at m={m}, ks={ks} "
            f"({elem_bytes}-byte LUT entries, span {span}; at most "
            f"{SMEM_BUDGET})")
    return span, -(-l_pad // span), smem


@dataclass(frozen=True)
class MergePlan:
    """Stage 2's layout: byte offsets in its dynamic shared memory of the
    parts' offsets (off_at), of cand_cap candidates (cand_at) and of the
    sort buffer of s_cap entries (sort_at), -1 where the buffer lives in
    device scratch; smem is the total. A query with more live candidates
    than cand_cap gathers them in device scratch (cand_scratch)."""
    off_at: int
    cand_at: int
    cand_cap: int
    sort_at: int
    s_cap: int
    smem: int
    cand_scratch: bool


@functools.lru_cache(maxsize=None)
def merge_plan(parts: int, rp: int, r: int) -> MergePlan:
    """The merge's layout for `parts` parts of at most rp survivors and a
    pool of r: the offsets (4 bytes a part) and the sort buffer
    (next_pow2(r) keys and candidate indices) in shared memory where they
    fit, the candidates (keys and doc ids) in what is left, up to
    parts * rp."""
    s_cap = _next_pow2(r)
    used = 0
    off_at = -1
    if _align16(4 * parts) <= _MERGE_OFF_SMEM:
        off_at, used = 0, _align16(4 * parts)
    sort_at = -1
    if 8 * s_cap <= _MERGE_SORT_SMEM:
        sort_at, used = used, used + _align16(8 * s_cap)
    worst = parts * rp
    cand_cap = min(worst, (SMEM_BUDGET - used) // 8) // 4 * 4
    return MergePlan(off_at=off_at, cand_at=used, cand_cap=cand_cap,
                     sort_at=sort_at, s_cap=s_cap, smem=used + 8 * cand_cap,
                     cand_scratch=worst > cand_cap)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared."""
    lib = cuda_lib.load("adc_scan")
    lib.adc_scan_launch.restype = ctypes.c_int
    lib.adc_scan_launch.argtypes = ([ctypes.c_void_p] * 15
                                    + [ctypes.c_int] * 15 + [ctypes.c_void_p])
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch(lib, lut, codes, ids, mask, probes, *, r: int,
           span: int | None = None):
    """Stage 1 and stage 2 through `lib` (a build of csrc/adc_scan.cu) on
    the current stream: (vals [B, r], ids [B, r]). `span` forces stage 1's
    range (scan_plan)."""
    _check_kernel_operands(lut, codes, ids, mask, probes, r)
    B, P, m, ks = lut.shape
    nlist, l_pad, _m = codes.shape
    dev = lut.device
    span, n_parts, scan_smem = scan_plan(B, P, l_pad, m, ks,
                                         lut.element_size(), _sm_count(dev),
                                         span)
    rp = min(r, span)
    parts = P * n_parts
    plan = merge_plan(parts, rp, r)
    # one int32 allocation for the parts' keys, doc ids and counts, then
    # whatever the merge keeps in device scratch (absent: null)
    sizes = (B * parts * rp, B * parts * rp, B * parts,
             B * parts if plan.off_at < 0 else 0,
             *(B * parts * rp if plan.cand_scratch else 0,) * 2,
             *(B * plan.s_cap if plan.sort_at < 0 else 0,) * 2)
    scratch = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
    at, bufs = scratch.data_ptr(), []
    for size in sizes:
        bufs.append(at if size else None)
        at += 4 * size
    vals = torch.empty((B, r), dtype=torch.float32, device=dev)
    out_ids = torch.empty((B, r), dtype=torch.int32, device=dev)
    operands = [t.data_ptr() for t in (lut, codes, mask, ids, probes)]
    part_k, part_i, part_n, *merge_scratch = bufs
    err = lib.adc_scan_launch(
        *operands, part_k, part_i, part_n, vals.data_ptr(),
        out_ids.data_ptr(), *merge_scratch, B, P, nlist, l_pad, m, ks, r,
        span, _PREC_CODE[lut.dtype], scan_smem, plan.off_at, plan.cand_at,
        plan.cand_cap, plan.sort_at, plan.smem,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adc_scan launch failed: cudaError {err}")
    return vals, out_ids


def adc_pool_scan(lut, codes, ids, mask, probes, *, r: int):
    """The ADC pool scan: (vals [B, r], ids [B, r]). CUDA tensors launch
    the kernel; CPU tensors take :func:`plain_adc_pool`."""
    if lut.device.type == "cuda":
        out = launch(_library(), lut, codes, ids, mask, probes, r=r)
        launches.add()
        return out
    if lut.device.type != "cpu":
        raise ValueError(f"unsupported device [{lut.device}]")
    return plain_adc_pool(lut, codes, ids, mask, probes, r=r)


def build_luts(queries, coarse, codebooks, probes, *, adc_precision: str,
               use_kernel: bool = True):
    """Per-(query, probe) residual LUTs at native width from the probe
    table: the f32 LUTs, each sum in one order whatever the batch (the
    kernel of ops/adc_lut for CUDA tensors when `use_kernel`, else its
    plain version, ivfpq.lut_for_probes: the same bits), then a bf16
    downcast, or a per-QUERY affine uint8 quantization (one scale across a
    query's probes keeps the integer sums comparable across probes, so the
    scan never dequantizes), both elementwise and so the same for a query
    in any batch. ``ivfpq.search`` quantizes per (query, probe) instead;
    each keeps the reference's choice."""
    ivfpq.check_precision(adc_precision)
    lut = (adc_lut.lut if use_kernel else ivfpq.lut_for_probes)(
        queries, coarse, codebooks, probes)
    if adc_precision == "bf16":
        return lut.to(torch.bfloat16)
    if adc_precision == "int8":
        lo = lut.amin(dim=(1, 2, 3), keepdim=True)           # [B, 1, 1, 1]
        hi = lut.amax(dim=(1, 2, 3), keepdim=True)
        scale = torch.clamp(hi - lo, min=1e-12) / 255.0
        return torch.clamp(torch.round((lut - lo) / scale), 0.0,
                           255.0).to(torch.uint8)
    return lut


def probes_on(probes, nlist: int, device) -> torch.Tensor:
    """The probe table as int32 on `device`. A host table (numpy, as
    host_probe_select makes it) is range-checked before the copy."""
    if isinstance(probes, torch.Tensor):
        return probes.to(device=device, dtype=torch.int32).contiguous()
    probes = np.asarray(probes)
    if probes.size and (probes.min() < 0 or probes.max() >= nlist):
        raise ValueError(f"probe ids outside [0, {nlist})")
    return torch.from_numpy(
        np.ascontiguousarray(probes, np.int32)).to(device)


def fused_adc_search(coarse, codebooks, codes, ids, mask, vectors, norms_sq,
                     valid, queries, probes, *, k: int, rerank: int,
                     similarity: str = "l2_norm",
                     adc_precision: str = "fp32", use_kernel: bool = True):
    """LUT build over the host-chosen probes, native-width quantization,
    the ADC scan, and the exact fp32 rescore: the kernels' wrappers (the
    LUT kernel, K2 and the fixed-order rescore) where `use_kernel`, else
    their plain versions, which give the same bits. Returns (scores
    [B, k] in k-NN score space, doc ids [B, k] int32, -1 pads): the
    ``ivfpq.search`` contract."""
    nlist, l_pad, _m = codes.shape
    probes = probes_on(probes, nlist, codes.device)
    P = probes.shape[1]
    k_eff = min(k, P * l_pad)
    r = max(k_eff, min(rerank, P * l_pad))
    lut = build_luts(queries, coarse, codebooks, probes,
                     adc_precision=adc_precision,
                     use_kernel=use_kernel).contiguous()
    scan = adc_pool_scan if use_kernel else plain_adc_pool
    _vals, cand = scan(lut, codes.contiguous(), ids.contiguous(),
                       mask.contiguous(), probes, r=r)
    best, best_ids = ivfpq.exact_rescore(
        queries, cand, vectors, norms_sq, valid,
        similarity=knn_ops.canonical_similarity(similarity), k_eff=k_eff,
        impl="pallas" if use_kernel else "xla")
    return ivfpq.pad_to_k(best, best_ids, k)


@profiled_kernel("ivfpq_adc_pallas")
def adc_topr_auto(coarse, codebooks, codes, ids, mask, vectors, norms_sq,
                  valid, queries, probes, *, k: int, rerank: int,
                  similarity: str = "l2_norm", adc_precision: str = "fp32",
                  impl: str | None = None):
    """Policy front door: impl None/"auto"/"pallas" -> the kernel's
    wrapper (the kernel on CUDA tensors, its plain version on CPU
    tensors); "xla" -> the fused pipeline with the plain scan."""
    if impl not in (None, "auto", "pallas", "xla"):
        raise ValueError(f"unknown impl [{impl}] (pallas or xla)")
    return fused_adc_search(
        coarse, codebooks, codes, ids, mask, vectors, norms_sq, valid,
        queries, probes, k=k, rerank=rerank, similarity=similarity,
        adc_precision=adc_precision, use_kernel=impl != "xla")
