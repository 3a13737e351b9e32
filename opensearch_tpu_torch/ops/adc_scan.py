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
reference.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from opensearch_tpu_torch import backend  # noqa: F401  (pins float32)
from opensearch_tpu_torch.ops import cuda_lib, ivfpq
from opensearch_tpu_torch.ops import knn as knn_ops
from opensearch_tpu_torch.ops.topk import stable_topk

_NEG_INF = float("-inf")
_PREC_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
# shared memory one CTA may use on Hopper (opt-in maximum)
_MAX_SMEM = 232_448
# list slots one scan CTA sorts at most, and at least when the grid is small
_MAX_CHUNK = 2048
_MIN_CHUNK = 512

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


def _chunk(B: int, P: int, l_pad: int, device) -> int:
    """List slots per scan CTA: a power of two of at most 2048, halved (to
    no less than 512) while the grid holds fewer than two CTAs per SM, and
    no larger than l_pad needs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ch = _MAX_CHUNK
    while ch > _MIN_CHUNK and B * P * -(-l_pad // ch) < 2 * sms:
        ch //= 2
    return min(ch, 1 << max(int(l_pad - 1).bit_length(), 1))


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = cuda_lib.load("adc_scan")
    lib.adc_scan_smem_bytes.restype = ctypes.c_size_t
    lib.adc_scan_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.adc_scan_launch.restype = ctypes.c_int
    lib.adc_scan_launch.argtypes = ([ctypes.c_void_p] * 9
                                    + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    return lib


def _launch_kernel(lut, codes, ids, mask, probes, *, r: int):
    _check_kernel_operands(lut, codes, ids, mask, probes, r)
    lib = _library()
    B, P, m, ks = lut.shape
    nlist, l_pad, _m = codes.shape
    prec = _PREC_CODE[lut.dtype]
    dev = lut.device
    ch = _chunk(B, P, l_pad, dev)
    smem = lib.adc_scan_smem_bytes(prec, m, ks, ch)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"adc_scan needs {smem} bytes of shared memory at m={m}, ks={ks} "
            f"({lut.dtype} LUT; at most {_MAX_SMEM})")
    n_chunks = -(-l_pad // ch)
    if 4 * P * n_chunks > _MAX_SMEM:
        raise ValueError(f"adc_scan merges at most {_MAX_SMEM // 4} partial "
                         f"pools per query (P={P} x {n_chunks} chunks)")
    rp = min(r, ch)
    part_v = torch.empty((B, P * n_chunks, rp), dtype=torch.float32, device=dev)
    part_p = torch.empty((B, P * n_chunks, rp), dtype=torch.int32, device=dev)
    vals = torch.empty((B, r), dtype=torch.float32, device=dev)
    out_ids = torch.empty((B, r), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.adc_scan_launch(
        lut.data_ptr(), codes.data_ptr(), mask.data_ptr(), ids.data_ptr(),
        probes.data_ptr(), part_v.data_ptr(), part_p.data_ptr(),
        vals.data_ptr(), out_ids.data_ptr(),
        B, P, nlist, l_pad, m, ks, r, ch, prec, stream,
    )
    if err != 0:
        raise RuntimeError(f"adc_scan launch failed: cudaError {err}")
    launches.add()
    return vals, out_ids


def adc_pool_scan(lut, codes, ids, mask, probes, *, r: int):
    """The ADC pool scan: (vals [B, r], ids [B, r]). CUDA tensors launch
    the kernel; CPU tensors take :func:`plain_adc_pool`."""
    if lut.device.type == "cuda":
        return _launch_kernel(lut, codes, ids, mask, probes, r=r)
    if lut.device.type != "cpu":
        raise ValueError(f"unsupported device [{lut.device}]")
    return plain_adc_pool(lut, codes, ids, mask, probes, r=r)


def build_luts(queries, coarse, codebooks, probes, *, adc_precision: str):
    """Per-(query, probe) residual LUTs at native width from the probe
    table: the shared f32 LUT math (ivfpq.lut_for_probes), then a bf16
    downcast, or a per-QUERY affine uint8 quantization (one scale across a
    query's probes keeps the integer sums comparable across probes, so the
    scan never dequantizes). ``ivfpq.search`` quantizes per (query, probe)
    instead; each keeps the reference's choice."""
    ivfpq.check_precision(adc_precision)
    lut = ivfpq.lut_for_probes(queries, coarse, codebooks, probes)
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
    the ADC scan (the kernel's wrapper, or the plain scan), and the exact
    fp32 rescore. Returns (scores [B, k] in k-NN score space, doc ids
    [B, k] int32, -1 pads): the ``ivfpq.search`` contract."""
    nlist, l_pad, _m = codes.shape
    probes = probes_on(probes, nlist, codes.device)
    P = probes.shape[1]
    k_eff = min(k, P * l_pad)
    r = max(k_eff, min(rerank, P * l_pad))
    lut = build_luts(queries, coarse, codebooks, probes,
                     adc_precision=adc_precision).contiguous()
    scan = adc_pool_scan if use_kernel else plain_adc_pool
    _vals, cand = scan(lut, codes.contiguous(), ids.contiguous(),
                       mask.contiguous(), probes, r=r)
    best, best_ids = ivfpq.exact_rescore(
        queries, cand, vectors, norms_sq, valid,
        similarity=knn_ops.canonical_similarity(similarity), k_eff=k_eff)
    return ivfpq.pad_to_k(best, best_ids, k)


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
