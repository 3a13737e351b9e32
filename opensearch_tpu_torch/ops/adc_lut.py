"""The IVF-PQ residual lookup tables, each sum in one fixed order: the
kernel of ``csrc/adc_lut.cu`` and its plain version.

No Pallas kernel is replaced: the reference builds the LUTs in XLA
(``opensearch_tpu/ops/ivfpq.py::lut_for_probes``, reached from
``opensearch_tpu/ops/pallas_adc.py::build_luts``). A batched einsum and
row sums let the library pick their summation order by the batch, so a
query merged into a batch by the dispatch batcher could get other LUT
bits, hence other candidates and scores, than alone. Here every entry

    lut[b, p, j, c] = (|r|^2 - 2 r . cb[j, c]) + |cb[j, c]|^2,
    r = q[b, slice j] - coarse[probes[b, p], slice j],

sums each of its three dots over the dsub elements in ascending order from
0, each product rounded and then added (no fused multiply-add), whatever
B or P. The plain version does the same with elementwise operations, so
kernel and plain version agree bit for bit.

Dispatch: a CUDA tensor launches the kernel (or raises), a CPU tensor
takes the plain version. Launches are counted on ``launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from opensearch_tpu_torch.ops import cuda_lib

launches = cuda_lib.LaunchCounter()


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_lib.load("adc_lut")
    lib.adc_lut_launch.restype = ctypes.c_int
    lib.adc_lut_launch.argtypes = ([ctypes.c_void_p] * 5
                                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return lib


def _ordered_sum(terms) -> torch.Tensor:
    """The terms added one after another from zero (the kernel's order)."""
    acc = torch.zeros_like(terms[0])
    for t in terms:
        acc = acc + t
    return acc


def plain_lut(queries, coarse, codebooks, probes) -> torch.Tensor:
    """f32 [B, P, m, ks] residual LUTs of queries [B, d] over the probe
    table [B, P], each sum in the kernel's order."""
    m, ks, dsub = codebooks.shape
    resid = queries[:, None, :] - coarse[probes.long()]        # [B, P, d]
    r_sub = resid.reshape(queries.shape[0], probes.shape[1], m, dsub)
    r_sq = _ordered_sum([r_sub[..., s] * r_sub[..., s] for s in range(dsub)])
    r_dot = _ordered_sum([r_sub[..., s, None] * codebooks[..., s]
                          for s in range(dsub)])               # [B, P, m, ks]
    cb_sq = _ordered_sum([codebooks[..., s] * codebooks[..., s]
                          for s in range(dsub)])               # [m, ks]
    return r_sq[..., None] - 2.0 * r_dot + cb_sq[None, None]


def lut(queries, coarse, codebooks, probes) -> torch.Tensor:
    """The LUTs of :func:`plain_lut`: the kernel for CUDA tensors (or a
    raise), the plain version for CPU tensors. queries [B, d], coarse
    [nlist, d] and codebooks [m, ks, dsub] f32; probes [B, P] int32, each
    in [0, nlist)."""
    if queries.device.type == "cpu":
        return plain_lut(queries, coarse, codebooks, probes)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device [{queries.device}]")
    m, ks, dsub = codebooks.shape
    B, d = queries.shape
    P = probes.shape[1]
    for name, t, dtype in (("queries", queries, torch.float32),
                           ("coarse", coarse, torch.float32),
                           ("codebooks", codebooks, torch.float32),
                           ("probes", probes, torch.int32)):
        if t.device != queries.device or t.dtype != dtype:
            raise ValueError(f"[{name}] is {t.dtype} on {t.device}, expected "
                             f"{dtype} on {queries.device}")
    if d != m * dsub or coarse.shape[1] != d or probes.shape[0] != B:
        raise ValueError(f"shapes disagree: queries {tuple(queries.shape)}, "
                         f"coarse {tuple(coarse.shape)}, codebooks "
                         f"{tuple(codebooks.shape)}, probes "
                         f"{tuple(probes.shape)}")
    if B > 65_535 or 4 * (d + m) > 232_448:
        raise ValueError(f"unsupported shape B={B} d={d} m={m}")
    q, c, cb, pr = (t.contiguous() for t in (queries, coarse, codebooks,
                                              probes))
    out = torch.empty((B, P, m, ks), dtype=torch.float32,
                      device=queries.device)
    err = _library().adc_lut_launch(
        q.data_ptr(), c.data_ptr(), cb.data_ptr(), pr.data_ptr(),
        out.data_ptr(), B, P, d, m, ks, dsub,
        torch.cuda.current_stream(queries.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"adc_lut launch failed: cudaError {err}")
    launches.add()
    return out
