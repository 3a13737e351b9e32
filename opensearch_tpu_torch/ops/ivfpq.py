"""IVF-PQ approximate nearest neighbour: build and search in PyTorch.

Counterpart of opensearch_tpu/ops/ivfpq.py (the k-NN plugin's IVF-PQ
engine). The heavy steps run on the tensors' device:

- k-means (Lloyd's) as a Python loop over steps: the assignment is one
  [n, k] matrix product; the centroid update sorts the points by their
  centroid (stable) and sums each run with ``torch.segment_reduce``. That
  sums every centroid's points in index order with no atomics, so a build
  is the same from run to run on the card (a float ``index_add_`` is not),
  and on the CPU it sums in the order the reference's ``segment_sum`` does.
- PQ codebooks are trained per subspace on the coarse residuals, the m
  subspaces as one written-out batch dimension (the reference's ``vmap``).
- The built index is padded and static-shaped: codes [nlist, L_pad, m]
  uint8, ids and mask [nlist, L_pad] (the inverted lists).
- ``search`` is the monolithic lowering (policy "xla"): coarse top-nprobe,
  per-probe LUTs, ADC gather-accumulate at the chosen precision, candidate
  top-R, then an exact fp32 rescore. ``search_index`` with kernel "pallas"
  takes the cooperative split instead: probes chosen on the host
  (:func:`host_probe_select`), then ops/adc_scan's fused pipeline, whose
  scan is the hand-written kernel K2 (csrc/adc_scan.cu).
- Every sum a query's answer depends on has one order, whatever the
  batch, so a batched search gets a solo one's bits: the probe scores are
  one product a query row (:func:`host_probe_select`), the LUTs sum in
  ascending element order (ops/adc_lut: the kernel csrc/adc_lut.cu on the
  fused pipeline, :func:`lut_for_probes` its plain version), and the exact
  rescore's dots and |q|^2 go through ops/knn_rescore's fixed-order
  kernels (plain versions under policy "xla").

Every build carries a process-unique ``build_generation``. Only l2 and
cosine are served by ANN (cosine is l2 on unit vectors).

Each build registers its slab (packed lists and codebooks) in the
device-residency ledger (telemetry/device_ledger.py); the owning segment
frees it when it retires.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from opensearch_tpu_torch import backend
from opensearch_tpu_torch.ops import adc_lut, knn_rescore
from opensearch_tpu_torch.ops import knn as knn_ops
from opensearch_tpu_torch.ops.topk import stable_topk

DEFAULT_NLIST = 128
DEFAULT_M = 8
DEFAULT_KS = 256
DEFAULT_NPROBE = 8
# exact-rescore pool width = multiplier * k (floored at 64 candidates)
DEFAULT_RESCORE_MULTIPLIER = 4
ADC_PRECISIONS = ("fp32", "bf16", "int8")
# below this many docs a flat scan beats list overhead; stay exact
MIN_TRAIN_DOCS = 512
# rows per chunk of the streamed encode
ENCODE_CHUNK = 65_536

_build_generation = itertools.count(1)


def check_precision(adc_precision: str) -> None:
    if adc_precision not in ADC_PRECISIONS:
        raise ValueError(
            f"unknown adc_precision [{adc_precision}] "
            f"(choose from {list(ADC_PRECISIONS)})"
        )


# --------------------------------------------------------------------------
# k-means
# --------------------------------------------------------------------------


def _assign(data: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid ids (l2), int64. data [..., n, d], centroids
    [..., k, d] with the same leading batch dims; first index on ties."""
    dots = data @ centroids.transpose(-1, -2)
    c_sq = (centroids * centroids).sum(dim=-1)
    # ||x-c||^2 = ||x||^2 - 2 x.c + ||c||^2; ||x||^2 is constant per row
    return torch.argmin(c_sq.unsqueeze(-2) - 2.0 * dots, dim=-1)


def _lloyd_step(data: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """One Lloyd step over a batch: data [g, n, d], centroids [g, k, d].
    Empty clusters keep their centroid."""
    g, n, d = data.shape
    k = centroids.shape[1]
    assign = _assign(data, centroids)                          # [g, n]
    seg = (assign + k * torch.arange(g, device=data.device)[:, None]).reshape(-1)
    order = torch.sort(seg, stable=True).indices
    counts = torch.bincount(seg, minlength=g * k)
    sums = torch.segment_reduce(data.reshape(g * n, d)[order], "sum",
                                lengths=counts, axis=0, unsafe=True)
    counts = counts.to(data.dtype).reshape(g, k, 1)
    fresh = sums.reshape(g, k, d) / torch.clamp(counts, min=1.0)
    return torch.where(counts > 0, fresh, centroids)


def kmeans(data: torch.Tensor, init: torch.Tensor, *, k: int,
           iters: int = 10) -> torch.Tensor:
    """Lloyd's iterations; returns centroids [k, d]. Empty clusters keep
    their previous centroid (callers seed with distinct points)."""
    if init.shape[0] != k:
        raise ValueError(f"init has {init.shape[0]} rows, k is {k}")
    centroids = init[None]
    for _ in range(iters):
        centroids = _lloyd_step(data[None], centroids)
    return centroids[0]


def _seed_points(rng: np.random.Generator, n: int, k: int) -> np.ndarray:
    return rng.choice(n, size=k, replace=n < k)


# --------------------------------------------------------------------------
# training + encoding
# --------------------------------------------------------------------------


@dataclass
class IVFPQParams:
    coarse: torch.Tensor      # [nlist, d] f32
    codebooks: torch.Tensor   # [m, ks, dsub] f32 (trained on residuals)
    nlist: int
    m: int
    ks: int
    d: int

    @property
    def dsub(self) -> int:
        return self.d // self.m


def _train_pq(residuals_sub: torch.Tensor, init: torch.Tensor, *,
              iters: int) -> torch.Tensor:
    """k-means over the m subspaces at once: [m, n, dsub] -> [m, ks, dsub]."""
    centroids = init
    for _ in range(iters):
        centroids = _lloyd_step(residuals_sub, centroids)
    return centroids


def train(
    vectors: np.ndarray,
    *,
    nlist: int = DEFAULT_NLIST,
    m: int = DEFAULT_M,
    ks: int = DEFAULT_KS,
    iters: int = 10,
    train_sample: int = 65_536,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> IVFPQParams:
    """Train coarse + PQ codebooks on a subsample, on `device`. The sample
    and the seed points are the reference's: the same numpy generator
    draws them in the same order."""
    device = backend.resolve_device(device)
    n, d = vectors.shape
    if d % m != 0:
        raise ValueError(f"dims [{d}] not divisible by pq m [{m}]")
    ks = min(ks, 256)
    rng = np.random.default_rng(seed)
    # the reference buckets the sample to a power of two (sampling with
    # replacement past n); the same draw keeps the builds comparable
    want = min(n, train_sample)
    bucket = 1 << (want - 1).bit_length()
    sample_idx = rng.choice(n, size=bucket, replace=bucket > n)
    sample = torch.from_numpy(
        np.ascontiguousarray(vectors[sample_idx], np.float32)).to(device)
    coarse_init = torch.from_numpy(np.ascontiguousarray(
        vectors[_seed_points(rng, n, nlist)], np.float32)).to(device)
    coarse = kmeans(sample, coarse_init, k=nlist, iters=iters)

    assign = _assign(sample, coarse)
    residuals = sample - coarse[assign]
    dsub = d // m
    res_sub = residuals.reshape(sample.shape[0], m, dsub).permute(1, 0, 2)
    res_sub = res_sub.contiguous()                          # [m, n_s, dsub]
    pq_seed = torch.from_numpy(
        _seed_points(rng, int(sample.shape[0]), ks)).to(device)
    pq_init = res_sub[:, pq_seed, :]                         # [m, ks, dsub]
    codebooks = _train_pq(res_sub, pq_init, iters=iters)
    # the sample and the seed points are build-time uploads the training
    # consumes: counted as traffic, never resident (build registers the
    # trained coarse centroids and codebooks with the slab)
    from opensearch_tpu_torch.telemetry.device_ledger import (
        KIND_IVFPQ,
        default_ledger,
    )

    default_ledger.record_transient(
        KIND_IVFPQ, sample.nbytes + coarse_init.nbytes + pq_seed.nbytes)
    return IVFPQParams(coarse=coarse, codebooks=codebooks, nlist=nlist, m=m,
                       ks=ks, d=d)


def _encode_chunk(chunk: torch.Tensor, coarse: torch.Tensor,
                  codebooks: torch.Tensor, m: int):
    """(list ids [c], codes [c, m] uint8) for one chunk of vectors."""
    lists = _assign(chunk, coarse)
    residuals = chunk - coarse[lists]
    dsub = chunk.shape[1] // m
    res_sub = residuals.reshape(-1, m, dsub).permute(1, 0, 2)   # [m, c, dsub]
    codes = _assign(res_sub, codebooks)                          # [m, c]
    return lists.to(torch.int32), codes.T.to(torch.uint8)


def encode(vectors: np.ndarray, params: IVFPQParams, *,
           chunk: int = ENCODE_CHUNK):
    """Stream-encode the full corpus in chunks: (list_ids [n] int32,
    codes [n, m] uint8) as numpy arrays on the host."""
    from opensearch_tpu_torch.telemetry.device_ledger import (
        KIND_IVFPQ,
        default_ledger,
    )

    n = vectors.shape[0]
    device = params.coarse.device
    lists_out = np.empty(n, np.int32)
    codes_out = np.empty((n, params.m), np.uint8)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        block = torch.from_numpy(
            np.ascontiguousarray(vectors[lo:hi], np.float32)).to(device)
        # a chunk the encoder consumes: traffic, never resident
        default_ledger.record_transient(KIND_IVFPQ, block.nbytes)
        lists, codes = _encode_chunk(block, params.coarse, params.codebooks,
                                     params.m)
        lists_out[lo:hi] = lists.cpu().numpy()
        codes_out[lo:hi] = codes.cpu().numpy()
    return lists_out, codes_out


# --------------------------------------------------------------------------
# index layout (padded inverted lists)
# --------------------------------------------------------------------------


@dataclass
class IVFPQIndex:
    params: IVFPQParams
    codes: torch.Tensor    # uint8 [nlist, L_pad, m]
    ids: torch.Tensor      # int32 [nlist, L_pad]  (-1 = padding)
    mask: torch.Tensor     # bool  [nlist, L_pad]
    l_pad: int
    n: int
    normalized: bool       # True when built for cosine (unit vectors)
    # process-unique id of this build (a rebuild gets a fresh one)
    build_generation: int = 0
    # device-residency ledger handle for this build's slab (freed when the
    # owning segment retires: the engine's retirement path walks it)
    allocation: object | None = None
    # host copies of the coarse centroids and their squared norms: probe
    # selection runs on the host (host_probe_select)
    coarse_host: np.ndarray | None = None
    coarse_sq_host: np.ndarray | None = None

    @property
    def nbytes(self) -> int:
        """Device bytes of the build: packed lists + coarse/PQ codebooks."""
        return sum(t.numel() * t.element_size() for t in (
            self.codes, self.ids, self.mask,
            self.params.coarse, self.params.codebooks))


def build(
    vectors: np.ndarray,
    doc_ids: np.ndarray | None = None,
    *,
    nlist: int = DEFAULT_NLIST,
    m: int = DEFAULT_M,
    ks: int = DEFAULT_KS,
    nprobe_default: int = DEFAULT_NPROBE,  # noqa: ARG001 (recorded by caller)
    iters: int = 10,
    normalized: bool = False,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> IVFPQIndex:
    """Train + encode + pack padded lists on `device` (None means the card,
    and raises without one)."""
    device = backend.resolve_device(device)
    n, d = vectors.shape
    vecs = vectors.astype(np.float32, copy=False)
    if normalized:
        norms = np.linalg.norm(vecs, axis=1, keepdims=True)
        vecs = vecs / np.maximum(norms, 1e-12)
    nlist = max(1, min(nlist, n // 4 if n >= 8 else 1))
    params = train(vecs, nlist=nlist, m=m, ks=ks, iters=iters, seed=seed,
                   device=device)
    lists, codes = encode(vecs, params)
    if doc_ids is None:
        doc_ids = np.arange(n, dtype=np.int32)

    counts = np.bincount(lists, minlength=nlist)
    l_pad = max(8, int(counts.max()))
    l_pad = 1 << (l_pad - 1).bit_length()  # next pow2 for shape bucketing

    packed_codes = np.zeros((nlist, l_pad, params.m), np.uint8)
    packed_ids = np.full((nlist, l_pad), -1, np.int32)
    packed_mask = np.zeros((nlist, l_pad), bool)
    order = np.argsort(lists, kind="stable")
    offs = np.zeros(nlist + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    for li in range(nlist):
        rows = order[offs[li]: offs[li + 1]]
        packed_codes[li, : len(rows)] = codes[rows]
        packed_ids[li, : len(rows)] = doc_ids[rows]
        packed_mask[li, : len(rows)] = True

    coarse_host = params.coarse.cpu().numpy().astype(np.float32)
    out = IVFPQIndex(
        params=params,
        codes=torch.from_numpy(packed_codes).to(device),
        ids=torch.from_numpy(packed_ids).to(device),
        mask=torch.from_numpy(packed_mask).to(device),
        l_pad=l_pad,
        n=n,
        normalized=normalized,
        build_generation=next(_build_generation),
        coarse_host=coarse_host,
        coarse_sq_host=np.sum(coarse_host * coarse_host, axis=1),
    )
    # residency accounting: the slab stays on the device until the owning
    # segment retires (index/field attribution rides the caller's
    # upload_scope; the generation is this build's own id)
    from opensearch_tpu_torch.telemetry.device_ledger import (
        KIND_IVFPQ,
        default_ledger,
    )

    out.allocation = default_ledger.register(
        KIND_IVFPQ, out.nbytes, generation=out.build_generation,
        device=str(out.codes.device))
    return out


# --------------------------------------------------------------------------
# search
# --------------------------------------------------------------------------


def lut_for_probes(queries: torch.Tensor, coarse: torch.Tensor,
                   codebooks: torch.Tensor,
                   probes: torch.Tensor) -> torch.Tensor:
    """f32 [B, P, m, ks] residual ADC lookup tables for the probe table
    [B, P], each sum in one order whatever the batch (ops/adc_lut's plain
    version). The monolithic lowering (:func:`search`) builds its LUTs
    here; the fused pipeline (ops/adc_scan.build_luts) through the kernel
    on the card, which gives the same bits."""
    return adc_lut.plain_lut(queries, coarse, codebooks, probes)


def exact_rescore(queries: torch.Tensor, cand: torch.Tensor,
                  vectors: torch.Tensor, norms_sq: torch.Tensor,
                  valid: torch.Tensor, *, similarity: str, k_eff: int,
                  impl: str = "xla"):
    """Exact fp32 rescore of the [B, R] candidate pool into k-NN score
    space: (scores [B, k_eff], doc ids [B, k_eff] int32, -1 where no finite
    candidate). Ties go to the lower pool position (``lax.top_k``'s
    order). -1 candidates are clamped before the gather and masked after
    it. The dots and |q|^2 sum in one order whatever the batch
    (ops/knn_rescore: its kernels for impl="pallas" on the card, its plain
    versions for "xla" or on the CPU); the transform is the reference's,
    one eager operation at a time (its cosine clamps the product of the
    norms, unlike the kernels' transform)."""
    plain = impl == "xla"
    cand = cand.long()
    cand_safe = torch.clamp(cand, min=0)
    dots = (knn_rescore.plain_rescore_dots if plain
            else knn_rescore.rescore_dots)
    cdots = dots(queries.contiguous(), vectors.contiguous()[None],
                 cand.to(torch.int32)[None].contiguous())[0]   # [B, R]
    q_sq = (knn_rescore.plain_query_sq if plain
            else knn_rescore.query_sq)(queries)[:, None]
    if similarity == knn_ops.COSINE:
        q_norm = torch.sqrt(q_sq)
        v_norm = torch.sqrt(torch.clamp(norms_sq[cand_safe], min=1e-24))
        raw = cdots / torch.clamp(q_norm * v_norm, min=1e-12)
        score = (1.0 + raw) / 2.0
    else:
        d_sq = torch.clamp(q_sq - 2.0 * cdots + norms_sq[cand_safe], min=0.0)
        score = 1.0 / (1.0 + d_sq)
    ok = (cand >= 0) & valid[cand_safe]
    score = torch.where(ok, score, float("-inf"))
    best, best_pos = stable_topk(score, k_eff)
    best_ids = torch.gather(cand, 1, best_pos)
    best_ids = torch.where(torch.isfinite(best), best_ids, -1)
    return best, best_ids.to(torch.int32)


def pad_to_k(best: torch.Tensor, best_ids: torch.Tensor, k: int):
    """Pad [B, k_eff] results to [B, k] with (-inf, -1)."""
    b, k_eff = best.shape
    if k_eff >= k:
        return best, best_ids
    return (torch.cat([best, best.new_full((b, k - k_eff), float("-inf"))], 1),
            torch.cat([best_ids, best_ids.new_full((b, k - k_eff), -1)], 1))


def sum_subspaces(parts: torch.Tensor) -> torch.Tensor:
    """[B, P, m, L] -> [B, P, L]: the m subspace entries added one after
    another, the order the ADC kernel and the reference's XLA reduce use
    (exact for integers in any order)."""
    if not parts.dtype.is_floating_point:
        return parts.sum(dim=2)
    acc = parts[:, :, 0]
    for mi in range(1, parts.shape[2]):
        acc = acc + parts[:, :, mi]
    return acc


def search(
    coarse: torch.Tensor,       # [nlist, d]
    codebooks: torch.Tensor,    # [m, ks, dsub]
    codes: torch.Tensor,        # uint8 [nlist, L_pad, m]
    ids: torch.Tensor,          # int32 [nlist, L_pad]
    mask: torch.Tensor,         # bool [nlist, L_pad]
    vectors: torch.Tensor,      # f32 [n_pad, d] full precision (rescore)
    norms_sq: torch.Tensor,     # f32 [n_pad]
    valid: torch.Tensor,        # bool [n_pad] live & present
    queries: torch.Tensor,      # f32 [B, d]
    *,
    k: int,
    nprobe: int,
    rerank: int,
    similarity: str = "l2_norm",
    chunk: int = 8,
    adc_precision: str = "fp32",
):
    """Monolithic IVF-PQ ADC search + exact fp32 rescore (policy "xla").
    Returns (scores [B, k] in k-NN score space, doc ids [B, k] int32, -1
    pads). Queries run in chunks, which bounds the [chunk, nprobe, m,
    L_pad] gather. ``adc_precision`` picks the ADC accumulation (candidate
    ranking only; the rescore is always fp32); int8 quantizes each
    (query, probe) LUT with its own affine."""
    check_precision(adc_precision)
    nlist, l_pad, m = codes.shape
    similarity = knn_ops.canonical_similarity(similarity)
    nprobe = min(nprobe, nlist)
    k_eff = min(k, nprobe * l_pad)
    rerank = max(k_eff, min(rerank, nprobe * l_pad))
    c_sq = (coarse * coarse).sum(dim=-1)
    out_v, out_i = [], []
    for lo in range(0, queries.shape[0], chunk):
        q = queries[lo: lo + chunk]
        c = q.shape[0]
        qdots = q @ coarse.T
        # negative l2^2 up to the constant ||q||^2
        _, probe = stable_topk(2.0 * qdots - c_sq[None, :], nprobe)  # [c, P]
        lut = lut_for_probes(q, coarse, codebooks, probe)     # [c, P, m, ks]
        pcodes = codes[probe].long().permute(0, 1, 3, 2)      # [c, P, m, L]
        pids = ids[probe]                                     # [c, P, L]
        pmask = mask[probe]
        if adc_precision == "int8":
            lut_lo = lut.amin(dim=(-2, -1), keepdim=True)     # [c, P, 1, 1]
            lut_hi = lut.amax(dim=(-2, -1), keepdim=True)
            scale = torch.clamp(lut_hi - lut_lo, min=1e-12) / 255.0
            lut_q = torch.clamp(torch.round((lut - lut_lo) / scale),
                                0.0, 255.0).to(torch.uint8)
            gathered = torch.gather(lut_q, 3, pcodes)         # [c, P, m, L]
            acc = sum_subspaces(gathered.to(torch.int32))     # exact
            adc = (acc.to(torch.float32) * scale[..., 0, 0][..., None]
                   + m * lut_lo[..., 0, 0][..., None])
        elif adc_precision == "bf16":
            gathered = torch.gather(lut.to(torch.bfloat16), 3, pcodes)
            # XLA sums a bf16 reduce in f32 and rounds the result to bf16
            adc = sum_subspaces(gathered.to(torch.float32)).to(
                torch.bfloat16).to(torch.float32)
        else:
            adc = sum_subspaces(torch.gather(lut, 3, pcodes))  # [c, P, L]
        adc = torch.where(pmask, adc, float("inf"))
        flat_adc = adc.reshape(c, nprobe * l_pad)
        flat_ids = pids.reshape(c, nprobe * l_pad)
        _, cand_pos = stable_topk(-flat_adc, rerank)
        cand = torch.gather(flat_ids, 1, cand_pos)            # [c, R]
        best, best_ids = exact_rescore(q, cand, vectors, norms_sq, valid,
                                       similarity=similarity, k_eff=k_eff)
        best, best_ids = pad_to_k(best, best_ids, k)
        out_v.append(best)
        out_i.append(best_ids)
    return torch.cat(out_v), torch.cat(out_i)


def default_rerank(k: int, rescore_multiplier: int | None = None) -> int:
    """Exact-rescore pool width before the candidate-count clamp."""
    mult = rescore_multiplier or DEFAULT_RESCORE_MULTIPLIER
    return max(mult * k, 64)


def rescore_pool(index: IVFPQIndex, k: int, nprobe: int,
                 rerank: int) -> int:
    """The effective rescore candidate count `search` uses for this
    index and shape (the same clamp)."""
    nprobe = min(nprobe, index.params.nlist)
    cap = nprobe * index.l_pad
    k_eff = min(k, cap)
    return max(k_eff, min(rerank, cap))


def host_probe_select(index: IVFPQIndex, queries: np.ndarray,
                      nprobe: int) -> np.ndarray:
    """Coarse quantization + probe selection in numpy over the cached host
    centroids. Returns the probe table [B, nprobe] int32, rows ordered by
    descending coarse score with list id ascending on ties (``lax.top_k``'s
    order, so the scan's probe-major candidate order matches the monolithic
    path)."""
    coarse = index.coarse_host
    c_sq = index.coarse_sq_host
    if coarse is None or c_sq is None:
        coarse = index.params.coarse.cpu().numpy().astype(np.float32)
        c_sq = np.sum(coarse * coarse, axis=1)
        index.coarse_host, index.coarse_sq_host = coarse, c_sq
    nprobe = min(nprobe, index.params.nlist)
    # one product a query row: a [B, d] x [d, nlist] product may take
    # another BLAS routine, hence other last bits, for one row than for
    # many, and the probes of a batched search must be its solo ones
    dots = np.stack([coarse @ q for q in queries]) if len(queries) else \
        np.zeros((0, coarse.shape[0]), np.float32)
    score = 2.0 * dots - c_sq[None, :]
    part = np.argpartition(-score, nprobe - 1, axis=1)[:, :nprobe]
    rows = np.take_along_axis(score, part, axis=1)
    # per row: score desc, then list id asc (lexsort is stable)
    order = np.stack([
        np.lexsort((part[i], -rows[i])) for i in range(part.shape[0])
    ])
    return np.take_along_axis(part, order, axis=1).astype(np.int32)


def search_index(
    index: IVFPQIndex,
    vectors: torch.Tensor,
    norms_sq: torch.Tensor,
    valid: torch.Tensor,
    queries,
    *,
    k: int,
    nprobe: int | None = None,
    rerank: int | None = None,
    similarity: str = "l2_norm",
    adc_precision: str = "fp32",
    rescore_multiplier: int | None = None,
    kernel: str = "xla",
):
    """Bind an IVFPQIndex's tensors to the selected ADC scan. ``kernel`` is
    the resolved serving policy (search/ann.resolve_kernel): "xla" runs the
    monolithic :func:`search`; "pallas" runs the cooperative split — probe
    selection on the host (:func:`host_probe_select`), then one batched
    fused pipeline on the device whose scan is the hand-written kernel's
    wrapper (ops/adc_scan.adc_topr_auto). `queries` is a [B, d] numpy
    array or tensor."""
    nprobe = nprobe or DEFAULT_NPROBE
    if rerank is None:
        rerank = default_rerank(k, rescore_multiplier)
    similarity = knn_ops.canonical_similarity(similarity)
    device = index.codes.device
    if kernel == "pallas":
        from opensearch_tpu_torch.ops import adc_scan

        qh = (queries.detach().cpu().numpy() if isinstance(queries, torch.Tensor)
              else np.asarray(queries)).astype(np.float32)
        if index.normalized:
            q_norm = np.linalg.norm(qh, axis=-1, keepdims=True)
            qh = qh / np.maximum(q_norm, 1e-12)
        probes = host_probe_select(index, qh, min(nprobe, index.params.nlist))
        return adc_scan.adc_topr_auto(
            index.params.coarse, index.params.codebooks,
            index.codes, index.ids, index.mask,
            vectors, norms_sq, valid,
            torch.from_numpy(  # tpulint: disable=TPU014 - per-search query rows
                np.ascontiguousarray(qh)).to(device), probes,
            k=k, rerank=rerank, similarity=similarity,
            adc_precision=adc_precision, impl="pallas")
    if kernel != "xla":
        raise ValueError(f"unknown ANN kernel [{kernel}] (pallas or xla)")
    q = torch.as_tensor(  # tpulint: disable=TPU014 - per-search query rows
        queries, dtype=torch.float32).to(device)
    if index.normalized:
        q_norm = torch.linalg.norm(q, dim=-1, keepdim=True)
        q = q / torch.clamp(q_norm, min=1e-12)
    return search(
        index.params.coarse, index.params.codebooks,
        index.codes, index.ids, index.mask,
        vectors, norms_sq, valid, q,
        k=k, nprobe=min(nprobe, index.params.nlist), rerank=rerank,
        similarity=similarity, adc_precision=adc_precision,
    )
