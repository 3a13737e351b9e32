"""Kernel roofline observability: per-launch FLOP/byte accounting.

Counterpart of opensearch_tpu/telemetry/roofline.py. Three pieces:

- an ANALYTIC COST-MODEL REGISTRY (:data:`COST_MODELS`): per kernel
  family, FLOPs and device-memory bytes moved as a pure function of the
  launch parameters the serving tier already has in hand (batch width,
  corpus rows, d, nprobe, m, k, dtype widths). The models are the
  reference's, formula for formula and under the same family names: the
  port's ``pallas`` setting means the hand-written kernel, so
  ``knn_fused_pallas`` is K1 (ops/knn_fused.py) and ``ivfpq_adc_pallas``
  is K2 (ops/adc_scan.py). The adapters read tensor shapes.

- a CALIBRATED PLATFORM PEAK TABLE: a one-shot matmul/copy probe
  (:func:`calibrate`, cached per platform, re-runnable via
  ``POST /_roofline/calibrate``) measures what THIS device sustains. On
  the card the probes fill it (an fp32 product of 4096^3 with TF32 off and
  a 1 GiB copy, timed by CUDA events, best of 3 after a warm-up), so they
  time the card and not a launch; on the CPU they keep the reference's
  small sizes on the host clock. Tests inject a deterministic stub
  (:func:`set_peaks` / :func:`stub_peaks`).

- a process-wide :class:`RooflineRecorder` that folds every fenced launch
  (``profiled_kernel`` entry points under a profiler, the batcher's
  per-shard launches, the stacked serving step) into per-family
  cumulative and EWMA achieved FLOP/s, bytes/s, arithmetic intensity,
  roofline fraction, and a compute-vs-memory-bound verdict. Per-launch
  achieved-GFLOP/s observations ride the EXECUTING node's metrics (the
  ``activate()`` attribution rule), and ``"profile": true`` kernel rows
  carry the family's fields.

``GET /_roofline`` turns the table into a REPORT ranked by LOST TIME
(cumulative fenced wall x the gap to the roofline).

Accounting identity: ``accounted_flops == sum of per-family model
FLOPs`` at all times: a launch is either folded into exactly one family
row or counted in ``unmodeled_launches``, never both, never dropped.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from opensearch_tpu_torch.common import timeutil

# registered metric name for per-launch achieved GFLOP/s observations
# (metric names are constants, never built at the record site);
# the family rides as a LABEL, not in the name
ROOFLINE_GFLOPS_METRIC = "roofline.achieved_gflops"

_EWMA_DECAY = 0.7
# family-map bound: real deployments hold < a dozen families; overflow
# folds into one reserved row so the accounting identity survives a
# pathological family-minting bug instead of hiding it
MAX_FAMILIES = 64
OVERFLOW_FAMILY = "_overflow"

_F32 = 4          # bytes per fp32 element
_I32 = 4
_IDX = 8          # top-k emits (score f32, index i32) pairs
# LUT entry bytes the ADC gather moves per precision (the ANNS-AMP knob)
ADC_LUT_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}


def base_family(family: str) -> str:
    """Strip a ``[variant]`` suffix: the recorder keys rows per variant
    (``ivfpq_search[int8]``) while the model registry keys the family."""
    return family.split("[", 1)[0]


# ---------------------------------------------------------------------------
# analytic cost models
# ---------------------------------------------------------------------------
#
# Each model maps the launch parameters to (flops, hbm_bytes) — the work
# the kernel MUST do and the bytes it MUST move, assuming perfect reuse
# of everything that fits in registers/shared memory. Measured wall against these
# floors is what places a launch on the roofline. Conventions:
#   - a matmul [B,d]x[d,n] is 2·B·n·d FLOPs (multiply + accumulate);
#   - elementwise passes over [B,n] count 1 FLOP per op per element;
#   - the corpus streams from HBM exactly once; queries upload once;
#   - top-k winners return as (f32 score, i32 id) pairs: 8 bytes/row.


def _model_knn_exact(p: dict) -> tuple[int, int]:
    """Exact kNN matmul + score-space map over the full padded column:
    FLOPs = 2·B·n·d (matmul) + 4·B·n (distance/score transform);
    bytes = corpus [n,d] + norms [n] + queries [B,d] + scores [B,n] out.
    """
    b, n, d = int(p["b"]), int(p["n"]), int(p["d"])
    flops = 2 * b * n * d + 4 * b * n
    nbytes = _F32 * (n * d + n + b * d + b * n)
    return flops, nbytes


def _model_knn_raw(p: dict) -> tuple[int, int]:
    """`raw_similarity` (no score-space map): 2·B·n·d + 2·B·n FLOPs,
    same byte traffic as the exact scan."""
    b, n, d = int(p["b"]), int(p["n"]), int(p["d"])
    flops = 2 * b * n * d + 2 * b * n
    nbytes = _F32 * (n * d + n + b * d + b * n)
    return flops, nbytes


def _model_knn_streaming(p: dict) -> tuple[int, int]:
    """Streaming top-k scan (ops/fused.knn_topk_streaming): the same
    matmul work plus a running [B,k] merge per element, but the [B,n]
    score row NEVER lands in HBM — only the [B,k] winners come back.
    FLOPs = 2·B·n·d + 6·B·n; bytes = corpus + norms + queries + B·k·8."""
    b, n, d, k = int(p["b"]), int(p["n"]), int(p["d"]), int(p["k"])
    flops = 2 * b * n * d + 6 * b * n
    nbytes = _F32 * (n * d + n + b * d) + _IDX * b * k
    return flops, nbytes


def _model_ivfpq(p: dict) -> tuple[int, int]:
    """IVF-PQ fused search: coarse quantize + per-probe LUT build + ADC
    gather-accumulate + exact fp32 rescore (ops/ivfpq.search).

    FLOPs: coarse 2·B·nlist·d, LUT 2·B·nprobe·ks·d (the bpms,mks einsum
    over dsub = d/m), ADC 2·B·nprobe·L_pad·m (gather + add), rescore
    2·B·R·d; int8 adds 4·B·nprobe·m·ks for the per-(query,probe) affine
    quantization (min/max/scale/round over the LUT).

    Bytes: codebooks + coarse once, codes gather B·nprobe·L_pad·m (uint8),
    LUT gather B·nprobe·L_pad·m × entry bytes (4/2/1 — the whole point of
    reduced precision is shrinking THIS term), rescore vectors B·R·d·4,
    queries B·d·4. When the measured wall says int8 achieves LESS than
    fp32 against a SMALLER byte floor, the XLA lowering is failing to
    realize the saving — the report's argument for the hand-written
    scan."""
    b = int(p["b"])
    nlist, d, m, ks = int(p["nlist"]), int(p["d"]), int(p["m"]), int(p["ks"])
    nprobe, l_pad, r = int(p["nprobe"]), int(p["l_pad"]), int(p["rescore"])
    precision = str(p.get("adc_precision", "fp32"))
    flops = (2 * b * nlist * d          # coarse quantize
             + 2 * b * nprobe * ks * d  # LUT build
             + 2 * b * nprobe * l_pad * m   # ADC scan
             + 2 * b * r * d)           # exact rescore
    if precision == "int8":
        flops += 4 * b * nprobe * m * ks
    lut_entry = ADC_LUT_BYTES.get(precision, _F32)
    nbytes = (_F32 * (nlist * d + ks * d)         # coarse + codebooks
              + b * nprobe * l_pad * m            # codes (uint8)
              + b * nprobe * l_pad * m * lut_entry  # LUT gather traffic
              + _F32 * (b * r * d + b * d))       # rescore vecs + queries
    return flops, nbytes


def _model_ivfpq_adc_pallas(p: dict) -> tuple[int, int]:
    """K2, the hand-written blockwise ADC scan (ops/adc_scan) behind the
    host/device cooperative split: coarse quantization and probe selection
    run HOST-side (host_probe_select), so neither appears in the device
    model. The device program builds the per-(query,probe) LUTs, streams
    each probed code block through shared memory against the resident
    native-width LUT, keeps a running top-R pool in scratch, and rescores.

    FLOPs: LUT build 2·B·nprobe·ks·d, ADC decode 2·B·nprobe·L_pad·m
    (select + accumulate per code slot — the must-do work, not the
    lowering's), rescore 2·B·R·d; int8 adds 4·B·nprobe·m·ks for the
    per-query affine quantization.

    Bytes: codes stream from HBM ONCE (B·nprobe·L_pad·m uint8), the LUT
    lands in HBM once at NATIVE width (B·nprobe·m·ks × 4/2/1 — resident
    on chip during the scan, never gathered per slot), only the PROBED
    coarse rows (min(nlist, B·nprobe)·d — the full table is a host
    structure now) + codebooks once, queries in, [B,R] winners + rescore
    vectors out. The ``[B, nprobe, L_pad]`` ADC-distance intermediate and
    the per-slot LUT gather traffic of the XLA lowering (_model_ivfpq) do
    NOT exist — that delta is what the kernel swap buys, and why int8's
    byte floor finally reaches device memory."""
    b = int(p["b"])
    nlist, d, m, ks = int(p["nlist"]), int(p["d"]), int(p["m"]), int(p["ks"])
    nprobe, l_pad, r = int(p["nprobe"]), int(p["l_pad"]), int(p["rescore"])
    precision = str(p.get("adc_precision", "fp32"))
    flops = (2 * b * nprobe * ks * d        # LUT build
             + 2 * b * nprobe * l_pad * m   # blockwise ADC decode
             + 2 * b * r * d)               # exact rescore
    if precision == "int8":
        flops += 4 * b * nprobe * m * ks
    lut_entry = ADC_LUT_BYTES.get(precision, _F32)
    nbytes = (_F32 * (min(nlist, b * nprobe) * d + ks * d)  # probed coarse
              + b * nprobe * l_pad * m          # codes stream (uint8)
              + b * nprobe * m * ks * lut_entry  # LUT once, native width
              + _F32 * (b * r * d + b * d)      # rescore vecs + queries
              + _IDX * b * r)                   # [B, R] winners out
    return flops, nbytes


def _model_mesh(p: dict) -> tuple[int, int]:
    """Shard-mesh kNN program (one `shard_map` launch over S shards):
    per-slot exact scan over [S, n_flat, d] + the on-device
    all_gather+top_k cross-shard merge. FLOPs = 2·B·S·n_flat·d +
    4·B·S·n_flat; bytes = slabs + norms/valid + queries + all_gather
    traffic devices·B·k_shard·8."""
    b, s = int(p["b"]), int(p["s"])
    n_flat, d = int(p["n_flat"]), int(p["d"])
    k_shard = int(p["k_shard"])
    devices = int(p.get("devices", s))
    flops = 2 * b * s * n_flat * d + 4 * b * s * n_flat
    nbytes = (_F32 * (s * n_flat * d + 2 * s * n_flat + b * d)
              + _IDX * devices * b * k_shard)
    return flops, nbytes


#: HBM bytes per corpus element at each fused-scan precision
_FUSED_SCAN_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}


def _fused_scan_terms(b: int, n: int, d: int, r: int,
                      precision: str) -> tuple[int, int]:
    """Per-corpus terms of the fused blockwise exact-kNN scan
    (ops/pallas_knn.knn_fused): one [B,d]x[n,d] matmul at the scan
    precision + the transform/pool merge, [B,R] winners out, exact fp32
    rescore when the scan ran reduced. Reduced precisions pay an honest
    per-launch prep pass (read the f32 corpus + write the narrowed
    operand — knn_fused quantizes per launch, nothing is cached), so
    their byte floor is HIGHER than fp32's here; the kernel's win is the
    never-materialized [B,n] score matrix, not corpus bytes."""
    w = _FUSED_SCAN_BYTES.get(precision, _F32)
    flops = 2 * b * n * d + 6 * b * n        # matmul + transform/merge
    nbytes = (w * n * d                      # corpus at scan width
              + _F32 * 2 * n                 # norms + valid
              + _F32 * b * d                 # queries
              + _IDX * b * r)                # [B, R] winners out
    if precision != "fp32":
        flops += 2 * b * r * d + 6 * b * r   # exact fp32 rescore
        nbytes += _F32 * (n * d + b * r * d)  # prep read + rescore gather
        nbytes += w * n * d                  # prep write (narrow operand)
    if precision == "int8":
        flops += 2 * (n * d + b * d)         # quantize round/clip passes
    return flops, nbytes


def _model_knn_fused(p: dict) -> tuple[int, int]:
    """K1, the fused exact-kNN kernel (ops/knn_fused.knn_fused_auto and
    knn_fused_stacked, family knn_fused_pallas): the [B,n] score matrix of the XLA exact
    lowerings NEVER exists — only [B,R] winners land in HBM. That delta
    vs _model_knn_exact's B·n term is what the kernel swap buys on the
    materializing path; vs _model_knn_streaming the win is on-chip
    selection width (the pool of R stays on chip, no per-chunk carries)."""
    b, n, d = int(p["b"]), int(p["n"]), int(p["d"])
    r = int(p.get("r", p.get("k", 10)))
    precision = str(p.get("precision", "fp32"))
    return _fused_scan_terms(b, n, d, r, precision)


def _model_mesh_fused(p: dict) -> tuple[int, int]:
    """Shard-mesh kNN program with the fused per-shard scan:
    S independent fused corpus scans (the _model_knn_fused terms per
    shard slab) + the unchanged on-device all_gather/top_k merge."""
    b, s = int(p["b"]), int(p["s"])
    n_flat, d = int(p["n_flat"]), int(p["d"])
    k_shard = int(p["k_shard"])
    devices = int(p.get("devices", s))
    r = int(p.get("r", k_shard))
    precision = str(p.get("precision", "fp32"))
    flops_1, nbytes_1 = _fused_scan_terms(b, n_flat, d, r, precision)
    flops = s * flops_1
    nbytes = s * nbytes_1 + _IDX * devices * b * k_shard
    return flops, nbytes


def _model_bm25(p: dict) -> tuple[int, int]:
    """BM25 postings scan (ops/bm25.bm25_term_scores): Q padded term
    windows gathered + tf/norm math + scatter-add. 6 FLOPs per posting
    slot; bytes = postings docs/tfs/doc-len gathers + scatter (16·Q·W) +
    the dense [n_pad] score/count columns out (8·n_pad)."""
    q, window, n_pad = int(p["q"]), int(p["window"]), int(p["n_pad"])
    flops = 6 * q * window
    nbytes = 16 * q * window + 8 * n_pad
    return flops, nbytes


def _model_constant_terms(p: dict) -> tuple[int, int]:
    """Constant-score postings scan: no tf/norm math, 2 FLOPs per slot."""
    q, window, n_pad = int(p["q"]), int(p["window"]), int(p["n_pad"])
    flops = 2 * q * window
    nbytes = 8 * q * window + 8 * n_pad
    return flops, nbytes


# family -> model fn(params) -> (flops, hbm_bytes). Every family a
# serving-path launch can report MUST be here.
COST_MODELS: dict[str, Callable[[dict], tuple[int, int]]] = {
    "knn_exact_scores": _model_knn_exact,
    "knn_raw_similarity": _model_knn_raw,
    "knn_topk_streaming": _model_knn_streaming,
    "ivfpq_search": _model_ivfpq,
    "ivfpq_adc_pallas": _model_ivfpq_adc_pallas,
    "knn_fused_pallas": _model_knn_fused,
    "mesh_knn": _model_mesh,
    "mesh_knn_fused": _model_mesh_fused,
    "bm25_term_scores": _model_bm25,
    "constant_term_scores": _model_constant_terms,
}

KNOWN_FAMILIES = frozenset(COST_MODELS)


# shape adapters for profiled_kernel entry points: kernel name ->
# fn(args, kwargs) -> model params. The decorator has the call's arg
# shapes in hand; these map them onto the family's launch parameters.


def _rows(vectors) -> int:
    """Corpus rows of a [n, d] slab, or of a stacked [S, n, d] one."""
    n = 1
    for extent in vectors.shape[:-1]:
        n *= int(extent)
    return n


def _adapt_knn(args: tuple, kwargs: dict) -> dict:
    queries, vectors = args[0], args[1]
    return {"b": int(queries.shape[0]), "n": _rows(vectors),
            "d": int(vectors.shape[-1])}


def _arg(args: tuple, kwargs: dict, pos: int, name: str) -> Any:
    if name in kwargs:
        return kwargs[name]
    return args[pos]


def _adapt_bm25(args: tuple, kwargs: dict) -> dict:
    offsets = _arg(args, kwargs, 3, "offsets")
    return {"q": len(offsets),
            "window": int(_arg(args, kwargs, 8, "window")),
            "n_pad": int(_arg(args, kwargs, 7, "n_pad"))}


def _adapt_constant(args: tuple, kwargs: dict) -> dict:
    offsets = _arg(args, kwargs, 1, "offsets")
    return {"q": len(offsets),
            "window": int(_arg(args, kwargs, 5, "window")),
            "n_pad": int(_arg(args, kwargs, 4, "n_pad"))}


def _adapt_knn_fused(args: tuple, kwargs: dict) -> dict:
    # ops/knn_fused.knn_fused_auto / knn_fused_stacked(vectors, norms_sq,
    # valid, queries, *, k, similarity, score_precision, impl): a stacked
    # [S, n, d] slab counts its S * n rows
    vectors, queries = args[0], args[3]
    k = int(kwargs.get("k", 10))
    precision = str(kwargs.get("score_precision", "fp32"))
    from opensearch_tpu_torch.ops.knn_fused import fused_pool_width

    return {"b": int(queries.shape[0]), "n": _rows(vectors),
            "d": int(vectors.shape[-1]), "k": k,
            "r": fused_pool_width(k, precision), "precision": precision}


def _adapt_adc_topr(args: tuple, kwargs: dict) -> dict:
    # ops/adc_scan.adc_topr_auto(coarse, codebooks, codes, ids, mask,
    # vectors, norms_sq, valid, queries, probes, *, k, rerank, ...)
    coarse, codebooks, codes = args[0], args[1], args[2]
    queries, probes = args[8], args[9]
    return {"b": int(queries.shape[0]),
            "nlist": int(coarse.shape[0]), "d": int(coarse.shape[1]),
            "m": int(codebooks.shape[0]), "ks": int(codebooks.shape[1]),
            "nprobe": int(probes.shape[1]), "l_pad": int(codes.shape[1]),
            "rescore": int(kwargs.get("rerank", 0)),
            "adc_precision": str(kwargs.get("adc_precision", "fp32"))}


_KERNEL_PARAM_ADAPTERS: dict[str, Callable[[tuple, dict], dict]] = {
    "knn_exact_scores": _adapt_knn,
    "knn_raw_similarity": _adapt_knn,
    "knn_fused_pallas": _adapt_knn_fused,
    "ivfpq_adc_pallas": _adapt_adc_topr,
    "bm25_term_scores": _adapt_bm25,
    "constant_term_scores": _adapt_constant,
}


# ---------------------------------------------------------------------------
# platform peaks (calibration)
# ---------------------------------------------------------------------------


class PlatformPeaks:
    """What this backend actually sustains: peak FLOP/s from a large
    fenced matmul, peak HBM bytes/s from an on-device copy. `source` is
    "measured" (the probe ran), "stub" (injected: tests),
    or "fallback" (no backend; fixed conservative numbers so fraction
    math never divides by zero)."""

    __slots__ = ("platform", "flops_per_s", "bytes_per_s", "source",
                 "calibrated_at_ms")

    def __init__(self, platform: str, flops_per_s: float,
                 bytes_per_s: float, source: str = "measured",
                 calibrated_at_ms: int | None = None):
        self.platform = platform
        self.flops_per_s = float(flops_per_s)
        self.bytes_per_s = float(bytes_per_s)
        self.source = source
        self.calibrated_at_ms = (calibrated_at_ms
                                 if calibrated_at_ms is not None
                                 else timeutil.epoch_millis())

    @property
    def ridge_intensity(self) -> float:
        """FLOPs/byte where the roofline's memory slope meets the compute
        ceiling: below it a kernel is memory-bound, above compute-bound."""
        return self.flops_per_s / max(self.bytes_per_s, 1.0)

    def to_dict(self) -> dict:
        return {
            "platform": self.platform,
            "peak_flops_per_s": self.flops_per_s,
            "peak_bytes_per_s": self.bytes_per_s,
            "ridge_intensity": round(self.ridge_intensity, 3),
            "source": self.source,
            "calibrated_at_ms": self.calibrated_at_ms,
        }


_peaks_lock = threading.Lock()
_peaks_by_platform: dict[str, PlatformPeaks] = {}
_active_peaks: PlatformPeaks | None = None


def stub_peaks(seed: int = 0, platform: str = "stub") -> PlatformPeaks:
    """Deterministic calibration stub for tests: peaks
    are a pure function of `seed`, so a replayed run sees byte-identical
    fractions and the probe never runs."""
    # small seed-derived spread keeps distinct seeds distinguishable in
    # assertions without ever touching a clock or RNG
    jitter = 1.0 + (seed % 17) / 100.0
    return PlatformPeaks(platform, 2.0e11 * jitter, 5.0e10 * jitter,
                         source="stub", calibrated_at_ms=0)


def set_peaks(peaks: PlatformPeaks) -> PlatformPeaks:
    """Inject the active peak table (test stub, or an
    operator overriding a bad calibration)."""
    global _active_peaks
    with _peaks_lock:
        _active_peaks = peaks
        _peaks_by_platform[peaks.platform] = peaks
    return peaks


def current_peaks() -> PlatformPeaks | None:
    return _active_peaks


# probe sizes: on the card large enough that the work, not the launch,
# is timed (a 4096^3 fp32 product is 1.4e11 FLOPs, a 1 GiB copy moves
# 2 GiB); on the CPU the reference's small probes, so a CPU node costs
# milliseconds to construct
CARD_MATMUL_N = 4096
CARD_COPY_BYTES = 1 << 30
CPU_MATMUL_N = 512
CPU_COPY_BYTES = 16 << 20


def _platform(device) -> str:
    """The peak table's key: the card's name, or "cpu"."""
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _best_wall_s(fn, device, reps: int = 3) -> float:
    """Best of `reps` timed calls after one warm-up: CUDA events on the
    card (the host clock would time the enqueue), the host clock on the
    CPU."""
    import time as _time

    import torch

    fn()  # warm-up (and, for the product, the library's plan)
    walls = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            walls.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = _time.perf_counter()
            fn()
            walls.append(_time.perf_counter() - t0)
    return max(min(walls), 1e-9)


def _measure_peaks(device) -> PlatformPeaks:
    """The one-shot probe on `device`: an fp32 product (TF32 off) bounds
    peak FLOP/s, a copy (read + write) bounds peak bytes/s, each the best
    of 3 so a hiccup does not under-calibrate the ceiling every fraction
    divides by."""
    import torch

    from opensearch_tpu_torch import backend

    backend.pin_float32()
    on_card = device.type == "cuda"
    m = CARD_MATMUL_N if on_card else CPU_MATMUL_N
    copy_bytes = CARD_COPY_BYTES if on_card else CPU_COPY_BYTES
    a = torch.ones((m, m), dtype=torch.float32, device=device)
    out = torch.empty_like(a)
    flops_per_s = (2 * m ** 3) / _best_wall_s(
        lambda: torch.matmul(a, a, out=out), device)
    del a, out
    src = torch.zeros(copy_bytes // 4, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    bytes_per_s = (2 * copy_bytes) / _best_wall_s(
        lambda: torch.add(src, 1.0, out=dst), device)
    del src, dst
    if on_card:
        torch.cuda.empty_cache()
    return PlatformPeaks(_platform(device), flops_per_s, bytes_per_s,
                         source="measured")


def _probe_device(device):
    """The device a calibration measures: the one named, else the card
    where torch sees one, else the CPU. The peak table is keyed by the
    platform's name, so a CPU figure never stands for the card."""
    import torch

    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def calibrate(force: bool = False, device=None) -> PlatformPeaks:
    """Run (or reuse) the platform calibration of `device` (see
    :func:`_probe_device`). Cached per platform; `force=True` re-measures
    (the `POST /_roofline/calibrate` button)."""
    global _active_peaks
    dev = _probe_device(device)
    platform = _platform(dev)
    if not force:
        with _peaks_lock:
            cached = _peaks_by_platform.get(platform)
            if cached is not None:
                _active_peaks = cached
                return cached
    return set_peaks(_measure_peaks(dev))


def ensure_peaks(device=None) -> PlatformPeaks:
    """The active peak table, calibrating once on first need (cached per
    platform). A stub installed first wins."""
    peaks = _active_peaks
    if peaks is not None:
        return peaks
    return calibrate(device=device)


# ---------------------------------------------------------------------------
# recorder
# ---------------------------------------------------------------------------


class _FamilyStats:
    __slots__ = ("launches", "flops", "bytes", "wall_ns", "card_wall_ns",
                 "ewma_flops_s", "ewma_bytes_s", "seq")

    def __init__(self) -> None:
        self.launches = 0
        self.flops = 0
        self.bytes = 0
        self.wall_ns = 0
        # the wall each launch held its cards, summed: a launch over c
        # distinct cards had c times one card's peaks
        self.card_wall_ns = 0
        self.ewma_flops_s = 0.0
        self.ewma_bytes_s = 0.0
        self.seq = 0  # update sequence: "most recently fed" tie-break


def _sig(x: float, digits: int = 6) -> float:
    """Round to significant figures: stats rows must stay readable
    without ever crushing a truthfully tiny value to a contract-breaking
    0.0 (fractions are in (0, 1] by design)."""
    if x == 0:
        return 0.0
    import math

    return round(x, -int(math.floor(math.log10(abs(x)))) + digits - 1)


def _fraction(achieved_flops_s: float, intensity: float,
              peaks: PlatformPeaks) -> tuple[float, float, str]:
    """(roofline ceiling FLOP/s at this intensity, achieved fraction of
    it clamped to (0, 1], bound verdict). The ceiling is the classic
    roofline: min(peak compute, intensity × peak bandwidth)."""
    ceiling = min(peaks.flops_per_s, intensity * peaks.bytes_per_s)
    ceiling = max(ceiling, 1.0)
    frac = achieved_flops_s / ceiling
    frac = min(max(frac, 1e-9), 1.0)
    bound = "memory" if intensity < peaks.ridge_intensity else "compute"
    return ceiling, frac, bound


class RooflineRecorder:
    """Process-wide per-kernel-family roofline accounting (the same
    scope as the kNN dispatch batcher and the device ledger: one process
    == one device set). Per-launch metric observations attribute to the
    EXECUTING node via ``tracing.active_metrics()`` — the ``activate()``
    rule every process-wide singleton follows."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, _FamilyStats] = {}
        self._seq = 0
        self.metrics = None  # optional telemetry MetricsRegistry sink
        self.counters = {
            "launches": 0,
            "accounted_flops": 0,
            "accounted_bytes": 0,
            "wall_ns": 0,
            # launches with no registered model / no params: counted, so
            # the accounting identity says exactly what it covers
            "unmodeled_launches": 0,
        }

    # -- producer side -------------------------------------------------------

    def record(self, family: str, wall_ns: int, params: dict | None = None,
               flops: int | None = None, nbytes: int | None = None,
               cards: int = 1) -> None:
        """Fold one fenced launch into the family's row. `flops`/`nbytes`
        may be passed precomputed; otherwise the registry model for
        ``base_family(family)`` computes them from `params`. `cards` is the
        number of distinct cards the launch ran on (a mesh launch over
        several): its bound is the per-card peaks times that number."""
        if flops is None or nbytes is None:
            model = COST_MODELS.get(base_family(family))
            if model is None or params is None:
                with self._lock:
                    self.counters["unmodeled_launches"] += 1
                return
            flops, nbytes = model(params)
        wall_ns = max(int(wall_ns), 1)
        wall_s = wall_ns / 1e9
        inst_flops_s = flops / wall_s
        inst_bytes_s = nbytes / wall_s
        with self._lock:
            fam = self._families.get(family)
            if fam is None:
                if len(self._families) >= MAX_FAMILIES:
                    family = OVERFLOW_FAMILY
                    fam = self._families.get(family)
                if fam is None:
                    fam = self._families[family] = _FamilyStats()
            fam.launches += 1
            fam.flops += flops
            fam.bytes += nbytes
            fam.wall_ns += wall_ns
            fam.card_wall_ns += wall_ns * max(int(cards), 1)
            if fam.ewma_flops_s <= 0.0:
                fam.ewma_flops_s = inst_flops_s
                fam.ewma_bytes_s = inst_bytes_s
            else:
                fam.ewma_flops_s = (_EWMA_DECAY * fam.ewma_flops_s
                                    + (1 - _EWMA_DECAY) * inst_flops_s)
                fam.ewma_bytes_s = (_EWMA_DECAY * fam.ewma_bytes_s
                                    + (1 - _EWMA_DECAY) * inst_bytes_s)
            self._seq += 1
            fam.seq = self._seq
            self.counters["launches"] += 1
            self.counters["accounted_flops"] += flops
            self.counters["accounted_bytes"] += nbytes
            self.counters["wall_ns"] += wall_ns
        # per-launch observation into the EXECUTING node's registry (the
        # exemplar trace_id must resolve in the recording node's ring),
        # else the attached sink — the batcher's attribution rule
        from opensearch_tpu_torch.telemetry.tracing import active_metrics

        metrics = active_metrics() or self.metrics
        if metrics is not None:
            metrics.histogram(ROOFLINE_GFLOPS_METRIC,
                              labels={"family": family}).record(
                inst_flops_s / 1e9)

    # -- introspection -------------------------------------------------------

    def _family_row(self, name: str, fam: _FamilyStats,
                    peaks: PlatformPeaks) -> dict:
        wall_s = max(fam.wall_ns, 1) / 1e9
        achieved_flops_s = fam.flops / wall_s
        achieved_bytes_s = fam.bytes / wall_s
        intensity = fam.flops / max(fam.bytes, 1)
        # the peaks of the cards the launches held, weighted by wall
        cards = fam.card_wall_ns / max(fam.wall_ns, 1)
        if cards != 1:
            peaks = PlatformPeaks(peaks.platform, peaks.flops_per_s * cards,
                                  peaks.bytes_per_s * cards, peaks.source,
                                  peaks.calibrated_at_ms)
        ceiling, frac, bound = _fraction(achieved_flops_s, intensity, peaks)
        row = {
            "family": name,
            "launches": fam.launches,
            "flops": fam.flops,
            "bytes": fam.bytes,
            "wall_ms": round(fam.wall_ns / 1e6, 3),
            "achieved_gflops": _sig(achieved_flops_s / 1e9),
            "ewma_gflops": _sig(fam.ewma_flops_s / 1e9),
            "achieved_gbytes_s": _sig(achieved_bytes_s / 1e9),
            "intensity": _sig(intensity),
            "roofline_gflops": _sig(ceiling / 1e9),
            "roofline_fraction": _sig(frac),
            "bound": bound,
            # the report's ranking key: wall spent × gap to the roofline
            "lost_ms": round((fam.wall_ns / 1e6) * (1.0 - frac), 3),
        }
        if cards != 1:
            row["cards"] = _sig(cards)
        return row

    def family_names(self) -> list[str]:
        with self._lock:
            return list(self._families)

    def kernel_row_fields(self, name: str) -> dict:
        """The roofline fields a ``"profile": true`` kernel row carries:
        matches the kernel's family directly or its most recently fed
        variant (``ivfpq_search`` -> ``ivfpq_search[int8]``)."""
        # peaks resolve BEFORE the lock (first need may calibrate); the
        # row builds UNDER it so a concurrent record() can't be observed
        # mid-update (flops bumped, wall not yet)
        peaks = ensure_peaks()
        with self._lock:
            match: tuple[str, _FamilyStats] | None = None
            for fname, fam in self._families.items():
                if fname == name or base_family(fname) == name:
                    if match is None or fam.seq > match[1].seq:
                        match = (fname, fam)
            if match is None:
                return {}
            row = self._family_row(match[0], match[1], peaks)
        return {
            "achieved_gflops": row["ewma_gflops"],
            "intensity": row["intensity"],
            "roofline_fraction": row["roofline_fraction"],
            "bound": row["bound"],
        }

    def snapshot_stats(self) -> dict:
        """The ``_nodes/stats`` ``roofline`` section: peaks, per-family
        rows, cumulative counters, and the accounting identity."""
        peaks = ensure_peaks()
        with self._lock:
            families = {
                name: self._family_row(name, fam, peaks)
                for name, fam in self._families.items()
            }
            counters = dict(self.counters)
        total_flops = sum(row["flops"] for row in families.values())
        return {
            "peaks": peaks.to_dict(),
            "families": families,
            "counters": counters,
            "identity_ok": total_flops == counters["accounted_flops"],
        }

    def report(self) -> dict:
        """The ``GET /_roofline`` report: families ranked by LOST TIME
        (cumulative fenced wall × gap-to-roofline) — the priority list
        for kernel work. The top row is where a Pallas rewrite buys the
        most wall-clock back."""
        snap = self.snapshot_stats()
        rows = sorted(snap["families"].values(),
                      key=lambda r: -r["lost_ms"])
        by_name = {r["family"]: r for r in rows}
        # the fused Pallas ADC scan SERVING clears the inversion note: the
        # XLA rows defer to the fused ones only while the fused family is
        # the more recently fed of the two (cumulative rows never leave
        # the map, so presence alone would latch the note forever after a
        # brief policy trial — recency is what "selected" means here)
        with self._lock:
            seqs = {name: fam.seq for name, fam in self._families.items()}
        fused_seq = max((s for n, s in seqs.items()
                         if base_family(n) == "ivfpq_adc_pallas"),
                        default=0)
        xla_seq = max((s for n, s in seqs.items()
                       if base_family(n) == "ivfpq_search"), default=0)
        fused_live = fused_seq > xla_seq
        int8 = by_name.get("ivfpq_search[int8]")
        fp32 = by_name.get("ivfpq_search[fp32]")
        if (int8 is not None and fp32 is not None
                and int8["achieved_gflops"] < fp32["achieved_gflops"]):
            if fused_live:
                int8["note"] = (
                    "legacy XLA lowering (gather widens the quantized "
                    "LUT); the fused Pallas ADC scan "
                    "(ivfpq_adc_pallas[*], search.knn.ann.kernel) is "
                    "serving this corpus — compare those rows instead.")
            else:
                int8["note"] = (
                    "int8 ADC achieves less than fp32 against a SMALLER "
                    "modeled byte floor: the XLA lowering widens the "
                    "quantized LUT through the gather, so the byte saving "
                    "never reaches HBM — the QPS inversion in "
                    "BENCH_ANN.json. Select the fused Pallas blockwise "
                    "ADC scan (search.knn.ann.kernel=pallas, ROADMAP "
                    "item 2) — it is where this precision pays.")
        return {
            "peaks": snap["peaks"],
            "counters": snap["counters"],
            "identity_ok": snap["identity_ok"],
            "families": rows,
            "top_offender": rows[0]["family"] if rows else None,
        }

    def reset(self) -> None:
        """Test hook: forget every family and counter."""
        with self._lock:
            self._families.clear()
            self._seq = 0
            for k in self.counters:
                self.counters[k] = 0


# process-wide default: launch sites are module-level code with no node
# handle (the batcher/ledger pattern); one recorder a process.
default_recorder = RooflineRecorder()


def record_launch(family: str, wall_ns: int, **params: Any) -> None:
    """Module-level convenience for launch sites: fold one fenced launch
    with its model parameters into the default recorder."""
    default_recorder.record(family, wall_ns, params=params)


def observe_kernel(name: str, args: tuple, kwargs: dict,
                   wall_ns: int) -> None:
    """`profiled_kernel` hook: derive the model parameters from the
    call's argument shapes (the registered adapter) and fold the fenced
    launch. Families without an adapter count as unmodeled."""
    adapter = _KERNEL_PARAM_ADAPTERS.get(name)
    params = adapter(args, kwargs) if adapter is not None else None
    default_recorder.record(name, wall_ns, params=params)


def stats_section() -> dict:
    """The `_nodes/stats` `roofline` section — ONE assembly shared by the
    single-node REST handler and the cluster per-node RPC (the
    device-ledger precedent, so the two surfaces cannot drift)."""
    return default_recorder.snapshot_stats()
