"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N]
                          [--phases kernel,timing,main|filtered|rest,
                                    hybrid,large]
                          [--kernels knn_fused,adc_scan,knn_block,knn_pb,
                                     knn_sbmax,knn_rescore,adc_lut]

Builds the port's CUDA kernels from the sources in this checkout (one
nvcc per source, all started together): K1 (csrc/knn_fused.cu, fused exact
kNN: the list scan of csrc/knn_pool.cuh at fp32 with r <= 32, its wide
tier, csrc/knn_wide.cuh, at fp32 with 32 < r <= 1024, its large-r tier,
csrc/knn_large.cuh, at fp32 past r = 1024, the wide tier's tensor-core
scan, csrc/knn_wide_mma.cuh, at bf16 and int8 with r <= 1024, the large-r
tier's tensor-core scan, csrc/knn_large_mma.cuh, there past r = 1024; the
tile scan of csrc/knn_tile.cuh serves no shape and is timed beside them),
the fixed-order rescore and |q|^2 (csrc/knn_rescore.cu:
knn_rescore_kernel, knn_query_sq_kernel; no Pallas counterpart: they
replace a batched einsum and a row sum, so a batched search gets a solo
one's bits; the IVF-PQ rescore takes their dots alone), the IVF-PQ LUT
build (csrc/adc_lut.cu: adc_lut_kernel, each sum in one order whatever the
batch; no Pallas counterpart), K2
(csrc/adc_scan.cu, the IVF-PQ ADC scan) and the exact-scan family K3
(csrc/knn_block.cu, running top-k: the list scan and its wide tier), K4 (csrc/knn_pb.cu: per-block top-k, then the
block-major merge, two kernels) and K5 (csrc/knn_sbmax.cu: sub-block
maxima, then the selection and rescore, two kernels). ``--kernels`` limits
the kernel and timing phases to
the named kernels (default all seven; the main phase needs K1, K2, the
rescore and the LUT kernel).
Then:

1. kernel: holds each kernel against its plain PyTorch version on the card.
   K1's large-r tier (large_kernel_phase) on clustered floats, bit for bit
   against kernel_order_pool: one shard of 60,000 128-d docs at B = 1, 9
   and 33 x r = 1025, 1400, 2000, 4096, 10,000 and 20,000 (five tiles and
   three merge rounds), 20,000 768-d docs to r = 10,000, four shards (one
   with 5 live docs) at B = 1, 9 and 33, d = 30, r past a shard's live
   count, which returns every live doc, and 20,000 copies of one vector
   (every score equal); at every check the multi-CTA select again on the
   scan's keys by both sorts and the one-CTA yardstick, all bit-equal to
   the pool; the tile scan beside it at r = 1025 and 1400. The select on
   key rows built to stress it (select_stress_check): every live doc one
   score, a first-level bin of exactly the keys needed, r the live count
   and past it, four shards, B = 33 over four shards; bit-equal to
   plain_large_select. The
   large-r tier at bf16 and int8 (large_mma_kernel_phase) on clustered
   floats, one shard of 60,000 128-d docs and one of 20,000 768-d docs at
   B = 1, 9 and 33 x r = 1025, 2000, 4096 and 10,000, l2 and cosine, int8
   bit-equal to plain_pool, bf16 ids equal but at logged summation ties
   (at d = 768 every score within its f32 error bound, f32_bound_check);
   on mma_sixteenths bit-equal at both precisions; four shards; the
   r = 1025 pool's first 1024 slots the tensor-core tier's r = 1024 pool
   bit for bit. The LUT kernel (lut_kernel_phase) bit-equal to its plain
   version at glove-100's and cell C's shapes (B = 1, 8, 32) and 768-d
   m = 96, through build_luts at bf16 and u8 too, each batch row its solo
   LUT; the rescore's dots alone bit-equal to theirs; the host's batched
   probe product against one a row, logged. The
   rescore and |q|^2 (rescore_kernel_phase): bit-equal to their plain
   versions on sixteenths and on floats (a float difference would be
   logged and held to the f32 bound), every batch row its solo call's
   bits, at B = 1, 8 and 33 x R = 40-512, d = 100, 128 and 768.
   K1: fp32, bf16 and int8 x l2, cosine and dot (n = 50,000, d = 128,
   B = 16, k = 10, 3% dead docs, planted duplicate vectors), and at the
   shapes the main path gives it. int8 pools must be bit-equal; fp32 ids
   equal and bf16 ids equal but at summation ties (summation_ties: two
   docs whose f64 scores lie within what an f32 summation of the d
   products can move them, each logged), scores within rtol 1e-5 / atol
   2e-3: the kernel sums the d products in another order than cuBLAS (at
   B = 1 PyTorch's product reduces as a tree; bf16 on the tensor cores),
   and for a near neighbour l2's |q|^2 - 2 q.v + |v|^2 cancels, so each
   ulp of a dot near |q|^2 ~ 2,000 (2.4e-4) reaches the score almost
   whole. K1's tensor-core tier (mma_kernel_phase) at bf16 and int8 on
   sixteenths narrow enough (mma_sixteenths: k^2 d <= 2^18) that the
   tensor cores' f32 sums of bf16 products are exact, bit for bit with
   the planted ties in id order: one shard of 300,001 docs at B = 1, 5,
   8, 9, 32, 33 and 129 x r = 32, 40, 100, 400, 512 and 1024, four shards
   of 200,000 (one with 5 live docs), d = 30, 100 and 768, n = 90 and
   1,000, operands off a 16-byte boundary; on clustered floats int8 still
   bit for bit, bf16 ids equal but at summation ties. K1's list scan
   (lists_kernel_phase) on sixteenths, bit for bit
   with its planted ties in id order: one shard of 300,001 docs at B = 1,
   5, 8, 9, 32, 33, 128 and 129 x r = 1, 10 and 32 (and 33, the wide
   tier), four shards of 200,000 (one with 5 live docs), d = 30 and 768,
   operands off a 16-byte boundary; then on clustered floats, ids equal
   but at near ties (scores within a relative 1e-5, ranked the other way
   by the other summation order) and scores within rtol 1e-5 / atol 2e-3.
   The wide tier of K1 and K3 (wide_kernel_phase) on sixteenths, bit for
   bit, at B = 1, 5, 8, 9, 32, 33 and 129 x r = 33, 64, 100, 128, 256 and
   1024, one and four shards (one with 5 live docs, fewer than r), d = 30,
   128 and 768, unaligned operands, n = 90 and 1,000 (ranges shorter than
   r), planted duplicates across a range edge and within a sub-block, and
   a shard whose near docs fill 24 whole ranges at r = 1024, so the split
   merge's candidates overflow shared memory and it reads every slot from
   device memory (merge_fallback_check); on clustered floats bit for bit
   against kernel_order_pool, a brute force summed in the kernel's order
   (plain_pool's cuBLAS order ranks some neighbours the other way at
   r >= 100: each such slot is logged with both docs' f64 scores). The tile
   scan, which still serves fp32 past r = 1024 and is timed beside the
   list scan and its wide tier: bit-equal at r = 1025 and 1400 on
   sixteenths (lists_kernel_phase), K3's copy at k = 100
   (blocks_kernel_phase), and before each of its timings against
   kernel_order_pool (fp32), plain_pool (int8 bit for bit, bf16 but at
   summation ties) or, on integer data, plain_block_topk.
   K2 (csrc/adc_scan.cu: stage 1 adc_scan_kernel, stage 2
   adc_merge_kernel; adc_kernel_phase): an IVF-PQ build of n = 100,000,
   d = 100 (nlist 64, m 20), P = 8, at B = 1, 8, 16, 33 and 129 x R = 1,
   10, 63, 64, 65, 500 and 4096; random slabs at m = 8 (ragged and empty
   lists), m = 96 (a 96 KB fp32 LUT) and m = 30 (the byte path, live < R);
   600 identical zero-scoring rows a list, so the threshold ties across
   parts and probes; a merge past shared memory (R = 4096 and 20,000); the
   ragged-and-empty synthetic slab and a planted identical-code tie; each
   for fp32, bf16 and uint8 LUTs. int8 pools must be bit-equal; fp32 and
   bf16 ids equal and scores within rtol 1e-6 / atol 1e-6: kernel and
   plain add the m LUT entries in the same order with round-to-nearest f32
   adds, so they should agree to the bit; the tolerance allows a rounding,
   never a reordering of candidates.
   K3: n = 50,000 (ragged past the block), d = 128, 3% dead docs, a
   duplicate planted across the block boundary, B = 1, 5, 16, 40 and 129,
   k = 10 and 32 (the list scan) and 100 (the wide tier), l2, cosine and
   dot. K4
   (pb_kernel_phase): n = 50,000 with a duplicate across a block edge and
   a run of 12 equal vectors inside a block, B = 1, 5, 8, 9, 16, 32, 33,
   40, 128 and 129 (its query tiles 8, 32 and 128, full and partial),
   k = 10, 32, 33, 100 and 2048 (both tiers), at d = 128, 30 (padded) and
   768 (chunked), operands off a 16-byte boundary, and n = 300,000 (CTAs
   walking several blocks). K5 (sbmax_kernel_phase) on the same kind of
   data with one vector planted in 13 sub-blocks and one all-dead
   sub-block, at the same B and k = 10, 100 and n_sub = 400, then at
   d = 30 and off a 16-byte boundary. Each stage is held against its own
   plain version. The data are multiples of 1/16, so every dot is exact in
   f32 in any order: stage 1 (K3's pools, K4's per-block pools, K5's
   maxima), K4's and K5's stage 2 and the whole entry point must equal the
   plain versions bit for bit, and the lower id must win the planted ties.
   exact=False runs on the same data plus 2^-14, which the bf16 rounding
   of the operands must remove.
2. timing: CUDA-event times of each kernel, its plain version and a library
   yardstick where one exists, beside the bound, with the memory clock
   read before and after each window. K1 at the SIFT-1M shape
   (n = 1,000,000, d = 128, f32, l2, k = 10) at B = 1, 32 and 128, and at
   the serving shapes (one shard of 200,000 docs at B = 1 and 8, four of
   5,000 at B = 1): the list scan's time and its two kernels' device ms by
   name, the tile scan's on the same inputs; library is torch.topk over
   the l2-transformed q @ v.T (never called by the port); bound
   max(bytes / 3.35 TB/s, 2*B*n*d / 67 TFLOP/s). Then the wide records
   (wide_timing_phase) at the SIFT-1M shape: K1 at fp32 r = 64, 100 and
   128 at B = 1, 8, 32 and 128 (the wide tier), at bf16 and int8 with
   k = 10 and 100 at B = 1, 8 and 32 (the tensor-core tier), and K3 at
   k = 64, 128, 256 and 1024 at B = 1 and 32, each beside the tile scan on
   the same call. K2 at the
   glove-100 shape (1,200,000 x 100-d, cosine, m = 20, nlist = 512,
   nprobe = 8, R = 64) at B = 1 and 32 and on cell C's index (200,000 such
   docs) at B = 1 and 8, built with the port's ivfpq.build on the card,
   each stage's device ms read by kernel name (stage1_device_ms,
   stage2_device_ms): bound max(bytes / 3.35 TB/s, lookups / 67 T/s), both counted from the
   run's probes (adc_bound: each distinct probed list's live codes and mask
   once, the LUTs, the winners' ids, the pool); no single PyTorch call
   computes an ADC top-R, so K2 has no library time. K3, K4, K5 through
   their entry points at the SIFT-1M shape (SIFT-style integer
   descriptors) at B = 1, 32 and 128 (K3 beside its tile scan): first one
   call per B with the launch counts set to 0 (their path), each answer the
   brute-force top-10 in order with its scores bit for bit, and each
   kernel's stage 1 bit-equal to its own plain version at every B; then
   the call's time, its device time under torch.profiler (K4 and K5: each
   stage's too, by kernel name), the plain pipeline's, the library
   yardstick's and the bound (slab, norms, flags and queries read once,
   what the kernel writes, against 2*B*n*d operations).
3. main: drives TorchNode on the card. Exact (K1): index A (1 shard,
   200,000 clustered 128-d docs, with the k-NN plugin perf-tool filtering
   specs' age, color and taste columns from --seed) and index B (4
   shards, 20,000 docs), 64
   knn searches each; every hit list must equal the brute-force truth in
   the same order, every search must go through the stacked serving path
   and K1's list scan (its counter), whose step is timed (200 steps) and
   profiled by kernel name. Then index A on the per-shard route (distributed_serving off):
   32 searches at k = 256, size = 10 must equal the brute force and each
   take the streaming scan, and 64 searches from 8 threads (K1 through the
   dispatch batcher) must equal the same searches run one at a time; in
   the gated run (each round of 8 released together, a 50 ms batch
   window) with a mean merged batch above 1 and fewer K1 launches than
   searches, every K1 launch on the list scan. Then index A at k = 100,
   size = 100 (wide_main_phase): 64 searches through the stacked step,
   32 on the per-shard route (k_bucket 128) and 8 threads x 8 through the
   batcher, every hit list the brute-force top-100 in order, every K1
   launch of each path (counted from 0) on the wide tier. Then index A at
   search.knn.score_precision bf16 and int8 (reduced_main_phase), k = 10
   and 100: 32 searches through the stacked step, 16 on the per-shard
   route and 8 threads x 8 through the batcher (gated only), every K1
   launch of each path on the tensor-core tier, every solo hit list the
   plain pipeline's on the node's own slab (bf16: but at summation ties
   of the pool), recall@k against the fp32 brute force printed; and one
   stacked step a precision and k split by kernel name (prep, scan,
   merge, rescore).
   Then (stacked_batch_phase) 8 queries in one stacked launch against
   each alone at fp32, bf16 and int8, k = 10 and 100: bit for bit. Then
   filtered kNN (filtered_main_phase): the relaxed (~40%), restrictive
   (~1%) and 50-ids filters at fp32 k = 10 and 100, bf16 and int8 k = 10,
   8 searches each on both routes, every hit list the brute force over the
   filtered docs (fp32, kernel order) or the plain pipeline (bf16, int8),
   one K1 launch a search on the tier scan_tier names, each stacked one
   counted in "filtered"; the mask build's and the filtered step's device
   ms beside the unfiltered step's. Then the stacked step past r = 1024
   (large_main_phase): k = 1025, 2000 and 4096 on a 768-d index of 20,000
   docs, k = 10,000 on index A, k = 5,000 on 1,500 docs (every live doc),
   each hit list the kernel-order brute force, one large-r launch and one
   launch of its multi-CTA select a search, none of the yardstick; then
   at bf16 and int8 (large_reduced_main) k = 1025, 2000 and 4096 on the
   768-d index and 10,000 on index A, each hit list the plain
   pipeline's (bf16: but at logged summation ties of the pool), one
   launch a search on the large-r tier's tensor-core scan, none on the
   tile scan. msearch (msearch_main_phase): one msearch of 32 bare knn
   bodies on index A at fp32 k = 10 and 100 and bf16 k = 10, each body's
   hits its solo search's bit for bit, one K1 launch a run on the tier
   scan_tier names, batched_queries up by 32; a mixed run whose fourth
   body carries a filter goes one body at a time; the msearch p50 beside
   32 solo searches, the B = 32 step's device ms beside 32 B = 1 steps.
   The REST path (rest_main_phase): the port's HTTP server
   (opensearch_tpu_torch/rest/http.py) on 127.0.0.1:0 in a thread over
   the same node: a 4-shard index of 20,000 docs written over HTTP (one
   NDJSON _bulk, _refresh, PUT / GET / _update / DELETE of one doc with
   its versions and seq_nos) and 32 searches on it; kNN _search on index
   A at k = 10 (64) and 100 (16), each response node.search's bits and
   the K1 launches (all, and on the list scan or wide tier) the
   in-process run's, p50 / p99 / QPS beside in process; eight fetch
   options, each response the in-process one field for field; an NDJSON
   _msearch of 32 in one K1 launch; 8 HTTP clients x 8 searches on the
   stacked step and the per-shard route, each its solo search's bits;
   "profile": true of the in-process profile's shape with its K1 launch's
   device_time_in_nanos > 0; a match query and GET /_cat/indices the 500
   "not yet ported" envelope on a connection that then serves a search;
   and the in-process p50 with the profiler's hooks and without.
   ``--phases rest`` builds index A and runs this phase alone.
   Every concurrent (gated) check, of K1's paths and of index C's IVF-PQ
   route, holds ids and scores bit for bit to the solo search.
   ANN (K2): index C (1 shard, 200,000 clustered 100-d docs, cosine,
   ivf_pq nlist 512, m 20, nprobe 8; cut from 1.2M by host ingest), 64 knn
   searches, k = 10; every hit list must equal the plain pipeline
   (adc_topr_auto impl="xla") on the same index and probes, every search
   must take the per-shard ANN branch and launch K2. Under the relaxed
   filter (it has the same attribute columns) 16 searches on each route
   are exact K1 searches with no K2 launch, equal to the cosine brute force
   over the filtered docs. Recall@10 against
   exact cosine brute force is printed, not gated. Then a second refresh
   adds 300 docs (below min_train, so an exact segment) and 16 searches
   over both segments must equal the plain pipeline and launch K2 and K1
   (the per-shard route's exact branch) each time; 16 more at k = 256 must
   take the materializing scan on the small segment and equal the plain
   pipeline; and the 64 searches from 8 threads must equal the solo ones,
   with fewer K2 and K1 launches than searches in the gated run. Each
   8-thread run is repeated free-running under the default batch window
   (measured, not gated) and with the batcher off; p50, p99 and QPS are
   printed solo, concurrent and concurrent without the batcher. An ANN
   batch of 8 through the fused pipeline (ann_batch_check) equals its 8
   solo calls bit for bit at fp32, bf16 and u8 ADC.
``--phases large`` runs the large-r tier's kernel checks, the select's
stress rows and the large-r records alone (the quick loop for that tier):
each shape of PERF.md's large-r table at fp32, bf16 and int8, the tier,
its select by each sort, the yardstick, the plain versions and the
library calls, logged as `large record` lines.
4. hybrid (also after main): the hybrid BM25 + kNN program at
   BASELINE.md row 4's full width (hybrid_main_phase: 1,000,000 128-d
   docs, 64 terms x 2,000 postings, 8 query terms, window 128, k = 10,
   4 batches of 200), ids the fp64 host hybrid's on a 50,000-doc
   subsample but at logged f32 ties, a batch twice the same bits,
   graft_entry.entry() on the card against its CPU run; the batch p50,
   QPS, device split by stage and the bound.

Prints the card's name and power limit, one JSON line of kernel numbers,
and last `{"ok": true, "device": {...}}`; logs each phase's wall seconds. Exits non-zero, with no result
line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
FP32_FLOP_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
# H100 SXM peak a second by operand type (dense tensor-core rates for bf16
# and int8), for the bound of a scan at that precision
PEAK_OPS_PER_S = {"fp32": FP32_FLOP_PER_S, "bf16": 989e12, "int8": 1979e12}
DIM = 128
ANN_DIM = 100                 # glove-100
ANN_M = 20
K2_PARITY_DOCS = 100_000      # K2 kernel phase build
GLOVE_DOCS = 1_200_000        # K2 timing phase (the glove-100 corpus size)
SIFT_DOCS = 1_000_000         # K3-K5 timing phase (the SIFT-1M corpus size)
ANN_MAIN_DOCS = 200_000       # index C (cut from 1.2M by host ingest)
KERNELS = ("knn_fused", "adc_scan", "knn_block", "knn_pb", "knn_sbmax",
           "knn_rescore", "adc_lut")
SIMS = ("l2_norm", "cosine", "dot_product")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def clustered(rng, n: int, d: int, n_centers: int = 64) -> np.ndarray:
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 4.0
    return (centers[rng.integers(0, n_centers, n)]
            + rng.standard_normal((n, d)).astype(np.float32))


def time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, reps: int) -> dict | None:
    """Host wall ms per call under the profiler and the summed device time
    per call of every CUDA kernel it ran (torch.profiler, CUPTI). The
    profiler slows the host, so an idle share divides the device time by
    an unprofiled wall. None, with a log line, if the profiler records no
    device time on this machine."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
        kernels = {}
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            # kernels whose names share the first 60 characters add up
            key = evt.key[:60]
            kernels[key] = kernels.get(key, 0.0) + us / 1e3 / reps
    except Exception as exc:  # measurement only: the checks run elsewhere
        log(f"torch.profiler gave no device times ({exc!r}): not measured")
        return None
    if not kernels:
        log("torch.profiler recorded no CUDA kernel: not measured")
        return None
    busy = sum(kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:6])
    return {"wall_ms": wall, "device_ms": busy, "top": top,
            "kernels": kernels}


def mem_clock() -> str:
    """The card's memory clock now, as nvidia-smi reads it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.mem", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def kernel_ms(prof: dict | None, part: str) -> float | None:
    """Device ms per call of the profiled kernels whose name holds `part`."""
    if prof is None:
        return None
    return sum(ms for key, ms in prof["kernels"].items() if part in key)


def scan_inputs(kf, vectors, norms, valid, queries, k, prec):
    """Operands of one pool scan exactly as knn_fused_stacked makes them."""
    n = vectors.shape[1]
    n_pad = -(-n // kf.FK_BLOCK) * kf.FK_BLOCK
    r = min(kf.fused_pool_width(min(k, n_pad), prec), n_pad)
    qsq = (queries * queries).sum(dim=1)
    v_x, q_x, scale = kf._prep_operands(vectors, queries, prec)
    return (v_x.contiguous(), norms.contiguous(), valid.contiguous(),
            q_x.contiguous(), qsq, scale), r


def compare_pools(kf, args, r, sim, prec, what: str,
                  bits: bool = False) -> float:
    """Kernel vs plain pool on the same operands; returns max |dv|. int8
    pools, and any pool when `bits` (data whose dots are exact in f32),
    must be bit-equal."""
    kv, ki = kf.pool_scan(*args, r=r, similarity=sim, score_precision=prec)
    pv, pi = kf.plain_pool(*args, r=r, similarity=sim, score_precision=prec)
    torch.cuda.synchronize()
    if not torch.equal(ki, pi):
        bad = (ki != pi).nonzero()[:5].tolist()
        seen = [(tuple(i), (float(kv[tuple(i)]), int(ki[tuple(i)])),
                 (float(pv[tuple(i)]), int(pi[tuple(i)]))) for i in bad]
        raise AssertionError(f"{what}: ids differ at (slot, kernel (score, "
                             f"id), plain (score, id)) {seen}")
    fin = torch.isfinite(pv)
    if not torch.equal(fin, torch.isfinite(kv)):
        raise AssertionError(f"{what}: finite slots differ")
    if prec == "int8" or bits:
        if not torch.equal(kv, pv):
            raise AssertionError(f"{what}: pool not bit-equal")
    elif not torch.allclose(kv[fin], pv[fin], rtol=1e-5, atol=2e-3):
        raise AssertionError(f"{what}: scores beyond rtol 1e-5 / atol 2e-3")
    return float((kv[fin] - pv[fin]).abs().max()) if bool(fin.any()) else 0.0


def kernel_phase(kf, dev, seed: int) -> float:
    rng = np.random.default_rng(seed)
    n, b, k = 50_000, 16, 10
    data = clustered(rng, n, DIM)
    for i in range(50):                       # planted exact duplicates
        data[n - 1 - i] = data[i * 97]
    valid = np.ones(n, bool)
    valid[rng.choice(n, int(0.03 * n), replace=False)] = False
    queries = data[rng.choice(n, b, replace=False)] + 0.01 * rng.standard_normal(
        (b, DIM)).astype(np.float32)
    queries[0] = data[97]                     # hits a planted tie
    v = torch.from_numpy(data)[None].to(dev)
    nrm = torch.from_numpy((data.astype(np.float64) ** 2).sum(1).astype(
        np.float32))[None].to(dev)
    ok = torch.from_numpy(valid)[None].to(dev)
    q = torch.from_numpy(queries).to(dev)
    err = 0.0
    for prec in kf.SCORE_PRECISIONS:
        for sim in SIMS:
            args, r = scan_inputs(kf, v, nrm, ok, q, k, prec)
            if prec == "bf16":
                # the tensor cores sum in another order than cuBLAS
                e = bf16_float_check(kf, args, r, sim, f"{prec}/{sim}")
            else:
                e = compare_pools(kf, args, r, sim, prec, f"{prec}/{sim}")
            err = max(err, e)
            log(f"kernel parity {prec}/{sim}: r={r} ok max_abs_err={e:.3g}")
        # end to end, with the exact rescore at reduced precisions
        ev, ei = kf.knn_fused(v[0], nrm[0], ok[0], q, k=k, score_precision=prec,
                              impl="pallas")
        xv, xi = kf.knn_fused(v[0], nrm[0], ok[0], q, k=k, score_precision=prec,
                              impl="xla")
        if not torch.equal(ei, xi):
            raise AssertionError(f"knn_fused {prec}: ids differ from plain")
    # the shapes the main path gives the kernel: B = 1 over a [1, 2^18, d]
    # and a [4, 2^13, d] slab (fp32, l2, k = 10)
    for s, n_flat in ((1, 1 << 18), (4, 1 << 13)):
        data = clustered(rng, s * n_flat, DIM).reshape(s, n_flat, DIM)
        v = torch.from_numpy(data).to(dev)
        nrm = torch.from_numpy((data.astype(np.float64) ** 2).sum(2).astype(
            np.float32)).to(dev)
        ok = torch.from_numpy(rng.random((s, n_flat)) > 0.1).to(dev)
        q = torch.from_numpy(data[0, :1] + 0.01).to(dev)
        args, r = scan_inputs(kf, v, nrm, ok, q, 10, "fp32")
        err = max(err, compare_pools(kf, args, r, "l2_norm", "fp32",
                                     f"main-path shape S={s}"))
        log(f"kernel parity main-path shape S={s} n={n_flat}: ok")
    return err


LIST_COPIES = (2303, 2304)           # a duplicate across a range edge
LIST_RUN = tuple(range(5000, 5040))  # 40 equal vectors in one sub-block


def lists_case(dev, rng, s: int, n: int, d: int, integer: bool = True,
               grid=None):
    """Operands of K1's list scan and its wide tier: s shards of n docs of
    width d (sixteenths, or `grid`'s coarser ones where given, or
    clustered floats when not `integer`), 3% dead docs, LIST_COPIES and
    LIST_RUN planted in every shard and live (where n holds them); with
    four shards the last keeps 5 live docs, fewer than r. Returns (shard
    0's data, v, norms, valid)."""
    data = ((grid or sixteenths) if integer else clustered)(
        rng, s * n, d).reshape(s, n, d)
    valid = rng.random((s, n)) >= 0.03
    if n > LIST_RUN[-1]:
        data[:, list(LIST_COPIES)] = data[:, LIST_COPIES[:1]]
        data[:, list(LIST_RUN)] = data[:, LIST_RUN[:1]]
        valid[:, [*LIST_COPIES, *LIST_RUN]] = True
    if s == 4:
        valid[3] = False
        valid[3, rng.choice(n, 5, replace=False)] = True
    v = torch.from_numpy(data).to(dev)
    nrm = torch.from_numpy(np.concatenate([
        (data[i].astype(np.float64) ** 2).sum(1).astype(np.float32)[None]
        for i in range(s)])).to(dev)
    return data[0], v, nrm, torch.from_numpy(valid).to(dev)


def exact_scores(kf, v, nrm, q, qsq, sim: str, s: int, b: int,
                 docs: list) -> list:
    """The scores of `docs` of shard s for query b computed in f64: the dot
    in f64 (exact for f32 operands), the transform in f64 on the same
    norms and |q|^2 the kernel was given. A witness independent of both
    f32 summation orders."""
    idx = torch.tensor(docs, device=v.device)
    dots = v[s, idx].double() @ q[b].double()
    return kf._transform_scores(dots, qsq[b].double(), nrm[s, idx].double(),
                                sim).tolist()


def near_tie_swaps(kf, kv, ki, pv, pi, args, sim: str, what: str) -> list:
    """Float data: the slot scores must agree to rtol 1e-5 / atol 2e-3, and
    every slot where the kernel's id differs from plain_pool's must hold a
    live doc of the shard, once in its row, whose f64 score
    (exact_scores) lies within a relative 1e-5 of the f64 score of the doc
    plain put there: a near tie, which two f32 summation orders may rank
    either way. Returns one record per such slot: the kernel's and plain's
    doc, each with its f64 score."""
    v, nrm, ok, q, qsq, _scale = args
    fin = torch.isfinite(pv)
    if not torch.equal(fin, torch.isfinite(kv)) or not torch.allclose(
            kv[fin], pv[fin], rtol=1e-5, atol=2e-3):
        raise AssertionError(f"{what}: scores beyond rtol 1e-5 / atol 2e-3")
    swaps = []
    for s, b, j in (ki != pi).nonzero().tolist():
        row = ki[s, b].tolist()
        doc, other = row[j], int(pi[s, b, j])
        if not (0 <= doc < v.shape[1] and bool(ok[s, doc])) or \
                row.count(doc) != 1 or other < 0:
            raise AssertionError(f"{what}: slot {(s, b, j)} holds doc {doc} "
                                 f"(plain: {other}): not a live doc once")
        a, c = exact_scores(kf, v, nrm, q, qsq, sim, s, b, [doc, other])
        if abs(a - c) > 1e-5 * max(abs(a), abs(c)):
            raise AssertionError(
                f"{what}: slot {(s, b, j)} holds doc {doc}, plain {other} "
                f"(f64 scores {a!r} and {c!r}: not a near tie)")
        swaps.append({"slot": [s, b, j], "kernel": [doc, a],
                      "plain": [other, c]})
    return swaps


def kernel_order_scores(kf, v, nrm, ok, q, qsq, sim: str):
    """The [S, B, n] scores of f32 operands under the range scans' own
    arithmetic, on the card: every dot summed over d in ascending order in
    one f32 accumulator, each step a fused multiply-add (the product exact
    in f64, the sum rounded once to f64 and then to f32: a second rounding
    can differ from the fused one only when the f64 sum lands on an f32
    midpoint, about 2^-28 of the steps, and then by one ulp), then the
    plain version's transform, which rounds as the kernel does; -inf for a
    dead doc."""
    S, n, d = v.shape
    vt = v.transpose(1, 2).contiguous()           # [S, d, n]
    acc = torch.zeros((S, q.shape[0], n), dtype=torch.float32,
                      device=v.device)
    for j in range(d):
        acc = (acc.double() + q[None, :, j, None].double()
               * vt[:, None, j].double()).float()
    scores = kf._transform_scores(acc, qsq[None, :, None], nrm[:, None, :],
                                  sim)
    return torch.where(ok[:, None, :], scores, float("-inf"))


def order_top(kf, scores, r: int):
    """The top r of kernel_order_scores' scores under (score desc, doc id
    asc): (vals [S, B, r], ids [S, B, r] int32), (-inf, -1) past the live
    count."""
    vals, ids = kf.stable_topk(scores, r)
    return vals, torch.where(vals > float("-inf"), ids, -1).to(torch.int32)


def kernel_order_pool(kf, v, nrm, ok, q, qsq, r: int, sim: str):
    """The exact top-r pools of f32 operands under the list scan's own
    arithmetic (kernel_order_scores, order_top). Returns (vals [S, B, r],
    ids [S, B, r] int32), (-inf, -1) past the live count."""
    return order_top(kf, kernel_order_scores(kf, v, nrm, ok, q, qsq, sim), r)


def order_check(kf, kv, ki, args, r: int, sim: str, what: str,
                pv=None, pi=None) -> None:
    """Float data: the kernel's pools must equal kernel_order_pool's bit for
    bit, ids and values. Where a plain version's pools (pv, pi) are given,
    each slot whose id differs from them (a neighbour the other summation
    order ranks the other way) is logged with both docs' f64 scores."""
    v, nrm, ok, q, qsq, _scale = args
    rv, ri = kernel_order_pool(kf, v, nrm, ok, q, qsq, r, sim)
    if not (torch.equal(ki, ri) and torch.equal(kv, rv)):
        bad = (ki != ri).nonzero()[:5].tolist()
        raise AssertionError(f"{what}: differs from the kernel-order "
                             f"reference (ids differ at {bad})")
    if pi is None:
        return
    for s, b, j in (ki != pi).nonzero().tolist():
        doc, other = int(ki[s, b, j]), int(pi[s, b, j])
        a, c = exact_scores(kf, v, nrm, q, qsq, sim, s, b, [doc, other])
        log(f"{what}: plain_pool's order differs at {[s, b, j]}: kernel doc "
            f"{doc} (f64 {a!r}), plain doc {other} (f64 {c!r}), relative "
            f"gap {abs(a - c) / max(abs(a), abs(c)):.3g}")


def tile_check(kf, args, r: int, what: str) -> None:
    """The tile scan (kf._launch_tile), the yardstick timed beside the list
    scan and its wide tier, on the fp32 operands `args` of clustered
    floats: bit-equal to kernel_order_pool (order_check), since it too sums
    each dot in ascending order with one FFMA a product."""
    kv, ki = kf._launch_tile(*args, r=r, similarity="l2_norm",
                             score_precision="fp32")
    order_check(kf, kv, ki, args, r, "l2_norm", f"{what} (tile scan)")


def block_tile_check(kb, kf, v, nrm, ok, q, k: int, what: str) -> None:
    """K3's tile scan (kb._launch_block_tile on the padded batch), the
    yardstick timed beside K3's wide tier, on one shard of clustered f32
    floats: its rows for q bit-equal to kernel_order_pool."""
    tv, ti = kb._launch_block_tile(v, nrm, ok, kb._pad_queries(q, None), k=k,
                                   similarity="l2_norm")
    b = q.shape[0]
    order_check(kf, tv[None, :b], ti[None, :b],
                (v[None], nrm[None], ok[None], q, (q * q).sum(1),
                 torch.ones(1, device=v.device)), k, "l2_norm",
                f"{what} (K3 tile scan)")


def lists_check(kf, v, nrm, ok, q, r: int, sim: str, what: str,
                bits: bool, planted: bool = True) -> float:
    """One pool scan at fp32 against plain_pool: on sixteenths (`bits`) ids
    equal and values bit-equal, the planted copies (where `planted`) first
    in id order for l2 and cosine; on float data scores within rtol 1e-5 /
    atol 2e-3 and ids equal but at near ties (near_tie_swaps; the wide
    tier: equal to kernel_order_pool bit for bit, order_check, since at
    r >= 100 two summation orders swap neighbours further apart than
    near_tie_swaps' 1e-5). The design scan_tier names must have served it,
    one launch of K1: the list scan at r <= 32 (one list_launches), its
    wide tier at r <= 1024 (one wide_launches), else its large-r tier (one
    large_launches)."""
    qsq = (q * q).sum(dim=1)
    one = torch.ones(v.shape[0], device=v.device)
    tier = kf.scan_tier("fp32", r)
    counters = (kf.launches, kf.list_launches, kf.wide_launches,
                kf.large_launches)
    before = [c.count for c in counters]
    args = (v, nrm, ok, q, qsq, one)
    if bits:
        err = compare_pools(kf, args, r, sim, "fp32", what, bits=True)
    else:
        kv, ki = kf.pool_scan(*args, r=r, similarity=sim,
                              score_precision="fp32")
        pv, pi = kf.plain_pool(*args, r=r, similarity=sim,
                               score_precision="fp32")
        torch.cuda.synchronize()
        if tier == "wide":
            fin = torch.isfinite(pv)
            if not torch.equal(fin, torch.isfinite(kv)) or not torch.allclose(
                    kv[fin], pv[fin], rtol=1e-5, atol=2e-3):
                raise AssertionError(f"{what}: scores beyond rtol 1e-5 / "
                                     f"atol 2e-3")
            order_check(kf, kv, ki, args, r, sim, what, pv, pi)
        swaps = [] if tier == "wide" else near_tie_swaps(
            kf, kv, ki, pv, pi, args, sim, what)
        for sw in swaps:
            # which of the two the f64 scores put first (the id on a tie)
            first = max((sw["kernel"][1], -sw["kernel"][0]),
                        (sw["plain"][1], -sw["plain"][0]))
            log(f"{what}: near tie at {sw['slot']}: kernel doc "
                f"{sw['kernel'][0]} (f64 {sw['kernel'][1]!r}), plain doc "
                f"{sw['plain'][0]} (f64 {sw['plain'][1]!r}); f64 puts doc "
                f"{-first[1]} first")
        fin = torch.isfinite(pv)
        err = float((kv[fin] - pv[fin]).abs().max()) if bool(fin.any()) \
            else 0.0
    want = [1, int(tier == "lists"), int(tier == "wide"),
            int(tier == "large")]
    got = [c.count - b for c, b in zip(counters, before)]
    if got != want:
        raise AssertionError(f"{what}: (K1, list scan, wide tier, large-r "
                             f"tier) launched {got} times, want {want} "
                             f"({tier})")
    if bits and planted and sim != "dot_product" and r >= 2:
        kv, ki = kf.pool_scan(v, nrm, ok, q, qsq, one, r=r, similarity=sim,
                              score_precision="fp32")
        if ki[0, 0, :2].tolist() != list(LIST_COPIES):
            raise AssertionError(f"{what}: planted tie gave "
                                 f"{ki[0, 0, :2].tolist()}")
        run = min(r, len(LIST_RUN))
        if q.shape[0] > 1 and ki[0, 1, :run].tolist() != list(LIST_RUN[:run]):
            raise AssertionError(f"{what}: planted run gave "
                                 f"{ki[0, 1, :run].tolist()}")
    return err


def lists_kernel_phase(kf, dev, seed: int) -> float:
    """K1's list scan (fp32, r <= 32) against plain_pool on the card, its
    wide tier at r = 33 and its large-r tier at r = 1025 and 1400 beside
    it. Sixteenths (every dot exact in f32, so values
    and ids bit-equal, the planted ties in id order): one shard of
    n = 300,001 (a ragged tail; LIST_COPIES straddle a range edge at
    B <= 8) at B = 1, 5, 8, 9, 32, 33, 128 and 129 (query tiles 8, 32 and
    128, full and partial, and two 128-query tiles) x r = 1, 10 and 32 in
    l2, cosine and dot at r = 10, and r = 33; the large-r tier on another
    such shard at B = 1, 9 and 33 in l2 and cosine; four shards of 200,000 (the
    last with 5 live docs) at B = 1, 8 and 33 x r = 10 and 32; d = 30 and
    768 (the two-stage ring at r = 32) at B = 1, 9 and 129; operands 4
    bytes off a 16-byte boundary. Then clustered floats: scores within
    rtol 1e-5 / atol 2e-3 and ids equal but at near ties held to their f64
    scores (near_tie_swaps), at B = 1, 8, 32 and 128 in the three
    similarities, and over four shards. Each case checks which design
    launched (lists_check). Returns the max |dv|."""
    rng = np.random.default_rng(seed + 30)
    err = 0.0
    cases = (
        (1, 300_001, DIM, True, (1, 5, 8, 9, 32, 33, 128, 129),
         ((1, "l2_norm"), (10, "l2_norm"), (32, "l2_norm"), (10, "cosine"),
          (10, "dot_product"), (33, "l2_norm"))),
        (1, 300_001, DIM, True, (1, 9, 33),
         ((1025, "l2_norm"), (1400, "l2_norm"), (1025, "cosine"))),
        (4, 200_000, DIM, True, (1, 8, 33),
         ((10, "l2_norm"), (32, "l2_norm"), (10, "cosine"))),
        (1, 200_000, 30, True, (1, 9, 129),
         ((10, "l2_norm"), (32, "cosine"))),
        (1, 200_000, 768, True, (1, 9, 129),
         ((10, "l2_norm"), (32, "l2_norm"))),
        (1, 200_000, DIM, False, (1, 8, 32, 128),
         ((10, "l2_norm"), (10, "cosine"), (10, "dot_product"))),
        (4, 200_000, DIM, False, (1,), ((10, "l2_norm"), (32, "l2_norm"))),
    )
    for s, n, d, integer, bs, rs in cases:
        data, v, nrm, ok = lists_case(dev, rng, s, n, d, integer)
        for b in bs:
            queries = data[rng.choice(n, b, replace=False)].copy()
            queries[0] = data[LIST_COPIES[0]]
            if b > 1:
                queries[1] = data[LIST_RUN[0]]
            if not integer:
                queries = queries + 0.01 * rng.standard_normal(
                    queries.shape).astype(np.float32)
            q = torch.from_numpy(queries).to(dev)
            for r, sim in rs:
                err = max(err, lists_check(
                    kf, v, nrm, ok, q, r, sim,
                    f"K1 lists S={s} n={n} d={d} B={b} r={r} {sim} "
                    f"integer={integer}", integer))
        log(f"K1 list-scan parity S={s} n={n} d={d} integer={integer}: "
            f"{'bit-equal' if integer else 'ids equal'} at B = {bs}, "
            f"(r, sim) = {rs}")
        if s == 1 and d == DIM and integer and n == 300_001 and \
                rs[0][0] <= kf.LIST_MAX_R:
            for sim in ("l2_norm", "cosine"):
                q = torch.from_numpy(data[[LIST_COPIES[0], LIST_RUN[0], 7, 9,
                                           11]].copy()).to(dev)
                err = max(err, lists_check(
                    kf, unaligned(v), nrm, ok, unaligned(q), 10, sim,
                    f"K1 lists unaligned {sim}", True))
            log("K1 list-scan parity, operands off a 16-byte boundary: "
                "bit-equal")
        del v
        torch.cuda.empty_cache()
    return err


def block_wide_check(kb, v, nrm, ok, q, k: int, sim: str, what: str) -> float:
    """K3's entry point (knn_topk_auto) on one shard of sixteenths against
    plain_block_topk: ids equal and values bit-equal, served by the wide
    tier (one block_wide_launches)."""
    before = kb.block_wide_launches.count
    gv, gi = kb.knn_topk_auto(v, nrm, ok, q, k=k, similarity=sim)
    pv, pi = kb.plain_block_topk(v, nrm, ok, q, k=k, similarity=sim)
    torch.cuda.synchronize()
    if not (torch.equal(gi, pi) and torch.equal(gv, pv)):
        bad = (gi != pi).nonzero()[:5].tolist()
        raise AssertionError(f"{what}: K3 differs from plain_block_topk "
                             f"(ids differ at {bad})")
    if kb.block_wide_launches.count - before != 1:
        raise AssertionError(f"{what}: K3's wide tier launched "
                             f"{kb.block_wide_launches.count - before} times")
    fin = torch.isfinite(pv)
    return float((gv[fin] - pv[fin]).abs().max()) if bool(fin.any()) else 0.0


# r and similarity of the wide tier's parity cases
WIDE_RS = (33, 64, 100, 128, 256, 1024)
# the wide merge's stage-2 candidates in shared memory (kMergeStage in
# csrc/knn_wide.cuh): past them it reads every slot from device memory
WIDE_MERGE_STAGE = 16384


def wide_merge_candidates(scores, r: int, chunk: int, n_split: int) -> int:
    """The wide merge's stage-2 candidate count for one (shard, query) of
    f32 scores [n] (-inf for dead docs), as knn_wide_merge_kernel counts
    them: each range's pool (its r best under (score desc, doc id asc)),
    t0 the r-th best of the pools' first merge_prefix slots (every live one
    when they are no more than r), and the slots of all pools at or above
    t0."""
    n = scores.shape[0]
    order = torch.sort(-scores, stable=True).indices   # score desc, id asc
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=scores.device)
    live = scores > float("-inf")
    pre = min(r, 4 * -(-r // n_split))                 # merge_prefix
    pools = []
    for p in range(n_split):
        lo, hi = p * chunk, min(n, (p + 1) * chunk)
        pools.append(torch.sort(rank[lo:hi][live[lo:hi]]).values[:r])
    first = torch.cat([pool[:pre] for pool in pools])
    t0 = torch.sort(first).values[r - 1] if first.numel() > r else n
    return sum(int((pool <= t0).sum()) for pool in pools)


def merge_fallback_check(kf, kb, dev, rng, k1: bool, k3: bool) -> float:
    """The wide merge's fallback, which reads every slot from device memory
    where the ranges' prefixes hold more than WIDE_MERGE_STAGE candidates:
    one shard of 300,000 sixteenths whose docs in 24 whole ranges (from the
    third on) lie within 1/16 a coordinate of the query, so each of those
    ranges' pools is r = 1024 near docs above the merge's first bound; B = 1
    (the stacked step's), l2 and cosine. wide_merge_candidates must count
    more candidates than the merge stages (so the fallback ran), and K1 and
    K3 must equal plain_pool and plain_block_topk bit for bit. Returns the
    max |dv|."""
    n, r, near = 300_000, 1024, 24
    chunk, n_split = kf.list_geometry(1, n, 1, kf.sm_count(dev))
    data = sixteenths(rng, n, DIM)
    q0 = data[7].copy()
    lo, hi = 2 * chunk, min(n, (2 + near) * chunk)
    data[lo:hi] = q0 + rng.integers(-1, 2, (hi - lo, DIM)).astype(
        np.float32) / 16
    v = torch.from_numpy(data)[None].to(dev)
    nrm = (v.double() ** 2).sum(2).float()
    ok = torch.ones((1, n), dtype=torch.bool, device=dev)
    q = torch.from_numpy(q0[None]).to(dev)
    qsq = (q * q).sum(1)
    err = 0.0
    for sim in ("l2_norm", "cosine"):
        scores = kf._transform_scores(v[0] @ q[0], qsq[0], nrm[0], sim)
        m = wide_merge_candidates(scores, r, chunk, n_split)
        stage = min(n_split * r, WIDE_MERGE_STAGE)
        if m <= stage:
            raise AssertionError(f"wide merge fallback {sim}: {m} candidates "
                                 f"fit the merge's {stage}")
        what = f"wide merge fallback {sim} ({m} candidates, {n_split} ranges)"
        if k1:
            err = max(err, lists_check(kf, v, nrm, ok, q, r, sim, f"K1 {what}",
                                       True, planted=False))
        if k3:
            err = max(err, block_wide_check(kb, v[0], nrm[0], ok[0], q, r,
                                            sim, f"K3 {what}"))
        log(f"{what}: past the {stage} the merge stages, so read from device "
            f"memory; bit-equal")
    del v
    torch.cuda.empty_cache()
    return err


def wide_kernel_phase(kf, kb, dev, seed: int, k1: bool, k3: bool) -> float:
    """K1's wide tier (fp32, 32 < r <= 1024) against plain_pool and K3's
    against plain_block_topk on the card (lists_check, block_wide_check).
    Sixteenths (every dot exact in f32, so values and ids bit-equal, the
    planted ties in id order: LIST_COPIES across a range edge at B <= 8,
    LIST_RUN's 40 equal vectors within one sub-block): one shard of
    n = 300,001 (a ragged tail) at B = 1, 5, 8, 9, 32, 33 and 129 (one,
    two, five and seventeen 8-query tiles, full and partial) x r = 33, 64,
    100, 128, 256 and 1024 in l2, and r = 100 in cosine and dot, K3 beside
    K1; operands 4 bytes off a 16-byte boundary; four shards of 200,000
    (the last with 5 live docs, fewer than r) at B = 1, 8 and 33; d = 30
    and 768 (the two-stage rings) at B = 1, 9 and 129; n = 90 (fewer docs
    than r, in one range shorter than a sub-block) and n = 1,000 (eight
    ranges of 128 docs, each shorter than r); the merge's fallback from
    device memory (merge_fallback_check). Then clustered floats: K1
    bit-equal to kernel_order_pool, a brute force summed in the kernel's
    order (order_check; each slot where plain_pool's cuBLAS order ranks two
    neighbours the other way is logged with both docs' f64 scores), at
    B = 1, 8, 32 and 129 and over four shards. Returns the max |dv|."""
    rng = np.random.default_rng(seed + 31)
    err = 0.0
    all_b = (1, 5, 8, 9, 32, 33, 129)
    cases = (
        (1, 300_001, DIM, True, all_b,
         tuple((r, "l2_norm") for r in WIDE_RS)
         + ((100, "cosine"), (100, "dot_product"))),
        (4, 200_000, DIM, True, (1, 8, 33),
         ((64, "l2_norm"), (256, "l2_norm"), (1024, "l2_norm"),
          (100, "cosine"))),
        (1, 200_000, 30, True, (1, 9, 129),
         ((100, "l2_norm"), (1024, "cosine"))),
        (1, 200_000, 768, True, (1, 9, 129),
         ((100, "l2_norm"), (1024, "l2_norm"))),
        (1, 90, DIM, True, (1, 9), ((33, "l2_norm"), (100, "cosine"))),
        (1, 1_000, DIM, True, (1, 9), ((256, "l2_norm"), (1024, "l2_norm"))),
        (1, 200_000, DIM, False, (1, 8, 32, 129),
         ((100, "l2_norm"), (100, "cosine"), (100, "dot_product"),
          (1024, "l2_norm"))),
        (4, 200_000, DIM, False, (1,), ((128, "l2_norm"),)),
    )
    for s, n, d, integer, bs, rs in cases:
        data, v, nrm, ok = lists_case(dev, rng, s, n, d, integer)
        planted = n > LIST_RUN[-1]
        for b in bs:
            queries = data[rng.choice(n, b, replace=b > n)].copy()
            if planted:
                queries[0] = data[LIST_COPIES[0]]
                if b > 1:
                    queries[1] = data[LIST_RUN[0]]
            if not integer:
                queries = queries + 0.01 * rng.standard_normal(
                    queries.shape).astype(np.float32)
            q = torch.from_numpy(queries).to(dev)
            for r, sim in rs:
                what = (f"wide S={s} n={n} d={d} B={b} r={r} {sim} "
                        f"integer={integer}")
                if k1:
                    err = max(err, lists_check(kf, v, nrm, ok, q, r, sim,
                                               f"K1 {what}", integer,
                                               planted))
                if k3 and s == 1 and integer:
                    err = max(err, block_wide_check(kb, v[0], nrm[0], ok[0],
                                                    q, r, sim, f"K3 {what}"))
        log(f"wide-tier parity S={s} n={n} d={d} integer={integer}: "
            f"{'bit-equal' if integer else 'ids equal'} at B = {bs}, "
            f"(r, sim) = {rs}" + (" (K1 and K3)" if s == 1 and integer
                                  else " (K1)"))
        if s == 1 and d == DIM and integer and n == 300_001:
            q = torch.from_numpy(data[[LIST_COPIES[0], LIST_RUN[0], 7, 9,
                                       11]].copy()).to(dev)
            for r, sim in ((100, "l2_norm"), (1024, "cosine")):
                what = f"wide unaligned r={r} {sim}"
                if k1:
                    err = max(err, lists_check(kf, unaligned(v), nrm, ok,
                                               unaligned(q), r, sim,
                                               f"K1 {what}", True))
                if k3:
                    err = max(err, block_wide_check(
                        kb, unaligned(v[0]), nrm[0], ok[0], unaligned(q), r,
                        sim, f"K3 {what}"))
            log("wide-tier parity, operands off a 16-byte boundary: "
                "bit-equal")
        del v
        torch.cuda.empty_cache()
    return max(err, merge_fallback_check(kf, kb, dev, rng, k1, k3))


# the wide tier's tensor-core scan (K1 at bf16 and int8): the pool widths
# of its parity cases, its precisions and the profiler's kernel names
MMA_RS = (32, 40, 100, 400, 512, 1024)
REDUCED = ("bf16", "int8")
MMA_KERNELS = ("knn_wide_mma_scan_kernel", "knn_wide_merge_kernel")
F32_UNIT = 2.0 ** -24


def mma_sixteenths(rng, n: int, d: int) -> np.ndarray:
    """sixteenths() on a range narrow enough for the tensor cores' f32
    accumulation of bf16 products to be exact in any order and alignment:
    coordinates k/16 with |k| <= kmax = min(63, floor(sqrt(2^18 / d))) (45
    at d = 128, 18 at 768), each exact in bf16. Every product is then a
    multiple of 2^-8 and every partial sum of a dot at most
    d kmax^2 2^-8 <= 2^10 in magnitude: at most 2^18 units of that grain,
    inside the 2^20 the check allows itself and far inside the 2^24 of an
    f32 significand, so no alignment or rounding drops a bit and the sums
    equal cuBLAS's (plain_pool's) bit for bit."""
    kmax = min(63, math.isqrt((1 << 18) // d))
    x = np.round(clustered(rng, n, d) * 4.0) / 16.0
    return np.clip(x, -kmax / 16, kmax / 16).astype(np.float32)


def reduced_args(kf, v, nrm, ok, q, prec: str) -> tuple:
    """The pool scan's operands at `prec` as knn_fused_stacked preps them."""
    v_x, q_x, scale = kf._prep_operands(v, q, prec)
    return (v_x.contiguous(), nrm, ok, q_x.contiguous(), (q * q).sum(1),
            scale)


def f32_score_bounds(kf, rows, qd, qq, nn, sim: str):
    """(lo, hi) in f64 around the f32 score of each of `rows` ([m, d] f64)
    against query qd ([d] f64) with the f32 |q|^2 qq and norms nn: each dot
    moved by the error bound of one f32 summation of its d exact products
    (gamma_d * sum |q_i v_i|), then the transform's own f32 roundings
    (l2: qq - 2 dot + nn to 2u of qq + 2|dot| + nn, then 1 + d_sq and the
    division, u each; cosine: the norms, their product and the division to
    4u relative, then 1 + c to u; dot: 2u relative), u = 2^-24. l2, cosine
    and dot are increasing in the dot."""
    d = rows.shape[1]
    u = F32_UNIT
    gamma = d * u / (1 - d * u)
    dots = rows @ qd
    slack = gamma * (rows.abs() @ qd.abs())
    lo_dot, hi_dot = dots - slack, dots + slack
    if sim == "l2_norm":
        mag = qq + 2.0 * dots.abs() + nn + 2.0 * slack
        t_lo = torch.clamp(qq - 2.0 * hi_dot + nn - 2 * u * mag, min=0.0)
        t_hi = torch.clamp(qq - 2.0 * lo_dot + nn + 2 * u * mag, min=0.0)
        return (1.0 / (1.0 + t_hi)) * (1 - 3 * u), \
            (1.0 / (1.0 + t_lo)) * (1 + 3 * u)
    if sim == "cosine":
        den = torch.sqrt(torch.clamp(qq, min=1e-24)) * torch.sqrt(
            torch.clamp(nn, min=1e-24))
        c_lo, c_hi = lo_dot / den, hi_dot / den
        c_lo, c_hi = c_lo - 4 * u * c_lo.abs(), c_hi + 4 * u * c_hi.abs()
        return (1.0 + c_lo) / 2.0 - u, (1.0 + c_hi) / 2.0 + u
    lo = kf._transform_scores(lo_dot, qq, nn, sim)
    hi = kf._transform_scores(hi_dot, qq, nn, sim)
    return lo - 2 * u * lo.abs(), hi + 2 * u * hi.abs()


def f32_bound_check(kf, kv, ki, args, sim: str, what: str) -> float:
    """Every finite slot of a pool (vals kv, ids ki over the prepped args)
    holds a score within f32_score_bounds of its doc's exact f64 score.
    Returns the largest |score - f64 score| met."""
    v_x, nrm, _ok, q_x, qsq, _scale = args
    worst = 0.0
    for s in range(kv.shape[0]):
        for b in range(kv.shape[1]):
            fin = torch.isfinite(kv[s, b])
            docs = ki[s, b][fin].long()
            rows, qd = v_x[s, docs].double(), q_x[b].double()
            qq, nn = qsq[b].double(), nrm[s, docs].double()
            lo, hi = f32_score_bounds(kf, rows, qd, qq, nn, sim)
            got = kv[s, b][fin].double()
            out = (got < lo) | (got > hi)
            if bool(out.any()):
                j = int(out.nonzero()[0])
                raise AssertionError(
                    f"{what}: row {(s, b)} doc {int(docs[j])} score "
                    f"{float(got[j])!r} outside its f32 bound "
                    f"[{float(lo[j])!r}, {float(hi[j])!r}]")
            exact = kf._transform_scores(rows @ qd, qq, nn, sim)
            if docs.numel():
                worst = max(worst, float((got - exact).abs().max()))
    return worst


def summation_ties(kf, kv, ki, pv, pi, args, sim: str, what: str,
                   bound: bool = False) -> list:
    """bf16 pools on float data, where the tensor cores and cuBLAS sum each
    dot's d exact products in f32 in two orders: scores within rtol 1e-5 /
    atol 2e-3 slot for slot (with `bound`, where a dot's f32 ulp makes
    that tolerance too narrow, as at d = 768 with |q|^2 near 13,000: each
    pool's every score within f32_score_bounds of its doc's exact score
    instead), and every slot where the kernel's id differs
    from plain_pool's must hold a live doc of the shard, once in its row,
    that the two orders may rank either way against plain's doc: each
    doc's f64 score (the dot in f64, exact, through the plain transform on
    the kernel's norms) moved by up to the error bound of one f32
    summation, gamma_d * sum |q_i v_i| with gamma_d = d u / (1 - d u),
    u = 2^-24, on its dot, gives an interval, and the two docs' intervals
    overlap. Returns one record a slot: both docs, their f64 scores and
    the relative gap."""
    v_x, nrm, ok, q_x, qsq, _scale = args
    fin = torch.isfinite(pv)
    if not torch.equal(fin, torch.isfinite(kv)):
        raise AssertionError(f"{what}: finite slots differ")
    if bound:
        for pool_v, pool_i, name in ((kv, ki, "kernel"), (pv, pi, "plain")):
            f32_bound_check(kf, pool_v, pool_i, args, sim, f"{what} {name}")
    elif not torch.allclose(kv[fin], pv[fin], rtol=1e-5, atol=2e-3):
        raise AssertionError(f"{what}: scores beyond rtol 1e-5 / atol 2e-3")
    d = v_x.shape[2]
    gamma = d * F32_UNIT / (1 - d * F32_UNIT)
    ties = []
    for s, b, j in (ki != pi).nonzero().tolist():
        row = ki[s, b].tolist()
        doc, other = row[j], int(pi[s, b, j])
        if not (0 <= doc < v_x.shape[1] and bool(ok[s, doc])) or \
                row.count(doc) != 1 or other < 0:
            raise AssertionError(f"{what}: slot {(s, b, j)} holds doc {doc} "
                                 f"(plain: {other}): not a live doc once")
        idx = torch.tensor([doc, other], device=v_x.device)
        rows, qd = v_x[s, idx].double(), q_x[b].double()
        dots = rows @ qd
        slack = gamma * (rows.abs() @ qd.abs())
        qq, nn = qsq[b].double(), nrm[s, idx].double()
        lo = kf._transform_scores(dots - slack, qq, nn, sim).tolist()
        hi = kf._transform_scores(dots + slack, qq, nn, sim).tolist()
        a, c = kf._transform_scores(dots, qq, nn, sim).tolist()
        if lo[0] > hi[1] or lo[1] > hi[0]:
            raise AssertionError(
                f"{what}: slot {(s, b, j)} holds doc {doc}, plain {other} "
                f"(f64 scores {a!r} and {c!r}, further apart than f32 "
                f"summation moves them)")
        ties.append({"slot": [s, b, j], "kernel": [doc, a],
                     "plain": [other, c],
                     "gap": abs(a - c) / max(abs(a), abs(c))})
    return ties


def bf16_float_check(kf, args, r: int, sim: str, what: str,
                     bound: bool = False) -> float:
    """K1 at bf16 on float data against plain_pool: summation_ties (with
    `bound`: every score within its f32 error bound), each tie logged.
    Returns the max |dv| over the finite slots."""
    kv, ki = kf.pool_scan(*args, r=r, similarity=sim, score_precision="bf16")
    pv, pi = kf.plain_pool(*args, r=r, similarity=sim,
                           score_precision="bf16")
    torch.cuda.synchronize()
    for tie in summation_ties(kf, kv, ki, pv, pi, args, sim, what, bound):
        log(f"{what}: summation tie at {tie['slot']}: kernel doc "
            f"{tie['kernel'][0]} (f64 {tie['kernel'][1]!r}), plain doc "
            f"{tie['plain'][0]} (f64 {tie['plain'][1]!r}), relative gap "
            f"{tie['gap']:.3g}")
    fin = torch.isfinite(pv)
    return float((kv[fin] - pv[fin]).abs().max()) if bool(fin.any()) else 0.0


def mma_check(kf, args, r: int, sim: str, prec: str, what: str,
              integer: bool, planted: bool) -> float:
    """One K1 pool scan at bf16 or int8 (args: the prepped operands) against
    plain_pool, served by the tensor-core tier alone (one launch of K1, on
    mma_launches): int8 pools bit-equal on any data, bf16 pools bit-equal
    on mma_sixteenths (`integer`) and on floats equal but at summation
    ties (bf16_float_check); where `planted`, LIST_COPIES first in id
    order for query 0 and LIST_RUN for query 1 (l2 and cosine). Returns the
    max |dv|."""
    counters = (kf.launches, kf.list_launches, kf.wide_launches,
                kf.mma_launches)
    before = [c.count for c in counters]
    if prec == "bf16" and not integer:
        err = bf16_float_check(kf, args, r, sim, what)
    else:
        err = compare_pools(kf, args, r, sim, prec, what, bits=True)
    got = [c.count - b for c, b in zip(counters, before)]
    if got != [1, 0, 0, 1]:
        raise AssertionError(f"{what}: (K1, list scan, wide tier, tensor-core "
                             f"tier) launched {got} times, want [1, 0, 0, 1]")
    if planted and sim != "dot_product":
        _kv, ki = kf.pool_scan(*args, r=r, similarity=sim,
                               score_precision=prec)
        if ki[0, 0, :2].tolist() != list(LIST_COPIES):
            raise AssertionError(f"{what}: planted tie gave "
                                 f"{ki[0, 0, :2].tolist()}")
        run = min(r, len(LIST_RUN))
        if args[3].shape[0] > 1 and \
                ki[0, 1, :run].tolist() != list(LIST_RUN[:run]):
            raise AssertionError(f"{what}: planted run gave "
                                 f"{ki[0, 1, :run].tolist()}")
    return err


def mma_kernel_phase(kf, dev, seed: int) -> float:
    """K1's tensor-core tier (bf16 and int8, r <= 1024) against plain_pool
    on the card (mma_check), at both precisions. mma_sixteenths, on which
    bf16's f32 accumulation is exact in any order (values and ids
    bit-equal, the planted ties in id order: LIST_COPIES across a range
    edge at B <= 8, LIST_RUN's 40 equal vectors within one sub-block): one
    shard of n = 300,001 (a ragged tail) at B = 1, 5, 8, 9, 32, 33 and 129
    x r = 32, 40, 100, 400, 512 and 1024 in l2, r = 40 in cosine and 400 in
    dot; operands 4 bytes off a 16-byte boundary (copied by the wrapper);
    four shards of 200,000 (the last with 5 live docs, fewer than r) at
    B = 1, 8 and 33; d = 30 (bf16 rows padded to 32 elements, int8 to 32),
    100 (104 and 112) and 768 at B = 1, 9 and 129; n = 90 (fewer docs than
    r, one range shorter than a sub-block) and n = 1,000 (ranges of 128
    docs, each shorter than r). Then clustered floats at B = 1, 8, 32 and
    129 and over four shards: int8 still bit-equal, bf16 ids equal but at
    summation ties, each logged with both docs' f64 scores. Returns the
    max |dv|."""
    rng = np.random.default_rng(seed + 32)
    err = 0.0
    all_b = (1, 5, 8, 9, 32, 33, 129)
    cases = (
        (1, 300_001, DIM, True, all_b,
         tuple((r, "l2_norm") for r in MMA_RS)
         + ((40, "cosine"), (400, "dot_product"))),
        (4, 200_000, DIM, True, (1, 8, 33),
         ((40, "l2_norm"), (400, "l2_norm"), (1024, "cosine"))),
        (1, 200_000, 30, True, (1, 9, 129),
         ((40, "l2_norm"), (1024, "cosine"))),
        (1, 200_000, 100, True, (1, 9, 129),
         ((400, "l2_norm"), (32, "dot_product"))),
        (1, 200_000, 768, True, (1, 9, 129),
         ((40, "l2_norm"), (1024, "l2_norm"))),
        (1, 90, DIM, True, (1, 9), ((32, "l2_norm"), (100, "cosine"))),
        (1, 1_000, DIM, True, (1, 9), ((400, "l2_norm"), (1024, "l2_norm"))),
        (1, 200_000, DIM, False, (1, 8, 32, 129),
         ((40, "l2_norm"), (400, "l2_norm"), (400, "cosine"),
          (512, "dot_product"))),
        (4, 200_000, DIM, False, (1,), ((400, "l2_norm"),)),
    )
    for s, n, d, integer, bs, rs in cases:
        data, v, nrm, ok = lists_case(dev, rng, s, n, d, integer,
                                      grid=mma_sixteenths)
        planted = integer and n > LIST_RUN[-1]
        for b in bs:
            queries = data[rng.choice(n, b, replace=b > n)].copy()
            if n > LIST_RUN[-1]:
                queries[0] = data[LIST_COPIES[0]]
                if b > 1:
                    queries[1] = data[LIST_RUN[0]]
            if not integer:
                queries = queries + 0.01 * rng.standard_normal(
                    queries.shape).astype(np.float32)
            q = torch.from_numpy(queries).to(dev)
            for prec in REDUCED:
                args = reduced_args(kf, v, nrm, ok, q, prec)
                for r, sim in rs:
                    err = max(err, mma_check(
                        kf, args, r, sim, prec,
                        f"K1 mma {prec} S={s} n={n} d={d} B={b} r={r} {sim} "
                        f"integer={integer}", integer, planted))
        log(f"tensor-core tier parity S={s} n={n} d={d} integer={integer}: "
            f"{'bit-equal' if integer else 'int8 bit-equal, bf16 ids equal'}"
            f" at B = {bs}, (r, sim) = {rs}, bf16 and int8")
        if s == 1 and d == DIM and integer and n == 300_001:
            q = torch.from_numpy(data[[LIST_COPIES[0], LIST_RUN[0], 7, 9,
                                       11]].copy()).to(dev)
            for prec in REDUCED:
                v_x, nrm_, ok_, q_x, qsq, scale = reduced_args(
                    kf, v, nrm, ok, q, prec)
                args = (unaligned(v_x), nrm_, ok_, unaligned(q_x), qsq,
                        scale)
                for r, sim in ((40, "l2_norm"), (400, "cosine")):
                    err = max(err, mma_check(
                        kf, args, r, sim, prec,
                        f"K1 mma {prec} unaligned r={r} {sim}", True, True))
            log("tensor-core tier parity, operands off a 16-byte boundary: "
                "bit-equal")
        del v
        torch.cuda.empty_cache()
    return err


# the profiler's kernel names of K1's and K3's list scan
LIST_KERNELS = ("knn_pool_scan_kernel", "knn_pool_merge_kernel")


def pool_bound(s: int, n: int, d: int, b: int, r: int,
               prec: str = "fp32") -> dict:
    """The least time of one pool scan: the slab (4, 2 or 1 bytes an
    element at fp32, bf16, int8), norms and valid flags read once, the
    queries and |q|^2, the [S, B, r] pools written, over 3.35 TB/s; against
    2*B*S*n*d operations over the card's peak for the operands' type (67
    TFLOP/s fp32, 989 bf16, 1,979 int8)."""
    width = {"fp32": 4, "bf16": 2, "int8": 1}[prec]
    nbytes = s * n * (d * width + 4 + 1) + b * (d * width + 4) + s * b * r * 8
    flops = 2 * b * s * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[prec] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def time_pool(kf, args, r: int, q, v, nrm, k: int, label: str,
              plain: bool = True) -> dict:
    """One K1 shape: the list scan's CUDA-event ms and device ms of its two
    kernels by name, the tile scan's beside it in the same window, the
    plain version's and the library yardstick's (torch.topk over the
    l2-transformed q @ v.T, per shard), with the memory clock read before
    and after."""
    clock0 = mem_clock()

    def lists():
        return kf.pool_scan(*args, r=r, similarity="l2_norm",
                            score_precision="fp32")

    def tile():
        return kf._launch_tile(*args, r=r, similarity="l2_norm",
                               score_precision="fp32")

    qsq = args[4]

    def library():
        d_sq = torch.clamp(qsq[None, :, None] - 2.0 * torch.einsum(
            "bd,snd->sbn", q, v) + nrm[:, None, :], min=0.0)
        return torch.topk(1.0 / (1.0 + d_sq), k)

    # 100 calls: at the serving shapes the host, not the card, sets the
    # pace, and its noise needs the longer average
    ms = time_ms(lists, 100)
    tile_ms = time_ms(tile, 100)
    ms_again = time_ms(lists, 100)
    plain_ms = time_ms(lambda: kf.plain_pool(
        *args, r=r, similarity="l2_norm", score_precision="fp32"), 5) \
        if plain else None
    library_ms = time_ms(library, 10)
    prof = device_profile(lists, 5)
    tile_prof = device_profile(tile, 5)
    out = {"ms": ms, "ms_again": ms_again, "tile_ms": tile_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "device_ms": prof and prof["device_ms"],
           "scan_device_ms": kernel_ms(prof, LIST_KERNELS[0]),
           "merge_device_ms": kernel_ms(prof, LIST_KERNELS[1]),
           "tile_device_ms": tile_prof and tile_prof["device_ms"],
           "mem_clock": [clock0, mem_clock()]}
    log(f"K1 {label}: list scan {ms:.4f} / {ms_again:.4f} ms (device "
        f"{out['device_ms']}: scan {out['scan_device_ms']}, merge "
        f"{out['merge_device_ms']}), tile scan {tile_ms:.4f} ms (device "
        f"{out['tile_device_ms']}), plain {plain_ms}, library "
        f"{library_ms:.4f} ms; memory clock {out['mem_clock']}")
    return out


def timing_phase(kf, dev, seed: int) -> dict:
    """K1 (fp32, l2, k = 10: the list scan) at the SIFT-1M shape (1,000,000
    clustered 128-d docs) at B = 1, 32 and 128, then at the serving shapes:
    one shard of 200,000 docs at B = 1 and 8, four of 5,000 at B = 1; each
    checked against plain_pool first, and the tile scan timed beside it
    against kernel_order_pool (tile_check), then timed (time_pool) beside
    its bound (pool_bound)."""
    rng = np.random.default_rng(seed + 1)
    k = 10
    out = {}
    shapes = ((1, 1_000_000, (1, 32, 128)), (1, 200_000, (1, 8)),
              (4, 5_000, (1,)))
    for s, n, bs in shapes:
        v = torch.from_numpy(clustered(rng, s * n, DIM).reshape(s, n, DIM)) \
            .to(dev)
        nrm = (v.double() ** 2).sum(2).float()
        ok = torch.ones((s, n), dtype=torch.bool, device=dev)
        for b in bs:
            q = v[0, torch.from_numpy(rng.choice(n, b, replace=False))
                  .to(dev)] + 0.01
            args, r = scan_inputs(kf, v, nrm, ok, q, k, "fp32")
            label = f"S={s} n={n} B={b}"
            compare_pools(kf, args, r, "l2_norm", "fp32", label)
            tile_check(kf, args, r, label)
            t = time_pool(kf, args, r, q, v, nrm, k, label,
                          plain=n * s * b <= 128_000_000)
            t.update(pool_bound(s, n, DIM, b, r))
            log(f"K1 {label}: bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']})")
            out[b if n == 1_000_000 else label] = t
        del v
        torch.cuda.empty_cache()
    return out


# the profiler's kernel names of the tile scan (K1 at bf16 and int8 past
# r = 1024; the yardstick beside the other designs) and of the wide tier
TILE_KERNELS = ("knn_scan_kernel", "knn_merge_kernel")
WIDE_KERNELS = ("knn_wide_scan_kernel", "knn_wide_merge_kernel")
# the shapes that ran the tile scan before the wide tier: K1 at fp32 with
# r = 64, 100, 128; K3 at k = 64-1024; K1 at bf16 and int8 with k = 10 and
# 100 (pools of R = 40 and 400)
WIDE_K1 = ((64, 100, 128), (1, 8, 32, 128))
WIDE_K3 = ((64, 128, 256, 1024), (1, 32))
WIDE_REDUCED = (("bf16", "int8"), (10, 100), (1, 8, 32))


def check_scan(kf, args, r: int, prec: str, what: str) -> None:
    """A pool scan and the tile scan beside it against their references on
    clustered floats before they are timed: at int8 both bit-equal to
    plain_pool; at bf16 both ids equal to plain_pool but at summation ties
    (summation_ties, each logged); at fp32 both bit-equal to
    kernel_order_pool (order_check, tile_check)."""
    if prec == "fp32":
        kv, ki = kf.pool_scan(*args, r=r, similarity="l2_norm",
                              score_precision=prec)
        order_check(kf, kv, ki, args, r, "l2_norm", what)
        tile_check(kf, args, r, what)
        return
    pv, pi = kf.plain_pool(*args, r=r, similarity="l2_norm",
                           score_precision=prec)
    for design, scan in (("", kf.pool_scan),
                         (" (tile scan)", kf._launch_tile)):
        kv, ki = scan(*args, r=r, similarity="l2_norm", score_precision=prec)
        torch.cuda.synchronize()
        if prec == "int8":
            if not (torch.equal(ki, pi) and torch.equal(kv, pv)):
                raise AssertionError(f"{what}{design}: not bit-equal to "
                                     f"plain_pool")
            continue
        for tie in summation_ties(kf, kv, ki, pv, pi, args, "l2_norm",
                                  what + design):
            log(f"{what}{design}: summation tie {tie}")


def time_design(label: str, design, tile, plain, library, bound: dict,
                iters: int = 20, names=WIDE_KERNELS) -> dict:
    """One shape of the wide tier's record: CUDA-event ms of the design the
    wrapper picks (twice, the tile scan's between when it is not the same
    design), the plain version's and the library call's; device ms of each
    design by kernel name (the design's `names`, scan and merge, and
    TILE_KERNELS); the memory clock before and after."""
    clock0 = mem_clock()
    ms = time_ms(design, iters)
    tile_ms = time_ms(tile, iters) if tile is not None else None
    ms_again = time_ms(design, iters)
    plain_ms = time_ms(plain, 3)
    library_ms = time_ms(library, 10)
    prof = device_profile(design, 5)
    tile_prof = device_profile(tile, 5) if tile is not None else prof
    out = {"ms": ms, "ms_again": ms_again, "tile_ms": tile_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "device_ms": prof and prof["device_ms"],
           "scan_device_ms": kernel_ms(prof, names[0]),
           "merge_device_ms": kernel_ms(prof, names[1]),
           "tile_device_ms": tile_prof and tile_prof["device_ms"],
           "tile_scan_device_ms": kernel_ms(tile_prof, TILE_KERNELS[0]),
           "tile_merge_device_ms": kernel_ms(tile_prof, TILE_KERNELS[1]),
           "mem_clock": [clock0, mem_clock()], **bound}
    log(f"wide record {label}: {json.dumps(out)}")
    return out


def wide_timing_phase(kf, kb, dev, seed: int, k1: bool, k3: bool) -> dict:
    """The tile scan's former shapes at the SIFT-1M shape (1,000,000
    clustered 128-d docs, l2): K1 (pool_scan) at fp32 with r = 64, 100 and
    128 at B = 1, 8, 32 and 128 (the wide tier), and at bf16 and int8 with
    k = 10 and 100 at B = 1, 8 and 32 (the tensor-core tier, pools of
    R = 40 and 400); K3 (knn_topk_auto) at k = 64, 128, 256 and 1024 at
    B = 1 and 32. Each, and the tile scan beside it (`_launch_tile`,
    `_launch_block_tile`), is checked first (check_scan, block_tile_check),
    then timed by time_design beside the tile scan on the same call. The
    library call is torch.topk at the pool's width over the l2-transformed
    q @ v.T (bf16: of bf16 operands; int8: the f32 product of the int8
    values, exact at d = 128, scaled)."""
    rng = np.random.default_rng(seed + 3)
    n = SIFT_DOCS
    v = torch.from_numpy(clustered(rng, n, DIM))[None].to(dev)
    nrm = (v.double() ** 2).sum(2).float()
    ok = torch.ones((1, n), dtype=torch.bool, device=dev)
    q_all = v[0, torch.from_numpy(rng.choice(n, 128, replace=False))
              .to(dev)] + 0.01
    out = {}

    def library_fn(args, r, prec):
        v_x, _nrm, _ok, q_x, qsq, scale = args
        # int8 values held as f32 (a copy made once, outside the timing)
        v8 = v_x[0].float() if prec == "int8" else None

        def library():
            if prec == "bf16":
                dots = (q_x @ v_x[0].T).float()
            elif prec == "int8":
                dots = (q_x.float() @ v8.T) * scale[0]
            else:
                dots = q_x @ v_x[0].T
            d_sq = torch.clamp(qsq[:, None] - 2.0 * dots + nrm[0][None],
                               min=0.0)
            return torch.topk(1.0 / (1.0 + d_sq), r)
        return library

    shapes = []
    if k1:
        shapes += [("fp32", r, b) for r in WIDE_K1[0] for b in WIDE_K1[1]]
        shapes += [(prec, k, b) for prec in WIDE_REDUCED[0]
                   for k in WIDE_REDUCED[1] for b in WIDE_REDUCED[2]]
    for prec, k, b in shapes:
        q = q_all[:b].contiguous()
        args, r = scan_inputs(kf, v, nrm, ok, q, k, prec)
        label = f"K1 {prec} k={k} r={r} B={b}"
        check_scan(kf, args, r, prec, label)
        design = functools.partial(kf.pool_scan, *args, r=r,
                                   similarity="l2_norm",
                                   score_precision=prec)
        tile = functools.partial(kf._launch_tile, *args, r=r,
                                 similarity="l2_norm", score_precision=prec)
        plain = functools.partial(kf.plain_pool, *args, r=r,
                                  similarity="l2_norm", score_precision=prec)
        tier = kf.scan_tier(prec, r)
        out[label] = time_design(label, design, tile, plain,
                                 library_fn(args, r, prec),
                                 pool_bound(1, n, DIM, b, r, prec),
                                 names=MMA_KERNELS if tier == "mma"
                                 else WIDE_KERNELS)
        out[label]["tier"] = tier
    if k3:
        for k in WIDE_K3[0]:
            for b in WIDE_K3[1]:
                q = q_all[:b].contiguous()
                qsq = (q * q).sum(1)
                one = torch.ones(1, device=dev)
                label = f"K3 k={k} B={b}"
                gv, gi = kb.knn_topk_auto(v[0], nrm[0], ok[0], q, k=k)
                order_check(kf, gv[None], gi[None], (v, nrm, ok, q, qsq, one),
                            k, "l2_norm", label)
                block_tile_check(kb, kf, v[0], nrm[0], ok[0], q, k, label)
                qp = kb._pad_queries(q, None)
                design = functools.partial(kb.knn_topk_auto, v[0], nrm[0],
                                           ok[0], q, k=k)
                tile = functools.partial(kb._launch_block_tile, v[0], nrm[0],
                                         ok[0], qp, k=k, similarity="l2_norm")
                plain = functools.partial(family_plain, kb, "knn_block", v[0],
                                          nrm[0], ok[0], q, k)
                out[label] = time_design(
                    label, design, tile, plain,
                    library_fn((v, nrm, ok, q, qsq, one), k, "fp32"),
                    blocks_bound("knn_block", n, DIM, b, k, 0))
                out[label]["tier"] = kb.block_tier(k)
    del v
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# K1 at fp32 past r = 1024: the large-r tier (csrc/knn_large.cuh)
# --------------------------------------------------------------------------

# the r of the large-r tier's checks, and past them one of five tiles and
# three merge rounds
LARGE_RS = (1025, 1400, 2000, 4096, 10_000)
LARGE_MULTI_TILE_R = 20_000
# the tier's kernels by the profiler's names (its keys are cut at 60
# characters): the scans, the multi-CTA select's, the yardstick select
LARGE_SCAN = "scan"
LARGE_SELECT = ("knn_large_pass", "knn_large_collect", "knn_large_tile",
                "knn_large_merge", "knn_large_rank", "knn_large_place")
LARGE_YARDSTICK = "knn_large_select_kernel"


def select_variants_check(kf, args, r: int, sim: str, prec: str,
                          what: str) -> None:
    """The tier's pool (pool_scan) against its select run again on the
    scan's keys by each sort and by the yardstick (the earlier one-CTA
    select): bit for bit."""
    lib = kf._library()
    want_v, want_i = kf.pool_scan(*args, r=r, similarity=sim,
                                  score_precision=prec)
    keys = kf.large_keys(lib, *args, similarity=sim, score_precision=prec)
    runs = {sort: functools.partial(kf.large_select, lib, keys, r, sort)
            for sort in kf.LARGE_SORTS}
    runs["yardstick"] = functools.partial(kf.large_select_yardstick, lib,
                                          keys, r)
    for name, run in runs.items():
        v, i = run()
        torch.cuda.synchronize()
        if not (torch.equal(i, want_i) and torch.equal(v, want_v)):
            bad = (i != want_i).nonzero()[:5].tolist()
            raise AssertionError(f"{what}: the {name} select differs from "
                                 f"the tier's pool (ids differ at {bad})")


def large_check(kf, args, scores, r: int, sim: str, what: str) -> float:
    """One K1 scan at fp32 with r > 1024 on clustered floats: ids and
    values bit-equal to the kernel-order brute force's top r (`scores`:
    kernel_order_scores on the same operands, order_top), and exactly one
    K1 launch, on the large-r tier and its multi-CTA select (none of the
    yardstick); then each sort and the yardstick on the same keys
    (select_variants_check). Returns the max |dv| (0)."""
    counters = (kf.launches, kf.large_launches, kf.large_select_launches,
                kf.yardstick_launches)
    before = [c.count for c in counters]
    kv, ki = kf.pool_scan(*args, r=r, similarity=sim, score_precision="fp32")
    torch.cuda.synchronize()
    got = [c.count - b for c, b in zip(counters, before)]
    if got != [1, 1, 1, 0]:
        raise AssertionError(f"{what}: (K1, large-r tier, its select, the "
                             f"yardstick) launched {got} times, want "
                             f"[1, 1, 1, 0]")
    rv, ri = order_top(kf, scores, r)
    if not (torch.equal(ki, ri) and torch.equal(kv, rv)):
        bad = (ki != ri).nonzero()[:5].tolist()
        raise AssertionError(f"{what}: differs from the kernel-order brute "
                             f"force (ids differ at {bad})")
    select_variants_check(kf, args, r, sim, "fp32", what)
    fin = torch.isfinite(rv)
    return float((kv[fin] - rv[fin]).abs().max()) if bool(fin.any()) else 0.0


def score_keys(scores, valid):
    """The scans' u32 score keys (in int32) of f32 scores [S, B, n] (-0.0
    as +0.0): 0 for -inf and for a dead doc (valid [S, n])."""
    u = torch.where(scores == 0, torch.zeros_like(scores), scores).view(
        torch.int32)
    sk = torch.where(u < 0, ~u, u | -0x80000000)
    live = valid[:, None, :] & (scores > float("-inf"))
    return torch.where(live, sk, torch.zeros_like(sk)).contiguous()


def select_stress_check(kf, dev, seed: int) -> int:
    """The multi-CTA select, by both sorts, and the yardstick on key rows
    built to stress it, bit-equal to plain_large_select: every live doc one
    score (every key ties: the compaction takes them in doc order, across
    slices); a first-level bin
    (exponent and three mantissa bits) holding exactly the keys still
    needed; r equal to the live count and past it; four shards, one with 5
    live docs; and B = 33 over 4 shards (132 rows: two CTAs a row) of
    scores tied in runs. Returns the rows checked."""
    rng = np.random.default_rng(seed + 46)
    lib = kf._library()
    n = 60_000

    def tied(s: int, b: int, m: int) -> np.ndarray:
        return (np.round(rng.uniform(0, 1, (s, b, m)) * 4608) / 4608).astype(
            np.float32)

    exact = rng.uniform(0.0, 0.25, n).astype(np.float32)
    exact[:2000] = rng.uniform(0.75, 1.0, 2000)
    exact[2000:10_000] = rng.uniform(0.5, 0.56, 8000)
    dead = rng.random((1, n)) >= 0.03
    four = rng.random((4, 12_000)) >= 0.03
    four[3] = False
    four[3, :5] = True
    live = int(dead.sum())
    cases = (
        ("every live doc one score", np.full((1, 2, n), 0.5, np.float32),
         np.ones((1, n), bool), (1025, 4096, 10_000, LARGE_MULTI_TILE_R)),
        ("a first-level bin of exactly the keys needed", exact[None, None],
         np.ones((1, n), bool), (10_000,)),
        ("r the live count and past it", tied(1, 2, n), dead,
         (live, live + 777)),
        ("four shards, one with 5 live docs", tied(4, 9, 12_000), four,
         (1025, 10_000)),
        ("B = 33 over four shards", tied(4, 33, 12_000),
         rng.random((4, 12_000)) >= 0.03, (1025, 4096, 10_000)),
    )
    rows = 0
    for what, scores, valid, rs in cases:
        keys = score_keys(torch.from_numpy(scores).to(dev),
                          torch.from_numpy(valid).to(dev))
        for r in rs:
            want_v, want_i = kf.plain_large_select(keys, r)
            runs = {sort: functools.partial(kf.large_select, lib, keys, r,
                                            sort) for sort in kf.LARGE_SORTS}
            runs["yardstick"] = functools.partial(kf.large_select_yardstick,
                                                  lib, keys, r)
            for name, run in runs.items():
                v, i = run()
                torch.cuda.synchronize()
                if not (torch.equal(i, want_i) and torch.equal(v, want_v)):
                    bad = (i != want_i).nonzero()[:5].tolist()
                    raise AssertionError(f"select stress [{what}] r={r}: "
                                         f"the {name} select differs from "
                                         f"plain_large_select at {bad}")
            rows += keys.shape[0] * keys.shape[1]
        log(f"K1 large-r select stress [{what}]: both sorts and the "
            f"yardstick bit-equal to plain_large_select at r = {rs}")
    return rows


def large_kernel_phase(kf, dev, seed: int) -> float:
    """K1's large-r tier (fp32, r > 1024) on clustered floats with 3% dead
    docs, bit for bit against the kernel-order brute force, and each sort of
    its select and the yardstick against its pool (large_check): one shard
    of 60,000 128-d docs at B = 1, 9 and 33 x r = 1025, 1400, 2000, 4096,
    10,000 and 20,000 (five tiles, three merge rounds) in l2 and cosine;
    one of 20,000 768-d docs at the same B and r up to 10,000; four shards
    of 12,000 (the last with 5 live docs, fewer than r) at B = 1, 9 and 33;
    d = 30 (padded to 32); a shard of 1,500 docs at r = 2048 and 5000, past
    its live count, which must return every live doc; and a shard of
    20,000 copies of one vector (every score equal: the select's threshold
    is decided by doc order). Beside it the tile scan, the yardstick
    timed beside every design, at r = 1025 and 1400 (d = 128: its pools fit
    shared memory) against the same brute force (tile_check). Returns the
    max |dv|."""
    rng = np.random.default_rng(seed + 40)
    err = 0.0
    if LARGE_MULTI_TILE_R <= 4 * kf.LARGE_TILE:
        raise AssertionError("the large-r checks do not reach three merge "
                             "rounds of the select's sort")
    cases = (
        (1, 60_000, DIM, (1, 9, 33), ("l2_norm", "cosine"),
         LARGE_RS + (LARGE_MULTI_TILE_R,), False),
        (1, 20_000, 768, (1, 9, 33), ("l2_norm", "cosine"), LARGE_RS, False),
        (4, 12_000, DIM, (1, 9, 33), ("l2_norm",), (1025, 4096, 10_000),
         False),
        (1, 5_000, 30, (1, 9), ("l2_norm",), (1025, 2000), False),
        (1, 1_500, DIM, (1, 9), ("l2_norm",), (2048, 5000), False),
        (1, 20_000, DIM, (1, 9), ("l2_norm",), (1025, 4096, 10_000), True),
    )
    for s, n, d, bs, sims, rs, same in cases:
        data = clustered(rng, s * n, d).reshape(s, n, d)
        if same:
            data[:] = data[0, 0]
        v = torch.from_numpy(data).to(dev)
        nrm = (v.double() ** 2).sum(2).float()
        ok = torch.from_numpy(rng.random((s, n)) >= 0.03).to(dev)
        if s == 4:
            ok[3] = False
            ok[3, :5] = True
        one = torch.ones(s, device=dev)
        for b in bs:
            q = v[0, torch.from_numpy(rng.choice(n, b, replace=False))
                  .to(dev)] + 0.01 * torch.randn((b, d), device=dev)
            qsq = (q * q).sum(1)
            args = (v, nrm, ok, q, qsq, one)
            for sim in sims:
                scores = kernel_order_scores(kf, v, nrm, ok, q, qsq, sim)
                for r in rs:
                    what = (f"K1 large S={s} n={n} d={d} B={b} r={r} {sim}"
                            f"{' one vector' if same else ''}")
                    err = max(err, large_check(kf, args, scores, r, sim,
                                               what))
                    if r > n:
                        kv, _ki = kf.pool_scan(*args, r=r, similarity=sim,
                                               score_precision="fp32")
                        live = ok.sum(1)[:, None].expand(s, b)
                        if not torch.equal(torch.isfinite(kv).sum(2), live):
                            raise AssertionError(f"{what}: not every live "
                                                 f"doc returned")
                del scores
            if s == 1 and d == DIM and n == 60_000:
                for r in (1025, 1400):
                    tile_check(kf, args, r, f"K1 S=1 n={n} B={b} r={r}")
        log(f"K1 large-r tier parity S={s} n={n} d={d}"
            f"{' (one vector)' if same else ''}: bit-equal to the "
            f"kernel-order brute force at B = {bs}, r = {rs}, {sims}; both "
            f"sorts and the yardstick equal")
        del v
        torch.cuda.empty_cache()
    return err


def time_large(kf, label: str, args, r: int, prec: str, plain, library,
               bound: dict) -> dict:
    """One shape of the large-r record: CUDA-event ms of the tier
    (pool_scan, twice, around the rest), of its select alone on the scan's
    keys by each sort and by the yardstick, of the plain versions
    (plain_pool, plain_large_select) and of the library calls (the tier's:
    `library`; the select's: torch.topk over the keys' scores, decoded
    before timing); device ms of each by kernel name (the select's share
    of the tier: its device ms less the scan's, the state's zeroing
    included); the select's bound (the keys read once, the r winners
    written); the memory clock before and after."""
    lib = kf._library()
    clock0 = mem_clock()
    tier = functools.partial(kf.pool_scan, *args, r=r, similarity="l2_norm",
                             score_precision=prec)
    keys = kf.large_keys(lib, *args, similarity="l2_norm",
                         score_precision=prec)
    scores = kf.key_scores(keys)
    sel = {sort: functools.partial(kf.large_select, lib, keys, r, sort)
           for sort in kf.LARGE_SORTS}
    yard = functools.partial(kf.large_select_yardstick, lib, keys, r)
    ms = time_ms(tier, 20)
    sel_ms = {sort: time_ms(fn, 20) for sort, fn in sel.items()}
    yard_ms = time_ms(yard, 10)
    ms_again = time_ms(tier, 20)
    plain_ms = time_ms(plain, 3)
    sel_plain_ms = time_ms(functools.partial(kf.plain_large_select, keys, r),
                           3)
    library_ms = time_ms(library, 10)
    sel_library_ms = time_ms(lambda: torch.topk(scores, r), 10)
    prof = device_profile(tier, 5)
    sel_prof = {sort: device_profile(fn, 5) for sort, fn in sel.items()}
    yard_prof = device_profile(yard, 5)
    scan_ms = kernel_ms(prof, LARGE_SCAN)
    S, B, n = keys.shape
    sel_bytes = 4 * S * B * n + 8 * S * B * r
    out = {"ms": ms, "ms_again": ms_again, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "device_ms": prof and prof["device_ms"],
           "scan_device_ms": scan_ms,
           "select_device_ms": prof and prof["device_ms"] - scan_ms,
           "select_kernels": {part: kernel_ms(prof, part)
                              for part in LARGE_SELECT},
           "sort": kf.large_sort_plan(r),
           "select_ms": sel_ms,
           "select_device": {sort: p and p["device_ms"]
                             for sort, p in sel_prof.items()},
           "select_kernels_by_sort": {
               sort: {part: kernel_ms(p, part) for part in LARGE_SELECT}
               for sort, p in sel_prof.items()},
           "yardstick_ms": yard_ms,
           "yardstick_device_ms": kernel_ms(yard_prof, LARGE_YARDSTICK),
           "select_plain_ms": sel_plain_ms,
           "select_library_ms": sel_library_ms,
           "select_bound_ms": sel_bytes / HBM_BYTES_PER_S * 1e3,
           "select_bound_by": "bytes",
           "mem_clock": [clock0, mem_clock()], **bound}
    log(f"large record {label}: {json.dumps(out)}")
    return out


# (docs, slots, d, r) of the large-r records: the 768-d index's slab and
# cell A's
LARGE_SHAPES = ((20_000, 32_768, 768, (1025, 2000, 4096)),
                (200_000, 262_144, DIM, (10_000, LARGE_MULTI_TILE_R)))
# the shape of the select's line in the kernels record
LARGE_SELECT_HEADLINE = "K1 large n=200000 slots=262144 d=128 r=10000 B=1"


def large_timing(kf, dev, seed: int) -> dict:
    """K1's large-r tier at the stacked step's shapes (one shard, B = 1, l2,
    the serving slab's power-of-two slot count): 20,000 768-d docs in 32,768
    slots at r = 1025, 2000 and 4096, cell A's 200,000 128-d docs in
    262,144 slots at r = 10,000 and 20,000; each checked first
    (large_check), then timed (time_large: the tier, its select by each
    sort, the yardstick, the plain versions and the library calls:
    torch.topk over the l2-transformed q @ v.T for the tier) beside its
    bound (pool_bound: the slab, norms and flags read once, the pool
    written; the keys the design writes and reads back are its scratch and
    are not counted)."""
    rng = np.random.default_rng(seed + 41)
    out = {}
    for n_docs, slots, d, rs in LARGE_SHAPES:
        data = np.zeros((1, slots, d), np.float32)
        data[0, :n_docs] = clustered(rng, n_docs, d)
        v = torch.from_numpy(data).to(dev)
        nrm = (v.double() ** 2).sum(2).float()
        ok = torch.zeros((1, slots), dtype=torch.bool, device=dev)
        ok[0, :n_docs] = True
        q = v[0, int(rng.integers(n_docs))][None] + 0.01
        qsq = (q * q).sum(1)
        args = (v, nrm, ok, q, qsq, torch.ones(1, device=dev))
        scores = kernel_order_scores(kf, v, nrm, ok, q, qsq, "l2_norm")
        for r in rs:
            label = f"K1 large n={n_docs} slots={slots} d={d} r={r} B=1"
            large_check(kf, args, scores, r, "l2_norm", label)
            plain = functools.partial(kf.plain_pool, *args, r=r,
                                      similarity="l2_norm",
                                      score_precision="fp32")

            def library(r=r):
                d_sq = torch.clamp(qsq[:, None] - 2.0 * (q @ v[0].T)
                                   + nrm[0][None], min=0.0)
                return torch.topk(1.0 / (1.0 + d_sq), r)

            out[label] = time_large(kf, label, args, r, "fp32", plain,
                                    library, pool_bound(1, slots, d, 1, r))
        del v, scores
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# K1 at bf16 and int8 past r = 1024: the large-r tier's tensor-core scan
# (csrc/knn_large_mma.cuh)
# --------------------------------------------------------------------------

LARGE_MMA_RS = (1025, 2000, 4096, 10_000)
# the shape of the large-r tensor-core scan's line in the kernels record
LARGE_MMA_HEADLINE = "K1 large bf16 n=20000 slots=32768 d=768 r=1025 B=1"


def large_mma_check(kf, args, r: int, sim: str, prec: str, what: str,
                    integer: bool) -> float:
    """One K1 scan at bf16 or int8 with r > 1024 against plain_pool: int8
    pools bit-equal on any data, bf16 pools bit-equal on mma_sixteenths
    (`integer`) and on floats equal but at summation ties
    (bf16_float_check, each logged; at d = 768, whose dots near 13,000 have
    an f32 ulp of 1e-3, every score held to its f32 error bound in place of
    the fixed tolerance); exactly one K1 launch, on the large-r
    tier's tensor-core scan and its multi-CTA select, and none of the tile
    scan, the tensor-core tier or the yardstick; then each sort and the
    yardstick on the same keys (select_variants_check). Returns the max
    |dv|."""
    counters = (kf.launches, kf.large_launches, kf.large_mma_launches,
                kf.mma_launches, kf.tile_launches, kf.large_select_launches,
                kf.yardstick_launches)
    before = [c.count for c in counters]
    if prec == "bf16" and not integer:
        err = bf16_float_check(kf, args, r, sim, what,
                               bound=args[0].shape[2] >= 512)
    else:
        err = compare_pools(kf, args, r, sim, prec, what, bits=True)
    got = [c.count - b for c, b in zip(counters, before)]
    if got != [1, 1, 1, 0, 0, 1, 0]:
        raise AssertionError(f"{what}: (K1, large-r tier, its tensor-core "
                             f"scan, tensor-core tier, tile scan, select, "
                             f"yardstick) launched {got} times, want "
                             f"[1, 1, 1, 0, 0, 1, 0]")
    select_variants_check(kf, args, r, sim, prec, what)
    return err


def large_mma_kernel_phase(kf, dev, seed: int) -> float:
    """K1's large-r tier at bf16 and int8 (r > 1024, the tensor-core tier's
    dots feeding the large-r select) against plain_pool (large_mma_check):
    clustered floats, one shard of 60,000 128-d docs and one of 20,000
    768-d docs, at B = 1, 9 and 33 x r = 1025, 2000, 4096 and 10,000 in l2
    and cosine (int8 bit-equal, bf16 ids equal but at logged summation
    ties); mma_sixteenths (bf16's f32 sums exact, so bit-equal at both
    precisions) at both widths, B = 1 and 9, r = 1025 and 4096; four shards
    of 12,000 (the last with 5 live docs) at B = 1, 9 and 33; 20,000 copies
    of one mma_sixteenths vector (every score equal) at B = 1 and 9. At
    every (width, B, precision, similarity) the first 1024 slots of the
    r = 1025 pool must be the tensor-core tier's r = 1024 pool bit for bit:
    a doc's score is the same bits in both tiers. Returns the max |dv|."""
    rng = np.random.default_rng(seed + 44)
    err = 0.0
    cases = (
        (1, 60_000, DIM, False, (1, 9, 33), ("l2_norm", "cosine"),
         LARGE_MMA_RS, False),
        (1, 20_000, 768, False, (1, 9, 33), ("l2_norm", "cosine"),
         LARGE_MMA_RS, False),
        (1, 60_000, DIM, True, (1, 9), ("l2_norm",), (1025, 4096), False),
        (1, 20_000, 768, True, (1, 9), ("l2_norm",), (1025, 4096), False),
        (4, 12_000, DIM, False, (1, 9, 33), ("l2_norm",), (1025, 4096),
         False),
        (1, 20_000, DIM, True, (1, 9), ("l2_norm",), (1025, 10_000), True),
    )
    for s, n, d, integer, bs, sims, rs, same in cases:
        data, v, nrm, ok = lists_case(dev, rng, s, n, d, integer,
                                      grid=mma_sixteenths)
        if same:
            data[:] = data[0]
            v[:] = v[0, 0]
            nrm[:] = nrm[0, 0]
        for b in bs:
            queries = data[rng.choice(n, b, replace=False)].copy()
            if not integer:
                queries = queries + 0.01 * rng.standard_normal(
                    queries.shape).astype(np.float32)
            q = torch.from_numpy(queries).to(dev)
            for prec in REDUCED:
                args = reduced_args(kf, v, nrm, ok, q, prec)
                for sim in sims:
                    what = (f"K1 large mma {prec} S={s} n={n} d={d} B={b} "
                            f"{sim} integer={integer}"
                            f"{' one vector' if same else ''}")
                    for r in rs:
                        err = max(err, large_mma_check(
                            kf, args, r, sim, prec, f"{what} r={r}",
                            integer))
                    bv, bi = kf.pool_scan(*args, r=1025, similarity=sim,
                                          score_precision=prec)
                    wv, wi = kf.pool_scan(*args, r=1024, similarity=sim,
                                          score_precision=prec)
                    if not (torch.equal(bi[..., :1024], wi)
                            and torch.equal(bv[..., :1024], wv)):
                        raise AssertionError(f"{what}: the r = 1025 pool's "
                                             f"first 1024 slots are not the "
                                             f"tensor-core tier's r = 1024 "
                                             f"pool")
        log(f"K1 large-r tensor-core scan parity S={s} n={n} d={d} "
            f"integer={integer}{' (one vector)' if same else ''}: "
            f"{'bit-equal' if integer else 'int8 bit-equal, bf16 ids equal'}"
            f" at B = {bs}, r = {rs}, {sims}; r = 1025's first 1024 slots "
            f"the tensor-core tier's pool; both sorts and the yardstick "
            f"equal")
        del v
        torch.cuda.empty_cache()
    return err


def large_mma_timing(kf, dev, seed: int) -> dict:
    """K1's large-r tier at bf16 and int8 at the stacked step's shapes (one
    shard, B = 1, l2; as large_timing: 20,000 768-d docs in 32,768 slots at
    r = 1025, 2000 and 4096, cell A's 200,000 128-d docs in 262,144 slots
    at r = 10,000 and 20,000): each checked first (large_mma_check), then
    timed (time_large; the tier's library call: torch.topk over the
    l2-transformed f32 product of the same bf16 or int8 operands, exact in
    f32, times the int8 scale) beside its bound (pool_bound at the
    operands' width: bf16 2 bytes and int8 1 byte a component, against
    their peaks)."""
    rng = np.random.default_rng(seed + 45)
    out = {}
    for n_docs, slots, d, rs in LARGE_SHAPES:
        data = np.zeros((1, slots, d), np.float32)
        data[0, :n_docs] = clustered(rng, n_docs, d)
        v = torch.from_numpy(data).to(dev)
        nrm = (v.double() ** 2).sum(2).float()
        ok = torch.zeros((1, slots), dtype=torch.bool, device=dev)
        ok[0, :n_docs] = True
        q = v[0, int(rng.integers(n_docs))][None] + 0.01
        for prec in REDUCED:
            args = reduced_args(kf, v, nrm, ok, q, prec)
            v_x, _n, _o, q_x, qsq, scale = args
            for r in rs:
                label = (f"K1 large {prec} n={n_docs} slots={slots} d={d} "
                         f"r={r} B=1")
                large_mma_check(kf, args, r, "l2_norm", prec, label, False)
                plain = functools.partial(kf.plain_pool, *args, r=r,
                                          similarity="l2_norm",
                                          score_precision=prec)

                def library(r=r, v_x=v_x, q_x=q_x, qsq=qsq, scale=scale):
                    dots = (q_x.float() @ v_x[0].float().T) * scale[0]
                    d_sq = torch.clamp(qsq[:, None] - 2.0 * dots + nrm[0][None],
                                       min=0.0)
                    return torch.topk(1.0 / (1.0 + d_sq), r)

                out[label] = time_large(kf, label, args, r, prec, plain,
                                        library,
                                        pool_bound(1, slots, d, 1, r, prec))
        del v
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# the IVF-PQ route in one order whatever the batch: the LUT kernel
# (csrc/adc_lut.cu) and the exact rescore's dots (csrc/knn_rescore.cu)
# --------------------------------------------------------------------------

# (what, nlist, d, m, B): glove-100 and cell C (100-d, m 20, nlist 512),
# and MS-MARCO-class 768-d at m = 96
LUT_SHAPES = (("glove-100 / cell C", 512, ANN_DIM, ANN_M, (1, 8, 32)),
              ("768-d m=96", 512, 768, 96, (1, 8)))


def einsum_lut(queries, coarse, codebooks, probes):
    """The LUT build the kernel replaced (a batched einsum and row sums,
    whose orders the library picks by the shape): the yardstick."""
    m, ks, dsub = codebooks.shape
    resid = queries[:, None, :] - coarse[probes.long()]
    r_sub = resid.reshape(queries.shape[0], probes.shape[1], m, dsub)
    r_dot = torch.einsum("bpms,mks->bpmk", r_sub, codebooks)
    r_sq = (r_sub * r_sub).sum(dim=-1)
    cb_sq = (codebooks * codebooks).sum(dim=-1)
    return r_sq[..., None] - 2.0 * r_dot + cb_sq[None, None]


def einsum_exact_rescore(queries, cand, vectors, norms_sq, valid,
                         similarity: str, k_eff: int):
    """The IVF-PQ rescore before its dots went to the fixed-order kernel
    (a batched einsum and a row sum of |q|^2): the yardstick."""
    from opensearch_tpu_torch.ops.topk import stable_topk

    cand = cand.long()
    safe = torch.clamp(cand, min=0)
    cdots = torch.einsum("bd,brd->br", queries, vectors[safe])
    q_sq = (queries * queries).sum(dim=-1, keepdim=True)
    if similarity == "cosine":
        raw = cdots / torch.clamp(torch.sqrt(q_sq) * torch.sqrt(
            torch.clamp(norms_sq[safe], min=1e-24)), min=1e-12)
        score = (1.0 + raw) / 2.0
    else:
        score = 1.0 / (1.0 + torch.clamp(q_sq - 2.0 * cdots + norms_sq[safe],
                                         min=0.0))
    score = torch.where((cand >= 0) & valid[safe], score, float("-inf"))
    return stable_topk(score, k_eff)


def lut_kernel_phase(dev, seed: int) -> dict:
    """The LUT kernel against its plain version (ops/adc_lut.plain_lut) on
    random coarse centroids and codebooks at glove-100's and cell C's
    shapes (nlist 512, d 100, m 20, ks 256, P = 8) at B = 1, 8 and 32, and
    at 768-d with m = 96 (dsub 8) at B = 1 and 8: the f32 LUTs bit-equal,
    and through adc_scan.build_luts at bf16 and u8 (the downcast and the
    per-query quantization after it) bit-equal to the plain build; each
    batch row bit-equal to its solo call; one launch a call. The rescore's
    dots alone (knn_rescore.rescore_dots) bit-equal to their plain version
    at B = 1 and 8 x R = 64 and 640, d = 100 and 768, -1 ids among them.
    Then the host's probe scores: numpy's product of a batch of 32 rows
    against 32 products of one row each (host_probe_select takes the
    latter), the count of rows whose bits differ logged. Returns
    {"max_abs_err": 0.0, "probe_rows_differ": n}."""
    from opensearch_tpu_torch.ops import adc_lut, adc_scan
    from opensearch_tpu_torch.ops import knn_rescore as kr

    rng = np.random.default_rng(seed + 50)
    for what, nlist, d, m, bs in LUT_SHAPES:
        coarse = torch.from_numpy(rng.standard_normal((nlist, d)).astype(
            np.float32) * 2.0).to(dev)
        cb = torch.from_numpy(rng.standard_normal((m, 256, d // m)).astype(
            np.float32)).to(dev)
        for b in bs:
            q = torch.from_numpy(rng.standard_normal((b, d)).astype(
                np.float32) * 2.0).to(dev)
            probes = torch.from_numpy(np.stack([
                rng.choice(nlist, 8, replace=False) for _ in range(b)])
                .astype(np.int32)).to(dev)
            before = adc_lut.launches.count
            got = adc_lut.lut(q, coarse, cb, probes)
            if adc_lut.launches.count - before != 1:
                raise AssertionError(f"LUT {what} B={b}: not one launch")
            want = adc_lut.plain_lut(q, coarse, cb, probes)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = (got != want).nonzero()[:3].tolist()
                raise AssertionError(f"LUT {what} B={b}: not bit-equal to "
                                     f"plain_lut (first at {bad})")
            for prec in ("bf16", "int8"):
                k_lut = adc_scan.build_luts(q, coarse, cb, probes,
                                            adc_precision=prec)
                p_lut = adc_scan.build_luts(q, coarse, cb, probes,
                                            adc_precision=prec,
                                            use_kernel=False)
                if not torch.equal(k_lut, p_lut):
                    raise AssertionError(f"LUT {what} B={b} {prec}: not "
                                         f"bit-equal to the plain build")
            for i in range(b):
                solo = adc_lut.lut(q[i:i + 1], coarse, cb, probes[i:i + 1])
                if not torch.equal(got[i:i + 1], solo):
                    raise AssertionError(f"LUT {what} B={b}: row {i} is not "
                                         f"its solo LUT")
        log(f"LUT kernel {what}: bit-equal to plain_lut at B = {bs} (f32, "
            f"and through build_luts at bf16 and u8), each row its solo "
            f"LUT")
    for d in (ANN_DIM, 768):
        v = torch.from_numpy(clustered(rng, 5000, d)).to(dev)[None]
        for b in (1, 8):
            q = torch.from_numpy(rng.standard_normal((b, d)).astype(
                np.float32)).to(dev)
            for r in (64, 640):
                cand = torch.from_numpy(rng.integers(-1, 5000, (1, b, r))
                                        .astype(np.int32)).to(dev)
                got = kr.rescore_dots(q, v, cand)
                want = kr.plain_rescore_dots(q, v, cand)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"rescore dots d={d} B={b} R={r}: "
                                         f"not bit-equal to the plain dots")
    log("rescore dots: bit-equal to plain_rescore_dots at d = 100 and 768, "
        "B = 1 and 8, R = 64 and 640")
    coarse_h = rng.standard_normal((512, ANN_DIM)).astype(np.float32)
    qh = rng.standard_normal((32, ANN_DIM)).astype(np.float32)
    rows = np.stack([coarse_h @ x for x in qh])
    differ = int((~np.all(qh @ coarse_h.T == rows, axis=1)).sum())
    log(f"host probe scores: {differ} of 32 rows of numpy's batched product "
        f"differ in their bits from one product a row (host_probe_select "
        f"takes one a row)")
    return {"max_abs_err": 0.0, "probe_rows_differ": differ}


def lut_timing(dev, seed: int) -> dict:
    """The LUT kernel and the IVF-PQ exact rescore (the fixed-order dots and
    |q|^2 kernels, the reference's transform and the top-k) beside the
    einsum path each replaced, at glove-100's and cell C's shapes (nlist
    512, d 100, m 20, ks 256, P = 8; the rescore: R = 64 candidates, k = 10,
    cosine) at B = 1, 8 and 32: CUDA-event ms, profiler device ms, the
    plain version's ms, and the bound (bytes: the queries, each probe's
    centroid, the codebooks and the LUTs once; operations 2 B P m ks dsub;
    the rescore: each candidate row, its norm and flag, the ids once)."""
    from opensearch_tpu_torch.ops import adc_lut, ivfpq

    rng = np.random.default_rng(seed + 51)
    nlist, d, m, ks, P, R, k = 512, ANN_DIM, ANN_M, 256, 8, 64, 10
    coarse = torch.from_numpy(rng.standard_normal((nlist, d)).astype(
        np.float32)).to(dev)
    cb = torch.from_numpy(rng.standard_normal((m, ks, d // m)).astype(
        np.float32)).to(dev)
    n = ANN_MAIN_DOCS
    vecs = torch.from_numpy(ann_corpus(rng, n, d)).to(dev)
    vecs = vecs / torch.linalg.norm(vecs, dim=1, keepdim=True)
    nrm = (vecs * vecs).sum(1)
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    out = {}
    for b in (1, 8, 32):
        q = torch.from_numpy(rng.standard_normal((b, d)).astype(
            np.float32)).to(dev)
        q = q / torch.linalg.norm(q, dim=1, keepdim=True)
        probes = torch.from_numpy(np.stack([
            rng.choice(nlist, P, replace=False) for _ in range(b)])
            .astype(np.int32)).to(dev)
        cand = torch.from_numpy(rng.integers(0, n, (b, R)).astype(
            np.int32)).to(dev)
        kern = functools.partial(adc_lut.lut, q, coarse, cb, probes)
        plain = functools.partial(adc_lut.plain_lut, q, coarse, cb, probes)
        eins = functools.partial(einsum_lut, q, coarse, cb, probes)
        nbytes = 4 * (b * d + b * P * d + m * ks * (d // m) + b * P * m * ks)
        flops = 2 * b * P * m * ks * (d // m)
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
        ms = time_ms(kern, 50)
        eins_ms = time_ms(eins, 50)
        ms_again = time_ms(kern, 50)
        prof, eprof = device_profile(kern, 10), device_profile(eins, 10)
        out[f"lut B={b}"] = {
            "ms": ms, "ms_again": ms_again, "einsum_ms": eins_ms,
            "plain_ms": time_ms(plain, 10), "library_ms": None,
            "device_ms": prof and prof["device_ms"],
            "einsum_device_ms": eprof and eprof["device_ms"],
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations"}
        resc = functools.partial(ivfpq.exact_rescore, q, cand, vecs, nrm, ok,
                                 similarity="cosine", k_eff=k,
                                 impl="pallas")
        resc_plain = functools.partial(ivfpq.exact_rescore, q, cand, vecs,
                                       nrm, ok, similarity="cosine",
                                       k_eff=k, impl="xla")
        resc_eins = functools.partial(einsum_exact_rescore, q, cand, vecs,
                                      nrm, ok, "cosine", k)
        nbytes = b * R * (4 * d + 4 + 1 + 4) + 4 * b * d + 8 * b * k
        rms = time_ms(resc, 50)
        reins = time_ms(resc_eins, 50)
        rms_again = time_ms(resc, 50)
        rprof = device_profile(resc, 10)
        reprof = device_profile(resc_eins, 10)
        out[f"rescore B={b}"] = {
            "ms": rms, "ms_again": rms_again, "einsum_ms": reins,
            "plain_ms": time_ms(resc_plain, 10), "library_ms": None,
            "device_ms": rprof and rprof["device_ms"],
            "dots_device_ms": kernel_ms(rprof, "knn_rescore_kernel"),
            "einsum_device_ms": reprof and reprof["device_ms"],
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        log(f"LUT B={b}: {json.dumps(out[f'lut B={b}'])}; ANN rescore B={b}: "
            f"{json.dumps(out[f'rescore B={b}'])}")
    return out


def ann_batch_check(ads, ivfpq, segment, queries: np.ndarray, dev) -> dict:
    """Index C's IVF-PQ segment: 8 queries through the fused pipeline in one
    call (search_index, kernel "pallas": the host probes, one LUT launch,
    one K2 launch, one rescore-dots launch and one |q|^2 launch) against
    each query alone, as stacked_batch_phase holds the stacked step: every
    row's scores and ids its solo call's bits, at fp32, bf16 and u8 ADC."""
    from opensearch_tpu_torch.ops import adc_lut
    from opensearch_tpu_torch.ops import knn_rescore as kr

    _host, dseg = segment
    vf = dseg.vector_fields["v"]
    valid = vf.present & dseg.live
    counters = {"adc_lut": adc_lut.launches, "adc_scan": ads.launches,
                "knn_rescore": kr.launches, "knn_query_sq": kr.sq_launches}
    out = {}
    for prec in ("fp32", "bf16", "int8"):
        def run(qs):
            return ivfpq.search_index(vf.ann, vf.vectors, vf.norms_sq, valid,
                                      qs, k=10, nprobe=8,
                                      similarity="cosine",
                                      adc_precision=prec, kernel="pallas")

        before = {key: c.count for key, c in counters.items()}
        bv, bi = run(queries[:8])
        launches = {key: c.count - before[key] for key, c in counters.items()}
        if set(launches.values()) != {1}:
            raise AssertionError(f"[glove_c] ANN batch {prec}: launches "
                                 f"{launches}, want one each")
        for i in range(8):
            sv, si = run(queries[i:i + 1])
            if not (torch.equal(bv[i:i + 1], sv)
                    and torch.equal(bi[i:i + 1], si)):
                raise AssertionError(f"[glove_c] ANN batch {prec} query {i}: "
                                     f"not its solo search bit for bit")
        out[prec] = {"queries": 8, "launches": launches}
    log(f"[glove_c] ANN batch of 8: every query its solo search bit for bit "
        f"at {sorted(out)}: {out}")
    return out


# --------------------------------------------------------------------------
# the hybrid BM25 + kNN program (ops/fused.hybrid_score_topk) at BASELINE.md
# row 4's width, and batched _msearch kNN through the stacked step
# --------------------------------------------------------------------------

HYBRID_DOCS = 1_000_000
HYBRID_TERMS, HYBRID_PER_TERM, HYBRID_Q_TERMS = 64, 2_000, 8
HYBRID_WINDOW, HYBRID_K, HYBRID_BATCH, HYBRID_BATCHES = 128, 10, 200, 4
HYBRID_SUB, HYBRID_SUB_QUERIES = 50_000, 100
HYBRID_LEX_W, HYBRID_VEC_W = 0.3, 1.0


def hybrid_inputs(rng, n: int, d: int = DIM) -> dict:
    """Row 4's segment (benchmarks/baseline_configs.py row4_hybrid): n
    standard-normal d-dim docs in the next power of two of slots, 64 terms
    of n / 500 postings (tf 1-4, docs uniform), doc lengths 5-79; one term
    set of 8 terms (window 128) for every query."""
    n_pad = 1 << (n - 1).bit_length()
    per_term = max(64, n // 500)
    vectors = np.zeros((n_pad, d), np.float32)
    vectors[:n] = rng.standard_normal((n, d), dtype=np.float32)
    p_pad = 1 << (HYBRID_TERMS * per_term - 1).bit_length()
    docs = rng.integers(0, n, HYBRID_TERMS * per_term).astype(np.int32)
    tfs = rng.integers(1, 5, HYBRID_TERMS * per_term).astype(np.float32)
    postings_docs = np.zeros(p_pad, np.int32)
    postings_tfs = np.zeros(p_pad, np.float32)
    postings_docs[:docs.size] = docs
    postings_tfs[:tfs.size] = tfs
    doc_len = np.zeros(n_pad, np.float32)
    doc_len[:n] = rng.integers(5, 80, n).astype(np.float32)
    term_ids = rng.integers(0, HYBRID_TERMS, HYBRID_Q_TERMS)
    return {"n": n, "n_pad": n_pad, "vectors": vectors,
            "postings_docs": postings_docs, "postings_tfs": postings_tfs,
            "doc_len": doc_len, "avgdl": float(doc_len[:n].mean()),
            "offsets": (term_ids * per_term).astype(np.int32),
            "lengths": np.full(HYBRID_Q_TERMS, min(HYBRID_WINDOW, per_term),
                               np.int32),
            "idfs": rng.uniform(0.5, 3.0, HYBRID_Q_TERMS).astype(np.float32)}


def hybrid_args(inp: dict, dev, queries) -> tuple:
    """hybrid_score_topk's arguments on the card for `inp`."""
    vectors = torch.from_numpy(inp["vectors"]).to(dev)
    return (torch.from_numpy(inp["postings_docs"]).to(dev),
            torch.from_numpy(inp["postings_tfs"]).to(dev),
            torch.from_numpy(inp["doc_len"]).to(dev), vectors,
            (vectors * vectors).sum(1),
            torch.arange(inp["n_pad"], device=dev) < inp["n"],
            torch.from_numpy(inp["offsets"]).to(dev),
            torch.from_numpy(inp["lengths"]).to(dev),
            torch.from_numpy(inp["idfs"]).to(dev),
            torch.tensor(inp["avgdl"], device=dev), queries,
            torch.tensor(HYBRID_LEX_W, device=dev),
            torch.tensor(HYBRID_VEC_W, device=dev))


def hybrid_host_reference(inp: dict, queries: np.ndarray, sub: int):
    """Row 4's fp64 host hybrid over the first `sub` docs: (scores [B, sub]
    f64, the f32 error bound of each score [B, sub]: the dot's f32
    summation bound and |q|^2 - 2 q.v + |v|^2's roundings through l2's
    derivative, and a few ulps of the BM25 sum and the blend)."""
    u = 2.0 ** -24
    sv = inp["vectors"][:sub].astype(np.float64)
    q = queries.astype(np.float64)
    d = sv.shape[1]
    dots = q @ sv.T
    qq, nn = (q ** 2).sum(-1, keepdims=True), (sv ** 2).sum(-1)[None, :]
    d_sq = np.maximum(qq - 2 * dots + nn, 0.0)
    vec = 1.0 / (1.0 + d_sq)
    slack = (d * u / (1 - d * u)) * (np.abs(q) @ np.abs(sv).T)
    vec_err = (2 * slack + 4 * u * (qq + 2 * np.abs(dots) + nn)) * vec ** 2 \
        + 4 * u * vec
    lex = np.zeros(sub)
    k1, b, avgdl = 1.2, 0.75, inp["avgdl"]
    pd, pt, dl = inp["postings_docs"], inp["postings_tfs"], inp["doc_len"]
    for t in range(HYBRID_Q_TERMS):
        lo = int(inp["offsets"][t])
        for p in range(lo, lo + int(inp["lengths"][t])):
            doc, tf = int(pd[p]), float(pt[p])
            if doc < sub:
                lex[doc] += float(inp["idfs"][t]) * tf / (
                    tf + k1 * (1 - b + b * float(dl[doc]) / avgdl))
    host = HYBRID_VEC_W * vec + HYBRID_LEX_W * lex[None, :]
    err = HYBRID_VEC_W * vec_err + HYBRID_LEX_W * (
        (HYBRID_Q_TERMS + 8) * u * lex[None, :]) + 4 * u * np.abs(host)
    return host, err


def hybrid_main_phase(dev, seed: int) -> dict:
    """The hybrid BM25 + exact-kNN program (ops/fused.jit_hybrid: the
    lexical gather and ordered segment sum, one fp32 [B, d] x [d, n]
    product, the l2 transform and blend, blockwise_topk) at BASELINE.md
    row 4's full width, all made from --seed: 1,000,000 128-d docs in 2^20
    slots, 64 terms x 2,000 postings (tf 1-4), doc lengths 5-79, 8 query
    terms, window 128, k = 10, lexical weight 0.3, vector weight 1.0, l2;
    4 batches of 200 queries. Gates: (1) on a 50,000-doc subsample and 100
    queries, as row 4 checks, the ids equal the fp64 host hybrid's but at
    pairs whose fp64 scores lie within the f32 error bound of each other
    (each logged); (2) a batch run twice gives the same bits; (3)
    graft_entry.entry() on the card matches the plain CPU run of the same
    function (rtol 1e-5 / atol 1e-6, ids equal where no two scores are
    that close: tests/test_torch_hybrid.py's tolerance). Reports the p50
    of a batch of 200 (CUDA events) and the QPS, the device split by
    stage and kernel name, the bound and the [B, n_pad] score matrix's
    bytes."""
    from opensearch_tpu_torch import graft_entry
    from opensearch_tpu_torch.ops import fused, topk

    rng = np.random.default_rng(seed + 60)
    t0 = time.perf_counter()
    inp = hybrid_inputs(rng, HYBRID_DOCS)
    queries = rng.standard_normal((HYBRID_BATCH * HYBRID_BATCHES, DIM),
                                  dtype=np.float32)
    qdev = torch.from_numpy(queries).to(dev)
    fn = fused.jit_hybrid(HYBRID_K, HYBRID_WINDOW, "l2_norm")
    args = hybrid_args(inp, dev, qdev[:HYBRID_BATCH])
    log(f"[hybrid] {HYBRID_DOCS} docs in {inp['n_pad']} slots, "
        f"{inp['postings_docs'].size} postings: made and uploaded in "
        f"{time.perf_counter() - t0:.1f} s")

    def batch(i: int):
        return fn(*args[:10], qdev[i * HYBRID_BATCH:(i + 1) * HYBRID_BATCH],
                  *args[11:])

    # (2) the same batch twice: the same bits
    v1, i1 = batch(0)
    v2, i2 = batch(0)
    torch.cuda.synchronize()
    if not (torch.equal(v1, v2) and torch.equal(i1, i2)):
        raise AssertionError("[hybrid] a batch run twice gave other bits")
    # timing: CUDA events around each batch of 200, three rounds of the
    # four batches after the warm-up above
    batch_ms = []
    for _round in range(3):
        for i in range(HYBRID_BATCHES):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            batch(i)
            end.record()
            torch.cuda.synchronize()
            batch_ms.append(start.elapsed_time(end))
    p50 = float(np.percentile(batch_ms, 50))
    whole = device_profile(lambda: batch(1), 5)
    lex_prof = device_profile(lambda: fused.lexical_scores(
        *args[:3], *args[6:10], n_pad=inp["n_pad"], window=HYBRID_WINDOW), 5)
    q200 = qdev[:HYBRID_BATCH]
    vt = args[3]
    prod_prof = device_profile(lambda: q200 @ vt.T, 5)
    vec_prof = device_profile(lambda: fused._vector_scores(
        q200, vt, args[4], "l2_norm"), 5)
    scores = fused._vector_scores(q200, vt, args[4], "l2_norm")
    topk_prof = device_profile(lambda: topk.blockwise_topk(scores, HYBRID_K),
                               5)
    del scores
    n_pad = inp["n_pad"]
    t_bytes = n_pad * DIM * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * HYBRID_BATCH * n_pad * DIM / FP32_FLOP_PER_S * 1e3
    out = {"batch_ms": batch_ms, "p50_batch_ms": p50,
           "qps": HYBRID_BATCH * len(batch_ms) / (sum(batch_ms) / 1e3),
           "device_ms": whole and whole["device_ms"],
           "device_kernels": whole and whole["top"],
           "lexical_device_ms": lex_prof and lex_prof["device_ms"],
           "lexical_kernels": lex_prof and lex_prof["top"],
           "product_device_ms": prod_prof and prod_prof["device_ms"],
           "vector_scores_device_ms": vec_prof and vec_prof["device_ms"],
           "transform_device_ms": (vec_prof and prod_prof and
                                   vec_prof["device_ms"]
                                   - prod_prof["device_ms"]),
           "topk_device_ms": topk_prof and topk_prof["device_ms"],
           "topk_kernels": topk_prof and topk_prof["top"],
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
           "score_matrix_bytes": HYBRID_BATCH * n_pad * 4}
    log(f"[hybrid] batch of {HYBRID_BATCH}: p50 {p50:.4f} ms, QPS "
        f"{out['qps']:.1f}; {json.dumps(out)}")
    del args, qdev
    torch.cuda.empty_cache()

    # (1) the subsample against the fp64 host hybrid
    sub = HYBRID_SUB
    sub_pad = 1 << (sub - 1).bit_length()
    sinp = dict(inp, n=sub, n_pad=sub_pad,
                vectors=np.pad(inp["vectors"][:sub],
                               ((0, sub_pad - sub), (0, 0))),
                doc_len=np.pad(inp["doc_len"][:sub], (0, sub_pad - sub)),
                postings_docs=np.where(inp["postings_docs"] < sub,
                                       inp["postings_docs"], 0),
                postings_tfs=np.where(inp["postings_docs"] < sub,
                                      inp["postings_tfs"], 0.0).astype(
                                          np.float32))
    q100 = queries[:HYBRID_SUB_QUERIES]
    gv, gi = fn(*hybrid_args(sinp, dev, torch.from_numpy(q100).to(dev)))
    gi = gi.cpu().numpy()
    host, err = hybrid_host_reference(inp, q100, sub)
    exact = np.stack([np.lexsort((np.arange(sub), -host[i]))[:HYBRID_K]
                      for i in range(len(q100))])
    ties = []
    for i in range(len(q100)):
        for j in np.nonzero(gi[i] != exact[i])[0]:
            a, c = int(gi[i, j]), int(exact[i, j])
            if abs(host[i, a] - host[i, c]) > err[i, a] + err[i, c]:
                raise AssertionError(
                    f"[hybrid] query {i} rank {j}: doc {a} (f64 "
                    f"{host[i, a]!r}) where the fp64 hybrid has {c} (f64 "
                    f"{host[i, c]!r}), further apart than f32 moves them")
            ties.append((i, int(j), a, c))
            log(f"[hybrid] query {i} rank {j}: doc {a} against the fp64 "
                f"host's {c}, f64 scores {host[i, a]!r} and {host[i, c]!r} "
                f"within their f32 bound")
    recall = float(np.mean([len(set(gi[i]) & set(exact[i])) / HYBRID_K
                            for i in range(len(q100))]))
    out.update(subsample_recall=recall, subsample_ties=len(ties))
    log(f"[hybrid] {sub}-doc subsample, {len(q100)} queries: ids the fp64 "
        f"host hybrid's but at {len(ties)} logged f32 ties; recall@10 "
        f"{recall:.4f}")

    # (3) graft_entry on the card against its plain CPU run
    efn, eargs = graft_entry.entry()
    if eargs[3].device.type != "cuda":
        raise AssertionError("graft_entry.entry() did not place its "
                             "arguments on the card")
    ev, ei = efn(*eargs)
    cfn, cargs = graft_entry.entry(device="cpu")
    cv, ci = cfn(*cargs)
    ev, ei = ev.cpu().numpy(), ei.cpu().numpy()
    cv, ci = cv.numpy(), ci.numpy()
    if not np.allclose(ev, cv, rtol=1e-5, atol=1e-6):
        raise AssertionError("[hybrid] graft_entry on the card: scores "
                             "beyond rtol 1e-5 / atol 1e-6 of the CPU run")
    tol = 1e-6 + 1e-5 * np.abs(cv)
    close = np.zeros_like(ev, bool)
    gap = np.abs(np.diff(cv, axis=1)) <= tol[:, 1:]
    close[:, 1:] |= gap
    close[:, :-1] |= gap
    if not np.array_equal(ei[~close], ci[~close]):
        raise AssertionError("[hybrid] graft_entry on the card: ids differ "
                             "from the CPU run")
    out["graft_entry_max_abs_err"] = float(np.abs(ev - cv).max())
    log(f"[hybrid] graft_entry.entry() on the card matches its CPU run "
        f"(max |dv| {out['graft_entry_max_abs_err']:.3g})")
    return out


MSEARCH_BODIES = 32


def msearch_main_phase(node, kf, queries: np.ndarray) -> dict:
    """Batched _msearch kNN on index A through TorchNode.msearch: one
    msearch of 32 bare knn bodies at fp32 k = 10, at fp32 k = 100 and at
    bf16 k = 10 (size = k). Gates: each batched hit list is its solo
    node.search's bit for bit (ids and scores); the run of 32 makes
    exactly one K1 launch, on the tier scan_tier names (the list scan, the
    wide tier, the tensor-core tier), and distributed_serving's
    batched_queries rises by 32. Then a mixed msearch of 8 bodies whose
    fourth carries a filter inside its knn clause: the run goes one body
    at a time (8 launches, none batched), each its solo search's bits.
    Reports the msearch p50 on the host clock (5 calls) beside 32 solo
    searches in a row, and the device ms of the B = 32 step beside 32
    B = 1 steps."""
    from opensearch_tpu_torch.search import ann, distributed_serving

    def hits(resp) -> list:
        return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]

    qs = queries[:MSEARCH_BODIES]
    out = {}
    try:
        for prec, k, tier in (("fp32", 10, "lists"), ("fp32", 100, "wide"),
                              ("bf16", 10, "mma")):
            ann.default_config.configure(score_precision=prec)
            r = min(kf.fused_pool_width(k, prec), 1 << 18)
            if kf.scan_tier(prec, r) != tier:
                raise AssertionError(f"msearch {prec} k={k}: tier "
                                     f"{kf.scan_tier(prec, r)}, want {tier}")
            counter = {"lists": kf.list_launches, "wide": kf.wide_launches,
                       "mma": kf.mma_launches}[tier]
            searches = [({"index": "sift_a"}, {"query": {"knn": {"v": {
                "vector": qv.tolist(), "k": k}}}, "size": k}) for qv in qs]
            kf.launches.reset()
            counter.reset()
            batched0 = distributed_serving.stats["batched_queries"]
            t0 = time.perf_counter()
            resp = node.msearch(searches)
            first_s = time.perf_counter() - t0
            got = (kf.launches.count, counter.count,
                   distributed_serving.stats["batched_queries"] - batched0)
            if got != (1, 1, MSEARCH_BODIES):
                raise AssertionError(f"[sift_a] msearch {prec} k={k}: (K1 "
                                     f"launches, on {tier}, batched queries)"
                                     f" = {got}, want (1, 1, 32)")
            solo_lat, solo = [], []
            for _h, body in searches:
                t0 = time.perf_counter()
                solo.append(hits(node.search("sift_a", body)))
                solo_lat.append(time.perf_counter() - t0)
            for i, (g, s) in enumerate(zip(resp["responses"], solo)):
                if hits(g) != s:
                    raise AssertionError(f"[sift_a] msearch {prec} k={k} "
                                         f"body {i}: not its solo search bit "
                                         f"for bit")
            lat = []
            for _ in range(5):
                t0 = time.perf_counter()
                node.msearch(searches)
                lat.append(time.perf_counter() - t0)
            slab = bundle_slab("sift_a")
            qt = torch.from_numpy(qs).to(slab[0].device)
            step32 = device_profile(functools.partial(
                kf.knn_fused_stacked, *slab, qt, k=k, similarity="l2_norm",
                score_precision=prec), 5)

            def solo_steps():
                for i in range(MSEARCH_BODIES):
                    kf.knn_fused_stacked(*slab, qt[i:i + 1], k=k,
                                         similarity="l2_norm",
                                         score_precision=prec)

            step1 = device_profile(solo_steps, 3)
            out[f"{prec} k={k}"] = {
                "launches": {"knn_fused": got[0], f"knn_fused_{tier}": got[1]},
                "batched_queries": got[2],
                "first_msearch_ms": first_s * 1e3,
                "msearch_p50_ms": float(np.percentile(lat, 50)) * 1e3,
                "solo_32_ms": sum(solo_lat) * 1e3,
                "solo_p50_ms": float(np.percentile(solo_lat, 50)) * 1e3,
                "step_b32_device_ms": step32 and step32["device_ms"],
                "steps_32x_b1_device_ms": step1 and step1["device_ms"]}
            log(f"[sift_a] msearch of 32 at {prec} k={k}: one K1 launch on "
                f"{tier}, every body its solo search bit for bit; "
                f"{json.dumps(out[f'{prec} k={k}'])}")
    finally:
        ann.default_config.configure(score_precision="fp32")
    # the mixed run: a filter in the fourth body keeps the run serial
    bodies = [{"query": {"knn": {"v": {"vector": qv.tolist(), "k": 10}}},
               "size": 10} for qv in qs[:8]]
    bodies[3] = {"query": {"knn": {"v": {
        "vector": qs[3].tolist(), "k": 10,
        "filter": {"range": {"age": {"gte": 20, "lte": 60}}}}}}, "size": 10}
    kf.launches.reset()
    batched0 = distributed_serving.stats["batched_queries"]
    resp = node.msearch([({"index": "sift_a"}, b) for b in bodies])
    got = (kf.launches.count,
           distributed_serving.stats["batched_queries"] - batched0)
    if got != (8, 0):
        raise AssertionError(f"[sift_a] mixed msearch: (K1 launches, batched "
                             f"queries) = {got}, want (8, 0)")
    for i, (g, body) in enumerate(zip(resp["responses"], bodies)):
        if hits(g) != hits(node.search("sift_a", body)):
            raise AssertionError(f"[sift_a] mixed msearch body {i}: not its "
                                 f"solo search")
    out["mixed"] = {"bodies": 8, "launches": got[0], "batched_queries": got[1]}
    log(f"[sift_a] mixed msearch (a filter in body 3): 8 launches, none "
        f"batched, every body its solo search")
    return out


# --------------------------------------------------------------------------
# the REST path: the port's HTTP server over the same node
# --------------------------------------------------------------------------

REST_FETCH_OPTIONS = (
    {"version": True}, {"seq_no_primary_term": True},
    {"docvalue_fields": ["age"]}, {"fields": ["c*"]},
    {"stored_fields": "_none_"}, {"_source": {"excludes": ["v"]}},
    {"explain": True}, {"min_score": 0.001})


class RestClient:
    """One keep-alive HTTP/1.1 connection to the port's server."""

    def __init__(self, port: int):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)

    def __call__(self, method: str, path: str, body=None, ndjson=None):
        headers = {"Content-Type": "application/json"}
        data = None
        if ndjson is not None:
            data = ("\n".join(json.dumps(x) for x in ndjson) + "\n").encode()
            headers["Content-Type"] = "application/x-ndjson"
        elif body is not None:
            data = json.dumps(body).encode()
        self.conn.request(method, path, body=data, headers=headers)
        resp = self.conn.getresponse()
        raw = resp.read()
        return resp.status, (json.loads(raw) if raw else None)

    def ok(self, method: str, path: str, body=None, ndjson=None,
           status: int | tuple = 200):
        got, payload = self(method, path, body, ndjson)
        want = status if isinstance(status, tuple) else (status,)
        if got not in want:
            raise AssertionError(f"{method} {path}: HTTP {got} (want "
                                 f"{want}): {json.dumps(payload)[:400]}")
        return payload

    def close(self) -> None:
        self.conn.close()


def json_view(resp: dict) -> dict:
    """A response as JSON gives it, `took` removed at every level."""
    def strip(obj):
        if isinstance(obj, dict):
            return {k: strip(v) for k, v in obj.items() if k != "took"}
        if isinstance(obj, list):
            return [strip(v) for v in obj]
        return obj

    return strip(json.loads(json.dumps(resp)))


def profile_shape(obj):
    """Keys, list lengths, strings and leaf types of a profile."""
    if isinstance(obj, dict):
        return {k: profile_shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [profile_shape(v) for v in obj]
    return obj if isinstance(obj, str) else type(obj).__name__


def rest_hits(resp) -> list:
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


def rest_main_phase(node, kf, queries: np.ndarray, data_b: np.ndarray,
                    per_shard: dict | None) -> dict:
    """The port's HTTP server (rest/http.HttpServer on 127.0.0.1:0, in a
    thread) over the node that holds cell A. Every check is against the
    same request made in process, in this run:

    1. writes: PUT /rest_b with cell B's mapping (4 shards), one NDJSON
       _bulk of its 20,000 128-d docs, _refresh, then PUT / GET / _update /
       DELETE of one doc, each version and seq_no as the engine must give
       them, and a stale if_seq_no a 409; 32 kNN searches on rest_b equal
       node.search's bit for bit;
    2. kNN _search on cell A: 64 queries at k = 10 and 16 at k = 100, each
       response's (_id, _score) list node.search's bits, and the K1
       launches (all, and on the list scan or the wide tier) of the HTTP
       run the in-process run's; p50 / p99 / QPS of both;
    3. the fetch options on 8 queries (version, seq_no_primary_term,
       docvalue_fields, fields with a wildcard, stored_fields _none_,
       _source excludes, explain, min_score): each response the in-process
       one field for field, `took` aside;
    4. an NDJSON _msearch of 32 bare kNN bodies: one K1 launch (32
       batched queries), each response the in-process msearch's bits;
    5. 8 HTTP clients x 8 searches over keep-alive connections, on the
       stacked step and on the per-shard route (K1 through the batcher),
       each hit list its solo search's bits; QPS and the batcher's mean
       merged batch beside concurrent_phase's in-process figures;
    6. "profile": true: the operator tree of the in-process profile's
       shape, the K1 launch's device_time_in_nanos > 0;
    7. a match query and GET /_cat/indices answer the 500 envelope with
       their "not yet ported" reason, and the next search on the same
       connection succeeds.
    Then DELETE /rest_b, whose stacked slabs must leave the registry. Also
    the in-process p50 at cell A with the profiler's hooks and without
    them (the decorated entry points swapped for the functions they
    wrap), in turns."""
    from opensearch_tpu_torch.cluster import shard_mesh
    from opensearch_tpu_torch.ops import adc_scan as ads
    from opensearch_tpu_torch.ops import knn as knn_ops
    from opensearch_tpu_torch.rest.http import HttpServer
    from opensearch_tpu_torch.search import distributed_serving

    t_phase = time.perf_counter()
    server = HttpServer(node, "127.0.0.1", 0)
    server.start_in_thread()
    client = RestClient(server.port)
    out = {"port": server.port}
    try:
        # 1. writes over HTTP
        mapping = {"properties": {"v": {"type": "knn_vector",
                                        "dimension": DIM,
                                        "similarity": "l2_norm"},
                                  "tag": {"type": "keyword"}}}
        client.ok("PUT", "/rest_b", {"settings": {"number_of_shards": 4},
                                     "mappings": mapping})
        lines = []
        for i in range(data_b.shape[0]):
            lines += [{"index": {"_index": "rest_b", "_id": str(i)}},
                      {"v": data_b[i].tolist(), "tag": f"t{i % 7}"}]
        t0 = time.perf_counter()
        bulk = client.ok("POST", "/_bulk", ndjson=lines)
        if bulk["errors"] or len(bulk["items"]) != data_b.shape[0]:
            raise AssertionError("REST _bulk into rest_b reported errors")
        client.ok("POST", "/rest_b/_refresh")
        out["bulk_refresh_s"] = time.perf_counter() - t0
        doc = {"v": data_b[0].tolist(), "tag": "new"}
        first = client.ok("PUT", "/rest_b/_doc/n1", doc, status=201)
        second = client.ok("PUT", "/rest_b/_doc/n1", doc)
        got = client.ok("GET", "/rest_b/_doc/n1")
        upd = client.ok("POST", "/rest_b/_update/n1",
                        {"doc": {"tag": "newer"}})
        noop = client.ok("POST", "/rest_b/_update/n1",
                         {"doc": {"tag": "newer"}})
        stale = client("PUT", f"/rest_b/_doc/n1?if_seq_no="
                       f"{first['_seq_no']}&if_primary_term=1", doc)
        deleted = client.ok("DELETE", "/rest_b/_doc/n1")
        gone = client("GET", "/rest_b/_doc/n1")
        versions = [first["_version"], second["_version"], got["_version"],
                    upd["_version"], noop["_version"], deleted["_version"]]
        if (versions != [1, 2, 2, 3, 3, 4]
                or first["result"] != "created"
                or second["result"] != "updated"
                or upd["result"] != "updated" or noop["result"] != "noop"
                or deleted["result"] != "deleted"
                or got["_seq_no"] != second["_seq_no"]
                or not first["_seq_no"] < second["_seq_no"] < upd["_seq_no"]
                < deleted["_seq_no"]
                or got["_source"] != doc or stale[0] != 409
                or gone[0] != 404 or gone[1]["found"] is not False):
            raise AssertionError(
                f"rest_b single-doc writes: versions {versions}, seq_nos "
                f"{[first['_seq_no'], second['_seq_no'], upd['_seq_no']]}, "
                f"stale CAS {stale[0]}, GET after delete {gone[0]}")
        qb = data_b[:32] + 0.05
        for i, qv in enumerate(qb):
            body = {"query": {"knn": {"v": {"vector": qv.tolist(), "k": 10}}},
                    "size": 10}
            http_hits = rest_hits(client.ok("POST", "/rest_b/_search", body))
            if http_hits != rest_hits(node.search("rest_b", body)):
                raise AssertionError(f"rest_b query {i}: HTTP hits are not "
                                     f"node.search's bits")
        out["writes"] = {"docs": data_b.shape[0], "shards": 4,
                         "versions": versions, "searches": 32}
        log(f"[rest_b] over HTTP: PUT, one _bulk of {data_b.shape[0]} docs "
            f"and _refresh in {out['bulk_refresh_s']:.1f} s; PUT / GET / "
            f"_update / DELETE versions {versions}; 32 kNN searches equal "
            f"node.search bit for bit")

        # 2. kNN _search over HTTP on cell A, beside the same in process
        def run(k: int, qs: np.ndarray, counter, over_http: bool) -> tuple:
            kf.launches.reset()
            counter.reset()
            lat, hits = [], []
            for qv in qs:
                body = {"query": {"knn": {"v": {"vector": qv.tolist(),
                                                "k": k}}}, "size": k}
                t0 = time.perf_counter()
                resp = (client.ok("POST", "/sift_a/_search", body)
                        if over_http else node.search("sift_a", body))
                lat.append(time.perf_counter() - t0)
                hits.append(rest_hits(resp))
            return hits, lat, (kf.launches.count, counter.count)

        knn = {}
        for k, n, counter, tier in ((10, 64, kf.list_launches, "lists"),
                                    (100, 16, kf.wide_launches, "wide")):
            solo_hits, solo_lat, solo_n = run(k, queries[:n], counter, False)
            http_hits, http_lat, http_n = run(k, queries[:n], counter, True)
            for i, (a, b) in enumerate(zip(http_hits, solo_hits)):
                if a != b:
                    raise AssertionError(f"[sift_a] HTTP k={k} query {i}: "
                                         f"not node.search's bits")
            if http_n != solo_n or solo_n != (n, n):
                raise AssertionError(
                    f"[sift_a] k={k}: (K1 launches, on {tier}) HTTP {http_n}"
                    f", in process {solo_n}, want ({n}, {n})")
            knn[f"k={k}"] = {
                "searches": n,
                "launches": {"knn_fused": http_n[0],
                             f"knn_fused_{tier}": http_n[1]},
                "http": latency_summary(http_lat),
                "in_process": latency_summary(solo_lat)}
            log(f"[sift_a] kNN _search over HTTP at k={k}: {n} responses "
                f"node.search's bits, K1 launches {http_n} as in process; "
                f"{json.dumps(knn[f'k={k}'])}")
        out["knn"] = knn

        # 3. the fetch options
        for i, extra in enumerate(REST_FETCH_OPTIONS):
            body = {"query": {"knn": {"v": {"vector": queries[i].tolist(),
                                            "k": 10}}}, "size": 10, **extra}
            got = json_view(client.ok("POST", "/sift_a/_search", body))
            want = json_view(node.search("sift_a", body))
            if got != want or not got["hits"]["hits"]:
                raise AssertionError(f"[sift_a] fetch option {extra}: the "
                                     f"HTTP response is not node.search's")
        out["fetch_options"] = [sorted(e)[0] for e in REST_FETCH_OPTIONS]
        log(f"[sift_a] fetch options over HTTP equal in process field for "
            f"field: {out['fetch_options']}")

        # 4. _msearch of 32 bare kNN bodies
        bodies = [{"query": {"knn": {"v": {"vector": qv.tolist(), "k": 10}}},
                   "size": 10} for qv in queries[:MSEARCH_BODIES]]
        nd = [x for b in bodies for x in ({"index": "sift_a"}, b)]
        kf.launches.reset()
        batched0 = distributed_serving.stats["batched_queries"]
        t0 = time.perf_counter()
        got = client.ok("POST", "/_msearch", ndjson=nd)
        msearch_ms = (time.perf_counter() - t0) * 1e3
        got_n = (kf.launches.count,
                 distributed_serving.stats["batched_queries"] - batched0)
        want = node.msearch([({"index": "sift_a"}, b) for b in bodies])
        if got_n != (1, MSEARCH_BODIES):
            raise AssertionError(f"[sift_a] HTTP _msearch: (K1 launches, "
                                 f"batched queries) = {got_n}, want (1, 32)")
        for i, (g, w) in enumerate(zip(got["responses"],
                                       want["responses"])):
            if g["status"] != 200 or rest_hits(g) != rest_hits(w):
                raise AssertionError(f"[sift_a] HTTP _msearch body {i}: not "
                                     f"the in-process msearch's bits")
        searches = [({"index": "sift_a"}, b) for b in bodies]
        lat = {"http": [], "in_process": []}
        for _ in range(5):
            t0 = time.perf_counter()
            client.ok("POST", "/_msearch", ndjson=nd)
            lat["http"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            node.msearch(searches)
            lat["in_process"].append(time.perf_counter() - t0)
        out["msearch"] = {
            "bodies": MSEARCH_BODIES, "launches": got_n[0],
            "batched_queries": got_n[1], "first_http_ms": msearch_ms,
            **{f"{key}_p50_ms": float(np.percentile(v, 50)) * 1e3
               for key, v in lat.items()}}
        log(f"[sift_a] HTTP _msearch of 32: one K1 launch, every body the "
            f"in-process msearch's bits; {json.dumps(out['msearch'])}")

        # 5. 8 HTTP clients x 8 searches over keep-alive connections
        def clients(route: str) -> dict:
            qs = queries[:64]
            body = [{"query": {"knn": {"v": {"vector": qv.tolist(),
                                             "k": 10}}}, "size": 10}
                    for qv in qs]
            solo = [rest_hits(node.search("sift_a", b)) for b in body]
            got, lat = [None] * len(qs), [0.0] * len(qs)
            node.knn_batcher.reset()

            def worker(t: int) -> None:
                c = RestClient(server.port)
                try:
                    for i in range(t, len(qs), 8):
                        t0 = time.perf_counter()
                        got[i] = rest_hits(c.ok("POST", "/sift_a/_search",
                                                body[i]))
                        lat[i] = time.perf_counter() - t0
                finally:
                    c.close()

            t0 = time.perf_counter()
            with ThreadPoolExecutor(8) as pool:
                for f in [pool.submit(worker, t) for t in range(8)]:
                    f.result()
            wall = time.perf_counter() - t0
            for i, (g, s) in enumerate(zip(got, solo)):
                concurrent_check(f"sift_a HTTP {route}", i, g, s)
            stats = node.knn_batcher.snapshot_stats()
            return {**latency_summary(lat, wall),
                    "dispatches": stats["dispatches"],
                    "mean_merged_batch": stats["mean_merged_batch"]}

        conc = {"stacked": clients("stacked")}
        distributed_serving.enabled = False
        try:
            conc["per_shard"] = clients("per_shard")
        finally:
            distributed_serving.enabled = True
        if per_shard is not None:
            c = per_shard["concurrent"]
            conc["in_process_per_shard"] = {
                **c["concurrent"], "mean_merged_batch": c["mean_merged_batch"]}
        out["concurrent"] = conc
        log(f"[sift_a] 8 HTTP clients x 8 searches, each its solo search's "
            f"bits: {json.dumps(conc)}")

        # 6. "profile": true
        body = {"query": {"knn": {"v": {"vector": queries[0].tolist(),
                                        "k": 10}}}, "size": 10,
                "profile": True}
        got = client.ok("POST", "/sift_a/_search", body)["profile"]
        want = node.search("sift_a", body)["profile"]
        if profile_shape(got) != profile_shape(want):
            raise AssertionError("[sift_a] the HTTP profile's shape is not "
                                 "the in-process profile's")
        (shard,) = got["shards"]
        (op,) = shard["searches"][0]["query"]
        device_ns = op["device_time_in_nanos"]
        if device_ns <= 0 or op["kernels"][0]["name"] != "shard_mesh_knn":
            raise AssertionError(f"[sift_a] profile: K1 launch "
                                 f"device_time_in_nanos {device_ns}")
        out["profile"] = {"device_time_in_nanos": device_ns,
                          "kernels": op["kernels"],
                          "fetch": shard["fetch"]["time_in_nanos"]}
        log(f"[sift_a] profile over HTTP has the in-process shape; the K1 "
            f"launch: device_time_in_nanos {device_ns}")

        # 7. not yet ported, then the same connection serves a search
        envelopes = {}
        for method, path, req in (
                ("POST", "/sift_a/_search", {"query": {"match": {
                    "color": "red"}}}),
                ("GET", "/_cat/indices", None)):
            status, payload = client(method, path, req)
            reason = (payload or {}).get("error", {}).get("reason", "")
            if status != 500 or payload.get("status") != 500 or \
                    "is not yet ported to opensearch_tpu_torch" not in reason:
                raise AssertionError(f"{method} {path}: HTTP {status} "
                                     f"{payload}")
            envelopes[f"{method} {path}"] = reason
            after = client.ok("POST", "/sift_a/_search", {"query": {"knn": {
                "v": {"vector": queries[1].tolist(), "k": 10}}}})
            if not after["hits"]["hits"]:
                raise AssertionError("no search after a 500")
        out["not_yet_ported"] = envelopes
        log(f"not yet ported over HTTP: {envelopes}; the connection serves "
            f"the next search")

        client.ok("DELETE", "/rest_b")
        if any(key[0] == "rest_b"
               for key in shard_mesh.default_registry._bundles):
            raise AssertionError("DELETE /rest_b left its serving slabs")
    finally:
        client.close()
        server.stop_thread()

    # the profiler's hooks on the unprofiled path: in-process p50 at cell
    # A with the decorated entry points and with the functions they wrap,
    # in turns (hooked, bare, bare, hooked)
    hooked = [(kf, "knn_fused_stacked"), (kf, "knn_fused_auto"),
              (knn_ops, "raw_similarity"), (knn_ops, "exact_knn_scores"),
              (ads, "adc_topr_auto")]
    originals = {(id(m), name): getattr(m, name) for m, name in hooked}

    def p50(bare: bool) -> float:
        for m, name in hooked:
            fn = originals[(id(m), name)]
            setattr(m, name, fn.__wrapped__ if bare else fn)
        try:
            lat = []
            for qv in queries[:64]:
                body = {"query": {"knn": {"v": {"vector": qv.tolist(),
                                                "k": 10}}}, "size": 10}
                t0 = time.perf_counter()
                node.search("sift_a", body)
                lat.append(time.perf_counter() - t0)
            return float(np.percentile(np.asarray(lat) * 1e3, 50))
        finally:
            for m, name in hooked:
                setattr(m, name, originals[(id(m), name)])

    turns = [("hooked", p50(False)), ("bare", p50(True)),
             ("bare", p50(True)), ("hooked", p50(False))]
    out["hooks_p50_ms"] = {
        "hooked": [v for key, v in turns if key == "hooked"],
        "bare": [v for key, v in turns if key == "bare"]}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[sift_a] in-process p50 with the profiler's hooks and without, in "
        f"turns: {json.dumps(out['hooks_p50_ms'])}; REST phase "
        f"{out['phase_s']:.1f} s")
    return out


def rest_phase(kf, dev, seed: int) -> dict:
    """Index A alone, built as main_path_phase builds it, one search to
    build its serving bundle, then rest_main_phase with cell B's corpus
    (``--phases rest``)."""
    from opensearch_tpu_torch.node import TorchNode

    rng = np.random.default_rng(seed + 2)
    data = clustered(rng, 200_000, DIM)
    data_b = clustered(rng, 20_000, DIM)
    attrs = attributes(rng, 200_000)
    queries = (data[rng.choice(200_000, 64, replace=False)]
               + 0.05 * rng.standard_normal((64, DIM)).astype(np.float32))
    with tempfile.TemporaryDirectory() as tmp:
        node = TorchNode(tmp, device="cuda")
        t0 = time.perf_counter()
        _bulk_index(node, "sift_a", data, 1, attrs)
        log(f"[sift_a] 200000 docs with age, color, taste: bulk + refresh "
            f"{time.perf_counter() - t0:.1f} s")
        node.search("sift_a", {"query": {"knn": {"v": {
            "vector": queries[0].tolist(), "k": 10}}}})
        out = rest_main_phase(node, kf, queries, data_b, None)
        node.close()
    return out


# --------------------------------------------------------------------------
# the fixed-order rescore and |q|^2 (csrc/knn_rescore.cu)
# --------------------------------------------------------------------------

RESCORE_KERNELS = ("knn_rescore_kernel", "knn_query_sq_kernel")


def einsum_rescore(kf, queries, vectors, norms_sq, valid, cand, k: int,
                   similarity: str):
    """The rescore the port ran before its kernel: a gather and one batched
    torch.einsum (cuBLAS, which picks its summation order by the batch),
    the transform, the mask and a stable top-k. Kept here only as the
    yardstick the kernel's time stands beside."""
    cand = cand.long()
    safe = torch.clamp(cand, min=0)
    shard = torch.arange(vectors.shape[0], device=vectors.device)[:, None, None]
    dots = torch.einsum("bd,sbrd->sbr", queries, vectors[shard, safe])
    qsq = (queries * queries).sum(dim=1)[None, :, None]
    scores = kf._transform_scores(dots, qsq, norms_sq[shard, safe], similarity)
    scores = torch.where((cand >= 0) & valid[shard, safe], scores,
                         float("-inf"))
    return kf.stable_topk(scores, k)


def rescore_check(kr, v, nrm, ok, q, cand, sim: str, what: str,
                  bits: bool) -> int:
    """The rescore kernel and the |q|^2 kernel against their plain versions
    on the same operands: |q|^2 bit-equal; the scores bit-equal on data
    whose dots are exact (`bits`), and on float data either bit-equal or,
    where not, each differing slot logged with its f64 score and both
    within 1e-6 relative of it (the f32 bound of a d-term sum at these
    magnitudes); a batch's rows bit-equal to each query's solo call (the
    batcher's contract), one rescore launch a call. Returns the slots
    that differ from plain."""
    from opensearch_tpu_torch.ops.knn_fused import _transform_scores

    before = kr.launches.count
    qsq = kr.query_sq(q)
    got = kr.rescore(q, qsq, v, nrm, ok, cand, similarity=sim)
    torch.cuda.synchronize()
    if kr.launches.count - before != 1:
        raise AssertionError(f"{what}: the rescore launched "
                             f"{kr.launches.count - before} times")
    if not torch.equal(qsq, kr.plain_query_sq(q)):
        raise AssertionError(f"{what}: |q|^2 not bit-equal to plain")
    want = kr.plain_rescore(q, kr.plain_query_sq(q), v, nrm, ok, cand,
                            similarity=sim)
    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        raise AssertionError(f"{what}: -inf slots differ from plain")
    diff = (got != want) & torch.isfinite(want)
    if bits and bool(diff.any()):
        raise AssertionError(f"{what}: not bit-equal on exact dots at "
                             f"{diff.nonzero()[:5].tolist()}")
    for s, b, j in diff.nonzero().tolist():
        c = int(cand[s, b, j])
        exact = float(_transform_scores(
            (v[s, c].double() * q[b].double()).sum(), qsq[b].double(),
            nrm[s, c].double(), sim))
        a, p = float(got[s, b, j]), float(want[s, b, j])
        log(f"{what}: slot {(s, b, j)} doc {c}: kernel {a!r}, plain {p!r}, "
            f"f64 {exact!r}")
        if max(abs(a - exact), abs(p - exact)) > 1e-6 * abs(exact) + 1e-7:
            raise AssertionError(f"{what}: slot {(s, b, j)} beyond the f32 "
                                 f"bound")
    for i in range(q.shape[0]):
        solo_sq = kr.query_sq(q[i:i + 1])
        solo = kr.rescore(q[i:i + 1], solo_sq, v, nrm, ok,
                          cand[:, i:i + 1].contiguous(), similarity=sim)
        if not (torch.equal(solo_sq[0], qsq[i])
                and torch.equal(solo[:, 0], got[:, i])):
            raise AssertionError(f"{what}: query {i} alone differs from its "
                                 f"row of the batch")
    return int(diff.sum())


def rescore_kernel_phase(kr, dev, seed: int) -> int:
    """The rescore kernel (knn_rescore_kernel) and |q|^2
    (knn_query_sq_kernel) on the card (rescore_check): sixteenths (every dot
    exact in f32) and clustered floats; one shard of 200,000 docs at d = 128
    and four of 20,000 at d = 100 (cosine) and 768; B = 1, 8 and 33; R = 40,
    64, 400 and 512 candidates a (shard, query), a tenth of them -1 and 3%
    of the docs dead. Returns the float slots that differ from plain."""
    rng = np.random.default_rng(seed + 50)
    differ = 0
    for s, n, d, sim in ((1, 200_000, DIM, "l2_norm"),
                         (4, 20_000, 100, "cosine"),
                         (4, 20_000, 768, "l2_norm")):
        for bits in (True, False):
            raw = rng.standard_normal((s, n, d)).astype(np.float32)
            data = np.round(raw * 16) / 16 if bits else raw
            v = torch.from_numpy(data.astype(np.float32)).to(dev)
            nrm = (v.double() ** 2).sum(2).float()
            ok = torch.from_numpy(rng.random((s, n)) >= 0.03).to(dev)
            for b in (1, 8, 33):
                q = v[0, torch.from_numpy(rng.choice(n, b)).to(dev)].clone()
                if not bits:
                    q += 0.01 * torch.randn_like(q)
                for r in (40, 64, 400, 512):
                    cand = rng.integers(0, n, (s, b, r)).astype(np.int32)
                    cand[rng.random((s, b, r)) < 0.1] = -1
                    differ += rescore_check(
                        kr, v, nrm, ok, q, torch.from_numpy(cand).to(dev),
                        sim, f"rescore S={s} n={n} d={d} {sim} B={b} R={r} "
                        f"exact={bits}", bits)
            del v
            torch.cuda.empty_cache()
    log(f"rescore and |q|^2 parity: bit-equal on exact dots, {differ} float "
        f"slots differ from plain (each logged), every batch row its solo "
        f"call's bits")
    return differ


def rescore_timing(kf, kr, dev, seed: int) -> dict:
    """The rescore kernel at cell A's serving shapes (one shard of 200,000
    128-d docs in 262,144 slots, l2): B = 1 with R = 40 and 400 (the
    stacked step at bf16 and int8, k = 10 and 100) and B = 8 with R = 64
    and 512 (the per-shard route's merged batches, k_bucket 16 and 128);
    candidates from a bf16 pool. CUDA-event ms and device ms of the kernel
    (with its |q|^2 launch: the rescore as the step runs it), of the plain
    version and of the einsum rescore it replaced (einsum_rescore), beside
    the bound: each candidate's row, norm and flag read once, the ids
    read, the scores written. No single PyTorch call computes it (library
    null). Then |q|^2 alone at B = 1, 8 and 64: its ms, the plain
    version's and one torch.einsum("bd,bd->b") call's."""
    rng = np.random.default_rng(seed + 51)
    n, slots = 200_000, 262_144
    data = np.zeros((1, slots, DIM), np.float32)
    data[0, :n] = clustered(rng, n, DIM)
    v = torch.from_numpy(data).to(dev)
    nrm = (v.double() ** 2).sum(2).float()
    ok = torch.zeros((1, slots), dtype=torch.bool, device=dev)
    ok[0, :n] = True
    out = {}
    for b, r, k in ((1, 40, 10), (1, 400, 100), (8, 64, 16), (8, 512, 128)):
        q = v[0, torch.from_numpy(rng.choice(n, b)).to(dev)] + 0.01
        args = reduced_args(kf, v, nrm, ok, q, "bf16")
        _pv, cand = kf.pool_scan(*args, r=r, similarity="l2_norm",
                                 score_precision="bf16")
        label = f"rescore B={b} R={r}"
        rescore_check(kr, v, nrm, ok, q, cand, "l2_norm", label, False)

        def kernel():
            return kr.rescore(q, kr.query_sq(q), v, nrm, ok, cand,
                              similarity="l2_norm")

        def plain():
            return kr.plain_rescore(q, kr.plain_query_sq(q), v, nrm, ok,
                                    cand, similarity="l2_norm")

        def einsum():
            return einsum_rescore(kf, q, v, nrm, ok, cand, k, "l2_norm")

        nbytes = b * r * (DIM * 4 + 4 + 1 + 4 + 4) + b * (DIM * 4 + 4)
        prof = device_profile(kernel, 10)
        eprof = device_profile(einsum, 10)
        out[label] = {
            "ms": time_ms(kernel, 50), "plain_ms": time_ms(plain, 5),
            "einsum_ms": time_ms(einsum, 50), "library_ms": None,
            "device_ms": prof and prof["device_ms"],
            "rescore_device_ms": kernel_ms(prof, RESCORE_KERNELS[0]),
            "query_sq_device_ms": kernel_ms(prof, RESCORE_KERNELS[1]),
            "einsum_device_ms": eprof and eprof["device_ms"],
            "einsum_kernels": eprof and eprof["top"],
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}
        log(f"{label}: {json.dumps(out[label])}")
    for b in (1, 8, 64):
        q = torch.randn((b, DIM), device=dev)
        nbytes = b * (DIM * 4 + 4)
        prof = device_profile(lambda: kr.query_sq(q), 10)
        out[f"query_sq B={b}"] = {
            "ms": time_ms(lambda: kr.query_sq(q), 50),
            "plain_ms": time_ms(lambda: kr.plain_query_sq(q), 10),
            "library_ms": time_ms(lambda: torch.einsum("bd,bd->b", q, q), 50),
            "device_ms": prof and prof["device_ms"],
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}
        log(f"query_sq B={b}: {json.dumps(out[f'query_sq B={b}'])}")
    del v
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# K3, K4, K5: the exact-scan family
# --------------------------------------------------------------------------

FAMILY = ("knn_block", "knn_pb", "knn_sbmax")
FAMILY_ENTRY = {"knn_block": "knn_topk_auto", "knn_pb": "knn_blocktopk_auto",
                "knn_sbmax": "knn_sbmax_auto"}
# the profiler's kernel names of the two-kernel entry points' stages (K3 at
# k = 10: the list scan and its split merge)
STAGE_KERNELS = {"knn_block": ("knn_pool_scan_kernel", "knn_pool_merge_kernel"),
                 "knn_pb": ("knn_pb_kernel", "knn_pb_merge_kernel"),
                 "knn_sbmax": ("sbmax_stage1", "sbmax_stage2")}


def sixteenths(rng, n: int, d: int) -> np.ndarray:
    """Clustered vectors whose coordinates are multiples of 1/16 below 4 in
    magnitude: every product and every partial sum of a dot is exact in
    f32, so a dot comes out to the same bits in any summation order and
    the kernels must agree with their plain versions bit for bit, ties
    (there are many) included."""
    x = np.round(clustered(rng, n, d) * 4.0) / 16.0
    return np.clip(x, -63 / 16, 63 / 16).astype(np.float32)


def sift_like(rng, n: int, d: int) -> np.ndarray:
    """SIFT-style descriptors: clustered integer coordinates in [0, 255].
    Dots stay below 2^24, so f32 holds them exactly in any order."""
    centers = rng.integers(0, 120, (64, d)).astype(np.float32)
    out = np.empty((n, d), np.float32)
    for lo in range(0, n, 200_000):
        hi = min(lo + 200_000, n)
        out[lo:hi] = centers[rng.integers(0, 64, hi - lo)] + \
            rng.normal(0.0, 12.0, (hi - lo, d)).astype(np.float32)
    return np.clip(np.round(out), 0, 255).astype(np.float32)


def family_stage1(kb, name: str, args, k: int, sim: str, exact: bool):
    """(kernel, plain) stage-1 outputs of one family kernel on the same
    padded operands."""
    if name == "knn_block":
        return (kb.block_topk(*args, k=k, similarity=sim),
                kb.plain_block_topk(*args, k=k, similarity=sim))
    if name == "knn_pb":
        return (kb.pb_topk(*args, k=k, similarity=sim, exact=exact),
                kb.plain_pb_topk(*args, k=k, similarity=sim, exact=exact))
    return ((kb.sbmax(*args, similarity=sim, exact=exact),),
            (kb.plain_sbmax(*args, similarity=sim, exact=exact),))


def family_plain(kb, name: str, v, nrm, ok, q, k: int, sim: str = "l2_norm",
                 exact: bool = True):
    """The whole entry point with the plain stage 1, on the card."""
    if name == "knn_block":
        qp = kb._pad_queries(q, None)
        return kb.plain_block_topk(v, nrm, ok, qp, k=k, similarity=sim)
    qp = kb._pad_queries(q, kb.PB_QTILE)
    if name == "knn_pb":
        return kb.pb_merge(*kb.plain_pb_topk(v, nrm, ok, qp, k=k,
                                             similarity=sim, exact=exact), k)
    return kb.sbmax_rescore(kb.plain_sbmax(v, nrm, ok, qp, similarity=sim,
                                           exact=exact),
                            v, nrm, ok, qp, k=k, similarity=sim, exact=exact)


def compare_stage1(kb, name, args, k, sim, exact, what: str) -> float:
    """Kernel vs plain stage 1, bit for bit: ids (K4: on finite slots) and
    scores. Returns max |dv| over the finite slots."""
    got, want = family_stage1(kb, name, args, k, sim, exact)
    torch.cuda.synchronize()
    if not torch.equal(got[0], want[0]):
        bad = (got[0] != want[0]).nonzero()[:5].tolist()
        raise AssertionError(f"{what}: scores differ at {bad}")
    fin = torch.isfinite(want[0])
    if len(got) > 1 and not torch.equal(got[1][fin], want[1][fin]):
        raise AssertionError(f"{what}: ids differ on finite slots")
    return float((got[0][fin] - want[0][fin]).abs().max()) \
        if bool(fin.any()) else 0.0


def blocks_kernel_phase(kb, dev, seed: int) -> float:
    """K3 against its plain version on the card: n = 50,000 (a ragged tail
    past the 1024-doc block), d = 128, 3% dead docs, a duplicate of doc
    2040 planted at 2053 (across the block boundary), B = 1, 5, 16, 40
    and 129 (two of the list scan's 128-query tiles, seventeen of the wide
    tier's 8-query tiles), k = 10 and 32 (the list scan) and 100 (the wide
    tier, and the tile scan beside it, the yardstick it is timed against),
    l2, cosine and dot. The data are sixteenths:
    the pools must match bit for bit, the whole entry point too, and the
    lower id must win the planted tie. Returns the max |dv| against the
    plain version."""
    rng = np.random.default_rng(seed + 20)
    n, d = 50_000, DIM
    data = sixteenths(rng, n, d)
    data[2053] = data[2040]
    valid = np.ones(n, bool)
    valid[rng.choice(n, int(0.03 * n), replace=False)] = False
    valid[[2040, 2053]] = True
    ok = torch.from_numpy(valid).to(dev)
    v = torch.from_numpy(data).to(dev)
    nrm = torch.from_numpy((data.astype(np.float64) ** 2).sum(1).astype(
        np.float32)).to(dev)
    err = 0.0
    for b in (1, 5, 16, 40, 129):
        queries = data[rng.choice(n, b, replace=False)].copy()
        queries[0] = data[2040]
        q = torch.from_numpy(queries).to(dev)
        for k in (10, 32, 100):
            for sim in SIMS:
                args = (v, nrm, ok, kb._pad_queries(q, None))
                what = f"knn_block {sim} B={b} k={k}"
                before = (kb.block_list_launches.count,
                          kb.block_wide_launches.count)
                err = max(err, compare_stage1(kb, "knn_block", args, k, sim,
                                              True, what))
                got = (kb.block_list_launches.count - before[0],
                       kb.block_wide_launches.count - before[1])
                if got != ((1, 0) if k <= kb.LIST_MAX_R else (0, 1)):
                    raise AssertionError(f"{what}: (list scan, wide tier) "
                                         f"launches {got}")
                if k > kb.LIST_MAX_R:
                    # K3's tile scan, the yardstick of the wide tier
                    tv, ti = kb._launch_block_tile(*args, k=k, similarity=sim)
                    pv, pi = kb.plain_block_topk(*args, k=k, similarity=sim)
                    if not (torch.equal(ti, pi) and torch.equal(tv, pv)):
                        raise AssertionError(f"{what}: K3's tile scan differs "
                                             f"from plain_block_topk")
                gv, gi = kb.knn_topk_auto(v, nrm, ok, q, k=k, similarity=sim)
                pv, pi = family_plain(kb, "knn_block", v, nrm, ok, q, k, sim)
                if not (torch.equal(gi, pi[:b]) and torch.equal(gv, pv[:b])):
                    raise AssertionError(f"{what}: entry point differs from "
                                         f"its plain pipeline")
                if sim == "l2_norm" and gi[0, :2].tolist() != [2040, 2053]:
                    raise AssertionError(
                        f"{what}: planted tie gave {gi[0, :2].tolist()}")
        log(f"knn_block parity B={b}: bit-equal over k = 10, 32 (list "
            f"scan), 100 (wide tier, and the tile scan) and l2, cosine, dot")
    return err


def unaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x whose data starts 4 bytes past a 16-byte
    boundary: a view the cp.async kernels cannot read as it is."""
    off = 4 // x.element_size()
    flat = torch.empty(x.numel() + off, dtype=x.dtype, device=x.device)
    out = flat[off:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 == 4 and out.is_contiguous()
    return out


PB_COPIES = (2040, 2053)                   # a duplicate across a block edge
PB_RUN = tuple(range(6150, 6162))          # 12 equal vectors in block 3


def pb_case(kb, dev, rng, n: int, d: int, exact: bool):
    """K4's parity operands: n sixteenths of width d, 3% dead docs, the
    duplicate PB_COPIES and the run PB_RUN planted; exact=False adds 2^-14
    to every nonzero coordinate (equal on the planted copies), which the
    bf16 rounding of the operands must remove."""
    data = sixteenths(rng, n, d)
    data[list(PB_COPIES)] = data[PB_COPIES[0]]
    data[list(PB_RUN)] = data[PB_RUN[0]]
    valid = np.ones(n, bool)
    valid[rng.choice(n, int(0.03 * n), replace=False)] = False
    valid[[*PB_COPIES, *PB_RUN]] = True
    if not exact:
        jitter = np.where(data != 0, np.where(rng.random((n, d)) < 0.5, 1, -1)
                          * 2.0 ** -14, 0).astype(np.float32)
        jitter[list(PB_COPIES)] = jitter[PB_COPIES[0]]
        jitter[list(PB_RUN)] = jitter[PB_RUN[0]]
        data = data + jitter
    v = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
    nrm = torch.from_numpy((data.astype(np.float64) ** 2).sum(1).astype(
        np.float32)).to(dev)
    return data, v, nrm, torch.from_numpy(valid).to(dev)


def pb_check(kb, v, nrm, ok, q, k: int, sim: str, exact: bool,
             what: str) -> float:
    """K4 on one case: stage 1 bit-equal to plain_pb_topk (ids on finite
    slots), the merge kernel on plain_pb_topk's pools bit-equal to pb_merge,
    and the entry point to the plain pipeline. Returns max |dv|."""
    b = q.shape[0]
    qp = kb._pad_queries(q, kb.PB_QTILE)
    err = compare_stage1(kb, "knn_pb", (v, nrm, ok, qp), k, sim, exact,
                         f"{what} stage 1")
    pools = kb.plain_pb_topk(v, nrm, ok, qp, k=k, similarity=sim,
                             exact=exact)
    got, want = kb.pb_select(*pools, k), kb.pb_merge(*pools, k)
    torch.cuda.synchronize()
    if not all(torch.equal(a, w) for a, w in zip(got, want)):
        raise AssertionError(f"{what}: the merge kernel differs from pb_merge")
    gv, gi = kb.knn_blocktopk_auto(v, nrm, ok, q, k=k, similarity=sim,
                                   exact=exact)
    pv, pi = kb.pb_merge(*pools, k)
    if not (torch.equal(gi, pi[:b]) and torch.equal(gv, pv[:b])):
        raise AssertionError(f"{what}: entry point differs from its plain "
                             f"pipeline")
    if sim != "dot_product":
        if gi[0, :2].tolist() != list(PB_COPIES):
            raise AssertionError(f"{what}: planted tie gave "
                                 f"{gi[0, :2].tolist()}")
        if b > 1 and gi[1, :min(k, 10)].tolist() != list(PB_RUN[:min(k, 10)]):
            raise AssertionError(f"{what}: planted run gave "
                                 f"{gi[1, :10].tolist()}")
    return err


def pb_kernel_phase(kb, dev, seed: int) -> float:
    """K4's two kernels against their plain versions on the card (pb_check
    on each case): n = 50,000 sixteenths (a ragged tail past the 2048-doc
    block), 3% dead docs, a duplicate across a block edge (PB_COPIES) and a
    run of 12 equal vectors inside one block (PB_RUN), queried by the first
    two queries, so k = 10 cuts through the run. At d = 128: B = 1, 5, 8,
    9, 16, 32, 33, 40, 128 and 129 (each query tile 8, 32 and 128, full
    and partial, and two 128-query tiles) x k = 10, 32 (PB_LIST_K, the
    last of the list tier), 33, 100 and 2048 (PB_MAX_K) x l2, cosine, dot x
    exact and not. At d = 30 (padded to 32 by rows_in_16_bytes) and d = 768
    (chunked d, the query tile stepped down): B = 1, 33 and 129 x k = 10
    and 2048 x the three similarities x exact and not. Then operands 4
    bytes off a 16-byte boundary (copied by rows_in_16_bytes). Last n =
    300,000 (147 blocks, more than the CTAs of a query tile, so some CTAs
    walk two blocks): B = 9, 33 and 129 x k = 10 and 32. Returns the max
    |dv|."""
    rng = np.random.default_rng(seed + 23)
    err = 0.0
    widths = ((50_000, DIM, (1, 5, 8, 9, 16, 32, 33, 40, 128, 129),
               (10, 32, 33, 100, 2048)),
              (50_000, 30, (1, 33, 129), (10, 2048)),
              (50_000, 768, (1, 33, 129), (10, 2048)),
              (300_000, DIM, (9, 33, 129), (10, 32)))
    for n, d, bs, ks in widths:
        for exact in (True, False):
            data, v, nrm, ok = pb_case(kb, dev, rng, n, d, exact)
            for b in bs:
                queries = data[rng.choice(n, b, replace=False)].copy()
                queries[0] = data[PB_COPIES[0]]
                if b > 1:
                    queries[1] = data[PB_RUN[0]]
                q = torch.from_numpy(queries).to(dev)
                for k in ks:
                    for sim in SIMS:
                        err = max(err, pb_check(
                            kb, v, nrm, ok, q, k, sim, exact,
                            f"knn_pb d={d} {sim} B={b} k={k} exact={exact}"))
            log(f"K4 parity n={n} d={d} exact={exact}: both kernels and the "
                f"entry point bit-equal at B = {bs}, k = {ks}, l2, cosine, "
                f"dot")
            if n == 50_000 and d == DIM and exact:
                for sim in SIMS:
                    err = max(err, pb_check(
                        kb, unaligned(v), nrm, ok, unaligned(q[:9]), 10, sim,
                        True, f"knn_pb unaligned {sim}"))
                log("K4 parity, operands off a 16-byte boundary: bit-equal")
            del v
            torch.cuda.empty_cache()
    return err


SBMAX_COPIES = (2040, 2053, *range(6041, 50_000, 4001))  # 13 blocks
SBMAX_DEAD = range(4096, 4224)                          # one whole sub-block


def sbmax_kernel_phase(kb, dev, seed: int) -> float:
    """K5's two kernels against their plain versions on the card: n =
    50,000 sixteenths (as blocks_kernel_phase), 3% dead docs plus the
    all-dead sub-block SBMAX_DEAD, one vector planted at the 13 docs
    SBMAX_COPIES (one sub-block in each of 13 blocks, so the queries that
    are that vector see 13 equal maxima and k = 10 cuts through them),
    B = 1, 5, 8,
    9, 16, 32, 33, 40, 128 and 129 (each query tile 8, 32 and 128, full and
    partial, and two 128-query tiles), k = 10, 100 and n_sub = 400 (every
    sub-block, the dead one and those past n included), l2, cosine and dot,
    exact and not. Stage 1 must equal plain_sbmax bit for bit, stage 2
    sbmax_rescore on the same maxima, and the entry point the plain
    pipeline; for the planted query (l2 and cosine) the 10 lowest copies
    come first, in id order. exact=False runs on the data plus 2^-14 (the
    copies keep equal jitter), which the bf16 rounding must remove. Then
    d = 30 (padded to 32 by rows_in_16_bytes) and operands 4 bytes off a
    16-byte boundary, both stages at B = 9, k = 10. Returns the max |dv| of
    stage 1 and the entry point against the plain ones."""
    rng = np.random.default_rng(seed + 22)
    n, d = 50_000, DIM
    base = sixteenths(rng, n, d)
    base[list(SBMAX_COPIES)] = base[SBMAX_COPIES[0]]
    valid = np.ones(n, bool)
    valid[rng.choice(n, int(0.03 * n), replace=False)] = False
    valid[list(SBMAX_DEAD)] = False
    valid[list(SBMAX_COPIES)] = True
    jitter = np.where(base != 0, np.where(rng.random((n, d)) < 0.5, 1, -1)
                      * 2.0 ** -14, 0).astype(np.float32)
    jitter[list(SBMAX_COPIES)] = jitter[SBMAX_COPIES[0]]
    ok = torch.from_numpy(valid).to(dev)
    n_sub = -(-n // kb.PB_BLOCK) * (kb.PB_BLOCK // kb.SUB)
    err = 0.0
    for exact, data in ((True, base), (False, base + jitter)):
        v = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
        nrm = torch.from_numpy((data.astype(np.float64) ** 2).sum(1).astype(
            np.float32)).to(dev)
        for b in (1, 5, 8, 9, 16, 32, 33, 40, 128, 129):
            queries = data[rng.choice(n, b, replace=False)].copy()
            queries[0] = data[SBMAX_COPIES[0]]
            q = torch.from_numpy(queries).to(dev)
            qp = kb._pad_queries(q, kb.PB_QTILE)
            for sim in SIMS:
                what = f"knn_sbmax {sim} B={b} exact={exact}"
                err = max(err, compare_stage1(kb, "knn_sbmax", (v, nrm, ok, qp),
                                              0, sim, exact, what))
                submax = kb.plain_sbmax(v, nrm, ok, qp, similarity=sim,
                                        exact=exact)
                for k in (10, 100, n_sub):
                    what = f"knn_sbmax {sim} B={b} k={k} exact={exact}"
                    got = kb.sbmax_select(submax, v, nrm, ok, qp, k=k,
                                          similarity=sim, exact=exact)
                    want = kb.sbmax_rescore(submax, v, nrm, ok, qp, k=k,
                                            similarity=sim, exact=exact)
                    torch.cuda.synchronize()
                    if not (torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1])):
                        raise AssertionError(f"{what}: stage 2 differs from "
                                             f"sbmax_rescore")
                    gv, gi = kb.knn_sbmax_auto(v, nrm, ok, q, k=k,
                                               similarity=sim, exact=exact)
                    pv, pi = family_plain(kb, "knn_sbmax", v, nrm, ok, q, k,
                                          sim, exact)
                    if not (torch.equal(gi, pi[:b]) and torch.equal(gv, pv[:b])):
                        raise AssertionError(f"{what}: entry point differs "
                                             f"from its plain pipeline")
                    fin = torch.isfinite(pv[:b])
                    if bool(fin.any()):
                        err = max(err, float((gv[fin] - pv[:b][fin]).abs().max()))
                    if sim != "dot_product" and \
                            gi[0, :10].tolist() != list(SBMAX_COPIES[:10]):
                        raise AssertionError(
                            f"{what}: planted ties gave {gi[0, :10].tolist()}")
            del submax
        # stage 2 with the maxima read from device memory and its k arrays
        # in the scratch, the layout of a row too long for shared memory
        limit, kb.SBMAX_SELECT_SMEM = kb.SBMAX_SELECT_SMEM, 0
        try:
            for k in (10, n_sub):
                submax = kb.plain_sbmax(v, nrm, ok, qp, similarity="l2_norm",
                                        exact=exact)
                got = kb.sbmax_select(submax, v, nrm, ok, qp, k=k,
                                      exact=exact)
                want = kb.sbmax_rescore(submax, v, nrm, ok, qp, k=k,
                                        similarity="l2_norm", exact=exact)
                torch.cuda.synchronize()
                if not all(torch.equal(a, w) for a, w in zip(got, want)):
                    raise AssertionError(f"knn_sbmax stage 2, maxima in device "
                                         f"memory, k={k} exact={exact}: differs "
                                         f"from sbmax_rescore")
        finally:
            kb.SBMAX_SELECT_SMEM = limit
        log(f"K5 parity exact={exact}: both stages and the entry point "
            f"bit-equal at B = 1..129, k = 10, 100, {n_sub}, l2, cosine, dot "
            f"(stage 2 in both shared-memory layouts)")
        del v
        torch.cuda.empty_cache()
    # rows that are not whole 16-byte units (d = 30, padded to 32 by
    # rows_in_16_bytes) and operands 4 bytes off a 16-byte boundary (copied)
    data30 = sixteenths(rng, n, 30)
    cases = (("d=30", torch.from_numpy(data30).to(dev),
              torch.from_numpy(data30[:9].copy()).to(dev)),
             ("unaligned", unaligned(torch.from_numpy(base).to(dev)),
              unaligned(torch.from_numpy(base[:9].copy()).to(dev))))
    for label, v, q in cases:
        nrm = (v.double() ** 2).sum(1).float()
        qp = kb._pad_queries(q, kb.PB_QTILE)
        for exact in (True, False):
            for sim in SIMS:
                what = f"knn_sbmax {label} {sim} exact={exact}"
                err = max(err, compare_stage1(kb, "knn_sbmax", (v, nrm, ok, qp),
                                              0, sim, exact, what))
                submax = kb.plain_sbmax(v, nrm, ok, qp, similarity=sim,
                                        exact=exact)
                got = kb.sbmax_select(submax, v, nrm, ok, qp, k=10,
                                      similarity=sim, exact=exact)
                want = kb.sbmax_rescore(submax, v, nrm, ok, qp, k=10,
                                        similarity=sim, exact=exact)
                torch.cuda.synchronize()
                if not all(torch.equal(a, w) for a, w in zip(got, want)):
                    raise AssertionError(f"{what}: stage 2 differs from "
                                         f"sbmax_rescore")
        log(f"K5 parity {label}: both stages bit-equal (B = 9, k = 10)")
    return err


def blocks_bound(name: str, n: int, d: int, b: int, k: int, nb: int) -> dict:
    """The least time of one call: the slab, norms and valid flags read
    once, the queries, and what the kernel writes (K3 [B, k], K4 [nb, B, k]
    values and ids, K5 [nb, B, 16] maxima), over 3.35 TB/s; against
    2*B*n*d operations over 67 TFLOP/s."""
    out = {"knn_block": 8 * b * k, "knn_pb": 8 * nb * b * k,
           "knn_sbmax": 4 * nb * b * 16}[name]
    nbytes = n * d * 4 + n * 4 + n + b * d * 4 + out
    flops = 2 * b * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def blocks_timing_phase(kb, dev, seed: int, names) -> dict:
    """K3, K4 and K5 (those of `names`) through their entry points at the
    SIFT-1M shape (1,000,000 SIFT-style 128-d f32 docs, l2, k = 10) at
    B = 1 and 32, and
    B = 128 for K4 and K5 (their design tile). First the path run: the
    launch counts are set to 0, each entry point answers once per B, and
    each answer must be the brute-force top-10 in order, scores bit for bit
    (the plain scores and a stable top-10: the data make every dot exact).
    Then, at each of these B, each kernel's stage 1 (K3's pools, K4's
    per-block pools over all 489 blocks, K5's maxima) and K5's stage 2 on
    the plain maxima, and K4's merge kernel on the plain pools, must equal
    their own plain versions bit for bit. Then the CUDA-event time of each
    call, its device time under torch.profiler, the plain pipeline's time,
    the library yardstick (torch.topk over the l2-transformed q @ v.T) and
    the bound. K4 and K5 launch two kernels a call (stage 1 and stage 2,
    each counted), and each stage's device ms is read from the profiler by
    kernel name (STAGE_KERNELS)."""
    rng = np.random.default_rng(seed + 21)
    n, k = SIFT_DOCS, 10
    v = torch.from_numpy(sift_like(rng, n, DIM)).to(dev)
    nrm = (v.double() ** 2).sum(1).float()
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    q_all = torch.clamp(torch.round(
        v[torch.from_numpy(rng.choice(n, 128, replace=False)).to(dev)]
        + torch.from_numpy(rng.normal(0, 4, (128, DIM)).astype(np.float32))
        .to(dev)), 0, 255)
    sizes = {name: bs for name, bs in (("knn_block", (1, 32, 128)),
                                       ("knn_pb", (1, 32, 128)),
                                       ("knn_sbmax", (1, 32, 128)))
             if name in names}
    second = {"knn_pb": kb.pb_merge_launches,
              "knn_sbmax": kb.sbmax_select_launches}
    for counter in (kb.block_launches, kb.block_list_launches,
                    kb.pb_launches, kb.sbmax_launches, *second.values()):
        counter.reset()
    for name, bs in sizes.items():
        for b in bs:
            q = q_all[:b].contiguous()
            tv, ti = getattr(kb, FAMILY_ENTRY[name])(v, nrm, ok, q, k=k)
            bv, bi = kb.plain_block_topk(v, nrm, ok, q, k=k,
                                         similarity="l2_norm")
            if not (torch.equal(ti, bi) and torch.equal(tv, bv)):
                raise AssertionError(f"{name} B={b}: not the brute-force "
                                     f"top-10 in order")
    launches = {"knn_block": kb.block_launches.count,
                "knn_pb": kb.pb_launches.count,
                "knn_sbmax": kb.sbmax_launches.count}
    stage2_launches = {name: c.count for name, c in second.items()}
    if "knn_block" in sizes and \
            kb.block_list_launches.count != launches["knn_block"]:
        raise AssertionError(f"K3 at k = {k}: {kb.block_list_launches.count} "
                             f"of {launches['knn_block']} launches took the "
                             f"list scan")
    for name, bs in sizes.items():
        if launches[name] != len(bs):
            raise AssertionError(f"{name}: {launches[name]} launches in "
                                 f"{len(bs)} calls")
        if name in second and stage2_launches[name] != len(bs):
            raise AssertionError(f"{name} stage 2: {stage2_launches[name]} "
                                 f"launches in {len(bs)} calls")
    log(f"K3/K4/K5 at the SIFT-1M shape: brute-force top-10 in order; "
        f"launches {launches}")
    out = {name: {"launches": launches[name], "stage1_err": 0.0}
           for name in sizes}
    for name in second.keys() & out.keys():
        out[name]["stage2_launches"] = stage2_launches[name]
    for name, bs in sizes.items():
        qtile = None if name == "knn_block" else kb.PB_QTILE
        for b in bs:
            args = (v, nrm, ok, kb._pad_queries(q_all[:b].contiguous(), qtile))
            out[name]["stage1_err"] = max(out[name]["stage1_err"],
                                          compare_stage1(
                kb, name, args, k, "l2_norm", True,
                f"{name} SIFT-1M shape B={b} stage 1"))
            if name == "knn_sbmax":
                submax = kb.plain_sbmax(*args, similarity="l2_norm")
                got = kb.sbmax_select(submax, *args, k=k)
                want = kb.sbmax_rescore(submax, *args, k=k,
                                        similarity="l2_norm")
                torch.cuda.synchronize()
                if not all(torch.equal(a, w) for a, w in zip(got, want)):
                    raise AssertionError(f"knn_sbmax SIFT-1M shape B={b}: "
                                         f"stage 2 differs from sbmax_rescore")
            if name == "knn_pb":
                pools = kb.plain_pb_topk(*args, k=k, similarity="l2_norm")
                got, want = kb.pb_select(*pools, k), kb.pb_merge(*pools, k)
                torch.cuda.synchronize()
                if not all(torch.equal(a, w) for a, w in zip(got, want)):
                    raise AssertionError(f"knn_pb SIFT-1M shape B={b}: the "
                                         f"merge kernel differs from pb_merge")
    log("K3/K4/K5 at the SIFT-1M shape: stage 1 (and K4's and K5's stage 2) "
        "bit-equal to the plain versions at every B")
    nb = -(-n // kb.PB_BLOCK)
    for name, bs in sizes.items():
        entry = getattr(kb, FAMILY_ENTRY[name])
        for b in bs:
            q = q_all[:b].contiguous()
            clock0 = mem_clock()
            ms = time_ms(lambda: entry(v, nrm, ok, q, k=k), 10)
            plain_ms = time_ms(lambda: family_plain(kb, name, v, nrm, ok, q, k),
                               3)
            qsq = (q * q).sum(1)

            def library():
                d_sq = torch.clamp(qsq[:, None] - 2.0 * (q @ v.T) + nrm[None],
                                   min=0.0)
                return torch.topk(1.0 / (1.0 + d_sq), k)

            library_ms = time_ms(library, 10)
            prof = device_profile(lambda: entry(v, nrm, ok, q, k=k), 5)
            bound = blocks_bound(name, n, DIM, b, k, nb)
            out[name][b] = {"ms": ms, "plain_ms": plain_ms,
                            "library_ms": library_ms,
                            "device_ms": prof and prof["device_ms"], **bound}
            if name == "knn_block":
                # the tile scan on the same call, for the two designs side
                # by side
                qp = kb._pad_queries(q, None)
                tv, ti = kb._launch_block_tile(v, nrm, ok, qp, k=k,
                                               similarity="l2_norm")
                pv, pi = kb.plain_block_topk(v, nrm, ok, qp, k=k,
                                             similarity="l2_norm")
                if not (torch.equal(ti, pi) and torch.equal(tv, pv)):
                    raise AssertionError(f"knn_block SIFT-1M shape B={b}: "
                                         f"the tile scan differs from "
                                         f"plain_block_topk")
                tile = time_ms(lambda: kb._launch_block_tile(
                    v, nrm, ok, qp, k=k, similarity="l2_norm"), 10)
                out[name][b]["tile_ms"] = tile
                log(f"knn_block SIFT-1M shape B={b}: tile scan {tile:.4f} "
                    f"ms")
            out[name][b]["mem_clock"] = [clock0, mem_clock()]
            if name in STAGE_KERNELS:
                for key, part in zip(("stage1_device_ms", "stage2_device_ms"),
                                     STAGE_KERNELS[name]):
                    out[name][b][key] = kernel_ms(prof, part)
                log(f"{name} SIFT-1M shape B={b}: stage 1 device "
                    f"{out[name][b]['stage1_device_ms']} ms, stage 2 device "
                    f"{out[name][b]['stage2_device_ms']} ms")
            log(f"{name} SIFT-1M shape B={b}: {ms:.4f} ms (device "
                f"{out[name][b]['device_ms']}), plain {plain_ms:.4f} ms, "
                f"library {library_ms:.4f} ms, bound {bound['bound_ms']:.4f} "
                f"ms ({bound['bound_by']}); top kernels "
                f"{prof and prof['top']}")
    del v
    torch.cuda.empty_cache()
    return out


# the attribute columns of the filtering specs of the k-NN plugin's
# perf-tool (faiss-hnsw/filtering relaxed-filter and restrictive-filter on
# SIFT-128): age integer 0-99, color one of 6 keywords, taste one of 4
COLORS = ("red", "green", "blue", "yellow", "white", "black")
TASTES = ("sweet", "salty", "sour", "bitter")


def attributes(rng, n: int) -> dict:
    """Each doc's age, color and taste indices, uniform, from the seed."""
    return {"age": rng.integers(0, 100, n), "color": rng.integers(0, 6, n),
            "taste": rng.integers(0, 4, n)}


def attribute_mapping() -> dict:
    return {"age": {"type": "integer"}, "color": {"type": "keyword"},
            "taste": {"type": "keyword"}}


def attribute_doc(attrs: dict, i: int) -> dict:
    return {"age": int(attrs["age"][i]),
            "color": COLORS[int(attrs["color"][i])],
            "taste": TASTES[int(attrs["taste"][i])]}


def _bulk_index(node, name: str, data: np.ndarray, shards: int,
                attrs: dict | None = None) -> None:
    props = {"v": {"type": "knn_vector", "dimension": data.shape[1],
                   "similarity": "l2_norm"}}
    if attrs is not None:
        props.update(attribute_mapping())
    node.create_index(name, {
        "settings": {"number_of_shards": shards},
        "mappings": {"properties": props},
    })
    for s in range(0, data.shape[0], 5000):
        resp = node.bulk([
            ("index", {"_index": name, "_id": str(i)},
             {"v": data[i].tolist(),
              **(attribute_doc(attrs, i) if attrs is not None else {})})
            for i in range(s, min(s + 5000, data.shape[0]))
        ], refresh=False)
        if resp["errors"]:
            raise AssertionError(f"bulk into [{name}] reported errors")
    node.refresh(name)


def main_path_phase(kf, dev, seed: int) -> dict:
    from opensearch_tpu_torch.node import TorchNode
    from opensearch_tpu_torch.ops import knn_rescore as kr
    from opensearch_tpu_torch.search import distributed_serving

    rng = np.random.default_rng(seed + 2)
    corpora = {"sift_a": (clustered(rng, 200_000, DIM), 1),
               "sift_b": (clustered(rng, 20_000, DIM), 4)}
    # cell A carries the filtering specs' attribute columns
    attrs_a = attributes(rng, 200_000)
    out = {}
    step_inputs = {}
    truths = {}
    ingest_s = {}
    with tempfile.TemporaryDirectory() as tmp:
        node = TorchNode(tmp, device="cuda")
        for name, (data, shards) in corpora.items():
            t0 = time.perf_counter()
            _bulk_index(node, name, data, shards,
                        attrs_a if name == "sift_a" else None)
            ingest_s[name] = time.perf_counter() - t0
            log(f"[{name}] {data.shape[0]} docs, {shards} shard(s)"
                f"{' with age, color, taste' if name == 'sift_a' else ''}: "
                f"bulk + refresh {ingest_s[name]:.1f} s")
        # the counts are read for the searches alone
        searches0 = distributed_serving.stats["distributed_searches"]
        kf.launches.reset()
        kf.list_launches.reset()
        kr.sq_launches.reset()
        for name, (data, _shards) in corpora.items():
            queries = (data[rng.choice(data.shape[0], 64, replace=False)]
                       + 0.05 * rng.standard_normal((64, DIM)).astype(np.float32))
            lat = []
            hits = []
            for qv in queries:
                t0 = time.perf_counter()
                resp = node.search(name, {"query": {"knn": {"v": {
                    "vector": qv.tolist(), "k": 10}}}, "size": 10})
                lat.append(time.perf_counter() - t0)
                hits.append([h["_id"] for h in resp["hits"]["hits"]])
            out[name] = lat
            # brute-force truth: the plain version on the card, docs in id order
            v = torch.from_numpy(data)[None].to(dev)
            nrm = torch.from_numpy((data.astype(np.float64) ** 2).sum(1).astype(
                np.float32))[None].to(dev)
            ok = torch.ones((1, data.shape[0]), dtype=torch.bool, device=dev)
            q = torch.from_numpy(queries).to(dev)
            step_inputs[name] = (v, nrm, ok, q[:1])
            _tv, ti = kf.plain_pool(v, nrm, ok, q, kr.plain_query_sq(q),
                                    torch.ones(1, device=dev), r=10,
                                    similarity="l2_norm",
                                    score_precision="fp32")
            truth = [[str(int(i)) for i in row] for row in ti[0].cpu()]
            truths[name] = (queries, truth)
            if hits != truth:
                bad = next(i for i, (h, t) in enumerate(zip(hits, truth)) if h != t)
                raise AssertionError(
                    f"[{name}] query {bad}: hits {hits[bad]} != truth {truth[bad]}")
            lat_ms = np.asarray(lat) * 1e3
            log(f"[{name}] 64 searches: recall@10 = 1.0 (same order), p50 "
                f"{np.percentile(lat_ms, 50):.3f} ms, p99 "
                f"{np.percentile(lat_ms, 99):.3f} ms, QPS {64 / sum(lat):.1f}")
        launches = kf.launches.count
        list_launches = kf.list_launches.count
        sq_launches = kr.sq_launches.count
        searches = distributed_serving.stats["distributed_searches"] - searches0
        per_shard = per_shard_exact_phase(node, kf, *truths["sift_a"])
        wide = wide_main_phase(node, kf, corpora["sift_a"][0],
                               truths["sift_a"][0], step_inputs["sift_a"])
        reduced = reduced_main_phase(node, kf, truths["sift_a"][0],
                                     step_inputs["sift_a"])
        batched = stacked_batch_phase(node, kf, truths["sift_a"][0])
        msearch = msearch_main_phase(node, kf, truths["sift_a"][0])
        rest = rest_main_phase(node, kf, truths["sift_a"][0],
                               corpora["sift_b"][0], per_shard)
        filtered = filtered_main_phase(node, kf, attrs_a,
                                       truths["sift_a"][0],
                                       step_inputs["sift_a"], rng)
        large = large_main_phase(node, kf, corpora["sift_a"][0],
                                 truths["sift_a"][0], step_inputs["sift_a"],
                                 rng)
        node.close()
    # the device step of one search alone (operand prep, scan, top-k), at
    # each index's shape, beside the whole search's latency above: CUDA-event
    # ms over a window of 20 steps (the window of the earlier records) and
    # of 200 (host-bound at these sizes, so the window moves the reading),
    # and the profiler's device ms of the step's kernels, with the tile
    # scan's on the same operands beside the list scan's
    step_ms, step_device = {}, {}
    for name, (v, nrm, ok, q) in step_inputs.items():
        def step():
            return kf.knn_fused_stacked(v, nrm, ok, q, k=10,
                                        similarity="l2_norm")

        args, r = scan_inputs(kf, v, nrm, ok, q, 10, "fp32")
        step_ms[name] = {"window_20": time_ms(step, 20),
                         "window_200": time_ms(step, 200)}
        prof = device_profile(step, 10)
        tile_prof = device_profile(lambda: kf._launch_tile(
            *args, r=r, similarity="l2_norm", score_precision="fp32"), 10)
        step_device[name] = {
            "device_ms": prof and prof["device_ms"],
            "scan_device_ms": kernel_ms(prof, LIST_KERNELS[0]),
            "merge_device_ms": kernel_ms(prof, LIST_KERNELS[1]),
            "tile_scan_device_ms": tile_prof and tile_prof["device_ms"]}
        log(f"[{name}] device step of one search (B=1, n={v.shape[1]}): "
            f"{step_ms[name]} ms; profiler {step_device[name]}")
    if searches != 128:
        raise AssertionError(f"{searches} of 128 searches took the serving path")
    if launches < 128:
        raise AssertionError(f"the kernel launched {launches} times in 128 searches")
    if list_launches != launches:
        raise AssertionError(f"{list_launches} of {launches} K1 launches of "
                             f"the stacked step took the list scan")
    if sq_launches != launches:
        raise AssertionError(f"|q|^2 launched {sq_launches} times in "
                             f"{launches} K1 launches")
    log(f"main path: {searches} served searches, {launches} kernel launches, "
        f"all {list_launches} on K1's list scan (knn_pool.cuh), "
        f"{sq_launches} |q|^2 launches")
    rest["step_device_ms"] = step_device["sift_a"]["device_ms"]
    log(f"[sift_a] the HTTP profile's K1 launch: device_time_in_nanos "
        f"{rest['profile']['device_time_in_nanos']} (the fenced launch, its "
        f"copy to the host included) beside the profiler's device ms of "
        f"the step: {rest['step_device_ms']}")
    return {"launches": launches, "list_launches": list_launches,
            "query_sq_launches": sq_launches, "ingest_s": ingest_s,
            "latency_s": out, "step_ms": step_ms,
            "step_device": step_device, "per_shard": per_shard,
            "wide": wide, "reduced": reduced, "batched": batched,
            "msearch": msearch, "rest": rest, "filtered": filtered,
            "large": large}


def filtered_phase(kf, dev, seed: int) -> dict:
    """Index A alone, built as main_path_phase builds it (200,000 clustered
    128-d docs with the age, color and taste columns), one unfiltered
    search to build its serving bundle, then stacked_batch_phase,
    msearch_main_phase, filtered_main_phase and large_main_phase: the
    quick loop for filtered kNN, msearch and the stacked step past
    r = 1024 (``--phases filtered``)."""
    from opensearch_tpu_torch.node import TorchNode

    rng = np.random.default_rng(seed + 2)
    data = clustered(rng, 200_000, DIM)
    attrs = attributes(rng, 200_000)
    queries = (data[rng.choice(200_000, 64, replace=False)]
               + 0.05 * rng.standard_normal((64, DIM)).astype(np.float32))
    v = torch.from_numpy(data)[None].to(dev)
    nrm = (v.double() ** 2).sum(2).float()
    ok = torch.ones((1, 200_000), dtype=torch.bool, device=dev)
    step_input = (v, nrm, ok, torch.from_numpy(queries[:1]).to(dev))
    with tempfile.TemporaryDirectory() as tmp:
        node = TorchNode(tmp, device="cuda")
        t0 = time.perf_counter()
        _bulk_index(node, "sift_a", data, 1, attrs)
        log(f"[sift_a] 200000 docs with age, color, taste: bulk + refresh "
            f"{time.perf_counter() - t0:.1f} s")
        node.search("sift_a", {"query": {"knn": {"v": {
            "vector": queries[0].tolist(), "k": 10}}}})
        out = {"batched": stacked_batch_phase(node, kf, queries),
               "msearch": msearch_main_phase(node, kf, queries),
               "filtered": filtered_main_phase(node, kf, attrs, queries,
                                               step_input, rng),
               "large": large_main_phase(node, kf, data, queries, step_input,
                                         rng)}
        node.close()
    return out


def wide_main_phase(node, kf, data: np.ndarray, queries: np.ndarray,
                    step_input: tuple) -> dict:
    """Index A at k = 100 on both serving routes, K1 on its wide tier:
    64 searches through the stacked step (k = 100, size = 100: r = 100,
    B = 1), then on the per-shard route (distributed_serving.enabled off)
    32 searches at k = 100 (k_bucket 128: r = 128) and 8 threads x 8
    searches through the batcher (concurrent_phase, gated and
    free-running, size = 100). Every hit list must equal the brute-force
    top-100 in order, summed in the kernel's order (kernel_order_pool:
    plain_pool's cuBLAS order ranks some neighbours the other way at this
    depth, each such slot logged with its f64 scores), the concurrent ones
    their solo ones, and every K1
    launch of these searches must be on the wide tier: the counts are set
    to 0 just before each path and read just after. Logs p50, p99 and QPS,
    and the step's device ms by kernel name beside the tile scan's on the
    same operands (its pools first held to kernel_order_pool, tile_check)."""
    from opensearch_tpu_torch.ops import knn_rescore as kr
    from opensearch_tpu_torch.search import distributed_serving, executor

    k = 100
    v, nrm, ok, _q = step_input
    q = torch.from_numpy(queries).to(v.device)
    # |q|^2 as the serving step computes it: the fixed-order plain version
    # (the kernel's bits, with no launch outside the searches)
    qsq = kr.plain_query_sq(q)
    tv, ti = kernel_order_pool(kf, v, nrm, ok, q, qsq, k, "l2_norm")
    truth = [[str(int(i)) for i in row] for row in ti[0].cpu()]
    # where cuBLAS's summation order (plain_pool) ranks neighbours the
    # other way: logged with both docs' f64 scores, not gated
    _pv, pi = kf.plain_pool(v, nrm, ok, q, qsq, torch.ones(1, device=v.device),
                            r=k, similarity="l2_norm", score_precision="fp32")
    gaps = []
    for s, b, j in (ti != pi).nonzero().tolist():
        a, c = exact_scores(kf, v, nrm, q, qsq, "l2_norm", s, b,
                            [int(ti[s, b, j]), int(pi[s, b, j])])
        gaps.append(abs(a - c) / max(abs(a), abs(c)))
    log(f"[sift_a] k={k}: the kernel-order top-{k} differs from plain_pool's "
        f"at {len(gaps)} of {ti.numel()} slots, f64 relative gaps up to "
        f"{max(gaps, default=0.0):.3g}")
    del data, tv

    def run(n: int, what: str) -> dict:
        lat = []
        for i, qv in enumerate(queries[:n]):
            t0 = time.perf_counter()
            resp = node.search("sift_a", {"query": {"knn": {"v": {
                "vector": qv.tolist(), "k": k}}}, "size": k})
            lat.append(time.perf_counter() - t0)
            hits = [h["_id"] for h in resp["hits"]["hits"]]
            if hits != truth[i]:
                raise AssertionError(f"[sift_a] {what} k={k} query {i}: "
                                     f"hits differ from the brute-force "
                                     f"top-{k}")
        return latency_summary(lat)

    def counts() -> dict:
        return {"knn_fused": kf.launches.count,
                "knn_fused_wide": kf.wide_launches.count}

    out = {}
    searches0 = distributed_serving.stats["distributed_searches"]
    kf.launches.reset()
    kf.wide_launches.reset()
    out["stacked"] = run(64, "stacked")
    out["stacked"]["launches"] = counts()
    served = distributed_serving.stats["distributed_searches"] - searches0
    if served != 64 or out["stacked"]["launches"]["knn_fused"] < 64:
        raise AssertionError(f"[sift_a] k={k}: {served} of 64 searches on "
                             f"the stacked step, launches "
                             f"{out['stacked']['launches']}")
    distributed_serving.enabled = False
    try:
        fused0 = executor.knn_path_stats["fused"]
        kf.launches.reset()
        kf.wide_launches.reset()
        out["per_shard"] = run(32, "per-shard")
        out["per_shard"]["launches"] = counts()
        if executor.knn_path_stats["fused"] - fused0 != 32:
            raise AssertionError(f"[sift_a] per-shard k={k}: not every "
                                 f"search took the fused kernel")
        out["concurrent"] = concurrent_phase(
            node, "sift_a", queries, k,
            {"knn_fused": kf.launches, "knn_fused_wide": kf.wide_launches},
            size=k)
    finally:
        distributed_serving.enabled = True
    for what, run_counts in (
            ("stacked", out["stacked"]["launches"]),
            ("per-shard", out["per_shard"]["launches"]),
            ("concurrent gated", out["concurrent"]["gated"]["launches"]),
            ("concurrent", out["concurrent"]["launches"])):
        if run_counts["knn_fused_wide"] != run_counts["knn_fused"]:
            raise AssertionError(f"[sift_a] {what} k={k}: K1 launches not "
                                 f"all on the wide tier: {run_counts}")
    # the stacked step at k = 100 on the device, by kernel name
    qs = q[:1]
    args, r = scan_inputs(kf, v, nrm, ok, qs, k, "fp32")
    tile_check(kf, args, r, f"[sift_a] step k={k}")
    step = functools.partial(kf.knn_fused_stacked, v, nrm, ok, qs, k=k,
                             similarity="l2_norm")
    prof = device_profile(step, 10)
    tile_prof = device_profile(functools.partial(
        kf._launch_tile, *args, r=r, similarity="l2_norm",
        score_precision="fp32"), 10)
    out["step_ms"] = {"window_20": time_ms(step, 20),
                      "window_200": time_ms(step, 200)}
    out["step_device"] = {
        "device_ms": prof and prof["device_ms"],
        "scan_device_ms": kernel_ms(prof, WIDE_KERNELS[0]),
        "merge_device_ms": kernel_ms(prof, WIDE_KERNELS[1]),
        "tile_device_ms": tile_prof and tile_prof["device_ms"],
        "tile_scan_device_ms": kernel_ms(tile_prof, TILE_KERNELS[0]),
        "tile_merge_device_ms": kernel_ms(tile_prof, TILE_KERNELS[1])}
    log(f"[sift_a] k={k}: stacked {out['stacked']}, per-shard "
        f"{out['per_shard']}: every hit list the brute-force top-{k} in "
        f"order, every K1 launch on the wide tier; step {out['step_ms']} ms, "
        f"device {out['step_device']}")
    return out


# k of the reduced-precision main path, and its searches a route
REDUCED_KS = (10, 100)
REDUCED_STACKED = 32
REDUCED_PER_SHARD = 16


def pool_ties(kf, slab, q, r: int, prec: str, what: str,
              bound: bool = False) -> list:
    """Where a search's hits differ from the plain pipeline's at bf16: the
    kernel's and plain_pool's pools of R for the query on the same slab,
    every doc in one and not the other a summation tie (summation_ties,
    `bound` passed on) at the pool's R-th score. Returns the ties."""
    args = reduced_args(kf, *slab, q, prec)
    kv, ki = kf.pool_scan(*args, r=r, similarity="l2_norm",
                          score_precision=prec)
    pv, pi = kf.plain_pool(*args, r=r, similarity="l2_norm",
                           score_precision=prec)
    torch.cuda.synchronize()
    if set(ki.flatten().tolist()) == set(pi.flatten().tolist()):
        raise AssertionError(f"{what}: the hits differ though the pools hold "
                             f"the same docs")
    return summation_ties(kf, kv, ki, pv, pi, args, "l2_norm", what, bound)


def reduced_main_phase(node, kf, queries: np.ndarray,
                       step_input: tuple) -> dict:
    """Index A at search.knn.score_precision bf16, then int8 (set through
    ann.default_config as the port's tests set it; fp32 restored after),
    on both serving routes, K1 on the wide tier's tensor-core scan: at
    k = 10 and k = 100 (size = k), 32 searches through the stacked step
    (R = 40 / 400), 16 on the per-shard route (k_bucket 16 / 128: R = 64 /
    512) and the 64 searches from 8 threads through the batcher, gated
    only (concurrent_phase: each equal to its solo search bit for bit, the
    exact fp32 rescore of a batch summed in the solo order by the
    fixed-order rescore kernel). Every K1 launch
    of each path, counted from 0, is on the tensor-core tier. Each solo
    hit list equals the plain pipeline's on the node's own slab (the
    stacked step's bundle: knn_fused_stacked with impl="xla" at the same
    precision and k, its exact fp32 rescore, the top k) in order; at bf16
    a differing list is allowed only where the two pools differ by
    summation ties (pool_ties), each logged. Recall@k against the fp32
    brute force is printed, not gated. Then one stacked step a precision
    and k on the device by kernel name: the whole step, and its parts
    alone: the operand prep (cast or quantize), the scan and merge (by
    name), and the exact rescore (the fixed-order rescore kernel with its
    |q|^2 launch, and the top-k: its kernels by name)."""
    from opensearch_tpu_torch.cluster.shard_mesh import default_registry
    from opensearch_tpu_torch.ops import knn_rescore as kr
    from opensearch_tpu_torch.search import ann, distributed_serving, executor

    v, nrm, ok, _q = step_input
    n = v.shape[1]
    bundles = [b for key, b in default_registry._bundles.items()
               if key[0] == "sift_a"]
    if len(bundles) != 1:
        raise AssertionError(f"[sift_a] {len(bundles)} serving bundles")
    bundle = bundles[0]
    slab = (bundle.vectors, bundle.norms_sq, bundle.valid)
    # flat slot i of the one-segment bundle is doc "i"
    if not torch.equal(bundle.vectors[0, :n], v[0]) or \
            int(bundle.valid[0].sum()) != n:
        raise AssertionError("[sift_a] the bundle is not the docs in id order")
    dev = v.device
    qt = torch.from_numpy(queries).to(dev)
    one = torch.ones(1, device=dev)
    truth = {k: kf.plain_pool(v, nrm, ok, qt, (qt * qt).sum(1), one, r=k,
                              similarity="l2_norm",
                              score_precision="fp32")[1][0].tolist()
             for k in REDUCED_KS}

    def plain_hits(i: int, k: int, prec: str) -> list:
        _vals, ids = kf.knn_fused_stacked(*slab, qt[i:i + 1], k=k,
                                          similarity="l2_norm",
                                          score_precision=prec, impl="xla")
        return [str(int(x)) for x in ids[0, 0].tolist() if x >= 0]

    def counts() -> dict:
        return {"knn_fused": kf.launches.count,
                "knn_fused_mma": kf.mma_launches.count,
                "knn_rescore": kr.launches.count,
                "knn_query_sq": kr.sq_launches.count}

    def run(m: int, k: int, k_route: int, prec: str, what: str) -> dict:
        for counter in (kf.launches, kf.mma_launches, kr.launches,
                        kr.sq_launches):
            counter.reset()
        lat, recall, ties = [], [], 0
        for i, qv in enumerate(queries[:m]):
            t0 = time.perf_counter()
            resp = node.search("sift_a", {"query": {"knn": {"v": {
                "vector": qv.tolist(), "k": k}}}, "size": k})
            lat.append(time.perf_counter() - t0)
            hits = [h["_id"] for h in resp["hits"]["hits"]]
            want = plain_hits(i, k_route, prec)[:k]
            if hits != want:
                label = f"[sift_a] {what} {prec} k={k} query {i}"
                if prec != "bf16":
                    raise AssertionError(f"{label}: hits differ from the "
                                         f"plain pipeline's")
                r = kf.fused_pool_width(k_route, prec)
                for tie in pool_ties(kf, slab, qt[i:i + 1], r, prec, label):
                    ties += 1
                    log(f"{label}: hits differ from the plain pipeline's at "
                        f"a summation tie of the pool {tie}")
            recall.append(len(set(hits) & {str(x) for x in truth[k][i]}) / k)
        out = latency_summary(lat)
        out.update(launches=counts(), recall=float(np.mean(recall)),
                   summation_ties=ties)
        return out

    out = {}
    try:
        for prec in REDUCED:
            ann.default_config.configure(score_precision=prec)
            for k in REDUCED_KS:
                key = f"{prec} k={k}"
                res = out[key] = {}
                searches0 = distributed_serving.stats["distributed_searches"]
                res["stacked"] = run(REDUCED_STACKED, k, k, prec, "stacked")
                served = (distributed_serving.stats["distributed_searches"]
                          - searches0)
                if served != REDUCED_STACKED:
                    raise AssertionError(f"[sift_a] {key}: {served} of "
                                         f"{REDUCED_STACKED} searches on the "
                                         f"stacked step")
                k_bucket = 1 << (k - 1).bit_length()
                distributed_serving.enabled = False
                try:
                    fused0 = executor.knn_path_stats["fused"]
                    res["per_shard"] = run(REDUCED_PER_SHARD, k, k_bucket,
                                           prec, "per-shard")
                    if executor.knn_path_stats["fused"] - fused0 != \
                            REDUCED_PER_SHARD:
                        raise AssertionError(f"[sift_a] per-shard {key}: not "
                                             f"every search took K1")
                    res["concurrent"] = concurrent_phase(
                        node, "sift_a", queries, k,
                        {"knn_fused": kf.launches,
                         "knn_fused_mma": kf.mma_launches,
                         "knn_rescore": kr.launches,
                         "knn_query_sq": kr.sq_launches},
                        size=k, reduced=True)
                finally:
                    distributed_serving.enabled = True
                for what, want, got in (
                        ("stacked", REDUCED_STACKED,
                         res["stacked"]["launches"]),
                        ("per-shard", REDUCED_PER_SHARD,
                         res["per_shard"]["launches"]),
                        ("concurrent gated", None,
                         res["concurrent"]["gated"]["launches"])):
                    if got["knn_fused_mma"] != got["knn_fused"] or (
                            want is not None and got["knn_fused"] != want) \
                            or got["knn_rescore"] != got["knn_fused"] \
                            or got["knn_query_sq"] != got["knn_fused"]:
                        raise AssertionError(
                            f"[sift_a] {what} {key}: K1 launches not one a "
                            f"search, all on the tensor-core tier, each with "
                            f"one |q|^2 and one rescore launch: {got}")
                log(f"[sift_a] {key}: stacked {res['stacked']}, per-shard "
                    f"{res['per_shard']}, gated "
                    f"{res['concurrent']['gated']}: every K1 launch on the "
                    f"tensor-core tier, hits the plain pipeline's")
    finally:
        ann.default_config.configure(score_precision="fp32")
    # one stacked step a precision and k on the device, whole and by parts
    q1 = qt[:1]
    for prec in REDUCED:
        for k in REDUCED_KS:
            r = kf.fused_pool_width(k, prec)
            args = reduced_args(kf, *slab, q1, prec)
            _pv, pi = kf.pool_scan(*args, r=r, similarity="l2_norm",
                                   score_precision=prec)
            step = device_profile(functools.partial(
                kf.knn_fused_stacked, *slab, q1, k=k, similarity="l2_norm",
                score_precision=prec), 10)
            prep = device_profile(functools.partial(
                kf._prep_operands, slab[0], q1, prec), 10)
            scan = device_profile(functools.partial(
                kf.pool_scan, *args, r=r, similarity="l2_norm",
                score_precision=prec), 10)
            rescore = device_profile(functools.partial(
                kf._fused_rescore, q1, *slab, pi, k=k,
                similarity="l2_norm"), 10)
            einsum = device_profile(functools.partial(
                einsum_rescore, kf, q1, *slab, pi, k, "l2_norm"), 10)
            split = {
                "step_ms": time_ms(functools.partial(
                    kf.knn_fused_stacked, *slab, q1, k=k,
                    similarity="l2_norm", score_precision=prec), 20),
                "step_device_ms": step and step["device_ms"],
                "step_kernels": step and step["top"],
                "prep_device_ms": prep and prep["device_ms"],
                "prep_kernels": prep and prep["top"],
                "scan_device_ms": kernel_ms(scan, MMA_KERNELS[0]),
                "merge_device_ms": kernel_ms(scan, MMA_KERNELS[1]),
                "rescore_device_ms": rescore and rescore["device_ms"],
                "rescore_kernels": rescore and rescore["top"],
                "einsum_rescore_device_ms": einsum and einsum["device_ms"]}
            out[f"{prec} k={k}"]["step"] = split
            log(f"[sift_a] stacked step {prec} k={k} (B=1, "
                f"{bundle.n_flat} slots) device split: {json.dumps(split)}")
    return out


def stacked_batch_phase(node, kf, queries: np.ndarray) -> dict:
    """The stacked step's batch against its solo launches (the reference
    batcher's contract on the route with no dispatch batcher): index A,
    distributed_serving.mesh_knn_batch with 8 queries in one launch, then
    each alone, at fp32, bf16 and int8 and k = 10 and 100. Every query's
    device-merged hits (score, shard, segment, doc) must equal its solo
    launch's bit for bit; one K1 launch a batch."""
    from opensearch_tpu_torch.search import ann, distributed_serving
    from opensearch_tpu_torch.search.query_dsl import KnnQuery

    (shard,) = node.indices["sift_a"].shards.values()
    snaps = [shard.acquire_searcher()]
    nodes = [KnnQuery(field="v", vector=qv.tolist(), k=0)
             for qv in queries[:8]]

    def rows(out) -> list:
        return [[(h.score, si, h.segment, h.doc) for si, h in row]
                for row in out.premerged]

    out = {}
    try:
        for prec in ("fp32", *REDUCED):
            ann.default_config.configure(score_precision=prec)
            for k in REDUCED_KS:
                for q in nodes:
                    q.k = k
                kf.launches.reset()
                batch = distributed_serving.mesh_knn_batch(
                    [shard], snaps, nodes, k)
                launches = kf.launches.count
                solo = [rows(distributed_serving.mesh_knn_batch(
                    [shard], snaps, [q], k))[0] for q in nodes]
                got = rows(batch)
                if launches != 1:
                    raise AssertionError(f"[sift_a] stacked batch {prec} "
                                         f"k={k}: {launches} K1 launches")
                for i, (g, w) in enumerate(zip(got, solo)):
                    if g != w:
                        raise AssertionError(
                            f"[sift_a] stacked batch {prec} k={k} query {i}: "
                            f"not its solo hits bit for bit")
                out[f"{prec} k={k}"] = {"queries": len(nodes),
                                        "launches": launches}
    finally:
        ann.default_config.configure(score_precision="fp32")
    log(f"[sift_a] stacked step, 8 queries a launch: every query's hits its "
        f"solo launch's bit for bit at {sorted(out)}")
    return out


# the filters of the filtered main phase: the perf-tool's relaxed (about
# 40% of docs) and restrictive (about 1%) specs, and 50 ids
FILTER_IDS = 50


def filter_bodies(rng, n: int) -> dict:
    """(filter body, its docs as a numpy predicate over the attributes) by
    name; the ids filter's 50 docs drawn from the seed."""
    ids = np.sort(rng.choice(n, FILTER_IDS, replace=False))
    return {
        "relaxed": ({"bool": {"filter": [
            {"range": {"age": {"gte": 20, "lt": 80}}},
            {"terms": {"color": list(COLORS[:4])}}]}},
            lambda a: (a["age"] >= 20) & (a["age"] < 80) & (a["color"] < 4)),
        "restrictive": ({"bool": {"filter": [
            {"range": {"age": {"gte": 30, "lt": 40}}},
            {"term": {"color": COLORS[0]}}],
            "must_not": [{"term": {"taste": TASTES[2]}}]}},
            lambda a: (a["age"] >= 30) & (a["age"] < 40) & (a["color"] == 0)
            & (a["taste"] != 2)),
        "ids": ({"ids": {"values": [str(int(i)) for i in ids]}},
                lambda a: np.isin(np.arange(len(a["age"])), ids)),
    }


FILTERED_QUERIES = 8


def filtered_main_phase(node, kf, attrs: dict, queries: np.ndarray,
                        step_input: tuple, rng) -> dict:
    """Filtered kNN on index A (a filter inside the knn clause), through
    the stacked step and the per-shard route (distributed_serving off):
    the relaxed, restrictive and ids filters (filter_bodies), 8 searches
    each at fp32 k = 10 and 100 (size = k) and at bf16 and int8 k = 10.
    Every hit list must equal, in order, the brute force over the filtered
    docs summed in the kernel's order (fp32: kernel_order_scores on the
    docs the filter admits) or the plain pipeline on the node's slab with
    the filter's docs as valid (bf16, int8: knn_fused_stacked impl="xla";
    bf16 but at logged summation ties of the pool, pool_ties); the ids
    filter at k = 100 returns exactly its 50 docs. Each search launches K1
    exactly once, on the tier scan_tier names (counted from 0 on
    list_launches, wide_launches, mma_launches), and every stacked search
    counts in distributed_serving.stats["filtered"]. Logs the segment's
    device bytes by column kind and each run's p50 on the host clock; then
    the device ms of the stacked mask build
    (_filter_valid_mask) and of the step over the filtered slab beside the
    unfiltered step's, by kernel name."""
    from opensearch_tpu_torch.cluster.shard_mesh import default_registry
    from opensearch_tpu_torch.ops import knn_rescore as kr
    from opensearch_tpu_torch.search import (ann, distributed_serving,
                                             query_dsl)

    v, nrm, ok, _q = step_input
    n, dev = v.shape[1], v.device
    (bundle,) = [b for key, b in default_registry._bundles.items()
                 if key[0] == "sift_a"]
    filters_ = filter_bodies(rng, n)
    (shard,) = node.indices["sift_a"].shards.values()
    out = {"column_nbytes": [dev_seg.column_nbytes() for _host, dev_seg
                             in shard.acquire_searcher().segments]}
    log(f"[sift_a] device bytes by column kind: {out['column_nbytes']}")
    qt = torch.from_numpy(queries[:FILTERED_QUERIES]).to(dev)
    qsq = kr.plain_query_sq(qt)
    tier_counter = {"lists": kf.list_launches, "wide": kf.wide_launches,
                    "mma": kf.mma_launches}
    fkeys = (("fp32", 10), ("fp32", 100), ("bf16", 10), ("int8", 10))
    try:
        for fname, (body, pred) in filters_.items():
            mask = torch.from_numpy(pred(attrs)).to(dev)
            eligible = int(mask.sum())
            eligible_ids = {str(int(x)) for x in mask.nonzero()[:, 0].tolist()}
            valid_f = ok & mask[None]
            slab_valid = bundle.valid.clone()
            slab_valid[0, :n] &= mask
            slab = (bundle.vectors, bundle.norms_sq, slab_valid)
            scores = kernel_order_scores(kf, v, nrm, valid_f, qt, qsq,
                                         "l2_norm")
            for prec, k in fkeys:
                ann.default_config.configure(score_precision=prec)
                truth = [[str(int(i)) for i in row if i >= 0]
                         for row in order_top(kf, scores, k)[1][0].tolist()]
                for route in ("stacked", "per_shard"):
                    distributed_serving.enabled = route == "stacked"
                    k_route = k if route == "stacked" \
                        else 1 << (k - 1).bit_length()
                    r = kf.fused_pool_width(k_route, prec)
                    tier = kf.scan_tier(prec, r)
                    label = f"[sift_a] filtered {fname} {route} {prec} k={k}"
                    for c in (kf.launches, *tier_counter.values()):
                        c.reset()
                    filtered0 = distributed_serving.stats["filtered"]
                    lat, ties = [], 0
                    for i in range(FILTERED_QUERIES):
                        t0 = time.perf_counter()
                        resp = node.search("sift_a", {"query": {"knn": {"v": {
                            "vector": queries[i].tolist(), "k": k,
                            "filter": body}}}, "size": k})
                        lat.append(time.perf_counter() - t0)
                        hits = [h["_id"] for h in resp["hits"]["hits"]]
                        if prec == "fp32":
                            want = truth[i]
                        else:
                            _vals, ids = kf.knn_fused_stacked(
                                *slab, qt[i:i + 1], k=k_route,
                                similarity="l2_norm", score_precision=prec,
                                impl="xla")
                            want = [str(int(x)) for x in ids[0, 0].tolist()
                                    if x >= 0][:k]
                        if hits != want:
                            if prec != "bf16":
                                raise AssertionError(f"{label} query {i}: "
                                                     f"hits differ from the "
                                                     f"brute force")
                            for tie in pool_ties(kf, slab, qt[i:i + 1], r,
                                                 prec, f"{label} query {i}"):
                                ties += 1
                                log(f"{label} query {i}: summation tie {tie}")
                        if not set(hits) <= eligible_ids:
                            raise AssertionError(f"{label} query {i}: a hit "
                                                 f"outside the filter")
                        if fname == "ids" and k >= FILTER_IDS and \
                                len(hits) != FILTER_IDS:
                            raise AssertionError(f"{label} query {i}: "
                                                 f"{len(hits)} hits of the "
                                                 f"{FILTER_IDS} docs")
                    got = {"knn_fused": kf.launches.count,
                           tier: tier_counter[tier].count,
                           "filtered": distributed_serving.stats["filtered"]
                           - filtered0}
                    want_f = FILTERED_QUERIES if route == "stacked" else 0
                    if got["knn_fused"] != FILTERED_QUERIES or \
                            got[tier] != FILTERED_QUERIES or \
                            got["filtered"] != want_f:
                        raise AssertionError(f"{label}: not one K1 launch a "
                                             f"search on the {tier} tier, "
                                             f"{want_f} filtered: {got}")
                    res = latency_summary(lat)
                    res.update(launches=got, tier=tier, eligible=eligible,
                               summation_ties=ties)
                    out[f"{fname} {route} {prec} k={k}"] = res
                    log(f"{label}: hits equal the brute force over the "
                        f"{eligible} filtered docs; {json.dumps(res)}")
            del scores
    finally:
        distributed_serving.enabled = True
        ann.default_config.configure(score_precision="fp32")
    # the device side of one filtered stacked search at k = 10
    snaps = [shard.acquire_searcher()]
    q1 = qt[:1]
    for fname in ("relaxed", "restrictive"):
        flt = query_dsl.parse_query(filters_[fname][0])
        mask_prof = device_profile(functools.partial(
            distributed_serving._filter_valid_mask, [shard], snaps, flt,
            bundle.n_flat, dev), 10)
        fvalid = bundle.valid & distributed_serving._filter_valid_mask(
            [shard], snaps, flt, bundle.n_flat, dev)
        step_f = device_profile(functools.partial(
            kf.knn_fused_stacked, bundle.vectors, bundle.norms_sq, fvalid, q1,
            k=10, similarity="l2_norm"), 10)
        step_u = device_profile(functools.partial(
            kf.knn_fused_stacked, bundle.vectors, bundle.norms_sq,
            bundle.valid, q1, k=10, similarity="l2_norm"), 10)
        out[f"{fname} device"] = {
            "mask_device_ms": mask_prof and mask_prof["device_ms"],
            "mask_wall_ms": mask_prof and mask_prof["wall_ms"],
            "mask_kernels": mask_prof and mask_prof["top"],
            "step_device_ms": step_f and step_f["device_ms"],
            "unfiltered_step_device_ms": step_u and step_u["device_ms"],
            "step_kernels": step_f and step_f["top"]}
        log(f"[sift_a] filtered {fname} stacked k=10 device: "
            f"{json.dumps(out[f'{fname} device'])}")
    return out


# the stacked step past the wide tier: k on the 768-d index, and on cell A
LARGE_MAIN_KS = (1025, 2000, 4096)
LARGE_MAIN_DOCS = 20_000
LARGE_MAIN_CELL_A_K = 10_000


def large_main_phase(node, kf, data_a: np.ndarray, queries_a: np.ndarray,
                     step_input: tuple, rng) -> dict:
    """The stacked step at fp32 past r = 1024, K1 on its large-r tier:
    node.search at k = 1025, 2000 and 4096 (size = k) on a 768-d l2 index of
    20,000 clustered docs (one shard: 32,768 slots), 4 searches each, and at
    k = 10,000 on index A (262,144 slots), 2 searches; then k = 5,000 on an
    index of 1,500 docs with 20 deleted (2,048 slots: r = n_flat), which
    must return every live doc. Every hit list is the brute force summed in
    the kernel's order (kernel_order_scores, order_top) in order, and each
    search launches K1 exactly once, on the large-r tier (counted from 0).
    Logs the p50 of each k on the host clock."""
    from opensearch_tpu_torch.ops import knn_rescore as kr

    dev = step_input[0].device
    data768 = clustered(rng, LARGE_MAIN_DOCS, 768)
    small = clustered(rng, 1500, DIM)
    t0 = time.perf_counter()
    _bulk_index(node, "wide768", data768, 1)
    _bulk_index(node, "small", small, 1)
    deleted = [str(int(i)) for i in rng.choice(1500, 20, replace=False)]
    node.bulk([("delete", {"_index": "small", "_id": d}, None)
               for d in deleted], refresh=True)
    log(f"[wide768] {LARGE_MAIN_DOCS} 768-d docs and [small] 1,500 docs: "
        f"bulk + refresh {time.perf_counter() - t0:.1f} s")

    def brute(data: np.ndarray, qs: np.ndarray, k: int, valid=None):
        v = torch.from_numpy(data)[None].to(dev)
        nrm = (v.double() ** 2).sum(2).float()
        ok = torch.ones((1, data.shape[0]), dtype=torch.bool, device=dev) \
            if valid is None else valid
        q = torch.from_numpy(qs).to(dev)
        scores = kernel_order_scores(kf, v, nrm, ok, q, kr.plain_query_sq(q),
                                     "l2_norm")
        return [[str(int(i)) for i in row if i >= 0]
                for row in order_top(kf, scores, k)[1][0].tolist()]

    def run(name: str, qs: np.ndarray, k: int, truth: list) -> dict:
        counters = (kf.launches, kf.large_launches, kf.large_select_launches,
                    kf.yardstick_launches)
        for c in counters:
            c.reset()
        lat = []
        for i, qv in enumerate(qs):
            t0 = time.perf_counter()
            resp = node.search(name, {"query": {"knn": {"v": {
                "vector": qv.tolist(), "k": k}}}, "size": k,
                "_source": False})
            lat.append(time.perf_counter() - t0)
            hits = [h["_id"] for h in resp["hits"]["hits"]]
            if hits != truth[i]:
                bad = next((j for j, (a, b) in enumerate(zip(hits, truth[i]))
                            if a != b), min(len(hits), len(truth[i])))
                raise AssertionError(f"[{name}] k={k} query {i}: hits differ "
                                     f"from the kernel-order brute force at "
                                     f"rank {bad} ({len(hits)} hits)")
        got = [c.count for c in counters]
        if got != [len(qs), len(qs), len(qs), 0]:
            raise AssertionError(f"[{name}] k={k}: (K1, large-r tier, its "
                                 f"multi-CTA select, the yardstick) launched "
                                 f"{got} times in {len(qs)} searches")
        res = latency_summary(lat)
        res["launches"] = {"knn_fused": got[0], "knn_fused_large": got[1],
                           "knn_large_select": got[2],
                           "knn_large_yardstick": got[3]}
        log(f"[{name}] k={k}: {len(qs)} searches, every hit list the "
            f"kernel-order brute force, one large-r launch each; "
            f"{json.dumps(res)}")
        return res

    out = {}
    q768 = (data768[rng.choice(LARGE_MAIN_DOCS, 4, replace=False)]
            + 0.05 * rng.standard_normal((4, 768)).astype(np.float32))
    for k in LARGE_MAIN_KS:
        out[f"wide768 k={k}"] = run("wide768", q768, k,
                                    brute(data768, q768, k))
    qa = queries_a[:2]
    out[f"sift_a k={LARGE_MAIN_CELL_A_K}"] = run(
        "sift_a", qa, LARGE_MAIN_CELL_A_K,
        brute(data_a, qa, LARGE_MAIN_CELL_A_K))
    live = torch.ones((1, 1500), dtype=torch.bool, device=dev)
    live[0, [int(d) for d in deleted]] = False
    qs = small[:2] + 0.05
    truth = brute(small, qs, 2048, live)
    if any(len(t) != 1480 for t in truth):
        raise AssertionError("[small] the brute force lost a live doc")
    out["small k=5000"] = run("small", qs, 5000, truth)
    out.update(large_reduced_main(node, kf, q768[:2], qa))
    return out


def bundle_slab(name: str) -> tuple:
    """(vectors, norms_sq, valid) of index `name`'s one serving bundle."""
    from opensearch_tpu_torch.cluster.shard_mesh import default_registry

    bundles = [b for key, b in default_registry._bundles.items()
               if key[0] == name]
    if len(bundles) != 1:
        raise AssertionError(f"[{name}] {len(bundles)} serving bundles")
    return bundles[0].vectors, bundles[0].norms_sq, bundles[0].valid


def large_reduced_main(node, kf, q768: np.ndarray, qa: np.ndarray) -> dict:
    """The stacked step at bf16 and int8 past r = 1024 (R = k), K1 on the
    large-r tier's tensor-core scan: node.search at k = 1025, 2000 and 4096
    (size = k) on the 768-d index, 2 searches each, and k = 10,000 on index
    A, 2 searches, at each precision. Every hit list is the plain
    pipeline's on the node's own slab (knn_fused_stacked impl="xla" at the
    same precision and k) in order; at bf16 a differing list only where the
    pools differ by summation ties (pool_ties, each logged). Each search
    launches K1 exactly once, on the large-r tier's tensor-core scan, and
    never the tile scan (counted from 0)."""
    from opensearch_tpu_torch.search import ann

    out = {}
    try:
        for prec in REDUCED:
            ann.default_config.configure(score_precision=prec)
            for name, qs, ks in (("wide768", q768, LARGE_MAIN_KS),
                                 ("sift_a", qa, (LARGE_MAIN_CELL_A_K,))):
                for k in ks:
                    counters = (kf.launches, kf.large_launches,
                                kf.large_mma_launches, kf.tile_launches,
                                kf.large_select_launches,
                                kf.yardstick_launches)
                    for c in counters:
                        c.reset()
                    lat, ties = [], 0
                    for i, qv in enumerate(qs):
                        t0 = time.perf_counter()
                        resp = node.search(name, {"query": {"knn": {"v": {
                            "vector": qv.tolist(), "k": k}}}, "size": k,
                            "_source": False})
                        lat.append(time.perf_counter() - t0)
                        slab = bundle_slab(name)
                        q1 = torch.from_numpy(qv[None]).to(slab[0].device)
                        _v, ids = kf.knn_fused_stacked(
                            *slab, q1, k=k, similarity="l2_norm",
                            score_precision=prec, impl="xla")
                        want = [str(int(x)) for x in ids[0, 0].tolist()
                                if x >= 0]
                        hits = [h["_id"] for h in resp["hits"]["hits"]]
                        if hits != want:
                            label = f"[{name}] {prec} k={k} query {i}"
                            if prec != "bf16":
                                raise AssertionError(f"{label}: hits differ "
                                                     f"from the plain "
                                                     f"pipeline's")
                            for tie in pool_ties(kf, slab, q1, k, prec,
                                                 label, bound=qv.size >= 512):
                                ties += 1
                                log(f"{label}: a summation tie of the pool "
                                    f"{tie}")
                    got = [c.count for c in counters]
                    n_q = len(qs)
                    if got != [n_q, n_q, n_q, 0, n_q, 0]:
                        raise AssertionError(
                            f"[{name}] {prec} k={k}: (K1, large-r tier, its "
                            f"tensor-core scan, tile scan, multi-CTA select, "
                            f"yardstick) launched {got} times in {n_q} "
                            f"searches")
                    res = latency_summary(lat)
                    res["launches"] = {"knn_fused": got[0],
                                       "knn_fused_large": got[1],
                                       "knn_fused_large_mma": got[2],
                                       "knn_fused_tile": got[3],
                                       "knn_large_select": got[4],
                                       "knn_large_yardstick": got[5]}
                    res["summation_ties"] = ties
                    out[f"{name} {prec} k={k}"] = res
                    log(f"[{name}] {prec} k={k}: {len(qs)} searches, hits "
                        f"the plain pipeline's, one launch each on the "
                        f"large-r tier's tensor-core scan; {json.dumps(res)}")
    finally:
        ann.default_config.configure(score_precision="fp32")
    return out


def latency_summary(lat_s: list, wall_s: float | None = None) -> dict:
    """p50 and p99 of per-search latencies (ms) and QPS: searches over the
    summed latencies, or over the wall time when searches overlapped."""
    lat_ms = np.asarray(lat_s) * 1e3
    return {"p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "qps": len(lat_s) / (wall_s if wall_s is not None else sum(lat_s))}


def concurrent_check(name: str, i: int, got: list, solo: list) -> None:
    """A concurrent hit list against its solo one: the ids in the same order
    and every score the same float, bit for bit (the reference batcher's
    contract), on every path, K1's at fp32, bf16 and int8 and the IVF-PQ
    route's: each dot, |q|^2, LUT, probe score and exact rescore sums in
    one order whatever the batch."""
    if got != solo:
        bad = next(j for j, (a, b) in enumerate(zip(got, solo)) if a != b) \
            if len(got) == len(solo) else None
        raise AssertionError(f"[{name}] concurrent query {i}: not the "
                             f"solo hits bit for bit (first difference "
                             f"at position {bad}: {got[bad] if bad is not None else got} "
                             f"!= {solo[bad] if bad is not None else solo})")


def concurrent_phase(node, name: str, queries: np.ndarray, k: int,
                     counters: dict, size: int = 10,
                     reduced: bool = False) -> dict:
    """The 64 queries one after another, then the same 64 from 8 threads of
    8 searches each, three times, each returning `size` hits. Every
    concurrent hit list must equal its solo one (concurrent_check): ids in
    order and scores bit for bit, since every sum a hit depends on
    (K1's dots, |q|^2, the rescore; the IVF-PQ route's probe scores, LUTs
    and rescore) has one order whatever the batch.

    1. The gated run: each round of 8 searches leaves a barrier together,
       and the batcher waits up to 50 ms with its tuner off, so the merge
       does not hang on how the host schedules the threads. The batcher
       must have merged more than one query a launch on average, and each
       kernel in `counters` must have launched fewer times than there were
       searches.
    2. The measured run: the threads run free under the batcher's default
       settings; p50, p99, QPS and the mean merged batch are reported, not
       gated.
    3. The same with the batcher switched off, to tell its share of the
       concurrent numbers from the threads'.
    At a reduced precision (`reduced`) the gated run alone."""
    def search(qv) -> list:
        resp = node.search(name, {"query": {"knn": {"v": {
            "vector": qv.tolist(), "k": k}}}, "size": size})
        return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]

    n = len(queries)
    solo, solo_lat = [], []
    for qv in queries:
        t0 = time.perf_counter()
        solo.append(search(qv))
        solo_lat.append(time.perf_counter() - t0)

    def threaded(together: bool = False) -> tuple[list, float]:
        got, lat = [None] * n, [0.0] * n
        barrier = threading.Barrier(8) if together else None

        def worker(t: int) -> None:
            try:
                for i in range(t, n, 8):
                    if barrier is not None:
                        barrier.wait(timeout=120)
                    t0 = time.perf_counter()
                    got[i] = search(queries[i])
                    lat[i] = time.perf_counter() - t0
            except BaseException:
                if barrier is not None:
                    # release the other threads instead of leaving them
                    # at the barrier
                    barrier.abort()
                raise

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            for f in [pool.submit(worker, t) for t in range(8)]:
                f.result()
        wall = time.perf_counter() - t0
        for i, (g, s) in enumerate(zip(got, solo)):
            concurrent_check(name, i, g, s)
        return lat, wall

    def batched_run(together: bool) -> tuple[dict, dict, tuple]:
        node.knn_batcher.reset()
        for counter in counters.values():
            counter.reset()
        timed = threaded(together)
        stats = node.knn_batcher.snapshot_stats()
        return stats, {key: c.count for key, c in counters.items()}, timed

    batcher = node.knn_batcher
    wait0 = batcher.max_wait_ms
    batcher.configure(max_wait_ms=50, auto_tune=False)
    try:
        gated, gated_launches, _timed = batched_run(together=True)
    finally:
        batcher.configure(max_wait_ms=wait0, auto_tune=True)
    if gated["mean_merged_batch"] <= 1:
        raise AssertionError(f"[{name}] the batcher merged nothing: {gated}")
    for key, count in gated_launches.items():
        if not 0 < count < n:
            raise AssertionError(f"[{name}] {key} launched {count} times in "
                                 f"{n} concurrent searches")
    gated_out = {"dispatches": gated["dispatches"],
                 "mean_merged_batch": gated["mean_merged_batch"],
                 "max_batch": gated["max_batch"], "launches": gated_launches}
    if reduced:
        out = {"solo": latency_summary(solo_lat), "gated": gated_out}
        log(f"[{name}] 8 threads x 8 searches, gated, equal the solo ones: "
            f"{out}")
        return out
    stats, launches, (lat, wall) = batched_run(together=False)
    batcher.configure(enabled=False)
    try:
        lat_off, wall_off = threaded()
    finally:
        batcher.configure(enabled=True)
    out = {"solo": latency_summary(solo_lat),
           "concurrent": latency_summary(lat, wall),
           "concurrent_batcher_off": latency_summary(lat_off, wall_off),
           "dispatches": stats["dispatches"],
           "mean_merged_batch": stats["mean_merged_batch"],
           "max_batch": stats["max_batch"], "launches": launches,
           "gated": gated_out}
    log(f"[{name}] 8 threads x 8 searches equal the solo ones: {out}")
    return out


def per_shard_exact_phase(node, kf, queries: np.ndarray, truth: list) -> dict:
    """Index A on the per-shard route (distributed_serving.enabled off).
    32 searches at k = 256, size = 10: one 200,000-doc segment, so each
    takes the streaming scan once, and every hit list must be the
    brute-force top-10 in order. Then 8 threads x 8 searches at k = 10
    (K1 through the batcher) against the same searches one at a time."""
    from opensearch_tpu_torch.search import distributed_serving, executor

    distributed_serving.enabled = False
    try:
        stream0 = executor.knn_path_stats["streaming"]
        lat = []
        for i, qv in enumerate(queries[:32]):
            t0 = time.perf_counter()
            resp = node.search("sift_a", {"query": {"knn": {"v": {
                "vector": qv.tolist(), "k": 256}}}, "size": 10})
            lat.append(time.perf_counter() - t0)
            hits = [h["_id"] for h in resp["hits"]["hits"]]
            if hits != truth[i]:
                raise AssertionError(f"[sift_a] per-shard k=256 query {i}: "
                                     f"{hits} != truth {truth[i]}")
        streamed = executor.knn_path_stats["streaming"] - stream0
        if streamed != 32:
            raise AssertionError(f"[sift_a] {streamed} of 32 k=256 searches "
                                 f"took the streaming scan")
        k256 = latency_summary(lat)
        log(f"[sift_a] per-shard route, k=256 size=10: 32 searches equal the "
            f"brute force, each streamed once; {k256}")
        conc = concurrent_phase(node, "sift_a", queries, 10,
                                {"knn_fused": kf.launches,
                                 "knn_fused_lists": kf.list_launches})
    finally:
        distributed_serving.enabled = True
    for run in (conc["gated"]["launches"], conc["launches"]):
        if run["knn_fused_lists"] != run["knn_fused"]:
            raise AssertionError(f"[sift_a] per-shard K1 launches not all on "
                                 f"the list scan: {run}")
    log("[sift_a] per-shard route: every K1 launch through the batcher took "
        "the list scan (knn_pool.cuh)")
    return {"k256": k256, "concurrent": conc}

# --------------------------------------------------------------------------
# K2: the IVF-PQ ADC scan
# --------------------------------------------------------------------------


def compare_adc_pools(ads, args, r, what: str, scan=None) -> float:
    """K2 (or `scan`, another build's launch) vs its plain version on the
    same operands; returns max |dv|."""
    lut = args[0]
    kv, ki = (scan or ads.adc_pool_scan)(*args, r=r)
    pv, pi = ads.plain_adc_pool(*args, r=r)
    torch.cuda.synchronize()
    if not torch.equal(ki, pi):
        bad = (ki != pi).nonzero()[:5].tolist()
        raise AssertionError(f"{what}: ids differ at {bad}")
    fin = torch.isfinite(pv)
    if not torch.equal(fin, torch.isfinite(kv)):
        raise AssertionError(f"{what}: finite slots differ")
    if lut.dtype == torch.uint8:
        if not torch.equal(kv, pv):
            raise AssertionError(f"{what}: uint8 pool not bit-equal")
    elif not torch.allclose(kv[fin], pv[fin], rtol=1e-6, atol=1e-6):
        raise AssertionError(f"{what}: scores beyond rtol 1e-6 / atol 1e-6")
    return float((kv[fin] - pv[fin]).abs().max()) if bool(fin.any()) else 0.0


def ann_corpus(rng, n: int, d: int, n_centers: int = 1024) -> np.ndarray:
    """Clustered vectors whose IVF lists come out of similar length, as in
    a real embedding corpus (the exact phases use 64 tight centres)."""
    centers = rng.standard_normal((n_centers, d)).astype(np.float32) * 2.0
    out = np.empty((n, d), np.float32)
    for lo in range(0, n, 200_000):
        hi = min(lo + 200_000, n)
        out[lo:hi] = (centers[rng.integers(0, n_centers, hi - lo)]
                      + rng.standard_normal((hi - lo, d)).astype(np.float32))
    return out


def adc_operands(ads, ivfpq, index, queries, nprobe, precision):
    """The scan operands exactly as fused_adc_search makes them."""
    probes = ads.probes_on(ivfpq.host_probe_select(index, queries, nprobe),
                           index.params.nlist, index.codes.device)
    q = torch.from_numpy(queries).to(index.codes.device)
    lut = ads.build_luts(q, index.params.coarse, index.params.codebooks,
                         probes, adc_precision=precision).contiguous()
    return lut, index.codes, index.ids, index.mask, probes


def adc_synthetic(ads, dev, rng, nlist: int, l_pad: int, m: int, fills,
                  b: int, p: int, prec: str, ks: int = 256):
    """K2 operands on a random slab: list li live on its first fills[li]
    slots (ids a permutation, -1 where masked), b queries of p distinct
    probes, a random LUT at `prec`'s width (uint8 direct, not through the
    affine)."""
    codes = rng.integers(0, ks, (nlist, l_pad, m), dtype=np.uint8)
    ids = rng.permutation(nlist * l_pad).astype(np.int32).reshape(nlist,
                                                                  l_pad)
    mask = np.zeros((nlist, l_pad), bool)
    for li, fill in enumerate(fills):
        mask[li, :fill] = True
    ids[~mask] = -1
    probes = np.stack([rng.choice(nlist, p, replace=False)
                       for _ in range(b)]).astype(np.int32)
    return adc_slab_operands(dev, rng, codes, ids, mask, probes, prec, ks)


def adc_slab_operands(dev, rng, codes, ids, mask, probes, prec: str,
                      ks: int = 256, zero_column: bool = False):
    b, p = probes.shape
    m = codes.shape[2]
    if prec == "int8":
        lut = torch.from_numpy(rng.integers(0, 256, (b, p, m, ks))
                               .astype(np.uint8)).to(dev)
    else:
        lut = torch.from_numpy((rng.random((b, p, m, ks)) * 8.0)
                               .astype(np.float32)).to(dev)
        if prec == "bf16":
            lut = lut.to(torch.bfloat16)
    if zero_column:
        lut[..., 0] = 0
    return [lut.contiguous(), *(torch.from_numpy(a).to(dev)
                                for a in (codes, ids, mask, probes))]


def adc_kernel_phase(ads, ivfpq, dev, seed: int) -> float:
    """K2 against plain_adc_pool: an IVF-PQ build (m = 20) at B = 1, 8, 16,
    33 and 129 x R = 1, 10, 63, 64, 65, 500 and 4096; random slabs at
    m = 8 (B = 33, ragged and empty lists, R to 4096), m = 96 (a 96 KB fp32
    LUT), m = 30 (the byte path, live < R at R = 500 and 4096); threshold
    ties across parts and probes (600 identical zero-scoring rows a list,
    more than R of them); a merge past shared memory (every slot of 8 lists
    of 8192 live, R = 4096 and R = 20,000, whose sort buffer is in device
    scratch too); the reference's ragged slab with a planted tie. Each at
    fp32, bf16 and uint8 LUTs."""
    rng = np.random.default_rng(seed + 10)
    n, nprobe = K2_PARITY_DOCS, 8
    data = ann_corpus(rng, n, ANN_DIM)
    t0 = time.perf_counter()
    index = ivfpq.build(data, nlist=64, m=ANN_M, device=dev)
    log(f"K2 parity build: n={n} d={ANN_DIM} nlist=64 m={ANN_M} "
        f"l_pad={index.l_pad} in {time.perf_counter() - t0:.1f} s")
    precs = ("fp32", "bf16", "int8")
    err, cases = 0.0, 0
    for b in (1, 8, 16, 33, 129):
        queries = data[rng.choice(n, b, replace=False)] + 0.1 * \
            rng.standard_normal((b, ANN_DIM)).astype(np.float32)
        for prec in precs:
            args = adc_operands(ads, ivfpq, index, queries, nprobe, prec)
            for r in (1, 10, 63, 64, 65, 500, 4096):
                err = max(err, compare_adc_pools(
                    ads, args, r, f"K2 build B={b} {prec} R={r}"))
                cases += 1
    log(f"K2 parity on the build: B = 1/8/16/33/129 x R = 1-4096 x 3 "
        f"precisions ok ({cases} cases)")
    synthetic = (
        # (what, nlist, l_pad, m, fills, B, P, Rs)
        ("m=8 ragged", 32, 2048, 8,
         [0, 1, 2048, 700] + list(rng.integers(0, 2049, 28)), 33, 8,
         (1, 10, 64, 65, 500, 4096)),
        ("m=96 (96 KB fp32 LUT)", 16, 1024, 96,
         list(rng.integers(300, 1025, 16)), 8, 4, (10, 64, 500)),
        ("m=30 bytes, live < R", 16, 512, 30,
         list(rng.integers(0, 100, 16)), 8, 4, (10, 63, 500, 4096)),
        ("merge past shared memory", 8, 8192, 8, [8192] * 8, 2, 8,
         (4096, 20_000)),
    )
    for what, nlist, l_pad, m, fills, b, p, rs in synthetic:
        for prec in precs:
            args = adc_synthetic(ads, dev, rng, nlist, l_pad, m, fills, b, p,
                                 prec)
            for r in rs:
                e = compare_adc_pools(ads, args, r, f"K2 {what} {prec} R={r}")
                err = max(err, e)
        log(f"K2 parity {what}: B={b} P={p} l_pad={l_pad} R={rs} x 3 "
            f"precisions ok")
    # ties on the threshold across parts and probes: 600 rows a list of
    # code 0 in every subspace, and a zero LUT column, so 600 slots a list
    # share the best key (-0.0); the lower position must win each tie
    nlist, l_pad, m = 16, 4096, ANN_M
    codes = rng.integers(1, 256, (nlist, l_pad, m), dtype=np.uint8)
    for li in range(nlist):
        codes[li, rng.choice(3000, 600, replace=False)] = 0
    ids = rng.permutation(nlist * l_pad).astype(np.int32).reshape(nlist,
                                                                  l_pad)
    mask = np.zeros((nlist, l_pad), bool)
    mask[:, :3000] = True
    ids[~mask] = -1
    probes = np.stack([rng.choice(nlist, 8, replace=False)
                       for _ in range(8)]).astype(np.int32)
    for prec in precs:
        args = adc_slab_operands(dev, rng, codes, ids, mask, probes, prec,
                                 zero_column=True)
        for r in (10, 64, 500, 4096):
            err = max(err, compare_adc_pools(ads, args, r,
                                             f"K2 threshold ties {prec} "
                                             f"R={r}"))
        _kv, ki = ads.adc_pool_scan(*args, r=10)
        first = [int(ids[probes[0, 0], l]) for l in range(3000)
                 if not codes[probes[0, 0], l].any()][:10]
        if ki[0].tolist() != first:
            raise AssertionError(f"K2 threshold ties {prec}: {ki[0].tolist()}"
                                 f", expected the first probe's {first}")
    log("K2 parity threshold ties (600 a list, > R, across parts and "
        "probes) x 3 precisions ok")
    # the reference's ragged slab: one empty list, ragged fills, a full one
    nlist, l_pad, m, ks = 6, 32, 4, 16
    codes = rng.integers(0, ks, (nlist, l_pad, m), dtype=np.uint8)
    ids = np.arange(nlist * l_pad, dtype=np.int32).reshape(nlist, l_pad)
    mask = np.zeros((nlist, l_pad), bool)
    for li, fill in enumerate((0, 1, 3, 32, 7, 20)):
        mask[li, :fill] = True
        ids[li, fill:] = -1
    probes = np.stack([rng.choice(nlist, 4, replace=False)
                       for _ in range(3)]).astype(np.int32)
    probes[0] = [0, 1, 2, 4]                 # 11 live slots < R = 16
    # a planted tie: identical codes in lists 4 and 3, both probed by
    # query 1, list 4 first; a zero LUT column makes them the best
    probes[1] = [4, 3, 5, 0]
    codes[4, 5] = codes[3, 9] = 0
    lut_f = rng.random((3, 4, m, ks)).astype(np.float32) * 40 + 5
    lut_f[..., 0] = 0.0
    slab = [torch.from_numpy(a).to(dev) for a in (codes, ids, mask, probes)]
    for lut in (torch.from_numpy(lut_f).to(dev),
                torch.from_numpy(lut_f).to(dev).to(torch.bfloat16),
                torch.from_numpy(np.round(lut_f).astype(np.uint8)).to(dev)):
        args = (lut.contiguous(), *slab)
        err = max(err, compare_adc_pools(ads, args, 16,
                                         f"K2 ragged {lut.dtype}"))
        kv, ki = ads.adc_pool_scan(*args, r=16)
        if not (bool((ki[0, 11:] == -1).all())
                and bool(torch.isneginf(kv[0, 11:]).all())):
            raise AssertionError("K2 ragged: pool tail is not (-inf, -1)")
        if ki[1, :2].tolist() != [int(ids[4, 5]), int(ids[3, 9])]:
            raise AssertionError(
                f"K2 planted tie: {ki[1, :2].tolist()}, expected the "
                f"earlier probe's doc {int(ids[4, 5])} first")
        log(f"K2 parity ragged/empty lists + planted tie {lut.dtype}: ok")
    return err


def adc_bound(index, lut, probes, r: int) -> dict:
    """The least time of one K2 call on these operands: the larger of the
    bytes this run's data needs over 3.35 TB/s and one add per lookup over
    67 T/s. Bytes: each distinct probed list once, however many queries
    probe it (its mask up to its last live slot, m code bytes per live
    slot); every (query, probe) LUT and the probe table; the ids of the
    winners only; the [B, R] pool written. Lookups: m per live slot per
    (query, probe)."""
    b, _p, m, _ks = lut.shape
    mask = index.mask
    live = mask.sum(1)                                        # [nlist]
    extent = (mask * torch.arange(1, mask.shape[1] + 1,
                                  device=mask.device)).amax(1)
    lists = torch.unique(probes.long())
    live_q = live[probes.long()].sum(1)                       # [B]
    nbytes = int(extent[lists].sum() + m * live[lists].sum()
                 + 4 * torch.clamp(live_q, max=r).sum()) \
        + lut.numel() * lut.element_size() + probes.numel() * 4 + b * r * 8
    lookups = int(m * live_q.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = lookups / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "lookups": lookups}


def adc_time(ads, ivfpq, index, queries, r: int, label: str) -> dict:
    """One K2 shape: parity, the wrapper's CUDA-event ms, the plain
    version's, the device ms of each stage read by kernel name under the
    profiler (stage 1 adc_scan_kernel, stage 2 adc_merge_kernel), and the
    bound."""
    args = adc_operands(ads, ivfpq, index, queries, 8, "fp32")
    compare_adc_pools(ads, args, r, label)
    ms = time_ms(lambda: ads.adc_pool_scan(*args, r=r), 50)
    plain_ms = time_ms(lambda: ads.plain_adc_pool(*args, r=r), 5)
    prof = device_profile(lambda: ads.adc_pool_scan(*args, r=r), 20)
    stage1 = kernel_ms(prof, "adc_scan_kernel")
    stage2 = kernel_ms(prof, "adc_merge_kernel")
    bound = adc_bound(index, args[0], args[4], r)
    if prof is not None:
        log(f"{label}: K2 under the profiler: wall {prof['wall_ms']:.4f} ms "
            f"a call, device {prof['device_ms']:.4f} ms a call (stage 1 "
            f"{stage1:.4f}, stage 2 {stage2:.4f}) {prof['top']}")
    log(f"{label}: K2 {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}; {bound['bytes']} "
        f"bytes, {bound['lookups']} lookups)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "device_ms": prof and prof["device_ms"],
            "stage1_device_ms": stage1, "stage2_device_ms": stage2, **bound}


def adc_timing_phase(ads, ivfpq, dev, seed: int) -> dict:
    """K2 at the glove-100 shape (1.2M x 100-d cosine, m = 20, nlist = 512,
    nprobe = 8, R = 64, k = 10 at the default multiplier) at B = 1 and 32,
    and on cell C's index (200,000 such docs, nlist 512) at B = 1 and 8, the
    per-shard route's padded batches."""
    rng = np.random.default_rng(seed + 11)
    out = {}
    for key, n, bs in (("glove", GLOVE_DOCS, (1, 32)),
                       ("cell_c", ANN_MAIN_DOCS, (1, 8))):
        data = ann_corpus(rng, n, ANN_DIM)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = ivfpq.build(data, nlist=512, m=ANN_M, normalized=True,
                            device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        log(f"{key} index build (ivfpq.build on the card): n={n} "
            f"d={ANN_DIM} nlist=512 m={ANN_M} l_pad={index.l_pad} in "
            f"{build_s:.1f} s")
        out[key] = {"n": n, "build_s": build_s, "l_pad": index.l_pad}
        for b in bs:
            q = data[rng.choice(n, b, replace=False)]
            q = q / np.linalg.norm(q, axis=1, keepdims=True)
            out[key][b] = adc_time(ads, ivfpq, index, q, 64,
                                   f"{key} shape B={b}")
        del index
        torch.cuda.empty_cache()
    return out


def plain_shard_hits(ads, ivfpq, kf, segments, qv, k: int, dev) -> list:
    """A shard's best k (doc id, score) by the plain pipeline on the card,
    one query at a time as the per-shard route runs it: per segment the
    IVF-PQ pipeline with the plain scan (adc_topr_auto impl="xla") or the
    plain exact scan (knn_fused impl="xla"; past FUSED_MAX_K the
    materializing scan's scores), then the shard cut by (-score, segment,
    doc)."""
    from opensearch_tpu_torch.ops.knn import exact_knn_scores
    from opensearch_tpu_torch.ops.topk import stable_topk
    from opensearch_tpu_torch.search.executor import _pad_query_batch

    k_bucket = 1 << (k - 1).bit_length()
    cands = []
    for seg_idx, (_host, dseg) in enumerate(segments):
        vf = dseg.vector_fields["v"]
        valid = vf.present & dseg.live
        if vf.ann is not None:
            q1 = qv[None]
            q1 = q1 / np.maximum(np.linalg.norm(q1, axis=-1, keepdims=True),
                                 1e-12)
            index = vf.ann
            pv, pi = ads.adc_topr_auto(
                index.params.coarse, index.params.codebooks, index.codes,
                index.ids, index.mask, vf.vectors, vf.norms_sq, valid,
                torch.from_numpy(q1).to(dev),
                ivfpq.host_probe_select(index, q1, 8), k=k_bucket,
                rerank=ivfpq.default_rerank(k_bucket), similarity="cosine",
                impl="xla")
        elif k_bucket <= kf.FUSED_MAX_K:
            q = torch.from_numpy(_pad_query_batch([qv])).to(dev)
            pv, pi = kf.knn_fused(vf.vectors, vf.norms_sq, valid, q,
                                  k=k_bucket, similarity="cosine", impl="xla")
        else:
            # the materializing scan's scores, and a stable top-k
            q = torch.from_numpy(qv[None]).to(dev)
            pv, pi = stable_topk(exact_knn_scores(
                q, vf.vectors, vf.norms_sq, valid, "cosine"), k_bucket)
        pv, pi = pv[0].cpu().numpy(), pi[0].cpu().numpy()
        cands += [(float(v), seg_idx, int(d)) for v, d in zip(pv, pi)
                  if d >= 0 and np.isfinite(v)][:k]
    cands.sort(key=lambda c: (-c[0], c[1], c[2]))
    return [(segments[s][0].doc_ids[d], v) for v, s, d in cands[:k]]


def check_hits(what: str, got: list, want: list) -> None:
    if [h[0] for h in got] != [w[0] for w in want] or not np.allclose(
            [h[1] for h in got], [w[1] for w in want], rtol=1e-6, atol=1e-6):
        raise AssertionError(f"{what}: hits {got} != plain {want}")


def ann_filtered_check(node, name: str, kf, ads, data: np.ndarray,
                       attrs: dict, queries: np.ndarray, dev, rng) -> dict:
    """Index C (one IVF-PQ segment) under the relaxed filter, k = 10: a
    filtered query never takes ANN, so each search is one exact K1 launch
    (the list scan at fp32) and no K2 launch, through the stacked step
    (which serves the ANN column when filtered, counted in "filtered") and
    the per-shard route. Every hit list is the cosine brute force over the
    filtered docs summed in the kernel's order."""
    from opensearch_tpu_torch.ops import knn_rescore as kr
    from opensearch_tpu_torch.search import distributed_serving, executor

    body, pred = filter_bodies(rng, len(data))["relaxed"]
    mask = torch.from_numpy(pred(attrs)).to(dev)
    v = torch.from_numpy(data)[None].to(dev)
    nrm = (v.double() ** 2).sum(2).float()
    q = torch.from_numpy(queries).to(dev)
    scores = kernel_order_scores(kf, v, nrm, mask[None], q,
                                 kr.plain_query_sq(q), "cosine")
    truth = [[str(int(i)) for i in row if i >= 0]
             for row in order_top(kf, scores, 10)[1][0].tolist()]
    del v, scores
    out = {}
    try:
        for route in ("stacked", "per_shard"):
            distributed_serving.enabled = route == "stacked"
            kf.launches.reset()
            kf.list_launches.reset()
            ads.launches.reset()
            filtered0 = distributed_serving.stats["filtered"]
            ann0 = executor.knn_path_stats["ann"]
            lat = []
            for i, qv in enumerate(queries):
                t0 = time.perf_counter()
                resp = node.search(name, {"query": {"knn": {"v": {
                    "vector": qv.tolist(), "k": 10, "filter": body}}},
                    "size": 10})
                lat.append(time.perf_counter() - t0)
                hits = [h["_id"] for h in resp["hits"]["hits"]]
                if hits != truth[i]:
                    raise AssertionError(f"[{name}] filtered {route} query "
                                         f"{i}: hits differ from the brute "
                                         f"force over the filtered docs")
            got = {"knn_fused": kf.launches.count,
                   "knn_fused_lists": kf.list_launches.count,
                   "adc_scan": ads.launches.count,
                   "ann": executor.knn_path_stats["ann"] - ann0,
                   "filtered": distributed_serving.stats["filtered"]
                   - filtered0}
            m = len(queries)
            want = {"knn_fused": m, "knn_fused_lists": m, "adc_scan": 0,
                    "ann": 0, "filtered": m if route == "stacked" else 0}
            if got != want:
                raise AssertionError(f"[{name}] filtered {route}: launches "
                                     f"{got}, want {want}")
            out[route] = {**latency_summary(lat), "launches": got}
            log(f"[{name}] relaxed filter {route}: {m} exact K1 searches "
                f"equal the brute force, no K2 launch; {json.dumps(out[route])}")
    finally:
        distributed_serving.enabled = True
    return out


def ann_main_phase(ads, ivfpq, kf, dev, seed: int) -> dict:
    """Index C through TorchNode on the card: 200,000 clustered 100-d docs,
    cosine, ivf_pq (nlist 512, m 20, nprobe 8), 1 shard, 64 searches. Then
    a second refresh of 300 docs (below min_train, so exact) and 16
    searches over the shard's IVF-PQ and exact segments together."""
    from opensearch_tpu_torch.node import TorchNode
    from opensearch_tpu_torch.ops import adc_lut
    from opensearch_tpu_torch.search import executor

    rng = np.random.default_rng(seed + 12)
    n, name = ANN_MAIN_DOCS, "glove_c"
    data = ann_corpus(rng, n, ANN_DIM)
    attrs = attributes(rng, n)
    queries = (data[rng.choice(n, 64, replace=False)]
               + 0.1 * rng.standard_normal((64, ANN_DIM)).astype(np.float32))

    def search(qv, k: int = 10) -> list:
        resp = node.search(name, {"query": {"knn": {"v": {
            "vector": qv.tolist(), "k": k}}}, "size": 10})
        return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]

    with tempfile.TemporaryDirectory() as tmp:
        node = TorchNode(tmp, device=dev)
        t0 = time.perf_counter()
        node.create_index(name, {
            "settings": {"number_of_shards": 1},
            "mappings": {"properties": {"v": {
                "type": "knn_vector", "dimension": ANN_DIM,
                "similarity": "cosine",
                "method": {"name": "ivf_pq", "parameters": {
                    "nlist": 512, "m": ANN_M, "nprobe": 8}}},
                **attribute_mapping()}},
        })
        for s in range(0, n, 5000):
            resp = node.bulk([
                ("index", {"_index": name, "_id": str(i)},
                 {"v": data[i].tolist(), **attribute_doc(attrs, i)})
                for i in range(s, min(s + 5000, n))
            ], refresh=False)
            if resp["errors"]:
                raise AssertionError(f"bulk into [{name}] reported errors")
        t1 = time.perf_counter()
        node.refresh(name)
        torch.cuda.synchronize()
        log(f"[{name}] {n} docs, 1 shard: bulk {t1 - t0:.1f} s, refresh "
            f"with the IVF-PQ build {time.perf_counter() - t1:.1f} s")
        # the counts are read for the searches alone
        ann0 = executor.knn_path_stats["ann"]
        ads.launches.reset()
        adc_lut.launches.reset()
        lat, hits = [], []
        for qv in queries:
            t0 = time.perf_counter()
            hits.append(search(qv))
            lat.append(time.perf_counter() - t0)
        launches = ads.launches.count
        lut_launches = adc_lut.launches.count
        ann_searches = executor.knn_path_stats["ann"] - ann0
        # where a search's time goes: device kernels under the profiler, on
        # 16 more searches after the counted window
        prof_q = iter(queries)
        prof = device_profile(lambda: search(next(prof_q)), 16)
        (shard,) = node.indices[name].shards.values()
        segments = shard.acquire_searcher().segments
        if len(segments) != 1 or segments[0][1].vector_fields["v"].ann is None:
            raise AssertionError(f"[{name}] is not one IVF-PQ segment")
        for i, got in enumerate(hits):
            check_hits(f"[{name}] query {i}", got, plain_shard_hits(
                ads, ivfpq, kf, segments, queries[i], 10, dev))
        filtered = ann_filtered_check(node, name, kf, ads, data, attrs,
                                      queries[:16], dev, rng)

        # the second refresh: 64 of its docs sit next to the 16 queries, so
        # the exact segment places hits beside the IVF-PQ one
        n_small, mixed_q = 300, queries[:16]
        extra = (data[rng.choice(n, n_small, replace=False)]
                 + 0.1 * rng.standard_normal((n_small, ANN_DIM)).astype(
                     np.float32))
        extra[:64] = np.repeat(mixed_q, 4, axis=0) + 0.05 * \
            rng.standard_normal((64, ANN_DIM)).astype(np.float32)
        resp = node.bulk([
            ("index", {"_index": name, "_id": str(n + i)},
             {"v": extra[i].tolist()}) for i in range(n_small)
        ], refresh=True)
        if resp["errors"]:
            raise AssertionError(f"bulk into [{name}] reported errors")
        segments = shard.acquire_searcher().segments
        if len(segments) != 2 or segments[1][1].vector_fields["v"].ann \
                is not None:
            raise AssertionError(f"[{name}] is not an IVF-PQ segment beside "
                                 f"an exact one")
        paths0 = dict(executor.knn_path_stats)
        ads.launches.reset()
        kf.launches.reset()
        mixed_hits = [search(qv) for qv in mixed_q]
        mixed = {"k1_launches": kf.launches.count,
                 "k2_launches": ads.launches.count,
                 **{key: executor.knn_path_stats[key] - paths0[key]
                    for key in ("ann", "fused")}}
        for i, got in enumerate(mixed_hits):
            check_hits(f"[{name}] two segments, query {i}", got,
                       plain_shard_hits(ads, ivfpq, kf, segments, mixed_q[i],
                                        10, dev))
        mixed["exact_hits"] = sum(int(h[0]) >= n for got in mixed_hits
                                  for h in got)
        # K1 against its plain pool on the exact segment's own operands
        dseg1 = segments[1][1]
        vf1 = dseg1.vector_fields["v"]
        q = torch.from_numpy(executor._pad_query_batch([mixed_q[0]])).to(dev)
        args, r = scan_inputs(kf, vf1.vectors[None], vf1.norms_sq[None],
                              (vf1.present & dseg1.live)[None], q, 16, "fp32")
        compare_pools(kf, args, r, "cosine", "fp32",
                      f"K1 on the exact segment (n_pad={dseg1.n_pad})")
        # k = 256: past FUSED_MAX_K the 300-doc segment materializes
        paths0 = dict(executor.knn_path_stats)
        k256_hits = [search(qv, 256) for qv in mixed_q]
        mixed["k256"] = {key: executor.knn_path_stats[key] - paths0[key]
                         for key in ("ann", "fused", "materializing",
                                     "streaming")}
        if mixed["k256"] != {"ann": 16, "fused": 0, "materializing": 16,
                             "streaming": 0}:
            raise AssertionError(f"two-segment k=256 branches: {mixed}")
        for i, got in enumerate(k256_hits):
            check_hits(f"[{name}] two segments k=256, query {i}", got,
                       plain_shard_hits(ads, ivfpq, kf, segments, mixed_q[i],
                                        256, dev)[:10])
        log(f"[{name}] two segments, k=256: 16 searches equal the plain "
            f"pipeline; the exact segment materialized each time")
        batch = ann_batch_check(ads, ivfpq, segments[0], queries, dev)
        concurrent = concurrent_phase(
            node, name, queries, 10,
            {"adc_scan": ads.launches, "knn_fused": kf.launches})
        node.close()
    # recall@10 against exact cosine brute force (reported, not gated)
    dn = torch.from_numpy(data).to(dev)
    dn = dn / torch.clamp(torch.linalg.norm(dn, dim=1, keepdim=True), 1e-12)
    qn = torch.from_numpy(queries).to(dev)
    qn = qn / torch.clamp(torch.linalg.norm(qn, dim=1, keepdim=True), 1e-12)
    truth = torch.topk(qn @ dn.T, 10).indices.cpu()
    recall = float(np.mean([
        len({int(h[0]) for h in got} & set(truth[i].tolist())) / 10
        for i, got in enumerate(hits)]))
    lat_ms = np.asarray(lat) * 1e3
    out = {"launches": launches, "searches": ann_searches, "recall": recall,
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "qps": 64 / sum(lat), "mixed": mixed, "concurrent": concurrent,
           "filtered": filtered, "batch": batch,
           "lut_launches": lut_launches}
    log(f"[{name}] 64 searches equal the plain pipeline; recall@10 vs exact "
        f"cosine = {recall:.4f}; p50 {out['p50_ms']:.3f} ms, p99 "
        f"{out['p99_ms']:.3f} ms, QPS {out['qps']:.1f}")
    if prof is not None:
        # idle share against the unprofiled mean wall of a search: the
        # profiler itself slows the host
        out["device_ms"] = prof["device_ms"]
        out["idle_share"] = max(0.0, 1.0 - prof["device_ms"]
                                / float(lat_ms.mean()))
        log(f"[{name}] device time of a search {prof['device_ms']:.4f} ms "
            f"(wall {prof['wall_ms']:.3f} ms under the profiler, "
            f"{lat_ms.mean():.3f} ms without): idle share "
            f"{out['idle_share']:.4f}; top kernels {prof['top']}")
    if ann_searches != 64:
        raise AssertionError(f"{ann_searches} of 64 searches took the ANN "
                             f"branch")
    if launches < 64:
        raise AssertionError(f"K2 launched {launches} times in 64 searches")
    if lut_launches != launches:
        raise AssertionError(f"the LUT kernel launched {lut_launches} times "
                             f"beside {launches} K2 launches")
    log(f"ANN main path: {ann_searches} ANN searches, {launches} K2 launches")
    if (mixed["ann"], mixed["fused"]) != (16, 16) or min(
            mixed["k1_launches"], mixed["k2_launches"]) < 16:
        raise AssertionError(f"two-segment searches: {mixed}")
    if mixed["exact_hits"] == 0:
        raise AssertionError("no hit of the two-segment searches came from "
                             "the exact segment")
    log(f"two-segment shard: 16 searches equal the plain pipeline, "
        f"{mixed}")
    return out


def large_kernels(kf, dev, seed: int, entry: dict, large_mma_entry: dict,
                  select_entry: dict) -> None:
    """K1's large-r checks (both scans, the select's stress rows) into the
    kernels record."""
    entry["max_abs_err"] = max(entry["max_abs_err"] or 0.0,
                               large_kernel_phase(kf, dev, seed))
    large_mma_entry["max_abs_err"] = large_mma_kernel_phase(kf, dev, seed)
    large_mma_entry["parity"] = ("int8 bit-equal; bf16 bit-equal on exact "
                                 "sums, ids equal but at logged summation "
                                 "ties on floats")
    rows = select_stress_check(kf, dev, seed)
    select_entry["max_abs_err"] = 0.0
    select_entry["parity"] = (f"bit-equal, both sorts and the yardstick: to "
                              f"the tier's pool at every large-r check, to "
                              f"plain_large_select on {rows} stress rows")


def large_records(kf, dev, seed: int, entry: dict, large_mma_entry: dict,
                  select_entry: dict) -> None:
    """K1's large-r records (both scans, the select) into the kernels
    record."""
    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    large = large_timing(kf, dev, seed)
    entry["large_shapes"] = large
    lm = large_mma_timing(kf, dev, seed)
    large_mma_entry.update({key: lm[LARGE_MMA_HEADLINE][key] for key in
                            (*fields, "device_ms", "scan_device_ms",
                             "select_device_ms")})
    large_mma_entry["shape"] = LARGE_MMA_HEADLINE
    large_mma_entry["serving_shapes"] = lm
    head = large[LARGE_SELECT_HEADLINE]
    sort = head["sort"]
    select_entry.update({
        "ms": head["select_ms"][sort],
        "device_ms": head["select_device"][sort],
        "plain_ms": head["select_plain_ms"],
        "bound_ms": head["select_bound_ms"],
        "bound_by": head["select_bound_by"],
        "library_ms": head["select_library_ms"],
        "yardstick_ms": head["yardstick_ms"],
        "yardstick_device_ms": head["yardstick_device_ms"],
        "sort": sort, "shape": LARGE_SELECT_HEADLINE + " fp32"})
    select_entry["serving_shapes"] = {
        label: {key: rec[key] for key in
                ("sort", "select_ms", "select_device", "select_device_ms",
                 "yardstick_ms", "yardstick_device_ms", "select_plain_ms",
                 "select_library_ms", "select_bound_ms")}
        for label, rec in {**large, **lm}.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="kernel,timing,main")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="limit the kernel and timing phases to these "
                         f"kernels (default: all of {','.join(KERNELS)})")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    chosen = set(args.kernels.split(","))
    if not chosen <= set(KERNELS):
        ap.error(f"unknown kernels {sorted(chosen - set(KERNELS))}")
    family_names = [name for name in FAMILY if name in chosen]
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is false")
        return 2
    from opensearch_tpu_torch.ops import adc_scan as ads
    from opensearch_tpu_torch.ops import cuda_lib, ivfpq
    from opensearch_tpu_torch.ops import knn_blocks as kb
    from opensearch_tpu_torch.ops import knn_fused as kf
    from opensearch_tpu_torch.ops import knn_rescore as kr

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(cuda_lib.build, KERNELS))
    log(f"built {', '.join(KERNELS)} in {time.perf_counter() - t0:.1f} s")
    # wall seconds of each phase, logged at the end
    phase_s = {"build": time.perf_counter() - t0}

    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    designs = {"lists": "opensearch_tpu_torch/csrc/knn_pool.cuh: the list "
                        "scan (kernels knn_pool_scan_kernel, "
                        "knn_pool_merge_kernel), fp32 with r <= 32",
               "wide": "opensearch_tpu_torch/csrc/knn_wide.cuh: the list "
                       "scan's wide tier (kernels knn_wide_scan_kernel, "
                       "knn_wide_merge_kernel), fp32 with 32 < r <= 1024",
               "mma": "opensearch_tpu_torch/csrc/knn_wide_mma.cuh: the wide "
                      "tier's tensor-core scan (kernels "
                      "knn_wide_mma_scan_kernel, knn_wide_merge_kernel), "
                      "bf16 and int8 with r <= 1024",
               "large": "opensearch_tpu_torch/csrc/knn_large.cuh: the "
                        "large-r tier (kernel knn_large_scan_kernel, then "
                        "the multi-CTA select: knn_large_pass_kernel, "
                        "knn_large_collect_kernel, knn_large_tile_kernel "
                        "and knn_large_merge_kernel or knn_large_rank_kernel "
                        "and knn_large_place_kernel), fp32 with r > 1024",
               "large_mma": "opensearch_tpu_torch/csrc/knn_large_mma.cuh: "
                            "the large-r tier's tensor-core scan (kernel "
                            "knn_large_mma_scan_kernel, then the same "
                            "select), bf16 and int8 with r > 1024",
               "tile": "opensearch_tpu_torch/csrc/knn_tile.cuh: the tile "
                       "scan (knn_scan_kernel, knn_merge_kernel): no shape, "
                       "the yardstick timed beside the designs"}
    entry = {"name": "knn_fused", "route": "cuda",
             "source": "opensearch_tpu_torch/csrc/knn_fused.cu",
             "designs": designs,
             "replaces": "opensearch_tpu/ops/pallas_knn.py:785 "
                         "(pallas_knn_fused -> _knn_fused_kernel :675)",
             "launches": None, "parity": None, "max_abs_err": None,
             "ms": None, "plain_ms": None, "bound_ms": None,
             "bound_by": None, "library_ms": None}
    entry2 = {"name": "adc_scan", "route": "cuda",
              "source": "opensearch_tpu_torch/csrc/adc_scan.cu",
              "replaces": "opensearch_tpu/ops/pallas_adc.py:234 "
                          "(pallas_adc_topr -> _adc_scan_kernel :78)",
              "launches": None, "parity": None, "max_abs_err": None,
              "ms": None, "plain_ms": None, "bound_ms": None,
              "bound_by": None, "library_ms": None,
              "library_note": "none: no single PyTorch call computes an "
                              "ADC top-R over probed inverted lists"}
    family = {
        name: {"name": name, "route": "cuda",
               "source": f"opensearch_tpu_torch/csrc/{name}.cu",
               "replaces": replaces, "launches": None, "parity": None,
               "max_abs_err": None, "ms": None, "plain_ms": None,
               "bound_ms": None, "bound_by": None, "library_ms": None}
        for name, replaces in (
            ("knn_block", "opensearch_tpu/ops/pallas_knn.py:181 "
                          "(pallas_knn_topk -> _knn_block_kernel :53)"),
            ("knn_pb", "opensearch_tpu/ops/pallas_knn.py:325 "
                       "(pallas_knn_blocktopk -> _knn_pb_kernel :236)"),
            ("knn_sbmax", "opensearch_tpu/ops/pallas_knn.py:446 "
                          "(pallas_knn_sbmax_topk -> _knn_sbmax_kernel :383)"))
    }
    rescore_entries = {
        name: {"name": name, "route": "cuda",
               "source": "opensearch_tpu_torch/csrc/knn_rescore.cu",
               "replaces": "none (no Pallas kernel): the batched torch.einsum "
                           "of the exact fp32 rescore, "
                           "opensearch_tpu_torch/ops/knn_fused.py "
                           "_fused_rescore (XLA's gather and einsum in "
                           "opensearch_tpu/ops/pallas_knn.py knn_fused), and "
                           "the row sum of |q|^2",
               "launches": None, "parity": None, "max_abs_err": None,
               "ms": None, "plain_ms": None, "bound_ms": None,
               "bound_by": None, "library_ms": None}
        for name in ("knn_rescore", "knn_query_sq")}
    # the large-r tier's tensor-core scan (a K1 design, listed on its own
    # line too) and the IVF-PQ LUT kernel (no Pallas counterpart)
    large_mma_entry = {
        "name": "knn_large_mma", "route": "cuda",
        "source": "opensearch_tpu_torch/csrc/knn_large_mma.cuh (built in "
                  "knn_fused.cu)",
        "replaces": "opensearch_tpu/ops/pallas_knn.py:785 (pallas_knn_fused "
                    "-> _knn_fused_kernel :675) at bf16 and int8, r > 1024",
        "launches": None, "parity": None, "max_abs_err": None, "ms": None,
        "plain_ms": None, "bound_ms": None, "bound_by": None,
        "library_ms": None}
    # the large-r tier's multi-CTA select (a K1 stage behind both large-r
    # scans, listed on its own line; the earlier one-CTA select, its
    # yardstick, timed beside it)
    select_entry = {
        "name": "knn_large_select", "route": "cuda",
        "source": "opensearch_tpu_torch/csrc/knn_large.cuh (built in "
                  "knn_fused.cu): knn_large_pass_kernel, "
                  "knn_large_collect_kernel, knn_large_tile_kernel, "
                  "knn_large_merge_kernel, knn_large_rank_kernel, "
                  "knn_large_place_kernel",
        "replaces": "opensearch_tpu/ops/pallas_knn.py:785 (pallas_knn_fused "
                    "-> _knn_fused_kernel :675) at r > 1024: the running "
                    "top-R's selection, behind the large-r scans",
        "launches": None, "parity": None, "max_abs_err": None, "ms": None,
        "plain_ms": None, "bound_ms": None, "bound_by": None,
        "library_ms": None,
        "library_note": "torch.topk over the keys' f32 scores (decoded "
                        "before timing)"}
    lut_entry = {
        "name": "adc_lut", "route": "cuda",
        "source": "opensearch_tpu_torch/csrc/adc_lut.cu",
        "replaces": "none (no Pallas kernel): the batched torch.einsum LUT "
                    "build of opensearch_tpu_torch/ops/ivfpq.py "
                    "lut_for_probes (XLA's in opensearch_tpu/ops/ivfpq.py "
                    "lut_for_probes)",
        "launches": None, "parity": None, "max_abs_err": None, "ms": None,
        "plain_ms": None, "bound_ms": None, "bound_by": None,
        "library_ms": None,
        "library_note": "none: no single PyTorch call builds residual PQ "
                        "lookup tables; einsum_ms is the build it replaced"}
    rescore_entries["knn_rescore"]["library_note"] = (
        "none: no single PyTorch call gathers, dots, transforms and masks "
        "the candidates; einsum_ms is the rescore it replaced")
    family["knn_block"]["designs"] = {
        "lists": designs["lists"].replace("r <= 32", "k <= 32"),
        "wide": designs["wide"].replace("32 < r", "32 < k")}
    if "kernel" in phases:
        t0 = time.perf_counter()
        if "knn_fused" in chosen:
            entry["max_abs_err"] = max(kernel_phase(kf, dev, args.seed),
                                       lists_kernel_phase(kf, dev, args.seed),
                                       mma_kernel_phase(kf, dev, args.seed))
            entry["parity"] = "ok"
        if chosen & {"knn_fused", "knn_block"}:
            wide_err = wide_kernel_phase(kf, kb, dev, args.seed,
                                         "knn_fused" in chosen,
                                         "knn_block" in chosen)
            if "knn_fused" in chosen:
                entry["max_abs_err"] = max(entry["max_abs_err"], wide_err)
        if "knn_fused" in chosen:
            large_kernels(kf, dev, args.seed, entry, large_mma_entry,
                          select_entry)
        if "adc_lut" in chosen:
            lut_check = lut_kernel_phase(dev, args.seed)
            lut_entry["max_abs_err"] = lut_check["max_abs_err"]
            lut_entry["parity"] = "bit-equal"
            lut_entry["probe_rows_differ"] = lut_check["probe_rows_differ"]
        if "knn_rescore" in chosen:
            differ = rescore_kernel_phase(kr, dev, args.seed)
            for e in rescore_entries.values():
                e["parity"] = ("bit-equal" if differ == 0 else
                               f"bit-equal but {differ} float slots within "
                               f"the f32 bound")
                e["max_abs_err"] = 0.0
        if "adc_scan" in chosen:
            entry2["max_abs_err"] = adc_kernel_phase(ads, ivfpq, dev,
                                                     args.seed)
            entry2["parity"] = "ok"
        errs = {}
        if "knn_block" in chosen:
            errs["knn_block"] = max(blocks_kernel_phase(kb, dev, args.seed),
                                    wide_err)
        if "knn_pb" in chosen:
            errs["knn_pb"] = pb_kernel_phase(kb, dev, args.seed)
        if "knn_sbmax" in chosen:
            errs["knn_sbmax"] = sbmax_kernel_phase(kb, dev, args.seed)
        for name, e in errs.items():
            family[name]["parity"] = "bit-equal"
            family[name]["max_abs_err"] = e
        phase_s["kernel"] = time.perf_counter() - t0
    if "timing" in phases:
        t0 = time.perf_counter()
        if "knn_fused" in chosen:
            t = timing_phase(kf, dev, args.seed)
            entry.update(t.pop(1))
            entry["shape"] = "n=1000000 d=128 fp32 l2 k=10 B=1"
            entry["b32"], entry["b128"] = t.pop(32), t.pop(128)
            entry["serving_shapes"] = t
        if "adc_scan" in chosen:
            t2 = adc_timing_phase(ads, ivfpq, dev, args.seed)
            glove, cell_c = t2["glove"], t2["cell_c"]
            stages = ("device_ms", "stage1_device_ms", "stage2_device_ms")
            entry2.update({key: glove[1][key] for key in (*fields, *stages)})
            entry2["shape"] = (f"glove-100: n={GLOVE_DOCS} d={ANN_DIM} "
                               f"cosine nlist=512 m={ANN_M} nprobe=8 "
                               f"l_pad={glove['l_pad']} fp32 R=64 B=1")
            entry2["build_s"] = glove["build_s"]
            entry2["b32"] = {key: glove[32][key] for key in (*fields, *stages)}
            entry2["serving_shapes"] = {
                f"cell_c n={ANN_MAIN_DOCS} l_pad={cell_c['l_pad']} B={b}": {
                    key: cell_c[b][key] for key in (*fields, *stages)}
                for b in (1, 8)}
        if "knn_fused" in chosen:
            large_records(kf, dev, args.seed, entry, large_mma_entry,
                          select_entry)
        if "adc_lut" in chosen:
            lt = lut_timing(dev, args.seed)
            lut_entry.update({key: lt["lut B=1"][key] for key in
                              (*fields, "einsum_ms", "device_ms",
                               "einsum_device_ms")})
            lut_entry["shape"] = ("glove-100 / cell C: nlist=512 d=100 m=20 "
                                  "ks=256 P=8 B=1")
            lut_entry["serving_shapes"] = lt
        if "knn_rescore" in chosen:
            rt = rescore_timing(kf, kr, dev, args.seed)
            rescore_entries["knn_rescore"].update(
                {key: rt["rescore B=1 R=40"][key] for key in
                 (*fields, "einsum_ms", "device_ms", "einsum_device_ms")})
            rescore_entries["knn_rescore"]["shape"] = (
                "cell A: n=200000 in 262144 slots d=128 l2 B=1 R=40 (bf16 "
                "k=10)")
            rescore_entries["knn_rescore"]["serving_shapes"] = {
                key: t for key, t in rt.items() if key.startswith("rescore")}
            rescore_entries["knn_query_sq"].update(
                {key: rt["query_sq B=1"][key] for key in
                 (*fields, "device_ms")})
            rescore_entries["knn_query_sq"]["shape"] = "B=1 d=128"
            rescore_entries["knn_query_sq"]["serving_shapes"] = {
                key: t for key, t in rt.items() if key.startswith("query_sq")}
        if chosen & {"knn_fused", "knn_block"}:
            wide = wide_timing_phase(kf, kb, dev, args.seed,
                                     "knn_fused" in chosen,
                                     "knn_block" in chosen)
            entry["wide_shapes"] = {key: t for key, t in wide.items()
                                    if key.startswith("K1")}
            family["knn_block"]["wide_shapes"] = {
                key: t for key, t in wide.items() if key.startswith("K3")}
        t3 = blocks_timing_phase(kb, dev, args.seed, family_names) \
            if family_names else {}
        for name, t3n in t3.items():
            e = family[name]
            e["launches"] = t3n["launches"]
            e["max_abs_err"] = max(e["max_abs_err"] or 0.0, t3n["stage1_err"])
            e.update(t3n[1])
            e["shape"] = "SIFT-1M: n=1000000 d=128 fp32 l2 k=10 B=1"
            if "stage2_launches" in t3n:
                # K4's and K5's stage 2 is a second kernel, counted apart
                e["stage2_launches"] = t3n["stage2_launches"]
            for b in (32, 128):
                if b in t3n:
                    e[f"b{b}"] = t3n[b]
        phase_s["timing"] = time.perf_counter() - t0
    if "large" in phases:
        # the large-r tier's checks and records alone (the quick loop)
        t0 = time.perf_counter()
        large_kernels(kf, dev, args.seed, entry, large_mma_entry,
                      select_entry)
        large_records(kf, dev, args.seed, entry, large_mma_entry,
                      select_entry)
        phase_s["large"] = time.perf_counter() - t0
    if "main" in phases:
        t0 = time.perf_counter()
        main = main_path_phase(kf, dev, args.seed)
        entry["launches"] = main["launches"]
        entry["list_launches"] = main["list_launches"]
        entry["ingest_s"] = main["ingest_s"]
        # the stacked step past r = 1024: each search's K1 launches,
        # counted from 0, all on the large-r tier
        entry["large_main_path"] = main["large"]
        entry["large_launches"] = sum(
            res["launches"]["knn_fused_large"] for res in main["large"].values())
        large_mma_entry["launches"] = sum(
            res["launches"].get("knn_fused_large_mma", 0)
            for res in main["large"].values())
        select_entry["launches"] = sum(
            res["launches"]["knn_large_select"]
            for res in main["large"].values())
        # filtered kNN on both routes: each run's launches counted from 0
        entry["filtered_main_path"] = main["filtered"]
        entry["stacked_batch"] = main["batched"]
        entry["msearch_main_path"] = main["msearch"]
        # kNN _search over HTTP (rest/http.py) on cell A: each run's K1
        # launches counted from 0
        entry["rest_main_path"] = main["rest"]
        rescore_entries["knn_query_sq"]["launches"] = \
            main["query_sq_launches"]
        rescore_entries["knn_rescore"]["launches"] = sum(
            res[path]["launches"]["knn_rescore"]
            for res in main["reduced"].values()
            for path in ("stacked", "per_shard"))
        entry["main_path_step_ms"] = main["step_ms"]
        entry["main_path_step_device"] = main["step_device"]
        # index A at k = 100: the stacked step and the per-shard route, each
        # path's K1 launches counted from 0 (all on the wide tier)
        entry["wide_main_path"] = main["wide"]
        entry["wide_launches"] = {
            path: main["wide"][path]["launches"]["knn_fused_wide"]
            for path in ("stacked", "per_shard")}
        entry["wide_launches"]["concurrent"] = \
            main["wide"]["concurrent"]["launches"]["knn_fused_wide"]
        # index A at bf16 and int8, k = 10 and 100: each path's K1 launches
        # counted from 0 (all on the tensor-core tier)
        entry["reduced_main_path"] = main["reduced"]
        entry["mma_launches"] = {
            key: {"stacked": res["stacked"]["launches"]["knn_fused_mma"],
                  "per_shard": res["per_shard"]["launches"]["knn_fused_mma"],
                  "gated": res["concurrent"]["gated"]["launches"][
                      "knn_fused_mma"]}
            for key, res in main["reduced"].items()}
        ann = ann_main_phase(ads, ivfpq, kf, dev, args.seed)
        entry2["launches"] = ann["launches"]
        lut_entry["launches"] = ann["lut_launches"]
        entry2["ann_batch"] = ann["batch"]
        entry2["main_path"] = {key: ann[key] for key in
                               ("searches", "recall", "p50_ms", "p99_ms",
                                "qps", "device_ms", "idle_share")
                               if key in ann}
        # K1 and K2 launches of the 16 searches over an IVF-PQ segment and
        # an exact one (the per-shard route's exact branch)
        entry["launches_two_segment"] = ann["mixed"]["k1_launches"]
        entry2["launches_two_segment"] = ann["mixed"]["k2_launches"]
        # the per-shard route: index A at k = 256 (streaming) and under 8
        # concurrent threads (K1 through the batcher), index C concurrent
        entry["per_shard_route"] = main["per_shard"]
        entry2["concurrent"] = ann["concurrent"]
        entry["filtered_ann_index"] = ann["filtered"]
        phase_s["main"] = time.perf_counter() - t0
    elif "filtered" in phases:
        t0 = time.perf_counter()
        fp = filtered_phase(kf, dev, args.seed)
        entry["filtered_main_path"] = fp["filtered"]
        entry["stacked_batch"] = fp["batched"]
        entry["msearch_main_path"] = fp["msearch"]
        entry["large_main_path"] = fp["large"]
        large_mma_entry["launches"] = sum(
            res["launches"].get("knn_fused_large_mma", 0)
            for res in fp["large"].values())
        select_entry["launches"] = sum(
            res["launches"]["knn_large_select"]
            for res in fp["large"].values())
        phase_s["filtered"] = time.perf_counter() - t0
    elif "rest" in phases:
        t0 = time.perf_counter()
        entry["rest_main_path"] = rest_phase(kf, dev, args.seed)
        phase_s["rest"] = time.perf_counter() - t0
    if phases & {"main", "hybrid"}:
        t0 = time.perf_counter()
        hybrid = hybrid_main_phase(dev, args.seed)
        log(f"hybrid program record: {json.dumps(hybrid)}")
        phase_s["hybrid"] = time.perf_counter() - t0
    log(f"phase wall seconds: {json.dumps(phase_s)}")
    print(json.dumps({"kernels": [entry, large_mma_entry, select_entry,
                                  entry2, lut_entry,
                                  *family.values(),
                                  *rescore_entries.values()]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
