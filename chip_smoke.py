"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N] [--phases kernel,timing,main]
                          [--kernels knn_fused,adc_scan,knn_block,knn_pb,knn_sbmax]

Builds the port's five CUDA kernels from the sources in this checkout (one
nvcc per source, all started together): K1 (csrc/knn_fused.cu, fused exact
kNN: the list scan of csrc/knn_pool.cuh at fp32 with r <= 32, the tile scan
of csrc/knn_tile.cuh otherwise), K2 (csrc/adc_scan.cu, the IVF-PQ ADC scan) and the exact-scan family
K3 (csrc/knn_block.cu, running top-k), K4 (csrc/knn_pb.cu: per-block top-k,
then the block-major merge, two kernels) and K5 (csrc/knn_sbmax.cu:
sub-block maxima, then the selection and rescore, two kernels). ``--kernels`` limits the kernel and timing phases to
the named kernels (default all five; the main phase needs K1 and K2).
Then:

1. kernel: holds each kernel against its plain PyTorch version on the card.
   K1: fp32, bf16 and int8 x l2, cosine and dot (n = 50,000, d = 128,
   B = 16, k = 10, 3% dead docs, planted duplicate vectors), and at the
   shapes the main path gives it. int8 pools must be bit-equal; fp32 and
   bf16 ids equal, scores within rtol 1e-5 / atol 2e-3: the two sum the d
   products in another order (at B = 1 PyTorch's product reduces as a
   tree), and for a near neighbour l2's |q|^2 - 2 q.v + |v|^2 cancels, so
   each ulp of a dot near |q|^2 ~ 2,000 (2.4e-4) reaches the score almost
   whole. K1's list scan (lists_kernel_phase) on sixteenths, bit for bit
   with its planted ties in id order: one shard of 300,001 docs at B = 1,
   5, 8, 9, 32, 33, 128 and 129 x r = 1, 10 and 32 (and 33, the tile scan),
   four shards of 200,000 (one with 5 live docs), d = 30 and 768, operands
   off a 16-byte boundary; then on clustered floats, ids equal but at near
   ties (scores within a relative 1e-5, ranked the other way by the other
   summation order) and scores within rtol 1e-5 / atol 2e-3.
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
   k = 10 and 32 (the list scan) and 100 (the tile scan), l2, cosine and
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
   max(bytes / 3.35 TB/s, 2*B*n*d / 67 TFLOP/s). K2 at the
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
   200,000 clustered 128-d docs) and index B (4 shards, 20,000 docs), 64
   knn searches each; every hit list must equal the brute-force truth in
   the same order, every search must go through the stacked serving path
   and K1's list scan (its counter), whose step is timed (200 steps) and
   profiled by kernel name. Then index A on the per-shard route (distributed_serving off):
   32 searches at k = 256, size = 10 must equal the brute force and each
   take the streaming scan, and 64 searches from 8 threads (K1 through the
   dispatch batcher) must equal the same searches run one at a time; in
   the gated run (each round of 8 released together, a 50 ms batch
   window) with a mean merged batch above 1 and fewer K1 launches than
   searches, every K1 launch on the list scan.
   ANN (K2): index C (1 shard, 200,000 clustered 100-d docs, cosine,
   ivf_pq nlist 512, m 20, nprobe 8; cut from 1.2M by host ingest), 64 knn
   searches, k = 10; every hit list must equal the plain pipeline
   (adc_topr_auto impl="xla") on the same index and probes, every search
   must take the per-shard ANN branch and launch K2. Recall@10 against
   exact cosine brute force is printed, not gated. Then a second refresh
   adds 300 docs (below min_train, so an exact segment) and 16 searches
   over both segments must equal the plain pipeline and launch K2 and K1
   (the per-shard route's exact branch) each time; 16 more at k = 256 must
   take the materializing scan on the small segment and equal the plain
   pipeline; and the 64 searches from 8 threads must equal the solo ones,
   with fewer K2 and K1 launches than searches in the gated run. Each
   8-thread run is repeated free-running under the default batch window
   (measured, not gated) and with the batcher off; p50, p99 and QPS are
   printed solo, concurrent and concurrent without the batcher.

Prints the card's name and power limit, one JSON line of kernel numbers,
and last `{"ok": true, "device": {...}}`; logs each phase's wall seconds. Exits non-zero, with no result
line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import argparse
import json
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
DIM = 128
ANN_DIM = 100                 # glove-100
ANN_M = 20
K2_PARITY_DOCS = 100_000      # K2 kernel phase build
GLOVE_DOCS = 1_200_000        # K2 timing phase (the glove-100 corpus size)
SIFT_DOCS = 1_000_000         # K3-K5 timing phase (the SIFT-1M corpus size)
ANN_MAIN_DOCS = 200_000       # index C (cut from 1.2M by host ingest)
KERNELS = ("knn_fused", "adc_scan", "knn_block", "knn_pb", "knn_sbmax")
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
            kernels[evt.key[:60]] = us / 1e3 / reps
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


def lists_case(dev, rng, s: int, n: int, d: int, integer: bool = True):
    """Operands of K1's list scan: s shards of n docs of width d
    (sixteenths, or clustered floats when not `integer`), 3% dead docs,
    LIST_COPIES and LIST_RUN planted in every shard and live; with four
    shards the last keeps 5 live docs, fewer than r. Returns (shard 0's
    data, v, norms, valid)."""
    data = (sixteenths if integer else clustered)(rng, s * n, d).reshape(
        s, n, d)
    data[:, list(LIST_COPIES)] = data[:, LIST_COPIES[:1]]
    data[:, list(LIST_RUN)] = data[:, LIST_RUN[:1]]
    valid = rng.random((s, n)) >= 0.03
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


def lists_check(kf, v, nrm, ok, q, r: int, sim: str, what: str,
                bits: bool) -> float:
    """One pool scan at fp32 against plain_pool: on sixteenths (`bits`) ids
    equal and values bit-equal, the planted copies first in id order for
    l2 and cosine; on float data ids equal but at near ties
    (near_tie_swaps), scores within rtol 1e-5 / atol 2e-3. The list scan
    must have served it exactly when r <= 32 (the tile scan above)."""
    qsq = (q * q).sum(dim=1)
    one = torch.ones(v.shape[0], device=v.device)
    before = kf.list_launches.count
    args = (v, nrm, ok, q, qsq, one)
    if bits:
        err = compare_pools(kf, args, r, sim, "fp32", what, bits=True)
    else:
        kv, ki = kf.pool_scan(*args, r=r, similarity=sim,
                              score_precision="fp32")
        pv, pi = kf.plain_pool(*args, r=r, similarity=sim,
                               score_precision="fp32")
        torch.cuda.synchronize()
        swaps = near_tie_swaps(kf, kv, ki, pv, pi, args, sim, what)
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
    want = 1 if r <= kf.LIST_MAX_R else 0
    if kf.list_launches.count - before != want:
        raise AssertionError(f"{what}: the list scan launched "
                             f"{kf.list_launches.count - before} times, "
                             f"want {want}")
    if bits and sim != "dot_product" and r >= 2:
        kv, ki = kf.pool_scan(v, nrm, ok, q, qsq, one, r=r, similarity=sim,
                              score_precision="fp32")
        if ki[0, 0, :2].tolist() != list(LIST_COPIES):
            raise AssertionError(f"{what}: planted tie gave "
                                 f"{ki[0, 0, :2].tolist()}")
        if q.shape[0] > 1 and ki[0, 1].tolist() != list(LIST_RUN[:r]):
            raise AssertionError(f"{what}: planted run gave "
                                 f"{ki[0, 1].tolist()}")
    return err


def lists_kernel_phase(kf, dev, seed: int) -> float:
    """K1's list scan (fp32, r <= 32) against plain_pool on the card, the
    tile scan at r = 33 beside it. Sixteenths (every dot exact in f32, so
    values and ids bit-equal, the planted ties in id order): one shard of
    n = 300,001 (a ragged tail; LIST_COPIES straddle a range edge at
    B <= 8) at B = 1, 5, 8, 9, 32, 33, 128 and 129 (query tiles 8, 32 and
    128, full and partial, and two 128-query tiles) x r = 1, 10 and 32 in
    l2, cosine and dot at r = 10, and r = 33; four shards of 200,000 (the
    last with 5 live docs) at B = 1, 8 and 33 x r = 10 and 32; d = 30 and
    768 (the two-stage ring at r = 32) at B = 1, 9 and 129; operands 4
    bytes off a 16-byte boundary. Then clustered floats: scores within
    rtol 1e-5 / atol 2e-3 and ids equal but at near ties held to their f64
    scores (near_tie_swaps), at B = 1, 8, 32 and 128 in the three
    similarities, and over four shards. Returns the max |dv|."""
    rng = np.random.default_rng(seed + 30)
    err = 0.0
    cases = (
        (1, 300_001, DIM, True, (1, 5, 8, 9, 32, 33, 128, 129),
         ((1, "l2_norm"), (10, "l2_norm"), (32, "l2_norm"), (10, "cosine"),
          (10, "dot_product"), (33, "l2_norm"))),
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
        if s == 1 and d == DIM and integer and n == 300_001:
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


# the profiler's kernel names of K1's and K3's list scan
LIST_KERNELS = ("knn_pool_scan_kernel", "knn_pool_merge_kernel")


def pool_bound(s: int, n: int, d: int, b: int, r: int) -> dict:
    """The least time of one pool scan: the slab, norms and valid flags read
    once, the queries and |q|^2, the [S, B, r] pools written, over
    3.35 TB/s; against 2*B*S*n*d operations over 67 TFLOP/s."""
    nbytes = s * n * (d * 4 + 4 + 1) + b * (d * 4 + 4) + s * b * r * 8
    flops = 2 * b * s * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
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
    checked against plain_pool first, then timed (time_pool) beside its
    bound (pool_bound)."""
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
            t = time_pool(kf, args, r, q, v, nrm, k, label,
                          plain=n * s * b <= 128_000_000)
            t.update(pool_bound(s, n, DIM, b, r))
            log(f"K1 {label}: bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']})")
            out[b if n == 1_000_000 else label] = t
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
    (three of the tile scan's 16-query tiles, the last one partial) and 129
    (two of the list scan's 128-query tiles), k = 10 and 32 (the list scan)
    and 100 (the tile scan), l2, cosine and dot. The data are sixteenths:
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
                before = kb.block_list_launches.count
                err = max(err, compare_stage1(kb, "knn_block", args, k, sim,
                                              True, what))
                lists = kb.block_list_launches.count - before
                if lists != (1 if k <= kb.LIST_MAX_R else 0):
                    raise AssertionError(f"{what}: {lists} list-scan "
                                         f"launches")
                gv, gi = kb.knn_topk_auto(v, nrm, ok, q, k=k, similarity=sim)
                pv, pi = family_plain(kb, "knn_block", v, nrm, ok, q, k, sim)
                if not (torch.equal(gi, pi[:b]) and torch.equal(gv, pv[:b])):
                    raise AssertionError(f"{what}: entry point differs from "
                                         f"its plain pipeline")
                if sim == "l2_norm" and gi[0, :2].tolist() != [2040, 2053]:
                    raise AssertionError(
                        f"{what}: planted tie gave {gi[0, :2].tolist()}")
        log(f"knn_block parity B={b}: bit-equal over k = 10, 32 (list "
            f"scan), 100 (tile scan) and l2, cosine, dot")
    return err


def unaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x whose data starts 4 bytes past a 16-byte
    boundary: a view the cp.async kernels cannot read as it is."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
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


def _bulk_index(node, name: str, data: np.ndarray, shards: int) -> None:
    node.create_index(name, {
        "settings": {"number_of_shards": shards},
        "mappings": {"properties": {"v": {
            "type": "knn_vector", "dimension": DIM, "similarity": "l2_norm"}}},
    })
    for s in range(0, data.shape[0], 5000):
        resp = node.bulk([
            ("index", {"_index": name, "_id": str(i)}, {"v": data[i].tolist()})
            for i in range(s, min(s + 5000, data.shape[0]))
        ], refresh=False)
        if resp["errors"]:
            raise AssertionError(f"bulk into [{name}] reported errors")
    node.refresh(name)


def main_path_phase(kf, dev, seed: int) -> dict:
    from opensearch_tpu_torch.node import TorchNode
    from opensearch_tpu_torch.search import distributed_serving

    rng = np.random.default_rng(seed + 2)
    corpora = {"sift_a": (clustered(rng, 200_000, DIM), 1),
               "sift_b": (clustered(rng, 20_000, DIM), 4)}
    out = {}
    step_inputs = {}
    truths = {}
    with tempfile.TemporaryDirectory() as tmp:
        node = TorchNode(tmp, device="cuda")
        for name, (data, shards) in corpora.items():
            t0 = time.perf_counter()
            _bulk_index(node, name, data, shards)
            log(f"[{name}] {data.shape[0]} docs, {shards} shard(s): bulk + "
                f"refresh {time.perf_counter() - t0:.1f} s")
        # the counts are read for the searches alone
        searches0 = distributed_serving.stats["distributed_searches"]
        kf.launches.reset()
        kf.list_launches.reset()
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
            _tv, ti = kf.plain_pool(v, nrm, ok, q, (q * q).sum(1),
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
        searches = distributed_serving.stats["distributed_searches"] - searches0
        per_shard = per_shard_exact_phase(node, kf, *truths["sift_a"])
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
    log(f"main path: {searches} served searches, {launches} kernel launches, "
        f"all {list_launches} on K1's list scan (knn_pool.cuh)")
    return {"launches": launches, "list_launches": list_launches,
            "latency_s": out, "step_ms": step_ms,
            "step_device": step_device, "per_shard": per_shard}


def latency_summary(lat_s: list, wall_s: float | None = None) -> dict:
    """p50 and p99 of per-search latencies (ms) and QPS: searches over the
    summed latencies, or over the wall time when searches overlapped."""
    lat_ms = np.asarray(lat_s) * 1e3
    return {"p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "qps": len(lat_s) / (wall_s if wall_s is not None else sum(lat_s))}


def concurrent_phase(node, name: str, queries: np.ndarray, k: int,
                     counters: dict) -> dict:
    """The 64 queries one after another, then the same 64 from 8 threads of
    8 searches each, three times. Every concurrent hit list must equal its
    solo one: ids in order, scores to K1's rtol 1e-5 / atol 2e-3, because a
    batch of B queries goes through PyTorch products (the IVF-PQ LUTs, the
    exact rescore) whose f32 sums the library may order by B, and for a
    near neighbour l2's |q|^2 - 2 q.v + |v|^2 cancels near |q|^2 ~ 2,000.

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
       concurrent numbers from the threads'."""
    def search(qv) -> list:
        resp = node.search(name, {"query": {"knn": {"v": {
            "vector": qv.tolist(), "k": k}}}, "size": 10})
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
            if [h[0] for h in g] != [h[0] for h in s] or not np.allclose(
                    [h[1] for h in g], [h[1] for h in s], rtol=1e-5,
                    atol=2e-3):
                raise AssertionError(f"[{name}] concurrent query {i}: {g} != "
                                     f"solo {s}")
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
           "gated": {"dispatches": gated["dispatches"],
                     "mean_merged_batch": gated["mean_merged_batch"],
                     "max_batch": gated["max_batch"],
                     "launches": gated_launches}}
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


def ann_main_phase(ads, ivfpq, kf, dev, seed: int) -> dict:
    """Index C through TorchNode on the card: 200,000 clustered 100-d docs,
    cosine, ivf_pq (nlist 512, m 20, nprobe 8), 1 shard, 64 searches. Then
    a second refresh of 300 docs (below min_train, so exact) and 16
    searches over the shard's IVF-PQ and exact segments together."""
    from opensearch_tpu_torch.node import TorchNode
    from opensearch_tpu_torch.search import executor

    rng = np.random.default_rng(seed + 12)
    n, name = ANN_MAIN_DOCS, "glove_c"
    data = ann_corpus(rng, n, ANN_DIM)
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
                    "nlist": 512, "m": ANN_M, "nprobe": 8}}}}},
        })
        for s in range(0, n, 5000):
            resp = node.bulk([
                ("index", {"_index": name, "_id": str(i)},
                 {"v": data[i].tolist()})
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
        lat, hits = [], []
        for qv in queries:
            t0 = time.perf_counter()
            hits.append(search(qv))
            lat.append(time.perf_counter() - t0)
        launches = ads.launches.count
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
           "qps": 64 / sum(lat), "mixed": mixed, "concurrent": concurrent}
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
               "tile": "opensearch_tpu_torch/csrc/knn_tile.cuh: the tile "
                       "scan (knn_scan_kernel, knn_merge_kernel), every "
                       "other (precision, r)"}
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
    family["knn_block"]["designs"] = {
        "lists": designs["lists"].replace("r <= 32", "k <= 32"),
        "tile": designs["tile"].replace("every other (precision, r)",
                                        "32 < k <= 1024")}
    if "kernel" in phases:
        t0 = time.perf_counter()
        if "knn_fused" in chosen:
            entry["max_abs_err"] = max(kernel_phase(kf, dev, args.seed),
                                       lists_kernel_phase(kf, dev, args.seed))
            entry["parity"] = "ok"
        if "adc_scan" in chosen:
            entry2["max_abs_err"] = adc_kernel_phase(ads, ivfpq, dev,
                                                     args.seed)
            entry2["parity"] = "ok"
        errs = {}
        if "knn_block" in chosen:
            errs["knn_block"] = blocks_kernel_phase(kb, dev, args.seed)
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
    if "main" in phases:
        t0 = time.perf_counter()
        main = main_path_phase(kf, dev, args.seed)
        entry["launches"] = main["launches"]
        entry["list_launches"] = main["list_launches"]
        entry["main_path_step_ms"] = main["step_ms"]
        entry["main_path_step_device"] = main["step_device"]
        ann = ann_main_phase(ads, ivfpq, kf, dev, args.seed)
        entry2["launches"] = ann["launches"]
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
        phase_s["main"] = time.perf_counter() - t0
    log(f"phase wall seconds: {json.dumps(phase_s)}")
    print(json.dumps({"kernels": [entry, entry2, *family.values()]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
