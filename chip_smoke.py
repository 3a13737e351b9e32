"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N] [--phases kernel,timing,main]

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
per source, all started together), then, for K1 (csrc/knn_fused.cu, fused
exact kNN) and K2 (csrc/adc_scan.cu, the IVF-PQ ADC scan):

1. kernel: holds each kernel against its plain PyTorch version on the card.
   K1: fp32, bf16 and int8 x l2, cosine and dot (n = 50,000, d = 128,
   B = 16, k = 10, 3% dead docs, planted duplicate vectors), and at the
   shapes the main path gives it. int8 pools must be bit-equal; fp32 and
   bf16 ids equal, scores within rtol 1e-5 / atol 2e-3: the two sum the d
   products in another order (at B = 1 PyTorch's product reduces as a
   tree), and for a near neighbour l2's |q|^2 - 2 q.v + |v|^2 cancels, so
   each ulp of a dot near |q|^2 ~ 2,000 (2.4e-4) reaches the score almost
   whole.
   K2: an IVF-PQ build of n = 100,000, d = 100 (nlist 64, m 20), P = 8,
   B = 16, for fp32, bf16 and uint8 LUTs at R = 64 and R = 4096, plus the
   ragged-and-empty synthetic slab and a planted identical-code tie. int8
   pools must be bit-equal; fp32 and bf16 ids equal and scores within
   rtol 1e-6 / atol 1e-6: kernel and plain add the m LUT entries in the same
   order with round-to-nearest f32 adds, so they should agree to the bit;
   the tolerance allows a rounding, never a reordering of candidates.
2. timing: CUDA-event times of each kernel, its plain version and (K1 only)
   a library yardstick, beside the bound, at B = 1 and 32. K1 at the
   SIFT-1M shape (n = 1,000,000, d = 128, f32, l2, k = 10): library is
   torch.topk over the l2-transformed q @ v.T (never called by the port);
   bound max(bytes / 3.35 TB/s, 2*B*n*d / 67 TFLOP/s). K2 at the
   glove-100 shape (1,200,000 x 100-d, cosine, m = 20, nlist = 512,
   nprobe = 8, R = 64), built with the port's ivfpq.build on the card:
   bound max(bytes / 3.35 TB/s, lookups / 67 T/s), both counted from the
   run's probes (adc_bound: each distinct probed list's live codes and mask
   once, the LUTs, the winners' ids, the pool); no single PyTorch call
   computes an ADC top-R, so K2 has no library time.
3. main: drives TorchNode on the card. Exact (K1): index A (1 shard,
   200,000 clustered 128-d docs) and index B (4 shards, 20,000 docs), 64
   knn searches each; every hit list must equal the brute-force truth in
   the same order, every search must go through the stacked serving path
   and K1. ANN (K2): index C (1 shard, 200,000 clustered 100-d docs,
   cosine, ivf_pq nlist 512, m 20, nprobe 8; cut from 1.2M by host
   ingest), 64 knn searches, k = 10; every hit list must equal the plain
   pipeline (adc_topr_auto impl="xla") on the same index and probes, every
   search must take the per-shard ANN branch and launch K2. Recall@10
   against exact cosine brute force is printed, not gated. Then a second
   refresh adds 300 docs (below min_train, so an exact segment) and 16
   searches over both segments must equal the plain pipeline and launch
   K2 and K1 (the per-shard route's exact branch) each time.

Prints the card's name and power limit, one JSON line of kernel numbers,
and last `{"ok": true, "device": {...}}`. Exits non-zero, with no result
line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
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
ANN_MAIN_DOCS = 200_000       # index C (cut from 1.2M by host ingest)
KERNELS = ("knn_fused", "adc_scan")
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
    return {"wall_ms": wall, "device_ms": busy, "top": top}


def scan_inputs(kf, vectors, norms, valid, queries, k, prec):
    """Operands of one pool scan exactly as knn_fused_stacked makes them."""
    n = vectors.shape[1]
    n_pad = -(-n // kf.FK_BLOCK) * kf.FK_BLOCK
    r = min(kf.fused_pool_width(min(k, n_pad), prec), n_pad)
    qsq = (queries * queries).sum(dim=1)
    v_x, q_x, scale = kf._prep_operands(vectors, queries, prec)
    return (v_x.contiguous(), norms.contiguous(), valid.contiguous(),
            q_x.contiguous(), qsq, scale), r


def compare_pools(kf, args, r, sim, prec, what: str) -> float:
    """Kernel vs plain pool on the same operands; returns max |dv|."""
    kv, ki = kf.pool_scan(*args, r=r, similarity=sim, score_precision=prec)
    pv, pi = kf.plain_pool(*args, r=r, similarity=sim, score_precision=prec)
    torch.cuda.synchronize()
    if not torch.equal(ki, pi):
        bad = (ki != pi).nonzero()[:5].tolist()
        raise AssertionError(f"{what}: ids differ at {bad}")
    fin = torch.isfinite(pv)
    if not torch.equal(fin, torch.isfinite(kv)):
        raise AssertionError(f"{what}: finite slots differ")
    if prec == "int8":
        if not torch.equal(kv, pv):
            raise AssertionError(f"{what}: int8 pool not bit-equal")
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


def timing_phase(kf, dev, seed: int) -> dict:
    rng = np.random.default_rng(seed + 1)
    n, k = 1_000_000, 10
    v = torch.from_numpy(clustered(rng, n, DIM))[None].to(dev)
    nrm = (v.double() ** 2).sum(2).float()
    ok = torch.ones((1, n), dtype=torch.bool, device=dev)
    out = {}
    for b in (1, 32):
        q = v[0, torch.randint(0, n, (b,), generator=torch.Generator().manual_seed(seed))
              .to(dev)] + 0.01
        args, r = scan_inputs(kf, v, nrm, ok, q, k, "fp32")
        compare_pools(kf, args, r, "l2_norm", "fp32", f"SIFT-1M shape B={b}")
        ms = time_ms(lambda: kf.pool_scan(*args, r=r, similarity="l2_norm",
                                          score_precision="fp32"), 20)
        plain_ms = time_ms(lambda: kf.plain_pool(
            *args, r=r, similarity="l2_norm", score_precision="fp32"), 5)
        qsq = args[4]

        def library():
            d_sq = torch.clamp(qsq[:, None] - 2.0 * (q @ v[0].T) + nrm[0][None],
                               min=0.0)
            return torch.topk(1.0 / (1.0 + d_sq), k)

        library_ms = time_ms(library, 10)
        nbytes = n * DIM * 4 + n * 4 + n * 1 + b * DIM * 4 + b * 4 + b * r * 8
        flops = 2 * b * n * DIM
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        out[b] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  "bound_ms": max(t_bytes, t_ops),
                  "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                  "bytes": nbytes, "flops": flops}
        log(f"SIFT-1M shape B={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
            f" library {library_ms:.4f} ms, bound {out[b]['bound_ms']:.4f} ms "
            f"({out[b]['bound_by']})")
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
            if hits != truth:
                bad = next(i for i, (h, t) in enumerate(zip(hits, truth)) if h != t)
                raise AssertionError(
                    f"[{name}] query {bad}: hits {hits[bad]} != truth {truth[bad]}")
            lat_ms = np.asarray(lat) * 1e3
            log(f"[{name}] 64 searches: recall@10 = 1.0 (same order), p50 "
                f"{np.percentile(lat_ms, 50):.3f} ms, p99 "
                f"{np.percentile(lat_ms, 99):.3f} ms, QPS {64 / sum(lat):.1f}")
        launches = kf.launches.count
        searches = distributed_serving.stats["distributed_searches"] - searches0
        node.close()
    # the device step of one search alone (operand prep, scan, top-k), at
    # each index's shape, beside the whole search's latency above
    step_ms = {}
    for name, (v, nrm, ok, q) in step_inputs.items():
        step_ms[name] = time_ms(lambda: kf.knn_fused_stacked(
            v, nrm, ok, q, k=10, similarity="l2_norm"), 20)
        log(f"[{name}] device step of one search (B=1, n={v.shape[1]}): "
            f"{step_ms[name]:.4f} ms")
    if searches != 128:
        raise AssertionError(f"{searches} of 128 searches took the serving path")
    if launches < 128:
        raise AssertionError(f"the kernel launched {launches} times in 128 searches")
    log(f"main path: {searches} served searches, {launches} kernel launches")
    return {"launches": launches, "latency_s": out, "step_ms": step_ms}

# --------------------------------------------------------------------------
# K2: the IVF-PQ ADC scan
# --------------------------------------------------------------------------


def compare_adc_pools(ads, args, r, what: str) -> float:
    """K2 vs its plain version on the same operands; returns max |dv|."""
    lut = args[0]
    kv, ki = ads.adc_pool_scan(*args, r=r)
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


def adc_kernel_phase(ads, ivfpq, dev, seed: int) -> float:
    rng = np.random.default_rng(seed + 10)
    n, b, nprobe = K2_PARITY_DOCS, 16, 8
    data = ann_corpus(rng, n, ANN_DIM)
    t0 = time.perf_counter()
    index = ivfpq.build(data, nlist=64, m=ANN_M, device=dev)
    log(f"K2 parity build: n={n} d={ANN_DIM} nlist=64 m={ANN_M} "
        f"l_pad={index.l_pad} in {time.perf_counter() - t0:.1f} s")
    queries = data[rng.choice(n, b, replace=False)] + 0.1 * \
        rng.standard_normal((b, ANN_DIM)).astype(np.float32)
    err = 0.0
    for prec in ("fp32", "bf16", "int8"):
        args = adc_operands(ads, ivfpq, index, queries, nprobe, prec)
        for r in (64, 4096):
            e = compare_adc_pools(ads, args, r, f"K2 {prec} R={r}")
            err = max(err, e)
            log(f"K2 parity {prec} R={r}: ok max_abs_err={e:.3g}")
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


def adc_timing_phase(ads, ivfpq, dev, seed: int) -> dict:
    """K2 at the glove-100 shape: 1.2M x 100-d cosine, m = 20,
    nlist = 512, nprobe = 8, R = 64 (k = 10 at the default multiplier)."""
    rng = np.random.default_rng(seed + 11)
    n, nprobe, r = GLOVE_DOCS, 8, 64
    data = ann_corpus(rng, n, ANN_DIM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = ivfpq.build(data, nlist=512, m=ANN_M, normalized=True,
                        device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"glove-100 shape build (ivfpq.build on the card): n={n} "
        f"d={ANN_DIM} nlist=512 m={ANN_M} l_pad={index.l_pad} in "
        f"{build_s:.1f} s")
    out = {"build_s": build_s, "l_pad": index.l_pad}
    for b in (1, 32):
        q = data[rng.choice(n, b, replace=False)]
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        args = adc_operands(ads, ivfpq, index, q, nprobe, "fp32")
        compare_adc_pools(ads, args, r, f"glove-100 shape B={b}")
        ms = time_ms(lambda: ads.adc_pool_scan(*args, r=r), 50)
        plain_ms = time_ms(lambda: ads.plain_adc_pool(*args, r=r), 5)
        prof = device_profile(lambda: ads.adc_pool_scan(*args, r=r), 20)
        if prof is not None:
            log(f"glove-100 shape B={b}: K2 under the profiler: wall "
                f"{prof['wall_ms']:.4f} ms a call, device {prof['device_ms']:.4f}"
                f" ms a call {prof['top']}")
        bound = adc_bound(index, args[0], args[4], r)
        out[b] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                  "device_ms": prof and prof["device_ms"], **bound}
        log(f"glove-100 shape B={b}: K2 {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {bound['bound_ms']:.6f} ms ({bound['bound_by']}; "
            f"{bound['bytes']} bytes, {bound['lookups']} lookups)")
    del index
    torch.cuda.empty_cache()
    return out


def plain_shard_hits(ads, ivfpq, kf, segments, qv, k: int, dev) -> list:
    """A shard's best k (doc id, score) by the plain pipeline on the card,
    one query at a time as the per-shard route runs it: per segment the
    IVF-PQ pipeline with the plain scan (adc_topr_auto impl="xla") or the
    plain exact scan (knn_fused impl="xla"), then the shard cut by
    (-score, segment, doc)."""
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
        else:
            q = torch.from_numpy(_pad_query_batch([qv])).to(dev)
            pv, pi = kf.knn_fused(vf.vectors, vf.norms_sq, valid, q,
                                  k=k_bucket, similarity="cosine", impl="xla")
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

    def search(qv) -> list:
        resp = node.search(name, {"query": {"knn": {"v": {
            "vector": qv.tolist(), "k": 10}}}, "size": 10})
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
           "qps": 64 / sum(lat), "mixed": mixed}
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
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is false")
        return 2
    from opensearch_tpu_torch.ops import adc_scan as ads
    from opensearch_tpu_torch.ops import cuda_lib, ivfpq
    from opensearch_tpu_torch.ops import knn_fused as kf

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(cuda_lib.build, KERNELS))
    log(f"built {', '.join(KERNELS)} in {time.perf_counter() - t0:.1f} s")

    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    entry = {"name": "knn_fused", "route": "cuda",
             "source": "opensearch_tpu_torch/csrc/knn_fused.cu",
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
    if "kernel" in phases:
        entry["max_abs_err"] = kernel_phase(kf, dev, args.seed)
        entry["parity"] = "ok"
        entry2["max_abs_err"] = adc_kernel_phase(ads, ivfpq, dev, args.seed)
        entry2["parity"] = "ok"
    if "timing" in phases:
        t = timing_phase(kf, dev, args.seed)
        entry.update({key: t[1][key] for key in fields})
        entry["shape"] = "n=1000000 d=128 fp32 l2 k=10 B=1"
        entry["b32"] = {key: t[32][key] for key in fields}
        t2 = adc_timing_phase(ads, ivfpq, dev, args.seed)
        entry2.update({key: t2[1][key] for key in fields})
        entry2["shape"] = (f"glove-100: n={GLOVE_DOCS} d={ANN_DIM} cosine "
                           f"nlist=512 m={ANN_M} nprobe=8 l_pad={t2['l_pad']} "
                           f"fp32 R=64 B=1")
        entry2["build_s"] = t2["build_s"]
        entry2["device_ms"] = t2[1]["device_ms"]
        entry2["b32"] = {key: t2[32][key] for key in (*fields, "device_ms")}
    if "main" in phases:
        main = main_path_phase(kf, dev, args.seed)
        entry["launches"] = main["launches"]
        entry["main_path_step_ms"] = main["step_ms"]
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
    print(json.dumps({"kernels": [entry, entry2]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
