"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed N] [--phases kernel,timing,main]

Builds the port's CUDA kernel from the sources in this checkout, then:

1. kernel: holds the fused exact-kNN kernel (csrc/knn_fused.cu) against
   its plain PyTorch version on the card, for fp32, bf16 and int8 x l2,
   cosine and dot (n = 50,000, d = 128, B = 16, k = 10, 3% dead docs,
   planted duplicate vectors), and at the shapes the main path gives it.
   int8 pools must be bit-equal; fp32 and bf16 ids equal, scores within
   rtol 1e-5 / atol 2e-3: the two sum the d products in another order (at
   B = 1 PyTorch's product reduces as a tree), and for a near neighbour
   l2's |q|^2 - 2 q.v + |v|^2 cancels, so each ulp of a dot near
   |q|^2 ~ 2,000 (2.4e-4) reaches the score almost whole.
2. timing: at the SIFT-1M shape (n = 1,000,000, d = 128, f32, l2, k = 10,
   B = 1 and 32) times the kernel, the plain version and a library
   yardstick (torch.topk over the l2-transformed q @ v.T, which the port
   never calls) with CUDA events, beside the bound
   max(bytes / 3.35 TB/s, 2*B*n*d / 67 TFLOP/s).
3. main: drives TorchNode on the card: index A (1 shard, 200,000
   clustered 128-d docs) and index B (4 shards, 20,000 docs), 64 knn
   searches each; every hit list must equal the brute-force truth in the
   same order, every search must go through the stacked serving path and
   the kernel.

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

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
FP32_FLOP_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
DIM = 128
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="kernel,timing,main")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is false")
        return 2
    from opensearch_tpu_torch.ops import cuda_lib
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
    cuda_lib.build("knn_fused")
    log(f"built knn_fused in {time.perf_counter() - t0:.1f} s")

    entry = {"name": "knn_fused", "route": "cuda",
             "source": "opensearch_tpu_torch/csrc/knn_fused.cu",
             "replaces": "opensearch_tpu/ops/pallas_knn.py:785 "
                         "(pallas_knn_fused -> _knn_fused_kernel :675)",
             "launches": None, "parity": None, "max_abs_err": None,
             "ms": None, "plain_ms": None, "bound_ms": None,
             "bound_by": None, "library_ms": None}
    if "kernel" in phases:
        entry["max_abs_err"] = kernel_phase(kf, dev, args.seed)
        entry["parity"] = "ok"
    if "timing" in phases:
        t = timing_phase(kf, dev, args.seed)
        entry.update({key: t[1][key] for key in
                      ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        entry["shape"] = "n=1000000 d=128 fp32 l2 k=10 B=1"
        entry["b32"] = {key: t[32][key] for key in
                        ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    if "main" in phases:
        main = main_path_phase(kf, dev, args.seed)
        entry["launches"] = main["launches"]
        entry["main_path_step_ms"] = main["step_ms"]
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
