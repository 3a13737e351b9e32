"""Variants of K1's list scan (opensearch_tpu_torch/csrc/knn_pool.cuh) on one
NVIDIA GPU.

    python3 scripts/pool_variants.py

Builds csrc/knn_fused.cu as it stands ("current", with nvcc's register and
spill report for the list scan's kernels) and once for each variant in
VARIANTS, a text substitution in knn_pool.cuh. Every build but
"filter_only" must equal ``plain_pool`` bit for bit on data whose dots are
exact in f32 (sixteenths; B = 1, 33 and 129; r = 10; l2, cosine and dot).
"filter_only" inserts no doc (its lists stay empty): its time is the
scan's and the filter's alone. "strided" walks whole steps strided by the
grid (K5's walk) in place of contiguous ranges. "counted" counts, per
(query, range), the
(query, step) pairs filtered, those with a passer, the passers and the
inserts one at a time. "tile_merge" merges the ranges' pools with the tile
scan's one-warp merge (knn_tile.cuh ``knn_merge_kernel``) in place of the
list scan's CTA-per-query ``knn_pool_merge_kernel``. Then each build's list
scan (scan and merge) is timed with CUDA events, and each of its two
kernels read by name under torch.profiler, at the SIFT-1M shape (1,000,000
clustered 128-d f32 docs, l2, r = 10) at B = 1, 32 and 128 and at the
serving shapes (one shard of 200,000 docs at B = 1 and 8, four of 5,000 at
B = 1), twice, the second pass in reverse build order, beside the card's
name and power limit. Needs nvcc; exits non-zero without a card or when a
build or a check fails.

    python3 scripts/pool_variants.py --variants current,tile_merge

builds and times only the named builds.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from opensearch_tpu_torch.ops import cuda_lib  # noqa: E402
from opensearch_tpu_torch.ops import knn_fused as kf  # noqa: E402

VARIANTS = {
    # the scan and the filter, with no doc inserted (lists stay empty)
    "filter_only": [("        if (!__any_sync(kFull, any)) continue;",
                     "        if (true) continue;")],
    # each CTA walks whole steps strided by the grid over the shard (K5's
    # walk), its lists carried across them, in place of one contiguous range
    "strided": [
        ("  const int end = min(n, start + chunk);",
         "  const int end = n;"),
        ("  const int n_steps = end > start ? (end - start + T::kSD - 1) / "
         "T::kSD : 0;",
         "  const int all_steps = (n + T::kSD - 1) / T::kSD;\n"
         "  const int n_steps =\n"
         "      split < all_steps ? (all_steps - 1 - split) / n_split + 1 "
         ": 0;"),
        ("  int in_c = 0, in_doc = start;",
         "  int in_c = 0, in_doc = split * T::kSD;"),
        ("        in_doc += T::kSD;", "        in_doc += n_split * T::kSD;"),
        ("    const int docb = start + step * T::kSD + sb * kSub;",
         "    const int docb = (split + step * n_split) * T::kSD + sb * kSub;"),
    ],
    # the current kernel counting, in device memory, the (query, step)
    # pairs filtered, those with a passer, the passers and the inserts
    "counted": [
        ('#include "knn_tile.cuh"\n',
         '#include "knn_tile.cuh"\n__device__ unsigned long long '
         'pool_count[4];\n'),
        ("        float lower = ord_float(low_g[gq + u]);\n",
         "        float lower = ord_float(low_g[gq + u]);\n"
         "        if (lane == 0) atomicAdd(&pool_count[0], 1ull);\n"),
        ("        if (!__any_sync(kFull, any)) continue;\n",
         "        if (!__any_sync(kFull, any)) continue;\n"
         "        if (lane == 0) atomicAdd(&pool_count[1], 1ull);\n"),
        ("  float v;\n  int c;\n  load_list(lv, lc, r, lane, v, c);\n",
         "  float v;\n  int c;\n  load_list(lv, lc, r, lane, v, c);\n"
         "  if (lane == 0) atomicAdd(&pool_count[2], (unsigned long long)("
         "__popc(mk[0]) + __popc(mk[1]) + __popc(mk[2]) + __popc(mk[3])));\n"),
        ("        const unsigned below = __ballot_sync(kFull, "
         "better(cv, cc, v, c));\n",
         "        const unsigned below = __ballot_sync(kFull, "
         "better(cv, cc, v, c));\n"
         "        if (lane == 0) atomicAdd(&pool_count[3], 1ull);\n"),
        ("}  // namespace pool\n}  // namespace\n",
         "}  // namespace pool\n}  // namespace\n"
         'extern "C" int knn_pool_counts(unsigned long long* out, int reset) '
         '{\n  static const unsigned long long zero[4] = {0, 0, 0, 0};\n'
         '  if (reset) return (int)cudaMemcpyToSymbol(pool_count, zero, 32);\n'
         '  return (int)cudaMemcpyFromSymbol(out, pool_count, 32);\n}\n'),
    ],
    # the tile scan's merge: one warp per (query, shard) over the heads
    "tile_merge": [
        ("""  const size_t smem = merge_smem_bytes(n_split, r);
  e = cudaFuncSetAttribute(knn_pool_merge_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  knn_pool_merge_kernel<<<dim3(B, S), kMergeThreads, smem, st>>>(""",
         """  knn_merge_kernel<<<dim3(B, S), 32, n_split * sizeof(int), st>>>("""),
    ],
}
# the profiler's names of the scan and of the two merges
SCAN_KERNEL = "knn_pool_scan_kernel"
MERGE_KERNELS = ("knn_pool_merge_kernel", "knn_merge_kernel")
SIMS = ("l2_norm", "cosine", "dot_product")


def build(tmp: Path, name: str, subs):
    """csrc/knn_fused.cu built against a copy of knn_pool.cuh with the
    variant's substitutions, loaded with its list-scan signatures."""
    src = (cuda_lib.CSRC / "knn_pool.cuh").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{name}: {old!r} not found in knn_pool.cuh")
        src = src.replace(old, new)
    where = tmp / name
    where.mkdir()
    # knn_fused.cu reaches knn_pool.cuh through the other headers, whose
    # quoted includes look beside them first: copies of them all make them
    # find the variant's
    for header in cuda_lib.CSRC.glob("*.cuh"):
        shutil.copy(header, where / header.name)
    (where / "knn_pool.cuh").write_text(src)
    cu, so = where / "knn_fused.cu", where / "libknn_fused.so"
    shutil.copy(cuda_lib.CSRC / "knn_fused.cu", cu)
    flags = [*cuda_lib.NVCC_FLAGS, "-I", str(cuda_lib.CSRC)]
    if name == "current":
        flags += ["-Xptxas", "-v"]
    proc = subprocess.run([cuda_lib.nvcc_path(), *flags, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr}")
    if name == "current":
        # ptxas reports a kernel's spills, then its registers
        kernel, spills = None, ""
        for line in proc.stderr.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"knn_pool_scan_kernelILi(\d+)ELi(\d+)E", line)
                kernel = (f"knn_pool_scan_kernel<{m[1]}, {m[2]}>" if m
                          else "knn_pool_merge_kernel"
                          if "knn_pool_merge_kernel" in line else None)
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line and kernel:
                print(f"{kernel}: {line.split(':', 1)[1].strip()}; {spills}")
                kernel = None
    lib = ctypes.CDLL(str(so))
    lib.knn_fused_lists_smem_bytes.restype = ctypes.c_size_t
    lib.knn_fused_lists_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.knn_fused_lists_launch.restype = ctypes.c_int
    lib.knn_fused_lists_launch.argtypes = ([ctypes.c_void_p] * 9
                                           + [ctypes.c_int] * 10
                                           + [ctypes.c_void_p])
    return lib


def scan(lib, v, nrm, ok, q, sim: str, r: int = 10):
    """The list scan through `lib` as ops/knn_fused launches it."""
    return kf.launch_lists(lib.knn_fused_lists_launch,
                           lib.knn_fused_lists_smem_bytes, v, nrm, ok, q,
                           (q * q).sum(1), r=r, similarity=sim)


def check(name, lib, dev) -> None:
    rng = np.random.default_rng(5)
    n = 50_000
    x = np.round(rng.standard_normal((n, 128)).astype(np.float32) * 16) / 16
    v = torch.from_numpy(np.clip(x, -4, 4))[None].to(dev)
    nrm = (v.double() ** 2).sum(2).float()
    ok = torch.from_numpy(rng.random((1, n)) > 0.03).to(dev)
    for b in (1, 33, 129):
        q = v[0, torch.from_numpy(rng.choice(n, b)).to(dev)]
        for sim in SIMS:
            want = kf.plain_pool(v, nrm, ok, q, (q * q).sum(1),
                                 torch.ones(1, device=dev), r=10,
                                 similarity=sim, score_precision="fp32")
            got = scan(lib, v, nrm, ok, q, sim)
            if not all(torch.equal(a, w) for a, w in zip(got, want)):
                raise SystemExit(f"{name}: differs from plain_pool at B={b} "
                                 f"{sim}")


def time_ms(fn, iters: int = 20) -> float:
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


def device_ms(fn, reps: int = 10) -> tuple[float, float]:
    """(scan, merge) device ms per call of fn under torch.profiler, each
    read by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    scan_ms = merge_ms = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        ms = (evt.self_cuda_time_total if us is None else us) / 1e3 / reps
        if SCAN_KERNEL in evt.key:
            scan_ms += ms
        elif any(m in evt.key for m in MERGE_KERNELS):
            merge_ms += ms
    return scan_ms, merge_ms


def clustered(rng, n: int) -> np.ndarray:
    centers = rng.standard_normal((64, 128)).astype(np.float32) * 4.0
    return centers[rng.integers(0, 64, n)] + rng.standard_normal(
        (n, 128)).astype(np.float32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=None,
                    help="comma list of builds (default: current and every "
                         f"variant: {','.join(VARIANTS)})")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    builds = {"current": [], **VARIANTS}
    if args.variants:
        names = args.variants.split(",")
        unknown = set(names) - set(builds)
        if unknown:
            ap.error(f"unknown builds {sorted(unknown)}")
        builds = {name: builds[name] for name in names}
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc a build
            libs = dict(zip(builds, pool.map(
                lambda item: build(Path(tmp), *item), builds.items())))
        for name, lib in libs.items():
            if name != "filter_only":
                check(name, lib, dev)
        print("every build but filter_only bit-equal to plain_pool")
        counts = (ctypes.c_ulonglong * 4)()
        if "counted" in libs:
            libs["counted"].knn_pool_counts.argtypes = [ctypes.c_void_p,
                                                        ctypes.c_int]
        rng = np.random.default_rng(1)
        order = list(libs.items())
        for s, n, bs in ((1, 1_000_000, (1, 32, 128)), (1, 200_000, (1, 8)),
                         (4, 5_000, (1,))):
            v = torch.from_numpy(clustered(rng, s * n)).reshape(
                s, n, 128).to(dev)
            nrm = (v.double() ** 2).sum(2).float()
            ok = torch.ones((s, n), dtype=torch.bool, device=dev)
            qs = v[0, torch.from_numpy(rng.choice(n, max(bs), replace=False))
                   .to(dev)] + 0.01
            for rnd, builds in enumerate((order, order[::-1])):
                for name, lib in builds:
                    for b in bs:
                        q = qs[:b].contiguous()
                        call = functools.partial(scan, lib, v, nrm, ok, q,
                                                 "l2_norm")
                        ms = time_ms(call)
                        scan_ms, merge_ms = device_ms(call)
                        print(f"round {rnd} {name:12s} S={s} n={n} B={b:3d}: "
                              f"list scan {ms:.4f} ms; device scan "
                              f"{scan_ms:.4f} ms, merge {merge_ms:.4f} ms "
                              f"({merge_ms / (scan_ms + merge_ms):.1%} of "
                              f"the call)")
                        if name == "counted" and rnd == 0:
                            lib.knn_pool_counts(counts, 1)
                            call()
                            torch.cuda.synchronize()
                            lib.knn_pool_counts(counts, 0)
                            qt, _stages = kf.list_plan(
                                b, 128, 10, lib.knn_fused_lists_smem_bytes)
                            _chunk, n_split = kf.list_geometry(
                                s, n, -(-b // qt), kf.sm_count(dev))
                            per = s * b * n_split
                            print(f"counted S={s} n={n} B={b}: per (query, "
                                  f"range of {n_split}) "
                                  f"{counts[0] / per:.2f} filtered steps, "
                                  f"{counts[1] / per:.2f} with a passer, "
                                  f"{counts[2] / per:.2f} passers, "
                                  f"{counts[3] / per:.2f} inserted one at a "
                                  f"time")
            del v
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
