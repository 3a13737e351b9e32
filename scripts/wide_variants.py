"""Variants of the wide tier of K1's list scan
(opensearch_tpu_torch/csrc/knn_wide.cuh) on one NVIDIA GPU.

    python3 scripts/wide_variants.py

Builds csrc/knn_fused.cu as it stands ("current", with nvcc's register and
spill report for the wide tier's kernels) and once for each variant in
VARIANTS, a text substitution in knn_wide.cuh. Every build but
"filter_only" must equal ``plain_pool`` bit for bit on data whose dots are
exact in f32 (sixteenths; B = 1, 9 and 33; r = 100 and 1024; l2, cosine
and dot). "filter_only" appends no doc (its pools stay empty): its time is
the scan's and the filter's alone. "counted" counts, per (query, range),
the passers appended, the flushes, the flushes that select (more than r
pairs) and the pairs they select from. "one_warp" selects and sorts with
one warp a query at every batch, in place of all of a CTA's warps for one
query. "prefix_2x" starts the merge from twice a fair share of each range's
pool in place of four times. "merge_from_device" gives the merge one
candidate of shared memory, so its second stage always takes the fallback
that reads every slot from device memory. Then each build is timed with CUDA events, and
its scan and merge read by kernel name under torch.profiler, at the SIFT-1M
shape (1,000,000 clustered 128-d f32 docs, l2) at r = 100, 128 and 1024
and B = 1, 8 and 32, twice, the second pass in reverse build order; and the
current build at every ring of ``WIDE_RINGS`` with each buffer capacity of
BUFFERS that fits beside it, after the plan the wrapper picks, beside the
card's name and power limit.
Needs nvcc; exits non-zero without a card or when a build or a check
fails.

    python3 scripts/wide_variants.py --variants current,counted

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
    # the scan and the filter, with no doc appended (pools stay empty)
    "filter_only": [("    if (total == 0) continue;\n",
                     "    if (true) continue;\n")],
    # the current kernel counting, in device memory, the passers appended,
    # the flushes, the selecting flushes and the pairs they select from
    "counted": [
        ('#include "knn_pool.cuh"\n',
         '#include "knn_pool.cuh"\n__device__ unsigned long long '
         'wide_count[4];\n'),
        ("    if (total == 0) continue;\n",
         "    if (total == 0) continue;\n"
         "    if (lane == 0) atomicAdd(&wide_count[0], "
         "(unsigned long long)total);\n"),
        ("  const int m = pn + cn;\n  u64 t = 0ull;\n  if (m > r) {\n",
         "  const int m = pn + cn;\n  u64 t = 0ull;\n"
         "  if (g.gt == 0) atomicAdd(&wide_count[1], 1ull);\n"
         "  if (m > r && g.gt == 0) {\n"
         "    atomicAdd(&wide_count[2], 1ull);\n"
         "    atomicAdd(&wide_count[3], (unsigned long long)m);\n  }\n"
         "  if (m > r) {\n"),
        ("}  // namespace wide\n}  // namespace\n",
         "}  // namespace wide\n}  // namespace\n"
         'extern "C" int knn_wide_counts(unsigned long long* out, int reset) '
         '{\n  static const unsigned long long zero[4] = {0, 0, 0, 0};\n'
         '  if (reset) return (int)cudaMemcpyToSymbol(wide_count, zero, 32);\n'
         '  return (int)cudaMemcpyFromSymbol(out, wide_count, 32);\n}\n'),
    ],
    # one warp selects and sorts for each query at every batch
    "one_warp": [("  return qb == 1 ? 8 : qb == 2 ? 4 : qb <= 4 ? 2 : 1;",
                  "  return 1;")],
    # the merge's first stage from twice a fair share of each pool
    "prefix_2x": [("  const int t = 4 * ((r + n_split - 1) / n_split);",
                   "  const int t = 2 * ((r + n_split - 1) / n_split);")],
    # the merge's second stage from device memory at every shape (its
    # fallback where the prefixes do not fit shared memory)
    "merge_from_device": [("constexpr int kMergeStage = 16384;",
                           "constexpr int kMergeStage = 1;")],
}
# buffer capacities timed beside each plan's own (those that fit)
BUFFERS = (1024, 2048, 4096)
SCAN_KERNEL = "knn_wide_scan_kernel"
MERGE_KERNEL = "knn_wide_merge_kernel"
SIMS = ("l2_norm", "cosine", "dot_product")
SHAPES = ((100, (1, 8, 32)), (128, (1, 8, 32)), (1024, (1, 8, 32)))


def build(tmp: Path, name: str, subs):
    """csrc/knn_fused.cu built against a copy of knn_wide.cuh with the
    variant's substitutions, loaded with its wide-tier signatures."""
    src = (cuda_lib.CSRC / "knn_wide.cuh").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{name}: {old!r} not found in knn_wide.cuh")
        src = src.replace(old, new)
    where = tmp / name
    where.mkdir()
    # copies of every header beside the variant's, so that the quoted
    # includes of those that include it find it
    for header in cuda_lib.CSRC.glob("*.cuh"):
        shutil.copy(header, where / header.name)
    (where / "knn_wide.cuh").write_text(src)
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
                m = re.search(r"knn_wide_scan_kernelILi(\d+)ELi(\d+)E", line)
                kernel = (f"{SCAN_KERNEL}<{m[1]}, {m[2]}>" if m
                          else MERGE_KERNEL if MERGE_KERNEL in line else None)
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line and kernel:
                print(f"{kernel}: {line.split(':', 1)[1].strip()}; {spills}")
                kernel = None
    lib = ctypes.CDLL(str(so))
    lib.knn_fused_wide_smem_bytes.restype = ctypes.c_size_t
    lib.knn_fused_wide_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.knn_fused_wide_launch.restype = ctypes.c_int
    lib.knn_fused_wide_launch.argtypes = ([ctypes.c_void_p] * 9
                                          + [ctypes.c_int] * 11
                                          + [ctypes.c_void_p])
    return lib


def scan(lib, v, nrm, ok, q, sim: str, r: int, plan=None):
    """The wide tier through `lib` as ops/knn_fused launches it, at `plan`
    (stages, floats a stage, buffer capacity) when given, else at the
    wrapper's (kf.wide_plan)."""
    if plan is None:
        return kf.launch_wide(lib.knn_fused_wide_launch,
                              lib.knn_fused_wide_smem_bytes, v, nrm, ok, q,
                              (q * q).sum(1), r=r, similarity=sim)
    qsq = (q * q).sum(1)
    v, q = kf.rows_in_16_bytes(v, q)
    return kf._launch_ranges(lib.knn_fused_wide_launch, "wide tier", v, nrm,
                             ok, q, qsq, r=r, similarity=sim,
                             qt=kf.WIDE_QUERY_TILE, plan=plan)


def check(name, lib, dev) -> None:
    rng = np.random.default_rng(5)
    n = 50_000
    x = np.round(rng.standard_normal((n, 128)).astype(np.float32) * 16) / 16
    v = torch.from_numpy(np.clip(x, -4, 4))[None].to(dev)
    nrm = (v.double() ** 2).sum(2).float()
    ok = torch.from_numpy(rng.random((1, n)) > 0.03).to(dev)
    for b in (1, 9, 33):
        q = v[0, torch.from_numpy(rng.choice(n, b)).to(dev)]
        for r in (100, 1024):
            for sim in SIMS:
                want = kf.plain_pool(v, nrm, ok, q, (q * q).sum(1),
                                     torch.ones(1, device=dev), r=r,
                                     similarity=sim, score_precision="fp32")
                got = scan(lib, v, nrm, ok, q, sim, r)
                if not all(torch.equal(a, w) for a, w in zip(got, want)):
                    raise SystemExit(f"{name}: differs from plain_pool at "
                                     f"B={b} r={r} {sim}")


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
        elif MERGE_KERNEL in evt.key:
            merge_ms += ms
    return scan_ms, merge_ms


def clustered(rng, n: int) -> np.ndarray:
    centers = rng.standard_normal((64, 128)).astype(np.float32) * 4.0
    return centers[rng.integers(0, 64, n)] + rng.standard_normal(
        (n, 128)).astype(np.float32)


def report(label: str, call) -> None:
    ms = time_ms(call)
    scan_ms, merge_ms = device_ms(call)
    print(f"{label}: wide tier {ms:.4f} ms; device scan {scan_ms:.4f} ms, "
          f"merge {merge_ms:.4f} ms", flush=True)


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
        print("every build but filter_only bit-equal to plain_pool",
              flush=True)
        counts = (ctypes.c_ulonglong * 4)()
        if "counted" in libs:
            libs["counted"].knn_wide_counts.argtypes = [ctypes.c_void_p,
                                                        ctypes.c_int]
        rng = np.random.default_rng(1)
        n = 1_000_000
        v = torch.from_numpy(clustered(rng, n))[None].to(dev)
        nrm = (v.double() ** 2).sum(2).float()
        ok = torch.ones((1, n), dtype=torch.bool, device=dev)
        qs = v[0, torch.from_numpy(rng.choice(n, 32, replace=False))
               .to(dev)] + 0.01
        order = list(libs.items())
        for rnd, builds in enumerate((order, order[::-1])):
            for name, lib in builds:
                for r, bs in SHAPES:
                    for b in bs:
                        q = qs[:b].contiguous()
                        call = functools.partial(scan, lib, v, nrm, ok, q,
                                                 "l2_norm", r)
                        report(f"round {rnd} {name:11s} r={r:4d} B={b:2d}",
                               call)
                        if name == "counted" and rnd == 0:
                            lib.knn_wide_counts(counts, 1)
                            call()
                            torch.cuda.synchronize()
                            lib.knn_wide_counts(counts, 0)
                            _chunk, n_split = kf.list_geometry(
                                1, n, -(-b // kf.WIDE_QUERY_TILE),
                                kf.sm_count(dev))
                            per = b * n_split
                            print(f"counted r={r} B={b}: per (query, range "
                                  f"of {n_split}) {counts[0] / per:.1f} "
                                  f"passers, {counts[1] / per:.2f} flushes, "
                                  f"{counts[2] / per:.2f} selecting, from "
                                  f"{counts[3] / max(counts[2], 1):.0f} "
                                  f"pairs each", flush=True)
        if "current" in libs:
            lib = libs["current"]
            for r, bs in SHAPES:
                for b in bs:
                    rows = min(kf.WIDE_QUERY_TILE, b)
                    plan = kf.wide_plan(b, 128, r,
                                        lib.knn_fused_wide_smem_bytes)
                    print(f"plan r={r} B={b}: {plan}")
                    for stages, floats in kf.WIDE_RINGS:
                        for cap in BUFFERS:
                            smem = lib.knn_fused_wide_smem_bytes(
                                stages, floats, 128, r, rows, cap)
                            if smem > kf._MAX_SMEM:
                                continue
                            plan = (stages, floats, cap)
                            report(f"buffer r={r:4d} B={b:2d} plan {plan}",
                                   functools.partial(
                                       scan, lib, v, nrm, ok,
                                       qs[:b].contiguous(), "l2_norm", r,
                                       plan))
    return 0


if __name__ == "__main__":
    sys.exit(main())
