"""Variants of the wide tier's tensor-core scan, K1 at bf16 and int8
(opensearch_tpu_torch/csrc/knn_wide_mma.cuh), on one NVIDIA GPU.

    python3 scripts/mma_variants.py [--baseline DIR]

Builds csrc/knn_fused.cu as it stands ("current", with nvcc's register and
spill report for the scan kernels) and once for each variant in VARIANTS,
a text substitution in one of its headers (every header copied beside the
build, so the substituted one is the one included). "smem_regroup" hands
the m16n8 accumulators to the selection by staging each warp's 128 x 8
f32 tile in its own rows of the ring stage just read, in place of the
quad shuffles. "filter_only" appends no doc (the pools stay empty): its
time is the stream's, the dots' and the filter's alone. Every build but
"filter_only" must equal ``plain_pool`` bit for bit at bf16 and int8 on
data whose bf16 sums are exact (sixteenths below 2^18 / d in square;
B = 1, 9 and 33; r = 40, 400 and 1024; l2, cosine and dot). Then each
build is timed with CUDA events, and its scan and merge read by kernel
name under torch.profiler, at the SIFT-1M shape (1,000,000 clustered 128-d
docs, l2) at bf16 and int8, r = 40 and 400 (k = 10 and 100) and B = 1, 8
and 32, twice, the second pass in reverse build order; then the current
build at each ring of ``WIDE_RINGS`` that fits (ring depths three and two
at 64 KB a stage, two at 32 KB), with the buffer the plan gives it.

With ``--baseline DIR`` (a directory holding an older csrc/knn_fused.cu
and its headers, e.g. a parent commit's: ``mkdir -p build/base && for f
in knn_fused.cu knn_wide.cuh knn_pool.cuh knn_tile.cuh; do git show
COMMIT:opensearch_tpu_torch/csrc/$f > build/base/$f; done``) the fp32
list scan and wide tier of that build ("pre") and of the current one
("new") are also checked bit for bit against each other (clustered
floats) and against plain_pool (sixteenths), then timed in turns: pre,
new, new, pre, at r = 10 (the list scan, B = 1, 32 and 128) and r = 100,
128 and 1024 (the wide tier, B = 1, 8 and 32).
Prints the card's name and power limit first. Needs nvcc; exits non-zero
without a card or when a build or a check fails.

    python3 scripts/mma_variants.py --variants current,filter_only

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

import chip_smoke as cs  # noqa: E402
from opensearch_tpu_torch.ops import cuda_lib  # noqa: E402
from opensearch_tpu_torch.ops import knn_fused as kf  # noqa: E402

# each warp's 128 x 8 f32 tile staged in its own rows of the stage it has
# just read (at least 1,024 words), each row's two 16-byte halves swapped on
# odd quads of docs so that the reads of 8 lanes' halves fall in distinct
# banks; then lane l holds docs l + 32 i
REGROUP_STAGED = """
__device__ __forceinline__ void regroup_staged(float (&f)[8][4],
                                               float (&acc)[4][8],
                                               float* scratch, int lane) {
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int doc = 16 * j + g + 8 * h;
      const int col = (((t >> 1) ^ ((doc >> 2) & 1)) << 2) + ((t & 1) << 1);
      *reinterpret_cast<float2*>(scratch + doc * 8 + col) =
          make_float2(f[j][2 * h], f[j][2 * h + 1]);
    }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int doc = lane + 32 * i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 x = *reinterpret_cast<const float4*>(
          scratch + doc * 8 + ((h ^ ((doc >> 2) & 1)) << 2));
      acc[i][4 * h] = x.x;
      acc[i][4 * h + 1] = x.y;
      acc[i][4 * h + 2] = x.z;
      acc[i][4 * h + 3] = x.w;
    }
  }
}

"""
VARIANTS = {
    # the accumulators regrouped through shared memory
    "smem_regroup": ("knn_wide_mma.cuh", [
        ("  return 16 * ((lane & 3) + 4 * (i >> 1)) + (lane >> 2) + "
         "8 * (i & 1);", "  return lane + 32 * i;"),
        ("// the query tile's row in words",
         REGROUP_STAGED + "// the query tile's row in words"),
        ("      regroup(f, acc, lane);",
         "      regroup_staged(f, acc, const_cast<float*>(st) + warp * kSub "
         "* R::kDC, lane);")]),
    # the stream, the dots and the filter, with no doc appended
    "filter_only": ("knn_wide.cuh", [
        ("    if (total == 0) continue;\n", "    if (true) continue;\n")]),
}
SCAN_KERNEL = "knn_wide_mma_scan_kernel"
MERGE_KERNEL = "knn_wide_merge_kernel"
FP32_KERNELS = {"lists": ("knn_pool_scan_kernel", "knn_pool_merge_kernel"),
                "wide": ("knn_wide_scan_kernel", "knn_wide_merge_kernel")}
SIMS = ("l2_norm", "cosine", "dot_product")
PRECS = ("bf16", "int8")
SHAPES = ((40, (1, 8, 32)), (400, (1, 8, 32)))
FP32_SHAPES = ((10, (1, 32, 128)), (100, (1, 8, 32)), (128, (1, 8, 32)),
               (1024, (1, 8, 32)))


def build(tmp: Path, name: str, header: str | None, subs, src_dir: Path):
    """src_dir's knn_fused.cu built beside copies of its headers, `header`
    with the variant's substitutions; loaded with the signatures it has."""
    where = tmp / name
    where.mkdir()
    for h in src_dir.glob("*.cuh"):
        shutil.copy(h, where / h.name)
    if header is not None:
        text = (where / header).read_text()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} not found in {header}")
            text = text.replace(old, new)
        (where / header).write_text(text)
    cu, so = where / "knn_fused.cu", where / "libknn_fused.so"
    shutil.copy(src_dir / "knn_fused.cu", cu)
    flags = list(cuda_lib.NVCC_FLAGS)
    if name == "current":
        flags += ["-Xptxas", "-v"]
    proc = subprocess.run([cuda_lib.nvcc_path(), *flags, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr}")
    if name == "current":
        kernel, spills = None, ""
        for line in proc.stderr.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"(knn_wide_mma_scan_kernel|knn_wide_scan_"
                              r"kernel)I((?:Li\d+E)+)", line)
                kernel = (f"{m[1]}<{', '.join(re.findall(r'Li(\d+)E', m[2]))}>"
                          if m else None)
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line and kernel:
                print(f"{kernel}: {line.split(':', 1)[1].strip()}; {spills}",
                      flush=True)
                kernel = None
    lib = ctypes.CDLL(str(so))
    for fn, n_ptr, n_int in (("knn_fused_wide_launch", 9, 11),
                             ("knn_fused_lists_launch", 9, 10)):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = ([ctypes.c_void_p] * n_ptr
                                     + [ctypes.c_int] * n_int
                                     + [ctypes.c_void_p])
    lib.knn_fused_wide_smem_bytes.restype = ctypes.c_size_t
    lib.knn_fused_wide_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.knn_fused_lists_smem_bytes.restype = ctypes.c_size_t
    lib.knn_fused_lists_smem_bytes.argtypes = [ctypes.c_int] * 4
    if hasattr(lib, "knn_fused_mma_launch"):
        lib.knn_fused_mma_smem_bytes.restype = ctypes.c_size_t
        lib.knn_fused_mma_smem_bytes.argtypes = [ctypes.c_int] * 7
        lib.knn_fused_mma_launch.restype = ctypes.c_int
        lib.knn_fused_mma_launch.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                                             + [ctypes.c_void_p] * 9
                                             + [ctypes.c_int] * 11
                                             + [ctypes.c_void_p])
    return lib


def mma_scan(lib, args, prec: str, sim: str, r: int, plan=None):
    """The tensor-core tier through `lib` as ops/knn_fused launches it, at
    `plan` (stages, words a stage, buffer capacity) when given."""
    v_x, nrm, ok, q_x, qsq, scale = args
    if plan is None:
        return kf.launch_wide_mma(lib, *args, r=r, similarity=sim,
                                  score_precision=prec)
    v, q = kf.rows_in_16_bytes(v_x, q_x)
    launch = functools.partial(lib.knn_fused_mma_launch, scale.data_ptr(),
                               kf._PREC_CODE[prec])
    return kf._launch_ranges(launch, "tensor-core tier", v, nrm, ok, q, qsq,
                             r=r, similarity=sim, qt=kf.WIDE_QUERY_TILE,
                             plan=plan)


def fp32_scan(lib, v, nrm, ok, q, r: int):
    """K1's fp32 design at r (the list scan or its wide tier) through
    `lib`."""
    if r <= kf.LIST_MAX_R:
        return kf.launch_lists(lib.knn_fused_lists_launch,
                               lib.knn_fused_lists_smem_bytes, v, nrm, ok, q,
                               (q * q).sum(1), r=r, similarity="l2_norm")
    return kf.launch_wide(lib.knn_fused_wide_launch,
                          lib.knn_fused_wide_smem_bytes, v, nrm, ok, q,
                          (q * q).sum(1), r=r, similarity="l2_norm")


def operands(v, q, prec: str):
    nrm = (v.double() ** 2).sum(2).float()
    ok = torch.ones(v.shape[:2], dtype=torch.bool, device=v.device)
    v_x, q_x, scale = kf._prep_operands(v, q, prec)
    return v_x, nrm, ok, q_x, (q * q).sum(1), scale


def check(name, lib, dev) -> None:
    rng = np.random.default_rng(5)
    n = 50_000
    v = torch.from_numpy(cs.mma_sixteenths(rng, n, 128))[None].to(dev)
    for b in (1, 9, 33):
        q = v[0, torch.from_numpy(rng.choice(n, b)).to(dev)]
        for prec in PRECS:
            args = operands(v, q, prec)
            for r in (40, 400, 1024):
                for sim in SIMS:
                    want = kf.plain_pool(*args, r=r, similarity=sim,
                                         score_precision=prec)
                    got = mma_scan(lib, args, prec, sim, r)
                    if not all(torch.equal(a, w) for a, w in zip(got, want)):
                        raise SystemExit(f"{name}: differs from plain_pool "
                                         f"at {prec} B={b} r={r} {sim}")


def device_ms(fn, names, reps: int = 10) -> tuple[float, float]:
    """Device ms per call of fn under torch.profiler of the kernels whose
    names hold names[0] (the scan) and names[1] (the merge)."""
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
        if names[0] in evt.key:
            scan_ms += ms
        elif names[1] in evt.key:
            merge_ms += ms
    return scan_ms, merge_ms


def report(label: str, call, names=(SCAN_KERNEL, MERGE_KERNEL)) -> None:
    ms = cs.time_ms(call, 20)
    scan_ms, merge_ms = device_ms(call, names)
    print(f"{label}: {ms:.4f} ms; device scan {scan_ms:.4f} ms, merge "
          f"{merge_ms:.4f} ms", flush=True)


def baseline_ab(pre, new, dev) -> None:
    """The fp32 list scan and wide tier of the baseline build (pre) and of
    the current one (new): bit-equal to each other on clustered floats and
    to plain_pool on sixteenths, then timed pre, new, new, pre."""
    rng = np.random.default_rng(7)
    n = 200_000
    for integer, data in ((True, cs.sixteenths(rng, n, 128)),
                          (False, cs.clustered(rng, n, 128))):
        v = torch.from_numpy(data)[None].to(dev)
        nrm = (v.double() ** 2).sum(2).float()
        ok = torch.from_numpy(rng.random((1, n)) > 0.03).to(dev)
        for b in (1, 9, 33):
            q = v[0, torch.from_numpy(rng.choice(n, b)).to(dev)] + (
                0.0 if integer else 0.01)
            for r in (10, 100, 1024):
                got = [fp32_scan(lib, v, nrm, ok, q, r) for lib in (pre, new)]
                if not all(torch.equal(a, w) for a, w in zip(*got)):
                    raise SystemExit(f"pre and new differ at B={b} r={r} "
                                     f"integer={integer}")
                if integer:
                    want = kf.plain_pool(v, nrm, ok, q, (q * q).sum(1),
                                         torch.ones(1, device=dev), r=r,
                                         similarity="l2_norm",
                                         score_precision="fp32")
                    if not all(torch.equal(a, w)
                               for a, w in zip(got[1], want)):
                        raise SystemExit(f"new differs from plain_pool at "
                                         f"B={b} r={r}")
    print("fp32 list scan and wide tier: pre and new bit-equal (floats), "
          "both plain_pool's (sixteenths)", flush=True)
    n = 1_000_000
    v = torch.from_numpy(cs.clustered(rng, n, 128))[None].to(dev)
    nrm = (v.double() ** 2).sum(2).float()
    ok = torch.ones((1, n), dtype=torch.bool, device=dev)
    qs = v[0, torch.from_numpy(rng.choice(n, 128, replace=False))
           .to(dev)] + 0.01
    for r, bs in FP32_SHAPES:
        names = FP32_KERNELS["lists" if r <= kf.LIST_MAX_R else "wide"]
        for b in bs:
            q = qs[:b].contiguous()
            for turn, (tag, lib) in enumerate(
                    (("pre", pre), ("new", new), ("new", new),
                     ("pre", pre))):
                report(f"fp32 A/B r={r:4d} B={b:3d} turn {turn} {tag}",
                       functools.partial(fp32_scan, lib, v, nrm, ok, q, r),
                       names)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=None,
                    help="comma list of builds (default: current and every "
                         f"variant: {','.join(VARIANTS)})")
    ap.add_argument("--baseline", default=None,
                    help="a directory with an older knn_fused.cu and its "
                         "headers, for the fp32 A/B")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    builds = {"current": (None, []), **VARIANTS}
    if args.variants:
        names = args.variants.split(",")
        unknown = set(names) - set(builds)
        if unknown:
            ap.error(f"unknown builds {sorted(unknown)}")
        builds = {name: builds[name] for name in names}
    jobs = {name: (hdr, subs, cuda_lib.CSRC)
            for name, (hdr, subs) in builds.items()}
    if args.baseline:
        jobs["pre"] = (None, [], Path(args.baseline).resolve())
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc a build
            libs = dict(zip(jobs, pool.map(
                lambda item: build(Path(tmp), item[0], *item[1]),
                jobs.items())))
        pre = libs.pop("pre", None)
        for name, lib in libs.items():
            if name != "filter_only":
                check(name, lib, dev)
        print("every build but filter_only bit-equal to plain_pool",
              flush=True)
        if pre is not None:
            new = libs.get("current") or build(Path(tmp), "new", None, [],
                                               cuda_lib.CSRC)
            baseline_ab(pre, new, dev)
        rng = np.random.default_rng(1)
        n = 1_000_000
        v = torch.from_numpy(cs.clustered(rng, n, 128))[None].to(dev)
        qs = v[0, torch.from_numpy(rng.choice(n, 32, replace=False))
               .to(dev)] + 0.01
        ops = {(prec, b): operands(v, qs[:b].contiguous(), prec)
               for prec in PRECS for _r, bs in SHAPES[:1] for b in bs}
        order = list(libs.items())
        for rnd, seq in enumerate((order, order[::-1])):
            for name, lib in seq:
                for prec in PRECS:
                    for r, bs in SHAPES:
                        for b in bs:
                            call = functools.partial(
                                mma_scan, lib, ops[prec, b], prec,
                                "l2_norm", r)
                            report(f"round {rnd} {name:12s} {prec} r={r:3d} "
                                   f"B={b:2d}", call)
        if "current" in libs:
            lib = libs["current"]
            for prec in PRECS:
                for r, bs in SHAPES:
                    for b in bs:
                        plan = kf.wide_mma_plan(b, 128, r, prec,
                                                lib.knn_fused_mma_smem_bytes)
                        print(f"plan {prec} r={r} B={b}: {plan}", flush=True)
                        for stages, words in kf.WIDE_RINGS:
                            try:
                                ring = kf._ring_plan(
                                    b, lambda s_, w_, rows, cap: (
                                        lib.knn_fused_mma_smem_bytes(
                                            kf._PREC_CODE[prec], s_, w_, 128,
                                            r, rows, cap)
                                        if (s_, w_) == (stages, words)
                                        else 0), "ring")
                            except ValueError:
                                continue
                            report(f"ring {prec} r={r:3d} B={b:2d} plan "
                                   f"{ring}", functools.partial(
                                       mma_scan, lib, ops[prec, b], prec,
                                       "l2_norm", r, ring))
    return 0


if __name__ == "__main__":
    sys.exit(main())
