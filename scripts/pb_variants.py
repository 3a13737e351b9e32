"""Stage-1 variants of K4 (opensearch_tpu_torch/csrc/knn_pb.cu) on one NVIDIA
GPU.

    python3 scripts/pb_variants.py

Builds csrc/knn_pb.cu as it stands ("current", with nvcc's register and
spill report) and once for each variant in VARIANTS, a text substitution
in the source. Every build but "filter_only" must equal ``plain_pb_topk``
bit for bit on data whose dots are exact in f32 (sixteenths; B = 1, 33 and
129; k = 10; l2, cosine and dot). "filter_only" inserts no doc (its lists
stay empty): its time is the scan's and the filter's alone. Then each build's stage 1
is timed with CUDA events at the SIFT-1M shape (1,000,000 x 128 f32, l2,
k = 10) at B = 1, 32 and 128, twice, the second pass in reverse build
order, beside
the card's name and power limit. Needs nvcc; exits non-zero without a card
or when a build or a check fails.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from opensearch_tpu_torch.ops import cuda_lib  # noqa: E402
from opensearch_tpu_torch.ops import knn_blocks as kb  # noqa: E402

VARIANTS = {
    # the scan and the filter, with no doc inserted (lists stay empty)
    "filter_only": [("        if (!__any_sync(kFull, any)) continue;",
                     "        if (true) continue;")],
    # the passers' insertion called, not inlined, at each of its 8 sites
    "called_passers": [("__device__ __forceinline__ void add_passers(",
                        "__device__ __noinline__ void add_passers(")],
    # fewer warps at query tile 32, each seeing more of a block: 256
    # threads (two warps a group) and 128 (one)
    "qt32_256": [("  return qt >= 32 ? 512 : 256;",
                  "  return qt >= 128 ? 512 : 256;")],
    "qt32_128": [("  return qt >= 32 ? 512 : 256;",
                  "  return qt >= 128 ? 512 : (qt == 32 ? 128 : 256);")],
    # two CTAs an SM at query tiles 32 and 64 (256 threads, two 32 KB ring
    # stages), so one CTA's warps score while the other's select
    "cta2": [("  return qt >= 32 ? 512 : 256;", "  return qt >= 128 ? 512 : 256;"),
             ("(qt <= 32 ? 3 : 4)", "(qt == 32 || qt == 64 ? 2 : (qt < 32 ? 3 : 4))"),
             ("(qt <= 32 ? 16384 : 8192)", "(qt < 32 ? 16384 : 8192)"),
             ("__launch_bounds__(scan_threads(QT), 1) knn_pb_kernel(",
              "__launch_bounds__(scan_threads(QT), QT == 32 || QT == 64 ? 2 "
              ": 1) knn_pb_kernel("),
             ("  } else if (qt == 128) {",
              "  } else if (qt == 64) {\n    PB_LAUNCH(64, TIER_LISTS);\n"
              "  } else if (qt == 128) {")],
    # the current kernel counting, in device memory, the (query, step)
    # pairs filtered, those with a passer, the passers and the inserts
    "counted": [
        ('#include "knn_tile.cuh"\n',
         '#include "knn_tile.cuh"\n__device__ unsigned long long '
         'pb_count[4];\n'),
        ("        float lower = ord_float(low_g[gq + u]);\n",
         "        float lower = ord_float(low_g[gq + u]);\n"
         "        if (lane == 0) atomicAdd(&pb_count[0], 1ull);\n"),
        ("        if (!__any_sync(kFull, any)) continue;\n",
         "        if (!__any_sync(kFull, any)) continue;\n"
         "        if (lane == 0) atomicAdd(&pb_count[1], 1ull);\n"),
        ("  float v;\n  int c;\n  load_list(lv, lc, k, lane, v, c);\n",
         "  float v;\n  int c;\n  load_list(lv, lc, k, lane, v, c);\n"
         "  if (lane == 0) atomicAdd(&pb_count[2], (unsigned long long)("
         "__popc(mk[0]) + __popc(mk[1]) + __popc(mk[2]) + __popc(mk[3])));\n"),
        ("        const unsigned below = __ballot_sync(kFull, "
         "better(cv, cc, v, c));\n",
         "        const unsigned below = __ballot_sync(kFull, "
         "better(cv, cc, v, c));\n"
         "        if (lane == 0) atomicAdd(&pb_count[3], 1ull);\n"),
        ('extern "C" {\n',
         'extern "C" {\nint knn_pb_counts(unsigned long long* out, int reset) '
         '{\n  static const unsigned long long zero[4] = {0, 0, 0, 0};\n'
         '  if (reset) return (int)cudaMemcpyToSymbol(pb_count, zero, 32);\n'
         '  return (int)cudaMemcpyFromSymbol(out, pb_count, 32);\n}\n'),
    ],
}
SIMS = ("l2_norm", "cosine", "dot_product")
SIGNATURE = {
    "knn_pb_smem_bytes": (ctypes.c_size_t, [ctypes.c_int] * 4),
    "knn_pb_launch": (ctypes.c_int, [ctypes.c_void_p] * 7
                      + [ctypes.c_int] * 10 + [ctypes.c_void_p]),
}


def build(tmp: Path, name: str, subs) -> ctypes.CDLL:
    src = (cuda_lib.CSRC / "knn_pb.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{name}: {old!r} not found in knn_pb.cu")
        src = src.replace(old, new)
    cu, so = tmp / f"{name}.cu", tmp / f"lib{name}.so"
    cu.write_text(src)
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
                m = re.search(r"knn_pb_kernelILi(\d+)ELi(\d+)ELi(\d+)E", line)
                kernel = (f"knn_pb_kernel<{m[1]}, {m[2]}, {m[3]}>" if m
                          else "knn_pb_merge_kernel"
                          if "knn_pb_merge_kernel" in line else None)
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line and kernel:
                print(f"{kernel}: {line.split(':', 1)[1].strip()}; {spills}")
                kernel = None
    lib = ctypes.CDLL(str(so))
    for fn, (restype, argtypes) in SIGNATURE.items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def stage1(lib, v, nrm, ok, q, k, sim, exact=True, rows=None, qt=None):
    """K4 stage 1 through `lib` as ops/knn_blocks._launch_pb launches it,
    over the first `rows` queries (default all), at the wrapper's query
    tile or `qt`."""
    n, d = v.shape
    B = q.shape[0]
    qsq = (q * q).sum(1)
    tile, tier = kb.pb_plan(B, d, k, lib.knn_pb_smem_bytes)
    qt = qt or tile
    nb = -(-n // kb.PB_BLOCK)
    vals = torch.empty((nb, B, k), dtype=torch.float32, device=v.device)
    ids = torch.empty((nb, B, k), dtype=torch.int32, device=v.device)
    err = lib.knn_pb_launch(
        v.data_ptr(), nrm.data_ptr(), ok.data_ptr(), q.data_ptr(),
        qsq.data_ptr(), vals.data_ptr(), ids.data_ptr(), n, d, B,
        B if rows is None else rows, nb, k, qt, tier, kb._SIM_CODE[sim],
        int(exact), kb._stream(v.device))
    if err:
        raise SystemExit(f"launch failed: cudaError {err}")
    return vals, ids


def check(name, lib, dev) -> None:
    rng = np.random.default_rng(5)
    n = 50_000
    x = np.round(rng.standard_normal((n, 128)).astype(np.float32) * 16) / 16
    v = torch.from_numpy(np.clip(x, -4, 4)).to(dev)
    nrm = (v.double() ** 2).sum(1).float()
    ok = torch.from_numpy(rng.random(n) > 0.03).to(dev)
    for b in (1, 33, 129):
        q = kb._pad_queries(v[torch.from_numpy(rng.choice(n, b)).to(dev)],
                            kb.PB_QTILE)
        for sim in SIMS:
            pv, pi = kb.plain_pb_topk(v, nrm, ok, q, k=10, similarity=sim)
            fin = torch.isfinite(pv)
            for qt in (None, 64) if name == "cta2" and b > 1 else (None,):
                gv, gi = stage1(lib, v, nrm, ok, q, 10, sim, qt=qt)
                if not (torch.equal(gv, pv)
                        and torch.equal(gi[fin], pi[fin])):
                    raise SystemExit(f"{name}: stage 1 differs at B={b} "
                                     f"{sim} qt={qt}")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        builds = {"current": [], **VARIANTS}
        with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc a build
            libs = dict(zip(builds, pool.map(
                lambda item: build(Path(tmp), *item), builds.items())))
        for name, lib in libs.items():
            if name != "filter_only":
                check(name, lib, dev)
        print("every build but filter_only bit-equal to plain_pb_topk")
        counts = (ctypes.c_ulonglong * 4)()
        libs["counted"].knn_pb_counts.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_int]
        rng = np.random.default_rng(21)
        n = 1_000_000
        v = torch.from_numpy(np.clip(np.round(
            rng.integers(0, 120, (64, 128))[rng.integers(0, 64, n)]
            + rng.normal(0, 12, (n, 128))), 0, 255).astype(np.float32)).to(dev)
        nrm = (v.double() ** 2).sum(1).float()
        ok = torch.ones(n, dtype=torch.bool, device=dev)
        qs = torch.clamp(torch.round(v[:128] + 3.0), 0, 255)
        order = list(libs.items())
        for rnd, builds in enumerate((order, order[::-1])):
            for name, lib in builds:
                for b in (1, 32, 128):
                    q = kb._pad_queries(qs[:b].contiguous(), kb.PB_QTILE)
                    for qt in (None, 64) if name == "cta2" and b == 128 \
                            else (None,):
                        ms = time_ms(lambda: stage1(lib, v, nrm, ok, q, 10,
                                                    "l2_norm", rows=b, qt=qt))
                        print(f"round {rnd} {name:12s} B={b:3d} "
                              f"qt={qt or 'plan'}: stage 1 {ms:.4f} ms")
                    if name == "counted" and rnd == 0:
                        lib.knn_pb_counts(counts, 1)
                        stage1(lib, v, nrm, ok, q, 10, "l2_norm", rows=b)
                        torch.cuda.synchronize()
                        lib.knn_pb_counts(counts, 0)
                        per = b * -(-n // kb.PB_BLOCK)
                        print(f"counted B={b}: per (query, block) "
                              f"{counts[0] / per:.2f} filtered steps, "
                              f"{counts[1] / per:.2f} with a passer, "
                              f"{counts[2] / per:.2f} passers, "
                              f"{counts[3] / per:.2f} inserted one at a time")
    return 0


if __name__ == "__main__":
    sys.exit(main())
