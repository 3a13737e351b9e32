"""Variants of K2, the IVF-PQ ADC scan (opensearch_tpu_torch/csrc/adc_scan.cu),
on one NVIDIA GPU.

    python3 scripts/adc_variants.py [--variants current,radix8]
                                    [--baseline path/to/adc_scan.cu]

Builds csrc/adc_scan.cu as it stands ("current") and once for each text
substitution in VARIANTS, and prints nvcc's register and spill report for
every build's two kernels. "decode_only" keeps no candidate (stage 1
decodes, counts and stops; the merge writes empty pools): its stage-1 time
is the decode's alone. "scan_radix8" runs stage 1's histogram passes on 8
bits in place of 11, "merge_radix11" the merge's on 11 in place of 8.
"scan256" and "merge256" run stage 1 (512 threads) and stage 2 (1024)
with 256 threads a CTA. "bitonic_only" sorts every merge's winners with
the bitonic network (no rank placement up to 256). "one_cta" is the
current build launched with one CTA per (query, probe) over the whole
list (span = next_pow2(L_pad), at most 8192), "span1024" with parts of
at least 1024 slots, in place of the planned span. ``--baseline`` adds the build of
another source with the C interface of the design before this one (one
bitonic sort a chunk, a one-warp merge: ``adc_scan_smem_bytes`` and the
19-argument ``adc_scan_launch``), launched as its wrapper did ("baseline");
unpack it from an older commit with ``git archive``. Every build but
decode_only must equal ``plain_adc_pool`` (ids equal, scores within
rtol 1e-6 / atol 1e-6) at every shape. Then each build is timed with CUDA
events, and each of its two kernels (stage 1 ``adc_scan_kernel``, stage 2
``adc_merge_kernel``) read by name under torch.profiler, at the glove-100
shape (1,200,000 clustered 100-d cosine docs, nlist 512, m 20, nprobe 8,
fp32 LUT, R = 64) at B = 1 and 32 and on cell C's index (200,000 such
docs) at B = 1 and 8, twice, the second pass in reverse build order,
beside the card's name and power limit. Needs nvcc; exits non-zero without
a card or when a build or a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from opensearch_tpu_torch.ops import adc_scan as ads  # noqa: E402
from opensearch_tpu_torch.ops import cuda_lib, ivfpq  # noqa: E402

VARIANTS = {
    # stage 1 keeps nothing: the decode, the live count and the early exit
    "decode_only": [("  const int want = n_live < rp ? n_live : rp;",
                     "  const int want = 0;")],
    # stage 1's histogram passes on 8 bits in place of 11
    "scan_radix8": [("constexpr int kScanRadixBits = 11;",
                     "constexpr int kScanRadixBits = 8;")],
    # the merge's histogram passes on 11 bits in place of 8
    "merge_radix11": [("constexpr int kMergeRadixBits = 8;",
                       "constexpr int kMergeRadixBits = 11;")],
    # stage 1 with 256 threads a CTA in place of 512
    "scan256": [("constexpr int kScanThreads = 512;",
                 "constexpr int kScanThreads = 256;")],
    # the merge with 256 threads in place of 1024
    "merge256": [("constexpr int kMergeThreads = 1024;",
                  "constexpr int kMergeThreads = 256;")],
    # the merge always sorts by the bitonic network (no rank placement)
    "bitonic_only": [("constexpr int kRankMax = 256;",
                      "constexpr int kRankMax = 0;")],
}
# launched with another span, same build as "current": one CTA a whole
# list (span = next_pow2(L_pad), at most 8192), or parts of at least 1024
SPAN_VARIANTS = ("one_cta", "span1024")


def ptxas_report(name: str, stderr: str) -> None:
    """Each kernel's registers and spills from nvcc -Xptxas -v."""
    kernel, spills = None, ""
    for line in stderr.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(adc_scan_kernel|adc_merge_kernel)ILi(\d)ELb(\d)E",
                          line)
            kernel = (f"adc_scan_kernel<{m[2]}, {m[3]}>" if m else
                      "adc_merge_kernel" if "adc_merge_kernel" in line
                      else None)
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and kernel:
            print(f"{name}: {kernel}: {line.split(':', 1)[1].strip()}; "
                  f"{spills}")
            kernel = None


def build(tmp: Path, name: str, src: str):
    where = tmp / name
    where.mkdir()
    cu, so = where / "adc_scan.cu", where / "libadc_scan.so"
    cu.write_text(src)
    proc = subprocess.run([cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS,
                           "-Xptxas", "-v", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr}")
    ptxas_report(name, proc.stderr)
    lib = ctypes.CDLL(str(so))
    lib.adc_scan_launch.restype = ctypes.c_int
    if name == "baseline":
        lib.adc_scan_smem_bytes.restype = ctypes.c_size_t
        lib.adc_scan_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.adc_scan_launch.argtypes = ([ctypes.c_void_p] * 9
                                        + [ctypes.c_int] * 9
                                        + [ctypes.c_void_p])
    else:
        lib.adc_scan_launch.argtypes = ([ctypes.c_void_p] * 15
                                        + [ctypes.c_int] * 15
                                        + [ctypes.c_void_p])
    return lib


def launch_baseline(lib, lut, codes, ids, mask, probes, *, r: int):
    """The design before this one, as its wrapper launched it: chunks of a
    power of two of at most 2048 slots, halved (to 512) while the grid
    holds fewer than two CTAs per SM."""
    B, P, m, ks = lut.shape
    nlist, l_pad, _m = codes.shape
    dev = lut.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ch = 2048
    while ch > 512 and B * P * -(-l_pad // ch) < 2 * sms:
        ch //= 2
    ch = min(ch, 1 << max(int(l_pad - 1).bit_length(), 1))
    prec = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}[lut.dtype]
    n_chunks, rp = -(-l_pad // ch), min(r, ch)
    part_v = torch.empty((B, P * n_chunks, rp), dtype=torch.float32,
                         device=dev)
    part_p = torch.empty((B, P * n_chunks, rp), dtype=torch.int32, device=dev)
    vals = torch.empty((B, r), dtype=torch.float32, device=dev)
    out_ids = torch.empty((B, r), dtype=torch.int32, device=dev)
    err = lib.adc_scan_launch(
        lut.data_ptr(), codes.data_ptr(), mask.data_ptr(), ids.data_ptr(),
        probes.data_ptr(), part_v.data_ptr(), part_p.data_ptr(),
        vals.data_ptr(), out_ids.data_ptr(), B, P, nlist, l_pad, m, ks, r,
        ch, prec, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"baseline launch failed: cudaError {err}")
    return vals, out_ids


def caller(name: str, lib):
    if name == "baseline":
        return functools.partial(launch_baseline, lib)
    if name in SPAN_VARIANTS:
        def other_span(lut, codes, ids, mask, probes, *, r: int):
            B, P, m, ks = lut.shape
            l_pad = codes.shape[1]
            span = min(ads.MAX_SPAN, 1 << (l_pad - 1).bit_length())
            if name == "span1024":
                sms = torch.cuda.get_device_properties(
                    lut.device).multi_processor_count
                span = min(span, max(1024, ads.scan_plan(
                    B, P, l_pad, m, ks, lut.element_size(), sms)[0]))
            return ads.launch(lib, lut, codes, ids, mask, probes, r=r,
                              span=span)
        return other_span
    return functools.partial(ads.launch, lib)


def device_ms(fn, reps: int = 20) -> tuple[float, float]:
    """(stage 1, stage 2) device ms per call under torch.profiler with CUDA
    activity alone, each read by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = [0.0, 0.0]
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        ms = (evt.self_cuda_time_total if us is None else us) / 1e3 / reps
        for j, kernel in enumerate(("adc_scan_kernel", "adc_merge_kernel")):
            if kernel in evt.key:
                out[j] += ms
    if out == [0.0, 0.0]:
        raise SystemExit("torch.profiler recorded no K2 kernel: not measured")
    return out[0], out[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=None,
                    help="comma list of builds (default: current and every "
                         f"variant: {','.join([*VARIANTS, *SPAN_VARIANTS])}, "
                         "and baseline with --baseline)")
    ap.add_argument("--baseline", default=None,
                    help="an adc_scan.cu with the earlier design's C "
                         "interface, built and timed as 'baseline'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    current = (cuda_lib.CSRC / "adc_scan.cu").read_text()
    sources = {"current": current}
    for name, subs in VARIANTS.items():
        src = current
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"{name}: {old!r} not found in adc_scan.cu")
            src = src.replace(old, new)
        sources[name] = src
    if args.baseline:
        sources["baseline"] = Path(args.baseline).read_text()
    names = [*sources, *SPAN_VARIANTS]
    if args.variants:
        names = args.variants.split(",")
        unknown = set(names) - set(sources) - set(SPAN_VARIANTS)
        if unknown:
            ap.error(f"unknown builds {sorted(unknown)}")
    to_build = {n: sources[n] for n in sources
                if n in names or (n == "current"
                                  and set(SPAN_VARIANTS) & set(names))}
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(to_build)) as pool:  # one nvcc a build
            libs = dict(zip(to_build, pool.map(
                lambda item: build(Path(tmp), *item), to_build.items())))
        calls = {n: caller(n, libs[n if n in libs else "current"])
                 for n in names}
        rng = np.random.default_rng(1)
        order = list(calls.items())
        for key, n, bs in (("glove", chip_smoke.GLOVE_DOCS, (1, 32)),
                           ("cell_c", chip_smoke.ANN_MAIN_DOCS, (1, 8))):
            data = chip_smoke.ann_corpus(rng, n, chip_smoke.ANN_DIM)
            index = ivfpq.build(data, nlist=512, m=chip_smoke.ANN_M,
                                normalized=True, device=dev)
            shapes = {}
            for b in bs:
                q = data[rng.choice(n, b, replace=False)]
                q = q / np.linalg.norm(q, axis=1, keepdims=True)
                shapes[b] = chip_smoke.adc_operands(ads, ivfpq, index, q, 8,
                                                    "fp32")
                for name, fn in calls.items():
                    if name != "decode_only":
                        chip_smoke.compare_adc_pools(
                            ads, shapes[b], 64, f"{name} {key} B={b}", fn)
            print(f"{key} (n={n}, l_pad={index.l_pad}): every build but "
                  f"decode_only equals plain_adc_pool")
            for rnd, builds in enumerate((order, order[::-1])):
                for name, fn in builds:
                    for b in bs:
                        call = functools.partial(fn, *shapes[b], r=64)
                        ms = chip_smoke.time_ms(call, 50)
                        s1, s2 = device_ms(call)
                        print(f"round {rnd} {name:12s} {key:6s} B={b:3d}: "
                              f"call {ms:.4f} ms; device stage 1 {s1:.4f} "
                              f"ms, stage 2 {s2:.4f} ms, sum {s1 + s2:.4f}")
            del index, shapes
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
