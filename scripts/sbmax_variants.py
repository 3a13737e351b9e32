"""Stage-1 shape sweep of K5 (opensearch_tpu_torch/csrc/knn_sbmax.cu) on one
NVIDIA GPU.

    python3 scripts/sbmax_variants.py

Builds csrc/knn_sbmax.cu once as it stands ("current") and once for each
variant in VARIANTS, a text substitution of one of the functions that fix
stage 1's shape per query tile (scan_threads, ring_stages, stage_floats).
Every build's stage 1 must equal ``plain_sbmax`` bit for bit on data whose
dots are exact in f32 (sixteenths; B = 1, 9, 32, 40, 128 and 129; l2,
cosine and dot; exact and not). Then each build's stage 1 is timed with
CUDA events at the SIFT-1M shape (1,000,000 x 128 f32, l2) at B = 1, 32
and 128, twice, the second pass in reverse build order, beside the card's
name and power limit. Needs nvcc; exits non-zero without a card or when a
build or a check fails.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from opensearch_tpu_torch.ops import cuda_lib  # noqa: E402
from opensearch_tpu_torch.ops import knn_blocks as kb  # noqa: E402

STAGES = "  return qt <= 32 ? 3 : 4;"
FLOATS = "  return qt <= 32 ? 16384 : 8192;"
THREADS = "  return qt >= 32 ? 512 : 256;"
VARIANTS = {
    # 4 stages of 32 KB at every query tile
    "ring_4x32k": [(STAGES, "  return 4;"), (FLOATS, "  return 8192;")],
    # 3 stages of 64 KB at query tile 8 only
    "ring_3x64k_at_8": [(STAGES, "  return qt == 8 ? 3 : 4;"),
                        (FLOATS, "  return qt == 8 ? 16384 : 8192;")],
    # 256 threads at query tile 32 (the 128-row tile needs 16 warps)
    "threads_256_at_32": [(THREADS, "  return qt == 128 ? 512 : 256;")],
}
SIMS = ("l2_norm", "cosine", "dot_product")


def build(tmp: Path, name: str, subs) -> ctypes.CDLL:
    src = (cuda_lib.CSRC / "knn_sbmax.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{name}: {old!r} not found in knn_sbmax.cu")
        src = src.replace(old, new)
    cu, so = tmp / f"{name}.cu", tmp / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run(
        [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-I", str(cuda_lib.CSRC),
         "-o", str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.knn_sbmax_launch.restype = ctypes.c_int
    lib.knn_sbmax_launch.argtypes = ([ctypes.c_void_p] * 6
                                     + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    return lib


def stage1(lib, v, nrm, ok, qp, sim: str = "l2_norm", exact: bool = True):
    n, d = v.shape
    b, nb = qp.shape[0], -(-n // kb.PB_BLOCK)
    qsq = (qp * qp).sum(1)
    out = torch.empty((nb, b, kb.PB_BLOCK // kb.SUB), device=v.device)
    err = lib.knn_sbmax_launch(
        v.data_ptr(), nrm.data_ptr(), ok.data_ptr(), qp.data_ptr(),
        qsq.data_ptr(), out.data_ptr(), n, d, b, nb, kb.sbmax_query_tile(b),
        SIMS.index(sim), int(exact), torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"launch failed: cudaError {err}")
    return out


def time_ms(fn, iters: int = 30) -> float:
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
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: build(Path(tmp), name, subs) for name, subs in
                {"current": [], **VARIANTS}.items()}
        rng = np.random.default_rng(0)
        n, d = 50_000, 128
        x = np.clip(np.round(rng.standard_normal((n, d)) * 16) / 16,
                    -63 / 16, 63 / 16).astype(np.float32)
        v = torch.from_numpy(x).to(dev)
        ok = torch.from_numpy(rng.random(n) > 0.03).to(dev)
        nrm = torch.from_numpy((x.astype(np.float64) ** 2).sum(1)
                               .astype(np.float32)).to(dev)
        for b in (1, 9, 32, 40, 128, 129):
            qp = kb._pad_queries(
                v[torch.from_numpy(rng.choice(n, b)).to(dev)].clone(),
                kb.PB_QTILE)
            for sim in SIMS:
                for exact in (True, False):
                    want = kb.plain_sbmax(v, nrm, ok, qp, similarity=sim,
                                          exact=exact)
                    for name, lib in libs.items():
                        if not torch.equal(stage1(lib, v, nrm, ok, qp, sim,
                                                  exact), want):
                            raise SystemExit(f"{name}: stage 1 differs from "
                                             f"plain_sbmax at B={b} {sim} "
                                             f"exact={exact}")
        print(f"every build bit-equal to plain_sbmax ({', '.join(libs)})")
        n = 1_000_000
        v = torch.randint(0, 256, (n, d), device=dev).float()
        nrm = (v.double() ** 2).sum(1).float()
        ok = torch.ones(n, dtype=torch.bool, device=dev)
        times: dict[tuple[str, int], list[float]] = {}
        for order in (list(libs), list(reversed(libs))):
            for name in order:
                for b in (1, 32, 128):
                    qp = kb._pad_queries(v[:b] + 1, kb.PB_QTILE)
                    times.setdefault((name, b), []).append(time_ms(
                        lambda: stage1(libs[name], v, nrm, ok, qp)))
        for (name, b), ms in times.items():
            print(f"stage 1 {name} B={b}: {ms[0]:.4f} / {ms[1]:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
