"""What the chaos soak leaves allocated on the card, and who made it.

    python3 scripts/soak_memory_probe.py [--seed 7]

Builds the kernels, then runs chip_smoke's soak (``run_soak`` with
chip_smoke's cycles, ops and topology cycle) on the card while the CUDA
allocator keeps the Python stack of every live block. Once the soak has
closed its nodes it prints the card's name and power limit and one JSON
line: the bytes allocated over the soak, the blocks still allocated by
the frames of the port that made them, and the same after one
``gc.collect()``, which frees what only reference cycles among the
closed nodes' objects keep alive. Needs a card: the allocator's history
is CUDA's.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def left_by_frame(snapshot) -> dict:
    """Bytes of the live blocks of an allocator snapshot that carry a
    stack (those made while the history was on), by the port's frames that
    made them (up to three, innermost first)."""
    out: dict[str, int] = {}
    for segment in snapshot["segments"]:
        for block in segment["blocks"]:
            frames = block.get("frames") or []
            if block["state"] != "active_allocated" or not frames:
                continue
            ours = [f"{f['filename'].rsplit('opensearch_tpu_torch/', 1)[-1]}"
                    f":{f['line']} {f['name']}" for f in frames
                    if "opensearch_tpu_torch/" in f["filename"]]
            where = " < ".join(ours[:3]) or (
                f"{frames[0]['filename']}:{frames[0]['line']} "
                f"{frames[0]['name']}")
            out[where] = out.get(where, 0) + block["size"]
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=cs.SOAK_SEED)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from opensearch_tpu_torch.ops import cuda_lib
    from opensearch_tpu_torch.testing import soak

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    with ThreadPoolExecutor(len(cs.KERNELS)) as pool:
        list(pool.map(cuda_lib.build, cs.KERNELS))
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(
        enabled="state", context="state", stacks="python")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        report = soak.run_soak(
            args.seed, tmp, cycles=cs.SOAK_CYCLES,
            ops_per_cycle=cs.SOAK_OPS,
            topology_cycle=cs.SOAK_TOPOLOGY_CYCLE, device="cuda")
    soak_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    closed = torch.cuda.memory_allocated()
    before_gc = left_by_frame(torch.cuda.memory._snapshot())
    gc.collect()
    collected = torch.cuda.memory_allocated()
    after_gc = left_by_frame(torch.cuda.memory._snapshot())
    torch.cuda.memory._record_memory_history(enabled=None)
    print(json.dumps({
        "seed": args.seed, "digest": report.digest,
        "ops_completed": report.ops_completed, "soak_s": soak_s,
        "allocated_after_close": closed - mem0,
        "freed_by_gc": closed - collected,
        "allocated_after_gc": collected - mem0,
        "left_by_frame_before_gc": before_gc,
        "left_by_frame_after_gc": after_gc}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
