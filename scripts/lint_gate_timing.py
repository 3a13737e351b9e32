"""Wall seconds of the port's lint gate.

    python3 scripts/lint_gate_timing.py [--runs 10]

Runs ``python -m opensearch_tpu_torch.lint opensearch_tpu_torch`` (the
gate: every rule against the port's baseline, the default worker pool)
``--runs`` times from the checkout root, alternating a cold run
(``--no-cache``: every module's role summary extracted anew) with a warm
one (the summary cache, .tpulint_torch_cache.json, as the previous run
left it), and prints one JSON line: each run's wall seconds, the linter's
own ``elapsed_seconds`` (lint_paths alone, past interpreter start-up and
imports), its exit code, and the host's CPU count and 1-minute load
average at the start and end. Nothing in it sets the load: run it alone
for the gate's own time, or beside another command (the test suite under
``-n 6``) for its time under that load.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def one_run(cold: bool) -> dict:
    cmd = [sys.executable, "-m", "opensearch_tpu_torch.lint",
           "opensearch_tpu_torch", "--format", "json"]
    if cold:
        cmd.append("--no-cache")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          timeout=600)
    wall = time.perf_counter() - t0
    report = json.loads(proc.stdout)
    return {"cold": cold, "rc": proc.returncode, "wall_s": wall,
            "lint_s": report["elapsed_seconds"],
            "files": report["files_checked"],
            "violations": report["total_violations"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args()
    load0 = os.getloadavg()[0]
    runs = [one_run(cold=i % 2 == 0) for i in range(args.runs)]
    out = {"cpus": os.cpu_count(), "load1_start": load0,
           "load1_end": os.getloadavg()[0], "runs": runs}
    for kind in ("cold", "warm"):
        walls = sorted(r["wall_s"] for r in runs if r["cold"] == (kind == "cold"))
        if walls:
            out[f"{kind}_wall_s"] = {"min": walls[0], "max": walls[-1],
                                     "median": walls[len(walls) // 2]}
    print(json.dumps(out), flush=True)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
