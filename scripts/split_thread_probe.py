"""Where a re-layout's host time goes: one index split on the main thread
and on a worker thread of the same process.

    python3 scripts/split_thread_probe.py [--docs 20000] [--device cuda]
        [--threads main,worker,main,worker]

Builds one index of `--docs` clustered 128-d docs shaped like chip_smoke's
vec-2026.10 (a knn_vector, a keyword, a long, a date and a derived long),
write-blocks it, then runs ``TorchNode.resize_index("split", ...)`` into 2
shards once for each entry of `--threads` (by default four times,
alternating the main thread and a fresh worker thread, as the REST layer
runs `_split` and `_reindex`), and prints each run's
seconds and microseconds a doc beside the `_bulk`'s and the card's name
and power limit. Before that it times the translog op's text built by
``+`` and by one ``join``, and ``json.loads`` of one doc's source, on both
kinds of thread. With ``--device cpu`` it runs without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import timeit

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from opensearch_tpu_torch.node import TorchNode  # noqa: E402


def in_thread(fn):
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join()
    return out[0]


def payload_benches() -> None:
    v = np.random.default_rng(0).standard_normal(128).astype(
        np.float32).tolist()
    sj = json.dumps({"v": v, "tag": "ham", "views": 3})

    def plus():
        return ('{"op": "index", "id": ' + json.dumps("123")
                + ', "seq_no": ' + json.dumps(5)
                + ', "version": ' + json.dumps(1) + ', "source": ' + sj
                + ', "routing": ' + json.dumps(None) + '}').encode()

    def join():
        return "".join((
            '{"op": "index", "id": ', json.dumps("123"),
            ', "seq_no": ', json.dumps(5), ', "version": ', json.dumps(1),
            ', "source": ', sj, ', "routing": ', json.dumps(None),
            '}')).encode()

    for label, fn in (("op by +", plus), ("op by join", join),
                      ("json.loads", lambda: json.loads(sj))):
        def bench(fn=fn):
            return timeit.timeit(fn, number=20000) / 20000 * 1e6
        print(f"{label}: main {bench():.2f} us, worker "
              f"{in_thread(bench):.2f} us", flush=True)


def split_runs(device: str, n: int, threads: list[str]) -> None:
    node = TorchNode(tempfile.mkdtemp(), device=device)
    rng = np.random.default_rng(1)
    data = cs.clustered(rng, n, 128)
    node.create_index("src", {"settings": {"number_of_shards": 1},
                              "mappings": {"properties": {
                                  "v": {"type": "knn_vector",
                                        "dimension": 128,
                                        "similarity": "l2_norm"},
                                  "tag": {"type": "keyword"},
                                  "views": {"type": "long"}}}})
    t = time.perf_counter()
    node.bulk([("index", {"_index": "src", "_id": str(i)},
                {"v": data[i].tolist(), "tag": "ham", "views": i,
                 "ingested_at": "2026-10-01T00:00:00Z",
                 "views_k": i // 1000}) for i in range(n)])
    print(f"[{device}] _bulk {(time.perf_counter() - t) / n * 1e6:.1f} us "
          f"a doc", flush=True)
    node.refresh("src")
    node.put_index_settings("src", {"index.blocks.write": True})
    for i, where in enumerate(threads):
        name = f"dst-{i}"

        def split(name=name):
            t0 = time.perf_counter()
            node.resize_index("split", "src", name,
                              {"settings": {"index.number_of_shards": 2}})
            return time.perf_counter() - t0

        s = split() if where == "main" else in_thread(split)
        print(f"[{device}] split on the {where} thread: {s:.3f} s, "
              f"{s / n * 1e6:.1f} us a doc", flush=True)
        node.delete_index(name)
    node.close()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=20_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", default="main,worker,main,worker",
                    help="the thread of each split, in order: main or "
                         "worker")
    args = ap.parse_args()
    threads = args.threads.split(",")
    if not set(threads) <= {"main", "worker"}:
        ap.error("--threads takes main and worker")
    if args.device != "cpu":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
    payload_benches()
    split_runs(args.device, args.docs, threads)
    return 0


if __name__ == "__main__":
    sys.exit(main())
