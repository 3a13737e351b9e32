"""`opensearch-tpu-torch` launcher: config file + CLI flags -> a running node.

The analog of the reference's distribution entry
(distribution/src/bin/opensearch + Bootstrap/Node startup,
server/src/main/java/org/opensearch/bootstrap/OpenSearch.java): reads an
`opensearch.yml`-style config, overlays CLI flags, and boots either a
single node (default) or a TCP-cluster node (`--cluster`).

Config keys (the reference's names where they exist):
  cluster.name, node.name, http.port, transport.port, path.data,
  discovery.seed_hosts (["id=host:port", ...]),
  cluster.initial_cluster_manager_nodes ([ids])

The node runs on the card (``--device cuda``, the default; no card is an
error, raised before anything boots); ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def load_config(path: str | None) -> dict:
    if not path:
        for cand in ("opensearch.yml", "config/opensearch.yml"):
            if Path(cand).exists():
                path = cand
                break
    if not path or not Path(path).exists():
        return {}
    import yaml

    with open(path) as f:
        flat = yaml.safe_load(f) or {}
    return flat if isinstance(flat, dict) else {}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="opensearch-tpu-torch",
        description="search engine node on PyTorch and CUDA",
    )
    parser.add_argument("-c", "--config", help="opensearch.yml path")
    parser.add_argument("--node-name", default=None)
    parser.add_argument("--http-port", type=int, default=None)
    parser.add_argument("--transport-port", type=int, default=None)
    parser.add_argument("--data", default=None, help="data directory")
    parser.add_argument("--cluster", action="store_true",
                        help="join/bootstrap a TCP cluster (uses "
                             "discovery.seed_hosts)")
    parser.add_argument("--seeds", default=None,
                        help="n1=host:port,n2=host:port (cluster mode)")
    parser.add_argument("--bootstrap", default=None,
                        help="comma-separated initial voting node ids")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                             "cpu")
    args = parser.parse_args(argv)
    from opensearch_tpu_torch import backend

    # the card unless the caller asks for the CPU: no card raises here
    device = backend.resolve_device(args.device)

    conf = load_config(args.config)
    node_name = args.node_name or conf.get("node.name", "node-0")
    http_port = args.http_port or int(conf.get("http.port", 9200))
    data = Path(args.data or conf.get("path.data", "./data"))

    if args.cluster or args.seeds or conf.get("discovery.seed_hosts"):
        from opensearch_tpu_torch.server import amain, parse_seeds

        seeds_spec = args.seeds or ",".join(
            conf.get("discovery.seed_hosts") or []
        )
        if not seeds_spec:
            print("cluster mode requires --seeds or discovery.seed_hosts",
                  file=sys.stderr)
            return 2
        bootstrap = args.bootstrap or ",".join(
            conf.get("cluster.initial_cluster_manager_nodes") or []
        )
        ns = argparse.Namespace(
            node_id=node_name, host="127.0.0.1", http_port=http_port,
            data=str(data), seeds=seeds_spec,
            bootstrap=bootstrap or None, device=device,
        )
        _ = parse_seeds(seeds_spec)  # fail fast on malformed specs
        import asyncio

        try:
            asyncio.run(amain(ns))
        except KeyboardInterrupt:
            pass
        return 0

    # single node
    import asyncio

    from opensearch_tpu_torch.node import TorchNode
    from opensearch_tpu_torch.rest.http import HttpServer

    node = TorchNode(data, device=device, node_name=node_name)
    srv = HttpServer(node, "127.0.0.1", http_port)
    print(f"[{node_name}] http 127.0.0.1:{http_port} data={data}",
          flush=True)
    try:
        asyncio.run(srv.serve_forever())
    except KeyboardInterrupt:
        pass
    finally:
        node.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
