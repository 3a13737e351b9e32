"""Cross-cluster search: remote cluster registry + fan-out client.

The analog of the reference's CCS stack
(server/src/main/java/org/opensearch/transport/RemoteClusterService.java:80
+ RemoteClusterAware's "cluster:index" expression split and
TransportSearchAction's remote shard fan-out): remote clusters register
under `cluster.remote.<alias>.seeds` dynamic settings; search expressions
`alias:pattern` route to them; the coordinator merges remote hits with
local ones and reports the per-cluster `_clusters` section.

Transport: the remote's REST surface over HTTP (urllib). The reference
dials the binary transport; this engine's REST carries the same search
contract, and a zero-dependency HTTP client keeps CCS usable against any
node of a remote cluster — the sniff/proxy connection-strategy split
collapses to "first reachable seed".
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any

from opensearch_tpu_torch.common.errors import (
    ConnectTransportException,
    IllegalArgumentException,
)

REMOTE_SEPARATOR = ":"


def split_index_expression(expr: str) -> tuple[dict[str, list[str]], list[str]]:
    """"c1:logs-*,local,c2:x" -> ({"c1": ["logs-*"], "c2": ["x"]}, ["local"])
    (RemoteClusterAware.groupClusterIndices)."""
    remotes: dict[str, list[str]] = {}
    locals_: list[str] = []
    for part in (expr or "").split(","):
        part = part.strip()
        if not part:
            continue
        if REMOTE_SEPARATOR in part and not part.startswith(REMOTE_SEPARATOR):
            alias, _, pattern = part.partition(REMOTE_SEPARATOR)
            remotes.setdefault(alias, []).append(pattern)
        else:
            locals_.append(part)
    return remotes, locals_


class RemoteClusterService:
    """Registry of remote clusters + HTTP search client."""

    def __init__(self, node):
        self.node = node

    def registered(self) -> dict[str, list[str]]:
        """alias -> seed list from cluster.remote.<alias>.seeds settings."""
        out: dict[str, list[str]] = {}
        for store in (getattr(self.node, "_cluster_settings", {}) or {},
                      getattr(self.node, "_transient_cluster_settings", {}) or {}):
            for key, value in store.items():
                parts = key.split(".")
                if len(parts) == 4 and parts[0] == "cluster" \
                        and parts[1] == "remote" and parts[3] == "seeds" \
                        and value is not None:
                    seeds = (value if isinstance(value, list)
                             else str(value).split(","))
                    out[parts[2]] = [str(s).strip() for s in seeds if s]
        return out

    def info(self) -> dict:
        """GET /_remote/info (RemoteClusterService.getRemoteConnectionInfos)."""
        return {
            alias: {
                "seeds": seeds,
                "connected": True,  # lazily dialed on first use
                "num_nodes_connected": 1,
                "max_connections_per_cluster": 1,
                "initial_connect_timeout": "30s",
                "skip_unavailable": False,
            }
            for alias, seeds in self.registered().items()
        }

    def _base_url(self, alias: str) -> str:
        seeds = self.registered().get(alias)
        if not seeds:
            raise IllegalArgumentException(
                f"no such remote cluster: [{alias}]"
            )
        seed = seeds[0]
        if not seed.startswith("http"):
            seed = f"http://{seed}"
        return seed.rstrip("/")

    def search_remote(self, alias: str, index_expr: str, body: dict,
                      timeout_s: float = 30.0) -> dict:
        """One remote cluster's full search response."""
        url = f"{self._base_url(alias)}/{index_expr or '_all'}/_search"
        data = json.dumps(body or {}).encode()
        req = urllib.request.Request(
            url, data=data, method="POST",
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:200]
            raise IllegalArgumentException(
                f"remote cluster [{alias}] search failed: HTTP {e.code} "
                f"{detail}"
            ) from e
        except (urllib.error.URLError, OSError) as e:
            raise ConnectTransportException(
                f"unable to connect to remote cluster [{alias}]: {e}"
            ) from e


def merge_cross_cluster(local_resp: dict | None,
                        remote_resps: dict[str, dict],
                        body: dict) -> dict:
    """Merge a local response with per-remote responses: hits re-sorted by
    (score|sort values), remote hit _index prefixed "alias:index"
    (SearchResponseMerger semantics)."""
    size = int(body.get("size", 10))
    from_ = int(body.get("from", 0))
    sort = body.get("sort")
    all_hits: list[tuple[Any, dict]] = []
    total = 0
    max_score = None
    took = 0
    shards = {"total": 0, "successful": 0, "skipped": 0, "failed": 0}
    responses = ([("", local_resp)] if local_resp is not None else []) + [
        (alias, r) for alias, r in remote_resps.items()
    ]
    for alias, resp in responses:
        took = max(took, resp.get("took", 0))
        for k in shards:
            shards[k] += resp.get("_shards", {}).get(k, 0)
        h = resp.get("hits", {})
        t = h.get("total")
        if isinstance(t, dict):
            total += t.get("value", 0)
        elif isinstance(t, int):
            total += t
        ms = h.get("max_score")
        if ms is not None and (max_score is None or ms > max_score):
            max_score = ms
        for hit in h.get("hits", []):
            if alias:
                hit = {**hit, "_index": f"{alias}:{hit.get('_index')}"}
            all_hits.append(hit)

    if sort:
        sort_list = [sort] if isinstance(sort, (str, dict)) else list(sort)
        orders = []
        for spec in sort_list:
            if isinstance(spec, str):
                orders.append("desc" if spec == "_score" else "asc")
            else:
                fname = next(iter(spec), None)
                conf = spec.get(fname)
                if isinstance(conf, str):
                    orders.append(conf)
                elif isinstance(conf, dict):
                    orders.append(conf.get(
                        "order", "desc" if fname == "_score" else "asc"))
                else:
                    orders.append("desc" if fname == "_score" else "asc")

        def key(hit):
            parts = []
            for i, v in enumerate(hit.get("sort", [])):
                desc = i < len(orders) and orders[i] == "desc"
                if v is None:
                    parts.append((1, 0, 0))
                elif isinstance(v, str):
                    parts.append((0, 1, _Rev(v) if desc else v))
                else:
                    parts.append((0, 0, -v if desc else v))
            return tuple(parts)

        all_hits.sort(key=key)
    else:
        all_hits.sort(key=lambda hh: -(hh.get("_score") or 0.0))
    page = all_hits[from_: from_ + size]
    num_clusters = len(remote_resps) + (1 if local_resp is not None else 0)
    return {
        "took": took,
        "timed_out": False,
        "_shards": shards,
        "_clusters": {"total": num_clusters, "successful": num_clusters,
                      "skipped": 0},
        "hits": {
            "total": {"value": total, "relation": "eq"},
            "max_score": max_score,
            "hits": page,
        },
    }


class _Rev:
    """Reverses string comparison for descending merge keys."""

    __slots__ = ("v",)

    def __init__(self, v: str):
        self.v = v

    def __lt__(self, other: "_Rev") -> bool:
        return other.v < self.v

    def __eq__(self, other: object) -> bool:
        return isinstance(other, _Rev) and other.v == self.v
