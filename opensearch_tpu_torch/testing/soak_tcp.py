"""Elastic-topology soak on the REAL TcpTransport (invariants-only).

The MockTransport soak (testing/soak.py) owns the byte-identical replay
contract; this runner re-drives the same reshape chain — node JOIN,
rebalance onto the new capacity, watermark-driven EVACUATION, graceful
DRAIN — against live loopback sockets, where scheduling is real and
nothing replays. So it checks INVARIANTS, not digests:

 - every acked write is searchable at the end, through every live node;
 - routing converges to all-STARTED with no copy on the drained node and
   no replica on the over-watermark node;
 - client-visible unavailability stays bounded (consecutive all-nodes
   probe failures under a hard ceiling);
 - exactly one stable leader at the end.

Budgeted by ``--seconds`` (default 60): the whole chain must land inside
the budget or the run fails. The nodes run on the card (``--device cuda``,
the default) or the CPU (``--device cpu``):

    python -m opensearch_tpu_torch.testing.soak_tcp --seconds 90 --device cpu

Every node's disk reading is pinned to DISK_USAGE_PCT until the ramp moves
one: the nodes share this host's disk, whose fill is not the cluster's,
and over the 90% high watermark the decider would leave every replica
unassigned.
"""

from __future__ import annotations

import asyncio
import json
import socket
import time
from typing import Any

from opensearch_tpu_torch.server import ClusterServer

# a reshape step may take a while on a loaded box, but client-visible
# TOTAL unavailability (no node answers) must stay far below it
MAX_CONSECUTIVE_DARK_PROBES = 40  # x 0.25s probe gap = 10s dark ceiling
DISK_USAGE_PCT = 50.0  # each node's disk reading, below every watermark


def free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


async def http(port: int, method: str, path: str, body: Any = None,
               timeout: float = 10.0):
    async def _exchange():
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        try:
            data = (json.dumps(body).encode() if body is not None
                    else b"")
            writer.write(
                (f"{method} {path} HTTP/1.1\r\nhost: x\r\n"
                 f"content-length: {len(data)}\r\n\r\n").encode() + data)
            await writer.drain()
            status = int((await reader.readline()).split()[1])
            length = 0
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode().partition(":")
                if k.strip().lower() == "content-length":
                    length = int(v)
            payload = (json.loads(await reader.readexactly(length))
                       if length else None)
            return status, payload
        finally:
            writer.close()

    return await asyncio.wait_for(_exchange(), timeout)


class TcpSoakError(AssertionError):
    pass


class TcpSoak:
    """One reshape soak: boot, traffic, join/evacuate/drain, verify."""

    INDEX = "logs"

    def __init__(self, tmp_path, seconds: float = 60.0, nodes: int = 3,
                 device="cuda"):
        self.tmp_path = tmp_path
        self.device = device
        self.budget_s = seconds
        ports = free_ports(2 * nodes + 2)
        self.node_ids = [f"n{i}" for i in range(nodes)]
        self.seeds = {nid: ("127.0.0.1", ports[i])
                      for i, nid in enumerate(self.node_ids)}
        self.http_ports = {nid: ports[nodes + i]
                           for i, nid in enumerate(self.node_ids)}
        self.joiner_ports = (ports[-2], ports[-1])  # transport, http
        self.servers: dict[str, ClusterServer] = {}
        self.t0 = 0.0
        self.acked: set[str] = set()
        self.milestones: list[dict] = []
        self.searches_ok = 0
        self.dark_streak = 0
        self.max_dark_streak = 0
        self._stop_traffic = asyncio.Event()

    # -- plumbing -----------------------------------------------------------

    def _deadline(self) -> float:
        return self.t0 + self.budget_s

    def _remaining(self) -> float:
        return self._deadline() - time.monotonic()

    def milestone(self, event: str, **fields: Any) -> None:
        at = round(time.monotonic() - self.t0, 2)
        self.milestones.append({"event": event, "at_s": at, **fields})
        print(f"[{at:7.2f}s] {event} "
              f"{' '.join(f'{k}={v}' for k, v in fields.items())}",
              flush=True)

    def live_http_ports(self) -> list[int]:
        return [self.http_ports[nid] for nid in self.servers]

    def a_leader(self) -> ClusterServer:
        leaders = [s for s in self.servers.values() if s.node.is_leader]
        if len(leaders) != 1:
            raise TcpSoakError(f"expected one leader, saw "
                               f"{[s.node.node_id for s in leaders]}")
        return leaders[0]

    def routing(self) -> list[dict]:
        state = self.a_leader().node.applied_state
        return [{"node": r.node_id, "primary": r.primary,
                 "state": r.state, "relocating": r.relocating_node,
                 "shard": r.shard}
                for r in state.shards_for_index(self.INDEX)]

    async def wait_for(self, what: str, cond, poll_s: float = 0.25):
        """Poll `cond` until true; the shared budget is the deadline."""
        while True:
            try:
                if cond():
                    return
            except (TcpSoakError, KeyError, StopIteration):
                pass
            if self._remaining() <= 0:
                raise TcpSoakError(
                    f"budget exhausted waiting for {what}; "
                    f"routing={self.routing()}")
            await asyncio.sleep(poll_s)

    # -- cluster lifecycle --------------------------------------------------

    def server(self, nid: str, tport: int, hport: int,
               seeds: dict) -> ClusterServer:
        srv = ClusterServer(nid, self.tmp_path / nid, "127.0.0.1", tport,
                            hport, seeds, loop=asyncio.get_running_loop(),
                            device=self.device)
        srv.node.disk_usage_pct = DISK_USAGE_PCT
        return srv

    async def start(self) -> None:
        for nid in self.node_ids:
            srv = self.server(nid, self.seeds[nid][1], self.http_ports[nid],
                              self.seeds)
            self.servers[nid] = srv
            await srv.start(bootstrap=self.node_ids)

    async def stop(self) -> None:
        for srv in self.servers.values():
            try:
                await srv.aclose()
            except Exception as e:  # noqa: BLE001 - teardown
                print(f"teardown: {srv.node.node_id}: {e}", flush=True)

    async def wait_leader(self) -> str:
        def stable():
            leaders = {nid for nid, s in self.servers.items()
                       if s.node.is_leader}
            known = {s.node.coordinator.leader_id
                     for s in self.servers.values()}
            return len(leaders) == 1 and known == {next(iter(leaders))}
        await self.wait_for("stable leader", stable)
        return self.a_leader().node.node_id

    # -- live traffic -------------------------------------------------------

    async def traffic(self) -> None:
        """Round-robin writes + count searches through every live node;
        tracks the acked-write ledger and the dark-probe streak."""
        seq = 0
        while not self._stop_traffic.is_set():
            ports = self.live_http_ports()
            port = ports[seq % len(ports)]
            doc_id = f"d{seq}"
            ok = False
            try:
                status, resp = await http(
                    port, "PUT", f"/{self.INDEX}/_doc/{doc_id}",
                    {"n": seq}, timeout=5.0)
                if status in (200, 201) and resp and \
                        resp.get("_shards", {}).get("failed", 1) == 0:
                    self.acked.add(doc_id)
                    ok = True
            except (ConnectionError, OSError, asyncio.TimeoutError,
                    asyncio.IncompleteReadError):
                pass
            if seq % 3 == 2:
                try:
                    status, resp = await http(
                        port, "POST", f"/{self.INDEX}/_search",
                        {"query": {"match_all": {}}, "size": 0},
                        timeout=5.0)
                    if status == 200:
                        self.searches_ok += 1
                        ok = True
                except (ConnectionError, OSError, asyncio.TimeoutError,
                        asyncio.IncompleteReadError):
                    pass
            self.dark_streak = 0 if ok else self.dark_streak + 1
            self.max_dark_streak = max(self.max_dark_streak,
                                       self.dark_streak)
            if self.dark_streak > MAX_CONSECUTIVE_DARK_PROBES:
                raise TcpSoakError(
                    f"client went dark for {self.dark_streak} straight "
                    f"probes (> {MAX_CONSECUTIVE_DARK_PROBES})")
            seq += 1
            await asyncio.sleep(0.25)

    # -- the reshape chain --------------------------------------------------

    async def join_node(self) -> str:
        nid = f"n{len(self.node_ids)}"
        tport, hport = self.joiner_ports
        seeds = dict(self.seeds)
        seeds[nid] = ("127.0.0.1", tport)
        # discovery address propagation: sitting members learn the
        # joiner's published address (the seed-host-provider analog —
        # TcpTransport resolves strictly from its seeds map)
        for srv in self.servers.values():
            srv.transport.seeds[nid] = seeds[nid]
        srv = self.server(nid, tport, hport, seeds)
        # no bootstrap: the fresh node must DISCOVER the sitting leader
        # and join — booting a second cluster would be a split brain
        await srv.start(bootstrap=None)
        self.servers[nid] = srv
        self.http_ports[nid] = hport
        self.milestone("join_started", node=nid)
        await self.wait_for(
            f"{nid} joined",
            lambda: nid in self.a_leader().node.applied_state.nodes
            and srv.node.coordinator.leader_id is not None)
        self.milestone("join_warm", node=nid)
        return nid

    async def wait_rebalanced_onto(self, nid: str) -> None:
        def holds_copy():
            return any(r["node"] == nid and r["state"] == "STARTED"
                       for r in self.routing())
        await self.wait_for(f"rebalance onto {nid}", holds_copy)
        self.milestone("rebalanced", node=nid)

    async def watermark_evacuation(self, exclude: set[str]) -> str:
        victim = next(r["node"] for r in sorted(
            self.routing(), key=lambda r: (r["node"] or ""))
            if not r["primary"] and r["state"] == "STARTED"
            and r["node"] not in exclude)
        self.servers[victim].node.disk_usage_pct = 95.0
        self.milestone("disk_ramp", node=victim, pct=95.0)

        def evacuated():
            rt = self.routing()
            return (not any(r["relocating"] for r in rt)
                    and not any(r["node"] == victim and not r["primary"]
                                for r in rt))
        await self.wait_for(f"evacuation off {victim}", evacuated)
        self.milestone("evacuated", node=victim)
        self.servers[victim].node.disk_usage_pct = 40.0
        return victim

    async def drain_and_depart(self, exclude: set[str]) -> str:
        leader_id = self.a_leader().node.node_id
        target = next(nid for nid in self.node_ids
                      if nid != leader_id and nid not in exclude)
        port = self.http_ports[leader_id]
        status, resp = await http(
            port, "PUT", "/_cluster/settings",
            {"transient": {
                "cluster.routing.allocation.exclude._name": target}})
        if status != 200:
            raise TcpSoakError(f"exclude PUT failed: {status} {resp}")
        self.milestone("drain_started", node=target)

        def drained():
            rt = self.routing()
            return (all(r["state"] == "STARTED" for r in rt)
                    and not any(r["node"] == target
                                or r["relocating"] == target
                                for r in rt))
        await self.wait_for(f"drain of {target}", drained)
        # stop the node FIRST, then lift the filter: a cleared exclude
        # with the node still up would invite copies straight back
        srv = self.servers.pop(target)
        self.http_ports.pop(target)
        await srv.aclose()
        self.milestone("depart", node=target)
        leader_id = self.a_leader().node.node_id
        await http(self.http_ports[leader_id], "PUT", "/_cluster/settings",
                   {"transient": {
                       "cluster.routing.allocation.exclude._name": None}})
        await self.wait_for(
            f"{target} evicted from membership",
            lambda: target not in self.a_leader().node.applied_state.nodes)
        return target

    # -- final invariants ---------------------------------------------------

    async def verify(self, departed: str, full_node: str) -> None:
        def converged():
            rt = self.routing()
            return rt and all(r["state"] == "STARTED"
                              and not r["relocating"] for r in rt)
        await self.wait_for("final convergence", converged)
        rt = self.routing()
        if any(r["node"] == departed for r in rt):
            raise TcpSoakError(f"copy still on drained {departed}: {rt}")
        if any(r["node"] == full_node and not r["primary"] for r in rt):
            raise TcpSoakError(
                f"replica back on watermarked {full_node}: {rt}")
        # every acked write searchable through EVERY live node (a write
        # whose ack was lost to a connection error may ALSO have landed —
        # at-least-once is fine, loss is not), and all nodes agree
        any_port = self.live_http_ports()[0]
        await http(any_port, "POST", f"/{self.INDEX}/_refresh")
        totals = set()
        for nid, port in sorted(self.http_ports.items()):
            status, resp = await http(
                port, "POST", f"/{self.INDEX}/_search",
                {"query": {"match_all": {}}, "size": 10_000})
            if status != 200:
                raise TcpSoakError(f"final search via {nid}: {status}")
            totals.add(resp["hits"]["total"]["value"])
            present = {h["_id"] for h in resp["hits"]["hits"]}
            lost = self.acked - present
            if lost:
                raise TcpSoakError(
                    f"acked-write loss via {nid}: {sorted(lost)[:8]} "
                    f"({len(lost)} of {len(self.acked)} acked)")
        if len(totals) != 1:
            raise TcpSoakError(f"nodes disagree on doc count: {totals}")
        self.milestone("verified", acked=len(self.acked),
                       searches_ok=self.searches_ok,
                       max_dark_streak=self.max_dark_streak)

    # -- orchestration ------------------------------------------------------

    async def run(self) -> dict:
        self.t0 = time.monotonic()
        await self.start()
        leader0 = await self.wait_leader()
        self.milestone("booted", leader=leader0)
        status, resp = await http(
            self.http_ports[leader0], "PUT", f"/{self.INDEX}",
            {"settings": {"index": {"number_of_shards": 2,
                                    "number_of_replicas": 1}}})
        if status != 200 or not (resp or {}).get("acknowledged"):
            raise TcpSoakError(f"create index: {status} {resp}")
        await self.wait_for(
            "initial green",
            lambda: all(r["state"] == "STARTED" for r in self.routing()))
        self.milestone("reshape_start")

        traffic = asyncio.ensure_future(self.traffic())
        try:
            joined = await self.join_node()
            await self.wait_rebalanced_onto(joined)
            full = await self.watermark_evacuation(exclude={joined})
            departed = await self.drain_and_depart(
                exclude={joined, full})
            self.milestone("reshape_done",
                           members=sorted(self.servers))
            # sustain: the reshape chain can land fast on an idle box —
            # keep traffic flowing on the reshaped cluster so the final
            # ledger audit has a real write history behind it
            await asyncio.sleep(
                min(8.0, max(0.0, self._remaining() - 10.0)))
        finally:
            self._stop_traffic.set()
            # surface a dark-streak failure from inside the traffic task
            try:
                await traffic
            except asyncio.CancelledError:
                pass
        await self.verify(departed, full)
        return {
            "seconds": round(time.monotonic() - self.t0, 2),
            "budget_s": self.budget_s,
            "members": sorted(self.servers),
            "writes_acked": len(self.acked),
            "searches_ok": self.searches_ok,
            "max_dark_streak": self.max_dark_streak,
            "milestones": self.milestones,
        }


def main(argv: list[str] | None = None) -> int:
    import argparse
    import tempfile

    parser = argparse.ArgumentParser(
        description="elastic-topology soak on the real TCP transport "
                    "(invariants-only; no replay)")
    parser.add_argument("--seconds", type=float, default=60.0,
                        help="hard wall-clock budget for the whole chain")
    parser.add_argument("--nodes", type=int, default=3)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                             "cpu")
    args = parser.parse_args(argv)

    async def scenario(tmp) -> dict:
        from pathlib import Path

        soak = TcpSoak(Path(tmp), seconds=args.seconds, nodes=args.nodes,
                       device=args.device)
        try:
            return await soak.run()
        finally:
            await soak.stop()

    with tempfile.TemporaryDirectory() as tmp:
        try:
            report = asyncio.run(scenario(tmp))
        except TcpSoakError as e:
            print(f"TCP SOAK FAILED: {e}")
            return 1
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
