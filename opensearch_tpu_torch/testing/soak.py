"""Ingest-while-serving chaos soak: seeded scenario replay + invariants.

The scenario-diversity tier the ROADMAP's north star asks for (open item
4): a deterministic workload generator interleaves heavy indexing / bulk /
refresh / force-merge (and the relocations and re-recoveries that node
kill/heal cycles force) against a live mixed query stream — BM25 match,
kNN through the dispatch batcher, aggregations, hybrid BM25+kNN fusion,
msearch, scroll and PIT — on a multi-node simulated cluster, while a
:class:`FaultScheduler` injects node kills, partitions, slow links,
one-way drops, disk-full ramps (the DiskThresholdDecider must evacuate),
clock skew and slow data workers from the MockTransport disruption
machinery and the node-level fault hooks.

Cluster SHAPE is part of the seeded plan too: a topology cycle
(``topology_cycle``) runs an elastic reshape under the live mixed
traffic — a fresh node boots mid-soak and joins (receiving peer
recoveries and warming its residency board before it takes query
traffic), the join triggers an online rebalance, a ``disk_usage_pct``
ramp pushes one node over the high watermark so the decider evacuates
its replicas, and finally one node is gracefully drained
(``cluster.routing.allocation.exclude._name``) and departs with zero
acked-write loss. Optional cluster-mode snapshots
(:class:`~opensearch_tpu_torch.snapshots.service.ClusterSnapshotsService`)
ride the op mix: create/status/restore cycles interleave with bulk and
chaos, and every restored index must match the acked-write ledger at
snapshot time.

Everything is replayable from ONE seed: virtual time comes from the
DeterministicTaskQueue (installed via timeutil.clock_scope), entropy from
the queue's seeded RNG (randutil.rng_scope), and every workload/fault
decision is drawn at PLAN time from seed-derived `random.Random` streams,
so op interleavings are a pure function of the seed. On any invariant
violation the seed is printed with the exact replay command and the
failure carries the event-log digest, so a bug found at 3am reproduces
byte-identically on a laptop (`--replay SEED`).

A pluggable invariant checker asserts, at runtime and after each cycle's
quiesce:

- **no-acked-write-loss** — every acked create is searchable, every acked
  delete stays gone, all copies of a shard agree on doc counts;
- **snapshot-isolation** — a search response never returns the same _id
  twice (a torn snapshot double-serves a doc), never returns phantom ids,
  and the reader generation stamped per shard partial
  (search/service.py `_generations`) never falls below the generation the
  engine had already published when the query was issued;
- **recovery-monotonicity** — recovery progress records only move
  forward: stages in order, counters non-decreasing, terminal stages
  immutable;
- **shed-correctness** — every issued request completes exactly once
  (shed 429s included), and shed requests leave no queue slots behind;
- **bounded-queues** — the kNN batcher queue, wlm bulk slots and reader
  contexts all return to zero/empty at quiesce;
- **convergence** — after heal the cluster returns to one agreed leader,
  all shards STARTED on live nodes, nothing relocating or unassigned;
- **interactive-under-flood** — with a wlm `enforced` group flooding
  bulk, the flood sheds 429s at its slot share while every interactive
  query issued during the flood completes;
- **watermark-respected** — no shard is ever newly assigned to a node
  the leader already knew was over the high disk watermark;
- **relocation-isolation** — one response never merges two copies of
  the same shard (a pre-move and a post-move snapshot);
- **bounded-unavailability** — every shard keeps a live serving copy,
  with only a bounded probe-streak of unavailability tolerated while
  fault recovery runs (zero tolerance while a relocation's live source
  should be serving);
- **balanced-convergence** — the routing table at quiesce is a FIXED
  POINT of the allocator (re-running reroute with the leader's disk
  view changes nothing: balanced, fully STARTED);
- **throughput-floor** — per-cycle per-class ops/sec never drop below
  a seed-recorded baseline floor (the `soak_baseline.json` ratchet).

Run it::

    python -m opensearch_tpu_torch.testing.soak --seed 7 --cycles 3
    python -m opensearch_tpu_torch.testing.soak --replay 7   # byte-identical

Every node runs on the card (``--device cuda``, the default; without one
it raises) unless asked for the CPU (``--device cpu``).

Add a scenario: extend `_plan_cycle_ops` (one weighted entry + a
`_issue_*` method). Add an invariant: subclass :class:`Invariant` and pass
it via ``run_soak(extra_invariants=[...])`` — hooks fire per response
(`on_response`), per periodic probe (`at_probe`) and per cycle quiesce
(`at_quiesce`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import random
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

from opensearch_tpu_torch.common import randutil, timeutil
from opensearch_tpu_torch.testing.sim import DeterministicTaskQueue, MockTransport

# stage order for recovery-progress monotonicity; terminal stages rank top
_STAGE_RANK = {"INIT": 0, "INDEX": 1, "TRANSLOG": 2, "FINALIZE": 3,
               "DONE": 4, "FAILED": 4}

_VEC_DIM = 4


class SoakFailure(AssertionError):
    """An invariant violation (or a wedged run). Carries everything needed
    to reproduce: the seed, the cycle, and the event-log digest up to the
    failure point."""

    def __init__(self, seed: int, cycle: int, invariant: str, detail: str,
                 digest: str):
        self.seed = seed
        self.cycle = cycle
        self.invariant = invariant
        self.detail = detail
        self.digest = digest
        super().__init__(
            f"[{invariant}] cycle {cycle}: {detail}\n"
            f"  seed={seed} digest={digest}\n"
            f"  replay: python -m opensearch_tpu_torch.testing.soak --replay {seed}"
        )


@dataclass
class SoakConfig:
    seed: int
    cycles: int = 3
    nodes: int = 3
    ops_per_cycle: int = 30
    cycle_ms: int = 20_000
    chaos: bool = True
    # which cycle runs the wlm bulk-flood scenario (-1 disables)
    flood_cycle: int = 1
    # the tail scenario: EVERY cycle runs background bulk+msearch
    # flood pressure, with interactive probes whose virtual-time latency
    # the interactive-p99-floor invariant ratchets per cycle
    flood_all: bool = False
    # test hook: deterministically corrupt one copy mid-run so the
    # no-acked-write-loss invariant MUST fire (replay regression tests)
    inject_acked_write_loss: bool = False
    replica_count: int = 1
    # which cycle runs the elastic-topology reshape (join -> online
    # rebalance -> watermark evacuation -> graceful drain) under the live
    # mixed traffic; -1 disables. The reshape cycle runs no random faults
    # — the reshape IS its adversarial condition.
    topology_cycle: int = -1
    # the fault kinds the FaultScheduler may draw from
    fault_kinds: tuple = ("kill", "partition", "slow_link", "one_way",
                          "disk_full", "clock_skew", "slow_worker")
    # run a snapshot create/status/restore/verify chain in every cycle's
    # op mix (ClusterSnapshotsService against the "logs" index)
    snapshots: bool = False
    # per-class ops/sec floors (the soak_baseline.json ratchet): any
    # cycle whose rate drops below floor * ThroughputFloor.FACTOR fails
    throughput_floors: dict | None = None
    # where every node's shards live: the card unless the caller asks
    # for the CPU (nothing moves to the CPU on its own)
    device: str = "cuda"


@dataclass
class SoakReport:
    seed: int
    cycles_completed: int = 0
    ops_issued: int = 0
    ops_completed: int = 0
    ops_degraded: int = 0      # completed with partial failures / errors
    sheds: int = 0             # 429-shaped completions
    faults_injected: list = field(default_factory=list)
    invariants_checked: int = 0
    flood: dict = field(default_factory=dict)
    # aggregate span-exporter accounting across nodes at final quiesce
    # (the telemetry-bounded invariant's post-flush numbers)
    telemetry: dict = field(default_factory=dict)
    # topology reshape milestones (join / watermark_evacuation / drain)
    topology: list = field(default_factory=list)
    # per-cycle per-class completed ops/sec of virtual time
    throughput: dict = field(default_factory=dict)
    # snapshot workload accounting (creates / restores / verified docs)
    snapshots: dict = field(default_factory=dict)
    digest: str = ""

    def to_dict(self) -> dict:
        return {
            "seed": self.seed, "cycles_completed": self.cycles_completed,
            "ops_issued": self.ops_issued,
            "ops_completed": self.ops_completed,
            "ops_degraded": self.ops_degraded, "sheds": self.sheds,
            "faults_injected": self.faults_injected,
            "invariants_checked": self.invariants_checked,
            "flood": self.flood,
            "telemetry": self.telemetry,
            "topology": self.topology,
            "throughput": {str(k): v for k, v in self.throughput.items()},
            "snapshots": self.snapshots,
            "digest": self.digest,
        }


# --------------------------------------------------------------------- #
# invariants
# --------------------------------------------------------------------- #


class Invariant:
    """Base class for pluggable checks. Raise nothing — call
    ``harness.fail(self, detail)`` so failures carry the replay seed."""

    name = "invariant"

    def on_response(self, harness: "SoakHarness", op: dict,
                    resp: dict) -> None:
        pass

    def at_probe(self, harness: "SoakHarness") -> None:
        pass

    def at_quiesce(self, harness: "SoakHarness") -> None:
        pass


class AckedWritesSurvive(Invariant):
    """At quiesce: acked creates are searchable, acked deletes are gone,
    all copies of a shard agree on doc counts."""

    name = "no-acked-write-loss"

    def at_quiesce(self, h: "SoakHarness") -> None:
        state = h.live_leader().applied_state
        for index in h.indices:
            must_have = h.acked_present(index)
            must_miss = h.acked_deleted(index)
            attempted = h.attempted_ids(index)
            found = h.search_all_ids(index)
            lost = must_have - found
            if lost:
                h.fail(self, f"acked docs missing from [{index}]: "
                             f"{sorted(lost)[:10]} ({len(lost)} total)")
            risen = must_miss & found
            if risen:
                h.fail(self, f"acked-deleted docs resurfaced in [{index}]: "
                             f"{sorted(risen)[:10]}")
            phantom = found - attempted
            if phantom:
                h.fail(self, f"phantom docs in [{index}]: "
                             f"{sorted(phantom)[:10]}")
            # copy agreement (engine-level doc counts, replication check)
            by_shard: dict[int, dict[str, int]] = {}
            for r in state.shards_for_index(index):
                shard = h.nodes[r.node_id].local_shards.get((index, r.shard))
                if shard is not None:
                    by_shard.setdefault(r.shard, {})[r.node_id] = \
                        shard.num_docs
            for num, counts in by_shard.items():
                if len(set(counts.values())) > 1:
                    h.fail(self, f"copies of [{index}][{num}] disagree on "
                                 f"doc count: {counts}")


class SnapshotIsolation(Invariant):
    """Per search response: no duplicate ids (torn snapshot), no phantom
    ids, and per-shard generation stamps never below the engine's
    already-published generation at issue time."""

    name = "snapshot-isolation"

    def on_response(self, h: "SoakHarness", op: dict, resp: dict) -> None:
        hits = ((resp.get("hits") or {}).get("hits")) or []
        ids = [hit["_id"] for hit in hits if "_id" in hit]
        if len(ids) != len(set(ids)):
            dup = sorted({i for i in ids if ids.count(i) > 1})
            h.fail(self, f"op#{op['i']} [{op['kind']}] returned duplicate "
                         f"ids {dup} — a response mixed snapshots")
        index = op.get("index")
        if index is not None:
            unknown = set(ids) - h.attempted_ids(index)
            if unknown:
                h.fail(self, f"op#{op['i']} [{op['kind']}] returned phantom "
                             f"ids {sorted(unknown)[:10]}")
        # generation floors: each per-node partial stamped {shard: gen};
        # the engine had already published `floor` when the op was issued,
        # and snapshots are acquired at handler time (later), so a lower
        # stamp means a stale/torn snapshot was served
        for (index, shard_num, nid, engine_id), gen in \
                (op.get("generations") or {}).items():
            floor = op.get("floors", {}).get((index, shard_num, nid))
            if floor is None:
                continue
            floor_gen, floor_engine_id = floor
            if engine_id == floor_engine_id and gen < floor_gen:
                h.fail(self, f"op#{op['i']} [{op['kind']}] served "
                             f"[{index}][{shard_num}] on {nid} from "
                             f"generation {gen} < published {floor_gen}")


class RecoveryMonotonicity(Invariant):
    """Recovery progress only moves forward within one attempt: stage
    ranks non-decreasing, counters non-decreasing, terminal immutable."""

    name = "recovery-monotonicity"

    _COUNTERS = ("files_recovered", "bytes_recovered", "ops_recovered",
                 "retries")

    def __init__(self) -> None:
        # one entry per (node, index, shard), holding a STRONG reference
        # to the observed record: identity comparison detects a fresh
        # attempt, and the kept reference stops CPython from reusing the
        # old record's address (id()-keying raced the allocator and could
        # fire non-replayable false violations)
        self._seen: dict[tuple, dict] = {}

    def at_probe(self, h: "SoakHarness") -> None:
        for nid, node in h.nodes.items():
            for (index, shard), rec in list(node.recoveries.items()):
                key = (nid, index, shard)
                prev = self._seen.get(key)
                if prev is not None and prev["rec"] is not rec:
                    prev = None  # a new attempt replaced the record
                cur = {"rec": rec, "stage": rec.stage,
                       **{c: getattr(rec, c) for c in self._COUNTERS}}
                if prev is not None:
                    p_rank = _STAGE_RANK.get(prev["stage"], 0)
                    c_rank = _STAGE_RANK.get(cur["stage"], 0)
                    if c_rank < p_rank:
                        h.fail(self, f"recovery [{index}][{shard}] on "
                                     f"{nid} moved backwards: "
                                     f"{prev['stage']} -> {cur['stage']}")
                    if prev["stage"] in ("DONE", "FAILED") and \
                            cur["stage"] != prev["stage"]:
                        h.fail(self, f"terminal recovery [{index}][{shard}]"
                                     f" on {nid} mutated: {prev['stage']}"
                                     f" -> {cur['stage']}")
                    for c in self._COUNTERS:
                        if cur[c] < prev[c]:
                            h.fail(self, f"recovery [{index}][{shard}] on "
                                         f"{nid}: {c} decreased "
                                         f"{prev[c]} -> {cur[c]}")
                self._seen[key] = cur

    def at_quiesce(self, h: "SoakHarness") -> None:
        self.at_probe(h)


class ShedCorrectness(Invariant):
    """Every issued op completed exactly once; shed (429) requests left no
    queue slots behind."""

    name = "shed-correctness"

    def at_quiesce(self, h: "SoakHarness") -> None:
        incomplete = [op["i"] for op in h.ops if op["completions"] == 0]
        if incomplete:
            h.fail(self, f"ops never completed (wedged callbacks): "
                         f"{incomplete[:10]} ({len(incomplete)} total)")
        doubled = [op["i"] for op in h.ops if op["completions"] > 1]
        if doubled:
            h.fail(self, f"ops completed more than once: {doubled[:10]}")
        for nid, node in h.nodes.items():
            wlm = node.query_groups.bulk_stats()
            for gid, stats in wlm.items():
                if stats["current"] != 0:
                    h.fail(self, f"wlm bulk slots leaked on {nid} "
                                 f"group {gid}: {stats}")


class BoundedQueues(Invariant):
    """The kNN batcher's pending queue and in-flight map drain to zero at
    quiesce; reader contexts hold only what the workload still has open."""

    name = "bounded-queues"

    def at_quiesce(self, h: "SoakHarness") -> None:
        from opensearch_tpu_torch.search import batcher as batcher_mod

        b = batcher_mod.default_batcher
        if b.pressure.stats()["current"] != 0:
            h.fail(self, f"batcher queue slots leaked: "
                         f"{b.pressure.stats()}")
        if b._buckets:
            h.fail(self, f"batcher buckets not drained: "
                         f"{list(b._buckets)[:5]}")
        if b._in_flight:
            h.fail(self, f"batcher in-flight launches leaked: "
                         f"{dict(b._in_flight)}")
        open_ctx = h.open_context_ids()
        for nid, node in h.nodes.items():
            extra = set(node._reader_contexts) - open_ctx
            if extra and h.final_quiesce:
                h.fail(self, f"reader contexts leaked on {nid}: "
                             f"{sorted(extra)[:5]}")


class ClusterConverges(Invariant):
    """After heal: one agreed leader, everything STARTED on live nodes,
    nothing relocating/unassigned, routing backed by local shards."""

    name = "convergence"

    def at_quiesce(self, h: "SoakHarness") -> None:
        leaders = [n for n in h.nodes.values() if n.is_leader]
        if len(leaders) != 1:
            h.fail(self, f"expected one leader, got "
                         f"{[n.node_id for n in leaders]}")
        leader = leaders[0]
        for nid, node in h.nodes.items():
            if node.coordinator.leader_id != leader.node_id:
                h.fail(self, f"{nid} disagrees on leader: "
                             f"{node.coordinator.leader_id} != "
                             f"{leader.node_id}")
        state = leader.applied_state
        bad = [r for r in state.routing if r.state != "STARTED"
               or r.node_id is None or r.relocating_node]
        if bad:
            h.fail(self, f"routing not converged: {bad[:5]}")
        for r in state.routing:
            if (r.index, r.shard) not in h.nodes[r.node_id].local_shards:
                h.fail(self, f"routing says [{r.index}][{r.shard}] on "
                             f"{r.node_id} but no local shard exists")


class InteractiveP99Floor(Invariant):
    """Tail slice: interactive queries issued under background
    bulk+msearch flood pressure must not just COMPLETE — their
    virtual-time latency must hold a per-cycle RATCHET. The first flood
    cycle's p99 sets the baseline; every later cycle's p99 must stay
    within the ratchet band (baseline-relative with an absolute floor so
    a fast baseline doesn't make noise a failure). Latencies are pure
    virtual time, so a violation replays byte-identically."""

    name = "interactive-p99-floor"

    # a later cycle may be at most this multiple of the baseline p99
    # (with the absolute floor below); the workload is seeded, so any
    # drift past the band is a scheduling regression, not noise
    RATCHET_FACTOR = 3.0
    FLOOR_MS = 2_000

    @staticmethod
    def _p99(samples: list[int]) -> int:
        ordered = sorted(samples)
        return ordered[min(len(ordered) - 1, int(len(ordered) * 0.99))]

    def __init__(self) -> None:
        self.baseline_p99: int | None = None

    def at_quiesce(self, h: "SoakHarness") -> None:
        samples = h.interactive_latencies.get(h.cycle) or []
        if not samples:
            return
        p99 = self._p99(samples)
        h.log_event("interactive_p99", cycle=h.cycle, p99_ms=p99,
                    n=len(samples))
        if self.baseline_p99 is None:
            self.baseline_p99 = p99
            return
        bound = max(int(self.baseline_p99 * self.RATCHET_FACTOR),
                    self.FLOOR_MS)
        if p99 > bound:
            h.fail(self, f"interactive p99 ratchet broken in cycle "
                         f"{h.cycle}: {p99}ms > bound {bound}ms "
                         f"(baseline {self.baseline_p99}ms, "
                         f"{len(samples)} samples)")


class InteractiveUnderFlood(Invariant):
    """wlm slice: the flood group's bulks shed 429 at its slot share while
    every interactive query issued during the flood completes."""

    name = "interactive-under-flood"

    def at_quiesce(self, h: "SoakHarness") -> None:
        flood_cycle = (h.cycle == h.cfg.flood_cycle or h.cfg.flood_all)
        if not flood_cycle or not h.flood_stats["bulks"]:
            return
        if h.flood_stats["sheds"] == 0:
            h.fail(self, f"bulk flood past the group share never shed: "
                         f"{h.flood_stats}")
        inter = h.flood_stats["interactive"]
        done = h.flood_stats["interactive_ok"]
        if done < inter:
            h.fail(self, f"interactive queries starved under bulk flood: "
                         f"{done}/{inter} completed")


class TelemetryBounded(Invariant):
    """Telemetry stays bounded under chaos: each node's span exporter
    keeps its pending-trace buffer and export queue inside their caps and
    accounts for every span it was offered —
    ``exported + dropped + resident == seen`` — while the tracer ring
    honors its maxlen. At the final quiesce a flush must leave nothing
    resident: a span fragment surviving kill/heal cycles in the pending
    buffer would be a leak (its trace's local root never completed and
    eviction never claimed it)."""

    name = "telemetry-bounded"

    def at_probe(self, h: "SoakHarness") -> None:
        for nid, node in h.nodes.items():
            tracer = node.telemetry.tracer
            if len(tracer.finished_spans()) > tracer.max_finished:
                h.fail(self, f"span ring on {nid} exceeds maxlen "
                             f"{tracer.max_finished}")
            exp = tracer.exporter
            if exp is None:
                continue
            st = exp.snapshot_stats()
            if st["pending_traces"] > st["max_pending_traces"]:
                h.fail(self, f"exporter pending-trace buffer on {nid} "
                             f"over cap: {st['pending_traces']} > "
                             f"{st['max_pending_traces']}")
            if st["queued_spans"] > st["max_queue"]:
                h.fail(self, f"exporter queue on {nid} over cap: "
                             f"{st['queued_spans']} > {st['max_queue']}")
            resident = st["pending_spans"] + st["queued_spans"]
            accounted = st["spans_exported"] + st["spans_dropped"] + resident
            if st["spans_seen"] != accounted:
                h.fail(self, f"exporter accounting broken on {nid}: "
                             f"seen {st['spans_seen']} != exported "
                             f"{st['spans_exported']} + dropped "
                             f"{st['spans_dropped']} + resident {resident}")

    def at_quiesce(self, h: "SoakHarness") -> None:
        self.at_probe(h)
        if not h.final_quiesce:
            return
        for nid, node in h.nodes.items():
            exp = node.telemetry.tracer.exporter
            if exp is None:
                continue
            exp.flush()
            st = exp.snapshot_stats()
            if st["pending_spans"] or st["queued_spans"]:
                h.fail(self, f"spans leaked across kill/heal on {nid}: "
                             f"{st['pending_spans']} pending / "
                             f"{st['queued_spans']} queued after flush")
            accounted = st["spans_exported"] + st["spans_dropped"]
            if st["spans_seen"] != accounted:
                h.fail(self, f"post-flush accounting broken on {nid}: "
                             f"seen {st['spans_seen']} != exported+dropped "
                             f"{accounted}")


class DeviceLedgerBounded(Invariant):
    """Device-memory residency stays accounted under chaos: the ledger's
    identity ``resident == allocated − freed == sum(live bytes)`` holds at
    every probe, the shard-mesh registry never exceeds its HBM byte
    budget, and at the FINAL quiesce every live allocation made during the
    soak is reachable from a live owner — an engine's published segment
    set or the mesh registry. An unreachable allocation is leaked HBM: its
    owner retired (kill, relocation, rebuild, eviction) without freeing."""

    name = "device-ledger-bounded"

    def __init__(self) -> None:
        from opensearch_tpu_torch.telemetry.device_ledger import default_ledger

        # leak checks only cover allocations made DURING this soak: the
        # process-wide ledger may carry live structures from other owners
        # in the same interpreter (other tests' engines)
        self._start_id = default_ledger.current_id()

    def at_probe(self, h: "SoakHarness") -> None:
        from opensearch_tpu_torch.cluster.shard_mesh import default_registry
        from opensearch_tpu_torch.telemetry.device_ledger import default_ledger

        st = default_ledger.snapshot_stats()
        if not st["identity_ok"]:
            h.fail(self, f"ledger identity broken: resident "
                         f"{st['resident_bytes']} != allocated "
                         f"{st['allocated_bytes']} - freed "
                         f"{st['freed_bytes']}")
        mesh = default_registry.snapshot_stats()
        budget = mesh.get("hbm_budget_bytes") or 0
        if budget and mesh["resident_bytes"] > budget:
            # one bundle larger than the whole budget is deliberately
            # ADMITTED (the query must serve; everything else evicts), so
            # the bound that must hold is max(budget, largest bundle)
            largest = max(
                (r["bytes"] for r in default_registry.resident()),
                default=0)
            if mesh["resident_bytes"] > max(budget, largest):
                h.fail(self, f"mesh registry over its HBM budget: "
                             f"{mesh['resident_bytes']} > {budget} "
                             f"(largest bundle {largest})")

    def at_quiesce(self, h: "SoakHarness") -> None:
        self.at_probe(h)
        if not h.final_quiesce:
            return
        from opensearch_tpu_torch.cluster.shard_mesh import default_registry
        from opensearch_tpu_torch.telemetry.device_ledger import default_ledger

        reachable: set[int] = set()
        for node in h.nodes.values():
            for shard in node.local_shards.values():
                for _host, dev in shard.engine._segments:
                    for alloc in (getattr(dev, "allocations", None)
                                  or {}).values():
                        reachable.add(alloc.alloc_id)
        with default_registry._lock:
            bundles = list(default_registry._bundles.values())
        for bundle in bundles:
            # one allocation a slot of the bundle
            for alloc in getattr(bundle, "allocations", ()):
                reachable.add(alloc.alloc_id)
        leaked = [
            a for a in default_ledger.live_allocations()
            if a.alloc_id > self._start_id
            and a.alloc_id not in reachable
            and a.index in (set(h.indices) | {"_unattributed"})
        ]
        if leaked:
            rows = [a.row() for a in leaked[:5]]
            h.fail(self, f"device allocations leaked across kill/heal "
                         f"({len(leaked)} total): {rows}")


class HeatBounded(Invariant):
    """Structure-heat accounting stays bounded and truthful under chaos:
    every heat row belongs to a LIVE allocation group (heat retires with
    its structure — a rebuild/eviction/kill may never leave ghost rows),
    the cumulative touch counters are monotone probe-over-probe, the
    advisor's access ring respects its capacity, and at the FINAL quiesce
    every structure still carrying heat is reachable from a live owner —
    an engine's published segment set or the mesh registry (the
    leak-check idiom). Touch timestamps ride the injectable clock and the
    classification is a pure threshold function, so replayed runs see
    byte-identical heat under ``clock_scope``/``rng_scope``."""

    name = "heat-bounded"

    def __init__(self) -> None:
        from opensearch_tpu_torch.telemetry.device_ledger import default_ledger

        self._ledger = default_ledger
        # reachability only covers structures allocated DURING this soak:
        # the process-wide ledger may hold live same-named structures from
        # other owners in the interpreter (the DeviceLedgerBounded
        # watermark idiom)
        self._start_id = default_ledger.current_id()
        self._prev: dict | None = None

    def at_probe(self, h: "SoakHarness") -> None:
        live = set(self._ledger.live_group_keys())
        ghosts = [k for k in self._ledger.heat_group_keys()
                  if k not in live]
        if ghosts:
            h.fail(self, f"heat rows outlive their structures "
                         f"({len(ghosts)} ghosts): {ghosts[:5]}")
        st = self._ledger.heat_stats()
        ring = st["ring"]
        if ring["size"] > ring["capacity"]:
            h.fail(self, f"advisor access ring over capacity: "
                         f"{ring['size']} > {ring['capacity']}")
        counters = st["counters"]
        if self._prev is not None:
            for key in ("touches", "touched_bytes", "transitions"):
                if counters[key] < self._prev[key]:
                    h.fail(self, f"heat counter [{key}] went backwards: "
                                 f"{counters[key]} < {self._prev[key]}")
        self._prev = dict(counters)

    def at_quiesce(self, h: "SoakHarness") -> None:
        self.at_probe(h)
        if not h.final_quiesce:
            return
        from opensearch_tpu_torch.cluster.shard_mesh import default_registry
        from opensearch_tpu_torch.telemetry.device_ledger import group_key

        # reachable groups: every allocation owned by a live engine's
        # published segments or a resident mesh bundle (the
        # device-ledger-bounded reachability set, folded to group keys)
        reachable: set[tuple] = set()
        for node in h.nodes.values():
            for shard in node.local_shards.values():
                for _host, dev in shard.engine._segments:
                    for alloc in (getattr(dev, "allocations", None)
                                  or {}).values():
                        reachable.add(group_key(alloc))
        with default_registry._lock:
            bundles = list(default_registry._bundles.values())
        for bundle in bundles:
            for alloc in getattr(bundle, "allocations", ()):
                reachable.add(group_key(alloc))
        # groups with at least one allocation made DURING this soak: a
        # pre-existing same-named structure (another test's engine in
        # this interpreter) is not ours to account
        mine: set[tuple] = {
            group_key(a) for a in self._ledger.live_allocations()
            if a.alloc_id > self._start_id
        }
        orphans = [
            k for k in self._ledger.heat_group_keys()
            if k[0] in set(h.indices) and k in mine and k not in reachable
        ]
        if orphans:
            h.fail(self, f"touched structures unreachable from any live "
                         f"engine/registry at quiesce ({len(orphans)}): "
                         f"{orphans[:5]}")


class RooflineBounded(Invariant):
    """Kernel roofline accounting stays bounded and truthful under
    chaos: the recorder's family map never exceeds its bound, every
    cumulative counter is monotone probe-over-probe, and the accounting
    identity ``accounted_flops == Σ per-family model FLOPs`` holds at
    every probe and at the final quiesce. A deterministic calibration
    stub is installed up front so the wall-clock matmul/memcpy
    microbenchmark can never fire inside the virtual-clock sim — replayed
    runs stay byte-identical from one seed."""

    name = "roofline-bounded"

    def __init__(self) -> None:
        from opensearch_tpu_torch.telemetry import roofline

        # seeded stub: peaks become a pure function of the seed, and
        # lazily-triggered calibration (a stats probe reading fractions)
        # never measures real wall time mid-soak
        if roofline.current_peaks() is None:
            roofline.set_peaks(roofline.stub_peaks(seed=0))
        self._recorder = roofline.default_recorder
        self._max_families = roofline.MAX_FAMILIES
        self._prev: dict | None = None

    def at_probe(self, h: "SoakHarness") -> None:
        snap = self._recorder.snapshot_stats()
        fams = snap["families"]
        # + 1: the reserved overflow row may coexist with a full map
        if len(fams) > self._max_families + 1:
            h.fail(self, f"roofline family map unbounded: {len(fams)} "
                         f"families > {self._max_families}")
        counters = snap["counters"]
        total = sum(row["flops"] for row in fams.values())
        if total != counters["accounted_flops"]:
            h.fail(self, f"roofline accounting identity broken: "
                         f"sum(family flops) {total} != accounted_flops "
                         f"{counters['accounted_flops']}")
        for row in fams.values():
            if not (0.0 < row["roofline_fraction"] <= 1.0):
                h.fail(self, f"roofline fraction out of (0, 1] for "
                             f"{row['family']}: {row['roofline_fraction']}")
        if self._prev is not None:
            for key in ("launches", "accounted_flops", "accounted_bytes",
                        "wall_ns", "unmodeled_launches"):
                if counters[key] < self._prev[key]:
                    h.fail(self, f"roofline counter [{key}] went "
                                 f"backwards: {counters[key]} < "
                                 f"{self._prev[key]}")
        self._prev = dict(counters)

    def at_quiesce(self, h: "SoakHarness") -> None:
        self.at_probe(h)


class WatermarkRespected(Invariant):
    """No shard is ever NEWLY assigned (INITIALIZING — fresh allocation or
    relocation target) on a node the leader already knew was over the high
    disk watermark. Compares each probe's fresh assignments against the
    leader's disk view at the PREVIOUS probe, so heartbeat lag (a node
    ramping over the watermark after the assignment decision) cannot fire
    a false positive — only a knowing assignment violates."""

    name = "watermark-respected"

    def __init__(self) -> None:
        self._prev_entries: set[tuple] = set()
        self._prev_over: set[str] = set()

    def at_probe(self, h: "SoakHarness") -> None:
        from opensearch_tpu_torch.cluster.allocation import AllocationSettings

        leader = h.maybe_live_leader()
        if leader is None:
            return
        state = leader.applied_state
        settings = AllocationSettings.from_cluster(state)
        disk = dict(leader._node_disk)
        own = leader._disk_usage()
        if own is not None:
            disk[leader.node_id] = own
        cur_over = {nid for nid, pct in disk.items()
                    if pct >= settings.disk_high_watermark_pct}
        cur = {(r.index, r.shard, r.node_id) for r in state.routing
               if r.state == "INITIALIZING" and r.node_id is not None}
        # a node must be over at BOTH bracketing probes to convict: over
        # only now means it ramped after the decision; over only before
        # means it legitimately dropped below before the assignment
        for index, shard, nid in sorted(cur - self._prev_entries):
            if nid in self._prev_over and nid in cur_over:
                h.fail(self, f"[{index}][{shard}] assigned on {nid}, which "
                             f"the leader already knew was over the high "
                             f"watermark")
        self._prev_over = cur_over
        self._prev_entries = cur

    def at_quiesce(self, h: "SoakHarness") -> None:
        self.at_probe(h)


class RelocationGenerationIsolation(Invariant):
    """One response never merges two copies of the same shard: across a
    relocation swap the pre-move and post-move snapshots both exist, and a
    query that collected partials from BOTH would double-serve (or tear)
    the shard. The per-shard generation stamps carry the serving node, so
    two nodes answering one shard inside one response is the violation."""

    name = "relocation-isolation"

    def on_response(self, h: "SoakHarness", op: dict, resp: dict) -> None:
        served: dict[tuple[str, int], set[str]] = {}
        for (index, shard_num, nid, _engine_id) in \
                (op.get("generations") or {}):
            served.setdefault((index, shard_num), set()).add(nid)
        for (index, shard_num), nids in sorted(served.items()):
            if len(nids) > 1:
                h.fail(self, f"op#{op['i']} [{op['kind']}] merged "
                             f"[{index}][{shard_num}] partials from "
                             f"{sorted(nids)} — a query crossed a "
                             f"relocation swap")


class BoundedShardUnavailability(Invariant):
    """Every workload shard keeps a live serving copy (STARTED or
    RELOCATING source on an up node). Faults may take copies away, but
    only for a BOUNDED streak of probes — recovery must reinstate a
    serving copy; a shard dark past the bound is stuck, not degraded.
    While a relocation is in flight with its source alive the source
    still serves, so moves get zero tolerance by construction."""

    name = "bounded-unavailability"

    # consecutive 500ms probes a shard may lack a live serving copy
    # (covers kill -> shard-failed -> reassign -> recover under chaos)
    LIMIT = 60

    def __init__(self) -> None:
        self._streak: dict[tuple[str, int], int] = {}

    def at_probe(self, h: "SoakHarness") -> None:
        leader = h.maybe_live_leader()
        if leader is None:
            # an election in progress is leadership unavailability, not
            # shard unavailability; the convergence invariant owns it
            self._streak.clear()
            return
        state = leader.applied_state
        down = h.transport.down
        for index in h.indices:
            meta = state.indices.get(index)
            if meta is None:
                continue
            copies_by_shard: dict[int, list] = {n: []
                                                for n in
                                                range(meta.num_shards)}
            for r in state.routing:
                if r.index == index and r.shard in copies_by_shard:
                    copies_by_shard[r.shard].append(r)
            for num, copies in copies_by_shard.items():
                serving = [r for r in copies
                           if r.state in ("STARTED", "RELOCATING")
                           and r.node_id is not None
                           and r.node_id not in down]
                key = (index, num)
                if serving:
                    self._streak.pop(key, None)
                    continue
                streak = self._streak.get(key, 0) + 1
                self._streak[key] = streak
                if streak > self.LIMIT:
                    h.fail(self, f"[{index}][{num}] had no live serving "
                                 f"copy for {streak} consecutive probes "
                                 f"(routing: {copies})")

    def at_quiesce(self, h: "SoakHarness") -> None:
        self._streak.clear()


class BalancedConvergence(Invariant):
    """The quiesced routing table is a FIXED POINT of the allocator:
    re-running reroute with the leader's own disk view must change
    nothing. Convergence (everything STARTED) is not enough after a
    reshape — the table must also be where the balancer would have put
    it, or the next publication silently starts moving shards again."""

    name = "balanced-convergence"

    def at_quiesce(self, h: "SoakHarness") -> None:
        from opensearch_tpu_torch.cluster.allocation import (
            AllocationSettings,
            reroute,
        )

        leader = h.live_leader()
        state = leader.applied_state
        disk = dict(leader._node_disk)
        own = leader._disk_usage()
        if own is not None:
            disk[leader.node_id] = own
        out = reroute(state, AllocationSettings.from_cluster(state, disk))
        before = sorted(repr(r) for r in state.routing)
        after = sorted(repr(r) for r in out.routing)
        if before != after:
            moved = [r for r in after if r not in before]
            h.fail(self, f"routing at quiesce is not an allocator fixed "
                         f"point — reroute still wants: {moved[:4]}")


class ThroughputFloor(Invariant):
    """Per-cycle per-class throughput ratchet: completed ops per virtual
    second must stay above the seed-recorded baseline floor (times the
    tolerance factor) for every workload class the baseline covers. A
    chaos cycle that quietly grinds to a crawl is a regression even when
    every op eventually completes."""

    name = "throughput-floor"

    # a cycle may degrade to this fraction of the recorded floor before
    # the invariant fires (chaos cycles legitimately run slower than the
    # baseline recording's best cycle)
    FACTOR = 0.5

    def at_quiesce(self, h: "SoakHarness") -> None:
        floors = h.cfg.throughput_floors or {}
        rates = h.report.throughput.get(h.cycle) or {}
        for cls, floor in sorted(floors.items()):
            rate = rates.get(cls)
            if rate is None:
                continue
            bound = floor * self.FACTOR
            if rate < bound:
                h.fail(self, f"cycle {h.cycle} [{cls}] throughput "
                             f"{rate:.3f} ops/s below floor {bound:.3f} "
                             f"(baseline {floor:.3f} x {self.FACTOR})")


DEFAULT_INVARIANTS: tuple[Callable[[], Invariant], ...] = (
    AckedWritesSurvive, SnapshotIsolation, RecoveryMonotonicity,
    ShedCorrectness, BoundedQueues, ClusterConverges, InteractiveUnderFlood,
    InteractiveP99Floor, TelemetryBounded, DeviceLedgerBounded,
    RooflineBounded, HeatBounded, WatermarkRespected,
    RelocationGenerationIsolation, BoundedShardUnavailability,
    BalancedConvergence, ThroughputFloor,
)


# --------------------------------------------------------------------- #
# fault scheduling
# --------------------------------------------------------------------- #


# workload classes for the per-cycle throughput ratchet
_OP_CLASS = {
    "index": "ingest", "bulk": "ingest", "delete": "ingest",
    "bulk_flood": "ingest", "ann_rebuild": "ingest",
    "refresh": "maint", "flush": "maint", "force_merge": "maint",
    "snapshot_cycle": "snapshot",
}


class FaultScheduler:
    """Plans and injects the per-cycle fault schedule from the seeded
    fault stream. Transport faults (kill / partition / slow_link /
    one_way) ride the MockTransport disruption machinery; node faults
    ride the ClusterNode fault hooks — ``disk_full`` ramps
    ``disk_usage_pct`` so the heartbeat path carries it to the leader and
    the DiskThresholdDecider evacuates, ``clock_skew`` offsets the node's
    reader-context clock, ``slow_worker`` delays the serial data worker.
    ``heal_all`` restores every baseline at quiesce."""

    BASELINE_DISK_PCT = 40.0

    def __init__(self, harness: "SoakHarness"):
        self.h = harness

    def plan_cycle(self) -> list[dict]:
        """1-2 sequential faults per chaos cycle, all healed well before
        the cycle ends. Flood cycles run fault-free (the bulk flood IS
        the adversarial condition and interactive-under-flood needs
        clean-network determinism); the topology cycle runs fault-free
        too (the reshape is its chaos — concurrent kills are covered by
        the fault-injection edge-case tests)."""
        h = self.h
        if not h.cfg.chaos or h.cycle == h.cfg.flood_cycle \
                or h.cfg.flood_all or h.cycle == h.cfg.topology_cycle:
            return []
        out = []
        t = h.frng.randint(1_500, 3_000)
        for _ in range(h.frng.randint(1, 2)):
            kind = h.frng.choice(list(h.cfg.fault_kinds))
            duration = h.frng.randint(2_500, 6_000)
            if t + duration > h.cfg.cycle_ms - 5_000:
                break
            a, b = h.frng.sample(h.node_ids, 2)
            fault = {"kind": kind, "at": t, "duration": duration,
                     "a": a, "b": b}
            if kind == "clock_skew":
                fault["skew"] = h.frng.choice([-4_000, -2_000,
                                               2_000, 4_000])
            elif kind == "slow_worker":
                fault["delay"] = h.frng.randint(80, 150)
            out.append(fault)
            t += duration + h.frng.randint(1_500, 3_000)
        return out

    def inject(self, fault: dict) -> None:
        h = self.h
        kind, a, b = fault["kind"], fault["a"], fault["b"]
        h.log_event("fault", kind=kind, a=a, b=b)
        h.report.faults_injected.append(kind)
        node = h.nodes.get(a)
        if kind == "kill":
            h.transport.take_down(a)
        elif kind == "partition":
            h.transport.partition({a}, {b})
        elif kind == "slow_link":
            h.transport.set_latency(a, b, 150)
        elif kind == "one_way":
            h.transport.drop_one_way(a, b)
        elif kind == "disk_full" and node is not None:
            node.disk_usage_pct = 95.0
        elif kind == "clock_skew" and node is not None:
            node.clock_skew_ms = fault["skew"]
        elif kind == "slow_worker" and node is not None:
            node.data_worker_delay_ms = fault["delay"]

    def heal(self, fault: dict) -> None:
        h = self.h
        kind, a, b = fault["kind"], fault["a"], fault["b"]
        h.log_event("heal", kind=kind, a=a, b=b)
        node = h.nodes.get(a)
        if kind == "kill":
            h.transport.bring_up(a)
        elif kind == "partition":
            h.transport.blackholed.discard((a, b))
            h.transport.blackholed.discard((b, a))
        elif kind == "slow_link":
            h.transport.set_latency(a, b, 0)
        elif kind == "one_way":
            h.transport.restore_one_way(a, b)
        elif kind == "disk_full" and node is not None:
            node.disk_usage_pct = self.BASELINE_DISK_PCT
        elif kind == "clock_skew" and node is not None:
            node.clock_skew_ms = 0
        elif kind == "slow_worker" and node is not None:
            node.data_worker_delay_ms = 0

    def heal_all(self) -> None:
        """Quiesce-time belt and braces: every disruption cleared, every
        node fault hook back at baseline. Departed nodes stay down; a
        topology reshape mid-flight keeps ownership of its disk ramp."""
        h = self.h
        h.transport.heal()
        for nid in list(h.transport.down):
            if nid in h.nodes:
                h.transport.bring_up(nid)
        reshaping = h._topology_pending > 0
        for node in h.nodes.values():
            node.clock_skew_ms = 0
            node.data_worker_delay_ms = 0
            if not reshaping:
                node.disk_usage_pct = self.BASELINE_DISK_PCT


# --------------------------------------------------------------------- #
# callback-style cluster client (the facade's fan-out without its threads)
# --------------------------------------------------------------------- #


class SoakClient:
    """Coordinator-side search surface over the sim transport, callback
    style so it runs inside the deterministic queue: search[node] fan-out
    + reduce (kNN/aggs/hybrid ride the full per-node search service),
    msearch[node], scroll and PIT via pinned reader contexts. Per-node
    failures degrade into `_shards.failed` instead of wedging the op."""

    def __init__(self, harness: "SoakHarness"):
        self.h = harness

    # -- assignment (one (node, shards) call per data node) ----------------

    def assignments(self, via: str, index: str):
        state = self.h.nodes[via].applied_state
        meta = state.indices.get(index)
        if meta is None:
            return None, 0
        targets: dict[int, Any] = {}
        for r in state.shards_for_index(index):
            if r.state not in ("STARTED", "RELOCATING") or r.node_id is None:
                continue
            if r.shard not in targets or r.primary:
                targets[r.shard] = r
        by_node: dict[str, list[int]] = {}
        for num, r in sorted(targets.items()):
            by_node.setdefault(r.node_id, []).append(num)
        missing = meta.num_shards - len(targets)
        return sorted(by_node.items()), missing

    def _fan_out(self, via: str, index: str, calls: list[tuple[str, str, dict]],
                 on_done: Callable[[list], None]) -> None:
        """Send every (target, action, payload); collect responses/errors in
        order; on_done(list) fires exactly once when all arrived."""
        results: list[Any] = [None] * len(calls)
        remaining = [len(calls)]

        def finish(i: int, value: Any) -> None:
            results[i] = value
            remaining[0] -= 1
            if remaining[0] == 0:
                on_done(results)

        for i, (target, action, payload) in enumerate(calls):
            self.h.transport.send(
                via, target, action, payload,
                on_response=lambda r, i=i: finish(i, r),
                on_failure=lambda e, i=i: finish(i, {"error": str(e)}),
            )
        if not calls:
            self.h.queue.schedule(0, lambda: on_done([]))

    def search(self, via: str, index: str, body: dict,
               callback: Callable[[dict], None], *,
               keep_context: bool = False,
               keep_alive_ms: int = 60_000) -> None:
        from opensearch_tpu_torch.search.reduce import reduce_search_responses

        assign, missing = self.assignments(via, index)
        if assign is None or not assign:
            callback({"error": f"no serving copy of [{index}]"})
            return
        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        node_body = dict(body)
        node_body["from"] = 0
        node_body["size"] = from_ + size
        node_body["track_total_hits"] = True
        calls = [(nid, "indices:data/read/search[node]",
                  {"index": index, "shards": nums, "body": node_body,
                   "keep_context": keep_context,
                   "keep_alive_ms": keep_alive_ms})
                 for nid, nums in assign]

        def on_done(results: list) -> None:
            ok, failed_shards, stamps, contexts = [], missing, {}, {}
            for (nid, nums), p in zip(assign, results):
                if isinstance(p, dict) and "hits" in p:
                    ok.append(p)
                    for s, gen in (p.get("_generations") or {}).items():
                        stamps[(index, int(s), nid)] = gen
                    if "_ctx_id" in p:
                        contexts[nid] = p["_ctx_id"]
                else:
                    failed_shards += len(nums)
            if not ok:
                callback({"error": f"every node failed for [{index}]",
                          "_soak_failed_shards": failed_shards})
                return
            try:
                resp = reduce_search_responses(
                    body, ok, size=size, from_=from_,
                    track_total=body.get("track_total_hits", True))
            except Exception as e:  # noqa: BLE001 - degrade, never wedge
                callback({"error": f"reduce failed: {type(e).__name__}: {e}"})
                return
            resp["_shards"]["total"] += failed_shards
            resp["_shards"]["failed"] += failed_shards
            resp["_soak_generations"] = stamps
            if contexts:
                resp["_soak_contexts"] = contexts
            callback(resp)

        self._fan_out(via, index, calls, on_done)

    def msearch(self, via: str, index: str, bodies: list[dict],
                callback: Callable[[dict], None]) -> None:
        from opensearch_tpu_torch.search.reduce import reduce_search_responses

        assign, missing = self.assignments(via, index)
        if assign is None or not assign:
            callback({"error": f"no serving copy of [{index}]"})
            return
        node_bodies = []
        for b in bodies:
            nb = dict(b)
            nb["from"] = 0
            nb["size"] = int(b.get("from", 0)) + int(b.get("size", 10))
            nb["track_total_hits"] = True
            node_bodies.append(nb)
        calls = [(nid, "indices:data/read/msearch[node]",
                  {"index": index, "shards": nums, "bodies": node_bodies})
                 for nid, nums in assign]

        def on_done(results: list) -> None:
            responses = []
            for bi, b in enumerate(bodies):
                parts = []
                failed = missing
                for (nid, nums), node_resp in zip(assign, results):
                    if isinstance(node_resp, dict) and \
                            "responses" in node_resp:
                        p = node_resp["responses"][bi]
                        if isinstance(p, dict) and "hits" in p:
                            parts.append(p)
                        else:
                            failed += len(nums)
                    else:
                        failed += len(nums)
                if not parts:
                    responses.append({"error": "all nodes failed"})
                    continue
                try:
                    r = reduce_search_responses(
                        b, parts, size=int(b.get("size", 10)),
                        from_=int(b.get("from", 0)), track_total=True)
                except Exception as e:  # noqa: BLE001
                    responses.append({"error": str(e)})
                    continue
                r["_shards"]["failed"] += failed
                responses.append(r)
            callback({"responses": responses})

        self._fan_out(via, index, calls, on_done)

    def ctx_search(self, via: str, contexts: dict[str, str], body: dict | None,
                   size: int, seen: int,
                   callback: Callable[[dict], None]) -> None:
        """One page against pinned reader contexts (scroll page when `body`
        is None, PIT search otherwise)."""
        from opensearch_tpu_torch.search.reduce import reduce_hits

        calls = []
        for nid, ctx_id in sorted(contexts.items()):
            payload: dict[str, Any] = {"ctx_id": ctx_id}
            if body is not None:
                nb = dict(body)
                nb["from"] = 0
                nb["size"] = size
                payload["body"] = nb
            else:
                payload["from"] = 0
                payload["size"] = seen + size
            calls.append((nid, "indices:data/read/search[ctx]", payload))

        def on_done(results: list) -> None:
            ok = [p for p in results
                  if isinstance(p, dict) and "hits" in p]
            failed = len(results) - len(ok)
            if not ok:
                callback({"error": "every pinned context failed"})
                return
            hits_obj = reduce_hits(ok, size=size,
                                   from_=seen if body is None else 0,
                                   sort=None, track_total=True)
            callback({"hits": hits_obj,
                      "_shards": {"failed": failed, "total": len(results)}})

        self._fan_out(via, None, calls, on_done)

    def ctx_close(self, via: str, contexts: dict[str, str],
                  callback: Callable[[dict], None]) -> None:
        calls = [(nid, "indices:data/read/ctx_close", {"ctx_ids": [cid]})
                 for nid, cid in sorted(contexts.items())]

        def on_done(results: list) -> None:
            callback({"freed": sum(r.get("freed", 0) for r in results
                                   if isinstance(r, dict))})

        self._fan_out(via, None, calls, on_done)

    def broadcast(self, via: str, action: str, payload: dict,
                  callback: Callable[[dict], None]) -> None:
        """One RPC per live node (flush[node] / forcemerge[node])."""
        live = [nid for nid in self.h.node_ids
                if nid not in self.h.transport.down]
        calls = [(nid, action, payload) for nid in live]
        self._fan_out(via, None, calls,
                      lambda rs: callback({"responses": rs}))


# --------------------------------------------------------------------- #
# the harness
# --------------------------------------------------------------------- #


class SoakHarness:
    def __init__(self, cfg: SoakConfig, tmp_path: Path):
        from opensearch_tpu_torch.cluster.cluster_node import ClusterNode

        self.cfg = cfg
        self.queue = DeterministicTaskQueue(cfg.seed)
        self.transport = MockTransport(self.queue, timeout_ms=400)
        self._tmp_path = Path(tmp_path)
        self._snap_root = self._tmp_path / "csnap"
        # node_ids is the LIVE member list: topology reshapes append
        # joiners and remove drained nodes; the bootstrap configuration
        # stays pinned to the founding members
        self.node_ids = [f"n{i}" for i in range(cfg.nodes)]
        self._next_ordinal = cfg.nodes
        bootstrap_ids = list(self.node_ids)
        self.nodes: dict[str, Any] = {}
        for nid in self.node_ids:
            self.nodes[nid] = ClusterNode(
                nid, self._tmp_path / nid, self.transport, self.queue,
                list(self.node_ids), device=cfg.device,
            )
        for n in self.nodes.values():
            n.bootstrap(bootstrap_ids)
        for n in self.nodes.values():
            n.start()
            # a known disk baseline: fault ramps and topology reshapes
            # move this, never the host filesystem's real numbers
            n.disk_usage_pct = FaultScheduler.BASELINE_DISK_PCT
        # span exporters ride the soak: SYNCHRONOUS (no threads under the
        # deterministic queue), in-memory sinks (no file IO), and a
        # seed-derived private RNG per node so tail-sampling decisions
        # replay byte-identically without perturbing the workload streams.
        # The telemetry-bounded invariant audits their accounting.
        from opensearch_tpu_torch.telemetry.export import MemorySink, SpanExporter

        for i, nid in enumerate(self.node_ids):
            self.nodes[nid].telemetry.tracer.exporter = SpanExporter(
                MemorySink(), service_name=nid,
                slow_threshold_ms=250, sample_ratio=0.25,
                rng=random.Random(cfg.seed * 31_337 + 11 + i),
                synchronous=True, mode="memory",
            )
        self.client = SoakClient(self)
        self.faults = FaultScheduler(self)
        # seed-derived decision streams, independent of the queue's RNG so
        # transport-delay draws can't shift workload plans
        self.wrng = random.Random(cfg.seed * 7_919 + 1)
        self.frng = random.Random(cfg.seed * 104_729 + 2)
        self.indices = ["logs", "vec", "hyb", "annvec"]
        self.cycle = -1
        self.final_quiesce = False
        self.report = SoakReport(seed=cfg.seed)
        self.invariants: list[Invariant] = [f() for f in DEFAULT_INVARIANTS]
        self.ops: list[dict] = []
        self._events: list[str] = []
        self._doc_seq = 0
        # doc ledger per index: id -> list of (op_index, kind, acked)
        self._writes: dict[str, dict[str, list]] = {i: {}
                                                    for i in self.indices}
        # scroll/PIT contexts the workload currently holds open
        self._open_contexts: dict[int, dict[str, str]] = {}
        self.flood_stats = {"bulks": 0, "sheds": 0, "interactive": 0,
                            "interactive_ok": 0, "msearches": 0}
        # per-cycle VIRTUAL-time latencies of interactive probes (the
        # interactive-p99-floor invariant's ratchet input)
        self.interactive_latencies: dict[int, list[int]] = {}
        self._probe_timer: Any = None
        # elastic-topology bookkeeping: >0 while a join/rebalance/drain
        # chain is in flight (quiesce waits for it; heal_all leaves its
        # disk ramp alone)
        self._topology_pending = 0
        # per-cycle completed-op counts by workload class (throughput
        # ratchet input); the cycle's virtual start stamp divides them
        self._cycle_counts: dict[int, dict[str, int]] = {}
        self._cycle_start_ms = 0

    # -- plumbing ----------------------------------------------------------

    def add_invariant(self, inv: Invariant) -> None:
        self.invariants.append(inv)

    def log_event(self, event: str, **fields: Any) -> None:
        self._events.append(json.dumps(
            [self.queue.now_ms, event, fields], sort_keys=True, default=str))

    def digest(self) -> str:
        return hashlib.sha256(
            "\n".join(self._events).encode()).hexdigest()[:16]

    def fail(self, invariant: Invariant | str, detail: str) -> None:
        name = invariant if isinstance(invariant, str) else invariant.name
        self.log_event("violation", invariant=name, detail=detail)
        raise SoakFailure(self.cfg.seed, self.cycle, name, detail,
                          self.digest())

    def live_leader(self):
        leaders = [n for nid, n in self.nodes.items()
                   if nid not in self.transport.down and n.is_leader]
        if len(leaders) != 1:
            self.fail("convergence",
                      f"no single live leader: {[n.node_id for n in leaders]}")
        return leaders[0]

    def maybe_live_leader(self):
        """The single live leader, or None while an election is in
        flight — probe-time invariants skip rather than convict."""
        leaders = [n for nid, n in self.nodes.items()
                   if nid not in self.transport.down and n.is_leader]
        return leaders[0] if len(leaders) == 1 else None

    def anchor(self) -> str:
        """A live member to issue control-plane calls through. 'n0' in a
        static soak, but topology reshapes may drain any node — the
        anchor follows the membership."""
        for nid in self.node_ids:
            if nid in self.nodes and nid not in self.transport.down:
                return nid
        return self.node_ids[0]

    def call(self, fn, *args, **kwargs) -> dict:
        """Setup-phase helper: run a callback API to completion."""
        out: list = []
        fn(*args, callback=out.append, **kwargs)
        for _ in range(200_000):
            if out:
                return out[0]
            if not self.queue.run_one():
                break
        raise SoakFailure(self.cfg.seed, self.cycle, "wedge",
                          f"{getattr(fn, '__name__', fn)} never completed",
                          self.digest())

    def run_ms(self, ms: int) -> None:
        self.queue.run_until(self.queue.now_ms + ms)

    # -- doc ledger --------------------------------------------------------

    def _record_write(self, index: str, doc_id: str, op_i: int,
                      kind: str) -> None:
        self._writes[index].setdefault(doc_id, []).append(
            {"op": op_i, "kind": kind, "acked": False})

    def _ack_write(self, index: str, doc_id: str, op_i: int) -> None:
        for entry in self._writes[index].get(doc_id, ()):
            if entry["op"] == op_i:
                entry["acked"] = True

    def attempted_ids(self, index: str) -> set[str]:
        return set(self._writes[index])

    def acked_present(self, index: str) -> set[str]:
        """Ids whose LAST attempted op is an acked create/index."""
        out = set()
        for doc_id, entries in self._writes[index].items():
            last = entries[-1]
            if last["kind"] == "index" and last["acked"]:
                out.add(doc_id)
        return out

    def acked_deleted(self, index: str) -> set[str]:
        out = set()
        for doc_id, entries in self._writes[index].items():
            last = entries[-1]
            if last["kind"] == "delete" and last["acked"]:
                out.add(doc_id)
        return out

    def open_context_ids(self) -> set[str]:
        return {cid for ctxs in self._open_contexts.values()
                for cid in ctxs.values()}

    # -- generation floors (white-box: engine's published generation) ------

    def generation_floors(self) -> dict[tuple, tuple]:
        """(index, shard, node) -> (generation, engine identity) for every
        live local shard. A search issued after this snapshot must be
        served at >= these generations (by the same engine instance)."""
        floors: dict[tuple, tuple] = {}
        for nid, node in self.nodes.items():
            for (index, num), shard in node.local_shards.items():
                floors[(index, num, nid)] = (
                    shard.engine._refresh_generation, id(shard.engine))
        return floors

    def _stamp_generations(self, op: dict, resp: dict) -> None:
        stamps = resp.get("_soak_generations") or {}
        out = {}
        for (index, num, nid), gen in stamps.items():
            shard = self.nodes[nid].local_shards.get((index, num))
            engine_id = id(shard.engine) if shard is not None else None
            out[(index, num, nid, engine_id)] = gen
        op["generations"] = out

    # -- quiesce search (invariant support) --------------------------------

    def search_all_ids(self, index: str) -> set[str]:
        total = len(self._writes[index]) + 10
        resp = self.call(
            lambda callback: self.client.search(
                self.live_leader().node_id, index,
                {"query": {"match_all": {}}, "size": total}, callback))
        if "error" in resp:
            self.fail("no-acked-write-loss",
                      f"quiesce search of [{index}] failed: {resp['error']}")
        if resp["_shards"]["failed"]:
            self.fail("no-acked-write-loss",
                      f"quiesce search of [{index}] degraded: "
                      f"{resp['_shards']}")
        return {h["_id"] for h in resp["hits"]["hits"]}

    # -- op planning -------------------------------------------------------

    def _next_doc(self, index: str) -> tuple[str, dict]:
        i = self._doc_seq
        self._doc_seq += 1
        doc_id = f"d{i}"
        if index == "logs":
            src = {"msg": f"hello world {i}", "tag": f"t{i % 5}", "n": i}
        elif index in ("vec", "annvec"):
            src = {"x": [round(self.wrng.uniform(-1.0, 1.0), 4)
                         for _ in range(_VEC_DIM)], "tag": f"t{i % 3}"}
        else:
            src = {"msg": f"fused hello {i}",
                   "x": [round(self.wrng.uniform(-1.0, 1.0), 4)
                         for _ in range(_VEC_DIM)]}
        return doc_id, src

    def _vec(self) -> list[float]:
        return [round(self.wrng.uniform(-1.0, 1.0), 4)
                for _ in range(_VEC_DIM)]

    _OP_WEIGHTS = [
        ("index", 22), ("bulk", 12), ("delete", 6), ("refresh", 8),
        ("flush", 3), ("force_merge", 3),
        ("search_match", 12), ("search_knn", 10), ("search_aggs", 7),
        ("search_hybrid", 5), ("msearch", 5), ("scroll_chain", 4),
        ("pit_chain", 3), ("search_ann", 6),
    ]

    def _plan_cycle_ops(self, flood: bool) -> list[dict]:
        """Draw the cycle's whole op schedule up front — every RNG draw
        happens here, in a fixed order, so replay is exact."""
        kinds = [k for k, w in self._OP_WEIGHTS for _ in range(w)]
        plans: list[dict] = []
        n_ops = self.cfg.ops_per_cycle
        for _ in range(n_ops):
            offset = self.wrng.randint(200, max(self.cfg.cycle_ms - 4_000,
                                                1_000))
            kind = self.wrng.choice(kinds)
            via = self.wrng.choice(self.node_ids)
            plan = {"kind": kind, "offset": offset, "via": via}
            if kind == "index":
                plan["index"] = self.wrng.choice(self.indices)
                plan["doc"] = self._next_doc(plan["index"])
            elif kind == "bulk":
                plan["index"] = self.wrng.choice(["logs", "vec"])
                plan["docs"] = [self._next_doc(plan["index"])
                                for _ in range(self.wrng.randint(3, 8))]
            elif kind == "delete":
                plan["index"] = self.wrng.choice(self.indices)
                known = sorted(self._writes[plan["index"]])
                live = [d for d in known
                        if self._writes[plan["index"]][d][-1]["kind"]
                        == "index"]
                if not live:
                    plan["kind"] = "index"
                    plan["doc"] = self._next_doc(plan["index"])
                else:
                    plan["doc_id"] = self.wrng.choice(live)
                    # claim it in the ledger NOW so a later plan in this
                    # cycle can't race a second delete of the same id
                    self._writes[plan["index"]][plan["doc_id"]].append(
                        {"op": None, "kind": "delete", "acked": False})
            elif kind in ("refresh", "flush", "force_merge"):
                plan["index"] = self.wrng.choice(self.indices)
            elif kind == "search_match":
                plan["index"] = self.wrng.choice(["logs", "hyb"])
                plan["body"] = {"query": {"match": {"msg": "hello"}},
                                "size": 5}
            elif kind == "search_knn":
                plan["index"] = "vec"
                plan["body"] = {"query": {"knn": {"x": {
                    "vector": self._vec(), "k": 5}}}, "size": 5}
            elif kind == "search_ann":
                # IVF-PQ serving path: the annvec index carries
                # an ANN structure, so these ride the batched ADC dispatch
                # — under the FUSED kernel policy: run_soak
                # forces search.knn.ann.kernel="pallas", so every one of
                # these runs the interpret parity path's cooperative
                # host/device split under kill/partition chaos
                plan["index"] = "annvec"
                plan["body"] = {"query": {"knn": {"x": {
                    "vector": self._vec(), "k": 5}}}, "size": 5}
            elif kind == "search_aggs":
                plan["index"] = "logs"
                plan["body"] = {
                    "query": {"match_all": {}}, "size": 3,
                    "aggs": {"tags": {"terms": {"field": "tag"}},
                             "mean_n": {"avg": {"field": "n"}}}}
            elif kind == "search_hybrid":
                plan["index"] = "hyb"
                plan["body"] = {"query": {"hybrid": {"queries": [
                    {"match": {"msg": "hello"}},
                    {"knn": {"x": {"vector": self._vec(), "k": 5}}},
                ]}}, "size": 5}
            elif kind == "msearch":
                plan["index"] = "vec"
                plan["bodies"] = [
                    {"query": {"knn": {"x": {"vector": self._vec(),
                                             "k": 4}}}, "size": 4}
                    for _ in range(3)]
            elif kind == "scroll_chain":
                plan["index"] = "logs"
                plan["pages"] = 2
            elif kind == "pit_chain":
                plan["index"] = self.wrng.choice(["logs", "vec"])
            plans.append(plan)
        if self.cycle == 1:
            # one mid-soak ANN index rebuild (fresh docs + refresh + force
            # merge): the merged segment re-trains its IVF-PQ structure,
            # so in-flight batched ANN traffic must observe a NEW build
            # generation — the generation-isolation contract under chaos
            plans.append({
                "kind": "ann_rebuild", "via": self.anchor(),
                "index": "annvec", "offset": self.cfg.cycle_ms // 2,
                "docs": [self._next_doc("annvec") for _ in range(6)],
            })
        if self.cfg.snapshots:
            # one cluster-snapshot create/status/restore/verify cycle per
            # soak cycle, interleaved with the bulk+chaos mix: the restored
            # index must match the acked-write ledger at snapshot time
            plans.append({
                "kind": "snapshot_cycle",
                "offset": int(self.cfg.cycle_ms * 0.45),
                "via": self.wrng.choice(self.node_ids),
                "name": f"s{self.cycle}",
                "dest": f"logs-restore-{self.cycle}",
            })
        if flood:
            # one burst of bulks tagged to the enforced flood group, all
            # issued in a single callback so admission sees them together,
            # plus interactive searches DURING the flood window
            at = self.cfg.cycle_ms // 3
            plans.append({"kind": "bulk_flood", "offset": at, "via": "n0",
                          "bulks": [[self._next_doc("logs")
                                     for _ in range(3)]
                                    for _ in range(8)]})
            # background msearch pressure alongside the bulk flood (the
            # the tail scenario: BOTH background kinds push on the
            # serving tier while the interactive probes run)
            plans.append({
                "kind": "msearch_flood", "offset": at + 20,
                "via": self.wrng.choice(self.node_ids), "index": "vec",
                "bursts": 4,
                "bodies": [
                    {"query": {"knn": {"x": {"vector": self._vec(),
                                             "k": 4}}}, "size": 4}
                    for _ in range(3)]})
            for j in range(4):
                plans.append({
                    "kind": "search_match", "offset": at + 40 * (j + 1),
                    "via": self.wrng.choice(self.node_ids),
                    "index": "logs", "interactive": True,
                    "body": {"query": {"match": {"msg": "hello"}},
                             "size": 5}})
            # interactive kNN probes ride the flood too: the tail lever
            # under test is the QUERY path, lanes + batcher included
            for j in range(2):
                plans.append({
                    "kind": "search_knn", "offset": at + 60 * (j + 1),
                    "via": self.wrng.choice(self.node_ids),
                    "index": "vec", "interactive": True,
                    "body": {"query": {"knn": {"x": {
                        "vector": self._vec(), "k": 5}}}, "size": 5}})
        plans.sort(key=lambda p: p["offset"])
        return plans

    # -- op execution ------------------------------------------------------

    def _issue(self, plan: dict) -> None:
        op = dict(plan)
        op["i"] = len(self.ops)
        op["completions"] = 0
        self.ops.append(op)
        op["issued_ms"] = self.queue.now_ms
        op["cycle"] = self.cycle
        self.report.ops_issued += 1
        self.log_event("issue", i=op["i"], kind=op["kind"],
                       index=op.get("index"), via=op["via"])
        if op.get("interactive"):
            self.flood_stats["interactive"] += 1
        handler = getattr(self, f"_issue_{op['kind']}")
        try:
            handler(op)
        except Exception as e:  # noqa: BLE001 - an op may fail, not wedge
            self._complete(op, {"error": f"{type(e).__name__}: {e}"})

    def _complete(self, op: dict, resp: dict) -> None:
        op["completions"] += 1
        if op["completions"] > 1:
            self.fail("shed-correctness",
                      f"op#{op['i']} [{op['kind']}] completed "
                      f"{op['completions']} times")
        self.report.ops_completed += 1
        outcome = self._outcome_digest(op, resp)
        if outcome.get("error") or outcome.get("failed"):
            self.report.ops_degraded += 1
        if not outcome.get("error"):
            # successful completions feed the per-cycle throughput ratchet,
            # attributed to the ISSUING cycle (stragglers count where they
            # were planned)
            per = self._cycle_counts.setdefault(
                op.get("cycle", self.cycle), {})
            cls = _OP_CLASS.get(op["kind"], "query")
            per[cls] = per.get(cls, 0) + 1
        if outcome.get("shed"):
            self.report.sheds += 1
        self.log_event("complete", i=op["i"], kind=op["kind"], **outcome)
        if "hits" in resp:
            self._stamp_generations(op, resp)
            for inv in self.invariants:
                inv.on_response(self, op, resp)
        if op.get("interactive") and "hits" in resp and \
                not resp["_shards"]["failed"]:
            self.flood_stats["interactive_ok"] += 1
        if op.get("interactive"):
            # virtual-time latency of the interactive probe, per issuing
            # cycle (the p99-floor ratchet's input; pure function of seed)
            self.interactive_latencies.setdefault(
                op.get("cycle", self.cycle), []).append(
                max(0, self.queue.now_ms - op["issued_ms"]))

    @staticmethod
    def _outcome_digest(op: dict, resp: dict) -> dict:
        """The deterministic projection of a response that enters the event
        log (wall-time fields like `took` stay out)."""
        out: dict[str, Any] = {}
        if "error" in resp:
            err = str(resp["error"])
            out["error"] = err[:120]
            out["shed"] = "RejectedExecutionException" in err or \
                resp.get("status") == 429
            return out
        if "hits" in resp:
            out["total"] = (resp["hits"].get("total") or {}).get("value")
            out["ids"] = [h.get("_id") for h in resp["hits"]["hits"]]
            shards = resp.get("_shards") or {}
            out["failed"] = shards.get("failed", 0)
            if "aggregations" in resp:
                out["aggs"] = json.dumps(resp["aggregations"],
                                         sort_keys=True, default=str)
        elif "items" in resp:
            out["items"] = [
                {k: (v.get("result"), v.get("_seq_no"), v.get("status"))
                 for k, v in item.items()}
                for item in resp["items"] if item]
            out["errors"] = resp.get("errors")
        elif "responses" in resp:
            out["n"] = len(resp["responses"])
            out["sub"] = [
                (r.get("hits", {}).get("total", {}).get("value")
                 if isinstance(r, dict) and "hits" in r
                 else str(r.get("error"))[:60] if isinstance(r, dict)
                 else None)
                for r in resp["responses"]]
        else:
            out["keys"] = sorted(resp)
            if "result" in resp:
                out["result"] = resp["result"]
                out["seq_no"] = resp.get("_seq_no")
        return out

    # individual op issuers -------------------------------------------------

    def _search_op(self, op: dict) -> None:
        op["floors"] = self.generation_floors()
        self.client.search(op["via"], op["index"], op["body"],
                           lambda r: self._complete(op, r))

    _issue_search_match = _search_op
    _issue_search_knn = _search_op
    _issue_search_ann = _search_op
    _issue_search_aggs = _search_op
    _issue_search_hybrid = _search_op

    def _issue_ann_rebuild(self, op: dict) -> None:
        """Mid-soak ANN rebuild: bulk fresh docs, refresh, force-merge. The
        merged segment re-trains its IVF-PQ index (index/device.py build
        path), so the serving batch keys pick up a fresh build generation
        while batched ANN queries are in flight."""
        node = self.nodes[op["via"]]
        operations = []
        for doc_id, src in op["docs"]:
            self._record_write(op["index"], doc_id, op["i"], "index")
            operations.append(
                ("index", {"_index": op["index"], "_id": doc_id}, src))

        def merged(resp: dict) -> None:
            self._complete(op, resp)

        def refreshed(_resp: dict) -> None:
            self.client.broadcast(op["via"], "indices:admin/forcemerge[node]",
                                  {"indices": [op["index"]],
                                   "max_num_segments": 1},
                                  merged)

        def indexed(resp: dict) -> None:
            for item in resp.get("items") or []:
                for _action, r in (item or {}).items():
                    if r and "error" not in r and \
                            r.get("_shards", {}).get("failed", 1) == 0:
                        self._ack_write(op["index"], r.get("_id"), op["i"])
            node.refresh(op["index"], refreshed)

        node.bulk(operations, indexed)

    def _issue_index(self, op: dict) -> None:
        doc_id, src = op["doc"]
        self._record_write(op["index"], doc_id, op["i"], "index")

        def done(resp: dict) -> None:
            if "error" not in resp and \
                    resp.get("_shards", {}).get("failed", 1) == 0:
                self._ack_write(op["index"], doc_id, op["i"])
            self._complete(op, resp)

        self.nodes[op["via"]].index_doc(op["index"], doc_id, src, done)

    def _issue_delete(self, op: dict) -> None:
        doc_id = op["doc_id"]
        # adopt the ledger entry claimed at plan time
        for entry in self._writes[op["index"]].get(doc_id, ()):
            if entry["kind"] == "delete" and entry["op"] is None:
                entry["op"] = op["i"]

        def done(resp: dict) -> None:
            if "error" not in resp and resp.get("result") == "deleted" and \
                    resp.get("_shards", {}).get("failed", 1) == 0:
                self._ack_write(op["index"], doc_id, op["i"])
            self._complete(op, resp)

        self.nodes[op["via"]].delete_doc(op["index"], doc_id, done)

    def _issue_bulk(self, op: dict) -> None:
        operations = []
        for doc_id, src in op["docs"]:
            self._record_write(op["index"], doc_id, op["i"], "index")
            operations.append(
                ("index", {"_index": op["index"], "_id": doc_id}, src))

        def done(resp: dict) -> None:
            for item in resp.get("items") or []:
                for action, r in (item or {}).items():
                    if r and "error" not in r and \
                            r.get("_shards", {}).get("failed", 1) == 0:
                        self._ack_write(op["index"], r.get("_id"), op["i"])
            self._complete(op, resp)

        self.nodes[op["via"]].bulk(operations, done)

    def _issue_bulk_flood(self, op: dict) -> None:
        """The wlm scenario: N bulks tagged to the enforced flood group in
        one burst — past the slot share they MUST shed 429."""
        node = self.nodes[op["via"]]
        pending = [len(op["bulks"])]

        def one_done(resp: dict) -> None:
            self.flood_stats["bulks"] += 1
            if resp.get("status") == 429 or (
                    "error" in resp
                    and "RejectedExecutionException" in str(resp["error"])):
                self.flood_stats["sheds"] += 1
            else:
                for item in resp.get("items") or []:
                    for action, r in (item or {}).items():
                        if r and "error" not in r and \
                                r.get("_shards", {}).get("failed", 1) == 0:
                            self._ack_write("logs", r.get("_id"), op["i"])
            pending[0] -= 1
            if pending[0] == 0:
                self._complete(op, {"responses": [],
                                    "flood": dict(self.flood_stats)})

        for docs in op["bulks"]:
            operations = []
            for doc_id, src in docs:
                self._record_write("logs", doc_id, op["i"], "index")
                operations.append(
                    ("index", {"_index": "logs", "_id": doc_id}, src))
            node.bulk(operations, one_done, query_group="flood")

    def _issue_msearch_flood(self, op: dict) -> None:
        """Background msearch pressure riding the flood window: `bursts`
        concurrent msearch fan-outs (the background lane's traffic) while
        the interactive probes run. Completes exactly once when every
        burst answered; sub-responses feed no hit invariants (they race
        the flood's writes by design)."""
        pending = [op["bursts"]]

        def one_done(_resp: dict) -> None:
            self.flood_stats["msearches"] += 1
            pending[0] -= 1
            if pending[0] == 0:
                self._complete(op, {"responses": [],
                                    "flood": dict(self.flood_stats)})

        for _ in range(op["bursts"]):
            self.client.msearch(op["via"], op["index"], op["bodies"],
                                one_done)

    def _issue_refresh(self, op: dict) -> None:
        self.nodes[op["via"]].refresh(op["index"],
                                      lambda r: self._complete(op, r))

    def _issue_flush(self, op: dict) -> None:
        self.client.broadcast(op["via"], "indices:admin/flush[node]",
                              {"indices": [op["index"]]},
                              lambda r: self._complete(op, r))

    def _issue_force_merge(self, op: dict) -> None:
        self.client.broadcast(op["via"], "indices:admin/forcemerge[node]",
                              {"indices": [op["index"]],
                               "max_num_segments": 1},
                              lambda r: self._complete(op, r))

    def _issue_msearch(self, op: dict) -> None:
        op["floors"] = self.generation_floors()

        def done(resp: dict) -> None:
            # runtime hit checks run per sub-response
            for sub in resp.get("responses") or []:
                if isinstance(sub, dict) and "hits" in sub:
                    sub_op = dict(op, index=op["index"])
                    for inv in self.invariants:
                        inv.on_response(self, sub_op, sub)
            self._complete(op, resp)

        self.client.msearch(op["via"], op["index"], op["bodies"], done)

    def _issue_scroll_chain(self, op: dict) -> None:
        """open (pinned contexts) -> pages -> close; any step may degrade,
        the chain always completes exactly once."""
        state = {"seen": 0, "pages_left": op["pages"], "ids": []}

        def close_and_complete(outcome: dict) -> None:
            ctxs = self._open_contexts.pop(op["i"], None)
            if not ctxs:
                self._complete(op, outcome)
                return
            self.client.ctx_close(op["via"], ctxs,
                                  lambda _r: self._complete(op, outcome))

        def on_page(resp: dict) -> None:
            if "error" in resp:
                close_and_complete(resp)
                return
            hits = resp["hits"]["hits"]
            state["ids"].extend(h.get("_id") for h in hits)
            state["seen"] += len(hits)
            state["pages_left"] -= 1
            if state["pages_left"] <= 0 or not hits:
                close_and_complete(
                    {"hits": {"total": {"value": state["seen"]},
                              "hits": []},
                     "_shards": {"failed": 0},
                     "scroll_ids": state["ids"]})
                return
            ctxs = self._open_contexts.get(op["i"])
            if not ctxs:
                close_and_complete({"error": "contexts lost"})
                return
            self.queue.schedule(400, lambda: self.client.ctx_search(
                op["via"], ctxs, None, 3, state["seen"], on_page))

        def on_open(resp: dict) -> None:
            if "error" in resp or "_soak_contexts" not in resp:
                close_and_complete(resp if "error" in resp
                                   else dict(resp, error="no contexts"))
                return
            self._open_contexts[op["i"]] = resp["_soak_contexts"]
            hits = resp["hits"]["hits"]
            # a scroll must not return duplicate ids ACROSS pages either
            state["ids"].extend(h.get("_id") for h in hits)
            state["seen"] += len(hits)
            on_page_dup_check()
            if state["pages_left"] <= 0:
                close_and_complete({"hits": {"total": {"value":
                                                       state["seen"]},
                                             "hits": []},
                                    "_shards": {"failed": 0},
                                    "scroll_ids": state["ids"]})
                return
            self.queue.schedule(400, lambda: self.client.ctx_search(
                op["via"], self._open_contexts.get(op["i"], {}),
                None, 3, state["seen"], on_page))

        def on_page_dup_check() -> None:
            ids = [i for i in state["ids"] if i is not None]
            if len(ids) != len(set(ids)):
                self.fail("snapshot-isolation",
                          f"op#{op['i']} scroll returned duplicate ids "
                          f"across pages: {sorted(ids)}")

        self.client.search(op["via"], op["index"],
                           {"query": {"match_all": {}}, "size": 3},
                           on_open, keep_context=True,
                           keep_alive_ms=120_000)

    def _issue_pit_chain(self, op: dict) -> None:
        """open PIT -> one refresh lands in between -> PIT search must see
        the PINNED view -> close."""

        def close_and_complete(outcome: dict) -> None:
            ctxs = self._open_contexts.pop(op["i"], None)
            if not ctxs:
                self._complete(op, outcome)
                return
            self.client.ctx_close(op["via"], ctxs,
                                  lambda _r: self._complete(op, outcome))

        def on_pit_search(resp: dict) -> None:
            close_and_complete(resp)

        def on_open(resp: dict) -> None:
            if "error" in resp or "_soak_contexts" not in resp:
                close_and_complete(resp if "error" in resp
                                   else dict(resp, error="no contexts"))
                return
            self._open_contexts[op["i"]] = resp["_soak_contexts"]
            self.queue.schedule(600, lambda: self.client.ctx_search(
                op["via"], self._open_contexts.get(op["i"], {}),
                {"query": {"match_all": {}}, "size": 5}, 5, 0,
                on_pit_search))

        self.client.search(op["via"], op["index"],
                           {"query": {"match_all": {}}, "size": 0},
                           on_open, keep_context=True,
                           keep_alive_ms=120_000)

    # -- faults ------------------------------------------------------------

    def _corrupt_one_copy(self) -> None:
        """Failure-injection hook: remove one acked doc from the primary
        copy, bypassing replication. no-acked-write-loss MUST catch it."""
        present = sorted(self.acked_present("logs"))
        if not present:
            self.queue.schedule(500, self._corrupt_one_copy)
            return
        doc_id = present[0]
        leader_state = self.live_leader().applied_state
        from opensearch_tpu_torch.common.hashing import shard_id_for_routing

        meta = leader_state.indices["logs"]
        num = shard_id_for_routing(doc_id, meta.num_shards)
        primary = leader_state.primary("logs", num)
        shard = self.nodes[primary.node_id].local_shards.get(("logs", num))
        if shard is None:
            self.queue.schedule(500, self._corrupt_one_copy)
            return
        self.log_event("inject_corruption", doc=doc_id,
                       node=primary.node_id, shard=num)
        shard.apply_delete_on_primary(doc_id)
        shard.refresh()

    # -- cluster-mode snapshots (satellite: snapshots in the soak mix) -----

    def _issue_snapshot_cycle(self, op: dict) -> None:
        """Create -> status -> restore -> verify -> drop, interleaved with
        the live bulk+chaos mix. The restored index must surface exactly
        the acked-write ledger at snapshot time: every acked-present doc
        whose ledger is untouched afterwards must come back, no
        acked-deleted doc may resurrect, and nothing never-written may
        appear. Transport-level failures degrade the op (chaos may
        legitimately break a snapshot); ledger mismatches FAIL the soak."""
        from opensearch_tpu_torch.snapshots.service import ClusterSnapshotsService

        via = op["via"] if op["via"] in self.nodes else self.anchor()
        node = self.nodes[via]
        svc = ClusterSnapshotsService(node, self._snap_root)
        name, dest = op["name"], op["dest"]
        base_present = self.acked_present("logs")
        base_deleted = self.acked_deleted("logs")
        base_len = {d: len(e) for d, e in self._writes["logs"].items()}

        def degrade(stage: str, err: Any) -> None:
            self._complete(op, {"error": f"snapshot {stage}: {err}"})

        def cleanup(then) -> None:
            # the restore target is replicas=0; drop it as soon as the
            # verdict is in so a stray copy can't wedge convergence later
            if dest not in node.applied_state.indices:
                then()
                return
            try:
                node.delete_index(dest, lambda _r: then())
            except Exception as e:  # noqa: BLE001 - no leader; leave to chaos
                self.log_event("snapshot_cleanup_error", dest=dest,
                               error=str(e)[:120])
                then()

        def on_verified(resp: dict) -> None:
            if "error" in resp or resp.get("_shards", {}).get("failed"):
                cleanup(lambda: degrade(
                    "verify-search",
                    resp.get("error") or resp.get("_shards")))
                return
            restored = {h["_id"] for h in resp["hits"]["hits"]}
            untouched = {d for d, n in base_len.items()
                         if len(self._writes["logs"].get(d, ())) == n}
            missing = sorted((base_present & untouched) - restored)
            zombies = sorted(restored & (base_deleted & untouched))
            phantoms = sorted(restored - self.attempted_ids("logs"))
            if missing:
                self.fail("snapshot-restore",
                          f"acked docs absent from restored [{dest}]: "
                          f"{missing[:5]}")
            if zombies:
                self.fail("snapshot-restore",
                          f"acked-deleted docs resurrected in [{dest}]: "
                          f"{zombies[:5]}")
            if phantoms:
                self.fail("snapshot-restore",
                          f"never-written docs in restored [{dest}]: "
                          f"{phantoms[:5]}")
            snaps = self.report.snapshots
            snaps["cycles"] = snaps.get("cycles", 0) + 1
            snaps["verified_docs"] = (snaps.get("verified_docs", 0)
                                      + len(restored))
            cleanup(lambda: self._complete(op, {
                "snapshot": name, "restored": len(restored),
                "verified": len(base_present & untouched)}))

        def on_restored(resp: dict) -> None:
            if resp.get("error"):
                cleanup(lambda: degrade("restore", resp["error"]))
                return
            self.client.search(
                via, dest,
                {"query": {"match_all": {}}, "size": len(base_len) + 50},
                on_verified)

        def on_created(resp: dict) -> None:
            if resp.get("error"):
                degrade("create", resp["error"])
                return
            st = svc.status(name)
            if st.get("error") or st.get("state") != "SUCCESS":
                degrade("status", st)
                return
            svc.restore(name, dest, on_restored)

        svc.create(name, "logs", on_created)

    # -- elastic topology (tentpole: join / rebalance / drain) -------------

    def _topology_poll(self, what: str, cond, on_ok,
                       deadline_ms: int) -> None:
        """Re-check `cond` every 500ms of virtual time until it holds,
        then advance the reshape chain; a blown deadline fails the soak
        (the reshape wedging IS the bug this harness exists to catch)."""

        def tick() -> None:
            if cond():
                on_ok()
            elif self.queue.now_ms > deadline_ms:
                self.fail("topology",
                          f"reshape stage [{what}] did not complete by "
                          f"its virtual deadline")
            else:
                self.queue.schedule(500, tick)

        tick()

    def _topology_milestone(self, event: str, **fields: Any) -> None:
        self.log_event(f"topology_{event}", **fields)
        self.report.topology.append(
            {"event": event, "at_ms": self.queue.now_ms, **fields})

    def _start_topology_reshape(self) -> None:
        """The seeded elastic-topology chain, run under live traffic:
        a fresh node JOINS (peer recovery + residency warm-up before it
        is counted on), the router REBALANCES onto it, a disk ramp pushes
        one replica-holder over the high watermark (the decider must
        EVACUATE), and finally one founding member is DRAINED via
        allocation filtering and departs with zero acked-write loss."""
        self._topology_pending += 1
        self._topology_milestone("reshape_start", members=list(self.node_ids))
        self._topology_join()

    def _topology_join(self) -> None:
        from opensearch_tpu_torch.cluster.cluster_node import ClusterNode
        from opensearch_tpu_torch.cluster import residency as residency_mod
        from opensearch_tpu_torch.telemetry.export import MemorySink, SpanExporter

        ordinal = self._next_ordinal
        self._next_ordinal += 1
        nid = f"n{ordinal}"
        # no bootstrap: an empty voting config cannot self-elect, so the
        # fresh node discovers the sitting leader via pre-vote and JOINS
        node = ClusterNode(nid, self._tmp_path / nid, self.transport,
                           self.queue, list(self.node_ids) + [nid],
                           device=self.cfg.device)
        node.telemetry.tracer.exporter = SpanExporter(
            MemorySink(), service_name=nid,
            slow_threshold_ms=250, sample_ratio=0.25,
            rng=random.Random(self.cfg.seed * 31_337 + 11 + ordinal),
            synchronous=True, mode="memory",
        )
        node.disk_usage_pct = FaultScheduler.BASELINE_DISK_PCT
        node.start()
        self.nodes[nid] = node
        self.node_ids.append(nid)
        self._topology_milestone("join_started", node=nid)

        def warm() -> bool:
            leader = self.maybe_live_leader()
            if leader is None or nid not in leader.applied_state.nodes:
                return False
            if nid not in node.applied_state.nodes:
                return False
            # mesh bundles warm from the residency advertisement before
            # the joiner is treated as a full member
            return (node._residency_seeded
                    or not residency_mod.default_config.enabled)

        self._topology_poll(
            "join-warm", warm,
            lambda: self._topology_joined(nid),
            self.queue.now_ms + 120_000)

    def _topology_joined(self, nid: str) -> None:
        self._topology_milestone("join_warm", node=nid)

        def settled() -> bool:
            leader = self.maybe_live_leader()
            if leader is None:
                return False
            state = leader.applied_state
            return (len(state.nodes) == len(self.node_ids)
                    and all(r.state == "STARTED" and r.node_id is not None
                            and not r.relocating_node
                            for r in state.routing))

        self._topology_poll(
            "post-join-rebalance", settled,
            lambda: self._begin_disk_ramp(nid),
            self.queue.now_ms + 120_000)

    def _begin_disk_ramp(self, joined: str) -> None:
        """Push one replica-holder over the high watermark in two steps
        (through the heartbeat path, like a real disk filling up); the
        DiskThresholdDecider must evacuate its replicas while queries
        keep flowing."""
        leader = self.live_leader()
        state = leader.applied_state
        holders = sorted({r.node_id for r in state.routing
                          if not r.primary and r.node_id is not None
                          and r.node_id not in (joined, leader.node_id)})
        if not holders:
            # degenerate layouts skip the ramp; the drain still runs
            self._topology_milestone("ramp_skipped")
            self._topology_drain(joined, None)
            return
        victim = holders[0]
        self._topology_milestone("disk_ramp", node=victim)
        self.nodes[victim].disk_usage_pct = 70.0
        self.queue.schedule(
            1_000, lambda: self._ramp_to_high(joined, victim))

    def _ramp_to_high(self, joined: str, victim: str) -> None:
        if victim in self.nodes:
            self.nodes[victim].disk_usage_pct = 95.0

        def evacuated() -> bool:
            leader = self.maybe_live_leader()
            if leader is None:
                return False
            state = leader.applied_state
            return (not any(r.relocating_node for r in state.routing)
                    and not any(r.node_id == victim and not r.primary
                                for r in state.routing))

        self._topology_poll(
            "watermark-evacuation", evacuated,
            lambda: self._after_evacuation(joined, victim),
            self.queue.now_ms + 120_000)

    def _after_evacuation(self, joined: str, victim: str) -> None:
        self._topology_milestone("evacuated", node=victim)
        if victim in self.nodes:
            self.nodes[victim].disk_usage_pct = \
                FaultScheduler.BASELINE_DISK_PCT
        self._topology_drain(joined, victim)

    def _topology_drain(self, joined: str, victim: str | None) -> None:
        """Graceful decommission via allocation filtering: exclude one
        founding member by name, wait for its shards to relocate off,
        then let it depart."""
        leader = self.live_leader()
        target = next(nid for nid in sorted(self.node_ids)
                      if nid != leader.node_id and nid != joined)
        self._topology_milestone("drain_started", node=target)
        self.transport.send(
            self.anchor(), leader.node_id, "cluster:admin/settings/update",
            {"transient":
             {"cluster.routing.allocation.exclude._name": target}},
            on_response=lambda _r: None,
            on_failure=lambda e: self.fail(
                "topology", f"drain settings update failed: {e}"))

        def drained() -> bool:
            leader = self.maybe_live_leader()
            if leader is None:
                return False
            state = leader.applied_state
            return (not any(r.node_id == target or r.relocating_node
                            == target for r in state.routing)
                    and all(r.state == "STARTED" for r in state.routing))

        self._topology_poll(
            "drain", drained,
            lambda: self._depart(target),
            self.queue.now_ms + 180_000)

    def _depart(self, target: str) -> None:
        """The drained node leaves: it goes dark FIRST, then the exclude
        filter lifts — order matters, or the still-running node would
        soak shards right back up before shutdown."""
        self._topology_milestone("depart", node=target)
        self.transport.take_down(target)
        node = self.nodes.pop(target)
        node.close()
        self.node_ids.remove(target)
        leader = self.live_leader()
        self.transport.send(
            self.anchor(), leader.node_id, "cluster:admin/settings/update",
            {"transient":
             {"cluster.routing.allocation.exclude._name": None}},
            on_response=lambda _r: None,
            on_failure=lambda e: self.fail(
                "topology", f"exclude cleanup failed: {e}"))

        def departed() -> bool:
            leader = self.maybe_live_leader()
            return (leader is not None
                    and target not in leader.applied_state.nodes)

        self._topology_poll(
            "departure-eviction", departed,
            self._topology_done,
            self.queue.now_ms + 120_000)

    def _topology_done(self) -> None:
        self._topology_milestone("reshape_done",
                                 members=list(self.node_ids))
        self._topology_pending -= 1

    # -- probes ------------------------------------------------------------

    def _probe(self) -> None:
        for inv in self.invariants:
            inv.at_probe(self)
        self._probe_timer = self.queue.schedule(500, self._probe)

    # -- lifecycle ---------------------------------------------------------

    def setup(self) -> None:
        self.run_ms(6_000)
        self.live_leader()
        specs = {
            "logs": ({"number_of_shards": 2,
                      "number_of_replicas": self.cfg.replica_count},
                     {"properties": {"msg": {"type": "text"},
                                     "tag": {"type": "keyword"},
                                     "n": {"type": "integer"}}}),
            "vec": ({"number_of_shards": 2,
                     "number_of_replicas": self.cfg.replica_count},
                    {"properties": {"x": {"type": "knn_vector",
                                          "dimension": _VEC_DIM},
                                    "tag": {"type": "keyword"}}}),
            # hybrid fusion normalizes per node; one shard keeps the
            # per-node fusion globally correct in cluster mode
            "hyb": ({"number_of_shards": 1,
                     "number_of_replicas": self.cfg.replica_count},
                    {"properties": {"msg": {"type": "text"},
                                    "x": {"type": "knn_vector",
                                          "dimension": _VEC_DIM}}}),
            # IVF-PQ index: tiny method params so the structure
            # builds from the seed corpus and rebuilds stay cheap under
            # the deterministic queue; knn queries against it exercise the
            # batched ANN dispatch path under kill/partition faults
            "annvec": ({"number_of_shards": 1,
                        "number_of_replicas": self.cfg.replica_count},
                       {"properties": {"x": {
                           "type": "knn_vector", "dimension": _VEC_DIM,
                           "method": {"name": "ivf_pq", "parameters": {
                               "nlist": 4, "m": 2, "nprobe": 4,
                               "min_train": 24, "iters": 2}}},
                           "tag": {"type": "keyword"}}}),
        }
        anchor = self.nodes[self.anchor()]
        for name, (settings, mappings) in specs.items():
            resp = self.call(anchor.create_index, name,
                             {"settings": {"index": settings},
                              "mappings": mappings})
            if not resp.get("acknowledged"):
                self.fail("setup", f"create [{name}] failed: {resp}")
        self.run_ms(8_000)
        # a seed corpus so the first cycle's queries have data to hit; the
        # annvec index seeds PAST its min_train so the first refresh
        # publishes a built IVF-PQ structure
        seed_counts = {i: 6 for i in self.indices}
        seed_counts["annvec"] = 30
        for index in self.indices:
            for _ in range(seed_counts[index]):
                doc_id, src = self._next_doc(index)
                self._writes[index][doc_id] = [
                    {"op": -1, "kind": "index", "acked": False}]
                resp = self.call(anchor.index_doc, index, doc_id, src)
                if "error" not in resp and \
                        resp.get("_shards", {}).get("failed", 1) == 0:
                    self._writes[index][doc_id][0]["acked"] = True
        for index in self.indices:
            self.call(anchor.refresh, index)
        self.run_ms(2_000)
        # wlm flood group (enforced, tiny share -> ~3 bulk slots of 64)
        if self.cfg.flood_cycle >= 0 or self.cfg.flood_all:
            for node in self.nodes.values():
                node.query_groups.put({
                    "name": "flood", "resiliency_mode": "enforced",
                    "resource_limits": {"memory": 0.05}})
        self.log_event("setup_done", docs=self._doc_seq)

    def run_cycle(self, cycle: int) -> None:
        self.cycle = cycle
        self.log_event("cycle_start", cycle=cycle)
        flood = cycle == self.cfg.flood_cycle or self.cfg.flood_all
        plans = self._plan_cycle_ops(flood)
        faults = self.faults.plan_cycle()
        base = self.queue.now_ms
        self._cycle_start_ms = base
        for plan in plans:
            self.queue.schedule(plan["offset"],
                                lambda p=plan: self._issue(p))
        for fault in faults:
            self.queue.schedule(fault["at"],
                                lambda f=fault: self.faults.inject(f))
            self.queue.schedule(fault["at"] + fault["duration"],
                                lambda f=fault: self.faults.heal(f))
        if cycle == self.cfg.topology_cycle:
            # the cluster reshape IS this cycle's chaos: join -> rebalance
            # -> watermark evacuation -> drain, under the live op mix
            self.queue.schedule(500, self._start_topology_reshape)
        if self.cfg.inject_acked_write_loss and cycle == 0:
            self.queue.schedule(self.cfg.cycle_ms // 2,
                                self._corrupt_one_copy)
        self._probe()
        self.queue.run_until(base + self.cfg.cycle_ms)
        if self._probe_timer is not None:
            self._probe_timer.cancel()
        self._quiesce()
        self.report.cycles_completed += 1
        self.log_event("cycle_done", cycle=cycle, digest=self.digest())

    def _quiesce(self) -> None:
        # heal everything and wait for convergence + every op to complete
        # + any in-flight topology reshape to finish its chain
        self.faults.heal_all()
        deadline = self.queue.now_ms + 240_000
        while self.queue.now_ms < deadline:
            self.run_ms(2_000)
            if self._converged() and self._topology_pending == 0 and all(
                    op["completions"] > 0 for op in self.ops):
                break
        else:
            stuck = [op["i"] for op in self.ops if op["completions"] == 0]
            self.fail("convergence",
                      f"cluster/ops did not quiesce in 240s of virtual "
                      f"time (stuck ops: {stuck[:10]}, "
                      f"topology_pending: {self._topology_pending})")
        anchor = self.nodes[self.anchor()]
        for index in self.indices:
            self.call(anchor.refresh, index)
        self.run_ms(2_000)
        # per-class throughput for the cycle: every op issued this cycle
        # has completed (the loop above waits for that), so the counts are
        # final; elapsed spans issue window + quiesce, all virtual time
        elapsed_s = max((self.queue.now_ms - self._cycle_start_ms) / 1000.0,
                        0.001)
        counts = self._cycle_counts.get(self.cycle, {})
        rates = {cls: round(n / elapsed_s, 3)
                 for cls, n in sorted(counts.items())}
        self.report.throughput[self.cycle] = rates
        self.log_event("throughput", cycle=self.cycle, **rates)
        for inv in self.invariants:
            inv.at_quiesce(self)
            self.report.invariants_checked += 1

    def _converged(self) -> bool:
        live = [n for nid, n in self.nodes.items()
                if nid not in self.transport.down]
        leaders = [n for n in live if n.is_leader]
        if len(leaders) != 1:
            return False
        leader = leaders[0]
        if any(n.coordinator.leader_id != leader.node_id for n in live):
            return False
        state = leader.applied_state
        if len(state.nodes) != len(self.node_ids):
            return False
        return all(r.state == "STARTED" and r.node_id is not None
                   and not r.relocating_node for r in state.routing)

    def teardown_checks(self) -> None:
        """Final quiesce: close every held context, advance past keep-alive
        so expiry reaps strays, then assert zero leftovers."""
        self.final_quiesce = True
        anchor = self.anchor()
        for op_i, ctxs in sorted(self._open_contexts.items()):
            self.call(lambda callback, c=ctxs: self.client.ctx_close(
                anchor, c, callback))
        self._open_contexts.clear()
        self.run_ms(130_000)  # past every keep_alive
        for index in self.indices:
            # any search triggers the reap on each node it touches
            self.call(lambda callback, i=index: self.client.search(
                anchor, i, {"query": {"match_all": {}}, "size": 1},
                callback))
        for inv in self.invariants:
            inv.at_quiesce(self)
        self.report.flood = dict(self.flood_stats)
        totals = {"spans_seen": 0, "spans_exported": 0, "spans_dropped": 0}
        for node in self.nodes.values():
            exp = node.telemetry.tracer.exporter
            if exp is None:
                continue
            st = exp.snapshot_stats()
            for k in totals:
                totals[k] += st[k]
        self.report.telemetry = totals
        self.report.digest = self.digest()

    def close(self) -> None:
        for n in self.nodes.values():
            n.close()


def run_soak(seed: int, tmp_path, *, cycles: int = 3, nodes: int = 3,
             ops_per_cycle: int = 30, cycle_ms: int = 20_000,
             chaos: bool = True, flood_cycle: int = 1,
             flood_all: bool = False,
             inject_acked_write_loss: bool = False,
             topology_cycle: int = -1,
             fault_kinds: tuple | None = None,
             snapshots: bool = False,
             throughput_floors: dict | None = None,
             extra_invariants: tuple = (),
             device: str = "cuda") -> SoakReport:
    """Run the soak; returns the SoakReport, raises SoakFailure (seed and
    replay command attached) on any invariant violation. Every node runs
    on ``device``: the card by default, ``"cpu"`` when asked."""
    from opensearch_tpu_torch.search import ann as ann_mod
    from opensearch_tpu_torch.search import batcher as batcher_mod

    cfg = SoakConfig(seed=seed, cycles=cycles, nodes=nodes,
                     ops_per_cycle=ops_per_cycle, cycle_ms=cycle_ms,
                     chaos=chaos, flood_cycle=flood_cycle,
                     flood_all=flood_all,
                     inject_acked_write_loss=inject_acked_write_loss,
                     topology_cycle=topology_cycle,
                     snapshots=snapshots,
                     throughput_floors=throughput_floors,
                     device=device)
    if fault_kinds is not None:
        cfg = dataclasses.replace(cfg, fault_kinds=tuple(fault_kinds))
    harness = SoakHarness(cfg, Path(tmp_path))
    for inv in extra_invariants:
        harness.add_invariant(inv)
    batcher_mod.default_batcher.reset()
    # the search_ann workload exercises the FUSED kernel selection policy:
    # forcing kernel="pallas" sends it through the hand-written ADC scan
    # (K2; on a CPU tensor its wrapper runs the plain version), so the
    # cooperative split (host probe select + one batched scan) faces
    # kill/partition chaos, and the mid-soak ann_rebuild proves
    # old-generation batches never merge into the new kernel variant (both
    # terms ride the batch key). The same forcing covers the EXACT path
    # (search.knn.kernel="pallas"): exact knn ops under FUSED_MAX_K serve
    # through the hand-written fused kernel (K1), so its pool/padding/
    # tie-break math also soaks under chaos. A static policy is
    # seed-deterministic; restored on exit so siblings keep "auto".
    prev_kernel = ann_mod.default_config.kernel
    prev_exact_kernel = ann_mod.default_config.exact_kernel
    ann_mod.default_config.configure(kernel="pallas",
                                     exact_kernel="pallas")
    try:
        with timeutil.clock_scope(harness.queue.clock()), \
                randutil.rng_scope(harness.queue.random):
            harness.setup()
            for cycle in range(cfg.cycles):
                harness.run_cycle(cycle)
            harness.teardown_checks()
    except SoakFailure as failure:
        print(f"SOAK FAILURE seed={failure.seed} cycle={failure.cycle} "
              f"invariant={failure.invariant}\n  replay: python -m "
              f"opensearch_tpu_torch.testing.soak --replay {failure.seed}")
        raise
    finally:
        ann_mod.default_config.configure(kernel=prev_kernel,
                                         exact_kernel=prev_exact_kernel)
        harness.close()
    return harness.report


def floors_from_report(report: SoakReport) -> dict:
    """The per-class floor a recorded run establishes: the MINIMUM rate
    any cycle achieved, per workload class (only classes every cycle
    produced — a class absent from some cycle can't ratchet)."""
    floors: dict[str, float] = {}
    cycles = list(report.throughput.values())
    if not cycles:
        return floors
    classes = set(cycles[0])
    for rates in cycles[1:]:
        classes &= set(rates)
    for cls in sorted(classes):
        floors[cls] = min(rates[cls] for rates in cycles)
    return floors


def load_baseline(path) -> dict | None:
    """Floors from a soak_baseline.json ratchet file, or None if absent."""
    p = Path(path)
    if not p.exists():
        return None
    doc = json.loads(p.read_text())
    return doc.get("floors") or None


def main(argv: list[str] | None = None) -> int:
    import argparse
    import tempfile

    parser = argparse.ArgumentParser(
        description="ingest-while-serving chaos soak (seeded, replayable)")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--replay", type=int, default=None,
                        help="re-run a failing seed byte-identically")
    parser.add_argument("--cycles", type=int, default=3)
    parser.add_argument("--ops", type=int, default=30)
    parser.add_argument("--no-chaos", action="store_true")
    parser.add_argument("--topology-cycle", type=int, default=-1,
                        help="cycle index running the elastic-topology "
                             "reshape (join/rebalance/drain); -1 disables")
    parser.add_argument("--snapshots", action="store_true",
                        help="interleave cluster snapshot create/restore "
                             "cycles with the chaos mix")
    parser.add_argument("--baseline", default=None,
                        help="soak_baseline.json to enforce per-cycle "
                             "throughput floors against")
    parser.add_argument("--record-baseline", default=None,
                        help="write this run's per-class minimum rates "
                             "as a new throughput ratchet file")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                             "cpu")
    parser.add_argument("--race-probe", action="store_true",
                        help="run under the runtime race instrumentation "
                             "(testing/race_probe.py): tagged roles + "
                             "wrapped locks; fail on any confirmed "
                             "unlocked cross-role write")
    args = parser.parse_args(argv)
    seed = args.replay if args.replay is not None else args.seed
    floors = load_baseline(args.baseline) if args.baseline else None
    probe = None
    if args.race_probe:
        from opensearch_tpu_torch.testing.race_probe import probe_scope

        probe_ctx = probe_scope()
    else:
        import contextlib

        probe_ctx = contextlib.nullcontext()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            with probe_ctx as probe:
                report = run_soak(seed, tmp, cycles=args.cycles,
                                  ops_per_cycle=args.ops,
                                  chaos=not args.no_chaos,
                                  topology_cycle=args.topology_cycle,
                                  snapshots=args.snapshots,
                                  throughput_floors=floors,
                                  device=args.device)
        except SoakFailure as e:
            print(str(e))
            return 1
    if probe is not None:
        probe_report = probe.report()
        confirmed = probe_report["confirmed"]
        print(json.dumps({"race_probe": probe_report}, indent=1))
        if confirmed:
            print(f"RACE PROBE: {len(confirmed)} confirmed unlocked "
                  "cross-role write(s)")
            return 1
    if args.record_baseline:
        Path(args.record_baseline).write_text(json.dumps({
            "seed": seed, "cycles": args.cycles, "ops": args.ops,
            "floors": floors_from_report(report),
        }, indent=1, sort_keys=True) + "\n")
    print(json.dumps(report.to_dict(), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
