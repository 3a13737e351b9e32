"""Device-memory residency ledger: what is in device memory, in bytes, now.

Counterpart of opensearch_tpu/telemetry/device_ledger.py. Every
device-upload path of the port registers its allocations here:

- exact segment columns (``index/device.to_device`` / ``with_live``),
- IVF-PQ slabs (``ops/ivfpq.build``),
- stacked serving bundles (``search/distributed_serving._build_bundle``,
  freed by ``cluster/shard_mesh.ShardMeshRegistry`` evictions),
- padded query/filter-mask batch uploads (transient: allocated and freed
  in the same launch).

Allocations are keyed (index, field, structure kind, generation, device)
with ``bytes`` the summed ``numel() * element_size()`` of the structure's
tensors, and the accounting identity ``resident == allocated - freed``
holds at all times (``verify_identity``). Upload sites that cannot thread
ownership context through their signatures inherit it from the nearest
:func:`upload_scope` (a contextvar, the same pattern as the profiler).

Compile accounting rides along per KERNEL FAMILY: every launch path that
consults the profiler's first-signature oracle
(``search/profile.signature_retraced`` / a program-cache miss) reports the
entry and its first-launch wall here (on the card the first launch of a
hand-written kernel includes its build).

The ledger is process-wide (one process, the scope of the kNN dispatch
batcher and the shard-mesh registry). Its structures may lie on several
devices (a mesh bundle registers one allocation a slot, labelled with the
slot's device), and its bytes can be read per device
(:meth:`DeviceResidencyLedger.resident_bytes` with a device,
:meth:`~DeviceResidencyLedger.device_totals`).

TOUCH ACCOUNTING: every launch that reads a ledger-registered structure
records a :meth:`DeviceResidencyLedger.touch` against its allocations:
touch count, bytes read (computed from the SAME roofline cost model the
launch feeds ``roofline.record_launch``, split across the launch's
structures in proportion to their resident bytes), and a timestamp on the
injectable clock. Per structure the ledger folds touches into HEAT state
(EWMA inter-access gap, recency, a 1-2-5-ladder gap histogram, and a
hot/warm/cold class with ``heat.transition`` span events on class
changes) and appends each access to a bounded ring that the
:meth:`~DeviceResidencyLedger.advise_tiering` what-if advisor replays
against a candidate device-memory budget (LRU-by-bytes, the shard-mesh
registry's exact semantics) to project hit bytes, re-upload traffic and
added latency per structure (promotion cost from the roofline copy
calibration). Heat retires WITH the structure: freeing a group's last
allocation drops its heat row, and transient uploads
(``record_transient``) never enter heat at all.
"""

from __future__ import annotations

import contextvars
import threading
from collections import deque
from contextlib import contextmanager
from typing import Any

from opensearch_tpu_torch.common import timeutil
from opensearch_tpu_torch.common.settings import Property, Setting

# structure kinds the serving tier registers (free-form strings are
# accepted; these are the ones the stats surfaces document)
KIND_COLUMN = "column"            # exact segment columns (+ the live bitmap)
KIND_IVFPQ = "ivfpq_slab"         # packed IVF-PQ inverted lists + codebooks
KIND_MESH_BUNDLE = "mesh_bundle"  # [S, n_flat, d] shard-mesh slabs
KIND_QUERY_BATCH = "query_batch"  # padded per-launch query/mask uploads

# -- heat classification (virtual-clock ms; pure thresholds, no wall reads) --
HEAT_HOT = "hot"
HEAT_WARM = "warm"
HEAT_COLD = "cold"
# hot: re-accessed at a sub-second EWMA cadence and seen recently; cold:
# untouched long enough that demoting it would cost nothing observable
HEAT_HOT_GAP_MS = 1_000
HEAT_WARM_AGE_MS = 30_000
HEAT_COLD_AGE_MS = 300_000
_HEAT_EWMA_DECAY = 0.7
# inter-access-gap histogram ladder (ms, 1-2-5; the last bucket is +inf)
HEAT_GAP_BUCKETS_MS = (1, 2, 5, 10, 20, 50, 100, 200, 500,
                       1_000, 2_000, 5_000, 10_000)
# numeric class encoding for the Prometheus gauge (2 hot / 1 warm / 0 cold)
HEAT_CLASS_VALUE = {HEAT_HOT: 2, HEAT_WARM: 1, HEAT_COLD: 0}

# -- settings (registered dynamic in cluster/cluster_settings.py) -----------

HEAT_ENABLED_SETTING = Setting.bool_setting(
    "telemetry.heat.enabled", True, Property.NODE_SCOPE, Property.DYNAMIC,
)


def _validate_ring(v: int) -> None:
    if v < 16:
        raise ValueError(
            f"telemetry.heat.ring must be >= 16 accesses, got [{v}]")


# bounded access-stream window the tiering advisor replays; resizing keeps
# the newest entries
HEAT_RING_SETTING = Setting(
    "telemetry.heat.ring", 4_096, int,
    Property.NODE_SCOPE, Property.DYNAMIC, validator=_validate_ring,
)

HEAT_SETTINGS = (HEAT_ENABLED_SETTING, HEAT_RING_SETTING)


def classify_heat(age_ms: int, ewma_gap_ms: float, touches: int) -> str:
    """Pure classification from recency + EWMA cadence: deterministic
    under an injected clock: replayed runs classify byte-identically."""
    if age_ms > HEAT_COLD_AGE_MS:
        return HEAT_COLD
    if (touches >= 2 and ewma_gap_ms <= HEAT_HOT_GAP_MS
            and age_ms <= HEAT_WARM_AGE_MS):
        return HEAT_HOT
    return HEAT_WARM


def _gap_bucket(gap_ms: int) -> int:
    for i, le in enumerate(HEAT_GAP_BUCKETS_MS):
        if gap_ms <= le:
            return i
    return len(HEAT_GAP_BUCKETS_MS)


def group_key(alloc: "Allocation") -> tuple:
    """The per-structure heat/grouping key — `structures()`'s grouping
    minus the shard: (index, field, kind, generation, device)."""
    gen = alloc.generation
    return (alloc.index, alloc.field, alloc.kind,
            gen if isinstance(gen, (int, str)) else str(gen), alloc.device)


class _HeatState:
    """Folded access pattern of one resident structure group. The CLASS
    is never stored — readers and the transition detector re-derive it
    from (age, EWMA gap, touches) so it can never go stale as a
    structure cools in place."""

    __slots__ = ("touches", "bytes_read", "first_ms", "last_ms",
                 "ewma_gap_ms", "gap_hist", "transitions")

    def __init__(self, now_ms: int) -> None:
        self.touches = 0
        self.bytes_read = 0
        self.first_ms = now_ms
        self.last_ms = now_ms
        self.ewma_gap_ms = 0.0
        self.gap_hist = [0] * (len(HEAT_GAP_BUCKETS_MS) + 1)
        self.transitions = 0


_scope_var: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "opensearch_tpu_torch_upload_scope", default=None
)


@contextmanager
def upload_scope(index: str | None = None, shard: int | None = None,
                 generation: Any = None, field: str | None = None,
                 device: str | None = None):
    """Attribution context for uploads below this point: ``register`` calls
    that omit index/shard/generation/field/device inherit them from the
    nearest enclosing scope (scopes nest; inner non-None values win). The
    engine opens one around refresh/merge/recovery publishes so
    ``to_device`` / ``ivfpq.build`` need no signature changes."""
    outer = _scope_var.get() or {}
    merged = dict(outer)
    for key, value in (("index", index), ("shard", shard),
                       ("generation", generation), ("field", field),
                       ("device", device)):
        if value is not None:
            merged[key] = value
    token = _scope_var.set(merged)
    try:
        yield
    finally:
        _scope_var.reset(token)


def active_scope() -> dict:
    return dict(_scope_var.get() or {})


def _default_device() -> str:
    """The label of an upload made with no device in its scope: the
    current CUDA device (``cuda:0``), or ``device:0`` where torch sees no
    card (the bytes are still accounted; nothing runs on a label)."""
    import torch

    if torch.cuda.is_available():
        return str(torch.device("cuda", torch.cuda.current_device()))
    return "device:0"


class Allocation:
    """One registered device-resident structure. ``free()`` is idempotent —
    retirement paths (merge, eviction, close, invalidation) may race or
    overlap and double-accounting would break the identity."""

    __slots__ = ("ledger", "alloc_id", "index", "shard", "field", "kind",
                 "generation", "device", "bytes", "freed", "freed_reason")

    def __init__(self, ledger: "DeviceResidencyLedger", alloc_id: int,
                 index: str, shard: int, field: str, kind: str,
                 generation: Any, device: str, nbytes: int):
        self.ledger = ledger
        self.alloc_id = alloc_id
        self.index = index
        self.shard = shard
        self.field = field
        self.kind = kind
        self.generation = generation
        self.device = device
        self.bytes = int(nbytes)
        self.freed = False
        self.freed_reason = None

    def free(self, reason: str = "retired") -> None:
        self.ledger.free(self, reason)

    def row(self) -> dict:
        gen = self.generation
        return {
            "index": self.index, "shard": self.shard, "field": self.field,
            "kind": self.kind,
            "generation": gen if isinstance(gen, (int, str)) else str(gen),
            "device": self.device, "bytes": self.bytes,
        }


class DeviceResidencyLedger:
    """Process-wide accounting of device-resident bytes.

    Invariant (checked by ``verify_identity``):
    ``allocated_bytes - freed_bytes == resident_bytes == sum(live.bytes)``.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next_id = 0
        self._live: dict[int, Allocation] = {}
        self._resident_bytes = 0
        self.counters = {
            "allocations": 0, "frees": 0,
            "allocated_bytes": 0, "freed_bytes": 0,
            "transient_uploads": 0, "transient_bytes": 0,
        }
        # kernel family -> [jit-cache entries, cumulative compile wall ns]
        self._compile: dict[str, list[int]] = {}
        # -- touch accounting --------------------------------------------------
        # heat config cell: read racily by design (the dynamic-settings
        # contract, same as the batcher/registry knobs)
        self.heat_config = {"enabled": True, "ring": 4_096}
        # live allocation groups: group key -> [live count, live bytes] —
        # heat rows may only exist for live groups (retirement drops them)
        self._group_live: dict[tuple, list[int]] = {}
        # group key -> folded heat state (created on first touch)
        self._heat: dict[tuple, _HeatState] = {}
        # bounded access stream the tiering advisor replays:
        # (at_ms, group key, group resident bytes, bytes read)
        self._access_ring: deque = deque(maxlen=self.heat_config["ring"])
        # cumulative — separate from `counters` so the `device` stats
        # section keeps its shape; surfaced in the `heat` section
        self.heat_counters = {
            "touches": 0, "touched_bytes": 0, "transitions": 0,
        }

    # -- producer side -------------------------------------------------------

    def register(self, kind: str, nbytes: int, *, index: str | None = None,
                 shard: int | None = None, field: str | None = None,
                 generation: Any = None,
                 device: str | None = None) -> Allocation:
        """Account a device-resident structure of ``nbytes`` (the summed
        ``.nbytes`` of its live arrays). Missing attribution falls back to
        the active :func:`upload_scope`, then to placeholders — bytes are
        never dropped for want of a label."""
        scope = _scope_var.get() or {}
        with self._lock:
            self._next_id += 1
            alloc = Allocation(
                self, self._next_id,
                index=index if index is not None
                else scope.get("index", "_unattributed"),
                shard=shard if shard is not None else scope.get("shard", 0),
                field=field if field is not None
                else scope.get("field", "_none"),
                kind=kind,
                generation=generation if generation is not None
                else scope.get("generation", 0),
                device=device if device is not None
                else scope.get("device") or _default_device(),
                nbytes=nbytes,
            )
            self._live[alloc.alloc_id] = alloc
            self.counters["allocations"] += 1
            self.counters["allocated_bytes"] += alloc.bytes
            self._resident_bytes += alloc.bytes
            cell = self._group_live.setdefault(group_key(alloc), [0, 0])
            cell[0] += 1
            cell[1] += alloc.bytes
        return alloc

    def free(self, allocation: Allocation, reason: str = "retired") -> None:
        with self._lock:
            if allocation.freed:
                return
            allocation.freed = True
            allocation.freed_reason = reason
            self._live.pop(allocation.alloc_id, None)
            self.counters["frees"] += 1
            self.counters["freed_bytes"] += allocation.bytes
            self._resident_bytes -= allocation.bytes
            # heat retires WITH the structure: the group's last free drops
            # its heat row, so a rebuild/eviction leaves no ghost heat
            key = group_key(allocation)
            cell = self._group_live.get(key)
            if cell is not None:
                cell[0] -= 1
                cell[1] -= allocation.bytes
                if cell[0] <= 0:
                    del self._group_live[key]
                    self._heat.pop(key, None)

    def record_transient(self, kind: str, nbytes: int) -> None:
        """A per-launch upload (padded query batch, filter mask) that the
        launch consumes and releases: allocated and freed in one step, so
        the identity holds while the cumulative counters still show the
        host->device traffic these paths generate."""
        nbytes = int(nbytes)
        with self._lock:
            self.counters["transient_uploads"] += 1
            self.counters["transient_bytes"] += nbytes
            self.counters["allocated_bytes"] += nbytes
            self.counters["freed_bytes"] += nbytes

    def record_compile(self, family: str, wall_ns: int = 0) -> None:
        """One jit-cache entry for ``family`` (the profiler's retrace
        oracle fired): count it and bank the first-launch wall, which
        includes the compile."""
        with self._lock:
            cell = self._compile.setdefault(family, [0, 0])
            cell[0] += 1
            cell[1] += int(wall_ns)

    # -- touch accounting -----------------------------------------------------

    def configure_heat(self, *, enabled: bool | None = None,
                       ring: int | None = None) -> None:
        if enabled is not None:
            self.heat_config["enabled"] = bool(enabled)
        if ring is not None and int(ring) != self.heat_config["ring"]:
            with self._lock:
                self.heat_config["ring"] = int(ring)
                # keep the NEWEST entries on shrink (they are what the
                # advisor should replay)
                self._access_ring = deque(self._access_ring,
                                          maxlen=int(ring))

    def apply_heat_settings(self, flat: dict) -> None:
        """Pick the heat keys out of a flat effective-settings map (the
        cluster-settings update consumer — the mesh registry's adapter
        shape)."""
        from opensearch_tpu_torch.common.settings import Settings

        s = Settings.from_flat({
            st.key: flat[st.key] for st in HEAT_SETTINGS if st.key in flat
        })
        self.configure_heat(enabled=HEAT_ENABLED_SETTING.get(s),
                            ring=HEAT_RING_SETTING.get(s))

    def touch(self, allocations: list, *, family: str | None = None,
              params: dict | None = None, nbytes: int | None = None,
              at_ms: int | None = None) -> None:
        """Record one launch's read of the given ledger-registered
        structures. ``nbytes`` is the launch's modeled HBM traffic; when
        omitted it comes from the roofline cost model for ``family`` with
        ``params`` (the SAME model the launch feeds ``record_launch``, so
        touched-bytes agrees with modeled traffic by construction), and
        failing that from the structures' resident bytes (one full pass).
        The bytes split across the structures proportional to their
        resident size; each structure counts one touch. Timestamps ride
        the injectable clock, so replayed runs are byte-identical."""
        if not self.heat_config["enabled"]:
            return
        allocs = [a for a in allocations if a is not None and not a.freed]
        if not allocs:
            return
        if nbytes is None and family is not None and params is not None:
            from opensearch_tpu_torch.telemetry.roofline import (
                COST_MODELS,
                base_family,
            )

            model = COST_MODELS.get(base_family(family))
            if model is not None:
                _flops, nbytes = model(params)
        if nbytes is None:
            nbytes = sum(a.bytes for a in allocs)
        nbytes = max(0, int(nbytes))
        weights = [a.bytes for a in allocs]
        total_w = sum(weights)
        if total_w <= 0:
            weights = [1] * len(allocs)
            total_w = len(allocs)
        shares = [nbytes * w // total_w for w in weights]
        shares[0] += nbytes - sum(shares)  # exact: Σ shares == nbytes
        now = at_ms if at_ms is not None else timeutil.epoch_millis()
        transitions: list[tuple[tuple, str, str]] = []
        with self._lock:
            for alloc, share in zip(allocs, shares):
                if alloc.freed:  # raced a retirement path
                    continue
                key = group_key(alloc)
                cell = self._group_live.get(key)
                if cell is None:  # freed between the filter and the lock
                    continue
                hs = self._heat.get(key)
                if hs is None:
                    hs = self._heat[key] = _HeatState(now)
                    # a first touch classifies WARM by construction
                    # (touches=1 has no cadence), so no transition fires
                    prev_cls = HEAT_WARM
                else:
                    # class the structure had AGED to before this touch
                    # (a long-idle structure may have gone cold in place)
                    prev_cls = classify_heat(
                        max(0, now - hs.last_ms), hs.ewma_gap_ms,
                        hs.touches)
                    gap = max(0, now - hs.last_ms)
                    hs.gap_hist[_gap_bucket(gap)] += 1
                    if hs.touches == 1:
                        hs.ewma_gap_ms = float(gap)
                    else:
                        hs.ewma_gap_ms = (
                            _HEAT_EWMA_DECAY * hs.ewma_gap_ms
                            + (1 - _HEAT_EWMA_DECAY) * gap)
                hs.touches += 1
                hs.bytes_read += share
                hs.last_ms = now
                new_cls = classify_heat(0, hs.ewma_gap_ms, hs.touches)
                if new_cls != prev_cls:
                    hs.transitions += 1
                    self.heat_counters["transitions"] += 1
                    transitions.append((key, prev_cls, new_cls))
                self.heat_counters["touches"] += 1
                self.heat_counters["touched_bytes"] += share
                self._access_ring.append((now, key, cell[1], share))
        if transitions:
            # class transitions ride the triggering request's trace as
            # span EVENTS (no-op outside a span) — emitted OUTSIDE the
            # ledger lock, like the mesh registry's evict events
            from opensearch_tpu_torch.telemetry.tracing import add_span_event

            for key, old_cls, new_cls in transitions:
                add_span_event("heat.transition", {
                    "index": key[0], "field": key[1], "kind": key[2],
                    "from": old_cls, "to": new_cls,
                })

    def heat_rows(self, index: str | None = None) -> list[dict]:
        """Per-structure heat rows (live structures only — heat retires
        with its group's last allocation). Classification re-derives from
        the CURRENT age, so a structure cools in place without needing a
        touch to notice."""
        now = timeutil.epoch_millis()
        rows: list[dict] = []
        with self._lock:
            for key, hs in self._heat.items():
                if index is not None and key[0] != index:
                    continue
                cell = self._group_live.get(key) or [0, 0]
                age = max(0, now - hs.last_ms)
                hist = {str(le): n for le, n in
                        zip(HEAT_GAP_BUCKETS_MS, hs.gap_hist)}
                hist["+inf"] = hs.gap_hist[-1]
                rows.append({
                    "index": key[0], "field": key[1], "kind": key[2],
                    "generation": key[3], "device": key[4],
                    "bytes": cell[1],
                    "touches": hs.touches,
                    "bytes_read": hs.bytes_read,
                    "last_touch_ms": hs.last_ms,
                    "age_ms": age,
                    "ewma_gap_ms": round(hs.ewma_gap_ms, 3),
                    "gap_histogram": hist,
                    "class": classify_heat(age, hs.ewma_gap_ms,
                                           hs.touches),
                    "transitions": hs.transitions,
                })
        return sorted(rows, key=lambda r: (r["index"], r["field"],
                                           r["kind"], str(r["generation"])))

    def heat_group_keys(self) -> list[tuple]:
        with self._lock:
            return list(self._heat)

    def live_group_keys(self) -> list[tuple]:
        with self._lock:
            return list(self._group_live)

    def heat_stats(self) -> dict:
        """The `_nodes/stats` `heat` section: per-structure rows, class
        census, cumulative touch counters, and the advisor window state."""
        rows = self.heat_rows()
        classes = {HEAT_HOT: 0, HEAT_WARM: 0, HEAT_COLD: 0}
        for row in rows:
            classes[row["class"]] += 1
        with self._lock:
            counters = dict(self.heat_counters)
            ring = {"size": len(self._access_ring),
                    "capacity": self.heat_config["ring"]}
        return {
            "enabled": self.heat_config["enabled"],
            "rows": rows,
            "classes": classes,
            "counters": counters,
            "ring": ring,
        }

    def heat_summary(self, key: tuple) -> dict | None:
        """Compact heat fields for a structure group (the `"profile":
        true` device rows), or None when the group was never touched."""
        now = timeutil.epoch_millis()
        with self._lock:
            hs = self._heat.get(key)
            if hs is None:
                return None
            age = max(0, now - hs.last_ms)
            return {
                "touches": hs.touches,
                "bytes_read": hs.bytes_read,
                "age_ms": age,
                "ewma_gap_ms": round(hs.ewma_gap_ms, 3),
                "class": classify_heat(age, hs.ewma_gap_ms, hs.touches),
            }

    def advise_tiering(self, hbm_budget_bytes: int,
                       memcpy_bytes_per_s: float | None = None) -> dict:
        """What-if tiering advisor: replay the recorded access stream
        against an HBM tier of ``hbm_budget_bytes`` with the shard-mesh
        registry's exact LRU-by-bytes semantics (hits re-insert at the
        warm end; misses evict from the cold end until the incoming
        structure fits; a structure larger than the whole budget is still
        admitted; budget 0 = unbounded), and report per structure the
        projected hit bytes, re-upload traffic, and the added latency of
        promoting it back — re-upload bytes over the calibrated memcpy
        bandwidth (the roofline peak table). Pure function of the ring +
        budget + bandwidth: two replays of one recorded stream are
        byte-identical."""
        if memcpy_bytes_per_s is None:
            from opensearch_tpu_torch.telemetry.roofline import ensure_peaks

            memcpy_bytes_per_s = ensure_peaks().bytes_per_s
        memcpy_bytes_per_s = max(float(memcpy_bytes_per_s), 1.0)
        budget = max(0, int(hbm_budget_bytes))
        with self._lock:
            stream = list(self._access_ring)
        resident: dict[tuple, int] = {}  # insertion order == LRU order
        resident_total = 0
        rows: dict[tuple, dict] = {}
        for at_ms, key, sbytes, rbytes in stream:
            row = rows.get(key)
            if row is None:
                row = rows[key] = {
                    "accesses": 0, "hits": 0, "misses": 0,
                    "hit_bytes": 0, "read_bytes": 0, "reupload_bytes": 0,
                }
            row["accesses"] += 1
            row["read_bytes"] += rbytes
            row["bytes"] = sbytes
            if key in resident:
                row["hits"] += 1
                row["hit_bytes"] += rbytes
                resident_total += sbytes - resident.pop(key)  # LRU touch
                resident[key] = sbytes
            else:
                row["misses"] += 1
                row["reupload_bytes"] += sbytes
                if budget > 0:
                    while resident and resident_total + sbytes > budget:
                        cold = next(iter(resident))
                        resident_total -= resident.pop(cold)
                resident[key] = sbytes
                resident_total += sbytes
        totals = {"accesses": 0, "hits": 0, "misses": 0, "hit_bytes": 0,
                  "reupload_bytes": 0, "added_latency_ms": 0.0}
        structures: list[dict] = []
        for key, row in rows.items():
            added_ms = round(
                row["reupload_bytes"] / memcpy_bytes_per_s * 1e3, 3)
            if row["accesses"] <= 1:
                tier = "evicted"       # no observed reuse: nothing lost
            elif key in resident:
                tier = "hbm"           # survived the replay resident
            else:
                tier = "host_ram"      # reused but churns: stage close by
            structures.append({
                "index": key[0], "field": key[1], "kind": key[2],
                "generation": key[3], "device": key[4],
                **row, "added_latency_ms": added_ms, "tier": tier,
            })
            for name in ("accesses", "hits", "misses", "hit_bytes",
                         "reupload_bytes"):
                totals[name] += row[name]
            totals["added_latency_ms"] = round(
                totals["added_latency_ms"] + added_ms, 3)
        structures.sort(key=lambda r: (-r["hit_bytes"], r["index"],
                                       r["field"], r["kind"],
                                       str(r["generation"]), r["device"]))
        return {
            "hbm_budget_bytes": budget,
            "memcpy_bytes_per_s": memcpy_bytes_per_s,
            "window": {"accesses": len(stream),
                       "capacity": self.heat_config["ring"],
                       "from_ms": stream[0][0] if stream else None,
                       "to_ms": stream[-1][0] if stream else None},
            "projected": totals,
            "structures": structures,
        }

    # -- introspection -------------------------------------------------------

    def resident_bytes(self, device: Any = None) -> int:
        """The resident bytes, of every device or of one (a device label
        such as ``"cuda:1"``, or a ``torch.device``)."""
        with self._lock:
            if device is None:
                return self._resident_bytes
            label = str(device)
            return sum(a.bytes for a in self._live.values()
                       if a.device == label)

    def current_id(self) -> int:
        """High-water allocation id: a leak check scoped to 'allocations
        made after this point' starts here."""
        with self._lock:
            return self._next_id

    def live_allocations(self) -> list[Allocation]:
        with self._lock:
            return list(self._live.values())

    def structures(self, index: str | None = None,
                   with_heat: bool = False) -> list[dict]:
        """Per-structure rows grouped by (index, field, kind, generation,
        device): what is resident, in bytes, structure by structure. With
        ``with_heat`` each touched structure's row carries its compact
        heat summary (the ``"profile": true`` device rows)."""
        with self._lock:
            grouped: dict[tuple, dict] = {}
            for alloc in self._live.values():
                if index is not None and alloc.index != index:
                    continue
                row = alloc.row()
                key = (row["index"], row["field"], row["kind"],
                       row["generation"], row["device"])
                cell = grouped.get(key)
                if cell is None:
                    cell = grouped[key] = {**row, "allocations": 0,
                                           "bytes": 0}
                    del cell["shard"]
                cell["bytes"] += row["bytes"]
                cell["allocations"] += 1
        if with_heat:
            for key, cell in grouped.items():
                heat = self.heat_summary(key)
                if heat is not None:
                    cell["heat"] = heat
        return sorted(grouped.values(),
                      key=lambda r: (r["index"], r["field"], r["kind"],
                                     str(r["generation"])))

    def device_totals(self) -> dict[str, int]:
        with self._lock:
            out: dict[str, int] = {}
            for alloc in self._live.values():
                out[alloc.device] = out.get(alloc.device, 0) + alloc.bytes
        return out

    def compile_stats(self) -> dict[str, dict]:
        with self._lock:
            return {
                family: {"entries": cell[0], "compile_wall_ns": cell[1]}
                for family, cell in sorted(self._compile.items())
            }

    def verify_identity(self) -> None:
        """Raises AssertionError unless resident == allocated − freed ==
        sum of live allocation bytes (check.sh / bench gates call this)."""
        with self._lock:
            live_sum = sum(a.bytes for a in self._live.values())
            delta = (self.counters["allocated_bytes"]
                     - self.counters["freed_bytes"])
            resident = self._resident_bytes
        assert resident == delta == live_sum, (
            f"device ledger identity broken: resident={resident} "
            f"allocated-freed={delta} live_sum={live_sum}")

    def snapshot_stats(self) -> dict:
        with self._lock:
            live_sum = sum(a.bytes for a in self._live.values())
            out = {
                **self.counters,
                "resident_bytes": self._resident_bytes,
                "live_allocations": len(self._live),
                "identity_ok": (
                    self._resident_bytes == live_sum
                    == self.counters["allocated_bytes"]
                    - self.counters["freed_bytes"]),
            }
        out["by_device"] = self.device_totals()
        out["structures"] = self.structures()
        out["compile"] = self.compile_stats()
        return out

    def reset(self) -> None:
        """Test hook: forget everything (callers must own no live
        structures — production code never resets the ledger)."""
        with self._lock:
            self._live.clear()
            self._resident_bytes = 0
            for k in self.counters:
                self.counters[k] = 0
            self._compile.clear()
            self._group_live.clear()
            self._heat.clear()
            self._access_ring.clear()
            for k in self.heat_counters:
                self.heat_counters[k] = 0


# process-wide default: upload sites are module-level code with no node
# handle (the batcher/registry pattern); one ledger a process.
default_ledger = DeviceResidencyLedger()


def array_nbytes(*arrays: Any) -> int:
    """Summed bytes over tensors (``numel() * element_size()``) and numpy
    arrays (``nbytes``), skipping Nones (device dataclasses carry optional
    columns)."""
    total = 0
    for a in arrays:
        if a is None:
            continue
        if hasattr(a, "element_size"):
            total += int(a.numel()) * int(a.element_size())
        else:
            total += int(a.nbytes)
    return total


def stats_section() -> dict:
    """The `_nodes/stats` `device` section: the process-wide ledger
    snapshot plus the shard-mesh registry's byte-budget state, ONE
    assembly for every stats surface (`_nodes/stats`, and the resident
    bytes `_prometheus/metrics` reads from the same ledger)."""
    from opensearch_tpu_torch.cluster.shard_mesh import default_registry

    out = default_ledger.snapshot_stats()
    out["shard_mesh"] = default_registry.snapshot_stats()
    return out


def heat_section() -> dict:
    """The `_nodes/stats` `heat` section, ONE assembly for every stats
    surface (the `device` section precedent)."""
    return default_ledger.heat_stats()
