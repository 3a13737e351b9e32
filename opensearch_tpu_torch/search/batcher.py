"""Adaptive cross-request micro-batching for kNN dispatch.

Counterpart of opensearch_tpu/search/batcher.py. The per-shard dispatch
sites (search/executor.shard_knn_selection: the fused exact, streaming,
materializing and IVF-PQ scans) route each query through :func:`dispatch`
with a BATCH KEY, the identity of the launch they would have made: kernel
kind, device-column identity, reader GENERATION, k bucket, similarity and
the scan's policy and precision. Concurrent queries with the same key
coalesce into one padded batch launch; per-query rows scatter back to the
waiting requests. Because the key carries the snapshot generation (and, for
IVF-PQ, the index-build generation), a refresh or a rebuild mid-flight is a
different key, a different bucket and a different launch: a query is never
merged into a batch against the wrong snapshot. ``key=None`` (a query whose
valid mask is its own) runs solo.

Flush policy:
 - size: a bucket reaching ``max_batch_size`` flushes at once;
 - deadline: otherwise the earliest-queued entry flushes the bucket after
   its wait window (timeutil clock, so virtual-clock runs cannot hang);
 - solo fast path: when the key family's recent flushes show no
   concurrency and no launch for the key is in flight, an arrival launches
   at once; while a launch is in flight arrivals queue, and the completing
   leader flags the backlog for immediate flush (continuous batching).

The wait window is tuned per key family (:class:`_KeyTuner`, fed by the
generation-free ``tune_key``): solo traffic converges to no wait, bursty
families earn up to ``max_wait_ms``. Cross-k coalescing (``alt_keys``): an
arrival may ride a forming batch of a larger k bucket of the same family,
whose rows it truncates; it never opens one. The pending queue is bounded
(index/pressure.QueuePressure): past the bound a request is shed with
RejectedExecutionException (HTTP 429).

Each outcome carries the launch's wall time (fenced by the launch's copy
of its results to the host) and whether it was the first launch under its
signature, for the profiler (search/profile.py): a launch closure returns
its per-payload results, or (results, retraced) as the reference's do. The
active priority lane (search/lanes.py) widens the window of a background
entry, as in the reference.

Left out until telemetry and the settings path are ported: the
residency-ledger compile accounting and the tracing span events of a
flush, the metrics registry, ``apply_settings``, and the cross-shard
counters (no mesh-wide launch dispatches through the batcher yet).

Settings (the defaults of ``configure``):
  search.knn.batch.max_wait_ms     flush deadline ceiling (default 2ms)
  search.knn.batch.max_batch_size  flush size bound  (default 32)
  search.knn.batch.max_queue       pending-query bound (default 1024)
  search.knn.batch.enabled         kill switch         (default true)
  search.knn.batch.auto_tune       per-key wait tuner  (default true)
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Sequence

from opensearch_tpu_torch.common import timeutil
from opensearch_tpu_torch.common.settings import Property, Setting, Settings
from opensearch_tpu_torch.index.pressure import QueuePressure

MAX_WAIT_MS_SETTING = Setting.time_setting(
    "search.knn.batch.max_wait_ms", 2,
    Property.NODE_SCOPE, Property.DYNAMIC,
)
MAX_BATCH_SIZE_SETTING = Setting.int_setting(
    "search.knn.batch.max_batch_size", 32,
    Property.NODE_SCOPE, Property.DYNAMIC, min_value=1,
)
MAX_QUEUE_SETTING = Setting.int_setting(
    "search.knn.batch.max_queue", 1024,
    Property.NODE_SCOPE, Property.DYNAMIC, min_value=0,
)
ENABLED_SETTING = Setting.bool_setting(
    "search.knn.batch.enabled", True,
    Property.NODE_SCOPE, Property.DYNAMIC,
)
AUTO_TUNE_SETTING = Setting.bool_setting(
    "search.knn.batch.auto_tune", True,
    Property.NODE_SCOPE, Property.DYNAMIC,
)

# EWMA of merged batch sizes at/below this -> no recent concurrency ->
# skip the wait window for idle-device arrivals
_SOLO_EWMA_THRESHOLD = 1.25
_EWMA_DECAY = 0.7
# background-lane entries accept this multiple of the configured wait:
# they are throughput traffic, and a longer window earns bigger merges;
# interactive entries in the same bucket still flush it at THEIR deadline
_BACKGROUND_WAIT_FACTOR = 4
# per-key tuner table bound (LRU)
_MAX_TUNERS = 256


class _KeyTuner:
    """Per-key-family wait controller, fed (under the batcher lock) by
    every arrival and every flush; read at dispatch time to derive the
    entry's wait window from the family's measured merge factor, queue
    waits and arrival gaps."""

    __slots__ = ("ewma_merged", "ewma_wait_ms", "ewma_gap_ms", "flushes",
                 "last_arrival_ms")

    def __init__(self) -> None:
        # optimistic start: assume concurrency until flushes prove
        # otherwise, so a key's first burst coalesces
        self.ewma_merged = 2.0 * _SOLO_EWMA_THRESHOLD
        self.ewma_wait_ms = 0.0
        self.ewma_gap_ms: float | None = None
        self.flushes = 0
        self.last_arrival_ms: int | None = None

    def note_arrival(self, now_ms: int) -> None:
        if self.last_arrival_ms is not None:
            gap = max(0, now_ms - self.last_arrival_ms)
            self.ewma_gap_ms = (
                gap if self.ewma_gap_ms is None
                else _EWMA_DECAY * self.ewma_gap_ms + (1 - _EWMA_DECAY) * gap)
        self.last_arrival_ms = now_ms

    def note_flush(self, merged: int, max_wait_ms: int) -> None:
        self.ewma_merged = (_EWMA_DECAY * self.ewma_merged
                            + (1 - _EWMA_DECAY) * merged)
        self.ewma_wait_ms = (_EWMA_DECAY * self.ewma_wait_ms
                             + (1 - _EWMA_DECAY) * max_wait_ms)
        self.flushes += 1

    @property
    def solo(self) -> bool:
        return self.ewma_merged <= _SOLO_EWMA_THRESHOLD

    def effective_wait(self, ceiling_ms: int) -> int:
        """0 for solo traffic; for concurrent traffic, scaled toward the
        ceiling by the observed merge factor, capped at the measured wait
        the family's batches needed, and floored at the observed
        inter-arrival gap (waiting less than one gap never coalesces)."""
        if ceiling_ms <= 0 or self.solo:
            return 0
        frac = min(1.0, self.ewma_merged - 1.0)
        wait = max(1, round(ceiling_ms * frac))
        if self.flushes >= 4:
            wait = min(wait, max(1, round(self.ewma_wait_ms) + 1))
        if self.ewma_gap_ms is not None and self.ewma_gap_ms < ceiling_ms:
            wait = max(wait, min(ceiling_ms, int(self.ewma_gap_ms) + 1))
        return min(wait, ceiling_ms)

    def snapshot(self) -> dict:
        return {
            "ewma_merged": round(self.ewma_merged, 3),
            "ewma_wait_ms": round(self.ewma_wait_ms, 3),
            "ewma_gap_ms": (round(self.ewma_gap_ms, 3)
                            if self.ewma_gap_ms is not None else None),
            "flushes": self.flushes,
        }


class _Entry:
    __slots__ = ("payload", "enq_ms", "taken", "done", "result", "error",
                 "batch_size", "wait_ms", "launch", "rank", "tune_key",
                 "wall_ns", "retraced")

    def __init__(self, payload: Any, enq_ms: int, launch=None, rank: int = 0,
                 tune_key: Any = None):
        self.payload = payload
        self.enq_ms = enq_ms
        self.taken = False
        self.done = False
        self.result: Any = None
        self.error: BaseException | None = None
        self.batch_size = 1
        self.wait_ms = 0
        self.wall_ns = 0
        self.retraced = False
        # the entry's own launch closure and its k-bucket rank: a batch is
        # launched by the closure of its largest-rank member, so a smaller-k
        # joiner can ride a bigger-k launch but never shrink one
        self.launch = launch
        self.rank = rank
        self.tune_key = tune_key


class _Bucket:
    __slots__ = ("entries", "flush_now")

    def __init__(self) -> None:
        self.entries: list[_Entry] = []
        # set by a completing leader: the backlog that queued while the
        # device was busy flushes at once
        self.flush_now = False


class DispatchOutcome:
    """What one query learns about the launch that served it."""

    __slots__ = ("value", "merged", "wall_ns", "retraced", "wait_ms")

    def __init__(self, value: Any, merged: int, wall_ns: int,
                 retraced: bool, wait_ms: int):
        self.value = value
        self.merged = merged          # live queries in the batch
        self.wall_ns = wall_ns        # fenced wall of the whole launch
        self.retraced = retraced
        self.wait_ms = wait_ms        # time this query spent queued

    @property
    def kernel_share_ns(self) -> int:
        """This query's share of the fenced kernel time (profiler entry)."""
        return self.wall_ns // max(self.merged, 1)


def _launch_timed(launch, payloads: list) -> tuple[list, bool, int]:
    """(per-payload results, retraced, wall ns) of one launch: a closure
    returns its results, or (results, retraced)."""
    t0 = time.perf_counter_ns()
    out = launch(payloads)
    wall_ns = time.perf_counter_ns() - t0
    if isinstance(out, tuple):
        results, retraced = out
        return results, bool(retraced), wall_ns
    return out, False, wall_ns


class KnnDispatchBatcher:
    """Per-process scheduler coalescing concurrent same-key kNN dispatches."""

    # tuner rows surfaced in stats (the busiest few)
    _STATS_TUNER_ROWS = 16

    def __init__(self, *, max_batch_size: int | None = None,
                 max_wait_ms: int | None = None,
                 max_queue: int | None = None,
                 enabled: bool | None = None,
                 auto_tune: bool | None = None):
        self.max_batch_size = (max_batch_size if max_batch_size is not None
                               else MAX_BATCH_SIZE_SETTING.default(Settings.EMPTY))
        self.max_wait_ms = (max_wait_ms if max_wait_ms is not None
                            else MAX_WAIT_MS_SETTING.default(Settings.EMPTY))
        self.enabled = (enabled if enabled is not None
                        else ENABLED_SETTING.default(Settings.EMPTY))
        self.auto_tune = (auto_tune if auto_tune is not None
                          else AUTO_TUNE_SETTING.default(Settings.EMPTY))
        limit = (max_queue if max_queue is not None
                 else MAX_QUEUE_SETTING.default(Settings.EMPTY))
        self.pressure = QueuePressure(limit, operation="knn batch dispatch")
        self._cond = threading.Condition()
        self._buckets: dict[Any, _Bucket] = {}
        self._in_flight: dict[Any, int] = {}
        self._tuners: dict[Any, _KeyTuner] = {}
        self._ewma = 2.0 * _SOLO_EWMA_THRESHOLD
        self.stats = {
            "dispatches": 0,        # launches
            "merged_queries": 0,    # queries served by those launches
            "coalesced_batches": 0,  # launches with more than one query
            "max_batch": 0,
            "solo_fast_path": 0,    # adaptive immediate launches
            "rejections": 0,        # queue-bound sheds (429)
            "ann_dispatches": 0,
            "exact_dispatches": 0,
            # queries served from a larger k bucket's forming batch
            "cross_k_served": 0,
        }

    # -- config ------------------------------------------------------------

    def configure(self, *, max_batch_size: int | None = None,
                  max_wait_ms: int | None = None,
                  max_queue: int | None = None,
                  enabled: bool | None = None,
                  auto_tune: bool | None = None) -> None:
        # plain atomic assignments read racily by design: a dispatch that
        # read the old value completes under the old policy
        if max_batch_size is not None:
            self.max_batch_size = max(1, int(max_batch_size))
        if max_wait_ms is not None:
            self.max_wait_ms = int(max_wait_ms)
        if enabled is not None:
            self.enabled = bool(enabled)
        if auto_tune is not None:
            self.auto_tune = bool(auto_tune)
        if max_queue is not None:
            self.pressure.set_limit(max_queue)
        with self._cond:
            self._cond.notify_all()

    def snapshot_stats(self) -> dict:
        with self._cond:
            out = dict(self.stats)
            out["mean_merged_batch"] = (
                out["merged_queries"] / out["dispatches"]
                if out["dispatches"] else 0.0
            )
            out["ewma_batch"] = round(self._ewma, 3)
            busiest = sorted(self._tuners.items(),
                             key=lambda kv: -kv[1].flushes)
            out["auto_tune"] = {
                "enabled": self.auto_tune,
                "tuned_keys": len(self._tuners),
                "keys": {
                    str(tk): {
                        **tuner.snapshot(),
                        "effective_wait_ms": tuner.effective_wait(
                            self.max_wait_ms),
                    }
                    for tk, tuner in busiest[: self._STATS_TUNER_ROWS]
                },
            }
        out["queue"] = self.pressure.stats()
        out["rejections"] = out["queue"]["rejections"]
        out["enabled"] = self.enabled
        out["max_batch_size"] = self.max_batch_size
        out["max_wait_ms"] = self.max_wait_ms
        from opensearch_tpu_torch.search import ann as ann_mod

        out["ann"] = ann_mod.default_config.snapshot()
        return out

    def reset(self) -> None:
        """Forget adaptive state and counters (never pending entries:
        callers must be idle)."""
        for k in self.stats:
            self.stats[k] = 0
        self._ewma = 2.0 * _SOLO_EWMA_THRESHOLD
        self._tuners.clear()
        self.pressure.rejections = 0
        self.pressure.total = 0

    # -- dispatch ----------------------------------------------------------

    def dispatch(self, key: Any, payload: Any,
                 launch: Callable[[Sequence[Any]], list], *,
                 kind: str = "exact", rank: int = 0,
                 alt_keys: Sequence[Any] = (),
                 tune_key: Any = None) -> DispatchOutcome:
        """Run `payload` through the batch identified by `key`.

        `launch(payloads)` performs ONE launch for the whole batch (padding
        the width as it sees fit) and returns the per-payload results, or
        (results, retraced).
        Every payload sharing a key MUST be servable by any member's launch
        closure: the key is the caller's promise that the kernel and its
        device-resident arguments are identical. key=None means "not
        mergeable": the launch runs solo, still counted in the stats.

        `kind` ("exact" | "ann") splits the dispatch counters. `alt_keys`
        are larger-k-bucket variants of `key`, nearest first, that this
        request may ride if one already has a batch forming; `rank` orders
        the k buckets, and a batch launches with its largest-rank member's
        closure. `tune_key` names the generation-free key family of the
        wait tuner (defaults to `key`). The active priority lane
        (search/lanes.py) widens the window for background entries."""
        if key is None or not self.enabled or self.max_batch_size <= 1:
            return self._solo(payload, launch, kind)
        from opensearch_tpu_torch.search import lanes as lanes_mod

        # the lanes kill switch governs the wait widening too
        background = (lanes_mod.default_config.enabled
                      and lanes_mod.active_lane() == lanes_mod.BACKGROUND)
        if tune_key is None:
            tune_key = key
        with self._cond:
            self.pressure.acquire()
            entry = _Entry(payload, timeutil.monotonic_millis(),
                           launch=launch, rank=rank, tune_key=tune_key)
            tuner = None
            if self.auto_tune:
                tuner = self._tuner_locked(tune_key)
                tuner.note_arrival(entry.enq_ms)
                eff_wait = tuner.effective_wait(self.max_wait_ms)
            else:
                eff_wait = self.max_wait_ms
            if background:
                # never BELOW the configured ceiling, so a tuned-down
                # interactive window does not shrink it
                eff_wait = max(self.max_wait_ms, eff_wait) \
                    * _BACKGROUND_WAIT_FACTOR
            deadline = entry.enq_ms + max(eff_wait, 0)
            for alt in alt_keys:
                alt_bucket = self._buckets.get(alt)
                if (alt_bucket is not None and alt_bucket.entries
                        and len(alt_bucket.entries) < self.max_batch_size):
                    # ride the bigger-k batch already forming; never create
                    # a bigger-k bucket for a smaller-k request
                    key = alt
                    self.stats["cross_k_served"] += 1
                    break
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = self._buckets[key] = _Bucket()
            bucket.entries.append(entry)
            solo_now = (tuner.solo if tuner is not None
                        else self._ewma <= _SOLO_EWMA_THRESHOLD)
            if len(bucket.entries) >= self.max_batch_size:
                batch = self._take_locked(key)
            elif self.max_wait_ms <= 0 or (
                self._in_flight.get(key, 0) == 0 and solo_now
            ):
                if len(bucket.entries) == 1:
                    self.stats["solo_fast_path"] += 1
                batch = self._take_locked(key)
            else:
                batch = None
        while True:
            if batch is not None:
                out = self._run_batch(key, batch, own=entry, kind=kind)
                if out is not None:
                    return out
                # we led a batch that did not include our own entry (the
                # size bound shrank under us): keep waiting for ours
                batch = None
                continue
            batch = self._await_or_lead(key, entry, deadline)
            if batch is None:
                # another leader served us
                if entry.error is not None:
                    raise entry.error
                return DispatchOutcome(entry.result, entry.batch_size,
                                       entry.wall_ns, entry.retraced,
                                       entry.wait_ms)

    # -- internals ---------------------------------------------------------

    def _solo(self, payload: Any, launch, kind: str) -> DispatchOutcome:
        results, retraced, wall_ns = _launch_timed(launch, [payload])
        self._record_launch(1, kind)
        return DispatchOutcome(results[0], 1, wall_ns, retraced, 0)

    def _tuner_locked(self, tune_key: Any) -> _KeyTuner:
        """The key family's controller (caller holds the lock); LRU touch
        and bound so abandoned families age out."""
        tuner = self._tuners.pop(tune_key, None)
        if tuner is None:
            tuner = _KeyTuner()
        self._tuners[tune_key] = tuner
        while len(self._tuners) > _MAX_TUNERS:
            self._tuners.pop(next(iter(self._tuners)))
        return tuner

    def _take_locked(self, key: Any) -> list[_Entry]:
        """Detach the key's pending entries (<= max_batch_size of them) as
        one batch; the caller holds the lock and becomes the leader."""
        bucket = self._buckets.get(key)
        assert bucket is not None and bucket.entries
        batch = bucket.entries[: self.max_batch_size]
        rest = bucket.entries[self.max_batch_size:]
        if rest:
            bucket.entries = rest
        else:
            del self._buckets[key]
        now = timeutil.monotonic_millis()
        for e in batch:
            e.taken = True
            e.wait_ms = max(0, now - e.enq_ms)
        self.pressure.release(len(batch))
        self._in_flight[key] = self._in_flight.get(key, 0) + 1
        return batch

    def _await_or_lead(self, key: Any, entry: _Entry,
                       deadline: int) -> list[_Entry] | None:
        """Wait until the entry is served, or its bucket qualifies for a
        flush it can lead. Returns the batch to lead, or None if done."""
        with self._cond:
            while True:
                if entry.done:
                    return None
                if entry.taken:
                    # a leader is running our batch; the 100ms timeout is a
                    # liveness backstop, completion notifies at once
                    self._cond.wait(0.1)
                    continue
                bucket = self._buckets.get(key)
                now = timeutil.monotonic_millis()
                if bucket is not None and (
                        len(bucket.entries) >= self.max_batch_size
                        or bucket.flush_now):
                    return self._take_locked(key)
                if now >= deadline:
                    return self._take_locked(key)
                remaining = max((deadline - now) / 1000.0, 0.0)
                signaled = self._cond.wait(remaining)
                if not signaled and timeutil.monotonic_millis() <= now:
                    # the injected clock is virtual or frozen: waiting can
                    # never reach the deadline, so flush now
                    deadline = now

    def _run_batch(self, key: Any, batch: list[_Entry], own: _Entry,
                   kind: str) -> DispatchOutcome | None:
        """Launch one batch; returns the outcome for `own`, or None when
        `own` was not part of this batch (its caller keeps waiting)."""
        # the largest-rank member's closure: every smaller-k joiner's
        # result is a prefix of that launch's rows
        launch = max(batch, key=lambda e: e.rank).launch
        try:
            results, retraced, wall_ns = _launch_timed(
                launch, [e.payload for e in batch])
        except BaseException as err:
            with self._cond:
                for e in batch:
                    e.error = err
                    e.done = True
                self._finish_locked(key, batch)
            raise
        with self._cond:
            for e, r in zip(batch, results):
                e.result = r
                e.batch_size = len(batch)
                e.wall_ns = wall_ns
                e.retraced = retraced
                e.done = True
            self._finish_locked(key, batch)
        self._record_launch(len(batch), kind)
        if not any(e is own for e in batch):
            return None
        return DispatchOutcome(own.result, len(batch), wall_ns, retraced,
                               own.wait_ms)

    def _finish_locked(self, key: Any, batch: list[_Entry]) -> None:
        merged = len(batch)
        n = self._in_flight.get(key, 0) - 1
        if n > 0:
            self._in_flight[key] = n
        else:
            self._in_flight.pop(key, None)
        self._ewma = _EWMA_DECAY * self._ewma + (1 - _EWMA_DECAY) * merged
        if self.auto_tune:
            # every key family in the batch (cross-k joiners carry their
            # own tune_key) learns this flush's merge factor and its
            # members' measured waits
            by_family: dict[Any, int] = {}
            for e in batch:
                if e.tune_key is not None:
                    by_family[e.tune_key] = max(
                        by_family.get(e.tune_key, 0), e.wait_ms)
            for tk, max_wait in by_family.items():
                self._tuner_locked(tk).note_flush(merged, max_wait)
        bucket = self._buckets.get(key)
        if bucket is not None and bucket.entries:
            # continuous batching: the backlog that formed while this
            # launch ran flushes at once, led by one of its waiters
            bucket.flush_now = True
        self._cond.notify_all()

    def _record_launch(self, merged: int, kind: str) -> None:
        with self._cond:
            self.stats["dispatches"] += 1
            self.stats["merged_queries"] += merged
            if merged > 1:
                self.stats["coalesced_batches"] += 1
            self.stats["max_batch"] = max(self.stats["max_batch"], merged)
            if kind == "ann":
                self.stats["ann_dispatches"] += 1
            else:
                self.stats["exact_dispatches"] += 1


# process-wide default: the executor's dispatch sites are module-level code
# with no node handle (as executor.knn_path_stats); a TorchNode exposes it
# as `knn_batcher`. One process serves one device.
default_batcher = KnnDispatchBatcher()


def dispatch(key: Any, payload: Any, launch, *, kind: str = "exact",
             rank: int = 0, alt_keys: Sequence[Any] = (),
             tune_key: Any = None) -> DispatchOutcome:
    return default_batcher.dispatch(key, payload, launch, kind=kind,
                                    rank=rank, alt_keys=alt_keys,
                                    tune_key=tune_key)
