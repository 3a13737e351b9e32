"""Priority lanes: interactive vs background request classification.

Counterpart of opensearch_tpu/search/lanes.py. Under mixed traffic a
flood of background work (bulk, msearch fan-outs, scroll pages,
force-merges) must never occupy every serving slot while an interactive
query waits. Every request is classified ONCE at its boundary (the REST
dispatch in rest/http.py) into one of two lanes:

- ``interactive`` — a user is waiting: plain ``_search`` / ``_count``.
- ``background`` — throughput traffic that tolerates latency: ``_bulk``,
  ``_msearch``, scroll start/continuation, ``_forcemerge``.

The lane then follows the request through every queueing point:

1. **pool slots** — rest/http.py keeps a RESERVED interactive pool;
   background work runs on its own smaller pool, so a background flood
   can saturate only its own workers.
2. **the kNN dispatch batcher** — the active lane rides a contextvar into
   ``search/batcher.py``: background entries may wait out a longer batch
   deadline (they earn bigger merges), while an interactive entry's own
   (auto-tuned, short) deadline flushes any bucket it joins.
3. **shedding** — the background lane's queue is BOUNDED
   (``search.lanes.background_max_queue``); past the bound it sheds 429
   (the QueuePressure contract) instead of queueing without bound.

``search.lanes.enabled`` is the kill switch: disabled, every request runs
the shared interactive pool. The metric records take the node's metrics
registry, which the port does not have yet (``None`` records nothing).
"""

from __future__ import annotations

import contextvars
import threading

from opensearch_tpu_torch.common.settings import Property, Setting

INTERACTIVE = "interactive"
BACKGROUND = "background"
LANES = (INTERACTIVE, BACKGROUND)

# registered metric names (constants, never built at the record
# site); per-lane series vary by LABEL under these families
LANE_QUEUE_DEPTH_MS = "search.lane.queue_depth"
LANE_SHED_TOTAL = "search.lane.shed"
SEARCH_TOOK_MS = "search.took_ms"

# -- settings (registered dynamic in cluster/cluster_settings.py) -----------

LANES_ENABLED_SETTING = Setting.bool_setting(
    "search.lanes.enabled", True,
    Property.NODE_SCOPE, Property.DYNAMIC,
)
BACKGROUND_MAX_QUEUE_SETTING = Setting.int_setting(
    "search.lanes.background_max_queue", 256,
    Property.NODE_SCOPE, Property.DYNAMIC, min_value=0,
)

LANE_SETTINGS = (LANES_ENABLED_SETTING, BACKGROUND_MAX_QUEUE_SETTING)


class LaneConfig:
    """Process-wide lane policy (the batcher/registry adapter shape):
    dynamic-settings updates retune it live; readers read racily by
    design — a request classified under the old policy completes under
    it, which is the dynamic-settings contract."""

    def __init__(self, enabled: bool | None = None,
                 background_max_queue: int | None = None):
        from opensearch_tpu_torch.common.settings import Settings

        self.enabled = (enabled if enabled is not None
                        else LANES_ENABLED_SETTING.default(Settings.EMPTY))
        self.background_max_queue = (
            background_max_queue if background_max_queue is not None
            else BACKGROUND_MAX_QUEUE_SETTING.default(Settings.EMPTY))

    def configure(self, *, enabled: bool | None = None,
                  background_max_queue: int | None = None) -> None:
        if enabled is not None:
            self.enabled = bool(enabled)
        if background_max_queue is not None:
            self.background_max_queue = max(0, int(background_max_queue))

    def apply_settings(self, flat: dict) -> None:
        """Pick this config's keys out of a flat effective-settings map
        (the cluster-settings update consumer)."""
        from opensearch_tpu_torch.common.settings import Settings

        s = Settings.from_flat({
            st.key: flat[st.key] for st in LANE_SETTINGS if st.key in flat
        })
        self.configure(
            enabled=LANES_ENABLED_SETTING.get(s),
            background_max_queue=BACKGROUND_MAX_QUEUE_SETTING.get(s),
        )


default_config = LaneConfig()

# -- the active lane (contextvar, like the profiler / upload_scope) ----------

_lane_var: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "opensearch_tpu_request_lane", default=None
)


class lane_scope:
    """Context manager stamping the current request's lane; everything
    below (the dispatch batcher, metrics records) reads it without
    signature changes through the service/executor stack."""

    __slots__ = ("lane", "_token")

    def __init__(self, lane: str):
        self.lane = lane if lane in LANES else INTERACTIVE
        self._token = None

    def __enter__(self) -> "lane_scope":
        self._token = _lane_var.set(self.lane)
        return self

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _lane_var.reset(self._token)


def active_lane() -> str:
    """The lane of the executing request; unclassified work (engine
    publishes, recovery, tests driving internals directly) counts as
    interactive — the conservative default."""
    return _lane_var.get() or INTERACTIVE


# -- classification ----------------------------------------------------------

# last path segments that mark a request background at the REST boundary
_BACKGROUND_TAILS = frozenset({
    "_bulk", "_msearch", "_forcemerge", "scroll",
})


def classify_rest(path: str, query: dict) -> str:
    """Lane of one REST request, from its path shape alone: msearch /
    bulk / scroll (start via ?scroll= or continuation via /_search/scroll)
    / force-merge are background; everything else — including plain
    ``_search`` and ``_count`` — is interactive. An explicit ``?lane=``
    overrides (an operator marking a reporting query background)."""
    explicit = query.get("lane")
    if explicit in LANES:
        return explicit
    if "scroll" in query:
        return BACKGROUND
    tail = path.rstrip("/").rsplit("/", 1)[-1]
    return BACKGROUND if tail in _BACKGROUND_TAILS else INTERACTIVE


class LaneTracker:
    """Per-pool-owner lane bookkeeping: live queue depth, lifetime
    submitted/completed/shed counters, one cell per lane. Feeds the
    `tail.lanes` stats section and the `search.lane.*` metric families."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cells: dict[str, dict[str, int]] = {
            lane: {"submitted": 0, "completed": 0, "shed": 0, "depth": 0}
            for lane in LANES
        }

    def try_submit(self, lane: str, max_queue: int | None = None) -> bool:
        """Account one submission; returns False (a shed) when the lane's
        live depth is at `max_queue` — the caller must 429, not queue."""
        cell = self._cells[lane if lane in LANES else INTERACTIVE]
        with self._lock:
            if max_queue is not None and cell["depth"] >= max_queue:
                cell["shed"] += 1
                return False
            cell["submitted"] += 1
            cell["depth"] += 1
        return True

    def complete(self, lane: str) -> None:
        cell = self._cells[lane if lane in LANES else INTERACTIVE]
        with self._lock:
            cell["completed"] += 1
            cell["depth"] = max(0, cell["depth"] - 1)

    def depth(self, lane: str) -> int:
        cell = self._cells[lane if lane in LANES else INTERACTIVE]
        with self._lock:
            return cell["depth"]

    def snapshot(self) -> dict:
        with self._lock:
            return {lane: dict(cell) for lane, cell in self._cells.items()}


def record_lane_metrics(metrics, lane: str, depth: int) -> None:
    """Queue-depth observation at submit time (a distribution beats a
    point-in-time gauge for tail analysis) under the constant family
    name, lane as a LABEL."""
    if metrics is None:
        return
    metrics.histogram(LANE_QUEUE_DEPTH_MS, labels={"lane": lane}).record(
        depth)


def record_lane_shed(metrics, lane: str) -> None:
    if metrics is None:
        return
    metrics.counter(LANE_SHED_COUNTERS[lane]).add(1)


# counter names are constants per lane (counters have no label support;
# the family split is the two-member lane enum, not unbounded cardinality)
LANE_SHED_COUNTERS = {
    INTERACTIVE: "search.lane.shed.interactive",
    BACKGROUND: "search.lane.shed.background",
}
