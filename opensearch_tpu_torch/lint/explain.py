"""``tpulint --explain TPUxxx``: per-rule documentation on demand.

Every registered rule carries one minimal bad/good pair. The snippets are
REAL lintable sources, not prose: the linter's tests run each bad snippet
through ``lint_source`` and asserts its own rule fires (and that the good
snippet is clean for that rule), so the documentation can never rot away
from the checkers. Module markers (``# tpulint: deterministic-module``,
``# tpulint: device-module``, ``# tpulint: ops-module``) scope snippets the
same way real modules opt in.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Example:
    bad: str
    good: str


EXAMPLES: dict[str, Example] = {
    "TPU001": Example(
        bad='''\
import torch


@torch.compile
def score(x):
    best = x.max().item()    # host sync inside the compiled function
    if best > 0:             # a branch on a tensor's value
        return x / best
    return x
''',
        good='''\
import torch


@torch.compile
def score(x):
    best = x.amax()
    return torch.where(best > 0, x / best, x)


def debug(x):
    print("best", score(x).max().item())  # host work stays outside
''',
    ),
    "TPU002": Example(
        bad='''\
import time


async def handler(reader, writer):
    time.sleep(0.1)  # parks the whole event loop
''',
        good='''\
import asyncio


async def handler(reader, writer):
    await asyncio.sleep(0.1)
''',
    ),
    "TPU003": Example(
        bad='''\
import threading


class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0

    def add(self, n):
        with self._lock:
            self.total += n

    def snapshot(self):
        return self.total  # lock-free read of a locked attribute
''',
        good='''\
import threading


class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0

    def add(self, n):
        with self._lock:
            self.total += n

    def snapshot(self):
        with self._lock:
            return self.total
''',
    ),
    "TPU004": Example(
        bad='''\
# tpulint: deterministic-module
import time


def next_delay():
    return time.time() + 0.5  # wall clock breaks seeded replay
''',
        good='''\
# tpulint: deterministic-module
from opensearch_tpu_torch.common import timeutil


def next_delay():
    return timeutil.monotonic_millis() + 500
''',
    ),
    "TPU005": Example(
        bad='''\
def refresh(engine):
    try:
        engine.refresh()
    except Exception:
        pass  # the error evaporates
''',
        good='''\
import logging

log = logging.getLogger(__name__)


def refresh(engine):
    try:
        engine.refresh()
    except Exception:
        log.exception("refresh failed")
''',
    ),
    "TPU006": Example(
        bad='''\
# tpulint: deterministic-module
import uuid


def mint_id():
    return uuid.uuid4().hex  # process entropy: not replayable
''',
        good='''\
# tpulint: deterministic-module
def mint_id(scheduler):
    return "%020x" % scheduler.random.getrandbits(80)
''',
    ),
    "TPU007": Example(
        bad='''\
import torch


def score(f, xs):
    return [torch.compile(f)(x) for x in xs]  # a fresh compile per call
''',
        good='''\
import torch


def _f(x):
    return x


score_compiled = torch.compile(_f)  # one compiled function per process


def score(xs):
    return [score_compiled(x) for x in xs]
''',
    ),
    "TPU008": Example(
        bad='''\
def dispatch(req, on_response, on_failure):
    if req.ok:
        on_response(req.value)
    # the not-ok path drops BOTH callbacks: the caller waits forever
''',
        good='''\
def dispatch(req, on_response, on_failure):
    if req.ok:
        on_response(req.value)
    else:
        on_failure(ValueError("not ok"))
''',
    ),
    "TPU009": Example(
        bad='''\
# tpulint: deterministic-module
class ReplyRouter:
    def __init__(self):
        self._pending = {}

    def on_request(self, rid, frame):
        self._pending[rid] = frame  # grows forever: no bound, no shed
''',
        good='''\
# tpulint: deterministic-module
MAX_PENDING = 4096


class ReplyRouter:
    def __init__(self):
        self._pending = {}

    def on_request(self, rid, frame):
        while len(self._pending) >= MAX_PENDING:
            self._pending.pop(next(iter(self._pending)))
        self._pending[rid] = frame
''',
    ),
    "TPU010": Example(
        bad='''\
import threading


class Inverted:
    def __init__(self):
        self._alpha = threading.Lock()
        self._beta = threading.Lock()

    def record(self):
        with self._alpha:
            self._refresh()  # acquires beta under alpha...

    def _refresh(self):
        with self._beta:
            pass

    def snapshot(self):
        with self._beta:
            with self._alpha:  # ...while this path takes beta first
                pass
''',
        good='''\
import threading


class Consistent:
    def __init__(self):
        self._alpha = threading.Lock()
        self._beta = threading.Lock()

    def record(self):
        with self._alpha:
            self._refresh()

    def _refresh(self):
        with self._beta:
            pass

    def snapshot(self):
        with self._alpha:
            with self._beta:  # same global order everywhere
                pass
''',
    ),
    "TPU011": Example(
        bad='''\
class Node:
    def _offload(self, fn):
        return fn()

    def _on_get(self, fut):
        return self._offload(lambda: fut.result())  # untimed wait wedges
        # the serial worker and stalls every search/write on the node
''',
        good='''\
class Node:
    def _offload(self, fn):
        return fn()

    def _on_get(self, fut):
        return self._offload(lambda: fut.result(timeout=30.0))
''',
    ),
    "TPU012": Example(
        bad='''\
def serve(tracer, req):
    span = tracer.begin_span("op")
    if not req.valid:
        return None  # span abandoned: the ring holds it open forever
    out = req.run()
    tracer.end_span(span)
    return out
''',
        good='''\
def serve(tracer, req):
    span = tracer.begin_span("op")
    try:
        if not req.valid:
            return None
        return req.run()
    finally:
        tracer.end_span(span)
''',
    ),
    "TPU013": Example(
        bad='''\
def record(metrics, index, took_ms):
    # each index mints a fresh series forever
    metrics.histogram(f"search.took_ms.{index}").record(took_ms)
''',
        good='''\
SEARCH_TOOK_MS = "search.took_ms"


def record(metrics, index, took_ms):
    metrics.histogram(SEARCH_TOOK_MS).record(took_ms)
''',
    ),
    "TPU014": Example(
        bad='''\
# tpulint: device-module
import torch


def publish_column(host_array, device):
    return torch.from_numpy(host_array).to(device)  # bytes no budget sees
''',
        good='''\
# tpulint: device-module
import torch

from opensearch_tpu_torch.telemetry.device_ledger import default_ledger


def publish_column(host_array, device, field):
    dev = torch.from_numpy(host_array).to(device)
    default_ledger.register("column", dev.nbytes, field=field)
    return dev
''',
    ),
    "TPU015": Example(
        bad='''\
# tpulint: device-module
from opensearch_tpu_torch.search.profile import profiled_kernel


@profiled_kernel("my_unmodeled_scan")  # no roofline cost model
def custom_scan(vectors, queries):
    return vectors @ queries
''',
        good='''\
# tpulint: device-module
from opensearch_tpu_torch.search.profile import profiled_kernel


@profiled_kernel("knn_exact_scores")  # registered in telemetry/roofline
def exact_scan(vectors, queries):
    return vectors @ queries
''',
    ),
    "TPU016": Example(
        bad='''\
from opensearch_tpu_torch.ops import cuda_lib


def serve_scores(x):  # serving code loads and launches a kernel itself
    lib = cuda_lib.load("double")
    lib.double_launch(x.data_ptr(), x.numel())
    return x
''',
        good='''\
# tpulint: ops-module
import functools

from opensearch_tpu_torch.ops import cuda_lib


@functools.lru_cache(maxsize=None)
def _library():
    return cuda_lib.load("double")


def plain_double(x):
    return x * 2.0


def double(x):
    if x.device.type == "cpu":
        return plain_double(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device [{x.device}]")
    out = x.clone()
    _library().double_launch(out.data_ptr(), out.numel())
    return out
''',
    ),
    "TPU017": Example(
        bad='''\
# tpulint: device-module
from opensearch_tpu_torch.telemetry import roofline


def launch_scan(column, queries, wall_ns):
    scores = column.scan(queries)
    roofline.record_launch(  # heat map never sees this access
        "knn_exact_scores", wall_ns,
        b=queries.shape[0], n=column.n, d=column.d)
    return scores
''',
        good='''\
# tpulint: device-module
from opensearch_tpu_torch.telemetry import roofline
from opensearch_tpu_torch.telemetry.device_ledger import default_ledger


def launch_scan(column, queries, wall_ns):
    scores = column.scan(queries)
    params = dict(b=queries.shape[0], n=column.n, d=column.d)
    roofline.record_launch("knn_exact_scores", wall_ns, **params)
    default_ledger.touch([column.allocation],
                         family="knn_exact_scores", params=params)
    return scores
''',
    ),
    "TPU018": Example(
        bad='''\
class HeatLedger:
    def __init__(self, scheduler):
        self._rows = {}
        scheduler.schedule(1000, self._tick)  # tick: timer role

    def record(self, key, nbytes):
        def write():
            self._rows[key] = nbytes

        return self._offload(write)  # write: data-worker role

    def _tick(self):
        # live iteration races the data worker's writes — no common lock
        return sum(n for _k, n in self._rows.items())

    def _offload(self, fn):
        return fn()
''',
        good='''\
class HeatLedger:
    def __init__(self, scheduler):
        self._rows = {}
        scheduler.schedule(1000, self._tick)

    def record(self, key, nbytes):
        def write():
            self._rows[key] = nbytes

        return self._offload(write)

    def _tick(self):
        # list() is one C-level op: an atomic snapshot against
        # concurrent single-key writes
        return sum(n for _k, n in list(self._rows.items()))

    def _offload(self, fn):
        return fn()
''',
    ),
    "TPU019": Example(
        bad='''\
class QueryCache:
    def __init__(self, search_pool):
        self._search_pool = search_pool
        self._cache = {}

    def lookup(self, key):
        return self._search_pool.submit(self._get, key)

    def store(self, key, value):
        def write():
            self._cache[key] = value

        return self._offload(write)

    def _get(self, key):
        if key in self._cache:       # the key can vanish between
            return self._cache[key]  # the test and the read
        return None

    def _offload(self, fn):
        return fn()
''',
        good='''\
class QueryCache:
    def __init__(self, search_pool):
        self._search_pool = search_pool
        self._cache = {}

    def lookup(self, key):
        return self._search_pool.submit(self._get, key)

    def store(self, key, value):
        def write():
            self._cache[key] = value

        return self._offload(write)

    def _get(self, key):
        return self._cache.get(key)  # one atomic dict op

    def _offload(self, fn):
        return fn()
''',
    ),
}


# The thread-role rules also fire on CROSS-MODULE shapes: the racing class
# has no dispatch idiom of its own — its roles arrive from a caller class
# that constructs/injects it (lint/callgraph.py propagates roles through
# ``self.<attr>.<method>()`` edges). These pairs document exactly that
# shape; like EXAMPLES they are real lintable sources exercised by
# tests/test_lint.py (the bad snippet must fire its own rule and nothing
# else from the role family, the good snippet must stay clean).
CROSS_MODULE_EXAMPLES: dict[str, Example] = {
    "TPU018": Example(
        bad='''\
class ShardStatsService:
    """No dispatch idiom in sight: roles arrive from the caller below."""

    def __init__(self):
        self._rows = {}

    def record(self, key, nbytes):
        self._rows[key] = nbytes

    def total(self):
        # live iteration vs the data worker's writes — no common lock
        return sum(n for _k, n in self._rows.items())


class StatsNode:
    def __init__(self, scheduler):
        self.stats = ShardStatsService()
        scheduler.schedule(1000, self._tick)  # _tick: timer role

    def handle_index(self, key, nbytes):
        def write():
            self.stats.record(key, nbytes)

        return self._offload(write)  # record(): data-worker role

    def _tick(self):
        return self.stats.total()  # total(): timer role

    def _offload(self, fn):
        return fn()
''',
        good='''\
class ShardStatsService:
    def __init__(self):
        self._rows = {}

    def record(self, key, nbytes):
        self._rows[key] = nbytes

    def total(self):
        # list() snapshots atomically against single-key writes
        return sum(n for _k, n in list(self._rows.items()))


class StatsNode:
    def __init__(self, scheduler):
        self.stats = ShardStatsService()
        scheduler.schedule(1000, self._tick)

    def handle_index(self, key, nbytes):
        def write():
            self.stats.record(key, nbytes)

        return self._offload(write)

    def _tick(self):
        return self.stats.total()

    def _offload(self, fn):
        return fn()
''',
    ),
    "TPU019": Example(
        bad='''\
class SessionTable:
    """Check-then-act that is only racy because of how callers role it."""

    def __init__(self):
        self._sessions = {}

    def open(self, sid, session):
        if sid not in self._sessions:    # the slot can be filled between
            self._sessions[sid] = session  # the test and the insert

    def close(self, sid):
        return self._sessions.pop(sid, None)


class RecoveryNode:
    def __init__(self, transport):
        self.sessions = SessionTable()
        transport.register("n1", "recovery:start", self._on_start)

    def _on_start(self, msg):
        self.sessions.open(msg["sid"], msg)  # open(): transport role

    def begin_local(self, sid):
        def work():
            self.sessions.close(sid)

        return self._offload(work)  # close(): data-worker role

    def _offload(self, fn):
        return fn()
''',
        good='''\
class SessionTable:
    def __init__(self):
        self._sessions = {}

    def open(self, sid, session):
        # one atomic dict op: no window between membership test and insert
        self._sessions.setdefault(sid, session)

    def close(self, sid):
        return self._sessions.pop(sid, None)


class RecoveryNode:
    def __init__(self, transport):
        self.sessions = SessionTable()
        transport.register("n1", "recovery:start", self._on_start)

    def _on_start(self, msg):
        self.sessions.open(msg["sid"], msg)

    def begin_local(self, sid):
        def work():
            self.sessions.close(sid)

        return self._offload(work)

    def _offload(self, fn):
        return fn()
''',
    ),
}


def explain(rule_id: str) -> str | None:
    """The full ``--explain`` text for one rule, or None if unknown."""
    from opensearch_tpu_torch.lint.rules import RULES

    checker = RULES.get(rule_id)
    if checker is None:
        return None
    ex = EXAMPLES.get(rule_id)
    parts = [f"{rule_id} {checker.name}", "", checker.description, ""]
    if ex is not None:
        parts += ["BAD:", "", _indent(ex.bad), "GOOD:", "", _indent(ex.good)]
    xex = CROSS_MODULE_EXAMPLES.get(rule_id)
    if xex is not None:
        parts += ["CROSS-MODULE BAD (roles arrive from the caller class):",
                  "", _indent(xex.bad),
                  "CROSS-MODULE GOOD:", "", _indent(xex.good)]
    return "\n".join(parts).rstrip() + "\n"


def _indent(snippet: str) -> str:
    return "\n".join("    " + line if line else ""
                     for line in snippet.rstrip().splitlines()) + "\n"
