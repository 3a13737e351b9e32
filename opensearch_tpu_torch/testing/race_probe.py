"""Runtime confirmation for the TPU018/TPU019 thread-role analyzer.

The static analyzer (lint/threadroles.py) infers which executor runs each
method and flags shared mutable state reachable from >= 2 execution
domains without a common lock. The whole-program pass
(lint/callgraph.py) resolves roles ACROSS files too — classes like
SearchBackpressureService and HierarchyBreakerService, whose callers live
elsewhere, now carry static roles and no longer need a dynamic drill.
What remains for runtime confirmation: flagged patterns may in fact be
protected by discipline the recognizers don't model, and any class the
cross-module pass still cannot role (``statically_unroled()``) keeps its
place in the drill. This probe closes that loop:

- ``role_scope(role)`` tags the current thread with an executor role;
  ``probe_scope()`` auto-tags the sim's dispatch points (ClusterNode
  ``_offload`` -> data worker, ``_offload_search`` -> search pool,
  scheduler ``schedule`` -> timer, MockTransport handlers -> transport)
  so soak traffic arrives pre-labelled.
- ``threading.Lock``/``RLock`` constructed inside the scope become
  :class:`ProbeLock` wrappers that track the per-thread held set.
- Watched attributes record every write as ``(domain, kind, locks
  held)``: scalar rebinds via a recording ``__setattr__`` subclass, dict
  item ops and iteration via :class:`ProbeDict`.

``report()`` then classifies each attribute exactly the way TPU018
would, but from OBSERVED events: writes from >= 2 domains with no common
lock and a non-atomic kind are **confirmed** races; a common lock across
every access **confirms the fix**; single C-level dict ops cross-domain
are **refuted** (GIL-atomic, the static ATOMIC exemption). The CLI runs
one seeded soak cycle plus a threaded drill of whatever is STILL
statically unroled and exits 1 on any confirmed finding. ``--tcp``
drives the TcpSoak reshape chain (real sockets, real thread pools,
invariants-only) under the same instrumentation. The soak's nodes run on
the card (``--device cuda``, the default) or the CPU (``--device cpu``)::

    python -m opensearch_tpu_torch.testing.race_probe --device cpu
    python -m opensearch_tpu_torch.testing.race_probe --tcp --seconds 45 \
        --device cpu
    python -m opensearch_tpu_torch.testing.race_probe --no-soak
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from dataclasses import dataclass, field

from opensearch_tpu_torch.lint.threadroles import (
    DOMAIN,
    ROLE_DATA,
    ROLE_SEARCH,
    ROLE_TIMER,
    ROLE_TRANSPORT,
)

# captured before any patching: the recorder must never run through its
# own instrumentation
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

ROLE_MAIN = "main"  # un-tagged code (setup, direct test calls)

# runtime write kinds, mirroring the static access model
KIND_REBIND = "rebind"  # attribute rebind: += on a counter is RMW
KIND_ITEM = "item"      # one C-level dict op: GIL-atomic
KIND_ITER = "iter"      # iteration started (snapshot or live — can't tell)
KIND_TORN = "torn-iter"  # a write landed while ANOTHER thread was mid-walk


class _ThreadState(threading.local):
    def __init__(self):
        self.roles: list[str] = []
        self.held: dict[str, int] = {}  # ProbeLock name -> recursion depth


_state = _ThreadState()


def current_role() -> str:
    return _state.roles[-1] if _state.roles else ROLE_MAIN


@contextlib.contextmanager
def role_scope(role: str):
    """Tag the current thread with an executor role (innermost wins)."""
    _state.roles.append(role)
    try:
        yield
    finally:
        _state.roles.pop()


def _held_locks() -> frozenset[str]:
    return frozenset(n for n, depth in _state.held.items() if depth > 0)


class ProbeLock:
    """A Lock/RLock wrapper tracking the per-thread held set. Exposes the
    Condition integration surface (_release_save/_acquire_restore/
    _is_owned) so threading.Condition built on a wrapped RLock keeps the
    accounting straight."""

    _seq = itertools.count(1)

    def __init__(self, inner):
        self._inner = inner
        self.name = f"lock-{next(ProbeLock._seq)}"

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            _state.held[self.name] = _state.held.get(self.name, 0) + 1
        return ok

    def release(self):
        self._inner.release()
        depth = _state.held.get(self.name, 0)
        if depth > 1:
            _state.held[self.name] = depth - 1
        else:
            _state.held.pop(self.name, None)

    def locked(self):
        return self._inner.locked()

    def _at_fork_reinit(self):
        # stdlib modules built on module-level locks register this with
        # os.register_at_fork at IMPORT time (concurrent.futures.thread) —
        # a lock constructed in-scope must expose it or the import breaks
        self._inner._at_fork_reinit()
        _state.held.pop(self.name, None)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # -- threading.Condition protocol --------------------------------------
    # Condition duck-probes these with try/AttributeError; a wrapper
    # always has them, so each must also emulate Condition's plain-Lock
    # fallback when the inner lock is not an RLock.

    def _release_save(self):
        depth = _state.held.pop(self.name, 0)
        if hasattr(self._inner, "_release_save"):
            return (self._inner._release_save(), depth)
        self._inner.release()
        return (None, depth)

    def _acquire_restore(self, saved):
        inner_state, depth = saved
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(inner_state)
        else:
            self._inner.acquire()
        if depth:
            _state.held[self.name] = depth

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


@dataclass(frozen=True)
class WriteEvent:
    role: str
    kind: str
    locks: frozenset[str]

    @property
    def domain(self) -> str | None:
        return DOMAIN.get(self.role)


class Recorder:
    """Event sink: dedup'd (class, attr) -> {WriteEvent} so a soak's
    million writes cost a set lookup each, not unbounded memory."""

    def __init__(self):
        self._lock = _REAL_LOCK()
        self.events: dict[tuple[str, str], set[WriteEvent]] = {}

    def record(self, cls_name: str, attr: str, kind: str) -> None:
        ev = WriteEvent(current_role(), kind, _held_locks())
        with self._lock:
            self.events.setdefault((cls_name, attr), set()).add(ev)

    # -- classification ----------------------------------------------------

    def report(self) -> dict:
        findings = []
        for (cls_name, attr), evs in sorted(self.events.items()):
            tagged = [e for e in evs if e.domain is not None]
            doms = {e.domain for e in tagged}
            writes = [e for e in tagged
                      if e.kind in (KIND_REBIND, KIND_ITEM, KIND_TORN)]
            torn = any(e.kind == KIND_TORN for e in evs)
            entry = {
                "class": cls_name, "attr": attr,
                "domains": sorted(doms),
                "events": len(evs),
            }
            if torn:
                # a write observed landing inside another thread's live
                # walk — confirmed regardless of inferred domains
                entry["verdict"] = "confirmed"
                entry["unlocked_kinds"] = sorted(
                    {e.kind for e in tagged if not e.locks})
            elif not writes or len(doms) < 2:
                entry["verdict"] = "single-domain" if doms else "untagged"
            else:
                common = frozenset.intersection(*(e.locks for e in tagged))
                if common:
                    # the fix confirmed: every cross-domain access shares
                    # a lock
                    entry["verdict"] = "locked"
                elif any(e.kind == KIND_REBIND for e in writes):
                    entry["verdict"] = "confirmed"
                    entry["unlocked_kinds"] = sorted(
                        {e.kind for e in tagged if not e.locks})
                else:
                    # single C-level dict ops are GIL-atomic, and ITER
                    # with no observed interleaving is indistinguishable
                    # from the snapshot idiom — the static ATOMIC/
                    # SNAPSHOT exemptions, refuted as a race
                    entry["verdict"] = "atomic"
            findings.append(entry)
        confirmed = [f for f in findings if f["verdict"] == "confirmed"]
        return {"findings": findings, "confirmed": confirmed}


# ---------------------------------------------------------------------------
# attribute watching
# ---------------------------------------------------------------------------

_WATCH_CACHE: dict[tuple[type, frozenset, frozenset], type] = {}


class ProbeDict(dict):
    """A dict recording item writes and iteration per (class, attr).

    From inside the dict, ``list(d.items())`` (the sanctioned snapshot
    idiom) and a live ``for k, v in d.items()`` walk are the same call —
    so ITER events alone never confirm a race. What does is an OBSERVED
    interleaving: each iteration marks its thread live until exhaustion,
    and a mutation arriving from a different thread mid-walk records a
    torn-iter event — the actual "dictionary changed size during
    iteration" hazard, witnessed rather than inferred. Reads
    (get/__getitem__/__contains__) stay silent: the race signal is who
    WRITES and who WALKS, and read noise would drown it."""

    __slots__ = ("_probe", "_live")

    def _init_probe(self, recorder: Recorder, cls_name: str, attr: str):
        self._probe = (recorder, cls_name, attr)
        self._live: dict[int, int] = {}  # thread id -> live-walk depth
        return self

    def _rec(self, kind: str) -> None:
        recorder, cls_name, attr = self._probe
        recorder.record(cls_name, attr, kind)

    def _rec_write(self) -> None:
        me = threading.get_ident()
        if any(tid != me for tid in self._live):
            self._rec(KIND_TORN)
        self._rec(KIND_ITEM)

    def _walk(self, it):
        tid = threading.get_ident()
        self._live[tid] = self._live.get(tid, 0) + 1
        try:
            yield from it
        finally:
            depth = self._live.get(tid, 1)
            if depth > 1:
                self._live[tid] = depth - 1
            else:
                self._live.pop(tid, None)

    def __setitem__(self, k, v):
        self._rec_write()
        dict.__setitem__(self, k, v)

    def __delitem__(self, k):
        self._rec_write()
        dict.__delitem__(self, k)

    def pop(self, *a):
        self._rec_write()
        return dict.pop(self, *a)

    def setdefault(self, k, default=None):
        self._rec_write()
        return dict.setdefault(self, k, default)

    def clear(self):
        self._rec_write()
        dict.clear(self)

    def update(self, *a, **kw):
        self._rec_write()
        dict.update(self, *a, **kw)

    def __iter__(self):
        self._rec(KIND_ITER)
        return self._walk(dict.__iter__(self))

    def items(self):
        self._rec(KIND_ITER)
        return self._walk(dict.items(self))

    def keys(self):
        self._rec(KIND_ITER)
        return self._walk(dict.keys(self))

    def values(self):
        self._rec(KIND_ITER)
        return self._walk(dict.values(self))


def watch(obj, recorder: Recorder, scalar_attrs=(), dict_attrs=()) -> None:
    """Instrument one instance: scalar rebinds record via a __setattr__
    subclass swap; dict attrs are replaced with recording ProbeDicts."""
    cls = type(obj)
    scalars, dicts = frozenset(scalar_attrs), frozenset(dict_attrs)
    key = (cls, scalars, dicts)
    sub = _WATCH_CACHE.get(key)
    if sub is None:

        class _Watched(cls):  # type: ignore[misc, valid-type]
            _probe_scalars = scalars
            _probe_dicts = dicts
            _probe_recorder = recorder

            def __setattr__(self, name, value):
                watched = type(self)
                if name in watched._probe_scalars:
                    watched._probe_recorder.record(
                        cls.__name__, name, KIND_REBIND)
                elif name in watched._probe_dicts and type(value) is dict:
                    # a rebound plain dict would escape instrumentation:
                    # re-wrap so later item ops keep recording
                    value = ProbeDict(value)._init_probe(
                        watched._probe_recorder, cls.__name__, name)
                cls.__setattr__(self, name, value)

        _Watched.__name__ = cls.__name__
        _Watched.__qualname__ = cls.__qualname__
        sub = _WATCH_CACHE[key] = _Watched
    sub._probe_recorder = recorder
    obj.__class__ = sub
    for attr in dicts:
        current = obj.__dict__.get(attr)
        if type(current) is dict:
            obj.__dict__[attr] = ProbeDict(current)._init_probe(
                recorder, cls.__name__, attr)


# ---------------------------------------------------------------------------
# instrumentation scope
# ---------------------------------------------------------------------------

# statically-unroled or cross-file-dispatched hot spots the probe watches
# whenever one is constructed inside the scope:
#   (module, class) -> (scalar attrs, dict attrs)
WATCH_SPECS: dict[tuple[str, str], tuple[tuple[str, ...], tuple[str, ...]]] = {
    ("opensearch_tpu_torch.search.backpressure", "SearchBackpressureService"):
        (("rejections", "cancellations"), ()),
    ("opensearch_tpu_torch.common.breaker", "HierarchyBreakerService"):
        (("parent_trip_count",), ()),
    ("opensearch_tpu_torch.cluster.cluster_node", "ClusterNode"):
        ((), ("_reader_contexts", "_tracked_targets")),
}


@dataclass
class Probe:
    recorder: Recorder = field(default_factory=Recorder)

    def report(self) -> dict:
        return self.recorder.report()


def _wrap_dispatch(fn, role):
    def run():
        with role_scope(role):
            return fn()
    return run


@contextlib.contextmanager
def probe_scope():
    """Install the instrumentation: ProbeLock factories, role tags on the
    sim's dispatch points, auto-watch on the WATCH_SPECS classes. Restores
    everything on exit; yields the :class:`Probe`."""
    import importlib

    from opensearch_tpu_torch.cluster.cluster_node import ClusterNode
    from opensearch_tpu_torch.testing.sim import DeterministicTaskQueue, MockTransport
    from opensearch_tpu_torch.transport.tcp import LoopScheduler, TcpTransport

    probe = Probe()
    recorder = probe.recorder
    saved: list[tuple[object, str, object]] = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    # 1. every lock constructed in-scope becomes a ProbeLock
    patch(threading, "Lock", lambda: ProbeLock(_REAL_LOCK()))
    patch(threading, "RLock", lambda: ProbeLock(_REAL_RLOCK()))

    # 2. role tags on the dispatch points the static analyzer recognizes
    orig_offload = ClusterNode._offload
    orig_offload_search = ClusterNode._offload_search
    patch(ClusterNode, "_offload",
          lambda self, fn: orig_offload(self, _wrap_dispatch(fn, ROLE_DATA)))
    patch(ClusterNode, "_offload_search",
          lambda self, fn, lane=None: orig_offload_search(
              self, _wrap_dispatch(fn, ROLE_SEARCH), lane))
    for sched_cls in (DeterministicTaskQueue, LoopScheduler):
        orig_schedule = sched_cls.schedule
        patch(sched_cls, "schedule",
              lambda self, delay_ms, fn, _orig=orig_schedule:
              _orig(self, delay_ms, _wrap_dispatch(fn, ROLE_TIMER)))
    # both transports share the register(node_id, action, handler) shape
    # and call handlers as handler(sender, payload) — tag them identically
    # so the TcpSoak reshape chain (--tcp) arrives pre-labelled too
    for transport_cls in (MockTransport, TcpTransport):
        orig_register = transport_cls.register

        def register(self, node_id, action, handler, _orig=orig_register):
            def tagged(sender, payload):
                with role_scope(ROLE_TRANSPORT):
                    return handler(sender, payload)
            return _orig(self, node_id, action, tagged)

        patch(transport_cls, "register", register)

    # 3. auto-watch: new instances of the hot-spot classes record writes
    for (mod_name, cls_name), (scalars, dicts) in WATCH_SPECS.items():
        cls = getattr(importlib.import_module(mod_name), cls_name)
        orig_init = cls.__init__

        def init(self, *a, _orig=orig_init, _s=scalars, _d=dicts, **kw):
            _orig(self, *a, **kw)
            watch(self, recorder, scalar_attrs=_s, dict_attrs=_d)

        patch(cls, "__init__", init)

    try:
        yield probe
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


# ---------------------------------------------------------------------------
# threaded drill: only what the static pass STILL cannot role
# ---------------------------------------------------------------------------

def statically_unroled(candidates=None) -> list[str]:
    """Class names among ``candidates`` to which the whole-program static
    pass (lint/callgraph.py) assigns NO executor roles — the set that
    still needs a dynamic drill.  Default candidates: every watched or
    drillable class.  This is expected to be EMPTY for the two drill
    services (asserted in tests), which is the point: the drill shrinks
    as the statics grow."""
    import os

    from opensearch_tpu_torch.lint import callgraph
    from opensearch_tpu_torch.lint.core import iter_py_files

    if candidates is None:
        candidates = sorted({cls for _, cls in WATCH_SPECS} | set(DRILLS))
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roles, _ = callgraph.program_roles(list(iter_py_files([pkg])))
    return sorted(c for c in candidates if not roles.get(c))


def _drill_backpressure():
    from opensearch_tpu_torch.search.backpressure import (
        RejectedExecutionException,
        SearchBackpressureService,
    )
    from opensearch_tpu_torch.tasks.manager import TaskManager

    tm = TaskManager()
    bp = SearchBackpressureService(tm, max_concurrent=1,
                                   max_runtime_ms=60_000)
    tm.register("indices:data/read/search")  # saturate: every admit sheds

    def hit():
        try:
            bp.admit()
        except RejectedExecutionException:
            pass
    return hit


def _drill_breakers():
    from opensearch_tpu_torch.common.breaker import (
        CircuitBreakingException,
        HierarchyBreakerService,
    )

    brk = HierarchyBreakerService(total_bytes=1000, settings={
        "request_limit_bytes": 1 << 30, "parent_limit_bytes": 100,
    })
    brk.request.used = 500  # past the parent limit: every check trips

    def hit():
        try:
            brk.check_parent("race-probe")
        except CircuitBreakingException:
            pass
    return hit


# class name -> setup returning the per-iteration hammer callable
DRILLS = {
    "SearchBackpressureService": _drill_backpressure,
    "HierarchyBreakerService": _drill_breakers,
}


def run_drill(threads: int = 4, per_thread: int = 50,
              targets=None) -> list[str]:
    """Hammer the targeted services from tagged REAL threads (alternating
    data-worker/search-pool roles, the pools that actually call them) so
    the report carries observed evidence. Must run inside probe_scope().

    ``targets`` defaults to ``statically_unroled()`` ∩ DRILLS — services
    the cross-module pass now roles statically are NOT drilled (the
    drill shrink). Pass explicit class names to force a drill (how tests
    re-confirm the services' lock fixes). Returns what was drilled."""
    if targets is None:
        targets = [c for c in statically_unroled() if c in DRILLS]
    hits = [DRILLS[c]() for c in targets]
    if not hits:
        return []
    start = threading.Barrier(threads)
    roles = (ROLE_DATA, ROLE_SEARCH)

    def hammer(role):
        start.wait()
        with role_scope(role):
            for _ in range(per_thread):
                for hit in hits:
                    hit()

    workers = [threading.Thread(target=hammer, args=(roles[i % 2],))
               for i in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    return list(targets)


def main(argv: list[str] | None = None) -> int:
    import argparse
    import json
    import tempfile

    parser = argparse.ArgumentParser(
        description="runtime race confirmation: one seeded soak cycle + "
                    "a threaded drill under lock/role instrumentation")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--cycles", type=int, default=1)
    parser.add_argument("--ops", type=int, default=20)
    parser.add_argument("--no-soak", action="store_true",
                        help="drill only (skip the seeded soak cycle)")
    parser.add_argument("--tcp", action="store_true",
                        help="drive the TcpSoak reshape chain (real "
                             "sockets, real pools; invariants-only) under "
                             "the probe instead of the sim soak")
    parser.add_argument("--seconds", type=float, default=45.0,
                        help="--tcp: wall-clock budget for the reshape "
                             "chain (default 45)")
    parser.add_argument("--device", default="cuda",
                        help="where the soak's nodes run: cuda (the "
                             "default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    if args.tcp:
        # import the full server stack BEFORE the patches land: stdlib
        # modules construct module-level locks at import time and must
        # get real ones
        import opensearch_tpu_torch.testing.soak_tcp  # noqa: F401

    with probe_scope() as probe:
        if args.tcp:
            import asyncio
            from pathlib import Path

            from opensearch_tpu_torch.testing.soak_tcp import (
                TcpSoak,
                TcpSoakError,
            )

            async def scenario(tmp) -> dict:
                soak = TcpSoak(Path(tmp), seconds=args.seconds,
                               device=args.device)
                try:
                    return await soak.run()
                finally:
                    await soak.stop()

            with tempfile.TemporaryDirectory() as tmp:
                try:
                    asyncio.run(scenario(tmp))
                except TcpSoakError as e:
                    print(f"TCP SOAK FAILED under probe: {e}")
                    return 1
        elif not args.no_soak:
            from opensearch_tpu_torch.testing.soak import run_soak

            with tempfile.TemporaryDirectory() as tmp:
                run_soak(args.seed, tmp, cycles=args.cycles,
                         ops_per_cycle=args.ops, device=args.device)
        drilled = run_drill()
    what = (", ".join(drilled) if drilled else
            "nothing — the cross-module pass roles every watched service")
    print(f"drilled (statically unroled): {what}")
    report = probe.report()
    print(json.dumps(report, indent=1))
    if report["confirmed"]:
        print(f"\n{len(report['confirmed'])} CONFIRMED unlocked cross-role "
              "write(s) — fix them (see lint --explain TPU018)")
        return 1
    print(f"\nok: {len(report['findings'])} watched attribute(s), "
          "zero unconfirmed-unlocked cross-role writes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
