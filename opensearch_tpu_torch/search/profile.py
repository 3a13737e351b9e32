"""Deep per-operator search profiler (the `"profile": true` engine).

Counterpart of opensearch_tpu/search/profile.py, with the same response
shape and key names, so a client's parser reads both packages' output
the same way:

- an OPERATOR TREE: one entry per executed query node, accumulated across
  the shard's segments, with the classic create_weight / build_scorer /
  score breakdown analogs;
- device fields per operator and per shard: `device_time_in_nanos` (a
  kernel's wall bracketed by ``torch.cuda.synchronize`` on its device
  before and after the launch; without the fences asynchronous launches
  bill the kernel to whoever copies the result later), `transfer_bytes`
  (host-resident arguments shipped to the device for this request:
  numpy arrays and host sequences; a tensor, already on the node's
  device, counts 0), and `retraced` (the first launch in this process
  under this kernel name and argument signature);
- the fetch phase's sub-phase timings (:class:`FetchProfiler`).

The active profiler rides a contextvar (`profiling(...)` scope) so the
executor and the ops' entry points record into it without a handle
threaded through every signature. When no profiler is active an
instrumented path costs one contextvar read and no fence.

Each kernel row carries its family's roofline fields
(telemetry/roofline.py: EWMA achieved GFLOP/s, arithmetic intensity,
fraction of the calibrated roofline, bound verdict), and each fenced
``profiled_kernel`` launch is folded into the roofline from its argument
shapes and, the first time under its signature, counts one entry in the
device-residency ledger's compile table.
"""

from __future__ import annotations

import contextvars
import functools
import time
from typing import Any, Callable

import torch

_active_profiler: contextvars.ContextVar["ShardProfiler | None"] = (
    contextvars.ContextVar("opensearch_tpu_torch_active_profiler",
                           default=None)
)

# (kernel name, argument signature) pairs this process has launched
# before; a miss flags the launch as the first under its signature
_seen_kernel_signatures: set[tuple] = set()


def active() -> "ShardProfiler | None":
    return _active_profiler.get()


class _ProfilingScope:
    __slots__ = ("_profiler", "_token")

    def __init__(self, profiler: "ShardProfiler | None"):
        self._profiler = profiler

    def __enter__(self) -> "ShardProfiler | None":
        self._token = _active_profiler.set(self._profiler)
        return self._profiler

    def __exit__(self, exc_type, exc, tb):
        _active_profiler.reset(self._token)
        return False


def profiling(profiler: "ShardProfiler | None") -> _ProfilingScope:
    return _ProfilingScope(profiler)


class OpProfile:
    """One operator node of the profile tree, accumulated across segments
    (the same query node executes once per segment of the shard)."""

    __slots__ = ("type", "description", "time_ns", "device_ns",
                 "transfer_bytes", "retraced", "kernels", "children",
                 "_child_index", "calls", "kernel_annotations")

    def __init__(self, type_: str, description: str):
        self.type = type_
        self.description = description
        self.time_ns = 0
        self.device_ns = 0
        self.transfer_bytes = 0
        self.retraced = False
        self.calls = 0
        # kernel name -> [calls, time_ns, transfer_bytes, retraces]
        self.kernels: dict[str, list] = {}
        # kernel name -> static launch configuration, merged PER KEY: a key
        # whose records disagree keeps every distinct value as a list
        self.kernel_annotations: dict[str, dict] = {}
        self.children: list[OpProfile] = []
        self._child_index: dict[tuple[str, str], OpProfile] = {}

    def child(self, type_: str, description: str) -> "OpProfile":
        key = (type_, description)
        op = self._child_index.get(key)
        if op is None:
            op = OpProfile(type_, description)
            self._child_index[key] = op
            self.children.append(op)
        return op

    def record_kernel(self, name: str, time_ns: int, transfer_bytes: int,
                      retraced: bool, annotations: dict | None = None) -> None:
        self.device_ns += time_ns
        self.transfer_bytes += transfer_bytes
        self.retraced = self.retraced or retraced
        cell = self.kernels.setdefault(name, [0, 0, 0, 0])
        cell[0] += 1
        cell[1] += time_ns
        cell[2] += transfer_bytes
        cell[3] += int(retraced)
        if annotations:
            merged = self.kernel_annotations.setdefault(name, {})
            for key, value in annotations.items():
                have = merged.get(key)
                if key not in merged:
                    merged[key] = value
                elif isinstance(have, list):
                    if value not in have:
                        have.append(value)
                elif have != value:
                    merged[key] = [have, value]

    def to_dict(self) -> dict:
        # children's wall time is nested inside self.time_ns (inclusive),
        # so the host-side share is self minus device minus children
        child_ns = sum(c.time_ns for c in self.children)
        host_ns = max(self.time_ns - self.device_ns - child_ns, 0)
        out: dict[str, Any] = {
            "type": self.type,
            "description": self.description,
            "time_in_nanos": self.time_ns,
            "breakdown": {
                # Lucene analogs: create_weight ~ host-side query prep,
                # build_scorer ~ kernel launches, score ~ device scoring
                # time, next_doc ~ folded into score (vectorized)
                "create_weight": host_ns, "create_weight_count": self.calls,
                "build_scorer": 0, "build_scorer_count": self.calls,
                "score": self.device_ns,
                "score_count": self.calls,
                "next_doc": 0, "next_doc_count": 0,
            },
            "device_time_in_nanos": self.device_ns,
            "transfer_bytes": self.transfer_bytes,
            "retraced": self.retraced,
        }
        if self.kernels:
            from opensearch_tpu_torch.telemetry.roofline import (
                default_recorder,
            )

            out["kernels"] = [
                {"name": name, "calls": c[0], "time_in_nanos": c[1],
                 "transfer_bytes": c[2], "retraces": c[3],
                 **default_recorder.kernel_row_fields(name),
                 **(self.kernel_annotations.get(name) or {})}
                for name, c in sorted(self.kernels.items())
            ]
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        return out


class ShardProfiler:
    """Collects one shard's query-phase profile: the operator tree,
    rewrite time, collector (top-k) time and the shard-level device
    totals."""

    def __init__(self) -> None:
        self._root = OpProfile("<root>", "")
        self._stack: list[OpProfile] = [self._root]
        self.rewrite_ns = 0
        self.collect_ns = 0
        # sharded-launch records (record_sharded_launch): one entry per
        # device launch this shard took part in; every shard covered by
        # the same launch carries the same launch_id
        self.launches: list[dict] = []

    # -- operator tree ------------------------------------------------------

    class _OpScope:
        __slots__ = ("_profiler", "_op", "_t0")

        def __init__(self, profiler: "ShardProfiler", op: "OpProfile"):
            self._profiler = profiler
            self._op = op

        def __enter__(self) -> "OpProfile":
            self._profiler._stack.append(self._op)
            self._op.calls += 1
            self._t0 = time.perf_counter_ns()
            return self._op

        def __exit__(self, exc_type, exc, tb):
            self._op.time_ns += time.perf_counter_ns() - self._t0
            self._profiler._stack.pop()
            return False

    def operator(self, type_: str, description: str) -> "_OpScope":
        op = self._stack[-1].child(type_, description)
        return ShardProfiler._OpScope(self, op)

    def record_kernel(self, name: str, time_ns: int, transfer_bytes: int,
                      retraced: bool, annotations: dict | None = None) -> None:
        self._stack[-1].record_kernel(name, time_ns, transfer_bytes, retraced,
                                      annotations)

    def record_sharded_launch(self, type_: str, description: str, *,
                              name: str, launch_id: int, shards: int,
                              wall_ns: int, transfer_bytes: int,
                              retraced: bool) -> None:
        """Attribute this shard's share of ONE stacked device launch (the
        serving step covers S shards in a single launch). The fenced launch
        wall splits evenly across the shards it served; the shared
        `launch_id` is how a reader of the per-shard entries proves they
        came from one launch, not S."""
        op = self._stack[-1].child(type_, description)
        op.calls += 1
        share = wall_ns // max(shards, 1)
        op.time_ns += share
        op.record_kernel(name, share, transfer_bytes, retraced)
        self.launches.append({
            "name": name, "launch_id": launch_id, "shards": shards,
            "wall_ns": wall_ns, "share_ns": share, "retraced": retraced,
        })

    # -- rollups ------------------------------------------------------------

    @property
    def roots(self) -> list[OpProfile]:
        return self._root.children

    def _totals(self) -> tuple[int, int, bool]:
        device = transfer = 0
        retraced = False
        stack = list(self.roots)
        while stack:
            op = stack.pop()
            device += op.device_ns
            transfer += op.transfer_bytes
            retraced = retraced or op.retraced
            stack.extend(op.children)
        return device, transfer, retraced

    def query_entries(self) -> list[dict]:
        return [op.to_dict() for op in self.roots]

    def tpu_summary(self) -> dict:
        """The shard-level device rollup, under the reference's key names
        (the response's `tpu` section)."""
        device, transfer, retraced = self._totals()
        out = {
            "device_time_in_nanos": device,
            "transfer_bytes": transfer,
            "jit_retrace": retraced,
        }
        if self.launches:
            out["launches"] = list(self.launches)
        return out


# fetch sub-phase keys -> the reference's subphase class names
FETCH_SUBPHASES = {
    "load_source": "FetchSourcePhase",
    "docvalue_fields": "FetchDocValuesPhase",
    "fields": "FetchFieldsPhase",
    "stored_fields": "StoredFieldsPhase",
    "highlight": "HighlightPhase",
    "script_fields": "ScriptFieldsPhase",
    "explain": "ExplainPhase",
}


class FetchProfiler:
    """Per-shard fetch-phase sub-phase timings: the `"profile": true`
    coverage for fetch that the operator tree gives the query phase. One
    instance covers one search request; hits attribute to the shard they
    came from."""

    def __init__(self, n_shards: int) -> None:
        # shard idx -> {subphase: [time_ns, count]}
        self._phases: list[dict[str, list[int]]] = [
            {} for _ in range(n_shards)
        ]
        self._hits: list[int] = [0] * n_shards

    def hit(self, shard_idx: int) -> None:
        self._hits[shard_idx] += 1

    def add(self, shard_idx: int, phase: str, t0_ns: int) -> None:
        cell = self._phases[shard_idx].setdefault(phase, [0, 0])
        cell[0] += time.perf_counter_ns() - t0_ns
        cell[1] += 1

    def entry(self, shard_idx: int) -> dict:
        phases = self._phases[shard_idx]
        total = sum(c[0] for c in phases.values())
        breakdown: dict[str, int] = {}
        children = []
        for key, cls in FETCH_SUBPHASES.items():
            ns, count = phases.get(key, (0, 0))
            breakdown[key] = ns
            breakdown[f"{key}_count"] = count
            if count:
                children.append({
                    "type": cls, "description": key,
                    "time_in_nanos": ns,
                    "breakdown": {key: ns, f"{key}_count": count},
                })
        return {
            "type": "fetch",
            "description": "fetch",
            "time_in_nanos": total,
            "breakdown": breakdown,
            "debug": {"hits_fetched": self._hits[shard_idx]},
            "children": children,
        }


def describe_node(node: Any) -> str:
    """Compact operator description: the node's salient config, not the
    whole query JSON."""
    parts = []
    for attr in ("field", "fields", "query", "value", "values", "k"):
        v = getattr(node, attr, None)
        if v is None:
            continue
        text = str(v)
        if len(text) > 64:
            text = text[:61] + "..."
        parts.append(f"{attr}={text}")
    return " ".join(parts)


def _host_bytes(value: Any) -> int:
    """Bytes this argument ships host->device: numpy arrays and host
    sequences count; a tensor counts 0 (it already lies on the device the
    kernel runs on: a wrapper moves no tensor)."""
    if isinstance(value, torch.Tensor):
        return 0
    nbytes = getattr(value, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    if isinstance(value, (list, tuple)):
        return 8 * len(value)
    if isinstance(value, (int, float, bool)):
        return 8
    return 0


def _signature(name: str, args: tuple, kwargs: dict) -> tuple:
    parts: list = [name]
    for a in args:
        shape = getattr(a, "shape", None)
        if shape is not None:
            parts.append((tuple(shape), str(getattr(a, "dtype", ""))))
        elif isinstance(a, (list, tuple)):
            parts.append(("seq", len(a)))
        else:
            parts.append(type(a).__name__)
    for k in sorted(kwargs):
        parts.append((k, str(kwargs[k])))
    return tuple(parts)


def _cuda_devices(args: tuple, kwargs: dict) -> set:
    return {a.device for a in (*args, *kwargs.values())
            if isinstance(a, torch.Tensor) and a.device.type == "cuda"}


def signature_retraced(name: str, args: tuple, static: tuple = ()) -> bool:
    """True the first time this process sees the (name, argument shapes,
    static config) combination: for the launch sites the decorator cannot
    wrap (the batcher's launch closures)."""
    sig = _signature(name, args, {"static": static})
    retraced = sig not in _seen_kernel_signatures
    _seen_kernel_signatures.add(sig)
    return retraced


def profiled_kernel(name: str) -> Callable:
    """Decorator for device kernel entry points: while a profiler is
    active, fence the launch with ``torch.cuda.synchronize`` on each CUDA
    device among its arguments (before and after), count host->device
    transfer bytes, and flag first-seen argument signatures. A profiled
    kernel called inside another records nothing of its own: the outer
    one's wall covers it. With no profiler active: one contextvar read."""

    def deco(fn: Callable) -> Callable:

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            prof = _active_profiler.get()
            if prof is None:
                return fn(*args, **kwargs)
            transfer = sum(_host_bytes(a) for a in args)
            transfer += sum(_host_bytes(v) for v in kwargs.values())
            sig = _signature(name, args, kwargs)
            retraced = sig not in _seen_kernel_signatures
            _seen_kernel_signatures.add(sig)
            devices = _cuda_devices(args, kwargs)
            for dev in devices:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter_ns()
            with profiling(None):
                out = fn(*args, **kwargs)
            for dev in devices:
                torch.cuda.synchronize(dev)
            elapsed = time.perf_counter_ns() - t0
            prof.record_kernel(name, elapsed, transfer, retraced)
            # roofline accounting: the fenced wall and the call's argument
            # shapes are what the family's cost model needs
            from opensearch_tpu_torch.telemetry import roofline
            from opensearch_tpu_torch.telemetry.device_ledger import (
                default_ledger,
            )

            roofline.observe_kernel(name, args, kwargs, elapsed)
            if retraced:
                # first launch under this signature: one entry for the
                # family in the ledger's compile table (its wall includes
                # any kernel build)
                default_ledger.record_compile(name, elapsed)
            return out

        return wrapper

    return deco
