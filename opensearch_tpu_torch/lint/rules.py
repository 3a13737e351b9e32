"""The tpulint rules (TPU001–TPU019).

TPU001-TPU007 are single AST walks with a small amount of per-file context
(scope, decorators, held locks). TPU008 and TPU010 sit on the dataflow
layer in lint/cfg.py: a per-function CFG with path-sensitive walks
(callback-leak) and a call-graph/summary pass (interprocedural lock
order). They are deliberately heuristic: the goal is catching the
invariant breaks that have bitten this codebase (host syncs under jit,
wall-clock in sim-run modules, swallowed exceptions, dropped transport
listeners, unbounded serving-path buffers), not a sound type system.
False positives are absorbed by the baseline ratchet or a
``# tpulint: disable=`` comment.
"""

from __future__ import annotations

import ast
from typing import Iterable

from opensearch_tpu_torch.lint import cfg as cfg_mod
from opensearch_tpu_torch.lint import threadroles
from opensearch_tpu_torch.lint.core import (
    Checker,
    FileContext,
    Violation,
    call_name,
    dotted_name,
)

# ---------------------------------------------------------------------------
# TPU001 — compile purity (torch.compile / TorchScript regions)
# ---------------------------------------------------------------------------

# the wrappers whose decorated or wrapped function torch traces or compiles
# into a graph: a host sync there breaks the graph (or, under
# torch.jit.trace, is baked in as a constant), and a branch on a tensor's
# value is taken once at trace time
_COMPILE_ENTRIES = frozenset({"torch.compile", "torch.jit.script",
                              "torch.jit.trace"})
# attribute reads that are static in a compiled region (no tensor data)
_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout",
                 "requires_grad", "is_sparse"}
# tensor methods that read metadata, not data
_STATIC_METHODS = {"size", "dim", "numel", "stride", "element_size",
                   "is_contiguous"}
# torch namespaces whose calls do not produce tensors from tensor data
_UNTRACED_TORCH = ("torch.cuda.", "torch.jit.", "torch.compiler.",
                   "torch._dynamo.", "torch.backends.")
# tensor methods that copy to the host and wait for the card
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# host-sync call targets (full dotted names) taking a tensor argument
_HOST_SYNC_CALLS = {
    "np.asarray", "numpy.asarray", "np.array", "numpy.array",
}
_STATIC_BUILTINS = {"len", "isinstance", "type", "range", "enumerate",
                    "zip", "hasattr", "getattr", "min", "max"}


def _is_compile_entry(ctx: FileContext, name: str | None) -> bool:
    return ctx.canonical(name) in _COMPILE_ENTRIES


class _TracedFunctionFinder(ast.NodeVisitor):
    """Collect every function that torch compiles or traces: decorated
    with torch.compile / torch.jit.script / torch.jit.trace (directly,
    called with options, or via functools.partial), or passed by name into
    such a call (``torch.compile(f)``, ``torch.jit.trace(f, example)``)."""

    def __init__(self, ctx: FileContext) -> None:
        self.ctx = ctx
        self.defs_by_name: dict[str, list[ast.FunctionDef]] = {}
        self.traced: dict[ast.AST, set[str]] = {}
        self._calls: list[ast.Call] = []

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.defs_by_name.setdefault(node.name, []).append(node)
        for dec in node.decorator_list:
            if _is_compile_entry(self.ctx, dotted_name(dec)):
                self.traced.setdefault(node, set())
            elif isinstance(dec, ast.Call):
                dec_name = call_name(dec)
                if _is_compile_entry(self.ctx, dec_name):
                    self.traced.setdefault(node, set())
                elif dec_name is not None and \
                        dec_name.split(".")[-1] == "partial":
                    # @functools.partial(torch.compile, mode=...)
                    if dec.args and _is_compile_entry(
                            self.ctx, dotted_name(dec.args[0])):
                        self.traced.setdefault(node, set())
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Call(self, node: ast.Call) -> None:
        if _is_compile_entry(self.ctx, call_name(node)):
            self._calls.append(node)
        self.generic_visit(node)

    def resolve_wrapped(self) -> None:
        """torch.compile(f) / torch.jit.trace(f, ...): mark the named
        function (through a functools.partial, whose keyword-bound names
        are fixed at wrap time)."""
        for call in self._calls:
            targets: list[tuple[ast.AST, set[str]]] = [
                (t, set()) for t in call.args[:1]]
            for t, st in list(targets):
                if isinstance(t, ast.Call):
                    tn = call_name(t)
                    if tn is not None and tn.split(".")[-1] == "partial" \
                            and t.args:
                        bound = {kw.arg for kw in t.keywords if kw.arg}
                        targets.append((t.args[0], st | bound))
            for t, st in targets:
                if isinstance(t, ast.Name):
                    for fn in self.defs_by_name.get(t.id, ()):
                        self.traced.setdefault(fn, set()).update(st)
                elif isinstance(t, ast.Lambda):
                    self.traced.setdefault(t, set())


def _mentions_traced(node: ast.AST, traced: set[str]) -> bool:
    """Does this expression carry tensor data? Shape, dtype and device
    reads, metadata methods and static builtins don't count."""
    if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
        return False
    if isinstance(node, ast.Call):
        name = call_name(node)
        if name in _STATIC_BUILTINS:
            return False
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _STATIC_METHODS:
            return False
        if name is not None and name.startswith("torch.") and \
                not name.startswith(_UNTRACED_TORCH):
            return True
    if isinstance(node, ast.Name):
        return node.id in traced
    if isinstance(node, ast.Compare):
        # `x is None` / `x is not None` is resolved at trace time
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return False
    return any(_mentions_traced(c, traced) for c in ast.iter_child_nodes(node))


class _PurityVisitor(ast.NodeVisitor):
    """Walk ONE compiled function body, tracking which local names carry
    tensors, and flag impurities."""

    def __init__(self, ctx: FileContext, fn: ast.AST, statics: set[str]):
        self.ctx = ctx
        self.out: list[Violation] = []
        self.traced: set[str] = set()
        self.local_names: set[str] = set()
        args = getattr(fn, "args", None)
        if args is not None:
            params = [a.arg for a in
                      args.posonlyargs + args.args + args.kwonlyargs]
            if args.vararg:
                params.append(args.vararg.arg)
            if args.kwarg:
                params.append(args.kwarg.arg)
            self.local_names.update(params)
            # params with str/bool/None defaults are configuration, not
            # tensors: torch specializes on them
            static_by_default: set[str] = set()
            pos = args.posonlyargs + args.args
            for param, default in zip(pos[len(pos) - len(args.defaults):],
                                      args.defaults):
                if isinstance(default, ast.Constant) and isinstance(
                        default.value, (str, bool, type(None))):
                    static_by_default.add(param.arg)
            for param, default in zip(args.kwonlyargs, args.kw_defaults):
                if isinstance(default, ast.Constant) and isinstance(
                        default.value, (str, bool, type(None))):
                    static_by_default.add(param.arg)
            self.traced.update(p for p in params
                               if p not in statics and p not in static_by_default)
            self.traced.discard("self")

    def _flag(self, node: ast.AST, message: str) -> None:
        self.out.append(self.ctx.violation("TPU001", node, message))

    # -- name tracking -----------------------------------------------------

    def _bind(self, target: ast.AST, value_traced: bool) -> None:
        for node in ast.walk(target):
            if isinstance(node, ast.Name):
                self.local_names.add(node.id)
                if value_traced:
                    self.traced.add(node.id)
                else:
                    self.traced.discard(node.id)

    def visit_Assign(self, node: ast.Assign) -> None:
        self.visit(node.value)
        traced = _mentions_traced(node.value, self.traced)
        for t in node.targets:
            self._check_mutation(t, node)
            self._bind(t, traced)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self.visit(node.value)
            self._check_mutation(node.target, node)
            self._bind(node.target, _mentions_traced(node.value, self.traced))

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.visit(node.value)
        self._check_mutation(node.target, node)
        if isinstance(node.target, ast.Name):
            self.local_names.add(node.target.id)
            if _mentions_traced(node.value, self.traced):
                self.traced.add(node.target.id)

    def visit_For(self, node: ast.For) -> None:
        self.visit(node.iter)
        self._bind(node.target, _mentions_traced(node.iter, self.traced))
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    # -- impurities --------------------------------------------------------

    def _check_mutation(self, target: ast.AST, stmt: ast.AST) -> None:
        """Assignment through an Attribute/Subscript whose root is not a
        local: Python-level mutation of nonlocal state in a compiled
        region (a graph break, or a side effect torch.jit.trace drops)."""
        root = target
        seen_deref = False
        while isinstance(root, (ast.Attribute, ast.Subscript)):
            seen_deref = True
            root = root.value
        if not seen_deref:
            return
        if isinstance(root, ast.Name):
            if root.id == "self" or root.id not in self.local_names:
                self._flag(stmt, (
                    f"mutation of nonlocal state "
                    f"[{dotted_name(target) or ast.unparse(target)}] inside a "
                    "compiled function (a graph break under torch.compile, "
                    "dropped by torch.jit.trace)"
                ))

    def visit_Global(self, node: ast.Global) -> None:
        self._flag(node, "global statement inside a compiled function "
                         "(nonlocal mutation breaks the graph)")

    def visit_Nonlocal(self, node: ast.Nonlocal) -> None:
        self._flag(node, "nonlocal statement inside a compiled function "
                         "(nonlocal mutation breaks the graph)")

    def visit_Call(self, node: ast.Call) -> None:
        name = call_name(node)
        method = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        if method in _HOST_SYNC_METHODS and _mentions_traced(
                node.func.value, self.traced):
            self._flag(node, f".{method}() on a tensor forces a host sync "
                             "(device->host copy) inside the compiled region")
        elif method == "synchronize":
            self._flag(node, f"{name or '.synchronize'}() inside a compiled "
                             "function waits for the card (a host sync)")
        elif name in _HOST_SYNC_CALLS and any(
                _mentions_traced(a, self.traced) for a in node.args):
            self._flag(node, f"{name}() on a tensor forces a host sync "
                             "(device->host copy) inside the compiled region")
        elif name in ("float", "int", "bool") and node.args and any(
                _mentions_traced(a, self.traced) for a in node.args):
            self._flag(node, f"{name}() on a tensor reads its value on the "
                             "host (a host sync and a graph break)")
        self.generic_visit(node)

    def visit_If(self, node: ast.If) -> None:
        if _mentions_traced(node.test, self.traced):
            self._flag(node, "data-dependent `if` on a tensor value inside "
                             "a compiled function; use torch.where / "
                             "torch.cond")
        self.visit(node.test)
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    def visit_While(self, node: ast.While) -> None:
        if _mentions_traced(node.test, self.traced):
            self._flag(node, "data-dependent `while` on a tensor value "
                             "inside a compiled function; bound the loop "
                             "by a shape or use torch.where")
        self.visit(node.test)
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    # nested defs inherit the outer compiled scope via the finder (they
    # are compiled too); don't double-walk them here
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.local_names.add(node.name)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass


class JitPurityChecker(Checker):
    """TPU001 in the port: the port compiles nothing today (no
    torch.compile, torch.jit or CUDA graph), and this rule holds that a
    region that does is pure. Inside a function decorated with, or wrapped
    by, torch.compile / torch.jit.script / torch.jit.trace there are no
    host syncs (``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``.synchronize()``, float/int/bool or np.asarray of a tensor), no
    mutation of nonlocal state, and no ``if`` / ``while`` on a tensor's
    value: each is a graph break under torch.compile, and a value that
    torch.jit.trace bakes in once."""

    rule_id = "TPU001"
    name = "jit-purity"
    description = ("host syncs, nonlocal mutation, and data-dependent "
                   "control flow inside torch.compile / torch.jit "
                   "compiled functions")

    def applies_to(self, display_path: str, source: str) -> bool:
        return "compile" in source or "jit" in source

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        finder = _TracedFunctionFinder(ctx)
        finder.visit(ctx.tree)
        finder.resolve_wrapped()
        out: list[Violation] = []
        for fn, statics in finder.traced.items():
            visitor = _PurityVisitor(ctx, fn, statics)
            body = fn.body if isinstance(fn.body, list) else [fn.body]
            for stmt in body:
                visitor.visit(stmt)
            out.extend(visitor.out)
            # nested defs inside a compiled function are compiled as well
            for stmt in body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.FunctionDef) and sub not in finder.traced:
                        nested = _PurityVisitor(ctx, sub, statics)
                        for s in sub.body:
                            nested.visit(s)
                        out.extend(nested.out)
        return out


# ---------------------------------------------------------------------------
# TPU002 — blocking calls in async code
# ---------------------------------------------------------------------------

_BLOCKING_PREFIXES = ("socket.", "requests.", "urllib.request.", "subprocess.")
_BLOCKING_CALLS = {"time.sleep", "open"}


class _AsyncBodyVisitor(ast.NodeVisitor):
    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.out: list[Violation] = []
        self._awaited_calls: set[int] = set()

    def visit_Await(self, node: ast.Await) -> None:
        if isinstance(node.value, ast.Call):
            self._awaited_calls.add(id(node.value))
        self.generic_visit(node)

    # a nested sync def is a callback that may run off-loop; don't flag it.
    # nested ASYNC defs are skipped too — the outer walk in check() visits
    # every AsyncFunctionDef separately (descending here double-reports)
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Call(self, node: ast.Call) -> None:
        name = self.ctx.canonical(call_name(node))
        if name in _BLOCKING_CALLS:
            what = ("time.sleep() blocks the event loop; use await "
                    "asyncio.sleep" if name == "time.sleep"
                    else "open() is blocking file IO on the event loop")
            self.out.append(self.ctx.violation("TPU002", node, what))
        elif name is not None and name.startswith(_BLOCKING_PREFIXES):
            self.out.append(self.ctx.violation(
                "TPU002", node,
                f"{name}() is blocking IO inside an async function"))
        elif (
            name is not None
            and name.split(".")[-1] == "acquire"
            and id(node) not in self._awaited_calls
            and not any(kw.arg in ("timeout", "blocking") for kw in node.keywords)
            and not node.args
        ):
            self.out.append(self.ctx.violation(
                "TPU002", node,
                f"{name}() without a timeout can deadlock the event loop; "
                "pass timeout= or use an asyncio primitive"))
        self.generic_visit(node)


class BlockingInAsyncChecker(Checker):
    rule_id = "TPU002"
    name = "blocking-in-async"
    description = ("time.sleep, blocking socket/file IO, and untimed "
                   "Lock.acquire inside async def bodies")

    def applies_to(self, display_path: str, source: str) -> bool:
        return "async def" in source

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        out: list[Violation] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.AsyncFunctionDef):
                v = _AsyncBodyVisitor(ctx)
                # two passes: collect awaited calls first so `await
                # lock.acquire()` is not flagged regardless of walk order
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Await) and isinstance(sub.value, ast.Call):
                        v._awaited_calls.add(id(sub.value))
                for stmt in node.body:
                    v.visit(stmt)
                out.extend(v.out)
        return out


# ---------------------------------------------------------------------------
# TPU003 — lock discipline
# ---------------------------------------------------------------------------

_LOCK_FACTORIES = ("Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore")
# methods where lock-free access is fine: object is not yet / no longer shared
_EXEMPT_METHODS = {"__init__", "__new__", "__del__", "__repr__", "__str__",
                   "__enter__", "__exit__"}


class _MethodLockScan(ast.NodeVisitor):
    """Scan one method, tracking which of the class's locks are held."""

    def __init__(self, lock_attrs: set[str], method: str):
        self.lock_attrs = lock_attrs
        self.method = method
        self.held: list[str] = []
        # (attr, line, col, is_store, frozenset(held), node)
        self.accesses: list[tuple] = []
        # ordered pairs (outer, inner) -> node of the inner acquisition
        self.pairs: dict[tuple[str, str], ast.AST] = {}

    def _self_attr(self, node: ast.AST) -> str | None:
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        return None

    def visit_With(self, node: ast.With) -> None:
        acquired: list[str] = []
        for item in node.items:
            attr = self._self_attr(item.context_expr)
            if attr is not None and attr in self.lock_attrs:
                for outer in self.held + acquired:
                    if outer != attr:
                        self.pairs.setdefault((outer, attr), item.context_expr)
                acquired.append(attr)
            else:
                self.visit(item.context_expr)
        self.held.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        if acquired:
            del self.held[-len(acquired):]

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = self._self_attr(node)
        if attr is not None and attr not in self.lock_attrs:
            self.accesses.append((
                attr, node.lineno, node.col_offset,
                isinstance(node.ctx, (ast.Store, ast.Del)),
                frozenset(self.held), node,
            ))
        self.generic_visit(node)

    # nested defs (callbacks) run later, possibly without the lock — skip
    # them for held-lock accounting but still record their accesses as
    # unlocked? Too noisy: skip entirely.
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]
    visit_Lambda = visit_FunctionDef  # type: ignore[assignment]


class LockDisciplineChecker(Checker):
    rule_id = "TPU003"
    name = "lock-discipline"
    description = ("attributes written under a lock accessed lock-free "
                   "elsewhere in the class; inconsistent lock acquisition "
                   "order")

    def applies_to(self, display_path: str, source: str) -> bool:
        return "Lock" in source or "_lock" in source or "Semaphore" in source

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        out: list[Violation] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                out.extend(self._check_class(ctx, node))
        return out

    def _lock_attrs(self, cls: ast.ClassDef) -> set[str]:
        locks: set[str] = set()
        for node in ast.walk(cls):
            # self.X = threading.Lock() (or RLock/Condition/Semaphore)
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                name = call_name(node.value)
                if name is not None and name.split(".")[-1] in _LOCK_FACTORIES:
                    for t in node.targets:
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            locks.add(t.attr)
            # `with self.X:` on an attr that looks like a lock
            if isinstance(node, ast.With):
                for item in node.items:
                    e = item.context_expr
                    if (isinstance(e, ast.Attribute)
                            and isinstance(e.value, ast.Name)
                            and e.value.id == "self"
                            and "lock" in e.attr.lower()):
                        locks.add(e.attr)
        return locks

    def _check_class(self, ctx: FileContext, cls: ast.ClassDef) -> list[Violation]:
        locks = self._lock_attrs(cls)
        if not locks:
            return []
        scans: list[_MethodLockScan] = []
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan = _MethodLockScan(locks, item.name)
                for stmt in item.body:
                    scan.visit(stmt)
                scans.append(scan)

        # which attrs are written under which lock (outside exempt methods)
        guarded: dict[str, set[str]] = {}
        writer: dict[str, str] = {}
        for scan in scans:
            if scan.method in _EXEMPT_METHODS:
                continue
            for attr, _line, _col, is_store, held, _node in scan.accesses:
                if is_store and held:
                    guarded.setdefault(attr, set()).update(held)
                    writer.setdefault(attr, scan.method)

        out: list[Violation] = []
        for scan in scans:
            if scan.method in _EXEMPT_METHODS:
                continue
            for attr, _line, _col, _is_store, held, node in scan.accesses:
                need = guarded.get(attr)
                if need and not (held & need):
                    lock_names = "/".join(f"self.{n}" for n in sorted(need))
                    out.append(ctx.violation(
                        "TPU003", node,
                        f"self.{attr} is written under {lock_names} "
                        f"(in {writer[attr]}()) but accessed here in "
                        f"{scan.method}() without holding it"))

        # inconsistent lock ordering across the whole class
        all_pairs: dict[tuple[str, str], ast.AST] = {}
        for scan in scans:
            for pair, node in scan.pairs.items():
                all_pairs.setdefault(pair, node)
        for (a, b) in sorted(all_pairs):
            if (b, a) in all_pairs and a < b:
                out.append(ctx.violation(
                    "TPU003", all_pairs[(b, a)],
                    f"locks self.{a} and self.{b} are acquired in both "
                    f"orders in class {cls.name} (deadlock risk)"))
        return out


# ---------------------------------------------------------------------------
# TPU004 — determinism in sim-run modules
# ---------------------------------------------------------------------------

# module path fragments that run under testing/sim.py's virtual time
_SIM_MODULE_PATTERNS = (
    "opensearch_tpu_torch/cluster/",
    "opensearch_tpu_torch/transport/",
    "opensearch_tpu_torch/index/recovery.py",
)
# a file can opt in explicitly (fixtures, new sim-run modules); the marker
# must START a line so a source file merely MENTIONING it (this one) does
# not opt itself in
_SIM_MARKER = "# tpulint: deterministic-module"
_SIM_MARKER_RE = None  # compiled lazily below


def _sim_scoped(display_path: str, source: str) -> bool:
    global _SIM_MARKER_RE
    if any(p in display_path for p in _SIM_MODULE_PATTERNS):
        return True
    if _SIM_MARKER not in source:
        return False
    if _SIM_MARKER_RE is None:
        import re

        _SIM_MARKER_RE = re.compile(
            r"(?m)^\s*" + re.escape(_SIM_MARKER))
    return _SIM_MARKER_RE.search(source) is not None

_WALLCLOCK_CALLS = {
    "time.time", "time.monotonic", "time.perf_counter", "time.time_ns",
    "time.monotonic_ns", "time.perf_counter_ns", "time.sleep",
}
_DATETIME_CALLS = {
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow", "date.today",
    "datetime.date.today",
}
# random.Random(seed) is the FIX (seeded instance), so it is allowed;
# everything else on the global `random` module is unseeded process state
_ALLOWED_RANDOM = {"random.Random", "random.SystemRandom"}


class DeterminismChecker(Checker):
    rule_id = "TPU004"
    name = "determinism"
    description = ("wall-clock time / global random / datetime.now in "
                   "modules that run under the deterministic sim")

    def applies_to(self, display_path: str, source: str) -> bool:
        return _sim_scoped(display_path, source)

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        out: list[Violation] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = ctx.canonical(call_name(node))
            if name is None:
                continue
            if name in _WALLCLOCK_CALLS:
                out.append(ctx.violation(
                    "TPU004", node,
                    f"{name}() in a sim-run module defeats virtual time; "
                    "use the injected clock "
                    "(opensearch_tpu_torch.common.timeutil.epoch_millis/"
                    "monotonic_millis) or the scheduler"))
            elif name in _DATETIME_CALLS:
                out.append(ctx.violation(
                    "TPU004", node,
                    f"{name}() in a sim-run module defeats virtual time; "
                    "derive timestamps from the injected clock"))
            elif (name.startswith("random.")
                  and name not in _ALLOWED_RANDOM):
                out.append(ctx.violation(
                    "TPU004", node,
                    f"{name}() uses the unseeded process-global RNG; use the "
                    "scheduler's seeded random.Random instance"))
        return out


# ---------------------------------------------------------------------------
# TPU006 — injectable entropy in sim-run modules
# ---------------------------------------------------------------------------

# process-entropy id/byte sources: ids minted from these differ run to run,
# so a replayed sim diverges (and a trace id can never be asserted against)
_ENTROPY_CALLS = {
    "uuid.uuid1", "uuid.uuid4", "os.urandom",
    "secrets.token_bytes", "secrets.token_hex", "secrets.token_urlsafe",
    "secrets.randbits", "secrets.randbelow", "secrets.choice",
}


class InjectableIdChecker(Checker):
    rule_id = "TPU006"
    name = "injectable-ids"
    description = ("uuid.uuid4/os.urandom/secrets.* in modules that run "
                   "under the deterministic sim — ids and entropy must come "
                   "from an injectable source (the scheduler's seeded "
                   "random.Random, the tracer's counter)")

    def applies_to(self, display_path: str, source: str) -> bool:
        return _sim_scoped(display_path, source)

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        out: list[Violation] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = ctx.canonical(call_name(node))
            if name in _ENTROPY_CALLS:
                out.append(ctx.violation(
                    "TPU006", node,
                    f"{name}() draws process entropy in a sim-run module; "
                    "mint ids from an injectable source (scheduler.random, "
                    "a seeded Random, or a per-node counter)"))
        return out


# ---------------------------------------------------------------------------
# TPU007 — retracing risk (a compiled function made per call)
# ---------------------------------------------------------------------------

_CACHE_DECORATORS = {"lru_cache", "cache", "cached"}


def _is_cached_def(fn: ast.AST) -> bool:
    for dec in getattr(fn, "decorator_list", ()):
        name = dotted_name(dec) or (
            call_name(dec) if isinstance(dec, ast.Call) else None)
        if name is not None and name.split(".")[-1] in _CACHE_DECORATORS:
            return True
    return False


def _compile_decorated(ctx: FileContext, fn: ast.AST) -> bool:
    """Is ``fn`` decorated with a compile entry (bare or called)?"""
    for dec in getattr(fn, "decorator_list", ()):
        name = dotted_name(dec) or (
            call_name(dec) if isinstance(dec, ast.Call) else None)
        if _is_compile_entry(ctx, name):
            return True
    return False


class _RetraceVisitor(ast.NodeVisitor):
    """Walk one function body looking for compiled functions that cannot
    outlive the call."""

    def __init__(self, ctx: FileContext, fn: ast.AST):
        self.ctx = ctx
        self.fn = fn
        self.out: list[Violation] = []
        self.loop_depth = 0
        # local name -> the compile call that produced it (this scope)
        self._compiled_locals: dict[str, ast.Call] = {}
        self._flagged: set[int] = set()

    def _flag(self, node: ast.AST, message: str) -> None:
        if id(node) not in self._flagged:
            self._flagged.add(id(node))
            self.out.append(self.ctx.violation("TPU007", node, message))

    # -- loops -------------------------------------------------------------

    def visit_For(self, node: ast.For) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_While = visit_For  # type: ignore[assignment]

    # nested defs get their own walk from the checker; don't descend. A
    # nested def decorated with a compile entry is a fresh compiled
    # function on every call of the function that defines it.
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._compiled_locals.pop(node.name, None)
        if not isinstance(self.fn, ast.Module) and \
                not _is_cached_def(self.fn) and \
                _compile_decorated(self.ctx, node):
            self._flag(node, (
                f"[{node.name}] is compiled by a decorator inside "
                f"[{self.fn.name}]: every call of [{self.fn.name}] makes "
                "and compiles a fresh function; hoist it to module scope "
                "or cache the factory (functools.lru_cache)"))

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    # -- bindings ----------------------------------------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        value = node.value
        if isinstance(value, ast.Call) and \
                _is_compile_entry(self.ctx, call_name(value)):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self._compiled_locals[t.id] = value
        else:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self._compiled_locals.pop(t.id, None)

    # -- calls -------------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        name = call_name(node)
        if _is_compile_entry(self.ctx, name) and self.loop_depth > 0:
            self._flag(node, (
                f"fresh {name}() inside a loop compiles a new function "
                "every iteration; hoist it or use a cached factory"))
        # torch.compile(f)(x): the compiled function dies with the
        # expression, so every call compiles from scratch
        if isinstance(node.func, ast.Call) and \
                _is_compile_entry(self.ctx, call_name(node.func)):
            self._flag(node, (
                "immediately-invoked compile wrapper recompiles on every "
                "call; bind the compiled function once (module level or "
                "an lru_cache'd factory) and call that"))
        # local = torch.compile(...); ... local(x) in the SAME uncached
        # function: the function is recompiled on every outer call
        if isinstance(node.func, ast.Name) and \
                node.func.id in self._compiled_locals and \
                not _is_cached_def(self.fn):
            self._flag(node, (
                f"[{node.func.id}] is a fresh compiled function created in "
                "this function and called here: every outer call "
                "recompiles; return it, cache the factory "
                "(functools.lru_cache), or hoist to module scope"))
        self.generic_visit(node)


class RetracingRiskChecker(Checker):
    """TPU007 in the port: no compiled function is made per call. A
    ``torch.compile`` / ``torch.jit.script`` / ``torch.jit.trace`` inside a
    loop, invoked where it is made (``torch.compile(f)(x)``), bound to a
    local and called in the same uncached function, or applied as the
    decorator of a def nested in an uncached function, compiles again on
    every call. A module-level binding or an lru_cache'd factory compiles
    once. The port compiles nothing today; this holds the invariant for
    the first function that does."""

    rule_id = "TPU007"
    name = "retracing-risk"
    description = ("torch.compile / torch.jit functions made per call "
                   "(inside loops, immediately invoked, built and called "
                   "in an uncached function, or decorating a nested def)")

    def applies_to(self, display_path: str, source: str) -> bool:
        return "compile" in source or "jit" in source

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        out: list[Violation] = []
        # module level: only loops and immediate invocation are risks (a
        # module-level binding compiles once, which is the fix)
        module_fn = ast.Module(body=[], type_ignores=[])
        visitors = [(_RetraceVisitor(ctx, module_fn), ctx.tree, True)]
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visitors.append((_RetraceVisitor(ctx, node), node, False))
        for visitor, root, is_module in visitors:
            body = root.body if isinstance(root.body, list) else [root.body]
            for stmt in body:
                if is_module and isinstance(
                        stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                visitor.visit(stmt)
            if is_module:
                # a module-level `name = torch.compile(...)` binding is the
                # recommended pattern: drop the built-and-called flags
                visitor.out = [
                    v for v in visitor.out if "created in this" not in v.message
                ]
            out.extend(visitor.out)
        return out


# ---------------------------------------------------------------------------
# TPU005 — exception hygiene
# ---------------------------------------------------------------------------

_LOG_LAST_SEGMENTS = {"debug", "info", "warning", "warn", "error",
                      "exception", "critical", "log", "print_exc",
                      "format_exc"}
_LOG_FIRST_SEGMENTS = {"logger", "logging", "log", "warnings", "traceback"}
_RECORD_SUBSTRINGS = ("err", "fail", "drop", "reject", "miss", "bad",
                      "invalid", "skip", "exc")


def _body_handles_error(handler: ast.ExceptHandler) -> bool:
    bound = handler.name
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if bound and isinstance(node, ast.Name) and node.id == bound:
            return True
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name is not None:
                segs = name.split(".")
                if segs[-1] in _LOG_LAST_SEGMENTS or segs[0] in _LOG_FIRST_SEGMENTS:
                    return True
                if name == "sys.exc_info":
                    return True
        # counting the failure (self.stats["dropped"] += 1, errors.append)
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for part in ast.walk(t):
                    text = None
                    if isinstance(part, ast.Name):
                        text = part.id
                    elif isinstance(part, ast.Attribute):
                        text = part.attr
                    elif isinstance(part, ast.Constant) and isinstance(part.value, str):
                        text = part.value
                    if text is not None and any(
                            s in text.lower() for s in _RECORD_SUBSTRINGS):
                        return True
    return False


class ExceptionHygieneChecker(Checker):
    rule_id = "TPU005"
    name = "exception-hygiene"
    description = ("except Exception / bare except whose body neither "
                   "logs, re-raises, nor records the error")

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        out: list[Violation] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            type_name = dotted_name(node.type) if node.type is not None else None
            broad = node.type is None or (
                type_name is not None
                and type_name.split(".")[-1] in ("Exception", "BaseException"))
            if not broad:
                continue
            if not _body_handles_error(node):
                what = type_name or "bare except"
                out.append(ctx.violation(
                    "TPU005", node,
                    f"`except {what}` swallows the error: body neither "
                    "logs, re-raises, nor records it"))
        return out


# ---------------------------------------------------------------------------
# TPU008 — callback-leak (path-sensitive must-call-exactly-once on lint/cfg)
# ---------------------------------------------------------------------------

# completion-callback pairs (the transport contract: exactly ONE of the
# pair must fire) and single-listener parameter names (must fire once)
_CALLBACK_PAIRS = (("on_response", "on_failure"), ("on_ok", "on_give_up"))
_SINGLE_LISTENERS = ("callback", "listener", "on_done", "done")


def _fn_param_names(fn: ast.AST) -> set[str]:
    args = getattr(fn, "args", None)
    if args is None:
        return set()
    names = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}
    if args.vararg:
        names.add(args.vararg.arg)
    if args.kwarg:
        names.add(args.kwarg.arg)
    return names


def _names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


class _PathState:
    """Accumulated resolution facts along one CFG path."""

    __slots__ = ("invokes", "escaped", "events")

    def __init__(self) -> None:
        self.invokes = 0
        self.escaped = False
        self.events: list[tuple[str, ast.AST]] = []  # (kind, node)


class _EventWalker:
    """Extract resolution events from one statement/expression: direct
    invocations of a tracked callback, delegations to a local helper whose
    body (transitively) references one, and escapes — the callback stored,
    returned, or passed onward, i.e. resolved later by someone else."""

    def __init__(self, tracked: set[str], carriers: set[str]):
        self.tracked = tracked
        self.carriers = carriers

    def walk(self, node: ast.AST, state: _PathState) -> None:
        # a carrier CALL only counts as delegation when its result is
        # discarded (`helper(x)` as a statement, or `return helper(x)`):
        # a factory call whose result is passed onward
        # (`send(on_response=make_handler())`) produces the resolver, it
        # does not resolve — that value escaping is the resolution
        if isinstance(node, ast.Expr):
            self._visit(node.value, state, discard=True)
        elif isinstance(node, ast.Return) and node.value is not None:
            self._visit(node.value, state, discard=True)
        elif isinstance(node, ast.expr):
            # a bare expression in a block is a branch test / with-item /
            # loop iterable the CFG emitted: truthiness reads of a tracked
            # name there (`if on_response:`) are feasibility tests — the
            # same fact branch_infeasible prunes on — not escapes
            self._visit_test(node, state)
        else:
            self._visit(node, state)

    def _visit_test(self, node: ast.AST, state: _PathState) -> None:
        if isinstance(node, ast.Name) and \
                node.id in (self.tracked | self.carriers):
            return
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            self._visit_test(node.operand, state)
            return
        if isinstance(node, ast.BoolOp):
            for value in node.values:
                self._visit_test(value, state)
            return
        self._visit(node, state)

    def _visit(self, node: ast.AST, state: _PathState,
               discard: bool = False) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # a definition is inert until used
        if isinstance(node, ast.Lambda):
            # a lambda in expression position IS being used: if its body
            # touches a tracked name (or a carrier), the callback escapes
            # into deferred execution
            if _names_in(node.body) & (self.tracked | self.carriers):
                state.escaped = True
                state.events.append(("escape", node))
            return
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id in self.tracked:
                state.invokes += 1
                state.events.append(("invoke", node))
            elif isinstance(fn, ast.Name) and fn.id in self.carriers:
                if discard:
                    # delegation: the helper's own CFG is checked
                    # separately; this callsite's summary is "resolves once"
                    state.invokes += 1
                    state.events.append(("delegate", node))
                else:
                    # factory/constructor use — the returned resolver
                    # escapes into whoever receives it
                    state.escaped = True
                    state.events.append(("escape", node))
            else:
                self._visit(fn, state)
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                self._visit(arg, state)
            return
        if isinstance(node, ast.Compare):
            # `x is None` is a test, not a use — skip tracked names that
            # are only being compared against None
            none_cmp = any(
                isinstance(c, ast.Constant) and c.value is None
                for c in [node.left, *node.comparators]
            )
            for child in [node.left, *node.comparators]:
                if (none_cmp and isinstance(child, ast.Name)
                        and child.id in (self.tracked | self.carriers)):
                    continue
                self._visit(child, state)
            return
        if isinstance(node, ast.IfExp):
            # conservative join: count the arm with FEWER resolutions
            self._visit(node.test, state)
            a, b = _PathState(), _PathState()
            self._visit(node.body, a)
            self._visit(node.orelse, b)
            lo = a if (a.invokes + (1 if a.escaped else 0)) <= \
                (b.invokes + (1 if b.escaped else 0)) else b
            state.invokes += lo.invokes
            state.escaped = state.escaped or lo.escaped
            state.events.extend(lo.events)
            return
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Load) and \
                    node.id in (self.tracked | self.carriers):
                state.escaped = True
                state.events.append(("escape", node))
            return
        for child in ast.iter_child_nodes(node):
            self._visit(child, state)


def _carrier_names(fn: ast.AST, tracked: set[str]) -> set[str]:
    """Names of functions defined under `fn` whose bodies (transitively)
    reference a tracked callback — calling or passing one of these
    delegates the resolution (the summary layer of the analysis)."""
    defs: dict[str, set[str]] = {}
    for node in ast.walk(fn):
        if node is fn:
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, set()).update(_names_in(node))
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Lambda):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    defs.setdefault(t.id, set()).update(_names_in(node.value))
    carriers: set[str] = set()
    changed = True
    while changed:
        changed = False
        for name, refs in defs.items():
            if name not in carriers and refs & (tracked | carriers):
                carriers.add(name)
                changed = True
    return carriers


class CallbackLeakChecker(Checker):
    rule_id = "TPU008"
    name = "callback-leak"
    description = ("a path through a listener-handling function drops both "
                   "completion callbacks (on_response/on_failure) or "
                   "invokes more than one; helper delegation recognized "
                   "via call summaries on the per-function CFG")

    def applies_to(self, display_path: str, source: str) -> bool:
        return any(n in source for pair in _CALLBACK_PAIRS for n in pair) \
            or any(n in source for n in _SINGLE_LISTENERS)

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        out: list[Violation] = []
        seen: set[tuple[str, int]] = set()
        for fn, tracked, strict in self._targets(ctx.tree):
            for v in self._check_fn(ctx, fn, tracked, strict):
                key = (v.rule, v.line)
                if key not in seen:
                    seen.add(key)
                    out.append(v)
        return out

    # -- which functions are listener handlers -----------------------------

    def _targets(self, tree: ast.AST):
        """Collect (fn, tracked_names, strict). strict=True (callback
        names are PARAMETERS of fn — the dispatch function itself): every
        path must resolve. strict=False (a nested closure capturing
        callbacks bound by an enclosing function): only except-paths and
        double resolutions are flagged — closures legitimately resolve on
        a *later* invocation (count-down latches)."""
        yield_list: list[tuple[ast.AST, set[str], bool]] = []

        def descend(node: ast.AST, env: set[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    handle(child, env)
                else:
                    descend(child, env)

        def handle(fn: ast.AST, enclosing_params: set[str]) -> None:
            params = _fn_param_names(fn)
            body_names = _names_in(fn)
            tracked: set[str] | None = None
            strict = False
            for pair in _CALLBACK_PAIRS:
                if set(pair) <= params:
                    tracked, strict = set(pair), True
                    break
                if tracked is None and (set(pair) & body_names) \
                        and set(pair) <= enclosing_params:
                    tracked = set(pair)
            if tracked is None:
                for single in _SINGLE_LISTENERS:
                    if single in params and single in body_names:
                        tracked, strict = {single}, True
                        break
                    if single in enclosing_params and any(
                        isinstance(n, ast.Name) and n.id == single
                        for n in ast.walk(fn)
                    ):
                        tracked = {single}
                        break
            if tracked is not None:
                yield_list.append((fn, tracked, strict))
            descend(fn, enclosing_params | params)

        descend(tree, set())
        return yield_list

    # -- per-function path walk --------------------------------------------

    def _check_fn(self, ctx: FileContext, fn: ast.AST, tracked: set[str],
                  strict: bool) -> Iterable[Violation]:
        carriers = _carrier_names(fn, tracked)
        walker = _EventWalker(tracked, carriers)
        graph = cfg_mod.build_cfg(fn)
        pair = " / ".join(sorted(tracked))
        out: list[Violation] = []
        for path in cfg_mod.enumerate_paths(
            graph, prune=lambda e: cfg_mod.branch_infeasible(e, tracked)
        ):
            if path.raises:
                # an escaping exception reaches the CALLER (a raising
                # transport handler produces the error response); paths
                # ending at raise_exit are the caller's problem
                continue
            state = _PathState()
            for block in path.blocks:
                for stmt in block.stmts:
                    walker.walk(stmt, state)
            if state.escaped:
                continue  # resolution handed off — exactly-once unknown
            if state.invokes == 0 and (strict or path.exceptional):
                anchor = self._leak_anchor(path, fn)
                kind = ("an except-path" if path.exceptional
                        else "a code path")
                out.append(ctx.violation(
                    "TPU008", anchor,
                    f"{kind} through this listener handler completes "
                    f"without resolving {pair} — the caller waits forever"))
            elif state.invokes >= 2 and not path.exceptional:
                second = [n for k, n in state.events
                          if k in ("invoke", "delegate")][1]
                out.append(ctx.violation(
                    "TPU008", second,
                    f"a code path resolves {pair} more than once "
                    "(double-completion corrupts the caller's state "
                    "machine)"))
        return out

    @staticmethod
    def _leak_anchor(path: "cfg_mod.Path", fn: ast.AST) -> ast.AST:
        # the return that drops the callbacks, else the handler the path
        # fell through, else the def line
        for block in reversed(path.blocks):
            for stmt in reversed(block.stmts):
                if isinstance(stmt, ast.Return):
                    return stmt
        for block in path.blocks:
            if block.label.startswith("except:") and block.stmts:
                return block.stmts[0]
        return fn


# ---------------------------------------------------------------------------
# TPU009 — unbounded growth on long-lived transport/queue attributes
# ---------------------------------------------------------------------------

_GROW_METHODS = {"append", "appendleft", "add", "put", "put_nowait",
                 "push", "setdefault"}
_SHRINK_METHODS = {"pop", "popleft", "popitem", "remove", "discard",
                   "clear", "get_nowait"}
_CONTAINER_CALLS = {"dict", "list", "set", "deque", "defaultdict",
                    "OrderedDict", "Counter", "Queue", "SimpleQueue",
                    "LifoQueue", "PriorityQueue"}
# attrs that are registration REGISTRIES (handlers, settings consumers):
# bounded by the code that registers into them, not runtime traffic
_REGISTRY_HINTS = ("handler", "listener", "consumer", "subscriber",
                   "callback", "hook")
_REGISTER_METHOD_HINTS = ("register", "subscribe", "install")


def _self_attr_of(node: ast.AST) -> str | None:
    """self.X for Attribute chains rooted at self (through subscripts)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _is_bounded_container_ctor(value: ast.expr) -> bool | None:
    """True: bounded ctor. False: unbounded container ctor.
    None: not a recognized container initializer."""
    if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                          ast.DictComp, ast.SetComp)):
        return False
    if isinstance(value, ast.Call):
        name = call_name(value)
        if name is None:
            return None
        last = name.split(".")[-1]
        if last not in _CONTAINER_CALLS:
            return None
        if last == "deque":
            for kw in value.keywords:
                if kw.arg == "maxlen" and not (
                        isinstance(kw.value, ast.Constant)
                        and kw.value.value is None):
                    return True
            if len(value.args) >= 2:
                return True
            return False
        if last.endswith("Queue"):
            for kw in value.keywords:
                if kw.arg == "maxsize" and not (
                        isinstance(kw.value, ast.Constant)
                        and kw.value.value in (0, None)):
                    return True
            if value.args and not (
                    isinstance(value.args[0], ast.Constant)
                    and value.args[0].value in (0, None)):
                return True
            return False
        return False
    return None


class UnboundedGrowthChecker(Checker):
    rule_id = "TPU009"
    name = "unbounded-growth"
    description = ("append/put/dict[...]= on a long-lived container "
                   "attribute of a sim-run (transport/cluster/recovery) "
                   "class with no size bound, shed, or eviction anywhere "
                   "in the class")

    # same scope as TPU004/TPU006: the modules on the serving/sim path
    def applies_to(self, display_path: str, source: str) -> bool:
        return _sim_scoped(display_path, source)

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        out: list[Violation] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                out.extend(self._check_class(ctx, node))
        return out

    def _check_class(self, ctx: FileContext,
                     cls: ast.ClassDef) -> list[Violation]:
        containers: set[str] = set()
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and item.name in ("__init__", "__new__"):
                for sub in ast.walk(item):
                    if isinstance(sub, ast.Assign):
                        bounded = _is_bounded_container_ctor(sub.value)
                        if bounded is not None:
                            for t in sub.targets:
                                attr = _self_attr_of(t)
                                if attr is not None and not bounded:
                                    containers.add(attr)
                    elif isinstance(sub, ast.AnnAssign) and sub.value is not None:
                        bounded = _is_bounded_container_ctor(sub.value)
                        if bounded is False:
                            attr = _self_attr_of(sub.target)
                            if attr is not None:
                                containers.add(attr)
        containers = {
            a for a in containers
            if not any(h in a.lower() for h in _REGISTRY_HINTS)
        }
        if not containers:
            return []

        grows: list[tuple[str, ast.AST, str]] = []  # (attr, node, method)
        evidence: set[str] = set()  # attrs with shrink/bound/reassignment

        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            ctor = item.name in ("__init__", "__new__")
            # a nested def inside __init__ is a CALLBACK registered at
            # construction — its body runs at runtime, not construction
            runtime_nodes: set[int] = set()
            if ctor:
                for fd in ast.walk(item):
                    if fd is not item and isinstance(
                            fd, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        runtime_nodes.update(id(n) for n in ast.walk(fd))
            is_registry_method = any(
                item.name.startswith(h) for h in _REGISTER_METHOD_HINTS)
            for sub in ast.walk(item):
                is_init = ctor and id(sub) not in runtime_nodes
                # self.X.append(...) / .put(...) / .setdefault(...).add(...)
                if isinstance(sub, ast.Call) and isinstance(
                        sub.func, ast.Attribute):
                    base = sub.func.value
                    meth = sub.func.attr
                    # look through one chained call: setdefault(...).add()
                    if isinstance(base, ast.Call) and isinstance(
                            base.func, ast.Attribute) and \
                            base.func.attr == "setdefault":
                        base = base.func.value
                    attr = _self_attr_of(base)
                    if attr in containers:
                        if meth in _SHRINK_METHODS:
                            evidence.add(attr)
                        elif meth in _GROW_METHODS and not is_init \
                                and not is_registry_method:
                            grows.append((attr, sub, item.name))
                # self.X[k] = v
                if isinstance(sub, ast.Assign):
                    for t in sub.targets:
                        if isinstance(t, ast.Subscript):
                            attr = _self_attr_of(t)
                            if attr in containers and not is_init \
                                    and not is_registry_method:
                                grows.append((attr, sub, item.name))
                        elif not is_init:
                            # reassignment (drain/rotate) is eviction
                            attr = _self_attr_of(t) if isinstance(
                                t, ast.Attribute) else None
                            if attr in containers:
                                evidence.add(attr)
                            if isinstance(t, ast.Tuple):
                                for el in t.elts:
                                    a2 = _self_attr_of(el) if isinstance(
                                        el, ast.Attribute) else None
                                    if a2 in containers:
                                        evidence.add(a2)
                # del self.X[k]
                if isinstance(sub, ast.Delete):
                    for t in sub.targets:
                        attr = _self_attr_of(t)
                        if attr in containers:
                            evidence.add(attr)
                # len(self.X) under comparison = an explicit bound check
                if isinstance(sub, ast.Compare):
                    for part in [sub.left, *sub.comparators]:
                        if isinstance(part, ast.Call) and \
                                call_name(part) == "len" and part.args:
                            attr = _self_attr_of(part.args[0])
                            if attr in containers:
                                evidence.add(attr)

        out: list[Violation] = []
        flagged: set[tuple[str, int]] = set()
        for attr, node, method in grows:
            if attr in evidence:
                continue
            key = (attr, getattr(node, "lineno", 0))
            if key in flagged:
                continue
            flagged.add(key)
            out.append(ctx.violation(
                "TPU009", node,
                f"self.{attr} grows in {method}() but {cls.name} never "
                "bounds, sheds, or evicts it — a long-lived queue/buffer "
                "on the serving path must have a size bound or eviction "
                "(see QueuePressure)"))
        return out


# ---------------------------------------------------------------------------
# TPU010 — interprocedural lock-order inversion (TPU003 across functions)
# ---------------------------------------------------------------------------

_SUMMARY_DEPTH = 4  # call-chain depth for acquired-lock summaries


class _LockCallScan(ast.NodeVisitor):
    """One method: locks acquired, plus self-method calls annotated with
    the locks held at the callsite (the summary TPU010 propagates).

    Lock names are *qualified*: a lock of this class is its attr name
    (``_lock``); a member object's lock reached through ``self._x`` —
    either directly (``with self._x._lock:``) or via a member-method
    summary — is ``_x._lock``, so inversions that cross a class boundary
    join on one name space."""

    def __init__(self, lock_attrs: set[str],
                 member_locks: dict[str, set[str]] | None = None):
        self.lock_attrs = lock_attrs
        # member attr -> that member class's own lock attr names
        self.member_locks = member_locks or {}
        self.held: list[str] = []
        self.acquired: set[str] = set()
        # (callee method name, frozenset(held at callsite), call node)
        self.calls: list[tuple[str, frozenset, ast.Call]] = []
        # (member attr, callee method, frozenset(held), call node)
        self.member_calls: list[tuple[str, str, frozenset, ast.Call]] = []
        # intra-method ordered pairs (outer, inner) -> acquisition node
        self.pairs: dict[tuple[str, str], ast.AST] = {}

    def _self_attr(self, node: ast.AST) -> str | None:
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        return None

    def _lock_name(self, node: ast.AST) -> str | None:
        """The qualified lock name an expression acquires, if any."""
        attr = self._self_attr(node)
        if attr is not None:
            return attr if attr in self.lock_attrs else None
        # self._x._lock: a member object's lock taken directly
        if isinstance(node, ast.Attribute):
            owner = self._self_attr(node.value)
            if owner is not None and node.attr in \
                    self.member_locks.get(owner, ()):
                return f"{owner}.{node.attr}"
        return None

    def visit_With(self, node: ast.With) -> None:
        acquired: list[str] = []
        for item in node.items:
            name = self._lock_name(item.context_expr)
            if name is not None:
                self.acquired.add(name)
                for outer in self.held + acquired:
                    if outer != name:
                        self.pairs.setdefault((outer, name),
                                              item.context_expr)
                acquired.append(name)
            else:
                self.visit(item.context_expr)
        self.held.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        if acquired:
            del self.held[-len(acquired):]

    visit_AsyncWith = visit_With  # type: ignore[assignment]

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if (isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "self"):
            self.calls.append((fn.attr, frozenset(self.held), node))
        elif isinstance(fn, ast.Attribute):
            # self._x.method(): a call into a member class's summary
            owner = self._self_attr(fn.value)
            if owner is not None and owner in self.member_locks:
                self.member_calls.append(
                    (owner, fn.attr, frozenset(self.held), node))
        self.generic_visit(node)

    # nested defs run later, in an unknown lock context — skip
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]
    visit_Lambda = visit_FunctionDef  # type: ignore[assignment]


class InterproceduralLockOrderChecker(Checker):
    rule_id = "TPU010"
    name = "lock-order-interprocedural"
    description = ("lock-order inversions ACROSS method boundaries: "
                   "calling self.m() while holding lock A acquires lock B "
                   "(via the callee's acquired-locks summary — including a "
                   "member object's lock taken through self._x.method()) "
                   "while another path takes B before A")

    def applies_to(self, display_path: str, source: str) -> bool:
        return ("Lock" in source or "_lock" in source
                or "Condition" in source or "Semaphore" in source)

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        classes: dict[str, ast.ClassDef] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                classes.setdefault(node.name, node)
        out: list[Violation] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                out.extend(self._check_class(ctx, node, classes))
        return out

    @staticmethod
    def _member_classes(cls: ast.ClassDef,
                        classes: dict[str, ast.ClassDef]) -> dict[str, str]:
        """Member attrs constructed from a same-file class:
        ``self._x = ClassName(...)`` -> {"_x": "ClassName"}."""
        out: dict[str, str] = {}
        for node in ast.walk(cls):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            t = node.targets[0]
            if not (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                continue
            v = node.value
            if (isinstance(v, ast.Call) and isinstance(v.func, ast.Name)
                    and v.func.id in classes):
                out.setdefault(t.attr, v.func.id)
        return out

    @staticmethod
    def _scan_methods(cls: ast.ClassDef, locks: set[str],
                      member_locks: dict[str, set[str]] | None = None,
                      ) -> dict[str, _LockCallScan]:
        scans: dict[str, _LockCallScan] = {}
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan = _LockCallScan(locks, member_locks)
                for stmt in item.body:
                    scan.visit(stmt)
                # latest def wins on duplicate names (matches runtime)
                scans[item.name] = scan
        return scans

    @staticmethod
    def _acquires_fn(scans: dict[str, _LockCallScan]):
        """Transitive acquired-locks summary over one class's scans."""
        summary: dict[str, set[str]] = {}

        def acquires(method: str, depth: int, seen: frozenset) -> set[str]:
            if method in summary:
                return summary[method]
            scan = scans.get(method)
            if scan is None or depth <= 0 or method in seen:
                return set()
            acc = set(scan.acquired)
            for callee, _held, _node in scan.calls:
                acc |= acquires(callee, depth - 1, seen | {method})
            if depth == _SUMMARY_DEPTH:
                summary[method] = acc
            return acc

        return acquires

    def _check_class(self, ctx: FileContext, cls: ast.ClassDef,
                     classes: dict[str, ast.ClassDef]) -> list[Violation]:
        locks = LockDisciplineChecker()._lock_attrs(cls)
        members = self._member_classes(cls, classes)
        member_locks = {
            attr: mlocks for attr, cname in members.items()
            if cname != cls.name
            and (mlocks := LockDisciplineChecker()._lock_attrs(
                classes[cname]))
        }
        if len(locks) + len(member_locks) < 2:
            return []  # an inversion needs two distinct locks
        scans = self._scan_methods(cls, locks, member_locks)
        acquires = self._acquires_fn(scans)

        # one acquired-locks summary per member class (its OWN locks; a
        # member's member is depth-2 cross-class and out of scope)
        member_acquires: dict[str, Any] = {}
        for attr in member_locks:
            mcls = classes[members[attr]]
            member_acquires[attr] = self._acquires_fn(
                self._scan_methods(mcls, member_locks[attr]))

        # ordered pairs: intra-method (TPU003 territory, kept for the
        # inversion join) + interprocedural via callee summaries
        intra: dict[tuple[str, str], ast.AST] = {}
        inter: dict[tuple[str, str], tuple[ast.AST, str, str]] = {}
        for name, scan in scans.items():
            for pair, node in scan.pairs.items():
                intra.setdefault(pair, node)
            for callee, held, node in scan.calls:
                if not held or callee not in scans:
                    continue
                callee_locks = acquires(callee, _SUMMARY_DEPTH, frozenset())
                for inner in callee_locks - set(held):
                    for outer in held:
                        if outer != inner:
                            inter.setdefault(
                                (outer, inner), (node, name, callee))
            for attr, callee, held, node in scan.member_calls:
                if not held:
                    continue
                got = member_acquires[attr](callee, _SUMMARY_DEPTH,
                                            frozenset())
                qualified = {f"{attr}.{lk}" for lk in got}
                for inner in qualified - set(held):
                    for outer in held:
                        if outer != inner:
                            inter.setdefault(
                                (outer, inner),
                                (node, name, f"{attr}.{callee}"))

        out: list[Violation] = []
        reported: set[frozenset] = set()
        all_pairs = set(intra) | set(inter)
        for (a, b) in sorted(all_pairs):
            if (b, a) not in all_pairs:
                continue
            key = frozenset((a, b))
            if key in reported:
                continue
            # at least one direction must cross a function boundary —
            # pure intra-method inversions are TPU003's finding
            if (a, b) not in inter and (b, a) not in inter:
                continue
            reported.add(key)
            direction = (a, b) if (a, b) in inter else (b, a)
            node, caller, callee = inter[direction]
            out.append(ctx.violation(
                "TPU010", node,
                f"{caller}() holds self.{direction[0]} while calling "
                f"self.{callee}(), which acquires self.{direction[1]} — "
                f"but class {cls.name} also takes these locks in the "
                "opposite order (cross-function deadlock risk)"))
        return out


# ---------------------------------------------------------------------------
# TPU011 — blocking on the serial data worker
# ---------------------------------------------------------------------------

# call targets that hand a callable to the serial data worker; the first
# positional argument runs there (`ClusterNode._offload` / `_after_offload`)
_OFFLOAD_FUNCS = {"_offload", "_after_offload"}
_DW_BLOCKING_PREFIXES = ("socket.", "requests.", "urllib.request.")
_DW_BLOCKING_CALLS = {"time.sleep", "input"}
# zero-arg, untimed forms of these methods block indefinitely: Condition/
# Event.wait(), Lock.acquire(), Future.result(), Thread.join(). A wedged
# data worker stalls EVERY search/write on the node (one worker keeps the
# engine's single-writer discipline), and the soak's quiesce contract
# (every op completes) depends on the worker never parking forever.
_DW_UNTIMED_METHODS = {"wait", "acquire", "result", "join"}


class _DataWorkerScan(ast.NodeVisitor):
    """Walk one offloaded callable's body; follow direct delegation to
    local helper defs and same-class `self.*` methods (bounded depth)."""

    MAX_DEPTH = 3

    def __init__(self, ctx: FileContext, methods: dict, local_defs: dict):
        self.ctx = ctx
        self.methods = methods
        self.local_defs = local_defs
        self.out: list[Violation] = []
        self._visited: set[int] = set()
        self._depth = 0

    # nested defs are usually completion callbacks that run back on the
    # transport loop, not on the worker — only follow them when CALLED
    # directly (handled in visit_Call), never by definition
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]
    visit_Lambda = visit_FunctionDef  # type: ignore[assignment]

    def _follow(self, fn: ast.FunctionDef) -> None:
        if id(fn) in self._visited or self._depth >= self.MAX_DEPTH:
            return
        self._visited.add(id(fn))
        self._depth += 1
        try:
            for stmt in fn.body:
                self.visit(stmt)
        finally:
            self._depth -= 1

    def visit_Call(self, node: ast.Call) -> None:
        raw = call_name(node)
        name = self.ctx.canonical(raw)
        if name in _DW_BLOCKING_CALLS:
            self.out.append(self.ctx.violation(
                "TPU011", node,
                f"{name}() parks the serial data worker; every search and "
                f"write on the node stalls behind it"))
        elif name is not None and name.startswith(_DW_BLOCKING_PREFIXES):
            self.out.append(self.ctx.violation(
                "TPU011", node,
                f"{name}() is blocking network IO on the serial data "
                f"worker"))
        elif (
            name is not None
            and name.split(".")[-1] in _DW_UNTIMED_METHODS
            and not node.args
            and not any(kw.arg in ("timeout", "blocking")
                        for kw in node.keywords)
            and "." in name  # bare wait()/result() locals are not waits
        ):
            self.out.append(self.ctx.violation(
                "TPU011", node,
                f"untimed {name}() can wedge the serial data worker "
                f"forever; pass a timeout"))
        # direct delegation: run() -> helper() / self.method()
        if isinstance(node.func, ast.Name):
            target = self.local_defs.get(node.func.id)
            if target is not None:
                self._follow(target)
        elif raw is not None and raw.startswith("self."):
            parts = raw.split(".")
            if len(parts) == 2:
                target = self.methods.get(parts[1])
                if target is not None:
                    self._follow(target)
        self.generic_visit(node)


class BlockingOnDataWorkerChecker(Checker):
    rule_id = "TPU011"
    name = "blocking-on-data-worker"
    description = ("untimed waits and blocking IO inside callables "
                   "offloaded to the serial data worker "
                   "(_offload/_after_offload)")

    def applies_to(self, display_path: str, source: str) -> bool:
        return "_offload" in source

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        out: list[Violation] = []
        for cls in (n for n in ast.walk(ctx.tree)
                    if isinstance(n, ast.ClassDef)):
            methods = {m.name: m for m in cls.body
                       if isinstance(m, ast.FunctionDef)}
            for method in methods.values():
                local_defs = {
                    d.name: d for d in ast.walk(method)
                    if isinstance(d, ast.FunctionDef) and d is not method
                }
                for call in ast.walk(method):
                    if not isinstance(call, ast.Call):
                        continue
                    cname = call_name(call)
                    if (cname is None
                            or cname.split(".")[-1] not in _OFFLOAD_FUNCS
                            or not call.args):
                        continue
                    target = call.args[0]
                    scan = _DataWorkerScan(ctx, methods, local_defs)
                    if isinstance(target, ast.Lambda):
                        scan.visit(target.body)
                    elif isinstance(target, ast.Name) and \
                            target.id in local_defs:
                        scan._follow(local_defs[target.id])
                    elif isinstance(target, ast.Attribute) and \
                            isinstance(target.value, ast.Name) and \
                            target.value.id == "self" and \
                            target.attr in methods:
                        scan._follow(methods[target.attr])
                    out.extend(scan.out)
        # one offloaded helper reached from several sites reports once
        seen: set[tuple] = set()
        deduped = []
        for v in out:
            key = (v.line, v.col, v.message)
            if key not in seen:
                seen.add(key)
                deduped.append(v)
        return deduped


# ---------------------------------------------------------------------------
# TPU012 — span-leak (begin_span without end_span on some path, on lint/cfg)
# ---------------------------------------------------------------------------


class _SpanScan:
    """Extract span-resolution events from one statement.

    Resolution model (mirrors TPU008's exactly-once analysis, specialized
    to manual span pairs): a name bound from `*.begin_span(...)` must, on
    every non-raising path, either be passed to `*.end_span(name)` or be
    HANDED OFF — captured by a nested def/lambda (deferred completion
    callbacks end spans later), stored into a container/attribute,
    returned, or passed to another call. Attribute access on the span
    itself (`span.set_attribute(...)`, `span.trace_id`) is neutral: it
    neither ends the span nor hands it off."""

    def __init__(self, tracked: set[str]):
        self.tracked = tracked

    def walk(self, stmt: ast.AST, opened: set[str], ended: set[str],
             escaped: set[str]) -> None:
        # (re)binding a tracked name from begin_span opens a fresh span
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name) and \
                stmt.targets[0].id in self.tracked and \
                self._is_begin_span(stmt.value):
            name = stmt.targets[0].id
            opened.add(name)
            ended.discard(name)
            escaped.discard(name)
            self._visit(stmt.value.func, opened, ended, escaped)
            for arg in list(stmt.value.args) + \
                    [kw.value for kw in stmt.value.keywords]:
                self._visit(arg, opened, ended, escaped)
            return
        self._visit(stmt, opened, ended, escaped)

    @staticmethod
    def _is_begin_span(node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "begin_span")

    def _visit(self, node: ast.AST, opened: set[str], ended: set[str],
               escaped: set[str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # a closure capturing the span owns its completion from here
            escaped.update(_names_in(node) & self.tracked)
            return
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr == "end_span":
                for arg in node.args:
                    if isinstance(arg, ast.Name) and arg.id in self.tracked:
                        ended.add(arg.id)
                    else:
                        self._visit(arg, opened, ended, escaped)
                self._visit(fn.value, opened, ended, escaped)
                return
            self._visit(fn, opened, ended, escaped)
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name) and arg.id in self.tracked:
                    # handed to another call — resolved by the receiver
                    escaped.add(arg.id)
                else:
                    self._visit(arg, opened, ended, escaped)
            return
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and \
                    node.value.id in self.tracked:
                return  # span.attr / span.method(...): neutral
            self._visit(node.value, opened, ended, escaped)
            return
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Load) and node.id in self.tracked:
                # stored / returned / yielded — someone else ends it
                escaped.add(node.id)
            return
        for child in ast.iter_child_nodes(node):
            self._visit(child, opened, ended, escaped)


class SpanLeakChecker(Checker):
    rule_id = "TPU012"
    name = "span-leak"
    description = ("a path through a function abandons a span opened with "
                   "begin_span — neither end_span nor a handoff (closure "
                   "capture, store, return, argument) resolves it, so the "
                   "tracing ring holds an open span forever")

    def applies_to(self, display_path: str, source: str) -> bool:
        return "begin_span" in source

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        out: list[Violation] = []
        seen: set[tuple] = set()
        for fn in (n for n in ast.walk(ctx.tree)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))):
            tracked = {
                stmt.targets[0].id
                for stmt in ast.walk(fn)
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and _SpanScan._is_begin_span(stmt.value)
            }
            if not tracked:
                continue
            for v in self._check_fn(ctx, fn, tracked):
                key = (v.line, v.message)
                if key not in seen:
                    seen.add(key)
                    out.append(v)
        return out

    def _check_fn(self, ctx: FileContext, fn: ast.AST,
                  tracked: set[str]) -> Iterable[Violation]:
        scan = _SpanScan(tracked)
        graph = cfg_mod.build_cfg(fn)
        out: list[Violation] = []
        for path in cfg_mod.enumerate_paths(graph):
            if path.raises:
                # an escaping exception is the CALLER's signal (TPU008's
                # contract); the abandoned-span cases that matter complete
                # normally with the span still open
                continue
            opened: set[str] = set()
            ended: set[str] = set()
            escaped: set[str] = set()
            for block in path.blocks:
                for stmt in block.stmts:
                    scan.walk(stmt, opened, ended, escaped)
            leaked = opened - ended - escaped
            if leaked:
                anchor = self._leak_anchor(path, fn)
                names = ", ".join(sorted(leaked))
                out.append(ctx.violation(
                    "TPU012", anchor,
                    f"a code path completes without end_span({names}) — "
                    f"begin_span'd spans must end (or be handed off) on "
                    f"every path, or the trace tree never closes"))
        return out

    @staticmethod
    def _leak_anchor(path: "cfg_mod.Path", fn: ast.AST) -> ast.AST:
        for block in reversed(path.blocks):
            for stmt in reversed(block.stmts):
                if isinstance(stmt, ast.Return):
                    return stmt
        for block in path.blocks:
            if block.label.startswith("except:") and block.stmts:
                return block.stmts[0]
        return fn


# ---------------------------------------------------------------------------
# TPU013 — metric-hygiene (metric names must be registered constants)
# ---------------------------------------------------------------------------


def _is_dynamic_string(node: ast.AST) -> bool:
    """A string expression built AT THE CALL SITE: f-strings, + / %
    concatenation, and .format()/str.join() calls. Literals, module
    constants (Name/Attribute reads) and plain variables are fine — a
    variable can only be flagged where IT was built."""
    if isinstance(node, ast.JoinedStr):
        return any(isinstance(v, ast.FormattedValue) for v in node.values)
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add, ast.Mod)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        # "x.{}".format(...) / ".".join(...) — the receiver is usually a
        # string CONSTANT, which dotted_name cannot resolve
        if node.func.attr in ("format", "join"):
            return True
    return False


class MetricHygieneChecker(Checker):
    """TPU013: `metrics.histogram(name)` / `metrics.counter(name)` with a
    name BUILT at the record site (f-string, concatenation, %-format,
    .format()) silently explodes Prometheus cardinality: every distinct
    interpolation mints a new time series, and the registry holds them all
    forever (a TPU009-shaped leak the growth rule cannot see). Metric
    names must be string literals or registered constants; varying
    dimensions belong in labels or in bucketed values, not the name."""

    rule_id = "TPU013"
    name = "metric-hygiene"
    description = ("histogram/counter metric names must be registered "
                   "constants, not strings built at the record site")

    _METHODS = ("histogram", "counter")

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        out: list[Violation] = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self._METHODS
                    and node.args):
                continue
            arg = node.args[0]
            if _is_dynamic_string(arg):
                out.append(ctx.violation(
                    "TPU013", node,
                    f"metric name passed to .{node.func.attr}() is built "
                    f"at the record site — every distinct interpolation "
                    f"mints a new Prometheus series; use a registered "
                    f"constant name (vary labels, not names)"))
        return out


# ---------------------------------------------------------------------------
# TPU014 — naked-device-put (uploads must route through the residency ledger)
# ---------------------------------------------------------------------------

# modules whose host-to-card uploads publish serving-path structures into
# device memory: every upload there must be accounted by the
# device-residency ledger (telemetry/device_ledger.py) or device memory
# goes dark
_DEVICE_MODULE_PATTERNS = (
    "opensearch_tpu_torch/index/",
    "opensearch_tpu_torch/ops/",
    "opensearch_tpu_torch/search/",
    "opensearch_tpu_torch/cluster/",
)
# explicit opt-in for fixtures / new device modules; line-start anchored
# like the sim marker so merely MENTIONING it doesn't opt a file in
_DEVICE_MARKER = "# tpulint: device-module"
_DEVICE_MARKER_RE = None  # compiled lazily


def _device_scoped(display_path: str, source: str) -> bool:
    global _DEVICE_MARKER_RE
    if any(p in display_path for p in _DEVICE_MODULE_PATTERNS):
        return True
    if _DEVICE_MARKER not in source:
        return False
    if _DEVICE_MARKER_RE is None:
        import re

        _DEVICE_MARKER_RE = re.compile(
            r"(?m)^\s*" + re.escape(_DEVICE_MARKER))
    return _DEVICE_MARKER_RE.search(source) is not None


def _calls_ledger(scope: ast.AST) -> bool:
    """True when the scope contains any call whose callee path names the
    ledger (``default_ledger.register``, ``ledger.record_transient``,
    ``bundle.allocation.free`` ...): the evidence that this function's
    uploads are accounted."""
    for node in ast.walk(scope):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        if name is not None and ("ledger" in name.lower()
                                 or "allocation" in name.lower()):
            return True
    return False


# host tensors made from host data: `<one of these>(...).to(dev)` uploads
_HOST_TENSOR_CALLS = frozenset({"torch.from_numpy", "torch.as_tensor",
                                "torch.tensor"})
# constructors that copy host data straight onto `device=`
_DEVICE_KW_CALLS = frozenset({"torch.as_tensor", "torch.tensor"})


_DTYPE_NAMES = frozenset({
    "float32", "float16", "bfloat16", "float64", "int8", "uint8", "int16",
    "int32", "int64", "bool", "float", "half", "double", "long", "int"})


def _not_a_device(expr: ast.AST) -> bool:
    """A literal "cpu" or None, a torch dtype, or an ``x.dtype`` read:
    ``.to()`` with it copies nothing to the card."""
    if isinstance(expr, ast.Constant):
        return expr.value in ("cpu", None)
    name = dotted_name(expr)
    return name is not None and (
        name.endswith(".dtype")
        or (name.startswith("torch.")
            and name.rsplit(".", 1)[-1] in _DTYPE_NAMES))


def _to_device(call: ast.Call) -> bool:
    """Does this ``.to(...)`` call name a device other than the CPU?"""
    for kw in call.keywords:
        if kw.arg == "device":
            return not _not_a_device(kw.value)
    return bool(call.args) and not _not_a_device(call.args[0])


def _upload(ctx: FileContext, node: ast.Call) -> str | None:
    """The spelling of a host-to-card upload, else None:
    ``torch.from_numpy(a).to(dev)`` (and as_tensor / tensor before
    ``.to``), ``torch.as_tensor(a, device=dev)`` /
    ``torch.tensor(a, device=dev)`` on any device but a literal "cpu",
    and ``x.cuda()``."""
    func = node.func
    if isinstance(func, ast.Attribute):
        if func.attr == "cuda":
            return ".cuda()"
        if func.attr == "to" and isinstance(func.value, ast.Call):
            inner = ctx.canonical(call_name(func.value))
            if inner in _HOST_TENSOR_CALLS and _to_device(node):
                return f"{inner}(...).to()"
    name = ctx.canonical(call_name(node))
    if name in _DEVICE_KW_CALLS:
        for kw in node.keywords:
            if kw.arg == "device" and not _not_a_device(kw.value):
                return f"{name}(..., device=)"
    return None


class NakedDevicePutChecker(Checker):
    """TPU014 in the port: a host-to-card upload in a device-serving
    module (``torch.from_numpy(a).to(dev)``, ``torch.as_tensor(a,
    device=dev)``, ``torch.tensor(a, device=dev)``, ``x.cuda()``) whose
    enclosing function never touches the residency ledger is an
    UNACCOUNTED device upload: the bytes exist on the card but
    `_nodes/stats` `device`, the Prometheus gauges and the mesh byte
    budget can't see them, so every placement/budget decision reads a
    lie. Route the upload through ``telemetry/device_ledger`` (register /
    record_transient) in the same function, or suppress with a comment
    where the upload is a per-launch transient that no structure keeps."""

    rule_id = "TPU014"
    name = "naked-device-put"
    description = ("host-to-card uploads in serving modules must route "
                   "through the device-residency ledger")

    def applies_to(self, display_path: str, source: str) -> bool:
        return _device_scoped(display_path, source)

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        out: list[Violation] = []

        def visit(node: ast.AST, ok: bool) -> None:
            # evidence is per-FUNCTION: a module-level ledger import alone
            # proves nothing about a given upload site. Nested functions
            # (and the `put = lambda ...` idiom) inherit their enclosing
            # function's evidence.
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ok = ok or _calls_ledger(node)
            if isinstance(node, ast.Call) and not ok:
                spelling = _upload(ctx, node)
                if spelling is not None:
                    out.append(ctx.violation(
                        "TPU014", node,
                        f"{spelling} upload without residency accounting: "
                        "register the upload with telemetry/device_ledger "
                        "(or record_transient for per-launch uploads) in "
                        "this function"))
            for child in ast.iter_child_nodes(node):
                visit(child, ok)

        visit(ctx.tree, ok=False)
        return out


# ---------------------------------------------------------------------------
# TPU015 — unmodeled-kernel (launch sites must have a roofline cost model)
# ---------------------------------------------------------------------------

_ROOFLINE_FAMILIES: frozenset | None = None


def _roofline_families() -> frozenset:
    """The registered cost-model families (telemetry/roofline.py). Loaded
    lazily ONCE per process: the module is import-light (no torch at import
    time), and reading the real registry keeps this rule incapable of
    drifting from it — a family registered there is known here."""
    global _ROOFLINE_FAMILIES
    if _ROOFLINE_FAMILIES is None:
        from opensearch_tpu_torch.telemetry.roofline import KNOWN_FAMILIES

        _ROOFLINE_FAMILIES = KNOWN_FAMILIES
    return _ROOFLINE_FAMILIES


class UnmodeledKernelChecker(Checker):
    """TPU015: a ``profiled_kernel("name")``-decorated entry point, or a
    batcher ``dispatch(..., family="name")`` site, whose family has NO
    registered roofline cost model (telemetry/roofline.py COST_MODELS) is
    a kernel the roofline report cannot place: its launches count only as
    ``unmodeled_launches`` and every "what would a rewrite buy" ranking
    silently omits it. New kernels arrive WITH their FLOP/byte model (or
    a suppression where modeling is genuinely out of scope). Families may
    carry a ``[variant]`` suffix (``ivfpq_search[int8]``) — the base name
    is what must be registered. Non-constant family expressions are out
    of static reach and not flagged."""

    rule_id = "TPU015"
    name = "unmodeled-kernel"
    description = ("profiled_kernel / dispatch(family=...) sites must "
                   "name a registered roofline cost model")

    def applies_to(self, display_path: str, source: str) -> bool:
        return _device_scoped(display_path, source)

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        out: list[Violation] = []
        from opensearch_tpu_torch.telemetry.roofline import base_family

        known = _roofline_families()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name is None:
                continue
            family = None
            if (name == "profiled_kernel"
                    or name.endswith(".profiled_kernel")):
                if (node.args and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    family = node.args[0].value
            elif name == "dispatch" or name.endswith(".dispatch"):
                for kw in node.keywords:
                    if (kw.arg == "family"
                            and isinstance(kw.value, ast.Constant)
                            and isinstance(kw.value.value, str)):
                        family = kw.value.value
                        break
            if family is None:
                continue
            if base_family(family) not in known:
                out.append(ctx.violation(
                    "TPU015", node,
                    f"kernel family [{family}] has no registered roofline "
                    f"cost model: add it to telemetry/roofline.py "
                    f"COST_MODELS so the roofline report can place its "
                    f"launches"))
        return out


# ---------------------------------------------------------------------------
# TPU016 — naked-pallas-call (kernel libraries live in ops/, behind device
# guards)
# ---------------------------------------------------------------------------

# hand-written kernel libraries are loaded ONLY here: everything else
# consumes them through the module's wrappers, which own the device
# dispatch (a kernel library loaded elsewhere bypasses the selection
# policy, and launches-or-crashes depending on the tensor it happens to
# meet at runtime)
_OPS_MODULE_PATTERNS = ("opensearch_tpu_torch/ops/",)
_OPS_MARKER = "# tpulint: ops-module"
_OPS_MARKER_RE = None  # compiled lazily


def _ops_scoped(display_path: str, source: str) -> bool:
    global _OPS_MARKER_RE
    if any(p in display_path for p in _OPS_MODULE_PATTERNS):
        return True
    if _OPS_MARKER not in source:
        return False
    if _OPS_MARKER_RE is None:
        import re

        _OPS_MARKER_RE = re.compile(r"(?m)^\s*" + re.escape(_OPS_MARKER))
    return _OPS_MARKER_RE.search(source) is not None


def _is_kernel_load(ctx: FileContext, node: ast.Call) -> bool:
    """``cuda_lib.load(...)``, however ops/cuda_lib was imported."""
    name = ctx.canonical(call_name(node))
    return name is not None and (name == "cuda_lib.load"
                                 or name.endswith(".cuda_lib.load"))


_DEVICE_NAMES = ("cpu", "cuda")


def _is_guard_read(node: ast.AST) -> bool:
    """The device guard: a read of ``<tensor>.device.type`` or
    ``<tensor>.is_cuda``."""
    return isinstance(node, ast.Attribute) and (
        node.attr == "is_cuda"
        or (node.attr == "type" and isinstance(node.value, ast.Attribute)
            and node.value.attr == "device"))


def _device_test(test: ast.AST) -> str | None:
    """Which device a guard test selects when it holds: "cpu" for
    ``x.device.type == "cpu"`` / ``!= "cuda"`` / ``not x.is_cuda``,
    "cuda" for ``x.device.type == "cuda"`` / ``!= "cpu"`` / ``x.is_cuda``;
    None when the test is no guard."""
    negate = False
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        negate, test = True, test.operand
    selects = None
    if isinstance(test, ast.Attribute) and test.attr == "is_cuda":
        selects = "cuda"
    elif isinstance(test, ast.Compare) and len(test.ops) == 1:
        left, right = test.left, test.comparators[0]
        if not _is_guard_read(left):
            left, right = right, left
        if _is_guard_read(left) and isinstance(right, ast.Constant) and \
                right.value in _DEVICE_NAMES and \
                isinstance(test.ops[0], (ast.Eq, ast.NotEq)):
            selects = right.value
            if isinstance(test.ops[0], ast.NotEq):
                selects = "cuda" if selects == "cpu" else "cpu"
    if selects is not None and negate:
        selects = "cuda" if selects == "cpu" else "cpu"
    return selects


def _is_device_type_test(test: ast.AST) -> bool:
    """Any test of a device's type against "cpu" / "cuda" (``dev.type not
    in ("cuda", "cpu")``, ``x.device.type != "cpu"``, ``x.is_cuda``)."""
    for node in ast.walk(test):
        if _is_guard_read(node):
            return True
        if isinstance(node, ast.Compare) and any(
                isinstance(n, ast.Attribute) and n.attr == "type"
                for n in (node.left, *node.comparators)) and any(
                isinstance(c, ast.Constant) and c.value in _DEVICE_NAMES
                for c in ast.walk(node)):
            return True
    return False


def _cpu_side(fn: ast.AST) -> list[ast.AST]:
    """The statements a guarded function runs for a CPU tensor: the body
    of a test that selects the CPU, and what follows a test that selects
    the card (its else branch and the statements after it)."""
    out: list[ast.AST] = []

    def scan(stmts: list) -> None:
        for i, stmt in enumerate(stmts):
            if isinstance(stmt, ast.If):
                selects = _device_test(stmt.test)
                if selects == "cpu":
                    out.extend(stmt.body)
                elif selects == "cuda":
                    out.extend(stmt.orelse)
                    out.extend(stmts[i + 1:])
                scan(stmt.body)
                scan(stmt.orelse)
            elif isinstance(stmt, (ast.With, ast.Try, ast.For, ast.While)):
                for block in ("body", "orelse", "finalbody"):
                    scan(getattr(stmt, block, []) or [])

    scan(fn.body)
    return out


def _calls_outside_raise(stmts: list) -> list[ast.Call]:
    out: list[ast.Call] = []

    def walk(node: ast.AST) -> None:
        if isinstance(node, ast.Raise):
            return
        if isinstance(node, ast.Call):
            out.append(node)
        for child in ast.iter_child_nodes(node):
            walk(child)

    for stmt in stmts:
        walk(stmt)
    return out


def _callee(node: ast.Call) -> str | None:
    f = node.func
    return f.id if isinstance(f, ast.Name) else (
        f.attr if isinstance(f, ast.Attribute) else None)


def _raises_for_device(fn: ast.AST) -> bool:
    """Does ``fn`` raise under a test of a device's type?"""
    return any(isinstance(n, ast.If) and _is_device_type_test(n.test)
               and any(isinstance(s, ast.Raise) for b in n.body
                       for s in ast.walk(b))
               for n in ast.walk(fn))


class NakedPallasCallChecker(Checker):
    """TPU016 in the port: hand-written kernel libraries have exactly one
    home and one front door. A ``cuda_lib.load(...)`` OUTSIDE ``ops/``
    loads a kernel past the selection policy. INSIDE ``ops/``, every
    function that loads a library (a ``cuda_lib.load`` call, or a
    ``return`` of such a loader's call) or launches one (calls a loader)
    must be reachable, through the module's functions, from a wrapper
    carrying the device guard (a read of ``.device.type`` or ``.is_cuda``:
    the shape of ``knn_fused.pool_scan``, ``adc_scan.adc_pool_scan``,
    ``adc_lut.lut``, ``knn_rescore.query_sq`` and ``knn_blocks``'s stage
    wrappers). The twin of the reference's ``interpret`` clause: one of
    those guards sends a CPU tensor to a plain version (a call, outside a
    ``raise``, of something that loads no kernel), and a function on the
    way (or one it calls) raises for any other device. The CPU tests run
    the plain version; only a CUDA tensor reaches a launch."""

    rule_id = "TPU016"
    name = "naked-pallas-call"
    description = ("cuda_lib.load only under ops/, each loader and launch "
                   "reachable only through wrappers carrying the device "
                   "guard, whose CPU branch runs the plain version")

    def applies_to(self, display_path: str, source: str) -> bool:
        return "cuda_lib" in source

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        out: list[Violation] = []
        if not _ops_scoped(ctx.display_path, ctx.source):
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.Call) and _is_kernel_load(ctx, node):
                    out.append(ctx.violation(
                        "TPU016", node,
                        "cuda_lib.load outside ops/: hand-written kernels "
                        "live in ops/ behind a wrapper that owns the "
                        "device dispatch"))
            return out

        # every function in the file (methods and nested helpers too),
        # and each load call's INNERMOST enclosing function; a load
        # enclosed by nothing is a module-scope load with no guard
        all_fns = [n for n in ast.walk(ctx.tree)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        loaders: set[str] = set()

        def collect(node: ast.AST, stack: list) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                stack = stack + [node]
            if isinstance(node, ast.Call) and _is_kernel_load(ctx, node):
                if not stack:
                    out.append(ctx.violation(
                        "TPU016", node,
                        "cuda_lib.load at module scope: kernel libraries "
                        "load inside a guarded entry point"))
                else:
                    loaders.add(stack[-1].name)
            for child in ast.iter_child_nodes(node):
                collect(child, stack)

        collect(ctx.tree, [])
        if not loaders:
            return out
        # a function returning a loader's call is a loader too
        changed = True
        while changed:
            changed = False
            for fn in all_fns:
                if fn.name in loaders:
                    continue
                if any(isinstance(n, ast.Return)
                       and isinstance(n.value, ast.Call)
                       and _callee(n.value) in loaders
                       for n in ast.walk(fn)):
                    loaders.add(fn.name)
                    changed = True

        # reference graph over EVERY function in the file: fn -> names it
        # references, by bare Name or Attribute
        names = {fn.name for fn in all_fns}
        refs: dict[str, set] = {}
        for fn in all_fns:
            rs = refs.setdefault(fn.name, set())
            for n in ast.walk(fn):
                if isinstance(n, ast.Name) and n.id in names \
                        and n.id != fn.name:
                    rs.add(n.id)
                elif isinstance(n, ast.Attribute) and n.attr in names \
                        and n.attr != fn.name:
                    rs.add(n.attr)

        def reach(start: str) -> set[str]:
            seen, frontier = {start}, [start]
            while frontier:
                for ref in refs.get(frontier.pop(), ()):
                    if ref not in seen:
                        seen.add(ref)
                        frontier.append(ref)
            return seen

        reaches = {fn.name: reach(fn.name) for fn in all_fns}
        kernel_fns = {name for name, r in reaches.items() if r & loaders}
        by_name = {fn.name: fn for fn in all_fns}
        guarded = {fn.name for fn in all_fns
                   if any(_is_guard_read(n) for n in ast.walk(fn))}
        plain_guard = {
            name for name in guarded
            if any(_callee(c) not in kernel_fns
                   for c in _calls_outside_raise(_cpu_side(by_name[name])))}
        raising = {fn.name for fn in all_fns if _raises_for_device(fn)}
        launchers = {fn.name for fn in all_fns
                     if fn.name not in loaders and refs[fn.name] & loaders}

        for fn in all_fns:
            if fn.name not in loaders and fn.name not in launchers:
                continue
            role = "loader" if fn.name in loaders else "launch"
            above = {g for g, r in reaches.items() if fn.name in r}
            guards = above & guarded
            if not guards:
                out.append(ctx.violation(
                    "TPU016", fn,
                    f"kernel {role} [{fn.name}] is not reachable from any "
                    f"wrapper carrying the device guard (a read of "
                    f".device.type or .is_cuda): add the wrapper that "
                    f"launches for CUDA tensors and runs the plain "
                    f"version for CPU tensors"))
                continue
            if not guards & plain_guard:
                out.append(ctx.violation(
                    "TPU016", fn,
                    f"no device guard above kernel {role} [{fn.name}] "
                    f"sends a CPU tensor to a plain version: the CPU "
                    f"parity path is part of the kernel contract"))
            if not any(g in raising or refs[g] & raising for g in above):
                out.append(ctx.violation(
                    "TPU016", fn,
                    f"no wrapper above kernel {role} [{fn.name}] raises "
                    f"for a device other than the CPU and the card"))
        return out


# ---------------------------------------------------------------------------
# TPU017 — untracked-structure-read (launches over resident structures must
# record a heat touch)
# ---------------------------------------------------------------------------


def _calls_touch(scope: ast.AST) -> bool:
    """True when the scope contains a call whose callee's LAST path
    segment names a touch (``default_ledger.touch``, ``ledger.touch``,
    ``touch_structures`` ...): the evidence that this launch's structure
    reads feed the heat map."""
    for node in ast.walk(scope):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        if name is not None and "touch" in name.rsplit(".", 1)[-1].lower():
            return True
    return False


class UntrackedStructureReadChecker(Checker):
    """TPU017: a launch site in a device-serving module that folds a
    fenced launch into the roofline (``roofline.record_launch``) reads a
    ledger-registered structure — but if the enclosing function never
    records a ledger TOUCH, that access is invisible to the heat map and
    the tiering advisor replays a lie: the structure looks cold while a
    launch path hammers it, and the demotion policy evicts exactly the
    wrong slab. The twin of TPU014 (naked-device-put) for READS: record
    ``default_ledger.touch(...)`` against the structures the launch
    scanned in the same function (the modeled bytes come from the same
    cost-model params the roofline fold uses), or suppress with a comment
    where the launch genuinely reads no resident structure."""

    rule_id = "TPU017"
    name = "untracked-structure-read"
    description = ("roofline.record_launch sites in serving modules must "
                   "record a device-ledger heat touch")

    def applies_to(self, display_path: str, source: str) -> bool:
        return (_device_scoped(display_path, source)
                and "record_launch" in source)

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        out: list[Violation] = []

        def visit(node: ast.AST, ok: bool) -> None:
            # evidence is per-FUNCTION, like TPU014: nested launch
            # closures inherit their enclosing function's touch call
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ok = ok or _calls_touch(node)
            if isinstance(node, ast.Call):
                name = call_name(node)
                # exactly record_launch — record_launch_wall (the mesh
                # metrics hook) and other *_launch* helpers are not reads
                if (name is not None
                        and name.rsplit(".", 1)[-1] == "record_launch"
                        and not ok):
                    out.append(ctx.violation(
                        "TPU017", node,
                        "launch reads a ledger-registered structure "
                        "without touch accounting: record "
                        "default_ledger.touch(...) for the structures "
                        "this launch scanned in this function (or the "
                        "heat map and tiering advisor go blind to it)"))
            for child in ast.iter_child_nodes(node):
                visit(child, ok)

        visit(ctx.tree, ok=False)
        return out


# ---------------------------------------------------------------------------
# TPU018 — cross-pool shared state (thread-role race analysis)
# ---------------------------------------------------------------------------

# a file can only produce roles ON ITS OWN if it contains a dispatch
# idiom; files without one can still be roled by the whole-program pass
# (ctx.external_roles, lint/callgraph.py) — the check()-level gate below
def _role_gate(source: str) -> bool:
    return "self." in source and (
        "_offload" in source or "register" in source
        or "schedule" in source or ".submit(" in source
        or "run_in_executor" in source or "start_server" in source)


def _external_roles(ctx: FileContext) -> dict:
    return getattr(ctx, "external_roles", None) or {}


def _fmt_roles(roles: set[str]) -> str:
    return "/".join(sorted(roles))


def _role_meta(roles: set[str], **extra) -> dict:
    """Structured evidence for --format json: executor roles, collapsed
    domains, plus rule-specific lock evidence (hashable values only —
    Violation.meta is stored as a sorted item tuple)."""
    meta = {
        "roles": tuple(sorted(roles)),
        "domains": tuple(sorted(threadroles.domains(roles))),
    }
    meta.update(extra)
    return meta


_KIND_DESC = {
    threadroles.ITER: "live iteration",
    threadroles.RMW: "read-modify-write",
    threadroles.MUTATE: "mutation",
    threadroles.REBIND: "rebind",
}


class CrossPoolSharedStateChecker(Checker):
    rule_id = "TPU018"
    name = "cross-pool-shared-state"
    description = ("mutable attribute reachable from >= 2 thread roles "
                   "(data worker / search pool / http / timer / transport) "
                   "with a racy access pair holding no lock in common; "
                   "snapshot reads (list(d)/dict(d)) and single-op "
                   "GIL-atomic accesses are recognized as safe, "
                   "`# tpulint: single-role` opts an attribute out")

    def applies_to(self, display_path: str, source: str) -> bool:
        # wide textual gate: the real decision needs ctx.external_roles
        return "class " in source and "self." in source

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        gate = _role_gate(ctx.source)
        ext = _external_roles(ctx)
        if not gate and not any(ext.values()):
            return []
        out: list[Violation] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                if not gate and not ext.get(node.name):
                    continue
                out.extend(self._check_class(ctx, node))
        return out

    def _check_class(self, ctx: FileContext,
                     cls: ast.ClassDef) -> list[Violation]:
        analysis = threadroles.analyze_class(ctx, cls)
        out: list[Violation] = []
        for conflict in analysis.conflicts():
            a, b = conflict.a, conflict.b
            if a.node is b.node:
                detail = (f"this {_KIND_DESC[a.kind]} runs under roles "
                          f"{_fmt_roles(a.scope.roles)} with no lock held")
            else:
                detail = (f"this {_KIND_DESC[a.kind]} "
                          f"({_fmt_roles(a.scope.roles)}) races the "
                          f"{_KIND_DESC[b.kind]} in {b.scope.name}() "
                          f"line {getattr(b.node, 'lineno', '?')} "
                          f"({_fmt_roles(b.scope.roles)}) — no common lock")
            out.append(ctx.violation(
                "TPU018", a.node,
                f"self.{conflict.attr} in {cls.name} is shared across "
                f"thread roles: {detail}; hold one lock on every racy "
                f"path, snapshot with list()/dict() first, or mark the "
                f"attribute `# tpulint: single-role`",
                meta=_role_meta(
                    a.scope.roles | b.scope.roles,
                    attr=conflict.attr,
                    locks=(tuple(sorted(a.held)),
                           tuple(sorted(b.held))),
                    races=(f"{a.kind}@{getattr(a.node, 'lineno', 0)}",
                           f"{b.kind}@{getattr(b.node, 'lineno', 0)}"))))
        return out


# ---------------------------------------------------------------------------
# TPU019 — atomicity: check-then-act / rmw across a lock release
# ---------------------------------------------------------------------------

def _key_repr(node: ast.AST) -> str | None:
    """A stable key identity for check-then-act matching: names,
    constants, and simple dotted attrs. Anything else is unmatched."""
    if isinstance(node, ast.Constant):
        return f"const:{node.value!r}"
    name = dotted_name(node)
    if name is not None:
        return f"name:{name}"
    if isinstance(node, ast.Tuple):
        parts = [_key_repr(e) for e in node.elts]
        if all(p is not None for p in parts):
            return "tuple:" + ",".join(parts)  # type: ignore[arg-type]
    return None


def _shallow_nodes(node: ast.AST):
    """Pre-order walk that does not descend into nested defs/lambdas —
    those are separate scopes with their own lock context."""
    yield node
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        return
    for child in ast.iter_child_nodes(node):
        yield from _shallow_nodes(child)


# Counter methods that merge counts key-by-key: each key is a
# read-modify-write, so the whole call needs the lock.
_COUNTER_RMW = frozenset({"update", "subtract"})

# Mutators that, applied to a defaultdict slot (`self.d[k].append(v)`),
# perform get-or-insert plus mutate as two separate dict operations.
_VIVIFY_MUTATORS = frozenset({"append", "appendleft", "extend", "add",
                              "update", "insert", "remove", "discard",
                              "subtract"})

# Pseudo-key under which an `is None` sentinel test is recorded; the
# prefix cannot collide with _key_repr output ("const:"/"name:"/"tuple:").
_NONE_KEY = "is-none:"

# Value shapes that look like lazy initialisation (a fresh object), as
# opposed to a reset (`= None`) or a plain rebind of a parameter.
_INIT_SHAPES = (ast.Call, ast.Dict, ast.List, ast.Set, ast.ListComp,
                ast.DictComp, ast.SetComp)


class AtomicityChecker(Checker):
    rule_id = "TPU019"
    name = "atomicity"
    description = ("check-then-act (`if k in d:` then `d[k]`/`d.pop(k)`), "
                   "unlocked read-modify-write (`d[k] += v`, "
                   "`Counter.update`, `defaultdict[k].append`), and "
                   "double-checked init without a locked re-test, on state "
                   "shared across thread roles, where the test and the "
                   "act are not covered by one continuous lock hold")

    def applies_to(self, display_path: str, source: str) -> bool:
        # wide textual gate: the real decision needs ctx.external_roles
        return "class " in source and "self." in source

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        gate = _role_gate(ctx.source)
        ext = _external_roles(ctx)
        if not gate and not any(ext.values()):
            return []
        out: list[Violation] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                if not gate and not ext.get(node.name):
                    continue
                out.extend(self._check_class(ctx, node))
        return out

    def _check_class(self, ctx: FileContext,
                     cls: ast.ClassDef) -> list[Violation]:
        analysis = threadroles.analyze_class(ctx, cls)
        shared = analysis.multi_role_attrs()
        if not shared:
            return []
        ctors = self._ctor_types(cls)
        out: list[Violation] = []
        reported: set[int] = set()
        for scope in analysis.scopes:
            if not scope.roles or \
                    scope.method in threadroles._EXEMPT_METHODS:
                continue
            if not any(a.attr in shared for a in scope.accesses):
                continue
            out.extend(self._check_scope(
                ctx, cls, analysis, shared, ctors, scope, reported))
        out.sort(key=Violation.sort_key)
        return out

    @staticmethod
    def _ctor_types(cls: ast.ClassDef) -> dict[str, str]:
        """attr -> ctor name (last dotted segment) for ctor-assigned
        attrs, e.g. ``self._counts = collections.Counter()`` -> Counter."""
        ctors: dict[str, str] = {}
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call):
                name = dotted_name(node.value.func)
                if name is None:
                    continue
                last = name.split(".")[-1]
                for t in node.targets:
                    attr = threadroles.self_attr_of(t)
                    if attr is not None:
                        ctors[attr] = last
        return ctors

    def _check_scope(self, ctx: FileContext, cls: ast.ClassDef,
                     analysis, shared: dict, ctors: dict, scope,
                     reported: set[int]) -> list[Violation]:
        out: list[Violation] = []
        cfg = cfg_mod.build_cfg(scope.node)
        for path in cfg_mod.enumerate_paths(cfg):
            held: list[tuple[str, int]] = []
            epoch = 0
            # (attr, key) -> (held-pairs at the test, test node)
            tests: dict[tuple[str, str], tuple[frozenset, ast.AST]] = {}
            for block in path.blocks:
                for stmt in block.stmts:
                    if isinstance(stmt, cfg_mod.ScopeEnter):
                        lock = threadroles.self_attr_of(stmt.context_expr)
                        if lock in analysis.lock_attrs:
                            epoch += 1
                            held.append((lock, epoch))
                        continue
                    if isinstance(stmt, cfg_mod.ScopeExit):
                        lock = threadroles.self_attr_of(stmt.context_expr)
                        if lock in analysis.lock_attrs:
                            for i in range(len(held) - 1, -1, -1):
                                if held[i][0] == lock:
                                    del held[i]
                                    break
                        continue
                    self._scan(ctx, cls, stmt, shared, ctors, held,
                               tests, reported, scope, out)
        return out

    @staticmethod
    def _meta(shared: dict, attr: str, held_now: frozenset,
              shape: str) -> dict:
        return _role_meta(shared[attr], attr=attr, shape=shape,
                          locks=tuple(sorted(l for l, _ in held_now)))

    def _scan(self, ctx, cls, stmt, shared, ctors, held, tests, reported,
              scope, out) -> None:
        held_now = frozenset(held)
        for node in _shallow_nodes(stmt):
            # containment test: `k in self.d` / `k not in self.d`,
            # or lazy-init sentinel test: `self.x is None`
            if isinstance(node, ast.Compare):
                for op, comp in zip(node.ops, node.comparators):
                    if isinstance(op, (ast.In, ast.NotIn)):
                        attr = threadroles.self_attr_of(comp)
                        if attr in shared:
                            key = _key_repr(node.left)
                            if key is not None:
                                tests[(attr, key)] = (held_now, node)
                    elif isinstance(op, (ast.Is, ast.IsNot)) and \
                            isinstance(comp, ast.Constant) and \
                            comp.value is None:
                        attr = threadroles.self_attr_of(node.left)
                        if attr in shared:
                            tests[(attr, _NONE_KEY)] = (held_now, node)
                continue
            # dependent act: self.d[k] (load/store/del)
            if isinstance(node, ast.Subscript):
                attr = threadroles.self_attr_of(node.value)
                if attr in shared:
                    key = _key_repr(node.slice)
                    self._act(ctx, cls, node, attr, key, held_now,
                              tests, reported, shared, out)
                continue
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute):
                meth = node.func.attr
                # dependent act: self.d.pop(k) with no default
                if meth == "pop" and len(node.args) == 1:
                    attr = threadroles.self_attr_of(node.func.value)
                    if attr in shared:
                        key = _key_repr(node.args[0])
                        self._act(ctx, cls, node, attr, key, held_now,
                                  tests, reported, shared, out)
                    continue
                # unlocked rmw: Counter.update/.subtract merges per key
                if meth in _COUNTER_RMW and not held_now:
                    attr = threadroles.self_attr_of(node.func.value)
                    if attr in shared and \
                            ctors.get(attr) == "Counter" and \
                            id(node) not in reported:
                        reported.add(id(node))
                        out.append(ctx.violation(
                            "TPU019", node,
                            f"Counter.{meth} on self.{attr} in {cls.name} "
                            f"with no lock held: each merged key is a "
                            f"read-modify-write, and self.{attr} is shared "
                            f"across roles {_fmt_roles(shared[attr])}, so "
                            f"concurrent increments are lost (wrap in the "
                            f"lock that guards self.{attr})",
                            meta=self._meta(shared, attr, held_now,
                                            "counter-rmw")))
                    continue
                # unlocked vivify-then-mutate: self.d[k].append(v) on a
                # defaultdict is get-or-insert plus mutate in two steps
                if meth in _VIVIFY_MUTATORS and not held_now and \
                        isinstance(node.func.value, ast.Subscript):
                    attr = threadroles.self_attr_of(node.func.value.value)
                    if attr in shared and \
                            ctors.get(attr) == "defaultdict" and \
                            id(node) not in reported:
                        reported.add(id(node))
                        out.append(ctx.violation(
                            "TPU019", node,
                            f"defaultdict vivify-and-mutate on "
                            f"self.{attr} in {cls.name} with no lock "
                            f"held: `self.{attr}[k].{meth}(...)` inserts "
                            f"the default and mutates it as two separate "
                            f"steps, and self.{attr} is shared across "
                            f"roles {_fmt_roles(shared[attr])}, so two "
                            f"roles can vivify distinct defaults and one "
                            f"mutation is lost (wrap in the lock that "
                            f"guards self.{attr})",
                            meta=self._meta(shared, attr, held_now,
                                            "vivify-mutate")))
                continue
            # unlocked read-modify-write on shared state
            if isinstance(node, ast.AugAssign) and not held_now:
                target = node.target
                attr = threadroles.self_attr_of(target)
                if attr is None and isinstance(target, ast.Subscript):
                    attr = threadroles.self_attr_of(target.value)
                if attr in shared and id(node) not in reported:
                    reported.add(id(node))
                    out.append(ctx.violation(
                        "TPU019", node,
                        f"read-modify-write on self.{attr} in {cls.name} "
                        f"with no lock held; the attribute is shared "
                        f"across roles {_fmt_roles(shared[attr])}, so a "
                        f"concurrent update is lost (wrap in the lock "
                        f"that guards self.{attr})",
                        meta=self._meta(shared, attr, held_now, "rmw")))
                continue
            if isinstance(node, ast.Assign):
                # unlocked rmw spelled as assignment:
                # `self.d[k] = f(self.d[k])`
                if not held_now:
                    for target in node.targets:
                        if not isinstance(target, ast.Subscript):
                            continue
                        attr = threadroles.self_attr_of(target.value)
                        if attr not in shared:
                            continue
                        key = _key_repr(target.slice)
                        if key is None or id(node) in reported:
                            continue
                        if self._reads_slot(node.value, attr, key):
                            reported.add(id(node))
                            out.append(ctx.violation(
                                "TPU019", node,
                                f"read-modify-write on self.{attr}[...] "
                                f"in {cls.name} spelled as an assignment "
                                f"whose right-hand side reads the same "
                                f"slot, with no lock held; self.{attr} is "
                                f"shared across roles "
                                f"{_fmt_roles(shared[attr])}, so a "
                                f"concurrent update is lost (wrap in the "
                                f"lock that guards self.{attr})",
                                meta=self._meta(shared, attr, held_now,
                                                "assign-rmw")))
                # lazy-init act: `self.x = <fresh object>` after an
                # `is None` test — double-checked init must re-test
                # under the lock it initialises under
                for target in node.targets:
                    attr = threadroles.self_attr_of(target)
                    if attr in shared and \
                            isinstance(node.value, _INIT_SHAPES):
                        self._lazy_init_act(
                            ctx, cls, node, attr, held_now, tests,
                            reported, shared, out)

    @staticmethod
    def _reads_slot(value: ast.AST, attr: str, key: str) -> bool:
        for sub in ast.walk(value):
            if isinstance(sub, ast.Subscript) and \
                    threadroles.self_attr_of(sub.value) == attr and \
                    _key_repr(sub.slice) == key:
                return True
        return False

    def _lazy_init_act(self, ctx, cls, node, attr, held_now, tests,
                       reported, shared, out) -> None:
        test = tests.get((attr, _NONE_KEY))
        # Only the double-checked shape is flagged: the init happens
        # under a lock hold that did not cover the sentinel test.  A
        # fully unlocked lazy init is an ordinary (benign-until-shared)
        # race the rmw clauses already police; requiring a hold here
        # keeps the rule from firing on plain cached-property idioms.
        if test is None or not held_now:
            return
        test_held, test_node = test
        if test_held & held_now:
            return  # sentinel re-tested (or tested) under this hold
        if id(node) in reported:
            return
        reported.add(id(node))
        out.append(ctx.violation(
            "TPU019", node,
            f"double-checked init of self.{attr} in {cls.name}: the "
            f"`is None` test at line "
            f"{getattr(test_node, 'lineno', '?')} ran outside the lock "
            f"this assignment holds and is not repeated inside it, so "
            f"two roles {_fmt_roles(shared[attr])} can both pass the "
            f"test and build self.{attr} twice (re-test under the lock "
            f"before assigning)",
            meta=self._meta(shared, attr, held_now, "double-checked-init")))

    def _act(self, ctx, cls, node, attr, key, held_now, tests,
             reported, shared, out) -> None:
        if key is None:
            return
        test = tests.get((attr, key))
        if test is None:
            return
        test_held, test_node = test
        if test_held & held_now:
            return  # one continuous acquisition covers test and act
        if id(node) in reported:
            return
        reported.add(id(node))
        out.append(ctx.violation(
            "TPU019", node,
            f"check-then-act on self.{attr} in {cls.name}: the membership "
            f"test at line {getattr(test_node, 'lineno', '?')} and this "
            f"access are not covered by one continuous lock hold, and "
            f"self.{attr} is shared across roles "
            f"{_fmt_roles(shared[attr])} — another role can mutate it "
            f"in between (take the lock around both, or use "
            f".get()/.pop(k, default))",
            meta=self._meta(shared, attr, held_now, "check-then-act")))


ALL_CHECKERS: list[Checker] = [
    JitPurityChecker(),
    BlockingInAsyncChecker(),
    LockDisciplineChecker(),
    DeterminismChecker(),
    ExceptionHygieneChecker(),
    InjectableIdChecker(),
    RetracingRiskChecker(),
    CallbackLeakChecker(),
    UnboundedGrowthChecker(),
    InterproceduralLockOrderChecker(),
    BlockingOnDataWorkerChecker(),
    SpanLeakChecker(),
    MetricHygieneChecker(),
    NakedDevicePutChecker(),
    UnmodeledKernelChecker(),
    NakedPallasCallChecker(),
    UntrackedStructureReadChecker(),
    CrossPoolSharedStateChecker(),
    AtomicityChecker(),
]

RULES: dict[str, Checker] = {c.rule_id: c for c in ALL_CHECKERS}
