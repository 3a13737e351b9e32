"""Thread-role inference: who-runs-what for the tpulint race rules.

The serving path fans work out across five executor families, and every
hand-off goes through one of a small set of dispatch idioms.  This module
infers, per class, which role(s) each function runs under by recognizing
those idioms at their registration/dispatch sites and propagating the
roles through the class's synchronous call graph:

========================  =================================================
role                      entry recognizer
========================  =================================================
``data-worker``           first arg of ``self._offload(fn)`` /
                          ``self._after_offload(fn, cb)``; ``.submit`` on
                          an executor/pool-named attribute
``search-pool``           first arg of ``self._offload_search(fn, ...)``;
                          ``.submit`` on a search-named executor
``transport``             handler arg of ``transport.register(node, action,
                          handler)`` (incl. the ``reg = transport.register``
                          alias; an action string containing ``:`` marks
                          the transport form); the completion callback of
                          ``_after_offload`` (it fires back on the server
                          loop)
``http-pool``             handler arg of ``router.register("GET", path,
                          handler)`` — first arg an HTTP-method constant
``timer``                 callable arg of ``*.schedule(delay_ms, fn)`` and
                          friends (coordinator/shard ticks, sim timers)
``event-loop``            connection-handler arg of
                          ``asyncio.start_server(handler, ...)`` — the
                          accept path runs as loop callbacks, same domain
                          as timers/transport
``data-worker`` /         callable handed to
``search-pool``           ``loop.run_in_executor(executor, fn)`` — the
                          executor's name decides the pool (``search`` ->
                          search-pool, ``executor``/``pool``/``worker`` ->
                          data-worker); with a branch-assigned executor the
                          callable gets the union of every branch's role
========================  =================================================

Cross-MODULE roles arrive through ``lint/callgraph.py``: a two-pass run
first extracts per-module summaries (per class: in-file roles per
method, attribute/parameter type bindings, outgoing call chains), runs a
global fixpoint resolving chains like ``handler -> node.search() ->
self.search_backpressure.admit()``, and hands each class's externally
derived roles back here as ``entry_roles`` seeds (the ``external``
ctor argument, plumbed via ``ctx.external_roles``).  Single-file runs
fall back to file-local propagation so fixtures stay self-contained.

Propagation is caller -> callee: if a timer tick calls ``self._m()``,
``_m`` runs on the timer too; a nested ``def``/``lambda`` handed to a
dispatcher gets the dispatcher's role, one called directly inherits the
enclosing function's roles.  Functions with no inferred role stay
unknown and are never counted — the race rules built on top (TPU018
cross-pool-shared-state, TPU019 atomicity) only reason about state
reachable from at least two *known* roles, which keeps them quiet on
single-threaded code.

Accesses to ``self.<attr>`` state are classified by how they interact
with the GIL so the rules can tell a benign atomic read from a racy one:

- ``rebind``/``mutate`` — attribute rebinding and single-call container
  mutation (``d[k] = v``, ``d.pop(k, None)``, ``l.append(x)``):
  individually atomic, but they invalidate concurrent iteration.
- ``rmw`` — read-modify-write (``self.c += 1``, ``d[k] += v``): loses
  updates against ANY concurrent write, including itself.
- ``iter`` — live iteration (``for k in self.d``, bare ``.items()``):
  breaks against any concurrent write.
- ``atomic`` — single-op reads (``d[k]``, ``d.get(k)``, ``k in d``):
  never counted as racy.
- ``snapshot`` — the blessed copy idiom (``list(d)``, ``dict(d)``,
  ``sorted(d.items())``, ``len(d)``): safe by construction.

``# tpulint: single-role`` on the attribute's ``__init__`` assignment or
on any access line opts the attribute out class-wide (the author asserts
the apparent multi-role reachability is not real).
"""

from __future__ import annotations

import ast
import re

from opensearch_tpu_torch.lint.core import dotted_name

ROLE_DATA = "data-worker"
ROLE_SEARCH = "search-pool"
ROLE_HTTP = "http-pool"
ROLE_TIMER = "timer"
ROLE_TRANSPORT = "transport"
ROLE_THREAD = "background-thread"
ROLE_LOOP = "event-loop"

ALL_ROLES = (ROLE_DATA, ROLE_SEARCH, ROLE_HTTP, ROLE_TIMER, ROLE_TRANSPORT,
             ROLE_THREAD, ROLE_LOOP)

# Execution DOMAINS: which roles can actually interleave. Timers and
# transport handlers both run on the single-threaded event loop
# (LoopScheduler is loop.call_later; "handlers run on the event loop" —
# transport/tcp.py; the sim queue serializes both the same way), so
# timer-vs-transport is NOT a race. The pools and dedicated threads are
# real OS threads. Runtime confirmation (testing/race_probe.py) refuted
# the first cut of timer-vs-transport findings; this table is the
# resulting recognizer improvement.
DOMAIN = {
    ROLE_DATA: "data",
    ROLE_SEARCH: "search",
    ROLE_HTTP: "http",
    ROLE_TIMER: "loop",
    ROLE_TRANSPORT: "loop",
    ROLE_THREAD: "thread",
    ROLE_LOOP: "loop",
}


def domains(roles: set[str]) -> set[str]:
    return {DOMAIN[r] for r in roles}

# access kinds (see module docstring)
REBIND = "rebind"
MUTATE = "mutate"
RMW = "rmw"
ITER = "iter"
ATOMIC = "atomic"
SNAPSHOT = "snapshot"

WRITE_KINDS = frozenset((REBIND, MUTATE, RMW))

_HTTP_METHODS = {"GET", "POST", "PUT", "DELETE", "HEAD", "PATCH", "OPTIONS"}
_SCHEDULE_SEGMENTS = {"schedule", "schedule_repeating", "call_later",
                      "call_at"}
_OFFLOAD_DATA = {"_offload"}
_OFFLOAD_SEARCH = {"_offload_search"}
_AFTER_OFFLOAD = {"_after_offload"}

_MUTATOR_METHODS = {
    "append", "appendleft", "add", "insert", "extend", "update",
    "setdefault", "pop", "popleft", "popitem", "remove", "discard",
    "clear", "put", "put_nowait", "sort", "reverse",
}
_ITER_METHODS = {"items", "keys", "values"}
_SNAPSHOT_METHODS = {"copy"}
_ATOMIC_METHODS = {"get", "qsize", "empty", "full", "count", "index",
                   "__contains__"}
# C-level one-shot consumers: the whole read happens inside one call with
# no Python-level re-entry, so a concurrent mutator can't interleave
_SNAPSHOT_WRAPPERS = {"list", "dict", "tuple", "set", "frozenset",
                      "sorted", "len", "sum", "min", "max", "any", "all"}

_LOCK_FACTORIES = ("Lock", "RLock", "Condition", "Semaphore",
                   "BoundedSemaphore")
_CONTAINER_CTORS = {"dict", "list", "set", "deque", "defaultdict",
                    "OrderedDict", "Counter"}
_MUTABLE_LITERALS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                     ast.DictComp, ast.SetComp)
# attr values that are mutated via an atomic protocol of their own
_ATOMIC_CTORS = {"count"}  # itertools.count: next() is atomic

_EXEMPT_METHODS = {"__init__", "__new__", "__del__", "__repr__", "__str__",
                   "__enter__", "__exit__", "__post_init__"}

_SINGLE_ROLE_RE = re.compile(r"#\s*tpulint:\s*single-role\b")


def self_attr_of(node: ast.AST) -> str | None:
    """'x' for ``self.x``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def lock_attrs(cls: ast.ClassDef) -> set[str]:
    """The class's lock attributes: ctor-assigned threading primitives
    plus anything lock-named used as ``with self.X:`` (mirrors TPU003)."""
    locks: set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            name = dotted_name(node.value.func)
            if name is not None and name.split(".")[-1] in _LOCK_FACTORIES:
                for t in node.targets:
                    attr = self_attr_of(t)
                    if attr is not None:
                        locks.add(attr)
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                attr = self_attr_of(item.context_expr)
                if attr is not None and "lock" in attr.lower():
                    locks.add(attr)
    return locks


class Access:
    """One classified touch of ``self.<attr>`` inside a scope."""

    __slots__ = ("attr", "node", "kind", "held", "scope")

    def __init__(self, attr: str, node: ast.AST, kind: str,
                 held: frozenset, scope: "Scope"):
        self.attr = attr
        self.node = node
        self.kind = kind
        self.held = held
        self.scope = scope

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Access({self.attr}@{getattr(self.node, 'lineno', '?')} "
                f"{self.kind} held={sorted(self.held)})")


class Scope:
    """A method, nested function, or lambda — the unit roles attach to."""

    __slots__ = ("name", "node", "parent", "method", "entry_roles", "roles",
                 "accesses", "self_calls", "local_calls", "local_defs",
                 "ext_calls")

    def __init__(self, name: str, node: ast.AST, parent: "Scope | None"):
        self.name = name
        self.node = node
        self.parent = parent
        # the top-level method this scope lives in (for exemption checks)
        self.method = parent.method if parent is not None else name
        self.entry_roles: set[str] = set()
        self.roles: set[str] = set()
        self.accesses: list[Access] = []
        self.self_calls: set[str] = set()
        self.local_calls: set[str] = set()
        self.local_defs: dict[str, "Scope"] = {}
        # outgoing cross-object call chains, alias-resolved:
        # (root, attr_chain, callee) — root is "self" or a bare name the
        # summary layer binds to a parameter; e.g. self._svc.admit() ->
        # ("self", ("_svc",), "admit"), node.search() -> ("node", (), "search")
        self.ext_calls: list[tuple[str, tuple[str, ...], str]] = []

    def lookup_local(self, name: str) -> "Scope | None":
        scope: Scope | None = self
        while scope is not None:
            child = scope.local_defs.get(name)
            if child is not None:
                return child
            scope = scope.parent
        return None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Scope({self.name}, roles={sorted(self.roles)})"


class Conflict:
    """A racy access pair TPU018 reports: ``a`` is the racy read/rmw,
    ``b`` the write it races with (may be the same access for an rmw
    reachable from two roles)."""

    __slots__ = ("attr", "a", "b")

    def __init__(self, attr: str, a: Access, b: Access):
        self.attr = attr
        self.a = a
        self.b = b


class ClassRoleAnalysis:
    """Role inference + shared-state access classification for one class."""

    def __init__(self, cls: ast.ClassDef, lines: list[str],
                 external: "dict[str, object] | None" = None):
        self.cls = cls
        # method -> iterable of roles derived by the whole-program pass
        # (callgraph.py); seeded as entry_roles so in-class propagation
        # carries them into self-called helpers and nested defs
        self.external = external or {}
        self.lock_attrs = lock_attrs(cls)
        self.mutable_attrs: dict[str, ast.AST] = {}
        self.single_role: set[str] = set()
        self.scopes: list[Scope] = []
        self.methods: dict[str, Scope] = {}
        # id(def/lambda node) -> its Scope, for dispatch-arg resolution
        self.expr_scopes: dict[int, Scope] = {}
        # (callable expr, role) tags collected during the walk
        self.pending_tags: list[tuple[ast.AST, str]] = []
        self._marker_lines = {
            i for i, text in enumerate(lines, start=1)
            if _SINGLE_ROLE_RE.search(text)
        }
        self._analyze()

    # -- construction ------------------------------------------------------

    def _analyze(self) -> None:
        self._collect_mutable_attrs()
        for item in self.cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scope = Scope(item.name, item, None)
                self.scopes.append(scope)
                # latest def wins on duplicate names (matches runtime)
                self.methods[item.name] = scope
        for scope in list(self.scopes):
            walker = _ScopeWalker(self, scope)
            for stmt in scope.node.body:
                walker.visit(stmt)
        for name, roles in self.external.items():
            scope = self.methods.get(name)
            if scope is not None:
                scope.entry_roles.update(
                    r for r in roles if r in DOMAIN)
        self._apply_tags()
        self._propagate()

    def _collect_mutable_attrs(self) -> None:
        none_sentinel: set[str] = set()
        lazy_built: dict[str, ast.AST] = {}
        for node in ast.walk(self.cls):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    attr = self_attr_of(t)
                    if attr is None or attr in self.lock_attrs:
                        continue
                    if node.value is not None and \
                            self._is_mutable_value(node.value):
                        self.mutable_attrs.setdefault(attr, node)
                        if node.lineno in self._marker_lines:
                            self.single_role.add(attr)
                    elif isinstance(node.value, ast.Constant) and \
                            node.value.value is None:
                        none_sentinel.add(attr)
                    elif isinstance(node.value, ast.Call) and \
                            not self._is_atomic_ctor(node.value):
                        lazy_built.setdefault(attr, node)
            elif isinstance(node, ast.AugAssign):
                attr = self_attr_of(node.target)
                if attr is not None and attr not in self.lock_attrs:
                    # a scalar counter: += makes it read-modify-write state
                    self.mutable_attrs.setdefault(attr, node)
        # lazy-init state: `self.x = None` plus a later `self.x = build()`
        # is the double-checked-init shape — mutable even though neither
        # assign is a container literal or ctor
        for attr in none_sentinel & set(lazy_built):
            self.mutable_attrs.setdefault(attr, lazy_built[attr])

    @staticmethod
    def _is_atomic_ctor(value: ast.Call) -> bool:
        name = dotted_name(value.func)
        return (name is not None
                and name.split(".")[-1] in _ATOMIC_CTORS)

    def _is_mutable_value(self, value: ast.expr) -> bool:
        if isinstance(value, _MUTABLE_LITERALS):
            return True
        if isinstance(value, ast.Call):
            name = dotted_name(value.func)
            if name is not None:
                last = name.split(".")[-1]
                if last in _ATOMIC_CTORS:
                    return False
                return last in _CONTAINER_CTORS
        return False

    def _apply_tags(self) -> None:
        for expr, role in self.pending_tags:
            scope = self._resolve_callable(expr)
            if scope is not None:
                scope.entry_roles.add(role)

    def _resolve_callable(self, expr: ast.AST) -> Scope | None:
        if isinstance(expr, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            return self.expr_scopes.get(id(expr))
        attr = self_attr_of(expr)
        if attr is not None:
            return self.methods.get(attr)
        if isinstance(expr, ast.Name):
            owner = getattr(expr, "_tpulint_scope", None)
            if owner is not None:
                return owner.lookup_local(expr.id)
            return None
        if isinstance(expr, ast.Call):
            # functools.partial(fn, ...) and friends: tag the first arg
            name = dotted_name(expr.func)
            if name is not None and name.split(".")[-1] == "partial" \
                    and expr.args:
                return self._resolve_callable(expr.args[0])
        return None

    def _propagate(self) -> None:
        for scope in self.scopes:
            scope.roles |= scope.entry_roles
        changed = True
        while changed:
            changed = False
            for scope in self.scopes:
                if not scope.roles:
                    continue
                for m in scope.self_calls:
                    callee = self.methods.get(m)
                    if callee is not None and not \
                            scope.roles <= callee.roles:
                        callee.roles |= scope.roles
                        changed = True
                for n in scope.local_calls:
                    callee = scope.lookup_local(n)
                    if callee is not None and not \
                            scope.roles <= callee.roles:
                        callee.roles |= scope.roles
                        changed = True

    # -- queries -----------------------------------------------------------

    def counted_accesses(self, attr: str) -> list[Access]:
        """Accesses to ``attr`` from scopes with a known role, outside the
        exempt (pre-sharing / teardown) methods."""
        out = []
        for scope in self.scopes:
            if not scope.roles or scope.method in _EXEMPT_METHODS:
                continue
            for acc in scope.accesses:
                if acc.attr == attr:
                    out.append(acc)
        return out

    def attr_roles(self, attr: str) -> set[str]:
        roles: set[str] = set()
        for acc in self.counted_accesses(attr):
            roles |= acc.scope.roles
        return roles

    def multi_role_attrs(self) -> dict[str, set[str]]:
        """Mutable attrs written by at least one known role and reachable
        (any access kind) from >= 2 roles — the TPU019 universe."""
        out: dict[str, set[str]] = {}
        for attr in self.mutable_attrs:
            if attr in self.single_role:
                continue
            counted = self.counted_accesses(attr)
            if not any(a.kind in WRITE_KINDS for a in counted):
                continue
            roles: set[str] = set()
            for a in counted:
                roles |= a.scope.roles
            if len(domains(roles)) >= 2:
                out[attr] = roles
        return out

    def conflicts(self) -> list[Conflict]:
        """The TPU018 findings: for each shared attr, the first racy
        access pair — (iter vs write) or (rmw vs write) — spanning >= 2
        roles with no lock in common."""
        out: list[Conflict] = []
        for attr in sorted(self.mutable_attrs):
            if attr in self.single_role:
                continue
            counted = self.counted_accesses(attr)
            counted.sort(key=lambda a: (getattr(a.node, "lineno", 0),
                                        getattr(a.node, "col_offset", 0)))
            writes = [a for a in counted if a.kind in WRITE_KINDS]
            racy = [a for a in counted if a.kind in (ITER, RMW)]
            found: Conflict | None = None
            for a in racy:
                for b in writes:
                    if a.node is b.node and a.kind != RMW:
                        continue
                    if a.node is b.node and \
                            len(domains(a.scope.roles)) < 2:
                        continue  # an rmw only races itself across domains
                    if len(domains(a.scope.roles | b.scope.roles)) < 2:
                        continue
                    if a.held & b.held:
                        continue  # a common lock serializes the pair
                    found = Conflict(attr, a, b)
                    break
                if found:
                    break
            if found:
                out.append(found)
        return out


class _ScopeWalker(ast.NodeVisitor):
    """One pass over a scope body: classify self-attr accesses under the
    held-lock stack, record call edges, and collect dispatch-entry tags.
    Nested defs/lambdas become child scopes walked with a fresh stack
    (they run later, without the enclosing locks)."""

    def __init__(self, analysis: ClassRoleAnalysis, scope: Scope):
        self.a = analysis
        self.scope = scope
        self.held: list[str] = []
        # local name -> dotted source, for alias resolution at dispatch
        # sites: `reg = transport.register`, `t = self.transport`,
        # `b = getattr(self.node, "breakers", None)`
        self.name_sources: dict[str, str] = {}
        # same, but keeping EVERY branch's assignment (`executor = a`
        # in one arm, `executor = b` in the other) — run_in_executor
        # roles the callable with the union over branches
        self.name_sources_multi: dict[str, set[str]] = {}

    # -- helpers -----------------------------------------------------------

    def _rec(self, attr: str, node: ast.AST, kind: str) -> None:
        if attr in self.a.lock_attrs:
            return
        if getattr(node, "lineno", 0) in self.a._marker_lines:
            self.a.single_role.add(attr)
        self.scope.accesses.append(
            Access(attr, node, kind, frozenset(self.held), self.scope))

    def _tag(self, expr: ast.AST | None, role: str) -> None:
        if expr is None:
            return
        if isinstance(expr, ast.Name):
            # remember where the name was seen so resolution can search
            # the right scope chain after the walk completes
            expr._tpulint_scope = self.scope  # type: ignore[attr-defined]
        self.a.pending_tags.append((expr, role))

    def _child_scope(self, node: ast.AST, name: str) -> Scope:
        child = Scope(f"{self.scope.name}.{name}", node, self.scope)
        self.a.scopes.append(child)
        self.a.expr_scopes[id(node)] = child
        return child

    def _snapshot_target(self, expr: ast.AST) -> str | None:
        """'d' when expr is ``self.d`` or ``self.d.items()/keys()/values()``."""
        attr = self_attr_of(expr)
        if attr is not None:
            return attr
        if (isinstance(expr, ast.Call) and not expr.args
                and isinstance(expr.func, ast.Attribute)
                and expr.func.attr in _ITER_METHODS):
            return self_attr_of(expr.func.value)
        return None

    # -- scopes ------------------------------------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        child = self._child_scope(node, node.name)
        self.scope.local_defs[node.name] = child
        walker = _ScopeWalker(self.a, child)
        for stmt in node.body:
            walker.visit(stmt)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Lambda(self, node: ast.Lambda) -> None:
        child = self._child_scope(node, f"<lambda:{node.lineno}>")
        walker = _ScopeWalker(self.a, child)
        walker.visit(node.body)

    # -- locks -------------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        acquired: list[str] = []
        for item in node.items:
            attr = self_attr_of(item.context_expr)
            if attr is not None and attr in self.a.lock_attrs:
                acquired.append(attr)
            else:
                self.visit(item.context_expr)
        self.held.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        if acquired:
            del self.held[-len(acquired):]

    visit_AsyncWith = visit_With  # type: ignore[assignment]

    # -- access classification --------------------------------------------

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        target = node.target
        attr = self_attr_of(target)
        if attr is None and isinstance(target, ast.Subscript):
            attr = self_attr_of(target.value)
            if attr is not None:
                self.visit(target.slice)
        if attr is not None:
            self._rec(attr, node, RMW)
        else:
            self.visit(target)
        self.visit(node.value)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        attr = self_attr_of(node.value)
        if attr is not None:
            kind = ATOMIC if isinstance(node.ctx, ast.Load) else MUTATE
            self._rec(attr, node, kind)
            self.visit(node.slice)
            return
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = self_attr_of(node)
        if attr is not None:
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                self._rec(attr, node, REBIND)
            else:
                # a bare reference (passed/returned/truth-tested): the
                # read of the reference itself is atomic
                self._rec(attr, node, ATOMIC)
            return
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for target in node.targets:
            if isinstance(target, ast.Subscript):
                attr = self_attr_of(target.value)
                if attr is not None:
                    self._rec(attr, target, MUTATE)
                    self.visit(target.slice)
                    continue
            self.visit(target)

    def _classify_iter(self, expr: ast.AST) -> bool:
        """Record a live-iteration read when expr is ``self.d`` or
        ``self.d.items()`` etc.; True when consumed."""
        attr = self._snapshot_target(expr)
        if attr is not None:
            self._rec(attr, expr, ITER)
            return True
        return False

    def visit_For(self, node: ast.For) -> None:
        if not self._classify_iter(node.iter):
            self.visit(node.iter)
        self.visit(node.target)
        for stmt in node.body + node.orelse:
            self.visit(stmt)

    visit_AsyncFor = visit_For  # type: ignore[assignment]

    def _visit_comprehension(self, node) -> None:
        for gen in node.generators:
            if not self._classify_iter(gen.iter):
                self.visit(gen.iter)
            self.visit(gen.target)
            for test in gen.ifs:
                self.visit(test)
        for field in ("elt", "key", "value"):
            sub = getattr(node, field, None)
            if sub is not None:
                self.visit(sub)

    visit_ListComp = _visit_comprehension
    visit_SetComp = _visit_comprehension
    visit_DictComp = _visit_comprehension
    visit_GeneratorExp = _visit_comprehension

    def visit_Compare(self, node: ast.Compare) -> None:
        # `k in self.d` is an atomic containment probe
        for op, comparator in zip(node.ops, node.comparators):
            if isinstance(op, (ast.In, ast.NotIn)):
                attr = self_attr_of(comparator)
                if attr is not None:
                    self._rec(attr, comparator, ATOMIC)
                    continue
            self.visit(comparator)
        self.visit(node.left)

    # -- calls: dispatch recognizers + container methods ------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        # track simple aliases (scope-local): `reg = transport.register`,
        # `t = self.transport` — dispatch recognition resolves through them
        if (len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            source = dotted_name(node.value)
            if source is None:
                source = self._getattr_source(node.value)
            if source is not None:
                target = node.targets[0].id
                self.name_sources[target] = source
                self.name_sources_multi.setdefault(target, set()).add(source)
        self.generic_visit(node)

    @staticmethod
    def _getattr_source(value: ast.AST) -> str | None:
        """'self.node.breakers' for ``getattr(self.node, "breakers", d)``
        — the duck-typed attribute walk the wiring code favors."""
        if (isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)
                and value.func.id == "getattr"
                and len(value.args) >= 2
                and isinstance(value.args[1], ast.Constant)
                and isinstance(value.args[1].value, str)):
            base = dotted_name(value.args[0])
            if base is not None:
                return f"{base}.{value.args[1].value}"
        return None

    def _call_source(self, fn: ast.AST) -> str:
        """The call target's dotted source with local aliases resolved
        one level: ``t.register`` -> ``self.transport.register``."""
        name = dotted_name(fn)
        if name is None:
            return ""
        head, sep, rest = name.partition(".")
        resolved = self.name_sources.get(head)
        if resolved is not None:
            return f"{resolved}{sep}{rest}" if sep else resolved
        return name

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func

        # snapshot wrappers: list(self.d), sorted(self.d.items()), len(...)
        if (isinstance(fn, ast.Name) and fn.id in _SNAPSHOT_WRAPPERS
                and node.args):
            attr = self._snapshot_target(node.args[0])
            if attr is not None:
                self._rec(attr, node, SNAPSHOT)
                for arg in node.args[1:]:
                    self.visit(arg)
                for kw in node.keywords:
                    self.visit(kw.value)
                return

        # container method on self state: self.d.append(x), self.d.get(k)
        if isinstance(fn, ast.Attribute):
            attr = self_attr_of(fn.value)
            if attr is not None:
                if fn.attr in _MUTATOR_METHODS:
                    self._rec(attr, node, MUTATE)
                elif fn.attr in _ITER_METHODS:
                    self._rec(attr, node, ITER)
                elif fn.attr in _SNAPSHOT_METHODS:
                    self._rec(attr, node, SNAPSHOT)
                elif fn.attr in _ATOMIC_METHODS:
                    self._rec(attr, node, ATOMIC)
                for arg in node.args:
                    self.visit(arg)
                for kw in node.keywords:
                    self.visit(kw.value)
                self._dispatch_tags(node)
                return
            # slot mutation through the container: self.d[k].append(x)
            # mutates d's contents (and on a defaultdict vivifies the
            # slot as a separate step first)
            if isinstance(fn.value, ast.Subscript) and \
                    fn.attr in _MUTATOR_METHODS:
                owner = self_attr_of(fn.value.value)
                if owner is not None:
                    self._rec(owner, node, MUTATE)
                    self.visit(fn.value.slice)
                    for arg in node.args:
                        self.visit(arg)
                    for kw in node.keywords:
                        self.visit(kw.value)
                    self._dispatch_tags(node)
                    return

        self._dispatch_tags(node)
        self.generic_visit(node)

    def _dispatch_tags(self, node: ast.Call) -> None:
        fn = node.func
        last = None
        if isinstance(fn, ast.Attribute):
            last = fn.attr
        elif isinstance(fn, ast.Name):
            last = fn.id

        # cross-object call chains for the whole-program summary:
        # self.a.b.m() -> ("self", ("a","b"), "m"); param.m() ->
        # ("param", (), "m").  `self.m()` stays an intra-class edge.
        resolved = self._call_source(fn)
        if resolved:
            parts = resolved.split(".")
            if parts[0] == "self":
                if len(parts) >= 3:
                    self.scope.ext_calls.append(
                        ("self", tuple(parts[1:-1]), parts[-1]))
            elif len(parts) >= 2:
                self.scope.ext_calls.append(
                    (parts[0], tuple(parts[1:-1]), parts[-1]))

        # self._offload(fn) / self._after_offload(fn, cb) / _offload_search
        self_method = self_attr_of(fn)
        if self_method is not None:
            self.scope.self_calls.add(self_method)
            if self_method in _OFFLOAD_DATA and node.args:
                self._tag(node.args[0], ROLE_DATA)
            elif self_method in _AFTER_OFFLOAD and node.args:
                self._tag(node.args[0], ROLE_DATA)
                if len(node.args) > 1:
                    self._tag(node.args[1], ROLE_TRANSPORT)
            elif self_method in _OFFLOAD_SEARCH and node.args:
                self._tag(node.args[0], ROLE_SEARCH)
            return

        # direct call of a nested def: callee inherits this scope's roles
        if isinstance(fn, ast.Name):
            if self.scope.lookup_local(fn.id) is not None:
                self.scope.local_calls.add(fn.id)

        # pool.submit(fn): the submitted callable runs on that pool
        if last == "submit" and node.args and isinstance(fn, ast.Attribute):
            receiver = (dotted_name(fn.value) or "").lower()
            if "search" in receiver:
                self._tag(node.args[0], ROLE_SEARCH)
            elif "executor" in receiver or "pool" in receiver \
                    or "worker" in receiver:
                self._tag(node.args[0], ROLE_DATA)

        # handler registration: transport + http router forms
        source = self._call_source(fn)
        if node.args and (last == "register"
                          or source.rsplit(".", 1)[-1] == "register"):
            first = node.args[0]
            handler = node.args[-1]
            handler_attr = self_attr_of(handler) or ""
            if (len(node.args) >= 3 and isinstance(first, ast.Constant)
                    and first.value in _HTTP_METHODS):
                self._tag(handler, ROLE_HTTP)
            elif len(node.args) >= 2 and (
                    "transport" in source.lower()
                    or handler_attr.startswith("_on_")
                    or any(isinstance(a, ast.Constant)
                           and isinstance(a.value, str) and ":" in a.value
                           for a in node.args[:-1])):
                self._tag(handler, ROLE_TRANSPORT)

        # timers: scheduler.schedule(delay_ms, fn)
        if last in _SCHEDULE_SEGMENTS and len(node.args) >= 2:
            self._tag(node.args[1], ROLE_TIMER)

        # the accept path: asyncio.start_server(self._handle_conn, ...)
        # runs the handler as loop callbacks — same domain as timers
        if last == "start_server" and node.args:
            self._tag(node.args[0], ROLE_LOOP)

        # loop.run_in_executor(executor, fn, *args): fn runs on the pool
        # the executor names; a contextvars trampoline
        # (`run_in_executor(ex, ctx.run, fn)`) unwraps to the real fn
        if last == "run_in_executor" and len(node.args) >= 2:
            target = node.args[1]
            tname = self._call_source(target) or dotted_name(target) or ""
            if tname.split(".")[-1] == "run" and len(node.args) >= 3:
                target = node.args[2]
            sources: set[str] = set()
            direct = dotted_name(node.args[0])
            if direct is not None:
                sources.add(direct)
            if isinstance(node.args[0], ast.Name):
                sources |= self.name_sources_multi.get(node.args[0].id,
                                                       set())
            for src in sources:
                low = src.lower()
                if "search" in low:
                    self._tag(target, ROLE_SEARCH)
                elif "executor" in low or "pool" in low or "worker" in low:
                    self._tag(target, ROLE_DATA)

        # a dedicated OS thread: threading.Thread(target=fn)
        if last == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    self._tag(kw.value, ROLE_THREAD)


def analyze_class(ctx, cls: ast.ClassDef) -> ClassRoleAnalysis:
    """Memoized per-FileContext analysis so TPU018 and TPU019 share one
    pass over each class.  ``ctx.external_roles`` (set by the lint driver
    from the callgraph fixpoint: ``{class: {method: [roles]}}``) seeds
    entry roles derived from callers in OTHER modules."""
    cache = ctx.__dict__.setdefault("_threadrole_cache", {})
    analysis = cache.get(id(cls))
    if analysis is None:
        ext = getattr(ctx, "external_roles", None) or {}
        analysis = ClassRoleAnalysis(cls, ctx.lines,
                                     external=ext.get(cls.name))
        cache[id(cls)] = analysis
    return analysis
