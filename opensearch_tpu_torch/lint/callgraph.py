"""Whole-program thread-role summaries for the tpulint race rules.

`threadroles.py` infers roles from dispatch idioms visible inside ONE
file; services whose callers live in other modules (the drilled pair:
``SearchBackpressureService``, ``HierarchyBreakerService``) stayed
unknown and needed the runtime drill.  This module closes that gap the
way TPU010 exports lock summaries — a two-pass whole-program analysis:

1. **Extract** (per module, cached by content hash): for every class,
   the in-file roles per method, the attribute/parameter type bindings
   (``self.breakers = HierarchyBreakerService()``, ctor params annotated
   and stored, ``getattr(self.node, "breakers", None)`` duck walks), and
   every outgoing cross-object call chain (``Scope.ext_calls``); for
   every module function, its registration-derived roles (the REST
   router's ``reg("GET", path, handler)`` form), parameter bindings, and
   the call chains rooted at annotated params (``node.search()`` inside
   a handler whose signature says ``node: TorchNode``).

2. **Fixpoint** (global): merge class summaries by simple name (a
   documented over-approximation — two same-named classes pool their
   bindings), then iterate role flow until stable: function roles flow
   along function->function calls and through param-rooted chains into
   class methods; class-rooted chains (``self.a.b.m()``) resolve
   through the pooled attribute bindings and carry the owning scope's
   roles — including roles the fixpoint itself added to the enclosing
   method, tracked per edge via the in-class flow set ``m``.

The result — ``{class: {method: [roles]}}`` — feeds back into
``ClassRoleAnalysis`` as ``entry_roles`` seeds (``ctx.external_roles``),
so TPU018/TPU019 judge cross-module shared state with real domains
instead of "unknown".  Summaries serialize to
``.tpulint_torch_cache.json`` at the repo root (apart from the reference
linter's cache) keyed on a sha256 of each file's bytes, so single-file
lint stays incremental; ``use_cache=False`` bypasses it.

Known edges this pass does NOT see: duck
typing that never states a type (``ClusterFacade`` handing itself to
REST handlers annotated ``TorchNode``), registry lookups keyed by runtime
strings, and roles crossing process boundaries.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os

from opensearch_tpu_torch.lint.core import dotted_name
from opensearch_tpu_torch.lint.threadroles import (
    _HTTP_METHODS,
    _SCHEDULE_SEGMENTS,
    ClassRoleAnalysis,
    ROLE_HTTP,
    ROLE_THREAD,
    ROLE_TIMER,
    ROLE_TRANSPORT,
)

SUMMARY_VERSION = 1
CACHE_BASENAME = ".tpulint_torch_cache.json"

# names that look class-ish inside annotations but never bind state
_NON_CLASSES = {"None", "Optional", "Union", "Any", "Callable", "Self",
                "Type", "List", "Dict", "Set", "Tuple", "Iterable",
                "Iterator", "Sequence", "Mapping", "Awaitable"}

_MAX_FIXPOINT_ROUNDS = 50


def _ann_classes(node: ast.AST | None) -> list[str]:
    """Candidate class names named by an annotation: handles ``Foo``,
    ``pkg.Foo``, ``Foo | None``, ``Optional[Foo]``, ``Union[A, B]`` and
    string annotations of all of the above."""
    out: list[str] = []

    def add(name: str) -> None:
        last = name.split(".")[-1]
        if last and last[0].isupper() and last not in _NON_CLASSES:
            out.append(last)

    def walk(n: ast.AST | None) -> None:
        if n is None:
            return
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            try:
                walk(ast.parse(n.value, mode="eval").body)
            except SyntaxError:
                pass
        elif isinstance(n, ast.Name):
            add(n.id)
        elif isinstance(n, ast.Attribute):
            d = dotted_name(n)
            if d is not None:
                add(d)
        elif isinstance(n, ast.BinOp) and isinstance(n.op, ast.BitOr):
            walk(n.left)
            walk(n.right)
        elif isinstance(n, ast.Subscript):
            head = (dotted_name(n.value) or "").split(".")[-1]
            if head in ("Optional", "Union"):
                walk(n.slice)
        elif isinstance(n, ast.Tuple):
            for elt in n.elts:
                walk(elt)

    walk(node)
    return out


def _param_classes(fn: ast.FunctionDef | ast.AsyncFunctionDef) \
        -> dict[str, list[str]]:
    params: dict[str, list[str]] = {}
    args = fn.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        classes = _ann_classes(a.annotation)
        if classes:
            params[a.arg] = classes
    return params


def _class_bindings(cls: ast.ClassDef) -> dict[str, set[str]]:
    """attr -> candidate classes, from ctor calls (``self.x = Foo(...)``),
    annotated-param passthrough (``self._parent = parent`` where the
    signature says ``parent: Foo | None``), and attribute annotations."""
    bindings: dict[str, set[str]] = {}
    for item in cls.body:
        if isinstance(item, ast.AnnAssign) and isinstance(item.target,
                                                          ast.Name):
            classes = _ann_classes(item.annotation)
            if classes:
                bindings.setdefault(item.target.id, set()).update(classes)
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = _param_classes(item)
        for node in ast.walk(item):
            if isinstance(node, ast.Assign):
                value = node.value
                for t in node.targets:
                    if not (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        continue
                    if isinstance(value, ast.Call):
                        name = dotted_name(value.func)
                        if name is not None:
                            last = name.split(".")[-1]
                            if last[:1].isupper() and \
                                    last not in _NON_CLASSES:
                                bindings.setdefault(t.attr,
                                                    set()).add(last)
                    elif isinstance(value, ast.Name) and \
                            value.id in params:
                        bindings.setdefault(t.attr, set()).update(
                            params[value.id])
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Attribute) and \
                    isinstance(node.target.value, ast.Name) and \
                    node.target.value.id == "self":
                classes = _ann_classes(node.annotation)
                if classes:
                    bindings.setdefault(node.target.attr,
                                        set()).update(classes)
    return bindings


def _role_flows(analysis: ClassRoleAnalysis) -> dict[int, set[str]]:
    """scope-id -> the method names whose (future, externally added)
    roles reach that scope through in-class propagation — the same
    self_calls/local_calls edges ``ClassRoleAnalysis._propagate`` walks."""
    flows: dict[int, set[str]] = {id(s): set() for s in analysis.scopes}
    for seed, seed_scope in analysis.methods.items():
        stack = [seed_scope]
        visited: set[int] = set()
        while stack:
            scope = stack.pop()
            if id(scope) in visited:
                continue
            visited.add(id(scope))
            flows[id(scope)].add(seed)
            for m in scope.self_calls:
                callee = analysis.methods.get(m)
                if callee is not None:
                    stack.append(callee)
            for n in scope.local_calls:
                child = scope.lookup_local(n)
                if child is not None:
                    stack.append(child)
    return flows


def _extract_class(cls: ast.ClassDef, lines: list[str]) -> dict:
    analysis = ClassRoleAnalysis(cls, lines)
    bindings = _class_bindings(cls)
    flows = _role_flows(analysis)
    edges: list[dict] = []
    for scope in analysis.scopes:
        if not scope.ext_calls:
            continue
        carriers = sorted(flows.get(id(scope), ()))
        roles = sorted(scope.roles)
        # param -> classes for this scope chain (method params cover the
        # common `def handle(self, req: Foo)` shape)
        params: dict[str, list[str]] = {}
        walk: object = scope
        while walk is not None:
            node = walk.node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for name, classes in _param_classes(node).items():
                    params.setdefault(name, classes)
            walk = walk.parent
        for root, chain, callee in scope.ext_calls:
            if root == "self":
                if not chain or chain[0] not in bindings:
                    continue  # unbound head: chain can never resolve
                edges.append({"kind": "self", "chain": list(chain),
                              "callee": callee, "m": carriers,
                              "roles": roles})
            elif root in params:
                edges.append({"kind": "param",
                              "classes": params[root],
                              "chain": list(chain), "callee": callee,
                              "m": carriers, "roles": roles})
    return {
        "methods": sorted(analysis.methods),
        "base_roles": {m: sorted(s.roles)
                       for m, s in analysis.methods.items() if s.roles},
        "bindings": {attr: sorted(v) for attr, v in bindings.items()},
        "edges": edges,
    }


class _FnWalker:
    """Module-function pass: aliases, registration recognizers (tagging
    OTHER module functions — the router builder names its handlers),
    param-rooted call chains, and module-function call edges."""

    def __init__(self, fn_names: set[str]):
        self.fn_names = fn_names
        self.aliases: dict[str, str] = {}
        self.edges: list[dict] = []
        self.calls: set[str] = set()
        self.tags: dict[str, set[str]] = {}

    def _source(self, node: ast.AST) -> str:
        name = dotted_name(node)
        if name is None:
            return ""
        head, sep, rest = name.partition(".")
        resolved = self.aliases.get(head)
        if resolved is not None:
            return f"{resolved}{sep}{rest}" if sep else resolved
        return name

    def _tag(self, handler: ast.AST, role: str) -> None:
        if isinstance(handler, ast.Name) and handler.id in self.fn_names:
            self.tags.setdefault(handler.id, set()).add(role)

    def run(self, fn: ast.FunctionDef | ast.AsyncFunctionDef) -> dict:
        params = _param_classes(fn)
        body_nodes = list(ast.walk(fn))
        for node in body_nodes:  # aliases first: use sites may precede
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                source = dotted_name(node.value)
                if source is not None:
                    self.aliases.setdefault(node.targets[0].id, source)
        for node in body_nodes:
            if not isinstance(node, ast.Call):
                continue
            self._visit_call(node, params)
        return {
            "roles": [],
            "calls": sorted(self.calls),
            "edges": self.edges,
        }

    def _visit_call(self, node: ast.Call,
                    params: dict[str, list[str]]) -> None:
        fn = node.func
        source = self._source(fn)
        parts = source.split(".") if source else []
        last = parts[-1] if parts else None

        if isinstance(fn, ast.Name) and fn.id in self.fn_names:
            self.calls.add(fn.id)

        if len(parts) >= 2 and parts[0] in params:
            self.edges.append({"kind": "param",
                               "classes": params[parts[0]],
                               "chain": parts[1:-1], "callee": parts[-1],
                               "m": [], "roles": []})

        if node.args and last == "register":
            first = node.args[0]
            handler = node.args[-1]
            if (len(node.args) >= 3 and isinstance(first, ast.Constant)
                    and first.value in _HTTP_METHODS):
                self._tag(handler, ROLE_HTTP)
            elif len(node.args) >= 2 and (
                    "transport" in source.lower()
                    or any(isinstance(a, ast.Constant)
                           and isinstance(a.value, str) and ":" in a.value
                           for a in node.args[:-1])):
                self._tag(handler, ROLE_TRANSPORT)
        if last in _SCHEDULE_SEGMENTS and len(node.args) >= 2:
            self._tag(node.args[1], ROLE_TIMER)
        if last == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    self._tag(kw.value, ROLE_THREAD)


def extract_module(source: str, tree: ast.Module | None = None) -> dict:
    """One module's role summary — pure lists/dicts, JSON-ready."""
    if tree is None:
        tree = ast.parse(source)
    lines = source.splitlines()
    classes: dict[str, dict] = {}
    fn_defs: dict[str, ast.FunctionDef | ast.AsyncFunctionDef] = {}
    for item in tree.body:
        if isinstance(item, ast.ClassDef):
            classes[item.name] = _extract_class(item, lines)
        elif isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn_defs[item.name] = item
    fn_names = set(fn_defs)
    functions: dict[str, dict] = {}
    tags: dict[str, set[str]] = {}
    for name, fn in fn_defs.items():
        walker = _FnWalker(fn_names)
        functions[name] = walker.run(fn)
        for tagged, roles in walker.tags.items():
            tags.setdefault(tagged, set()).update(roles)
    for name, roles in tags.items():
        entry = functions.get(name)
        if entry is not None:
            entry["roles"] = sorted(set(entry["roles"]) | roles)
    return {"classes": classes, "functions": functions}


def compute_program_roles(summaries: dict[str, dict]) \
        -> dict[str, dict[str, list[str]]]:
    """Global fixpoint over the per-module summaries; returns
    ``{class: {method: [roles]}}`` for every method any role reaches."""
    classes: dict[str, dict] = {}
    for summary in summaries.values():
        for cname, c in summary.get("classes", {}).items():
            merged = classes.setdefault(
                cname, {"bindings": {}, "edges": [], "roles": {},
                        "methods": set()})
            for attr, names in c.get("bindings", {}).items():
                merged["bindings"].setdefault(attr, set()).update(names)
            merged["edges"].extend(c.get("edges", ()))
            for m, roles in c.get("base_roles", {}).items():
                merged["roles"].setdefault(m, set()).update(roles)
            merged["methods"].update(c.get("methods", ()))

    fn_state: dict[tuple[str, str], set[str]] = {}
    fn_index: dict[tuple[str, str], dict] = {}
    for path, summary in summaries.items():
        for fname, f in summary.get("functions", {}).items():
            key = (path, fname)
            fn_index[key] = f
            fn_state[key] = set(f.get("roles", ()))

    def resolve_chain(start: set[str], chain: list[str]) -> set[str]:
        cur = {c for c in start if c in classes}
        for attr in chain:
            nxt: set[str] = set()
            for c in cur:
                nxt |= classes[c]["bindings"].get(attr, set())
            cur = {c for c in nxt if c in classes}
            if not cur:
                break
        return cur

    def flow_into(cname: str, method: str, roles: set[str]) -> bool:
        info = classes[cname]
        if method not in info["methods"]:
            return False
        slot = info["roles"].setdefault(method, set())
        if roles <= slot:
            return False
        slot |= roles
        return True

    for _ in range(_MAX_FIXPOINT_ROUNDS):
        changed = False
        for (path, _fname), f in fn_index.items():
            roles = fn_state[(path, _fname)]
            if not roles:
                continue
            for callee in f.get("calls", ()):
                key = (path, callee)
                if key in fn_state and not roles <= fn_state[key]:
                    fn_state[key] |= roles
                    changed = True
            for e in f.get("edges", ()):
                for target in resolve_chain(set(e["classes"]), e["chain"]):
                    changed |= flow_into(target, e["callee"], roles)
        for cname, info in classes.items():
            for e in info["edges"]:
                contrib = set(e.get("roles", ()))
                for m in e.get("m", ()):
                    contrib |= info["roles"].get(m, set())
                if not contrib:
                    continue
                start = ({cname} if e["kind"] == "self"
                         else set(e.get("classes", ())))
                for target in resolve_chain(start, e["chain"]):
                    changed |= flow_into(target, e["callee"], contrib)
        if not changed:
            break

    return {
        cname: {m: sorted(r) for m, r in info["roles"].items() if r}
        for cname, info in classes.items()
        if any(info["roles"].values())
    }


# -- cache ----------------------------------------------------------------

def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def default_cache_path() -> str:
    return os.path.join(repo_root(), CACHE_BASENAME)


def load_summaries(files, use_cache: bool = True,
                   cache_path: str | None = None) -> dict[str, dict]:
    """Per-file summaries keyed by abspath, through the content-hash
    cache.  Cache misses re-extract; unknown/unparseable files summarize
    empty.  Writes are best-effort (a read-only checkout still lints)."""
    cache_path = cache_path or default_cache_path()
    cached: dict[str, dict] = {}
    if use_cache:
        try:
            with open(cache_path, encoding="utf-8") as f:
                data = json.load(f)
            if isinstance(data, dict) and \
                    data.get("version") == SUMMARY_VERSION:
                cached = data.get("files", {})
        except (OSError, ValueError):
            cached = {}
    summaries: dict[str, dict] = {}
    entries = dict(cached)  # keep entries for files outside this run
    dirty = False
    for path in files:
        key = os.path.abspath(path)
        try:
            with open(key, "rb") as f:
                raw = f.read()
        except OSError:
            continue
        digest = hashlib.sha256(raw).hexdigest()
        hit = cached.get(key)
        if isinstance(hit, dict) and hit.get("sha") == digest:
            summaries[key] = hit.get("summary", {})
            continue
        try:
            summary = extract_module(raw.decode("utf-8"))
        except (SyntaxError, UnicodeDecodeError, ValueError):
            summary = {"classes": {}, "functions": {}}
        summaries[key] = summary
        entries[key] = {"sha": digest, "summary": summary}
        dirty = True
    if use_cache and dirty:
        try:
            tmp = f"{cache_path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"version": SUMMARY_VERSION, "files": entries},
                          f, separators=(",", ":"))
            os.replace(tmp, cache_path)
        except OSError:
            pass
    return summaries


def program_roles(files, use_cache: bool = True,
                  cache_path: str | None = None):
    """The whole-program pass: ``(roles, summaries)`` where roles is
    ``{class: {method: [roles]}}`` and summaries is per-abspath."""
    summaries = load_summaries(files, use_cache=use_cache,
                               cache_path=cache_path)
    return compute_program_roles(summaries), summaries


def roles_for_file(summaries: dict[str, dict],
                   roles: dict[str, dict[str, list[str]]],
                   path: str) -> dict[str, dict[str, list[str]]] | None:
    """The external-role slice relevant to one file: only classes the
    file defines (what ``ctx.external_roles`` seeds)."""
    summary = summaries.get(os.path.abspath(path))
    if not summary:
        return None
    out = {cname: roles[cname]
           for cname in summary.get("classes", {}) if cname in roles}
    return out or None
