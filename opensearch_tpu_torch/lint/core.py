"""tpulint core: file context, suppression parsing, checker protocol, runner.

Design constraints: single AST pass per file per checker, no
imports of the checked modules (pure ``ast`` — linting must stay fast and
side-effect free), line-level suppression comments, and stable relative
paths so the baseline file survives being run from the repo root.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Iterable, Iterator

# rule id used for files that fail to parse (always fatal, never baselined)
PARSE_ERROR_RULE = "TPU000"

_SUPPRESS_RE = re.compile(
    r"#\s*tpulint:\s*disable(?:\s*=\s*(?P<rules>[A-Z0-9,\s]+))?"
)


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    col: int
    message: str
    # structured evidence (domains, roles, lock sets) for --format json
    # consumers; omitted from to_dict when absent so the text-era shape
    # is unchanged
    meta: tuple | None = None

    def sort_key(self) -> tuple:
        return (self.path, self.line, self.col, self.rule)

    def to_dict(self) -> dict:
        out = {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }
        if self.meta is not None:
            out["meta"] = dict(self.meta)
        return out

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


def parse_suppressions(source: str) -> dict[int, set[str] | None]:
    """line number -> suppressed rule ids (None = all rules on that line)."""
    out: dict[int, set[str] | None] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = m.group("rules")
        if rules is None:
            out[i] = None
        else:
            ids = {r.strip() for r in rules.split(",") if r.strip()}
            prev = out.get(i)
            out[i] = None if prev is None else (prev or set()) | ids
    return out


def dotted_name(node: ast.AST) -> str | None:
    """'a.b.c' for Name/Attribute chains, else None (calls/subscripts break
    the chain — ``jax.jit(f)(x)`` has no dotted name, by design)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> str | None:
    return dotted_name(node.func)


def import_aliases(tree: ast.AST) -> dict[str, str]:
    """first-segment alias -> canonical dotted prefix, from the file's
    imports: ``import time as _time`` maps _time -> time, ``from datetime
    import datetime`` maps datetime -> datetime.datetime."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                if a.name != "*":
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


class FileContext:
    """Everything a checker needs about one file: tree, source lines,
    suppression map, and a display path stable across runs."""

    def __init__(self, path: str, source: str, display_path: str | None = None):
        self.path = path
        self.display_path = display_path or normalize_path(path)
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.suppressed = parse_suppressions(source)
        self._aliases: dict[str, str] | None = None

    def canonical(self, name: str | None) -> str | None:
        """Resolve the first segment of a dotted call name through the
        file's import aliases (``_time.monotonic`` -> ``time.monotonic``)."""
        if name is None:
            return None
        if self._aliases is None:
            self._aliases = import_aliases(self.tree)
        head, sep, rest = name.partition(".")
        resolved = self._aliases.get(head)
        if resolved is None:
            return name
        return f"{resolved}{sep}{rest}" if sep else resolved

    def is_suppressed(self, rule: str, line: int) -> bool:
        ids = self.suppressed.get(line, ())
        return ids is None or rule in ids

    def violation(self, rule: str, node: ast.AST, message: str,
                  meta: dict | None = None) -> Violation:
        return Violation(
            rule=rule,
            path=self.display_path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0) + 1,
            message=message,
            meta=(tuple(sorted(meta.items()))
                  if meta is not None else None),
        )


class Checker:
    """Base class for a rule. Subclasses set rule_id/name/description and
    implement check(ctx) -> iterable of Violation."""

    rule_id: str = "TPU999"
    name: str = "unnamed"
    description: str = ""

    def applies_to(self, display_path: str, source: str) -> bool:
        return True

    def check(self, ctx: FileContext) -> Iterable[Violation]:  # pragma: no cover
        raise NotImplementedError


# checkout root (core.py -> lint -> opensearch_tpu_torch -> root): files
# under it
# get repo-relative keys so lint_baseline.json works from any cwd
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def normalize_path(path: str) -> str:
    """Posix-style baseline key: relative to the repo root when the file
    lives under it, else to cwd, else absolute."""
    p = os.path.abspath(path)
    for anchor in (_REPO_ROOT, os.getcwd()):
        try:
            rel = os.path.relpath(p, anchor)
        except ValueError:  # different drive (windows)
            continue
        if not rel.startswith(".."):
            return rel.replace(os.sep, "/")
    return p.replace(os.sep, "/")


def iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    seen: set[str] = set()
    for path in paths:
        if os.path.isdir(path):
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git", ".venv", "node_modules")
                )
                for f in sorted(files):
                    if f.endswith(".py"):
                        full = os.path.join(root, f)
                        if full not in seen:
                            seen.add(full)
                            yield full
        elif path.endswith(".py") or os.path.isfile(path):
            if path not in seen:
                seen.add(path)
                yield path


# rules that consume whole-program role summaries (lint/callgraph.py)
ROLE_RULES = ("TPU018", "TPU019")


def _file_local_roles(source: str, tree: ast.AST) -> dict:
    """Cross-CLASS role propagation within ONE file — the fallback when
    no whole-program pass ran (single-snippet lint, fixtures), so the
    cross-module shapes stay testable as self-contained files."""
    from opensearch_tpu_torch.lint import callgraph

    try:
        summary = callgraph.extract_module(source, tree=tree)
    except (ValueError, RecursionError):  # pragma: no cover - defensive
        return {}
    return callgraph.compute_program_roles({"<file>": summary})


def lint_source(
    path: str,
    source: str,
    checkers: Iterable[Checker],
    display_path: str | None = None,
    external_roles: dict | None = None,
) -> list[Violation]:
    display = display_path or normalize_path(path)
    try:
        ctx = FileContext(path, source, display_path=display)
    except SyntaxError as e:
        return [Violation(
            rule=PARSE_ERROR_RULE, path=display,
            line=e.lineno or 1, col=(e.offset or 0) + 1,
            message=f"syntax error: {e.msg}",
        )]
    checkers = list(checkers)
    if external_roles is None and \
            any(c.rule_id in ROLE_RULES for c in checkers):
        external_roles = _file_local_roles(source, ctx.tree)
    ctx.external_roles = external_roles or {}
    out: list[Violation] = []
    for checker in checkers:
        if not checker.applies_to(display, source):
            continue
        for v in checker.check(ctx):
            if not ctx.is_suppressed(v.rule, v.line):
                out.append(v)
    out.sort(key=Violation.sort_key)
    return out


def _lint_file(f: str, checkers: Iterable[Checker],
               external_roles: dict | None = None) -> list[Violation]:
    try:
        with open(f, encoding="utf-8") as fh:
            source = fh.read()
    except OSError as e:
        return [Violation(
            rule=PARSE_ERROR_RULE, path=normalize_path(f),
            line=1, col=1, message=f"cannot read file: {e}",
        )]
    return lint_source(f, source, checkers, external_roles=external_roles)


def _lint_file_by_rules(args: tuple) -> list[Violation]:
    """Process-pool worker: files are dispatched with RULE IDS (picklable)
    and each worker resolves them against its own module-level registry.
    The per-file external-role slice rides along so the whole-program
    fixpoint runs ONCE in the parent, never per worker."""
    f, rule_ids, external_roles = args
    from opensearch_tpu_torch.lint.rules import RULES

    return _lint_file(f, [RULES[r] for r in rule_ids],
                      external_roles=external_roles)


def _program_pass(files: list[str], use_cache: bool):
    """Whole-program role summaries for a lint run.  When every linted
    file lives inside the package, the analysis scope widens to the WHOLE
    package so single-file lint still sees cross-module callers (cache
    hits make that cheap); otherwise the scope is the linted set."""
    from opensearch_tpu_torch.lint import callgraph

    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    abs_files = [os.path.abspath(f) for f in files]
    if abs_files and all(f.startswith(pkg_dir + os.sep) for f in abs_files):
        scope = list(iter_py_files([pkg_dir]))
    else:
        scope = abs_files
    roles, summaries = callgraph.program_roles(scope, use_cache=use_cache)

    def for_file(f: str) -> dict:
        return callgraph.roles_for_file(summaries, roles, f) or {}

    return for_file


def lint_paths(
    paths: Iterable[str],
    checkers: Iterable[Checker] | None = None,
    jobs: int | None = None,
    use_cache: bool = True,
) -> tuple[list[Violation], int]:
    """Lint every .py file under `paths`. Returns (violations, files_checked).

    ``jobs > 1`` parses/checks files in a process pool (per-file work is
    independent by construction — every checker gets a fresh FileContext).
    Parallel dispatch requires registry checkers (rule ids are what
    crosses the process boundary); custom checker instances fall back to
    serial, as does any pool failure.

    When the checker set includes the thread-role rules, a whole-program
    pre-pass (lint/callgraph.py) runs first and each file is linted with
    its classes' externally derived roles; ``use_cache=False`` bypasses
    the on-disk summary cache.
    """
    if checkers is None:
        from opensearch_tpu_torch.lint.rules import ALL_CHECKERS

        checkers = ALL_CHECKERS
    checkers = list(checkers)
    files = list(iter_py_files(paths))
    violations: list[Violation] = []

    roles_for = None
    if any(c.rule_id in ROLE_RULES for c in checkers):
        roles_for = _program_pass(files, use_cache)

    def external(f: str) -> dict:
        return roles_for(f) if roles_for is not None else {}

    if jobs is not None and jobs > 1 and len(files) >= 2 * jobs:
        from opensearch_tpu_torch.lint.rules import RULES

        rule_ids = tuple(sorted(
            c.rule_id for c in checkers
            if RULES.get(c.rule_id) is c
        ))
        if len(rule_ids) == len(checkers):
            try:
                import concurrent.futures as _cf
                import multiprocessing as _mp

                # spawned, not forked: the caller may have threads (a test
                # runner's, a server's), and a fork copies their locks
                with _cf.ProcessPoolExecutor(
                        max_workers=jobs,
                        mp_context=_mp.get_context("spawn")) as pool:
                    for batch in pool.map(
                        _lint_file_by_rules,
                        [(f, rule_ids, external(f)) for f in files],
                        chunksize=max(1, len(files) // (jobs * 4)),
                    ):
                        violations.extend(batch)
                violations.sort(key=Violation.sort_key)
                return violations, len(files)
            except (OSError, RuntimeError,
                    ImportError):  # pragma: no cover - env-specific
                violations = []  # pool unavailable: fall through to serial

    for f in files:
        violations.extend(_lint_file(f, checkers, external_roles=external(f)))
    violations.sort(key=Violation.sort_key)
    return violations, len(files)
