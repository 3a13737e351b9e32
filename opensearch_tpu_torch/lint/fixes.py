"""``tpulint --fix``: mechanical rewrites with stable, idempotent output.

Three fixers, each the automated remedy for a rule the linter enforces:

- TPU004 wallclock  — ``time.time()`` and friends in sim-run modules
  become the injectable clock (``timeutil.epoch_millis() / 1000.0``,
  unit-preserving so surrounding arithmetic stays correct).
- TPU006 entropy    — ``uuid.uuid4()`` / ``os.urandom(n)`` /
  ``secrets.token_*`` in sim-run modules become the injectable RNG
  (``randutil.uuid4()`` etc. — drop-in, type-preserving; the sim installs
  the scheduler's seeded Random via ``randutil.set_rng``).
- TPU005 swallowed  — ``except Exception: pass`` (pass-only bodies)
  becomes a logged variant binding the exception.

Rewrites are planned off the AST (exact ``col_offset``/``end_col_offset``
spans, import aliases resolved) and applied bottom-up so earlier edits
never invalidate later spans. Missing ``timeutil``/``randutil``/
``logging`` imports are inserted after the last top-level import. Running
``--fix`` twice produces no further diff: every rewrite removes the
pattern that triggered it. Lines carrying a ``# tpulint: disable``
suppression are left untouched.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from opensearch_tpu_torch.lint.core import FileContext, call_name, normalize_path
from opensearch_tpu_torch.lint.rules import _sim_scoped

# rule -> { canonical no-arg call -> replacement expression }
_WALLCLOCK_REWRITES = {
    # parenthesized: the rewrite must compose under any surrounding
    # operator (`time.time() ** 2` etc.) without changing precedence
    "time.time": "(timeutil.epoch_millis() / 1000.0)",
    "time.monotonic": "(timeutil.monotonic_millis() / 1000.0)",
    "time.perf_counter": "(timeutil.monotonic_millis() / 1000.0)",
    "time.time_ns": "(timeutil.epoch_millis() * 1_000_000)",
    "time.monotonic_ns": "(timeutil.monotonic_millis() * 1_000_000)",
    "time.perf_counter_ns": "(timeutil.monotonic_millis() * 1_000_000)",
}
_TIMEUTIL_IMPORT = "from opensearch_tpu_torch.common import timeutil"

# canonical callee -> replacement callee (arguments preserved verbatim)
_ENTROPY_REWRITES = {
    "uuid.uuid4": "randutil.uuid4",
    "os.urandom": "randutil.urandom",
    "secrets.token_bytes": "randutil.urandom",
    "secrets.token_hex": "randutil.token_hex",
}
_RANDUTIL_IMPORT = "from opensearch_tpu_torch.common import randutil"
_LOGGING_IMPORT = "import logging"


@dataclass(frozen=True)
class Fix:
    rule: str
    path: str
    line: int
    col: int
    description: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.description}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "description": self.description}


@dataclass(frozen=True)
class _Edit:
    # 1-indexed lines, 0-indexed columns (the ast convention)
    line: int
    col: int
    end_line: int
    end_col: int
    replacement: str
    fix: Fix


def _span(node: ast.AST) -> tuple[int, int, int, int]:
    return (node.lineno, node.col_offset, node.end_lineno, node.end_col_offset)


def _module_has_logger(tree: ast.Module) -> bool:
    for node in tree.body:
        if isinstance(node, ast.Assign):
            if any(isinstance(t, ast.Name) and t.id == "logger"
                   for t in node.targets):
                return True
    return False


def _module_imports(tree: ast.Module) -> set[str]:
    """Import lines already present at module top level, normalized to
    the NAME they bind: an aliased import (``... import timeutil as _tu``)
    does not bind ``timeutil`` and must not satisfy the dedup check — the
    rewrites reference the unaliased name."""
    out: set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname is None:
                    out.add(f"import {a.name}")
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            for a in node.names:
                if a.asname is None:
                    out.add(f"from {node.module} import {a.name}")
    return out


def _import_insert_line(tree: ast.Module) -> int:
    """1-indexed line AFTER which to insert new imports."""
    last = 0
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            last = max(last, node.end_lineno or node.lineno)
        elif last:
            break
    if last:
        return last
    # no imports: after the module docstring, if any
    if tree.body and isinstance(tree.body[0], ast.Expr) and \
            isinstance(tree.body[0].value, ast.Constant) and \
            isinstance(tree.body[0].value.value, str):
        return tree.body[0].end_lineno or tree.body[0].lineno
    return 0


def plan_fixes(ctx: FileContext) -> tuple[list[_Edit], set[str]]:
    """All mechanical rewrites for one file + the imports they need."""
    edits: list[_Edit] = []
    imports: set[str] = set()
    sim = _sim_scoped(ctx.display_path, ctx.source)
    has_logger = _module_has_logger(ctx.tree)

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            name = ctx.canonical(call_name(node))
            if name is None:
                continue
            if sim and name in _WALLCLOCK_REWRITES and not node.args \
                    and not node.keywords:
                if ctx.is_suppressed("TPU004", node.lineno):
                    continue
                line, col, el, ec = _span(node)
                replacement = _WALLCLOCK_REWRITES[name]
                edits.append(_Edit(line, col, el, ec, replacement, Fix(
                    "TPU004", ctx.display_path, line, col + 1,
                    f"{name}() -> {replacement}")))
                imports.add(_TIMEUTIL_IMPORT)
            elif sim and name in _ENTROPY_REWRITES:
                if ctx.is_suppressed("TPU006", node.lineno):
                    continue
                # replace only the callee expression; arguments stay
                line, col, el, ec = _span(node.func)
                replacement = _ENTROPY_REWRITES[name]
                edits.append(_Edit(line, col, el, ec, replacement, Fix(
                    "TPU006", ctx.display_path, line, col + 1,
                    f"{name}(...) -> {replacement}(...)")))
                imports.add(_RANDUTIL_IMPORT)
        elif isinstance(node, ast.ExceptHandler):
            edit = _plan_swallowed_pass(ctx, node, has_logger)
            if edit is not None:
                edits.append(edit)
                if not has_logger:
                    imports.add(_LOGGING_IMPORT)

    # never apply imports the module already has
    imports -= _module_imports(ctx.tree)
    return edits, imports


def _plan_swallowed_pass(ctx: FileContext, node: ast.ExceptHandler,
                         has_logger: bool) -> _Edit | None:
    type_name = None
    if node.type is not None:
        try:
            type_name = ast.unparse(node.type)
        except (AttributeError, ValueError):  # pragma: no cover
            return None
    broad = node.type is None or (
        type_name is not None
        and type_name.split(".")[-1] in ("Exception", "BaseException"))
    if not broad:
        return None
    if len(node.body) != 1 or not isinstance(node.body[0], ast.Pass):
        return None
    if ctx.is_suppressed("TPU005", node.lineno):
        return None
    pass_stmt = node.body[0]
    bound = node.name or "e"
    # a bare `except:` catches BaseException — preserve that breadth
    # (narrowing to Exception would let SystemExit/KeyboardInterrupt
    # start propagating, a semantic change a mechanical fixer must not
    # make); only the logging is added
    except_txt = f"except {type_name or 'BaseException'} as {bound}:"
    log_target = "logger" if has_logger else "logging.getLogger(__name__)"
    same_line = pass_stmt.lineno == node.lineno
    body_indent = " " * (node.col_offset + 4 if same_line
                         else pass_stmt.col_offset)
    replacement = (
        f"{except_txt}\n"
        f"{body_indent}{log_target}.debug(\"swallowed exception: %s\", "
        f"{bound})"
    )
    line, col = node.lineno, node.col_offset
    el, ec = pass_stmt.end_lineno, pass_stmt.end_col_offset
    return _Edit(line, col, el, ec, replacement, Fix(
        "TPU005", ctx.display_path, line, col + 1,
        f"`except {type_name or ''}: pass` -> logged variant".replace(
            "`except : pass`", "`except: pass`")))


def _apply_edits(source: str, edits: list[_Edit],
                 imports: set[str], tree: ast.Module) -> str:
    lines = source.splitlines(keepends=True)

    def splice(line: int, col: int, end_line: int, end_col: int,
               text: str) -> None:
        # merge the affected region into one string, replace, re-split
        start_idx, end_idx = line - 1, end_line - 1
        region = "".join(lines[start_idx:end_idx + 1])
        # column offsets are within their own lines
        prefix_len = col
        suffix_start = sum(len(lines[i]) for i in
                           range(start_idx, end_idx)) + end_col
        new_region = region[:prefix_len] + text + region[suffix_start:]
        lines[start_idx:end_idx + 1] = new_region.splitlines(keepends=True)

    for edit in sorted(edits, key=lambda e: (e.line, e.col), reverse=True):
        splice(edit.line, edit.col, edit.end_line, edit.end_col,
               edit.replacement)

    if imports:
        insert_after = _import_insert_line(tree)
        block = "".join(f"{imp}\n" for imp in sorted(imports))
        lines.insert(insert_after, block)
    return "".join(lines)


def fix_source(path: str, source: str,
               display_path: str | None = None) -> tuple[str, list[Fix]]:
    """Plan and apply every mechanical rewrite for one file's source.
    Returns (new_source, fixes). On a parse error, returns the source
    unchanged (the linter reports TPU000 separately)."""
    display = display_path or normalize_path(path)
    try:
        ctx = FileContext(path, source, display_path=display)
    except SyntaxError:
        return source, []
    edits, imports = plan_fixes(ctx)
    if not edits:
        return source, []
    new_source = _apply_edits(source, edits, imports, ctx.tree)
    return new_source, [e.fix for e in edits]


def fix_paths(files: list[str], *, write: bool) -> tuple[list[Fix], int]:
    """Run the fixer over files. write=False is --dry-run: report what
    WOULD change. Returns (fixes, files_changed)."""
    all_fixes: list[Fix] = []
    changed = 0
    for f in files:
        try:
            with open(f, encoding="utf-8") as fh:
                source = fh.read()
        except OSError:
            continue
        new_source, fixes = fix_source(f, source)
        if not fixes:
            continue
        all_fixes.extend(fixes)
        changed += 1
        if write and new_source != source:
            with open(f, "w", encoding="utf-8") as fh:
                fh.write(new_source)
    all_fixes.sort(key=lambda fx: (fx.path, fx.line, fx.col, fx.rule))
    return all_fixes, changed
