"""tpulint CLI: ``python -m opensearch_tpu_torch.lint [paths] [--format text|json]``.

Exit codes: 0 clean (all violations covered by the baseline), 1 when new
violations regress past the baseline (or any file fails to parse, or
``--fix --dry-run`` finds pending rewrites), 2 on usage errors. No imports
of checked modules — the full tree lints in well under 10s; ``--jobs``
parses files in a process pool and ``--changed`` restricts the run to
files differing from ``git HEAD`` so the pre-commit loop stays instant.

``--fix`` applies the mechanical rewrites from lint/fixes.py in place
(``--fix --dry-run`` only reports them); the lint pass then runs on the
rewritten tree.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from opensearch_tpu_torch.lint import baseline as baseline_mod
from opensearch_tpu_torch.lint.core import iter_py_files, lint_paths
from opensearch_tpu_torch.lint.rules import ALL_CHECKERS, RULES

# repo root when running from a checkout
# (cli.py -> lint -> opensearch_tpu_torch -> root)
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _default_baseline() -> str | None:
    """The port's baseline (opensearch_tpu_torch/lint_baseline.json),
    whatever the working directory: the checkout root's lint_baseline.json
    is the reference linter's."""
    if os.path.isfile(baseline_mod.DEFAULT_BASELINE_PATH):
        return baseline_mod.DEFAULT_BASELINE_PATH
    return None


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m opensearch_tpu_torch.lint",
        description="AST+dataflow invariant checker (rules TPU001-TPU019)",
    )
    parser.add_argument(
        "paths", nargs="*", default=None,
        help="files or directories to lint (default: the opensearch_tpu_torch package)")
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="output format (default: text)")
    parser.add_argument(
        "--baseline", default=None, metavar="FILE",
        help="baseline file (default: the package's lint_baseline.json, "
             "opensearch_tpu_torch/lint_baseline.json)")
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="ignore any baseline: every violation fails")
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="write the current violations as the new baseline and exit 0")
    parser.add_argument(
        "--rules", default=None, metavar="IDS",
        help="comma-separated rule ids to run (default: all)")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit")
    parser.add_argument(
        "--explain", default=None, metavar="TPUXXX",
        help="print one rule's documentation with a minimal bad/good "
             "example and exit")
    parser.add_argument(
        "--fix", action="store_true",
        help="apply mechanical rewrites (wallclock -> timeutil, entropy "
             "-> randutil, `except: pass` -> logged) before linting")
    parser.add_argument(
        "--dry-run", action="store_true",
        help="with --fix: report pending rewrites without writing; exits "
             "1 if any are pending")
    parser.add_argument(
        "--changed", action="store_true",
        help="lint only files differing from git HEAD (plus untracked)")
    parser.add_argument(
        "--jobs", type=int, default=None, metavar="N",
        help="parse/check files in N worker processes "
             "(default: auto for repo-wide runs, serial for small ones)")
    parser.add_argument(
        "--no-cache", action="store_true",
        help="bypass the whole-program role-summary cache "
             "(.tpulint_torch_cache.json): re-extract every module "
             "summary")
    return parser


def _changed_files() -> list[str] | None:
    """Python files differing from HEAD (modified or untracked). None on
    git failure (not a repo, no git)."""
    try:
        top = subprocess.run(
            ["git", "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, timeout=30)
        if top.returncode != 0:
            return None
        root = top.stdout.strip()
        names: list[str] = []
        for cmd in (["git", "diff", "--name-only", "HEAD"],
                    ["git", "ls-files", "--others", "--exclude-standard"]):
            # run from the toplevel: `diff --name-only` is always
            # root-relative but `ls-files --others` is CWD-relative, and
            # the two must agree before joining onto `root`
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=30, cwd=root)
            if proc.returncode != 0:
                return None
            names.extend(proc.stdout.splitlines())
    except (OSError, subprocess.SubprocessError):
        return None
    out: list[str] = []
    seen: set[str] = set()
    for name in names:
        if not name.endswith(".py") or name in seen:
            continue
        seen.add(name)
        full = os.path.join(root, name)
        if os.path.isfile(full):
            out.append(full)
    return out


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for rule_id, checker in sorted(RULES.items()):
            print(f"{rule_id} {checker.name}: {checker.description}")
        return 0

    if args.explain:
        from opensearch_tpu_torch.lint.explain import explain

        text = explain(args.explain.strip().upper())
        if text is None:
            print(f"unknown rule: {args.explain}", file=sys.stderr)
            return 2
        print(text, end="")
        return 0

    checkers = ALL_CHECKERS
    if args.rules:
        if args.write_baseline:
            # a partial-rule run must never become the whole baseline —
            # it would erase every other rule's tolerated entries
            print("--write-baseline cannot be combined with --rules",
                  file=sys.stderr)
            return 2
        wanted = {r.strip().upper() for r in args.rules.split(",") if r.strip()}
        unknown = wanted - set(RULES)
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        checkers = [RULES[r] for r in sorted(wanted)]

    if args.dry_run and not args.fix:
        print("--dry-run only makes sense with --fix", file=sys.stderr)
        return 2

    paths = args.paths or [os.path.join(_PKG_ROOT, "opensearch_tpu_torch")]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        # a typo'd path must not pass green having linted nothing
        print("no such file or directory: " + ", ".join(missing),
              file=sys.stderr)
        return 2
    if args.changed:
        changed = _changed_files()
        if changed is None:
            print("--changed requires a git checkout", file=sys.stderr)
            return 2
        # restrict to the requested paths (default: the package)
        roots = [os.path.abspath(p) for p in paths]
        paths = [
            f for f in changed
            if any(os.path.abspath(f) == r
                   or os.path.abspath(f).startswith(r + os.sep)
                   for r in roots)
        ]
        if not paths:
            print("no changed python files under "
                  + ", ".join(os.path.relpath(r) for r in roots))
            return 0

    fixes_report: list | None = None
    if args.fix:
        from opensearch_tpu_torch.lint import fixes as fixes_mod

        files = list(iter_py_files(paths))
        fixes_report, _changed_count = fixes_mod.fix_paths(
            files, write=not args.dry_run)

    t0 = time.monotonic()
    jobs = args.jobs
    if jobs is None:
        # auto: a repo-wide run amortizes pool startup; tiny runs don't
        jobs = min(8, os.cpu_count() or 1)
    violations, files_checked = lint_paths(paths, checkers, jobs=jobs,
                                           use_cache=not args.no_cache)
    elapsed = time.monotonic() - t0

    baseline_path = None if args.no_baseline else (
        args.baseline or _default_baseline())

    if args.write_baseline:
        target = args.baseline or baseline_mod.DEFAULT_BASELINE_PATH
        baseline_mod.write_baseline(target, violations)
        print(f"wrote baseline with {len(violations)} violation(s) "
              f"across {files_checked} file(s) to {target}")
        return 0

    baseline = None
    if baseline_path is not None:
        try:
            baseline = baseline_mod.load_baseline(baseline_path)
        except (OSError, ValueError) as e:
            print(f"cannot load baseline {baseline_path}: {e}", file=sys.stderr)
            return 2

    regressions = baseline_mod.compare(violations, baseline)
    stale = baseline_mod.stale_entries(violations, baseline)
    # which concrete violations are NEW (not absorbed by the baseline)?
    # report the trailing N per regressed (path, rule) cell — deterministic
    # because violations are sorted by (path, line, col).
    regressed_cells = {(r.path, r.rule): r.count - r.allowed for r in regressions}
    new_violations = []
    seen_per_cell: dict[tuple[str, str], int] = {}
    totals = baseline_mod.violation_counts(violations)
    for v in violations:
        cell = (v.path, v.rule)
        if cell not in regressed_cells:
            continue
        seen = seen_per_cell.get(cell, 0) + 1
        seen_per_cell[cell] = seen
        if seen > totals[v.path][v.rule] - regressed_cells[cell]:
            new_violations.append(v)

    if args.format == "json":
        report = {
            "version": 2,
            "files_checked": files_checked,
            "elapsed_seconds": round(elapsed, 3),
            "baseline": baseline_path,
            # the active rule catalog, so gate scripts assert "rule X ran"
            # from the same report they read findings from (no text grep)
            "rules": [{"id": c.rule_id, "name": c.name,
                       "description": c.description}
                      for c in sorted(checkers, key=lambda c: c.rule_id)],
            "total_violations": len(violations),
            "violations": [v.to_dict() for v in violations],
            "regressions": [r.to_dict() for r in regressions],
            "new_violations": [v.to_dict() for v in new_violations],
            "stale_baseline_entries": [s.to_dict() for s in stale],
        }
        if fixes_report is not None:
            key = "pending_fixes" if args.dry_run else "applied_fixes"
            report[key] = [f.to_dict() for f in fixes_report]
        print(json.dumps(report, indent=2))
    else:
        if fixes_report is not None:
            verb = "would fix" if args.dry_run else "fixed"
            for f in fixes_report:
                print(f"{verb}: {f.render()}")
        if baseline is None:
            for v in violations:
                print(v.render())
        else:
            for v in new_violations:
                print(v.render())
        if regressions and baseline is not None:
            print(f"\n{len(regressions)} regression(s) past the baseline:")
            for r in regressions:
                print(f"  {r.render()}")
        if stale:
            print(f"\n{len(stale)} stale baseline entr"
                  f"{'y' if len(stale) == 1 else 'ies'} (ratchet down with "
                  "--write-baseline):")
            for s in stale:
                print(f"  {s.render()}")
        print(f"\nchecked {files_checked} file(s) in {elapsed:.2f}s: "
              f"{len(violations)} violation(s), "
              f"{len(regressions)} regression(s)"
              + (f" [baseline: {baseline_path}]" if baseline_path else ""))

    if args.fix and args.dry_run and fixes_report:
        return 1  # pending mechanical rewrites fail the gate
    if baseline is None:
        return 1 if violations else 0
    return 1 if regressions else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
