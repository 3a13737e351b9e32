"""The port's linter (opensearch_tpu_torch/lint) against the reference's,
and the port's own gate.

- The registry holds the reference's 19 rule ids, each with its name.
- On every fixture of tests/lint_fixtures/, the 15 rules whose logic the
  port keeps as the reference wrote it (all but TPU001, TPU007, TPU014
  and TPU016) give the reference's violations exactly: rule, path, line,
  column and message, the message with the port's package named where
  the reference names its own (TPU004 points at
  ``opensearch_tpu_torch.common.timeutil``).
- The four rules rewritten for PyTorch and CUDA flag nothing on the
  reference's JAX fixtures; their torch twins in tests/lint_fixtures_torch/
  are flagged at exactly their ``# EXPECT:`` lines (``*_bad.py``) or not
  at all (``*_good.py``), and the reference's "every rule has fixture
  coverage" check holds for the port's registry over both directories.
- The gate: ``opensearch_tpu_torch/`` is clean against the port's
  baseline, which is empty, with no pending ``--fix`` rewrite; and
  ``python -m opensearch_tpu_torch.lint opensearch_tpu_torch`` exits 0
  in a process where ``jax`` and ``opensearch_tpu`` cannot be imported.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "lint_fixtures"
TORCH_FIXTURES = REPO / "tests" / "lint_fixtures_torch"
PORT_BASELINE = REPO / "opensearch_tpu_torch" / "lint_baseline.json"
TWINS = ("TPU001", "TPU007", "TPU014", "TPU016")
_EXPECT_RE = re.compile(r"#\s*EXPECT:\s*(TPU\d{3})")


def lint(package: str, name: str):
    return importlib.import_module(f"{package}.lint.{name}")


def expected(fixture: Path) -> list[tuple[int, str]]:
    return sorted((lineno, m.group(1)) for lineno, text in enumerate(
        fixture.read_text().splitlines(), start=1)
        for m in _EXPECT_RE.finditer(text))


def port_actual(fixture: Path) -> list[tuple[int, str]]:
    core, rules = lint("opensearch_tpu_torch", "core"), \
        lint("opensearch_tpu_torch", "rules")
    return sorted((v.line, v.rule) for v in core.lint_source(
        str(fixture), fixture.read_text(), rules.ALL_CHECKERS))


def test_the_registry_holds_the_references_rules():
    ref, port = lint("opensearch_tpu", "rules"), \
        lint("opensearch_tpu_torch", "rules")
    assert list(port.RULES) == list(ref.RULES)
    assert len(port.RULES) == 19
    assert {r: c.name for r, c in port.RULES.items()} == \
        {r: c.name for r, c in ref.RULES.items()}
    import opensearch_tpu_torch.lint as port_lint

    assert port_lint.RULES is port.RULES
    assert port_lint.ALL_CHECKERS is port.ALL_CHECKERS


def shared_checkers(package: str) -> list:
    rules = lint(package, "rules")
    checkers = [c for c in rules.ALL_CHECKERS if c.rule_id not in TWINS]
    assert len(checkers) == 15
    return checkers


def row(v) -> dict:
    """A violation as the reference would word it: the port's messages
    name the port's package where the reference's name its own."""
    d = v.to_dict()
    d["message"] = d["message"].replace("opensearch_tpu_torch.",
                                        "opensearch_tpu.")
    return d


@pytest.fixture(scope="module")
def shared_findings():
    """Each package's violations of the 15 shared rules over the whole
    reference fixture directory (the whole-program role pass included,
    with no cache), by fixture."""
    out = {}
    for package in ("opensearch_tpu", "opensearch_tpu_torch"):
        vs, n = lint(package, "core").lint_paths(
            [str(FIXTURES)], shared_checkers(package), use_cache=False)
        by_file: dict = {}
        for v in vs:
            by_file.setdefault(Path(v.path).name, []).append(row(v))
        out[package] = (by_file, n)
    return out


def _shared_by_file(package: str, fixture: Path) -> list:
    """The 15 shared rules on one file alone (``lint_source``)."""
    return [row(v) for v in lint(package, "core").lint_source(
        str(fixture), fixture.read_text(), shared_checkers(package))]


@pytest.mark.parametrize("fixture", sorted(FIXTURES.glob("*.py")),
                         ids=lambda p: p.name)
def test_shared_rules_agree_on_reference_fixture(fixture, shared_findings):
    # over the whole directory, cross-module roles included
    ref, port = (shared_findings[p][0].get(fixture.name, [])
                 for p in ("opensearch_tpu", "opensearch_tpu_torch"))
    assert port == ref
    # the file alone, where the fixture's EXPECT lines are the findings
    ref, port = (_shared_by_file(p, fixture)
                 for p in ("opensearch_tpu", "opensearch_tpu_torch"))
    assert port == ref
    wanted = [(line, rule) for line, rule in expected(fixture)
              if rule not in TWINS]
    assert sorted((v["line"], v["rule"]) for v in ref) == wanted


def test_shared_rules_saw_every_reference_fixture(shared_findings):
    n_ref, n_port = (shared_findings[p][1]
                     for p in ("opensearch_tpu", "opensearch_tpu_torch"))
    assert n_ref == n_port == len(list(FIXTURES.glob("*.py"))) >= 40


@pytest.mark.parametrize("fixture", sorted(FIXTURES.glob("*.py")),
                         ids=lambda p: p.name)
def test_twin_rules_flag_nothing_on_jax_fixture(fixture):
    core, rules = lint("opensearch_tpu_torch", "core"), \
        lint("opensearch_tpu_torch", "rules")
    twins = [rules.RULES[r] for r in TWINS]
    assert core.lint_source(str(fixture), fixture.read_text(), twins) == []


TORCH_BAD = sorted(TORCH_FIXTURES.glob("tpu*_bad.py"))
TORCH_GOOD = sorted(TORCH_FIXTURES.glob("tpu*_good.py"))


@pytest.mark.parametrize("fixture", TORCH_BAD, ids=lambda p: p.name)
def test_twin_bad_fixture_flags_exact_lines(fixture):
    want = expected(fixture)
    assert want, f"{fixture.name} has no EXPECT annotations"
    assert {r for _l, r in want} <= set(TWINS)
    assert port_actual(fixture) == want


@pytest.mark.parametrize("fixture", TORCH_GOOD, ids=lambda p: p.name)
def test_twin_good_fixture_is_clean(fixture):
    assert port_actual(fixture) == []


def test_every_rule_has_fixture_coverage_over_both_directories():
    """The reference's coverage check, for the port's registry: every rule
    has a true-positive and a false-positive-guard fixture in
    tests/lint_fixtures/ or tests/lint_fixtures_torch/; the twins have
    both in the torch directory."""
    rules = lint("opensearch_tpu_torch", "rules")
    bad = sorted(FIXTURES.glob("tpu*_bad.py")) + TORCH_BAD
    good = sorted(FIXTURES.glob("tpu*_good.py")) + TORCH_GOOD + [
        FIXTURES / "tpu004_unscoped.py"]
    bad_rules = {r for f in bad for _, r in expected(f)}
    good_names = {f.name.split("_")[0].upper() for f in good}
    for rule_id in rules.RULES:
        assert rule_id in bad_rules, f"{rule_id} has no true-positive fixture"
        assert rule_id in good_names, f"{rule_id} has no FP-guard fixture"
    for rule_id in TWINS:
        assert any(rule_id in {r for _, r in expected(f)} for f in TORCH_BAD)
        assert rule_id.lower() in {f.name.split("_")[0] for f in TORCH_GOOD}


def test_explain_examples_name_no_jax():
    explain = lint("opensearch_tpu_torch", "explain")
    for rule_id, ex in {**explain.EXAMPLES,
                        **explain.CROSS_MODULE_EXAMPLES}.items():
        for text in (ex.bad, ex.good):
            assert "jax" not in text and "pallas_call" not in text, rule_id


# -- the port's gate ----------------------------------------------------------


def test_the_ports_baseline_is_empty():
    baseline = lint("opensearch_tpu_torch", "baseline")
    assert Path(baseline.DEFAULT_BASELINE_PATH) == PORT_BASELINE
    assert baseline.load_baseline(str(PORT_BASELINE)) == {}


def test_the_ports_tree_is_clean_against_its_baseline(monkeypatch):
    """Every rule over the port's package, against its empty baseline
    (keys are relative to the checkout root, whatever the cwd)."""
    monkeypatch.chdir(REPO)
    core = lint("opensearch_tpu_torch", "core")
    baseline = lint("opensearch_tpu_torch", "baseline")
    violations, files_checked = core.lint_paths(
        [str(REPO / "opensearch_tpu_torch")])
    assert files_checked > 100
    regressions = baseline.compare(
        violations, baseline.load_baseline(str(PORT_BASELINE)))
    assert regressions == [] and violations == [], "\n".join(
        v.render() for v in violations)


def test_the_ports_tree_has_no_pending_fix():
    core = lint("opensearch_tpu_torch", "core")
    fixes = lint("opensearch_tpu_torch", "fixes")
    files = list(core.iter_py_files([str(REPO / "opensearch_tpu_torch")]))
    pending, changed = fixes.fix_paths(files, write=False)
    assert pending == [] and changed == 0


# a process in which neither the JAX package nor JAX itself can be imported
_REFUSE = textwrap.dedent("""\
    import importlib.abc
    import runpy
    import sys

    REFUSED = ("jax", "jaxlib", "opensearch_tpu")


    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"{name} is refused here")
            return None


    sys.meta_path.insert(0, Refuse())
    sys.argv = ["opensearch_tpu_torch.lint", *sys.argv[1:]]
    try:
        runpy.run_module("opensearch_tpu_torch.lint", run_name="__main__")
    finally:
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in REFUSED)
        print("REFUSED_LOADED=" + ",".join(loaded))
""")


def _run_refusing(*args, cwd=REPO):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run([sys.executable, "-c", _REFUSE, *args],
                          capture_output=True, text=True, cwd=str(cwd),
                          timeout=300, env=env)


def test_the_gate_runs_without_jax_or_the_reference(tmp_path):
    proc = _run_refusing("opensearch_tpu_torch")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 violation(s), 0 regression(s)" in proc.stdout
    assert str(PORT_BASELINE) in proc.stdout
    assert "REFUSED_LOADED=\n" in proc.stdout
    # from another directory, and --fix --dry-run, in JSON
    proc = _run_refusing(str(REPO / "opensearch_tpu_torch"), "--fix",
                         "--dry-run", "--format", "json", cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout.split("REFUSED_LOADED=")[0])
    assert report["pending_fixes"] == [] and report["violations"] == []
    assert report["baseline"] == str(PORT_BASELINE)
    assert len(report["rules"]) == 19
    assert proc.stdout.rstrip().endswith("REFUSED_LOADED=")


def test_the_refusal_is_real():
    """The same process refuses a module of the JAX package."""
    proc = subprocess.run(
        [sys.executable, "-c", _REFUSE.replace(
            'runpy.run_module("opensearch_tpu_torch.lint", '
            'run_name="__main__")', 'import opensearch_tpu.lint')],
        capture_output=True, text=True, cwd=str(REPO), timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode != 0
    assert "opensearch_tpu is refused here" in proc.stderr
