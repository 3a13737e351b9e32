"""The reference linter's own tests (tests/test_lint.py) on the port's
linter.

Each case of tests/test_lint.py runs twice: as the reference wrote it, and
as the port's copy (:func:`port_copy`: the same source with every
``opensearch_tpu`` import rewritten to ``opensearch_tpu_torch``, as
tests/test_torch_cluster_data.py's ``_ToPort`` does, and every string that
names the reference's package, its ``-m opensearch_tpu.lint`` entry point,
its ``opensearch_tpu.common`` imports or its ``lint_baseline.json``
naming the port's instead). Both runs must pass the case's own assertions:
the CFG, the baseline ratchet, ``--fix``, ``--explain``, the CLI
(``--changed`` in a temporary git repository included), ``jobs > 1``
against a serial run, thread roles and the role-summary cache.

Cases about the reference's own tree or baseline (:data:`TREE_CASES`) run
only as the port's copy, which points them at ``opensearch_tpu_torch/``
and its baseline, ``opensearch_tpu_torch/lint_baseline.json``; the
reference's run of them is tests/test_lint.py's. Left to the reference
alone (:data:`REFERENCE_ONLY`): the fixture cases of the four rules the
port rewrites for PyTorch (their JAX fixtures have torch twins in
tests/lint_fixtures_torch/, held by tests/test_torch_lint.py), the
reference's repo gate with its 13 s wall-clock budget (the port's gate is
tests/test_torch_lint.py's, timed apart), and scripts/check.sh, which
wraps the reference's gate.
"""

from __future__ import annotations

import ast
import importlib
import sys
import types
from pathlib import Path

import pytest

from test_torch_cluster_data import _ToPort, cases, run_case

REFERENCE = "test_lint"
TESTS = Path(__file__).resolve().parent
REF_PKG, PORT_PKG = "opensearch_tpu", "opensearch_tpu_torch"
PORT_BASELINE = f"{PORT_PKG}/lint_baseline.json"
TWIN_FIXTURES = ("tpu001_bad.py", "tpu007_bad.py", "tpu014_bad.py",
                 "tpu016_bad.py", "tpu016_ops_bad.py")
TREE_CASES = (
    "test_baseline_is_fully_ratcheted",
    "test_linter_lints_its_own_source_clean",
    "test_cli_repo_gate_exits_zero_with_committed_baseline",
    "test_cli_repo_gate_passes_from_any_cwd",
    "test_repo_has_zero_pending_fixes",
    "test_static_pass_roles_services_that_needed_dynamic_drilling",
    "test_cache_hit_and_cold_runs_produce_identical_findings",
)
REFERENCE_ONLY = (
    "test_repo_is_clean_against_committed_baseline",
    "test_check_script_exists_and_runs_the_lint_gate",
)


class _LintToPort(_ToPort):
    """``_ToPort``'s import rewriting, and the strings that name the
    reference's package, entry point or baseline."""

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            text = node.value
            if text == REF_PKG:
                text = PORT_PKG
            elif text == "lint_baseline.json":
                text = PORT_BASELINE
            else:
                text = text.replace(f"{REF_PKG}.", f"{PORT_PKG}.")
            node.value = text
        return node


def port_copy() -> types.ModuleType:
    """tests/test_lint.py with the port's linter in place of the
    reference's."""
    name = f"torch_port_lint_{REFERENCE}"
    if name in sys.modules:
        return sys.modules[name]
    path = TESTS / f"{REFERENCE}.py"
    tree = _LintToPort().visit(ast.parse(path.read_text(), str(path)))
    ast.fix_missing_locations(tree)
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    sys.modules[name] = mod
    exec(compile(tree, str(path), "exec"), mod.__dict__)
    return mod


def _case_id(param) -> str:
    _cls, fname, params = param.values[0]
    pid = "-".join(v.name if isinstance(v, Path) else str(v)
                   for v in params.values())
    return fname + (f"[{pid}]" if pid else "")


def _is_twin_fixture(param) -> bool:
    _cls, _fname, params = param.values[0]
    return any(isinstance(v, Path) and v.name in TWIN_FIXTURES
               for v in params.values())


ALL = cases(importlib.import_module(REFERENCE), skip=REFERENCE_ONLY)
BOTH = [pytest.param(p.values[0], id=_case_id(p)) for p in ALL
        if p.values[0][1] not in TREE_CASES and not _is_twin_fixture(p)]
TREE = [pytest.param(p.values[0], id=_case_id(p)) for p in ALL
        if p.values[0][1] in TREE_CASES]


@pytest.mark.parametrize("case", BOTH)
def test_reference_case_on_both(case, tmp_path):
    """The case as the reference wrote it, then as the port's copy."""
    for label, mod in (("ref", importlib.import_module(REFERENCE)),
                       ("port", port_copy())):
        (tmp_path / label).mkdir()
        run_case(mod, case, tmp_path / label)


@pytest.mark.parametrize("case", TREE)
def test_tree_case_on_the_port(case, tmp_path):
    """A case about the reference's tree or baseline, pointed at the
    port's."""
    run_case(port_copy(), case, tmp_path)


def test_every_reference_case_is_placed():
    """Each case of tests/test_lint.py runs here on both packages, here on
    the port's tree, or stays the reference's for a stated reason."""
    ref = importlib.import_module(REFERENCE)
    every = cases(ref)
    placed = BOTH + TREE
    left = [p for p in every if p.values[0][1] in REFERENCE_ONLY
            or _is_twin_fixture(p)]
    assert len(placed) + len(left) == len(every)
    assert {_case_id(p) for p in left} == {
        *REFERENCE_ONLY,
        *(f"test_bad_fixture_flags_exact_lines[{f}]" for f in TWIN_FIXTURES)}
    names = {p.values[0][1] for p in every}
    assert set(TREE_CASES) <= names and set(REFERENCE_ONLY) <= names


def test_the_port_copy_names_only_the_port():
    """The copy's strings and imports name the port's package, entry
    point and baseline, never the reference's."""
    mod = port_copy()
    assert mod.lint_source.__module__ == f"{PORT_PKG}.lint.core"
    assert mod.ALL_CHECKERS is importlib.import_module(
        f"{PORT_PKG}.lint.rules").ALL_CHECKERS
    assert mod.BASELINE == mod.REPO / PORT_BASELINE
    assert mod.PKG == mod.REPO / PORT_PKG
