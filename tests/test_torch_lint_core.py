"""tpulint's analysis core of the port (lint/{core,threadroles,callgraph})
against the reference's.

- ``callgraph.program_roles`` of each package over one input tree (the
  reference's ``opensearch_tpu/``) gives the same role map, method for
  method: the copies analyse alike.
- The port's pass over ``opensearch_tpu_torch/`` roles the same class
  names as the reference's pass over its own tree, but for the
  differences :data:`ROLED_ONLY` names.
- ``core.iter_py_files``, ``dotted_name``, ``import_aliases``,
  ``parse_suppressions`` and ``lint_source`` agree on every fixture under
  tests/lint_fixtures/, with the thread-role rules' in-file roles
  (``callgraph.extract_module`` / ``compute_program_roles``) equal too.
- The rule registry (``lint/rules.py``) holds the reference's 19 rule
  ids, and ``lint_paths`` with no checkers runs them all, serially or in
  a process pool (tests/test_torch_lint.py holds the rules themselves).

Each pass here runs with ``use_cache=False`` or a cache file under the
test's own directory.
"""

from __future__ import annotations

import ast
import importlib
from pathlib import Path

import pytest

pytest.importorskip("jax")

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "lint_fixtures"
PACKAGES = ("opensearch_tpu", "opensearch_tpu_torch")
# class names one package's pass over its own tree roles and the other's
# does not, and why
ROLED_ONLY = {
    "opensearch_tpu": {
        # the port's node class is TorchNode
        "TpuNode",
    },
    "opensearch_tpu_torch": {
        # the reference's node class is TpuNode
        "TorchNode",
        # TorchNode._release_index(name, svc: IndexService) names the type
        # of the index it closes (node.py), so the pass carries the REST
        # pool's role into IndexService.close; the reference closes it
        # through an untyped local
        "IndexService",
    },
}


def lint(package: str, name: str):
    return importlib.import_module(f"{package}.lint.{name}")


def roles_over(package: str, tree: str, tmp_path: Path) -> dict:
    core, callgraph = lint(package, "core"), lint(package, "callgraph")
    files = list(core.iter_py_files([str(REPO / tree)]))
    roles, _summaries = callgraph.program_roles(
        files, cache_path=str(tmp_path / f"{package}.json"))
    return roles


def test_program_roles_equal_over_one_tree(tmp_path):
    ref, port = (roles_over(p, "opensearch_tpu", tmp_path) for p in PACKAGES)
    assert ref, "the pass roled nothing"
    assert ref == port


def test_each_pass_roles_the_same_classes_over_its_own_tree(tmp_path):
    roled = {p: set(roles_over(p, p, tmp_path)) for p in PACKAGES}
    for p in PACKAGES:
        other = PACKAGES[1 - PACKAGES.index(p)]
        assert roled[p] - roled[other] == ROLED_ONLY[p], p
    # the services the race probe drills and watches are roled in both
    for cls in ("SearchBackpressureService", "HierarchyBreakerService",
                "ClusterNode"):
        assert all(cls in roled[p] for p in PACKAGES), cls


def test_the_cache_round_trips(tmp_path):
    """A second pass reads the summaries the first wrote, to the same
    roles; the port's default cache is a file of its own."""
    callgraph = lint("opensearch_tpu_torch", "callgraph")
    first = roles_over("opensearch_tpu_torch", "opensearch_tpu_torch/lint",
                       tmp_path)
    assert (tmp_path / "opensearch_tpu_torch.json").exists()
    assert roles_over("opensearch_tpu_torch", "opensearch_tpu_torch/lint",
                      tmp_path) == first
    assert Path(callgraph.default_cache_path()).name != \
        Path(lint("opensearch_tpu", "callgraph").default_cache_path()).name


def _names(tree: ast.AST, dotted_name) -> list:
    return [dotted_name(n) for n in ast.walk(tree)
            if isinstance(n, (ast.Name, ast.Attribute, ast.Call))]


def test_core_agrees_on_the_fixtures():
    ref, port = (lint(p, "core") for p in PACKAGES)
    files = list(ref.iter_py_files([str(FIXTURES)]))
    assert len(files) >= 40
    assert files == list(port.iter_py_files([str(FIXTURES)]))
    for f in files:
        source = Path(f).read_text()
        tree = ast.parse(source)
        assert _names(tree, ref.dotted_name) == \
            _names(tree, port.dotted_name), f
        assert ref.import_aliases(tree) == port.import_aliases(tree), f
        assert ref.parse_suppressions(source) == \
            port.parse_suppressions(source), f
        assert ref.normalize_path(f) == port.normalize_path(f)


def test_in_file_roles_agree_on_the_fixtures():
    files = sorted(FIXTURES.glob("*.py"))
    roled = 0
    for f in files:
        source = f.read_text()
        out = []
        for p in PACKAGES:
            callgraph = lint(p, "callgraph")
            summary = callgraph.extract_module(source)
            out.append(callgraph.compute_program_roles({"<file>": summary}))
        assert out[0] == out[1], f.name
        roled += bool(out[0])
    assert roled, "no fixture carries a role"


def attr_chains(package: str):
    """A checker written against ``package``'s Checker base: one
    violation per attribute chain of three names or more."""
    core = lint(package, "core")

    class AttrChains(core.Checker):
        rule_id = "TPU900"
        name = "attr-chains"

        def check(self, ctx):
            for n in ast.walk(ctx.tree):
                name = core.dotted_name(n)
                if isinstance(n, ast.Attribute) and name and \
                        name.count(".") >= 2:
                    yield ctx.violation(self.rule_id, n, name)

    return AttrChains()


def test_lint_source_and_paths_agree_on_the_fixtures():
    out = {}
    for p in PACKAGES:
        core = lint(p, "core")
        checker = attr_chains(p)
        vs, n = core.lint_paths([str(FIXTURES)], checkers=[checker])
        out[p] = ([v.to_dict() for v in vs], n)
    assert out["opensearch_tpu"] == out["opensearch_tpu_torch"]
    assert out["opensearch_tpu"][0], "the checker found nothing"


def test_the_rule_registry_is_not_quietly_empty(tmp_path):
    """The port's registry holds the reference's 19 rule ids, and
    ``lint_paths`` with no checkers runs them all: over the fixtures it
    finds violations of the reference's shared rules, serially and in a
    process pool alike."""
    ref_rules = lint("opensearch_tpu", "rules")
    import opensearch_tpu_torch.lint as port_lint

    assert list(port_lint.RULES) == list(ref_rules.RULES)
    assert len(port_lint.RULES) == 19
    core = lint("opensearch_tpu_torch", "core")
    serial, n = core.lint_paths([str(FIXTURES)], use_cache=False)
    pooled, n2 = core.lint_paths([str(FIXTURES)], jobs=4, use_cache=False)
    assert (serial, n) == (pooled, n2) and n >= 40
    found = {v.rule for v in serial}
    # every rule the reference keeps as it is finds its bad fixture
    assert found == set(port_lint.RULES) - {
        "TPU001", "TPU007", "TPU014", "TPU016"}
    # a custom checker with jobs > 1 runs serially, as the reference runs
    # a checker its registry does not hold
    checker = attr_chains("opensearch_tpu_torch")
    serial, n = core.lint_paths([str(FIXTURES)], checkers=[checker])
    jobs, n2 = core.lint_paths([str(FIXTURES)], checkers=[checker], jobs=4)
    assert (serial, n) == (jobs, n2) and serial
