"""The YAML REST runner (testing/yaml_compat.py) of the port against the
reference's.

The reference's one case reads OpenSearch's own YAML suites from the
checkout of its rest-api-spec, and skips where that is absent; the port's
copy of the case reads the port runner's spec root (``$OPENSEARCH_REST_API_SPEC``,
else ``reference/`` inside the checkout) and skips by the same rule, for
the same reason.

Both runners then run YAML step files written by hand for this test
(tests/yaml_steps/test/, with the few API specs they call in
tests/yaml_steps/api/), each through its own package's router over a
fresh single node per test: the reference's over a ``TpuNode``, the
port's over a ``TorchNode(..., device="cpu")``. The files cover every
step kind the runner's docstring lists: ``do`` (with ``catch`` by name
and by pattern), ``match`` (values, patterns, stashed values), ``length``,
``is_true``, ``is_false``, ``set``, ``transform_and_set`` (which both
skip), ``gt`` / ``gte`` / ``lt`` / ``lte``, ``contains`` and ``skip``
(by version and by feature); and three tests written to fail. Both
runners must report the same status for every test and the same outcome
for every step, in order.
"""

from __future__ import annotations

import importlib
import os
from pathlib import Path

import pytest

pytest.importorskip("jax")
pytest.importorskip("yaml")

from test_torch_cluster_data import port_module

REFERENCE = "test_yaml_compat"
PACKAGES = ("opensearch_tpu", "opensearch_tpu_torch")
STEPS = Path(__file__).resolve().parent / "yaml_steps"
REPO = Path(__file__).resolve().parents[1]
STEP_KINDS = {"do", "match", "length", "is_true", "is_false", "set",
              "transform_and_set", "gt", "gte", "lt", "lte", "contains",
              "skip"}
# the tests written to fail, and the step each fails at
FAILING = {"a match that fails": "match", "a length that fails": "length",
           "an uncaught error fails": "do"}


def yaml_compat(package: str):
    return importlib.import_module(f"{package}.testing.yaml_compat")


def test_reference_case_skips_the_same_way_in_both():
    ref_mod, port_mod = (importlib.import_module(REFERENCE),
                         port_module(REFERENCE))
    for mod, package in zip((ref_mod, port_mod), PACKAGES):
        spec = yaml_compat(package).REFERENCE_SPEC
        assert spec.parts[-4:] == ("src", "main", "resources",
                                   "rest-api-spec")
        (mark,) = [m for m in mod.test_yaml_compliance_pass_rate.pytestmark
                   if m.name == "skipif"]
        assert (mark.args, mark.kwargs) == ((not spec.exists(),), {
            "reason": "reference rest-api-spec not mounted"}), package
        assert (mod.SUITES == []) is (not spec.exists()), package
    # the port's root is the one the environment names, else one inside
    # this checkout: never a path around it
    port_yc = yaml_compat("opensearch_tpu_torch")
    named = os.environ.get(port_yc.SPEC_ENV)
    if named:
        assert port_yc.REFERENCE_SPEC == Path(named)
    else:
        assert REPO in port_yc.REFERENCE_SPEC.parents


def run_steps(package: str, tmp_path: Path) -> tuple[list, list]:
    """Every hand-written file through ``package``'s runner: its results
    as (suite, test, status), and each test's steps as (kind, outcome),
    in the same order."""
    yc = yaml_compat(package)
    per_test: list[list] = []
    step, run_one = yc.YamlTestRunner._step, yc.YamlTestRunner._run_one

    def recorded(runner, s, *a, **kw):
        kind = next(iter(s)) if isinstance(s, dict) and s else repr(s)
        try:
            out = step(runner, s, *a, **kw)
        except Exception as e:
            per_test[-1].append((kind, type(e).__name__))
            raise
        per_test[-1].append((kind, "ok"))
        return out

    def one_test(runner, *a, **kw):
        per_test.append([])
        return run_one(runner, *a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(yc.YamlTestRunner, "_step", recorded)
    mp.setattr(yc.YamlTestRunner, "_run_one", one_test)
    factory = (yc.make_node_factory(tmp_path) if package == "opensearch_tpu"
               else yc.make_node_factory(tmp_path, device="cpu"))
    runner = yc.YamlTestRunner(factory, yc.ApiSpecs(STEPS / "api"))
    results = []
    try:
        for suite_dir in sorted((STEPS / "test").iterdir()):
            for path in sorted(suite_dir.glob("*.yml")):
                results.extend(runner.run_file(path, suite_dir.name))
    finally:
        mp.undo()
    assert len(results) == len(per_test)
    return [(r.suite, r.name, r.status) for r in results], per_test


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    return {p: run_steps(p, tmp_path_factory.mktemp(p)) for p in PACKAGES}


def test_both_runners_report_the_same_for_every_test(both_runs):
    ref, port = (both_runs[p][0] for p in PACKAGES)
    assert ref == port
    status = {name: s for _suite, name, s in ref}
    assert {n for n, s in status.items() if s == "failed"} == set(FAILING)
    assert sum(s == "skipped" for s in status.values()) == 4
    assert sum(s == "passed" for s in status.values()) == len(status) - 7


def test_both_runners_agree_step_by_step(both_runs):
    ref, port = (both_runs[p][1] for p in PACKAGES)
    assert ref == port
    kinds = {kind for steps in ref for kind, _outcome in steps}
    assert kinds == STEP_KINDS, kinds ^ STEP_KINDS
    outcomes = {outcome for steps in ref for _kind, outcome in steps}
    assert outcomes == {"ok", "StepFailure", "TestSkipped"}


def test_failing_tests_fail_at_their_step(both_runs):
    """The three failures are the runner's own verdicts (a wrong value, a
    wrong length, an uncaught 404), at the step each was written to fail
    at, in both packages."""
    for p in PACKAGES:
        results, per_test = both_runs[p]
        for (_suite, name, status), steps in zip(results, per_test):
            if name in FAILING:
                assert steps[-1] == (FAILING[name], "StepFailure"), (p, name)
            elif status == "passed":
                assert all(o == "ok" for _k, o in steps), (p, name)


def test_the_port_runner_defaults_to_the_card(tmp_path):
    import torch

    yc = yaml_compat("opensearch_tpu_torch")
    node_factory = yc.make_node_factory(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default node would use it")
    with pytest.raises(Exception, match="(?i)cuda"):
        node_factory()
