"""The port's host scripting (opensearch_tpu_torch/script/: the Painless
subset's tokenizer, parser and Evaluator, the ScriptService cache and the
mustache templates) against the reference's, on the CPU.

Every expression of tests/test_scripting.py's language tests, and the
scripts the pipeline aggregations run (``moving_fn`` over the
MovingFunctions namespace of each package's search/aggs_pipeline.py,
``bucket_script``, ``bucket_selector`` and ``scripted_metric`` bodies),
runs through both packages' ``Evaluator`` with the same environment: the
values must be equal (the same type too), or both must raise an exception
of the same class name with the same message. The mustache cases are those
of tests/test_templates_geo.py and the search-template bodies.
"""

from __future__ import annotations

import pytest

pytest.importorskip("jax")

from opensearch_tpu.script import ScriptService as RefScriptService
from opensearch_tpu.script import mustache as ref_mustache
from opensearch_tpu.script import painless as ref_painless
from opensearch_tpu.search import aggs_pipeline as ref_pipeline
from opensearch_tpu_torch.script import ScriptService
from opensearch_tpu_torch.script import mustache, painless
from opensearch_tpu_torch.search import aggs_pipeline

WINDOW = [30.0, 70.0, 50.0, 12.5, 99.0]

# (source, environment) pairs; "MF" in an environment stands for each
# package's own MovingFunctions namespace
CASES = [
    ("1 + 2 * 3", {}), ("(1 + 2) * 3", {}), ("10 / 4.0", {}),
    ("10 / 3", {}), ("10 % 3", {}), ("2 - -3", {}),
    ("1 < 2 && 2 <= 2", {}), ("1 > 2 || 3 != 4", {}), ("!(1 == 1)", {}),
    ("5 > 3 ? 'big' : 'small'", {}),
    ("'a' + 'b'", {}), ("'count: ' + 3", {}), ("'Hello'.toLowerCase()", {}),
    ("'hello world'.contains('wor')", {}), ("'abc'.substring(1)", {}),
    ("'a,b,c'.split(',')", {}), ("'abc'.length()", {}),
    ("Math.max(3, 7)", {}), ("Math.log(Math.E)", {}), ("Math.sqrt(16)", {}),
    ("Math.pow(2, 10)", {}),
    ("params.a * 2", {"params": {"a": 21}}), ("def x = 5; x * x", {}),
    ("double y = 1.5; y + 1", {}),
    ("if (params.n > 10) { return 'big' } else { return 'small' }",
     {"params": {"n": 11}}),
    ("if (params.n > 10) { return 'big' } else { return 'small' }",
     {"params": {"n": 2}}),
    ("[1, 2, 3].size()", {}),
    ("params.m.containsKey('k')", {"params": {"m": {"k": 1}}}),
    ("params.m.get('k') + 1", {"params": {"m": {"k": 1}}}),
    ("params.xs.contains(2)", {"params": {"xs": [1, 2]}}),
    # the sandbox and the runtime errors
    ("__import__('os')", {}), ("open('/etc/passwd')", {}),
    ("params.__class__", {"params": {}}), ("1 / 0", {}),
    ("Math.pi", {}), ("Math.sqrt(0 - 1)", {}), ("'abc'.charAt(10)", {}),
    ("def x = ; 1", {}), ("while (true) { }", {}),
    # the pipeline aggregations' scripts
    ("MovingFunctions.unweightedAvg(values)",
     {"values": WINDOW, "MovingFunctions": "MF"}),
    ("MovingFunctions.unweightedAvg(values)",
     {"values": [], "MovingFunctions": "MF"}),
    ("MovingFunctions.max(values)", {"values": WINDOW, "MovingFunctions": "MF"}),
    ("MovingFunctions.min(values)", {"values": WINDOW, "MovingFunctions": "MF"}),
    ("MovingFunctions.sum(values)", {"values": WINDOW, "MovingFunctions": "MF"}),
    ("MovingFunctions.stdDev(values, MovingFunctions.unweightedAvg(values))",
     {"values": WINDOW, "MovingFunctions": "MF"}),
    ("MovingFunctions.linearWeightedAvg(values)",
     {"values": WINDOW, "MovingFunctions": "MF"}),
    ("MovingFunctions.ewma(values, 0.3)",
     {"values": WINDOW, "MovingFunctions": "MF"}),
    ("MovingFunctions.holt(values, 0.3, 0.1)",
     {"values": WINDOW, "MovingFunctions": "MF"}),
    ("MovingFunctions.bogus(values)",
     {"values": WINDOW, "MovingFunctions": "MF"}),
    ("params.s / params.n", {"params": {"s": 70.0, "n": 2.0}}),
    ("params.s > 40", {"params": {"s": 30.0}}),
    ("params.n > 1", {"params": {"n": 2.0}}),
    ("state.total = 0", {"state": {}}),
    ("def s = 0; for (t in states) { s += t } return s",
     {"states": [30, 70, 50]}),
    ("return state.total", {"state": {"total": 150}}),
]


def _outcome(package_painless, pipeline_mod, source: str, env: dict):
    env = {k: (pipeline_mod._MovingFunctions() if v == "MF" else v)
           for k, v in env.items()}
    env = {k: (dict(v) if isinstance(v, dict) else v) for k, v in env.items()}
    try:
        ast = package_painless.compile_script(source)
        value = package_painless.Evaluator(env).run(ast)
    except Exception as e:  # noqa: BLE001 - the outcome under test
        return ("raises", type(e).__name__, str(e))
    return ("value", type(value).__name__, value, env.get("state"))


@pytest.mark.parametrize("source,env", CASES,
                         ids=[f"{i}" for i in range(len(CASES))])
def test_evaluator_is_the_references(source, env):
    want = _outcome(ref_painless, ref_pipeline, source, env)
    got = _outcome(painless, aggs_pipeline, source, env)
    assert got == want


def test_sandbox_errors_are_script_exceptions():
    for source in ("__import__('os')", "1 / 0", "Math.pi"):
        outcome = _outcome(painless, aggs_pipeline, source, {})
        assert outcome[:2] == ("raises", "ScriptException")
    assert painless.ScriptException.__name__ == \
        ref_painless.ScriptException.__name__


def test_compile_cache_is_the_references():
    for svc in (ScriptService(), RefScriptService()):
        svc.compile({"source": "1 + 1"})
        svc.compile({"source": "1 + 1"})
        assert svc.stats["compilations"] == 1


MUSTACHE_CASES = [
    ("{{a}}/{{b.c}}", {"a": 1, "b": {"c": "x"}}),
    ("{{#toJson}}v{{/toJson}}", {"v": [1, 2]}),
    ("{{#join}}v{{/join}}", {"v": ["a", "b"]}),
    ("{{#on}}yes{{/on}}{{^on}}no{{/on}}", {"on": True}),
    ("{{#on}}yes{{/on}}{{^on}}no{{/on}}", {"on": False}),
    ("{{#xs}}[{{.}}]{{/xs}}", {"xs": [1, 2, 3]}),
    ("{{missing}}-{{a}}", {"a": "z"}),
    ("{{#open}}never closed", {"open": True}),
]


@pytest.mark.parametrize("template,params", MUSTACHE_CASES,
                         ids=[f"{i}" for i in range(len(MUSTACHE_CASES))])
def test_mustache_is_the_references(template, params):
    def outcome(mod):
        try:
            return ("value", mod.render(template, params))
        except Exception as e:  # noqa: BLE001 - the outcome under test
            return ("raises", type(e).__name__, str(e))

    assert outcome(mustache) == outcome(ref_mustache)


@pytest.mark.parametrize("source", [
    {"query": {"term": {"level": "{{lvl}}"}}},
    '{"query": {"term": {"level": "{{lvl}}"}}}',
    '{"query": {"terms": {"level": {{#toJson}}levels{{/toJson}}}}, '
    '"size": {{size}}}',
], ids=["tree", "string", "to_json"])
def test_search_template_is_the_references(source):
    params = {"lvl": "x", "levels": ["a", "b"], "size": 3}
    assert (mustache.render_search_template(source, params)
            == ref_mustache.render_search_template(source, params))
