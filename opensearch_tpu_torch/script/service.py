"""ScriptService: compile cache + execution contexts.

The analog of server/.../script/ScriptService.java:82 — compile-once cache
keyed by (lang, source), per-context entry points mirroring the reference's
ScriptContext registry (score, field, update, ingest, aggs). The "painless"
language is the interpreter in painless.py; "expression" is accepted as an
alias (numeric-only scripts are a strict subset).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any

from opensearch_tpu_torch.common.errors import IllegalArgumentException
from opensearch_tpu_torch.script.painless import (
    DocView,
    Evaluator,
    ScriptException,
    compile_script,
)

DEFAULT_CACHE_SIZE = 3000


class ScriptService:
    def __init__(self, cache_size: int = DEFAULT_CACHE_SIZE):
        self._cache: OrderedDict[str, Any] = OrderedDict()
        self._cache_size = cache_size
        self.stats = {"compilations": 0, "cache_evictions": 0}

    def compile(self, script: dict | str):
        """script: {"source": ..., "lang": "painless", "params": {...}} or
        bare source string. Returns (ast, params)."""
        if isinstance(script, str):
            source, params = script, {}
        else:
            if "id" in script:
                raise IllegalArgumentException(
                    "stored scripts are not supported yet; use inline source"
                )
            source = script.get("source", "")
            params = script.get("params") or {}
            lang = script.get("lang", "painless")
            if lang not in ("painless", "expression"):
                raise IllegalArgumentException(f"unsupported script lang [{lang}]")
        ast = self._cache.get(source)
        if ast is None:
            ast = compile_script(source)
            self.stats["compilations"] += 1
            self._cache[source] = ast
            if len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)
                self.stats["cache_evictions"] += 1
        else:
            self._cache.move_to_end(source)
        return ast, params

    # -- contexts ----------------------------------------------------------

    def score(self, ast, params: dict, host, doc: int, mapper_service,
              score: float = 0.0) -> float:
        env = {
            "params": params,
            "doc": DocView(host, doc, mapper_service),
            "_score": score,
        }
        out = Evaluator(env).run(ast)
        if out is None:
            raise ScriptException("score script returned null")
        return float(out)

    def field(self, ast, params: dict, host, doc: int, mapper_service,
              source: dict | None = None) -> Any:
        env = {
            "params": params,
            "doc": DocView(host, doc, mapper_service),
        }
        if source is not None:
            env["_source"] = source
        return Evaluator(env).run(ast)

    def execute_update(self, ast, params: dict, ctx: dict) -> dict:
        """update-by-script: ctx = {"_source": {...}, "op": "index", ...};
        the script mutates ctx in place (UpdateHelper semantics)."""
        env = {"params": params, "ctx": ctx}
        Evaluator(env).run(ast)
        return ctx

    def execute_ingest(self, ast, params: dict, doc_source: dict) -> dict:
        """ingest script processor: ctx IS the document source."""
        env = {"params": params, "ctx": doc_source}
        Evaluator(env).run(ast)
        return doc_source


# module-level default instance (the node-singleton the reference wires in
# Node.java; a TpuNode could own one per node — scripts are stateless so a
# process-wide cache is equivalent)
default_script_service = ScriptService()
