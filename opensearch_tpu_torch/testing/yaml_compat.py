"""YAML REST compliance runner.

Executes OpenSearch's implementation-agnostic YAML suites
(``rest-api-spec/src/main/resources/rest-api-spec/test`` of an OpenSearch
checkout — the suite OpenSearchClientYamlSuiteTestCase runs against a
packaged cluster) against the port's REST layer. The YAML files and API
specs are read at run time (they are protocol test DATA, not code) and are
never copied into this repo. The spec root is ``$OPENSEARCH_REST_API_SPEC``
where that is set, else ``reference/rest-api-spec/src/main/resources/
rest-api-spec`` inside this checkout (git ignores ``reference/``: link or
unpack an OpenSearch checkout there); where it is absent the suite is
skipped.

Supported step kinds: do (with catch), match, length, is_true, is_false,
set, transform_and_set (skipped), gt/gte/lt/lte, contains, skip
(version/features). Responses dispatch through the SAME trie router the
HTTP server uses (method/path/query/body — protocol-level black box minus
the socket). Each test gets a fresh ``TorchNode`` on the card
(``device="cuda"``, the default) unless the caller asks for the CPU
(``run_suites(..., device="cpu")``).
"""

from __future__ import annotations

import json
import numbers
import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

# an OpenSearch checkout's rest-api-spec: named by the environment, else
# looked for inside this checkout, never around it
SPEC_ENV = "OPENSEARCH_REST_API_SPEC"
REFERENCE_SPEC = Path(
    os.environ.get(SPEC_ENV)
    or Path(__file__).resolve().parents[2] / "reference"
    / "rest-api-spec/src/main/resources/rest-api-spec")

# test features we implement; tests demanding others are skipped
SUPPORTED_FEATURES = {
    "contains", "allowed_warnings", "warnings", "arbitrary_key",
}

CATCH_STATUS = {
    "bad_request": {400},
    "unauthorized": {401},
    "forbidden": {403},
    "missing": {404},
    "request_timeout": {408},
    "conflict": {409},
    "unavailable": {503},
    "request": set(range(400, 600)),
    "param": {400},
}


def _jsonable(v):
    """YAML auto-parses ISO timestamps to datetime; REST bodies are JSON."""
    import datetime as _dt

    if isinstance(v, _dt.datetime):
        return v.isoformat().replace("+00:00", "Z")
    if isinstance(v, _dt.date):
        return v.isoformat()
    return str(v)


class StepFailure(Exception):
    pass


class TestSkipped(Exception):
    pass


@dataclass
class YamlTestResult:
    suite: str
    name: str
    status: str          # passed | failed | skipped
    detail: str = ""


class ApiSpecs:
    def __init__(self, api_dir: Path):
        self.api_dir = api_dir
        self._cache: dict[str, dict] = {}

    def get(self, api: str) -> dict | None:
        if api not in self._cache:
            path = self.api_dir / f"{api}.json"
            if not path.exists():
                self._cache[api] = None
            else:
                self._cache[api] = json.loads(path.read_text())[api]
        return self._cache[api]

    def resolve(self, api: str, args: dict) -> tuple[str, str, dict, Any]:
        """(method, path, query_params, body) for one `do` invocation."""
        spec = self.get(api)
        if spec is None:
            raise StepFailure(f"no API spec for [{api}]")
        args = dict(args)
        body = args.pop("body", None)
        # choose the path with the most parts that are all provided
        best = None
        for p in spec["url"]["paths"]:
            parts = set((p.get("parts") or {}).keys())
            if parts <= set(args):
                if best is None or len(parts) > len(best[1]):
                    best = (p, parts)
        if best is None:
            raise StepFailure(f"no matching url for [{api}] args {args}")
        p, parts = best
        path = p["path"]
        from urllib.parse import quote

        for part in parts:
            value = args.pop(part)
            if value is None:
                # an explicit null path part fails java-client validation
                raise StepFailure(
                    f"[{api}] path part [{part}] must not be null")
            if isinstance(value, list):
                value = ",".join(str(v) for v in value)
            # clients URL-encode path parts (date-math "<x-{now/M}>" has a
            # slash); the router unquotes bound params
            path = path.replace("{" + part + "}",
                                quote(str(value), safe=",*"))
        method = p["methods"][0]
        if "POST" in p["methods"] and body is not None:
            method = "POST"
        if "PUT" in p["methods"] and method == "POST" and body is not None \
                and "POST" not in p["methods"]:
            method = "PUT"
        def urlish(v: Any) -> str:
            # query params travel as URL strings: booleans lowercase
            if isinstance(v, bool):
                return "true" if v else "false"
            if isinstance(v, list):
                return ",".join(urlish(x) for x in v)
            return str(v)

        query = {k: urlish(v) for k, v in args.items()}
        return method, path, query, body


class Stash(dict):
    _VAR = re.compile(r"^\$\{?(\w+)\}?$")

    def resolve(self, value: Any) -> Any:
        if isinstance(value, str):
            m = self._VAR.match(value)
            if m and m.group(1) in self:
                return self[m.group(1)]
        if isinstance(value, dict):
            return {k: self.resolve(v) for k, v in value.items()}
        if isinstance(value, list):
            return [self.resolve(v) for v in value]
        return value


def lookup(response: Any, path: str, stash: Stash) -> Any:
    if path in ("$body", ""):
        return response
    current = response
    # split on '.' but keep escaped dots (a\.b)
    parts = re.split(r"(?<!\\)\.", path)
    for raw in parts:
        key = stash.resolve(raw.replace("\\.", "."))
        if key == "_arbitrary_key_" and isinstance(current, dict):
            # the `arbitrary_key` feature: resolves to SOME key of the
            # object (used to grab a node id from the nodes map)
            if not current:
                raise StepFailure(f"path [{path}]: empty object for "
                                  f"_arbitrary_key_")
            current = next(iter(current))
            continue
        if isinstance(current, list):
            current = current[int(key)]
        elif isinstance(current, dict):
            if key not in current:
                raise StepFailure(f"path [{path}]: missing key [{key}]")
            current = current[key]
        else:
            raise StepFailure(f"path [{path}]: cannot descend into {type(current)}")
    return current


def _match(expected: Any, actual: Any) -> bool:
    if isinstance(expected, str) and len(expected) > 1 \
            and expected.startswith("/") and expected.rstrip().endswith("/"):
        pattern = expected.strip().strip("/")
        return re.search(pattern, str(actual), re.VERBOSE) is not None
    if isinstance(expected, numbers.Number) and isinstance(actual, numbers.Number) \
            and not isinstance(expected, bool) and not isinstance(actual, bool):
        return float(expected) == float(actual)
    if isinstance(expected, dict) and isinstance(actual, dict):
        return all(k in actual and _match(v, actual[k])
                   for k, v in expected.items())
    return expected == actual


class YamlTestRunner:
    """Runs one YAML document set against a fresh node per test."""

    def __init__(self, node_factory, specs: ApiSpecs):
        self.node_factory = node_factory
        self.specs = specs

    def run_file(self, path: Path, suite: str) -> list[YamlTestResult]:
        import yaml as _yaml

        docs = list(_yaml.safe_load_all(path.read_text()))
        setup_steps: list = []
        teardown_steps: list = []
        tests: list[tuple[str, list]] = []
        for doc in docs:
            if not doc:
                continue
            for name, steps in doc.items():
                if name == "setup":
                    setup_steps = steps
                elif name == "teardown":
                    teardown_steps = steps
                else:
                    tests.append((name, steps))
        results = []
        for name, steps in tests:
            label = f"{suite}/{path.stem}"
            try:
                self._run_one(setup_steps, steps)
                results.append(YamlTestResult(label, name, "passed"))
            except TestSkipped as e:
                results.append(YamlTestResult(label, name, "skipped", str(e)))
            except Exception as e:  # noqa: BLE001 - any failure is a miss
                results.append(
                    YamlTestResult(label, name, "failed", str(e)[:200])
                )
        return results

    def _run_one(self, setup_steps: list, steps: list) -> None:
        node, dispatch = self.node_factory()
        stash = Stash()
        try:
            for step in setup_steps:
                self._step(step, dispatch, stash, in_setup=True)
            for step in steps:
                self._step(step, dispatch, stash)
        finally:
            node.close()

    # -- steps -------------------------------------------------------------

    def _step(self, step: dict, dispatch, stash: Stash,
              in_setup: bool = False) -> None:
        if not isinstance(step, dict) or len(step) != 1:
            raise StepFailure(f"malformed step {step!r}")
        kind, payload = next(iter(step.items()))
        if kind == "skip":
            self._skip(payload)
            return
        if kind == "do":
            self._do(payload, dispatch, stash)
            return
        if kind == "set":
            (path, var), = payload.items()
            stash[var] = lookup(self.last_response, path, stash)
            return
        if kind == "match":
            (path, expected), = payload.items()
            if expected is None:
                # match: {key: null} passes when the key is null OR absent
                # (the reference runner's assertNull)
                try:
                    actual = lookup(self.last_response, path, stash)
                except StepFailure:
                    return
                if actual is None:
                    return
                raise StepFailure(f"match {path}: expected null "
                                  f"got {actual!r}")
            actual = lookup(self.last_response, path, stash)
            expected = stash.resolve(expected)
            if not _match(expected, actual):
                raise StepFailure(
                    f"match {path}: expected {expected!r} got {actual!r}"
                )
            return
        if kind == "length":
            (path, expected), = payload.items()
            actual = lookup(self.last_response, path, stash)
            if len(actual) != int(stash.resolve(expected)):
                raise StepFailure(
                    f"length {path}: expected {expected} got {len(actual)}"
                )
            return
        if kind in ("is_true", "is_false"):
            try:
                value = lookup(self.last_response, payload, stash)
            except StepFailure:
                value = None
            truthy = value not in (None, False, "", 0, "false")
            if kind == "is_true" and not truthy:
                raise StepFailure(f"is_true {payload}: got {value!r}")
            if kind == "is_false" and truthy:
                raise StepFailure(f"is_false {payload}: got {value!r}")
            return
        if kind in ("gt", "gte", "lt", "lte"):
            (path, bound), = payload.items()
            actual = lookup(self.last_response, path, stash)
            bound = float(stash.resolve(bound))
            ok = {"gt": actual > bound, "gte": actual >= bound,
                  "lt": actual < bound, "lte": actual <= bound}[kind]
            if not ok:
                raise StepFailure(f"{kind} {path}: {actual} vs {bound}")
            return
        if kind == "contains":
            (path, expected), = payload.items()
            actual = lookup(self.last_response, path, stash)
            expected = stash.resolve(expected)
            if isinstance(actual, list):
                if not any(_match(expected, item) for item in actual):
                    raise StepFailure(f"contains {path}: {expected!r} not in list")
                return
            if expected not in actual:
                raise StepFailure(f"contains {path}: {expected!r} not in {actual!r}")
            return
        if kind == "transform_and_set":
            raise TestSkipped("transform_and_set not supported")
        raise StepFailure(f"unknown step kind [{kind}]")

    def _skip(self, payload: dict) -> None:
        features = payload.get("features") or []
        if isinstance(features, str):
            features = [features]
        unsupported = [f for f in features if f not in SUPPORTED_FEATURES]
        if unsupported:
            raise TestSkipped(f"requires features {unsupported}")
        version = payload.get("version")
        if version is not None:
            v = str(version).strip()
            if v == "all" or v.startswith("all"):
                raise TestSkipped(payload.get("reason", "skipped for all versions"))
            # "N - " (no upper bound) covers every later version incl. this
            # engine's -> skip; " - N" ranges target OLD versions -> run
            if v.endswith("-") or re.fullmatch(r"[\d.]+\s*-\s*", v):
                raise TestSkipped(payload.get("reason", v))

    def _do(self, payload: dict, dispatch, stash: Stash) -> None:
        payload = dict(payload)
        catch = payload.pop("catch", None)
        payload.pop("headers", None)
        payload.pop("allowed_warnings", None)
        payload.pop("warnings", None)
        payload.pop("node_selector", None)
        if len(payload) != 1:
            raise StepFailure(f"do with {len(payload)} apis")
        (api, args), = payload.items()
        args = stash.resolve(args or {})
        ignore = args.pop("ignore", None) if isinstance(args, dict) else None
        ignored = ({int(v) for v in (ignore if isinstance(ignore, list) else [ignore])}
                   if ignore is not None else set())
        try:
            method, path, query, body = self.specs.resolve(api, args)
        except StepFailure:
            if catch is not None:
                # client-side validation failure (e.g. a required path part
                # is absent) satisfies an expected-error step, matching the
                # java client's request validation
                self.last_response = {}
                return
            raise
        status, response = dispatch(method, path, query, body)
        if method == "HEAD":
            # HEAD-based exists APIs: the client contract is a boolean
            # (404 is "false", not an error) — ClientYamlTestResponse
            response = status == 200
            self.last_response = response
            if catch is None and status not in (200, 404):
                raise StepFailure(f"do {api}: HTTP {status}")
            if catch is None:
                return
        self.last_response = response
        if catch is None:
            if status in ignored:
                return
            if status >= 400:
                raise StepFailure(
                    f"do {api}: HTTP {status} {str(response)[:160]}"
                )
            return
        if catch.startswith("/"):
            if status < 400:
                raise StepFailure(f"do {api}: expected error, got {status}")
            if re.search(catch.strip("/"), json.dumps(response)) is None:
                raise StepFailure(
                    f"do {api}: error {str(response)[:120]} !~ {catch}"
                )
            return
        allowed = CATCH_STATUS.get(catch)
        if allowed is None:
            raise StepFailure(f"unknown catch [{catch}]")
        if status not in allowed:
            raise StepFailure(
                f"do {api}: catch {catch} expected {sorted(allowed)} got "
                f"{status}"
            )


def make_node_factory(tmp_root: Path, device="cuda"):
    """Fresh single TorchNode (on ``device``) + router dispatch per test."""
    import itertools

    from opensearch_tpu_torch.node import TorchNode
    from opensearch_tpu_torch.rest.handlers import build_router
    from opensearch_tpu_torch.rest.http import _error_envelope, _parse_body
    from opensearch_tpu_torch.common.errors import OpenSearchTpuException

    router = build_router()
    counter = itertools.count()

    def factory():
        node = TorchNode(tmp_root / f"n{next(counter)}", device=device)

        def dispatch(method: str, path: str, query: dict, body: Any):
            try:
                handler, params = router.resolve(method, path)
                raw = b""
                if body is not None:
                    if isinstance(body, (list, str)):
                        # NDJSON bodies (bulk/msearch) arrive as a list of
                        # objects or a raw string from the YAML
                        if isinstance(body, str):
                            raw = body.encode()
                        else:
                            raw = "\n".join(
                                line if isinstance(line, str)
                                else json.dumps(line, default=_jsonable)
                                for line in body
                            ).encode() + b"\n"
                    else:
                        raw = json.dumps(body, default=_jsonable).encode()
                parsed = _parse_body(path, raw) if raw else None
                status, out = handler(node, params, dict(query), parsed)
                if "filter_path" in query and status < 400:
                    from opensearch_tpu_torch.rest.handlers import (
                        apply_filter_path,
                    )

                    out = apply_filter_path(out, query["filter_path"])
                return status, out
            except OpenSearchTpuException as e:
                return e.status, _error_envelope(e)
            except Exception as e:  # noqa: BLE001
                return 500, {"error": {"type": "exception",
                                       "reason": str(e)}, "status": 500}

        return node, dispatch

    return factory


def run_suites(suites: list[str], tmp_root: Path,
               test_dir: Path | None = None,
               device="cuda") -> list[YamlTestResult]:
    test_dir = test_dir or (REFERENCE_SPEC / "test")
    specs = ApiSpecs(REFERENCE_SPEC / "api")
    runner = YamlTestRunner(make_node_factory(tmp_root, device), specs)
    results: list[YamlTestResult] = []
    for suite in suites:
        suite_dir = test_dir / suite
        if not suite_dir.exists():
            continue
        for path in sorted(suite_dir.glob("*.yml")):
            results.extend(runner.run_file(path, suite))
    return results


def summarize(results: list[YamlTestResult]) -> dict:
    by_suite: dict[str, dict] = {}
    for r in results:
        suite = r.suite.split("/")[0]
        s = by_suite.setdefault(
            suite, {"passed": 0, "failed": 0, "skipped": 0}
        )
        s[r.status] += 1
    total = {
        "passed": sum(s["passed"] for s in by_suite.values()),
        "failed": sum(s["failed"] for s in by_suite.values()),
        "skipped": sum(s["skipped"] for s in by_suite.values()),
    }
    run = total["passed"] + total["failed"]
    total["pass_rate"] = round(total["passed"] / run, 4) if run else 0.0
    return {"suites": by_suite, "total": total}
