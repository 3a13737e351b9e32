"""Search templates: a from-scratch mustache subset.

The analog of the reference's lang-mustache module
(modules/lang-mustache — MustacheScriptEngine, RestSearchTemplateAction,
RestRenderSearchTemplateAction): templates are strings (or JSON trees
serialized to strings) with {{...}} placeholders, rendered against params
and parsed back to the search body.

Supported syntax (the subset the reference's own tests exercise):
- {{var}} / {{a.b}}      dotted lookups, HTML-escape-free (mustache
                         escaping is meaningless inside JSON)
- {{#toJson}}v{{/toJson}} JSON-encode a param (arrays/objects)
- {{#join}}v{{/join}}     comma-join an array param
- {{#section}}..{{/section}} render when truthy; iterate when a list
- {{^section}}..{{/section}} inverted section
- {{var}}{{^var}}default{{/var}} idiom works through the above
"""

from __future__ import annotations

import json
import re
from typing import Any

from opensearch_tpu_torch.common.errors import IllegalArgumentException

_TAG = re.compile(r"\{\{\s*([#^/]?)\s*([^}]+?)\s*\}\}")


def _lookup(params: Any, path: str) -> Any:
    if path == ".":
        return params
    cur = params
    for part in path.split("."):
        if isinstance(cur, dict):
            cur = cur.get(part)
        elif isinstance(cur, list) and part.isdigit():
            cur = cur[int(part)] if int(part) < len(cur) else None
        else:
            return None
        if cur is None:
            return None
    return cur


def _stringify(v: Any) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (dict, list)):
        return json.dumps(v)
    return str(v)


def render(template: str, params: dict | None) -> str:
    """Render a mustache template string against params."""
    params = params or {}
    out, _pos = _render_block(template, 0, None, params)
    return out


def _render_block(
    tpl: str, pos: int, until: str | None, params: Any
) -> tuple[str, int]:
    """Render until the closing tag `until` (None = end of string).
    Returns (rendered, position after the closing tag)."""
    parts: list[str] = []
    while True:
        m = _TAG.search(tpl, pos)
        if m is None:
            if until is not None:
                raise IllegalArgumentException(
                    f"unclosed mustache section [{until}]"
                )
            parts.append(tpl[pos:])
            return "".join(parts), len(tpl)
        parts.append(tpl[pos: m.start()])
        kind, name = m.group(1), m.group(2)
        pos = m.end()
        if kind == "/":
            if name != until:
                raise IllegalArgumentException(
                    f"mismatched mustache close [{name}], expected [{until}]"
                )
            return "".join(parts), pos
        if kind == "":
            parts.append(_stringify(_lookup(params, name)))
            continue
        # section start: find and render the body
        if name == "toJson":
            body, pos = _render_block(tpl, pos, name, params)
            parts.append(json.dumps(_lookup(params, body.strip())))
            continue
        if name == "join":
            body, pos = _render_block(tpl, pos, name, params)
            v = _lookup(params, body.strip())
            parts.append(",".join(_stringify(x) for x in (v or [])))
            continue
        value = _lookup(params, name)
        if kind == "#":
            if isinstance(value, list):
                # render the body once per element with the element as ctx
                body_start = pos
                rendered, pos = _render_block(tpl, body_start, name, params)
                for item in value:
                    r, _ = _render_block(tpl, body_start, name, item)
                    parts.append(r)
                # drop the params-rendered probe (only used to locate pos)
                _ = rendered
            elif value:
                ctx = value if isinstance(value, dict) else params
                rendered, pos = _render_block(tpl, pos, name, ctx)
                parts.append(rendered)
            else:
                _, pos = _render_block(tpl, pos, name, params)
        else:  # "^" inverted
            if not value or value == []:
                rendered, pos = _render_block(tpl, pos, name, params)
                parts.append(rendered)
            else:
                _, pos = _render_block(tpl, pos, name, params)


def render_search_template(source: Any, params: dict | None) -> dict:
    """Template source (string or JSON tree) -> rendered search body."""
    if isinstance(source, dict):
        source = json.dumps(source)
    rendered = render(str(source), params)
    try:
        return json.loads(rendered)
    except json.JSONDecodeError as e:
        raise IllegalArgumentException(
            f"rendered template is not valid JSON: {e}: {rendered[:200]}"
        ) from e
