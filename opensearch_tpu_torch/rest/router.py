"""REST route registry: method + path-template dispatch.

A copy of opensearch_tpu/rest/router.py. The analog of the reference's RestController trie router
(server/src/main/java/org/opensearch/rest/RestController.java:93,
dispatchRequest:285 + MethodHandlers): handlers register
(method, "/{index}/_doc/{id}") templates; dispatch extracts path params and
returns (handler, params). Wildcards bind single path segments; literal
segments always win over placeholders (the reference's trie behaves the
same, so /_cat/indices beats /{index}).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from opensearch_tpu_torch.common.errors import OpenSearchTpuException


class NoHandlerException(OpenSearchTpuException):
    status = 400
    error_type = "invalid_request"


class MethodNotAllowedException(OpenSearchTpuException):
    status = 405
    error_type = "method_not_allowed"


Handler = Callable[..., Any]


@dataclass
class _TrieNode:
    children: dict[str, "_TrieNode"] = field(default_factory=dict)
    wildcard: "_TrieNode | None" = None
    wildcard_name: str = ""
    handlers: dict[str, Handler] = field(default_factory=dict)   # method -> handler


class Router:
    def __init__(self) -> None:
        self.root = _TrieNode()

    def register(self, method: str, template: str, handler: Handler) -> None:
        node = self.root
        for seg in template.strip("/").split("/"):
            if not seg:
                continue
            if seg.startswith("{") and seg.endswith("}"):
                name = seg[1:-1]
                if node.wildcard is None:
                    node.wildcard = _TrieNode()
                    node.wildcard_name = name
                elif node.wildcard_name != name:
                    # same position reused with a different name is fine;
                    # first registration wins for naming
                    pass
                node = node.wildcard
            else:
                node = node.children.setdefault(seg, _TrieNode())
        if method in node.handlers:
            raise ValueError(f"duplicate route {method} {template}")
        node.handlers[method] = handler

    def resolve(self, method: str, path: str) -> tuple[Handler, dict[str, str]]:
        segments = [s for s in path.strip("/").split("/") if s]
        matches: list[tuple[_TrieNode, dict[str, str]]] = []

        def walk(node: _TrieNode, idx: int, params: dict[str, str]) -> None:
            if idx == len(segments):
                if node.handlers:
                    matches.append((node, params))
                return
            seg = segments[idx]
            child = node.children.get(seg)
            if child is not None:
                walk(child, idx + 1, params)
            if node.wildcard is not None:
                from urllib.parse import unquote

                walk(node.wildcard, idx + 1,
                     {**params, node.wildcard_name: unquote(seg)})

        walk(self.root, 0, {})
        if not matches:
            raise NoHandlerException(
                f"no handler found for uri [/{'/'.join(segments)}] and method [{method}]"
            )
        # literal-over-wildcard preference: walk() visits literal paths first,
        # so the first match with the method wins
        for node, params in matches:
            if method in node.handlers:
                return node.handlers[method], params
        if method == "HEAD":
            # HEAD falls back to GET with body suppressed by the server
            for node, params in matches:
                if "GET" in node.handlers:
                    return node.handlers["GET"], params
        allowed = sorted({m for node, _ in matches for m in node.handlers})
        raise MethodNotAllowedException(
            f"Incorrect HTTP method for uri [{path}], allowed: {allowed}"
        )
