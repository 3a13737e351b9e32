"""IngestDocument: the mutable doc view processors operate on.

The analog of the reference's IngestDocument (server/.../ingest/
IngestDocument.java): dot-path field access over _source plus addressable
metadata (_index, _id, _routing) and the ephemeral _ingest namespace
(timestamp, foreach _value)."""

from __future__ import annotations

import datetime as _dt
from typing import Any

from opensearch_tpu_torch.common.errors import IllegalArgumentException

_MISSING = object()

METADATA_FIELDS = ("_index", "_id", "_routing")


class IngestDocument:
    def __init__(self, index: str, doc_id: str | None, source: dict,
                 routing: str | None = None):
        self.source = source
        self.meta: dict[str, Any] = {
            "_index": index, "_id": doc_id, "_routing": routing,
        }
        self.ingest_meta: dict[str, Any] = {
            "timestamp": _dt.datetime.now(_dt.timezone.utc)
            .isoformat().replace("+00:00", "Z"),
        }

    # -- path resolution ----------------------------------------------------

    def _root_for(self, path: str) -> tuple[Any, list[str]]:
        parts = path.split(".")
        if parts[0] == "_ingest":
            return self.ingest_meta, parts[1:]
        if parts[0] == "_source":
            parts = parts[1:]
        elif parts[0] in METADATA_FIELDS and len(parts) == 1:
            return self.meta, parts
        return self.source, parts

    def get(self, path: str, default: Any = _MISSING) -> Any:
        node, parts = self._root_for(path)
        for p in parts:
            if isinstance(node, dict):
                if p not in node:
                    node = _MISSING
                    break
                node = node[p]
            elif isinstance(node, list):
                try:
                    node = node[int(p)]
                except (ValueError, IndexError):
                    node = _MISSING
                    break
            else:
                node = _MISSING
                break
        if node is _MISSING:
            if default is _MISSING:
                raise IllegalArgumentException(
                    f"field [{path}] not present as part of path [{path}]"
                )
            return default
        return node

    def has(self, path: str) -> bool:
        return self.get(path, default=None) is not None or self._has_null(path)

    def _has_null(self, path: str) -> bool:
        sentinel = object()
        return self.get(path, default=sentinel) is not sentinel

    def set(self, path: str, value: Any) -> None:
        node, parts = self._root_for(path)
        if node is self.meta:
            self.meta[parts[0]] = value
            return
        for p in parts[:-1]:
            if isinstance(node, list):
                node = node[int(p)]
                continue
            if not isinstance(node, dict):
                raise IllegalArgumentException(
                    f"cannot set [{path}]: [{p}] is not an object"
                )
            nxt = node.get(p)
            if nxt is None:
                nxt = {}
                node[p] = nxt
            node = nxt
        last = parts[-1]
        if isinstance(node, list):
            node[int(last)] = value
        elif isinstance(node, dict):
            node[last] = value
        else:
            raise IllegalArgumentException(
                f"cannot set [{path}]: parent is not an object"
            )

    def remove(self, path: str, ignore_missing: bool = False) -> None:
        node, parts = self._root_for(path)
        for p in parts[:-1]:
            if isinstance(node, dict):
                node = node.get(p)
            elif isinstance(node, list):
                try:
                    node = node[int(p)]
                except (ValueError, IndexError):
                    node = None
            else:
                node = None
            if node is None:
                break
        last = parts[-1]
        if isinstance(node, dict) and last in node:
            del node[last]
            return
        if isinstance(node, list):
            try:
                del node[int(last)]
                return
            except (ValueError, IndexError):
                pass
        if not ignore_missing:
            raise IllegalArgumentException(
                f"field [{path}] not present as part of path [{path}]"
            )

    def append(self, path: str, value: Any, allow_duplicates: bool = True) -> None:
        cur = self.get(path, default=None)
        items = value if isinstance(value, list) else [value]
        if cur is None:
            self.set(path, list(items))
            return
        if not isinstance(cur, list):
            cur = [cur]
            self.set(path, cur)
        for item in items:
            if allow_duplicates or item not in cur:
                cur.append(item)

    # -- script / template views --------------------------------------------

    def ctx(self) -> dict:
        """Script context: _source IS ctx, with metadata keys injected
        (UpdateHelper/IngestScript semantics — mutations to nested fields
        land in the real source)."""
        view = self.source
        view["_index"] = self.meta["_index"]
        view["_id"] = self.meta["_id"]
        view["_ingest"] = self.ingest_meta
        return view

    def finish_ctx(self) -> None:
        """Re-absorb metadata mutations made through ctx and strip the
        injected keys back out of _source."""
        for key in METADATA_FIELDS:
            if key in self.source:
                self.meta[key] = self.source.pop(key)
        self.source.pop("_ingest", None)

    def render(self, template: Any) -> Any:
        """Resolve {{field}} / {{{field}}} mustache-lite references."""
        if not isinstance(template, str) or "{{" not in template:
            return template
        import re

        def sub(m):
            path = m.group(1) or m.group(2)
            v = self.get(path.strip(), default="")
            return "" if v is None else str(v)

        return re.sub(r"\{\{\{([^}]+)\}\}\}|\{\{([^}]+)\}\}", sub, template)
