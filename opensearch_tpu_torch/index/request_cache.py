"""Indices request cache: search-response caching keyed by reader generation.

Counterpart of opensearch_tpu/index/request_cache.py, a copy with its
imports rewritten (the reference's IndicesRequestCache). Results are
cached by (reader generations, request bytes), so a refresh that changes
a reader invalidates by moving its generation. Only ``size: 0`` requests
are cached by default, as in the reference; the ``request_cache`` request
parameter and ``index.requests.cache.enable`` are honoured.

One LRU a node, evicted by the serialized response's byte length against
``indices.requests.cache.size``, with a max-entry-count backstop.
Responses enter the cache as JSON strings.
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import OrderedDict
from typing import Any

from opensearch_tpu_torch.common.settings import Property, Setting, parse_bytes

DEFAULT_MAX_ENTRIES = 1024
DEFAULT_MAX_BYTES = 64 << 20  # 64mb — the fixed stand-in for 1% of heap

CACHE_SIZE_SETTING: Setting[int] = Setting(
    "indices.requests.cache.size", DEFAULT_MAX_BYTES, parse_bytes,
    Property.NODE_SCOPE, Property.DYNAMIC,
)


def _entry_bytes(value: Any) -> int:
    """Approximate response size: cached values are JSON strings (the node
    caches the serialized response), so len() is the payload size; anything
    else falls back to a serialization-length estimate."""
    if isinstance(value, (str, bytes)):
        return len(value)
    try:
        return len(json.dumps(value, default=str))
    except (TypeError, ValueError):
        return 1024  # unserializable: charge a nominal block


class RequestCache:
    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES,
                 max_bytes: int = DEFAULT_MAX_BYTES):
        self.max_entries = max_entries
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, Any] = OrderedDict()
        self._sizes: dict[tuple, int] = {}
        self._total_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def cacheable(body: dict | None, request_cache: bool | None) -> bool:
        """IndicesService.canCache: only size=0 requests by default; an
        explicit request_cache=true opts any request in, =false opts out."""
        body = body or {}
        if request_cache is False:
            return False
        if body.get("profile"):
            return False
        # scroll/PIT callers never reach the cache (their pinned snapshots
        # bypass shard-level caching by construction)
        if request_cache is True:
            return True
        return int(body.get("size", 10)) == 0

    @staticmethod
    def key(names, shard_keys: list, generations: list[int],
            body: dict | None) -> tuple:
        blob = json.dumps(body or {}, sort_keys=True, default=str)
        digest = hashlib.sha1(blob.encode()).hexdigest()
        return (tuple(names), tuple(map(tuple, shard_keys)),
                tuple(generations), digest)

    def set_max_bytes(self, max_bytes: int) -> None:
        with self._lock:
            self.max_bytes = int(max_bytes)
            self._evict_over_budget()

    def get(self, key: tuple):
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return self._entries[key]
            self.misses += 1
            return None

    def put(self, key: tuple, value: Any) -> None:
        size = _entry_bytes(value)
        with self._lock:
            if size > self.max_bytes:
                return  # larger than the whole budget: never cacheable
            old = self._sizes.pop(key, None)
            if old is not None:
                self._total_bytes -= old
            self._entries[key] = value
            self._entries.move_to_end(key)
            self._sizes[key] = size
            self._total_bytes += size
            self._evict_over_budget()

    def _evict_over_budget(self) -> None:
        """LRU eviction to the byte budget (entry count as a backstop).
        Every caller holds self._lock — the lexical lock-discipline scan
        can't see a caller-held lock, hence the line suppressions."""
        while self._entries and (
            self._total_bytes > self.max_bytes  # tpulint: disable=TPU003
            or len(self._entries) > self.max_entries
        ):
            victim, _v = self._entries.popitem(last=False)  # tpulint: disable=TPU003
            self._total_bytes -= self._sizes.pop(victim, 0)  # tpulint: disable=TPU003
            self.evictions += 1

    def clear(self, index: str | None = None) -> int:
        with self._lock:
            if index is None:
                n = len(self._entries)
                self._entries.clear()
                self._sizes.clear()
                self._total_bytes = 0
                return n
            victims = [k for k in self._entries
                       if index in k[0]
                       or any(sk[0] == index for sk in k[1])]
            for k in victims:
                del self._entries[k]
                self._total_bytes -= self._sizes.pop(k, 0)
            return len(victims)

    def stats(self) -> dict:
        with self._lock:
            return {
                "memory_size_in_bytes": self._total_bytes,
                "max_size_in_bytes": self.max_bytes,
                "evictions": self.evictions,
                "hit_count": self.hits,
                "miss_count": self.misses,
                "entries": len(self._entries),
            }
