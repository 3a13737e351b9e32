"""Slow logs: search + indexing threshold loggers.

Counterpart of opensearch_tpu/telemetry/slowlog.py, a host-only copy. The
analog of index/SearchSlowLog.java + IndexingSlowLog.java (SURVEY.md
§5): operations slower than configured thresholds are logged at the
matching level and retained in a bounded ring for the stats surface.
Thresholds are dynamic settings (index.search.slowlog.threshold.query.*,
index.indexing.slowlog.threshold.index.*); -1 disables a level.
"""

from __future__ import annotations

import logging
import threading
from collections import deque

logger = logging.getLogger("opensearch_tpu_torch_torch.slowlog")

LEVELS = ("warn", "info", "debug", "trace")
_LOG_FN = {
    "warn": logger.warning, "info": logger.info,
    "debug": logger.debug, "trace": logger.debug,
}


class SlowLog:
    def __init__(self, kind: str, max_entries: int = 512):
        self.kind = kind  # "search" | "indexing"
        # ms thresholds per level; -1 = disabled (reference defaults)
        self.thresholds: dict[str, int] = {lvl: -1 for lvl in LEVELS}
        self._ring: deque[dict] = deque(maxlen=max_entries)
        self._lock = threading.Lock()

    def configure(self, settings: dict) -> None:
        """Accepts {'warn': '500ms'|500, ...} or flat setting suffixes."""
        from opensearch_tpu_torch.common.timeutil import parse_time_value_millis

        for lvl in LEVELS:
            if lvl in settings:
                v = settings[lvl]
                if v in (-1, "-1", None):
                    self.thresholds[lvl] = -1
                elif isinstance(v, (int, float)):
                    self.thresholds[lvl] = int(v)
                else:
                    self.thresholds[lvl] = parse_time_value_millis(
                        v, f"slowlog.{lvl}"
                    )

    def maybe_log(self, took_ms: float, index: str, detail: str) -> str | None:
        """Returns the level logged at, or None."""
        for lvl in LEVELS:  # warn first: log at the most severe crossing
            threshold = self.thresholds[lvl]
            if threshold >= 0 and took_ms >= threshold:
                entry = {
                    "level": lvl, "took_ms": round(took_ms, 2),
                    "index": index, "detail": detail[:1000],
                }
                # correlate the slow operation with its distributed trace:
                # a slowlog line names WHAT was slow, the trace tree (spans
                # ring / _nodes/stats) shows WHERE the time went
                from opensearch_tpu_torch.telemetry.tracing import (
                    current_trace_context,
                )

                ctx = current_trace_context()
                if ctx is not None:
                    entry["trace_id"] = ctx["trace_id"]
                with self._lock:
                    self._ring.append(entry)
                _LOG_FN[lvl](
                    "[%s slowlog] [%s] took[%sms] %s",
                    self.kind, index, round(took_ms, 1), entry["detail"],
                )
                return lvl
        return None

    def entries(self) -> list[dict]:
        with self._lock:
            return list(self._ring)
