"""IndexShard: the per-shard state machine gluing engine + search.

The analog of server/src/main/java/org/opensearch/index/shard/IndexShard.java
(:271): owns one Engine, exposes the primary/replica operation entry points
(applyIndexOperationOnPrimary:1109 / OnReplica:1135), refresh scheduling and
shard-level stats. Replication fan-out lives above (cluster layer); replicas
replay ops through `apply_on_replica` with the primary's seq_no, and the
segment-replication path ships sealed HostSegments instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import torch

from opensearch_tpu_torch.index.engine import Engine, OpResult, SearcherSnapshot
from opensearch_tpu_torch.index.mapper import MapperService


def translog_durability(settings: dict) -> str:
    """Resolve + validate index.translog.durability from index settings
    (flat `translog.durability` or nested `translog: {durability}` forms).
    Raises on unknown values — a typo must not silently downgrade acked
    writes to no-fsync (Translog.Durability enum validation)."""
    from opensearch_tpu_torch.common.errors import IllegalArgumentException

    settings = settings or {}
    tl = settings.get("translog")
    value = str(
        settings.get("translog.durability")
        or settings.get("index.translog.durability")
        or (tl.get("durability") if isinstance(tl, dict) else None)
        or "request"
    ).lower()
    if value not in ("request", "async"):
        raise IllegalArgumentException(
            f"unknown value [{value}] for [index.translog.durability], "
            "must be one of [request, async]"
        )
    return value


def replication_type(settings: dict) -> str:
    """index.replication.type: DOCUMENT (logical re-execution on replicas,
    the default) or SEGMENT (replicas consume sealed segment bundles
    published by the primary — indices/replication/ in the reference)."""
    from opensearch_tpu_torch.common.errors import IllegalArgumentException

    settings = settings or {}
    rep = settings.get("replication")
    value = str(
        settings.get("replication.type")
        or settings.get("index.replication.type")
        or (rep.get("type") if isinstance(rep, dict) else None)
        or "DOCUMENT"
    ).upper()
    if value not in ("DOCUMENT", "SEGMENT"):
        raise IllegalArgumentException(
            f"unknown value [{value}] for [index.replication.type], "
            "must be one of [DOCUMENT, SEGMENT]"
        )
    return value


@dataclass(frozen=True)
class ShardId:
    index: str
    shard: int

    def __str__(self) -> str:
        return f"[{self.index}][{self.shard}]"


class IndexShard:
    def __init__(self, shard_id: ShardId, path: Path, mapper_service: MapperService,
                 durability: str = "request", replication: str = "DOCUMENT",
                 device: torch.device | str = "cuda"):
        self.shard_id = shard_id
        self.mapper_service = mapper_service
        self.engine = Engine(path, mapper_service, durability=durability,
                             device=device)
        self.primary = True
        self.replication = replication
        # peer-recovery bookkeeping (IndexShard.recoveryState analog, read
        # by the cluster layer): `recovery_done` gates shard-started
        # re-reports; `recovery_inflight` suppresses duplicate drivers
        self.recovery_done = False
        self.recovery_inflight = False

    # -- write ops ---------------------------------------------------------

    def apply_index_on_primary(
        self, doc_id: str, source: dict, routing: str | None = None,
        if_seq_no: int | None = None, version: int | None = None,
        version_type: str = "internal",
    ) -> OpResult:
        return self.engine.index(doc_id, source, routing, if_seq_no=if_seq_no,
                                 version=version, version_type=version_type)

    def apply_index_on_replica(
        self, doc_id: str, source: dict, seq_no: int, routing: str | None = None
    ) -> OpResult:
        return self.engine.index(doc_id, source, routing, seq_no=seq_no)

    def apply_delete_on_primary(self, doc_id: str,
                                if_seq_no: int | None = None,
                                version: int | None = None,
                                version_type: str = "internal") -> OpResult:
        return self.engine.delete(doc_id, if_seq_no=if_seq_no,
                                  version=version, version_type=version_type)

    def apply_delete_on_replica(self, doc_id: str, seq_no: int) -> OpResult:
        return self.engine.delete(doc_id, seq_no=seq_no)

    # -- read ops ----------------------------------------------------------

    def get(self, doc_id: str, realtime: bool = True) -> dict | None:
        return self.engine.get(doc_id, realtime=realtime)

    def acquire_searcher(self) -> SearcherSnapshot:
        return self.engine.acquire_searcher()

    def maybe_sync_translog(self) -> None:
        """Fsync once per request before the ack when durability=request
        (IndexShard.maybeSyncTranslog / TransportWriteAction's async-after
        action); async durability defers to the refresh-interval timer."""
        if self.engine.durability == "request":
            self.engine.ensure_synced()

    def refresh(self) -> None:
        self.engine.refresh()

    def flush(self) -> None:
        self.engine.flush()

    @property
    def num_docs(self) -> int:
        return self.engine.num_docs

    def stats(self) -> dict:
        return {
            "docs": {"count": self.engine.num_docs},
            "indexing": {
                "index_total": self.engine.stats["index_total"],
                "delete_total": self.engine.stats["delete_total"],
                "index_time_in_millis": int(self.engine.stats["index_time_ms"]),
            },
            "refresh": {"total": self.engine.stats["refresh_total"]},
            "flush": {"total": self.engine.stats["flush_total"]},
            "segments": self.engine.segment_stats(),
            "translog": self.engine.translog.stats(),
            "seq_no": {
                "max_seq_no": self.engine.max_seq_no,
                "local_checkpoint": self.engine.local_checkpoint,
                "global_checkpoint": self.engine.local_checkpoint,
            },
        }

    def close(self) -> None:
        self.engine.close()
