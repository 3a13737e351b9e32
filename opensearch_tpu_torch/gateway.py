"""Gateway: node-local durable cluster state.

The analog of the reference's GatewayMetaState / PersistedClusterStateService
(server/src/main/java/org/opensearch/gateway/PersistedClusterStateService.java:137
— cluster state stored durably on every cluster-manager-eligible node,
recovered behind a quorum barrier by GatewayService on full-cluster restart).

The reference persists into a local Lucene index with incremental writes of
changed IndexMetadata; here the state is small structured metadata, so the
store is one atomic JSON document per save: write to a temp file, fsync,
rename over the live file (rename is atomic on POSIX), fsync the directory.
Every save is write-ahead with respect to the coordination state machine:
CoordinationState persists the term BEFORE a vote leaves the node and the
accepted state BEFORE the publish ack — a crash between the two cannot
produce a double vote or a regressed accept.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from opensearch_tpu_torch.cluster.state import ClusterState

STATE_FILE = "cluster_state.json"


class GatewayStore:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.saves = 0

    @property
    def _live(self) -> Path:
        return self.path / STATE_FILE

    def save(self, term: int, state: ClusterState) -> None:
        doc = {"current_term": term, "accepted_state": state.to_dict()}
        tmp = self.path / f".{STATE_FILE}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._live)
        dir_fd = os.open(self.path, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        self.saves += 1

    def load(self) -> tuple[int, ClusterState] | None:
        if not self._live.exists():
            return None
        with open(self._live) as f:
            doc = json.load(f)
        return int(doc["current_term"]), ClusterState.from_dict(
            doc["accepted_state"]
        )
