"""Snapshot/restore: point-in-time backup of indices into repositories.

The analog of server/.../snapshots/ (SnapshotsService.java:157 snapshot
FSM, SnapshotShardsService per-shard uploads, RestoreService restore into
the routing table)."""

from opensearch_tpu_torch.snapshots.service import SnapshotsService

__all__ = ["SnapshotsService"]
