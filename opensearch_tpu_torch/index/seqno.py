"""Sequence-number bookkeeping: local + global checkpoints.

The analog of server/src/main/java/org/opensearch/index/seqno/:

- `LocalCheckpointTracker` (LocalCheckpointTracker.java): tracks which
  sequence numbers have been durably processed on THIS shard copy. The
  local checkpoint is the highest seq_no such that every seq_no at or
  below it has been processed. On the primary (single writer) ops are
  issued and processed in order, so the checkpoint trails max_seq_no by
  zero — but on a replica fed by a real network, ops arrive out of order
  and the checkpoint must hold at the first gap (the reference uses a
  CountedBitSet per 1024-op window; a set of pending seq_nos above the
  checkpoint is the same contract).
- `ReplicationTracker` (ReplicationTracker.java:104): primary-side table
  of in-sync copies and their local checkpoints; the global checkpoint is
  the minimum local checkpoint over the in-sync set — every op at or
  below it is durable on every in-sync copy and can never be rolled back
  by a primary failover.
"""

from __future__ import annotations

NO_OPS_PERFORMED = -1
UNASSIGNED_SEQ_NO = -2


class LocalCheckpointTracker:
    def __init__(self, max_seq_no: int = NO_OPS_PERFORMED,
                 local_checkpoint: int = NO_OPS_PERFORMED):
        if local_checkpoint > max_seq_no:
            raise ValueError(
                f"local_checkpoint {local_checkpoint} > max_seq_no {max_seq_no}"
            )
        self._max_seq_no = max_seq_no
        self._checkpoint = local_checkpoint
        # processed seq_nos strictly above the checkpoint (gap buffer)
        self._pending: set[int] = set()

    # -- issue (primary) ---------------------------------------------------

    def generate_seq_no(self) -> int:
        self._max_seq_no += 1
        return self._max_seq_no

    # -- track (both roles) ------------------------------------------------

    def advance_max_seq_no(self, seq_no: int) -> None:
        """A replica learns of an op with this seq_no (it may not have
        processed everything below it yet)."""
        if seq_no > self._max_seq_no:
            self._max_seq_no = seq_no

    def mark_seq_no_as_processed(self, seq_no: int) -> None:
        """Record that `seq_no` is durably applied here; the checkpoint
        advances over every contiguous processed run starting at
        checkpoint+1 (LocalCheckpointTracker.markSeqNoAsProcessed)."""
        self.advance_max_seq_no(seq_no)
        if seq_no <= self._checkpoint:
            return
        self._pending.add(seq_no)
        while self._checkpoint + 1 in self._pending:
            self._checkpoint += 1
            self._pending.discard(self._checkpoint)

    def fast_forward_processed(self, seq_no: int) -> None:
        """Mark EVERYTHING at or below `seq_no` processed. A point-in-time
        copy (recovery dump / segment snapshot) taken at `seq_no` already
        incorporates every op at or below it — including ops superseded by
        later overwrites or deletes, whose individual seq_nos can never be
        observed again on the copy. Without this jump those holes pin the
        local checkpoint forever and the recovery seqno handoff can never
        complete (the reference seeds a recovering copy's local checkpoint
        from the source commit's maxSeqNo for the same reason)."""
        self.advance_max_seq_no(seq_no)
        if seq_no <= self._checkpoint:
            return
        self._checkpoint = seq_no
        self._pending = {s for s in self._pending if s > seq_no}
        while self._checkpoint + 1 in self._pending:
            self._checkpoint += 1
            self._pending.discard(self._checkpoint)

    def has_processed(self, seq_no: int) -> bool:
        return seq_no <= self._checkpoint or seq_no in self._pending

    @property
    def checkpoint(self) -> int:
        return self._checkpoint

    @property
    def max_seq_no(self) -> int:
        return self._max_seq_no

    @property
    def pending_count(self) -> int:
        """Processed ops above the checkpoint (i.e. sitting after a gap)."""
        return len(self._pending)


class ReplicationTracker:
    """Primary-side in-sync tracking + global checkpoint computation.

    Kept deliberately independent of the transport: the cluster layer
    calls `update_local_checkpoint(allocation_id, ckpt)` whenever a copy
    acks a replicated op (the reference piggybacks this on every
    replication response), and reads `global_checkpoint` back to ship to
    replicas with the next op.
    """

    def __init__(self, primary_allocation_id: str):
        self.primary_allocation_id = primary_allocation_id
        self._local_checkpoints: dict[str, int] = {
            primary_allocation_id: NO_OPS_PERFORMED
        }
        self._in_sync: set[str] = {primary_allocation_id}
        self._global_checkpoint = NO_OPS_PERFORMED

    # -- membership --------------------------------------------------------

    def initiate_tracking(self, allocation_id: str) -> None:
        """A recovering copy starts being tracked (not yet in-sync: it does
        not hold back the global checkpoint until markAllocationIdAsInSync)."""
        self._local_checkpoints.setdefault(allocation_id, NO_OPS_PERFORMED)

    def mark_in_sync(self, allocation_id: str, local_checkpoint: int) -> None:
        """Recovery finished: the copy caught up to the global checkpoint
        and now participates in its computation."""
        self._local_checkpoints[allocation_id] = local_checkpoint
        self._in_sync.add(allocation_id)
        self._recompute()

    def remove_tracking(self, allocation_id: str) -> None:
        self._local_checkpoints.pop(allocation_id, None)
        self._in_sync.discard(allocation_id)
        self._recompute()

    # -- checkpoints -------------------------------------------------------

    def update_local_checkpoint(self, allocation_id: str, checkpoint: int) -> None:
        prev = self._local_checkpoints.get(allocation_id, NO_OPS_PERFORMED)
        if checkpoint > prev:
            self._local_checkpoints[allocation_id] = checkpoint
            self._recompute()

    def _recompute(self) -> None:
        if not self._in_sync:
            return
        gc = min(self._local_checkpoints.get(a, NO_OPS_PERFORMED)
                 for a in self._in_sync)
        # monotonic: the global checkpoint never moves backwards, even if
        # membership changes drop the minimum (ReplicationTracker invariant)
        if gc > self._global_checkpoint:
            self._global_checkpoint = gc

    @property
    def global_checkpoint(self) -> int:
        return self._global_checkpoint

    @property
    def in_sync_ids(self) -> set[str]:
        return set(self._in_sync)

    def local_checkpoint_of(self, allocation_id: str) -> int:
        return self._local_checkpoints.get(allocation_id, UNASSIGNED_SEQ_NO)


class RetentionLease:
    """One retained history interval (RetentionLease.java): ops at or above
    `retaining_seq_no` must stay replayable for the lease holder."""

    __slots__ = ("id", "retaining_seq_no", "timestamp_ms", "source")

    def __init__(self, lease_id: str, retaining_seq_no: int,
                 timestamp_ms: int, source: str = "peer recovery"):
        self.id = lease_id
        self.retaining_seq_no = retaining_seq_no
        self.timestamp_ms = timestamp_ms
        self.source = source

    def to_dict(self) -> dict:
        return {"id": self.id, "retaining_seq_no": self.retaining_seq_no,
                "timestamp": self.timestamp_ms, "source": self.source}


class RetentionLeases:
    """The shard's lease collection (ReplicationTracker.retentionLeases,
    ReplicationTracker.java:104): peer-recovery leases keep translog
    history alive so a returning replica can recover by OPS REPLAY instead
    of a full segment copy. Versioned so copies can reconcile."""

    # leases older than this expire unless renewed (the reference's
    # index.soft_deletes.retention_lease.period default, 12h)
    DEFAULT_RETENTION_MS = 12 * 3600 * 1000

    def __init__(self):
        self._leases: dict[str, RetentionLease] = {}
        self.version = 0
        self.primary_term = 1

    def add_or_renew(self, lease_id: str, retaining_seq_no: int,
                     now_ms: int, source: str = "peer recovery") -> RetentionLease:
        existing = self._leases.get(lease_id)
        if existing is not None:
            # renewal never moves the retained point backwards
            retaining_seq_no = max(retaining_seq_no,
                                   existing.retaining_seq_no)
        lease = RetentionLease(lease_id, retaining_seq_no, now_ms, source)
        self._leases[lease_id] = lease
        self.version += 1
        return lease

    def remove(self, lease_id: str) -> None:
        if self._leases.pop(lease_id, None) is not None:
            self.version += 1

    def get(self, lease_id: str) -> RetentionLease | None:
        return self._leases.get(lease_id)

    def expire(self, now_ms: int,
               retention_ms: int = DEFAULT_RETENTION_MS) -> list[str]:
        """Drop leases whose holder has not renewed within the retention
        period; returns the expired ids."""
        expired = [lid for lid, l in self._leases.items()
                   if now_ms - l.timestamp_ms > retention_ms]
        for lid in expired:
            del self._leases[lid]
        if expired:
            self.version += 1
        return expired

    def min_retained_seq_no(self) -> int | None:
        """The lowest seq_no any lease still needs, or None (no leases —
        history may be trimmed freely)."""
        if not self._leases:
            return None
        return min(l.retaining_seq_no for l in self._leases.values())

    def covers(self, from_seq_no: int) -> bool:
        """True if retained history includes every op >= from_seq_no."""
        m = self.min_retained_seq_no()
        return m is not None and m <= from_seq_no

    def leases(self) -> list[RetentionLease]:
        return sorted(self._leases.values(), key=lambda l: l.id)

    def to_dict(self) -> dict:
        return {"version": self.version,
                "primary_term": self.primary_term,
                "leases": [l.to_dict() for l in self.leases()]}

    @classmethod
    def from_dict(cls, d: dict) -> "RetentionLeases":
        out = cls()
        out.version = int(d.get("version", 0))
        out.primary_term = int(d.get("primary_term", 1))
        for l in d.get("leases", []):
            out._leases[l["id"]] = RetentionLease(
                l["id"], int(l["retaining_seq_no"]),
                int(l.get("timestamp", 0)),
                l.get("source", "peer recovery"),
            )
        return out
