"""The per-shard engine: write path kernel + NRT reader publication.

The analog of InternalEngine
(server/src/main/java/org/opensearch/index/engine/InternalEngine.java:152):

- index/delete ops get a sequence number and a version plan from the live
  version map (dedup + conflict detection, `LiveVersionMap`), are buffered
  in RAM and appended to the translog before being acknowledged
  (InternalEngine.index:863 → indexIntoLucene:1138 + Translog.add:606)
- `refresh` seals the RAM buffer into an immutable HostSegment, publishes
  its padded tensors to the engine's device, and swaps the searcher
  snapshot (the NRT reader model); deletes republish the affected
  segments' live bitmaps
- `flush` = persist segments + a commit point, then roll/trim the translog
  (Lucene commit + CombinedDeletionPolicy analog)
- crash recovery = load last commit, replay translog ops with
  seq_no > commit max_seq_no (TranslogRecoveryRunner)

Searcher snapshots are immutable lists of (host, device) segment pairs —
holding one is the PIT/scroll `ReaderContext` refcount analog.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field as dc_field
from pathlib import Path

import torch

from opensearch_tpu_torch.common.errors import (
    OpenSearchTpuException,
    VersionConflictException,
)
from opensearch_tpu_torch.index.device import DeviceSegment, to_device
from opensearch_tpu_torch.index.mapper import MapperService, ParsedDocument
from opensearch_tpu_torch.index.segment import (
    HostSegment,
    SegmentBuilder,
    load_segment,
    save_segment,
)
from opensearch_tpu_torch.index.seqno import LocalCheckpointTracker
from opensearch_tpu_torch.index.translog import Translog


@dataclass
class OpResult:
    doc_id: str
    seq_no: int
    version: int
    created: bool = False
    found: bool = True
    result: str = "created"   # created | updated | deleted | not_found


@dataclass
class VersionEntry:
    seq_no: int
    version: int
    deleted: bool = False


@dataclass
class SearcherSnapshot:
    """Immutable point-in-time view over sealed segments + live masks."""

    segments: list[tuple[HostSegment, DeviceSegment]]
    generation: int

    @property
    def num_docs(self) -> int:
        return sum(h.live_count for h, _ in self.segments)

    @property
    def max_doc(self) -> int:
        return sum(h.n_docs for h, _ in self.segments)


_ENGINE_SEQ = 0


class Engine:
    def __init__(self, path: str | Path, mapper_service: MapperService,
                 durability: str = "request",
                 device: torch.device | str = "cuda"):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.mapper_service = mapper_service
        # every segment this engine publishes goes to this device
        self.device = torch.device(device)
        self.translog = Translog(self.path / "translog")
        # "request" = fsync once per request before ack (the reference's
        # index.translog.durability=REQUEST — TransportWriteAction syncs at
        # the end of the shard bulk, NOT per op); "async" = fsync only on
        # refresh/flush (the sync_interval timer analog)
        self.durability = durability
        self.version_map: dict[str, VersionEntry] = {}
        # process-unique engine identity: cache layers (e.g. the distributed
        # serving bundles) key on it so a deleted+recreated index can never
        # alias a stale cache entry
        global _ENGINE_SEQ
        _ENGINE_SEQ += 1
        self.instance_id = _ENGINE_SEQ
        self._segment_counter = 0
        self._segments: list[tuple[HostSegment, DeviceSegment]] = []
        self._buffer: list[tuple[ParsedDocument, int] | None] = []
        self._buffer_pos: dict[str, int] = {}
        self._refresh_generation = 0
        import uuid as _uuid

        # identity that survives neither delete/recreate nor restart —
        # request-cache keys embed it so recreated indices never collide
        self.engine_uuid = _uuid.uuid4().hex
        self._searcher = SearcherSnapshot([], 0)
        self._dirty_live: set[str] = set()  # segment names needing live republish
        # gap-tracking checkpoint machinery (LocalCheckpointTracker.java):
        # on the primary ops issue+process in order; on a replica fed by a
        # real transport they arrive out of order and the checkpoint must
        # hold at the first unprocessed seq_no
        self.tracker = LocalCheckpointTracker()
        # peer-recovery retention leases (ReplicationTracker.java:104):
        # flush-time translog trimming honors the leased floor so a
        # returning replica can recover by ops replay, not segment copy
        from opensearch_tpu_torch.index.seqno import RetentionLeases

        self.retention_leases = RetentionLeases()
        self._sync_needed = False
        self.stats = {"index_total": 0, "delete_total": 0, "refresh_total": 0,
                      "flush_total": 0, "index_time_ms": 0.0}
        self._recover()

    # -- sequence numbers --------------------------------------------------

    @property
    def max_seq_no(self) -> int:
        return self.tracker.max_seq_no

    @property
    def local_checkpoint(self) -> int:
        return self.tracker.checkpoint

    # -- durability --------------------------------------------------------

    def ensure_synced(self) -> None:
        """Fsync the translog once per REQUEST (possibly covering many ops
        — Translog.java:606 + TransportWriteAction's AsyncAfterWriteAction).
        No-op when nothing was appended since the last sync."""
        if self._sync_needed:
            self.translog.sync()
            self._sync_needed = False

    # -- write path --------------------------------------------------------

    def _check_version(self, doc_id: str, entry, version: int | None,
                       version_type: str) -> None:
        """VersionType.isVersionConflictForWrites semantics."""
        if version is None:
            return
        current = entry.version if entry is not None and not entry.deleted \
            else None
        if version_type == "external":
            if current is not None and version <= current:
                raise VersionConflictException(
                    f"[{doc_id}]: version conflict, current version "
                    f"[{current}] is higher or equal to the one provided "
                    f"[{version}]"
                )
        elif version_type == "external_gte":
            if current is not None and version < current:
                raise VersionConflictException(
                    f"[{doc_id}]: version conflict, current version "
                    f"[{current}] is higher than the one provided "
                    f"[{version}]"
                )
        else:  # internal CAS
            if current is None or current != version:
                raise VersionConflictException(
                    f"[{doc_id}]: version conflict, current version "
                    f"[{current if current is not None else -1}] is "
                    f"different than the one provided [{version}]"
                )

    def index(
        self,
        doc_id: str,
        source: dict,
        routing: str | None = None,
        if_seq_no: int | None = None,
        if_primary_term: int | None = None,
        seq_no: int | None = None,
        version: int | None = None,
        version_type: str = "internal",
    ) -> OpResult:
        """Index one document (InternalEngine.index:863). `seq_no` is set
        only on the replica/recovery replay path."""
        t0 = time.monotonic()
        entry = self.version_map.get(doc_id)
        if if_seq_no is not None:
            current_seq = entry.seq_no if entry and not entry.deleted else -1
            if current_seq != if_seq_no:
                raise VersionConflictException(
                    f"[{doc_id}]: version conflict, required seqNo [{if_seq_no}], "
                    f"current document has seqNo [{current_seq}]"
                )
        self._check_version(doc_id, entry, version, version_type)
        if seq_no is not None and entry is not None and entry.seq_no >= seq_no:
            # stale op on the replica/replay path: a newer op for this doc
            # already applied (reference: per-doc seq_no check in
            # InternalEngine.planIndexingAsNonPrimary — ops may arrive both
            # via recovery dump and concurrent replication fan-out, in
            # either order). Still marked processed: the checkpoint counts
            # seq_nos this copy has ACCOUNTED FOR, including superseded ones
            self.tracker.mark_seq_no_as_processed(seq_no)
            return OpResult(doc_id, seq_no, entry.version, created=False,
                            result="noop")
        parsed = self.mapper_service.parse_document(doc_id, source, routing)
        op_seq = seq_no if seq_no is not None else self.tracker.generate_seq_no()
        created = entry is None or entry.deleted
        if version is not None and version_type in ("external", "external_gte"):
            pass  # external versions are caller-assigned verbatim
        else:
            version = 1 if created else entry.version + 1
        self._delete_from_live_segments(doc_id)
        self._buffer_put(parsed, op_seq)
        self.version_map[doc_id] = VersionEntry(op_seq, version)
        self.translog.add(
            {"op": "index", "id": doc_id, "seq_no": op_seq, "version": version,
             "source": source, "routing": routing}
        )
        self._sync_needed = True
        self.tracker.mark_seq_no_as_processed(op_seq)
        self.stats["index_total"] += 1
        self.stats["index_time_ms"] += (time.monotonic() - t0) * 1e3
        return OpResult(doc_id, op_seq, version, created=created,
                        result="created" if created else "updated")

    def delete(self, doc_id: str, seq_no: int | None = None,
               if_seq_no: int | None = None,
               version: int | None = None,
               version_type: str = "internal") -> OpResult:
        entry = self.version_map.get(doc_id)
        found = (entry is not None and not entry.deleted) or doc_id in self._buffer_pos
        if if_seq_no is not None:
            current_seq = entry.seq_no if entry and not entry.deleted else -1
            if current_seq != if_seq_no:
                raise VersionConflictException(
                    f"[{doc_id}]: version conflict, required seqNo "
                    f"[{if_seq_no}], current document has seqNo [{current_seq}]"
                )
        self._check_version(doc_id, entry, version, version_type)
        if seq_no is not None and entry is not None and entry.seq_no >= seq_no:
            # stale op (see index()): ignore, a newer op already applied
            self.tracker.mark_seq_no_as_processed(seq_no)
            return OpResult(doc_id, seq_no, entry.version, found=False,
                            result="noop")
        op_seq = seq_no if seq_no is not None else self.tracker.generate_seq_no()
        if version is not None and version_type in ("external", "external_gte"):
            pass  # caller-assigned external version
        else:
            version = (entry.version + 1) if entry else 1
        self._buffer_remove(doc_id)
        self._delete_from_live_segments(doc_id)
        self.version_map[doc_id] = VersionEntry(op_seq, version, deleted=True)
        self.translog.add(
            {"op": "delete", "id": doc_id, "seq_no": op_seq, "version": version}
        )
        self._sync_needed = True
        self.tracker.mark_seq_no_as_processed(op_seq)
        self.stats["delete_total"] += 1
        return OpResult(doc_id, op_seq, version, found=found,
                        result="deleted" if found else "not_found")

    def _buffer_put(self, parsed: ParsedDocument, seq_no: int) -> None:
        pos = self._buffer_pos.get(parsed.doc_id)
        if pos is not None:
            self._buffer[pos] = None  # supersede older buffered version
        self._buffer_pos[parsed.doc_id] = len(self._buffer)
        self._buffer.append((parsed, seq_no))

    def _buffer_remove(self, doc_id: str) -> None:
        pos = self._buffer_pos.pop(doc_id, None)
        if pos is not None:
            self._buffer[pos] = None

    def _delete_from_live_segments(self, doc_id: str) -> None:
        for host, _dev in self._segments:
            if host.delete_doc(doc_id):
                self._dirty_live.add(host.name)

    # -- read path ---------------------------------------------------------

    def get(self, doc_id: str, realtime: bool = True) -> dict | None:
        """Realtime GET (index/get in the reference: reads through the
        version map + buffer without waiting for refresh). realtime=False
        reads only what the last refresh made searchable."""
        entry = self.version_map.get(doc_id)
        if realtime and entry is not None and entry.deleted:
            return None
        pos = self._buffer_pos.get(doc_id) if realtime else None
        if pos is not None and self._buffer[pos] is not None:
            parsed, seq = self._buffer[pos]
            return {"_source": parsed.source, "_seq_no": seq,
                    "_version": entry.version if entry else 1,
                    "_routing": parsed.routing}
        for host, _dev in self._segments:
            d = host.local_doc(doc_id)
            if d is not None:
                return {"_source": json.loads(host.sources[d]),
                        "_seq_no": entry.seq_no if entry else -1,
                        "_version": entry.version if entry else 1,
                        "_routing": host.doc_routings[d]}
        return None

    def acquire_searcher(self) -> SearcherSnapshot:
        return self._searcher

    # -- refresh / flush ---------------------------------------------------

    def refresh(self) -> SearcherSnapshot:
        """Seal the RAM buffer into a new segment + republish live masks."""
        # async durability: the refresh cadence doubles as the fsync timer
        # (index.translog.sync_interval analog); no-op under request
        # durability where every ack already synced
        self.ensure_synced()
        live_buffer = [e for e in self._buffer if e is not None]
        if live_buffer:
            self._segment_counter += 1
            self.stats["segments_built"] = self.stats.get("segments_built", 0) + 1
            builder = SegmentBuilder(self.mapper_service, f"_{self._segment_counter}")
            for parsed, seq in live_buffer:
                builder.add(parsed, seq)
            host = builder.build()
            # stamp per-doc versions at seal time (version doc-values)
            import numpy as _np

            host.doc_versions = _np.asarray(
                [self.version_map[d].version if d in self.version_map else 1
                 for d in host.doc_ids], _np.int64,
            )
            dev = to_device(host, self.device)
            self._segments.append((host, dev))
            self._buffer = []
            self._buffer_pos = {}
        if self._dirty_live:
            self._segments = [
                (h, d.with_live(h.live) if h.name in self._dirty_live
                 else d)
                for h, d in self._segments
            ]
            self._dirty_live.clear()
        self._maybe_merge()
        self._refresh_generation += 1
        self._searcher = SearcherSnapshot(list(self._segments), self._refresh_generation)
        self.stats["refresh_total"] += 1
        return self._searcher

    # -- merging -----------------------------------------------------------
    #
    # The OpenSearchConcurrentMergeScheduler + TieredMergePolicy analog
    # (InternalEngine.java:152, CombinedDeletionPolicy). Without merging
    # every refresh adds a segment forever: per-segment device dispatch
    # overhead grows without bound and deleted docs are never reclaimed.
    # Merges happen on the host (rebuild packed arrays from the live docs
    # of the source segments), then the merged segment is republished to
    # device memory and the next searcher snapshot swaps it in.
    # Old snapshots (scroll/PIT) keep their references to the merged-away
    # segments — immutability gives the IndexReader refcount semantics for
    # free; the arrays are dropped when the last snapshot dies.

    MAX_SEGMENTS_BEFORE_MERGE = 10  # segments_per_tier analog
    MERGE_FACTOR = 8                # how many smallest segments fuse per pass

    def _maybe_merge(self) -> None:
        """Background-merge policy, run synchronously at refresh time (the
        single-writer engine's scheduler): when the tier overflows, fuse the
        MERGE_FACTOR smallest segments into one."""
        if len(self._segments) <= self.MAX_SEGMENTS_BEFORE_MERGE:
            return
        by_size = sorted(self._segments, key=lambda hd: int(hd[0].live.sum()))
        self._merge_segments([h.name for h, _ in by_size[: self.MERGE_FACTOR]])

    def force_merge(self, max_num_segments: int = 1,
                    only_expunge_deletes: bool = False) -> dict:
        """POST /{index}/_forcemerge — fuse down to max_num_segments (or
        just rewrite segments carrying tombstones)."""
        self.refresh()
        if not only_expunge_deletes:
            while len(self._segments) > max(1, int(max_num_segments)):
                n_fuse = len(self._segments) - max(1, int(max_num_segments)) + 1
                by_size = sorted(self._segments,
                                 key=lambda hd: int(hd[0].live.sum()))
                self._merge_segments([h.name for h, _ in by_size[:n_fuse]])
        # a force merge always rewrites tombstone-carrying segments, even
        # at/below the target count (Lucene's forceMerge drops deletes in
        # every segment it touches)
        victims = [h.name for h, _ in self._segments
                   if int(h.live.sum()) < h.n_docs]
        if victims:
            self._merge_segments(victims)
        self._refresh_generation += 1
        self._searcher = SearcherSnapshot(list(self._segments),
                                          self._refresh_generation)
        return {"segments": len(self._segments)}

    def _merge_segments(self, names: list[str]) -> None:
        """Fuse the named segments into one new segment holding only their
        live docs. Docs are re-packed via the mapper (host-side rebuild —
        the analyze cost is the merge cost, paid off the query path);
        seal-time seq_nos/versions/routings carry over from the sources."""
        names_set = set(names)
        chosen = [(h, d) for h, d in self._segments if h.name in names_set]
        keep = [(h, d) for h, d in self._segments if h.name not in names_set]
        live_total = sum(int(h.live.sum()) for h, _ in chosen)
        if not chosen:
            return
        if live_total == 0:
            # pure-tombstone segments simply drop
            self._segments = keep
            self._dirty_live -= {h.name for h, _ in chosen}
            self.stats["merge_total"] = self.stats.get("merge_total", 0) + 1
            return
        self._segment_counter += 1
        self.stats["segments_built"] = self.stats.get("segments_built", 0) + 1
        builder = SegmentBuilder(self.mapper_service,
                                 f"_{self._segment_counter}")
        versions: list[int] = []
        for host, _dev in chosen:
            for d in range(host.n_docs):
                if not host.live[d]:
                    continue  # tombstone reclaim
                parsed = self.mapper_service.parse_document(
                    host.doc_ids[d], json.loads(host.sources[d]),
                    host.doc_routings[d] if host.doc_routings else None,
                )
                builder.add(parsed, int(host.doc_seq_nos[d]))
                versions.append(int(host.doc_versions[d]))
        merged = builder.build()
        import numpy as _np

        merged.doc_versions = _np.asarray(versions, _np.int64)
        self._segments = keep + [(merged, to_device(merged, self.device))]
        self._dirty_live -= {h.name for h, _ in chosen}
        self.stats["merge_total"] = self.stats.get("merge_total", 0) + 1

    def _commit_signature(self) -> tuple:
        import hashlib

        return (
            self.tracker.max_seq_no,
            tuple(
                (h.name, hashlib.sha1(h.live.tobytes()).hexdigest())
                for h, _ in self._segments
            ),
        )

    def flush(self) -> None:
        """Commit: refresh, persist segments + commit point, roll translog.
        A no-change flush is skipped entirely (Lucene's IndexWriter.commit
        no-op) so repeated snapshots of an idle shard produce byte-identical
        files for the repository's content-addressed dedup."""
        self.refresh()
        sig = self._commit_signature()
        if sig == getattr(self, "_last_flush_sig", None) and (
            self.path / "commit.json"
        ).exists():
            return
        seg_dir = self.path / "segments"
        prev_seg_lives = dict(getattr(self, "_last_flush_sig", (None, ()))[1])
        cur_seg_lives = dict(sig[1])  # (name, live-digest) pairs from sig
        for host, _dev in self._segments:
            if (seg_dir / f"{host.name}.json").exists() and (
                prev_seg_lives.get(host.name) == cur_seg_lives[host.name]
            ):
                continue  # unchanged since last commit
            save_segment(host, seg_dir)
        commit = {
            "segments": [h.name for h, _ in self._segments],
            "max_seq_no": self.tracker.max_seq_no,
            "local_checkpoint": self.local_checkpoint,
            "segment_counter": self._segment_counter,
            "translog_generation": self.translog.current_generation + 1,
            "retention_leases": self.retention_leases.to_dict(),
            "version_map": {
                doc_id: [e.seq_no, e.version, e.deleted]
                for doc_id, e in self.version_map.items()
            },
        }
        tmp = self.path / "commit.json.tmp"
        with open(tmp, "w") as f:
            json.dump(commit, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path / "commit.json")
        # merged-away segments are no longer referenced by any commit:
        # delete their files (CombinedDeletionPolicy keeping only commits
        # the translog/snapshots still need — here: just the latest)
        current = {h.name for h, _ in self._segments}
        for f in seg_dir.glob("_*"):
            stem = f.name.split(".")[0]
            if stem not in current:
                f.unlink(missing_ok=True)
        self.translog.roll_generation()
        # flush is the periodic hook where stale leases (holder gone >12h
        # without a renewal) stop pinning history
        self.retention_leases.expire(int(time.time() * 1000))
        self.translog.trim_below(
            self.translog.current_generation,
            min_retained_seq=self.retention_leases.min_retained_seq_no(),
        )
        self._last_flush_sig = sig
        self.stats["flush_total"] += 1

    # -- segment replication (NRTReplicationEngine analog) ------------------
    #
    # In SEGMENT replication mode a replica never indexes documents: writes
    # only append to its translog (durability + promotion source), and
    # searchable state arrives as sealed immutable segment bundles published
    # by the primary after refresh (indices/replication/
    # SegmentReplicationTargetService.java:66, onNewCheckpoint:298; the
    # replica engine swap is NRTReplicationEngine's updateSegments).

    def segment_names(self) -> list[str]:
        return [h.name for h, _ in self._segments]

    def segment_sigs(self) -> dict[str, list[int]]:
        """Cheap per-segment content signature for checkpoint diffs: two
        copies may hold same-NAME segments with different content (a
        crash-restarted replica rebuilds a bootstrap segment from its
        translog); the signature distinguishes them. Equal signatures mean
        the segments cover the same ops — equivalent for serving."""
        return {
            h.name: [h.n_docs, int(h.min_seq_no), int(h.max_seq_no),
                     int(h.live.sum())]
            for h, _ in self._segments
        }

    def append_translog_op(self, op: dict) -> None:
        """Replica-side durability for a replicated write without indexing
        (segment-replication replicas)."""
        self.translog.add(op)
        self._sync_needed = True
        self.tracker.mark_seq_no_as_processed(int(op["seq_no"]))
        if op.get("op") == "index":
            self.stats["index_total"] += 1
        else:
            self.stats["delete_total"] += 1

    def install_replicated_segments(
        self, new_hosts: list, order: list[str]
    ) -> None:
        """Swap in the primary's segment set: keep local copies of
        unchanged segments, adopt the new ones, drop segments the primary
        no longer has (merged away). `order` is the primary's full segment
        name list — the replica mirrors it exactly so doc-id tie-breaks and
        segment ordering match across copies."""
        existing = {h.name: (h, d) for h, d in self._segments}
        for host in new_hosts:
            existing[host.name] = (host, to_device(host, self.device))
        self._segments = [existing[n] for n in order if n in existing]
        # seal-time doc columns refresh the version map so realtime GET and
        # seq-no stale checks see replicated docs — only the NEWLY adopted
        # hosts need scanning (kept segments were processed on first install)
        for host in new_hosts:
            for d in range(host.n_docs):
                if not host.live[d]:
                    continue
                doc_id = host.doc_ids[d]
                seq = int(host.doc_seq_nos[d])
                cur = self.version_map.get(doc_id)
                if cur is None or cur.seq_no < seq:
                    self.version_map[doc_id] = VersionEntry(
                        seq, int(host.doc_versions[d])
                    )
                self.tracker.mark_seq_no_as_processed(seq)
        # buffered ops now covered by an installed segment must not build a
        # duplicate local segment at the next refresh
        for doc_id, pos in list(self._buffer_pos.items()):
            entry = self._buffer[pos]
            if entry is None:
                self._buffer_pos.pop(doc_id, None)
                continue
            vm = self.version_map.get(doc_id)
            if vm is not None and vm.seq_no >= entry[1]:
                self._buffer[pos] = None
                self._buffer_pos.pop(doc_id, None)
        if not self._buffer_pos:
            self._buffer = []
        # keep the segment counter ahead of adopted names so a promoted
        # replica never reuses a replicated segment's name
        for name in order:
            try:
                self._segment_counter = max(
                    self._segment_counter, int(name.lstrip("_").split(".")[0])
                )
            except ValueError:
                pass
        self._refresh_generation += 1
        self._searcher = SearcherSnapshot(
            list(self._segments), self._refresh_generation
        )
        self.stats["refresh_total"] += 1

    def translog_tail_ops(self) -> list[dict]:
        """Ops since the last flush (the translog tail a recovering segrep
        replica needs for durability/promotion completeness). Syncs first:
        under async durability recently acked ops may still be unsynced,
        and read_ops truncates at the fsynced checkpoint — a recovery dump
        must never miss acked ops."""
        self.translog.sync()
        self._sync_needed = False
        return list(self.translog.read_ops())

    def history_ops_from(self, from_seq_no: int) -> list[dict] | None:
        """Retained history ops with seq_no >= from_seq_no, in order —
        or None when the translog no longer covers that point (history was
        trimmed past it; the caller must fall back to a segment copy).
        The ops-based recovery source (RecoverySourceHandler phase2-only,
        .../indices/recovery/RecoverySourceHandler.java:171)."""
        if from_seq_no > self.tracker.max_seq_no:
            return []
        if not self.retention_leases.covers(from_seq_no):
            return None
        self.translog.sync()
        ops = [op for op in self.translog.read_ops()
               if int(op.get("seq_no", -1)) >= from_seq_no]
        covered = {int(op["seq_no"]) for op in ops}
        # every needed seq_no must be present (gaps mean trimmed history)
        if any(s not in covered
               for s in range(from_seq_no, self.tracker.max_seq_no + 1)):
            return None
        return sorted(ops, key=lambda o: int(o["seq_no"]))

    def replay_translog_tail(self) -> int:
        """Promotion of a segment-replication replica: index any translog
        ops not yet reflected in the engine (the per-doc seq_no stale check
        dedups ops already covered by replicated segments)."""
        replayed = 0
        for op in self.translog.read_ops():
            if op["op"] == "index":
                r = self.index(op["id"], op["source"], op.get("routing"),
                               seq_no=op["seq_no"])
            else:
                r = self.delete(op["id"], seq_no=op["seq_no"])
            if r.result != "noop":
                replayed += 1
        return replayed

    # -- recovery ----------------------------------------------------------

    def _recover(self) -> None:
        commit_path = self.path / "commit.json"
        replay_from_seq = -1
        if commit_path.exists():
            commit = json.loads(commit_path.read_text())
            seg_dir = self.path / "segments"
            for name in commit["segments"]:
                host = load_segment(seg_dir, name)
                self._segments.append((host, to_device(host, self.device)))
            self.tracker = LocalCheckpointTracker(
                max_seq_no=commit["max_seq_no"],
                local_checkpoint=commit["local_checkpoint"],
            )
            self._segment_counter = commit["segment_counter"]
            self.version_map = {
                doc_id: VersionEntry(seq, ver, deleted)
                for doc_id, (seq, ver, deleted) in commit["version_map"].items()
            }
            if commit.get("retention_leases"):
                from opensearch_tpu_torch.index.seqno import RetentionLeases

                self.retention_leases = RetentionLeases.from_dict(
                    commit["retention_leases"])
            replay_from_seq = commit["max_seq_no"]
        replayed = 0
        for op in self.translog.read_ops():
            if int(op["seq_no"]) <= replay_from_seq:
                continue
            if op["op"] == "index":
                parsed = self.mapper_service.parse_document(
                    op["id"], op["source"], op.get("routing")
                )
                self.tracker.mark_seq_no_as_processed(op["seq_no"])
                self._delete_from_live_segments(op["id"])
                self._buffer_put(parsed, op["seq_no"])
                self.version_map[op["id"]] = VersionEntry(op["seq_no"], op["version"])
            else:
                self.tracker.mark_seq_no_as_processed(op["seq_no"])
                self._buffer_remove(op["id"])
                self._delete_from_live_segments(op["id"])
                self.version_map[op["id"]] = VersionEntry(
                    op["seq_no"], op["version"], deleted=True
                )
            replayed += 1
        if self._segments or replayed:
            self.refresh()
        if commit_path.exists() and replayed == 0:
            # recovered state matches the on-disk commit exactly: remember
            # its signature so the next no-change flush skips file rewrites
            # (keeps snapshot dedup byte-stable across restarts)
            self._last_flush_sig = self._commit_signature()

    # -- stats / lifecycle -------------------------------------------------

    @property
    def num_docs(self) -> int:
        buffered = len([e for e in self._buffer if e is not None])
        return buffered + sum(h.live_count for h, _ in self._segments)

    def segment_stats(self) -> dict:
        return {
            "count": len(self._segments),
            "docs": sum(h.n_docs for h, _ in self._segments),
            "live_docs": sum(h.live_count for h, _ in self._segments),
            "buffered_docs": len([e for e in self._buffer if e is not None]),
        }

    def close(self) -> None:
        self.translog.close()
