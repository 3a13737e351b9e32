"""Remote segment store: commits mirrored to a blob repository.

Counterpart of opensearch_tpu/index/remote_store.py. A restore rebuilds
each shard through ``Engine.install_replicated_segments``, which publishes
the unpacked segments (their ``knn_vector`` columns and norms included) to
the node's device under the residency ledger's upload scope.

The analog of the reference's remote store
(server/src/main/java/org/opensearch/index/remote/ +
index/store/RemoteSegmentStoreDirectory.java and
RemoteStoreRestoreService): indices created with
`index.remote_store.enabled: true` upload every committed segment (and the
commit point) to a content-addressed blob repository; a node that lost its
local disk restores shards from the remote store via
`POST /_remotestore/_restore`.

Segment bundles ride `pack_segment` — the same bytes segment replication
ships — so the remote object layout is one content-addressed blob per
sealed segment plus one `{index}/{shard}/commit` JSON per shard with the
manifest (RemoteSegmentMetadata analog).
"""

from __future__ import annotations

import json
from typing import Any

from opensearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    ResourceNotFoundException,
)
from opensearch_tpu_torch.index.segment import pack_segment, unpack_segment
from opensearch_tpu_torch.repositories.blobstore import FsBlobStore


class RemoteStoreService:
    """Per-node remote store coordinator."""

    def __init__(self, node):
        self.node = node

    # -- wiring ------------------------------------------------------------

    def _store_for(self, index: str) -> FsBlobStore | None:
        svc = self.node.indices.get(index)
        if svc is None:
            return None
        s = svc.settings or {}
        enabled = str(
            s.get("remote_store.enabled",
                  s.get("remote_store", {}).get("enabled", False)
                  if isinstance(s.get("remote_store"), dict) else False)
        ).lower() == "true"
        if not enabled:
            return None
        repo = (
            s.get("remote_store.segment.repository")
            or (s.get("remote_store", {}) or {}).get(
                "segment", {}).get("repository")
            if isinstance(s.get("remote_store"), dict)
            else s.get("remote_store.segment.repository")
        )
        if repo:
            conf = self.node.snapshots.repositories.get(str(repo))
            if conf is None:
                raise IllegalArgumentException(
                    f"remote store repository [{repo}] is not registered"
                )
            return FsBlobStore(conf["settings"]["location"])
        # default: a node-local "remote" root (stand-in object store)
        return FsBlobStore(self.node.data_path / "remote_store")

    # -- upload (RemoteStoreRefreshListener.afterRefresh analog) -----------

    def sync_shard(self, index: str, shard_id: int) -> dict | None:
        """Upload the shard's current commit (segments + manifest)."""
        store = self._store_for(index)
        if store is None:
            return None
        shard = self.node.indices[index].shards[shard_id]
        engine = shard.engine
        engine.flush()
        uploaded = 0
        manifest: dict[str, Any] = {
            "segments": {},
            "max_seq_no": engine.tracker.max_seq_no,
            "mappings": self.node.indices[index].mapper_service.to_dict(),
            "settings": self.node.indices[index].settings,
        }
        for host, _dev in engine._segments:
            blob = pack_segment(host)
            key = store.put_blob(blob)  # content-addressed: dedups resends
            manifest["segments"][host.name] = key
            uploaded += 1
        store.put_json(f"{index}/{shard_id}/commit", manifest)
        return {"index": index, "shard": shard_id,
                "segments_uploaded": uploaded}

    def sync_index(self, index: str) -> list[dict]:
        svc = self.node.indices.get(index)
        if svc is None:
            raise ResourceNotFoundException(f"no such index [{index}]")
        out = []
        for sid in sorted(svc.shards):
            r = self.sync_shard(index, sid)
            if r is not None:
                out.append(r)
        return out

    # -- restore (RemoteStoreRestoreService.restore) -----------------------

    def restore(self, indices: list[str]) -> dict:
        """Rebuild each index's shards from the remote store manifests.
        The local copy (if any) is replaced — the reference requires the
        index to be closed or absent; here restore recreates it."""
        restored = []
        for index in indices:
            # locate the manifest: the index's configured store if it still
            # exists locally, else every registered repository, else the
            # node-local default root (the restore path must work when the
            # local index metadata is GONE — that is its whole point)
            candidates = []
            configured = self._store_for(index)
            if configured is not None:
                candidates.append(configured)
            for conf in self.node.snapshots.repositories.values():
                loc = (conf.get("settings") or {}).get("location")
                if loc:
                    candidates.append(FsBlobStore(loc))
            candidates.append(
                FsBlobStore(self.node.data_path / "remote_store")
            )
            store = manifest0 = None
            for cand in candidates:
                m = cand.get_json(f"{index}/0/commit")
                if m is not None:
                    store, manifest0 = cand, m
                    break
            if manifest0 is None:
                raise ResourceNotFoundException(
                    f"no remote store data for index [{index}]"
                )
            if index in self.node.indices:
                self.node.delete_index(index)
            self.node.create_index(index, {
                "settings": manifest0.get("settings") or {},
                "mappings": manifest0.get("mappings") or {},
            })
            svc = self.node.indices[index]
            for sid, shard in sorted(svc.shards.items()):
                manifest = store.get_json(f"{index}/{sid}/commit")
                if manifest is None:
                    continue
                hosts = [
                    unpack_segment(store.get_blob(key))
                    for _name, key in sorted(manifest["segments"].items())
                ]
                shard.engine.install_replicated_segments(
                    hosts, [h.name for h in hosts]
                )
            restored.append(index)
        return {"accepted": True, "indices": restored}

    def stats(self, index: str | None = None) -> dict:
        out: dict[str, Any] = {}
        for name, svc in sorted(self.node.indices.items()):
            if index and name != index:
                continue
            store = self._store_for(name)
            if store is None:
                continue
            shards = {}
            for sid in sorted(svc.shards):
                manifest = store.get_json(f"{name}/{sid}/commit")
                shards[str(sid)] = {
                    "segments_uploaded":
                        len((manifest or {}).get("segments", {})),
                    "last_uploaded_max_seq_no":
                        (manifest or {}).get("max_seq_no", -1),
                }
            out[name] = {"shards": shards}
        return out
