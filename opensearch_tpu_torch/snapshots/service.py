"""SnapshotsService: repository registry + snapshot/restore lifecycle.

Counterpart of opensearch_tpu/snapshots/service.py's ``SnapshotsService``
(the single-node service; the cluster-mode ``ClusterSnapshotsService``
arrives with the control plane). Mirrors the reference flow (SURVEY.md
§2.2): snapshot = per-shard upload of the committed files into a
content-addressed blob store (SnapshotShardsService → BlobStoreRepository),
a per-snapshot global manifest, and a repository-root generation file
(RepositoryData analog); restore rebuilds shard directories from the
manifests (RestoreService), and the restored shards recover from their
commit onto the node's device like a restart's. Unreferenced blobs are
garbage-collected on snapshot delete, like the reference's stale-blob
cleanup.

A restore over a closed index of the same name replaces it: its engines
close (their device columns leave the residency ledger) and its stacked
serving bundles are released, as ``TorchNode.delete_index`` releases
them (a closed index keeps both in the port)."""

from __future__ import annotations

import fnmatch
import re
import time
from pathlib import Path
from typing import TYPE_CHECKING, Any

from opensearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    ResourceAlreadyExistsException,
    ResourceNotFoundException,
)
from opensearch_tpu_torch.repositories.blobstore import FsBlobStore

if TYPE_CHECKING:
    from opensearch_tpu_torch.node import TorchNode

_SNAPSHOT_NAME = re.compile(r"^[a-z0-9][a-z0-9_\-.]*$")


class SnapshotsService:
    def __init__(self, node: "TorchNode"):
        self.node = node
        self._repos_file = node.data_path / "repositories.json"
        self.repositories: dict[str, dict] = {}
        if self._repos_file.exists():
            import json

            self.repositories = json.loads(self._repos_file.read_text())

    # -- repository registry ------------------------------------------------

    def put_repository(self, name: str, body: dict) -> dict:
        typ = body.get("type")
        if typ != "fs":
            raise IllegalArgumentException(
                f"repository type [{typ}] is not supported (use [fs])"
            )
        settings = body.get("settings") or {}
        if not settings.get("location"):
            raise IllegalArgumentException(
                "[location] is required for [fs] repositories"
            )
        self.repositories[name] = {"type": typ, "settings": settings}
        self._persist()
        # eagerly create the root so registration validates the path
        self._store(name)
        return {"acknowledged": True}

    def get_repository(self, name: str | None = None) -> dict:
        if name in (None, "_all", "*"):
            return dict(self.repositories)
        if name not in self.repositories:
            raise ResourceNotFoundException(f"[{name}] missing")
        return {name: self.repositories[name]}

    def delete_repository(self, name: str) -> dict:
        if name not in self.repositories:
            raise ResourceNotFoundException(f"[{name}] missing")
        del self.repositories[name]
        self._persist()
        return {"acknowledged": True}

    def _persist(self) -> None:
        import json

        self._repos_file.parent.mkdir(parents=True, exist_ok=True)
        self._repos_file.write_text(json.dumps(self.repositories))

    def _store(self, repo: str) -> FsBlobStore:
        meta = self.repositories.get(repo)
        if meta is None:
            raise ResourceNotFoundException(f"[{repo}] missing")
        location = meta["settings"]["location"]
        root = Path(location)
        if not root.is_absolute():
            root = self.node.data_path / "repos" / location
        return FsBlobStore(root)

    # -- snapshot create ----------------------------------------------------

    def create_snapshot(self, repo: str, snapshot: str,
                        body: dict | None = None) -> dict:
        body = body or {}
        if not _SNAPSHOT_NAME.match(snapshot):
            raise IllegalArgumentException(f"invalid snapshot name [{snapshot}]")
        store = self._store(repo)
        if store.get_json(f"snap-{snapshot}") is not None:
            raise ResourceAlreadyExistsException(
                f"snapshot with the same name [{snapshot}] already exists"
            )
        indices_expr = body.get("indices", "_all")
        if isinstance(indices_expr, str):
            indices_expr = [s for s in indices_expr.split(",") if s]
        names = self._resolve_indices(
            indices_expr,
            ignore_unavailable=bool(body.get("ignore_unavailable", False)))
        start_ms = int(time.time() * 1000)
        indices_meta: dict[str, Any] = {}
        total_files = 0
        for index in names:
            svc = self.node.indices[index]
            shards_meta: dict[str, Any] = {}
            for sid, shard in svc.shards.items():
                shard.flush()  # commit so the on-disk files are complete
                files: dict[str, dict] = {}
                shard_dir = shard.engine.path
                for rel in self._shard_files(shard_dir):
                    data = (shard_dir / rel).read_bytes()
                    key = store.put_blob(data)
                    files[rel] = {"hash": key, "size": len(data)}
                    total_files += 1
                shards_meta[str(sid)] = {"files": files}
            indices_meta[index] = {
                "settings": svc.settings,
                "mappings": svc.mapper_service.to_dict(),
                "shards": shards_meta,
            }
        snap_doc = {
            "snapshot": snapshot,
            "uuid": f"{repo}-{snapshot}-{start_ms}",
            "state": "SUCCESS",
            "indices": indices_meta,
            "include_global_state": bool(
                body.get("include_global_state", True)),
            "metadata": body.get("metadata"),
            "start_time_in_millis": start_ms,
            "end_time_in_millis": int(time.time() * 1000),
            "shards": {
                "total": sum(len(m["shards"]) for m in indices_meta.values()),
                "failed": 0,
                "successful": sum(len(m["shards"]) for m in indices_meta.values()),
            },
        }
        store.put_json(f"snap-{snapshot}", snap_doc)
        # repository generation root (RepositoryData analog)
        root = store.get_json("index") or {"snapshots": []}
        root["snapshots"] = sorted(set(root["snapshots"]) | {snapshot})
        store.put_json("index", root)
        return {"snapshot": self._public_snapshot(snap_doc)}

    def _shard_files(self, shard_dir: Path) -> list[str]:
        """Files that constitute one shard's committed state: the commit
        point, every segment file it references, and the translog."""
        out = []
        for p in shard_dir.rglob("*"):
            if p.is_file() and not p.name.endswith(".tmp"):
                out.append(str(p.relative_to(shard_dir)))
        return sorted(out)

    def _resolve_indices(self, patterns: list[str],
                         ignore_unavailable: bool = False) -> list[str]:
        if not patterns or patterns == ["_all"]:
            return sorted(self.node.indices)
        out = []
        for pat in patterns:
            matched = [n for n in self.node.indices if fnmatch.fnmatch(n, pat)]
            if not matched and "*" not in pat and not ignore_unavailable:
                from opensearch_tpu_torch.common.errors import IndexNotFoundException

                raise IndexNotFoundException(pat)
            out.extend(matched)
        return sorted(set(out))

    # -- get / status / delete ---------------------------------------------

    def _public_snapshot(self, doc: dict, verbose: bool = True) -> dict:
        if not verbose:
            # non-verbose listings carry the summary only — no shard
            # counts, failures, or timing detail
            return {
                "snapshot": doc["snapshot"],
                "uuid": doc["uuid"],
                "state": doc["state"],
                "indices": sorted(doc["indices"]),
            }
        out = {
            "snapshot": doc["snapshot"],
            "uuid": doc["uuid"],
            "version": "3.3.0",
            "version_id": 137227827,
            "state": doc["state"],
            "indices": sorted(doc["indices"]),
            "include_global_state": doc.get("include_global_state", True),
            "start_time_in_millis": doc["start_time_in_millis"],
            "end_time_in_millis": doc["end_time_in_millis"],
            "duration_in_millis": (
                doc["end_time_in_millis"] - doc["start_time_in_millis"]
            ),
            "shards": doc["shards"],
            "failures": [],
        }
        if doc.get("metadata") is not None:
            out["metadata"] = doc["metadata"]
        return out

    def get_snapshot(self, repo: str, snapshot: str | None = None,
                     verbose: bool = True,
                     ignore_unavailable: bool = False) -> dict:
        from opensearch_tpu_torch.common.errors import SnapshotMissingException

        store = self._store(repo)
        root = store.get_json("index") or {"snapshots": []}
        if snapshot in (None, "_all", "*"):
            names = root["snapshots"]
        else:
            names = []
            for pat in snapshot.split(","):
                if "*" in pat:
                    names.extend(n for n in root["snapshots"]
                                 if fnmatch.fnmatch(n, pat))
                elif pat in root["snapshots"]:
                    names.append(pat)
                elif not ignore_unavailable:
                    raise SnapshotMissingException(repo, pat)
        out = []
        for name in sorted(set(names)):
            doc = store.get_json(f"snap-{name}")
            if doc is not None:
                out.append(self._public_snapshot(doc, verbose=verbose))
        return {"snapshots": out}

    def snapshot_status(self, repo: str, snapshot: str) -> dict:
        from opensearch_tpu_torch.common.errors import SnapshotMissingException

        store = self._store(repo)
        doc = store.get_json(f"snap-{snapshot}")
        if doc is None:
            raise SnapshotMissingException(repo, snapshot)
        indices = {}
        agg_files = 0
        agg_bytes = 0
        n_shards = 0
        for index, meta in doc["indices"].items():
            shard_stats = {}
            for sid, sh in meta["shards"].items():
                nfiles = len(sh["files"])
                nbytes = sum(f["size"] for f in sh["files"].values())
                agg_files += nfiles
                agg_bytes += nbytes
                n_shards += 1
                shard_stats[sid] = {
                    "stage": "DONE",
                    "stats": self._status_stats(nfiles, nbytes, doc),
                }
            indices[index] = {"shards": shard_stats}
        return {"snapshots": [{
            "snapshot": doc["snapshot"],
            "repository": repo,
            "uuid": doc["uuid"],
            "state": doc["state"],
            "include_global_state": doc.get("include_global_state", True),
            "shards_stats": {"initializing": 0, "started": 0,
                             "finalizing": 0, "done": n_shards,
                             "failed": 0, "total": n_shards},
            "stats": self._status_stats(agg_files, agg_bytes, doc),
            "indices": indices,
        }]}

    @staticmethod
    def _status_stats(nfiles: int, nbytes: int, doc: dict) -> dict:
        start = doc.get("start_time_in_millis", 0)
        return {
            "incremental": {"file_count": nfiles,
                            "size_in_bytes": nbytes},
            "total": {"file_count": nfiles, "size_in_bytes": nbytes},
            "start_time_in_millis": start,
            "time_in_millis": max(
                doc.get("end_time_in_millis", start) - start, 0),
        }

    def delete_snapshot(self, repo: str, snapshot: str) -> dict:
        from opensearch_tpu_torch.common.errors import SnapshotMissingException

        store = self._store(repo)
        doc = store.get_json(f"snap-{snapshot}")
        if doc is None:
            raise SnapshotMissingException(repo, snapshot)
        store.delete_json(f"snap-{snapshot}")
        root = store.get_json("index") or {"snapshots": []}
        root["snapshots"] = [s for s in root["snapshots"] if s != snapshot]
        store.put_json("index", root)
        # garbage-collect blobs no longer referenced by any snapshot
        live: set[str] = set()
        for name in root["snapshots"]:
            d = store.get_json(f"snap-{name}")
            if d is None:
                continue
            for meta in d["indices"].values():
                for sh in meta["shards"].values():
                    live.update(f["hash"] for f in sh["files"].values())
        for key in store.list_blobs():
            if key not in live:
                store.delete_blob(key)
        return {"acknowledged": True}

    # -- restore ------------------------------------------------------------

    def restore_snapshot(self, repo: str, snapshot: str,
                         body: dict | None = None) -> dict:
        body = body or {}
        from opensearch_tpu_torch.common.errors import SnapshotMissingException

        store = self._store(repo)
        doc = store.get_json(f"snap-{snapshot}")
        if doc is None:
            raise SnapshotMissingException(repo, snapshot)
        indices_expr = body.get("indices", "_all")
        if isinstance(indices_expr, str):
            indices_expr = [s for s in indices_expr.split(",") if s]
        if not indices_expr or indices_expr == ["_all"]:
            targets = sorted(doc["indices"])
        else:
            targets = []
            for pat in indices_expr:
                targets.extend(n for n in doc["indices"]
                               if fnmatch.fnmatch(n, pat))
            targets = sorted(set(targets))
        rename_pat = body.get("rename_pattern")
        rename_rep = body.get("rename_replacement")

        def _dest_name(index: str) -> str:
            if rename_pat is not None and rename_rep is not None:
                return re.sub(rename_pat, rename_rep.replace("$1", r"\1"), index)
            return index

        # validate EVERY target before writing anything: restore is
        # all-or-nothing (no partially-registered indices on conflict)
        for index in targets:
            dest = _dest_name(index)
            existing = self.node.indices.get(dest)
            if existing is not None and not existing.closed:
                raise ResourceAlreadyExistsException(
                    f"cannot restore index [{dest}] because an open index "
                    "with same name already exists in the cluster"
                )
        import shutil as _sh

        # fetch EVERY blob before touching any index: a missing/corrupt
        # blob must fail the whole restore with nothing destroyed
        fetched: dict[str, dict[str, dict[str, bytes]]] = {}
        for index in targets:
            meta = doc["indices"][index]
            per_shard: dict[str, dict[str, bytes]] = {}
            for sid, sh in meta["shards"].items():
                per_shard[sid] = {
                    rel: store.get_blob(info["hash"])
                    for rel, info in sh["files"].items()
                }
            fetched[index] = per_shard
        restored = []
        for index in targets:
            dest = _dest_name(index)
            meta = doc["indices"][index]
            # a CLOSED index of the same name is replaced (the reference
            # restores into closed indices)
            existing = self.node.indices.pop(dest, None)
            if existing is not None:
                # a closed index keeps its device columns and stacked
                # bundles, and the restored engines' ids never evict them
                self.node._release_index(dest, existing)
            dest_path = self.node._index_path(dest)
            _sh.rmtree(dest_path, ignore_errors=True)
            for sid, files in fetched[index].items():
                shard_dir = dest_path / sid
                for rel, data in files.items():
                    out = shard_dir / rel
                    out.parent.mkdir(parents=True, exist_ok=True)
                    out.write_bytes(data)
            self.node.attach_index(dest, meta["settings"], meta["mappings"])
            self.node.indices[dest].restored_from_snapshot = snapshot
            restored.append(dest)
        self.node._persist_index_registry()
        return {"snapshot": {
            "snapshot": snapshot,
            "indices": restored,
            "shards": doc["shards"],
        }}
