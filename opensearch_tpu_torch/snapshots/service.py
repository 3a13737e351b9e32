"""SnapshotsService: repository registry + snapshot/restore lifecycle.

Counterpart of opensearch_tpu/snapshots/service.py's ``SnapshotsService``
and ``ClusterSnapshotsService``. Mirrors the reference flow (SURVEY.md
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
them (a closed index keeps both in the port).

:class:`ClusterSnapshotsService` is the cluster-mode counterpart: shard
data lives on whichever node holds the primary, so create/restore run as
per-shard RPCs (``internal:snapshot/shard_dump`` /
``internal:snapshot/restore_dump``) orchestrated callback-style from a
coordinator node."""

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

class ClusterSnapshotsService:
    """Snapshot/restore for the CLUSTER node: shard data lives on whichever
    node holds the primary, so create fans ``internal:snapshot/shard_dump``
    to each primary's owner and stores the returned logical point-in-time
    doc sets content-addressed in an fs repository; restore creates a FRESH
    index (same shard count, zero replicas — primary-only install), waits
    for its primaries to start, then pushes each shard's docs back via
    ``internal:snapshot/restore_dump``.

    Everything is callback-style on the node's transport/scheduler so the
    chaos soak can interleave create/status/restore with bulk traffic and
    topology reshapes; all timestamps come from timeutil so a seeded run
    replays byte-identically."""

    def __init__(self, node: Any, root: Path):
        self.node = node
        self.store = FsBlobStore(Path(root))

    # -- create --------------------------------------------------------------

    def create(self, name: str, index: str,
               callback: "Callable[[dict], None]") -> None:
        from opensearch_tpu_torch.common import timeutil

        if not _SNAPSHOT_NAME.match(name):
            callback({"error": f"invalid snapshot name [{name}]"})
            return
        if self.store.get_json(f"csnap-{name}") is not None:
            callback({"error": f"snapshot [{name}] already exists"})
            return
        state = self.node.applied_state
        meta = state.indices.get(index)
        if meta is None:
            callback({"error": f"no such index [{index}]"})
            return
        start_ms = timeutil.epoch_millis()
        pending = {"n": meta.num_shards, "failed": None}
        shards: dict[str, dict] = {}

        def finish() -> None:
            if pending["failed"] is not None:
                callback({"error": pending["failed"]})
                return
            import json as _json

            manifest_shards: dict[str, dict] = {}
            for sid, dump in shards.items():
                data = _json.dumps(dump["docs"], sort_keys=True).encode()
                key = self.store.put_blob(data)
                manifest_shards[sid] = {
                    "blob": key,
                    "docs": len(dump["docs"]),
                    "max_seq_no": dump["max_seq_no"],
                }
            manifest = {
                "snapshot": name,
                "state": "SUCCESS",
                "index": index,
                "num_shards": meta.num_shards,
                # the index's mappings ride the manifest, so a restored
                # knn_vector field is a knn_vector again (the reference
                # restores docs under dynamic mappings only)
                "mappings": meta.mappings,
                "shards": manifest_shards,
                "start_time_in_millis": start_ms,
                "end_time_in_millis": timeutil.epoch_millis(),
            }
            self.store.put_json(f"csnap-{name}", manifest)
            root = self.store.get_json("cindex") or {"snapshots": []}
            root["snapshots"] = sorted(set(root["snapshots"]) | {name})
            self.store.put_json("cindex", root)
            callback({
                "snapshot": name,
                "state": "SUCCESS",
                "index": index,
                "docs": sum(s["docs"] for s in manifest_shards.values()),
                "shards": meta.num_shards,
            })

        def one_done(sid: int, result: dict | None, err: str | None) -> None:
            if err is not None and pending["failed"] is None:
                pending["failed"] = err
            elif result is not None:
                shards[str(sid)] = result
            pending["n"] -= 1
            if pending["n"] == 0:
                finish()

        for num in range(meta.num_shards):
            entry = state.primary(index, num)
            if entry is None or entry.node_id is None:
                one_done(num, None, f"shard [{index}][{num}] has no primary")
                continue
            self.node.transport.send(
                self.node.node_id, entry.node_id,
                "internal:snapshot/shard_dump",
                {"index": index, "shard": num},
                on_response=lambda r, s=num: one_done(s, r, None),
                on_failure=lambda e, s=num: one_done(
                    s, None, f"shard [{index}][{s}] dump failed: {e}"),
            )

    # -- status --------------------------------------------------------------

    def status(self, name: str) -> dict:
        doc = self.store.get_json(f"csnap-{name}")
        if doc is None:
            return {"error": f"snapshot [{name}] missing"}
        return {
            "snapshot": doc["snapshot"],
            "state": doc["state"],
            "index": doc["index"],
            "shards": {
                "total": doc["num_shards"],
                "done": len(doc["shards"]),
                "failed": doc["num_shards"] - len(doc["shards"]),
            },
            "docs": sum(s["docs"] for s in doc["shards"].values()),
            "start_time_in_millis": doc["start_time_in_millis"],
            "end_time_in_millis": doc["end_time_in_millis"],
        }

    def list_snapshots(self) -> list[str]:
        root = self.store.get_json("cindex") or {"snapshots": []}
        return list(root["snapshots"])

    # -- restore -------------------------------------------------------------

    # restore polls the applied state waiting for the fresh index's
    # primaries; bounded so a wedged cluster fails the restore instead of
    # leaking the poll timer forever
    _RESTORE_POLL_MS = 100
    _RESTORE_MAX_POLLS = 600

    def restore(self, name: str, dest: str,
                callback: "Callable[[dict], None]") -> None:
        doc = self.store.get_json(f"csnap-{name}")
        if doc is None:
            callback({"error": f"snapshot [{name}] missing"})
            return
        if dest in self.node.applied_state.indices:
            callback({"error": f"index [{dest}] already exists"})
            return

        def on_created(resp: dict) -> None:
            if resp.get("error"):
                callback({"error": f"restore create failed: {resp['error']}"})
                return
            self._await_primaries(doc, dest, callback,
                                  self._RESTORE_MAX_POLLS)

        try:
            self.node.create_index(dest, {"settings": {
                "number_of_shards": doc["num_shards"],
                "number_of_replicas": 0,
            }, "mappings": doc.get("mappings") or {}}, on_created)
        except Exception as e:  # noqa: BLE001 - no leader etc.
            callback({"error": f"restore create failed: {e}"})

    def _await_primaries(self, doc: dict, dest: str,
                         callback: "Callable[[dict], None]",
                         polls_left: int) -> None:
        state = self.node.applied_state
        entries = [state.primary(dest, n) for n in range(doc["num_shards"])]
        if all(e is not None and e.node_id is not None
               and e.state == "STARTED" for e in entries):
            self._push_shards(doc, dest, callback)
            return
        if polls_left <= 0:
            callback({"error": f"restore [{dest}] timed out waiting for "
                               "primaries to start"})
            return
        self.node.scheduler.schedule(
            self._RESTORE_POLL_MS,
            lambda: self._await_primaries(doc, dest, callback,
                                          polls_left - 1))

    def _push_shards(self, doc: dict, dest: str,
                     callback: "Callable[[dict], None]") -> None:
        import json as _json

        state = self.node.applied_state
        pending = {"n": doc["num_shards"], "failed": None, "docs": 0}

        def one_done(result: dict | None, err: str | None) -> None:
            if err is not None and pending["failed"] is None:
                pending["failed"] = err
            elif result is not None:
                pending["docs"] += int(result.get("restored", 0))
            pending["n"] -= 1
            if pending["n"] == 0:
                if pending["failed"] is not None:
                    callback({"error": pending["failed"]})
                else:
                    callback({"snapshot": doc["snapshot"], "index": dest,
                              "state": "SUCCESS", "docs": pending["docs"]})

        for num in range(doc["num_shards"]):
            shard_meta = doc["shards"].get(str(num))
            if shard_meta is None:
                one_done(None, f"snapshot shard [{num}] missing from "
                               "manifest")
                continue
            docs = _json.loads(self.store.get_blob(shard_meta["blob"]))
            entry = state.primary(dest, num)
            self.node.transport.send(
                self.node.node_id, entry.node_id,
                "internal:snapshot/restore_dump",
                {"index": dest, "shard": num, "docs": docs},
                on_response=lambda r: one_done(r, None),
                on_failure=lambda e, s=num: one_done(
                    None, f"shard [{dest}][{s}] restore failed: {e}"),
            )
