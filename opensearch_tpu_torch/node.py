"""TorchNode: a single search node of the PyTorch port.

Counterpart of opensearch_tpu/node.py's ``TpuNode``, for the slice ported
so far: ``create_index``, ``bulk``, ``refresh``, ``search`` (a top-level
knn query), ``msearch`` (runs of bare kNN bodies in one stacked launch)
and ``close``. Every shard publishes its segments to the node's
device; searches run the stacked serving step on it
(search/distributed_serving.py), or the per-shard route, whose launches
coalesce across concurrent searches in ``knn_batcher``
(search/batcher.py).

The device is the card unless the caller asks for the CPU::

    node = TorchNode(path)                 # CUDA; raises without a card
    node = TorchNode(path, device="cpu")   # the CPU, as the tests run it
"""

from __future__ import annotations

import time
import uuid
from pathlib import Path

import torch

from opensearch_tpu_torch import backend
from opensearch_tpu_torch.cluster import shard_mesh
from opensearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    IndexNotFoundException,
    OpenSearchTpuException,
    ResourceAlreadyExistsException,
    VersionConflictException,
)
from opensearch_tpu_torch.common.hashing import shard_id_for_routing
from opensearch_tpu_torch.common.settings import Settings
from opensearch_tpu_torch.index.analysis import AnalysisRegistry
from opensearch_tpu_torch.index.mapper import MapperService
from opensearch_tpu_torch.index.shard import IndexShard, ShardId, translog_durability
from opensearch_tpu_torch.search import batcher
from opensearch_tpu_torch.search import service as search_service
from opensearch_tpu_torch.search.distributed_serving import not_yet_ported

# ASCII, not starting with _ - + (MetadataCreateIndexService.validateIndexName)
_INVALID_INDEX_CHARS = set(' "*\\<>|,/?#:')


def _valid_index_name(name: str) -> bool:
    if not name or name in (".", ".."):
        return False
    if any(c in _INVALID_INDEX_CHARS for c in name):
        return False
    if any("A" <= c <= "Z" for c in name):
        return False
    return not name.startswith(("_", "-", "+"))


class IndexService:
    """Per-index container (index module + its shards)."""

    def __init__(self, name: str, path: Path, settings: dict,
                 mappings: dict | None, device: torch.device):
        self.name = name
        self.path = path
        self.settings = settings
        analysis = AnalysisRegistry.from_index_settings(
            (settings.get("analysis")
             if isinstance(settings.get("analysis"), dict) else None)
        )
        self.mapper_service = MapperService(mappings, analysis)
        self.num_shards = int(settings.get("number_of_shards", 1))
        durability = translog_durability(settings)
        self.shards: dict[int, IndexShard] = {
            s: IndexShard(ShardId(name, s), path / str(s),
                          self.mapper_service, durability=durability,
                          device=device)
            for s in range(self.num_shards)
        }

    def shard_for(self, doc_id: str, routing: str | None) -> IndexShard:
        return self.shards[shard_id_for_routing(routing or doc_id,
                                                self.num_shards)]

    def close(self) -> None:
        for shard in self.shards.values():
            shard.close()


class TorchNode:
    def __init__(self, data_path: str | Path,
                 device: torch.device | str = "cuda"):
        self.device = backend.resolve_device(device)
        self.data_path = Path(data_path)
        self.indices: dict[str, IndexService] = {}
        # the process-wide kNN dispatch batcher the per-shard route uses
        self.knn_batcher = batcher.default_batcher

    # -- index lifecycle ---------------------------------------------------

    def create_index(self, name: str, body: dict | None = None) -> dict:
        if not _valid_index_name(name):
            raise IllegalArgumentException(f"invalid index name [{name}]")
        if name in self.indices:
            raise ResourceAlreadyExistsException(f"index [{name}] already exists")
        body = body or {}
        unknown = set(body) - {"settings", "mappings"}
        if unknown:
            raise not_yet_ported(f"create-index keys {sorted(unknown)}")
        # accept both flat ("index.number_of_shards") and nested forms
        flat = Settings.from_nested(body.get("settings") or {}).as_dict()
        norm = {(k[len("index."):] if k.startswith("index.") else k): v
                for k, v in flat.items()}
        nested = Settings.from_flat(norm).as_nested()
        self.indices[name] = IndexService(
            name, self.data_path / "indices" / name, nested,
            body.get("mappings"), self.device)
        return {"acknowledged": True, "shards_acknowledged": True, "index": name}

    def _get_index(self, name: str) -> IndexService:
        svc = self.indices.get(name)
        if svc is None:
            raise IndexNotFoundException(name)
        return svc

    # -- writes ------------------------------------------------------------

    def _index_doc(self, index: str, doc_id: str | None, source: dict,
                   routing: str | None, op_type: str) -> tuple[dict, IndexShard]:
        svc = self._get_index(index)
        doc_id = uuid.uuid4().hex[:20] if doc_id is None else str(doc_id)
        if len(doc_id.encode()) > 512:
            raise IllegalArgumentException(
                f"id is too long, must be no longer than 512 bytes but "
                f"was: {len(doc_id.encode())}")
        shard = svc.shard_for(doc_id, routing)
        if op_type == "create" and shard.get(doc_id) is not None:
            raise VersionConflictException(
                f"[{doc_id}]: version conflict, document already exists "
                "(current version [1])")
        result = shard.apply_index_on_primary(doc_id, source, routing)
        return self._write_response(index, doc_id, result), shard

    def _delete_doc(self, index: str, doc_id: str,
                    routing: str | None) -> tuple[dict, IndexShard]:
        svc = self._get_index(index)
        shard = svc.shard_for(doc_id, routing)
        result = shard.apply_delete_on_primary(doc_id)
        return self._write_response(index, doc_id, result), shard

    @staticmethod
    def _write_response(index: str, doc_id: str, result) -> dict:
        return {
            "_index": index, "_id": doc_id, "_version": result.version,
            "result": result.result,
            "_shards": {"total": 1, "successful": 1, "failed": 0},
            "_seq_no": result.seq_no, "_primary_term": 1,
        }

    def bulk(self, operations: list[tuple[str, dict, dict | None]],
             refresh: bool = False) -> dict:
        """operations: [(action, metadata, source)]; action in
        index|create|delete (update is not yet ported). The translog is
        fsynced once per request for every shard it touched, before the
        response, as the reference does under durability=request."""
        t0 = time.monotonic()
        items = []
        errors = False
        touched: dict[int, IndexShard] = {}
        for action, meta, source in operations:
            index = meta.get("_index")
            doc_id = meta.get("_id")
            if doc_id is not None and not isinstance(doc_id, str):
                doc_id = str(doc_id)
            routing = meta.get("routing") or meta.get("_routing")
            if routing is not None:
                routing = str(routing)
            if action == "index" and meta.get("op_type") == "create":
                action = "create"
            try:
                if doc_id == "":
                    raise IllegalArgumentException(
                        "if _id is specified it must not be empty")
                if action in ("index", "create"):
                    resp, shard = self._index_doc(index, doc_id, source,
                                                  routing, action)
                    status = 201 if resp["result"] == "created" else 200
                elif action == "delete":
                    resp, shard = self._delete_doc(index, doc_id, routing)
                    status = 200 if resp["result"] == "deleted" else 404
                elif action == "update":
                    raise not_yet_ported("the bulk [update] action")
                else:
                    raise IllegalArgumentException(
                        f"unknown bulk action [{action}]")
                touched[id(shard)] = shard
                items.append({action: {**resp, "status": status}})
            except OpenSearchTpuException as e:
                errors = True
                items.append({action: {"_index": index, "_id": doc_id,
                                       "status": e.status,
                                       "error": e.to_dict()}})
        for shard in touched.values():
            shard.maybe_sync_translog()
            if refresh:
                shard.refresh()
        return {"took": int((time.monotonic() - t0) * 1000),
                "errors": errors, "items": items}

    # -- refresh / search ----------------------------------------------------

    def _resolve(self, index: str) -> list[str]:
        if index in ("_all", "*", ""):
            return sorted(self.indices)
        names = [part.strip() for part in index.split(",")]
        for name in names:
            if "*" in name or "?" in name:
                raise not_yet_ported("wildcard index expressions")
            self._get_index(name)
        return names

    def refresh(self, index: str = "_all") -> dict:
        count = 0
        for name in self._resolve(index):
            for shard in self._get_index(name).shards.values():
                shard.refresh()
                count += 1
        return {"_shards": {"total": count, "successful": count, "failed": 0}}

    def _search_shards(self, index: str | None) -> list[IndexShard]:
        return [shard for name in self._resolve(index or "_all")
                for shard in self._get_index(name).shards.values()]

    def search(self, index: str | None = None, body: dict | None = None,
               precomputed_results: list | None = None) -> dict:
        return search_service.search(self._search_shards(index),
                                     dict(body or {}), precomputed_results)

    def msearch(self, searches: list[tuple[dict, dict]]) -> dict:
        """Runs of consecutive bare-knn sub-searches against the SAME index
        run their query phase as ONE stacked launch
        (search_service.try_batched_knn_msearch: B query vectors in one
        launch); everything else runs one by one, as the reference's
        TransportMultiSearchAction fans out a sub-request at a time. An
        error of this API (an OpenSearchTpuException) fills its own slot;
        a body outside the port raises "not yet ported", as search does."""
        responses: list[dict | None] = [None] * len(searches)
        for group in search_service.msearch_groups(searches):
            index = searches[group[0]][0].get("index")
            precomputed = None
            if len(group) > 1:
                precomputed = self._try_msearch_knn_batch(
                    index, [searches[g][1] for g in group])
            # precomputed None: the whole run one by one (each member still
            # eligible for the single-query stacked step)
            for slot, g in enumerate(group):
                try:
                    responses[g] = self.search(
                        searches[g][0].get("index"), searches[g][1],
                        precomputed_results=(precomputed[slot]
                                             if precomputed else None))
                except OpenSearchTpuException as e:
                    responses[g] = {"error": e.to_dict(), "status": e.status}
        return {"took": 0, "responses": responses}

    def _try_msearch_knn_batch(self, index: str,
                               bodies: list[dict]) -> list[list] | None:
        """Resolve `index` once, pin one set of searcher snapshots, and run
        the batched knn query phase over them. Returns per-body
        precomputed_results for search(), or None (the bodies one by one).
        The reference also keeps a run on its serial path for a filtered
        alias or an index with a default search pipeline; TorchNode has
        neither aliases nor pipelines yet, so neither check applies."""
        try:
            shards = self._search_shards(index)
        except OpenSearchTpuException:
            return None  # the serial path reports the error per sub-search
        snaps = [s.acquire_searcher() for s in shards]
        return search_service.try_batched_knn_msearch(shards, bodies, snaps)

    def close(self) -> None:
        for name, svc in self.indices.items():
            svc.close()
            # the stacked serving slabs of this index leave device memory
            shard_mesh.default_registry.invalidate_index(name)
        self.indices.clear()
