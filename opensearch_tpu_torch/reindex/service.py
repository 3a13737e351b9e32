"""Reindex module: _reindex, _update_by_query, _delete_by_query.

Counterpart of opensearch_tpu/reindex/service.py, a host copy. Its kNN
consequences are the node's: a copied or updated document reaches the
device at the next refresh, and a deleted one leaves the live mask that
K1's dead-doc operand reads.

The analog of modules/reindex (SURVEY.md §2.3: 4,909 LoC — scroll+bulk
client-style copy with an AsyncTwoPhaseIndexer-style throttled worker).
Same architecture here: batches stream through the node's own public
search-scroll and bulk APIs (never the engine internals), each run is a
cancellable task, version conflicts are detected via seq-no compare-and-set
and either abort (default) or are counted and skipped (conflicts=proceed).
"""

from __future__ import annotations

import time
from typing import Any

from opensearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    OpenSearchTpuException,
    VersionConflictException,
)

DEFAULT_BATCH = 1000
TASK_REINDEX = "indices:data/write/reindex"
TASK_UPDATE_BY_QUERY = "indices:data/write/update/byquery"
TASK_DELETE_BY_QUERY = "indices:data/write/delete/byquery"


def _scan_batches(node, index: str, query: dict | None, batch: int,
                  source_filter=None, task=None):
    """Yield lists of hits (with seq_no) streaming over a pinned snapshot."""
    body: dict[str, Any] = {
        "query": query or {"match_all": {}},
        "size": batch,
        "seq_no_primary_term": True,
    }
    if source_filter is not None:
        body["_source"] = source_filter
    resp = node.search(index, body, scroll="5m")
    sid = resp.get("_scroll_id")
    try:
        while True:
            hits = resp["hits"]["hits"]
            if not hits:
                return
            if task is not None:
                task.ensure_not_cancelled()
            yield hits
            resp = node.scroll(sid)
    finally:
        if sid:
            node.clear_scroll([sid])


def _compile_script(node, script: dict | None):
    if not script:
        return None
    from opensearch_tpu_torch.script import default_script_service

    return default_script_service.compile(script)


def _run_script(compiled, hit: dict, op_default: str) -> tuple[str, dict]:
    """Returns (op, mutated source). op in index|noop|delete."""
    if compiled is None:
        return op_default, hit["_source"]
    from opensearch_tpu_torch.script import default_script_service

    ast, params = compiled
    ctx = {
        "_source": dict(hit["_source"]),
        "_id": hit["_id"],
        "_index": hit["_index"],
        "op": op_default,
    }
    default_script_service.execute_update(ast, params, ctx)
    op = ctx.get("op", op_default)
    if op not in ("index", "create", "noop", "delete"):
        raise IllegalArgumentException(f"invalid script op [{op}]")
    return op, ctx["_source"]


def reindex(node, body: dict, refresh: bool = False) -> dict:
    body = body or {}
    src = body.get("source") or {}
    dest = body.get("dest") or {}
    if not src.get("index") or not dest.get("index"):
        raise IllegalArgumentException(
            "[reindex] requires [source.index] and [dest.index]"
        )
    src_concrete = set(node.resolve_indices(src["index"]))
    if node.resolve_write_target(dest["index"]) in src_concrete:
        raise IllegalArgumentException(
            "reindex cannot write into an index its reading from "
            f"[{dest['index']}]"
        )
    conflicts_proceed = body.get("conflicts") == "proceed"
    max_docs = body.get("max_docs")
    batch = int(src.get("size", DEFAULT_BATCH))
    op_type = dest.get("op_type", "index")
    pipeline = dest.get("pipeline")
    compiled = _compile_script(node, body.get("script"))

    t0 = time.monotonic()
    stats = {"total": 0, "created": 0, "updated": 0, "deleted": 0,
             "noops": 0, "version_conflicts": 0, "batches": 0}
    failures: list[dict] = []
    with node.task_manager.task_scope(
        TASK_REINDEX,
        description=f"reindex from [{src['index']}] to [{dest['index']}]",
    ) as task:
        done = False
        for hits in _scan_batches(node, src["index"], src.get("query"),
                                  batch, src.get("_source"), task):
            stats["batches"] += 1
            ops = []
            for hit in hits:
                if max_docs is not None and stats["total"] >= int(max_docs):
                    done = True
                    break
                stats["total"] += 1
                op, new_source = _run_script(compiled, hit, "index")
                if op == "noop":
                    stats["noops"] += 1
                    continue
                # preserve custom _routing through the copy (the reference
                # carries routing on every scroll hit into the bulk op;
                # dropping it would land routed docs on the _id-hashed shard)
                hit_routing = hit.get("_routing")
                if op == "delete":
                    dmeta = {"_index": dest["index"], "_id": hit["_id"]}
                    if hit_routing is not None:
                        dmeta["routing"] = hit_routing
                    ops.append(("delete", dmeta, None))
                    continue
                meta = {"_index": dest["index"], "_id": hit["_id"]}
                if hit_routing is not None:
                    meta["routing"] = hit_routing
                if pipeline:
                    meta["pipeline"] = pipeline
                ops.append((op_type if op == "index" else op, meta, new_source))
            if ops:
                resp = node.bulk(ops)
                _merge_bulk(resp, stats, failures, conflicts_proceed)
                # non-conflict failures always abort; conflicts only
                # populate `failures` when conflicts != proceed
                if failures:
                    break
            if done:
                break
        if refresh:
            node.refresh(dest["index"])
    return _response(t0, stats, failures)


def update_by_query(node, index: str, body: dict | None = None,
                    conflicts: str | None = None,
                    refresh: bool = False) -> dict:
    body = body or {}
    conflicts_proceed = (conflicts or body.get("conflicts")) == "proceed"
    max_docs = body.get("max_docs")
    compiled = _compile_script(node, body.get("script"))
    t0 = time.monotonic()
    stats = {"total": 0, "created": 0, "updated": 0, "deleted": 0,
             "noops": 0, "version_conflicts": 0, "batches": 0}
    failures: list[dict] = []
    with node.task_manager.task_scope(
        TASK_UPDATE_BY_QUERY, description=f"update-by-query [{index}]"
    ) as task:
        done = False
        for hits in _scan_batches(node, index, body.get("query"),
                                  int(body.get("size", DEFAULT_BATCH)),
                                  task=task):
            stats["batches"] += 1
            # one write-request scope per scan batch: pressure accounted and
            # translog fsynced ONCE per batch, not per doc (the reference's
            # by-query workers write through bulk for the same reason)
            with node._write_pressure(
                sum(len(str(h.get("_source") or "")) for h in hits),
                "update_by_query",
            ):
                for hit in hits:
                    if max_docs is not None and stats["total"] >= int(max_docs):
                        done = True
                        break
                    stats["total"] += 1
                    op, new_source = _run_script(compiled, hit, "index")
                    if op == "noop":
                        stats["noops"] += 1
                        continue
                    try:
                        # CAS on the seq-no observed at scan time: a doc
                        # modified since then is a version conflict
                        if op == "delete":
                            node.delete_doc(hit["_index"], hit["_id"],
                                            routing=hit.get("_routing"),
                                            if_seq_no=hit["_seq_no"])
                            stats["deleted"] += 1
                        else:
                            node.index_doc(
                                hit["_index"], hit["_id"], new_source,
                                routing=hit.get("_routing"),
                                if_seq_no=hit["_seq_no"],
                            )
                            stats["updated"] += 1
                    except OpenSearchTpuException as e:
                        if isinstance(e, VersionConflictException):
                            stats["version_conflicts"] += 1
                            if conflicts_proceed:
                                continue
                        failures.append({
                            "index": hit["_index"], "id": hit["_id"],
                            "cause": e.to_dict(), "status": e.status,
                        })
                        done = True
                        break
            if done:
                break
        if refresh:
            node.refresh(index)
    return _response(t0, stats, failures)


def delete_by_query(node, index: str, body: dict | None = None,
                    conflicts: str | None = None,
                    refresh: bool = False) -> dict:
    body = body or {}
    if "query" not in body:
        raise IllegalArgumentException("[delete_by_query] requires [query]")
    conflicts_proceed = (conflicts or body.get("conflicts")) == "proceed"
    max_docs = body.get("max_docs")
    t0 = time.monotonic()
    stats = {"total": 0, "created": 0, "updated": 0, "deleted": 0,
             "noops": 0, "version_conflicts": 0, "batches": 0}
    failures: list[dict] = []
    with node.task_manager.task_scope(
        TASK_DELETE_BY_QUERY, description=f"delete-by-query [{index}]"
    ) as task:
        done = False
        for hits in _scan_batches(node, index, body["query"],
                                  int(body.get("size", DEFAULT_BATCH)),
                                  source_filter=False, task=task):
            stats["batches"] += 1
            # batch-level write scope: one fsync per batch (see update_by_query)
            with node._write_pressure(64 * len(hits), "delete_by_query"):
                for hit in hits:
                    if max_docs is not None and stats["total"] >= int(max_docs):
                        done = True
                        break
                    stats["total"] += 1
                    try:
                        resp = node.delete_doc(hit["_index"], hit["_id"],
                                               routing=hit.get("_routing"),
                                               if_seq_no=hit["_seq_no"])
                        if resp["result"] == "deleted":
                            stats["deleted"] += 1
                    except OpenSearchTpuException as e:
                        if isinstance(e, VersionConflictException):
                            stats["version_conflicts"] += 1
                            if conflicts_proceed:
                                continue
                        failures.append({
                            "index": hit["_index"], "id": hit["_id"],
                            "cause": e.to_dict(), "status": e.status,
                        })
                        done = True
                        break
            if done:
                break
        if refresh:
            node.refresh(index)
    return _response(t0, stats, failures)


def _merge_bulk(resp: dict, stats: dict, failures: list,
                conflicts_proceed: bool) -> None:
    for item in resp["items"]:
        result = next(iter(item.values()))
        if "error" in result:
            if result["error"].get("type") == "version_conflict_engine_exception":
                stats["version_conflicts"] += 1
                if conflicts_proceed:
                    continue
            failures.append({
                "index": result.get("_index"), "id": result.get("_id"),
                "cause": result["error"], "status": result["status"],
            })
        elif result.get("result") == "created":
            stats["created"] += 1
        elif result.get("result") == "updated":
            stats["updated"] += 1
        elif result.get("result") == "deleted":
            stats["deleted"] += 1


def _response(t0: float, stats: dict, failures: list) -> dict:
    return {
        "took": int((time.monotonic() - t0) * 1000),
        "timed_out": False,
        **stats,
        "retries": {"bulk": 0, "search": 0},
        "throttled_millis": 0,
        "requests_per_second": -1.0,
        "throttled_until_millis": 0,
        "failures": failures,
    }
