"""IngestService: pipeline registry + execution + simulate.

The analog of server/.../ingest/IngestService.java:118 (pipeline CRUD held
in cluster metadata, executePipelinesInBatchRequests:963 running docs
through processor chains before the index step) and the _ingest/pipeline
REST APIs including /_simulate.

Beside the reference's registry, the service keeps the `ingest` section of
`_nodes/stats` (IngestStats): a count, time, in-flight and failure total,
and the same a pipeline and a processor of it, for every document run
through ``execute`` (``_simulate`` counts nothing, as in OpenSearch)."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path
from typing import Any

from opensearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    OpenSearchTpuException,
    ResourceNotFoundException,
)
from opensearch_tpu_torch.ingest.document import IngestDocument
from opensearch_tpu_torch.ingest.processors import (
    DropDocument,
    Processor,
    build_processor,
)


class Pipeline:
    def __init__(self, pipeline_id: str, body: dict, service: "IngestService"):
        self.id = pipeline_id
        self.description = body.get("description")
        self.version = body.get("version")
        self.processors: list[Processor] = [
            build_processor(p, service) for p in (body.get("processors") or [])
        ]
        self.on_failure: list[Processor] = [
            build_processor(p, service) for p in (body.get("on_failure") or [])
        ]

    def run(self, doc: IngestDocument,
            processor_stats: list[dict] | None = None) -> None:
        try:
            for i, p in enumerate(self.processors):
                if processor_stats is None:
                    p.run(doc)
                    continue
                _timed(processor_stats[i], p.run, doc)
        except DropDocument:
            raise
        except OpenSearchTpuException as e:
            if not self.on_failure:
                raise
            doc.ingest_meta["on_failure_message"] = str(e)
            for p in self.on_failure:
                p.run(doc)


def _new_stats() -> dict:
    return {"count": 0, "time_ns": 0, "current": 0, "failed": 0}


def _timed(stats: dict, fn, *args) -> None:
    """fn(*args) counted in `stats`: a drop counts, an error fails too."""
    stats["current"] += 1
    t0 = time.perf_counter_ns()
    try:
        fn(*args)
    except DropDocument:
        raise
    except Exception:
        stats["failed"] += 1
        raise
    finally:
        stats["count"] += 1
        stats["current"] -= 1
        stats["time_ns"] += time.perf_counter_ns() - t0


def _stats_view(stats: dict) -> dict:
    return {"count": stats["count"],
            "time_in_millis": stats["time_ns"] // 1_000_000,
            "current": stats["current"], "failed": stats["failed"]}


class IngestService:
    def __init__(self, state_file: Path | None = None):
        self.state_file = state_file
        self.pipelines: dict[str, dict] = {}
        self._compiled: dict[str, Pipeline] = {}
        # pipeline id -> {"pipeline": counters, "processors": [(type, tag,
        # counters)]}; a redefinition with other processors restarts them
        self._stats: dict[str, dict] = {}
        self._total = _new_stats()
        if state_file is not None and state_file.exists():
            self.pipelines = json.loads(state_file.read_text())

    # -- CRUD (cluster-metadata pipeline registry analog) -------------------

    def put_pipeline(self, pipeline_id: str, body: dict) -> dict:
        # compile first: bad definitions must be rejected at PUT time
        Pipeline(pipeline_id, body, self)
        self.pipelines[pipeline_id] = body
        self._compiled.pop(pipeline_id, None)
        self._persist()
        return {"acknowledged": True}

    def get_pipeline(self, pipeline_id: str | None = None) -> dict:
        if pipeline_id in (None, "*", "_all"):
            return dict(self.pipelines)
        ids = pipeline_id.split(",")
        out = {i: self.pipelines[i] for i in ids if i in self.pipelines}
        if not out:
            raise ResourceNotFoundException(f"pipeline [{pipeline_id}] is missing")
        return out

    def delete_pipeline(self, pipeline_id: str) -> dict:
        if pipeline_id == "*":
            self.pipelines.clear()
            self._compiled.clear()
        else:
            if pipeline_id not in self.pipelines:
                raise ResourceNotFoundException(
                    f"pipeline [{pipeline_id}] is missing"
                )
            del self.pipelines[pipeline_id]
            self._compiled.pop(pipeline_id, None)
        self._persist()
        return {"acknowledged": True}

    def _persist(self) -> None:
        if self.state_file is not None:
            self.state_file.parent.mkdir(parents=True, exist_ok=True)
            self.state_file.write_text(json.dumps(self.pipelines))

    def get_compiled(self, pipeline_id: str) -> Pipeline | None:
        pipe = self._compiled.get(pipeline_id)
        if pipe is None:
            body = self.pipelines.get(pipeline_id)
            if body is None:
                return None
            pipe = Pipeline(pipeline_id, body, self)
            self._compiled[pipeline_id] = pipe
        return pipe

    # -- execution ----------------------------------------------------------

    def execute(
        self,
        pipeline_id: str,
        index: str,
        doc_id: str | None,
        source: dict,
        routing: str | None = None,
    ) -> IngestDocument | None:
        """Run one document through a pipeline. Returns the transformed
        IngestDocument (metadata may have changed: _index/_id/_routing) or
        None if a drop processor discarded it."""
        pipe = self.get_compiled(pipeline_id)
        if pipe is None:
            raise IllegalArgumentException(
                f"pipeline with id [{pipeline_id}] does not exist"
            )
        doc = IngestDocument(index, doc_id, copy.deepcopy(source), routing)
        stats = self._pipeline_stats(pipeline_id, pipe)
        try:
            _timed(self._total, _timed, stats["pipeline"], pipe.run, doc,
                   [c for _t, _g, c in stats["processors"]])
        except DropDocument:
            return None
        return doc

    def _pipeline_stats(self, pipeline_id: str, pipe: Pipeline) -> dict:
        shape = [(p.type, p.tag) for p in pipe.processors]
        stats = self._stats.get(pipeline_id)
        if stats is None or [(t, g) for t, g, _c in
                             stats["processors"]] != shape:
            stats = self._stats[pipeline_id] = {
                "pipeline": (stats or {}).get("pipeline", _new_stats()),
                "processors": [(t, g, _new_stats()) for t, g in shape]}
        return stats

    def stats(self) -> dict:
        """The `ingest` section of `_nodes/stats` (IngestStats): totals,
        then each pipeline that ran, with its processors in order, each
        keyed by its type (and tag)."""
        return {
            "total": _stats_view(self._total),
            "pipelines": {
                pid: {**_stats_view(st["pipeline"]), "processors": [
                    {(f"{t}:{g}" if g else t): {
                        "type": t, "stats": _stats_view(c)}}
                    for t, g, c in st["processors"]]}
                for pid, st in sorted(self._stats.items())},
        }

    # -- simulate -----------------------------------------------------------

    def simulate(self, body: dict, pipeline_id: str | None = None,
                 verbose: bool = False) -> dict:
        if pipeline_id is not None:
            pipe_body = self.pipelines.get(pipeline_id)
            if pipe_body is None:
                raise ResourceNotFoundException(
                    f"pipeline [{pipeline_id}] does not exist"
                )
        else:
            pipe_body = body.get("pipeline")
            if pipe_body is None:
                raise IllegalArgumentException("required property is missing: pipeline")
        docs = body.get("docs") or []
        results = []
        for entry in docs:
            src = copy.deepcopy(entry.get("_source") or {})
            doc = IngestDocument(
                entry.get("_index", "_index"), entry.get("_id", "_id"),
                src, entry.get("_routing"),
            )
            if verbose:
                results.append(self._simulate_verbose(pipe_body, doc))
            else:
                try:
                    Pipeline("_simulate_pipeline", pipe_body, self).run(doc)
                    results.append({"doc": self._doc_json(doc)})
                except DropDocument:
                    results.append({"doc": None})
                except OpenSearchTpuException as e:
                    results.append({"error": e.to_dict()})
        return {"docs": results}

    def _simulate_verbose(self, pipe_body: dict, doc: IngestDocument) -> dict:
        steps = []
        procs = [
            build_processor(p, self) for p in (pipe_body.get("processors") or [])
        ]
        for p in procs:
            try:
                p.run(doc)
                steps.append({
                    "processor_type": p.type,
                    **({"tag": p.tag} if p.tag else {}),
                    "status": "success",
                    "doc": self._doc_json(doc),
                })
            except DropDocument:
                steps.append({"processor_type": p.type, "status": "dropped"})
                break
            except OpenSearchTpuException as e:
                steps.append({
                    "processor_type": p.type,
                    **({"tag": p.tag} if p.tag else {}),
                    "status": "error",
                    "error": e.to_dict(),
                })
                break
        return {"processor_results": steps}

    def _doc_json(self, doc: IngestDocument) -> dict:
        return {
            "_index": doc.meta["_index"],
            "_id": doc.meta["_id"],
            "_source": doc.source,
            "_ingest": {"timestamp": doc.ingest_meta["timestamp"]},
        }
