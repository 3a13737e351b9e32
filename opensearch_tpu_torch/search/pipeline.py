"""Search pipelines: request, response and phase-results processors.

Counterpart of opensearch_tpu/search/pipeline.py, a host copy: named
pipelines (persisted under the node's data path as
``search_pipelines.json``) of processors that rewrite the request before
the search, the response after it, and, between the query and the fetch
phase, the query phase's results (the slot the hybrid query's fusion
uses).

Processors:
  request:        filter_query, oversample
  response:       rename_field, truncate_hits, sort
  phase_results:  normalization-processor (min_max | l2 | z_score, then an
                  arithmetic, geometric or harmonic mean), and
                  score-ranker-processor (reciprocal rank fusion)

:func:`fuse_hybrid_results` fuses a hybrid query's sub-query results: each
sub-query's scores are normalized over every shard's results at once,
then combined a doc, then re-ranked (host floats, as in the reference).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any

import numpy as np

from opensearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    ResourceNotFoundException,
)

_REQUEST_PROCESSORS = ("filter_query", "oversample")
_RESPONSE_PROCESSORS = ("rename_field", "truncate_hits", "sort")
_PHASE_PROCESSORS = ("normalization-processor", "score-ranker-processor")


class SearchPipelineService:
    """Pipeline registry with file persistence (IngestService-style)."""

    def __init__(self, state_path: Path):
        self._path = Path(state_path)
        self.pipelines: dict[str, dict] = {}
        if self._path.exists():
            self.pipelines = json.loads(self._path.read_text())

    def _persist(self) -> None:
        self._path.parent.mkdir(parents=True, exist_ok=True)
        self._path.write_text(json.dumps(self.pipelines))

    def put(self, pipeline_id: str, body: dict) -> None:
        self._validate(body)
        self.pipelines[pipeline_id] = body
        self._persist()

    def get(self, pipeline_id: str) -> dict:
        if pipeline_id not in self.pipelines:
            raise ResourceNotFoundException(
                f"search pipeline [{pipeline_id}] not found"
            )
        return self.pipelines[pipeline_id]

    def delete(self, pipeline_id: str) -> None:
        if pipeline_id not in self.pipelines:
            raise ResourceNotFoundException(
                f"search pipeline [{pipeline_id}] not found"
            )
        del self.pipelines[pipeline_id]
        self._persist()

    def _validate(self, body: dict) -> None:
        for section, known in (
            ("request_processors", _REQUEST_PROCESSORS),
            ("response_processors", _RESPONSE_PROCESSORS),
            ("phase_results_processors", _PHASE_PROCESSORS),
        ):
            for proc in body.get(section) or []:
                if not isinstance(proc, dict) or len(proc) != 1:
                    raise IllegalArgumentException(
                        f"each processor in [{section}] must be a single-key object"
                    )
                name = next(iter(proc))
                if name not in known:
                    raise IllegalArgumentException(
                        f"unknown processor type [{name}] in [{section}]"
                    )

    # -- execution ---------------------------------------------------------

    def transform_request(self, pipeline: dict, body: dict) -> dict:
        body = dict(body)
        for proc in pipeline.get("request_processors") or []:
            name, conf = next(iter(proc.items()))
            conf = conf or {}
            if name == "filter_query":
                extra = conf.get("query")
                if extra:
                    orig = body.get("query")
                    must = [orig] if orig else []
                    body["query"] = {"bool": {"must": must, "filter": [extra]}}
            elif name == "oversample":
                factor = float(conf.get("sample_factor", 1.0))
                if factor < 1.0:
                    raise IllegalArgumentException(
                        "[oversample] sample_factor must be >= 1"
                    )
                size = int(body.get("size", 10))
                body["_original_size"] = size
                body["size"] = int(math.ceil(size * factor))
        return body

    def transform_response(self, pipeline: dict, body: dict, response: dict) -> dict:
        for proc in pipeline.get("response_processors") or []:
            name, conf = next(iter(proc.items()))
            conf = conf or {}
            hits = response.get("hits", {}).get("hits", [])
            if name == "rename_field":
                field, target = conf.get("field"), conf.get("target_field")
                for hit in hits:
                    src = hit.get("_source")
                    if isinstance(src, dict) and field in src:
                        src[target] = src.pop(field)
            elif name == "truncate_hits":
                target = conf.get("target_size", body.get("_original_size"))
                if target is not None:
                    response["hits"]["hits"] = hits[: int(target)]
            elif name == "sort":
                field = conf.get("field")
                order = conf.get("order", "asc")
                target = conf.get("target_field", field)
                for hit in hits:
                    src = hit.get("_source")
                    if isinstance(src, dict) and isinstance(src.get(field), list):
                        src[target] = sorted(
                            src[field], reverse=(order == "desc")
                        )
        return response

    def phase_results_config(self, pipeline: dict) -> dict | None:
        """The first phase-results processor's config (normalization/RRF)."""
        for proc in pipeline.get("phase_results_processors") or []:
            name, conf = next(iter(proc.items()))
            conf = dict(conf or {})
            conf["_processor"] = name
            return conf
        return None


# --------------------------------------------------------------------------
# hybrid score fusion (the phase-results compute)
# --------------------------------------------------------------------------


def _normalize(all_scores: list[float], scores: list[float], technique: str) -> list[float]:
    if technique == "l2":
        norm = math.sqrt(sum(s * s for s in all_scores)) or 1.0
        return [s / norm for s in scores]
    if technique == "z_score":
        n = len(all_scores) or 1
        mean = sum(all_scores) / n
        var = sum((s - mean) ** 2 for s in all_scores) / n
        std = math.sqrt(var) or 1.0
        return [(s - mean) / std for s in scores]
    # min_max (default); single-point range maps to 1.0
    lo, hi = (min(all_scores), max(all_scores)) if all_scores else (0.0, 0.0)
    if hi <= lo:
        return [1.0 for _ in scores]
    return [max((s - lo) / (hi - lo), 0.001) for s in scores]


def _combine(sub_scores: list[float | None], technique: str, weights: list[float]) -> float:
    n = len(sub_scores)
    w = (weights + [1.0] * n)[:n] if weights else [1.0] * n
    if technique == "geometric_mean":
        num = den = 0.0
        for s, wi in zip(sub_scores, w):
            if s is not None and s > 0:
                num += wi * math.log(s)
                den += wi
        return math.exp(num / den) if den > 0 else 0.0
    if technique == "harmonic_mean":
        num = den = 0.0
        for s, wi in zip(sub_scores, w):
            if s is not None and s > 0:
                num += wi
                den += wi / s
        return num / den if den > 0 else 0.0
    # arithmetic_mean: absent sub-scores count as 0 against the full weight
    total_w = sum(w) or 1.0
    return sum(wi * (s or 0.0) for s, wi in zip(sub_scores, w)) / total_w


def fuse_hybrid_results(
    per_shard_sub_results: list[list],
    config: dict | None,
    fetch_k: int,
):
    """Normalize per-sub-query scores globally, combine per doc, re-rank.

    per_shard_sub_results[shard][sub] is a ShardQueryResult. Returns a list
    of per-shard fused ShardQueryResults (hits re-scored and re-sorted).
    Mirrors the normalization-processor contract: min/max statistics span
    ALL shards' query-phase results for a sub-query, not one shard's.
    """
    from opensearch_tpu_torch.search.executor import ShardHit, ShardQueryResult

    config = config or {}
    processor = config.get("_processor", "normalization-processor")
    n_sub = len(per_shard_sub_results[0]) if per_shard_sub_results else 0

    if processor == "score-ranker-processor":
        comb = config.get("combination") or {}
        rank_constant = int(comb.get("rank_constant", 60))
        weights = list((comb.get("parameters") or {}).get("weights") or [])
        w = (weights + [1.0] * n_sub)[:n_sub] if weights else [1.0] * n_sub
        fused_scores_per_shard: list[dict] = []
        for sub_results in per_shard_sub_results:
            fused: dict[tuple[int, int], float] = {}
            for i, res in enumerate(sub_results):
                ranked = sorted(
                    res.hits, key=lambda h: (-h.score, h.segment, h.doc)
                )
                for rank, h in enumerate(ranked):
                    key = (h.segment, h.doc)
                    fused[key] = fused.get(key, 0.0) + w[i] / (
                        rank_constant + rank + 1
                    )
            fused_scores_per_shard.append(fused)
        return _build_fused(
            per_shard_sub_results, fused_scores_per_shard, fetch_k,
            ShardHit, ShardQueryResult,
        )

    norm_technique = (config.get("normalization") or {}).get("technique", "min_max")
    comb_conf = config.get("combination") or {}
    comb_technique = comb_conf.get("technique", "arithmetic_mean")
    weights = list((comb_conf.get("parameters") or {}).get("weights") or [])

    # global per-sub-query score pools for normalization statistics
    pools: list[list[float]] = [[] for _ in range(n_sub)]
    for sub_results in per_shard_sub_results:
        for i, res in enumerate(sub_results):
            pools[i].extend(h.score for h in res.hits)

    fused_scores_per_shard = []
    for sub_results in per_shard_sub_results:
        per_doc: dict[tuple[int, int], list[float | None]] = {}
        for i, res in enumerate(sub_results):
            if not res.hits:
                continue
            normed = _normalize(
                pools[i], [h.score for h in res.hits], norm_technique
            )
            for h, s in zip(res.hits, normed):
                key = (h.segment, h.doc)
                if key not in per_doc:
                    per_doc[key] = [None] * n_sub
                per_doc[key][i] = s
        fused_scores_per_shard.append({
            key: _combine(subs, comb_technique, weights)
            for key, subs in per_doc.items()
        })
    return _build_fused(
        per_shard_sub_results, fused_scores_per_shard, fetch_k,
        ShardHit, ShardQueryResult,
    )


def _build_fused(per_shard_sub_results, fused_scores_per_shard, fetch_k,
                 ShardHit, ShardQueryResult):
    out = []
    for sub_results, fused in zip(per_shard_sub_results, fused_scores_per_shard):
        ranked = sorted(
            fused.items(), key=lambda kv: (-kv[1], kv[0][0], kv[0][1])
        )[:fetch_k]
        hits = [
            ShardHit(score=score, segment=seg, doc=doc)
            for (seg, doc), score in ranked
        ]
        # union totals / masks across sub-queries
        n_seg = len(sub_results[0].masks) if sub_results and sub_results[0].masks else 0
        masks = []
        score_arrays = []
        for seg_i in range(n_seg):
            m = None
            for res in sub_results:
                seg_mask = res.masks[seg_i]
                if seg_mask is None:
                    continue
                m = seg_mask.copy() if m is None else (m | seg_mask)
            masks.append(m)
            if m is not None:
                arr = np.zeros(m.shape[0], np.float32)
                for (seg, doc), score in fused.items():
                    if seg == seg_i and doc < arr.shape[0]:
                        arr[doc] = score
                score_arrays.append(arr)
            else:
                score_arrays.append(None)
        # union total: exact from OR'd masks when present (aggs path),
        # otherwise the best lower bound from the sub-query totals
        if masks and all(m is not None for m in masks):
            total = int(sum(int(m.sum()) for m in masks))
        else:
            total = max(
                (max((r.total for r in sub_results), default=0), len(fused))
            )
        out.append(ShardQueryResult(
            hits=hits,
            total=total,
            max_score=hits[0].score if hits else None,
            masks=masks,
            score_arrays=score_arrays,
        ))
    return out
