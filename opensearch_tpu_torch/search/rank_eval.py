"""Rank evaluation: offline relevance metrics over templated searches.

Counterpart of opensearch_tpu/search/rank_eval.py, a host copy: each rated
request is one ``node.search``, so a ``knn`` request is one K1 launch on an
exact column and one K2 launch on an IVF-PQ one.

The analog of modules/rank-eval (SURVEY.md §2.3: P@k, MRR, DCG, expected
reciprocal rank over rated documents). Pure coordinator-side compute: run
each request through the normal search path, score the ranked hits against
the provided ratings.
"""

from __future__ import annotations

import math
from typing import Any

from opensearch_tpu_torch.common.errors import IllegalArgumentException

DEFAULT_K = 10


def _ratings_map(ratings: list[dict]) -> dict[tuple[str, str], int]:
    out = {}
    for r in ratings or []:
        out[(r.get("_index", ""), str(r["_id"]))] = int(r.get("rating", 0))
    return out


def _precision_at_k(hits, rated, k, relevant_threshold=1):
    top = hits[:k]
    if not top:
        return 0.0
    relevant = sum(
        1 for h in top
        if rated.get((h["_index"], h["_id"]), 0) >= relevant_threshold
    )
    return relevant / len(top)


def _recall_at_k(hits, rated, k, relevant_threshold=1):
    total_relevant = sum(1 for v in rated.values() if v >= relevant_threshold)
    if total_relevant == 0:
        return 0.0
    top = hits[:k]
    found = sum(
        1 for h in top
        if rated.get((h["_index"], h["_id"]), 0) >= relevant_threshold
    )
    return found / total_relevant


def _mrr(hits, rated, k, relevant_threshold=1):
    for i, h in enumerate(hits[:k]):
        if rated.get((h["_index"], h["_id"]), 0) >= relevant_threshold:
            return 1.0 / (i + 1)
    return 0.0


def _dcg(hits, rated, k, normalize=False):
    def gain(rating, pos):
        return (2 ** rating - 1) / math.log2(pos + 2)

    dcg = sum(
        gain(rated.get((h["_index"], h["_id"]), 0), i)
        for i, h in enumerate(hits[:k])
    )
    if not normalize:
        return dcg
    ideal = sorted(rated.values(), reverse=True)[:k]
    idcg = sum(gain(r, i) for i, r in enumerate(ideal))
    return dcg / idcg if idcg > 0 else 0.0


def _err(hits, rated, k, max_rating=3):
    """Expected reciprocal rank (cascade model)."""
    err = 0.0
    p_continue = 1.0
    for i, h in enumerate(hits[:k]):
        rating = rated.get((h["_index"], h["_id"]), 0)
        r = (2 ** rating - 1) / (2 ** max_rating)
        err += p_continue * r / (i + 1)
        p_continue *= 1.0 - r
    return err


def rank_eval(node, index: str | None, body: dict) -> dict:
    body = body or {}
    requests = body.get("requests")
    if not isinstance(requests, list) or not requests:
        raise IllegalArgumentException("[rank_eval] requires [requests]")
    metric_conf = body.get("metric") or {"precision": {}}
    if len(metric_conf) != 1:
        raise IllegalArgumentException("[rank_eval] requires exactly one metric")
    metric_name, mconf = next(iter(metric_conf.items()))
    mconf = mconf or {}
    k = int(mconf.get("k", DEFAULT_K))

    details: dict[str, Any] = {}
    scores: list[float] = []
    failures: dict[str, Any] = {}
    for i, req in enumerate(requests):
        rid = str(req.get("id", i))
        rated = _ratings_map(req.get("ratings"))
        try:
            search_body = dict(req.get("request") or {})
            search_body.setdefault("size", max(k, DEFAULT_K))
            resp = node.search(index, search_body)
        except Exception as e:  # per-request failures reported, not fatal
            failures[rid] = {"error": str(e)}
            continue
        hits = resp["hits"]["hits"]
        if metric_name == "precision":
            score = _precision_at_k(
                hits, rated, k, int(mconf.get("relevant_rating_threshold", 1))
            )
        elif metric_name == "recall":
            score = _recall_at_k(
                hits, rated, k, int(mconf.get("relevant_rating_threshold", 1))
            )
        elif metric_name == "mean_reciprocal_rank":
            score = _mrr(
                hits, rated, k, int(mconf.get("relevant_rating_threshold", 1))
            )
        elif metric_name == "dcg":
            score = _dcg(hits, rated, k, bool(mconf.get("normalize", False)))
        elif metric_name == "expected_reciprocal_rank":
            score = _err(hits, rated, k, int(mconf.get("maximum_relevance", 3)))
        else:
            raise IllegalArgumentException(
                f"unknown rank-eval metric [{metric_name}]"
            )
        scores.append(score)
        unrated = [
            {"_index": h["_index"], "_id": h["_id"]}
            for h in hits[:k]
            if (h["_index"], h["_id"]) not in rated
        ]
        details[rid] = {
            "metric_score": score,
            "unrated_docs": unrated,
            "hits": [
                {
                    "hit": {"_index": h["_index"], "_id": h["_id"],
                            "_score": h.get("_score")},
                    "rating": rated.get((h["_index"], h["_id"])),
                }
                for h in hits[:k]
            ],
        }
    return {
        "metric_score": sum(scores) / len(scores) if scores else 0.0,
        "details": details,
        "failures": failures,
    }
