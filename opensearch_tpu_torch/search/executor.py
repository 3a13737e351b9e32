"""Per-shard query-phase result types.

The pieces of opensearch_tpu/search/executor.py that the ported slice
needs: the hit and result records the serving path fills, and the geo
literal parser the query DSL uses. The per-shard executor itself (BM25,
filters, aggregations, the per-shard kNN path) is not yet ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any

import numpy as np

from opensearch_tpu_torch.common.errors import IllegalArgumentException


@dataclass
class ShardHit:
    score: float
    segment: int          # index into snapshot.segments
    doc: int              # local doc id
    sort_values: list = dc_field(default_factory=list)


@dataclass
class ShardQueryResult:
    hits: list[ShardHit]
    total: int
    max_score: float | None
    # per-segment match masks (host bool arrays) for the aggs phase
    masks: list[np.ndarray] = dc_field(default_factory=list)
    # per-segment score arrays (host f32, n_docs)
    score_arrays: list[np.ndarray] = dc_field(default_factory=list)


def _parse_geo_origin(origin: Any) -> tuple[float, float]:
    """(lat, lon) from the geo_point literal forms."""
    if isinstance(origin, dict) and "lat" in origin and "lon" in origin:
        return float(origin["lat"]), float(origin["lon"])
    if isinstance(origin, list) and len(origin) >= 2:
        return float(origin[1]), float(origin[0])  # [lon, lat]
    if isinstance(origin, str) and "," in origin:
        parts = origin.split(",")
        return float(parts[0]), float(parts[1])
    raise IllegalArgumentException(f"invalid geo origin [{origin!r}]")
