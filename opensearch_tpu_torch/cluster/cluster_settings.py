"""Dynamic cluster settings registry (ClusterSettings.java:205).

Counterpart of opensearch_tpu/cluster/cluster_settings.py, a copy with
its imports rewritten. The two-phase persistent/transient model: `PUT
/_cluster/settings` carries {"persistent": {...}, "transient": {...}};
values validate before they apply; null deletes a key. Effective value =
transient over persistent over default. Persistent settings survive a
restart; transient ones do not.
"""

from __future__ import annotations

from typing import Any, Callable

from opensearch_tpu_torch.common.errors import IllegalArgumentException


def _validate_pct(v: Any) -> None:
    pct = float(str(v).rstrip("%"))
    if not 0 <= pct <= 100:
        raise IllegalArgumentException(f"watermark [{v}] must be 0-100%")


def _validate_pos_int(v: Any) -> None:
    if int(v) < 1:
        raise IllegalArgumentException(f"[{v}] must be >= 1")


def _validate_enable(v: Any) -> None:
    if str(v).lower() not in ("all", "none", "primaries", "replicas"):
        raise IllegalArgumentException(
            f"[{v}] must be one of [all, none, primaries, replicas]"
        )


# registered dynamic cluster settings: key -> validator (None = any value)
DYNAMIC_CLUSTER_SETTINGS: dict[str, Callable[[Any], None] | None] = {
    "cluster.routing.allocation.node_concurrent_recoveries": _validate_pos_int,
    "cluster.routing.allocation.disk.watermark.low": _validate_pct,
    "cluster.routing.allocation.disk.watermark.high": _validate_pct,
    "cluster.routing.allocation.awareness.attributes": None,
    # cluster-level FilterAllocationDecider: comma-separated node NAMES to
    # drain (graceful decommission — shards relocate off, then the node
    # can leave with zero acked-write loss)
    "cluster.routing.allocation.exclude._name": None,
    "cluster.routing.allocation.enable": _validate_enable,
    "cluster.routing.rebalance.enable": _validate_enable,
    "search.max_buckets": _validate_pos_int,
    "search.max_keep_alive": None,
    "search.allow_expensive_queries": None,
    "search.default_keep_alive": None,
    "search.default_search_timeout": None,
    "cluster.max_shards_per_node": _validate_pos_int,
    "action.auto_create_index": None,
    "action.destructive_requires_name": None,
    "cluster.blocks.read_only": None,
    "indices.recovery.max_bytes_per_sec": None,
}


def _validate_backpressure_mode(v: Any) -> None:
    if str(v) not in ("monitor_only", "enforced", "disabled"):
        raise IllegalArgumentException(
            f"Invalid SearchBackpressureMode: {v}")


def _pos_double(key: str) -> Callable[[Any], None]:
    def validate(v: Any) -> None:
        if float(v) <= 0:
            raise IllegalArgumentException(f"{key} must be > 0")
    return validate


# search backpressure settings (SearchBackpressureSettings +
# SearchTaskSettings/SearchShardTaskSettings in the reference)
DYNAMIC_CLUSTER_SETTINGS["search_backpressure.mode"] = \
    _validate_backpressure_mode
for _task in ("search_task", "search_shard_task"):
    for _name, _v in [
        ("cancellation_burst", None),
        ("cancellation_rate",
         _pos_double(f"search_backpressure.{_task}.cancellation_rate")),
        ("cancellation_ratio",
         _pos_double(f"search_backpressure.{_task}.cancellation_ratio")),
        ("elapsed_time_millis_threshold", None),
        ("cpu_time_millis_threshold", None),
        ("heap_percent_threshold", None),
        ("total_heap_percent_threshold", None),
        ("heap_variance", None),
        ("heap_moving_average_window_size", None),
    ]:
        DYNAMIC_CLUSTER_SETTINGS[
            f"search_backpressure.{_task}.{_name}"] = _v
for _name in ("num_successive_breaches", "cpu_threshold", "heap_threshold"):
    DYNAMIC_CLUSTER_SETTINGS[f"search_backpressure.node_duress.{_name}"] = None

def _validate_with_setting(setting) -> Callable[[Any], None]:
    """Adapt a common.settings.Setting parser+validator to this registry."""
    def validate(v: Any) -> None:
        try:
            value = setting.parser(v)
        except (ValueError, TypeError):
            raise IllegalArgumentException(
                f"failed to parse value [{v!r}] for setting [{setting.key}]"
            ) from None
        if setting.validator is not None:
            try:
                setting.validator(value)
            except Exception as e:  # noqa: BLE001 - surface as 400
                raise IllegalArgumentException(str(e)) from None
    return validate


def _register_typed_settings() -> None:
    # kNN dispatch batcher (search/batcher.py) + ANN serving knobs
    # (search/ann.py) + request-cache budget: the Setting objects carry
    # parser/validator/default; the registry reuses them so
    # PUT /_cluster/settings validation cannot drift from the component's
    # own parsing
    from opensearch_tpu_torch.cluster.residency import ROUTING_SETTINGS
    from opensearch_tpu_torch.cluster.shard_mesh import MESH_SETTINGS
    from opensearch_tpu_torch.index.request_cache import CACHE_SIZE_SETTING
    from opensearch_tpu_torch.search.ann import ANN_SETTINGS
    from opensearch_tpu_torch.search.batcher import BATCH_SETTINGS
    from opensearch_tpu_torch.search.lanes import LANE_SETTINGS
    from opensearch_tpu_torch.telemetry.device_ledger import HEAT_SETTINGS
    from opensearch_tpu_torch.telemetry.export import TRACING_SETTINGS

    for s in (*BATCH_SETTINGS, *ANN_SETTINGS, CACHE_SIZE_SETTING,
              *TRACING_SETTINGS, *MESH_SETTINGS, *LANE_SETTINGS,
              *ROUTING_SETTINGS, *HEAT_SETTINGS):
        DYNAMIC_CLUSTER_SETTINGS[s.key] = _validate_with_setting(s)


_register_typed_settings()

# prefix-registered settings (affix settings in the reference —
# Setting.affixKeySetting): any key matching "<prefix>.<name>.<suffix>"
DYNAMIC_AFFIX_SETTINGS: list[tuple[str, str]] = [
    ("cluster.remote.", ".seeds"),
    ("cluster.remote.", ".skip_unavailable"),
]


def validate_settings(flat: dict[str, Any]) -> None:
    for key, value in flat.items():
        if any(key.startswith(p) and key.endswith(sfx)
               for p, sfx in DYNAMIC_AFFIX_SETTINGS):
            continue
        validator = DYNAMIC_CLUSTER_SETTINGS.get(key, "__missing__")
        if validator == "__missing__":
            raise IllegalArgumentException(
                f"unknown cluster setting [{key}] — not registered as a "
                f"dynamic setting"
            )
        if validator is not None and value is not None:
            validator(value)


def flatten(obj: dict, prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in (obj or {}).items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, f"{key}."))
        else:
            out[key] = v
    return out


def merge(current: dict, updates: dict) -> dict:
    """Apply a flat update map: null values delete keys."""
    out = dict(current)
    for k, v in updates.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = v
    return out


def effective(persistent: dict, transient: dict) -> dict:
    return {**persistent, **transient}


class SettingsUpdateConsumers:
    """addSettingsUpdateConsumer registry: notified on effective-value
    changes at state application."""

    def __init__(self) -> None:
        self._consumers: list[tuple[str, Callable[[dict], None]]] = []
        self._last: dict[str, Any] = {}

    def register(self, key_prefix: str,
                 consumer: Callable[[dict], None]) -> None:
        self._consumers.append((key_prefix, consumer))

    def apply(self, eff: dict) -> None:
        changed = {
            k for k in set(eff) | set(self._last)
            if eff.get(k) != self._last.get(k)
        }
        if not changed:
            return
        self._last = dict(eff)
        for prefix, consumer in self._consumers:
            if any(k.startswith(prefix) for k in changed):
                consumer(eff)
