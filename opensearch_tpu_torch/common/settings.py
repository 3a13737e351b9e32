"""Typed, validated, scoped, dynamically-updatable settings.

Reimplements the model of the reference's config system
(server/src/main/java/org/opensearch/common/settings/Setting.java:109 and
ClusterSettings.java:205): every flag is a `Setting` object with a parser,
default, validator and scope properties; registries validate unknown keys and
dispatch update consumers when dynamic settings change.  SURVEY.md §5 calls
this "the best part of the config story" — we keep the exact model.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, Generic, TypeVar

T = TypeVar("T")


class Property(enum.Flag):
    """Mirrors Setting.Property in the reference."""

    NODE_SCOPE = enum.auto()
    INDEX_SCOPE = enum.auto()
    DYNAMIC = enum.auto()      # updatable at runtime via the settings API
    FINAL = enum.auto()        # can never be changed after creation
    DEPRECATED = enum.auto()
    PRIVATE_INDEX = enum.auto()  # not settable by users, only by the system


class SettingsException(Exception):
    pass


class Setting(Generic[T]):
    def __init__(
        self,
        key: str,
        default: T | Callable[["Settings"], T],
        parser: Callable[[Any], T],
        *props: Property,
        validator: Callable[[T], None] | None = None,
    ):
        self.key = key
        self._default = default
        self.parser = parser
        self.properties = Property(0)
        for p in props:
            self.properties |= p
        self.validator = validator
        if self.is_dynamic and self.is_final:
            raise SettingsException(f"setting [{key}] cannot be both dynamic and final")

    # -- property helpers -------------------------------------------------
    @property
    def is_dynamic(self) -> bool:
        return bool(self.properties & Property.DYNAMIC)

    @property
    def is_final(self) -> bool:
        return bool(self.properties & Property.FINAL)

    def has_node_scope(self) -> bool:
        return bool(self.properties & Property.NODE_SCOPE)

    def has_index_scope(self) -> bool:
        return bool(self.properties & Property.INDEX_SCOPE)

    # -- value access -----------------------------------------------------
    def default(self, settings: "Settings") -> T:
        if callable(self._default):
            return self._default(settings)
        return self._default

    def exists(self, settings: "Settings") -> bool:
        return self.key in settings

    def get(self, settings: "Settings") -> T:
        raw = settings.raw_get(self.key)
        if raw is None:
            value = self.default(settings)
        else:
            try:
                value = self.parser(raw)
            except (ValueError, TypeError) as e:
                raise SettingsException(
                    f"failed to parse value [{raw!r}] for setting [{self.key}]"
                ) from e
        if self.validator is not None:
            self.validator(value)
        return value

    def __repr__(self) -> str:
        return f"Setting({self.key})"

    # -- typed constructors (mirror Setting.intSetting etc.) --------------
    @staticmethod
    def bool_setting(key: str, default: bool, *props: Property) -> "Setting[bool]":
        def parse(v: Any) -> bool:
            if isinstance(v, bool):
                return v
            if isinstance(v, str):
                if v.lower() in ("true", "1"):
                    return True
                if v.lower() in ("false", "0"):
                    return False
            raise ValueError(f"cannot parse boolean [{v!r}]")

        return Setting(key, default, parse, *props)

    @staticmethod
    def int_setting(
        key: str,
        default: int,
        *props: Property,
        min_value: int | None = None,
        max_value: int | None = None,
    ) -> "Setting[int]":
        def validate(v: int) -> None:
            if min_value is not None and v < min_value:
                raise SettingsException(
                    f"failed to parse value [{v}] for setting [{key}] must be >= {min_value}"
                )
            if max_value is not None and v > max_value:
                raise SettingsException(
                    f"failed to parse value [{v}] for setting [{key}] must be <= {max_value}"
                )

        return Setting(key, default, int, *props, validator=validate)

    @staticmethod
    def float_setting(
        key: str, default: float, *props: Property, min_value: float | None = None
    ) -> "Setting[float]":
        def validate(v: float) -> None:
            if min_value is not None and v < min_value:
                raise SettingsException(
                    f"failed to parse value [{v}] for setting [{key}] must be >= {min_value}"
                )

        return Setting(key, default, float, *props, validator=validate)

    @staticmethod
    def string_setting(key: str, default: str, *props: Property) -> "Setting[str]":
        return Setting(key, default, str, *props)

    @staticmethod
    def time_setting(key: str, default_millis: int, *props: Property) -> "Setting[int]":
        """Value in milliseconds; accepts '30s', '1m', '500ms', bare ints."""
        return Setting(key, default_millis, parse_time_millis, *props)


_TIME_UNITS = {"ms": 1, "s": 1000, "m": 60_000, "h": 3_600_000, "d": 86_400_000}


def parse_time_millis(v: Any) -> int:
    if isinstance(v, (int, float)):
        return int(v)
    s = str(v).strip().lower()
    for suffix in ("ms", "s", "m", "h", "d"):
        if s.endswith(suffix):
            num = s[: -len(suffix)]
            return int(float(num) * _TIME_UNITS[suffix])
    return int(s)


_BYTE_UNITS = {"b": 1, "kb": 1024, "mb": 1024**2, "gb": 1024**3, "tb": 1024**4}


def parse_bytes(v: Any) -> int:
    if isinstance(v, (int, float)):
        return int(v)
    s = str(v).strip().lower()
    for suffix in ("kb", "mb", "gb", "tb", "b"):
        if s.endswith(suffix):
            num = s[: -len(suffix)]
            return int(float(num) * _BYTE_UNITS[suffix])
    return int(s)


class Settings:
    """An immutable flat key→raw-value map (the reference's Settings)."""

    EMPTY: "Settings"

    def __init__(self, values: dict[str, Any] | None = None):
        self._values: dict[str, Any] = dict(values or {})

    @staticmethod
    def builder() -> "SettingsBuilder":
        return SettingsBuilder()

    @staticmethod
    def from_flat(values: dict[str, Any]) -> "Settings":
        return Settings(values)

    @staticmethod
    def from_nested(obj: dict[str, Any], prefix: str = "") -> "Settings":
        """Flatten a nested JSON/YAML dict into dotted keys."""
        flat: dict[str, Any] = {}

        def walk(node: Any, path: str) -> None:
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{path}.{k}" if path else str(k))
            else:
                flat[path] = node

        walk(obj, prefix)
        return Settings(flat)

    def raw_get(self, key: str) -> Any:
        return self._values.get(key)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def keys(self):
        return self._values.keys()

    def as_dict(self) -> dict[str, Any]:
        return dict(self._values)

    def as_nested(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for key, value in sorted(self._values.items()):
            parts = key.split(".")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
                if not isinstance(node, dict):
                    raise SettingsException(
                        f"setting [{key}] conflicts with a leaf value at [{p}]"
                    )
            if isinstance(node.get(parts[-1]), dict):
                raise SettingsException(
                    f"leaf setting [{key}] conflicts with object at the same path"
                )
            node[parts[-1]] = value
        return out

    def filtered_by_prefix(self, prefix: str) -> "Settings":
        return Settings(
            {k: v for k, v in self._values.items() if k.startswith(prefix)}
        )

    def merged_with(self, other: "Settings") -> "Settings":
        merged = dict(self._values)
        merged.update(other._values)
        return Settings(merged)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Settings) and self._values == other._values

    def __hash__(self) -> int:
        return hash(frozenset((k, repr(v)) for k, v in self._values.items()))

    def __repr__(self) -> str:
        return f"Settings({self._values})"


Settings.EMPTY = Settings()


class SettingsBuilder:
    def __init__(self) -> None:
        self._values: dict[str, Any] = {}

    def put(self, key: str, value: Any) -> "SettingsBuilder":
        self._values[str(key)] = value
        return self

    def put_all(self, settings: "Settings | dict[str, Any]") -> "SettingsBuilder":
        if isinstance(settings, Settings):
            self._values.update(settings.as_dict())
        else:
            self._values.update(settings)
        return self

    def remove(self, key: str) -> "SettingsBuilder":
        self._values.pop(key, None)
        return self

    def build(self) -> Settings:
        return Settings(self._values)


class AbstractScopedSettings:
    """Registry of known settings for one scope + dynamic-update dispatch.

    Mirrors ClusterSettings/IndexScopedSettings
    (common/settings/AbstractScopedSettings.java): validates keys against the
    registry and notifies registered consumers when a dynamic value changes.
    """

    def __init__(self, settings: Settings, registered: list[Setting]):
        self._registry: dict[str, Setting] = {}
        for s in registered:
            if s.key in self._registry:
                raise SettingsException(f"duplicate setting [{s.key}]")
            self._registry[s.key] = s
        self._current = settings
        self._update_consumers: list[tuple[Setting, Callable[[Any], None]]] = []
        self.validate(settings, validate_dynamic=False)

    @property
    def current(self) -> Settings:
        return self._current

    def get_setting(self, key: str) -> Setting | None:
        return self._registry.get(key)

    def get(self, setting: Setting[T]) -> T:
        if setting.key not in self._registry:
            raise SettingsException(f"setting [{setting.key}] not registered")
        return setting.get(self._current)

    def validate(self, settings: Settings, validate_dynamic: bool) -> None:
        for key in settings.keys():
            setting = self._registry.get(key)
            if setting is None:
                raise SettingsException(f"unknown setting [{key}]")
            if validate_dynamic and not setting.is_dynamic:
                raise SettingsException(
                    f"final or non-dynamic setting [{key}] cannot be updated"
                )
            setting.get(settings)  # parse + validate value

    def add_settings_update_consumer(
        self, setting: Setting[T], consumer: Callable[[T], None]
    ) -> None:
        if setting.key not in self._registry:
            raise SettingsException(f"setting [{setting.key}] not registered")
        if not setting.is_dynamic:
            raise SettingsException(f"setting [{setting.key}] is not dynamic")
        self._update_consumers.append((setting, consumer))

    def apply_settings(self, update: Settings) -> Settings:
        """Two-phase apply: validate everything, then swap + notify consumers.

        A failing consumer cannot block other consumers or desync the
        registry: all consumers run, and failures are re-raised at the end
        (the reference validates updaters pre-commit and logs applier
        failures; we aggregate and surface them).
        """
        self.validate(update, validate_dynamic=True)
        new_settings = self._current.merged_with(update)
        changed: list[tuple[Callable[[Any], None], Any]] = []
        for setting, consumer in self._update_consumers:
            if setting.key in update:
                changed.append((consumer, setting.get(new_settings)))
        self._current = new_settings
        failures: list[BaseException] = []
        for consumer, value in changed:
            try:
                consumer(value)
            except Exception as e:  # noqa: BLE001 - consumer isolation
                failures.append(e)
        if failures:
            raise SettingsException(
                f"{len(failures)} settings update consumer(s) failed: {failures[0]}"
            ) from failures[0]
        return new_settings


class ClusterSettings(AbstractScopedSettings):
    """Node/cluster-scope registry (ClusterSettings.java:205)."""


class IndexScopedSettings(AbstractScopedSettings):
    """Per-index registry (IndexScopedSettings.java)."""


def setting_str(v):
    """Canonical string rendering of one setting value (the reference
    renders every Setting as its string form: booleans lowercase, numbers
    via toString)."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float, str)):
        return str(v)
    return v  # lists / structured values (e.g. analysis) stay as-is


def settings_section(flat_map: dict, flat: bool) -> dict:
    """Stringified flat or re-nested view of one settings section — the
    shared response shaping for GET/PUT settings APIs (single-node and
    cluster facade)."""
    out = {k: setting_str(v) for k, v in flat_map.items()}
    return out if flat else Settings.from_flat(out).as_nested()
