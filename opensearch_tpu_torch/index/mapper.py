"""Mappings: field types, document parsing, dynamic mapping.

The analog of the reference's mapper layer
(server/src/main/java/org/opensearch/index/mapper/ — MapperService,
DocumentMapper, DocumentParser.java:66, MappedFieldType subclasses): a
MapperService owns the schema for one index, parses JSON documents into typed
per-field values ("LuceneDocument fields" become typed column/posting inputs
for the segment builder), infers mappings dynamically, and validates merges.

Field value encodings chosen for the TPU segment layout:
- text      -> analyzed terms (postings + doc length norm)
- keyword   -> ordinal doc-values + exact-term postings
- long/integer/short/byte/date -> int64 doc-values column
- double/float/half_float      -> float64 doc-values column
- boolean   -> int64 column (0/1)
- dense_vector -> row in the segment's [n, dims] matrix
"""

from __future__ import annotations

import datetime as _dt
import math
from dataclasses import dataclass, field as dc_field
from typing import Any

from opensearch_tpu_torch.common.errors import (
    IllegalArgumentException,
    MapperParsingException,
    StrictDynamicMappingException,
)
from opensearch_tpu_torch.index.analysis import AnalysisRegistry, Analyzer

INT_TYPES = {"long", "integer", "short", "byte"}
FLOAT_TYPES = {"double", "float", "half_float"}
NUMERIC_TYPES = INT_TYPES | FLOAT_TYPES
# range families (RangeFieldMapper.java): each value is an interval stored
# as TWO synthetic numeric columns `field#lo` / `field#hi`; range queries
# evaluate intersects/contains/within against the pair
RANGE_TYPES = {"integer_range", "long_range", "float_range", "double_range",
               "date_range", "ip_range"}

# discrete domains step whole units on gt/lt; floats step one ulp
_RANGE_DISCRETE = {"integer_range", "long_range", "date_range", "ip_range"}


def _ip_ord(value: str) -> int:
    """Total order over IP addresses in int64. IPv4 maps raw (< 2^32);
    IPv6 folds its top bits above a 2^62 flag — coarse within v6 (bottom
    66 bits dropped) but order-preserving, and all v4 sorts below all v6."""
    import ipaddress

    ip = ipaddress.ip_address(str(value))
    v = int(ip)
    if ip.version == 6:
        return (1 << 62) + (v >> 66)
    return v


def range_value_bounds(rtype: str, value: dict,
                       fmt: str | None = None) -> tuple:
    """(lo, hi) numeric bounds for one range VALUE or QUERY body with
    gte/gt/lte/lt keys; missing sides are unbounded. CIDR strings expand
    for ip_range."""
    import math

    def one(raw, round_up: bool):
        if rtype in ("integer_range", "long_range"):
            return int(raw)
        if rtype == "date_range":
            if isinstance(raw, str):
                # date-math with per-side rounding (DateMathParser: upper
                # bounds round to the last ms of the unit)
                from opensearch_tpu_torch.common.timeutil import parse_date_math

                return parse_date_math(raw, round_up=round_up)
            return int(raw)
        if rtype == "ip_range":
            return _ip_ord(raw)
        return float(raw)

    lo = hi = None
    if isinstance(value, str):
        if rtype != "ip_range":
            raise ValueError(
                f"[{rtype}] values must be objects with gte/gt/lte/lt")
        if "/" in value:
            import ipaddress

            net = ipaddress.ip_network(value, strict=False)
            return (_ip_ord(net.network_address),
                    _ip_ord(net.broadcast_address))
        v = _ip_ord(value)  # single address == one-point range
        return v, v
    if value.get("gte") is not None:
        lo = one(value["gte"], round_up=False)
    elif value.get("gt") is not None:
        v = one(value["gt"], round_up=True)
        lo = v + 1 if rtype in _RANGE_DISCRETE else math.nextafter(
            v, math.inf)
    if value.get("lte") is not None:
        hi = one(value["lte"], round_up=True)
    elif value.get("lt") is not None:
        v = one(value["lt"], round_up=False)
        hi = v - 1 if rtype in _RANGE_DISCRETE else math.nextafter(
            v, -math.inf)
    if rtype in _RANGE_DISCRETE:
        # open sides sit at the true int64 domain edges — above every
        # IPv6 ordinal and every storable long
        if lo is None:
            lo = -(2**63)
        if hi is None:
            hi = 2**63 - 1
    else:
        if lo is None:
            lo = -math.inf
        if hi is None:
            hi = math.inf
    return lo, hi



_INT_RANGES = {
    "long": (-(2**63), 2**63 - 1),
    "integer": (-(2**31), 2**31 - 1),
    "short": (-(2**15), 2**15 - 1),
    "byte": (-(2**7), 2**7 - 1),
}


@dataclass
class FieldMapper:
    """One mapped field (a MappedFieldType + its Mapper in the reference)."""

    name: str
    type: str
    analyzer: str = "standard"
    search_analyzer: str | None = None
    index: bool = True
    doc_values: bool = True
    store: bool = False
    # dense_vector
    dims: int = 0
    similarity: str = "l2_norm"  # l2_norm | cosine | dot_product
    # ANN method config (k-NN plugin style): {"name": "ivf_pq",
    # "parameters": {"nlist": .., "m": .., "nprobe": ..}}; None = exact
    method: dict | None = None
    # original type was "completion" (stored keyword-style; the suggester
    # prefix-matches its values and object-form {input, weight} is accepted)
    completion: bool = False
    # join field (parent-join module analog): {"parent_type": [children]}
    relations: dict | None = None
    # internal column generated by the engine (join #name/#parent), hidden
    # from GET _mapping and not persisted through to_dict round-trips
    synthetic: bool = False
    # date
    format: str = "strict_date_optional_time||epoch_millis"
    # extra sub-fields ("fields": {"raw": {"type": "keyword"}})
    fields: dict[str, "FieldMapper"] = dc_field(default_factory=dict)
    # the declared type when it maps to a storage-compatible internal type
    # (e.g. search_as_you_type -> text); GET _mapping must echo the original
    original_type: str | None = None
    # field alias (alias type): dotted path of the concrete target field
    path: str | None = None
    # keyword normalizer ("lowercase" supported; applied index- and
    # query-side like the reference's normalizer analysis chain)
    normalizer: str | None = None
    # ignore_malformed: None = inherit index.mapping.ignore_malformed
    ignore_malformed: bool | None = None
    # date resolution: "millis" (date) | "nanos" (date_nanos)
    resolution: str = "millis"
    # user-attached field metadata ({"meta": {...}} — echoed by GET _mapping)
    meta: dict | None = None
    # constant_keyword: the single value every document carries
    const_value: Any = None
    # search_as_you_type shingle subfields: tokens join into n-grams of
    # this size before indexing (ShingleFieldMapper analog)
    shingle_size: int = 0
    # text fielddata (TextFieldMapper.fielddata): enables sort/agg columnar
    # access on a text field; surfaced by GET /_cat/fielddata
    fielddata: bool = False

    def to_dict(self) -> dict:
        out: dict[str, Any] = {
            "type": self.original_type or (
                "completion" if self.completion else self.type
            )
        }
        if self.type == "alias" and self.path:
            out["path"] = self.path
        if self.normalizer:
            out["normalizer"] = self.normalizer
        if self.meta:
            out["meta"] = self.meta
        if self.original_type == "constant_keyword" and \
                self.const_value is not None:
            out["value"] = self.const_value
        if self.type == "join" and self.relations:
            out["relations"] = self.relations
        if self.type == "text" and self.analyzer != "standard":
            out["analyzer"] = self.analyzer
        if self.type == "text" and self.fielddata:
            out["fielddata"] = True
        if self.search_analyzer and self.search_analyzer != self.analyzer:
            out["search_analyzer"] = self.search_analyzer
        if self.type == "dense_vector" or self.type == "knn_vector":
            out["dims"] = self.dims
            out["similarity"] = self.similarity
            if self.method:
                out["method"] = self.method
        if not self.index:
            out["index"] = False
        visible = {n: m for n, m in self.fields.items()
                   if not m.shingle_size}
        if visible:
            out["fields"] = {n: m.to_dict() for n, m in visible.items()}
        return out


@dataclass
class ParsedField:
    """Typed value(s) extracted from one document field."""

    terms: list[str] | None = None        # text: analyzed term stream
    positions: list[int] | None = None    # text: token position per term
    exact: list[str] | None = None        # keyword: untokenized values
    numeric: list[float] | None = None    # numeric/date/boolean column values
    vector: list[float] | None = None     # dense_vector row


# position gap between successive values of a multi-valued text field, so
# phrases never match across array entries (Lucene's position_increment_gap
# default, TextFieldMapper.Defaults.POSITION_INCREMENT_GAP)
POSITION_INCREMENT_GAP = 100


@dataclass
class ParsedDocument:
    doc_id: str
    source: dict
    fields: dict[str, ParsedField]
    routing: str | None = None
    # completion object form {"input": ..., "weight": N}: weight per input
    # value, consumed by the completion suggester's (-weight, text) ranking
    # (the reference persists weight in the FST; we persist it per segment)
    completion_weights: dict[str, dict[str, int]] = dc_field(default_factory=dict)


# epoch range guard so dates stay in int64 millis
_MAX_MILLIS = 2**62
_MAX_NANOS = 2**63 - 1  # ~2262-04-11; date_nanos hard ceiling


def parse_date_nanos(value: Any) -> int:
    """Epoch NANOS for date_nanos fields (DateFieldMapper.Resolution.NANOS):
    full nanosecond precision from the string's fractional digits; values
    before 1970 or after 2262 are rejected like the reference."""
    if isinstance(value, bool):
        raise ValueError("booleans are not dates")
    if isinstance(value, (int, float)):
        # numeric input is epoch millis (the reference's parsing default)
        ns = int(value) * 1_000_000
        if not 0 <= ns <= _MAX_NANOS:
            raise ValueError(f"date_nanos out of range: {value}")
        return ns
    s = str(value).strip()
    if s.lstrip("-").isdigit():
        ns = int(s) * 1_000_000
        if not 0 <= ns <= _MAX_NANOS:
            raise ValueError(f"date_nanos out of range: {value}")
        return ns
    frac_ns = 0
    base = s
    m = _re_frac.search(s)
    if m:
        digits = m.group(1)[:9].ljust(9, "0")
        frac_ns = int(digits)
        base = s[: m.start()] + s[m.end():]
    ms = parse_date_millis(base)
    ns = ms * 1_000_000 + frac_ns
    if ns < 0:
        raise ValueError(
            f"date[{s}] is before the epoch in 1970 and cannot be "
            f"stored in nanosecond resolution"
        )
    if ns > _MAX_NANOS:
        raise ValueError(
            f"date[{s}] is after 2262-04-11T23:47:16.854775807 and "
            f"cannot be stored in nanosecond resolution"
        )
    return ns


import re as _re_mod

# ANN method config (k-NN plugin style) accepted on dense_vector fields.
# Only the IVF-PQ family is validated strictly — the index build at publish
# time (index/device._maybe_build_ann) consumes exactly these parameters,
# so a typo'd key or an impossible shape must 400 at mapping time, not
# fail (or be silently ignored by) the refresh-time build.
_IVF_METHOD_NAMES = {"ivf_pq", "ivfpq", "ivf"}
_IVF_INT_PARAMS = {"nlist", "m", "code_size", "ks", "nprobe", "min_train",
                   "iters"}


def validate_ann_method(full: str, method: dict, dims: int) -> None:
    name = str(method.get("name", "")).lower().replace("-", "_")
    if name not in _IVF_METHOD_NAMES:
        return  # other engines' configs pass through untouched
    params = method.get("parameters")
    if params is None:
        return
    if not isinstance(params, dict):
        raise MapperParsingException(
            f"[method.parameters] of field [{full}] must be an object"
        )
    for key, value in params.items():
        if key not in _IVF_INT_PARAMS:
            raise MapperParsingException(
                f"unknown [method.parameters] key [{key}] for ivf_pq "
                f"field [{full}] (known: {sorted(_IVF_INT_PARAMS)})"
            )
        if isinstance(value, bool) or not isinstance(value, int) \
                or value < 1:
            raise MapperParsingException(
                f"[method.parameters.{key}] of field [{full}] must be a "
                f"positive integer, got [{value!r}]"
            )
    m = params.get("m", params.get("code_size"))
    if m is not None and dims % int(m) != 0:
        raise MapperParsingException(
            f"[method.parameters.m]=[{m}] of field [{full}] must divide "
            f"the vector dimension [{dims}]"
        )

_re_frac = _re_mod.compile(r"\.(\d+)")


def parse_date_millis(value: Any) -> int:
    """strict_date_optional_time || epoch_millis, like the reference default."""
    if isinstance(value, bool):
        raise ValueError("booleans are not dates")
    if isinstance(value, (int, float)):
        v = int(value)
        if abs(v) > _MAX_MILLIS:
            raise ValueError(f"epoch_millis out of range: {value}")
        return v
    s = str(value).strip()
    if s.lstrip("-").isdigit():
        return int(s)
    # ISO-8601 family
    txt = s.replace("Z", "+00:00")
    try:
        dt = _dt.datetime.fromisoformat(txt)
    except ValueError:
        # date-only variants fromisoformat already handles in 3.11+; re-raise
        raise ValueError(f"failed to parse date field [{s}]")
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return int(dt.timestamp() * 1000)


_GEOHASH32 = "0123456789bcdefghjkmnpqrstuvwxyz"


def _geohash_decode(h: str) -> tuple[float, float]:
    """(lat, lon) cell center of a geohash (GeoHashUtils.decode)."""
    lat_lo, lat_hi = -90.0, 90.0
    lon_lo, lon_hi = -180.0, 180.0
    even = True
    for ch in h.lower():
        idx = _GEOHASH32.index(ch)  # ValueError on bad chars -> malformed
        for bit in (16, 8, 4, 2, 1):
            if even:
                mid = (lon_lo + lon_hi) / 2
                if idx & bit:
                    lon_lo = mid
                else:
                    lon_hi = mid
            else:
                mid = (lat_lo + lat_hi) / 2
                if idx & bit:
                    lat_lo = mid
                else:
                    lat_hi = mid
            even = not even
    return (lat_lo + lat_hi) / 2, (lon_lo + lon_hi) / 2


def _parse_boolean(value: Any) -> int:
    if isinstance(value, bool):
        return 1 if value else 0
    if isinstance(value, str):
        if value == "true":
            return 1
        if value == "false" or value == "":
            return 0
    raise ValueError(f"failed to parse boolean [{value!r}]")


class MapperService:
    """Schema owner for one index (MapperService + DocumentParser)."""

    def __init__(
        self,
        mappings: dict | None = None,
        analysis_registry: AnalysisRegistry | None = None,
    ):
        self.analysis = analysis_registry or AnalysisRegistry()
        self.mappers: dict[str, FieldMapper] = {}
        self.dynamic: str | bool = True  # True | False | "strict"
        self._source_enabled = True
        self.dynamic_raw = None  # declared `dynamic` string for GET _mapping
        # [{name: {match/path_match/match_mapping_type, mapping}}]
        self.dynamic_templates: list = []
        # dotted paths declared `nested` (the nested-docs limit applies)
        self.nested_paths: set[str] = set()
        # index.mapping.ignore_malformed default (field-level overrides)
        self.ignore_malformed_default = False
        if mappings:
            self.merge(mappings)

    # -- mapping CRUD ------------------------------------------------------

    def merge(self, mappings: dict) -> None:
        """Apply a mappings dict {"properties": {...}, "dynamic": ...}."""
        if "dynamic" in mappings:
            d = mappings["dynamic"]
            if d not in (True, False, "true", "false", "strict",
                         "strict_allow_templates", "false_allow_templates"):
                raise MapperParsingException(f"invalid dynamic value [{d}]")
            # *_allow_templates variants behave like their base value except
            # for dynamic templates (which always apply)
            self.dynamic = {
                "true": True, "false": False,
                "false_allow_templates": False,
                "strict_allow_templates": "strict",
            }.get(d, d)
            # GET _mapping echoes the declared string verbatim
            self.dynamic_raw = d
        if "dynamic_templates" in mappings:
            self.dynamic_templates = list(mappings["dynamic_templates"] or [])
        src = mappings.get("_source")
        if isinstance(src, dict) and "enabled" in src:
            self._source_enabled = bool(src["enabled"])
        for name, conf in (mappings.get("properties") or {}).items():
            self._merge_field("", name, conf)

    def _merge_field(self, prefix: str, name: str, conf: dict) -> None:
        if name == "":
            raise IllegalArgumentException(
                "field name cannot be an empty string"
            )
        full = f"{prefix}{name}"
        if "properties" in conf and "type" not in conf:
            # object field: flatten children with dotted names
            for child, child_conf in conf["properties"].items():
                self._merge_field(f"{full}.", child, child_conf)
            return
        ftype = conf.get("type")
        if ftype is None:
            raise MapperParsingException(f"no type specified for field [{full}]")
        if ftype == "knn_vector":  # k-NN plugin compat alias
            ftype = "dense_vector"
        if ftype in ("object", "nested"):
            # object: children flatten with dotted names. nested flattens
            # the same way — the per-object match scoping of true nested
            # docs is NOT modeled; nested queries reject loudly instead of
            # matching wrongly (index/mapper/ObjectMapper vs NestedDocs)
            if ftype == "nested":
                self.nested_paths.add(full)
            for child, child_conf in (conf.get("properties") or {}).items():
                self._merge_field(f"{full}.", child, child_conf)
            return
        # storage-compatible aliases: same indexing/search behavior at this
        # engine's fidelity (type-specific refinements are mapper TODOs)
        declared = ftype
        ftype = {
            "unsigned_long": "long",
            "half_float": "float",
            "scaled_float": "double",
            "constant_keyword": "keyword",
            "wildcard": "keyword",
            "ip": "keyword",
            "binary": "keyword",
            "date_nanos": "date",
        }.get(ftype, ftype)
        known = (
            {"text", "keyword", "date", "boolean", "dense_vector",
             "match_only_text", "completion", "search_as_you_type",
             "percolator", "join", "alias", "flat_object", "token_count",
             "geo_point", "rank_feature", "rank_features"}
            | RANGE_TYPES
            | NUMERIC_TYPES
        )
        if ftype not in known:
            raise MapperParsingException(
                f"No handler for type [{ftype}] declared on field [{full}]"
            )
        if ftype in ("match_only_text", "search_as_you_type"):
            ftype = "text"

        if declared == "flat_object":
            bad = [k for k in ("analyzer", "search_analyzer", "normalizer",
                               "ignore_above") if k in conf]
            if bad:
                rendered = ", ".join(f"{k} : {conf[k]}" for k in bad)
                raise MapperParsingException(
                    f"Mapping definition for [{full}] has unsupported "
                    f"parameters:  [{rendered}]"
                )
        original_type = declared if declared != ftype else None
        if ftype == "alias":
            target = conf.get("path")
            if not isinstance(target, str) or not target:
                raise MapperParsingException(
                    f"field alias [{full}] requires [path]"
                )
            self.mappers[full] = FieldMapper(full, "alias", path=target)
            return
        is_completion = ftype == "completion"
        if is_completion:
            # completion inputs are stored whole like keywords; the suggester
            # prefix-matches over the keyword ordinals (the FST analog)
            ftype = "keyword"
        relations = None
        if ftype == "join":
            raw = conf.get("relations")
            if not isinstance(raw, dict) or not raw:
                raise MapperParsingException(
                    f"join field [{full}] requires [relations]"
                )
            relations = {
                p: (c if isinstance(c, list) else [c]) for p, c in raw.items()
            }
        mapper = FieldMapper(
            name=full,
            type=ftype,
            completion=is_completion,
            relations=relations,
            original_type=original_type,
            resolution="nanos" if declared == "date_nanos" else "millis",
            meta=conf.get("meta") if isinstance(conf.get("meta"), dict) else None,
            const_value=(conf.get("value")
                         if declared == "constant_keyword" else None),
            normalizer=conf.get("normalizer"),
            ignore_malformed=(bool(conf["ignore_malformed"])
                              if "ignore_malformed" in conf else None),
            analyzer=conf.get("analyzer", "standard"),
            search_analyzer=conf.get("search_analyzer"),
            index=conf.get("index", True),
            doc_values=conf.get("doc_values", True),
            store=conf.get("store", False),
            dims=int(conf.get("dims", conf.get("dimension", 0))),
            similarity=conf.get("similarity", conf.get("space_type", "l2_norm")),
            method=conf.get("method") if isinstance(conf.get("method"), dict) else None,
            format=conf.get("format", "strict_date_optional_time||epoch_millis"),
            fielddata=bool(conf.get("fielddata", False)),
        )
        if ftype == "dense_vector" and mapper.dims <= 0:
            raise MapperParsingException(
                f"dense_vector field [{full}] requires positive [dims]"
            )
        if ftype == "dense_vector" and mapper.method is not None:
            validate_ann_method(full, mapper.method, mapper.dims)
        existing = self.mappers.get(full)
        if existing is not None and existing.type != mapper.type:
            raise IllegalArgumentException(
                f"mapper [{full}] cannot be changed from type "
                f"[{existing.type}] to [{mapper.type}]"
            )
        # multi-fields: registered globally (queries address "f.sub", the
        # segment builder emits their columns) AND recorded on the parent
        # so (a) parse fans values out to them and (b) GET _mapping renders
        # them under "fields" instead of as object children
        for sub, sub_conf in (conf.get("fields") or {}).items():
            self._merge_field(f"{full}.", sub, sub_conf)
            sub_mapper = self.mappers.get(f"{full}.{sub}")
            if sub_mapper is not None:
                sub_mapper.synthetic = True
                mapper.fields[sub] = sub_mapper
        if declared == "search_as_you_type":
            # shingle subfields SearchAsYouTypeFieldMapper always creates;
            # indexed via the multi-field fan-out, hidden from GET _mapping
            for sub, size in (("_2gram", 2), ("_3gram", 3),
                              ("_index_prefix", 1)):
                sub_name = f"{full}.{sub}"
                sub_mapper = FieldMapper(
                    sub_name, "text", synthetic=True, shingle_size=size,
                    analyzer=conf.get("analyzer", "standard"),
                )
                self.mappers[sub_name] = sub_mapper
                mapper.fields[sub] = sub_mapper
        self.mappers[full] = mapper

    def field_mapper(self, name: str) -> FieldMapper | None:
        """Mapper for a field, following alias paths (the reference resolves
        aliases in QueryShardContext.fieldMapper). Segment columns are
        shared by reference under the alias name, so callers can keep using
        the queried name for column lookups."""
        m = self.mappers.get(name)
        seen = 0
        while m is not None and m.type == "alias" and m.path and seen < 4:
            m = self.mappers.get(m.path)
            seen += 1
        return m

    def to_dict(self) -> dict:
        props: dict[str, Any] = {}
        for name, m in sorted(self.mappers.items()):
            if m.synthetic:
                continue  # engine-internal columns (join #name/#parent)
            # re-nest dotted names into object properties
            parts = name.split(".")
            node = props
            for p in parts[:-1]:
                node = node.setdefault(p, {}).setdefault("properties", {})
            node[parts[-1]] = m.to_dict()
        out: dict[str, Any] = {"properties": props}
        if self.dynamic_templates:
            out["dynamic_templates"] = self.dynamic_templates
        if self.dynamic is not True:
            out["dynamic"] = (self.dynamic_raw if self.dynamic_raw is not None
                              else self.dynamic)
        return out

    # -- document parsing --------------------------------------------------

    def _analyzer_for(self, mapper: FieldMapper, search: bool = False) -> Analyzer:
        name = (mapper.search_analyzer if search else None) or mapper.analyzer
        return self.analysis.get(name)

    def parse_document(
        self, doc_id: str, source: dict, routing: str | None = None
    ) -> ParsedDocument:
        """DocumentParser.parseDocument:78 — JSON → typed field values,
        applying dynamic mapping for unseen fields."""
        fields: dict[str, ParsedField] = {}
        cw: dict[str, dict[str, int]] = {}
        self._parse_object(source, "", fields, cw)
        # constant_keyword: absent fields still carry the constant
        for fname, m in self.mappers.items():
            if m.original_type == "constant_keyword" \
                    and m.const_value is not None and fname not in fields:
                fields[fname] = ParsedField(exact=[str(m.const_value)])
        return ParsedDocument(doc_id=doc_id, source=source, fields=fields,
                              routing=routing, completion_weights=cw)

    def _parse_object(self, obj: dict, prefix: str, out: dict[str, ParsedField],
                      cw: dict[str, dict[str, int]] | None = None) -> None:
        for key, value in obj.items():
            full = f"{prefix}{key}"
            if isinstance(value, list) and any(
                isinstance(v, dict) for v in value
            ):
                # arrays of objects: each element indexes independently
                # (DocumentParser.parseArray — fields flatten to
                # multi-valued dotted columns)
                for item in value:
                    self._parse_field_entry(full, item, out, cw)
                continue
            self._parse_field_entry(full, value, out, cw)

    def _parse_field_entry(self, full: str, value: Any,
                           out: dict[str, ParsedField],
                           cw: dict[str, dict[str, int]] | None = None) -> None:
        """Index one field entry (scalar, array of scalars, or one object
        of an object array) under its dotted name."""
        leaf = full.rsplit(".", 1)[-1]
        if leaf == "" or set(leaf) <= {"."}:
            raise MapperParsingException(
                f"field name cannot contain only the character [.]"
            )
        if isinstance(value, dict):
            mapper = self.mappers.get(full)
            if mapper is not None and mapper.type == "dense_vector":
                raise MapperParsingException(
                    f"dense_vector field [{full}] must be an array of numbers"
                )
            if mapper is not None and mapper.completion:
                # completion object form: {"input": str|[str], "weight": N}
                inputs = value.get("input")
                if inputs is None:
                    raise MapperParsingException(
                        f"completion field [{full}] object form requires [input]"
                    )
                if isinstance(inputs, str):
                    inputs = [inputs]
                if cw is not None and "weight" in value:
                    raw_w = value["weight"]
                    try:
                        if isinstance(raw_w, (bool, float)):
                            raise ValueError
                        w = int(str(raw_w), 10)
                    except ValueError:
                        raise MapperParsingException(
                            f"weight must be an integer, but was [{raw_w}]"
                        ) from None
                    slot = cw.setdefault(full, {})
                    for inp in inputs:
                        slot[str(inp)] = max(slot.get(str(inp), 0), w)
                self._parse_value(mapper, full, inputs, out)
                return
            if mapper is not None and mapper.type == "join":
                self._parse_join(mapper, full, value, out)
                return
            if mapper is not None and mapper.type == "percolator":
                return  # the query lives in _source; nothing is indexed
            if mapper is not None and mapper.type == "flat_object":
                self._parse_flat_object(full, value, out)
                return
            if mapper is not None and mapper.type == "rank_features":
                for key, v in value.items():
                    x = float(v)
                    if x <= 0:
                        raise MapperParsingException(
                            f"[rank_features] fields must be positive, "
                            f"got [{v}] for [{key}]"
                        )
                    fname = f"{full}.{key}"
                    self.mappers.setdefault(
                        fname,
                        FieldMapper(fname, "float", synthetic=True),
                    )
                    pf2 = out.setdefault(fname, ParsedField())
                    pf2.numeric = (pf2.numeric or []) + [x]
                return
            if mapper is not None and mapper.type in RANGE_TYPES:
                self._parse_range(mapper, full, value, out)
                return
            if mapper is not None and mapper.type == "geo_point":
                self._parse_geo_point(full, value, out)
                return
            self._parse_object(value, f"{full}.", out, cw)
            return
        mapper = self.mappers.get(full)
        if mapper is None:
            mapper = self._dynamic_mapper(full, value)
            if mapper is None:
                return  # dynamic: false -> ignore; strict raises inside
            self.mappers[full] = mapper
        if mapper.type == "join":
            self._parse_join(mapper, full, value, out)
        elif mapper.type == "percolator":
            pass  # query stays in _source only
        elif mapper.type in RANGE_TYPES:
            self._parse_range(mapper, full, value, out)  # e.g. CIDR string
        elif mapper.type == "alias":
            pass  # aliases hold no values
        elif mapper.type == "geo_point":
            self._parse_geo_point(full, value, out)
        elif mapper.type == "flat_object":
            self._parse_flat_object(full, value, out)
        else:
            self._parse_value(mapper, full, value, out)

    def _parse_range(self, mapper: FieldMapper, full: str, value: Any,
                     out: dict[str, ParsedField]) -> None:
        """Range value ({gte/gt/lte/lt} object, or a CIDR string for
        ip_range) -> synthetic `{field}#lo` / `{field}#hi` numeric columns
        (RangeFieldMapper encodes the same interval into BKD dimensions)."""
        if value is None:
            return
        if not isinstance(value, (dict, str)):
            raise MapperParsingException(
                f"range field [{full}] requires an object with "
                f"gte/gt/lte/lt bounds"
            )
        try:
            lo, hi = range_value_bounds(mapper.type, value, mapper.format)
        except (ValueError, TypeError) as e:
            raise MapperParsingException(
                f"failed to parse range field [{full}]: {e}"
            ) from None
        kind = "double" if mapper.type in ("float_range", "double_range") \
            else "long"
        for suffix, v in (("#lo", lo), ("#hi", hi)):
            fname = f"{full}{suffix}"
            self.mappers.setdefault(
                fname, FieldMapper(fname, kind, synthetic=True)
            )
            pf = out.setdefault(fname, ParsedField())
            pf.numeric = (pf.numeric or []) + [v]

    def _parse_join(self, mapper: FieldMapper, full: str, value: Any,
                    out: dict[str, ParsedField]) -> None:
        """join value: "parent_name" or {"name": .., "parent": ..} — stored
        as synthetic keyword columns {field}#name / {field}#parent (the
        parent-join module keeps them as doc-values the same way)."""
        if isinstance(value, str):
            name, parent = value, None
        elif isinstance(value, dict) and "name" in value:
            name, parent = str(value["name"]), value.get("parent")
        else:
            raise MapperParsingException(
                f"join field [{full}] requires a relation name"
            )
        known = set(mapper.relations or {})
        for children in (mapper.relations or {}).values():
            known.update(children)
        if name not in known:
            raise MapperParsingException(
                f"unknown join relation [{name}] for field [{full}]"
            )
        is_child = any(
            name in children for children in (mapper.relations or {}).values()
        )
        if is_child and parent is None:
            raise MapperParsingException(
                f"join relation [{name}] requires [parent]"
            )
        name_field = f"{full}#name"
        self.mappers.setdefault(
            name_field, FieldMapper(name_field, "keyword", synthetic=True)
        )
        out.setdefault(name_field, ParsedField()).exact = [name]
        if parent is not None:
            parent_field = f"{full}#parent"
            self.mappers.setdefault(
                parent_field,
                FieldMapper(parent_field, "keyword", synthetic=True),
            )
            out.setdefault(parent_field, ParsedField()).exact = [str(parent)]

    def _parse_flat_object(self, root: str, value: Any,
                           out: dict[str, ParsedField]) -> None:
        if value is None or (isinstance(value, list)
                             and all(v is None for v in value)):
            return  # null clears nothing and indexes nothing
        if not isinstance(value, dict):
            from opensearch_tpu_torch.common.errors import ParsingException

            raise ParsingException(
                f"object mapping for [{root}] tried to parse field "
                f"[{root}] as object, but found a concrete value"
            )
        """flat_object (FlatObjectFieldMapper): leaf values are indexed as
        keywords under the root field (search any leaf) plus ONE shared
        `{root}#paths` column holding "sub.path=value" entries (the
        reference's `_valueAndPath` subfield) — sub-path searches rewrite
        onto it (see flat_object_parent), so the mapping never grows with
        leaf-key cardinality."""
        paths_field = f"{root}#paths"
        self.mappers.setdefault(
            paths_field, FieldMapper(paths_field, "keyword", synthetic=True)
        )

        def emit(fname: str, sval: str) -> None:
            pf = out.setdefault(fname, ParsedField())
            pf.exact = (pf.exact or []) + [sval]

        def walk(subpath: str, v: Any) -> None:
            if isinstance(v, dict):
                for k, sub in v.items():
                    walk(f"{subpath}.{k}" if subpath else k, sub)
            elif isinstance(v, list):
                for sub in v:
                    walk(subpath, sub)
            elif v is not None:
                sval = str(v).lower() if isinstance(v, bool) else str(v)
                emit(root, sval)
                if subpath:
                    emit(paths_field, f"{subpath}={sval}")

        walk("", value)

    def flat_object_parent(self, name: str) -> tuple[str, str] | None:
        """If `name` addresses a sub-path of a flat_object field, return
        (root, subpath) so term-level queries can rewrite onto the
        `{root}#paths` column."""
        parts = name.split(".")
        for i in range(len(parts) - 1, 0, -1):
            root = ".".join(parts[:i])
            m = self.mappers.get(root)
            if m is not None and m.type == "flat_object":
                return root, ".".join(parts[i:])
        return None

    def _parse_geo_point(self, full: str, value: Any,
                         out: dict[str, ParsedField]) -> None:
        """geo_point forms: {"lat","lon"} | [lon, lat] | "lat,lon" — stored
        as synthetic lat/lon float columns ({field}#lat/{field}#lon) that
        geo queries and geo aggs address (GeoPointFieldMapper doc-values)."""
        if isinstance(value, list) and value and \
                all(isinstance(v, (dict, str, list)) for v in value):
            # multi-valued points: last one wins the sort column (the
            # reference keeps all in doc-values; first-value simplification
            # mirrors the numeric-column TODO)
            for v in value:
                self._parse_geo_point(full, v, out)
            return
        try:
            lat = lon = None
            if isinstance(value, dict) and "lat" in value and "lon" in value:
                lat, lon = float(value["lat"]), float(value["lon"])
            elif isinstance(value, dict) and \
                    str(value.get("type", "")).lower() == "point":
                # GeoJSON Point: [lon, lat]
                coords = value.get("coordinates") or []
                lon, lat = float(coords[0]), float(coords[1])
            elif isinstance(value, list) and len(value) >= 2:
                lon, lat = float(value[0]), float(value[1])
            elif isinstance(value, str) and \
                    value.strip().upper().startswith("POINT"):
                # WKT "POINT (lon lat)"
                inner = value[value.index("(") + 1: value.rindex(")")]
                p_lon, p_lat = inner.split()
                lon, lat = float(p_lon), float(p_lat)
            elif isinstance(value, str) and "," in value:
                parts = value.split(",")
                lat, lon = float(parts[0]), float(parts[1])
            elif isinstance(value, str) and value.strip():
                lat, lon = _geohash_decode(value.strip())
        except (ValueError, TypeError) as e:
            raise MapperParsingException(
                f"failed to parse field [{full}] of type [geo_point]: {e}"
            ) from e
        if lat is None:
            raise MapperParsingException(
                f"failed to parse field [{full}] of type [geo_point]: "
                f"[{value!r}]"
            )
        for suffix, v in (("#lat", lat), ("#lon", lon)):
            fname = f"{full}{suffix}"
            self.mappers.setdefault(
                fname, FieldMapper(fname, "double", synthetic=True)
            )
            pf = out.setdefault(fname, ParsedField())
            pf.numeric = (pf.numeric or []) + [v]

    def _dynamic_mapper(self, name: str, value: Any) -> FieldMapper | None:
        # templates apply under true and under the *_allow_templates
        # variants — NOT under plain false/strict
        templates_ok = (
            self.dynamic is True
            or self.dynamic_raw in ("strict_allow_templates",
                                    "false_allow_templates")
        )
        if templates_ok:
            tmpl = self._dynamic_template_mapper(name, value)
            if tmpl is not None:
                return tmpl
        if self.dynamic == "strict":
            mode = self.dynamic_raw or "strict"
            raise StrictDynamicMappingException(
                f"mapping set to {mode}, dynamic introduction of [{name}] "
                f"within [_doc] is not allowed"
            )
        if self.dynamic is False:
            return None
        if isinstance(value, bool):
            return FieldMapper(name, "boolean")
        if isinstance(value, int):
            return FieldMapper(name, "long")
        if isinstance(value, float):
            return FieldMapper(name, "float")
        if isinstance(value, str):
            try:
                parse_date_millis(value)
                if not value.lstrip("-").isdigit():
                    return FieldMapper(name, "date")
            except ValueError:
                pass
            # dynamic strings get text + .keyword sub-field, like the
            # reference; the sub-field hangs off the parent's `fields` so
            # document parsing populates its column too
            kw = FieldMapper(f"{name}.keyword", "keyword")
            self.mappers[f"{name}.keyword"] = kw
            parent = FieldMapper(name, "text")
            parent.fields["keyword"] = kw
            return parent
        if isinstance(value, list):
            if value and all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in value):
                # plain numeric array -> numeric field (NOT dense_vector: the
                # reference requires explicit mapping for vectors)
                if all(isinstance(v, int) for v in value):
                    return FieldMapper(name, "long")
                return FieldMapper(name, "float")
            for v in value:
                if v is not None:
                    return self._dynamic_mapper(name, v)
            return None
        if value is None:
            return None
        raise MapperParsingException(f"cannot infer mapping for [{name}]={value!r}")

    def _dynamic_template_mapper(self, name: str,
                                 value: Any) -> FieldMapper | None:
        """First dynamic template whose match conditions accept the field
        (DynamicTemplate.match); templates apply in every dynamic mode,
        including strict_allow_templates/false_allow_templates."""
        import fnmatch as _fn

        if not self.dynamic_templates:
            return None
        vtype = ("string" if isinstance(value, str)
                 else "boolean" if isinstance(value, bool)
                 else "long" if isinstance(value, int)
                 else "double" if isinstance(value, float)
                 else "object" if isinstance(value, dict) else None)
        if vtype == "string":
            # date detection feeds match_mapping_type: date
            try:
                parse_date_millis(value)
                if not str(value).lstrip("-").isdigit():
                    vtype_date = True
                else:
                    vtype_date = False
            except ValueError:
                vtype_date = False
        else:
            vtype_date = False
        leaf = name.rsplit(".", 1)[-1]
        for entry in self.dynamic_templates:
            if not isinstance(entry, dict) or len(entry) != 1:
                continue
            conf = next(iter(entry.values()))
            if not isinstance(conf, dict):
                continue
            if "match" in conf and not _fn.fnmatch(leaf, str(conf["match"])):
                continue
            if "unmatch" in conf and _fn.fnmatch(leaf, str(conf["unmatch"])):
                continue
            if "path_match" in conf and not _fn.fnmatch(
                name, str(conf["path_match"])
            ):
                continue
            if "match_mapping_type" in conf:
                want = str(conf["match_mapping_type"])
                if want == "date":
                    if not vtype_date:
                        continue
                elif want == "string":
                    if vtype != "string" or vtype_date:
                        continue
                elif want != "*" and want != vtype:
                    continue
            mapping = conf.get("mapping")
            if not isinstance(mapping, dict) or "type" not in mapping:
                continue
            self._merge_field(
                name.rsplit(".", 1)[0] + "." if "." in name else "",
                leaf, dict(mapping),
            )
            return self.mappers.get(name)
        return None

    def _parse_value(
        self, mapper: FieldMapper, name: str, value: Any, out: dict[str, ParsedField]
    ) -> None:
        if value is None:
            return
        # multi-fields receive the same raw value (DocumentParser indexes
        # every sub-field of a FieldMapper alongside the parent)
        for sub_name, sub_mapper in mapper.fields.items():
            self._parse_value(sub_mapper, f"{name}.{sub_name}", value, out)
        values = value if isinstance(value, list) else [value]
        pf = out.setdefault(name, ParsedField())
        try:
            if mapper.type == "text":
                analyzer = self._analyzer_for(mapper)
                terms: list[str] = pf.terms or []
                positions: list[int] = pf.positions or []
                next_pos = (
                    positions[-1] + POSITION_INCREMENT_GAP + 1
                    if positions else 0
                )
                for v in values:
                    if v is None:
                        continue
                    toks = analyzer.analyze(str(v))
                    if mapper.shingle_size > 1:
                        toks = [
                            " ".join(toks[i: i + mapper.shingle_size])
                            for i in range(
                                len(toks) - mapper.shingle_size + 1
                            )
                        ]
                    terms.extend(toks)
                    positions.extend(range(next_pos, next_pos + len(toks)))
                    next_pos += len(toks) + POSITION_INCREMENT_GAP + 1
                pf.terms = terms
                pf.positions = positions
            elif mapper.type == "keyword":
                exact = pf.exact or []
                for v in values:
                    if v is None:
                        continue
                    sval = str(v)
                    if mapper.original_type == "constant_keyword":
                        if mapper.const_value is None:
                            mapper.const_value = sval
                        elif sval != str(mapper.const_value):
                            raise ValueError(
                                f"[constant_keyword] field [{name}] only "
                                f"accepts values that are equal to the "
                                f"value defined in the mappings "
                                f"[{mapper.const_value}], but got [{sval}]"
                            )
                    if mapper.original_type == "ip":
                        import ipaddress

                        try:
                            ipaddress.ip_address(sval)
                        except ValueError:
                            raise ValueError(
                                f"'{sval}' is not an IP string literal"
                            ) from None
                    if mapper.normalizer == "lowercase":
                        sval = sval.lower()
                    exact.append(sval)
                pf.exact = exact
            elif mapper.type == "rank_feature":
                nums = pf.numeric or []
                for v in values:
                    if v is None:
                        continue
                    x = float(v)
                    if x <= 0:
                        raise ValueError(
                            f"[rank_feature] fields must be positive, got [{v}]"
                        )
                    nums.append(x)
                pf.numeric = nums
            elif mapper.type == "token_count":
                # TokenCountFieldMapper: the number of analyzed tokens,
                # stored as an integer column
                analyzer = self._analyzer_for(mapper)
                nums = pf.numeric or []
                nums.extend(
                    float(len(analyzer.analyze(str(v))))
                    for v in values if v is not None
                )
                pf.numeric = nums
            elif mapper.type in NUMERIC_TYPES:
                nums = pf.numeric or []
                unsigned = mapper.original_type == "unsigned_long"
                for v in values:
                    if v is None:
                        continue
                    if isinstance(v, bool):
                        raise ValueError("booleans are not numbers")
                    if unsigned:
                        if isinstance(v, int):
                            iv = v
                        else:
                            # decimal strings truncate toward zero at FULL
                            # precision (float64 would corrupt 2^63-range
                            # values) — Numbers.toUnsignedLongExact-ish
                            from decimal import Decimal

                            iv = int(Decimal(str(v)))
                        if not 0 <= iv <= 2**64 - 1:
                            raise ValueError(
                                f"[{v}] out of range for [unsigned_long]"
                            )
                        # biased int64: iv - 2^63 keeps 64-bit order in the
                        # int64 column with NO float round-trip
                        nums.append(iv - 2**63)
                        continue
                    x = float(v)
                    if mapper.type in INT_TYPES:
                        if not float(v).is_integer() and not isinstance(v, int):
                            # the reference rejects "3.5" for integer types
                            raise ValueError(f"[{v}] is not an integer")
                        lo, hi = _INT_RANGES[mapper.type]
                        if not (lo <= int(v) <= hi):
                            raise ValueError(f"[{v}] out of range for [{mapper.type}]")
                        nums.append(int(v))
                        continue
                    elif not math.isfinite(x):
                        raise ValueError(f"[{v}] is not finite")
                    if mapper.original_type == "half_float":
                        # half_float quantizes to fp16 at index time like
                        # the reference's HalfFloatPoint encoding — sort
                        # and range semantics depend on it
                        import numpy as _np

                        x = float(_np.float16(x))
                    nums.append(x)
                pf.numeric = nums
            elif mapper.type == "date":
                nums = pf.numeric or []
                if mapper.resolution == "nanos":
                    # keep PYTHON ints: epoch nanos need 61 bits and would
                    # round through float64 (the int64 column stores exact)
                    nums.extend(parse_date_nanos(v)
                                for v in values if v is not None)
                else:
                    # an epoch_second-formatted field reads bare numbers as
                    # SECONDS (DateFormatter resolution, not epoch_millis)
                    fmts = (mapper.format or "").split("||")
                    def _pd(v):
                        if "epoch_second" in fmts and (
                                isinstance(v, (int, float)) or
                                str(v).strip().lstrip("-").isdigit()):
                            return float(int(v) * 1000)
                        return float(parse_date_millis(v))
                    nums.extend(_pd(v) for v in values if v is not None)
                pf.numeric = nums
            elif mapper.type == "boolean":
                nums = pf.numeric or []
                nums.extend(float(_parse_boolean(v)) for v in values if v is not None)
                pf.numeric = nums
            elif mapper.type == "dense_vector":
                if pf.vector is not None:
                    raise ValueError("multiple vectors for one field")
                vec = [float(v) for v in values]
                if len(vec) != mapper.dims:
                    raise ValueError(
                        f"vector length {len(vec)} != dims {mapper.dims}"
                    )
                pf.vector = vec
            else:  # pragma: no cover
                raise ValueError(f"unhandled type [{mapper.type}]")
        except (ValueError, TypeError) as e:
            ignore = (mapper.ignore_malformed
                      if mapper.ignore_malformed is not None
                      else self.ignore_malformed_default)
            # malformed values on non-analyzed types may be dropped
            # (IgnoreMalformedStoredValues): the doc indexes without the
            # field and lists it under the _ignored metadata field
            if ignore and mapper.type not in ("text", "dense_vector"):
                ig = out.setdefault("_ignored", ParsedField())
                if ig.exact is None or name not in ig.exact:
                    ig.exact = (ig.exact or []) + [name]
                self.mappers.setdefault(
                    "_ignored", FieldMapper("_ignored", "keyword",
                                            synthetic=True)
                )
                return
            raise MapperParsingException(
                f"failed to parse field [{name}] of type [{mapper.type}]: {e}"
            ) from e

    def analyze_query_text(self, field: str, text: str) -> list[str]:
        """Analyze query text with the field's search analyzer (match query)."""
        mapper = self.field_mapper(field)
        if mapper is None or mapper.type != "text":
            return [text]
        return self._analyzer_for(mapper, search=True).analyze(str(text))
