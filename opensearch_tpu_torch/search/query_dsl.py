"""Query DSL: JSON -> query node tree.

The analog of the reference's 86 QueryBuilder classes + parsing
(server/src/main/java/org/opensearch/index/query/ — AbstractQueryBuilder,
QueryShardContext): `parse_query` turns the JSON DSL into a typed node tree;
opensearch_tpu_torch/search/executor.py compiles nodes against a segment into
device score/mask ops (the `toQuery(QueryShardContext)` step).

Supported (growing set): match_all, match_none, match, multi_match, term,
terms, range, exists, ids, bool, constant_score, boost on all nodes,
match_phrase (position-less approximation: all terms must match), knn,
script_score (k-NN script patterns), function_score (subset).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any

from opensearch_tpu_torch.common.errors import ParsingException


@dataclass
class QueryNode:
    boost: float = 1.0
    # `_name` (named queries): hits report which named clauses matched
    # (matched_queries; AbstractQueryBuilder#queryName)
    name: str | None = None


@dataclass
class MatchAllQuery(QueryNode):
    pass


@dataclass
class MatchNoneQuery(QueryNode):
    pass


@dataclass
class SliceQuery(QueryNode):
    """Sliced scroll partition (search/slice/SliceBuilder.java): doc belongs
    to slice `id` of `max` iff murmur3(_id) % max == id."""

    id: int = 0
    max: int = 1


@dataclass
class MatchQuery(QueryNode):
    field: str = ""
    query: str = ""
    operator: str = "or"          # or | and
    minimum_should_match: int | None = None


@dataclass
class MatchPhraseQuery(QueryNode):
    field: str = ""
    query: str = ""
    slop: int = 0


@dataclass
class IntervalsQuery(QueryNode):
    """intervals query (IntervalQueryBuilder) — source tree parsed by
    opensearch_tpu_torch/search/intervals.py, verified against position postings."""

    field: str = ""
    source: Any = None            # intervals.IntervalSource


@dataclass
class MultiMatchQuery(QueryNode):
    fields: list[str] = dc_field(default_factory=list)
    query: str = ""
    type: str = "best_fields"     # best_fields | most_fields | bool_prefix | phrase | phrase_prefix | cross_fields
    operator: str = "or"
    minimum_should_match: Any = None
    fuzziness: Any = None
    analyzer: str | None = None
    slop: int = 0                 # phrase/phrase_prefix types
    field_boosts: dict = dc_field(default_factory=dict)  # "f^2" per-field boost


@dataclass
class TermQuery(QueryNode):
    field: str = ""
    value: Any = None
    case_insensitive: bool = False


@dataclass
class TermsQuery(QueryNode):
    field: str = ""
    values: list[Any] = dc_field(default_factory=list)


@dataclass
class RangeQuery(QueryNode):
    field: str = ""
    gte: Any = None
    gt: Any = None
    lte: Any = None
    lt: Any = None
    # range-FIELD relation (RangeQueryBuilder.relation, BKD range fields):
    # intersects (default) | contains | within
    relation: str = "intersects"


@dataclass
class ExistsQuery(QueryNode):
    field: str = ""


@dataclass
class TermsSetQuery(QueryNode):
    """terms_set (TermsSetQueryBuilder): per-doc minimum-should-match from
    a field or a script."""

    field: str = ""
    terms: list = dc_field(default_factory=list)
    minimum_should_match_field: str | None = None
    minimum_should_match_script: dict | None = None


@dataclass
class RankFeatureQuery(QueryNode):
    """rank_feature (RankFeatureQueryBuilder): score from a positive
    feature value via saturation/log/sigmoid/linear."""

    field: str = ""
    function: str = "saturation"  # saturation | log | sigmoid | linear
    pivot: float | None = None
    scaling_factor: float = 1.0   # log
    exponent: float = 1.0         # sigmoid


@dataclass
class GeoDistanceQuery(QueryNode):
    """geo_distance (GeoDistanceQueryBuilder): docs within `distance` of a
    center point."""

    field: str = ""
    distance: Any = None
    point: Any = None             # {lat, lon} | [lon, lat] | "lat,lon"


@dataclass
class GeoBoundingBoxQuery(QueryNode):
    """geo_bounding_box (GeoBoundingBoxQueryBuilder)."""

    field: str = ""
    top_left: Any = None
    bottom_right: Any = None


@dataclass
class GeoShapeQuery(QueryNode):
    """geo_shape against geo_point columns (envelope/point/polygon-bbox
    subset of GeoShapeQueryBuilder)."""

    field: str = ""
    shape: dict | None = None
    relation: str = "intersects"


@dataclass
class DistanceFeatureQuery(QueryNode):
    """distance_feature (DistanceFeatureQueryBuilder): score decays with
    distance from origin; boost * pivot / (pivot + distance)."""

    field: str = ""
    origin: Any = None
    pivot: Any = None


@dataclass
class IdsQuery(QueryNode):
    values: list[str] = dc_field(default_factory=list)


@dataclass
class BoolQuery(QueryNode):
    must: list[QueryNode] = dc_field(default_factory=list)
    should: list[QueryNode] = dc_field(default_factory=list)
    filter: list[QueryNode] = dc_field(default_factory=list)
    must_not: list[QueryNode] = dc_field(default_factory=list)
    minimum_should_match: int | None = None


@dataclass
class ConstantScoreQuery(QueryNode):
    filter: QueryNode | None = None


@dataclass
class KnnQuery(QueryNode):
    field: str = ""
    vector: list[float] = dc_field(default_factory=list)
    k: int = 10
    filter: QueryNode | None = None
    # per-query ANN knobs ({"nprobe": N}, k-NN plugin method_parameters)
    method_parameters: dict | None = None


@dataclass
class PrefixQuery(QueryNode):
    field: str = ""
    value: str = ""
    case_insensitive: bool = False


@dataclass
class WildcardQuery(QueryNode):
    field: str = ""
    value: str = ""
    case_insensitive: bool = False


@dataclass
class RegexpQuery(QueryNode):
    field: str = ""
    value: str = ""
    case_insensitive: bool = False


@dataclass
class FuzzyQuery(QueryNode):
    field: str = ""
    value: str = ""
    fuzziness: str = "AUTO"
    prefix_length: int = 0


@dataclass
class MatchPhrasePrefixQuery(QueryNode):
    field: str = ""
    query: str = ""
    max_expansions: int = 50


@dataclass
class MatchBoolPrefixQuery(QueryNode):
    field: str = ""
    query: str = ""
    operator: str = "or"
    minimum_should_match: Any = None
    fuzziness: Any = None
    analyzer: str | None = None


@dataclass
class QueryStringQuery(QueryNode):
    query: str = ""
    fields: list[str] = dc_field(default_factory=list)
    default_operator: str = "or"


@dataclass
class SimpleQueryStringQuery(QueryNode):
    query: str = ""
    fields: list[str] = dc_field(default_factory=list)
    default_operator: str = "or"


@dataclass
class BoostingQuery(QueryNode):
    positive: QueryNode | None = None
    negative: QueryNode | None = None
    negative_boost: float = 0.5


@dataclass
class DisMaxQuery(QueryNode):
    queries: list[QueryNode] = dc_field(default_factory=list)
    tie_breaker: float = 0.0


@dataclass
class ScoreFunction:
    """One entry of function_score.functions (FunctionScoreQueryBuilder)."""

    kind: str = "weight"          # weight | field_value_factor | random_score | decay
    filter: QueryNode | None = None
    weight: float | None = None
    # field_value_factor
    field: str = ""
    factor: float = 1.0
    modifier: str = "none"
    missing: float | None = None
    # random_score
    seed: int = 0
    # decay (gauss | exp | linear over numeric/date field)
    decay_type: str = ""
    origin: Any = None
    scale: Any = None
    offset: Any = None
    decay: float = 0.5


@dataclass
class FunctionScoreQuery(QueryNode):
    query: QueryNode | None = None
    functions: list[ScoreFunction] = dc_field(default_factory=list)
    score_mode: str = "multiply"  # multiply | sum | avg | first | max | min
    boost_mode: str = "multiply"  # multiply | replace | sum | avg | max | min
    max_boost: float = float("inf")
    min_score: float | None = None


@dataclass
class NestedQuery(QueryNode):
    """Flattened-semantics nested: delegates to the inner query over the
    dotted subfields (arrays are multi-valued columns in our layout)."""

    path: str = ""
    query: QueryNode | None = None
    score_mode: str = "avg"


@dataclass
class HybridQuery(QueryNode):
    """OpenSearch neural-search hybrid query: sub-query scores are kept
    separate through the query phase so a search-pipeline normalization
    processor can combine them (reference: neural-search plugin's
    HybridQuery + NormalizationProcessor)."""

    queries: list[QueryNode] = dc_field(default_factory=list)


@dataclass
class MoreLikeThisQuery(QueryNode):
    """TF-IDF representative-term selection over like-texts (reference:
    index/query/MoreLikeThisQueryBuilder; doc refs are resolved to texts
    before shard execution, like the two-phase rewrite)."""

    fields: list[str] = dc_field(default_factory=list)
    like_texts: list[str] = dc_field(default_factory=list)
    like_docs: list[dict] = dc_field(default_factory=list)  # {_index, _id}
    min_term_freq: int = 2
    min_doc_freq: int = 5
    max_query_terms: int = 25
    minimum_should_match: str = "30%"


@dataclass
class PercolateQuery(QueryNode):
    """Reverse search: match stored queries against provided documents
    (reference: modules/percolator PercolateQueryBuilder)."""

    field: str = ""
    documents: list[dict] = dc_field(default_factory=list)


@dataclass
class HasChildQuery(QueryNode):
    type: str = ""
    query: QueryNode | None = None
    score_mode: str = "none"     # none | sum | max | avg
    min_children: int = 1
    max_children: int = 2**31 - 1


@dataclass
class HasParentQuery(QueryNode):
    parent_type: str = ""
    query: QueryNode | None = None
    score: bool = False


@dataclass
class ParentIdQuery(QueryNode):
    type: str = ""
    id: str = ""


@dataclass
class GenericScriptScoreQuery(QueryNode):
    """script_score with an arbitrary painless script (per-doc host eval);
    the recognized vector-function patterns compile to the fused device
    path (ScriptScoreQuery) instead."""

    query: QueryNode | None = None
    script: dict = dc_field(default_factory=dict)


@dataclass
class ScriptQuery(QueryNode):
    """script filter query: {"script": {"script": {...}}} — keep docs where
    the script returns true."""

    script: dict = dc_field(default_factory=dict)


@dataclass
class ScriptScoreQuery(QueryNode):
    query: QueryNode | None = None
    # recognized vector scoring functions (the k-NN plugin script patterns)
    function: str = ""            # knn_score | cosineSimilarity | dotProduct | l2Squared
    field: str = ""
    query_vector: list[float] = dc_field(default_factory=list)
    space_type: str = "l2"
    add_constant: float = 0.0     # e.g. "cosineSimilarity(...) + 1.0"


def iter_query_nodes(node: QueryNode):
    """Depth-first walk over a query node tree (all QueryNode-typed fields
    and lists thereof)."""
    import dataclasses as _dc

    yield node
    for f in _dc.fields(node):
        v = getattr(node, f.name, None)
        if isinstance(v, QueryNode):
            yield from iter_query_nodes(v)
        elif isinstance(v, list):
            for item in v:
                if isinstance(item, QueryNode):
                    yield from iter_query_nodes(item)


def _single_kv(body: dict, name: str) -> tuple[str, Any]:
    if not isinstance(body, dict) or len(body) != 1:
        raise ParsingException(f"[{name}] query must have a single field")
    return next(iter(body.items()))


def parse_query(body: dict | None) -> QueryNode:
    if body is None:
        return MatchAllQuery()
    if not isinstance(body, dict) or len(body) != 1:
        raise ParsingException(
            "query must be an object with a single top-level key, got "
            f"{list(body) if isinstance(body, dict) else type(body).__name__}"
        )
    qtype, qbody = next(iter(body.items()))
    parser = _PARSERS.get(qtype)
    if parser is None:
        # same did-you-mean hint as the reference's
        # AbstractQueryBuilder.parseInnerQueryBuilder
        import difflib

        close = difflib.get_close_matches(qtype, list(_PARSERS), n=1,
                                          cutoff=0.7)
        hint = f" did you mean [{close[0]}]?" if close else ""
        raise ParsingException(f"unknown query [{qtype}]{hint}")
    # `_name` may sit at the query-body level ({"bool": {..., "_name": x}})
    # or inside the single-field conf ({"term": {"f": {.., "_name": x}}})
    qname = None
    if isinstance(qbody, dict):
        if "_name" in qbody:
            qbody = {k: v for k, v in qbody.items() if k != "_name"}
            qname = body[qtype]["_name"]
        elif len(qbody) == 1:
            inner = next(iter(qbody.values()))
            if isinstance(inner, dict) and "_name" in inner:
                qname = inner["_name"]
                qbody = {next(iter(qbody)): {
                    k: v for k, v in inner.items() if k != "_name"
                }}
        body = {qtype: qbody}
    if not isinstance(qbody, dict):
        raise ParsingException(
            f"[{qtype}] query malformed, expected an object but got "
            f"[{type(qbody).__name__}]"
        )
    node = parser(qbody)
    if qname is not None:
        node.name = str(qname)
    return node


def _parse_match_all(body: dict) -> QueryNode:
    return MatchAllQuery(boost=float(body.get("boost", 1.0)))


def _parse_match_none(_body: dict) -> QueryNode:
    return MatchNoneQuery()


def _query_text(v: Any) -> str:
    """JSON-canonical text for a match value: booleans render as the JSON
    literals (the reference coerces via XContent text, so `true`, not
    Python's `True` — a boolean-field match must round-trip)."""
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _parse_match(body: dict) -> QueryNode:
    fname, conf = _single_kv(body, "match")
    if isinstance(conf, dict):
        return MatchQuery(
            field=fname,
            query=_query_text(conf.get("query", "")),
            operator=str(conf.get("operator", "or")).lower(),
            minimum_should_match=_parse_msm(conf.get("minimum_should_match")),
            boost=float(conf.get("boost", 1.0)),
        )
    return MatchQuery(field=fname, query=_query_text(conf))


def _parse_match_phrase(body: dict) -> QueryNode:
    fname, conf = _single_kv(body, "match_phrase")
    if isinstance(conf, dict):
        return MatchPhraseQuery(field=fname, query=_query_text(conf.get("query", "")),
                                slop=int(conf.get("slop", 0)),
                                boost=float(conf.get("boost", 1.0)))
    return MatchPhraseQuery(field=fname, query=_query_text(conf))


def _parse_span_source(qtype: str, body: Any) -> tuple[str, Any]:
    """(field, IntervalSource) for one span_* clause. Span queries are the
    reference's position-query family (index/query/Span*QueryBuilder);
    here they lower onto the minimal-interval algebra the intervals query
    already evaluates against position postings."""
    from opensearch_tpu_torch.search import intervals as iv

    if qtype == "span_term":
        fname, conf = _single_kv(body, "span_term")
        value = conf.get("value") if isinstance(conf, dict) else conf
        boost = float(conf.get("boost", 1.0)) if isinstance(conf, dict) else 1.0
        _ = boost
        return fname, iv.TermSource(term=str(value))
    if qtype in ("span_near", "span_or"):
        clauses = body.get("clauses")
        if not isinstance(clauses, list) or not clauses:
            raise ParsingException(f"[{qtype}] requires [clauses]")
        parsed = []
        field = None
        for c in clauses:
            if not isinstance(c, dict) or len(c) != 1:
                raise ParsingException(f"[{qtype}] clause must be a span query")
            ctype, cbody = next(iter(c.items()))
            f, src = _parse_span_source(ctype, cbody)
            field = field or f
            if f != field:
                raise ParsingException(
                    "span clauses must target the same field"
                )
            parsed.append(src)
        if qtype == "span_or":
            return field, iv.AnyOfSource(sources=parsed)
        in_order = bool(body.get("in_order", True))
        slop = int(body.get("slop", 0))
        return field, iv.AllOfSource(
            sources=parsed, mode="ordered" if in_order else "unordered",
            max_gaps=slop,
        )
    if qtype == "span_first":
        match = body.get("match")
        if not isinstance(match, dict) or len(match) != 1:
            raise ParsingException("[span_first] requires [match]")
        ctype, cbody = next(iter(match.items()))
        field, src = _parse_span_source(ctype, cbody)
        return field, iv.FirstSource(source=src, end=int(body.get("end", 0)))
    if qtype in ("span_containing", "span_within"):
        big = body.get("big")
        little = body.get("little")
        if not isinstance(big, dict) or not isinstance(little, dict):
            raise ParsingException(f"[{qtype}] requires [big] and [little]")
        bf, bsrc = _parse_span_source(*next(iter(big.items())))
        lf, lsrc = _parse_span_source(*next(iter(little.items())))
        if bf != lf:
            raise ParsingException("span clauses must target the same field")
        if qtype == "span_containing":
            bsrc.filter = iv.IntervalFilter("containing", lsrc)
            return bf, bsrc
        lsrc.filter = iv.IntervalFilter("contained_by", bsrc)
        return lf, lsrc
    if qtype == "span_not":
        include = body.get("include")
        exclude = body.get("exclude")
        if not isinstance(include, dict) or not isinstance(exclude, dict):
            raise ParsingException(
                "[span_not] requires [include] and [exclude]"
            )
        inf, insrc = _parse_span_source(*next(iter(include.items())))
        exf, exsrc = _parse_span_source(*next(iter(exclude.items())))
        if inf != exf:
            raise ParsingException("span clauses must target the same field")
        insrc.filter = iv.IntervalFilter("not_overlapping", exsrc)
        return inf, insrc
    if qtype == "span_multi":
        match = body.get("match")
        if not isinstance(match, dict) or len(match) != 1:
            raise ParsingException("[span_multi] requires [match]")
        mtype, mbody = next(iter(match.items()))
        if mtype not in ("prefix", "wildcard", "fuzzy", "regexp"):
            raise ParsingException(
                f"[span_multi] does not support [{mtype}]"
            )
        fname, conf = _single_kv(mbody, mtype)
        if isinstance(conf, dict):
            value = conf.get("value", conf.get(mtype, conf.get("wildcard")))
            ci = bool(conf.get("case_insensitive", False))
            fuzz = conf.get("fuzziness", "AUTO")
            plen = int(conf.get("prefix_length", 0))
        else:
            value, ci, fuzz, plen = conf, False, "AUTO", 0
        kind = {"prefix": "prefix", "wildcard": "wildcard",
                "fuzzy": "fuzzy", "regexp": "regexp"}[mtype]
        return fname, iv.ExpandSource(
            kind=kind, pattern=str(value), case_insensitive=ci,
            fuzziness=fuzz, prefix_length=plen,
        )
    raise ParsingException(f"unknown span query [{qtype}]")


def _parse_span_query(qtype: str):
    def parse(body: dict) -> QueryNode:
        field, src = _parse_span_source(qtype, body)
        boost = float(body.get("boost", 1.0)) if isinstance(body, dict) else 1.0
        return IntervalsQuery(field=field, source=src, boost=boost)

    return parse


def _parse_intervals(body: dict) -> QueryNode:
    from opensearch_tpu_torch.search import intervals as iv

    fname, conf = _single_kv(body, "intervals")
    if not isinstance(conf, dict):
        raise ParsingException("[intervals] query body must be an object")
    conf = dict(conf)
    boost = float(conf.pop("boost", 1.0))
    return IntervalsQuery(
        field=fname, source=iv.parse_intervals_source(conf), boost=boost
    )


def _parse_combined_fields(body: dict) -> QueryNode:
    """combined_fields (CombinedFieldsQueryBuilder): BM25F-style scoring —
    here lowered onto the weighted most_fields sum, the closest shape in
    this engine's scoring model."""
    if "query" not in body or not body.get("fields"):
        raise ParsingException(
            "[combined_fields] requires [query] and [fields]"
        )
    raw_fields = body["fields"]
    field_boosts = {}
    for f in raw_fields:
        if "^" in f:
            name, _, sfx = f.partition("^")
            field_boosts[name] = float(sfx)
    return MultiMatchQuery(
        fields=[f.split("^")[0] for f in raw_fields],
        query=_query_text(body["query"]),
        type="most_fields",
        field_boosts=field_boosts,
        operator=str(body.get("operator", "or")).lower(),
        minimum_should_match=body.get("minimum_should_match"),
        boost=float(body.get("boost", 1.0)),
    )


def _parse_multi_match(body: dict) -> QueryNode:
    mm_type = body.get("type", "best_fields")
    known = {"best_fields", "most_fields", "cross_fields", "phrase",
             "phrase_prefix", "bool_prefix"}
    if mm_type not in known:
        raise ParsingException(f"[multi_match] unknown type [{mm_type}]")
    # parameter/type validation (MultiMatchQueryBuilder.doToQuery rejects
    # positional params for term-centric types)
    if mm_type == "bool_prefix":
        for bad in ("slop", "cutoff_frequency"):
            if bad in body:
                raise ParsingException(
                    f"[{bad}] not allowed for type [{mm_type}]"
                )
    raw_fields = body.get("fields", [])
    for f in raw_fields:
        if not isinstance(f, str) or not f:
            raise ParsingException(
                "[multi_match] field name is null or empty"
            )
    field_boosts = {}
    for f in raw_fields:
        if "^" not in f:
            continue
        name, _, suffix = f.partition("^")
        try:
            field_boosts[name] = float(suffix)
        except ValueError:
            raise ParsingException(
                f"[multi_match] invalid field boost [{f}]"
            ) from None
    return MultiMatchQuery(
        fields=[f.split("^")[0] for f in raw_fields],
        query=_query_text(body.get("query", "")),
        type=mm_type,
        field_boosts=field_boosts,
        operator=str(body.get("operator", "or")).lower(),
        minimum_should_match=body.get("minimum_should_match"),
        fuzziness=body.get("fuzziness"),
        analyzer=body.get("analyzer"),
        slop=int(body.get("slop", 0)),
        boost=float(body.get("boost", 1.0)),
    )


def _parse_term(body: dict) -> QueryNode:
    fname, conf = _single_kv(body, "term")
    if isinstance(conf, dict):
        return TermQuery(field=fname, value=conf.get("value"),
                         case_insensitive=bool(
                             conf.get("case_insensitive", False)),
                         boost=float(conf.get("boost", 1.0)))
    return TermQuery(field=fname, value=conf)


def _parse_terms(body: dict) -> QueryNode:
    body = dict(body)
    boost = float(body.pop("boost", 1.0))
    if len(body) != 1:
        raise ParsingException("[terms] query must have a single field")
    fname, values = next(iter(body.items()))
    if not isinstance(values, list):
        raise ParsingException("[terms] query values must be an array")
    return TermsQuery(field=fname, values=values, boost=boost)


def _parse_range(body: dict) -> QueryNode:
    fname, conf = _single_kv(body, "range")
    if not isinstance(conf, dict):
        raise ParsingException("[range] body must be an object")
    known = {"gte", "gt", "lte", "lt", "boost", "format", "time_zone", "relation",
             "from", "to", "include_lower", "include_upper"}
    unknown = set(conf) - known
    if unknown:
        raise ParsingException(f"[range] unknown options {sorted(unknown)}")
    gte, gt, lte, lt = conf.get("gte"), conf.get("gt"), conf.get("lte"), conf.get("lt")

    def _flag(v, default=True):
        if isinstance(v, str):
            return v.lower() != "false"
        return default if v is None else bool(v)

    # legacy from/to form
    if "from" in conf:
        if _flag(conf.get("include_lower")):
            gte = conf["from"]
        else:
            gt = conf["from"]
    if "to" in conf:
        if _flag(conf.get("include_upper")):
            lte = conf["to"]
        else:
            lt = conf["to"]
    return RangeQuery(field=fname, gte=gte, gt=gt, lte=lte, lt=lt,
                      relation=str(conf.get("relation", "intersects")).lower(),
                      boost=float(conf.get("boost", 1.0)))


def _parse_terms_set(body: dict) -> QueryNode:
    fname, conf = _single_kv(body, "terms_set")
    if not isinstance(conf, dict) or "terms" not in conf:
        raise ParsingException("[terms_set] requires [terms]")
    return TermsSetQuery(
        field=fname,
        terms=list(conf["terms"]),
        minimum_should_match_field=conf.get("minimum_should_match_field"),
        minimum_should_match_script=conf.get("minimum_should_match_script"),
        boost=float(conf.get("boost", 1.0)),
    )


def _parse_rank_feature(body: dict) -> QueryNode:
    if not isinstance(body, dict) or "field" not in body:
        raise ParsingException("[rank_feature] requires [field]")
    fn, pivot, sf, exp = "saturation", None, 1.0, 1.0
    if "saturation" in body:
        pivot = (body["saturation"] or {}).get("pivot")
    elif "log" in body:
        fn = "log"
        sf = float((body["log"] or {}).get("scaling_factor", 1.0))
    elif "sigmoid" in body:
        fn = "sigmoid"
        conf = body["sigmoid"] or {}
        pivot = conf.get("pivot")
        exp = float(conf.get("exponent", 1.0))
    elif "linear" in body:
        fn = "linear"
    return RankFeatureQuery(
        field=str(body["field"]), function=fn,
        pivot=float(pivot) if pivot is not None else None,
        scaling_factor=sf, exponent=exp,
        boost=float(body.get("boost", 1.0)),
    )


def _parse_geo_distance(body: dict) -> QueryNode:
    conf = dict(body)
    distance = conf.pop("distance", None)
    boost = float(conf.pop("boost", 1.0))
    conf.pop("distance_type", None)
    conf.pop("validation_method", None)
    conf.pop("_name", None)
    if distance is None or len(conf) != 1:
        raise ParsingException(
            "[geo_distance] requires [distance] and exactly one field"
        )
    fname, point = next(iter(conf.items()))
    return GeoDistanceQuery(field=fname, distance=distance, point=point,
                            boost=boost)


def _parse_geo_bounding_box(body: dict) -> QueryNode:
    conf = dict(body)
    boost = float(conf.pop("boost", 1.0))
    conf.pop("validation_method", None)
    conf.pop("type", None)
    conf.pop("_name", None)
    if len(conf) != 1:
        raise ParsingException(
            "[geo_bounding_box] requires exactly one field"
        )
    fname, box = next(iter(conf.items()))
    if not isinstance(box, dict):
        raise ParsingException("[geo_bounding_box] field body must be an object")
    tl = box.get("top_left")
    br = box.get("bottom_right")
    if tl is None or br is None:
        # corner-list form {"top_right": .., "bottom_left": ..} or wkt
        tr, bl = box.get("top_right"), box.get("bottom_left")
        if tr is not None and bl is not None:
            from opensearch_tpu_torch.search.executor import _parse_geo_origin

            tr_lat, tr_lon = _parse_geo_origin(tr)
            bl_lat, bl_lon = _parse_geo_origin(bl)
            tl = {"lat": tr_lat, "lon": bl_lon}
            br = {"lat": bl_lat, "lon": tr_lon}
        else:
            raise ParsingException(
                "[geo_bounding_box] requires [top_left] and [bottom_right]"
            )
    return GeoBoundingBoxQuery(field=fname, top_left=tl, bottom_right=br,
                               boost=boost)


def _parse_geo_shape(body: dict) -> QueryNode:
    conf = dict(body)
    boost = float(conf.pop("boost", 1.0))
    conf.pop("ignore_unmapped", None)
    conf.pop("_name", None)
    if len(conf) != 1:
        raise ParsingException("[geo_shape] requires exactly one field")
    fname, fconf = next(iter(conf.items()))
    if not isinstance(fconf, dict) or "shape" not in fconf:
        raise ParsingException("[geo_shape] requires [shape]")
    relation = str(fconf.get("relation", "intersects")).lower()
    if relation not in ("intersects", "disjoint", "within", "contains"):
        raise ParsingException(f"[geo_shape] unknown relation [{relation}]")
    return GeoShapeQuery(field=fname, shape=fconf["shape"],
                         relation=relation, boost=boost)


def _parse_distance_feature(body: dict) -> QueryNode:
    if not isinstance(body, dict) or "field" not in body:
        raise ParsingException("[distance_feature] requires [field]")
    if "origin" not in body or "pivot" not in body:
        raise ParsingException(
            "[distance_feature] requires [origin] and [pivot]"
        )
    return DistanceFeatureQuery(
        field=str(body["field"]), origin=body["origin"],
        pivot=body["pivot"], boost=float(body.get("boost", 1.0)),
    )


def _parse_exists(body: dict) -> QueryNode:
    return ExistsQuery(field=str(body["field"]), boost=float(body.get("boost", 1.0)))


def _parse_ids(body: dict) -> QueryNode:
    return IdsQuery(values=[str(v) for v in body.get("values", [])],
                    boost=float(body.get("boost", 1.0)))


def _parse_msm(v: Any) -> int | None:
    if v is None:
        return None
    s = str(v)
    if s.endswith("%"):
        raise ParsingException("percentage minimum_should_match not yet supported")
    return int(s)


def _as_list(v: Any) -> list:
    return v if isinstance(v, list) else [v]


def _parse_bool(body: dict) -> QueryNode:
    return BoolQuery(
        must=[parse_query(q) for q in _as_list(body.get("must", []))],
        should=[parse_query(q) for q in _as_list(body.get("should", []))],
        filter=[parse_query(q) for q in _as_list(body.get("filter", []))],
        must_not=[parse_query(q) for q in _as_list(body.get("must_not", []))],
        minimum_should_match=_parse_msm(body.get("minimum_should_match")),
        boost=float(body.get("boost", 1.0)),
    )


def _parse_constant_score(body: dict) -> QueryNode:
    return ConstantScoreQuery(
        filter=parse_query(body.get("filter")),
        boost=float(body.get("boost", 1.0)),
    )


def _parse_knn(body: dict) -> QueryNode:
    fname, conf = _single_kv(body, "knn")
    if not isinstance(conf, dict) or "vector" not in conf:
        raise ParsingException("[knn] requires {field: {vector: [...], k: N}}")
    filt = conf.get("filter")
    return KnnQuery(
        field=fname,
        vector=[float(x) for x in conf["vector"]],
        k=int(conf.get("k", 10)),
        filter=parse_query(filt) if filt else None,
        method_parameters=(
            conf["method_parameters"]
            if isinstance(conf.get("method_parameters"), dict) else None
        ),
        boost=float(conf.get("boost", 1.0)),
    )


def _parse_term_level(cls, name: str, value_key: str = "value"):
    def parse(body: dict) -> QueryNode:
        fname, conf = _single_kv(body, name)
        if isinstance(conf, dict):
            kwargs = dict(
                field=fname,
                value=str(conf.get(value_key, conf.get("value", ""))),
                boost=float(conf.get("boost", 1.0)),
            )
            if cls is FuzzyQuery:
                kwargs["fuzziness"] = str(conf.get("fuzziness", "AUTO"))
                kwargs["prefix_length"] = int(conf.get("prefix_length", 0))
            else:
                kwargs["case_insensitive"] = bool(conf.get("case_insensitive", False))
            return cls(**kwargs)
        return cls(field=fname, value=str(conf))

    return parse


def _parse_match_phrase_prefix(body: dict) -> QueryNode:
    fname, conf = _single_kv(body, "match_phrase_prefix")
    if isinstance(conf, dict):
        return MatchPhrasePrefixQuery(
            field=fname, query=_query_text(conf.get("query", "")),
            max_expansions=int(conf.get("max_expansions", 50)),
            boost=float(conf.get("boost", 1.0)),
        )
    return MatchPhrasePrefixQuery(field=fname, query=_query_text(conf))


def _parse_match_bool_prefix(body: dict) -> QueryNode:
    fname, conf = _single_kv(body, "match_bool_prefix")
    if isinstance(conf, dict):
        return MatchBoolPrefixQuery(
            field=fname, query=_query_text(conf.get("query", "")),
            operator=str(conf.get("operator", "or")).lower(),
            minimum_should_match=conf.get("minimum_should_match"),
            fuzziness=conf.get("fuzziness"),
            analyzer=conf.get("analyzer"),
            boost=float(conf.get("boost", 1.0)),
        )
    return MatchBoolPrefixQuery(field=fname, query=_query_text(conf))


def _parse_query_string(body: dict) -> QueryNode:
    fields = [f.split("^")[0] for f in body.get("fields", [])]
    if body.get("default_field"):
        fields = [str(body["default_field"]).split("^")[0]]
    return QueryStringQuery(
        query=_query_text(body.get("query", "")),
        fields=fields,
        default_operator=str(body.get("default_operator", "or")).lower(),
        boost=float(body.get("boost", 1.0)),
    )


def _parse_simple_query_string(body: dict) -> QueryNode:
    return SimpleQueryStringQuery(
        query=_query_text(body.get("query", "")),
        fields=[f.split("^")[0] for f in body.get("fields", [])],
        default_operator=str(body.get("default_operator", "or")).lower(),
        boost=float(body.get("boost", 1.0)),
    )


def _parse_boosting(body: dict) -> QueryNode:
    if "positive" not in body or "negative" not in body:
        raise ParsingException("[boosting] requires [positive] and [negative]")
    return BoostingQuery(
        positive=parse_query(body["positive"]),
        negative=parse_query(body["negative"]),
        negative_boost=float(body.get("negative_boost", 0.5)),
        boost=float(body.get("boost", 1.0)),
    )


def _parse_dis_max(body: dict) -> QueryNode:
    return DisMaxQuery(
        queries=[parse_query(q) for q in body.get("queries", [])],
        tie_breaker=float(body.get("tie_breaker", 0.0)),
        boost=float(body.get("boost", 1.0)),
    )


_FVF_MODIFIERS = {
    "none", "log", "log1p", "log2p", "ln", "ln1p", "ln2p",
    "square", "sqrt", "reciprocal",
}


def _parse_one_function(conf: dict) -> ScoreFunction:
    fn = ScoreFunction()
    if conf.get("filter") is not None:
        fn.filter = parse_query(conf["filter"])
    if "weight" in conf:
        fn.weight = float(conf["weight"])
    if "field_value_factor" in conf:
        fvf = conf["field_value_factor"]
        fn.kind = "field_value_factor"
        fn.field = str(fvf.get("field", ""))
        fn.factor = float(fvf.get("factor", 1.0))
        fn.modifier = str(fvf.get("modifier", "none")).lower()
        if fn.modifier not in _FVF_MODIFIERS:
            raise ParsingException(f"unknown field_value_factor modifier [{fn.modifier}]")
        fn.missing = float(fvf["missing"]) if "missing" in fvf else None
    elif "random_score" in conf:
        fn.kind = "random_score"
        fn.seed = int((conf["random_score"] or {}).get("seed", 0))
    elif any(d in conf for d in ("gauss", "exp", "linear")):
        fn.kind = "decay"
        fn.decay_type = next(d for d in ("gauss", "exp", "linear") if d in conf)
        spec = conf[fn.decay_type]
        fname, dconf = _single_kv(spec, fn.decay_type)
        fn.field = fname
        fn.origin = dconf.get("origin")
        fn.scale = dconf.get("scale")
        fn.offset = dconf.get("offset", 0)
        fn.decay = float(dconf.get("decay", 0.5))
        if fn.scale is None:
            raise ParsingException(f"[{fn.decay_type}] requires [scale]")
    elif "weight" in conf:
        fn.kind = "weight"
    elif "script_score" in conf:
        raise ParsingException(
            "script_score inside function_score is not supported; use the "
            "top-level script_score query"
        )
    else:
        fn.kind = "weight"
        if fn.weight is None:
            raise ParsingException(f"unknown function in function_score: {sorted(conf)}")
    return fn


def _parse_function_score(body: dict) -> QueryNode:
    functions = [_parse_one_function(f) for f in body.get("functions", [])]
    # shorthand single-function form
    if not functions:
        single = {
            k: v for k, v in body.items()
            if k in ("field_value_factor", "random_score", "gauss", "exp", "linear", "weight")
        }
        if single:
            functions = [_parse_one_function(single)]
    return FunctionScoreQuery(
        query=parse_query(body.get("query")) if body.get("query") else MatchAllQuery(),
        functions=functions,
        score_mode=str(body.get("score_mode", "multiply")).lower(),
        boost_mode=str(body.get("boost_mode", "multiply")).lower(),
        max_boost=float(body.get("max_boost", float("inf"))),
        min_score=float(body["min_score"]) if "min_score" in body else None,
        boost=float(body.get("boost", 1.0)),
    )


def _parse_nested(body: dict) -> QueryNode:
    if "path" not in body or "query" not in body:
        raise ParsingException("[nested] requires [path] and [query]")
    return NestedQuery(
        path=str(body["path"]),
        query=parse_query(body["query"]),
        score_mode=str(body.get("score_mode", "avg")),
        boost=float(body.get("boost", 1.0)),
    )


def _parse_hybrid(conf: dict) -> QueryNode:
    if not isinstance(conf, dict) or not isinstance(conf.get("queries"), list):
        raise ParsingException("[hybrid] requires a [queries] array")
    queries = [parse_query(q) for q in conf["queries"]]
    if not queries:
        raise ParsingException("[hybrid] requires at least one sub-query")
    if len(queries) > 5:
        raise ParsingException("[hybrid] supports at most 5 sub-queries")
    return HybridQuery(queries=queries, boost=float(conf.get("boost", 1.0)))


_VECTOR_FUNCS = ("cosineSimilarity", "dotProduct", "l2Squared", "knn_score")


def _parse_script_score(body: dict) -> QueryNode:
    inner = parse_query(body.get("query"))
    script = body.get("script") or {}
    source = script.get("source", "")
    params = script.get("params") or {}
    if source == "knn_score":
        # legacy k-NN plugin script: params {field, query_value, space_type}
        return ScriptScoreQuery(
            query=inner,
            function="knn_score",
            field=str(params.get("field", "")),
            query_vector=[float(x) for x in params.get("query_value", [])],
            space_type=params.get("space_type", "l2"),
            boost=float(body.get("boost", 1.0)),
        )
    for fn in _VECTOR_FUNCS:
        if fn in source:
            # e.g. "cosineSimilarity(params.query_vector, doc['vec']) + 1.0"
            import re

            m = re.search(
                rf"{fn}\(\s*params\.(\w+)\s*,\s*doc\[['\"]([\w.]+)['\"]\]\s*\)"
                r"(?:\s*\+\s*([0-9.]+))?",
                source,
            )
            if not m:
                raise ParsingException(f"unsupported script_score source [{source}]")
            pname, fieldname, const = m.groups()
            if pname not in params:
                raise ParsingException(f"missing script param [{pname}]")
            space = {"cosineSimilarity": "cosine", "dotProduct": "dot_product",
                     "l2Squared": "l2_raw"}[fn] if fn != "knn_score" else "l2"
            return ScriptScoreQuery(
                query=inner,
                function=fn,
                field=fieldname,
                query_vector=[float(x) for x in params[pname]],
                space_type=space,
                add_constant=float(const) if const else 0.0,
                boost=float(body.get("boost", 1.0)),
            )
    # arbitrary painless script: per-doc host evaluation path
    return GenericScriptScoreQuery(
        query=inner, script=script, boost=float(body.get("boost", 1.0))
    )


def _parse_script_query(body: dict) -> QueryNode:
    if "script" not in body:
        raise ParsingException("[script] query requires [script]")
    return ScriptQuery(script=body["script"], boost=float(body.get("boost", 1.0)))


def _parse_more_like_this(conf: dict) -> QueryNode:
    like = conf.get("like")
    if like is None:
        raise ParsingException("[more_like_this] requires [like]")
    likes = like if isinstance(like, list) else [like]
    texts = [x for x in likes if isinstance(x, str)]
    docs = [x for x in likes if isinstance(x, dict)]
    fields = conf.get("fields") or []
    return MoreLikeThisQuery(
        fields=list(fields),
        like_texts=texts,
        like_docs=docs,
        min_term_freq=int(conf.get("min_term_freq", 2)),
        min_doc_freq=int(conf.get("min_doc_freq", 5)),
        max_query_terms=int(conf.get("max_query_terms", 25)),
        minimum_should_match=str(conf.get("minimum_should_match", "30%")),
        boost=float(conf.get("boost", 1.0)),
    )


def _parse_percolate(conf: dict) -> QueryNode:
    if not isinstance(conf, dict) or not conf.get("field"):
        raise ParsingException("[percolate] requires [field]")
    if "document" in conf:
        documents = [conf["document"]]
    elif "documents" in conf:
        documents = list(conf["documents"])
    else:
        raise ParsingException("[percolate] requires [document] or [documents]")
    return PercolateQuery(
        field=conf["field"], documents=documents,
        boost=float(conf.get("boost", 1.0)),
    )


def _parse_has_child(conf: dict) -> QueryNode:
    if not conf.get("type") or "query" not in conf:
        raise ParsingException("[has_child] requires [type] and [query]")
    return HasChildQuery(
        type=conf["type"],
        query=parse_query(conf["query"]),
        score_mode=conf.get("score_mode", "none"),
        min_children=int(conf.get("min_children", 1)),
        max_children=int(conf.get("max_children", 2**31 - 1)),
        boost=float(conf.get("boost", 1.0)),
    )


def _parse_has_parent(conf: dict) -> QueryNode:
    if not conf.get("parent_type") or "query" not in conf:
        raise ParsingException("[has_parent] requires [parent_type] and [query]")
    return HasParentQuery(
        parent_type=conf["parent_type"],
        query=parse_query(conf["query"]),
        score=bool(conf.get("score", False)),
        boost=float(conf.get("boost", 1.0)),
    )


def _parse_parent_id(conf: dict) -> QueryNode:
    if not conf.get("type") or conf.get("id") is None:
        raise ParsingException("[parent_id] requires [type] and [id]")
    return ParentIdQuery(
        type=conf["type"], id=str(conf["id"]),
        boost=float(conf.get("boost", 1.0)),
    )


_PARSERS = {
    "more_like_this": _parse_more_like_this,
    "percolate": _parse_percolate,
    "has_child": _parse_has_child,
    "has_parent": _parse_has_parent,
    "parent_id": _parse_parent_id,
    "match_all": _parse_match_all,
    "match_none": _parse_match_none,
    "match": _parse_match,
    "match_phrase": _parse_match_phrase,
    "intervals": _parse_intervals,
    "span_term": _parse_span_query("span_term"),
    "span_near": _parse_span_query("span_near"),
    "span_or": _parse_span_query("span_or"),
    "span_first": _parse_span_query("span_first"),
    "span_not": _parse_span_query("span_not"),
    "span_containing": _parse_span_query("span_containing"),
    "span_within": _parse_span_query("span_within"),
    "span_multi": _parse_span_query("span_multi"),
    "multi_match": _parse_multi_match,
    "combined_fields": _parse_combined_fields,
    "term": _parse_term,
    "terms": _parse_terms,
    "range": _parse_range,
    "exists": _parse_exists,
    "terms_set": _parse_terms_set,
    "distance_feature": _parse_distance_feature,
    "geo_distance": _parse_geo_distance,
    "rank_feature": _parse_rank_feature,
    "geo_bounding_box": _parse_geo_bounding_box,
    "geo_shape": _parse_geo_shape,
    "ids": _parse_ids,
    "bool": _parse_bool,
    "constant_score": _parse_constant_score,
    "knn": _parse_knn,
    "script_score": _parse_script_score,
    "script": _parse_script_query,
    "prefix": _parse_term_level(PrefixQuery, "prefix"),
    "wildcard": _parse_term_level(WildcardQuery, "wildcard", "wildcard"),
    "regexp": _parse_term_level(RegexpQuery, "regexp"),
    "fuzzy": _parse_term_level(FuzzyQuery, "fuzzy"),
    "match_phrase_prefix": _parse_match_phrase_prefix,
    "match_bool_prefix": _parse_match_bool_prefix,
    "query_string": _parse_query_string,
    "simple_query_string": _parse_simple_query_string,
    "boosting": _parse_boosting,
    "dis_max": _parse_dis_max,
    "function_score": _parse_function_score,
    "nested": _parse_nested,
    "hybrid": _parse_hybrid,
}
