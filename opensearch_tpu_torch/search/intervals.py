"""Intervals query: minimal-interval algebra over position postings.

The analog of the reference's intervals query
(server/src/main/java/org/opensearch/index/query/IntervalQueryBuilder.java +
IntervalsSourceProvider.java — Lucene's o.a.l.queries.intervals): sources
(match / prefix / wildcard / fuzzy / regexp / all_of / any_of) produce
per-document lists of (start, end) position intervals; combinators compose
them (ordered / unordered / unordered_no_overlap, max_gaps); filters
restrict them (containing / contained_by / overlapping / before / after and
negations).

Execution model: the device-side postings mask narrows candidates (docs
holding at least one involved term); interval verification is host work
over the segment's position CSR (`HostTextField.term_positions`) — the same
split the engine uses for phrase queries. Interval lists per doc are tiny
(bounded by per-doc tf), so exhaustive minimal-interval enumeration with a
work cap replaces Lucene's lazy iterator stack.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field as dc_field
from typing import Any, Callable

from opensearch_tpu_torch.common.errors import ParsingException

Interval = tuple[int, int]  # inclusive (start, end) token positions

# combination work cap: product of sub-interval list sizes beyond which a
# combinator falls back to greedy (first-match) evaluation
_MAX_COMBINATIONS = 200_000


# --------------------------------------------------------------------------
# AST
# --------------------------------------------------------------------------


@dataclass
class IntervalSource:
    filter: "IntervalFilter | None" = None


@dataclass
class MatchSource(IntervalSource):
    query: str = ""
    mode: str = "unordered"       # ordered | unordered | unordered_no_overlap
    max_gaps: int = -1
    analyzer: str | None = None
    use_field: str | None = None


@dataclass
class ExpandSource(IntervalSource):
    """Term-set expansion source (prefix/wildcard/regexp/fuzzy)."""

    kind: str = "prefix"
    pattern: str = ""
    case_insensitive: bool = False
    fuzziness: Any = "AUTO"
    prefix_length: int = 0
    use_field: str | None = None


@dataclass
class TermSource(IntervalSource):
    """Single un-analyzed term (span_term's literal semantics)."""

    term: str = ""


@dataclass
class FirstSource(IntervalSource):
    """span_first: intervals ending at position < end."""

    source: IntervalSource | None = None
    end: int = 0


@dataclass
class AllOfSource(IntervalSource):
    sources: list[IntervalSource] = dc_field(default_factory=list)
    mode: str = "unordered"
    max_gaps: int = -1


@dataclass
class AnyOfSource(IntervalSource):
    sources: list[IntervalSource] = dc_field(default_factory=list)


@dataclass
class IntervalFilter:
    kind: str                      # containing | contained_by | not_* | ...
    source: IntervalSource


# --------------------------------------------------------------------------
# Parsing (IntervalsSourceProvider.fromXContent analog)
# --------------------------------------------------------------------------

_FILTER_KINDS = {
    "containing", "contained_by", "not_containing", "not_contained_by",
    "overlapping", "not_overlapping", "before", "after",
}


def _parse_mode(conf: dict, default: str = "unordered") -> str:
    mode = conf.get("mode")
    if mode is None and "ordered" in conf:
        mode = "ordered" if conf["ordered"] else "unordered"
    if mode is None:
        return default
    if mode not in ("ordered", "unordered", "unordered_no_overlap"):
        raise ParsingException(f"unknown intervals mode [{mode}]")
    return mode


def _parse_filter(conf: Any) -> IntervalFilter:
    if not isinstance(conf, dict) or len(conf) != 1:
        raise ParsingException("[intervals] filter must define exactly one rule")
    kind, sub = next(iter(conf.items()))
    if kind not in _FILTER_KINDS:
        raise ParsingException(f"unknown intervals filter [{kind}]")
    return IntervalFilter(kind=kind, source=parse_intervals_source(sub))


def parse_intervals_source(conf: Any) -> IntervalSource:
    if not isinstance(conf, dict) or len(conf) != 1:
        raise ParsingException(
            "[intervals] source must define exactly one rule "
            "(match/prefix/wildcard/fuzzy/regexp/all_of/any_of)"
        )
    kind, body = next(iter(conf.items()))
    if not isinstance(body, dict):
        raise ParsingException(f"[intervals] [{kind}] body must be an object")
    filt = _parse_filter(body["filter"]) if "filter" in body else None
    if kind == "match":
        if "query" not in body:
            raise ParsingException("[intervals] match requires [query]")
        return MatchSource(
            query=str(body["query"]),
            mode=_parse_mode(body),
            max_gaps=int(body.get("max_gaps", -1)),
            analyzer=body.get("analyzer"),
            use_field=body.get("use_field"),
            filter=filt,
        )
    if kind == "prefix":
        if "prefix" not in body:
            raise ParsingException("[intervals] prefix requires [prefix]")
        return ExpandSource(kind="prefix", pattern=str(body["prefix"]),
                            use_field=body.get("use_field"), filter=filt)
    if kind == "wildcard":
        if "pattern" not in body:
            raise ParsingException("[intervals] wildcard requires [pattern]")
        return ExpandSource(kind="wildcard", pattern=str(body["pattern"]),
                            use_field=body.get("use_field"), filter=filt)
    if kind == "regexp":
        if "pattern" not in body:
            raise ParsingException("[intervals] regexp requires [pattern]")
        return ExpandSource(
            kind="regexp", pattern=str(body["pattern"]),
            case_insensitive=bool(body.get("case_insensitive", False)),
            use_field=body.get("use_field"), filter=filt,
        )
    if kind == "fuzzy":
        if "term" not in body:
            raise ParsingException("[intervals] fuzzy requires [term]")
        return ExpandSource(
            kind="fuzzy", pattern=str(body["term"]),
            fuzziness=body.get("fuzziness", "AUTO"),
            prefix_length=int(body.get("prefix_length", 0)),
            use_field=body.get("use_field"), filter=filt,
        )
    if kind == "all_of":
        subs = body.get("intervals")
        if not isinstance(subs, list) or not subs:
            raise ParsingException("[intervals] all_of requires [intervals]")
        return AllOfSource(
            sources=[parse_intervals_source(s) for s in subs],
            mode=_parse_mode(body),
            max_gaps=int(body.get("max_gaps", -1)),
            filter=filt,
        )
    if kind == "any_of":
        subs = body.get("intervals")
        if not isinstance(subs, list) or not subs:
            raise ParsingException("[intervals] any_of requires [intervals]")
        return AnyOfSource(
            sources=[parse_intervals_source(s) for s in subs], filter=filt,
        )
    raise ParsingException(f"unknown intervals source [{kind}]")


# --------------------------------------------------------------------------
# Evaluation
# --------------------------------------------------------------------------


class IntervalContext:
    """Per-(segment, query) evaluation context.

    `analyze(text, analyzer)` -> list[str]; `expand(src)` -> terms of the
    segment vocabulary matched by an expansion source (cached per segment);
    `positions(term, doc)` -> ascending position list.
    """

    def __init__(
        self,
        analyze: Callable[[str, str | None], list[str]],
        vocab: list[str],
        positions: Callable[[str, int], Any],
        edit_distance_at_most: Callable[[str, str, int], bool],
        fuzziness_distance: Callable[[Any, str], int],
    ):
        self.analyze = analyze
        self.vocab = vocab
        self.positions = positions
        self._edit_distance_at_most = edit_distance_at_most
        self._fuzziness_distance = fuzziness_distance
        self._expand_cache: dict[int, list[str]] = {}

    def expand(self, src: ExpandSource) -> list[str]:
        cached = self._expand_cache.get(id(src))
        if cached is not None:
            return cached
        if src.kind == "prefix":
            match = lambda t: t.startswith(src.pattern)  # noqa: E731
        elif src.kind == "wildcard":
            rx = re.compile(
                "".join(
                    ".*" if c == "*" else "." if c == "?" else re.escape(c)
                    for c in src.pattern
                ),
                re.IGNORECASE if src.case_insensitive else 0,
            )
            match = lambda t: rx.fullmatch(t) is not None  # noqa: E731
        elif src.kind == "regexp":
            rx = re.compile(
                src.pattern, re.IGNORECASE if src.case_insensitive else 0
            )
            match = lambda t: rx.fullmatch(t) is not None  # noqa: E731
        else:  # fuzzy
            value = src.pattern
            max_d = self._fuzziness_distance(src.fuzziness, value)
            plen = src.prefix_length

            def match(t: str) -> bool:
                if plen and t[:plen] != value[:plen]:
                    return False
                if abs(len(t) - len(value)) > max_d:
                    return False
                return self._edit_distance_at_most(value, t, max_d)

        out = [t for t in self.vocab if match(t)]
        self._expand_cache[id(src)] = out
        return out

    def leaf_terms(self, src: IntervalSource) -> set[str]:
        """All terms the source may touch (candidate-doc pre-filter)."""
        out: set[str] = set()
        if isinstance(src, MatchSource):
            out.update(self.analyze(src.query, src.analyzer))
        elif isinstance(src, TermSource):
            out.add(src.term)
        elif isinstance(src, FirstSource):
            if src.source is not None:
                out.update(self.leaf_terms(src.source))
        elif isinstance(src, ExpandSource):
            out.update(self.expand(src))
        elif isinstance(src, (AllOfSource, AnyOfSource)):
            for s in src.sources:
                out.update(self.leaf_terms(s))
        if src.filter is not None:
            out.update(self.leaf_terms(src.filter.source))
        return out


def _minimal(intervals: list[Interval]) -> list[Interval]:
    """Drop duplicates and intervals strictly containing another interval
    (Lucene's minimal-interval semantics), return sorted by (start, end)."""
    if not intervals:
        return []
    uniq = sorted(set(intervals))
    out: list[Interval] = []
    for s, e in uniq:
        if any(s <= s2 and e2 <= e and (s2, e2) != (s, e) for s2, e2 in uniq):
            continue
        out.append((s, e))
    return out


def _combine(
    lists: list[list[Interval]], mode: str, max_gaps: int
) -> list[Interval]:
    """All minimal combined intervals choosing one interval per sub-list."""
    if any(not lst for lst in lists):
        return []
    if mode == "unordered_no_overlap" and len(lists) > 2:
        # Lucene builds n-ary no-overlap as a left fold of pairwise
        # combinations (Intervals.unorderedNoOverlaps is binary); the fold
        # order is observable — the YAML suite's "cold wet it" case counts
        # on it — so reproduce it exactly.
        acc = lists[0]
        for nxt in lists[1:]:
            acc = _combine([acc, nxt], mode, max_gaps)
            if not acc:
                return []
        return acc
    total = 1
    for lst in lists:
        total *= len(lst)
        if total > _MAX_COMBINATIONS:
            break
    results: list[Interval] = []

    if total > _MAX_COMBINATIONS:
        # greedy fallback: take the earliest legal interval per sub-list
        # (keeps existence checks sound for pathological docs at the cost
        # of minimality)
        chosen: list[Interval] = []
        last_end = -1
        for lst in lists:
            nxt = (next((iv for iv in lst if iv[0] > last_end), None)
                   if mode == "ordered" else lst[0])
            if nxt is None:
                return []
            chosen.append(nxt)
            last_end = nxt[1]
        iv = _score_combo(chosen, mode, max_gaps)
        return [iv] if iv is not None else []

    def rec(i: int, chosen: list[Interval]) -> None:
        if i == len(lists):
            iv = _score_combo(chosen, mode, max_gaps)
            if iv is not None:
                results.append(iv)
            return
        for iv in lists[i]:
            rec(i + 1, chosen + [iv])

    rec(0, [])
    return _minimal(results)


def _score_combo(
    chosen: list[Interval], mode: str, max_gaps: int
) -> Interval | None:
    """Validate one choice of sub-intervals; return the combined interval."""
    if mode == "ordered":
        for a, b in zip(chosen, chosen[1:]):
            if b[0] <= a[1]:
                return None
        gaps = sum(b[0] - a[1] - 1 for a, b in zip(chosen, chosen[1:]))
        if 0 <= max_gaps < gaps:
            return None
        return (chosen[0][0], chosen[-1][1])
    # unordered: overlap (even identical spans from different sub-sources)
    # is allowed — Lucene's UnorderedIntervalsSource positions each
    # sub-iterator independently, and the YAML suite's nested-combination
    # cases count on a single occurrence satisfying two sub-sources
    srt = sorted(chosen)
    if mode == "unordered_no_overlap":
        for a, b in zip(srt, srt[1:]):
            if b[0] <= a[1]:
                return None
    gaps = sum(max(0, b[0] - a[1] - 1) for a, b in zip(srt, srt[1:]))
    if 0 <= max_gaps < gaps:
        return None
    return (srt[0][0], srt[-1][1])


def _apply_filter(
    intervals: list[Interval], filt: IntervalFilter, ctx: IntervalContext,
    doc: int,
) -> list[Interval]:
    f_ivs = evaluate(filt.source, ctx, doc)
    kind = filt.kind

    def keep(iv: Interval) -> bool:
        s, e = iv
        if kind == "containing":
            return any(s <= fs and fe <= e for fs, fe in f_ivs)
        if kind == "not_containing":
            return not any(s <= fs and fe <= e for fs, fe in f_ivs)
        if kind == "contained_by":
            return any(fs <= s and e <= fe for fs, fe in f_ivs)
        if kind == "not_contained_by":
            return not any(fs <= s and e <= fe for fs, fe in f_ivs)
        if kind == "overlapping":
            return any(s <= fe and fs <= e for fs, fe in f_ivs)
        if kind == "not_overlapping":
            return not any(s <= fe and fs <= e for fs, fe in f_ivs)
        if kind == "before":
            return any(e < fs for fs, _fe in f_ivs)
        if kind == "after":
            return any(s > fe for _fs, fe in f_ivs)
        raise ParsingException(f"unknown intervals filter [{kind}]")

    return [iv for iv in intervals if keep(iv)]


def evaluate(
    src: IntervalSource, ctx: IntervalContext, doc: int
) -> list[Interval]:
    """Minimal intervals of `src` in local doc `doc`."""
    if isinstance(src, TermSource):
        out = _minimal([(int(p), int(p)) for p in ctx.positions(src.term, doc)])
    elif isinstance(src, FirstSource):
        inner = evaluate(src.source, ctx, doc) if src.source else []
        out = [iv for iv in inner if iv[1] < src.end]
    elif isinstance(src, MatchSource):
        terms = ctx.analyze(src.query, src.analyzer)
        if not terms:
            out = []
        else:
            lists = [
                [(int(p), int(p)) for p in ctx.positions(t, doc)]
                for t in terms
            ]
            out = _combine(lists, src.mode, src.max_gaps) if len(lists) > 1 \
                else _minimal(lists[0])
    elif isinstance(src, ExpandSource):
        ivs = [
            (int(p), int(p))
            for t in ctx.expand(src)
            for p in ctx.positions(t, doc)
        ]
        out = _minimal(ivs)
    elif isinstance(src, AllOfSource):
        lists = [evaluate(s, ctx, doc) for s in src.sources]
        out = _combine(lists, src.mode, src.max_gaps)
    elif isinstance(src, AnyOfSource):
        ivs = [iv for s in src.sources for iv in evaluate(s, ctx, doc)]
        out = _minimal(ivs)
    else:  # pragma: no cover
        raise ParsingException(f"unknown intervals source [{type(src)}]")
    if src.filter is not None:
        out = _apply_filter(out, src.filter, ctx, doc)
    return out
