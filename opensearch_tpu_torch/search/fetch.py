"""Fetch phase sub-phases: per-hit document assembly.

A copy of opensearch_tpu/search/fetch.py (host-only), with the fuzzy
edit distance the highlighter needs brought along from the reference's
executor; highlighting a query_string query waits for its parser. The
analog of the reference's FetchPhase + fetch/subphase/* chain
(search/fetch/FetchPhase.java:99 runs 17 sub-phases per winning doc:
FetchSourcePhase, HighlightPhase, FetchDocValuesPhase, FetchFieldsPhase,
ExplainPhase, FetchVersionsPhase, SeqNoPrimaryTermPhase, ScriptFieldsPhase…).
Here each sub-phase is a small function over (hit dict, host segment, doc);
the service composes them per request.

The highlighter is the plain-highlighter model (fetch/subphase/highlight/
PlainHighlighter.java): re-analyze the stored text, mark tokens the query's
per-field term predicates accept, emit merged fragments.
"""

from __future__ import annotations

import re
from typing import Any, Callable

from opensearch_tpu_torch.common.errors import IllegalArgumentException
from opensearch_tpu_torch.index.mapper import MapperService
from opensearch_tpu_torch.search import query_dsl as q

_WORD_RE = re.compile(r"\w+", re.UNICODE)


# --------------------------------------------------------------------------
# query term extraction (per-field predicates for highlighting)
# --------------------------------------------------------------------------


def _wildcard_rx(pattern: str) -> re.Pattern:
    parts = []
    for ch in pattern:
        parts.append(".*" if ch == "*" else "." if ch == "?" else re.escape(ch))
    return re.compile("".join(parts) + r"\Z")


def field_term_predicates(
    node: q.QueryNode, ms: MapperService
) -> dict[str, list[Callable[[str], bool]]]:
    """field -> [predicate over analyzed token] for every leaf query."""
    out: dict[str, list[Callable[[str], bool]]] = {}

    def add(field: str, pred: Callable[[str], bool]) -> None:
        out.setdefault(field, []).append(pred)

    def term_set_pred(terms: list[str]) -> Callable[[str], bool]:
        tset = {t.lower() for t in terms}
        return lambda tok: tok.lower() in tset

    def walk(n: q.QueryNode) -> None:
        if isinstance(n, (q.MatchQuery, q.MatchPhraseQuery,
                          q.MatchPhrasePrefixQuery, q.MatchBoolPrefixQuery)):
            add(n.field, term_set_pred(ms.analyze_query_text(n.field, n.query)))
        elif isinstance(n, q.MultiMatchQuery):
            for f in n.fields:
                add(f, term_set_pred(ms.analyze_query_text(f, n.query)))
        elif isinstance(n, q.TermQuery):
            add(n.field, term_set_pred([str(n.value)]))
        elif isinstance(n, q.TermsQuery):
            add(n.field, term_set_pred([str(v) for v in n.values]))
        elif isinstance(n, q.PrefixQuery):
            p = n.value.lower()
            add(n.field, lambda tok, p=p: tok.lower().startswith(p))
        elif isinstance(n, (q.WildcardQuery,)):
            rx = _wildcard_rx(n.value.lower())
            add(n.field, lambda tok, rx=rx: rx.match(tok.lower()) is not None)
        elif isinstance(n, q.RegexpQuery):
            try:
                rx = re.compile(n.value)
            except re.error:
                return
            add(n.field, lambda tok, rx=rx: rx.fullmatch(tok) is not None)
        elif isinstance(n, q.FuzzyQuery):
            v = n.value
            d = _fuzziness_distance(n.fuzziness, v)
            add(n.field,
                lambda tok, v=v, d=d: _edit_distance_at_most(v, tok, d))
        elif isinstance(n, q.BoolQuery):
            for sub in (*n.must, *n.should, *n.filter):
                walk(sub)  # must_not terms are not highlighted
        elif isinstance(n, q.DisMaxQuery) or isinstance(n, q.HybridQuery):
            for sub in n.queries:
                walk(sub)
        elif isinstance(n, q.BoostingQuery):
            if n.positive is not None:
                walk(n.positive)
        elif isinstance(n, q.ConstantScoreQuery):
            if n.filter is not None:
                walk(n.filter)
        elif isinstance(n, q.FunctionScoreQuery):
            if n.query is not None:
                walk(n.query)
        elif isinstance(n, q.NestedQuery):
            if n.query is not None:
                walk(n.query)
        elif isinstance(n, (q.QueryStringQuery, q.SimpleQueryStringQuery)):
            raise NotImplementedError(
                "highlighting a query_string query is not yet ported to "
                "opensearch_tpu_torch")

    walk(node)
    return out


def _fuzziness_distance(fuzziness: str, term: str) -> int:
    f = str(fuzziness).upper()
    if f == "AUTO":
        n = len(term)
        return 0 if n < 3 else (1 if n <= 5 else 2)
    try:
        return int(f)
    except ValueError:
        raise IllegalArgumentException(f"invalid fuzziness [{fuzziness}]")


def _edit_distance_at_most(a: str, b: str, max_d: int) -> bool:
    """OSA (Damerau-Levenshtein with adjacent transpositions = 1 edit) with
    early exit — fuzzy queries default to transpositions=true like Lucene's
    LevenshteinAutomata(..., transpositions)."""
    if max_d == 0:
        return a == b
    la, lb = len(a), len(b)
    prev2: list[int] | None = None
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        row_min = i
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
            if (prev2 is not None and i > 1 and j > 1
                    and a[i - 1] == b[j - 2] and a[i - 2] == b[j - 1]):
                cur[j] = min(cur[j], prev2[j - 2] + 1)
            row_min = min(row_min, cur[j])
        if row_min > max_d:
            return False
        prev2, prev = prev, cur
    return prev[lb] <= max_d


# --------------------------------------------------------------------------
# highlight
# --------------------------------------------------------------------------

DEFAULT_FRAGMENT_SIZE = 100
DEFAULT_NUM_FRAGMENTS = 5


def highlight_field(
    text: str,
    preds: list[Callable[[str], bool]],
    ms: MapperService,
    field: str,
    pre_tag: str = "<em>",
    post_tag: str = "</em>",
    fragment_size: int = DEFAULT_FRAGMENT_SIZE,
    number_of_fragments: int = DEFAULT_NUM_FRAGMENTS,
) -> list[str]:
    """Plain highlighter: token spans whose analyzed form any predicate
    accepts are wrapped; fragments are windows around match clusters."""
    spans: list[tuple[int, int]] = []
    # memoize analysis + predicate decisions per distinct raw token — a
    # 1000-word field has far fewer distinct words than words, and each
    # analyze call builds the full chain (plain-highlighter token stream
    # equivalent without per-word re-analysis)
    decided: dict[str, bool] = {}
    for m in _WORD_RE.finditer(text):
        raw = m.group(0)
        hit = decided.get(raw)
        if hit is None:
            analyzed = ms.analyze_query_text(field, raw)
            tok = analyzed[0] if analyzed else raw.lower()
            hit = any(p(tok) or p(raw) for p in preds)
            decided[raw] = hit
        if hit:
            spans.append((m.start(), m.end()))
    if not spans:
        return []
    if number_of_fragments == 0:
        # whole-field highlighting
        return [_apply_tags(text, spans, pre_tag, post_tag)]
    # group spans into fragments of ~fragment_size chars
    fragments: list[tuple[int, int, list[tuple[int, int]]]] = []
    for s, e in spans:
        if fragments and s - fragments[-1][0] < fragment_size:
            fs, _fe, group = fragments[-1]
            fragments[-1] = (fs, max(_fe, e), group + [(s, e)])
        else:
            fragments.append((s, e, [(s, e)]))
    out = []
    for fs, fe, group in fragments[:number_of_fragments]:
        # expand the window to fragment_size, snapping to word boundaries
        lo = max(0, fs - max(0, (fragment_size - (fe - fs)) // 2))
        hi = min(len(text), lo + max(fragment_size, fe - fs))
        while lo > 0 and text[lo - 1].isalnum():
            lo -= 1
        while hi < len(text) and text[hi].isalnum():
            hi += 1
        rel = [(s - lo, e - lo) for s, e in group if s >= lo and e <= hi]
        out.append(_apply_tags(text[lo:hi], rel, pre_tag, post_tag))
    return out


def _apply_tags(text: str, spans: list[tuple[int, int]],
                pre: str, post: str) -> str:
    parts = []
    last = 0
    for s, e in spans:
        parts.append(text[last:s])
        parts.append(pre)
        parts.append(text[s:e])
        parts.append(post)
        last = e
    parts.append(text[last:])
    return "".join(parts)


def compute_highlight(
    body_highlight: dict,
    preds_by_field: dict[str, list[Callable[[str], bool]]],
    source: dict,
    ms: MapperService,
) -> dict[str, list[str]]:
    fields_conf = body_highlight.get("fields") or {}
    if isinstance(fields_conf, list):  # ["f1", {"f2": {...}}] form
        norm: dict[str, dict] = {}
        for f in fields_conf:
            if isinstance(f, str):
                norm[f] = {}
            else:
                norm.update(f)
        fields_conf = norm
    pre = (body_highlight.get("pre_tags") or ["<em>"])[0]
    post = (body_highlight.get("post_tags") or ["</em>"])[0]
    require_match = body_highlight.get("require_field_match", True)
    out: dict[str, list[str]] = {}
    flat = _flatten_source(source)
    for fname, conf in fields_conf.items():
        conf = conf or {}
        preds = preds_by_field.get(fname, [])
        if not preds and not require_match:
            preds = [p for ps in preds_by_field.values() for p in ps]
        if not preds:
            continue
        values = flat.get(fname)
        if values is None:
            continue
        if not isinstance(values, list):
            values = [values]
        frags: list[str] = []
        for v in values:
            if not isinstance(v, str):
                continue
            frags.extend(highlight_field(
                v, preds, ms, fname,
                pre_tag=conf.get("pre_tags", [pre])[0] if "pre_tags" in conf else pre,
                post_tag=conf.get("post_tags", [post])[0] if "post_tags" in conf else post,
                fragment_size=int(conf.get("fragment_size", DEFAULT_FRAGMENT_SIZE)),
                number_of_fragments=int(conf.get("number_of_fragments",
                                                 DEFAULT_NUM_FRAGMENTS)),
            ))
        if frags:
            out[fname] = frags
    return out


def _flatten_source(obj: dict, prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in obj.items():
        full = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_source(v, f"{full}."))
        else:
            out[full] = v
    return out


# --------------------------------------------------------------------------
# docvalue_fields / fields
# --------------------------------------------------------------------------


def docvalue_fields_for_doc(
    specs: list, host, doc: int, ms: MapperService
) -> dict[str, list]:
    """Columnar reads straight from the segment arrays (FetchDocValuesPhase:
    values come from doc-values, not _source)."""
    out: dict[str, list] = {}
    for spec in specs:
        if isinstance(spec, str):
            fname, fmt = spec, None
        else:
            fname, fmt = spec.get("field"), spec.get("format")
        if fname is None:
            continue
        vals = _doc_column_values(host, doc, fname, ms, fmt)
        if vals:
            # repeated specs for one field accumulate (the reference emits
            # one entry per requested format)
            out.setdefault(fname, []).extend(vals)
    return out


def _doc_column_values(host, doc: int, fname: str, ms: MapperService,
                       fmt: str | None) -> list:
    mapper = ms.field_mapper(fname)
    nf = host.numeric_fields.get(fname)
    if nf is not None and nf.present[doc]:
        vals = nf.doc_values(doc)
        if fmt and set(fmt) <= set("#,.0"):
            # decimal pattern (java DecimalFormat subset): '#.0' -> 1 place
            places = len(fmt.split(".")[1]) if "." in fmt else 0
            return [f"{float(v):.{places}f}" for v in vals]
        if nf.kind == "int":
            if mapper is not None and \
                    getattr(mapper, "original_type", None) == "unsigned_long":
                return [int(v) + 2**63 for v in vals]
            if mapper is not None and mapper.type == "date":
                if mapper.resolution == "nanos":
                    return [_format_date_nanos(int(v), fmt) for v in vals]
                return [_format_date_ms(int(v), fmt) for v in vals]
            if mapper is not None and mapper.type == "boolean":
                return [bool(v) for v in vals]
            return [int(v) for v in vals]
        return [float(v) for v in vals]
    kf = host.keyword_fields.get(fname)
    if kf is not None:
        s, e = int(kf.mv_offsets[doc]), int(kf.mv_offsets[doc + 1])
        return [kf.ord_values[int(o)] for o in kf.mv_ords[s:e]]
    return []


# joda/java-time pattern letters -> strftime (the common subset)
_JODA_MAP = [
    ("uuuu", "%Y"), ("yyyy", "%Y"), ("yy", "%y"), ("MM", "%m"),
    ("dd", "%d"), ("HH", "%H"), ("mm", "%M"), ("ss", "%S"),
]


def _format_date_nanos(ns_value: int, fmt: str | None) -> Any:
    """date_nanos doc-value rendering: 9-digit fractional ISO by default
    (strict_date_optional_time_nanos); epoch_millis renders fractional
    millis ("1540815132123.456789"); millis-resolution formats truncate."""
    from datetime import datetime, timezone

    if fmt == "epoch_millis":
        frac_ns = ns_value % 1_000_000
        ms = ns_value // 1_000_000
        if frac_ns:
            return f"{ms}.{frac_ns:06d}".rstrip("0")
        return str(ms)
    dt = datetime.fromtimestamp(ns_value // 1_000_000_000, tz=timezone.utc)
    if fmt in ("strict_date_optional_time", "date_optional_time"):
        ms_part = (ns_value // 1_000_000) % 1000
        return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{ms_part:03d}Z"
    if fmt and fmt not in ("strict_date_optional_time_nanos",):
        # custom java-time pattern with nanosecond fraction support
        out = fmt.replace("'", "")
        out = out.replace("XXX", "Z").replace("XX", "Z").replace("X", "Z")
        if "SSSSSSSSS" in out:
            out = out.replace("SSSSSSSSS", f"{ns_value % 1_000_000_000:09d}")
        elif "SSSSSS" in out:
            out = out.replace("SSSSSS", f"{ns_value % 1_000_000:06d}")
        elif "SSS" in out:
            out = out.replace("SSS", f"{(ns_value // 1_000_000) % 1000:03d}")
        for joda, strf in _JODA_MAP:
            out = out.replace(joda, strf)
        if "%" in out:
            return dt.strftime(out)
    frac = ns_value % 1_000_000_000
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{frac:09d}".rstrip("0").ljust(3, "0") + "Z"


def _format_date_ms(ms_value: int, fmt: str | None) -> Any:
    from datetime import datetime, timezone

    if fmt == "epoch_millis":
        return str(ms_value)
    dt = datetime.fromtimestamp(ms_value / 1000.0, tz=timezone.utc)
    if fmt is None or fmt.startswith("strict_date") or fmt == "date_optional_time":
        return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{ms_value % 1000:03d}Z"
    # joda-style custom pattern
    out = fmt.replace("'", "")
    out = out.replace("XXX", "Z").replace("XX", "Z").replace("X", "Z")
    if "SSSSSSSSS" in out:
        out = out.replace("SSSSSSSSS", f"{ms_value % 1000:03d}000000")
    elif "SSSSSS" in out:
        out = out.replace("SSSSSS", f"{ms_value % 1000:03d}000")
    elif "SSS" in out:
        out = out.replace("SSS", f"{ms_value % 1000:03d}")
    for joda, strf in _JODA_MAP:
        out = out.replace(joda, strf)
    if "%" in out:
        return dt.strftime(out)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{ms_value % 1000:03d}Z"


def fields_option_for_doc(
    specs: list, source: dict, host, doc: int, ms: MapperService
) -> dict[str, list]:
    """The `fields` request option (FetchFieldsPhase): values from _source
    with wildcard patterns, always arrays, doc-values fallback."""
    import fnmatch

    flat = _flatten_source(source)
    # fields mapped as ranges keep their object shape ({gte, lte}) instead
    # of flattening, and malformed-ignored values are omitted
    from opensearch_tpu_torch.index.mapper import RANGE_TYPES

    for fname in list(source):
        m = ms.field_mapper(fname)
        if m is not None and m.type in RANGE_TYPES:
            flat = {k: v for k, v in flat.items()
                    if not k.startswith(f"{fname}.")}
            flat[fname] = source[fname]
    ig = host.keyword_fields.get("_ignored")
    ignored: set = set()
    if ig is not None:
        s_, e_ = int(ig.mv_offsets[doc]), int(ig.mv_offsets[doc + 1])
        ignored = {ig.ord_values[int(o)] for o in ig.mv_ords[s_:e_]}
    out: dict[str, list] = {}
    for spec in specs:
        if isinstance(spec, str):
            pattern, fmt = spec, None
        else:
            pattern, fmt = spec.get("field"), spec.get("format")
        if pattern is None:
            continue
        matched = False
        for key, val in flat.items():
            if fnmatch.fnmatch(key, pattern):
                matched = True
                if key in out or key in ignored:
                    continue  # first spec wins; _ignored values are absent
                vals = val if isinstance(val, list) else [val]
                mapper = ms.field_mapper(key)
                if mapper is not None and mapper.type == "date" and fmt:
                    from opensearch_tpu_torch.index.mapper import parse_date_millis

                    vals = [_format_date_ms(parse_date_millis(v), fmt) for v in vals]
                elif mapper is not None and mapper.type == "token_count":
                    # derived fields read from doc-values, not _source
                    vals = _doc_column_values(host, doc, key, ms, fmt) or vals
                out[key] = list(vals)
        if not matched and "*" not in pattern:
            vals = _doc_column_values(host, doc, pattern, ms, fmt)
            if vals:
                out[pattern] = vals
    return out


# --------------------------------------------------------------------------
# explain
# --------------------------------------------------------------------------


def explain_for_hit(score: float, query_node: q.QueryNode) -> dict:
    """Simplified explanation tree (ExplainPhase): the top-level value is
    exact; the breakdown names the query shape rather than replaying every
    BM25 sub-term."""
    return {
        "value": score,
        "description": f"score({type(query_node).__name__})",
        "details": [],
    }
