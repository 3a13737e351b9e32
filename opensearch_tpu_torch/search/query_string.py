"""Lucene-style query_string / simple_query_string mini-language parsers.

Counterpart of opensearch_tpu/search/query_string.py, a copy with its
imports pointed at this package (host-only: it builds query trees). The
analog of the reference's QueryStringQueryParser / SimpleQueryStringParser
(server/.../index/query/QueryStringQueryBuilder.java,
SimpleQueryStringBuilder.java — which delegate to Lucene's classic and simple
query parsers). Both produce trees of the same QueryNode types as the JSON
DSL, so execution is shared with every other query.

Supported subset:
- query_string: AND/OR/NOT (and &&/||/!), parentheses, field:term,
  quoted phrases, wildcard terms (* and ?), prefix terms (trailing *),
  bare terms combined with default_operator.
- simple_query_string: + (AND), | (OR), - (NOT), quoted phrases,
  trailing-* prefix, parentheses; invalid syntax degrades to terms
  (the "simple" contract: never throws on user input).
"""

from __future__ import annotations

import re

from opensearch_tpu_torch.common.errors import ParsingException
from opensearch_tpu_torch.search import query_dsl as q

_TOKEN_RE = re.compile(
    r"""
    \s*(
        \(|\)                          # parens
        | "(?:[^"\\]|\\.)*"(?:~\d+)?   # quoted phrase (+ optional ~N slop)
        | /(?:[^/\\]|\\.)*/            # /regex/ literal
        | (?:[^\s()":]+:)              # field prefix
        | [^\s()"]+                    # bare term
    )
    """,
    re.VERBOSE,
)


def _tokenize(s: str) -> list[str]:
    out, pos = [], 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if m is None:
            break
        out.append(m.group(1))
        pos = m.end()
    return out


def _term_node(field: str, text: str) -> q.QueryNode:
    if text.startswith('"'):
        # "..." or "..."~N (sloppy phrase, classic parser's proximity)
        m = re.fullmatch(r'("(?:[^"\\]|\\.)*")(?:~(\d+))?', text)
        if m is not None:
            return q.MatchPhraseQuery(
                field=field,
                query=m.group(1)[1:-1].replace('\\"', '"'),
                slop=int(m.group(2)) if m.group(2) else 0,
            )
    if text.startswith("/") and text.endswith("/") and len(text) >= 2:
        # /regex/ syntax (classic parser's RegexpQuery clause)
        return q.RegexpQuery(field=field, value=text[1:-1])
    if "*" in text or "?" in text:
        return q.WildcardQuery(field=field, value=text)
    m = re.fullmatch(r"(.+)~(\d+(?:\.\d+)?)?", text)
    if m is not None:
        # term~ (AUTO) or term~N; N goes through Lucene's
        # FuzzyQuery.floatToEdits: >=1 caps at 2 edits, a fraction is a
        # legacy minimum-similarity converted to edits by term length
        fuzz = "AUTO"
        if m.group(2):
            f = float(m.group(2))
            if f >= 1.0:
                edits = int(min(f, 2))
            elif f == 0.0:
                edits = 0
            else:
                edits = min(int((1.0 - f) * len(m.group(1))), 2)
            fuzz = str(edits)
        return q.FuzzyQuery(field=field, value=m.group(1), fuzziness=fuzz)
    return q.MatchQuery(field=field, query=text)


def _multi_field(fields: list[str], text: str) -> q.QueryNode:
    if len(fields) == 1:
        return _term_node(fields[0], text)
    return q.DisMaxQuery(queries=[_term_node(f, text) for f in fields])


class _QSParser:
    def __init__(self, tokens: list[str], fields: list[str], default_op: str):
        self.tokens = tokens
        self.i = 0
        self.fields = fields
        self.default_op = default_op

    def peek(self) -> str | None:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def next(self) -> str:
        t = self.tokens[self.i]
        self.i += 1
        return t

    def parse(self) -> q.QueryNode:
        node = self.parse_or()
        if self.peek() is not None:
            raise ParsingException(f"unexpected token [{self.peek()}] in query_string")
        return node

    def parse_or(self) -> q.QueryNode:
        parts = [self.parse_and()]
        while self.peek() in ("OR", "||"):
            self.next()
            parts.append(self.parse_and())
        if len(parts) == 1:
            return parts[0]
        return q.BoolQuery(should=parts, minimum_should_match=1)

    def parse_and(self) -> q.QueryNode:
        # Lucene classic-parser semantics: NOT produces a prohibited clause
        # on the ENCLOSING boolean (brown NOT dog == should:[brown],
        # must_not:[dog]), not a standalone negative query.
        clauses = [self.parse_not()]          # list of (negated, node)
        explicit_and = False
        while True:
            t = self.peek()
            if t in ("AND", "&&"):
                self.next()
                explicit_and = True
                clauses.append(self.parse_not())
                continue
            if t is None or t in ("OR", "||", ")"):
                break
            clauses.append(self.parse_not())
        positives = [n for neg, n in clauses if not neg]
        negatives = [n for neg, n in clauses if neg]
        if len(clauses) == 1 and negatives:
            return q.BoolQuery(must_not=negatives)
        if len(positives) == 1 and not negatives:
            return positives[0]
        if explicit_and or self.default_op == "and":
            return q.BoolQuery(must=positives, must_not=negatives)
        return q.BoolQuery(
            should=positives, must_not=negatives,
            minimum_should_match=1 if positives else None,
        )

    def parse_not(self) -> tuple[bool, q.QueryNode]:
        """Returns (negated, node)."""
        t = self.peek()
        if t in ("NOT", "!"):
            self.next()
            neg, node = self.parse_not()
            return (not neg, node)
        # leading -/!/+ operators apply even when glued to a field prefix
        # token ("-status:deleted" tokenizes as ["-status:", "deleted"])
        if t is not None and len(t) > 1 and t[0] in "-!":
            self.next()
            self.tokens.insert(self.i, t[1:])
            neg, node = self.parse_not()
            return (not neg, node)
        if t is not None and len(t) > 1 and t[0] == "+":
            self.next()
            self.tokens.insert(self.i, t[1:])
            return self.parse_not()
        return (False, self.parse_primary())

    def parse_primary(self) -> q.QueryNode:
        t = self.peek()
        if t is None:
            raise ParsingException("unexpected end of query_string")
        if t == "(":
            self.next()
            node = self.parse_or()
            if self.peek() != ")":
                raise ParsingException("unbalanced parentheses in query_string")
            self.next()
            return node
        t = self.next()
        if t.endswith(":") and len(t) > 1:
            field = t[:-1]
            nxt = self.peek()
            if nxt == "(":
                # field:(a OR b) — rescope a sub-expression to one field
                self.next()
                sub = _QSParser(self._collect_group(), [field], self.default_op)
                return sub.parse()
            if nxt is None:
                raise ParsingException(f"missing value after [{field}:]")
            if nxt[:1] in "[{":
                # field:[a TO b] / field:{a TO b} (classic-parser range
                # syntax; brackets inclusive, braces exclusive, * open)
                return self._parse_range_syntax(field)
            return _term_node(field, self.next())
        return _multi_field(self.fields, t)

    def _parse_range_syntax(self, field: str) -> q.QueryNode:
        open_tok = self.next()
        inc_lo = open_tok[0] == "["
        parts = [open_tok[1:]] if len(open_tok) > 1 else []
        close_tok = None
        while self.peek() is not None:
            t = self.next()
            if t.endswith("]") or t.endswith("}"):
                close_tok = t
                break
            parts.append(t)
        if close_tok is None:
            raise ParsingException(
                f"unclosed range syntax after [{field}:]")
        inc_hi = close_tok.endswith("]")
        if len(close_tok) > 1:
            parts.append(close_tok[:-1])
        vals = [p for p in parts if p and p.upper() != "TO"]
        if len(vals) != 2:
            raise ParsingException(
                f"range syntax after [{field}:] needs [lo TO hi], "
                f"got {vals}")
        lo = None if vals[0] == "*" else vals[0]
        hi = None if vals[1] == "*" else vals[1]
        return q.RangeQuery(
            field=field,
            gte=lo if inc_lo else None,
            gt=None if inc_lo else lo,
            lte=hi if inc_hi else None,
            lt=None if inc_hi else hi,
        )

    def _collect_group(self) -> list[str]:
        depth, out = 1, []
        while self.i < len(self.tokens):
            t = self.next()
            if t == "(":
                depth += 1
            elif t == ")":
                depth -= 1
                if depth == 0:
                    return out
            out.append(t)
        raise ParsingException("unbalanced parentheses in query_string")


def parse_query_string(
    query: str, fields: list[str], default_operator: str = "or"
) -> q.QueryNode:
    tokens = _tokenize(query)
    if not tokens:
        return q.MatchNoneQuery()
    return _QSParser(tokens, fields, default_operator).parse()


# --------------------------------------------------------------------------
# simple_query_string: +/|/- flavor, never throws on bad syntax
# --------------------------------------------------------------------------


def parse_simple_query_string(
    query: str, fields: list[str], default_operator: str = "or"
) -> q.QueryNode:
    try:
        return _SQSParser(_tokenize(query), fields, default_operator).parse()
    except ParsingException:
        # "simple" contract: degrade to a bag-of-terms match
        terms = [t for t in re.split(r"[\s+|()-]+", query) if t and t != '"']
        if not terms:
            return q.MatchNoneQuery()
        return q.BoolQuery(
            should=[_multi_field(fields, t) for t in terms],
            minimum_should_match=1,
        )


class _SQSParser(_QSParser):
    def parse_or(self) -> q.QueryNode:
        parts = [self.parse_and()]
        while self.peek() == "|":
            self.next()
            parts.append(self.parse_and())
        if len(parts) == 1:
            return parts[0]
        return q.BoolQuery(should=parts, minimum_should_match=1)

    def parse_and(self) -> q.QueryNode:
        clauses = [self.parse_not()]
        explicit_and = False
        while True:
            t = self.peek()
            if t == "+":
                self.next()
                explicit_and = True
                clauses.append(self.parse_not())
                continue
            if t is None or t in ("|", ")"):
                break
            clauses.append(self.parse_not())
        positives = [n for neg, n in clauses if not neg]
        negatives = [n for neg, n in clauses if neg]
        if len(clauses) == 1 and negatives:
            return q.BoolQuery(must_not=negatives)
        if len(positives) == 1 and not negatives:
            return positives[0]
        if explicit_and or self.default_op == "and":
            return q.BoolQuery(must=positives, must_not=negatives)
        return q.BoolQuery(
            should=positives, must_not=negatives,
            minimum_should_match=1 if positives else None,
        )

    def parse_not(self) -> tuple[bool, q.QueryNode]:
        t = self.peek()
        if t == "-":
            self.next()
            neg, node = self.parse_not()
            return (not neg, node)
        if t is not None and len(t) > 1 and t[0] == "-":
            self.next()
            self.tokens.insert(self.i, t[1:])
            neg, node = self.parse_not()
            return (not neg, node)
        return (False, self.parse_primary())

    def parse_primary(self) -> q.QueryNode:  # type: ignore[override]
        t = self.peek()
        if t is None:
            raise ParsingException("unexpected end of simple_query_string")
        if t == "(":
            self.next()
            node = self.parse_or()
            if self.peek() != ")":
                raise ParsingException("unbalanced parens")
            self.next()
            return node
        t = self.next()
        if t in ("+", "|", "-", ")"):
            raise ParsingException(f"unexpected [{t}]")
        # no field:term syntax in simple_query_string; ':' is part of the term
        if t.endswith(":"):
            t = t[:-1]
        return _multi_field(self.fields, t)
