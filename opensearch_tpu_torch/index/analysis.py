"""Text analysis: tokenizers, token filters, analyzers, registry.

The analog of the reference's analysis chain
(server/src/main/java/org/opensearch/index/analysis/AnalysisRegistry.java and
modules/analysis-common): an Analyzer is a tokenizer plus an ordered list of
token filters, resolved by name from a registry that also accepts custom
definitions from index settings ("analysis": {"analyzer": {...}}).

All of this is host-side: analysis produces the term streams that the segment
builder turns into device postings arrays.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Iterable

from opensearch_tpu_torch.common.errors import IllegalArgumentException

# --------------------------------------------------------------------------
# Tokenizers: text -> list[str]
# --------------------------------------------------------------------------

# Unicode-aware word tokenizer: runs of word chars (letters/digits/underscore
# excluded -> we split on non-alphanumeric, matching Lucene's
# StandardTokenizer closely enough for the word-boundary cases in the YAML
# suite; full UAX#29 segmentation is a later refinement).
_STANDARD_RE = re.compile(r"[^\W_]+(?:[.'’][^\W_]+)*", re.UNICODE)
_LETTER_RE = re.compile(r"[^\W\d_]+", re.UNICODE)


def standard_tokenizer(text: str) -> list[str]:
    return _STANDARD_RE.findall(text)


def whitespace_tokenizer(text: str) -> list[str]:
    return text.split()


def letter_tokenizer(text: str) -> list[str]:
    return _LETTER_RE.findall(text)


def keyword_tokenizer(text: str) -> list[str]:
    return [text] if text else []


def ngram_tokenizer(min_gram: int = 1, max_gram: int = 2) -> Callable[[str], list[str]]:
    def tokenize(text: str) -> list[str]:
        out = []
        for n in range(min_gram, max_gram + 1):
            out.extend(text[i : i + n] for i in range(0, len(text) - n + 1))
        return out

    return tokenize


def edge_ngram_tokenizer(min_gram: int = 1, max_gram: int = 2) -> Callable[[str], list[str]]:
    def tokenize(text: str) -> list[str]:
        return [text[:n] for n in range(min_gram, min(max_gram, len(text)) + 1)]

    return tokenize


TOKENIZERS: dict[str, Callable[[str], list[str]]] = {
    "standard": standard_tokenizer,
    "whitespace": whitespace_tokenizer,
    "letter": letter_tokenizer,
    "keyword": keyword_tokenizer,
    "lowercase": lambda t: [tok.lower() for tok in letter_tokenizer(t)],
}

# --------------------------------------------------------------------------
# Token filters: list[str] -> list[str]
# --------------------------------------------------------------------------

ENGLISH_STOPWORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such
    that the their then there these they this to was will with""".split()
)


def lowercase_filter(tokens: list[str]) -> list[str]:
    return [t.lower() for t in tokens]


def uppercase_filter(tokens: list[str]) -> list[str]:
    return [t.upper() for t in tokens]


def stop_filter(stopwords: frozenset[str] = ENGLISH_STOPWORDS) -> Callable:
    def apply(tokens: list[str]) -> list[str]:
        return [t for t in tokens if t not in stopwords]

    return apply


def unique_filter(tokens: list[str]) -> list[str]:
    seen: set[str] = set()
    out = []
    for t in tokens:
        if t not in seen:
            seen.add(t)
            out.append(t)
    return out


def trim_filter(tokens: list[str]) -> list[str]:
    return [t.strip() for t in tokens]


def truncate_filter(length: int = 10) -> Callable:
    def apply(tokens: list[str]) -> list[str]:
        return [t[:length] for t in tokens]

    return apply


_ASCII_FOLD = str.maketrans(
    "àáâãäåçèéêëìíîïñòóôõöùúûüýÿÀÁÂÃÄÅÇÈÉÊËÌÍÎÏÑÒÓÔÕÖÙÚÛÜÝ",
    "aaaaaaceeeeiiiinooooouuuuyyAAAAAACEEEEIIIINOOOOOUUUUY",
)


def asciifolding_filter(tokens: list[str]) -> list[str]:
    return [t.translate(_ASCII_FOLD) for t in tokens]


def porter_stem(word: str) -> str:
    """Porter stemming algorithm (the reference's `porter_stem`/english
    stemmer default; implemented from the published algorithm)."""
    if len(word) <= 2:
        return word
    w = word

    vowels = "aeiou"

    def is_cons(s: str, i: int) -> bool:
        c = s[i]
        if c in vowels:
            return False
        if c == "y":
            return i == 0 or not is_cons(s, i - 1)
        return True

    def measure(s: str) -> int:
        # number of VC sequences
        m = 0
        i = 0
        n = len(s)
        while i < n and is_cons(s, i):
            i += 1
        while i < n:
            while i < n and not is_cons(s, i):
                i += 1
            if i >= n:
                break
            m += 1
            while i < n and is_cons(s, i):
                i += 1
        return m

    def has_vowel(s: str) -> bool:
        return any(not is_cons(s, i) for i in range(len(s)))

    def ends_double_cons(s: str) -> bool:
        return len(s) >= 2 and s[-1] == s[-2] and is_cons(s, len(s) - 1)

    def cvc(s: str) -> bool:
        if len(s) < 3:
            return False
        return (
            is_cons(s, len(s) - 3)
            and not is_cons(s, len(s) - 2)
            and is_cons(s, len(s) - 1)
            and s[-1] not in "wxy"
        )

    # Step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # Step 1b
    flag_1b = False
    if w.endswith("eed"):
        if measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed"):
        if has_vowel(w[:-2]):
            w = w[:-2]
            flag_1b = True
    elif w.endswith("ing"):
        if has_vowel(w[:-3]):
            w = w[:-3]
            flag_1b = True
    if flag_1b:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif ends_double_cons(w) and w[-1] not in "lsz":
            w = w[:-1]
        elif measure(w) == 1 and cvc(w):
            w += "e"

    # Step 1c
    if w.endswith("y") and has_vowel(w[:-1]):
        w = w[:-1] + "i"

    # Step 2
    step2 = [
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
        ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ]
    for suf, rep in step2:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if measure(stem) > 0:
                w = stem + rep
            break

    # Step 3
    step3 = [
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ]
    for suf, rep in step3:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if measure(stem) > 0:
                w = stem + rep
            break

    # Step 4
    step4 = [
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ]
    for suf in step4:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" and measure(w[:-3]) > 1:
            w = w[:-3]

    # Step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = measure(stem)
        if m > 1 or (m == 1 and not cvc(stem)):
            w = stem
    # Step 5b
    if measure(w) > 1 and ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]

    return w


def porter_stem_filter(tokens: list[str]) -> list[str]:
    return [porter_stem(t) for t in tokens]


def build_token_filter(name: str, config: dict | None = None) -> Callable:
    config = config or {}
    if name == "lowercase":
        return lowercase_filter
    if name == "uppercase":
        return uppercase_filter
    if name == "stop":
        words = config.get("stopwords", "_english_")
        if words == "_english_":
            return stop_filter()
        if words == "_none_":
            return stop_filter(frozenset())
        return stop_filter(frozenset(words))
    if name == "asciifolding":
        return asciifolding_filter
    if name in ("porter_stem", "stemmer", "kstem"):
        return porter_stem_filter
    if name == "unique":
        return unique_filter
    if name == "trim":
        return trim_filter
    if name == "truncate":
        return truncate_filter(int(config.get("length", 10)))
    if name == "reverse":
        return lambda toks: [t[::-1] for t in toks]
    raise IllegalArgumentException(f"unknown token filter [{name}]")


# --------------------------------------------------------------------------
# Analyzers
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Analyzer:
    name: str
    tokenizer: Callable[[str], list[str]]
    filters: tuple[Callable[[list[str]], list[str]], ...] = ()

    def analyze(self, text: str) -> list[str]:
        tokens = self.tokenizer(text)
        for f in self.filters:
            tokens = f(tokens)
        return tokens

    def analyze_with_offsets(self, text: str) -> list[tuple]:
        """[(term, start_offset, end_offset, position)] — character spans
        from the tokenizer, positions counted pre-filter so dropped tokens
        (stopwords) leave position gaps like Lucene's posInc. Tokenizers
        without span support fall back to zero offsets.

        The offset stream RECONCILES against analyze(text) (the indexing
        pipeline): per-token filter application cannot see stream state
        (e.g. the `unique` filter's seen-set), so any token the full-stream
        pass drops is dropped here too — term_freq from this path always
        agrees with the indexed postings."""
        span_fn = _SPAN_TOKENIZERS.get(self.tokenizer)
        if span_fn is None:
            return [(t, 0, 0, i) for i, t in enumerate(self.analyze(text))]
        per_tok = []
        for pos, (tok, s, e) in enumerate(span_fn(text)):
            cur = [tok]
            for f in self.filters:
                cur = f(cur)
                if not cur:
                    break
            if cur:
                per_tok.append((cur[0], s, e, pos))
        expected = self.analyze(text)
        out = []
        j = 0
        for term, s, e, pos in per_tok:
            if j < len(expected) and expected[j] == term:
                out.append((term, s, e, pos))
                j += 1
        return out


def _spans(regex: "re.Pattern") -> Callable[[str], list[tuple]]:
    return lambda text: [(m.group(), m.start(), m.end())
                         for m in regex.finditer(text)]


_WS_RE = re.compile(r"\S+")
_SPAN_TOKENIZERS: dict[Callable, Callable[[str], list[tuple]]] = {
    standard_tokenizer: _spans(_STANDARD_RE),
    letter_tokenizer: _spans(_LETTER_RE),
    whitespace_tokenizer: _spans(_WS_RE),
    keyword_tokenizer: lambda text: [(text, 0, len(text))] if text else [],
}


def _builtin_analyzers() -> dict[str, Analyzer]:
    return {
        "standard": Analyzer("standard", standard_tokenizer, (lowercase_filter,)),
        "simple": Analyzer("simple", letter_tokenizer, (lowercase_filter,)),
        "whitespace": Analyzer("whitespace", whitespace_tokenizer),
        "keyword": Analyzer("keyword", keyword_tokenizer),
        "stop": Analyzer("stop", letter_tokenizer, (lowercase_filter, stop_filter())),
        "english": Analyzer(
            "english",
            standard_tokenizer,
            (lowercase_filter, stop_filter(), porter_stem_filter),
        ),
    }


@dataclass
class AnalysisRegistry:
    """Named analyzers for one index, built-ins + custom from settings."""

    analyzers: dict[str, Analyzer] = field(default_factory=_builtin_analyzers)

    def get(self, name: str) -> Analyzer:
        a = self.analyzers.get(name)
        if a is None:
            raise IllegalArgumentException(f"failed to find analyzer [{name}]")
        return a

    @staticmethod
    def from_index_settings(analysis_config: dict | None) -> "AnalysisRegistry":
        """Build from the `analysis` section of index settings:
        {"analyzer": {"my_an": {"tokenizer": "standard", "filter": ["lowercase"]}},
         "filter": {"my_stop": {"type": "stop", "stopwords": [...]}}}
        """
        reg = AnalysisRegistry()
        if not analysis_config:
            return reg
        custom_filters: dict[str, Callable] = {}
        for fname, fconf in (analysis_config.get("filter") or {}).items():
            ftype = fconf.get("type")
            if ftype is None:
                raise IllegalArgumentException(f"token filter [{fname}] must have a type")
            custom_filters[fname] = build_token_filter(ftype, fconf)
        for aname, aconf in (analysis_config.get("analyzer") or {}).items():
            atype = aconf.get("type", "custom")
            if atype != "custom" and "tokenizer" not in aconf:
                # alias of a builtin
                reg.analyzers[aname] = reg.get(atype)
                continue
            tok_name = aconf.get("tokenizer", "standard")
            tokenizer = TOKENIZERS.get(tok_name)
            if tokenizer is None:
                raise IllegalArgumentException(f"unknown tokenizer [{tok_name}]")
            filters: list[Callable] = []
            for fname in aconf.get("filter", []):
                if fname in custom_filters:
                    filters.append(custom_filters[fname])
                else:
                    filters.append(build_token_filter(fname))
            reg.analyzers[aname] = Analyzer(aname, tokenizer, tuple(filters))
        return reg


def analyze(text: str, analyzer: Analyzer) -> list[str]:
    return analyzer.analyze(text)
