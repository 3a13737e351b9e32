"""Suggesters: term, phrase and completion.

Counterpart of opensearch_tpu/search/suggest.py, a host copy: the term
suggester's candidates come from each segment's term dictionary by
optimal-string-alignment distance (ranked by similarity, then doc
frequency), the phrase suggester takes the best corrections a token in a
beam, and the completion suggester matches prefixes of a field's values
ranked by weight. The dictionaries live on the host side of each segment
(HostTextField.terms, HostKeywordField.ord_values), so suggesting never
touches the device, as the reference's suggesters read Lucene's terms
enum and not the scorer.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from opensearch_tpu_torch.common.errors import ParsingException


def _damerau_osa(a: str, b: str, cap: int) -> int:
    """Optimal-string-alignment distance with early cap."""
    la, lb = len(a), len(b)
    if abs(la - lb) > cap:
        return cap + 1
    prev2: list[int] = []
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        row_min = cur[0]
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
            if i > 1 and j > 1 and a[i - 1] == b[j - 2] and a[i - 2] == b[j - 1]:
                cur[j] = min(cur[j], prev2[j - 2] + 1)
            row_min = min(row_min, cur[j])
        if row_min > cap:
            return cap + 1
        prev2, prev = prev, cur
    return prev[lb]


def _term_stats(segments: list, field: str) -> dict[str, int]:
    """term -> doc freq across the shard's segments (text or keyword)."""
    freqs: dict[str, int] = {}
    for host, _dev in segments:
        tf = host.text_fields.get(field)
        if tf is not None:
            for term in tf.terms:
                freqs[term] = freqs.get(term, 0) + tf.doc_freq(term)
            continue
        kf = host.keyword_fields.get(field)
        if kf is not None:
            counts = np.bincount(
                kf.mv_ords[kf.mv_ords >= 0], minlength=len(kf.ord_values)
            )
            for ord_, value in enumerate(kf.ord_values):
                freqs[value] = freqs.get(value, 0) + int(counts[ord_])
    return freqs


def _suggest_terms_for(
    text: str, freqs: dict[str, int], max_edits: int, size: int,
    prefix_length: int = 1,
) -> list[dict]:
    out = []
    for term, freq in freqs.items():
        if term == text or freq <= 0:
            continue
        if prefix_length and term[:prefix_length] != text[:prefix_length]:
            continue
        dist = _damerau_osa(text, term, max_edits)
        if dist > max_edits:
            continue
        score = 1.0 - dist / max(len(text), len(term), 1)
        out.append({"text": term, "score": round(score, 6), "freq": freq})
    out.sort(key=lambda o: (-o["score"], -o["freq"], o["text"]))
    return out[:size]


def _analyze_token(token: str, field: str, mapper_services: list) -> str | None:
    """Analyzed form of one raw token via the field's analyzer (None when
    the analyzer eats it, e.g. a stopword); falls back to lowercasing for
    unmapped / non-text fields so keyword corpora still work."""
    for ms in mapper_services:
        mapper = ms.field_mapper(field)
        if mapper is not None:
            if mapper.type != "text":
                return token
            terms = ms.analyze_query_text(field, token)
            return terms[0] if terms else None
    return token.lower()


def compute_suggest(
    suggest_body: dict, shards_segments: list[list], mapper_services: list,
) -> dict[str, Any]:
    """suggest_body: {name: {text, term|phrase|completion: {...}}}.

    shards_segments[i] is shard i's [(host, dev), ...]; suggestions reduce
    over all shards (doc-freq summed), like the coordinator's suggest
    reduce (search/suggest/Suggest.java group-and-merge)."""
    global_text = suggest_body.get("text")
    out: dict[str, Any] = {}
    all_segments = [seg for segs in shards_segments for seg in segs]
    for name, conf in suggest_body.items():
        if name == "text":
            continue
        if not isinstance(conf, dict):
            raise ParsingException(f"suggestion [{name}] must be an object")
        kinds = [k for k in ("term", "phrase", "completion") if k in conf]
        if len(kinds) != 1:
            raise ParsingException(
                f"suggestion [{name}] requires exactly one of "
                "[term, phrase, completion]"
            )
        kind = kinds[0]
        sconf = conf[kind] or {}
        text = conf.get("text", global_text)
        if text is None and kind != "completion":
            raise ParsingException(f"suggestion [{name}] requires [text]")
        if kind == "completion":
            text = conf.get("prefix", text)
            if text is None:
                raise ParsingException(
                    f"completion suggestion [{name}] requires [prefix]"
                )
        field = sconf.get("field")
        if not field:
            raise ParsingException(f"suggestion [{name}] requires [field]")
        size = int(sconf.get("size", 5))
        if kind == "term":
            out[name] = _term_suggest(
                text, field, sconf, size, all_segments, mapper_services
            )
        elif kind == "phrase":
            out[name] = _phrase_suggest(
                text, field, sconf, size, all_segments, mapper_services
            )
        else:
            out[name] = _completion_suggest(text, field, size, all_segments)
    return out


def _term_suggest(text, field, sconf, size, segments,
                  mapper_services=()) -> list[dict]:
    max_edits = min(int(sconf.get("max_edits", 2)), 2)
    prefix_length = int(sconf.get("prefix_length", 1))
    freqs = _term_stats(segments, field)
    entries = []
    offset = 0
    for token in str(text).split():
        analyzed = _analyze_token(token, field, mapper_services)
        options = (
            _suggest_terms_for(analyzed, freqs, max_edits, size, prefix_length)
            if analyzed is not None else []
        )
        # suggest_mode=missing (default): only suggest for unknown terms
        mode = sconf.get("suggest_mode", "missing")
        if (mode == "missing" and analyzed is not None
                and freqs.get(analyzed, 0) > 0):
            options = []
        entries.append({
            "text": token, "offset": offset, "length": len(token),
            "options": options,
        })
        offset += len(token) + 1
    return entries


def _phrase_suggest(text, field, sconf, size, segments,
                    mapper_services=()) -> list[dict]:
    """Greedy best-correction-per-token phrase candidates."""
    freqs = _term_stats(segments, field)
    raw = str(text).split()
    tokens = [
        t for t in (
            _analyze_token(tok, field, mapper_services) for tok in raw
        ) if t is not None
    ]
    per_token: list[list[tuple[str, float]]] = []
    for tok in tokens:
        if freqs.get(tok, 0) > 0:
            per_token.append([(tok, 1.0)])
            continue
        cands = _suggest_terms_for(tok, freqs, 2, 3)
        per_token.append(
            [(c["text"], c["score"]) for c in cands] or [(tok, 0.1)]
        )
    # beam over per-token candidates (width = size)
    beams: list[tuple[list[str], float]] = [([], 1.0)]
    for cands in per_token:
        beams = [
            (path + [w], score * s)
            for path, score in beams
            for w, s in cands
        ]
        beams.sort(key=lambda b: -b[1])
        beams = beams[: max(size, 5)]
    options = []
    seen = set()
    for path, score in beams:
        phrase = " ".join(path)
        if phrase == " ".join(tokens) or phrase in seen:
            continue
        seen.add(phrase)
        options.append({"text": phrase, "score": round(score, 6)})
    return [{
        "text": text, "offset": 0, "length": len(str(text)),
        "options": options[:size],
    }]


def _completion_suggest(prefix, field, size, segments) -> list[dict]:
    """Prefix match over completion inputs, ranked by (-weight, text) like
    the reference FST suggester (weight defaults to 1 when unset)."""
    prefix_l = str(prefix).lower()
    matches: dict[str, int] = {}
    for host, _dev in segments:
        kf = host.keyword_fields.get(field)
        values: list[str] = []
        if kf is not None:
            values = kf.ord_values
        else:
            tf = host.text_fields.get(field)
            if tf is not None:
                values = tf.terms
        weights = host.completion_weights.get(field, {})
        for v in values:
            if v.lower().startswith(prefix_l):
                w = int(weights.get(v, 1))
                matches[v] = max(matches.get(v, 0), w)
    ranked = sorted(matches.items(), key=lambda kv: (-kv[1], kv[0]))
    return [{
        "text": prefix, "offset": 0, "length": len(str(prefix)),
        "options": [
            {"text": v, "_id": None, "_index": None, "score": float(w)}
            for v, w in ranked[:size]
        ],
    }]
