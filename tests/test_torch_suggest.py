"""Suggesters in the port against the JAX reference, on the CPU: the term,
phrase and completion cases of tests/test_fetch_apis.py, and term and
phrase suggestions of misspelt words over a seeded corpus in one and in
three shards (written in two refreshes with deletes), beside a query and
in an ``_msearch``. The suggestions (texts, offsets, scores, freqs) and
the errors must be equal.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from test_torch_dsl import answer, pair, same
from test_torch_lexical import _word, corpus_docs


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    ref, port = pair(tmp_path_factory, "lib")
    for node in (ref, port):
        node.create_index("lib", {"mappings": {"properties": {
            "title": {"type": "text"}, "genre": {"type": "keyword"},
            "year": {"type": "long"}, "sugg": {"type": "completion"}}}})
        for _id, title, genre, year, sugg in (
                ("1", "the quick brown fox", "animal", 2001, "quick fox"),
                ("2", "quality quartz quarry", "mineral", 2005,
                 "quality stone"),
                ("3", "quiet quill writing", "craft", 2010, "quill pen")):
            node.index_doc("lib", _id, {"title": title, "genre": genre,
                                        "year": year, "sugg": sugg})
        for _id, inp, weight in (("4", ["quince jam"], 3),
                                 ("w1", ["quant low"], 2),
                                 ("w2", ["quant high"], 9)):
            node.index_doc("lib", _id, {"title": "x", "genre": "g",
                                        "year": 1, "sugg": {
                                            "input": inp, "weight": weight}})
        node.refresh("lib")
        for i, (name, shards) in enumerate((("c1", 1), ("c3", 3))):
            node.create_index(name, {
                "settings": {"number_of_shards": shards},
                "mappings": {"properties": {"body": {"type": "text"},
                                            "tag": {"type": "keyword"}}}})
            docs = corpus_docs(seed=7)[:200]
            ops = [("index", {"_index": name, "_id": str(j)},
                    {"body": d["body"], "tag": d["tag"]})
                   for j, d in enumerate(docs)]
            node.bulk(ops[:100])
            node.refresh(name)
            node.bulk(ops[100:] + [("delete", {"_index": name, "_id": d},
                                    None) for d in ("4", "120")])
            node.refresh(name)
    yield ref, port
    ref.close()
    port.close()


@pytest.mark.parametrize("suggest", [
    {"fix": {"text": "quick", "term": {"field": "title"}}},
    {"fix": {"text": "quik", "term": {"field": "title"}}},
    {"fix": {"text": "quick", "term": {"field": "title",
                                       "suggest_mode": "always"}}},
    {"fix": {"text": "quik quartx", "term": {"field": "title", "size": 2,
                                             "prefix_length": 0}}},
    {"fix": {"text": "Quik", "term": {"field": "genre", "max_edits": 1}}},
    {"ph": {"text": "quik fox", "phrase": {"field": "title"}}},
    {"ph": {"text": "the quiet quil", "phrase": {"field": "title",
                                                 "size": 2}}},
    {"c": {"prefix": "qu", "completion": {"field": "sugg"}}},
    {"c": {"prefix": "quin", "completion": {"field": "sugg"}}},
    {"c": {"prefix": "quant", "completion": {"field": "sugg"}}},
    {"c": {"prefix": "QU", "completion": {"field": "sugg", "size": 2}}},
    {"text": "quarz", "a": {"term": {"field": "title"}},
     "b": {"phrase": {"field": "title"}}},
    {"bad": {"term": {}}},
    {"bad": {"text": "x", "term": {}, "phrase": {}}},
    {"bad": {"term": {"field": "title"}}},
    {"bad": {"completion": {"field": "sugg"}}},
    {"bad": "x"},
])
def test_fetch_apis_suggestions_match_reference(lib, suggest):
    ref, port = lib
    got = same(ref, port, "lib", {"suggest": suggest})
    if got is not None:
        assert got["suggest"]


def _typo(word: str) -> str:
    """The word with its last two letters swapped (one transposition)."""
    return word[:-2] + word[-1] + word[-2] if len(word) > 3 else word + "q"


@pytest.mark.parametrize("index", ["c1", "c3"])
@pytest.mark.parametrize("kind", ["term", "phrase"])
def test_corpus_typos_suggest_their_words(lib, index, kind):
    """Misspelt corpus words: the port's suggestions are the reference's,
    and the word the typo came from is among them."""
    ref, port = lib
    words = [_word(i) for i in (3, 17, 40)]
    text = " ".join(_typo(w) for w in words)
    body = {"query": {"match": {"body": words[0]}},
            "suggest": {"s": {"text": text, kind: {"field": "body",
                                                   "size": 5}}}}
    got = same(ref, port, index, body)
    entries = got["suggest"]["s"]
    if kind == "term":
        for word, entry in zip(words, entries):
            assert word in [o["text"] for o in entry["options"]]
    else:
        assert " ".join(words) in [o["text"] for o in entries[0]["options"]]


def test_msearch_suggestions_match_reference(lib):
    ref, port = lib
    searches = [({"index": "c3"}, {"size": 0, "suggest": {"s": {
        "text": _typo(_word(5)), "term": {"field": "body"}}}}),
        ({"index": "lib"}, {"suggest": {"c": {"prefix": "qui",
                                              "completion": {
                                                  "field": "sugg"}}}})]
    want, got = answer(ref, port, lambda n: n.msearch(searches))
    assert [r["suggest"] for r in got["responses"]] == \
        [r["suggest"] for r in want["responses"]]
    assert np.all([r["suggest"] for r in got["responses"]])
