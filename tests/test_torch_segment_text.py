"""A sealed segment's text postings: TorchNode against TpuNode.

The port builds a text field's postings by sorting every token's
(term_id, doc, position) once (index/segment.py ``_build_text``); the
reference walks terms and docs in Python. On the same documents (made from
a numpy seed: repeated terms, multi-valued fields with their position
gap, empty strings, docs without the field, a keyword sub-field) each
shard's segment must hold the same terms, term dictionary, offsets,
postings, term frequencies, positions, doc lengths, totals and counts,
tolerance 0.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu_torch.node import TorchNode

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
         "Theta", "iota", "kappa", "lambda", "mu"]

MAPPING = {"properties": {
    "body": {"type": "text"},
    "title": {"type": "text", "fields": {"raw": {"type": "keyword"}}},
    "n": {"type": "long"}}}


def _docs(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        doc: dict = {"n": i}
        kind = i % 5
        words = [WORDS[j] for j in rng.integers(0, len(WORDS),
                                                rng.integers(1, 12))]
        if kind == 1:
            doc["body"] = [" ".join(words[:3]), " ".join(words[3:])]
        elif kind == 2:
            doc["body"] = ""
        elif kind != 3:
            doc["body"] = " ".join(words + words[:2])
        if i % 3:
            doc["title"] = " ".join(words[::-1][:4])
        out.append(doc)
    return out


def _text_fields(node, index: str) -> list:
    out = []
    for sid in sorted(node.indices[index].shards):
        shard = node.indices[index].shards[sid]
        for host, _dev in shard.acquire_searcher().segments:
            for name in sorted(host.text_fields):
                out.append((sid, host.name, name, host.text_fields[name]))
    return out


@pytest.mark.parametrize("seed,n_docs,shards", [(1, 40, 1), (2, 300, 2),
                                                (3, 7, 3)])
def test_text_postings_are_the_references(tmp_path, seed, n_docs, shards):
    docs = _docs(seed, n_docs)
    nodes = (TpuNode(tmp_path / "ref"),
             TorchNode(tmp_path / "port", device="cpu"))
    try:
        for node in nodes:
            node.create_index("t", {"settings": {"number_of_shards": shards},
                                    "mappings": MAPPING})
            half = n_docs // 2
            for lo, hi in ((0, half), (half, n_docs)):
                node.bulk([("index", {"_index": "t", "_id": str(i)},
                            docs[i]) for i in range(lo, hi)], refresh=True)
        ref, port = (_text_fields(n, "t") for n in nodes)
        assert [r[:3] for r in ref] == [p[:3] for p in port]
        assert ref
        for (_s, _seg, name, want), (*_key, got) in zip(ref, port):
            assert got.terms == want.terms, name
            assert got.term_dict == want.term_dict, name
            for attr in ("term_offsets", "postings_docs", "postings_tfs",
                         "doc_len", "pos_offsets", "positions"):
                a, b = getattr(got, attr), getattr(want, attr)
                assert a.dtype == b.dtype, (name, attr)
                np.testing.assert_array_equal(a, b, err_msg=f"{name}.{attr}")
            assert got.total_terms == want.total_terms
            assert got.docs_with_field == want.docs_with_field
    finally:
        for node in nodes:
            node.close()
