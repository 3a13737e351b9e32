"""Request keys of `_search` on TorchNode(device="cpu") against TpuNode:
a key the reference does not know is the reference's ParsingException (a
400, "unknown search request keys [...]") on both nodes; every key
the reference knows answers as the reference's does."""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.common.errors import ParsingException as JaxParsing
from opensearch_tpu.node import TpuNode
from opensearch_tpu_torch.common.errors import ParsingException
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.search import service

KNN = {"knn": {"v": {"vector": [1.0, 1.0, 1.0, 1.0], "k": 2}}}


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    ref = TpuNode(tmp_path_factory.mktemp("tpu"))
    port = TorchNode(tmp_path_factory.mktemp("torch"), device="cpu")
    for node in (ref, port):
        node.create_index("i", {"mappings": {"properties": {
            "v": {"type": "knn_vector", "dimension": 4},
            "title": {"type": "keyword"}}}})
        node.bulk([("index", {"_index": "i", "_id": str(i)},
                    {"v": np.full(4, i, np.float32).tolist(),
                     "title": f"t{i % 2}"}) for i in range(6)], refresh=True)
    yield ref, port
    ref.close()
    port.close()


@pytest.mark.parametrize("extra", [{"bogus": 1}, {"bogus": 1, "aggs": {}},
                                   {"sizee": 3, "frm": 0}])
def test_unknown_key_is_the_references_parsing_exception(nodes, extra):
    ref, port = nodes
    body = {"query": KNN, **extra}
    with pytest.raises(JaxParsing) as want:
        ref.search("i", body)
    with pytest.raises(ParsingException) as got:
        port.search("i", body)
    assert str(got.value) == str(want.value)
    assert "unknown search request keys" in str(got.value)
    assert got.value.status == want.value.status == 400


@pytest.mark.parametrize("extra", [
    {"aggs": {"t": {"terms": {"field": "title"}}}},
    {"suggest": {"s": {"text": "t0", "term": {"field": "title"}}}},
    {"script_fields": {"x": {"script": {"source": "1"}}}},
    {"slice": {"id": 0, "max": 1}}])
def test_known_unported_key_is_not_yet_ported(nodes, extra):
    """Every key the reference knows is served now: ``aggs``,
    ``suggest``, ``script_fields`` and ``slice`` answer as the
    reference's do (the same hits, aggregations, suggestions and script
    fields)."""
    ref, port = nodes
    body = {"query": KNN, **extra}
    want = ref.search("i", body)
    assert want["hits"]["hits"]
    got = port.search("i", body)
    assert ([(h["_id"], h.get("fields")) for h in got["hits"]["hits"]]
            == [(h["_id"], h.get("fields")) for h in want["hits"]["hits"]])
    assert got["hits"]["total"] == want["hits"]["total"]
    for key in ("aggregations", "suggest"):
        assert got.get(key) == want.get(key)
    if "aggs" in extra:
        assert got["aggregations"]["t"]["buckets"]
    if "script_fields" in extra:
        assert all(h["fields"]["x"] == [1] for h in got["hits"]["hits"])


def test_known_keys_are_the_references():
    """The port's copy of the reference's key set, every key of it
    served: no request key is left outside the port."""
    assert not hasattr(service, "UNPORTED_KEYS")
    assert len(service.KNOWN_KEYS) == 28
