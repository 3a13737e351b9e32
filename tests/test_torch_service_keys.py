"""Request keys of `_search` on TorchNode(device="cpu") against TpuNode:
a key the reference does not know is the reference's ParsingException (a
400, "unknown search request keys [...]") on both nodes; a key the
reference knows and the port does not serve yet raises "not yet ported" on
the port and is served by the reference."""

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
    ref, port = nodes
    body = {"query": KNN, **extra}
    assert ref.search("i", body)["hits"]["hits"]
    with pytest.raises(NotImplementedError, match="not yet ported"):
        port.search("i", body)


def test_known_keys_are_the_references():
    """The port's copy of the reference's key set: every key the port
    serves is one the reference knows."""
    assert service.SUPPORTED_KEYS <= service.KNOWN_KEYS
    assert len(service.KNOWN_KEYS) == 28
