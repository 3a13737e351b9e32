"""The engine encodes an indexed document's source once: its translog op is
``json.dumps`` of the op dict byte for byte, and the segment stores the
same text, for sources and ids of every JSON kind."""

from __future__ import annotations

import json

import pytest

from opensearch_tpu_torch.index.engine import Engine
from opensearch_tpu_torch.index.mapper import MapperService
from opensearch_tpu_torch.index.translog import _HEADER

SOURCES = [
    {"v": [0.1, -2.5e-07, 3.0], "n": 7},
    {"title": "café ☃ \"quoted\" \\ slash", "tags": ["a", "b"]},
    {"nested": {"x": [1, {"y": None}], "ok": True}, "f": 1e30},
    {},
]


@pytest.mark.parametrize("routing", [None, "ré"])
def test_translog_ops_and_stored_sources_are_json_dumps(tmp_path, routing):
    engine = Engine(tmp_path, MapperService(), device="cpu")
    try:
        ids = ["1", "déjà", "q\"x", "4"]
        for doc_id, source in zip(ids, SOURCES):
            engine.index(doc_id, source, routing=routing)
        engine.index("1", {"v": [1.5]}, routing=routing)   # an update
        engine.translog.sync()
        tl = engine.translog
        data = tl._gen_path(tl.checkpoint.generation).read_bytes()
        got, pos = [], 0
        while pos + _HEADER.size <= len(data):
            length, _crc = _HEADER.unpack_from(data, pos)
            pos += _HEADER.size
            got.append(data[pos:pos + length])
            pos += length
        want = [json.dumps({"op": "index", "id": i, "seq_no": n,
                            "version": 2 if n == 4 else 1, "source": s,
                            "routing": routing}).encode()
                for n, (i, s) in enumerate(zip(ids + ["1"],
                                               SOURCES + [{"v": [1.5]}]))]
        assert got == want
        assert [op["seq_no"] for op in tl.read_ops()] == [0, 1, 2, 3, 4]
        engine.refresh()
        (host, _dev), = engine._segments
        stored = dict(zip(host.doc_ids, host.sources))
        for doc_id, source in zip(ids[1:], SOURCES[1:]):
            assert stored[doc_id] == json.dumps(source).encode()
        assert stored["1"] == json.dumps({"v": [1.5]}).encode()
    finally:
        engine.close()


def _translog_payloads(engine) -> list[bytes]:
    engine.translog.sync()
    tl = engine.translog
    data = tl._gen_path(tl.checkpoint.generation).read_bytes()
    got, pos = [], 0
    while pos + _HEADER.size <= len(data):
        length, _crc = _HEADER.unpack_from(data, pos)
        pos += _HEADER.size
        got.append(data[pos:pos + length])
        pos += length
    return got


@pytest.mark.parametrize("pipeline", [None, "stamp"])
def test_bulk_and_split_store_json_dumps_of_the_written_source(tmp_path,
                                                              pipeline):
    """A `_bulk` hands the engine each source's text from its byte count,
    and a `_split` the source segment's bytes; what is stored is still
    ``json.dumps`` of the source the engine indexed, the pipeline's output
    where one ran."""
    from opensearch_tpu_torch.node import TorchNode

    node = TorchNode(str(tmp_path), device="cpu")
    try:
        node.ingest.put_pipeline("stamp", {"processors": [
            {"set": {"field": "stamp", "value": "é"}}]})
        ids = ["1", "déjà", "q\"x", "4"]
        resp = node.bulk([("index", {"_index": "src", "_id": i}, s)
                          for i, s in zip(ids, SOURCES)], pipeline=pipeline)
        assert not resp["errors"]
        written = [dict(s, stamp="é") if pipeline else s for s in SOURCES]
        (shard,) = node.indices["src"].shards.values()
        want = [json.dumps({"op": "index", "id": i, "seq_no": n,
                            "version": 1, "source": s,
                            "routing": None}).encode()
                for n, (i, s) in enumerate(zip(ids, written))]
        assert _translog_payloads(shard.engine) == want
        node.refresh("src")
        node.put_index_settings("src", {"index.blocks.write": True})
        node.resize_index("split", "src", "dst",
                          {"settings": {"index.number_of_shards": 2}})
        stored, ops = {}, {}
        for tgt in node.indices["dst"].shards.values():
            for host, _dev in tgt.engine._segments:
                stored.update(zip(host.doc_ids, host.sources))
            for raw in _translog_payloads(tgt.engine):
                op = json.loads(raw)
                ops[op["id"]] = raw
                assert raw == json.dumps(op).encode()
        for doc_id, source in zip(ids, written):
            assert stored[doc_id] == json.dumps(source).encode()
            assert json.loads(ops[doc_id])["source"] == source
    finally:
        node.close()
