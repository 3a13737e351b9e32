"""The TCP transport: the port's transport/tcp.py against the reference's.

- ``encode_frame`` gives the reference's bytes for the same bodies (plain
  JSON frames, and the binary side-channel under ``payload``, ``result``
  and the body itself), and ``read_frame`` reads either package's frame
  back to the same dict;
- the reference's handshake-rejects-wrong-cluster, timeout-and-late-
  response-dropped and lazy-reconnect cases (tests/test_tcp_cluster.py),
  each run on the reference and on the port's copy of the module
  (:func:`test_torch_cluster_data.port_module`) as cases of one
  parametrised test;
- the three ``test_tcp_send_*`` cases of tests/test_fault_injection.py
  (backlog shed, oversized and unserializable payloads), through
  :func:`test_torch_cluster_data.run_both`: both packages pass the
  reference's assertions.
"""

from __future__ import annotations

import asyncio
import importlib

import pytest

pytest.importorskip("jax")

from test_torch_cluster_data import cases, port_module, run_both

PACKAGES = ("opensearch_tpu", "opensearch_tpu_torch")
TRANSPORT_CASES = (
    "test_handshake_rejects_wrong_cluster",
    "test_request_timeout_and_late_response_dropped",
    "test_lazy_connection_reopens_after_peer_restart",
)
SEND_CASES = (
    "test_tcp_send_sheds_when_pending_backlog_full",
    "test_tcp_send_oversized_payload_fails_listener",
    "test_tcp_send_unserializable_payload_fails_listener_once",
)

BODIES = [
    {"t": "req", "id": 1, "action": "internal:ping", "sender": "n0",
     "payload": {}},
    {"t": "res", "id": 7, "payload": {"hits": [{"_id": "a", "_score": 0.5}],
                                      "text": "café ☃", "n": None}},
    {"t": "err", "id": 9, "error": "IndexNotFoundException: no such index"},
    {"t": "handshake", "sender": "n1", "cluster": "opensearch-tpu",
     "version": 2},
    {"t": "req", "id": 3, "action": "internal:segment/chunk", "sender": "n2",
     "payload": {"index": "v", "shard": 0, "_binary": bytes(range(256))}},
    {"t": "res", "id": 4, "result": {"ok": True, "_binary": b"\x00\xff" * 9}},
    {"t": "res", "id": 5, "_binary": bytearray(b"raw bytes")},
]


def _tcp(package: str):
    return importlib.import_module(f"{package}.transport.tcp")


def _read(tcp, frame: bytes) -> dict:
    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(frame)
        reader.feed_eof()
        return await tcp.read_frame(reader)

    return asyncio.run(go())


def test_constants_match():
    ref, port = _tcp("opensearch_tpu"), _tcp("opensearch_tpu_torch")
    for name in ("PROTOCOL_VERSION", "MAX_FRAME", "DEFAULT_MAX_PENDING",
                 "BINARY_KEY", "_KIND_JSON", "_KIND_BINARY"):
        assert getattr(ref, name) == getattr(port, name), name


@pytest.mark.parametrize("i", range(len(BODIES)))
def test_frames_match(i):
    ref, port = _tcp("opensearch_tpu"), _tcp("opensearch_tpu_torch")
    body = BODIES[i]
    frame = port.encode_frame(body)
    assert frame == ref.encode_frame(body)
    back = _read(port, frame)
    assert back == _read(ref, frame)
    want = {k: (bytes(v) if isinstance(v, bytearray) else v)
            for k, v in body.items()}
    assert back == want


def test_oversized_frame_raises_in_both(monkeypatch):
    for package in PACKAGES:
        tcp = _tcp(package)
        monkeypatch.setattr(tcp, "MAX_FRAME", 32)
        for body in ({"payload": "x" * 64},
                     {"payload": {"_binary": b"y" * 64}}):
            with pytest.raises(ValueError, match="MAX_FRAME"):
                tcp.encode_frame(body)


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", TRANSPORT_CASES)
def test_transport_case(case, package, tmp_path):
    mod = (importlib.import_module("test_tcp_cluster")
           if package == "opensearch_tpu" else port_module("test_tcp_cluster"))
    getattr(mod, case)(tmp_path)


@pytest.mark.parametrize("case", [
    c for c in cases(importlib.import_module("test_fault_injection"))
    if c.values[0][1] in SEND_CASES])
def test_send_case(case, tmp_path):
    run_both("test_fault_injection", case, tmp_path)


def test_send_cases_all_found():
    names = {c.values[0][1] for c in cases(
        importlib.import_module("test_fault_injection"))}
    assert set(SEND_CASES) <= names
