"""Fault injection over the deterministic sim: node kills, partitions,
one-way drops, slow links, relocation races and the virtual clock, on the
port's ClusterNode against the reference's.

Every case of tests/test_fault_injection.py runs twice on its seed, as the
reference wrote it and as the port's copy
(:func:`test_torch_cluster_data.port_module`), through
:func:`test_torch_cluster_data.run_both`: both runs pass the reference's
assertions, and their steps, transport messages and client responses are
equal. The three cases of the TCP transport (``test_tcp_send_*``) run in
tests/test_torch_tcp_transport.py.
"""

from __future__ import annotations

import importlib

import pytest

pytest.importorskip("jax")

from test_torch_cluster_data import cases, run_both

REFERENCE = "test_fault_injection"
TCP_CASES = (
    "test_tcp_send_sheds_when_pending_backlog_full",
    "test_tcp_send_oversized_payload_fails_listener",
    "test_tcp_send_unserializable_payload_fails_listener_once",
)


@pytest.mark.parametrize(
    "case", cases(importlib.import_module(REFERENCE), skip=TCP_CASES))
def test_reference_case(case, tmp_path):
    run_both(REFERENCE, case, tmp_path)
