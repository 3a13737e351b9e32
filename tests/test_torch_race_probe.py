"""The runtime race probe (testing/race_probe.py) of the port against the
reference's.

Each of the 15 cases of tests/test_race_probe.py runs as the reference
wrote it and as the port's copy (tests/test_torch_cluster_data.py's
import-rewriting harness: ``opensearch_tpu`` imports to
``opensearch_tpu_torch``, ``run_soak(...)`` on the CPU), and both must
pass its assertions; ``run_both`` also holds the soak case's sim steps,
messages and responses equal. In the port's copy:

- ``test_default_drill_shrinks_to_nothing``: the port's static pass
  (``lint/callgraph.program_roles`` over ``opensearch_tpu_torch/``) roles
  every drilled class of the port, so ``statically_unroled()`` is empty;
- ``test_soak_cycle_under_probe_is_clean``: one seeded sim soak cycle of
  the port's ClusterNodes on the CPU under ``probe_scope``, with watched
  events and no confirmed write;
- ``test_cli_exits_zero_on_clean_tree`` runs the module its source names,
  the reference's CLI; the port's CLI is run below, on the port's tree.
"""

from __future__ import annotations

import importlib
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

from test_torch_cluster_data import cases, run_both

REFERENCE = "test_race_probe"
REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("case", cases(importlib.import_module(REFERENCE)))
def test_reference_case(case, tmp_path):
    run_both(REFERENCE, case, tmp_path)


def test_the_fifteen_cases():
    assert len(cases(importlib.import_module(REFERENCE))) == 15


def _cli(tmp_path, *args) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "opensearch_tpu_torch.testing.race_probe",
         *args], capture_output=True, text=True, cwd=str(REPO), timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "TMPDIR": str(tmp_path), "PYTHONPATH": str(REPO)})


def test_port_cli_exits_zero_on_the_ports_tree(tmp_path):
    proc = _cli(tmp_path, "--no-soak")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "zero unconfirmed-unlocked cross-role writes" in proc.stdout
    assert "nothing — the cross-module pass roles every watched service" \
        in proc.stdout


def test_port_cli_soak_on_the_cpu_when_asked(tmp_path):
    proc = _cli(tmp_path, "--device", "cpu", "--ops", "10")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "zero unconfirmed-unlocked cross-role writes" in proc.stdout


def test_port_cli_soak_defaults_to_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would use it")
    proc = _cli(tmp_path, "--ops", "4")
    assert proc.returncode != 0
    assert "cuda" in (proc.stdout + proc.stderr).lower()


def test_probe_scope_patches_the_ports_classes_alone():
    """The port's scope wraps the port's dispatch points and transports,
    the reference's stay as they are, and everything is restored."""
    from opensearch_tpu_torch.cluster.cluster_node import ClusterNode
    from opensearch_tpu_torch.testing import race_probe as rp
    from opensearch_tpu_torch.testing.sim import (DeterministicTaskQueue,
                                                  MockTransport)
    from opensearch_tpu_torch.transport.tcp import LoopScheduler, TcpTransport

    ref_cn = importlib.import_module("opensearch_tpu.cluster.cluster_node")
    points = [(ClusterNode, "_offload"), (ClusterNode, "_offload_search"),
              (DeterministicTaskQueue, "schedule"),
              (LoopScheduler, "schedule"), (MockTransport, "register"),
              (TcpTransport, "register"), (ClusterNode, "__init__")]
    before = {p: vars(p[0])[p[1]] for p in points}
    ref_before = vars(ref_cn.ClusterNode)["_offload"]
    with rp.probe_scope():
        for p in points:
            assert vars(p[0])[p[1]] is not before[p], p
        assert vars(ref_cn.ClusterNode)["_offload"] is ref_before
    for p in points:
        assert vars(p[0])[p[1]] is before[p], p
    assert {mod for mod, _cls in rp.WATCH_SPECS} == {
        "opensearch_tpu_torch.search.backpressure",
        "opensearch_tpu_torch.common.breaker",
        "opensearch_tpu_torch.cluster.cluster_node"}
