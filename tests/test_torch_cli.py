"""The port's launchers: cli.py and server.py against the reference's.

- ``parse_seeds`` and ``load_config`` give the reference's answers;
- ``ClusterServer``, ``server.main`` and ``cli.main`` run on the card by
  default and raise where ``torch.cuda.is_available()`` is false, before
  anything boots;
- ``--device cpu`` boots, as its own process, a single node
  (``python -m opensearch_tpu_torch.cli``) and a one-node cluster
  (``python -m opensearch_tpu_torch.server``, and the CLI's ``--cluster``
  branch), each answering ``_cluster/health`` over HTTP. A launch whose
  ports another process took meanwhile (EADDRINUSE) runs again on fresh
  ones.
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

pytest.importorskip("jax")

from opensearch_tpu import cli as ref_cli
from opensearch_tpu import server as ref_server
from opensearch_tpu_torch import cli, server
from test_tcp_cluster import free_ports, http

REPO = Path(__file__).resolve().parent.parent
BOOT_S = 60.0
LAUNCH_ATTEMPTS = 5

SEED_SPECS = [
    "n1=127.0.0.1:9301",
    "n1=127.0.0.1:9301,n2=127.0.0.1:9302,n3=10.0.0.7:9303",
    " n1 = 127.0.0.1:9301 , ,n2=localhost:9400,",
    "a=::1:9300",
]


@pytest.mark.parametrize("spec", SEED_SPECS)
def test_parse_seeds_matches(spec):
    assert server.parse_seeds(spec) == ref_server.parse_seeds(spec)


def test_load_config_matches(tmp_path, monkeypatch):
    conf = tmp_path / "opensearch.yml"
    conf.write_text("cluster.name: c1\nnode.name: n7\nhttp.port: 9333\n"
                    "discovery.seed_hosts: [\"n7=127.0.0.1:9307\"]\n"
                    "cluster.initial_cluster_manager_nodes: [n7]\n")
    assert cli.load_config(str(conf)) == ref_cli.load_config(str(conf)) == {
        "cluster.name": "c1", "node.name": "n7", "http.port": 9333,
        "discovery.seed_hosts": ["n7=127.0.0.1:9307"],
        "cluster.initial_cluster_manager_nodes": ["n7"]}
    assert cli.load_config(str(tmp_path / "none.yml")) == \
        ref_cli.load_config(str(tmp_path / "none.yml")) == {}
    (tmp_path / "list.yml").write_text("- a\n- b\n")
    assert cli.load_config(str(tmp_path / "list.yml")) == \
        ref_cli.load_config(str(tmp_path / "list.yml")) == {}
    # no path: ./opensearch.yml, then ./config/opensearch.yml
    monkeypatch.chdir(tmp_path)
    assert cli.load_config(None) == ref_cli.load_config(None)
    conf.unlink()
    (tmp_path / "config").mkdir()
    (tmp_path / "config" / "opensearch.yml").write_text("node.name: n8\n")
    assert cli.load_config(None) == ref_cli.load_config(None) == {
        "node.name": "n8"}


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the card is here: nothing to refuse")
def test_the_card_by_default_and_no_card_raises(tmp_path):
    [tport, hport] = free_ports(2)
    seeds = {"n1": ("127.0.0.1", tport)}

    async def construct():
        return server.ClusterServer("n1", tmp_path / "n1", "127.0.0.1",
                                    tport, hport, seeds,
                                    loop=asyncio.get_running_loop())

    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        asyncio.run(construct())
    args = ["--node-id", "n1", "--http-port", str(hport), "--data",
            str(tmp_path / "s"), "--seeds", f"n1=127.0.0.1:{tport}"]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        server.main(args)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["--http-port", str(hport), "--data", str(tmp_path / "c")])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.main(["--http-port", str(hport), "--data", str(tmp_path / "k"),
                  "--seeds", f"n1=127.0.0.1:{tport}", "--node-name", "n1"])
    # nothing booted: no data directory was made
    assert not any((tmp_path / d).exists() for d in ("n1", "s", "c", "k"))


def test_device_cpu_node_on_the_cpu(tmp_path):
    [tport, hport] = free_ports(2)

    async def construct():
        srv = server.ClusterServer(
            "n1", tmp_path / "n1", "127.0.0.1", tport, hport,
            {"n1": ("127.0.0.1", tport)}, loop=asyncio.get_running_loop(),
            device="cpu")
        await srv.transport.aclose()
        await srv.http.stop()
        srv.node.close()
        return srv

    srv = asyncio.run(construct())
    assert srv.node.device == torch.device("cpu")


def _launch(argv_for, tmp_path: Path) -> dict:
    """Run ``argv_for(transport_port, http_port)`` as a process until
    ``_cluster/health`` answers green with a node; returns that answer."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for attempt in range(LAUNCH_ATTEMPTS):
        tport, hport = free_ports(2)
        log = tmp_path / f"launch{attempt}.log"
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, *argv_for(tport, hport)], cwd=tmp_path,
                env=env, stdout=out, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + BOOT_S
            while time.monotonic() < deadline and proc.poll() is None:
                try:
                    status, health = asyncio.run(
                        http(hport, "GET", "/_cluster/health", timeout=5.0))
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    time.sleep(0.2)
                    continue
                # green with its node elected (a cluster node answers
                # green with no node before its first election)
                if status == 200 and health["status"] == "green" \
                        and health["number_of_nodes"] >= 1:
                    return health
                time.sleep(0.2)
        finally:
            proc.terminate()
            try:
                proc.wait(10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(10)
        text = log.read_text()
        if "Address already in use" not in text:
            raise AssertionError(f"no health within {BOOT_S} s:\n{text}")
    raise AssertionError("every launch met EADDRINUSE")


def test_cli_single_node_on_cpu(tmp_path):
    health = _launch(lambda t, h: [
        "-m", "opensearch_tpu_torch.cli", "--device", "cpu",
        "--node-name", "solo", "--http-port", str(h),
        "--data", str(tmp_path / "d")], tmp_path)
    assert health["number_of_nodes"] == 1


def test_server_one_node_cluster_on_cpu(tmp_path):
    health = _launch(lambda t, h: [
        "-m", "opensearch_tpu_torch.server", "--device", "cpu",
        "--node-id", "n1", "--http-port", str(h),
        "--data", str(tmp_path / "d"), "--seeds", f"n1=127.0.0.1:{t}",
        "--bootstrap", "n1"], tmp_path)
    assert health["number_of_nodes"] == 1
    assert health["cluster_manager_node"] == "n1"


def test_cli_cluster_branch_on_cpu(tmp_path):
    health = _launch(lambda t, h: [
        "-m", "opensearch_tpu_torch.cli", "--device", "cpu", "--cluster",
        "--node-name", "n1", "--http-port", str(h),
        "--data", str(tmp_path / "d"), "--seeds", f"n1=127.0.0.1:{t}",
        "--bootstrap", "n1"], tmp_path)
    assert health["cluster_manager_node"] == "n1"
