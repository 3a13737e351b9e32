"""Persistent tasks: TorchNode against TpuNode.

tests/test_persistent_tasks.py's case runs in both packages: the same
executor is registered in each package's own registry (the port keeps its
own dict), a task that completes and one that does not start on a node,
the node closes, and a new node on the same data path replays the
incomplete task alone. Each package's runs, statuses and errors must be
equal (tolerance 0); task ids are random and left out.
"""

from __future__ import annotations

import pytest

pytest.importorskip("jax")

from opensearch_tpu import persistent as ref_persistent
from opensearch_tpu.node import TpuNode
from opensearch_tpu_torch import persistent as port_persistent
from opensearch_tpu_torch.node import TorchNode

from test_torch_scroll_pit import observe

PACKAGES = {"ref": (ref_persistent, lambda p: TpuNode(p)),
            "port": (port_persistent,
                     lambda p: TorchNode(p, device="cpu"))}


def _lifecycle(tmp_path, side: str) -> list:
    """The reference's test_persistent_task_lifecycle, observed."""
    persistent, make = PACKAGES[side]
    runs = []

    def executor(params, task):
        runs.append(params["n"])
        task.update_state({"seen": params["n"]})
        if params.get("finish"):
            task.complete()

    persistent.register_executor("test/echo", executor)
    n = make(tmp_path / side)
    tid = n.persistent_tasks.start("test/echo", {"n": 1, "finish": True})
    out = [list(runs), n.persistent_tasks.get(tid)["status"]]
    # incomplete task resumes on restart
    tid2 = n.persistent_tasks.start("test/echo", {"n": 2})
    out.append(n.persistent_tasks.get(tid2)["status"])
    out.append(sorted((t["task_name"], t["status"], t["state"] == {
        "seen": t["params"]["n"]}) for t in n.persistent_tasks.list()))
    n.close()

    n2 = make(tmp_path / side)
    # the restart replayed the incomplete task but not the completed one
    out.append(list(runs))
    out.append(n2.persistent_tasks.get(tid)["status"])
    out.append(observe(lambda: n2.persistent_tasks.start("test/unknown",
                                                         {})))
    out.append(observe(lambda: n2.persistent_tasks.get("nope"))[:3])
    n2.persistent_tasks.complete(tid2)
    n2.persistent_tasks.remove(tid)
    out.append([t["status"] for t in n2.persistent_tasks.list()])
    n2.close()
    return out


def test_persistent_task_lifecycle(tmp_path):
    ref = _lifecycle(tmp_path, "ref")
    port = _lifecycle(tmp_path, "port")
    assert port == ref
    assert port[0] == [1] and port[4] == [1, 2, 2]
    assert port[1] == "completed" and port[2] == "started"
    assert port[6][:3] == ("error", "IllegalArgumentException", 400)
    assert port[7] == ("error", "ResourceNotFoundException", 404)


def test_failed_executor_is_recorded_and_not_replayed(tmp_path):
    def boom(params, task):
        raise RuntimeError(f"boom {params['n']}")

    out = {}
    for side, (persistent, make) in PACKAGES.items():
        persistent.register_executor("test/boom", boom)
        n = make(tmp_path / side)
        tid = n.persistent_tasks.start("test/boom", {"n": 3})
        got = n.persistent_tasks.get(tid)
        n.close()
        n2 = make(tmp_path / side)
        out[side] = [got["status"], got["failure"],
                     n2.persistent_tasks.get(tid)["status"]]
        n2.close()
    assert out["port"] == out["ref"] == ["failed", "RuntimeError: boom 3",
                                         "failed"]


def test_registries_are_separate():
    port_persistent.register_executor("test/port-only", lambda p, t: None)
    assert "test/port-only" in port_persistent._EXECUTORS
    assert "test/port-only" not in ref_persistent._EXECUTORS
