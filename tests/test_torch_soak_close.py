"""A closed node's device tensors die when its close returns.

A small seeded chaos soak (3 nodes, 2 cycles, a topology change) runs with
the cyclic collector off. Just before ``SoakHarness.close``, a weak
reference is taken to every device array of every segment each node's
engines publish: the live bitmaps, the vector, filter and text columns,
and the IVF-PQ structures built at refresh. The port's nodes must leave
none alive once close returns, with no ``gc.collect()``: ``Engine.close``
drops its segments and searcher, so the reference cycles among a closed
node's objects (the coordinator's ``on_state_applied`` hook and the
transport's handler table are bound methods of the node) no longer reach
the card's memory.

The same check on the reference's nodes, as a stated difference: its
closed engines keep their segments, so its device arrays stay alive until
the cyclic collector runs. Both packages free everything after one
``gc.collect()``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import weakref

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

SEED = 7
SOAK = {"cycles": 2, "ops_per_cycle": 20, "topology_cycle": 1}
PORT = "opensearch_tpu_torch"


def device_arrays(obj, depth: int = 0):
    """Every torch tensor or JAX array a device segment reaches through
    its dataclass fields, dicts, sequences and plain objects (the IVF-PQ
    index)."""
    if isinstance(obj, (torch.Tensor, jax.Array)):
        yield obj
        return
    if depth > 4 or obj is None or isinstance(obj, (str, bytes, int, float)):
        return
    if isinstance(obj, dict):
        children = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        children = list(obj)
    elif dataclasses.is_dataclass(obj) or hasattr(obj, "__dict__"):
        children = list(vars(obj).values())
    else:
        return
    for child in children:
        yield from device_arrays(child, depth + 1)


def closed_soak(package: str, tmp_path, monkeypatch) -> dict:
    """Weak references to the nodes' device arrays, taken just before the
    harness closes them; how many are alive after close, with the cyclic
    collector off, and after one collect."""
    soak = importlib.import_module(f"{package}.testing.soak")
    refs: dict[str, list] = {"segments": [], "ivfpq": []}
    close = soak.SoakHarness.close

    def watched_close(harness):
        for node in harness.nodes.values():
            for shard in node.local_shards.values():
                for _host, dev in shard.engine._segments:
                    for field in dev.vector_fields.values():
                        refs["ivfpq"].extend(
                            weakref.ref(a) for a in device_arrays(field.ann))
                    refs["segments"].extend(
                        weakref.ref(a) for a in device_arrays(dev))
        close(harness)

    monkeypatch.setattr(soak.SoakHarness, "close", watched_close)
    kw = dict(SOAK, device="cpu") if package == PORT else dict(SOAK)
    gc.collect()
    gc.disable()
    try:
        soak.run_soak(SEED, tmp_path, **kw)
        alive = {k: sum(w() is not None for w in ws)
                 for k, ws in refs.items()}
    finally:
        gc.enable()
    gc.collect()
    return {"taken": {k: len(ws) for k, ws in refs.items()},
            "alive_after_close": alive,
            "alive_after_collect": sum(w() is not None
                                       for ws in refs.values() for w in ws)}


def test_port_frees_device_tensors_at_close(tmp_path, monkeypatch):
    got = closed_soak(PORT, tmp_path, monkeypatch)
    assert got["taken"]["segments"] > 0 and got["taken"]["ivfpq"] > 0, got
    assert got["alive_after_close"] == {"segments": 0, "ivfpq": 0}, got
    assert got["alive_after_collect"] == 0, got


def test_reference_keeps_them_until_the_collector_runs(tmp_path,
                                                       monkeypatch):
    """The stated difference: the reference's closed nodes keep their
    device arrays until the cyclic collector runs."""
    got = closed_soak("opensearch_tpu", tmp_path, monkeypatch)
    assert got["taken"]["segments"] > 0 and got["taken"]["ivfpq"] > 0, got
    assert got["alive_after_close"]["segments"] > 0, got
    assert got["alive_after_collect"] == 0, got
