"""The port's device-residency ledger (opensearch_tpu_torch/telemetry/
device_ledger.py) against the reference's: the single-node cases of
tests/test_device_ledger.py and tests/test_heat.py.

The ledger's own semantics (registration, idempotent free, transients,
upload scopes, structures, compile accounting, touches and heat, the
what-if tiering advisor) run on both packages' ledgers, and the same
access trace must give the same heat rows and an advisor dict equal to
the reference's. The wiring runs on the port alone: every column, IVF-PQ
slab and stacked serving bundle registers with bytes equal to its
tensors' numel * element_size and frees when it retires; the mesh
registry's byte budget frees ledger allocations; searches heat what they
read; ``"profile": true`` returns the residency rows; the mesh budget and
the heat settings apply through ``TorchNode.put_cluster_settings``.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from opensearch_tpu.telemetry import device_ledger as ref_ledger
from opensearch_tpu_torch.cluster.shard_mesh import ShardMeshRegistry
from opensearch_tpu_torch.cluster.shard_mesh import (
    default_registry as port_registry,
)
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.telemetry import device_ledger as port_ledger
from opensearch_tpu_torch.telemetry.device_ledger import (
    HEAT_HOT,
    DeviceResidencyLedger,
    array_nbytes,
    default_ledger,
)
from opensearch_tpu_torch.telemetry.tracing import Telemetry, activate

MODULES = {"reference": ref_ledger, "port": port_ledger}


@pytest.fixture(params=sorted(MODULES))
def mod(request):
    return MODULES[request.param]


# ---------------------------------------------------------------------------
# ledger semantics, on both packages
# ---------------------------------------------------------------------------


def test_identity_through_register_free_cycles(mod):
    led = mod.DeviceResidencyLedger()
    a = led.register("column", 1024, index="i", field="f", generation=1)
    b = led.register("ivfpq_slab", 2048, index="i", field="f")
    assert led.resident_bytes() == 3072
    led.verify_identity()
    a.free()
    a.free()  # idempotent: a double free must not double-subtract
    assert led.resident_bytes() == 2048
    b.free(reason="evicted")
    st = led.snapshot_stats()
    assert st["identity_ok"] and st["resident_bytes"] == 0
    assert st["allocations"] == 2 and st["frees"] == 2
    assert st["allocated_bytes"] == 3072 == st["freed_bytes"]


def test_transient_counts_both_sides(mod):
    led = mod.DeviceResidencyLedger()
    led.record_transient("query_batch", 512)
    st = led.snapshot_stats()
    assert st["resident_bytes"] == 0 and st["identity_ok"]
    assert st["transient_uploads"] == 1
    assert st["allocated_bytes"] == 512 == st["freed_bytes"]
    assert led.heat_group_keys() == []  # transients never enter heat


def test_upload_scope_attribution_nests(mod):
    led = mod.DeviceResidencyLedger()
    with mod.upload_scope(index="events", shard=2, generation=7):
        with mod.upload_scope(field="vec"):
            row = led.register("column", 64).row()
    assert (row["index"], row["shard"], row["field"], row["generation"]) == \
        ("events", 2, "vec", 7)


def _trace(led) -> None:
    """One access trace: registrations, frees, compiles, touches."""
    for size, idx, field, dev in ((10, "i", "f", "d0"), (20, "i", "f", "d0"),
                                  (5, "i", "g", "d0")):
        led.register("column", size, index=idx, field=field, generation=1,
                     device=dev)
    led.record_compile("knn_topk_streaming", 1000)
    led.record_compile("knn_topk_streaming", 3000)
    led.record_compile("mesh_knn", 500)
    allocs = {n: led.register("mesh_bundle", s, index=n, field="v",
                              generation=(1,), device="mesh[1]")
              for n, s in (("a", 300), ("b", 500), ("c", 700))}
    col = led.register("column", 4096, index="k", field="v", generation=1,
                       device="d0")
    led.touch([col], family="knn_exact_scores", params=dict(b=4, n=1024,
                                                            d=16), at_ms=5)
    rng = np.random.default_rng(23)
    for at in range(10, 160):
        name = sorted(allocs)[int(rng.integers(0, 3))]
        led.touch([allocs[name]], nbytes=64, at_ms=at)
    led.touch([allocs["a"], allocs["c"]], nbytes=401, at_ms=170)
    allocs["b"].free(reason="evicted")


def _clockless(rows: list) -> list:
    return [{k: v for k, v in r.items() if k not in ("age_ms", "class")}
            for r in rows]


def test_the_same_trace_gives_the_references_tables():
    ref, port = ref_ledger.DeviceResidencyLedger(), DeviceResidencyLedger()
    _trace(ref)
    _trace(port)
    assert port.structures() == ref.structures()
    assert port.device_totals() == ref.device_totals() == {
        "d0": 4131, "mesh[1]": 1000}
    assert port.compile_stats() == ref.compile_stats()
    assert port.compile_stats()["knn_topk_streaming"] == {
        "entries": 2, "compile_wall_ns": 4000}
    assert _clockless(port.heat_rows()) == _clockless(ref.heat_rows())
    assert port.heat_counters == ref.heat_counters
    ps, rs = port.snapshot_stats(), ref.snapshot_stats()
    for key in ("allocations", "frees", "allocated_bytes", "freed_bytes",
                "resident_bytes", "live_allocations", "identity_ok"):
        assert ps[key] == rs[key], key


@pytest.mark.parametrize("budget", [0, 400, 800, 1000, 10_000])
def test_advise_tiering_equals_the_references(budget):
    ref, port = ref_ledger.DeviceResidencyLedger(), DeviceResidencyLedger()
    _trace(ref)
    _trace(port)
    want = ref.advise_tiering(budget, memcpy_bytes_per_s=5e10)
    got = port.advise_tiering(budget, memcpy_bytes_per_s=5e10)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    # replaying the same ledger twice is idempotent
    assert port.advise_tiering(budget, memcpy_bytes_per_s=5e10) == got


def test_touch_splits_model_bytes_exactly(mod):
    led = mod.DeviceResidencyLedger()
    a = led.register("column", 1000, index="i", field="v", generation=1)
    b = led.register("ivfpq_slab", 3000, index="i", field="v", generation=5)
    led.touch([a, b], nbytes=400, at_ms=100)
    rows = {r["kind"]: r for r in led.heat_rows()}
    assert rows["column"]["bytes_read"] == 100
    assert rows["ivfpq_slab"]["bytes_read"] == 300
    assert led.heat_counters == {"touches": 2, "touched_bytes": 400,
                                 "transitions": 0}


def test_touched_bytes_agree_with_the_cost_model():
    from opensearch_tpu_torch.telemetry.roofline import COST_MODELS

    led = DeviceResidencyLedger()
    a = led.register("column", 4096, index="i", field="v", generation=1)
    params = dict(b=4, n=1024, d=16)
    led.touch([a], family="knn_exact_scores", params=params, at_ms=10)
    assert led.heat_rows()[0]["bytes_read"] == \
        COST_MODELS["knn_exact_scores"](params)[1]


def test_gap_histogram_ewma_and_classes(mod):
    led = mod.DeviceResidencyLedger()
    a = led.register("column", 100, index="i", field="v", generation=1)
    for at in (0, 100, 200, 300):
        led.touch([a], nbytes=10, at_ms=at)
    (row,) = led.heat_rows()
    assert row["touches"] == 4 and row["gap_histogram"]["100"] == 3
    assert row["ewma_gap_ms"] == 100.0
    assert mod.classify_heat(mod.HEAT_COLD_AGE_MS + 1, 0.0, 5) == \
        mod.HEAT_COLD
    assert mod.classify_heat(0, 50.0, 5) == mod.HEAT_HOT
    assert mod.classify_heat(0, 50.0, 1) == mod.HEAT_WARM
    assert mod.classify_heat(0, 60_000.0, 5) == mod.HEAT_WARM


def test_heat_retires_with_its_last_allocation(mod):
    led = mod.DeviceResidencyLedger()
    a = led.register("column", 100, index="i", field="v", generation=1,
                     device="d0")
    b = led.register("column", 100, index="i", field="v", generation=1,
                     device="d0")
    led.touch([a], nbytes=10, at_ms=0)
    assert led.heat_group_keys() == [mod.group_key(a)]
    a.free()
    assert led.heat_group_keys()  # b keeps the group alive
    b.free()
    assert led.heat_group_keys() == []
    assert led.heat_counters["touches"] == 1  # cumulative survives
    led.touch([a], nbytes=10, at_ms=1)  # a freed allocation: no touch
    assert led.heat_counters["touches"] == 1


def test_kill_switch_and_ring_resize(mod):
    led = mod.DeviceResidencyLedger()
    a = led.register("column", 100, index="i", field="v", generation=1)
    led.configure_heat(enabled=False)
    led.touch([a], nbytes=10, at_ms=0)
    assert led.heat_counters["touches"] == 0
    led.configure_heat(enabled=True)
    for at in range(64):
        led.touch([a], nbytes=1, at_ms=at)
    led.configure_heat(ring=16)
    st = led.heat_stats()
    assert st["ring"] == {"size": 16, "capacity": 16}
    assert led.advise_tiering(0, memcpy_bytes_per_s=1e9)["window"][
        "from_ms"] == 48


def test_transition_emits_span_event():
    led = DeviceResidencyLedger()
    a = led.register("column", 100, index="i", field="v", generation=1)
    tel = Telemetry(name="heat-evt")
    with activate(tel.tracer), tel.tracer.start_span("req") as span:
        led.touch([a], nbytes=10, at_ms=0)
        led.touch([a], nbytes=10, at_ms=50)
    events = [e for e in span.events if e["name"] == "heat.transition"]
    assert events and events[0]["attributes"]["to"] == HEAT_HOT
    assert led.heat_counters["transitions"] == 1


def test_array_nbytes_counts_tensors_and_arrays():
    import torch

    assert array_nbytes(torch.zeros(3, 4), None,
                        torch.zeros(5, dtype=torch.bool),
                        np.zeros(2, np.int64)) == 48 + 5 + 16


# ---------------------------------------------------------------------------
# the mesh registry's byte budget frees ledger allocations
# ---------------------------------------------------------------------------


class _FakeBundle:
    def __init__(self, nbytes, led=default_ledger, name="fake"):
        self.nbytes = nbytes
        self.allocation = led.register(
            "mesh_bundle", nbytes, index=name, field="v", generation=(1,),
            device="mesh[1]")
        # the registry frees a bundle's allocations, one a slot
        self.allocations = [self.allocation]


def _key(name, engine):
    return (name, "v", 1, (engine,), (0,), (1,))


def test_lru_by_bytes_eviction_frees_the_ledger():
    reg = ShardMeshRegistry(hbm_budget_bytes=1000)
    b1, b2, b3 = _FakeBundle(400), _FakeBundle(400), _FakeBundle(400)
    reg.put(_key("i1", 1), b1)
    reg.put(_key("i2", 2), b2)
    assert reg.resident_bytes() == 800
    reg.get(_key("i1", 1))            # LRU touch: i2 becomes the coldest
    reg.put(_key("i3", 3), b3)        # 1200 > 1000: i2 goes
    st = reg.snapshot_stats()
    assert st["resident_bytes"] == 800
    assert st["evictions"] == 1 and st["evicted_bytes"] == 400
    assert {r["index"] for r in reg.resident()} == {"i1", "i3"}
    assert b2.allocation.freed and b2.allocation.freed_reason == "hbm-budget"
    assert not b1.allocation.freed
    reg.clear()
    assert b1.allocation.freed and b3.allocation.freed


def test_oversized_bundle_admitted_and_budget_shrink_evicts():
    reg = ShardMeshRegistry(hbm_budget_bytes=100)
    big = _FakeBundle(500)
    reg.put(_key("huge", 9), big)
    assert reg.snapshot_stats()["resident_bundles"] == 1
    reg.configure(hbm_budget_bytes=1000)
    b2 = _FakeBundle(400)
    reg.put(_key("i2", 2), b2)
    reg.apply_settings({"search.mesh.hbm_budget_bytes": "500b"})
    assert reg.hbm_budget_bytes == 500
    assert reg.resident_bytes() == 400
    assert big.allocation.freed  # the coldest went first
    reg.clear()


def test_eviction_emits_span_event():
    reg = ShardMeshRegistry(hbm_budget_bytes=500)
    tel = Telemetry(name="evt")
    with activate(tel.tracer), tel.tracer.start_span("req") as span:
        reg.put(_key("i1", 1), _FakeBundle(400))
        reg.put(_key("i2", 2), _FakeBundle(400))
    events = [e for e in span.events if e["name"] == "mesh.evict"]
    assert events[0]["attributes"] == {"index": "i1", "field": "v",
                                       "reason": "hbm-budget", "bytes": 400}
    reg.clear()


def test_duplicate_build_race_frees_loser_and_invalidate_counts():
    reg = ShardMeshRegistry(hbm_budget_bytes=10_000)
    winner, loser = _FakeBundle(100), _FakeBundle(100)
    assert reg.put(_key("i", 5), winner) is winner
    assert reg.put(_key("i", 5), loser) is winner
    assert loser.allocation.freed and not winner.allocation.freed
    assert reg.invalidate_index("i") == 1
    st = reg.snapshot_stats()
    assert st["invalidations"] == 1 and st["evictions"] == 0
    assert st["evicted_bytes"] == 0 and st["invalidated_bytes"] == 100
    assert winner.allocation.freed_reason == "invalidated"


# ---------------------------------------------------------------------------
# engine and node wiring (the port)
# ---------------------------------------------------------------------------


def _engine(tmp_path, mapping, label):
    from opensearch_tpu_torch.index.engine import Engine
    from opensearch_tpu_torch.index.mapper import MapperService

    ms = MapperService()
    ms.merge({"properties": mapping})
    return Engine(tmp_path, ms, device="cpu", shard_label=label)


def test_columns_bytes_match_live_tensors(tmp_path):
    before = default_ledger.resident_bytes()
    e = _engine(tmp_path / "a", {"title": {"type": "text"},
                                 "n": {"type": "integer"},
                                 "tag": {"type": "keyword"}},
                label=("cidx", 0))
    for i in range(16):
        e.index(f"d{i}", {"title": f"w{i} common", "n": i, "tag": f"t{i}"})
    e.refresh()
    rows = {r["field"]: r for r in default_ledger.structures("cidx")}
    (_host, dev), = e.acquire_searcher().segments
    tf = dev.text_fields["title"]
    assert rows["title"]["bytes"] == array_nbytes(
        tf.postings_docs, tf.postings_tfs, tf.doc_len)
    nf = dev.numeric_fields["n"]
    assert rows["n"]["bytes"] == array_nbytes(nf.hi, nf.lo, nf.present)
    kf = dev.keyword_fields["tag"]
    assert rows["tag"]["bytes"] == array_nbytes(kf.first_ord, kf.mv_ords,
                                                kf.mv_docs)
    assert rows["_live"]["bytes"] == array_nbytes(dev.live)
    assert {r["device"] for r in rows.values()} == {"cpu"}
    assert {r["generation"] for r in rows.values()} == {1}
    default_ledger.verify_identity()
    e.close()
    assert default_ledger.structures("cidx") == []
    assert default_ledger.resident_bytes() == before


def test_merge_and_delete_republish_keep_one_generation(tmp_path):
    e = _engine(tmp_path / "b", {"n": {"type": "integer"}},
                label=("midx", 0))
    for batch in "ab":
        for i in range(8):
            e.index(f"{batch}{i}", {"n": i})
        e.refresh()
    assert len(e._segments) == 2
    e.delete("a3")
    e.refresh()  # the republished deletes bitmap swaps the _live entry
    assert sum(r["field"] == "_live"
               for r in default_ledger.structures("midx")) == 2
    e.force_merge(1)
    assert len(e._segments) == 1
    rows = default_ledger.structures("midx")
    assert sorted(r["field"] for r in rows) == ["_live", "n"]
    default_ledger.verify_identity()
    e.close()
    assert default_ledger.structures("midx") == []


def test_ivfpq_slab_registers_and_frees(tmp_path):
    rng = np.random.default_rng(7)
    e = _engine(tmp_path / "d", {
        "v": {"type": "knn_vector", "dimension": 16,
              "method": {"name": "ivf_pq", "parameters": {
                  "nlist": 8, "m": 4, "min_train": 512}}},
    }, label=("annidx", 0))
    for i, row in enumerate(rng.normal(size=(600, 16)).astype(np.float32)):
        e.index(f"d{i}", {"v": [float(x) for x in row]})
    e.refresh()
    slab = [r for r in default_ledger.structures("annidx")
            if r["kind"] == "ivfpq_slab"]
    (_host, dev), = e.acquire_searcher().segments
    ann = dev.vector_fields["v"].ann
    assert len(slab) == 1 and slab[0]["bytes"] == ann.nbytes
    assert slab[0]["generation"] == ann.build_generation
    default_ledger.verify_identity()
    e.close()
    assert default_ledger.structures("annidx") == []


@pytest.fixture()
def node(tmp_path):
    n = TorchNode(tmp_path / "data", device="cpu")
    yield n
    n.close()


def _knn_index(node, name, docs=32, dims=8, seed=3, shards=1):
    rng = np.random.default_rng(seed)
    node.create_index(name, {
        "settings": {"number_of_shards": shards},
        "mappings": {"properties": {"v": {
            "type": "knn_vector", "dimension": dims, "space_type": "l2"}}},
    })
    node.bulk([("index", {"_index": name, "_id": str(i)},
                {"v": rng.standard_normal(dims).astype(np.float32).tolist()})
               for i in range(docs)], refresh=True)
    return rng


def _knn_search(node, name, rng, dims=8, k=3, profile=False):
    body = {"size": k, "query": {"knn": {"v": {
        "vector": rng.standard_normal(dims).tolist(), "k": k}}}}
    if profile:
        body["profile"] = True
    return node.search(name, body)


def _registered_tensor_bytes(node) -> int:
    """The bytes of every tensor the ledger should hold for the node: each
    published segment's columns, live bitmap and IVF-PQ slab, and each
    resident serving bundle."""
    total = 0
    for svc in node.indices.values():
        for shard in svc.shards.values():
            for _host, dev in shard.engine.acquire_searcher().segments:
                total += sum(dev.column_nbytes().values())
                for vf in dev.vector_fields.values():
                    if vf.ann is not None:
                        total += vf.ann.nbytes
    return total + port_registry.resident_bytes()


def test_resident_bytes_are_the_registered_tensors(node):
    port_registry.clear()
    base = default_ledger.resident_bytes()
    _knn_index(node, "r1", shards=2)
    rng = _knn_index(node, "r2", docs=40)
    _knn_search(node, "r1", rng)
    _knn_search(node, "r2", rng)
    default_ledger.verify_identity()
    assert default_ledger.resident_bytes() - base == \
        _registered_tensor_bytes(node)
    share = sum(r["bytes"] for r in default_ledger.structures("r1"))
    node.delete_index("r1")
    assert default_ledger.resident_bytes() - base == \
        _registered_tensor_bytes(node)
    assert default_ledger.structures("r1") == []
    assert default_ledger.resident_bytes() == base + \
        _registered_tensor_bytes(node)
    assert share > 0


def test_mesh_search_heats_the_bundle(node):
    rng = _knn_index(node, "hm")
    for _ in range(3):
        _knn_search(node, "hm", rng)
    rows = default_ledger.heat_rows(index="hm")
    mesh = next(r for r in rows if r["kind"] == "mesh_bundle")
    assert mesh["touches"] == 3 and mesh["bytes_read"] > 0
    assert mesh["class"] == HEAT_HOT
    assert "query_batch" not in {r["kind"] for r in rows}


def test_per_shard_route_heats_the_column_and_live_bitmap(node):
    from opensearch_tpu_torch.search import distributed_serving

    rng = _knn_index(node, "hp")
    distributed_serving.enabled = False
    try:
        _knn_search(node, "hp", rng)
    finally:
        distributed_serving.enabled = True
    fields = {r["field"] for r in default_ledger.heat_rows(index="hp")}
    assert fields == {"v", "_live"}


def test_ann_rebuild_retires_old_generation_heat(node):
    method = {"name": "ivf_pq",
              "parameters": {"nlist": 8, "m": 4, "min_train": 512}}
    rng = np.random.default_rng(3)
    node.create_index("ha", {"settings": {"number_of_shards": 1},
                             "mappings": {"properties": {"v": {
                                 "type": "knn_vector", "dimension": 16,
                                 "space_type": "l2", "method": method}}}})
    node.bulk([("index", {"_index": "ha", "_id": str(i)},
                {"v": rng.standard_normal(16).astype(np.float32).tolist()})
               for i in range(600)], refresh=True)
    _knn_search(node, "ha", rng, dims=16)
    slabs = [r for r in default_ledger.heat_rows(index="ha")
             if r["kind"] == "ivfpq_slab"]
    assert len(slabs) == 1, "the ANN search did not touch the slab"
    old_gen = slabs[0]["generation"]
    node.bulk([("index", {"_index": "ha", "_id": f"x{i}"},
                {"v": rng.standard_normal(16).astype(np.float32).tolist()})
               for i in range(64)], refresh=True)
    node.indices["ha"].shards[0].engine.force_merge(1)
    assert all(r["generation"] != old_gen
               for r in default_ledger.heat_rows(index="ha")
               if r["kind"] == "ivfpq_slab")
    _knn_search(node, "ha", rng, dims=16)
    rebuilt = [r for r in default_ledger.heat_rows(index="ha")
               if r["kind"] == "ivfpq_slab"]
    assert len(rebuilt) == 1 and rebuilt[0]["generation"] != old_gen
    assert rebuilt[0]["touches"] == 1


def test_index_delete_and_budget_eviction_clear_mesh_heat(node):
    rng = _knn_index(node, "he1")
    _knn_search(node, "he1", rng)
    assert any(r["kind"] == "mesh_bundle"
               for r in default_ledger.heat_rows(index="he1"))
    bundle_bytes = next(r["bytes"] for r in port_registry.resident()
                        if r["index"] == "he1")
    old_budget = port_registry.hbm_budget_bytes
    try:
        node.put_cluster_settings({"transient": {
            "search.mesh.hbm_budget_bytes": int(bundle_bytes * 1.5)}})
        rng2 = _knn_index(node, "he2")
        _knn_search(node, "he2", rng2)
        assert not any(r["kind"] == "mesh_bundle"
                       for r in default_ledger.heat_rows(index="he1"))
        assert any(r["kind"] == "mesh_bundle"
                   for r in default_ledger.heat_rows(index="he2"))
    finally:
        port_registry.configure(hbm_budget_bytes=old_budget)
    node.delete_index("he2")
    assert default_ledger.heat_rows(index="he2") == []


def test_profile_rows_carry_residency_and_heat(node):
    rng = _knn_index(node, "hf")
    _knn_search(node, "hf", rng)
    rows = _knn_search(node, "hf", rng, profile=True)["profile"]["device"]
    assert rows and all(r["index"] == "hf" for r in rows)
    assert {r["field"] for r in rows} >= {"v", "_live"}
    heat = next(r for r in rows if "heat" in r)["heat"]
    assert {"touches", "bytes_read", "class", "ewma_gap_ms",
            "age_ms"} <= set(heat)


def test_heat_settings_apply_through_the_node(node):
    from opensearch_tpu_torch.common.errors import IllegalArgumentException

    rng = _knn_index(node, "hk")
    try:
        node.put_cluster_settings(
            {"transient": {"telemetry.heat.enabled": "false"}})
        assert default_ledger.heat_config["enabled"] is False
        before = default_ledger.heat_counters["touches"]
        _knn_search(node, "hk", rng)
        assert default_ledger.heat_counters["touches"] == before
        node.put_cluster_settings({"transient": {
            "telemetry.heat.enabled": "true", "telemetry.heat.ring": "128"}})
        assert default_ledger.heat_config == {"enabled": True, "ring": 128}
        # the reference's 400 for a value its validator rejects
        with pytest.raises(IllegalArgumentException):
            node.put_cluster_settings(
                {"transient": {"telemetry.heat.ring": "2"}})
    finally:
        default_ledger.configure_heat(enabled=True, ring=4096)


def test_stats_sections_assemble_the_ledger_and_registry(node):
    rng = _knn_index(node, "ss")
    _knn_search(node, "ss", rng)
    device = port_ledger.stats_section()
    assert device["identity_ok"]
    assert device["resident_bytes"] == (device["allocated_bytes"]
                                        - device["freed_bytes"])
    assert device["shard_mesh"]["hbm_budget_bytes"] > 0
    heat = port_ledger.heat_section()
    assert any(r["index"] == "ss" for r in heat["rows"])
