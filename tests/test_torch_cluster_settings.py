"""Single-node `_cluster/settings` on TorchNode against TpuNode.

Each case runs on both nodes and the observations must be equal: an
unknown key and an invalid value are 400s that change nothing; the
response echoes both sections, nested or flat; `include_defaults`; a null
deletes a key; persistent settings survive a restart and transient ones
do not. Then each process-wide object (the kNN dispatch batcher, the ANN
config, the lanes, the residency routing, the shard-mesh budget, the heat
ledger) is applied only when an update or the effective settings name one
of its keys: booting a second node or updating an unrelated key leaves it
alone, and a null deletion restores its default. The request cache's
budget and the span exporter are per node. Over HTTP, `GET` and `PUT
/_cluster/settings` answer as the reference's handlers.
"""

from __future__ import annotations

import pytest

pytest.importorskip("jax")

from opensearch_tpu_torch.cluster import residency
from opensearch_tpu_torch.cluster.shard_mesh import default_registry
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.search import ann, batcher, lanes
from opensearch_tpu_torch.telemetry.device_ledger import default_ledger

from test_torch_scroll_pit import Pair, observe

# every process-wide key these tests set, deleted again at the end
PROCESS_KEYS = ("search.knn.batch.max_wait_ms",
                "search.knn.batch.max_batch_size",
                "search.knn.batch.enabled",
                "search.knn.ann.rescore_multiplier",
                "search.knn.score_precision",
                "search.mesh.hbm_budget_bytes",
                "search.lanes.enabled",
                "search.routing.residency",
                "telemetry.heat.ring")


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path)
    yield p
    try:
        for n in p.nodes:
            n.put_cluster_settings({
                "persistent": dict.fromkeys(PROCESS_KEYS),
                "transient": dict.fromkeys(PROCESS_KEYS)})
    finally:
        p.close()


@pytest.mark.parametrize("body", [
    {"persistent": {"no.such.setting": 1}},
    {"transient": {"search": {"knn": {"batch": {"max_batch_size": 0}}}}},
    {"persistent": {"search.knn.batch.max_wait_ms": "soon"}},
    {"persistent": {"search.knn.score_precision": "fp8"}},
    {"persistent": {"indices.requests.cache.size": "lots"}},
    {"transient": {"telemetry.tracing.exporter": "carrier"}},
    {"persistent": {"search.knn.batch.max_batch_size": 8,
                    "bogus.key": True}},
], ids=["unknown", "batch_size_zero", "wait_unparsable", "precision",
        "cache_size", "exporter", "one_bad_key"])
def test_invalid_updates_are_400_and_change_nothing(pair, body):
    def scenario(node):
        return [observe(lambda: node.put_cluster_settings(body)),
                node.get_cluster_settings()]

    out = pair.flow(scenario)
    assert out[0][:3] == ("error", "IllegalArgumentException", 400)
    assert out[1] == {"persistent": {}, "transient": {}}
    assert batcher.default_batcher.max_batch_size == 32


def test_sections_echo_flat_defaults_and_null_deletes(pair):
    def scenario(node):
        put = node.put_cluster_settings({
            "persistent": {"search": {"knn": {"batch": {
                "max_wait_ms": "7ms", "max_batch_size": 16}}},
                "search.max_keep_alive": "1h"},
            "transient": {"indices.requests.cache.size": "2mb"}})
        return [put,
                node.get_cluster_settings(flat=True),
                node.get_cluster_settings(include_defaults=True),
                node.effective_cluster_setting("search.max_keep_alive"),
                node.put_cluster_settings({"persistent": {"search": {
                    "knn": {"batch": {"max_batch_size": None}}}}},
                    flat=True),
                node.get_cluster_settings()]

    out = pair.flow(scenario)
    assert out[1]["persistent"]["search.knn.batch.max_wait_ms"] == "7ms"
    assert "search.knn.batch.max_batch_size" not in out[4]["persistent"]


def test_persistent_survives_restart_transient_does_not(tmp_path):
    pair = Pair(tmp_path)
    try:
        for n in pair.nodes:
            n.put_cluster_settings({
                "persistent": {"search.knn.batch.max_wait_ms": "9ms"},
                "transient": {"indices.requests.cache.size": "1kb"}})
            assert n.request_cache.max_bytes == 1024
    finally:
        pair.close()
    # the batcher is process-wide: back to its default, so the reopened
    # node's boot must set the persisted value again
    batcher.default_batcher.configure(max_wait_ms=2)
    again = Pair(tmp_path)
    try:
        out = again.flow(lambda n: [n.get_cluster_settings(flat=True),
                                    n.request_cache.max_bytes])
        assert out == [{"persistent": {
            "search.knn.batch.max_wait_ms": "9ms"}, "transient": {}},
            64 << 20]
        assert batcher.default_batcher.max_wait_ms == 9
    finally:
        again.port.put_cluster_settings({"persistent": {
            "search.knn.batch.max_wait_ms": None}})
        again.close()
    assert batcher.default_batcher.max_wait_ms == 2


# -- the process-wide objects: only when named ---------------------------------

OBJECTS = {
    "batcher": ({"search.knn.batch.max_batch_size": 5},
                lambda: batcher.default_batcher.max_batch_size, 5, 32),
    "ann": ({"search.knn.ann.rescore_multiplier": 9},
            lambda: ann.default_config.rescore_multiplier, 9, 4),
    "exact_precision": ({"search.knn.score_precision": "bf16"},
                        lambda: ann.default_config.score_precision, "bf16",
                        "fp32"),
    "mesh": ({"search.mesh.hbm_budget_bytes": 12345},
             lambda: default_registry.hbm_budget_bytes, 12345, 1 << 30),
    "lanes": ({"search.lanes.enabled": False},
              lambda: lanes.default_config.enabled, False, True),
    "residency": ({"search.routing.residency": False},
                  lambda: residency.default_config.enabled, False, True),
    "heat": ({"telemetry.heat.ring": 64},
             lambda: default_ledger.heat_config["ring"], 64, 4096),
}


@pytest.mark.parametrize("name", sorted(OBJECTS))
def test_process_wide_objects_apply_only_when_named(tmp_path, name):
    update, read, value, default = OBJECTS[name]
    node = TorchNode(tmp_path / "a", device="cpu")
    other = None
    try:
        node.put_cluster_settings({"persistent": update})
        assert read() == value
        # another node booting with nothing persisted, and its update of an
        # unrelated key, leave the live object alone
        other = TorchNode(tmp_path / "b", device="cpu")
        assert read() == value
        other.put_cluster_settings({"persistent": {
            "search.max_keep_alive": "1h"}})
        assert read() == value
        # a transient on top wins, and its deletion falls back to the
        # persistent value; a null deletion of both restores the default
        key = next(iter(update))
        node.put_cluster_settings({"transient": {key: update[key]}})
        node.put_cluster_settings({"transient": {key: None}})
        assert read() == value
        node.put_cluster_settings({"persistent": {key: None}})
        assert read() == default
    finally:
        node.put_cluster_settings({"persistent": dict.fromkeys(update)})
        if other is not None:
            other.close()
        node.close()


def test_request_cache_budget_and_exporter_are_per_node(tmp_path):
    a = TorchNode(tmp_path / "a", device="cpu")
    b = TorchNode(tmp_path / "b", device="cpu")
    try:
        a.put_cluster_settings({"transient": {
            "indices.requests.cache.size": "3kb",
            "telemetry.tracing.exporter": "file"}})
        assert a.request_cache.max_bytes == 3 * 1024
        assert b.request_cache.max_bytes == 64 << 20
        assert a.telemetry.tracer.exporter is not None
        assert b.telemetry.tracer.exporter is None
        a.put_cluster_settings({"transient": {
            "telemetry.tracing.exporter": None}})
        assert a.telemetry.tracer.exporter is None
    finally:
        a.close()
        b.close()


def test_cluster_settings_over_http(tmp_path):
    from opensearch_tpu.rest.handlers import (
        get_cluster_settings as ref_get,
        put_cluster_settings as ref_put,
    )
    from opensearch_tpu_torch.rest.handlers import (
        get_cluster_settings as port_get,
        put_cluster_settings as port_put,
    )

    pair = Pair(tmp_path)
    try:
        calls = [(ref_put, port_put, {}, {"persistent": {
                     "search.knn.batch.max_wait_ms": "4ms"}}),
                 (ref_get, port_get, {"flat_settings": "true"}, None),
                 (ref_get, port_get, {"include_defaults": "true"}, None),
                 (ref_put, port_put, {"flat_settings": "true"},
                  {"transient": {"search.max_keep_alive": "2h"}}),
                 (ref_put, port_put, {}, {"persistent": {
                     "search.knn.batch.max_wait_ms": None}})]
        for ref_h, port_h, query, body in calls:
            pair.flow(lambda n: [observe(lambda: (
                ref_h if n is pair.ref else port_h)(n, {}, query, body))])
    finally:
        pair.close()
