"""`"profile": true` on a kNN search: TorchNode(device="cpu") against
TpuNode, on both routes.

The stacked serving step (the default) and the per-shard route (the step
switched off in both packages, the exact kernel policy "pallas" in both,
so each takes its K1 path: the port's kernel wrapper, the reference's
Pallas kernel in interpret mode) must give the reference's profile shape:
the same key set at every level, the same operator types and
descriptions, kernel names, shard ids and fetch sub-phases. Times differ;
what is held is their type and, where the reference's are, their being
positive (the reference's `rewrite_time`, its can_match, reads 0 in the
port, which has no can_match). Not held: the kernel rows' roofline fields
and the `profile.device` residency rows, which come with the port's
telemetry.

Beside it, the profiler's own contract: a profiled kernel fences and
records once; with no profiler active it records nothing.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu.search import ann as jax_ann
from opensearch_tpu.search import distributed_serving as jax_serving
from opensearch_tpu.telemetry import roofline
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.ops import knn as torch_knn
from opensearch_tpu_torch.ops import knn_fused
from opensearch_tpu_torch.search import ann as torch_ann
from opensearch_tpu_torch.search import distributed_serving as torch_serving
from opensearch_tpu_torch.search import profile

DIM = 8
N_DOCS = 90
# the roofline's fields on a kernel row: telemetry, not ported yet
ROOFLINE_FIELDS = {"achieved_gflops", "intensity", "roofline_fraction",
                   "bound"}


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    prev_peaks = roofline.current_peaks()
    roofline.set_peaks(roofline.stub_peaks(seed=3))
    rng = np.random.default_rng(8)
    data = rng.standard_normal((N_DOCS, DIM)).astype(np.float32).round(4)
    ref = TpuNode(tmp_path_factory.mktemp("tpu"))
    port = TorchNode(tmp_path_factory.mktemp("torch"), device="cpu")
    for node in (ref, port):
        for shards in (1, 3):
            name = f"p{shards}"
            node.create_index(name, {
                "settings": {"number_of_shards": shards},
                "mappings": {"properties": {
                    "v": {"type": "knn_vector", "dimension": DIM},
                    "age": {"type": "integer"}}}})
            node.bulk([("index", {"_index": name, "_id": str(i)},
                        {"v": data[i].tolist(), "age": i})
                       for i in range(N_DOCS)], refresh=True)
        node.create_index("ann", {"mappings": {"properties": {"v": {
            "type": "knn_vector", "dimension": DIM, "method": {
                "name": "ivf_pq", "parameters": {
                    "nlist": 4, "m": 2, "min_train": 64}}}}}})
        node.bulk([("index", {"_index": "ann", "_id": str(i)},
                    {"v": data[i].tolist()}) for i in range(N_DOCS)],
                  refresh=True)
    yield ref, port, data
    ref.close()
    port.close()
    if prev_peaks is not None:
        roofline.set_peaks(prev_peaks)


@pytest.fixture(params=["stacked", "per_shard"])
def route(request):
    if request.param == "stacked":
        yield request.param
        return
    exact = (jax_ann.default_config.exact_kernel,
             torch_ann.default_config.exact_kernel)
    jax_serving.enabled = torch_serving.enabled = False
    jax_ann.default_config.configure(exact_kernel="pallas")
    torch_ann.default_config.configure(exact_kernel="pallas")
    try:
        yield request.param
    finally:
        jax_serving.enabled = torch_serving.enabled = True
        jax_ann.default_config.configure(exact_kernel=exact[0])
        torch_ann.default_config.configure(exact_kernel=exact[1])


def _shape(obj, path="$"):
    """Keys, list lengths, strings and leaf types; roofline fields out."""
    if isinstance(obj, dict):
        return {k: _shape(v, f"{path}.{k}") for k, v in obj.items()
                if k not in ROOFLINE_FIELDS}
    if isinstance(obj, list):
        return [_shape(v, f"{path}[{i}]") for i, v in enumerate(obj)]
    if isinstance(obj, str):
        return obj
    return type(obj).__name__


def _positive_times(obj, path="$") -> set:
    """Paths of the nanosecond fields that are > 0."""
    out = set()
    if isinstance(obj, dict):
        for k, v in obj.items():
            sub = f"{path}.{k}"
            if isinstance(v, int) and not isinstance(v, bool) and \
                    (k.endswith("nanos") or k.endswith("_ns")) and v > 0:
                out.add(sub)
            out |= _positive_times(v, sub)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            out |= _positive_times(v, f"{path}[{i}]")
    return out


@pytest.mark.parametrize("shards", (1, 3))
def test_profile_has_the_references_shape(nodes, route, shards):
    ref, port, data = nodes
    body = {"query": {"knn": {"v": {"vector": (data[4] + 0.02).tolist(),
                                    "k": 5}}},
            "size": 5, "profile": True, "docvalue_fields": ["age"],
            "explain": True}
    want = ref.search(f"p{shards}", dict(body))
    got = port.search(f"p{shards}", dict(body))
    assert [h["_id"] for h in got["hits"]["hits"]] == \
        [h["_id"] for h in want["hits"]["hits"]]
    json.dumps(got)  # the server sends it as JSON: no numpy or torch scalar
    wp, gp = want["profile"], got["profile"]
    assert list(gp) == list(wp) == ["shards", "device"]
    assert gp["device"] == []
    assert _shape(gp["shards"]) == _shape(wp["shards"])
    # what the reference times, the port times too
    assert _positive_times(wp["shards"]) <= _positive_times(gp["shards"])
    kernels = [k["name"] for s in gp["shards"]
               for q in s["searches"][0]["query"] for k in q["kernels"]]
    if route == "stacked":
        assert set(kernels) == {"shard_mesh_knn"}
        launch_ids = {s["tpu"]["launches"][0]["launch_id"]
                      for s in gp["shards"]}
        assert len(launch_ids) == 1
    else:
        assert set(kernels) == {"knn_fused_pallas"}
    for s in gp["shards"]:
        assert s["tpu"]["device_time_in_nanos"] > 0
        assert s["searches"][0]["query"][0]["device_time_in_nanos"] > 0


def test_profile_of_a_batched_msearch_body_keeps_the_shape(nodes):
    """`profile` is not one of the keys a batched msearch body may carry
    (the reference's set), so such bodies run one by one, each with its
    own profile of the reference's shape."""
    ref, port, data = nodes
    searches = [({"index": "p3"}, {"query": {"knn": {"v": {
        "vector": data[i].tolist(), "k": 3}}}, "size": 3, "profile": True})
        for i in (1, 2)]
    want = ref.msearch(searches)
    got = port.msearch(searches)
    for w, g in zip(want["responses"], got["responses"]):
        assert _shape(g["profile"]["shards"]) == \
            _shape(w["profile"]["shards"])


def test_profiled_kernel_records_once_and_only_when_profiling():
    v = torch.randn(64, DIM)
    nrm = (v * v).sum(1)
    valid = torch.ones(64, dtype=torch.bool)
    q = torch.randn(2, DIM)
    prof = profile.ShardProfiler()
    with profile.profiling(prof), prof.operator("KnnQuery", "field=v"):
        knn_fused.knn_fused_auto(v, nrm, valid, q, k=4)
        # exact_knn_scores calls the profiled raw_similarity inside: one row
        torch_knn.exact_knn_scores(q, v, nrm, valid, "l2_norm")
    (op,) = prof.roots
    rows = {k["name"]: k for k in op.to_dict()["kernels"]}
    assert set(rows) == {"knn_fused_pallas", "knn_exact_scores"}
    assert all(r["calls"] == 1 and r["time_in_nanos"] > 0
               for r in rows.values())
    # every argument is a tensor on the node's device: nothing to ship
    assert rows["knn_exact_scores"]["transfer_bytes"] == 0
    # numpy arrays and host sequences are what a launch ships
    assert profile._host_bytes(np.zeros((3, DIM), np.float32)) == 3 * DIM * 4
    assert profile._host_bytes([1.0, 2.0]) == 16
    assert profile._host_bytes(torch.zeros(5)) == 0
    # the same signature again: not a first launch any more
    assert profile.signature_retraced("x", (v,), (1,)) is True
    assert profile.signature_retraced("x", (v,), (1,)) is False
    assert profile.active() is None
    before = dict(op.kernels)
    knn_fused.knn_fused_auto(v, nrm, valid, q, k=4)
    assert op.kernels == before


def test_fetch_profile_counts_each_subphase(nodes):
    _ref, port, data = nodes
    got = port.search("p1", {"query": {"knn": {"v": {
        "vector": data[0].tolist(), "k": 4}}}, "size": 4, "profile": True,
        "docvalue_fields": ["age"], "explain": True, "fields": ["age"]})
    fetch = got["profile"]["shards"][0]["fetch"]
    assert fetch["debug"]["hits_fetched"] == 4
    for phase in ("load_source", "docvalue_fields", "fields", "explain"):
        assert fetch["breakdown"][f"{phase}_count"] == 4
    assert fetch["breakdown"]["highlight_count"] == 0


def test_ann_profile_has_the_references_shape(nodes):
    """The IVF-PQ route (both packages' ADC scan under the "pallas"
    policy: the port's K2 wrapper, the reference's Pallas kernel in
    interpret mode) records "ivfpq_adc_pallas" with the reference's
    annotations."""
    ref, port, data = nodes
    kernels = (jax_ann.default_config.kernel, torch_ann.default_config.kernel)
    jax_ann.default_config.configure(kernel="pallas")
    torch_ann.default_config.configure(kernel="pallas")
    try:
        body = {"query": {"knn": {"v": {"vector": data[9].tolist(),
                                        "k": 4}}},
                "size": 4, "profile": True}
        want = ref.search("ann", dict(body))
        got = port.search("ann", dict(body))
    finally:
        jax_ann.default_config.configure(kernel=kernels[0])
        torch_ann.default_config.configure(kernel=kernels[1])
    json.dumps(got)
    assert _shape(got["profile"]["shards"]) == \
        _shape(want["profile"]["shards"])
    (op,) = got["profile"]["shards"][0]["searches"][0]["query"]
    assert [k["name"] for k in op["kernels"]] == ["ivfpq_adc_pallas"]
