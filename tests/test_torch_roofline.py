"""The port's kernel roofline (opensearch_tpu_torch/telemetry/roofline.py)
against the reference's.

Each cost model equals the reference's over a grid of launch parameters,
as exact integers, under the same family names; the shape adapters give
the reference's parameters for the port's tensors; the recorder's rows,
report and kernel-row fields are the reference's under the same stub
peaks and walls; the calibration probe runs on the CPU at the reference's
small sizes and caches per platform. A warm TorchNode reports its kernel
families through the port's router (``GET /_roofline``,
``POST /_roofline/calibrate``, ``GET /_tiering/advise``), with the
accounting identity and one row per route.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from opensearch_tpu.telemetry import roofline as ref_roofline
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.rest.handlers import build_router
from opensearch_tpu_torch.search import ann as ann_mod
from opensearch_tpu_torch.search import distributed_serving
from opensearch_tpu_torch.telemetry import roofline
from opensearch_tpu_torch.telemetry.roofline import (
    COST_MODELS,
    PlatformPeaks,
    RooflineRecorder,
    stub_peaks,
)


@pytest.fixture()
def stubbed_peaks():
    """The same deterministic peak table in both packages; whatever was
    active comes back after."""
    prev, ref_prev = roofline.current_peaks(), ref_roofline.current_peaks()
    roofline.set_peaks(PlatformPeaks("test", 1000.0, 100.0, source="stub",
                                     calibrated_at_ms=0))
    ref_roofline.set_peaks(ref_roofline.PlatformPeaks(
        "test", 1000.0, 100.0, source="stub", calibrated_at_ms=0))
    yield
    if prev is not None:
        roofline.set_peaks(prev)
    if ref_prev is not None:
        ref_roofline.set_peaks(ref_prev)


# ---------------------------------------------------------------------------
# cost models
# ---------------------------------------------------------------------------


def test_the_same_families_as_the_reference():
    assert set(COST_MODELS) == set(ref_roofline.COST_MODELS)
    assert roofline.KNOWN_FAMILIES == ref_roofline.KNOWN_FAMILIES
    assert roofline.base_family("ivfpq_search[int8]") == "ivfpq_search"


_GRID = {
    "b": (1, 7, 200), "n": (1, 1000, 1 << 20), "d": (16, 128),
    "k": (1, 10, 1024), "r": (10, 40, 512),
    "precision": ("fp32", "bf16", "int8"),
    "nlist": (8, 512), "m": (4, 20), "ks": (256,), "nprobe": (1, 8),
    "l_pad": (64, 4096), "rescore": (0, 40),
    "adc_precision": ("fp32", "bf16", "int8"),
    "s": (1, 4), "n_flat": (8, 262_144), "k_shard": (1, 10),
    "devices": (1, 4),
    "q": (1, 8), "window": (16, 128), "n_pad": (64, 1 << 20),
}
_PARAMS = {
    "knn_exact_scores": ("b", "n", "d"),
    "knn_raw_similarity": ("b", "n", "d"),
    "knn_topk_streaming": ("b", "n", "d", "k"),
    "ivfpq_search": ("b", "nlist", "d", "m", "ks", "nprobe", "l_pad",
                     "rescore", "adc_precision"),
    "ivfpq_adc_pallas": ("b", "nlist", "d", "m", "ks", "nprobe", "l_pad",
                         "rescore", "adc_precision"),
    "knn_fused_pallas": ("b", "n", "d", "r", "precision"),
    "mesh_knn": ("b", "s", "n_flat", "d", "k_shard", "devices"),
    "mesh_knn_fused": ("b", "s", "n_flat", "d", "k_shard", "devices", "r",
                       "precision"),
    "bm25_term_scores": ("q", "window", "n_pad"),
    "constant_term_scores": ("q", "window", "n_pad"),
}


@pytest.mark.parametrize("family", sorted(_PARAMS))
def test_cost_models_equal_the_references_as_integers(family):
    keys = _PARAMS[family]
    n = 0
    for values in itertools.product(*(_GRID[k] for k in keys)):
        params = dict(zip(keys, values))
        got = COST_MODELS[family](params)
        want = ref_roofline.COST_MODELS[family](params)
        assert got == want and all(type(x) is int for x in got), params
        n += 1
    assert n > 1
    assert set(_PARAMS) == set(COST_MODELS)


def test_hand_computed_exact_and_mesh_models():
    flops, nbytes = COST_MODELS["knn_exact_scores"](
        {"b": 2, "n": 1000, "d": 128})
    assert flops == 2 * 2 * 1000 * 128 + 4 * 2 * 1000
    assert nbytes == 4 * (1000 * 128 + 1000 + 2 * 128 + 2 * 1000)
    flops, nbytes = COST_MODELS["mesh_knn"](
        {"b": 4, "s": 2, "n_flat": 64, "d": 8, "k_shard": 5, "devices": 1})
    assert flops == 2 * 4 * 2 * 64 * 8 + 4 * 4 * 2 * 64
    assert nbytes == 4 * (2 * 64 * 8 + 2 * 2 * 64 + 4 * 8) + 8 * 4 * 5


def test_adapters_read_tensor_shapes_as_the_reference_reads_arrays():
    """The kernel entry points' argument shapes map onto the reference's
    launch parameters; a stacked [S, n, d] slab counts its S * n rows."""
    from opensearch_tpu_torch.ops.knn_fused import fused_pool_width

    v, q = torch.zeros(300, 16), torch.zeros(5, 16)
    nrm, ok = torch.zeros(300), torch.ones(300, dtype=torch.bool)
    adapt = roofline._KERNEL_PARAM_ADAPTERS
    assert adapt["knn_exact_scores"]((q, v, nrm, ok, "l2_norm"), {}) == \
        ref_roofline._KERNEL_PARAM_ADAPTERS["knn_exact_scores"](
            (np.zeros((5, 16)), np.zeros((300, 16))), {})
    kw = {"k": 10, "score_precision": "bf16"}
    assert adapt["knn_fused_pallas"]((v, nrm, ok, q), kw) == {
        "b": 5, "n": 300, "d": 16, "k": 10,
        "r": fused_pool_width(10, "bf16"), "precision": "bf16"}
    stacked = torch.zeros(4, 300, 16)
    assert adapt["knn_fused_pallas"]((stacked, nrm, ok, q), kw)["n"] == 1200
    bm25_args = (None, None, None, np.zeros(6, np.int32), None, None, None,
                 1024, 128)
    assert adapt["bm25_term_scores"](bm25_args, {}) == \
        ref_roofline._KERNEL_PARAM_ADAPTERS["bm25_term_scores"](
            bm25_args, {}) == {"q": 6, "window": 128, "n_pad": 1024}
    assert adapt["constant_term_scores"](
        (None, [1, 2, 3], None, None, 64, 16), {}) == \
        {"q": 3, "window": 16, "n_pad": 64}


# ---------------------------------------------------------------------------
# recorder
# ---------------------------------------------------------------------------


def _feed(mod) -> "RooflineRecorder":
    rec = mod.RooflineRecorder()
    rec.record("x", 1_000_000_000, flops=400, nbytes=8)
    rec.record("mem", 2_000_000_000, flops=10, nbytes=100)
    rec.record("knn_exact_scores", 5_000, params={"b": 2, "n": 64, "d": 8})
    rec.record("knn_exact_scores", 9_000, params={"b": 4, "n": 64, "d": 8})
    rec.record("ivfpq_search[int8]", 7_000, params={
        "b": 1, "nlist": 8, "d": 16, "m": 4, "ks": 256, "nprobe": 2,
        "l_pad": 64, "rescore": 10, "adc_precision": "int8"})
    rec.record("ivfpq_search[fp32]", 7_000, params={
        "b": 1, "nlist": 8, "d": 16, "m": 4, "ks": 256, "nprobe": 2,
        "l_pad": 64, "rescore": 10, "adc_precision": "fp32"})
    rec.record("no_model", 1_000, params={"b": 1})
    rec.record("knn_exact_scores", 1_000)  # no params: unmodeled
    return rec


def test_recorder_rows_report_and_fields_are_the_references(stubbed_peaks):
    got, want = _feed(roofline), _feed(ref_roofline)
    assert got.snapshot_stats() == want.snapshot_stats()
    assert got.report() == want.report()
    for name in ("x", "knn_exact_scores", "ivfpq_search", "absent"):
        assert got.kernel_row_fields(name) == want.kernel_row_fields(name)
    snap = got.snapshot_stats()
    assert snap["identity_ok"]
    assert snap["counters"]["unmodeled_launches"] == 2
    x = snap["families"]["x"]
    assert (x["intensity"], x["roofline_fraction"], x["bound"]) == \
        (50.0, 0.4, "compute")
    assert snap["families"]["mem"]["bound"] == "memory"
    rows = got.report()["families"]
    assert [r["lost_ms"] for r in rows] == sorted(
        (r["lost_ms"] for r in rows), reverse=True)


def test_fraction_clamp_and_family_bound(stubbed_peaks):
    rec = RooflineRecorder()
    rec.record("fast", 1, flops=10 ** 12, nbytes=1)
    assert rec.snapshot_stats()["families"]["fast"]["roofline_fraction"] \
        == 1.0
    for i in range(roofline.MAX_FAMILIES + 3):
        rec.record(f"f{i}", 1000, flops=1, nbytes=1)
    fams = rec.snapshot_stats()["families"]
    assert len(fams) == roofline.MAX_FAMILIES + 1
    assert fams[roofline.OVERFLOW_FAMILY]["launches"] == 4
    assert rec.snapshot_stats()["identity_ok"]


def test_observe_kernel_folds_a_profiled_launch(stubbed_peaks):
    roofline.default_recorder.reset()
    q, v = torch.zeros(3, 8), torch.zeros(50, 8)
    roofline.observe_kernel("knn_exact_scores", (q, v), {}, 4_000)
    roofline.observe_kernel("unknown_kernel", (q,), {}, 4_000)
    snap = roofline.default_recorder.snapshot_stats()
    row = snap["families"]["knn_exact_scores"]
    assert (row["flops"], row["bytes"]) == COST_MODELS["knn_exact_scores"](
        {"b": 3, "n": 50, "d": 8})
    assert snap["counters"]["unmodeled_launches"] == 1
    roofline.default_recorder.reset()


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def test_stub_peaks_are_the_references():
    for seed in (0, 1, 16, 17):
        assert stub_peaks(seed).to_dict() == \
            ref_roofline.stub_peaks(seed).to_dict()


def test_cpu_calibration_measures_caches_and_restores():
    prev = roofline.current_peaks()
    try:
        peaks = roofline.calibrate(force=True, device="cpu")
        assert peaks.platform == "cpu" and peaks.source == "measured"
        assert peaks.flops_per_s > 0 and peaks.bytes_per_s > 0
        assert roofline.calibrate(device="cpu") is peaks
        assert roofline.ensure_peaks() is peaks
    finally:
        if prev is not None:
            roofline.set_peaks(prev)


def test_probe_sizes_fill_the_card_and_stay_small_on_the_cpu():
    # on the card: 1.4e11 FLOPs and 2 GiB moved, far past a launch's cost
    assert 2 * roofline.CARD_MATMUL_N ** 3 >= 2 * 4096 ** 3
    assert roofline.CARD_COPY_BYTES >= 1 << 30
    # on the CPU: the reference's 512^3 product and 16 MiB copy
    assert roofline.CPU_MATMUL_N == 512
    assert roofline.CPU_COPY_BYTES == 16 << 20


# ---------------------------------------------------------------------------
# a warm node through the port's router
# ---------------------------------------------------------------------------


def _handle(node, method, path, query=None, body=None):
    handler, params = build_router().resolve(method, path)
    return handler(node, params, query or {}, body)


@pytest.fixture()
def warm_node(tmp_path):
    """A node that has launched each route's kernel family: the per-shard
    exact scan (stacked step off), the stacked step over 2 shards, IVF-PQ
    at three ADC precisions, and a profiled BM25 match."""
    prev_peaks = roofline.current_peaks()
    roofline.set_peaks(stub_peaks(seed=1))
    roofline.default_recorder.reset()
    rng = np.random.default_rng(7)
    d = 16
    node = TorchNode(tmp_path / "data", device="cpu")

    def vec_index(name, n_docs, shards=1, method=None):
        mapping = {"type": "knn_vector", "dimension": d}
        if method is not None:
            mapping["method"] = method
        node.create_index(name, {
            "settings": {"number_of_shards": shards},
            "mappings": {"properties": {"v": mapping}}})
        node.bulk([("index", {"_index": name, "_id": str(i)},
                    {"v": rng.normal(size=d).round(4).tolist()})
                   for i in range(n_docs)], refresh=True)

    vec_index("ex", 48)
    vec_index("m2", 48, shards=2)
    vec_index("annv", 600, method={
        "name": "ivf_pq", "parameters": {"nlist": 8, "m": 4, "nprobe": 4}})
    node.create_index("lex", {"mappings": {"properties": {
        "msg": {"type": "text"}}}})
    for i in range(8):
        node.index_doc("lex", str(i), {"msg": f"hello world {i}"})
    node.refresh("lex")

    def knn(index):
        node.search(index, {"size": 3, "query": {"knn": {"v": {
            "vector": rng.normal(size=d).round(4).tolist(), "k": 3}}}})

    distributed_serving.enabled = False
    try:
        for _ in range(3):
            knn("ex")
    finally:
        distributed_serving.enabled = True
    for _ in range(3):
        knn("m2")
    for precision in ("fp32", "bf16", "int8"):
        ann_mod.default_config.configure(adc_precision=precision)
        for _ in range(3):
            knn("annv")
    ann_mod.default_config.configure(adc_precision="fp32")
    node.search("lex", {"query": {"match": {"msg": "hello"}},
                        "profile": True})
    yield node
    node.close()
    roofline.default_recorder.reset()
    if prev_peaks is not None:
        roofline.set_peaks(prev_peaks)


def test_roofline_report_ranks_each_routes_family(warm_node):
    status, report = _handle(warm_node, "GET", "/_roofline")
    assert status == 200 and report["identity_ok"]
    rows = {r["family"]: r for r in report["families"]}
    # the CPU runs the plain versions under the same policy names: the
    # fused exact scan is knn_fused_pallas, the ANN scan ivfpq_adc_pallas
    assert {"knn_fused_pallas[fp32]", "mesh_knn_fused[fp32]",
            "bm25_term_scores", "ivfpq_adc_pallas[fp32]",
            "ivfpq_adc_pallas[bf16]", "ivfpq_adc_pallas[int8]"} <= set(rows)
    assert rows["knn_fused_pallas[fp32]"]["launches"] == 3
    assert rows["mesh_knn_fused[fp32]"]["launches"] == 3
    for prec in ("fp32", "bf16", "int8"):
        assert rows[f"ivfpq_adc_pallas[{prec}]"]["launches"] == 3
    assert rows["bm25_term_scores"]["launches"] == 1
    losses = [r["lost_ms"] for r in report["families"]]
    assert losses == sorted(losses, reverse=True)
    assert report["top_offender"] == report["families"][0]["family"]
    for r in report["families"]:
        assert 0.0 < r["roofline_fraction"] <= 1.0
        assert r["bound"] in ("memory", "compute")
    assert report["peaks"]["source"] == "stub"
    assert sum(r["flops"] for r in report["families"]) == \
        report["counters"]["accounted_flops"]


def test_profile_rows_carry_roofline_fields(warm_node):
    ann_mod.default_config.configure(adc_precision="int8")
    try:
        resp = warm_node.search("annv", {
            "size": 3, "profile": True,
            "query": {"knn": {"v": {"vector": [0.1] * 16, "k": 3}}}})
    finally:
        ann_mod.default_config.configure(adc_precision="fp32")
    rows = [k for s in resp["profile"]["shards"]
            for q in s["searches"][0]["query"] for k in q.get("kernels", [])]
    ivf = next(r for r in rows if r["name"] == "ivfpq_adc_pallas")
    assert 0.0 < ivf["roofline_fraction"] <= 1.0
    assert ivf["bound"] in ("memory", "compute")
    assert ivf["achieved_gflops"] > 0 and ivf["intensity"] > 0
    assert ivf["adc_precision"] == "int8"


def test_calibrate_endpoint_round_trip(warm_node):
    prev = roofline.current_peaks()
    try:
        status, resp = _handle(warm_node, "POST", "/_roofline/calibrate")
        assert status == 200 and resp["acknowledged"]
        peaks = resp["peaks"]
        assert peaks["source"] == "measured" and peaks["platform"] == "cpu"
        assert peaks["peak_flops_per_s"] > 0 and peaks["peak_bytes_per_s"] > 0
    finally:
        if prev is not None:
            roofline.set_peaks(prev)


def test_tiering_advise_endpoint(warm_node):
    from opensearch_tpu_torch.cluster.shard_mesh import default_registry
    from opensearch_tpu_torch.common.errors import IllegalArgumentException

    status, resp = _handle(warm_node, "GET", "/_tiering/advise",
                           query={"hbm_budget": "1gb"})
    assert status == 200 and resp["hbm_budget_bytes"] == 1 << 30
    assert resp["projected"]["accesses"] >= 3
    mine = [r for r in resp["structures"] if r["index"] == "m2"]
    assert mine and mine[0]["kind"] == "mesh_bundle"
    assert mine[0]["hits"] >= 1
    status, resp = _handle(warm_node, "GET", "/_tiering/advise")
    assert resp["hbm_budget_bytes"] == default_registry.hbm_budget_bytes
    with pytest.raises(IllegalArgumentException):
        _handle(warm_node, "GET", "/_tiering/advise",
                query={"hbm_budget": "lots"})
    with pytest.raises(IllegalArgumentException):
        _handle(warm_node, "GET", "/_tiering/advise",
                query={"hbm_budget": "-5"})
