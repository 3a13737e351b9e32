"""The shard mesh over several devices, against the reference's mesh on
the 8 virtual CPU devices tests/conftest.py gives it.

- ``mesh_knn_batch`` (search/distributed_serving.py): S shards go over the
  largest divisor of S no greater than the serving devices. The port with
  serving devices ``["cpu"] * 8`` (``backend.set_serving_devices``) gives
  the reference's hits for S = 1, 2, 3, 4, 6 and 8 (n_devices 1, 2, 3, 4,
  6, 8), at each similarity, filtered and not, a batch of 4, with scores
  to the tolerance tests/test_torch_shard_mesh.py states (rtol 1e-6); its
  bundle holds one slab and one ledger allocation a slot, and the
  registry frees every slot's allocation on eviction.
- The multi-slot serving step gives the one-slot step's bits, at every
  kernel, precision and similarity, and through ``mesh_knn_batch``.
- ``_largest_divisor_at_most`` and ``build_mesh``'s default n_data and
  "needs N devices" error are the reference's; a serving-devices
  override never changes a node's kind of device.
- The tensor-parallel program over slots ``["cpu"] * 8`` (one device) and
  over eight device labels ``cpu:0`` .. ``cpu:7`` (which torch places on
  the one CPU), both laid out slot by slot, gives the reference's 4 x 2 mesh's answer at n_model 1 and 2,
  all-gather and ring.
- The roofline bounds a launch over c distinct cards by c times the
  per-card peaks; the ledger reads its bytes by device.
- Every C launcher call of the kernel wrappers sits inside
  ``torch.cuda.device(<the tensor's device>)``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_tpu.node import TpuNode
from opensearch_tpu.parallel import distributed as ref_dist
from opensearch_tpu.parallel.mesh import build_mesh as ref_build_mesh
from opensearch_tpu.search import distributed_serving as ref_serving
from opensearch_tpu.search import query_dsl as ref_dsl
from opensearch_tpu_torch import backend, interop
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.parallel import distributed as port_dist
from opensearch_tpu_torch.parallel.mesh import build_mesh
from opensearch_tpu_torch.search import distributed_serving, query_dsl
from opensearch_tpu_torch.telemetry import roofline
from opensearch_tpu_torch.telemetry.device_ledger import (
    KIND_MESH_BUNDLE,
    default_ledger,
)

DIMS = 8
SIMS = {"l2": "l2_norm", "cosinesimil": "cosine", "innerproduct": "dot_product"}
CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _clean():
    distributed_serving.clear_caches()
    ref_serving.clear_caches()
    prev = backend.set_serving_devices(None)
    yield
    backend.set_serving_devices(prev)
    distributed_serving.clear_caches()
    ref_serving.clear_caches()


def _body(n_shards, space):
    return {"settings": {"number_of_shards": n_shards},
            "mappings": {"properties": {
                "v": {"type": "knn_vector", "dimension": DIMS,
                      "space_type": space},
                "tag": {"type": "keyword"}}}}


def _docs(n_docs, seed):
    rng = np.random.default_rng(seed)
    return [("index", {"_index": "vecs", "_id": f"d{i}"},
             {"v": rng.standard_normal(DIMS).round(3).tolist(),
              "tag": "ab"[i % 2]})
            for i in range(n_docs)]


def _nodes(tmp_path, n_shards, space, seed, *, ref=True):
    out = []
    for cls, name, kw in ((TpuNode, "ref", {}),
                          (TorchNode, "port", {"device": "cpu"})):
        if cls is TpuNode and not ref:
            continue
        node = cls(tmp_path / name, **kw)
        node.create_index("vecs", _body(n_shards, space))
        node.bulk(_docs(12 * n_shards + 5, seed), refresh=True)
        out.append(node)
    return out


def _batch(dsl, vectors, filtered):
    body = {"vector": vectors[0], "k": 5}
    if filtered:
        body["filter"] = {"term": {"tag": "a"}}
    nodes = []
    for vec in vectors:
        node = dsl.parse_query({"knn": {"v": {**body, "vector": vec}}})
        if nodes:
            # a batch shares its filter by identity
            node.filter = nodes[0].filter
        nodes.append(node)
    return nodes


def _launch(serving_mod, dsl, node, vectors, filtered):
    svc = node.indices["vecs"]
    shards = [svc.shards[i] for i in sorted(svc.shards)]
    snaps = [s.acquire_searcher() for s in shards]
    return serving_mod.mesh_knn_batch(shards, snaps,
                                      _batch(dsl, vectors, filtered), 10)


def _rows(out):
    return [[(si, h.segment, h.doc, h.score) for si, h in rows]
            for rows in out.premerged]


def _queries(seed, b=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(DIMS).round(3).tolist() for _ in range(b)]


def _mesh_bundle_allocs():
    return [a for a in default_ledger.live_allocations()
            if a.kind == KIND_MESH_BUNDLE and a.index == "vecs"]


@pytest.mark.parametrize("filtered", [False, True],
                         ids=["unfiltered", "filtered"])
@pytest.mark.parametrize("space", list(SIMS))
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 6, 8])
def test_serving_over_eight_slots_is_the_references_eight_devices(
        tmp_path, n_shards, space, filtered):
    assert len(jax.devices()) == 8
    backend.set_serving_devices(CPU8)
    ref, port = _nodes(tmp_path, n_shards, space, seed=n_shards)
    try:
        queries = _queries(n_shards + 100)
        want = _launch(ref_serving, ref_dsl, ref, queries, filtered)
        got = _launch(distributed_serving, query_dsl, port, queries,
                      filtered)
        for w_rows, g_rows in zip(_rows(want), _rows(got)):
            assert [r[:3] for r in g_rows] == [r[:3] for r in w_rows]
            np.testing.assert_allclose([r[3] for r in g_rows],
                                       [r[3] for r in w_rows], rtol=1e-6)
        for w_res, g_res in zip(want.per_query, got.per_query):
            assert [r.total for r in g_res] == [r.total for r in w_res]
        # the reference's device count, and one slab and one ledger
        # allocation a slot
        n_devices = ref_serving._largest_divisor_at_most(n_shards, 8)
        (bundle,) = distributed_serving.registry._bundles.values()
        assert len(bundle.slot_vectors) == n_devices
        assert all(v.shape[0] == n_shards // n_devices
                   for v in bundle.slot_vectors)
        allocs = _mesh_bundle_allocs()
        assert len(allocs) == n_devices
        assert sum(a.bytes for a in allocs) == bundle.nbytes
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("filtered", [False, True],
                         ids=["unfiltered", "filtered"])
@pytest.mark.parametrize("n_shards", [2, 4, 6, 8])
def test_slots_give_the_one_slot_bits_through_the_service(
        tmp_path, n_shards, filtered):
    (port,) = _nodes(tmp_path, n_shards, "l2", seed=7 + n_shards,
                     ref=False)
    try:
        queries = _queries(n_shards)
        one = _launch(distributed_serving, query_dsl, port, queries,
                      filtered)
        one_bytes = sum(a.bytes for a in _mesh_bundle_allocs())
        assert len(_mesh_bundle_allocs()) == 1
        distributed_serving.clear_caches()
        backend.set_serving_devices(CPU8)
        many = _launch(distributed_serving, query_dsl, port, queries,
                       filtered)
        assert _rows(many) == _rows(one)
        assert [[(r.total, r.max_score, [(h.score, h.segment, h.doc)
                                          for h in r.hits]) for r in q]
                for q in many.per_query] == \
            [[(r.total, r.max_score, [(h.score, h.segment, h.doc)
                                      for h in r.hits]) for r in q]
             for q in one.per_query]
        allocs = _mesh_bundle_allocs()
        n_devices = distributed_serving._largest_divisor_at_most(n_shards, 8)
        assert len(allocs) == n_devices
        # the slots' slabs hold what the one slab held
        assert sum(a.bytes for a in allocs) == one_bytes
    finally:
        port.close()


def _step_inputs(seed, s, n=64, b=4):
    rng = np.random.default_rng(seed)
    vectors = rng.standard_normal((s, n, DIMS)).astype(np.float32)
    norms = (vectors.astype(np.float64) ** 2).sum(2).astype(np.float32)
    valid = rng.random((s, n)) > 0.15
    valid[-1, 3:] = False  # a shard with fewer live docs than k_shard
    queries = rng.standard_normal((b, DIMS)).astype(np.float32)
    return (torch.from_numpy(vectors), torch.from_numpy(norms),
            torch.from_numpy(valid), torch.from_numpy(queries))


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("kernel", ["pallas", "xla"])
@pytest.mark.parametrize("s,slots", [(2, 2), (6, 2), (6, 3), (6, 6),
                                     (8, 4), (8, 8)])
def test_multi_slot_step_is_the_one_slot_steps_bits(s, slots, kernel,
                                                    precision):
    args = _step_inputs(s * 10 + slots, s)
    one = [[x] for x in args[:3]]
    # S / n consecutive shards a slot, each slot on a device label of its
    # own (torch keeps them all on the one CPU)
    many = [[g.to(f"cpu:{i}") for i, g in enumerate(x.chunk(slots))]
            for x in args[:3]]
    for sim in SIMS.values():
        step = port_dist.build_knn_serving_step(
            k_shard=8, k_final=min(10, 8 * s), similarity=sim,
            kernel=kernel, score_precision=precision)
        for a, b in zip(step(*one, args[3]), step(*many, args[3])):
            assert a.dtype == b.dtype and torch.equal(a, b), (sim, a, b)


def test_step_refuses_mismatched_slot_groups():
    v, nrm, ok, q = _step_inputs(1, 6)
    step = port_dist.build_knn_serving_step(
        k_shard=4, k_final=4, similarity="l2_norm")
    with pytest.raises(ValueError, match="slot groups"):
        step([v], list(nrm.chunk(2)), [ok], q)
    with pytest.raises(ValueError, match="slot groups"):
        step([], [], [], q)


@pytest.mark.parametrize("s", range(1, 17))
def test_largest_divisor_is_the_references(s):
    for cap in range(1, 9):
        assert distributed_serving._largest_divisor_at_most(s, cap) == \
            ref_serving._largest_divisor_at_most(s, cap)


@pytest.mark.parametrize("n_data,n_model", [(None, 1), (None, 2), (None, 4),
                                            (2, 2), (4, 2), (8, 1)])
def test_build_mesh_shapes_are_the_references(n_data, n_model):
    ref = ref_build_mesh(n_data=n_data, n_model=n_model)
    port = build_mesh(n_data=n_data, n_model=n_model, devices=CPU8)
    assert port.shape == dict(ref.shape)
    assert port.devices.shape == ref.devices.shape
    assert port.device == torch.device("cpu")


@pytest.mark.parametrize("n_data,n_model", [(4, 4), (9, 1), (3, 3)])
def test_build_mesh_too_few_devices_raises_as_the_reference(n_data, n_model):
    with pytest.raises(ValueError) as want:
        ref_build_mesh(n_data=n_data, n_model=n_model)
    with pytest.raises(ValueError) as got:
        build_mesh(n_data=n_data, n_model=n_model, devices=CPU8)
    assert str(got.value) == str(want.value)
    assert f"needs {n_data * n_model} devices, have 8" in str(got.value)


def test_serving_devices_rules():
    assert backend.serving_devices("cpu") == [torch.device("cpu")]
    backend.set_serving_devices(CPU8)
    assert backend.serving_devices("cpu") == [torch.device("cpu")] * 8
    assert build_mesh(devices=backend.serving_devices("cpu")).shape == \
        {"data": 8, "model": 1}
    with pytest.raises(ValueError, match="empty"):
        backend.set_serving_devices([])
    assert backend.set_serving_devices(None) == [torch.device("cpu")] * 8
    if not torch.cuda.is_available():
        # nothing moves to the CPU on its own
        with pytest.raises(RuntimeError, match="cuda"):
            backend.serving_devices("cuda")


def test_an_override_of_cards_refuses_a_cpu_node(monkeypatch):
    """An override may repeat or reorder the node's kind of device, never
    change it: cards set for a CPU node raise. (The override is set
    directly: without a card set_serving_devices cannot name one.)"""
    monkeypatch.setattr(backend, "_serving_override",
                        [torch.device("cuda", 0)] * 4)
    with pytest.raises(ValueError, match="not of the node's device type"):
        backend.serving_devices("cpu")


@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a card: the node is a CUDA node")
def test_a_cpu_override_refuses_a_cuda_node(tmp_path):
    """A CPU override left set in a process never puts a CUDA node's kNN
    slabs on the CPU: its serving devices, and so its search, raise."""
    backend.set_serving_devices(CPU8)
    with pytest.raises(ValueError, match="not of the node's device type"):
        backend.serving_devices("cuda")
    node = TorchNode(tmp_path / "port", device="cuda")
    try:
        node.create_index("vecs", _body(2, "l2"))
        node.bulk(_docs(29, 1), refresh=True)
        with pytest.raises(ValueError, match="not of the node's device"):
            _launch(distributed_serving, query_dsl, node, _queries(5),
                    False)
    finally:
        node.close()


# the tensor-parallel program over slots, against the reference's 4 x 2

S, N_PAD, D, B, K, Q, P_PAD, WINDOW = 4, 64, 16, 3, 5, 4, 128, 16
SEG_KEYS = ("vectors", "norms_sq", "valid", "postings_docs", "postings_tfs",
            "doc_len")


def _tp_inputs(seed):
    rng = np.random.default_rng(seed)
    # sixteenths: every dot and |q|^2 exact in any order
    v = (rng.integers(-16, 17, (S, N_PAD, D)) / 16).astype(np.float32)
    valid = np.ones((S, N_PAD), bool)
    valid[:, -3:] = False
    valid[2, 5] = False
    return {
        "vectors": v,
        "norms_sq": (v.astype(np.float64) ** 2).sum(-1).astype(np.float32),
        "valid": valid,
        "postings_docs": rng.integers(0, N_PAD - 3, (S, P_PAD)).astype(
            np.int32),
        "postings_tfs": rng.integers(1, 5, (S, P_PAD)).astype(np.float32),
        "doc_len": rng.integers(5, 50, (S, N_PAD)).astype(np.float32),
        "queries": (rng.integers(-16, 17, (B, D)) / 16).astype(np.float32),
        "offsets": rng.integers(0, P_PAD - WINDOW, (S, Q)).astype(np.int32),
        "lengths": np.zeros((S, Q), np.int32),
        "idfs": rng.uniform(0.5, 3.0, (S, Q)).astype(np.float32),
        "avgdl": rng.uniform(10.0, 40.0, S).astype(np.float32),
    }


def _tp_reference(inp, *, n_model, ring, similarity):
    mesh = ref_build_mesh(n_data=S, n_model=n_model)
    segs = ref_dist.ShardedSegments(*(jnp.asarray(inp[k]) for k in SEG_KEYS))
    qargs = ref_dist.QueryArgs(
        jnp.asarray(inp["queries"]), jnp.asarray(inp["offsets"]),
        jnp.asarray(inp["lengths"]), jnp.asarray(inp["idfs"]),
        jnp.asarray(inp["avgdl"]), jnp.float32(0.0), jnp.float32(1.0))
    with mesh:
        fn = ref_dist.build_distributed_search(
            mesh, k=K, window=WINDOW, similarity=similarity, ring=ring)
        vals, ids = jax.block_until_ready(
            fn(ref_dist.shard_arrays_to_mesh(mesh, segs), qargs))
    return np.asarray(vals), np.asarray(ids).astype(np.int64)


def _tp_port(inp, *, n_model, ring, similarity, devices):
    mesh = build_mesh(n_data=S, n_model=n_model, devices=devices)
    segs = interop.sharded_segments_from_numpy(
        *(inp[k] for k in SEG_KEYS), device="cpu")
    qargs = interop.query_args_from_numpy(
        inp["queries"], inp["offsets"], inp["lengths"], inp["idfs"],
        inp["avgdl"], 0.0, 1.0, device="cpu")
    laid = port_dist.shard_arrays_to_mesh(mesh, segs)
    fn = port_dist.build_distributed_search(
        mesh, k=K, window=WINDOW, similarity=similarity, ring=ring)
    vals, ids = fn(laid, qargs)
    return laid, vals.numpy(), ids.numpy()


@pytest.mark.parametrize("similarity", ["l2_norm", "cosine", "dot_product"])
@pytest.mark.parametrize("ring", [False, True], ids=["all_gather", "ring"])
@pytest.mark.parametrize("n_model", [1, 2])
@pytest.mark.parametrize("form", ["one_device", "device_labels"])
def test_tensor_parallel_over_slots_is_the_references(form, n_model, ring,
                                                      similarity):
    inp = _tp_inputs(300 + n_model * 10 + ring)
    devices = (CPU8 if form == "one_device"
               else [f"cpu:{i}" for i in range(8)])
    laid, pv, pi = _tp_port(inp, n_model=n_model, ring=ring,
                            similarity=similarity, devices=devices)
    rv, ri = _tp_reference(inp, n_model=n_model, ring=ring,
                           similarity=similarity)
    # slot by slot on any mesh: shard s's n_model column slices, its other
    # rows
    assert len(laid.vectors) == S
    assert all(len(row) == n_model and row[0].shape == (N_PAD, D // n_model)
               for row in laid.vectors)
    assert len(laid.doc_len) == S and laid.doc_len[0].shape == (N_PAD,)
    np.testing.assert_array_equal(pi, ri)
    # on sixteenths every dot and |q|^2 is exact: the reference's bits,
    # but at cosine, whose square roots and division XLA may round one
    # ulp apart
    ulps = np.abs(pv.view(np.int32).astype(np.int64)
                  - rv.view(np.int32).astype(np.int64))
    assert ulps.max() <= (1 if similarity == "cosine" else 0)
    # the slot-by-slot layout gives the one-device layout's bits
    if form == "device_labels":
        _laid, ov, oi = _tp_port(inp, n_model=n_model, ring=ring,
                                 similarity=similarity, devices=CPU8)
        np.testing.assert_array_equal(pv.view(np.int32), ov.view(np.int32))
        np.testing.assert_array_equal(pi, oi)


def test_roofline_bound_takes_the_distinct_cards():
    rec = roofline.RooflineRecorder()
    params = dict(b=4, s=4, n_flat=1 << 16, d=128, k_shard=10, devices=4)
    rec.record("mesh_knn", 1_000_000, params=params)
    rec.record("mesh_knn[x4]", 1_000_000, params=params, cards=4)
    peaks = roofline.stub_peaks()
    one, four = (rec._family_row(name, rec._families[name], peaks)
                 for name in ("mesh_knn", "mesh_knn[x4]"))
    # the byte count is the reference's cost model, whatever the cards
    flops, nbytes = roofline.COST_MODELS["mesh_knn"](params)
    assert one["bytes"] == four["bytes"] == nbytes
    assert one["flops"] == four["flops"] == flops
    assert "cards" not in one and four["cards"] == 4
    assert four["roofline_gflops"] == pytest.approx(
        4 * one["roofline_gflops"], rel=1e-5)
    assert four["roofline_fraction"] <= one["roofline_fraction"]
    # the reference's all-gather term counts the mesh's devices (slots)
    more = roofline.COST_MODELS["mesh_knn"]({**params, "devices": 8})[1]
    assert more - nbytes == roofline._IDX * 4 * 4 * 10


def test_ledger_reads_bytes_by_device():
    before = default_ledger.resident_bytes("cpu:7")
    a = default_ledger.register(KIND_MESH_BUNDLE, 100, index="ix",
                                device="cpu:7")
    b = default_ledger.register(KIND_MESH_BUNDLE, 40, index="ix",
                                device="cpu:6")
    try:
        assert default_ledger.resident_bytes("cpu:7") == before + 100
        assert default_ledger.resident_bytes(torch.device("cpu:6")) >= 40
        assert default_ledger.device_totals()["cpu:7"] == before + 100
    finally:
        a.free()
        b.free()
    assert default_ledger.resident_bytes("cpu:7") == before


def test_registry_frees_every_slot_on_eviction(tmp_path):
    backend.set_serving_devices(CPU8)
    (port,) = _nodes(tmp_path, 4, "l2", seed=3, ref=False)
    try:
        _launch(distributed_serving, query_dsl, port, _queries(1), False)
        allocs = _mesh_bundle_allocs()
        assert len(allocs) == 4 and not any(a.freed for a in allocs)
        # a refresh's new generation supersedes the bundle
        port.index_doc("vecs", "new", {"v": [0.0] * DIMS, "tag": "a"})
        port.refresh("vecs")
        _launch(distributed_serving, query_dsl, port, _queries(2), False)
        assert all(a.freed and a.freed_reason == "superseded"
                   for a in allocs)
        live = _mesh_bundle_allocs()
        assert len(live) == 4
        port.delete_index("vecs")
        assert all(a.freed for a in live)
        assert not _mesh_bundle_allocs()
        assert distributed_serving.registry.resident_bytes() == 0
    finally:
        port.close()


def test_close_frees_every_slot(tmp_path):
    backend.set_serving_devices(CPU8)
    (port,) = _nodes(tmp_path, 8, "l2", seed=4, ref=False)
    _launch(distributed_serving, query_dsl, port, _queries(3), True)
    allocs = _mesh_bundle_allocs()
    assert len(allocs) == 8
    port.close()
    assert all(a.freed for a in allocs)
    assert not _mesh_bundle_allocs()


def test_dryrun_over_eight_slots(capsys):
    """graft_entry.dryrun_multichip(8) over serving devices ["cpu"] * 8:
    its 4-shard search runs on 4 slots, and the program on a 4 x 2 mesh
    of slots; both OK lines."""
    from opensearch_tpu_torch import graft_entry

    backend.set_serving_devices(CPU8)
    before = distributed_serving.stats["distributed_searches"]
    graft_entry.dryrun_multichip(8, device="cpu")
    assert capsys.readouterr().out.splitlines() == [
        "serving path OK: 4-shard knn _search merged on-device over 4 "
        "devices (cpu)",
        "dryrun_multichip OK: mesh data=4 x model=2, top-5 scores for 2 "
        "queries over 512 docs",
    ]
    assert distributed_serving.stats["distributed_searches"] == before + 1


KERNEL_WRAPPERS = ("knn_fused", "adc_scan", "adc_lut", "knn_rescore",
                   "knn_blocks")


@pytest.mark.parametrize("module", KERNEL_WRAPPERS)
def test_every_ctypes_launch_runs_under_its_tensors_device(module):
    """Each call of a C launcher (``lib.<name>_launch(...)``, or a local
    ``launch(...)`` bound to one) sits inside ``with
    torch.cuda.device(...)``: the launchers set their shared-memory
    attribute and launch on the current card, which must be the one the
    tensors live on."""
    import ast
    import pathlib

    import opensearch_tpu_torch

    path = (pathlib.Path(opensearch_tpu_torch.__file__).parent / "ops"
            / f"{module}.py")
    tree = ast.parse(path.read_text())
    # the module's own Python functions are not C launchers
    defs = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}

    def is_launch(call: ast.Call) -> bool:
        f = call.func
        if isinstance(f, ast.Name) and f.id in defs:
            return False
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else "")
        return name == "launch" or (name.endswith("_launch")
                                    and not name.startswith("launch_"))

    def guarded(node, stack) -> bool:
        return any(isinstance(w, ast.With) and any(
            ast.unparse(item.context_expr).startswith("torch.cuda.device(")
            for item in w.items) for w in stack)

    found, bare = 0, []

    def walk(node, stack):
        nonlocal found
        if isinstance(node, ast.Call) and is_launch(node):
            found += 1
            if not guarded(node, stack):
                bare.append(node.lineno)
        for child in ast.iter_child_nodes(node):
            walk(child, stack + [node])

    walk(tree, [])
    assert found > 0
    assert not bare, f"ops/{module}.py: unguarded launches at {bare}"
