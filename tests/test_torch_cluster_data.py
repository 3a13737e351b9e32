"""The cluster's data plane over the deterministic sim: ClusterNode of the
port against the reference's.

Every case of tests/test_cluster_data.py runs twice on one seed: as the
reference wrote it, and as the port's copy (:func:`port_module`: the same
source with each ``opensearch_tpu`` import rewritten to
``opensearch_tpu_torch`` and every ``ClusterNode(...)`` given
``device="cpu"``). Both runs must pass the reference's own assertions, and
the two runs' observations must be equal (:class:`Recorder`):

- after each ``run_until`` / ``run_all`` of the sim's queue, every
  coordinator's mode, leader, term, applied version and committed voting
  configuration, and every node's routing table (index, shard, node,
  primary, state) and recovery records' stages;
- every message the sim's transport carries (sender, target, action), in
  order, and the count of node searches that fell back to the per-shard
  route;
- every response a ClusterNode client call (``create_index``,
  ``index_doc``, ``bulk``, ``get_doc``, ``delete_doc``, ``refresh``,
  ``search``, ...) hands its callback, ``took`` and a profile's timings,
  rates and retrace flag left out (:func:`volatile`; a profile's numbers
  are compared by type): the hits' ids
  equal, scores to rtol 1e-6 (:func:`assert_same`).

Each node's disk-usage reading is pinned to 50% (``disk_usage_pct``, the
reference's hook for its fs probe) unless a case sets its own, so the
disk-threshold decider reads the same number in both runs whatever the
host's disk holds. Each run starts with no kernel signature seen
(``search/profile._seen_kernel_signatures``), so a profile's
``jit_retrace`` is the case's own, whatever ran before in the process.
The reference runs with the port's one change to its coordinator
(:func:`publication_fix`).

Then the slice's own kNN case: 3 shards, 1 replica, d = 16, 600 docs; a
bare ``knn`` through each node as coordinator, again after ``isolate`` of
a primary's node and the replica's promotion, after ``heal`` and peer
recovery, and after ``cluster.routing.allocation.exclude._name`` drains a
node; and ``ClusterSnapshotsService``'s restore of the index. The port's
hits are the reference's: ids equal, l2 scores to rtol 1e-5 / atol 1e-4,
the tolerance tests/test_torch_node_knn.py states (the frameworks sum the
d products in other orders).
"""

from __future__ import annotations

import ast
import contextlib
import importlib
import inspect
import math
import sys
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

TESTS = Path(__file__).resolve().parent
PORT_PREFIX = "torch_port_"
DISK_PCT = 50.0


def volatile(key) -> bool:
    """Keys read off a wall clock: ``took``, and a profile's timings
    (``*_nanos``, ``*_ns``, ``breakdown``); and a profile's ``retraced``,
    which says whether this process compiled the launch before."""
    return isinstance(key, str) and (
        key == "took" or key.endswith("_nanos") or key.endswith("_ns")
        or key in ("breakdown", "retraced"))


# -- the port's copy of a reference test module ------------------------------


# the port's entry points a reference test calls, each given
# ``device="cpu"`` in the port's copy
ON_THE_CPU = ("ClusterNode", "ClusterServer", "TcpSoak", "run_soak",
              "run_suites")


class _ToPort(ast.NodeTransformer):
    """Reference imports to the port's; the calls of :data:`ON_THE_CPU`
    on the CPU."""

    @staticmethod
    def _module(name: str) -> str:
        if name == "opensearch_tpu" or name.startswith("opensearch_tpu."):
            return "opensearch_tpu_torch" + name[len("opensearch_tpu"):]
        if name.startswith("tests.test_"):
            base = name.split(".", 1)[1]
            port_module(base)
            return PORT_PREFIX + base
        return name

    def visit_ImportFrom(self, node):
        if node.module:
            node.module = self._module(node.module)
        return node

    def visit_Import(self, node):
        for alias in node.names:
            alias.name = self._module(alias.name)
        return node

    def visit_Call(self, node):
        self.generic_visit(node)
        f = node.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None)
        if name in ON_THE_CPU and not any(
                k.arg == "device" for k in node.keywords):
            node.keywords.append(
                ast.keyword(arg="device", value=ast.Constant("cpu")))
        return node


def port_module(name: str) -> types.ModuleType:
    """tests/<name>.py with the port in place of the reference."""
    mod_name = PORT_PREFIX + name
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    path = TESTS / f"{name}.py"
    tree = _ToPort().visit(ast.parse(path.read_text(), str(path)))
    ast.fix_missing_locations(tree)
    mod = types.ModuleType(mod_name)
    mod.__file__ = str(path)
    sys.modules[mod_name] = mod
    exec(compile(tree, str(path), "exec"), mod.__dict__)
    return mod


# -- cases and a small fixture resolver --------------------------------------


def _param_sets(fn) -> list[dict]:
    sets = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names = [n.strip() for n in mark.args[0].split(",")]
        values = list(mark.args[1])
        out = []
        for s in sets:
            for v in values:
                vals = v if len(names) > 1 else (v,)
                out.append({**s, **dict(zip(names, vals))})
        sets = out
    return sets


def cases(mod: types.ModuleType, skip: tuple[str, ...] = ()) -> list:
    """pytest params of every case of a reference module, ids as pytest's."""
    out = []
    for name, obj in vars(mod).items():
        if name.startswith("test_") and inspect.isfunction(obj):
            targets = [(None, name, obj)]
        elif name.startswith("Test") and inspect.isclass(obj):
            targets = [(name, m, f) for m, f in vars(obj).items()
                       if m.startswith("test_") and inspect.isfunction(f)]
        else:
            continue
        for cls, fname, fn in targets:
            if fname in skip:
                continue
            for params in _param_sets(fn):
                pid = "-".join(str(v) for v in params.values())
                label = (f"{cls}::" if cls else "") + fname + (
                    f"[{pid}]" if pid else "")
                out.append(pytest.param((cls, fname, params), id=label))
    return out


def _raw(fixture):
    return getattr(fixture, "_fixture_function", fixture)


def run_case(mod: types.ModuleType, case, tmp_path: Path) -> None:
    """Run one case of ``mod`` with its fixtures, as pytest would."""
    cls_name, fname, params = case
    finalizers = []
    mp = pytest.MonkeyPatch()
    finalizers.append(mp.undo)
    values: dict = {}

    def call_fixture(fn, owner=None):
        raw = _raw(fn)
        args = [resolve(a) for a in inspect.signature(raw).parameters
                if a != "self"]
        out = raw(owner, *args) if owner is not None else raw(*args)
        if inspect.isgenerator(out):
            gen = out
            out = next(gen)
            finalizers.append(lambda: next(gen, None))
        return out

    def resolve(arg):
        if arg in values:
            return values[arg]
        if arg in params:
            v = params[arg]
        elif arg == "tmp_path":
            v = tmp_path
        elif arg == "monkeypatch":
            v = mp
        else:
            v = call_fixture(getattr(mod, arg))
        values[arg] = v
        return v

    try:
        if cls_name is None:
            fn = getattr(mod, fname)
            fn(**{a: resolve(a) for a in inspect.signature(fn).parameters})
        else:
            cls = getattr(mod, cls_name)
            inst = cls()
            for attr in vars(cls).values():
                marker = getattr(attr, "_fixture_function_marker", None)
                if marker is not None and marker.autouse:
                    call_fixture(attr, owner=inst)
            fn = getattr(inst, fname)
            fn(**{a: resolve(a) for a in inspect.signature(fn).parameters})
    finally:
        for fin in reversed(finalizers):
            fin()


# -- the port's one departure from the reference's coordinator ---------------


def publication_fix(mp: pytest.MonkeyPatch) -> None:
    """The reference's ``Coordinator._become_leader`` with the port's one
    change (opensearch_tpu_torch/cluster/coordinator.py): a node that wins
    a later term drops the publication it began in an earlier one. The
    reference keeps that publication's flag set, so the new term's first
    publication waits for the old one's 30 s timeout (over TCP: about one
    leader kill in two on the card). The parity suites hold the port to
    the reference with that change, step for step."""
    coord = importlib.import_module("opensearch_tpu.cluster.coordinator")
    become = coord.Coordinator._become_leader

    def become_leader(c, __become=become):
        if not c._stopped:
            c._publishing = False
        return __become(c)

    mp.setattr(coord.Coordinator, "_become_leader", become_leader)


# -- what the two runs must agree on ------------------------------------------


class Recorder:
    """Observations of one package's run (see the module docstring)."""

    def __init__(self, package: str):
        self.package = package
        self.steps: list = []
        self.responses: list = []
        self.sends: list = []
        self.fallbacks = 0
        self._owners: dict[int, object] = {}
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        p = self.package
        sim = importlib.import_module(f"{p}.testing.sim")
        coord = importlib.import_module(f"{p}.cluster.coordinator")
        cnode = importlib.import_module(f"{p}.cluster.cluster_node")
        self._coordinator = coord.Coordinator
        self._cluster_node = cnode.ClusterNode
        mp = pytest.MonkeyPatch()
        self._stack.callback(mp.undo)
        if p == "opensearch_tpu":
            publication_fix(mp)
        rec = self

        queue = sim.DeterministicTaskQueue
        for meth in ("run_until", "run_all"):
            orig = getattr(queue, meth)

            def stepped(q, *a, __orig=orig, **kw):
                out = __orig(q, *a, **kw)
                rec.steps.append((q.now_ms, rec.snapshot()))
                return out

            mp.setattr(queue, meth, stepped)
        reg = sim.MockTransport.register

        def register(t, node_id, action, handler):
            owner = getattr(handler, "__self__", None)
            if owner is not None:
                rec._owners[id(owner)] = owner
            return reg(t, node_id, action, handler)

        mp.setattr(sim.MockTransport, "register", register)
        send = sim.MockTransport.send

        def sending(t, sender, target, action, *a, **kw):
            rec.sends.append((sender, target, action))
            return send(t, sender, target, action, *a, **kw)

        mp.setattr(sim.MockTransport, "send", sending)
        fallback = cnode.ClusterNode._per_shard_fallback

        def counted_fallback(*a, **kw):
            rec.fallbacks += 1
            return fallback(*a, **kw)

        mp.setattr(cnode.ClusterNode, "_per_shard_fallback", counted_fallback)
        init = cnode.ClusterNode.__init__

        def pinned_init(node, *a, **kw):
            init(node, *a, **kw)
            node.disk_usage_pct = DISK_PCT

        mp.setattr(cnode.ClusterNode, "__init__", pinned_init)
        # a profile's jit_retrace says whether this process launched the
        # signature before: each run starts from none, so the flag is the
        # case's own and not the worker's history
        profile = importlib.import_module(f"{p}.search.profile")
        mp.setattr(profile, "_seen_kernel_signatures", set())
        for name, fn in inspect.getmembers(cnode.ClusterNode,
                                           inspect.isfunction):
            if name.startswith("_"):
                continue
            sig = inspect.signature(fn)
            if "callback" not in sig.parameters:
                continue
            mp.setattr(cnode.ClusterNode, name, self._recording(name, fn, sig))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        # a case may leave its nodes open; close them, so their stacked
        # bundles leave the process-wide registry before the next test
        for owner in self._owners.values():
            if isinstance(owner, self._cluster_node) and \
                    not getattr(owner, "_closed", False):
                owner.close()
        return False

    def _recording(self, name, fn, sig):
        rec = self

        def wrapped(*a, **kw):
            bound = sig.bind(*a, **kw)
            cb = bound.arguments["callback"]
            node = bound.arguments["self"]

            def on_response(resp, __cb=cb):
                rec.responses.append((node.node_id, name, resp))
                return __cb(resp)

            bound.arguments["callback"] = on_response
            return fn(*bound.args, **bound.kwargs)

        return wrapped

    def snapshot(self) -> list:
        out = []
        for owner in self._owners.values():
            if isinstance(owner, self._coordinator):
                st = owner.applied_state
                out.append(("coordinator", owner.node_id, owner.mode.name,
                            owner.leader_id, owner.coord.current_term,
                            st.term, st.version,
                            tuple(sorted(st.last_committed_config.node_ids))))
            elif isinstance(owner, self._cluster_node):
                st = owner.coordinator.applied_state
                routing = tuple(sorted(
                    (r.index, r.shard, r.node_id or "", r.primary, r.state)
                    for r in st.routing))
                stages = tuple(sorted(
                    (k[0], k[1], getattr(v, "stage", None))
                    for k, v in owner.recoveries.items()))
                out.append(("node", owner.node_id, routing, stages))
        return sorted(out, key=repr)


def assert_same(ref, port, path="$", rtol=1e-6, atol=0.0):
    """Equal structures; floats to the tolerance; volatile keys left out."""
    if isinstance(ref, dict):
        assert isinstance(port, dict), (path, ref, port)
        rk = {k for k in ref if not volatile(k)}
        pk = {k for k in port if not volatile(k)}
        assert rk == pk, (path, sorted(rk ^ pk))
        for k in sorted(rk, key=str):
            assert_same(ref[k], port[k], f"{path}.{k}", rtol, atol)
    elif isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)), (path, ref, port)
        assert len(ref) == len(port), (path, len(ref), len(port))
        for i, (a, b) in enumerate(zip(ref, port)):
            assert_same(a, b, f"{path}[{i}]", rtol, atol)
    elif ".profile" in path and isinstance(ref, (int, float)) \
            and not isinstance(ref, bool):
        # a profile's numbers are timings and rates read off the clock
        assert isinstance(port, (int, float)), (path, ref, port)
    elif isinstance(ref, float) and not isinstance(ref, bool):
        assert isinstance(port, (int, float)), (path, ref, port)
        if math.isnan(ref):
            assert math.isnan(port), (path, ref, port)
        else:
            assert math.isclose(ref, port, rel_tol=rtol, abs_tol=atol), (
                path, ref, port)
    elif isinstance(ref, Exception):
        assert type(ref).__name__ == type(port).__name__, (path, ref, port)
        assert str(ref) == str(port), (path, ref, port)
    else:
        assert ref == port, (path, ref, port)


def run_both(name: str, case, tmp_path: Path) -> tuple[Recorder, Recorder]:
    """The case on the reference, then on the port; both must pass, and
    their observations must agree."""
    ref_mod, port_mod = importlib.import_module(name), port_module(name)
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    with Recorder("opensearch_tpu") as ref:
        run_case(ref_mod, case, tmp_path / "ref")
    with Recorder("opensearch_tpu_torch") as port:
        run_case(port_mod, case, tmp_path / "port")
    assert len(ref.steps) == len(port.steps)
    for (t_ref, s_ref), (t_port, s_port) in zip(ref.steps, port.steps):
        assert t_ref == t_port
        assert s_ref == s_port, (t_ref, s_ref, s_port)
    assert_same(ref.responses, port.responses, "$responses")
    assert ref.sends == port.sends
    assert ref.fallbacks == port.fallbacks
    return ref, port


REFERENCE = "test_cluster_data"


@pytest.mark.parametrize("case", cases(importlib.import_module(REFERENCE)))
def test_reference_case(case, tmp_path):
    run_both(REFERENCE, case, tmp_path)


# -- the slice's kNN case -----------------------------------------------------

KNN_DIM, KNN_DOCS, KNN_K = 16, 600, 10
KNN_RTOL, KNN_ATOL = 1e-5, 1e-4


def _knn_data(seed=24):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((KNN_DOCS, KNN_DIM)).astype(np.float32)
    queries = rng.standard_normal((4, KNN_DIM)).astype(np.float32)
    return vecs, queries


def _brute_ids(vecs, q, k):
    d = ((vecs.astype(np.float64) - q.astype(np.float64)) ** 2).sum(1)
    return [str(i) for i in np.argsort(d, kind="stable")[:k]]


def _put_transient(sim, transient):
    leader = sim.leader()
    out = []
    sim.transport.send(
        leader.node_id, leader.node_id, "cluster:admin/settings/update",
        {"transient": transient}, on_response=out.append,
        on_failure=lambda e: out.append({"error": str(e)}))
    for _ in range(500):
        if out:
            break
        sim.queue.run_one()
    assert out and "error" not in out[0], out


def _started(sim, leader, index):
    return all(r.state == "STARTED" and r.node_id is not None
               for r in leader.applied_state.shards_for_index(index))


def knn_scenario(mod, tmp_path: Path, restore_keeps_mappings: bool) -> list:
    """The bare kNN through a 3-node sim of one package (see the module
    docstring); returns each search's [(id, score)], and checks each
    against the numpy brute force's ids on the way. The reference's
    cluster restore creates the index under dynamic mappings alone, so
    its restored ``v`` is no knn_vector and the kNN finds nothing there;
    the port's keeps the snapshot's mappings."""
    vecs, queries = _knn_data()
    sim = mod.DataSim(3, seed=24, tmp_path=tmp_path)
    out = []

    def knn_all(via, index="vecs", label="", expect_hits=True):
        for qi, q in enumerate(queries):
            resp = sim.call(sim.nodes[via].search, index, {
                "query": {"knn": {"v": {"vector": q.tolist(),
                                        "k": KNN_K}}},
                "size": KNN_K})
            hits = [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]
            want = _brute_ids(vecs, q, KNN_K) if expect_hits else []
            assert [i for i, _ in hits] == want, (label, via, qi)
            out.append((label, via, qi, resp["_shards"]["failed"], hits))

    try:
        sim.run(5_000)
        resp = sim.call(sim.nodes["n0"].create_index, "vecs", {
            "settings": {"index": {"number_of_shards": 3,
                                   "number_of_replicas": 1}},
            "mappings": {"properties": {"v": {
                "type": "knn_vector", "dimension": KNN_DIM}}}})
        assert resp.get("acknowledged"), resp
        sim.run(5_000)
        ops = [("index", {"_index": "vecs", "_id": str(i)},
                {"v": vecs[i].tolist()}) for i in range(KNN_DOCS)]
        for lo in range(0, KNN_DOCS, 200):
            resp = sim.call(sim.nodes["n0"].bulk, ops[lo:lo + 200])
            assert not resp["errors"], resp
        sim.call(sim.nodes["n0"].refresh, "vecs")
        sim.run(1_000)
        assert _started(sim, sim.leader(), "vecs")
        for via in sim.node_ids:
            knn_all(via, label="green")

        # the node holding shard 0's primary leaves; its replica is promoted
        leader = sim.leader()
        lost = leader.applied_state.primary("vecs", 0).node_id
        others = set(sim.node_ids) - {lost}
        sim.transport.isolate(lost, others)
        sim.run(20_000)
        live = [n for nid, n in sim.nodes.items()
                if nid in others and n.is_leader]
        assert len(live) == 1
        promoted = live[0].applied_state.primary("vecs", 0)
        assert promoted.node_id in others and promoted.state == "STARTED"
        for via in sorted(others):
            knn_all(via, label="promoted")

        # heal: the node rejoins and its copies recover from the primaries
        sim.transport.heal()
        sim.run(30_000)
        assert _started(sim, sim.leader(), "vecs")
        assert len(sim.leader().applied_state.shards_for_index("vecs")) == 6
        sim.call(sim.nodes["n0"].refresh, "vecs")
        sim.run(1_000)
        for via in sim.node_ids:
            knn_all(via, label="healed")

        # drain n1 by allocation filter
        _put_transient(sim, {"cluster.routing.allocation.exclude._name":
                             "n1"})
        sim.run(30_000)
        leader = sim.leader()
        assert _started(sim, leader, "vecs")
        assert not [r for r in leader.applied_state.shards_for_index("vecs")
                    if r.node_id == "n1"]
        assert not [k for k in sim.nodes["n1"].local_shards
                    if k[0] == "vecs"]
        for via in sim.node_ids:
            knn_all(via, label="drained")

        # snapshot the index and restore it under another name
        svc_mod = importlib.import_module(
            mod.ClusterNode.__module__.split(".")[0] + ".snapshots.service")
        svc = svc_mod.ClusterSnapshotsService(sim.nodes["n0"],
                                              tmp_path / "snaprepo")
        resp = sim.call(svc.create, "snap1", "vecs")
        assert resp.get("state") == "SUCCESS", resp
        resp = sim.call(svc.restore, "snap1", "vecs-restored")
        assert resp.get("state") == "SUCCESS", resp
        assert resp["docs"] == KNN_DOCS, resp
        sim.run(2_000)
        sim.call(sim.nodes["n2"].refresh, "vecs-restored")
        sim.run(1_000)
        knn_all("n2", index="vecs-restored", label="restored",
                expect_hits=restore_keeps_mappings)
    finally:
        for n in sim.nodes.values():
            n.close()
    return out


def test_knn_through_node_loss_recovery_drain_and_restore(tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    with Recorder("opensearch_tpu") as ref:
        ref_hits = knn_scenario(importlib.import_module(REFERENCE), tmp_path / "ref",
                                restore_keeps_mappings=False)
    with Recorder("opensearch_tpu_torch") as port:
        port_hits = knn_scenario(port_module(REFERENCE), tmp_path / "port",
                                 restore_keeps_mappings=True)
    assert [s for _, s in ref.steps] == [s for _, s in port.steps]
    assert ref.sends == port.sends
    # every node answered its search[node] RPC: no search degraded to the
    # per-shard fallback
    assert ref.fallbacks == port.fallbacks == 0
    assert len(ref_hits) == len(port_hits) == 4 * (3 + 2 + 3 + 3 + 1)
    green = {qi: hits for label, via, qi, _f, hits in port_hits
             if label == "green" and via == "n2"}
    for a, b in zip(ref_hits, port_hits):
        assert a[:4] == b[:4], (a[:4], b[:4])
        want = green[b[2]] if a[0] == "restored" else a[4]
        assert [i for i, _ in b[4]] == [i for i, _ in want], (a, b)
        np.testing.assert_allclose([s for _, s in b[4]], [s for _, s in want],
                                   rtol=KNN_RTOL, atol=KNN_ATOL)


def test_cluster_node_runs_on_the_card_unless_asked(tmp_path):
    """``ClusterNode`` takes the card by default and raises without one;
    ``device="cpu"`` reaches every shard it opens."""
    import torch

    from opensearch_tpu_torch.cluster.cluster_node import ClusterNode
    from opensearch_tpu_torch.testing.sim import (DeterministicTaskQueue,
                                                  MockTransport)

    queue = DeterministicTaskQueue(1)
    transport = MockTransport(queue)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            ClusterNode("n0", tmp_path / "card", transport, queue, ["n0"])
    node = ClusterNode("n1", tmp_path / "cpu", transport, queue, ["n1"],
                       device="cpu")
    try:
        node.disk_usage_pct = DISK_PCT
        node.bootstrap(["n1"])
        node.start()
        queue.run_until(queue.now_ms + 5_000)
        out = []
        node.create_index("v", {"settings": {"index": {
            "number_of_shards": 2, "number_of_replicas": 0}}},
            callback=out.append)
        queue.run_until(queue.now_ms + 5_000)
        assert out and out[0].get("acknowledged"), out
        assert node.device == torch.device("cpu")
        assert len(node.local_shards) == 2
        for shard in node.local_shards.values():
            assert shard.engine.device == torch.device("cpu")
    finally:
        node.close()


def test_closed_cluster_node_leaves_no_bundle(tmp_path):
    """A node's kNN builds its stacked bundle in the process-wide
    registry; closing the node drops it, and only it."""
    from opensearch_tpu_torch.cluster.shard_mesh import default_registry

    mod = port_module(REFERENCE)
    sim = mod.DataSim(3, seed=5, tmp_path=tmp_path)
    try:
        for node in sim.nodes.values():
            node.disk_usage_pct = DISK_PCT
        sim.run(5_000)
        sim.call(sim.nodes["n0"].create_index, "v", {
            "settings": {"index": {"number_of_shards": 3,
                                   "number_of_replicas": 0}},
            "mappings": {"properties": {"v": {"type": "knn_vector",
                                              "dimension": 2}}}})
        sim.run(5_000)
        sim.call(sim.nodes["n0"].bulk, [
            ("index", {"_index": "v", "_id": str(i)}, {"v": [i, 1.0]})
            for i in range(30)])
        sim.call(sim.nodes["n0"].refresh, "v")
        resp = sim.call(sim.nodes["n1"].search, "v", {"query": {"knn": {
            "v": {"vector": [3.0, 1.0], "k": 3}}}, "size": 3})
        assert {h["_id"] for h in resp["hits"]["hits"]} == {"3", "2", "4"}

        def holding(node):
            engines = {sh.engine.instance_id
                       for sh in node.local_shards.values()}
            with default_registry._lock:
                return [k for k in default_registry._bundles
                        if engines & set(k[3])]

        built = {nid: holding(n) for nid, n in sim.nodes.items()}
        assert sum(map(len, built.values())) == 3   # one a node
        sim.nodes["n2"].close()
        assert holding(sim.nodes["n2"]) == []
        assert holding(sim.nodes["n0"]) == built["n0"]
    finally:
        for node in sim.nodes.values():
            if not getattr(node, "_closed", False):
                node.close()
