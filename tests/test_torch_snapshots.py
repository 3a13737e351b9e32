"""Snapshots and repositories: TorchNode against TpuNode.

The cases of tests/test_snapshots.py run on a TpuNode and a
TorchNode(device="cpu") through :class:`test_torch_scroll_pit.Pair`: each
scenario's observations (results, or an error's class, status and
message) must be equal, with `took`, uuids and the snapshot clocks
(`*_time_in_millis`, `duration_in_millis`, `time_in_millis`) left out, and
each repository at its own location. Tolerances: 0 for ids, statuses,
counts and blob counts; rtol 1e-5 / atol 1e-4 for l2 scores, the
tolerance tests/test_torch_node_knn.py states (the frameworks sum the d
products in other orders). Then the slice's own cases, data made from a
numpy seed: a `knn_vector` index restored under a rename, a restore after
`DELETE` and a restore over a closed index (each kNN the reference's, and
the port's restored hits its live ones bit for bit), `_cat/snapshots` and
`_cat/repositories`, and the snapshot REST handlers.

The port alone: a restore over a closed index retires every device column
of the replaced shards in the residency ledger and releases the replaced
index's stacked bundle, so after the restored index's first kNN the
ledger holds what it held before the restore (a closed index keeps both
in the port, and the restored engines' ids never evict the old bundle).
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from opensearch_tpu.node import TpuNode
from opensearch_tpu.rest import handlers as ref_handlers
from opensearch_tpu_torch.node import TorchNode
from opensearch_tpu_torch.ops import knn_fused
from opensearch_tpu_torch.rest import handlers as port_handlers
from opensearch_tpu_torch.search import distributed_serving
from opensearch_tpu_torch.telemetry.device_ledger import default_ledger

from test_torch_scroll_pit import Pair, observe

DIM = 8
CLOCKS = {"start_time_in_millis", "end_time_in_millis", "duration_in_millis",
          "time_in_millis"}


def no_clocks(obj):
    """A snapshot response less its wall clocks."""
    if isinstance(obj, dict):
        return {k: no_clocks(v) for k, v in obj.items() if k not in CLOCKS}
    if isinstance(obj, (list, tuple)):
        return type(obj)(no_clocks(v) for v in obj)
    return obj


def _books(node, repo_dir) -> None:
    """tests/test_snapshots.py's fixture."""
    node.create_index("books", {"settings": {"number_of_shards": 2},
                                "mappings": {"properties": {
                                    "title": {"type": "text"},
                                    "year": {"type": "long"}}}})
    for i, (title, year) in enumerate([
        ("the old man and the sea", 1952),
        ("brave new world", 1932),
        ("dune", 1965),
    ]):
        node.index_doc("books", str(i + 1), {"title": title, "year": year})
    node.refresh("books")
    node.snapshots.put_repository("backup", {
        "type": "fs", "settings": {"location": str(repo_dir)}})


class Both:
    """A Pair whose scenarios also take the node's own scratch directory
    (each package keeps its repositories apart)."""

    def __init__(self, tmp_path, pair: Pair):
        self.tmp = tmp_path
        self.pair = pair

    def dir(self, node, name: str):
        side = "ref" if node is self.pair.ref else "port"
        return self.tmp / name / side

    def flow(self, scenario) -> list:
        return self.pair.flow(lambda n: no_clocks(scenario(n)))


@pytest.fixture()
def both(tmp_path):
    p = Pair(tmp_path)
    b = Both(tmp_path, p)
    for n in p.nodes:
        _books(n, b.dir(n, "repo"))
    yield b
    p.close()


# ---------------------------------------------------------------------------
# tests/test_snapshots.py
# ---------------------------------------------------------------------------


def test_repository_crud(both):
    def scenario(node):
        out = ["backup" in node.snapshots.get_repository(None)]
        out.append(observe(lambda: node.snapshots.put_repository(
            "bad", {"type": "s3", "settings": {}})))
        out.append(observe(lambda: node.snapshots.put_repository(
            "bad", {"type": "fs", "settings": {}})))
        out.append(node.snapshots.put_repository("other", {
            "type": "fs",
            "settings": {"location": str(both.dir(node, "repo2"))}}))
        out.append(node.snapshots.delete_repository("other"))
        out.append(observe(lambda: node.snapshots.get_repository("other")))
        return out

    out = both.flow(scenario)
    assert out[0] is True and out[1][:3] == ("error",
                                             "IllegalArgumentException", 400)
    assert out[5][:3] == ("error", "ResourceNotFoundException", 404)


def test_snapshot_create_get_status(both):
    def scenario(node):
        out = [node.snapshots.create_snapshot("backup", "snap1")]
        assert out[0]["snapshot"]["state"] == "SUCCESS"
        assert out[0]["snapshot"]["indices"] == ["books"]
        out.append(node.snapshots.get_snapshot("backup", "snap1"))
        status = node.snapshots.snapshot_status("backup", "snap1")
        shards = status["snapshots"][0]["indices"]["books"]["shards"]
        assert len(shards) == 2
        assert all(s["stage"] == "DONE" for s in shards.values())
        out.append(status)
        out.append(observe(lambda: node.snapshots.create_snapshot(
            "backup", "snap1")))
        return out

    out = both.flow(scenario)
    assert out[3][:3] == ("error", "ResourceAlreadyExistsException", 400)


def test_restore_roundtrip(both):
    def scenario(node):
        node.snapshots.create_snapshot("backup", "snap1")
        # mutate after the snapshot: restore must NOT see this doc
        node.index_doc("books", "4", {"title": "later book", "year": 2020})
        node.refresh("books")
        out = [node.snapshots.restore_snapshot("backup", "snap1", {
            "indices": "books", "rename_pattern": "books",
            "rename_replacement": "books_restored"})]
        assert out[0]["snapshot"]["indices"] == ["books_restored"]
        resp = node.search("books_restored", {"query": {"match_all": {}}})
        assert resp["hits"]["total"]["value"] == 3  # not 4
        out.append(resp)
        resp = node.search("books_restored",
                           {"query": {"match": {"title": "dune"}}})
        assert resp["hits"]["hits"][0]["_id"] == "3"
        out.append(resp)
        # restoring over an existing index is rejected
        out.append(observe(lambda: node.snapshots.restore_snapshot(
            "backup", "snap1")))
        return out

    out = both.flow(scenario)
    assert out[3][:3] == ("error", "ResourceAlreadyExistsException", 400)


def test_restore_after_delete(both):
    def scenario(node):
        node.snapshots.create_snapshot("backup", "snap1")
        node.delete_index("books")
        out = [node.snapshots.restore_snapshot("backup", "snap1")]
        resp = node.search("books", {"query": {"match_all": {}}})
        assert resp["hits"]["total"]["value"] == 3
        return out + [resp]

    both.flow(scenario)


def test_incremental_dedup(both):
    def scenario(node):
        store = node.snapshots._store("backup")
        node.snapshots.create_snapshot("backup", "snap1")
        n1 = len(store.list_blobs())
        # identical second snapshot: no new blobs
        node.snapshots.create_snapshot("backup", "snap2")
        n2 = len(store.list_blobs())
        assert n2 == n1
        # new doc -> only the changed shard's files add blobs
        node.index_doc("books", "4", {"title": "new", "year": 2021})
        node.refresh("books")
        node.snapshots.create_snapshot("backup", "snap3")
        n3 = len(store.list_blobs())
        assert n3 > n1
        return [n1, n2, n3]

    both.flow(scenario)


def test_delete_snapshot_gc(both):
    def scenario(node):
        node.snapshots.create_snapshot("backup", "snap1")
        store = node.snapshots._store("backup")
        out = [len(store.list_blobs())]
        assert out[0] > 0
        out.append(node.snapshots.delete_snapshot("backup", "snap1"))
        assert node.snapshots.get_snapshot("backup")["snapshots"] == []
        assert store.list_blobs() == []  # all blobs unreferenced -> GC'd
        out.append(observe(lambda: node.snapshots.delete_snapshot(
            "backup", "snap1")))
        return out

    out = both.flow(scenario)
    assert out[2][:3] == ("error", "SnapshotMissingException", 404)


def test_snapshot_survives_node_restart(tmp_path):
    repo = {"ref": tmp_path / "repo-ref", "port": tmp_path / "repo-port"}
    made = {"ref": TpuNode(tmp_path / "ref"),
            "port": TorchNode(tmp_path / "port", device="cpu")}
    for side, node in made.items():
        _books(node, repo[side])
        node.snapshots.create_snapshot("backup", "snap1")
        node.delete_index("books")
        node.close()
    pair = Pair(tmp_path, TpuNode(tmp_path / "ref"),
                TorchNode(tmp_path / "port", device="cpu"))
    try:
        def scenario(node):
            # the repository registry persisted
            assert "backup" in node.snapshots.get_repository(None)
            out = [no_clocks(node.snapshots.restore_snapshot("backup",
                                                             "snap1"))]
            resp = node.search("books", {"query": {"match_all": {}}})
            assert resp["hits"]["total"]["value"] == 3
            return out + [resp]

        pair.flow(scenario)
    finally:
        pair.close()


# ---------------------------------------------------------------------------
# kNN over restored indices
# ---------------------------------------------------------------------------

VEC_MAPPING = {"properties": {
    "v": {"type": "knn_vector", "dimension": DIM, "space_type": "l2"},
    "tag": {"type": "keyword"}, "n": {"type": "long"}}}


def _vectors(n, seed=5):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, DIM)).astype(np.float32).round(3)


def _seed_vecs(node, name="vec-a", n_docs=60, shards=2, seed=5):
    node.create_index(name, {"settings": {"number_of_shards": shards},
                             "mappings": VEC_MAPPING})
    vecs = _vectors(n_docs, seed)
    node.bulk([("index", {"_index": name, "_id": f"d{i}"},
                {"v": vecs[i].tolist(), "tag": "ab"[i % 2], "n": i})
               for i in range(n_docs)], refresh=True)
    return vecs


def _knn(vec, k=5):
    return {"query": {"knn": {"v": {"vector": list(map(float, vec)),
                                    "k": k}}}, "size": k}


def _hits(resp):
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


@pytest.fixture()
def vec_both(tmp_path):
    p = Pair(tmp_path)
    b = Both(tmp_path, p)
    for n in p.nodes:
        _seed_vecs(n)
        n.snapshots.put_repository("backup", {
            "type": "fs", "settings": {"location": str(b.dir(n, "repo"))}})
    b.vecs = _vectors(60)
    yield b
    p.close()


def _queries(vecs, seed=9, n=6):
    rng = np.random.default_rng(seed)
    return vecs[rng.choice(len(vecs), n, replace=False)] + \
        0.05 * rng.standard_normal((n, DIM)).astype(np.float32)


def test_knn_index_restored_under_a_rename(vec_both):
    qs = _queries(vec_both.vecs)
    live = {}

    def scenario(node):
        before = [node.search("vec-a", _knn(q, k)) for q in qs
                  for k in (5, 20)]
        live[node is vec_both.pair.port] = before
        out = [node.snapshots.create_snapshot("backup", "s1")]
        out.append(node.snapshots.restore_snapshot("backup", "s1", {
            "indices": "vec-*", "rename_pattern": "vec-(.+)",
            "rename_replacement": "restored-$1"}))
        assert out[-1]["snapshot"]["indices"] == ["restored-a"]
        after = [node.search("restored-a", _knn(q, k)) for q in qs
                 for k in (5, 20)]
        assert node.indices["restored-a"].restored_from_snapshot == "s1"
        return out + before + after

    port = vec_both.flow(scenario)
    # the restored segment files are the live index's bytes: its kNN hits
    # are the live index's bit for bit
    n = 2 * len(qs)
    assert [_hits(r) for r in port[2 + n:]] == \
        [_hits(r) for r in live[True]]


def test_knn_restore_after_delete(vec_both):
    qs = _queries(vec_both.vecs)

    def scenario(node):
        before = [_hits(node.search("vec-a", _knn(q))) for q in qs]
        node.snapshots.create_snapshot("backup", "s1")
        node.delete_index("vec-a")
        out = [observe(lambda: node.search("vec-a", _knn(qs[0])))[:3]]
        out.append(node.snapshots.restore_snapshot("backup", "s1"))
        after = [_hits(node.search("vec-a", _knn(q))) for q in qs]
        assert after == before
        return out + after

    out = vec_both.flow(scenario)
    assert out[0] == ("error", "IndexNotFoundException", 404)


def test_knn_restore_over_a_closed_index(vec_both):
    qs = _queries(vec_both.vecs)

    def scenario(node):
        before = [_hits(node.search("vec-a", _knn(q))) for q in qs]
        node.snapshots.create_snapshot("backup", "s1")
        # written after the snapshot: the restore drops it
        node.index_doc("vec-a", "late", {"v": list(map(float, qs[0])),
                                         "n": -1}, refresh=True)
        node.close_index("vec-a")
        out = [observe(lambda: node.search("vec-a", _knn(qs[0])))[:3]]
        out.append(node.snapshots.restore_snapshot("backup", "s1"))
        after = [_hits(node.search("vec-a", _knn(q))) for q in qs]
        assert after == before
        out.append(node.count("vec-a"))
        return out + after

    out = vec_both.flow(scenario)
    assert out[0] == ("error", "IndexClosedException", 400)
    assert out[2]["count"] == 60


def test_restore_over_a_closed_index_leaves_nothing_of_it_resident(
        tmp_path, monkeypatch):
    """The replaced shards' device columns leave the ledger at the
    restore, and their stacked bundle with them: after the restored
    index's first kNN (one K1 launch on the stacked step), the ledger
    holds exactly what it held before the restore, one bundle of the
    index, and no column of the replaced engines."""
    node = TorchNode(tmp_path / "n", device="cpu")
    vecs = _seed_vecs(node)
    node.snapshots.put_repository("backup", {
        "type": "fs", "settings": {"location": str(tmp_path / "repo")}})
    calls = []
    scan = knn_fused.pool_scan
    monkeypatch.setattr(knn_fused, "pool_scan",
                        lambda *a, **k: calls.append(1) or scan(*a, **k))
    registry = distributed_serving.registry
    before = _hits(node.search("vec-a", _knn(vecs[4], 10)))
    node.snapshots.create_snapshot("backup", "s1")
    node.close_index("vec-a")
    old_engines = {sh.engine.instance_id
                   for sh in node.indices["vec-a"].shards.values()}
    resident = default_ledger.resident_bytes()
    bundle_bytes = registry.resident_bytes()
    assert bundle_bytes > 0
    node.snapshots.restore_snapshot("backup", "s1")
    # the replaced engines' columns and bundle left at the restore; the
    # restored shards' columns (the same bytes) took the columns' place
    assert default_ledger.resident_bytes() == resident - bundle_bytes
    assert not [a for a in default_ledger.live_allocations()
                if a.index == "vec-a" and a.kind == "bundle"]
    assert not [k for k in registry._bundles if k[0] == "vec-a"]
    calls.clear()
    after = _hits(node.search("vec-a", _knn(vecs[4], 10)))
    assert len(calls) == 1 and after == before
    assert default_ledger.resident_bytes() == resident
    keys = [k for k in registry._bundles if k[0] == "vec-a"]
    assert len(keys) == 1 and not set(keys[0][3]) & old_engines
    node.close()


def test_restored_index_reopens_after_a_restart(tmp_path):
    node = TorchNode(tmp_path / "n", device="cpu")
    vecs = _seed_vecs(node)
    node.snapshots.put_repository("backup", {
        "type": "fs", "settings": {"location": str(tmp_path / "repo")}})
    node.snapshots.create_snapshot("backup", "s1")
    node.snapshots.restore_snapshot("backup", "s1", {
        "rename_pattern": "vec-a", "rename_replacement": "copy"})
    want = _hits(node.search("copy", _knn(vecs[7])))
    node.close()
    node = TorchNode(tmp_path / "n", device="cpu")
    try:
        assert node.indices["copy"].restored_from_snapshot == "s1"
        assert _hits(node.search("copy", _knn(vecs[7]))) == want
    finally:
        node.close()


# ---------------------------------------------------------------------------
# _cat/snapshots, _cat/repositories and the REST handlers
# ---------------------------------------------------------------------------


def _handler(mod, node, name, params, query=None, body=None):
    return observe(lambda: getattr(mod, name)(node, params, query or {},
                                              body))


def no_locations(obj):
    """A repository listing less each package's own location."""
    if isinstance(obj, dict):
        return {k: ("<location>" if k == "location" else no_locations(v))
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(no_locations(v) for v in obj)
    return obj


def _both_handlers(both, name, params, query=None, body=None, norm=None):
    out = {}
    for node, mod in ((both.pair.ref, ref_handlers),
                      (both.pair.port, port_handlers)):
        got = no_locations(_handler(mod, node, name, params, query, body))
        out[node is both.pair.port] = norm(got) if norm else got
    both.pair.flow(lambda n: [out[n is both.pair.port]])
    return out[True]


CAT_COLS = "id,status,indices,successful_shards,failed_shards,total_shards"


def test_cat_snapshots_and_repositories(vec_both):
    for n in vec_both.pair.nodes:
        n.snapshots.put_repository("second", {
            "type": "fs",
            "settings": {"location": str(vec_both.dir(n, "repo2"))}})
        n.snapshots.create_snapshot("backup", "s1", {"indices": "vec-a"})
        n.snapshots.create_snapshot("backup", "s2")
    got = _both_handlers(vec_both, "cat_repositories", {}, {"v": "true"})
    assert got[1][1].split() == ["id", "type", "backup", "fs", "second",
                                 "fs"]
    _both_handlers(vec_both, "cat_repositories", {}, {"format": "json"})
    got = _both_handlers(vec_both, "cat_snapshots", {"repo": "backup"},
                         {"v": "true", "h": CAT_COLS})
    assert got[1][1].split()[6:] == ["s1", "SUCCESS", "1", "2", "0", "2",
                                  "s2", "SUCCESS", "1", "2", "0", "2"]
    _both_handlers(vec_both, "cat_snapshots", {}, {"v": "true"})
    _both_handlers(vec_both, "cat_snapshots", {}, {"help": "true"})
    _both_handlers(vec_both, "cat_snapshots", {"repo": "nope"}, {})
    # the JSON rows, less their clocks
    _both_handlers(vec_both, "cat_snapshots", {"repo": "backup"},
                   {"format": "json"}, norm=lambda o: (o[0], [
                       {k: v for k, v in row.items()
                        if k not in ("start_epoch", "start_time",
                                     "end_epoch", "end_time", "duration")}
                       for row in o[1][1]]))


def test_snapshot_handlers_are_the_references(vec_both):
    def h(name, params, query=None, body=None):
        return _both_handlers(vec_both, name, params, query, body,
                              norm=no_clocks)

    h("get_repositories", {})
    h("get_repository", {"repo": "backup"})
    h("get_repository", {"repo": "nope"})
    h("cleanup_repository", {"repo": "backup"})
    h("cleanup_repository", {"repo": "nope"})
    h("create_snapshot", {"repo": "backup", "snapshot": "s1"}, {},
      {"indices": "vec-a", "metadata": {"why": "test"}})
    h("create_snapshot", {"repo": "backup", "snapshot": "Bad"}, {}, None)
    h("create_snapshot", {"repo": "backup", "snapshot": "s2"}, {},
      {"indices": "nope,vec-a"})
    h("create_snapshot", {"repo": "backup", "snapshot": "s3"}, {},
      {"indices": "nope,vec-a", "ignore_unavailable": True})
    h("get_snapshot", {"repo": "backup", "snapshot": "_all"},
      {"verbose": "false"})
    h("get_snapshot", {"repo": "backup", "snapshot": "s*,zz"},
      {"ignore_unavailable": "true"})
    h("get_snapshot", {"repo": "backup", "snapshot": "zz"})
    h("snapshot_status", {"repo": "backup", "snapshot": "s1"})
    h("snapshot_status", {"repo": "backup", "snapshot": "zz"})
    h("snapshot_status", {"repo": "backup", "snapshot": "zz"},
      {"ignore_unavailable": "true"})
    h("restore_snapshot", {"repo": "backup", "snapshot": "s1"}, {},
      {"rename_pattern": "vec-(.+)", "rename_replacement": "r-$1"})
    h("restore_snapshot", {"repo": "backup", "snapshot": "s1"}, {}, None)
    h("restore_snapshot", {"repo": "backup", "snapshot": "zz"}, {}, None)
    h("delete_snapshot", {"repo": "backup", "snapshot": "s3"})
    h("delete_snapshot", {"repo": "backup", "snapshot": "s3"})
    h("put_repository", {"repo": "r2"}, {},
      {"type": "url", "settings": {"location": "x"}})
    h("delete_repository", {"repo": "nope"})
    h("delete_repository", {"repo": "backup"})
    vec_both.pair.flow(lambda n: [_hits(n.search("r-a", _knn(
        vec_both.vecs[3], 8)))])
