"""The port stands alone: no JAX, no opensearch_tpu, no quiet CPU runs,
and a clear error for what is not ported yet."""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from opensearch_tpu_torch import backend
from opensearch_tpu_torch.node import TorchNode

PKG = Path(__file__).resolve().parents[1] / "opensearch_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "opensearch_tpu"}


def _top_level_imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f.relative_to(PKG)): sorted(_top_level_imports(f) & FORBIDDEN)
           for f in files if _top_level_imports(f) & FORBIDDEN}
    assert not bad, bad
    # the prefix trap: opensearch_tpu_torch is not opensearch_tpu
    assert "opensearch_tpu_torch" in _top_level_imports(PKG / "node.py")


# the modules of the search-contexts slice, each at its reference path
CONTEXT_MODULES = ("tasks/__init__.py", "tasks/manager.py",
                   "search/backpressure.py", "common/breaker.py", "wlm.py",
                   "index/request_cache.py", "telemetry/export.py",
                   "cluster/cluster_settings.py", "cluster/residency.py",
                   "common/randutil.py")


@pytest.mark.parametrize("rel", CONTEXT_MODULES)
def test_context_modules_stand_alone(rel):
    """Each module of the search-contexts slice sits at its reference
    path, imports nothing of jax or the JAX package, and its imports of
    the port resolve (no module of the reference under a port name)."""
    path = PKG / rel
    assert path.exists() and (PKG.parent / "opensearch_tpu" / rel).exists()
    assert not _top_level_imports(path) & FORBIDDEN
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module.startswith("opensearch_tpu_torch"):
            rel_mod = node.module.replace(".", "/")
            assert (PKG.parent / f"{rel_mod}.py").exists() or \
                (PKG.parent / rel_mod / "__init__.py").exists(), node.module


def test_context_modules_import_with_jax_unimportable(tmp_path):
    script = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["opensearch_tpu"] = None
        sys.path.insert(0, {str(PKG.parent)!r})
        import opensearch_tpu_torch.tasks
        import opensearch_tpu_torch.search.backpressure
        import opensearch_tpu_torch.common.breaker
        import opensearch_tpu_torch.wlm
        import opensearch_tpu_torch.index.request_cache
        import opensearch_tpu_torch.telemetry.export
        import opensearch_tpu_torch.cluster.cluster_settings
        import opensearch_tpu_torch.cluster.residency
        from opensearch_tpu_torch.node import TorchNode
        node = TorchNode({str(tmp_path)!r}, device="cpu")
        node.create_index("i", {{"aliases": {{"a": {{}}}}}})
        node.put_cluster_settings({{"persistent": {{
            "search.max_keep_alive": "1h"}}}})
        pit = node.open_pit("a", "1m")
        print(len(node.close_pit([pit["pit_id"]])["pits"]))
        node.close()
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1"]


# the modules of the ingest, templates and stats slice, each at its
# reference path
OPS_MODULES = ("ingest/__init__.py", "ingest/document.py",
               "ingest/processors.py", "ingest/service.py",
               "common/monitor.py")


@pytest.mark.parametrize("rel", OPS_MODULES)
def test_ops_modules_stand_alone(rel):
    """Each module of the ingest, templates and stats slice sits at its
    reference path, imports nothing of jax or the JAX package, and its
    imports of the port resolve."""
    test_context_modules_stand_alone(rel)


def test_ops_slice_runs_with_jax_unimportable(tmp_path):
    """A template-built, pipeline-fed kNN index through a pattern, and the
    stats surface, with jax and the JAX package unimportable."""
    script = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["opensearch_tpu"] = None
        sys.path.insert(0, {str(PKG.parent)!r})
        import opensearch_tpu_torch.ingest
        import opensearch_tpu_torch.common.monitor
        from opensearch_tpu_torch.node import TorchNode
        from opensearch_tpu_torch.rest import handlers
        node = TorchNode({str(tmp_path)!r}, device="cpu")
        node.put_component_template("c", {{"template": {{
            "settings": {{"index.default_pipeline": "p"}},
            "mappings": {{"properties": {{"v": {{
                "type": "knn_vector", "dimension": 3}}}}}}}}}})
        node.put_index_template("t", {{"index_patterns": ["vec-*"],
                                       "composed_of": ["c"]}})
        node.ingest.put_pipeline("p", {{"processors": [
            {{"json": {{"field": "s", "target_field": "v"}}}},
            {{"remove": {{"field": "s"}}}}]}})
        node.bulk([("index", {{"_index": "vec-1", "_id": str(i)}},
                    {{"s": f"[{{i}}, 1, 0]"}}) for i in range(8)],
                  refresh=True)
        r = node.search("vec-*,-vec-9", {{"query": {{"knn": {{"v": {{
            "vector": [4.1, 1.0, 0.0], "k": 3}}}}}}, "size": 3}})
        print(",".join(h["_id"] for h in r["hits"]["hits"]))
        st = handlers.nodes_stats(node, {{"metric": "ingest"}}, {{}}, None)
        print(st[1]["nodes"]["node-0"]["ingest"]["pipelines"]["p"]["count"])
        print(handlers.cat_count(node, {{}}, {{"h": "count"}}, None)[1].strip())
        node.close()
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["4,5,3", "8", "8"]


# the modules the index-management, document-reads and batching slice
# extended, each at its reference path
ADMIN_MODULES = ("search/batcher.py", "search/service.py", "node.py",
                 "rest/handlers.py")


@pytest.mark.parametrize("rel", ADMIN_MODULES)
def test_admin_modules_stand_alone(rel):
    test_context_modules_stand_alone(rel)


def test_admin_slice_runs_with_jax_unimportable(tmp_path):
    """Concurrent bare kNN searches merged on the stacked step, a mapping
    update, close / open, a split, a rollover and the document reads, with
    jax and the JAX package unimportable."""
    script = textwrap.dedent(f"""
        import sys, threading
        sys.modules["jax"] = None
        sys.modules["opensearch_tpu"] = None
        sys.path.insert(0, {str(PKG.parent)!r})
        from opensearch_tpu_torch.node import TorchNode
        from opensearch_tpu_torch.rest import handlers
        node = TorchNode({str(tmp_path)!r}, device="cpu")
        node.knn_batcher.reset()
        node.create_index("a-000001", {{
            "settings": {{"number_of_shards": 2}},
            "aliases": {{"w": {{"is_write_index": True}}}},
            "mappings": {{"properties": {{"v": {{
                "type": "knn_vector", "dimension": 3}}}}}}}})
        node.bulk([("index", {{"_index": "w", "_id": str(i)}},
                    {{"v": [i, 1, 0]}}) for i in range(8)], refresh=True)
        q = {{"query": {{"knn": {{"v": {{"vector": [4.1, 1, 0],
                                         "k": 3}}}}}}, "size": 3}}
        bar = threading.Barrier(4)
        out = []
        def run():
            bar.wait()
            out.append(node.search("a-000001", q))
        ts = [threading.Thread(target=run) for _ in range(4)]
        [t.start() for t in ts]; [t.join() for t in ts]
        st = node.knn_batcher.snapshot_stats()
        print(st["cross_shard_queries"], st["dispatches"] < 4)
        node.put_mapping("a-000001", {{"properties": {{"t": {{
            "type": "text"}}}}}})
        node.close_index("a-000001")
        node.open_index("a-000001")
        node.put_index_settings("a-000001", {{"index.blocks.write": True}})
        node.resize_index("split", "a-000001", "s")
        r = node.search("s", q)
        print(",".join(h["_id"] for h in r["hits"]["hits"]))
        node.put_index_settings("a-000001", {{"index.blocks.write": False}})
        print(node.rollover("w")["new_index"])
        print(node.explain("s", "4", q)["matched"],
              len(node.mget("s", {{"ids": ["1", "2"]}})["docs"]),
              handlers.validate_query(node, {{}}, {{}}, q)[1]["valid"])
        node.close()
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["4", "True", "4,5,3", "a-000002", "True",
                                  "2", "True"]


# the modules of the snapshots, remote store, reindex, rank evaluation and
# persistent-tasks slice, each at its reference path
BACKUP_MODULES = ("repositories/__init__.py", "repositories/blobstore.py",
                  "persistent.py", "snapshots/__init__.py",
                  "snapshots/service.py", "index/remote_store.py",
                  "reindex/__init__.py", "reindex/service.py",
                  "search/rank_eval.py")


@pytest.mark.parametrize("rel", BACKUP_MODULES)
def test_backup_modules_stand_alone(rel):
    test_context_modules_stand_alone(rel)


def test_backup_slice_runs_with_jax_unimportable(tmp_path):
    """A kNN index snapshotted and restored under a rename, synced to the
    remote store and restored from it, reindexed, updated and deleted by
    query, rank-evaluated, and a persistent task resumed after a restart,
    with jax and the JAX package unimportable."""
    script = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["opensearch_tpu"] = None
        sys.path.insert(0, {str(PKG.parent)!r})
        from opensearch_tpu_torch import persistent
        from opensearch_tpu_torch.node import TorchNode
        from opensearch_tpu_torch.reindex import (
            delete_by_query, reindex, update_by_query)
        from opensearch_tpu_torch.search.rank_eval import rank_eval
        runs = []
        persistent.register_executor("t/echo", lambda p, t: runs.append(1))
        path = {str(tmp_path / "data")!r}
        node = TorchNode(path, device="cpu")
        mapping = {{"properties": {{
            "v": {{"type": "knn_vector", "dimension": 3}},
            "n": {{"type": "long"}}}}}}
        node.create_index("a", {{"mappings": mapping, "settings": {{
            "index.remote_store.enabled": True,
            "index.remote_store.segment.repository": "obj"}}}})
        node.create_index("c", {{"mappings": mapping}})
        node.snapshots.put_repository("bk", {{"type": "fs", "settings": {{
            "location": {str(tmp_path / "bk")!r}}}}})
        node.snapshots.put_repository("obj", {{"type": "fs", "settings": {{
            "location": {str(tmp_path / "obj")!r}}}}})
        node.bulk([("index", {{"_index": "a", "_id": str(i)}},
                    {{"v": [i, 1, 0], "n": i}}) for i in range(8)],
                  refresh=True)
        q = {{"query": {{"knn": {{"v": {{"vector": [4.1, 1, 0],
                                         "k": 3}}}}}}, "size": 3}}
        ids = lambda r: ",".join(h["_id"] for h in r["hits"]["hits"])
        node.snapshots.create_snapshot("bk", "s1", {{"indices": "a"}})
        node.snapshots.restore_snapshot("bk", "s1", {{
            "rename_pattern": "a", "rename_replacement": "r"}})
        print(ids(node.search("r", q)))
        node.remote_store.sync_index("a")
        node.delete_index("a")
        node.remote_store.restore(["a"])
        print(ids(node.search("a", q)))
        reindex(node, {{"source": {{"index": "a"}},
                        "dest": {{"index": "c"}}}}, refresh=True)
        update_by_query(node, "c", {{"script": {{
            "source": "ctx._source.n += 10"}}}}, refresh=True)
        delete_by_query(node, "c", {{"query": {{"term": {{
            "n": 14}}}}}}, refresh=True)
        print(ids(node.search("c", q)))
        print(rank_eval(node, "c", {{"requests": [{{"id": "x",
            "request": q, "ratings": [{{"_index": "c", "_id": "5",
            "rating": 1}}]}}], "metric": {{"recall": {{"k": 3}}}}}})[
            "metric_score"])
        node.persistent_tasks.start("t/echo", {{}})
        node.close()
        TorchNode(path, device="cpu").close()
        print(len(runs))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["4,5,3", "4,5,3", "5,3,6", "1.0", "2"]


# the modules of the cluster slice, each at its reference path
CLUSTER_MODULES = ("cluster/state.py", "cluster/coordination.py",
                   "cluster/allocation.py", "cluster/coordinator.py",
                   "gateway.py", "transport/__init__.py", "transport/base.py",
                   "testing/__init__.py", "testing/sim.py",
                   "index/recovery.py", "search/reduce.py",
                   "cluster/cluster_node.py", "cluster/remote.py")


@pytest.mark.parametrize("rel", CLUSTER_MODULES)
def test_cluster_modules_stand_alone(rel):
    test_context_modules_stand_alone(rel)


def test_cluster_slice_runs_with_jax_unimportable(tmp_path):
    """A 3-node sim cluster elects a leader, allocates a replicated kNN
    index, takes a bulk and answers a kNN through each node, with jax and
    the JAX package unimportable."""
    script = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["opensearch_tpu"] = None
        sys.path.insert(0, {str(PKG.parent)!r})
        from pathlib import Path
        from opensearch_tpu_torch.cluster.cluster_node import ClusterNode
        from opensearch_tpu_torch.testing.sim import (
            DeterministicTaskQueue, MockTransport)
        queue = DeterministicTaskQueue(3)
        transport = MockTransport(queue, timeout_ms=400)
        ids = ["n0", "n1", "n2"]
        nodes = [ClusterNode(i, Path({str(tmp_path)!r}) / i, transport,
                             queue, ids, device="cpu") for i in ids]
        for n in nodes:
            n.disk_usage_pct = 50.0
            n.bootstrap(ids)
        for n in nodes:
            n.start()
        queue.run_until(queue.now_ms + 5000)
        def call(fn, *args):
            out = []
            fn(*args, callback=out.append)
            while not out:
                queue.run_one()
            return out[0]
        call(nodes[0].create_index, "v", {{
            "settings": {{"index": {{"number_of_shards": 2,
                                     "number_of_replicas": 1}}}},
            "mappings": {{"properties": {{"v": {{
                "type": "knn_vector", "dimension": 3}}}}}}}})
        queue.run_until(queue.now_ms + 5000)
        call(nodes[0].bulk, [("index", {{"_index": "v", "_id": str(i)}},
                              {{"v": [i, 1, 0]}}) for i in range(8)])
        call(nodes[0].refresh, "v")
        for n in nodes:
            r = call(n.search, "v", {{"query": {{"knn": {{"v": {{
                "vector": [4.1, 1, 0], "k": 3}}}}}}, "size": 3}})
            print(",".join(h["_id"] for h in r["hits"]["hits"]))
        for n in nodes:
            n.close()
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["4,5,3"] * 3


# an ivf_pq mapping with min_train 64 over 200 docs: the refresh builds an
# IVF-PQ index and the search takes the per-shard ANN route
_ANN_METHOD = {"name": "ivf_pq",
               "parameters": {"nlist": 4, "m": 3, "min_train": 64}}


@pytest.mark.parametrize("method,n_docs", [(None, 20), (_ANN_METHOD, 200)],
                         ids=["exact", "ivf_pq"])
def test_search_runs_with_jax_unimportable(tmp_path, method, n_docs):
    mapping = {"type": "knn_vector", "dimension": 3}
    if method is not None:
        mapping["method"] = method
    script = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["opensearch_tpu"] = None
        sys.path.insert(0, {str(PKG.parent)!r})
        from opensearch_tpu_torch.node import TorchNode
        from opensearch_tpu_torch.search import executor
        node = TorchNode({str(tmp_path)!r}, device="cpu")
        node.create_index("i", {{"mappings": {{"properties": {{
            "v": {mapping!r}}}}}}})
        node.bulk([("index", {{"_index": "i", "_id": str(i)}},
                    {{"v": [float(i), 1.0, 0.0]}}) for i in range({n_docs})])
        node.refresh("i")
        r = node.search("i", {{"query": {{"knn": {{"v": {{
            "vector": [4.1, 1.0, 0.0], "k": 3}}}}}}, "size": 3}})
        print(",".join(h["_id"] for h in r["hits"]["hits"]))
        print(executor.knn_path_stats["ann"])
        node.close()
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    hits, ann = out.stdout.split()
    assert hits == "4,5,3"
    assert ann == ("1" if method is not None else "0")


def test_default_device_is_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchNode(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        backend.resolve_device(None)
    assert backend.resolve_device("cpu") == torch.device("cpu")


def test_float32_products_are_pinned():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.fixture()
def node(tmp_path):
    n = TorchNode(tmp_path, device="cpu")
    n.create_index("i", {"mappings": {"properties": {
        "v": {"type": "knn_vector", "dimension": 4},
        "title": {"type": "text"}}}})
    n.bulk([("index", {"_index": "i", "_id": str(i)},
             {"v": np.full(4, i, np.float32).tolist(), "title": "a b"})
            for i in range(10)], refresh=True)
    yield n
    n.close()


@pytest.mark.parametrize("index,body,outside", [
    ("i", {"query": {"script": {"script": {"source": "true"}}}}, False),
    ("i", {"query": {"knn": {"v": {"vector": [1, 1, 1, 1], "k": 2}}},
           "script_fields": {"x": {"script": {"source": "1"}}}}, False),
    ("i", {"query": {"knn": {"v": {"vector": [1, 1, 1, 1], "k": 2}}},
           "suggest": {"s": {"text": "a", "term": {"field": "title"}}}},
     False),
    ("i", {"query": {"knn": {"v": {"vector": [1, 1, 1, 1], "k": 2,
                                   "filter": {"nested": {
                                       "path": "n",
                                       "query": {"match": {"title": "a"}}}}}}}},
     False),
    pytest.param("i*", {"query": {"script": {"script": {
        "source": "true"}}}}, False, id="i*-body4-True"),
])
def test_bodies_outside_the_slice_raise(node, tmp_path, index, body,
                                        outside):
    """A body outside the port raises "not yet ported"; the script, script
    field, suggest and nested-filter bodies and a wildcard index
    expression, ported now, answer as the reference does."""
    if outside:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            node.search(index, body)
        return
    got = node.search(index, body)
    pytest.importorskip("jax")
    from opensearch_tpu.node import TpuNode

    ref = TpuNode(tmp_path / "ref")
    try:
        ref.create_index("i", {"mappings": {"properties": {
            "v": {"type": "knn_vector", "dimension": 4},
            "title": {"type": "text"}}}})
        ref.bulk([("index", {"_index": "i", "_id": str(i)},
                   {"v": np.full(4, i, np.float32).tolist(), "title": "a b"})
                  for i in range(10)], refresh=True)
        want = ref.search(index, body)
    finally:
        ref.close()
    assert [(h["_id"], h["_score"], h.get("fields"))
            for h in got["hits"]["hits"]] == \
        [(h["_id"], h["_score"], h.get("fields"))
         for h in want["hits"]["hits"]]
    assert got["hits"]["total"] == want["hits"]["total"]
    assert got.get("suggest") == want.get("suggest")


def test_knn_with_terms_on_a_text_field_is_the_references(node, tmp_path):
    """Aggregations are served: a terms aggregation on a text field is an
    empty bucket list beside the kNN hits, as in the reference."""
    body = {"query": {"knn": {"v": {"vector": [1, 1, 1, 1], "k": 2}}},
            "aggs": {"t": {"terms": {"field": "title"}}}}
    got = node.search("i", body)
    assert [h["_id"] for h in got["hits"]["hits"]] == ["1", "0"]
    pytest.importorskip("jax")
    from opensearch_tpu.node import TpuNode

    ref = TpuNode(tmp_path / "ref")
    try:
        ref.create_index("i", {"mappings": {"properties": {
            "v": {"type": "knn_vector", "dimension": 4},
            "title": {"type": "text"}}}})
        ref.bulk([("index", {"_index": "i", "_id": str(i)},
                   {"v": np.full(4, i, np.float32).tolist(), "title": "a b"})
                  for i in range(10)], refresh=True)
        want = ref.search("i", body)
    finally:
        ref.close()
    assert got["aggregations"] == want["aggregations"]
    assert ([h["_id"] for h in got["hits"]["hits"]]
            == [h["_id"] for h in want["hits"]["hits"]])


def test_filtered_knn_body_is_served(node):
    """A term filter on a text field inside the kNN clause is served: every
    doc holds "a", so the two nearest come back."""
    resp = node.search("i", {"query": {"knn": {"v": {
        "vector": [1, 1, 1, 1], "k": 2,
        "filter": {"term": {"title": "a"}}}}}})
    assert [h["_id"] for h in resp["hits"]["hits"]] == ["1", "0"]


def test_ivf_pq_mapping_builds_at_min_train(tmp_path):
    """Below min_train an ivf_pq column stays exact and serves; at or above
    it the refresh builds an IVFPQIndex."""
    from opensearch_tpu_torch.ops.ivfpq import IVFPQIndex

    n = TorchNode(tmp_path, device="cpu")
    n.create_index("ann", {"mappings": {"properties": {"v": {
        "type": "knn_vector", "dimension": 4,
        "method": {"name": "ivf_pq", "parameters": {
            "nlist": 4, "m": 2, "min_train": 40}}}}}})
    rng = np.random.default_rng(3)
    data = rng.standard_normal((60, 4)).astype(np.float32)
    n.bulk([("index", {"_index": "ann", "_id": str(i)}, {"v": data[i].tolist()})
            for i in range(20)], refresh=True)
    (shard,) = n.indices["ann"].shards.values()
    (_host, dev), = shard.acquire_searcher().segments
    assert dev.vector_fields["v"].ann is None
    r = n.search("ann", {"query": {"knn": {"v": {
        "vector": data[7].tolist(), "k": 1}}}})
    assert [h["_id"] for h in r["hits"]["hits"]] == ["7"]
    n.bulk([("index", {"_index": "ann", "_id": str(i)}, {"v": data[i].tolist()})
            for i in range(20, 60)], refresh=True)
    anns = [dev.vector_fields["v"].ann
            for _h, dev in shard.acquire_searcher().segments]
    assert [type(a) for a in anns] == [type(None), IVFPQIndex]
    assert anns[1].n == 40 and anns[1].params.m == 2
    n.close()
