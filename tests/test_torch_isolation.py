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


@pytest.mark.parametrize("body", [
    {"query": {"match": {"title": "a"}}},
    {"query": {"knn": {"v": {"vector": [1, 1, 1, 1], "k": 2}}},
     "aggs": {"t": {"terms": {"field": "title"}}}},
    {"query": {"knn": {"v": {"vector": [1, 1, 1, 1], "k": 2}}},
     "sort": ["_score"]},
    {"query": {"knn": {"v": {"vector": [1, 1, 1, 1], "k": 2,
                             "filter": {"match": {"title": "a"}}}}}},
])
def test_bodies_outside_the_slice_raise(node, body):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        node.search("i", body)


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
