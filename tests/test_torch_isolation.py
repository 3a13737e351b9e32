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


def test_search_runs_with_jax_unimportable(tmp_path):
    script = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["opensearch_tpu"] = None
        sys.path.insert(0, {str(PKG.parent)!r})
        from opensearch_tpu_torch.node import TorchNode
        node = TorchNode({str(tmp_path)!r}, device="cpu")
        node.create_index("i", {{"mappings": {{"properties": {{
            "v": {{"type": "knn_vector", "dimension": 3}}}}}}}})
        node.bulk([("index", {{"_index": "i", "_id": str(i)}},
                    {{"v": [float(i), 1.0, 0.0]}}) for i in range(20)])
        node.refresh("i")
        r = node.search("i", {{"query": {{"knn": {{"v": {{
            "vector": [4.1, 1.0, 0.0], "k": 3}}}}}}, "size": 3}})
        print(",".join(h["_id"] for h in r["hits"]["hits"]))
        node.close()
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "4,5,3"


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
                             "filter": {"term": {"title": "a"}}}}}},
])
def test_bodies_outside_the_slice_raise(node, body):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        node.search("i", body)


def test_ivf_pq_mapping_raises_not_yet_ported(tmp_path):
    n = TorchNode(tmp_path, device="cpu")
    n.create_index("ann", {"mappings": {"properties": {"v": {
        "type": "knn_vector", "dimension": 4,
        "method": {"name": "ivf_pq"}}}}})
    n.bulk([("index", {"_index": "ann", "_id": "1"}, {"v": [1, 2, 3, 4]})])
    with pytest.raises(NotImplementedError, match="not yet ported"):
        n.refresh("ann")
    n.close()
