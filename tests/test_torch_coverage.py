"""The port has every module of the reference, and imports none of it.

- For every ``.py`` under ``opensearch_tpu/`` a module of the same
  relative path exists under ``opensearch_tpu_torch/``, but for the two
  files that hold the Pallas kernels: their kernels are CUDA sources under
  ``opensearch_tpu_torch/csrc/`` (named in :data:`SERVED_BY_CSRC`), and
  the wrappers that launch them live in the port's ``ops/`` modules.
- No module of the port imports ``jax`` (or ``jaxlib``) or anything of
  ``opensearch_tpu``: an AST walk over every import statement of the
  port's package, relative imports resolved.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
REF = REPO / "opensearch_tpu"
PORT = REPO / "opensearch_tpu_torch"
# the reference's Pallas files -> the port's CUDA sources of their kernels
SERVED_BY_CSRC = {
    "ops/pallas_knn.py": ("knn_fused.cu", "knn_block.cu", "knn_pb.cu",
                          "knn_sbmax.cu"),
    "ops/pallas_adc.py": ("adc_scan.cu",),
}
REFUSED = ("jax", "jaxlib", "opensearch_tpu")


def modules(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                  if "__pycache__" not in p.parts)


def test_every_reference_module_has_a_counterpart():
    ref, port = modules(REF), set(modules(PORT))
    assert len(ref) >= 120
    missing = [m for m in ref if m not in port]
    assert missing == sorted(SERVED_BY_CSRC), missing


@pytest.mark.parametrize("pallas_file", sorted(SERVED_BY_CSRC))
def test_pallas_files_are_served_by_csrc(pallas_file):
    assert (REF / pallas_file).is_file()
    assert "pallas_call" in (REF / pallas_file).read_text()
    for source in SERVED_BY_CSRC[pallas_file]:
        assert (PORT / "csrc" / source).is_file(), source


def _imported(path: Path, tree: ast.AST) -> list[tuple[int, str]]:
    """(line, absolute module name) of every import in a port module."""
    package = ".".join(path.relative_to(REPO).with_suffix("").parts[:-1])
    if path.name == "__init__.py":
        package = ".".join(path.relative_to(REPO).parts[:-1])
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.extend((node.lineno, a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package.split(".")
                base = base[:len(base) - node.level + 1]
                name = ".".join(base + ([node.module] if node.module
                                        else []))
            else:
                name = node.module or ""
            out.append((node.lineno, name))
    return out


def test_no_port_module_imports_jax_or_the_reference():
    offenders = []
    files = [p for p in PORT.rglob("*.py") if "__pycache__" not in p.parts]
    assert len(files) >= 120
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for line, name in _imported(path, tree):
            if name.split(".")[0] in REFUSED:
                offenders.append(f"{path.relative_to(REPO)}:{line} {name}")
    assert offenders == []


def test_the_walk_sees_a_refused_import():
    """The walk resolves what a port module would have to spell to reach
    the reference."""
    src = ("import jax.numpy as jnp\n"
           "from opensearch_tpu.ops import knn\n"
           "from . import knn_fused\n")
    path = PORT / "ops" / "example.py"
    names = [n for _l, n in _imported(path, ast.parse(src))]
    assert names == ["jax.numpy", "opensearch_tpu.ops", "opensearch_tpu_torch.ops"]
