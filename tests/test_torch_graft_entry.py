"""graft_entry.dryrun_multichip: the reference's dry run of its two mesh
programs (a multi-shard kNN _search through the stacked serving step, and
the tensor-parallel hybrid program over a [n_data, n_model] mesh), on one
device."""

from __future__ import annotations

import pytest
import torch

from opensearch_tpu_torch import backend, graft_entry
from opensearch_tpu_torch.search import distributed_serving


def test_dryrun_multichip_prints_both_ok_lines(capsys):
    before = distributed_serving.stats["distributed_searches"]
    graft_entry.dryrun_multichip(8, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines == [
        "serving path OK: 4-shard knn _search merged on-device over 1 "
        "device (cpu)",
        "dryrun_multichip OK: mesh data=4 x model=2, top-5 scores for 2 "
        "queries over 512 docs",
    ]
    assert distributed_serving.stats["distributed_searches"] == before + 1


@pytest.mark.parametrize("n_devices, shards, mesh", [
    (1, 1, "data=1 x model=1"),
    (2, 2, "data=2 x model=1"),
    (3, 3, "data=3 x model=1"),
    (4, 4, "data=2 x model=2"),
])
def test_dryrun_mesh_shapes_follow_the_reference(capsys, n_devices, shards,
                                                 mesh):
    graft_entry.dryrun_multichip(n_devices, device="cpu")
    out = capsys.readouterr().out
    assert f"{shards}-shard knn _search" in out
    assert f"mesh {mesh}," in out


def test_default_device_is_the_card():
    """With no device the dry run runs on the card, and raises where
    there is none: never a quiet CPU run."""
    if torch.cuda.is_available():
        assert backend.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.dryrun_multichip(8)
