"""The search engine's parallelism axes as a logical grid of slots.

Counterpart of opensearch_tpu/parallel/mesh.py:

- the "data" axis is shard partitioning: each slot along it owns one
  index shard's segment arrays;
- the "model" axis is intra-shard parallelism: a shard's vector dim is
  split across the slots along it, and their partial products are summed.

The port's mesh is the single-device form: a logical [n_data, n_model]
grid of slots, every one of them the same device (by default the card,
``backend.resolve_device(None)``). The tensor-parallel program
(parallel/distributed.build_distributed_search) keeps the grid's
arithmetic (a leading [S] shard axis, d split into n_model slices, the
partials added in rank order) on that one device. So the reference's
"mesh AxB needs N devices" error has no counterpart here: any grid fits
one card. A mesh over several GPUs (``torch.distributed``) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opensearch_tpu_torch import backend

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A logical [n_data, n_model] grid of slots on one device.
    ``devices`` is the grid as a numpy object array (every entry the one
    device), ``shape`` maps each axis name to its extent."""

    def __init__(self, device: torch.device, n_data: int, n_model: int):
        self.device = device
        self.axis_names = (DATA_AXIS, MODEL_AXIS)
        self.shape = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
        grid = np.empty((n_data, n_model), dtype=object)
        grid.fill(device)
        self.devices = grid

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape[DATA_AXIS]}x{self.shape[MODEL_AXIS]} "
                f"on {self.device})")


def build_mesh(n_data: int | None = None, n_model: int = 1,
               devices: list | None = None) -> Mesh:
    """A [n_data, n_model] mesh over `devices` (default: the card; it
    raises where there is none). Every slot is the one device, so
    ``devices`` may name only one; n_data defaults to 1."""
    devs = ([backend.resolve_device(None)] if devices is None
            else [backend.resolve_device(d) for d in devices])
    if len(set(devs)) != 1:
        raise ValueError(
            f"the port's mesh runs on one device, got {len(set(devs))} "
            f"distinct devices; a mesh over several GPUs is not ported")
    n_data = 1 if n_data is None else int(n_data)
    n_model = int(n_model)
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh {n_data}x{n_model}: extents must be >= 1")
    return Mesh(devs[0], n_data, n_model)


class NamedSharding(NamedTuple):
    """How an array's dims map onto the mesh axes (None: replicated). On
    one device it describes the layout the program slices by; nothing
    moves between devices."""

    mesh: Mesh
    spec: tuple


def shard_spec(mesh: Mesh, *axes: str | None) -> NamedSharding:
    return NamedSharding(mesh, tuple(axes))
