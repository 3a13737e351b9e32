"""The search engine's parallelism axes as a grid of device slots.

Counterpart of opensearch_tpu/parallel/mesh.py:

- the "data" axis is shard partitioning: each slot along it owns one
  index shard's segment arrays on its device;
- the "model" axis is intra-shard parallelism: a shard's vector dim is
  split across the slots along it, and their partial products are summed.

A mesh is a [n_data, n_model] grid of slots, each naming a device, built
by the reference's rule from a device list (by default the node's serving
devices, ``backend.serving_devices``, the counterpart of
``jax.devices()``): the first n_data * n_model devices, reshaped. Slots
may name distinct cards, and the programs of parallel/distributed.py then
put each slot's slice on its card and copy each slot's partial results to
the device that merges them (the reference's ``psum``, ``all_gather`` and
``ppermute``). A list may repeat a device (``[cuda:0] * 8``, as the
reference's 8 virtual CPU devices share one host), and a list of one
device fills every slot: both run the whole grid on one card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from opensearch_tpu_torch import backend

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A [n_data, n_model] grid of device slots. ``devices`` is the grid
    as a numpy object array of ``torch.device``, ``shape`` maps each axis
    name to its extent, ``device`` is slot (0, 0)'s device."""

    def __init__(self, grid: np.ndarray):
        self.devices = grid
        self.axis_names = (DATA_AXIS, MODEL_AXIS)
        self.shape = {DATA_AXIS: grid.shape[0], MODEL_AXIS: grid.shape[1]}
        self.device = grid[0, 0]

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    def slot(self, data: int, model: int = 0) -> torch.device:
        return self.devices[data, model]

    def __repr__(self) -> str:
        # the grid's devices, each once, in slot order
        devs = ", ".join(str(d) for d in dict.fromkeys(self.devices.flat))
        return (f"Mesh({self.shape[DATA_AXIS]}x{self.shape[MODEL_AXIS]} "
                f"on {devs})")


def build_mesh(n_data: int | None = None, n_model: int = 1,
               devices: list | None = None) -> Mesh:
    """A [n_data, n_model] mesh over `devices` (default: the serving
    devices of the card; it raises where there is none), by the
    reference's rule: n_data defaults to ``len(devices) // n_model``, a
    list shorter than n_data * n_model raises "mesh AxB needs N devices,
    have M", and the grid is the list's first N devices reshaped. A list
    of one device fills every slot (the one-card form)."""
    devs = (backend.serving_devices(None) if devices is None
            else [backend.indexed(backend.resolve_device(d))
                  for d in devices])
    n_model = int(n_model)
    if n_data is None:
        n_data = len(devs) // n_model if len(devs) > 1 else 1
    n_data = int(n_data)
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh {n_data}x{n_model}: extents must be >= 1")
    need = n_data * n_model
    if len(devs) == 1:
        devs = devs * need
    if need > len(devs):
        raise ValueError(f"mesh {n_data}x{n_model} needs {need} devices, "
                         f"have {len(devs)}")
    grid = np.empty(need, dtype=object)
    for i, d in enumerate(devs[:need]):
        grid[i] = d
    return Mesh(grid.reshape(n_data, n_model))


class NamedSharding(NamedTuple):
    """How an array's dims map onto the mesh axes (None: replicated): the
    layout parallel/distributed.shard_arrays_to_mesh slices by."""

    mesh: Mesh
    spec: tuple


def shard_spec(mesh: Mesh, *axes: str | None) -> NamedSharding:
    return NamedSharding(mesh, tuple(axes))
