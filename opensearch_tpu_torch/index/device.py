"""Device-resident segment bundles: padded torch tensors on one device.

Counterpart of opensearch_tpu/index/device.py. A HostSegment is sealed
once, then :func:`to_device` pads its columns to the segment's bucketed
n_pad and copies them to an explicit ``device``. Readers (the query phase)
only ever see these tensors; a refresh after deletes republishes the live
bitmap alone (:meth:`DeviceSegment.with_live`). Docs >= n_docs are padding
(live=False).

Only what the kNN slice reads goes to the device so far: the live bitmap
and the vector columns. Text, keyword and numeric columns stay on the host
until the executor that scores them is ported.

Vector norms use the host formula (float64 sum, then float32), so they are
bit-identical to the JAX package's. IVF-PQ vector fields are not ported
yet: a mapping that asks for one raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from opensearch_tpu_torch.index.segment import HostSegment, pad_size

_ANN_METHODS = ("ivf_pq", "ivfpq", "ivf")


def _pad1(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    if a.shape[0] >= n:
        return a[:n]
    out = np.full((n, *a.shape[1:]), fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def vector_norms_sq(vectors: np.ndarray) -> np.ndarray:
    """||v||^2 per row: float64 sum then float32, the host formula shared
    by the segment upload and the serving bundle."""
    return (np.asarray(vectors).astype(np.float64) ** 2).sum(axis=1).astype(
        np.float32)


@dataclass
class DeviceVectorField:
    vectors: torch.Tensor         # float32 [n_pad, dims]
    norms_sq: torch.Tensor        # float32 [n_pad]
    present: torch.Tensor         # bool [n_pad]
    dims: int
    similarity: str
    # the IVF-PQ structure of the reference; always None until ANN is
    # ported (to_device raises for an ivf_pq mapping)
    ann: object | None = None


@dataclass
class DeviceSegment:
    name: str
    n_docs: int
    n_pad: int
    live: torch.Tensor            # bool [n_pad] (padding rows are False)
    vector_fields: dict[str, DeviceVectorField]

    def with_live(self, live_host: np.ndarray) -> "DeviceSegment":
        """Republishes the deletes bitmap (refresh after deletes)."""
        live = np.zeros(self.n_pad, dtype=bool)
        live[: self.n_docs] = live_host[: self.n_docs]
        return DeviceSegment(
            name=self.name,
            n_docs=self.n_docs,
            n_pad=self.n_pad,
            live=torch.from_numpy(live).to(self.live.device),
            vector_fields=self.vector_fields,
        )


def _check_not_ann(fname: str, vf) -> None:
    method = vf.method or {}
    name = str(method.get("name", "")).lower().replace("-", "_")
    if name in _ANN_METHODS:
        raise NotImplementedError(
            f"knn_vector field [{fname}] asks for method [{name}]: IVF-PQ "
            f"is not yet ported to opensearch_tpu_torch"
        )


def vector_field_from_numpy(vectors: np.ndarray, present: np.ndarray, *,
                            similarity: str, n_pad: int,
                            device: torch.device | str) -> DeviceVectorField:
    """One vector column on `device`, padded to n_pad rows."""
    vecs = _pad1(np.asarray(vectors, np.float32), n_pad)
    return DeviceVectorField(
        vectors=torch.from_numpy(np.ascontiguousarray(vecs)).to(device),
        norms_sq=torch.from_numpy(vector_norms_sq(vecs)).to(device),
        present=torch.from_numpy(
            _pad1(np.asarray(present, bool), n_pad, fill=False)).to(device),
        dims=int(vecs.shape[1]),
        similarity=similarity,
    )


def to_device(seg: HostSegment, device: torch.device | str) -> DeviceSegment:
    n_pad = pad_size(seg.n_docs)
    live = np.zeros(n_pad, dtype=bool)
    live[: seg.n_docs] = seg.live

    vector_fields: dict[str, DeviceVectorField] = {}
    for fname, vf in seg.vector_fields.items():
        _check_not_ann(fname, vf)
        vector_fields[fname] = vector_field_from_numpy(
            vf.vectors, vf.present, similarity=vf.similarity, n_pad=n_pad,
            device=device,
        )

    return DeviceSegment(
        name=seg.name,
        n_docs=seg.n_docs,
        n_pad=n_pad,
        live=torch.from_numpy(live).to(device),
        vector_fields=vector_fields,
    )
