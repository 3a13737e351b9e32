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
bit-identical to the JAX package's. A vector column whose mapping asks for
method ivf_pq also gets an IVF-PQ structure (ops/ivfpq.build) when the
segment has at least ``min_train`` present vectors; smaller segments stay
exact.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from opensearch_tpu_torch.index.segment import HostSegment, pad_size

_ANN_METHODS = ("ivf_pq", "ivfpq", "ivf")

# IVF-PQ build accounting (search/ann.AnnServingConfig.snapshot): builds
# run on the refresh/merge path, which can run beside stats readers
_ann_build_lock = threading.Lock()
_ann_build_stats = {"builds": 0, "build_wall_ns": 0, "last_generation": 0}


def ann_build_stats() -> dict:
    with _ann_build_lock:
        return dict(_ann_build_stats)


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
    # IVF-PQ structure (ops/ivfpq.IVFPQIndex) built at refresh when the
    # mapping asked for method ivf_pq and the segment is big enough
    ann: object | None = None
    nprobe_default: int = 8


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


def _maybe_build_ann(vf, device: torch.device | str):
    """Build an IVF-PQ index for a sealed vector column when asked for.

    Returns (ann_or_None, nprobe_default). ANN serves l2/cosine;
    dot_product stays exact, as in the k-NN plugin."""
    method = vf.method or {}
    name = str(method.get("name", "")).lower().replace("-", "_")
    if name not in _ANN_METHODS:
        return None, 8
    if vf.similarity not in ("l2_norm", "l2", "cosine", "cosinesimil"):
        return None, 8
    params = method.get("parameters") or {}
    n_present = int(vf.present.sum())
    from opensearch_tpu_torch.ops import ivfpq

    min_train = int(params.get("min_train", ivfpq.MIN_TRAIN_DOCS))
    if n_present < min_train:
        return None, 8
    dims = vf.dims
    m = int(params.get("m", params.get("code_size", ivfpq.DEFAULT_M)))
    while dims % m != 0 and m > 1:
        m -= 1
    doc_ids = np.nonzero(vf.present)[0].astype(np.int32)
    t0 = time.perf_counter_ns()
    ann = ivfpq.build(
        vf.vectors[doc_ids],
        doc_ids,
        nlist=int(params.get("nlist", ivfpq.DEFAULT_NLIST)),
        m=m,
        ks=int(params.get("ks", ivfpq.DEFAULT_KS)),
        iters=int(params.get("iters", 10)),
        normalized=vf.similarity in ("cosine", "cosinesimil"),
        device=device,
    )
    with _ann_build_lock:
        _ann_build_stats["builds"] += 1
        _ann_build_stats["build_wall_ns"] += time.perf_counter_ns() - t0
        _ann_build_stats["last_generation"] = ann.build_generation
    return ann, int(params.get("nprobe", ivfpq.DEFAULT_NPROBE))


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
        dvf = vector_field_from_numpy(
            vf.vectors, vf.present, similarity=vf.similarity, n_pad=n_pad,
            device=device,
        )
        dvf.ann, dvf.nprobe_default = _maybe_build_ann(vf, device)
        vector_fields[fname] = dvf

    return DeviceSegment(
        name=seg.name,
        n_docs=seg.n_docs,
        n_pad=n_pad,
        live=torch.from_numpy(live).to(device),
        vector_fields=vector_fields,
    )
