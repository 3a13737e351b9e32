"""Device-resident segment bundles: padded torch tensors on one device.

Counterpart of opensearch_tpu/index/device.py. A HostSegment is sealed
once, then :func:`to_device` pads its columns to the segment's bucketed
n_pad and copies them to an explicit ``device``. Readers (the query phase)
only ever see these tensors; a refresh after deletes republishes the live
bitmap alone (:meth:`DeviceSegment.with_live`). Docs >= n_docs are padding
(live=False).

What the kNN slice and its filters read goes to the device: the live
bitmap, the vector columns, and the columns a filter-context query reads
(search/executor.SegmentExecutor): keyword ordinals (first ordinal a doc,
and the CSR entries' ordinals and owning docs, padded with ordinal -2 and
doc 0), numeric columns (int64 as the two int32 words of
segment.split_i64, floats as f32, and the presence flags) and each text
field's postings docs and doc lengths (a term filter on a text field, and
exists). The text postings' term frequencies come with BM25.
:meth:`DeviceSegment.column_nbytes` counts each kind's bytes beside the
vector slab's.

Vector norms use the host formula (float64 sum, then float32), so they are
bit-identical to the JAX package's. A vector column whose mapping asks for
method ivf_pq also gets an IVF-PQ structure (ops/ivfpq.build) when the
segment has at least ``min_train`` present vectors; smaller segments stay
exact.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from opensearch_tpu_torch.index.segment import (
    HostSegment,
    pad_size,
    split_i64,
)

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
class DeviceTextField:
    postings_docs: torch.Tensor   # int32 [P_pad] (pad 0, never addressed)
    doc_len: torch.Tensor         # float32 [n_pad] (0 = field absent)


@dataclass
class DeviceKeywordField:
    first_ord: torch.Tensor       # int32 [n_pad], -1 missing
    mv_ords: torch.Tensor         # int32 [E_pad], pad = -2
    mv_docs: torch.Tensor         # int32 [E_pad], pad = 0


@dataclass
class DeviceNumericField:
    kind: str                     # "int" | "float"
    hi: torch.Tensor | None       # int32 [n_pad] (int kind)
    lo: torch.Tensor | None
    values: torch.Tensor | None   # float32 [n_pad] (float kind)
    present: torch.Tensor         # bool [n_pad]


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


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
    text_fields: dict[str, DeviceTextField] = dc_field(default_factory=dict)
    keyword_fields: dict[str, DeviceKeywordField] = dc_field(
        default_factory=dict)
    numeric_fields: dict[str, DeviceNumericField] = dc_field(
        default_factory=dict)

    def column_nbytes(self) -> dict[str, int]:
        """Device bytes of each kind of column: the vector slabs (vectors,
        norms, presence), the filter columns (keyword, numeric, text) and
        the live bitmap."""
        return {
            "vector": sum(_nbytes(f.vectors, f.norms_sq, f.present)
                          for f in self.vector_fields.values()),
            "keyword": sum(_nbytes(f.first_ord, f.mv_ords, f.mv_docs)
                           for f in self.keyword_fields.values()),
            "numeric": sum(_nbytes(f.hi, f.lo, f.values, f.present)
                           for f in self.numeric_fields.values()),
            "text": sum(_nbytes(f.postings_docs, f.doc_len)
                        for f in self.text_fields.values()),
            "live": _nbytes(self.live),
        }

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
            text_fields=self.text_fields,
            keyword_fields=self.keyword_fields,
            numeric_fields=self.numeric_fields,
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

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    text_fields: dict[str, DeviceTextField] = {}
    for fname, tf in seg.text_fields.items():
        p_pad = pad_size(max(len(tf.postings_docs), 1))
        text_fields[fname] = DeviceTextField(
            postings_docs=put(_pad1(np.asarray(tf.postings_docs, np.int32),
                                    p_pad)),
            doc_len=put(_pad1(np.asarray(tf.doc_len, np.float32), n_pad)),
        )

    keyword_fields: dict[str, DeviceKeywordField] = {}
    for fname, kf in seg.keyword_fields.items():
        e_pad = pad_size(max(len(kf.mv_ords), 1))
        keyword_fields[fname] = DeviceKeywordField(
            first_ord=put(_pad1(np.asarray(kf.first_ord, np.int32), n_pad,
                                fill=-1)),
            mv_ords=put(_pad1(np.asarray(kf.mv_ords, np.int32), e_pad,
                              fill=-2)),
            mv_docs=put(_pad1(np.asarray(kf.mv_docs, np.int32), e_pad,
                              fill=0)),
        )

    numeric_fields: dict[str, DeviceNumericField] = {}
    for fname, nf in seg.numeric_fields.items():
        present = put(_pad1(np.asarray(nf.present, bool), n_pad, fill=False))
        if nf.kind == "int":
            hi, lo = split_i64(nf.values_i64)
            numeric_fields[fname] = DeviceNumericField(
                kind="int", hi=put(_pad1(hi, n_pad)), lo=put(_pad1(lo, n_pad)),
                values=None, present=present)
        else:
            numeric_fields[fname] = DeviceNumericField(
                kind="float", hi=None, lo=None,
                values=put(_pad1(nf.values_f64.astype(np.float32), n_pad)),
                present=present)

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
        text_fields=text_fields,
        keyword_fields=keyword_fields,
        numeric_fields=numeric_fields,
    )
