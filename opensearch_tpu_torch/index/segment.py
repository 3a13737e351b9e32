"""Immutable segment array bundles: host build + device residency.

The analog of a Lucene segment (what IndexWriter writes and a LeafReader
serves, reference: server/src/main/java/org/opensearch/index/engine/
InternalEngine.java:1138 addDocs → IndexWriter) re-designed for TPU HBM:

- postings: flat CSR int32/float32 arrays sorted by (term_id, doc_id); the
  term dictionary stays host-side (hash map), postings go to device; BM25
  scoring gathers padded per-term windows and scatter-adds into a dense
  score column (opensearch_tpu_torch/ops/bm25.py)
- doc-values: dense columns. int-family (long/integer/date/boolean) columns
  are split into two int32 words on device (TPU JAX is 32-bit by default and
  epoch-millis don't fit float32); float-family stored as float32
- keyword: ordinal encoding, CSR for multi-valued + first-ord column for sort
- vectors: [n_docs, dims] float32 matrix (bf16 variant for the MXU path)
- stored fields (_source, _id): host-side only — fetch phase is host work

All device arrays are padded: n_docs to a bucketed n_pad so XLA compile
cache entries stay bounded across segments.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field
from pathlib import Path
from typing import Any

import numpy as np

from opensearch_tpu_torch.common.errors import IllegalArgumentException
from opensearch_tpu_torch.index.mapper import (
    INT_TYPES,
    RANGE_TYPES,
    MapperService,
    ParsedDocument,
)


def pad_size(n: int) -> int:
    """Bucketed padding: multiples of 128 up to 1024, powers of two above."""
    n = max(n, 128)
    if n <= 1024:
        return ((n + 127) // 128) * 128
    p = 1024
    while p < n:
        p *= 2
    return p


def pad_window(n: int) -> int:
    """Bucketed postings-window length (per-term gather width)."""
    n = max(n, 8)
    p = 8
    while p < n:
        p *= 2
    return p


def split_i64(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int64 -> (hi, lo) int32 words; lexicographic (hi, lo-as-unsigned)
    compare preserves int64 ordering."""
    v = values.astype(np.int64)
    hi = (v >> 32).astype(np.int32)
    lo = (v & 0xFFFFFFFF).astype(np.uint32).astype(np.int64)
    # store lo with the sign-flip trick so signed int32 compare == unsigned
    lo = (lo - 0x80000000).astype(np.int32)
    return hi, lo


def i64_query_words(value: int) -> tuple[int, int]:
    """Encode a query-side int64 bound the same way as split_i64."""
    hi = int(np.int64(value) >> np.int64(32))
    lo = int((np.int64(value) & np.int64(0xFFFFFFFF)) - np.int64(0x80000000))
    return hi, lo


# --------------------------------------------------------------------------
# Host-side per-field column formats (numpy; persistable)
# --------------------------------------------------------------------------


@dataclass
class HostTextField:
    terms: list[str]                 # term_id -> term (sorted lexicographically)
    term_dict: dict[str, int]        # term -> term_id
    term_offsets: np.ndarray         # int64 [T+1] into postings arrays
    postings_docs: np.ndarray        # int32 [P]
    postings_tfs: np.ndarray         # float32 [P]
    doc_len: np.ndarray              # float32 [n_docs] (0 = field absent)
    total_terms: float               # sum(doc_len) — feeds shard-level avgdl
    docs_with_field: int
    # position postings: for postings entry p (one (term, doc) pair),
    # positions[pos_offsets[p]:pos_offsets[p+1]] are that term's token
    # positions in that doc, ascending (Lucene .prx analog; host-side —
    # phrase/interval verification is candidate-bounded host work)
    pos_offsets: np.ndarray = None   # int64 [P+1]
    positions: np.ndarray = None     # int32 [Q]

    def __post_init__(self) -> None:
        if self.pos_offsets is None:
            self.pos_offsets = np.zeros(len(self.postings_docs) + 1, np.int64)
        if self.positions is None:
            self.positions = np.zeros(0, np.int32)

    def doc_freq(self, term: str) -> int:
        tid = self.term_dict.get(term)
        if tid is None:
            return 0
        return int(self.term_offsets[tid + 1] - self.term_offsets[tid])

    def total_term_freq(self, term: str) -> int:
        """Sum of the term's frequencies across all docs (Lucene ttf)."""
        tid = self.term_dict.get(term)
        if tid is None:
            return 0
        off, end = int(self.term_offsets[tid]), int(self.term_offsets[tid + 1])
        return int(self.postings_tfs[off:end].sum())

    @property
    def sum_doc_freq(self) -> int:
        """Number of (term, doc) postings pairs (Lucene sumDocFreq)."""
        return int(len(self.postings_docs))

    def term_positions(self, term: str, doc: int) -> np.ndarray:
        """Token positions of `term` in local doc `doc` (empty if absent or
        the segment predates position postings)."""
        tid = self.term_dict.get(term)
        if tid is None or self.positions.size == 0:
            return np.zeros(0, np.int32)
        off = int(self.term_offsets[tid])
        end = int(self.term_offsets[tid + 1])
        p = off + int(np.searchsorted(self.postings_docs[off:end], doc))
        if p >= end or self.postings_docs[p] != doc:
            return np.zeros(0, np.int32)
        return self.positions[int(self.pos_offsets[p]): int(self.pos_offsets[p + 1])]

    @property
    def has_positions(self) -> bool:
        return self.positions.size > 0


@dataclass
class HostKeywordField:
    ord_values: list[str]            # ordinal -> value (sorted)
    ord_dict: dict[str, int]
    first_ord: np.ndarray            # int32 [n_docs], -1 = missing (sort key)
    mv_offsets: np.ndarray           # int32 [n_docs+1] CSR into mv_ords
    mv_ords: np.ndarray              # int32 [E] ordinals per doc (sorted per doc)
    mv_docs: np.ndarray              # int32 [E] owning doc of each entry


@dataclass
class HostNumericField:
    kind: str                        # "int" | "float"
    values_i64: np.ndarray | None    # int64 [n_docs] first value (sort key)
    values_f64: np.ndarray | None    # float64 [n_docs] first value (sort key)
    present: np.ndarray              # bool [n_docs]
    # multi-valued storage (SortedNumericDocValues analog): CSR over ALL
    # values per doc; None when every doc holds at most one value
    mv_offsets: np.ndarray | None = None   # int64 [n_docs+1]
    mv_values: np.ndarray | None = None    # int64/float64 [E]

    def doc_values(self, doc: int) -> np.ndarray:
        if self.mv_offsets is not None:
            return self.mv_values[
                int(self.mv_offsets[doc]): int(self.mv_offsets[doc + 1])
            ]
        if not self.present[doc]:
            return np.zeros(0, np.int64 if self.kind == "int" else np.float64)
        col = self.values_i64 if self.kind == "int" else self.values_f64
        return col[doc: doc + 1]


@dataclass
class HostVectorField:
    vectors: np.ndarray              # float32 [n_docs, dims]
    present: np.ndarray              # bool [n_docs]
    dims: int
    similarity: str
    method: dict | None = None       # ANN method config from the mapper


@dataclass
class HostSegment:
    """One sealed, immutable segment (host representation)."""

    name: str
    n_docs: int
    doc_ids: list[str]                       # local docid -> _id
    sources: list[bytes]                     # local docid -> _source JSON
    text_fields: dict[str, HostTextField] = dc_field(default_factory=dict)
    keyword_fields: dict[str, HostKeywordField] = dc_field(default_factory=dict)
    numeric_fields: dict[str, HostNumericField] = dc_field(default_factory=dict)
    vector_fields: dict[str, HostVectorField] = dc_field(default_factory=dict)
    # live docs bitmap — mutated by deletes, republished to device on refresh
    live: np.ndarray = dc_field(default_factory=lambda: np.zeros(0, bool))
    min_seq_no: int = -1
    max_seq_no: int = -1
    # per-doc seq_no/version captured at seal time: fetch under a pinned
    # snapshot must report the version of the doc it returns, not the live
    # version_map's (the reference stores these as doc-values)
    doc_seq_nos: np.ndarray = dc_field(default_factory=lambda: np.zeros(0, np.int64))
    doc_versions: np.ndarray = dc_field(default_factory=lambda: np.zeros(0, np.int64))
    # local docid -> custom _routing (None when routed by _id); the _routing
    # metadata field — hits must expose it so reindex/update_by_query can
    # address the owning shard (reference: RoutingFieldMapper stored field)
    doc_routings: list = dc_field(default_factory=list)
    # completion field -> {input value -> weight} (FST weight analog)
    completion_weights: dict = dc_field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.live.size == 0:
            self.live = np.ones(self.n_docs, dtype=bool)
        if self.doc_seq_nos.size == 0:
            self.doc_seq_nos = np.zeros(self.n_docs, np.int64)
        if self.doc_versions.size == 0:
            self.doc_versions = np.ones(self.n_docs, np.int64)
        if not self.doc_routings:
            self.doc_routings = [None] * self.n_docs
        self._id_to_doc = {id_: i for i, id_ in enumerate(self.doc_ids)}

    def local_doc(self, doc_id: str) -> int | None:
        d = self._id_to_doc.get(doc_id)
        if d is None or not self.live[d]:
            return None
        return d

    def doc_index(self, doc_id: str) -> int | None:
        """Id -> local doc WITHOUT the live check. Query execution must use
        this + the snapshot's device live mask: host `live` is mutated in
        place by deletes, so checking it here would leak post-snapshot
        deletes into pinned scroll/PIT readers."""
        return self._id_to_doc.get(doc_id)

    def delete_doc(self, doc_id: str) -> bool:
        d = self._id_to_doc.get(doc_id)
        if d is None or not self.live[d]:
            return False
        self.live[d] = False
        return True

    @property
    def live_count(self) -> int:
        return int(self.live.sum())


# --------------------------------------------------------------------------
# Builder: accumulates parsed docs, seals into a HostSegment
# --------------------------------------------------------------------------


class SegmentBuilder:
    """The in-memory indexing buffer (the IndexWriter RAM buffer analog)."""

    def __init__(self, mapper_service: MapperService, name: str):
        self.mapper_service = mapper_service
        self.name = name
        self.docs: list[ParsedDocument] = []
        self.seq_nos: list[int] = []

    def add(self, doc: ParsedDocument, seq_no: int) -> int:
        self.docs.append(doc)
        self.seq_nos.append(seq_no)
        return len(self.docs) - 1

    def __len__(self) -> int:
        return len(self.docs)

    @property
    def ram_docs(self) -> int:
        return len(self.docs)

    def build(self) -> HostSegment:
        if not self.docs:
            raise IllegalArgumentException("cannot build an empty segment")
        n = len(self.docs)
        seg = HostSegment(
            name=self.name,
            n_docs=n,
            doc_ids=[d.doc_id for d in self.docs],
            sources=[(d.source_json if d.source_json is not None
                      else json.dumps(d.source)).encode() for d in self.docs],
            min_seq_no=min(self.seq_nos),
            max_seq_no=max(self.seq_nos),
            doc_seq_nos=np.asarray(self.seq_nos, np.int64),
            doc_routings=[d.routing for d in self.docs],
        )
        for d in self.docs:
            for cf, weights in d.completion_weights.items():
                slot = seg.completion_weights.setdefault(cf, {})
                for val, w in weights.items():
                    slot[val] = max(slot.get(val, 0), w)
        mappers = self.mapper_service.mappers
        for fname, mapper in mappers.items():
            if mapper.type == "text":
                tf = self._build_text(fname, n)
                if tf is not None:
                    seg.text_fields[fname] = tf
            elif mapper.type in ("keyword", "flat_object"):
                kf = self._build_keyword(fname, n)
                if kf is not None:
                    seg.keyword_fields[fname] = kf
            elif (mapper.type in ("date", "boolean", "token_count")
                  or mapper.type in INT_TYPES):
                nf = self._build_numeric(fname, n, "int")
                if nf is not None:
                    seg.numeric_fields[fname] = nf
            elif mapper.type == "dense_vector":
                vf = self._build_vector(
                    fname, n, mapper.dims, mapper.similarity, mapper.method
                )
                if vf is not None:
                    seg.vector_fields[fname] = vf
            elif mapper.type == "rank_feature":
                nf = self._build_numeric(fname, n, "float")
                if nf is not None:
                    seg.numeric_fields[fname] = nf
            elif mapper.type in ("alias", "geo_point", "percolator", "join",
                                 "rank_features") \
                    or mapper.type in RANGE_TYPES:
                continue  # no direct column (aliases resolve below)
            else:  # float family
                nf = self._build_numeric(fname, n, "float")
                if nf is not None:
                    seg.numeric_fields[fname] = nf
        # field aliases share the target's columns by reference — queries,
        # sorts, and aggs then address the alias with zero executor changes
        for fname, mapper in mappers.items():
            if mapper.type != "alias" or not mapper.path:
                continue
            for store in (seg.text_fields, seg.keyword_fields,
                          seg.numeric_fields, seg.vector_fields):
                if mapper.path in store:
                    store[fname] = store[mapper.path]
        return seg

    def _build_text(self, fname: str, n: int) -> HostTextField | None:
        """The field's postings, sorted by (term_id, doc_id), with each
        pair's positions ascending (tf = their count): every token is one
        (term_id, doc, position) triple, sorted once. The same arrays as
        the reference's per-term walk (opensearch_tpu/index/segment.py)."""
        tok_terms: list[str] = []
        tok_pos: list[int] = []
        field_docs: list[int] = []
        doc_tokens: list[int] = []
        for d, doc in enumerate(self.docs):
            pf = doc.fields.get(fname)
            if pf is None or pf.terms is None:
                continue
            field_docs.append(d)
            doc_tokens.append(len(pf.terms))
            tok_terms.extend(pf.terms)
            tok_pos.extend(pf.positions if pf.positions is not None
                           and len(pf.positions) == len(pf.terms)
                           else range(len(pf.terms)))
        if not field_docs:
            return None
        terms = sorted(set(tok_terms))
        term_dict = {t: i for i, t in enumerate(terms)}
        tid = np.fromiter(map(term_dict.__getitem__, tok_terms), np.int64,
                          len(tok_terms))
        tdoc = np.repeat(np.asarray(field_docs, np.int64),
                         np.asarray(doc_tokens, np.int64))
        tpos = np.asarray(tok_pos, np.int64)
        order = np.lexsort((tpos, tdoc, tid))
        tid, tdoc, tpos = tid[order], tdoc[order], tpos[order]
        # one postings entry a (term, doc) run
        first = np.ones(len(tid), bool)
        first[1:] = (tid[1:] != tid[:-1]) | (tdoc[1:] != tdoc[:-1])
        starts = np.flatnonzero(first)
        pos_offsets = np.append(starts, len(tid)).astype(np.int64)
        offsets = np.zeros(len(terms) + 1, dtype=np.int64)
        np.cumsum(np.bincount(tid[starts], minlength=len(terms)),
                  out=offsets[1:])
        doc_len = np.bincount(tdoc, minlength=n)[:n].astype(np.float32)
        return HostTextField(
            terms=terms,
            term_dict=term_dict,
            term_offsets=offsets,
            postings_docs=tdoc[starts].astype(np.int32),
            postings_tfs=np.diff(pos_offsets).astype(np.float32),
            doc_len=doc_len,
            total_terms=float(doc_len.sum()),
            docs_with_field=len(field_docs),
            pos_offsets=pos_offsets,
            positions=tpos.astype(np.int32),
        )

    def _build_keyword(self, fname: str, n: int) -> HostKeywordField | None:
        per_doc: list[list[str]] = []
        any_field = False
        for doc in self.docs:
            pf = doc.fields.get(fname)
            vals = pf.exact if pf is not None and pf.exact else []
            if vals:
                any_field = True
            per_doc.append(vals)
        if not any_field:
            return None
        ord_values = sorted({v for vals in per_doc for v in vals})
        ord_dict = {v: i for i, v in enumerate(ord_values)}
        first_ord = np.full(n, -1, dtype=np.int32)
        mv_offsets = np.zeros(n + 1, dtype=np.int32)
        flat_ords: list[int] = []
        flat_docs: list[int] = []
        for d, vals in enumerate(per_doc):
            ords = sorted(ord_dict[v] for v in vals)
            if ords:
                first_ord[d] = ords[0]
            flat_ords.extend(ords)
            flat_docs.extend([d] * len(ords))
            mv_offsets[d + 1] = mv_offsets[d] + len(ords)
        return HostKeywordField(
            ord_values=ord_values,
            ord_dict=ord_dict,
            first_ord=first_ord,
            mv_offsets=mv_offsets,
            mv_ords=np.asarray(flat_ords, dtype=np.int32),
            mv_docs=np.asarray(flat_docs, dtype=np.int32),
        )

    def _build_numeric(self, fname: str, n: int, kind: str) -> HostNumericField | None:
        present = np.zeros(n, dtype=bool)
        dtype = np.int64 if kind == "int" else np.float64
        vals = np.zeros(n, dtype=dtype)
        mv_offsets = np.zeros(n + 1, dtype=np.int64)
        flat: list = []
        any_field = False
        any_multi = False
        for d, doc in enumerate(self.docs):
            pf = doc.fields.get(fname)
            nums = pf.numeric if pf is not None and pf.numeric else []
            if nums:
                any_field = True
                present[d] = True
                # first value is the sort key (SortedNumericDocValues MIN
                # mode analog); the CSR keeps every value for matching
                vals[d] = int(nums[0]) if kind == "int" else nums[0]
                if len(nums) > 1:
                    any_multi = True
                flat.extend(int(v) if kind == "int" else v for v in nums)
            mv_offsets[d + 1] = mv_offsets[d] + len(nums)
        if not any_field:
            return None
        return HostNumericField(
            kind=kind,
            values_i64=vals if kind == "int" else None,
            values_f64=vals if kind == "float" else None,
            present=present,
            mv_offsets=mv_offsets if any_multi else None,
            mv_values=np.asarray(flat, dtype=dtype) if any_multi else None,
        )

    def _build_vector(
        self, fname: str, n: int, dims: int, similarity: str,
        method: dict | None = None,
    ) -> HostVectorField | None:
        present = np.zeros(n, dtype=bool)
        mat = np.zeros((n, dims), dtype=np.float32)
        any_field = False
        for d, doc in enumerate(self.docs):
            pf = doc.fields.get(fname)
            if pf is None or pf.vector is None:
                continue
            any_field = True
            present[d] = True
            mat[d] = np.asarray(pf.vector, dtype=np.float32)
        if not any_field:
            return None
        return HostVectorField(
            vectors=mat, present=present, dims=dims, similarity=similarity,
            method=method,
        )


# --------------------------------------------------------------------------
# Persistence (flush/commit writes segments to disk; recovery reads them)
# --------------------------------------------------------------------------


def save_segment(seg: HostSegment, directory: Path,
                 compress: bool = True) -> None:
    """Persist one sealed segment as {name}.json/{name}.npz/{name}.sources."""
    directory.mkdir(parents=True, exist_ok=True)
    meta, arrays, sources = segment_payload(seg)
    if compress:
        np.savez_compressed(directory / f"{seg.name}.npz", **arrays)
    else:
        np.savez(directory / f"{seg.name}.npz", **arrays)
    (directory / f"{seg.name}.json").write_text(json.dumps(meta))
    (directory / f"{seg.name}.sources").write_bytes(sources)


def segment_payload(
    seg: HostSegment,
) -> tuple[dict, dict[str, np.ndarray], bytes]:
    """(meta, arrays, sources_blob) — the serializable form shared by the
    on-disk store and the wire packer."""
    arrays: dict[str, np.ndarray] = {
        "live": seg.live,
        "doc_seq_nos": seg.doc_seq_nos,
        "doc_versions": seg.doc_versions,
    }
    meta: dict[str, Any] = {
        "name": seg.name,
        "n_docs": seg.n_docs,
        "doc_ids": seg.doc_ids,
        "doc_routings": seg.doc_routings,
        "completion_weights": seg.completion_weights,
        "min_seq_no": seg.min_seq_no,
        "max_seq_no": seg.max_seq_no,
        "text_fields": {},
        "keyword_fields": {},
        "numeric_fields": {},
        "vector_fields": {},
        # alias columns (shared by reference, see SegmentBuilder.build) are
        # serialized once under the canonical name; load re-links them
        "field_links": {},
    }
    seen_objs: dict[int, str] = {}

    def _link(fname: str, obj: Any) -> bool:
        canonical = seen_objs.get(id(obj))
        if canonical is not None:
            meta["field_links"][fname] = canonical
            return True
        seen_objs[id(obj)] = fname
        return False

    for fname, tf in seg.text_fields.items():
        if _link(fname, tf):
            continue
        key = f"text:{fname}"
        arrays[f"{key}:offsets"] = tf.term_offsets
        # postings doc ids are stored zigzag-delta varint encoded (the
        # native codec, ~1 byte/doc on ascending runs — Lucene's varint
        # postings analog); ":docs_vint" presence selects the format
        from opensearch_tpu_torch import native as _native

        arrays[f"{key}:docs_vint"] = np.frombuffer(
            _native.varint_encode(tf.postings_docs), dtype=np.uint8
        )
        arrays[f"{key}:tfs"] = tf.postings_tfs
        arrays[f"{key}:doc_len"] = tf.doc_len
        arrays[f"{key}:pos_offsets"] = tf.pos_offsets
        arrays[f"{key}:positions"] = tf.positions
        meta["text_fields"][fname] = {
            "terms": tf.terms,
            "total_terms": tf.total_terms,
            "docs_with_field": tf.docs_with_field,
        }
    for fname, kf in seg.keyword_fields.items():
        if _link(fname, kf):
            continue
        key = f"kw:{fname}"
        arrays[f"{key}:first_ord"] = kf.first_ord
        arrays[f"{key}:mv_offsets"] = kf.mv_offsets
        arrays[f"{key}:mv_ords"] = kf.mv_ords
        arrays[f"{key}:mv_docs"] = kf.mv_docs
        meta["keyword_fields"][fname] = {"ord_values": kf.ord_values}
    for fname, nf in seg.numeric_fields.items():
        if _link(fname, nf):
            continue
        key = f"num:{fname}"
        arrays[f"{key}:values"] = (
            nf.values_i64 if nf.kind == "int" else nf.values_f64
        )
        arrays[f"{key}:present"] = nf.present
        if nf.mv_offsets is not None:
            arrays[f"{key}:mv_offsets"] = nf.mv_offsets
            arrays[f"{key}:mv_values"] = nf.mv_values
        meta["numeric_fields"][fname] = {"kind": nf.kind}
    for fname, vf in seg.vector_fields.items():
        if _link(fname, vf):
            continue
        key = f"vec:{fname}"
        arrays[f"{key}:vectors"] = vf.vectors
        arrays[f"{key}:present"] = vf.present
        meta["vector_fields"][fname] = {
            "dims": vf.dims, "similarity": vf.similarity, "method": vf.method,
        }
    import io as _io

    src_buf = _io.BytesIO()
    for src in seg.sources:
        src_buf.write(len(src).to_bytes(4, "little"))
        src_buf.write(src)
    return meta, arrays, src_buf.getvalue()


def _load_postings_docs(arrays, key: str):
    if f"{key}:docs_vint" in arrays:
        from opensearch_tpu_torch import native as _native

        return _native.varint_decode(arrays[f"{key}:docs_vint"].tobytes())
    return arrays[f"{key}:docs"]  # legacy raw-int32 format


def load_segment(directory: Path, name: str) -> HostSegment:
    meta = json.loads((directory / f"{name}.json").read_text())
    arrays = np.load(directory / f"{name}.npz", allow_pickle=False)
    sources = _parse_sources((directory / f"{name}.sources").read_bytes())
    return segment_from_payload(meta, arrays, sources)


def _parse_sources(blob: bytes) -> list[bytes]:
    sources: list[bytes] = []
    pos = 0
    n = len(blob)
    while pos < n:
        size = int.from_bytes(blob[pos: pos + 4], "little")
        pos += 4
        sources.append(blob[pos: pos + size])
        pos += size
    return sources


def segment_from_payload(meta: dict, arrays, sources: list[bytes]) -> HostSegment:
    seg = HostSegment(
        name=meta["name"],
        n_docs=meta["n_docs"],
        doc_ids=meta["doc_ids"],
        sources=sources,
        live=arrays["live"].copy(),
        min_seq_no=meta["min_seq_no"],
        max_seq_no=meta["max_seq_no"],
        doc_seq_nos=(arrays["doc_seq_nos"].copy() if "doc_seq_nos" in arrays
                     else np.zeros(0, np.int64)),
        doc_versions=(arrays["doc_versions"].copy() if "doc_versions" in arrays
                      else np.zeros(0, np.int64)),
        doc_routings=meta.get("doc_routings") or [],
        completion_weights=meta.get("completion_weights") or {},
    )
    for fname, m in meta["text_fields"].items():
        key = f"text:{fname}"
        terms = m["terms"]
        seg.text_fields[fname] = HostTextField(
            terms=terms,
            term_dict={t: i for i, t in enumerate(terms)},
            term_offsets=arrays[f"{key}:offsets"],
            postings_docs=_load_postings_docs(arrays, key),
            postings_tfs=arrays[f"{key}:tfs"],
            doc_len=arrays[f"{key}:doc_len"],
            total_terms=m["total_terms"],
            docs_with_field=m["docs_with_field"],
            pos_offsets=(arrays[f"{key}:pos_offsets"]
                         if f"{key}:pos_offsets" in arrays else None),
            positions=(arrays[f"{key}:positions"]
                       if f"{key}:positions" in arrays else None),
        )
    for fname, m in meta["keyword_fields"].items():
        key = f"kw:{fname}"
        ord_values = m["ord_values"]
        seg.keyword_fields[fname] = HostKeywordField(
            ord_values=ord_values,
            ord_dict={v: i for i, v in enumerate(ord_values)},
            first_ord=arrays[f"{key}:first_ord"],
            mv_offsets=arrays[f"{key}:mv_offsets"],
            mv_ords=arrays[f"{key}:mv_ords"],
            mv_docs=arrays[f"{key}:mv_docs"],
        )
    for fname, m in meta["numeric_fields"].items():
        key = f"num:{fname}"
        vals = arrays[f"{key}:values"]
        seg.numeric_fields[fname] = HostNumericField(
            kind=m["kind"],
            values_i64=vals if m["kind"] == "int" else None,
            values_f64=vals if m["kind"] == "float" else None,
            present=arrays[f"{key}:present"],
            mv_offsets=(arrays[f"{key}:mv_offsets"]
                        if f"{key}:mv_offsets" in arrays else None),
            mv_values=(arrays[f"{key}:mv_values"]
                       if f"{key}:mv_values" in arrays else None),
        )
    for fname, m in meta["vector_fields"].items():
        key = f"vec:{fname}"
        seg.vector_fields[fname] = HostVectorField(
            vectors=arrays[f"{key}:vectors"],
            present=arrays[f"{key}:present"],
            dims=m["dims"],
            similarity=m["similarity"],
            method=m.get("method"),
        )
    # re-link alias columns (serialized once under the canonical name)
    for fname, target in (meta.get("field_links") or {}).items():
        for store in (seg.text_fields, seg.keyword_fields,
                      seg.numeric_fields, seg.vector_fields):
            if target in store:
                store[fname] = store[target]
                break
    return seg


# -- wire packing (segment replication / file-based peer recovery) ----------
#
# The sealed-segment files (.json meta, .npz arrays, .sources) ARE the
# replication unit (indices/replication/ in the reference ships Lucene
# files; here the immutable array bundle ships as its three files packed
# into one binary blob). Packing goes through save_segment/load_segment so
# the bytes a replica receives are byte-identical to what a local flush
# would have written — a replica can flush them straight back out.


def pack_segment(seg: HostSegment) -> bytes:
    """Serialize one sealed segment to a single binary blob, fully in
    memory (no disk round-trip on the replication hot path). The blob's
    parts are byte-identical to the on-disk files, so a replica may
    persist them verbatim. Uncompressed: loopback/ICI bandwidth is
    plentiful and zlib on 100k-doc columns costs seconds."""
    import io

    meta, arrays, sources = segment_payload(seg)
    npz_buf = io.BytesIO()
    np.savez(npz_buf, **arrays)
    parts = [
        (".json", json.dumps(meta).encode()),
        (".npz", npz_buf.getvalue()),
        (".sources", sources),
    ]
    out = io.BytesIO()
    header = json.dumps(
        {"name": seg.name, "files": [[s, len(b)] for s, b in parts]}
    ).encode()
    out.write(len(header).to_bytes(4, "little"))
    out.write(header)
    for _suffix, data in parts:
        out.write(data)
    return out.getvalue()


def unpack_segment(blob: bytes, directory: Path | None = None) -> HostSegment:
    """Deserialize a packed segment in memory; optionally also persist its
    files into `directory` (the replica's segment store) so a later
    commit/recovery finds them without a re-send."""
    import io

    hlen = int.from_bytes(blob[:4], "little")
    header = json.loads(blob[4: 4 + hlen])
    pos = 4 + hlen
    files: dict[str, bytes] = {}
    for suffix, size in header["files"]:
        files[suffix] = blob[pos: pos + size]
        pos += size
    if directory is not None:
        directory.mkdir(parents=True, exist_ok=True)
        for suffix, data in files.items():
            (directory / f"{header['name']}{suffix}").write_bytes(data)
    meta = json.loads(files[".json"])
    arrays = np.load(io.BytesIO(files[".npz"]), allow_pickle=False)
    return segment_from_payload(meta, arrays, _parse_sources(files[".sources"]))
