"""Translog: the per-shard write-ahead log.

Reimplements the durability model of the reference's translog
(server/src/main/java/org/opensearch/index/translog/Translog.java:119,
add:606): every accepted operation is serialized and appended to the current
generation file before being acknowledged; a `Checkpoint` sidecar records the
fsynced (generation, offset, op-count, max_seq_no) so crash recovery knows
exactly how much of the log is trustworthy; `rollGeneration` starts a new
file at flush time and `trim` drops generations whose ops are safely in
committed segments.

Record format (binary, checksummed like the reference's):
    [u32 len][u32 crc32(payload)][payload = JSON utf-8]
Payload: {"op": "index"|"delete", "id", "seq_no", "version", "source"?, "routing"?}
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass, field as dc_field
from pathlib import Path
from typing import Any, Iterator

from opensearch_tpu_torch.common.errors import OpenSearchTpuException


class TranslogCorruptedException(OpenSearchTpuException):
    error_type = "translog_corrupted_exception"


_HEADER = struct.Struct("<II")
CHECKPOINT_FILE = "translog.ckp"


@dataclass
class Checkpoint:
    generation: int
    offset: int          # fsynced byte offset in the current generation
    num_ops: int         # ops in the current generation
    max_seq_no: int
    min_generation: int  # oldest generation still needed for recovery
    # sealed generations' max seq_no ("gen" -> max_seq_no at roll time):
    # lets retention-lease trimming keep exactly the generations whose ops
    # a lease may still need (TranslogDeletionPolicy.minTranslogGenRequired)
    gen_max_seq: dict = dc_field(default_factory=dict)

    def to_bytes(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @staticmethod
    def from_bytes(data: bytes) -> "Checkpoint":
        return Checkpoint(**json.loads(data))


class Translog:
    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        ckp_path = self.dir / CHECKPOINT_FILE
        if ckp_path.exists():
            self.checkpoint = Checkpoint.from_bytes(ckp_path.read_bytes())
        else:
            self.checkpoint = Checkpoint(
                generation=1, offset=0, num_ops=0, max_seq_no=-1, min_generation=1
            )
            self._write_checkpoint()
        self._open_writer()

    def _open_writer(self) -> None:
        """Native C++ buffered writer when available (the reference's WAL
        append runs on the JVM's intrinsified channel path; ours is
        native/tlog_codec.cpp), else a Python file. Both truncate to the
        checkpoint offset — a crash may have left unsynced garbage."""
        from opensearch_tpu_torch import native

        path = self._gen_path(self.checkpoint.generation)
        if native.native_available():
            self._native = native.NativeTlogWriter(path, self.checkpoint.offset)
            self._file = None
        else:
            self._native = None
            self._file = open(path, "ab")
            self._file.truncate(self.checkpoint.offset)
            self._file.seek(self.checkpoint.offset)

    def _gen_path(self, gen: int) -> Path:
        return self.dir / f"translog-{gen}.tlog"

    def _write_checkpoint(self) -> None:
        # node close() (server loop thread) can race an in-flight write's
        # per-request sync (data worker): per-thread tmp names keep each
        # atomic replace self-contained instead of stealing a shared tmp
        # (observed as FileNotFoundError in os.replace). Either content is
        # a valid checkpoint; the later replace wins, and crash replay is
        # seq_no-idempotent past a slightly stale offset.
        import threading as _threading

        tmp = self.dir / f"{CHECKPOINT_FILE}.{_threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            f.write(self.checkpoint.to_bytes())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.dir / CHECKPOINT_FILE)

    # -- write path --------------------------------------------------------

    def add(self, op: dict[str, Any]) -> int:
        """Append one op; returns its byte location. Caller syncs (per
        request by default, like index.translog.durability=REQUEST)."""
        return self.add_payload(json.dumps(op).encode(),
                                int(op.get("seq_no", -1)))

    def add_payload(self, payload: bytes, seq_no: int) -> int:
        """Append one op already encoded as ``json.dumps(op).encode()``
        (the engine encodes a document's source once, for the translog and
        the segment)."""
        if self._native is not None:
            location = self._native.append(payload)
        else:
            record = _HEADER.pack(len(payload), zlib.crc32(payload)) + payload
            location = self._file.tell()
            self._file.write(record)
        self.checkpoint.num_ops += 1
        if seq_no > self.checkpoint.max_seq_no:
            self.checkpoint.max_seq_no = seq_no
        return location

    def sync(self) -> None:
        if self._native is not None:
            self._native.sync()
            self.checkpoint.offset = self._native.tell()
        else:
            self._file.flush()
            os.fsync(self._file.fileno())
            self.checkpoint.offset = self._file.tell()
        self._write_checkpoint()

    def roll_generation(self) -> None:
        """Seal the current generation and start a new one (flush path)."""
        self.sync()
        self._close_writer()
        sealed = dict(self.checkpoint.gen_max_seq)
        sealed[str(self.checkpoint.generation)] = self.checkpoint.max_seq_no
        self.checkpoint = Checkpoint(
            generation=self.checkpoint.generation + 1,
            offset=0,
            num_ops=0,
            max_seq_no=self.checkpoint.max_seq_no,
            min_generation=self.checkpoint.min_generation,
            gen_max_seq=sealed,
        )
        self._open_writer()
        self._write_checkpoint()

    def _close_writer(self) -> None:
        if self._native is not None:
            self._native.close()
            self._native = None
        if self._file is not None:
            self._file.close()
            self._file = None

    def trim_below(self, generation: int,
                   min_retained_seq: int | None = None) -> None:
        """Delete generations < generation (their ops are in committed
        segments). With `min_retained_seq` (a retention lease's floor),
        generations that may still hold ops >= that seq_no survive the
        trim. Mirrors TranslogDeletionPolicy."""
        if min_retained_seq is not None:
            # a sealed generation is deletable only when everything in it
            # is below the retained floor; generations without a recorded
            # max (pre-upgrade) are conservatively kept
            for gen in range(self.checkpoint.min_generation, generation):
                gmax = self.checkpoint.gen_max_seq.get(str(gen))
                if gmax is None or gmax >= min_retained_seq:
                    generation = gen
                    break
        for gen in range(self.checkpoint.min_generation, generation):
            path = self._gen_path(gen)
            if path.exists():
                path.unlink()
            self.checkpoint.gen_max_seq.pop(str(gen), None)
        self.checkpoint.min_generation = max(self.checkpoint.min_generation, generation)
        self._write_checkpoint()

    # -- recovery ----------------------------------------------------------

    def read_ops(self, from_generation: int | None = None) -> Iterator[dict[str, Any]]:
        """Replay ops from `from_generation` (default: oldest retained)
        through the fsynced tail of the current generation."""
        start = from_generation or self.checkpoint.min_generation
        for gen in range(start, self.checkpoint.generation + 1):
            path = self._gen_path(gen)
            if not path.exists():
                continue
            limit = (
                self.checkpoint.offset
                if gen == self.checkpoint.generation
                else None
            )
            yield from self._read_file(path, limit)

    def _read_file(self, path: Path, limit: int | None) -> Iterator[dict[str, Any]]:
        with open(path, "rb") as f:
            data = f.read() if limit is None else f.read(limit)
        pos = 0
        while pos + _HEADER.size <= len(data):
            length, crc = _HEADER.unpack_from(data, pos)
            pos += _HEADER.size
            if pos + length > len(data):
                break  # torn tail write past checkpoint — ignore
            payload = data[pos : pos + length]
            if zlib.crc32(payload) != crc:
                raise TranslogCorruptedException(
                    f"translog record at {path}:{pos} failed checksum"
                )
            pos += length
            yield json.loads(payload)

    @property
    def current_generation(self) -> int:
        return self.checkpoint.generation

    def stats(self) -> dict:
        size = 0
        for g in range(self.checkpoint.min_generation,
                       self.checkpoint.generation + 1):
            p = self._gen_path(g)
            if p.exists():
                size += p.stat().st_size
        # the checkpoint file counts toward translog size like the
        # reference's Translog.sizeInBytes (header + ckp accounting)
        ckp = self.dir / CHECKPOINT_FILE
        if ckp.exists():
            size += ckp.stat().st_size
        return {
            "operations": self.checkpoint.num_ops,
            "generation": self.checkpoint.generation,
            "size_in_bytes": size,
            "uncommitted_operations": self.checkpoint.num_ops,
            "uncommitted_size_in_bytes": size,
            "earliest_last_modified_age": 0,
        }

    def close(self) -> None:
        self.sync()
        self._close_writer()
