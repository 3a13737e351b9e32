"""Content-addressed blob store over a directory tree (counterpart of
opensearch_tpu/repositories/blobstore.py, a host copy).

The analog of common/blobstore/ (BlobContainer SPI) + the
content-addressed file dedup of BlobStoreRepository: segment files are
stored once per content hash; snapshots reference hashes, so unchanged
files cost nothing in later snapshots (incremental semantics,
BlobStoreRepository.java:216)."""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Any


class BlobStore:
    """Minimal blob interface: named JSON documents + content-addressed
    binary blobs."""

    def put_json(self, name: str, doc: Any) -> None:
        raise NotImplementedError

    def get_json(self, name: str) -> Any:
        raise NotImplementedError

    def delete_json(self, name: str) -> None:
        raise NotImplementedError

    def list_json(self, prefix: str) -> list[str]:
        raise NotImplementedError

    def put_blob(self, data: bytes) -> str:
        """Store content-addressed; returns the hash key."""
        raise NotImplementedError

    def get_blob(self, key: str) -> bytes:
        raise NotImplementedError

    def has_blob(self, key: str) -> bool:
        raise NotImplementedError

    def delete_blob(self, key: str) -> None:
        raise NotImplementedError

    def list_blobs(self) -> list[str]:
        raise NotImplementedError


class FsBlobStore(BlobStore):
    """Filesystem repository (fs/FsRepository analog). Writes are
    atomic-rename so a crashed snapshot never corrupts earlier ones."""

    def __init__(self, location: str | Path):
        self.root = Path(location)
        (self.root / "blobs").mkdir(parents=True, exist_ok=True)
        (self.root / "meta").mkdir(parents=True, exist_ok=True)

    def _json_path(self, name: str) -> Path:
        return self.root / "meta" / f"{name}.json"

    def put_json(self, name: str, doc: Any) -> None:
        path = self._json_path(name)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def get_json(self, name: str) -> Any:
        path = self._json_path(name)
        if not path.exists():
            return None
        return json.loads(path.read_text())

    def delete_json(self, name: str) -> None:
        path = self._json_path(name)
        if path.exists():
            path.unlink()

    def list_json(self, prefix: str) -> list[str]:
        base = self.root / "meta"
        out = []
        for p in base.rglob("*.json"):
            rel = str(p.relative_to(base))[: -len(".json")]
            if rel.startswith(prefix):
                out.append(rel)
        return sorted(out)

    def _blob_path(self, key: str) -> Path:
        return self.root / "blobs" / key[:2] / key

    def put_blob(self, data: bytes) -> str:
        key = hashlib.sha256(data).hexdigest()
        path = self._blob_path(key)
        if path.exists():
            return key  # dedup hit: identical content already stored
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(data)
        os.replace(tmp, path)
        return key

    def get_blob(self, key: str) -> bytes:
        return self._blob_path(key).read_bytes()

    def has_blob(self, key: str) -> bool:
        return self._blob_path(key).exists()

    def delete_blob(self, key: str) -> None:
        path = self._blob_path(key)
        if path.exists():
            path.unlink()

    def list_blobs(self) -> list[str]:
        return sorted(p.name for p in (self.root / "blobs").rglob("*")
                      if p.is_file())
