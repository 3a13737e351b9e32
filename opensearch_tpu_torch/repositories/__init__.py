"""Repositories: blob-store persistence for snapshots.

Counterpart of opensearch_tpu/repositories/, a host copy.

The analog of server/.../repositories/ (Repository SPI,
blobstore/BlobStoreRepository.java:216 — content-addressed incremental
segment-file dedup under a root RepositoryData manifest) with the
filesystem implementation (fs/FsRepository). Cloud backends (S3/Azure/GCS)
plug in behind the same BlobStore interface.
"""

from opensearch_tpu_torch.repositories.blobstore import BlobStore, FsBlobStore

__all__ = ["BlobStore", "FsBlobStore"]
