"""Ingest pipelines: node-side document transforms before indexing.

The analog of the reference's ingest/ package (IngestService.java:118,
Pipeline/Processor SPI, ~35 processors in modules/ingest-common) plus the
grok/dissect parsing libraries (libs/grok, libs/dissect).
"""

from opensearch_tpu_torch.ingest.document import IngestDocument
from opensearch_tpu_torch.ingest.service import IngestService, Pipeline

__all__ = ["IngestDocument", "IngestService", "Pipeline"]
