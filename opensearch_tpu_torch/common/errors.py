"""Exception hierarchy with REST status mapping.

The analog of OpenSearchException + RestStatus
(libs/core/src/main/java/org/opensearch/OpenSearchException.java,
core/rest/RestStatus.java): every engine error carries an HTTP status and a
stable `type` string so the REST layer can render the same error envelope
({"error": {"type": ..., "reason": ...}, "status": N}) the reference does.
"""

from __future__ import annotations


class OpenSearchTpuException(Exception):
    status = 500
    error_type = "exception"

    def __init__(self, reason: str, **metadata):
        super().__init__(reason)
        self.reason = reason
        self.metadata = metadata

    def to_dict(self) -> dict:
        body = {"type": self.error_type, "reason": self.reason}
        cause = self.__cause__
        if cause is not None:
            body["caused_by"] = {
                "type": getattr(cause, "error_type",
                                type(cause).__name__.lower()),
                "reason": str(cause),
            }
        body.update(self.metadata)
        return body


class ActionRequestValidationException(OpenSearchTpuException):
    status = 400
    error_type = "action_request_validation_exception"


class InputCoercionException(OpenSearchTpuException):
    """Jackson's InputCoercionException surface: numeric JSON values that
    overflow the declared java type (e.g. size: 2^31)."""

    status = 400
    error_type = "input_coercion_exception"


class ParsingException(OpenSearchTpuException):
    status = 400
    error_type = "parsing_exception"


class ParseException(OpenSearchTpuException):
    """Generic content-parse failure (common.ParsingException vs the
    x-content ParseException type string)."""

    status = 400
    error_type = "parse_exception"


class IllegalArgumentException(OpenSearchTpuException):
    status = 400
    error_type = "illegal_argument_exception"


class MapperParsingException(OpenSearchTpuException):
    status = 400
    error_type = "mapper_parsing_exception"


class StrictDynamicMappingException(MapperParsingException):
    error_type = "strict_dynamic_mapping_exception"


class IllegalStateException(OpenSearchTpuException):
    status = 500
    error_type = "illegal_state_exception"


class IndexNotFoundException(OpenSearchTpuException):
    status = 404
    error_type = "index_not_found_exception"

    def __init__(self, index: str):
        super().__init__(
            f"no such index [{index}]",
            **{"resource.type": "index_or_alias", "resource.id": index, "index": index},
        )
        self.index = index


class IndexClosedException(OpenSearchTpuException):
    status = 400
    error_type = "index_closed_exception"

    def __init__(self, index: str):
        super().__init__(f"closed index [{index}]", index=index)
        self.index = index


class SnapshotMissingException(OpenSearchTpuException):
    status = 404
    error_type = "snapshot_missing_exception"

    def __init__(self, repo: str, snapshot: str):
        super().__init__(f"[{repo}:{snapshot}] is missing")


class ResourceNotFoundException(OpenSearchTpuException):
    status = 404
    error_type = "resource_not_found_exception"


class ResourceAlreadyExistsException(OpenSearchTpuException):
    status = 400
    error_type = "resource_already_exists_exception"


class DocumentMissingException(OpenSearchTpuException):
    status = 404
    error_type = "document_missing_exception"


class VersionConflictException(OpenSearchTpuException):
    status = 409
    error_type = "version_conflict_engine_exception"


class ShardNotFoundException(OpenSearchTpuException):
    status = 404
    error_type = "shard_not_found_exception"


class SearchPhaseExecutionException(OpenSearchTpuException):
    status = 500
    error_type = "search_phase_execution_exception"


class SearchContextMissingException(OpenSearchTpuException):
    """Expired/unknown scroll or PIT id (search/SearchContextMissingException)."""

    status = 404
    error_type = "search_context_missing_exception"


class TaskCancelledException(OpenSearchTpuException):
    status = 400
    error_type = "task_cancelled_exception"


class CircuitBreakingException(OpenSearchTpuException):
    status = 429
    error_type = "circuit_breaking_exception"


class RejectedExecutionException(OpenSearchTpuException):
    status = 429
    error_type = "rejected_execution_exception"


class ClusterBlockException(OpenSearchTpuException):
    status = 503
    error_type = "cluster_block_exception"


class NotClusterManagerException(OpenSearchTpuException):
    status = 503
    error_type = "not_cluster_manager_exception"


class ConnectTransportException(OpenSearchTpuException):
    status = 503
    error_type = "connect_transport_exception"


class ActionNotFoundException(OpenSearchTpuException):
    status = 400
    error_type = "action_not_found_transport_exception"
