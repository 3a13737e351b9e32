from opensearch_tpu_torch.reindex.service import (
    delete_by_query,
    reindex,
    update_by_query,
)

__all__ = ["reindex", "update_by_query", "delete_by_query"]
