from opensearch_tpu_torch.script.service import ScriptService, default_script_service

__all__ = ["ScriptService", "default_script_service"]
