from opensearch_tpu_torch.tasks.manager import Task, TaskManager

__all__ = ["Task", "TaskManager"]
