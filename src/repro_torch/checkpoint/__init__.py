from .async_ckpt import CheckpointManager, flatten_with_paths

__all__ = ["CheckpointManager", "flatten_with_paths"]
