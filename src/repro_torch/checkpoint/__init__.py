# Fault-tolerant checkpointing (counterpart of repro.checkpoint, in its file format).
from .manager import CheckpointManager, restore_resharded

__all__ = ["CheckpointManager", "restore_resharded"]
