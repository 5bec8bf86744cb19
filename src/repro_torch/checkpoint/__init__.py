"""Checkpoints: atomic npz snapshots of trees of tensors, with step
management and a fallback past torn files."""
from .store import (TORN_CHECKPOINT_ERRORS, CheckpointManager, restore_tree,
                    save_tree)

__all__ = ["CheckpointManager", "TORN_CHECKPOINT_ERRORS", "restore_tree",
           "save_tree"]
