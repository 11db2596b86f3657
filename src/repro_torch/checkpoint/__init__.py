"""Checkpointing: atomic pytree save/restore, in the reference's layout."""

from repro_torch.checkpoint.checkpoint import (
    CheckpointManager,
    committed_steps,
    load_checkpoint,
    save_checkpoint,
    step_path,
)

__all__ = ["CheckpointManager", "committed_steps", "load_checkpoint",
           "save_checkpoint", "step_path"]
