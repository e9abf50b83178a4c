"""Atomic checkpoints with a CRC manifest (the reference's
`repro.checkpoint`, same on-disk layout)."""
from .store import (CheckpointManager, complete_steps, latest_step,
                    restore_checkpoint, save_checkpoint, verify_checkpoint)

__all__ = ["CheckpointManager", "complete_steps", "latest_step",
           "restore_checkpoint", "save_checkpoint", "verify_checkpoint"]
