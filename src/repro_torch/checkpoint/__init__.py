"""Checkpoints in ``repro``'s on-disk format and the weight and state
bridge between ``repro``'s layout and the port's."""
from repro_torch.checkpoint.checkpoint import (CheckpointCorruptError,
                                               latest_step, restore, save,
                                               unflatten)

__all__ = ["save", "restore", "latest_step", "unflatten",
           "CheckpointCorruptError"]
