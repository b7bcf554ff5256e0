"""Checkpoint substrate of the port (the JAX package's file layout)."""

from .checkpoint import (  # noqa: F401
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
