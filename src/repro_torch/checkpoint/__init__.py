"""Atomic, async-capable checkpoints of the port's trees."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
