"""Checkpointing of the port (``repro.checkpoint``'s counterpart)."""

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
