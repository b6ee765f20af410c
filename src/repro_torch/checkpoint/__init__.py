"""Checkpoints (port of ``src/repro/checkpoint``)."""
from repro_torch.checkpoint.checkpoint import CheckpointManager

__all__ = ["CheckpointManager"]
