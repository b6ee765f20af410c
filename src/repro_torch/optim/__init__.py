"""Optimizers and schedules (port of ``src/repro/optim``)."""
from repro_torch.optim.optimizer import (
    AdamW, SGDM, clip_by_global_norm, global_norm)
from repro_torch.optim import schedules

__all__ = ["AdamW", "SGDM", "clip_by_global_norm", "global_norm",
           "schedules"]
