"""Optimizers, LR schedules, gradient compression."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    global_norm,
    init as adamw_init,
    update as adamw_update,
)
from repro_torch.optim import compression, schedules

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "schedules", "compression"]
