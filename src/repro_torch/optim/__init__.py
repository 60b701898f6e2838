"""Optimizers and schedules of the port (the reference's `optim/`; its
int8 gradient compression of the pod backend is not ported)."""
from repro_torch.optim.optimizers import (
    Optimizer,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
    sgdm,
)
from repro_torch.optim.schedules import make_schedule

__all__ = [
    "Optimizer", "adamw", "sgdm", "make_optimizer", "apply_updates",
    "clip_by_global_norm", "global_norm", "make_schedule",
]
