"""Optimizers, schedules and the int8 error-feedback gradient compression
of the port (the reference's `optim/`)."""
from repro_torch.optim.compression import int8_error_feedback
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
    "int8_error_feedback",
]
