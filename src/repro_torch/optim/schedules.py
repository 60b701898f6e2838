"""Learning-rate schedules (the reference's `optim/schedules.py`): pure
functions of the step, a 0-d int tensor on the state's device, returning a
0-d f32 tensor there (no host read)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(lr, warmup, total, final_frac=0.1):
    def fn(step):
        s = step.to(torch.float32)
        warm = lr * (s + 1.0) / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac * lr + (1 - final_frac) * lr * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return fn


def warmup_linear(lr, warmup, total, final_frac=0.0):
    def fn(step):
        s = step.to(torch.float32)
        warm = lr * (s + 1.0) / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        lin = lr * (1 - (1 - final_frac) * prog)
        return torch.where(s < warmup, warm, lin)
    return fn


def constant(lr):
    def fn(step):
        return torch.full((), lr, dtype=torch.float32, device=step.device)
    return fn


def make_schedule(train_cfg):
    if train_cfg.schedule == "cosine":
        return warmup_cosine(train_cfg.lr, train_cfg.warmup_steps,
                             train_cfg.steps)
    if train_cfg.schedule == "linear":
        return warmup_linear(train_cfg.lr, train_cfg.warmup_steps,
                             train_cfg.steps)
    return constant(train_cfg.lr)
