"""From-scratch optimizers (the reference's `optim/optimizers.py`): AdamW
and SGD-momentum as pairs of pure functions over trees of tensors,

    init(params)                           -> opt_state
    update(grads, opt_state, params, step) -> (updates, new_opt_state)

`updates` are the deltas to ADD to params (lr applied, sign included);
`step` is the state's 0-d int tensor. Every result is a NEW tensor, never
an in-place write: the sequential commit gate keeps the pre-step state on
a mismatch, and a checkpoint holds references to the committed one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Tuple

import torch

from repro_torch import tree as tree_util


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]
    name: str = "opt"


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in flatten order, of each leaf's sum
    of squares (f32)."""
    total = 0
    for leaf in tree_util.leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(tree, max_norm: float):
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_util.tree_map(
        lambda g: (g.to(torch.float32) * scale).to(g.dtype), tree), gn


def apply_updates(params, updates):
    return tree_util.tree_map(
        lambda p, u: (p.to(torch.float32) + u.to(torch.float32)).to(p.dtype),
        params, updates)


def _zeros_f32(p):
    return torch.zeros_like(p, dtype=torch.float32)


def _unzip(grads, outs, n: int):
    """Per-leaf tuples of results -> n trees of grads' structure."""
    return [tree_util.unflatten_like(grads, [o[k] for o in outs])
            for k in range(n)]


def adamw(lr_fn, *, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
          grad_clip: float = 1.0) -> Optimizer:
    def init(params):
        return {"m": tree_util.tree_map(_zeros_f32, params),
                "v": tree_util.tree_map(_zeros_f32, params)}

    def update(grads, state, params, step):
        if grad_clip:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        stepf = step.to(torch.float32) + 1.0
        lr = lr_fn(step)
        bc1 = 1.0 - beta1 ** stepf
        bc2 = 1.0 - beta2 ** stepf

        def upd(g, m, v, p):
            gf = g.to(torch.float32)
            m2 = beta1 * m + (1.0 - beta1) * gf
            v2 = beta2 * v + (1.0 - beta2) * gf * gf
            mhat = m2 / bc1
            vhat = v2 / bc2
            delta = -lr * (mhat / (torch.sqrt(vhat) + eps)
                           + weight_decay * p.to(torch.float32))
            return delta, m2, v2

        outs = [upd(*a) for a in zip(tree_util.leaves(grads),
                                     tree_util.leaves(state["m"]),
                                     tree_util.leaves(state["v"]),
                                     tree_util.leaves(params))]
        updates, m, v = _unzip(grads, outs, 3)
        return updates, {"m": m, "v": v}

    return Optimizer(init, update, "adamw")


def sgdm(lr_fn, *, momentum=0.9, weight_decay=0.0,
         grad_clip: float = 1.0) -> Optimizer:
    def init(params):
        return {"m": tree_util.tree_map(_zeros_f32, params)}

    def update(grads, state, params, step):
        if grad_clip:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        lr = lr_fn(step)

        def upd(g, m, p):
            gf = g.to(torch.float32) + weight_decay * p.to(torch.float32)
            m2 = momentum * m + gf
            return -lr * m2, m2

        outs = [upd(*a) for a in zip(tree_util.leaves(grads),
                                     tree_util.leaves(state["m"]),
                                     tree_util.leaves(params))]
        updates, m = _unzip(grads, outs, 2)
        return updates, {"m": m}

    return Optimizer(init, update, "sgdm")


def make_optimizer(train_cfg) -> Optimizer:
    from repro_torch.optim.schedules import make_schedule
    lr_fn = make_schedule(train_cfg)
    if train_cfg.optimizer == "adamw":
        return adamw(lr_fn, beta1=train_cfg.beta1, beta2=train_cfg.beta2,
                     eps=train_cfg.eps, weight_decay=train_cfg.weight_decay,
                     grad_clip=train_cfg.grad_clip)
    if train_cfg.optimizer == "sgdm":
        return sgdm(lr_fn, momentum=train_cfg.beta1,
                    weight_decay=train_cfg.weight_decay,
                    grad_clip=train_cfg.grad_clip)
    raise ValueError(train_cfg.optimizer)
