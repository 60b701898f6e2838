"""From-scratch optimizers (the reference's `optim/optimizers.py`): AdamW
and SGD-momentum as pure functions over trees of tensors,

    init(params)                           -> opt_state
    update(grads, opt_state, params, step) -> (updates, new_opt_state)
    apply(grads, opt_state, params, step[, replicas])
                                           -> (new_params, new_opt_state)

`updates` are the deltas to ADD to params (lr applied, sign included);
`step` is the state's 0-d int tensor. Every result is a NEW tensor, never
an in-place write: the sequential commit gate keeps the pre-step state on
a mismatch, and a checkpoint holds references to the committed one.

`apply` (port only) is `update` followed by `apply_updates`, bit for bit,
in one pass leaf by leaf, largest leaf first. It builds neither the
clipped grads nor the updates as trees, and it drops each gradient leaf
from `grads` (a list of the gradient leaves in flatten order, which the
caller hands over) once that leaf is stepped. So the step's peak is the
old and the new {params, opt} and what is left of the grads, where
`update` + `apply_updates` held two more trees of the parameters' size:
the difference between a full-width family fitting beside a dual run on
one card or not. `replicas=True` steps both replicas of the fused
backend's stacked state (a leading axis of 2 on every leaf, `step` of
shape (2,)) with each replica's own global norm and schedule, as a
`torch.vmap` of `update` does. `norm_sq(grads)`, where given, returns
the clip's global sum of squares in place of the leaf loop (the sharded
training program's: every rank's block of the grads, each element once,
summed over the ranks).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Tuple

import torch

from repro_torch import tree as tree_util


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]
    apply: Callable[..., Tuple[Any, Any]]
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


def _per_replica(x, leaf: torch.Tensor, replicas: bool):
    """A per-replica value ((2,) under `replicas`) shaped to broadcast over
    `leaf`'s stacked dims; as it is otherwise."""
    if not replicas or not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    return x.reshape((-1,) + (1,) * (leaf.dim() - 1))


def _apply(leaf_fn, consts_fn, n_state: int, grad_clip: float):
    """The `apply` of an optimizer whose per-leaf math is
    leaf_fn(g, *state leaves, p, *consts) -> (delta, *new state leaves) and
    whose per-step constants are consts_fn(step)."""

    def apply(grads: List[torch.Tensor], state, params, step,
              replicas: bool = False, norm_sq=None):
        p_leaves = tree_util.leaves(params)
        s_names = sorted(state)
        s_leaves = [tree_util.leaves(state[k]) for k in s_names]
        if len(grads) != len(p_leaves):
            raise ValueError(f"{len(grads)} gradient leaves for "
                             f"{len(p_leaves)} parameters")
        scale = None
        if grad_clip and norm_sq is not None:
            total = [norm_sq(grads)]
        elif grad_clip:
            # as global_norm, per replica: each replica's leaf is reduced
            # on its own, as the sequential backend reduces it
            n_rep = 2 if replicas else 1
            total = [0] * n_rep
            for g in grads:
                sq = torch.square(g.to(torch.float32))
                for r in range(n_rep):
                    total[r] = total[r] + torch.sum(sq[r] if replicas
                                                    else sq)
        if grad_clip:
            gn = torch.sqrt(torch.stack([torch.as_tensor(
                t, dtype=torch.float32) for t in total]))
            scale = torch.clamp(grad_clip / torch.clamp(gn, min=1e-12),
                                max=1.0)
            if not replicas:
                scale = scale[0]
        consts = consts_fn(step)
        new_p = [None] * len(p_leaves)
        new_s = [[None] * len(p_leaves) for _ in range(n_state)]
        for i in sorted(range(len(p_leaves)),
                        key=lambda j: -p_leaves[j].numel()):
            g, grads[i] = grads[i], None
            p = p_leaves[i]
            if scale is not None:     # as clip_by_global_norm
                g = (g.to(torch.float32) * _per_replica(scale, g, replicas)
                     ).to(g.dtype)
            delta, *st = leaf_fn(g, *[s[i] for s in s_leaves], p,
                                 *[_per_replica(c, p, replicas)
                                   for c in consts])
            del g
            new_p[i] = (p.to(torch.float32) + delta.to(torch.float32)
                        ).to(p.dtype)                 # as apply_updates
            del delta
            for k in range(n_state):
                new_s[k][i] = st[k]
        return (tree_util.unflatten_like(params, new_p),
                {k: tree_util.unflatten_like(params, v)
                 for k, v in zip(s_names, new_s)})

    return apply


def adamw(lr_fn, *, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
          grad_clip: float = 1.0) -> Optimizer:
    def init(params):
        return {"m": tree_util.tree_map(_zeros_f32, params),
                "v": tree_util.tree_map(_zeros_f32, params)}

    def consts(step):
        stepf = step.to(torch.float32) + 1.0
        return lr_fn(step), 1.0 - beta1 ** stepf, 1.0 - beta2 ** stepf

    def upd(g, m, v, p, lr, bc1, bc2):
        gf = g.to(torch.float32)
        m2 = beta1 * m + (1.0 - beta1) * gf
        v2 = beta2 * v + (1.0 - beta2) * gf * gf
        mhat = m2 / bc1
        vhat = v2 / bc2
        delta = -lr * (mhat / (torch.sqrt(vhat) + eps)
                       + weight_decay * p.to(torch.float32))
        return delta, m2, v2

    def update(grads, state, params, step):
        if grad_clip:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        c = consts(step)
        outs = [upd(*a, *c) for a in zip(tree_util.leaves(grads),
                                         tree_util.leaves(state["m"]),
                                         tree_util.leaves(state["v"]),
                                         tree_util.leaves(params))]
        updates, m, v = _unzip(grads, outs, 3)
        return updates, {"m": m, "v": v}

    return Optimizer(init, update, _apply(upd, consts, 2, grad_clip),
                     "adamw")


def sgdm(lr_fn, *, momentum=0.9, weight_decay=0.0,
         grad_clip: float = 1.0) -> Optimizer:
    def init(params):
        return {"m": tree_util.tree_map(_zeros_f32, params)}

    def consts(step):
        return (lr_fn(step),)

    def upd(g, m, p, lr):
        gf = g.to(torch.float32) + weight_decay * p.to(torch.float32)
        m2 = momentum * m + gf
        return -lr * m2, m2

    def update(grads, state, params, step):
        if grad_clip:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        c = consts(step)
        outs = [upd(*a, *c) for a in zip(tree_util.leaves(grads),
                                         tree_util.leaves(state["m"]),
                                         tree_util.leaves(params))]
        updates, m = _unzip(grads, outs, 2)
        return updates, {"m": m}

    return Optimizer(init, update, _apply(upd, consts, 1, grad_clip),
                     "sgdm")


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
