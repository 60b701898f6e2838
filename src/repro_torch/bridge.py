"""Carry parameters across from the JAX reference package.

`params_from_numpy(tree)` takes the reference's params as a nested dict of
numpy arrays (e.g. `jax.tree.map(np.asarray, params)`) and returns the
port's params: the same nested dicts, the same stacked leading-L leaves and
so the same flatten order, so an `InjectionSpec.leaf_idx` and every
fingerprint mean the same leaf in both packages. `train_state_from_numpy`
does the same for a whole training state. `expert_shard(params, tp, m)`
cuts the full expert leaves to model rank m's slice for expert
parallelism. This module imports neither JAX nor the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tree_util


def params_from_numpy(tree, device="cpu"):
    return tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def train_state_from_numpy(state, device="cpu"):
    """The reference's training state `{"params", "opt": {"m", "v"} (adamw)
    or {"m"} (sgdm), "step"}` as numpy (e.g. `jax.tree.map(np.asarray,
    state)`) -> the port's: the same tree, so the same leaf order and
    `leaf_idx`, with `step` a 0-d int32 tensor."""
    return {"params": params_from_numpy(state["params"], device),
            "opt": params_from_numpy(state["opt"], device),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}


def expert_shard(params, tp: int, m: int):
    """Model rank m's params for expert parallelism over tp ranks
    (`models/moe.py::moe_mlp_ep`): every MoE block's w_gate, w_up and
    w_down cut to experts [m E/tp, (m+1) E/tp) along their experts axis
    (the third from last, after any stacked layer axis); every other leaf,
    the router included, as it is (views, no copy)."""
    if isinstance(params, dict):
        if "router" in params:
            out = dict(params)
            for name in ("w_gate", "w_up", "w_down"):
                w = params[name]
                E = w.shape[-3]
                if E % tp:
                    raise ValueError(f"{E} experts do not split over {tp} "
                                     "model ranks")
                n = E // tp
                out[name] = w.narrow(w.dim() - 3, m * n, n)
            return out
        return {k: expert_shard(v, tp, m) for k, v in params.items()}
    return params
