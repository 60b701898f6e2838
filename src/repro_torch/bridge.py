"""Carry parameters across from the JAX reference package.

`params_from_numpy(tree)` takes the reference's params as a nested dict of
numpy arrays (e.g. `jax.tree.map(np.asarray, params)`) and returns the
port's params: the same nested dicts, the same stacked leading-L leaves and
so the same flatten order, so an `InjectionSpec.leaf_idx` and every
fingerprint mean the same leaf in both packages. `train_state_from_numpy`
does the same for a whole training state. This module imports neither JAX
nor the reference package.
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
