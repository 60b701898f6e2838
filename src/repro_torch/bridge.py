"""Carry parameters across from the JAX reference package.

`params_from_numpy(tree)` takes the reference's params as a nested dict of
numpy arrays (e.g. `jax.tree.map(np.asarray, params)`) and returns the
port's params: the same nested dicts, the same stacked leading-L leaves and
so the same flatten order, so an `InjectionSpec.leaf_idx` and every
fingerprint mean the same leaf in both packages. This module imports
neither JAX nor the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tree_util


def params_from_numpy(tree, device="cpu"):
    return tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)
