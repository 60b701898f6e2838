"""Carry parameters across from the JAX reference package.

`params_from_numpy(tree)` takes the reference's params as a nested dict of
numpy arrays (e.g. `jax.tree.map(np.asarray, params)`) and returns the
port's params: the same nested dicts, the same stacked leading-L leaves and
so the same flatten order, so an `InjectionSpec.leaf_idx` and every
fingerprint mean the same leaf in both packages. `train_state_from_numpy`
does the same for a whole training state. `expert_shard(params, tp, m)`
cuts the full expert leaves to model rank m's slice for expert
parallelism. `shard_params(params, resolver, coords, cfg)` cuts every leaf
to a rank's block by its spec (the reference's `Resolver.tree_shardings`
placement, over a process mesh), `shard_state` a whole training state,
`gather_params` joins the ranks' blocks back, and `shard_batch` cuts a
global batch as `launch/dryrun.py::build_train_program` takes it. This
module imports neither JAX nor the reference package.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from repro_torch import tree as tree_util

MESH_AXES = ("pod", "data", "model")


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


# ---------------------------------------------------------------------------
# A rank's block of every leaf, by the resolver's specs
# ---------------------------------------------------------------------------

def mesh_sizes(resolver) -> Dict[str, int]:
    """The resolver's mesh as {axis: size} over pod, data and model."""
    m = resolver.mesh
    sizes = dict(m) if isinstance(m, dict) else dict(m.sizes)
    return {a: int(sizes.get(a, 1)) for a in MESH_AXES}


def mesh_coords(coords) -> Dict[str, int]:
    """A rank's (pod, data, model) indices from a `launch/mesh.py::
    ProcessMesh` or a dict."""
    if isinstance(coords, dict):
        return {a: int(coords.get(a, 0)) for a in MESH_AXES}
    return {"pod": coords.pod, "data": coords.data, "model": coords.model}


def rank_coords(rank: int, sizes: Dict[str, int]) -> Dict[str, int]:
    """Rank r's indices, r = (p * D + d) * M + m (the mesh's order)."""
    pd, m = divmod(rank, sizes["model"])
    p, d = divmod(pd, sizes["data"])
    return {"pod": p, "data": d, "model": m}


def _entry_axes(entry):
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def block_index(entry, coords, sizes):
    """(index, count) of a rank's block along a dim placed by `entry` (a
    mesh axis, a tuple of them or None): several axes index the blocks in
    their order, the first slowest."""
    idx, n = 0, 1
    for a in _entry_axes(entry):
        idx, n = idx * sizes[a] + coords[a], n * sizes[a]
    return idx, n


def shard_leaf(t: torch.Tensor, spec, coords, sizes) -> torch.Tensor:
    """Rank `coords`' block of t placed by `spec` (a view, no copy)."""
    for dim, entry in enumerate(spec):
        idx, n = block_index(entry, coords, sizes)
        if n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, idx * size, size)
    return t


class _Spec:
    """A partition entry tuple as one leaf of a tree walk."""

    def __init__(self, entries):
        self.entries = tuple(entries)


def spec_leaves(tree, specs):
    """The partition entries of `tree`'s leaves, in flatten order (a specs
    tree's tuples are not leaves of a tree walk)."""
    return [b.entries for b in tree_util.leaves(tree_util.tree_map(
        lambda t, s: _Spec(s), tree, specs))]


def partition(cfg, params, resolver):
    """The params' partition entries: `Resolver.tree_specs` of
    `models/model.py::param_axes` over the leaves' shapes (fallbacks
    recorded on the resolver)."""
    from repro_torch.models.model import param_axes
    return resolver.tree_specs(param_axes(cfg, params), tree_util.tree_map(
        lambda t: tuple(t.shape), params))


def shard_params(params, resolver, coords, cfg, specs=None):
    """Rank `coords`' block of every leaf of `params` (views, no copy), by
    `specs` (default: `partition(cfg, params, resolver)`)."""
    specs = partition(cfg, params, resolver) if specs is None else specs
    sizes, c = mesh_sizes(resolver), mesh_coords(coords)
    return tree_util.tree_map(lambda t, s: shard_leaf(t, s, c, sizes),
                              params, specs)


def shard_state(state, resolver, coords, cfg, specs=None):
    """A training state's block for rank `coords`: params and each
    optimizer moment cut as the params are; `step` whole."""
    specs = partition(cfg, state["params"], resolver) if specs is None \
        else specs
    return {"params": shard_params(state["params"], resolver, coords, cfg,
                                   specs),
            "opt": {k: shard_params(v, resolver, coords, cfg, specs)
                    for k, v in state["opt"].items()},
            "step": state["step"]}


def _join(blocks: Sequence[torch.Tensor], spec, coords, sizes):
    """The whole leaf from every rank's block (`coords[r]` rank r's)."""
    out = None
    for t, c in zip(blocks, coords):
        if out is None:
            shape = list(t.shape)
            for dim, entry in enumerate(spec):
                shape[dim] *= block_index(entry, c, sizes)[1]
            out = t.new_empty(shape)
        dst = out
        for dim, entry in enumerate(spec):
            idx, n = block_index(entry, c, sizes)
            if n > 1:
                dst = dst.narrow(dim, idx * t.shape[dim], t.shape[dim])
        dst.copy_(t)
    return out


def whole_partition(cfg, resolver):
    """The partition entries of the config's whole params (their shapes
    on `meta`, `launch/input_specs.py`)."""
    from repro_torch.launch import input_specs as ispec
    return partition(cfg, ispec._abstract_params(cfg)[0], resolver)


def gather_params(shards: Sequence[Any], resolver, cfg, specs=None):
    """The whole params from every rank's block, `shards[r]` rank r's in
    the mesh's order (`shard_params`' inverse); `specs` default:
    `whole_partition(cfg, resolver)`."""
    sizes = mesh_sizes(resolver)
    coords = [rank_coords(r, sizes) for r in range(len(shards))]
    specs = whole_partition(cfg, resolver) if specs is None else specs
    return tree_util.tree_map(
        lambda b0, s, *bs: _join((b0,) + bs, s, coords, sizes), shards[0],
        specs, *shards[1:])


def shard_batch(batch, resolver, coords, microbatches: int = 1):
    """Rank `coords`' rows of a global batch (dim 0 of every leaf) over the
    rules' data axes. With M microbatches the rows are taken so that the
    rank's i-th microbatch holds its data index' share of the global
    microbatch i (the reference's reshape to (M, B / M) and its batch
    sharding inside each): global rows (M, D, B / (M D)), the rank's
    [:, d]."""
    sizes, c = mesh_sizes(resolver), mesh_coords(coords)
    idx, n = block_index(resolver.rules.data_axes, c, sizes)

    def cut(t):
        B = t.shape[0]
        if B % (microbatches * n):
            raise ValueError(f"a batch of {B} rows does not split into "
                             f"{microbatches} microbatches over {n} data "
                             "shards")
        rows = t.reshape((microbatches, n, B // (microbatches * n))
                         + tuple(t.shape[1:]))
        return rows[:, idx].reshape((B // n,) + tuple(t.shape[1:]))
    return tree_util.tree_map(cut, batch)
