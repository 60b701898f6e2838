"""Logical-axis sharding rules with divisibility-aware fallback (the
reference's `sharding.py`), as plain Python over a process mesh.

Model code names every parameter and activation dimension by a logical
axis ("heads", "embed", "mlp", "experts", "batch", ...). The resolver maps
logical axes onto mesh axes:

  * tensor-parallel candidates  -> the "model" mesh axis
  * FSDP / data candidates      -> the "data" mesh axis
  * sequence-parallel candidate -> optional

A mesh axis goes to at most one dimension per tensor, in priority order,
and only where the dimension divides by the axis' extent; a candidate that
does not divide falls through to the next dimension that can take the
axis, and every fallback is recorded. The decisions are the reference's,
case for case (`tests/test_torch_ep.py`); `Resolver.spec` returns the
entries of the reference's `PartitionSpec` as a tuple.

Over processes there is no sharded array: each rank holds its own tensors
and every exchange is an explicit collective (`launch/mesh.py`,
`models/moe.py::moe_mlp_ep`). So the reference's `Resolver.named`,
`tree_shardings` and `constrain`, which build `NamedSharding`s and GSPMD
constraints, have no counterpart here and are left out.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Logical axes that want the tensor-parallel ("model") mesh axis, in
# priority order. Within one tensor, the first divisible dim wins.
MODEL_PARALLEL_AXES: Tuple[str, ...] = (
    "experts",      # MoE expert parallelism
    "heads",
    "kv_heads",
    "mlp",
    "vocab",
    "rnn",          # RG-LRU recurrent width
    "inner",        # xLSTM inner width
    "head_dim",     # fallback when the head axis is not divisible (params)
    "batch_dm",     # activations only: batch over data * model
)

# Logical axes that want the data/FSDP mesh axes.
DATA_PARALLEL_AXES: Tuple[str, ...] = (
    "batch",
    "batch_dm",     # if the combined data * model grab failed, plain data
    "embed",        # FSDP: parameters sharded along their embed dim
)

# Sequence axis: shardable over "model" under sequence parallelism.
SEQUENCE_AXES: Tuple[str, ...] = ("seq",)


@dataclass(frozen=True)
class ShardingRules:
    """Physical mapping policy for one run."""

    model_axes: Tuple[str, ...] = ("model",)
    data_axes: Tuple[str, ...] = ("data",)
    sequence_parallel: bool = False
    fsdp: bool = True

    def axis_size(self, mesh, axes: Tuple[str, ...]) -> int:
        """The product of `axes`' sizes in `mesh`: a dict of axis sizes or
        a `launch/mesh.py::ProcessMesh`."""
        sizes = mesh if isinstance(mesh, dict) else mesh.sizes
        n = 1
        for a in axes:
            n *= sizes[a]
        return n


@dataclass
class FallbackRecord:
    tensor: str
    logical: str
    dim: int
    size: int
    wanted: Tuple[str, ...]
    reason: str


class Resolver:
    """Resolves logical-axis tuples to partition entries over a mesh."""

    def __init__(self, mesh, rules: Optional[ShardingRules] = None):
        self.mesh = mesh
        self.rules = rules or ShardingRules()
        self.fallbacks: List[FallbackRecord] = []

    def spec(self, logical: Sequence[Optional[str]], shape: Sequence[int],
             name: str = "?") -> Tuple[Any, ...]:
        """One tensor's partition entries: per dim None, a mesh axis name,
        or a tuple of them; trailing Nones dropped (the reference's
        `PartitionSpec`, as a tuple)."""
        assert len(logical) == len(shape), (name, logical, shape)
        rules = self.rules
        assigned: Dict[int, Tuple[str, ...]] = {}
        used: set = set()

        def try_assign(dim: int, axes: Tuple[str, ...]) -> bool:
            if any(a in used for a in axes):
                return False
            n = rules.axis_size(self.mesh, axes)
            if n == 1 or shape[dim] % n != 0:
                return False
            assigned[dim] = axes
            used.update(axes)
            return True

        def fallback(dim: int, lname: str, axes: Tuple[str, ...]) -> None:
            self.fallbacks.append(FallbackRecord(
                name, lname, dim, shape[dim], axes,
                f"{shape[dim]} % {rules.axis_size(self.mesh, axes)} != 0"))

        # pass 1: tensor parallel, by priority over names, then dims
        for lname in MODEL_PARALLEL_AXES:
            if any(a in used for a in rules.model_axes):
                break
            for dim, l in enumerate(logical):
                if l == lname and dim not in assigned:
                    axes = (rules.data_axes + rules.model_axes
                            if lname == "batch_dm" else rules.model_axes)
                    if try_assign(dim, axes):
                        break
                    fallback(dim, lname, axes)

        # pass 2: sequence parallelism (activations only; opt-in)
        if rules.sequence_parallel:
            for dim, l in enumerate(logical):
                if l in SEQUENCE_AXES and dim not in assigned:
                    try_assign(dim, rules.model_axes)

        # pass 3: data / FSDP
        for lname in DATA_PARALLEL_AXES:
            if lname == "embed" and not rules.fsdp:
                continue
            if any(a in used for a in rules.data_axes):
                break
            for dim, l in enumerate(logical):
                if l == lname and dim not in assigned:
                    if try_assign(dim, rules.data_axes):
                        break
                    fallback(dim, lname, rules.data_axes)

        entries: List[Any] = []
        for dim in range(len(shape)):
            ax = assigned.get(dim)
            entries.append(None if ax is None
                           else ax[0] if len(ax) == 1 else tuple(ax))
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    def tree_specs(self, logical_tree, shape_tree):
        """`spec` over a nested dict of logical-axis tuples and the same
        nesting of shapes; each tensor named by its path as the reference's
        `jax.tree_util.keystr` names it (``['mlp']['w_up']``)."""
        return _tree_specs(self, logical_tree, shape_tree, "")

    def fallback_report(self) -> List[dict]:
        return [dataclasses.asdict(f) for f in self.fallbacks]


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _tree_specs(resolver: Resolver, logical, shapes, path: str):
    if _is_axes(logical):
        return resolver.spec(logical, tuple(shapes), path)
    if isinstance(logical, dict):
        return {k: _tree_specs(resolver, logical[k], shapes[k],
                               f"{path}[{k!r}]")
                for k in sorted(logical)}
    return type(logical)(_tree_specs(resolver, l, s, f"{path}[{i}]")
                         for i, (l, s) in enumerate(zip(logical, shapes)))


def batch_spec(rules: ShardingRules):
    """The partition entry of the global-batch dimension."""
    axes = rules.data_axes
    return axes[0] if len(axes) == 1 else tuple(axes)
