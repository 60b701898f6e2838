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

Over processes there is no sharded array: each rank holds its own block
of every tensor (`bridge.shard_params`) and every exchange is an explicit
collective. Where the reference's `Resolver.tree_shardings` places a leaf
and `constrain` pins an activation for GSPMD, the port cuts the leaf by
its spec and the layers call the collectives below at the reference's
hint points (`models/transformer.py::ShardCtx`).

The collectives, as autograd Functions over one mesh axis (`Axis`: a
group, its size and this rank's index in it):

  * `copy_to`: identity forward, the gradient summed over the axis
    backward (a replicated tensor that each rank uses for its own part);
  * `reduce_from`: the sum over the axis forward (a cast after it, if
    asked), identity backward;
  * `gather` along a dim: all-gather forward (a cast after it, if asked),
    and backward either the reduce-scatter (`grad="sum"`: each rank used
    the whole for its own part) or the rank's own block (`grad="slice"`:
    every rank used the whole alike);
  * `scatter` along a dim: reduce-scatter forward (a cast after it, if
    asked), all-gather backward;
  * `split` along a dim: the rank's own block forward, all-gather
    backward;
  * `gather_many`, `copy_to_many`: `gather` and `copy_to` of a layer's
    leaves in one collective each way (FSDP's buckets);
  * `all_max`, `all_sum`, `all_gather`, `all_gather_many`: the vocab
    statistics, the small reductions of the training program and the
    serving programs' exchanges (a decode's partial scores, its q/k for
    RoPE, a prefill's k/v into the cache's layout), no gradient.

Every sum adds the ranks' parts in rank order, in f32, after an
all-gather (or, for a reduce-scatter, an all_to_all of the blocks), so
every rank of the axis holds the same bits and no float atomics run.
Each call goes through `core/hostsync.py::collective` under its label
with the bytes this rank receives; a CUDA tensor is staged through host
memory, as gloo takes it, and the host only copies bytes: the layout
changes and the sums run on the tensor's device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

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


# ---------------------------------------------------------------------------
# Collectives over one mesh axis
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Axis:
    """One axis of the process mesh as a communicator: its group (None
    when it has one rank), its size, this rank's index along it, and the
    label prefix of its collectives ("tp" for the model axis, "fsdp" for
    the data axes)."""

    group: Any
    size: int
    index: int
    prefix: str


def _host(x: torch.Tensor) -> torch.Tensor:
    """x's host copy; a card's tensor lands in pinned memory (the caching
    host allocator's), which the copies to and from the card stream at
    full rate."""
    if x.device.type == "cpu":
        return x.detach().to("cpu", copy=True).contiguous()
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return h.copy_(x.detach())


def _host_like(h: torch.Tensor, shape=None) -> torch.Tensor:
    """A host buffer of h's dtype (and pinning), h's shape or `shape`."""
    return torch.empty(h.shape if shape is None else shape, dtype=h.dtype,
                       pin_memory=h.is_pinned())


def _wire(h: torch.Tensor) -> torch.Tensor:
    """h's bytes (gloo moves bytes of every dtype; not every gloo build
    reduces or gathers 16-bit floats)."""
    return h.reshape(-1).view(torch.uint8)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _staged(x: torch.Tensor, label: str, nbytes: int, fn) -> torch.Tensor:
    """fn(x's host copy) -> a host tensor, back on x's device: one counted
    collective, its staging through host memory included. The host only
    copies and moves bytes; every layout change and sum runs on x's
    device."""
    from repro_torch.core import hostsync
    with hostsync.collective(label, nbytes):
        return fn(_host(x)).to(x.device)


def _stacked(h: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every rank's host tensor h stacked in rank order, (n, *h.shape):
    an all-gather into the rows of one buffer."""
    import torch.distributed as dist
    out = _host_like(h, (axis.size,) + tuple(h.shape))
    dist.all_gather([_wire(r) for r in out.unbind(0)], _wire(h),
                    group=axis.group)
    return out


def _ordered_sum(parts: torch.Tensor, dtype) -> torch.Tensor:
    """parts (n, ...) summed over the first dim in order, in f32."""
    out = parts[0].to(torch.float32)
    for p in parts[1:]:
        out = out + p.to(torch.float32)
    return out.to(dtype)


def _ordered_max(parts: torch.Tensor) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p)
    return out


def _gathered(x: torch.Tensor, axis: Axis, label: str) -> torch.Tensor:
    """Every rank's x, (n, *x.shape) on x's device."""
    return _staged(x, label, (axis.size - 1) * _nbytes(x),
                   lambda h: _stacked(h, axis))


def all_sum(x: torch.Tensor, axis: Axis, label: str) -> torch.Tensor:
    """x summed over the axis, in rank order (f32), on every rank."""
    if axis.size == 1:
        return x
    return _ordered_sum(_gathered(x, axis, label), x.dtype)


def all_max(x: torch.Tensor, axis: Axis, label: str) -> torch.Tensor:
    """The elementwise max of x over the axis, on every rank."""
    if axis.size == 1:
        return x
    return _ordered_max(_gathered(x, axis, label))


def all_gather(x: torch.Tensor, dim: int, axis: Axis, label: str) -> torch.Tensor:
    """Every rank's x joined along `dim`, in rank order."""
    if axis.size == 1:
        return x
    return torch.cat(list(_gathered(x, axis, label).unbind(0)), dim=dim)


def all_gather_many(xs: Sequence[torch.Tensor], dims: Sequence[int],
                    axis: Axis, label: str, dtype=None) -> List[torch.Tensor]:
    """Every rank's x joined along its dim, for each of xs (one dtype), in
    one all-gather: each x's dim moved to the front and flattened into one
    buffer, the ranks' buffers split back; cast to `dtype` after it."""
    dtype = dtype or xs[0].dtype
    if axis.size == 1:
        return [x.to(dtype) for x in xs]
    moved = [x.movedim(d, 0) for x, d in zip(xs, dims)]
    flat = torch.cat([m.reshape(-1) for m in moved])
    parts = _gathered(flat, axis, label).to(dtype).unbind(0)
    per_rank = [p.split([m.numel() for m in moved]) for p in parts]
    return [torch.cat([pr[i].reshape(m.shape) for pr in per_rank]).movedim(0, d)
            for i, (m, d) in enumerate(zip(moved, dims))]


def reduce_scatter(x: torch.Tensor, dim: int, axis: Axis,
                   label: str) -> torch.Tensor:
    """This rank's block along `dim` of x summed over the axis: one
    all_to_all of the blocks, then their sum in rank order (f32)."""
    if axis.size == 1:
        return x
    import torch.distributed as dist
    n = axis.size
    moved = x.movedim(dim, 0).contiguous()
    blocks = moved.reshape((n, moved.shape[0] // n) + tuple(moved.shape[1:]))

    def run(h):
        out = _host_like(h)
        dist.all_to_all_single(_wire(out), _wire(h), group=axis.group)
        return out
    got = _staged(blocks, label, (n - 1) * _nbytes(x) // n, run)
    return _ordered_sum(got, x.dtype).movedim(0, dim).contiguous()


def _block(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * n, n)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        a = ctx.axis
        return all_sum(g, a, f"{a.prefix}_reduce"), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dtype):
        ctx.dtype = x.dtype
        return all_sum(x, axis, f"{axis.prefix}_reduce").to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, grad, dtype):
        ctx.dim, ctx.axis, ctx.grad, ctx.dtype = dim, axis, grad, x.dtype
        return all_gather(x, dim, axis, f"{axis.prefix}_gather").to(dtype)

    @staticmethod
    def backward(ctx, g):
        a = ctx.axis
        if ctx.grad == "sum":
            g = reduce_scatter(g, ctx.dim, a, f"{a.prefix}_scatter")
        else:
            g = _block(g, ctx.dim, a).contiguous()
        return g.to(ctx.dtype), None, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, dtype):
        ctx.dim, ctx.axis, ctx.dtype = dim, axis, x.dtype
        return reduce_scatter(x, dim, axis, f"{axis.prefix}_scatter").to(dtype)

    @staticmethod
    def backward(ctx, g):
        a = ctx.axis
        return all_gather(g.contiguous(), ctx.dim, a,
                          f"{a.prefix}_gather").to(ctx.dtype), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _block(x, dim, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        a = ctx.axis
        return all_gather(g.contiguous(), ctx.dim, a,
                          f"{a.prefix}_gather"), None, None


class _GatherMany(torch.autograd.Function):
    """`gather` (grad "sum") of several tensors in one all-gather forward
    and one all_to_all backward: each tensor's dim moved to the front and
    flattened into one buffer, the ranks' buffers split back."""

    @staticmethod
    def forward(ctx, dims, axis, dtype, *xs):
        ctx.dims, ctx.axis, ctx.dtype = dims, axis, xs[0].dtype
        ctx.shapes = [tuple(x.movedim(d, 0).shape) for x, d in zip(xs, dims)]
        return tuple(all_gather_many(xs, dims, axis, f"{axis.prefix}_gather",
                                     dtype))

    @staticmethod
    def backward(ctx, *gs):
        a, n = ctx.axis, ctx.axis.size
        # per destination rank r: every tensor's block r, flattened
        blocks = [g.movedim(d, 0).reshape((n, -1))
                  for g, d in zip(gs, ctx.dims)]
        flat = torch.cat(blocks, dim=1).reshape(-1)
        summed = reduce_scatter(flat, 0, a, f"{a.prefix}_scatter")
        pieces = summed.split([b.shape[1] for b in blocks])
        return (None, None, None) + tuple(
            p.reshape(shape).movedim(0, d).to(ctx.dtype)
            for p, shape, d in zip(pieces, ctx.shapes, ctx.dims))


class _CopyToMany(torch.autograd.Function):
    """`copy_to` of several tensors, their grads summed in one
    collective."""

    @staticmethod
    def forward(ctx, axis, *xs):
        ctx.axis = axis
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        a = ctx.axis
        flat = all_sum(torch.cat([g.reshape(-1) for g in gs]), a,
                       f"{a.prefix}_reduce")
        return (None,) + tuple(p.reshape(g.shape) for p, g in zip(
            flat.split([g.numel() for g in gs]), gs))


def gather_many(xs: Sequence[torch.Tensor], dims: Sequence[int], axis: Axis,
                dtype=None) -> List[torch.Tensor]:
    """`gather(x, dim, axis, "sum", dtype)` of each of xs (one dtype), in
    one collective each way."""
    dtype = dtype or xs[0].dtype
    if axis.size == 1:
        return [x.to(dtype) for x in xs]
    return list(_GatherMany.apply(tuple(dims), axis, dtype, *xs))


def copy_to_many(xs: Sequence[torch.Tensor], axis: Axis) -> List[torch.Tensor]:
    """`copy_to` of each of xs (one dtype), the grads in one collective."""
    if axis.size == 1:
        return list(xs)
    return list(_CopyToMany.apply(axis, *xs))


def copy_to(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Identity; backward: the gradient summed over the axis."""
    return x if axis.size == 1 else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Axis, dtype=None) -> torch.Tensor:
    """The sum over the axis, cast to `dtype` after it (default x's);
    backward: identity, cast to x's dtype."""
    dtype = dtype or x.dtype
    if axis.size == 1:
        return x.to(dtype)
    return _ReduceFrom.apply(x, axis, dtype)


def gather(x: torch.Tensor, dim: int, axis: Axis, grad: str = "sum",
           dtype=None) -> torch.Tensor:
    """The axis' blocks joined along `dim`, cast to `dtype` after the
    gather (default x's); backward: the reduce-scatter (`grad="sum"`) or
    the rank's own block (`grad="slice"`) in the grad's dtype, cast to
    x's after it. A bf16 weight gathered for f32 compute so moves bf16
    forward and sums its f32 partial grads, as the reference's program
    sums them before its bf16 convert."""
    if grad not in ("sum", "slice"):
        raise ValueError(f"grad={grad!r}: 'sum' or 'slice'")
    dtype = dtype or x.dtype
    if axis.size == 1:
        return x.to(dtype)
    return _Gather.apply(x, dim, axis, grad, dtype)


def scatter(x: torch.Tensor, dim: int, axis: Axis, dtype=None) -> torch.Tensor:
    """This rank's block along `dim` of the sum over the axis, cast to
    `dtype` after it (default x's); backward: the all-gather in the grad's
    dtype, cast to x's after it. f32 partial products summed so and cast
    to bf16 round once, as one product over the whole contraction does,
    and their bf16 grads move as bf16."""
    dtype = dtype or x.dtype
    if axis.size == 1:
        return x.to(dtype)
    return _Scatter.apply(x, dim, axis, dtype)


def split(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """This rank's block along `dim`; backward: the all-gather."""
    return x if axis.size == 1 else _Split.apply(x, dim, axis)
