"""Activation rematerialization (the reference's `_remat`: `jax.checkpoint`
under a policy, `src/repro/models/transformer.py:232-239`).

`remat(body, policy, *tensors)` runs `body(*tensors) -> tuple of tensors`
as one block whose internals autograd does not keep:

  none     body runs as it is; autograd keeps what its ops save.
  full     only the block's inputs are kept (`nothing_saveable`); the
           backward reruns the block and takes its vector-Jacobian product.
  minimal  the inputs and the outputs of the products with no batch dims
           are kept (`dots_with_no_batch_dims_saveable`): the weight
           einsums, "bsd,df->bsf", "bsd,dhk->bshk" and the like, whose
           operands share no index with each other and the output. The
           rerun takes those products from the forward instead of
           computing them again and recomputes the rest. Attention's and
           the expert products' batched einsums are recomputed.

The block is a `torch.autograd.Function` (as `layers._ChunkedAttention`
is): its backward reruns the block with autograd on and takes
`torch.autograd.grad` through it. Its vmap rule lets the fused trainer's
`torch.vmap` run it, where `torch.utils.checkpoint` fails: it applies the
block to the batched tensors with a body that vmaps it, so the rerun
records the very batched ops a vmapped forward without remat records.

The three policies give the same bits: the rerun is the same arithmetic on
the same inputs at the same shapes, and its gradient is autograd's own
formula for each op (a product taken from the forward is the tensor the
rerun would compute; its backward is still the product's). The weight
einsums say what they are: the model computes each through `taped`
(`layers.wein`). Inside a `minimal` block `taped` runs its einsum under a
dispatch mode below autograd and vmap that records the output of each
matrix product the einsum dispatches (the forward) or hands the recorded
one back in the same order (the rerun), so the product's autograd node is
recorded as usual. No other op of the block passes through the mode. A
weight product written as a plain `torch.einsum` is recomputed: the same
bits, only slower.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

POLICIES = ("none", "minimal", "full")

_MM = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
       torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default,
       torch.ops.aten.mv.default, torch.ops.aten.dot.default}
# the tape of the `minimal` block running on this thread, or None
_ACTIVE = threading.local()
# products that `minimal` reruns took from their forwards, process wide
# (the tests read it: a rerun that replayed nothing would still be right,
# only slower)
counts = {"replayed": 0}


class _Tape(TorchDispatchMode):
    """Records (`saved` a list) or replays (`saved` an iterator) the
    outputs of the matrix products dispatched while it is on."""

    def __init__(self, saved, replay: bool):
        super().__init__()
        self.saved, self.replay = saved, replay

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _MM:
            if self.replay:
                counts["replayed"] += 1
                return next(self.saved).detach()
            out = func(*args, **(kwargs or {}))
            self.saved.append(out)
            return out
        return func(*args, **(kwargs or {}))


def taped(equation: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """torch.einsum(equation, x, w) for a weight product (a product with
    no batch dims, `layers.wein`): recorded or replayed inside a `minimal`
    block, plain elsewhere."""
    tape = getattr(_ACTIVE, "tape", None)
    if tape is None:
        return torch.einsum(equation, x, w)
    with tape:
        return torch.einsum(equation, x, w)


@contextlib.contextmanager
def _taping(saved, replay: bool):
    """`taped` records into the list `saved` (replay False) or replays the
    iterator `saved` (replay True) inside; nothing is taped when `saved`
    is None."""
    prev = getattr(_ACTIVE, "tape", None)
    _ACTIVE.tape = None if saved is None else _Tape(saved, replay)
    try:
        yield
    finally:
        _ACTIVE.tape = prev


class _Box:
    """A block's body, its policy and layer count, the vmap it runs under
    (`in_dims` of its params, or None), and what its forward kept beyond
    its inputs (the products, under `minimal`)."""

    def __init__(self, body: Callable, policy: str, layers, in_dims=None):
        self.body, self.policy, self.layers = body, policy, layers
        self.in_dims = in_dims
        self.products = None

    def layer(self, j, x, params):
        """Layer j's outputs: the body on its slice of each stacked leaf
        (the whole leaves for a one-layer block); under `in_dims`, vmapped
        over x's leading axis and the params' batched ones."""
        def one(x, *ps):
            if self.layers is None:
                return tuple(self.body(x, *ps))
            return tuple(self.body(x, *[p[j] for p in ps]))
        if self.in_dims is None:
            return one(x, *params)
        return torch.vmap(one, in_dims=(0, *self.in_dims))(x, *params)

    def run(self, x, params, keep_inputs=None):
        """Every layer in order -> (x, *each layer's aux outputs); each
        layer's input x appended to `keep_inputs` when given."""
        aux = []
        for j in range(self.layers or 1):
            if keep_inputs is not None:
                keep_inputs.append(x)
            x, *a = self.layer(j, x, params)
            aux.append(a)
        return x, aux


class _Remat(torch.autograd.Function):
    """The block (`_Box`) as one autograd node (module docstring). The
    vmap rule keeps autograd on the batched ops: a gradient taken through
    vmap's rules for the logical ops rounds otherwise where a weight is a
    strided slice of a stacked leaf."""

    @staticmethod
    def forward(box, x, *params):
        saved = [] if box.policy == "minimal" else None
        with _taping(saved, replay=False):
            x, aux = box.run(x, params)
        box.products = saved
        return (x, *[t for a in aux for t in a])

    @staticmethod
    def setup_context(ctx, inputs, output):
        box, *flat = inputs
        ctx.box, ctx.n_inputs = box, len(flat)
        # the products kept by `minimal` live as long as this node does
        ctx.save_for_backward(*flat, *(box.products or ()))
        box.products = None

    @staticmethod
    def vmap(info, in_dims, box, x, *params):
        # an input batched at 0 goes in as it is: a view node per input
        # would change the order in which autograd sums the gradients of
        # a tensor that is more than one input
        x = (x.unsqueeze(0).expand(info.batch_size, *x.shape)
             if in_dims[1] is None else x if in_dims[1] == 0
             else x.movedim(in_dims[1], 0))
        params = [p if d is None or d == 0 else p.movedim(d, 0)
                  for p, d in zip(params, in_dims[2:])]
        inner = _Box(box.body, box.policy, box.layers,
                     tuple(None if d is None else 0 for d in in_dims[2:]))
        out = _Remat.apply(inner, x, *params)
        return out, (0,) * len(out)

    @staticmethod
    def backward(ctx, gx, *gaux):
        box = ctx.box
        saved = ctx.saved_tensors
        x, *params = saved[:ctx.n_inputs]
        need = [i for i, p in enumerate(params)
                if ctx.needs_input_grad[i + 2] and p.is_floating_point()]
        # a group's rerun without grad keeps each layer's input (under
        # `minimal` it takes the forward's products); a one-layer block's
        # input is x, and its rerun below takes them
        products = (iter(saved[ctx.n_inputs:]) if box.policy == "minimal"
                    else None)
        del saved
        inputs = [x]
        if box.layers is not None:
            inputs = []
            with torch.no_grad(), _taping(products, replay=True):
                box.run(x, params, inputs)
        n_aux = len(gaux) // (box.layers or 1)
        grads = [None] * len(params)
        for j in reversed(range(box.layers or 1)):
            xj = inputs[j].detach().requires_grad_(ctx.needs_input_grad[1]
                                                   or j > 0)
            ps = list(params)
            for i in need:
                ps[i] = params[i].detach().requires_grad_(True)
            with torch.enable_grad(), _taping(
                    products if box.layers is None else None, replay=True):
                outs = box.layer(j, xj, ps)
            wrt = ([xj] if xj.requires_grad else []) + [ps[i] for i in need]
            pairs = [(o, g) for o, g in zip(
                outs, (gx, *gaux[j * n_aux:(j + 1) * n_aux]))
                if o.requires_grad]
            got = torch.autograd.grad([o for o, _ in pairs],
                                      wrt, [g for _, g in pairs],
                                      allow_unused=True)
            del outs, pairs
            inputs[j] = None
            if xj.requires_grad:
                gx, got = got[0], got[1:]
            for i, g in zip(need, got):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
        if products is not None and next(products, None) is not None:
            raise RuntimeError("a minimal rerun took fewer products than "
                               "its forward kept")
        return (None, gx if ctx.needs_input_grad[1] else None, *grads)


def remat(body: Callable[..., Tuple[torch.Tensor, ...]], policy: str,
          x: torch.Tensor, *params: torch.Tensor,
          layers=None) -> Tuple[torch.Tensor, ...]:
    """`body(x, *params) -> (x, *aux)` as one rematerialized block under
    `policy` (module docstring). With `layers` = G, every leaf of
    `params` stacks G layers on its leading axis and the block is the G
    layers in turn, body(x, *[p[j] for p in params]) for j < G, each
    output x the next one's input (the reference's two-level group: its
    backward reruns the group's forward without grad, keeping each
    layer's input, then takes one layer's gradient at a time, as its
    inner `nothing_saveable` does). Returns (x, *every layer's aux in
    order). Under grad mode off (prefill, serving) and `none` it runs the
    body itself."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r} ({POLICIES})")
    box = _Box(body, policy, layers)
    if policy == "none" or not torch.is_grad_enabled():
        x, aux = box.run(x, params)
        return (x, *[t for a in aux for t in a])
    return _Remat.apply(box, x, *params)
