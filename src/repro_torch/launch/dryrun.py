"""One card's dry run of a cell (arch x shape x flavor): what the port
would hold and compute on one NVIDIA H100, predicted without the card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \
        --shape train_4k --flavor sedar [--mesh pod=2,data=1,model=2]

Writes one JSON per cell under --out (default artifacts/dryrun_torch/)
and prints a line each. Every tensor is on the `meta` device: shapes and
dtypes, no memory, no card.

What a cell holds (the reference's `launch/dryrun.py::run_cell`, cut to
one card):
  * bytes, exact, from `launch/input_specs.py`: the trainer's state (f32
    params, the AdamW moments, the step); under `sedar` (the sequential
    dual) two states and one device-ring slot; the f32 grads; a server's
    bf16 params and its decode cache at the shape;
  * activation bytes under the config's remat policy, counted on `meta`:
    the bytes autograd saves for the backward (`saved_tensors_hooks`) over
    one training step, at their most alive at once, forward and backward
    (a remat block's rerun included), the params themselves left out; at
    batch 1 and 2, which splits them into a part each sequence adds and
    a part the step holds whatever its batch (the weights' bf16 casts);
  * FLOPs: `torch.utils.flop_counter.FlopCounterMode` over the step on
    `meta` tensors with `attention_impl="xla"` (K2's arithmetic), the
    remat reruns included; prefill and decode their forward;
  * the predicted peak of one step (`memory.peak_model` says what it
    counts) and whether the shape's global batch fits the card, and the
    largest batch that does;
  * a roofline: FLOPs at 989 TFLOP/s, the bytes the step must move (each
    input read once, each output written once) at 3.35 TB/s.

With `--mesh` a cell is planned on a mesh of ranks (`plan_ranks`): a
training cell's state, grads and ring bytes per rank, a prefill or decode
cell's bf16 params and KV cache bytes per rank, from the Resolver's specs
of the sharded trees, with the fallback report.

`build_train_program` is the reference's sharded training step (baseline
and sedar flavors, gradient accumulation) on a rank of a process mesh
(`launch/mesh.py`), its layers tensor-, sequence- and FSDP-parallel
behind `models/transformer.py::ShardCtx`; `build_prefill_program` and
`build_decode_program` are the reference's serving programs there, the
KV cache split over kv heads or head dims.

No counterpart here: the reference's HLO collective parsers (a process
mesh's collectives are counted as they run, under their
`core/hostsync.py` labels), its TPU v5e hardware model (this card's constants
are below) and its scan-cost `Probe`s (a Python loop over the layers on
`meta` counts every layer, so there is no scan body counted once).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import (SHAPE_BY_NAME, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.configs.registry import ASSIGNED_ARCHS
from repro_torch.launch import input_specs as ispec
from repro_torch.sharding import Resolver, ShardingRules

# -- the card: NVIDIA H100 SXM 80GB ------------------------------------------
H100_HBM_BYTES = 80 * 10 ** 9        # 80 GB of HBM3
H100_BF16_FLOPS = 989e12             # dense bf16 on the tensor cores
H100_HBM_BYTES_PER_S = 3.35e12
FLAVORS = ("baseline", "sedar")


def _live_saved(fn, params) -> int:
    """Run fn() and return the most bytes of autograd's saved tensors
    alive at once, the `params` leaves not counted. A saved tensor is
    alive from its pack until autograd drops it."""
    skip = {t.untyped_storage()._cdata for t in params}
    live = {"now": 0, "peak": 0}
    held: Dict[int, int] = {}

    class Saved:
        def __init__(self, t):
            self.t = t

    def release(key, size):
        held[key] -= 1
        if held[key] == 0:
            del held[key]
            live["now"] -= size

    def pack(t):
        box = Saved(t)
        key = t.untyped_storage()._cdata
        if key in skip:
            return box
        size = t.untyped_storage().nbytes()
        if key not in held:
            held[key] = 0
            live["now"] += size
            live["peak"] = max(live["peak"], live["now"])
        held[key] += 1
        weakref.finalize(box, release, key, size)
        return box

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda b: b.t):
        fn()
    return live["peak"]


def _meta_batch(cfg, B: int, S: int) -> Dict[str, torch.Tensor]:
    specs, _ = ispec.batch_specs(cfg, dataclasses.replace(
        SHAPES[0], kind="train", seq_len=S, global_batch=B))
    return {k: (torch.zeros(t.shape, dtype=torch.int64, device=ispec.META)
                if not t.is_floating_point() else t)
            for k, t in specs.items()}


_STEP_COSTS: Dict[tuple, Dict[str, int]] = {}


def train_step_cost(cfg, S: int) -> Dict[str, Any]:
    """One training step of S-token sequences on `meta`: the FLOPs of one
    sequence (forward, the remat reruns and backward; FlopCounterMode at
    batch 1) and the saved bytes most alive at once at batch 1 and 2,
    split into what a step holds whatever its batch (the bf16 casts of the
    weights, say) and what each sequence adds. Kept per (config, S) for
    the process."""
    from repro_torch.models import build_model
    cfg = dataclasses.replace(cfg, attention_impl="xla")
    key = (cfg, S)
    if key not in _STEP_COSTS:
        model = build_model(cfg, ispec.META)
        params, _ = ispec._abstract_params(cfg)
        leaves = [p.requires_grad_(True) for p in tree_util.leaves(params)]

        def step(batch):
            loss = model.loss(tree_util.unflatten_like(params, leaves),
                              batch)[0]
            torch.autograd.grad(loss, leaves, allow_unused=True)
        b1, b2 = _meta_batch(cfg, 1, S), _meta_batch(cfg, 2, S)
        with FlopCounterMode(display=False) as fc:
            saved1 = _live_saved(lambda: step(b1), leaves)
        saved2 = _live_saved(lambda: step(b2), leaves)
        _STEP_COSTS[key] = {"flops": int(fc.get_total_flops()),
                            "saved_fixed": int(2 * saved1 - saved2),
                            "saved_per_seq": int(saved2 - saved1)}
    return dict(_STEP_COSTS[key])


def forward_flops(cfg, shape) -> int:
    """FLOPs of one prefill of one sequence, or one decode step of one
    row over a cache of the shape's length, on `meta`."""
    from repro_torch.models import build_model
    cfg = dataclasses.replace(cfg, attention_impl="xla")
    model = build_model(cfg, ispec.META)
    params, _ = ispec._abstract_params(cfg)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        if shape.kind == "prefill":
            batch = _meta_batch(cfg, 1, shape.seq_len)
            # a vlm's cache also holds its patches (the reference's)
            model.prefill(params, batch, shape.seq_len + (
                cfg.frontend_seq if cfg.family == "vlm" else 0))
        else:
            cache = model.init_cache(1, shape.seq_len)
            tok = torch.zeros((1,), dtype=torch.int64, device=ispec.META)
            model.decode_step(params, cache, tok, shape.seq_len - 1)
    return int(fc.get_total_flops())


def _peak_train(state: int, grads: int, act: int, flavor: str,
                ring: int) -> int:
    """A training step's peak: the backward holds the resident states,
    the step's candidates so far, the grads and the activations; the
    optimizer then builds a candidate beside each old state leaf by leaf
    (`Optimizer.apply`) while the grads are still held. `baseline` (the
    unprotected trainer): max(state + grads + act, 2 state + grads).
    `sedar` (the sequential dual: two states and a ring slot resident,
    each replica's candidate kept for the commit compare): max(3 state +
    grads + act, 4 state + grads) + ring."""
    if flavor == "baseline":
        return max(state + grads + act, 2 * state + grads)
    return max(3 * state + grads + act, 4 * state + grads) + ring


def run_cell(arch: str, shape_name, flavor: str = "baseline",
             out_dir: Optional[str] = None, cfg=None,
             mesh: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    """The cell's report (module docstring). `shape_name` names one of
    SHAPES or is a `ShapeSpec`; `cfg` the arch's config (a cut-down one,
    or another remat policy, say). `mesh` ({axis: size} over pod, data
    and model) plans the cell on that mesh of ranks, where the reference
    plans its production mesh, by the reference's rules: the data axes
    ("pod", "data") under `baseline` on a pod mesh, ("data",) under
    `sedar`, whose pods are the replicas, and sequence parallelism for
    every shape but decode; each rank's bytes from the Resolver's specs
    (`plan_ranks`: a training cell's state, grads and ring, a serving
    cell's bf16 params and its block of the KV cache) with the fallback
    report; without it, one card, whose report stays as it was."""
    cfg = cfg or get_config(arch)
    shape = (SHAPE_BY_NAME[shape_name] if isinstance(shape_name, str)
             else shape_name)
    shape_name = shape.name
    t0 = time.time()
    cell: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "flavor": flavor,
        "device": {"name": "NVIDIA H100 80GB HBM3",
                   "hbm_bytes": H100_HBM_BYTES,
                   "bf16_flops_per_s": H100_BF16_FLOPS,
                   "hbm_bytes_per_s": H100_HBM_BYTES_PER_S}}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        cell.update({"status": "skipped", "reason": reason})
        return _emit(cell, out_dir)
    if flavor not in FLAVORS:
        raise ValueError(f"unknown flavor {flavor!r} ({FLAVORS})")
    if flavor == "sedar" and shape.kind != "train":
        cell.update({"status": "skipped",
                     "reason": "the sedar flavor is the training dual"})
        return _emit(cell, out_dir)

    if mesh is not None:
        if flavor == "sedar" and mesh.get("pod", 1) < 2:
            cell.update({"status": "skipped",
                         "reason": "sedar flavor needs the pod axis"})
            return _emit(cell, out_dir)
        pods = flavor == "baseline" and mesh.get("pod", 1) > 1
        rules = ShardingRules(data_axes=("pod", "data") if pods
                              else ("data",),
                              sequence_parallel=shape.kind != "decode")
        plan = plan_ranks(cfg, mesh, rules, flavor, shape)
        cell.update({"mesh": plan["mesh"], "ranks": plan["ranks"],
                     "sharding_fallbacks": plan["fallbacks"][:40]})
        if "whole" in plan:
            cell["whole"] = plan["whole"]
    from repro_torch.models.model import count_params_analytic
    B = shape.global_batch
    S = shape.seq_len
    # one card: a mesh of one data and one model rank, every leaf whole
    resolver = Resolver({"data": 1, "model": 1}, ShardingRules())
    n_params = count_params_analytic(cfg)
    n_active = count_params_analytic(cfg, active_only=True)
    mem: Dict[str, Any] = {}
    if shape.kind == "train":
        st_specs, st_axes = ispec.train_state_specs(cfg)
        ispec.shardings(resolver, st_specs, st_axes)
        state = ispec.nbytes(st_specs)
        grads = ispec.nbytes(st_specs["params"])
        ring = state if flavor == "sedar" else 0
        cost = train_step_cost(cfg, S)
        per_seq, fixed = cost["saved_per_seq"], cost["saved_fixed"]

        def peak(b):
            return _peak_train(state, grads, fixed + b * per_seq, flavor,
                               ring)
        resident = state * (2 if flavor == "sedar" else 1) + ring
        mem.update({"peak_model": "baseline: max(state + grads + act, 2 "
                    "state + grads); sedar: max(3 state + grads + act, 4 "
                    "state + grads) + ring; the transients of a step that "
                    "autograd does not save (a CE chunk's logits, "
                    "workspace) are not counted",
                    "state_bytes": state, "grads_bytes": grads,
                    "ring_slot_bytes": ring, "resident_bytes": resident,
                    "remat": cfg.remat,
                    "activation_bytes_per_seq": per_seq,
                    "activation_bytes_fixed": fixed,
                    "activation_bytes": fixed + B * per_seq,
                    "activation_method": "counted on meta: autograd's "
                    "saved tensors of a step at batch 1 and 2, most alive "
                    "at once"})
        flops_per_seq = cost["flops"]
        flops = flops_per_seq * B
        model_flops = 6 * n_active * B * S
        bytes_moved = 2 * state + grads * 2      # read state, write it; grads
    else:
        p_specs, p_axes = ispec.serve_param_specs(cfg)
        ispec.shardings(resolver, p_specs, p_axes)
        params = ispec.nbytes(p_specs)
        cache_specs, cache_axes = ispec.decode_specs(
            cfg, dataclasses.replace(shape, global_batch=1))
        ispec.shardings(resolver, cache_specs["cache"], cache_axes["cache"])
        cache_per_seq = ispec.nbytes(cache_specs["cache"])
        V = cfg.vocab_size

        def peak(b):      # params, caches, the f32 logits of b rows
            return params + b * (cache_per_seq + 4 * V)
        mem.update({"peak_model": "the bf16 params, the decode caches and "
                    "the f32 logits of the batch's rows; a prefill's "
                    "activations, live one layer at a time, are not "
                    "counted",
                    "serve_param_bytes": params,
                    "cache_bytes_per_seq": cache_per_seq,
                    "cache_bytes": B * cache_per_seq})
        flops_per_seq = forward_flops(cfg, shape)
        flops = flops_per_seq * B
        tokens = B * S if shape.kind == "prefill" else B
        model_flops = 2 * n_active * tokens
        bytes_moved = params + B * cache_per_seq
    b_max = 0
    while peak(b_max + 1) <= H100_HBM_BYTES and b_max < B:
        b_max += 1
    if b_max == B:     # it fits; how far beyond the shape's batch
        hi = B
        while peak(2 * hi) <= H100_HBM_BYTES:
            hi *= 2
        lo = hi
        hi *= 2
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if peak(mid) <= H100_HBM_BYTES else (lo, mid)
        b_max = lo
    mem.update({"batch": B, "peak_bytes": peak(B),
                "fits_80GB": bool(peak(B) <= H100_HBM_BYTES),
                "max_batch": b_max})
    compute_s = flops / H100_BF16_FLOPS
    memory_s = bytes_moved / H100_HBM_BYTES_PER_S
    cell.update({
        "status": "ok",
        "memory": mem,
        "flops": {"per_seq": flops_per_seq, "total": flops,
                  "method": "FlopCounterMode on meta, attention_impl=xla",
                  "model_flops": float(model_flops)},
        "roofline": {"compute_s": compute_s, "memory_s": memory_s,
                     "dominant": "compute" if compute_s >= memory_s
                     else "memory",
                     "bound_s": max(compute_s, memory_s)},
        "params": int(n_params), "active_params": int(n_active),
        "sharding_fallbacks": cell.get("sharding_fallbacks",
                                       resolver.fallback_report()[:40]),
        "elapsed_s": round(time.time() - t0, 1),
    })
    return _emit(cell, out_dir)


# ---------------------------------------------------------------------------
# The sharded training program
# ---------------------------------------------------------------------------

def _half_params(params):
    """The f32 masters as bf16 before the layers' FSDP gathers (the
    reference's `_half_params`), so weight gathers move bf16; the
    gradients are f32 partial sums until their reduce-scatter, and bf16
    after it (`transformer.ShardCtx`). Also a serving deployment's
    weights (`input_specs.serve_param_specs`)."""
    return tree_util.tree_map(
        lambda p: p.to(torch.bfloat16) if p.dtype == torch.float32 else p,
        params)


class TrainProgram:
    """One rank's training step of `build_train_program`:
    `program(state, batch)` on this rank's block of the state
    (`shard_state`) and its rows of the batch (`shard_batch`). `specs`
    holds the state's partition entries, `ctx` the rank's
    `transformer.ShardCtx`."""

    def __init__(self, step, cfg, mesh, resolver, specs, ctx,
                 microbatches: int):
        self._step = step
        self.cfg, self.mesh, self.resolver = cfg, mesh, resolver
        self.specs, self.ctx, self.microbatches = specs, ctx, microbatches

    def __call__(self, state, batch, fault=None, grads_out=None):
        return self._step(state, batch, fault, grads_out)

    def shard_state(self, state):
        return bridge.shard_state(state, self.resolver, self.mesh, self.cfg,
                                  self.specs["params"])

    def shard_batch(self, batch):
        return bridge.shard_batch(batch, self.resolver, self.mesh,
                                  self.microbatches)


def build_train_program(cfg, shape, mesh, resolver, flavor, train_cfg=None,
                        microbatches: int = 1, device=None):
    """The full training step on rank `mesh` (a `launch/mesh.py::
    ProcessMesh`) of a process mesh (the reference's
    `build_train_program`): the f32 masters cast to bf16
    (`_half_params`), grads accumulated over `microbatches` (each
    microbatch's f32 grads / M, summed in order; the loss the mean of
    theirs), AdamW (`Optimizer.apply`, leaf by leaf) on the rank's block
    of the state, the clip's global norm summed over every block. Returns
    (program, (state_specs, batch_specs)): a `TrainProgram` and the
    global `meta` specs, as the reference returns its jitted step and
    ShapeDtypeStructs.

    The layers shard as `transformer.ShardCtx` with the resolver's specs
    says (tensor, sequence and FSDP parallelism). Each data rank's loss
    is the mean over its rows; its backward runs on loss / D, the grads
    of the leaves that are not data-sharded are summed over the data axes
    (`fsdp_reduce`, f32 partials), and the returned loss is the mean over
    the data ranks.

    flavor `baseline`: the batch splits over the rules' data axes
    (("pod", "data") on a pod mesh); the step returns (new_state, loss).
    flavor `sedar`: the pods carry the two replicas and see the same
    batch; each rank fingerprints its grads block (K1 lanes, one lane,
    `core/fingerprint.py::pytree_fingerprint_lanes`), compares it over
    its pod group (`core/detection.py::make_pod_comparator`) and the
    verdict is combined over every rank (`verdict`), so every rank gates
    the same commit; the step returns (cand, (loss, eq, fp_all)) and the
    caller commits cand only where eq holds. `fp_all` is per block where
    the reference's covers the global tree; the verdict is what agrees.

    `program(state, batch, fault=(leaf, element, bit))` flips that bit of
    this rank's f32 grads block before the fingerprint;
    `grads_out` (a list) receives the block's f32 grads. On a mesh of one
    rank the program is the unsharded code: `Model.loss` and
    `Optimizer.apply` on the whole state, bit for bit. The device is the
    card's unless `device` says otherwise."""
    import torch.distributed as dist

    from repro_torch import sharding as shd
    from repro_torch.configs import TrainConfig
    from repro_torch.core import hostsync
    from repro_torch.core.detection import make_pod_comparator
    from repro_torch.core.fingerprint import pytree_fingerprint_lanes
    from repro_torch.core.injection import flip_bit
    from repro_torch.launch.mesh import make_axes_group
    from repro_torch.models import build_model
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.transformer import ShardCtx
    from repro_torch.optim import make_optimizer

    if flavor not in FLAVORS:
        raise ValueError(f"unknown flavor {flavor!r} ({FLAVORS})")
    if flavor == "sedar" and mesh.n_pods < 2:
        raise ValueError("the sedar flavor needs the pod axis")
    if flavor == "sedar" and len(mesh.ranks) != dist.get_world_size():
        raise ValueError("the sedar flavor's verdict runs over every rank "
                         "of the process group: the mesh must span them")
    dev = torch.device(device or "cuda")
    model = build_model(cfg, dev)
    opt = make_optimizer(train_cfg or TrainConfig())
    M = int(microbatches)
    state_specs, state_axes = ispec.train_state_specs(cfg)
    bspecs, _ = ispec.batch_specs(cfg, shape)
    specs = ispec.shardings(resolver, state_specs, state_axes)
    rules = resolver.rules
    data_group = None
    if tuple(rules.data_axes) != ("data",) and rules.axis_size(
            mesh, rules.data_axes) > 1:
        data_group = make_axes_group(mesh, rules.data_axes)
    ctx = ShardCtx(mesh, resolver, specs=specs["params"],
                   data_group=data_group, dtype=torch_dtype(cfg.dtype))
    model_axis, data_axis = ctx.model_axis, ctx.data_axis
    D = data_axis.size
    pspecs = bridge.spec_leaves(state_specs["params"], specs["params"])
    d_entry = ctx._entry(rules.data_axes)
    m_entry = ctx._entry(rules.model_axes)
    d_sharded = [d_entry in s for s in pspecs]
    # each element once in the clip's norm: a leaf whole over an axis
    # counts on that axis' rank 0
    counted = [(m_entry in s or model_axis.index == 0)
               and (d_sharded[i] or data_axis.index == 0)
               for i, s in enumerate(pspecs)]
    local = model_axis.size == 1 and D == 1
    pod_cmp = make_pod_comparator(mesh) if flavor == "sedar" else None

    def norm_sq(grads):
        total = 0
        for g, c in zip(grads, counted):
            if c:
                total = total + torch.sum(torch.square(g.to(torch.float32)))
        total = torch.as_tensor(total, dtype=torch.float32, device=dev)
        total = shd.all_sum(total, model_axis, "grad_norm")
        return shd.all_sum(total, data_axis, "grad_norm")

    def grads_of(half, batch):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_util.leaves(half)]
        loss = model.loss(tree_util.unflatten_like(half, leaves), batch,
                          ctx)[0]
        obj = loss if D == 1 else loss * (1.0 / D)
        gs = torch.autograd.grad(obj, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(l) if g is None else g
                               for g, l in zip(gs, leaves)]

    def accumulate(half, batch):
        if M <= 1:
            loss, gs = grads_of(half, batch)
            return loss, [g.to(torch.float32) for g in gs]
        n = batch["tokens"].shape[0] // M
        acc, losses = None, []
        for i in range(M):
            loss, gs = grads_of(half, {k: v[i * n:(i + 1) * n]
                                       for k, v in batch.items()})
            losses.append(loss)
            if acc is None:
                acc = [torch.zeros(g.shape, dtype=torch.float32,
                                   device=g.device) for g in gs]
            acc = [a + g.to(torch.float32) / M for a, g in zip(acc, gs)]
            del gs
        return torch.mean(torch.stack(losses)), acc

    def verdict(eq):
        v = eq.to(torch.int32).reshape(1)
        with hostsync.collective("verdict",
                                 4 * (dist.get_world_size() - 1)):
            dist.all_reduce(v, op=dist.ReduceOp.MIN)
        return v[0] == 1

    def step(state, batch, fault=None, grads_out=None):
        half = _half_params(state["params"])
        loss, grads = accumulate(half, batch)
        del half
        if D > 1:
            loss = shd.all_sum(loss, data_axis, "loss_mean") / D
        if fault is not None:
            leaf, element, bit = fault
            grads[leaf] = flip_bit(grads[leaf], element, bit)
        if grads_out is not None:
            grads_out.extend(grads)
        if pod_cmp is not None:
            eq, fp_all = pod_cmp(pytree_fingerprint_lanes(grads, 1))
            eq = verdict(eq)
        new_p, new_opt = opt.apply(grads, state["opt"], state["params"],
                                   state["step"],
                                   norm_sq=None if local else norm_sq)
        new = {"params": new_p, "opt": new_opt, "step": state["step"] + 1}
        if pod_cmp is not None:
            return new, (loss, eq, fp_all)
        return new, loss

    return (TrainProgram(step, cfg, mesh, resolver, specs, ctx, M),
            (state_specs, bspecs))


# ---------------------------------------------------------------------------
# The sharded serving programs
# ---------------------------------------------------------------------------

def serve_max_len(cfg, shape) -> int:
    """The prefill cache's rows (the reference's rule): the prompt, and a
    vlm's frontend positions before it."""
    return shape.seq_len + (cfg.frontend_seq if cfg.family == "vlm" else 0)


def _cache_meta(cfg, shape, max_len: Optional[int] = None):
    """(the KV cache on `meta` that a serving shape's program holds, its
    logical axes): a prefill's of `max_len` rows (default
    `serve_max_len`), a decode's of the shape's length
    (`input_specs.decode_specs`)."""
    from repro_torch.models import build_model
    from repro_torch.models.model import cache_axes
    if shape.kind == "prefill":
        cache = build_model(cfg, ispec.META).init_cache(
            shape.global_batch, max_len or serve_max_len(cfg, shape))
        return cache, cache_axes(cache)
    specs, axes = ispec.decode_specs(cfg, shape)
    return specs["cache"], axes["cache"]


class ServeProgram:
    """One rank's serving program of `build_prefill_program` or
    `build_decode_program`: `program(...)` on the rank's block of the bf16
    params (`shard_params`), its rows of the batch (`shard_batch`) and its
    block of the KV cache (`shard_cache`). `specs` holds the params'
    partition entries, `cache_specs` the cache's, `ctx` the rank's
    `transformer.ShardCtx`. `gather_cache` and `gather_logits` join the
    ranks' blocks (the tests' and the card checks' view: no rank holds
    the whole)."""

    def __init__(self, fn, cfg, mesh, resolver, specs, cache_specs, ctx):
        self._fn = fn
        self.cfg, self.mesh, self.resolver = cfg, mesh, resolver
        self.specs, self.cache_specs, self.ctx = specs, cache_specs, ctx

    def __call__(self, *args):
        with torch.no_grad():
            return self._fn(*args)

    def _sizes(self):
        return bridge.mesh_sizes(self.resolver)

    def shard_params(self, params):
        return bridge.shard_params(_half_params(params), self.resolver,
                                   self.mesh, self.cfg, self.specs)

    def shard_batch(self, batch):
        return bridge.shard_batch(batch, self.resolver, self.mesh)

    def shard_cache(self, cache):
        sizes, c = self._sizes(), bridge.mesh_coords(self.mesh)
        return tree_util.tree_map(
            lambda t, sp: bridge.shard_leaf(t, sp, c, sizes), cache,
            self.cache_specs)

    def _join(self, blocks, spec):
        sizes = self._sizes()
        coords = [bridge.rank_coords(r, sizes) for r in range(len(blocks))]
        return bridge._join(blocks, spec, coords, sizes)

    def gather_cache(self, blocks):
        """The whole cache from every rank's block, `blocks[r]` rank r's in
        the mesh's order."""
        return tree_util.tree_map(
            lambda b0, sp, *bs: self._join((b0,) + bs, sp), blocks[0],
            self.cache_specs, *blocks[1:])

    def gather_logits(self, blocks):
        """The whole (B, V) logits from every rank's (its rows; its vocab
        block where the vocab splits)."""
        B = blocks[0].shape[0] * self.ctx.data_axis.size
        spec = Resolver(self.resolver.mesh, self.resolver.rules).spec(
            ("batch", "vocab"), (B, self.cfg.vocab_size))
        return self._join(blocks, spec)


def _serve_setup(cfg, mesh, resolver, device):
    """What both serving programs take: the model on the device, the bf16
    params' specs and partition entries, the rank's `ShardCtx`."""
    from repro_torch.launch.mesh import make_axes_group
    from repro_torch.models import build_model
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.transformer import ShardCtx
    model = build_model(cfg, torch.device(device or "cuda"))
    pspecs, paxes = ispec.serve_param_specs(cfg)
    specs = ispec.shardings(resolver, pspecs, paxes)
    rules = resolver.rules
    data_group = None
    if tuple(rules.data_axes) != ("data",) and rules.axis_size(
            mesh, rules.data_axes) > 1:
        data_group = make_axes_group(mesh, rules.data_axes)
    ctx = ShardCtx(mesh, resolver, specs=specs, data_group=data_group,
                   dtype=torch_dtype(cfg.dtype))
    return model, pspecs, specs, ctx


def build_prefill_program(cfg, shape, mesh, resolver, device=None,
                          max_len: Optional[int] = None):
    """The reference's `build_prefill_program` on rank `mesh` (a
    `launch/mesh.py::ProcessMesh`) of a process mesh: `Model.prefill` of
    the bf16 serving params (`input_specs.serve_param_specs`) over the
    rank's rows of the batch (the rules' data axes) into a KV cache of
    `max_len` rows, by default the reference's rule (`serve_max_len`: the
    prompt, and a vlm's frontend positions); a larger `max_len` leaves
    room for decode steps. Returns (program, (param_specs, batch_specs)):
    a `ServeProgram` whose `program(params, batch)` gives (the rank's
    logits of the last position, its vocab block where the vocab splits;
    the rank's block of the cache), and the global `meta` specs, as the
    reference returns its jitted function and ShapeDtypeStructs.

    The layers run as the sharded training forward does
    (`transformer.ShardCtx`: attention over the heads, or the rows over
    the model ranks where the heads do not split; SP under the rules;
    FSDP gathers over the data axes); the k/v then move into the cache's
    layout, ("layers", "batch", None, "kv_heads", "head_dim") resolved
    (`transformer._cache_block`). On a mesh of more than one rank the
    products whose partials a collective sums take f32 carriers and round
    once; on a mesh of one rank the program is `Model.prefill` on the
    whole params, bit for bit. The device is the card's unless `device`
    says otherwise."""
    model, pspecs, specs, ctx = _serve_setup(cfg, mesh, resolver, device)
    bspecs, _ = ispec.batch_specs(cfg, shape)
    T = max_len or serve_max_len(cfg, shape)
    cache_specs = ispec.shardings(resolver, *_cache_meta(cfg, shape, T))

    def prefill(params, batch):
        return model.prefill(params, batch, T, ctx=ctx)

    return (ServeProgram(prefill, cfg, mesh, resolver, specs, cache_specs,
                         ctx), (pspecs, bspecs))


def build_decode_program(cfg, shape, mesh, resolver, device=None):
    """The reference's `build_decode_program` on rank `mesh` of a process
    mesh: one token per row at a host-int position `pos` (the reference's
    unsharded scalar), `Model.decode_step` of the bf16 serving params on
    the rank's block of the KV cache of the shape's length
    (`input_specs.decode_specs`), written in place (the reference donates
    it). Returns (program, (param_specs, cache_specs, token_specs,
    pos_spec)): a `ServeProgram` whose `program(params, cache, tokens,
    pos)` gives (the rank's logits, its vocab block where the vocab
    splits; the cache), and the global `meta` specs.

    Decode has no sequence parallelism; attention follows the cache
    (`transformer._attn_decode`): by kv heads where they split over
    the model ranks, else by blocks of the head dim with the partial
    scores summed in f32; the MLP column- then row-parallel; MoE over the
    model ranks where the rows split (the reference's condition), else
    each data shard routing as one group. On a mesh of one rank the
    program is `Model.decode_step` on the whole params, bit for bit."""
    model, pspecs, specs, ctx = _serve_setup(cfg, mesh, resolver, device)
    dspecs, _ = ispec.decode_specs(cfg, shape)
    cache_specs = ispec.shardings(resolver, *_cache_meta(cfg, shape))

    def decode(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, int(pos), ctx=ctx)

    return (ServeProgram(decode, cfg, mesh, resolver, specs, cache_specs,
                         ctx),
            (pspecs, dspecs["cache"], dspecs["tokens"], dspecs["pos"]))


def _shard_bytes(meta: torch.Tensor, spec, sizes: Dict[str, int]) -> int:
    n = meta.numel()
    for entry in spec:
        n //= bridge.block_index(entry, dict.fromkeys(sizes, 0), sizes)[1]
    return n * meta.element_size()


def plan_ranks(cfg, sizes: Dict[str, int], rules: ShardingRules,
               flavor: str = "baseline", shape=None) -> Dict[str, Any]:
    """The mesh of ranks' memory plan, from the Resolver's specs of the
    sharded trees, with the fallback report. A training cell (no `shape`,
    or a train shape): each rank's bytes of the training state (f32
    params, the AdamW moments, the step), of its f32 grads and, under
    `sedar`, of its device-ring slot (one state), `build_train_program`'s
    blocks. A prefill or decode `shape`: each rank's bytes of the bf16
    serving params and of its block of the KV cache (the prefill's of
    `serve_max_len` rows, the decode's of the shape's length), the
    serving programs' blocks, and under "whole" the same unsharded."""
    resolver = Resolver(sizes, rules)
    full = {a: int(sizes.get(a, 1)) for a in bridge.MESH_AXES}
    n = full["pod"] * full["data"] * full["model"]

    def nbytes(tree, spec_tree):
        return sum(_shard_bytes(t, sp, full) for t, sp in zip(
            tree_util.leaves(tree), bridge.spec_leaves(tree, spec_tree)))
    if shape is not None and shape.kind != "train":
        p_specs, p_axes = ispec.serve_param_specs(cfg)
        cache, c_axes = _cache_meta(cfg, shape)
        rank = {"serve_param_bytes": nbytes(p_specs, ispec.shardings(
                    resolver, p_specs, p_axes)),
                "cache_bytes": nbytes(cache, ispec.shardings(
                    resolver, cache, c_axes))}
        return {"mesh": full, "ranks": [dict(rank) for _ in range(n)],
                "fallbacks": resolver.fallback_report(),
                "whole": {"serve_param_bytes": ispec.nbytes(p_specs),
                          "cache_bytes": ispec.nbytes(cache)}}
    st_specs, st_axes = ispec.train_state_specs(cfg)
    specs = ispec.shardings(resolver, st_specs, st_axes)
    state = nbytes(st_specs, specs)
    grads = nbytes(st_specs["params"], specs["params"])
    rank = {"state_bytes": state, "grads_bytes": grads,
            "ring_slot_bytes": state if flavor == "sedar" else 0}
    return {"mesh": full, "ranks": [dict(rank) for _ in range(n)],
            "fallbacks": resolver.fallback_report()}


def _emit(cell: Dict[str, Any], out_dir: Optional[str]) -> Dict[str, Any]:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        mesh = "".join(f"__{a}{n}" for a, n in cell.get("mesh", {}).items())
        name = (f"{cell['arch']}__{cell['shape']}__{cell['flavor']}"
                f"{mesh}.json")
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(cell, f, indent=1, default=str)
    mem = cell.get("memory", {})
    gib = 2 ** 30
    print(f"[dryrun] {cell['arch']:24s} {cell['shape']:12s} "
          f"{cell['flavor']:8s} {cell.get('status'):8s} "
          + (f"peak {mem['peak_bytes'] / gib:.2f} GiB at batch "
             f"{mem['batch']}, fits {mem['fits_80GB']}, max batch "
             f"{mem['max_batch']}, dominant "
             f"{cell['roofline']['dominant']}, t={cell['elapsed_s']}s"
             if cell.get("status") == "ok" else cell.get("reason", ""))
          + (f"; mesh {cell['mesh']}: per rank " + ", ".join(
              f"{k[:-6].replace('_', ' ')} {v / gib:.2f} GiB"
              for k, v in cell["ranks"][0].items() if k != "ring_slot_bytes")
             if cell.get("ranks") else ""),
          flush=True)
    return cell


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--flavor", default="baseline",
                    choices=[*FLAVORS, "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--mesh", default=None,
                    help="plan the cells on a mesh of ranks, e.g. "
                    "pod=2,data=1,model=2 (default: one card)")
    args = ap.parse_args(argv)
    mesh = (None if args.mesh is None else
            {k: int(v) for k, v in (a.split("=")
                                    for a in args.mesh.split(","))})
    archs = ASSIGNED_ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = ([s.name for s in SHAPES] if args.shape == "all"
              else args.shape.split(","))
    flavors = list(FLAVORS) if args.flavor == "both" else [args.flavor]
    for arch in archs:
        for shape in shapes:
            for fl in flavors:
                run_cell(arch, shape, fl, args.out, mesh=mesh)


if __name__ == "__main__":
    main()
