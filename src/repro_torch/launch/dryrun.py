"""One card's dry run of a cell (arch x shape x flavor): what the port
would hold and compute on one NVIDIA H100, predicted without the card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \
        --shape train_4k --flavor sedar

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

No counterpart here: the reference's HLO collective parsers (one card has
no collectives), its TPU v5e hardware model (this card's constants are
below) and its scan-cost `Probe`s (a Python loop over the layers on
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
             out_dir: Optional[str] = None, cfg=None) -> Dict[str, Any]:
    """The cell's report (module docstring). `shape_name` names one of
    SHAPES or is a `ShapeSpec`; `cfg` the arch's config (a cut-down one,
    or another remat policy, say)."""
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
        "sharding_fallbacks": resolver.fallback_report()[:40],
        "elapsed_s": round(time.time() - t0, 1),
    })
    return _emit(cell, out_dir)


def _emit(cell: Dict[str, Any], out_dir: Optional[str]) -> Dict[str, Any]:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{cell['arch']}__{cell['shape']}__{cell['flavor']}.json"
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
             if cell.get("status") == "ok" else cell.get("reason", "")),
          flush=True)
    return cell


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--flavor", default="baseline",
                    choices=[*FLAVORS, "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    archs = ASSIGNED_ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = ([s.name for s in SHAPES] if args.shape == "all"
              else args.shape.split(","))
    flavors = list(FLAVORS) if args.flavor == "both" else [args.flavor]
    for arch in archs:
        for shape in shapes:
            for fl in flavors:
                run_cell(arch, shape, fl, args.out)


if __name__ == "__main__":
    main()
