"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch
(the reference's `models/moe.py`): the one-process `moe_mlp` and the
expert-parallel `moe_mlp_ep` over the model group of a process mesh.

Dispatch groups: the reference routes every call's tokens as ONE group,
and where it serves several independent decodes at once it vmaps them (the
fused backend's two replicas, `serve()`'s B=1 slot decodes), so each of
those routes on its own. The port stacks such decodes as the rows of one
batch, so `moe_mlp(groups=G)` splits the rows into G equal groups, each
with its own cumsum positions and its own capacity from its own tokens: a
group routes exactly as the reference's vmapped call does, whatever the
other groups hold. (The fused backend's replicas run as separate row
blocks, `Model.decode_step` and `Model.prefill`; stacked, a host-int
position routes each replica's rows as one group, `lm_decode_step`.)

Routing exactly as the reference: an f32 softmax over the router logits,
`top_k` and renormalisation; each (token, choice) pair takes the next
free position of its expert in token-major order (t * k + j, a cumsum);
capacity Cg = max(ceil(k T / E * 1.25), 4); pairs past capacity are
dropped and their token keeps only the residual path; the Switch
load-balance aux loss.

Determinism across replicas (SEDAR compares them bit for bit): the
dispatch writes only the kept pairs, whose (expert, position) slots are
unique, and the dropped ones into a spare row that is cut off, so no write
accumulates (no `index_add_`/`scatter_add_`, whose float atomics on the
card sum in any order); the combine gathers each pair's row and sums the
k choices in f32 in a fixed order.

Expert parallelism (`moe_mlp_ep`, picked by `moe_mlp(ctx=)` under the
reference's condition: E % tp == 0, the tokens split over the token shards
and tp > 1). The rank of model index m holds its data shard's tokens, as
every rank of its model group does, and the experts [m E/tp, (m+1) E/tp)
(`bridge.expert_shard`). It routes its 1/tp slice of the tokens, in the
reference's token order, on its own (local positions, capacity Cl =
max(ceil(k Tl / E * 1.25), 4)), dispatches them into (E, Cl, D) as above,
then one all_to_all over the model group gives each rank its experts'
queues (E/tp, tp Cl, D), the local experts run, the reverse all_to_all
brings the results home, the combine runs as above, and an all_gather
over the model group rebuilds the data shard's tokens (what GSPMD does
for the reference's token-sharded output). The aux loss and the drop
fraction are means over every token shard (all_reduce over the model,
then the data group).

Each exchange is a `torch.autograd.Function` whose backward is the
adjoint exchange, so a loss's gradient flows through EP: the all_to_all's
is the all_to_all itself, the token slice's an all_gather of the slices'
grads, the all_gather's the rank's own slice, and the router (replicated
over the model group, each rank routing its slice) sums its grads over the
model group. The aux mean passes 1/tp of its grad to each rank's own aux:
with the trainers' convention (each data rank's loss a mean over its
shard, grads averaged over the data group) that is the gradient of the
global mean. Every collective runs through `core/hostsync.py::collective`
(labels `ep_dispatch`, `ep_combine`, `ep_gather`, `ep_stats`), staged
through host memory on the card: gloo's all_to_all takes CPU tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _pdt, normal_init, wein

CAPACITY_FACTOR = 1.25   # the reference's moe_mlp default


def moe_axes(layers: Optional[int] = None):
    """The MoE params' logical axes (the reference's `init_moe`'s second
    return value), for `sharding.Resolver`."""
    L = ("layers",) if layers else ()
    return {"router": L + ("embed", None),
            "w_gate": L + ("experts", "embed", "mlp"),
            "w_up": L + ("experts", "embed", "mlp"),
            "w_down": L + ("experts", "mlp", "embed")}


def init_moe(gen, cfg, layers: Optional[int], device):
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    L = (layers,) if layers else ()
    pdt = _pdt(cfg)
    return {
        "router": normal_init(gen, L + (D, E), pdt, 1.0 / math.sqrt(D), device),
        "w_gate": normal_init(gen, L + (E, D, F_), pdt, 1.0 / math.sqrt(D),
                              device),
        "w_up": normal_init(gen, L + (E, D, F_), pdt, 1.0 / math.sqrt(D),
                            device),
        "w_down": normal_init(gen, L + (E, F_, D), pdt, 1.0 / math.sqrt(F_),
                              device),
    }


def capacity(cfg, T: int) -> int:
    """Positions per expert for T tokens (one dispatch group)."""
    k, E = cfg.experts_per_token, cfg.num_experts
    return max(int(math.ceil(k * T / E * CAPACITY_FACTOR)), 4)


def moe_mlp(cfg, p, x, groups: int = 1, ctx=None):
    """x: (B, S, D) -> ((B, S, D), {"moe_aux", "moe_drop_frac"}). The B rows
    form `groups` dispatch groups G of B / G rows each, routed
    independently: the kept pairs of group g at their unique slot
    e * G * Cg + g * Cg + pos, so the experts see (E, G * Cg, D), each
    group's positions a run of Cg rows. The aux loss and drop fraction are
    means over the groups.

    `ctx` (a `transformer.ShardCtx`): x is this rank's data shard. EP runs
    where the reference's condition holds (E % tp == 0, the data shard's
    tokens split over tp, tp > 1); otherwise the shard routes as its own
    group, which is the reference's grouping by the data degree."""
    B, S, D = x.shape
    if ctx is not None and ctx.expert_parallel(cfg, B * S):
        if groups != 1:
            raise ValueError("expert parallelism routes one dispatch "
                             "group per token shard")
        return moe_mlp_ep(cfg, p, x, ctx)
    G = groups
    if G < 1 or B % G:
        raise ValueError(f"{B} rows do not split into {G} dispatch groups")
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    Tg = T // G
    dt = x.dtype
    xt = x.reshape(T, D)

    # ---- route -----------------------------------------------------------
    logits = wein("td,de->te", xt, p["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    gate_w, gate_idx = torch.topk(probs, k, dim=-1)             # (T, k)
    gate_w = gate_w / torch.sum(gate_w, dim=-1, keepdim=True)

    # load-balance aux loss (Switch-style), per group
    me = torch.mean(probs.reshape(G, Tg, E), dim=1)
    ce = torch.mean(torch.sum(F.one_hot(gate_idx, E).float(), dim=1)
                    .reshape(G, Tg, E), dim=1)
    aux_loss = torch.mean(E * torch.sum(me * ce, dim=-1))

    # ---- dispatch --------------------------------------------------------
    Cg = capacity(cfg, Tg)
    flat_e = gate_idx.reshape(G, Tg * k)                        # t * k + j
    onehot = F.one_hot(flat_e, E)
    pos_in_e = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(pos_in_e, 2, flat_e[..., None])[..., 0].reshape(T * k)
    flat_e = flat_e.reshape(T * k)
    keep = pos < Cg
    src = torch.repeat_interleave(xt, k, dim=0) if k > 1 else xt
    group = torch.arange(G, device=x.device).repeat_interleave(Tg * k)
    # kept pairs at their unique slot, dropped pairs into the spare row
    # E * G * Cg, which is cut off
    slot = torch.where(keep, (flat_e * G + group) * Cg + pos,
                       torch.full_like(pos, E * G * Cg))
    # the buffer is made from `src`, so under torch.vmap (fused training)
    # it is batched as the rows written into it are
    src = src.to(dt)
    buf = src.new_zeros((E * G * Cg + 1, D))
    buf.index_put_((slot,), src)
    buf = buf[:E * G * Cg].reshape(E, G * Cg, D)

    # ---- expert compute --------------------------------------------------
    h_g = torch.einsum("ecd,edf->ecf", buf, p["w_gate"].to(dt))
    h_u = torch.einsum("ecd,edf->ecf", buf, p["w_up"].to(dt))
    h = F.silu(h_g.float()).to(dt) * h_u
    out_buf = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(dt))

    # ---- combine ---------------------------------------------------------
    gathered = out_buf.reshape(E * G * Cg, D).index_select(
        0, torch.where(keep, slot, torch.zeros_like(slot)))
    gathered = torch.where(keep[:, None], gathered.float(),
                           torch.zeros((), device=x.device))
    w = gate_w.reshape(T * k, 1).float()
    contrib = (gathered * w).reshape(T, k, D)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out.reshape(B, S, D).to(dt), {
        "moe_aux": aux_loss,
        "moe_drop_frac": 1.0 - torch.mean(keep.float())}


# ---------------------------------------------------------------------------
# Expert parallelism over the model group
# ---------------------------------------------------------------------------

def _collective(label: str, fn, x: torch.Tensor) -> torch.Tensor:
    """`fn(host_tensor) -> host_tensor`, a gloo collective, on x staged
    through host memory when x is on the card, counted under `label`."""
    from repro_torch.core import hostsync
    with hostsync.collective(label):
        out = fn(x.detach().to("cpu", copy=True).contiguous())
        return out.to(x.device)


def _all_to_all(x: torch.Tensor, group, label: str) -> torch.Tensor:
    """x: (tp, ...) -> (tp, ...) with out[r] = rank r's x[me]."""
    import torch.distributed as dist

    def run(h):
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=group)
        return out
    return _collective(label, run, x)


def _all_gather(x: torch.Tensor, group, tp: int, label: str) -> torch.Tensor:
    """x: (n, ...) -> (tp * n, ...), the model group's slices in order."""
    import torch.distributed as dist

    def run(h):
        parts = [torch.empty_like(h) for _ in range(tp)]
        dist.all_gather(parts, h, group=group)
        return torch.cat(parts)
    return _collective(label, run, x)


def _all_reduce(x: torch.Tensor, groups, label: str) -> torch.Tensor:
    """x summed over each group of `groups` in turn."""
    import torch.distributed as dist

    def run(h):
        for g in groups:
            dist.all_reduce(h, group=g)
        return h
    return _collective(label, run, x)


class _Exchange(torch.autograd.Function):
    """The tiled all_to_all of (tp, ...) blocks over the model group; its
    own adjoint."""

    @staticmethod
    def forward(ctx, x, group, label: str):
        ctx.group, ctx.label = group, label
        return _all_to_all(x, group, label)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, ctx.label), None, None


class _TokenSlice(torch.autograd.Function):
    """The rank's slice m of the model group's shared tokens (T, D) ->
    (T / tp, D); backward: the all_gather of every slice's grad."""

    @staticmethod
    def forward(ctx, x, group, tp: int, m: int):
        ctx.group, ctx.tp = group, tp
        n = x.shape[0] // tp
        return x[m * n:(m + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        return (_all_gather(g.contiguous(), ctx.group, ctx.tp, "ep_gather"),
                None, None, None)


class _TokenGather(torch.autograd.Function):
    """The all_gather of every rank's token slice (T / tp, D) -> (T, D);
    backward: the rank's own slice of the grad (each rank's loss reads
    the whole data shard)."""

    @staticmethod
    def forward(ctx, x, group, tp: int, m: int):
        ctx.m, ctx.n = m, x.shape[0]
        return _all_gather(x, group, tp, "ep_gather")

    @staticmethod
    def backward(ctx, g):
        return g[ctx.m * ctx.n:(ctx.m + 1) * ctx.n], None, None, None


class _GroupCopy(torch.autograd.Function):
    """Identity; backward: the grad summed over the model group (a weight
    every rank of it holds and applies to its own token slice)."""

    @staticmethod
    def forward(ctx, w, group):
        ctx.group = group
        return w

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), [ctx.group], "ep_gather"), None


class _TokenMean(torch.autograd.Function):
    """The mean of a per-rank value over every token shard (the model
    group, then the data group); backward: 1/tp of the grad to each rank's
    own value (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, groups, n: int, tp: int):
        ctx.tp = tp
        return _all_reduce(x, groups, "ep_stats") / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.tp, None, None, None


def moe_mlp_ep(cfg, p, x, ctx, capacity_factor: float = CAPACITY_FACTOR):
    """Expert-parallel MoE (the reference's `moe_mlp_ep`) on this rank:
    x (B, S, D), its data shard; p holds the full router and this rank's
    E/tp experts' slices of w_gate, w_up and w_down. Returns the data
    shard's (B, S, D) and {"moe_aux", "moe_drop_frac"}, each the mean over
    every token shard."""
    mesh = ctx.mesh
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    tp, m = ctx.tp_size(), mesh.model
    group = mesh.model_group
    E_l = E // tp
    if p["w_gate"].shape[-3] != E_l:
        raise ValueError(f"rank {mesh.rank} holds {p['w_gate'].shape[-3]} "
                         f"experts, expert parallelism over {tp} ranks "
                         f"wants {E_l} (bridge.expert_shard)")
    T = B * S
    Tl = T // tp
    Cl = max(int(math.ceil(k * Tl / E * capacity_factor)), 4)
    dt = x.dtype
    xt = _TokenSlice.apply(x.reshape(T, D), group, tp, m)      # (Tl, D)

    # ---- route (local) ---------------------------------------------------
    router = _GroupCopy.apply(p["router"], group)
    logits = torch.einsum("td,de->te", xt, router.to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = torch.topk(probs, k, dim=-1)
    gate_w = gate_w / torch.sum(gate_w, dim=-1, keepdim=True)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.sum(F.one_hot(gate_idx, E).float(), dim=1), dim=0)
    aux = E * torch.sum(me * ce)

    # ---- dispatch (local) ------------------------------------------------
    flat_e = gate_idx.reshape(Tl * k)
    onehot = F.one_hot(flat_e, E)
    pos = torch.gather(torch.cumsum(onehot, dim=0) - onehot, 1,
                       flat_e[:, None])[:, 0]
    keep = pos < Cl
    slot = torch.where(keep, flat_e * Cl + pos,
                       torch.full_like(pos, E * Cl))
    src = (torch.repeat_interleave(xt, k, dim=0) if k > 1 else xt).to(dt)
    buf = src.new_zeros((E * Cl + 1, D))
    buf.index_put_((slot,), src)
    buf = buf[:E * Cl].reshape(tp, E_l, Cl, D)

    # ---- token -> expert exchange: (E_l, tp * Cl, D), by source rank ------
    recv = _Exchange.apply(buf, group, "ep_dispatch")
    recv = recv.permute(1, 0, 2, 3).reshape(E_l, tp * Cl, D)
    hg = torch.einsum("ecd,edf->ecf", recv, p["w_gate"].to(dt))
    hu = torch.einsum("ecd,edf->ecf", recv, p["w_up"].to(dt))
    h = F.silu(hg.float()).to(dt) * hu
    outb = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(dt))

    # ---- reverse exchange: (E, Cl, D) back at the token owner -------------
    send = outb.reshape(E_l, tp, Cl, D).permute(1, 0, 2, 3)
    back = _Exchange.apply(send.contiguous(), group, "ep_combine")
    back = back.reshape(E * Cl, D)

    # ---- combine ---------------------------------------------------------
    gathered = back.index_select(0, torch.where(keep, slot,
                                                torch.zeros_like(slot)))
    gathered = torch.where(keep[:, None], gathered.float(),
                           torch.zeros((), device=x.device))
    contrib = (gathered * gate_w.reshape(Tl * k, 1).float()).reshape(Tl, k, D)
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    out = _TokenGather.apply(out.to(dt), group, tp, m)

    # ---- the means over every token shard ---------------------------------
    groups = [group] + ([mesh.data_group] if mesh.n_data > 1 else [])
    n = tp * mesh.n_data
    aux = _TokenMean.apply(aux, groups, n, tp)
    drop = _all_reduce(1.0 - torch.mean(keep.float()), groups,
                       "ep_stats") / n
    return out.reshape(B, S, D), {"moe_aux": aux, "moe_drop_frac": drop}
