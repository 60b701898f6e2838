"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch, the
mesh-free `moe_mlp` of the reference's `models/moe.py` (the expert-parallel
form, `moe_mlp_ep`, is not ported: ROADMAP Queue 1 item 3).

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
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _pdt, normal_init

CAPACITY_FACTOR = 1.25   # the reference's moe_mlp default


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


def moe_mlp(cfg, p, x, groups: int = 1):
    """x: (B, S, D) -> ((B, S, D), {"moe_aux", "moe_drop_frac"}). The B rows
    form `groups` dispatch groups G of B / G rows each, routed
    independently: the kept pairs of group g at their unique slot
    e * G * Cg + g * Cg + pos, so the experts see (E, G * Cg, D), each
    group's positions a run of Cg rows. The aux loss and drop fraction are
    means over the groups."""
    B, S, D = x.shape
    G = groups
    if G < 1 or B % G:
        raise ValueError(f"{B} rows do not split into {G} dispatch groups")
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    Tg = T // G
    dt = x.dtype
    xt = x.reshape(T, D)

    # ---- route -----------------------------------------------------------
    logits = torch.einsum("td,de->te", xt, p["router"].to(dt)).float()
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
