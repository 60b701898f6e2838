"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch, the
mesh-free `moe_mlp` of the reference's `models/moe.py` (one dispatch
group; the expert-parallel form waits for the mesh backends).

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


def moe_mlp(cfg, p, x):
    """x: (B, S, D) -> ((B, S, D), {"moe_aux", "moe_drop_frac"})."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    dt = x.dtype
    xt = x.reshape(T, D)

    # ---- route -----------------------------------------------------------
    logits = torch.einsum("td,de->te", xt, p["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    gate_w, gate_idx = torch.topk(probs, k, dim=-1)             # (T, k)
    gate_w = gate_w / torch.sum(gate_w, dim=-1, keepdim=True)

    # load-balance aux loss (Switch-style)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.sum(F.one_hot(gate_idx, E).float(), dim=1), dim=0)
    aux_loss = E * torch.sum(me * ce)

    # ---- dispatch --------------------------------------------------------
    Cg = capacity(cfg, T)
    flat_e = gate_idx.reshape(T * k)                            # t * k + j
    onehot = F.one_hot(flat_e, E)
    pos_in_e = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.gather(pos_in_e, 1, flat_e[:, None])[:, 0]
    keep = pos < Cg
    src = torch.repeat_interleave(xt, k, dim=0) if k > 1 else xt
    # kept pairs at their unique slot e * Cg + pos, dropped pairs into the
    # spare row E * Cg, which is cut off
    slot = torch.where(keep, flat_e * Cg + pos,
                       torch.full_like(pos, E * Cg))
    buf = torch.zeros((E * Cg + 1, D), dtype=dt, device=x.device)
    buf.index_put_((slot,), src.to(dt))
    buf = buf[:E * Cg].reshape(E, Cg, D)

    # ---- expert compute --------------------------------------------------
    h_g = torch.einsum("ecd,edf->ecf", buf, p["w_gate"].to(dt))
    h_u = torch.einsum("ecd,edf->ecf", buf, p["w_up"].to(dt))
    h = F.silu(h_g.float()).to(dt) * h_u
    out_buf = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(dt))

    # ---- combine ---------------------------------------------------------
    gathered = out_buf.reshape(E * Cg, D).index_select(
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
