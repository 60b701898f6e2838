"""Griffin-style recurrent block (RG-LRU) for recurrentgemma, the port of
the reference's `models/recurrent.py` [arXiv:2402.19427].

Block: x -> (W_gelu branch) * (conv1d -> RG-LRU branch) -> W_out.

RG-LRU (Real-Gated Linear Recurrent Unit):
    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence as a log-depth scan over the (a, b) pairs
(Hillis-Steele: ceil(log2 S) steps of whole-tensor products, 12 at
S = 4096), where the reference runs `jax.lax.associative_scan`; the two
associate the same products in another order, so they agree to f32
rounding, not bit for bit. Decode is the O(1) recurrence.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as nn
from repro_torch.models.layers import _pdt, normal_init

RG_LRU_C = 8.0


def init_recurrent_block(gen, cfg, layers: Optional[int], device):
    D, R, W = cfg.d_model, cfg.d_rnn, cfg.conv_width
    L = (layers,) if layers else ()
    pdt = _pdt(cfg)

    def mk(shape, scale):
        return normal_init(gen, L + shape, pdt, scale, device)

    def zeros(shape):
        return torch.zeros(L + shape, dtype=pdt, device=device)

    return {
        "w_gelu": mk((D, R), 1.0 / math.sqrt(D)),
        "w_in": mk((D, R), 1.0 / math.sqrt(D)),
        "w_out": mk((R, D), 1.0 / math.sqrt(R)),
        "conv_w": mk((W, R), 1.0 / math.sqrt(W)),
        "conv_b": zeros((R,)),
        "wa": mk((R, R), 1.0 / math.sqrt(R)),
        "ba": zeros((R,)),
        "wx": mk((R, R), 1.0 / math.sqrt(R)),
        "bx": zeros((R,)),
        # Lambda so that a^c lies in [0.9, 0.999] (the paper's init)
        "lam": zeros((R,)) + 0.7,
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B,S,R); w: (W,R); state: (B,W-1,R) or
    None. Returns (y, new_state); with a state the conv sees [state, x]."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                 # (B, S+W-1, R)
    S = x.shape[1]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):                              # W is tiny (4)
        y = y + xp[:, i:i + S, :].float() * w[i].float()
    y = (y + b.float()).to(x.dtype)
    new_state = xp[:, -(W - 1):, :] if W > 1 else None
    return y, new_state


def _rg_lru_gates(p, u):
    """u: (B,S,R) post-conv branch -> (a, beta_x) in f32."""
    uf = u.float()
    r = torch.sigmoid(nn.wein("bsr,rq->bsq", uf, p["wa"].float())
                      + p["ba"].float())
    i = torch.sigmoid(nn.wein("bsr,rq->bsq", uf, p["wx"].float())
                      + p["bx"].float())
    log_a = -RG_LRU_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    return a, b


def linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along dim 1,
    Hillis-Steele over the pairs: at offset d every position t >= d folds
    in the pair d steps before it, (a1, b1) then (a2, b2) -> (a1 a2,
    a2 b1 + b2). Returns h, the second member of each prefix."""
    S = a.shape[1]
    d = 1
    while d < S:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        a_cur, b_cur = a[:, d:], b[:, d:]
        b = torch.cat([b[:, :d], a_cur * b_prev + b_cur], dim=1)
        a = torch.cat([a[:, :d], a_prev * a_cur], dim=1)
        d *= 2
    return b


def rg_lru_scan(p, u, h0=None):
    """Full-sequence RG-LRU. u: (B,S,R) -> (y, h_last f32)."""
    a, b = _rg_lru_gates(p, u)
    if h0 is not None:
        # fold the carried state into the first step: b_0 += a_0 * h0
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    h = linear_scan(a, b)
    return h.to(u.dtype), h[:, -1, :]


def rg_lru_step(p, u_t, h):
    """Single decode step. u_t: (B,R); h: (B,R) f32 -> (y_t, h_new)."""
    a, b = _rg_lru_gates(p, u_t[:, None, :])
    h_new = a[:, 0, :] * h + b[:, 0, :]
    return h_new.to(u_t.dtype), h_new


def recurrent_block(cfg, p, x, *, conv_state=None, h_state=None,
                    decode: bool = False):
    """Griffin recurrent temporal-mixing block.

    Prefill: x (B,S,D) -> (y, (conv_state, h_last)).
    Decode: x (B,1,D), states given -> (y, new states). The states are new
    tensors (never written in place): a retried step starts again from
    the committed ones."""
    dt = x.dtype
    gate = F.gelu(nn.wein("bsd,dr->bsr", x, p["w_gelu"].to(dt)).float(),
                  approximate="tanh").to(dt)
    u = nn.wein("bsd,dr->bsr", x, p["w_in"].to(dt))
    u, conv_state_new = _causal_conv(u, p["conv_w"], p["conv_b"], conv_state)
    if decode:
        y_t, h_new = rg_lru_step(p, u[:, 0, :], h_state)
        y = y_t[:, None, :]
    else:
        y, h_new = rg_lru_scan(p, u, h_state)
    out = nn.wein("bsr,rd->bsd", gate * y, p["w_out"].to(dt))
    return out, (conv_state_new, h_new)


def init_recurrent_state(cfg, batch: int, device=None,
                         dtype=torch.float32):
    """Decode state for one recurrent layer: (conv_state, h)."""
    return (torch.zeros((batch, cfg.conv_width - 1, cfg.d_rnn), dtype=dtype,
                        device=device),
            torch.zeros((batch, cfg.d_rnn), dtype=torch.float32,
                        device=device))
