"""xLSTM blocks [arXiv:2405.04517], the port of the reference's
`models/xlstm.py`: mLSTM (matrix memory, parallelizable) and sLSTM (scalar
memory, sequential), attention-free with an O(1) decode state.

mLSTM prefill uses the exact *chunkwise* form: intra-chunk quadratic
compute plus an inter-chunk recurrent (C, n, m) state, stabilized in log
space.

    true state:  C_t = f_t C_{t-1} + i_t k_t v_t^T ;  n_t = f_t n_{t-1} + i_t k_t
    stabilized:  C = Cbar * exp(m); per chunk, with lf = logsigmoid(f_raw),
                 cum_j = inclusive-cumsum(lf), M = max(m_prev, max_j(i_j - cum_j)):
                 w_j   = exp(i_j - cum_j - M)                (intra weights)
                 Cbar' = exp(m_prev - M) Cbar + sum_j w_j k_j v_j^T
                 m'    = cum_C + M
                 h_t   = num_t / max(|q_t . n_t|, exp(-m_loc_t)), m_loc_t = cum_t + M

The reference scans the chunks and the sLSTM tokens with `lax.scan`; here
a Python loop walks them, so an sLSTM prefill of S tokens is S small steps
(the RG-LRU prefill is a log-depth scan instead; the sLSTM's recurrent
products do not associate).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as nn
from repro_torch.models.layers import _pdt, normal_init
from repro_torch.models.recurrent import _causal_conv

NEG = -1e30       # the empty state's stabilizer m


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_mlstm_block(gen, cfg, layers: Optional[int], device):
    D, H, hd, W = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.conv_width
    if H * hd != D:
        raise ValueError(f"mLSTM inner dim must equal d_model: {H} x {hd} "
                         f"!= {D}")
    L = (layers,) if layers else ()
    pdt = _pdt(cfg)
    s = 1.0 / math.sqrt(D)

    def mk(shape, scale):
        return normal_init(gen, L + shape, pdt, scale, device)

    def full(shape, value):
        return torch.full(L + shape, value, dtype=pdt, device=device)

    return {
        "w_up": mk((D, 2 * D), s),
        "conv_w": mk((W, D), 1.0 / math.sqrt(W)),
        "conv_b": full((D,), 0.0),
        "wq": mk((D, H, hd), s),
        "wk": mk((D, H, hd), s),
        "wv": mk((D, H, hd), s),
        "wi": mk((D, H), s),
        "bi": full((H,), 0.0),
        "wf": mk((D, H), s),
        "bf": full((H,), 3.0),        # forget-gate bias init: remember
        "gn": full((D,), 0.0),
        "w_down": mk((D, D), s),
    }


def init_slstm_block(gen, cfg, layers: Optional[int], device):
    D, H, hd, W = cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.conv_width
    L = (layers,) if layers else ()
    pdt = _pdt(cfg)
    s = 1.0 / math.sqrt(D)
    sr = 1.0 / math.sqrt(hd)
    Fp = int(cfg.proj_factor * D)

    def mk(shape, scale):
        return normal_init(gen, L + shape, pdt, scale, device)

    def full(shape, value):
        return torch.full(L + shape, value, dtype=pdt, device=device)

    return {
        "conv_w": mk((W, D), 1.0 / math.sqrt(W)),
        "conv_b": full((D,), 0.0),
        "wz": mk((D, D), s),
        "wi": mk((D, D), s),
        "wf": mk((D, D), s),
        "wo": mk((D, D), s),
        "rz": mk((H, hd, hd), sr),
        "ri": mk((H, hd, hd), sr),
        "rf": mk((H, hd, hd), sr),
        "ro": mk((H, hd, hd), sr),
        "bz": full((D,), 0.0),
        "bi": full((D,), 0.0),
        "bf": full((D,), 3.0),
        "bo": full((D,), 0.0),
        "gn": full((D,), 0.0),
        # gated FFN
        "w_gate": mk((D, Fp), s),
        "w_upf": mk((D, Fp), s),
        "w_downf": mk((Fp, D), 1.0 / math.sqrt(Fp)),
    }


# ---------------------------------------------------------------------------
# mLSTM cell: chunkwise (prefill) and one token (decode)
# ---------------------------------------------------------------------------

def mlstm_chunk_body(carry, xs):
    """One chunk of the chunkwise mLSTM. carry = (Cbar, nbar, m); xs = (q,
    k, v, i_raw, f_raw) with q/k/v (B,H,c,hd) and gates (B,H,c) f32.
    Returns (new carry, h (B,H,c,hd) f32)."""
    Cbar, nbar, m = carry
    qq, kk, vv, ii, ff = xs
    chunk = qq.shape[-2]
    lf = F.logsigmoid(ff)                                   # (B,H,c)
    cum = torch.cumsum(lf, dim=-1)                          # inclusive
    total = cum[..., -1]                                    # (B,H)
    M = torch.maximum(m, torch.amax(ii - cum, dim=-1))      # (B,H)
    w = torch.exp(ii - cum - M[..., None])                  # (B,H,c)
    m_loc = cum + M[..., None]                              # (B,H,c)

    qf, kf, vf = qq.float(), kk.float(), vv.float()

    # intra-chunk: the weight of pair (t, j), j <= t, after the exp(-m_loc_t)
    # scaling is exp(i_j - cum_j - M) = w_j (independent of t)
    s_tj = torch.einsum("bhtd,bhjd->bhtj", qf, kf) * w[..., None, :]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=qq.device))
    s_tj = torch.where(tri, s_tj, torch.zeros_like(s_tj))
    num_intra = torch.einsum("bhtj,bhjd->bhtd", s_tj, vf)

    # inter-chunk: the carried state, scaled by exp(m_prev - M)
    inter_scale = torch.exp(m - M)[..., None, None]         # (B,H,1,1)
    num_inter = torch.einsum("bhtd,bhde->bhte", qf, Cbar) * inter_scale
    qn_inter = torch.einsum("bhtd,bhd->bht", qf, nbar)[..., None] * inter_scale

    num = num_intra + num_inter                             # (B,H,c,hd)
    # denominator: q.n_t = sum_{j<=t} (q.k_j) w_j + e^{m-M} q.nbar
    qn = torch.sum(s_tj, dim=-1)[..., None] + qn_inter      # (B,H,c,1)
    den = torch.maximum(torch.abs(qn), torch.exp(-m_loc)[..., None])
    h = num / den

    # state update, with m_new = total + M: the carry scales by exp(m - M),
    # token j by w_j
    m_new = total + M
    carry_scale = torch.exp(m - M)
    Cbar_new = (carry_scale[..., None, None] * Cbar
                + torch.einsum("bhj,bhjd,bhje->bhde", w, kf, vf))
    nbar_new = (carry_scale[..., None] * nbar
                + torch.einsum("bhj,bhjd->bhd", w, kf))
    return (Cbar_new, nbar_new, m_new), h


def _empty_mlstm_cell(B: int, H: int, hd: int, device):
    return (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=device),
            torch.zeros((B, H, hd), dtype=torch.float32, device=device),
            torch.full((B, H), NEG, dtype=torch.float32, device=device))


def mlstm_chunkwise(q, k, v, i_raw, f_raw, chunk: int,
                    state: Optional[Tuple] = None):
    """Exact chunkwise mLSTM. q, k, v: (B,H,S,hd); gates (B,H,S) f32.
    S must be a multiple of `chunk`, as in the reference. Returns (h
    (B,H,S,hd) f32, (Cbar, nbar, m) final state)."""
    B, H, S, hd = q.shape
    if S % chunk:
        raise ValueError(f"mLSTM prefill needs S % chunk == 0 (S={S}, "
                         f"chunk={chunk})")
    carry = state if state is not None else _empty_mlstm_cell(B, H, hd,
                                                              q.device)
    hs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        carry, h = mlstm_chunk_body(carry, (q[:, :, sl], k[:, :, sl],
                                            v[:, :, sl], i_raw[:, :, sl],
                                            f_raw[:, :, sl]))
        hs.append(h)
    return torch.cat(hs, dim=2), carry


def mlstm_step(q_t, k_t, v_t, i_t, f_t, state):
    """Single-token mLSTM recurrence (decode). q/k/v_t: (B,H,hd); i/f_t:
    (B,H) f32; state = (Cbar, nbar, m). Returns (h (B,H,hd) in q's dtype,
    new state)."""
    Cbar, nbar, m = state
    qf, kf, vf = q_t.float(), k_t.float(), v_t.float()
    lf = F.logsigmoid(f_t)
    m_new = torch.maximum(lf + m, i_t)
    fg = torch.exp(lf + m - m_new)                          # (B,H)
    ig = torch.exp(i_t - m_new)
    Cbar = fg[..., None, None] * Cbar + ig[..., None, None] * (
        kf[..., :, None] * vf[..., None, :])
    nbar = fg[..., None] * nbar + ig[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, Cbar)
    qn = torch.einsum("bhd,bhd->bh", qf, nbar)
    den = torch.maximum(torch.abs(qn), torch.exp(-m_new))[..., None]
    return (num / den).to(q_t.dtype), (Cbar, nbar, m_new)


def ref_mlstm_sequential(q, k, v, i_raw, f_raw, state=None):
    """Token-by-token oracle for tests. q, k, v: (B,H,S,hd) -> (h
    (B,H,S,hd), final state)."""
    B, H, S, hd = q.shape
    st = state if state is not None else _empty_mlstm_cell(B, H, hd,
                                                           q.device)
    hs = []
    for t in range(S):
        h, st = mlstm_step(q[:, :, t], k[:, :, t], v[:, :, t],
                           i_raw[:, :, t], f_raw[:, :, t], st)
        hs.append(h)
    return torch.stack(hs, dim=2), st


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _head_groupnorm(h, scale, eps: float = 1e-6):
    """Per-head RMS norm. h: (B,S,H,hd); scale: (H*hd,). Its eps is fixed,
    as in the reference (not cfg.norm_eps)."""
    B, S, H, hd = h.shape
    hf = h.float()
    var = nn.feature_mean(hf * hf)
    y = hf * torch.rsqrt(var + eps)
    y = y.reshape(B, S, H * hd) * (1.0 + scale.float())
    return y.to(h.dtype)


def _gate_product(x, w):
    """An input or forget gate's pre-activations, one per head: (B, S, D)
    by (D, H) -> (B, H, S). A stacked decode runs it once per row block
    (`layers.row_blocks`): at N = H columns the card's GEMM rounds a row
    differently at 2B rows than at B
    (`scripts/stacked_decode_bisect.py`)."""
    return nn.blockwise(lambda t: nn.wein("bsd,dh->bhs", t, w), x)


def mlstm_block(cfg, p, x, *, state=None, decode: bool = False):
    """x: (B,S,D) -> (y, new_state); state = (conv_state, (Cbar, nbar,
    m)). Decode takes S = 1 and a state; prefill needs S % chunk == 0 with
    chunk = min(cfg.mlstm_chunk, S)."""
    dt = x.dtype
    B, S, D = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    up = nn.wein("bsd,de->bse", x, p["w_up"].to(dt))
    u, g = up[..., :D], up[..., D:]

    conv_state = state[0] if state is not None else None
    uc, conv_state_new = _causal_conv(u, p["conv_w"], p["conv_b"], conv_state)
    uc = F.silu(uc.float()).to(dt)
    q = nn.wein("bsd,dhk->bhsk", uc, p["wq"].to(dt))
    k = nn.wein("bsd,dhk->bhsk", uc, p["wk"].to(dt)) / math.sqrt(hd)
    v = nn.wein("bsd,dhk->bhsk", u, p["wv"].to(dt))
    i_raw = (_gate_product(uc, p["wi"].to(dt))
             + p["bi"].to(dt)[:, None]).float()
    f_raw = (_gate_product(uc, p["wf"].to(dt))
             + p["bf"].to(dt)[:, None]).float()

    cell_state = state[1] if state is not None else None
    if decode:
        h_t, cell_state_new = mlstm_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                         i_raw[:, :, 0], f_raw[:, :, 0],
                                         cell_state)
        h = h_t[:, :, None, :]                      # (B,H,1,hd)
    else:
        h, cell_state_new = mlstm_chunkwise(q, k, v, i_raw, f_raw,
                                            min(cfg.mlstm_chunk, S),
                                            cell_state)
    h = h.transpose(1, 2).to(dt)        # (B,S,H,hd), back to compute dtype
    h = _head_groupnorm(h, p["gn"])
    y = h * F.silu(g.float()).to(dt)
    out = nn.wein("bsd,de->bse", y, p["w_down"].to(dt))
    return out, (conv_state_new, cell_state_new)


def init_mlstm_state(cfg, batch: int, device=None):
    conv = torch.zeros((batch, cfg.conv_width - 1, cfg.d_model),
                       dtype=torch.float32, device=device)
    return conv, _empty_mlstm_cell(batch, cfg.num_heads, cfg.head_dim,
                                   device)


def slstm_token_body(r_mats, head_shape, carry, xs):
    """One sLSTM token step. r_mats = (rz, ri, rf, ro) each (H,hd,hd) f32;
    carry = (c, n, h, m) each (B,D) f32; xs = the token's input-gate
    preactivations (z, i, f, o) each (B,D) f32."""
    rz, ri, rf, ro = r_mats
    H, hd = head_shape
    c, n, h, m = carry
    B, D = c.shape
    z_t, i_t, f_t, o_t = xs
    hh = h.reshape(B, H, hd)

    def rmul(r):
        return torch.einsum("bhk,hkq->bhq", hh, r).reshape(B, D)

    z = torch.tanh(z_t + rmul(rz))
    it = i_t + rmul(ri)
    ft = f_t + rmul(rf)
    o = torch.sigmoid(o_t + rmul(ro))
    lf = F.logsigmoid(ft)               # exp-gate via logsigmoid (stable)
    m_new = torch.maximum(lf + m, it)
    fg = torch.exp(lf + m - m_new)
    ig = torch.exp(it - m_new)
    c_new = fg * c + ig * z
    n_new = fg * n + ig
    h_new = o * (c_new / torch.clamp(n_new, min=1e-12))
    return (c_new, n_new, h_new, m_new), h_new


def _empty_slstm_cell(B: int, D: int, device):
    def full(value):
        return torch.full((B, D), value, dtype=torch.float32, device=device)

    return full(0.0), full(0.0), full(0.0), full(NEG)


def slstm_cell_scan(cfg, p, x, xc, state=None):
    """sLSTM over a sequence, one token at a time. x, xc: (B,S,D); state =
    (c, n, h, m) each (B,D) f32. Returns (h_seq (B,S,D) in x's dtype,
    state). The input-driven gate terms are bf16 products (in the compute
    dtype) cast to f32, for the whole sequence at once."""
    B, S, D = x.shape
    dt = x.dtype
    f32 = torch.float32

    def gate(inp, w, b):
        return (nn.wein("bsd,de->bse", inp, p[w].to(dt)).to(f32)
                + p[b].to(f32))

    gz, gi = gate(x, "wz", "bz"), gate(xc, "wi", "bi")
    gf, go = gate(xc, "wf", "bf"), gate(x, "wo", "bo")
    r_mats = tuple(p[k].to(f32) for k in ("rz", "ri", "rf", "ro"))
    carry = state if state is not None else _empty_slstm_cell(B, D, x.device)
    hs = []
    for t in range(S):
        carry, h = slstm_token_body(r_mats, (cfg.num_heads, cfg.head_dim),
                                    carry, (gz[:, t], gi[:, t], gf[:, t],
                                            go[:, t]))
        hs.append(h)
    return torch.stack(hs, dim=1).to(dt), carry


def slstm_block(cfg, p, x, *, state=None, decode: bool = False):
    """x: (B,S,D) -> (y, new_state); state = (conv_state, (c, n, h, m)).
    Decode is the same scan over S = 1 (`decode` is kept for the blocks'
    common signature)."""
    dt = x.dtype
    conv_state = state[0] if state is not None else None
    xc, conv_state_new = _causal_conv(x, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc.float()).to(dt)
    cell_state = state[1] if state is not None else None
    h, cell_state_new = slstm_cell_scan(cfg, p, x, xc, cell_state)
    B, S, D = h.shape
    h = _head_groupnorm(h.reshape(B, S, cfg.num_heads, cfg.head_dim), p["gn"])
    # gated FFN
    g = nn.wein("bsd,df->bsf", h, p["w_gate"].to(dt))
    u = nn.wein("bsd,df->bsf", h, p["w_upf"].to(dt))
    y = F.silu(g.float()).to(dt) * u
    out = nn.wein("bsf,fd->bsd", y, p["w_downf"].to(dt))
    return out, (conv_state_new, cell_state_new)


def init_slstm_state(cfg, batch: int, device=None):
    conv = torch.zeros((batch, cfg.conv_width - 1, cfg.d_model),
                       dtype=torch.float32, device=device)
    return conv, _empty_slstm_cell(batch, cfg.d_model, device)
