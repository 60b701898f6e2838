"""Layer library (the reference's `models/layers.py` without its chunked
XLA attention forms), plain functions on tensors.

Conventions, as in the reference:
  * params are nested dicts of tensors; a stacked layer dict has a leading
    ``num_layers`` axis on every leaf.
  * compute dtype = cfg.dtype (bf16 on the card); master params =
    cfg.param_dtype (f32). Each op casts the master weight it uses to the
    compute dtype, so a corrupted master bit reaches the computation.
  * attention softmax runs in f32; the flash kernel K2 is the alternative
    prefill implementation selected by cfg.attention_impl (transformer.py).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _dt(cfg) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def _pdt(cfg) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def normal_init(gen: torch.Generator, shape, dtype, scale: float, device):
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def init_attention(gen, cfg, layers: Optional[int], device):
    """GQA attention params; stacked over ``layers`` when given."""
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L = (layers,) if layers else ()
    pdt = _pdt(cfg)

    def mk(shape, fan_in):
        return normal_init(gen, L + shape, pdt, 1.0 / math.sqrt(fan_in), device)

    p = {"wq": mk((D, H, hd), D), "wk": mk((D, KV, hd), D),
         "wv": mk((D, KV, hd), D), "wo": mk((H, hd, D), H * hd)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(L + (H, hd), dtype=pdt, device=device)
        p["bk"] = torch.zeros(L + (KV, hd), dtype=pdt, device=device)
        p["bv"] = torch.zeros(L + (KV, hd), dtype=pdt, device=device)
    return p


def init_mlp(gen, cfg, layers: Optional[int], device):
    D, F_ = cfg.d_model, cfg.d_ff
    L = (layers,) if layers else ()
    pdt = _pdt(cfg)
    if cfg.mlp_act == "swiglu":
        return {
            "w_gate": normal_init(gen, L + (D, F_), pdt, 1.0 / math.sqrt(D), device),
            "w_up": normal_init(gen, L + (D, F_), pdt, 1.0 / math.sqrt(D), device),
            "w_down": normal_init(gen, L + (F_, D), pdt, 1.0 / math.sqrt(F_), device),
        }
    return {
        "w_up": normal_init(gen, L + (D, F_), pdt, 1.0 / math.sqrt(D), device),
        "b_up": torch.zeros(L + (F_,), dtype=pdt, device=device),
        "w_down": normal_init(gen, L + (F_, D), pdt, 1.0 / math.sqrt(F_), device),
        "b_down": torch.zeros(L + (D,), dtype=pdt, device=device),
    }


def init_embedding(gen, cfg, device):
    pdt = _pdt(cfg)
    p = {"tok": normal_init(gen, (cfg.vocab_size, cfg.d_model), pdt, 0.02,
                            device)}
    if not cfg.tie_embeddings:
        p["head"] = normal_init(gen, (cfg.d_model, cfg.vocab_size), pdt,
                                1.0 / math.sqrt(cfg.d_model), device)
    return p


# ---------------------------------------------------------------------------
# Norm / RoPE
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope_tables(positions, head_dim: int, theta: float):
    """positions: (...,) int -> (sin, cos) of shape (..., head_dim//2), f32."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: (B, S, H, hd); sin/cos: (S, hd//2) or (B, S, hd//2)."""
    half = x.shape[-1] // 2
    if sin.dim() == 2:
        sin = sin[None, :, None, :]
        cos = cos[None, :, None, :]
    else:
        sin = sin[:, :, None, :]
        cos = cos[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def qkv_project(cfg, p, x):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd) in compute dtype."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def out_project(cfg, p, o):
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))


def _gqa_scores(q, k, scale):
    """q: (B,S,H,hd) k: (B,T,KV,hd) -> logits (B,KV,G,S,T) in f32."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    return torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float()) * scale


def _gqa_out(w, v, out_dtype):
    """w: (B,KV,G,S,T) f32; v: (B,T,KV,hd) -> (B,S,H,hd)."""
    B, KV, G, S, T = w.shape
    o = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return o.reshape(B, S, KV * G, v.shape[-1]).to(out_dtype)


def causal_attention(q, k, v, window: int = 0, *, causal: bool = True):
    """Exact attention with f32 softmax. q:(B,S,H,hd) k,v:(B,T,KV,hd).
    `window` > 0 keeps only the keys within `window` positions of the
    query (local attention, the reference's sliding-window forms);
    `causal=False` masks nothing (the encoder and cross-attention)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = _gqa_scores(q, k, scale)
    if not causal:
        return _gqa_out(torch.softmax(logits, dim=-1), v, q.dtype)
    S, T = logits.shape[-2], logits.shape[-1]
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = qpos >= kpos
    if window:
        mask = mask & (qpos - kpos < window)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    return _gqa_out(w, v, q.dtype)


class RowPositions(NamedTuple):
    """Per-row decode positions as the masks a decode step uses, built once
    per step by `row_positions`: `hit` (B, T, 1, 1) marks each row's cache
    slot (pos[b], or pos[b] % window in a ring), `visible` (B, 1, 1, 1, T)
    the slots row b attends to."""

    hit: torch.Tensor
    visible: torch.Tensor


def row_positions(pos: torch.Tensor, T: int, window: int = 0) -> RowPositions:
    """The masks of per-row positions `pos` (B,) over T cache slots. With
    `window` the cache is a ring (`decode_attention`): row b writes slot
    pos[b] % window and sees every slot once pos[b] + 1 >= T, else the
    slots <= pos[b]. Built on the device: no index tensor, no host read."""
    t = torch.arange(T, device=pos.device)
    p = pos[:, None]
    if window:
        hit = t[None] == p % window
        visible = (t[None] <= p) | (p + 1 >= T)
    else:
        hit = t[None] == p
        visible = t[None] <= p
    return RowPositions(hit=hit[:, :, None, None],
                        visible=visible[:, None, None, None, :])


def decode_attention(q, k_cache, v_cache, pos, window: int = 0):
    """Single-token decode. q: (B,1,H,hd); caches: (B,T,KV,hd); pos: the
    current 0-based position, a host int shared by every row or the
    `RowPositions` of per-row positions (built with the same `window`).

    `window` > 0: the caches are a ring of T = min(window, max_len) slots,
    position p at slot p % window (`cache_update`, and the prefill writes
    the same slots). Slot s holds a live position once written: every slot
    when pos + 1 >= T, else slots <= pos. The ring then holds exactly the
    positions pos - window + 1 .. pos that local attention sees."""
    T = k_cache.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = _gqa_scores(q, k_cache, scale)               # (B,KV,G,1,T)
    if isinstance(pos, RowPositions):
        valid = pos.visible
    elif window:
        valid = (torch.ones((T,), dtype=torch.bool, device=q.device)
                 if pos + 1 >= T else
                 torch.arange(T, device=q.device) <= pos)
    else:
        valid = torch.arange(T, device=q.device) <= pos
    logits = torch.where(valid, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    return _gqa_out(w, v_cache, q.dtype)


def cache_update(k_cache, v_cache, k_new, v_new, pos, window: int = 0):
    """Write one token's k/v into slot ``pos`` IN PLACE and return the
    caches; `pos` is a host int (every row) or `RowPositions` (row b at
    pos[b]: one masked select per cache, written back into it; no index
    tensors, so no bounds checks or sort, and no host read). In place is
    safe under re-execution: decode writes slot `pos` before it attends to
    it and masks every later slot, so a retried step overwrites exactly
    what the failed attempt wrote.

    `window` > 0 writes ring slot ``pos % window`` (the `RowPositions`
    of a ring mark that slot already). The position it evicts, pos -
    window, is outside the window of pos and of every later position, so a
    retried step is as safe as above."""
    if isinstance(pos, RowPositions):
        torch.where(pos.hit, k_new.to(k_cache.dtype), k_cache, out=k_cache)
        torch.where(pos.hit, v_new.to(v_cache.dtype), v_cache, out=v_cache)
        return k_cache, v_cache
    if window:
        pos = pos % window
    k_cache[:, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache


# ---------------------------------------------------------------------------
# MLP / embedding / head
# ---------------------------------------------------------------------------

def mlp(cfg, p, x):
    dt = x.dtype
    if cfg.mlp_act == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(dt))
        u = torch.einsum("bsd,df->bsf", x, p["w_up"].to(dt))
        h = F.silu(g.float()).to(dt) * u
        return torch.einsum("bsf,fd->bsd", h, p["w_down"].to(dt))
    h = torch.einsum("bsd,df->bsf", x, p["w_up"].to(dt)) + p["b_up"].to(dt)
    h = F.gelu(h.float(), approximate="tanh").to(dt)
    return torch.einsum("bsf,fd->bsd", h, p["w_down"].to(dt)) + p["b_down"].to(dt)


def embed_tokens(cfg, emb_p, tokens):
    """The token rows of the embedding. `F.embedding` rather than indexing:
    the same rows, and a backward that is deterministic on the CPU with
    several threads too (indexing's accumulate is not there), so two
    replicas' gradients agree bit for bit on either device."""
    return F.embedding(tokens, emb_p["tok"]).to(_dt(cfg))


def logits_from_hidden(cfg, emb_p, h):
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", h, emb_p["tok"].to(h.dtype))
    return torch.einsum("bsd,dv->bsv", h, emb_p["head"].to(h.dtype))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy_loss(logits, targets, *, z_loss: float = 1e-4):
    """Token-mean cross-entropy with the z-loss, in f32. The gold logits are
    a `gather` (its backward is a deterministic scatter-add on the card
    under deterministic algorithms)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.to(torch.int64)[..., None])[..., 0]
    loss = torch.mean(lse - gold)
    if z_loss:
        loss = loss + z_loss * torch.mean(lse * lse)
    return loss


CE_CHUNK = 512      # seq chunk of the streamed head + CE path


def ce_chunk_body(carry, xs, w_or_emb, tied: bool):
    """One seq chunk of the streamed cross-entropy: the head projection AND
    the CE of the chunk, so the full (B, S, V) logits never exist.
    carry=(nll_sum, z_sum); xs=(h_chunk (B,c,D), tgt_chunk (B,c),
    valid (B,c))."""
    nll_sum, z_sum = carry
    h, tgt, valid = xs
    if tied:
        logits = torch.einsum("bcd,vd->bcv", h, w_or_emb.to(h.dtype))
    else:
        logits = torch.einsum("bcd,dv->bcv", h, w_or_emb.to(h.dtype))
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, tgt.to(torch.int64)[..., None])[..., 0]
    m = valid.to(torch.float32)
    return (nll_sum + torch.sum((lse - gold) * m),
            z_sum + torch.sum(lse * lse * m)), None


def chunked_cross_entropy(cfg, emb_p, h, targets, *, chunk: int = CE_CHUNK,
                          z_loss: float = 1e-4):
    """Streamed head + CE over seq chunks. h: (B,S,D); targets: (B,S). Each
    chunk's logits are recomputed in the backward (activation
    checkpointing), never kept, as the reference's `jax.checkpoint` with
    nothing saveable does."""
    from torch.utils.checkpoint import checkpoint

    B, S, D = h.shape
    c = min(chunk, S)
    pS = (-S) % c
    if pS:
        h = F.pad(h, (0, 0, 0, pS))
        targets = F.pad(targets, (0, pS))
    n = h.shape[1] // c
    valid = (torch.arange(h.shape[1], device=h.device) < S).reshape(n, c)
    w = emb_p["tok"] if cfg.tie_embeddings else emb_p["head"]

    def body(nll_sum, z_sum, hc, tc, vc):
        return ce_chunk_body((nll_sum, z_sum), (hc, tc, vc), w,
                             cfg.tie_embeddings)[0]

    carry = (torch.zeros((), dtype=torch.float32, device=h.device),
             torch.zeros((), dtype=torch.float32, device=h.device))
    for i in range(n):
        sl = slice(i * c, (i + 1) * c)
        carry = checkpoint(body, *carry, h[:, sl], targets[:, sl],
                           valid[i].expand(B, c), use_reentrant=False)
    nll_sum, z_sum = carry
    n_tok = B * S
    loss = nll_sum / n_tok
    if z_loss:
        loss = loss + z_loss * (z_sum / n_tok)
    return loss
