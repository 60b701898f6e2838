"""Layer library (the reference's `models/layers.py`), plain functions on
tensors, with its chunked causal and windowed attention forms
(`chunked_causal_attention`, `chunked_window_attention`) as one
`torch.autograd.Function` that recomputes each tile in the backward.

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

import contextlib
import math
import threading
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import remat

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _dt(cfg) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def _pdt(cfg) -> torch.dtype:
    return torch_dtype(cfg.param_dtype)


# ---------------------------------------------------------------------------
# Row blocks: the fused backend's stacked decode
# ---------------------------------------------------------------------------

_ROWS = threading.local()


@contextlib.contextmanager
def row_blocks(n: int):
    """Inside, the rows of a decode step are `n` equal blocks, each an
    independent batch (the fused backend's replicas), and the ops whose
    result for a row depends on how many rows run beside it run once per
    block (`blockwise`): on the card a mean over the features splits its
    sum by the number of rows (`feature_mean`), and xlstm's per-head gate
    product rounds by its M (`xlstm._gate_product`);
    `scripts/stacked_decode_bisect.py` finds each such op. Every other op,
    the weight products of every other family among them, runs on the
    stacked rows: attention runs per block by its own `row_blocks`
    argument."""
    prev = getattr(_ROWS, "n", 1)
    _ROWS.n = n
    try:
        yield
    finally:
        _ROWS.n = prev


def blockwise(fn, *xs, dim: int = 0):
    """fn(*xs) with each of xs split along `dim` into the current row
    blocks (`row_blocks`), one call per block, the outputs joined along
    `dim`. Outside `row_blocks`, fn(*xs)."""
    n = getattr(_ROWS, "n", 1)
    if n == 1:
        return fn(*xs)
    size = xs[0].shape[dim] // n
    return torch.cat([fn(*(x.narrow(dim, r * size, size) for x in xs))
                      for r in range(n)], dim=dim)


def feature_mean(x):
    """x's mean over its last axis (keepdim), per row block."""
    return blockwise(lambda t: torch.mean(t, dim=-1, keepdim=True), x)


def wein(equation: str, x, w):
    """A weight product, torch.einsum(equation, x, w): activations times a
    weight, no batch dims. Remat's `minimal` keeps these
    (`remat.taped`)."""
    return remat.taped(equation, x, w)


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
    var = feature_mean(xf * xf)
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

def _rounded(t, dtype):
    return t if dtype is None else t.to(dtype)


def mm32(a, b, dtype):
    """a @ b of 2-D carriers of `dtype`'s values, accumulated in f32 and
    not rounded: on the card `torch.mm` of dtype's operands into an f32
    output (the tensor cores' accumulator, which dtype's own product
    rounds once), elsewhere the f32 product."""
    if a.is_cuda and dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a.to(dtype), b.to(dtype), out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _Product32(torch.autograd.Function):
    """x times w over x's trailing and w's leading `nc` dims, the forward
    and both grads by `mm32`: a 16-bit compute dtype's products with the
    f32 accumulators kept for the sums over ranks."""

    @staticmethod
    def forward(ctx, x, w, nc: int, dtype):
        ctx.save_for_backward(x.to(dtype), w.to(dtype))
        ctx.nc, ctx.dtype, ctx.dtypes = nc, dtype, (x.dtype, w.dtype)
        K = math.prod(w.shape[:nc])
        out = mm32(x.reshape(-1, K), w.reshape(K, -1), dtype)
        return out.reshape(x.shape[:x.dim() - nc] + w.shape[nc:])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        K = math.prod(w.shape[:ctx.nc])
        g2, w2 = g.reshape(-1, w.numel() // K), w.reshape(K, -1)
        dx = mm32(g2, w2.t(), ctx.dtype).reshape(x.shape)
        dw = mm32(x.reshape(-1, K).t(), g2, ctx.dtype).reshape(w.shape)
        return dx.to(ctx.dtypes[0]), dw.to(ctx.dtypes[1]), None, None


def _product(equation: str, x, w, out_dtype):
    """`wein`, or on carriers of a 16-bit `out_dtype` `_Product32` (the
    equation's contraction: x's trailing dims with w's leading ones)."""
    if out_dtype is None or out_dtype == torch.float32:
        return wein(equation, x, w)
    nc = (x.dim() + w.dim() - len(equation.split("->")[1])) // 2
    return _Product32.apply(x, w, nc, out_dtype)


def bias_add(y, b, out_dtype=None):
    """y + b in y's dtype; with `out_dtype` (y and b carriers, below) the
    sum taken in b's dtype and rounded to out_dtype: the same value, and
    b's grad summed over the tokens in b's dtype."""
    if out_dtype is None:
        return y + b.to(y.dtype)
    return (y.to(b.dtype) + b).to(out_dtype)


def qkv_project(cfg, p, x, out_dtype=None):
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd) in compute dtype.

    `out_dtype` (a sharded rank's compute dtype): x and the weights are
    f32 carriers of that dtype's values, each product is taken in f32 and
    rounded to out_dtype after it, each bias added as `bias_add` adds it:
    the values that out_dtype's own products and sums give, with grads
    that stay f32 until the sums over ranks."""
    dt, rd = x.dtype, out_dtype
    q = _rounded(_product("bsd,dhk->bshk", x, p["wq"].to(dt), rd), rd)
    k = _rounded(_product("bsd,dhk->bshk", x, p["wk"].to(dt), rd), rd)
    v = _rounded(_product("bsd,dhk->bshk", x, p["wv"].to(dt), rd), rd)
    if "bq" in p:
        q = bias_add(q, p["bq"], out_dtype)
        k = bias_add(k, p["bk"], out_dtype)
        v = bias_add(v, p["bv"], out_dtype)
    return q, k, v


def out_project(cfg, p, o, dtype=None):
    """The out product, taken in `dtype` (default o's): a sharded rank's
    f32 partial sum of o's products (`_product`), rounded after the sum
    over ranks."""
    if dtype is None:
        return wein("bshk,hkd->bsd", o, p["wo"].to(o.dtype))
    return _product("bshk,hkd->bsd", o.to(dtype), p["wo"].to(dtype),
                    o.dtype)


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


_CHUNK_Q = 512           # the reference's q chunk of the chunked forms
_CHUNK_K = 1024
CHUNKED_THRESHOLD = 2048  # chunked causal attention when S exceeds this
_PAD_POS = 2 ** 30        # a padded key's position: after every query
_NEG = -1e30              # the reference's mask value


def _key_ranges(i: int, qc: int, kc: int, S: int, Sk: int, window: int):
    """The key ranges [k0, k1) q chunk i visits, in order. Windowed: the
    one live slice [i qc - window, i qc + qc) cut to [0, S), so the
    softmax runs over the keys a query can see and no left padding.
    Causal: the padded keys' blocks of kc, skipping those wholly above
    the diagonal (a masked block adds p = 0 with a correction of 1: the
    value is the same as the reference's scan over every block)."""
    if window:
        return [(max(0, i * qc - window), min(S, i * qc + qc))]
    last_q = i * qc + qc - 1
    return [(j * kc, (j + 1) * kc) for j in range(Sk // kc)
            if j * kc <= last_q]


def _tile_scores(qb, kb, qpos, kpos, window: int, scale: float):
    """Masked f32 scores of one tile: qb (B,KV,G,qc,hd), kb (B,KV,c,hd)."""
    s = torch.einsum("bkgqd,bkcd->bkgqc", qb, kb) * scale
    mask = qpos[:, None] >= kpos[None, :]
    if window:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    return torch.where(mask, s, torch.full_like(s, _NEG))


class _ChunkedAttention(torch.autograd.Function):
    """Flash attention in plain PyTorch over (q chunk, key range) tiles
    with the reference's online-softmax carry in f32 (`_flash_kv_body`).
    The forward saves q, k, v, the f32 output and each row's log-sum-exp;
    the backward recomputes every tile's probabilities from them and sums
    dq, dk and dv in a fixed order, no atomics. So under autograd no
    (S, S) tensor lives past one tile of (qc, kc): the reference's
    `jax.checkpoint(nothing_saveable)` made explicit. `setup_context` and
    `generate_vmap_rule` let the fused trainer's `torch.vmap` run it (the
    loops depend on shapes alone).

    q (B,S,H,hd), k/v (B,S,KV,hd) -> (out (B,S,H,hd) f32, lse (B,KV,G,Sq)).
    q is padded to a multiple of qc and, causal, k/v to one of kc, a
    padded key at position 2**30, after every query, as the reference
    pads."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, window: int, qc: int, kc: int):
        B, S, H, hd = q.shape
        KV = k.shape[2]
        G = H // KV
        scale = 1.0 / math.sqrt(hd)
        qt, kt, vt, kpos, Sq, Sk = _chunk_layout(q, k, v, window, qc, kc)
        outs, lses = [], []
        for i in range(Sq // qc):
            qb = qt[:, :, :, i * qc:(i + 1) * qc].float()
            qpos = torch.arange(i * qc, (i + 1) * qc, device=q.device)
            m = l = acc = None
            for k0, k1 in _key_ranges(i, qc, kc, S, Sk, window):
                s = _tile_scores(qb, kt[:, :, k0:k1].float(), qpos,
                                 kpos[k0:k1], window, scale)
                vb = vt[:, :, k0:k1].float()
                if m is None:
                    m = s.amax(dim=-1)
                    p = torch.exp(s - m[..., None])
                    l = p.sum(dim=-1)
                    acc = torch.einsum("bkgqc,bkcd->bkgqd", p, vb)
                    continue
                m_new = torch.maximum(m, s.amax(dim=-1))
                p = torch.exp(s - m_new[..., None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "bkgqc,bkcd->bkgqd", p, vb)
                m = m_new
            outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
            lses.append(m + torch.log(l))
        out = torch.cat(outs, dim=3)[:, :, :, :S]          # (B,KV,G,S,hd)
        out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
        return out, torch.cat(lses, dim=3)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, window, qc, kc = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (window, qc, kc)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        window, qc, kc = ctx.cfg
        B, S, H, hd = q.shape
        KV = k.shape[2]
        G = H // KV
        scale = 1.0 / math.sqrt(hd)
        qt, kt, vt, kpos, Sq, Sk = _chunk_layout(q, k, v, window, qc, kc)
        pS = Sq - S
        # (B,S,H,hd) -> (B,KV,G,Sq,hd), padded rows zero
        dot = F.pad(dout.float().reshape(B, S, KV, G, hd)
                    .permute(0, 2, 3, 1, 4), (0, 0, 0, pS))
        ot = F.pad(out.reshape(B, S, KV, G, hd).permute(0, 2, 3, 1, 4),
                   (0, 0, 0, pS))
        delta = (dot * ot).sum(dim=-1)                     # (B,KV,G,Sq)
        dqs = []
        dk = dv = None
        for i in range(Sq // qc):
            sl = slice(i * qc, (i + 1) * qc)
            qb, do_i = qt[:, :, :, sl].float(), dot[:, :, :, sl]
            qpos = torch.arange(i * qc, (i + 1) * qc, device=q.device)
            dq_i = None
            for k0, k1 in _key_ranges(i, qc, kc, S, Sk, window):
                kb, vb = kt[:, :, k0:k1].float(), vt[:, :, k0:k1].float()
                s = _tile_scores(qb, kb, qpos, kpos[k0:k1], window, scale)
                p = torch.exp(s - lse[:, :, :, sl, None])
                dp = torch.einsum("bkgqd,bkcd->bkgqc", do_i, vb)
                ds = p * (dp - delta[:, :, :, sl, None])
                dq_t = torch.einsum("bkgqc,bkcd->bkgqd", ds, kb) * scale
                dq_i = dq_t if dq_i is None else dq_i + dq_t
                pad = (0, 0, k0, Sk - k1)
                dk_t = F.pad(torch.einsum("bkgqc,bkgqd->bkcd", ds, qb)
                             * scale, pad)
                dv_t = F.pad(torch.einsum("bkgqc,bkgqd->bkcd", p, do_i),
                             pad)
                dk = dk_t if dk is None else dk + dk_t
                dv = dv_t if dv is None else dv + dv_t
            dqs.append(dq_i)
        dq = torch.cat(dqs, dim=3)[:, :, :, :S]
        dq = dq.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)
        dk = dk[:, :, :S].permute(0, 2, 1, 3).to(k.dtype)
        dv = dv[:, :, :S].permute(0, 2, 1, 3).to(v.dtype)
        return dq, dk, dv, None, None, None


def _chunk_layout(q, k, v, window: int, qc: int, kc: int):
    """Head-major padded operands of `_ChunkedAttention`: qt (B,KV,G,Sq,hd),
    kt/vt (B,KV,Sk,hd) in their own dtype, the keys' positions (Sk,),
    padded keys at 2**30; Sq, Sk."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    pS = (-S) % qc
    pK = 0 if window else (-S) % kc
    qt = F.pad(q.reshape(B, S, KV, H // KV, hd).permute(0, 2, 3, 1, 4),
               (0, 0, 0, pS))
    kt = F.pad(k.permute(0, 2, 1, 3), (0, 0, 0, pK))
    vt = F.pad(v.permute(0, 2, 1, 3), (0, 0, 0, pK))
    Sk = S + pK
    kpos = torch.arange(Sk, device=q.device)
    kpos = torch.where(kpos < S, kpos, torch.full_like(kpos, _PAD_POS))
    return qt, kt, vt, kpos, S + pS, Sk


def chunked_causal_attention(q, k, v, *, q_chunk: int = _CHUNK_Q,
                             k_chunk: int = _CHUNK_K):
    """Causal flash attention over q chunks of `q_chunk` and key blocks of
    `k_chunk` (the reference's, in XLA scans): memory O(q_chunk * k_chunk)
    per tile instead of O(S^2), forward and backward. q: (B,S,H,hd);
    k/v: (B,S,KV,hd) -> (B,S,H,hd) in q's dtype."""
    S = q.shape[1]
    out, _ = _ChunkedAttention.apply(q, k, v, 0, min(q_chunk, S),
                                     min(k_chunk, S))
    return out.to(q.dtype)


def chunked_window_attention(q, k, v, window: int, *,
                             q_chunk: int = _CHUNK_Q):
    """Exact sliding-window attention, linear in S: each q chunk attends to
    its live key slice [chunk_start - window, chunk_end) (the reference's,
    whose slice runs over keys left-padded by `window`)."""
    S = q.shape[1]
    qc = min(q_chunk, S)
    out, _ = _ChunkedAttention.apply(q, k, v, window, qc, qc)
    return out.to(q.dtype)


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


def decode_attention(q, k_cache, v_cache, pos, window: int = 0, *,
                     axis=None, head_dim: Optional[int] = None):
    """Single-token decode. q: (B,1,H,hd); caches: (B,T,KV,hd); pos: the
    current 0-based position, a host int shared by every row or the
    `RowPositions` of per-row positions (built with the same `window`).

    `window` > 0: the caches are a ring of T = min(window, max_len) slots,
    position p at slot p % window (`cache_update`, and the prefill writes
    the same slots). Slot s holds a live position once written: every slot
    when pos + 1 >= T, else slots <= pos. The ring then holds exactly the
    positions pos - window + 1 .. pos that local attention sees.

    `axis` (a `sharding.Axis`, the model ranks): q and the caches hold this
    rank's block of the head dim, whose whole is `head_dim`. Each rank's
    partial scores (B,KV,G,1,T) are summed over the axis in f32, in rank
    order (label `tp_scores`), then scaled by 1/sqrt(head_dim), the whole
    head's, masked and softmaxed; the output is the rank's block of the
    head dim (PV on its block of v)."""
    T = k_cache.shape[1]
    if axis is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
        logits = _gqa_scores(q, k_cache, scale)           # (B,KV,G,1,T)
    else:
        from repro_torch.sharding import all_sum
        logits = all_sum(_gqa_scores(q, k_cache, 1.0), axis, "tp_scores") \
            * (1.0 / math.sqrt(head_dim))
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

def mlp(cfg, p, x, down_bias: bool = True, out_dtype=None):
    """The MLP; `down_bias=False` leaves the GELU form's b_down out and
    returns the down product unrounded (a row-parallel down product: the
    sum over ranks, then the bias once). `out_dtype` as `qkv_project`'s:
    x and the weights f32 carriers, every product but the down product
    rounded to out_dtype after it."""
    dt, rd = x.dtype, out_dtype
    if cfg.mlp_act == "swiglu":
        g = _rounded(_product("bsd,df->bsf", x, p["w_gate"].to(dt), rd), rd)
        u = _rounded(_product("bsd,df->bsf", x, p["w_up"].to(dt), rd), rd)
        h = F.silu(g.float()).to(g.dtype) * u
    else:
        h = bias_add(_rounded(_product("bsd,df->bsf", x, p["w_up"].to(dt),
                                       rd), rd), p["b_up"], rd)
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    out = _product("bsf,fd->bsd", h.to(dt), p["w_down"].to(dt), rd)
    if not down_bias:
        return out
    if cfg.mlp_act == "swiglu":
        return _rounded(out, out_dtype)
    return bias_add(_rounded(out, out_dtype), p["b_down"], out_dtype)


def embed_tokens(cfg, emb_p, tokens, lo=None):
    """The token rows of the embedding. `F.embedding` rather than indexing:
    the same rows, and a backward that is deterministic on the CPU with
    several threads too (indexing's accumulate is not there), so two
    replicas' gradients agree bit for bit on either device. `lo`:
    emb_p["tok"] holds the vocab rows from lo on (a rank's block of a
    vocab-parallel embedding), and a token outside them gets zeros, so
    the sum over the ranks is the lookup."""
    if lo is None:
        return F.embedding(tokens, emb_p["tok"]).to(_dt(cfg))
    ids = tokens - lo
    inside = (ids >= 0) & (ids < emb_p["tok"].shape[0])
    x = F.embedding(torch.where(inside, ids, torch.zeros_like(ids)),
                    emb_p["tok"]).to(_dt(cfg))
    return torch.where(inside[..., None], x, torch.zeros_like(x))


def logits_from_hidden(cfg, emb_p, h):
    if cfg.tie_embeddings:
        return wein("bsd,vd->bsv", h, emb_p["tok"].to(h.dtype))
    return wein("bsd,dv->bsv", h, emb_p["head"].to(h.dtype))


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


class _StreamedCE(torch.autograd.Function):
    """The streamed head + CE over seq chunks of `chunk`: (nll_sum, z_sum)
    of h (B, Sp, D) against targets and the valid mask (B, Sp). The
    forward keeps no chunk's logits; the backward recomputes each chunk's
    (`ce_chunk_body`'s arithmetic) and forms its gradient from the softmax:
    d nll = p - onehot(gold), d z = 2 lse p, masked by `valid`. The
    weight's gradient is each chunk's product in the compute dtype, summed
    in f32 in chunk order, as autograd through the weight's cast sums it.
    A Function rather than `torch.utils.checkpoint`, which fails under
    `torch.vmap` (the fused trainer's forward); `generate_vmap_rule` lets
    vmap run it."""

    generate_vmap_rule = True

    @staticmethod
    def forward(h, w, targets, valid, tied: bool, chunk: int):
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        carry = (zero, zero)
        for i in range(h.shape[1] // chunk):
            sl = slice(i * chunk, (i + 1) * chunk)
            carry, _ = ce_chunk_body(carry, (h[:, sl], targets[:, sl],
                                             valid[:, sl]), w, tied)
        return carry

    @staticmethod
    def setup_context(ctx, inputs, output):
        h, w, targets, valid, tied, chunk = inputs
        ctx.save_for_backward(h, w, targets, valid)
        ctx.cfg = (tied, chunk)

    @staticmethod
    def backward(ctx, g_nll, g_z):
        h, w, targets, valid = ctx.saved_tensors
        tied, chunk = ctx.cfg
        wd = w.to(h.dtype)
        dhs, dw = [], None
        for i in range(h.shape[1] // chunk):
            sl = slice(i * chunk, (i + 1) * chunk)
            hc = h[:, sl]
            if tied:
                logits = torch.einsum("bcd,vd->bcv", hc, wd)
            else:
                logits = torch.einsum("bcd,dv->bcv", hc, wd)
            lf = logits.to(torch.float32)
            lse = torch.logsumexp(lf, dim=-1)
            p = torch.exp(lf - lse[..., None])
            gold = torch.arange(lf.shape[-1], device=h.device) \
                == targets[:, sl, None].to(torch.int64)
            m = valid[:, sl].to(torch.float32)[..., None]
            dl = (m * (g_nll * torch.where(gold, p - 1.0, p)
                       + (2.0 * g_z) * lse[..., None] * p)).to(h.dtype)
            if tied:
                dhs.append(torch.einsum("bcv,vd->bcd", dl, wd))
                dw_c = torch.einsum("bcv,bcd->vd", dl, hc)
            else:
                dhs.append(torch.einsum("bcv,dv->bcd", dl, wd))
                dw_c = torch.einsum("bcv,bcd->dv", dl, hc)
            dw_c = dw_c.to(w.dtype)
            dw = dw_c if dw is None else dw + dw_c
        return torch.cat(dhs, dim=1), dw, None, None, None, None


def chunked_cross_entropy(cfg, emb_p, h, targets, *, chunk: int = CE_CHUNK,
                          z_loss: float = 1e-4):
    """Streamed head + CE over seq chunks. h: (B,S,D); targets: (B,S). Each
    chunk's logits are recomputed in the backward (`_StreamedCE`), never
    kept, as the reference's `jax.checkpoint` with nothing saveable
    does."""
    B, S, D = h.shape
    c = min(chunk, S)
    pS = (-S) % c
    if pS:
        h = F.pad(h, (0, 0, 0, pS))
        targets = F.pad(targets, (0, pS))
    valid = (torch.arange(h.shape[1], device=h.device) < S).expand(
        B, h.shape[1])
    w = emb_p["tok"] if cfg.tie_embeddings else emb_p["head"]
    nll_sum, z_sum = _StreamedCE.apply(h, w, targets, valid,
                                       cfg.tie_embeddings, c)
    n_tok = B * S
    loss = nll_sum / n_tok
    if z_loss:
        loss = loss + z_loss * (z_sum / n_tok)
    return loss


class _VocabParallelCE(torch.autograd.Function):
    """The head + CE with the vocabulary split over a mesh axis
    (`sharding.Axis`): w holds this rank's V / n vocab rows (tied, (Vl, D))
    or columns (untied, (D, Vl)), the rank's block `index`. Per seq chunk
    each rank forms its logits (B, c, Vl) in f32; the global max over the
    vocab, then the sum of exp(logit - max) and the target's logit (each
    rank's own, zero where the target is another rank's) are summed over
    the axis (`vocab_stats`, two collectives a chunk), so every rank holds
    the same lse and gold and the same (nll_sum, z_sum). The backward is
    local: each rank's softmax slice p = exp(logit - lse) gives d logits =
    p - onehot (and 2 lse p for the z-loss), masked by `valid`; its h
    gradient is a partial sum over the ranks' slices (the collective that
    brought h to the rank sums it), its weight gradient the rank's own
    block. No rank ever holds the (B, S, V) logits. `dtype` is the
    compute dtype where h and w are f32 carriers of its values (a sharded
    rank's): the logits and their grads are rounded to it, as the
    unsharded head rounds them, and the h and w grads stay f32 for their
    sums over ranks."""

    @staticmethod
    def forward(ctx, h, w, targets, valid, tied: bool, chunk: int, axis,
                dtype):
        from repro_torch.sharding import all_max, all_sum
        Vl = w.shape[0] if tied else w.shape[1]
        lo = axis.index * Vl
        wd = w.to(h.dtype)
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        nll_sum, z_sum, lses = zero, zero, []
        for i in range(h.shape[1] // chunk):
            sl = slice(i * chunk, (i + 1) * chunk)
            lf = _head(h[:, sl], wd, tied, dtype).to(dtype).to(torch.float32)
            mx = all_max(torch.amax(lf, dim=-1), axis, "vocab_stats")
            t = targets[:, sl].to(torch.int64) - lo
            inside = (t >= 0) & (t < Vl)
            gold = torch.gather(lf, -1, torch.where(
                inside, t, torch.zeros_like(t))[..., None])[..., 0]
            gold = torch.where(inside, gold, torch.zeros_like(gold))
            se = torch.sum(torch.exp(lf - mx[..., None]), dim=-1)
            stats = all_sum(torch.stack([se, gold]), axis, "vocab_stats")
            lse = mx + torch.log(stats[0])
            m = valid[:, sl].to(torch.float32)
            nll_sum = nll_sum + torch.sum((lse - stats[1]) * m)
            z_sum = z_sum + torch.sum(lse * lse * m)
            lses.append(lse)
        ctx.save_for_backward(h, w, targets, valid, torch.cat(lses, dim=1))
        ctx.cfg = (tied, chunk, lo, dtype)
        return nll_sum, z_sum

    @staticmethod
    def backward(ctx, g_nll, g_z):
        h, w, targets, valid, lse_all = ctx.saved_tensors
        tied, chunk, lo, dtype = ctx.cfg
        wd = w.to(h.dtype)
        dhs, dw = [], None
        for i in range(h.shape[1] // chunk):
            sl = slice(i * chunk, (i + 1) * chunk)
            hc = h[:, sl]
            lf = _head(hc, wd, tied, dtype).to(dtype).to(torch.float32)
            lse = lse_all[:, sl]
            p = torch.exp(lf - lse[..., None])
            gold = torch.arange(lf.shape[-1], device=h.device) + lo \
                == targets[:, sl, None].to(torch.int64)
            m = valid[:, sl].to(torch.float32)[..., None]
            dl = (m * (g_nll * torch.where(gold, p - 1.0, p)
                       + (2.0 * g_z) * lse[..., None] * p)).to(dtype).to(
                           h.dtype)
            dh_c, dw_c = _head_grads(dl, hc, wd, tied, dtype)
            dhs.append(dh_c)
            dw_c = dw_c.to(w.dtype)
            dw = dw_c if dw is None else dw + dw_c
        return (torch.cat(dhs, dim=1), dw) + (None,) * 6


def _head(h, wd, tied: bool, dtype=None):
    """h's logits over the head's block wd; on carriers of a 16-bit
    `dtype`, its f32 accumulator (`mm32`)."""
    if dtype is None or dtype == torch.float32:
        if tied:
            return torch.einsum("bcd,vd->bcv", h, wd)
        return torch.einsum("bcd,dv->bcv", h, wd)
    B, c, D = h.shape
    return mm32(h.reshape(-1, D), wd.t() if tied else wd, dtype).reshape(
        B, c, -1)


def _head_grads(dl, h, wd, tied: bool, dtype=None):
    """(dh, dw) of `_head` for the logits' grads dl, alike."""
    if dtype is None or dtype == torch.float32:
        if tied:
            return (torch.einsum("bcv,vd->bcd", dl, wd),
                    torch.einsum("bcv,bcd->vd", dl, h))
        return (torch.einsum("bcv,dv->bcd", dl, wd),
                torch.einsum("bcv,bcd->dv", dl, h))
    B, c, D = h.shape
    dl2, h2 = dl.reshape(B * c, -1), h.reshape(B * c, D)
    dh = mm32(dl2, wd if tied else wd.t(), dtype).reshape(B, c, D)
    dw = mm32(dl2.t(), h2, dtype) if tied else mm32(h2.t(), dl2, dtype)
    return dh, dw


def vocab_parallel_cross_entropy(cfg, w, h, targets, axis, *,
                                 chunk: int = CE_CHUNK,
                                 z_loss: float = 1e-4, dtype=None):
    """The token-mean CE + z-loss of h (B, S, D), whole on every rank of
    `axis`, against targets (B, S), with the head's vocab split over the
    axis (w: this rank's block of `tok` (Vl, D) when tied, of `head`
    (D, Vl) otherwise): `_VocabParallelCE` over seq chunks of
    min(chunk, S), the last padded and masked as `chunked_cross_entropy`
    pads it; `dtype` the compute dtype of f32 carriers h and w (default
    h's)."""
    B, S, D = h.shape
    c = min(chunk, S)
    pS = (-S) % c
    if pS:
        h = F.pad(h, (0, 0, 0, pS))
        targets = F.pad(targets, (0, pS))
    valid = (torch.arange(h.shape[1], device=h.device) < S).expand(
        B, h.shape[1])
    nll_sum, z_sum = _VocabParallelCE.apply(h, w, targets, valid,
                                            cfg.tie_embeddings, c, axis,
                                            dtype or h.dtype)
    n_tok = B * S
    loss = nll_sum / n_tok
    if z_loss:
        loss = loss + z_loss * (z_sum / n_tok)
    return loss
