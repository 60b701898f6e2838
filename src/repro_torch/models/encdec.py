"""Encoder-decoder transformer (the seamless-m4t-medium backbone), the port
of the reference's `models/encdec.py`.

The speech frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, D). The encoder is bidirectional
plain attention; the decoder is causal, its self-attention through
`transformer._attention_dispatch` (the flash kernel K2 under
`attention_impl="pallas"`) and its cross-attention plain. Decode keeps a
self-attention KV cache, written in place (`layers.cache_update`), and a
cross-attention cache `xk`/`xv` written once by the prefill. Positions
count decoder tokens only: the frames are not decode positions.

Params keep the reference's tree ({"embed", "encoder", "decoder"}, each
stack's leaves stacked over its layers), so a leaf index and a fingerprint
mean the same leaf in both packages.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import tree as tree_util
from repro_torch.models import layers as nn
from repro_torch.models import transformer as tfm
from repro_torch.models.remat import remat


def init_encdec(gen: torch.Generator, cfg, device) -> Dict[str, Any]:
    """Seeded random params (f32 masters) on `device`."""
    pdt = nn.torch_dtype(cfg.param_dtype)
    D = cfg.d_model

    def zeros(*shape):
        return torch.zeros(shape, dtype=pdt, device=device)

    def stack(L: int, cross: bool):
        p = {"attn": nn.init_attention(gen, cfg, L, device),
             "mlp": nn.init_mlp(gen, cfg, L, device),
             "ln1": zeros(L, D), "ln2": zeros(L, D)}
        if cross:
            p["xattn"] = nn.init_attention(gen, cfg, L, device)
            p["lnx"] = zeros(L, D)
        return p

    return {"embed": nn.init_embedding(gen, cfg, device),
            "encoder": {"layers": stack(cfg.encoder_layers, cross=False),
                        "final_ln": zeros(D)},
            "decoder": {"layers": stack(cfg.num_layers, cross=True),
                        "final_ln": zeros(D)}}


def _rope(cfg, S: int, device):
    return nn.rope_tables(torch.arange(S, device=device), cfg.head_dim,
                          cfg.rope_theta)


def encode(cfg, params, frames):
    """frames: (B, S_enc, D) precomputed frontend embeddings -> (B, S_enc,
    D), bidirectional; each layer one remat block of `cfg.remat` under
    grad mode (`models/remat.py`), as the reference's."""
    x = frames.to(nn.torch_dtype(cfg.dtype))
    sin, cos = _rope(cfg, x.shape[1], x.device)
    layers = params["encoder"]["layers"]
    template = tfm._slice(layers, 0)
    flat = tree_util.leaves(layers)

    def body(x, *leaves):
        lp = tree_util.unflatten_like(template, leaves)
        h = nn.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = nn.qkv_project(cfg, lp["attn"], h)
        q = nn.apply_rope(q, sin, cos)
        k = nn.apply_rope(k, sin, cos)
        o = nn.causal_attention(q, k, v, causal=False)
        x = x + nn.out_project(cfg, lp["attn"], o)
        h2 = nn.rms_norm(x, lp["ln2"], cfg.norm_eps)
        return (x + nn.mlp(cfg, lp["mlp"], h2),)

    for i in range(cfg.encoder_layers):
        x, = remat(body, cfg.remat, x, *[a[i] for a in flat])
    return nn.rms_norm(x, params["encoder"]["final_ln"], cfg.norm_eps)


def _project(ap, x, which: str):
    """`layers.qkv_project`'s keys ("k") or values ("v") alone."""
    dt = x.dtype
    y = nn.wein("bsd,dhk->bshk", x, ap["w" + which].to(dt))
    if "b" + which in ap:
        y = y + ap["b" + which].to(dt)
    return y


def _decoder_layer(cfg, lp, x, enc_out, sin, cos, enc_v=None):
    """One decoder layer -> (x, k, v, kx, vx): self-attention, cross
    attention over the encoder's output, MLP. `enc_v`, where given, is the
    encoder's output for the value projection (the same tensor as a second
    input of a remat block, so that its gradient arrives apart from the
    keys', in the order it does without remat)."""
    x, k, v = tfm._attn_full(cfg, lp["ln1"], lp["attn"], x, sin, cos)
    hx = nn.rms_norm(x, lp["lnx"], cfg.norm_eps)
    qx, _, _ = nn.qkv_project(cfg, lp["xattn"], hx)
    if enc_v is None:
        _, kx, vx = nn.qkv_project(cfg, lp["xattn"], enc_out)
    else:
        kx = _project(lp["xattn"], enc_out, "k")
        vx = _project(lp["xattn"], enc_v, "v")
    ox = nn.causal_attention(qx, kx, vx, causal=False)
    x = x + nn.out_project(cfg, lp["xattn"], ox)
    h2 = nn.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + nn.mlp(cfg, lp["mlp"], h2), k, v, kx, vx


def _decoder_hidden(cfg, params, tokens, enc_out, collect_kv: bool = False):
    """The decoder over the whole token sequence -> (hidden (B, S, D),
    kv). kv, with `collect_kv`, is (k, v, xk, xv): the self-attention's
    rotated keys and values (L, B, S, KV, hd) and the cross-attention's
    (L, B, S_enc, KV, hd); else None. Without `collect_kv` each layer is
    one remat block of `cfg.remat` (the encoder's output one of its
    inputs)."""
    x = nn.embed_tokens(cfg, params["embed"], tokens)
    sin, cos = _rope(cfg, x.shape[1], x.device)
    layers = params["decoder"]["layers"]
    if collect_kv:
        kv = ([], [], [], [])
        for i in range(cfg.num_layers):
            x, *t = _decoder_layer(cfg, tfm._slice(layers, i), x, enc_out,
                                   sin, cos)
            for acc, a in zip(kv, t):
                acc.append(a)
        x = nn.rms_norm(x, params["decoder"]["final_ln"], cfg.norm_eps)
        return x, tuple(torch.stack(a) for a in kv)
    template = tfm._slice(layers, 0)
    flat = tree_util.leaves(layers)

    def body(x, ev, ek, *leaves):
        lp = tree_util.unflatten_like(template, leaves)
        return (_decoder_layer(cfg, lp, x, ek, sin, cos, enc_v=ev)[0],)

    for i in range(cfg.num_layers):
        x, = remat(body, cfg.remat, x, enc_out, enc_out,
                   *[a[i] for a in flat])
    x = nn.rms_norm(x, params["decoder"]["final_ln"], cfg.norm_eps)
    return x, None


def encdec_loss(cfg, params, batch):
    """batch: {"frontend_embeds": (B, S_enc, D), "tokens": (B, S),
    "targets": (B, S)} -> (loss, {"loss"})."""
    if cfg.attention_impl == "pallas":
        raise NotImplementedError(
            "attention_impl='pallas' has no backward (K2 is forward-only, as "
            "the reference's Pallas kernel is): train with 'xla'")
    enc_out = encode(cfg, params, batch["frontend_embeds"])
    h, _ = _decoder_hidden(cfg, params, batch["tokens"], enc_out)
    if h.shape[1] > nn.CE_CHUNK:
        loss = nn.chunked_cross_entropy(cfg, params["embed"], h,
                                        batch["targets"])
    else:
        logits = nn.logits_from_hidden(cfg, params["embed"], h)
        loss = nn.cross_entropy_loss(logits, batch["targets"])
    return loss, {"loss": loss}


def init_encdec_cache(cfg, batch: int, max_len: int,
                      cache_dtype=torch.bfloat16, device=None):
    """An all-zero decode cache: self-attention "k", "v" (L, batch,
    max_len, KV, hd) and cross-attention "xk", "xv" (L, batch,
    frontend_seq, KV, hd)."""
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

    def zeros(T):
        return torch.zeros((L, batch, T, KV, hd), dtype=cache_dtype,
                           device=device)

    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(cfg.frontend_seq), "xv": zeros(cfg.frontend_seq)}


def encdec_prefill(cfg, params, frames, tokens, max_len: int,
                   cache_dtype=torch.bfloat16):
    """Encode, then run the decoder over the prompt. Returns (last_logits
    (B, V), cache); decode continues at position S."""
    enc_out = encode(cfg, params, frames)
    h, (k, v, xk, xv) = _decoder_hidden(cfg, params, tokens, enc_out,
                                        collect_kv=True)
    B, S = tokens.shape
    cache = init_encdec_cache(cfg, B, max_len, cache_dtype, device=h.device)
    cache["k"][:, :, :S] = k.to(cache_dtype)
    cache["v"][:, :, :S] = v.to(cache_dtype)
    cache["xk"] = xk.to(cache_dtype)
    cache["xv"] = xv.to(cache_dtype)
    logits = nn.logits_from_hidden(cfg, params["embed"], h[:, -1:, :])
    return logits[:, 0, :], cache


def encdec_decode_step(cfg, params, cache, tokens, pos: int,
                       row_blocks: int = 1):
    """One decoder step. tokens: (B,); pos: the token's 0-based decoder
    position, a host int shared by every row. The self-attention cache is
    written in place and the same cache dict comes back. `row_blocks` > 1
    (the fused backend's replicas): both attentions block by block, and
    the feature means (`layers.row_blocks`)."""
    with nn.row_blocks(row_blocks):
        return _decode_step(cfg, params, cache, tokens, pos, row_blocks)


def _decode_step(cfg, params, cache, tokens, pos: int, row_blocks: int):
    x = nn.embed_tokens(cfg, params["embed"], tokens[:, None])
    sin, cos = nn.rope_tables(torch.arange(pos, pos + 1, device=x.device),
                              cfg.head_dim, cfg.rope_theta)
    layers = params["decoder"]["layers"]
    last = cache["xk"].shape[2] - 1       # every frame is visible
    for i in range(cfg.num_layers):
        lp = tfm._slice(layers, i)
        x = tfm._attn_decode(cfg, lp["ln1"], lp["attn"], x, cache["k"][i],
                             cache["v"][i], sin, cos, pos, row_blocks)
        hx = nn.rms_norm(x, lp["lnx"], cfg.norm_eps)
        qx, _, _ = nn.qkv_project(cfg, lp["xattn"], hx)
        ox = tfm._decode_attention(qx, cache["xk"][i], cache["xv"][i], last,
                                   row_blocks)
        x = x + nn.out_project(cfg, lp["xattn"], ox)
        h2 = nn.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + nn.mlp(cfg, lp["mlp"], h2)
    x = nn.rms_norm(x, params["decoder"]["final_ln"], cfg.norm_eps)
    return nn.logits_from_hidden(cfg, params["embed"], x)[:, 0, :], cache
