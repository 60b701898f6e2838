"""Dense decoder LM: init, full-sequence trunk, prefill and decode (the dense
branch of the reference's `models/transformer.py`).

The reference scans over stacked layer params with `lax.scan`; here a
Python loop walks the layers and slices each stacked leaf (a view, no
copy). Params keep the reference's tree — per-layer stacks with a leading L
axis under ``params["layers"]`` — so a leaf index and a fingerprint mean the
same leaf in both packages.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.kernels import ops
from repro_torch.models import layers as nn


def _init_dense_layer_stack(gen, cfg, L: int, device):
    pdt = nn.torch_dtype(cfg.param_dtype)
    return {"attn": nn.init_attention(gen, cfg, L, device),
            "mlp": nn.init_mlp(gen, cfg, L, device),
            "ln1": torch.zeros((L, cfg.d_model), dtype=pdt, device=device),
            "ln2": torch.zeros((L, cfg.d_model), dtype=pdt, device=device)}


def init_lm(gen: torch.Generator, cfg, device) -> Dict[str, Any]:
    """Seeded random params (f32 masters) on `device`."""
    if cfg.family != "dense" or cfg.block_pattern:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    pdt = nn.torch_dtype(cfg.param_dtype)
    return {"embed": nn.init_embedding(gen, cfg, device),
            "final_ln": torch.zeros((cfg.d_model,), dtype=pdt, device=device),
            "layers": _init_dense_layer_stack(gen, cfg, cfg.num_layers, device)}


def layer_params(params, i: int):
    """Layer i's slice of the stacked layer params (views)."""
    return tree_util.tree_map(lambda a: a[i], params["layers"])


def _attention_dispatch(cfg, q, k, v):
    """attention_impl="pallas": the flash kernel K2 (its plain version on the
    CPU); otherwise exact plain attention at every length (the reference's
    chunked XLA form above CHUNKED_THRESHOLD computes the same function)."""
    if cfg.attention_impl == "pallas":
        return ops.flash_attention(q, k, v, causal=True)
    return nn.causal_attention(q, k, v)


def _attn_full(cfg, lp, x, sin, cos):
    """Pre-norm attention sub-block over the full sequence. Returns
    (x + attn, k, v) with k rotated, as the decode cache stores them."""
    h = nn.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = nn.qkv_project(cfg, lp["attn"], h)
    q = nn.apply_rope(q, sin, cos)
    k = nn.apply_rope(k, sin, cos)
    o = _attention_dispatch(cfg, q, k, v)
    return x + nn.out_project(cfg, lp["attn"], o), k, v


def _mlp_sub(cfg, lp, x):
    h = nn.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + nn.mlp(cfg, lp["mlp"], h)


def lm_hidden(cfg, params, tokens, collect_kv: bool = False):
    """tokens: (B, S) -> (hidden (B,S,D), kv or None). kv is (k, v), each
    (L, B, S, KV, hd), when `collect_kv`."""
    x = nn.embed_tokens(cfg, params["embed"], tokens)
    S = x.shape[1]
    sin, cos = nn.rope_tables(torch.arange(S, device=x.device),
                              cfg.head_dim, cfg.rope_theta)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        x, k, v = _attn_full(cfg, lp, x, sin, cos)
        x = _mlp_sub(cfg, lp, x)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    x = nn.rms_norm(x, params["final_ln"], cfg.norm_eps)
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return x, kv


def init_cache(cfg, batch: int, max_len: int,
               cache_dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cache_dtype, device=device),
            "v": torch.zeros(shape, dtype=cache_dtype, device=device)}


def lm_decode_step(cfg, params, cache, tokens, pos: int):
    """One serve step. tokens: (B,); pos: 0-based absolute position of this
    token (a host int). Updates `cache` in place (see layers.cache_update)
    and returns (logits (B,V), cache)."""
    x = nn.embed_tokens(cfg, params["embed"], tokens[:, None])
    sin, cos = nn.rope_tables(torch.arange(pos, pos + 1, device=x.device),
                              cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        h = nn.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = nn.qkv_project(cfg, lp["attn"], h)
        q = nn.apply_rope(q, sin, cos)
        k = nn.apply_rope(k, sin, cos)
        kc, vc = nn.cache_update(cache["k"][i], cache["v"][i], k, v, pos)
        o = nn.decode_attention(q, kc, vc, pos)
        x = x + nn.out_project(cfg, lp["attn"], o)
        x = _mlp_sub(cfg, lp, x)
    x = nn.rms_norm(x, params["final_ln"], cfg.norm_eps)
    logits = nn.logits_from_hidden(cfg, params["embed"], x)[:, 0, :]
    return logits, cache


def lm_prefill(cfg, params, tokens, max_len: int,
               cache_dtype=torch.bfloat16,
               lengths: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the trunk over the prompt and build the decode cache.
    Returns (last_logits (B,V), cache).

    `lengths` (B,) enables RIGHT-PADDED prompts: the last hidden state is
    gathered at each row's true final position. Causal attention keeps pad
    columns out of every real position, and decode overwrites slot `pos`
    before attending it, so the pad entries written into the cache beyond
    `lengths` are never observed."""
    if cfg.window_size and lengths is not None:
        raise NotImplementedError("length-gathered prefill is incompatible "
                                  "with ring-buffer window caches")
    B, S = tokens.shape
    h, (k, v) = lm_hidden(cfg, params, tokens, collect_kv=True)
    cache = init_cache(cfg, B, max_len, cache_dtype, device=h.device)
    cache["k"][:, :, :S] = k.to(cache_dtype)
    cache["v"][:, :, :S] = v.to(cache_dtype)
    if lengths is None:
        h_last = h[:, -1:, :]
    else:
        idx = torch.clamp(lengths.to(torch.int64) - 1, 0, S - 1)
        h_last = torch.take_along_dim(h, idx[:, None, None], dim=1)
    logits = nn.logits_from_hidden(cfg, params["embed"], h_last)[:, 0, :]
    return logits, cache
