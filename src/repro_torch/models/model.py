"""Model facade (the reference's `models/model.py`, decoder-only families
dense, moe, vlm and hybrid): `build_model(cfg, device)` -> a uniform API
over the decoder LM.

    model.init(seed)                          -> params on model.device
    model.loss(params, batch)                 -> (loss, metrics)
    model.prefill(params, batch, max_len)     -> (logits, cache)
                                    (batch: tokens [, lengths]
                                     [, frontend_embeds (B, P, D)])
    model.decode_step(params, cache, tokens, pos[, row_blocks])
                                    -> (logits, cache)
                                    (pos: a host int or a (B,) tensor)
    model.init_cache(batch, max_len)          -> an all-zero cache

The ssm (xlstm) and audio (enc-dec) families raise NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm


def count_params_analytic(cfg: ModelConfig) -> int:
    """Parameter count, mirroring the init functions exactly (the
    reference's formula for the dense, moe, hybrid and vlm families)."""
    D, H, KV, hd, F, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim, cfg.d_ff, cfg.vocab_size)

    def attn():
        n = D * H * hd + 2 * D * KV * hd + H * hd * D
        if cfg.qkv_bias:
            n += H * hd + 2 * KV * hd
        return n

    def mlp():
        if cfg.mlp_act == "swiglu":
            return 3 * D * F
        return 2 * D * F + F + D

    def recurrent():
        R, W = cfg.d_rnn, cfg.conv_width
        return (2 * D * R + R * D + W * R + R          # branches + conv
                + 2 * (R * R + R) + R)                  # gates + Lambda

    total = V * D + D                                    # embed + final_ln
    if not cfg.tie_embeddings:
        total += D * V

    if cfg.block_pattern:
        per_kind = {"attention": attn() + D, "recurrent": recurrent() + D}
        if cfg.d_ff:
            per_kind["attention"] += mlp() + D
            per_kind["recurrent"] += mlp() + D
        pat = tuple(cfg.block_pattern)
        G = cfg.num_layers // len(pat)
        counts = list(pat) * G + list(pat[:cfg.num_layers - G * len(pat)])
        return total + sum(per_kind[k] for k in counts)

    per_layer = attn() + 2 * D
    if cfg.family == "moe" and cfg.num_experts:
        per_layer += D * cfg.num_experts + cfg.num_experts * 3 * D * F
    else:
        per_layer += mlp()
    return total + cfg.num_layers * per_layer


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device

    def init(self, seed: int = 0):
        """Seeded random params, generated on the model's device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return tfm.init_lm(gen, self.cfg, self.device)

    def loss(self, params, batch):
        return tfm.lm_loss(self.cfg, params, batch)

    def prefill(self, params, batch, max_len: int):
        return tfm.lm_prefill(self.cfg, params, batch["tokens"], max_len,
                              lengths=batch.get("lengths"),
                              frontend_embeds=batch.get("frontend_embeds"))

    def decode_step(self, params, cache, tokens, pos, row_blocks: int = 1):
        return tfm.lm_decode_step(self.cfg, params, cache, tokens, pos,
                                  row_blocks)

    def init_cache(self, batch: int, max_len: int):
        """An all-zero decode cache (`transformer.init_cache`)."""
        return tfm.init_cache(self.cfg, batch, max_len, device=self.device)


def build_model(cfg: ModelConfig, device) -> Model:
    tfm.check_family(cfg)
    return Model(cfg, torch.device(device))
