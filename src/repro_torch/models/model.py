"""Model facade (the reference's `models/model.py`): `build_model(cfg,
device)` -> a uniform API over the decoder LM (dense, moe, vlm, hybrid and
ssm) or the encoder-decoder (audio).

    model.init(seed)                          -> params on model.device
    model.loss(params, batch)                 -> (loss, metrics)
    model.prefill(params, batch, max_len)     -> (logits, cache)
                                    (batch: tokens [, lengths]
                                     [, frontend_embeds (B, P, D)]; audio:
                                     tokens, frontend_embeds = the
                                     encoder's frames)
    model.decode_step(params, cache, tokens, pos[, row_blocks])
                                    -> (logits, cache)
                                    (pos: a host int or a (B,) tensor)
    model.init_cache(batch, max_len)          -> an all-zero cache
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tfm


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count, mirroring the init functions exactly (the
    reference's formula). `active_only` counts a MoE layer's router and
    the k experts a token uses."""
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

    def moe():
        E = cfg.experts_per_token if active_only else cfg.num_experts
        return D * cfg.num_experts + E * 3 * D * F      # router + experts

    def recurrent():
        R, W = cfg.d_rnn, cfg.conv_width
        return (2 * D * R + R * D + W * R + R          # branches + conv
                + 2 * (R * R + R) + R)                  # gates + Lambda

    def mlstm():
        return (D * 2 * D + cfg.conv_width * D + D      # up + conv
                + 3 * D * H * hd + 2 * (D * H + H)      # qkv + gates
                + D + D * D)                            # gn + down

    def slstm():
        Fp = int(cfg.proj_factor * D)
        return (cfg.conv_width * D + D                  # conv
                + 4 * (D * D + D) + 4 * H * hd * hd     # gates + recurrent
                + D + 3 * D * Fp)                       # gn + ffn

    total = V * D + D                                    # embed + final_ln
    if not cfg.tie_embeddings:
        total += D * V

    if cfg.family == "audio":
        total -= D   # per-stack final_lns, no global one
        layer = attn() + mlp() + 2 * D
        xlayer = attn() + D
        total += cfg.encoder_layers * layer + D
        return total + cfg.num_layers * (layer + xlayer) + D

    if cfg.block_pattern:
        per_kind = {"attention": attn() + D, "recurrent": recurrent() + D,
                    "mlstm": mlstm() + D, "slstm": slstm() + D}
        if cfg.d_ff:
            per_kind["attention"] += mlp() + D
            per_kind["recurrent"] += mlp() + D
        pat = tuple(cfg.block_pattern)
        G = cfg.num_layers // len(pat)
        counts = list(pat) * G + list(pat[:cfg.num_layers - G * len(pat)])
        return total + sum(per_kind[k] for k in counts)

    per_layer = attn() + 2 * D
    per_layer += moe() if (cfg.family == "moe" and cfg.num_experts) else mlp()
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


class EncDecModel(Model):
    """The audio family's facade (`models/encdec.py`): `prefill` reads
    `batch["frontend_embeds"]` as the encoder's frames, and decode
    positions count decoder tokens only."""

    def init(self, seed: int = 0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return encdec_lib.init_encdec(gen, self.cfg, self.device)

    def loss(self, params, batch):
        return encdec_lib.encdec_loss(self.cfg, params, batch)

    def prefill(self, params, batch, max_len: int):
        if batch.get("lengths") is not None:
            raise NotImplementedError("the encoder-decoder prefills exact "
                                      "prompts only")
        return encdec_lib.encdec_prefill(self.cfg, params,
                                         batch["frontend_embeds"],
                                         batch["tokens"], max_len)

    def decode_step(self, params, cache, tokens, pos, row_blocks: int = 1):
        if row_blocks != 1 or isinstance(pos, torch.Tensor):
            raise NotImplementedError("the encoder-decoder decodes one batch "
                                      "at one shared position")
        return encdec_lib.encdec_decode_step(self.cfg, params, cache, tokens,
                                             pos)

    def init_cache(self, batch: int, max_len: int):
        return encdec_lib.init_encdec_cache(self.cfg, batch, max_len,
                                            device=self.device)


def build_model(cfg: ModelConfig, device) -> Model:
    tfm.check_family(cfg)
    cls = EncDecModel if cfg.family == "audio" else Model
    return cls(cfg, torch.device(device))
