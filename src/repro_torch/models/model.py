"""Model facade (the reference's `models/model.py`, dense family):
`build_model(cfg, device)` -> a uniform API over the decoder LM.

    model.init(seed)                          -> params on model.device
    model.loss(params, batch)                 -> (loss, metrics)
    model.prefill(params, batch, max_len)     -> (logits, cache)
    model.decode_step(params, cache, tokens, pos[, row_blocks])
                                    -> (logits, cache)
                                    (pos: a host int or a (B,) tensor)
    model.init_cache(batch, max_len)          -> an all-zero cache
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm


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
                              lengths=batch.get("lengths"))

    def decode_step(self, params, cache, tokens, pos, row_blocks: int = 1):
        return tfm.lm_decode_step(self.cfg, params, cache, tokens, pos,
                                  row_blocks)

    def init_cache(self, batch: int, max_len: int):
        """An all-zero decode cache (L, batch, max_len, KV, hd) per leaf."""
        return tfm.init_cache(self.cfg, batch, max_len, device=self.device)


def build_model(cfg: ModelConfig, device) -> Model:
    if cfg.family != "dense" or cfg.block_pattern or cfg.frontend:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")
    return Model(cfg, torch.device(device))
