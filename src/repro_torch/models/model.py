"""Model facade (the reference's `models/model.py`, dense family):
`build_model(cfg, device)` -> a uniform API over the decoder LM.

    model.init(seed)                          -> params on model.device
    model.prefill(params, batch, max_len)     -> (logits, cache)
    model.decode_step(params, cache, tokens, pos) -> (logits, cache)
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

    def prefill(self, params, batch, max_len: int):
        return tfm.lm_prefill(self.cfg, params, batch["tokens"], max_len,
                              lengths=batch.get("lengths"))

    def decode_step(self, params, cache, tokens, pos: int):
        return tfm.lm_decode_step(self.cfg, params, cache, tokens, pos)


def build_model(cfg: ModelConfig, device) -> Model:
    if cfg.family != "dense" or cfg.block_pattern or cfg.frontend:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")
    return Model(cfg, torch.device(device))
