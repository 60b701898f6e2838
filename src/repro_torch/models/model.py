"""Model facade (the reference's `models/model.py`): `build_model(cfg,
device)` -> a uniform API over the decoder LM (dense, moe, vlm, hybrid and
ssm) or the encoder-decoder (audio).

    model.init(seed)                          -> params on model.device
    model.loss(params, batch)                 -> (loss, metrics)
    model.prefill(params, batch, max_len[, row_blocks])
                                    -> (logits, cache)
                                    (batch: tokens [, lengths]
                                     [, frontend_embeds (B, P, D)]; audio:
                                     tokens, frontend_embeds = the
                                     encoder's frames; row_blocks: the rows
                                     are that many independent batches,
                                     the fused backend's replica copies)
    model.decode_step(params, cache, tokens, pos[, row_blocks])
                                    -> (logits, cache)
                                    (pos: a host int or a (B,) tensor)
    model.init_cache(batch, max_len)          -> an all-zero cache
    model.slot_axes()                         -> each cache leaf's batch axis
    model.cache_roles()                       -> each cache leaf's baseline
                                                 role (rows, ring, whole)
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tfm

# Families whose fused backend decodes each replica's block of rows on its
# own (`Model._in_blocks`), because on the card their stacked 2B-row decode
# lost a replica's bits: xlstm-125m's logits at the first step, internvl2's
# at the seventh, a phi3.5-moe `serve()` stream a token
# (`chip_smoke.py::stacked_decode_bits` and its fused stream checks; PERF.md
# §6). Every other family decodes the stacked rows together, the
# attention per block (`transformer._decode_attention`).
BLOCKWISE_FAMILIES = ("moe", "vlm", "ssm")


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

    def loss(self, params, batch, ctx=None):
        """(loss, metrics); `ctx` (a `transformer.ShardCtx`) runs the MoE
        layers expert-parallel over its model group."""
        return tfm.lm_loss(self.cfg, params, batch, ctx)

    def prefill(self, params, batch, max_len: int, row_blocks: int = 1):
        """`row_blocks` > 1: the rows are that many independent batches
        (the fused backend's replica copies of a pack), prefilled together
        except in a moe model, which prefills each block on its own, so
        that each copy routes as its own dispatch group."""
        if row_blocks != 1 and self.cfg.family == "moe":
            n = batch["tokens"].shape[0] // row_blocks
            outs = [self._prefill(params, {k: t[r * n:(r + 1) * n]
                                           for k, t in batch.items()},
                                  max_len) for r in range(row_blocks)]
            return (torch.cat([lg for lg, _ in outs]), tree_util.tree_map(
                lambda ax, *cs: torch.cat(cs, dim=ax), self.slot_axes(),
                *[c for _, c in outs]))
        return self._prefill(params, batch, max_len)

    def _prefill(self, params, batch, max_len: int):
        return tfm.lm_prefill(self.cfg, params, batch["tokens"], max_len,
                              lengths=batch.get("lengths"),
                              frontend_embeds=batch.get("frontend_embeds"))

    def decode_step(self, params, cache, tokens, pos, row_blocks: int = 1):
        """`row_blocks` > 1: the rows are that many independent batches
        (the fused backend's replicas), decoded together with the
        attention per block, or each block on its own (`_in_blocks`) in a
        `BLOCKWISE_FAMILIES` model."""
        if row_blocks != 1 and self.cfg.family in BLOCKWISE_FAMILIES:
            return self._in_blocks(params, cache, tokens, pos, row_blocks)
        return self._decode(params, cache, tokens, pos, row_blocks)

    def _decode(self, params, cache, tokens, pos, row_blocks: int = 1):
        return tfm.lm_decode_step(self.cfg, params, cache, tokens, pos,
                                  row_blocks)

    def _in_blocks(self, params, cache, tokens, pos, row_blocks: int):
        """One decode per block of rows, each on views of its cache rows:
        a block runs exactly the products a decode of its rows alone runs.
        KV caches written in place through the views stay the stacked
        tensors; new states are concatenated."""
        n, axes = tokens.shape[0] // row_blocks, self.slot_axes()
        views = [tree_util.tree_map(lambda c, ax: c.narrow(ax, r * n, n),
                                    cache, axes) for r in range(row_blocks)]
        outs = [self._decode(params, views[r], tokens[r * n:(r + 1) * n],
                             pos[r * n:(r + 1) * n]
                             if isinstance(pos, torch.Tensor) else pos)
                for r in range(row_blocks)]

        def join(c, ax, *vo):
            ins, news = vo[:row_blocks], vo[row_blocks:]
            if all(o is v for v, o in zip(ins, news)):
                return c
            return torch.cat(news, dim=ax)
        return (torch.cat([lg for lg, _ in outs]),
                tree_util.tree_map(join, cache, axes, *views,
                                   *[c for _, c in outs]))

    def init_cache(self, batch: int, max_len: int):
        """An all-zero decode cache (`transformer.init_cache`)."""
        return tfm.init_cache(self.cfg, batch, max_len, device=self.device)

    def cache_roles(self):
        """The cache tree with each leaf's role in a resident baseline of
        the state a decode step consumes (the hybrid backend's): "rows" for
        a KV cache of absolute positions (its rows [0, pos) are live),
        "ring" for a local-attention ring of min(window, max_len) rows
        (every live row but pos % window, which the step overwrites) and
        "whole" for a leaf a step replaces or never writes (recurrent
        states, the cross-attention cache)."""
        if not hasattr(self, "_cache_roles"):
            ring = ("ring" if self.cfg.block_pattern and self.cfg.window_size
                    else "rows")
            cache = self.init_cache(1, 1)
            self._cache_roles = tree_util.unflatten_like(cache, [
                ring if p.endswith(("['k']", "['v']")) else "whole"
                for p, _ in tree_util.flatten_with_path(cache)])
        return self._cache_roles

    def slot_axes(self):
        """The cache tree with each leaf's batch (slot) axis, read off
        `init_cache`'s layout: the one axis where a 1-row and a 2-row
        cache differ (state surgery slices each leaf there)."""
        if not hasattr(self, "_slot_axes"):
            self._slot_axes = tree_util.tree_map(
                lambda a, b: next(i for i, (m, n) in enumerate(
                    zip(a.shape, b.shape)) if m != n),
                self.init_cache(1, 1), self.init_cache(2, 1))
        return self._slot_axes


class EncDecModel(Model):
    """The audio family's facade (`models/encdec.py`): `prefill` reads
    `batch["frontend_embeds"]` as the encoder's frames, and decode
    positions count decoder tokens only."""

    def init(self, seed: int = 0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return encdec_lib.init_encdec(gen, self.cfg, self.device)

    def loss(self, params, batch, ctx=None):
        return encdec_lib.encdec_loss(self.cfg, params, batch)

    def _prefill(self, params, batch, max_len: int):
        if batch.get("lengths") is not None:
            raise NotImplementedError("the encoder-decoder prefills exact "
                                      "prompts only")
        return encdec_lib.encdec_prefill(self.cfg, params,
                                         batch["frontend_embeds"],
                                         batch["tokens"], max_len)

    def _decode(self, params, cache, tokens, pos, row_blocks: int = 1):
        if isinstance(pos, torch.Tensor):
            raise NotImplementedError("the encoder-decoder decodes at one "
                                      "shared position")
        return encdec_lib.encdec_decode_step(self.cfg, params, cache, tokens,
                                             pos, row_blocks)

    def init_cache(self, batch: int, max_len: int):
        return encdec_lib.init_encdec_cache(self.cfg, batch, max_len,
                                            device=self.device)


def build_model(cfg: ModelConfig, device) -> Model:
    tfm.check_family(cfg)
    cls = EncDecModel if cfg.family == "audio" else Model
    return cls(cfg, torch.device(device))
