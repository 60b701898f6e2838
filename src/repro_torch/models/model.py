"""Model facade (the reference's `models/model.py`): `build_model(cfg,
device)` -> a uniform API over the decoder LM (dense, moe, vlm, hybrid and
ssm) or the encoder-decoder (audio).

    model.init(seed)                          -> params on model.device
    model.loss(params, batch)                 -> (loss, metrics)
    model.prefill(params, batch, max_len[, row_blocks][, ctx])
                                    -> (logits, cache)
                                    (batch: tokens [, lengths]
                                     [, frontend_embeds (B, P, D)]; audio:
                                     tokens, frontend_embeds = the
                                     encoder's frames; row_blocks: the rows
                                     are that many independent batches,
                                     the fused backend's replica copies)
    model.decode_step(params, cache, tokens, pos[, row_blocks][, ctx])
                                    -> (logits, cache)
                                    (pos: a host int or a (B,) tensor;
                                     ctx: a sharded `transformer.ShardCtx`,
                                     a rank of a process mesh, whose
                                     logits are its vocab block)
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


# The reference's logical axes of each parameter leaf (its init functions'
# second return value), by the kind of block that holds it and the leaf's
# name; a stacked leaf adds "layers" in front.
_ATTN_AXES = {"wq": ("embed", "heads", "head_dim"),
              "wk": ("embed", "kv_heads", "head_dim"),
              "wv": ("embed", "kv_heads", "head_dim"),
              "wo": ("heads", "head_dim", "embed"),
              "bq": ("heads", "head_dim"), "bk": ("kv_heads", "head_dim"),
              "bv": ("kv_heads", "head_dim")}
_PARAM_AXES = {
    "attention": _ATTN_AXES,
    "mlp": {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed"), "b_up": ("mlp",),
            "b_down": ("embed",)},
    "moe": {"router": ("embed", None),
            "w_gate": ("experts", "embed", "mlp"),
            "w_up": ("experts", "embed", "mlp"),
            "w_down": ("experts", "mlp", "embed")},
    "recurrent": {"wa": ("embed", "rnn"), "wx": ("embed", "rnn"),
                  "w_gelu": ("embed", "rnn"), "w_in": ("embed", "rnn"),
                  "w_out": ("rnn", "embed"), "ba": ("rnn",), "bx": ("rnn",),
                  "lam": ("rnn",), "conv_b": ("rnn",),
                  "conv_w": (None, "rnn")},
    "mlstm": {"w_up": ("embed", "inner"), "conv_w": (None, "inner"),
              "conv_b": ("inner",), "wq": ("embed", "heads", "head_dim"),
              "wk": ("embed", "heads", "head_dim"),
              "wv": ("embed", "heads", "head_dim"), "wi": ("embed", "heads"),
              "wf": ("embed", "heads"), "bi": ("heads",), "bf": ("heads",),
              "gn": ("inner",), "w_down": ("inner", "embed")},
    "slstm": {"conv_w": (None, "inner"), "conv_b": ("inner",),
              **{w: ("embed", "inner") for w in ("wz", "wi", "wf", "wo")},
              **{b: ("inner",) for b in ("bz", "bi", "bf", "bo", "gn")},
              **{r: ("heads", "head_dim", None)
                 for r in ("rz", "ri", "rf", "ro")},
              "w_gate": ("embed", "mlp"), "w_upf": ("embed", "mlp"),
              "w_downf": ("mlp", "embed")},
    "norm": {"": ("embed",)},
    "embed": {"tok": ("vocab", "embed"), "head": ("embed", "vocab")},
}
_CACHE_AXES = {"k": (None, "kv_heads", "head_dim"),
               "v": (None, "kv_heads", "head_dim"),
               "xk": (None, "kv_heads", "head_dim"),
               "xv": (None, "kv_heads", "head_dim"),
               "recurrent": {"conv": (None, "rnn"), "h": ("rnn",)},
               "mlstm": {"conv": (None, "inner"),
                         "C": ("heads", "head_dim", None),
                         "n": ("heads", "head_dim"), "m": ("heads",)},
               "slstm": {"conv": (None, "inner"), "c": ("inner",),
                         "n2": ("inner",), "h": ("inner",), "m": ("inner",)}}
_STACKS = ("layers", "groups", "tail")


def _keys(path: str):
    return [k.strip("'") for k in path[1:-1].split("][")]


def param_axes(cfg: ModelConfig, params):
    """The params' logical axes tree (the reference's `abstract_params()`
    second value), for `sharding.Resolver`."""
    moe = cfg.family == "moe" and cfg.num_experts > 0

    def axes(path):
        keys = _keys(path)
        stacked = ("layers",) if any(k in _STACKS for k in keys) else ()
        name = keys[-1]
        if keys[0] == "embed":
            kind = "embed"
        elif name in ("ln", "ln1", "ln2", "lnx", "final_ln"):
            kind, name = "norm", ""
        elif keys[-2] == "mlp":
            kind = "moe" if moe else "mlp"
        elif keys[-2] in ("attn", "xattn") or keys[-3].endswith(
                "_attention"):
            kind = "attention"
        else:                               # b{i}_{kind}/core
            kind = keys[-3].split("_", 1)[1]
        return stacked + _PARAM_AXES[kind][name]

    return tree_util.unflatten_like(params, [
        axes(p) for p, _ in tree_util.flatten_with_path(params)])


def cache_axes(cache):
    """A decode cache's logical axes tree (the reference's `init_cache`
    second value)."""
    def axes(path):
        keys = _keys(path)
        if len(keys) == 1 or keys[-2].endswith("_attention"):
            return ("layers", "batch") + _CACHE_AXES[keys[-1]]
        return ("layers", "batch") + _CACHE_AXES[
            keys[-2].split("_", 1)[1]][keys[-1]]

    return tree_util.unflatten_like(cache, [
        axes(p) for p, _ in tree_util.flatten_with_path(cache)])


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
        layers expert-parallel over its model group and, with its
        `specs`, every layer on the rank's blocks of the params."""
        return tfm.lm_loss(self.cfg, params, batch, ctx)

    def prefill(self, params, batch, max_len: int, row_blocks: int = 1,
                ctx=None):
        """`row_blocks` > 1: the rows are that many independent batches
        (the fused backend's replica copies of a pack), prefilled together
        except in a moe model, which prefills each block on its own, so
        that each copy routes as its own dispatch group. `ctx` (a
        `transformer.ShardCtx`): the prefill on a rank of a process mesh
        (`transformer.lm_prefill`)."""
        if ctx is not None and row_blocks != 1:
            raise ValueError("a sharded prefill takes one block of rows")
        if row_blocks != 1 and self.cfg.family == "moe":
            n = batch["tokens"].shape[0] // row_blocks
            outs = [self._prefill(params, {k: t[r * n:(r + 1) * n]
                                           for k, t in batch.items()},
                                  max_len) for r in range(row_blocks)]
            return (torch.cat([lg for lg, _ in outs]), tree_util.tree_map(
                lambda ax, *cs: torch.cat(cs, dim=ax), self.slot_axes(),
                *[c for _, c in outs]))
        return self._prefill(params, batch, max_len, ctx)

    def _prefill(self, params, batch, max_len: int, ctx=None):
        return tfm.lm_prefill(self.cfg, params, batch["tokens"], max_len,
                              lengths=batch.get("lengths"),
                              frontend_embeds=batch.get("frontend_embeds"),
                              ctx=ctx)

    def decode_step(self, params, cache, tokens, pos, row_blocks: int = 1,
                    ctx=None):
        """`row_blocks` > 1: the rows are that many independent batches
        (the fused backend's replicas), decoded together with each block
        keeping the bits of its rows decoded alone
        (`transformer.lm_decode_step`); `ctx` as `prefill`'s."""
        if ctx is not None:
            return tfm.lm_decode_step(self.cfg, params, cache, tokens, pos,
                                      row_blocks, ctx=ctx)
        # the unsharded call as it was: the spy that
        # tests/test_torch_generate_families_fused.py sets on
        # `lm_decode_step` takes no `ctx`
        return tfm.lm_decode_step(self.cfg, params, cache, tokens, pos,
                                  row_blocks)

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


def _no_model_axis(ctx) -> None:
    if ctx is not None:
        raise NotImplementedError("the audio family's layers have no model "
                                  "axis in the port")


class EncDecModel(Model):
    """The audio family's facade (`models/encdec.py`): `prefill` reads
    `batch["frontend_embeds"]` as the encoder's frames, and decode
    positions count decoder tokens only."""

    def init(self, seed: int = 0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return encdec_lib.init_encdec(gen, self.cfg, self.device)

    def loss(self, params, batch, ctx=None):
        return encdec_lib.encdec_loss(self.cfg, params, batch)

    def _prefill(self, params, batch, max_len: int, ctx=None):
        _no_model_axis(ctx)
        if batch.get("lengths") is not None:
            raise NotImplementedError("the encoder-decoder prefills exact "
                                      "prompts only")
        return encdec_lib.encdec_prefill(self.cfg, params,
                                         batch["frontend_embeds"],
                                         batch["tokens"], max_len)

    def decode_step(self, params, cache, tokens, pos, row_blocks: int = 1,
                    ctx=None):
        _no_model_axis(ctx)
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
