"""Shape stand-ins for every model input (the reference's
`launch/input_specs.py`): tensors on the `meta` device, which carry a
shape and a dtype and hold no memory, with their logical axes.

Each function returns (specs, logical_axes) per (arch config, ShapeSpec),
the reference's dtypes and axes leaf for leaf; `shardings` resolves the
axes with the port's `sharding.Resolver` over a mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import layers as nn

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _abstract_params(cfg: ModelConfig):
    """(params on `meta` at the config's param dtype, logical axes)."""
    from repro_torch.models import encdec, transformer as tfm
    from repro_torch.models.model import param_axes
    init = encdec.init_encdec if cfg.family == "audio" else tfm.init_lm
    params = init(None, cfg, META)
    return params, param_axes(cfg, params)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[Dict, Dict]:
    """Training / prefill batch: tokens + targets (+ the frontend's
    embeddings for the modality-stub archs)."""
    B, S = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {"tokens": _meta((B, S), torch.int32)}
    axes: Dict[str, Any] = {"tokens": ("batch", None)}
    if shape.kind == "train":
        specs["targets"] = _meta((B, S), torch.int32)
        axes["targets"] = ("batch", None)
    if cfg.frontend:
        specs["frontend_embeds"] = _meta(
            (B, cfg.frontend_seq, cfg.frontend_dim), nn.torch_dtype(cfg.dtype))
        axes["frontend_embeds"] = ("batch", None, None)
    return specs, axes


def decode_specs(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[Dict, Dict]:
    """Serve-step inputs: one new token per sequence, the position and the
    bf16 decode cache of the shape's length."""
    from repro_torch.models import build_model
    from repro_torch.models.model import cache_axes
    B, S = shape.global_batch, shape.seq_len
    cache = build_model(cfg, META).init_cache(B, S)
    specs = {"tokens": _meta((B,), torch.int32),
             "pos": _meta((), torch.int32), "cache": cache}
    axes = {"tokens": ("batch",), "pos": (), "cache": cache_axes(cache)}
    return specs, axes


def train_state_specs(cfg: ModelConfig) -> Tuple[Dict, Dict]:
    """The trainer's state: f32 master params, the AdamW moments and the
    step."""
    params, paxes = _abstract_params(cfg)
    f32 = tree_util.tree_map(lambda t: _meta(t.shape, torch.float32), params)
    m = tree_util.tree_map(lambda t: _meta(t.shape, torch.float32), params)
    v = tree_util.tree_map(lambda t: _meta(t.shape, torch.float32), params)
    specs = {"params": f32, "opt": {"m": m, "v": v},
             "step": _meta((), torch.int32)}
    axes = {"params": paxes, "opt": {"m": paxes, "v": paxes}, "step": ()}
    return specs, axes


def serve_param_specs(cfg: ModelConfig) -> Tuple[Dict, Dict]:
    """A serving deployment's bf16 weights."""
    params, paxes = _abstract_params(cfg)
    return (tree_util.tree_map(lambda t: _meta(t.shape, torch.bfloat16),
                               params), paxes)


def shardings(resolver, specs, axes):
    """The specs' leaves' mesh placement from their logical axes
    (`sharding.Resolver.tree_specs`): a tree of `spec` tuples."""
    return resolver.tree_specs(axes, tree_util.tree_map(
        lambda t: tuple(t.shape), specs))


def nbytes(specs) -> int:
    """The bytes the specs' leaves would hold."""
    return sum(t.numel() * t.element_size() for t in tree_util.leaves(specs))
