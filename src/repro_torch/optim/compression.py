"""Gradient compression for the cross-pod all-reduce (the reference's
`optim/compression.py`): int8 with error feedback.

Each gradient leaf is quantized to int8 with a per-tensor scale before the
pod-axis reduction; the quantization residual is carried in a side state
and added back at the next call (EF-SGD), so the scheme is unbiased in the
long run. Nothing in the port calls it, as nothing in the reference does
(`SedarConfig.grad_compression` is not wired to it in either package).
"""
from __future__ import annotations

import torch

from repro_torch import tree as tree_util


def int8_error_feedback(grads, ef_state):
    """Returns (compressed-then-decompressed grads, new ef_state).

    ef_state mirrors grads (f32 residuals); pass None to initialize.
    `torch.round` rounds half to even, as `jnp.round` does."""
    if ef_state is None:
        ef_state = tree_util.tree_map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    def comp(g, e):
        gf = g.to(torch.float32) + e
        scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        deq = q.to(torch.float32) * scale
        return deq.to(g.dtype), gf - deq

    flat_g = tree_util.leaves(grads)
    flat_e = tree_util.leaves(ef_state)
    out = [comp(g, e) for g, e in zip(flat_g, flat_e)]
    return (tree_util.unflatten_like(grads, [o[0] for o in out]),
            tree_util.unflatten_like(grads, [o[1] for o in out]))
