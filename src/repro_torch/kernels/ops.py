"""Public wrappers for the port's kernels (the reference's `kernels/ops.py`).

Each call runs the hand-written CUDA kernel for a CUDA tensor and the plain
PyTorch version for a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fingerprint import fingerprint_u32
from repro_torch.kernels.flash_attention import flash_attention_fwd


def fingerprint(x: torch.Tensor) -> torch.Tensor:
    """Fused fingerprint of one tensor -> (4,) int32 carrier. Float input is
    upcast to f32 and bitcast; a torch.uint32 tensor is hashed as-is; other
    integer input is value-cast to f32 first, as in the reference."""
    if x.dtype == torch.uint32:
        return fingerprint_u32(x.reshape(-1).view(torch.int32).contiguous())
    xf = x if x.dtype == torch.float32 else x.to(torch.float32)
    return fingerprint_u32(xf.reshape(-1).contiguous().view(torch.int32))


def fingerprint_packed(u: torch.Tensor) -> torch.Tensor:
    """Fingerprint of an already-packed word buffer (the fused whole-state
    path: core.fingerprint.pack_tree_u32 -> one kernel pass) -> (4,).
    Float input is bit-reinterpreted, never value-cast."""
    if u.is_floating_point():
        u = u.to(torch.float32)
    elif u.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"fingerprint_packed expects a packed word buffer "
                        f"(or a float tensor to bitcast), got {u.dtype}")
    return fingerprint_u32(u.reshape(-1).contiguous().view(torch.int32))


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """Flash attention in model layout. q: (B,S,H,hd); k/v: (B,S,KV,hd) ->
    (B,S,H,hd). The transposes are views; the kernel reads and writes
    through strides, so neither direction copies on the card."""
    out = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window)
    return out.transpose(1, 2)
