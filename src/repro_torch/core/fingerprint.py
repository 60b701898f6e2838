"""State fingerprinting — SEDAR's comparison primitive (the reference's
`core/fingerprint.py`).

Every tensor is compressed into two 32-bit hash words plus two diagnostic
stats in one streaming pass, and replicas compare only the hash words:

    h1 = sum_i ((x_i XOR (i * C1)) * C2)       mod 2^32
    h2 = sum_i (t XOR (t >> 15)), t = (x_i+i)*C3
    s  = sum(x)  (f32)        a  = max(|x|)  (f32)

where x_i is the tensor after `_to_u32`'s exact reinterpretation. For the
same input bits, h1 and h2 equal the reference's bit for bit.

Words and fingerprints travel as int32 tensors holding u32 bits (see
`kernels/fingerprint.py`).

Two granularities, as in the reference:
  * per-leaf -- `pytree_fingerprint` -> (n_leaves, 4), plain PyTorch on the
    tensors' own device; keeps leaf-level localization for
    `mismatch_report`.
  * fused    -- `pytree_fingerprint_fused` -> (4,): all leaves packed into
    ONE word buffer and hashed in one pass of kernel K1 (its plain version
    on the CPU). This is the commit-compare hot path.
Leaf order is the reference's (sorted dict keys, `repro_torch.tree`).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core import hostsync
from repro_torch.kernels import ops
from repro_torch.kernels.fingerprint import fingerprint_plain


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _leaf_tensors(tree):
    """The tree's leaves as tensors on one device: Python scalars (e.g. a
    host-side position) join the device of the first tensor leaf."""
    leaves = tree_util.leaves(tree)
    dev = next((l.device for l in leaves if isinstance(l, torch.Tensor)),
               torch.device("cpu"))
    return [l if isinstance(l, torch.Tensor) else torch.as_tensor(l, device=dev)
            for l in leaves]


def _to_u32(x) -> torch.Tensor:
    """Exact reinterpretation of any supported dtype as a flat word buffer
    (int32 carrier of u32 bits), with the reference's casts:
    f64 -> f32 and i64 -> i32 are value casts, bf16/f16 upcast exactly to
    f32, f32 is bitcast, int32/uint32 keep their bits, and bool, int8,
    uint8, int16 and uint16 are value casts to u32."""
    x = _as_tensor(x)
    if x.dtype == torch.float64:
        x = x.to(torch.float32)
    elif x.dtype == torch.int64:
        x = x.to(torch.int32)
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.to(torch.float32)
    if x.dtype == torch.float32:
        u = x.contiguous().view(torch.int32)
    elif x.dtype == torch.int32:
        u = x
    elif x.dtype == torch.uint32:
        u = x.contiguous().view(torch.int32)
    elif x.dtype in (torch.bool, torch.int8, torch.uint8, torch.int16,
                     torch.uint16):
        u = x.to(torch.int32)
    else:
        raise TypeError(f"unsupported dtype {x.dtype}")
    return u.reshape(-1).contiguous()


def tensor_fingerprint(x) -> torch.Tensor:
    """-> (4,) int32 carrier: [h1, h2, bits(sum), bits(absmax)]. Plain
    PyTorch; the stats are over the float values and 0 for other dtypes."""
    x = _as_tensor(x)
    fp = fingerprint_plain(_to_u32(x))
    if not x.is_floating_point():
        fp = torch.cat([fp[:2], torch.zeros(2, dtype=torch.int32,
                                            device=fp.device)])
    return fp


def pytree_fingerprint(tree) -> torch.Tensor:
    """-> (n_leaves, 4) int32 carrier, leaf order = flatten order."""
    fps = [tensor_fingerprint(l) for l in _leaf_tensors(tree)]
    return torch.stack(fps) if fps else torch.zeros((0, 4), dtype=torch.int32)


def pack_tree_u32(tree) -> torch.Tensor:
    """Bit-exact packing of every leaf into one flat word buffer (flatten
    order). A reinterpretation, not a value conversion: a corrupted bit in
    any leaf is a corrupted bit in the packed buffer."""
    leaves = _leaf_tensors(tree)
    if not leaves:
        return torch.zeros((0,), dtype=torch.int32)
    words = [_to_u32(l) for l in leaves]
    return words[0] if len(words) == 1 else torch.cat(words)


def packed_fingerprint(u) -> torch.Tensor:
    """Plain fingerprint of an already-packed buffer -> (4,); the stats are
    over the f32 reinterpretation of the words. Non-word input is
    bit-reinterpreted through `_to_u32`, never value-cast."""
    u = _as_tensor(u)
    if u.dtype != torch.int32:
        u = _to_u32(u)
    return fingerprint_plain(u.reshape(-1).contiguous())


def pytree_fingerprint_fused(tree) -> torch.Tensor:
    """Whole-state fingerprint -> (4,): the leaves packed once into one word
    buffer and hashed in ONE launch of kernel K1 (CUDA tensors) or its
    plain version (CPU tensors). Hash words equal the reference's fused
    fingerprint; the fused hash is not comparable with per-leaf hashes."""
    u = pack_tree_u32(tree)
    if u.numel() == 0:
        return torch.zeros((4,), dtype=torch.int32, device=u.device)
    return ops.fingerprint_packed(u)


def fingerprints_equal(fp_a, fp_b) -> torch.Tensor:
    """Exact equality on the hash words (cols 0..1); stats are diagnostics.
    Returns a device bool; reading it is the caller's (counted) sync."""
    return torch.all(fp_a[..., :2] == fp_b[..., :2])


def mismatch_report(tree, fp_a, fp_b) -> List[Dict[str, Any]]:
    """Host-side: list of {leaf, h_a, h_b, sum_a, sum_b} for leaves whose
    hash words differ (one counted read batch)."""
    paths = [p for p, _ in tree_util.flatten_with_path(tree)]
    a, b = hostsync.batched_get([fp_a, fp_b], label="mismatch_report")
    a = np.asarray(a).astype(np.int32).view(np.uint32)
    b = np.asarray(b).astype(np.int32).view(np.uint32)
    out = []
    for i, path in enumerate(paths):
        if not np.array_equal(a[i, :2], b[i, :2]):
            out.append({
                "leaf": path,
                "h_a": [int(a[i, 0]), int(a[i, 1])],
                "h_b": [int(b[i, 0]), int(b[i, 1])],
                "sum_a": float(a[i, 2:3].view(np.float32)[0]),
                "sum_b": float(b[i, 2:3].view(np.float32)[0]),
            })
    return out
