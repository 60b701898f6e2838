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
    `mismatch_report`. `leaf_fingerprints` is the same through K1 (one
    launch per leaf) for CUDA leaves: the trainer's per-leaf state
    fingerprint.
  * per-row  -- `slot_fingerprints` (N, V) -> (N, 4) and `lane_fingerprints`
    (a pack's per-prompt lanes): one K1 call per row or lane, reading the
    leaves in place; on CUDA tensors K1 or an error, never a fallback.
  * resident -- `slot_rows_fingerprint` -> (4,): one K1 call over every
    slot's cache rows [0, pos[i]) (a ring's live rows but pos[i] % W),
    the recurrent states whole, and the tokens, the positions read by the
    kernel from the device (K1's row-limit leaves).
  * fused    -- `pytree_fingerprint_fused` -> (4,): all leaves hashed as
    ONE word buffer in one launch of kernel K1. On the card, f32, int32,
    uint32, bf16 and int64 leaves laid out as rows of one contiguous run
    are read where they lie (no cast, copy or concatenation); other leaves
    are packed first. On the CPU K1's plain version walks the same table.
    This is the commit-compare hot path: the lanes below at L = 1.
  * lanes    -- `pytree_fingerprint_lanes` -> (L, 4): the packed words cut
    into L equal lanes (zero-padded tail), each hashed on its own index
    stream, in one K1 launch on the card (the mesh backends' per-shard
    compare; `lane_of_leaf_index` names the lane of an element).
Leaf order is the reference's (sorted dict keys, `repro_torch.tree`).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core import hostsync
from repro_torch.kernels import fingerprint as kfp
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


def leaf_fingerprints(tree) -> torch.Tensor:
    """`pytree_fingerprint` with each CUDA leaf hashed by K1, one launch per
    leaf read in place (or over its packed words where K1 cannot read it in
    place): the hash words equal the plain per-leaf ones; the stats are
    zeroed for non-float leaves as `tensor_fingerprint` does. CPU leaves
    take the plain version."""
    leaves = _leaf_tensors(tree)
    if not leaves or not all(l.is_cuda for l in leaves):
        return pytree_fingerprint(tree)
    fps = []
    for leaf in leaves:
        if leaf.numel() == 0:
            fps.append(torch.zeros(4, dtype=torch.int32, device=leaf.device))
            continue
        table = kfp.leaf_table([leaf])
        fp = (kfp.fingerprint_leaves(table) if table is not None
              else kfp.fingerprint_u32(_to_u32(leaf)))
        if not leaf.is_floating_point():
            fp = torch.cat([fp[:2], torch.zeros(2, dtype=torch.int32,
                                                device=fp.device)])
        fps.append(fp)
    return torch.stack(fps)


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
    """Whole-state fingerprint -> (4,): the one lane of
    `pytree_fingerprint_lanes` (ONE launch of kernel K1 for CUDA tensors,
    K1's plain version for CPU tensors). Hash words equal the reference's
    fused fingerprint; the fused hash is not comparable with per-leaf
    hashes."""
    return pytree_fingerprint_lanes(tree, 1)[0]


def pytree_fingerprint_lanes(tree, n_lanes: int) -> torch.Tensor:
    """Per-shard fingerprint lanes -> (n_lanes, 4) int32 carrier. Lane i
    covers packed words [i W, (i + 1) W), W = ceil(N / n_lanes), the tail
    zero-padded, each lane's index stream starting at 0 (the reference's
    `pytree_fingerprint_lanes`, bit for bit on h1/h2). One K1 call over
    K1's lane table of the leaves read in place (`kfp.lane_table`), or of
    their packed words where K1 cannot read a leaf in place; K1's plain
    version for CPU tensors."""
    L = max(int(n_lanes), 1)
    leaves = _leaf_tensors(tree)
    if not sum(l.numel() for l in leaves):
        dev = leaves[0].device if leaves else torch.device("cpu")
        return torch.zeros((L, 4), dtype=torch.int32, device=dev)
    table = kfp.lane_table(leaves, L)
    if table is None:
        table = kfp.lane_table([pack_tree_u32(tree)], L)
    return kfp.fingerprint_lanes(table, L)


def lane_of_leaf_index(tree, leaf_idx: int, flat_idx: int,
                       n_lanes: int) -> int:
    """Host-side: the lane of `pytree_fingerprint_lanes` that covers element
    `flat_idx` of leaf `leaf_idx` (flatten order); one word per element."""
    sizes = [int(np.prod(l.shape)) if hasattr(l, "shape") else 1
             for l in tree_util.leaves(tree)]
    off = sum(sizes[:leaf_idx]) + int(flat_idx)
    width = -(-sum(sizes) // max(int(n_lanes), 1))
    return off // width


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


def fingerprint_in_place(leaves) -> torch.Tensor:
    """One K1 call over `leaves` read where they lie -> (4,); the plain
    leaf walk for CPU tensors. Raises when K1 cannot read them in place."""
    table = kfp.leaf_table(leaves)
    if table is None:
        raise ValueError(
            "K1 cannot read these leaves in place: "
            + ", ".join(f"{tuple(t.shape)} {t.dtype} strides {t.stride()}"
                        for t in leaves))
    return kfp.fingerprint_leaves(table)


def slot_fingerprints(logits: torch.Tensor,
                      active: torch.Tensor) -> torch.Tensor:
    """Per-slot fingerprints of an (N, V) logits block -> (N, 4): row i is
    hashed on its own (the reference's `vmap(tensor_fingerprint)`), one K1
    call per row in place; rows of inactive slots are zeroed on the device,
    so they never mismatch."""
    fps = torch.stack([fingerprint_in_place([logits[i]])
                       for i in range(logits.shape[0])])
    return torch.where(active[:, None], fps, torch.zeros_like(fps))


def lane_fingerprints(logits: torch.Tensor, rows) -> torch.Tensor:
    """Per-prompt lanes of a packed prefill -> (K, 4): lane i is the fused
    fingerprint of {cache: row i of every rows leaf, logits: logits[i]} (the
    reference's `_packed_fn` lanes), one K1 call per lane over the pack
    row's strided views."""
    return torch.stack([
        fingerprint_in_place(tree_util.leaves(
            {"cache": tree_util.tree_map(lambda r: r[i], rows),
             "logits": logits[i]}))
        for i in range(logits.shape[0])])


def slot_rows_fingerprint(cache, pos: torch.Tensor, tok: torch.Tensor,
                          roles=None, axes=None,
                          window: int = 0) -> torch.Tensor:
    """One K1 call -> (4,) over what continuous serving's decode state holds
    at rest: for each cache leaf of role "rows" (`Model.cache_roles`; the
    default for every leaf) each slot i's rows [0, pos[i]), for a "ring"
    of `window` rows each slot's live rows but pos[i] % window, a "whole"
    leaf as it is, then the tokens. `axes` (`Model.slot_axes`; default 1)
    gives each leaf's slot axis, its rows the axis after it. `pos` stays on
    the device: the kernel reads each slot's limit there, and the rows it
    leaves out (the failed step's own in-place write, an idle slot's
    frozen row) count as zero words at their fixed offsets. Leaf order:
    the cache's flatten order (sorted names), slot by slot, then the
    tokens."""
    leaves, limits = [], []
    flat = tree_util.leaves(cache)
    roles = tree_util.leaves(roles) if roles is not None else ["rows"] * len(
        flat)
    axes = tree_util.leaves(axes) if axes is not None else [1] * len(flat)
    for c, role, ax in zip(flat, roles, axes):
        if role == "whole":
            leaves.append(c)
            limits.append(None)
            continue
        ring = (window,) if role == "ring" else ()
        for i in range(c.shape[ax]):
            leaves.append(c.select(ax, i))
            limits.append((pos[i], ax, *ring))
    leaves.append(tok)
    limits.append(None)
    table = kfp.leaf_table(leaves, limits)
    if table is None:
        raise ValueError("K1 cannot read the slot cache rows in place")
    return kfp.fingerprint_leaves(table)
