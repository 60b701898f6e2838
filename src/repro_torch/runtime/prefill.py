"""Bucketed, packed, protected prefill (the reference's
`runtime/prefill.py`): prompts are right-padded to a small geometric ladder
of length buckets. PyTorch runs eagerly, so there is no compile cache (the
reference's `CompileStats`, `count_compiles` and `warmup` are left out);
the bucket and pack size still fix the prefill shapes a server sees, which
is what a CUDA-graph capture per (bucket, K) would key on.

Continuous serving admits up to `max_pack` prompts of one bucket in ONE
(K, bucket) prefill (`protected_pack`). Each row carries a LANE: the fused
K1 fingerprint over {its cache rows, its logits row}. The sequential
backend runs the pack twice and compares lanes, so a fault is localized to
its row; the fused backend runs ONE prefill of the 2K rows (both replicas'
copies of the pack) and compares the lanes of rows i and K + i. The
replica-free backends (abft/hybrid) checksum-guard the (K, V) logits block
(`abft/executor.py::pack_checksum_guard`) before the lanes and the argmax,
and localize an uncorrectable fault to the rows whose residuals it
violates. The verdict is a per-row int (`VERDICT_*`): 0 = faulty (retry
this row alone), 1 = clean, 2 = clean after a forward correction (admit,
and record the detection). The server's whole admission read is one
`batched_get([tok, verdict])`.

Right-padding is a dense-family property (not moe: pad tokens would route
through top-k): causal attention keeps pad columns out of every real
position, the last hidden state is gathered at
each row's true end (`lm_prefill(lengths=...)`), and decode overwrites
cache slot `pos` before attending it.

Packing is kept apart from padding. A moe prompt may be PACKED but not
padded: its packs hold prompts of one exact length (`group_packs(exact=
True)`) and no dummy rows, so every token a pack routes is a real one, the
pack's tokens one dispatch group per replica copy, and the prompt is
prefilled at its own length. Where the reference's pack has no pad (every
prompt at a ladder length, a pack of 1, 2 or 4 prompts) the two route the
same tokens together.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree as tree_util
from repro_torch.abft.executor import pack_checksum_guard
from repro_torch.core.fingerprint import lane_fingerprints
from repro_torch.core.injection import (InjectionSpec, inject_row,
                                        inject_row_halves)
from repro_torch.device import upload

DEFAULT_BUCKETS = (8, 16, 32, 64, 128, 256)
VERDICT_BAD = 0
VERDICT_CLEAN = 1
VERDICT_CORRECTED = 2


def make_buckets(max_prompt: int, min_bucket: int = 8) -> Tuple[int, ...]:
    """Geometric (power-of-two) bucket ladder covering `max_prompt`."""
    out = [b := max(int(min_bucket), 1)]
    while b < max_prompt:
        b *= 2
        out.append(b)
    return tuple(out)


def bucket_for(length: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket >= length, or None (overflow -> exact-shape path)."""
    for b in sorted(buckets):
        if length <= b:
            return int(b)
    return None


def pack_sizes(max_pack: int) -> Tuple[int, ...]:
    """The pack sizes a launch takes: powers of two up to `max_pack`."""
    out, k = [], 1
    while k <= max(int(max_pack), 1):
        out.append(k)
        k *= 2
    return tuple(out)


def pack_for(n: int, max_pack: int) -> int:
    """Smallest pack size >= n (n must not exceed max_pack)."""
    for k in pack_sizes(max_pack):
        if n <= k:
            return k
    raise ValueError(f"pack of {n} exceeds max_pack={max_pack}")


def group_packs(items: Sequence[Any], lengths: Sequence[int],
                buckets: Sequence[int], max_pack: int, exact: bool = False
                ) -> Tuple[List[Tuple[int, List[Any]]], List[Any]]:
    """Group `items` by length bucket (`exact`: by length itself, for
    prompts that must not be padded) and chunk each group to at most
    `max_pack`. Returns (packs, overflow): packs is [(bucket or length,
    [items...])] in first-come order within a group; overflow holds items
    longer than the largest bucket (exact-shape path)."""
    by_bucket: Dict[int, List[Any]] = {}
    overflow: List[Any] = []
    for it, ln in zip(items, lengths):
        b = bucket_for(int(ln), buckets)
        if b is None:
            overflow.append(it)
        else:
            by_bucket.setdefault(int(ln) if exact else b, []).append(it)
    packs: List[Tuple[int, List[Any]]] = []
    cap = max(int(max_pack), 1)
    for b in sorted(by_bucket):
        grp = by_bucket[b]
        for i in range(0, len(grp), cap):
            packs.append((b, grp[i:i + cap]))
    return packs, overflow


class BucketedPrefill:
    """Bucketed prefill for `generate()` and the packed, protected admission
    prefill of continuous serving.

    `protected_pack` returns device tensors:
      tok     (K, 1) int64  — each row's first (argmax) token
      rows    the cache tree — each leaf in INSERT layout, the pack row out
                              front ((K, L, 1, T, KV, hd) for a layer
                              stack's k/v): a view of the model-layout
                              cache, so row i is a slot slice
      lengths (K,)          — each row's prompt length (its first decode
                              position)
      verdict (K,)          — `VERDICT_*` per row

    Faults: `InjectionSpec(target='prefill')` flips one bit of pack row
    `leaf_idx`'s logits on the chosen replica (the admission counterpart of
    the decode 'slot' target); `target='prefill_kernel'` lands in the
    checksum window of the abft/hybrid guard."""

    def __init__(self, model, backend: str = "none",
                 inj_spec: Optional[InjectionSpec] = None, inj_flag=None,
                 buckets: Optional[Sequence[int]] = None, max_pack: int = 4):
        self.model = model
        self.backend = backend
        self.inj_spec = inj_spec
        self.inj_flag = inj_flag
        self.buckets = tuple(sorted(buckets)) if buckets else DEFAULT_BUCKETS
        self.max_pack = max(int(max_pack), 1)
        self.dual = backend in ("sequential", "fused")
        self.fused = backend == "fused"
        self.guarded = backend in ("abft", "hybrid")

    @property
    def supported(self) -> bool:
        """Padding is invisible only to dense layer stacks without
        ring-buffer window caches or a frontend (recurrent states and ring
        caches fold every position in). The reference's gate also admits
        moe; the port does not, its one deliberate divergence here: pad
        tokens would route through top-k, taking capacity and expert
        positions from the real tokens, and change their logits. A MoE
        prompt takes the exact prefill (eager PyTorch compiles nothing, so
        that costs nothing)."""
        cfg = self.model.cfg
        return (not cfg.block_pattern and not cfg.window_size
                and not cfg.frontend and cfg.family not in ("audio", "moe"))

    @property
    def may_pack(self) -> bool:
        """Whether continuous serving admits through `protected_pack`: the
        padded families, and moe in exact-length packs (the reference
        packs moe too, padded)."""
        return self.supported or (self.model.cfg.family == "moe"
                                  and not self.model.cfg.frontend)

    def usable_buckets(self, max_len: int) -> Tuple[int, ...]:
        """Buckets the cache can hold (prefill writes `bucket` positions
        into a max_len-deep cache)."""
        return tuple(b for b in self.buckets if b <= max_len)

    def prefill_padded(self, params, tokens: torch.Tensor, max_len: int):
        """Pad to the bucket boundary, prefill, return (logits, cache) in the
        model's layout; None when the prompt overflows the ladder."""
        B, S = tokens.shape
        bucket = bucket_for(S, self.usable_buckets(max_len))
        if bucket is None:
            return None
        toks = F.pad(tokens, (0, bucket - S)) if bucket > S else tokens
        lengths = torch.full((B,), S, dtype=torch.int64, device=tokens.device)
        return self.model.prefill(params, {"tokens": toks, "lengths": lengths},
                                  max_len)

    def _armed(self) -> bool:
        # the engine's arming rule: the once-only flag is the paper's
        # injected.txt — re-executions after a detection do not re-inject
        return (self.inj_flag is not None
                and self.inj_flag.arm_spec(self.inj_spec) is not None)

    def _packed(self, params, toks, lengths, max_len: int,
                replica_id: Optional[int], armed: bool,
                tick: int) -> Dict[str, Any]:
        """One packed prefill: first tokens, insert-layout rows, per-row
        lanes (replica backends) and the guard's verdict (abft/hybrid).
        `replica_id=None` runs both replicas' copies of the pack as one
        prefill of 2K rows (the fused backend), each copy its own MoE
        dispatch group. `lengths=None`: an exact pack, unpadded."""
        spec = self.inj_spec
        batch = {"tokens": toks}
        if lengths is not None:
            batch["lengths"] = lengths
        if replica_id is None:
            batch = {k: torch.cat([t, t]) for k, t in batch.items()}
        logits, cache = self.model.prefill(
            params, batch, max_len, row_blocks=1 if replica_id is not None
            else 2)
        if replica_id is None:
            logits = inject_row_halves(logits, spec, target="prefill",
                                       tick=tick, armed=armed)
        else:
            logits = inject_row(logits, spec, target="prefill", tick=tick,
                                replica_id=replica_id, armed=armed)
        verdict = None
        if self.guarded:
            logits, verdict, _report = pack_checksum_guard(logits, spec,
                                                           tick, armed)
        # each leaf's pack rows out front and its batch axis restored at
        # size 1, as views: row i is a slot slice
        rows = tree_util.tree_map(
            lambda c, ax: c.movedim(ax, 0).unsqueeze(ax + 1), cache,
            self.model.slot_axes())
        return {"tok": torch.argmax(logits, dim=-1)[:, None], "rows": rows,
                "lanes": lane_fingerprints(logits, rows) if self.dual
                else None, "verdict": verdict}

    def protected_pack(self, params, prompts: Sequence[np.ndarray],
                       max_len: int, tick: int) -> Dict[str, Any]:
        """One protected packed prefill over <= max_pack prompts of a shared
        bucket. The pack is padded to the next pack size with dummy rows
        (length 1, token 0) that the caller ignores. The sequential backend
        runs the same pack twice (replica 0 and 1), the fused backend once
        over both replicas' copies, and the lanes are compared per row; DMR
        cannot say WHICH replica corrupted a row, so the verdict only says
        "do not admit". abft/hybrid take the checksum guard's verdict.

        A family that may not pad (moe) takes prompts of one length, with
        no dummy rows: K = n rows of that length, prefilled exactly."""
        n = len(prompts)
        bucket = bucket_for(max(len(p) for p in prompts),
                            self.usable_buckets(max_len))
        if bucket is None:
            raise ValueError("prompt overflows the bucket ladder")
        pad = self.supported
        if not pad:
            bucket = len(prompts[0])
            if any(len(p) != bucket for p in prompts):
                raise ValueError("an unpadded pack takes prompts of one "
                                 "length")
        k = pack_for(n, self.max_pack) if pad else n
        toks = np.zeros((k, bucket), np.int64)
        lens = np.ones((k,), np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
            lens[i] = len(p)
        dev = self.model.device
        toks_d, lens_d = upload(toks, dev), upload(lens, dev)
        lengths = lens_d if pad else None
        armed = self._armed()
        if self.fused:
            both = self._packed(params, toks_d, lengths, max_len, None, armed,
                                tick)
            r0 = {"tok": both["tok"][:k],
                  "rows": tree_util.tree_map(lambda r: r[:k], both["rows"])}
            verdict = _lane_verdict(both["lanes"][:k], both["lanes"][k:])
        else:
            r0 = self._packed(params, toks_d, lengths, max_len, 0, armed,
                              tick)
            if self.dual:
                r1 = self._packed(params, toks_d, lengths, max_len, 1, armed,
                                  tick)
                verdict = _lane_verdict(r0["lanes"], r1["lanes"])
            elif self.guarded:
                verdict = r0["verdict"]
            else:
                verdict = torch.full((k,), VERDICT_CLEAN, dtype=torch.int64,
                                     device=dev)
        return {"tok": r0["tok"], "rows": r0["rows"], "lengths": lens_d,
                "verdict": verdict, "n": n, "pack_size": k}


def _lane_verdict(lanes0: torch.Tensor, lanes1: torch.Tensor) -> torch.Tensor:
    """Per-prompt replica compare: rows whose hash lanes (cols 0..1)
    disagree are faulty."""
    agree = torch.all(lanes0[:, :2] == lanes1[:, :2], dim=1)
    return torch.where(agree, VERDICT_CLEAN, VERDICT_BAD)
