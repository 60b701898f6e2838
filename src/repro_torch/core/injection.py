"""Controlled fault injection — the paper's workfault generator (Sec. 4.2),
ported from the reference's `core/injection.py`.

  * `flip_bit` / `inject_tree`: replica-gated, step-gated exact bit flip in
    a chosen leaf (flatten order, as in the reference).
  * `make_kernel_fault`: bit flips in a protected kernel's output between
    compute and verify (the ABFT fault model, target='kernel').
  * `MemoryInjectionFlag`: the once-only flag, so the re-execution after a
    recovery does not re-inject.

The firing decision is made on the host from the engine's step, the replica
id and the armed flag; no device value is read. A spec that does not fire
leaves the tree untouched (same tensor objects), so the clean path is
bit-identical to a run without a spec — the counterpart of the reference's
`lax.cond`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import tree as tree_util

DTYPE_BITS = {"float32": 32, "int32": 32, "uint32": 32,
              "bfloat16": 16, "float16": 16}


@dataclass(frozen=True)
class InjectionSpec:
    """Static description of one injection experiment (same fields and
    meaning as the reference's; see its docstring)."""
    leaf_idx: int
    flat_idx: int
    bit: int
    step: int
    replica: int = 1
    target: str = "grads"
    n_elems: int = 1
    dtype: str = ""
    persistent: bool = False

    def __post_init__(self):
        if not 0 <= self.bit < 32:
            raise ValueError(f"bit {self.bit} outside any supported dtype "
                             f"(must be in [0, 32))")
        if self.dtype:
            width = DTYPE_BITS.get(self.dtype)
            if width is None:
                raise ValueError(f"unknown injection dtype {self.dtype!r}")
            if self.bit >= width:
                raise ValueError(
                    f"bit {self.bit} out of range for {self.dtype} "
                    f"(must be in [0, {width}))")
        if self.n_elems < 1:
            raise ValueError(f"n_elems must be >= 1, got {self.n_elems}")


def _signed(mask: int, bits: int) -> int:
    """Bit mask as the signed integer of its width (for XOR on intN)."""
    return mask - (1 << bits) if mask >= 1 << (bits - 1) else mask


def flip_bit(x: torch.Tensor, flat_idx: int, bit: int) -> torch.Tensor:
    """Copy of `x` with one bit of one element flipped (exact,
    dtype-preserving). `bit` is validated against the dtype's width."""
    dt = x.dtype
    nbits = 16 if dt in (torch.bfloat16, torch.float16) else 32
    if not 0 <= bit < nbits:
        raise ValueError(f"bit {bit} out of range for {dt} "
                         f"(must be in [0, {nbits}))")
    if dt in (torch.float32, torch.int32, torch.uint32):
        carrier = torch.int32
    elif dt == torch.bfloat16:
        carrier = torch.int16
    else:
        raise TypeError(f"injection unsupported for {dt}")
    out = x.clone()
    words = out.view(carrier).reshape(-1)
    words[flat_idx] ^= _signed(1 << bit, nbits)
    return out


def spec_step_hit(spec: InjectionSpec, step: int) -> bool:
    """Step gate: exact hit for transients, `>=` for persistent (stuck-bit)
    faults that re-manifest on every later execution."""
    return step >= spec.step if spec.persistent else step == spec.step


def make_kernel_fault(spec: InjectionSpec, *, step: int, armed: bool):
    """In-kernel corruption (target='kernel'): returns fn(out) -> out' that
    flips `spec.bit` in `spec.n_elems` elements of a protected kernel's
    output, between compute and verify. Elements are spread one row AND one
    column apart (flat stride width+1, wrapping at the size), so
    n_elems >= 2 violates >= 2 row and >= 2 column residuals. The firing
    decision is made on the host (armed and the step gate; no replica
    gate); a fault that does not fire returns `out` itself."""
    if spec.target != "kernel":
        raise ValueError(f"make_kernel_fault needs target='kernel', "
                         f"got {spec.target!r}")
    fire = bool(armed) and spec_step_hit(spec, int(step))

    def apply(out: torch.Tensor) -> torch.Tensor:
        if not fire:
            return out
        flat = out.reshape(-1)
        stride = out.shape[-1] + 1
        for e in range(spec.n_elems):
            flat = flip_bit(flat, (spec.flat_idx + e * stride) % flat.numel(),
                            spec.bit)
        return flat.reshape(out.shape)

    return apply


def inject_tree(tree, spec: Optional[InjectionSpec], *, step: int,
                replica_id: int, armed: bool = True):
    """Corrupt `tree` when the spec fires at (step, replica_id, armed);
    otherwise return `tree` itself. On firing, only the target leaf is
    copied (and the dicts on its path)."""
    if spec is None:
        return tree
    fire = bool(armed) and spec_step_hit(spec, step) and \
        int(replica_id) == spec.replica
    if not fire:
        return tree
    target = tree_util.leaves(tree)[spec.leaf_idx]
    return tree_util.replace_leaf(tree, spec.leaf_idx,
                                  flip_bit(target, spec.flat_idx, spec.bit))


class MemoryInjectionFlag:
    """In-memory once-only flag (the paper's injected.txt for workloads
    without a workdir): a transient fault does not repeat, so the retry
    after a detection must not re-inject."""

    def __init__(self):
        self._injected = False

    def already_injected(self) -> bool:
        return self._injected

    def mark(self) -> None:
        self._injected = True

    def reset(self) -> None:
        self._injected = False

    def arm_spec(self, spec: Optional[InjectionSpec]) -> Optional[InjectionSpec]:
        if spec is None or self._injected:
            return None
        return spec
