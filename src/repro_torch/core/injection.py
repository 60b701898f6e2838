"""Controlled fault injection — the paper's workfault generator (Sec. 4.2),
ported from the reference's `core/injection.py`.

  * `flip_bit` / `inject_tree`: replica-gated, step-gated exact bit flip in
    a chosen leaf (flatten order, as in the reference).
  * `make_kernel_fault`: bit flips in a protected kernel's output between
    compute and verify (the ABFT fault model, target='kernel'; the packed
    admission prefill's checksum window is the distinct target
    'prefill_kernel', so a campaign aimed at one stage never fires, and is
    never disarmed, in the other).
  * `inject_row`: a flip in one row of an (N, V) logits block — one
    sequence slot of continuous serving's decode (target='slot') or one
    row of a packed admission prefill (target='prefill');
    `inject_row_halves` does it on a block that stacks both replicas'
    rows (the fused backend).
  * `InjectionFlag` (the paper's injected.txt, a file in the trainer's
    workdir, outside every checkpoint, so neither a rollback nor a restart
    re-injects) and `MemoryInjectionFlag` (the same once-only flag in
    memory, for serving): the re-execution after a recovery does not
    re-inject.

The trainer fires `inject_tree` on the gradients (target 'grads'), the
updated params ('params') or the updated optimizer state ('opt_state').

The firing decision is made on the host from the engine's step, the replica
id and the armed flag; no device value is read. A spec that does not fire
leaves the tree untouched (same tensor objects), so the clean path is
bit-identical to a run without a spec — the counterpart of the reference's
`lax.cond`.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
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
    # an in-place op with a scalar operand: no host->device copy
    words[flat_idx:flat_idx + 1].bitwise_xor_(_signed(1 << bit, nbits))
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


def inject_row(block: torch.Tensor, spec: Optional[InjectionSpec], *,
               target: str, tick: int, replica_id: int,
               armed: bool) -> torch.Tensor:
    """Row-localized SDC for the 'slot' and 'prefill' targets: flip
    `spec.bit` of element `spec.flat_idx % V` of row `spec.leaf_idx` of the
    (N, V) block when a spec of `target` fires at (tick, replica_id, armed);
    otherwise (or when the block has no such row: a pack too small to hold
    it) return `block` itself. The decision is made on the host from the
    host-int tick."""
    if spec is None or spec.target != target:
        return block
    n, v = block.shape
    fire = (bool(armed) and spec_step_hit(spec, int(tick))
            and int(replica_id) == spec.replica and spec.leaf_idx < n)
    if not fire:
        return block
    return flip_bit(block, spec.leaf_idx * v + spec.flat_idx % v, spec.bit)


def inject_row_halves(block: torch.Tensor, spec: Optional[InjectionSpec], *,
                      target: str, tick: int, armed: bool) -> torch.Tensor:
    """`inject_row` on a (2N, V) block whose rows [0, N) are replica 0's and
    [N, 2N) replica 1's: each half gets its own replica's decision. Returns
    `block` itself when neither fires."""
    n = block.shape[0] // 2
    halves = (block[:n], block[n:])
    out = [inject_row(h, spec, target=target, tick=tick, replica_id=r,
                      armed=armed) for r, h in enumerate(halves)]
    if all(o is h for o, h in zip(out, halves)):
        return block
    return torch.cat(out)


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


class InjectionFlag:
    """The paper's ``injected.txt``: an external once-only flag file, so
    recovery re-executions do not re-inject (it lives OUTSIDE the
    checkpoint and survives rollbacks, paper Sec. 4.2). Same file format as
    the reference's."""

    def __init__(self, path: str):
        self.path = path
        if not os.path.exists(path):
            self._write(0)

    def _write(self, v: int) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            json.dump({"injected": v}, f)

    def already_injected(self) -> bool:
        with open(self.path) as f:
            return json.load(f)["injected"] > 0

    def mark(self) -> None:
        self._write(1)

    def arm_spec(self, spec: Optional[InjectionSpec]) -> Optional[InjectionSpec]:
        """spec if not yet injected, else None (the paper's "function
        returns without making a new injection")."""
        if spec is None or self.already_injected():
            return None
        return spec


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


# ---------------------------------------------------------------------------
# Random single-bit faults for campaigns: the reference's `random_spec`,
# which draws with `jax.random` (threefry2x32 with the partitionable
# split and bits, JAX's default), in numpy on the host
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key, count):
    """The Threefry-2x32 block cipher (20 rounds) of one 64-bit count
    (hi, lo) under key (k0, k1) -> two uint32 words, as `jax.random`'s."""
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (int(count[0]) + ks[0]) & _M32, (int(count[1]) + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int):
    """`jax.random.PRNGKey(seed)`'s two words for a seed in [0, 2**64)."""
    return ((seed >> 32) & _M32, seed & _M32)


def prng_split(key, num: int = 2):
    """`jax.random.split(key, num)`: key i is the cipher of count i."""
    return [threefry2x32(key, (0, i)) for i in range(num)]


def _bits32(key) -> int:
    """`jax.random.bits(key, (), uint32)`: the two words of count 0,
    XORed."""
    a, b = threefry2x32(key, (0, 0))
    return a ^ b


def _uniform32(key) -> np.float32:
    """`jax.random.uniform(key, (), float32)` in [0, 1)."""
    bits = np.uint32((_bits32(key) >> 9) | 0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def _randint32(key, minval: int, maxval: int) -> int:
    """`jax.random.randint(key, (), minval, maxval)` (int32): two words
    folded into [minval, maxval) by the reference's multiplier rule."""
    k1, k2 = prng_split(key)
    hi, lo = _bits32(k1), _bits32(k2)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = (((2 ** 16 % span) ** 2) & _M32) % span     # uint32 products
    off = (((hi % span) * mult) & _M32) + (lo % span)
    return minval + (off & _M32) % span


def _choice_p(key, p: np.ndarray) -> int:
    """`jax.random.choice(key, len(p), p=p)` (with replacement): the
    first index whose f32 running sum reaches total * (1 - u)."""
    cum = np.cumsum(p.astype(np.float32), dtype=np.float32)
    r = cum[-1] * (np.float32(1.0) - _uniform32(key))
    return int(np.searchsorted(cum, np.float32(r), side="left"))


def random_spec(key, tree, *, step: int, replica: int = 1,
                target: str = "grads") -> InjectionSpec:
    """A uniformly random single-bit fault over a tree (for campaigns):
    the reference's choice for the same key (`prng_key(seed)`, or the two
    words of a `jax.random.PRNGKey`). A leaf is drawn with probability by
    its size, then an element and a bit of its width (16 for bf16, else
    32). The leaves are read for their shapes and dtypes only."""
    leaves = tree_util.leaves(tree)
    sizes = np.array([int(np.prod(tuple(t.shape))) for t in leaves],
                     np.int64)
    k1, k2, k3 = prng_split(key, 3)
    leaf = _choice_p(k1, sizes / sizes.sum())
    idx = _randint32(k2, 0, int(sizes[leaf]))
    nbits = 16 if leaves[leaf].dtype == torch.bfloat16 else 32
    bit = _randint32(k3, 0, nbits)
    return InjectionSpec(leaf_idx=leaf, flat_idx=idx, bit=bit, step=step,
                         replica=replica, target=target)
