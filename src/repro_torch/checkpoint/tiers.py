"""Tier-0 keyed snapshot ring of continuous-batching serving (the `SlotRing`
of the reference's `checkpoint/tiers.py`). The device, host, disk and
partner rings and the tier planner come with the training slice.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as tree_util


def _clone(state):
    return tree_util.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)


class SlotRing:
    """One bounded version ring PER SEQUENCE SLOT, holding that slot's
    {cache slice, token, position} image on the device.

    Saves and restores are device-side copies: no disk, no host read. The
    ring stores CLONES and hands out clones: the serving KV cache is written
    in place, so a stored view would silently change with the next decode
    step. Versions are decode ticks; `restore(slot, max_step=k)` returns
    the newest snapshot at or below `k`. `evict` drops a finished or
    rejected request's history so the ring never resurrects state across
    requests sharing a slot."""

    name = "device"

    def __init__(self, slots_per_key: int = 4):
        self.slots_per_key = max(int(slots_per_key), 1)
        self._rings: Dict[int, List[Tuple[int, Any]]] = {}
        self.saves = 0
        self.restores = 0

    def save(self, key: int, step: int, state_slice) -> None:
        """Store a clone of `state_slice` as version `step` of `key`; the
        oldest version leaves once the key holds `slots_per_key`."""
        ring = [e for e in self._rings.get(int(key), []) if e[0] != step]
        ring.append((int(step), _clone(state_slice)))
        ring.sort(key=lambda e: e[0])
        self._rings[int(key)] = ring[-self.slots_per_key:]
        self.saves += 1

    def save_many(self, step: int, slices: Dict[int, Any]) -> None:
        """Snapshots of several keys at one shared version (a prefill pack's
        admitted rows, or every running slot at a clean flush edge)."""
        for key, sl in slices.items():
            self.save(key, step, sl)

    def versions(self, key: int) -> List[int]:
        return [s for s, _ in self._rings.get(int(key), [])]

    def restore(self, key: int, max_step: Optional[int] = None
                ) -> Tuple[int, Any]:
        """Newest version at or below `max_step` for `key` -> (version, a
        clone of its slice). KeyError when nothing qualifies."""
        ring = self._rings.get(int(key))
        if ring is None:
            raise KeyError(f"no snapshots for slot {key}")
        cands = [e for e in ring if max_step is None or e[0] <= max_step]
        if not cands:
            raise KeyError(f"no slot-{key} snapshot at or below {max_step}")
        version, payload = cands[-1]
        self.restores += 1
        return version, _clone(payload)

    def nbytes(self) -> int:
        """Device bytes the stored snapshots hold."""
        return sum(x.numel() * x.element_size()
                   for ring in self._rings.values() for _, sl in ring
                   for x in tree_util.leaves(sl)
                   if isinstance(x, torch.Tensor))

    def evict(self, key: int) -> None:
        self._rings.pop(int(key), None)

    def clear(self) -> None:
        self._rings.clear()
