"""Delta checkpoints (the reference's `checkpoint/delta.py`): per-leaf digest
dedup against the previous version.

An L2 chain re-serializes the full dual state every interval even when a
step touched only part of it. `DeltaCheckpointStore` compares each leaf's
digest with the newest prior version at save time: changed leaves are
written as usual, unchanged ones become manifest references
(`leaf_refs[str(i)] = base_step`), always resolved to the ROOT holder, so
a restore is one hop per leaf and never a chain walk. Restore digest-checks
every leaf against THIS version's manifest. GC never strands a reference:
`gc_keep_last` / `delete_others_than` keep every step a surviving manifest
references.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.checkpoint.store import (CheckpointStore, Manifest,
                                          _fingerprint_json, _gc_keep_set,
                                          _leaf_digest, snapshot)


class DeltaCheckpointStore(CheckpointStore):
    """Drop-in `CheckpointStore` whose versions share unchanged leaves."""

    def __init__(self, directory: str, compress: bool = False):
        super().__init__(directory, compress=compress)
        # (step, digests, refs) of the newest version this process saved;
        # saves come from one calling thread, so a plain attribute is enough
        self._last: Optional[Tuple[int, List[List[int]], Dict[str, int]]] = None

    def _base_for(self, step: int):
        """Newest version strictly older than `step` to delta against, as
        (base_step, base_digests, base_refs); None -> full checkpoint."""
        if self._last is not None and self._last[0] < step:
            return self._last
        prior = [s for s in self.steps() if s < step]
        if not prior:
            return None
        man = self.manifest(prior[-1])
        if man.leaf_digests is None:
            return None
        return prior[-1], man.leaf_digests, man.leaf_refs or {}

    def save(self, step: int, state, *, kind: str = "system",
             valid: Optional[bool] = None, fingerprint=None,
             async_: bool = False, extra: Optional[dict] = None,
             compress: Optional[bool] = None, snap=None) -> None:
        host, digests = snap if snap is not None else snapshot(state)
        # the delta plan needs the digests before the write is enqueued
        if digests is None:
            digests = [_leaf_digest(a) for a in host]
        refs: Dict[str, int] = {}
        base = self._base_for(step)
        if base is not None:
            base_step, base_digests, base_refs = base
            for i, d in enumerate(digests):
                if i < len(base_digests) and d == base_digests[i]:
                    refs[str(i)] = int(base_refs.get(str(i), base_step))
        man = Manifest(step=step, kind=kind, valid=valid,
                       fingerprint=_fingerprint_json(fingerprint),
                       n_leaves=len(host), extra=extra or {},
                       leaf_digests=digests, leaf_refs=refs or None)
        self._last = (step, digests, refs)
        self._enqueue(step, host, man,
                      self.compress if compress is None else bool(compress),
                      async_)

    def delete(self, step: int) -> None:
        """Deleting the cached base invalidates the cache, or the next save
        would reference a version that no longer exists."""
        super().delete(step)
        if self._last is not None and self._last[0] == step:
            self._last = None

    def _bases_of(self, keep: set) -> set:
        """Every step physically holding a leaf some kept version refs."""
        out = set()
        for s in keep:
            try:
                man = self.manifest(s)
            except FileNotFoundError:
                continue
            for ref in (man.leaf_refs or {}).values():
                out.add(int(ref))
        return out

    def delete_others_than(self, keep_step: int) -> None:
        keep = {keep_step} | self._bases_of({keep_step})
        for s in self.steps():
            if s not in keep:
                self.delete(s)

    def gc_keep_last(self, n: int, keep_floor: Optional[int] = None) -> None:
        if n <= 0:
            return
        steps = self.steps()
        keep = _gc_keep_set(steps, n, keep_floor)
        keep |= self._bases_of(keep)
        for s in steps:
            if s not in keep:
                self.delete(s)
