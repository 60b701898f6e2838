"""SEDAR recovery strategies, the part the serving slices run (the
reference's `core/recovery.py`): L1 `SafeStop`, the L0 re-execution policy
`RetryRecovery` and the per-request `SlotRecovery` of continuous serving.
The checkpoint levels L2/L3 and their stores come with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core import hostsync
from repro_torch.core.detection import DetectionEvent


@dataclass
class RecoveryAction:
    kind: str                      # stop | retry | restore | restart_scratch
    step: Optional[int] = None     # checkpoint version to restore
    rollbacks: int = 0             # counter value after this detection
    event: Optional[DetectionEvent] = None


class SafeStop:
    """L1: detection with notification, then a safe stop; never deliver
    defective results (paper Sec. 3.1)."""

    level = 1

    def __init__(self, notify: Optional[Callable[[DetectionEvent], None]] = None):
        self.notify = notify or (lambda e: print(str(e), flush=True))

    def on_detection(self, event: DetectionEvent) -> RecoveryAction:
        self.notify(event)
        return RecoveryAction(kind="stop", event=event)


class RetryRecovery:
    """Pure re-execution for workloads whose step is cheap to redo (the
    serving decode step). Every detection yields `retry`; `rollbacks`
    carries the CONSECUTIVE retry count. A committed step resets it
    (`note_success`, called by the engine), so only `max_retries`
    consecutive failures — a persistent divergence — degrade to the L1 safe
    stop."""

    level = 0

    def __init__(self, max_retries: int = 8):
        self.max_retries = max_retries
        self._consecutive = 0

    def reset(self) -> None:
        self._consecutive = 0

    def note_success(self) -> None:
        self._consecutive = 0

    def on_detection(self, event: DetectionEvent) -> RecoveryAction:
        self._consecutive += 1
        if self.max_retries and self._consecutive > self.max_retries:
            return RecoveryAction(kind="stop", rollbacks=self._consecutive,
                                  event=event)
        return RecoveryAction(kind="retry", rollbacks=self._consecutive,
                              event=event)


class SlotRecovery:
    """Per-REQUEST recovery for continuous-batching serving: the paper's
    levels re-scoped from "the run" to "the sequence slot".

      * commit-gated slot mismatch (partial commit): the faulty slots kept
        their pre-step image, so the action is a per-slot L0 retry — the
        next protected step re-decodes exactly those slots.
      * deferred-window slot fault (`boundary='deferred'`): the corruption
        was committed optimistically up to D steps ago. The action restores
        ONLY the affected slots from the Tier-0 `SlotRing`, each to its
        newest snapshot at or before its first bad step.
      * exhausted per-slot consecutive budget: the REQUEST is rejected (L1
        scoped to one sequence); the server drains `take_rejections()`.

    The server binds `merge(dual, slot, slice) -> dual` (writes one slot
    slice into every replica image) before serving; restores done here are
    reported through `take_restores()` so the server can truncate the
    affected requests' streams to the restored position."""

    level = 0

    def __init__(self, ring, max_retries: int = 8):
        self.ring = ring
        self.max_retries = max_retries
        self.merge: Optional[Callable[[Any, int, Any], Any]] = None
        self._consecutive: Dict[int, int] = {}
        self._pending_restores: Dict[int, Dict[str, int]] = {}
        self._pending_rejects: List[int] = []
        self.last_restore_info: Optional[dict] = None

    def reset(self) -> None:
        self._consecutive.clear()
        self._pending_restores.clear()
        self._pending_rejects.clear()
        self.ring.clear()

    def note_success(self) -> None:
        """A fully clean step committed: every slot's failure was transient."""
        self._consecutive.clear()

    def take_restores(self) -> Dict[int, Dict[str, int]]:
        out, self._pending_restores = self._pending_restores, {}
        return out

    def take_rejections(self) -> List[int]:
        out, self._pending_rejects = self._pending_rejects, []
        for slot in out:
            # the budget is per REQUEST: the slot's next tenant starts clean
            self._consecutive.pop(slot, None)
        return out

    def on_detection(self, event: DetectionEvent) -> RecoveryAction:
        slots = [int(s) for s in event.detail.get("slots", [])]
        for s in slots:
            self._consecutive[s] = self._consecutive.get(s, 0) + 1
        self._pending_rejects.extend(
            s for s in slots
            if self.max_retries and self._consecutive[s] > self.max_retries)
        worst = max((self._consecutive[s] for s in slots), default=1)
        if event.boundary == "deferred":
            return RecoveryAction(kind="slot_restore", step=event.step,
                                  rollbacks=worst, event=event)
        # commit/toe/validate: the faulty slots are pre-step (partial
        # commit) or nothing committed — re-execution recovers
        return RecoveryAction(kind="retry", rollbacks=worst, event=event)

    def restore(self, action: RecoveryAction, dual):
        """Merge each faulty slot's newest snapshot at or before its first
        bad step into the state; one counted `slot_restore` read of each
        restored position. A slot without such a snapshot is rejected."""
        if self.merge is None:
            raise RuntimeError("SlotRecovery.merge not bound by the server")
        ev = action.event
        first_bad = ev.detail.get("slot_first_bad", {})
        rejected = set(self._pending_rejects)
        restored: Dict[int, Dict[str, int]] = {}
        for slot in [int(s) for s in ev.detail.get("slots", [])]:
            if slot in rejected:
                continue   # the server evicts it
            bound = int(first_bad.get(slot, ev.step))
            try:
                version, sl = self.ring.restore(slot, max_step=bound)
            except KeyError:
                self._pending_rejects.append(slot)
                continue
            dual = self.merge(dual, slot, sl)
            restored[slot] = {
                "version": version,
                "pos": hostsync.read_int(sl["pos"], label="slot_restore")}
        self._pending_restores.update(restored)
        self.last_restore_info = {"tier": "device", "slots": restored}
        return dual
