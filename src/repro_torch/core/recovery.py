"""SEDAR recovery strategies (the reference's `core/recovery.py`, paper
Secs. 3.1-3.3, Algorithms 1 and 2):

  L1  SafeStop                    detection + notification + safe stop
  L2  MultiCheckpointRecovery     chain of system-level checkpoints, rolled
                                  back until the fault stops re-manifesting
                                  (Alg. 1)
  L3  ValidatedCheckpointRecovery one replica-validated application-level
                                  checkpoint, at most one rollback (Alg. 2)

plus the L0 re-execution policy `RetryRecovery` and the per-request
`SlotRecovery` of continuous serving.

System-level (L2) checkpoints hold the FULL dual state (both replicas), so
a checkpoint cut after a silent corruption still holds the replicas'
divergence and the fault re-manifests after a restore (the paper's "dirty
checkpoint"). Application-level (L3) checkpoints hold ONE replica's state,
committed only after the replicas' state fingerprints were proven equal.
The rollback counter lives OUTSIDE the checkpoints (`rollbacks.json`, the
paper's failures.txt), so it survives restores.

With `tiers` (a `checkpoint.tiers.TieredCheckpointer`, `ckpt_tiers` other
than "disk") L2 and L3 save into the device/host/disk/partner hierarchy and
restore through its cost-aware planner; where the state came from (tier,
version, fallbacks) is `last_restore_info`, which the engine merges into
its recovery record.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.delta import DeltaCheckpointStore
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.checkpoint.tiers import TieredCheckpointer, make_tiered
from repro_torch.core import hostsync
from repro_torch.core.detection import DetectionEvent


class ExternalCounter:
    """paper Sec. 4.2: failures.txt, kept outside the checkpoint storage."""

    def __init__(self, path: str):
        self.path = path
        if not os.path.exists(path):
            self._write(0)

    def _write(self, v: int) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            json.dump({"count": v}, f)

    def value(self) -> int:
        with open(self.path) as f:
            return json.load(f)["count"]

    def increment(self) -> int:
        v = self.value() + 1
        self._write(v)
        return v

    def reset(self) -> None:
        self._write(0)


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


class MultiCheckpointRecovery:
    """Recovery from a chain of system-level checkpoints (paper Alg. 1):

        extern_counter++                      # on each detection
        ckpt_no = ckpt_count - extern_counter # 1-based from the end
        restore(ckpt_no)                      # or restart from scratch

    The chain is never pruned (any checkpoint may be dirty) unless the
    bounded mode `max_checkpoints` is asked for.

    With `tiers` the chain spans the whole hierarchy: the device/host rings
    hold dense recent versions, the disk/partner stores the sparse durable
    ones. Alg. 1's counter then walks the UNION of versions at or below the
    detected fault's step, newest first, and each restore goes through the
    planner (the cheapest tier holding the version, with corruption
    fallback)."""

    level = 2

    def __init__(self, store: CheckpointStore, counter_path: str,
                 checkpoint_interval: int, max_checkpoints: int = 0,
                 async_: bool = True,
                 tiers: Optional[TieredCheckpointer] = None):
        self.store = store
        self.counter = ExternalCounter(counter_path)
        self.interval = checkpoint_interval
        self.max_checkpoints = max_checkpoints
        self.async_ = async_
        self.tiers = tiers
        # where the last restore came from; the engine merges it into its
        # recovery record
        self.last_restore_info: Optional[dict] = None

    # -- cadence hooks (the engine gates its fingerprint reads on them) ------

    def due(self, step: int) -> bool:
        if self.tiers is not None:
            return self.tiers.due(step)
        return self.interval > 0 and step % self.interval == 0

    def fp_needed(self, step: int) -> bool:
        """Whether this save needs the state fingerprint (a host read): only
        manifest-writing tiers record it, so a ring-only save stays free of
        host reads."""
        if self.tiers is not None:
            return self.tiers.fp_needed(step)
        return self.due(step)

    def sync_due(self, step: int) -> bool:
        """Whether a DURABLE tier is due at `step`: the engine flushes the
        deferred window first, so every host/disk/partner version predates
        every unvalidated step. Device-ring saves do not force a flush:
        their slots may hold unvalidated state, and the restore's bound at
        the faulty step keeps them out."""
        if self.tiers is not None:
            return self.tiers.sync_due(step)
        return self.due(step)

    def maybe_checkpoint(self, step: int, dual_state, fingerprints=None,
                         validated_floor: Optional[int] = None) -> bool:
        """Cut a system-level checkpoint right after a validated commit
        (paper: "the best moments to take them are when the communications
        have just been validated"). `validated_floor`, the engine's first
        unvalidated step, is the bounded chain's (and the rings')
        retention floor. Returns whether a DURABLE version was cut (what
        the engine records as a checkpoint)."""
        if step == 0 or not self.due(step):
            return False
        if self.tiers is not None:
            saved = self.tiers.save(step, dual_state,
                                    fingerprint=fingerprints, kind="system",
                                    async_=self.async_,
                                    keep_floor=validated_floor)
            # GC only when a durable store grew: gc_keep_last waits for the
            # writer and lists the directory
            if self.max_checkpoints and \
                    any(t in ("disk", "partner") for t in saved):
                self.tiers.gc_keep_last(self.max_checkpoints,
                                        keep_floor=validated_floor)
            return any(t != "device" for t in saved)
        self.store.save(step, dual_state, kind="system", valid=None,
                        fingerprint=fingerprints, async_=self.async_)
        if self.max_checkpoints:
            self.store.gc_keep_last(self.max_checkpoints,
                                    keep_floor=validated_floor)
        return True

    def on_detection(self, event: DetectionEvent) -> RecoveryAction:
        """Alg. 1 against its 1-based pseudo-code: extern_counter (>= 1,
        incremented first) gives ckpt_no = ckpt_count - extern_counter + 1,
        i.e. the 0-based steps[ckpt_count - counter]; ckpt_no < 1 relaunches
        from the beginning. The first detection restores the NEWEST
        checkpoint (possibly dirty), each re-detection one further back.
        `store.steps()` waits for pending async writes, so ckpt_count is
        exact right after a checkpoint boundary. A tiered chain is bounded
        at the event's faulty step: the rings snapshot optimistically inside
        the deferred window, so versions newer than the fault exist and are
        corrupt by construction."""
        rollbacks = self.counter.increment()
        if self.tiers is not None:
            steps = [v for v in self.tiers.versions()
                     if event.step is None or v <= event.step]
        else:
            steps = self.store.steps()
        idx = len(steps) - rollbacks
        if idx < 0:
            # the fault predates every checkpoint (paper Fig. 2a)
            return RecoveryAction(kind="restart_scratch", rollbacks=rollbacks,
                                  event=event)
        return RecoveryAction(kind="restore", step=steps[idx],
                              rollbacks=rollbacks, event=event)

    def restore(self, action: RecoveryAction, template):
        if self.tiers is not None:
            # a durability barrier even when a ring serves the state: a
            # replay must never re-cut a version whose first async write is
            # still in flight
            self.tiers.wait()
            state, info = self.tiers.restore(action.step, template)
            self.last_restore_info = info
            return state
        self.last_restore_info = {"tier": "disk", "version": action.step}
        return self.store.restore(action.step, template)


class ValidatedCheckpointRecovery:
    """One safe application-level checkpoint (paper Alg. 2). At each
    boundary the replicas' state fingerprints are compared: equal -> the
    checkpoint is VALID, committed, and the previous one deleted (exactly
    one valid checkpoint exists); different -> nothing is stored and
    recovery rolls back, at most once, to the previous valid one.

    With `tiers` the validated state goes into EVERY enabled tier at the
    boundary, and "exactly one valid checkpoint" holds PER TIER
    (`keep_only`): a restore comes from the cheapest tier (normally the
    device ring: no disk read), the partner store being the corruption
    fallback of last resort."""

    level = 3

    def __init__(self, store: CheckpointStore, checkpoint_interval: int,
                 async_: bool = False,
                 tiers: Optional[TieredCheckpointer] = None):
        # synchronous by default: the previous version is deleted only
        # after the new one is durable
        self.store = store
        self.interval = checkpoint_interval
        self.async_ = async_
        self.tiers = tiers
        self.last_restore_info: Optional[dict] = None

    def maybe_checkpoint(self, step: int, dual_state, fingerprints=None,
                         fp_equal: Optional[bool] = None
                         ) -> Optional[DetectionEvent]:
        """None if no boundary or the checkpoint was committed; a
        DetectionEvent if its validation FAILED (paper Alg. 2 line 16).
        `dual_state` carries replica 0's state under 'r0'; only r0 is
        stored (provably equal to r1 when `fp_equal`)."""
        if step == 0 or step % self.interval != 0:
            return None
        if fp_equal is None:
            raise ValueError("L3 checkpointing requires the replica "
                             "state-fingerprint comparison")
        if not bool(fp_equal):
            return DetectionEvent(step=step, boundary="ckpt_validate",
                                  effect="FSC",
                                  detail={"reason": "app-level checkpoint "
                                          "hash mismatch (corrupted)"})
        if self.tiers is not None:
            # into every tier synchronously (each tier's previous version
            # goes only once the new one is durable everywhere), then one
            # valid version per tier
            self.tiers.save(step, dual_state["r0"], kind="app", valid=True,
                            fingerprint=fingerprints, async_=False,
                            force=True)
            self.tiers.wait()
            self.tiers.keep_only(step)
            return None
        prev = self.store.latest(valid_only=True)
        self.store.save(step, dual_state["r0"], kind="app", valid=True,
                        fingerprint=fingerprints, async_=self.async_)
        self.store.wait()
        if prev is not None and prev != step:
            self.store.delete(prev)   # "the previous can be discarded"
        return None

    def on_detection(self, event: DetectionEvent) -> RecoveryAction:
        target = self.tiers.latest_valid() if self.tiers is not None \
            else self.store.latest(valid_only=True)
        if target is None:
            return RecoveryAction(kind="restart_scratch", rollbacks=1,
                                  event=event)
        return RecoveryAction(kind="restore", step=target, rollbacks=1,
                              event=event)

    def restore(self, action: RecoveryAction, template_single):
        """The single validated state; the engine seeds every replica from
        it (valid by construction)."""
        if self.tiers is not None:
            state, info = self.tiers.restore(action.step, template_single)
            self.last_restore_info = info
            return state
        self.last_restore_info = {"tier": "disk", "version": action.step}
        return self.store.restore(action.step, template_single)


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


def make_recovery(sedar_cfg, workdir: Optional[str] = None,
                  notify: Optional[Callable[[dict], None]] = None):
    """The recovery policy of a SedarConfig: L1 SafeStop, or L2/L3 over the
    disk store under `<workdir or checkpoint_dir>/checkpoints`
    (`ckpt_delta` with level 2: the delta store; `ckpt_compress`:
    compressed leaves). A `ckpt_tiers` beyond the flat "disk" routes L2/L3
    through a `TieredCheckpointer` (`checkpoint/tiers.py::make_tiered`;
    `notify` receives its tier-fallback events)."""
    d = workdir or sedar_cfg.checkpoint_dir
    if sedar_cfg.level <= 1:
        return SafeStop()
    delta = bool(sedar_cfg.ckpt_delta) and sedar_cfg.level == 2
    store_cls = DeltaCheckpointStore if delta else CheckpointStore
    store = store_cls(os.path.join(d, "checkpoints"),
                      compress=bool(sedar_cfg.ckpt_compress))
    tiers = make_tiered(sedar_cfg, d, disk_store=store, notify=notify)
    if sedar_cfg.level == 2:
        return MultiCheckpointRecovery(
            store, os.path.join(d, "rollbacks.json"),
            sedar_cfg.checkpoint_interval, sedar_cfg.max_checkpoints,
            async_=sedar_cfg.async_checkpoint, tiers=tiers)
    return ValidatedCheckpointRecovery(store, sedar_cfg.checkpoint_interval,
                                       tiers=tiers)
