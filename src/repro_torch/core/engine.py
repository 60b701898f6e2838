"""The SEDAR engine, lag-1 part (the reference's `core/engine.py`):

    SedarEngine = ReplicaExecutor        (how redundant copies execute)
                × BoundarySchedule       (when boundaries fire)
                × recovery policy        (L0 retry / L1 stop)
                × injection              (fault campaigns)

Workloads provide `step_fn(state, batch, replica_id, armed) -> (candidate,
fingerprint, aux)` and call `run_protected_step()` per step and
`on_detection()` per event.

Ported backends: `PlainExecutor` (no redundancy), `SequentialExecutor`
(time redundancy: both replicas run back to back on the same card, each
owning a full state image, with the TOE watchdog timing) and, in
`abft/executor.py`, the replica-free `AbftExecutor` ("abft"/"hybrid"),
whose `repair()` commits a checksum-corrected step forward before the
recovery policy is asked. Every commit
compare is read back at once (validation lag 1): under `RetryRecovery` the
reference clamps the lag to 1 as well, because a retry can only rewind the
current step. The deferred ring, the checkpoint boundaries and the L2/L3
recoveries come with later slices.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.core import hostsync
from repro_torch.core.detection import (DetectionEvent, SedarSafeStop,
                                        Watchdog)
from repro_torch.core.fingerprint import (fingerprints_equal, mismatch_report,
                                          pytree_fingerprint)
from repro_torch.core.recovery import RecoveryAction


@dataclass(frozen=True)
class BoundarySchedule:
    """When each SEDAR boundary fires (cadences in steps; 0 = never).

    commit_interval   -- TDC boundary: replica fingerprint compare before the
                         commit (paper: validate-before-send).
    validate_interval -- FSC boundary: full-state fingerprint compare.
    toe_timeout_s     -- replica flow-separation lapse (TOE boundary).
    """

    commit_interval: int = 1
    validate_interval: int = 0
    toe_timeout_s: float = 120.0

    @classmethod
    def from_config(cls, sedar) -> "BoundarySchedule":
        return cls(commit_interval=max(int(sedar.validate_interval), 1),
                   validate_interval=int(sedar.param_validate_interval),
                   toe_timeout_s=float(sedar.toe_timeout_s))

    def commit_due(self, step: int) -> bool:
        return self.commit_interval > 0 and step % self.commit_interval == 0

    def validate_due(self, step: int) -> bool:
        return (self.validate_interval > 0 and step > 0
                and step % self.validate_interval == 0)


@dataclass
class StepOutcome:
    """Result of one protected step. `dual` is ALWAYS the state to continue
    from: the pre-step state when the commit was gated by a detection, the
    committed state otherwise."""

    dual: Any
    aux: Any = None
    event: Optional[DetectionEvent] = None


def _localize(c0, c1) -> List[Dict[str, Any]]:
    """Leaf-level localization of a commit mismatch: per-leaf fingerprints
    of the two candidates (off the hot path)."""
    fa, fb = pytree_fingerprint(c0), pytree_fingerprint(c1)
    return mismatch_report(c0, fa, fb)[:4]


def _clone_state(state):
    return tree_util.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)


class ReplicaExecutor:
    """Protocol for redundant-execution backends.

    execute(dual, batch, step, armed, compare) -> (dual', aux, event | None);
        dual' is the pre-step state when event is not None.
    validate(dual, step)   -> DetectionEvent | None  (FSC boundary)
    init_dual(single)      -> dual state from one logical state
    peek(dual, key)        -> replica 0's entry `key`
    repair(event, dual)    -> (dual', record) | None  (forward correction)
    """

    name = "base"
    n_replicas = 1

    @property
    def can_validate(self) -> bool:
        """Whether the ENGINE drives the periodic FSC boundary by calling
        `validate()` after commits (replica backends). Executors with their
        own periodic check (hybrid validates at step ENTRY) return False
        here and `can_validate_final` True."""
        return self.n_replicas > 1

    @property
    def can_validate_final(self) -> bool:
        """Whether `validate()` is meaningful for the end-of-run final
        comparison (paper Sec. 3.1)."""
        return self.can_validate

    def init_dual(self, single):
        return {"r0": single}

    def note_external_update(self) -> None:
        """Callers run this after mutating the resident state outside a
        protected step, so executors that keep state-derived baselines (the
        hybrid commit-time fingerprint) drop them."""

    def repair(self, event: DetectionEvent, dual):
        return None

    def peek(self, dual, key: str):
        return dual["r0"][key]

    def validate(self, dual, step: int) -> Optional[DetectionEvent]:
        return None


class PlainExecutor(ReplicaExecutor):
    """No redundancy: the unprotected baseline (replication='none')."""

    name = "none"

    def __init__(self, step_fn: Callable):
        self.step_fn = step_fn

    def execute(self, dual, batch, step: int, armed, compare: bool):
        cand, _fp, aux = self.step_fn(dual["r0"], batch, 0, armed)
        return {"r0": cand}, aux, None


class SequentialExecutor(ReplicaExecutor):
    """Time redundancy: replicas run back to back on the same card, each
    owning a FULL state image (the paper's per-thread memory image). The
    commit compare is ONE counted device read (`commit_compare`).
    `state_fp_fn` fingerprints a replica's state at the FSC boundary."""

    name = "sequential"
    n_replicas = 2

    def __init__(self, step_fn: Callable, state_fp_fn: Callable,
                 watchdog: Optional[Watchdog] = None,
                 toe_timeout_s: float = 120.0,
                 delay_source: Optional[Callable[[], dict]] = None):
        self.step_fn = step_fn
        self.state_fp_fn = state_fp_fn
        self.watchdog = watchdog
        self.toe_timeout_s = toe_timeout_s
        # scenario hook: {(step, replica): seconds} of one-shot delays
        self.delay_source = delay_source or (lambda: {})

    def init_dual(self, single):
        return {"r0": single, "r1": _clone_state(single)}

    def _launch(self, dual, batch, step: int, armed):
        """Both replicas, back to back. The per-replica wall time (the TOE
        lapse) needs a device sync after each replica, paid only when the
        boundary can fire: a scenario delay is pending or the watchdog was
        armed. Returns (outs, toe_event | None)."""
        delays = self.delay_source() or {}
        timed = bool(delays) or (self.watchdog is not None
                                 and self.watchdog.armed)
        outs, exec_t = {}, {}
        for rid in range(self.n_replicas):
            delay = delays.pop((step, rid), None)   # one-shot, as the paper
            t_r = time.monotonic()
            if delay:
                time.sleep(delay)
            outs[rid] = self.step_fn(dual[f"r{rid}"], batch, rid, armed)
            if timed:
                hostsync.read_scalar(outs[rid][1], label="toe_timing")
            exec_t[rid] = time.monotonic() - t_r
            if self.watchdog is not None:
                self.watchdog.beat(rid, step)
        if timed and abs(exec_t[1] - exec_t[0]) > self.toe_timeout_s:
            return outs, DetectionEvent(
                step=step, boundary="toe", effect="TOE",
                detail={"dt0": exec_t[0], "dt1": exec_t[1],
                        "timeout_s": self.toe_timeout_s})
        return outs, None

    def execute(self, dual, batch, step: int, armed, compare: bool):
        outs, toe = self._launch(dual, batch, step, armed)
        if toe is not None:
            return dual, outs[0][2], toe
        (c0, fp0, aux0), (c1, fp1, _aux1) = outs[0], outs[1]
        if compare and not hostsync.read_bool(fingerprints_equal(fp0, fp1),
                                              label="commit_compare"):
            return dual, aux0, DetectionEvent(
                step=step, boundary="commit", effect="TDC",
                detail={"mismatch": _localize(c0, c1)})
        return {"r0": c0, "r1": c1}, aux0, None

    def validate(self, dual, step: int) -> Optional[DetectionEvent]:
        if hostsync.read_bool(
                fingerprints_equal(self.state_fp_fn(dual["r0"]),
                                   self.state_fp_fn(dual["r1"])),
                label="state_validate"):
            return None
        return DetectionEvent(step=step, boundary="validate", effect="FSC")


class SedarEngine:
    """Composes executor × schedule × recovery × injection behind
    `run_protected_step()` + `on_detection()`. Owns the run's `detections`
    and `recoveries` records; call `reset()` at the start of each run."""

    def __init__(self, executor: ReplicaExecutor, schedule: BoundarySchedule,
                 recovery, *, inj_spec=None, inj_flag=None,
                 notify: Optional[Callable[[DetectionEvent], None]] = None):
        self.executor = executor
        self.schedule = schedule
        self.recovery = recovery
        self.inj_spec = inj_spec
        self.inj_flag = inj_flag
        self.notify = notify or (lambda e: print(str(e), flush=True))
        self.detections: List[DetectionEvent] = []
        self.recoveries: List[Dict[str, Any]] = []

    def reset(self) -> None:
        self.detections.clear()
        self.recoveries.clear()

    def run_protected_step(self, dual, batch, step: int) -> StepOutcome:
        """Execute one redundant step at `step`: inject (if armed) ->
        execute replicas -> TDC commit gate -> FSC validation boundary.
        Returns the state to continue from plus the detection event, if
        any (feed it to `on_detection`)."""
        armed = (self.inj_flag is not None
                 and self.inj_flag.arm_spec(self.inj_spec) is not None)
        compare = self.schedule.commit_due(step)
        dual2, aux, event = self.executor.execute(dual, batch, step, armed,
                                                  compare)
        self._mark_injected(step)
        if event is not None:
            return StepOutcome(dual=dual2, aux=aux, event=event)
        note = getattr(self.recovery, "note_success", None)
        if note is not None:
            note()   # the step committed: whatever failed before was transient
        if self.executor.can_validate and \
                self.schedule.validate_due(step + 1):
            event = self.executor.validate(dual2, step + 1)
        return StepOutcome(dual=dual2, aux=aux, event=event)

    def validate_final(self, dual, step: int) -> Optional[DetectionEvent]:
        """Final-results comparison (paper Sec. 3.1), tagged
        boundary='final'."""
        if not self.executor.can_validate_final:
            return None
        event = self.executor.validate(dual, step)
        if event is not None:
            event.boundary = "final"
        return event

    def on_detection(self, event: DetectionEvent, dual):
        """Record + notify + recover. Returns the state to continue from;
        raises SedarSafeStop when the policy is (or degrades to) L1."""
        self.detections.append(event)
        self.notify(event)
        fix = self.executor.repair(event, dual)
        if fix is not None:
            # forward correction (abft): commit the repaired candidate, no
            # rollback and no retry
            repaired, record = fix
            self.recoveries.append(dict(record, at=event.step))
            return repaired
        action: RecoveryAction = self.recovery.on_detection(event)
        self.recoveries.append({"kind": action.kind, "step": action.step,
                                "rollbacks": action.rollbacks,
                                "at": event.step})
        if action.kind == "stop":
            raise SedarSafeStop(event)
        if action.kind == "retry":
            return dual      # transient fault: re-execute the same step
        raise NotImplementedError(
            f"recovery action {action.kind!r} needs the checkpoint levels, "
            f"which are not ported yet")

    def _mark_injected(self, step: int) -> None:
        # persistent (stuck-bit) specs are never marked: recovery
        # re-executions MUST re-inject them
        if (self.inj_spec is not None and self.inj_flag is not None
                and not self.inj_spec.persistent
                and not self.inj_flag.already_injected()
                and step == self.inj_spec.step):
            self.inj_flag.mark()
