"""The SEDAR engine (the reference's `core/engine.py`):

    SedarEngine = ReplicaExecutor        (how redundant copies execute)
                × BoundarySchedule       (when boundaries fire)
                × recovery policy        (L0 retry / per-slot restore / L1
                                          stop / L2 chain / L3 validated)
                × injection              (fault campaigns)

Workloads provide `step_fn(state, batch, replica_id, armed) -> (candidate,
fingerprint, aux)` and call `run_protected_step()` per step and
`on_detection()` per event. A protected step runs the replicas, gates the
commit (TDC), validates the full state at the FSC cadence and then cuts
the L2/L3 checkpoint due at the new step, right after the validation
(paper Sec. 3.2: the smallest window of vulnerability).

Ported backends: `PlainExecutor` (no redundancy), `SequentialExecutor`
(time redundancy: both replicas run back to back on the same card, each
owning a full state image, with the TOE watchdog timing), its slot-granular
`SlottedSequentialExecutor` (continuous-batching serving: per-slot
fingerprints, localized mismatches, partial commit), the single-launch
`FusedSequentialExecutor` and `SlottedFusedExecutor` (both replicas stacked
as 2N rows of ONE state and stepped by one decode), the training state's
`StackedFusedExecutor` (both replicas on a leading axis of every leaf,
stepped by one vmapped step, with the deferred window) and, in
`abft/executor.py`, the replica-free `AbftExecutor` ("abft"/"hybrid"),
whose `repair()` commits a checksum-corrected step forward before the
recovery policy is asked.

Deferred validation: with `BoundarySchedule.validate_lag=D > 1`, executors
that `supports_deferred` commit optimistically and hand back the ON-DEVICE
match predicate; the engine parks it in a small ring and reads the ring
back once every D commits (and at validate boundaries and the end of a
run), so a fault-free step reads nothing from the device. A failed flush
localizes the first bad step (and, for per-slot predicates, the slots);
recovery then routes through the policy's `restore` (an L2/L3 rollback,
or the per-slot Tier-0 rollback of `SlotRecovery`). A checkpoint boundary
forces the flush first, so every stored version predates every
unvalidated step. The lag degrades to 1 for executors without deferred
support and under `RetryRecovery`, whose retry can only rewind the current
step — so `generate()` keeps its commit-per-step gate.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch import tree as tree_util
from repro_torch.core import hostsync
from repro_torch.core.detection import (DetectionEvent, SedarSafeStop,
                                        Watchdog)
from repro_torch.core.fingerprint import (fingerprints_equal,
                                          leaf_fingerprints, mismatch_report)
from repro_torch.core.recovery import (MultiCheckpointRecovery,
                                       RecoveryAction, RetryRecovery,
                                       ValidatedCheckpointRecovery)


@dataclass(frozen=True)
class BoundarySchedule:
    """When each SEDAR boundary fires (cadences in steps; 0 = never).

    commit_interval     -- TDC boundary: replica fingerprint compare before
                           the commit (paper: validate-before-send).
    validate_interval   -- FSC boundary: full-state fingerprint compare.
    checkpoint_interval -- L2/L3 checkpoint cadence (it also forces the
                           deferred flush).
    toe_timeout_s       -- replica flow-separation lapse (TOE boundary).
    validate_lag        -- deferred validation window D: commit predicates
                           stay on the device and are read back every D
                           commits. 1 = a read per compare.
    """

    commit_interval: int = 1
    validate_interval: int = 0
    checkpoint_interval: int = 0
    toe_timeout_s: float = 120.0
    validate_lag: int = 1

    @classmethod
    def from_config(cls, sedar) -> "BoundarySchedule":
        return cls(commit_interval=max(int(sedar.validate_interval), 1),
                   validate_interval=int(sedar.param_validate_interval),
                   checkpoint_interval=int(sedar.checkpoint_interval),
                   toe_timeout_s=float(sedar.toe_timeout_s),
                   validate_lag=max(int(sedar.validate_lag), 1))

    @staticmethod
    def _due(step: int, interval: int) -> bool:
        return interval > 0 and step > 0 and step % interval == 0

    def commit_due(self, step: int) -> bool:
        return self.commit_interval > 0 and step % self.commit_interval == 0

    def validate_due(self, step: int) -> bool:
        return self._due(step, self.validate_interval)

    def checkpoint_due(self, step: int) -> bool:
        return self._due(step, self.checkpoint_interval)


@dataclass
class StepOutcome:
    """Result of one protected step. `dual` is ALWAYS the state to continue
    from: the pre-step state when the commit was gated by a detection, the
    committed state otherwise."""

    dual: Any
    aux: Any = None
    event: Optional[DetectionEvent] = None

    @property
    def committed(self) -> bool:
        """Whether the step's candidate was adopted (a commit or TOE event
        keeps the pre-step state)."""
        return self.event is None or self.event.boundary not in ("commit",
                                                                 "toe")


def _localize(c0, c1) -> List[Dict[str, Any]]:
    """Leaf-level localization of a commit mismatch: per-leaf fingerprints
    of the two candidates (K1 per leaf on the card; off the hot path)."""
    fa, fb = leaf_fingerprints(c0), leaf_fingerprints(c1)
    return mismatch_report(c0, fa, fb)[:4]


def _clone_state(state):
    return tree_util.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)


class _StateMemo:
    """One verdict memoized on a committed state by identity, without
    keeping the state alive: the key is the state's id and weak references
    to its tensor leaves. A freed or replaced leaf breaks the key, so a
    recycled id can never return its verdict, and the memo never holds a
    state's memory after the caller dropped it."""

    def __init__(self):
        self._key = None
        self._value = None

    @staticmethod
    def _tensors(state):
        return [x for x in tree_util.leaves(state)
                if isinstance(x, torch.Tensor)]

    def get(self, state):
        if self._key is None or self._key[0] != id(state):
            return None
        now = self._tensors(state)
        if len(now) != len(self._key[1]) or any(
                r() is not x for r, x in zip(self._key[1], now)):
            return None
        return self._value

    def put(self, state, value):
        self._key = (id(state), [weakref.ref(x)
                                 for x in self._tensors(state)])
        self._value = value
        return value

    def clear(self) -> None:
        self._key = self._value = None


class ReplicaExecutor:
    """Protocol for redundant-execution backends.

    execute(dual, batch, step, armed, compare) -> (dual', aux, event | None);
        dual' is the pre-step state when event is not None (the slotted
        executor: the matching slots committed, the faulty ones pre-step).
    execute_deferred(dual, batch, step, armed, compare) -> (dual', aux,
        pred): an OPTIMISTIC commit; `pred` is the on-device predicate
        "this step's replicas matched" (only when `supports_deferred`).
    validate(dual, step)   -> DetectionEvent | None  (FSC boundary)
    validated_fp(dual)     -> (per-leaf fp of r0 [np], replicas_equal)
    init_dual(single)      -> dual state from one logical state
    adopt_single(single)   -> dual state from a restored L3 checkpoint
    primary(dual)          -> replica 0's logical state (what an L3
                              checkpoint stores)
    state_fp(dual)         -> per-leaf fingerprint of r0 (reports, L2
                              manifests)
    peek(dual, key)        -> replica 0's entry `key`
    map_state(fn, dual)    -> fn applied to every replica's state
    repair(event, dual)    -> (dual', record) | None  (forward correction)
    """

    name = "base"
    n_replicas = 1
    supports_deferred = False

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

    def adopt_single(self, single):
        return {"r0": single}

    def primary(self, dual):
        return dual["r0"]

    def state_fp(self, dual):
        raise NotImplementedError

    def validated_fp(self, dual):
        return (hostsync.read_scalar(self.state_fp(dual),
                                     label="validated_fp"), True)

    def note_external_update(self) -> None:
        """Callers run this after mutating the resident state outside a
        protected step, so executors that keep state-derived baselines (the
        hybrid commit-time fingerprint) drop them."""

    def repair(self, event: DetectionEvent, dual):
        return None

    def peek(self, dual, key: str):
        return dual["r0"][key]

    def map_state(self, fn, dual):
        """Apply `fn` to EVERY replica's state (the caller's surgery: slot
        admission, eviction, rollback merges). It must treat the replicas
        alike, or it would manufacture a detection."""
        return {r: fn(st) for r, st in dual.items()}

    def execute_deferred(self, dual, batch, step: int, armed,
                         compare: bool = True):
        raise NotImplementedError(
            f"backend {self.name!r} does not support deferred validation")

    def validate(self, dual, step: int) -> Optional[DetectionEvent]:
        return None


class PlainExecutor(ReplicaExecutor):
    """No redundancy: the unprotected baseline (replication='none')."""

    name = "none"

    def __init__(self, step_fn: Callable,
                 state_fp_fn: Optional[Callable] = None):
        self.step_fn = step_fn
        self.state_fp_fn = state_fp_fn

    def execute(self, dual, batch, step: int, armed, compare: bool):
        cand, _fp, aux = self.step_fn(dual["r0"], batch, 0, armed)
        return {"r0": cand}, aux, None

    def state_fp(self, dual):
        return self.state_fp_fn(dual["r0"])


class SequentialExecutor(ReplicaExecutor):
    """Time redundancy: replicas run back to back on the same card, each
    owning a FULL state image (the paper's per-thread memory image). The
    commit compare is ONE counted device read (`commit_compare`).
    `state_fp_fn` fingerprints a replica's state leaf by leaf (reports,
    manifests); `fast_state_fp_fn` (default: the same) is the FSC
    boundary's replica compare."""

    name = "sequential"
    n_replicas = 2
    supports_deferred = True

    def __init__(self, step_fn: Callable, state_fp_fn: Callable,
                 fast_state_fp_fn: Optional[Callable] = None,
                 watchdog: Optional[Watchdog] = None,
                 toe_timeout_s: float = 120.0,
                 delay_source: Optional[Callable[[], dict]] = None):
        self.step_fn = step_fn
        self.state_fp_fn = state_fp_fn
        self.fast_state_fp_fn = fast_state_fp_fn or state_fp_fn
        self.watchdog = watchdog
        self.toe_timeout_s = toe_timeout_s
        # scenario hook: {(step, replica): seconds} of one-shot delays
        self.delay_source = delay_source or (lambda: {})
        self._eq = _StateMemo()   # the FSC verdict of the committed r0

    def init_dual(self, single):
        return {"r0": single, "r1": _clone_state(single)}

    adopt_single = init_dual   # a validated single state seeds both replicas

    def _launch(self, dual, batch, step: int, armed, timed: bool,
                delays: dict):
        """Both replicas, back to back. The per-replica wall time (the TOE
        lapse) needs a device read after each replica, paid only when
        `timed`. Returns (outs, per-replica seconds)."""
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
        self._eq.clear()
        return outs, exec_t

    def _launch_with_toe(self, dual, batch, step: int, armed):
        """Timed dual launch + TOE boundary, shared by the plain and slotted
        sequential executors. The timing is paid only when the boundary can
        fire: a scenario delay is pending or the watchdog was armed.
        Returns (outs, toe_event | None)."""
        delays = self.delay_source() or {}
        timed = bool(delays) or (self.watchdog is not None
                                 and self.watchdog.armed)
        outs, exec_t = self._launch(dual, batch, step, armed, timed, delays)
        if timed and abs(exec_t[1] - exec_t[0]) > self.toe_timeout_s:
            return outs, DetectionEvent(
                step=step, boundary="toe", effect="TOE",
                detail={"dt0": exec_t[0], "dt1": exec_t[1],
                        "timeout_s": self.toe_timeout_s})
        return outs, None

    def execute(self, dual, batch, step: int, armed, compare: bool):
        outs, toe = self._launch_with_toe(dual, batch, step, armed)
        if toe is not None:
            return dual, outs[0][2], toe
        (c0, fp0, aux0), (c1, fp1, _aux1) = outs[0], outs[1]
        if compare and not hostsync.read_bool(fingerprints_equal(fp0, fp1),
                                              label="commit_compare"):
            return dual, aux0, DetectionEvent(
                step=step, boundary="commit", effect="TDC",
                detail={"mismatch": _localize(c0, c1)})
        return {"r0": c0, "r1": c1}, aux0, None

    def _launch_untimed(self, dual, batch, step: int, armed):
        """The deferred path's launch: no TOE timing, which would bring
        back the per-replica read this path exists to avoid."""
        outs, _ = self._launch(dual, batch, step, armed, False,
                               self.delay_source() or {})
        return outs[0], outs[1]

    def execute_deferred(self, dual, batch, step: int, armed,
                         compare: bool = True):
        """Optimistic commit: both candidates adopted, the match predicate
        stays on the device for the engine's deferred ring."""
        (c0, fp0, aux0), (c1, fp1, _aux1) = self._launch_untimed(
            dual, batch, step, armed)
        return {"r0": c0, "r1": c1}, aux0, fingerprints_equal(fp0, fp1)

    def _resident_eq(self, dual) -> bool:
        """Full-state replica comparison, memoized on the committed r0
        state (`_StateMemo`): validate() and validated_fp() land on the
        same state within one step and must not reduce it twice. Every
        launch drops the memo."""
        hit = self._eq.get(dual["r0"])
        if hit is not None:
            return hit
        equal = hostsync.read_bool(
            fingerprints_equal(self.fast_state_fp_fn(dual["r0"]),
                               self.fast_state_fp_fn(dual["r1"])),
            label="state_validate")
        return self._eq.put(dual["r0"], equal)

    def validate(self, dual, step: int) -> Optional[DetectionEvent]:
        if self._resident_eq(dual):
            return None
        return DetectionEvent(step=step, boundary="validate", effect="FSC")

    def validated_fp(self, dual):
        return (hostsync.read_scalar(self.state_fp_fn(dual["r0"]),
                                     label="validated_fp"),
                self._resident_eq(dual))

    def state_fp(self, dual):
        return self.state_fp_fn(dual["r0"])


# ---------------------------------------------------------------------------
# Slot-granular executor (continuous-batching serving)
# ---------------------------------------------------------------------------

def _slot_eq(fp0, fp1) -> torch.Tensor:
    """Per-slot replica equality from per-slot fingerprints (N, 4): exact
    match on the hash words, one device bool per sequence slot."""
    return torch.all(fp0[..., :2] == fp1[..., :2], dim=-1)


def _slot_mismatch_event(eq, step: int,
                         extra: Optional[Dict[str, Any]] = None
                         ) -> DetectionEvent:
    """Fault-path localization: ONE extra read resolves the per-slot
    equality vector into the event's slot list."""
    eq_h = np.asarray(hostsync.read_scalar(eq, label="slot_compare"), bool)
    bad = [int(i) for i in np.nonzero(~eq_h)[0]]
    return DetectionEvent(step=step, boundary="commit", effect="TDC",
                          detail={"slots": bad, "partial": True,
                                  **(extra or {})})


def slot_select(mask, new, old, n_slots: int, axis: int = 0):
    """Per-slot merge of two states: `where(mask)` along the slot axis for
    tensors that carry it (shape[axis] == n_slots); other leaves (the host
    decode tick) and leaves both states share adopt `new`. The KV cache,
    written in place by the step, is one tensor in both states, so the
    merge leaves it as it is: only `tok`, `pos` and `active` select."""
    def sel(a, b):
        if (a is b or not isinstance(a, torch.Tensor) or a.dim() <= axis
                or a.shape[axis] != n_slots):
            return a
        m = mask.reshape((1,) * axis + (n_slots,) + (1,) * (a.dim() - axis - 1))
        return torch.where(m, a, b)
    return tree_util.tree_map(sel, new, old)


class SlottedSequentialExecutor(SequentialExecutor):
    """Time redundancy over a PACKED sequence batch: the step_fn's
    fingerprint has a leading slot axis (N, 4), so a commit mismatch is
    localized to sequence slots and the matching slots' candidates are
    PARTIALLY COMMITTED. Faulty slots keep their pre-step `tok` and `pos`,
    so the next protected step re-decodes them while the others stream on.

    The KV cache is written in place, so a faulty slot's pre-step image
    already holds the failed step's row `pos`. That is safe for the reason
    it is in `generate()`: the re-decode writes row `pos` again before it
    attends to it, and every later row is masked."""

    name = "slotted"

    def __init__(self, *args, n_slots: int = 1, **kw):
        super().__init__(*args, **kw)
        self.n_slots = int(n_slots)

    def execute(self, dual, batch, step: int, armed, compare: bool):
        outs, toe = self._launch_with_toe(dual, batch, step, armed)
        if toe is not None:
            return dual, outs[0][2], toe
        (c0, fp0, aux0), (c1, fp1, _aux1) = outs[0], outs[1]
        if not compare:
            return {"r0": c0, "r1": c1}, aux0, None
        eq = _slot_eq(fp0, fp1)
        if hostsync.read_bool(torch.all(eq), label="commit_compare"):
            return {"r0": c0, "r1": c1}, aux0, None
        merged = {"r0": slot_select(eq, c0, dual["r0"], self.n_slots),
                  "r1": slot_select(eq, c1, dual["r1"], self.n_slots)}
        return merged, aux0, _slot_mismatch_event(eq, step)

    def execute_deferred(self, dual, batch, step: int, armed,
                         compare: bool = True):
        """Optimistic per-slot commit: the (N,) match-predicate vector joins
        the engine's ring, so a failed flush localizes step and slots."""
        (c0, fp0, aux0), (c1, fp1, _aux1) = self._launch_untimed(
            dual, batch, step, armed)
        return {"r0": c0, "r1": c1}, aux0, _slot_eq(fp0, fp1)


# ---------------------------------------------------------------------------
# Fused executors: both replicas as the rows of one state, one launch
# ---------------------------------------------------------------------------

def _row_axis(key: str) -> int:
    """The row (batch) axis of a decode-state entry: the KV cache keeps the
    model's layout (L, B, T, KV, hd), every other tensor has its rows
    first."""
    return 1 if key == "cache" else 0


def _map_rows(fn, state, *others):
    """fn(leaf, row_axis, *matching leaves of `others`) over every leaf of a
    decode state (tensors and host ints alike)."""
    return {k: tree_util.tree_map(
        lambda x, *o, ax=_row_axis(k): fn(x, ax, *o), v,
        *[o[k] for o in others]) for k, v in state.items()}


def stack_replicas(single, n: int = 2):
    """One state holding `n` replica images as row blocks: every tensor
    gets n copies of its rows along its row axis; host ints are shared."""
    def stack(x, ax):
        if not isinstance(x, torch.Tensor):
            return x
        return torch.cat([x] + [x.clone() for _ in range(n - 1)], dim=ax)
    return _map_rows(stack, single)


def replica_rows(stacked, r: int, n: int = 2):
    """Views of replica `r`'s rows of a stacked state."""
    def view(x, ax):
        if not isinstance(x, torch.Tensor):
            return x
        rows = x.shape[ax] // n
        return x.narrow(ax, r * rows, rows)
    return _map_rows(view, stacked)


class FusedSequentialExecutor(ReplicaExecutor):
    """Time redundancy in ONE launch: both replicas' states are stacked as
    row blocks of one state (rows [0, B) replica 0, [B, 2B) replica 1; the
    KV cache (L, 2B, T, KV, hd)) and one step runs them together. PyTorch
    cannot vmap the ctypes kernels, so the reference's vmap over a replica
    axis becomes a batch twice as tall: one decode's launches instead of
    two. Fused step_fn contract: `(stacked, batch, armed) -> (candidate,
    fps (2, ...), aux)`, the fingerprints with a leading replica axis;
    `state_fp_fn` fingerprints one replica's rows.

    The commit gate keeps the pre-step state on a mismatch (the cache, one
    tensor written in place, stays as it is: the retry rewrites row `pos`
    before it reads it). Per-replica TOE timing does not exist: the
    replicas share one launch. The whole-state variant keeps a host-int
    position, so it has no device-side gate and no deferred mode."""

    name = "fused"
    n_replicas = 2

    def __init__(self, step_fn: Callable, state_fp_fn: Callable):
        self.step_fn = step_fn
        self.state_fp_fn = state_fp_fn

    def init_dual(self, single):
        return {"s": stack_replicas(single, self.n_replicas)}

    def peek(self, dual, key: str):
        return replica_rows({key: dual["s"][key]}, 0, self.n_replicas)[key]

    def execute(self, dual, batch, step: int, armed, compare: bool):
        cand, fps, aux = self.step_fn(dual["s"], batch, armed)
        if compare and not hostsync.read_bool(
                fingerprints_equal(fps[0], fps[1]), label="commit_compare"):
            # gated: the pre-step state carries on (the fused hot path
            # trades the leaf-level localization away, as in the reference)
            return dual, aux, DetectionEvent(step=step, boundary="commit",
                                             effect="TDC",
                                             detail={"fused": True})
        return {"s": cand}, aux, None

    def validate(self, dual, step: int) -> Optional[DetectionEvent]:
        fps = [self.state_fp_fn(replica_rows(dual["s"], r, self.n_replicas))
               for r in range(self.n_replicas)]
        if hostsync.read_bool(fingerprints_equal(fps[0], fps[1]),
                              label="state_validate"):
            return None
        return DetectionEvent(step=step, boundary="validate", effect="FSC")

    def map_state(self, fn, dual):
        """fn applied to each replica's rows (views), restacked. A tensor fn
        hands back as the very view it was given (the cache, written in
        place through it) keeps the stacked tensor; a new tensor is
        concatenated in; host ints come from replica 0."""
        n = self.n_replicas
        halves = [replica_rows(dual["s"], r, n) for r in range(n)]
        outs = [fn(h) for h in halves]

        def restack(x, ax, *rest):
            news, views = rest[:n], rest[n:]
            if not isinstance(x, torch.Tensor):
                return news[0]
            if all(o is v for o, v in zip(news, views)):
                return x
            return torch.cat(list(news), dim=ax)

        return {"s": _map_rows(restack, dual["s"], *outs, *halves)}


class SlottedFusedExecutor(FusedSequentialExecutor):
    """Single-launch time redundancy over a packed sequence batch: the
    stacked state holds 2N slot rows, the step's per-row fingerprints
    (2, N, 4) compare rows i and N + i on the device, and the commit gate
    is PER SLOT — a device-side select of `tok`, `pos` and `active` rows
    (`slot_select` over the stacked rows), so a faulty slot keeps its
    pre-step image in both halves while the others advance. At lag 1 the
    gate runs only after a mismatch was read; in deferred mode it runs every
    step with no read, and the (N,) predicate joins the engine's ring."""

    name = "slotted_fused"
    supports_deferred = True

    def __init__(self, step_fn: Callable, state_fp_fn: Callable,
                 n_slots: int = 1):
        super().__init__(step_fn, state_fp_fn)
        self.n_slots = int(n_slots)

    def _gate(self, commit, cand, pre):
        mask = torch.cat([commit] * self.n_replicas)
        return slot_select(mask, cand, pre, self.n_replicas * self.n_slots)

    def execute(self, dual, batch, step: int, armed, compare: bool):
        cand, fps, aux = self.step_fn(dual["s"], batch, armed)
        if not compare:
            return {"s": cand}, aux, None
        eq = _slot_eq(fps[0], fps[1])
        if hostsync.read_bool(torch.all(eq), label="commit_compare"):
            return {"s": cand}, aux, None
        return ({"s": self._gate(eq, cand, dual["s"])}, aux,
                _slot_mismatch_event(eq, step, {"fused": True}))

    def execute_deferred(self, dual, batch, step: int, armed,
                         compare: bool = True):
        """The same launch; the per-slot gate is applied on the device (a
        mismatched slot stays frozen until the flush localizes it) and the
        (N,) predicate joins the engine's ring."""
        cand, fps, aux = self.step_fn(dual["s"], batch, armed)
        eq = _slot_eq(fps[0], fps[1])
        if not compare:
            return {"s": cand}, aux, eq
        return {"s": self._gate(eq, cand, dual["s"])}, aux, eq


# ---------------------------------------------------------------------------
# Fused training executor: both replicas on a leading replica axis
# ---------------------------------------------------------------------------

def stack_leading(single, n: int = 2):
    """One state holding `n` replica images on a new leading axis of every
    tensor leaf (parameters are not row-separable, and a 0-d step counter
    has no rows); other leaves are shared."""
    return tree_util.tree_map(
        lambda x: torch.stack([x] * n) if isinstance(x, torch.Tensor) else x,
        single)


def replica_view(stacked, r: int):
    """Replica `r`'s image of a leading-axis stacked state (views)."""
    return tree_util.tree_map(
        lambda x: x[r] if isinstance(x, torch.Tensor) else x, stacked)


class StackedFusedExecutor(ReplicaExecutor):
    """Time redundancy in ONE set of launches for a training state (the
    reference's vmapped `FusedSequentialExecutor`): every leaf carries both
    replicas on a leading axis of 2, and one step runs them together. Fused
    step_fn contract: `(stacked, batch, armed) -> (candidate, fps (2, 4),
    aux)`; `state_fp_fn` / `fast_state_fp_fn` fingerprint one replica's
    image (a `replica_view`).

    The commit gate adopts the candidate only where the replicas matched.
    At lag 1 the predicate is read first and the host keeps the pre-step
    state on a mismatch. In deferred mode the gate runs on the device with
    no read: `where(eq, candidate, pre-step)` per leaf, written into the
    candidate's own (fresh) tensors, so a mismatched step freezes both
    replicas in place and later steps run batch-skewed until the flush
    localizes the fault and a checkpoint rollback repairs the skew, as in
    the reference. Off-boundary steps (no compare) adopt the candidate
    unconditionally. Per-replica TOE timing does not exist: the replicas
    share one launch."""

    name = "fused"
    n_replicas = 2
    supports_deferred = True

    def __init__(self, step_fn: Callable, state_fp_fn: Callable,
                 fast_state_fp_fn: Optional[Callable] = None):
        self.step_fn = step_fn
        self.state_fp_fn = state_fp_fn
        self.fast_state_fp_fn = fast_state_fp_fn or state_fp_fn
        self._eq = _StateMemo()   # the FSC verdict of the committed state

    def init_dual(self, single):
        return {"s": stack_leading(single, self.n_replicas)}

    adopt_single = init_dual   # a validated single state seeds both replicas

    def primary(self, dual):
        return replica_view(dual["s"], 0)

    def peek(self, dual, key: str):
        return replica_view(dual["s"][key], 0)

    def _launch(self, dual, batch, armed):
        cand, fps, aux = self.step_fn(dual["s"], batch, armed)
        self._eq.clear()
        return cand, fingerprints_equal(fps[0], fps[1]), aux

    def execute(self, dual, batch, step: int, armed, compare: bool):
        cand, eq, aux = self._launch(dual, batch, armed)
        if compare and not hostsync.read_bool(eq, label="commit_compare"):
            # gated: the pre-step state carries on (the fused path trades
            # the leaf-level localization away, as in the reference)
            return dual, aux, DetectionEvent(step=step, boundary="commit",
                                             effect="TDC",
                                             detail={"fused": True})
        return {"s": cand}, aux, None

    def execute_deferred(self, dual, batch, step: int, armed,
                         compare: bool = True):
        cand, eq, aux = self._launch(dual, batch, armed)
        if compare:
            tree_util.tree_map(
                lambda c, p: torch.where(eq, c, p, out=c)
                if isinstance(c, torch.Tensor) else c, cand, dual["s"])
        return {"s": cand}, aux, eq

    def _resident_eq(self, dual) -> bool:
        """Full-state replica compare (two K1 launches on the card, one
        read), memoized on the stacked state as the sequential
        executor's."""
        hit = self._eq.get(dual["s"])
        if hit is not None:
            return hit
        fps = [self.fast_state_fp_fn(replica_view(dual["s"], r))
               for r in range(self.n_replicas)]
        equal = hostsync.read_bool(fingerprints_equal(fps[0], fps[1]),
                                   label="state_validate")
        return self._eq.put(dual["s"], equal)

    def validate(self, dual, step: int) -> Optional[DetectionEvent]:
        if self._resident_eq(dual):
            return None
        return DetectionEvent(step=step, boundary="validate", effect="FSC")

    def validated_fp(self, dual):
        return (hostsync.read_scalar(self.state_fp_fn(self.primary(dual)),
                                     label="validated_fp"),
                self._resident_eq(dual))

    def state_fp(self, dual):
        return self.state_fp_fn(self.primary(dual))


class SedarEngine:
    """Composes executor × schedule × recovery × injection behind
    `run_protected_step()` + `on_detection()`. Owns the run's `detections`,
    `recoveries` and `checkpoints` records; call `reset()` at the start of
    each run. `init_fn()` builds a fresh dual state (the restart from
    scratch of Alg. 1)."""

    def __init__(self, executor: ReplicaExecutor, schedule: BoundarySchedule,
                 recovery, *, inj_spec=None, inj_flag=None,
                 init_fn: Optional[Callable[[], Any]] = None,
                 notify: Optional[Callable[[DetectionEvent], None]] = None):
        self.executor = executor
        self.schedule = schedule
        self.recovery = recovery
        self.inj_spec = inj_spec
        self.inj_flag = inj_flag
        self.init_fn = init_fn
        self.notify = notify or (lambda e: print(str(e), flush=True))
        self.detections: List[DetectionEvent] = []
        self.recoveries: List[Dict[str, Any]] = []
        self.checkpoints: List[int] = []
        # the deferred window degrades to 1 when the executor cannot hand
        # back an on-device predicate, or when recovery is L0 re-execution
        # (a retry can only rewind the CURRENT step)
        lag = max(int(schedule.validate_lag), 1)
        if not executor.supports_deferred or isinstance(recovery,
                                                        RetryRecovery):
            lag = 1
        self.validate_lag = lag
        self._ring: List[Tuple[int, Any]] = []   # device-resident predicates
        self.validated_frontier = 0              # first step NOT validated
        # a serving loop attaches a `TokenRing`: every deferred step parks
        # its emission tensors and flush_deferred reads the drained window
        # in the SAME batch as the combined commit predicate
        self.emission_ring = None
        # autotuner transitions are per run: reset() restores the configured
        # schedule and lag, so a cached engine never carries a tuned knob
        # into the next run
        self.reconfigs: List[Dict[str, Any]] = []
        self._base_schedule = self.schedule
        self._base_lag = self.validate_lag

    @property
    def pending_validation(self) -> bool:
        """True while deferred predicates are parked in the ring."""
        return bool(self._ring)

    def reset(self) -> None:
        self.detections.clear()
        self.recoveries.clear()
        self.checkpoints.clear()
        self._ring.clear()
        self.validated_frontier = 0
        self.emission_ring = None     # callers re-attach per run
        self.reconfigs.clear()
        self.schedule = self._base_schedule
        self.validate_lag = self._base_lag

    def apply_reconfig(self, *, validate_lag: Optional[int] = None,
                       checkpoint_interval: Optional[int] = None,
                       tier_schedule=None,
                       reason: str = "") -> Optional[Dict[str, Any]]:
        """Apply an autotuner knob change at a clean boundary.

        A lag change only takes effect when the deferred ring is EMPTY:
        every optimistic commit so far has been validated, so changing the
        window cannot strand an unvalidated predicate or change which steps
        a pending fault rolls back. A call mid-window returns None (the
        caller retries after the next flush). The `__init__` clamps apply:
        an executor without deferred support or an L0-retry recovery keeps
        lag 1 whatever the tuner asks. A no-op returns None unjournaled; an
        applied transition is appended to `reconfigs` and journaled as a
        `reconfig` line."""
        if self._ring:
            return None
        changes: Dict[str, Any] = {}
        if validate_lag is not None:
            lag = max(int(validate_lag), 1)
            if not self.executor.supports_deferred or isinstance(
                    self.recovery, RetryRecovery):
                lag = 1
            if lag != self.validate_lag:
                changes["validate_lag"] = {"from": self.validate_lag,
                                           "to": lag}
                self.validate_lag = lag
                self.schedule = dataclasses.replace(self.schedule,
                                                    validate_lag=lag)
        if checkpoint_interval is not None:
            ci = max(int(checkpoint_interval), 0)
            if ci != self.schedule.checkpoint_interval:
                changes["checkpoint_interval"] = {
                    "from": self.schedule.checkpoint_interval, "to": ci}
                self.schedule = dataclasses.replace(
                    self.schedule, checkpoint_interval=ci)
                if hasattr(self.recovery, "interval"):
                    self.recovery.interval = ci
        if tier_schedule is not None:
            tiers = getattr(self.recovery, "tiers", None)
            if tiers is not None and tiers.schedule != tier_schedule:
                changes["tier_schedule"] = {
                    "from": dataclasses.asdict(tiers.schedule),
                    "to": dataclasses.asdict(tier_schedule)}
                tiers.schedule = tier_schedule
        if not changes:
            return None
        rec = {"kind": "reconfig", "step": int(self.validated_frontier),
               "reason": str(reason), "changes": changes}
        self.reconfigs.append(rec)
        obs.note_reconfig(rec)
        return rec

    def init_dual(self):
        if self.init_fn is None:
            raise RuntimeError("engine has no init_fn")
        return self.init_fn()

    def run_protected_step(self, dual, batch, step: int) -> StepOutcome:
        """Execute one redundant step at `step`: inject (if armed) ->
        execute replicas -> TDC commit gate (immediate or deferred) -> FSC
        validation boundary -> checkpoint boundary. Returns the state to
        continue from plus the detection event, if any (feed it to
        `on_detection`)."""
        armed = (self.inj_flag is not None
                 and self.inj_flag.arm_spec(self.inj_spec) is not None)
        compare = self.schedule.commit_due(step)
        if self.validate_lag > 1:
            return self._run_deferred(dual, batch, step, armed, compare)

        dual2, aux, event = self.executor.execute(dual, batch, step, armed,
                                                  compare)
        self._mark_injected(step)
        if event is not None:
            return StepOutcome(dual=dual2, aux=aux, event=event)
        self._note_success()   # whatever failed before was transient
        if compare:
            self.validated_frontier = step + 1
        return self._boundaries(dual2, aux, step + 1)

    def _boundaries(self, dual, aux, new_step: int) -> StepOutcome:
        """After a commit: the FSC validation due at `new_step`, then the
        checkpoint right after it."""
        if self.executor.can_validate and \
                self.schedule.validate_due(new_step):
            with obs.span("validate", step=new_step):
                event = self.executor.validate(dual, new_step)
            if event is not None:
                return StepOutcome(dual=dual, aux=aux, event=event)
        return StepOutcome(dual=dual, aux=aux,
                           event=self._maybe_checkpoint(dual, new_step))

    def _note_success(self) -> None:
        note = getattr(self.recovery, "note_success", None)
        if note is not None:
            note()

    def _run_deferred(self, dual, batch, step: int, armed,
                      compare: bool) -> StepOutcome:
        """The commit is optimistic, the match predicate joins the ring, and
        the host reads the ring back every `validate_lag` commits or at a
        validate/checkpoint boundary: a fault-free step between flushes
        reads nothing from the device."""
        dual2, aux, pred = self.executor.execute_deferred(dual, batch, step,
                                                          armed, compare)
        self._mark_injected(step)
        if compare:
            self._ring.append((step, pred))
        if self.emission_ring is not None:
            # park BEFORE the flush check, so the window's last tick is in
            # the ring when its own predicate flushes
            self.emission_ring.park(step, aux)
        new_step = step + 1
        # a checkpoint due at new_step forces the flush too: every stored
        # version predates every unvalidated step
        sync_due = getattr(self.recovery, "sync_due", None)
        if (len(self._ring) >= self.validate_lag
                or self.schedule.validate_due(new_step)
                or self.schedule.checkpoint_due(new_step)
                or (sync_due is not None and sync_due(new_step))):
            event = self.flush_deferred()
            if event is not None:
                return StepOutcome(dual=dual2, aux=aux, event=event)
            self._note_success()
        return self._boundaries(dual2, aux, new_step)

    def flush_deferred(self, final: bool = False,
                       eager: bool = False) -> Optional[DetectionEvent]:
        """Read the deferred window back: ONE counted read of the combined
        ring predicate; only a failed flush pays a second read
        (`deferred_ring`) to localize the first mismatched step and slots.
        A clean flush advances the validated frontier.

        With an `emission_ring` attached, the drained token window rides in
        the SAME `batched_get` as the combined predicate (label
        `token_emit`); a failed flush retracts the faulty slots' rows from
        their first bad step on BEFORE delivery. `final=True` forces the
        drain below the ring's cadence (end of run). `eager=True` reads the
        parked rows below the cadence too (while none is retracted) but
        delivers them only if the flush is clean: what a later drain would
        deliver, sooner; after a failed flush they stay parked, as below
        the cadence."""
        emis = self.emission_ring
        drain = due = None
        if emis is not None:
            due = emis.due(final)
            drain = emis.provide(final=final, eager=eager)
        if not self._ring:
            if drain is not None:
                # nothing pending: every parked row was proven clean by an
                # earlier flush — pure delivery
                with obs.span("token_drain", rows=len(emis)):
                    vals = hostsync.batched_get(drain, label="token_emit")
                emis.deliver(vals)
            return None
        steps_, preds = zip(*self._ring)
        combined = torch.all(torch.stack(list(preds)))
        drain_vals = None
        if drain is not None:
            with obs.span("deferred_flush", steps=len(self._ring),
                          drain_rows=len(emis)):
                vals = hostsync.batched_get([combined] + drain,
                                            label="token_emit")
            ok = bool(np.all(vals[0]))
            drain_vals = vals[1:]
        else:
            with obs.span("deferred_flush", steps=len(self._ring)):
                ok = hostsync.read_bool(combined, label="deferred_flush")
        if ok:
            self.validated_frontier = steps_[-1] + 1
            self._ring.clear()
            if drain_vals is not None:
                emis.deliver(drain_vals)
            return None
        vals = hostsync.batched_get(list(preds), label="deferred_ring")
        bad = [s for s, v in zip(steps_, vals) if not bool(np.all(v))]
        detected_at = steps_[-1] + 1
        self._ring.clear()
        detail: Dict[str, Any] = {"detected_at": detected_at,
                                  "lag": detected_at - bad[0],
                                  "faulty_steps": bad[:8]}
        # per-slot predicates also say WHICH slots diverged and at which
        # step each first went bad
        slot_first: Optional[Dict[int, int]] = None
        if any(np.ndim(v) for v in vals):
            slot_first = {}
            for s, v in zip(steps_, vals):
                v = np.asarray(v)
                if v.ndim and not v.all():
                    for i in np.nonzero(~v)[0]:
                        slot_first.setdefault(int(i), s)
            detail["slots"] = sorted(slot_first)
            detail["slot_first_bad"] = slot_first
        if emis is not None:
            emis.truncate(slot_first, global_bad=bad[0])
            if drain_vals is not None and due:
                emis.deliver(drain_vals)
        return DetectionEvent(step=bad[0], boundary="deferred", effect="TDC",
                              detail=detail)

    def validate_final(self, dual, step: int) -> Optional[DetectionEvent]:
        """Final-results comparison (paper Sec. 3.1), tagged
        boundary='final'. Flushes the deferred window first: unvalidated
        optimistic commits must not reach the final comparison unexamined."""
        event = self.flush_deferred()
        if event is not None:
            return event
        if not self.executor.can_validate_final:
            return None
        event = self.executor.validate(dual, step)
        if event is not None:
            event.boundary = "final"
        return event

    def on_detection(self, event: DetectionEvent, dual):
        """Record + notify + recover. Returns the state to continue from;
        raises SedarSafeStop when the policy is (or degrades to) L1."""
        # predicates parked for steps at or after the detection are stale:
        # the recovery target predates them and the steps re-run
        self._ring.clear()
        self.detections.append(event)
        obs.note_detection(event)
        self.notify(event)
        fix = self.executor.repair(event, dual)
        if fix is not None:
            # forward correction (abft): commit the repaired candidate, no
            # rollback and no retry
            repaired, record = fix
            record = dict(record, at=event.step)
            self.recoveries.append(record)
            obs.note_recovery(record)
            return repaired
        action: RecoveryAction = self.recovery.on_detection(event)
        record = {"kind": action.kind, "step": action.step,
                  "rollbacks": action.rollbacks, "at": event.step}
        self.recoveries.append(record)
        # journal in a finally: the record goes out AFTER the restore's
        # tier and version are merged in, and even when safe-stop raises
        try:
            if action.kind == "stop":
                raise SedarSafeStop(event)
            if action.kind == "retry":
                return dual      # transient fault: re-execute the same step
            if action.kind == "restart_scratch":
                self.validated_frontier = 0
                return self.init_dual()
            if action.step is not None:
                self.validated_frontier = min(self.validated_frontier,
                                              action.step)
            with obs.span("rollback", step=action.step, kind=action.kind):
                if isinstance(self.recovery, ValidatedCheckpointRecovery):
                    # L3 stores ONE validated state: seed every replica
                    # from it
                    single = self.recovery.restore(
                        action, self.executor.primary(dual))
                    self._merge_restore_info(record)
                    return self.executor.adopt_single(single)
                restored = self.recovery.restore(action, dual)
                self._merge_restore_info(record)
                return restored
        finally:
            obs.note_recovery(record)

    def _merge_restore_info(self, record: Dict[str, Any]) -> None:
        """Fold where the restore came from (tier, version) into the
        recovery record just appended."""
        info = getattr(self.recovery, "last_restore_info", None)
        if info:
            record.update(info)

    def _mark_injected(self, step: int) -> None:
        # persistent (stuck-bit) specs are never marked: recovery
        # re-executions MUST re-inject them
        if (self.inj_spec is not None and self.inj_flag is not None
                and not self.inj_spec.persistent
                and not self.inj_flag.already_injected()
                and step == self.inj_spec.step):
            self.inj_flag.mark()

    def _maybe_checkpoint(self, dual, step: int) -> Optional[DetectionEvent]:
        """The L2/L3 checkpoint due at `step`, cut after the commit and the
        FSC validation. L2 saves the full dual state with replica 0's
        per-leaf fingerprint (read only on a boundary); L3 saves replica 0
        if the replicas' state fingerprints are equal, else returns the
        `ckpt_validate` event."""
        r = self.recovery
        if isinstance(r, MultiCheckpointRecovery):
            if step == 0 or not r.due(step):
                return None
            fp = hostsync.read_scalar(self.executor.state_fp(dual),
                                      label="checkpoint_fp") \
                if r.fp_needed(step) else None
            with obs.span("checkpoint", step=step):
                if r.maybe_checkpoint(step, dual, fp,
                                      validated_floor=self.validated_frontier):
                    self.checkpoints.append(step)
                    obs.note_checkpoint(step)
            return None
        if isinstance(r, ValidatedCheckpointRecovery):
            if step == 0 or step % r.interval != 0:
                return None
            fp0, fp_equal = self.executor.validated_fp(dual)
            with obs.span("checkpoint", step=step):
                ev = r.maybe_checkpoint(step,
                                        {"r0": self.executor.primary(dual)},
                                        fp0, fp_equal=fp_equal)
            if ev is None:
                self.checkpoints.append(step)
                obs.note_checkpoint(step)
            return ev
        return None   # SafeStop / RetryRecovery / SlotRecovery store none
