"""SEDAR temporal-behavior model — paper Eqs. (1)-(14), Sec. 3.4 and Sec. 4.4.

All times in HOURS unless suffixed _s. Parameter names follow paper Table 1:

    T_prog  : execution time of two instances of the original app in parallel
    T_comp  : semi-automatic result comparison time
    T_rest  : restart time
    f_d     : detection-mechanism overhead factor (0 < f_d < 1)
    X       : fault-detection instant as a fraction of progress (0 < X < 1)
    n       : number of checkpoints in the whole execution
    t_cs    : system-level checkpoint store time
    t_i     : checkpoint interval
    k       : extra checkpoints to rewind when the last one is dirty
    t_ca    : application-level checkpoint store time (t_ca < t_cs)
    T_compA : application-level checkpoint validation time

Beyond-paper ABFT terms (DESIGN.md §10 — detection by checksum-carrying
kernels instead of duplicated execution):

    f_a     : ABFT checksum overhead factor (encode + verify, a few percent)
    abft_correct_frac : fraction of detected faults the checksums localize
              and forward-correct in place (single-element corruptions)
    redundancy_wall   : wall-clock ratio of the duplicated execution to ONE
              instance. T_prog is defined as two instances IN PARALLEL
              (space redundancy: same wall as one instance, 2x resources),
              so the default is 1.0 — ABFT's fault-free WALL matches
              duplication's, its win there is halved resources plus forward
              correction on the faulty path. Set 2.0 explicitly when
              modeling the time-redundant sequential backend (duplication
              doubles the wall and ABFT's single instance halves it back).

Deferred-validation terms (DESIGN.md §11 — the engine's `validate_lag=D`
window; cf. Aupy et al., "On the Combination of Silent Error Detection and
Checkpointing": the validation interval is a tunable independent of the
checkpoint interval):

    t_step  : duration of ONE protected step (hours)
    t_sync  : host-sync cost the per-step predicate readback adds to a step
              (hours) — a device->host round-trip plus the pipeline bubble
              it forces; 0 disables the deferred model
    D       : validate_lag. Fault-free runs save t_sync*(1 - 1/D) per step;
              a fault detected up to D steps late discards D/2 steps of
              work in expectation (uniform fault instant inside the window)

Validated against the paper's published Tables 4 and 5 in
tests/test_temporal_model.py.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class SedarParams:
    T_prog: float            # hours
    T_comp: float            # hours
    T_rest: float            # hours
    f_d: float
    t_cs: float              # hours
    t_ca: float              # hours
    T_compA: float           # hours
    t_i: float = 1.0         # hours
    n: Optional[int] = None  # checkpoints; default derived from Eq. 3 / t_i
    f_a: float = 0.03        # ABFT checksum overhead factor (beyond paper)
    abft_correct_frac: float = 0.8   # detected faults corrected in place
    redundancy_wall: float = 1.0     # duplicated wall / single-instance wall
    t_step: float = 0.0      # hours per protected step (deferred model)
    t_sync: float = 0.0      # hours of host-sync cost per per-step readback

    def n_ckpts(self) -> int:
        """Paper: n = time of the detection-only strategy (Eq. 3) / t_i."""
        if self.n is not None:
            return self.n
        return int(detection_fa(self) / self.t_i)


# ---------------------------------------------------------------------------
# Baseline (manual two-instance + vote) — Eqs. (1), (2)
# ---------------------------------------------------------------------------

def baseline_fa(p: SedarParams) -> float:
    return p.T_prog + p.T_comp                                   # Eq. (1)


def baseline_fp(p: SedarParams) -> float:
    return 2.0 * (p.T_prog + p.T_comp) + p.T_rest                # Eq. (2)


# ---------------------------------------------------------------------------
# L1: detection + notification — Eqs. (3), (4)
# ---------------------------------------------------------------------------

def detection_fa(p: SedarParams) -> float:
    return p.T_prog * (1.0 + p.f_d) + p.T_comp                   # Eq. (3)


def detection_fp(p: SedarParams, X: float) -> float:
    return (p.T_prog * (1.0 + p.f_d) * (X + 1.0)
            + p.T_rest + p.T_comp)                               # Eq. (4)


# ---------------------------------------------------------------------------
# L2: multiple system-level checkpoints — Eqs. (5), (6) == (14) via (13)
# ---------------------------------------------------------------------------

def multi_ckpt_fa(p: SedarParams) -> float:
    return detection_fa(p) + p.n_ckpts() * p.t_cs                # Eq. (5)


def multi_ckpt_fp(p: SedarParams, k: int) -> float:
    """Eq. (6)/(14): sum_{m=0}^{k}(k - m + 1/2) t_i == ((k+1)^2 / 2) t_i."""
    n = p.n_ckpts()
    rework = ((k + 1) ** 2) / 2.0 * p.t_i                        # Eq. (13)
    return (p.T_prog * (1.0 + p.f_d) + p.T_comp
            + (n + k) * p.t_cs + rework + (k + 1) * p.T_rest)    # Eq. (14)


# ---------------------------------------------------------------------------
# L3: single validated application-level checkpoint — Eqs. (7), (8)
# ---------------------------------------------------------------------------

def single_ckpt_fa(p: SedarParams) -> float:
    n = p.n_ckpts()
    return detection_fa(p) + n * (p.t_ca + p.T_compA)            # Eq. (7)


def single_ckpt_fp(p: SedarParams) -> float:
    return (single_ckpt_fa(p) + 0.5 * p.t_i + p.T_rest)          # Eq. (8)


# ---------------------------------------------------------------------------
# ABFT: replica-free checksum detection (beyond paper, DESIGN.md §10)
# ---------------------------------------------------------------------------

def abft_fa(p: SedarParams) -> float:
    """Fault-free time of the ABFT-protected SINGLE instance: one execution
    carrying checksums (f_a analogue of f_d) plus the residual-verification
    pass (bounded by T_comp — both are one pass over the results)."""
    return (p.T_prog / p.redundancy_wall) * (1.0 + p.f_a) + p.T_comp


def abft_fp(p: SedarParams, X: float) -> float:
    """Time with one fault at progress X. Detected-corrected faults (frac
    abft_correct_frac) are repaired FORWARD at negligible cost; the
    uncorrectable remainder relaunches, mirroring Eq. (4) with the
    single-instance progression time."""
    t = (p.T_prog / p.redundancy_wall) * (1.0 + p.f_a)
    relaunch = t * (X + 1.0) + p.T_rest + p.T_comp
    return p.abft_correct_frac * abft_fa(p) \
        + (1.0 - p.abft_correct_frac) * relaunch


def hybrid_fa(p: SedarParams, validations: int = 0) -> float:
    """ABFT + periodic fingerprint validation (the escaped-fault backstop):
    each validation is one T_comp-class pass over the state."""
    return abft_fa(p) + validations * p.T_comp


# ---------------------------------------------------------------------------
# Deferred validation window (DESIGN.md §11, beyond paper)
# ---------------------------------------------------------------------------

def n_steps(p: SedarParams) -> float:
    """Protected steps in the detection-only run (Eq.-3 time / t_step)."""
    if p.t_step <= 0:
        return 0.0
    return detection_fa(p) / p.t_step


def deferred_sync_savings(p: SedarParams, D: int) -> float:
    """Hours removed from the fault-free run by deferring the per-step
    predicate readback to every D-th step: each of the n_steps steps keeps
    1/D of the sync cost (the flush still reads the ring once per window)."""
    if D <= 1 or p.t_sync <= 0 or p.t_step <= 0:
        return 0.0
    return n_steps(p) * p.t_sync * (1.0 - 1.0 / D)


def deferred_waste(p: SedarParams, D: int) -> float:
    """Expected work discarded per fault: detection lags the faulty step by
    U[0, D) steps (uniform fault instant inside the window), so D/2 steps
    of optimistic progress roll back and re-execute in expectation."""
    if D <= 1 or p.t_step <= 0:
        return 0.0
    return (D / 2.0) * p.t_step


def deferred_fa(p: SedarParams, D: int) -> float:
    """Fault-free time of detection+deferral: Eq. (3) minus the sync wins."""
    return detection_fa(p) - deferred_sync_savings(p, D)


def deferred_fp(p: SedarParams, D: int, X: float) -> float:
    """Faulty time: Eq. (4) keeps the sync wins but pays the D/2 discard."""
    return detection_fp(p, X) - deferred_sync_savings(p, D) \
        + deferred_waste(p, D)


def aet_deferred(p: SedarParams, D: int, mtbe: float, X: float = 0.5) -> float:
    """Eq. (11) with the deferred-window fa/fp pair.

    Short-MTBE correction: Eq. (11)'s alpha saturates at ONE fault per
    execution, but a faulty run at mtbe << T_prog contains ~T_prog/mtbe
    faults and pays the D/2-step discard for EACH of them. Without the
    extra term the model would always prefer the longest window under
    fault storms — exactly when long windows are most expensive (pinned
    against a measured-cost simulation in bench_autotune)."""
    extra = max(p.T_prog / mtbe - 1.0, 0.0) * deferred_waste(p, D)
    return aet(deferred_fp(p, D, X) + extra, deferred_fa(p, D),
               p.T_prog, mtbe)


LAG_CANDIDATES = (1, 2, 4, 8, 16, 32, 64, 128)


def optimal_validate_lag(p: SedarParams, mtbe: float, X: float = 0.5,
                         candidates=LAG_CANDIDATES) -> int:
    """argmin_D of the deferred AET. The tension: sync savings saturate as
    (1 - 1/D) while the per-fault discard grows as D/2, so the optimum
    rises with t_sync/t_step and falls as MTBE shrinks. Returns 1 when the
    deferred terms are unparameterized (t_step or t_sync unset)."""
    if p.t_step <= 0 or p.t_sync <= 0:
        return 1
    return min(candidates, key=lambda D: aet_deferred(p, int(D), mtbe, X))


# ---------------------------------------------------------------------------
# Tiered checkpoint hierarchy (DESIGN.md §12, beyond paper; cf. Aupy et al.
# arXiv:1310.8486 — verification cadence coupled with a hierarchy of
# checkpoint costs)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TierCosts:
    """Per-tier generalization of the paper's single t_cs/t_r pair.

    t_save    : hours to store one version in this tier (the tier's t_cs)
    t_restore : hours to restore one version from this tier (its t_r —
                includes the restart-class costs that tier actually pays:
                a device-ring restore is a few on-device copies, a disk
                restore pays deserialization + digest verification)
    slots     : ring capacity in versions (0 = unbounded, disk-backed)
    """

    t_save: float
    t_restore: float
    slots: int = 0


def default_tier_costs(p: SedarParams) -> dict:
    """Tier costs derived from the measured flat-store numbers: the device
    ring is ~2 orders of magnitude cheaper than serialization (pure HBM
    copies), the host ring ~1 order (one batched D2H, no serialization),
    the partner tier doubles the disk cost (second independent copy).
    Replace with bench_checkpoint.py measurements when available."""
    return {
        "device": TierCosts(t_save=p.t_cs / 256.0, t_restore=p.t_cs / 256.0,
                            slots=4),
        "host": TierCosts(t_save=p.t_cs / 16.0, t_restore=p.t_cs / 16.0,
                          slots=4),
        "disk": TierCosts(t_save=p.t_cs, t_restore=p.T_rest),
        "partner": TierCosts(t_save=2.0 * p.t_cs, t_restore=2.0 * p.T_rest),
    }


TIER_NAMES = ("device", "host", "disk", "partner")


def tiered_fa(p: SedarParams, schedule: dict, costs: dict) -> float:
    """Eq. (5) generalized to the hierarchy: fault-free time = detection
    time + Σ_tier (saves in that tier) · t_save(tier). `schedule` maps tier
    name -> save interval in steps (0/absent = tier disabled)."""
    steps = n_steps(p)
    if steps <= 0:
        return detection_fa(p)
    extra = sum((steps / iv) * costs[t].t_save
                for t, iv in schedule.items() if iv > 0 and t in costs)
    return detection_fa(p) + extra


def restore_tier(schedule: dict, costs: dict, lag_steps: int = 1) -> str:
    """The planner's expected source tier for a fault detected `lag_steps`
    after it happened: the cheapest tier whose retention window (slots ·
    interval, unbounded for disk tiers) still spans a version predating the
    fault. Mirrors TieredCheckpointer.plan's cost order."""
    enabled = [t for t in TIER_NAMES if schedule.get(t, 0) > 0]
    for t in enabled:
        c = costs[t]
        if c.slots == 0 or c.slots * schedule[t] > lag_steps:
            return t
    return enabled[-1] if enabled else "disk"


def tiered_fp(p: SedarParams, schedule: dict, costs: dict, X: float = 0.5,
              lag_steps: int = 1) -> float:
    """Time with one fault: the planner restores from `restore_tier`, so
    the penalty is that tier's t_restore plus the rework back to its newest
    version predating the fault — detection lag + half the tier's interval
    in expectation (uniform fault instant inside the interval)."""
    t = restore_tier(schedule, costs, lag_steps)
    rework = (lag_steps + schedule.get(t, 1) / 2.0) * p.t_step
    return tiered_fa(p, schedule, costs) + costs[t].t_restore + rework


def aet_tiered(p: SedarParams, schedule: dict, costs: dict, mtbe: float,
               X: float = 0.5, lag_steps: int = 1) -> float:
    """Eq. (11) with the tiered fa/fp pair."""
    return aet(tiered_fp(p, schedule, costs, X, lag_steps),
               tiered_fa(p, schedule, costs), p.T_prog, mtbe)


def optimal_tier_schedule(p: SedarParams, costs: Optional[dict] = None,
                          mtbe: float = 5.0, lag_steps: int = 1) -> dict:
    """Cost-aware cadence per tier (steps between saves).

    * device: every step — a ring snapshot costs ~nothing next to t_step,
      and it is the tier that makes rollback-to-k free;
    * host / disk: Daly's optimum interval computed against EACH tier's own
      t_save (the whole point of the hierarchy: a cheap tier affords a
      short interval), floored at one step and kept monotonically
      non-decreasing down the hierarchy;
    * partner: the disk cadence ×2 — it exists to survive store corruption,
      not to shorten rollback distance, so it only needs to bound the
      re-protection window.

    Empty dict when the deferred terms are unparameterized (t_step unset)."""
    if p.t_step <= 0:
        return {}
    costs = costs or default_tier_costs(p)

    def steps_for(tier: str, floor: int) -> int:
        iv_h = daly_interval(costs[tier].t_save, mtbe)
        return max(int(round(iv_h / p.t_step)), floor, 1)

    out = {"device": 1}
    out["host"] = steps_for("host", out["device"])
    out["disk"] = steps_for("disk", out["host"])
    out["partner"] = max(2 * out["disk"], 1)
    return out


# ---------------------------------------------------------------------------
# Serving under faults (DESIGN.md §13, beyond paper): goodput & availability
# of continuous-batching protected decode with per-request recovery
# ---------------------------------------------------------------------------
#
# One decode step emits one token per active slot, so t_step doubles as the
# per-token machine time. Faults arrive at rate 1/MTBE; per fault the
# recovery cost depends on the rework SCOPE:
#   whole-batch (the synchronous generate() loop): every one of n_slots
#     sequences re-executes the detection window -> n_slots * D/2 slot-steps
#     discarded in expectation (uniform fault instant inside the window);
#   per-request (the slotted loop): ONE slot rolls back from its Tier-0
#     ring while the others stream on -> D/2 slot-steps discarded.
# Goodput is the delivered fraction of slot-step capacity; availability is
# the probability a random sequence is NOT replaying rolled-back work at a
# random instant (whole-batch recovery stalls everyone, per-request only
# the affected sequence).


def serve_goodput(p: SedarParams, mtbe: float, n_slots: int, D: int = 1,
                  per_request: bool = True) -> float:
    """Delivered fraction of decode capacity under faults: 1 minus the
    expected slot-steps discarded per fault over the slot-steps produced
    between faults."""
    if p.t_step <= 0 or n_slots <= 0:
        return 1.0
    steps_between_faults = mtbe / p.t_step          # decode ticks per fault
    discarded = (max(D, 1) / 2.0) * (1.0 if per_request else n_slots)
    frac = discarded / max(steps_between_faults * n_slots, 1e-12)
    return max(0.0, 1.0 - frac)


def serve_availability(p: SedarParams, mtbe: float, n_slots: int,
                       D: int = 1, per_request: bool = True) -> float:
    """Probability a given sequence is streaming (not replaying) at a
    random instant: replay occupies D/2 of its slot's ticks per fault, and
    whole-batch recovery replays EVERY sequence while per-request recovery
    replays only the affected one (probability 1/n_slots per fault)."""
    if p.t_step <= 0 or n_slots <= 0:
        return 1.0
    steps_between_faults = mtbe / p.t_step
    replay = (max(D, 1) / 2.0) * \
        ((1.0 / n_slots) if per_request else 1.0)
    return max(0.0, 1.0 - replay / max(steps_between_faults, 1e-12))


def serve_token_cost(p: SedarParams, mtbe: float, n_slots: int,
                     D: int = 1) -> float:
    """Expected machine-hours per DELIVERED token at validate_lag D with
    per-request recovery: the step itself, the amortized once-per-D
    predicate readback, and the per-fault slot rework spread over the
    tokens between faults. The serving analogue of Eq. (11)'s integrand."""
    if p.t_step <= 0:
        return 0.0
    sync = p.t_sync / max(D, 1)
    tokens_between_faults = (mtbe / p.t_step) * max(n_slots, 1)
    rework = (max(D, 1) / 2.0) * p.t_step / max(tokens_between_faults, 1e-12)
    return p.t_step + sync + rework


SERVE_LAG_CANDIDATES = (1, 2, 4, 8, 16, 32, 64)


def optimal_serve_lag(p: SedarParams, mtbe: float, n_slots: int,
                      candidates=SERVE_LAG_CANDIDATES) -> int:
    """argmin_D of the per-token cost. Same tension as
    `optimal_validate_lag`, but the per-fault discard is divided by
    n_slots (only one sequence replays), so serving tolerates LONGER
    windows than training at the same MTBE — at the price of up to D
    steps of emission-rollback latency on the faulty request."""
    if p.t_step <= 0 or p.t_sync <= 0:
        return 1
    return min(candidates,
               key=lambda D: serve_token_cost(p, mtbe, n_slots, int(D)))


# ---------------------------------------------------------------------------
# Average execution time — Eqs. (9)-(11)
# ---------------------------------------------------------------------------

def fault_probability(T_prog: float, mtbe: float) -> float:
    """Eq. (10): P = 1 - exp(-T_prog / MTBE), exponential error model."""
    return 1.0 - math.exp(-T_prog / mtbe)


def aet(t_fp: float, t_fa: float, T_prog: float, mtbe: float) -> float:
    """Eq. (11)."""
    alpha = fault_probability(T_prog, mtbe)
    return t_fp * alpha + t_fa * (1.0 - alpha)


def aet_strategy(p: SedarParams, strategy: str, mtbe: float,
                 X: float = 0.5, k: int = 0) -> float:
    """AET for one of: baseline | detection | multi_ckpt | single_ckpt | abft."""
    table = {
        "baseline": (baseline_fa(p), baseline_fp(p)),
        "detection": (detection_fa(p), detection_fp(p, X)),
        "multi_ckpt": (multi_ckpt_fa(p), multi_ckpt_fp(p, k)),
        "single_ckpt": (single_ckpt_fa(p), single_ckpt_fp(p)),
        "abft": (abft_fa(p), abft_fp(p, X)),
    }
    fa, fp = table[strategy]
    return aet(fp, fa, p.T_prog, mtbe)


def system_mtbe(mtbe_individual: float, n_processors: int) -> float:
    """MTBE = MTBE_ind / N (paper Sec. 3.4)."""
    return mtbe_individual / n_processors


# ---------------------------------------------------------------------------
# Checkpoint-interval selection (Daly's higher-order estimate, paper Sec. 4.3)
# ---------------------------------------------------------------------------

def daly_interval(t_cs: float, mtbe: float) -> float:
    """Daly (2006) higher-order optimum checkpoint interval (hours)."""
    if t_cs >= 2.0 * mtbe:
        return mtbe
    x = math.sqrt(2.0 * t_cs * mtbe)
    return x * (1.0 + math.sqrt(t_cs / (2.0 * mtbe)) / 3.0
                + (t_cs / (2.0 * mtbe)) / 9.0) - t_cs


# ---------------------------------------------------------------------------
# Sec. 4.4 — convenience of saving multiple checkpoints
# ---------------------------------------------------------------------------

def admissible_k(p: SedarParams, X: float) -> int:
    """Largest admissible k at detection instant X: the rollback target
    checkpoint must already exist (ckpts are cut every t_i of Eq.-3 time)."""
    stored = int((X * detection_fa(p)) / p.t_i)   # checkpoints stored so far
    return max(stored - 1, -1)                    # k in {0..stored-1}


def rollback_beats_restart(p: SedarParams, X: float, k: int) -> bool:
    """True if k+1 rollbacks (Eq. 14) beat detect+relaunch (Eq. 4) at X."""
    if k > admissible_k(p, X):
        return False
    return multi_ckpt_fp(p, k) <= detection_fp(p, X)


def min_progress_for_checkpointing(p: SedarParams) -> float:
    """X* below which storing checkpoints is NOT worth it (Eq.4 <= Eq.14, k=0).

    Paper Sec 4.4: X <= ~5.88% for the Jacobi parameters."""
    # T(1+fd)(X+1) + Trest + Tcomp <= T(1+fd) + Tcomp + n tcs + ti/2 + Trest
    n = p.n_ckpts()
    return (n * p.t_cs + 0.5 * p.t_i) / (p.T_prog * (1.0 + p.f_d))


def min_progress_for_k(p: SedarParams, k: int) -> float:
    """X* above which rolling back k+1 checkpoints beats detect+relaunch."""
    n = p.n_ckpts()
    lhs = ((n + k) * p.t_cs + ((k + 1) ** 2) / 2.0 * p.t_i
           + k * p.T_rest)
    return lhs / (p.T_prog * (1.0 + p.f_d))


def convenience_table(p: SedarParams, Xs=(0.3, 0.5, 0.8), ks=(0, 1, 2, 3, 4)):
    """Paper Table 5: detection-only time vs k+1-rollback times, with NA for
    non-admissible (checkpoint not yet stored) combinations."""
    rows = []
    for X in Xs:
        adm = admissible_k(p, X)
        row = {"X": X, "detection": detection_fp(p, X), "k": {}}
        for k in ks:
            row["k"][k] = multi_ckpt_fp(p, k) if k <= adm else None  # None = NA
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Node loss: fail-in-place vs full restart (DESIGN.md §16, beyond paper —
# the spatial analogue of Sec. 4.4's rollback-vs-restart convenience rule)
# ---------------------------------------------------------------------------

def remesh_overhead(p: SedarParams, costs: Optional[dict] = None) -> float:
    """Hours one elastic remesh transition costs: restore the anchor state
    from the durable partner tier onto the (new) mesh plus re-plumbing the
    survivors. The process, data pipeline, and compiled executables all
    survive, so the restore pays only the partner copy's data movement
    (~its save cost, NOT its restart-class t_restore) plus a small
    fraction of a relaunch for the mesh rebuild."""
    c = costs or default_tier_costs(p)
    return c["partner"].t_save + 0.1 * p.T_rest


def fail_in_place_cost(p: SedarParams, outage_hours: float,
                       costs: Optional[dict] = None,
                       keep_degraded: bool = False) -> float:
    """Hours a node outage costs under fail-in-place: shrink + regrow
    transitions (2× remesh), and — because the authoritative full-width
    trajectory re-anchors at the pre-shrink checkpoint — the degraded
    segment is replayed at full width unless `keep_degraded` (a workload
    that accepts the reduced-batch trajectory as-is). The replayed segment
    is the outage span plus half a checkpoint interval of pre-outage work
    in expectation."""
    transitions = 2.0 * remesh_overhead(p, costs)
    if keep_degraded:
        return transitions
    return transitions + 0.5 * p.t_i + outage_hours


def node_restart_cost(p: SedarParams, outage_hours: float) -> float:
    """Hours the same outage costs under stop-and-relaunch (the Eq.-4
    restart path applied to a node loss): the job idles for the outage,
    pays a full relaunch, and redoes half a checkpoint interval."""
    return outage_hours + p.T_rest + 0.5 * p.t_i


def fail_in_place_beats_restart(p: SedarParams, outage_hours: float,
                                costs: Optional[dict] = None,
                                keep_degraded: bool = False) -> bool:
    """The §16 decision direction: with the degraded trajectory replayed,
    both options pay the outage span + t_i/2, so fail-in-place wins exactly
    when two remesh transitions undercut one full relaunch (2·remesh <
    T_rest) — and always wins when the degraded progress is kept."""
    return fail_in_place_cost(p, outage_hours, costs, keep_degraded) <= \
        node_restart_cost(p, outage_hours)


# ---------------------------------------------------------------------------
# Paper Table 3 parameter sets (for validation + benchmarks)
# ---------------------------------------------------------------------------

PAPER_TABLE3 = {
    "MATMUL": SedarParams(T_prog=10.21, T_comp=42 / 3600, T_rest=14.10 / 3600,
                          f_d=0.0001, t_cs=14.10 / 3600, t_ca=10.58 / 3600,
                          T_compA=42 / 3600, t_i=1.0, n=10),
    "JACOBI": SedarParams(T_prog=8.92, T_comp=1 / 3600, T_rest=9.62 / 3600,
                          f_d=0.006, t_cs=9.62 / 3600, t_ca=9.11 / 3600,
                          T_compA=1 / 3600, t_i=1.0, n=8),
    "SW":     SedarParams(T_prog=11.15, T_comp=0.5 / 3600, T_rest=2.55 / 3600,
                          f_d=0.0005, t_cs=2.55 / 3600, t_ca=1.92 / 3600,
                          T_compA=0.5 / 3600, t_i=1.0, n=11),
}

# Paper Table 4 published values (hours) for regression-testing our model.
PAPER_TABLE4 = {
    # row: (MATMUL, JACOBI, SW)
    "baseline_fa":        (10.22, 8.92, 11.15),
    "baseline_fp":        (20.45, 17.85, 22.35),
    "detection_fa":       (10.23, 8.97, 11.16),
    "detection_fp_30":    (13.29, 11.67, 14.50),
    "detection_fp_50":    (15.33, 13.46, 16.73),
    "detection_fp_80":    (18.39, 16.16, 20.08),
    "multi_fa":           (10.26, 9.00, 11.17),
    "multi_fp_k0":        (10.77, 9.50, 11.66),
    "multi_fp_k1":        (12.27, 11.01, 13.17),
    "multi_fp_k4":        (22.79, 21.53, 23.67),
    "single_fa":          (10.37, 8.99, 11.16),
    "single_fp":          (10.87, 9.50, 11.66),
}


def table4_ours() -> dict:
    """Recompute paper Table 4 from Table 3 parameters with our model."""
    out = {}
    apps = ["MATMUL", "JACOBI", "SW"]
    P = [PAPER_TABLE3[a] for a in apps]
    out["baseline_fa"] = tuple(baseline_fa(p) for p in P)
    out["baseline_fp"] = tuple(baseline_fp(p) for p in P)
    out["detection_fa"] = tuple(detection_fa(p) for p in P)
    for x in (30, 50, 80):
        out[f"detection_fp_{x}"] = tuple(detection_fp(p, x / 100) for p in P)
    out["multi_fa"] = tuple(multi_ckpt_fa(p) for p in P)
    for k in (0, 1, 4):
        out[f"multi_fp_k{k}"] = tuple(multi_ckpt_fp(p, k) for p in P)
    out["single_fa"] = tuple(single_ckpt_fa(p) for p in P)
    out["single_fp"] = tuple(single_ckpt_fp(p) for p in P)
    return out
