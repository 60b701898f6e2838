"""Protection policy: strategy advisor, engine factory and the autotuner
(the reference's `core/policy.py`).

Three parts:
  * `advise()` (paper Secs. 3.4 + 4.4): given measured execution parameters
    (f_d, t_cs, t_ca, ...) and the system MTBE, pick the SEDAR level +
    checkpoint interval that minimizes the Average Execution Time (Eq. 11);
    `choose_degraded_mode()` weighs fail-in-place against a restart after
    a node loss.
  * `make_engine()` / `make_trainer()` / `make_server()`: the composition
    point that turns a SedarConfig + workload step functions into a
    `SedarEngine` for the `none`/`sequential`/`fused`/`abft`/`hybrid`
    backends and the mesh backends `pod`/`vote` (training).
  * `Autotuner` / `autotune()`: the closed loop — the obs estimator
    calibrates the temporal model online, drift detectors and SLO burn
    windows raise alerts, and safe knob changes (validate_lag, tier
    cadences) are applied via `SedarEngine.apply_reconfig()` at clean
    deferred-flush boundaries with hysteresis; backend changes are
    advisory alerts only.

Host-side Python only: nothing here reads a device tensor.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from repro_torch.core import temporal_model as tm


@dataclass
class Advice:
    strategy: str                  # detection | multi_ckpt | single_ckpt
    level: int
    t_i: float                     # recommended checkpoint interval (hours)
    aet_hours: Dict[str, float]    # AET per strategy at the chosen t_i
    start_checkpointing_at: float  # progress fraction X* (Sec. 4.4)
    keep_two_checkpoints_at: float # X* above which >=2 rollbacks pay off
    notes: str = ""
    # detection-mechanism axis (DESIGN.md §10): "duplication" (the paper's
    # replicated execution) vs "abft" (replica-free checksummed kernels).
    detection_mechanism: str = "duplication"
    abft_aet_hours: float = 0.0    # AET of the ABFT backend at the same MTBE
    # deferred-validation axis (DESIGN.md §11): recommended validate_lag D
    # (1 = classic sync-per-compare) and its AET at the chosen MTBE
    validate_lag: int = 1
    deferred_aet_hours: float = 0.0
    # tiered-checkpoint axis (DESIGN.md §12): recommended per-tier save
    # cadence in steps (device/host/disk/partner; empty when t_step is
    # unparameterized) and the hierarchy's AET at the chosen MTBE
    tier_schedule: Dict[str, int] = field(default_factory=dict)
    tiered_aet_hours: float = 0.0
    # serving axis (DESIGN.md §13): recommended deferred window for the
    # continuous-batching decode loop, plus the goodput/availability of
    # per-request recovery vs whole-batch recovery at that window
    serve_validate_lag: int = 1
    serve_goodput: float = 1.0          # per-request recovery, at the lag
    serve_goodput_whole_batch: float = 1.0
    serve_availability: float = 1.0


def advise(p: tm.SedarParams, mtbe_hours: float,
           X_expected: float = 0.5, k_expected: int = 0,
           serve_slots: int = 8) -> Advice:
    """Pick the minimum-AET strategy.

    X_expected: where faults are typically detected (0.5 if unknown —
    uniform detection instant, the paper's average-case assumption).
    k_expected: typical extra rollbacks for L2 (0 when the detection latency
    is usually inside one interval).
    serve_slots: continuous-batching slot count used for the serving
    goodput/lag guidance (only meaningful when t_step/t_sync are set)."""
    # tune t_i by Daly for the two checkpointing strategies
    ti_sys = max(tm.daly_interval(p.t_cs, mtbe_hours), p.t_cs * 4)
    ti_app = max(tm.daly_interval(p.t_ca + p.T_compA, mtbe_hours),
                 (p.t_ca + p.T_compA) * 4)

    p_sys = dataclasses.replace(p, t_i=ti_sys, n=None)
    p_app = dataclasses.replace(p, t_i=ti_app, n=None)

    aets = {
        "detection": tm.aet_strategy(p, "detection", mtbe_hours, X=X_expected),
        "multi_ckpt": tm.aet_strategy(p_sys, "multi_ckpt", mtbe_hours,
                                      k=k_expected),
        "single_ckpt": tm.aet_strategy(p_app, "single_ckpt", mtbe_hours),
    }
    best = min(aets, key=aets.get)
    level = {"detection": 1, "multi_ckpt": 2, "single_ckpt": 3}[best]
    t_i = {"detection": 0.0, "multi_ckpt": ti_sys, "single_ckpt": ti_app}[best]

    notes = []
    if p.T_prog < 4 * max(p.t_cs, p.t_ca):
        notes.append("short run: checkpointing overhead may dominate "
                     "(paper: 'if the execution is too short, checkpoints "
                     "become worthless')")

    # duplication-vs-ABFT guidance (orthogonal to the checkpoint level: the
    # abft/hybrid backends compose with L0-L3 recovery unchanged)
    abft = tm.aet_strategy(p, "abft", mtbe_hours, X=X_expected)
    mech = "abft" if abft < aets[best] else "duplication"
    if mech == "abft":
        notes.append(
            f"ABFT detection beats duplicated execution here "
            f"({abft:.2f}h vs {aets[best]:.2f}h AET): replica-free "
            f"checksummed kernels with forward correction of "
            f"{p.abft_correct_frac:.0%} of detected faults; pair with the "
            f"'hybrid' backend so escaped faults still hit the fingerprint "
            f"boundary")
    else:
        notes.append(
            "duplicated execution wins: coverage is total (any divergence) "
            "while ABFT only sees checksummed kernels; keep replication")

    # deferred-validation guidance (DESIGN.md §11): how far the per-step
    # predicate readback should lag execution. Needs the measured per-step
    # duration and host-sync cost; D=1 (classic) when unparameterized.
    lag = tm.optimal_validate_lag(p, mtbe_hours, X=X_expected)
    deferred_aet = tm.aet_deferred(p, lag, mtbe_hours, X=X_expected) \
        if lag > 1 else aets["detection"]
    if lag > 1:
        notes.append(
            f"defer validation by D={lag} steps (validate_lag): saves "
            f"{tm.deferred_sync_savings(p, lag):.3f}h of per-step syncs vs "
            f"an expected {tm.deferred_waste(p, lag):.3f}h re-executed per "
            f"fault; requires a checkpointing level (L2/L3) so rollback can "
            f"reach inside the window")

    # tiered-checkpoint guidance (DESIGN.md §12): per-tier save cadence
    # from each tier's own store cost (Daly per tier), and the hierarchy's
    # AET — rollback is served by the cheapest tier covering the detection
    # lag, so the flat-store t_r term mostly disappears
    tier_costs = tm.default_tier_costs(p)
    tier_sched = tm.optimal_tier_schedule(p, tier_costs, mtbe_hours,
                                          lag_steps=max(lag, 1))
    tiered_aet = 0.0
    if tier_sched:
        tiered_aet = tm.aet_tiered(p, tier_sched, tier_costs, mtbe_hours,
                                   X=X_expected, lag_steps=max(lag, 1))
        src = tm.restore_tier(tier_sched, tier_costs, max(lag, 1))
        notes.append(
            f"tier schedule (ckpt_tiers): device every "
            f"{tier_sched['device']} step(s), host every "
            f"{tier_sched['host']}, disk every {tier_sched['disk']}, "
            f"partner every {tier_sched['partner']} — expected restores "
            f"from the {src!r} tier, AET {tiered_aet:.2f}h vs flat-disk "
            f"{aets['multi_ckpt']:.2f}h")

    # serving guidance (DESIGN.md §13): deferred window + per-request
    # recovery scope for the continuous-batching decode loop. The per-fault
    # discard is one SLOT's window instead of the whole batch's, so the
    # optimal serving lag is at least the training one and the goodput gap
    # vs whole-batch recovery widens with the slot count.
    serve_lag = tm.optimal_serve_lag(p, mtbe_hours, serve_slots)
    serve_good = tm.serve_goodput(p, mtbe_hours, serve_slots, serve_lag,
                                  per_request=True)
    serve_good_wb = tm.serve_goodput(p, mtbe_hours, serve_slots, serve_lag,
                                     per_request=False)
    serve_avail = tm.serve_availability(p, mtbe_hours, serve_slots,
                                        serve_lag, per_request=True)
    if p.t_step > 0 and p.t_sync > 0:
        notes.append(
            f"serving ({serve_slots} slots): validate_lag D={serve_lag}, "
            f"per-request recovery goodput {serve_good:.4f} vs whole-batch "
            f"{serve_good_wb:.4f}; availability {serve_avail:.4f}")
    return Advice(
        strategy=best,
        level=level,
        t_i=t_i,
        aet_hours={k: round(v, 4) for k, v in aets.items()},
        start_checkpointing_at=tm.min_progress_for_checkpointing(p_sys),
        keep_two_checkpoints_at=tm.min_progress_for_k(p_sys, 1),
        notes="; ".join(notes),
        detection_mechanism=mech,
        abft_aet_hours=round(abft, 4),
        validate_lag=lag,
        deferred_aet_hours=round(deferred_aet, 4),
        tier_schedule=tier_sched,
        tiered_aet_hours=round(tiered_aet, 4),
        serve_validate_lag=serve_lag,
        serve_goodput=round(serve_good, 6),
        serve_goodput_whole_batch=round(serve_good_wb, 6),
        serve_availability=round(serve_avail, 6),
    )


# ---------------------------------------------------------------------------
# Degraded-mode policy — what to do with the survivors after a node loss
# (DESIGN.md §16; the spatial analogue of Sec. 4.4's rollback-vs-restart)
# ---------------------------------------------------------------------------

@dataclass
class DegradedModeDecision:
    """Outcome of `choose_degraded_mode` for one node-loss incident.

    mode: "fail_in_place" — keep running on the survivors (shrunken data
    axis, or unprotected-but-checkpointed when the lost node was the
    replica pod) and regrow when the host returns; "safe_stop" — park the
    job on its last validated checkpoint and wait for a relaunch."""

    mode: str                         # fail_in_place | safe_stop
    protection_lost: bool             # did the outage take the replica pod?
    fail_in_place_hours: float        # modeled cost of riding it out
    restart_hours: float              # modeled cost of stop-and-relaunch
    expected_faults_during_outage: float
    notes: str = ""


def choose_degraded_mode(p: tm.SedarParams, mtbe_hours: float,
                         outage_hours: float, *,
                         protection_lost: bool = False,
                         sdc_risk_budget: float = 1.0,
                         keep_degraded: bool = False) -> DegradedModeDecision:
    """Fail-in-place vs safe-stop for a node outage of `outage_hours`.

    Two gates, in order:
      1. SDC risk — when the lost node removes the replica pod, the
         survivors run WITHOUT detection; the expected number of soft
         errors during the outage (outage/MTBE) must stay under
         `sdc_risk_budget` or the only safe answer is to stop (an
         undetected fault would silently corrupt every later checkpoint).
      2. Cost — fail-in-place pays two remesh transitions (shrink+regrow)
         and, because the authoritative trajectory re-anchors at the last
         full-width checkpoint, replays the degraded span; stop-and-
         relaunch pays the outage plus a full T_rest. The cheaper side
         wins (`tm.fail_in_place_beats_restart`) — the same convenience
         rule as `rollback_beats_restart` (Eq. 14 vs Eq. 4), applied to
         space instead of time."""
    exp_faults = (outage_hours / mtbe_hours) if mtbe_hours > 0 else \
        float("inf")
    fip = tm.fail_in_place_cost(p, outage_hours, keep_degraded=keep_degraded)
    rst = tm.node_restart_cost(p, outage_hours)
    notes = []
    if protection_lost and exp_faults > sdc_risk_budget:
        notes.append(
            f"replica pod lost and expected faults during the outage "
            f"({exp_faults:.2f}) exceed the SDC risk budget "
            f"({sdc_risk_budget:.2f}): unprotected survivors would risk "
            f"silent corruption of every checkpoint cut while degraded — "
            f"safe-stop on the last validated checkpoint")
        return DegradedModeDecision(
            mode="safe_stop", protection_lost=True,
            fail_in_place_hours=fip, restart_hours=rst,
            expected_faults_during_outage=exp_faults,
            notes="; ".join(notes))
    if protection_lost:
        notes.append(
            f"replica pod lost but expected faults {exp_faults:.2f} <= "
            f"budget {sdc_risk_budget:.2f}: survivors run unprotected-but-"
            f"checkpointed; the regrown full-width replay re-validates")
    mode = "fail_in_place" if fip <= rst else "safe_stop"
    notes.append(
        f"fail-in-place {fip:.3f}h vs stop-and-relaunch {rst:.3f}h "
        f"(2×remesh vs T_rest — cf. rollback_beats_restart, Eq.14 vs Eq.4)")
    return DegradedModeDecision(
        mode=mode, protection_lost=protection_lost,
        fail_in_place_hours=fip, restart_hours=rst,
        expected_faults_during_outage=exp_faults,
        notes="; ".join(notes))


# ---------------------------------------------------------------------------
# Engine factory — the one place engines are assembled
# ---------------------------------------------------------------------------

def make_engine(sedar_cfg, *, step_fn: Optional[Callable] = None,
                recovery: Any = None,
                workdir: Optional[str] = None,
                backend: Optional[str] = None,
                state_fp_fn: Optional[Callable] = None,
                fast_state_fp_fn: Optional[Callable] = None,
                pod_step: Optional[Callable] = None,
                pod_validate: Optional[Callable] = None,
                pod_broadcaster: Optional[Callable] = None,
                n_replicas: int = 2,
                lane_hosts: Optional[Callable] = None,
                schedule: Any = None, watchdog: Any = None,
                inj_spec: Any = None, inj_flag: Any = None,
                init_fn: Optional[Callable] = None,
                notify: Optional[Callable] = None,
                delay_source: Optional[Callable[[], dict]] = None,
                slots: Optional[int] = None,
                stack: str = "rows"):
    """Assemble a `SedarEngine` for one workload.

    backend: "none" | "sequential" | "fused" | "pod" | "vote" | "abft" |
    "hybrid" (defaults to sedar_cfg.replication); all but "none" also need
    `state_fp_fn`. "pod"/"vote" take the mesh step instead of `step_fn`:
    `pod_step` and `pod_validate` (and `pod_broadcaster` for vote), with
    `n_replicas` pods and `lane_hosts` (lanes -> hosts, pod).
    "fused" steps both replicas in one launch over a state that stacks
    them: as row blocks (`stack="rows"`, serving's decode state,
    `core/engine.py::FusedSequentialExecutor`) or on a leading replica
    axis of every leaf (`stack="leading"`, a training state,
    `StackedFusedExecutor`); step_fn then follows the fused contract
    `(stacked, batch, armed) -> (candidate, fps (2, ...), aux)`.
    abft/hybrid run replica-free: step_fn may return a 4th element (an
    `abft.ref.AbftReport` from checksummed kernels), and hybrid also checks
    the commit-time state fingerprint (`fast_state_fp_fn`, default
    `state_fp_fn`) at the FSC cadence. Sequential: `state_fp_fn` is
    the per-leaf fingerprint (reports, L2 manifests, L3 validation),
    `fast_state_fp_fn` (default: the same) the FSC compare. `recovery`
    defaults to the config's (`make_recovery(sedar_cfg, workdir)`: L1, or
    L2/L3 on disk); `init_fn` builds a fresh dual state for Alg. 1's
    restart from scratch.
    `slots=N` selects the slot-granular sequential or fused executor
    (continuous serving): step_fn then returns per-slot fingerprints
    ((N, 4), or (2, N, 4) fused), and a commit mismatch is localized to
    slots and partially committed. abft/hybrid ignore `slots`."""
    from repro_torch.core.detection import Watchdog
    from repro_torch.core.recovery import make_recovery
    from repro_torch.core.engine import (BoundarySchedule,
                                         FusedSequentialExecutor,
                                         PlainExecutor, PodExecutor,
                                         SedarEngine, SequentialExecutor,
                                         SlottedFusedExecutor,
                                         StackedFusedExecutor,
                                         SlottedSequentialExecutor,
                                         VoteExecutor)

    backend = backend or sedar_cfg.replication
    schedule = schedule or BoundarySchedule.from_config(sedar_cfg)
    if recovery is None:
        recovery = make_recovery(sedar_cfg, workdir)
    if backend in ("pod", "vote"):
        if pod_step is None or pod_validate is None:
            raise ValueError(f"backend {backend!r} needs pod_step and "
                             "pod_validate")
        if backend == "vote":
            if pod_broadcaster is None:
                raise ValueError("vote backend needs pod_broadcaster")
            executor = VoteExecutor(pod_step, pod_validate, state_fp_fn,
                                    pod_broadcaster,
                                    n_replicas=max(n_replicas, 3))
        else:
            executor = PodExecutor(pod_step, pod_validate, state_fp_fn,
                                   lane_hosts=lane_hosts)
    elif backend == "none":
        executor = PlainExecutor(step_fn, state_fp_fn)
    elif backend == "sequential":
        if state_fp_fn is None:
            raise ValueError("backend 'sequential' needs state_fp_fn")
        kw = dict(fast_state_fp_fn=fast_state_fp_fn,
                  watchdog=watchdog or Watchdog(schedule.toe_timeout_s),
                  toe_timeout_s=schedule.toe_timeout_s,
                  delay_source=delay_source)
        executor = (SlottedSequentialExecutor(step_fn, state_fp_fn,
                                              n_slots=slots, **kw)
                    if slots else SequentialExecutor(step_fn, state_fp_fn,
                                                     **kw))
    elif backend == "fused":
        if state_fp_fn is None:
            raise ValueError("backend 'fused' needs state_fp_fn")
        if stack == "leading":
            executor = StackedFusedExecutor(
                step_fn, state_fp_fn, fast_state_fp_fn=fast_state_fp_fn)
        elif slots:
            executor = SlottedFusedExecutor(step_fn, state_fp_fn,
                                            n_slots=slots)
        else:
            executor = FusedSequentialExecutor(step_fn, state_fp_fn)
    elif backend in ("abft", "hybrid"):
        if state_fp_fn is None:
            raise ValueError(f"backend {backend!r} needs state_fp_fn")
        from repro_torch.abft.executor import AbftExecutor
        executor = AbftExecutor(step_fn, state_fp_fn,
                                fast_state_fp_fn=fast_state_fp_fn,
                                hybrid=(backend == "hybrid"),
                                validate_interval=schedule.validate_interval)
    else:
        raise NotImplementedError(f"backend {backend!r} is not ported yet")
    return SedarEngine(executor, schedule, recovery, inj_spec=inj_spec,
                       inj_flag=inj_flag, init_fn=init_fn, notify=notify)


def make_trainer(run_cfg, workdir: str, **kw):
    """Construct a SEDAR-protected trainer (`runtime/train.py`). Runs on the
    card unless `device="cpu"` is passed; raises when no card is present."""
    from repro_torch.runtime.train import SedarTrainer
    return SedarTrainer(run_cfg, workdir, **kw)


def make_server(run_cfg, *, dual: bool = False, inj_spec: Any = None, **kw):
    """Construct a SEDAR-protected server (`backend=` as `SedarServer`'s).
    Runs on the card unless `device="cpu"` is passed; raises when no card
    is present."""
    from repro_torch.runtime.serve import SedarServer
    return SedarServer(run_cfg, dual=dual, inj_spec=inj_spec, **kw)


# ---------------------------------------------------------------------------
# Closed-loop autotuning
# ---------------------------------------------------------------------------

@dataclass
class AutotuneConfig:
    """Knobs of the control loop itself (the meta-knobs)."""

    interval_steps: int = 16        # evaluate every N protected steps
    persistence: int = 2            # consecutive evals agreeing on a target
                                    # before it is applied (anti-flap)
    mode: str = "train"             # "train" | "serve" (which optimum)
    serve_slots: int = 8
    X_expected: float = 0.5
    min_confidence: float = 0.25    # below this the estimator stays advisory
    prior_mtbe_hours: float = 24.0
    backend: str = "sequential"     # current detection backend (for advice)
    slo_availability: Optional[float] = None   # e.g. 0.999
    slo_goodput: Optional[float] = None


def autotune(engine, snapshot, *, mode: str = "train", serve_slots: int = 8,
             X: float = 0.5, lag: Optional[int] = None,
             reason: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """One-shot re-plan: recompute the optimal knobs from a calibrated
    snapshot (`obs.OnlineEstimator.calibrated_params()`) and apply them via
    `engine.apply_reconfig()`. Returns the reconfig record, or None when
    nothing changed / the engine is mid-window (caller retries at the next
    flush boundary)."""
    p, mtbe = snapshot.params, snapshot.mtbe_hours
    if lag is None:
        lag = (tm.optimal_serve_lag(p, mtbe, serve_slots)
               if mode == "serve"
               else tm.optimal_validate_lag(p, mtbe, X=X))
    tier_schedule = None
    tiers = getattr(engine.recovery, "tiers", None)
    if tiers is not None:
        sched = tm.optimal_tier_schedule(p, snapshot.tier_costs, mtbe,
                                         lag_steps=max(lag, 1))
        if sched:
            from repro_torch.checkpoint.tiers import TierSchedule
            cur = tiers.schedule
            # only retune cadences of tiers the run enabled — the tuner
            # must not conjure a partner store the launcher never set up
            tier_schedule = TierSchedule(**{
                t: (int(sched.get(t, 0)) if cur.interval(t) > 0 else 0)
                for t in ("device", "host", "disk", "partner")})
    if reason is None:
        reason = (f"autotune[{mode}]: mtbe={mtbe:.4g}h "
                  f"t_step={p.t_step:.4g}h t_sync={p.t_sync:.4g}h "
                  f"confidence={snapshot.confidence:.2f}")
    return engine.apply_reconfig(validate_lag=lag,
                                 tier_schedule=tier_schedule, reason=reason)


class Autotuner:
    """Periodic estimate → detect → re-advise → reconfigure loop.

    Call `maybe_tune(engine, step)` after every protected step; it is a
    no-op except every `interval_steps`, and even then it only reads
    host-side aggregates (registry histograms, journal records) — never a
    device buffer — so the zero-extra-hostsync contract is untouched
    (asserted in tests via `count_transfers`).

    Safety: knob changes go through `engine.apply_reconfig()` (clean
    deferred-flush boundaries only, engine clamps re-applied) and are
    double-gated here by an estimator-confidence floor and a persistence
    count — the tuner must see the SAME target on `persistence`
    consecutive evaluations before acting, so estimation noise cannot
    flap the window. One exception: when the fault-rate change-point
    detector fires, the environment shift is CONFIRMED (not noise — the
    exact case persistence exists to filter), so the next retarget skips
    the persistence wait and lands at the first clean boundary. Backend
    advice (duplication vs ABFT) is surfaced as an advisory alert only:
    swapping executors mid-run would rebuild the step.
    """

    def __init__(self, base_params: tm.SedarParams,
                 cfg: Optional[AutotuneConfig] = None):
        from repro_torch.obs.alerts import AlertManager, SloTracker
        from repro_torch.obs.anomaly import AnomalyMonitor
        from repro_torch.obs.estimator import OnlineEstimator
        self.cfg = cfg or AutotuneConfig()
        self.estimator = OnlineEstimator(
            base_params, prior_mtbe_hours=self.cfg.prior_mtbe_hours)
        self.monitor = AnomalyMonitor()
        self.alerts = AlertManager()
        self.slos = []
        if self.cfg.slo_availability:
            self.slos.append(SloTracker("availability",
                                        self.cfg.slo_availability))
        if self.cfg.slo_goodput:
            self.slos.append(SloTracker("goodput", self.cfg.slo_goodput))
        self.evaluations = 0
        self._pending_target: Optional[int] = None
        self._pending_count = 0
        self._last_det_count = 0
        self._burst = False     # fault-rate change-point fired: the next
                                # retarget skips the persistence wait

    # -- the periodic tick ---------------------------------------------------

    def maybe_tune(self, engine, step: int) -> Optional[Dict[str, Any]]:
        cfg = self.cfg
        if step <= 0 or step % cfg.interval_steps != 0:
            return None
        from repro_torch import obs
        self.evaluations += 1
        self.estimator.ingest(
            obs.metrics if obs.metrics_enabled() else None,
            obs.get_journal())
        snap = self.estimator.calibrated_params()
        self._watch(engine, step, snap)
        if snap.confidence < cfg.min_confidence:
            return None
        return self._retune(engine, step, snap)

    # -- drift / SLO surveillance -------------------------------------------

    def _watch(self, engine, step: int, snap) -> None:
        from repro_torch.obs.alerts import Alert
        cfg, p = self.cfg, snap.params
        fired = []
        if p.t_step > 0:
            fired += self.monitor.update("step_time", p.t_step)
        if p.t_sync > 0:
            fired += self.monitor.update("sync_time", p.t_sync)
        disk = snap.tier_costs.get("disk")
        if disk is not None and snap.sample_counts.get("tier_save_disk"):
            fired += self.monitor.update("checkpoint_cost", disk.t_save)
        # fault-rate bursts: detections per evaluation window
        ndet = snap.sample_counts.get("detections", 0)
        new_det = ndet - self._last_det_count
        self._last_det_count = ndet
        fired += self.monitor.update("fault_rate", float(new_det))
        if any(a["stream"] == "fault_rate" for a in fired):
            self._burst = True
        # SLO burn: the replay proxy — a fault discards up to lag/2 of the
        # window's steps, so delivered fraction over this interval is
        # 1 - faults*(lag/2)/interval (floored at 0)
        lag = max(engine.validate_lag, 1)
        good = max(0.0, 1.0 - new_det * (lag / 2.0) / cfg.interval_steps)
        for slo in self.slos:
            alert = slo.update(step, good)
            if alert is not None:
                self.alerts.emit(alert)
        # journal-vs-prediction divergence: observed delivered fraction
        # against what the calibrated model predicts at this lag
        if p.t_step > 0 and p.t_sync > 0:
            pred = tm.serve_availability(p, snap.mtbe_hours,
                                         max(cfg.serve_slots, 1), lag)
            fired += self.monitor.update("kpi_divergence", good - pred)
        for a in fired:
            self.alerts.emit(Alert(
                name=f"{a['stream']}_drift", severity="warning", step=step,
                message=(f"{a['stream']} drift flagged by {a['detector']} "
                         f"at value {a['value']:.6g}"),
                detail=dict(a)))

    # -- re-advise + apply ---------------------------------------------------

    def _retune(self, engine, step: int, snap) -> Optional[Dict[str, Any]]:
        cfg = self.cfg
        self._advise_backend(step, snap)
        p, mtbe = snap.params, snap.mtbe_hours
        target = (tm.optimal_serve_lag(p, mtbe, cfg.serve_slots)
                  if cfg.mode == "serve"
                  else tm.optimal_validate_lag(p, mtbe, X=cfg.X_expected))
        if target == engine.validate_lag:
            self._pending_target, self._pending_count = None, 0
            self._burst = False
            return None
        if target == self._pending_target:
            self._pending_count += 1
        else:
            self._pending_target, self._pending_count = target, 1
        if self._pending_count < cfg.persistence and not self._burst:
            return None
        if engine.pending_validation:
            # mid-window: keep the pending vote, retry at the next eval
            # (the engine would refuse anyway; this keeps hysteresis state)
            return None
        rec = autotune(engine, snap, mode=cfg.mode,
                       serve_slots=cfg.serve_slots, X=cfg.X_expected,
                       lag=target)
        if rec is not None:
            self._pending_target, self._pending_count = None, 0
            self._burst = False
        return rec

    def _advise_backend(self, step: int, snap) -> None:
        from repro_torch.obs.alerts import Alert
        cfg, p = self.cfg, snap.params
        dup = tm.aet_strategy(p, "detection", snap.mtbe_hours,
                              X=cfg.X_expected)
        abft = tm.aet_strategy(p, "abft", snap.mtbe_hours, X=cfg.X_expected)
        abft_wins = abft < dup
        using_abft = cfg.backend in ("abft", "hybrid")
        if abft_wins != using_abft:
            better, worse = ("abft", dup) if abft_wins else ("duplication",
                                                             abft)
            self.alerts.emit(Alert(
                name="backend_advice", severity="info", step=step,
                message=(f"calibrated model prefers {better} detection "
                         f"(AET {min(dup, abft):.4g}h vs {worse:.4g}h) — "
                         f"advisory only; restart with the recommended "
                         f"backend to apply"),
                detail={"current": cfg.backend,
                        "recommended": better,
                        "aet_duplication_h": round(dup, 6),
                        "aet_abft_h": round(abft, 6)}))
