"""Online temporal-model calibration from live telemetry (DESIGN.md §17).

The paper's Section-7 model predicts every strategy's cost from a handful
of parameters — step time, sync cost, per-tier checkpoint costs, MTBE, SDC
mix — that the registry and journal already *measure*. This module
closes the gap: `OnlineEstimator` folds the live streams into a calibrated
`SedarParams`/`TierCosts` snapshot the autotuner can re-plan from (Aupy et
al.'s optimal verification cadence is a closed-form function of exactly
these quantities).

Two intake paths, same accumulators:

  * ``ingest(metrics, journal)`` — pull deltas since the last call from
    the stage-duration histograms (count/total per stage label) and the
    journal (records past the last seen seq). This is what the Autotuner
    calls between steps; it reads ONLY host-side aggregates the engine
    already produced, so the zero-extra-hostsync contract holds trivially.
  * ``observe_*`` — direct push for benches/tests that synthesize streams
    without a running engine.

Estimates are EWMA-smoothed with a sliding window for dispersion; MTBE is
the smoothed inter-detection gap with a Bayesian-style prior so a
fault-free stretch decays toward "rarer than observed horizon" instead of
jumping to infinity.

Pure Python + `repro_torch.core.temporal_model` (also pure), like the
rest of `repro_torch.obs`.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, Optional

from repro_torch.core.temporal_model import SedarParams, TierCosts, \
    default_tier_costs

S_PER_H = 3600.0

# stage-duration labels (obs.span names) feeding each estimate
STEP_STAGES = ("train_step", "decode_tick")
SYNC_STAGE = "deferred_flush"
TIER_STAGES = ("device", "host", "disk", "partner")


class _Ewma:
    """EWMA mean + a bounded sliding window for variance/extremes."""

    __slots__ = ("alpha", "mean", "n", "window")

    def __init__(self, alpha: float = 0.2, window: int = 256):
        self.alpha = float(alpha)
        self.mean: Optional[float] = None
        self.n = 0
        self.window: Deque[float] = deque(maxlen=window)

    def add(self, x: float, weight: int = 1) -> None:
        x = float(x)
        for _ in range(max(int(weight), 1)):
            self.mean = (x if self.mean is None
                         else self.alpha * x + (1 - self.alpha) * self.mean)
            self.n += 1
        self.window.append(x)

    def std(self) -> float:
        if len(self.window) < 2:
            return 0.0
        m = sum(self.window) / len(self.window)
        return math.sqrt(sum((v - m) ** 2 for v in self.window)
                         / (len(self.window) - 1))


@dataclass(frozen=True)
class CalibratedSnapshot:
    """One self-consistent calibration the control loop can plan from."""

    params: SedarParams                 # base params with measured overrides
    tier_costs: Dict[str, TierCosts]
    mtbe_hours: float
    sdc_fraction: float                 # detections that were SDCs (vs hangs)
    sample_counts: Dict[str, int] = field(default_factory=dict)
    confidence: float = 0.0             # 0..1, saturating in sample count

    def is_confident(self, floor: float = 0.5) -> bool:
        return self.confidence >= floor


class OnlineEstimator:
    """Fits SedarParams/TierCosts online from metrics + journal streams.

    ``base`` supplies every parameter telemetry cannot see (T_rest, f_d,
    redundancy_wall, ...); the snapshot overrides only what was measured
    (`t_step`, `t_sync`, tier save/restore costs). ``prior_mtbe_hours``
    anchors the failure-rate estimate until enough detections arrive —
    with ``n`` observed gaps the estimate is ``(elapsed + prior) /
    (n + 1)``, i.e. one pseudo-observation of the prior.
    """

    # confidence saturates once this many step samples have been seen
    CONF_STEPS = 64

    def __init__(self, base: SedarParams,
                 prior_mtbe_hours: float = 24.0,
                 alpha: float = 0.2, window: int = 256):
        self.base = base
        self.prior_mtbe_hours = float(prior_mtbe_hours)
        self._step_s = _Ewma(alpha, window)
        self._sync_s = _Ewma(alpha, window)
        self._tier_save_s = {t: _Ewma(alpha, window) for t in TIER_STAGES}
        self._tier_restore_s = {t: _Ewma(alpha, window) for t in TIER_STAGES}
        self._gap_s = _Ewma(alpha, window)
        self._n_gaps = 0
        self._n_detections = 0
        self._n_sdc = 0
        self._last_det_t: Optional[float] = None
        self._elapsed_s = 0.0
        # ingest cursors
        self._hist_seen: Dict[Any, tuple] = {}
        self._journal_seq = -1

    # -- direct push (benches/tests) ----------------------------------------

    def observe_step_s(self, seconds: float, weight: int = 1) -> None:
        self._step_s.add(seconds, weight)
        self._elapsed_s += float(seconds) * max(int(weight), 1)

    def observe_sync_s(self, seconds: float, weight: int = 1) -> None:
        self._sync_s.add(seconds, weight)

    def observe_tier_save_s(self, tier: str, seconds: float) -> None:
        if tier in self._tier_save_s:
            self._tier_save_s[tier].add(seconds)

    def observe_tier_restore_s(self, tier: str, seconds: float) -> None:
        if tier in self._tier_restore_s:
            self._tier_restore_s[tier].add(seconds)

    def observe_fault(self, t_s: float, sdc: bool = True) -> None:
        """A detection at monotonic offset ``t_s`` (journal t_mono)."""
        self._n_detections += 1
        if sdc:
            self._n_sdc += 1
        if self._last_det_t is not None and t_s > self._last_det_t:
            self._gap_s.add(t_s - self._last_det_t)
            self._n_gaps += 1
        self._last_det_t = t_s

    # -- pull path: registry histograms + journal ---------------------------

    def ingest(self, metrics=None, journal=None) -> None:
        """Fold in everything new since the last ingest.

        ``metrics`` is a MetricsRegistry whose `sedar_stage_duration_seconds`
        histograms carry per-stage (count, total); deltas since the last
        call are attributed at the per-stage mean. ``journal`` is a
        FaultJournal (or a plain record list) scanned past the last seen
        seq for detections and tier restores.
        """
        if metrics is not None:
            for labels in metrics.labels_of("sedar_stage_duration_seconds"):
                stage = labels.get("stage", "")
                h = metrics.get_histogram("sedar_stage_duration_seconds",
                                          **labels)
                if h is None:
                    continue
                key = tuple(sorted(labels.items()))
                seen_c, seen_t = self._hist_seen.get(key, (0, 0.0))
                dc, dt = h.count - seen_c, h.total - seen_t
                self._hist_seen[key] = (h.count, h.total)
                if dc <= 0:
                    continue
                mean = dt / dc
                if stage in STEP_STAGES:
                    self.observe_step_s(mean, weight=dc)
                elif stage == SYNC_STAGE:
                    self.observe_sync_s(mean, weight=dc)
                elif stage == "checkpoint":
                    # engine-level span; per-tier costs arrive via the
                    # journal's tier_restore lines and the tier-labeled
                    # histograms when present
                    self.observe_tier_save_s("disk", mean)
        if journal is not None:
            recs = journal.records() if hasattr(journal, "records") \
                else list(journal)
            for rec in recs:
                if rec.get("seq", -1) <= self._journal_seq:
                    continue
                self._journal_seq = max(self._journal_seq,
                                        rec.get("seq", -1))
                kind = rec.get("kind")
                if kind == "detection":
                    ev = rec.get("event", {})
                    self.observe_fault(
                        float(rec.get("t_mono", 0.0)),
                        sdc=(ev.get("effect") != "hang"))

    # -- estimates ----------------------------------------------------------

    def mtbe_hours(self) -> float:
        """Smoothed MTBE with a one-pseudo-observation prior."""
        if self._n_gaps >= 2 and self._gap_s.mean:
            return self._gap_s.mean / S_PER_H
        elapsed_h = self._elapsed_s / S_PER_H
        return (elapsed_h + self.prior_mtbe_hours) / (self._n_detections + 1)

    def calibrated_params(self) -> CalibratedSnapshot:
        p = self.base
        over = {}
        if self._step_s.mean:
            over["t_step"] = self._step_s.mean / S_PER_H
        if self._sync_s.mean:
            over["t_sync"] = self._sync_s.mean / S_PER_H
        if over:
            p = dataclasses.replace(p, **over)
        costs = dict(default_tier_costs(p))
        for tier in TIER_STAGES:
            save, rest = self._tier_save_s[tier], self._tier_restore_s[tier]
            if save.mean or rest.mean:
                cur = costs[tier]
                costs[tier] = TierCosts(
                    t_save=(save.mean / S_PER_H if save.mean
                            else cur.t_save),
                    t_restore=(rest.mean / S_PER_H if rest.mean
                               else cur.t_restore),
                    slots=cur.slots)
        counts = {
            "step": self._step_s.n, "sync": self._sync_s.n,
            "detections": self._n_detections, "gaps": self._n_gaps,
            **{f"tier_save_{t}": self._tier_save_s[t].n
               for t in TIER_STAGES if self._tier_save_s[t].n},
        }
        conf = min(1.0, self._step_s.n / float(self.CONF_STEPS))
        if self._sync_s.n == 0:
            conf *= 0.5        # t_sync still the prior — halve confidence
        return CalibratedSnapshot(
            params=p, tier_costs=costs, mtbe_hours=self.mtbe_hours(),
            sdc_fraction=(self._n_sdc / self._n_detections
                          if self._n_detections else 1.0),
            sample_counts=counts, confidence=conf)
