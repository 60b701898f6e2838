"""Structured alerts + SLO burn-rate windows (DESIGN.md §17).

:class:`AlertManager` converts anomaly-monitor firings and SLO burns into
:class:`Alert` records: deduplicated (a held-down condition re-alerts only
after ``min_interval_steps``), counted in the registry
(``sedar_alerts_total{name,severity}``) and journaled as ``alert`` lines
whose ``record`` payload reconstructs byte-for-byte via
``journal.reconcile(..., alerts=mgr.records)``.

:class:`SloTracker` implements the standard multi-window burn-rate rule:
an error budget (1 - target) is "burning" when BOTH a fast and a slow
sliding window exceed their burn-rate thresholds — the fast window makes
the alert responsive, the slow window keeps one bad sample from paging.
Targets come from `policy.advise` predictions (availability/goodput).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional


@dataclass(frozen=True)
class Alert:
    name: str                   # e.g. "step_time_drift", "slo_availability"
    severity: str               # "info" | "warning" | "critical"
    step: int
    message: str
    detail: Dict[str, Any] = field(default_factory=dict)

    def record(self) -> Dict[str, Any]:
        return {"name": self.name, "severity": self.severity,
                "step": int(self.step), "message": self.message,
                "detail": dict(self.detail)}


class AlertManager:
    """Dedup + journal + count. ``records`` mirrors every journaled alert
    payload in order, so reconcile() can verify the byte-for-byte
    round trip."""

    def __init__(self, min_interval_steps: int = 16):
        self.min_interval_steps = int(min_interval_steps)
        self.records: List[Dict[str, Any]] = []
        self._last_step: Dict[str, int] = {}

    def emit(self, alert: Alert) -> bool:
        """Returns True when the alert was actually emitted (not deduped)."""
        last = self._last_step.get(alert.name)
        if last is not None and \
                alert.step - last < self.min_interval_steps:
            return False
        self._last_step[alert.name] = alert.step
        from repro_torch import obs
        from repro_torch.obs.journal import _jsonable
        rec = _jsonable(alert.record())
        self.records.append(rec)
        obs.note_alert(rec)
        return True


class SloTracker:
    """Multi-window burn-rate tracking for one objective.

    ``update(step, good)`` feeds one sample of the objective (1.0 = fully
    meeting it, 0.0 = fully failing; fractional for goodput-style
    objectives) and returns an :class:`Alert` when both windows burn.
    Burn rate = (observed error rate) / (budget = 1 - target); the classic
    page rule is fast_burn ≈ 14 with a small fast window and slow_burn ≈ 2
    over a much longer one.
    """

    def __init__(self, name: str, target: float,
                 fast_window: int = 32, slow_window: int = 256,
                 fast_burn: float = 14.0, slow_burn: float = 2.0):
        self.name = name
        self.target = float(target)
        self.budget = max(1.0 - self.target, 1e-9)
        self.fast: Deque[float] = deque(maxlen=int(fast_window))
        self.slow: Deque[float] = deque(maxlen=int(slow_window))
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)

    def _burn(self, window: Deque[float]) -> float:
        if not window:
            return 0.0
        err = sum(1.0 - g for g in window) / len(window)
        return err / self.budget

    def update(self, step: int, good: float) -> Optional[Alert]:
        good = min(max(float(good), 0.0), 1.0)
        self.fast.append(good)
        self.slow.append(good)
        fb, sb = self._burn(self.fast), self._burn(self.slow)
        if len(self.fast) == self.fast.maxlen and \
                fb >= self.fast_burn and sb >= self.slow_burn:
            return Alert(
                name=f"slo_{self.name}", severity="critical", step=step,
                message=(f"{self.name} SLO burning: fast burn {fb:.1f}x "
                         f"(>= {self.fast_burn:g}), slow burn {sb:.1f}x "
                         f"(>= {self.slow_burn:g}) against target "
                         f"{self.target:g}"),
                detail={"fast_burn": round(fb, 3), "slow_burn": round(sb, 3),
                        "target": self.target})
        return None
