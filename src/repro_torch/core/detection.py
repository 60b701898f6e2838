"""Detection machinery, host side (the reference's `core/detection.py`):
the detection event, the L1 safe-stop exception and the TOE watchdog
(paper Sec. 3.1). The mesh comparators wait for the port of the mesh
backends.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class DetectionEvent:
    step: int
    boundary: str            # commit | validate | toe | final
    effect: str = ""         # TDC | FSC | TOE (classification, best effort)
    detail: Dict[str, Any] = field(default_factory=dict)

    def __str__(self):
        return (f"[SEDAR] fault detected at step {self.step} "
                f"(boundary={self.boundary}{', ' + self.effect if self.effect else ''})")


class SedarSafeStop(RuntimeError):
    """L1: notification + safe stop (paper Sec. 3.1)."""

    def __init__(self, event: DetectionEvent):
        super().__init__(str(event))
        self.event = event


class Watchdog:
    """Per-replica heartbeat monitor: `check()` flags replicas whose last
    beat is older than `timeout_s` (the paper's configurable-lapse TOE
    detector)."""

    def __init__(self, timeout_s: float, n_replicas: int = 2):
        self.timeout_s = timeout_s
        self.last_beat: Dict[int, float] = {r: time.monotonic()
                                            for r in range(n_replicas)}
        self.step_time: Dict[int, float] = {}
        # per-replica wall-clock separation needs a device sync after each
        # replica launch; executors only pay it while the watchdog is armed
        self.armed: bool = False

    def arm(self) -> None:
        self.armed = True

    def disarm(self) -> None:
        self.armed = False

    def beat(self, replica: int, step: int) -> None:
        now = time.monotonic()
        prev = self.last_beat.get(replica, now)
        self.last_beat[replica] = now
        self.step_time[replica] = now - prev

    def stale(self) -> List[int]:
        now = time.monotonic()
        return [r for r, t in self.last_beat.items()
                if now - t > self.timeout_s]

    def skew(self) -> float:
        """Max pairwise difference of last-beat times (replica flow
        separation)."""
        ts = list(self.last_beat.values())
        return max(ts) - min(ts) if len(ts) > 1 else 0.0

    def check(self, step: int) -> Optional[DetectionEvent]:
        bad = self.stale()
        if bad:
            return DetectionEvent(step=step, boundary="toe", effect="TOE",
                                  detail={"stale_replicas": bad,
                                          "timeout_s": self.timeout_s})
        return None
