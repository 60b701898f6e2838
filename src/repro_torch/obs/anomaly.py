"""Streaming drift/anomaly detectors over the telemetry streams.

Three classical detectors, each O(1) state per stream (DESIGN.md §17):

  * :class:`EwmaBand` — point anomalies: flag |x - ewma| > k·std after a
    warmup. Catches step-time spikes (straggler onset) and checkpoint-cost
    outliers.
  * :class:`PageHinkley` — sustained mean shift in one direction; the
    standard change-point test for "the step time has drifted up and
    stayed there".
  * :class:`Cusum` — two-sided cumulative-sum test; catches slower drifts
    than the band and recovers automatically after reset.

:class:`AnomalyMonitor` owns one detector set per named stream and turns
raw samples into structured anomaly dicts the AlertManager converts to
journaled alerts. Pure Python.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional


class EwmaBand:
    """EWMA mean/variance band: anomaly when |x - mean| > k * std."""

    def __init__(self, alpha: float = 0.2, k: float = 4.0,
                 warmup: int = 8):
        self.alpha = float(alpha)
        self.k = float(k)
        self.warmup = int(warmup)
        self.mean: Optional[float] = None
        self.var = 0.0
        self.n = 0

    def update(self, x: float) -> bool:
        x = float(x)
        self.n += 1
        if self.mean is None:
            self.mean = x
            return False
        dev = x - self.mean
        std = math.sqrt(self.var)
        anomalous = (self.n > self.warmup and std > 0.0
                     and abs(dev) > self.k * std)
        if not anomalous:
            # anomalies are excluded from the estimate so a spike does not
            # widen its own band
            self.mean += self.alpha * dev
            self.var = (1 - self.alpha) * (self.var + self.alpha * dev * dev)
        return anomalous


class PageHinkley:
    """One-sided Page-Hinkley mean-shift test (upward by default)."""

    def __init__(self, delta: float = 0.005, threshold: float = 0.5,
                 direction: int = +1):
        self.delta = float(delta)
        self.threshold = float(threshold)
        self.direction = 1 if direction >= 0 else -1
        self.mean = 0.0
        self.n = 0
        self.cum = 0.0
        self.cum_min = 0.0

    def update(self, x: float) -> bool:
        x = float(x) * self.direction
        self.n += 1
        self.mean += (x - self.mean) / self.n
        self.cum += x - self.mean - self.delta
        self.cum_min = min(self.cum_min, self.cum)
        if self.cum - self.cum_min > self.threshold:
            self.reset()
            return True
        return False

    def reset(self) -> None:
        self.mean = 0.0
        self.n = 0
        self.cum = 0.0
        self.cum_min = 0.0


class Cusum:
    """Two-sided CUSUM around a reference mean (first `warmup` samples)."""

    def __init__(self, k: float = 0.5, h: float = 5.0, warmup: int = 8):
        self.k = float(k)          # slack, in reference-std units
        self.h = float(h)          # decision threshold, in std units
        self.warmup = int(warmup)
        self._ref: List[float] = []
        self.mean = 0.0
        self.std = 0.0
        self.pos = 0.0
        self.neg = 0.0

    def update(self, x: float) -> bool:
        x = float(x)
        if len(self._ref) < self.warmup:
            self._ref.append(x)
            if len(self._ref) == self.warmup:
                self.mean = sum(self._ref) / len(self._ref)
                var = (sum((v - self.mean) ** 2 for v in self._ref)
                       / max(len(self._ref) - 1, 1))
                self.std = math.sqrt(var) or abs(self.mean) * 0.05 or 1e-9
            return False
        z = (x - self.mean) / self.std
        self.pos = max(0.0, self.pos + z - self.k)
        self.neg = max(0.0, self.neg - z - self.k)
        if self.pos > self.h or self.neg > self.h:
            self.pos = self.neg = 0.0
            return True
        return False


class AnomalyMonitor:
    """Named streams, each watched by a band + a change-point detector.

    ``update(stream, value)`` returns the (possibly empty) list of anomaly
    dicts fired by this sample: ``{"stream", "detector", "value"}``.
    Streams are created lazily with shared default thresholds; tune one
    with ``configure(stream, ...)`` before its first sample.
    """

    def __init__(self):
        self._bands: Dict[str, EwmaBand] = {}
        self._cusums: Dict[str, Cusum] = {}
        self._cfg: Dict[str, dict] = {}
        self.fired: List[dict] = []

    def configure(self, stream: str, *, band_k: float = 4.0,
                  cusum_k: float = 0.5, cusum_h: float = 5.0,
                  warmup: int = 8) -> None:
        self._cfg[stream] = dict(band_k=band_k, cusum_k=cusum_k,
                                 cusum_h=cusum_h, warmup=warmup)

    def _ensure(self, stream: str) -> None:
        if stream in self._bands:
            return
        cfg = self._cfg.get(stream, {})
        self._bands[stream] = EwmaBand(
            k=cfg.get("band_k", 4.0), warmup=cfg.get("warmup", 8))
        self._cusums[stream] = Cusum(
            k=cfg.get("cusum_k", 0.5), h=cfg.get("cusum_h", 5.0),
            warmup=cfg.get("warmup", 8))

    def update(self, stream: str, value: float) -> List[dict]:
        self._ensure(stream)
        out = []
        if self._bands[stream].update(value):
            out.append({"stream": stream, "detector": "ewma_band",
                        "value": float(value)})
        if self._cusums[stream].update(value):
            out.append({"stream": stream, "detector": "cusum",
                        "value": float(value)})
        self.fired.extend(out)
        return out
