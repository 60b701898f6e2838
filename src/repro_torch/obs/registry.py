"""Process-wide metrics registry: counters / gauges / histograms with labels.

This is the single sink that absorbs the repo's three ad-hoc counting hooks
(`hostsync.count_transfers`, `prefill.count_compiles`,
`checkpoint.store.count_disk_reads`) plus every engine-level event counter
(detections, recoveries, rollbacks, rejections, per-tier checkpoint
saves/restores). The old context managers stay as thin compatibility shims
for scoped assertions; the registry is the PROCESS-WIDE, CROSS-THREAD view.

Design constraints (DESIGN.md §15):

  * **Metrics-off is a no-op.** The registry starts disabled; the producer
    hooks installed into hostsync/prefill/store are `None` until
    `enable()` runs, so the disabled fast path is one `is None` test —
    nothing allocates, nothing locks. Benchmarks assert < 3% overhead for
    the ENABLED path (`bench_observability.py`).
  * **Cross-thread aggregation is explicit.** Every mutation takes the
    registry lock, so counts from a background consumer thread (the
    ROADMAP's detokenize-drain item) aggregate correctly — unlike the
    `TransferStats` shim, which is thread-local BY DESIGN and documents
    that choice with a test (tests/test_obs.py).
  * **Zero extra host syncs.** The registry only ever records host-side
    facts that already exist (a label string, an event dict, a wall
    clock); no producer hook may issue a device readback.

`percentile(values, q)` is the repo's one shared nearest-rank percentile
(matches `numpy.percentile(..., method="inverted_cdf")`); the scheduler's
TTFT/latency reports and the bench harness use it instead of hand-rolled
index formulas.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# Bounded per-histogram sample buffer: enough for smoke-scale percentile
# reporting without unbounded growth on long runs (old samples are dropped
# FIFO; count/sum/min/max stay exact).
HIST_MAX_SAMPLES = 4096

# Default cumulative-bucket ladder: 1-2.5-5 decades from 1ms-scale to
# 1000-scale, covering both seconds-valued spans and ms-valued latency
# histograms with one generic ladder. Override per-metric with
# `MetricsRegistry.set_buckets` before the first observe.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   500.0, 1000.0)


def percentile(values: Iterable[float], q: float) -> float:
    """Nearest-rank percentile (the one percentile implementation).

    rank = ceil(q/100 * N) clamped to [1, N]; returns values[rank-1] of the
    sorted list. Matches ``numpy.percentile(values, q,
    method="inverted_cdf")`` (property-tested in tests/test_obs.py), which
    makes p50 a true median draw and p99 clamp to the max for small N —
    the two corners the previous per-call-site formulas disagreed on.
    """
    vals = sorted(values)
    if not vals:
        return 0.0
    n = len(vals)
    rank = math.ceil((float(q) / 100.0) * n)
    return float(vals[min(max(rank, 1), n) - 1])


class _Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class _Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class _Histogram:
    __slots__ = ("count", "total", "vmin", "vmax", "samples",
                 "buckets", "bucket_counts")

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.samples: List[float] = []
        # bucket_counts[i] counts observations <= buckets[i] (per-bucket,
        # not cumulative; exposition cumulates). Exact even after the
        # sample buffer drops old values FIFO.
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.bucket_counts = [0] * len(self.buckets)

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.vmin = min(self.vmin, value)
        self.vmax = max(self.vmax, value)
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                self.bucket_counts[i] += 1
                break
        self.samples.append(value)
        if len(self.samples) > HIST_MAX_SAMPLES:
            del self.samples[: len(self.samples) - HIST_MAX_SAMPLES]

    def quantile(self, q: float) -> float:
        return percentile(self.samples, q)

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """[(upper_bound, cumulative_count)] — Prometheus `le` semantics;
        the implicit +Inf bucket (== count) is appended by the renderer."""
        out, acc = [], 0
        for ub, c in zip(self.buckets, self.bucket_counts):
            acc += c
            out.append((ub, acc))
        return out


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Lock-protected, label-aware metric store.

    One registry per process (`repro_torch.obs.metrics`); mutation from any
    thread is safe and aggregates into the same series. Names follow the
    Prometheus convention (`*_total` counters, unit-suffixed gauges/
    histograms); the full catalog lives in DESIGN.md §15.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._kinds: Dict[str, str] = {}
        self._series: Dict[Tuple[str, LabelKey], object] = {}
        self._buckets: Dict[str, Tuple[float, ...]] = {}

    # -- internals -----------------------------------------------------------

    def _get(self, kind: str, name: str, labels: Dict[str, object]):
        prev = self._kinds.setdefault(name, kind)
        if prev != kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{prev}, not {kind}")
        key = (name, _label_key(labels))
        m = self._series.get(key)
        if m is None:
            if kind == "histogram":
                m = _Histogram(self._buckets.get(name, DEFAULT_BUCKETS))
            else:
                m = {"counter": _Counter, "gauge": _Gauge}[kind]()
            self._series[key] = m
        return m

    def set_buckets(self, name: str, buckets: Iterable[float]) -> None:
        """Pin a histogram's bucket ladder; must precede the first observe
        (existing series keep the ladder they were created with)."""
        with self._lock:
            self._buckets[name] = tuple(sorted(float(b) for b in buckets))

    # -- producers -----------------------------------------------------------

    def inc(self, name: str, value: float = 1, **labels) -> None:
        with self._lock:
            self._get("counter", name, labels).value += value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._get("gauge", name, labels).value = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._get("histogram", name, labels).observe(float(value))

    # -- consumers -----------------------------------------------------------

    def get(self, name: str, **labels) -> float:
        """Current value of a counter/gauge series (0.0 when unseen)."""
        with self._lock:
            m = self._series.get((name, _label_key(labels)))
            return float(m.value) if m is not None else 0.0

    def get_histogram(self, name: str, **labels) -> Optional[_Histogram]:
        with self._lock:
            m = self._series.get((name, _label_key(labels)))
            return m if isinstance(m, _Histogram) else None

    def labels_of(self, name: str) -> List[Dict[str, str]]:
        with self._lock:
            return [dict(lk) for (n, lk) in self._series if n == name]

    def snapshot(self) -> Dict[str, Dict[LabelKey, float]]:
        """{name: {label_key: value}} for counters/gauges (histograms
        surface their count)."""
        out: Dict[str, Dict[LabelKey, float]] = {}
        with self._lock:
            for (name, lk), m in self._series.items():
                val = m.count if isinstance(m, _Histogram) else m.value
                out.setdefault(name, {})[lk] = float(val)
        return out

    def reset(self) -> None:
        with self._lock:
            self._kinds.clear()
            self._series.clear()
            self._buckets.clear()

    # -- Prometheus text exposition ------------------------------------------

    def render_prometheus(self) -> str:
        """Prometheus-style text snapshot (`--metrics-dir` writes this as
        metrics.prom; the launchers print it after a run). Histograms render
        as cumulative le-labeled `_bucket` lines (with the implicit `+Inf`
        bucket) plus `_sum`/`_count` — the real Prometheus histogram
        exposition, scrapeable and `parse_prometheus`-round-trippable."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._kinds):
                kind = self._kinds[name]
                lines.append(f"# TYPE {name} "
                             f"{'histogram' if kind == 'histogram' else kind}")
                series = sorted((lk, m) for (n, lk), m in
                                self._series.items() if n == name)
                for lk, m in series:
                    lab = ",".join(f'{k}="{v}"' for k, v in lk)
                    if kind == "histogram":
                        blab = (lab + "," if lab else "")
                        for ub, cum in m.cumulative_buckets():
                            lines.append(
                                f"{name}_bucket{{{blab}le=\"{ub:g}\"}} "
                                f"{cum}")
                        lines.append(
                            f"{name}_bucket{{{blab}le=\"+Inf\"}} {m.count}")
                        lines.append(f"{name}_sum"
                                     f"{'{' + lab + '}' if lab else ''} "
                                     f"{m.total:g}")
                        lines.append(f"{name}_count"
                                     f"{'{' + lab + '}' if lab else ''} "
                                     f"{m.count}")
                    else:
                        body = f"{{{lab}}}" if lab else ""
                        lines.append(f"{name}{body} {m.value:g}")
        return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus(text: str):
    """Parse the text exposition back into structured samples.

    Returns ``(types, samples)`` where ``types`` maps metric family name to
    its declared kind and ``samples`` maps sample name (including
    ``_bucket``/``_sum``/``_count`` suffixes) to ``{label_key: value}``.
    Used by the round-trip pin test and the live `launch/status.py` view;
    tolerant of comments and blank lines, strict about sample syntax.
    """
    types: Dict[str, str] = {}
    samples: Dict[str, Dict[LabelKey, float]] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        name_labels, _, value = line.rpartition(" ")
        name, brace, rest = name_labels.partition("{")
        labels: Dict[str, str] = {}
        if brace:
            body = rest.rsplit("}", 1)[0]
            for pair in filter(None, body.split(",")):
                k, _, v = pair.partition("=")
                labels[k.strip()] = v.strip().strip('"')
        samples.setdefault(name, {})[_label_key(labels)] = float(value)
    return types, samples
