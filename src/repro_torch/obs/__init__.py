"""repro_torch.obs — unified SEDAR telemetry, the port's own switchboard
(a copy of the reference's `repro.obs`, process-global and separate from it).

Three surfaces behind one switchboard:

  * ``metrics`` — the process-wide :class:`MetricsRegistry`.
    ``enable_metrics()`` installs fan-in hooks into the two counting shims
    (``hostsync._metrics_note``, ``store._metrics_note``) so every
    device->host read and checkpoint disk read lands in the registry with
    the same label the shim saw; engine/serve/checkpoint events arrive via
    the ``note_*`` functions below. The port's prefill has no compile
    cache (eager PyTorch), so the reference's ``prefill_compiles_total``
    has no source here.
  * ``FaultJournal`` — ``set_journal()`` routes every DetectionEvent,
    recovery record, tier fallback, heartbeat anomaly and rejection into
    an append-only JSONL stream.
  * ``TraceRecorder`` — ``enable_trace()`` turns ``span(name)`` from a
    shared no-op context manager into a Chrome-trace complete event.

Contract: everything here is host-side bookkeeping on facts the engine
already read back — **telemetry never issues a device sync** (a torch
tensor handed to the journal raises), and with everything disabled each
instrumentation point costs one ``is None`` / bool test. Spans time the
host clock: PyTorch launches asynchronously, so a span over work that
reads nothing back times its dispatch, and the next counted read absorbs
the queued device time.

This package never imports the engine/runtime modules (they import us),
so there are no cycles.
"""
from __future__ import annotations

import os
import time
from contextlib import nullcontext
from typing import Any, Dict, Optional

from .alerts import Alert, AlertManager, SloTracker
from .anomaly import AnomalyMonitor, Cusum, EwmaBand, PageHinkley
from .estimator import CalibratedSnapshot, OnlineEstimator
from .journal import FaultJournal, canonical, event_to_record, payloads, \
    reconcile, replay
from .kpi import compute_kpis, reconcile_with_advice
from .registry import DEFAULT_BUCKETS, MetricsRegistry, parse_prometheus, \
    percentile
from .trace import TraceRecorder

__all__ = [
    "metrics", "percentile", "MetricsRegistry", "parse_prometheus",
    "DEFAULT_BUCKETS",
    "FaultJournal", "canonical", "event_to_record", "payloads", "replay",
    "reconcile", "compute_kpis", "reconcile_with_advice", "TraceRecorder",
    "OnlineEstimator", "CalibratedSnapshot",
    "AnomalyMonitor", "EwmaBand", "PageHinkley", "Cusum",
    "Alert", "AlertManager", "SloTracker",
    "enable_metrics", "disable_metrics", "metrics_enabled",
    "set_journal", "get_journal", "enable_trace", "disable_trace",
    "get_trace", "span", "configure", "shutdown",
    "note_detection", "note_recovery", "note_checkpoint",
    "note_tier_save", "note_tier_restore", "note_tier_event",
    "note_rejection", "note_heartbeat_anomaly", "note_tokens",
    "note_drain", "note_alert", "note_reconfig",
    "Observability",
]

metrics = MetricsRegistry()

_metrics_on = False
_journal: Optional[FaultJournal] = None
_trace: Optional[TraceRecorder] = None
_NULL_SPAN = nullcontext()


# --------------------------------------------------------------------------
# switchboard
# --------------------------------------------------------------------------

def _hostsync_hook(label: str, items: int) -> None:
    metrics.inc("hostsync_transfers_total", items, label=label)
    metrics.inc("hostsync_batches_total", 1, label=label)


def _disk_read_hook(label: str, items: int) -> None:
    metrics.inc("checkpoint_disk_reads_total", items, label=label)


def enable_metrics() -> None:
    """Turn the registry on and absorb the counting shims."""
    global _metrics_on
    from repro_torch.checkpoint import store
    from repro_torch.core import hostsync
    hostsync._metrics_note = _hostsync_hook
    store._metrics_note = _disk_read_hook
    _metrics_on = True


def disable_metrics() -> None:
    import sys
    global _metrics_on
    _metrics_on = False
    for modname in ("repro_torch.core.hostsync",
                    "repro_torch.checkpoint.store"):
        mod = sys.modules.get(modname)
        if mod is not None:
            mod._metrics_note = None


def metrics_enabled() -> bool:
    return _metrics_on


def set_journal(journal: Optional[FaultJournal]) -> Optional[FaultJournal]:
    global _journal
    prev, _journal = _journal, journal
    return prev


def get_journal() -> Optional[FaultJournal]:
    return _journal


def enable_trace() -> TraceRecorder:
    global _trace
    if _trace is None:
        _trace = TraceRecorder()
    return _trace


def disable_trace() -> None:
    global _trace
    _trace = None


def get_trace() -> Optional[TraceRecorder]:
    return _trace


class _MetricSpan:
    """Times the span body into the stage-duration histogram (host clock
    only — never a device sync), optionally wrapping a trace span."""

    __slots__ = ("name", "inner", "_t0")

    def __init__(self, name: str, inner=None):
        self.name = name
        self.inner = inner
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.monotonic()
        if self.inner is not None:
            self.inner.__enter__()
        return self

    def __exit__(self, *exc):
        if self.inner is not None:
            self.inner.__exit__(*exc)
        metrics.observe("sedar_stage_duration_seconds",
                        time.monotonic() - self._t0, stage=self.name)
        return False


def span(name: str, **args):
    """Stage span context manager: a Chrome-trace event when tracing is
    on, a stage-duration histogram sample when metrics are on (these are
    what the estimator calibrates t_step/t_sync/tier costs from),
    and the shared no-op when both are off."""
    tr = _trace
    if tr is None and not _metrics_on:
        return _NULL_SPAN
    inner = tr.span(name, **args) if tr is not None else None
    if not _metrics_on:
        return inner
    return _MetricSpan(name, inner)


def shutdown() -> None:
    """Reset all global observability state (test teardown helper)."""
    global _journal, _trace
    disable_metrics()
    metrics.reset()
    if _journal is not None:
        _journal.close()
    _journal = None
    _trace = None


# --------------------------------------------------------------------------
# event intake — each guarded so the disabled path is a couple of branches
# --------------------------------------------------------------------------

def note_detection(event: Any) -> None:
    if _metrics_on:
        metrics.inc("sedar_detections_total",
                    boundary=event.boundary, effect=event.effect)
    if _journal is not None:
        _journal.append("detection", step=event.step,
                        event=event_to_record(event))


def note_recovery(record: Dict[str, Any]) -> None:
    if _metrics_on:
        kind = str(record.get("kind", "?"))
        metrics.inc("sedar_recoveries_total", kind=kind)
        rb = record.get("rollbacks", 0) or 0
        if rb:
            metrics.inc("sedar_rollbacks_total", rb)
        if kind == "retry":
            metrics.inc("sedar_retries_total")
    if _journal is not None:
        _journal.append("recovery", step=record.get("step"),
                        record=dict(record))


def note_checkpoint(step: int) -> None:
    if _metrics_on:
        metrics.inc("sedar_checkpoints_total")
    if _journal is not None:
        _journal.append("checkpoint", step=step)


def note_tier_save(tier: str, step: Optional[int] = None) -> None:
    if _metrics_on:
        metrics.inc("checkpoint_saves_total", tier=tier)


def note_tier_restore(tier: str, version: Optional[int] = None) -> None:
    if _metrics_on:
        metrics.inc("checkpoint_restores_total", tier=tier)
    if _journal is not None:
        _journal.append("tier_restore", tier=tier, version=version)


def note_tier_event(ev: Dict[str, Any]) -> None:
    """Tier fallback / corruption events from TieredCheckpointer."""
    if _metrics_on:
        metrics.inc("checkpoint_tier_fallbacks_total",
                    tier=str(ev.get("tier", "?")))
    if _journal is not None:
        fields = {k: v for k, v in ev.items() if k != "kind"}
        _journal.append("tier_fallback", **fields)


def note_rejection(step: int, rid: Any = None, slot: Optional[int] = None,
                   reason: str = "persistent_fault") -> None:
    if _metrics_on:
        metrics.inc("serve_rejections_total", reason=reason)
    if _journal is not None:
        _journal.append("rejection", step=step, rid=rid, slot=slot,
                        reason=reason)


def note_heartbeat_anomaly(host_id: int, gap_s: float,
                           kind: str = "stale") -> None:
    if _metrics_on:
        metrics.inc("cluster_heartbeat_anomalies_total", kind=kind)
    if _journal is not None:
        _journal.append("heartbeat_anomaly", host=int(host_id),
                        gap_s=float(gap_s), anomaly=kind)


def note_tokens(n: int) -> None:
    if _metrics_on and n:
        metrics.inc("serve_tokens_emitted_total", n)


def note_drain(rows: int) -> None:
    """One lag-aligned emission-ring drain batch (DESIGN.md §18)."""
    if _metrics_on:
        metrics.inc("serve_drain_batches_total")
        metrics.inc("serve_drained_rows_total", rows)


def note_alert(record: Dict[str, Any]) -> None:
    """Structured anomaly/SLO alert from the AlertManager (DESIGN.md §17)."""
    if _metrics_on:
        # label key is "alert", not "name" — the registry's positional
        # metric name would collide with a label literally called name
        metrics.inc("sedar_alerts_total",
                    alert=str(record.get("name", "?")),
                    severity=str(record.get("severity", "warning")))
    if _journal is not None:
        _journal.append("alert", step=record.get("step"),
                        record=dict(record))


def note_reconfig(record: Dict[str, Any]) -> None:
    """Autotuner knob transition applied by SedarEngine.apply_reconfig."""
    if _metrics_on:
        for knob in record.get("changes", {}):
            metrics.inc("sedar_reconfigs_total", knob=str(knob))
    if _journal is not None:
        _journal.append("reconfig", step=record.get("step"),
                        record=dict(record))


# --------------------------------------------------------------------------
# launcher-facing bundle
# --------------------------------------------------------------------------

class Observability:
    """What `--metrics-dir` / `--trace` turn on, and how it lands on disk.

    finalize() writes `metrics.prom` (Prometheus text snapshot) into the
    metrics dir and the Chrome trace to its path; the journal streamed to
    `<metrics_dir>/journal.jsonl` during the run is closed.
    """

    def __init__(self, metrics_dir: Optional[str] = None,
                 trace_path: Optional[str] = None):
        self.metrics_dir = metrics_dir
        self.trace_path = trace_path
        self.journal: Optional[FaultJournal] = None
        self._t0 = time.monotonic()
        if metrics_dir:
            os.makedirs(metrics_dir, exist_ok=True)
            enable_metrics()
            self.journal = FaultJournal(
                os.path.join(metrics_dir, "journal.jsonl"))
            set_journal(self.journal)
        if trace_path:
            enable_trace()

    def kpis(self, **kw) -> Dict[str, Any]:
        recs = self.journal.records() if self.journal else []
        return compute_kpis(recs, wall_s=time.monotonic() - self._t0, **kw)

    def finalize(self) -> Optional[str]:
        """Flush everything; returns the Prometheus snapshot text (also
        written to metrics.prom) when metrics were on."""
        snap = None
        if self.metrics_dir:
            snap = metrics.render_prometheus()
            with open(os.path.join(self.metrics_dir, "metrics.prom"),
                      "w") as fh:
                fh.write(snap)
        if self.trace_path and _trace is not None:
            _trace.write(self.trace_path)
        if self.journal is not None:
            self.journal.close()
            set_journal(None)
        return snap


def configure(metrics_dir: Optional[str] = None,
              trace: Optional[str] = None) -> Observability:
    """One-call launcher setup: returns the bundle to finalize() at exit."""
    return Observability(metrics_dir=metrics_dir, trace_path=trace)
