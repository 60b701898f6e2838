"""Live status view over a run's observability directory (DESIGN.md §17).

Tails the fault journal and the Prometheus snapshot a `--metrics-dir` run
writes, and renders one consolidated terminal page: journal record counts,
per-stage timings, reliability KPIs, the calibrated temporal-model view
(with the lag the analytic optimum would pick right now), and the most
recent alerts / reconfig transitions.

    PYTHONPATH=src python -m repro_torch.launch.status --metrics-dir /tmp/obs
    # one-shot render (no screen clearing, exits immediately):
    PYTHONPATH=src python -m repro_torch.launch.status --metrics-dir /tmp/obs --once

Read-only: this process never writes to the directory it watches, so it is
safe to point at a live run from another terminal.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List

from repro_torch.core import temporal_model as tm
from repro_torch.obs import parse_prometheus
from repro_torch.obs.estimator import OnlineEstimator, STEP_STAGES, SYNC_STAGE
from repro_torch.obs.journal import FaultJournal
from repro_torch.obs.kpi import compute_kpis


def _load(metrics_dir: str):
    recs: List[Dict[str, Any]] = []
    jpath = os.path.join(metrics_dir, "journal.jsonl")
    if os.path.exists(jpath) or os.path.exists(jpath + ".1"):
        recs = FaultJournal.load(jpath)
    types: Dict[str, str] = {}
    samples: Dict[Any, Any] = {}
    ppath = os.path.join(metrics_dir, "metrics.prom")
    if os.path.exists(ppath):
        with open(ppath) as f:
            types, samples = parse_prometheus(f.read())
    return recs, types, samples


def _stage_means(samples) -> List[Dict[str, Any]]:
    """[{stage, count, mean_s}] from the stage-duration histogram family."""
    sums = samples.get("sedar_stage_duration_seconds_sum", {})
    counts = samples.get("sedar_stage_duration_seconds_count", {})
    rows = []
    for lk, total in sorted(sums.items()):
        n = int(counts.get(lk, 0))
        if n <= 0:
            continue
        rows.append({"stage": dict(lk).get("stage", "?"), "count": n,
                     "mean_s": total / n})
    return rows


def _estimator_view(stages, recs) -> Dict[str, Any]:
    """Replay the parsed aggregates through an OnlineEstimator — the same
    calibration the in-process autotuner runs, reconstructed offline."""
    est = OnlineEstimator(tm.PAPER_TABLE3["JACOBI"])
    for row in stages:
        if row["stage"] in STEP_STAGES:
            est.observe_step_s(row["mean_s"], weight=row["count"])
        elif row["stage"] == SYNC_STAGE:
            est.observe_sync_s(row["mean_s"], weight=row["count"])
    est.ingest(journal=recs)
    snap = est.calibrated_params()
    lag = tm.optimal_validate_lag(snap.params, snap.mtbe_hours)
    return {"snap": snap, "lag": lag}


def render(metrics_dir: str, tail: int = 5) -> str:
    recs, types, samples = _load(metrics_dir)
    out: List[str] = []
    out.append(f"== SEDAR status: {metrics_dir} "
               f"({time.strftime('%H:%M:%S')}) ==")

    by_kind: Dict[str, int] = {}
    max_step = 0
    for r in recs:
        by_kind[r.get("kind", "?")] = by_kind.get(r.get("kind", "?"), 0) + 1
        if r.get("step") is not None:
            max_step = max(max_step, int(r["step"]))
    if recs:
        kinds = ", ".join(f"{k}={v}" for k, v in sorted(by_kind.items()))
        out.append(f"journal: {len(recs)} records ({kinds}), "
                   f"frontier step {max_step}")
    else:
        out.append("journal: empty")

    stages = _stage_means(samples)
    if stages:
        out.append("stages (mean):")
        for row in stages:
            out.append(f"  {row['stage']:<18} n={row['count']:<6} "
                       f"{1e3 * row['mean_s']:.3f} ms")

    depth = samples.get("sedar_serve_queue_depth")
    if depth:
        out.append(f"serve queue depth: {next(iter(depth.values())):g}")

    if recs:
        kpis = compute_kpis(recs, steps=max_step or None)
        out.append("kpis: " + ", ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in kpis.items()))

    if stages or recs:
        view = _estimator_view(stages, recs)
        snap = view["snap"]
        out.append(f"calibrated: t_step={snap.params.t_step:.3e} h, "
                   f"t_sync={snap.params.t_sync:.3e} h, "
                   f"mtbe={snap.mtbe_hours:.3g} h, "
                   f"confidence={snap.confidence:.2f} -> "
                   f"optimal validate lag {view['lag']}")

    alerts = [r for r in recs if r.get("kind") == "alert"][-tail:]
    if alerts:
        out.append(f"alerts (last {len(alerts)}):")
        for a in alerts:
            rec = a.get("record", {}) or {}
            out.append(f"  [{rec.get('severity', '?'):>8}] "
                       f"step {rec.get('step', '?')}: "
                       f"{rec.get('name', '?')} — "
                       f"{rec.get('message', '')}")
    reconfigs = [r for r in recs if r.get("kind") == "reconfig"][-tail:]
    if reconfigs:
        out.append(f"reconfigs (last {len(reconfigs)}):")
        for rc in reconfigs:
            rec = rc.get("record", {}) or {}
            changes = rec.get("changes", {})
            desc = ", ".join(
                f"{k}: {v.get('from')}->{v.get('to')}"
                if isinstance(v, dict) and "from" in v else f"{k}"
                for k, v in changes.items())
            out.append(f"  step {rec.get('step', '?')}: {desc} "
                       f"({rec.get('reason', '')})")
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--metrics-dir", required=True,
                    help="directory a run was launched with via "
                         "--metrics-dir (journal.jsonl + metrics.prom)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="seconds between refreshes")
    ap.add_argument("--once", action="store_true",
                    help="render a single snapshot and exit (no screen "
                         "clearing; what the tests drive)")
    ap.add_argument("--tail", type=int, default=5,
                    help="how many recent alerts/reconfigs to show")
    args = ap.parse_args()

    if args.once:
        print(render(args.metrics_dir, tail=args.tail))
        return
    try:
        while True:
            print("\x1b[2J\x1b[H", end="")
            print(render(args.metrics_dir, tail=args.tail), flush=True)
            time.sleep(max(args.interval, 0.1))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
