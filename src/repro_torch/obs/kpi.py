"""Live reliability KPIs computed from the fault journal.

MTTD, MTTR, redone work, availability, goodput, and SDC coverage — the
measured side of the paper's Section-7 predicted-vs-observed check.
`reconcile_with_advice` lines the measurements up against the temporal
model's `policy.advise` outputs (validate_lag bound, serve availability)
and reports per-metric pass/fail rows.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

from .journal import payloads


def compute_kpis(records: Iterable[Dict[str, Any]], *,
                 steps: Optional[int] = None,
                 tokens: Optional[int] = None,
                 injected: Optional[int] = None,
                 wall_s: Optional[float] = None) -> Dict[str, Any]:
    """Reduce a journal to reliability KPIs.

    - ``mttd_steps``: mean detection latency in steps — for a deferred
      detection `detail["detected_at"] − step` (fault commit → flush that
      surfaced it), else 0 (caught at its own boundary).
    - ``mttr_s``: mean wall time from a detection line to the SDC recovery
      line that resolved it (journal `t_mono` deltas). Elastic remesh
      recoveries are excluded — they pair with heartbeat anomalies and
      report separately as ``elastic_mttr_s``.
    - ``redone_steps``: total steps re-executed by rollbacks
      (`record["at"] − record["step"]` summed over rollback recoveries).
    - ``availability``: 1 − redone/steps (useful-work fraction).
    - ``goodput_tokens_per_step``: tokens / steps when both known.
    - ``sdc_detected`` / ``sdc_coverage``: detections vs injected faults.
    """
    recs = list(records)
    det_lines = [r for r in recs if r.get("kind") == "detection"]
    rec_lines = [r for r in recs if r.get("kind") == "recovery"]
    dets = payloads(recs, "detection", "event")

    lags: List[float] = []
    for d in dets:
        detail = d.get("detail", {}) or {}
        lags.append(float(detail.get("detected_at", d["step"])) -
                    float(d["step"]))

    # Elastic remesh transitions (DESIGN.md §16) are node-loss recoveries,
    # not SDC recoveries: pairing one with an SDC detection line would both
    # corrupt MTTR (the remesh did not resolve that detection) and leave
    # the real recovery line unpaired. Split them out and pair them with
    # the heartbeat anomaly that triggered the transition instead.
    def _is_remesh(rl: Dict[str, Any]) -> bool:
        return (rl.get("record") or {}).get("kind") == "elastic_remesh"

    sdc_rec_lines = [r for r in rec_lines if not _is_remesh(r)]
    remesh_lines = [r for r in rec_lines if _is_remesh(r)]
    hb_lines = [r for r in recs if r.get("kind") == "heartbeat_anomaly"]

    # Pair each SDC recovery with the nearest preceding unclaimed detection.
    mttrs: List[float] = []
    free = list(det_lines)
    for rl in sdc_rec_lines:
        prior = [dl for dl in free if dl["seq"] < rl["seq"]]
        if prior:
            dl = prior[-1]
            free.remove(dl)
            mttrs.append(rl["t_mono"] - dl["t_mono"])

    # Elastic MTTR: stale-host heartbeat anomaly -> remesh completion.
    elastic_mttrs: List[float] = []
    free_hb = list(hb_lines)
    for rl in remesh_lines:
        prior = [h for h in free_hb if h["seq"] < rl["seq"]]
        if prior:
            h = prior[-1]
            free_hb.remove(h)
            elastic_mttrs.append(rl["t_mono"] - h["t_mono"])

    redone = 0
    rollbacks = 0
    corrected = 0
    remeshes = 0
    downtime_s = 0.0
    for r in payloads(recs, "recovery", "record"):
        rollbacks += int(r.get("rollbacks", 0) or 0)
        if r.get("at") is not None and r.get("step") is not None:
            redone += max(0, int(r["at"]) - int(r["step"]))
        if r.get("kind") in ("abft_correct", "vote_repair", "corrected"):
            corrected += 1
        if r.get("kind") == "elastic_remesh":
            # node-loss transitions (DESIGN.md §16): their `at - step` spans
            # already feed `redone` above (work discarded by re-anchoring);
            # the transition pauses themselves are a separate downtime axis
            remeshes += 1
            downtime_s += float(r.get("downtime_s", 0.0) or 0.0)
    # prefill-corrected events are repaired inline (no recovery record)
    corrected += sum(1 for d in dets
                     if d.get("effect") == "abft_corrected")

    out: Dict[str, Any] = {
        "detections": len(dets),
        "recoveries": len(rec_lines),
        "rollbacks": rollbacks,
        "corrected": corrected,
        "mttd_steps": (sum(lags) / len(lags)) if lags else 0.0,
        "mttd_max_steps": max(lags) if lags else 0.0,
        "mttr_s": (sum(mttrs) / len(mttrs)) if mttrs else 0.0,
        "redone_steps": redone,
    }
    if remeshes:
        out["elastic_remeshes"] = remeshes
        out["node_loss_downtime_s"] = downtime_s
        if elastic_mttrs:
            out["elastic_mttr_s"] = sum(elastic_mttrs) / len(elastic_mttrs)
    if steps:
        out["steps"] = int(steps)
        out["availability"] = max(0.0, 1.0 - redone / float(steps))
        if remeshes and wall_s:
            # node-loss downtime windows are wall time where NO useful work
            # happens at all — fold them in as an uptime factor on top of
            # the redone-work fraction
            out["availability"] *= max(0.0,
                                       1.0 - downtime_s / float(wall_s))
    if tokens is not None and steps:
        out["goodput_tokens_per_step"] = tokens / float(steps)
    if injected is not None:
        out["sdc_injected"] = int(injected)
        out["sdc_detected"] = len(dets)
        out["sdc_coverage"] = (len(dets) / float(injected)) if injected \
            else 1.0
    if wall_s is not None:
        out["wall_s"] = float(wall_s)
    return out


def reconcile_with_advice(kpis: Dict[str, Any], *,
                          advice: Any = None,
                          validate_lag: Optional[int] = None,
                          predicted_downtime_s: Optional[float] = None
                          ) -> List[Dict[str, Any]]:
    """Predicted-vs-observed rows. Hard bound checked here: every deferred
    detection must surface within the validation window
    (``mttd_max_steps ≤ validate_lag``). When a `policy.Advice` is given,
    its serve-availability prediction becomes a floor-with-slack check on
    the measured availability. `predicted_downtime_s` is the temporal
    model's fail-in-place transition estimate
    (`tm.remesh_overhead × transitions`, in seconds) checked against the
    measured node-loss downtime with a generous slack band — transition
    wall time is dominated by restore IO, which the model only scales."""
    rows: List[Dict[str, Any]] = []
    lag = validate_lag
    if lag is None and advice is not None:
        lag = getattr(advice, "serve_validate_lag", None) or \
            getattr(advice, "validate_lag", None)
    if lag is not None:
        rows.append({
            "metric": "mttd_max_steps",
            "predicted": f"<= {lag}",
            "observed": kpis.get("mttd_max_steps", 0.0),
            "ok": kpis.get("mttd_max_steps", 0.0) <= lag,
        })
    if advice is not None and kpis.get("availability") is not None:
        pred = getattr(advice, "serve_availability", None)
        if pred is not None:
            obs_v = kpis["availability"]
            rows.append({
                "metric": "availability",
                "predicted": pred,
                "observed": obs_v,
                # model is an expectation over the fault process; allow a
                # generous slack band rather than a point match
                "ok": obs_v >= pred - 0.25,
            })
    if predicted_downtime_s is not None and \
            kpis.get("node_loss_downtime_s") is not None:
        obs_dt = float(kpis["node_loss_downtime_s"])
        rows.append({
            "metric": "node_loss_downtime_s",
            "predicted": predicted_downtime_s,
            "observed": obs_dt,
            # the model predicts the expected transition overhead; real
            # transitions add compile + IO jitter, so check order of
            # magnitude, not a point value
            "ok": obs_dt <= 4.0 * float(predicted_downtime_s) + 5.0,
        })
    if "sdc_coverage" in kpis:
        rows.append({
            "metric": "sdc_coverage",
            "predicted": 1.0,
            "observed": kpis["sdc_coverage"],
            "ok": kpis["sdc_coverage"] >= 1.0,
        })
    return rows
