"""The port's telemetry modules (`repro_torch/obs/`: registry, journal,
trace, kpi, anomaly, alerts, estimator and the switchboard) against the JAX
package's `repro.obs`, on the same seeded streams.

Held exactly: the Prometheus text (byte for byte) after the same
`inc`/`observe`/`set_gauge` sequence, and its parse; the journal's
canonical lines (the `t_mono` wall-time field excluded: it is the host
clock of each run); the KPIs of the same record list; each detector's
verdict sequence; the alert and SLO records; the estimator's calibrated
snapshot. The estimator and the detectors sum floats in the same order in
both packages (the same code), so no tolerance is needed and none is used.
Then the port's own contract: a torch tensor in a journal record raises
(reading it would sync the device), the counting shims feed the registry,
the switchboard is inert when off, the launcher bundle writes its
artifacts, the status page renders them as the reference's does, and the
port's switchboard is separate from the reference's."""
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import temporal_model as jtm
from repro.core.detection import DetectionEvent as JEvent
from repro.launch import status as jstatus
from repro.obs import alerts as jalerts
from repro.obs import anomaly as janomaly
from repro.obs import estimator as jest
from repro.obs import journal as jjournal
from repro.obs import kpi as jkpi
from repro.obs import registry as jregistry

from repro_torch import obs as tobs
from repro_torch.checkpoint import store as tstore
from repro_torch.core import hostsync
from repro_torch.core import temporal_model as ttm
from repro_torch.core.detection import DetectionEvent
from repro_torch.launch import status as tstatus
from repro_torch.obs import alerts as talerts
from repro_torch.obs import anomaly as tanomaly
from repro_torch.obs import estimator as test_
from repro_torch.obs import journal as tjournal
from repro_torch.obs import kpi as tkpi
from repro_torch.obs import registry as tregistry
from repro_torch.runtime.cluster import ClusterMonitor, Heartbeat

torch.set_num_threads(1)

@pytest.fixture(autouse=True)
def _reset_switchboards():
    yield
    for o in (tobs, jobs):
        o.disable_metrics()
        o.set_journal(None)
        o.disable_trace()
        o.shutdown()


def _strip_time(rec):
    """A journal record without its host-clock field."""
    return {k: v for k, v in rec.items() if k != "t_mono"}


# ---------------------------------------------------------------------------
# registry: Prometheus text byte-equal
# ---------------------------------------------------------------------------

def _registry_ops(seed):
    rs = np.random.RandomState(seed)
    ops = [("set_buckets", "lat_s", (0.1, 1.0, 10.0))]
    for _ in range(60):
        kind = rs.choice(["inc", "gauge", "observe", "observe_lat"])
        label = str(rs.choice(["a", "b", "c"]))
        v = float(rs.exponential(2.0))
        if kind == "inc":
            ops.append(("inc", "req_total", int(rs.randint(1, 4)),
                        {"route": label}))
        elif kind == "gauge":
            ops.append(("set_gauge", "depth", v, {}))
        elif kind == "observe":
            ops.append(("observe", "sedar_stage_duration_seconds", v,
                        {"stage": label}))
        else:
            ops.append(("observe", "lat_s", v, {"stage": label}))
    return ops


def _apply(reg, ops):
    for op in ops:
        if op[0] == "set_buckets":
            reg.set_buckets(op[1], op[2])
        else:
            getattr(reg, op[0])(op[1], op[2], **op[3])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prometheus_text_byte_equal(seed):
    treg, jreg = tregistry.MetricsRegistry(), jregistry.MetricsRegistry()
    ops = _registry_ops(seed)
    _apply(treg, ops)
    _apply(jreg, ops)
    text = treg.render_prometheus()
    assert text == jreg.render_prometheus()
    assert tregistry.parse_prometheus(text) == \
        jregistry.parse_prometheus(text)
    for stage in ("a", "b", "c"):
        th = treg.get_histogram("sedar_stage_duration_seconds", stage=stage)
        jh = jreg.get_histogram("sedar_stage_duration_seconds", stage=stage)
        assert (th is None) == (jh is None)
        if th is not None:
            assert [th.quantile(q) for q in (50, 90, 99)] == \
                [jh.quantile(q) for q in (50, 90, 99)]
    assert treg.snapshot() == jreg.snapshot()


def test_percentile_equal_to_jax_and_numpy():
    rs = np.random.RandomState(4)
    for n in (1, 2, 5, 33):
        vals = list(rs.uniform(0, 10, n))
        for q in (0, 1, 50, 90, 99, 100):
            assert tregistry.percentile(vals, q) == \
                jregistry.percentile(vals, q) == \
                float(np.percentile(vals, q, method="inverted_cdf"))
    assert tregistry.percentile([], 50) == 0.0


def test_registry_cross_thread_aggregation():
    m = tregistry.MetricsRegistry()

    def work():
        for _ in range(500):
            m.inc("t_total")

    ts = [threading.Thread(target=work) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    assert m.get("t_total") == 2000


# ---------------------------------------------------------------------------
# journal: canonical lines equal, tensors refused
# ---------------------------------------------------------------------------

def _journal_stream(mod, path=None):
    j = mod.FaultJournal(path)
    j.append("detection", step=np.int64(4),
             event={"step": np.int32(4), "boundary": "deferred",
                    "effect": "TDC",
                    "detail": {3: np.float32(1.5), "arr": np.arange(3),
                               "slot_first_bad": {1: 4},
                               "slots": [np.int64(1)], "partial": True}})
    j.append("recovery", step=2, record={"kind": "slot_restore", "step": 2,
                                         "rollbacks": 1, "at": 4,
                                         "tier": "device",
                                         "slots": {1: {"version": 3,
                                                       "pos": 97}}})
    j.append("tier_fallback", tier="disk", version=2, error="X: y")
    j.append("rejection", step=7, rid=3, slot=1, reason="persistent_fault")
    j.append("reconfig", step=8, record={"kind": "reconfig", "step": 8,
                                         "reason": "r", "changes": {
                                             "validate_lag": {"from": 8,
                                                              "to": 1}}})
    return j


def test_journal_canonical_lines_equal(tmp_path):
    tj = _journal_stream(tjournal, str(tmp_path / "t.jsonl"))
    jj = _journal_stream(jjournal, str(tmp_path / "j.jsonl"))
    tj.close()
    jj.close()
    assert [tjournal.canonical(_strip_time(r)) for r in tj.entries] == \
        [jjournal.canonical(_strip_time(r)) for r in jj.entries]
    tl = tjournal.FaultJournal.load(str(tmp_path / "t.jsonl"))
    jl = jjournal.FaultJournal.load(str(tmp_path / "j.jsonl"))
    assert [_strip_time(r) for r in tl] == [_strip_time(r) for r in jl]
    for mem, disk in zip(tj.entries, tl):
        assert tjournal.canonical(mem) == tjournal.canonical(disk)
    assert tobs.replay(tl).keys() == jobs.replay(jl).keys()


def test_journal_rotation_and_torn_line(tmp_path):
    """Rotation keeps one generation, a torn final line is skipped, and
    the fsync cadence names the last synced record — as in JAX's."""
    out = []
    for mod, name in ((tjournal, "t"), (jjournal, "j")):
        path = str(tmp_path / f"{name}.jsonl")
        j = mod.FaultJournal(path, max_bytes=200, fsync_every=2)
        for i in range(12):
            j.append("detection", step=i, event={"step": i})
        j.close()
        with open(path, "a") as fh:
            fh.write('{"kind": "detec')          # a crash mid-write
        loaded = mod.FaultJournal.load(path)
        out.append(([_strip_time(r) for r in loaded], j.synced_seq))
    assert out[0] == out[1]
    steps = [r["step"] for r in out[0][0]]
    assert steps == list(range(steps[0], 12)) and out[0][1] == 11


@pytest.mark.parametrize("where", ["detail", "record", "top"])
def test_journal_refuses_torch_tensors_without_reading_them(monkeypatch,
                                                            where):
    """A tensor in a record raises TypeError before anything reads it: on
    a CUDA tensor `.item()`, `.tolist()` or `str()` would sync."""
    def no_read(*a, **k):
        raise AssertionError("telemetry read a tensor")
    for name in ("item", "tolist", "__repr__", "__str__", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, no_read)
    j = tjournal.FaultJournal()
    t = torch.zeros((), dtype=torch.int64)
    payload = {"detail": {"event": {"step": 1, "detail": {"lag": t}}},
               "record": {"record": {"kind": "retry", "at": t}},
               "top": {"step": t}}[where]
    with pytest.raises(TypeError, match="torch tensor"):
        j.append("detection", **payload)
    with pytest.raises(TypeError):
        tjournal.canonical([1, {"x": t}])
    assert j.entries == []


def test_reconcile_equal_to_jax():
    evs = [(3, "deferred", "TDC", {"detected_at": 7, "lag": 4}),
           (10, "commit", "TDC", {"slots": [1], "partial": True})]
    recs = [{"kind": "slot_restore", "step": 2, "rollbacks": 1, "at": 3},
            {"kind": "retry", "step": None, "rollbacks": 1, "at": 10}]
    out = []
    for mod, ev_cls in ((tobs, DetectionEvent), (jobs, JEvent)):
        events = [ev_cls(step=s, boundary=b, effect=e, detail=d)
                  for s, b, e, d in evs]
        j = mod.FaultJournal()
        for e in events:
            j.append("detection", step=e.step,
                     event=mod.event_to_record(e))
        for r in recs:
            j.append("recovery", step=r["step"], record=r)
        out.append((mod.reconcile(j.records(), events, recs),
                    mod.reconcile(j.records(), events,
                                  [dict(recs[0], at=9), recs[1]]),
                    [mod.canonical(mod.event_to_record(e))
                     for e in events]))
    assert out[0] == out[1]
    assert out[0][0] == {"detections_match": True, "recoveries_match": True}
    assert not out[0][1]["recoveries_match"]


# ---------------------------------------------------------------------------
# kpi
# ---------------------------------------------------------------------------

def _kpi_records(seed):
    """A journal-shaped record list with fixed t_mono values."""
    rs = np.random.RandomState(seed)
    recs, t, seq = [], 0.0, 0
    for _ in range(8):
        step = int(rs.randint(0, 40))
        t += float(rs.uniform(0.01, 1.0))
        kind = rs.choice(["deferred", "commit", "stale"])
        if kind == "stale":
            recs.append({"kind": "heartbeat_anomaly", "seq": seq,
                         "t_mono": t, "host": 2, "gap_s": 3.0,
                         "anomaly": "stale"})
            seq += 1
            t += 0.5
            recs.append({"kind": "recovery", "seq": seq, "t_mono": t,
                         "step": step, "record": {
                             "kind": "elastic_remesh", "step": step,
                             "at": step + 2, "downtime_s": 0.7}})
        else:
            lag = int(rs.randint(1, 8))
            recs.append({"kind": "detection", "seq": seq, "t_mono": t,
                         "step": step, "event": {
                             "step": step, "boundary": kind,
                             "effect": "TDC",
                             "detail": ({"detected_at": step + lag,
                                         "lag": lag}
                                        if kind == "deferred" else {})}})
            seq += 1
            t += float(rs.uniform(0.001, 0.1))
            recs.append({"kind": "recovery", "seq": seq, "t_mono": t,
                         "step": step - 1, "record": {
                             "kind": "restore" if kind == "deferred"
                             else "retry",
                             "step": step - 1 if kind == "deferred"
                             else None,
                             "rollbacks": 1, "at": step}})
        seq += 1
    return recs


@pytest.mark.parametrize("seed", [0, 1])
def test_kpis_equal_to_jax(seed):
    recs = _kpi_records(seed)
    kw = dict(steps=50, tokens=120, injected=6, wall_s=30.0)
    tk, jk = tkpi.compute_kpis(recs, **kw), jkpi.compute_kpis(recs, **kw)
    assert tk == jk
    for lag in (1, 4, 8):
        assert tkpi.reconcile_with_advice(tk, validate_lag=lag,
                                          predicted_downtime_s=1.0) == \
            jkpi.reconcile_with_advice(jk, validate_lag=lag,
                                       predicted_downtime_s=1.0)


# ---------------------------------------------------------------------------
# anomaly detectors, alerts, SLO burn windows
# ---------------------------------------------------------------------------

def _stream(seed, n=200):
    rs = np.random.RandomState(seed)
    base = 1.0 + 0.02 * rs.randn(n)
    base[n // 2:] += 0.3                     # a sustained shift
    base[n // 4] = 6.0                       # a spike
    return [float(v) for v in base]


@pytest.mark.parametrize("seed", [0, 1])
def test_detectors_equal_to_jax(seed):
    xs = _stream(seed)
    for cls, kw in (("EwmaBand", dict(k=4.0, warmup=8)),
                    ("PageHinkley", dict(delta=0.005, threshold=0.5)),
                    ("Cusum", dict(warmup=8))):
        t = getattr(tanomaly, cls)(**kw)
        j = getattr(janomaly, cls)(**kw)
        assert [t.update(x) for x in xs] == [j.update(x) for x in xs], cls
    tm_, jm = tanomaly.AnomalyMonitor(), janomaly.AnomalyMonitor()
    for m in (tm_, jm):
        m.configure("sync_time", band_k=3.0, warmup=4)
    for i, x in enumerate(xs):
        for s in ("step_time", "sync_time", "fault_rate"):
            v = x if s != "fault_rate" else float(i % 17 == 0) * 3.0
            assert tm_.update(s, v) == jm.update(s, v)
    assert tm_.fired == jm.fired and tm_.fired


def test_alerts_and_slo_equal_to_jax():
    out = []
    for o, al in ((tobs, talerts), (jobs, jalerts)):
        o.enable_metrics()
        j = o.FaultJournal()
        o.set_journal(j)
        mgr = al.AlertManager(min_interval_steps=16)
        emitted = [mgr.emit(al.Alert(name=n, severity=s, step=st,
                                     message=f"m{st}",
                                     detail={"v": np.float32(st / 3)}))
                   for n, s, st in (("a", "warning", 0), ("a", "warning", 10),
                                    ("a", "warning", 32), ("b", "critical",
                                                           10))]
        slo = al.SloTracker("availability", target=0.99, fast_window=4,
                            slow_window=8)
        fired = []
        for step, good in enumerate([1.0] * 8 + [0.0] * 4 + [0.5] * 8):
            a = slo.update(step, good)
            if a is not None:
                fired.append(a.record())
                mgr.emit(a)
        verdict = o.reconcile(j.records(), [], [], alerts=mgr.records)
        out.append((emitted, mgr.records, fired, verdict,
                    [_strip_time(r) for r in j.records()],
                    o.metrics.render_prometheus()))
        o.shutdown()
    assert out[0] == out[1]
    assert out[0][3]["alerts_match"] and out[0][2]


# ---------------------------------------------------------------------------
# estimator
# ---------------------------------------------------------------------------

def _estimator_run(mod, reg_mod, tm_mod):
    """Six ingest rounds of stage histograms and journal detections (a
    record list with fixed `t_mono`: the MTBE gaps come from it), plus
    direct pushes; the snapshot after every round."""
    est = mod.OnlineEstimator(tm_mod.PAPER_TABLE3["JACOBI"],
                              prior_mtbe_hours=24.0)
    rs = np.random.RandomState(7)
    snaps, journal = [], []
    reg = reg_mod.MetricsRegistry()
    for rnd in range(6):
        for _ in range(int(rs.randint(3, 12))):
            reg.observe("sedar_stage_duration_seconds",
                        float(rs.uniform(0.05, 0.2)),
                        stage=str(rs.choice(mod.STEP_STAGES)))
        for stage in (mod.SYNC_STAGE, "checkpoint", "validate"):
            reg.observe("sedar_stage_duration_seconds",
                        float(rs.uniform(0.001, 3.0)), stage=stage)
        for _ in range(rnd % 3):
            journal.append({"kind": "detection", "seq": len(journal),
                            "t_mono": 3600.0 * float(rs.uniform(0.1, 9.0)),
                            "step": rnd,
                            "event": {"step": rnd, "boundary": "commit",
                                      "effect": "hang" if rnd == 4
                                      else "TDC", "detail": {}}})
        est.ingest(metrics=reg, journal=journal)
        est.observe_tier_restore_s("host", float(rs.uniform(0.1, 0.5)))
        snap = est.calibrated_params()
        snaps.append((dataclasses.asdict(snap.params),
                      {k: dataclasses.asdict(v)
                       for k, v in snap.tier_costs.items()},
                      snap.mtbe_hours, snap.sdc_fraction,
                      snap.sample_counts, snap.confidence,
                      est.mtbe_hours()))
    return snaps


def test_estimator_equal_to_jax():
    assert (test_.STEP_STAGES, test_.SYNC_STAGE, test_.TIER_STAGES) == \
        (jest.STEP_STAGES, jest.SYNC_STAGE, jest.TIER_STAGES) == \
        (("train_step", "decode_tick"), "deferred_flush",
         ("device", "host", "disk", "partner"))
    assert _estimator_run(test_, tregistry, ttm) == \
        _estimator_run(jest, jregistry, jtm)


# ---------------------------------------------------------------------------
# the switchboard
# ---------------------------------------------------------------------------

def test_hostsync_and_disk_reads_feed_the_registry():
    tobs.enable_metrics()
    hostsync.read_scalar(torch.tensor(1.0), label="probe")
    hostsync.batched_get([torch.zeros(2), torch.zeros(3)], label="pair")
    tstore._note_disk_read("leaf", 3)
    tstore._note_disk_read("manifest")
    m = tobs.metrics
    assert m.get("hostsync_transfers_total", label="probe") == 1
    assert m.get("hostsync_transfers_total", label="pair") == 2
    assert m.get("hostsync_batches_total", label="pair") == 1
    assert m.get("checkpoint_disk_reads_total", label="leaf") == 3
    assert m.get("checkpoint_disk_reads_total", label="manifest") == 1
    # the port has no prefill compile cache: no such series
    assert "prefill_compiles_total" not in m.render_prometheus()
    # the reference's switchboard saw none of it
    assert jobs.metrics.snapshot() == {}
    tobs.disable_metrics()
    assert hostsync._metrics_note is None and tstore._metrics_note is None


def test_worker_thread_reads_reach_the_registry_only():
    tobs.enable_metrics()

    def worker():
        hostsync.read_scalar(torch.tensor(2.0), label="worker_read")

    with hostsync.count_transfers() as st:
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert st.by_label == {}
    assert tobs.metrics.get("hostsync_transfers_total",
                            label="worker_read") == 1


def test_switchboard_off_is_inert():
    assert not tobs.metrics_enabled()
    hostsync.read_scalar(torch.tensor(1.0), label="probe")
    tobs.note_checkpoint(3)
    tobs.note_tokens(5)
    assert tobs.metrics.snapshot() == {}
    assert tobs.get_journal() is None
    assert tobs.span("anything") is tobs.span("other")     # shared no-op


def _notes(o, ev_cls):
    o.note_detection(ev_cls(step=4, boundary="commit", effect="TDC",
                            detail={"slots": [1], "partial": True}))
    o.note_recovery({"kind": "restore", "step": 2, "rollbacks": 1,
                     "at": 4, "tier": "device", "version": 2})
    o.note_recovery({"kind": "retry", "step": None, "rollbacks": 0,
                     "at": 5})
    o.note_checkpoint(6)
    o.note_tier_save("host", 6)
    o.note_tier_restore("device", 3)
    o.note_tier_event({"kind": "tier_fallback", "tier": "disk",
                       "version": 2, "error": "X"})
    o.note_rejection(7, rid=1, slot=0, reason="persistent_fault")
    o.note_heartbeat_anomaly(3, 61.5, kind="stale")
    o.note_tokens(3)
    o.note_drain(8)
    o.note_alert({"name": "step_time_drift", "severity": "warning",
                  "step": 8, "message": "m", "detail": {}})
    o.note_reconfig({"kind": "reconfig", "step": 12, "reason": "r",
                     "changes": {"validate_lag": {"from": 8, "to": 1}}})


def test_note_functions_equal_to_jax():
    out = []
    for o, ev_cls in ((tobs, DetectionEvent), (jobs, JEvent)):
        o.enable_metrics()
        j = o.FaultJournal()
        o.set_journal(j)
        _notes(o, ev_cls)
        out.append((o.metrics.render_prometheus(),
                    [_strip_time(r) for r in j.records()]))
        o.shutdown()
    assert out[0] == out[1]
    assert [r["kind"] for r in out[0][1]] == [
        "detection", "recovery", "recovery", "checkpoint", "tier_restore",
        "tier_fallback", "rejection", "heartbeat_anomaly", "alert",
        "reconfig"]


def test_trace_spans_and_metric_spans():
    tr = tobs.enable_trace()
    with tobs.span("decode_tick", step=3):
        with tobs.span("deferred_flush", steps=8):
            pass
    assert [e["name"] for e in tr.events] == ["deferred_flush",
                                              "decode_tick"]
    assert tr.events[1]["args"] == {"step": 3}
    tobs.enable_metrics()
    with tobs.span("train_step", step=0):
        pass
    h = tobs.metrics.get_histogram("sedar_stage_duration_seconds",
                                   stage="train_step")
    assert h.count == 1 and h.total >= 0.0


def test_configure_finalize_and_status_match_jax(tmp_path):
    """Both packages' bundles write the same artifacts for the same notes,
    and the port's status page renders either directory as the
    reference's does (the clock in the heading aside)."""
    pages = []
    for o, ev_cls, name in ((tobs, DetectionEvent, "t"),
                            (jobs, JEvent, "j")):
        mdir = str(tmp_path / name)
        ob = o.configure(metrics_dir=mdir, trace=mdir + "/trace.json")
        assert o.metrics_enabled() and o.get_journal() is not None
        for i in range(4):
            o.metrics.observe("sedar_stage_duration_seconds", 0.1 + i,
                              stage="decode_tick")
        o.metrics.observe("sedar_stage_duration_seconds", 0.01,
                          stage="deferred_flush")
        with o.span("train_step", step=0):
            pass
        _notes(o, ev_cls)
        snap = ob.finalize()
        assert o.get_journal() is None
        with open(mdir + "/metrics.prom") as fh:
            assert fh.read() == snap
        with open(mdir + "/trace.json") as fh:
            assert [e["name"] for e in json.load(fh)["traceEvents"]] == \
                ["train_step"]
        o.shutdown()
        # drop the train_step span's sample (host clock) before rendering
        prom = [ln for ln in snap.splitlines()
                if 'stage="train_step"' not in ln]
        with open(mdir + "/metrics.prom", "w") as fh:
            fh.write("\n".join(prom) + "\n")
        pages.append((tstatus.render(mdir), jstatus.render(mdir)))
    for tpage, jpage in pages:
        assert tpage.splitlines()[1:] == jpage.splitlines()[1:]

    def lines(page):        # the kpis line's mttr_s is each run's clock
        return [ln for ln in page.splitlines()[1:]
                if not ln.startswith("kpis:")]
    assert lines(pages[0][0]) == lines(pages[1][0])
    page = pages[0][0]
    assert "journal: 10 records" in page and "decode_tick" in page
    assert "validate_lag: 8->1" in page and "optimal validate lag" in page
    assert "journal: empty" in tstatus.render(str(tmp_path / "none"))


def test_cluster_monitor_publish(tmp_path):
    tobs.enable_metrics()
    j = tobs.FaultJournal()
    tobs.set_journal(j)
    hb_dir = str(tmp_path / "hb")
    for host, step in ((0, 10), (1, 10), (2, 2)):
        assert Heartbeat(hb_dir, host).beat(step)
    mon = ClusterMonitor(hb_dir, n_hosts=4, timeout_s=60.0,
                         straggler_factor=2.0)
    summary = mon.publish()
    assert summary == {"seen": [0, 1, 2], "stale": [3], "stragglers": [2]}
    m = tobs.metrics
    assert m.get("cluster_hosts_seen") == 3
    assert m.get("cluster_stale_hosts") == 1
    assert m.get("cluster_host_step", host=2) == 2
    assert {(a["host"], a["anomaly"])
            for a in j.records("heartbeat_anomaly")} == \
        {(3, "stale"), (2, "straggler")}
