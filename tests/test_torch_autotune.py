"""The port's closed loop (`core/policy.py` advise, choose_degraded_mode,
autotune, Autotuner; `SedarEngine.apply_reconfig`) against the JAX
package's.

The Autotuner runs against the stub engine of `tests/test_autotune.py` on
the same calibration streams in both packages: every evaluation's return,
the stub's lag and reconfig records, the alert records and the estimator's
snapshot are equal. `advise()` and `choose_degraded_mode()` give equal
results on a seeded grid. Then `apply_reconfig` on a real toy engine in
both packages (the same calls give the same records and schedule): the
refusal mid-window, the clamps (an executor without deferred support, L0
retry recovery), the checkpoint-interval change and `reset()` restoring
the base schedule; an autotuned toy run whose reconfig lands at a clean
boundary and reconciles with the journal; and the zero-extra-read
contract: the same host reads by label with the tuner on and off."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import SedarConfig as JSedarConfig
from repro.core import fingerprint as jfp
from repro.core import policy as jpolicy
from repro.core import temporal_model as jtm
from repro.core.injection import MemoryInjectionFlag as JFlag
from repro.obs.journal import FaultJournal as JJournal

from repro_torch import obs as tobs
from repro_torch.configs import SedarConfig
from repro_torch.core import fingerprint as tfp
from repro_torch.core import hostsync
from repro_torch.core import policy as tpolicy
from repro_torch.core import temporal_model as ttm
from repro_torch.core.injection import MemoryInjectionFlag
from repro_torch.core.recovery import RetryRecovery
from repro_torch.obs.journal import FaultJournal

torch.set_num_threads(1)
N = 16


@pytest.fixture(autouse=True)
def _reset_switchboards():
    yield
    for o in (tobs, jobs):
        o.disable_metrics()
        o.set_journal(None)
        o.disable_trace()
        o.shutdown()


class _StubEngine:
    """The reference test's stub: a lag, a pending flag, and an
    apply_reconfig that records transitions."""

    def __init__(self, lag=8):
        self.validate_lag = lag
        self.pending_validation = False
        self.recovery = type("R", (), {"tiers": None})()
        self.reconfigs = []

    def apply_reconfig(self, *, validate_lag=None, checkpoint_interval=None,
                       tier_schedule=None, reason=""):
        if self.pending_validation:
            return None
        if validate_lag is None or int(validate_lag) == self.validate_lag:
            return None
        rec = {"kind": "reconfig", "step": 0, "reason": str(reason),
               "changes": {"validate_lag": {"from": self.validate_lag,
                                            "to": int(validate_lag)}}}
        self.validate_lag = int(validate_lag)
        self.reconfigs.append(rec)
        return rec


def _storm(est, n_steps=64, gap_s=72.0, n_faults=12, sync=True):
    for _ in range(n_steps):
        est.observe_step_s(2.0)
    if sync:
        for _ in range(8):
            est.observe_sync_s(4.0)
    t = 0.0
    for _ in range(n_faults):
        est.observe_fault(t)
        t += gap_s


def _snap(s):
    return (dataclasses.asdict(s.params),
            {k: dataclasses.asdict(v) for k, v in s.tier_costs.items()},
            s.mtbe_hours, s.sdc_fraction, s.sample_counts, s.confidence)


# name -> (AutotuneConfig kwargs, stub lag, feed(est) before, evaluations:
# list of (step, feed before the evaluation or None, pending flag))
def _faults(est, n=12, gap=72.0):
    t = 0.0
    for _ in range(n):
        est.observe_fault(t)
        t += gap


SCENARIOS = {
    "persistence_gates_flap": (
        dict(interval_steps=1, persistence=3, min_confidence=0.0), 8,
        _storm, [(s, None, False) for s in (1, 2, 3, 4)]),
    "low_confidence_advisory": (
        dict(interval_steps=1, persistence=1, min_confidence=0.25), 8,
        lambda e: _faults(e, n=6),
        [(s, None, False) for s in range(1, 5)]),
    "burst_overrides_persistence": (
        dict(interval_steps=1, persistence=50, min_confidence=0.0), 8,
        lambda e: _storm(e, n_faults=0, sync=False),
        [(s, None, False) for s in range(1, 10)]
        + [(10, _faults, False), (11, None, False)]),
    "refused_mid_window_keeps_vote": (
        dict(interval_steps=2, persistence=1, min_confidence=0.0), 8,
        _storm, [(2, None, True), (4, None, True), (5, None, False),
                 (6, None, False)]),
    "serve_mode_with_slos": (
        dict(interval_steps=1, persistence=1, min_confidence=0.0,
             mode="serve", serve_slots=4, slo_availability=0.999,
             slo_goodput=0.9), 8, _storm,
        [(s, _faults if s == 3 else None, False) for s in range(1, 7)]),
    "backend_advice_alert": (
        dict(interval_steps=1, persistence=10 ** 6, min_confidence=0.0,
             backend="sequential"), 8, _storm, [(1, None, False)]),
}


def _autotuner_run(policy, tm, name):
    cfg_kw, lag, feed, evals = SCENARIOS[name]
    tuner = policy.Autotuner(tm.PAPER_TABLE3["JACOBI"],
                             policy.AutotuneConfig(**cfg_kw))
    feed(tuner.estimator)
    eng = _StubEngine(lag=lag)
    out = []
    for step, more, pending in evals:
        if more is not None:
            more(tuner.estimator)
        eng.pending_validation = pending
        out.append((tuner.maybe_tune(eng, step), eng.validate_lag,
                    tuner._pending_target, tuner._pending_count,
                    tuner._burst))
    return (out, eng.reconfigs, tuner.alerts.records, tuner.evaluations,
            _snap(tuner.estimator.calibrated_params()))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_autotuner_decisions_equal_to_jax(name):
    got = _autotuner_run(tpolicy, ttm, name)
    assert got == _autotuner_run(jpolicy, jtm, name)
    out, reconfigs = got[0], got[1]
    if name == "persistence_gates_flap":
        assert [r[0] is not None for r in out] == [False, False, True,
                                                   False]
    if name == "low_confidence_advisory":
        assert reconfigs == [] and got[3] == 4
    if name == "burst_overrides_persistence":
        assert reconfigs and out[-2][0] is not None
    if name == "refused_mid_window_keeps_vote":
        assert [r[0] is not None for r in out[:2]] == [False, False]
        assert len(reconfigs) == 1
    if name == "backend_advice_alert":
        assert reconfigs == []


def test_autotune_one_shot_equal_to_jax():
    out = []
    for policy, tm, est_mod in ((tpolicy, ttm, tobs), (jpolicy, jtm, jobs)):
        est = est_mod.OnlineEstimator(tm.PAPER_TABLE3["JACOBI"])
        _storm(est)
        snap = est.calibrated_params()
        rows = []
        for mode in ("train", "serve"):
            eng = _StubEngine(lag=8)
            rows.append((policy.autotune(eng, snap, mode=mode,
                                         serve_slots=4),
                         policy.autotune(eng, snap, mode=mode,
                                         serve_slots=4), eng.validate_lag))
        out.append(rows)
    assert out[0] == out[1]
    assert out[0][0][0] is not None and out[0][0][1] is None


def _adv(a):
    return dataclasses.asdict(a)


def test_advise_and_degraded_mode_equal_to_jax():
    rs = np.random.RandomState(0)
    for app in ("MATMUL", "JACOBI", "SW"):
        for _ in range(4):
            over = {"t_step": float(rs.uniform(1e-5, 1e-3)),
                    "t_sync": float(rs.uniform(1e-6, 1e-4))}
            tp = dataclasses.replace(ttm.PAPER_TABLE3[app], **over)
            jp = dataclasses.replace(jtm.PAPER_TABLE3[app], **over)
            mtbe = float(10 ** rs.uniform(-1, 3))
            X, k, slots = float(rs.uniform(0.1, 0.9)), int(rs.randint(0, 3)), \
                int(rs.choice([1, 4, 8]))
            assert _adv(tpolicy.advise(tp, mtbe, X, k, slots)) == \
                _adv(jpolicy.advise(jp, mtbe, X, k, slots))
            for lost in (False, True):
                kw = dict(protection_lost=lost,
                          sdc_risk_budget=float(rs.uniform(0.01, 2)),
                          keep_degraded=bool(rs.randint(2)))
                out = float(rs.uniform(0.01, 10))
                assert _adv(tpolicy.choose_degraded_mode(tp, mtbe, out,
                                                         **kw)) == \
                    _adv(jpolicy.choose_degraded_mode(jp, mtbe, out, **kw))


# ---------------------------------------------------------------------------
# apply_reconfig on a real engine, both packages
# ---------------------------------------------------------------------------

def _engines(workdir, lag=4, ckpt=3, level=2, recovery=None):
    """The same toy L2 sequential engine in both packages (the shape of
    tests/test_torch_recovery_levels.py's)."""
    kw = dict(level=level, replication="sequential", validate_interval=1,
              validate_lag=lag, param_validate_interval=0,
              checkpoint_interval=ckpt)
    jw, tw = os.path.join(workdir, "jax"), os.path.join(workdir, "torch")

    def jstep(state, batch, rid, armed):
        delta = 0.1 * batch - 0.01 * state["x"]
        cand = {"x": state["x"] + delta, "step": state["step"] + 1}
        return cand, jfp.pytree_fingerprint_fused({"d": delta}), \
            jnp.sum(cand["x"])

    def tstep(state, batch, rid, armed):
        delta = 0.1 * batch - 0.01 * state["x"]
        cand = {"x": state["x"] + delta, "step": state["step"] + 1}
        return cand, tfp.pytree_fingerprint_fused({"d": delta}), \
            torch.sum(cand["x"])

    jeng = jpolicy.make_engine(
        JSedarConfig(checkpoint_dir=os.path.join(jw, "ckpt"), **kw),
        backend="sequential", workdir=jw, step_fn=jax.jit(jstep),
        state_fp_fn=jax.jit(lambda s: jfp.pytree_fingerprint({"x": s["x"]})),
        inj_flag=JFlag(), notify=lambda e: None,
        recovery=recovery() if recovery else None,
        init_fn=lambda: jeng.executor.init_dual(
            {"x": jnp.zeros((N,), jnp.float32),
             "step": jnp.zeros((), jnp.int32)}))
    teng = tpolicy.make_engine(
        SedarConfig(checkpoint_dir=os.path.join(tw, "ckpt"), **kw),
        backend="sequential", workdir=tw, step_fn=tstep,
        state_fp_fn=lambda s: tfp.leaf_fingerprints({"x": s["x"]}),
        inj_flag=MemoryInjectionFlag(), notify=lambda e: None,
        recovery=recovery() if recovery else None,
        init_fn=lambda: teng.executor.init_dual(
            {"x": torch.zeros(N), "step": torch.zeros((), dtype=torch.int32)}))
    return jeng, teng


def _jbatch(s):
    return jnp.full((N,), float(s + 1), jnp.float32)


def _tbatch(s):
    return torch.full((N,), float(s + 1))


def _steps(eng, batch, dual, steps):
    for s in steps:
        out = eng.run_protected_step(dual, batch(s), s)
        assert out.event is None
        dual = out.dual
    return dual


def test_apply_reconfig_refused_mid_window_equal_to_jax(tmp_workdir):
    jeng, teng = _engines(tmp_workdir, lag=8, ckpt=100)
    out = []
    for eng, batch in ((jeng, _jbatch), (teng, _tbatch)):
        dual = eng.init_dual()
        eng.reset()
        dual = _steps(eng, batch, dual, range(3))   # the ring holds 3
        assert eng.pending_validation
        mid = eng.apply_reconfig(validate_lag=2, reason="mid")
        lag_mid = eng.validate_lag
        assert eng.flush_deferred() is None and not eng.pending_validation
        rec = eng.apply_reconfig(validate_lag=2, reason="boundary")
        out.append((mid, lag_mid, rec, eng.validate_lag,
                    eng.schedule.validate_lag))
    assert out[0] == out[1]
    assert out[1][:2] == (None, 8)
    assert out[1][2] == {"kind": "reconfig", "step": 3, "reason": "boundary",
                         "changes": {"validate_lag": {"from": 8, "to": 2}}}


@pytest.mark.parametrize("clamp", ["no_deferred", "retry_recovery"])
def test_apply_reconfig_clamps_equal_to_jax(tmp_workdir, monkeypatch,
                                            clamp):
    if clamp == "retry_recovery":
        from repro.core.recovery import RetryRecovery as JRetry
        jeng, teng = _engines(tmp_workdir, lag=4, level=1)
        jeng.recovery, teng.recovery = JRetry(), RetryRecovery()
    else:
        jeng, teng = _engines(tmp_workdir, lag=4)
        for eng in (jeng, teng):
            monkeypatch.setattr(eng.executor, "supports_deferred", False,
                                raising=False)
    out = []
    for eng in (jeng, teng):
        rec = eng.apply_reconfig(validate_lag=64, reason="clamp")
        again = [eng.apply_reconfig(validate_lag=v) for v in (4, 16, 1)]
        out.append((rec, again, eng.validate_lag, eng.reconfigs))
    assert out[0] == out[1]
    rec, again, lag, recs = out[1]
    assert rec["changes"] == {"validate_lag": {"from": 4, "to": 1}}
    assert again == [None, None, None] and lag == 1 and recs == [rec]


def test_apply_reconfig_checkpoint_interval_and_reset(tmp_workdir):
    jeng, teng = _engines(tmp_workdir, lag=4, ckpt=3)
    out = []
    for eng, o, jcls in ((jeng, jobs, JJournal), (teng, tobs, FaultJournal)):
        o.enable_metrics()
        j = jcls()
        o.set_journal(j)
        rec = eng.apply_reconfig(validate_lag=8, checkpoint_interval=7,
                                 reason="retune")
        state = (eng.schedule.checkpoint_interval, eng.recovery.interval,
                 eng.validate_lag)
        verdict = o.reconcile(j.records(), [], [], reconfigs=eng.reconfigs)
        prom = o.metrics.render_prometheus()
        eng.reset()
        out.append((rec, state, verdict, prom, eng.validate_lag,
                    eng.schedule, eng.reconfigs))
        o.shutdown()
    assert out[0][:5] == out[1][:5]
    rec, state, verdict, prom, lag, sched, recs = out[1]
    assert set(rec["changes"]) == {"validate_lag", "checkpoint_interval"}
    assert state == (7, 7, 8)
    assert verdict == {"detections_match": True, "recoveries_match": True,
                       "reconfigs_match": True}
    assert 'sedar_reconfigs_total{knob="checkpoint_interval"} 1' in prom
    # reset restores the configured schedule and lag
    assert lag == 4 and sched == teng._base_schedule and recs == []
    assert sched.checkpoint_interval == 3


def test_toy_engine_autotune_reconfigs_at_boundary(tmp_workdir):
    """The reference's toy e2e on both packages: the journal on, the tuner
    every 4 steps from a shared calibration (metrics stay off: the spans'
    host times differ between runs); the same reconfig lands at a clean
    boundary, and the journal reproduces detections, recoveries, alerts
    and reconfigs."""
    jeng, teng = _engines(tmp_workdir, lag=4, ckpt=100)
    out = []
    for eng, batch, o, policy, tm, jcls in (
            (jeng, _jbatch, jobs, jpolicy, jtm, JJournal),
            (teng, _tbatch, tobs, tpolicy, ttm, FaultJournal)):
        j = jcls()
        o.set_journal(j)
        tuner = policy.Autotuner(
            tm.PAPER_TABLE3["JACOBI"],
            policy.AutotuneConfig(interval_steps=4, persistence=1,
                                  min_confidence=0.0))
        _storm(tuner.estimator)
        dual = eng.init_dual()
        eng.reset()
        applied = []
        for s in range(12):
            dual = _steps(eng, batch, dual, [s])
            rec = tuner.maybe_tune(eng, s + 1)
            if rec is not None:
                applied.append((s + 1, eng.pending_validation))
        verdict = o.reconcile(j.records(), eng.detections, eng.recoveries,
                              alerts=tuner.alerts.records,
                              reconfigs=eng.reconfigs)
        out.append((list(eng.reconfigs), eng.validate_lag, verdict,
                    tuner.alerts.records, applied))
        o.shutdown()
    assert out[0] == out[1]
    reconfigs, lag, verdict, _, applied = out[1]
    assert reconfigs and reconfigs[0]["changes"]["validate_lag"]["from"] == 4
    assert applied and not any(p for _, p in applied)
    assert all(verdict.values()) and len(verdict) == 4


def test_autotune_on_adds_no_host_read_train(tmp_workdir):
    """A fault-free lag-8 window: the same reads by label with the full
    loop ticking (ingest + watch every 2 steps) as with it off."""
    def run(workdir, tuner):
        _, eng = _engines(workdir, lag=8, ckpt=100)
        dual = eng.init_dual()
        eng.reset()
        with hostsync.count_transfers() as st:
            for s in range(8):
                dual = _steps(eng, _tbatch, dual, [s])
                if tuner is not None:
                    tuner.maybe_tune(eng, s + 1)
        assert eng.validate_lag == 8
        return st.by_label

    off = run(tmp_workdir + "_off", None)
    tobs.enable_metrics()
    tobs.set_journal(FaultJournal())
    tuner = tpolicy.Autotuner(ttm.PAPER_TABLE3["JACOBI"],
                              tpolicy.AutotuneConfig(interval_steps=2,
                                                     persistence=10 ** 6))
    on = run(tmp_workdir + "_on", tuner)
    assert tuner.evaluations == 4
    assert on == off == {"deferred_flush": 1}
