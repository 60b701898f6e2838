"""The port's engine against the JAX reference's on toy states: the same
boundary schedule, recovery and scenario give the same (step, boundary,
effect) detection stream and the same recovery records. Also the prefill
bucket ladder and the host-read accounting."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SedarConfig as JSedarConfig
from repro.core import fingerprint as jfp
from repro.core.detection import SedarSafeStop as JSafeStop
from repro.core.engine import BoundarySchedule as JSchedule
from repro.core.policy import make_engine as jmake_engine
from repro.core.recovery import RetryRecovery as JRetry
from repro.runtime import prefill as jprefill

from repro_torch.configs import SedarConfig
from repro_torch.core import fingerprint as tfp
from repro_torch.core import hostsync
from repro_torch.core.detection import SedarSafeStop
from repro_torch.core.engine import BoundarySchedule
from repro_torch.core.policy import make_engine
from repro_torch.core.recovery import RecoveryAction, RetryRecovery, SafeStop
from repro_torch.runtime import prefill as tprefill

torch.set_num_threads(1)


def _jstep(state, batch, rid, armed):
    """Replica 1 silently corrupts `b` at n == 1; the commit fingerprint
    covers only `a`, so only the full-state (FSC) compare can see it."""
    n = state["n"]
    bump = jnp.where((rid == 1) & (n == 1), 1.0, 0.0)
    cand = {"a": state["a"] + 1.0, "b": state["b"] + bump, "n": n + 1}
    return cand, jfp.pytree_fingerprint_fused({"a": cand["a"]}), None


def _tstep(state, batch, rid, armed):
    n = state["n"]
    bump = 1.0 if (rid == 1 and n == 1) else 0.0
    cand = {"a": state["a"] + 1.0, "b": state["b"] + bump, "n": n + 1}
    return cand, tfp.pytree_fingerprint_fused({"a": cand["a"]}), None


def _drive(eng, state, safe_stop, steps=5):
    dual = eng.executor.init_dual(state)
    for step in range(steps):
        out = eng.run_protected_step(dual, None, step)
        dual = out.dual
        if out.event is not None:
            try:
                dual = eng.on_detection(out.event, dual)
            except safe_stop:
                break
    events = [(e.step, e.boundary, e.effect) for e in eng.detections]
    recs = [(r["kind"], r["step"], r["rollbacks"], r["at"])
            for r in eng.recoveries]
    return events, recs


def _engines(validate_interval=0, toe_timeout_s=120.0, delays=None,
             max_retries=8):
    jeng = jmake_engine(
        JSedarConfig(), backend="sequential", step_fn=_jstep,
        state_fp_fn=jfp.pytree_fingerprint_fused,
        schedule=JSchedule(commit_interval=1,
                           validate_interval=validate_interval,
                           toe_timeout_s=toe_timeout_s),
        recovery=JRetry(max_retries=max_retries), notify=lambda e: None,
        delay_source=(lambda: delays[0]) if delays else None)
    teng = make_engine(
        SedarConfig(), backend="sequential", step_fn=_tstep,
        state_fp_fn=tfp.pytree_fingerprint_fused,
        schedule=BoundarySchedule(commit_interval=1,
                                  validate_interval=validate_interval,
                                  toe_timeout_s=toe_timeout_s),
        recovery=RetryRecovery(max_retries=max_retries),
        notify=lambda e: None,
        delay_source=(lambda: delays[1]) if delays else None)
    jstate = {"a": jnp.zeros(3), "b": jnp.zeros(3), "n": jnp.int32(0)}
    tstate = {"a": torch.zeros(3), "b": torch.zeros(3), "n": 0}
    return (jeng, jstate), (teng, tstate)


@pytest.mark.parametrize("max_retries", [8, 1])
def test_fsc_validate_boundary_matches_reference(max_retries):
    (jeng, js), (teng, ts) = _engines(validate_interval=2,
                                      max_retries=max_retries)
    want = _drive(jeng, js, JSafeStop)
    got = _drive(teng, ts, SedarSafeStop)
    assert got == want
    assert got[0] == [(2, "validate", "FSC"), (4, "validate", "FSC")]


def _tstep_fused(st, batch, armed):
    """_tstep on both replicas stacked as rows [0, 3) and [3, 6)."""
    n = st["n"]
    b = st["b"].clone()
    if n == 1:
        b[3:] += 1.0                   # replica 1's rows
    cand = {"a": st["a"] + 1.0, "b": b, "n": n + 1}
    fps = torch.stack([tfp.pytree_fingerprint_fused({"a": cand["a"][r]})
                       for r in (slice(0, 3), slice(3, 6))])
    return cand, fps, None


@pytest.mark.parametrize("max_retries", [8, 1])
def test_fused_fsc_validate_boundary_matches_reference(max_retries):
    """The fused executor's FSC boundary: each replica's rows fingerprinted
    and compared, the same events and recoveries as the reference's fused
    engine (a vmap over the replica axis)."""
    jeng = jmake_engine(
        JSedarConfig(), backend="fused", step_fn=_jstep,
        state_fp_fn=jfp.pytree_fingerprint_fused,
        schedule=JSchedule(commit_interval=1, validate_interval=2),
        recovery=JRetry(max_retries=max_retries), notify=lambda e: None)
    teng = make_engine(
        SedarConfig(), backend="fused", step_fn=_tstep_fused,
        state_fp_fn=tfp.pytree_fingerprint_fused,
        schedule=BoundarySchedule(commit_interval=1, validate_interval=2),
        recovery=RetryRecovery(max_retries=max_retries),
        notify=lambda e: None)
    want = _drive(jeng, {"a": jnp.zeros(3), "b": jnp.zeros(3),
                         "n": jnp.int32(0)}, JSafeStop)
    got = _drive(teng, {"a": torch.zeros(3), "b": torch.zeros(3), "n": 0},
                 SedarSafeStop)
    assert got == want
    assert got[0][0] == (2, "validate", "FSC")


def test_toe_delay_detects_and_retries_like_reference():
    # one-shot delay of replica 1 at step 2, beyond the 0.15 s lapse
    delays = ({(2, 1): 0.3}, {(2, 1): 0.3})
    (jeng, js), (teng, ts) = _engines(toe_timeout_s=0.15, delays=delays)
    want = _drive(jeng, js, JSafeStop)
    got = _drive(teng, ts, SedarSafeStop)
    assert got == want == ([(2, "toe", "TOE")], [("retry", None, 1, 2)])


def test_plain_backend_never_compares():
    eng = make_engine(SedarConfig(), backend="none", step_fn=_tstep,
                      recovery=RetryRecovery(), notify=lambda e: None)
    with hostsync.count_transfers() as st:
        events, _ = _drive(eng, {"a": torch.zeros(3), "b": torch.zeros(3),
                                 "n": 0}, SedarSafeStop)
    assert events == [] and st.transfers == 0


def test_unported_backend_raises():
    """The mesh backends take the mesh step (`pod_step`, `pod_validate`),
    not a replica step: without it make_engine raises, as the reference's
    does; an unknown backend is not ported."""
    for backend in ("pod", "vote"):
        with pytest.raises(ValueError, match="needs pod_step"):
            make_engine(SedarConfig(), backend=backend, step_fn=_tstep,
                        state_fp_fn=tfp.pytree_fingerprint_fused,
                        recovery=RetryRecovery())
    with pytest.raises(NotImplementedError):
        make_engine(SedarConfig(), backend="elastic", step_fn=_tstep,
                    state_fp_fn=tfp.pytree_fingerprint_fused,
                    recovery=RetryRecovery())


def test_recovery_policies():
    from repro_torch.core.detection import DetectionEvent
    ev = DetectionEvent(step=3, boundary="commit", effect="TDC")
    assert SafeStop(notify=lambda e: None).on_detection(ev).kind == "stop"
    r = RetryRecovery(max_retries=2)
    kinds = [r.on_detection(ev).kind for _ in range(3)]
    assert kinds == ["retry", "retry", "stop"]
    r.note_success()
    assert r.on_detection(ev) == RecoveryAction(kind="retry", rollbacks=1,
                                                event=ev)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 100, 256, 257])
def test_bucket_ladder_matches_reference(n):
    assert tprefill.make_buckets(n) == jprefill.make_buckets(n)
    assert tprefill.DEFAULT_BUCKETS == jprefill.DEFAULT_BUCKETS
    assert tprefill.bucket_for(n, tprefill.DEFAULT_BUCKETS) == \
        jprefill.bucket_for(n, jprefill.DEFAULT_BUCKETS)


def test_host_reads_are_counted_per_label_and_nested():
    x = torch.arange(4)
    with hostsync.count_transfers() as outer:
        assert hostsync.read_int(x[1], label="counter") == 1
        with hostsync.count_transfers() as inner:
            a, b = hostsync.batched_get([x, x * 2], label="batch")
            assert hostsync.read_bool(x[2] > 1)
        np.testing.assert_array_equal(b, np.arange(4) * 2)
    assert inner.by_label == {"batch": 2, "predicate": 1}
    assert inner.batches == 2 and inner.transfers == 3
    assert outer.by_label == {"counter": 1, "batch": 2, "predicate": 1}
