"""The port's L1/L2/L3 recovery through its engine against the JAX
package's, on a toy step (no model in the loop): the sequential × {L1, L2,
L3} matrix of the reference's engine tests, Alg. 1's restart from scratch
and its dirty-checkpoint double rollback, Alg. 2's checkpoint validation,
and deferred validation (lag 4 and 8) with L2. The (step, boundary, effect)
event streams, the recovery records and the checkpoint lists are equal; a
recovered run ends bitwise equal to the port's own clean run, and within
f32 rounding (rtol 1e-6) of JAX's."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SedarConfig as JSedarConfig
from repro.core import fingerprint as jfp
from repro.core.detection import SedarSafeStop as JSafeStop
from repro.core.injection import InjectionSpec as JSpec
from repro.core.injection import MemoryInjectionFlag as JFlag
from repro.core.injection import inject_tree as jinject
from repro.core.policy import make_engine as jmake_engine

from repro_torch.configs import SedarConfig
from repro_torch.core import fingerprint as tfp
from repro_torch.core.detection import SedarSafeStop
from repro_torch.core.injection import InjectionSpec, MemoryInjectionFlag
from repro_torch.core.injection import inject_tree as tinject
from repro_torch.core.policy import make_engine

torch.set_num_threads(1)
N = 16


def _jstep(spec):
    """state {"x": f32[16], "y": f32[16], "step": i32}: x takes a decayed
    update; y is carried and never read (like an embedding row no token
    uses). A 'grads' fault hits the update before its fingerprint (TDC), a
    'params' fault y (FSC: only the state compare sees it)."""
    def step_fn(state, batch, rid, armed):
        delta = 0.1 * batch - 0.01 * state["x"]
        if spec is not None and spec.target == "grads":
            delta = jinject({"d": delta}, spec, step=state["step"],
                            replica_id=rid, armed=armed)["d"]
        fp = jfp.pytree_fingerprint_fused({"d": delta})
        y = state["y"]
        if spec is not None and spec.target == "params":
            y = jinject({"y": y}, spec, step=state["step"], replica_id=rid,
                        armed=armed)["y"]
        cand = {"x": state["x"] + delta, "y": y, "step": state["step"] + 1}
        return cand, fp, jnp.sum(cand["x"])
    return jax.jit(step_fn)


def _tstep(spec):
    def step_fn(state, batch, rid, armed):
        step = int(state["step"])          # a CPU tensor: the host step
        delta = 0.1 * batch - 0.01 * state["x"]
        if spec is not None and spec.target == "grads":
            delta = tinject({"d": delta}, spec, step=step, replica_id=rid,
                            armed=armed)["d"]
        fp = tfp.pytree_fingerprint_fused({"d": delta})
        y = state["y"]
        if spec is not None and spec.target == "params":
            y = tinject({"y": y}, spec, step=step, replica_id=rid,
                        armed=armed)["y"]
        cand = {"x": state["x"] + delta, "y": y, "step": state["step"] + 1}
        return cand, fp, torch.sum(cand["x"])
    return step_fn


def _xy(state):
    return {"x": state["x"], "y": state["y"]}


def _engines(workdir, level, spec=None, backend="sequential", lag=1,
             ckpt=3, validate=4):
    kw = dict(level=level, replication=backend, validate_interval=1,
              validate_lag=lag, param_validate_interval=validate,
              checkpoint_interval=ckpt)
    jw, tw = os.path.join(workdir, "jax"), os.path.join(workdir, "torch")
    jspec = None if spec is None else JSpec(**spec)
    tspec = None if spec is None else InjectionSpec(**spec)

    jeng = jmake_engine(
        JSedarConfig(checkpoint_dir=os.path.join(jw, "ckpt"), **kw),
        backend=backend, workdir=jw, step_fn=_jstep(jspec),
        state_fp_fn=jax.jit(lambda s: jfp.pytree_fingerprint(_xy(s))),
        fast_state_fp_fn=jax.jit(
            lambda s: jfp.pytree_fingerprint_fused(_xy(s))),
        inj_spec=jspec, inj_flag=JFlag(), notify=lambda e: None,
        init_fn=lambda: jeng.executor.init_dual(
            {"x": jnp.zeros((N,), jnp.float32),
             "y": jnp.ones((N,), jnp.float32),
             "step": jnp.zeros((), jnp.int32)}))
    teng = make_engine(
        SedarConfig(checkpoint_dir=os.path.join(tw, "ckpt"), **kw),
        backend=backend, workdir=tw, step_fn=_tstep(tspec),
        state_fp_fn=lambda s: tfp.leaf_fingerprints(_xy(s)),
        fast_state_fp_fn=lambda s: tfp.pytree_fingerprint_fused(_xy(s)),
        inj_spec=tspec, inj_flag=MemoryInjectionFlag(),
        notify=lambda e: None,
        init_fn=lambda: teng.executor.init_dual(
            {"x": torch.zeros(N, dtype=torch.float32),
             "y": torch.ones(N, dtype=torch.float32),
             "step": torch.zeros((), dtype=torch.int32)}))
    return jeng, teng


def _drive(eng, num_steps, safe_stop, batch_fn, max_iters=100):
    """The trainer's loop shape: the step tracked on the host, re-read once
    per recovery, the deferred window flushed before completion."""
    dual = eng.init_dual()
    eng.reset()
    step = int(np.asarray(eng.executor.peek(dual, "step")))
    stopped, it = False, 0
    while True:
        if step >= num_steps:
            event = eng.flush_deferred()
            if event is None:
                break
        else:
            it += 1
            assert it < max_iters, "engine did not converge"
            outcome = eng.run_protected_step(dual, batch_fn(step), step)
            dual = outcome.dual
            if outcome.committed:
                step += 1
            event = outcome.event
            if event is None:
                continue
        try:
            dual = eng.on_detection(event, dual)
        except safe_stop:
            stopped = True
            break
        step = int(np.asarray(eng.executor.peek(dual, "step")))
    store = getattr(eng.recovery, "store", None)
    if store is not None:
        store.wait()
    x = np.asarray(eng.executor.primary(dual)["x"])
    events = [(e.step, e.boundary, e.effect) for e in eng.detections]
    return x, stopped, events, list(eng.recoveries), list(eng.checkpoints)


def _run_both(workdir, level, spec=None, steps=10, **kw):
    jeng, teng = _engines(workdir, level, spec, **kw)
    j = _drive(jeng, steps, JSafeStop,
               lambda s: jnp.full((N,), float(s + 1), jnp.float32))
    t = _drive(teng, steps, SedarSafeStop,
               lambda s: torch.full((N,), float(s + 1)))
    return j, t, jeng, teng


def _assert_same_protocol(j, t):
    assert t[2] == j[2]          # events
    assert t[3] == j[3]          # recovery records
    assert t[4] == j[4]          # checkpoints
    assert t[1] == j[1]          # stopped
    np.testing.assert_allclose(t[0], j[0], rtol=1e-6)


def _clean_x(workdir, level, **kw):
    _, t, _, _ = _run_both(workdir + "_clean", level, **kw)
    assert not t[2]
    return t[0]


GRADS4 = dict(leaf_idx=0, flat_idx=5, bit=20, step=4, replica=1,
              target="grads")


@pytest.mark.parametrize("level,kinds", [(1, ["stop"]), (2, ["restore"]),
                                         (3, ["restore"])])
def test_matrix_sequential_matches_jax(tmp_workdir, level, kinds):
    j, t, _, _ = _run_both(tmp_workdir, level, GRADS4, steps=8)
    _assert_same_protocol(j, t)
    assert t[2] == [(4, "commit", "TDC")]
    assert [r["kind"] for r in t[3]] == kinds
    if level > 1:
        assert t[3][0]["rollbacks"] == 1 and t[3][0]["step"] == 3
        np.testing.assert_array_equal(t[0], _clean_x(tmp_workdir, level,
                                                     steps=8))


def test_l2_restart_from_scratch_matches_jax(tmp_workdir):
    spec = dict(GRADS4, step=1)
    j, t, _, _ = _run_both(tmp_workdir, 2, spec, steps=6, ckpt=5)
    _assert_same_protocol(j, t)
    assert [r["kind"] for r in t[3]] == ["restart_scratch"]
    np.testing.assert_array_equal(t[0], _clean_x(tmp_workdir, 2, steps=6,
                                                 ckpt=5))


def test_l2_dirty_checkpoint_double_rollback_matches_jax(tmp_workdir):
    """An FSC fault at step 4: the checkpoint cut at 6 is dirty, so Alg. 1
    rolls back twice (to 6, then 3) — the toy form of paper scenario 50."""
    spec = dict(GRADS4, target="params", bit=22)
    j, t, _, teng = _run_both(tmp_workdir, 2, spec, validate=8)
    _assert_same_protocol(j, t)
    assert t[2] == [(8, "validate", "FSC"), (8, "validate", "FSC")]
    assert [(r["step"], r["rollbacks"]) for r in t[3]] == [(6, 1), (3, 2)]
    np.testing.assert_array_equal(t[0], _clean_x(tmp_workdir, 2, validate=8))
    assert teng.recovery.counter.value() == 2       # outside the payload


def test_l3_checkpoint_validation_fails_and_rolls_back(tmp_workdir):
    """Alg. 2: with no FSC cadence, the checkpoint boundary's replica
    compare finds the FSC fault, stores nothing, and restores the previous
    valid checkpoint."""
    spec = dict(GRADS4, target="params", bit=22)
    j, t, _, teng = _run_both(tmp_workdir, 3, spec, validate=0)
    _assert_same_protocol(j, t)
    assert t[2] == [(6, "ckpt_validate", "FSC")]
    assert t[3][0]["step"] == 3 and t[3][0]["version"] == 3
    assert teng.recovery.store.steps() == [9]
    assert teng.recovery.store.manifest(9).valid is True
    np.testing.assert_array_equal(t[0], _clean_x(tmp_workdir, 3, validate=0))


@pytest.mark.parametrize("lag", [4, 8])
def test_deferred_window_with_l2_matches_jax(tmp_workdir, lag):
    """Lag D: the fault is found at the window's flush (or a checkpoint
    boundary's), rolls back to a checkpoint at or before the faulty step,
    and the replay equals the port's clean lag-1 run."""
    j, t, jeng, teng = _run_both(tmp_workdir, 2, GRADS4, lag=lag,
                                 validate=0)
    _assert_same_protocol(j, t)
    jd = [e.detail for e in jeng.detections]
    td = [e.detail for e in teng.detections]
    assert td == jd and td[0]["faulty_steps"][0] == 4
    assert t[2][0][1] == "deferred"
    np.testing.assert_array_equal(t[0], _clean_x(tmp_workdir, 2, validate=0))


def test_plain_baseline_commits_the_fault(tmp_workdir):
    spec = dict(GRADS4, replica=0)
    j, t, _, _ = _run_both(tmp_workdir, 1, spec, backend="none", steps=8)
    _assert_same_protocol(j, t)
    assert t[2] == [] and t[3] == []
    clean = _clean_x(tmp_workdir, 1, backend="none", steps=8)
    assert not np.array_equal(t[0], clean)
