"""The port's fused, abft and hybrid trainers against the JAX package's, at
the reduced paper-testapp of `tests/test_detection_recovery.py`, from one
state (`bridge.train_state_from_numpy`).

Event streams (step, boundary, effect), recovery records, checkpoints,
`stopped` and the step count come from JAX; losses agree with JAX's within
rtol 1e-5 (f32, different reduction orders). Bits come from inside the
port: a recovered run's final per-leaf fingerprints and losses are bitwise
equal to the port's own clean run of the same backend (the JAX fused
path's replay is not bit-identical to its lag-1 runs, so no bits are taken
from it). Fused runs both replicas stacked on a leading axis through
`torch.vmap`; on the CPU with one thread its trajectory is bitwise equal to
sequential's.

Covered: the nine scenarios under fused; fused at lag 4 and 8 (the device
commit gate of the deferred window); the reference's
`test_trainer_runs_replica_free_backends` runs; hybrid's catch of an
at-rest parameter fault at its entry check and pure abft's miss of it;
the launcher's new flags."""
import contextlib
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRunConfig
from repro.configs import SedarConfig as JSedarConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.injection import InjectionSpec as JSpec
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import build_model as jbuild_model
from repro.optim import make_optimizer as jmake_optimizer
from repro.runtime.train import SedarTrainer as JTrainer

from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import (RunConfig, SedarConfig, TrainConfig,
                                 get_config, reduce_for_smoke)
from repro_torch.core.engine import StackedFusedExecutor, replica_view
from repro_torch.core.injection import InjectionSpec
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.runtime.train import SedarTrainer

torch.set_num_threads(1)

JCFG = jreduce(jget_config("paper-testapp"))
CFG = reduce_for_smoke(get_config("paper-testapp"))
TRAIN = dict(global_batch=4, seq_len=16, steps=10, warmup_steps=2, lr=1e-3)
LOSS_RTOL = 1e-5

SPECS = {
    "grads4": dict(leaf_idx=3, flat_idx=5, bit=20, step=4, replica=1,
                   target="grads"),
    "grads5": dict(leaf_idx=3, flat_idx=5, bit=20, step=5, replica=1,
                   target="grads"),
    "embed_row250": dict(leaf_idx=1, flat_idx=250 * CFG.d_model + 3, bit=22,
                         step=4, replica=1, target="params"),
    "never": dict(leaf_idx=1, flat_idx=3, bit=22, step=99, replica=1,
                  target="params"),
    "opt5": dict(leaf_idx=2, flat_idx=7, bit=22, step=5, replica=1,
                 target="opt_state"),
}
# name -> (backend, level, spec, data vocab or None, toe delay, overrides)
SCENARIOS = {
    "fused_l1": ("fused", 1, "grads4", None, None, {}),
    "fused_l3_tdc": ("fused", 3, "grads5", None, None, {}),
    "fused_l2_dirty": ("fused", 2, "embed_row250", 200, None,
                       dict(checkpoint_interval=3,
                            param_validate_interval=8)),
    "fused_le": ("fused", 3, "never", 200, None, {}),
    # fused has no per-replica timing (one launch for both): no TOE
    "fused_toe": ("fused", 3, None, None, {(5, 1): 2.0},
                  dict(toe_timeout_s=0.5)),
    "fused_l3_clean": ("fused", 3, None, None, None, {}),
    "fused_l2_chain": ("fused", 2, None, None, None,
                       dict(checkpoint_interval=2)),
    "fused_opt_l2": ("fused", 2, "opt5", None, None, {}),
    "fused_clean": ("fused", 1, None, None, None, {}),
    "fused_clean_v200": ("fused", 1, None, 200, None, {}),
    "fused_lag4": ("fused", 2, "grads5", None, None, dict(validate_lag=4)),
    "fused_lag8": ("fused", 2, "grads5", None, None, dict(validate_lag=8)),
    # the reference's test_trainer_runs_replica_free_backends config
    "abft_free": ("abft", 2, None, None, None,
                  dict(param_validate_interval=2, checkpoint_interval=2)),
    "hybrid_free": ("hybrid", 2, None, None, None,
                    dict(param_validate_interval=2, checkpoint_interval=2)),
}
NINE = ["fused_l1", "fused_l3_tdc", "fused_l2_dirty", "fused_le",
        "fused_toe", "fused_l3_clean", "fused_l2_chain", "fused_clean",
        "fused_clean_v200"]

_runs = {}


@pytest.fixture(scope="module")
def state_np():
    params = jbuild_model(JCFG).init(jax.random.PRNGKey(0))
    opt = jmake_optimizer(JTrainConfig(**TRAIN)).init(params)
    return jax.tree.map(np.asarray, {"params": params, "opt": opt,
                                     "step": jnp.zeros((), jnp.int32)})


def _sedar(backend, level, overrides):
    kw = dict(level=level, replication=backend, validate_interval=1,
              param_validate_interval=4, checkpoint_interval=4,
              toe_timeout_s=60.0)
    kw.update(overrides)
    return kw


def _trainer(pkg, name, wd, steps=10):
    backend, level, spec, vocab, _, over = SCENARIOS[name]
    if pkg == "jax":
        rc = JRunConfig(model=JCFG, train=JTrainConfig(**TRAIN),
                        sedar=JSedarConfig(**_sedar(backend, level, over)))
        return JTrainer(rc, wd, inj_spec=spec and JSpec(**SPECS[spec]),
                        data=vocab and JSyntheticLM(vocab, 4, 16, seed=0),
                        notify=lambda e: None)
    rc = RunConfig(model=CFG, train=TrainConfig(**TRAIN),
                   sedar=SedarConfig(**_sedar(backend, level, over)))
    return SedarTrainer(rc, wd,
                        inj_spec=spec and InjectionSpec(**SPECS[spec]),
                        data=vocab and SyntheticLM(vocab, 4, 16, seed=0),
                        notify=lambda e: None, device="cpu")


def _state(pkg, state_np):
    if pkg == "jax":
        return jax.tree.map(jnp.asarray, state_np)
    return bridge.train_state_from_numpy(state_np)


def _run(pkg, name, state_np, tmp_path_factory):
    key = (pkg, name)
    if key not in _runs:
        toe = SCENARIOS[name][4]
        tr = _trainer(pkg, name, str(tmp_path_factory.mktemp(f"{pkg}_{name}")))
        state = _state(pkg, state_np)
        if toe:
            tr.run(1, dual=tr.engine.executor.init_dual(state))
            tr.toe_delay = dict(toe)
        _, rep = tr.run(10, dual=tr.engine.executor.init_dual(state))
        _runs[key] = (rep, tr)
    return _runs[key]


def _same_stream(trep, jrep):
    assert [(e.step, e.boundary, e.effect) for e in trep.detections] == \
        [(e.step, e.boundary, e.effect) for e in jrep.detections]
    assert trep.recoveries == jrep.recoveries
    assert trep.checkpoints == jrep.checkpoints
    assert trep.stopped == jrep.stopped
    assert trep.steps_completed == jrep.steps_completed
    assert trep.restored_from == jrep.restored_from
    assert trep.final_state_fp.shape == jrep.final_state_fp.shape
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=LOSS_RTOL)


@pytest.fixture
def both(state_np, tmp_path_factory):
    """name -> (port report, port trainer), after holding the port's run to
    JAX's event and recovery streams."""
    def get(name):
        jrep, _ = _run("jax", name, state_np, tmp_path_factory)
        trep, ttr = _run("torch", name, state_np, tmp_path_factory)
        _same_stream(trep, jrep)
        return trep, ttr
    return get


@pytest.fixture
def own(state_np, tmp_path_factory):
    """The port's own run of a scenario (no JAX run): the bitwise oracle."""
    def get(name):
        return _run("torch", name, state_np, tmp_path_factory)[0]
    return get


def _bitwise(a, b) -> bool:
    return (np.array_equal(a.final_state_fp[:, :2], b.final_state_fp[:, :2])
            and a.losses == b.losses)


@pytest.mark.parametrize("name", NINE)
def test_fused_streams_equal_jax_fused(both, name):
    rep, tr = both(name)
    assert isinstance(tr.engine.executor, StackedFusedExecutor)
    if name in ("fused_clean", "fused_clean_v200", "fused_l3_clean",
                "fused_l2_chain", "fused_toe", "fused_le"):
        assert not rep.detections and rep.steps_completed == 10


def test_fused_l1_detects_and_stops(both):
    rep, _ = both("fused_l1")
    assert rep.stopped
    assert [(e.step, e.boundary) for e in rep.detections] == [(4, "commit")]
    assert rep.detections[0].detail == {"fused": True}


@pytest.mark.parametrize("name,oracle", [
    ("fused_l3_tdc", "fused_clean"),
    ("fused_l2_dirty", "fused_clean_v200"),
    ("fused_opt_l2", "fused_clean"),
    ("fused_lag4", "fused_clean"),
    ("fused_lag8", "fused_clean"),
])
def test_fused_recovered_run_bitwise_equals_fused_clean(both, own, name,
                                                        oracle):
    rep, _ = both(name)
    assert rep.detections and rep.steps_completed == 10
    assert _bitwise(rep, own(oracle))


def test_fused_l2_dirty_double_rollback(both):
    rep, _ = both("fused_l2_dirty")
    assert [e.effect for e in rep.detections] == ["FSC", "FSC"]
    assert [(r["step"], r["rollbacks"]) for r in rep.recoveries] == \
        [(6, 1), (3, 2)]


@pytest.mark.parametrize("name,lag", [("fused_lag4", 4), ("fused_lag8", 8)])
def test_fused_deferred_window_detects_at_flush(both, name, lag):
    """The deferred window parks the device predicate; the device gate
    freezes both replicas at the faulty step; the flush localizes step 5
    and L2 restores the checkpoint at 4, as JAX fused does."""
    rep, tr = both(name)
    assert tr.engine.validate_lag == lag
    ev = rep.detections[0]
    assert (ev.step, ev.boundary) == (5, "deferred")
    assert ev.detail["faulty_steps"] == [5]
    assert rep.recoveries[0]["step"] == 4


def test_fused_matches_sequential_bitwise_on_the_cpu(own, state_np,
                                                     tmp_path_factory):
    """Finding: on the CPU with one thread, the vmapped fused step gives
    the sequential backend's bits (on the card cuBLAS may choose other
    algorithms for the batched products: PERF.md)."""
    wd = str(tmp_path_factory.mktemp("seq_clean"))
    rc = RunConfig(model=CFG, train=TrainConfig(**TRAIN),
                   sedar=SedarConfig(**_sedar("sequential", 1, {})))
    tr = SedarTrainer(rc, wd, notify=lambda e: None, device="cpu")
    state = bridge.train_state_from_numpy(state_np)
    _, seq = tr.run(10, dual=tr.engine.executor.init_dual(state))
    assert _bitwise(own("fused_clean"), seq)


def test_fused_state_stacks_on_a_leading_axis(both):
    _, tr = both("fused_clean")
    state = tr.init_state(seed=0)
    dual = tr.engine.executor.init_dual(state)
    for a, b in zip(tree_util.leaves(dual["s"]), tree_util.leaves(state)):
        assert a.shape == (2,) + tuple(b.shape)
        assert torch.equal(a[0], b) and torch.equal(a[1], b)
    assert tr.engine.executor.peek(dual, "step").shape == ()
    prim = tr.engine.executor.primary(dual)
    assert all(x.data_ptr() == y.data_ptr() for x, y in zip(
        tree_util.leaves(prim), tree_util.leaves(replica_view(dual["s"], 0))))


def test_fused_grads_fault_lands_on_replica_1_only(state_np, tmp_path):
    """The injection writes replica 1's slice of the stacked grads: the two
    grads fingerprints of the fused step differ, replica 0's equals a
    clean step's."""
    tr = _trainer("torch", "fused_l3_tdc", str(tmp_path))
    dual = tr.engine.executor.init_dual(_state("torch", state_np))
    batch = (5, tr.batch(5))
    _, fps, _ = tr._fused_step(dual["s"], batch, True)
    _, clean, _ = tr._fused_step(dual["s"], batch, False)
    assert not torch.equal(fps[0, :2], fps[1, :2])
    assert torch.equal(fps[0], clean[0]) and torch.equal(clean[0], clean[1])


@pytest.mark.parametrize("name", ["abft_free", "hybrid_free"])
def test_trainer_runs_replica_free_backends(both, name):
    """The reference's test_abft.py::test_trainer_runs_replica_free_backends
    on both trainers: the unmodified single-state step, no detection."""
    rep, tr = both(name)
    assert tr.engine.executor.name == name.split("_")[0]
    assert rep.steps_completed == 10
    assert not rep.detections and not rep.stopped
    assert len(rep.losses) == 10
    assert rep.checkpoints == [2, 4, 6, 8, 10]


def _rest_fault(pkg, backend, state_np, wd):
    """Run 4 steps, flip bit 20 of embed.tok element 5 in the resident
    state, then run on to 8: an at-rest fault before the entry check at
    step 4."""
    name = f"{backend}_free"
    tr = _trainer(pkg, name, wd)
    dual, r1 = tr.run(4, dual=tr.engine.executor.init_dual(
        _state(pkg, state_np)))
    if pkg == "jax":
        tok = np.array(dual["r0"]["params"]["embed"]["tok"])
        tok.reshape(-1)[5:6].view(np.uint32)[0] ^= np.uint32(1 << 20)
        params = dict(dual["r0"]["params"],
                      embed=dict(dual["r0"]["params"]["embed"],
                                 tok=jnp.asarray(tok)))
        dual = {"r0": dict(dual["r0"], params=params)}
    else:
        tok = tr.engine.executor.primary(dual)["params"]["embed"]["tok"]
        tok.view(-1)[5:6].view(torch.int32).bitwise_xor_(1 << 20)
    _, r2 = tr.run(8, dual=dual)
    return r1, r2


@pytest.fixture(scope="module")
def rest_runs(state_np, tmp_path_factory):
    out = {}
    for pkg in ("jax", "torch"):
        for backend in ("hybrid", "abft"):
            out[pkg, backend] = _rest_fault(
                pkg, backend, state_np,
                str(tmp_path_factory.mktemp(f"rest_{pkg}_{backend}")))
    for backend in ("hybrid", "abft"):
        tr = _trainer("torch", f"{backend}_free",
                      str(tmp_path_factory.mktemp(f"rest_clean_{backend}")))
        out["clean", backend] = tr.run(8, dual=tr.engine.executor.init_dual(
            _state("torch", state_np)))[1]
    return out


def test_hybrid_catches_at_rest_fault_like_jax(rest_runs):
    """Hybrid's entry check at step 4 sees the resident state differ from
    its commit-time fingerprint (FSC, no step executed) and L2 restores
    the checkpoint at 4, as the reference's does."""
    _, t2 = rest_runs["torch", "hybrid"]
    _, j2 = rest_runs["jax", "hybrid"]
    _same_stream(t2, j2)
    assert [(e.step, e.boundary, e.effect) for e in t2.detections] == \
        [(4, "validate", "FSC")]
    assert [(r["kind"], r["step"]) for r in t2.recoveries] == \
        [("restore", 4)]


def test_hybrid_at_rest_recovery_bitwise_equals_hybrid_clean(rest_runs):
    t1, t2 = rest_runs["torch", "hybrid"]
    clean = rest_runs["clean", "hybrid"]
    assert np.array_equal(t2.final_state_fp[:, :2],
                          clean.final_state_fp[:, :2])
    assert t1.losses + t2.losses == clean.losses


def test_pure_abft_misses_the_at_rest_fault_like_jax(rest_runs):
    _, t2 = rest_runs["torch", "abft"]
    _, j2 = rest_runs["jax", "abft"]
    _same_stream(t2, j2)
    assert not t2.detections
    assert not np.array_equal(t2.final_state_fp[:, :2],
                              rest_runs["clean", "abft"].final_state_fp[:, :2])


def test_hybrid_validated_fp_reads_the_resident_compare(state_np, tmp_path):
    """L3's validated checkpoint under hybrid: "equal" is the resident
    state's compare with its commit-time fingerprint, so an at-rest fault
    after the commit fails the checkpoint's validation."""
    tr = _trainer("torch", "hybrid_free", str(tmp_path))
    ex = tr.engine.executor
    dual, _ = tr.run(2, dual=ex.init_dual(_state("torch", state_np)))
    fp, equal = ex.validated_fp(dual)
    assert equal and fp.shape == (
        3 * len(tree_util.leaves(dual["r0"]["params"])), 4)
    ex.primary(dual)["params"]["final_ln"].view(-1)[0:1].view(
        torch.int32).bitwise_xor_(1 << 22)
    assert ex.validated_fp(dual)[1] is False


def test_abft_trainer_skips_the_grads_fingerprint(state_np, tmp_path):
    """No second replica: the single-instance step returns no grads
    fingerprint (the reference computes one and never reads it)."""
    tr = _trainer("torch", "abft_free", str(tmp_path))
    state = _state("torch", state_np)
    _, fp, _ = tr._replica_step(state, (0, tr.batch(0)), 0, False)
    assert fp is None


@pytest.mark.parametrize("replication", ["fused", "abft", "hybrid"])
def test_launcher_runs_the_new_backends(tmp_path, monkeypatch, replication):
    argv = ["train", "--device", "cpu", "--steps", "6", "--level", "3",
            "--ckpt-interval", "2", "--inject-step", "3", "--replication",
            replication, "--workdir", str(tmp_path / "wd")]
    monkeypatch.setattr(sys, "argv", argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main()
    text = out.getvalue()
    if replication == "fused":
        assert "steps=6 detections=1 recoveries=1 ckpts=3" in text
        assert "fault detected at step 3 (boundary=commit, TDC)" in text
    else:
        # the grads fault has no replica to be compared with: undetected,
        # as in the reference
        assert "steps=6 detections=0 recoveries=0 ckpts=3" in text


@pytest.mark.parametrize("replication", ["fused", "abft", "hybrid"])
def test_trainer_raises_without_a_card(tmp_path, replication):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the trainer would use it")
    rc = RunConfig(model=CFG, train=TrainConfig(**TRAIN),
                   sedar=SedarConfig(level=3, replication=replication))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SedarTrainer(rc, str(tmp_path / "wd"))
