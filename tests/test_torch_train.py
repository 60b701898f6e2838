"""The port's protected trainer against the JAX package's, at the reduced
paper-testapp of `tests/test_detection_recovery.py`: its nine scenarios run
on both trainers from one state (`bridge.train_state_from_numpy`). Events
(step, boundary, effect), recovery records, checkpoints, `stopped` and the
step count are equal; losses agree within rtol 1e-5 (f32, different
reduction orders); a recovered run's final per-leaf fingerprints are
bitwise equal to the port's own clean run. Also the loss and its gradients
against JAX's (both CE paths), the launcher on the CPU, and the loud
failures of what is not ported."""
import contextlib
import dataclasses
import io
import os
import sys
import tempfile

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
from repro.models import transformer as jtfm
from repro.optim import make_optimizer as jmake_optimizer
from repro.runtime.train import SedarTrainer as JTrainer

from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import (RunConfig, SedarConfig, TrainConfig,
                                 get_config, reduce_for_smoke)
from repro_torch.core.injection import InjectionSpec
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as ttfm
from repro_torch.runtime.train import SedarTrainer

torch.set_num_threads(1)

JCFG = jreduce(jget_config("paper-testapp"))
CFG = reduce_for_smoke(get_config("paper-testapp"))
TRAIN = dict(global_batch=4, seq_len=16, steps=10, warmup_steps=2, lr=1e-3)
LOSS_RTOL = 1e-5

# the reference tests' specs (tests/test_detection_recovery.py)
SPECS = {
    "grads4": dict(leaf_idx=3, flat_idx=5, bit=20, step=4, replica=1,
                   target="grads"),
    "grads5": dict(leaf_idx=3, flat_idx=5, bit=20, step=5, replica=1,
                   target="grads"),
    "embed_row250": dict(leaf_idx=1, flat_idx=250 * CFG.d_model + 3, bit=22,
                         step=4, replica=1, target="params"),
    "never": dict(leaf_idx=1, flat_idx=3, bit=22, step=99, replica=1,
                  target="params"),
    "grads5_r0": dict(leaf_idx=3, flat_idx=5, bit=20, step=5, replica=0,
                      target="grads"),
}
# name -> (level, spec, data vocab or None, toe delay, sedar overrides)
SCENARIOS = {
    "l1": (1, "grads4", None, None, {}),
    "l3_tdc": (3, "grads5", None, None, {}),
    "l2_dirty": (2, "embed_row250", 200, None,
                 dict(checkpoint_interval=3, param_validate_interval=8)),
    "le": (3, "never", 200, None, {}),
    # replica 1 stalls 2 s at step 5 against a 0.5 s timeout (the
    # reference test's 0.8 s left a 0.3 s margin, which a loaded CPU can
    # eat from replica 0's own step)
    "toe": (3, None, None, {(5, 1): 2.0}, dict(toe_timeout_s=0.5)),
    "l3_clean": (3, None, None, None, {}),
    "l2_chain": (2, None, None, None, dict(checkpoint_interval=2)),
    "plain": (1, "grads5_r0", 200, None, dict(replication="none")),
    "clean": (1, None, None, None, {}),
    "clean_v200": (1, None, 200, None, {}),
}

_runs = {}


@pytest.fixture(scope="module")
def state_np():
    """One initial training state (the JAX model's seeded init + zero adamw
    moments) as numpy, the start of every run of both trainers."""
    params = jbuild_model(JCFG).init(jax.random.PRNGKey(0))
    opt = jmake_optimizer(JTrainConfig(**TRAIN)).init(params)
    return jax.tree.map(np.asarray, {"params": params, "opt": opt,
                                     "step": jnp.zeros((), jnp.int32)})


def _sedar(level, overrides):
    kw = dict(level=level, replication="sequential", validate_interval=1,
              param_validate_interval=4, checkpoint_interval=4,
              toe_timeout_s=60.0)
    kw.update(overrides)
    return kw


def _run(pkg, name, state_np, tmp_path_factory):
    """The scenario's run on one trainer, once per module."""
    key = (pkg, name)
    if key not in _runs:
        level, spec, vocab, toe, over = SCENARIOS[name]
        wd = str(tmp_path_factory.mktemp(f"{pkg}_{name}"))
        if pkg == "jax":
            rc = JRunConfig(model=JCFG, train=JTrainConfig(**TRAIN),
                            sedar=JSedarConfig(**_sedar(level, over)))
            data = vocab and JSyntheticLM(vocab, 4, 16, seed=0)
            tr = JTrainer(rc, wd, inj_spec=spec and JSpec(**SPECS[spec]),
                          data=data, notify=lambda e: None)
            state = jax.tree.map(jnp.asarray, state_np)
        else:
            rc = RunConfig(model=CFG, train=TrainConfig(**TRAIN),
                           sedar=SedarConfig(**_sedar(level, over)))
            data = vocab and SyntheticLM(vocab, 4, 16, seed=0)
            tr = SedarTrainer(rc, wd,
                              inj_spec=spec and InjectionSpec(**SPECS[spec]),
                              data=data, notify=lambda e: None, device="cpu")
            state = bridge.train_state_from_numpy(state_np)
        if toe:
            # one warm-up step first, so a TOE can only come from the
            # scenario's delay (JAX compiles at the first call: replica 0's
            # first step would outlast replica 1's by the compile time)
            tr.run(1, dual=tr.engine.executor.init_dual(state))
            tr.toe_delay = dict(toe)
        _, rep = tr.run(10, dual=tr.engine.executor.init_dual(state))
        _runs[key] = (rep, tr)
    return _runs[key]


@pytest.fixture
def both(state_np, tmp_path_factory):
    """name -> (port report, port trainer), after checking the port's run
    against JAX's."""
    def get(name):
        jrep, _ = _run("jax", name, state_np, tmp_path_factory)
        trep, ttr = _run("torch", name, state_np, tmp_path_factory)
        assert [(e.step, e.boundary, e.effect) for e in trep.detections] == \
            [(e.step, e.boundary, e.effect) for e in jrep.detections]
        assert trep.recoveries == jrep.recoveries
        assert trep.checkpoints == jrep.checkpoints
        assert trep.stopped == jrep.stopped
        assert trep.steps_completed == jrep.steps_completed
        assert trep.final_state_fp.shape == jrep.final_state_fp.shape
        np.testing.assert_allclose(trep.losses, jrep.losses, rtol=LOSS_RTOL)
        return trep, ttr
    return get


@pytest.fixture
def clean_fp(state_np, tmp_path_factory):
    def get(name="clean"):
        rep, _ = _run("torch", name, state_np, tmp_path_factory)
        assert not rep.detections
        return rep.final_state_fp
    return get


def test_l1_detects_and_stops(both):
    rep, _ = both("l1")
    assert rep.stopped
    assert [(e.step, e.boundary) for e in rep.detections] == [(4, "commit")]


def test_l3_tdc_single_rollback_bitexact(both, clean_fp):
    rep, _ = both("l3_tdc")
    assert len(rep.detections) == 1
    assert rep.recoveries[0]["kind"] == "restore"
    assert rep.recoveries[0]["rollbacks"] == 1
    assert np.array_equal(rep.final_state_fp[:, :2], clean_fp()[:, :2])


def test_l2_dirty_checkpoint_double_rollback(both, clean_fp):
    rep, _ = both("l2_dirty")
    assert [e.effect for e in rep.detections] == ["FSC", "FSC"]
    assert [(r["step"], r["rollbacks"]) for r in rep.recoveries] == \
        [(6, 1), (3, 2)]
    assert np.array_equal(rep.final_state_fp[:, :2],
                          clean_fp("clean_v200")[:, :2])


def test_le_dead_data_not_detected(both, clean_fp):
    rep, _ = both("le")
    assert not rep.detections
    assert np.array_equal(rep.final_state_fp[:, :2],
                          clean_fp("clean_v200")[:, :2])


def test_toe_detected_and_recovered(both):
    rep, _ = both("toe")
    assert any(e.boundary == "toe" for e in rep.detections)
    assert rep.steps_completed == 10


def test_l3_single_valid_checkpoint_invariant(both):
    _, tr = both("l3_clean")
    store = tr.recovery.store
    assert len(store.steps()) == 1
    assert store.manifest(store.steps()[0]).valid is True


def test_l2_chain_never_pruned(both):
    rep, tr = both("l2_chain")
    assert len(tr.recovery.store.steps()) == len(rep.checkpoints) >= 4


def test_injection_flag_prevents_reinjection(both):
    rep, tr = both("l3_tdc")
    assert len(rep.detections) == 1
    assert rep.steps_completed == 10
    assert tr.inj_flag.already_injected()


def test_plain_mode_ignores_faults(both, clean_fp):
    rep, _ = both("plain")
    assert not rep.detections
    assert not np.array_equal(rep.final_state_fp[:, :2],
                              clean_fp("clean_v200")[:, :2])


@pytest.mark.parametrize("seq", [16, 520])
def test_loss_and_grads_match_jax(state_np, seq):
    """lm_loss and its gradients, both CE paths (520 > CE_CHUNK streams the
    head + CE in two chunks, the second padded): loss within rtol 1e-5,
    every gradient leaf within rtol 1e-4 / atol 1e-6 of JAX's."""
    batch = SyntheticLM(CFG.vocab_size, 2, seq, seed=1).batch(0)
    jp = jax.tree.map(jnp.asarray, state_np["params"])
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtfm.lm_loss(JCFG, p, b)[0]))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = bridge.params_from_numpy(state_np["params"])
    leaves = [p.requires_grad_(True) for p in tree_util.leaves(tp)]
    tloss = ttfm.lm_loss(CFG, tree_util.unflatten_like(tp, leaves),
                         {k: torch.from_numpy(v.astype(np.int64))
                          for k, v in batch.items()})[0]
    tg = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    for a, b in zip(tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_launcher_runs_on_the_cpu(tmp_path, monkeypatch):
    argv = ["train", "--device", "cpu", "--steps", "6", "--level", "3",
            "--ckpt-interval", "2", "--inject-step", "3",
            "--workdir", str(tmp_path / "wd")]
    monkeypatch.setattr(sys, "argv", argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main()
    text = out.getvalue()
    assert "steps=6 detections=1 recoveries=1 ckpts=3 stopped=False" in text
    assert "fault detected at step 3 (boundary=commit, TDC)" in text
    assert "'kind': 'restore', 'step': 2, 'rollbacks': 1" in text


def test_launcher_defaults_to_a_fresh_workdir(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    other = tmp_path / "sedar_train"
    other.mkdir()
    (other / "keep").write_text("another run's file")
    monkeypatch.setattr(sys, "argv", ["train", "--device", "cpu", "--steps",
                                      "2", "--level", "1"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main()
    wd = out.getvalue().splitlines()[-1].removeprefix("workdir: ")
    assert os.path.dirname(wd) == str(tmp_path) and os.path.isdir(wd)
    assert os.path.basename(wd).startswith("sedar_train_")
    assert (other / "keep").read_text() == "another run's file"


def test_launcher_raises_without_a_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would use it")
    monkeypatch.setattr(sys, "argv", ["train", "--steps", "2",
                                      "--workdir", str(tmp_path / "wd")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main()


@pytest.mark.parametrize("what", ["pod", "vote", "pallas"])
def test_what_is_not_ported_raises(tmp_path, what):
    """K2 has no backward (as in the reference), so training with pallas
    attention is not ported; the mesh backends train one process per rank
    and raise without their process mesh (tests/test_torch_mesh*.py train
    them)."""
    sedar = SedarConfig(level=3, replication="sequential")
    model = CFG
    if what == "pallas":
        model = dataclasses.replace(CFG, attention_impl="pallas")
    else:
        sedar = dataclasses.replace(sedar, replication=what)
    rc = RunConfig(model=model, train=TrainConfig(**TRAIN), sedar=sedar)
    err, match = ((NotImplementedError, None) if what == "pallas"
                  else (ValueError, "needs mesh="))
    with pytest.raises(err, match=match):
        tr = SedarTrainer(rc, str(tmp_path / "wd"), device="cpu")
        tr.run(1)
