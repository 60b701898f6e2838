"""End-to-end telemetry on the port, against the JAX package's, on the CPU.

  * Training (paper-testapp, reduced, both trainers from one state, as in
    tests/test_torch_train.py): a grads fault under L2 and under L3 leaves
    journal payloads (`detection`/`event`, `recovery`/`record`, and the
    checkpoint lines' steps) equal to JAX's for the same InjectionSpec,
    and each journal reconciles with its engine. The journal framing's
    `t_mono` (each run's host clock) is left out of every comparison;
    nothing else in these payloads is wall time. One field is not held
    bitwise: a commit mismatch report's per-leaf hash words and f32 sums
    describe each package's own f32 state, which agree within rtol 1e-5
    (the losses' tolerance), not bit for bit; the report is compared by
    its leaf paths, and its sums within rtol 1e-4.
  * Continuous serve() (reduced qwen2-0.5b, the workload of
    tests/test_torch_serve_batched.py) at lag 8 with a slot fault: the
    same rule. The trace holds the serving spans.
  * Metrics on adds no host read: the same `count_transfers` labels with
    metrics, journal and trace on as off, serving at lag 8 and training,
    and the same tokens and losses.
  * serve() follows an autotuner reconfig from lag 8 to lag 1 mid-run:
    the same reconfig record as JAX's, and every request's tokens equal
    the clean lag-8 run's.
  * The launchers with `--metrics-dir --trace --autotune --device cpu`,
    and `launch/status.py` on their output."""
import contextlib
import copy
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import RunConfig as JRunConfig
from repro.configs import SedarConfig as JSedarConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core import policy as jpolicy
from repro.core import temporal_model as jtm
from repro.core.injection import InjectionSpec as JSpec
from repro.models import build_model as jbuild_model
from repro.optim import make_optimizer as jmake_optimizer
from repro.runtime.scheduler import synthetic_requests as jsynthetic
from repro.runtime.serve import SedarServer as JServer
from repro.runtime.train import SedarTrainer as JTrainer

from repro_torch import bridge
from repro_torch import obs as tobs
from repro_torch.configs import (RunConfig, SedarConfig, TrainConfig,
                                 get_config, reduce_for_smoke)
from repro_torch.core import hostsync
from repro_torch.core import policy as tpolicy
from repro_torch.core import temporal_model as ttm
from repro_torch.core.injection import InjectionSpec
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import status as launch_status
from repro_torch.launch import train as launch_train
from repro_torch.runtime.scheduler import synthetic_requests
from repro_torch.runtime.serve import SedarServer
from repro_torch.runtime.train import SedarTrainer

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reset_switchboards():
    yield
    for o in (tobs, jobs):
        o.disable_metrics()
        o.set_journal(None)
        o.disable_trace()
        o.shutdown()


def _payloads(o, records):
    """What the journal says of the engine, framing (`seq`, `t_mono`)
    stripped."""
    return {"detections": o.payloads(records, "detection", "event"),
            "recoveries": o.payloads(records, "recovery", "record"),
            "checkpoints": [r["step"] for r in records
                            if r["kind"] == "checkpoint"],
            "kinds": [r["kind"] for r in records]}


# ---------------------------------------------------------------------------
# training: paper-testapp, L2 and L3 with a grads fault
# ---------------------------------------------------------------------------

JCFG = jreduce(jget_config("paper-testapp"))
CFG = reduce_for_smoke(get_config("paper-testapp"))
TRAIN = dict(global_batch=4, seq_len=16, steps=8, warmup_steps=2, lr=1e-3)
GRADS5 = dict(leaf_idx=3, flat_idx=5, bit=20, step=5, replica=1,
              target="grads")


@pytest.fixture(scope="module")
def state_np():
    params = jbuild_model(JCFG).init(jax.random.PRNGKey(0))
    opt = jmake_optimizer(JTrainConfig(**TRAIN)).init(params)
    return jax.tree.map(np.asarray, {"params": params, "opt": opt,
                                     "step": jnp.zeros((), jnp.int32)})


def _sedar(level):
    return dict(level=level, replication="sequential", validate_interval=1,
                param_validate_interval=4, checkpoint_interval=3,
                toe_timeout_s=60.0)


def _train(pkg, level, state_np, workdir, spec=GRADS5, journal=True,
           metrics=False, steps=8):
    """One protected run with the package's journal on; -> (report,
    trainer, journal records)."""
    o = jobs if pkg == "jax" else tobs
    j = o.FaultJournal() if journal else None
    o.set_journal(j)
    if metrics:
        o.enable_metrics()
    if pkg == "jax":
        rc = JRunConfig(model=JCFG, train=JTrainConfig(**TRAIN),
                        sedar=JSedarConfig(**_sedar(level)))
        tr = JTrainer(rc, workdir, inj_spec=spec and JSpec(**spec),
                      notify=lambda e: None)
        state = jax.tree.map(jnp.asarray, state_np)
    else:
        rc = RunConfig(model=CFG, train=TrainConfig(**TRAIN),
                       sedar=SedarConfig(**_sedar(level)))
        tr = SedarTrainer(rc, workdir,
                          inj_spec=spec and InjectionSpec(**spec),
                          notify=lambda e: None, device="cpu")
        state = bridge.train_state_from_numpy(state_np)
    _, rep = tr.run(steps, dual=tr.engine.executor.init_dual(state))
    recs = j.records() if j is not None else []
    o.shutdown()
    return rep, tr, recs


def _split_mismatch(p):
    """-> (payloads with each mismatch report cut to its leaf paths, the
    reports' f32 sums)."""
    p, sums = copy.deepcopy(p), []
    for d in p["detections"]:
        rep = d["detail"].get("mismatch")
        if rep is not None:
            sums += [(m["sum_a"], m["sum_b"]) for m in rep]
            d["detail"]["mismatch"] = [m["leaf"] for m in rep]
    return p, sums


@pytest.mark.parametrize("level", [2, 3])
def test_train_fault_journal_equal_to_jax(state_np, tmp_path, level):
    jrep, jtr, jrecs = _train("jax", level, state_np, str(tmp_path / "j"))
    trep, ttr, trecs = _train("torch", level, state_np, str(tmp_path / "t"))
    p, tsums = _split_mismatch(_payloads(tobs, trecs))
    jp, jsums = _split_mismatch(_payloads(jobs, jrecs))
    assert p == jp
    assert p["detections"][0]["detail"]["mismatch"]
    np.testing.assert_allclose(tsums, jsums, rtol=1e-4)
    assert [(d["step"], d["boundary"], d["effect"])
            for d in p["detections"]] == [(5, "commit", "TDC")]
    assert [r["kind"] for r in p["recoveries"]] == ["restore"]
    assert p["checkpoints"] == trep.checkpoints
    assert tobs.reconcile(trecs, ttr.engine.detections,
                          ttr.engine.recoveries) == \
        {"detections_match": True, "recoveries_match": True}
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=1e-5)


def test_train_metrics_on_adds_no_read(state_np, tmp_path):
    """L3 with a fault: the same reads by label and the same losses with
    metrics, journal and trace on as with telemetry off."""
    with hostsync.count_transfers() as off:
        rep_off, _, _ = _train("torch", 3, state_np, str(tmp_path / "off"),
                               journal=False)
    tobs.enable_trace()
    with hostsync.count_transfers() as on:
        rep_on, _, recs = _train("torch", 3, state_np, str(tmp_path / "on"),
                                 metrics=True)
    assert on.by_label == off.by_label
    assert rep_on.losses == rep_off.losses
    assert [r["kind"] for r in recs].count("checkpoint") == \
        len(rep_on.checkpoints)


# ---------------------------------------------------------------------------
# continuous serving: reduced qwen2-0.5b
# ---------------------------------------------------------------------------

SLOTS = 3
SLOT_FAULT = dict(leaf_idx=1, flat_idx=7, bit=30, step=3, replica=1,
                  target="slot")


def _rc():
    return RunConfig(model=reduce_for_smoke(get_config("qwen2-0.5b")),
                     train=TrainConfig(global_batch=2, seq_len=8))


def _jrc():
    return JRunConfig(model=jreduce(jget_config("qwen2-0.5b")),
                      train=JTrainConfig(global_batch=2, seq_len=8))


def _requests(mod):
    return mod(5, arrival_rate=2.0, prompt_lengths=(4, 8),
               max_new_choices=(4, 8), seed=1)


@pytest.fixture(scope="module")
def shared():
    jparams = JServer(_jrc(), dual=True).model.init(jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    srv = SedarServer(_rc(), dual=True, device="cpu")
    reqs, rep = srv.serve(tparams, _requests(synthetic_requests),
                          slots=SLOTS, validate_lag=8)
    assert not rep.detections
    return {"jparams": jparams, "tparams": tparams,
            "clean": {r.rid: list(r.tokens) for r in reqs}}


def _burst(mod):
    """Three requests at tick 0 with 16-token budgets: 15 decode ticks in
    a row, so a lag-8 window fills and flushes inside one step."""
    return mod(SLOTS, arrival_rate=100.0, prompt_lengths=(4, 8),
               max_new_choices=(16,), seed=1)


def _serve(pkg, shared, spec=None, requests=_requests, **kw):
    """-> (requests, report, the run's engine)."""
    if pkg == "jax":
        srv = JServer(_jrc(), dual=True, inj_spec=spec and JSpec(**spec))
        reqs, rep = srv.serve(shared["jparams"], requests(jsynthetic),
                              slots=SLOTS, **kw)
    else:
        srv = SedarServer(_rc(), dual=True,
                          inj_spec=spec and InjectionSpec(**spec),
                          device="cpu")
        reqs, rep = srv.serve(shared["tparams"],
                              requests(synthetic_requests), slots=SLOTS,
                              **kw)
    (eng, _ring, _rec), = srv._batch_engines.values()
    return reqs, rep, eng


def test_serve_fault_journal_equal_to_jax(shared):
    out = []
    for pkg, o in (("jax", jobs), ("torch", tobs)):
        j = o.FaultJournal()
        o.set_journal(j)
        tr = o.enable_trace()
        reqs, rep, _ = _serve(pkg, shared, SLOT_FAULT, validate_lag=8)
        recs = j.records()
        out.append((_payloads(o, recs),
                    {r.rid: list(r.tokens) for r in reqs},
                    {e["name"] for e in tr.events}))
        o.shutdown()
    (jp, jtoks, _), (tp, ttoks, spans) = out
    assert tp == jp
    assert ttoks == jtoks
    assert [(d["step"], d["boundary"], d["effect"], d["detail"]["slots"])
            for d in tp["detections"]] == [(3, "deferred", "TDC", [1])]
    assert [r["kind"] for r in tp["recoveries"]] == ["slot_restore"]
    assert {"decode_tick", "prefill_pack", "deferred_flush",
            "rollback"} <= spans


def test_serve_metrics_on_adds_no_read(shared):
    """Clean lag-8 serving: the same reads by label and the same tokens
    with metrics, journal, trace and a (never firing) autotuner on."""
    with hostsync.count_transfers() as off:
        reqs, _, _ = _serve("torch", shared, validate_lag=8)
    toks_off = {r.rid: list(r.tokens) for r in reqs}
    tobs.enable_metrics()
    tobs.set_journal(tobs.FaultJournal())
    tobs.enable_trace()
    tuner = tpolicy.Autotuner(
        ttm.PAPER_TABLE3["JACOBI"],
        tpolicy.AutotuneConfig(interval_steps=2, persistence=10 ** 6,
                               mode="serve", serve_slots=SLOTS))
    with hostsync.count_transfers() as on:
        reqs, rep, _ = _serve("torch", shared, validate_lag=8,
                              autotune=tuner)
    # a prefill pack reads its tokens and verdicts (2 items), a flush its
    # predicate and the drained rows: nothing per decode tick
    assert on.by_label == off.by_label
    assert set(on.by_label) == {"prefill_emit", "token_emit"}
    assert on.by_label["prefill_emit"] == 2 * rep.prefill_packs
    assert {r.rid: list(r.tokens) for r in reqs} == toks_off == \
        shared["clean"]
    assert tuner.evaluations >= 4
    m = tobs.metrics
    h = m.get_histogram("sedar_stage_duration_seconds", stage="decode_tick")
    assert h.count == rep.steps
    # the decode tokens (a request's first token comes from its prefill)
    assert m.get("serve_tokens_emitted_total") == sum(
        len(t) for t in toks_off.values()) - len(reqs)
    assert m.get("hostsync_transfers_total", label="prefill_emit") == \
        2 * rep.prefill_packs


def _lag1_tuner(policy, tm):
    """A tuner whose calibration (2 s steps, 1 ms syncs, a fault every
    72 s) puts the optimal serving lag at 1; metrics stay off, so nothing
    the run measures moves it."""
    tuner = policy.Autotuner(
        tm.PAPER_TABLE3["JACOBI"],
        policy.AutotuneConfig(interval_steps=1, persistence=1,
                              min_confidence=0.0, mode="serve",
                              serve_slots=SLOTS))
    est = tuner.estimator
    for _ in range(64):
        est.observe_step_s(2.0)
    for _ in range(8):
        est.observe_sync_s(0.001)
    for i in range(12):
        est.observe_fault(72.0 * i)
    return tuner


def test_serve_follows_reconfig_from_lag8_to_lag1(shared):
    """A burst of three 16-token requests; the tuner evaluates every tick.
    The evaluations inside the deferred window are refused, the one right
    after the tick that flushed the window (tick 8) drops the lag to 1:
    everything parked is delivered and emission goes per tick. The
    reconfig record equals JAX's, the tokens the clean lag-8 run's."""
    clean, _, _ = _serve("torch", shared, requests=_burst, validate_lag=8)
    out = []
    for pkg, policy, tm in (("jax", jpolicy, jtm), ("torch", tpolicy, ttm)):
        tuner = _lag1_tuner(policy, tm)
        with (hostsync.count_transfers() if pkg == "torch"
              else contextlib.nullcontext()) as st:
            reqs, rep, eng = _serve(pkg, shared, requests=_burst,
                                    validate_lag=8, autotune=tuner)
        out.append(({r.rid: list(r.tokens) for r in reqs},
                    [r.status for r in reqs], list(eng.reconfigs),
                    eng.validate_lag, tuner.evaluations))
    assert out[1] == out[0]
    toks, status, reconfigs, lag, evaluations = out[1]
    assert toks == {r.rid: list(r.tokens) for r in clean}
    assert set(status) == {"done"}
    assert [(r["step"], r["changes"]) for r in reconfigs] == \
        [(8, {"validate_lag": {"from": 8, "to": 1}})]
    assert lag == 1 and evaluations > 8
    # per-tick emission after the drop: a commit compare and a token read
    # per tick from then on
    assert st.by_label["commit_compare"] > 0
    assert st.by_label["token_emit"] > 1


def _run_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main()
    return out.getvalue()


def test_serve_launcher_with_telemetry_on_the_cpu(tmp_path, monkeypatch):
    mdir, trace = str(tmp_path / "m"), str(tmp_path / "trace.json")
    text = _run_main(launch_serve, [
        "serve", "--continuous", "--device", "cpu", "--validate-lag", "8",
        "--fault-slot", "1", "--fault-step", "5", "--metrics-dir", mdir,
        "--trace", trace, "--autotune", "--autotune-interval", "4",
        "--heartbeat-dir", str(tmp_path / "hb")], monkeypatch)
    assert "completed=12" in text and "rollbacks=1" in text
    assert "[obs] kpis: {'detections': 1, 'recoveries': 1" in text
    assert "[obs] predicted-vs-observed mttd_max_steps" in text
    assert "[autotune] calibrated: t_step=" in text
    assert "[cluster] host 0 of 1: all peers live" in text
    assert "sedar_stage_duration_seconds_count{stage=\"decode_tick\"}" \
        in text
    with open(trace) as fh:
        names = {e["name"] for e in json.load(fh)["traceEvents"]}
    assert {"decode_tick", "prefill_pack", "deferred_flush"} <= names
    page = _run_main(launch_status, ["status", "--metrics-dir", mdir,
                                     "--once"], monkeypatch)
    assert "decode_tick" in page and "calibrated: t_step=" in page
    assert "detection=1" in page


def test_train_launcher_with_telemetry_on_the_cpu(tmp_path, monkeypatch):
    mdir = str(tmp_path / "m")
    text = _run_main(launch_train, [
        "train", "--device", "cpu", "--steps", "6", "--level", "3",
        "--ckpt-interval", "2", "--inject-step", "3",
        "--workdir", str(tmp_path / "wd"), "--metrics-dir", mdir,
        "--trace", str(tmp_path / "trace.json"), "--autotune",
        "--autotune-interval", "2"], monkeypatch)
    assert "steps=6 detections=1 recoveries=1 ckpts=3" in text
    assert "[obs] kpis: {'detections': 1, 'recoveries': 1" in text
    assert "[autotune] 0 alert(s), " in text and "evaluation(s)" in text
    assert "sedar_checkpoints_total 3" in text
    page = _run_main(launch_status, ["status", "--metrics-dir", mdir,
                                     "--once"], monkeypatch)
    assert "checkpoint=3" in page and "train_step" in page


@pytest.mark.parametrize("argv", [["serve", "--autotune"],
                                  ["serve", "--continuous", "--autotune"],
                                  ["train", "--autotune"]])
def test_launchers_refuse_autotune_without_metrics(argv, monkeypatch,
                                                   capsys):
    module = launch_serve if argv[0] == "serve" else launch_train
    monkeypatch.setattr(sys, "argv", argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        module.main()
    assert e.value.code == 2
    assert "--autotune needs" in capsys.readouterr().err


@pytest.mark.parametrize("backend,spec", [
    ("fused", SLOT_FAULT),
    ("abft", dict(leaf_idx=0, flat_idx=None, bit=30, step=3, replica=0,
                  target="kernel")),
    ("hybrid", dict(leaf_idx=0, flat_idx=5, bit=30, step=0, replica=0,
                    target="prefill_kernel")),
])
def test_every_backend_journals_host_values(shared, backend, spec):
    """The journal refuses a tensor, so a fault run of each other backend
    with the journal on shows its events and recovery records hold host
    values only; the journal reconciles with the engine."""
    if spec["flat_idx"] is None:      # slot 1's row of the checksum block
        spec = dict(spec, flat_idx=(_rc().model.vocab_size + 1) + 7)
    j = tobs.FaultJournal()
    tobs.set_journal(j)
    srv = SedarServer(_rc(), backend=backend, inj_spec=InjectionSpec(**spec),
                      device="cpu")
    reqs, rep = srv.serve(shared["tparams"], _requests(synthetic_requests),
                          slots=SLOTS, validate_lag=8)
    (eng, _, _), = srv._batch_engines.values()
    assert rep.detections
    recs = j.records()
    assert tobs.reconcile(
        [r for r in recs if r["kind"] != "detection"
         or r["event"]["boundary"] != "prefill"],
        eng.detections, eng.recoveries) == \
        {"detections_match": True, "recoveries_match": True}
    assert len(tobs.payloads(recs, "detection", "event")) == \
        len(rep.detections)


def _flip_leaf_byte(store_dir, step, leaf=0):
    path = os.path.join(store_dir, f"ckpt_{step:08d}", f"leaf_{leaf:05d}.npy")
    arr = np.load(path)
    arr.reshape(-1).view(np.uint8)[3] ^= 0x10
    np.save(path, arr)


def test_tier_telemetry_equal_to_jax(tmp_path):
    """The corrupt-disk scenario of tests/test_torch_tiers.py with metrics
    and the journal on, in both packages: the same saves, restores and
    fallbacks by tier in the registry, the same tier_restore and
    tier_fallback lines (a fallback's error text names each package's own
    paths and is left out), and the tier spans."""
    from repro.checkpoint import CheckpointStore as JStore
    from repro.checkpoint import TieredCheckpointer as JTiered
    from repro.checkpoint import TierSchedule as JSchedule
    from repro_torch.checkpoint import (CheckpointStore, TieredCheckpointer,
                                        TierSchedule)
    out = {}
    for pkg, o in (("jax", jobs), ("torch", tobs)):
        o.enable_metrics()
        j = o.FaultJournal()
        o.set_journal(j)
        cls = (JSchedule, JStore, JTiered) if pkg == "jax" else \
            (TierSchedule, CheckpointStore, TieredCheckpointer)
        tc = cls[2](cls[0](device=1, host=2, disk=4, partner=4),
                    host_slots=2,
                    disk_store=cls[1](str(tmp_path / pkg / "disk")),
                    partner_store=cls[1](str(tmp_path / pkg / "partner")))
        rs = np.random.RandomState(0)
        for step in (2, 4):
            x = rs.randn(16).astype(np.float32)
            state = ({"x": jnp.asarray(x)} if pkg == "jax"
                     else {"x": torch.from_numpy(x)})
            tc.save(step, state, async_=False)
        tpl = jax.tree.map(np.asarray, state) if pkg == "jax" else state
        tc.device.keep_only(2)      # version 4 only on disk and partner
        tc.host.keep_only(2)
        _flip_leaf_byte(str(tmp_path / pkg / "disk"), 4)
        tc.restore(4, tpl)
        m = o.metrics
        out[pkg] = (
            {(name, t): m.get(name, tier=t)
             for name in ("checkpoint_saves_total",
                          "checkpoint_restores_total",
                          "checkpoint_tier_fallbacks_total")
             for t in ("device", "host", "disk", "partner")},
            [{k: v for k, v in r.items()
              if k not in ("t_mono", "error", "seq")}
             for r in j.records()],
            {lk["stage"] for lk in m.labels_of(
                "sedar_stage_duration_seconds")})
        o.shutdown()
    assert out["torch"] == out["jax"]
    counters, lines, stages = out["torch"]
    assert [r["kind"] for r in lines] == ["tier_fallback", "tier_restore"]
    assert lines[1]["tier"] == "partner" and lines[1]["version"] == 4
    assert {"checkpoint_tier", "restore_plan", "restore"} <= stages
