"""Elastic fail-in-place training of the port against the JAX package, in
one process (the reference's `tests/test_elastic.py`), at its reduced
paper-testapp: the same scenarios on both `ElasticTrainer`s from JAX's
initial state (`bridge.train_state_from_numpy`). The remesh records equal
JAX's field by field but `downtime_s` (wall time), the degraded-mode
decisions equal JAX's, each segment's losses agree within rtol 1e-5, and
the elastic run's final per-leaf fingerprint is bitwise equal to the
port's own uninterrupted run. Also the planner (`plan_elastic_remesh`,
`data_axis_index`, `elastic_restart`'s shrunken config, errors included)
over a grid, the journal records and metrics, the KPIs of remesh records,
the launcher's `--elastic` and its two errors, `int8_error_feedback`
bitwise on f32 and bf16 leaves, and a single-card backend's refusal of a
process mesh."""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import MeshConfig as JMeshConfig
from repro.configs import RunConfig as JRunConfig
from repro.configs import SedarConfig as JSedarConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.launch import train as jlaunch
from repro.obs.kpi import compute_kpis as jcompute_kpis
from repro.obs.kpi import reconcile_with_advice as jreconcile
from repro.optim.compression import int8_error_feedback as jint8_ef
from repro.runtime import cluster as jcluster
from repro.runtime.elastic import ElasticTrainer as JElastic
from repro.runtime.elastic import RemeshRecord as JRemeshRecord

from repro_torch import bridge
from repro_torch import obs
from repro_torch.configs import (MeshConfig, RunConfig, SedarConfig,
                                 TrainConfig, get_config, reduce_for_smoke)
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import SimCluster
from repro_torch.obs.kpi import compute_kpis, reconcile_with_advice
from repro_torch.optim.compression import int8_error_feedback
from repro_torch.runtime import cluster
from repro_torch.runtime.elastic import ElasticTrainer, RemeshRecord
from repro_torch.runtime.train import SedarTrainer

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
STEPS = 12
TRAIN = dict(global_batch=4, seq_len=16, steps=STEPS, warmup_steps=2,
             lr=1e-3)
MESH = dict(shape=(2, 1), axis_names=("data", "model"))
SEDAR = dict(level=3, replication="sequential", validate_interval=1,
             param_validate_interval=50, checkpoint_interval=2,
             toe_timeout_s=60.0)
# the reference's scenarios: name -> ElasticTrainer keywords
SCENARIOS = {
    "shrink_regrow": {},
    "replica_loss": dict(replica_hosts=[1]),
    "safe_stop": dict(replica_hosts=[1], mtbe_hours=0.001,
                      outage_hours=0.5, sdc_risk_budget=1.0),
}
RECORD_FIELDS = [f.name for f in dataclasses.fields(RemeshRecord)
                 if f.name != "downtime_s"]


@pytest.fixture(autouse=True)
def _obs_teardown():
    yield
    obs.shutdown()
    jobs.shutdown()


def jax_rc(**sedar_kw):
    return JRunConfig(model=jreduce(jget_config("paper-testapp")),
                      train=JTrainConfig(**TRAIN), mesh=JMeshConfig(**MESH),
                      sedar=JSedarConfig(**dict(SEDAR, **sedar_kw)))


def port_rc(**sedar_kw):
    return RunConfig(model=reduce_for_smoke(get_config("paper-testapp")),
                     train=TrainConfig(**TRAIN), mesh=MeshConfig(**MESH),
                     sedar=SedarConfig(**dict(SEDAR, **sedar_kw)))


_runs = {}


def run_both(name, tmp_path_factory):
    """The scenario on both elastic trainers (journal and metrics on), and
    the port's uninterrupted run, from JAX's initial state; once per
    module. -> dict of the reports and the journals' remesh payloads."""
    if name in _runs:
        return _runs[name]
    kw = SCENARIOS[name]
    out = {}
    for pkg in ("jax", "torch"):
        o = jobs if pkg == "jax" else obs
        j = o.FaultJournal()
        o.set_journal(j)
        o.enable_metrics()
        wd = str(tmp_path_factory.mktemp(f"{pkg}_{name}"))
        sim = SimCluster(os.path.join(wd, "heartbeats"))
        if pkg == "jax":
            et = JElastic(jax_rc(), wd, n_hosts=2, scan_interval=2,
                          clock=sim.clock, tick=sim.tick,
                          notify=lambda e: None, **kw)
            out["state"] = jax.tree.map(np.asarray, et.trainer.init_state())
            rep = et.run(STEPS)
        else:
            et = ElasticTrainer(port_rc(), wd, n_hosts=2, scan_interval=2,
                                clock=sim.clock, tick=sim.tick,
                                device="cpu", notify=lambda e: None, **kw)
            rep = et.run(STEPS, dual=et.trainer.engine.executor.init_dual(
                bridge.train_state_from_numpy(out["state"])))
        out[pkg] = rep
        out[pkg + "_journal"] = [
            r["record"] for r in j.records("recovery")
            if r["record"].get("kind") == "elastic_remesh"]
        out[pkg + "_metrics"] = {
            p: o.metrics.get("sedar_elastic_remeshes_total", phase=p)
            for p in ("shrink", "regrow", "safe_stop")}
        o.shutdown()
    if not out["torch"].stopped:
        ref = SedarTrainer(port_rc(), str(tmp_path_factory.mktemp(
            f"ref_{name}")), device="cpu", notify=lambda e: None)
        out["ref"] = ref.run(STEPS, dual=ref.engine.executor.init_dual(
            bridge.train_state_from_numpy(out["state"])))[1]
    _runs[name] = out
    return out


def check_against_jax(out):
    jrep, trep = out["jax"], out["torch"]
    for jr, tr in zip(jrep.remeshes, trep.remeshes):
        assert {f: getattr(tr, f) for f in RECORD_FIELDS} == \
            {f: getattr(jr, f) for f in RECORD_FIELDS}
    assert len(trep.remeshes) == len(jrep.remeshes)
    assert [dataclasses.asdict(d) for d in trep.decisions] == \
        [dataclasses.asdict(d) for d in jrep.decisions]
    assert trep.steps_completed == jrep.steps_completed
    assert trep.stopped == jrep.stopped
    assert trep.completed_degraded == jrep.completed_degraded
    assert [s.steps_completed for s in trep.segments] == \
        [s.steps_completed for s in jrep.segments]
    for js, ts in zip(jrep.segments, trep.segments):
        np.testing.assert_allclose(ts.losses, js.losses, rtol=LOSS_RTOL)
        assert [(e.step, e.boundary, e.effect) for e in ts.detections] == \
            [(e.step, e.boundary, e.effect) for e in js.detections]
        assert ts.recoveries == js.recoveries


def test_elastic_requires_level3(tmp_path):
    with pytest.raises(ValueError, match="level 3") as want:
        JElastic(jax_rc(level=2), str(tmp_path / "jax"))
    with pytest.raises(ValueError, match="level 3") as got:
        ElasticTrainer(port_rc(level=2), str(tmp_path / "torch"),
                       device="cpu")
    assert str(got.value) == str(want.value)


def test_shrink_regrow_matches_jax_and_ends_bitwise(tmp_path_factory):
    """Host 1 dark over [300, 700) of the simulated clock: a shrink at step
    4 onto data 1 and batch 2 from the validated disk checkpoint, a regrow
    at 12 that replays from it; JAX's records, decisions and losses, and
    the uninterrupted run's bits."""
    out = run_both("shrink_regrow", tmp_path_factory)
    check_against_jax(out)
    rep = out["torch"]
    assert rep.steps_completed == STEPS and not rep.stopped
    assert [r.phase for r in rep.remeshes] == ["shrink", "regrow"]
    shrink, regrow = rep.remeshes
    assert shrink.hosts == [1]
    assert (shrink.old_data, shrink.new_data) == (2, 1)
    assert (shrink.old_batch, shrink.new_batch) == (4, 2)
    assert shrink.restore_step is not None and shrink.restore_tier == "disk"
    assert (regrow.old_data, regrow.new_data) == (1, 2)
    assert not rep.completed_degraded
    np.testing.assert_array_equal(rep.final_state_fp,
                                  out["ref"].final_state_fp)


def test_elastic_journals_remesh_records_like_jax(tmp_path_factory):
    """kind="elastic_remesh" lines in the fault journal (JAX's payloads but
    the wall time) and `sedar_elastic_remeshes_total` per phase."""
    out = run_both("shrink_regrow", tmp_path_factory)

    def strip(recs):
        return [{k: v for k, v in r.items() if k != "downtime_s"}
                for r in recs]

    assert strip(out["torch_journal"]) == strip(out["jax_journal"])
    assert [r["phase"] for r in out["torch_journal"]] == ["shrink", "regrow"]
    assert out["torch_journal"][0]["hosts"] == [1]
    assert out["torch_metrics"] == out["jax_metrics"]
    assert out["torch_metrics"]["shrink"] == 1
    assert out["torch_metrics"]["regrow"] == 1


def test_replica_loss_runs_unprotected_like_jax(tmp_path_factory):
    """The lost host is the replica pod: the degraded trainer runs
    replication="none" at full data width, and the regrown replay ends on
    the uninterrupted run's bits."""
    out = run_both("replica_loss", tmp_path_factory)
    check_against_jax(out)
    rep = out["torch"]
    assert [r.phase for r in rep.remeshes] == ["shrink", "regrow"]
    shrink = rep.remeshes[0]
    assert shrink.protection_lost
    assert shrink.new_data == shrink.old_data
    np.testing.assert_array_equal(rep.final_state_fp,
                                  out["ref"].final_state_fp)


def test_replica_loss_safe_stops_like_jax(tmp_path_factory):
    out = run_both("safe_stop", tmp_path_factory)
    check_against_jax(out)
    rep = out["torch"]
    assert rep.stopped
    assert [r.phase for r in rep.remeshes] == ["safe_stop"]
    assert rep.decisions[0].mode == "safe_stop"
    assert rep.decisions[0].expected_faults_during_outage > 1.0


def test_remesh_records_feed_kpis_like_jax():
    kw = [dict(phase="shrink", trigger_step=6, restore_step=4,
               restore_tier="disk", hosts=[1], old_data=2, new_data=1,
               old_batch=4, new_batch=2, downtime_s=2.0,
               mode="fail_in_place"),
          dict(phase="regrow", trigger_step=10, restore_step=4,
               restore_tier="disk", hosts=[1], old_data=1, new_data=2,
               old_batch=4, new_batch=4, downtime_s=1.0,
               mode="fail_in_place")]

    def lines(cls):
        return [{"kind": "recovery", "seq": i, "t_mono": float(i),
                 "record": cls(**k).as_recovery_record()}
                for i, k in enumerate(kw)]

    assert lines(RemeshRecord) == lines(JRemeshRecord)
    k = compute_kpis(lines(RemeshRecord), steps=20, wall_s=100.0)
    assert k == jcompute_kpis(lines(JRemeshRecord), steps=20, wall_s=100.0)
    assert k["elastic_remeshes"] == 2
    assert k["node_loss_downtime_s"] == pytest.approx(3.0)
    assert k["redone_steps"] == 8
    assert k["availability"] == pytest.approx(0.6 * 0.97)
    for pred in (1.0, 0.0001):
        assert reconcile_with_advice(k, predicted_downtime_s=pred) == \
            jreconcile(k, predicted_downtime_s=pred)
    k0 = compute_kpis([], steps=10, wall_s=50.0)
    assert "elastic_remeshes" not in k0 and k0["availability"] == 1.0


PLAN_CASES = [(2, 4, [1], 1), (4, 8, [0, 3], 1), (4, 8, [5], 2),
              (8, 16, [2, 3], 2), (3, 9, [0, 1], 1), (2, 4, [0, 1], 1),
              (4, 6, [1], 1), (1, 4, [0], 1), (4, 8, [], 1)]


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_elastic_remesh_matches_jax(case):
    data, batch, lost, hpds = case
    got = _outcome(lambda: dataclasses.asdict(cluster.plan_elastic_remesh(
        data, batch, lost, hosts_per_data_shard=hpds)))
    want = _outcome(lambda: dataclasses.asdict(jcluster.plan_elastic_remesh(
        data, batch, lost, hosts_per_data_shard=hpds)))
    assert got == want


@pytest.mark.parametrize("axes", [("data", "model"), ("pod", "data"),
                                  ("pod", "data", "model"), ("model",)])
def test_data_axis_index_matches_jax(axes):
    shape = tuple(range(2, 2 + len(axes)))
    got = _outcome(lambda: cluster.data_axis_index(
        MeshConfig(shape=shape, axis_names=axes)))
    want = _outcome(lambda: jcluster.data_axis_index(
        JMeshConfig(shape=shape, axis_names=axes)))
    assert got == want


@pytest.mark.parametrize("mesh,lost", [
    (((2, 1), ("data", "model")), [1]),
    (((2, 4, 1), ("pod", "data", "model")), [0, 2]),
    (((2, 2), ("pod", "data")), [0, 1]),
    (((2, 3), ("pod", "data")), [1])])
def test_elastic_restart_shrinks_the_config_like_jax(tmp_path, mesh, lost):
    """The shrunken config (mesh shape, global batch) and the plan; a batch
    of 4 over 3 shards and the loss of every shard raise as in JAX."""
    shape, axes = mesh

    def port():
        rc = dataclasses.replace(
            port_rc(), mesh=MeshConfig(shape=shape, axis_names=axes),
            sedar=SedarConfig(**dict(SEDAR, replication="none")))
        plan, tr = cluster.elastic_restart(rc, str(tmp_path / "t"), lost,
                                           device="cpu")
        return (dataclasses.asdict(plan), tuple(tr.cfg.mesh.shape),
                tr.cfg.train.global_batch)

    def ref():
        rc = dataclasses.replace(
            jax_rc(), mesh=JMeshConfig(shape=shape, axis_names=axes),
            sedar=JSedarConfig(**dict(SEDAR, replication="none")))
        plan, tr = jcluster.elastic_restart(rc, str(tmp_path / "j"), lost)
        return (dataclasses.asdict(plan), tuple(tr.cfg.mesh.shape),
                tr.cfg.train.global_batch)

    assert _outcome(port) == _outcome(ref)


def _launch(main, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    main()
    return capsys.readouterr().out


def test_launcher_elastic_prints_the_reference_lines(tmp_path, monkeypatch,
                                                     capsys):
    """--elastic --device cpu: the summary, remesh[...] and decision: lines
    of the reference's launcher (its summary's downtime aside)."""
    argv = ["--steps", "12", "--level", "3", "--elastic", "--n-hosts", "2",
            "--lose-host", "1", "--lose-at", "300", "--return-at", "700"]
    want = _launch(jlaunch.main, argv + ["--workdir", str(tmp_path / "j")],
                   monkeypatch, capsys)
    got = _launch(launch_train.main, argv + [
        "--device", "cpu", "--workdir", str(tmp_path / "t")], monkeypatch,
        capsys)

    def lines(text):
        keep = [l for l in text.splitlines()
                if l.startswith(("steps=", "  remesh[", "  decision:"))]
        return [l.split(" downtime=")[0] + " " + l.split("s stopped=")[-1]
                if l.startswith("steps=") else l for l in keep]

    assert lines(got) == lines(want)
    assert len(lines(got)) == 4, got
    assert "remeshes=['shrink', 'regrow']" in got
    assert "  remesh[shrink]: trigger step 4, restored step 4 from tier " \
           "disk, hosts [1], data 2->1, batch 4->2" in got
    assert got.splitlines()[-1] == f"workdir: {tmp_path / 't'}"


@pytest.mark.parametrize("argv,msg", [
    (["--level", "2"], "--elastic requires --level 3"),
    (["--global-batch", "3"], "--global-batch must divide evenly"),
])
def test_launcher_elastic_errors_like_the_reference(tmp_path, monkeypatch,
                                                    capsys, argv, msg):
    for main in (jlaunch.main, launch_train.main):
        monkeypatch.setattr(sys, "argv", ["train", "--elastic", "--workdir",
                                          str(tmp_path)] + argv)
        with pytest.raises(SystemExit) as e:
            main()
        assert e.value.code == 2
        assert msg in capsys.readouterr().err


def test_launcher_elastic_refuses_a_mesh_backend(tmp_path, monkeypatch,
                                                 capsys):
    """--elastic runs one process of a single-card backend; the mesh
    backends and the manual-vote baseline are refused up front."""
    for extra in (["--replication", "pod"], ["--manual-vote"]):
        monkeypatch.setattr(sys, "argv", ["train", "--elastic", "--device",
                                          "cpu", "--workdir",
                                          str(tmp_path)] + extra)
        with pytest.raises(SystemExit) as e:
            launch_train.main()
        assert e.value.code == 2
        assert "--elastic runs one process" in capsys.readouterr().err


def _ef_tree(seed: int):
    r = np.random.RandomState(seed)
    return {"w": (r.standard_normal((7, 33)) * 3e-3).astype(np.float32),
            "b": (r.standard_normal(65) * 50.0).astype(np.float32),
            "z": np.zeros((4, 4), np.float32),
            "h": (r.standard_normal((9, 16)) * 0.2).astype(np.float32)}


def test_int8_error_feedback_bitwise_like_jax():
    """Three calls carrying the residuals from ef_state=None: the
    dequantized grads (f32 and bf16 leaves) and the f32 residuals are
    bitwise equal to JAX's (torch.round and jnp.round both round half to
    even)."""
    bf16 = ("h",)
    j_ef = t_ef = None
    for call in range(3):
        g = _ef_tree(call)
        jg = {k: jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32)
              for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(torch.bfloat16 if k in bf16
                                        else torch.float32)
              for k, v in g.items()}
        jout, j_ef = jint8_ef(jg, j_ef)
        tout, t_ef = int8_error_feedback(tg, t_ef)
        for k in g:
            want = np.asarray(jout[k].astype(jnp.float32))
            got = tout[k].float().numpy()
            assert tout[k].dtype == tg[k].dtype
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
            np.testing.assert_array_equal(
                t_ef[k].numpy().view(np.uint32),
                np.asarray(j_ef[k]).view(np.uint32))
            assert t_ef[k].dtype == torch.float32
    assert not np.array_equal(t_ef["w"].numpy(), 0)


def test_sim_cluster_beats_like_the_reference_test(tmp_path):
    """The launcher's simulated cluster writes the reference test's files:
    host 1 dark over [300, 700) of a clock that moves 100 s a tick."""
    sim = SimCluster(str(tmp_path), n_hosts=2, dark_host=1)
    seen = []
    for step in (0, 2, None, 6):
        sim.tick(step)
        beats = {}
        for h in (0, 1):
            p = tmp_path / f"host_{h:05d}.json"
            if p.exists():
                beats[h] = json.loads(p.read_text())
        seen.append(beats)
    assert seen[0][1] == {"host": 1, "step": 0, "t": 100.0}
    assert seen[2][0] == {"host": 0, "step": 0, "t": 300.0}
    assert seen[2][1]["t"] == 200.0 and seen[3][1]["t"] == 200.0
    assert sim.clock() == 400.0


@pytest.mark.parametrize("backend", ["sequential", "fused", "abft",
                                     "hybrid"])
def test_single_card_backends_refuse_a_process_mesh(tmp_path, backend):
    """A process mesh takes pod, vote and none (the survivors of a lost
    replica pod, grads averaged over their data group); a single-card
    backend given one raises instead of training each rank's rows alone."""
    from repro_torch.launch.mesh import ProcessMesh
    mesh = ProcessMesh((1, 2), ("pod", "data"), 0, 0, 0, None, None, [0],
                       [0, 1])
    rc = dataclasses.replace(port_rc(), sedar=SedarConfig(
        **dict(SEDAR, replication=backend)))
    with pytest.raises(ValueError, match="runs on one card"):
        SedarTrainer(rc, str(tmp_path), device="cpu", mesh=mesh)
