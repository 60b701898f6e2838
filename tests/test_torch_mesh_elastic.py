"""Elastic fail-in-place training on the pod backend's process mesh against
the JAX package, on the CPU.

The reference's acceptance scenario (`tests/test_multidevice.py:124`) runs
an `ElasticTrainer` on a (2, 2, 2) device mesh; the port runs it on a
(2, 2, 1) process mesh, four ranks over gloo on localhost, one torch
thread each (`launch/train.py::elastic_mesh_rank`), from JAX's initial
state. JAX's side runs in one subprocess with eight forced host devices;
this module imports no JAX. Held against JAX:

  * the acceptance scenario (host 1 dark over [250, 550), lag 4, the
    device and partner tiers): a shrink restored from `partner` onto data
    1 and batch 2, a regrow, 12 steps; the same remesh records (but the
    wall time; a dark rank restores nothing at the shrink, so its record
    there has no tier), decisions, segments (steps, losses within rtol
    1e-5, events) and no `commit_compare` read;
  * the replica-loss branch on a mesh whose data axis is 2 (host 1 is the
    replica pod): the first pod's ranks run `none` at full data width, as
    the reference does for the same call;
  * every rank's elastic run ends bitwise equal to its own uninterrupted
    run, and every rank on the same bits.
Also the process mesh over a subset of the ranks: its pod group reaches
only the survivors, the dark ranks get None, and a mesh over all ranks
keeps the groups of `make_process_mesh(cfg)`.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import (MeshConfig, RunConfig, SedarConfig,
                                 TrainConfig, get_config, reduce_for_smoke)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.train import elastic_mesh_rank
from repro_torch.runtime import cluster

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_RTOL = 1e-5
RANK_TIMEOUT_S = 240
TRAIN = dict(global_batch=4, seq_len=16, warmup_steps=2, lr=1e-3)
# name -> (steps, sedar, dark window, ElasticTrainer keywords)
SCENARIOS = {
    # tests/test_multidevice.py:124
    "acceptance": (12, dict(replication="pod", validate_interval=1,
                            validate_lag=4, param_validate_interval=100,
                            checkpoint_interval=4,
                            ckpt_tiers="device,partner"),
                   (250.0, 550.0), {}),
    "replica_loss": (6, dict(replication="pod", validate_interval=1,
                             param_validate_interval=2,
                             checkpoint_interval=2,
                             ckpt_tiers="device,partner"),
                     (150.0, 250.0), dict(replica_hosts=[1])),
}

JAX_SCRIPT = r"""
import dataclasses, json, os, pickle, sys
import numpy as np, jax
from repro.configs import (MeshConfig, RunConfig, SedarConfig, TrainConfig,
                           get_config, reduce_for_smoke)
from repro.core import hostsync
from repro.launch.mesh import make_test_mesh
from repro.runtime.elastic import ElasticTrainer

base, args = sys.argv[1], json.loads(sys.argv[2])
out = {}
for name, (steps, sedar, dark, kw) in args["scenarios"].items():
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    rc = RunConfig(model=reduce_for_smoke(get_config("paper-testapp")),
                   train=TrainConfig(steps=steps, **args["train"]),
                   mesh=MeshConfig(shape=(2, 2, 2),
                                   axis_names=("pod", "data", "model")),
                   sedar=SedarConfig(level=3, **sedar))
    wd = f"{base}/{name}"
    hb = os.path.join(wd, "heartbeats")
    sim = {"now": 0.0}

    def tick(step):
        sim["now"] += 100.0
        os.makedirs(hb, exist_ok=True)
        for h in range(2):
            if h == 1 and dark[0] <= sim["now"] < dark[1]:
                continue
            with open(os.path.join(hb, f"host_{h:05d}.json"), "w") as f:
                json.dump({"host": h, "step": int(step or 0),
                           "t": sim["now"]}, f)

    with mesh:
        et = ElasticTrainer(rc, wd, mesh=mesh, n_hosts=2, scan_interval=2,
                            clock=lambda: sim["now"], tick=tick,
                            notify=lambda e: None, **kw)
        with open(f"{base}/{name}_init.pkl", "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, et.trainer.init_state()), f)
        with hostsync.count_transfers() as st:
            rep = et.run(steps)
    out[name] = dict(
        remeshes=[dataclasses.asdict(r) for r in rep.remeshes],
        decisions=[d.mode for d in rep.decisions],
        steps=rep.steps_completed, stopped=rep.stopped,
        completed_degraded=rep.completed_degraded,
        segments=[dict(steps=s.steps_completed,
                       losses=[float(x) for x in s.losses])
                  for s in rep.segments],
        detections=[str(e) for e in rep.detections],
        reads=dict(st.by_label))
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    base = tmp_path_factory.mktemp("jax_mesh_elastic")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    args = dict(scenarios=SCENARIOS, train=TRAIN)
    out = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(base),
                          json.dumps(args)], env=env, capture_output=True,
                         text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("JSON")][-1]
    res = json.loads(line[4:])
    res["base"] = base
    return res


def _mesh() -> MeshConfig:
    return MeshConfig(shape=(2, 2, 1), axis_names=("pod", "data", "model"))


def run_port(ref, name: str, tmp_path):
    steps, sedar, dark, kw = SCENARIOS[name]
    with open(ref["base"] / f"{name}_init.pkl", "rb") as f:
        init = pickle.load(f)
    rc = RunConfig(model=reduce_for_smoke(get_config("paper-testapp")),
                   train=TrainConfig(steps=steps, **TRAIN), mesh=_mesh(),
                   sedar=SedarConfig(level=3, **sedar))
    cl = dict(n_hosts=2, dark_host=1, dark_from=dark[0], dark_to=dark[1])
    return tmesh.spawn(elastic_mesh_rank, 4, rc, _mesh(), str(tmp_path),
                       cl, "cpu", init, None, dict(kw, scan_interval=2),
                       threads=1, timeout_s=RANK_TIMEOUT_S)


def _records(recs):
    return [{k: v for k, v in r.items() if k != "downtime_s"} for r in recs]


def check_against_jax(reps, want) -> set:
    """Every rank against JAX's run; returns the survivors (the ranks that
    restored the anchor at the shrink)."""
    survivors = {r["rank"] for r in reps
                 if any(m["restore_tier"] for m in r["elastic"]["remeshes"]
                        if m["phase"] == "shrink")}
    shrink = want["remeshes"][0]
    for rep in reps:
        e = rep["elastic"]
        wrec, segs = _records(want["remeshes"]), want["segments"]
        if rep["rank"] not in survivors:
            # a dark rank restores nothing at the shrink and sits the
            # degraded segments out
            wrec = [dict(r, restore_tier=None) if r["phase"] == "shrink"
                    else r for r in wrec]
            steps = [s["steps"] for s in segs]
            n_pre = steps.index(shrink["trigger_step"]) + 1
            n_post = len(e["segments"]) - n_pre
            segs = segs[:n_pre] + segs[len(segs) - n_post:]
        else:
            assert e["detections"] == want["detections"]
        assert _records(e["remeshes"]) == wrec
        assert e["decisions"] == want["decisions"]
        assert e["steps"] == want["steps"]
        assert e["stopped"] == want["stopped"]
        assert e["completed_degraded"] == want["completed_degraded"]
        assert [s["steps"] for s in e["segments"]] == \
            [s["steps"] for s in segs]
        for g, w in zip(e["segments"], segs):
            np.testing.assert_allclose(g["losses"], w["losses"],
                                       rtol=LOSS_RTOL)
        # the elastic run ends on the uninterrupted run's bits
        np.testing.assert_array_equal(e["final_state_fp"],
                                      rep["ref"]["final_state_fp"])
        np.testing.assert_array_equal(e["final_state_fp"],
                                      reps[0]["elastic"]["final_state_fp"])
    return survivors


def test_pod_elastic_acceptance_matches_jax(ref, tmp_path):
    """tests/test_multidevice.py:124: shrink from the partner tier onto
    the survivors, regrow, 12 steps, no commit_compare read; every rank
    bitwise equal to its uninterrupted run."""
    want = ref["acceptance"]
    reps = run_port(ref, "acceptance", tmp_path)
    survivors = check_against_jax(reps, want)
    assert survivors == {0, 2}
    assert [m["phase"] for m in want["remeshes"]] == ["shrink", "regrow"]
    shrink = reps[0]["elastic"]["remeshes"][0]
    assert shrink["restore_tier"] == "partner"
    assert (shrink["new_data"], shrink["new_batch"]) == (1, 2)
    for rep in reps:
        e = rep["elastic"]
        assert e["steps"] == 12 and not e["stopped"]
        assert "commit_compare" not in e["reads"]
        assert not e["detections"]
        # one scan per segment, one progress broadcast after each
        assert e["collectives"]["elastic_scan"] == \
            e["collectives"]["elastic_progress"] + 1
    assert "commit_compare" not in want["reads"]


def test_pod_elastic_replica_loss_matches_jax(ref, tmp_path):
    """Host 1 is the replica pod: the first pod's two ranks run `none` at
    data 2 (grads averaged over their data group) through the outage; the
    regrown replay ends on the uninterrupted run's bits."""
    want = ref["replica_loss"]
    reps = run_port(ref, "replica_loss", tmp_path)
    survivors = check_against_jax(reps, want)
    assert survivors == {0, 1}
    shrink = reps[0]["elastic"]["remeshes"][0]
    assert shrink["protection_lost"]
    assert shrink["new_data"] == shrink["old_data"] == 2


def subset_rank(rank: int) -> dict:
    """One of four ranks: the full (2, 2) mesh two ways, the survivors of
    data shard 1 and the first pod, and collectives over each."""
    axes = ("pod", "data")
    full = tmesh.make_process_mesh(MeshConfig(shape=(2, 2), axis_names=axes))
    again = tmesh.make_process_mesh(MeshConfig(shape=(2, 2),
                                               axis_names=axes),
                                    ranks=[0, 1, 2, 3])

    def view(m):
        return None if m is None else [list(m.shape), m.rank, m.pod, m.data,
                                       m.pod_ranks, m.ranks]

    def total(x, group):
        t = torch.tensor([float(x)])
        dist.all_reduce(t, group=group)
        return float(t)

    out = {"full": view(full), "again": view(again)}
    for m, key in ((full, "full"), (again, "again")):
        out[key + "_sums"] = [total(rank + 1, m.pod_group),
                              total(rank + 1, m.data_group)]
    shape, surv = cluster.surviving_devices(full, [1])
    out["survivors"] = [list(shape), surv]
    sub = cluster.rebuild_mesh(shape, axes, ranks=surv)
    pod0 = cluster.rebuild_mesh((1, 2), axes, ranks=[0, 1])
    out["sub"], out["pod0"] = view(sub), view(pod0)
    if sub is not None:
        out["sub_sum"] = total(rank + 1, sub.pod_group)
        b = torch.tensor([float(rank)])
        dist.broadcast(b, src=sub.pod_rank(1), group=sub.pod_group)
        out["sub_bcast"] = float(b)
        out["sub_data_sum"] = total(rank + 1, sub.data_group)
    if pod0 is not None:
        out["pod0_sum"] = total(rank + 1, pod0.data_group)
    out["world_sum"] = total(rank + 1, None)
    for bad in ([0, 1], [0, 0, 1, 2], [0, 1, 2, 7]):
        try:
            tmesh.make_process_mesh(MeshConfig(shape=(2, 2),
                                               axis_names=axes), ranks=bad)
            out.setdefault("errors", []).append(None)
        except ValueError as e:
            out.setdefault("errors", []).append(str(e))
    return out


def test_subset_mesh_reaches_only_the_survivors():
    got = tmesh.spawn(subset_rank, 4, threads=1, timeout_s=RANK_TIMEOUT_S)
    for r, g in enumerate(got):
        pod, data = divmod(r, 2)
        assert g["full"] == g["again"] == [[2, 2], r, pod, data,
                                           [data, 2 + data], [0, 1, 2, 3]]
        assert g["full_sums"] == g["again_sums"] == [
            (data + 1) + (data + 3), (2 * pod + 1) + (2 * pod + 2)]
        assert g["survivors"] == [[2, 1], [0, 2]]
        assert g["world_sum"] == 10.0
        assert g["errors"][0].startswith("mesh (2, 2) needs 4 ranks")
        assert "not distinct ranks" in g["errors"][1]
        assert "not distinct ranks" in g["errors"][2]
    for r in (1, 3):     # the dark ranks
        assert got[r]["sub"] is None and "sub_sum" not in got[r]
    for r in (0, 2):
        g = got[r]
        assert g["sub"] == [[2, 1], r, r // 2, 0, [0, 2], [0, 2]]
        assert g["sub_sum"] == 1.0 + 3.0        # ranks 0 and 2 only
        assert g["sub_bcast"] == 2.0
        assert g["sub_data_sum"] == r + 1.0
    for r in (0, 1):
        assert got[r]["pod0"] == [[1, 2], r, 0, r, [r], [0, 1]]
        assert got[r]["pod0_sum"] == 3.0
    assert got[2]["pod0"] is None and got[3]["pod0"] is None
