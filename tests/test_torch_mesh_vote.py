"""The mesh backend `vote` and the paper's manual-vote baseline against the
JAX package, on the CPU (the `pod` backend is in `tests/test_torch_mesh.py`,
whose helpers this module uses).

  * `majority_replica` on 2-1, 1-1-1 and 3-0 splits, whole-state (n, 4)
    and per-lane (n, L, 4);
  * the reference scenario of `tests/test_multidevice.py:205`: 3 pods x 2
    data shards, a params fault (leaf 2, element 3, bit 30) on pod 1 at
    step 3 caught at the FSC boundary and repaired forward by a majority
    broadcast with no rollback. The port (6 ranks, mesh (3, 2, 1), from
    JAX's initial state) gives JAX's events, recovery records, step count
    and device reads; losses within rtol 1e-5; every rank's final state
    bitwise equal to the port's own clean run. The repaired state's -0.0
    count is reported (the broadcast keeps them, C4);
  * `manual_vote_baseline` with a fault that fires (replica 0's grads) and
    with the launcher's own (replica 1: an unprotected instance runs
    replica 0 only, so it never fires, in both packages): the same
    verdicts; and the vote launcher on the CPU.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import RunConfig, TrainConfig, get_config
from repro_torch.configs import reduce_for_smoke
from repro_torch.core import hostsync
from repro_torch.core.detection import majority_replica
from repro_torch.core.injection import InjectionSpec
from repro_torch.core.policy import make_trainer
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as launch_train

from test_torch_mesh import (LOSS_RTOL, RANK_TIMEOUT_S, TRAIN, _mesh, _rc,
                             run_jax)

torch.set_num_threads(1)

VOTE_STEPS = 8
VOTE_SEDAR = dict(replication="vote", validate_interval=1,
                  param_validate_interval=2, checkpoint_interval=100)
VOTE_SPEC = dict(leaf_idx=2, flat_idx=3, bit=30, step=3, replica=1,
                 target="params")
BASELINE_SPECS = {
    "fires": dict(leaf_idx=3, flat_idx=11, bit=21, step=3, replica=0,
                  target="grads"),
    "launcher": dict(leaf_idx=3, flat_idx=11, bit=21, step=3, replica=1,
                     target="grads"),
}
A, B, C = ([1, 2, 3, 4], [1, 9, 3, 4], [7, 2, 3, 4])
MAJORITY_CASES = [[A, B, A], [B, A, A], [A, B, C], [A, A, A],
                  [[A, B], [A, B], [A, C]], [[A, B], [B, B], [C, B]]]

JAX_SCRIPT = r"""
import contextlib, io, json, pickle, sys
import numpy as np, jax
from repro.configs import RunConfig, SedarConfig, TrainConfig, get_config, reduce_for_smoke
from repro.core import hostsync
from repro.core.detection import majority_replica
from repro.core.injection import InjectionSpec
from repro.launch.mesh import make_test_mesh
from repro.launch.train import manual_vote_baseline
from repro.runtime.train import SedarTrainer

base, args = sys.argv[1], json.loads(sys.argv[2])
out = {"majority": [list(majority_replica(np.asarray(c, np.uint32)))
                    for c in args["majority"]]}
cfg = reduce_for_smoke(get_config("paper-testapp"))
mesh = make_test_mesh((3, 2, 1), ("pod", "data", "model"))
rc = RunConfig(model=cfg, train=TrainConfig(steps=args["steps"], **args["train"]),
               sedar=SedarConfig(level=3, **args["sedar"]))
with mesh:
    tr = SedarTrainer(rc, base + "/vote", mesh=mesh,
                      inj_spec=InjectionSpec(**args["spec"]),
                      notify=lambda e: None)
    with open(base + "/vote_init.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, tr.init_state()), f)
    with hostsync.count_transfers() as st:
        _, rep = tr.run(args["steps"])
out["vote"] = dict(
    detections=[dict(step=e.step, boundary=e.boundary, effect=e.effect)
                for e in rep.detections],
    recoveries=[{k: r[k] for k in ("kind", "step", "rollbacks", "at",
                                   "src_replica") if k in r}
                for r in rep.recoveries],
    steps=rep.steps_completed, stopped=rep.stopped,
    losses=[float(x) for x in rep.losses], reads=dict(st.by_label))
rc1 = RunConfig(model=cfg, train=TrainConfig(steps=4, **args["train"]))
verdicts = {}
for name, spec in args["baseline"].items():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        manual_vote_baseline(rc1, f"{base}/mv_{name}", 4,
                             InjectionSpec(**spec))
    verdicts[name] = [l for l in buf.getvalue().splitlines()
                      if not l.startswith("[baseline] instance")]
out["baseline"] = verdicts
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    base = tmp_path_factory.mktemp("jax_vote")
    out = run_jax(JAX_SCRIPT, base, dict(
        majority=MAJORITY_CASES, steps=VOTE_STEPS, train=TRAIN,
        sedar=VOTE_SEDAR, spec=VOTE_SPEC, baseline=BASELINE_SPECS),
        devices=6)
    out["base"] = base
    return out


def test_majority_replica_matches_jax(ref):
    got = [list(majority_replica(np.asarray(c, np.uint32)))
           for c in MAJORITY_CASES]
    assert got == ref["majority"]
    assert got[0] == [0, True] and got[2] == [0, False]


def _negative_zeros(tree) -> int:
    """-0.0 elements of a CPU state (a diagnostic, not a counted read)."""
    from repro_torch import tree as tree_util
    return sum(int(((x == 0) & torch.signbit(x)).sum())
               for x in tree_util.leaves(tree)
               if isinstance(x, torch.Tensor) and x.is_floating_point())


def vote_rank(rank: int, rc, shape, workdir: str, init) -> dict:
    """The vote scenario on one rank: a clean run, then the fault run, each
    from JAX's initial state; the -0.0 the state holds when the broadcast
    repairs it."""
    from repro_torch import bridge
    mesh = tmesh.make_process_mesh(_mesh(shape))
    out = {}
    for name, spec in (("clean", None), ("fault", VOTE_SPEC)):
        tr = make_trainer(rc, os.path.join(workdir, name), device="cpu",
                          mesh=mesh, notify=lambda e: None,
                          inj_spec=spec and InjectionSpec(**spec))
        ex = tr.engine.executor
        at_repair = []

        def counting(src, bcast=ex.broadcaster):
            def run(tree):
                at_repair.append(_negative_zeros(tree))
                return bcast(src)(tree)
            return run

        ex.broadcaster = counting
        dual = ex.init_dual(bridge.train_state_from_numpy(init))
        with hostsync.count_transfers() as st:
            _, rep = tr.run(rc.train.steps, dual=dual)
        out[name] = dict(
            detections=[dict(step=e.step, boundary=e.boundary,
                             effect=e.effect) for e in rep.detections],
            recoveries=[dict(r) for r in rep.recoveries],
            steps=rep.steps_completed, stopped=rep.stopped,
            losses=list(rep.losses), reads=dict(st.by_label),
            final=np.asarray(rep.final_state_fp),
            negative_zeros_at_repair=at_repair)
    return out


def test_vote_repair_matches_jax(ref, tmp_path):
    """tests/test_multidevice.py:205 on six ranks: the params fault is an
    FSC repaired forward from the majority (vote_repair, 0 rollbacks), as
    in JAX, and every rank ends bitwise on the clean run's state."""
    want = ref["vote"]
    assert any(r["kind"] == "vote_repair" for r in want["recoveries"])
    with open(ref["base"] / "vote_init.pkl", "rb") as f:
        init = pickle.load(f)
    rc = _rc(VOTE_STEPS, VOTE_SEDAR).replace(mesh=_mesh((3, 2, 1)))
    reps = tmesh.spawn(vote_rank, 6, rc, (3, 2, 1), str(tmp_path), init,
                       threads=1, timeout_s=RANK_TIMEOUT_S)
    clean0 = reps[0]["clean"]["final"]
    for rep in reps:
        clean, fault = rep["clean"], rep["fault"]
        assert not clean["detections"] and clean["steps"] == VOTE_STEPS
        assert fault["detections"] == want["detections"]
        assert [{k: r[k] for k in ("kind", "step", "rollbacks", "at",
                                   "src_replica") if k in r}
                for r in fault["recoveries"]] == want["recoveries"]
        assert all(r["rollbacks"] == 0 for r in fault["recoveries"])
        assert fault["steps"] == want["steps"] == VOTE_STEPS
        assert fault["stopped"] == want["stopped"]
        assert fault["reads"] == want["reads"]
        np.testing.assert_allclose(fault["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_array_equal(clean["final"], clean0)
        np.testing.assert_array_equal(fault["final"], clean0)
        assert len(fault["negative_zeros_at_repair"]) == 1
    # the same count on every rank: the state is replicated
    assert len({r["fault"]["negative_zeros_at_repair"][0]
                for r in reps}) == 1


def test_manual_vote_baseline_matches_jax(ref, tmp_path, capsys):
    rc = RunConfig(model=reduce_for_smoke(get_config("paper-testapp")),
                   train=TrainConfig(steps=4, **TRAIN))
    for name, spec in BASELINE_SPECS.items():
        corrupted = launch_train.manual_vote_baseline(
            rc, str(tmp_path / name), 4, InjectionSpec(**spec),
            device="cpu")
        lines = [l for l in capsys.readouterr().out.splitlines()
                 if not l.startswith("[baseline] instance")]
        assert lines == ref["baseline"][name], name
        assert corrupted == (1 if name == "fires" else None)


@pytest.mark.parametrize("argv,expect", [
    (["--replication", "vote"], "vote: 3 pods x 1 data shards"),
    (["--manual-vote"], "[baseline] results MATCH"),
])
def test_vote_launchers_on_the_cpu(tmp_path, monkeypatch, capsys, argv,
                                   expect):
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--device", "cpu",
                                      "--steps", "3", "--workdir",
                                      str(tmp_path / "wd")])
    launch_train.main()
    out = capsys.readouterr().out
    assert expect in out, out
    if argv[0] == "--replication":
        assert "steps=3 detections=0" in out, out
        assert "final state fingerprints equal on every rank: True" in out
