"""The mesh backend `pod` against the JAX package, on the CPU.

The reference runs its replicas as pods of a device mesh (forced host
devices, `tests/test_multidevice.py`); the port runs one process per (pod,
data) rank over gloo on localhost (`repro_torch/launch/mesh.py`). The JAX
side runs in one subprocess with eight forced host devices and prints JSON;
this module itself imports no JAX, so the spawned ranks (which import it to
find their function) start light. Held against JAX:

  * `pytree_fingerprint_lanes` bitwise on h1/h2 (and absmax) for L = 1, 2,
    3, 8 on a tree whose leaves cross lane boundaries, with a zero-padded
    tail; `lane_of_leaf_index`; `lanes_to_hosts`;
  * the pod comparator, the lane comparator, the broadcaster and the
    injector with 2 and 3 ranks (each rank's local result against each
    pod's), where the broadcaster keeps a -0.0 that the reference's masked
    psum makes +0.0 (ROADMAP Queue 3, C4);
  * the reference scenarios of `tests/test_multidevice.py:49` (a grads
    fault localized to its lane and host, restored) and `:89` (a clean
    deferred run that reads no commit predicate), the port at mesh (2, 2,
    1) against JAX at (2, 2, 2) from JAX's initial state: the same events
    (step, boundary, effect, lanes, hosts), recovery records, checkpoints,
    step count and device reads by label; losses within rtol 1e-5 (the
    port averages two shard means where JAX takes one mean over the
    batch); every rank's final state bitwise equal;
  * the launcher's `--replication pod --pods 2 --data 2 --device cpu`.
Each rank runs one torch thread.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import (MeshConfig, RunConfig, SedarConfig,
                                 TrainConfig, get_config, reduce_for_smoke)
from repro_torch.core import fingerprint as tfp
from repro_torch.core.detection import (make_lane_comparator,
                                        make_pod_broadcaster,
                                        make_pod_comparator,
                                        make_pod_injector)
from repro_torch.core.injection import InjectionSpec
from repro_torch.kernels import fingerprint as kfp
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as launch_train
from repro_torch.runtime.cluster import lanes_to_hosts
from repro_torch.runtime.train import SedarTrainer

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_RTOL = 1e-5
RANK_TIMEOUT_S = 180
TRAIN = dict(global_batch=4, seq_len=16, warmup_steps=2, lr=1e-3)
LANES = (1, 2, 3, 8)
INDEX_CASES = [(0, 0), (0, 34), (1, 0), (2, 5), (2, 53), (3, 2)]
HOST_CASES = [([0], 1), ([1], 2), ([0, 2], 3), ([], 2)]
# the reference scenarios: name -> (steps, sedar, spec)
SCENARIOS = {
    "detect": (8, dict(replication="pod", validate_interval=1,
                       param_validate_interval=4, checkpoint_interval=4),
               dict(leaf_idx=3, flat_idx=5, bit=20, step=5, replica=1,
                    target="grads")),
    "zero_sync": (16, dict(replication="pod", validate_interval=1,
                           validate_lag=4, param_validate_interval=100,
                           checkpoint_interval=8,
                           ckpt_tiers="device,partner"), None),
}


def lanes_tree_np():
    """A small tree whose 105 words cross every lane width tried: f32,
    int32, bf16 (given as f32, rounded by each package) and f32 leaves."""
    r = np.random.RandomState(0)
    return {"a": r.standard_normal((5, 7)).astype(np.float32),
            "b": r.randint(-2 ** 31, 2 ** 31 - 1, 13).astype(np.int32),
            "c": r.standard_normal((6, 9)).astype(np.float32),
            "d": r.standard_normal(3).astype(np.float32)}


JAX_SCRIPT = r"""
import json, pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import RunConfig, SedarConfig, TrainConfig, get_config, reduce_for_smoke
from repro.core import hostsync
from repro.core.detection import (make_lane_comparator, make_pod_broadcaster,
                                  make_pod_comparator, make_pod_injector)
from repro.core.fingerprint import lane_of_leaf_index, pytree_fingerprint_lanes
from repro.core.injection import InjectionSpec
from repro.launch.mesh import make_test_mesh
from repro.runtime.cluster import lanes_to_hosts
from repro.runtime.train import SedarTrainer

base, args = sys.argv[1], json.loads(sys.argv[2])
out = {}
with open(base + "/lanes_tree.pkl", "rb") as f:
    t = pickle.load(f)
tree = {"a": jnp.asarray(t["a"]), "b": jnp.asarray(t["b"]),
        "c": jnp.asarray(t["c"], jnp.bfloat16), "d": jnp.asarray(t["d"])}
out["lanes"] = {str(L): np.asarray(pytree_fingerprint_lanes(tree, L)).tolist()
                for L in args["lanes"]}
out["lane_of"] = {str(L): [lane_of_leaf_index(tree, i, j, L)
                           for i, j in args["index_cases"]]
                  for L in args["lanes"]}
out["hosts"] = [lanes_to_hosts(l, hosts_per_data_shard=h)
                for l, h in args["host_cases"]]


def per_pod(mesh, xs):
    devs = mesh.devices.reshape(-1)
    return jax.make_array_from_single_device_arrays(
        xs[0].shape, NamedSharding(mesh, P()),
        [jax.device_put(x, d) for x, d in zip(xs, devs)])


def local(a):
    return [np.asarray(s.data) for s in
            sorted(a.addressable_shards, key=lambda s: s.device.id)]


sem = {}
for n in (2, 3):
    mesh = make_test_mesh((n, 1, 1), ("pod", "data", "model"))
    fp = np.array([1, 2, 3, 4], np.uint32)
    cmp = make_pod_comparator(mesh)
    r = {}
    eq, _ = cmp(per_pod(mesh, [fp] * n))
    r["same"] = [bool(x) for x in local(eq)]
    bad = [fp.copy() for _ in range(n)]
    bad[-1][1] ^= 1
    eq, fa = cmp(per_pod(mesh, bad))
    r["h2"] = [bool(x) for x in local(eq)]
    r["fp_all"] = [x.tolist() for x in local(fa)]
    st = [fp.copy() for _ in range(n)]
    st[-1][2] ^= 1
    eq, _ = cmp(per_pod(mesh, st))
    r["stats"] = [bool(x) for x in local(eq)]
    lanes = np.array([[5, 6, 7, 8], [2 ** 31, 2 ** 32 - 1, 0, 0],
                      [9, 9, 9, 9]], np.uint32)
    lb = [lanes.copy() for _ in range(n)]
    lb[-1][1, 0] ^= 4
    lc = make_lane_comparator(mesh)
    r["lanes"] = [x.tolist() for x in local(lc(per_pod(mesh, lb)))]
    r["lanes_same"] = [x.tolist() for x in local(lc(per_pod(mesh, [lanes] * n)))]
    w = [np.array([-0.0, 1.5 * p, 3.0], np.float32) for p in range(n)]
    iv = [np.array([p, 7], np.int32) for p in range(n)]
    b = make_pod_broadcaster(mesh)(1)({"w": per_pod(mesh, w),
                                       "i": per_pod(mesh, iv)})
    r["bcast_w"] = [x.view(np.uint32).tolist() for x in local(b["w"])]
    r["bcast_i"] = [x.tolist() for x in local(b["i"])]
    spec = InjectionSpec(leaf_idx=1, flat_idx=2, bit=3, step=2, replica=1,
                         target="grads")
    inj = make_pod_injector(mesh, spec)
    tr = {"a": jnp.arange(4, dtype=jnp.float32),
          "b": jnp.arange(6, dtype=jnp.float32) + 1.0}
    for s in (1, 2):
        o = inj(tr, jnp.asarray(s, jnp.int32))
        r[f"inject{s}"] = [x.view(np.uint32).tolist() for x in local(o["b"])]
    sem[str(n)] = r
out["semantics"] = sem

runs = {}
for name, (steps, sedar, spec) in args["scenarios"].items():
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    cfg = reduce_for_smoke(get_config("paper-testapp"))
    rc = RunConfig(model=cfg, train=TrainConfig(steps=steps, **args["train"]),
                   sedar=SedarConfig(level=3, **sedar))
    with mesh:
        tr = SedarTrainer(rc, f"{base}/{name}", mesh=mesh,
                          inj_spec=spec and InjectionSpec(**spec),
                          notify=lambda e: None)
        with open(f"{base}/{name}_init.pkl", "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, tr.init_state()), f)
        with hostsync.count_transfers() as st:
            _, rep = tr.run(steps)
    runs[name] = dict(
        detections=[dict(step=e.step, boundary=e.boundary, effect=e.effect,
                         lanes=e.detail.get("lanes"),
                         hosts=e.detail.get("hosts"))
                    for e in rep.detections],
        recoveries=[{k: r[k] for k in ("kind", "step", "rollbacks", "at")}
                    for r in rep.recoveries],
        checkpoints=list(rep.checkpoints), steps=rep.steps_completed,
        stopped=rep.stopped, losses=[float(x) for x in rep.losses],
        reads=dict(st.by_label))
out["runs"] = runs
print("JSON" + json.dumps(out))
"""


def run_jax(script: str, base, args: dict, devices: int) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    out = subprocess.run([sys.executable, "-c", script, str(base),
                          json.dumps(args)], env=env, capture_output=True,
                         text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("JSON")][-1]
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    base = tmp_path_factory.mktemp("jax_mesh")
    with open(base / "lanes_tree.pkl", "wb") as f:
        pickle.dump(lanes_tree_np(), f)
    out = run_jax(JAX_SCRIPT, base, dict(
        lanes=LANES, index_cases=INDEX_CASES, host_cases=HOST_CASES,
        scenarios=SCENARIOS, train=TRAIN), devices=8)
    out["base"] = base
    return out


def lanes_tree_torch():
    t = {k: torch.from_numpy(v) for k, v in lanes_tree_np().items()}
    t["c"] = t["c"].to(torch.bfloat16)
    return t


def _words(fp) -> np.ndarray:
    return np.asarray(fp).astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("L", LANES)
def test_fingerprint_lanes_match_jax(ref, L):
    """h1, h2 and absmax of every lane bitwise equal to JAX's, through
    `pytree_fingerprint_lanes` and through K1's plain version over the
    lane table (split rows, zero-padding rows) called directly."""
    want = np.asarray(ref["lanes"][str(L)], dtype=np.int64)
    tree = lanes_tree_torch()
    got = _words(tfp.pytree_fingerprint_lanes(tree, L))
    table = kfp.lane_table(list(tree.values()), L)
    by_table = _words(kfp.fingerprint_lanes(table, L))
    assert got.shape == (L, 4)
    for g in (got, by_table):
        np.testing.assert_array_equal(g[:, :2], want[:, :2])
        np.testing.assert_array_equal(g[:, 3], want[:, 3])
    if L == 1:      # the sum word is a float sum taken in another order
        np.testing.assert_array_equal(
            got[0, [0, 1, 3]],
            _words(tfp.pytree_fingerprint_fused(tree))[[0, 1, 3]])


def test_lane_table_splits_strided_leaves_and_pads():
    """K1's lane table reads a strided leaf in place: rows cut at lane
    boundaries mid-row give the lanes of the contiguous copy, bitwise on
    h1/h2, and 3 words in 8 lanes leave five lanes of padding alone."""
    r = np.random.RandomState(3)
    base = torch.from_numpy(r.standard_normal((10, 8)).astype(np.float32))
    leaves = [base[:, 1:6], torch.arange(7, dtype=torch.int32)]
    for L in (2, 3, 5, 8, 16):
        table = kfp.lane_table(leaves, L)
        # a lane of 29 words keeps whole rows of the view at its stride
        assert any(row.rows > 1 and row.stride == 8
                   for row in table) or L > 2
        got = _words(kfp.fingerprint_lanes(table, L))
        want = _words(tfp.pytree_fingerprint_lanes(
            [l.contiguous() for l in leaves], L))
        np.testing.assert_array_equal(got[:, :2], want[:, :2])
    tiny = [torch.ones(3)]
    table = kfp.lane_table(tiny, 8)
    assert sum(row.kind == kfp.ZEROS for row in table) == 5
    np.testing.assert_array_equal(
        _words(kfp.fingerprint_lanes(table, 8))[:, :2],
        _words(tfp.pytree_fingerprint_lanes(tiny, 8))[:, :2])
    with pytest.raises(ValueError, match="at most"):
        kfp.lane_table(tiny, kfp.MAX_LANES + 1)


def test_lane_of_leaf_index_and_lanes_to_hosts_match_jax(ref):
    tree = lanes_tree_torch()
    for L in LANES:
        assert [tfp.lane_of_leaf_index(tree, i, j, L)
                for i, j in INDEX_CASES] == ref["lane_of"][str(L)]
    assert [lanes_to_hosts(l, hosts_per_data_shard=h)
            for l, h in HOST_CASES] == ref["hosts"]


def semantics_rank(rank: int, n: int) -> dict:
    """One rank of the comparator semantics: the same inputs as the JAX
    script's pod `rank` (mesh (n, 1, 1))."""
    mesh = tmesh.make_process_mesh(_mesh((n, 1, 1)))
    last = mesh.pod == n - 1

    def u32(a):
        return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32))

    out = {}
    fp = np.array([1, 2, 3, 4], np.uint32)
    cmp = make_pod_comparator(mesh)
    out["same"] = bool(cmp(u32(fp))[0])
    bad = fp.copy()
    if last:
        bad[1] ^= 1
    eq, fa = cmp(u32(bad))
    out["h2"] = bool(eq)
    out["fp_all"] = fa.numpy().view(np.uint32).tolist()
    st = fp.copy()
    if last:
        st[2] ^= 1
    out["stats"] = bool(cmp(u32(st))[0])
    lanes = np.array([[5, 6, 7, 8], [2 ** 31, 2 ** 32 - 1, 0, 0],
                      [9, 9, 9, 9]], np.uint32)
    lb = lanes.copy()
    if last:
        lb[1, 0] ^= 4
    lc = make_lane_comparator(mesh)
    out["lanes"] = lc(u32(lb)).tolist()
    out["lanes_same"] = lc(u32(lanes)).tolist()
    tree = {"w": torch.tensor([-0.0, 1.5 * mesh.pod, 3.0]),
            "i": torch.tensor([mesh.pod, 7], dtype=torch.int32)}
    b = make_pod_broadcaster(mesh)(1)(tree)
    assert b["w"] is tree["w"]            # in place
    out["bcast_w"] = b["w"].numpy().view(np.uint32).tolist()
    out["bcast_i"] = b["i"].tolist()
    spec = InjectionSpec(leaf_idx=1, flat_idx=2, bit=3, step=2, replica=1,
                         target="grads")
    inj = make_pod_injector(mesh, spec)
    tr = {"a": torch.arange(4, dtype=torch.float32),
          "b": torch.arange(6, dtype=torch.float32) + 1.0}
    for s in (1, 2):
        out[f"inject{s}"] = inj(tr, s, True)["b"].numpy().view(
            np.uint32).tolist()
    return out


@pytest.mark.parametrize("n", [2, 3])
def test_pod_comparators_match_jax(ref, n):
    """Each rank's comparator, lane comparator, broadcaster and injector
    results equal the JAX pod's local ones, except the broadcast -0.0:
    the port's `dist.broadcast` copies its bits, the reference's masked
    psum gives +0.0 on every pod (C4)."""
    want = ref["semantics"][str(n)]
    got = tmesh.spawn(semantics_rank, n, n, threads=1,
                      timeout_s=RANK_TIMEOUT_S)
    for key in ("same", "h2", "stats", "lanes", "lanes_same", "bcast_i",
                "inject1", "inject2"):
        assert [g[key] for g in got] == want[key], key
    for g in got:
        assert g["fp_all"] == want["fp_all"][0]
    neg_zero = 0x80000000
    for g, w in zip(got, want["bcast_w"]):
        assert g["bcast_w"][0] == neg_zero and w[0] == 0
        assert g["bcast_w"][1:] == w[1:]


def _mesh(shape) -> MeshConfig:
    return MeshConfig(shape=shape, axis_names=("pod", "data", "model"))


def _rc(steps: int, sedar: dict) -> RunConfig:
    return RunConfig(model=reduce_for_smoke(get_config("paper-testapp")),
                     train=TrainConfig(steps=steps, **TRAIN),
                     sedar=SedarConfig(level=3, **sedar))


def run_port(ref, name: str, tmp_path, shape=(2, 2, 1)):
    """The scenario on the port's ranks from JAX's initial state."""
    steps, sedar, spec = SCENARIOS[name]
    with open(ref["base"] / f"{name}_init.pkl", "rb") as f:
        init = pickle.load(f)
    n = shape[0] * shape[1]
    return tmesh.spawn(launch_train.mesh_rank, n,
                       _rc(steps, sedar).replace(mesh=_mesh(shape)),
                       _mesh(shape), str(tmp_path / name),
                       spec and InjectionSpec(**spec), "cpu", init,
                       threads=1, timeout_s=RANK_TIMEOUT_S)


def check_against_jax(reps, want) -> None:
    for rep in reps:
        assert rep["detections"] == want["detections"]
        assert [{k: r[k] for k in ("kind", "step", "rollbacks", "at")}
                for r in rep["recoveries"]] == want["recoveries"]
        assert rep["checkpoints"] == want["checkpoints"]
        assert rep["steps"] == want["steps"]
        assert rep["stopped"] == want["stopped"]
        assert rep["reads"] == want["reads"]
        np.testing.assert_allclose(rep["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        # every rank ends on the same bits
        np.testing.assert_array_equal(rep["final_state_fp"],
                                      reps[0]["final_state_fp"])


def test_pod_detection_matches_jax(ref, tmp_path):
    """tests/test_multidevice.py:49: the grads fault at step 5 on pod 1 is
    a commit TDC in the lane that holds leaf 3's element 5 (lane 0 of 2,
    host 0), restored from the step-4 checkpoint; 8 steps complete."""
    want = ref["runs"]["detect"]
    assert want["detections"][0]["lanes"] == [0]
    reps = run_port(ref, "detect", tmp_path)
    check_against_jax(reps, want)
    assert [(r["pod"], r["data"]) for r in reps] == [(0, 0), (0, 1),
                                                     (1, 0), (1, 1)]
    assert all(r["collectives"]["lane_compare"] == 10 for r in reps)


def test_pod_zero_sync_matches_jax(ref, tmp_path):
    """tests/test_multidevice.py:89: a clean lag-4 run reads no commit
    predicate (the compare is a collective inside the step) and flushes
    its window at most 16 / 4 + 2 times, with JAX's reads exactly."""
    want = ref["runs"]["zero_sync"]
    reps = run_port(ref, "zero_sync", tmp_path)
    check_against_jax(reps, want)
    for rep in reps:
        assert not rep["detections"] and rep["steps"] == 16
        assert "commit_compare" not in rep["reads"]
        assert rep["reads"]["deferred_flush"] <= 16 // 4 + 2


def test_pod_launcher_on_the_cpu(tmp_path, monkeypatch, capsys):
    """--replication pod --pods 2 --data 2 --device cpu: the launcher spawns
    its four ranks; the launcher's grads fault (leaf 3, element 11, pod 1)
    is localized to its lane and restored, and every rank ends on the
    same state."""
    monkeypatch.setattr(sys, "argv", [
        "train", "--replication", "pod", "--pods", "2", "--data", "2",
        "--device", "cpu", "--steps", "4", "--ckpt-interval", "2",
        "--inject-step", "3", "--workdir", str(tmp_path / "wd")])
    launch_train.main()
    out = capsys.readouterr().out
    assert "pod: 2 pods x 2 data shards" in out, out
    assert "steps=4 detections=1 recoveries=1" in out, out
    assert "(boundary=commit, TDC) lanes=[0] hosts=[0]" in out, out
    assert "final state fingerprints equal on every rank: True" in out
    assert sorted(os.listdir(tmp_path / "wd")) == [f"rank{r}"
                                                   for r in range(4)]


def test_model_axis_and_a_missing_mesh_raise(tmp_path):
    """The trainers shard no state over a model axis (expert parallelism
    runs inside the MoE layer), and the mesh's shape comes from
    run_cfg.mesh alone: a process mesh of another shape raises."""
    mesh = tmesh.ProcessMesh((2, 2, 2), ("pod", "data", "model"), 0, 0, 0,
                             None, None, [0, 4], list(range(8)))
    rc = _rc(2, dict(replication="pod"))
    with pytest.raises(NotImplementedError, match="model axis"):
        SedarTrainer(rc.replace(mesh=_mesh((2, 2, 2))), str(tmp_path),
                     device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="disagrees with run_cfg.mesh"):
        SedarTrainer(rc.replace(mesh=_mesh((2, 1, 1))), str(tmp_path),
                     device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="needs mesh="):
        SedarTrainer(_rc(2, dict(replication="pod")), str(tmp_path),
                     device="cpu")
