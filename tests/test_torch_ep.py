"""The port's sharding rules, the model axis of the process mesh and
expert-parallel MoE (`sharding.py`, `launch/mesh.py::make_process_mesh`,
`models/moe.py::moe_mlp_ep`) against the JAX reference.

  * the resolver: the cases of `tests/test_multidevice.py:25-46` and the
    MoE weights' `experts` axis (reduced and full phi3.5-moe over meshes
    (1, 2), (2, 2), (2, 2, 2) and (1, 3)), specs and fallback records
    equal to the reference's;
  * `make_process_mesh` at (pod, data, model) = (2, 2, 2): each rank's
    indices and its pod, data and model groups (an all_reduce over each);
  * EP over gloo ranks on the CPU (`launch/mesh.py::spawn`) at (data,
    model) = (1, 2) and (2, 2) against the reference's `moe_mlp_ep` under
    `shard_map` (a subprocess with forced host devices, as
    `tests/test_multidevice.py` runs JAX), on reduced phi3.5-moe (4
    experts, top 2) where tokens drop: output, aux, drop fraction (equal)
    and the grads of mean(out * ct) + aux for the router, the experts and
    x, within atol 1e-5 and rtol 1e-5 (f32, the same math in another
    summation order); and against the port's one-process `moe_mlp` with
    the tokens split into the same tp x D dispatch groups, within 1e-6.

This module imports no JAX: the spawned ranks import it and start light.
Each test has its own time limit (`_time_limit`; the rank spawns and the
subprocess also carry their own)."""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import MeshConfig, get_config, reduce_for_smoke
from repro_torch.launch import mesh as tmesh
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import ShardCtx
from repro_torch.sharding import Resolver, ShardingRules, batch_spec

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TEST_TIMEOUT_S = 300
RANK_TIMEOUT_S = 240
TOL = dict(atol=1e-5, rtol=1e-5)
ORACLE_TOL = dict(atol=1e-6, rtol=1e-6)
ARCH = "phi3.5-moe-42b-a6.6b"
B, S = 4, 8
EP_SHAPES = [(1, 2), (2, 2)]
WEIGHTS = ("router", "w_gate", "w_up", "w_down")


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test's own time limit: SIGALRM fails it past TEST_TIMEOUT_S."""
    def expired(signum, frame):
        raise TimeoutError(f"test ran past {TEST_TIMEOUT_S} s")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(TEST_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _jax(script: str, *args, devices: int = 8) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    out = subprocess.run([sys.executable, "-c", script, *args], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# The resolver
# ---------------------------------------------------------------------------

RESOLVER_CASES = [
    # tests/test_multidevice.py:31-43 on (pod, data, model) = (2, 2, 2)
    ((2, 2, 2), ("embed", "heads", "head_dim"), (8, 4, 16), "wq"),
    ((2, 2, 2), ("embed", "heads", "head_dim"), (8, 3, 16), "wq_bad"),
    ((2, 2, 2), ("batch_dm", None, None), (4, 5, 7), "act"),
    ((2, 2, 2), ("batch_dm", None, None), (2, 5, 7), "act2"),
    ((2, 2, 2), ("batch", "seq", "embed"), (6, 16, 32), "x"),
    ((1, 2, 3), ("vocab", "embed"), (257, 64), "head"),
]
MOE_MESHES = [(1, 1, 2), (1, 2, 2), (2, 2, 2), (1, 1, 3)]

RESOLVER_SCRIPT = r"""
import json, sys
import numpy as np
from repro.configs import get_config, reduce_for_smoke
from repro.launch.mesh import make_test_mesh
from repro.models import moe
from repro.sharding import Resolver, ShardingRules, batch_spec
import jax
args = json.loads(sys.argv[1])
AX = ("pod", "data", "model")
def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]
out = {"cases": [], "moe": [],
       "batch": [enc([batch_spec(ShardingRules(data_axes=a))])
                 for a in (("data",), ("pod", "data"))]}
for shape, logical, dims, name in args["cases"]:
    r = Resolver(make_test_mesh(tuple(shape), AX),
                 ShardingRules(data_axes=("data",)))
    s = r.spec(tuple(logical), tuple(dims), name)
    out["cases"].append([enc(s), r.fallback_report()])
for arch in args["archs"]:
    for full in (False, True):
        cfg = get_config(arch)
        cfg = cfg if full else reduce_for_smoke(cfg)
        shapes = jax.eval_shape(lambda k: moe.init_moe(k, cfg, layers=2)[0],
                                jax.random.PRNGKey(0))
        shapes = {k: tuple(v.shape) for k, v in shapes.items()}
        _, ax = moe.init_moe(jax.random.PRNGKey(0), reduce_for_smoke(cfg),
                             layers=2)
        for shape in args["meshes"]:
            r = Resolver(make_test_mesh(tuple(shape), AX), ShardingRules())
            specs = r.tree_specs(ax, shapes)
            out["moe"].append([{k: enc(v) for k, v in specs.items()},
                               r.fallback_report()])
print(json.dumps(out))
"""


def _enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _norm(report):
    return [dict(f, wanted=list(f["wanted"])) for f in report]


@pytest.fixture(scope="module")
def jax_resolver():
    return _jax(RESOLVER_SCRIPT, json.dumps(dict(
        cases=RESOLVER_CASES, archs=[ARCH], meshes=MOE_MESHES)))


@pytest.mark.parametrize("i", range(len(RESOLVER_CASES)))
def test_resolver_cases_match_reference(jax_resolver, i):
    shape, logical, dims, name = RESOLVER_CASES[i]
    sizes = dict(zip(("pod", "data", "model"), shape))
    r = Resolver(sizes, ShardingRules(data_axes=("data",)))
    spec = r.spec(logical, dims, name)
    want_spec, want_fb = jax_resolver["cases"][i]
    assert _enc(spec) == want_spec
    assert _norm(r.fallback_report()) == _norm(want_fb)
    if name == "wq":        # the reference test's own assertions
        assert "model" in spec and "data" in spec
    if name == "wq_bad":
        assert spec[1] is None and any(f.logical == "heads"
                                       for f in r.fallbacks)
    if name == "act":
        assert spec[0] == ("data", "model")
    if name == "act2":
        assert spec[0] == "data"


def test_batch_spec_matches_reference(jax_resolver):
    assert [_enc([batch_spec(ShardingRules(data_axes=a))])
            for a in (("data",), ("pod", "data"))] == jax_resolver["batch"]


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("mesh_shape", MOE_MESHES)
def test_moe_weights_experts_axis_matches_reference(jax_resolver, full,
                                                    mesh_shape):
    cfg = get_config(ARCH)
    cfg = cfg if full else reduce_for_smoke(cfg)
    E, Dm, F_ = cfg.num_experts, cfg.d_model, cfg.d_ff
    shapes = {"router": (2, Dm, E), "w_gate": (2, E, Dm, F_),
              "w_up": (2, E, Dm, F_), "w_down": (2, E, F_, Dm)}
    r = Resolver(dict(zip(("pod", "data", "model"), mesh_shape)))
    specs = r.tree_specs(tmoe.moe_axes(layers=2), shapes)
    k = int(full) * len(MOE_MESHES) + MOE_MESHES.index(mesh_shape)
    want_specs, want_fb = jax_resolver["moe"][k]
    assert {n: _enc(s) for n, s in specs.items()} == want_specs
    assert _norm(r.fallback_report()) == _norm(want_fb)
    tp = mesh_shape[2]
    if E % tp == 0 and tp > 1:
        assert specs["w_gate"][1] == "model"     # experts over the model axis


# ---------------------------------------------------------------------------
# The process mesh's model axis
# ---------------------------------------------------------------------------

def groups_rank(rank: int) -> dict:
    import torch.distributed as dist
    m = tmesh.make_process_mesh(MeshConfig(
        shape=(2, 2, 2), axis_names=("pod", "data", "model")))

    def members(g):
        t = torch.tensor([float(1 << rank)])
        dist.all_reduce(t, group=g)
        return [r for r in range(8) if int(t.item()) >> r & 1]

    return dict(idx=(m.pod, m.data, m.model), ranks=m.ranks,
                pod=members(m.pod_group), data=members(m.data_group),
                model=members(m.model_group), pod_ranks=m.pod_ranks)


def test_make_process_mesh_groups_at_2_2_2():
    """Ranks in (pod, data, model) order, as the reference's device grid;
    the pod group shares (data, model), the data group (pod, model), the
    model group (pod, data)."""
    got = tmesh.spawn(groups_rank, 8, threads=1, timeout_s=RANK_TIMEOUT_S)
    for r, g in enumerate(got):
        p, d, m = r // 4, r // 2 % 2, r % 2
        assert g["idx"] == (p, d, m) and g["ranks"] == list(range(8))
        assert g["pod"] == g["pod_ranks"] == [d * 2 + m, 4 + d * 2 + m]
        assert g["data"] == [p * 4 + m, p * 4 + 2 + m]
        assert g["model"] == [p * 4 + d * 2, p * 4 + d * 2 + 1]


# ---------------------------------------------------------------------------
# Expert parallelism
# ---------------------------------------------------------------------------

def _cfg():
    cfg = reduce_for_smoke(get_config(ARCH))
    assert (cfg.num_experts, cfg.experts_per_token) == (4, 2)
    return cfg


def _inputs(seed: int = 0) -> dict:
    cfg = _cfg()
    r = np.random.RandomState(seed)
    E, Dm, F_ = cfg.num_experts, cfg.d_model, cfg.d_ff
    f = lambda *s, scale: (scale * r.standard_normal(s)).astype(np.float32)
    return {"router": f(Dm, E, scale=Dm ** -0.5),
            "w_gate": f(E, Dm, F_, scale=Dm ** -0.5),
            "w_up": f(E, Dm, F_, scale=Dm ** -0.5),
            "w_down": f(E, F_, Dm, scale=F_ ** -0.5),
            "x": f(B, S, Dm, scale=1.0), "ct": f(B, S, Dm, scale=1.0)}


EP_SCRIPT = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config, reduce_for_smoke
from repro.launch.mesh import make_test_mesh
from repro.models import moe
from repro.models.transformer import ShardCtx
from repro.sharding import Resolver, ShardingRules
d = np.load(sys.argv[1])
cfg = reduce_for_smoke(get_config(sys.argv[2]))
p = {k: jnp.asarray(d[k]) for k in ("router", "w_gate", "w_up", "w_down")}
x, ct = jnp.asarray(d["x"]), jnp.asarray(d["ct"])
out = {}
for shape in json.loads(sys.argv[3]):
    mesh = make_test_mesh(tuple(shape), ("data", "model"))
    ctx = ShardCtx(mesh, Resolver(mesh, ShardingRules()))
    def f(p, x):
        o, aux = moe.moe_mlp(cfg, p, x, ctx=ctx)
        return jnp.mean(o * ct) + aux["moe_aux"], (o, aux)
    with mesh:
        (_, (o, aux)), (gp, gx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(p, x)
    out[str(tuple(shape))] = dict(
        out=np.asarray(o).tolist(), aux=float(aux["moe_aux"]),
        drop=float(aux["moe_drop_frac"]), gx=np.asarray(gx).tolist(),
        **{"g_" + k: np.asarray(v).tolist() for k, v in gp.items()})
print(json.dumps(out))
"""


def ep_rank(rank: int, shape, inputs: dict) -> dict:
    """EP on one rank of MeshConfig(shape, (data, model)): this rank's data
    shard of x and its experts' slices; returns its output, aux, drop
    fraction and grads of mean(out * ct) + aux over its shard."""
    from repro_torch.core import hostsync
    mesh = tmesh.make_process_mesh(MeshConfig(shape=shape,
                                              axis_names=("data", "model")))
    ctx = ShardCtx(mesh, Resolver(mesh))
    D, tp = shape
    full = {k: torch.from_numpy(inputs[k]) for k in WEIGHTS}
    p = {k: v.clone().requires_grad_(True)
         for k, v in bridge.expert_shard(full, tp, mesh.model).items()}
    rows = B // D
    sl = slice(mesh.data * rows, (mesh.data + 1) * rows)
    x = torch.from_numpy(inputs["x"][sl]).requires_grad_(True)
    with hostsync.count_transfers() as st:
        out, aux = tmoe.moe_mlp(_cfg(), p, x, ctx=ctx)
        loss = torch.mean(out * torch.from_numpy(inputs["ct"][sl])) \
            + aux["moe_aux"]
        loss.backward()
    return dict(out=out.detach().numpy(), aux=float(aux["moe_aux"]),
                drop=float(aux["moe_drop_frac"]), gx=x.grad.numpy(),
                data=mesh.data, model=mesh.model,
                collectives=dict(st.collectives),
                **{"g_" + k: v.grad.numpy() for k, v in p.items()})


def _assemble(reps, shape) -> dict:
    """The ranks' results as the reference's global arrays: the output and
    x's grad by data shard (x's grad scaled from the shard's mean to the
    global one), the router's grad averaged over the data group, each
    expert slice's grad averaged over it and joined along the experts
    axis (the trainers' data-parallel convention)."""
    D, tp = shape
    by = {(r["data"], r["model"]): r for r in reps}
    for d in range(D):
        for m in range(tp):   # every model rank holds its shard's output
            assert np.array_equal(by[d, m]["out"], by[d, 0]["out"])
            assert np.array_equal(by[d, m]["g_router"], by[d, 0]["g_router"])
    got = dict(out=np.concatenate([by[d, 0]["out"] for d in range(D)]),
               gx=np.concatenate([by[d, 0]["gx"] for d in range(D)]) / D,
               g_router=np.mean([by[d, 0]["g_router"] for d in range(D)], 0))
    for k in WEIGHTS[1:]:
        got["g_" + k] = np.concatenate(
            [np.mean([by[d, m]["g_" + k] for d in range(D)], 0)
             for m in range(tp)])
    return got


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("ep")
    inputs = _inputs()
    np.savez(base / "in.npz", **inputs)
    want = _jax(EP_SCRIPT, str(base / "in.npz"), ARCH,
                json.dumps([list(s) for s in EP_SHAPES]), devices=4)
    runs = {}
    for shape in EP_SHAPES:
        reps = tmesh.spawn(ep_rank, shape[0] * shape[1], shape, inputs,
                           threads=1, timeout_s=RANK_TIMEOUT_S)
        runs[shape] = (reps, want[str(shape)])
    return inputs, runs


@pytest.mark.parametrize("shape", EP_SHAPES)
def test_ep_over_gloo_ranks_matches_reference_shard_map(ep_runs, shape):
    inputs, runs = ep_runs
    reps, want = runs[shape]
    got = _assemble(reps, shape)
    assert {r["drop"] for r in reps} == {want["drop"]}
    assert want["drop"] > 0              # the case drops tokens
    for r in reps:
        np.testing.assert_allclose(r["aux"], want["aux"], **TOL)
        # forward: 2 exchanges, 1 gather, 2 means; backward: 2 exchanges,
        # the token slice's gather and the router's sum
        assert r["collectives"] == {"ep_dispatch": 2, "ep_combine": 2,
                                    "ep_gather": 3, "ep_stats": 2}
    for k in ("out", "gx", "g_router", "g_w_gate", "g_w_up", "g_w_down"):
        np.testing.assert_allclose(got[k], np.asarray(want[k], np.float32),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("shape", EP_SHAPES)
def test_ep_equals_one_process_grouped_moe(ep_runs, shape):
    """EP on tp x D ranks is the one-process `moe_mlp` with the tokens split
    into tp x D dispatch groups (each group a rank's token slice, in the
    reference's token order): the same routing, capacity and drops."""
    inputs, runs = ep_runs
    reps, _ = runs[shape]
    got = _assemble(reps, shape)
    G = shape[0] * shape[1]
    p = {k: torch.from_numpy(inputs[k]).requires_grad_(True) for k in WEIGHTS}
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    out, aux = tmoe.moe_mlp(_cfg(), p, x, groups=G)
    (torch.mean(out * torch.from_numpy(inputs["ct"]))
     + aux["moe_aux"]).backward()
    assert float(aux["moe_drop_frac"]) == reps[0]["drop"]
    np.testing.assert_allclose(aux["moe_aux"].item(), reps[0]["aux"],
                               **ORACLE_TOL)
    want = dict(out=out.detach().numpy(), gx=x.grad.numpy(),
                **{"g_" + k: v.grad.numpy() for k, v in p.items()})
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **ORACLE_TOL)


def test_moe_mlp_without_a_model_axis_routes_its_shard():
    """A ctx whose model axis is 1 (or whose experts do not split) keeps
    the one-process path: the rank's data shard routes as one group."""
    cfg = _cfg()
    inputs = _inputs(1)
    p = {k: torch.from_numpy(inputs[k]) for k in WEIGHTS}
    x = torch.from_numpy(inputs["x"])
    mesh = tmesh.ProcessMesh((2, 1), ("data", "model"), 0, 0, 0, None, None,
                             [0], [0, 1])
    ctx = ShardCtx(mesh, Resolver(mesh))
    assert ctx.tp_size() == 1
    o1, a1 = tmoe.moe_mlp(cfg, p, x, ctx=ctx)
    o2, a2 = tmoe.moe_mlp(cfg, p, x)
    assert torch.equal(o1, o2) and torch.equal(a1["moe_aux"], a2["moe_aux"])


def test_expert_shard_cuts_the_experts_axis():
    cfg = _cfg()
    from repro_torch.models import build_model
    params = build_model(cfg, "cpu").init(seed=0)
    for m in range(2):
        cut = bridge.expert_shard(params, 2, m)
        mlp, full = cut["layers"]["mlp"], params["layers"]["mlp"]
        assert mlp["router"] is full["router"]
        for k in WEIGHTS[1:]:
            assert torch.equal(mlp[k], full[k][:, 2 * m:2 * m + 2])
        assert all(cut["embed"][k] is v for k, v in params["embed"].items())
    with pytest.raises(ValueError, match="do not split"):
        bridge.expert_shard(params, 3, 0)
