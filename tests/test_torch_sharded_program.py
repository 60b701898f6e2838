"""The sharded training program (`launch/dryrun.py::build_train_program`)
against the reference's own `build_train_program`.

Each case runs a reduced config (2 layers, the vocab 256 so that it
divides by 4, f32) for two steps of AdamW (warmup 1) on B = 4 x 16
tokens from numpy seed 0, from the port's seed-0 state:

  * the port: gloo ranks on the CPU (`launch/mesh.py::spawn`, one spawn of
    4 ranks running every case of a module in turn, one torch thread
    each), each rank its block of the state (`TrainProgram.shard_state`)
    and its rows of the batch (`shard_batch`);
  * the reference: one subprocess with forced host devices, its
    `build_train_program` jitted on a `jax.sharding.Mesh`, the state placed
    by `Resolver.tree_shardings` (as `tests/test_multidevice.py` runs JAX).

Checks: both steps' losses within rtol 1e-5; after step 0 the gathered
AdamW moment m (= 0.1 x the clipped grads) within 1e-4 of each leaf's max
|value| plus one bf16 ulp of each element (BF16_RTOL): both programs
differentiate the bf16 half params (`_half_params`), so their grads are
bf16, and an element whose f32 sums differ in the last bits rounds to the
neighbouring bf16 value; the updated params within 1e-4 of each leaf's
max plus what that moves AdamW's first step (`adamw_step0_bound`).
`sedar`: eq on every rank at every step, a port-side grads fault flips eq
on every rank and nothing commits, fp_all per pod. The `bf16_*` cases
run the config at bf16 compute, as the card does, on both sides, held
with the card's bounds (losses within 5e-3 relative, m within 4e-2 of
each leaf's max |value|); there the port's sharded program also sits
closer to its own run on one rank than the reference's sharded program
sits to its own on one device.
The collective counts per step by label equal the case's (`CASES`), the
per-rank state bytes `run_cell`'s plan.
On a mesh of one rank the program is bitwise `Model.loss` +
`Optimizer.apply` on the whole state.

The JAX subprocess starts first and runs while the port's ranks run.
This module imports no JAX: the spawned ranks import it and start light.
`tests/test_torch_tp.py` holds the fallback cases and imports the harness
from here."""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch import tree as tu
from repro_torch.configs import (SHAPES, MeshConfig, TrainConfig, get_config,
                                 reduce_for_smoke)
from repro_torch.core import hostsync
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.sharding import Resolver, ShardingRules

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TEST_TIMEOUT_S = 300
RANK_TIMEOUT_S = 240
JAX_TIMEOUT_S = 240
B, S, VOCAB, STEPS = 4, 16, 256, 2
LOSS_RTOL = 1e-5
MAX_TOL = 1e-4          # of each leaf's max |value|
BF16_RTOL = 2.0 ** -7   # one bf16 ulp is at most 2^-7 of the value
# bf16 compute (the `bf16_*` cases): the card's bounds against the
# one-process oracle (`chip_smoke.py` phase tp)
BF16_LOSS_RTOL = 5e-3
BF16_GRAD_GAP = 4e-2    # of each leaf's max |value|
TRAIN = dict(global_batch=B, seq_len=S, warmup_steps=1, steps=10)
FAULT = (0, 5, 20)      # grads leaf 0, element 5, bit 20
FAULT_STEP = 1


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


def case(name, arch="qwen2-0.5b", mesh=(2, 2), names=("data", "model"),
         sp=True, flavor="baseline", micro=1, fault=False,
         data_axes=("data",), collectives=None, **over):
    """A case; `collectives`: one step's collectives by label, as the
    code places them (`CASES`), and `over` the config's overrides."""
    return dict(name=name, arch=arch, mesh=list(mesh), names=list(names),
                sp=sp, flavor=flavor, micro=micro, fault=fault,
                data_axes=list(data_axes), collectives=collectives or {},
                over=over)


def case_cfg(c):
    return dataclasses.replace(reduce_for_smoke(get_config(c["arch"])),
                               vocab_size=VOCAB, **c["over"])


def shape_spec():
    return dataclasses.replace(SHAPES[0], kind="train", seq_len=S,
                               global_batch=B)


def resolver(c, mesh=None):
    mesh = mesh if mesh is not None else dict(zip(c["names"], c["mesh"]))
    return Resolver(mesh, ShardingRules(data_axes=tuple(c["data_axes"]),
                                        sequence_parallel=c["sp"]))


def init_state(cfg):
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    params = build_model(cfg, "cpu").init(seed=0)
    return {"params": params,
            "opt": make_optimizer(TrainConfig(**TRAIN)).init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def global_batch(cfg=None):
    """Tokens and targets from numpy seed 0; for a config with a frontend
    (vlm) also its embeddings, 0.1 N(0, 1) from numpy seed 1."""
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, VOCAB, (B, S)).astype(
        np.int64)) for k in ("tokens", "targets")}
    if cfg is not None and cfg.frontend:
        batch["frontend_embeds"] = torch.from_numpy((0.1 * np.random.default_rng(
            1).standard_normal((B, cfg.frontend_seq, cfg.frontend_dim))
        ).astype(np.float32))
    return batch


def _numpy(tree):
    return tu.tree_map(lambda t: t.detach().cpu().numpy(), tree)


def write_inputs(cases, root):
    """Each case's seed-0 params, by path, as the reference reads them."""
    for c in cases:
        params = init_state(case_cfg(c))["params"]
        np.savez(os.path.join(root, f"init_{c['name']}.npz"),
                 **{p: t.numpy() for p, t in tu.flatten_with_path(params)})
    np.savez(os.path.join(root, "batch.npz"),
             **{k: v.numpy().astype(np.int32)
                for k, v in global_batch().items()})
    fe = global_batch(case_cfg(CASE_VLM))["frontend_embeds"]
    np.savez(os.path.join(root, "frontend.npz"), frontend_embeds=fe.numpy())


# ---------------------------------------------------------------------------
# The port: every case on 4 gloo ranks
# ---------------------------------------------------------------------------

def run_case(rank, c, fault_rank=None):
    """This rank's run of case `c` (None outside its mesh): the losses and
    verdicts of STEPS steps, the state block after step 0, the
    collectives of each step and the state's bytes; with `fault_rank`
    (sedar) a second run whose step FAULT_STEP flips FAULT on that rank:
    its verdicts and the steps each rank committed."""
    n = int(np.prod(c["mesh"]))
    mesh = tmesh.make_process_mesh(MeshConfig(
        shape=tuple(c["mesh"]), axis_names=tuple(c["names"])),
        ranks=list(range(n)))
    if mesh is None:
        return None
    cfg = case_cfg(c)
    prog, _ = dryrun.build_train_program(
        cfg, shape_spec(), mesh, resolver(c, mesh), c["flavor"],
        TrainConfig(**TRAIN), c["micro"], device="cpu")
    start = prog.shard_state(init_state(cfg))
    batch = prog.shard_batch(global_batch(cfg))
    out = {"coords": bridge.mesh_coords(mesh), "losses": [], "eq": [],
           "collectives": [], "bytes": [],
           "state_bytes": sum(t.numel() * t.element_size()
                              for t in tu.leaves(start))}
    state = start
    for s in range(STEPS):
        with hostsync.count_transfers(cross_thread=True) as st:
            state, aux = prog(state, batch)
        out["collectives"].append(dict(st.collectives))
        out["bytes"].append(sum(st.collective_bytes.values()))
        if isinstance(aux, tuple):
            loss, eq, fp_all = aux
            out["eq"].append(bool(eq))
            out["fp_all"] = fp_all.numpy()
        else:
            loss = aux
        out["losses"].append(float(loss))
        if s == 0:
            out["params"] = _numpy(state["params"])
            out["m"] = _numpy(state["opt"]["m"])
    if fault_rank is not None:
        state, eqs, committed = start, [], []
        for s in range(STEPS + 1):
            fault = FAULT if (s == FAULT_STEP and rank == fault_rank
                              and len(eqs) == s) else None
            cand, (loss, eq, _) = prog(state, batch, fault=fault)
            eqs.append(bool(eq))
            if bool(eq):          # the runtime's gate: commit only on eq
                state = cand
            committed.append(int(state["step"]))
        out["fault_eq"], out["fault_committed"] = eqs, committed
    return out


def program_rank(rank, cases, fault_rank):
    torch.set_num_threads(1)
    return [run_case(rank, c, fault_rank if c["fault"] else None)
            for c in cases]


def run_port(cases, fault_rank=None):
    reps = tmesh.spawn(program_rank, 4, cases, fault_rank, threads=1,
                       timeout_s=RANK_TIMEOUT_S)
    return {c["name"]: [r[i] for r in reps if r[i] is not None]
            for i, c in enumerate(cases)}


def gathered(c, reps, key):
    """The whole tree of `key` from the ranks' blocks."""
    return bridge.gather_params(
        [tu.tree_map(torch.from_numpy, r[key]) for r in reps],
        resolver(c), case_cfg(c))


# ---------------------------------------------------------------------------
# The reference: one subprocess for a module's cases
# ---------------------------------------------------------------------------

JAX_SCRIPT = r"""
import dataclasses, json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import SHAPES, get_config, reduce_for_smoke
from repro.configs.base import TrainConfig
from repro.launch import dryrun
from repro.launch import input_specs as ispec
from repro.models import build_model
from repro.optim import make_optimizer
from repro.sharding import Resolver, ShardingRules

args = json.loads(sys.argv[1])
root = args["root"]
B, S = args["B"], args["S"]
batch_np = dict(np.load(os.path.join(root, "batch.npz")))
def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]
out = {}
for c in args["cases"]:
    cfg = dataclasses.replace(reduce_for_smoke(get_config(c["arch"])),
                              vocab_size=args["vocab"], **c["over"])
    shape = dataclasses.replace(SHAPES[0], kind="train", seq_len=S,
                                global_batch=B)
    tc = TrainConfig(**args["train"])
    n = int(np.prod(c["mesh"]))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(c["mesh"]),
                             tuple(c["names"]))
    res = Resolver(mesh, ShardingRules(data_axes=tuple(c["data_axes"]),
                                       sequence_parallel=c["sp"]))
    init = dict(np.load(os.path.join(root, f"init_{c['name']}.npz")))
    with mesh:
        fn, (sspec, bspec) = dryrun.build_train_program(
            cfg, shape, mesh, res, c["flavor"], tc, c["micro"])
        shapes, _ = build_model(cfg).abstract_params()
        params = jax.tree_util.tree_map_with_path(
            lambda p, s: jnp.asarray(init[jax.tree_util.keystr(p)]), shapes)
        state = {"params": params, "opt": make_optimizer(tc).init(params),
                 "step": jnp.zeros((), jnp.int32)}
        _, saxes = ispec.train_state_specs(cfg)
        _, baxes = ispec.batch_specs(cfg, shape)
        specs = Resolver(mesh, res.rules).tree_specs(
            saxes["params"], jax.tree.map(lambda s: tuple(s.shape), shapes))
        state = jax.device_put(state, res.tree_shardings(saxes, sspec))
        b = dict(batch_np)
        if "frontend_embeds" in bspec:
            b["frontend_embeds"] = np.load(os.path.join(
                root, "frontend.npz"))["frontend_embeds"].astype(
                    bspec["frontend_embeds"].dtype)
        batch = jax.device_put(b, res.tree_shardings(baxes, bspec))
        rec = {"losses": [], "eq": [],
               "specs": {jax.tree_util.keystr(p): enc(s) for p, s in
                         jax.tree_util.tree_flatten_with_path(
                             specs, is_leaf=lambda x: isinstance(
                                 x, jax.sharding.PartitionSpec))[0]}}
        for step in range(args["steps"]):
            state, aux = fn(state, batch)
            if isinstance(aux, tuple):
                loss, eq, _ = aux
                rec["eq"].append(bool(eq))
            else:
                loss = aux
            rec["losses"].append(float(loss))
            if step == 0:
                flat = {}
                for k in ("params", "m"):
                    tree = state["params"] if k == "params" \
                        else state["opt"]["m"]
                    for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
                        flat[k + jax.tree_util.keystr(p)] = np.asarray(a)
                np.savez(os.path.join(root, f"jax_{c['name']}.npz"), **flat)
    out[c["name"]] = rec
print(json.dumps(out))
"""


def start_jax(cases, root):
    args = dict(root=root, B=B, S=S, vocab=VOCAB, train=TRAIN, steps=STEPS,
                cases=cases)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return subprocess.Popen([sys.executable, "-c", JAX_SCRIPT,
                             json.dumps(args)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_jax(proc, root, cases):
    try:
        out, err = proc.communicate(timeout=JAX_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-3000:]
    rec = json.loads(out.strip().splitlines()[-1])
    for c in cases:
        z = np.load(os.path.join(root, f"jax_{c['name']}.npz"))
        rec[c["name"]]["trees"] = {k: z[k] for k in z.files}
    return rec


def run_both(cases, fault_rank=None):
    """(the port's per-rank results, the reference's) for `cases`."""
    with tempfile.TemporaryDirectory() as root:
        write_inputs(cases, root)
        proc = start_jax(cases, root)
        try:
            port = run_port(cases, fault_rank)
        except BaseException:
            proc.kill()
            raise
        return port, finish_jax(proc, root, cases)


def grads_bound(want, micro: int = 1, parts: bool = False,
                bf16: bool = False):
    """The grads' (or m's) tolerance, elementwise: MAX_TOL of the leaf's
    max |value| plus one bf16 ulp (BF16_RTOL) of the element, or of the
    leaf's max |value| where the grad is a sum of terms rounded to bf16
    on their own, which may be larger than the sum: each microbatch's
    (`micro` > 1), or each rank's (`parts`: the MoE router and experts,
    whose grads the reference's shard_map body rounds to bf16 on every
    device before its psum). With `bf16` compute, BF16_GRAD_GAP of the
    leaf's max."""
    a = np.abs(want)
    if bf16:
        return np.full_like(a, BF16_GRAD_GAP * a.max())
    return MAX_TOL * a.max() + BF16_RTOL * (
        a.max() if micro > 1 or parts else a)


def adamw_step0_bound(m_want, p_want, micro: int = 1, parts: bool = False,
                      bf16: bool = False):
    """The updated params' tolerance after AdamW's first step: MAX_TOL of
    the leaf's max |value| plus lr times the most that the step's
    direction g / (|g| + eps) moves when the clipped grads g (m / (1 -
    beta1)) move within their tolerance (`grads_bound`): near |g| ~ eps
    it turns fast, and a grad that is zero within the tolerance may step
    either way."""
    tc = TrainConfig(**TRAIN)
    g = m_want.astype(np.float64) / (1.0 - tc.beta1)
    dg = grads_bound(m_want, micro, parts, bf16).astype(np.float64) / (
        1.0 - tc.beta1)

    def u(x):
        return x / (np.abs(x) + tc.eps)
    du = np.maximum(np.abs(u(g + dg) - u(g)), np.abs(u(g) - u(g - dg)))
    return MAX_TOL * np.abs(p_want).max() + tc.lr * du


def check_against_reference(c, reps, ref):
    """The losses, the gathered m and params after step 0 and the verdicts
    of case `c` against the reference's run."""
    bf16 = c["over"].get("dtype") == "bfloat16"
    for r in reps:
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=BF16_LOSS_RTOL if bf16 else LOSS_RTOL,
                                   atol=0)
        assert r["eq"] == ref["eq"]
    m, p = gathered(c, reps, "m"), gathered(c, reps, "params")
    for (path, got_m), (_, got_p) in zip(tu.flatten_with_path(m),
                                         tu.flatten_with_path(p)):
        m_want, p_want = ref["trees"]["m" + path], ref["trees"]["params" + path]
        parts = c["arch"].startswith("phi3.5-moe") and "['mlp']" in path
        for key, got, want, bound in (
                ("m", got_m, m_want,
                 grads_bound(m_want, c["micro"], parts, bf16)),
                ("params", got_p, p_want,
                 adamw_step0_bound(m_want, p_want, c["micro"], parts,
                                   bf16))):
            got = got.numpy()
            assert got.shape == want.shape, (key, path)
            worst = float(np.max(np.abs(got - want) - bound))
            assert worst <= 0.0, (key, path, worst)


# ---------------------------------------------------------------------------
# The cases of this module
# ---------------------------------------------------------------------------

# One step's collectives by label, as the code places them, at L = 2
# layers: per layer and microbatch one FSDP bucket gathered (again in each
# remat rerun: `full` reruns a group of 2 and then each layer) and
# reduce-scattered, and one data sum of the leaves that the data axis
# leaves whole (the biases, fsdp_reduce); on the model axis each block's
# entry and exit (SP: a gather and a reduce-scatter forward, the reverse
# backward, 4 + 4 a layer; else a sum each way) and under SP the two
# norms' grad sums. Per microbatch the lookup's, the head's and the final
# norm's gathers, the embedding's and the head's model-axis exchanges, the
# final norm's sum under SP and 2 vocab_stats (one CE chunk); per step the
# loss mean over the data ranks, one clip-norm sum per axis of more than
# one rank, and under sedar the pod compare and the verdict.
CASES = [
    case("sp_on", collectives={
        "fsdp_gather": 5, "fsdp_scatter": 5, "fsdp_reduce": 2,
        "tp_gather": 10, "tp_scatter": 10, "tp_reduce": 5,
        "vocab_stats": 2, "loss_mean": 1, "grad_norm": 2}),
    case("sp_off_micro2", sp=False, micro=2, collectives={
        "fsdp_gather": 10, "fsdp_scatter": 10, "fsdp_reduce": 4,
        "tp_reduce": 20, "vocab_stats": 4, "loss_mean": 1,
        "grad_norm": 2}),
    case("sedar", mesh=(2, 1, 2), names=("pod", "data", "model"),
         flavor="sedar", fault=True, collectives={
             "tp_gather": 10, "tp_scatter": 10, "tp_reduce": 5,
             "vocab_stats": 2, "grad_norm": 1, "fp_gather": 1,
             "verdict": 1}),
    case("remat_full", remat="full", collectives={
        "fsdp_gather": 9, "fsdp_scatter": 5, "fsdp_reduce": 2,
        "tp_gather": 18, "tp_scatter": 18, "tp_reduce": 5,
        "vocab_stats": 2, "loss_mean": 1, "grad_norm": 2}),
    # bf16 compute, as the card runs it
    case("bf16_sp_on", dtype="bfloat16", collectives={
        "fsdp_gather": 5, "fsdp_scatter": 5, "fsdp_reduce": 2,
        "tp_gather": 10, "tp_scatter": 10, "tp_reduce": 5,
        "vocab_stats": 2, "loss_mean": 1, "grad_norm": 2}),
    case("bf16_sedar", mesh=(2, 1, 2), names=("pod", "data", "model"),
         flavor="sedar", dtype="bfloat16", collectives={
             "tp_gather": 10, "tp_scatter": 10, "tp_reduce": 5,
             "vocab_stats": 2, "grad_norm": 1, "fp_gather": 1,
             "verdict": 1}),
    # vlm: the frontend's 6 positions before the 16 tokens, joined to the
    # residual stream after the lookup's sum (tp_reduce, in place of the
    # reduce-scatter) and before the SP split (its backward a tp_gather);
    # the text positions taken after the CE's gather of the whole
    # sequence; no qkv biases, so no fsdp_reduce
    case("vlm", arch="internvl2-2b", collectives={
        "fsdp_gather": 5, "fsdp_scatter": 5, "tp_gather": 10,
        "tp_scatter": 9, "tp_reduce": 6, "vocab_stats": 2, "loss_mean": 1,
        "grad_norm": 2}),
]
CASE_VLM = CASES[-1]
# the bf16 program on a mesh of one rank (one device for the reference)
BF16_ONE = case("bf16_one", mesh=(1, 1), dtype="bfloat16")
# pod 1's rank (data 0, model 1) of the (2, 1, 2) mesh
FAULT_RANK = 3


@pytest.fixture(scope="module")
def runs():
    return run_both(CASES + [BF16_ONE], FAULT_RANK)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_program_matches_reference(runs, name):
    port, ref = runs
    c = next(c for c in CASES if c["name"] == name)
    check_against_reference(c, port[name], ref[name])


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_collectives_per_step_as_the_code_implies(runs, name):
    port, _ = runs
    c = next(c for c in CASES if c["name"] == name)
    want = c["collectives"]
    for r in port[name]:
        for step in r["collectives"]:
            assert step == want, (r["coords"], step, want)
        assert r["bytes"][0] == r["bytes"][1] > 0


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_state_bytes_equal_run_cell_plan(runs, name):
    port, _ = runs
    c = next(c for c in CASES if c["name"] == name)
    plan = dryrun.plan_ranks(case_cfg(c), dict(zip(c["names"], c["mesh"])),
                             resolver(c).rules)
    for r in port[name]:
        rank = plan["ranks"][tmesh_rank(c, r["coords"])]
        assert r["state_bytes"] == rank["state_bytes"]


def tmesh_rank(c, coords):
    sizes = dict(zip(c["names"], c["mesh"]))
    return ((coords["pod"] * sizes.get("data", 1) + coords["data"])
            * sizes.get("model", 1) + coords["model"])


def test_microbatches_2_within_bounds_of_1(runs):
    port, _ = runs
    one, two = port["sp_on"], port["sp_off_micro2"]
    np.testing.assert_allclose(two[0]["losses"], one[0]["losses"],
                               rtol=LOSS_RTOL, atol=0)
    c1 = next(c for c in CASES if c["name"] == "sp_on")
    c2 = next(c for c in CASES if c["name"] == "sp_off_micro2")
    a, b = gathered(c1, one, "m"), gathered(c2, two, "m")
    for (path, x), (_, y) in zip(tu.flatten_with_path(a),
                                 tu.flatten_with_path(b)):
        x, y = x.numpy(), y.numpy()
        assert float(np.max(np.abs(y - x) - grads_bound(x, 2))) <= 0.0, path


@pytest.mark.parametrize("name", ["bf16_sp_on", "bf16_sedar"])
def test_bf16_sharded_tracks_one_rank_closer_than_reference(runs, name):
    """bf16 compute: the port's sharded program sits closer to its own
    program on one rank than the reference's sharded program sits to its
    own on one device (m after step 0, the worst leaf, of each leaf's max
    |value|): the port's partial sums over ranks run in f32 and round
    once, as one product over the whole contraction rounds."""
    port, ref = runs
    c = next(c for c in CASES if c["name"] == name)
    got = gathered(c, port[name], "m")
    one = gathered(BF16_ONE, port["bf16_one"], "m")
    port_gap = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(tu.leaves(got), tu.leaves(one)))
    sharded, single = ref[name]["trees"], ref["bf16_one"]["trees"]
    ref_gap = max(float(np.abs(sharded[k] - single[k]).max()
                        / np.abs(single[k]).max())
                  for k in single if k.startswith("m"))
    assert port_gap < ref_gap, (port_gap, ref_gap)


def test_sedar_clean_eq_on_every_rank(runs):
    port, ref = runs
    for r in port["sedar"]:
        assert r["eq"] == [True] * STEPS
        # per block: each pod's row of this rank's fingerprint lane
        assert r["fp_all"].shape == (2, 1, 4)
        assert (r["fp_all"][0, ..., :2] == r["fp_all"][1, ..., :2]).all()
    assert ref["sedar"]["eq"] == [True] * STEPS


def test_sedar_grads_fault_flagged_on_every_rank_and_not_committed(runs):
    port, _ = runs
    for r in port["sedar"]:
        # step 1 faulty on rank FAULT_RANK only: every rank sees eq False
        # and keeps its state; the retry of step 1 is clean
        assert r["fault_eq"] == [True, False, True], r["coords"]
        assert r["fault_committed"] == [1, 1, 2], r["coords"]


# ---------------------------------------------------------------------------
# The mesh of one rank is the unsharded code
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("micro", [1, 2])
def test_mesh_of_one_bitwise_unsharded(micro):
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    c = case("one", mesh=(1, 1))
    cfg = case_cfg(c)
    mesh = tmesh.local_mesh(MeshConfig(shape=(1, 1),
                                       axis_names=("data", "model")))
    prog, _ = dryrun.build_train_program(
        cfg, shape_spec(), mesh, resolver(c, mesh), "baseline",
        TrainConfig(**TRAIN), micro, device="cpu")
    batch = global_batch()
    state = init_state(cfg)
    new, loss = prog(state, batch)

    model = build_model(cfg, "cpu")
    opt = make_optimizer(TrainConfig(**TRAIN))
    half = tu.tree_map(lambda p: p.to(torch.bfloat16), state["params"])
    leaves = [t.detach().requires_grad_(True) for t in tu.leaves(half)]
    n = B // micro
    acc, losses = None, []
    for i in range(micro):
        mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        l = model.loss(tu.unflatten_like(half, leaves), mb)[0]
        gs = torch.autograd.grad(l, leaves)
        losses.append(l.detach())
        if micro == 1:
            acc = [g.float() for g in gs]
        else:
            acc = [(torch.zeros(g.shape) if acc is None else acc[j])
                   + g.float() / micro for j, g in enumerate(gs)]
    want_loss = losses[0] if micro == 1 else torch.mean(torch.stack(losses))
    p, o = opt.apply(acc, state["opt"], state["params"], state["step"])
    assert torch.equal(loss.view(torch.int32), want_loss.view(torch.int32))
    for a, b in zip(tu.leaves(new["params"]) + tu.leaves(new["opt"]),
                    tu.leaves(p) + tu.leaves(o)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
