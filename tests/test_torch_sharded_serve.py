"""The sharded serving programs (`launch/dryrun.py::build_prefill_program`,
`build_decode_program`) against the reference's own.

Each case runs a reduced config (2 layers, f32 compute, the bf16 serving
params of `serve_param_specs`, cast from the port's seed-0 params) on B
prompts of S = 16 tokens from numpy seed 0 (a vlm's 6 frontend positions
first), then 3 decode steps of numpy tokens:

  * the port: 4 gloo ranks on the CPU (`launch/mesh.py::spawn`, one spawn
    running every case in turn, one torch thread each), each rank its
    block of the params (`ServeProgram.shard_params`), its rows of the
    batch and its block of the cache;
  * the reference: one subprocess with 4 forced host devices, its
    programs jitted on a `jax.sharding.Mesh`, the params, batch and cache
    placed by `Resolver.tree_shardings` (as
    `tests/test_torch_sharded_program.py` runs it).

Prefill is held on its own outputs: the last position's logits and the
cache, gathered over the ranks (`gather_logits`, `gather_cache`). Decode
starts on both sides from the same numpy cache: the port's one-process
prefill's, padded by the 3 rows the steps write. Both within MAX_TOL of
each row's (logits) or leaf's (cache) max |value|; the cache, bf16, also
one bf16 ulp of the element. The `bf16` case runs bf16 compute on both
sides, held with the card's bound (`chip_smoke.py` phase tp_serve). Each
case states its collectives per prefill and per decode step by label, as
the code places them; each rank's params and cache bytes equal
`dryrun.plan_ranks`; the cache leaves' specs equal the reference
Resolver's. On a mesh of one rank the programs are bitwise
`Model.prefill` / `Model.decode_step`.

The JAX subprocess starts first and runs while the port's ranks run. This
module imports no JAX: the spawned ranks import it and start light."""
import dataclasses
import json
import math
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
from repro_torch.configs import (SHAPES, MeshConfig, get_config,
                                 reduce_for_smoke)
from repro_torch.core import hostsync
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.sharding import Axis, Resolver, ShardingRules

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TEST_TIMEOUT_S = 300
RANK_TIMEOUT_S = 240
JAX_TIMEOUT_S = 240
S, STEPS, VOCAB = 16, 3, 256
MAX_TOL = 1e-4           # of each row's or leaf's max |value|
BF16_RTOL = 2.0 ** -7    # one bf16 ulp is at most 2^-7 of the value
CARD_TOL = 3e-2          # bf16 compute: of each row's max |logit|


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


def case(name, arch="qwen2-0.5b", mesh=(2, 2), sp=True, B=4, vocab=VOCAB,
         prefill=None, decode=None, **over):
    """A case on (data, model) = `mesh`; `prefill` and `decode`: the
    collectives of one prefill and one decode step by label, as the code
    places them; `over` the config's overrides."""
    return dict(name=name, arch=arch, mesh=list(mesh), sp=sp, B=B,
                vocab=vocab, prefill=prefill or {}, decode=decode or {},
                over=over)


# The collectives, at L = 2 layers. Prefill: with a data axis the FSDP
# gathers (one bucket a layer, two for MoE: its experts keep their stored
# bf16; the lookup, the head and the final norm); the embedding's vocab
# sum (SP: its reduce-scatter; vlm: the sum, then the split); per layer
# the attention's and the MLP's entry and exit (SP: a gather and a
# reduce-scatter each, else the exit's sum), MoE's SP gather and its EP
# exchanges (dispatch, combine, the token gather, the two means), the
# batch_dm and KV < TP weight gathers (7 and 4 leaves from their head dim
# blocks) and batch_dm's row gather at the exit; SP's gather of the last
# position; `tp_cache`, the k/v into the cache's layout. Decode (no SP):
# the FSDP gathers, the lookup's sum, per layer the attention's and the
# MLP's exit sums; by head dims also the q/k gather for RoPE (`tp_rope`)
# and the partial scores' sum (`tp_scores`), and where wo is stored by
# heads the output's gather; group-local MoE gathers its 3 expert leaves.
CASES = [
    case("sp_on",
         prefill={"fsdp_gather": 5, "tp_gather": 5, "tp_scatter": 5},
         decode={"fsdp_gather": 5, "tp_reduce": 5}),
    case("sp_off", sp=False,
         prefill={"fsdp_gather": 5, "tp_reduce": 5},
         decode={"fsdp_gather": 5, "tp_reduce": 5}),
    # 6 heads at model 4: batch_dm prefill, head-dim decode, wq/wo by dims
    case("dm_model_4", mesh=(1, 4), num_heads=6,
         prefill={"tp_gather": 21, "tp_scatter": 3, "tp_cache": 1},
         decode={"tp_reduce": 5, "tp_rope": 2, "tp_scores": 2}),
    # 2 kv heads at model 4 under the heads: wq/wo by heads
    case("kv_2_model_4", mesh=(1, 4),
         prefill={"tp_gather": 13, "tp_scatter": 5, "tp_cache": 1},
         decode={"tp_reduce": 5, "tp_rope": 2, "tp_scores": 2,
                 "tp_gather": 2}),
    case("untied_gelu", arch="starcoder2-7b",
         prefill={"fsdp_gather": 5, "tp_gather": 5, "tp_scatter": 5},
         decode={"fsdp_gather": 5, "tp_reduce": 5}),
    # MoE: B = 4 decodes 2 rows per data shard, which split over the 2
    # model ranks (EP); B = 2 decodes 1 (each data shard one group)
    case("moe_ep", arch="phi3.5-moe-42b-a6.6b",
         prefill={"fsdp_gather": 7, "tp_gather": 5, "tp_scatter": 3,
                  "ep_dispatch": 2, "ep_combine": 2, "ep_gather": 2,
                  "ep_stats": 4},
         decode={"fsdp_gather": 7, "tp_reduce": 3, "ep_dispatch": 2,
                 "ep_combine": 2, "ep_gather": 2, "ep_stats": 4}),
    case("moe_local", arch="phi3.5-moe-42b-a6.6b", B=2,
         prefill={"fsdp_gather": 7, "tp_gather": 5, "tp_scatter": 3,
                  "ep_dispatch": 2, "ep_combine": 2, "ep_gather": 2,
                  "ep_stats": 4},
         decode={"fsdp_gather": 7, "tp_reduce": 3, "tp_gather": 6}),
    case("vlm", arch="internvl2-2b",
         prefill={"fsdp_gather": 5, "tp_reduce": 1, "tp_gather": 5,
                  "tp_scatter": 4},
         decode={"fsdp_gather": 5, "tp_reduce": 5}),
    # a vocab that does not divide: the lookup and head whole
    case("vlm_vocab_257", arch="internvl2-2b", vocab=257,
         prefill={"fsdp_gather": 5, "tp_gather": 5, "tp_scatter": 4},
         decode={"fsdp_gather": 5, "tp_reduce": 4}),
    # bf16 compute, as the card runs it
    case("bf16", dtype="bfloat16",
         prefill={"fsdp_gather": 5, "tp_gather": 5, "tp_scatter": 5},
         decode={"fsdp_gather": 5, "tp_reduce": 5}),
]
LENGTHS_CASE = "sp_on"    # its ranks also prefill right-padded prompts


def case_cfg(c):
    return dataclasses.replace(reduce_for_smoke(get_config(c["arch"])),
                               vocab_size=c["vocab"], **c["over"])


def prompt_len(cfg) -> int:
    """The prefill's positions: the prompt, a vlm's frontend first."""
    return S + (cfg.frontend_seq if cfg.family == "vlm" else 0)


def shapes(c):
    """(the prefill's ShapeSpec, the decode's, of T = prompt + STEPS)."""
    cfg = case_cfg(c)
    pre = dataclasses.replace(SHAPES[0], kind="prefill", seq_len=S,
                              global_batch=c["B"])
    dec = dataclasses.replace(SHAPES[0], kind="decode",
                              seq_len=prompt_len(cfg) + STEPS,
                              global_batch=c["B"])
    return pre, dec


def rules(c, decode: bool = False):
    return ShardingRules(data_axes=("data",),
                         sequence_parallel=c["sp"] and not decode)


def sizes(c):
    return dict(zip(("data", "model"), c["mesh"]))


def inputs(c):
    """The case's numpy inputs: the prompts (and a vlm's frontend
    embeddings, 0.1 N(0, 1)), right-padded lengths, the decode tokens."""
    cfg = case_cfg(c)
    rng = np.random.default_rng(0)
    B = c["B"]
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "lengths": np.array([S - 3 * (b % 3) for b in range(B)], np.int32),
           "steps": rng.integers(0, cfg.vocab_size, (STEPS, B)).astype(
               np.int32)}
    if cfg.frontend:
        out["frontend_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.frontend_seq, cfg.frontend_dim))).astype(np.float32)
    return out


def torch_batch(cfg, x, keys=("tokens", "frontend_embeds")):
    dt = getattr(torch, cfg.dtype)
    return {k: (torch.from_numpy(x[k]).to(dt) if k == "frontend_embeds"
                else torch.from_numpy(x[k].astype(np.int64)))
            for k in keys if k in x}


def one_process(c, lengths: bool = False):
    """The port's unsharded prefill of case c (bf16 params at the config's
    compute): (logits, cache)."""
    from repro_torch.models import build_model
    cfg = case_cfg(c)
    model = build_model(cfg, "cpu")
    params = dryrun._half_params(model.init(seed=0))
    keys = ("tokens", "frontend_embeds", "lengths") if lengths else \
        ("tokens", "frontend_embeds")
    with torch.no_grad():
        return model.prefill(params, torch_batch(cfg, inputs(c), keys),
                             prompt_len(cfg))


def start_cache(c):
    """The decode's starting cache (numpy f32, bf16 values): the port's
    one-process prefill cache padded by STEPS zero rows."""
    _, cache = one_process(c)
    pad = ((0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0))
    return {f"['{k}']": np.pad(v.float().numpy(), pad)
            for k, v in cache.items()}


def write_inputs(cases, root):
    from repro_torch.models import build_model
    for c in cases:
        params = build_model(case_cfg(c), "cpu").init(seed=0)
        np.savez(os.path.join(root, f"init_{c['name']}.npz"),
                 **{p: t.numpy() for p, t in tu.flatten_with_path(params)})
        np.savez(os.path.join(root, f"in_{c['name']}.npz"), **inputs(c))
        np.savez(os.path.join(root, f"cache_{c['name']}.npz"),
                 **start_cache(c))


# ---------------------------------------------------------------------------
# The port: every case on 4 gloo ranks
# ---------------------------------------------------------------------------

def _np(t):
    return t.float().numpy()


def run_case(rank, c, root):
    """This rank's run of case c (None outside its mesh): the prefill's
    logits and cache blocks, each decode step's logits block and the last
    step's cache block, the collectives of the prefill and of each step,
    the bytes of the params and of the cache the rank holds."""
    n = int(np.prod(c["mesh"]))
    mesh = tmesh.make_process_mesh(MeshConfig(
        shape=tuple(c["mesh"]), axis_names=("data", "model")),
        ranks=list(range(n)))
    if mesh is None:
        return None
    from repro_torch.models import build_model
    cfg = case_cfg(c)
    pre_shape, dec_shape = shapes(c)
    T = prompt_len(cfg) + STEPS
    pre, _ = dryrun.build_prefill_program(cfg, pre_shape, mesh,
                                          Resolver(mesh, rules(c)),
                                          device="cpu", max_len=T)
    dec, _ = dryrun.build_decode_program(cfg, dec_shape, mesh,
                                         Resolver(mesh, rules(c, True)),
                                         device="cpu")
    params = pre.shard_params(build_model(cfg, "cpu").init(seed=0))
    x = dict(np.load(os.path.join(root, f"in_{c['name']}.npz")))
    batch = pre.shard_batch(torch_batch(cfg, x))
    out = {"coords": {"data": mesh.data, "model": mesh.model},
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in tu.leaves(params))}
    with hostsync.count_transfers() as st:
        logits, cache = pre(params, batch)
    out["prefill"] = {"logits": _np(logits),
                      "cache": tu.tree_map(_np, cache),
                      "collectives": dict(st.collectives)}
    out["cache_bytes"] = sum(t.numel() * t.element_size()
                             for t in tu.leaves(cache))
    if c["name"] == LENGTHS_CASE:
        b = pre.shard_batch(torch_batch(cfg, x, ("tokens", "lengths")))
        out["lengths_logits"] = _np(pre(params, b)[0])
    start = dict(np.load(os.path.join(root, f"cache_{c['name']}.npz")))
    cache = dec.shard_cache({k.strip("[]'"): torch.from_numpy(v).to(
        torch.bfloat16) for k, v in start.items()})
    cache = tu.tree_map(lambda t: t.contiguous(), cache)
    steps, colls = [], []
    for i in range(STEPS):
        tok = dec.shard_batch({"t": torch.from_numpy(
            x["steps"][i].astype(np.int64))})["t"]
        with hostsync.count_transfers() as st:
            logits, cache = dec(params, cache, tok, prompt_len(cfg) + i)
        steps.append(_np(logits))
        colls.append(dict(st.collectives))
    out["decode"] = {"logits": steps, "cache": tu.tree_map(_np, cache),
                     "collectives": colls}
    return out


def serve_rank(rank, cases, root):
    torch.set_num_threads(1)
    return [run_case(rank, c, root) for c in cases]


def run_port(cases, root):
    reps = tmesh.spawn(serve_rank, 4, cases, root, threads=1,
                       timeout_s=RANK_TIMEOUT_S)
    return {c["name"]: [r[i] for r in reps if r[i] is not None]
            for i, c in enumerate(cases)}


# ---------------------------------------------------------------------------
# The reference: one subprocess for the module's cases
# ---------------------------------------------------------------------------

JAX_SCRIPT = r"""
import dataclasses, json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import SHAPES, get_config, reduce_for_smoke
from repro.launch import dryrun
from repro.launch import input_specs as ispec
from repro.sharding import Resolver, ShardingRules

args = json.loads(sys.argv[1])
root, S, STEPS = args["root"], args["S"], args["steps"]
def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]
def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}
out = {}
for c in args["cases"]:
    cfg = dataclasses.replace(reduce_for_smoke(get_config(c["arch"])),
                              vocab_size=c["vocab"], **c["over"])
    B = c["B"]
    P = cfg.frontend_seq if cfg.family == "vlm" else 0
    n = int(np.prod(c["mesh"]))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(c["mesh"]),
                             ("data", "model"))
    init = dict(np.load(os.path.join(root, f"init_{c['name']}.npz")))
    x = dict(np.load(os.path.join(root, f"in_{c['name']}.npz")))
    start = dict(np.load(os.path.join(root, f"cache_{c['name']}.npz")))
    rec = {}
    with mesh:
        res = Resolver(mesh, ShardingRules(data_axes=("data",),
                                           sequence_parallel=c["sp"]))
        shape = dataclasses.replace(SHAPES[0], kind="prefill", seq_len=S,
                                    global_batch=B)
        fn, (pspecs, bspecs) = dryrun.build_prefill_program(cfg, shape, mesh,
                                                            res)
        _, paxes = ispec.serve_param_specs(cfg)
        _, baxes = ispec.batch_specs(cfg, shape)
        params = jax.tree_util.tree_map_with_path(
            lambda p, s: jnp.asarray(init[jax.tree_util.keystr(p)],
                                     jnp.bfloat16), pspecs)
        batch = {"tokens": x["tokens"]}
        if "frontend_embeds" in bspecs:
            batch["frontend_embeds"] = jnp.asarray(
                x["frontend_embeds"], bspecs["frontend_embeds"].dtype)
        logits, cache = fn(jax.device_put(params, res.tree_shardings(paxes,
                                                                     pspecs)),
                           jax.device_put(batch, res.tree_shardings(baxes,
                                                                    bspecs)))
        np.savez(os.path.join(root, f"jax_prefill_{c['name']}.npz"),
                 logits=np.asarray(logits, np.float32),
                 **{"cache" + k: v for k, v in flat(cache).items()})
        dres = Resolver(mesh, ShardingRules(data_axes=("data",)))
        dshape = dataclasses.replace(SHAPES[0], kind="decode",
                                     seq_len=S + P + STEPS, global_batch=B)
        dfn, (_, cspecs, tspecs, _) = dryrun.build_decode_program(
            cfg, dshape, mesh, dres)
        _, daxes = ispec.decode_specs(cfg, dshape)
        dparams = jax.device_put(params, dres.tree_shardings(paxes, pspecs))
        cache = jax.tree_util.tree_map_with_path(
            lambda p, s: jnp.asarray(start[jax.tree_util.keystr(p)],
                                     jnp.bfloat16), cspecs)
        cache = jax.device_put(cache, dres.tree_shardings(daxes["cache"],
                                                          cspecs))
        steps = []
        for i in range(STEPS):
            tok = jax.device_put(jnp.asarray(x["steps"][i]),
                                 dres.tree_shardings(daxes["tokens"], tspecs))
            logits, cache = dfn(dparams, cache, tok,
                                jnp.asarray(S + P + i, jnp.int32))
            steps.append(np.asarray(logits, np.float32))
        np.savez(os.path.join(root, f"jax_decode_{c['name']}.npz"),
                 logits=np.stack(steps),
                 **{"cache" + k: v for k, v in flat(cache).items()})
        specs = Resolver(mesh, dres.rules).tree_specs(
            daxes["cache"], jax.tree.map(lambda s: tuple(s.shape), cspecs))
        rec["cache_specs"] = {
            jax.tree_util.keystr(p): enc(s) for p, s in
            jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda v:
                isinstance(v, jax.sharding.PartitionSpec))[0]}
    out[c["name"]] = rec
print(json.dumps(out))
"""


def start_jax(cases, root):
    args = dict(root=root, S=S, steps=STEPS, cases=cases)
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
        for part in ("prefill", "decode"):
            z = np.load(os.path.join(root, f"jax_{part}_{c['name']}.npz"))
            rec[c["name"]][part] = {k: z[k] for k in z.files}
    return rec


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as root:
        write_inputs(CASES, root)
        proc = start_jax(CASES, root)
        try:
            port = run_port(CASES, root)
        except BaseException:
            proc.kill()
            raise
        return port, finish_jax(proc, root, CASES)


def _case(name):
    return next(c for c in CASES if c["name"] == name)


def _program(c, kind="prefill"):
    """The case's program on a mesh of one rank, with the case's resolver
    swapped in: its `gather_*` join blocks of the case's mesh."""
    cfg = case_cfg(c)
    pre_shape, dec_shape = shapes(c)
    res = Resolver(sizes(c), rules(c, kind == "decode"))
    one = tmesh.local_mesh(MeshConfig(shape=(1, 1),
                                      axis_names=("data", "model")))
    T = prompt_len(cfg) + STEPS
    prog = (dryrun.build_prefill_program(cfg, pre_shape, one, res,
                                         device="cpu", max_len=T)
            if kind == "prefill" else
            dryrun.build_decode_program(cfg, dec_shape, one, res,
                                        device="cpu"))[0]
    return prog


def gathered_logits(c, blocks):
    prog = _program(c)
    return prog.gather_logits([torch.from_numpy(b) for b in blocks]).numpy()


def gathered_cache(c, blocks):
    prog = _program(c)
    return {k: v.numpy() for k, v in prog.gather_cache(
        [tu.tree_map(torch.from_numpy, b) for b in blocks]).items()}


def row_gap(got, want):
    """The worst row's max |diff| over that row's max |value|."""
    got, want = np.atleast_2d(got), np.atleast_2d(want)
    return float(np.max(np.abs(got - want).max(-1)
                        / np.abs(want).max(-1)))


def check_cache(got, want, tol):
    for k in want:
        w = want[k]
        bound = tol * np.abs(w).max() + (0 if tol > MAX_TOL
                                         else BF16_RTOL * np.abs(w))
        worst = float(np.max(np.abs(got[k] - w) - bound))
        assert worst <= 0.0, (k, worst)


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_prefill_matches_reference(runs, name):
    port, ref = runs
    c = _case(name)
    tol = CARD_TOL if c["over"].get("dtype") == "bfloat16" else MAX_TOL
    reps = port[name]
    want = ref[name]["prefill"]
    got = gathered_logits(c, [r["prefill"]["logits"] for r in reps])
    assert got.shape == want["logits"].shape
    assert row_gap(got, want["logits"]) <= tol
    cache = gathered_cache(c, [r["prefill"]["cache"] for r in reps])
    T = prompt_len(case_cfg(c))
    check_cache({k: v[:, :, :T] for k, v in cache.items()},
                {k: want["cache['" + k + "']"] for k in cache}, tol)
    # the rows the prefill leaves for decode are zero
    assert all(not v[:, :, T:].any() for v in cache.values())


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_decode_matches_reference(runs, name):
    port, ref = runs
    c = _case(name)
    tol = CARD_TOL if c["over"].get("dtype") == "bfloat16" else MAX_TOL
    reps = port[name]
    want = ref[name]["decode"]
    for i in range(STEPS):
        got = gathered_logits(c, [r["decode"]["logits"][i] for r in reps])
        assert row_gap(got, want["logits"][i]) <= tol, i
    cache = gathered_cache(c, [r["decode"]["cache"] for r in reps])
    check_cache(cache, {k: want["cache['" + k + "']"] for k in cache}, tol)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_collectives_as_the_code_implies(runs, name):
    port, _ = runs
    c = _case(name)
    for r in port[name]:
        assert r["prefill"]["collectives"] == c["prefill"], r["coords"]
        for step in r["decode"]["collectives"]:
            assert step == c["decode"], (r["coords"], step)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_held_bytes_equal_plan_ranks(runs, name):
    port, _ = runs
    c = _case(name)
    _, dec_shape = shapes(c)
    plan = dryrun.plan_ranks(case_cfg(c), sizes(c), rules(c, True),
                             shape=dec_shape)
    for r in port[name]:
        rank = plan["ranks"][r["coords"]["data"] * c["mesh"][1]
                             + r["coords"]["model"]]
        assert r["param_bytes"] == rank["serve_param_bytes"]
        assert r["cache_bytes"] == rank["cache_bytes"]


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_cache_specs_equal_reference_and_round_trip(runs, name):
    _, ref = runs
    c = _case(name)
    prog = _program(c, "decode")
    cfg = case_cfg(c)
    _, dec_shape = shapes(c)
    meta, _ = dryrun._cache_meta(cfg, dec_shape)
    got = {p: [list(e) if isinstance(e, tuple) else e for e in s]
           for (p, _), s in zip(tu.flatten_with_path(meta),
                                bridge.spec_leaves(meta, prog.cache_specs))}
    assert got == ref[name]["cache_specs"]
    # shard_cache at every rank's coords, then gather_cache: the whole back
    whole = {k: torch.randn(v.shape) for k, v in meta.items()}
    blocks = []
    for r in range(4):
        prog.mesh = {"data": r // c["mesh"][1], "model": r % c["mesh"][1]}
        blocks.append(prog.shard_cache(whole))
    back = prog.gather_cache(blocks)
    assert all(torch.equal(back[k], whole[k]) for k in whole)


def test_lengths_prefill_on_ranks_equals_one_process(runs):
    """Right-padded prompts (`lengths`) under SP: each row's last real
    position's logits as the one-process prefill gives them."""
    port, _ = runs
    c = _case(LENGTHS_CASE)
    got = gathered_logits(c, [r["lengths_logits"] for r in port[c["name"]]])
    want, _ = one_process(c, lengths=True)
    assert row_gap(got, want.numpy()) <= MAX_TOL


# ---------------------------------------------------------------------------
# The head-dim decode's pieces, and the mesh of one rank
# ---------------------------------------------------------------------------

def test_head_dim_decode_takes_the_whole_heads_scale():
    """decode_attention on a block of the head dim scales the summed
    scores by 1/sqrt of the whole head dim (64 here), not the block's
    (16): on a model axis of one rank it equals the plain decode of the
    same 16 dims scaled as 64 would be."""
    from repro_torch.models import layers as nn
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 1, 4, 16, generator=g)
    kc = torch.randn(2, 8, 2, 16, generator=g)
    vc = torch.randn(2, 8, 2, 16, generator=g)
    one = Axis(None, 1, 0, "tp")
    got = nn.decode_attention(q, kc, vc, 5, axis=one, head_dim=64)
    want = nn.decode_attention(q * (math.sqrt(16) / math.sqrt(64)), kc, vc,
                               5)
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)
    plain = nn.decode_attention(q, kc, vc, 5)
    assert not torch.allclose(got, plain, rtol=1e-3, atol=1e-3)


def test_head_dim_block_of_rope_is_taken_after_the_whole_head():
    """RoPE pairs dim i with i + hd/2: the rank's block of the rotated
    head (what `_attn_decode_hd` keeps) differs from rotating the block
    alone, and equals the block of the whole head's rotation."""
    from repro_torch import sharding as shd
    from repro_torch.models import layers as nn
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 1, 3, 64, generator=g)
    sin, cos = nn.rope_tables(torch.arange(7, 8), 64, 10000.0)
    whole = nn.apply_rope(x, sin, cos)
    for m in range(4):
        axis = Axis(None, 4, m, "tp")
        block = shd._block(whole, 3, axis)
        assert torch.equal(block, whole[..., 16 * m:16 * (m + 1)])
        s16, c16 = nn.rope_tables(torch.arange(7, 8), 16, 10000.0)
        alone = nn.apply_rope(shd._block(x, 3, axis), s16, c16)
        assert not torch.allclose(alone, block, atol=1e-3)


@pytest.mark.parametrize("name", ["sp_on", "moe_ep", "vlm"])
def test_mesh_of_one_bitwise_unsharded(name):
    from repro_torch.models import build_model
    c = _case(name)
    cfg = case_cfg(c)
    one = tmesh.local_mesh(MeshConfig(shape=(1, 1),
                                      axis_names=("data", "model")))
    pre_shape, dec_shape = shapes(c)
    T = prompt_len(cfg) + STEPS
    pre, _ = dryrun.build_prefill_program(cfg, pre_shape, one,
                                          Resolver(one), device="cpu",
                                          max_len=T)
    dec, _ = dryrun.build_decode_program(cfg, dec_shape, one, Resolver(one),
                                         device="cpu")
    model = build_model(cfg, "cpu")
    full = model.init(seed=0)
    params = pre.shard_params(full)
    half = dryrun._half_params(full)
    x = inputs(c)
    batch = torch_batch(cfg, x)
    got, gcache = pre(params, pre.shard_batch(batch))
    with torch.no_grad():
        want, wcache = model.prefill(half, batch, T)
    assert torch.equal(got, want)
    for i in range(STEPS):
        tok = torch.from_numpy(x["steps"][i].astype(np.int64))
        got, gcache = dec(params, gcache, tok, prompt_len(cfg) + i)
        with torch.no_grad():
            want, wcache = model.decode_step(half, wcache, tok,
                                             prompt_len(cfg) + i)
        assert torch.equal(got, want)
    assert all(torch.equal(gcache[k], wcache[k]) for k in wcache)


# ---------------------------------------------------------------------------
# run_cell with a mesh of ranks for the serving shapes
# ---------------------------------------------------------------------------

def test_run_cell_decode_32k_plans_the_cache():
    cell = dryrun.run_cell("qwen2-0.5b", "decode_32k",
                           mesh={"data": 2, "model": 2})
    assert cell["status"] == "ok"
    assert cell["whole"]["cache_bytes"] == 51_539_607_552
    assert all(r["cache_bytes"] == 12_884_901_888 for r in cell["ranks"])
    assert len(cell["ranks"]) == 4
    # every leaf of the bf16 params split over the 4 ranks but the biases'
    # and norms' data-only cuts: a quarter of the whole, to within them
    whole = cell["whole"]["serve_param_bytes"]
    assert whole == 2 * 494_032_768
    rank = cell["ranks"][0]["serve_param_bytes"]
    assert abs(rank - whole / 4) < 0.001 * whole


def test_run_cell_prefill_fallbacks_name_the_vocab():
    """internvl2-2b's vocab (92,553) does not split over 2 model ranks: the
    plan's fallback report names it (a prefill of 4 x 256 tokens, for
    time: the plan of the report does not depend on the length)."""
    cfg = get_config("internvl2-2b")
    shape = dataclasses.replace(SHAPES[0], name="prefill_256",
                                kind="prefill", seq_len=256, global_batch=4)
    cell = dryrun.run_cell("internvl2-2b", shape,
                           mesh={"data": 2, "model": 2})
    assert cell["status"] == "ok"
    lost = {(f["tensor"], f["logical"]) for f in cell["sharding_fallbacks"]}
    assert ("['embed']['tok']", "vocab") in lost
    assert ("['embed']['head']", "vocab") in lost
    assert cfg.vocab_size % 2 == 1
    # the prefill's cache: the prompt and the 256 patches, whole and a
    # quarter per rank (batch over data, kv heads over model)
    T = 256 + cfg.frontend_seq
    whole = 2 * cfg.num_layers * 4 * T * cfg.num_kv_heads * cfg.head_dim * 2
    assert cell["whole"]["cache_bytes"] == whole
    assert all(r["cache_bytes"] == whole // 4 for r in cell["ranks"])


def test_run_cell_one_card_output_unchanged():
    cell = dryrun.run_cell("qwen2-0.5b", "decode_32k")
    assert "ranks" not in cell and "mesh" not in cell and "whole" not in cell
    assert set(cell["memory"]) == {
        "peak_model", "serve_param_bytes", "cache_bytes_per_seq",
        "cache_bytes", "batch", "peak_bytes", "fits_80GB", "max_batch"}
    assert cell["memory"]["cache_bytes"] == 51_539_607_552
