"""Tensor, sequence and FSDP parallelism of the layers (`models/
transformer.py::ShardCtx`, the collectives of `sharding.py`, `bridge.
shard_params`/`gather_params`) against the reference, through the training
program (the harness of `tests/test_torch_sharded_program.py`):

  * the baseline flavor on a pod mesh, whose data axes are ("pod",
    "data") (a group over both, `launch/mesh.py::make_axes_group`);
  * the layouts that fall back: heads that do not divide by the model
    ranks (6 heads at model 4: the batch rows over the model ranks, the
    params on head_dim, the reference's `batch_dm`), kv heads fewer than
    the model ranks (2 at model 4: replicated k/v), an untied head with
    the GELU MLP and biases (reduced starcoder2-7b), MoE (reduced
    phi3.5-moe: attention TP with the experts over the model ranks);
  * each param leaf's spec and the fallback records equal to the
    reference Resolver's, and shard_params / gather_params round trips;
  * the collectives as autograd Functions on 4 gloo ranks: forward and
    backward of copy_to, reduce_from, gather (sum and slice), scatter and
    split against their definitions, bitwise equal on every rank, counted
    under their labels with the bytes received;
  * `dryrun.run_cell` with a mesh of ranks: each rank's state bytes equal
    what the program's ranks hold.

This module imports no JAX (the spawned ranks import it)."""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import test_torch_sharded_program as H  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import MeshConfig  # noqa: E402
from repro_torch.core import hostsync  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.sharding import Axis  # noqa: E402

torch.set_num_threads(1)

_time_limit = H._time_limit

# one step's collectives as `H.CASES` counts them, but: where the heads do
# not split (batch_dm) attention's exit gathers the rows (forward; its
# reduce-scatter backward) and each of its 7 leaves is gathered whole from
# its head_dim blocks (its grads reduce-scattered); where KV < TP the 4 k/v
# leaves are gathered whole from their head_dim blocks; starcoder2's GELU
# MLP adds its down bias, whose grad is summed over the model ranks under
# SP; MoE's experts exchange their tokens (ep_*) on the whole sequence
# (SP: a slice gather each way, in place of the MLP's entry and exit) and
# the expert leaves are a second FSDP bucket (bf16, as stored).
CASES = [
    H.case("heads_6_model_4", mesh=(1, 4), num_heads=6, collectives={
        "tp_gather": 24, "tp_scatter": 24, "tp_reduce": 5,
        "vocab_stats": 2, "grad_norm": 1}),
    H.case("kv_2_model_4", mesh=(1, 4), sp=False, collectives={
        "tp_gather": 8, "tp_scatter": 8, "tp_reduce": 10,
        "vocab_stats": 2, "grad_norm": 1}),
    H.case("untied_gelu", arch="starcoder2-7b", collectives={
        "fsdp_gather": 5, "fsdp_scatter": 5, "fsdp_reduce": 2,
        "tp_gather": 10, "tp_scatter": 10, "tp_reduce": 7,
        "vocab_stats": 2, "loss_mean": 1, "grad_norm": 2}),
    H.case("moe", arch="phi3.5-moe-42b-a6.6b", collectives={
        "fsdp_gather": 7, "fsdp_scatter": 7, "tp_gather": 10,
        "tp_scatter": 6, "tp_reduce": 5, "ep_dispatch": 4,
        "ep_combine": 4, "ep_gather": 6, "ep_stats": 4, "vocab_stats": 2,
        "loss_mean": 1, "grad_norm": 2}),
    # baseline on a pod mesh: the batch and FSDP over ("pod", "data")
    H.case("baseline_pods", mesh=(2, 1, 2), names=("pod", "data", "model"),
           data_axes=("pod", "data"), collectives={
               "fsdp_gather": 5, "fsdp_scatter": 5, "fsdp_reduce": 2,
               "tp_gather": 10, "tp_scatter": 10, "tp_reduce": 5,
               "vocab_stats": 2, "loss_mean": 1, "grad_norm": 2}),
]


@pytest.fixture(scope="module")
def runs():
    return H.run_both(CASES)


def _case(name):
    return next(c for c in CASES if c["name"] == name)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_layout_matches_reference(runs, name):
    port, ref = runs
    H.check_against_reference(_case(name), port[name], ref[name])


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_collectives_per_step_as_the_code_implies(runs, name):
    port, _ = runs
    c = _case(name)
    want = c["collectives"]
    for r in port[name]:
        for step in r["collectives"]:
            assert step == want, (r["coords"], step, want)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_param_specs_equal_reference_resolver(runs, name):
    _, ref = runs
    c = _case(name)
    r = H.resolver(c)
    specs = bridge.whole_partition(H.case_cfg(c), r)
    got = {p: [list(e) if isinstance(e, tuple) else e for e in s]
           for p, s in _flat_specs(H.case_cfg(c), specs)}
    assert got == ref[name]["specs"]


def _flat_specs(cfg, specs):
    from repro_torch.launch import input_specs as ispec
    meta = ispec._abstract_params(cfg)[0]
    return zip([p for p, _ in tu.flatten_with_path(meta)],
               bridge.spec_leaves(meta, specs))


def test_fallbacks_recorded(runs):
    """6 heads at model 4 fall back to head_dim on the q/o weights and the
    kv weights (2 kv heads); the kv-heads case records kv_heads only."""
    c = _case("heads_6_model_4")
    r = H.resolver(c)
    bridge.whole_partition(H.case_cfg(c), r)
    lost = {(f["tensor"], f["logical"]) for f in r.fallback_report()}
    assert ("['layers']['attn']['wq']", "heads") in lost
    assert ("['layers']['attn']['wk']", "kv_heads") in lost
    specs = dict(_flat_specs(H.case_cfg(c), bridge.whole_partition(
        H.case_cfg(c), H.resolver(c))))
    assert specs["['layers']['attn']['wq']"] == (None, None, None, "model")
    c = _case("kv_2_model_4")
    r = H.resolver(c)
    specs = dict(_flat_specs(H.case_cfg(c), bridge.whole_partition(
        H.case_cfg(c), r)))
    assert specs["['layers']['attn']['wq']"] == (None, None, "model")
    assert specs["['layers']['attn']['wk']"] == (None, None, None, "model")


@pytest.mark.parametrize("name", ["sp_on", "heads_6_model_4", "moe"])
def test_shard_gather_round_trip(name):
    c = H.case("sp_on") if name == "sp_on" else _case(name)
    cfg = H.case_cfg(c)
    r = H.resolver(c)
    state = H.init_state(cfg)
    sizes = bridge.mesh_sizes(r)
    n = sizes["pod"] * sizes["data"] * sizes["model"]
    blocks = [bridge.shard_state(state, r, bridge.rank_coords(k, sizes), cfg)
              for k in range(n)]
    for key in ("params", "m"):
        shards = [b["params"] if key == "params" else b["opt"]["m"]
                  for b in blocks]
        whole = bridge.gather_params(shards, r, cfg)
        want = state["params"] if key == "params" else state["opt"]["m"]
        for a, b in zip(tu.leaves(whole), tu.leaves(want)):
            assert torch.equal(a, b)
    # each block is 1 / (its spec's blocks) of the leaf
    specs = bridge.whole_partition(cfg, r)
    for (path, t), spec in zip(tu.flatten_with_path(state["params"]),
                               bridge.spec_leaves(state["params"], specs)):
        k = 1
        for e in spec:
            for a in ((e,) if isinstance(e, str) else e or ()):
                k *= sizes[a]
        assert blocks[0]["params"] is not None
        got = dict(tu.flatten_with_path(blocks[-1]["params"]))[path]
        assert got.numel() * k == t.numel(), path


# ---------------------------------------------------------------------------
# The collectives as autograd Functions
# ---------------------------------------------------------------------------

def collectives_rank(rank):
    from repro_torch import sharding as shd
    torch.set_num_threads(1)
    mesh = tmesh.make_process_mesh(MeshConfig(shape=(1, 4),
                                              axis_names=("data", "model")))
    axis = Axis(mesh.model_group, 4, mesh.model, "tp")
    out = {}
    gen = torch.Generator().manual_seed(7)
    xs = [torch.randn((8, 8), generator=gen) for _ in range(4)]
    gs = [torch.randn((8, 8), generator=gen) for _ in range(4)]
    x = xs[rank].clone().requires_grad_(True)
    with hostsync.count_transfers() as st:
        for name, fn, gshape in (
                ("copy_to", lambda t: shd.copy_to(t, axis), (8, 8)),
                ("reduce_from", lambda t: shd.reduce_from(t, axis), (8, 8)),
                ("gather_sum", lambda t: shd.gather(t, 0, axis), (32, 8)),
                ("gather_slice", lambda t: shd.gather(t, 0, axis, "slice"),
                 (32, 8)),
                ("scatter", lambda t: shd.scatter(t, 0, axis), (2, 8)),
                ("split", lambda t: shd.split(t, 1, axis), (8, 2))):
            y = fn(x)
            g = torch.cat(gs)[:gshape[0], :gshape[1]] * (rank + 1)
            (dx,) = torch.autograd.grad(y, x, g)
            out[name] = (y.detach().numpy(), dx.numpy(), g.numpy())
        bf = shd.all_sum(xs[rank].to(torch.bfloat16), axis, "tp_reduce")
        out["bf16_sum"] = bf.float().numpy()
    return out, dict(st.collectives), dict(st.collective_bytes)


@pytest.fixture(scope="module")
def collectives():
    return tmesh.spawn(collectives_rank, 4, threads=1,
                       timeout_s=H.RANK_TIMEOUT_S)


def _xs():
    gen = torch.Generator().manual_seed(7)
    xs = [torch.randn((8, 8), generator=gen) for _ in range(4)]
    return [x.numpy() for x in xs]


def _ordered(parts):
    out = parts[0].astype(np.float32)
    for p in parts[1:]:
        out = out + p
    return out


def test_collective_forwards(collectives):
    xs = _xs()
    for r, (out, _, _) in enumerate(collectives):
        assert np.array_equal(out["copy_to"][0], xs[r])
        assert np.array_equal(out["reduce_from"][0], _ordered(xs))
        assert np.array_equal(out["gather_sum"][0], np.concatenate(xs))
        assert np.array_equal(out["gather_slice"][0], np.concatenate(xs))
        assert np.array_equal(out["scatter"][0],
                              _ordered([x[2 * r:2 * r + 2] for x in xs]))
        assert np.array_equal(out["split"][0], xs[r][:, 2 * r:2 * r + 2])
        # every rank the same bits
        assert np.array_equal(out["reduce_from"][0],
                              collectives[0][0]["reduce_from"][0])
        want = _ordered([x.astype(np.float32) for x in [
            torch.from_numpy(x).to(torch.bfloat16).float().numpy()
            for x in xs]])
        assert np.array_equal(out["bf16_sum"], torch.from_numpy(want).to(
            torch.bfloat16).float().numpy())


def test_collective_backwards_are_adjoints(collectives):
    g = {n: [o[n][2] for o, _, _ in collectives] for n in collectives[0][0]
         if n != "bf16_sum"}
    for r, (out, _, _) in enumerate(collectives):
        assert np.array_equal(out["copy_to"][1], _ordered(g["copy_to"]))
        assert np.array_equal(out["reduce_from"][1], g["reduce_from"][r])
        assert np.array_equal(out["gather_sum"][1], _ordered(
            [gg[8 * r:8 * r + 8] for gg in g["gather_sum"]]))
        assert np.array_equal(out["gather_slice"][1],
                              g["gather_slice"][r][8 * r:8 * r + 8])
        assert np.array_equal(out["scatter"][1], np.concatenate(
            g["scatter"]))
        assert np.array_equal(out["split"][1], np.concatenate(
            g["split"], axis=1))


def test_collective_labels_and_bytes(collectives):
    for _, counts, nbytes in collectives:
        # forward + backward: copy_to 0 + 1, reduce_from 1 + 0, the two
        # gathers 1 + 1 (sum) and 1 + 0 (slice), scatter 1 + 1, split
        # 0 + 1, then the bf16 sum
        assert counts == {"tp_reduce": 3, "tp_gather": 4, "tp_scatter": 2}
        # received from 3 peers: an (8, 8) f32 block (256 B) per sum or
        # gather, a quarter of it per scatter block, the split's and the
        # scatter's (8, 2) / (2, 8) grads, the (8, 8) bf16 sum
        assert nbytes == {"tp_reduce": 3 * (256 + 256 + 128),
                          "tp_gather": 3 * (256 + 256 + 64 + 64),
                          "tp_scatter": 3 * (256 + 64)}


# ---------------------------------------------------------------------------
# run_cell on a mesh of ranks
# ---------------------------------------------------------------------------

def test_run_cell_plans_ranks_as_the_program_holds(runs):
    from repro_torch.configs import ShapeSpec
    port, _ = runs
    c = _case("moe")
    shape = ShapeSpec("cpu_train", "train", H.S, H.B)
    cell = dryrun.run_cell("phi3.5-moe-42b-a6.6b", shape, "baseline",
                           cfg=H.case_cfg(c), mesh={"data": 2, "model": 2})
    assert cell["status"] == "ok"
    held = sorted(r["state_bytes"] for r in port["moe"])
    assert [r["state_bytes"] for r in cell["ranks"]] == held
    assert cell["mesh"] == {"pod": 1, "data": 2, "model": 2}
    one = dryrun.run_cell("phi3.5-moe-42b-a6.6b", shape, "baseline",
                          cfg=H.case_cfg(c))
    assert "ranks" not in one and "mesh" not in one
    assert one["memory"]["state_bytes"] > held[0]
    skipped = dryrun.run_cell("phi3.5-moe-42b-a6.6b", shape, "sedar",
                              cfg=H.case_cfg(c), mesh={"data": 2,
                                                       "model": 2})
    assert skipped["status"] == "skipped"
