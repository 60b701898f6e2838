"""Activation rematerialization in training, continued from
`test_torch_remat.py` (each file's time on one thread):

  * hybrid (recurrentgemma), ssm (xlstm) and audio (seamless): the port's
    loss and grads under `full` and `minimal` against the JAX model under
    the same policy (the tolerances of `test_torch_remat.py`);
  * the fused trainer's step (`loss_and_grads_stacked`, the forward under
    `torch.vmap`) bitwise equal across the policies, every family that
    fuses under vmap (ssm runs per replica), `minimal` replaying its
    products there too;
  * a `SedarTrainer` L3 run under `full` with a grads fault at step 3,
    recovered and bitwise equal to its clean run, which is bitwise equal
    to the clean run under `none`;
  * expert parallelism on 2 gloo ranks (model axis 2): loss and grads
    under `full` bitwise equal to `none`'s on each rank."""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_remat import (ARCHS, B, JAX_ARCHS, S, Case, _bits,  # noqa: F401
                              _time_limit, assert_bitwise,
                              assert_matches_jax, case)

from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import (MeshConfig, RunConfig, SedarConfig,
                                 TrainConfig, get_config, reduce_for_smoke)
from repro_torch.core.injection import InjectionSpec
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model, remat
from repro_torch.runtime.train import SedarTrainer

torch.set_num_threads(1)

RANK_TIMEOUT_S = 120


@pytest.mark.parametrize("policy", ["full", "minimal"])
@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in JAX_ARCHS])
def test_port_matches_jax_under_the_same_policy(arch, policy):
    assert_matches_jax(case(arch), policy)


def _stacked(tmp_path, c: Case, policy):
    """The fused trainer's (losses, stacked grads) of two replicas (the
    second's params scaled by 1.01) under `policy`."""
    cfg = dataclasses.replace(c.cfg, remat=policy)
    tr = SedarTrainer(RunConfig(model=cfg, train=TrainConfig(
        global_batch=B, seq_len=S, steps=1)), str(tmp_path / policy),
        notify=lambda e: None, device="cpu")
    tp = bridge.params_from_numpy(c.params_np)
    stacked = tree_util.tree_map(lambda p: torch.stack([p, p * 1.01]), tp)
    losses, grads = tr.loss_and_grads_stacked(stacked, c.batch())
    return losses, tree_util.leaves(grads)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "xlstm-125m"])
def test_fused_vmap_step_is_bitwise_equal_across_policies(arch, tmp_path):
    c = case(arch)
    none = _stacked(tmp_path, c, "none")
    for policy in ("full", "minimal"):
        before = remat.counts["replayed"]
        assert_bitwise(none, _stacked(tmp_path, c, policy))
        # under vmap too, `minimal`'s rerun takes the forward's products
        assert (remat.counts["replayed"] > before) == (policy == "minimal")


def _run(tmp_path, policy, spec=None):
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                              remat=policy)
    rc = RunConfig(model=cfg, train=TrainConfig(
        global_batch=B, seq_len=S, steps=4, warmup_steps=2, lr=1e-3),
        sedar=SedarConfig(level=3, replication="sequential",
                          validate_interval=1, param_validate_interval=2,
                          checkpoint_interval=2))
    tr = SedarTrainer(rc, str(tmp_path / f"{policy}_{spec is not None}"),
                      inj_spec=spec, notify=lambda e: None, device="cpu")
    _, rep = tr.run(4)
    return rep


def test_sedar_grads_fault_recovers_bitwise_under_full(tmp_path):
    spec = InjectionSpec(target="grads", leaf_idx=0, flat_idx=5, bit=20,
                         step=3, replica=1)
    clean = _run(tmp_path, "full")
    fault = _run(tmp_path, "full", spec)
    none = _run(tmp_path, "none")
    assert not clean.detections and clean.steps_completed == 4
    assert [(e.step, e.boundary, e.effect) for e in fault.detections] == \
        [(3, "commit", "TDC")]
    assert [(r["kind"], r["step"]) for r in fault.recoveries] == \
        [("restore", 2)]
    for a in (fault, none):
        assert a.losses == clean.losses
        assert np.array_equal(a.final_state_fp, clean.final_state_fp)


def ep_rank(rank: int, params_np, batch_np) -> dict:
    """One rank of MeshConfig((1, 2), (data, model)): the reduced
    phi3.5-moe's loss and grads over `Model.loss(ctx=)` with this rank's
    experts, under `none` and under `full`, as raw bits."""
    from repro_torch.models.transformer import ShardCtx
    from repro_torch.sharding import Resolver
    mesh = tmesh.make_process_mesh(MeshConfig(shape=(1, 2),
                                              axis_names=("data", "model")))
    ctx = ShardCtx(mesh, Resolver(mesh))
    batch = {k: torch.from_numpy(v.astype(np.int64))
             for k, v in batch_np.items()}
    out = {}
    for policy in ("none", "full"):
        cfg = dataclasses.replace(
            reduce_for_smoke(get_config("phi3.5-moe-42b-a6.6b")),
            remat=policy)
        model = build_model(cfg, "cpu")
        tp = bridge.expert_shard(bridge.params_from_numpy(params_np), 2,
                                 mesh.model)
        tp = tree_util.tree_map(lambda t: t.clone(), tp)
        leaves = [p.requires_grad_(True) for p in tree_util.leaves(tp)]
        loss = model.loss(tree_util.unflatten_like(tp, leaves), batch,
                          ctx=ctx)[0]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out[policy] = [_bits(loss)] + [
            None if g is None else _bits(g) for g in grads]
    return out


def test_expert_parallel_full_equals_none_on_two_gloo_ranks():
    c = case("phi3.5-moe-42b-a6.6b")
    batch = {k: v for k, v in c.batch_np.items()
             if k in ("tokens", "targets")}
    reps = tmesh.spawn(ep_rank, 2, c.params_np, batch, threads=1,
                       timeout_s=RANK_TIMEOUT_S)
    for rep in reps:
        assert len(rep["none"]) == len(rep["full"])
        for i, (a, b) in enumerate(zip(rep["none"], rep["full"])):
            assert (a is None) == (b is None), i
            assert a is None or np.array_equal(a, b), f"leaf {i - 1}"
