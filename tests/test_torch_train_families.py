"""Protected training of the moe (phi3.5-moe) and audio
(seamless-m4t-medium: the encoder over stub frames, the decoder's
cross-attention) families: the port's trainer against the JAX package's,
at reduce_for_smoke size, global batch 2 x 16 tokens, 4 steps, L3 with FSC
and a validated checkpoint every 2, from one state carried across by
`bridge.train_state_from_numpy`. The hybrid and vlm families are held the
same way in `test_torch_train_families_hybrid.py`, ssm in
`test_torch_train_families_ssm.py`. moe and hybrid train with sgdm, the
others with adamw, as on the card.

What is held, per family:
  * the port's clean runs under none, sequential, fused, abft and hybrid:
    no detection, checkpoints [2, 4], losses within rtol 1e-5 of JAX's
    (f32, other reduction orders); on the CPU with one thread every
    backend's losses and final per-leaf fingerprints are bitwise equal to
    none's;
  * a sequential grads fault (leaf 0 element 5 bit 20, replica 1, step 3):
    JAX's event and recovery streams (L3 TDC rollback to step 2), ending
    bitwise equal to the port's own clean sequential run (ROADMAP C2: no
    bits from JAX); the same fault under fused gives that stream too and
    ends bitwise equal to fused's clean run;
  * a resident parameter bit (params leaf 0 element 5 bit 20) flipped
    after step 2's commit: hybrid's entry check at step 2 catches it as
    JAX's does (FSC, L3 restore of step 2) and the run ends bitwise equal
    to hybrid's clean run.
JAX runs per family: the sequential fault and the hybrid at-rest fault
(whose recovered losses are the clean trajectory's), plus an L2 fault for
the family that shows the chain rollback (ssm).

F4: the trainer's batch used to upload every leaf as int64, so the stub
embeddings of the vlm and audio families (|x| <= 0.05) reached the loss as
zeros under every backend. `test_trainer_batch_keeps_frontend_embeds`
holds the uploaded leaf to the pipeline's f32 values and the step-0 loss
to JAX's.

Also here: the optimizers' leaf-by-leaf `apply` against `update` +
`apply_updates` and against `torch.vmap` of `update` over stacked
replicas, bitwise, and K1's leaf table over recurrentgemma's 126-leaf
{params, m, v}."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import RunConfig as JRunConfig
from repro.configs import SedarConfig as JSedarConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.injection import InjectionSpec as JSpec
from repro.models import build_model as jbuild_model
from repro.optim import make_optimizer as jmake_optimizer
from repro.runtime.train import SedarTrainer as JTrainer

from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import (RunConfig, SedarConfig, TrainConfig,
                                 get_config, reduce_for_smoke)
from repro_torch.core import fingerprint as tfp
from repro_torch.core.injection import InjectionSpec
from repro_torch.kernels import fingerprint as kfp
from repro_torch.models import build_model
from repro_torch.optim import apply_updates, make_optimizer
from repro_torch.runtime.train import SedarTrainer

torch.set_num_threads(1)

STEPS = 4
LOSS_RTOL = 1e-5
BACKENDS = ("none", "sequential", "fused", "abft", "hybrid")
OPTIMIZER = {"phi3.5-moe-42b-a6.6b": "sgdm", "recurrentgemma-2b": "sgdm",
             "internvl2-2b": "adamw", "xlstm-125m": "adamw",
             "seamless-m4t-medium": "adamw"}
GRADS_FAULT = dict(target="grads", leaf_idx=0, flat_idx=5, bit=20, step=3,
                   replica=1)


def _train(arch):
    return dict(global_batch=2, seq_len=16, steps=STEPS, warmup_steps=2,
                lr=1e-3, optimizer=OPTIMIZER[arch])


def _sedar(backend, level=3):
    return dict(level=level, replication=backend, validate_interval=1,
                param_validate_interval=2, checkpoint_interval=2,
                toe_timeout_s=60.0)


class Family:
    """One family's runs, each made once per test module: the JAX trainer's
    and the port's from the same numpy state."""

    def __init__(self, arch, tmp_path_factory):
        self.arch = arch
        self.tmp = tmp_path_factory
        self.jcfg = jreduce(jget_config(arch))
        self.cfg = reduce_for_smoke(get_config(arch))
        params = jbuild_model(self.jcfg).init(jax.random.PRNGKey(0))
        opt = jmake_optimizer(JTrainConfig(**_train(arch))).init(params)
        self.state_np = jax.tree.map(np.asarray, {
            "params": params, "opt": opt, "step": jnp.zeros((), jnp.int32)})
        self._runs = {}

    def trainer(self, pkg, name, backend, level=3, spec=None):
        wd = str(self.tmp.mktemp(f"{pkg}_{name}"))
        if pkg == "jax":
            rc = JRunConfig(model=self.jcfg, train=JTrainConfig(
                **_train(self.arch)), sedar=JSedarConfig(
                    **_sedar(backend, level)))
            return JTrainer(rc, wd, inj_spec=spec and JSpec(**spec),
                            notify=lambda e: None)
        rc = RunConfig(model=self.cfg, train=TrainConfig(**_train(self.arch)),
                       sedar=SedarConfig(**_sedar(backend, level)))
        return SedarTrainer(rc, wd, inj_spec=spec and InjectionSpec(**spec),
                            notify=lambda e: None, device="cpu")

    def state(self, pkg):
        if pkg == "jax":
            return jax.tree.map(jnp.asarray, self.state_np)
        return bridge.train_state_from_numpy(self.state_np)

    def run(self, pkg, backend, fault=None, level=3):
        """(report, trainer) of a 4-step run: `fault` None (clean), "grads"
        or "rest" (the at-rest flip after step 2; the report then holds
        both halves' losses)."""
        key = (pkg, backend, fault, level)
        if key not in self._runs:
            tr = self.trainer(pkg, f"{backend}_{fault}_l{level}", backend,
                              level, GRADS_FAULT if fault == "grads" else None)
            dual = tr.engine.executor.init_dual(self.state(pkg))
            if fault == "rest":
                dual, first = tr.run(2, dual=dual)
                dual = _flip_at_rest(pkg, tr, dual)
                _, rep = tr.run(STEPS, dual=dual)
                rep.losses = first.losses + rep.losses
            else:
                _, rep = tr.run(STEPS, dual=dual)
            self._runs[key] = (rep, tr)
        return self._runs[key]


def _flip_at_rest(pkg, tr, dual):
    """Bit 20 of element 5 of params leaf 0 in the resident state."""
    if pkg == "torch":
        leaf = tree_util.leaves(tr.engine.executor.primary(dual)["params"])[0]
        leaf.view(-1)[5:6].view(torch.int32).bitwise_xor_(1 << 20)
        return dual
    flat, treedef = jax.tree.flatten(dual["r0"]["params"])
    a = np.array(flat[0])
    a.reshape(-1)[5:6].view(np.uint32)[0] ^= np.uint32(1 << 20)
    flat[0] = jnp.asarray(a)
    return {"r0": dict(dual["r0"],
                       params=jax.tree.unflatten(treedef, flat))}


def same_stream(trep, jrep):
    assert [(e.step, e.boundary, e.effect) for e in trep.detections] == \
        [(e.step, e.boundary, e.effect) for e in jrep.detections]
    assert trep.recoveries == jrep.recoveries
    assert trep.checkpoints == jrep.checkpoints
    assert trep.stopped == jrep.stopped
    assert trep.steps_completed == jrep.steps_completed
    assert trep.final_state_fp.shape == jrep.final_state_fp.shape
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=LOSS_RTOL)


def bitwise(a, b) -> bool:
    return (np.array_equal(a.final_state_fp[:, :2], b.final_state_fp[:, :2])
            and a.losses == b.losses)


# -- the checks each family file runs -----------------------------------------

def check_clean(fam, backend):
    """A clean run of `backend`: JAX's checkpoints and, within rtol 1e-5,
    the losses of JAX's recovered sequential run (the clean trajectory);
    bitwise equal to the port's unprotected run."""
    rep, tr = fam.run("torch", backend)
    jrep, _ = fam.run("jax", "sequential", "grads")
    assert tr.engine.executor.name == backend
    assert not rep.detections and not rep.stopped
    assert rep.steps_completed == STEPS and rep.checkpoints == [2, 4]
    np.testing.assert_allclose(rep.losses, jrep.losses, rtol=LOSS_RTOL)
    assert bitwise(rep, fam.run("torch", "none")[0])


def check_grads_fault(fam, backend):
    """The grads fault at step 3 under `backend`: JAX's sequential streams
    (TDC at the commit, L3 restore of step 2), ending bitwise equal to the
    backend's own clean run."""
    rep, _ = fam.run("torch", backend, "grads")
    jrep, _ = fam.run("jax", "sequential", "grads")
    same_stream(rep, jrep)
    assert [(e.step, e.boundary, e.effect) for e in rep.detections] == \
        [(3, "commit", "TDC")]
    assert [(r["kind"], r["step"]) for r in rep.recoveries] == \
        [("restore", 2)]
    assert bitwise(rep, fam.run("torch", backend)[0])


def check_at_rest_fault(fam):
    """Hybrid's entry check catches the at-rest flip as JAX's does and the
    run ends bitwise equal to hybrid's clean run."""
    rep, _ = fam.run("torch", "hybrid", "rest")
    jrep, _ = fam.run("jax", "hybrid", "rest")
    same_stream(rep, jrep)
    assert [(e.step, e.boundary, e.effect) for e in rep.detections] == \
        [(2, "validate", "FSC")]
    assert [(r["kind"], r["step"]) for r in rep.recoveries] == \
        [("restore", 2)]
    assert bitwise(rep, fam.run("torch", "hybrid")[0])


def check_frontend_batch(fam):
    """The trainer's batch keeps `frontend_embeds` as the pipeline made it
    (f32, nonzero) and the tokens as int64; the step-0 loss on it is
    JAX's."""
    tr = fam.trainer("torch", "batch", "none")
    want = tr.data.batch(0)
    got = tr.batch(0)
    emb = got["frontend_embeds"]
    assert emb.dtype == torch.float32
    assert np.array_equal(emb.numpy(), want["frontend_embeds"])
    assert bool((emb != 0).any())
    for k in ("tokens", "targets"):
        assert got[k].dtype == torch.int64
        assert np.array_equal(got[k].numpy(), want[k])
    loss, _ = tr.loss_and_grads(fam.state("torch")["params"], got)
    jrep, _ = fam.run("jax", "sequential", "grads")
    np.testing.assert_allclose(float(loss), jrep.losses[0], rtol=LOSS_RTOL)


# -- moe and audio --------------------------------------------------------------

ARCHS = ("phi3.5-moe-42b-a6.6b", "seamless-m4t-medium")


@pytest.fixture(scope="module")
def fams(tmp_path_factory):
    return {a: Family(a, tmp_path_factory) for a in ARCHS}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_clean_training_matches_jax(fams, arch, backend):
    check_clean(fams[arch], backend)


@pytest.mark.parametrize("backend", ["sequential", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_fault_recovers_as_jax(fams, arch, backend):
    check_grads_fault(fams[arch], backend)


@pytest.mark.parametrize("arch", ARCHS)
def test_hybrid_catches_at_rest_fault_as_jax(fams, arch):
    check_at_rest_fault(fams[arch])


def test_trainer_batch_keeps_frontend_embeds(fams):
    check_frontend_batch(fams["seamless-m4t-medium"])


def test_moe_dispatch_buffer_is_batched_under_vmap(fams):
    """The MoE layer's dispatch buffer is made from the rows it receives,
    so `torch.vmap` over stacked params (fused training) writes batched
    rows into a batched buffer; the fused step's replicas agree with a
    replica alone, bitwise on the CPU."""
    fam = fams["phi3.5-moe-42b-a6.6b"]
    tr = fam.trainer("torch", "moe_vmap", "fused")
    state = fam.state("torch")
    batch = tr.batch(0)
    dual = tr.engine.executor.init_dual(state)
    losses, grads = tr.loss_and_grads_stacked(dual["s"]["params"], batch)
    loss, single = tr.loss_and_grads(state["params"], batch)
    assert torch.equal(losses[0], loss) and torch.equal(losses[1], loss)
    for g, s in zip(tree_util.leaves(grads), tree_util.leaves(single)):
        assert torch.equal(g[0], s) and torch.equal(g[1], s)


@pytest.mark.parametrize("opt", ["adamw", "sgdm"])
def test_optimizer_apply_is_update_then_apply_updates(opt):
    """`apply` steps leaf by leaf, largest first, and drops each gradient
    leaf it has used; its result is `update` + `apply_updates` bit for bit,
    and with `replicas=True` a `torch.vmap` of them over two stacked
    replicas at their own steps."""
    o = make_optimizer(TrainConfig(optimizer=opt, lr=1e-2, warmup_steps=2,
                                   steps=10))
    gen = torch.Generator().manual_seed(0)

    def rand(shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    params = {"a": rand((5, 7)), "b": {"c": rand((3,)), "d": rand((2, 3, 4))},
              "e": rand((1,))}
    grads = tree_util.tree_map(lambda p: rand(p.shape, 3.0), params)
    state = tree_util.tree_map(lambda p: rand(p.shape).abs(),
                               o.init(params))
    step = torch.tensor(3, dtype=torch.int32)
    updates, want_state = o.update(grads, state, params, step)
    want = (apply_updates(params, updates), want_state)
    glist = tree_util.leaves(grads)
    got = o.apply(glist, state, params, step)
    assert glist == [None] * len(glist)
    for a, b in zip(tree_util.leaves(got), tree_util.leaves(want)):
        assert torch.equal(a, b)

    def stack(t):
        return tree_util.tree_map(lambda a: torch.stack([a, 0.5 * a + 0.1]),
                                  t)

    P, G, S = stack(params), stack(grads), stack(state)
    steps = torch.tensor([3, 5], dtype=torch.int32)
    U, vstate = torch.vmap(o.update)(G, S, P, steps)
    want = (apply_updates(P, U), vstate)
    got = o.apply(tree_util.leaves(G), S, P, steps, replicas=True)
    for a, b in zip(tree_util.leaves(got), tree_util.leaves(want)):
        assert torch.equal(a, b)


def test_k1_leaf_table_takes_a_126_leaf_training_state():
    """recurrentgemma's {params, adamw m, v} has 126 leaves, more than the
    64 a small table holds: `leaf_table` takes them all (K1 reads them in
    place in one launch on the card), and the plain leaf walk of that
    table equals the packed plain fingerprint's hash words and absmax."""
    cfg = reduce_for_smoke(get_config("recurrentgemma-2b"))
    params = build_model(cfg, "cpu").init(seed=0)
    opt = make_optimizer(TrainConfig(optimizer="adamw")).init(params)
    gen = torch.Generator().manual_seed(5)
    opt = tree_util.tree_map(lambda t: torch.randn(t.shape, generator=gen),
                             opt)
    tree = {"params": params, "opt": opt}
    table = kfp.leaf_table(tree_util.leaves(tree))
    assert table is not None and len(table) == 126 > 64
    assert 126 <= kfp.MAX_LEAVES
    got = kfp.fingerprint_leaves_plain(table)
    want = kfp.fingerprint_plain(tfp.pack_tree_u32(tree))
    assert torch.equal(got[[0, 1, 3]], want[[0, 1, 3]])
