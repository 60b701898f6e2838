"""Activation rematerialization in training (`ModelConfig.remat`,
`models/remat.py`) against the JAX reference's `jax.checkpoint` policies,
at reduce_for_smoke size (batch 2 x 16 tokens, the frontend's stub
embeddings for vlm and audio):

  * dense, moe and vlm here (hybrid, ssm and audio in
    `test_torch_remat_families.py`): the port's loss
    and grads under `full` and `minimal` against the JAX model under the
    same policy, loss within rtol 1e-5 and every grad within rtol 1e-4 /
    atol 1e-6 (the training tests' tolerances: f32, other reduction
    orders); hybrid's and ssm's grads within atol 2e-5, as their models
    without remat already differ from JAX's by up to 1.1e-5 (the RG-LRU
    scan and the sLSTM loop sum in other orders);
  * every family: the port's three policies bitwise equal to one
    another, loss and
    every grad's bits (the rerun is the same arithmetic at the same
    shapes), and under `minimal` the rerun takes the forward's weight
    products;
  * the two-level groups of a layer stack (`remat_group_size`, the
    reference's): 4 layers in one group of G = 4 and 2 in one of G = 2,
    against JAX and bitwise against `none`;
  * in `test_torch_remat_families.py`: the JAX comparison of recurrentgemma,
    xlstm and seamless, the fused trainer's step (`loss_and_grads_stacked`,
    the forward under `torch.vmap`) bitwise equal across the policies, a
    `SedarTrainer` L3 run under `full` with a grads fault, and expert
    parallelism on 2 gloo ranks."""
import dataclasses
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtfm

from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import build_model, remat as tremat
from repro_torch.models import transformer as ttfm

torch.set_num_threads(1)

ARCHS = ("qwen2-0.5b", "phi3.5-moe-42b-a6.6b", "recurrentgemma-2b",
         "internvl2-2b", "xlstm-125m", "seamless-m4t-medium")
B, S = 2, 16
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
# the scans of hybrid (RG-LRU) and ssm (sLSTM) sum in other orders than
# JAX's: their grads differ from JAX's by up to 1.1e-5 without remat too
SCAN_GRAD_TOL = dict(rtol=1e-4, atol=2e-5)
TEST_TIMEOUT_S = 300


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


class Case:
    """One arch at reduced size (`layers` overrides the depth): numpy
    params from the JAX model's init and one seeded batch."""

    def __init__(self, arch, layers=None):
        self.arch = arch
        self.jcfg = jreduce(jget_config(arch))
        self.cfg = reduce_for_smoke(get_config(arch))
        if layers:
            self.jcfg = dataclasses.replace(self.jcfg, num_layers=layers)
            self.cfg = dataclasses.replace(self.cfg, num_layers=layers)
        params = jbuild_model(self.jcfg).init(jax.random.PRNGKey(0))
        self.params_np = jax.tree.map(np.asarray, params)
        r = np.random.RandomState(1)
        V = self.cfg.vocab_size
        self.batch_np = {"tokens": r.randint(0, V, (B, S)).astype(np.int32),
                         "targets": r.randint(0, V, (B, S)).astype(np.int32)}
        if self.cfg.frontend:
            self.batch_np["frontend_embeds"] = (0.05 * r.standard_normal(
                (B, self.cfg.frontend_seq, self.cfg.frontend_dim))
            ).astype(np.float32)
        self._port = {}
        self.replayed = {}      # products a policy's reruns took

    def batch(self):
        return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                    else v) for k, v in self.batch_np.items()}

    def port(self, policy):
        """(loss, grads) of the port's model under `policy`."""
        if policy not in self._port:
            cfg = dataclasses.replace(self.cfg, remat=policy)
            model = build_model(cfg, "cpu")
            before = tremat.counts["replayed"]
            tp = bridge.params_from_numpy(self.params_np)
            leaves = [p.requires_grad_(True) for p in tree_util.leaves(tp)]
            loss = model.loss(tree_util.unflatten_like(tp, leaves),
                              self.batch())[0]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            self._port[policy] = (loss.detach(), [
                torch.zeros_like(p) if g is None else g
                for g, p in zip(grads, leaves)])
            self.replayed[policy] = tremat.counts["replayed"] - before
        return self._port[policy]

    def jax(self, policy):
        cfg = dataclasses.replace(self.jcfg, remat=policy)
        model = jbuild_model(cfg)
        jp = jax.tree.map(jnp.asarray, self.params_np)
        loss, g = jax.value_and_grad(lambda p: model.loss(p, {
            k: jnp.asarray(v) for k, v in self.batch_np.items()})[0])(jp)
        return float(loss), [np.asarray(x) for x in jax.tree.leaves(g)]


_CASES = {}


def case(arch, layers=None) -> Case:
    if (arch, layers) not in _CASES:
        _CASES[arch, layers] = Case(arch, layers)
    return _CASES[arch, layers]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().view(np.uint32)


def assert_bitwise(a, b):
    assert _bits(a[0]).tolist() == _bits(b[0]).tolist()
    assert len(a[1]) == len(b[1])
    for i, (x, y) in enumerate(zip(a[1], b[1])):
        assert np.array_equal(_bits(x), _bits(y)), f"grad leaf {i}"


def assert_matches_jax(c: Case, policy):
    tloss, tg = c.port(policy)
    jloss, jg = c.jax(policy)
    np.testing.assert_allclose(float(tloss), jloss, rtol=LOSS_RTOL)
    assert len(tg) == len(jg)
    tol = (SCAN_GRAD_TOL if c.cfg.family in ("hybrid", "ssm")
           else GRAD_TOL)
    for i, (a, b) in enumerate(zip(tg, jg)):
        np.testing.assert_allclose(a.numpy(), b, err_msg=f"leaf {i}", **tol)


# the first half of the families here, the rest in
# test_torch_remat_families.py (each file's time on one thread)
JAX_ARCHS = ARCHS[:3]


@pytest.mark.parametrize("policy", ["full", "minimal"])
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_port_matches_jax_under_the_same_policy(arch, policy):
    assert_matches_jax(case(arch), policy)


@pytest.mark.parametrize("arch", ARCHS)
def test_policies_are_bitwise_equal(arch):
    c = case(arch)
    assert_bitwise(c.port("none"), c.port("full"))
    assert_bitwise(c.port("none"), c.port("minimal"))
    assert c.replayed["minimal"] > 0 == c.replayed["full"]


@pytest.mark.parametrize("layers,G", [(4, 4), (2, 2)])
def test_two_level_groups(layers, G):
    c = case("qwen2-0.5b", layers)
    for policy in ("full", "minimal"):
        cfg = dataclasses.replace(c.cfg, remat=policy)
        assert ttfm.remat_group_size(cfg) == G == jtfm.remat_group_size(
            dataclasses.replace(c.jcfg, remat=policy))
        assert_matches_jax(c, policy)
        assert_bitwise(c.port("none"), c.port(policy))
