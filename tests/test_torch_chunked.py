"""The chunked causal and windowed attentions of the port
(`models/layers.py::chunked_causal_attention`, `chunked_window_attention`,
one `torch.autograd.Function` that recomputes each tile in its backward)
against the JAX reference's scans, outputs and gradients (`jax.grad`) at
the reference's own cases (`tests/test_layers.py`: B 2, S 64, chunks 16;
S 96, window 32) and at ragged lengths (S not a multiple of a chunk); the
dispatch (`models/transformer.py::_attention_dispatch`) takes the
reference's branch at every (S, window); a reduced qwen2 forward at S =
2056 > CHUNKED_THRESHOLD against JAX's logits; and a reduced fused-trainer
step at S > 2048 (the forward under `torch.vmap`) against sequential.

Tolerances: atol 2e-5 for the attentions and their gradients (the
reference's own tolerance against exact attention), 1e-4 (abs and rel)
for model logits; the fused step's grads equal sequential's bitwise on
the CPU with one thread, as the fused trainer's other tests hold them."""
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
from repro.models import layers as jnn
from repro.models import transformer as jtfm

from repro_torch import tree as tree_util
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (RunConfig, SedarConfig, TrainConfig,
                                 get_config, reduce_for_smoke)
from repro_torch.models import layers as tnn
from repro_torch.models import transformer as ttfm

torch.set_num_threads(1)

ATOL = 2e-5
TOL = dict(atol=1e-4, rtol=1e-4)

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


def _qkv(seed, B, S, H, KV, hd):
    r = np.random.RandomState(seed)
    return tuple(r.randn(B, S, n, hd).astype(np.float32)
                 for n in (H, KV, KV))


def _jax_fn(window, qc, kc):
    if window:
        return lambda q, k, v: jnn.chunked_window_attention(
            q, k, v, window, q_chunk=qc)
    return lambda q, k, v: jnn.chunked_causal_attention(
        q, k, v, q_chunk=qc, k_chunk=kc)


def _port_fn(window, qc, kc):
    if window:
        return lambda q, k, v: tnn.chunked_window_attention(
            q, k, v, window, q_chunk=qc)
    return lambda q, k, v: tnn.chunked_causal_attention(
        q, k, v, q_chunk=qc, k_chunk=kc)


@pytest.mark.parametrize("B,S,H,KV,hd,window,qc,kc", [
    (2, 64, 4, 2, 16, 0, 16, 16),     # tests/test_layers.py:18
    (2, 96, 4, 2, 8, 32, 16, 16),     # tests/test_layers.py:28
    (2, 61, 4, 2, 16, 0, 16, 16),     # ragged: S % qc != 0
    (1, 70, 6, 2, 8, 0, 16, 32),      # ragged q and k chunks, kc != qc
    (2, 45, 4, 1, 8, 12, 16, 16),     # ragged windowed, window < qc
    (1, 50, 4, 2, 8, 20, 8, 8),       # window > q chunk
])
def test_chunked_attention_matches_reference_and_its_grads(
        B, S, H, KV, hd, window, qc, kc):
    q, k, v = _qkv(S + window, B, S, H, KV, hd)
    ct = np.random.RandomState(7).randn(B, S, H, hd).astype(np.float32)
    jf = _jax_fn(window, qc, kc)
    want = np.asarray(jf(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    jgrads = jax.grad(lambda a, b, c: jnp.sum(jf(a, b, c) * ct),
                      argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = _port_fn(window, qc, kc)(tq, tk, tv)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    (got * torch.from_numpy(ct)).sum().backward()
    for t, g in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATOL)
    # and the exact (S, S) form, through autograd
    eq, ek, ev = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    exact = tnn.causal_attention(eq, ek, ev, window)
    np.testing.assert_allclose(got.detach().numpy(), exact.detach().numpy(),
                               atol=ATOL)
    (exact * torch.from_numpy(ct)).sum().backward()
    for a, b in zip((tq, tk, tv), (eq, ek, ev)):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=ATOL)


@pytest.mark.parametrize("S,window", [
    (16, 0), (2048, 0), (2049, 0), (4096, 0), (8, 8), (9, 8), (16, 8),
    (2048, 2048), (2100, 2048), (3000, 4096), (4096, 2048)])
def test_dispatch_takes_the_reference_branch(S, window, monkeypatch):
    """Which form each package's `_attention_dispatch` runs at (S, window),
    spied on the functions it calls (the spies return q, nothing is
    computed)."""
    picked = {}

    def spy(pkg, name):
        def f(q, *a, **kw):
            picked.setdefault(pkg, []).append(name)
            return q
        return f

    for pkg, mod in (("jax", jnn), ("port", tnn)):
        for name in ("chunked_window_attention", "chunked_causal_attention",
                     "causal_attention"):
            monkeypatch.setattr(mod, name, spy(pkg, name))
    jcfg = jreduce(jget_config("recurrentgemma-2b"))
    tcfg = reduce_for_smoke(get_config("recurrentgemma-2b"))
    jq = jnp.zeros((1, S, 1, 1))
    jtfm._attention_dispatch(jcfg, jq, jq, jq, window)
    tq = torch.zeros((1, S, 1, 1))
    ttfm._attention_dispatch(tcfg, tq, tq, tq, window)
    assert picked["port"] == picked["jax"] and len(picked["jax"]) == 1


def _qwen_pair(layers=2):
    jcfg = jreduce(jget_config("qwen2-0.5b"))
    jcfg = dataclasses.replace(jcfg, num_layers=layers)
    tcfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                               num_layers=layers)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams))


def test_reduced_qwen2_forward_past_the_threshold_matches_reference():
    """S = 2056 > CHUNKED_THRESHOLD: both packages' dense forward runs the
    chunked causal form (its last q chunk and key block ragged)."""
    jcfg, tcfg, jp, tp = _qwen_pair()
    S = tnn.CHUNKED_THRESHOLD + 8
    toks = np.random.RandomState(3).randint(0, tcfg.vocab_size, (1, S))
    jh, _, _ = jtfm.lm_hidden(jcfg, jp, jnp.asarray(toks))
    want = np.asarray(jnn.logits_from_hidden(jcfg, jp["embed"], jh))
    calls = []
    real = tnn.chunked_causal_attention

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    tnn.chunked_causal_attention = counting
    try:
        th, _, _ = ttfm.lm_hidden(tcfg, tp, torch.from_numpy(toks))
    finally:
        tnn.chunked_causal_attention = real
    assert len(calls) == tcfg.num_layers
    got = tnn.logits_from_hidden(tcfg, tp["embed"], th)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_fused_trainer_steps_past_the_threshold_under_vmap(tmp_path):
    """A reduced fused-trainer step at S = 2056 runs the chunked causal
    Function under `torch.vmap` (its generated vmap rule) and gives each
    replica the grads of the sequential trainer's step, bitwise."""
    from repro_torch.core.policy import make_trainer
    tcfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-0.5b")),
                               num_layers=1)
    S = tnn.CHUNKED_THRESHOLD + 8

    def trainer(backend):
        rc = RunConfig(model=tcfg, train=TrainConfig(
            global_batch=1, seq_len=S, steps=1, warmup_steps=1),
            sedar=SedarConfig(level=1, replication=backend))
        return make_trainer(rc, str(tmp_path / backend), device="cpu",
                            notify=lambda e: None)

    seq = trainer("sequential")
    state = seq.init_state()
    batch = seq.batch(0)
    loss, grads = seq.loss_and_grads(state["params"], batch)
    fused = trainer("fused")
    stacked = tree_util.tree_map(lambda x: torch.stack([x, x]),
                                 state["params"])
    calls = []
    real = tnn._ChunkedAttention.apply

    def counting(*a):
        calls.append(1)
        return real(*a)

    tnn._ChunkedAttention.apply = counting
    try:
        losses, sgrads = fused.loss_and_grads_stacked(stacked, batch)
    finally:
        tnn._ChunkedAttention.apply = real
    assert calls
    for r in range(2):
        assert torch.equal(losses[r], loss)
        for a, b in zip(tree_util.leaves(grads), tree_util.leaves(sgrads)):
            assert torch.equal(b[r], a)
