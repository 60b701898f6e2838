"""Port dense model against the JAX reference on the same params (carried
across by `bridge.params_from_numpy`), at reduce_for_smoke size in f32:
prefill logits (exact and right-padded with `lengths`), one decode step's
logits and cache, for attention_impl "xla" and "pallas" (qwen2-0.5b: QKV
bias, tied embeddings, SwiGLU) and for starcoder2-7b (GELU MLP, untied
head). Tolerance 1e-4 (abs and rel): the same math with another summation
order."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtfm

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, list_archs, reduce_for_smoke
from repro_torch.models import transformer as ttfm

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", list_archs())
def test_configs_are_copies_of_the_reference(arch):
    for port, ref in ((get_config(arch), jget_config(arch)),
                      (reduce_for_smoke(get_config(arch)),
                       jreduce(jget_config(arch)))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def _setup(impl: str, arch: str = "qwen2-0.5b"):
    jcfg = dataclasses.replace(jreduce(jget_config(arch)),
                               attention_impl=impl)
    tcfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                               attention_impl=impl)
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    # non-zero norms and biases, so every parameter shapes the result
    leaves, tdef = jax.tree_util.tree_flatten(jparams)
    r = np.random.RandomState(1)
    leaves = [np.asarray(l) + (0.1 * r.standard_normal(l.shape)).astype(
        np.float32) * (np.asarray(l) == 0) for l in leaves]
    jparams = jax.tree_util.tree_unflatten(tdef, [jnp.asarray(l) for l in leaves])
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, tcfg, jparams, tparams


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("arch,impl", [("qwen2-0.5b", "xla"),
                                       ("qwen2-0.5b", "pallas"),
                                       ("starcoder2-7b", "xla")])
def test_prefill_and_decode_match_reference(arch, impl):
    jcfg, tcfg, jp, tp = _setup(impl, arch)
    B, S, max_len = 2, 12, 20
    toks = np.random.RandomState(2).randint(0, jcfg.vocab_size, (B, S))
    jl, jc = jtfm.lm_prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), max_len,
                             cache_dtype=jnp.float32)
    tl, tc = ttfm.lm_prefill(tcfg, tp, torch.from_numpy(toks), max_len,
                             cache_dtype=torch.float32)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **TOL)

    nxt = np.random.RandomState(3).randint(0, jcfg.vocab_size, (B,))
    jl2, jc2 = jtfm.lm_decode_step(jcfg, jp, jc, jnp.asarray(nxt, jnp.int32),
                                   jnp.asarray(S, jnp.int32))
    tl2, tc2 = ttfm.lm_decode_step(tcfg, tp, tc, torch.from_numpy(nxt), S)
    np.testing.assert_allclose(_np(tl2), _np(jl2), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc2[key]), _np(jc2[key]), **TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_right_padded_prefill_with_lengths(impl):
    jcfg, tcfg, jp, tp = _setup(impl)
    B, bucket, max_len = 3, 16, 24
    lengths = np.array([16, 9, 3])
    toks = np.random.RandomState(4).randint(0, jcfg.vocab_size, (B, bucket))
    toks[np.arange(bucket)[None, :] >= lengths[:, None]] = 0
    jl, _ = jtfm.lm_prefill(jcfg, jp, jnp.asarray(toks, jnp.int32), max_len,
                            cache_dtype=jnp.float32,
                            lengths=jnp.asarray(lengths, jnp.int32))
    tl, _ = ttfm.lm_prefill(tcfg, tp, torch.from_numpy(toks), max_len,
                            cache_dtype=torch.float32,
                            lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    # row 2's logits equal an exact-length prefill of its 3 real tokens
    ex, _ = ttfm.lm_prefill(tcfg, tp, torch.from_numpy(toks[2:3, :3]),
                            max_len, cache_dtype=torch.float32)
    np.testing.assert_allclose(_np(tl[2:3]), _np(ex), **TOL)


def test_param_tree_leaf_order_matches_reference():
    from repro_torch import tree as tree_util
    jcfg, tcfg, jp, tp = _setup("xla")
    jpaths = [jax.tree_util.keystr(p)
              for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    tpaths = [p for p, _ in tree_util.flatten_with_path(tp)]
    assert tpaths == jpaths
    assert tpaths[2] == "['layers']['attn']['bk']"
    # the port's own seeded init builds the same tree with the same shapes
    mine = ttfm.init_lm(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert [(p, tuple(l.shape)) for p, l in tree_util.flatten_with_path(mine)] \
        == [(p, tuple(l.shape)) for p, l in tree_util.flatten_with_path(tp)]
