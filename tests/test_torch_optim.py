"""The port's optimizers and schedules against the JAX package's on seeded
numpy trees. f32 on both sides; the tolerance allows the last-place
differences of pow/cos and of the sums' order (rtol 1e-5, atol 1e-7),
nothing more. Also the data pipeline's batches, bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.data import pipeline as jpipe
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched

from repro_torch import tree as tree_util
from repro_torch.configs import TrainConfig
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-7


def _tree(seed, scale=1.0):
    r = np.random.RandomState(seed)
    return {"a": (r.randn(6, 4) * scale).astype(np.float32),
            "b": {"c": (r.randn(9) * scale).astype(np.float32),
                  "d": (r.randn(2, 3, 2) * scale).astype(np.float32)}}


def _to_t(tree):
    return tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(t_tree, j_tree):
    tl = [x.numpy() for x in tree_util.leaves(t_tree)]
    jl = [np.asarray(x) for x in jax.tree.leaves(j_tree)]
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedules_match(kind):
    cfg = JTrainConfig(lr=3e-3, warmup_steps=4, steps=20, schedule=kind)
    jfn, tfn = jsched.make_schedule(cfg), tsched.make_schedule(
        TrainConfig(lr=3e-3, warmup_steps=4, steps=20, schedule=kind))
    for s in range(0, 24):
        want = float(jfn(jnp.asarray(s, jnp.int32)))
        got = float(tfn(torch.tensor(s, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("scale,max_norm", [(1.0, 1.0), (0.01, 1.0),
                                            (3.0, 0.5)])
def test_clip_by_global_norm_matches(scale, max_norm):
    g = _tree(1, scale)
    tg, tn = topt.clip_by_global_norm(_to_t(g), max_norm)
    jg, jn = jopt.clip_by_global_norm(_to_j(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    np.testing.assert_allclose(float(topt.global_norm(_to_t(g))),
                               float(jopt.global_norm(_to_j(g))), rtol=RTOL)
    _close(tg, jg)


@pytest.mark.parametrize("name", ["adamw", "sgdm"])
@pytest.mark.parametrize("grad_scale", [0.1, 10.0])
def test_optimizer_steps_match(name, grad_scale):
    """Five steps of each optimizer from the same params and grads: the
    updates, the new state and the applied params agree, and the port's
    update writes nothing in place."""
    cfg = dict(optimizer=name, lr=1e-2, warmup_steps=2, steps=8,
               weight_decay=0.1)
    jo = jopt.make_optimizer(JTrainConfig(**cfg))
    to = topt.make_optimizer(TrainConfig(**cfg))
    p = _tree(0)
    jp, tp = _to_j(p), _to_t(p)
    js, ts = jo.init(jp), to.init(tp)
    _close(ts, js)
    for step in range(5):
        g = _tree(10 + step, grad_scale)
        before = [x.clone() for x in tree_util.leaves(ts)]
        ju, js = jo.update(_to_j(g), js, jp, jnp.asarray(step, jnp.int32))
        tu, ts_new = to.update(_to_t(g), ts, tp,
                               torch.tensor(step, dtype=torch.int32))
        for a, b in zip(before, tree_util.leaves(ts)):
            assert torch.equal(a, b)          # out of place
        ts = ts_new
        _close(tu, ju)
        _close(ts, js)
        jp = jopt.apply_updates(jp, ju)
        tp = topt.apply_updates(tp, tu)
        _close(tp, jp)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 123456)])
def test_synthetic_batches_bitwise_equal(seed, step):
    j = jpipe.SyntheticLM(151_936, 4, 256, seed=seed).batch(step)
    t = tpipe.SyntheticLM(151_936, 4, 256, seed=seed).batch(step)
    assert sorted(j) == sorted(t) == ["targets", "tokens"]
    for k in j:
        assert j[k].dtype == t[k].dtype
        np.testing.assert_array_equal(j[k], t[k])


def test_memmap_corpus_batches_equal(tmp_path):
    path = str(tmp_path / "toks.bin")
    np.arange(5000, dtype=np.uint16).tofile(path)
    for step in (0, 5):
        j = jpipe.MemmapCorpus(path, 300, 3, 17, seed=2).batch(step)
        t = tpipe.MemmapCorpus(path, 300, 3, 17, seed=2).batch(step)
        for k in j:
            np.testing.assert_array_equal(j[k], t[k])
