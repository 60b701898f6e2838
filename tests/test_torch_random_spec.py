"""`core/injection.py::random_spec` of the port (threefry2x32, the split,
`choice(p=...)` and `randint` written in numpy) against the reference's,
which draws with `jax.random` (JAX's default partitionable threefry): for
200 keys over each of three trees (f32 leaves, bf16 leaves, and both),
the same (leaf_idx, flat_idx, bit), exactly. Also the cipher, the split
and the draws one by one against `jax.random` on a few keys."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import injection as jinj

from repro_torch.core import injection as tinj

torch.set_num_threads(1)

KEYS = 200
TREES = {
    "f32": {"a": ((7, 13), "f32"), "b": ((1000,), "f32"), "c": ((3,), "f32")},
    "bf16": {"a": ((5, 4097), "bf16"), "b": ((2,), "bf16")},
    "mixed": {"w": ((128, 256), "f32"), "e": ((300, 64), "bf16"),
              "s": ((1,), "f32"), "z": ((70000,), "bf16")},
}


def _trees(name):
    jt = {k: jnp.zeros(shape, jnp.bfloat16 if d == "bf16" else jnp.float32)
          for k, (shape, d) in TREES[name].items()}
    tt = {k: torch.zeros(shape, dtype=torch.bfloat16 if d == "bf16"
                         else torch.float32)
          for k, (shape, d) in TREES[name].items()}
    return jt, tt


@pytest.mark.parametrize("name", sorted(TREES))
def test_random_spec_picks_the_references_fault(name):
    jt, tt = _trees(name)
    for seed in range(KEYS):
        want = jinj.random_spec(jax.random.PRNGKey(seed), jt, step=3,
                                replica=0, target="params")
        got = tinj.random_spec(tinj.prng_key(seed), tt, step=3, replica=0,
                               target="params")
        assert got == tinj.InjectionSpec(
            leaf_idx=want.leaf_idx, flat_idx=want.flat_idx, bit=want.bit,
            step=3, replica=0, target="params"), seed


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 + 5])
def test_draws_match_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    tkey = tinj.prng_key(seed)
    assert tuple(int(w) for w in np.asarray(key)) == tkey
    assert [tuple(int(w) for w in k) for k in
            np.asarray(jax.random.split(key, 3))] == tinj.prng_split(tkey, 3)
    assert np.float32(jax.random.uniform(key)) == tinj._uniform32(tkey)
    for hi in (7, 65536, 123457, 2 ** 31 - 1):
        assert int(jax.random.randint(key, (), 0, hi)) == \
            tinj._randint32(tkey, 0, hi)
    p = np.array([0.1, 0.25, 0.05, 0.6])
    assert int(jax.random.choice(key, 4, p=jnp.asarray(p))) == \
        tinj._choice_p(tkey, p)
