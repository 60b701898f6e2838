"""K1's leaf table and its plain leaf walk against packing and the JAX
reference, on the CPU.

On the card, `pytree_fingerprint_fused` hands K1 a table of leaves read where
they lie (`kernels/fingerprint.py::leaf_table`): each leaf is rows of one
contiguous run at a row stride, with the global word index of its first
word. `fingerprint_leaves_plain` reads the same table through `as_strided`
views, so these tests hold the table builder itself: its h1/h2/absmax must
equal those of the packed buffer (`pack_tree_u32` + `fingerprint_plain`)
bit for bit, and h1/h2 those of the JAX `pytree_fingerprint_fused` of the
same state.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import fingerprint as jfp

from repro_torch import tree as tree_util
from repro_torch.core import fingerprint as tfp
from repro_torch.kernels import fingerprint as kfp

torch.set_num_threads(1)


def _cache(L=2, B=2, T=40, KV=2, hd=16, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(L, B, T, KV, hd, generator=g).to(dtype)


@pytest.mark.parametrize("make,want", [
    (lambda: torch.zeros(10), (1, 10, 10)),
    (lambda: torch.zeros(3, 5), (1, 15, 15)),
    (lambda: torch.zeros(()), (1, 1, 1)),
    (lambda: _cache()[:, :, :1], (4, 32, 40 * 32)),
    (lambda: _cache()[:, :, :13], (4, 13 * 32, 40 * 32)),
    (lambda: _cache()[:, :, :40], (1, 4 * 40 * 32, 4 * 40 * 32)),
    (lambda: _cache()[1:, :, :7], (2, 7 * 32, 40 * 32)),
    (lambda: torch.zeros(9, 33)[:, 1:30], (9, 29, 33)),
    (lambda: torch.zeros(6, 1, 4)[::2], (3, 4, 8)),
    (lambda: torch.zeros(5).expand(3, 5), (3, 5, 0)),
    (lambda: torch.zeros(4, 6).t(), None),
    (lambda: _cache()[:, :, :5, :1], None),
    (lambda: torch.zeros(4, 6, 8)[:, :3, :4], None),
])
def test_layout_is_rows_of_one_contiguous_run(make, want):
    assert kfp._layout(make()) == want


def test_table_kinds_bases_and_fallbacks():
    f = torch.zeros(5)
    tab = kfp.leaf_table([f, torch.zeros(0),
                          torch.zeros(3, dtype=torch.bfloat16),
                          torch.zeros(2, dtype=torch.int64),
                          torch.zeros(4, dtype=torch.int32),
                          torch.zeros(1, dtype=torch.uint32)])
    assert [(l.kind, l.base) for l in tab] == [(0, 0), (1, 5), (2, 8), (0, 10),
                                              (0, 14)]
    for dt in (torch.float16, torch.float64, torch.bool, torch.int8,
               torch.int16, torch.uint8):
        assert kfp.leaf_table([f, torch.zeros(3, dtype=dt)]) is None
    assert kfp.leaf_table([torch.zeros(4, 6).t()]) is None
    assert len(kfp.leaf_table([f] * kfp.MAX_LEAVES)) == kfp.MAX_LEAVES
    assert kfp.leaf_table([f] * (kfp.MAX_LEAVES + 1)) is None
    assert kfp.leaf_table([]) == []


def _trees():
    g = torch.Generator().manual_seed(3)
    c = _cache(dtype=torch.bfloat16, seed=1)
    return {
        "hybrid_bf16": {"cache": {"k": c[:, :, :13], "v": c[:, :, :13]},
                        "tok": torch.tensor([5, 2 ** 40 + 7])},
        "hybrid_f32": {"cache": {"k": _cache(dtype=torch.float32)[:, :, :1]},
                       "tok": torch.tensor([3])},
        "odd": {"a": torch.randn(1001, generator=g)[3:],
                "b": torch.randn(7, 5, generator=g).bfloat16(),
                # words below 0x7F800000 are finite as f32, so the sum and
                # absmax are defined
                "c": torch.randint(0, 0x7F800000, (13,), generator=g,
                                   dtype=torch.int32),
                "d": torch.randint(0, 2 ** 20, (3, 3), generator=g) * 2 ** 32
                + torch.randint(0, 0x7F800000, (3, 3), generator=g),
                "e": torch.zeros(0),
                "f": torch.randn(9, 33, generator=g)[:, 1:30],
                "g": torch.randn(5, generator=g).bfloat16()[1:]},
    }


def test_leaf_walk_hash_words_on_every_bit_pattern():
    """Negative int32/int64 values (NaN patterns as f32): the hash words
    still equal the packed buffer's."""
    g = torch.Generator().manual_seed(4)
    tree = {"c": torch.randint(-2 ** 31, 2 ** 31 - 1, (13,), generator=g,
                               dtype=torch.int32),
            "d": torch.randint(-2 ** 62, 2 ** 62, (3, 3), generator=g)}
    table = kfp.leaf_table(tree_util.leaves(tree))
    got = kfp.fingerprint_leaves_plain(table).numpy().view(np.uint32)
    want = kfp.fingerprint_plain(tfp.pack_tree_u32(tree)).numpy().view(
        np.uint32)
    np.testing.assert_array_equal(got[:2], want[:2])


@pytest.mark.parametrize("name", sorted(_trees()))
def test_leaf_walk_equals_pack_and_plain(name):
    tree = _trees()[name]
    table = kfp.leaf_table(tree_util.leaves(tree))
    got = kfp.fingerprint_leaves_plain(table).numpy().view(np.uint32)
    packed = tfp.pack_tree_u32(tree)
    want = kfp.fingerprint_plain(packed).numpy().view(np.uint32)
    np.testing.assert_array_equal(got[[0, 1, 3]], want[[0, 1, 3]])
    gs, ws = got[2:3].view(np.float32)[0], want[2:3].view(np.float32)[0]
    scale = float(packed.view(torch.float32).abs().sum())
    assert abs(float(gs) - float(ws)) <= 1e-5 * max(scale, 1.0)


def _bf16_to_jax(t: torch.Tensor):
    return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))


@pytest.mark.parametrize("pos", [1, 13, 40])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_hybrid_tree_leaf_walk_equals_jax_fused(pos, dtype):
    """The hybrid backend's tree (cache rows [0, pos) of both caches, and
    the token) as the server builds it, hashed through the leaf table, has
    the JAX fused fingerprint's hash words."""
    tdt = getattr(torch, dtype)
    cache = {"k": _cache(dtype=tdt, seed=pos), "v": _cache(dtype=tdt,
                                                            seed=pos + 1)}
    tok = torch.tensor([17, 151_000], dtype=torch.int64)
    tree = {"cache": {n: c[:, :, :pos] for n, c in cache.items()}, "tok": tok}
    table = kfp.leaf_table(tree_util.leaves(tree))
    assert [(l.kind, l.rows) for l in table] == \
        [(1 if dtype == "bfloat16" else 0, 4 if pos < 40 else 1)] * 2 + \
        [(2, 1)]
    got = kfp.fingerprint_leaves_plain(table).numpy().view(np.uint32)

    def to_jax(c):
        return (_bf16_to_jax(c) if dtype == "bfloat16"
                else jnp.asarray(c.numpy()))
    jtree = {"cache": {n: to_jax(c)[:, :, :pos] for n, c in cache.items()},
             "tok": jnp.asarray(tok.numpy().astype(np.int32))}
    for use_pallas in (False, True):
        want = np.asarray(jfp.pytree_fingerprint_fused(
            jtree, use_pallas=use_pallas)).astype(np.uint32)
        np.testing.assert_array_equal(got[:2], want[:2])


def test_cpu_leaves_take_the_plain_walk_without_a_launch():
    tree = _trees()["hybrid_bf16"]
    table = kfp.leaf_table(tree_util.leaves(tree))
    before = kfp.launch_count.n
    assert torch.equal(kfp.fingerprint_leaves(table),
                       kfp.fingerprint_leaves_plain(table))
    assert kfp.launch_count.n == before
    assert torch.equal(kfp.fingerprint_leaves([]),
                       torch.zeros(4, dtype=torch.int32))
    # the CPU fused path still packs: the same words as the table's walk
    fp = tfp.pytree_fingerprint_fused(tree).numpy().view(np.uint32)
    np.testing.assert_array_equal(
        fp[[0, 1, 3]],
        kfp.fingerprint_leaves(table).numpy().view(np.uint32)[[0, 1, 3]])
