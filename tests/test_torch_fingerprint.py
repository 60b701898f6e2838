"""Port fingerprint (plain versions and kernel K1) against the JAX reference.

Hash words h1/h2 must equal the reference's bit for bit; the sum/absmax
diagnostics are f32 reductions taken in another order, compared with
rtol=1e-5 relative to the sum of |x| and exactly for absmax.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import fingerprint as jfp
from repro.core.injection import flip_bit as jflip_bit
from repro.kernels.fingerprint import fingerprint_pallas

from repro_torch import tree as tree_util
from repro_torch.core import fingerprint as tfp
from repro_torch.core.injection import flip_bit as tflip_bit, inject_tree, \
    InjectionSpec
from repro_torch.kernels import fingerprint as kfp
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

DTYPES = ["float32", "bfloat16", "float16", "int32", "bool", "int8", "uint8"]
SIZES = [0, 1, 127, 128 * 256 + 1]


def _data(dtype: str, n: int, seed: int = 0):
    """The same values as (jax array, torch tensor)."""
    r = np.random.RandomState(seed + n)
    if dtype in ("float32", "bfloat16", "float16"):
        x = (r.standard_normal(n) * 3).astype(np.float32)
        if dtype == "float16":
            x = x.astype(np.float16)
            return jnp.asarray(x), torch.from_numpy(x)
        tx = torch.from_numpy(x)
        if dtype == "bfloat16":
            return jnp.asarray(x).astype(jnp.bfloat16), tx.to(torch.bfloat16)
        return jnp.asarray(x), tx
    if dtype == "bool":
        x = r.randint(0, 2, n).astype(bool)
    elif dtype == "int32":
        x = r.randint(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64).astype(np.int32)
    elif dtype == "int8":
        x = r.randint(-128, 128, n).astype(np.int8)
    else:
        x = r.randint(0, 256, n).astype(np.uint8)
    return jnp.asarray(x), torch.from_numpy(x)


def _u32(fp):
    return np.asarray(fp).astype(np.uint32) if not isinstance(fp, torch.Tensor) \
        else fp.numpy().view(np.uint32)


def _stats_close(j, t, ref_abs_sum):
    js, ja = j[2:].view(np.float32)
    ts, ta = t[2:].view(np.float32)
    assert ta == ja
    assert abs(float(ts) - float(js)) <= 1e-5 * max(ref_abs_sum, 1.0)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_tensor_fingerprint_bitwise(dtype, n):
    jx, tx = _data(dtype, n)
    j = _u32(jfp.tensor_fingerprint(jx))
    t = _u32(tfp.tensor_fingerprint(tx))
    np.testing.assert_array_equal(t[:2], j[:2])
    _stats_close(j, t, float(np.abs(np.asarray(jx, np.float64)).sum()))
    # the packed words themselves
    np.testing.assert_array_equal(
        _u32(tfp._to_u32(tx)), np.asarray(jfp._to_u32(jx)).astype(np.uint32))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_kernel_wrapper_matches_pallas_interpret(dtype, n):
    """ops.fingerprint (K1's plain version on the CPU) against the Pallas
    kernel run in interpret mode."""
    jx, tx = _data(dtype, n)
    j = _u32(fingerprint_pallas(jx, interpret=True))
    t = _u32(tops.fingerprint(tx))
    np.testing.assert_array_equal(t[:2], j[:2])
    _stats_close(j, t, float(np.abs(np.asarray(jx, np.float64)).sum()))


def _mixed_trees():
    """A nested dict whose insertion order differs from sorted order, with
    mixed dtypes and an empty leaf, as (jax tree, torch tree)."""
    parts = {"zeta": ("float32", 129), "alpha": ("bfloat16", 40),
             "mid": ("int32", 7), "empty": ("float32", 0)}
    jt, tt = {"z": {}, "a": {}}, {"z": {}, "a": {}}
    for i, (name, (dt, n)) in enumerate(parts.items()):
        jx, tx = _data(dt, n, seed=i)
        key = "z" if i % 2 == 0 else "a"
        jt[key][name], tt[key][name] = jx, tx
    jt["flag"], tt["flag"] = _data("bool", 5)
    return jt, tt


def test_leaf_order_is_jax_flatten_order():
    jt, tt = _mixed_trees()
    jpaths = [jax.tree_util.keystr(p)
              for p, _ in jax.tree_util.tree_flatten_with_path(jt)[0]]
    assert [p for p, _ in tree_util.flatten_with_path(tt)] == jpaths
    assert list(tt) == ["z", "a", "flag"]      # insertion order differs


def test_fused_and_per_leaf_tree_fingerprints_bitwise():
    jt, tt = _mixed_trees()
    np.testing.assert_array_equal(
        _u32(tfp.pack_tree_u32(tt)),
        np.asarray(jfp.pack_tree_u32(jt)).astype(np.uint32))
    t = _u32(tfp.pytree_fingerprint_fused(tt))
    for use_pallas in (False, True):
        j = _u32(jfp.pytree_fingerprint_fused(jt, use_pallas=use_pallas))
        np.testing.assert_array_equal(t[:2], j[:2])
    tp = tfp.pytree_fingerprint(tt).numpy().view(np.uint32)
    jp = np.asarray(jfp.pytree_fingerprint(jt)).astype(np.uint32)
    np.testing.assert_array_equal(tp[:, :2], jp[:, :2])
    np.testing.assert_array_equal(_u32(tfp.packed_fingerprint(
        tfp.pack_tree_u32(tt)))[:2], t[:2])


@pytest.mark.parametrize("tree", [{}, {"a": {}}, [], None])
def test_empty_trees(tree):
    assert tfp.pytree_fingerprint(tree).shape == (0, 4)
    np.testing.assert_array_equal(_u32(tfp.pytree_fingerprint_fused(tree)),
                                  np.zeros(4, np.uint32))
    np.testing.assert_array_equal(
        _u32(jfp.pytree_fingerprint_fused(tree if tree is not None else {})),
        np.zeros(4, np.uint32))


def test_mismatch_report_localizes_leaf():
    _, tt = _mixed_trees()
    bad = tree_util.replace_leaf(tt, 3, tflip_bit(tree_util.leaves(tt)[3], 2, 30))
    fa, fb = tfp.pytree_fingerprint(tt), tfp.pytree_fingerprint(bad)
    rep = tfp.mismatch_report(tt, fa, fb)
    assert [r["leaf"] for r in rep] == [tree_util.flatten_with_path(tt)[3][0]]
    assert not bool(tfp.fingerprints_equal(tfp.pytree_fingerprint_fused(tt),
                                           tfp.pytree_fingerprint_fused(bad)))


@pytest.mark.parametrize("dtype,bit", [("float32", 30), ("float32", 31),
                                       ("bfloat16", 14), ("int32", 30)])
def test_flip_bit_matches_reference(dtype, bit):
    jx, tx = _data(dtype, 33)
    j = np.asarray(jflip_bit(jx, 5, bit).astype(jnp.float32)
                   if dtype == "bfloat16" else jflip_bit(jx, 5, bit))
    before = tx.clone()
    t = tflip_bit(tx, 5, bit)
    t = (t.float() if dtype == "bfloat16" else t).numpy()
    np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))
    assert torch.equal(tx, before)          # the source tensor is untouched


def test_inject_tree_leaves_clean_path_untouched():
    _, tt = _mixed_trees()
    spec = InjectionSpec(leaf_idx=4, flat_idx=0, bit=30, step=4, replica=1,
                         target="params")
    assert inject_tree(tt, spec, step=3, replica_id=1, armed=True) is tt
    assert inject_tree(tt, spec, step=4, replica_id=0, armed=True) is tt
    assert inject_tree(tt, spec, step=4, replica_id=1, armed=False) is tt
    hit = inject_tree(tt, spec, step=4, replica_id=1, armed=True)
    leaves, hit_leaves = tree_util.leaves(tt), tree_util.leaves(hit)
    assert all(a is b for i, (a, b) in enumerate(zip(leaves, hit_leaves))
               if i != 4)
    assert not torch.equal(leaves[4], hit_leaves[4])


def test_plain_mulmod_has_no_int64_overflow():
    """Words near 2^32 at indices near 2^32 (the products the plain version
    splits) agree with exact Python integer arithmetic."""
    u = torch.tensor([0xFFFFFFFF, 0x80000001, 0x7FFFFFFF, 0], dtype=torch.int64)
    got = kfp._mulmod32(u, kfp.C2)
    want = [(int(v) * kfp.C2) % 2 ** 32 for v in u]
    assert got.tolist() == want

