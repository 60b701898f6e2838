"""The port's checkpoint store against the JAX package's: the same on-disk
format byte for byte (manifest JSON and leaf files), a version written by
either package restored by the other, the same delta references, gc
keep-sets and corruption detection."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import delta as jdelta
from repro.checkpoint import store as jstore

from repro_torch import tree as tree_util
from repro_torch.checkpoint import delta as tdelta
from repro_torch.checkpoint import store as tstore
from repro_torch.core import fingerprint as tfp

torch.set_num_threads(1)


def _np_state(seed=0):
    """A small training-state-shaped tree: f32 params and moments, an int32
    step (the leaves the trainer stores)."""
    r = np.random.RandomState(seed)
    return {"params": {"b": r.randn(7).astype(np.float32),
                       "w": r.randn(5, 3).astype(np.float32)},
            "opt": {"m": {"b": r.randn(7).astype(np.float32),
                          "w": r.randn(5, 3).astype(np.float32)}},
            "step": np.asarray(seed, np.int32)}


def _torch(tree):
    return tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax(tree):
    return {"params": {k: jnp.asarray(v) for k, v in tree["params"].items()},
            "opt": {"m": {k: jnp.asarray(v)
                          for k, v in tree["opt"]["m"].items()}},
            "step": jnp.asarray(tree["step"])}


def _files(d, step):
    path = os.path.join(d, f"ckpt_{step:08d}")
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


@pytest.mark.parametrize("compress", [False, True])
def test_same_bytes_on_disk(tmp_path, compress):
    """Both stores write the same manifest JSON and the same .npy leaf files
    for one state (the compressed .npz members carry timestamps, so those
    are compared by content)."""
    state = _np_state(3)
    fp = np.arange(12, dtype=np.uint32).reshape(3, 4) * np.uint32(2 ** 30)
    js = jstore.CheckpointStore(str(tmp_path / "j"), compress=compress)
    ts = tstore.CheckpointStore(str(tmp_path / "t"), compress=compress)
    js.save(4, _jax(state), kind="app", valid=True, fingerprint=fp,
            extra={"note": "x"})
    ts.save(4, _torch(state), kind="app", valid=True,
            fingerprint=fp.view(np.int32), extra={"note": "x"})
    jf, tf = _files(js.dir, 4), _files(ts.dir, 4)
    assert list(jf) == list(tf)
    assert jf["manifest.json"] == tf["manifest.json"]
    for name in jf:
        if name.endswith(".npy"):
            assert jf[name] == tf[name], name


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("compress", [False, True])
def test_version_restores_in_the_other_package(tmp_path, writer, compress):
    state = _np_state(5)
    d = str(tmp_path / "ck")
    if writer == "port":
        ts = tstore.CheckpointStore(d, compress=compress)
        ts.save(6, _torch(state), async_=True)
        ts.wait()
        got = jstore.CheckpointStore(d).restore(6, _jax(state))
        leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(got)]
    else:
        jstore.CheckpointStore(d, compress=compress).save(6, _jax(state))
        got = tstore.CheckpointStore(d).restore(6, _torch(state))
        leaves = [x.numpy() for x in tree_util.leaves(got)]
        assert all(isinstance(x, torch.Tensor)
                   for x in tree_util.leaves(got))
    want = tree_util.leaves(state)
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_leaf_digest_is_the_plain_fingerprint_words(seed):
    """The card path digests a leaf with K1; K1's h1/h2 equal its plain
    version's, and those equal the store's digest of the leaf's bytes."""
    r = np.random.RandomState(seed)
    for a in (r.randn(33).astype(np.float32),
              r.randint(-2 ** 31, 2 ** 31 - 1, (4, 5)).astype(np.int32),
              np.asarray(seed, np.int32)):
        fp = tfp.leaf_fingerprints({"x": torch.from_numpy(np.array(a))})
        words = [int(w) for w in fp.numpy()[0, :2].view(np.uint32)]
        assert words == jstore._leaf_digest(a) == tstore._leaf_digest(a)


def test_delta_refs_equal_and_restore_across(tmp_path):
    """A delta chain where some leaves stay unchanged: the same leaf_refs
    (resolved to the root holder) in both packages, and each package
    restores the other's delta version."""
    states = [_np_state(0), _np_state(0), _np_state(0)]
    states[1]["params"]["b"] = states[1]["params"]["b"] + 1
    states[2]["params"]["b"] = states[1]["params"]["b"]
    states[2]["step"] = np.asarray(7, np.int32)
    js = jdelta.DeltaCheckpointStore(str(tmp_path / "j"))
    ts = tdelta.DeltaCheckpointStore(str(tmp_path / "t"))
    for i, st in enumerate(states):
        js.save(2 * i + 2, _jax(st))
        ts.save(2 * i + 2, _torch(st))
    for step in (2, 4, 6):
        assert js.manifest(step).leaf_refs == ts.manifest(step).leaf_refs
        assert _files(js.dir, step)["manifest.json"] == \
            _files(ts.dir, step)["manifest.json"]
    assert ts.manifest(6).leaf_refs == {"0": 2, "1": 2, "2": 4, "3": 2}
    got_t = tstore.CheckpointStore(js.dir).restore(6, _torch(states[2]))
    got_j = jstore.CheckpointStore(ts.dir).restore(6, _jax(states[2]))
    for a, b, c in zip(tree_util.leaves(got_t),
                       jax.tree_util.tree_leaves(got_j),
                       tree_util.leaves(states[2])):
        np.testing.assert_array_equal(a.numpy(), c)
        np.testing.assert_array_equal(np.asarray(b), c)


@pytest.mark.parametrize("n,floor", [(1, None), (2, None), (2, 3), (1, 1),
                                     (3, 0)])
def test_gc_keep_sets_match(tmp_path, n, floor):
    steps = [2, 4, 6, 8, 10]
    assert tstore._gc_keep_set(steps, n, floor) == \
        jstore._gc_keep_set(steps, n, floor)
    js = jstore.CheckpointStore(str(tmp_path / "j"))
    ts = tstore.CheckpointStore(str(tmp_path / "t"))
    for s in steps:
        js.save(s, _jax(_np_state(s)))
        ts.save(s, _torch(_np_state(s)), async_=True)
    js.gc_keep_last(n, keep_floor=floor)
    ts.gc_keep_last(n, keep_floor=floor)
    assert ts.steps() == js.steps()


def test_delta_gc_keeps_referenced_bases(tmp_path):
    js = jdelta.DeltaCheckpointStore(str(tmp_path / "j"))
    ts = tdelta.DeltaCheckpointStore(str(tmp_path / "t"))
    for s in (1, 2, 3, 4):
        st = _np_state(0)
        st["step"] = np.asarray(s, np.int32)
        js.save(s, _jax(st))
        ts.save(s, _torch(st))
    js.gc_keep_last(1)
    ts.gc_keep_last(1)
    assert ts.steps() == js.steps() == [1, 4]
    ts.delete_others_than(4)
    js.delete_others_than(4)
    assert ts.steps() == js.steps() == [1, 4]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_corruption_detected_by_both(tmp_path, writer):
    state = _np_state(1)
    d = str(tmp_path / "ck")
    if writer == "port":
        tstore.CheckpointStore(d).save(3, _torch(state))
    else:
        jstore.CheckpointStore(d).save(3, _jax(state))
    path = os.path.join(d, "ckpt_00000003", "leaf_00001.npy")
    arr = np.load(path)
    arr.reshape(-1)[2] += 1.0
    np.save(path, arr)
    with pytest.raises(tstore.CheckpointCorruptionError):
        tstore.CheckpointStore(d).restore(3, _torch(state))
    with pytest.raises(jstore.CheckpointCorruptionError):
        jstore.CheckpointStore(d).restore(3, _jax(state))


def test_overwritten_delta_base_is_detected(tmp_path):
    ts = tdelta.DeltaCheckpointStore(str(tmp_path / "t"))
    ts.save(1, _torch(_np_state(0)))
    ts.save(2, _torch(_np_state(0)))
    assert ts.manifest(2).leaf_refs
    path = os.path.join(ts.dir, "ckpt_00000001", "leaf_00000.npy")
    np.save(path, np.load(path) * 2)
    with pytest.raises(tstore.CheckpointCorruptionError):
        ts.restore(2, _torch(_np_state(0)))


def test_l3_single_valid_protocol_and_reads(tmp_path):
    """valid flag, latest(valid_only), delete_others_than, no .tmp left,
    and the restore path's counted disk reads."""
    ts = tstore.CheckpointStore(str(tmp_path / "t"))
    ts.save(2, _torch(_np_state(2)), kind="system")
    ts.save(4, _torch(_np_state(4)), kind="app", valid=True, async_=True)
    assert ts.latest() == 4 and ts.latest(valid_only=True) == 4
    ts.delete_others_than(4)
    assert ts.steps() == [4]
    assert not [n for n in os.listdir(ts.dir) if n.endswith(".tmp")]
    with tstore.count_disk_reads() as st:
        ts.restore(4, _torch(_np_state(4)))
    assert st.by_label == {"manifest": 1, "leaf": 5}


def test_bf16_leaf_is_refused(tmp_path):
    ts = tstore.CheckpointStore(str(tmp_path / "t"))
    with pytest.raises(TypeError, match="bfloat16"):
        ts.save(1, {"w": torch.zeros(3, dtype=torch.bfloat16)})
    assert ts.steps() == []
