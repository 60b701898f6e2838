"""Multi-version atomic checkpoint store (the reference's
`checkpoint/store.py`), on the reference's on-disk format byte for byte:

    <dir>/ckpt_00001234/           one version per step
        manifest.json              step, kind, valid flag, fingerprint, leaf meta
        leaf_00000.npy ...         one npy per leaf (flatten order)
        leaf_00000.npz ...         compressed form (save(..., compress=True))
    <dir>/ckpt_00001234.tmp/       staging dir (renamed atomically on commit)

A version written by either package restores in the other: the manifest
has the same fields in the same order, the leaves are numpy's own files in
`repro_torch.tree` order (= `jax.tree.leaves` order), and the leaf digests
are the same function of the leaf's bytes.

What the recovery algorithms need from it, as in the reference:
  * L2: versions are never garbage collected implicitly (any checkpoint
    may be the only clean one); `gc_keep_last` is the opt-in bounded mode.
  * L3: `save(..., valid=True)` + `delete_others_than(step)` keep exactly
    one valid checkpoint.
  * async mode: the device->host copy finishes before `save` returns (the
    caller may write the snapshotted tensors right after); serialization,
    fsync of the manifest and the rename run on a writer thread.

On the card the leaf digests are computed there, one K1 launch per f32 or
int32 leaf over its words (its h1/h2 equal the digest of the leaf's bytes
bit for bit), and ride in the same batched copy as the leaves; `restore`
checks a leaf it puts on the card the same way. Elsewhere the digests are
numpy's, as in the reference. bfloat16 leaves are refused: the reference's
`.npy` files cannot carry them back.

Every leaf and manifest read on the restore path is counted by
`count_disk_reads()`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core import hostsync
from repro_torch.core.fingerprint import leaf_fingerprints


@dataclass
class Manifest:
    step: int
    kind: str = "system"            # system | app
    valid: Optional[bool] = None    # None = unknown (L2); True = validated (L3)
    fingerprint: Optional[List[List[int]]] = None
    n_leaves: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)
    # per-leaf digests of the bytes written, re-checked by restore()
    leaf_digests: Optional[List[List[int]]] = None
    # delta versions (delta.py): leaf i's bytes live in version
    # leaf_refs[str(i)], always the root holder
    leaf_refs: Optional[Dict[str, int]] = None
    bytes_on_disk: Optional[int] = None
    compressed: bool = False

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "Manifest":
        return Manifest(**json.loads(s))


class CheckpointCorruptionError(RuntimeError):
    """A restored leaf does not match its save-time digest: the on-disk
    payload changed after the atomic commit. Restoring it anyway would
    re-seed every replica from garbage, so restore fails loudly."""


@dataclass
class DiskReadStats:
    """Counts of restore-path disk reads inside a `count_disk_reads` region."""

    reads: int = 0
    by_label: Dict[str, int] = field(default_factory=dict)

    def note(self, label: str, items: int = 1) -> None:
        self.reads += items
        self.by_label[label] = self.by_label.get(label, 0) + items


_read_active: List[DiskReadStats] = []


@contextlib.contextmanager
def count_disk_reads() -> Iterator[DiskReadStats]:
    """Count every checkpoint leaf and manifest read inside the block."""
    st = DiskReadStats()
    _read_active.append(st)
    try:
        yield st
    finally:
        _read_active.remove(st)


# Process-wide metrics fan-in, installed by
# `repro_torch.obs.enable_metrics()` (None when metrics are off).
_metrics_note = None


def _note_disk_read(label: str, items: int = 1) -> None:
    for st in _read_active:
        st.note(label, items)
    if _metrics_note is not None:
        _metrics_note(label, items)


def _leaf_digest(arr: np.ndarray) -> List[int]:
    """Order-sensitive 64-bit digest of a leaf's raw bytes: the
    fingerprint's h1/h2 mixing over the bytes as u32 words."""
    b = arr.tobytes()
    u = np.frombuffer(b + b"\0" * ((-len(b)) % 4), np.uint32)
    idx = np.arange(u.size, dtype=np.uint32)
    h1 = int(((u ^ (idx * np.uint32(2654435761))) *
              np.uint32(2246822519)).sum(dtype=np.uint32))
    t = (u + idx) * np.uint32(3266489917)
    h2 = int((t ^ (t >> np.uint32(15))).sum(dtype=np.uint32))
    return [h1, h2]


# dtypes whose bytes ARE K1's words: the kernel's h1/h2 is the leaf digest
_WORD_DTYPES = (torch.float32, torch.int32, torch.uint32)


def _check_storable(t) -> None:
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        raise TypeError("the checkpoint store refuses bfloat16 leaves: the "
                        "reference's .npy format cannot round-trip them")


def _digest_words(fps: np.ndarray) -> List[List[int]]:
    """Rows of (n, 4) int32 carriers -> [[h1, h2], ...] as u32 ints."""
    words = np.asarray(fps).astype(np.int32).view(np.uint32)
    return [[int(a), int(b)] for a, b in words[:, :2]]


def _ckpt_name(step: int) -> str:
    return f"ckpt_{step:08d}"


def _write_leaf(dirpath: str, i: int, arr: np.ndarray, compress: bool) -> int:
    """Write one leaf payload; returns bytes written."""
    stem = os.path.join(dirpath, f"leaf_{i:05d}")
    if compress:
        np.savez_compressed(stem + ".npz", arr=arr)
        return os.path.getsize(stem + ".npz")
    np.save(stem + ".npy", arr)
    return os.path.getsize(stem + ".npy")


def _load_leaf(dirpath: str, i: int) -> np.ndarray:
    """Load one leaf payload (either serialization), counting the read."""
    stem = os.path.join(dirpath, f"leaf_{i:05d}")
    _note_disk_read("leaf")
    if os.path.exists(stem + ".npy"):
        return np.load(stem + ".npy")
    with np.load(stem + ".npz") as z:
        return z["arr"]


def _gc_keep_set(steps: List[int], n: int,
                 keep_floor: Optional[int]) -> set:
    """Keep-last-n plus the deferred-validation anchor: the newest version
    with step <= keep_floor is exempt from pruning."""
    keep = set(steps[-n:])
    if keep_floor is not None:
        anchored = [s for s in steps if s <= keep_floor]
        if anchored and not any(s <= keep_floor for s in keep):
            keep.add(anchored[-1])
    return keep


def snapshot(state) -> Tuple[List[np.ndarray], Optional[List[List[int]]]]:
    """(host leaves, leaf digests or None) of `state`, in flatten order.

    The device->host copy is ONE counted read batch (`checkpoint_save`);
    on the card the f32/int32 leaves' digests come from K1 in the same
    batch. Digests left None are computed from the host bytes later (on
    the writer thread)."""
    leaves = tree_util.leaves(state)
    for t in leaves:
        _check_storable(t)
    card = [i for i, t in enumerate(leaves)
            if isinstance(t, torch.Tensor) and t.is_cuda
            and t.dtype in _WORD_DTYPES]
    extra = [leaf_fingerprints([leaves[i] for i in card])] if card else []
    got = hostsync.batched_get(list(leaves) + extra,
                               label="checkpoint_save")
    # a card leaf arrives as a fresh host copy; a host leaf is copied here,
    # so the writer never sees a later in-place write to the state
    host = [np.asarray(a) if isinstance(t, torch.Tensor) and t.is_cuda
            else np.array(a) for a, t in zip(got, leaves)]
    if not card:
        return host, None
    dig: List[Optional[List[int]]] = [None] * len(leaves)
    for i, d in zip(card, _digest_words(got[-1])):
        dig[i] = d
    return host, [d if d is not None else _leaf_digest(a)
                  for d, a in zip(dig, host)]


def _fingerprint_json(fingerprint) -> Optional[List[List[int]]]:
    """A fingerprint for the manifest, as the reference writes its uint32
    array: int32 carriers are read as u32 words."""
    if fingerprint is None:
        return None
    fp = np.asarray(fingerprint)
    if fp.dtype == np.int32:
        fp = fp.view(np.uint32)
    return fp.astype(np.int64).tolist()


class CheckpointStore:
    def __init__(self, directory: str, compress: bool = False):
        self.dir = directory
        self.compress = compress
        os.makedirs(directory, exist_ok=True)
        self._pending: List[threading.Thread] = []
        self._lock = threading.Lock()

    # -- write ------------------------------------------------------------------

    def save(self, step: int, state, *, kind: str = "system",
             valid: Optional[bool] = None, fingerprint=None,
             async_: bool = False, extra: Optional[dict] = None,
             compress: Optional[bool] = None, snap=None) -> None:
        """Snapshot `state` (a tree of tensors) as version `step`. The copy
        to the host completes before this returns; with `async_` the
        serialization runs on a writer thread. `compress=True` stores each
        leaf via np.savez_compressed (the digests are of the content, so
        both forms carry the same digests). `snap`, a `snapshot(state)`
        already taken (digests None: computed on the writer thread), lets
        the tier hierarchy share one device-to-host copy among its
        tiers."""
        host, digests = snap if snap is not None else snapshot(state)
        man = Manifest(step=step, kind=kind, valid=valid,
                       fingerprint=_fingerprint_json(fingerprint),
                       n_leaves=len(host), extra=extra or {},
                       leaf_digests=digests)
        self._enqueue(step, host, man,
                      self.compress if compress is None else bool(compress),
                      async_)

    def _enqueue(self, step: int, host_leaves, man: Manifest,
                 compress: bool, async_: bool) -> None:
        if async_:
            t = threading.Thread(target=self._write,
                                 args=(step, host_leaves, man, compress),
                                 daemon=True)
            with self._lock:
                self._pending.append(t)
            t.start()
        else:
            self._write(step, host_leaves, man, compress)

    def _write(self, step: int, host_leaves, man: Manifest,
               compress: bool = False) -> None:
        final = os.path.join(self.dir, _ckpt_name(step))
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        if man.leaf_digests is None:
            man.leaf_digests = [_leaf_digest(arr) for arr in host_leaves]
        refs = man.leaf_refs or {}
        written = 0
        for i, arr in enumerate(host_leaves):
            if str(i) in refs:
                continue                    # delta: bytes live in the base
            written += _write_leaf(tmp, i, arr, compress)
        man.compressed = bool(compress)
        man.bytes_on_disk = written
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            f.write(man.to_json())
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)      # atomic commit

    def wait(self) -> None:
        """Barrier for async writes: returns only when every write issued
        before the call has committed (threads leave the pending list only
        after they were joined, so a second concurrent caller cannot return
        early)."""
        while True:
            with self._lock:
                pending = list(self._pending)
            if not pending:
                return
            for t in pending:
                t.join()
            with self._lock:
                self._pending = [t for t in self._pending if t.is_alive()]

    # -- read -------------------------------------------------------------------

    def steps(self) -> List[int]:
        # a read-path barrier: Algorithm 1 counts the versions, so one whose
        # async write is still in flight must be visible here
        self.wait()
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("ckpt_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def count(self) -> int:
        return len(self.steps())

    def manifest(self, step: int) -> Manifest:
        _note_disk_read("manifest")
        with open(os.path.join(self.dir, _ckpt_name(step),
                               "manifest.json")) as f:
            return Manifest.from_json(f.read())

    def latest(self, valid_only: bool = False) -> Optional[int]:
        for s in reversed(self.steps()):
            if not valid_only or self.manifest(s).valid:
                return s
        return None

    def restore(self, step: int, template) -> Any:
        """Rebuild version `step` in `template`'s structure: each leaf a
        tensor on its template leaf's device (the CPU for a non-tensor).
        Every leaf, a delta version's referenced ones too, is checked
        against THIS version's save-time digest; a mismatch raises
        `CheckpointCorruptionError`."""
        self.wait()
        man = self.manifest(step)
        tleaves = tree_util.leaves(template)
        if man.n_leaves != len(tleaves):
            raise ValueError(
                f"checkpoint {step} has {man.n_leaves} leaves, template has "
                f"{len(tleaves)}")
        refs = man.leaf_refs or {}
        out, card = [], []
        for i, t in enumerate(tleaves):
            src = os.path.join(self.dir, _ckpt_name(refs.get(str(i), step)))
            arr = _load_leaf(src, i)
            if tuple(arr.shape) != tuple(np.shape(t)):
                raise ValueError(f"leaf {i} shape {arr.shape} != "
                                 f"{tuple(np.shape(t))}")
            dev = t.device if isinstance(t, torch.Tensor) else None
            x = torch.from_numpy(arr)
            if dev is not None and dev.type == "cuda" \
                    and x.dtype in _WORD_DTYPES:
                x = x.to(dev)
                card.append(i)
            else:
                if man.leaf_digests is not None and \
                        _leaf_digest(arr) != man.leaf_digests[i]:
                    self._corrupt(step, i)
                if dev is not None:
                    x = x.to(dev)
            out.append(x)
        if card and man.leaf_digests is not None:
            fps = hostsync.read_scalar(leaf_fingerprints([out[i]
                                                          for i in card]),
                                       label="checkpoint_restore")
            for i, d in zip(card, _digest_words(fps)):
                if d != man.leaf_digests[i]:
                    self._corrupt(step, i)
        return tree_util.unflatten_like(template, out)

    @staticmethod
    def _corrupt(step: int, i: int):
        raise CheckpointCorruptionError(
            f"checkpoint {step} leaf {i}: content digest mismatch "
            f"(on-disk payload corrupted since save)")

    # -- delete / GC ------------------------------------------------------------

    def delete(self, step: int) -> None:
        self.wait()
        path = os.path.join(self.dir, _ckpt_name(step))
        if os.path.exists(path):
            shutil.rmtree(path)

    def delete_others_than(self, keep_step: int) -> None:
        for s in self.steps():
            if s != keep_step:
                self.delete(s)

    def gc_keep_last(self, n: int, keep_floor: Optional[int] = None) -> None:
        """Bounded-chain mode (SedarConfig.max_checkpoints > 0): keep the
        last n versions and the newest one at or below `keep_floor` (the
        last checkpoint older than every unvalidated step)."""
        if n <= 0:
            return
        steps = self.steps()
        keep = _gc_keep_set(steps, n, keep_floor)
        for s in steps:
            if s not in keep:
                self.delete(s)

    def clear(self) -> None:
        self.wait()
        for s in self.steps():
            self.delete(s)
