"""Host-sync accounting: every device->host read on the port's serving path
flows through here (the reference's `core/hostsync.py`).

`int(t)`, `.item()`, `bool(t)`, `.tolist()` and `.cpu()` on a CUDA tensor
each block the host until the device catches up. The engine and the server
never call them directly; they call `read_scalar` / `read_bool` /
`read_int` (one counted read) or `batched_get` (one counted batch of many
tensors: the copies are issued together and awaited once). A test wraps a
region in `count_transfers()` and asserts how many reads it made.

The counted reads also lift PyTorch's sync debug mode for their own copy,
so a run under `torch.cuda.set_sync_debug_mode("warn"|"error")` flags
exactly the reads that did NOT go through this module.

Counting is thread-local by default: a region counts the reads of the
thread that opened it. `count_transfers(cross_thread=True)` registers the
region on a process-wide, lock-protected list that every thread's reads
walk, so it also counts reads issued by other threads while it is open.
The detokenize consumer of continuous serving (`runtime/emission.py`) reads
nothing from the device: it walks host arrays the serving thread fetched.
Independent of either mode, when `repro_torch.obs.enable_metrics()` is on
every `_note` also fans into the process-wide registry through the
`_metrics_note` hook, which aggregates across threads.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch


@dataclass
class TransferStats:
    """Counts of device->host reads inside a `count_transfers` region."""

    transfers: int = 0          # individual tensors read back
    batches: int = 0            # read batches issued (1 per counted call)
    by_label: Dict[str, int] = field(default_factory=dict)

    def note(self, label: str, items: int = 1) -> None:
        self.transfers += items
        self.batches += 1
        self.by_label[label] = self.by_label.get(label, 0) + items


class _ActiveStats(threading.local):
    def __init__(self):
        self.stack: List[TransferStats] = []


_active = _ActiveStats()

# Cross-thread regions. The unguarded truthiness test in `_note` is a benign
# race: registration happens before the region's reads on the registering
# thread, and the lock serializes every mutation of the list and the stats.
_shared_lock = threading.Lock()
_shared: List[TransferStats] = []

# Process-wide metrics fan-in, installed by `repro_torch.obs.enable_metrics()`.
# None when metrics are off, so the disabled cost is one `is None` test.
_metrics_note: Optional[Callable[[str, int], None]] = None


@contextlib.contextmanager
def count_transfers(cross_thread: bool = False) -> Iterator[TransferStats]:
    """Count every device->host read this thread issues inside the block;
    with `cross_thread=True`, also the reads of every other thread while
    the block is open."""
    st = TransferStats()
    stack, lock = ((_shared, _shared_lock) if cross_thread
                   else (_active.stack, contextlib.nullcontext()))
    with lock:
        stack.append(st)
    try:
        yield st
    finally:
        with lock:
            stack.remove(st)


def _note(label: str, items: int = 1) -> None:
    for st in _active.stack:
        st.note(label, items)
    if _shared:
        with _shared_lock:
            for st in _shared:
                st.note(label, items)
    if _metrics_note is not None:
        _metrics_note(label, items)


@contextlib.contextmanager
def _sanctioned():
    """Lift the sync debug mode for one counted read."""
    if not torch.cuda.is_available():
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def read_scalar(x, label: str = "scalar") -> np.ndarray:
    """One counted read of a small tensor (predicate/counter/row)."""
    _note(label)
    with _sanctioned():
        return _to_numpy(x)


def read_bool(x, label: str = "predicate") -> bool:
    return bool(read_scalar(x, label=label))


def read_int(x, label: str = "counter") -> int:
    return int(read_scalar(x, label=label))


def batched_get(leaves: Sequence[Any], label: str = "batch") -> List[np.ndarray]:
    """ONE read batch for a list of tensors: every device->host copy is
    issued without waiting, then the host waits once."""
    leaves = list(leaves)
    _note(label, items=len(leaves))
    with _sanctioned():
        host = [l.detach().to("cpu", non_blocking=True)
                if isinstance(l, torch.Tensor) else l for l in leaves]
        if any(isinstance(l, torch.Tensor) and l.is_cuda for l in leaves):
            torch.cuda.synchronize()
        return [_to_numpy(h) for h in host]
