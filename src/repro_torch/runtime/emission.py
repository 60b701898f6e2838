"""Device-resident token emission ring and detokenize consumer (the
reference's `runtime/emission.py`).

Under deferred validation a token becomes visible truth only at a clean
flush, so emission moves to the flush cadence:

  * `TokenRing`   -- each deferred step PARKS its `(tok, pos)` device
                     tensors (the step's own outputs: no launch, no read)
                     with a host snapshot of the slot -> request owner map.
                     At a flush the ring hands the engine two stacked
                     tensors to read in the SAME `batched_get` as the
                     combined commit predicate.
  * rollback retraction -- a failed flush localizes `slot_first_bad`; the
                     ring marks the faulty slots' rows at or after their
                     first bad step dead before anything is delivered.
  * `DetokenizeConsumer` -- a bounded-queue worker thread: the server
                     submits drained batches and launches the next window;
                     the worker appends to the request streams. A full
                     queue blocks the server (backpressure); `quiesce()`
                     waits for the queue before any decision that reads
                     request streams.

The parked tensors must be ones no later step writes in place: the serving
loop replaces `tok` and `pos` with new tensors at every step, admission
and rollback (`runtime/serve.py`), and only the KV cache is written in
place. The consumer thread only ever sees numpy arrays and never touches
the device: every device read stays on the serving thread, in `hostsync`,
whose sync-debug toggle is process-wide.

Delivered-prefix property: `deliver_batch` appends a token only when its
position extends the stream by exactly one, so frozen slots, re-decoded
steps after a rollback and duplicate drains collapse to exactly-once
delivery per position.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import obs


class _Parked:
    """One decode tick's parked emission: device tensors + host bookkeeping."""

    __slots__ = ("step", "tok", "pos", "owners", "dead", "dead_all")

    def __init__(self, step: int, tok, pos, owners: Dict[int, Any]):
        self.step = int(step)
        self.tok = tok                  # (N, 1) device tensor
        self.pos = pos                  # (N,)  device tensor
        self.owners = owners            # slot -> Request (snapshot at park)
        self.dead: Set[int] = set()     # slots retracted by a failed flush
        self.dead_all = False           # scalar-predicate fallback


@dataclass
class DrainBatch:
    """One drained window, on the host: what the consumer thread walks."""

    steps: List[int]
    toks: np.ndarray                    # (W, N, 1)
    poss: np.ndarray                    # (W, N)
    owners: List[Dict[int, Any]]        # per-row slot -> Request
    dead: List[Set[int]]                # per-row retracted slots
    dead_all: List[bool]


class TokenRing:
    """Device-resident emission ring, drained at flush boundaries.

    The engine calls `park(step, aux)` inside the deferred step (before its
    own flush check, so a window's last token is never stranded past its
    flush), `provide(final=)` when assembling a flush read, `truncate` on a
    failed flush and `deliver` with the fetched host arrays. The serving loop owns
    `owners` (slot -> Request for the slots active this tick) and `sink`
    (usually `DetokenizeConsumer.submit`; by default `deliver_batch` on the
    calling thread)."""

    def __init__(self, cadence: int = 1,
                 sink: Optional[Callable[[DrainBatch], Any]] = None):
        self.cadence = max(int(cadence), 1)
        self.sink = sink if sink is not None else deliver_batch
        self.owners: Dict[int, Any] = {}
        self._entries: List[_Parked] = []
        self.parked = 0                 # cumulative rows parked
        self.drains = 0                 # drain batches issued

    def __len__(self) -> int:
        return len(self._entries)

    # -- engine-facing ------------------------------------------------------

    def park(self, step: int, aux) -> None:
        """Park one tick's emission tensors `aux = (tok, pos)`; `owners` is
        snapshotted so a later admission reusing the slot cannot reroute
        old rows."""
        tok, pos = aux
        self._entries.append(_Parked(step, tok, pos, dict(self.owners)))
        self.parked += 1

    def due(self, final: bool = False) -> bool:
        """Whether the parked rows are due for a drain: the run ends or the
        cadence is met."""
        return bool(self._entries) and (final
                                        or len(self._entries) >= self.cadence)

    def provide(self, final: bool = False,
                eager: bool = False) -> Optional[List[Any]]:
        """Tensors to read with the flush: `[toks, poss]` stacked over the
        parked window, or None while the drain cadence says keep parking (a
        sub-cadence flush still validates predicates; the rows ride along
        until the cadence fills or the run ends). `eager` also provides
        rows below the cadence while none of them is retracted."""
        if not self._entries:
            return None
        if not self.due(final) and not (eager and not any(
                e.dead or e.dead_all for e in self._entries)):
            return None
        return [torch.stack([e.tok for e in self._entries]),
                torch.stack([e.pos for e in self._entries])]

    def truncate(self, slot_first_bad: Optional[Dict[int, int]],
                 global_bad: Optional[int] = None) -> None:
        """Failed-flush retraction: mark faulty slots' rows at or after
        their first bad step dead. Applies only to rows parked so far —
        rows re-decoded after the rollback are new evidence."""
        for e in self._entries:
            if slot_first_bad:
                for slot, fb in slot_first_bad.items():
                    if e.step >= fb:
                        e.dead.add(int(slot))
            elif global_bad is not None and e.step >= global_bad:
                e.dead_all = True

    def deliver(self, vals: List[Any]) -> Optional[DrainBatch]:
        """Hand the fetched window to the sink and reset the ring. `vals`
        are the host arrays of the tensors `provide()` returned."""
        if not self._entries:
            return None
        batch = DrainBatch(
            steps=[e.step for e in self._entries],
            toks=np.asarray(vals[0]), poss=np.asarray(vals[1]),
            owners=[e.owners for e in self._entries],
            dead=[e.dead for e in self._entries],
            dead_all=[e.dead_all for e in self._entries])
        self._entries.clear()
        self.drains += 1
        obs.note_drain(len(batch.steps))
        self.sink(batch)
        return batch

    def clear(self) -> None:
        self._entries.clear()
        self.owners = {}


def deliver_batch(batch: DrainBatch,
                  on_token: Optional[Callable[..., None]] = None,
                  now: Optional[float] = None) -> Tuple[int, int]:
    """Walk one drained window in step order, appending each row's token to
    its owner request when the position extends the stream by exactly one.

    Dead rows count against the owner's `truncated_tokens` when they WOULD
    have extended the stream, tracked through a virtual length so a frozen
    slot's repeated position is counted once. Returns (delivered,
    retracted)."""
    stamp = time.time() if now is None else now
    delivered = retracted = 0
    virt: Dict[int, int] = {}           # id(req) -> len(tokens) + retracted
    for i in range(len(batch.steps)):
        owners, dead, dead_all = (batch.owners[i], batch.dead[i],
                                  batch.dead_all[i])
        for slot, req in owners.items():
            target = int(batch.poss[i, slot]) - req.pos0 + 1
            if dead_all or slot in dead:
                v = virt.get(id(req), len(req.tokens))
                if target == v + 1:
                    virt[id(req)] = v + 1
                    req.truncated_tokens += 1
                    retracted += 1
                continue
            if target == len(req.tokens) + 1:
                req.tokens.append(int(batch.toks[i, slot, 0]))
                req.token_times.append(stamp)
                virt[id(req)] = len(req.tokens)
                if on_token is not None:
                    on_token(req, req.tokens[-1], len(req.tokens) - 1)
                delivered += 1
    obs.note_tokens(delivered)
    return delivered, retracted


_STOP = object()


class DetokenizeConsumer:
    """Bounded-queue detokenize thread.

    The serving loop `submit()`s drained batches; the worker walks them with
    `deliver_batch` while the serving loop launches the next window. A full queue
    blocks `submit` (backpressure). `quiesce()` joins the queue — call it
    before reading request streams; `close()` stops the worker after
    everything queued and raises the first error the worker met."""

    def __init__(self, on_token: Optional[Callable[..., None]] = None,
                 max_queue: int = 8):
        self.on_token = on_token
        self._q: "queue.Queue" = queue.Queue(maxsize=max(int(max_queue), 1))
        self._thread: Optional[threading.Thread] = None
        self.delivered = 0
        self.retracted = 0
        self.batches = 0
        self.backlog_peak = 0
        self.errors: List[Exception] = []

    def start(self) -> "DetokenizeConsumer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="sedar-detokenize", daemon=True)
            self._thread.start()
        return self

    def submit(self, batch: DrainBatch) -> None:
        if self._thread is None:        # no thread started: deliver inline
            self._consume(batch)
            return
        self._q.put(batch)              # blocks when full: backpressure
        depth = self._q.qsize()
        self.backlog_peak = max(self.backlog_peak, depth)
        if obs.metrics_enabled():
            obs.metrics.set_gauge("sedar_serve_consumer_backlog", depth)

    def _consume(self, batch: DrainBatch) -> None:
        with obs.span("detokenize", rows=len(batch.steps)):
            d, r = deliver_batch(batch, self.on_token)
        self.delivered += d
        self.retracted += r
        self.batches += 1

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _STOP:
                    return
                self._consume(item)
            except Exception as exc:   # noqa: BLE001 — raised by close()
                self.errors.append(exc)
            finally:
                self._q.task_done()
                if obs.metrics_enabled():
                    obs.metrics.set_gauge("sedar_serve_consumer_backlog",
                                          self._q.qsize())

    def quiesce(self) -> None:
        """Block until every submitted batch has been delivered."""
        if self._thread is not None:
            self._q.join()

    def close(self) -> None:
        """Drain the queue, stop the worker, raise any worker error."""
        if self._thread is not None:
            self._q.put(_STOP)
            self._thread.join()
            self._thread = None
        if self.errors:
            raise self.errors[0]
