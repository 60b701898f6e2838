"""Continuous-batching request scheduler for protected serving (the
reference's `runtime/scheduler.py`). Pure Python and numpy, host side:

  * `Request`       -- one generation request's lifecycle record: prompt,
                       budget, arrival tick, emitted tokens with wall-clock
                       stamps, and the slot and recovery bookkeeping (admit
                       step, finish step, truncation count, rejection
                       reason).
  * `RequestQueue`  -- bounded FIFO admission queue; a full queue rejects
                       the offered request at once (backpressure).
  * `SlotScheduler` -- maps requests onto the packed batch's decode slots;
                       a freed slot is refilled by the next queued prompt
                       on the same decode tick.

Slot lifecycle:   FREE -> RUNNING -> DRAINING -> FREE
                            ^           |
                            +-- rollback reactivation (a deferred fault hit
                                the request's final window)

DRAINING exists because of deferred validation: a request that reaches its
token budget inside the optimistic window keeps its slot (decode frozen by
the active mask) until the validated frontier passes its finish step.

`synthetic_requests` is the seeded open-loop traffic replay; the latency
helpers report TTFT, inter-token gaps and time to the last token with the
nearest-rank `percentile`. The reference's metrics-registry calls are left
out (telemetry is ported separately).
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# Request lifecycle states
PENDING = "pending"      # created, not yet arrived
QUEUED = "queued"        # in the admission queue
RUNNING = "running"      # owns a slot, decoding
DRAINING = "draining"    # token budget reached, awaiting validation
DONE = "done"
REJECTED = "rejected"


def percentile(values: Iterable[float], q: float) -> float:
    """Nearest-rank percentile: rank = ceil(q/100 * N) clamped to [1, N] of
    the sorted values (numpy's method="inverted_cdf"); 0.0 when empty."""
    vals = sorted(values)
    if not vals:
        return 0.0
    n = len(vals)
    rank = math.ceil((float(q) / 100.0) * n)
    return float(vals[min(max(rank, 1), n) - 1])


@dataclass
class Request:
    """One generation request and its lifecycle record."""

    rid: int
    prompt: np.ndarray                    # (L,) int32 token ids
    max_new_tokens: int
    arrival: int = 0                      # decode tick of arrival (open loop)
    arrival_time: Optional[float] = None  # wall stamp at queue offer (TTFT)
    status: str = PENDING
    slot: Optional[int] = None
    tokens: List[int] = field(default_factory=list)
    token_times: List[float] = field(default_factory=list)  # wall stamps
    pos0: int = 0                         # decode position of the 1st token
    admit_step: Optional[int] = None
    finish_step: Optional[int] = None
    truncated_tokens: int = 0             # rolled back + re-decoded
    reject_reason: str = ""

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return self.status in (DONE, REJECTED)


class RequestQueue:
    """Bounded FIFO with admission control. `max_depth=0` disables the
    bound (accept everything)."""

    def __init__(self, max_depth: int = 0):
        self.max_depth = int(max_depth)
        self._q: deque = deque()
        self.rejected: List[Request] = []

    def __len__(self) -> int:
        return len(self._q)

    def offer(self, req: Request) -> bool:
        """Enqueue, or shed load: a full queue rejects the request now
        (status=rejected, reason=backpressure)."""
        if self.max_depth and len(self._q) >= self.max_depth:
            req.status = REJECTED
            req.reject_reason = "backpressure"
            self.rejected.append(req)
            return False
        req.status = QUEUED
        self._q.append(req)
        return True

    def pop(self) -> Optional[Request]:
        return self._q.popleft() if self._q else None


class SlotScheduler:
    """Slot ownership and lifecycle over the packed decode batch."""

    def __init__(self, n_slots: int, queue: Optional[RequestQueue] = None):
        self.n_slots = int(n_slots)
        # `queue or ...` would discard an EMPTY bounded queue (falsy)
        self.queue = RequestQueue() if queue is None else queue
        self.slots: List[Optional[Request]] = [None] * self.n_slots

    # -- queries ---------------------------------------------------------------

    def request(self, slot: int) -> Optional[Request]:
        return self.slots[slot]

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def items(self, status: str) -> List[Tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.slots)
                if r is not None and r.status == status]

    def running_items(self) -> List[Tuple[int, Request]]:
        return self.items(RUNNING)

    def draining_items(self) -> List[Tuple[int, Request]]:
        return self.items(DRAINING)

    @property
    def busy(self) -> bool:
        return any(r is not None for r in self.slots)

    # -- transitions -----------------------------------------------------------

    def admit(self, step: int) -> List[Tuple[int, Request]]:
        """Pair every free slot with the next queued request (FIFO). The
        caller prefills each pair into the packed state."""
        pairs: List[Tuple[int, Request]] = []
        for slot in self.free_slots():
            req = self.queue.pop()
            if req is None:
                break
            req.slot = slot
            req.status = RUNNING
            req.admit_step = step
            self.slots[slot] = req
            pairs.append((slot, req))
        return pairs

    def drain(self, slot: int, finish_step: int) -> None:
        req = self.slots[slot]
        req.status = DRAINING
        req.finish_step = finish_step

    def reactivate(self, slot: int) -> None:
        """Rollback reached into a draining request's final window: it
        resumes decoding its truncated tail."""
        req = self.slots[slot]
        req.status = RUNNING
        req.finish_step = None

    def release(self, slot: int) -> Request:
        req = self.slots[slot]
        req.status = DONE
        req.slot = None
        self.slots[slot] = None
        return req

    def reject(self, slot: int, reason: str) -> Request:
        req = self.slots[slot]
        req.status = REJECTED
        req.reject_reason = reason
        req.slot = None
        self.slots[slot] = None
        return req


# ---------------------------------------------------------------------------
# Open-loop traffic replay
# ---------------------------------------------------------------------------

def synthetic_requests(n: int, *, arrival_rate: float = 1.0,
                       prompt_lengths: Sequence[int] = (4, 8),
                       length_weights: Optional[Sequence[float]] = None,
                       max_new_choices: Sequence[int] = (4, 12),
                       vocab: int = 200, seed: int = 0) -> List[Request]:
    """Seeded open-loop workload: `n` requests with exponential inter-
    arrival gaps at `arrival_rate` requests per decode tick, prompt lengths
    drawn from the categorical mix, and per-request decode budgets from
    `max_new_choices`. The same seed gives the reference's requests."""
    rs = np.random.RandomState(seed)
    if length_weights is not None:
        w = np.asarray(length_weights, np.float64)
        w = w / w.sum()
    else:
        w = None
    out: List[Request] = []
    t = 0.0
    for rid in range(n):
        if rid:
            t += rs.exponential(1.0 / max(arrival_rate, 1e-9))
        L = int(rs.choice(list(prompt_lengths), p=w))
        out.append(Request(
            rid=rid,
            prompt=rs.randint(0, vocab, (L,)).astype(np.int32),
            max_new_tokens=int(rs.choice(list(max_new_choices))),
            arrival=int(t)))
    return out


def token_latencies(requests: Iterable[Request]) -> List[float]:
    """Per-token inter-token gaps across a request set."""
    out: List[float] = []
    for r in requests:
        ts = r.token_times
        out.extend(b - a for a, b in zip(ts, ts[1:]))
    return out


def ttft_latencies(requests: Iterable[Request]) -> List[float]:
    """Time to first token per request: the first token's wall stamp minus
    the arrival stamp cut at queue offer. Requests that never emitted are
    left out."""
    out: List[float] = []
    for r in requests:
        if r.arrival_time is not None and r.token_times:
            out.append(r.token_times[0] - r.arrival_time)
    return out


def ttlt_latencies(requests: Iterable[Request]) -> List[float]:
    """Time to the last token per request (the whole stream's turnaround)."""
    out: List[float] = []
    for r in requests:
        if r.arrival_time is not None and r.token_times:
            out.append(r.token_times[-1] - r.arrival_time)
    return out


def _p50_p99_ms(lat: List[float]) -> Tuple[float, float]:
    if not lat:
        return 0.0, 0.0
    return 1e3 * percentile(lat, 50), 1e3 * percentile(lat, 99)


def ttft_percentiles_ms(requests: Iterable[Request]) -> Tuple[float, float]:
    """(p50, p99) time to first token in ms ((0, 0) when none emitted)."""
    return _p50_p99_ms(ttft_latencies(requests))


def latency_percentiles_ms(requests: Iterable[Request]
                           ) -> Tuple[float, float]:
    """(p50, p99) inter-token latency in ms ((0, 0) below two tokens)."""
    return _p50_p99_ms(token_latencies(requests))


def ttlt_percentiles_ms(requests: Iterable[Request]) -> Tuple[float, float]:
    """(p50, p99) time to the last token in ms."""
    return _p50_p99_ms(ttlt_latencies(requests))


def stream_stats_ms(requests: Iterable[Request]) -> Dict[str, float]:
    """TTFT, inter-token gap and time to the last token, p50 and p99 in ms."""
    reqs = list(requests)
    ttft50, ttft99 = ttft_percentiles_ms(reqs)
    itl50, itl99 = latency_percentiles_ms(reqs)
    ttlt50, ttlt99 = ttlt_percentiles_ms(reqs)
    return {"ttft_p50_ms": ttft50, "ttft_p99_ms": ttft99,
            "itl_p50_ms": itl50, "itl_p99_ms": itl99,
            "ttlt_p50_ms": ttlt50, "ttlt_p99_ms": ttlt99}
