"""Detection machinery (the reference's `core/detection.py`): the detection
event, the L1 safe-stop exception, the TOE watchdog (paper Sec. 3.1) and the
pod-axis comparators of the mesh backends.

Pod-axis comparison: the replicas are processes (`launch/mesh.py`), and a
fingerprint is compared over the pod group of this rank's data index with
`torch.distributed` collectives, each through `hostsync.collective`. No
comparator reads a device tensor back: each returns device tensors, and
the executor's counted reads (`commit_compare`, `state_validate`, `fp_all`,
`commit_lanes`, `deferred_flush`) are the only ones.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.core import hostsync


@dataclass
class DetectionEvent:
    step: int
    boundary: str            # commit | validate | toe | final
    effect: str = ""         # TDC | FSC | TOE (classification, best effort)
    detail: Dict[str, Any] = field(default_factory=dict)

    def __str__(self):
        return (f"[SEDAR] fault detected at step {self.step} "
                f"(boundary={self.boundary}{', ' + self.effect if self.effect else ''})")


class SedarSafeStop(RuntimeError):
    """L1: notification + safe stop (paper Sec. 3.1)."""

    def __init__(self, event: DetectionEvent):
        super().__init__(str(event))
        self.event = event


# ---------------------------------------------------------------------------
# Pod-axis comparison (collectives over the pod group)
# ---------------------------------------------------------------------------

def make_pod_comparator(mesh) -> Callable:
    """Returns fn(fp) -> (all_equal: 0-d bool, fp_all: (n_pods, ...)).

    The gather is an all_reduce SUM over a zeroed (n_pods, ...) buffer of
    int32 words with this pod's row written: every other row adds zeros, so
    the sum is exact and every pod holds every pod's fingerprint."""

    def compare(fp: torch.Tensor):
        fp_all = fp.new_zeros((mesh.n_pods,) + tuple(fp.shape))
        fp_all[mesh.pod].copy_(fp)
        with hostsync.collective("fp_gather", (mesh.n_pods - 1)
                                 * fp_all[0].numel() * fp.element_size()):
            dist.all_reduce(fp_all, group=mesh.pod_group)
        return torch.all(fp_all[..., :2] == fp_all[:1, ..., :2]), fp_all

    return compare


def lanes_equal(fp_all: torch.Tensor) -> torch.Tensor:
    """(n_pods, L, 4) gathered lanes -> (L,) bool: every pod's hash words
    of lane i equal pod 0's."""
    return torch.all(torch.all(fp_all[..., :2] == fp_all[:1, ..., :2],
                               dim=-1), dim=0)


def make_lane_comparator(mesh) -> Callable:
    """Per-lane replica agreement by reductions: fn(fp_lanes (L, 4)) -> (L,)
    bool, lane i True iff every replica agrees on its hash words (max ==
    min over the pod group). One all_reduce MAX over [h, -h] widened to
    int64 gives the max and (negated) the min exactly: the hot path moves
    O(L) words and never forms the (n_pods, L, 4) matrix."""

    def compare(fp_lanes: torch.Tensor) -> torch.Tensor:
        h = fp_lanes[..., :2].to(torch.int64)
        both = torch.stack([h, -h])
        with hostsync.collective("lane_compare"):
            dist.all_reduce(both, op=dist.ReduceOp.MAX, group=mesh.pod_group)
        return torch.all(both[0] == -both[1], dim=-1)

    return compare


def make_pod_broadcaster(mesh) -> Callable:
    """N-modular redundancy's forward correction: returns make(src) ->
    bcast(tree), which copies pod `src`'s state into every pod's, leaf by
    leaf in place (`dist.broadcast` over the pod group: the bits as they
    are, where the reference's masked psum turns a -0.0 into +0.0). `src`
    is a host int (the majority vote's)."""

    def make(src: int):
        def bcast(tree):
            root = mesh.pod_rank(int(src))
            for x in tree_util.leaves(tree):
                if isinstance(x, torch.Tensor):
                    with hostsync.collective("vote_broadcast"):
                        dist.broadcast(x, src=root, group=mesh.pod_group)
            return tree
        return bcast

    return make


def majority_replica(fp_all) -> "tuple[int, bool]":
    """Host-side majority vote over gathered fingerprints ((n_replicas, 4)
    whole-state, or (n_replicas, L, 4)) -> (src replica, ok), ok False
    when no strict majority exists."""
    fp_all = np.asarray(fp_all)
    n = fp_all.shape[0]
    keys = [fp_all[i].reshape(-1, 4)[:, :2].tobytes() for i in range(n)]
    best, count = None, 0
    for i, k in enumerate(keys):
        c = keys.count(k)
        if c > count:
            best, count = i, c
    return best, count > n // 2


def make_pod_injector(mesh, spec) -> Callable:
    """Returns fn(tree, step, armed) that flips spec's bit only on the ranks
    of pod `spec.replica`, at `spec.step` (a physical divergence of a
    logically replicated tree)."""
    from repro_torch.core.injection import inject_tree

    def apply(tree, step: int, armed: bool):
        return inject_tree(tree, spec, step=step, replica_id=mesh.pod,
                           armed=armed)

    return apply


class Watchdog:
    """Per-replica heartbeat monitor: `check()` flags replicas whose last
    beat is older than `timeout_s` (the paper's configurable-lapse TOE
    detector)."""

    def __init__(self, timeout_s: float, n_replicas: int = 2):
        self.timeout_s = timeout_s
        self.last_beat: Dict[int, float] = {r: time.monotonic()
                                            for r in range(n_replicas)}
        self.step_time: Dict[int, float] = {}
        # per-replica wall-clock separation needs a device sync after each
        # replica launch; executors only pay it while the watchdog is armed
        self.armed: bool = False

    def arm(self) -> None:
        self.armed = True

    def disarm(self) -> None:
        self.armed = False

    def beat(self, replica: int, step: int) -> None:
        now = time.monotonic()
        prev = self.last_beat.get(replica, now)
        self.last_beat[replica] = now
        self.step_time[replica] = now - prev

    def stale(self) -> List[int]:
        now = time.monotonic()
        return [r for r, t in self.last_beat.items()
                if now - t > self.timeout_s]

    def skew(self) -> float:
        """Max pairwise difference of last-beat times (replica flow
        separation)."""
        ts = list(self.last_beat.values())
        return max(ts) - min(ts) if len(ts) > 1 else 0.0

    def check(self, step: int) -> Optional[DetectionEvent]:
        bad = self.stale()
        if bad:
            return DetectionEvent(step=step, boundary="toe", effect="TOE",
                                  detail={"stale_replicas": bad,
                                          "timeout_s": self.timeout_s})
        return None
