"""Cluster heartbeats (the reference's `runtime/cluster.py`, its
heartbeat half).

The paper's TOE detector generalizes to the host level: every host writes a
heartbeat file per step; a monitor flags hosts whose beat is stale (hang,
crash, TOE) and hosts whose step count lags the median (stragglers), and
publishes both into the telemetry stream (`repro_torch.obs`). `lanes_to_hosts`
names the hosts behind a fingerprint lane of the `pod` backend. The
elastic re-mesh half of the reference's module (`ElasticPlan`,
`plan_elastic_remesh`, the mesh rebuild, `elastic_restart`) is not ported.
Host-side Python only.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch import obs


@dataclass
class HostState:
    host_id: int
    last_beat: float
    step: int


class Heartbeat:
    """Per-host heartbeat writer (one file per host, atomic replace).

    A heartbeat is advisory: a transient IO error (full disk, ENOENT race
    on a recycled workdir, NFS hiccup) must never take the train loop down,
    so `beat()` retries a bounded number of times and then gives up
    silently — a missed beat at worst makes the monitor flag this host a
    little earlier. Exhausted attempts are counted in `io_errors` (and the
    `cluster_heartbeat_io_errors_total` metric) so the flakiness is still
    visible."""

    def __init__(self, directory: str, host_id: int, *,
                 retries: int = 3, retry_wait_s: float = 0.01):
        self.dir = directory
        self.host_id = host_id
        self.retries = max(int(retries), 1)
        self.retry_wait_s = retry_wait_s
        self.io_errors = 0
        try:
            os.makedirs(directory, exist_ok=True)
        except OSError:
            self.io_errors += 1

    def beat(self, step: int) -> bool:
        path = os.path.join(self.dir, f"host_{self.host_id:05d}.json")
        tmp = path + ".tmp"
        for attempt in range(self.retries):
            try:
                # re-create the directory every attempt: a concurrent
                # cleanup may remove it between beats (the ENOENT race)
                os.makedirs(self.dir, exist_ok=True)
                with open(tmp, "w") as f:
                    json.dump({"host": self.host_id, "step": step,
                               "t": time.time()}, f)
                os.replace(tmp, path)
                return True
            except OSError:
                if attempt + 1 < self.retries and self.retry_wait_s > 0:
                    time.sleep(self.retry_wait_s)
        self.io_errors += 1
        if obs.metrics_enabled():
            obs.metrics.inc("cluster_heartbeat_io_errors_total",
                            host=self.host_id)
        return False


class ClusterMonitor:
    """Scans heartbeat files; reports stale hosts and stragglers."""

    def __init__(self, directory: str, n_hosts: int, timeout_s: float = 60.0,
                 straggler_factor: float = 2.0):
        self.dir = directory
        self.n_hosts = n_hosts
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor

    def scan(self) -> Dict[int, HostState]:
        """Best-effort read of every heartbeat file. Corrupted files
        (truncated writes, garbage, wrong JSON shape) and racing deletes
        are skipped — the host simply reads as missing/stale; a transient
        listdir failure gets one retry and then an empty scan rather than
        an exception into the caller's loop."""
        out: Dict[int, HostState] = {}
        if not os.path.isdir(self.dir):
            return out
        for attempt in range(2):
            try:
                names = os.listdir(self.dir)
                break
            except OSError:
                if attempt:
                    return out
                time.sleep(0.01)
        for name in names:
            if not name.startswith("host_") or not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.dir, name)) as f:
                    d = json.load(f)
                out[int(d["host"])] = HostState(int(d["host"]),
                                                float(d["t"]),
                                                int(d["step"]))
            except (json.JSONDecodeError, KeyError, OSError,
                    TypeError, ValueError):
                continue
        return out

    def stale_hosts(self, now: Optional[float] = None) -> List[int]:
        # `now or time.time()` would treat now=0.0 (a perfectly legal
        # simulated clock origin) as unset and silently substitute wall time
        now = time.time() if now is None else now
        seen = self.scan()
        stale = [h for h, s in seen.items() if now - s.last_beat > self.timeout_s]
        missing = [h for h in range(self.n_hosts) if h not in seen]
        return sorted(stale + missing)

    def stragglers(self) -> List[int]:
        """Hosts more than straggler_factor x slower than the median, i.e.
        whose step count has fallen below median / straggler_factor.

        A LARGER factor tolerates MORE lag before flagging (factor=2: flag
        below half the median progress; factor=10: only below a tenth). The
        previous formula used `med - step > med / factor`, which INVERTED
        that: raising the factor shrank the allowed lag and made detection
        more sensitive. A 2-step grace floor keeps early-run jitter (median
        of 1-2 steps) from flagging healthy hosts."""
        seen = self.scan()
        if len(seen) < 2:
            return []
        steps = sorted(s.step for s in seen.values())
        med = steps[len(steps) // 2]
        floor = med / self.straggler_factor
        return sorted(h for h, s in seen.items()
                      if med - s.step > 2 and s.step < floor)

    def publish(self, now: Optional[float] = None) -> Dict[str, object]:
        """One scan published into the observability stream: cluster-health
        gauges in the metrics registry (hosts seen / stale / stragglers,
        per-host step and heartbeat age) and a journaled heartbeat anomaly
        per stale host — so multi-host health lands in the SAME stream as
        fault events. Returns the summary it published."""
        now = time.time() if now is None else now
        seen = self.scan()
        stale = self.stale_hosts(now)
        strag = self.stragglers()
        m = obs.metrics
        if obs.metrics_enabled():
            m.set_gauge("cluster_hosts_seen", len(seen))
            m.set_gauge("cluster_hosts_expected", self.n_hosts)
            m.set_gauge("cluster_stale_hosts", len(stale))
            m.set_gauge("cluster_stragglers", len(strag))
            for h, s in seen.items():
                m.set_gauge("cluster_host_step", s.step, host=h)
                m.set_gauge("cluster_heartbeat_age_s",
                            max(0.0, now - s.last_beat), host=h)
        for h in stale:
            s = seen.get(h)
            # -1.0 = host never beat at all (no file to age)
            gap = (now - s.last_beat) if s is not None else -1.0
            obs.note_heartbeat_anomaly(h, gap, kind="stale")
        for h in strag:
            obs.note_heartbeat_anomaly(h, 0.0, kind="straggler")
        return {"seen": sorted(seen), "stale": stale, "stragglers": strag}


def lanes_to_hosts(lane_ids, hosts_per_data_shard: int = 1) -> List[int]:
    """Fingerprint lane -> hosts: lane i covers data shard i, and shard i
    is owned by hosts [i H, (i + 1) H)."""
    H = max(int(hosts_per_data_shard), 1)
    out: List[int] = []
    for lane in lane_ids:
        out.extend(range(int(lane) * H, (int(lane) + 1) * H))
    return out
