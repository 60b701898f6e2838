"""Cluster heartbeats and the elastic re-mesh planner (the reference's
`runtime/cluster.py`).

The paper's TOE detector generalizes to the host level: every host writes a
heartbeat file per step; a monitor flags hosts whose beat is stale (hang,
crash, TOE) and hosts whose step count lags the median (stragglers), and
publishes both into the telemetry stream (`repro_torch.obs`). `lanes_to_hosts`
names the hosts behind a fingerprint lane of the `pod` backend.

The planner shrinks the data axis past lost hosts (`plan_elastic_remesh`,
`elastic_restart`). Where the reference drops device planes from a device
mesh, the port drops ranks from a process mesh (`launch/mesh.py`):
`surviving_devices` returns the survivors' global ranks and `rebuild_mesh`
makes a `ProcessMesh` over them (a collective over the default group: every
rank calls it, and ranks outside the survivors get None). Host-side Python.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

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


@dataclass
class ElasticPlan:
    old_data: int
    new_data: int
    new_global_batch: int
    dropped_hosts: List[int]
    note: str


def plan_elastic_remesh(data_axis: int, global_batch: int,
                        lost_hosts: List[int], hosts_per_data_shard: int = 1
                        ) -> ElasticPlan:
    """Shrink the data axis past lost hosts, keeping the per-shard batch.

    Whole data shards that hold a lost host are dropped and the global batch
    shrinks with them, so every per-rank shape (activations, the compiled
    or cached kernels' shapes) stays as it was. A `global_batch` that does
    not divide `data_axis` is refused up front: flooring would change the
    per-shard batch the restart relies on."""
    if global_batch % data_axis:
        raise ValueError(
            f"global_batch {global_batch} is not divisible by data_axis "
            f"{data_axis}: the per-shard batch is undefined, so an elastic "
            f"re-mesh cannot preserve it (compile-cache reuse)")
    per_shard = global_batch // data_axis
    lost_shards = sorted({h // hosts_per_data_shard for h in lost_hosts})
    new_data = data_axis - len(lost_shards)
    if new_data < 1:
        raise RuntimeError("all data shards lost")
    return ElasticPlan(
        old_data=data_axis, new_data=new_data,
        new_global_batch=per_shard * new_data, dropped_hosts=lost_hosts,
        note=("per-shard batch preserved; data-axis collectives shrink; "
              "restore from last VALID checkpoint (L3) then continue"))


def data_axis_index(mesh_cfg, name: str = "data") -> int:
    """Position of the data axis in a MeshConfig, found BY NAME: on a
    ("pod", "data", ...) mesh the data axis is index 1, so `shape[0]` would
    shrink the replica axis."""
    try:
        return list(mesh_cfg.axis_names).index(name)
    except ValueError:
        raise ValueError(
            f"mesh axes {tuple(mesh_cfg.axis_names)} have no {name!r} axis "
            f"to shrink") from None


def surviving_devices(mesh, lost_shards: Sequence[int],
                      data_axis: str = "data") -> Tuple[tuple, List[int]]:
    """The survivors of a process mesh: its global ranks (in the mesh's
    (pod, data, ...) order) with the lost data shards dropped from every
    pod -> (new shape, survivor ranks), ready for `rebuild_mesh` with the
    same axis names. The order is kept, so shard i of the shrunken mesh is
    survivor i in the old order."""
    ranks = np.asarray(mesh.ranks).reshape(mesh.shape)
    ax = list(mesh.axis_names).index(data_axis)
    lost = set(int(s) for s in lost_shards)
    keep = [i for i in range(ranks.shape[ax]) if i not in lost]
    kept = np.take(ranks, keep, axis=ax)
    return tuple(int(s) for s in kept.shape), [int(r) for r in
                                               kept.reshape(-1)]


def rebuild_mesh(shape, axes, ranks: Optional[Sequence[int]] = None):
    """A `ProcessMesh` of `shape` over `ranks` (default: every rank). Every
    rank of the default group must call it; ranks outside `ranks` get
    None."""
    from repro_torch.configs import MeshConfig
    from repro_torch.launch.mesh import make_process_mesh
    return make_process_mesh(MeshConfig(shape=tuple(shape),
                                        axis_names=tuple(axes)),
                             ranks=ranks)


def elastic_restart(run_cfg, workdir: str, lost_hosts: List[int], *,
                    hosts_per_data_shard: int = 1, mesh=None, **trainer_kw):
    """Host-loss recovery: shrink the data axis past the lost hosts and
    build a trainer for the survivors (`core/policy.py::make_trainer`).

    Returns (plan, trainer). The trainer starts uninitialized: the caller
    restores the anchor (the last valid L3 checkpoint, typically from the
    partner tier) and adopts it through
    `trainer.engine.executor.adopt_single`; `runtime/elastic.py::
    ElasticTrainer` drives the whole shrink/regrow cycle. The config
    shrinks both the mesh shape and the global batch, so the per-shard
    batch is kept. `mesh` is the survivors' `ProcessMesh` on a mesh run."""
    from repro_torch.core.policy import make_trainer

    mesh_cfg = run_cfg.mesh
    ax = data_axis_index(mesh_cfg)
    plan = plan_elastic_remesh(mesh_cfg.shape[ax],
                               run_cfg.train.global_batch, lost_hosts,
                               hosts_per_data_shard=hosts_per_data_shard)
    new_shape = tuple(plan.new_data if i == ax else s
                      for i, s in enumerate(mesh_cfg.shape))
    new_cfg = dataclasses.replace(
        run_cfg, mesh=dataclasses.replace(mesh_cfg, shape=new_shape),
        train=dataclasses.replace(run_cfg.train,
                                  global_batch=plan.new_global_batch))
    return plan, make_trainer(new_cfg, workdir, mesh=mesh, **trainer_kw)
