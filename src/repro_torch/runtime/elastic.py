"""Elastic fail-in-place training across node loss (the reference's
`runtime/elastic.py`, DESIGN.md §16).

`ElasticTrainer` wraps a SEDAR-protected trainer in a cluster-health loop:
train a segment, scan the heartbeat directory, and on a stale host run the
shrink/regrow protocol instead of dying:

  shrink  — consult `policy.choose_degraded_mode` (the temporal model's
            restart-vs-fail-in-place cost terms). Fail-in-place drops the
            lost data shards (`cluster.py::plan_elastic_remesh`, the
            per-shard batch kept), drops the volatile checkpoint rings
            (they lived in the failed topology's memory), restores the last
            validated L3 anchor from the durable tiers (the partner store
            when configured) onto the survivors, and trains on in a SIDE
            workdir (`degraded_{n}`).
  regrow  — when every lost host beats again, the original full-width
            trainer (kept alive) restores the SAME anchor from its own
            store and replays at full width.

The authoritative trajectory is the full-width one from the last validated
checkpoint: the data pipeline is a pure function of (seed, step) and the
step is deterministic, so the regrown run ends bitwise equal to an
uninterrupted run at the same seed. The degraded segments are best effort:
they keep training through the outage and are discarded on regrow.

Two ways to run:

  * in one process (`mesh=None`), as the reference's `tests/test_elastic.py`
    and the launcher's `--elastic`: the shrink rewrites the config (data
    axis and global batch) and builds the degraded trainer beside the
    original one;
  * on the process mesh of `pod` (`mesh=` a `launch/mesh.py::ProcessMesh`
    over every rank, one process per (pod, data) rank). Every rank runs the
    same `run` loop and every decision comes out of a collective over the
    default (world) group, so the ranks stay in lockstep: global rank 0
    ticks, scans the heartbeats and broadcasts the stale set; the active
    mesh's first rank broadcasts the step and the stop flag after each
    segment. At a shrink every rank joins the survivors' group creation
    (`cluster.py::rebuild_mesh`); each survivor restores the anchor from
    its own original trainer's durable tiers (`workdir/rank{r}`) and the
    degraded trainer writes under `degraded_{n}/rank{r}`. A "lost" rank
    stays alive: it restores nothing at the shrink (its shrink record has
    `restore_tier=None`), sits out the degraded segments, waits at the next
    scan and restores the anchor at the regrow.

Node loss is simulated by heartbeats, as in the reference, where a JAX
device cannot die either. A real process death, which would need a
rendezvous restart of the process group, is out of scope here as it is
there.

Every transition is journaled as a recovery record with
`kind="elastic_remesh"`, so `obs.kpi.compute_kpis` picks up the node-loss
downtime and the discarded work.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.core import hostsync
from repro_torch.core import temporal_model as tm
from repro_torch.core.policy import (DegradedModeDecision,
                                     choose_degraded_mode, make_trainer)
from repro_torch.runtime.cluster import (ClusterMonitor, elastic_restart,
                                         plan_elastic_remesh, rebuild_mesh,
                                         surviving_devices)


@dataclass
class RemeshRecord:
    """One shrink/regrow/safe-stop transition of the elastic cycle."""

    phase: str                    # shrink | regrow | safe_stop
    trigger_step: int             # host-side step when the scan fired
    restore_step: Optional[int]   # anchor checkpoint version (None = scratch)
    restore_tier: Optional[str]   # tier the anchor came back from
    hosts: List[int]              # hosts lost (shrink) / returned (regrow)
    old_data: int
    new_data: int
    old_batch: int
    new_batch: int
    downtime_s: float             # wall time training was paused
    mode: str                     # fail_in_place | safe_stop
    protection_lost: bool = False

    def as_recovery_record(self) -> Dict[str, Any]:
        """The journal/KPI view: `at - step` is the work this transition
        discarded (the engine's rollback convention), so redone work and
        availability fall out of `compute_kpis`."""
        return {"kind": "elastic_remesh", "phase": self.phase,
                "step": self.restore_step if self.restore_step is not None
                else self.trigger_step,
                "at": self.trigger_step, "rollbacks": 0,
                "hosts": list(self.hosts),
                "old_data": self.old_data, "new_data": self.new_data,
                "tier": self.restore_tier,
                "downtime_s": self.downtime_s, "mode": self.mode}


@dataclass
class ElasticReport:
    """Aggregate of every training segment plus the remesh transitions."""

    steps_completed: int = 0
    remeshes: List[RemeshRecord] = field(default_factory=list)
    decisions: List[DegradedModeDecision] = field(default_factory=list)
    segments: List[Any] = field(default_factory=list)   # TrainReports
    stopped: bool = False
    completed_degraded: bool = False
    final_state_fp: Any = None
    wall_s: float = 0.0

    @property
    def detections(self):
        return [d for seg in self.segments for d in seg.detections]

    @property
    def recoveries(self):
        return [r for seg in self.segments for r in seg.recoveries]

    def node_loss_downtime_s(self) -> float:
        return sum(r.downtime_s for r in self.remeshes)

    def summary(self) -> str:
        phases = [r.phase for r in self.remeshes]
        return (f"steps={self.steps_completed} remeshes={phases} "
                f"downtime={self.node_loss_downtime_s():.3f}s "
                f"stopped={self.stopped} degraded={self.completed_degraded}")


class ElasticTrainer:
    """Drive a SEDAR trainer through node loss without a full restart.

    Requires SEDAR level 3: the shrink anchor must be a VALIDATED
    checkpoint (restoring an unvalidated one onto the survivors would carry
    a silent corruption into the post-remesh trajectory).

    `clock` and `tick` exist for deterministic runs: `tick(step)` runs
    before every scan (simulated hosts beat there) and `clock()` supplies
    the scan's "now"; on a process mesh only global rank 0 calls them.
    `mesh` is the pod backend's `ProcessMesh` over every rank, made by the
    caller on each rank (`launch/mesh.py::make_process_mesh`).
    """

    def __init__(self, run_cfg, workdir: str, *,
                 monitor: Optional[ClusterMonitor] = None,
                 n_hosts: Optional[int] = None,
                 hosts_per_data_shard: int = 1,
                 replica_hosts: Sequence[int] = (),
                 scan_interval: int = 2,
                 mesh=None,
                 params: Optional[tm.SedarParams] = None,
                 mtbe_hours: float = 1000.0,
                 outage_hours: float = 0.1,
                 sdc_risk_budget: float = 1.0,
                 clock: Callable[[], float] = time.time,
                 tick: Optional[Callable[[int], None]] = None,
                 **trainer_kw):
        if run_cfg.sedar.level < 3:
            raise ValueError(
                "ElasticTrainer requires SEDAR level 3: the remesh anchor "
                "must be a validated checkpoint (L3), or a silent fault "
                "could ride the restore onto the survivors")
        self.cfg = run_cfg
        self.workdir = workdir
        self.mesh = mesh
        self.hosts_per_data_shard = max(int(hosts_per_data_shard), 1)
        self.replica_hosts = set(int(h) for h in replica_hosts)
        self.scan_interval = max(int(scan_interval), 1)
        self.params = params or tm.SedarParams(
            T_prog=1.0, T_comp=0.01, T_rest=0.1, f_d=0.02,
            t_cs=0.01, t_ca=0.005, T_compA=0.01, t_i=0.25)
        self.mtbe_hours = mtbe_hours
        self.outage_hours = outage_hours
        self.sdc_risk_budget = sdc_risk_budget
        self.clock = clock
        self.tick = tick
        self.trainer_kw = dict(trainer_kw)
        hb_dir = os.path.join(workdir, "heartbeats")
        self.monitor = monitor or ClusterMonitor(
            hb_dir, n_hosts if n_hosts is not None else 1)
        self.trainer = make_trainer(
            run_cfg, workdir, mesh=mesh,
            hosts_per_data_shard=self.hosts_per_data_shard,
            **self.trainer_kw)
        self._degraded = None       # (trainer, mesh) during an outage
        self._degraded_count = 0
        self._lost: set = set()
        # the global ranks that train: the mesh's, or the survivors'
        self._active_ranks = list(mesh.ranks) if mesh is not None else None

    # -- lockstep over the process mesh --------------------------------------

    def _scan(self, step) -> set:
        """The stale hosts: this process's scan, or on a process mesh rank
        0's, broadcast over the world group."""
        lead = self.mesh is None or dist.get_rank() == 0
        stale: set = set()
        if lead:
            if self.tick is not None:
                self.tick(step)
            stale = set(self.monitor.stale_hosts(self.clock()))
        if self.mesh is None:
            return stale
        box = [sorted(stale)]
        with hostsync.collective("elastic_scan"):
            dist.broadcast_object_list(box, src=0)
        return set(box[0])

    def _share_progress(self, step, stopped: bool):
        """(step, stopped) of the active mesh's first rank, on every rank
        (the dark ranks sit the degraded segments out)."""
        if self.mesh is None:
            return step, stopped
        t = torch.tensor([int(step or 0), int(stopped)], dtype=torch.int64)
        with hostsync.collective("elastic_progress"):
            dist.broadcast(t, src=self._active_ranks[0])
        return int(t[0]), bool(t[1])

    # -- anchor restore ------------------------------------------------------

    def _anchor(self):
        """(version, recovery) of the last validated full-width checkpoint
        in the ORIGINAL store: the authoritative trajectory's re-entry
        point for both shrink and regrow."""
        rec = self.trainer.recovery
        tiers = getattr(rec, "tiers", None)
        if tiers is not None:
            tiers.wait()
            return tiers.latest_valid(), rec
        store = getattr(rec, "store", None)
        if store is not None:
            store.wait()
            return store.latest(valid_only=True), rec
        return None, rec

    def _restore_onto(self, trainer, version, rec):
        """Restore anchor `version` from the full run's recovery stores and
        adopt it into `trainer`'s executor. Returns (dual, tier name)."""
        if version is None:
            return None, None
        template = trainer.init_state()
        tiers = getattr(rec, "tiers", None)
        if tiers is not None:
            state, info = tiers.restore(version, template)
            tier = info.get("tier")
        else:
            state = rec.store.restore(version, template)
            tier = "disk"
        del template
        return trainer.engine.executor.adopt_single(state), tier

    # -- transitions ---------------------------------------------------------

    def _decide(self, lost: set) -> DegradedModeDecision:
        return choose_degraded_mode(
            self.params, self.mtbe_hours, self.outage_hours,
            protection_lost=bool(self.replica_hosts & lost),
            sdc_risk_budget=self.sdc_risk_budget)

    def _full_data(self) -> int:
        return self.cfg.mesh.shape[self._data_ax()] \
            if "data" in self.cfg.mesh.axis_names else 1

    def _shrink(self, lost: set, step: int, report: ElasticReport):
        """Node loss: decide, then either park (safe_stop) or rebuild a
        degraded trainer on the survivors from the validated anchor.
        Returns (trainer, dual); (None, None) on a rank outside the
        survivors."""
        t0 = time.monotonic()
        decision = self._decide(lost)
        report.decisions.append(decision)
        old_data = self._full_data()
        batch = self.cfg.train.global_batch
        if decision.mode == "safe_stop":
            rr = RemeshRecord(
                phase="safe_stop", trigger_step=step, restore_step=None,
                restore_tier=None, hosts=sorted(lost), old_data=old_data,
                new_data=old_data, old_batch=batch, new_batch=batch,
                downtime_s=time.monotonic() - t0, mode="safe_stop",
                protection_lost=decision.protection_lost)
            self._journal(rr, report)
            report.stopped = True
            return None, None
        anchor, rec = self._anchor()
        # the failed topology takes the volatile rings with it: the restore
        # can only be served by the durable tiers (disk / partner)
        tiers = getattr(rec, "tiers", None)
        if tiers is not None:
            tiers.drop_volatile()
        gc.collect()
        self._degraded_count += 1
        side = os.path.join(self.workdir,
                            f"degraded_{self._degraded_count}")
        protection_lost = bool(self.replica_hosts & lost)
        if protection_lost:
            # the replica pod died: the survivors run unprotected but
            # checkpointed at full data width (the policy's degraded mode)
            deg_mesh = self._degraded_mesh(set(), drop_replica=True)
            trainer = None
            if self.mesh is None or deg_mesh is not None:
                deg_cfg = dataclasses.replace(
                    self.cfg, sedar=dataclasses.replace(
                        self.cfg.sedar, replication="none"))
                if deg_mesh is not None:
                    deg_cfg = dataclasses.replace(
                        deg_cfg, mesh=dataclasses.replace(
                            self.cfg.mesh, shape=deg_mesh.shape,
                            axis_names=deg_mesh.axis_names))
                trainer = make_trainer(deg_cfg, side, mesh=deg_mesh,
                                       **self.trainer_kw)
            new_data, new_batch = old_data, batch
        else:
            shards = sorted({h // self.hosts_per_data_shard for h in lost})
            deg_mesh = self._degraded_mesh(shards)
            if self.mesh is None or deg_mesh is not None:
                plan, trainer = elastic_restart(
                    self.cfg, side, sorted(lost),
                    hosts_per_data_shard=self.hosts_per_data_shard,
                    mesh=deg_mesh, **self.trainer_kw)
            else:
                trainer = None
                plan = plan_elastic_remesh(
                    old_data, batch, sorted(lost),
                    hosts_per_data_shard=self.hosts_per_data_shard)
            new_data, new_batch = plan.new_data, plan.new_global_batch
        dual = tier = None
        if trainer is not None:
            dual, tier = self._restore_onto(trainer, anchor, rec)
        rr = RemeshRecord(
            phase="shrink", trigger_step=step, restore_step=anchor,
            restore_tier=tier, hosts=sorted(lost), old_data=old_data,
            new_data=new_data, old_batch=batch, new_batch=new_batch,
            downtime_s=time.monotonic() - t0, mode="fail_in_place",
            protection_lost=protection_lost)
        self._journal(rr, report)
        self._degraded = (trainer, deg_mesh)
        return trainer, dual

    def _regrow(self, returned: set, step: int, report: ElasticReport):
        """Every lost host is back: re-anchor the kept-alive full-width
        trainer and replay from the anchor."""
        t0 = time.monotonic()
        # the degraded trainer and its state go first (a trainer and its
        # engine refer to each other: only the collector frees them)
        self._degraded = None
        gc.collect()
        anchor, rec = self._anchor()
        dual, tier = self._restore_onto(self.trainer, anchor, rec)
        full_data = self._full_data()
        shrinks = [r for r in report.remeshes if r.phase == "shrink"]
        rr = RemeshRecord(
            phase="regrow", trigger_step=step, restore_step=anchor,
            restore_tier=tier, hosts=sorted(returned),
            old_data=shrinks[-1].new_data if shrinks else full_data,
            new_data=full_data, old_batch=self.cfg.train.global_batch,
            new_batch=self.cfg.train.global_batch,
            downtime_s=time.monotonic() - t0, mode="fail_in_place")
        self._journal(rr, report)
        return self.trainer, dual

    def _data_ax(self) -> int:
        names = list(self.cfg.mesh.axis_names)
        return names.index("data") if "data" in names else 0

    def _degraded_mesh(self, lost_shards, drop_replica: bool = False):
        """The survivors' process mesh (None in one process, and on a rank
        outside the survivors); every rank of the mesh calls it. Sets the
        active ranks."""
        if self.mesh is None:
            return None
        if drop_replica:
            # the first pod's ranks, at full data width
            grid = np.asarray(self.mesh.ranks).reshape(self.mesh.shape)
            ax = list(self.mesh.axis_names).index(
                self.cfg.sedar.replica_axis)
            kept = np.take(grid, [0], axis=ax)
            shape, ranks = kept.shape, [int(r) for r in kept.reshape(-1)]
        else:
            shape, ranks = surviving_devices(self.mesh, sorted(lost_shards))
        self._active_ranks = ranks
        return rebuild_mesh(shape, self.mesh.axis_names, ranks=ranks)

    def _journal(self, rr: RemeshRecord, report: ElasticReport) -> None:
        report.remeshes.append(rr)
        obs.note_recovery(rr.as_recovery_record())
        if obs.metrics_enabled():
            obs.metrics.inc("sedar_elastic_remeshes_total", phase=rr.phase)
            obs.metrics.set_gauge("sedar_node_loss_downtime_s",
                                  sum(r.downtime_s for r in report.remeshes))

    # -- the run loop ------------------------------------------------------

    def run(self, num_steps: int, dual=None) -> ElasticReport:
        """Train to `num_steps` through node loss. `dual`, the starting
        state (default: the trainer's seeded init)."""
        report = ElasticReport()
        t0 = time.time()
        active = self.trainer
        step = 0
        max_segments = 8 * (num_steps // self.scan_interval + 2)
        for _ in range(max_segments):
            stale = self._scan(step)
            newly_lost = stale - self._lost
            if self._degraded is None and newly_lost:
                self._lost = set(stale)
                # the old topology's state goes before the anchor comes in
                active = dual = None
                active, dual = self._shrink(self._lost, step, report)
                if report.stopped:
                    break
                step = None   # re-read from the restored state
            elif self._degraded is not None and not (self._lost & stale):
                returned = set(self._lost)
                # any OTHER stale host is re-detected by the next scan
                self._lost = set()
                self._active_ranks = list(self.mesh.ranks) \
                    if self.mesh is not None else None
                active = dual = None
                active, dual = self._regrow(returned, step, report)
                step = None
            if step is not None and step >= num_steps:
                break
            stopped = False
            if active is not None:      # a dark rank sits the segment out
                seg_end = num_steps if step is None else \
                    min(step + self.scan_interval, num_steps)
                if step is None:
                    # bound the first post-transition segment by the scan
                    # cadence from the restored (anchor) step
                    restored = 0 if dual is None else \
                        active._host_step(dual)
                    seg_end = min(restored + self.scan_interval, num_steps)
                # handed over, not kept: the segment's first step frees it
                box, dual = [dual], None
                dual, seg = active.run(seg_end, dual=box.pop())
                report.segments.append(seg)
                step, stopped = seg.steps_completed, seg.stopped
            step, stopped = self._share_progress(step, stopped)
            if stopped:
                report.stopped = True
                break
        report.steps_completed = step if step is not None else 0
        report.completed_degraded = self._degraded is not None
        if report.segments:
            report.final_state_fp = report.segments[-1].final_state_fp
        report.wall_s = time.time() - t0
        return report
