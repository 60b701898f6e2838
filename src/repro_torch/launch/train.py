"""Training launcher (the reference's `launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 8 --level 3 \
        [--replication none|sequential|fused|abft|hybrid|pod|vote] \
        [--pods N --data D] [--manual-vote] \
        [--inject-step N] [--validate-lag D] [--ckpt-delta] \
        [--ckpt-compress] [--ckpt-tiers device,host,disk,partner] \
        [--elastic --n-hosts H --scan-interval S --lose-host h \
         --lose-at T0 --return-at T1] [--device cpu]

As in the reference, `--smoke` is a store_true flag that defaults to True,
so the launcher always trains the reduced configuration; the full-width run
is driven through the API (`chip_smoke.py`). It runs on the card unless
`--device cpu` is given, and raises without a card. `--inject-step N`
flips bit 21 of element 11 of gradient leaf 3 on replica 1 at step N (the
reference's fault). It prints the report's summary, each detection and
recovery, then the run directory (`--workdir`, else a fresh one under the
temp dir). `--ckpt-tiers` names the checkpoint tiers of L2/L3 (the
device ring every step, host and partner at the checkpoint interval;
"disk" alone is the flat store).

Telemetry, as in the reference: `--metrics-dir DIR` turns on the metrics
registry and the fault journal (DIR/metrics.prom, DIR/journal.jsonl) and
prints `[obs]` lines (the KPIs, the Prometheus snapshot); `--trace PATH`
writes the stage spans as a Chrome trace; `--autotune` (needs
`--metrics-dir`) runs the closed-loop autotuner every
`--autotune-interval` steps and prints the `[autotune]` lines (the
calibrated step and sync times, alerts, evaluations); `--slo-availability`
and `--slo-goodput` arm its burn-rate alerts.

`--replication pod|vote` trains on a process mesh of `--pods` x `--data`
ranks (default 2 x 1; vote takes at least 3 pods), which the launcher
spawns itself (`launch/mesh.py::spawn`, gloo on localhost): each rank runs
`mesh_rank`, keeps its checkpoints under `<workdir>/rank{r}`, and rank 0's
report is printed. `--manual-vote` runs the paper's baseline
(`manual_vote_baseline`): two unprotected instances compared at the end,
and on a mismatch a third and a majority vote.

`--elastic` drives the fail-in-place loop (`runtime/elastic.py`) in one
process, as the reference's does: an `ElasticTrainer` over a data axis of
`--n-hosts` shards (`MeshConfig((n_hosts, 1), ("data", "model"))`, L3
only), under a simulated cluster (`SimCluster`) whose clock advances 100 s
per scan (every `--scan-interval` steps) and where host `--lose-host` is
dark over [`--lose-at`, `--return-at`) of that clock. The run shrinks onto
the survivors from the last validated checkpoint, regrows when the host
returns and ends on the uninterrupted run's state; it prints the summary,
one `remesh[...]` line per transition and one `decision:` line per shrink:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 12 --level 3 --elastic --n-hosts 2 --lose-host 1 \
        --lose-at 300 --return-at 700

`elastic_mesh_rank` runs the same loop on the pod backend's process mesh
(one rank per (pod, data) index); the tests and `chip_smoke.py` spawn it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Optional

import numpy as np


def mesh_rank(rank: int, rc, mesh_cfg, workdir: str, inj_spec=None,
              device: str = "cuda", init_state=None) -> Dict[str, Any]:
    """One rank of `pod`/`vote` training (run under `launch/mesh.py::
    spawn`): builds the process mesh of `mesh_cfg` (a `MeshConfig`), trains
    `rc.train.steps` steps and returns its report as host values: the
    summary, the events (step, boundary, effect, lanes, hosts), the
    recovery records, the losses, ms/step, the device reads by label and
    the collectives, K1's launches, the peak device memory (GiB, None on
    the CPU), the final per-leaf fingerprint (uint32). `init_state`, a
    training state as numpy (`bridge.train_state_from_numpy`), replaces the
    seeded init."""
    import torch

    from repro_torch import bridge
    from repro_torch.core import hostsync
    from repro_torch.core.policy import make_trainer
    from repro_torch.kernels import fingerprint as kfp
    from repro_torch.launch.mesh import make_process_mesh

    mesh = make_process_mesh(mesh_cfg)
    tr = make_trainer(rc, workdir, inj_spec=inj_spec, device=device,
                      mesh=mesh, notify=lambda e: None)
    dual = None
    if init_state is not None:
        dual = tr.engine.executor.init_dual(
            bridge.train_state_from_numpy(init_state, tr.device))
    cuda = tr.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(tr.device)
        torch.cuda.reset_peak_memory_stats(tr.device)
    kfp.launch_count.reset()
    with hostsync.count_transfers() as st:
        _, rep = tr.run(rc.train.steps, dual=dual)
    return {
        "rank": rank, "pod": mesh.pod, "data": mesh.data,
        "summary": rep.summary(),
        "detections": [dict(step=e.step, boundary=e.boundary,
                            effect=e.effect, lanes=e.detail.get("lanes"),
                            hosts=e.detail.get("hosts"))
                       for e in rep.detections],
        "events": [str(e) for e in rep.detections],
        "recoveries": [dict(r) for r in rep.recoveries],
        "checkpoints": list(rep.checkpoints),
        "steps": rep.steps_completed, "stopped": rep.stopped,
        "losses": list(rep.losses),
        "ms_step": rep.wall_s * 1e3 / max(rep.steps_completed, 1),
        "reads": dict(st.by_label), "collectives": dict(st.collectives),
        "k1": kfp.launch_count.n,
        "peak_gib": (torch.cuda.max_memory_allocated(tr.device) / 2 ** 30
                     if cuda else None),
        "final_state_fp": np.asarray(rep.final_state_fp),
    }


class SimCluster:
    """Deterministic heartbeats for the elastic loop: `tick` advances the
    clock 100 s and writes every host's beat but host `dark_host`'s over
    [dark_from, dark_to) of that clock; `clock` reads it. The monitor then
    sees a real stale host. Picklable, so a mesh rank can take one."""

    def __init__(self, hb_dir: str, n_hosts: int = 2,
                 dark_host: Optional[int] = 1, dark_from: float = 300.0,
                 dark_to: float = 700.0):
        self.dir = hb_dir
        self.n_hosts = n_hosts
        self.dark_host = dark_host
        self.dark_from = dark_from
        self.dark_to = dark_to
        self.now = 0.0

    def clock(self) -> float:
        return self.now

    def tick(self, step) -> None:
        self.now += 100.0
        os.makedirs(self.dir, exist_ok=True)
        for h in range(self.n_hosts):
            if h == self.dark_host and \
                    self.dark_from <= self.now < self.dark_to:
                continue
            with open(os.path.join(self.dir, f"host_{h:05d}.json"),
                      "w") as f:
                json.dump({"host": h, "step": int(step or 0),
                           "t": self.now}, f)


def elastic_mesh_rank(rank: int, rc, mesh_cfg, workdir: str,
                      cluster: Dict[str, Any], device: str = "cuda",
                      init_state=None, ref_rc=None,
                      elastic_kw: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
    """One rank of elastic pod training (run under `launch/mesh.py::
    spawn`): builds the process mesh of `mesh_cfg`, then trains
    `rc.train.steps` steps twice from the same state: uninterrupted (a
    plain `make_trainer` run under `ref_rc`, default `rc`) and under an
    `ElasticTrainer` whose rank 0 plays the cluster
    (`SimCluster(**cluster)` in `workdir/run/heartbeats`).
    `init_state` (numpy, `bridge.train_state_from_numpy`) replaces the
    seeded init; `elastic_kw` goes to the ElasticTrainer (replica_hosts,
    mtbe_hours, ...). Returns host values: each run's summary, losses,
    ms/step, final per-leaf fingerprint (uint32), K1 launches and peak
    device memory (GiB, None on the CPU); the elastic run's remesh records
    and decisions, its events and recoveries, its device reads by label
    and collectives."""
    import gc
    import time

    import torch

    from repro_torch import bridge
    from repro_torch.core import hostsync
    from repro_torch.core.policy import make_trainer
    from repro_torch.kernels import fingerprint as kfp
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.runtime.elastic import ElasticTrainer

    mesh = make_process_mesh(mesh_cfg)
    steps = rc.train.steps
    out: Dict[str, Any] = {"rank": rank, "pod": mesh.pod, "data": mesh.data}

    def start(tr):
        if init_state is None:
            return None
        return tr.engine.executor.init_dual(
            bridge.train_state_from_numpy(init_state, tr.device))

    def measure(tr, run):
        """run(steps, dual=the starting state) under the counters; the
        state is handed over, not kept here."""
        cuda = tr.device.type == "cuda"
        # a dropped trainer and its engine refer to each other: collect
        # them, so the run before leaves no state on the card
        gc.collect()
        if cuda:
            torch.cuda.synchronize(tr.device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(tr.device)
        kfp.launch_count.reset()
        t0 = time.time()
        with hostsync.count_transfers() as st:
            rep = run(steps, dual=start(tr))
        wall = time.time() - t0
        rep = rep[1] if isinstance(rep, tuple) else rep
        return rep, st, {
            "ms_step": wall * 1e3 / max(steps, 1),
            "k1": kfp.launch_count.n,
            "peak_gib": (torch.cuda.max_memory_allocated(tr.device) / 2 ** 30
                         if cuda else None)}

    tr = make_trainer(ref_rc or rc, os.path.join(workdir, "ref"),
                      device=device, mesh=mesh, notify=lambda e: None)
    rep, _, m = measure(tr, tr.run)
    out["ref"] = dict(m, summary=rep.summary(), losses=list(rep.losses),
                      steps=rep.steps_completed,
                      detections=[str(e) for e in rep.detections],
                      final_state_fp=np.asarray(rep.final_state_fp))
    del tr, rep
    wd = os.path.join(workdir, "run")
    sim = SimCluster(os.path.join(wd, "heartbeats"), **cluster)
    et = ElasticTrainer(rc, wd, mesh=mesh, n_hosts=sim.n_hosts,
                        clock=sim.clock, tick=sim.tick, device=device,
                        notify=lambda e: None, **(elastic_kw or {}))
    rep, st, m = measure(et.trainer, et.run)
    out["elastic"] = dict(
        m, summary=rep.summary(),
        remeshes=[dataclasses.asdict(r) for r in rep.remeshes],
        decisions=[d.mode for d in rep.decisions],
        steps=rep.steps_completed, stopped=rep.stopped,
        completed_degraded=rep.completed_degraded,
        segments=[dict(steps=seg.steps_completed, losses=list(seg.losses))
                  for seg in rep.segments],
        detections=[str(e) for e in rep.detections],
        recoveries=[dict(r) for r in rep.recoveries],
        reads=dict(st.by_label), collectives=dict(st.collectives),
        final_state_fp=(None if rep.final_state_fp is None
                        else np.asarray(rep.final_state_fp)))
    return out


def run_elastic(rc, args) -> None:
    """The fail-in-place loop in one process: this process plays every
    host's heartbeat writer (`SimCluster`), so the `ClusterMonitor` sees a
    real stale host and the `ElasticTrainer` shrinks and regrows as it
    would under a real node loss."""
    from repro_torch.runtime.elastic import ElasticTrainer

    sim = SimCluster(os.path.join(args.workdir, "heartbeats"),
                     n_hosts=args.n_hosts, dark_host=args.lose_host,
                     dark_from=args.lose_at, dark_to=args.return_at)
    et = ElasticTrainer(rc, args.workdir, n_hosts=args.n_hosts,
                        scan_interval=args.scan_interval, clock=sim.clock,
                        tick=sim.tick, device=args.device)
    rep = et.run(args.steps)
    print(rep.summary())
    for r in rep.remeshes:
        print(f"  remesh[{r.phase}]: trigger step {r.trigger_step}, "
              f"restored step {r.restore_step} from tier "
              f"{r.restore_tier}, hosts {sorted(r.hosts)}, data "
              f"{r.old_data}->{r.new_data}, batch "
              f"{r.old_batch}->{r.new_batch}")
    for d in rep.decisions:
        print(f"  decision: {d.mode} (fail_in_place "
              f"{d.fail_in_place_hours:.3f} h vs restart "
              f"{d.restart_hours:.3f} h) — {d.notes}")


def manual_vote_baseline(rc, workdir: str, steps: int, inj_spec=None,
                         device: str = "cuda") -> Optional[int]:
    """The paper's baseline (Sec. 3, Eqs. 1-2): two unprotected instances
    and a final comparison; on a mismatch a third instance and a majority
    vote. Returns the corrupted instance, None when the two agree."""
    from repro_torch.configs import SedarConfig
    from repro_torch.core.policy import make_trainer

    def instance(i: int, spec):
        run = dataclasses.replace(
            rc, sedar=SedarConfig(level=1, replication="none"))
        tr = make_trainer(run, os.path.join(workdir, f"inst{i}"),
                          inj_spec=spec, device=device)
        _, rep = tr.run(steps)
        print(f"[baseline] instance {i}: {rep.summary()}")
        return rep.final_state_fp[:, :2]

    fps = [instance(0, None), instance(1, inj_spec)]
    if np.array_equal(fps[0], fps[1]):
        print("[baseline] results MATCH — accepted")
        return None
    print("[baseline] MISMATCH — launching third instance for majority vote")
    third = instance(2, None)
    winner = 0 if np.array_equal(third, fps[0]) else 1
    print(f"[baseline] majority: instances {winner} and 2 agree -> "
          f"instance {1 - winner} was corrupted")
    return 1 - winner


def main() -> None:
    # cuBLAS reads its workspace setting at its first call: deterministic
    # replicas on the card need it set before torch does any work
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch import obs
    from repro_torch.configs import (MeshConfig, RunConfig, SedarConfig,
                                     TrainConfig, get_config, list_archs,
                                     reduce_for_smoke)
    from repro_torch.core import temporal_model as tm
    from repro_torch.core.injection import InjectionSpec
    from repro_torch.core.policy import (Autotuner, AutotuneConfig,
                                         make_trainer)

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--level", type=int, default=3, choices=(1, 2, 3))
    ap.add_argument("--replication", default="sequential",
                    choices=("none", "sequential", "fused", "abft",
                             "hybrid", "pod", "vote"))
    ap.add_argument("--pods", type=int, default=None,
                    help="pod/vote: replicas, one process each per data "
                         "shard (default 2, vote 3)")
    ap.add_argument("--data", type=int, default=1,
                    help="pod/vote: data shards of the global batch, one "
                         "process and one fingerprint lane each")
    ap.add_argument("--manual-vote", action="store_true",
                    help="the paper's baseline: two unprotected instances, "
                         "compared at the end; a third and a majority vote "
                         "on a mismatch")
    ap.add_argument("--validate-lag", type=int, default=1,
                    help="deferred validation window D: read the commit "
                         "predicates back every D steps")
    ap.add_argument("--ckpt-delta", action="store_true",
                    help="L2 delta checkpoints: leaves unchanged since the "
                         "previous version become manifest references")
    ap.add_argument("--ckpt-compress", action="store_true",
                    help="compress leaf payloads (np.savez_compressed)")
    ap.add_argument("--ckpt-tiers", default="disk",
                    help="comma list of checkpoint tiers from device, host, "
                         "disk, partner (L2/L3)")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=16)
    ap.add_argument("--ckpt-interval", type=int, default=4)
    ap.add_argument("--workdir", default=None,
                    help="run directory (checkpoints, rollback counter, "
                         "injection flag); a named one is cleared first. "
                         "Default: a fresh directory under the temp dir")
    ap.add_argument("--inject-step", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--metrics-dir", default=None,
                    help="enable the metrics registry + fault journal: "
                         "writes metrics.prom and journal.jsonl here and "
                         "prints the Prometheus snapshot after the run")
    ap.add_argument("--autotune", action="store_true",
                    help="closed-loop calibration: estimate t_step/t_sync/"
                         "MTBE online and retune the deferred-validation "
                         "lag + tier cadences at clean flush boundaries "
                         "(requires --metrics-dir for the estimator's "
                         "inputs)")
    ap.add_argument("--autotune-interval", type=int, default=16,
                    help="steps between autotuner evaluations")
    ap.add_argument("--slo-availability", type=float, default=None,
                    help="availability SLO target (e.g. 0.999); burn-rate "
                         "alerts fire when the error budget burns fast")
    ap.add_argument("--slo-goodput", type=float, default=None,
                    help="goodput SLO target as a 0-1 fraction of the "
                         "fault-free rate")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record per-stage trace spans to a Chrome-trace "
                         "JSON (host clock: a span over work that reads "
                         "nothing back times its dispatch)")
    ap.add_argument("--elastic", action="store_true",
                    help="run under an ElasticTrainer: monitor heartbeats, "
                         "shrink onto survivors on node loss, regrow on "
                         "return (requires --level 3)")
    ap.add_argument("--n-hosts", type=int, default=2,
                    help="cluster width; the data axis gets one shard per "
                         "host")
    ap.add_argument("--scan-interval", type=int, default=2,
                    help="steps per training segment between cluster scans")
    ap.add_argument("--lose-host", type=int, default=None,
                    help="simulate this host going dark (heartbeats stop)")
    ap.add_argument("--lose-at", type=float, default=300.0,
                    help="simulated-clock second the host goes dark (the "
                         "clock advances 100 s per segment)")
    ap.add_argument("--return-at", type=float, default=700.0,
                    help="simulated-clock second the host comes back")
    args = ap.parse_args()
    if args.autotune and not args.metrics_dir:
        ap.error("--autotune needs --metrics-dir (the estimator reads "
                 "the stage-duration histograms and the fault journal)")

    mesh_run = args.replication in ("pod", "vote")
    pods = args.pods or (3 if args.replication == "vote" else 2)
    if mesh_run and (args.autotune or args.metrics_dir or args.trace):
        ap.error("the mesh backends run without the telemetry flags")
    mesh_cfg = MeshConfig()
    if args.elastic:
        if args.level < 3:
            ap.error("--elastic requires --level 3 (a validated checkpoint "
                     "anchor is what makes shrink/regrow exact)")
        if args.global_batch % args.n_hosts:
            ap.error("--global-batch must divide evenly across --n-hosts")
        if mesh_run or args.manual_vote:
            ap.error("--elastic runs one process of a single-card backend")
        mesh_cfg = MeshConfig(shape=(args.n_hosts, 1),
                              axis_names=("data", "model"))
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    rc = RunConfig(
        model=cfg,
        train=TrainConfig(global_batch=args.global_batch,
                          seq_len=args.seq_len, steps=args.steps,
                          warmup_steps=max(args.steps // 10, 1), lr=1e-3),
        mesh=mesh_cfg,
        sedar=SedarConfig(level=args.level, replication=args.replication,
                          validate_lag=args.validate_lag,
                          checkpoint_interval=args.ckpt_interval,
                          param_validate_interval=args.ckpt_interval,
                          ckpt_delta=args.ckpt_delta,
                          ckpt_compress=args.ckpt_compress,
                          ckpt_tiers=args.ckpt_tiers))
    if args.workdir is None:
        args.workdir = tempfile.mkdtemp(prefix="sedar_train_")
    else:
        shutil.rmtree(args.workdir, ignore_errors=True)
    inj = None
    if args.inject_step is not None:
        inj = InjectionSpec(leaf_idx=3, flat_idx=11, bit=21,
                            step=args.inject_step, replica=1, target="grads")
    if args.manual_vote:
        manual_vote_baseline(rc, args.workdir, args.steps, inj,
                             device=args.device)
        print(f"workdir: {args.workdir}")
        return
    if mesh_run:
        from repro_torch.launch.mesh import spawn
        mesh_cfg = MeshConfig(shape=(pods, args.data),
                              axis_names=("pod", "data"))
        # CPU ranks share the host's cores: one torch thread each
        reps = spawn(mesh_rank, pods * args.data, rc.replace(mesh=mesh_cfg),
                     mesh_cfg, args.workdir, inj, args.device,
                     threads=1 if args.device == "cpu" else 0)
        rep = reps[0]
        print(f"{args.replication}: {pods} pods x {args.data} data shards, "
              f"rank 0: {rep['summary']}")
        for e, d in zip(rep["events"], rep["detections"]):
            print(f"  detection: {e} lanes={d['lanes']} hosts={d['hosts']}")
        for r in rep["recoveries"]:
            print(f"  recovery: {r}")
        same = all(np.array_equal(r["final_state_fp"],
                                  reps[0]["final_state_fp"]) for r in reps)
        print(f"final state fingerprints equal on every rank: {same}")
        print(f"workdir: {args.workdir}")
        return
    ob = obs.configure(metrics_dir=args.metrics_dir, trace=args.trace)
    if args.elastic:
        run_elastic(rc, args)
        if args.metrics_dir:
            print(f"[obs] kpis: {ob.kpis(steps=args.steps)}")
        snap = ob.finalize()
        if snap:
            print(f"[obs] metrics snapshot ({args.metrics_dir}/"
                  f"metrics.prom):")
            print(snap, end="")
        print(f"workdir: {args.workdir}")
        return
    tuner = None
    if args.autotune:
        tuner = Autotuner(
            tm.PAPER_TABLE3["JACOBI"],
            AutotuneConfig(interval_steps=args.autotune_interval,
                           mode="train", backend=args.replication,
                           slo_availability=args.slo_availability,
                           slo_goodput=args.slo_goodput))
    trainer = make_trainer(rc, args.workdir, inj_spec=inj,
                           device=args.device, autotune=tuner)
    _, rep = trainer.run(args.steps)
    print(rep.summary())
    for e in rep.detections:
        print(f"  detection: {e}")
    for r in rep.recoveries:
        print(f"  recovery: {r}")
    if args.metrics_dir:
        print(f"[obs] kpis: {ob.kpis(steps=rep.steps_completed)}")
    if tuner is not None:
        snap = tuner.estimator.calibrated_params()
        print(f"[autotune] calibrated: t_step={snap.params.t_step:.3e} h, "
              f"t_sync={snap.params.t_sync:.3e} h, "
              f"mtbe={snap.mtbe_hours:.3g} h, "
              f"confidence={snap.confidence:.2f} "
              f"({snap.sample_counts})")
        print(f"[autotune] {len(tuner.alerts.records)} alert(s), "
              f"{tuner.evaluations} evaluation(s)")
    snap = ob.finalize()
    if snap:
        print(f"[obs] metrics snapshot ({args.metrics_dir}/metrics.prom):")
        print(snap, end="")
    if args.trace:
        print(f"[obs] trace written to {args.trace}")
    print(f"workdir: {args.workdir}")


if __name__ == "__main__":
    main()
