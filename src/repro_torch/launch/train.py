"""Training launcher (the reference's `launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 8 --level 3 \
        [--replication none|sequential|fused|abft|hybrid|pod|vote] \
        [--pods N --data D] [--manual-vote] \
        [--inject-step N] [--validate-lag D] [--ckpt-delta] \
        [--ckpt-compress] [--ckpt-tiers device,host,disk,partner] \
        [--device cpu]

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
and on a mismatch a third and a majority vote. The elastic flags are not
ported.
"""
from __future__ import annotations

import argparse
import dataclasses
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
    args = ap.parse_args()
    if args.autotune and not args.metrics_dir:
        ap.error("--autotune needs --metrics-dir (the estimator reads "
                 "the stage-duration histograms and the fault journal)")

    mesh_run = args.replication in ("pod", "vote")
    pods = args.pods or (3 if args.replication == "vote" else 2)
    if mesh_run and (args.autotune or args.metrics_dir or args.trace):
        ap.error("the mesh backends run without the telemetry flags")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    rc = RunConfig(
        model=cfg,
        train=TrainConfig(global_batch=args.global_batch,
                          seq_len=args.seq_len, steps=args.steps,
                          warmup_steps=max(args.steps // 10, 1), lr=1e-3),
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
        # CPU ranks share the host's cores: one torch thread each
        reps = spawn(mesh_rank, pods * args.data, rc,
                     MeshConfig(shape=(pods, args.data),
                                axis_names=("pod", "data")),
                     args.workdir, inj, args.device,
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
