"""Serving launcher (the reference's `launch/serve.py`): synchronous
whole-batch decode or a continuous-batching traffic replay.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --batch 4 --steps 16 [--dual | --backend fused|abft] [--device cpu]

    # continuous batching: an open-loop synthetic trace through the slot
    # scheduler, with per-request detection and recovery
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous \
        [--backend sequential|fused|abft|hybrid|none] \
        --requests 16 --slots 4 --arrival-rate 0.5 \
        --prompt-mix 4:0.5,8:0.3,16:0.2 --max-new 4,12 \
        --validate-lag 8 --fault-slot 1 --fault-step 5 [--device cpu]

As in the reference, `--smoke` is a store_true flag that defaults to True,
so the launcher always runs the reduced configuration; the full-width run is
driven through the API (`chip_smoke.py`). It runs on the card unless
`--device cpu` is given. `--backend` picks the protection (none,
sequential, fused, abft, hybrid). The synchronous run defaults to none,
and `--dual` alone means sequential there; the continuous replay defaults
to sequential, as the reference's does, and ignores `--dual`. Its
`--fault-slot` flips a bit of that slot's logits row on replica 1 (replica
0 under none), or, under abft/hybrid, of that slot's row of the
checksummed block (a kernel-domain fault: a flip before the encode would
be invisible to the guard by construction).

Telemetry, as in the reference:

    # metrics registry + fault journal (metrics.prom, journal.jsonl), a
    # Chrome trace of the stage spans, and the closed-loop autotuner
    ... --continuous --metrics-dir DIR --trace DIR/trace.json \
        --autotune --autotune-interval 4 [--slo-availability 0.999]
    PYTHONPATH=src python -m repro_torch.launch.status --metrics-dir DIR \
        --once

    # liveness in a shared heartbeat directory; stale peers are reported
    ... --heartbeat-dir DIR --host-id 0 --n-hosts 2 --hb-timeout 60

`--metrics-dir` prints `[obs]` lines (KPIs, predicted against observed, the
Prometheus snapshot), `--autotune` the `[autotune]` lines (the calibrated
step and sync times, alerts, evaluations), `--heartbeat-dir` a `[cluster]`
line. The reference's `--warmup` is left out: it compiles XLA programs
ahead of traffic, and eager PyTorch has none (the kernels are built at
first use).
"""
from __future__ import annotations

import argparse
import os


def _parse_prompt_mix(spec: str):
    """'4:0.5,8:0.5' -> (lengths, weights)."""
    lengths, weights = [], []
    for part in spec.split(","):
        length, _, w = part.partition(":")
        lengths.append(int(length))
        weights.append(float(w) if w else 1.0)
    return tuple(lengths), tuple(weights)


def _continuous(args, cfg, ob=None) -> None:
    from repro_torch import obs
    from repro_torch.configs import RunConfig, TrainConfig
    from repro_torch.core.injection import InjectionSpec
    from repro_torch.core.policy import make_server
    from repro_torch.runtime.scheduler import (stream_stats_ms,
                                               synthetic_requests)

    backend = args.backend or "sequential"
    spec = None
    if args.fault_slot is not None and backend in ("abft", "hybrid"):
        # one instance runs (replica 0); the fault lands between compute
        # and verify, in the chosen slot's row of the checksummed block
        spec = InjectionSpec(
            leaf_idx=0, flat_idx=args.fault_slot * (cfg.vocab_size + 1) + 7,
            bit=30, step=args.fault_step, replica=0, target="kernel",
            persistent=args.fault_persistent)
    elif args.fault_slot is not None:
        # replica 0 for the unprotected baseline (it has no replica 1: the
        # stream visibly corrupts with nothing detecting it)
        spec = InjectionSpec(
            leaf_idx=args.fault_slot, flat_idx=7, bit=30,
            step=args.fault_step, replica=0 if backend == "none" else 1,
            target="slot", persistent=args.fault_persistent)
    buckets = (tuple(int(b) for b in args.prefill_buckets.split(","))
               if args.prefill_buckets else None)
    srv = make_server(RunConfig(model=cfg, train=TrainConfig()),
                      backend=backend, inj_spec=spec,
                      max_retries=args.max_retries, prefill_buckets=buckets,
                      max_pack=args.max_pack, device=args.device)
    params = srv.model.init(seed=0)
    lengths, weights = _parse_prompt_mix(args.prompt_mix)
    reqs = synthetic_requests(
        args.requests, arrival_rate=args.arrival_rate,
        prompt_lengths=lengths, length_weights=weights,
        max_new_choices=tuple(int(x) for x in args.max_new.split(",")),
        vocab=min(cfg.vocab_size, 200), seed=args.seed)
    tuner = None
    if args.autotune:
        from repro_torch.core import temporal_model as tm
        from repro_torch.core.policy import Autotuner, AutotuneConfig
        tuner = Autotuner(
            tm.PAPER_TABLE3["JACOBI"],
            AutotuneConfig(interval_steps=args.autotune_interval,
                           mode="serve", serve_slots=args.slots,
                           backend=backend,
                           slo_availability=args.slo_availability,
                           slo_goodput=args.slo_goodput))
    out, rep = srv.serve(
        params, reqs, slots=args.slots, validate_lag=args.validate_lag,
        queue_depth=args.queue_depth, autotune=tuner,
        drain_cadence=args.drain_cadence,
        notify_reject=lambda r, e: print(
            f"[SEDAR] request {r.rid} REJECTED after {e.boundary} fault "
            f"(per-request safe stop)", flush=True))
    ms = stream_stats_ms(out)
    print(f"{args.arch}: {rep.tokens_emitted} tokens delivered over "
          f"{rep.steps} protected steps ({rep.tokens_per_s:.1f} tok/s "
          f"{_where(srv)}, goodput {rep.goodput_tokens_per_step:.2f} "
          f"tok/step), backend={srv.backend}, "
          f"p50/p99 inter-token {ms['itl_p50_ms']:.2f}/"
          f"{ms['itl_p99_ms']:.2f} ms, "
          f"p50/p99 TTFT {ms['ttft_p50_ms']:.2f}/{ms['ttft_p99_ms']:.2f} ms, "
          f"p50/p99 TTLT {ms['ttlt_p50_ms']:.2f}/{ms['ttlt_p99_ms']:.2f} ms")
    print(f"  completed={len(rep.completed)} rejected={rep.rejected} "
          f"detections={len(rep.detections)} retries={rep.retries} "
          f"rollbacks={rep.rollbacks} "
          f"truncated+redecoded={rep.truncated_tokens} tokens, "
          f"prefill packs={rep.prefill_packs} "
          f"prefill retries={rep.prefill_retries}")
    for e in rep.detections:
        print(f"  {e} slots={e.detail.get('slots')}")
    if ob is not None and ob.journal is not None:
        kpis = ob.kpis(steps=rep.steps, tokens=rep.tokens_emitted)
        print(f"[obs] kpis: {kpis}")
        rows = obs.reconcile_with_advice(kpis,
                                         validate_lag=args.validate_lag)
        for row in rows:
            print(f"[obs] predicted-vs-observed {row['metric']}: "
                  f"predicted {row['predicted']}, observed "
                  f"{row['observed']} -> {'OK' if row['ok'] else 'MISS'}")
    if tuner is not None:
        snap = tuner.estimator.calibrated_params()
        print(f"[autotune] calibrated: t_step={snap.params.t_step:.3e} h, "
              f"t_sync={snap.params.t_sync:.3e} h, "
              f"mtbe={snap.mtbe_hours:.3g} h, "
              f"confidence={snap.confidence:.2f}")
        print(f"[autotune] {len(tuner.alerts.records)} alert(s), "
              f"{tuner.evaluations} evaluation(s)")


def _where(srv) -> str:
    import torch
    return (f"on {torch.cuda.get_device_name(0)}"
            if srv.device.type == "cuda" else "on the CPU")


def main() -> None:
    from repro_torch.configs import list_archs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--dual", action="store_true",
                    help="SEDAR dual-execution detection on decode (the "
                         "synchronous run)")
    ap.add_argument("--backend", default=None,
                    choices=["none", "sequential", "fused", "abft",
                             "hybrid"],
                    help="protection backend (default: sequential for "
                         "--continuous; otherwise sequential with --dual, "
                         "else none)")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    # -- continuous-batching traffic replay ----------------------------------
    ap.add_argument("--continuous", action="store_true",
                    help="slot-scheduled continuous batching with "
                         "per-request recovery")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--arrival-rate", type=float, default=1.0,
                    help="open-loop arrivals per decode tick")
    ap.add_argument("--prompt-mix", default="4:0.5,8:0.5",
                    help="len:weight[,len:weight...] prompt-length mix")
    ap.add_argument("--max-new", default="4,12",
                    help="comma list of per-request token budgets")
    ap.add_argument("--queue-depth", type=int, default=0,
                    help="admission-queue bound (0 = unbounded); a full "
                         "queue sheds load (backpressure rejection)")
    ap.add_argument("--validate-lag", type=int, default=None,
                    help="deferred-validation window D")
    ap.add_argument("--drain-cadence", type=int, default=None,
                    help="parked decode ticks per token drain: default = "
                         "the validate lag; 1 = per-tick emission")
    ap.add_argument("--max-retries", type=int, default=8,
                    help="consecutive per-slot failures before the request "
                         "is rejected (per-request L1)")
    ap.add_argument("--prefill-buckets", default="",
                    help="comma list of prompt-length buckets for packed "
                         "admission prefill (empty = geometric default)")
    ap.add_argument("--max-pack", type=int, default=4,
                    help="max prompts packed into one prefill launch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-slot", type=int, default=None,
                    help="inject a slot-localized SDC into this slot (a "
                         "kernel-domain fault under abft/hybrid)")
    ap.add_argument("--fault-step", type=int, default=5)
    ap.add_argument("--fault-persistent", action="store_true",
                    help="stuck bit: re-inject every step (drives the "
                         "per-request rejection path)")
    # -- cluster membership ------------------------------------------------
    ap.add_argument("--heartbeat-dir", default=None,
                    help="publish this server's liveness to a shared "
                         "heartbeat directory and report any stale peers "
                         "after the run")
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--n-hosts", type=int, default=1)
    ap.add_argument("--hb-timeout", type=float, default=60.0,
                    help="seconds without a heartbeat before a peer is "
                         "declared stale")
    # -- observability -----------------------------------------------------
    ap.add_argument("--metrics-dir", default=None,
                    help="enable the metrics registry + fault journal: "
                         "writes metrics.prom and journal.jsonl here and "
                         "prints the Prometheus snapshot after the run")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record per-stage trace spans to a Chrome-trace "
                         "JSON (host clock: a span over work that reads "
                         "nothing back times its dispatch)")
    # -- closed-loop autotuning --------------------------------------------
    ap.add_argument("--autotune", action="store_true",
                    help="closed-loop calibration: estimate decode-tick/"
                         "flush costs and MTBE online, retune the serve "
                         "lag at clean flush boundaries (needs "
                         "--metrics-dir + --continuous)")
    ap.add_argument("--autotune-interval", type=int, default=16,
                    help="decode ticks between autotuner evaluations")
    ap.add_argument("--slo-availability", type=float, default=None,
                    help="availability SLO target (e.g. 0.999)")
    ap.add_argument("--slo-goodput", type=float, default=None,
                    help="goodput SLO target as a 0-1 fraction")
    args = ap.parse_args()
    if args.autotune and not (args.continuous and args.metrics_dir):
        ap.error("--autotune needs --continuous and --metrics-dir")

    # deterministic cuBLAS needs this before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np

    from repro_torch import obs
    from repro_torch.configs import (RunConfig, TrainConfig, get_config,
                                     reduce_for_smoke)
    from repro_torch.core.policy import make_server

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    ob = obs.configure(metrics_dir=args.metrics_dir, trace=args.trace)
    hb = mon = None
    if args.heartbeat_dir:
        from repro_torch.runtime.cluster import ClusterMonitor, Heartbeat
        hb = Heartbeat(args.heartbeat_dir, args.host_id)
        hb.beat(0)
        mon = ClusterMonitor(args.heartbeat_dir, args.n_hosts,
                             timeout_s=args.hb_timeout)
    if args.continuous:
        _continuous(args, cfg, ob)
    else:
        srv = make_server(RunConfig(model=cfg, train=TrainConfig()),
                          dual=args.dual, backend=args.backend,
                          device=args.device)
        params = srv.model.init(seed=0)
        prompts = {"tokens": np.random.RandomState(0).randint(
            0, min(cfg.vocab_size, 200), (args.batch, args.prompt_len))}
        toks, rep = srv.generate(params, prompts, steps=args.steps)
        tps = rep.tokens_emitted / max(rep.wall_s, 1e-9)
        print(f"{args.arch}: {rep.tokens_emitted} tokens, {tps:.1f} tok/s "
              f"({_where(srv)}), backend={srv.backend}, "
              f"detections={len(rep.detections)}")
    if hb is not None:
        if not hb.beat(args.steps):
            print(f"[cluster] heartbeat write failed "
                  f"({hb.io_errors} IO errors) — peers will see this "
                  f"host as stale")
        stale = mon.stale_hosts()
        print(f"[cluster] host {args.host_id} of {args.n_hosts}: "
              f"{'stale peers ' + str(stale) if stale else 'all peers live'}")
    snap = ob.finalize()
    if snap:
        print(f"[obs] metrics snapshot ({args.metrics_dir}/metrics.prom):")
        print(snap, end="")
    if args.trace:
        print(f"[obs] trace written to {args.trace}")


if __name__ == "__main__":
    main()
