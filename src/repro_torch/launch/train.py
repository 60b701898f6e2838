"""Training launcher (the reference's `launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 8 --level 3 \
        [--replication none|sequential|fused|abft|hybrid] \
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
"disk" alone is the flat store). The reference's manual-vote baseline, elastic, metrics,
autotune and trace flags are not ported.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile


def main() -> None:
    # cuBLAS reads its workspace setting at its first call: deterministic
    # replicas on the card need it set before torch does any work
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.configs import (RunConfig, SedarConfig, TrainConfig,
                                     get_config, list_archs,
                                     reduce_for_smoke)
    from repro_torch.core.injection import InjectionSpec
    from repro_torch.core.policy import make_trainer

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--level", type=int, default=3, choices=(1, 2, 3))
    ap.add_argument("--replication", default="sequential",
                    choices=("none", "sequential", "fused", "abft",
                             "hybrid"))
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
    args = ap.parse_args()

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
    trainer = make_trainer(rc, args.workdir, inj_spec=inj, device=args.device)
    _, rep = trainer.run(args.steps)
    print(rep.summary())
    for e in rep.detections:
        print(f"  detection: {e}")
    for r in rep.recoveries:
        print(f"  recovery: {r}")
    print(f"workdir: {args.workdir}")


if __name__ == "__main__":
    main()
