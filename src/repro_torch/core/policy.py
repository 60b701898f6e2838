"""Engine, trainer and server factories (the reference's `core/policy.py`:
`make_engine` for the `none`/`sequential`/`fused`/`abft`/`hybrid`
backends, `make_trainer` and `make_server`). The mesh backends `pod` and
`vote` are not ported."""
from __future__ import annotations

from typing import Any, Callable, Optional


def make_engine(sedar_cfg, *, step_fn: Callable, recovery: Any = None,
                workdir: Optional[str] = None,
                backend: Optional[str] = None,
                state_fp_fn: Optional[Callable] = None,
                fast_state_fp_fn: Optional[Callable] = None,
                schedule: Any = None, watchdog: Any = None,
                inj_spec: Any = None, inj_flag: Any = None,
                init_fn: Optional[Callable] = None,
                notify: Optional[Callable] = None,
                delay_source: Optional[Callable[[], dict]] = None,
                slots: Optional[int] = None,
                stack: str = "rows"):
    """Assemble a `SedarEngine` for one workload.

    backend: "none" | "sequential" | "fused" | "abft" | "hybrid" (defaults
    to sedar_cfg.replication); all but "none" also need `state_fp_fn`.
    "fused" steps both replicas in one launch over a state that stacks
    them: as row blocks (`stack="rows"`, serving's decode state,
    `core/engine.py::FusedSequentialExecutor`) or on a leading replica
    axis of every leaf (`stack="leading"`, a training state,
    `StackedFusedExecutor`); step_fn then follows the fused contract
    `(stacked, batch, armed) -> (candidate, fps (2, ...), aux)`.
    abft/hybrid run replica-free: step_fn may return a 4th element (an
    `abft.ref.AbftReport` from checksummed kernels), and hybrid also checks
    the commit-time state fingerprint (`fast_state_fp_fn`, default
    `state_fp_fn`) at the FSC cadence. Sequential: `state_fp_fn` is
    the per-leaf fingerprint (reports, L2 manifests, L3 validation),
    `fast_state_fp_fn` (default: the same) the FSC compare. `recovery`
    defaults to the config's (`make_recovery(sedar_cfg, workdir)`: L1, or
    L2/L3 on disk); `init_fn` builds a fresh dual state for Alg. 1's
    restart from scratch.
    `slots=N` selects the slot-granular sequential or fused executor
    (continuous serving): step_fn then returns per-slot fingerprints
    ((N, 4), or (2, N, 4) fused), and a commit mismatch is localized to
    slots and partially committed. abft/hybrid ignore `slots`."""
    from repro_torch.core.detection import Watchdog
    from repro_torch.core.recovery import make_recovery
    from repro_torch.core.engine import (BoundarySchedule,
                                         FusedSequentialExecutor,
                                         PlainExecutor, SedarEngine,
                                         SequentialExecutor,
                                         SlottedFusedExecutor,
                                         StackedFusedExecutor,
                                         SlottedSequentialExecutor)

    backend = backend or sedar_cfg.replication
    schedule = schedule or BoundarySchedule.from_config(sedar_cfg)
    if recovery is None:
        recovery = make_recovery(sedar_cfg, workdir)
    if backend == "none":
        executor = PlainExecutor(step_fn, state_fp_fn)
    elif backend == "sequential":
        if state_fp_fn is None:
            raise ValueError("backend 'sequential' needs state_fp_fn")
        kw = dict(fast_state_fp_fn=fast_state_fp_fn,
                  watchdog=watchdog or Watchdog(schedule.toe_timeout_s),
                  toe_timeout_s=schedule.toe_timeout_s,
                  delay_source=delay_source)
        executor = (SlottedSequentialExecutor(step_fn, state_fp_fn,
                                              n_slots=slots, **kw)
                    if slots else SequentialExecutor(step_fn, state_fp_fn,
                                                     **kw))
    elif backend == "fused":
        if state_fp_fn is None:
            raise ValueError("backend 'fused' needs state_fp_fn")
        if stack == "leading":
            executor = StackedFusedExecutor(
                step_fn, state_fp_fn, fast_state_fp_fn=fast_state_fp_fn)
        elif slots:
            executor = SlottedFusedExecutor(step_fn, state_fp_fn,
                                            n_slots=slots)
        else:
            executor = FusedSequentialExecutor(step_fn, state_fp_fn)
    elif backend in ("abft", "hybrid"):
        if state_fp_fn is None:
            raise ValueError(f"backend {backend!r} needs state_fp_fn")
        from repro_torch.abft.executor import AbftExecutor
        executor = AbftExecutor(step_fn, state_fp_fn,
                                fast_state_fp_fn=fast_state_fp_fn,
                                hybrid=(backend == "hybrid"),
                                validate_interval=schedule.validate_interval)
    else:
        raise NotImplementedError(f"backend {backend!r} is not ported yet")
    return SedarEngine(executor, schedule, recovery, inj_spec=inj_spec,
                       inj_flag=inj_flag, init_fn=init_fn, notify=notify)


def make_trainer(run_cfg, workdir: str, **kw):
    """Construct a SEDAR-protected trainer (`runtime/train.py`). Runs on the
    card unless `device="cpu"` is passed; raises when no card is present."""
    from repro_torch.runtime.train import SedarTrainer
    return SedarTrainer(run_cfg, workdir, **kw)


def make_server(run_cfg, *, dual: bool = False, inj_spec: Any = None, **kw):
    """Construct a SEDAR-protected server (`backend=` as `SedarServer`'s).
    Runs on the card unless `device="cpu"` is passed; raises when no card
    is present."""
    from repro_torch.runtime.serve import SedarServer
    return SedarServer(run_cfg, dual=dual, inj_spec=inj_spec, **kw)
