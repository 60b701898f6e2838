"""Engine and server factories (the reference's `core/policy.py`,
`make_engine` for the `none`/`sequential`/`abft`/`hybrid` backends and
`make_server`)."""
from __future__ import annotations

from typing import Any, Callable, Optional


def make_engine(sedar_cfg, *, step_fn: Callable, recovery: Any,
                backend: Optional[str] = None,
                state_fp_fn: Optional[Callable] = None,
                schedule: Any = None, watchdog: Any = None,
                inj_spec: Any = None, inj_flag: Any = None,
                notify: Optional[Callable] = None,
                delay_source: Optional[Callable[[], dict]] = None):
    """Assemble a `SedarEngine` for one workload.

    backend: "none" | "sequential" | "abft" | "hybrid" (defaults to
    sedar_cfg.replication); all but "none" also need `state_fp_fn`.
    abft/hybrid run replica-free: step_fn may return a 4th element (an
    `abft.ref.AbftReport` from checksummed kernels), and hybrid also checks
    the commit-time state fingerprint (`state_fp_fn`; the reference's
    `fast_state_fp_fn`) at the FSC cadence. `recovery` is required: the
    config-derived checkpoint recoveries (L2/L3) are not ported yet."""
    from repro_torch.core.detection import Watchdog
    from repro_torch.core.engine import (BoundarySchedule, PlainExecutor,
                                         SedarEngine, SequentialExecutor)

    backend = backend or sedar_cfg.replication
    schedule = schedule or BoundarySchedule.from_config(sedar_cfg)
    if backend == "none":
        executor = PlainExecutor(step_fn)
    elif backend == "sequential":
        if state_fp_fn is None:
            raise ValueError("backend 'sequential' needs state_fp_fn")
        executor = SequentialExecutor(
            step_fn, state_fp_fn,
            watchdog=watchdog or Watchdog(schedule.toe_timeout_s),
            toe_timeout_s=schedule.toe_timeout_s, delay_source=delay_source)
    elif backend in ("abft", "hybrid"):
        if state_fp_fn is None:
            raise ValueError(f"backend {backend!r} needs state_fp_fn")
        from repro_torch.abft.executor import AbftExecutor
        executor = AbftExecutor(step_fn, state_fp_fn,
                                hybrid=(backend == "hybrid"),
                                validate_interval=schedule.validate_interval)
    else:
        raise NotImplementedError(f"backend {backend!r} is not ported yet")
    return SedarEngine(executor, schedule, recovery, inj_spec=inj_spec,
                       inj_flag=inj_flag, notify=notify)


def make_server(run_cfg, *, dual: bool = False, inj_spec: Any = None, **kw):
    """Construct a SEDAR-protected server (`backend=` as `SedarServer`'s).
    Runs on the card unless `device="cpu"` is passed; raises when no card
    is present."""
    from repro_torch.runtime.serve import SedarServer
    return SedarServer(run_cfg, dual=dual, inj_spec=inj_spec, **kw)
