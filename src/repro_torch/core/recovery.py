"""SEDAR recovery strategies, the part the serving slice runs (the
reference's `core/recovery.py`): L1 `SafeStop` and the L0 re-execution
policy `RetryRecovery`. The checkpoint levels L2/L3 and their stores come
with the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.detection import DetectionEvent


@dataclass
class RecoveryAction:
    kind: str                      # stop | retry | restore | restart_scratch
    step: Optional[int] = None     # checkpoint version to restore
    rollbacks: int = 0             # counter value after this detection
    event: Optional[DetectionEvent] = None


class SafeStop:
    """L1: detection with notification, then a safe stop; never deliver
    defective results (paper Sec. 3.1)."""

    level = 1

    def __init__(self, notify: Optional[Callable[[DetectionEvent], None]] = None):
        self.notify = notify or (lambda e: print(str(e), flush=True))

    def on_detection(self, event: DetectionEvent) -> RecoveryAction:
        self.notify(event)
        return RecoveryAction(kind="stop", event=event)


class RetryRecovery:
    """Pure re-execution for workloads whose step is cheap to redo (the
    serving decode step). Every detection yields `retry`; `rollbacks`
    carries the CONSECUTIVE retry count. A committed step resets it
    (`note_success`, called by the engine), so only `max_retries`
    consecutive failures — a persistent divergence — degrade to the L1 safe
    stop."""

    level = 0

    def __init__(self, max_retries: int = 8):
        self.max_retries = max_retries
        self._consecutive = 0

    def reset(self) -> None:
        self._consecutive = 0

    def note_success(self) -> None:
        self._consecutive = 0

    def on_detection(self, event: DetectionEvent) -> RecoveryAction:
        self._consecutive += 1
        if self.max_retries and self._consecutive > self.max_retries:
            return RecoveryAction(kind="stop", rollbacks=self._consecutive,
                                  event=event)
        return RecoveryAction(kind="retry", rollbacks=self._consecutive,
                              event=event)
