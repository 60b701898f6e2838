"""Replica-free execution backend: ABFT detection through the SEDAR engine
(the reference's `abft/executor.py`).

`AbftExecutor` runs ONE instance of the workload whose protected kernels
carry checksums and report per-invocation verification outcomes. It plugs
into `SedarEngine` as backend "abft" / "hybrid" (`core/policy.py::
make_engine`) and emits the same DetectionEvent stream as the reference:

  * detected-corrected -- a single corrupted element was repaired in place;
    a commit-boundary TDC event whose `repair()` commits the corrected
    candidate FORWARD (rollbacks=0, kind="abft_correct").
  * detected-uncorrectable -- violations that do not localize: the event
    routes through the recovery policy (retry / stop) like a replica
    mismatch.
  * escaped -- below the residual noise floor, in an unprotected kernel, or
    in the QK^T path of checksummed attention. "hybrid" catches the
    resident-state subset: every commit fingerprints the committed state
    (on the device; kernel K1), and at the FSC cadence the NEXT execute
    first re-fingerprints the state it is about to consume and compares.

Host reads: one counted read per step of the packed verdict (label
`abft_verdict`: detected, uncorrectable and the summary fields together,
where the reference reads the report twice), plus, for hybrid, one
`state_validate` read per entry check. The commit-time fingerprint stays on
the device (the reference reads it back at every commit).

step_fn contract: `(state, batch, replica_id, armed) -> (candidate, fp,
aux[, report])`; the 3-tuple form of the replica backends still works
(report None: detection then comes only from hybrid validation).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import hostsync
from repro_torch.core.detection import DetectionEvent
from repro_torch.core.engine import ReplicaExecutor
from repro_torch.core.fingerprint import fingerprints_equal
from repro_torch.core.injection import make_kernel_fault


def _read_verdict(report) -> Tuple[bool, bool, Dict[str, Any]]:
    """ONE counted read of (detected, uncorrectable, summary)."""
    packed = torch.stack([report.detected.float(),
                          report.uncorrectable.float(),
                          report.bad_rows.float(), report.bad_cols.float(),
                          report.max_residual.float()])
    v = hostsync.batched_get([packed], label="abft_verdict")[0]
    return bool(v[0]), bool(v[1]), {"bad_rows": int(v[2]),
                                    "bad_cols": int(v[3]),
                                    "max_residual": float(v[4])}


def logits_checksum_guard(logits, spec, step: int, armed: bool):
    """ABFT output guard over one logits block: full-checksum encode (row and
    column sums of the CLEAN block), the kernel-domain corruption window
    (`InjectionSpec(target='kernel')` faults land between compute and
    verify), then residual verification with single-element forward
    correction. Returns (verified logits in logits.dtype, AbftReport); a
    corrected block flows straight into argmax, so the corrected commit
    emits its token with no re-execution."""
    from repro_torch.abft.ref import verify_and_correct
    lg = logits.float()
    row = lg.sum(dim=1, keepdim=True)                        # (B, 1)
    col = lg.sum(dim=0, keepdim=True)                        # (1, V)
    tot = row.sum(dim=0, keepdim=True)                       # (1, 1)
    c_full = torch.cat([torch.cat([lg, row], dim=1),
                        torch.cat([col, tot], dim=1)], dim=0)  # (B+1, V+1)
    if spec is not None and spec.target == "kernel":
        c_full = make_kernel_fault(spec, step=step, armed=armed)(c_full)
    out, report = verify_and_correct(c_full, inner_dim=lg.shape[1])
    return out.to(logits.dtype), report


class AbftExecutor(ReplicaExecutor):
    """Single-instance executor with checksum-based detection (+ optional
    hybrid fingerprint validation for the escaped-fault classes)."""

    name = "abft"
    n_replicas = 1

    def __init__(self, step_fn: Callable, state_fp_fn: Callable,
                 hybrid: bool = False, validate_interval: int = 0):
        self.step_fn = step_fn
        self.state_fp_fn = state_fp_fn   # hybrid's commit/entry fingerprint
        self.hybrid = hybrid
        self.validate_interval = validate_interval
        if hybrid:
            self.name = "hybrid"
        self._pending_commit = None    # corrected candidate awaiting repair()
        self._last_fp: Optional[torch.Tensor] = None  # fp at last commit
        self._last_fp_step = -1        # step the committed state carries

    @property
    def can_validate(self) -> bool:
        # the engine's post-commit validate would compare the committed
        # state with the fingerprint _commit() just took of it; the periodic
        # at-rest check runs at step ENTRY instead (execute())
        return False

    @property
    def can_validate_final(self) -> bool:
        # the end-of-run comparison is meaningful for hybrid: the state is
        # idle after the last commit
        return self.hybrid

    # -- lifecycle -----------------------------------------------------------

    def init_dual(self, single):
        self._last_fp = None           # restored/fresh state: new baseline
        self._last_fp_step = -1
        self._pending_commit = None
        return {"r0": single}

    def note_external_update(self) -> None:
        # the caller mutated the resident state outside a protected step:
        # the commit-time baseline no longer describes what is resident
        self._last_fp = None
        self._last_fp_step = -1

    # -- execution -----------------------------------------------------------

    def _entry_check_due(self, step: int) -> bool:
        # only against the fingerprint of the very state this step consumes
        # (`_last_fp_step == step`)
        return (self.hybrid and self.validate_interval > 0
                and step % self.validate_interval == 0
                and self._last_fp is not None
                and self._last_fp_step == step)

    def execute(self, dual, batch, step: int, armed, compare: bool):
        # resident-state FSC check at ENTRY, before step_fn consumes the
        # state (afterwards the next commit fingerprint would be
        # self-consistently corrupt); aux is None: the step did not execute
        if self._entry_check_due(step) and not self._resident_fp_equal(dual):
            return dual, None, DetectionEvent(
                step=step, boundary="validate", effect="FSC",
                detail={"reason": "resident state diverged from its "
                        "commit-time fingerprint"})
        outs = self.step_fn(dual["r0"], batch, 0, armed)
        if len(outs) == 4:
            cand, _fp, aux, report = outs
        else:
            cand, _fp, aux = outs
            report = None

        if report is not None:
            detected, uncorrectable, summary = _read_verdict(report)
            if detected:
                if uncorrectable:
                    return dual, aux, DetectionEvent(
                        step=step, boundary="commit", effect="TDC",
                        detail={"abft": summary})
                # repaired in place: committed forward by repair()
                self._pending_commit = {"r0": cand}
                return dual, aux, DetectionEvent(
                    step=step, boundary="commit", effect="TDC",
                    detail={"abft": summary, "abft_corrected": True})
        return self._commit({"r0": cand}, step + 1), aux, None

    def _commit(self, dual, next_step: int):
        if self.hybrid:
            self._last_fp = self.state_fp_fn(dual["r0"])
            self._last_fp_step = next_step
        return dual

    def repair(self, event: DetectionEvent, dual
               ) -> Optional[Tuple[Any, Dict[str, Any]]]:
        if event.detail.get("abft_corrected") and \
                self._pending_commit is not None:
            committed = self._commit(self._pending_commit, event.step + 1)
            self._pending_commit = None
            return committed, {"kind": "abft_correct", "step": None,
                               "rollbacks": 0}
        return None

    # -- FSC boundary (hybrid) -----------------------------------------------

    def _resident_fp_equal(self, dual) -> bool:
        if self._last_fp is None:
            return True
        cur = self.state_fp_fn(dual["r0"])
        return hostsync.read_bool(fingerprints_equal(self._last_fp, cur),
                                  label="state_validate")

    def validate(self, dual, step: int) -> Optional[DetectionEvent]:
        if not self.hybrid or self._resident_fp_equal(dual):
            return None
        return DetectionEvent(step=step, boundary="validate", effect="FSC",
                              detail={"reason": "resident state diverged "
                                      "from its commit-time fingerprint"})
