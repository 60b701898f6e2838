"""Synchronous protected serving (the reference's `runtime/serve.py`,
`SedarServer.generate`).

Decoding is deterministic (greedy), so a dual-replica decode step compares
the logits fingerprints of its two replicas before the token leaves —
"validate the message before sending it to the user". On a mismatch the
token is not emitted and the step re-executes (`RetryRecovery`); after
`max_retries` consecutive failures the run safe-stops (L1).

Per decode step on the card: each replica runs the model and one launch of
kernel K1 over its (B, V) logits; the commit compare is ONE counted
device->host read (`commit_compare`) and the emitted tokens another
(`token_emit`). Prefill runs once, through kernel K2 when
`attention_impl="pallas"`.

Replica-free serving (`backend="abft"|"hybrid"`): ONE decode state, and
each step's (B, V) logits block passes a full-checksum ABFT guard
(`abft/executor.py::logits_checksum_guard`, plain PyTorch as in the
reference). A single-element corruption in the kernel-domain window
(`InjectionSpec(target="kernel")`) is corrected forward and the corrected
commit EMITS its token: no re-execution, rollbacks=0. Per step one counted
read of the verdict (`abft_verdict`) and one of the token. Hybrid also
fingerprints the resident {cache rows [0, pos), tok} with K1 at every
commit and compares at step entry every `param_validate_interval` steps
(`state_validate`).

The continuous-batching `serve()` (slot scheduler, per-slot recovery,
emission ring) is the next slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import hostsync
from repro_torch.core.detection import DetectionEvent, SedarSafeStop
from repro_torch.core.engine import BoundarySchedule, SedarEngine
from repro_torch.abft.executor import logits_checksum_guard
from repro_torch.core.fingerprint import pytree_fingerprint_fused
from repro_torch.core.injection import (InjectionSpec, MemoryInjectionFlag,
                                        inject_tree)
from repro_torch.core.policy import make_engine
from repro_torch.core.recovery import RetryRecovery
from repro_torch.device import make_deterministic, resolve_device
from repro_torch.models import build_model
from repro_torch.runtime.prefill import BucketedPrefill

_UNPORTED_TARGETS = ("prefill", "prefill_kernel")
BACKENDS = ("none", "sequential", "abft", "hybrid")


@dataclass
class ServeReport:
    tokens_emitted: int = 0
    detections: List[DetectionEvent] = field(default_factory=list)
    retries: int = 0
    stopped: bool = False          # retry budget exhausted (safe stop)
    wall_s: float = 0.0
    prefill_s: float = 0.0         # until the first token reached the host


class SedarServer:
    """Prefill once, then decode step by step (dual-executed, replica-free
    ABFT-guarded, or unprotected). Runs on the card unless `device="cpu"`;
    raises when no card is found."""

    def __init__(self, run_cfg: RunConfig, dual: bool = False,
                 inj_spec: Optional[InjectionSpec] = None,
                 max_retries: int = 8, backend: Optional[str] = None,
                 device=None):
        backend = backend or ("sequential" if dual else "none")
        if backend not in BACKENDS:
            raise NotImplementedError(f"backend {backend!r} is not ported "
                                      f"yet (ported: {BACKENDS})")
        if inj_spec is not None and inj_spec.target in _UNPORTED_TARGETS:
            raise NotImplementedError(
                f"injection target {inj_spec.target!r} is not ported yet")
        self.device = resolve_device(device)
        make_deterministic(self.device)
        self.cfg = run_cfg
        self.model = build_model(run_cfg.model, self.device)
        self.backend = backend
        self.inj_spec = inj_spec
        self.inj_flag = MemoryInjectionFlag()
        # Serving boundaries: TDC commit gate on every decode step; no
        # checkpoint boundary (the KV cache is recomputable from the prompt,
        # recovery is re-execution). Hybrid's FSC cadence is its entry check.
        fsc_interval = (int(run_cfg.sedar.param_validate_interval)
                        if backend == "hybrid" else 0)
        self.engine: SedarEngine = make_engine(
            run_cfg.sedar,
            backend=backend,
            step_fn=self._decode_fn,
            state_fp_fn=lambda s: pytree_fingerprint_fused(self._fp_tree(s)),
            schedule=BoundarySchedule(
                commit_interval=1, validate_interval=fsc_interval,
                toe_timeout_s=run_cfg.sedar.toe_timeout_s),
            recovery=RetryRecovery(max_retries=max_retries),
            inj_spec=inj_spec, inj_flag=self.inj_flag,
            notify=lambda e: None)
        self.prefiller = BucketedPrefill(self.model)

    def _fp_tree(self, s) -> Dict[str, Any]:
        """What a state fingerprint covers. Replica backends: the token.
        abft/hybrid: the resident state a decode step consumes, the cache
        rows [0, pos) and the token. A step writes its own cache row `pos`
        in place before anything can fail (models/layers.py::cache_update),
        where the reference's cache is functional; leaving that row out of
        the baseline keeps a failed step's write from showing as at-rest
        corruption at the retry's entry check. Rows >= pos are never read
        before the step that owns them overwrites them."""
        if self.backend not in ("abft", "hybrid"):
            return {"tok": s["tok"]}
        pos = s["pos"]
        return {"cache": {name: c[:, :, :pos] for name, c in s["cache"].items()},
                "tok": s["tok"]}

    def _decode_fn(self, state, params, replica_id: int, armed: bool):
        """Engine step_fn: (decode state, params-as-batch, rid, armed) ->
        (candidate state, logits fingerprint, logits) for the replica
        backends, (candidate, None, logits, AbftReport) for abft/hybrid
        (their executor reads no step fingerprint)."""
        spec = self.inj_spec
        if spec is not None and spec.target != "kernel":
            params = inject_tree(params, spec, step=state["pos"],
                                 replica_id=replica_id, armed=armed)
        logits, cache = self.model.decode_step(params, state["cache"],
                                               state["tok"], state["pos"])
        report = None
        if self.backend in ("abft", "hybrid"):
            logits, report = logits_checksum_guard(logits, spec,
                                                   state["pos"], armed)
        tok = torch.argmax(logits, dim=-1)    # first maximum on ties
        cand = {"cache": cache, "tok": tok, "pos": state["pos"] + 1}
        if report is not None:
            return cand, None, logits, report
        return cand, pytree_fingerprint_fused({"logits": logits}), logits

    def generate(self, params, prompt_batch: Dict[str, Any], steps: int,
                 max_len: Optional[int] = None
                 ) -> "tuple[np.ndarray, ServeReport]":
        """Greedy generation of `steps` tokens per sequence (the first comes
        from prefill). Returns ((B, steps) tokens, report)."""
        rep = ServeReport()
        t0 = time.time()
        eng = self.engine
        eng.reset()
        self.inj_flag.reset()
        eng.recovery.reset()
        tokens = torch.as_tensor(prompt_batch["tokens"]).to(self.device,
                                                             torch.int64)
        B, S = tokens.shape
        max_len = max_len or (S + steps + 8)
        pre = None
        if self.prefiller.supported:
            pre = self.prefiller.prefill_padded(params, tokens, max_len)
        if pre is None:
            pre = self.model.prefill(params, {"tokens": tokens}, max_len)
        logits, cache = pre
        tok = torch.argmax(logits, dim=-1)
        out = [hostsync.read_scalar(tok, label="token_emit")]
        rep.prefill_s = time.time() - t0
        pos = S
        dual = eng.executor.init_dual({"cache": cache, "tok": tok, "pos": pos})

        while len(out) < steps:
            outcome = eng.run_protected_step(dual, params, pos)
            dual = outcome.dual
            if outcome.event is not None:
                # validate-before-send: the token is NOT emitted and the
                # step re-executes through the engine's retry policy — or,
                # for an ABFT-corrected step, repair() commits it forward
                # and its token is emitted (pos is a host int: no read)
                try:
                    dual = eng.on_detection(outcome.event, dual)
                except SedarSafeStop:
                    rep.stopped = True
                    break
                if eng.executor.peek(dual, "pos") > pos:
                    out.append(hostsync.read_scalar(
                        eng.executor.peek(dual, "tok"), label="token_emit"))
                    pos += 1
                continue
            out.append(hostsync.read_scalar(eng.executor.peek(dual, "tok"),
                                            label="token_emit"))
            pos += 1

        rep.detections = list(eng.detections)
        rep.retries = sum(1 for r in eng.recoveries if r["kind"] == "retry")
        rep.tokens_emitted = len(out) * B
        rep.wall_s = time.time() - t0
        return np.stack(out, axis=1), rep
