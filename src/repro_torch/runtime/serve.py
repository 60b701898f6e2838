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

The continuous-batching `serve()` (slot scheduler, per-slot recovery,
emission ring) is the next slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import hostsync
from repro_torch.core.detection import DetectionEvent, SedarSafeStop
from repro_torch.core.engine import BoundarySchedule, SedarEngine
from repro_torch.core.fingerprint import pytree_fingerprint_fused
from repro_torch.core.injection import (InjectionSpec, MemoryInjectionFlag,
                                        inject_tree)
from repro_torch.core.policy import make_engine
from repro_torch.core.recovery import RetryRecovery
from repro_torch.device import make_deterministic, resolve_device
from repro_torch.models import build_model
from repro_torch.runtime.prefill import BucketedPrefill

_UNPORTED_TARGETS = ("kernel", "prefill", "prefill_kernel")


@dataclass
class ServeReport:
    tokens_emitted: int = 0
    detections: List[DetectionEvent] = field(default_factory=list)
    retries: int = 0
    stopped: bool = False          # retry budget exhausted (safe stop)
    wall_s: float = 0.0
    prefill_s: float = 0.0         # until the first token reached the host


class SedarServer:
    """Prefill once, then decode step by step (optionally dual-executed).
    Runs on the card unless `device="cpu"`; raises when no card is found."""

    def __init__(self, run_cfg: RunConfig, dual: bool = False,
                 inj_spec: Optional[InjectionSpec] = None,
                 max_retries: int = 8, device=None):
        self.device = resolve_device(device)
        make_deterministic(self.device)
        self.cfg = run_cfg
        self.model = build_model(run_cfg.model, self.device)
        if inj_spec is not None and inj_spec.target in _UNPORTED_TARGETS:
            raise NotImplementedError(
                f"injection target {inj_spec.target!r} is not ported yet")
        self.inj_spec = inj_spec
        self.inj_flag = MemoryInjectionFlag()
        # Serving boundaries: TDC commit gate on every decode step; no FSC
        # or checkpoint boundary (the KV cache is recomputable from the
        # prompt, recovery is re-execution).
        self.engine: SedarEngine = make_engine(
            run_cfg.sedar,
            backend="sequential" if dual else "none",
            step_fn=self._decode_fn,
            state_fp_fn=lambda s: pytree_fingerprint_fused({"tok": s["tok"]}),
            schedule=BoundarySchedule(
                commit_interval=1, validate_interval=0,
                toe_timeout_s=run_cfg.sedar.toe_timeout_s),
            recovery=RetryRecovery(max_retries=max_retries),
            inj_spec=inj_spec, inj_flag=self.inj_flag,
            notify=lambda e: None)
        self.prefiller = BucketedPrefill(self.model)

    def _decode_fn(self, state, params, replica_id: int, armed: bool
                   ) -> Tuple[Dict[str, Any], torch.Tensor, torch.Tensor]:
        """Engine step_fn: (decode state, params-as-batch, rid, armed) ->
        (candidate state, logits fingerprint, logits)."""
        if self.inj_spec is not None:
            params = inject_tree(params, self.inj_spec, step=state["pos"],
                                 replica_id=replica_id, armed=armed)
        logits, cache = self.model.decode_step(params, state["cache"],
                                               state["tok"], state["pos"])
        fp = pytree_fingerprint_fused({"logits": logits})
        tok = torch.argmax(logits, dim=-1)    # first maximum on ties
        cand = {"cache": cache, "tok": tok, "pos": state["pos"] + 1}
        return cand, fp, logits

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
                # step re-executes through the engine's retry policy
                try:
                    dual = eng.on_detection(outcome.event, dual)
                except SedarSafeStop:
                    rep.stopped = True
                    break
                continue
            out.append(hostsync.read_scalar(eng.executor.peek(dual, "tok"),
                                            label="token_emit"))
            pos += 1

        rep.detections = list(eng.detections)
        rep.retries = sum(1 for r in eng.recoveries if r["kind"] == "retry")
        rep.tokens_emitted = len(out) * B
        rep.wall_s = time.time() - t0
        return np.stack(out, axis=1), rep
