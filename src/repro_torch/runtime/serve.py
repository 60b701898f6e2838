"""Protected serving (the reference's `runtime/serve.py`): the synchronous
whole-batch `SedarServer.generate` and the continuous-batching
`SedarServer.serve`.

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

Single-launch replication (`backend="fused"`): both replicas' states are
stacked as row blocks of one state (2B rows; the cache (L, 2B, T, KV,
hd)) and ONE decode steps them; rows i and B + i are compared on the
device. The decode's attention, its feature means and xlstm's gate
products run per replica half (their kernels round a row by how many
rows run beside it, `models/layers.py::row_blocks`), so each half keeps
a replica's own bits; every other operation runs once over the 2B rows.
A parameter fault is decided on the host for one replica: on the step
it fires, the corrupted launch runs first, then the shared-weight launch,
whose bits every clean row keeps, and the corrupted replica's cache rows
are put back as the corrupted launch left them (`_fused_forward`).

Continuous batching, `serve()` (every backend above): a `SlotScheduler`
packs independent requests into N sequence slots, each with its own
KV-cache rows, token and position; one protected decode step runs over the
packed batch at per-row positions, with a PER-SLOT fingerprint (one K1
call per slot row per replica: N per replica for sequential, 2N in one
fused launch), so detections are localized to slots and the paper's
recovery levels re-scope from "the run" to "the request":

  * transient slot mismatch at lag 1 -> partial commit + per-slot retry;
  * deferred-window fault (`validate_lag` D > 1) -> rollback of ONLY the
    affected slots from the Tier-0 `SlotRing` (device copies, no disk);
  * exhausted slot budget -> that REQUEST is rejected (L1 scoped to one
    sequence); the server keeps serving.

At lag D > 1 a fault-free decode tick reads nothing from the device:
tokens park in the engine's `TokenRing` and leave in ONE `batched_get` per
flush window together with the combined commit predicate (`token_emit`),
and a detokenize consumer thread appends them to the request streams.
Admission runs a packed, protected prefill (`BucketedPrefill.
protected_pack`: up to `max_pack` prompts of one bucket, both replicas,
per-row lanes through K1, prefill attention through K2; under abft/hybrid
the checksum guard's per-prompt verdict, a forward-corrected pack admitted
with an `abft_corrected` prefill event) with ONE `prefill_emit` read per
pack.

Replica-free `serve()` (abft/hybrid): ONE packed state, the (N, V) logits
block through the checksum guard every tick (lag 1: the engine's deferred
window needs a replica predicate). Hybrid's resident baseline covers each
slot's cache rows [0, pos[i]) and the tokens, one K1 launch whose row
limits it reads from the device (`core/fingerprint.py::
slot_rows_fingerprint`): no host read of `pos`, and the rows a failed
step or an idle slot writes in place never count.

The port's decode state is `{cache, tok (N, 1), pos (N,), active (N,),
t}`. Only the cache is written in place; `tok`, `pos` and `active` are
replaced by new tensors at every step and state surgery (the emission ring
parks them), and `t`, the decode tick that gates injection, is a host int.
The mesh backends ("pod", "vote") serve in neither package and train only;
live autotuning and the telemetry calls are not ported.

Model families: `generate()` serves all six families the port builds
(dense, moe, hybrid, vlm, ssm, audio) under every backend. A vlm prompt
passes its frontend's `frontend_embeds` (B, P, D) and decode starts at
position S + P; an audio prompt passes the encoder's frames as
`frontend_embeds` and decode starts at S (the frames are not decoder
positions). `serve()` takes the token-prompt families (dense, moe, hybrid,
ssm), as the reference does. What the non-dense state needs:

  * the fused backend decodes both replicas' rows together, every
    family alike (above); a fused MoE pack prefills each copy on its own,
    and a MoE layer routes each replica, and each `serve()` slot, as its
    own dispatch group (the reference's vmaps, `models/moe.py`);
  * the state is a tree: dense or ring KV caches written in place,
    recurrent states replaced each step, a cross cache written once.
    Slot surgery finds each leaf's slot axis in `Model.slot_axes`, and
    hybrid's resident baseline takes each leaf by its `Model.cache_roles`
    role (`_fp_tree`, `slot_rows_fingerprint`);
  * admission: a moe prompt is packed, never padded (exact-length packs,
    `BucketedPrefill.may_pack`); hybrid and ssm prompts take the exact
    B=1 prefill (`_admit_slot`), as in the reference.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch import tree as tree_util
from repro_torch.abft.executor import logits_checksum_guard
from repro_torch.checkpoint.tiers import SlotRing
from repro_torch.configs.base import RunConfig
from repro_torch.core import hostsync
from repro_torch.core.detection import DetectionEvent, SedarSafeStop
from repro_torch.core.engine import BoundarySchedule, SedarEngine
from repro_torch.core.fingerprint import (pytree_fingerprint_fused,
                                          slot_fingerprints,
                                          slot_rows_fingerprint)
from repro_torch.core.injection import (InjectionSpec, MemoryInjectionFlag,
                                        inject_row, inject_row_halves,
                                        inject_tree)
from repro_torch.core.policy import make_engine
from repro_torch.core.recovery import RetryRecovery, SlotRecovery
from repro_torch.device import make_deterministic, resolve_device, upload
from repro_torch.models import build_model
from repro_torch.runtime.emission import DetokenizeConsumer, TokenRing
from repro_torch.runtime.prefill import (VERDICT_BAD, VERDICT_CORRECTED,
                                         BucketedPrefill, group_packs)
from repro_torch.runtime.scheduler import (DRAINING, RUNNING, RequestQueue,
                                           SlotScheduler)

BACKENDS = ("none", "sequential", "fused", "abft", "hybrid")
# targets a decode step's parameter injection leaves to another stage
_NOT_PARAMS = ("kernel", "prefill", "prefill_kernel")


@dataclass
class ServeReport:
    tokens_emitted: int = 0
    detections: List[DetectionEvent] = field(default_factory=list)
    retries: int = 0
    stopped: bool = False          # retry budget exhausted (safe stop)
    wall_s: float = 0.0
    prefill_s: float = 0.0         # until the first token reached the host


@dataclass
class BatchServeReport:
    """Outcome of one continuous-batching `serve()` run."""

    tokens_emitted: int = 0        # tokens delivered by COMPLETED requests
    steps: int = 0                 # protected decode steps executed
    wall_s: float = 0.0
    detections: List[DetectionEvent] = field(default_factory=list)
    retries: int = 0               # per-slot re-executions (L0)
    rollbacks: int = 0             # slot restores from the Tier-0 ring
    truncated_tokens: int = 0      # optimistic tokens rolled back + redone
    completed: List[int] = field(default_factory=list)   # request ids
    rejected: List[int] = field(default_factory=list)    # request ids
    stopped: bool = False
    prefill_packs: int = 0         # packed prefill launches (incl. retries)
    prefill_retries: int = 0       # per-prompt prefill re-executions

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_emitted / max(self.wall_s, 1e-9)

    @property
    def goodput_tokens_per_step(self) -> float:
        """Delivered tokens per protected step (wall-clock free)."""
        return self.tokens_emitted / max(self.steps, 1)


def _put(x: torch.Tensor, slot: int, value: torch.Tensor) -> torch.Tensor:
    """A new tensor equal to `x` with row `slot` set to the device tensor
    `value` (the emission ring may hold `x`: it is never written)."""
    y = x.clone()
    y[slot].copy_(value.reshape(y[slot].shape))
    return y


def _put_flag(x: torch.Tensor, slot: int, value: bool) -> torch.Tensor:
    """A new bool tensor equal to `x` with element `slot` set to `value`
    (a fill: assigning a Python scalar would copy it from the host)."""
    y = x.clone()
    y[slot].fill_(bool(value))
    return y


class SedarServer:
    """Prefill once, then decode step by step (dual-executed, in two
    launches or one fused launch; replica-free ABFT-guarded; or
    unprotected). Runs on the card unless `device="cpu"`; raises when no
    card is found."""

    def __init__(self, run_cfg: RunConfig, dual: bool = False,
                 inj_spec: Optional[InjectionSpec] = None,
                 max_retries: int = 8, backend: Optional[str] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 max_pack: int = 4, device=None):
        backend = backend or ("sequential" if dual else "none")
        if backend not in BACKENDS:
            raise NotImplementedError(f"backend {backend!r} is not ported "
                                      f"yet (ported: {BACKENDS})")
        self.device = resolve_device(device)
        make_deterministic(self.device)
        self.cfg = run_cfg
        self.model = build_model(run_cfg.model, self.device)
        self.backend = backend
        self.inj_spec = inj_spec
        self.inj_flag = MemoryInjectionFlag()
        self.max_retries = max_retries
        # continuous-batching engines, keyed (slots, max_len, lag)
        self._batch_engines: Dict[Tuple[int, int, int],
                                  Tuple[SedarEngine, SlotRing,
                                        SlotRecovery]] = {}
        # Serving boundaries: TDC commit gate on every decode step; no
        # checkpoint boundary (the KV cache is recomputable from the prompt,
        # recovery is re-execution). Hybrid's FSC cadence is its entry check.
        fsc_interval = (int(run_cfg.sedar.param_validate_interval)
                        if backend == "hybrid" else 0)
        self._fsc_interval = fsc_interval
        self.engine: SedarEngine = make_engine(
            run_cfg.sedar,
            backend=backend,
            step_fn=(self._fused_decode_fn if backend == "fused"
                     else self._decode_fn),
            state_fp_fn=lambda s: pytree_fingerprint_fused(self._fp_tree(s)),
            schedule=BoundarySchedule(
                commit_interval=1, validate_interval=fsc_interval,
                toe_timeout_s=run_cfg.sedar.toe_timeout_s),
            recovery=RetryRecovery(max_retries=max_retries),
            inj_spec=inj_spec, inj_flag=self.inj_flag,
            notify=lambda e: None)
        self.prefiller = BucketedPrefill(
            self.model, backend=backend, inj_spec=inj_spec,
            inj_flag=self.inj_flag, buckets=prefill_buckets,
            max_pack=max_pack)

    def _fp_tree(self, s) -> Dict[str, Any]:
        """What a state fingerprint covers. Replica backends: the token.
        abft/hybrid: the resident state a decode step consumes and the
        token, each cache leaf by its role (`Model.cache_roles`): a KV
        cache's rows [0, pos), a ring's live rows but pos % W, a recurrent
        state or cross cache whole. A step writes its own cache row (ring
        slot) in place before anything can fail (models/layers.py::
        cache_update), where the reference's cache is functional; leaving
        that row out of the baseline keeps a failed step's write from
        showing as at-rest corruption at the retry's entry check. Rows >=
        pos are never read before the step that owns them overwrites them;
        recurrent states come back as new tensors each step."""
        if self.backend not in ("abft", "hybrid"):
            return {"tok": s["tok"]}
        pos, W = s["pos"], self.cfg.model.window_size

        def live(c, role, ax):
            if role == "whole":
                return c
            rows = c.narrow(ax + 1, 0, min(pos, c.shape[ax + 1]))
            if role == "rows" or pos < c.shape[ax + 1]:
                return rows
            e = pos % W                 # the ring slot this step writes
            return {"a": c.narrow(ax + 1, 0, e),
                    "b": c.narrow(ax + 1, e + 1, c.shape[ax + 1] - e - 1)}
        return {"cache": tree_util.tree_map(live, s["cache"],
                                            self.model.cache_roles(),
                                            self.model.slot_axes()),
                "tok": s["tok"]}

    def _decode_fn(self, state, params, replica_id: int, armed: bool):
        """Engine step_fn: (decode state, params-as-batch, rid, armed) ->
        (candidate state, logits fingerprint, logits) for the replica
        backends, (candidate, None, logits, AbftReport) for abft/hybrid
        (their executor reads no step fingerprint)."""
        spec = self.inj_spec
        if spec is not None and spec.target not in _NOT_PARAMS:
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

    def _fused_forward(self, params, cache, tok, pos, *, step: int,
                       armed: bool, skip: Tuple[str, ...]):
        """One decode of a stacked state's 2B rows -> (logits (2B, V), cache).
        A parameter fault (a spec whose target is not in `skip`) fires for
        ONE replica, decided on the host as `inject_tree` decides it. On
        that step the corrupted launch runs first and the shared-weight
        launch second, so every clean row keeps the bits of the launch
        without the fault; the corrupted replica takes its logits rows
        from the first launch and gets back the cache rows it wrote (both
        launches write row `pos` of every row in place)."""
        spec = self.inj_spec
        bad = params
        if (spec is not None and spec.target not in skip
                and spec.replica in (0, 1)):
            bad = inject_tree(params, spec, step=step,
                              replica_id=spec.replica, armed=armed)

        def decode(p):
            # the row-sensitive ops per replica half (`layers.row_blocks`)
            return self.model.decode_step(p, cache, tok, pos, row_blocks=2)

        if bad is params:
            return decode(params)
        n, r = tok.shape[0] // 2, spec.replica
        axes = self.model.slot_axes()
        logits_bad, cache_bad = decode(bad)
        # the corrupted replica's rows of every leaf as its launch left
        # them (KV caches in place, recurrent states new)
        kept = tree_util.tree_map(lambda c, ax: c.narrow(ax, r * n, n).clone(),
                                  cache_bad, axes)
        del cache_bad
        logits, cache = decode(params)
        tree_util.tree_map(lambda c, k, ax: c.narrow(ax, r * n, n).copy_(k),
                           cache, kept, axes)
        halves = [logits[:n], logits[n:]]
        halves[r] = logits_bad[r * n:(r + 1) * n]
        return torch.cat(halves), cache

    def _fused_decode_fn(self, stacked, params, armed: bool):
        """Fused engine step_fn for `generate()`: both replicas' B rows in
        one decode, one K1 call per replica's (B, V) logits block."""
        pos = stacked["pos"]
        logits, cache = self._fused_forward(
            params, stacked["cache"], stacked["tok"], pos, step=pos,
            armed=armed, skip=_NOT_PARAMS)
        b = logits.shape[0] // 2
        fps = torch.stack([pytree_fingerprint_fused({"logits": logits[:b]}),
                           pytree_fingerprint_fused({"logits": logits[b:]})])
        tok = torch.argmax(logits, dim=-1)    # first maximum on ties
        return {"cache": cache, "tok": tok, "pos": pos + 1}, fps, logits[:b]

    def generate(self, params, prompt_batch: Dict[str, Any], steps: int,
                 max_len: Optional[int] = None
                 ) -> "tuple[np.ndarray, ServeReport]":
        """Greedy generation of `steps` tokens per sequence (the first comes
        from prefill). `prompt_batch`: {"tokens" (B, S)[, "frontend_embeds"
        (B, P, D)]}; a vlm frontend's P positions come before the tokens,
        and decode starts at S + P; an audio frontend's frames feed the
        encoder, and decode starts at S. Returns ((B, steps) tokens,
        report)."""
        rep = ServeReport()
        t0 = time.time()
        eng = self.engine
        eng.reset()
        self.inj_flag.reset()
        eng.recovery.reset()
        tokens = torch.as_tensor(prompt_batch["tokens"]).to(self.device,
                                                             torch.int64)
        B, S = tokens.shape
        batch = {"tokens": tokens}
        fe = prompt_batch.get("frontend_embeds")
        if fe is not None:
            batch["frontend_embeds"] = torch.as_tensor(fe).to(self.device)
        P = (batch["frontend_embeds"].shape[1]
             if fe is not None and self.cfg.model.family == "vlm" else 0)
        max_len = max_len or (S + P + steps + 8)
        pre = None
        if self.prefiller.supported and fe is None:    # may pad
            pre = self.prefiller.prefill_padded(params, tokens, max_len)
        if pre is None:
            pre = self.model.prefill(params, batch, max_len)
        logits, cache = pre
        tok = torch.argmax(logits, dim=-1)
        out = [hostsync.read_scalar(tok, label="token_emit")]
        rep.prefill_s = time.time() - t0
        pos = S + P
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

    # ------------------------------------------------------------------
    # Continuous-batching protected decode
    # ------------------------------------------------------------------

    def _make_packed_decode(self):
        """Packed step_fn over N sequence slots, each with its own cache
        rows, token and position (decoded at per-row positions: the
        reference's vmap of the B=1 decode). The sequential backend returns
        per-slot fingerprints (N, 4) — one K1 call per row, rows of inactive
        slots zeroed — so the slotted executor localizes mismatches;
        abft/hybrid pass the (N, V) logits block through the checksum guard
        and return its report; the unprotected backend computes neither.
        Inactive slots keep their positions; the cache rows they write are
        garbage that an admission overwrites whole."""
        spec = self.inj_spec
        model = self.model
        replicated = self.backend == "sequential"
        guarded = self.backend in ("abft", "hybrid")

        def step(state, params, replica_id: int, armed: bool):
            t = state["t"]
            if spec is not None and spec.target not in _NOT_PARAMS + (
                    "slot",):
                params = inject_tree(params, spec, step=t,
                                     replica_id=replica_id, armed=armed)
            logits, cache = model.decode_step(params, state["cache"],
                                              state["tok"][:, 0],
                                              state["pos"])
            # slot-localized SDC: one bit of ONE slot's logits row
            # (spec.leaf_idx is the slot) on the chosen replica
            logits = inject_row(logits, spec, target="slot", tick=t,
                                replica_id=replica_id, armed=armed)
            report = None
            if guarded:
                logits, report = logits_checksum_guard(logits, spec, t,
                                                       armed)
            act = state["active"]
            fp = slot_fingerprints(logits, act) if replicated else None
            tok = torch.argmax(logits, dim=-1)[:, None]
            cand = {"cache": cache, "tok": tok,
                    "pos": torch.where(act, state["pos"] + 1, state["pos"]),
                    "active": act, "t": t + 1}
            # aux = the emission pair the engine's TokenRing parks per tick
            if report is not None:
                return cand, fp, (tok, cand["pos"]), report
            return cand, fp, (tok, cand["pos"])

        return step

    def _make_fused_packed_decode(self):
        """Fused packed step_fn over the stacked 2N slot rows: one decode,
        the slot fault on its replica's half, one K1 call per row (2N), the
        fingerprints as (2, N, 4); aux is replica 0's emission pair."""
        spec = self.inj_spec

        def step(stacked, params, armed: bool):
            t = stacked["t"]
            logits, cache = self._fused_forward(
                params, stacked["cache"], stacked["tok"][:, 0],
                stacked["pos"], step=t, armed=armed,
                skip=_NOT_PARAMS + ("slot",))
            logits = inject_row_halves(logits, spec, target="slot", tick=t,
                                       armed=armed)
            act = stacked["active"]
            n = act.shape[0] // 2
            fp = slot_fingerprints(logits, act)
            tok = torch.argmax(logits, dim=-1)[:, None]
            pos = torch.where(act, stacked["pos"] + 1, stacked["pos"])
            cand = {"cache": cache, "tok": tok, "pos": pos, "active": act,
                    "t": t + 1}
            return cand, fp.reshape(2, n, fp.shape[-1]), (tok[:n], pos[:n])

        return step

    def _batch_engine(self, slots: int, max_len: int, lag: int
                      ) -> Tuple[SedarEngine, SlotRing, SlotRecovery]:
        key = (slots, max_len, lag)
        if key not in self._batch_engines:
            ring = SlotRing(slots_per_key=4)
            recovery = SlotRecovery(ring, max_retries=self.max_retries)
            if self.backend in ("abft", "hybrid"):
                roles, axes = self.model.cache_roles(), self.model.slot_axes()
                W = self.cfg.model.window_size

                def state_fp(s):
                    return slot_rows_fingerprint(s["cache"], s["pos"],
                                                 s["tok"], roles=roles,
                                                 axes=axes, window=W)
            else:
                def state_fp(s):
                    return pytree_fingerprint_fused({"tok": s["tok"]})
            eng = make_engine(
                self.cfg.sedar,
                backend=self.backend,
                step_fn=(self._make_fused_packed_decode()
                         if self.backend == "fused"
                         else self._make_packed_decode()),
                state_fp_fn=state_fp,
                schedule=BoundarySchedule(
                    commit_interval=1, validate_interval=self._fsc_interval,
                    checkpoint_interval=0,
                    toe_timeout_s=self.cfg.sedar.toe_timeout_s,
                    validate_lag=lag),
                recovery=recovery,
                inj_spec=self.inj_spec, inj_flag=self.inj_flag,
                notify=lambda e: None,
                slots=(slots if self.backend in ("sequential", "fused")
                       else None))
            self._batch_engines[key] = (eng, ring, recovery)
        return self._batch_engines[key]

    # -- packed-state surgery (device side; no host reads) -------------------

    def _write_slot(self, eng, dual, slot: int, sl, active: bool = True):
        """Write one slot slice {cache (each leaf's slot axis at size 1),
        tok, pos} into EVERY replica image (admission, rollback merge): the
        cache leaves in place, tok/pos/active as new tensors."""
        axes = self.model.slot_axes()

        def write(st):
            tree_util.tree_map(
                lambda c, s, ax: c.narrow(ax, slot, 1).copy_(s),
                st["cache"], sl["cache"], axes)
            return {**st, "tok": _put(st["tok"], slot, sl["tok"]),
                    "pos": _put(st["pos"], slot, sl["pos"]),
                    "active": _put_flag(st["active"], slot, active)}
        dual = eng.executor.map_state(write, dual)
        eng.executor.note_external_update()
        return dual

    def _set_active(self, eng, dual, slot: int, value: bool):
        dual = eng.executor.map_state(
            lambda st: {**st, "active": _put_flag(st["active"], slot, value)},
            dual)
        eng.executor.note_external_update()
        return dual

    def _slot_slice(self, eng, dual, slot: int):
        """Views of replica 0's slot image {cache rows, tok, pos}, for
        `SlotRing.save`, which clones them."""
        cache = eng.executor.peek(dual, "cache")
        return {"cache": tree_util.tree_map(
                    lambda c, ax: c.narrow(ax, slot, 1), cache,
                    self.model.slot_axes()),
                "tok": eng.executor.peek(dual, "tok")[slot],
                "pos": eng.executor.peek(dual, "pos")[slot]}

    def _snapshot_slots(self, eng, dual, sched, ring, version: int) -> None:
        """Tier-0 per-slot snapshots at a clean flush edge: every RUNNING
        slot's image enters its keyed device ring (device copies, no host
        read), so a rollback target never predates a delivered token."""
        slices = {slot: self._slot_slice(eng, dual, slot)
                  for slot, _req in sched.running_items()}
        if slices:
            ring.save_many(version, slices)

    def _admit_slot(self, eng, dual, params, slot: int, req, t: int,
                    ring, ring_on: bool, max_len: int):
        """Prefill `req` into a freed slot on its own (exact-shape B=1
        prefill: prompts longer than the bucket ladder, or
        `packed_prefill=False`), write it into the packed state, cut its
        admission snapshot and emit its prefill token."""
        dev = self.device
        prompt = upload(req.prompt[None, :].astype(np.int64), dev)
        with obs.span("prefill_pack", step=t, pack=1, packed=False):
            logits, cache = self.model.prefill(params, {"tokens": prompt},
                                               max_len)
        tok = torch.argmax(logits, dim=-1)                       # (1,)
        sl = {"cache": cache, "tok": tok,
              "pos": torch.full((), req.prompt_len, dtype=torch.int64,
                                device=dev)}
        ring.evict(slot)           # never resurrect a previous tenant
        dual = self._write_slot(eng, dual, slot, sl, active=True)
        if ring_on:
            ring.save(slot, t, sl)
        req.pos0 = req.prompt_len
        # the prefill token is single-execution (like generate()): the
        # replica-validated stream starts at the first decode step
        req.tokens.append(int(hostsync.read_scalar(
            tok, label="prefill_emit")[0]))
        req.token_times.append(time.time())
        return dual

    def _insert_rows(self, eng, dual, res, placed: List[Tuple[int, int]]):
        """Write pack rows into slots ([(row, slot)]) of every replica
        image: cache rows in place, tok/pos/active as new tensors."""
        rows, toks, lens = res["rows"], res["tok"], res["lengths"]
        axes = self.model.slot_axes()

        def write(st):
            tok, pos = st["tok"].clone(), st["pos"].clone()
            act = st["active"].clone()
            for i, slot in placed:
                tree_util.tree_map(
                    lambda c, r, ax: c.narrow(ax, slot, 1).copy_(r[i]),
                    st["cache"], rows, axes)
                tok[slot].copy_(toks[i])
                pos[slot].copy_(lens[i])
                act[slot].fill_(True)
            return {**st, "tok": tok, "pos": pos, "active": act}
        dual = eng.executor.map_state(write, dual)
        eng.executor.note_external_update()
        return dual

    def _admit_pack(self, eng, dual, params, pairs, t: int, ring,
                    ring_on: bool, max_len: int, rep: BatchServeReport,
                    sched, notify, events: List[DetectionEvent]):
        """Protected packed admission: ONE prefill per replica (one for both
        under fused) computes the caches, first tokens and per-prompt
        verdicts of the whole pack, ONE `batched_get` reads {tokens,
        verdicts}, the admitted rows are written into their slots and their
        SlotRing snapshots cut. A faulty row is retried ALONE (the clean
        rows are admitted at once); a forward-corrected pack (abft/hybrid)
        is admitted with an `abft_corrected` prefill event; a persistent
        fault exhausts the retry budget into a per-request rejection."""
        spec = self.inj_spec
        for slot, _req in pairs:
            ring.evict(slot)       # never resurrect a previous tenant
        pairs = list(pairs)
        prompts = [r.prompt for _, r in pairs]
        need = list(range(len(pairs)))   # rows not yet admitted
        budget = self.max_retries
        while need:
            # retries relaunch the original pack, so a stuck lane keeps
            # hitting the same occupant; admitted rows are recomputed, not
            # re-admitted
            with obs.span("prefill_pack", step=t, pack=len(pairs)):
                res = self.prefiller.protected_pack(params, prompts,
                                                    max_len, t)
            rep.prefill_packs += 1
            toks, verdicts = hostsync.batched_get(
                [res["tok"], res["verdict"]], label="prefill_emit")
            good = [i for i in need if int(verdicts[i]) != VERDICT_BAD]
            bad = [i for i in need if int(verdicts[i]) == VERDICT_BAD]
            corrected = [i for i in good
                         if int(verdicts[i]) == VERDICT_CORRECTED]
            if good:
                dual = self._insert_rows(eng, dual, res,
                                         [(i, pairs[i][0]) for i in good])
                if ring_on:
                    ring.save_many(t, {
                        pairs[i][0]: {
                            "cache": tree_util.tree_map(
                                lambda r, j=i: r[j], res["rows"]),
                            "tok": res["tok"][i], "pos": res["lengths"][i]}
                        for i in good})
                now_wall = time.time()
                for i in good:
                    _slot, req = pairs[i]
                    req.pos0 = req.prompt_len
                    # the row's lanes agreed before this read
                    req.tokens.append(int(toks[i, 0]))
                    req.token_times.append(now_wall)
            if corrected:
                # prefill events never pass through eng.on_detection (the
                # pack retries inline), so the correction is journaled here
                ev = DetectionEvent(
                    step=t, boundary="prefill", effect="abft_corrected",
                    detail={"slots": [pairs[i][0] for i in corrected],
                            "rids": [pairs[i][1].rid for i in corrected]})
                events.append(ev)
                obs.note_detection(ev)
            if (bad or corrected) and spec is not None \
                    and not spec.persistent:
                self.inj_flag.mark()   # the transient fault manifested
                # (detected or corrected): it must not re-fire on the retry
                # or in a later stage
            if not bad:
                break
            ev = DetectionEvent(
                step=t, boundary="prefill", effect="TDC",
                detail={"slots": [pairs[i][0] for i in bad],
                        "rids": [pairs[i][1].rid for i in bad]})
            events.append(ev)
            obs.note_detection(ev)
            budget -= 1
            if budget <= 0:
                for i in bad:
                    slot, req = pairs[i]
                    sched.reject(slot, "prefill validation failed: "
                                 "consecutive retry budget exhausted")
                    rep.rejected.append(req.rid)
                    obs.note_rejection(t, rid=req.rid, slot=slot,
                                       reason="prefill_persistent")
                    if notify is not None:
                        notify(req, events[-1])
                break
            rep.prefill_retries += len(bad)
            need = bad
        return dual

    def _finish(self, sched, slot: int, rep: BatchServeReport) -> None:
        """Release a drained slot exactly once: a slot no longer draining
        (released or reactivated by another path) is skipped."""
        req = sched.request(slot)
        if req is None or req.status != DRAINING:
            return
        req = sched.release(slot)
        rep.completed.append(req.rid)

    def _release_drained(self, eng, sched, rep: BatchServeReport) -> None:
        for slot, req in list(sched.draining_items()):
            if eng.validated_frontier >= req.finish_step:
                self._finish(sched, slot, rep)

    def _handle_event(self, eng, recovery, sched, ring, event, dual,
                      rep: BatchServeReport, notify=None, expected=None,
                      consumer=None):
        """Per-request recovery: route the event through the engine (slot
        retry / ring restore), then apply the request-level consequences —
        stream truncation for rolled-back slots, eviction and notification
        for rejected requests, release of draining slots a failed flush
        proved clean.

        Drain mode (`expected`, the host-side token-count map): the failed
        flush already retracted the faulty slots' undrained rows from the
        emission ring, so the restore just resets the slot's optimistic
        count. The consumer is quiesced FIRST so rejection callbacks see
        the delivered prefix."""
        if consumer is not None:
            consumer.quiesce()
        try:
            dual = eng.on_detection(event, dual)
        except SedarSafeStop:
            rep.stopped = True
            return dual
        for slot in recovery.take_rejections():
            req = sched.request(slot)
            if req is not None:
                sched.reject(slot, "per-request safe stop: consecutive "
                             "retry budget exhausted")
                rep.rejected.append(req.rid)
                obs.note_rejection(event.step, rid=req.rid, slot=slot,
                                   reason="persistent_fault")
                if notify is not None:
                    notify(req, event)
            ring.evict(slot)
            if expected is not None:
                expected.pop(slot, None)
            dual = self._set_active(eng, dual, slot, False)
        for slot, info in recovery.take_restores().items():
            req = sched.request(slot)
            if req is None:
                continue
            rep.rollbacks += 1
            keep = max(info["pos"] - req.pos0 + 1, 1)
            if expected is not None:
                expected[slot] = keep
            elif len(req.tokens) > keep:
                cut = len(req.tokens) - keep
                req.truncated_tokens += cut
                rep.truncated_tokens += cut
                del req.tokens[keep:]
                del req.token_times[keep:]
            if req.status == DRAINING:
                sched.reactivate(slot)   # rollback reached its final window
        if event.boundary == "deferred":
            # the failed flush examined every parked predicate: draining
            # slots it did not implicate are proven clean — release them
            bad = set(event.detail.get("slots", []))
            for slot, _req in list(sched.draining_items()):
                if slot not in bad:
                    self._finish(sched, slot, rep)
        return dual

    def serve(self, params, requests, *, slots: int = 4,
              max_len: Optional[int] = None,
              validate_lag: Optional[int] = None, queue_depth: int = 0,
              max_steps: Optional[int] = None, notify_reject=None,
              packed_prefill: bool = True, autotune=None,
              drain_cadence: Optional[int] = None, on_token=None,
              consumer_depth: int = 8):
        """Continuous-batching protected decode over an open-loop request
        stream. Mutates and returns the `Request` objects (lifecycle fields
        are reset first, so a template list can be replayed) plus a
        `BatchServeReport`.

        `validate_lag` > 1 arms the deferred window (sequential and fused
        backends; abft/hybrid run at lag 1):
        the fault-free decode tick reads nothing from the device, detection
        lags by <= D steps, and a detected fault rolls back only the
        affected slots from the Tier-0 ring; tokens leave through the
        engine's TokenRing at the flush cadence and are delivered by a
        detokenize consumer thread. `drain_cadence` sets how many parked
        ticks a drain waits for (None: the lag; 1: the per-tick emission
        read); `on_token(req, tok, index)` streams each delivered token
        (from the consumer thread in drain mode); `consumer_depth` bounds
        the consumer's queue. `queue_depth` bounds the admission queue (a
        full queue rejects at once); `packed_prefill=False` admits each
        request with its own exact-shape prefill. `autotune` (a
        `core/policy.py::Autotuner` with mode="serve") retunes the lag at
        clean flush boundaries: the loop re-reads the lag every tick, the
        drain cadence follows it, and dropping to lag 1 delivers everything
        parked; the engine's reset() restores the configured lag for the
        next call."""
        if self.cfg.model.frontend:
            raise NotImplementedError(
                "continuous batching serves token-prompt families; frontend "
                "(VLM/audio) prompts need per-request embed plumbing")
        rep = BatchServeReport()
        t0 = time.time()
        for r in requests:
            r.status, r.slot = "pending", None
            r.tokens, r.token_times = [], []
            r.pos0, r.admit_step, r.finish_step = 0, None, None
            r.truncated_tokens, r.reject_reason = 0, ""
            r.arrival_time = None
        max_prompt = max((r.prompt_len for r in requests), default=8)
        max_new = max((r.max_new_tokens for r in requests), default=8)
        max_len = max_len or (max_prompt + max_new + 8)
        lag = int(validate_lag if validate_lag is not None
                  else self.cfg.sedar.validate_lag)
        eng, ring, recovery = self._batch_engine(slots, max_len, max(lag, 1))
        eng.reset()
        recovery.reset()
        self.inj_flag.reset()
        recovery.merge = lambda dual, slot, sl: self._write_slot(
            eng, dual, slot, sl, active=True)
        ring_on = eng.validate_lag > 1   # the clamped lag: deferred mode
        # lag-aligned drain: tokens leave through flush_deferred's read and
        # reach the request streams through the consumer thread
        drain_on = ring_on and (drain_cadence is None
                                or int(drain_cadence) > 1)
        tokring = consumer = None
        expected: Dict[int, int] = {}   # slot -> optimistic token count
        if drain_on:
            consumer = DetokenizeConsumer(on_token=on_token,
                                          max_queue=consumer_depth).start()
            tokring = TokenRing(
                cadence=(int(drain_cadence) if drain_cadence
                         else eng.validate_lag),
                sink=consumer.submit)
            eng.emission_ring = tokring

        sched = SlotScheduler(slots, RequestQueue(queue_depth))
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        dev = self.device
        state = {"cache": self.model.init_cache(slots, max_len),
                 "tok": torch.zeros((slots, 1), dtype=torch.int64,
                                    device=dev),
                 "pos": torch.zeros((slots,), dtype=torch.int64, device=dev),
                 "active": torch.zeros((slots,), dtype=torch.bool,
                                       device=dev),
                 "t": 0}
        dual = eng.executor.init_dual(state)

        use_packed = packed_prefill and self.prefiller.may_pack
        exact = not self.prefiller.supported   # packed, never padded
        prefill_events: List[DetectionEvent] = []
        t = 0
        cap = max_steps or (sum(r.max_new_tokens for r in requests)
                            + len(requests)) * 4 + 64
        try:
            while t < cap and (pending or len(sched.queue) or sched.busy):
                # the autotuner may have moved the lag at the last boundary
                ring_on = eng.validate_lag > 1
                while pending and pending[0].arrival <= t:
                    req = pending.pop(0)
                    req.arrival_time = time.time()     # TTFT reference
                    if not sched.queue.offer(req):
                        rep.rejected.append(req.rid)   # backpressure shed
                pairs = sched.admit(t)
                if pairs and use_packed:
                    packs, overflow = group_packs(
                        pairs, [req.prompt_len for _, req in pairs],
                        self.prefiller.usable_buckets(max_len),
                        self.prefiller.max_pack, exact=exact)
                    for _bucket, chunk in packs:
                        dual = self._admit_pack(eng, dual, params, chunk, t,
                                                ring, ring_on, max_len, rep,
                                                sched, notify_reject,
                                                prefill_events)
                    for slot, req in overflow:   # longer than the ladder
                        dual = self._admit_slot(eng, dual, params, slot, req,
                                                t, ring, ring_on, max_len)
                else:
                    for slot, req in pairs:
                        dual = self._admit_slot(eng, dual, params, slot, req,
                                                t, ring, ring_on, max_len)
                for slot, req in pairs:
                    if req.status == RUNNING and drain_on:
                        # the prefill token was delivered at admission
                        expected[slot] = 1
                    if (req.status == RUNNING
                            and len(req.tokens) >= req.max_new_tokens):
                        # budget of 1: the prefill token fills it
                        dual = self._set_active(eng, dual, slot, False)
                        sched.drain(slot, finish_step=t)
                        self._finish(sched, slot, rep)
                if not sched.running_items():
                    if sched.draining_items():
                        # nothing left to decode: the parked rows ride in
                        # the flush's read and are delivered if it is clean
                        # (the reference reads the predicate alone here and
                        # delivers the same rows at a later drain)
                        ev = eng.flush_deferred(eager=True)
                        if ev is not None:
                            dual = self._handle_event(
                                eng, recovery, sched, ring, ev, dual, rep,
                                notify_reject,
                                expected=expected if drain_on else None,
                                consumer=consumer)
                        self._release_drained(eng, sched, rep)
                        # quiescence: no runners and no parked predicates —
                        # the remaining drainers were never proven bad and
                        # nothing will re-examine them
                        if not eng.pending_validation and \
                                not sched.running_items():
                            for slot, _req in list(sched.draining_items()):
                                self._finish(sched, slot, rep)
                        continue
                    if pending or len(sched.queue):
                        # idle tick awaiting arrivals: the state's decode
                        # tick advances with the loop's, so a fault
                        # scheduled after the gap still fires
                        dual = eng.executor.map_state(
                            lambda st: {**st, "t": st["t"] + 1}, dual)
                        t += 1
                        continue
                    break
                if drain_on:
                    # owner snapshot for the rows this tick will park
                    tokring.owners = dict(sched.running_items())
                with obs.span("decode_tick", step=t):
                    outcome = eng.run_protected_step(dual, params, t)
                dual = outcome.dual
                rep.steps += 1
                if drain_on:
                    # host-side optimistic accounting, no read: every
                    # running slot's position advanced by one
                    for slot, _req in sched.running_items():
                        expected[slot] = expected.get(slot, 1) + 1
                if outcome.event is not None:
                    dual = self._handle_event(
                        eng, recovery, sched, ring, outcome.event, dual, rep,
                        notify_reject,
                        expected=expected if drain_on else None,
                        consumer=consumer)
                elif ring_on and not eng.pending_validation:
                    # clean flush boundary: cut the Tier-0 slot snapshots
                    self._snapshot_slots(eng, dual, sched, ring,
                                         version=t + 1)
                if autotune is not None and autotune.maybe_tune(eng, t + 1):
                    # a reconfig applies only at a clean boundary (the
                    # predicate ring is empty), so the state is validated
                    if eng.validate_lag == 1 and drain_on:
                        # leaving deferred mode: deliver everything parked
                        # and fall back to per-tick emission (lag 1 never
                        # parks)
                        eng.flush_deferred(final=True)
                        consumer.quiesce()
                        eng.emission_ring = None
                        drain_on = False
                    elif eng.validate_lag > 1 and not ring_on:
                        # entering deferred mode: the running slots need a
                        # Tier-0 version for a fault in the first window
                        self._snapshot_slots(eng, dual, sched, ring,
                                             version=t + 1)
                    if drain_on and not drain_cadence:
                        tokring.cadence = eng.validate_lag
                if drain_on:
                    # budget decisions ride the host count; drained slots
                    # release once a flush moved the frontier past them
                    for slot, req in sched.running_items():
                        if expected.get(slot, 1) >= req.max_new_tokens:
                            sched.drain(slot, finish_step=t + 1)
                            dual = self._set_active(eng, dual, slot, False)
                    if not eng.pending_validation:
                        self._release_drained(eng, sched, rep)
                else:
                    # per-tick emission (lag 1, or drain_cadence=1): tok and
                    # pos in one read; per-slot position deltas drive
                    # emission, so partial commits and rollbacks need no
                    # special case
                    toks, poss = hostsync.batched_get(
                        [eng.executor.peek(dual, "tok"),
                         eng.executor.peek(dual, "pos")], label="token_emit")
                    now_wall = time.time()
                    for slot, req in sched.running_items():
                        target = int(poss[slot]) - req.pos0 + 1
                        if target == len(req.tokens) + 1:
                            req.tokens.append(int(toks[slot, 0]))
                            req.token_times.append(now_wall)
                            obs.note_tokens(1)
                            if on_token is not None:
                                on_token(req, req.tokens[-1],
                                         len(req.tokens) - 1)
                        if len(req.tokens) >= req.max_new_tokens:
                            sched.drain(slot, finish_step=t + 1)
                            dual = self._set_active(eng, dual, slot, False)
                            if eng.validate_lag == 1:
                                # every emitted token passed the commit gate
                                self._finish(sched, slot, rep)
                    self._release_drained(eng, sched, rep)
                t += 1

            # final flush: validates (and in drain mode drains) the partial
            # window left when the loop exits
            ev = eng.flush_deferred(final=True)
            if ev is not None:
                dual = self._handle_event(
                    eng, recovery, sched, ring, ev, dual, rep, notify_reject,
                    expected=expected if drain_on else None,
                    consumer=consumer)
            self._release_drained(eng, sched, rep)
            if not eng.pending_validation:
                for slot, req in list(sched.draining_items()):
                    self._finish(sched, slot, rep)
        finally:
            if consumer is not None:
                consumer.quiesce()
                consumer.close()
                eng.emission_ring = None
        if consumer is not None:
            # ring retraction replaced the loop's own truncation
            rep.truncated_tokens = sum(r.truncated_tokens for r in requests)

        rep.detections = prefill_events + list(eng.detections)
        rep.retries = sum(1 for r in eng.recoveries if r["kind"] == "retry")
        rep.tokens_emitted = sum(len(r.tokens) for r in requests
                                 if r.status == "done")
        rep.wall_s = time.time() - t0
        return requests, rep
