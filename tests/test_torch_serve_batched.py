"""The port's continuous-batching `serve()` against the JAX reference's
(`backend="sequential"`), at reduce_for_smoke(qwen2-0.5b) in f32 on the
same params (carried across by `bridge.params_from_numpy`) and the same
`synthetic_requests`.

Held exactly in every case: each request's tokens; `completed`,
`rejected`, `retries`, `rollbacks`, `truncated_tokens`, `prefill_packs`
and `prefill_retries`; each detection's (step, boundary, effect,
detail.slots, partial, slot_first_bad, detected_at). Then the port's own
properties: slot-count invariance, B=1 `generate()` as the oracle, the
host reads by label, and the entry points' device rules."""
import numpy as np
import pytest
import torch

import jax

from repro.configs import RunConfig as JRunConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.injection import InjectionSpec as JSpec
from repro.runtime.scheduler import Request as JRequest
from repro.runtime.scheduler import synthetic_requests as jsynthetic
from repro.runtime.serve import SedarServer as JServer

from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint.tiers import SlotRing
from repro_torch.configs import RunConfig, TrainConfig, get_config, \
    reduce_for_smoke
from repro_torch.core import hostsync
from repro_torch.core.detection import DetectionEvent
from repro_torch.core.injection import InjectionSpec
from repro_torch.core.recovery import SlotRecovery
from repro_torch.kernels import fingerprint as kfp
from repro_torch.kernels import flash_attention as kfa
from repro_torch.runtime.scheduler import Request, synthetic_requests
from repro_torch.runtime.serve import SedarServer

torch.set_num_threads(1)

SLOTS = 3
FAULT_SLOT = 1
FAULT_STEP = 3
SLOT_FAULT = dict(leaf_idx=FAULT_SLOT, flat_idx=7, bit=30, step=FAULT_STEP,
                  replica=1, target="slot")
COUNTERS = ("completed", "rejected", "retries", "rollbacks",
            "truncated_tokens", "prefill_packs", "prefill_retries")


def _rc():
    return RunConfig(model=reduce_for_smoke(get_config("qwen2-0.5b")),
                     train=TrainConfig(global_batch=2, seq_len=8))


def _jrc():
    return JRunConfig(model=jreduce(jget_config("qwen2-0.5b")),
                      train=JTrainConfig(global_batch=2, seq_len=8))


def _requests(mod):
    return mod(5, arrival_rate=2.0, prompt_lengths=(4, 8),
               max_new_choices=(4, 8), seed=1)


def _idle_gap_requests(cls):
    """Request 0 finishes around tick 2; ticks ~3-7 are idle; request 1
    arrives at tick 8."""
    return [cls(rid=0, prompt=np.arange(4, dtype=np.int32),
                max_new_tokens=3, arrival=0),
            cls(rid=1, prompt=np.arange(4, dtype=np.int32),
                max_new_tokens=4, arrival=8)]


def _single_token_requests(cls):
    return [cls(rid=0, prompt=np.arange(4, dtype=np.int32),
                max_new_tokens=1, arrival=0),
            cls(rid=1, prompt=np.arange(6, dtype=np.int32),
                max_new_tokens=3, arrival=0)]


def _burst_requests(mod):
    return mod(6, arrival_rate=100.0, seed=2)      # all arrive at t=0


WORKLOADS = {
    "default": (lambda: _requests(jsynthetic), lambda: _requests(
        synthetic_requests)),
    "idle_gap": (lambda: _idle_gap_requests(JRequest),
                 lambda: _idle_gap_requests(Request)),
    "single_token": (lambda: _single_token_requests(JRequest),
                     lambda: _single_token_requests(Request)),
    "burst": (lambda: _burst_requests(jsynthetic),
              lambda: _burst_requests(synthetic_requests)),
}


@pytest.fixture(scope="module")
def shared():
    jsrv = JServer(_jrc(), dual=True)
    jparams = jsrv.model.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    srv = SedarServer(_rc(), dual=True, device="cpu")
    reqs, rep = srv.serve(tparams, _requests(synthetic_requests),
                          slots=SLOTS)
    assert not rep.detections
    return {"jparams": jparams, "tparams": tparams,
            "clean": {r.rid: list(r.tokens) for r in reqs}}


def _events(rep):
    return [(e.step, e.boundary, e.effect, e.detail.get("slots"),
             e.detail.get("partial"), e.detail.get("slot_first_bad"),
             e.detail.get("detected_at")) for e in rep.detections]


def _both(shared, spec=None, workload="default", server_kw=None, **kw):
    """The same traffic through JAX serve() and the port's serve()."""
    server_kw = server_kw or {}
    jreqs_fn, treqs_fn = WORKLOADS[workload]
    jsrv = JServer(_jrc(), dual=True,
                   inj_spec=JSpec(**spec) if spec else None, **server_kw)
    jreqs, jrep = jsrv.serve(shared["jparams"], jreqs_fn(), **kw)
    srv = SedarServer(_rc(), dual=True,
                      inj_spec=InjectionSpec(**spec) if spec else None,
                      device="cpu", **server_kw)
    treqs, trep = srv.serve(shared["tparams"], treqs_fn(), **kw)
    return jreqs, jrep, treqs, trep


def _assert_parity(jreqs, jrep, treqs, trep):
    assert [r.rid for r in treqs] == [r.rid for r in jreqs]
    for j, t in zip(jreqs, treqs):
        assert list(t.tokens) == list(j.tokens), f"request {t.rid}"
        assert t.status == j.status, f"request {t.rid}"
    for name in COUNTERS:
        assert getattr(trep, name) == getattr(jrep, name), name
    assert _events(trep) == _events(jrep)
    assert trep.steps == jrep.steps


# (spec, workload, serve kwargs, server kwargs, expected detections)
CASES = {
    "clean_lag1": (None, "default", dict(validate_lag=1), {}, 0),
    "clean_lag4": (None, "default", dict(validate_lag=4), {}, 0),
    "slot_fault_lag1": (SLOT_FAULT, "default", dict(validate_lag=1), {}, 1),
    "slot_fault_lag4": (SLOT_FAULT, "default", dict(validate_lag=4), {}, 1),
    "persistent_lag1": (dict(SLOT_FAULT, persistent=True), "default",
                        dict(validate_lag=1), dict(max_retries=3), 4),
    "persistent_lag4": (dict(SLOT_FAULT, persistent=True), "default",
                        dict(validate_lag=4), dict(max_retries=3), None),
    "prefill_row_fault": (dict(leaf_idx=0, flat_idx=7, bit=30, step=0,
                               replica=1, target="prefill"), "default",
                          dict(validate_lag=1), {}, 1),
    "params_fault_all_slots": (dict(leaf_idx=2, flat_idx=3, bit=30,
                                    step=FAULT_STEP, replica=1,
                                    target="params"), "default",
                               dict(validate_lag=1), {}, None),
    "backpressure": (None, "burst", dict(slots=2, queue_depth=2), {}, 0),
    "idle_gap_fault": (dict(leaf_idx=0, flat_idx=7, bit=30, step=9,
                            replica=1, target="slot"), "idle_gap",
                       dict(slots=1), {}, 1),
    "single_token_budget": (None, "single_token", dict(slots=2), {}, 0),
    "drain_cadence_1": (SLOT_FAULT, "default",
                        dict(validate_lag=8, drain_cadence=1), {}, 1),
    "unpacked_prefill": (SLOT_FAULT, "default",
                         dict(validate_lag=4, packed_prefill=False), {}, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_serve_matches_reference(shared, case):
    spec, workload, kw, server_kw, n_events = CASES[case]
    kw = dict(kw)
    kw.setdefault("slots", SLOTS)
    jreqs, jrep, treqs, trep = _both(shared, spec, workload, server_kw, **kw)
    _assert_parity(jreqs, jrep, treqs, trep)
    if n_events is not None:
        assert len(trep.detections) == n_events
    assert not trep.stopped
    if workload == "default" and not (spec or {}).get("persistent"):
        # transient faults are repaired before the stream completes
        for r in treqs:
            assert r.status == "done"
            assert list(r.tokens) == shared["clean"][r.rid], r.rid


def test_slot_fault_partial_commit_and_deferred_rollback(shared):
    """Lag 1: the slot's mismatch is partially committed and retried; lag 4:
    the flush localizes slot and step, only that slot rolls back and
    exactly one request is truncated and re-decoded."""
    *_, treqs, trep = _both(shared, SLOT_FAULT, slots=SLOTS, validate_lag=1)
    ev = trep.detections[0]
    assert (ev.step, ev.boundary, ev.detail["slots"], ev.detail["partial"]) \
        == (FAULT_STEP, "commit", [FAULT_SLOT], True)
    assert trep.retries >= 1 and trep.rollbacks == 0
    *_, treqs, trep = _both(shared, SLOT_FAULT, slots=SLOTS, validate_lag=4)
    ev = trep.detections[0]
    assert ev.boundary == "deferred" and ev.step == FAULT_STEP
    assert ev.detail["slot_first_bad"] == {FAULT_SLOT: FAULT_STEP}
    assert ev.detail["detected_at"] <= FAULT_STEP + 4
    assert trep.rollbacks == 1 and trep.truncated_tokens > 0
    assert sum(1 for r in treqs if r.truncated_tokens > 0) == 1


def test_persistent_fault_rejects_only_that_request(shared):
    notified = []
    srv = SedarServer(_rc(), dual=True, max_retries=3, device="cpu",
                      inj_spec=InjectionSpec(**dict(SLOT_FAULT,
                                                    persistent=True)))
    out, rep = srv.serve(shared["tparams"], _requests(synthetic_requests),
                         slots=SLOTS,
                         notify_reject=lambda r, e: notified.append(r.rid))
    rejected = [r for r in out if r.status == "rejected"]
    assert len(rejected) == 1 and "safe stop" in rejected[0].reject_reason
    assert rep.rejected == [rejected[0].rid] == notified
    assert not rep.stopped
    for r in out:
        if r.status == "done":
            assert list(r.tokens) == shared["clean"][r.rid]


def test_slot_count_invariance(shared):
    """A request's stream depends on its prompt and the params only, not
    on the slot it lands in or how many slots the server packs."""
    srv = SedarServer(_rc(), dual=True, device="cpu")
    for slots in (1, 2, 4):
        reqs, _ = srv.serve(shared["tparams"], _requests(synthetic_requests),
                            slots=slots)
        for r in reqs:
            assert list(r.tokens) == shared["clean"][r.rid], (slots, r.rid)


def test_matches_generate_oracle(shared):
    """Each request's stream equals the synchronous B=1 generate() on its
    prompt (per-row positions against one host-int position)."""
    srv = SedarServer(_rc(), dual=True, device="cpu")
    reqs, _ = srv.serve(shared["tparams"], _requests(synthetic_requests),
                        slots=SLOTS)
    max_len = max(r.prompt_len for r in reqs) + max(
        r.max_new_tokens for r in reqs) + 8
    for r in reqs:
        toks, _ = srv.generate(shared["tparams"],
                               {"tokens": r.prompt[None, :]},
                               steps=r.max_new_tokens, max_len=max_len)
        assert list(r.tokens) == list(toks[0]), r.rid


def test_host_reads_by_label(shared):
    """Lag 1: one `commit_compare` and one `token_emit` batch (tok, pos)
    per tick. Lag 4, drain on, fault-free: only `prefill_emit` (tok,
    verdict: one batch per pack) and `token_emit` (predicate, toks, poss:
    one batch per flush) — no read per decode tick."""
    srv = SedarServer(_rc(), dual=True, device="cpu")
    with hostsync.count_transfers() as st:
        _, rep = srv.serve(shared["tparams"], _requests(synthetic_requests),
                           slots=SLOTS, validate_lag=1)
    assert st.by_label == {"prefill_emit": 2 * rep.prefill_packs,
                           "commit_compare": rep.steps,
                           "token_emit": 2 * rep.steps}
    with hostsync.count_transfers(cross_thread=True) as st:
        out, rep = srv.serve(shared["tparams"],
                             _requests(synthetic_requests), slots=SLOTS,
                             validate_lag=4)
    assert not rep.detections and rep.prefill_packs > 0
    assert set(st.by_label) == {"prefill_emit", "token_emit"}, st.by_label
    assert st.by_label["prefill_emit"] == 2 * rep.prefill_packs
    assert st.by_label["token_emit"] % 3 == 0
    assert st.by_label["token_emit"] <= 3 * (rep.steps // 4 + 2)
    assert st.by_label["token_emit"] < 2 * rep.steps
    assert rep.tokens_emitted == sum(len(r.tokens) for r in out)
    for r in out:
        assert list(r.tokens) == shared["clean"][r.rid]


def test_cpu_serve_launches_no_kernel(shared):
    """On the CPU the wrappers take the plain versions: no launch counted,
    K1's plain version behind every slot and lane fingerprint."""
    before = (kfp.launch_count.n, kfa.launch_count.n)
    srv = SedarServer(_rc(), dual=True, device="cpu")
    _, rep = srv.serve(shared["tparams"], _requests(synthetic_requests),
                       slots=SLOTS, validate_lag=4)
    assert rep.steps > 0
    assert (kfp.launch_count.n, kfa.launch_count.n) == before


def test_unprotected_serve_matches_dual(shared):
    srv = SedarServer(_rc(), dual=False, device="cpu")
    with hostsync.count_transfers() as st:
        reqs, rep = srv.serve(shared["tparams"],
                              _requests(synthetic_requests), slots=SLOTS,
                              validate_lag=8)
    assert srv._batch_engines[(SLOTS, 24, 8)][0].validate_lag == 1
    for r in reqs:
        assert list(r.tokens) == shared["clean"][r.rid]
    assert "commit_compare" not in st.by_label and not rep.detections


def test_rejection_resets_slot_budget_for_next_tenant():
    rec = SlotRecovery(SlotRing(), max_retries=2)

    def ev():
        return DetectionEvent(step=1, boundary="commit", effect="TDC",
                              detail={"slots": [0], "partial": True})

    for _ in range(3):
        rec.on_detection(ev())
    assert rec.take_rejections() == [0]
    action = rec.on_detection(ev())
    assert action.kind == "retry" and action.rollbacks == 1
    assert rec.take_rejections() == []


@pytest.mark.parametrize("backend", ["abft", "hybrid"])
def test_serve_backends_of_the_next_slice_raise(shared, backend):
    """abft/hybrid `serve()` are ported: they serve the clean traffic with
    the dual run's streams. Only the mesh backends stay unported."""
    srv = SedarServer(_rc(), backend=backend, device="cpu")
    reqs, rep = srv.serve(shared["tparams"], _requests(synthetic_requests),
                          slots=SLOTS)
    assert not rep.detections and not rep.stopped
    for r in reqs:
        assert list(r.tokens) == shared["clean"][r.rid], r.rid
    for unported in ("pod", "vote"):
        with pytest.raises(NotImplementedError, match="not ported"):
            SedarServer(_rc(), backend=unported, device="cpu")


def test_continuous_launcher_runs_on_the_cpu_and_needs_a_card_otherwise(
        monkeypatch, capsys):
    from repro_torch.launch import serve as launcher
    argv = ["serve", "--continuous", "--dual", "--requests", "4",
            "--validate-lag", "4", "--fault-slot", "1", "--fault-step", "3"]
    monkeypatch.setattr("sys.argv", argv + ["--device", "cpu"])
    launcher.main()
    out = capsys.readouterr().out
    assert "backend=sequential" in out and "completed=4" in out
    assert "boundary=deferred" in out
    if torch.cuda.is_available():
        return
    monkeypatch.setattr("sys.argv", argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SedarServer(_rc(), dual=True)
