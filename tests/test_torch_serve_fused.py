"""The port's single-launch `fused` backend against the JAX reference's, at
reduce_for_smoke(qwen2-0.5b) in f32 on the CPU, the same params carried
across by `bridge.params_from_numpy` and the same `synthetic_requests`.

Two oracles, as the port's rules set them:
  * the EVENT and RECOVERY streams come from JAX fused `serve()` /
    `generate()`: each detection's (step, boundary, effect, slots,
    partial, slot_first_bad, detected_at) and the counters;
  * the BITS come from the port's own sequential lag-1 run (the
    reference's fused replay is not bitwise equal to its lag-1 runs in
    every case): fused tokens equal sequential's, bit for bit.

Plus the fused layout itself: both replicas stacked as 2N rows, the
parameter fault applied to one half only."""
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
from repro_torch.configs import RunConfig, TrainConfig, get_config, \
    reduce_for_smoke
from repro_torch.core import hostsync
from repro_torch.core.engine import (SlottedFusedExecutor, replica_rows,
                                     stack_replicas)
from repro_torch.core.injection import InjectionSpec, inject_tree
from repro_torch.core.policy import make_engine
from repro_torch.core.recovery import RetryRecovery
from repro_torch.configs import SedarConfig
from repro_torch.runtime.scheduler import Request, synthetic_requests
from repro_torch.runtime.serve import SedarServer

torch.set_num_threads(1)

SLOTS = 3
FAULT_SLOT = 1
FAULT_STEP = 3
SLOT_FAULT = dict(leaf_idx=FAULT_SLOT, flat_idx=7, bit=30, step=FAULT_STEP,
                  replica=1, target="slot")
COUNTERS = ("completed", "rejected", "retries", "rollbacks",
            "truncated_tokens", "prefill_packs", "prefill_retries", "steps")


def _rc():
    return RunConfig(model=reduce_for_smoke(get_config("qwen2-0.5b")),
                     train=TrainConfig(global_batch=2, seq_len=8))


def _jrc():
    return JRunConfig(model=jreduce(jget_config("qwen2-0.5b")),
                      train=JTrainConfig(global_batch=2, seq_len=8))


def _requests(mod):
    return mod(5, arrival_rate=2.0, prompt_lengths=(4, 8),
               max_new_choices=(4, 8), seed=1)


def _pack_requests(cls):
    """tests/test_prefill.py's traffic: lens 4, 6 -> one bucket-8 pack of
    2, len 9 -> a bucket-16 pack of 1, all at t=0."""
    return [cls(rid=i, prompt=np.arange(1, ln + 1, dtype=np.int32),
                max_new_tokens=4, arrival=0)
            for i, ln in enumerate((4, 6, 9))]


def _idle_gap_requests(cls):
    """Request 0 finishes around tick 2; ticks ~3-7 are idle; request 1
    arrives at tick 8."""
    return [cls(rid=0, prompt=np.arange(4, dtype=np.int32),
                max_new_tokens=3, arrival=0),
            cls(rid=1, prompt=np.arange(4, dtype=np.int32),
                max_new_tokens=4, arrival=8)]


WORKLOADS = {
    "default": (lambda: _requests(jsynthetic),
                lambda: _requests(synthetic_requests)),
    "packs": (lambda: _pack_requests(JRequest),
              lambda: _pack_requests(Request)),
    "idle_gap": (lambda: _idle_gap_requests(JRequest),
                 lambda: _idle_gap_requests(Request)),
}


@pytest.fixture(scope="module")
def shared():
    jsrv = JServer(_jrc(), dual=True)
    jparams = jsrv.model.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    srv = SedarServer(_rc(), backend="sequential", device="cpu")
    clean = {}
    for wl, (_, treqs) in WORKLOADS.items():
        reqs, rep = srv.serve(tparams, treqs(), slots=SLOTS, validate_lag=1)
        assert not rep.detections
        clean[wl] = {r.rid: list(r.tokens) for r in reqs}
    return {"jparams": jparams, "tparams": tparams, "clean": clean}


def _events(rep):
    return [(e.step, e.boundary, e.effect, e.detail.get("slots"),
             e.detail.get("partial"), e.detail.get("slot_first_bad"),
             e.detail.get("detected_at")) for e in rep.detections]


def _both(shared, spec=None, workload="default", server_kw=None, **kw):
    server_kw = server_kw or {}
    jreqs_fn, treqs_fn = WORKLOADS[workload]
    jsrv = JServer(_jrc(), backend="fused",
                   inj_spec=JSpec(**spec) if spec else None, **server_kw)
    jreqs, jrep = jsrv.serve(shared["jparams"], jreqs_fn(), slots=SLOTS,
                             **kw)
    srv = SedarServer(_rc(), backend="fused",
                      inj_spec=InjectionSpec(**spec) if spec else None,
                      device="cpu", **server_kw)
    treqs, trep = srv.serve(shared["tparams"], treqs_fn(), slots=SLOTS, **kw)
    return jreqs, jrep, treqs, trep


# (spec, workload, serve kwargs, server kwargs): the reference's fused
# cases (tests/test_serve_batched.py, test_prefill.py, test_emission.py)
CASES = {
    "clean_lag1": (None, "default", dict(validate_lag=1), {}),
    "clean_lag4": (None, "default", dict(validate_lag=4), {}),
    "slot_fault_lag1": (SLOT_FAULT, "default", dict(validate_lag=1), {}),
    "slot_fault_deferred_lag4": (SLOT_FAULT, "default",
                                 dict(validate_lag=4), {}),
    "persistent_deferred_lag4": (dict(SLOT_FAULT, persistent=True),
                                 "default", dict(validate_lag=4),
                                 dict(max_retries=3)),
    "persistent_lag1": (dict(SLOT_FAULT, persistent=True), "default",
                        dict(validate_lag=1), dict(max_retries=3)),
    "pack_row_fault": (dict(leaf_idx=1, flat_idx=7, bit=30, step=0,
                            replica=1, target="prefill"), "packs",
                       dict(validate_lag=1), {}),
    "params_fault_all_slots": (dict(leaf_idx=2, flat_idx=3, bit=30,
                                    step=FAULT_STEP, replica=1,
                                    target="params"), "default",
                               dict(validate_lag=1), {}),
    "unpacked_prefill_lag4": (SLOT_FAULT, "default",
                              dict(validate_lag=4, packed_prefill=False),
                              {}),
    "idle_gap_fault": (dict(leaf_idx=0, flat_idx=7, bit=30, step=9,
                            replica=1, target="slot"), "idle_gap",
                       dict(validate_lag=1), {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_serve_events_match_reference_and_bits_match_sequential(
        shared, case):
    spec, workload, kw, server_kw = CASES[case]
    jreqs, jrep, treqs, trep = _both(shared, spec, workload, server_kw, **kw)
    assert _events(trep) == _events(jrep)
    for name in COUNTERS:
        assert getattr(trep, name) == getattr(jrep, name), name
    assert [r.status for r in treqs] == [r.status for r in jreqs]
    assert not trep.stopped
    clean = shared["clean"][workload]
    for r in treqs:
        if r.status == "done":
            assert list(r.tokens) == clean[r.rid], r.rid
    if not (spec or {}).get("persistent"):
        assert all(r.status == "done" for r in treqs)


def test_fused_slot_fault_lag1_and_deferred_localize_slot(shared):
    """The reference's fused equality cases: one partial-commit event on
    the faulty slot at lag 1; one deferred event, one rollback at lag 4."""
    *_, trep = _both(shared, SLOT_FAULT, validate_lag=1)
    ev = trep.detections[0]
    assert len(trep.detections) == 1
    assert (ev.step, ev.boundary, ev.detail["slots"], ev.detail["fused"]) \
        == (FAULT_STEP, "commit", [FAULT_SLOT], True)
    *_, trep = _both(shared, SLOT_FAULT, validate_lag=4)
    assert trep.detections[0].boundary == "deferred"
    assert trep.detections[0].detail["slots"] == [FAULT_SLOT]
    assert trep.rollbacks == 1


def test_fused_pack_fault_retries_only_that_row(shared):
    *_, treqs, trep = _both(shared, dict(leaf_idx=1, flat_idx=7, bit=30,
                                         step=0, replica=1,
                                         target="prefill"), "packs")
    assert trep.prefill_retries == 1
    tdc = [e for e in trep.detections if e.boundary == "prefill"]
    assert len(tdc) == 1 and tdc[0].detail["rids"] == [1]


def test_fused_host_reads_and_kernel_path_on_the_cpu(shared):
    """Lag 1: one `commit_compare` and one `token_emit` batch per tick,
    one `prefill_emit` batch per pack (one prefill for both replicas)."""
    srv = SedarServer(_rc(), backend="fused", device="cpu")
    with hostsync.count_transfers() as st:
        _, rep = srv.serve(shared["tparams"], _requests(synthetic_requests),
                           slots=SLOTS, validate_lag=1)
    assert st.by_label == {"prefill_emit": 2 * rep.prefill_packs,
                           "commit_compare": rep.steps,
                           "token_emit": 2 * rep.steps}


def _jgenerate(shared, spec=None):
    jsrv = JServer(_jrc(), backend="fused",
                   inj_spec=JSpec(**spec) if spec else None)
    toks, rep = jsrv.generate(shared["jparams"], {"tokens": shared_prompt()},
                              steps=6)
    return toks, rep, jsrv


def shared_prompt():
    return np.random.RandomState(0).randint(0, 200, (2, 8)).astype(np.int32)


GEN_FAULTS = {
    "clean": None,
    # final_ln[3] bit 30 on replica 1 (the card smoke's fault), and a
    # layer leaf
    "final_ln": dict(leaf_idx=1, flat_idx=3, bit=30, step=10, replica=1,
                     target="params"),
    "layer_leaf_replica0": dict(leaf_idx=5, flat_idx=11, bit=30, step=9,
                                replica=0, target="params"),
}


@pytest.mark.parametrize("fault", list(GEN_FAULTS))
def test_fused_generate_matches_reference_events_and_sequential_bits(
        shared, fault):
    spec = GEN_FAULTS[fault]
    _, jrep, jsrv = _jgenerate(shared, spec)
    seq = SedarServer(_rc(), backend="sequential", device="cpu")
    want, _ = seq.generate(shared["tparams"], {"tokens": shared_prompt()},
                           steps=6)
    srv = SedarServer(_rc(), backend="fused", device="cpu",
                      inj_spec=InjectionSpec(**spec) if spec else None)
    toks, rep = srv.generate(shared["tparams"], {"tokens": shared_prompt()},
                             steps=6)
    assert [(e.step, e.boundary, e.effect) for e in rep.detections] == \
        [(e.step, e.boundary, e.effect) for e in jrep.detections]
    assert [(r["kind"], r["rollbacks"], r["at"])
            for r in srv.engine.recoveries] == \
        [(r["kind"], r["rollbacks"], r["at"]) for r in jsrv.engine.recoveries]
    assert rep.retries == jrep.retries and not rep.stopped
    np.testing.assert_array_equal(toks, want)
    if spec is not None:
        assert rep.detections and rep.detections[0].detail["fused"]


def test_param_fault_hits_one_half_and_the_clean_half_keeps_shared_bits(
        shared):
    """On the firing step the clean replica's rows are the shared-weight
    launch's bits; the corrupted replica's logits and cache rows are those
    of a launch with the corrupted weights."""
    spec = InjectionSpec(leaf_idx=1, flat_idx=3, bit=30, step=10,
                         replica=1, target="params")
    srv = SedarServer(_rc(), backend="fused", device="cpu", inj_spec=spec)
    params = shared["tparams"]
    logits, cache = srv.model.prefill(params, {"tokens": torch.as_tensor(
        shared_prompt(), dtype=torch.int64)}, 24)
    tok = torch.argmax(logits, dim=-1)
    stacked = stack_replicas({"cache": cache, "tok": tok, "pos": 8})
    clones = [{k: c.clone() for k, c in stacked["cache"].items()}
              for _ in range(2)]
    bad = inject_tree(params, spec, step=10, replica_id=1, armed=True)
    clean_l, clean_c = srv.model.decode_step(params, clones[0],
                                             stacked["tok"], 10, row_blocks=2)
    bad_l, bad_c = srv.model.decode_step(bad, clones[1], stacked["tok"], 10,
                                         row_blocks=2)
    got, got_c = srv._fused_forward(params, stacked["cache"], stacked["tok"],
                                    10, step=10, armed=True, skip=())
    assert torch.equal(got[:2], clean_l[:2])
    assert torch.equal(got[2:], bad_l[2:])
    assert not torch.equal(got[2:], clean_l[2:])
    for name in got_c:
        assert torch.equal(got_c[name][:, :2], clean_c[name][:, :2])
        assert torch.equal(got_c[name][:, 2:], bad_c[name][:, 2:])
    # not firing (another step): one shared launch, every row clean, each
    # half the bits of a replica decoded alone
    again, _ = srv._fused_forward(params, stacked["cache"], stacked["tok"],
                                  10, step=11, armed=True, skip=())
    assert torch.equal(again, clean_l)
    alone, _ = srv.model.decode_step(
        params, {k: c.clone() for k, c in cache.items()}, tok, 10)
    assert torch.equal(again[:2], alone) and torch.equal(again[2:], alone)


def test_stacked_state_map_state_writes_both_halves_in_place():
    """map_state hands each replica its rows as views: a cache row written
    through a view lands in the stacked cache (no copy of it), tok/pos/
    active are restacked, host ints come from replica 0."""
    n = 3
    state = {"cache": {"k": torch.zeros(2, n, 4, 1, 2)},
             "tok": torch.zeros(n, 1, dtype=torch.int64),
             "pos": torch.zeros(n, dtype=torch.int64),
             "active": torch.zeros(n, dtype=torch.bool), "t": 0}
    ex = SlottedFusedExecutor(lambda *a: None, lambda s: None, n_slots=n)
    dual = ex.init_dual(state)
    cache = dual["s"]["cache"]["k"]
    assert cache.shape == (2, 2 * n, 4, 1, 2)

    def write(st):
        st["cache"]["k"][:, 1:2].fill_(7.0)
        tok = st["tok"].clone()
        tok[1].fill_(5)
        return {**st, "tok": tok, "t": st["t"] + 1}

    dual = ex.map_state(write, dual)
    assert dual["s"]["cache"]["k"] is cache
    assert torch.equal(cache[:, 1], torch.full_like(cache[:, 1], 7.0))
    assert torch.equal(cache[:, n + 1], cache[:, 1])
    assert cache[:, 0].abs().sum() == 0
    assert dual["s"]["tok"][:, 0].tolist() == [0, 5, 0] * 2
    assert dual["s"]["t"] == 1
    assert torch.equal(ex.peek(dual, "tok"),
                       replica_rows(dual["s"], 1)["tok"])


def test_make_engine_builds_the_fused_executors():
    kw = dict(step_fn=lambda *a: None, state_fp_fn=lambda s: None,
              recovery=RetryRecovery())
    eng = make_engine(SedarConfig(), backend="fused", slots=4, **kw)
    assert isinstance(eng.executor, SlottedFusedExecutor)
    assert eng.executor.n_slots == 4
    eng = make_engine(SedarConfig(), backend="fused", **kw)
    assert eng.executor.name == "fused" and eng.validate_lag == 1
