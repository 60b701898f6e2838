"""Lag-aligned token emission in the port: `TokenRing` cadence, retraction
and exactly-once delivery, the detokenize consumer (threaded delivery,
quiesce, backpressure, error surfacing), and the serving-level oracle —
drained streams equal to the JAX reference's under the same faults and,
fault-free or repaired, to the port's own lag-1 run."""
import threading
import time

import numpy as np
import pytest
import torch

import jax

from repro.configs import RunConfig as JRunConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.injection import InjectionSpec as JSpec
from repro.runtime.scheduler import synthetic_requests as jsynthetic
from repro.runtime.serve import SedarServer as JServer

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import RunConfig, TrainConfig, get_config, \
    reduce_for_smoke
from repro_torch.core import hostsync
from repro_torch.core.injection import InjectionSpec
from repro_torch.runtime.emission import DetokenizeConsumer, DrainBatch, \
    TokenRing, deliver_batch
from repro_torch.runtime.scheduler import Request, synthetic_requests
from repro_torch.runtime.serve import SedarServer

torch.set_num_threads(1)

SLOTS = 3
FAULT_SLOT = 1


def _req(rid=0, pos0=4, prefill_tok=11):
    r = Request(rid=rid, prompt=np.arange(4, dtype=np.int32),
                max_new_tokens=8)
    r.pos0 = pos0
    r.tokens = [prefill_tok]
    r.token_times = [0.0]
    return r


def _row(tok, pos):
    return (torch.tensor([[tok]]), torch.tensor([pos]))


def _park_window(ring, req, toks, start_pos):
    """Park len(toks) single-slot ticks with consecutive positions."""
    ring.owners = {0: req}
    for i, tk in enumerate(toks):
        ring.park(i, _row(tk, start_pos + i))


def _fetch(ring):
    return hostsync.batched_get(ring.provide(final=True), label="test")


# ---------------------------------------------------------------------------
# TokenRing
# ---------------------------------------------------------------------------

def test_ring_cadence_gates_provide():
    counts = []
    ring = TokenRing(cadence=3,
                     sink=lambda b: counts.append(deliver_batch(b)))
    req = _req()
    _park_window(ring, req, [21, 22], start_pos=5)
    assert len(ring) == 2 and ring.parked == 2
    assert ring.provide() is None            # 2 < cadence
    leaves = ring.provide(final=True)        # final forces the drain
    assert [tuple(x.shape) for x in leaves] == [(2, 1, 1), (2, 1)]
    assert ring.provide(eager=True) is not None   # nothing retracted
    ring.park(2, _row(23, 7))
    assert ring.provide() is not None        # cadence met
    batch = ring.deliver(hostsync.batched_get(ring.provide(), label="test"))
    assert len(ring) == 0 and ring.drains == 1
    assert batch.steps == [0, 1, 2]
    assert req.tokens == [11, 21, 22, 23]    # the sink delivered in order
    assert counts == [(3, 0)]                # (delivered, retracted)


def test_ring_owner_snapshot_survives_slot_reuse():
    """park() copies the owner map: re-admitting a new request into the
    slot mid-window cannot reroute already-parked rows."""
    ring = TokenRing(cadence=4)
    old, new = _req(rid=0), _req(rid=1, pos0=10, prefill_tok=50)
    _park_window(ring, old, [21, 22], start_pos=5)
    ring.owners = {0: new}
    ring.park(2, _row(61, 11))
    ring.park(3, _row(62, 12))
    ring.deliver(_fetch(ring))
    assert old.tokens == [11, 21, 22]
    assert new.tokens == [50, 61, 62]


def test_truncate_retracts_at_or_after_first_bad():
    counts = []
    ring = TokenRing(cadence=8,
                     sink=lambda b: counts.append(deliver_batch(b)))
    req = _req()
    _park_window(ring, req, [21, 22, 23, 24], start_pos=5)
    assert ring.provide(eager=True) is not None
    ring.truncate({0: 1})                    # steps 1..3 are bad for slot 0
    assert ring.provide(eager=True) is None  # below the cadence they wait
    ring.deliver(_fetch(ring))
    assert req.tokens == [11, 21]            # the step-0 row was clean
    assert req.truncated_tokens == 3
    assert counts == [(1, 3)]                # (delivered, retracted)


def test_truncate_global_bad_and_frozen_dedup():
    """Scalar-predicate fallback dead-marks whole rows; a frozen slot's
    repeated position is retracted once."""
    ring = TokenRing(cadence=4)
    req = _req()
    ring.owners = {0: req}
    for step, pos in [(0, 5), (1, 6), (2, 6), (3, 6)]:   # frozen at pos 6
        ring.park(step, _row(30 + step, pos))
    ring.truncate(None, global_bad=1)
    ring.deliver(_fetch(ring))
    assert req.tokens == [11, 30]
    assert req.truncated_tokens == 1


def test_deliver_batch_prefix_guard_is_exactly_once():
    req = _req()
    batch = DrainBatch(steps=[0, 1, 2],
                       toks=np.asarray([[[21]], [[21]], [[22]]]),
                       poss=np.asarray([[5], [5], [6]]),
                       owners=[{0: req}] * 3, dead=[set(), set(), set()],
                       dead_all=[False] * 3)
    assert deliver_batch(batch, now=1.0) == (2, 0)
    assert req.tokens == [11, 21, 22]
    assert req.token_times[1:] == [1.0, 1.0]
    assert deliver_batch(batch, now=2.0) == (0, 0)   # a replay adds nothing
    assert req.tokens == [11, 21, 22]


def test_on_token_streams_in_order():
    seen = []
    req = _req()
    ring = TokenRing(cadence=2, sink=lambda b: deliver_batch(
        b, on_token=lambda r, tok, i: seen.append((r.rid, i, tok))))
    _park_window(ring, req, [21, 22], start_pos=5)
    ring.deliver(_fetch(ring))
    assert seen == [(0, 1, 21), (0, 2, 22)]


# ---------------------------------------------------------------------------
# detokenize consumer
# ---------------------------------------------------------------------------

def _batch_for(req, toks, start_pos):
    n = len(toks)
    return DrainBatch(
        steps=list(range(n)), toks=np.asarray(toks).reshape(n, 1, 1),
        poss=np.arange(start_pos, start_pos + n).reshape(n, 1),
        owners=[{0: req}] * n, dead=[set() for _ in range(n)],
        dead_all=[False] * n)


def test_consumer_threaded_delivery_and_quiesce():
    req = _req()
    cons = DetokenizeConsumer(max_queue=4).start()
    cons.submit(_batch_for(req, [21, 22], 5))
    cons.submit(_batch_for(req, [23], 7))
    cons.quiesce()
    assert req.tokens == [11, 21, 22, 23]
    assert cons.batches == 2 and cons.delivered == 3
    cons.close()
    assert cons._thread is None


def test_consumer_inline_fallback_without_start():
    req = _req()
    cons = DetokenizeConsumer()
    cons.submit(_batch_for(req, [21], 5))
    assert req.tokens == [11, 21] and cons.batches == 1
    cons.close()


def test_consumer_close_surfaces_worker_error():
    cons = DetokenizeConsumer(max_queue=2).start()
    bad = DrainBatch(steps=[0], toks=np.zeros((1, 1, 1), np.int64),
                     poss=np.zeros((1, 1), np.int64),
                     owners=[{0: object()}],   # no .pos0 -> worker raises
                     dead=[set()], dead_all=[False])
    cons.submit(bad)
    with pytest.raises(AttributeError):
        cons.close()
    assert cons.errors


def test_consumer_backpressure_blocks_submit():
    """A full queue makes submit() wait for the worker."""
    gate = threading.Event()
    req = _req()
    cons = DetokenizeConsumer(
        on_token=lambda *a: gate.wait(timeout=5.0), max_queue=1).start()
    cons.submit(_batch_for(req, [21], 5))    # the worker blocks in on_token
    time.sleep(0.02)
    cons.submit(_batch_for(req, [22], 6))    # fills the queue
    t0 = time.monotonic()
    release = threading.Timer(0.15, gate.set)
    release.start()
    cons.submit(_batch_for(req, [23], 7))    # must wait for the worker
    assert time.monotonic() - t0 > 0.05
    cons.quiesce()
    cons.close()
    release.join(timeout=5.0)
    assert not release.is_alive()
    assert req.tokens == [11, 21, 22, 23]
    assert cons.backlog_peak >= 1


def test_cross_thread_counting_sees_other_threads():
    """A cross-thread region counts another thread's reads; a thread-local
    one does not."""
    x = torch.arange(3)
    with hostsync.count_transfers(cross_thread=True) as shared, \
            hostsync.count_transfers() as local:
        th = threading.Thread(
            target=lambda: hostsync.batched_get([x, x], label="other"))
        th.start()
        th.join(timeout=10.0)
        assert not th.is_alive()
        hostsync.read_scalar(x, label="mine")
    assert shared.by_label == {"other": 2, "mine": 1}
    assert local.by_label == {"mine": 1}


# ---------------------------------------------------------------------------
# serving-level oracle
# ---------------------------------------------------------------------------

def _rc():
    return RunConfig(model=reduce_for_smoke(get_config("qwen2-0.5b")),
                     train=TrainConfig(global_batch=2, seq_len=8))


def _requests(mod=synthetic_requests):
    return mod(5, arrival_rate=2.0, prompt_lengths=(4, 8),
               max_new_choices=(4, 8), seed=1)


def _slot_spec(cls, step, **kw):
    return cls(leaf_idx=FAULT_SLOT, flat_idx=7, bit=30, step=step,
               replica=1, target="slot", **kw)


@pytest.fixture(scope="module")
def oracle():
    """The port's fault-free lag-1 streams: the ground truth every
    drain-mode campaign must reproduce."""
    jrc = JRunConfig(model=jreduce(jget_config("qwen2-0.5b")),
                     train=JTrainConfig(global_batch=2, seq_len=8))
    jparams = JServer(jrc, dual=True).model.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    srv = SedarServer(_rc(), dual=True, device="cpu")
    reqs, rep = srv.serve(tparams, _requests(), slots=SLOTS, validate_lag=1)
    assert not rep.detections
    return {"jrc": jrc, "jparams": jparams, "tparams": tparams,
            "clean": {r.rid: list(r.tokens) for r in reqs}}


def _assert_streams_equal(out, clean):
    for r in out:
        assert list(r.tokens) == clean[r.rid], f"request {r.rid}"


@pytest.mark.parametrize("lag,fault_step", [(4, 5), (8, 3)])
def test_midwindow_fault_retracts_and_matches_reference(oracle, lag,
                                                        fault_step):
    """A slot SDC inside the deferred window: the failed flush retracts the
    slot's undrained rows, the slot rolls back and re-decodes, and every
    stream, counter and event equals the JAX reference's (and the lag-1
    streams)."""
    jsrv = JServer(oracle["jrc"], dual=True,
                   inj_spec=_slot_spec(JSpec, fault_step))
    jout, jrep = jsrv.serve(oracle["jparams"], _requests(jsynthetic),
                            slots=SLOTS, validate_lag=lag)
    srv = SedarServer(_rc(), dual=True, device="cpu",
                      inj_spec=_slot_spec(InjectionSpec, fault_step))
    out, rep = srv.serve(oracle["tparams"], _requests(), slots=SLOTS,
                         validate_lag=lag)
    assert len(rep.detections) == 1
    ev = rep.detections[0]
    assert ev.boundary == "deferred" and ev.step == fault_step
    assert ev.detail["slots"] == [FAULT_SLOT]
    assert ev.detail == jrep.detections[0].detail
    assert (rep.rollbacks, rep.truncated_tokens, rep.completed) == \
        (jrep.rollbacks, jrep.truncated_tokens, jrep.completed)
    assert rep.rollbacks == 1 and rep.truncated_tokens > 0
    assert all(r.status == "done" for r in out)
    _assert_streams_equal(out, oracle["clean"])
    for r, j in zip(out, jout):
        assert (list(r.tokens), r.truncated_tokens) == \
            (list(j.tokens), j.truncated_tokens)
    assert sum(1 for r in out if r.truncated_tokens > 0) == 1


@pytest.mark.parametrize("lag", [4, 8])
def test_persistent_stuck_bit_rejects_under_drain(oracle, lag):
    notified = []
    srv = SedarServer(_rc(), dual=True, max_retries=3, device="cpu",
                      inj_spec=_slot_spec(InjectionSpec, 3, persistent=True))
    out, rep = srv.serve(oracle["tparams"], _requests(), slots=SLOTS,
                         validate_lag=lag,
                         notify_reject=lambda r, e: notified.append(r.rid))
    rejected = [r for r in out if r.status == "rejected"]
    assert len(rejected) == 1
    assert rep.rejected == [rejected[0].rid] == notified
    assert not rep.stopped
    for r in out:
        if r.status == "done":
            assert list(r.tokens) == oracle["clean"][r.rid]


def test_delivered_prefix_property_under_fault(oracle):
    """on_token (called from the consumer thread) sees each stream as
    delivered: gapless, in order, and equal to the final stream — nothing
    was delivered and later taken back."""
    streamed, first_idx = {}, {}

    def on_token(req, tok, idx):
        seq = streamed.setdefault(req.rid, [])
        if not seq:
            first_idx[req.rid] = idx
        assert idx == first_idx[req.rid] + len(seq)
        seq.append(tok)

    srv = SedarServer(_rc(), dual=True, device="cpu",
                      inj_spec=_slot_spec(InjectionSpec, 3))
    out, rep = srv.serve(oracle["tparams"], _requests(), slots=SLOTS,
                         validate_lag=8, on_token=on_token)
    assert rep.rollbacks == 1
    _assert_streams_equal(out, oracle["clean"])
    for r in out:
        seq = streamed.get(r.rid, [])
        if seq:
            assert first_idx[r.rid] == 1   # index 0: the prefill token
        assert seq == list(r.tokens)[1:]


def test_run_ending_midwindow_releases_exactly_once(oracle):
    srv = SedarServer(_rc(), dual=True, device="cpu")
    out, rep = srv.serve(oracle["tparams"], _requests(), slots=SLOTS,
                         validate_lag=8, max_steps=6)
    assert sorted(rep.completed) == sorted(set(rep.completed))
    assert all(r.status != "draining" for r in out)
    done = [r for r in out if r.status == "done"]
    assert {r.rid for r in done} == set(rep.completed)
    for r in out:
        assert list(r.tokens) == oracle["clean"][r.rid][:len(r.tokens)]
        if r.status == "done":
            assert list(r.tokens) == oracle["clean"][r.rid]


@pytest.mark.parametrize("lag,cadence", [(8, 1), (4, 12)])
def test_drain_cadence_against_the_per_tick_baseline(oracle, lag, cadence):
    """drain_cadence=1 keeps the per-tick read; a cadence above the lag
    drains fewer, bigger batches. The streams equal the lag-1 baseline."""
    srv = SedarServer(_rc(), dual=True, device="cpu")
    with hostsync.count_transfers(cross_thread=True) as st:
        out, rep = srv.serve(oracle["tparams"], _requests(), slots=SLOTS,
                             validate_lag=lag, drain_cadence=cadence)
    _assert_streams_equal(out, oracle["clean"])
    assert rep.tokens_emitted == sum(len(r.tokens) for r in out)
    if cadence == 1:
        assert st.by_label["token_emit"] == 2 * rep.steps
    else:
        assert st.by_label.get("token_emit", 0) < 3 * (rep.steps // lag + 2)
