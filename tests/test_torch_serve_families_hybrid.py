"""Continuous `serve()` of the hybrid family (reduced recurrentgemma-2b:
RG-LRU recurrent blocks and local attention over a ring of W = 8 slots) in
the port against the JAX reference's, on the same params and requests, in
f32 on the CPU.

The reference's ring is right only at prompt lengths S with S % W == 0 and
S >= W (it raises below W and is misaligned elsewhere, ROADMAP C1/C3), so
it is held against the port at S = 8 and 16, whose decode wraps the ring:
each request's tokens, the counters and each event's (step, boundary,
effect, slots, abft_corrected) under every backend and under a slot fault
(lag 1 and 8, sequential and fused), an abft slot fault corrected forward,
a hybrid retry at an entry-check tick with no false FSC (the failed
attempt writes each slot's ring slot pos % W in place), and an at-rest flip
of a live ring slot caught at the next entry check. At S = 4, 5 and 11 each
request's stream equals the port's own B=1 generate() of its prompt. K1's
ring rows: the plain leaf walk equals a masked copy, bit for bit."""
import numpy as np
import pytest
import torch

import jax

from repro.configs import RunConfig as JRunConfig
from repro.configs import SedarConfig as JSedarConfig
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.injection import InjectionSpec as JSpec
from repro.runtime.scheduler import synthetic_requests as jsynthetic
from repro.runtime.serve import SedarServer as JServer

from repro_torch import tree as tree_util
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (RunConfig, SedarConfig, get_config,
                                 reduce_for_smoke)
from repro_torch.core.injection import InjectionSpec
from repro_torch.runtime.scheduler import synthetic_requests
from repro_torch.runtime.serve import SedarServer

torch.set_num_threads(1)

ARCH = "recurrentgemma-2b"
SLOTS = 3
INTERVAL = 2
V = 257
COUNTERS = ("completed", "rejected", "retries", "rollbacks",
            "truncated_tokens", "prefill_packs", "prefill_retries", "steps")
W = 8                                       # the reduced window
RING = "['groups']['b2_attention']['k']"    # the at-rest flip's leaf


def _requests(fn, lengths=(8, 16)):
    return fn(4, arrival_rate=2.0, prompt_lengths=lengths,
              max_new_choices=(4, 8), seed=1)


@pytest.fixture(scope="module")
def shared():
    jcfg = jreduce(jget_config(ARCH))
    jsrv = JServer(JRunConfig(model=jcfg), backend="sequential")
    jparams = jsrv.model.init(jax.random.PRNGKey(0))
    jreqs, jrep = jsrv.serve(jparams, _requests(jsynthetic), slots=SLOTS,
                             validate_lag=1)
    assert not jrep.detections and len(jrep.completed) == 4
    return {"jcfg": jcfg, "tcfg": reduce_for_smoke(get_config(ARCH)),
            "jparams": jparams, "jrep": jrep,
            "tparams": params_from_numpy(jax.tree.map(np.asarray, jparams)),
            "clean": {r.rid: list(r.tokens) for r in jreqs}}


def _events(rep):
    return [(e.step, e.boundary, e.effect, e.detail.get("slots"),
             bool(e.detail.get("abft_corrected"))) for e in rep.detections]


def _jserver(shared, backend, spec=None):
    return JServer(JRunConfig(model=shared["jcfg"], sedar=JSedarConfig(
        param_validate_interval=INTERVAL)), backend=backend,
        inj_spec=JSpec(**spec) if spec else None)


def _tserver(shared, backend, spec=None):
    return SedarServer(RunConfig(model=shared["tcfg"], sedar=SedarConfig(
        param_validate_interval=INTERVAL)), backend=backend,
        inj_spec=InjectionSpec(**spec) if spec else None, device="cpu")


def _serve(srv, params, fn, lag=1):
    return srv.serve(params, _requests(fn), slots=SLOTS, validate_lag=lag)


def _assert_same(jout, tout):
    (jreqs, jrep), (treqs, trep) = jout, tout
    assert _events(trep) == _events(jrep)
    for name in COUNTERS:
        assert getattr(trep, name) == getattr(jrep, name), name
    for jr, tr in zip(jreqs, treqs):
        assert list(tr.tokens) == list(jr.tokens), tr.rid


@pytest.mark.parametrize("backend,lag", [
    ("none", 1), ("sequential", 1), ("sequential", 8), ("fused", 1),
    ("fused", 8), ("abft", 1), ("hybrid", 1)])
def test_clean_serve_matches_reference(shared, backend, lag):
    reqs, rep = _serve(_tserver(shared, backend), shared["tparams"],
                       synthetic_requests, lag)
    assert not rep.detections and not rep.stopped
    assert {r.rid: list(r.tokens) for r in reqs} == shared["clean"]
    assert sorted(rep.completed) == sorted(shared["jrep"].completed)
    assert rep.prefill_packs == 0      # every admission the exact prefill


SLOT_FAULT = dict(leaf_idx=1, flat_idx=7, bit=30, step=3, replica=1,
                  target="slot")


@pytest.mark.parametrize("backend,lag,spec", [
    ("sequential", 1, SLOT_FAULT), ("sequential", 8, SLOT_FAULT),
    ("fused", 1, SLOT_FAULT), ("fused", 8, SLOT_FAULT),
    ("abft", 1, dict(leaf_idx=0, flat_idx=1 * (V + 1) + 9, bit=30, step=2,
                     replica=0, target="kernel"))],
    ids=["slot-lag1", "slot-lag8", "fused-lag1", "fused-lag8", "abft"])
def test_slot_fault_events_and_streams_match_reference(shared, backend, lag,
                                                       spec):
    jout = _serve(_jserver(shared, backend, spec), shared["jparams"],
                  jsynthetic, lag)
    tout = _serve(_tserver(shared, backend, spec), shared["tparams"],
                  synthetic_requests, lag)
    _assert_same(jout, tout)
    assert tout[1].detections
    for r in tout[0]:
        if r.status == "done":
            assert list(r.tokens) == shared["clean"][r.rid]


def _entry_check_tick(shared):
    """A tick whose entry check runs in the clean hybrid serve."""
    srv = _tserver(shared, "hybrid")
    ticks = []
    orig = srv._batch_engine

    def spy(*a):
        eng, ring, rec = orig(*a)
        ex = eng.executor
        if not getattr(ex, "_spied", False):
            fn = ex._resident_fp_equal

            def logged(dual):
                ticks.append(ex._last_fp_step)
                return fn(dual)
            ex._resident_fp_equal, ex._spied = logged, True
        return eng, ring, rec

    srv._batch_engine = spy
    _serve(srv, shared["tparams"], synthetic_requests)
    assert ticks
    return ticks[len(ticks) // 2]


def _flip_state(srv, tick, path, index, jax_state):
    """Before the protected step at `tick`, add 1.0 to element `index` of
    slot s's rows of cache leaf `path` (s: the first running slot): in
    place in the port (leaf (n, N, ...), slot axis 1), as a new state in
    the reference (leaf (N, n, 1, ...): its B=1 slot caches stacked)."""
    orig = srv._batch_engine

    def wrapped(*a):
        eng, ring, rec = orig(*a)
        ex = eng.executor
        if getattr(ex, "_wrapped", False):
            return eng, ring, rec
        run = ex.execute

        def execute(dual, batch, step, armed, compare):
            if step == tick:
                st = dual["r0"]
                s = int(np.nonzero(np.asarray(st["active"]))[0][0])
                i = index(int(np.asarray(st["pos"])[s]))
                if jax_state:
                    flat, tdef = jax.tree_util.tree_flatten_with_path(
                        st["cache"])
                    leaves = [v.at[(s, i[0], 0) + i[1:]].add(1.0)
                              if jax.tree_util.keystr(k) == path else v
                              for k, v in flat]
                    dual = {"r0": {**st, "cache": jax.tree_util
                                   .tree_unflatten(tdef, leaves)}}
                else:
                    leaf = dict(tree_util.flatten_with_path(
                        st["cache"]))[path]
                    leaf[(i[0], s) + i[1:]] += 1.0
            return run(dual, batch, step, armed, compare)
        ex.execute, ex._wrapped = execute, True
        return eng, ring, rec

    srv._batch_engine = wrapped
    return srv


def test_hybrid_at_rest_ring_flip_caught_like_reference(shared):
    """A live ring slot, (pos - 1) % W: the one the next step attends to
    most recently."""
    tick = _entry_check_tick(shared)
    index = lambda pos: (0, (pos - 1) % W, 0, 3)    # noqa: E731
    jout = _serve(_flip_state(_jserver(shared, "hybrid"), tick, RING,
                              index, True), shared["jparams"], jsynthetic)
    tout = _serve(_flip_state(_tserver(shared, "hybrid"), tick, RING,
                              index, False), shared["tparams"],
                  synthetic_requests)
    assert [e[:3] for e in _events(tout[1])][:1] == [(tick, "validate",
                                                      "FSC")]
    _assert_same(jout, tout)


def test_hybrid_retry_at_an_entry_check_tick_gives_no_false_fsc(shared):
    tick = _entry_check_tick(shared)
    spec = dict(leaf_idx=0, flat_idx=1 * (V + 1) + 3, bit=30, step=tick,
                replica=0, target="kernel", n_elems=3)
    jout = _serve(_jserver(shared, "hybrid", spec), shared["jparams"],
                  jsynthetic)
    tout = _serve(_tserver(shared, "hybrid", spec), shared["tparams"],
                  synthetic_requests)
    assert _events(tout[1]) == [(tick, "commit", "TDC", None, False)]
    _assert_same(jout, tout)
    assert {r.rid: list(r.tokens) for r in tout[0]} == shared["clean"]


@pytest.mark.parametrize("backend", ["sequential", "fused", "hybrid"])
def test_off_window_prompts_stream_as_their_own_b1_generate(shared,
                                                            backend):
    """Prompts of 4, 5 and 11 tokens, where the reference raises (S < W)
    or misplaces its ring (S % W != 0): each served stream equals the
    port's own generate() of the prompt alone."""
    srv = _tserver(shared, backend)
    reqs, rep = srv.serve(shared["tparams"],
                          _requests(synthetic_requests, (4, 5, 11)),
                          slots=SLOTS, validate_lag=1)
    assert not rep.detections and len(rep.completed) == 4
    assert {len(r.prompt) for r in reqs} >= {5, 11}
    for r in reqs:
        toks, _ = srv.generate(shared["tparams"], {"tokens": r.prompt[None]},
                               steps=r.max_new_tokens)
        assert list(toks[0]) == list(r.tokens), r.rid


@pytest.mark.parametrize("n_slots", [1, 3])
def test_ring_rows_fingerprint_equals_masked_copy(n_slots):
    """K1's ring limit (plain leaf walk) over slots at positions below,
    at and past the window: each slot's rows but pos % W and those >= pos
    hashed as zero words, equal to the packed masked copy."""
    from repro_torch.core.fingerprint import (pack_tree_u32,
                                              slot_rows_fingerprint)
    from repro_torch.kernels import fingerprint as kfp
    g = torch.Generator().manual_seed(n_slots)
    ring = torch.randn(2, n_slots, W, 1, 16, generator=g).bfloat16()
    state = torch.randn(2, n_slots, 32, generator=g)
    pos = torch.tensor([0, 5, 8, 13][:n_slots] if n_slots > 1 else [11])
    tok = torch.arange(n_slots)[:, None]
    cache = {"a": {"k": ring}, "b": {"h": state}}
    got = slot_rows_fingerprint(cache, pos, tok,
                                roles={"a": {"k": "ring"}, "b": {"h": "whole"}},
                                axes={"a": {"k": 1}, "b": {"h": 1}}, window=W)
    masked = ring.clone()
    for i, p in enumerate(pos.tolist()):
        for r in range(W):
            if r >= p or r == p % W:
                masked[:, i, r] = 0
    words = pack_tree_u32([[masked[:, i] for i in range(n_slots)], state,
                           tok])
    assert torch.equal(got[:2], kfp.fingerprint_plain(words)[:2])
