"""Continuous `serve()` of the moe family (reduced phi3.5-moe, 4 experts,
top-2) in the port against the JAX reference's, on the same params
(`bridge.params_from_numpy`) and the same requests, in f32 on the CPU.

Every prompt is at a ladder length (8 or 16) and every admission pack
holds 1, 2 or 4 of them, so the reference's padded pack holds no pad and
routes exactly the tokens the port's exact-length pack routes. Decode
routes each slot as its own dispatch group (one token, capacity 4), as
the reference's vmap of B=1 decodes does.

Held exactly: each request's tokens, the counters and each event's (step,
boundary, effect, slots, abft_corrected) under every backend, a slot
fault (lag 1, lag 8, fused), an admission fault caught in the pack
(`prefill` under sequential: the row retried alone; `prefill_kernel`
under abft: corrected). Also: the grouped routing against the JAX vmap of
per-slot layers at a batch where one N-token group would drop a pair."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import RunConfig as JRunConfig
from repro.configs import SedarConfig as JSedarConfig
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.injection import InjectionSpec as JSpec
from repro.models import moe as jmoe
from repro.runtime.scheduler import Request as JRequest
from repro.runtime.serve import SedarServer as JServer

from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (RunConfig, SedarConfig, get_config,
                                 reduce_for_smoke)
from repro_torch.core.injection import InjectionSpec
from repro_torch.models import moe
from repro_torch.runtime.scheduler import Request
from repro_torch.runtime.serve import SedarServer

torch.set_num_threads(1)

ARCH = "phi3.5-moe-42b-a6.6b"
SLOTS = 4
INTERVAL = 2
V = 257
COUNTERS = ("completed", "rejected", "retries", "rollbacks",
            "truncated_tokens", "prefill_packs", "prefill_retries", "steps")
# (prompt length, arrival tick, budget): four at t=0 make two packs of 2
TRAFFIC = ((8, 0, 4), (16, 0, 6), (8, 0, 5), (16, 0, 8), (8, 2, 4),
           (16, 3, 6), (8, 5, 5), (16, 6, 4))


def _requests(cls):
    rng = np.random.RandomState(3)
    return [cls(rid=i, prompt=rng.randint(1, 200, ln).astype(np.int32),
                max_new_tokens=n, arrival=a)
            for i, (ln, a, n) in enumerate(TRAFFIC)]


def _cfgs():
    return (jreduce(jget_config(ARCH)), reduce_for_smoke(get_config(ARCH)))


@pytest.fixture(scope="module")
def shared():
    jcfg, tcfg = _cfgs()
    jsrv = JServer(JRunConfig(model=jcfg), backend="sequential")
    jparams = jsrv.model.init(jax.random.PRNGKey(0))
    clean, reps = {}, {}
    for lag in (1, 8):
        # the lag moves the ticks slots free at, so which prompts share an
        # admission pack, and a MoE pack routes its prompts together
        jreqs, reps[lag] = jsrv.serve(jparams, _requests(JRequest),
                                      slots=SLOTS, validate_lag=lag)
        assert not reps[lag].detections
        clean[lag] = {r.rid: list(r.tokens) for r in jreqs}
    return {"jcfg": jcfg, "tcfg": tcfg, "jparams": jparams,
            "tparams": params_from_numpy(jax.tree.map(np.asarray, jparams)),
            "clean": clean, "jrep": reps}


def _events(rep):
    return [(e.step, e.boundary, e.effect, e.detail.get("slots"),
             bool(e.detail.get("abft_corrected"))) for e in rep.detections]


def _port(shared, backend, spec=None, packs=None):
    srv = SedarServer(RunConfig(model=shared["tcfg"], sedar=SedarConfig(
        param_validate_interval=INTERVAL)), backend=backend,
        inj_spec=InjectionSpec(**spec) if spec else None, device="cpu")
    if packs is not None:
        pack = srv.prefiller.protected_pack

        def spy(params, prompts, max_len, tick):
            packs.append([len(p) for p in prompts])
            return pack(params, prompts, max_len, tick)
        srv.prefiller.protected_pack = spy
    return srv


def _both(shared, backend, spec=None, lag=1):
    jsrv = JServer(JRunConfig(model=shared["jcfg"], sedar=JSedarConfig(
        param_validate_interval=INTERVAL)), backend=backend,
        inj_spec=JSpec(**spec) if spec else None)
    jreqs, jrep = jsrv.serve(shared["jparams"], _requests(JRequest),
                             slots=SLOTS, validate_lag=lag)
    treqs, trep = _port(shared, backend, spec).serve(
        shared["tparams"], _requests(Request), slots=SLOTS, validate_lag=lag)
    return (jreqs, jrep), (treqs, trep)


@pytest.mark.parametrize("backend,lag", [
    ("none", 1), ("sequential", 1), ("sequential", 8), ("fused", 1),
    ("fused", 8), ("abft", 1), ("hybrid", 1)])
def test_clean_serve_matches_reference_through_unpadded_packs(shared,
                                                              backend, lag):
    packs = []
    srv = _port(shared, backend, packs=packs)
    reqs, rep = srv.serve(shared["tparams"], _requests(Request), slots=SLOTS,
                          validate_lag=lag)
    assert not rep.detections and not rep.stopped
    assert {r.rid: list(r.tokens) for r in reqs} == shared["clean"][lag]
    for name in COUNTERS:
        assert getattr(rep, name) == getattr(shared["jrep"][lag], name), name
    # every pack one length, 1, 2 or 4 prompts: nothing to pad anywhere
    assert packs and all(len(set(p)) == 1 and len(p) in (1, 2, 4)
                         for p in packs)
    assert [2, 2] == [len(p) for p in packs[:2]]


SLOT_FAULT = dict(leaf_idx=1, flat_idx=7, bit=30, step=4, replica=1,
                  target="slot")


@pytest.mark.parametrize("backend,lag,spec", [
    ("sequential", 1, SLOT_FAULT),
    ("sequential", 8, SLOT_FAULT),
    ("fused", 1, SLOT_FAULT),
    ("sequential", 1, dict(leaf_idx=1, flat_idx=7, bit=30, step=0,
                           replica=1, target="prefill")),
    ("abft", 1, dict(leaf_idx=0, flat_idx=1 * (V + 1) + 9, bit=30, step=0,
                     replica=0, target="prefill_kernel")),
    ("abft", 1, dict(leaf_idx=0, flat_idx=1 * (V + 1) + 9, bit=30, step=4,
                     replica=0, target="kernel"))],
    ids=["slot-lag1", "slot-lag8", "slot-fused", "pack-sequential",
         "pack-abft", "kernel-abft"])
def test_fault_events_and_streams_match_reference(shared, backend, lag,
                                                  spec):
    (jreqs, jrep), (treqs, trep) = _both(shared, backend, spec, lag)
    assert _events(trep) == _events(jrep) and trep.detections
    for name in COUNTERS:
        assert getattr(trep, name) == getattr(jrep, name), name
    for jr, tr in zip(jreqs, treqs):
        assert list(tr.tokens) == list(jr.tokens), tr.rid
        if tr.status == "done" and lag == 1:
            assert list(tr.tokens) == shared["clean"][1][tr.rid]


def test_moe_packs_but_never_pads():
    """May pack, may not pad: the gate admits moe prompts through the
    protected pack, grouped by exact length, while generate() keeps its
    exact prefill (`supported`, the padding gate, stays False)."""
    _, tcfg = _cfgs()
    srv = SedarServer(RunConfig(model=tcfg), backend="sequential",
                      device="cpu")
    pf = srv.prefiller
    assert pf.may_pack and not pf.supported
    with pytest.raises(ValueError, match="one length"):
        pf.protected_pack(None, [np.arange(5), np.arange(6)], 32, 0)


def test_grouped_routing_equals_the_jax_vmap_of_slots():
    """N one-token slots whose tokens all pick the same two experts: one
    N-token group (capacity max(ceil(2 N / 4 * 1.25), 4) = 5 at N = 8)
    drops six of its 16 pairs (three per expert), the reference's vmap
    over slots (capacity 4 each) drops none, and `moe_mlp(groups=N)`
    equals that vmap."""
    jcfg, tcfg = _cfgs()
    N, D = 8, tcfg.d_model
    jp, _ = jmoe.init_moe(jax.random.PRNGKey(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    base = np.random.RandomState(2).standard_normal(D).astype(np.float32)
    x = (base[None, None, :] + 1e-3 * np.random.RandomState(4)
         .standard_normal((N, 1, D))).astype(np.float32)

    want, jaux = jax.vmap(lambda r: jmoe.moe_mlp(jcfg, jp, r[None]))(
        jnp.asarray(x))
    got, aux = moe.moe_mlp(tcfg, tp, torch.from_numpy(x), groups=N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0],
                               rtol=1e-5, atol=1e-5)
    assert float(aux["moe_drop_frac"]) == 0.0
    assert float(np.mean(jaux["moe_drop_frac"])) == 0.0
    one, one_aux = moe.moe_mlp(tcfg, tp, torch.from_numpy(x))
    assert float(one_aux["moe_drop_frac"]) == pytest.approx(6 / 16)
    assert not np.allclose(one.numpy(), got.numpy(), atol=1e-3)


def test_dispatch_groups_must_split_the_rows():
    _, tcfg = _cfgs()
    p = moe.init_moe(torch.Generator().manual_seed(0), tcfg, None, "cpu")
    with pytest.raises(ValueError, match="dispatch groups"):
        moe.moe_mlp(tcfg, p, torch.zeros(3, 1, tcfg.d_model), groups=2)
