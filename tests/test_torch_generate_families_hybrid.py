"""Hybrid protected `generate()` (the ABFT logits guard plus the resident
state baseline checked at step entry) of the moe, hybrid, vlm, ssm and
audio families against the JAX reference's, on the same seeded prompt and
params, at reduce_for_smoke size in f32 with `attention_impl="pallas"`.

The reference hashes the whole {cache, tok}; the port writes its KV caches
in place, so its baseline takes each cache leaf by its role
(`Model.cache_roles`): a dense or self-attention cache's rows [0, pos), a
ring's live slots but pos % W, recurrent states and the cross cache whole.
Held exactly against the reference: the clean tokens; the abft logits
fault corrected forward (xlstm's (1, 5) logit makes a NaN that both miss,
ROADMAP F3); an uncorrectable fault at an entry-check step retried with no
false FSC (the failed attempt's in-place row or ring slot stays out of the
baseline); an at-rest flip of a live cache row, a live ring slot, a
recurrent state or the cross cache, made between steps, caught at the
next entry check. One deliberate divergence is shown: a flip of the ring
slot the step overwrites is flagged by the reference only."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs import RunConfig as JRunConfig
from repro.configs import SedarConfig as JSedarConfig
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.injection import InjectionSpec as JSpec
from repro.runtime.serve import SedarServer as JServer

from repro_torch import tree as tree_util
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import (RunConfig, SedarConfig, get_config,
                                 reduce_for_smoke)
from repro_torch.core.injection import InjectionSpec
from repro_torch.core.policy import make_server

torch.set_num_threads(1)

STEPS = 6
B, S = 2, 16
V = 257               # reduce_for_smoke vocabulary
INTERVAL = 2          # entry checks at even positions
W = 8                 # the reduced recurrentgemma's window
FAMILIES = {"moe": "phi3.5-moe-42b-a6.6b", "hybrid": "recurrentgemma-2b",
            "vlm": "internvl2-2b", "ssm": "xlstm-125m",
            "audio": "seamless-m4t-medium"}
# the at-rest flip per family: (cache leaf path, index given the entry
# check's position p): a live dense row, a live ring slot, a recurrent
# state, the cross-attention cache
AT_REST = {"moe": ("['k']", lambda p: (0, 0, p - 1, 0, 0)),
           "vlm": ("['k']", lambda p: (1, 1, p - 1, 2, 3)),
           "hybrid": ("['groups']['b2_attention']['k']",
                      lambda p: (0, 1, (p - 1) % W, 0, 5)),
           "ssm": ("['groups']['b0_mlstm']['C']", lambda p: (1, 0, 2, 3, 4)),
           "audio": ("['xk']", lambda p: (0, 1, 2, 0, 1))}


def _events(rep):
    return [(e.step, e.boundary, e.effect,
             bool(e.detail.get("abft_corrected"))) for e in rep.detections]


def _recs(eng):
    return [(r["kind"], r["step"], r["rollbacks"], r["at"])
            for r in eng.recoveries]


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def fam(request):
    arch = FAMILIES[request.param]
    jcfg = dataclasses.replace(jreduce(jget_config(arch)),
                               attention_impl="pallas")
    tcfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                               attention_impl="pallas")
    srv = JServer(JRunConfig(model=jcfg))
    jparams = srv.model.init(jax.random.PRNGKey(0))
    prompt = {"tokens": np.random.RandomState(0).randint(
        0, 200, (B, S)).astype(np.int32)}
    if jcfg.frontend:
        prompt["frontend_embeds"] = (0.1 * np.random.RandomState(1)
                                     .standard_normal((B, jcfg.frontend_seq,
                                                       jcfg.frontend_dim))
                                     ).astype(np.float32)
    clean, _ = srv.generate(jparams, prompt, steps=STEPS)
    return {"name": request.param, "jcfg": jcfg, "tcfg": tcfg,
            "jparams": jparams, "prompt": prompt, "clean": clean,
            "P": jcfg.frontend_seq if jcfg.family == "vlm" else 0,
            "tparams": params_from_numpy(jax.tree.map(np.asarray, jparams))}


def _pair(fam, spec=None, flip=None):
    """(port tokens, report, server), (JAX tokens, report, server) of one
    hybrid generate. `flip` = (step, leaf path, index): before the step's
    execution, 1.0 is added to that element of the resident cache, in
    place in the port, as a new state in the reference."""
    jsrv = JServer(JRunConfig(model=fam["jcfg"], sedar=JSedarConfig(
        param_validate_interval=INTERVAL)), backend="hybrid",
        inj_spec=JSpec(**spec) if spec else None)
    srv = make_server(RunConfig(model=fam["tcfg"], sedar=SedarConfig(
        param_validate_interval=INTERVAL)), backend="hybrid",
        inj_spec=InjectionSpec(**spec) if spec else None, device="cpu")
    if flip is not None:
        _flip_before(jsrv, flip, jax_state=True)
        _flip_before(srv, flip, jax_state=False)
    jtoks, jrep = jsrv.generate(fam["jparams"], fam["prompt"], steps=STEPS)
    toks, rep = srv.generate(fam["tparams"], fam["prompt"], steps=STEPS)
    return (toks, rep, srv), (jtoks, jrep, jsrv)


def _flip_before(srv, flip, jax_state: bool):
    tick, path, idx = flip
    ex = srv.engine.executor
    run = ex.execute

    def execute(dual, batch, step, armed, compare):
        if step == tick and not getattr(ex, "_flipped", False):
            ex._flipped = True
            st = dual["r0"]
            if jax_state:
                flat, tdef = jax.tree_util.tree_flatten_with_path(st["cache"])
                leaves = [v.at[idx].add(1.0) if jax.tree_util.keystr(k) == path
                          else v for k, v in flat]
                dual = {"r0": {**st, "cache": jax.tree_util.tree_unflatten(
                    tdef, leaves)}}
            else:
                leaf = dict(tree_util.flatten_with_path(st["cache"]))[path]
                leaf[idx] += 1.0
        return run(dual, batch, step, armed, compare)

    ex.execute = execute


def test_clean_hybrid_generate_matches_reference(fam):
    (toks, rep, srv), (jtoks, jrep, _) = _pair(fam)
    assert srv.engine.executor.name == "hybrid"
    assert not rep.detections and not jrep.detections and not rep.stopped
    np.testing.assert_array_equal(toks, fam["clean"])
    np.testing.assert_array_equal(jtoks, fam["clean"])


def test_hybrid_logits_fault_corrected_forward_like_reference(fam):
    step = S + fam["P"] + 2
    spec = dict(leaf_idx=0, flat_idx=1 * (V + 1) + 5, bit=30, step=step,
                replica=0, target="kernel")
    (toks, rep, srv), (jtoks, jrep, jsrv) = _pair(fam, spec)
    if fam["name"] == "ssm":
        # logit (1, 5) lies in [1, 2): bit 30 makes a NaN that the
        # reference's guard misses (ROADMAP F3, a reference caveat): row 1
        # emits token 5. The port flags it uncorrectable and retries the
        # step: the clean tokens
        assert _events(jrep) == [] and jrep.retries == 0
        assert jtoks[1, 3] == 5
        assert _events(rep) == [(step, "commit", "TDC", False)]
        assert _recs(srv.engine) == [("retry", None, 1, step)]
        assert rep.retries == 1 and not rep.stopped
        np.testing.assert_array_equal(toks, fam["clean"])
        return
    assert _events(rep) == _events(jrep)
    assert _recs(srv.engine) == _recs(jsrv.engine)
    assert rep.retries == jrep.retries == 0
    np.testing.assert_array_equal(toks, jtoks)
    assert _events(rep) == [(step, "commit", "TDC", True)]
    np.testing.assert_array_equal(toks, fam["clean"])


def test_hybrid_retry_at_an_entry_check_step_gives_no_false_fsc(fam):
    """An uncorrectable fault at an entry-check position: the failed
    attempt writes its cache row (or ring slot) in place before the guard
    fails it, and the retry's entry check still passes, as the reference's
    (whose cache is functional) does."""
    step = S + fam["P"] + 2
    spec = dict(leaf_idx=0, flat_idx=3, bit=30, step=step, replica=0,
                target="kernel", n_elems=3)
    (toks, rep, srv), (jtoks, jrep, jsrv) = _pair(fam, spec)
    assert _events(rep) == _events(jrep) == [(step, "commit", "TDC", False)]
    assert _recs(srv.engine) == _recs(jsrv.engine) == [("retry", None, 1,
                                                         step)]
    np.testing.assert_array_equal(toks, fam["clean"])
    np.testing.assert_array_equal(jtoks, fam["clean"])


def test_hybrid_at_rest_flip_caught_at_the_next_entry_check(fam):
    step = S + fam["P"] + 2
    path, idx = AT_REST[fam["name"]]
    (toks, rep, srv), (jtoks, jrep, jsrv) = _pair(
        fam, flip=(step, path, idx(step)))
    assert _events(rep)[:1] == [(step, "validate", "FSC", False)]
    assert _events(rep) == _events(jrep)
    assert _recs(srv.engine) == _recs(jsrv.engine)
    assert rep.stopped == jrep.stopped


def test_ring_slot_the_step_overwrites_is_outside_the_baseline():
    """The divergence of the in-place ring: a flip of ring slot p % W just
    before the step at p, which writes that slot before it reads it, is
    flagged by the reference's whole-cache hash and not by the port's."""
    arch = FAMILIES["hybrid"]
    jcfg = dataclasses.replace(jreduce(jget_config(arch)),
                               attention_impl="pallas")
    srv = JServer(JRunConfig(model=jcfg))
    jparams = srv.model.init(jax.random.PRNGKey(0))
    fam = {"jcfg": jcfg, "jparams": jparams,
           "tcfg": dataclasses.replace(reduce_for_smoke(get_config(arch)),
                                       attention_impl="pallas"),
           "tparams": params_from_numpy(jax.tree.map(np.asarray, jparams)),
           "prompt": {"tokens": np.random.RandomState(0).randint(
               0, 200, (B, S)).astype(np.int32)}}
    step = S + 2
    flip = (step, "['groups']['b2_attention']['k']", (0, 0, step % W, 0, 0))
    (toks, rep, _), (_, jrep, _) = _pair(fam, flip=flip)
    assert _events(jrep)[:1] == [(step, "validate", "FSC", False)]
    assert _events(rep) == [] and not rep.stopped
    clean, _ = make_server(RunConfig(model=fam["tcfg"]), backend="none",
                           device="cpu").generate(fam["tparams"],
                                                  fam["prompt"], steps=STEPS)
    np.testing.assert_array_equal(toks, clean)
