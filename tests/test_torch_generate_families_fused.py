"""Fused protected `generate()` of the moe, hybrid, vlm, ssm and audio
families against the JAX reference's, on the same seeded prompt and params
(`bridge.params_from_numpy`), at reduce_for_smoke size in f32 with
`attention_impl="pallas"` (K2's plain version on the CPU).

The port stacks both replicas as the row blocks of one decode, every
family alike: the attention, the feature means and xlstm's gate products
run per replica half (`layers.row_blocks`), the rest on the stacked rows,
and a MoE layer routes each replica's rows as its own dispatch group (the
reference vmaps the replicas). The stacked decode equals a replica
decoded alone bit for bit, at the host position and, for the families
`serve()` takes (moe, hybrid, ssm), at per-row positions. Held exactly:
the clean tokens (also equal to the port's own sequential run, bit for
bit: bits come from inside the port), and under a bit-30 flip of
`final_ln` on replica 1 the (step, boundary, effect) stream, the retries
and the recovery records, with the clean tokens."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs import RunConfig as JRunConfig
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.injection import InjectionSpec as JSpec
from repro.runtime.serve import SedarServer as JServer

from repro_torch import tree as tree_util
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
from repro_torch.core.injection import InjectionSpec
from repro_torch.core.policy import make_server

torch.set_num_threads(1)

STEPS = 6
B, S = 2, 16
FAMILIES = {"moe": "phi3.5-moe-42b-a6.6b", "hybrid": "recurrentgemma-2b",
            "vlm": "internvl2-2b", "ssm": "xlstm-125m",
            "audio": "seamless-m4t-medium"}


def _events(rep):
    return [(e.step, e.boundary, e.effect) for e in rep.detections]


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
    P = jcfg.frontend_seq if jcfg.family == "vlm" else 0
    clean, _ = srv.generate(jparams, prompt, steps=STEPS)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    paths = [p for p, _ in tree_util.flatten_with_path(tparams)]
    seq, _ = make_server(RunConfig(model=tcfg), backend="sequential",
                         device="cpu").generate(tparams, prompt, steps=STEPS)
    return {"name": request.param, "jcfg": jcfg, "tcfg": tcfg,
            "jparams": jparams, "tparams": tparams, "prompt": prompt,
            "clean": clean, "seq": seq, "P": P,
            "final_ln": paths.index("['decoder']['final_ln']"
                                    if jcfg.family == "audio"
                                    else "['final_ln']")}


def test_clean_fused_generate_matches_reference_and_sequential(fam):
    srv = make_server(RunConfig(model=fam["tcfg"]), backend="fused",
                      device="cpu")
    toks, rep = srv.generate(fam["tparams"], fam["prompt"], steps=STEPS)
    assert srv.engine.executor.name == "fused"
    assert not rep.detections and not rep.stopped
    np.testing.assert_array_equal(toks, fam["clean"])
    np.testing.assert_array_equal(toks, fam["seq"])


def test_fused_final_ln_fault_retried_like_reference(fam):
    step = S + fam["P"] + 2
    spec = dict(leaf_idx=fam["final_ln"], flat_idx=3, bit=30, step=step,
                replica=1, target="params")
    jsrv = JServer(JRunConfig(model=fam["jcfg"]), backend="fused",
                   inj_spec=JSpec(**spec))
    jtoks, jrep = jsrv.generate(fam["jparams"], fam["prompt"], steps=STEPS)
    srv = make_server(RunConfig(model=fam["tcfg"]), backend="fused",
                      inj_spec=InjectionSpec(**spec), device="cpu")
    toks, rep = srv.generate(fam["tparams"], fam["prompt"], steps=STEPS)
    assert _events(rep) == _events(jrep) == [(step, "commit", "TDC")]
    assert rep.retries == jrep.retries == 1 and not rep.stopped
    assert _recs(srv.engine) == _recs(jsrv.engine)
    np.testing.assert_array_equal(toks, fam["seq"])
    np.testing.assert_array_equal(jtoks, fam["clean"])


def _stacked_decode(tcfg, params, prompt, P: int, per_row: bool):
    """Three greedy decode steps of the B prompt rows alone against the 2B
    stacked rows through `Model.decode_step(row_blocks=2)`, at the host
    position or at per-row positions. Returns (the row counts each
    `lm_decode_step`/`encdec_decode_step` call saw, the MoE dispatch
    groups, the row blocks `layers.blockwise` ran under), after asserting
    each step's stacked logits equal the replica's bit for bit."""
    from repro_torch.models import encdec, layers, moe, transformer
    srv = make_server(RunConfig(model=tcfg), backend="none", device="cpu")
    m, p = srv.model, params
    batch = {k: torch.from_numpy(v) for k, v in prompt.items()}
    pos = S + P
    _, cache = m.prefill(p, batch, pos + 8)
    axes = m.slot_axes()
    one = tree_util.tree_map(lambda c: c.clone(), cache)
    two = tree_util.tree_map(lambda c, ax: torch.cat([c, c], dim=ax),
                             cache, axes)
    rows, groups, blocks = [], [], []
    mod = encdec if tcfg.family == "audio" else transformer
    name = ("encdec_decode_step" if tcfg.family == "audio"
            else "lm_decode_step")
    step_fn, mlp, blockwise = getattr(mod, name), moe.moe_mlp, \
        layers.blockwise

    def spy_step(cfg, params, cache, tokens, pos, row_blocks=1):
        rows.append((tokens.shape[0], row_blocks))
        return step_fn(cfg, params, cache, tokens, pos, row_blocks)

    def spy_mlp(cfg, lp, x, g=1, ctx=None):
        groups.append(g)
        return mlp(cfg, lp, x, g, ctx=ctx)

    def spy_blockwise(fn, *xs, dim=0):
        blocks.append(getattr(layers._ROWS, "n", 1))
        return blockwise(fn, *xs, dim=dim)
    setattr(mod, name, spy_step)
    moe.moe_mlp, layers.blockwise = spy_mlp, spy_blockwise
    try:
        tok = batch["tokens"][:, -1]
        for s in range(3):
            p1 = torch.full((B,), pos + s) if per_row else pos + s
            p2 = torch.cat([p1, p1]) if per_row else p1
            l1, one = m.decode_step(p, one, tok, p1)
            rows.clear()
            groups.clear()
            l2, two = m.decode_step(p, two, torch.cat([tok, tok]), p2,
                                    row_blocks=2)
            assert torch.equal(l2[:B], l1) and torch.equal(l2[B:], l1)
            tok = torch.argmax(l1, -1)
    finally:
        setattr(mod, name, step_fn)
        moe.moe_mlp, layers.blockwise = mlp, blockwise
    return rows, groups, blocks


def test_both_decode_layouts_equal_a_replica_alone(fam):
    """The fused backend's decode on the CPU, bit for bit against B rows
    decoded alone: every family decodes the 2B stacked rows together, in
    one decode of 2B rows in two row blocks (there is no decode per half
    any more), its row-sensitive ops per block, a MoE layer routing each
    half as one dispatch group (on the card, where the stacked rows once
    lost a replica's bits, `chip_smoke.py::stacked_decode_bits` holds the
    same)."""
    rows, groups, blocks = _stacked_decode(fam["tcfg"], fam["tparams"],
                                           fam["prompt"], fam["P"],
                                           per_row=False)
    assert rows == [(2 * B, 2)]
    assert 2 in blocks
    assert set(groups) == ({2} if fam["tcfg"].family == "moe" else set())


@pytest.mark.parametrize("family", ["moe", "hybrid", "ssm"])
def test_stacked_decode_at_per_row_positions_equals_a_replica_alone(family):
    """`serve()`'s per-row positions (moe, hybrid, ssm; the port's own
    seeded params): the 2B stacked rows together, bit for bit against B
    rows alone; a MoE layer routes each row as its own dispatch group."""
    tcfg = dataclasses.replace(reduce_for_smoke(get_config(FAMILIES[family])),
                               attention_impl="pallas")
    params = make_server(RunConfig(model=tcfg), backend="none",
                         device="cpu").model.init(seed=3)
    prompt = {"tokens": np.random.RandomState(2).randint(
        0, 200, (B, S)).astype(np.int64)}
    rows, groups, blocks = _stacked_decode(tcfg, params, prompt, 0,
                                           per_row=True)
    assert rows == [(2 * B, 2)]
    assert 2 in blocks
    assert set(groups) == ({2 * B} if family == "moe" else set())
