"""Fused protected `generate()` of the moe, hybrid, vlm, ssm and audio
families against the JAX reference's, on the same seeded prompt and params
(`bridge.params_from_numpy`), at reduce_for_smoke size in f32 with
`attention_impl="pallas"` (K2's plain version on the CPU).

The port stacks both replicas as the row blocks of one decode, the
attention per replica half and the recurrent states row-independent, or
(moe, vlm, ssm: `BLOCKWISE_FAMILIES`) decodes each half on its own; a MoE
layer routes each replica's rows as its own dispatch group (the reference
vmaps the replicas). Held exactly: the clean tokens (also equal to
the port's own sequential run, bit for bit: bits come from inside the
port), and under a bit-30 flip of `final_ln` on replica 1 the (step,
boundary, effect) stream, the retries and the recovery records, with the
clean tokens."""
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


def test_both_decode_layouts_equal_a_replica_alone(fam):
    """The fused backend's two layouts of a decode step on the CPU, bit
    for bit against B rows decoded alone: the 2B stacked rows together
    with the attention per half (`Model._decode(row_blocks=2)`, a MoE
    layer routing each half as one dispatch group) and each half on its
    own (`Model._in_blocks`). `decode_step` takes the second exactly for
    `BLOCKWISE_FAMILIES` (on the card the first lost a replica's bits
    there, `chip_smoke.py::stacked_decode_bits`)."""
    from repro_torch.models import model as model_lib, moe
    srv = make_server(RunConfig(model=fam["tcfg"]), backend="none",
                      device="cpu")
    m, p = srv.model, fam["tparams"]
    batch = {k: torch.from_numpy(v) for k, v in fam["prompt"].items()}
    pos = S + fam["P"]
    _, cache = m.prefill(p, batch, pos + 8)
    axes = m.slot_axes()
    one = tree_util.tree_map(lambda c: c.clone(), cache)
    two = tree_util.tree_map(lambda c, ax: torch.cat([c, c], dim=ax),
                             cache, axes)
    blk = tree_util.tree_map(lambda c: c.clone(), two)
    groups, blockwise = [], []
    mlp, in_blocks = moe.moe_mlp, m._in_blocks

    def spy_mlp(cfg, lp, x, g=1, ctx=None):
        groups.append(g)
        return mlp(cfg, lp, x, g, ctx=ctx)

    def spy_blocks(*a):
        blockwise.append(True)
        return in_blocks(*a)
    moe.moe_mlp, m._in_blocks = spy_mlp, spy_blocks
    try:
        tok = batch["tokens"][:, -1]
        for s in range(3):
            l1, one = m._decode(p, one, tok, pos + s)
            groups.clear()
            l2, two = m._decode(p, two, torch.cat([tok, tok]), pos + s,
                                row_blocks=2)
            assert set(groups) <= {2}
            l3, blk = m.decode_step(p, blk, torch.cat([tok, tok]), pos + s,
                                    row_blocks=2)
            for got in (l2, l3):
                assert torch.equal(got[:B], l1) and torch.equal(got[B:], l1)
            tok = torch.argmax(l1, -1)
    finally:
        moe.moe_mlp = mlp
        del m._in_blocks
    assert bool(blockwise) == (fam["tcfg"].family
                               in model_lib.BLOCKWISE_FAMILIES)
    assert bool(groups) == (fam["tcfg"].family == "moe")
