"""Protected `generate()` of the moe, hybrid and vlm families against the JAX
reference's `SedarServer.generate`, on the same seeded prompt and the same
params (carried across by `bridge.params_from_numpy`), at reduce_for_smoke
size in f32 with `attention_impl="pallas"` (K2's plain version on the
CPU). The vlm prompt passes `frontend_embeds`, and the hybrid prompt is a
multiple of the window (the reference's ring is misplaced otherwise).

Held exactly: the emitted tokens under none, sequential and abft; under
the same `InjectionSpec` (a bit-30 flip of `final_ln` on replica 1, or of
one element of the abft logits checksum block) the (step, boundary,
effect) stream of detections, the retries and the recoveries; the counted
host reads per step."""
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
from repro_torch.core import hostsync
from repro_torch.core.injection import InjectionSpec
from repro_torch.core.policy import make_server
from repro_torch.runtime.scheduler import Request

torch.set_num_threads(1)

STEPS = 6
B, S = 2, 16
V = 257               # reduce_for_smoke vocabulary
FAMILIES = {"moe": "phi3.5-moe-42b-a6.6b", "hybrid": "recurrentgemma-2b",
            "vlm": "internvl2-2b"}


def _cfgs(arch):
    return (dataclasses.replace(jreduce(jget_config(arch)),
                                attention_impl="pallas"),
            dataclasses.replace(reduce_for_smoke(get_config(arch)),
                                attention_impl="pallas"))


def _events(rep):
    return [(e.step, e.boundary, e.effect,
             bool(e.detail.get("abft_corrected"))) for e in rep.detections]


def _recs(eng):
    return [(r["kind"], r["step"], r["rollbacks"], r["at"])
            for r in eng.recoveries]


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def fam(request):
    jcfg, tcfg = _cfgs(FAMILIES[request.param])
    srv = JServer(JRunConfig(model=jcfg))
    jparams = srv.model.init(jax.random.PRNGKey(0))
    prompt = {"tokens": np.random.RandomState(0).randint(
        0, 200, (B, S)).astype(np.int32)}
    P = 0
    if jcfg.frontend:
        P = jcfg.frontend_seq
        prompt["frontend_embeds"] = (0.1 * np.random.RandomState(1)
                                     .standard_normal((B, P, jcfg.frontend_dim))
                                     ).astype(np.float32)
    clean, _ = srv.generate(jparams, prompt, steps=STEPS)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    paths = [p for p, _ in tree_util.flatten_with_path(tparams)]
    return {"name": request.param, "jcfg": jcfg, "tcfg": tcfg,
            "jparams": jparams, "tparams": tparams, "prompt": prompt,
            "clean": clean, "P": P,
            "final_ln": paths.index("['final_ln']")}


def _port(fam, backend, spec=None, **kw):
    return make_server(RunConfig(model=fam["tcfg"]), backend=backend,
                       inj_spec=InjectionSpec(**spec) if spec else None,
                       device="cpu", **kw)


def _pair(fam, backend, spec):
    jsrv = JServer(JRunConfig(model=fam["jcfg"]), backend=backend,
                   inj_spec=JSpec(**spec))
    jtoks, jrep = jsrv.generate(fam["jparams"], fam["prompt"], steps=STEPS)
    srv = _port(fam, backend, spec)
    toks, rep = srv.generate(fam["tparams"], fam["prompt"], steps=STEPS)
    return (toks, rep, srv), (jtoks, jrep, jsrv)


@pytest.mark.parametrize("backend,reads", [
    ("none", {"token_emit": STEPS}),
    ("sequential", {"commit_compare": STEPS - 1, "token_emit": STEPS}),
    ("abft", {"abft_verdict": STEPS - 1, "token_emit": STEPS})])
def test_clean_generate_matches_reference_tokens(fam, backend, reads):
    srv = _port(fam, backend)
    with hostsync.count_transfers() as st:
        toks, rep = srv.generate(fam["tparams"], fam["prompt"], steps=STEPS)
    assert toks.shape == (B, STEPS)
    np.testing.assert_array_equal(toks, fam["clean"])
    assert not rep.detections and not rep.stopped
    assert srv.engine.executor.name == backend
    assert st.by_label == reads


def test_sequential_fault_detected_and_retried_like_reference(fam):
    step = S + fam["P"] + 2
    spec = dict(leaf_idx=fam["final_ln"], flat_idx=3, bit=30, step=step,
                replica=1, target="params")
    (toks, rep, srv), (jtoks, jrep, jsrv) = _pair(fam, "sequential", spec)
    assert _events(rep) == _events(jrep) == [(step, "commit", "TDC", False)]
    assert rep.retries == jrep.retries == 1 and not rep.stopped
    assert _recs(srv.engine) == _recs(jsrv.engine)
    np.testing.assert_array_equal(toks, fam["clean"])
    np.testing.assert_array_equal(jtoks, fam["clean"])


def test_abft_kernel_fault_corrected_forward_like_reference(fam):
    step = S + fam["P"] + 2
    spec = dict(leaf_idx=0, flat_idx=1 * (V + 1) + 5, bit=30, step=step,
                replica=0, target="kernel")
    (toks, rep, srv), (jtoks, jrep, jsrv) = _pair(fam, "abft", spec)
    assert _events(rep) == _events(jrep) == [(step, "commit", "TDC", True)]
    assert _recs(srv.engine) == _recs(jsrv.engine) == \
        [("abft_correct", None, 0, step)]
    assert rep.retries == jrep.retries == 0
    np.testing.assert_array_equal(toks, fam["clean"])
    np.testing.assert_array_equal(jtoks, fam["clean"])


def test_backends_and_serve_not_yet_ported_for_the_families_raise(fam):
    for backend in ("fused", "hybrid"):
        with pytest.raises(NotImplementedError, match="slice 8"):
            _port(fam, backend)
    srv = _port(fam, "none")
    reqs = [Request(rid=0, prompt=np.arange(4), max_new_tokens=2)]
    match = "frontend" if fam["name"] == "vlm" else "slice 8"
    with pytest.raises(NotImplementedError, match=match):
        srv.serve(fam["tparams"], reqs, slots=2)


def test_launcher_runs_the_family_on_the_cpu(fam, monkeypatch, capsys):
    from repro_torch.launch import serve as launcher
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", FAMILIES[fam["name"]], "--dual", "--device", "cpu",
        "--batch", "2", "--prompt-len", "8", "--steps", "4"])
    launcher.main()
    out = capsys.readouterr().out
    assert "backend=sequential" in out and "detections=0" in out
