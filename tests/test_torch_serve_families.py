"""Protected `generate()` of the moe, hybrid, vlm, ssm (xLSTM) and audio
(encoder-decoder) families against the JAX reference's
`SedarServer.generate`, on the same seeded prompt and the same params
(carried across by `bridge.params_from_numpy`), at reduce_for_smoke size
in f32 with `attention_impl="pallas"` (K2's plain version on the CPU). The
vlm prompt passes `frontend_embeds` (decode starts at S + P), the audio
prompt passes the encoder's frames the same way (decode starts at S), and
the hybrid prompt is a multiple of the window (the reference's ring is
misplaced otherwise).

Held exactly: the emitted tokens under none, sequential and abft; under
the same `InjectionSpec` (a bit-30 flip of `final_ln` on replica 1, or of
one element of the abft logits checksum block) the (step, boundary,
effect) stream of detections, the retries and the recoveries; the counted
host reads per step. Also: a MoE prompt off the bucket ladder is
prefilled exactly, never padded (F2); serve() raises for the frontend
families, as the reference's does."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs import RunConfig as JRunConfig
from repro.configs import get_config as jget_config
from repro.configs import reduce_for_smoke as jreduce
from repro.core.injection import InjectionSpec as JSpec
from repro.runtime.scheduler import Request as JRequest
from repro.runtime.serve import SedarServer as JServer

from repro_torch import tree as tree_util
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import RunConfig, get_config, reduce_for_smoke
from repro_torch.core import hostsync
from repro_torch.core.injection import InjectionSpec
from repro_torch.core.policy import make_server
from repro_torch.models import build_model
from repro_torch.runtime.scheduler import Request

torch.set_num_threads(1)

STEPS = 6
B, S = 2, 16
V = 257               # reduce_for_smoke vocabulary
FAMILIES = {"moe": "phi3.5-moe-42b-a6.6b", "hybrid": "recurrentgemma-2b",
            "vlm": "internvl2-2b", "ssm": "xlstm-125m",
            "audio": "seamless-m4t-medium"}


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
    if jcfg.frontend:
        prompt["frontend_embeds"] = (0.1 * np.random.RandomState(1)
                                     .standard_normal((B, jcfg.frontend_seq,
                                                       jcfg.frontend_dim))
                                     ).astype(np.float32)
    # decode positions count a vlm's patches, not an audio encoder's frames
    P = jcfg.frontend_seq if jcfg.family == "vlm" else 0
    clean, _ = srv.generate(jparams, prompt, steps=STEPS)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    paths = [p for p, _ in tree_util.flatten_with_path(tparams)]
    return {"name": request.param, "jcfg": jcfg, "tcfg": tcfg,
            "jparams": jparams, "tparams": tparams, "prompt": prompt,
            "clean": clean, "P": P,
            "final_ln": paths.index("['decoder']['final_ln']"
                                    if jcfg.family == "audio"
                                    else "['final_ln']")}


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
    if fam["name"] == "ssm":
        # logit (1, 5) lies in [1, 2) here: bit 30 makes it a NaN. Its
        # residual compares False against the reference's `|res| > tau`,
        # so the fault escapes the reference's ABFT and row 1 emits token 5
        # (ROADMAP F3, a reference caveat). The port counts a non-finite
        # residual as violated: uncorrectable, the step is retried, and
        # the tokens are the clean run's.
        assert _events(jrep) == [] and jrep.retries == 0
        assert jtoks[1, 3] == 5 and not np.array_equal(jtoks, fam["clean"])
        assert _events(rep) == [(step, "commit", "TDC", False)]
        assert rep.retries == 1 and not rep.stopped
        np.testing.assert_array_equal(toks, fam["clean"])
        return
    assert _events(rep) == _events(jrep)
    assert _recs(srv.engine) == _recs(jsrv.engine)
    assert rep.retries == jrep.retries == 0
    np.testing.assert_array_equal(toks, jtoks)
    assert _events(rep) == [(step, "commit", "TDC", True)]
    assert _recs(srv.engine) == [("abft_correct", None, 0, step)]
    np.testing.assert_array_equal(toks, fam["clean"])


def test_decode_starts_after_the_prompt_and_a_vlm_frontend(fam):
    """The first decode step runs at position S + P: P counts a vlm's
    patches, not the audio encoder's frames (its frames are no decoder
    positions, as in the reference)."""
    srv = _port(fam, "none")
    seen = []
    decode = srv.model.decode_step

    def spy(params, cache, tokens, pos, **kw):
        seen.append(pos)
        return decode(params, cache, tokens, pos, **kw)

    srv.model.decode_step = spy
    toks, _ = srv.generate(fam["tparams"], fam["prompt"], steps=3)
    assert seen == [S + fam["P"], S + fam["P"] + 1]
    np.testing.assert_array_equal(toks, fam["clean"][:, :3])


@pytest.mark.parametrize("name", ["vlm", "audio"])
def test_serve_raises_for_the_frontend_families_as_the_reference(name):
    """Continuous batching serves token prompts in both packages: a vlm or
    audio server's serve() raises the reference's NotImplementedError."""
    jcfg, tcfg = _cfgs(FAMILIES[name])
    prompt = np.arange(4, dtype=np.int32)
    with pytest.raises(NotImplementedError, match="token-prompt families"):
        JServer(JRunConfig(model=jcfg)).serve(
            None, [JRequest(rid=0, prompt=prompt, max_new_tokens=2)], slots=2)
    with pytest.raises(NotImplementedError, match="token-prompt families"):
        _port({"tcfg": tcfg}, "none").serve(
            None, [Request(rid=0, prompt=prompt, max_new_tokens=2)], slots=2)


def test_launcher_runs_the_family_on_the_cpu(fam, monkeypatch, capsys):
    from repro_torch.launch import serve as launcher
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", FAMILIES[fam["name"]], "--dual", "--device", "cpu",
        "--batch", "2", "--prompt-len", "8", "--steps", "4"])
    launcher.main()
    out = capsys.readouterr().out
    assert "backend=sequential" in out and "detections=0" in out


@pytest.mark.parametrize("B_,S_", [(4, 5), (4, 13), (2, 20), (1, 40)])
def test_moe_prompt_off_the_ladder_prefills_exactly(B_, S_):
    """F2: padding a MoE prompt to its bucket (8, 16, 32, 64) would route the
    pad tokens through top-k and move the real tokens' logits. generate()'s
    first-token logits equal `model.prefill` at the exact length, bit for
    bit, with a cache deep enough for the bucket."""
    _, tcfg = _cfgs(FAMILIES["moe"])
    srv = _port({"tcfg": tcfg}, "sequential")
    params = srv.model.init(seed=0)
    toks = torch.from_numpy(np.random.RandomState(S_).randint(0, V, (B_, S_)))
    max_len = 80
    got = []
    prefill = srv.model.prefill

    def spy(params, batch, max_len):
        out = prefill(params, batch, max_len)
        got.append((dict(batch), out[0]))
        return out

    srv.model.prefill = spy
    out, rep = srv.generate(params, {"tokens": toks}, steps=2,
                            max_len=max_len)
    want, _ = build_model(tcfg, "cpu").prefill(params, {"tokens": toks},
                                               max_len)
    (batch, logits), = got
    assert "lengths" not in batch and batch["tokens"].shape == (B_, S_)
    assert torch.equal(logits, want)
    np.testing.assert_array_equal(out[:, 0], torch.argmax(want, -1).numpy())
    assert not rep.detections
